"""Command line: ``python -m sheeprl_tpu_torch.serve <serve|export|export-random>``.

``serve`` loads the listed artifacts into an engine and runs the HTTP
server in the foreground until SIGTERM (which drains)::

    python -m sheeprl_tpu_torch.serve serve 'artifacts=[pi.policy]' serve.port=8080 serve.max_batch=8

Keys (``key=value``), composed by the port's reader from
``configs/serve_config.yaml`` and ``configs/serve/default.yaml`` (the JAX
package's files): ``serve.host`` 127.0.0.1, ``serve.port`` 8080,
``serve.max_batch`` 8, ``serve.queue_capacity`` 64,
``serve.batch_window_ms`` 2.0, ``serve.max_models`` 4,
``serve.max_sessions`` 256, and ``device`` (cuda; ``device=cpu`` runs on the
CPU).

``export`` writes the policy of a port training checkpoint as an artifact
(default path ``<log dir>/artifacts/<name>.policy``)::

    python -m sheeprl_tpu_torch.serve export checkpoint_path=logs/runs/.../checkpoint/ckpt_1024_0.ckpt [name=pi] [output_path=pi.policy]

``export-random`` writes a DreamerV3-S / MsPacman artifact from the port's
seeded initialiser::

    python -m sheeprl_tpu_torch.serve export-random name=pi seed=0 [output_path=pi.policy] [precision=bf16-mixed]
"""

from __future__ import annotations

import pathlib
import sys
from typing import Any, Dict, List, Optional, Sequence

from sheeprl_tpu_torch.config import ConfigError, compose, parse_list, parse_overrides

CONFIG_NAME = "serve_config"
# The ``serve`` group's defaults, as composed from the port's tree.
SERVE_DEFAULTS: Dict[str, Any] = dict(compose(["artifacts=[]"], config_name=CONFIG_NAME).serve)


def serve_config(overrides: Sequence[str]) -> Dict[str, Any]:
    """{"artifacts": [...], "device": ..., "serve": {...}}: ``serve_config``
    composed with ``overrides``. The reader's refusal of a key the files do
    not define is the one check of the keys."""
    try:
        cfg = compose(list(overrides), config_name=CONFIG_NAME)
    except ConfigError as err:
        refusal = str(err).split(". Use '+")[0]
        raise ValueError(f"Unknown serve key or argument: {refusal}. Valid: {sorted('serve.' + k for k in SERVE_DEFAULTS)}, artifacts, device") from err
    artifacts = cfg.artifacts
    if not isinstance(artifacts, list):
        artifacts = [] if artifacts == "???" else parse_list(str(artifacts))  # ??? : the file's mandatory value, not given
    if not artifacts:
        raise ValueError("You must specify at least one artifact: 'artifacts=[path/to/policy.policy]'")
    return {"artifacts": [str(a) for a in artifacts], "device": str(cfg.device), "serve": dict(cfg.serve)}


def _serve(overrides: List[str]) -> None:
    from sheeprl_tpu_torch.serve.engine import InferenceEngine
    from sheeprl_tpu_torch.serve.server import PolicyServer

    cfg = serve_config(overrides)
    serve = cfg["serve"]
    engine = InferenceEngine(
        max_batch=int(serve["max_batch"]),
        queue_capacity=int(serve["queue_capacity"]),
        batch_window_s=float(serve["batch_window_ms"]) / 1000.0,
        max_models=int(serve["max_models"]),
        max_sessions=int(serve["max_sessions"]),
        device=cfg["device"],
    )
    for entry in cfg["artifacts"]:
        path = pathlib.Path(entry)
        name = path.name[: -len(".policy")] if path.name.endswith(".policy") else path.name
        card = engine.load(name, str(path))
        print(f"Loaded model {name!r} ({card['algo']}) from {path} on {card['device']}", flush=True)
    server = PolicyServer(engine, host=str(serve["host"]), port=int(serve["port"]))
    print(f"Serving {sorted(engine.models())} on {server.address} (SIGTERM drains and exits)", flush=True)
    server.serve_forever()


def _export(overrides: List[str]) -> None:
    from sheeprl_tpu_torch.serve.artifact import export_artifact

    kv = parse_overrides(overrides)
    checkpoint_path = kv.pop("checkpoint_path", None)
    if checkpoint_path is None:
        raise ValueError("You must specify checkpoint_path=<path-to-checkpoint>")
    output_path = kv.pop("output_path", None)
    name = kv.pop("name", None)
    if kv:
        raise ValueError(f"Unknown export arguments: {sorted(kv)}")
    print(f"Exported policy artifact: {export_artifact(checkpoint_path, output_path, name=name)}", flush=True)


def _export_random(overrides: List[str]) -> None:
    from sheeprl_tpu_torch.algos.dreamer_v3.serve import export_random

    kv = parse_overrides(overrides)
    name = kv.pop("name", "dreamer_v3_random")
    seed = int(kv.pop("seed", "0"))
    output_path = kv.pop("output_path", f"{name}.policy")
    precision = kv.pop("precision", "bf16-mixed")
    if kv:
        raise ValueError(f"Unknown export-random arguments: {sorted(kv)}")
    path = export_random(output_path, name=name, seed=seed, precision=precision)
    print(f"Exported policy artifact: {path}", flush=True)


def main(args: Optional[Sequence[str]] = None) -> None:
    argv = list(args) if args is not None else sys.argv[1:]
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return
    command, rest = argv[0], argv[1:]
    if command == "serve":
        _serve(rest)
    elif command == "export":
        _export(rest)
    elif command == "export-random":
        _export_random(rest)
    else:
        raise SystemExit(f"Unknown command {command!r}; expected 'serve', 'export' or 'export-random'.\n{__doc__}")
