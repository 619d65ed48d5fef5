"""Policy artifacts: self-contained inference snapshots (counterpart of
sheeprl_tpu/serve/artifact.py).

Layout, committed atomically (:func:`atomic_dir_writer`)::

    <name>.policy/
        arrays.pt       # {"world_model": state_dict, "actor": state_dict}, read with torch.load(weights_only=True)
        spec.json       # schema, algo, spaces, the config subtree the adapter rebuilds from
        manifest.json   # digests over arrays and spec; written last

:func:`export_artifact` makes one from a training checkpoint of the port
(``python -m sheeprl_tpu_torch.serve export checkpoint_path=...``). The JAX
package keeps its arrays in Orbax instead; reading its artifacts and
checkpoints here needs an importer that is not written yet.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from sheeprl_tpu_torch.utils.checkpoint import _digest_arrays, atomic_dir_writer, load_checkpoint, parse_ckpt_name

ARTIFACT_SUFFIX = ".policy"
ARRAYS_NAME = "arrays.pt"
SPEC_NAME = "spec.json"
MANIFEST_NAME = "manifest.json"
ARTIFACT_SCHEMA_VERSION = 1


def _sha256_bytes(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


@dataclass(frozen=True)
class PolicyArtifact:
    """A loaded artifact: parsed spec and manifest, params on the CPU."""

    path: str
    spec: Dict[str, Any]
    manifest: Dict[str, Any]
    params: Dict[str, Dict[str, torch.Tensor]]

    @property
    def algo(self) -> str:
        return str(self.spec["algo"])


def write_artifact(output_path: str, params: Dict[str, Dict[str, torch.Tensor]], spec: Dict[str, Any]) -> str:
    """Commit ``params`` (moved to the CPU) and ``spec`` as an artifact
    directory; returns its absolute path."""
    cpu = {group: {k: v.detach().to("cpu").contiguous() for k, v in sd.items()} for group, sd in params.items()}
    spec = {"schema_version": ARTIFACT_SCHEMA_VERSION, **spec}
    spec_bytes = json.dumps(spec, indent=2, sort_keys=True).encode()
    digest, leaf_count = _digest_arrays(cpu)
    manifest = {
        "schema_version": ARTIFACT_SCHEMA_VERSION,
        "kind": "policy_artifact",
        "algo": str(spec["algo"]),
        "leaf_count": leaf_count,
        "digest": digest,
        "spec_sha256": _sha256_bytes(spec_bytes),
        "created_unix": time.time(),
    }
    with atomic_dir_writer(output_path, fail_point="artifact.before_commit") as staging:
        os.makedirs(staging)
        torch.save(cpu, os.path.join(staging, ARRAYS_NAME))
        with open(os.path.join(staging, SPEC_NAME), "wb") as fp:
            fp.write(spec_bytes)
        with open(os.path.join(staging, MANIFEST_NAME), "w") as fp:
            json.dump(manifest, fp, indent=2)
    return os.path.abspath(output_path)


def export_artifact(checkpoint_path: str, output_path: Optional[str] = None, *, name: Optional[str] = None) -> str:
    """Write the policy of a port training checkpoint as an artifact; returns
    its path. The run's ``config.json`` (two levels above the checkpoint)
    gives the algorithm and the env, the checkpoint the spaces' specs the
    trainer saved in it. ``name`` defaults to ``<algo>_<env.id>_<policy
    step>``, ``output_path`` to ``<log dir>/artifacts/<name>.policy``."""
    from sheeprl_tpu_torch.serve.registry import get_policy_cls
    from sheeprl_tpu_torch.utils.utils import dotdict

    ckpt = os.path.abspath(checkpoint_path)
    log_dir = os.path.dirname(os.path.dirname(ckpt))
    with open(os.path.join(log_dir, "config.json")) as fp:
        cfg = dotdict(json.load(fp))
    algo = str(cfg.algo.name)
    adapter_cls = get_policy_cls(algo)
    state = load_checkpoint(ckpt)
    params, policy_config = adapter_cls.export(state, cfg)
    step = (parse_ckpt_name(ckpt) or (0, 0))[0]
    name = name or f"{algo}_{cfg.env.id}_{step}"
    spec = {
        "name": str(name),
        "algo": algo,
        "stateful": bool(adapter_cls.stateful),
        "policy_step": int(step),
        "source_checkpoint": ckpt,
        "env_id": str(cfg.env.id),
        "observation_space": state["observation_space"],
        "action_space": state["action_space"],
        "config": policy_config,
    }
    return write_artifact(output_path or os.path.join(log_dir, "artifacts", f"{name}{ARTIFACT_SUFFIX}"), params, spec)


def read_artifact_manifest(path: str) -> Optional[Dict[str, Any]]:
    try:
        with open(os.path.join(path, MANIFEST_NAME), "rb") as fp:
            manifest = json.load(fp)
    except (OSError, ValueError):
        return None
    return manifest if isinstance(manifest, dict) else None


def _load_arrays(path: str) -> Dict[str, Dict[str, torch.Tensor]]:
    return torch.load(os.path.join(path, ARRAYS_NAME), map_location="cpu", weights_only=True)


def validate_artifact(path: str, verify_digest: bool = False) -> bool:
    """True iff ``path`` is a complete, committed artifact; with
    ``verify_digest`` the spec and every array are rehashed too."""
    manifest = read_artifact_manifest(path)
    if manifest is None or manifest.get("kind") != "policy_artifact":
        return False
    try:
        if int(manifest["schema_version"]) > ARTIFACT_SCHEMA_VERSION:
            return False
        leaf_count = int(manifest["leaf_count"])
    except (KeyError, TypeError, ValueError):
        return False
    spec_file = os.path.join(path, SPEC_NAME)
    if not os.path.isfile(os.path.join(path, ARRAYS_NAME)) or not os.path.isfile(spec_file):
        return False
    if not verify_digest:
        return True
    try:
        with open(spec_file, "rb") as fp:
            if _sha256_bytes(fp.read()) != manifest.get("spec_sha256"):
                return False
        digest, n = _digest_arrays(_load_arrays(path))
    except Exception:  # noqa: BLE001 - any unreadable payload means invalid
        return False
    return n == leaf_count and digest == manifest.get("digest")


def load_artifact(path: str, *, verify_digest: bool = False) -> PolicyArtifact:
    """Read an artifact directory into spec + CPU params."""
    path = os.path.abspath(path)
    if not validate_artifact(path, verify_digest=verify_digest):
        raise ValueError(f"{path} is not a valid policy artifact (torn export, wrong schema, or failed digest check)")
    with open(os.path.join(path, SPEC_NAME), "rb") as fp:
        spec = json.load(fp)
    return PolicyArtifact(path=path, spec=spec, manifest=read_artifact_manifest(path) or {}, params=_load_arrays(path))


def make_policy(artifact: PolicyArtifact, device: torch.device):
    """Instantiate the registered adapter for a loaded artifact on ``device``."""
    from sheeprl_tpu_torch.serve.registry import get_policy_cls

    return get_policy_cls(artifact.algo)(artifact.spec, artifact.params, device)
