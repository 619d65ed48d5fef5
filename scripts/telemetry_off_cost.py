"""The host cost of the PyTorch port's telemetry when it is off (the default),
on a CUDA card: DV3-S's player step and ppo_atari's rollout step, with the
run's default telemetry open and not open in one process, and of one
checkout against another (the parent commit), one process per checkout,
the two taken in turns (A B B A ...).

    python3 scripts/telemetry_off_cost.py --compare BEFORE_DIR AFTER_DIR [--turns 2] [--out FILE]

Each process builds its checkout's LN-GRU kernels and times, with the
checkout's own ``chip_smoke.py`` helpers:

- DV3-S's player step (``exp=dreamer_v3_100k_ms_pacman``, bf16-mixed,
  random weights, 4 dummy envs) through ``InteractionPipeline.interact`` at
  one slice with the blocking fetch, each env step inside
  ``timer("Time/env_interaction_time")`` as the trainer's loop has it:
  ``WINDOWS`` windows of ``WINDOW`` steps per mode, host wall per env step
  ending in a synchronize;
- ppo_atari's rollout step (``_ppo_pipeline_timing``: the loop as it was
  before the pipeline, which emits no span, and the pipeline at one slice,
  at 4 envs and at 1 env), once per mode.

The modes: ``off``, the run's default telemetry (``telemetry.enabled=False``)
opened as a trainer opens it (the flight recorder and the live tracer that
feeds its ring), and ``none``, nothing opened; a checkout without
``sheeprl_tpu_torch.telemetry`` has ``none`` only. The DV3-S windows
alternate the modes (off none, none off, ...).

``--tree DIR --json FILE`` runs one such process. The summary (each
process's numbers, the means per checkout and mode, and three differences:
off against none in one process, none against the other checkout, off
against the other checkout) is printed as one JSON line and written to
``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

WARMUP, WINDOW, WINDOWS = 16, 64, 12


def measure(tree: str) -> dict:
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as c
    from sheeprl_tpu_torch import kernels
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.utils.distribution import BatchGenerator
    from sheeprl_tpu_torch.utils.timer import timer

    kernels.build()
    try:
        from sheeprl_tpu_torch.telemetry import Telemetry
    except ImportError:
        Telemetry = None
    log_dir = tempfile.mkdtemp(prefix="off_cost_")
    cfg = compose(c.PIPE_ARGS)

    def opened(mode):
        """The run's default telemetry, open (``off``) or not (``none``)."""
        if mode == "none":
            return None
        tele = Telemetry.from_config(cfg).open(log_dir, device="cuda")
        if tele.enabled:
            raise SystemExit("telemetry is on in the default config")
        return tele

    modes = ("off", "none") if Telemetry is not None else ("none",)
    cfg_p, agent = c._dv3_player("bf16-mixed")
    stepper = c._dv3_stepper(cfg_p, agent, BatchGenerator.from_seed(1, "cuda"))

    def step(n):
        for _ in range(n):
            with timer("Time/env_interaction_time"):
                stepper(1)

    step(WARMUP)
    windows = {m: [] for m in modes}
    for w in range(WINDOWS):
        for mode in modes if w % 2 == 0 else modes[::-1]:
            tele = opened(mode)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(WINDOW)
            torch.cuda.synchronize()
            windows[mode].append((time.perf_counter() - t0) * 1e3 / WINDOW)
            if tele is not None:
                tele.close()
    ppo = {}
    for mode in modes:
        tele = opened(mode)
        try:
            ppo[mode] = c._ppo_pipeline_timing()
        finally:
            if tele is not None:
                tele.close()
    variants = ("e4_loop", "e4_s1", "e1_loop", "e1_s1")
    return {
        "tree": tree,
        "modes": list(modes),
        "dv3_player_step_ms": {m: {"median": statistics.median(windows[m]), "windows": windows[m]} for m in modes},
        "ppo_atari_rollout_step_ms": {m: {k: ppo[m][k]["host_wall_ms_per_env_step"] for k in variants} for m in modes},
        "ppo_atari_windows_ms": {m: {k: ppo[m][k]["host_wall_ms_windows"] for k in variants} for m in modes},
    }


def compare(before: str, after: str, turns: int, out: str) -> None:
    order = []
    for t in range(turns):
        order += [("before", before), ("after", after)] if t % 2 == 0 else [("after", after), ("before", before)]
    runs = []
    for label, tree in order:
        with tempfile.NamedTemporaryFile(suffix=".json", delete=False) as fp:
            path = fp.name
        t0 = time.perf_counter()
        subprocess.run([sys.executable, os.path.abspath(__file__), "--tree", os.path.abspath(tree), "--json", path], check=True, cwd=os.path.abspath(tree))
        with open(path) as fp:
            runs.append({"label": label, "process_s": time.perf_counter() - t0, **json.load(fp)})
        print(json.dumps(runs[-1]), flush=True)
    summary = {"order": [label for label, _ in order], "runs": runs, "mean": {}}
    for label, mode in (("before", "none"), ("after", "none"), ("after", "off")):
        mine = [r for r in runs if r["label"] == label]
        ppo = [r["ppo_atari_rollout_step_ms"][mode] for r in mine]
        summary["mean"][f"{label}_{mode}"] = {
            "dv3_player_step_ms": statistics.mean(r["dv3_player_step_ms"][mode]["median"] for r in mine),
            **{f"ppo_atari_{k}_ms": statistics.mean(p[k] for p in ppo) for k in ppo[0]},
        }
    mean = summary["mean"]
    summary["differences_ms"] = {
        what: {k: mean[a][k] - mean[b][k] for k in mean[a]}
        for what, a, b in (("off_minus_none_in_process", "after_off", "after_none"), ("after_none_minus_before", "after_none", "before_none"),
                           ("after_off_minus_before", "after_off", "before_none"))
    }  # fmt: skip
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as fp:
            json.dump(summary, fp, indent=2)
    print(json.dumps({"mean": summary["mean"], "differences_ms": summary["differences_ms"]}), flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--compare", nargs=2, metavar=("BEFORE_DIR", "AFTER_DIR"))
    parser.add_argument("--turns", type=int, default=2)
    parser.add_argument("--out", default="")
    parser.add_argument("--tree")
    parser.add_argument("--json")
    args = parser.parse_args()
    if args.tree:
        result = measure(args.tree)
        with open(args.json, "w") as fp:
            json.dump(result, fp)
    elif args.compare:
        compare(*args.compare, args.turns, args.out)
    else:
        parser.error("give --compare BEFORE_DIR AFTER_DIR, or --tree DIR --json FILE")


if __name__ == "__main__":
    main()
