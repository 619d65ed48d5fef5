#!/usr/bin/env python3
"""Drive the PyTorch port (sheeprl_tpu_torch) on one CUDA card and check it.

Run from the root of a checkout, on a machine with an H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. Device: a CUDA card must be present; print its name and power limit.
2. Build: compile every CUDA kernel of the port from csrc/ with nvcc.
3. Kernels against their plain versions on the card: the LN-GRU step at
   DreamerV3-S shapes (D=1024, H=512, B in 1, 2, 4, 8, 64), an unaligned shape
   (B=3, D=200, H=100) and the XL shape (D=5120, H=4096, B=8), in f32 with
   TF32 off and in bf16. Tolerances: z within rtol 1e-4 / atol 1e-4 and h'
   within atol 1e-4 in f32; h' within one bf16 ulp (+1e-5 near 0) in bf16. Median times
   from CUDA events over back-to-back launches (queued behind a device sleep
   so host overhead does not show, W rotated through copies larger than the
   50 MB L2), beside the bound from bytes and operations.
4. Serving, the main path: write a DreamerV3-S / MsPacman artifact from the
   port's seeded initialiser (bf16-mixed), load it with InferenceEngine,
   serve it with PolicyServer on 127.0.0.1, check /healthz and /v1/models,
   send 4 sessions x 5 steps of POST /v1/act concurrently in greedy and in
   sample mode, check every action is in [0, 9), replay a session with its
   seed and observations and get the same actions, and check the kernel ran
   at least once per served batch. Then close with drain.
5. Step profile: host wall and device-busy time of one served batch of 4
   (torch.profiler), the device's idle share and the heaviest kernels.
6. Reference: the same weights at 32-true on the card (kernel) and on the
   CPU (plain version) step 5 times from the same generators; recurrent
   states must agree within 1e-3 and the actions must be equal.

Prints one ``{"kernels": [...]}`` line, the card's name and power limit,
and as the last line ``{"ok": true, "device": {...}}``. Details go to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}  # f32 outside the tensor cores; dense bf16
L2_BYTES = 50 * 1024 * 1024
MAIN_SHAPE = (8, 1024, 512, "bfloat16")  # DreamerV3-S at the default max serving bucket, bf16-mixed


def fail(message: str) -> None:
    print(f"chip_smoke: FAIL: {message}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(message: str) -> None:
    print(message, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, timeout=60
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def bf16_ulp(x):
    import torch

    _, e = torch.frexp(x.abs().clamp(min=2.0**-126))
    return torch.ldexp(torch.ones_like(x), e - 8)


def device_ms(fn, reps: int = 15, inner: int = 20) -> float:
    """Median device milliseconds per call: ``inner`` calls are queued behind
    a device sleep long enough to cover their enqueueing, between two events."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(inner):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    cycles = int(2 * host_s * 2e9)  # twice the enqueue time at about 2 GHz
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(max(cycles, 1_000_000))
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def kernel_split_ms(fn, calls: int = 50) -> dict:
    """Device ms per call of each CUDA kernel ``fn`` launches, from torch.profiler."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for evt in prof.key_averages():
        total_us = getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0.0)
        if total_us and evt.count:
            found = re.search(r"ln_gru_\w+", evt.key)
            name = found.group(0) if found else evt.key
            split[name] = split.get(name, 0.0) + total_us / calls / 1e3
    return split


def gru_inputs(batch, depth, hidden, dtype, seed=0):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    dev = torch.device("cuda")
    return (
        f(batch, depth).to(dev, dtype),
        (f(depth, 3 * hidden) / math.sqrt(depth)).to(dev, dtype),
        (0.1 * f(3 * hidden)).to(dev),
        (1.0 + 0.1 * f(3 * hidden)).to(dev),
        (0.1 * f(3 * hidden)).to(dev),
        f(batch, hidden).to(dev, dtype),
    )


def gru_bound(batch, depth, hidden, dtype) -> tuple:
    """(least ms, "bytes" or "operations"): each input read once, each output
    written once, against the product's operations at the dtype's peak."""
    e = 4 if dtype == "float32" else 2
    width = 3 * hidden
    nbytes = batch * depth * e + depth * width * e + 3 * width * 4 + 2 * batch * hidden * e + batch * width * 4
    ops = 2 * batch * depth * width
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def phase_kernels():
    import torch

    from sheeprl_tpu_torch.models.ln_gru import ln_gru_forward, ln_gru_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # DV3-S at every serving bucket of the default max_batch (1, 2, 4, 8) and at 64, unaligned, XL.
    shapes = [(1, 1024, 512), (2, 1024, 512), (4, 1024, 512), (8, 1024, 512), (64, 1024, 512), (3, 200, 100), (8, 5120, 4096)]
    rows = []
    for batch, depth, hidden in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            args = gru_inputs(batch, depth, hidden, dtype)
            before = ln_gru_forward.launches
            h_k, z_k = ln_gru_forward(*args)
            torch.cuda.synchronize()
            if ln_gru_forward.launches != before + 1:
                fail("ln_gru_forward did not count its launch")
            h_p, z_p = ln_gru_plain(*args)
            err_h = (h_k.float() - h_p.float()).abs()
            err_z = (z_k - z_p).abs()
            if not (torch.isfinite(h_k.float()).all() and torch.isfinite(z_k).all()):
                fail(f"ln_gru non-finite output at B={batch} D={depth} H={hidden} {dname}")
            if dtype == torch.float32:
                ok = bool((err_z <= 1e-4 + 1e-4 * z_p.abs()).all() and (err_h <= 1e-4).all())
            else:
                # One bf16 ulp, plus 1e-5 for the f32 difference before the final
                # rounding: near 0, h' = u*c + (1-u)*h cancels and f32 rounding
                # alone (|dh| <= 1.4e-6 in f32 runs) exceeds the bf16 spacing.
                ulp = bf16_ulp(torch.maximum(h_k.float().abs(), h_p.float().abs()))
                ok = bool((err_z <= 1e-4 + 1e-4 * z_p.abs()).all() and (err_h <= ulp + 1e-5).all())
            if not ok:
                fail(f"ln_gru disagrees with ln_gru_plain at B={batch} D={depth} H={hidden} {dname}: max |dh| {err_h.max().item()}, max |dz| {err_z.max().item()}")
            # Rotate W (and its inputs) through copies that exceed L2, as a
            # serving step finds W after the rest of the model has run.
            copies = max(1, math.ceil(2 * L2_BYTES / (args[1].numel() * args[1].element_size())))
            sets = [args] + [tuple(a.clone() for a in args) for _ in range(min(copies, 32) - 1)]
            cursor = [0]

            def run(fn):
                def call():
                    cursor[0] = (cursor[0] + 1) % len(sets)
                    fn(*sets[cursor[0]])

                return call

            kernel_ms = device_ms(run(ln_gru_forward))
            plain_ms = device_ms(run(ln_gru_plain))
            split = kernel_split_ms(run(ln_gru_forward)) if (batch, depth, hidden, dname) == MAIN_SHAPE else None
            bound_ms, bound_by = gru_bound(batch, depth, hidden, dname)
            row = {
                "shape": f"B={batch} D={depth} H={hidden}",
                "dtype": dname,
                "max_abs_err_h": err_h.max().item(),
                "max_abs_err_z": err_z.max().item(),
                "ms": kernel_ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
            }
            if split is not None:
                row["per_cuda_kernel_ms"] = split
                log(f"ln_gru {row['shape']} {dname}: device time per CUDA kernel (torch.profiler): {split}")
            rows.append(row)
            log(f"ln_gru {row['shape']} {dname}: ok, max|dh| {row['max_abs_err_h']:.3g}, max|dz| {row['max_abs_err_z']:.3g}, "
                f"kernel {kernel_ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us ({bound_by})")  # fmt: skip
            del sets, args
            torch.cuda.empty_cache()
    return rows


def http(address, path, body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(address + path, data=data, method="POST" if data is not None else "GET")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def phase_serving(workdir):
    import numpy as np

    from sheeprl_tpu_torch.algos.dreamer_v3.serve import export_random
    from sheeprl_tpu_torch.models.ln_gru import ln_gru_forward
    from sheeprl_tpu_torch.serve.cli import SERVE_DEFAULTS
    from sheeprl_tpu_torch.serve.engine import InferenceEngine
    from sheeprl_tpu_torch.serve.server import PolicyServer

    t0 = time.perf_counter()
    path = export_random(os.path.join(workdir, "dv3s.policy"), name="dv3s", seed=0, precision="bf16-mixed")
    engine = InferenceEngine(
        max_batch=SERVE_DEFAULTS["max_batch"],
        queue_capacity=SERVE_DEFAULTS["queue_capacity"],
        batch_window_s=SERVE_DEFAULTS["batch_window_ms"] / 1000.0,
        max_models=SERVE_DEFAULTS["max_models"],
        max_sessions=SERVE_DEFAULTS["max_sessions"],
        device="cuda",
    )
    card = engine.load("dv3s", path)
    server = PolicyServer(engine, host="127.0.0.1", port=0).start()
    log(f"serving: artifact written and loaded with warm-up in {time.perf_counter() - t0:.2f} s ({card['precision']} on {card['device']})")
    try:
        status, health = http(server.address, "/healthz")
        if status != 200 or health["models"] != ["dv3s"]:
            fail(f"/healthz: {status} {health}")
        status, models = http(server.address, "/v1/models")
        if status != 200 or models["models"]["dv3s"]["obs_keys"] != {"rgb": [64, 64, 3]}:
            fail(f"/v1/models: {status} {models}")

        sessions, steps = 4, 5
        rng = np.random.default_rng(0)
        obs = [[rng.integers(0, 256, (64, 64, 3), dtype=np.uint8).tolist() for _ in range(steps)] for _ in range(sessions)]
        barrier = threading.Barrier(sessions)

        def drive(mode, s):
            actions = []
            for t in range(steps):
                barrier.wait(timeout=60)  # the sessions' requests arrive together and share batches
                _, reply = http(server.address, "/v1/act", {"model": "dv3s", "obs": {"rgb": obs[s][t]}, "mode": mode, "seed": 100 + s, "session": f"{mode}-{s}"})
                actions.append(reply["action"])
            return actions

        # The main path: counts zeroed just before, read just after.
        engine.reset_stats()
        ln_gru_forward.launches = 0
        t1 = time.perf_counter()
        served = {}
        with ThreadPoolExecutor(sessions) as pool:
            for mode in ("greedy", "sample"):
                served[mode] = list(pool.map(lambda s: drive(mode, s), range(sessions)))
        wall_s = time.perf_counter() - t1
        launches = ln_gru_forward.launches
        stats = engine.stats()

        flat = [a for mode in served.values() for sess in mode for step in sess for a in step]
        if len(flat) != 2 * sessions * steps or not all(isinstance(a, int) and 0 <= a < 9 for a in flat):
            fail(f"served actions out of [0, 9): {flat}")
        if stats["counters"]["requests"] != 2 * sessions * steps or stats["counters"]["errors"]:
            fail(f"engine counters: {stats['counters']}")
        if launches < stats["counters"]["batches"]:
            fail(f"ln_gru launched {launches} times for {stats['counters']['batches']} batches")
        if not any(int(b) > 1 for b in stats["occupancy"]):
            fail(f"no batch had more than one row: {stats['occupancy']}")

        replay = []
        for t in range(steps):
            _, reply = http(server.address, "/v1/act", {"model": "dv3s", "obs": {"rgb": obs[0][t]}, "mode": "sample", "seed": 100, "session": "replay"})
            replay.append(reply["action"])
        if replay != served["sample"][0]:
            fail(f"replayed session differs: {replay} vs {served['sample'][0]}")
    finally:
        server.close(drain=True)
    lat = stats["latency"]
    result = {
        "requests": stats["counters"]["requests"],
        "batches": stats["counters"]["batches"],
        "occupancy": stats["occupancy"],
        "ln_gru_launches": launches,
        "latency_p50_ms": lat["p50"] * 1e3,
        "latency_p99_ms": lat["p99"] * 1e3,
        "wall_s": wall_s,
    }
    log(f"serving: {result['requests']} requests in {result['batches']} batches over {sessions} sessions, "
        f"occupancy {stats['occupancy']}, ln_gru launches {launches}, latency p50 {result['latency_p50_ms']:.2f} ms "
        f"p99 {result['latency_p99_ms']:.2f} ms, replay identical")  # fmt: skip
    return result, path


def phase_step_profile(path, bucket: int = 4, steps: int = 20):
    """Where one served batch's time goes: host wall per ``apply`` (to the
    actions on the host), the device's busy time per step from
    torch.profiler, and the kernels that take most of it."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch.serve.artifact import load_artifact, make_policy

    adapter = make_policy(load_artifact(path), torch.device("cuda"))
    state = adapter.stack_sessions([adapter.new_session(s) for s in range(bucket)])
    rng = np.random.default_rng(2)
    obs = adapter.pack_rows([adapter.normalize_row({"rgb": rng.integers(0, 256, (64, 64, 3))}) for _ in range(bucket)], bucket)
    seeds = np.zeros((bucket,), np.uint32)
    for _ in range(3):
        _, state = adapter.apply(obs, seeds, state, greedy=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        _, state = adapter.apply(obs, seeds, state, greedy=False)  # ends in a copy of the actions to the host
    wall_ms = (time.perf_counter() - t0) / steps * 1e3  # without the profiler's own overhead
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            _, state = adapter.apply(obs, seeds, state, greedy=False)
    kernels_ms, launches = {}, 0
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:  # kernels and copies, not the host ops that launched them
            total_us = getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0.0)
            kernels_ms[evt.key[:60]] = kernels_ms.get(evt.key[:60], 0.0) + total_us / steps / 1e3
            launches += evt.count
    busy_ms = sum(kernels_ms.values())
    top = dict(sorted(kernels_ms.items(), key=lambda kv: -kv[1])[:6])
    result = {"bucket": bucket, "host_wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy_ms,
              "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms), "device_ops_per_step": launches / steps,
              "top_device_ms_per_step": top}  # fmt: skip
    log(f"step profile (bucket {bucket}, bf16-mixed): host wall {wall_ms:.3f} ms/step, device busy {busy_ms:.3f} ms/step, "
        f"idle share {result['device_idle_share']:.3f}, {result['device_ops_per_step']:.0f} device ops/step, top {json.dumps({k: round(v, 4) for k, v in top.items()})}")  # fmt: skip
    return result


def phase_reference(path):
    """32-true on the card (kernel) against the CPU (plain version)."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import normalize_player_obs
    from sheeprl_tpu_torch.serve.artifact import load_artifact
    from sheeprl_tpu_torch.serve.spaces import spec_to_space
    from sheeprl_tpu_torch.utils.distribution import RowGenerators
    from sheeprl_tpu_torch.utils.utils import dotdict

    art = load_artifact(path)
    cfg = dotdict(art.spec["config"])
    agents = {
        dev: build_agent((9,), False, cfg, spec_to_space(art.spec["observation_space"]), precision="32-true", device=dev,
                         world_model_state=art.params["world_model"], actor_state=art.params["actor"])  # fmt: skip
        for dev in ("cuda", "cpu")
    }
    rng = np.random.default_rng(1)
    obs = [torch.from_numpy(rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)) for _ in range(5)]
    out = {}
    for dev, agent in agents.items():
        gens = RowGenerators.from_seeds([11, 12], dev)
        state = agent.init_player_state(2)
        trace = []
        for o in obs:
            _, real, state = agent.player_step(state, normalize_player_obs({"rgb": o.to(dev)}, ("rgb",)), gens, greedy=False)
            trace.append((state["recurrent_state"].float().cpu(), real.cpu()))
        out[dev] = trace
    worst = 0.0
    for (h_gpu, a_gpu), (h_cpu, a_cpu) in zip(out["cuda"], out["cpu"]):
        if not torch.isfinite(h_gpu).all():
            fail("non-finite recurrent state on the card")
        worst = max(worst, (h_gpu - h_cpu).abs().max().item())
        if not torch.equal(a_gpu, a_cpu):
            fail(f"card and CPU actions differ: {a_gpu.tolist()} vs {a_cpu.tolist()}")
    if worst > 1e-3:
        fail(f"card and CPU recurrent states differ by {worst}")
    log(f"reference: 5 player steps at 32-true, card (kernel) vs CPU (plain): max |dh| {worst:.3g}, actions equal")
    return worst


def main() -> None:
    import warnings

    import torch

    warnings.filterwarnings("ignore", message=".*Profiler clears events.*")

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    if not os.path.isdir(os.path.join(REPO, "sheeprl_tpu_torch")):
        fail(f"run from a checkout of the repository: no sheeprl_tpu_torch/ beside {__file__}")
    sys.path.insert(0, REPO)
    from sheeprl_tpu_torch import kernels

    card = nvidia_smi()
    log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    built = kernels.build()
    log(f"build: {built} in {time.perf_counter() - t0:.2f} s")
    for line in kernels.build_log("ln_gru").splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    rows = phase_kernels()
    workdir = os.path.join(str(kernels.BUILD_DIR), f"smoke-{os.getpid()}")
    os.makedirs(workdir, exist_ok=True)
    try:
        serving, path = phase_serving(workdir)
        step_profile = phase_step_profile(path)
        worst = phase_reference(path)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    main_row = next(r for r in rows if "per_cuda_kernel_ms" in r)
    kernels_line = {
        "kernels": [
            {
                "name": "ln_gru_forward",
                "route": "cuda",
                "source": "sheeprl_tpu_torch/csrc/ln_gru.cu",
                "replaces": "sheeprl_tpu/models/pallas_gru.py:118",
                "shapes": f"{main_row['shape']} {main_row['dtype']} (DreamerV3-S serving bucket 8)",
                "launches": serving["ln_gru_launches"],
                "max_abs_err": max(main_row["max_abs_err_h"], main_row["max_abs_err_z"]),
                "ms": main_row["ms"],
                "plain_ms": main_row["plain_ms"],
                "bound_ms": main_row["bound_ms"],
                "bound_by": main_row["bound_by"],
                "library_ms": None,
            }
        ]
    }
    report = {
        "card": card,
        "build_s": built,
        "ln_gru": rows,
        "serving": serving,
        "step_profile": step_profile,
        "reference_max_abs_dh": worst,
        "kernels": kernels_line["kernels"],
    }
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as fp:
        json.dump(report, fp, indent=2)
    print(json.dumps(kernels_line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
