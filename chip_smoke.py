#!/usr/bin/env python3
"""Drive the PyTorch port (sheeprl_tpu_torch) on one CUDA card and check it.

Run from the root of a checkout, on a machine with an H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. Device: a CUDA card must be present; print its name and power limit.
2. Build: compile every CUDA kernel of the port from csrc/ with nvcc, one
   nvcc per source, all at once.
3. The LN-GRU forward (the kernel ``forward_plan`` picks: streaming or
   tensor cores) against its plain version on the card: DreamerV3-S shapes
   (D=1024, H=512) at the serving buckets B = 1, 2, 4, 8, at the training
   path's B = 16 (dynamic scan) and B = 1024 (imagination) and at B = 64, an
   unaligned shape (B=3, D=200, H=100) and the XL shape (D=5120, H=4096,
   B=8), in f32 with TF32 off and in bf16. Tolerances: z within rtol 1e-4 /
   atol 1e-4 and h' within atol 1e-4 in f32; h' within one bf16 ulp (+1e-5
   near 0) in bf16. Median times (with the min and max of the repetitions)
   from CUDA events over back-to-back launches (queued behind a device sleep
   so host overhead does not show, inputs rotated through copies larger than
   the 50 MB L2), beside the bound from bytes and operations and beside
   cuBLAS's product alone (``torch.matmul(inp, w)``). The profiler's kernel
   split shows one ln_gru_* launch per call. Then both forward kernels at
   DV3-S bf16 and B = 16, 64, 128, 256, 1024, each held to the plain
   version and timed: the measurement behind ``TENSOR_CORE_MIN_BATCH``.
4. The LN-GRU backward against its plain version, at B = 16 and 1024
   (H = 512) and B = 3, H = 100, f32 and bf16 (tolerances in
   ``phase_backward``), timed the same way, one launch per call.
5. The cell's gradients on the card: LayerNormGRUCell (the autograd Function
   over both kernels) against torch autograd through the plain version.
6. Serving: write a DreamerV3-S / MsPacman artifact from the port's seeded
   initialiser (bf16-mixed), load it with InferenceEngine, serve it with
   PolicyServer on 127.0.0.1, check /healthz and /v1/models, send 4 sessions
   x 5 steps of POST /v1/act concurrently in greedy and in sample mode, check
   every action is in [0, 9), replay a session with its seed and
   observations and get the same actions, and check the kernel ran at least
   once per served batch (counts zeroed just before, read just after). Then
   close with drain. Then the served batch's step profile and a 32-true
   card-versus-CPU reference of 5 player steps.
7. Training, the main path: ``python -m sheeprl_tpu_torch
   exp=dreamer_v3_100k_ms_pacman env=dummy`` in process, DV3-S at full
   width, bf16-mixed, batch 16 x 64, horizon 15, the recipe's 100000-row
   replay buffer memory-mapped, with learning_starts and total_steps cut
   (listed in the output) so it takes 8 gradient steps, logging every 8
   policy steps and ending with the greedy test episode. Counts zeroed just
   before, read just after, and checked at every gradient step: 79 forward
   (64 streaming at B = 16, 15 on the tensor cores at B = 1024) and 64
   backward launches (B = 16). Finite losses; the target critic followed its
   EMA cadence; the actor's loss left the world model's and critic's
   gradients as they were; the world model, actor and critic moved. The
   run's TensorBoard file, read back with ``read_scalars``, holds every tag
   the JAX package logs at every log step where it logs it (the losses,
   ``Time/sps_train`` where a gradient step ran, the episode means where an
   episode ended, ``Params/replay_ratio`` = gradient steps / policy steps,
   ``Time/sps_env_interaction``, ``Test/cumulative_reward`` at step 0), all
   finite; the memmap files lie under ``memmap_buffer/rank_0/env_<i>`` at
   the recipe's size. Then the gradient step's profile (host wall, device
   busy, idle share, device operations within 1% of 17932, one backward's
   in-step time, peak memory) and a 32-true gradient step on the card
   against the CPU with the card's categorical draws replayed.
8. Continuous control, the second main path: ``python -m sheeprl_tpu_torch
   exp=dreamer_v3_dmc_walker_walk env=dummy env.id=continuous_dummy`` in
   process (6 actions in [-1, 1]), DV3-S at full width, bf16-mixed, batch
   16 x 64, horizon 15, the recipe's 500000-row replay buffer memory-mapped
   (125000 rows and 1.54 GB of pixels per env), with learning_starts,
   total_steps and checkpoint.every cut (listed in the output) so it takes
   8 gradient steps and writes a checkpoint after the 4th (its size and
   save time printed: it refers to the memmap files, it holds no copy of
   them), checked step by step, and its tags and files, as in 7:
   every gradient step must launch 64 backwards at B = 16 and 15 at
   B = 1024 (the pathwise actor gradient through the imagination, whose
   cells get no gradient of W or the LayerNorm's parameters) and 64 + 15
   forwards, with finite losses, leaving the world model's and critic's
   gradients untouched by the actor's loss. Then its step profile (launches
   by kernel and by batch, one backward's in-step time at B = 16 and at
   B = 1024), save and resume (the checkpoint's digest, every
   restored tensor bit-identical on the card, the resumed CLI run going on
   from gradient step 5), the checkpoint exported and served over HTTP (6
   actions in [-1, 1], greedy replays byte-identical), ``python -m
   sheeprl_tpu_torch.eval`` on its last checkpoint (a process of its own,
   on the card) logging the trainer's test reward, a 32-true continuous
   gradient step on the card against the CPU with the card's categorical
   and normal draws replayed, and device operations per step within 1% of
   18794.
9. Replay on the host: one walker env's memory-mapped buffer filled to its
   125000 rows (under the temporary directory), and one in memory;
   ``sample`` of 16 x 64 sequences plus the copy to the card timed from
   each, the memmap's page cache cold (the files unmapped and their pages
   dropped with ``posix_fadvise``; ``mincore`` reports what stayed) and
   warm. The same walker env's 125000 rows (1.54 GB) loaded into a replay
   ring on the card with ``load_host_buffer``, timed, and 16 x 64 sampled
   there, each window checked against the host buffer's rows of the same
   start; and the host path's sample and copy on the critical path,
   synchronous against ``buffer.prefetch`` (the copy on the infeed's
   worker thread while a 50 ms sleep stands in for the env step).
10. The captured step against the eager one (after 7, and after 8 for
   continuous actions): full DV3-S width, bf16-mixed, sampling a ring of
   1024 rows per env filled at the exp's shapes (MsPacman: 1 env; the
   walker: 4). The fused step's 3 eager warm-up steps (the first under
   ``torch.cuda.set_sync_debug_mode("error")``), then from one snapshot 8
   eager steps twice and 8 replays of the graph (taus 0.02, 0 and 1):
   every parameter, Adam state, the moments and each step's metrics bit
   for bit (or, were the two eager runs to differ, within their
   difference). The graph's nodes, read from the graph itself (libcuda's
   cuGraphGetNodes): 64 + 15 LN-GRU forward and 64 (discrete) or 79 (continuous)
   backward kernel nodes, beside the eager step's 17932 and 18794 device
   operations; the LN-GRU tickets back at zero after the replays. Then 16
   back-to-back replays timed (host wall, CUDA events) and profiled (device
   busy, operations, idle share as the eager step's: 1 - busy / the host
   wall without the profiler, at most 0.25), and 3 eager steps timed
   from the same state.
11. The discrete exp through the CLI with ``buffer.device=True``: the ring
   active at the recipe's 100000 rows (1.23 GB), all 8 gradient steps on
   the fused path (3 warm-up, 5 replays), the JAX package's tags read back,
   all finite.
12. The walker through the CLI with ``buffer.device=True
   algo.fused_train_steps=2``: the ring active at 4 x 125000 rows (6.16
   GB), 8 gradient steps in buckets of 2 on the fused path, the tags read
   back; then resumed from its mid-run checkpoint (the ring loaded from the
   checkpointed buffer), ending bit for bit on the uninterrupted fused
   run's parameters.

13. PPO on vector observations, a third main path: ``python -m
   sheeprl_tpu_torch exp=ppo env=dummy`` in process at the recipe's widths
   (64 units, 2 layers, 4 envs, 128 rollout steps, batch 64, 10 epochs,
   Adam lr 1e-3 eps 1e-4, 32-true), with total_steps and log_every cut
   (listed in the output) to 2 updates: finite losses at every update,
   every parameter tensor moved, the JAX package's tags at its steps read
   back with ``read_scalars``, and no LN-GRU launch (PPO has no recurrent
   cell; the counts zeroed just before, read just after). Then
   ``env.id=continuous_dummy`` for one update (the Normal head).
14. PPO on pixels: ``exp=ppo_atari env=dummy`` (84x84 rgb, 4 frames
   stacked: 12 channels, NatureCNN of 512 features, dense 512, 1 env, 1024
   rollout steps, batch 256, 3 epochs, lr and clip annealed,
   max_grad_norm 0.5), total_steps and checkpoint.every cut to 2 updates
   and a checkpoint after the first: checked as 13; resumed from that
   checkpoint (every restored tensor bit for bit on the card, the resumed
   update starting from them at the checkpoint's annealed learning rate);
   exported and served over HTTP (greedy repeats byte-identical, seeded
   samples repeatable, actions in range); ``python -m
   sheeprl_tpu_torch.eval`` in its own process logging the trainer's test
   reward.
15. PPO's profile for both exps (an update and a rollout step: host wall,
   device busy, idle share, device operations, peak memory; GAE on its
   own), and one ppo_atari update on the card against the CPU in 32-true
   from the same weights, data and permutation (tolerances in
   ``phase_ppo_reference``).
16. SAC, a fourth main path: ``python -m sheeprl_tpu_torch exp=sac
   env=dummy env.id=continuous_dummy`` in process at the recipe's widths
   (hidden 256, 2 critics, batch 256, replay ratio 1, Adam eps 1e-4,
   32-true, 4 envs, the 1000000-row buffer memory-mapped), cut in
   learning_starts, total_steps, checkpoint.every and log_every (listed in
   the output) to 117 gradient steps with a checkpoint at policy step 96:
   the loop's gradient steps, finite losses, the JAX package's tags, no
   LN-GRU launch (counts zeroed before, read after); resumed from that
   checkpoint it ends on the uninterrupted run's parameters and Adam states
   bit for bit; its last checkpoint exported (the actor only) and served
   over HTTP (greedy actions the trained agent's bit for bit and repeated
   byte-identical, samples repeatable per seed); ``python -m
   sheeprl_tpu_torch.eval`` on it; then the same run with
   ``buffer.device=True algo.fused_train_steps=16`` (the ring path's
   captured step).
17. One SAC update (4 gradient steps) on the card against the CPU in
   32-true from the same weights, batches and draws, per parameter leaf
   and per Adam moment, with two planted faults it must reject
   (``phase_sac_reference``).
18. DroQ through the CLI at replay ratio 20 (dropout 0.01, LayerNorm), on
   the host path and with ``buffer.device=True algo.fused_train_steps=16``
   (the critic graph and the actor graph both replayed), checked as 16.
19. SAC's and DroQ's ring paths: the captured steps against their eager
   steps, bit for bit over 8 gradient steps from one snapshot, sampling a
   4096-row ring per env (4 envs); the graphs' nodes (no LN-GRU node); 16
   back-to-back replays profiled.
20. The host path of both, 16 gradient steps in one train call, profiled:
   per gradient step host wall, device busy, idle share, device
   operations, peak memory, no LN-GRU launch.
21. DreamerV2's LN-GRU shapes: ``ln_gru_forward`` (planned on the streaming
   kernel: H = 600 is no multiple of 64), ``ln_gru_forward_streaming`` and
   ``ln_gru_backward`` against their plain versions at B = 32, 1600 and 4,
   D = 1000, H = 600, f32 and bf16, a non-zero dense bias; timed beside
   the plain versions, the bounds and cuBLAS's product alone.
22. DreamerV2, a fifth main path: ``python -m sheeprl_tpu_torch
   exp=dreamer_v2_ms_pacman env=dummy`` in process at full width
   (bf16-mixed, batch 32 x 50, horizon 15, recurrent state 600, the
   episodic buffer memory-mapped with prioritize_ends at 2000000 rows), cut
   (listed in the output) to 8 gradient steps and a checkpoint after the
   4th; every gradient step launches 50 + 15 forwards (B = 32, 1600) and
   50 + 15 backwards, the run none on the tensor cores (counts zeroed just
   before, read at every step); the episodes' files; resumed bit for bit
   (modules and Adam states); ``eval`` on its last checkpoint.
23. The DV2 gradient step's profile (host wall, device busy and idle share,
   operations, peak memory, the LN-GRU kernels' share of busy).
24. One full-width DV2 gradient step (B = 4, T = 16) on the card against
   the CPU with the card's draws replayed, in 32-true (losses, each leaf's
   change, the LN-GRU dense bias's gradient) and in bf16-mixed (the dense
   bias's gradient and its Adam update), with two planted faults the leaf
   check must reject (tolerances in ``phase_dv2_reference``).
25. DreamerV1: ``exp=dreamer_v1 env=dummy`` at the recipe's widths, 8
   gradient steps, resumed bit for bit, ``eval``; no LN-GRU launch.
26. A2C, a sixth main path: ``python -m sheeprl_tpu_torch exp=a2c
   env=dummy`` in process at the recipe's widths (dense 64, 2 tanh layers,
   4 envs x 5 rollout steps, 4 minibatches of 5 summed into one RMSprop
   step, eps 1e-4 inside the root, 32-true), total_steps, log_every and
   checkpoint.every cut (listed in the output) to 20 updates and a
   checkpoint after the 10th: finite losses, every parameter moved, the JAX
   package's tags (no ``Info/*``) at its steps, no LN-GRU launch; resumed
   from that checkpoint (every tensor restored bit for bit on the card, the
   resumed update starting from them); ``eval`` in its own process logging
   the trainer's test reward; the trained agent's update and rollout step
   profiled as 28.
27. Recurrent PPO, a seventh main path: ``exp=ppo_recurrent env=dummy``
   (LSTM 64, encoder 64 with LayerNorm, 16 envs x 512 rollout steps,
   sequences of 16, 8 batches, 8 epochs: 64 AdamW steps an update), cut to
   2 updates and a checkpoint after the first; checked, resumed and
   evaluated as 26.
28. Recurrent PPO's profile: one update and one rollout step of the
   trained agent (host wall, device busy, idle share, operations, peak
   memory).
29. One A2C update on the card against the CPU in 32-true from the same
   weights, rollout and minibatches, per parameter leaf and per RMSprop
   accumulator leaf within 2e-3, with two planted faults it must reject.
30. Recurrent PPO on the card against the CPU the same way: its update's
   first AdamW step within 2e-3 per parameter and moment leaf, its whole
   update (64 AdamW steps) within PPO's bounds (``onpolicy_reference``).
31. The LN-GRU entry points at P2E-DV3's shapes (D = 5120, H = 4096,
   32-true: H > 512 fails ``tensor_core_fits``, so every forward streams),
   B = 16 (the dynamic scan) and 1024 (the imaginations), against their
   plain versions, timed beside them, the bounds and cuBLAS's product alone.
32. P2E-DV3, an eighth main path: ``python -m sheeprl_tpu_torch
   exp=p2e_dv3_exploration env=dummy`` in process at the exp's XL widths
   (dense 1024 x 5, recurrent state 4096, batch 16 x 64, horizon 15, an
   ensemble of 8, two exploration critics), cut (listed in the output) to 8
   gradient steps and a checkpoint after the 4th; every gradient step
   launches 64 + 30 forwards (B = 16, 1024) and 64 backwards, the run none
   on the tensor cores (counts zeroed just before, read at every step); the
   per-critic tags; resumed bit for bit (every module and optimizer);
   ``eval``; finetuning without ``checkpoint.exploration_ckpt_path``
   refused; ``exp=p2e_dv3_finetuning`` from the exploration checkpoint (the
   exploration actor plays the prefill, the task actor after it; 64 + 15
   forwards and 64 backwards a step) and its ``eval``.
33. The XL exploration step's profile (host wall, device busy and idle
   share, operations, peak memory, the LN-GRU kernels' share of busy, the
   ``p2e/*`` stages).
34. One P2E-DV3 exploration step at DreamerV3-S widths on the card against
   the CPU in 32-true, discrete and continuous, the card's draws replayed:
   every metric and every parameter leaf's change within 2e-3; the card's
   step from weights one ulp away reported; three planted faults (the
   unbiased variance in the intrinsic reward, the ensemble updated after
   the exploration actor, the critics' weights not normalised) must read
   above the bound.
35-36. P2E-DV2 at its exp's widths (recurrent state 400, D = 800, 32-true,
   batch 16 x 50): the LN-GRU entry points at B = 16 and 800 against their
   plain versions and timed; ``exp=p2e_dv2_exploration`` through the CLI
   (8 gradient steps of 50 + 30 forwards and 50 + 30 backwards), resumed
   bit for bit, ``eval``, finetuning refused without its checkpoint and
   run from it (50 + 15 each a step), ``eval``.
37-38. P2E-DV1, a ninth main path: ``exp=p2e_dv1_exploration env=dummy``
   through the CLI at the recipe's widths (DreamerV1 at recurrent state
   400, dense 400, batch 50 x 50, an ensemble of 10 predicting the next
   embedding), 8 gradient steps, no LN-GRU launch at all, resumed bit for
   bit, ``eval``; ``exp=p2e_dv1_finetuning`` from its checkpoint, resumed
   bit for bit, ``eval``; the exploration step profiled.
39. SAC-AE, a tenth main path: ``exp=sac_ae env=dummy
   env.id=continuous_dummy`` through the CLI at the recipe's widths (64 x 64
   pixels, convolutions of 512 channels, batch 128), its cadences cut so
   that the 19 gradient steps meet every combination of the actor, EMA and
   decoder flags, no LN-GRU launch; resumed bit for bit; ``eval``.
40. One SAC-AE step with every flag on and one with none, profiled: host
   wall, busy, idle share, operations, peak memory, the cuDNN convolution
   kernels and their f32 rate against the convolutions' FLOPs reckoned
   from the shapes (``sac_ae_conv_flops``).
41. Card against CPU for one step of each (P2E-DV1 exploration at B = 4,
   T = 16; SAC-AE with every flag on at B = 8), from the same moved weights
   and draws, within 2e-3 per metric and leaf (SAC-AE's Adam moments
   included), the card from weights one ulp away reported, planted faults
   (P2E-DV1: ddof 1, the exploration critic on the task reward; SAC-AE: the
   actor's features not detached, the encoder's EMA at the critics' tau,
   the pixels' target at 8 bits) read above the bound.

Every profile reads its device busy time through ``_busy``, which leaves
out the device ranges of ``record_function`` annotations (the trainers'
spans and ``Optimizer.step``): they span kernels already counted.

Prints one ``{"kernels": [...]}`` line (the streaming forward at B = 16,
the tensor-core forward at B = 1024, the backward at B = 16 and at
B = 1024, each with its nodes in the captured step's graph and its
launches by the fused runs' replays; then DreamerV2's streaming forward and
backward at B = 32 and 1600, where the JAX package itself runs its plain
path: its ``_eligible`` takes H % 128 == 0 only; then P2E-DV3's forward at
B = 16 and 1024 and backward at B = 16, H = 4096, with the launches of the
exploration and the finetuning runs, and P2E-DV2's forward and backward at
B = 16 and 800, H = 400; every entry with the P2E-DV1 and SAC-AE runs'
launches, 0), the card's name and power limit,
and as the last line ``{"ok": true, "device": {...}}``. Details go to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import functools
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from contextlib import ExitStack, contextmanager

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


def time_phases(namespace: dict) -> dict:
    """Wrap every ``phase_*`` function of ``namespace`` (a module's globals)
    so that each outermost call adds its wall seconds to the returned dict
    under the phase's name; a phase that another phase calls counts in its
    caller's time."""
    seconds: dict = {}
    depth = [0]

    def timed(name, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            depth[0] += 1
            try:
                return fn(*args, **kwargs)
            finally:
                depth[0] -= 1
                if depth[0] == 0:
                    seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0

        return wrapper

    for name, fn in list(namespace.items()):
        if name.startswith("phase_") and callable(fn):
            namespace[name] = timed(name, fn)
    return seconds


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


def device_ms(fn, reps: int = 15, inner: int = 20) -> tuple:
    """(median, min, max) device milliseconds per call over ``reps``
    repetitions: each times ``inner`` calls queued behind a device sleep long
    enough to cover their enqueueing, between two events. The spread shows a
    one-off repetition as such."""
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
    return statistics.median(times), min(times), max(times)


PROFILE_MARKERS = 2048  # marker kernels ahead of each profiled call
MARKER_KERNEL = "spin_kernel"  # torch.cuda._sleep's kernel: nothing else in a capture launches it


def profiled(fn, activities=("cuda",), captures: int = 3):
    """torch.profiler over one call of ``fn``, after ``PROFILE_MARKERS``
    marker kernels (``torch.cuda._sleep(1000)``, about a microsecond each)
    and a synchronize. On an H100 with torch 2.11 the tracer loses the
    first device records of some captures while it keeps their host-side
    launch calls: all of them (an empty capture) or some (a discrete DV3
    step has read 17168 operations where it launches 17929). The markers
    take that loss in place of ``fn``'s records: a capture in which
    no marker was recorded may have lost some of ``fn``'s and is taken
    again, up to ``captures`` times, then the script fails. ``_busy`` and
    ``kernel_split_ms`` leave the markers out."""
    import torch

    kinds = {"cpu": torch.profiler.ProfilerActivity.CPU, "cuda": torch.profiler.ProfilerActivity.CUDA}
    for capture in range(1, captures + 1):
        with torch.profiler.profile(activities=[kinds[a] for a in activities]) as prof:
            for _ in range(PROFILE_MARKERS):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        markers = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA and MARKER_KERNEL in e.name)
        if markers < PROFILE_MARKERS:
            log(f"profile: capture {capture} of {captures} lost its first {PROFILE_MARKERS - markers} device records "
                f"({markers} of {PROFILE_MARKERS} markers recorded){'' if markers else '; taken again'}")  # fmt: skip
        if markers:
            return prof
    fail(f"torch.profiler lost the first device records of {captures} captures in a row (no marker kernel recorded)")


def kernel_split_ms(fn, calls: int = 50) -> dict:
    """Device ms and launches per call of each CUDA kernel ``fn`` launches,
    from torch.profiler: {name: {"ms": ..., "launches": ...}}."""
    import torch

    fn()
    torch.cuda.synchronize()
    prof = profiled(lambda: [fn() for _ in range(calls)])
    split = {}
    for evt in prof.key_averages():
        total_us = getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0.0)
        if total_us and evt.count and MARKER_KERNEL not in evt.key:
            found = re.search(r"ln_gru_\w+", evt.key)
            name = found.group(0) if found else evt.key
            entry = split.setdefault(name, {"ms": 0.0, "launches": 0.0})
            entry["ms"] += total_us / calls / 1e3
            entry["launches"] += evt.count / calls
    return split


def check_one_launch(what: str, split: dict) -> None:
    """Each call of an LN-GRU wrapper is one launch of one ln_gru_* kernel:
    one kernel name and at most one launch per call. (The profiler drops some
    events of short back-to-back kernels: up to a fifth of them in one run,
    so fewer than one launch per call is what it shows, not what ran.)"""
    gru = {k: v for k, v in split.items() if k.startswith("ln_gru")}
    if len(gru) != 1 or not 0.0 < next(iter(gru.values()))["launches"] <= 1.0 + 1e-9:
        fail(f"{what}: expected one ln_gru_* kernel launch per call, the profiler saw {split}")


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


def rotated(args, fn):
    """A call of ``fn`` on one of several copies of ``args`` that together
    exceed L2, so each call finds its inputs in HBM."""
    nbytes = sum(a.numel() * a.element_size() for a in args)
    copies = max(1, math.ceil(2 * L2_BYTES / nbytes))
    sets = [args] + [tuple(a.clone() for a in args) for _ in range(min(copies, 32) - 1)]
    cursor = [0]

    def call():
        cursor[0] = (cursor[0] + 1) % len(sets)
        fn(*sets[cursor[0]])

    return call


def timed(fn, reps: int = 15, inner: int = 20) -> dict:
    """ms (the median) beside the spread of ``device_ms``."""
    med, lo, hi = device_ms(fn, reps, inner)
    return {"ms": med, "ms_min": lo, "ms_max": hi}


def check_forward(fn, args, what) -> dict:
    """One call of a forward launcher against ln_gru_plain on the same
    inputs: z within rtol 1e-4 / atol 1e-4 and h' within atol 1e-4 in f32;
    h' within one bf16 ulp (+1e-5 near 0) in bf16."""
    import torch

    from sheeprl_tpu_torch.models.ln_gru import ln_gru_plain

    h_k, z_k = fn(*args)
    torch.cuda.synchronize()
    h_p, z_p = ln_gru_plain(*args)
    err_h = (h_k.float() - h_p.float()).abs()
    err_z = (z_k - z_p).abs()
    if not (torch.isfinite(h_k.float()).all() and torch.isfinite(z_k).all()):
        fail(f"{what}: non-finite output")
    if args[0].dtype == torch.float32:
        ok = bool((err_z <= 1e-4 + 1e-4 * z_p.abs()).all() and (err_h <= 1e-4).all())
    else:
        # One bf16 ulp, plus 1e-5 for the f32 difference before the final
        # rounding: near 0, h' = u*c + (1-u)*h cancels and f32 rounding
        # alone (|dh| <= 1.4e-6 in f32 runs) exceeds the bf16 spacing.
        ulp = bf16_ulp(torch.maximum(h_k.float().abs(), h_p.float().abs()))
        ok = bool((err_z <= 1e-4 + 1e-4 * z_p.abs()).all() and (err_h <= ulp + 1e-5).all())
    if not ok:
        fail(f"{what} disagrees with ln_gru_plain: max |dh| {err_h.max().item()}, max |dz| {err_z.max().item()}")
    return {"max_abs_err_h": err_h.max().item(), "max_abs_err_z": err_z.max().item()}


def phase_kernels():
    """ln_gru_forward (the kernel its plan picks) against ln_gru_plain at
    every shape, timed beside the plain version, cuBLAS's product alone
    (``torch.matmul(inp, w)``, the yardstick for the product part; no one
    PyTorch call computes the whole step) and the bound."""
    import torch

    from sheeprl_tpu_torch.models.ln_gru import _aligned, _sm_count, forward_plan, ln_gru_forward, ln_gru_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # DV3-S at every serving bucket of the default max_batch (1, 2, 4, 8) and at 64, unaligned, XL.
    # ... and at the training path's B = 16 (dynamic scan) and B = 1024 (imagination).
    shapes = [(1, 1024, 512), (2, 1024, 512), (4, 1024, 512), (8, 1024, 512), (16, 1024, 512), (64, 1024, 512),
              (1024, 1024, 512), (3, 200, 100), (8, 5120, 4096)]  # fmt: skip
    rows = []
    for batch, depth, hidden in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            args = gru_inputs(batch, depth, hidden, dtype)
            what = f"ln_gru B={batch} D={depth} H={hidden} {dname}"
            plan = forward_plan(batch, depth, hidden, dtype, _sm_count(0), _aligned(args[0], args[1], args[5]))
            before = ln_gru_forward.launches
            errs = check_forward(ln_gru_forward, args, what)
            if ln_gru_forward.launches != before + 1:
                fail("ln_gru_forward did not count its launch")
            # W and its inputs rotate through copies that exceed L2, as a
            # serving step finds W after the rest of the model has run.
            kernel = timed(rotated(args, ln_gru_forward))
            plain_ms = device_ms(rotated(args, ln_gru_plain))[0]
            product_ms = device_ms(rotated(args[:2], torch.matmul))[0]
            split = kernel_split_ms(rotated(args, ln_gru_forward))
            check_one_launch(what, split)
            bound_ms, bound_by = gru_bound(batch, depth, hidden, dname)
            row = {"shape": f"B={batch} D={depth} H={hidden}", "dtype": dname, "kernel": plan.kernel, **errs, **kernel,
                   "plain_ms": plain_ms, "product_library_ms": product_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                   "per_cuda_kernel": split}  # fmt: skip
            rows.append(row)
            log(f"{what}: ok on {plan.kernel}, max|dh| {row['max_abs_err_h']:.3g}, max|dz| {row['max_abs_err_z']:.3g}, "
                f"kernel {kernel['ms'] * 1e3:.2f} us [{kernel['ms_min'] * 1e3:.2f}, {kernel['ms_max'] * 1e3:.2f}], plain {plain_ms * 1e3:.2f} us, "
                f"product alone {product_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us ({bound_by}); {json.dumps(split)}")  # fmt: skip
            del args
            torch.cuda.empty_cache()
    return rows


THRESHOLD_BATCHES = (16, 64, 128, 256, 1024)


def phase_threshold():
    """Both forward kernels at DV3-S (D = 1024, H = 512) bf16 and B = 16, 64,
    128, 256, 1024, each held to ln_gru_plain and timed: the measurement
    behind TENSOR_CORE_MIN_BATCH in models/ln_gru.py."""
    import torch

    from sheeprl_tpu_torch import kernels
    from sheeprl_tpu_torch.models.ln_gru import TC_GATES, ln_gru_forward_streaming, ln_gru_forward_tensor_core

    fits = kernels.load("ln_gru_tc").ln_gru_tc_max_active_clusters
    clusters = fits(512 // TC_GATES, 0)
    log(f"threshold: the card holds {clusters} tensor-core clusters of {512 // TC_GATES} CTAs at once "
        f"(B = 1024 needs {1024 // 64})")  # fmt: skip
    if clusters < 1024 // 64:
        fail(f"only {clusters} clusters of the tensor-core kernel fit at once: B = 1024 takes two waves")
    rows = []
    for batch in THRESHOLD_BATCHES:
        args = gru_inputs(batch, 1024, 512, torch.bfloat16, seed=1)
        row = {"batch": batch}
        for name, fn in (("streaming", ln_gru_forward_streaming), ("tensor_core", ln_gru_forward_tensor_core)):
            before = fn.launches
            errs = check_forward(fn, args, f"ln_gru {name} B={batch} D=1024 H=512 bfloat16")
            if fn.launches != before + 1:
                fail(f"ln_gru_forward_{name} did not count its launch")
            row[name] = {**errs, **timed(rotated(args, fn))}
        row["product_library_ms"] = device_ms(rotated(args[:2], torch.matmul))[0]
        row["bound_ms"] = gru_bound(batch, 1024, 512, "bfloat16")[0]
        row["tensor_core_clusters_at_once"] = clusters
        rows.append(row)
        log(f"threshold B={batch} bf16: streaming {row['streaming']['ms'] * 1e3:.2f} us, tensor core {row['tensor_core']['ms'] * 1e3:.2f} us, "
            f"product alone {row['product_library_ms'] * 1e3:.2f} us, bound {row['bound_ms'] * 1e3:.2f} us")  # fmt: skip
        del args
        torch.cuda.empty_cache()
    return rows


def gru_bwd_bound(batch, hidden, dtype) -> tuple:
    """(least ms, "bytes" or "operations") of the LN-GRU tail's backward:
    g, h and dh_tail in the compute dtype, z and dz in f32, scale, ln_bias,
    dscale and dln_bias in f32 read or written once; 40 f32 operations per z
    element (statistics, gates, their derivatives, the two row means)."""
    e = 4 if dtype == "float32" else 2
    width = 3 * hidden
    nbytes = 3 * batch * hidden * e + 2 * batch * width * 4 + 4 * width * 4
    ops = 40 * batch * width
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S["float32"]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def check_backward(args, what) -> dict:
    """One call of ``ln_gru_backward`` against ``ln_gru_backward_plain`` on
    the same inputs (its launch counted): dz, dscale and dln_bias within
    atol 1e-4 + rtol 1e-4 (f32 sums over 3H and over B in another order);
    dh_tail within 1e-6 in f32 and one bf16 ulp (+1e-5) in bf16, the
    rounding of its final cast. Returns each output's max |d|."""
    import torch

    from sheeprl_tpu_torch.models.ln_gru import ln_gru_backward, ln_gru_backward_plain

    before = ln_gru_backward.launches
    got = ln_gru_backward(*args)
    torch.cuda.synchronize()
    if ln_gru_backward.launches != before + 1:
        fail("ln_gru_backward did not count its launch")
    want = ln_gru_backward_plain(*args)
    errs = {}
    for name, x, y in zip(("dz", "dscale", "dln_bias"), got[:3], want[:3]):
        if not torch.isfinite(x).all():
            fail(f"{what}: non-finite {name}")
        errs[name] = (x - y).abs().max().item()
        if not bool(((x - y).abs() <= 1e-4 + 1e-4 * y.abs()).all()):
            fail(f"{what}: {name} disagrees with the plain version: max |d| {errs[name]}")
    dh_k, dh_p = got[3].float(), want[3].float()
    errs["dh_tail"] = (dh_k - dh_p).abs().max().item()
    allowed = 1e-6 if args[4].dtype == torch.float32 else bf16_ulp(torch.maximum(dh_k.abs(), dh_p.abs())) + 1e-5
    if not bool(((dh_k - dh_p).abs() <= allowed).all()):
        fail(f"{what}: dh_tail disagrees: max |d| {errs['dh_tail']}")
    return errs


def phase_backward():
    """ln_gru_backward against ln_gru_backward_plain on the card, at the
    training path's shapes: the dynamic scan's B = 16 and imagination's
    B = 1024 (D = 1024, H = 512), and an unaligned B = 3, H = 100; f32 with
    TF32 off and bf16. z is the forward kernel's own output. Tolerances: dz,
    dscale and dln_bias within atol 1e-4 + rtol 1e-4 (f32 sums over 3H and
    over B in another order); dh_tail within 1e-6 in f32 and one bf16 ulp
    (+1e-5) in bf16, the rounding of its final cast."""
    import torch

    from sheeprl_tpu_torch.models.ln_gru import ln_gru_backward, ln_gru_backward_plain, ln_gru_forward

    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    for batch, depth, hidden in [(16, 1024, 512), (1024, 1024, 512), (3, 200, 100)]:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            inp, w, b, scale, ln_bias, h = gru_inputs(batch, depth, hidden, dtype, seed=3)
            _, z = ln_gru_forward(inp, w, b, scale, ln_bias, h)
            g = gru_inputs(batch, 1, hidden, dtype, seed=4)[5]
            args = (g, z, scale, ln_bias, h)
            errs = check_backward(args, f"ln_gru_backward B={batch} H={hidden} {dname}")
            kernel = timed(rotated(args, ln_gru_backward))
            kernel_ms = kernel["ms"]
            plain_ms = device_ms(rotated(args, ln_gru_backward_plain))[0]
            split = kernel_split_ms(rotated(args, ln_gru_backward))
            check_one_launch(f"ln_gru_backward B={batch} H={hidden} {dname}", split)
            bound_ms, bound_by = gru_bwd_bound(batch, hidden, dname)
            row = {"shape": f"B={batch} H={hidden}", "dtype": dname, "max_abs_err": errs, **kernel,
                   "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "per_cuda_kernel": split}  # fmt: skip
            rows.append(row)
            log(f"ln_gru_backward {row['shape']} {dname}: ok, max|d| {json.dumps({k: float(f'{v:.3g}') for k, v in errs.items()})}, "
                f"kernel {kernel_ms * 1e3:.2f} us [{kernel['ms_min'] * 1e3:.2f}, {kernel['ms_max'] * 1e3:.2f}], plain {plain_ms * 1e3:.2f} us, "
                f"bound {bound_ms * 1e3:.2f} us ({bound_by}); {json.dumps(split)}")  # fmt: skip
            torch.cuda.empty_cache()
    return rows


def phase_cell_grad():
    """The cell gets its gradients on the card: LayerNormGRUCell (the
    autograd Function over both kernels) against torch autograd through
    ln_gru_plain on the same CUDA tensors, f32 with TF32 off, at the dynamic
    scan's DV3-S shape (B = 16, D = 1024, H = 512). Every gradient (the
    cell's weight and LayerNorm, its input x and its state h) within atol
    1e-4 + rtol 1e-4: f32 products over B or 3H in another order."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch.models.ln_gru import ln_gru_backward, ln_gru_forward, ln_gru_plain
    from sheeprl_tpu_torch.models.models import LayerNormGRUCell

    torch.backends.cuda.matmul.allow_tf32 = False
    batch, in_dim, hidden = 16, 512, 512
    rng = np.random.default_rng(5)
    dev = torch.device("cuda")
    cell = LayerNormGRUCell(in_dim, hidden, bias=False).to(dev)
    with torch.no_grad():
        cell.weight.copy_(torch.from_numpy(rng.standard_normal(tuple(cell.weight.shape)).astype(np.float32) / 32.0))
        cell.norm.weight.copy_(torch.from_numpy(1.0 + 0.1 * rng.standard_normal(3 * hidden).astype(np.float32)))
        cell.norm.bias.copy_(torch.from_numpy(0.1 * rng.standard_normal(3 * hidden).astype(np.float32)))
    h0 = torch.from_numpy(rng.standard_normal((batch, hidden)).astype(np.float32)).to(dev)
    x0 = torch.from_numpy(rng.standard_normal((batch, in_dim)).astype(np.float32)).to(dev)
    target = torch.from_numpy(rng.standard_normal((batch, hidden)).astype(np.float32)).to(dev)

    h, x = h0.clone().requires_grad_(), x0.clone().requires_grad_()
    fwd, bwd = ln_gru_forward.launches, ln_gru_backward.launches
    ((cell(h, x) - target) ** 2).sum().backward()
    torch.cuda.synchronize()
    if ln_gru_forward.launches != fwd + 1 or ln_gru_backward.launches != bwd + 1:
        fail("the cell's step did not launch the forward and backward kernels once each")
    got = {"weight": cell.weight.grad, "norm.weight": cell.norm.weight.grad, "norm.bias": cell.norm.bias.grad,
           "x": x.grad, "h": h.grad}  # fmt: skip
    missing = [k for k, v in got.items() if v is None]
    if missing:
        fail(f"the cell got no gradient on the card for {missing}")

    w = cell.weight.detach().clone().requires_grad_()
    scale = cell.norm.weight.detach().clone().requires_grad_()
    ln_b = cell.norm.bias.detach().clone().requires_grad_()
    hp, xp = h0.clone().requires_grad_(), x0.clone().requires_grad_()
    out, _ = ln_gru_plain(torch.cat([hp, xp], -1), w, torch.zeros(3 * hidden, device=dev), scale, ln_b, hp)
    ((out - target) ** 2).sum().backward()
    want = {"weight": w.grad, "norm.weight": scale.grad, "norm.bias": ln_b.grad, "x": xp.grad, "h": hp.grad}
    errs = {}
    for name in want:
        d = (got[name] - want[name]).abs()
        errs[name] = d.max().item()
        if not bool((d <= 1e-4 + 1e-4 * want[name].abs()).all()):
            fail(f"cell gradient {name} on the card disagrees with autograd through ln_gru_plain: max |d| {errs[name]}")
    log(f"cell gradients on the card (B={batch} D={in_dim + hidden} H={hidden} f32) match autograd through ln_gru_plain: "
        f"max|d| {json.dumps({k: float(f'{v:.3g}') for k, v in errs.items()})}")  # fmt: skip
    return errs


def http(address, path, body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(address + path, data=data, method="POST" if data is not None else "GET")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def phase_serving(workdir):
    import numpy as np

    from sheeprl_tpu_torch.algos.dreamer_v3.serve import export_random
    from sheeprl_tpu_torch.models.ln_gru import ln_gru_forward, ln_gru_forward_streaming, ln_gru_forward_tensor_core
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
        ln_gru_forward.launches = ln_gru_forward_streaming.launches = ln_gru_forward_tensor_core.launches = 0
        t1 = time.perf_counter()
        served = {}
        with ThreadPoolExecutor(sessions) as pool:
            for mode in ("greedy", "sample"):
                served[mode] = list(pool.map(lambda s: drive(mode, s), range(sessions)))
        wall_s = time.perf_counter() - t1
        launches = ln_gru_forward.launches
        by_kernel = {"streaming": ln_gru_forward_streaming.launches, "tensor_core": ln_gru_forward_tensor_core.launches}
        stats = engine.stats()

        flat = [a for mode in served.values() for sess in mode for step in sess for a in step]
        if len(flat) != 2 * sessions * steps or not all(isinstance(a, int) and 0 <= a < 9 for a in flat):
            fail(f"served actions out of [0, 9): {flat}")
        if stats["counters"]["requests"] != 2 * sessions * steps or stats["counters"]["errors"]:
            fail(f"engine counters: {stats['counters']}")
        if by_kernel["streaming"] < stats["counters"]["batches"] or by_kernel["streaming"] + by_kernel["tensor_core"] != launches:
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
        "ln_gru_launches_by_kernel": by_kernel,
        "latency_p50_ms": lat["p50"] * 1e3,
        "latency_p99_ms": lat["p99"] * 1e3,
        "wall_s": wall_s,
    }
    log(f"serving: {result['requests']} requests in {result['batches']} batches over {sessions} sessions, "
        f"occupancy {stats['occupancy']}, ln_gru launches {launches} {json.dumps(by_kernel)}, latency p50 {result['latency_p50_ms']:.2f} ms "
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
    def profiled_steps():
        nonlocal state
        for _ in range(steps):
            _, state = adapter.apply(obs, seeds, state, greedy=False)

    prof = profiled(profiled_steps, ("cpu", "cuda"))
    kernels_ms = {}  # kernels and copies, not the host ops that launched them
    busy_ms, ops_per_step, _ = _busy(prof.key_averages(), steps, by_kernel=kernels_ms)
    top = dict(sorted(kernels_ms.items(), key=lambda kv: -kv[1])[:6])
    result = {"bucket": bucket, "host_wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy_ms,
              "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms), "device_ops_per_step": ops_per_step,
              "top_device_ms_per_step": top}  # fmt: skip
    log(f"step profile (bucket {bucket}, bf16-mixed): host wall {wall_ms:.3f} ms/step, device busy {busy_ms:.3f} ms/step, "
        f"idle share {result['device_idle_share']:.3f}, {result['device_ops_per_step']:.0f} device ops/step, top {json.dumps({k: round(v, 4) for k, v in top.items()})}")  # fmt: skip
    return result


def phase_reference(path):
    """32-true on the card (kernel) against the CPU (plain version)."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.utils.utils import normalize_obs
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
            _, real, state = agent.player_step(state, normalize_obs({"rgb": o.to(dev)}, ("rgb",)), gens, greedy=False)
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


# The training path's run: DreamerV3-S at full width on the dummy env at
# MsPacman's shapes, bf16-mixed, batch 16 x 64, horizon 15. Only these are
# cut from exp=dreamer_v3_100k_ms_pacman, so the run ends after 8 gradient
# steps.
TRAIN_CUTS = {"algo.learning_starts": "128 (from 1024)", "algo.total_steps": "135 (from 100000; 8 gradient steps)",
              "metric.log_every": "8 (from 5000)"}  # fmt: skip
TRAIN_ARGS = ["exp=dreamer_v3_100k_ms_pacman", "env=dummy", "algo.learning_starts=128", "algo.total_steps=135", "metric.log_every=8"]
FWD_PER_STEP = 64 + 15  # the dynamic scan over T = 64, then the 15-step imagination
STREAM_PER_STEP = 64  # the dynamic scan's B = 16 streams W
TC_PER_STEP = 15  # the imagination's B = 16 x 64 = 1024 runs on the tensor cores
BWD_PER_STEP = 64  # the world-model loss differentiates the dynamic scan only
IMAGINED_BATCH = 1024
FWD_BY_BATCH = {16: STREAM_PER_STEP, IMAGINED_BATCH: TC_PER_STEP}
BWD_BY_BATCH = {16: BWD_PER_STEP}
# The device span of the train step's stage in which each batch's backward
# runs: the world model's loss differentiates the dynamic scan (B = 16), the
# continuous actor's loss the imagination (B = 1024).
BWD_STAGE = {16: "dv3/world_model", IMAGINED_BATCH: "dv3/actor"}


def _params(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def zero_counts():
    """Set every LN-GRU launch count to 0 (just before a main path runs)."""
    from sheeprl_tpu_torch.models.ln_gru import ln_gru_backward, ln_gru_forward, ln_gru_forward_streaming, ln_gru_forward_tensor_core

    ln_gru_forward.launches = ln_gru_backward.launches = 0
    ln_gru_forward_streaming.launches = ln_gru_forward_tensor_core.launches = 0
    ln_gru_forward.launches_by_batch.clear()
    ln_gru_backward.launches_by_batch.clear()


def read_counts():
    """The LN-GRU launch counts (just after a main path ran)."""
    from sheeprl_tpu_torch.models.ln_gru import ln_gru_backward, ln_gru_forward, ln_gru_forward_streaming, ln_gru_forward_tensor_core

    return {"forward": ln_gru_forward.launches, "backward": ln_gru_backward.launches,
            "streaming": ln_gru_forward_streaming.launches, "tensor_core": ln_gru_forward_tensor_core.launches,
            "forward_by_batch": dict(ln_gru_forward.launches_by_batch), "backward_by_batch": dict(ln_gru_backward.launches_by_batch)}  # fmt: skip


@contextmanager
def patched(owner, name, value):
    """``owner.name`` set to ``value`` for the block, then put back."""
    had, old = name in vars(owner), vars(owner).get(name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        if had:
            setattr(owner, name, old)
        else:
            delattr(owner, name)


def train_through_cli(args, what, bwd_per_step, keep_params=False):
    """One run of the port's trainer through its CLI entry point, in
    process, on the card. At every gradient step it checks: finite metrics;
    the LN-GRU launches by batch since the step before (forward
    ``FWD_BY_BATCH``, backward ``bwd_per_step``; the player's forwards at
    B = num_envs fall between iterations); the target critic's EMA (a hard
    copy at step 1, then tau * critic + (1 - tau) * target within 1e-6 of
    that recomputed here); that the actor's backward left the world model's
    and the critic's gradients as the world model's update left them (read
    where the step clips each module's gradients); and that the
    imagination's cells (B = 1024) were asked for no gradient of W, the
    LayerNorm scale or its bias, only of their input (continuous actions),
    or for none (discrete actions imagine under no_grad). Returns
    (out, steps, wall_s, counts, worst_ema, trace); each step is (gradient
    step, tau, time, metrics, the modules' parameters if ``keep_params``);
    ``trace`` holds the iteration (env step call) of every gradient step and
    of every episode end, and the seconds each checkpoint took to save."""
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.envs.dummy import SyncVectorEnv
    from sheeprl_tpu_torch.models import ln_gru

    if int(compose(args).env.num_envs) in FWD_BY_BATCH:
        fail(f"{what}: the player's batch would be counted as the train step's")
    held, snap, imagined = {}, {}, []
    steps, last, prev_target, worst_ema = [], [None], {}, [0.0]
    trace = {"env_steps": 0, "grad_iters": [], "episode_iters": [], "save_s": []}
    make_train_step, clip, apply = dv3.make_train_step, dv3._clip, ln_gru.LNGRUFunction.apply
    env_step, save_checkpoint = SyncVectorEnv.step, dv3.save_checkpoint

    def recording_env_step(envs, actions):
        result = env_step(envs, actions)
        trace["env_steps"] += 1
        if result[4]["episode"]:
            trace["episode_iters"].append(trace["env_steps"])
        return result

    def timed_save(*args, **kwargs):
        t0 = time.perf_counter()
        path = save_checkpoint(*args, **kwargs)
        trace["save_s"].append(time.perf_counter() - t0)
        return path

    def holding_make_train_step(agent, optimizers, cfg):
        held["agent"] = agent
        return make_train_step(agent, optimizers, cfg)

    def grads(module):
        return {k: None if p.grad is None else p.grad.clone() for k, p in module.named_parameters()}

    def checking_clip(module, max_norm):
        agent = held["agent"]
        if module is agent.world_model:
            norm = clip(module, max_norm)  # scales the gradients in place
            snap.update(world_model=grads(agent.world_model), critic=grads(agent.critic))
            return norm
        if module is agent.actor:
            for name in ("world_model", "critic"):
                for k, g in grads(getattr(agent, name)).items():
                    before = snap[name][k]
                    if (g is None) != (before is None) or (g is not None and not torch.equal(g, before)):
                        fail(f"{what}: the actor's backward changed the {name}'s gradient of {k}")
            snap["checked"] = snap.get("checked", 0) + 1
        return clip(module, max_norm)

    def recording_apply(*inputs):
        if inputs[0].shape[0] == IMAGINED_BATCH:
            imagined.append(torch.is_grad_enabled() and tuple(t.requires_grad for t in inputs))
        return apply(*inputs)

    def on_step(agent, step, tau, metrics):
        bad = [k for k, v in metrics.items() if not torch.isfinite(v).all()]
        if bad:
            fail(f"{what}: non-finite metrics at gradient step {step}: {bad}")
        now = read_counts()
        bwd = {b: n - last[0]["backward_by_batch"].get(b, 0) for b, n in now["backward_by_batch"].items()}
        fwd = {b: now["forward_by_batch"].get(b, 0) - last[0]["forward_by_batch"].get(b, 0) for b in FWD_BY_BATCH}
        if {b: n for b, n in bwd.items() if n} != bwd_per_step or fwd != FWD_BY_BATCH:
            fail(f"{what}: gradient step {step} launched backward {bwd} and forward {fwd} by batch, "
                 f"expected {bwd_per_step} and {FWD_BY_BATCH}")  # fmt: skip
        last[0] = now
        differentiated = [need for need in imagined if need]
        if (len(imagined) != TC_PER_STEP or len(differentiated) != (TC_PER_STEP if agent.is_continuous else 0)
                or any(not need[0] or need[1] or need[3] or need[4] for need in differentiated)):  # fmt: skip
            fail(f"{what}: gradient step {step}: the imagination's cells asked for gradients {imagined[:2]} "
                 f"({len(differentiated)} of {len(imagined)} differentiated)")  # fmt: skip
        imagined.clear()
        if snap.pop("checked", 0) != 1:
            fail(f"{what}: gradient step {step} did not clip the actor's gradients once")
        critic, target = agent.critic.state_dict(), agent.target_critic.state_dict()
        if step == 1 or prev_target:
            for k, t in target.items():
                want = critic[k] if step == 1 else tau * critic[k] + (1 - tau) * prev_target[k]
                worst_ema[0] = max(worst_ema[0], (t - want).abs().max().item())
            if worst_ema[0] > 1e-6:
                fail(f"{what}: the target critic left its EMA by {worst_ema[0]} at gradient step {step}")
        prev_target.update({k: v.clone() for k, v in target.items()})
        params = {n: _params(getattr(agent, n)) for n in MODULES} if keep_params else None
        steps.append((step, tau, time.perf_counter(), {k: v.item() for k, v in metrics.items()}, params))
        trace["grad_iters"].append(trace["env_steps"])

    torch.cuda.synchronize()
    zero_counts()
    last[0] = read_counts()
    t0 = time.perf_counter()
    with patched(dv3, "make_train_step", holding_make_train_step), patched(dv3, "_clip", checking_clip), patched(
        ln_gru.LNGRUFunction, "apply", recording_apply
    ), patched(SyncVectorEnv, "step", recording_env_step), patched(dv3, "save_checkpoint", timed_save):
        out = run(args, callback=on_step)
    torch.cuda.synchronize()
    return out, steps, time.perf_counter() - t0, read_counts(), worst_ema[0], trace


def check_logged(out, cfg, trace, what):
    """The run's TensorBoard file, read back with ``read_scalars``, holds
    exactly the tags the JAX package's trainer logs at each of its log steps
    (tests/test_torch_evaluate.py holds the rule to the JAX package's run):
    ``Params/replay_ratio`` and ``Time/sps_env_interaction`` at every one;
    the 13 training means and ``Time/sps_train`` where a gradient step ran
    since the one before; ``Rewards/rew_avg`` and ``Game/ep_len_avg`` where
    an episode ended since; ``Test/cumulative_reward`` at step 0. Every value
    is finite and ``Params/replay_ratio`` is gradient steps / policy steps.
    Returns {tag: number of log steps}."""
    import numpy as np

    from sheeprl_tpu_torch.algos.dreamer_v3.utils import AGGREGATOR_METRICS
    from sheeprl_tpu_torch.utils.logger import read_scalars

    n, every = int(cfg.env.num_envs), int(cfg.metric.log_every)
    total_iters = int(cfg.algo.total_steps) // n
    expected, last = {"Test/cumulative_reward": [0]}, 0
    for it in range(1, total_iters + 1):
        if it * n - last < every and it != total_iters:
            continue
        tags = ["Params/replay_ratio", "Time/sps_env_interaction"]
        if any(last < g * n <= it * n for g in trace["grad_iters"]):
            tags += [*AGGREGATOR_METRICS[2:], "Time/sps_train"]
        if any(last < e * n <= it * n for e in trace["episode_iters"]):
            tags += list(AGGREGATOR_METRICS[:2])
        for tag in tags:
            expected.setdefault(tag, []).append(it * n)
        last = it * n
    scalars = read_scalars(out["log_dir"])
    got = {tag: [step for step, _ in values] for tag, values in scalars.items()}
    if got != {k: sorted(v) for k, v in expected.items()}:
        fail(f"{what}: the TensorBoard file holds tags at steps {got}, the JAX package's trainer logs {expected}")
    bad = [tag for tag, values in scalars.items() if not all(np.isfinite(v) for _, v in values)]
    if bad:
        fail(f"{what}: non-finite logged values for {bad}")
    for step, value in scalars["Params/replay_ratio"]:
        grads = sum(1 for g in trace["grad_iters"] if g * n <= step)
        if value != np.float32(grads / step):
            fail(f"{what}: Params/replay_ratio {value} at policy step {step}, {grads} gradient steps make {grads / step}")
    if scalars["Test/cumulative_reward"] != [(0, np.float32(out["test_reward"]))]:
        fail(f"{what}: Test/cumulative_reward {scalars['Test/cumulative_reward']}, the test episode returned {out['test_reward']}")
    log(f"{what}: the TensorBoard file holds the JAX package's {len(got)} tags at its {len(got['Params/replay_ratio'])} log steps "
        f"({sum(map(len, got.values()))} scalars, all finite; replay ratio = gradient steps / policy steps); "
        f"test episode reward {out['test_reward']}")  # fmt: skip
    return {tag: len(steps) for tag, steps in got.items()}


def check_memmap_files(out, cfg, what):
    """The replay buffer's files: one per key under
    ``memmap_buffer/rank_0/env_<i>``, each of the recipe's rows (buffer.size
    / num_envs), and the disk blocks they use (sparse until written)."""
    import numpy as np

    n = int(cfg.env.num_envs)
    rows = int(cfg.buffer.size) // n
    root = os.path.join(out["log_dir"], "memmap_buffer", "rank_0")
    if sorted(os.listdir(root)) != [f"env_{i}" for i in range(n)]:
        fail(f"{what}: memmap dirs {sorted(os.listdir(root))}")
    files = {}
    for i in range(n):
        for name in sorted(os.listdir(os.path.join(root, f"env_{i}"))):
            st = os.stat(os.path.join(root, f"env_{i}", name))
            files[f"env_{i}/{name}"] = {"bytes": st.st_size, "disk_bytes": st.st_blocks * 512}
    rgb = files.get("env_0/rgb.memmap", {}).get("bytes")
    width = int(np.prod((cfg.env.screen_size, cfg.env.screen_size, 3)))
    if rgb != rows * width or len(files) != 6 * n:
        fail(f"{what}: memmap files {files}, expected 6 per env and rgb of {rows} x {width} bytes")
    apparent, used = sum(f["bytes"] for f in files.values()), sum(f["disk_bytes"] for f in files.values())
    fs = filesystem_of(root)
    log(f"{what}: memory-mapped replay of {rows} rows x {n} envs: {len(files)} files, {apparent / 1e9:.3f} GB apparent "
        f"(rgb {rgb / 1e9:.3f} GB per env), {used / 1e6:.2f} MB of disk blocks used, on {fs}")  # fmt: skip
    return {"rows_per_env": rows, "apparent_bytes": apparent, "disk_bytes_used": used, "filesystem": fs, "files": files}


MODULES = ("world_model", "actor", "critic", "target_critic")


def phase_training(log_root):
    """The port's trainer through its CLI entry point, in process, on the
    card: DV3-S, bf16-mixed, 8 gradient steps checked step by step
    (:func:`train_through_cli`: 64 + 15 forwards and 64 backwards each);
    then that the world model, actor and critic moved and that the target
    critic's taus were a hard copy, then ``algo.critic.tau``. The run writes
    under ``log_root``."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.serve.spaces import Box, DictSpace

    cfg = compose(TRAIN_ARGS)
    log(f"training: exp=dreamer_v3_100k_ms_pacman env=dummy (rgb 64x64x3, 9 actions), full DV3-S width, "
        f"{cfg.fabric.precision}, batch {cfg.algo.per_rank_batch_size} x {cfg.algo.per_rank_sequence_length}, "
        f"horizon {cfg.algo.horizon}; cut: {json.dumps(TRAIN_CUTS)}")  # fmt: skip
    init = build_agent((9,), False, cfg, DictSpace({"rgb": Box((64, 64, 3), "uint8", 0.0, 255.0)}), device="cpu", seed=cfg.seed, training=True)
    before = {name: _params(getattr(init, name)) for name in ("world_model", "actor", "critic")}
    del init
    out, steps, wall_s, counts, worst_ema, trace = train_through_cli([*TRAIN_ARGS, f"log_root={log_root}"], "training", BWD_BY_BATCH)
    n = out["gradient_steps"]
    if n != 8 or len(steps) != 8:
        fail(f"training: {n} gradient steps, expected 8")
    taus = [tau for _, tau, _, _, _ in steps]
    if taus[0] != 1.0 or any(abs(t - float(cfg.algo.critic.tau)) > 1e-7 for t in taus[1:]):
        fail(f"training: target-critic taus {taus}")
    agent = out["agent"]
    for name, state in before.items():
        now = _params(getattr(agent, name))
        moved = sum(int(not torch.equal(v.cpu(), state[k])) for k, v in now.items())
        if moved == 0:
            fail(f"training: no parameter of the {name} moved")
        log(f"training: {moved}/{len(now)} {name} tensors moved")
    last = out["log"][-1]
    if not all(np.isfinite(v) for v in last.values()):
        fail(f"training: non-finite logged metrics {last}")
    tags = check_logged(out, cfg, trace, "training")
    memmap = check_memmap_files(out, cfg, "training")
    fwd, bwd, stream, tc = counts["forward"], counts["backward"], counts["streaming"], counts["tensor_core"]
    step_wall = [b[2] - a[2] for a, b in zip(steps, steps[1:])]
    result = {
        "cuts": TRAIN_CUTS,
        "gradient_steps": n,
        "policy_steps": out["policy_steps"],
        "wall_s": wall_s,
        "ln_gru_forward_launches": fwd,
        "ln_gru_backward_launches": bwd,
        "ln_gru_forward_launches_by_kernel": {"streaming": stream, "tensor_core": tc},
        "taus": taus,
        "target_ema_max_abs_err": worst_ema,
        "trainer_wall_ms_between_gradient_steps": statistics.median(step_wall) * 1e3,
        "metrics_last_step": steps[-1][3],
        "logged_tags": tags,
        "logged_sps_train": read_tag(out, "Time/sps_train"),
        "test_reward": out["test_reward"],
        "memmap": memmap,
    }
    log(f"training: {n} gradient steps in {out['policy_steps']} policy steps, {wall_s:.1f} s; ln_gru_forward {fwd} launches "
        f"({fwd / n:.1f}/step incl. the player; streaming {stream}, tensor core {tc}), ln_gru_backward {bwd} ({bwd / n:.1f}/step); "
        f"target EMA max |d| {worst_ema:.3g}; the actor's loss left the world model's and critic's gradients as they were; "
        f"median {result['trainer_wall_ms_between_gradient_steps']:.1f} ms between gradient steps")  # fmt: skip
    log(f"training: last step {json.dumps({k: float(f'{v:.5g}') for k, v in steps[-1][3].items()})}")
    return result, agent, cfg


def _train_batch(T, B, seed, device, n_actions=9, continuous=False):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    if continuous:
        actions = rng.uniform(-1, 1, (T, B, n_actions)).astype(np.float32)
    else:
        actions = np.zeros((T, B, n_actions), np.float32)
        actions[np.arange(T)[:, None], np.arange(B)[None, :], rng.integers(0, n_actions, (T, B))] = 1.0
    data = {
        "rgb": rng.integers(0, 256, (T, B, 64, 64, 3)).astype(np.uint8),
        "actions": actions,
        "rewards": rng.normal(size=(T, B, 1)).astype(np.float32),
        "terminated": (rng.random((T, B, 1)) < 0.05).astype(np.float32),
        "truncated": np.zeros((T, B, 1), np.float32),
        "is_first": (rng.random((T, B, 1)) < 0.05).astype(np.float32),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in data.items()}


def phase_train_profile(agent, cfg, steps: int = 3, bwd_per_step=None, what: str = "train step profile"):
    """Where one DV3-S gradient step's time goes (bf16-mixed, B = 16,
    T = 64, horizon 15, on the trained agent): host wall per step (ending in a
    synchronize), the device's busy time per step and its idle share from
    torch.profiler, device operations per step, the kernels' launches per
    step by kernel and by batch, one backward's device time in the step at
    each batch (the ln_gru_bwd kernels inside the device span of the stage
    that runs them, ``BWD_STAGE``), and peak device memory. ``bwd_per_step``
    is the backward launches a step must make at each batch size (the
    discrete step's 64 at B = 16 by default)."""
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import make_optimizers, make_train_step
    from sheeprl_tpu_torch.models.ln_gru import (
        ln_gru_backward,
        ln_gru_forward,
        ln_gru_forward_streaming,
        ln_gru_forward_tensor_core,
    )
    from sheeprl_tpu_torch.utils.distribution import BatchGenerator
    from sheeprl_tpu_torch.utils.ops import init_moments

    bwd_per_step = bwd_per_step or BWD_BY_BATCH
    dev = torch.device("cuda")
    step = make_train_step(agent, make_optimizers(agent, cfg), cfg)
    data = _train_batch(int(cfg.algo.per_rank_sequence_length), int(cfg.algo.per_rank_batch_size), 7, dev,
                        sum(agent.actions_dim), agent.is_continuous)  # fmt: skip
    rng = BatchGenerator.from_seed(0, dev)
    moments = init_moments(dev)
    moments, _ = step(moments, data, rng, 0.02)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        moments, _ = step(moments, data, rng, 0.02)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    fwd, bwd = ln_gru_forward.launches / steps, ln_gru_backward.launches / steps
    stream, tc = ln_gru_forward_streaming.launches / steps, ln_gru_forward_tensor_core.launches / steps
    bwd_by_batch = {b: n / steps for b, n in sorted(ln_gru_backward.launches_by_batch.items())}
    fwd_by_batch = {b: n / steps for b, n in sorted(ln_gru_forward.launches_by_batch.items())}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    def profiled_steps():
        nonlocal moments
        for _ in range(steps):
            moments, _ = step(moments, data, rng, 0.02)

    prof = profiled(profiled_steps, ("cpu", "cuda"))
    kernels_ms, stages = {}, {}
    averages = prof.key_averages()
    busy_ms, ops_per_step, annotated_ms = _busy(averages, steps, skip=("dv3/",), by_kernel=kernels_ms)
    for evt in averages:
        total_us = getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0.0)
        if evt.key.startswith("dv3/"):  # the train step's stage spans, host side and their device annotation
            side = "device_span_ms" if evt.device_type == torch.autograd.DeviceType.CUDA else "host_ms"
            stages.setdefault(evt.key, {})[side] = (total_us if side == "device_span_ms" else evt.cpu_time_total) / steps / 1e3
    if busy_ms <= 0.0:
        fail("train profile: torch.profiler saw no device time")
    spans, bwd_kernels = {stage: [] for stage in BWD_STAGE.values()}, []
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if evt.name in spans:
            spans[evt.name].append((evt.time_range.start, evt.time_range.end))
        elif "ln_gru_bwd" in evt.name:
            bwd_kernels.append(evt.time_range)
    bwd_in_step = {}
    for batch in bwd_per_step:
        us = [k.elapsed_us() for k in bwd_kernels if any(a <= k.start <= b for a, b in spans[BWD_STAGE[batch]])]
        if not us:
            fail(f"{what}: the profiler recorded no backward kernel in the {BWD_STAGE[batch]} device span (B = {batch})")
        bwd_in_step[batch] = {"ms": statistics.mean(us) / 1e3, "kernels_seen": len(us)}
    top = dict(sorted(kernels_ms.items(), key=lambda kv: -kv[1])[:8])
    gru_ms = {k: v for k, v in kernels_ms.items() if "ln_gru" in k}
    result = {"host_wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy_ms,
              "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms), "device_ops_per_step": ops_per_step,
              "annotation_ranges_ms_per_step": annotated_ms,
              "ln_gru_forward_per_step": fwd, "ln_gru_backward_per_step": bwd, "peak_memory_gib": peak_gib,
              "ln_gru_forward_per_step_by_kernel": {"streaming": stream, "tensor_core": tc},
              "ln_gru_forward_per_step_by_batch": fwd_by_batch, "ln_gru_backward_per_step_by_batch": bwd_by_batch,
              "ln_gru_device_ms_per_step_total": sum(gru_ms.values()), "ln_gru_backward_in_step_ms_by_batch": bwd_in_step,
              "stages_per_step": stages, "ln_gru_device_ms_per_step": gru_ms,
              "top_device_ms_per_step": top}  # fmt: skip
    if (fwd != FWD_PER_STEP or stream != STREAM_PER_STEP or tc != TC_PER_STEP or bwd_by_batch != bwd_per_step
            or fwd_by_batch != FWD_BY_BATCH):  # fmt: skip
        fail(f"{what}: {fwd} forward ({stream} streaming, {tc} tensor core; by batch {fwd_by_batch}) and {bwd} backward "
             f"launches per gradient step (by batch {bwd_by_batch}), expected {FWD_PER_STEP} ({STREAM_PER_STEP} + {TC_PER_STEP}) "
             f"and {bwd_per_step}")  # fmt: skip
    log(f"{what} (DV3-S, bf16-mixed, B=16 T=64 H=15): host wall {wall_ms:.2f} ms/step, device busy {busy_ms:.2f} ms/step, "
        f"idle share {result['device_idle_share']:.3f}, {result['device_ops_per_step']:.0f} device ops/step, "
        f"ln_gru {fwd:.0f} fwd + {bwd:.0f} bwd launches/step (backward by batch {bwd_by_batch}), peak memory {peak_gib:.2f} GiB")  # fmt: skip
    log(f"{what}: stages {json.dumps({k: {s: round(v, 3) for s, v in d.items()} for k, d in stages.items()})}")
    log(f"{what}: LN-GRU kernels' device ms/step {json.dumps({k: round(v, 4) for k, v in gru_ms.items()})}, "
        f"total {sum(gru_ms.values()):.4f}; one backward in the step by batch {json.dumps(bwd_in_step)}")
    log(f"{what}: top device ms/step {json.dumps({k: round(v, 4) for k, v in top.items()})}")
    return result


class RecordedDraws:
    """A noise source that records every draw of another: categorical
    indices and standard normals."""

    def __init__(self, source):
        self.source, self.draws = source, []

    def categorical(self, logits):
        idx = self.source.categorical(logits)
        self.draws.append(idx.cpu())
        return idx

    def normal(self, loc_shape, sample_shape=()):
        eps = self.source.normal(loc_shape, sample_shape)
        self.draws.append(eps.cpu())
        return eps


class ReplayedDraws:
    """A noise source that hands back recorded draws in order."""

    def __init__(self, draws):
        self.draws = list(draws)
        self.used = 0

    def _next(self, shape):
        draw = self.draws[self.used]
        self.used += 1
        if tuple(draw.shape) != tuple(shape):
            fail(f"replayed draw {self.used} has shape {tuple(draw.shape)}, the step asks for {tuple(shape)}")
        return draw

    def categorical(self, logits):
        return self._next(logits.shape[:-1]).to(logits.device)

    def normal(self, loc_shape, sample_shape=()):
        return self._next(tuple(sample_shape) + tuple(loc_shape))


def phase_train_reference(args=("exp=dreamer_v3_100k_ms_pacman", "env=dummy"), n_actions=9, continuous=False, what="train reference"):
    """One gradient step at 32-true on the card (the kernels) against the
    CPU (the plain versions): full DV3-S width, the same seeded weights, the
    same batch at B = 4, T = 16; the card's draws (categorical indices and,
    for continuous actions, standard normals) are recorded and replayed on
    the CPU. Losses and metrics within rtol 2e-3 + atol 1e-4, the three
    pre-clip gradient norms within rtol 2e-3: f32 products and convolutions
    in another order on two devices, through 16 GRU steps, a 64x64 decoder
    and 15 imagined steps (differentiated, for continuous actions)."""
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import make_optimizers, make_train_step
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.serve.spaces import Box, DictSpace
    from sheeprl_tpu_torch.utils.distribution import BatchGenerator
    from sheeprl_tpu_torch.utils.ops import init_moments

    cfg = compose([*args, "fabric.precision=32-true"])
    space = DictSpace({"rgb": Box((64, 64, 3), "uint8", 0.0, 255.0)})
    out = {}
    draws = None
    for dev in ("cuda", "cpu"):
        agent = build_agent((n_actions,), continuous, cfg, space, precision="32-true", device=dev, seed=0, training=True)
        step = make_train_step(agent, make_optimizers(agent, cfg), cfg)
        rng = RecordedDraws(BatchGenerator.from_seed(0, torch.device(dev))) if draws is None else ReplayedDraws(draws)
        data = _train_batch(16, 4, 11, torch.device(dev), n_actions, continuous)
        moments, metrics = step(init_moments(torch.device(dev)), data, rng, 1.0)
        if draws is None:
            draws = rng.draws
        elif rng.used != len(draws):
            fail(f"{what}: the CPU step drew {rng.used} times, the card {len(draws)}")
        out[dev] = {k: v.item() for k, v in metrics.items()} | {f"moments/{k}": v.item() for k, v in moments.items()}
    worst = {}
    for k, ref in out["cpu"].items():
        got = out["cuda"][k]
        worst[k] = abs(got - ref)
        if not (math.isfinite(got) and abs(got - ref) <= 1e-4 + 2e-3 * abs(ref)):
            fail(f"{what}: {k} on the card {got} vs the CPU {ref}")
    log(f"{what}: one 32-true gradient step, card (kernels) vs CPU (plain), {len(draws)} replayed draws: "
        f"max rel |d| {max(worst[k] / max(abs(out['cpu'][k]), 1e-12) for k in worst):.3g}; "
        f"world model loss {out['cuda']['Loss/world_model_loss']:.6g} vs {out['cpu']['Loss/world_model_loss']:.6g}")  # fmt: skip
    return {"card": out["cuda"], "cpu": out["cpu"]}


# The continuous path: DreamerV3-S on the walker (6 actions in [-1, 1], the
# port's continuous dummy env at walker's shapes), 4 envs, action repeat 2,
# replay ratio 0.5, bf16-mixed, batch 16 x 64, horizon 15. Only these are cut
# from exp=dreamer_v3_dmc_walker_walk: 2 gradient steps per iteration from
# policy step 264 to 276 make 8, with a checkpoint after the 4th.
WALKER_CUTS = {"algo.learning_starts": "264 (from 1300)", "algo.total_steps": "276 (from 500000; 8 gradient steps)",
               "checkpoint.every": "268 (from 10000; one checkpoint after 4 gradient steps)", "metric.log_every": "8 (from 5000)"}  # fmt: skip
WALKER_ARGS = ["exp=dreamer_v3_dmc_walker_walk", "env=dummy", "env.id=continuous_dummy", "algo.learning_starts=264",
               "algo.total_steps=276", "checkpoint.every=268", "metric.log_every=8"]  # fmt: skip
WALKER_BWD_PER_STEP = {16: BWD_PER_STEP, IMAGINED_BATCH: TC_PER_STEP}  # the dynamic scan's 64, then the 15 imagined steps
# The DV3-S gradient step's device operations (torch.profiler) on an H100: the step's own, whatever the loop around it does.
# Adam keeps its step count on the card (capturable) and the target critic's EMA reads its tau there, as the captured step
# needs; that added about 200 operations to the eager step's 17731 and 18597.
STEP_OPS = {"discrete": 17932, "continuous": 18794}


def phase_continuous_training(log_root):
    """The continuous path through the CLI on the card: DV3-S on the walker,
    8 gradient steps checked step by step (:func:`train_through_cli`: 64
    backwards at B = 16 and 15 at B = 1024, the pathwise actor gradient
    through the imagination, whose cells get no dW; the world model's and
    critic's gradients untouched by the actor's loss); a checkpoint after
    step 4 and one at the end; every parameter trainable again after the
    run."""
    import numpy as np

    from sheeprl_tpu_torch.config import compose

    args = [*WALKER_ARGS, f"log_root={log_root}"]
    cfg = compose(args)
    log(f"continuous training: exp=dreamer_v3_dmc_walker_walk env=dummy env.id=continuous_dummy (rgb 64x64x3, Box(-1, 1, (6,))), "
        f"full DV3-S width, {cfg.fabric.precision}, {cfg.env.num_envs} envs, action repeat {cfg.env.action_repeat}, replay ratio "
        f"{cfg.algo.replay_ratio}, batch {cfg.algo.per_rank_batch_size} x {cfg.algo.per_rank_sequence_length}, horizon {cfg.algo.horizon}; "
        f"cut: {json.dumps(WALKER_CUTS)}")  # fmt: skip
    out, steps, wall_s, counts, worst_ema, trace = train_through_cli(args, "continuous training", WALKER_BWD_PER_STEP, keep_params=True)
    n = out["gradient_steps"]
    if n != 8 or [s[0] for s in steps] != list(range(1, 9)) or out["policy_steps"] != 276:
        fail(f"continuous training: {n} gradient steps in {out['policy_steps']} policy steps, expected 8 in 276")
    if [os.path.basename(c) for c in out["checkpoints"]] != ["ckpt_268_0.ckpt", "ckpt_276_0.ckpt"]:
        fail(f"continuous training: checkpoints {out['checkpoints']}")
    agent = out["agent"]
    frozen = [k for m in (agent.world_model, agent.actor, agent.critic) for k, p in m.named_parameters() if not p.requires_grad]
    if frozen or not agent.is_continuous:
        fail(f"continuous training: parameters left frozen after the step: {frozen[:5]}")
    last = out["log"][-1]
    if not all(np.isfinite(v) for v in last.values()):
        fail(f"continuous training: non-finite logged metrics {last}")
    tags = check_logged(out, cfg, trace, "continuous training")
    memmap = check_memmap_files(out, cfg, "continuous training")
    mid = out["checkpoints"][0]
    ckpt_bytes = {name: os.path.getsize(os.path.join(mid, name)) for name in sorted(os.listdir(mid))}
    if ckpt_bytes.get("arrays.npz", 0) > 4 * 2**20:
        fail(f"continuous training: the checkpoint's arrays take {ckpt_bytes} bytes: it copied the replay buffer")
    step_wall = [b[2] - a[2] for a, b in zip(steps, steps[1:])]
    result = {"cuts": WALKER_CUTS, "gradient_steps": n, "policy_steps": out["policy_steps"], "wall_s": wall_s,
              "ln_gru_launches": counts, "target_ema_max_abs_err": worst_ema, "checkpoints": out["checkpoints"],
              "trainer_wall_ms_between_gradient_steps": statistics.median(step_wall) * 1e3,
              "trainer_wall_ms_from_an_iterations_last_gradient_step_to_the_next": statistics.median(step_wall[1::2]) * 1e3,
              "checkpoint_bytes": ckpt_bytes, "checkpoint_total_bytes": sum(ckpt_bytes.values()), "checkpoint_save_s": trace["save_s"],
              "logged_tags": tags, "logged_sps_train": read_tag(out, "Time/sps_train"), "test_reward": out["test_reward"],
              "memmap": memmap, "metrics_last_step": steps[-1][3]}  # fmt: skip
    log(f"continuous training: {n} gradient steps in {out['policy_steps']} policy steps, {wall_s:.1f} s; ln_gru forward "
        f"{counts['forward']} (streaming {counts['streaming']}, tensor core {counts['tensor_core']}; by batch {counts['forward_by_batch']}), "
        f"backward {counts['backward']} (by batch {counts['backward_by_batch']}): per step 64 + 15 backwards, as required; "
        f"the imagination's cells got no dW; the actor's loss left the world model's and critic's gradients as they were")  # fmt: skip
    log(f"continuous training: mid-run checkpoint {os.path.basename(mid)}: {result['checkpoint_total_bytes'] / 1e6:.2f} MB "
        f"({json.dumps(ckpt_bytes)}), saved in {trace['save_s'][0]:.3f} s (end of run: {trace['save_s'][-1]:.3f} s); "
        f"median {result['trainer_wall_ms_between_gradient_steps']:.1f} ms between gradient steps")  # fmt: skip
    log(f"continuous training: last step {json.dumps({k: float(f'{v:.5g}') for k, v in steps[-1][3].items()})}")
    return result, out, steps, cfg


def read_tag(out, tag):
    """[(policy step, value)] of one tag of a run's TensorBoard file."""
    from sheeprl_tpu_torch.utils.logger import read_scalars

    return read_scalars(out["log_dir"]).get(tag, [])


def phase_resume(out, steps, log_root):
    """Save and resume on the card: the mid-run checkpoint loads with its
    digest verified and holds, bit for bit, the modules as they were after
    gradient step 4; a fresh agent and optimizers on the card restore every
    tensor of it bit for bit; the CLI resumed from it numbers its gradient
    steps on from 5, ends at the run's 8 and 276 policy steps, with finite
    losses and 64 + 15 backwards per step. The resumed run's parameters
    beside the uninterrupted run's are reported (the card's kernels need
    not be bit-deterministic, so no bound is set on them)."""
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import OPTIMIZER_KEYS, load_training_state, make_optimizers
    from sheeprl_tpu_torch.algos.ppo.agent import actions_metadata
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.envs.dummy import ContinuousDummyEnv
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    mid = out["checkpoints"][0]
    t0 = time.perf_counter()
    state = load_checkpoint(mid)  # raises unless the leaves match the manifest's digest
    load_s = time.perf_counter() - t0
    if state["gradient_steps"] != 4 or state["iter_num"] != 67:
        fail(f"resume: the checkpoint holds gradient step {state['gradient_steps']} at iteration {state['iter_num']}, expected 4 at 67")
    at_save = steps[3][4]
    for name in MODULES:
        diff = [k for k, v in at_save[name].items() if not torch.equal(v.cpu(), state[name][k])]
        if diff:
            fail(f"resume: the checkpoint's {name} differs from the trained one at {diff[:5]}")
    args = [*WALKER_ARGS, f"log_root={log_root}"]
    cfg = compose(args)
    env = ContinuousDummyEnv(action_dim=6)
    agent = build_agent(*actions_metadata(env.action_space), cfg, env.observation_space, precision=cfg.fabric.precision,
                        device="cuda", seed=123, training=True)  # fmt: skip
    optimizers = make_optimizers(agent, cfg)
    moments = load_training_state(agent, optimizers, state, next(agent.parameters()).device)
    restored = 0
    for name in MODULES:
        for k, v in getattr(agent, name).state_dict().items():
            if not torch.equal(v.cpu(), state[name][k]):
                fail(f"resume: {name}.{k} is not the checkpoint's, bit for bit, on the card")
            restored += 1
    for name, key in OPTIMIZER_KEYS.items():
        saved = state[key]["state"]
        for i, entry in optimizers[name].state_dict()["state"].items():
            for k, v in entry.items():
                if not torch.equal(v.cpu(), saved[i][k]):
                    fail(f"resume: the {name} optimizer's {i}.{k} is not the checkpoint's")
                restored += 1
    if not all(torch.equal(moments[k].cpu(), state["moments"][k]) for k in moments):
        fail("resume: the moments are not the checkpoint's")
    restored += len(moments)
    del agent, optimizers
    torch.cuda.empty_cache()

    refs = state["rb"]["buffers"][0]["memmap"]
    if not os.path.isfile(refs["rgb"]["filename"]) or refs["rgb"]["shape"] != [125000, 1, 64, 64, 3]:
        fail(f"resume: the checkpoint's buffer does not refer to the walker's memmap files: {refs['rgb']}")
    resumed, rsteps, wall_s, counts, _, _ = train_through_cli([*args, f"checkpoint.resume_from={mid}"], "resumed training",
                                                              WALKER_BWD_PER_STEP, keep_params=True)  # fmt: skip
    if [s[0] for s in rsteps] != [5, 6, 7, 8] or resumed["gradient_steps"] != 8 or resumed["policy_steps"] != 276:
        fail(f"resume: gradient steps {[s[0] for s in rsteps]}, {resumed['gradient_steps']} in all, {resumed['policy_steps']} policy steps; "
             "expected 5..8, 8 and 276")  # fmt: skip
    gap = max((v.float() - steps[-1][4][name][k].float()).abs().max().item() for name in MODULES for k, v in rsteps[-1][4][name].items())
    result = {"checkpoint": mid, "load_s": load_s, "tensors_restored_bit_identical": restored, "resumed_steps": [s[0] for s in rsteps],
              "resumed_wall_s": wall_s, "ln_gru_launches": counts, "max_abs_param_gap_to_uninterrupted": gap}  # fmt: skip
    log(f"resume: {os.path.basename(mid)} loaded with its digest verified in {load_s:.2f} s; {restored} tensors restored on the card "
        f"bit for bit; the resumed CLI run took gradient steps {result['resumed_steps']} with finite losses in {wall_s:.1f} s; "
        f"its final parameters differ from the uninterrupted run's by at most {gap:.3g}")  # fmt: skip
    del resumed
    return result


def phase_export_serve(ckpt, workdir):
    """The walker checkpoint exported (``python -m sheeprl_tpu_torch.serve
    export``) and served over HTTP on the card: /v1/models shows the Box
    action space; 4 sessions x 4 steps in sample mode share batches; every
    action has 6 entries in [-1, 1]; a greedy session replayed from its seed
    and observations repeats its actions byte for byte; the LN-GRU forward
    ran for every served batch (counts zeroed just before)."""
    import numpy as np

    from sheeprl_tpu_torch.models.ln_gru import ln_gru_forward
    from sheeprl_tpu_torch.serve import cli as serve_cli
    from sheeprl_tpu_torch.serve.cli import SERVE_DEFAULTS
    from sheeprl_tpu_torch.serve.engine import InferenceEngine
    from sheeprl_tpu_torch.serve.server import PolicyServer

    path = os.path.join(workdir, "walker.policy")
    serve_cli.main(["export", f"checkpoint_path={ckpt}", "name=walker", f"output_path={path}"])
    engine = InferenceEngine(max_batch=SERVE_DEFAULTS["max_batch"], queue_capacity=SERVE_DEFAULTS["queue_capacity"],
                             batch_window_s=SERVE_DEFAULTS["batch_window_ms"] / 1000.0, device="cuda")  # fmt: skip
    card = engine.load("walker", path)
    server = PolicyServer(engine, host="127.0.0.1", port=0).start()
    try:
        status, models = http(server.address, "/v1/models")
        space = models["models"]["walker"]["action_space"]
        if status != 200 or space != {"type": "box", "shape": [6], "dtype": "float32", "low": -1.0, "high": 1.0}:
            fail(f"export/serve: /v1/models {status} {models}")
        rng = np.random.default_rng(3)
        obs = [rng.integers(0, 256, (64, 64, 3), dtype=np.uint8).tolist() for _ in range(4)]

        def act(session, mode, seed, o):
            return http(server.address, "/v1/act", {"model": "walker", "obs": {"rgb": o}, "mode": mode, "seed": seed, "session": session})[1]["action"]

        engine.reset_stats()
        zero_counts()
        barrier = threading.Barrier(4)

        def drive(s):
            out = []
            for o in obs:
                barrier.wait(timeout=60)
                out.append(act(f"sample-{s}", "sample", 10 + s, o))
            return out

        with ThreadPoolExecutor(4) as pool:
            sampled = list(pool.map(drive, range(4)))
        greedy = [act("greedy-a", "greedy", 7, o) for o in obs]
        again = [act("greedy-b", "greedy", 7, o) for o in obs]
        launches, stats = ln_gru_forward.launches, engine.stats()
    finally:
        server.close(drain=True)
    flat = [a for sess in sampled for a in sess] + greedy + again
    if not all(len(a) == 6 and all(isinstance(x, float) and -1.0 <= x <= 1.0 for x in a) for a in flat):
        fail(f"export/serve: actions outside 6 x [-1, 1]: {flat[:3]}")
    if json.dumps(greedy) != json.dumps(again):
        fail(f"export/serve: the replayed greedy session differs: {greedy} vs {again}")
    if launches < stats["counters"]["batches"] or stats["counters"]["errors"]:
        fail(f"export/serve: ln_gru_forward launched {launches} times for {stats['counters']['batches']} batches ({stats['counters']})")
    result = {"artifact_precision": card["precision"], "requests": stats["counters"]["requests"], "batches": stats["counters"]["batches"],
              "occupancy": stats["occupancy"], "ln_gru_launches": launches, "greedy_actions": greedy}  # fmt: skip
    log(f"export/serve: {os.path.basename(ckpt)} exported and served ({card['precision']} on {card['device']}): {result['requests']} requests "
        f"in {result['batches']} batches, occupancy {stats['occupancy']}, every action 6 x [-1, 1], greedy replay byte-identical")  # fmt: skip
    return result


def phase_eval(ckpt, test_reward, what="eval"):
    """``python -m sheeprl_tpu_torch.eval checkpoint_path=<ckpt>`` in a
    process of its own, on the card by default: it logs
    ``Test/cumulative_reward`` under ``<run>/<version>/evaluation/version_0``,
    equal to the trainer's own test episode's."""
    return finish_eval(start_eval(ckpt), test_reward, what)


def start_eval(ckpt):
    """The evaluation of ``ckpt`` started in a process of its own (its
    result read by :func:`finish_eval`, which the caller must reach, or
    kill the process)."""
    proc = subprocess.Popen([sys.executable, "-m", "sheeprl_tpu_torch.eval", f"checkpoint_path={ckpt}"], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)  # fmt: skip
    return ckpt, time.perf_counter(), proc


def finish_eval(started, test_reward, what):
    """Wait for :func:`start_eval`'s process and check what it logged
    (:func:`phase_eval`)."""
    import numpy as np

    from sheeprl_tpu_torch.utils.logger import read_scalars

    ckpt, t0, proc = started
    try:
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    wall_s = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"{what}: exit {proc.returncode}\n{stdout[-2000:]}\n{stderr[-4000:]}")
    eval_dir = os.path.join(os.path.dirname(os.path.dirname(ckpt)), "evaluation", "version_0")
    logged = read_scalars(eval_dir)
    if logged != {"Test/cumulative_reward": [(0, np.float32(test_reward))]}:
        fail(f"{what}: logged {logged} under {eval_dir}, the trainer's test episode returned {test_reward}")
    log(f"{what}: python -m sheeprl_tpu_torch.eval on {os.path.basename(ckpt)} logged Test/cumulative_reward "
        f"{logged['Test/cumulative_reward'][0][1]} = the trainer's test reward, in {wall_s:.1f} s")  # fmt: skip
    return {"checkpoint": ckpt, "wall_s": wall_s, "test_reward": logged["Test/cumulative_reward"][0][1]}


# PPO (exp=ppo on vector observations, exp=ppo_atari on pixels): the host
# path, one process. PPO launches no LN-GRU kernel: its counts stay at 0.
PPO_CUTS = {"algo.total_steps": "1024 (from 65536; 2 updates)", "metric.log_every": "512 (from 5000)"}
PPO_ARGS = ["exp=ppo", "env=dummy", "algo.total_steps=1024", "metric.log_every=512"]
PPO_CONT_CUTS = {"env.id": "continuous_dummy (from discrete_dummy)", "algo.total_steps": "512 (from 65536; 1 update)",
                 "metric.log_every": "512 (from 5000)"}  # fmt: skip
PPO_CONT_ARGS = ["exp=ppo", "env=dummy", "env.id=continuous_dummy", "algo.total_steps=512", "metric.log_every=512"]
PPO_ATARI_CUTS = {"algo.total_steps": "2048 (from 10000000; 2 updates)", "checkpoint.every": "1024 (from 100000)"}
PPO_ATARI_ARGS = ["exp=ppo_atari", "env=dummy", "algo.total_steps=2048", "checkpoint.every=1024"]
PPO_LOSSES = ("Loss/policy_loss", "Loss/value_loss", "Loss/entropy_loss")
PPO_INFO = ("Info/learning_rate", "Info/clip_coef", "Info/ent_coef")


def _ppo_snapshot(agent, optimizer):
    params = {k: v.detach().clone() for k, v in agent.state_dict().items()}
    state = [{k: v.detach().clone() for k, v in optimizer.state[p].items()} for p in agent.parameters()]
    return params, state, optimizer.param_groups[0]["lr"]


def _same_bits(a, b):
    """The tensors of two snapshots (or a snapshot and a checkpoint's
    ``agent`` and optimizer ``state``) that differ, by name."""
    import torch

    (pa, sa), (pb, sb) = a, b
    bad = [k for k in pa if not torch.equal(pa[k].cpu(), pb[k].cpu())]
    for i, (x, y) in enumerate(zip(sa, sb)):
        bad += [f"opt.{i}.{k}" for k in x if not torch.equal(x[k].cpu(), y[k].cpu())]
    return bad + ([] if len(sa) == len(sb) and pa.keys() == pb.keys() else ["<structure>"])


def ppo_through_cli(args, what, trainer="ppo"):
    """One run of the port's on-policy trainer ``trainer`` (``ppo``, ``a2c``
    or ``ppo_recurrent``) through its CLI entry point, in process, on the
    card, with the LN-GRU counts zeroed before and read after. Returns (out,
    trace, snaps, wall_s, counts): ``trace`` holds the env-step index of
    every episode end; ``snaps`` the agent and optimizer state before the
    first update of the run and after every update."""
    import importlib

    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.envs.dummy import SyncVectorEnv

    ppo_mod = importlib.import_module(f"sheeprl_tpu_torch.algos.{trainer}.{trainer}")

    trace, snaps = {"env_steps": 0, "episode_steps": []}, {"after": []}
    env_step, make_train_step = SyncVectorEnv.step, ppo_mod.make_train_step

    def recording_env_step(envs, actions):
        result = env_step(envs, actions)
        trace["env_steps"] += 1
        if result[4]["episode"]:
            trace["episode_steps"].append(trace["env_steps"])
        return result

    def spying_make_train_step(agent, optimizer, cfg):
        step = make_train_step(agent, optimizer, cfg)

        def wrapped(*a):
            snaps.setdefault("before", _ppo_snapshot(agent, optimizer))
            metrics = step(*a)
            snaps["after"].append(_ppo_snapshot(agent, optimizer))
            if not all(math.isfinite(float(v)) for v in metrics.values()):
                fail(f"{what}: non-finite losses {metrics}")
            return metrics

        return wrapped

    zero_counts()
    t0 = time.perf_counter()
    with patched(SyncVectorEnv, "step", recording_env_step), patched(ppo_mod, "make_train_step", spying_make_train_step):
        out = run(args)
    wall_s = time.perf_counter() - t0
    counts = read_counts()
    if counts["forward"] or counts["backward"]:
        fail(f"{what}: {trainer} launched LN-GRU kernels: {counts}")
    if next(out["agent"].parameters()).device.type != "cuda":
        fail(f"{what}: the agent is not on the card")
    return out, trace, snaps, wall_s, counts


def check_ppo_logged(out, cfg, trace, what, first_iter=1, last_log=0, info=PPO_INFO, losses=PPO_LOSSES):
    """The run's TensorBoard file holds exactly the tags the JAX package's
    PPO (A2C, recurrent PPO) logs at each step (tests/test_torch_train_ppo.py,
    test_torch_train_a2c.py and test_torch_train_ppo_recurrent.py hold the
    rule to its runs): ``info`` after every update; ``losses`` and
    ``Time/*`` at every log point (``metric.log_every`` policy steps since
    the last, and the last update); the episode means where an episode
    ended since the last log point; ``Test/cumulative_reward`` at 0. All
    finite."""
    import numpy as np

    from sheeprl_tpu_torch.utils.logger import read_scalars

    per_iter = int(cfg.env.num_envs) * int(cfg.algo.rollout_steps)
    total_iters = int(cfg.algo.total_steps) // per_iter
    ends = [s * int(cfg.env.num_envs) + (first_iter - 1) * per_iter for s in trace["episode_steps"]]
    expected, last = {"Test/cumulative_reward": [0]}, last_log
    for it in range(first_iter, total_iters + 1):
        step = it * per_iter
        tags = list(info)
        if step - last >= int(cfg.metric.log_every) or it == total_iters:
            tags += [*losses, "Time/sps_train", "Time/sps_env_interaction"]
            if any(last < e <= step for e in ends):
                tags += ["Rewards/rew_avg", "Game/ep_len_avg"]
            last = step
        for tag in tags:
            expected.setdefault(tag, []).append(step)
    scalars = read_scalars(out["log_dir"])
    got = {tag: [step for step, _ in values] for tag, values in scalars.items()}
    if got != expected:
        fail(f"{what}: the TensorBoard file holds tags at steps {got}, the JAX package's PPO logs {expected}")
    bad = [tag for tag, values in scalars.items() if not all(np.isfinite(v) for _, v in values)]
    if bad:
        fail(f"{what}: non-finite logged values for {bad}")
    if scalars["Test/cumulative_reward"] != [(0, np.float32(out["test_reward"]))]:
        fail(f"{what}: Test/cumulative_reward {scalars['Test/cumulative_reward']}, the test episode returned {out['test_reward']}")
    return {tag: len(steps) for tag, steps in got.items()}


def _ppo_spaces(cfg):
    from sheeprl_tpu_torch.algos.ppo.agent import actions_metadata
    from sheeprl_tpu_torch.envs.dummy import dummy_env_kwargs, make_dummy_env

    env = make_dummy_env(**dummy_env_kwargs(cfg))
    return env.observation_space, *actions_metadata(env.action_space)


# The agent module and the logged tags of each on-policy trainer.
ONPOLICY = {
    "ppo": {"agent": "ppo", "info": PPO_INFO, "losses": PPO_LOSSES},
    "a2c": {"agent": "ppo", "info": (), "losses": PPO_LOSSES[:2]},
    "ppo_recurrent": {"agent": "ppo_recurrent", "info": PPO_INFO, "losses": PPO_LOSSES},
}


def _onpolicy_agent(trainer):
    import importlib

    return importlib.import_module(f"sheeprl_tpu_torch.algos.{ONPOLICY[trainer]['agent']}.agent")


def _onpolicy_recipe(cfg, trainer):
    algo = cfg.algo
    if trainer == "a2c":
        return f"batch {algo.per_rank_batch_size}, one {algo.optimizer['_target_'].rsplit('.', 1)[1]} step a update"
    if trainer == "ppo_recurrent":
        return (f"LSTM {algo.rnn.lstm.hidden_size}, sequences of {algo.per_rank_sequence_length}, {algo.per_rank_num_batches} batches, "
                f"{algo.update_epochs} epochs, {algo.optimizer['_target_'].rsplit('.', 1)[1]}")  # fmt: skip
    return f"batch {algo.per_rank_batch_size}, {algo.update_epochs} epochs"


def ppo_train(args, cuts, what, log_root, updates, trainer="ppo"):
    """``args`` through the CLI on the card: ``updates`` updates, finite
    losses at every one, every parameter tensor moved from the seeded
    initialisation, the JAX package's tags at its steps."""
    import torch

    from sheeprl_tpu_torch.config import compose

    cfg = compose(args)
    obs_space, actions_dim, continuous = _ppo_spaces(cfg)
    keys = list(cfg.algo.cnn_keys.encoder) + list(cfg.algo.mlp_keys.encoder)
    log(f"{what}: {' '.join(args)}: {', '.join(f'{k} {tuple(obs_space[k].shape)}' for k in keys)}, actions {actions_dim} "
        f"({'continuous' if continuous else 'discrete'}), {cfg.env.num_envs} envs x {cfg.algo.rollout_steps} steps, "
        f"{_onpolicy_recipe(cfg, trainer)}, {cfg.fabric.precision}; cut: {json.dumps(cuts)}")  # fmt: skip
    init = _onpolicy_agent(trainer).build_agent(actions_dim, continuous, cfg, obs_space, device="cpu", seed=cfg.seed).state_dict()
    out, trace, snaps, wall_s, counts = ppo_through_cli([*args, f"log_root={log_root}"], what, trainer)
    if out["updates"] != updates or len(snaps["after"]) != updates or out["policy_steps"] != int(cfg.algo.total_steps):
        fail(f"{what}: {out['updates']} updates in {out['policy_steps']} policy steps, expected {updates} in {cfg.algo.total_steps}")
    now = out["agent"].state_dict()
    still = [k for k, v in now.items() if torch.equal(v.cpu(), init[k])]
    if still:
        fail(f"{what}: parameters that did not move: {still}")
    tags = check_ppo_logged(out, cfg, trace, what, info=ONPOLICY[trainer]["info"], losses=ONPOLICY[trainer]["losses"])
    last = out["log"][-1]
    result = {"cuts": cuts, "updates": out["updates"], "policy_steps": out["policy_steps"], "wall_s": wall_s, "ln_gru_launches": counts,
              "parameters_moved": len(now), "episodes_ended": len(trace["episode_steps"]), "logged_tags": tags,
              "last_log": last, "test_reward": out["test_reward"]}  # fmt: skip
    log(f"{what}: {out['updates']} updates in {out['policy_steps']} policy steps, {wall_s:.1f} s; all {len(now)} parameter tensors moved; "
        f"no LN-GRU launch; the JAX package's {len(tags)} tags at its steps; last log {json.dumps({k: float(f'{v:.5g}') for k, v in last.items()})}")  # fmt: skip
    return result, out, snaps, cfg


def phase_ppo(log_root):
    vector, vout, _, vcfg = ppo_train(PPO_ARGS, PPO_CUTS, "ppo", log_root, 2)
    continuous, _, _, _ = ppo_train(PPO_CONT_ARGS, PPO_CONT_CUTS, "ppo continuous", log_root, 1)
    return vector, continuous, vout, vcfg


def phase_ppo_resume(out, snaps, cfg, log_root):
    """ppo_atari's checkpoint after its first update, resumed
    (:func:`onpolicy_resume`)."""
    return onpolicy_resume(out, snaps, cfg, PPO_ATARI_ARGS, "ppo", log_root, "ppo resume")


def onpolicy_resume(out, snaps, cfg, args, trainer, log_root, what):
    """The run's first checkpoint: loaded with its digest verified, it holds
    the agent and optimizer state of the update it follows bit for bit; a
    fresh agent and optimizer on the card restore every tensor of it bit for
    bit; the CLI resumed from it starts its update from exactly those
    tensors and the checkpoint's (annealed) learning rate, at the
    checkpoint's policy step, and logs where the JAX ``main`` would
    (``ppo.py:274-275``, ``:353-360``; ``a2c.py:175-180``;
    ``ppo_recurrent.py:226-232``). The JAX checkpoint holds no env state,
    rollout key or carry, so the resumed rollout is not compared with the
    uninterrupted one."""
    import numpy as np

    from sheeprl_tpu_torch.algos.ppo.ppo import make_optimizer
    from sheeprl_tpu_torch.optim import load_optimizer_state
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    per_iter = int(cfg.env.num_envs) * int(cfg.algo.rollout_steps)
    total_iters = int(cfg.algo.total_steps) // per_iter
    mid = out["checkpoints"][0]
    t0 = time.perf_counter()
    state = load_checkpoint(mid)
    load_s = time.perf_counter() - t0
    it = int(state["iter_num"])
    # the first update whose policy step reaches checkpoint.every (``ppo.py:615``, ``a2c.py:372``, ``ppo_recurrent.py:506``)
    want = -(-int(cfg.checkpoint.every) // per_iter)
    if not it == want < total_iters or state["last_checkpoint"] != it * per_iter or not mid.endswith(f"ckpt_{it * per_iter}_0.ckpt"):
        fail(f"{what}: {mid} holds iteration {it}, last checkpoint {state['last_checkpoint']}, expected iteration {want}")
    saved = (state["agent"], [state["optimizer"]["state"][i] for i in range(len(state["optimizer"]["state"]))])
    bad = _same_bits(snaps["after"][it - 1][:2], saved)
    if bad:
        fail(f"{what}: the checkpoint differs from the state after update {it} at {bad[:5]}")
    base = float(cfg.algo.optimizer.lr)
    lr = float(np.float32(base * (1 - it / total_iters))) if cfg.algo.anneal_lr else base
    if state["optimizer"]["param_groups"][0]["lr"] != lr:
        fail(f"{what}: the checkpoint's learning rate is {state['optimizer']['param_groups'][0]['lr']}, expected {lr}")
    obs_space, actions_dim, continuous = _ppo_spaces(cfg)
    agent = _onpolicy_agent(trainer).build_agent(actions_dim, continuous, cfg, obs_space, precision=cfg.fabric.precision, device="cuda", seed=123)
    optimizer, _ = make_optimizer(agent, cfg)
    agent.load_state_dict(state["agent"])
    load_optimizer_state(optimizer, state["optimizer"])
    fresh = _ppo_snapshot(agent, optimizer)
    bad = _same_bits(fresh[:2], saved)
    if bad or fresh[2] != lr:
        fail(f"{what}: restored on the card, {bad[:5]} differ, learning rate {fresh[2]}")
    restored = len(fresh[0]) + sum(len(s) for s in fresh[1])
    del agent, optimizer
    resumed, trace, rsnaps, wall_s, _ = ppo_through_cli([*args, f"log_root={log_root}", f"checkpoint.resume_from={mid}"], f"{what}d", trainer)
    bad = _same_bits(rsnaps["before"][:2], saved)
    if bad or rsnaps["before"][2] != lr:
        fail(f"{what}: the resumed update started from other tensors ({bad[:5]}) or learning rate {rsnaps['before'][2]}")
    if resumed["updates"] != total_iters - it or resumed["policy_steps"] != per_iter * total_iters:
        fail(f"{what}: {resumed['updates']} updates to policy step {resumed['policy_steps']}, expected {total_iters - it} to {per_iter * total_iters}")
    check_ppo_logged(resumed, cfg, trace, f"{what}d", first_iter=it + 1, last_log=int(state["last_log"]),
                     info=ONPOLICY[trainer]["info"], losses=ONPOLICY[trainer]["losses"])  # fmt: skip
    result = {"checkpoint": mid, "load_s": load_s, "tensors_restored_bit_identical": restored, "learning_rate": lr,
              "resumed_updates": resumed["updates"], "resumed_wall_s": wall_s}  # fmt: skip
    log(f"{what}: {os.path.basename(mid)} loaded with its digest verified in {load_s:.2f} s; {restored} tensors restored on the "
        f"card bit for bit; the resumed CLI run started its update from them at learning rate {lr} and took {resumed['updates']} "
        f"update(s) to policy step {resumed['policy_steps']} in {wall_s:.1f} s, logging at the JAX package's steps")  # fmt: skip
    return result


def phase_ppo_serve(ckpt, obs_shape, workdir):
    """ppo_atari's checkpoint exported and served over HTTP on the card:
    greedy requests repeated give the same bytes, sampled ones repeated with
    their seeds give the same actions, and every action is an index in the
    dummy env's range."""
    import numpy as np

    from sheeprl_tpu_torch.serve import cli as serve_cli
    from sheeprl_tpu_torch.serve.cli import SERVE_DEFAULTS
    from sheeprl_tpu_torch.serve.engine import InferenceEngine
    from sheeprl_tpu_torch.serve.server import PolicyServer

    path = os.path.join(workdir, "ppo_atari.policy")
    serve_cli.main(["export", f"checkpoint_path={ckpt}", "name=ppo_atari", f"output_path={path}"])
    engine = InferenceEngine(max_batch=SERVE_DEFAULTS["max_batch"], queue_capacity=SERVE_DEFAULTS["queue_capacity"],
                             batch_window_s=SERVE_DEFAULTS["batch_window_ms"] / 1000.0, device="cuda")  # fmt: skip
    card = engine.load("ppo_atari", path)
    server = PolicyServer(engine, host="127.0.0.1", port=0).start()
    try:
        status, models = http(server.address, "/v1/models")
        n = models["models"]["ppo_atari"]["action_space"].get("n")
        if status != 200 or not n:
            fail(f"ppo serve: /v1/models {status} {models}")
        rng = np.random.default_rng(5)
        obs = [rng.integers(0, 256, obs_shape, dtype=np.uint8).tolist() for _ in range(3)]

        def act(mode, seed, o):
            return http(server.address, "/v1/act", {"model": "ppo_atari", "obs": {"rgb": o}, "mode": mode, "seed": seed})[1]["action"]

        with ThreadPoolExecutor(3) as pool:
            greedy = list(pool.map(lambda o: act("greedy", 0, o), obs))
            again = list(pool.map(lambda o: act("greedy", 1, o), obs))
            sampled = list(pool.map(lambda s: [act("sample", s, o) for o in obs], range(3)))
            resampled = list(pool.map(lambda s: [act("sample", s, o) for o in obs], range(3)))
        stats = engine.stats()
    finally:
        server.close(drain=True)
    if json.dumps(greedy) != json.dumps(again):
        fail(f"ppo serve: repeated greedy requests differ: {greedy} vs {again}")
    if sampled != resampled:
        fail(f"ppo serve: sampled requests repeated with their seeds differ: {sampled} vs {resampled}")
    flat = greedy + [a for s in sampled for a in s]
    if not all(len(a) == 1 and isinstance(a[0], int) and 0 <= a[0] < n for a in flat) or stats["counters"]["errors"]:
        fail(f"ppo serve: actions out of [0, {n}): {flat} ({stats['counters']})")
    result = {"requests": stats["counters"]["requests"], "batches": stats["counters"]["batches"], "greedy_actions": greedy,
              "sampled_actions": sampled, "precision": card["precision"]}  # fmt: skip
    log(f"ppo serve: {os.path.basename(ckpt)} exported and served ({card['precision']} on {card['device']}): {result['requests']} requests "
        f"in {result['batches']} batches, greedy repeats byte-identical, seeded samples repeatable, every action in [0, {n})")  # fmt: skip
    return result


def _ppo_rollout(cfg, T, E, dev, seed):
    """A rollout at the exp's shapes on ``dev`` (observations as stored)
    and the observation after it."""
    import numpy as np
    import torch

    obs_space, actions_dim, continuous = _ppo_spaces(cfg)
    keys = list(cfg.algo.cnn_keys.encoder) + list(cfg.algo.mlp_keys.encoder)
    rng = np.random.default_rng(seed)

    def obs(n):
        return {k: rng.integers(0, 256, (n, *obs_space[k].shape)).astype(np.uint8) if k in cfg.algo.cnn_keys.encoder
                else rng.normal(size=(n, *obs_space[k].shape)).astype(np.float32) for k in keys}  # fmt: skip

    data = {k: v.reshape(T, E, *v.shape[1:]) for k, v in obs(T * E).items()}
    if continuous:
        data["actions"] = rng.normal(size=(T, E, sum(actions_dim))).astype(np.float32)
    else:
        data["actions"] = np.concatenate([np.eye(d, dtype=np.float32)[rng.integers(0, d, (T, E))] for d in actions_dim], -1)
    data["logprobs"] = rng.normal(-1.0, 0.3, (T, E, 1)).astype(np.float32)
    data["rewards"] = rng.normal(size=(T, E, 1)).astype(np.float32)
    data["values"] = rng.normal(size=(T, E, 1)).astype(np.float32)
    data["dones"] = (rng.random((T, E, 1)) < 0.01).astype(np.uint8)
    to = lambda tree: {k: torch.from_numpy(v).to(dev) for k, v in tree.items()}  # noqa: E731
    return to(data), to(obs(E))


def phase_ppo_profile(agent, cfg, what):
    """Where one update and one rollout step of the exp's trained agent
    spend their time on the card (32-true): host wall (ending in a
    synchronize), device busy and idle share from torch.profiler, device
    operations, and peak memory; GAE (a loop over T on the card) timed on
    its own."""
    import torch

    from sheeprl_tpu_torch.algos.ppo.ppo import make_optimizer, make_train_step, minibatch_indices
    from sheeprl_tpu_torch.utils.utils import prepare_obs
    from sheeprl_tpu_torch.core.rollout import fuse_gae_pool
    from sheeprl_tpu_torch.utils.distribution import BatchGenerator

    dev = torch.device("cuda")
    T, E, mb, epochs = int(cfg.algo.rollout_steps), int(cfg.env.num_envs), int(cfg.algo.per_rank_batch_size), int(cfg.algo.update_epochs)
    keys = list(cfg.algo.cnn_keys.encoder) + list(cfg.algo.mlp_keys.encoder)
    data, next_obs = _ppo_rollout(cfg, T, E, dev, 11)
    optimizer, _ = make_optimizer(agent, cfg)
    step = make_train_step(agent, optimizer, cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    clip, ent = (torch.tensor(float(v), device=dev) for v in (cfg.algo.clip_coef, cfg.algo.ent_coef))

    def update():
        return step(data, next_obs, minibatch_indices(T * E, mb, epochs, gen), clip, ent)

    def busy(prof, n):
        return _busy(prof.key_averages(), n, skip=("ppo/",))[:2]

    update()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(2):
        update()
    torch.cuda.synchronize()
    update_ms = (time.perf_counter() - t0) / 2 * 1e3
    update_peak = torch.cuda.max_memory_allocated() / 2**30
    update_busy, update_ops = busy(profiled(update, ("cpu", "cuda")), 1)
    if update_busy <= 0.0:
        fail(f"{what}: torch.profiler saw no device time in the update")
    gae_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            fuse_gae_pool(agent, data, next_obs, (*keys, "actions", "logprobs"), float(cfg.algo.gamma), float(cfg.algo.gae_lambda))
        torch.cuda.synchronize()
        gae_ms.append((time.perf_counter() - t0) * 1e3)
    gae_busy, gae_ops = busy(profiled(lambda: fuse_gae_pool(agent, data, next_obs, keys, 0.99, 0.95), ("cpu", "cuda")), 1)

    host_obs = {k: v[0].cpu().numpy() for k, v in data.items() if k in keys}
    rng = BatchGenerator.from_seed(0, dev)

    def rollout_step():
        prepared = prepare_obs(host_obs, cnn_keys=list(cfg.algo.cnn_keys.encoder), num_envs=E)
        with torch.no_grad():
            actions, real, logprobs, values = agent.player_step({k: torch.from_numpy(v).to(dev) for k, v in prepared.items()}, rng)
            torch.cat([actions.float(), logprobs, values], -1).cpu()

    for _ in range(5):
        rollout_step()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(50):
        rollout_step()
    step_ms = (time.perf_counter() - t0) / 50 * 1e3
    step_peak = torch.cuda.max_memory_allocated() / 2**30
    step_busy, step_ops = busy(profiled(lambda: [rollout_step() for _ in range(20)], ("cpu", "cuda")), 20)
    adam_steps = epochs * -(-T * E // mb)
    result = {
        "update": {"host_wall_ms": update_ms, "device_busy_ms": update_busy, "idle_share": 1 - update_busy / update_ms,
                   "device_ops": update_ops, "adam_steps": adam_steps, "peak_gib": update_peak},
        "gae": {"host_wall_ms": statistics.median(gae_ms), "device_busy_ms": gae_busy, "device_ops": gae_ops, "T": T, "E": E},
        "rollout_step": {"host_wall_ms": step_ms, "device_busy_ms": step_busy, "idle_share": 1 - step_busy / step_ms,
                         "device_ops": step_ops, "peak_gib": step_peak, "num_envs": E},
    }  # fmt: skip
    log(f"{what}: update ({adam_steps} Adam steps over {T} x {E} rows) {update_ms:.1f} ms host wall, {update_busy:.1f} ms device busy "
        f"(idle {result['update']['idle_share']:.2f}), {update_ops:.0f} device operations, peak {update_peak:.2f} GiB; of it GAE over "
        f"T = {T}: {result['gae']['host_wall_ms']:.1f} ms host wall, {gae_busy:.2f} ms busy, {gae_ops:.0f} operations; rollout step "
        f"(player forward + one copy to the host, {E} envs) {step_ms:.3f} ms host wall, {step_busy:.3f} ms busy "
        f"(idle {result['rollout_step']['idle_share']:.2f}), {step_ops:.0f} operations")  # fmt: skip
    return result


# The card's ppo_atari update against the CPU's, per leaf (see
# phase_ppo_reference). On an H100 the sound update reads 0.078 (change) and
# 0.20 (moments), the card's own update from weights one ulp away 0.052 and
# 0.099 (Adam's eps of 1e-6 turns rounding-size gradients into whole steps),
# and the planted faults 1.0-1.42 and 1.0-1.68: each limit sits between.
PPO_PARAM_CHANGE_TOL = 0.3
PPO_MOMENT_TOL = 0.5
PPO_REF_TOL = {"loss_rtol": 1e-3, "loss_atol": 1e-5, "param_change": PPO_PARAM_CHANGE_TOL, "adam_moment": PPO_MOMENT_TOL}
# Planted faults of the card's update that the parameter check must see.
PPO_FAULTS = ("lr x 2", "last leaf's gradient zeroed")


def _relative_gaps(got, want, got_start=None, want_start=None):
    """Per leaf: ``||got - want|| / ||want||``, each taken as its change from
    its start when the starts are given."""
    gaps = {}
    for k in want:
        g, w = got[k].double(), want[k].double()
        if want_start is not None:
            g, w = g - got_start[k].double(), w - want_start[k].double()
        if w.norm() == 0:
            fail(f"ppo reference: {k} did not move")
        gaps[k] = ((g - w).norm() / w.norm()).item()
    return gaps


def phase_ppo_reference():
    """One ppo_atari update (NatureCNN at 84x84x12, 1024 rows, batch 256,
    3 epochs: 12 Adam steps, max_grad_norm 0.5) on the card in 32-true with
    TF32 off against the same update on the CPU, from the same weights, data
    and permutation. Tolerances: the mean losses within rtol 1e-3 + atol
    1e-5 (f32 convolutions and sums in another order); each parameter
    leaf's change from the start, ``||d_card - d_cpu|| / ||d_cpu||``, and
    each leaf's Adam moments, ``||m_card - m_cpu|| / ||m_cpu||``, within
    ``PPO_PARAM_CHANGE_TOL`` and ``PPO_MOMENT_TOL``. The card's update is
    also run from weights one f32 ulp away (its own sensitivity to rounding,
    reported) and with each of ``PPO_FAULTS`` planted, which the parameter
    check must reject: a check that passes them cannot see a wrong update."""
    import torch

    from sheeprl_tpu_torch.algos.ppo.agent import build_agent
    from sheeprl_tpu_torch.algos.ppo.ppo import make_optimizer, make_train_step, minibatch_indices
    from sheeprl_tpu_torch.config import compose

    cfg = compose([*PPO_ATARI_ARGS, "device=cpu"])
    obs_space, actions_dim, continuous = _ppo_spaces(cfg)
    T, E, mb, epochs = int(cfg.algo.rollout_steps), int(cfg.env.num_envs), int(cfg.algo.per_rank_batch_size), int(cfg.algo.update_epochs)
    indices = minibatch_indices(T * E, mb, epochs, torch.Generator().manual_seed(3))

    def update(where, fault=None):
        agent = build_agent(actions_dim, continuous, cfg, obs_space, device=where, seed=7)
        if fault == "nudge":
            with torch.no_grad():
                for p in agent.parameters():
                    p.mul_(1 + 2.0**-23)
        start = {k: v.detach().cpu().clone() for k, v in agent.state_dict().items()}
        optimizer, _ = make_optimizer(agent, cfg)
        if fault == "lr x 2":
            for group in optimizer.param_groups:
                group["lr"] = 2 * group["lr"]
        elif fault == "last leaf's gradient zeroed":
            list(agent.parameters())[-1].register_hook(torch.zeros_like)
        data, next_obs = _ppo_rollout(cfg, T, E, torch.device(where), 13)
        step = make_train_step(agent, optimizer, cfg)
        clip, ent = (torch.tensor(float(v), device=where) for v in (cfg.algo.clip_coef, cfg.algo.ent_coef))
        metrics = step(data, next_obs, indices.to(where), clip, ent)
        names = dict(agent.named_parameters())
        moments = {f"{m} {n}": optimizer.state[p][m].detach().cpu() for n, p in names.items() for m in ("exp_avg", "exp_avg_sq")}
        return ({k: float(v) for k, v in metrics.items()}, start, {k: v.detach().cpu() for k, v in agent.state_dict().items()}, moments)

    cpu_m, cpu_start, cpu_p, cpu_mom = update("cpu")
    gpu_m, gpu_start, gpu_p, gpu_mom = update("cuda")
    if any(not torch.equal(gpu_start[k], cpu_start[k]) for k in cpu_start):
        fail("ppo reference: the card's agent does not start from the CPU's weights")
    for k in cpu_m:
        if abs(gpu_m[k] - cpu_m[k]) > PPO_REF_TOL["loss_atol"] + PPO_REF_TOL["loss_rtol"] * abs(cpu_m[k]):
            fail(f"ppo reference: {k} {gpu_m[k]} on the card, {cpu_m[k]} on the CPU")
    adam_steps = epochs * -(-T * E // mb)

    def worst(gaps):
        k = max(gaps, key=gaps.get)
        return {"leaf": k, "gap": gaps[k]}

    param = worst(_relative_gaps(gpu_p, cpu_p, gpu_start, cpu_start))
    moment = worst(_relative_gaps(gpu_mom, cpu_mom))
    if param["gap"] > PPO_PARAM_CHANGE_TOL:
        fail(f"ppo reference: {param['leaf']}'s change on the card differs from the CPU's by {param['gap']} of its norm (> {PPO_PARAM_CHANGE_TOL})")
    if moment["gap"] > PPO_MOMENT_TOL:
        fail(f"ppo reference: Adam's {moment['leaf']} differs on the card by {moment['gap']} of its norm (> {PPO_MOMENT_TOL})")
    # The card's own sensitivity to rounding: its update from weights one
    # f32 ulp away, against its update.
    _, nudge_start, nudge_p, nudge_mom = update("cuda", "nudge")
    floor = {"param": worst(_relative_gaps(nudge_p, gpu_p, nudge_start, gpu_start)), "adam_moment": worst(_relative_gaps(nudge_mom, gpu_mom))}
    faults = {}
    for fault in PPO_FAULTS:
        f_m, f_start, f_p, f_mom = update("cuda", fault)
        faults[fault] = {"param": worst(_relative_gaps(f_p, cpu_p, f_start, cpu_start)), "adam_moment": worst(_relative_gaps(f_mom, cpu_mom)),
                         "loss_rel": max(abs(f_m[k] - cpu_m[k]) / abs(cpu_m[k]) for k in cpu_m)}  # fmt: skip
        if faults[fault]["param"]["gap"] <= PPO_PARAM_CHANGE_TOL:
            fail(f"ppo reference: the update with {fault} passes the parameter check ({faults[fault]['param']})")
    log(f"ppo reference: one ppo_atari update ({adam_steps} Adam steps), card against CPU in 32-true: losses "
        f"{json.dumps({k: [gpu_m[k], cpu_m[k]] for k in cpu_m})} (rtol {PPO_REF_TOL['loss_rtol']}); worst leaf's change "
        f"{param['gap']:.3g} of its norm ({param['leaf']}, limit {PPO_PARAM_CHANGE_TOL}); worst Adam moment {moment['gap']:.3g} "
        f"({moment['leaf']}, limit {PPO_MOMENT_TOL}); the card from weights one ulp away {json.dumps(floor)}; planted faults "
        f"{json.dumps(faults)}")  # fmt: skip
    return {"losses_card": gpu_m, "losses_cpu": cpu_m, "worst_param_change": param, "worst_adam_moment": moment,
            "one_ulp_nudge": floor, "planted_faults": faults, "tolerance": PPO_REF_TOL}  # fmt: skip


def phase_ppo_pixels(log_root, workdir):
    """ppo_atari through the CLI, then its resume, export and serving, and
    ``python -m sheeprl_tpu_torch.eval``."""
    pixels, out, snaps, cfg = ppo_train(PPO_ATARI_ARGS, PPO_ATARI_CUTS, "ppo_atari", log_root, 2)
    resume = phase_ppo_resume(out, snaps, cfg, log_root)
    obs_shape = _ppo_spaces(cfg)[0]["rgb"].shape
    serving = phase_ppo_serve(out["checkpoints"][-1], obs_shape, workdir)
    evaluation = phase_eval(out["checkpoints"][-1], out["test_reward"])
    return pixels, resume, serving, evaluation, out, cfg


# The fused path: the replay ring in card memory and the train step
# captured as a CUDA graph that samples it (buffer.device=True).
FUSED_CUTS = {"buffer.device": "True (from False)"}
WALKER_FUSED_CUTS = {"buffer.device": "True (from False)", "algo.fused_train_steps": "2 (from 1)"}
GRAPH_RING_ROWS = 1024  # rows per env of the graph-against-eager phase's ring (at the exp's shapes)
GRAPH_TAUS = (0.02, 0.0, 1.0, 0.02, 0.02, 0.0, 0.02, 0.02)  # 8 steps: the EMA's blend, its tau-0 and tau-1 cases
GRAPH_LN_GRU = {"discrete": {"streaming": STREAM_PER_STEP, "tensor_core": TC_PER_STEP, "backward": BWD_PER_STEP},
                "continuous": {"streaming": STREAM_PER_STEP, "tensor_core": TC_PER_STEP, "backward": BWD_PER_STEP + TC_PER_STEP}}  # fmt: skip
REPLAYS_PROFILED = 16
WARMUP_STEPS = 3  # sheeprl_tpu_torch.core.graphs.WARMUP_CALLS


def _ring_rows(rows, n_envs, n_actions, continuous, seed):
    """``rows`` steps of random rows at the exp's shapes for every env."""
    import numpy as np

    rng = np.random.default_rng(seed)
    if continuous:
        actions = rng.uniform(-1, 1, (rows, n_envs, n_actions)).astype(np.float32)
    else:
        actions = np.eye(n_actions, dtype=np.float32)[rng.integers(0, n_actions, (rows, n_envs))]
    return {
        "rgb": rng.integers(0, 256, (rows, n_envs, 64, 64, 3), dtype=np.uint8),
        "actions": actions,
        "rewards": rng.normal(size=(rows, n_envs, 1)).astype(np.float32),
        "terminated": (rng.random((rows, n_envs, 1)) < 0.05).astype(np.float32),
        "truncated": np.zeros((rows, n_envs, 1), np.float32),
        "is_first": (rng.random((rows, n_envs, 1)) < 0.05).astype(np.float32),
    }


def _train_state(agent, optimizers):
    """Every parameter and every Adam state tensor, in a fixed order."""
    params = [p for name in MODULES for p in getattr(agent, name).parameters()]
    adam = [v for name in ("world_model", "actor", "critic") for p in optimizers[name].param_groups[0]["params"]
            for _, v in sorted(optimizers[name].state[p].items())]  # fmt: skip
    return params, adam


def _gaps(a, b):
    """Per group: (max |a - b| over its tensors, bit for bit equal)."""
    out = {}
    for group in a:
        d = max(((x.double() - y.double()).abs().max().item() if x.numel() else 0.0) for x, y in zip(a[group], b[group]))
        same = all(torch_equal_bits(x, y) for x, y in zip(a[group], b[group]))
        out[group] = {"max_abs": d, "bit_for_bit": same}
    return out


def torch_equal_bits(x, y):
    import torch

    if x.dtype.is_floating_point:
        width = {2: torch.int16, 4: torch.int32, 8: torch.int64}[x.element_size()]
        return torch.equal(x.contiguous().view(width), y.contiguous().view(width))
    return torch.equal(x, y)


def phase_graph_vs_eager(kind):
    """The captured step against the eager one, on the card, at full DV3-S
    width (bf16-mixed, B = 16, T = 64, horizon 15), sampling a ring of
    ``GRAPH_RING_ROWS`` rows per env filled at the exp's shapes (MsPacman:
    1 env, 9 actions; the walker: 4 envs, 6 actions in [-1, 1]). The fused
    step warms up (its ``WARMUP_STEPS`` eager steps, the first under the
    sync check); then from one snapshot (every parameter, Adam state, the
    moments and the generator's state) 8 eager steps twice (the eager
    path's run-to-run difference) and 8 replays of the graph, with the taus
    ``GRAPH_TAUS``. Every parameter, Adam state, the moments and each step's
    metrics must be equal bit for bit, or, if the two eager runs differ,
    within that difference. The graph must hold ``GRAPH_LN_GRU`` LN-GRU
    kernel nodes. Then ``REPLAYS_PROFILED`` back-to-back replays and 3 eager
    steps from the same state, timed (host wall ending in a synchronize) and
    profiled (device busy, operations)."""
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import make_fused_train_step, make_optimizers, make_train_step
    from sheeprl_tpu_torch.algos.ppo.agent import actions_metadata
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.data.device_buffer import DeviceReplayRing
    from sheeprl_tpu_torch.envs.dummy import ContinuousDummyEnv
    from sheeprl_tpu_torch.models import ln_gru
    from sheeprl_tpu_torch.serve.spaces import Box, DictSpace
    from sheeprl_tpu_torch.utils.distribution import BatchGenerator
    from sheeprl_tpu_torch.utils.ops import init_moments

    what = f"graph vs eager ({kind})"
    continuous = kind == "continuous"
    cfg = compose(WALKER_ARGS if continuous else TRAIN_ARGS)
    dev = torch.device("cuda")
    if continuous:
        env = ContinuousDummyEnv(action_dim=6)
        actions_dim, is_cont = actions_metadata(env.action_space)
        space = env.observation_space
    else:
        actions_dim, is_cont, space = (9,), False, DictSpace({"rgb": Box((64, 64, 3), "uint8", 0.0, 255.0)})
    agent = build_agent(actions_dim, is_cont, cfg, space, precision=cfg.fabric.precision, device=dev, seed=cfg.seed, training=True)
    optimizers = make_optimizers(agent, cfg)
    n_envs, batch, seq = int(cfg.env.num_envs), int(cfg.algo.per_rank_batch_size), int(cfg.algo.per_rank_sequence_length)
    ring = DeviceReplayRing(GRAPH_RING_ROWS, n_envs, cnn_keys=("rgb",), obs_keys=("rgb",), device=dev)
    ring.add(_ring_rows(GRAPH_RING_ROWS, n_envs, sum(actions_dim), continuous, 17))
    ring.flush()
    if not (ring.active and ring.ready(seq)):
        fail(f"{what}: the ring is not active and ready: {ring.inactive_reason}")
    sample = ring.make_sample_fn(batch, seq, time_major=True)
    rng = BatchGenerator.from_seed(cfg.seed, dev)
    fused = make_fused_train_step(agent, optimizers, cfg, lambda state, r: sample(state, r.generator), rng)
    moments, _ = fused(init_moments(dev), ring.state, [1.0] + [0.02] * (WARMUP_STEPS - 1))  # the warm-up steps
    torch.cuda.synchronize()
    if fused.captured.warmup_calls != WARMUP_STEPS or fused.captured.graph is not None:
        fail(f"{what}: {fused.captured.warmup_calls} warm-up steps, graph {fused.captured.graph}")
    params, adam = _train_state(agent, optimizers)
    snap = {"params": [p.detach().clone() for p in params], "adam": [a.clone() for a in adam],
            "moments": {k: v.clone() for k, v in moments.items()}, "rng": rng.generator.get_state()}  # fmt: skip

    def restore():
        with torch.no_grad():
            for p, s in zip(params, snap["params"]):
                p.copy_(s)
            for a, s in zip(adam, snap["adam"]):
                a.copy_(s)
        rng.generator.set_state(snap["rng"])

    def result(m, per_step):
        p, a = _train_state(agent, optimizers)
        return {"params": [x.detach().clone() for x in p], "adam": [x.clone() for x in a],
                "moments": [m["low"].clone(), m["high"].clone()], "metrics": [torch.stack(per_step)]}  # fmt: skip

    step = make_train_step(agent, optimizers, cfg)
    tau = torch.zeros((), device=dev)

    def eager_run():
        restore()
        m, per_step = {k: v.clone() for k, v in snap["moments"].items()}, []
        for t in GRAPH_TAUS:
            tau.fill_(t)
            m, metrics = step(m, sample(ring.state, rng.generator), rng, tau)
            per_step.append(torch.stack([metrics[k].float() for k in fused.names]))
        torch.cuda.synchronize()
        return result(m, per_step)

    eager_a, eager_b = eager_run(), eager_run()
    restore()
    per_step = []
    t0 = time.perf_counter()
    m, _ = fused(snap["moments"], ring.state, GRAPH_TAUS, lambda i, metrics: per_step.append(torch.stack(list(metrics.values()))))
    torch.cuda.synchronize()
    capture_and_replay_s = time.perf_counter() - t0
    graph = result(m, per_step)
    if fused.captured.replays != len(GRAPH_TAUS):
        fail(f"{what}: {fused.captured.replays} replays for {len(GRAPH_TAUS)} steps")
    eager_gap, graph_gap = _gaps(eager_a, eager_b), _gaps(eager_a, graph)
    for group, gap in graph_gap.items():
        allowed = 0.0 if eager_gap[group]["bit_for_bit"] else eager_gap[group]["max_abs"]
        if not gap["bit_for_bit"] and gap["max_abs"] > allowed:
            fail(f"{what}: the graph's {group} differ from the eager step's by {gap['max_abs']} (two eager runs: {eager_gap[group]})")
    nodes = fused.captured.nodes
    if nodes["ln_gru"] != GRAPH_LN_GRU[kind]:
        fail(f"{what}: the graph holds LN-GRU kernel nodes {nodes['ln_gru']}, expected {GRAPH_LN_GRU[kind]}")
    # Each call's last block resets the arrival tickets it used, so the
    # replayed kernels find them at zero (models/ln_gru.py: _TICKETS).
    stream = fused.captured.stream.cuda_stream
    left = {k: int(t.abs().sum()) for (_, st, k), t in ln_gru._TICKETS.items() if st == stream}
    if not left or any(left.values()):
        fail(f"{what}: the capture stream's LN-GRU tickets after the replays: {left}")

    # 16 back-to-back replays, then 3 eager steps, from the state the replays left.
    taus = [0.02] * REPLAYS_PROFILED
    fused(m, ring.state, taus)  # settled
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    m, _ = fused(m, ring.state, taus)
    end.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / REPLAYS_PROFILED
    span_ms = start.elapsed_time(end) / REPLAYS_PROFILED
    profiled_wall = []

    def replays():
        t = time.perf_counter()
        fused(m, ring.state, taus)
        torch.cuda.synchronize()
        profiled_wall.append((time.perf_counter() - t) * 1e3 / REPLAYS_PROFILED)

    prof = profiled(replays, ("cpu", "cuda"))
    busy_ms, ops, _ = _busy(prof.key_averages(), REPLAYS_PROFILED, skip=("dv3/",))
    eager_moments = {k: v.clone() for k, v in m.items()}
    tau.fill_(0.02)
    step(eager_moments, sample(ring.state, rng.generator), rng, tau)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        eager_moments, _ = step(eager_moments, sample(ring.state, rng.generator), rng, tau)
    torch.cuda.synchronize()
    eager_wall_ms = (time.perf_counter() - t0) * 1e3 / 3
    out = {
        "ring_rows_per_env": GRAPH_RING_ROWS, "n_envs": n_envs, "taus": list(GRAPH_TAUS), "warmup_steps": fused.captured.warmup_calls,
        "eager_vs_eager": eager_gap, "graph_vs_eager": graph_gap, "capture_and_8_replays_s": capture_and_replay_s,
        "graph_nodes": nodes["nodes"], "graph_nodes_by_type": nodes["by_type"], "graph_ln_gru_nodes": nodes["ln_gru"],
        "ln_gru_tickets_after_replays": left,
        "graph_kernel_nodes": nodes["by_type"].get("kernel", 0), "eager_device_ops_per_step": STEP_OPS[kind],
        "replays_profiled": REPLAYS_PROFILED, "fused_host_wall_ms_per_step": wall_ms, "fused_event_span_ms_per_step": span_ms,
        "fused_device_busy_ms_per_step": busy_ms, "fused_device_ops_per_step": ops,
        "fused_host_wall_ms_per_step_profiled": profiled_wall[-1], "fused_device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "fused_device_idle_share_under_the_profiler": max(0.0, 1.0 - busy_ms / profiled_wall[-1]),
        "fused_gradient_steps_per_s": 1e3 / wall_ms,
        "eager_host_wall_ms_per_step": eager_wall_ms, "eager_gradient_steps_per_s": 1e3 / eager_wall_ms,
    }  # fmt: skip
    if busy_ms <= 0.0:
        fail(f"{what}: torch.profiler saw no device time in the replays")
    if out["fused_device_idle_share"] > 0.25:
        fail(f"{what}: the replayed step leaves the device idle {out['fused_device_idle_share']:.3f} of the time (at most 0.25)")
    log(f"{what}: DV3-S {cfg.fabric.precision}, B={batch} T={seq}, ring {GRAPH_RING_ROWS} rows x {n_envs} envs; {WARMUP_STEPS} eager warm-up "
        f"steps (the first under the sync check), then 8 steps from one snapshot: eager vs eager {json.dumps(eager_gap)}; graph vs eager "
        f"{json.dumps(graph_gap)}")  # fmt: skip
    log(f"{what}: the graph holds {nodes['nodes']} nodes ({json.dumps(nodes['by_type'])}), LN-GRU kernel nodes {json.dumps(nodes['ln_gru'])}; "
        f"the eager step runs {STEP_OPS[kind]} device operations")  # fmt: skip
    log(f"{what}: {REPLAYS_PROFILED} back-to-back replays: host wall {wall_ms:.2f} ms/step (events {span_ms:.2f}), device busy "
        f"{busy_ms:.2f} ms/step, {ops:.0f} device ops/step, idle share {out['fused_device_idle_share']:.3f} (under the "
        f"profiler {profiled_wall[-1]:.2f} ms/step, {out['fused_device_idle_share_under_the_profiler']:.3f}), "
        f"{out['fused_gradient_steps_per_s']:.2f} gradient steps/s; eager from the same state {eager_wall_ms:.2f} ms/step "
        f"({out['eager_gradient_steps_per_s']:.2f} steps/s)")  # fmt: skip
    del fused, ring, agent, optimizers, step, snap, eager_a, eager_b, graph
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_fused_through_cli(args, what, keep_params=False):
    """One run of the trainer through its CLI entry point with the ring
    (``buffer.device=True``): every gradient step's metrics finite, and the
    iterations of gradient steps and episode ends, as
    :func:`train_through_cli` records them for :func:`check_logged`.
    Returns (out, steps, wall_s, counts, trace)."""
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.envs.dummy import SyncVectorEnv

    trace = {"env_steps": 0, "grad_iters": [], "episode_iters": [], "save_s": []}
    steps = []
    env_step, save_checkpoint = SyncVectorEnv.step, dv3.save_checkpoint

    def recording_env_step(envs, actions):
        result = env_step(envs, actions)
        trace["env_steps"] += 1
        if result[4]["episode"]:
            trace["episode_iters"].append(trace["env_steps"])
        return result

    def timed_save(*a, **kw):
        t0 = time.perf_counter()
        path = save_checkpoint(*a, **kw)
        trace["save_s"].append(time.perf_counter() - t0)
        return path

    def on_step(agent, step, tau, metrics):
        values = {k: v.item() for k, v in metrics.items()}
        if not all(math.isfinite(v) for v in values.values()):
            fail(f"{what}: non-finite metrics at gradient step {step}: {values}")
        params = {n: _params(getattr(agent, n)) for n in MODULES} if keep_params else None
        steps.append((step, tau, time.perf_counter(), values, params))
        trace["grad_iters"].append(trace["env_steps"])

    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    with patched(SyncVectorEnv, "step", recording_env_step), patched(dv3, "save_checkpoint", timed_save):
        out = run(args, callback=on_step)
    torch.cuda.synchronize()
    return out, steps, time.perf_counter() - t0, read_counts(), trace


def check_fused(out, steps, cfg, what, kind, counts, first_step=1):
    """The ring was active at the recipe's size and every gradient step ran
    on the fused path: ``WARMUP_STEPS`` eager warm-up steps, then the graph,
    holding ``GRAPH_LN_GRU[kind]`` LN-GRU kernel nodes, replayed for the
    rest; each LN-GRU kernel's wrapper launched it during the run (the
    warm-up steps and the capture: ``counts``, zeroed just before)."""
    if not all(counts[k] > 0 for k in ("streaming", "tensor_core", "backward")):
        fail(f"{what}: an LN-GRU kernel was never launched in the run: {counts}")
    ring, fused, n = out["device_buffer"], out["fused"], out["gradient_steps"]
    rows = int(cfg.buffer.size) // int(cfg.env.num_envs)
    if not ring or not ring["active"] or ring["capacity"] != rows:
        fail(f"{what}: the ring was not active at {rows} rows per env: {ring}")
    if [s[0] for s in steps] != list(range(first_step, n + 1)) or not fused or fused["gradient_steps"] != len(steps):
        fail(f"{what}: gradient steps {[s[0] for s in steps]}, fused {fused}")
    if fused["warmup_steps"] != WARMUP_STEPS or fused["replays"] != len(steps) - WARMUP_STEPS:
        fail(f"{what}: {fused['warmup_steps']} warm-up steps and {fused['replays']} replays for {len(steps)} steps")
    if fused["graph"]["ln_gru"] != GRAPH_LN_GRU[kind]:
        fail(f"{what}: the graph holds LN-GRU kernel nodes {fused['graph']['ln_gru']}, expected {GRAPH_LN_GRU[kind]}")
    if out["infeed"] != {"hits": 0, "misses": 0}:
        fail(f"{what}: the host path's infeed ran: {out['infeed']}")


def phase_fused_training(log_root):
    """The discrete exp through the CLI with ``buffer.device=True`` (the
    ring at the recipe's 100000 rows, 1.23 GB of pixels on the card): 8
    gradient steps on the fused path (:func:`check_fused`), the JAX
    package's tags read back, all finite."""
    from sheeprl_tpu_torch.config import compose

    args = [*TRAIN_ARGS, "buffer.device=True", f"log_root={log_root}"]
    cfg = compose(args)
    out, steps, wall_s, counts, trace = train_fused_through_cli(args, "fused training")
    if out["gradient_steps"] != 8:
        fail(f"fused training: {out['gradient_steps']} gradient steps, expected 8")
    check_fused(out, steps, cfg, "fused training", "discrete", counts)
    tags = check_logged(out, cfg, trace, "fused training")
    result = {"cuts": {**TRAIN_CUTS, **FUSED_CUTS}, "gradient_steps": out["gradient_steps"], "wall_s": wall_s, "device_buffer": out["device_buffer"],
              "fused": out["fused"], "ln_gru_launches_eager_warmup_capture_and_player": counts, "logged_tags": tags,
              "logged_sps_train": read_tag(out, "Time/sps_train"), "metrics_last_step": steps[-1][3]}  # fmt: skip
    log(f"fused training: exp=dreamer_v3_100k_ms_pacman buffer.device=True: ring {out['device_buffer']['bytes'] / 1e9:.3f} GB active; "
        f"{out['gradient_steps']} gradient steps on the fused path ({out['fused']['warmup_steps']} warm-up, {out['fused']['replays']} "
        f"replays of a {out['fused']['graph']['nodes']}-node graph) in {wall_s:.1f} s; logged Time/sps_train {result['logged_sps_train']}")  # fmt: skip
    del out
    return result


def phase_fused_continuous(log_root):
    """The walker through the CLI with ``buffer.device=True`` and
    ``algo.fused_train_steps=2`` (the ring at the recipe's 4 x 125000 rows,
    6.14 GB of pixels): 8 gradient steps in buckets of 2 on the fused path,
    a checkpoint after the 4th, the tags read back; then the run resumed
    from that checkpoint (the ring loaded from the checkpointed buffer)
    ends on the uninterrupted run's parameters bit for bit."""
    import torch

    from sheeprl_tpu_torch.config import compose

    args = [*WALKER_ARGS, "buffer.device=True", "algo.fused_train_steps=2", f"log_root={log_root}"]
    cfg = compose(args)
    what = "fused continuous training"
    out, steps, wall_s, counts, trace = train_fused_through_cli(args, what, keep_params=True)
    if out["gradient_steps"] != 8 or [os.path.basename(c) for c in out["checkpoints"]] != ["ckpt_268_0.ckpt", "ckpt_276_0.ckpt"]:
        fail(f"{what}: {out['gradient_steps']} gradient steps, checkpoints {out['checkpoints']}")
    check_fused(out, steps, cfg, what, "continuous", counts)
    tags = check_logged(out, cfg, trace, what)
    mid = out["checkpoints"][0]
    resumed, rsteps, rwall_s, rcounts, _ = train_fused_through_cli([*args, f"checkpoint.resume_from={mid}"], "fused resume", keep_params=True)
    check_fused(resumed, rsteps, cfg, "fused resume", "continuous", rcounts, first_step=5)
    gaps = {f"{name}.{k}": (v.float() - steps[-1][4][name][k].float()).abs().max().item()
            for name in MODULES for k, v in rsteps[-1][4][name].items()
            if not torch_equal_bits(v, steps[-1][4][name][k])}  # fmt: skip
    if gaps:
        fail(f"fused resume: the resumed run's parameters differ from the uninterrupted run's: {dict(list(gaps.items())[:5])}")
    result = {"cuts": {**WALKER_CUTS, **WALKER_FUSED_CUTS}, "gradient_steps": out["gradient_steps"], "wall_s": wall_s,
              "device_buffer": out["device_buffer"], "fused": out["fused"], "ln_gru_launches_eager_warmup_capture_and_player": counts,
              "logged_tags": tags, "logged_sps_train": read_tag(out, "Time/sps_train"), "checkpoint_save_s": trace["save_s"],
              "resume": {"checkpoint": mid, "steps": [s[0] for s in rsteps], "wall_s": rwall_s, "fused": resumed["fused"],
                         "parameters_bit_for_bit": True}}  # fmt: skip
    log(f"{what}: ring {out['device_buffer']['bytes'] / 1e9:.3f} GB active; {out['gradient_steps']} gradient steps in buckets of 2 "
        f"({out['fused']['warmup_steps']} warm-up, {out['fused']['replays']} replays of a {out['fused']['graph']['nodes']}-node graph) "
        f"in {wall_s:.1f} s; logged Time/sps_train {result['logged_sps_train']}; resumed from {os.path.basename(mid)}: steps "
        f"{result['resume']['steps']}, final parameters bit for bit the uninterrupted run's")  # fmt: skip
    del out, resumed, steps, rsteps
    gc.collect()
    torch.cuda.empty_cache()
    return result


def _ring_at_scale(rb, rows, dev):
    """One walker env's filled host buffer (``rows`` rows) loaded into a
    ring with ``load_host_buffer``, timed; 16 x 64 sampled on the card, each
    window checked against the host buffer's rows of the same start."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch.data.device_buffer import DeviceReplayRing

    ring = DeviceReplayRing(rows, 1, cnn_keys=("rgb",), obs_keys=("rgb",), device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ring.load_host_buffer(rb)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if not ring.active or ring.state["added"].tolist() != [rows]:
        fail(f"ring at scale: the ring holds {ring.state['added'].tolist()} rows (active {ring.active})")
    sample = ring.make_sample_fn(16, 64, time_major=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = gen.get_state()
    batch = sample(ring.state, gen)
    gen.set_state(state)
    env_idx, start = sample.starts(ring.state, gen)
    host_off = rb._pos if rb.full else 0
    ring_off = int(ring.state["pos"][0]) if rb.full else 0
    for b in range(16):
        t = (host_off + (int(start[b]) - ring_off) % rows + np.arange(64)) % rows
        for k in batch:
            if not np.array_equal(batch[k][:, b].cpu().numpy(), np.asarray(rb[k][t, int(env_idx[b])])):
                fail(f"ring at scale: window {b} (start {int(start[b])}) of {k} is not the host buffer's")
    nbytes = ring.ring_nbytes()
    del ring, batch
    torch.cuda.empty_cache()
    return {"rows": rows, "ring_bytes": nbytes, "load_s": load_s, "load_gb_per_s": nbytes / load_s / 1e9, "windows_checked": 16}


def _prefetch_timing(rb, dev, reps):
    """The host path's sample and copy on the critical path: synchronous
    (``buffer.prefetch=False``) against prefetched (``stage`` samples on
    the caller's thread and hands the copy to the worker; the envs' step is
    stood in for by a 50 ms sleep; ``take_or_sample`` then hands the staged
    batch over)."""
    import torch

    from sheeprl_tpu_torch.data.infeed import ReplayInfeed

    sync, pre = ReplayInfeed(rb, 16, 64, ("rgb",), dev, enabled=False), ReplayInfeed(rb, 16, 64, ("rgb",), dev, enabled=True)
    try:
        sync.take_or_sample(1)
        sync_ms = []
        for _ in range(reps):
            t0 = time.perf_counter()
            sync.take_or_sample(1)
            torch.cuda.synchronize()
            sync_ms.append((time.perf_counter() - t0) * 1e3)
        pre.stage(1)
        pre.take_or_sample(1)
        stage_ms, take_ms = [], []
        for _ in range(reps):
            t0 = time.perf_counter()
            pre.stage(1)
            stage_ms.append((time.perf_counter() - t0) * 1e3)
            time.sleep(0.05)
            t0 = time.perf_counter()
            batch = pre.take_or_sample(1)[0]
            torch.cuda.synchronize()
            take_ms.append((time.perf_counter() - t0) * 1e3)
            if batch["rgb"].shape != (64, 16, 64, 64, 3) or batch["rgb"].dtype != torch.uint8 or batch["actions"].dtype != torch.float32:
                fail(f"prefetch: staged batch {batch['rgb'].shape} {batch['rgb'].dtype}")
        if pre.hits != reps + 1 or pre.misses != 0:
            fail(f"prefetch: {pre.hits} hits, {pre.misses} misses for {reps + 1} staged calls")
    finally:
        sync.close()
        pre.close()
    crit = [a + b for a, b in zip(stage_ms, take_ms)]
    return {"sync_sample_and_copy_ms": statistics.median(sync_ms), "prefetch_stage_ms": statistics.median(stage_ms),
            "prefetch_take_ms": statistics.median(take_ms), "prefetch_critical_path_ms": statistics.median(crit),
            "prefetch_critical_path_ms_max": max(crit)}  # fmt: skip


def phase_replay_sample(reps: int = 10):
    """One walker env's replay buffer filled to its 125000 rows (the
    recipe's 500000 over 4 envs: 1.54 GB of 64x64x3 pixels), memory-mapped
    and in memory; ``sample`` of 16 x 64 sequences (one gradient step's
    batch) plus its copy to the card, timed from each: for the memmap with
    its page cache cold (the files unmapped and their pages dropped with
    ``posix_fadvise`` before each sample) and warm (after the file was read
    once), with the share of the pixels' pages in the page cache before each
    sample (``mincore``) and the filesystem that holds the files: a fresh
    directory under the temporary directory (``TMPDIR``), where the host's
    own disk is, rather than the checkout's mount."""
    import numpy as np
    import torch

    rows, chunk = 125000, 5000
    rng = np.random.default_rng(0)
    block = {
        "rgb": rng.integers(0, 256, (chunk, 1, 64, 64, 3), dtype=np.uint8),
        "actions": rng.uniform(-1, 1, (chunk, 1, 6)).astype(np.float32),
        **{k: np.zeros((chunk, 1, 1), np.float32) for k in ("rewards", "terminated", "truncated", "is_first")},
    }
    root = tempfile.mkdtemp(prefix="replay_sample-")
    try:
        result = _replay_sample(root, rows, chunk, block, torch.device("cuda"), reps)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log("replay sample (one walker env, 125000 rows, 16 x 64 sequences + copy to the card, median of "
        f"{reps}): " + ", ".join(f"{k} {v['sample_ms']:.2f} ms sample / {v['sample_and_h2d_ms']:.2f} ms with the copy"
                                 + (f" (rgb pages resident {v['rgb_pages_resident_before_sample']:.3f})" if v["rgb_pages_resident_before_sample"] is not None else "")
                                 for k, v in result.items() if k not in ("filesystem", "ring_at_scale", "prefetch"))
        + f"; batch {result['memory']['batch_bytes'] / 1e6:.2f} MB; filled in {result['memmap_cold']['fill_s']:.1f} s (memmap) "
        f"and {result['memory']['fill_s']:.1f} s (memory); files on {result['filesystem']}")  # fmt: skip
    ring, pre = result["ring_at_scale"], result["prefetch"]
    log(f"ring at scale: {ring['rows']} rows ({ring['ring_bytes'] / 1e9:.3f} GB) loaded from the memmap buffer with load_host_buffer in "
        f"{ring['load_s']:.3f} s ({ring['load_gb_per_s']:.2f} GB/s); 16 x 64 sampled on the card, every window the host buffer's")
    log(f"prefetch (16 x 64 from memory, median of {reps}): sample and copy on the critical path {pre['sync_sample_and_copy_ms']:.2f} ms "
        f"synchronous, {pre['prefetch_critical_path_ms']:.2f} ms prefetched (stage, the sample on the caller's thread, "
        f"{pre['prefetch_stage_ms']:.2f} ms; take {pre['prefetch_take_ms']:.3f} ms)")  # fmt: skip
    return result


def _replay_sample(root, rows, chunk, block, dev, reps):
    import numpy as np
    import torch

    from sheeprl_tpu_torch.data.buffers import SequentialReplayBuffer

    result = {"filesystem": filesystem_of(root)}
    for kind in ("memmap", "memory"):
        kwargs = {"memmap": True, "memmap_dir": os.path.join(root, "replay_sample")} if kind == "memmap" else {}
        rb = SequentialReplayBuffer(rows, n_envs=1, obs_keys=("rgb",), **kwargs)
        rb.seed(0)
        t0 = time.perf_counter()
        for start in range(0, rows, chunk):
            rb.add({k: v if k != "rgb" else np.roll(v, start, axis=0) for k, v in block.items()})
        fill_s = time.perf_counter() - t0
        files = [os.path.join(root, "replay_sample", f) for f in os.listdir(os.path.join(root, "replay_sample"))] if kind == "memmap" else []
        for f in files:
            rb.buffer[os.path.basename(f)[: -len(".memmap")]].array.flush()

        def drop_cache():
            for v in rb.buffer.values():
                v.array.flush()
                v._array = None  # unmapped: the kernel keeps the pages of a live mapping; the next access maps the file again
            gc.collect()
            for f in files:
                fd = os.open(f, os.O_RDONLY)
                try:
                    os.fsync(fd)
                    os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
                finally:
                    os.close(fd)
            return resident_share(rb.buffer["rgb"].array) if files else None

        def sample_to_card():
            t = time.perf_counter()
            batch = rb.sample(16, sequence_length=64, n_samples=1)
            t_host = time.perf_counter()
            on_card = {k: torch.from_numpy(np.ascontiguousarray(v[0])).to(dev) for k, v in batch.items()}
            torch.cuda.synchronize()
            return (t_host - t) * 1e3, (time.perf_counter() - t) * 1e3, sum(x.numel() * x.element_size() for x in on_card.values())

        modes = ("cold", "warm") if kind == "memmap" else ("memory",)
        if kind == "memory":
            result["prefetch"] = _prefetch_timing(rb, dev, reps)
        for mode in modes:
            if mode == "warm":
                for f in files:
                    with open(f, "rb") as fp:
                        while fp.read(1 << 24):
                            pass
            sample_to_card()  # the copy path warmed up
            host, total, resident = [], [], []
            for _ in range(reps):
                if mode == "cold":
                    resident.append(drop_cache())
                elif files:
                    resident.append(resident_share(rb.buffer["rgb"].array))
                h, t, nbytes = sample_to_card()
                host.append(h)
                total.append(t)
            result[f"{kind}_{mode}" if kind == "memmap" else kind] = {
                "sample_ms": statistics.median(host), "sample_and_h2d_ms": statistics.median(total),
                "sample_and_h2d_ms_min": min(total), "sample_and_h2d_ms_max": max(total), "batch_bytes": nbytes, "fill_s": fill_s,
                "rgb_pages_resident_before_sample": statistics.mean(resident) if resident else None,
            }  # fmt: skip
        if kind == "memmap":
            result["ring_at_scale"] = _ring_at_scale(rb, rows, dev)
        del rb
        gc.collect()
    if os.listdir(os.path.join(root, "replay_sample")):
        fail(f"replay sample: the memmap buffer left its files behind: {os.listdir(os.path.join(root, 'replay_sample'))}")
    return result


def resident_share(arr) -> float:
    """The share of a memory-mapped array's pages in the page cache (mincore)."""
    import ctypes

    import numpy as np

    page = os.sysconf("SC_PAGE_SIZE")
    vec = (ctypes.c_ubyte * (-(-arr.nbytes // page)))()
    if ctypes.CDLL(None, use_errno=True).mincore(ctypes.c_void_p(arr.ctypes.data), ctypes.c_size_t(arr.nbytes), vec) != 0:
        fail(f"mincore failed: errno {ctypes.get_errno()}")
    return float((np.frombuffer(vec, np.uint8) & 1).mean())


def filesystem_of(path) -> str:
    """'<mount point> (<type>)' of the filesystem that holds ``path``."""
    path = os.path.realpath(path)
    with open("/proc/mounts") as fp:
        mounts = [line.split()[1:3] for line in fp]
    point, kind = max((m for m in mounts if path == m[0] or path.startswith(m[0].rstrip("/") + "/")), key=lambda m: len(m[0]))
    return f"{point} ({kind})"


# SAC and DroQ (exp=sac, exp=droq on env=dummy env.id=continuous_dummy):
# MLPs in 32-true, on the host path and on the ring path; no LN-GRU launch.
SAC_CUTS = {"algo.learning_starts": "64 (from 100)", "algo.total_steps": "128 (from 1000000; 117 gradient steps)",
            "checkpoint.every": "96 (from 50000)", "metric.log_every": "32 (from 5000)"}  # fmt: skip
SAC_ARGS = ["exp=sac", "env=dummy", "env.id=continuous_dummy", "algo.learning_starts=64", "algo.total_steps=128", "checkpoint.every=96",
            "metric.log_every=32"]  # fmt: skip
DROQ_CUTS = {"algo.learning_starts": "16 (from 100)", "algo.total_steps": "48 (from 1000000; 980 critic steps)", "metric.log_every": "16 (from 5000)"}
DROQ_ARGS = ["exp=droq", "env=dummy", "env.id=continuous_dummy", "algo.learning_starts=16", "algo.total_steps=48", "metric.log_every=16"]
RING_CUTS = {"buffer.device": "True (from False)", "algo.fused_train_steps": "16 (from 1)"}
RING_ARGS = ["buffer.device=True", "algo.fused_train_steps=16"]
SAC_TAGS = ("Loss/value_loss", "Loss/policy_loss", "Loss/alpha_loss", "Params/replay_ratio", "Time/sps_train", "Time/sps_env_interaction")
OFFPOLICY_RING_ROWS = 4096  # rows per env of the graph-against-eager phase's ring (4 envs, the dummy env's shapes)
SAC_GRAPH_TAUS = (0.005, 0.0, 0.005, 0.005, 0.0, 0.005, 0.005, 0.005)  # 8 steps: the EMA on and off (target_network_frequency)
# The card's SAC update against the CPU's, per leaf (phase_sac_reference).
# On the CPU a SAC update of 4 steps from weights one f32 ulp away reads
# 2.9e-4 on the worst leaf's change (a target critic's: tau x a small
# change) and 8e-7 on the worst Adam moment; lr x 2 and a zeroed critic
# gradient read 1.0 or more. The limits sit a decade and more above the
# rounding and two decades under the faults.
SAC_PARAM_CHANGE_TOL = 1e-2
SAC_MOMENT_TOL = 1e-2
SAC_FAULTS = ("lr x 2", "critic output bias's gradient zeroed")
SAC_REF_STEPS = 4


def _cli_cuts(args, cuts, ring):
    return ([*args, *RING_ARGS], {**cuts, **RING_CUTS}) if ring else (list(args), cuts)


def expected_gradient_steps(cfg):
    """The gradient (critic) steps the trainer's loop takes for ``cfg``:
    the JAX ``Ratio`` over ``policy_step - prefill + num_envs`` from the
    first training iteration on (``sac.py:462-464``)."""
    from sheeprl_tpu_torch.utils.utils import Ratio

    per_iter = int(cfg.env.num_envs)
    learning_starts = int(cfg.algo.learning_starts) // per_iter
    prefill = learning_starts - int(learning_starts > 0)
    ratio, total = Ratio(cfg.algo.replay_ratio, pretrain_steps=cfg.algo.per_rank_pretrain_steps), 0
    for it in range(1, int(cfg.algo.total_steps) // per_iter + 1):
        if it >= learning_starts:
            total += ratio(it * per_iter - prefill + per_iter)
    return total


def offpolicy_through_cli(args, cuts, what, log_root):
    """One run of the port's SAC or DroQ trainer through its CLI entry point,
    in process, on the card: the LN-GRU counts zeroed before and read after
    (all 0), the expected gradient steps, every train call's losses finite,
    the JAX package's tags at the last log point and the test reward at 0,
    all finite. Returns (out, result)."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.utils.logger import read_scalars

    cfg = compose(args)
    log(f"{what}: {' '.join(args)}: {cfg.env.num_envs} envs, hidden {cfg.algo.hidden_size}, {cfg.algo.critic.n} critics"
        f"{' (dropout ' + str(cfg.algo.critic.dropout) + ', LayerNorm)' if cfg.algo.name == 'droq' else ''}, batch {cfg.algo.per_rank_batch_size}, "
        f"replay ratio {cfg.algo.replay_ratio}, {cfg.buffer.size} rows {'memory-mapped' if cfg.buffer.memmap else 'in memory'}, "
        f"{cfg.fabric.precision}; cut: {json.dumps(cuts)}")  # fmt: skip
    losses = []

    def on_train(agent, gradient_steps, metrics):
        losses.extend(metrics)

    zero_counts()
    t0 = time.perf_counter()
    out = run([*args, f"log_root={log_root}"], callback=on_train)
    wall_s = time.perf_counter() - t0
    counts = read_counts()
    if counts["forward"] or counts["backward"]:
        fail(f"{what}: SAC/DroQ launched LN-GRU kernels: {counts}")
    if out["agent"].log_alpha.device.type != "cuda":
        fail(f"{what}: the agent is not on the card")
    resumed = bool(cfg.checkpoint.resume_from)
    if not resumed and out["gradient_steps"] != expected_gradient_steps(cfg):
        fail(f"{what}: {out['gradient_steps']} gradient steps, the loop's Ratio gives {expected_gradient_steps(cfg)}")
    bad = [m for m in losses if not all(math.isfinite(float(v)) for v in m.values())]
    if not losses or bad:
        fail(f"{what}: non-finite losses {bad[:2]} of {len(losses)} loss entries")
    scalars = read_scalars(out["log_dir"])
    last = int(out["policy_steps"])
    missing = [t for t in SAC_TAGS if last not in [s for s, _ in scalars.get(t, [])]]
    if missing or not all(np.isfinite(v) for values in scalars.values() for _, v in values):
        fail(f"{what}: tags {missing} missing at policy step {last}, or non-finite values: {scalars}")
    if scalars["Test/cumulative_reward"] != [(0, np.float32(out["test_reward"]))]:
        fail(f"{what}: Test/cumulative_reward {scalars['Test/cumulative_reward']}, the test episode returned {out['test_reward']}")
    if cfg.buffer.device and not (out["device_buffer"]["active"] and out["fused"] and out["fused"]["gradient_steps"] == out["gradient_steps"]):
        fail(f"{what}: the ring path did not take every gradient step: {out['device_buffer']} {out['fused']}")
    logged = {k: v for k, v in out["log"][-1].items()}
    result = {"cuts": cuts, "policy_steps": out["policy_steps"], "gradient_steps": out["gradient_steps"], "loss_entries": len(losses),
              "wall_s": wall_s, "ln_gru_launches": counts, "last_log": logged, "test_reward": out["test_reward"],
              "device_buffer": out["device_buffer"], "fused": out["fused"]}  # fmt: skip
    fused = out["fused"] or {}
    log(f"{what}: {out['gradient_steps']} gradient steps in {out['policy_steps']} policy steps, {wall_s:.1f} s; no LN-GRU launch; "
        f"finite losses; the JAX package's tags; Time/sps_train {logged.get('Time/sps_train', float('nan')):.4g}, Time/sps_env_interaction "
        f"{logged.get('Time/sps_env_interaction', float('nan')):.4g}"
        + (f"; ring {out['device_buffer']['bytes'] / 2**20:.1f} MiB, {fused.get('warmup_steps')} warm-up steps, {fused.get('replays')} replays "
           f"(graph {fused['graph']['nodes']} nodes)" if fused.get("graph") else ""))  # fmt: skip
    return out, result


def _state_of(out):
    """The agent's parameters and every Adam state tensor of a run."""
    params = {k: v.detach().clone() for k, v in out["agent"].state_dict().items()}
    adam = {f"{name}.{i}.{k}": v.clone() for name, opt in out["optimizers"].items() for i, p in enumerate(opt.param_groups[0]["params"])
            for k, v in sorted(opt.state[p].items())}  # fmt: skip
    return params, adam


def serve_sac_over_http(ckpt, agent, workdir):
    """SAC's checkpoint exported and served over HTTP on the card: the
    artifact holds the actor only. A burst of sampled requests from 4
    threads shares batches, every action 2 floats in [-1, 1]. Then one
    request at a time (a batch of one, as the test episode acts): each
    greedy action equals, bit for bit, the trained agent's greedy action
    for that observation on the card (the test episode's action) and
    repeats byte for byte; a sampled one repeats for its seed and differs
    across seeds. (A row's floats may change with the batch it shares: the
    product's kernel depends on the batch size.)"""
    import numpy as np
    import torch

    from sheeprl_tpu_torch.serve import cli as serve_cli
    from sheeprl_tpu_torch.serve.artifact import load_artifact
    from sheeprl_tpu_torch.serve.cli import SERVE_DEFAULTS
    from sheeprl_tpu_torch.serve.engine import InferenceEngine
    from sheeprl_tpu_torch.serve.server import PolicyServer

    path = os.path.join(workdir, "sac.policy")
    serve_cli.main(["export", f"checkpoint_path={ckpt}", "name=sac", f"output_path={path}"])
    if set(load_artifact(path, verify_digest=True).params) != {"actor"}:
        fail("sac serve: the artifact holds more than the actor")
    engine = InferenceEngine(max_batch=SERVE_DEFAULTS["max_batch"], queue_capacity=SERVE_DEFAULTS["queue_capacity"],
                             batch_window_s=SERVE_DEFAULTS["batch_window_ms"] / 1000.0, device="cuda")  # fmt: skip
    card = engine.load("sac", path)
    server = PolicyServer(engine, host="127.0.0.1", port=0).start()
    try:
        status, models = http(server.address, "/v1/models")
        if status != 200 or models["models"]["sac"]["action_space"]["type"] != "box":
            fail(f"sac serve: /v1/models {status} {models}")
        rng = np.random.default_rng(5)
        obs = [rng.normal(size=10).astype(np.float32).tolist() for _ in range(4)]

        def act(mode, seed, o):
            return http(server.address, "/v1/act", {"model": "sac", "obs": {"state": o}, "mode": mode, "seed": seed})[1]["action"]

        with ThreadPoolExecutor(4) as pool:
            burst = list(pool.map(lambda s: [act("sample", s, o) for o in obs], range(4)))
        greedy = [act("greedy", 0, o) for o in obs]
        again = [act("greedy", 1, o) for o in obs]
        sampled = [[act("sample", s, o) for o in obs] for s in range(3)]
        resampled = [[act("sample", s, o) for o in obs] for s in range(3)]
        stats = engine.stats()
    finally:
        server.close(drain=True)
    with torch.no_grad():
        want = [agent.get_actions(torch.tensor([o], device="cuda"), greedy=True)[0].cpu().tolist() for o in obs]
    if json.dumps(greedy) != json.dumps(again) or greedy != want:
        fail(f"sac serve: greedy actions {greedy}, repeated {again}, the trained agent's greedy actions {want}")
    if sampled != resampled or sampled[0] == sampled[1]:
        fail(f"sac serve: sampled requests do not repeat per seed, or two seeds agree: {sampled} vs {resampled}")
    flat = greedy + [a for s in sampled + burst for a in s]
    if not all(len(a) == 2 and all(-1.0 <= x <= 1.0 for x in a) for a in flat) or stats["counters"]["errors"]:
        fail(f"sac serve: actions outside 2 x [-1, 1]: {flat[:3]} ({stats['counters']})")
    log(f"sac serve: {os.path.basename(ckpt)} exported (the actor only) and served ({card['precision']} on {card['device']}): "
        f"{stats['counters']['requests']} requests in {stats['counters']['batches']} batches, occupancy {stats['occupancy']}; greedy actions "
        "the trained agent's bit for bit and repeated byte-identical, seeded samples repeatable and seed-dependent, every action 2 x [-1, 1]")  # fmt: skip
    return {"requests": stats["counters"]["requests"], "batches": stats["counters"]["batches"], "occupancy": stats["occupancy"], "greedy_actions": greedy}


def phase_sac(log_root, workdir):
    """(a) SAC through the CLI (host path), resumed from its mid-run
    checkpoint (every parameter and Adam state bit for bit the
    uninterrupted run's at the end), exported and served, ``eval``; then
    the same run on the ring path."""
    out, host = offpolicy_through_cli(SAC_ARGS, SAC_CUTS, "sac", log_root)
    [ckpt] = [c for c in out["checkpoints"] if os.path.basename(c).startswith("ckpt_96_")]
    again, resumed = offpolicy_through_cli([*SAC_ARGS, f"checkpoint.resume_from={ckpt}"], SAC_CUTS, "sac resume", log_root)
    (pa, aa), (pb, ab) = _state_of(out), _state_of(again)
    differ = [k for k in pa if not torch_equal_bits(pa[k], pb[k])] + [k for k in aa if not torch_equal_bits(aa[k], ab[k])]
    if differ or pa.keys() != pb.keys() or aa.keys() != ab.keys() or again["gradient_steps"] != out["gradient_steps"]:
        fail(f"sac resume: the resumed run ends off the uninterrupted one: {differ[:5]}")
    log(f"sac resume: from {os.path.basename(ckpt)} the run ends on the uninterrupted run's {len(pa)} parameter and {len(aa)} Adam tensors "
        "bit for bit")  # fmt: skip
    serving = serve_sac_over_http(out["checkpoints"][-1], out["agent"], workdir)
    evaluation = phase_eval(out["checkpoints"][-1], out["test_reward"])
    _, ring = offpolicy_through_cli(*_cli_cuts(SAC_ARGS, SAC_CUTS, True), "sac ring", log_root)
    return {"host": host, "resume": {**resumed, "tensors_bit_for_bit": len(pa) + len(aa)}, "serving": serving, "evaluation": evaluation, "ring": ring}


def phase_droq(log_root):
    """(c) DroQ through the CLI at replay ratio 20, on the host path and on
    the ring path (both captured graphs replayed)."""
    _, host = offpolicy_through_cli(DROQ_ARGS, DROQ_CUTS, "droq", log_root)
    _, ring = offpolicy_through_cli(*_cli_cuts(DROQ_ARGS, DROQ_CUTS, True), "droq ring", log_root)
    fused = ring["fused"]
    if not (fused["replays"] > 0 and fused["actor_replays"] > 0 and fused["graph"] and fused["actor_graph"]):
        fail(f"droq ring: the critic and actor graphs were not both replayed: {fused}")
    return {"host": host, "ring": ring}


def _offpolicy_setup(kind, where):
    """A full-width agent of ``kind`` (sac, droq) on ``where``, initialised
    on the CPU from seed 7, its optimizers and config."""
    from sheeprl_tpu_torch.algos.droq.agent import build_agent as build_droq
    from sheeprl_tpu_torch.algos.sac.agent import build_agent as build_sac
    from sheeprl_tpu_torch.algos.sac.sac import make_optimizers
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.envs.dummy import ContinuousDummyEnv

    cfg = compose([*(SAC_ARGS if kind == "sac" else DROQ_ARGS), f"device={where}"])
    env = ContinuousDummyEnv(action_dim=int(cfg.env.wrapper.action_dim))
    agent = (build_sac if kind == "sac" else build_droq)(cfg, env.observation_space, env.action_space, device=where, seed=7)
    return cfg, agent, make_optimizers(agent, cfg)


def _offpolicy_batch(lead, seed, dev):
    """A replay batch at the dummy env's shapes (10-float state, 2 actions)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    data = {"observations": rng.normal(size=(*lead, 10)), "next_observations": rng.normal(size=(*lead, 10)),
            "actions": rng.uniform(-1, 1, (*lead, 2)), "rewards": rng.normal(size=(*lead, 1)), "terminated": rng.random((*lead, 1)) < 0.05}  # fmt: skip
    return {k: torch.from_numpy(v.astype(np.float32)).to(dev) for k, v in data.items()}


def phase_sac_reference():
    """(b) One SAC update (``SAC_REF_STEPS`` gradient steps of batch 256 at
    hidden 256) on the card in 32-true with TF32 off against the same update
    on the CPU, from the same weights, batches and normal draws. Each
    parameter leaf's change from the start, ``||d_card - d_cpu|| /
    ||d_cpu||`` (the target critics and ``log_alpha`` included), within
    ``SAC_PARAM_CHANGE_TOL``; each leaf's Adam moments within
    ``SAC_MOMENT_TOL``; the mean losses within rtol 1e-4. The card's update
    from weights one f32 ulp away is reported (its own rounding), and each
    of ``SAC_FAULTS`` planted on the card must be rejected by the parameter
    check."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch.algos.sac.sac import make_train_step

    def update(where, fault=None):
        cfg, agent, optimizers = _offpolicy_setup("sac", where)
        if fault == "nudge":
            with torch.no_grad():
                for p in agent.parameters():
                    p.mul_(1 + 2.0**-23)
        start = {k: v.detach().cpu().clone() for k, v in agent.state_dict().items()}
        if fault == "lr x 2":
            for opt in optimizers.values():
                for group in opt.param_groups:
                    group["lr"] = 2 * group["lr"]
        elif fault == SAC_FAULTS[1]:
            agent.qfs.model.output.bias.register_hook(torch.zeros_like)
        batch = int(cfg.algo.per_rank_batch_size)
        data = _offpolicy_batch((SAC_REF_STEPS, batch), 13, torch.device(where))
        noise = torch.from_numpy(np.random.default_rng(14).normal(size=(SAC_REF_STEPS, 2, batch, agent.action_dim)).astype(np.float32)).to(where)
        metrics = make_train_step(agent, optimizers, cfg)(data, noise, torch.tensor(float(cfg.algo.tau), device=where))
        names = {id(p): n for n, p in agent.named_parameters()}
        moments = {f"{m} {names[id(p)]}": opt.state[p][m].detach().cpu() for opt in optimizers.values() for p in opt.param_groups[0]["params"]
                   for m in ("exp_avg", "exp_avg_sq")}  # fmt: skip
        return {k: float(v) for k, v in metrics.items()}, start, {k: v.detach().cpu() for k, v in agent.state_dict().items()}, moments

    def worst(gaps):
        k = max(gaps, key=gaps.get)
        return {"leaf": k, "gap": gaps[k]}

    cpu_m, cpu_start, cpu_p, cpu_mom = update("cpu")
    gpu_m, gpu_start, gpu_p, gpu_mom = update("cuda")
    if any(not torch.equal(gpu_start[k], cpu_start[k]) for k in cpu_start):
        fail("sac reference: the card's agent does not start from the CPU's weights")
    for k in cpu_m:
        if abs(gpu_m[k] - cpu_m[k]) > 1e-6 + 1e-4 * abs(cpu_m[k]):
            fail(f"sac reference: {k} {gpu_m[k]} on the card, {cpu_m[k]} on the CPU")
    param = worst(_relative_gaps(gpu_p, cpu_p, gpu_start, cpu_start))
    moment = worst(_relative_gaps(gpu_mom, cpu_mom))
    if param["gap"] > SAC_PARAM_CHANGE_TOL:
        fail(f"sac reference: {param['leaf']}'s change on the card differs from the CPU's by {param['gap']} of its norm (> {SAC_PARAM_CHANGE_TOL})")
    if moment["gap"] > SAC_MOMENT_TOL:
        fail(f"sac reference: Adam's {moment['leaf']} differs on the card by {moment['gap']} of its norm (> {SAC_MOMENT_TOL})")
    _, nudge_start, nudge_p, nudge_mom = update("cuda", "nudge")
    floor = {"param": worst(_relative_gaps(nudge_p, gpu_p, nudge_start, gpu_start)), "adam_moment": worst(_relative_gaps(nudge_mom, gpu_mom))}
    faults = {}
    for fault in SAC_FAULTS:
        f_m, f_start, f_p, f_mom = update("cuda", fault)
        faults[fault] = {"param": worst(_relative_gaps(f_p, cpu_p, f_start, cpu_start)), "adam_moment": worst(_relative_gaps(f_mom, cpu_mom)),
                         "loss_rel": max(abs(f_m[k] - cpu_m[k]) / abs(cpu_m[k]) for k in cpu_m)}  # fmt: skip
        if faults[fault]["param"]["gap"] <= SAC_PARAM_CHANGE_TOL:
            fail(f"sac reference: the update with {fault} passes the parameter check ({faults[fault]['param']})")
    log(f"sac reference: one SAC update ({SAC_REF_STEPS} gradient steps, batch 256, hidden 256), card against CPU in 32-true: losses "
        f"{json.dumps({k: [gpu_m[k], cpu_m[k]] for k in cpu_m})}; worst leaf's change {param['gap']:.3g} ({param['leaf']}, limit "
        f"{SAC_PARAM_CHANGE_TOL}); worst Adam moment {moment['gap']:.3g} ({moment['leaf']}, limit {SAC_MOMENT_TOL}); the card from weights one "
        f"ulp away {json.dumps(floor)}; planted faults {json.dumps(faults)}")  # fmt: skip
    return {"losses_card": gpu_m, "losses_cpu": cpu_m, "worst_param_change": param, "worst_adam_moment": moment, "one_ulp_nudge": floor,
            "planted_faults": faults, "tolerance": {"param_change": SAC_PARAM_CHANGE_TOL, "adam_moment": SAC_MOMENT_TOL, "loss_rtol": 1e-4}}  # fmt: skip


def _busy(averages, n, skip=(), by_kernel=None):
    """(device ms, operations, annotation ms) per ``n`` of the CUDA events
    of a profile's ``key_averages()`` (taken once by the caller: it is slow
    over a training step's tens of thousands of events). The device ranges of ``record_function`` annotations (the
    trainer's spans, named by ``skip``, and ``Optimizer.step#Adam.step``)
    span kernels counted already: they are left out of the first two and
    summed in the third. ``by_kernel``, a dict, receives each kernel's (the
    first 60 characters of its name) device ms per ``n``. Every profile of
    this script reads its busy time here."""
    import torch

    total, ops, annotated = 0.0, 0, 0.0
    for evt in averages:
        if evt.device_type != torch.autograd.DeviceType.CUDA or MARKER_KERNEL in evt.key:  # profiled's markers
            continue
        ms = getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0.0)
        if getattr(evt, "is_user_annotation", False) or evt.key.startswith(("Optimizer.", *skip)):
            annotated += ms
        else:
            total += ms
            ops += evt.count
            if by_kernel is not None:
                by_kernel[evt.key[:60]] = by_kernel.get(evt.key[:60], 0.0) + ms / n / 1e3
    return total / n / 1e3, ops / n, annotated / n / 1e3


def _timed_per_step(fn, steps, reps=3):
    """Host wall ms per step of ``fn`` (``steps`` steps a call, ending in a
    synchronize; best of ``reps``), its device busy ms and operations per
    step (torch.profiler over one more call), the idle share and the peak
    memory."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / steps)
    peak = torch.cuda.max_memory_allocated() / 2**30
    busy, ops, annotated = _busy(profiled(fn, ("cpu", "cuda")).key_averages(), steps, skip=("sac/", "droq/"))
    if busy <= 0.0:
        fail("torch.profiler saw no device time")
    wall = statistics.median(walls)
    return {"host_wall_ms_per_step": wall, "device_busy_ms_per_step": busy, "idle_share": max(0.0, 1.0 - busy / wall),
            "device_ops_per_step": ops, "annotation_ranges_ms_per_step": annotated, "peak_gib": peak, "gradient_steps_per_s": 1e3 / wall}  # fmt: skip


def phase_offpolicy_host_profile(kind):
    """(e) The host path's gradient steps at full width on the card: 16 of
    them in one train call (SAC: ``make_train_step``; DroQ: 16 critic steps
    and the actor step, the draws made in the call as the trainer makes
    them); per gradient step the host wall, device busy, idle share,
    operations and peak memory; no LN-GRU launch."""
    import torch

    from sheeprl_tpu_torch.algos.droq import droq as droq_mod
    from sheeprl_tpu_torch.algos.sac.sac import draw_noise, make_train_step
    from sheeprl_tpu_torch.utils.distribution import BatchGenerator

    dev = torch.device("cuda")
    cfg, agent, optimizers = _offpolicy_setup(kind, "cuda")
    batch, steps = int(cfg.algo.per_rank_batch_size), 16
    data = _offpolicy_batch((steps, batch), 21, dev)
    rng = BatchGenerator.from_seed(0, dev)
    if kind == "sac":
        step, tau = make_train_step(agent, optimizers, cfg), torch.tensor(float(cfg.algo.tau), device=dev)

        def call():
            return step(data, draw_noise(rng, batch, agent.action_dim, steps), tau)
    else:
        step, actor_obs = droq_mod.make_train_step(agent, optimizers, cfg), data["observations"][0]

        def call():
            draws = {"critic": [droq_mod.critic_draws(agent, rng, batch) for _ in range(steps)], "actor": droq_mod.actor_draws(agent, rng, batch)}
            return step(data, actor_obs, draws)

    zero_counts()
    out = _timed_per_step(call, steps)
    counts = read_counts()
    if counts["forward"] or counts["backward"]:
        fail(f"{kind} host profile: LN-GRU launches {counts}")
    out["ln_gru_launches"] = counts["forward"] + counts["backward"]
    log(f"{kind} host path: {steps} gradient steps a call at batch {batch}, hidden {cfg.algo.hidden_size}: {out['host_wall_ms_per_step']:.3f} ms "
        f"host wall a step, {out['device_busy_ms_per_step']:.3f} ms device busy, idle {out['idle_share']:.3f}, {out['device_ops_per_step']:.1f} "
        f"device operations, peak {out['peak_gib']:.3f} GiB, {out['gradient_steps_per_s']:.1f} gradient steps/s; no LN-GRU launch")  # fmt: skip
    return out


def phase_offpolicy_graph(kind):
    """(d) The ring path's captured steps against their eager steps on the
    card, at full width, sampling a ring of ``OFFPOLICY_RING_ROWS`` rows
    per env (4 envs) filled at the dummy env's shapes. The fused step warms
    up (3 eager calls, the first under the sync check; DroQ's critic and
    actor steps each); then from one snapshot (every parameter, target and
    Adam state, and the generator) 8 gradient steps eagerly twice and
    through the graphs (SAC: taus ``SAC_GRAPH_TAUS``; DroQ: two calls of 4
    critic steps and the actor step): every parameter, Adam state and the
    calls' metrics bit for bit, or within the two eager runs' difference.
    The graphs' nodes (no LN-GRU node); then (e) 16 back-to-back replays
    timed and profiled."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch.algos.droq.droq import make_fused_train_step as droq_fused
    from sheeprl_tpu_torch.algos.sac.sac import METRIC_KEYS
    from sheeprl_tpu_torch.algos.sac.sac import make_fused_train_step as sac_fused
    from sheeprl_tpu_torch.data.device_buffer import DeviceReplayRing
    from sheeprl_tpu_torch.utils.distribution import BatchGenerator

    what = f"{kind} graph vs eager"
    dev = torch.device("cuda")
    cfg, agent, optimizers = _offpolicy_setup(kind, "cuda")
    n_envs, batch = int(cfg.env.num_envs), int(cfg.algo.per_rank_batch_size)
    rows = _offpolicy_batch((OFFPOLICY_RING_ROWS, n_envs), 17, "cpu")
    rows = {k: v.numpy() for k, v in rows.items()}
    rows["terminated"] = rows["terminated"].astype(np.uint8)
    ring = DeviceReplayRing(OFFPOLICY_RING_ROWS, n_envs, obs_keys=("observations",), device=dev)
    ring.add(rows)
    ring.flush()
    sample = ring.make_sample_fn(batch, sequence_length=1)
    rng = BatchGenerator.from_seed(3, dev)
    if kind == "sac":
        fused = sac_fused(agent, optimizers, cfg, sample, rng)
        steps = [fused.captured]
        for _ in range(WARMUP_STEPS):
            fused(ring.state, [0.005])

        def through_graph():
            m = fused(ring.state, SAC_GRAPH_TAUS)
            return torch.stack([m[k] for k in METRIC_KEYS])

        def eagerly():
            total = None
            for t in SAC_GRAPH_TAUS:
                fused.tau.fill_(t)
                out = fused.captured.fn()
                total = out.clone() if total is None else total.add_(out)
            return total / len(SAC_GRAPH_TAUS)
    else:
        fused = droq_fused(agent, optimizers, cfg, sample, rng)
        steps = [fused.critic, fused.actor]
        for _ in range(WARMUP_STEPS):
            fused(ring.state, 1, True)

        def through_graph():
            return torch.stack([torch.stack([m[k] for k in sorted(m)]) for m in (fused(ring.state, 4, True) for _ in range(2))])

        def eagerly():
            calls = []
            for _ in range(2):
                total = None
                for _ in range(4):
                    out = fused.critic.fn()
                    total = out.clone() if total is None else total.add_(out)
                policy, alpha = fused.actor.fn().clone().unbind()
                calls.append(torch.stack([alpha, policy, total / 4]))
            return torch.stack(calls)

    torch.cuda.synchronize()
    if any(s.warmup_calls != WARMUP_STEPS or s.graph is not None for s in steps):
        fail(f"{what}: warm-up {[s.warmup_calls for s in steps]}, graphs {[s.graph for s in steps]}")
    params = list(agent.parameters())
    adam = [v for opt in optimizers.values() for p in opt.param_groups[0]["params"] for _, v in sorted(opt.state[p].items())]
    snap = {"params": [p.detach().clone() for p in params], "adam": [a.clone() for a in adam], "rng": rng.generator.get_state()}

    def restore():
        with torch.no_grad():
            for p, s in zip(params, snap["params"]):
                p.copy_(s)
            for a, s in zip(adam, snap["adam"]):
                a.copy_(s)
        rng.generator.set_state(snap["rng"])

    def result(metrics):
        torch.cuda.synchronize()
        return {"params": [p.detach().clone() for p in params], "adam": [a.clone() for a in adam], "metrics": [metrics.clone()]}

    restore()
    eager_a = result(eagerly())
    restore()
    eager_b = result(eagerly())
    restore()
    t0 = time.perf_counter()
    graph = result(through_graph())
    capture_and_replay_s = time.perf_counter() - t0
    eager_gap, graph_gap = _gaps(eager_a, eager_b), _gaps(eager_a, graph)
    for group, gap in graph_gap.items():
        allowed = 0.0 if eager_gap[group]["bit_for_bit"] else eager_gap[group]["max_abs"]
        if not gap["bit_for_bit"] and gap["max_abs"] > allowed:
            fail(f"{what}: the graph's {group} differ from the eager steps' by {gap['max_abs']} (two eager runs: {eager_gap[group]})")
    nodes = [s.nodes for s in steps]
    if any(n is None or any(n["ln_gru"].values()) for n in nodes):
        fail(f"{what}: graphs {nodes}")

    # (e) 16 back-to-back replays of the (critic) step.
    if kind == "sac":
        replays = lambda: fused(ring.state, [0.005] * REPLAYS_PROFILED)  # noqa: E731
    else:
        replays = lambda: fused(ring.state, REPLAYS_PROFILED, True)  # noqa: E731
    zero_counts()
    profile = _timed_per_step(replays, REPLAYS_PROFILED)
    counts = read_counts()
    if counts["forward"] or counts["backward"]:
        fail(f"{what}: LN-GRU launches {counts}")
    out = {"ring_rows_per_env": OFFPOLICY_RING_ROWS, "n_envs": n_envs, "warmup_steps": WARMUP_STEPS, "eager_vs_eager": eager_gap,
           "graph_vs_eager": graph_gap, "capture_and_replays_s": capture_and_replay_s,
           "graph_nodes": [{"nodes": n["nodes"], "by_type": n["by_type"], "ln_gru": n["ln_gru"]} for n in nodes],
           "replays_profiled": REPLAYS_PROFILED, **profile}  # fmt: skip
    log(f"{what}: hidden {cfg.algo.hidden_size}, batch {batch}, ring {OFFPOLICY_RING_ROWS} rows x {n_envs} envs; {WARMUP_STEPS} eager warm-up "
        f"calls, then 8 steps from one snapshot: eager vs eager {json.dumps(eager_gap)}; graph vs eager {json.dumps(graph_gap)}; graph nodes "
        f"{json.dumps(out['graph_nodes'])}")  # fmt: skip
    log(f"{what}: {REPLAYS_PROFILED} back-to-back replays: {profile['host_wall_ms_per_step']:.3f} ms host wall a step, "
        f"{profile['device_busy_ms_per_step']:.3f} ms device busy, idle {profile['idle_share']:.3f}, {profile['device_ops_per_step']:.1f} device "
        f"operations, peak {profile['peak_gib']:.3f} GiB, {profile['gradient_steps_per_s']:.1f} gradient steps/s")  # fmt: skip
    del fused, ring, agent, optimizers
    gc.collect()
    torch.cuda.empty_cache()
    return out


# DreamerV2 (exp=dreamer_v2_ms_pacman: 64x64 rgb, 9 actions, bf16-mixed,
# batch 32 x 50, horizon 15, recurrent state 600, dense 400, CNN multiplier
# 48, an episodic replay with prioritize_ends, memory-mapped at the recipe's
# 2000000 rows) and DreamerV1 (exp=dreamer_v1). The LN-GRU runs at H = 600
# (D = 600 + 400) with a learned dense bias: H is no multiple of 64, so
# every forward runs on the streaming kernel (tensor_core_fits refuses it).
DV2_DEPTH, DV2_HIDDEN = 1000, 600
DV2_BATCH, DV2_SEQ, DV2_HORIZON, DV2_ENVS = 32, 50, 15, 4
DV2_IMAGINED = DV2_BATCH * DV2_SEQ  # 1600
DV2_FWD_BY_BATCH = {DV2_BATCH: DV2_SEQ, DV2_IMAGINED: DV2_HORIZON}
DV2_BWD_BY_BATCH = {DV2_BATCH: DV2_SEQ, DV2_IMAGINED: DV2_HORIZON}  # the actor's loss differentiates the imagination
DV2_SHAPES = ((DV2_BATCH, "dynamic scan"), (DV2_IMAGINED, "imagination"), (DV2_ENVS, "player"))
# The dummy env's episodes cut to 63 steps (the recipe's windows are 50
# rows; an episode of the discrete dummy env has 5 by default); 64 policy
# iterations of 4 envs fill the buffer with four whole episodes before the
# first gradient step, the recipe's replay ratio then takes one gradient
# step every 16 policy steps: 8 in 128 more, a checkpoint after the 4th.
DV2_CUTS = {"algo.learning_starts": "256 (from 200000)", "algo.total_steps": "384 (from 200000000; 8 gradient steps)",
            "checkpoint.every": "320 (from 200000)", "metric.log_every": "128 (from 5000)",
            "+env.wrapper.n_steps": "62 (the dummy env's episodes: 63 steps, 64 rows with the reset row)"}  # fmt: skip
DV2_ARGS = ["exp=dreamer_v2_ms_pacman", "env=dummy", "algo.learning_starts=256", "algo.total_steps=384", "checkpoint.every=320",
            "metric.log_every=128", "+env.wrapper.n_steps=62"]  # fmt: skip
DV2_STEPS, DV2_RESUMED_FROM = 8, 4
DV2_EPISODE_ROWS = 64
DV1_CUTS = {"algo.learning_starts": "200 (from 5000)", "algo.total_steps": "288 (from 5000000; 8 gradient steps)",
            "checkpoint.every": "240 (from 100000)", "metric.log_every": "96 (from 5000)"}  # fmt: skip
DV1_ARGS = ["exp=dreamer_v1", "env=dummy", "algo.learning_starts=200", "algo.total_steps=288", "checkpoint.every=240", "metric.log_every=96"]
DV1_STEPS, DV1_RESUMED_FROM = 8, 4
# The card's 32-true DV2 step against the CPU's (phase_dv2_reference), per
# parameter leaf's change from the start; the LN-GRU dense bias's gradient
# on its own. Planted faults must exceed the leaf limit.
DV2_PARAM_CHANGE_TOL = 1e-3
DV2_BIAS_GRAD_TOL = 1e-4
DV2_BF16_BIAS_GRAD_TOL = 0.1
DV2_BF16_BIAS_CHANGE_TOL = 0.5
DV2_FAULTS = ("lr x 2", "the LN-GRU bias's gradient zeroed")


def phase_dv2_kernels():
    """(1) The three LN-GRU entry points at DreamerV2's shapes: B = 32 (the
    dynamic scan), B = 1600 (the imagination) and B = 4 (the player), D =
    1000, H = 600, f32 and bf16, a non-zero dense bias (:func:`streaming_rows`)."""
    import torch

    from sheeprl_tpu_torch.models.ln_gru import tensor_core_fits

    if tensor_core_fits(DV2_DEPTH, DV2_HIDDEN):
        fail("dv2 kernels: tensor_core_fits takes H = 600, DreamerV2's forwards would not all stream")
    return streaming_rows("dv2", DV2_DEPTH, DV2_HIDDEN, DV2_SHAPES, (torch.float32, torch.bfloat16), seed=5)


def streaming_rows(tag, depth, hidden, shapes, dtypes, seed, reps=None):
    """The three LN-GRU entry points at a model's shapes (``shapes``: (B,
    where) pairs) and ``dtypes``, a non-zero dense bias: ``ln_gru_forward``
    (its plan must pick the streaming kernel) and ``ln_gru_forward_streaming``
    against ``ln_gru_plain`` (tolerances of ``check_forward``),
    ``ln_gru_backward`` against ``ln_gru_backward_plain`` (those of
    ``phase_backward``); each timed beside its plain version, its bound, and
    for the forward cuBLAS's product alone; one launch per call. ``reps``
    maps a batch to the (repetitions, calls) of its timings where the
    default ones would take too long."""
    import torch

    from sheeprl_tpu_torch.models.ln_gru import (
        _aligned,
        _sm_count,
        forward_plan,
        ln_gru_backward,
        ln_gru_backward_plain,
        ln_gru_forward,
        ln_gru_forward_streaming,
        ln_gru_plain,
        streaming_plan,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    for batch, where in shapes:
        r = (reps or {}).get(batch, (15, 20))
        for dtype in dtypes:
            dname = str(dtype).split(".")[1]
            args = gru_inputs(batch, depth, hidden, dtype, seed=seed)
            if float(args[2].abs().min()) <= 0:
                fail(f"{tag} kernels: the dense bias has a zero entry")
            what = f"{tag} ln_gru B={batch} D={depth} H={hidden} {dname}"
            plan = forward_plan(batch, depth, hidden, dtype, _sm_count(0), _aligned(args[0], args[1], args[5]))
            if plan.kernel != "streaming":
                fail(f"{what}: forward_plan picks {plan.kernel}")
            errs = check_forward(ln_gru_forward, args, what)
            errs_streaming = check_forward(ln_gru_forward_streaming, args, f"{what} (streaming entry point)")
            fwd = timed(rotated(args, ln_gru_forward), *r)
            fwd_streaming = timed(rotated(args, ln_gru_forward_streaming), *r)
            plain_ms = device_ms(rotated(args, ln_gru_plain), *r)[0]
            product_ms = device_ms(rotated(args[:2], torch.matmul), *r)[0]
            check_one_launch(what, kernel_split_ms(rotated(args, ln_gru_forward), calls=min(50, 4 * r[1])))
            bound_ms, bound_by = gru_bound(batch, depth, hidden, dname)
            _, z = ln_gru_forward(*args)
            g = gru_inputs(batch, 1, hidden, dtype, seed=seed + 1)[5]
            bargs = (g, z, args[3], args[4], args[5])
            berrs = check_backward(bargs, f"{what} ln_gru_backward")
            bwd = timed(rotated(bargs, ln_gru_backward), *r)
            bwd_plain_ms = device_ms(rotated(bargs, ln_gru_backward_plain), *r)[0]
            check_one_launch(f"{what} backward", kernel_split_ms(rotated(bargs, ln_gru_backward), calls=min(50, 4 * r[1])))
            bwd_bound_ms, bwd_bound_by = gru_bwd_bound(batch, hidden, dname)
            sp = streaming_plan(batch, depth, hidden, args[0].element_size(), _sm_count(0), _aligned(args[1]))
            row = {"shape": f"B={batch} D={depth} H={hidden}", "batch": batch, "where": where, "dtype": dname,
                   "kernel": plan.kernel, "plan": {"grid": sp.grid, "cluster": sp.cluster, "vec": sp.vec, "ksplit": sp.ksplit},
                   "forward": {**errs, **fwd, "plain_ms": plain_ms, "product_library_ms": product_ms, "bound_ms": bound_ms, "bound_by": bound_by},
                   "forward_streaming": {**errs_streaming, **fwd_streaming},
                   "backward": {"max_abs_err": berrs, **bwd, "plain_ms": bwd_plain_ms, "bound_ms": bwd_bound_ms, "bound_by": bwd_bound_by}}  # fmt: skip
            rows.append(row)
            log(f"{what} ({where}): streaming plan grid {sp.grid} cluster {sp.cluster} vec {sp.vec}; forward {fwd['ms'] * 1e3:.2f} us "
                f"[{fwd['ms_min'] * 1e3:.2f}, {fwd['ms_max'] * 1e3:.2f}] (streaming entry point {fwd_streaming['ms'] * 1e3:.2f} us), plain "
                f"{plain_ms * 1e3:.2f} us, product alone {product_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us ({bound_by}), max|dh| "
                f"{errs['max_abs_err_h']:.3g}; backward {bwd['ms'] * 1e3:.2f} us, plain {bwd_plain_ms * 1e3:.2f} us, bound "
                f"{bwd_bound_ms * 1e3:.2f} us ({bwd_bound_by}), max|d| {json.dumps({k: float(f'{v:.3g}') for k, v in berrs.items()})}")  # fmt: skip
            del args, bargs, z
            torch.cuda.empty_cache()
    return rows


def dreamer_through_cli(args, what, fwd_by_batch, bwd_by_batch, keep_params=False):
    """One DreamerV2, DreamerV1 or P2E run through the CLI, in process, on
    the card. At every gradient step: finite metrics, and the LN-GRU launches
    since the step before, by batch, for the train step's batches (the
    player's at B = num_envs fall between iterations): ``fwd_by_batch`` and
    ``bwd_by_batch`` (empty for DreamerV1, which launches none). Returns
    (out, steps, wall_s, counts); each step is (gradient step, time,
    metrics, the modules' parameters if ``keep_params``)."""
    import torch

    from sheeprl_tpu_torch.cli import run

    steps, last = [], [None]
    batches = set(fwd_by_batch) | set(bwd_by_batch)

    def on_step(agent, step, *rest):  # (metrics) or, on DreamerV3's loop, (tau, metrics)
        metrics = rest[-1]
        bad = [k for k, v in metrics.items() if not torch.isfinite(v).all()]
        if bad:
            fail(f"{what}: non-finite metrics at gradient step {step}: {bad}")
        now = read_counts()
        fwd = {b: now["forward_by_batch"].get(b, 0) - last[0]["forward_by_batch"].get(b, 0) for b in batches}
        bwd = {b: now["backward_by_batch"].get(b, 0) - last[0]["backward_by_batch"].get(b, 0) for b in batches}
        if {b: n for b, n in fwd.items() if n} != fwd_by_batch or {b: n for b, n in bwd.items() if n} != bwd_by_batch:
            fail(f"{what}: gradient step {step} launched forward {fwd} and backward {bwd} by batch, expected {fwd_by_batch} and {bwd_by_batch}")
        last[0] = now
        params = {n: _params(getattr(agent, n)) for n in ("world_model", "actor", "critic")} if keep_params else None
        steps.append((step, time.perf_counter(), {k: v.item() for k, v in metrics.items()}, params))

    torch.cuda.synchronize()
    zero_counts()
    last[0] = read_counts()
    t0 = time.perf_counter()
    out = run(args, callback=on_step)
    torch.cuda.synchronize()
    return out, steps, time.perf_counter() - t0, read_counts()


def _same_state(a, b):
    """The names of the tensors of two state dicts that differ (bit for bit)."""
    return [k for k in a if not torch_equal_bits(a[k], b[k])]


def check_episode_files(out, what):
    """The episodic buffer's memory-mapped files: a directory per saved
    episode, each file sized to its episode (not to buffer.size), and the
    disk blocks they use."""
    root = os.path.join(out["log_dir"], "memmap_buffer", "rank_0")
    episodes = sorted(d for d in os.listdir(root) if d.startswith("episode_"))
    files = {}
    for d in episodes:
        for name in sorted(os.listdir(os.path.join(root, d))):
            st = os.stat(os.path.join(root, d, name))
            files[f"{d}/{name}"] = {"bytes": st.st_size, "disk_bytes": st.st_blocks * 512}
    rb = out["buffer"]
    saved = len(rb.buffer)
    rgb = [f["bytes"] for k, f in files.items() if k.endswith("/rgb.memmap")]
    if len(episodes) != saved or len(files) != 6 * saved or any(n != DV2_EPISODE_ROWS * 64 * 64 * 3 for n in rgb):
        fail(f"{what}: {len(episodes)} episode dirs and {len(files)} files for {saved} saved episodes; rgb bytes {rgb}")
    apparent, used = sum(f["bytes"] for f in files.values()), sum(f["disk_bytes"] for f in files.values())
    log(f"{what}: episodic replay of {rb.buffer_size} rows (buffer.size / num_envs): {saved} episodes of {DV2_EPISODE_ROWS} rows saved, "
        f"{len(files)} files, {apparent / 1e6:.3f} MB apparent, {used / 1e6:.3f} MB of disk blocks used, on {filesystem_of(root)}")  # fmt: skip
    return {"episodes": saved, "capacity_rows": rb.buffer_size, "apparent_bytes": apparent, "disk_bytes_used": used, "files": len(files)}


def phase_dv2_training(log_root):
    """(2) ``exp=dreamer_v2_ms_pacman env=dummy`` through the CLI at full
    width, cut (``DV2_CUTS``) to 8 gradient steps, each launching 50 + 15
    forwards (B = 32 and 1600, all on the streaming kernel) and 50 + 15
    backwards; no launch of the tensor-core kernel in the whole run. The
    episodic buffer's files, the logged tags, the modules moved. Then the
    resume from the checkpoint after the 4th gradient step, ending on the
    uninterrupted run's modules and Adam states bit for bit, and ``eval``
    on the last checkpoint."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch.config import compose

    cfg = compose(DV2_ARGS)
    log(f"dv2 training: exp=dreamer_v2_ms_pacman env=dummy (rgb 64x64x3, 9 actions), full width (H {cfg.algo.world_model.recurrent_model.recurrent_state_size}, "
        f"dense {cfg.algo.dense_units}, CNN x{cfg.algo.world_model.encoder.cnn_channels_multiplier}), {cfg.fabric.precision}, batch "
        f"{cfg.algo.per_rank_batch_size} x {cfg.algo.per_rank_sequence_length}, horizon {cfg.algo.horizon}, buffer {cfg.buffer.type} "
        f"(prioritize_ends {cfg.buffer.prioritize_ends}, memmap {cfg.buffer.memmap}, size {cfg.buffer.size}); cut: {json.dumps(DV2_CUTS)}")  # fmt: skip
    args = [*DV2_ARGS, f"log_root={log_root}"]
    out, steps, wall_s, counts = dreamer_through_cli(args, "dv2 training", DV2_FWD_BY_BATCH, DV2_BWD_BY_BATCH)
    if out["gradient_steps"] != DV2_STEPS or len(steps) != DV2_STEPS:
        fail(f"dv2 training: {out['gradient_steps']} gradient steps, expected {DV2_STEPS}")
    if counts["tensor_core"] != 0:
        fail(f"dv2 training: the tensor-core kernel ran {counts['tensor_core']} times")
    if not counts["forward_by_batch"].get(DV2_ENVS):
        fail(f"dv2 training: the player launched no forward at B = {DV2_ENVS} ({counts['forward_by_batch']})")
    last = out["log"][-1]
    if not all(np.isfinite(v) for v in last.values()) or "Loss/world_model_loss" not in last:
        fail(f"dv2 training: logged {last}")
    tags = {tag for row in out["log"] for tag in row}
    for tag in ("Loss/world_model_loss", "Loss/value_loss", "Loss/policy_loss", "State/kl", "Params/replay_ratio", "Time/sps_train",
                "Time/sps_env_interaction", "Rewards/rew_avg"):  # fmt: skip
        if tag not in tags:
            fail(f"dv2 training: {tag} was never logged ({sorted(tags)})")
    files = check_episode_files(out, "dv2 training")
    ckpt = next((c for c in out["checkpoints"] if c.endswith("ckpt_320_0.ckpt")), None)
    if ckpt is None:
        fail(f"dv2 training: no checkpoint at policy step 320 ({out['checkpoints']})")
    t0 = time.perf_counter()
    again, again_steps, _, again_counts = dreamer_through_cli([*args, f"checkpoint.resume_from={ckpt}"], "dv2 resume", DV2_FWD_BY_BATCH,
                                                              DV2_BWD_BY_BATCH)  # fmt: skip
    resume_s = time.perf_counter() - t0
    if [s[0] for s in again_steps] != list(range(DV2_RESUMED_FROM + 1, DV2_STEPS + 1)):
        fail(f"dv2 resume: gradient steps {[s[0] for s in again_steps]}")
    differ = _same_state(out["agent"].state_dict(), again["agent"].state_dict())
    for name, opt in out["optimizers"].items():
        other = again["optimizers"][name]
        for i, (p, q) in enumerate(zip(opt.param_groups[0]["params"], other.param_groups[0]["params"])):
            differ += [f"{name} Adam {k} {i}" for k in opt.state[p] if not torch_equal_bits(opt.state[p][k], other.state[q][k])]
    if differ:
        fail(f"dv2 resume: {len(differ)} tensors differ from the uninterrupted run, e.g. {differ[:4]}")
    evaluation = phase_eval(out["checkpoints"][-1], out["test_reward"], "dv2 eval")
    step_wall = [b[1] - a[1] for a, b in zip(steps, steps[1:])]
    result = {"cuts": DV2_CUTS, "gradient_steps": out["gradient_steps"], "policy_steps": out["policy_steps"], "wall_s": wall_s,
              "ln_gru_launches": counts, "resume_ln_gru_launches": again_counts, "resume_s": resume_s,
              "trainer_wall_ms_between_gradient_steps": statistics.median(step_wall) * 1e3, "metrics_last_step": steps[-1][2],
              "logged_sps_train": read_tag(out, "Time/sps_train"), "test_reward": out["test_reward"], "episodic_buffer": files,
              "evaluation": evaluation}  # fmt: skip
    log(f"dv2 training: {DV2_STEPS} gradient steps in {out['policy_steps']} policy steps, {wall_s:.1f} s; LN-GRU forward by batch "
        f"{counts['forward_by_batch']} (tensor core {counts['tensor_core']}), backward by batch {counts['backward_by_batch']}; median "
        f"{result['trainer_wall_ms_between_gradient_steps']:.1f} ms between gradient steps; logged Time/sps_train {result['logged_sps_train']}; "
        f"resumed from gradient step {DV2_RESUMED_FROM} bit for bit in {resume_s:.1f} s; eval = the test episode's {out['test_reward']}")  # fmt: skip
    log(f"dv2 training: last step {json.dumps({k: float(f'{v:.5g}') for k, v in steps[-1][2].items()})}")
    return result, out["agent"], cfg


def phase_dv2_reference():
    """(3) One DV2 gradient step at full width (B = 4, T = 16, horizon 15)
    on the card (its kernels) against the CPU (the plain versions), from the
    same seeded weights and batch, the card's categorical draws recorded and
    replayed on the CPU. 32-true: losses and metrics within rtol 2e-3 + atol
    1e-4; each parameter leaf's change, ``||d_card - d_cpu|| / ||d_cpu||``,
    within ``DV2_PARAM_CHANGE_TOL``; the LN-GRU dense bias's pre-clip
    gradient within ``DV2_BIAS_GRAD_TOL`` of its norm. The card's step from
    weights one f32 ulp away is reported, and each of ``DV2_FAULTS`` planted
    on the card must fail the leaf check. bf16-mixed: the dense bias's
    gradient within ``DV2_BF16_BIAS_GRAD_TOL`` and its Adam update within
    ``DV2_BF16_BIAS_CHANGE_TOL`` of the CPU's bf16 step."""
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v2 import dreamer_v2 as dv2
    from sheeprl_tpu_torch.algos.dreamer_v2.agent import build_agent
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.serve.spaces import Box, DictSpace
    from sheeprl_tpu_torch.utils.distribution import BatchGenerator

    space = DictSpace({"rgb": Box((64, 64, 3), "uint8", 0.0, 255.0)})
    draws = {}
    bias = "recurrent_model.rnn.bias"

    def step(where, precision, fault=None):
        cfg = compose(["exp=dreamer_v2_ms_pacman", "env=dummy", f"fabric.precision={precision}"])
        agent = build_agent((9,), False, cfg, space, precision=precision, device=where, seed=3)
        if fault == "nudge":
            with torch.no_grad():
                for p in agent.parameters():
                    p.mul_(1 + 2.0**-23)
        start = {k: v.detach().cpu().clone() for k, v in agent.state_dict().items()}
        optimizers = dv2.make_optimizers(agent, cfg)
        if fault == "lr x 2":
            for opt in optimizers.values():
                for group in opt.param_groups:
                    group["lr"] = 2 * group["lr"]
        elif fault == DV2_FAULTS[1]:
            agent.world_model.recurrent_model.rnn.bias.register_hook(torch.zeros_like)
        grads = {}

        def capture(module, max_norm):
            if module is agent.world_model:
                grads.update({k: p.grad.detach().float().cpu().clone() for k, p in module.named_parameters() if p.grad is not None})
            return clip(module, max_norm)

        key = precision
        rng = RecordedDraws(BatchGenerator.from_seed(0, torch.device(where))) if key not in draws else ReplayedDraws(draws[key])
        clip = dv2._clip
        with patched(dv2, "_clip", capture):
            metrics = dv2.make_train_step(agent, optimizers, cfg)(_train_batch(16, 4, 11, torch.device(where)), rng)
        if key not in draws:
            draws[key] = rng.draws
        elif rng.used != len(draws[key]):
            fail(f"dv2 reference: the replaying step drew {rng.used} times, the recording one {len(draws[key])}")
        end = {k: v.detach().cpu() for k, v in agent.state_dict().items()}
        return {k: float(v) for k, v in metrics.items()}, start, end, grads

    def worst(gaps):
        k = max(gaps, key=gaps.get)
        return {"leaf": k, "gap": gaps[k]}

    def leaf_gaps(got, want, got_start, want_start):
        out = {}
        for k in want:
            if k.startswith("target_critic."):
                continue
            g, w = (got[k] - got_start[k]).double(), (want[k] - want_start[k]).double()
            out[k] = ((g - w).norm() / w.norm()).item() if w.norm() > 0 else float(g.norm() > 0)
        return out

    def rel(a, b):
        return ((a.double() - b.double()).norm() / b.double().norm()).item()

    gpu_m, gpu_start, gpu_p, gpu_g = step("cuda", "32-true")
    cpu_m, cpu_start, cpu_p, cpu_g = step("cpu", "32-true")
    if any(not torch.equal(gpu_start[k], cpu_start[k]) for k in cpu_start):
        fail("dv2 reference: the card's agent does not start from the CPU's weights")
    for k, ref in cpu_m.items():
        if not (math.isfinite(gpu_m[k]) and abs(gpu_m[k] - ref) <= 1e-4 + 2e-3 * abs(ref)):
            fail(f"dv2 reference: {k} on the card {gpu_m[k]} vs the CPU {ref}")
    if float(cpu_g[bias].norm()) == 0:
        fail("dv2 reference: the LN-GRU dense bias got no gradient")
    bias_gap = rel(gpu_g[bias], cpu_g[bias])
    if bias_gap > DV2_BIAS_GRAD_TOL:
        fail(f"dv2 reference: the LN-GRU dense bias's gradient differs by {bias_gap} of its norm (> {DV2_BIAS_GRAD_TOL})")
    param = worst(leaf_gaps(gpu_p, cpu_p, gpu_start, cpu_start))
    if param["gap"] > DV2_PARAM_CHANGE_TOL:
        fail(f"dv2 reference: {param['leaf']}'s change differs by {param['gap']} of its norm (> {DV2_PARAM_CHANGE_TOL})")
    _, nudge_start, nudge_p, _ = step("cuda", "32-true", "nudge")
    floor = worst(leaf_gaps(nudge_p, gpu_p, nudge_start, gpu_start))
    faults = {}
    for fault in DV2_FAULTS:
        _, f_start, f_p, _ = step("cuda", "32-true", fault)
        faults[fault] = worst(leaf_gaps(f_p, cpu_p, f_start, cpu_start))
        if faults[fault]["gap"] <= DV2_PARAM_CHANGE_TOL:
            fail(f"dv2 reference: the step with {fault} passes the leaf check ({faults[fault]})")
    bf_gpu_m, bf_gpu_start, bf_gpu_p, bf_gpu_g = step("cuda", "bf16-mixed")
    bf_cpu_m, bf_cpu_start, bf_cpu_p, bf_cpu_g = step("cpu", "bf16-mixed")
    bf16 = {"bias_grad_gap": rel(bf_gpu_g[bias], bf_cpu_g[bias]),
            "bias_change_gap": leaf_gaps(bf_gpu_p, bf_cpu_p, bf_gpu_start, bf_cpu_start)[f"world_model.{bias}"],
            "world_model_loss": [bf_gpu_m["Loss/world_model_loss"], bf_cpu_m["Loss/world_model_loss"]]}  # fmt: skip
    if bf16["bias_grad_gap"] > DV2_BF16_BIAS_GRAD_TOL or bf16["bias_change_gap"] > DV2_BF16_BIAS_CHANGE_TOL:
        fail(f"dv2 reference: bf16-mixed, the LN-GRU dense bias {bf16} (limits {DV2_BF16_BIAS_GRAD_TOL}, {DV2_BF16_BIAS_CHANGE_TOL})")
    log(f"dv2 reference: one full-width DV2 gradient step (B=4 T=16), card (kernels) vs CPU (plain), {len(draws['32-true'])} replayed "
        f"draws; 32-true: max loss rel |d| {max(abs(gpu_m[k] - cpu_m[k]) / max(abs(cpu_m[k]), 1e-12) for k in cpu_m):.3g}, LN-GRU bias "
        f"gradient {bias_gap:.3g} of its norm (limit {DV2_BIAS_GRAD_TOL}), worst leaf's change {param['gap']:.3g} ({param['leaf']}, limit "
        f"{DV2_PARAM_CHANGE_TOL}); the card from weights one ulp away {json.dumps(floor)}; planted faults {json.dumps(faults)}; "
        f"bf16-mixed {json.dumps(bf16)}")  # fmt: skip
    return {"losses_card": gpu_m, "losses_cpu": cpu_m, "bias_grad_gap": bias_gap, "worst_param_change": param, "one_ulp_nudge": floor,
            "planted_faults": faults, "bf16": bf16,
            "tolerance": {"loss_rtol": 2e-3, "loss_atol": 1e-4, "param_change": DV2_PARAM_CHANGE_TOL, "bias_grad": DV2_BIAS_GRAD_TOL,
                          "bf16_bias_grad": DV2_BF16_BIAS_GRAD_TOL, "bf16_bias_change": DV2_BF16_BIAS_CHANGE_TOL}}  # fmt: skip


def phase_dv2_profile(agent, cfg, steps: int = 3, profiled_steps: int = 1):
    """(4) Where one DV2 gradient step's time goes (bf16-mixed, B = 32,
    T = 50, horizon 15, on the trained agent): host wall per step over
    ``steps`` (ending in a synchronize), device busy and idle share over
    ``profiled_steps`` more (``_busy``: annotation ranges left out), device
    operations, LN-GRU launches by kernel and batch, the LN-GRU kernels'
    device time and share of busy, the stages' spans, and peak memory."""
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import make_optimizers, make_train_step
    from sheeprl_tpu_torch.utils.distribution import BatchGenerator

    dev = torch.device("cuda")
    step = make_train_step(agent, make_optimizers(agent, cfg), cfg)
    data = _train_batch(DV2_SEQ, DV2_BATCH, 7, dev)
    rng = BatchGenerator.from_seed(0, dev)
    step(data, rng)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        step(data, rng)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    prof = profiled(lambda: [step(data, rng) for _ in range(profiled_steps)], ("cpu", "cuda"))
    kernels_ms, averages = {}, prof.key_averages()
    busy, ops, annotated = _busy(averages, profiled_steps, skip=("dv2/",), by_kernel=kernels_ms)
    if busy <= 0.0:
        fail("dv2 profile: torch.profiler saw no device time")
    stages = {}
    for evt in averages:
        if evt.key.startswith("dv2/"):
            us = getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0.0)
            side = "device_span_ms" if evt.device_type == torch.autograd.DeviceType.CUDA else "host_ms"
            stages.setdefault(evt.key, {})[side] = (us if side == "device_span_ms" else evt.cpu_time_total) / profiled_steps / 1e3
    gru = {k: v for k, v in kernels_ms.items() if "ln_gru" in k}
    fwd_by_batch = {b: n / steps for b, n in counts["forward_by_batch"].items()}
    bwd_by_batch = {b: n / steps for b, n in counts["backward_by_batch"].items()}
    if fwd_by_batch != DV2_FWD_BY_BATCH or bwd_by_batch != DV2_BWD_BY_BATCH or counts["tensor_core"] != 0:
        fail(f"dv2 profile: launches per step forward {fwd_by_batch} backward {bwd_by_batch} tensor core {counts['tensor_core']}")
    top = dict(sorted(kernels_ms.items(), key=lambda kv: -kv[1])[:8])
    result = {"host_wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy, "idle_share": max(0.0, 1.0 - busy / wall_ms),
              "device_ops_per_step": ops, "annotation_ranges_ms_per_step": annotated, "peak_gib": peak,
              "ln_gru_device_ms_per_step": gru, "ln_gru_share_of_busy": sum(gru.values()) / busy,
              "ln_gru_forward_per_step_by_batch": fwd_by_batch, "ln_gru_backward_per_step_by_batch": bwd_by_batch,
              "stages_per_step": stages, "top_device_ms_per_step": top}  # fmt: skip
    log(f"dv2 profile (bf16-mixed, B=32 T=50 H=15, H_rnn=600): host wall {wall_ms:.2f} ms/step, device busy {busy:.2f} ms/step, idle share "
        f"{result['idle_share']:.3f}, {ops:.0f} device ops/step, peak {peak:.2f} GiB; LN-GRU {sum(gru.values()):.3f} ms/step "
        f"({100 * result['ln_gru_share_of_busy']:.1f}% of busy) {json.dumps({k: round(v, 4) for k, v in gru.items()})}")  # fmt: skip
    log(f"dv2 profile: stages {json.dumps({k: {s: round(v, 3) for s, v in d.items()} for k, d in stages.items()})}; top {json.dumps({k: round(v, 3) for k, v in top.items()})}")
    return result


def phase_dv1_training(log_root):
    """(5) ``exp=dreamer_v1 env=dummy`` through the CLI at the recipe's
    widths (the ``state`` vector; recurrent state 200, dense 400, batch 50 x
    50), cut (``DV1_CUTS``) to 8 gradient steps; no LN-GRU launch at all
    (DreamerV1's GRU is plain torch); resumed from the checkpoint after the
    4th gradient step, bit for bit; ``eval``."""
    out, steps, wall_s, counts = dreamer_through_cli([*DV1_ARGS, f"log_root={log_root}"], "dv1 training", {}, {})
    if out["gradient_steps"] != DV1_STEPS:
        fail(f"dv1 training: {out['gradient_steps']} gradient steps, expected {DV1_STEPS}")
    if counts["forward"] or counts["backward"]:
        fail(f"dv1 training: LN-GRU launches {counts}")
    ckpt = next((c for c in out["checkpoints"] if c.endswith("ckpt_240_0.ckpt")), None)
    if ckpt is None:
        fail(f"dv1 training: no checkpoint at policy step 240 ({out['checkpoints']})")
    again, again_steps, _, again_counts = dreamer_through_cli([*DV1_ARGS, f"log_root={log_root}", f"checkpoint.resume_from={ckpt}"],
                                                              "dv1 resume", {}, {})  # fmt: skip
    if [s[0] for s in again_steps] != list(range(DV1_RESUMED_FROM + 1, DV1_STEPS + 1)):
        fail(f"dv1 resume: gradient steps {[s[0] for s in again_steps]}")
    differ = _same_state(out["agent"].state_dict(), again["agent"].state_dict())
    if differ or again_counts["forward"] or again_counts["backward"]:
        fail(f"dv1 resume: {len(differ)} tensors differ, e.g. {differ[:4]}; LN-GRU launches {again_counts}")
    evaluation = phase_eval(out["checkpoints"][-1], out["test_reward"], "dv1 eval")
    log(f"dv1 training: exp=dreamer_v1 env=dummy, cut {json.dumps(DV1_CUTS)}: {DV1_STEPS} gradient steps in {out['policy_steps']} policy "
        f"steps, {wall_s:.1f} s, LN-GRU launches {counts['forward']} + {counts['backward']}; resumed bit for bit; eval = the test episode's "
        f"{out['test_reward']}; last step {json.dumps({k: float(f'{v:.5g}') for k, v in steps[-1][2].items()})}")  # fmt: skip
    return {"cuts": DV1_CUTS, "gradient_steps": out["gradient_steps"], "wall_s": wall_s, "ln_gru_launches": counts,
            "metrics_last_step": steps[-1][2], "evaluation": evaluation}  # fmt: skip


# A2C and recurrent PPO (phases 26-30): the host path, one process each, on
# PPO's rollout and GAE. Neither launches an LN-GRU kernel (the JAX package
# leaves A2C's MLPs and flax's LSTM cell to XLA): their counts stay at 0.
A2C_CUTS = {"algo.total_steps": "400 (from 25000; 20 updates)", "metric.log_every": "200 (from 5000)",
            "checkpoint.every": "200 (from 100)"}  # fmt: skip
A2C_ARGS = ["exp=a2c", "env=dummy", "algo.total_steps=400", "metric.log_every=200", "checkpoint.every=200"]
A2C_UPDATES = 20
PPO_REC_CUTS = {"algo.total_steps": "16384 (from 409000; 2 updates)", "checkpoint.every": "8192 (from 100)"}
PPO_REC_ARGS = ["exp=ppo_recurrent", "env=dummy", "algo.total_steps=16384", "checkpoint.every=8192"]
PPO_REC_UPDATES = 2
# The card's update against the CPU's, per parameter leaf's change and per
# optimizer-state leaf (RMSprop's accumulator, AdamW's moments): the bound
# of PERF.md §2, for A2C's update (one RMSprop step; an H100 reads 7.5e-6)
# and recurrent PPO's first AdamW step and first epoch (8 AdamW steps; an
# H100 reads 2.0e-5 per leaf, 1.0e-5 per moment, and the step-count fault
# 0.73); its whole update takes PPO's.
ONPOLICY_REF_TOL = 2e-3
ONPOLICY_FAULTS = ("lr x 2", "last leaf's gradient zeroed")
PPO_REC_EPOCH_FAULTS = (*ONPOLICY_FAULTS, "AdamW's step count held at 1")


def phase_a2c(log_root):
    """(26) ``exp=a2c env=dummy`` through the CLI at the recipe's widths,
    resumed from its mid-run checkpoint bit for bit, ``eval`` on its last,
    the trained agent's update and rollout step profiled."""
    result, out, snaps, cfg = ppo_train(A2C_ARGS, A2C_CUTS, "a2c", log_root, A2C_UPDATES, trainer="a2c")
    resume = onpolicy_resume(out, snaps, cfg, A2C_ARGS, "a2c", log_root, "a2c resume")
    evaluation = phase_eval(out["checkpoints"][-1], out["test_reward"], "a2c eval")
    profile = onpolicy_profile("a2c", out["agent"], cfg, "a2c profile")
    return {"training": result, "resume": resume, "evaluation": evaluation, "profile": profile}


def _sequence_rollout(cfg, dev, seed):
    """A recurrent PPO rollout at the exp's shapes on ``dev`` (random
    observations, actions, rewards, values, log-probs, ~1% dones, the stored
    carries) and the update's sequences assembled from it."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch.algos.ppo_recurrent.ppo_recurrent import make_sequences
    from sheeprl_tpu_torch.utils.ops import gae

    T, E, H = int(cfg.algo.rollout_steps), int(cfg.env.num_envs), int(cfg.algo.rnn.lstm.hidden_size)
    data, next_obs = _ppo_rollout(cfg, T, E, torch.device("cpu"), seed)
    rng = np.random.default_rng(seed + 1)
    data["prev_actions"] = torch.roll(data["actions"], 1, 0) * (1 - torch.roll(data["dones"], 1, 0).float())
    data["prev_actions"][0] = 0
    data["prev_hx"], data["prev_cx"] = (torch.from_numpy(rng.normal(0, 0.3, (T, E, H)).astype(np.float32)) for _ in range(2))
    data["returns"], data["advantages"] = gae(data["rewards"], data["values"], data["dones"].float(), data["values"][-1], 0.99, 0.95)
    keys = (*cfg.algo.cnn_keys.encoder, *cfg.algo.mlp_keys.encoder, "prev_actions", "actions", "logprobs", "values", "advantages", "returns")
    seq = make_sequences(data, int(cfg.algo.per_rank_sequence_length), bool(cfg.algo.reset_recurrent_state_on_done), keys)
    return {k: v.to(dev) for k, v in seq.items()}, {k: v.to(dev) for k, v in next_obs.items()}


def phase_ppo_recurrent(log_root):
    """(27) ``exp=ppo_recurrent env=dummy`` through the CLI at the recipe's
    widths, resumed from its mid-run checkpoint bit for bit, ``eval``."""
    result, out, snaps, cfg = ppo_train(PPO_REC_ARGS, PPO_REC_CUTS, "ppo_recurrent", log_root, PPO_REC_UPDATES, trainer="ppo_recurrent")
    resume = onpolicy_resume(out, snaps, cfg, PPO_REC_ARGS, "ppo_recurrent", log_root, "ppo_recurrent resume")
    evaluation = phase_eval(out["checkpoints"][-1], out["test_reward"], "ppo_recurrent eval")
    return {"training": result, "resume": resume, "evaluation": evaluation}, out["agent"], cfg


def onpolicy_profile(trainer, agent, cfg, what):
    """One update of the trained ``trainer`` agent at the recipe's shapes
    (A2C: GAE over 4 x 5 and 4 minibatches into one RMSprop step; recurrent
    PPO: 512 sequences of 16, 8 epochs of 8 minibatches, 64 AdamW steps),
    and one rollout step of its envs (the player's forward and the one copy
    to the host): host wall (ending in a synchronize), device busy and idle
    share (``_busy``), device operations, peak memory."""
    import importlib

    import torch

    from sheeprl_tpu_torch.algos.ppo.ppo import make_optimizer, minibatch_indices
    from sheeprl_tpu_torch.utils.distribution import BatchGenerator
    from sheeprl_tpu_torch.utils.utils import prepare_obs

    dev = torch.device("cuda")
    step = importlib.import_module(f"sheeprl_tpu_torch.algos.{trainer}.{trainer}").make_train_step(agent, make_optimizer(agent, cfg)[0], cfg)
    T, E = int(cfg.algo.rollout_steps), int(cfg.env.num_envs)
    gen = torch.Generator(device=dev).manual_seed(0)
    if trainer == "a2c":
        data, next_obs = _ppo_rollout(cfg, T, E, dev, 21)
        n, mb, epochs = T * E, int(cfg.algo.per_rank_batch_size), 1

        def update():
            return step(data, next_obs, minibatch_indices(n, mb, 1, gen)[0])
    else:
        data, next_obs = _sequence_rollout(cfg, dev, 21)
        n, epochs = data["actions"].shape[0], int(cfg.algo.update_epochs)
        mb = max(1, n // int(cfg.algo.per_rank_num_batches))
        clip, ent = (torch.tensor(float(v), device=dev) for v in (cfg.algo.clip_coef, cfg.algo.ent_coef))

        def update():
            return step(data, minibatch_indices(n, mb, epochs, gen), clip, ent)

    update()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(2):
        update()
    torch.cuda.synchronize()
    update_ms = (time.perf_counter() - t0) / 2 * 1e3
    update_peak = torch.cuda.max_memory_allocated() / 2**30
    update_busy, update_ops, _ = _busy(profiled(update, ("cpu", "cuda")).key_averages(), 1, skip=(f"{trainer}/",))
    if update_busy <= 0.0:
        fail(f"{what}: torch.profiler saw no device time in the update")

    keys = list(cfg.algo.cnn_keys.encoder) + list(cfg.algo.mlp_keys.encoder)
    host_obs = {k: v.cpu().numpy() for k, v in next_obs.items() if k in keys}
    rng = BatchGenerator.from_seed(0, dev)
    state = {"carry": agent.initial_states(E)} if trainer == "ppo_recurrent" else {}
    prev_actions = torch.zeros(E, sum(agent.actions_dim), device=dev)

    def rollout_step():
        prepared = prepare_obs(host_obs, cnn_keys=list(cfg.algo.cnn_keys.encoder), num_envs=E)
        obs = {k: torch.from_numpy(v).to(dev) for k, v in prepared.items()}
        with torch.no_grad():
            if trainer == "a2c":
                actions, real, logprobs, values = agent.player_step(obs, rng)
                torch.cat([actions.float(), logprobs, values, real.float()], -1).cpu()
            else:
                prev = state["carry"]
                actions, real, logprobs, values, state["carry"] = agent.player_step(obs, prev_actions, prev, rng)
                torch.cat([actions.float(), logprobs, values, prev[1], prev[0], real.float()], -1).cpu()

    for _ in range(5):
        rollout_step()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(50):
        rollout_step()
    step_ms = (time.perf_counter() - t0) / 50 * 1e3
    step_peak = torch.cuda.max_memory_allocated() / 2**30
    step_busy, step_ops, _ = _busy(profiled(lambda: [rollout_step() for _ in range(20)], ("cpu", "cuda")).key_averages(), 20,
                                   skip=(f"{trainer}/",))  # fmt: skip
    optimizer_steps = epochs * -(-n // mb) if trainer == "ppo_recurrent" else 1
    result = {
        "update": {"host_wall_ms": update_ms, "device_busy_ms": update_busy, "idle_share": max(0.0, 1 - update_busy / update_ms),
                   "device_ops": update_ops, "optimizer_steps": optimizer_steps, "rows_or_sequences": n, "peak_gib": update_peak},
        "rollout_step": {"host_wall_ms": step_ms, "device_busy_ms": step_busy, "idle_share": max(0.0, 1 - step_busy / step_ms),
                         "device_ops": step_ops, "peak_gib": step_peak, "num_envs": E},
    }  # fmt: skip
    log(f"{what}: update ({optimizer_steps} optimizer step(s) over {n} {'rows' if trainer == 'a2c' else 'sequences'}) {update_ms:.2f} ms host "
        f"wall, {update_busy:.3f} ms device busy (idle {result['update']['idle_share']:.3f}), {update_ops:.0f} device operations, peak "
        f"{update_peak:.2f} GiB; rollout step (player forward + one copy to the host, {E} envs) {step_ms:.3f} ms host wall, {step_busy:.3f} "
        f"ms busy (idle {result['rollout_step']['idle_share']:.3f}), {step_ops:.0f} operations")  # fmt: skip
    return result


def phase_ppo_recurrent_profile(agent, cfg):
    """(28) Recurrent PPO's update and rollout step (:func:`onpolicy_profile`)."""
    return onpolicy_profile("ppo_recurrent", agent, cfg, "ppo_recurrent profile")


def onpolicy_reference(trainer, args, what):
    """One update of ``trainer`` (A2C: the recipe's 4 x 5 rollout, 4
    minibatches summed into one RMSprop step; recurrent PPO: 16 x 512, 64
    AdamW steps over sequences of 16) on the card in 32-true with TF32 off
    against the same update on the CPU, from the same weights, data and
    indices. Each parameter leaf's change from the start, ``||d_card -
    d_cpu|| / ||d_cpu||``, and each leaf of the optimizer's state, within
    ``ONPOLICY_REF_TOL``; the mean losses within rtol 1e-4. Recurrent PPO is
    held so over its update's first AdamW step and its first epoch (8 AdamW
    steps), where a fault in the later steps' bias correction must also be
    rejected; its whole update, whose
    clipped objective turns rounding into whole steps as ppo_atari's does
    (the card from weights one ulp away reads 0.069 and 0.10 on an H100),
    is held to PPO's bounds (``PPO_PARAM_CHANGE_TOL``,
    ``PPO_MOMENT_TOL``, losses within rtol 1e-3). For each, the card's
    update from weights one f32 ulp away is reported, and each of
    ``ONPOLICY_FAULTS`` (``PPO_REC_EPOCH_FAULTS`` for the first epoch)
    planted on the card must be rejected by the parameter check."""
    import importlib

    import torch

    from sheeprl_tpu_torch.algos.ppo.ppo import make_optimizer, minibatch_indices
    from sheeprl_tpu_torch.config import compose

    module = importlib.import_module(f"sheeprl_tpu_torch.algos.{trainer}.{trainer}")
    cfg = compose([*args, "device=cpu"])
    obs_space, actions_dim, continuous = _ppo_spaces(cfg)
    T, E = int(cfg.algo.rollout_steps), int(cfg.env.num_envs)
    gen = torch.Generator().manual_seed(3)
    if trainer == "a2c":
        indices = minibatch_indices(T * E, int(cfg.algo.per_rank_batch_size), 1, gen)[0]
        variants = {"update": (indices, ONPOLICY_REF_TOL, ONPOLICY_REF_TOL, 1e-4, ONPOLICY_FAULTS)}
    else:
        n = T // int(cfg.algo.per_rank_sequence_length) * E
        indices = minibatch_indices(n, max(1, n // int(cfg.algo.per_rank_num_batches)), int(cfg.algo.update_epochs), gen)
        variants = {"first AdamW step": (indices[:1, :1], ONPOLICY_REF_TOL, ONPOLICY_REF_TOL, 1e-4, ONPOLICY_FAULTS),
                    "first epoch": (indices[:1], ONPOLICY_REF_TOL, ONPOLICY_REF_TOL, 1e-4, PPO_REC_EPOCH_FAULTS),
                    "update": (indices, PPO_PARAM_CHANGE_TOL, PPO_MOMENT_TOL, 1e-3, ONPOLICY_FAULTS)}  # fmt: skip

    def update(where, idx, fault=None):
        agent = _onpolicy_agent(trainer).build_agent(actions_dim, continuous, cfg, obs_space, device=where, seed=7)
        if fault == "nudge":
            with torch.no_grad():
                for p in agent.parameters():
                    p.mul_(1 + 2.0**-23)
        start = {k: v.detach().cpu().clone() for k, v in agent.state_dict().items()}
        optimizer, _ = make_optimizer(agent, cfg)
        if fault == "lr x 2":
            for group in optimizer.param_groups:
                group["lr"] = 2 * group["lr"]
        elif fault == ONPOLICY_FAULTS[1]:
            list(agent.parameters())[-1].register_hook(torch.zeros_like)
        elif fault == PPO_REC_EPOCH_FAULTS[2]:
            # every step's bias correction that of the first: the count falls back to 0 before the next step adds one
            optimizer.register_step_post_hook(lambda opt, *_: [s["step"].zero_() for s in opt.state.values()])
        step = module.make_train_step(agent, optimizer, cfg)
        if trainer == "a2c":
            data, next_obs = _ppo_rollout(cfg, T, E, torch.device(where), 13)
            metrics = step(data, next_obs, idx.to(where))
        else:
            data, _ = _sequence_rollout(cfg, torch.device(where), 13)
            clip, ent = (torch.tensor(float(v), device=where) for v in (cfg.algo.clip_coef, cfg.algo.ent_coef))
            metrics = step(data, idx.to(where), clip, ent)
        names = dict(agent.named_parameters())
        state = {f"{k} {n}": v.detach().cpu() for n, p in names.items() for k, v in optimizer.state[p].items() if k != "step"}
        return ({k: float(v) for k, v in metrics.items()}, start, {k: v.detach().cpu() for k, v in agent.state_dict().items()}, state)

    def worst(gaps):
        k = max(gaps, key=gaps.get)
        return {"leaf": k, "gap": gaps[k]}

    results = {}
    for name, (idx, param_tol, state_tol, loss_rtol, planted) in variants.items():
        steps = 1 if trainer == "a2c" else idx.shape[0] * idx.shape[1]
        cpu_m, cpu_start, cpu_p, cpu_s = update("cpu", idx)
        gpu_m, gpu_start, gpu_p, gpu_s = update("cuda", idx)
        if any(not torch.equal(gpu_start[k], cpu_start[k]) for k in cpu_start):
            fail(f"{what}: the card's agent does not start from the CPU's weights")
        param = worst(_relative_gaps(gpu_p, cpu_p, gpu_start, cpu_start))
        opt_state = worst(_relative_gaps(gpu_s, cpu_s))
        _, nudge_start, nudge_p, nudge_s = update("cuda", idx, "nudge")
        floor = {"param": worst(_relative_gaps(nudge_p, gpu_p, nudge_start, gpu_start)), "optimizer_state": worst(_relative_gaps(nudge_s, gpu_s))}
        faults = {}
        for fault in planted:
            f_m, f_start, f_p, f_s = update("cuda", idx, fault)
            faults[fault] = {"param": worst(_relative_gaps(f_p, cpu_p, f_start, cpu_start)), "optimizer_state": worst(_relative_gaps(f_s, cpu_s)),
                             "loss_rel": max(abs(f_m[k] - cpu_m[k]) / abs(cpu_m[k]) for k in cpu_m)}  # fmt: skip
        log(f"{what} ({name}, {steps} optimizer step(s)): card against CPU in 32-true: losses {json.dumps({k: [gpu_m[k], cpu_m[k]] for k in cpu_m})} "
            f"(rtol {loss_rtol}); worst leaf's change {param['gap']:.3g} of its norm ({param['leaf']}, limit {param_tol}); worst "
            f"optimizer-state leaf {opt_state['gap']:.3g} ({opt_state['leaf']}, limit {state_tol}); the card from weights one ulp away "
            f"{json.dumps(floor)}; planted faults {json.dumps(faults)}")  # fmt: skip
        for k in cpu_m:
            if abs(gpu_m[k] - cpu_m[k]) > 1e-6 + loss_rtol * abs(cpu_m[k]):
                fail(f"{what} ({name}): {k} {gpu_m[k]} on the card, {cpu_m[k]} on the CPU")
        if param["gap"] > param_tol:
            fail(f"{what} ({name}): {param['leaf']}'s change on the card differs from the CPU's by {param['gap']} of its norm (> {param_tol})")
        if opt_state["gap"] > state_tol:
            fail(f"{what} ({name}): the optimizer's {opt_state['leaf']} differs on the card by {opt_state['gap']} of its norm (> {state_tol})")
        for fault, read in faults.items():
            if read["param"]["gap"] <= param_tol:
                fail(f"{what} ({name}): the update with {fault} passes the parameter check ({read['param']})")
        results[name] = {"optimizer_steps": steps, "losses_card": gpu_m, "losses_cpu": cpu_m, "worst_param_change": param,
                         "worst_optimizer_state": opt_state, "one_ulp_nudge": floor, "planted_faults": faults,
                         "tolerance": {"param_change": param_tol, "optimizer_state": state_tol, "loss_rtol": loss_rtol}}  # fmt: skip
    return results


def phase_a2c_reference():
    """(29) One A2C update, card against CPU (:func:`onpolicy_reference`)."""
    return onpolicy_reference("a2c", A2C_ARGS, "a2c reference")


def phase_ppo_recurrent_reference():
    """(30) One recurrent PPO update, card against CPU (:func:`onpolicy_reference`)."""
    return onpolicy_reference("ppo_recurrent", PPO_REC_ARGS, "ppo_recurrent reference")


# Plan2Explore (phases 31-36). P2E-DV3 (exp=p2e_dv3_exploration) composes
# to DreamerV3's XL widths: dense 1024 x 5 layers, recurrent state 4096 (the
# LN-GRU at D = 4096 + 1024), 32 x 32 latents, 32-true, batch 16 x 64,
# horizon 15, 4 envs on the dummy env's 10-float state and 2 actions, an
# ensemble of 8 members and two exploration critics. H = 4096 fails
# tensor_core_fits: every forward streams. A gradient step runs the dynamic
# scan (64 forwards and 64 backwards at B = 16) and two imaginations (the
# exploration actor's and the task actor's, 15 forwards each at B = 1024;
# discrete actions take no gradient through them). Only these are cut: 64
# iterations of random prefill (a window is 64 rows), then 4 gradient steps
# per iteration (replay ratio 1) for 2 iterations, a checkpoint after the
# first; finetuning plays the exploration actor for its 64 prefill
# iterations (there is no random prefill) and takes 8 DreamerV3 steps.
P2E_DEPTH, P2E_HIDDEN = 5120, 4096
P2E_BATCH, P2E_SEQ, P2E_HORIZON, P2E_ENVS = 16, 64, 15, 4
P2E_IMAGINED = P2E_BATCH * P2E_SEQ  # 1024
P2E_FWD_BY_BATCH = {P2E_BATCH: P2E_SEQ, P2E_IMAGINED: 2 * P2E_HORIZON}
P2E_BWD_BY_BATCH = {P2E_BATCH: P2E_SEQ}
P2E_FT_FWD_BY_BATCH = {P2E_BATCH: P2E_SEQ, P2E_IMAGINED: P2E_HORIZON}
P2E_CUTS = {"algo.learning_starts": "256 (from 1024)", "algo.total_steps": "260 (from 5000000; 8 gradient steps)",
            "checkpoint.every": "256 (from 100000)", "metric.log_every": "256 (from 5000)"}  # fmt: skip
P2E_ARGS = ["exp=p2e_dv3_exploration", "env=dummy", "algo.learning_starts=256", "algo.total_steps=260", "checkpoint.every=256",
            "metric.log_every=256", "checkpoint.save_last=True"]  # fmt: skip
P2E_STEPS, P2E_RESUMED_FROM = 8, 4
P2E_FT_CUTS = {"algo.learning_starts": "256 (from 16384)", "algo.total_steps": "260 (from 1000000; 8 gradient steps)",
               "checkpoint.every": "0 (from 100000)", "metric.log_every": "256 (from 5000)"}  # fmt: skip
P2E_FT_ARGS = ["exp=p2e_dv3_finetuning", "env=dummy", "algo.learning_starts=256", "algo.total_steps=260", "checkpoint.every=0",
               "metric.log_every=256", "checkpoint.save_last=True"]  # fmt: skip
P2E_CRITIC_TAGS = tuple(f"{t}_{n}" for t in ("Loss/value_loss_exploration", "Values_exploration/predicted_values",
                                              "Values_exploration/lambda_values", "Grads/critic_exploration") for n in ("extrinsic", "intrinsic"))  # fmt: skip
P2E_TAGS = ("Loss/world_model_loss", "Loss/ensemble_loss", "Loss/policy_loss_exploration", "Loss/policy_loss_task", "Loss/value_loss_task",
            "Grads/ensemble", "Grads/actor_exploration", "Rewards/intrinsic_intrinsic", *P2E_CRITIC_TAGS, "Params/replay_ratio",
            "Time/sps_train", "Rewards/rew_avg")  # fmt: skip
# The card's 32-true exploration step against the CPU's, at DreamerV3-S
# widths (algo/dreamer_v3_S.yaml; the CPU cannot take an XL step in the
# time): every metric within rtol 2e-3 + atol 1e-4 and every parameter
# leaf's change within 2e-3 of its norm. Each planted fault's reading (the
# larger of its worst metric's relative gap and its worst leaf's) must
# exceed the bound.
P2E_S_WIDTHS = ["algo.dense_units=512", "algo.mlp_layers=2", "algo.world_model.recurrent_model.recurrent_state_size=512",
                "algo.world_model.transition_model.hidden_size=512", "algo.world_model.representation_model.hidden_size=512"]  # fmt: skip
P2E_REF_TOL = 2e-3
# Every weight moved by this times a seeded standard normal first, as the
# CPU parity tests move theirs. At the seeded weights the reward and critic
# heads are zero, so the task actor's advantages are rounding residue and
# its gradient is mostly the entropy term's, with entries under Adam's eps
# (1e-5): its update is then proportional to the gradient and far below the
# learning rate, and its LayerNorm weights (stored at 1.0) move by a few f32
# ulps, so that leaf's change is a few rounded ulps whichever device takes
# the step. The seeded weights' readings (card against CPU, and the card
# from weights one ulp away, with the worst leaf's largest gap in ulps) are
# reported beside the held ones.
P2E_REF_PERTURB = 0.02
P2E_FAULTS = ("unbiased variance in the intrinsic reward", "ensemble updated after the exploration actor", "critic weights not normalised")
# P2E-DV2 (exp=p2e_dv2_exploration): DreamerV2 at recurrent state 400
# (D = 400 + 400), dense 400 x 4, 32-true, batch 16 x 50, horizon 15, 4
# envs; H = 400 is no multiple of 64, so every forward streams. A step runs
# the dynamic scan (50 at B = 16) and two imaginations (15 each at B = 800),
# all differentiated (DreamerV2's actor loss runs back through them). Only
# these are cut: 50 prefill iterations, then the recipe's ratio (0.2, 100
# pretrain steps) takes 8 gradient steps by policy step 240, 4 by 224.
P2E2_DEPTH, P2E2_HIDDEN = 800, 400
P2E2_BATCH, P2E2_SEQ = 16, 50
P2E2_IMAGINED = P2E2_BATCH * P2E2_SEQ  # 800
P2E2_FWD_BY_BATCH = P2E2_BWD_BY_BATCH = {P2E2_BATCH: P2E2_SEQ, P2E2_IMAGINED: 2 * P2E_HORIZON}
P2E2_FT_BY_BATCH = {P2E2_BATCH: P2E2_SEQ, P2E2_IMAGINED: P2E_HORIZON}
P2E2_CUTS = {"algo.learning_starts": "200 (from 1000)", "algo.total_steps": "240 (from 5000000; 8 gradient steps)",
             "checkpoint.every": "224 (from 100000)", "metric.log_every": "224 (from 5000)"}  # fmt: skip
P2E2_ARGS = ["exp=p2e_dv2_exploration", "env=dummy", "algo.learning_starts=200", "algo.total_steps=240", "checkpoint.every=224",
             "metric.log_every=224", "checkpoint.save_last=True"]  # fmt: skip
P2E2_FT_CUTS = {"algo.learning_starts": "200 (from 5000)", "algo.total_steps": "240 (from 1000000; 8 gradient steps)",
                "checkpoint.every": "0 (from 100000)", "metric.log_every": "224 (from 5000)"}  # fmt: skip
P2E2_FT_ARGS = ["exp=p2e_dv2_finetuning", "env=dummy", "algo.learning_starts=200", "algo.total_steps=240", "checkpoint.every=0",
                "metric.log_every=224", "checkpoint.save_last=True"]  # fmt: skip
P2E2_TAGS = ("Loss/world_model_loss", "Loss/ensemble_loss", "Loss/policy_loss_exploration", "Loss/value_loss_exploration",
             "Loss/policy_loss_task", "Loss/value_loss_task", "Rewards/intrinsic", "Grads/ensemble", "Grads/critic_exploration")  # fmt: skip
P2E_STEPS_BY_EXP = {"p2e_dv3_exploration": (P2E_STEPS, P2E_RESUMED_FROM), "p2e_dv2_exploration": (8, 4), "p2e_dv1_exploration": (8, 4)}


def _vector_batch(T, B, seed, device, n_actions=2, continuous=False):
    """A time-major batch of the dummy env's 10-float state."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    data = {k: v.cpu().numpy() for k, v in _train_batch(T, B, seed, torch.device("cpu"), n_actions, continuous).items() if k != "rgb"}
    data["state"] = rng.normal(size=(T, B, 10)).astype(np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in data.items()}


def _optimizer_states(optimizers):
    """Every optimizer of a trainer's (nested) dict, by name."""
    out = {}
    for name, opt in optimizers.items():
        out.update({f"{name}.{k}": v for k, v in _optimizer_states(opt).items()} if isinstance(opt, dict) else {name: opt})
    return out


def _same_optimizers(a, b):
    """Every Adam moment of two trainers' optimizers, bit for bit; returns
    what differs."""
    differ = []
    a, b = _optimizer_states(a), _optimizer_states(b)
    for name, opt in a.items():
        for i, (p, q) in enumerate(zip(opt.param_groups[0]["params"], b[name].param_groups[0]["params"])):
            differ += [f"{name} Adam {k} {i}" for k in opt.state[p] if not torch_equal_bits(opt.state[p][k], b[name].state[q][k])]
    return differ


def p2e_chain(what, args, cuts, fwd_by_batch, bwd_by_batch, tags, ft_args, ft_cuts, ft_fwd, ft_bwd, log_root, agent_cls, kernels=True,
              ft_resume=False):  # fmt: skip
    """One P2E variant through the CLI at its exp's widths: the exploration
    phase (every gradient step's LN-GRU launches by batch; none on the tensor
    cores; with ``kernels`` False none at all, the player's included), its
    tags, its resume from the mid-run checkpoint bit for bit,
    ``eval`` on its last checkpoint; then finetuning without
    ``checkpoint.exploration_ckpt_path`` (must raise), finetuning from the
    exploration checkpoint (the exploration actor plays up to
    ``learning_starts``, the task actor after it), with ``ft_resume`` its
    resume from its ``checkpoint.every`` checkpoint bit for bit, and ``eval``
    on its checkpoint. Returns (result, the exploration run's output)."""
    import numpy as np

    from sheeprl_tpu_torch.config import compose

    cfg = compose(args)
    steps_total, resumed_from = P2E_STEPS_BY_EXP[cfg.algo.name]
    log(f"{what}: {args[0]} env=dummy (state 10 floats, 2 actions), full width (H {cfg.algo.world_model.recurrent_model.recurrent_state_size}, "
        f"dense {cfg.algo.dense_units} x {cfg.algo.mlp_layers}, ensembles {cfg.algo.ensembles.n} x {cfg.algo.ensembles.dense_units} x "
        f"{cfg.algo.ensembles.mlp_layers}), {cfg.fabric.precision}, batch {cfg.algo.per_rank_batch_size} x {cfg.algo.per_rank_sequence_length}, "
        f"horizon {cfg.algo.horizon}, {cfg.env.num_envs} envs; cut: {json.dumps(cuts)}")  # fmt: skip
    full = [*args, f"log_root={log_root}"]
    out, steps, wall_s, counts = dreamer_through_cli(full, what, fwd_by_batch, bwd_by_batch)
    if out["gradient_steps"] != steps_total or len(steps) != steps_total:
        fail(f"{what}: {out['gradient_steps']} gradient steps, expected {steps_total}")
    if (counts["tensor_core"] != 0 or not counts["forward_by_batch"].get(int(cfg.env.num_envs))) if kernels else _launched(counts):
        fail(f"{what}: tensor-core launches {counts['tensor_core']}, player forwards {counts['forward_by_batch']}; all launches {counts}")
    logged = {tag for row in out["log"] for tag in row}
    missing = [t for t in tags if t not in logged]
    if missing or not all(np.isfinite(v) for row in out["log"] for v in row.values()):
        fail(f"{what}: tags never logged {missing}, or a non-finite one in {out['log'][-1]}")
    ckpt = next((c for c in out["checkpoints"] if os.path.basename(c) == f"ckpt_{cfg.checkpoint.every}_0.ckpt"), None)
    if ckpt is None:
        fail(f"{what}: no checkpoint at policy step {cfg.checkpoint.every} ({out['checkpoints']})")
    started = start_eval(out["checkpoints"][-1])  # runs beside the resume and the finetuning
    try:
        result = _p2e_resume_and_finetune(what, out, full, ckpt, fwd_by_batch, bwd_by_batch, steps_total, resumed_from, ft_args, ft_cuts,
                                          ft_fwd, ft_bwd, log_root, agent_cls, kernels, ft_resume)  # fmt: skip
    except BaseException:
        started[2].kill()
        raise
    result["evaluation"] = finish_eval(started, out["test_reward"], f"{what} eval")
    result.update(cuts=cuts, gradient_steps=out["gradient_steps"], wall_s=wall_s, ln_gru_launches=counts,
                  seconds_per_gradient_step=statistics.median(b[1] - a[1] for a, b in zip(steps, steps[1:])), metrics_last_step=steps[-1][2])
    log(f"{what}: {steps_total} gradient steps in {out['policy_steps']} policy steps, {wall_s:.1f} s (median "
        f"{result['seconds_per_gradient_step']:.3f} s between gradient steps); LN-GRU forward by batch {counts['forward_by_batch']}, backward "
        f"{counts['backward_by_batch']}, tensor core {counts['tensor_core']}; resumed from gradient step {resumed_from} bit for bit in "
        f"{result['resume_s']:.1f} s; finetuning {result['finetuning']['gradient_steps']} steps in {result['finetuning']['wall_s']:.1f} s, LN-GRU "
        f"forward {result['finetuning']['ln_gru_launches']['forward_by_batch']} backward {result['finetuning']['ln_gru_launches']['backward_by_batch']}, "
        f"the player switched actors after iteration {result['finetuning']['player_switched_after_iteration']}")  # fmt: skip
    log(f"{what}: last step {json.dumps({k: float(f'{v:.5g}') for k, v in steps[-1][2].items()})}")
    return result, out


def _launched(counts):
    """Whether any LN-GRU kernel was launched."""
    return any(counts[k] for k in ("forward", "backward", "streaming", "tensor_core"))


def _p2e_resume_and_finetune(what, out, full, ckpt, fwd_by_batch, bwd_by_batch, steps_total, resumed_from, ft_args, ft_cuts, ft_fwd, ft_bwd,
                             log_root, agent_cls, kernels=True, ft_resume=False):  # fmt: skip
    """:func:`p2e_chain`'s resume of the exploration run from ``ckpt`` (bit
    for bit) and its finetuning runs (refused without the exploration
    checkpoint; from it, the player's switch, with ``ft_resume`` its own
    resume bit for bit, and ``eval``)."""
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    t0 = time.perf_counter()
    again, again_steps, _, _ = dreamer_through_cli([*full, f"checkpoint.resume_from={ckpt}"], f"{what} resume", fwd_by_batch, bwd_by_batch)
    resume_s = time.perf_counter() - t0
    if [s[0] for s in again_steps] != list(range(resumed_from + 1, steps_total + 1)):
        fail(f"{what} resume: gradient steps {[s[0] for s in again_steps]}")
    differ = _same_state(out["agent"].state_dict(), again["agent"].state_dict()) + _same_optimizers(out["optimizers"], again["optimizers"])
    if differ:
        fail(f"{what} resume: {len(differ)} tensors differ from the uninterrupted run, e.g. {differ[:4]}")
    shutil.rmtree(again["log_dir"], ignore_errors=True)
    del again

    ft = [*ft_args, f"log_root={log_root}"]
    try:
        run(ft)
    except ValueError as err:
        if "exploration_ckpt_path" not in str(err):
            fail(f"{what} finetuning without its exploration checkpoint: {err}")
    else:
        fail(f"{what}: finetuning without checkpoint.exploration_ckpt_path ran")
    played = []
    step_fn = agent_cls.player_step

    def recording(self, *a, **k):
        played.append(id(self.actor))
        return step_fn(self, *a, **k)

    with patched(agent_cls, "player_step", recording):
        tuned, tuned_steps, ft_wall_s, ft_counts = dreamer_through_cli(
            [*ft, f"checkpoint.exploration_ckpt_path={out['checkpoints'][-1]}"], f"{what} finetuning", ft_fwd, ft_bwd
        )
    ft_cfg = compose(ft_args)
    prefill = int(ft_cfg.algo.learning_starts) // int(ft_cfg.env.num_envs)
    task = id(tuned["agent"].actor)
    if len(set(played[:prefill])) != 1 or played[0] == task or played[prefill] != task:
        fail(f"{what} finetuning: the player's actor did not switch from the exploration actor to the task actor after iteration {prefill}")
    if tuned["gradient_steps"] != len(tuned_steps) or not tuned_steps or ft_counts["tensor_core"] or (not kernels and _launched(ft_counts)):
        fail(f"{what} finetuning: {tuned['gradient_steps']} gradient steps, LN-GRU {ft_counts}")
    finetuning = {"cuts": ft_cuts, "gradient_steps": tuned["gradient_steps"], "wall_s": ft_wall_s, "ln_gru_launches": ft_counts,
                  "player_switched_after_iteration": prefill}  # fmt: skip
    started = start_eval(tuned["checkpoints"][-1])  # runs beside the resume
    try:
        if ft_resume:
            ft_ckpt = next((c for c in tuned["checkpoints"] if os.path.basename(c) == f"ckpt_{ft_cfg.checkpoint.every}_0.ckpt"), None)
            if ft_ckpt is None:
                fail(f"{what} finetuning: no checkpoint at policy step {ft_cfg.checkpoint.every} ({tuned['checkpoints']})")
            saved_steps = int(load_checkpoint(ft_ckpt)["gradient_steps"])
            t0 = time.perf_counter()
            again, again_steps, _, again_counts = dreamer_through_cli(
                [*ft, f"checkpoint.exploration_ckpt_path={out['checkpoints'][-1]}", f"checkpoint.resume_from={ft_ckpt}"], f"{what} finetuning resume",
                ft_fwd, ft_bwd,
            )  # fmt: skip
            finetuning["resume_s"] = time.perf_counter() - t0
            if [s[0] for s in again_steps] != list(range(saved_steps + 1, tuned["gradient_steps"] + 1)) or not again_steps:
                fail(f"{what} finetuning resume: gradient steps {[s[0] for s in again_steps]} after the checkpoint's {saved_steps}")
            differ = _same_state(tuned["agent"].state_dict(), again["agent"].state_dict()) + _same_optimizers(tuned["optimizers"], again["optimizers"])
            if differ or (not kernels and _launched(again_counts)):
                fail(f"{what} finetuning resume: {len(differ)} tensors differ from the uninterrupted run, e.g. {differ[:4]}; LN-GRU {again_counts}")
            finetuning["resumed_from_gradient_step"] = saved_steps
            shutil.rmtree(again["log_dir"], ignore_errors=True)
            del again
    except BaseException:
        started[2].kill()
        raise
    finetuning["evaluation"] = finish_eval(started, tuned["test_reward"], f"{what} finetuning eval")
    shutil.rmtree(tuned["log_dir"], ignore_errors=True)
    return {"resume_s": resume_s, "finetuning": finetuning}


def phase_p2e_kernels():
    """(31) The LN-GRU entry points at P2E-DV3's shapes, D = 5120, H = 4096,
    f32 (the exp's precision): B = 16 (the dynamic scan), B = 1024 (the
    imaginations) and B = 4 (the player, whose plan splits D over a cluster
    of CTAs where the other two do not); every forward must stream
    (:func:`streaming_rows`; 5 repetitions of 4 calls at B = 1024, whose f32
    product is 129 GFLOP)."""
    import torch

    from sheeprl_tpu_torch.models.ln_gru import tensor_core_fits

    if tensor_core_fits(P2E_DEPTH, P2E_HIDDEN):
        fail("p2e kernels: tensor_core_fits takes H = 4096")
    shapes = ((P2E_BATCH, "dynamic scan"), (P2E_IMAGINED, "imagination"), (P2E_ENVS, "player"))
    return streaming_rows("p2e", P2E_DEPTH, P2E_HIDDEN, shapes, (torch.float32,), seed=7, reps={P2E_IMAGINED: (5, 4)})


def phase_p2e_training(log_root):
    """(32) ``exp=p2e_dv3_exploration env=dummy`` through the CLI at XL
    width, cut (``P2E_CUTS``) to 8 gradient steps of 64 + 30 forwards and 64
    backwards each, then its resume, ``eval``, and finetuning (``P2E_FT_CUTS``,
    DreamerV3's 64 + 15 forwards a step) with its ``eval`` (:func:`p2e_chain`)."""
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import DV3Agent

    result, out = p2e_chain("p2e training", P2E_ARGS, P2E_CUTS, P2E_FWD_BY_BATCH, P2E_BWD_BY_BATCH, P2E_TAGS, P2E_FT_ARGS, P2E_FT_CUTS,
                            P2E_FT_FWD_BY_BATCH, P2E_BWD_BY_BATCH, log_root, DV3Agent)  # fmt: skip
    return result, out


def phase_p2e_profile(agent, steps: int = 2):
    """(33) Where one P2E-DV3 exploration step's time goes at XL width
    (32-true, B = 16, T = 64, the trained agent; :func:`step_profile`)."""
    import torch

    from sheeprl_tpu_torch.algos.p2e_dv3 import p2e_dv3_exploration as p2e
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.utils.distribution import BatchGenerator

    dev = torch.device("cuda")
    cfg = compose(P2E_ARGS)
    step = p2e.make_train_step(agent, p2e.make_optimizers(agent, cfg), cfg)
    data = _vector_batch(P2E_SEQ, P2E_BATCH, 7, dev)
    rng = BatchGenerator.from_seed(0, dev)
    moments = [p2e.init_p2e_moments(agent.critics_cfg, dev)]

    def call():
        moments[0], _ = step(moments[0], data, rng, 0.02)

    return step_profile("p2e profile (XL, 32-true, B=16 T=64 horizon 15, H_rnn=4096)", call, steps, P2E_FWD_BY_BATCH, P2E_BWD_BY_BATCH)


def step_profile(what, call, steps, fwd_per_step, bwd_per_step, activities=("cpu", "cuda")):
    """Host wall per step of ``call`` (one gradient step) over ``steps``
    after a warm-up one, ending in a synchronize, then one profiled step:
    device busy, idle share, operations, the LN-GRU kernels' time and share
    of busy, peak memory, and with the CPU among ``activities`` the
    ``p2e/*`` and Dreamer stages (the host's events make the profile's
    reading slow: tens of seconds for 12k operations); the LN-GRU
    launches per step by batch must be ``fwd_per_step`` and
    ``bwd_per_step``, none on the tensor cores."""
    import torch

    call()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        call()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    prof = profiled(call, activities)
    kernels_ms, averages = {}, prof.key_averages()
    spans = ("p2e/", "dv3/", "dv2/", "dv1/")
    busy, ops, annotated = _busy(averages, 1, skip=spans, by_kernel=kernels_ms)
    if busy <= 0.0:
        fail(f"{what}: torch.profiler saw no device time")
    stages = {}
    for evt in averages:
        if evt.key.startswith(spans):
            us = getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0.0)
            side = "device_span_ms" if evt.device_type == torch.autograd.DeviceType.CUDA else "host_ms"
            stages.setdefault(evt.key, {})[side] = (us if side == "device_span_ms" else evt.cpu_time_total) / 1e3
    gru = {k: v for k, v in kernels_ms.items() if "ln_gru" in k}
    fwd_by_batch = {b: n / steps for b, n in counts["forward_by_batch"].items()}
    bwd_by_batch = {b: n / steps for b, n in counts["backward_by_batch"].items()}
    if fwd_by_batch != fwd_per_step or bwd_by_batch != bwd_per_step or counts["tensor_core"] != 0:
        fail(f"{what}: launches per step forward {fwd_by_batch} backward {bwd_by_batch} tensor core {counts['tensor_core']}")
    top = dict(sorted(kernels_ms.items(), key=lambda kv: -kv[1])[:8])
    result = {"host_wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy, "idle_share": max(0.0, 1.0 - busy / wall_ms),
              "device_ops_per_step": ops, "annotation_ranges_ms_per_step": annotated, "peak_gib": peak,
              "ln_gru_device_ms_per_step": gru, "ln_gru_share_of_busy": sum(gru.values()) / busy,
              "ln_gru_forward_per_step_by_batch": fwd_by_batch, "ln_gru_backward_per_step_by_batch": bwd_by_batch,
              "stages_per_step": stages, "top_device_ms_per_step": top}  # fmt: skip
    log(f"{what}: host wall {wall_ms:.2f} ms/step, device busy {busy:.2f} ms/step, idle share {result['idle_share']:.3f}, {ops:.0f} device "
        f"ops/step, peak {peak:.2f} GiB; LN-GRU {sum(gru.values()):.3f} ms/step ({100 * result['ln_gru_share_of_busy']:.1f}% of busy) "
        f"{json.dumps({k: round(v, 4) for k, v in gru.items()})}")  # fmt: skip
    log(f"{what}: stages {json.dumps({k: {s: round(v, 3) for s, v in d.items()} for k, d in stages.items()})}; top {json.dumps({k: round(v, 3) for k, v in top.items()})}")
    return result


def step_gaps(got, want, at=None):
    """A step's reading against another's, each (metrics, parameters at the
    start, at the end) -> (worst metric, worst leaf): each metric's |d| over atol 1e-4 +
    |ref|, each leaf's change gap over its norm; for the worst leaf, how
    many entries' changes differ, by how many ulps of ``want``'s value
    at most, the share of the gap's norm its largest entry carries and
    that entry's change on each side; with ``at``, that leaf's gap too."""
    import torch

    (gm, gs, gp), (wm, ws, wp) = got, want
    metric = {k: abs(gm[k] - ref) / (1e-4 / P2E_REF_TOL + abs(ref)) if math.isfinite(gm[k]) else math.inf for k, ref in wm.items()}
    leaf = {}
    for k in wp:
        g, w = (gp[k] - gs[k]).double(), (wp[k] - ws[k]).double()
        leaf[k] = ((g - w).norm() / w.norm()).item() if w.norm() > 0 else float(g.norm() > 0)
    mk, top = max(metric, key=metric.get), sorted(leaf, key=leaf.get, reverse=True)[:3]
    w, dg = wp[top[0]], (gp[top[0]] - gs[top[0]]).flatten()
    dw = (w - ws[top[0]]).flatten()
    d = (dg - dw).abs().double()
    ulps = d / (torch.nextafter(w.abs(), torch.tensor(math.inf)) - w.abs()).flatten().double()
    i = int(d.argmax())
    return {"metric": mk, "metric_gap": metric[mk], "leaf": top[0], "leaf_gap": leaf[top[0]], "reading": max(metric[mk], leaf[top[0]]),
            "leaf_entries_differ": int((d > 0).sum()), "leaf_entries": w.numel(), "leaf_max_ulps": float(ulps.max()),
            "leaf_top_entry_share": float(d[i] / d.norm()) if d[i] > 0 else 0.0, "leaf_top_entry_changes": [float(dg[i]), float(dw[i])],
            "next_leaves": {k: leaf[k] for k in top[1:]}} | ({"at": {at: leaf[at]}} if at else {})  # fmt: skip


def phase_p2e_reference(continuous: bool):
    """(34) One P2E-DV3 exploration step at DreamerV3-S widths in 32-true
    (B = 4, T = 16, horizon 15, the exp's ensemble of 8 and two exploration
    critics) on the card (its kernels) against the CPU (the plain
    versions), from the same seeded weights and batch, the card's draws
    recorded and replayed on the CPU, the weights moved by
    ``P2E_REF_PERTURB`` times a seeded normal: every metric within rtol
    ``P2E_REF_TOL`` + atol 1e-4, every parameter leaf's change within
    ``P2E_REF_TOL`` of its norm. The card's step from weights one f32 ulp
    away is reported; each of ``P2E_FAULTS`` planted on the card must read
    above the bound. The same two readings at the seeded weights (no move)
    are reported, unheld, with the one-ulp step's gap on the leaf where
    the card and the CPU part most."""
    import torch

    from sheeprl_tpu_torch.algos.p2e_dv3 import p2e_dv3_exploration as p2e
    from sheeprl_tpu_torch.algos.p2e_dv3.agent import build_agent, ensemble_apply
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.serve.spaces import Box, DictSpace
    from sheeprl_tpu_torch.utils.distribution import BatchGenerator

    what = f"p2e reference ({'continuous' if continuous else 'discrete'})"
    args = ["exp=p2e_dv3_exploration", "env=dummy", *P2E_S_WIDTHS, "fabric.precision=32-true"]
    args += ["env.id=continuous_dummy", "env.wrapper.id=continuous_dummy"] if continuous else []
    space = DictSpace({"state": Box((10,), "float32", -20.0, 20.0)})
    draws = []
    real_update, real_reward = p2e.update_ensemble, p2e.intrinsic_reward

    def unbiased(ensemble, trajectories, actions, multiplier):
        with torch.no_grad():
            preds = ensemble_apply(ensemble, torch.cat([trajectories.detach(), actions.detach()], -1)).float()
            return preds.var(0).mean(-1, keepdim=True) * multiplier

    pending = []

    class Later:
        """An optimizer whose step waits for the intrinsic reward."""

        def __init__(self, opt):
            self.opt = opt

        def zero_grad(self, set_to_none=True):
            self.opt.zero_grad(set_to_none=set_to_none)

        def step(self):
            pending.append(self.opt)

    def late_update(ensemble, optimizer, *rest):
        return real_update(ensemble, Later(optimizer), *rest)

    def reward_then_update(*a):
        reward = real_reward(*a)
        while pending:
            pending.pop().step()
        return reward

    plants = {
        P2E_FAULTS[0]: [("intrinsic_reward", unbiased)],
        P2E_FAULTS[1]: [("update_ensemble", late_update), ("intrinsic_reward", reward_then_update)],
        P2E_FAULTS[2]: [("critic_weights", lambda critics: {n: c["weight"] for n, c in critics.items()})],
    }

    def step(where, fault=None, perturb=P2E_REF_PERTURB, draws=draws):
        cfg = compose(args)
        agent = build_agent((2,), continuous, cfg, space, device=where, seed=3)
        gen = torch.Generator().manual_seed(4)
        with torch.no_grad():
            for p in agent.parameters():
                p.add_((perturb * torch.randn(p.shape, generator=gen)).to(p.device))
                if fault == "nudge":
                    p.mul_(1 + 2.0**-23)
        start = {k: v.detach().cpu().clone() for k, v in agent.state_dict().items()}
        rng = ReplayedDraws(draws) if draws else RecordedDraws(BatchGenerator.from_seed(0, torch.device(where)))
        with ExitStack() as stack:
            for name, value in plants.get(fault, []):
                stack.enter_context(patched(p2e, name, value))
            train_step = p2e.make_train_step(agent, p2e.make_optimizers(agent, cfg), cfg)
            moments, metrics = train_step(p2e.init_p2e_moments(agent.critics_cfg, torch.device(where)),
                                          _vector_batch(16, 4, 11, torch.device(where), 2, continuous), rng, 1.0)  # fmt: skip
        if isinstance(rng, RecordedDraws):
            draws.extend(rng.draws)
        elif rng.used != len(draws):
            fail(f"{what}: the replaying step drew {rng.used} times, the recording one {len(draws)}")
        out = {k: float(v) for k, v in metrics.items()}
        out.update({f"moments/task/{k}": float(v) for k, v in moments["task"].items()})
        out.update({f"moments/{n}/{k}": float(v) for n, m in moments["exploration"].items() for k, v in m.items()})
        return out, start, {k: v.detach().cpu() for k, v in agent.state_dict().items()}

    card = step("cuda")
    cpu = step("cpu")
    if any(not torch.equal(card[1][k], cpu[1][k]) for k in cpu[1]):
        fail(f"{what}: the card's agent does not start from the CPU's weights")
    held = step_gaps(card, cpu)
    if held["reading"] > P2E_REF_TOL:
        fail(f"{what}: card vs CPU {held} (bound {P2E_REF_TOL})")
    floor = step_gaps(step("cuda", "nudge"), card)
    faults = {}
    for fault in P2E_FAULTS:
        faults[fault] = step_gaps(step("cuda", fault), cpu)
        if faults[fault]["reading"] <= P2E_REF_TOL:
            fail(f"{what}: the step with {fault} reads {faults[fault]} against the CPU, within the bound {P2E_REF_TOL}")
    seeded_draws = []
    seeded_card = step("cuda", perturb=0.0, draws=seeded_draws)
    seeded = {"card_vs_cpu": step_gaps(seeded_card, step("cpu", perturb=0.0, draws=seeded_draws))}
    seeded["one_ulp_nudge"] = step_gaps(step("cuda", "nudge", perturb=0.0, draws=seeded_draws), seeded_card, at=seeded["card_vs_cpu"]["leaf"])
    log(f"{what}: one DV3-S P2E exploration step (B=4 T=16), card (kernels) vs CPU (plain), {len(draws)} replayed draws: worst metric "
        f"{held['metric']} {held['metric_gap']:.3g}, worst leaf {held['leaf']} {held['leaf_gap']:.3g} (bound {P2E_REF_TOL}); the card from "
        f"weights one ulp away {json.dumps(floor)}; planted faults {json.dumps({k: v['reading'] for k, v in faults.items()})}; at the "
        f"seeded weights (not held) {json.dumps(seeded)}")  # fmt: skip
    return {"held": held, "one_ulp_nudge": floor, "planted_faults": faults, "seeded_weights": seeded, "metrics_card": card[0],
            "metrics_cpu": cpu[0], "bound": P2E_REF_TOL}  # fmt: skip


def phase_p2e_dv2(log_root):
    """(35-36) P2E-DV2 at its exp's widths: the LN-GRU entry points at D =
    800, H = 400, f32, B = 16 (the dynamic scan), B = 800 (the
    imaginations) and B = 4 (the player), every forward streaming (:func:`streaming_rows`); then
    ``exp=p2e_dv2_exploration env=dummy`` through the CLI (``P2E2_CUTS``,
    50 + 30 forwards and 50 + 30 backwards a step), resumed, evaluated, and
    finetuned from (:func:`p2e_chain`; DreamerV2's 50 + 15 each a step);
    then the trained agent's exploration step profiled (:func:`step_profile`)."""
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v2.agent import DV2Agent
    from sheeprl_tpu_torch.algos.p2e_dv2 import p2e_dv2_exploration as p2e
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.models.ln_gru import tensor_core_fits
    from sheeprl_tpu_torch.utils.distribution import BatchGenerator

    if tensor_core_fits(P2E2_DEPTH, P2E2_HIDDEN):
        fail("p2e dv2 kernels: tensor_core_fits takes H = 400")
    shapes = ((P2E2_BATCH, "dynamic scan"), (P2E2_IMAGINED, "imagination"), (P2E_ENVS, "player"))
    rows = streaming_rows("p2e dv2", P2E2_DEPTH, P2E2_HIDDEN, shapes, (torch.float32,), seed=9)
    result, out = p2e_chain("p2e dv2 training", P2E2_ARGS, P2E2_CUTS, P2E2_FWD_BY_BATCH, P2E2_BWD_BY_BATCH, P2E2_TAGS, P2E2_FT_ARGS,
                            P2E2_FT_CUTS, P2E2_FT_BY_BATCH, P2E2_FT_BY_BATCH, log_root, DV2Agent)  # fmt: skip
    shutil.rmtree(out["log_dir"], ignore_errors=True)
    cfg = compose(P2E2_ARGS)
    dev = torch.device("cuda")
    step = p2e.make_train_step(out["agent"], p2e.make_optimizers(out["agent"], cfg), cfg)
    data, rng = _vector_batch(P2E2_SEQ, P2E2_BATCH, 7, dev), BatchGenerator.from_seed(0, dev)
    result["profile"] = step_profile("p2e dv2 profile (32-true, B=16 T=50 horizon 15, H_rnn=400)", lambda: step(data, rng), 3,
                                     P2E2_FWD_BY_BATCH, P2E2_BWD_BY_BATCH, ("cuda",))  # fmt: skip
    return rows, result


# P2E-DV1 and SAC-AE (phases 37-41): the last single-process trainers.
# Neither launches an LN-GRU kernel (DreamerV1's cell is flax's plain GRU;
# SAC-AE has no recurrent cell): every count stays at 0.
#
# P2E-DV1 (exp=p2e_dv1_exploration, then exp=p2e_dv1_finetuning):
# DreamerV1 at recurrent state 400, stochastic 60, dense 400 x 4, an
# ensemble of 10 x 400 x 4 predicting the next embedding, 32-true, batch 50
# x 50, horizon 15, 4 envs. Only the counters are cut, as phase 25 cuts
# DreamerV1's: 50 prefill iterations, then the recipe's ratio (0.1) takes 8
# gradient steps by policy step 288, 4 by the checkpoint at 240.
P2E1_CUTS = {"algo.learning_starts": "200 (from 5000)", "algo.total_steps": "288 (from 5000000; 8 gradient steps)",
             "checkpoint.every": "240 (from 100000)", "metric.log_every": "96 (from 5000)"}  # fmt: skip
P2E1_ARGS = ["exp=p2e_dv1_exploration", "env=dummy", "algo.learning_starts=200", "algo.total_steps=288", "checkpoint.every=240",
             "metric.log_every=96", "checkpoint.save_last=True"]  # fmt: skip
P2E1_FT_CUTS = {"algo.learning_starts": "200 (from 5000)", "algo.total_steps": "288 (from 1000000; 8 gradient steps)",
                "checkpoint.every": "240 (from 100000)", "metric.log_every": "96 (from 5000)"}  # fmt: skip
P2E1_FT_ARGS = ["exp=p2e_dv1_finetuning", "env=dummy", "algo.learning_starts=200", "algo.total_steps=288", "checkpoint.every=240",
                "metric.log_every=96", "checkpoint.save_last=True"]  # fmt: skip
P2E1_TAGS = ("Loss/world_model_loss", "Loss/ensemble_loss", "Loss/policy_loss_exploration", "Loss/value_loss_exploration",
             "Loss/policy_loss_task", "Loss/value_loss_task", "Rewards/intrinsic", "Grads/ensemble", "Grads/critic_exploration",
             "Params/exploration_amount")  # fmt: skip
P2E1_BATCH, P2E1_SEQ = 50, 50
# The card's exploration step against the CPU's at the recipe's widths, B = 4
# and T = 16, every weight moved by P2E_REF_PERTURB, held to P2E_REF_TOL; each
# planted fault must read above it.
P2E1_FAULTS = ("unbiased variance in the intrinsic reward", "exploration critic trained on the task reward")
# SAC-AE (exp=sac_ae env=dummy env.id=continuous_dummy): the recipe's
# widths (64 x 64 x 3 pixels, four 3x3 convolutions of 32 x 16 = 512
# channels, a 25 x 25 x 512 grid, fc 320000 -> 64, hidden 1024), batch 128,
# 4 envs, 32-true. Cut: 2 prefill iterations and 2 more, 19 gradient steps
# (11 at the first train call); the buffer to 1024 rows (from 1000000); the
# target EMAs' and the decoder's cadences to 3 and 5 (from 2 and 1), so that
# with the actor's 2 the 19 steps meet every combination of the three flags
# (the recipe's cadences give two: all on, the decoder alone).
SAC_AE_CUTS = {"algo.learning_starts": "8 (from 1000)", "algo.total_steps": "16 (from 1000000; 19 gradient steps)",
               "buffer.size": "1024 (from 1000000)", "checkpoint.every": "12 (from 50000)", "metric.log_every": "8 (from 5000)",
               "algo.critic.per_rank_target_network_update_freq": "3 (from 2)", "algo.decoder.per_rank_update_freq": "5 (from 1)"}  # fmt: skip
SAC_AE_ARGS = ["exp=sac_ae", "env=dummy", "env.id=continuous_dummy", "algo.learning_starts=8", "algo.total_steps=16", "buffer.size=1024",
               "checkpoint.every=12", "metric.log_every=8", "algo.critic.per_rank_target_network_update_freq=3",
               "algo.decoder.per_rank_update_freq=5", "checkpoint.save_last=True"]  # fmt: skip
SAC_AE_FAULTS = ("actor features not detached (the actor's Adam over the encoder too)", "encoder EMA at the critics' tau",
                 "pixels' target at 8 bits")  # fmt: skip
SAC_AE_REF_BATCH = 8  # the card-against-CPU step's batch (the CPU takes a full-width step at B = 128 in minutes)
# SAC-AE's step is not held to 2e-3 per leaf: on the CPU at the recipe's
# widths and B = 8 the step from weights one f32 ulp away reads 0.09 on its
# worst leaf's change (a decoder bias, an encoder convolution), and its Adam
# moments 7e-3. The autoencoder's gradient reaches the encoder through the
# LayerNorm as a residual four decades under the critic's (conv 0's median
# entry 2.4e-6 against 1.4e-2), so rounding moves it by a percent, and
# Adam's first step turns each entry's sign into a whole learning rate.
# The leaves are held to SAC_AE_REF_LEAF_TOL, between that floor and the
# planted faults (0.80, 1.15 and 1.76 on the CPU), the metrics to 2e-3. The
# seeded weights are not moved: moved by 0.02 they put the 8-bit target
# fault at 0.13, no further than the floor.
SAC_AE_REF_LEAF_TOL = 0.4


def sac_ae_conv_flops(cfg, batch, flags):
    """The convolutions' FLOPs of one SAC-AE gradient step from the shapes
    (2 per multiply-add; ``fc`` and the MLPs left out). Per image, the
    encoder's forward sums ``2 * Ho * Wo * Cout * Cin * 9`` over its four
    convolutions (64 -> 31 -> 29 -> 27 -> 25) and the decoder's
    ``2 * Hin * Win * Cin * Cout * 9`` over its four transposed ones (25 ->
    27 -> 29 -> 31 -> 64). A pass with its backward costs three forwards (the
    input's gradient and the weights'), but the encoder's first convolution
    takes no input gradient. The step: the target's two encoder forwards
    (online and target encoder) and the critic's encoder forward and
    backward; with ``update_actor`` one more encoder forward; with
    ``update_decoder`` the encoder's and the decoder's forward and backward.
    Returns (total FLOPs, the count as text)."""
    c, side = 32 * int(cfg.algo.encoder.cnn_channels_multiplier), 64
    sizes = [side]
    for s in (2, 1, 1, 1):
        sizes.append((sizes[-1] - 3) // s + 1)
    cins = [3, c, c, c]
    enc = [2 * batch * sizes[i + 1] ** 2 * c * cins[i] * 9 for i in range(4)]
    dec_in = sizes[4:0:-1]  # 25, 27, 29, 31
    couts = [c, c, c, 3]
    dec = [2 * batch * dec_in[i] ** 2 * c * couts[i] * 9 for i in range(4)]
    enc_fwd, dec_fwd = sum(enc), sum(dec)
    enc_train, dec_train = 3 * enc_fwd - enc[0], 3 * dec_fwd
    update_actor, _, update_decoder = flags
    total = 2 * enc_fwd + enc_train + (enc_fwd if update_actor else 0) + ((enc_train + dec_train) if update_decoder else 0)
    text = (f"encoder forward {enc_fwd / 1e12:.4f} TFLOP (layers {[round(f / 1e9, 2) for f in enc]} GFLOP), decoder forward "
            f"{dec_fwd / 1e12:.4f} TFLOP (layers {[round(f / 1e9, 2) for f in dec]} GFLOP) at B = {batch}; step = 2 encoder forwards (target) + "
            f"3 - first layer (critic){' + 1 (actor)' if update_actor else ''}{' + 3 - first layer (autoencoder) + 3 decoder (autoencoder)' if update_decoder else ''}"
            f" = {total / 1e12:.4f} TFLOP")  # fmt: skip
    return total, text


def phase_p2e_dv1(log_root):
    """(37-38) ``exp=p2e_dv1_exploration env=dummy`` through the CLI at the
    recipe's widths (``P2E1_CUTS``), no LN-GRU launch at all, resumed from
    its mid-run checkpoint bit for bit, evaluated; finetuning
    (``P2E1_FT_CUTS``) from its checkpoint, the exploration actor playing up
    to ``learning_starts``, resumed bit for bit and evaluated
    (:func:`p2e_chain`); then the trained agent's exploration step profiled
    (:func:`step_profile`, B = 50, T = 50)."""
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v1.agent import DV1Agent
    from sheeprl_tpu_torch.algos.p2e_dv1 import p2e_dv1_exploration as p2e
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.utils.distribution import BatchGenerator

    result, out = p2e_chain("p2e dv1 training", P2E1_ARGS, P2E1_CUTS, {}, {}, P2E1_TAGS, P2E1_FT_ARGS, P2E1_FT_CUTS, {}, {}, log_root, DV1Agent,
                            kernels=False, ft_resume=True)  # fmt: skip
    shutil.rmtree(out["log_dir"], ignore_errors=True)
    cfg = compose(P2E1_ARGS)
    dev = torch.device("cuda")
    step = p2e.make_train_step(out["agent"], p2e.make_optimizers(out["agent"], cfg), cfg)
    data, rng = _vector_batch(P2E1_SEQ, P2E1_BATCH, 7, dev), BatchGenerator.from_seed(0, dev)
    zero_counts()
    result["profile"] = step_profile("p2e dv1 profile (32-true, B=50 T=50 horizon 15, H_rnn=400, ensembles 10 x 400 x 4)", lambda: step(data, rng), 3,
                                     {}, {}, ("cuda",))  # fmt: skip
    if _launched(read_counts()):
        fail(f"p2e dv1 profile: LN-GRU launches {read_counts()}")
    return result


def phase_sac_ae(log_root):
    """(39) ``exp=sac_ae env=dummy env.id=continuous_dummy`` through the CLI
    at the recipe's widths (``SAC_AE_CUTS``): no LN-GRU launch, the expected
    gradient steps, every combination of the cadence flags met, each step's
    losses those of the stages that ran, the JAX package's tags with
    ``Loss/reconstruction_loss``, the test reward; resumed from its
    checkpoint at policy step 12, every parameter and Adam state bit for bit
    the uninterrupted run's at the end; ``eval``."""
    import itertools

    from sheeprl_tpu_torch.algos.sac_ae import sac_ae
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.utils.logger import read_scalars

    flags = []
    cadence = sac_ae.cadence

    def recording(cfg, step):
        flags.append(cadence(cfg, step))
        return flags[-1]

    with patched(sac_ae, "cadence", recording):
        out, host = offpolicy_through_cli(SAC_AE_ARGS, SAC_AE_CUTS, "sac_ae", log_root)
    cfg = compose(SAC_AE_ARGS)
    if set(flags) != set(itertools.product([True, False], repeat=3)) or len(flags) != out["gradient_steps"]:
        fail(f"sac_ae: cadence flags {sorted(set(flags))} over {len(flags)} of {out['gradient_steps']} gradient steps")
    last = int(out["policy_steps"])
    if last not in [s for s, _ in read_scalars(out["log_dir"]).get("Loss/reconstruction_loss", [])]:
        fail("sac_ae: Loss/reconstruction_loss not logged at the last log point")
    grid = 25 * 25 * 32 * int(cfg.algo.encoder.cnn_channels_multiplier)  # 320000 at the recipe's 512 channels
    if tuple(out["agent"].encoder.cnn_encoder.fc.weight.shape) != (int(cfg.algo.encoder.features_dim), grid):
        fail(f"sac_ae: fc {tuple(out['agent'].encoder.cnn_encoder.fc.weight.shape)}, not {grid} -> {cfg.algo.encoder.features_dim}")
    [ckpt] = [c for c in out["checkpoints"] if os.path.basename(c) == "ckpt_12_0.ckpt"]
    started = start_eval(out["checkpoints"][-1])
    try:
        t0 = time.perf_counter()
        again, resumed = offpolicy_through_cli([*SAC_AE_ARGS, f"checkpoint.resume_from={ckpt}"], SAC_AE_CUTS, "sac_ae resume", log_root)
        resume_s = time.perf_counter() - t0
        (pa, aa), (pb, ab) = _state_of(out), _state_of(again)
        differ = [k for k in pa if not torch_equal_bits(pa[k], pb[k])] + [k for k in aa if not torch_equal_bits(aa[k], ab[k])]
        if differ or pa.keys() != pb.keys() or aa.keys() != ab.keys() or again["gradient_steps"] != out["gradient_steps"]:
            fail(f"sac_ae resume: the resumed run ends off the uninterrupted one: {differ[:5]}")
    except BaseException:
        started[2].kill()
        raise
    evaluation = finish_eval(started, out["test_reward"], "sac_ae eval")
    log(f"sac_ae resume: from {os.path.basename(ckpt)} the run ends on the uninterrupted run's {len(pa)} parameter and {len(aa)} Adam tensors "
        f"bit for bit, in {resume_s:.1f} s; flags met {len(set(flags))} of 8 combinations over {len(flags)} gradient steps")  # fmt: skip
    shutil.rmtree(out["log_dir"], ignore_errors=True)
    shutil.rmtree(again["log_dir"], ignore_errors=True)
    return {"host": host, "resume": {**resumed, "wall_s": resume_s, "tensors_bit_for_bit": len(pa) + len(aa)}, "evaluation": evaluation,
            "flag_combinations": len(set(flags)), "seconds_per_gradient_step": host["wall_s"] / host["gradient_steps"]}  # fmt: skip


def _sac_ae_setup(where, batch, seed=7):
    """A recipe-width SAC-AE agent on ``where`` (initialised on the CPU from
    ``seed``), its optimizers and config, at ``per_rank_batch_size`` ``batch``."""
    from sheeprl_tpu_torch.algos.sac_ae.agent import build_agent
    from sheeprl_tpu_torch.algos.sac_ae.sac_ae import make_optimizers
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.envs.dummy import ContinuousDummyEnv

    cfg = compose(["exp=sac_ae", "env=dummy", "env.id=continuous_dummy", f"algo.per_rank_batch_size={batch}", f"device={where}"])
    cfg.env.screen_size = 64
    env = ContinuousDummyEnv(action_dim=int(cfg.env.wrapper.action_dim))
    agent = build_agent(cfg, env.observation_space, env.action_space, device=where, seed=seed)
    return cfg, agent, make_optimizers(agent, cfg)


def _sac_ae_batch(batch, seed, dev):
    """A replay batch at the dummy env's shapes (64 x 64 x 3 uint8 pixels,
    2 actions) and one step's draws: the normals and the pixels' uniforms."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    data = {"actions": rng.uniform(-1, 1, (batch, 2)), "rewards": rng.normal(size=(batch, 1)), "terminated": rng.random((batch, 1)) < 0.05}
    data = {k: torch.from_numpy(v.astype(np.float32)).to(dev) for k, v in data.items()}
    for k in ("rgb", "next_rgb"):
        data[k] = torch.from_numpy(rng.integers(0, 256, (batch, 64, 64, 3), dtype=np.uint8)).to(dev)
    normals = torch.from_numpy(rng.normal(size=(2, batch, 2)).astype(np.float32)).to(dev)
    uniforms = {"rgb": torch.from_numpy(rng.random((batch, 64, 64, 3)).astype(np.float32)).to(dev)}
    return data, normals, uniforms


# Kernel names of cuDNN's convolutions: direct and implicit-GEMM ones, and the FFT algorithms' transforms and complex products.
CONV_KERNELS = ("conv", "cudnn", "dgrad", "wgrad", "fprop", "implicit", "winograd", "fft", "cf32")


def phase_sac_ae_profile(steps: int = 3):
    """(40) One SAC-AE gradient step at the recipe's widths (B = 128, 512
    channels, 32-true, TF32 off) with every cadence flag on, and one with
    none: host wall per step over ``steps`` after a warm-up, then one step
    through :func:`profiled`: device busy, idle share, operations, peak
    memory, the top device kernels, the convolutions' kernels (cuDNN's,
    named) and their time, and the rate of the convolutions' FLOPs reckoned
    as direct convolutions (:func:`sac_ae_conv_flops`) over that time and
    over busy (cuDNN's FFT algorithms do fewer operations, so the first can
    exceed the f32 peak); no LN-GRU launch."""
    import torch

    from sheeprl_tpu_torch.algos.sac_ae.sac_ae import make_train_step

    dev = torch.device("cuda")
    cfg, agent, optimizers = _sac_ae_setup("cuda", 128)
    step = make_train_step(agent, optimizers, cfg)
    data, normals, uniforms = _sac_ae_batch(128, 21, dev)
    out = {}
    for name, flags in (("all_flags", (True, True, True)), ("no_flags", (False, False, False))):

        def call():
            step(data, normals, uniforms, *flags)

        call()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        for _ in range(steps):
            call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / steps * 1e3
        peak = torch.cuda.max_memory_allocated() / 2**30
        prof = profiled(call, ("cuda",))
        if _launched(read_counts()):
            fail(f"sac_ae profile: LN-GRU launches {read_counts()}")
        kernels_ms = {}
        busy, ops, annotated = _busy(prof.key_averages(), 1, skip=("sac_ae/",), by_kernel=kernels_ms)
        if busy <= 0.0:
            fail("sac_ae profile: torch.profiler saw no device time")
        conv_ms = {k: v for k, v in kernels_ms.items() if any(t in k.lower() for t in CONV_KERNELS)}
        flops, count = sac_ae_conv_flops(cfg, 128, flags)
        conv_total = sum(conv_ms.values())
        top = dict(sorted(kernels_ms.items(), key=lambda kv: -kv[1])[:10])
        out[name] = {"host_wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy, "idle_share": max(0.0, 1.0 - busy / wall_ms),
                     "device_ops_per_step": ops, "annotation_ranges_ms_per_step": annotated, "peak_gib": peak, "top_device_ms_per_step": top,
                     "conv_kernels_ms_per_step": conv_ms, "conv_ms_per_step": conv_total, "conv_tflop_per_step": flops / 1e12,
                     "conv_flop_count": count, "conv_tflops_over_conv_time": flops / 1e9 / conv_total if conv_total else None,
                     "conv_tflops_over_busy": flops / 1e9 / busy, "f32_peak_tflops": PEAK_OPS_PER_S["float32"] / 1e12}  # fmt: skip
        log(f"sac_ae profile ({name}: actor, EMA, decoder = {flags}): host wall {wall_ms:.2f} ms/step, device busy {busy:.2f} ms/step, idle "
            f"{out[name]['idle_share']:.3f}, {ops:.0f} device ops/step, peak {peak:.2f} GiB; convolutions {conv_total:.2f} ms over "
            f"{len(conv_ms)} kernels, {count}: {out[name]['conv_tflops_over_busy']:.1f} TFLOP/s over busy, "
            f"{out[name]['conv_tflops_over_conv_time'] or float('nan'):.1f} over the convolutions' time (f32 peak "
            f"{PEAK_OPS_PER_S['float32'] / 1e12:.0f}); no LN-GRU launch")  # fmt: skip
        log(f"sac_ae profile ({name}): top {json.dumps({k: round(v, 3) for k, v in top.items()})}")
    return out


def _nudged(agent, perturb, nudge):
    import torch

    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for p in agent.parameters():
            p.add_((perturb * torch.randn(p.shape, generator=gen)).to(p.device))
            if nudge:
                p.mul_(1 + 2.0**-23)


def _card_cpu(what, step, faults, leaf_tol=P2E_REF_TOL):
    """A step on the card against the same step on the CPU (``step(where,
    fault)`` -> (metrics, parameters at the start, at the end)): every
    metric held to ``P2E_REF_TOL`` and every leaf to ``leaf_tol``
    (:func:`step_gaps`); the card from weights one ulp away reported; each
    planted fault must read above a bound."""
    import torch

    def over(g):  # > 1: outside the bounds
        return max(g["metric_gap"] / P2E_REF_TOL, g["leaf_gap"] / leaf_tol)

    card, cpu = step("cuda"), step("cpu")
    if any(not torch.equal(card[1][k], cpu[1][k]) for k in cpu[1]):
        fail(f"{what}: the card's agent does not start from the CPU's weights")
    held = step_gaps(card, cpu)
    if over(held) > 1:
        fail(f"{what}: card vs CPU {held} (bounds: metrics {P2E_REF_TOL}, leaves {leaf_tol})")
    floor = step_gaps(step("cuda", "nudge"), card)
    readings = {}
    for fault in faults:
        readings[fault] = step_gaps(step("cuda", fault), cpu)
        if over(readings[fault]) <= 1:
            fail(f"{what}: the step with {fault} reads {readings[fault]} against the CPU, within the bounds")
    log(f"{what}: card vs CPU worst metric {held['metric']} {held['metric_gap']:.3g} (bound {P2E_REF_TOL}), worst leaf {held['leaf']} "
        f"{held['leaf_gap']:.3g} (bound {leaf_tol}); the card from weights one ulp away: metric {floor['metric_gap']:.3g}, leaf "
        f"{floor['leaf_gap']:.3g} ({floor['leaf']}); planted faults {json.dumps({k: v['reading'] for k, v in readings.items()})}")  # fmt: skip
    return {"held": held, "one_ulp_nudge": floor, "planted_faults": readings, "metrics_card": card[0], "metrics_cpu": cpu[0],
            "bounds": {"metrics": P2E_REF_TOL, "leaves": leaf_tol}}  # fmt: skip


def phase_new_reference():
    """(41) Card against CPU, one step of each new trainer from the same
    weights and the same draws: P2E-DV1's exploration step at the recipe's
    widths (B = 4, T = 16; the weights moved by ``P2E_REF_PERTURB`` times a
    seeded normal; the card's draws recorded and replayed on the CPU) with
    ``P2E1_FAULTS``, held to 2e-3; SAC-AE's step with every cadence flag on
    at the recipe's widths and B = ``SAC_AE_REF_BATCH`` (the seeded weights,
    numpy-seeded draws), its Adam moments among the leaves, with
    ``SAC_AE_FAULTS``, its leaves held to ``SAC_AE_REF_LEAF_TOL``
    (:func:`_card_cpu`)."""
    import torch

    from sheeprl_tpu_torch.algos.p2e_dv1 import p2e_dv1_exploration as p2e
    from sheeprl_tpu_torch.algos.p2e_dv1.agent import build_agent as build_p2e_dv1
    from sheeprl_tpu_torch.algos.p2e_dv3.agent import ensemble_apply
    from sheeprl_tpu_torch.algos.sac_ae import sac_ae
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.serve.spaces import Box, DictSpace
    from sheeprl_tpu_torch.utils.distribution import BatchGenerator

    space = DictSpace({"state": Box((10,), "float32", -20.0, 20.0)})
    draws = []

    def unbiased(ensemble, trajectories, actions, multiplier):
        with torch.no_grad():
            preds = ensemble_apply(ensemble, torch.cat([trajectories.detach(), actions.detach()], -1)).float()
            return preds.var(0).mean(-1, keepdim=True) * multiplier

    def p2e_step(where, fault=None):
        cfg = compose(["exp=p2e_dv1_exploration", "env=dummy", f"device={where}"])
        agent = build_p2e_dv1((2,), False, cfg, space, device=where, seed=3)
        _nudged(agent, P2E_REF_PERTURB, fault == "nudge")
        start = {k: v.detach().cpu().clone() for k, v in agent.state_dict().items()}
        rng = ReplayedDraws(draws) if draws else RecordedDraws(BatchGenerator.from_seed(0, torch.device(where)))
        plant = {P2E1_FAULTS[0]: unbiased, P2E1_FAULTS[1]: lambda ens, traj, act, mult: agent.world_model.reward(traj).float()}.get(fault)
        with patched(p2e, "intrinsic_reward", plant) if plant else ExitStack():
            metrics = p2e.make_train_step(agent, p2e.make_optimizers(agent, cfg), cfg)(_vector_batch(16, 4, 11, torch.device(where), 2), rng)
        if isinstance(rng, RecordedDraws):
            draws.extend(rng.draws)
        elif rng.used != len(draws):
            fail(f"p2e dv1 reference: the replaying step drew {rng.used} times, the recording one {len(draws)}")
        return {k: float(v.detach()) for k, v in metrics.items()}, start, {k: v.detach().cpu() for k, v in agent.state_dict().items()}

    def sac_ae_step(where, fault=None):
        cfg, agent, optimizers = _sac_ae_setup(where, SAC_AE_REF_BATCH)
        _nudged(agent, 0.0, fault == "nudge")
        start = {k: v.detach().cpu().clone() for k, v in agent.state_dict().items()}
        with ExitStack() as stack:
            if fault == SAC_AE_FAULTS[0]:
                stack.enter_context(patched(sac_ae, "actor_features", lambda agent, obs: agent.encoder(obs)))
                optimizers["actor"] = sac_ae.build_optimizer([*agent.actor.parameters(), *agent.encoder.parameters()], cfg.algo.actor.optimizer)
            elif fault == SAC_AE_FAULTS[1]:
                agent.encoder_tau = agent.tau
            elif fault == SAC_AE_FAULTS[2]:
                stack.enter_context(patched(sac_ae, "RECONSTRUCTION_BITS", 8))
            data, normals, uniforms = _sac_ae_batch(SAC_AE_REF_BATCH, 13, torch.device(where))
            metrics = sac_ae.make_train_step(agent, optimizers, cfg)(data, normals, uniforms, True, True, True)
        end = {k: v.detach().cpu() for k, v in agent.state_dict().items()}
        names = {id(p): n for n, p in agent.named_parameters()}
        for name, opt in optimizers.items():
            for p in opt.param_groups[0]["params"]:
                for m in ("exp_avg", "exp_avg_sq"):
                    if m in opt.state[p]:
                        key = f"adam/{name}/{names[id(p)]}/{m}"
                        end[key], start[key] = opt.state[p][m].detach().cpu(), torch.zeros(p.shape)
        return {k: float(v) for k, v in metrics.items()}, start, end

    return {"p2e_dv1": _card_cpu("p2e dv1 reference (recipe widths, B=4 T=16)", p2e_step, P2E1_FAULTS),
            "sac_ae": _card_cpu(f"sac_ae reference (recipe widths, B={SAC_AE_REF_BATCH}, every flag on, seeded weights)", sac_ae_step, SAC_AE_FAULTS,
                                SAC_AE_REF_LEAF_TOL)}  # fmt: skip


def phases_37_41(workdir):
    """Phases 37-41 (they run alone too, after ``kernels.build()`` or not:
    none of their paths launches a kernel)."""
    t0 = time.perf_counter()
    p2e_dv1 = phase_p2e_dv1(workdir)
    sac_ae = phase_sac_ae(workdir)
    sac_ae_profile = phase_sac_ae_profile()
    new_reference = phase_new_reference()
    took = time.perf_counter() - t0
    log(f"p2e_dv1, sac_ae: phases 37-41 took {took:.1f} s")
    return {"p2e_dv1": p2e_dv1, "sac_ae": sac_ae, "sac_ae_profile": sac_ae_profile, "new_reference": new_reference, "phases_37_41_s": took}


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

    phase_s = time_phases(globals())
    card = nvidia_smi()
    log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    built = kernels.build()
    log(f"build: {built} in {time.perf_counter() - t0:.2f} s")
    for name in kernels.SOURCES:
        for line in kernels.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas ({name}): {line.strip()}")

    rows = phase_kernels()
    threshold = phase_threshold()
    bwd_rows = phase_backward()
    cell_grad = phase_cell_grad()
    workdir = os.path.join(str(kernels.BUILD_DIR), f"smoke-{os.getpid()}")
    os.makedirs(workdir, exist_ok=True)
    try:
        serving, path = phase_serving(workdir)
        step_profile = phase_step_profile(path)
        worst = phase_reference(path)
        training, agent, cfg = phase_training(workdir)
        train_profile = phase_train_profile(agent, cfg)
        del agent
        torch.cuda.empty_cache()
        graph_discrete = phase_graph_vs_eager("discrete")
        fused_training = phase_fused_training(workdir)
        train_reference = phase_train_reference()
        continuous, cont_out, cont_steps, wcfg = phase_continuous_training(workdir)
        continuous_profile = phase_train_profile(cont_out["agent"], wcfg, bwd_per_step=WALKER_BWD_PER_STEP, what="continuous step profile")
        resume = phase_resume(cont_out, cont_steps, workdir)
        continuous_serving = phase_export_serve(cont_out["checkpoints"][-1], workdir)
        evaluation = phase_eval(cont_out["checkpoints"][-1], cont_out["test_reward"])
        del cont_out, cont_steps
        torch.cuda.empty_cache()
        continuous_reference = phase_train_reference(
            ("exp=dreamer_v3_dmc_walker_walk", "env=dummy", "env.id=continuous_dummy"), 6, True, "continuous reference"
        )
        graph_continuous = phase_graph_vs_eager("continuous")
        fused_continuous = phase_fused_continuous(workdir)
        ppo_t0 = time.perf_counter()
        ppo_vector, ppo_continuous, ppo_out, ppo_cfg = phase_ppo(workdir)
        ppo_profile = phase_ppo_profile(ppo_out["agent"], ppo_cfg, "ppo profile")
        del ppo_out
        ppo_pixels, ppo_resume, ppo_serving, ppo_evaluation, atari_out, atari_cfg = phase_ppo_pixels(workdir, workdir)
        ppo_atari_profile = phase_ppo_profile(atari_out["agent"], atari_cfg, "ppo_atari profile")
        del atari_out
        ppo_reference = phase_ppo_reference()
        ppo_phases_s = time.perf_counter() - ppo_t0
        log(f"ppo: phases 13-15 took {ppo_phases_s:.1f} s")
        sac_t0 = time.perf_counter()
        sac = phase_sac(workdir, workdir)
        sac_reference = phase_sac_reference()
        droq = phase_droq(workdir)
        offpolicy_graph = {kind: phase_offpolicy_graph(kind) for kind in ("sac", "droq")}
        offpolicy_host = {kind: phase_offpolicy_host_profile(kind) for kind in ("sac", "droq")}
        sac_phases_s = time.perf_counter() - sac_t0
        log(f"sac, droq: phases 16-20 took {sac_phases_s:.1f} s")
        dv2_t0 = time.perf_counter()
        dv2_kernels = phase_dv2_kernels()
        dv2_training, dv2_agent, dv2_cfg = phase_dv2_training(workdir)
        dv2_profile = phase_dv2_profile(dv2_agent, dv2_cfg)
        del dv2_agent
        torch.cuda.empty_cache()
        dv2_reference = phase_dv2_reference()
        dv1_training = phase_dv1_training(workdir)
        dv2_phases_s = time.perf_counter() - dv2_t0
        log(f"dreamer_v2, dreamer_v1: phases 21-25 took {dv2_phases_s:.1f} s")
        onpolicy_t0 = time.perf_counter()
        a2c = phase_a2c(workdir)
        ppo_recurrent, rec_agent, rec_cfg = phase_ppo_recurrent(workdir)
        ppo_recurrent_profile = phase_ppo_recurrent_profile(rec_agent, rec_cfg)
        del rec_agent
        a2c_reference = phase_a2c_reference()
        ppo_recurrent_reference = phase_ppo_recurrent_reference()
        onpolicy_phases_s = time.perf_counter() - onpolicy_t0
        log(f"a2c, ppo_recurrent: phases 26-30 took {onpolicy_phases_s:.1f} s")
        p2e_t0 = time.perf_counter()
        p2e_kernels = phase_p2e_kernels()
        p2e_training, p2e_out = phase_p2e_training(workdir)
        p2e_profile = phase_p2e_profile(p2e_out["agent"])
        shutil.rmtree(p2e_out["log_dir"], ignore_errors=True)
        del p2e_out
        torch.cuda.empty_cache()
        p2e_reference = {kind: phase_p2e_reference(kind == "continuous") for kind in ("discrete", "continuous")}
        p2e_dv2_kernels, p2e_dv2 = phase_p2e_dv2(workdir)
        p2e_phases_s = time.perf_counter() - p2e_t0
        log(f"p2e_dv3, p2e_dv2: phases 31-36 took {p2e_phases_s:.1f} s")
        last_trainers = phases_37_41(workdir)
        replay_sample = phase_replay_sample()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    # Device operations per gradient step: the trainer's host side (replay, metrics, logging) adds none to the step's.
    for what, profile, ops in (("discrete", train_profile, STEP_OPS["discrete"]), ("continuous", continuous_profile, STEP_OPS["continuous"])):
        if abs(profile["device_ops_per_step"] - ops) > 0.01 * ops:
            fail(f"{what} step: {profile['device_ops_per_step']} device operations per gradient step, expected {ops} within 1%")

    # The training path's shapes in bf16-mixed: the dynamic scan's B = 16
    # (streaming), the imagination's B = 1024 (tensor cores).
    def row_of(table, shape, dtype="bfloat16"):
        return next(r for r in table if r["shape"] == shape and r["dtype"] == dtype)

    fwd_row = row_of(rows, "B=16 D=1024 H=512")
    tc_row = row_of(rows, "B=1024 D=1024 H=512")
    serve_row = row_of(rows, "B=8 D=1024 H=512")
    bwd_row = row_of(bwd_rows, "B=16 H=512")
    bwd_big_row = row_of(bwd_rows, "B=1024 H=512")
    by_kernel = training["ln_gru_forward_launches_by_kernel"]
    cont_counts = continuous["ln_gru_launches"]
    bwd16_in_step_ms = train_profile["ln_gru_backward_in_step_ms_by_batch"][16]["ms"]
    bwd1024_in_step_ms = continuous_profile["ln_gru_backward_in_step_ms_by_batch"][IMAGINED_BATCH]["ms"]

    def entry(name, source, replaces, shapes, launches, row, err):
        # The on-policy trainers' runs (phases 26-27), P2E-DV1's and SAC-AE's (37, 39) launch none: checked there, shown here.
        kind = {"ln_gru_forward": "forward", "ln_gru_forward_tensor_core": "tensor_core", "ln_gru_backward": "backward"}[name]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces, "shapes": shapes,
                "launches": launches, "max_abs_err": err, "ms": row["ms"], "ms_min": row["ms_min"], "ms_max": row["ms_max"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": None,
                "launches_a2c": a2c["training"]["ln_gru_launches"][kind],
                "launches_ppo_recurrent": ppo_recurrent["training"]["ln_gru_launches"][kind],
                "launches_p2e_dv1": last_trainers["p2e_dv1"]["ln_gru_launches"][kind],
                "launches_sac_ae": last_trainers["sac_ae"]["host"]["ln_gru_launches"][kind]}  # fmt: skip

    def in_graph(kernel):
        """The kernel's nodes in the captured step's graph, and its launches
        by the fused CLI runs' replays."""
        return {"graph_nodes_per_step": {k: g["graph_ln_gru_nodes"][kernel] for k, g in (("discrete", graph_discrete), ("continuous", graph_continuous))},
                "launches_fused_replays": {k: f["fused"]["graph"]["ln_gru"][kernel] * f["fused"]["replays"]
                                           for k, f in (("discrete", fused_training), ("continuous", fused_continuous))}}  # fmt: skip

    def dv2_row(batch, kind):
        """A DreamerV2 kernel's entry: bf16 (the recipe's precision) at one of its batches."""
        row = next(r for r in dv2_kernels if r["batch"] == batch and r["dtype"] == "bfloat16")
        part = row[kind]
        counts = dv2_training["ln_gru_launches"]["forward_by_batch" if kind == "forward" else "backward_by_batch"]
        err = max(part["max_abs_err_h"], part["max_abs_err_z"]) if kind == "forward" else max(part["max_abs_err"].values())
        per_step = (DV2_FWD_BY_BATCH if kind == "forward" else DV2_BWD_BY_BATCH)[batch]
        name, source, replaces = (("ln_gru_forward", "sheeprl_tpu_torch/csrc/ln_gru.cu", "sheeprl_tpu/models/pallas_gru.py:118") if kind == "forward"
                                  else ("ln_gru_backward", "sheeprl_tpu_torch/csrc/ln_gru_bwd.cu", "sheeprl_tpu/models/pallas_gru.py:172"))
        out = entry(name, source, replaces, f"{row['shape']} bfloat16, streaming kernel (DreamerV2 {row['where']}; {per_step} launches per "
                    f"gradient step)" if kind == "forward" else f"B={batch} H={DV2_HIDDEN} bfloat16 (DreamerV2 {row['where']}; {per_step} "
                    f"launches per gradient step)", counts.get(batch, 0), part, err)  # fmt: skip
        # The TPU reference at H = 600 is not its kernel: the JAX _eligible takes H % 128 == 0 only.
        out |= {"tpu_reference_at_this_shape": "plain path: _eligible, sheeprl_tpu/models/pallas_gru.py:143-151, refuses H % 128 != 0"}
        if kind == "forward":
            out |= {"product_library_ms": part["product_library_ms"]}
        return out

    dv2_entries = [dv2_row(DV2_BATCH, "forward"), dv2_row(DV2_IMAGINED, "forward"), dv2_row(DV2_BATCH, "backward"),
                   dv2_row(DV2_IMAGINED, "backward")]  # fmt: skip
    dv2_entries[0]["launches_player"] = dv2_training["ln_gru_launches"]["forward_by_batch"].get(DV2_ENVS, 0)

    def p2e_entry(rows, training, batch, kind, model, per_step, tpu_reference, per="gradient step"):
        """A P2E kernel's entry at one of its batches (f32, the exps'
        precision): launches of the exploration run, and of the finetuning
        run beside them; ``per_step`` launches per ``per``."""
        row = next(r for r in rows if r["batch"] == batch)
        part = row[kind]
        key = "forward_by_batch" if kind == "forward" else "backward_by_batch"
        if kind == "forward":
            err, name, source, replaces = (max(part["max_abs_err_h"], part["max_abs_err_z"]), "ln_gru_forward", "sheeprl_tpu_torch/csrc/ln_gru.cu",
                                           "sheeprl_tpu/models/pallas_gru.py:118")  # fmt: skip
            shapes = f"{row['shape']} float32, streaming kernel ({model} {row['where']}; {per_step} launches per {per})"
        else:
            err, name, source, replaces = (max(part["max_abs_err"].values()), "ln_gru_backward", "sheeprl_tpu_torch/csrc/ln_gru_bwd.cu",
                                           "sheeprl_tpu/models/pallas_gru.py:172")  # fmt: skip
            shapes = f"B={batch} H={row['shape'].rsplit('H=', 1)[1]} float32 ({model} {row['where']}; {per_step} launches per {per})"
        out = entry(name, source, replaces, shapes, training["ln_gru_launches"][key].get(batch, 0), part, err)
        out |= {"launches_finetuning": training["finetuning"]["ln_gru_launches"][key].get(batch, 0), "tpu_reference_at_this_shape": tpu_reference}
        return out | ({"product_library_ms": part["product_library_ms"]} if kind == "forward" else {})

    pallas = "the Pallas kernel: _eligible, sheeprl_tpu/models/pallas_gru.py:143-151, takes H % 128 == 0"
    plain = "plain path: _eligible, sheeprl_tpu/models/pallas_gru.py:143-151, refuses H % 128 != 0"
    p2e_entries = [
        p2e_entry(p2e_kernels, p2e_training, P2E_BATCH, "forward", "P2E-DV3 XL", P2E_SEQ, pallas),
        p2e_entry(p2e_kernels, p2e_training, P2E_IMAGINED, "forward", "P2E-DV3 XL", 2 * P2E_HORIZON, pallas),
        p2e_entry(p2e_kernels, p2e_training, P2E_BATCH, "backward", "P2E-DV3 XL", P2E_SEQ, pallas),
        p2e_entry(p2e_dv2_kernels, p2e_dv2, P2E2_BATCH, "forward", "P2E-DV2", P2E2_SEQ, plain),
        p2e_entry(p2e_dv2_kernels, p2e_dv2, P2E2_IMAGINED, "forward", "P2E-DV2", 2 * P2E_HORIZON, plain),
        p2e_entry(p2e_dv2_kernels, p2e_dv2, P2E2_BATCH, "backward", "P2E-DV2", P2E2_SEQ, plain),
        p2e_entry(p2e_dv2_kernels, p2e_dv2, P2E2_IMAGINED, "backward", "P2E-DV2", 2 * P2E_HORIZON, plain),
        p2e_entry(p2e_kernels, p2e_training, P2E_ENVS, "forward", "P2E-DV3 XL", 1, pallas, per="policy iteration"),
        p2e_entry(p2e_dv2_kernels, p2e_dv2, P2E_ENVS, "forward", "P2E-DV2", 1, plain, per="policy iteration"),
    ]
    kernels_line = {
        "kernels": [
            entry("ln_gru_forward", "sheeprl_tpu_torch/csrc/ln_gru.cu", "sheeprl_tpu/models/pallas_gru.py:118",
                  f"B=16 D=1024 H=512 bfloat16, streaming kernel (DreamerV3-S dynamic scan; {STREAM_PER_STEP} launches per gradient step)",
                  by_kernel["streaming"], fwd_row, max(fwd_row["max_abs_err_h"], fwd_row["max_abs_err_z"]))
            | {"product_library_ms": fwd_row["product_library_ms"], "launches_serving": serving["ln_gru_launches_by_kernel"]["streaming"],
               "serving_b8": {k: serve_row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "product_library_ms")},
               "launches_continuous": cont_counts["forward_by_batch"].get(16, 0)} | in_graph("streaming"),
            entry("ln_gru_forward_tensor_core", "sheeprl_tpu_torch/csrc/ln_gru_tc.cu", "sheeprl_tpu/models/pallas_gru.py:118",
                  f"B=1024 D=1024 H=512 bfloat16 (DreamerV3-S imagination; {TC_PER_STEP} launches per gradient step)",
                  by_kernel["tensor_core"], tc_row, max(tc_row["max_abs_err_h"], tc_row["max_abs_err_z"]))
            | {"product_library_ms": tc_row["product_library_ms"], "launches_continuous": cont_counts["forward_by_batch"].get(1024, 0)}
            | in_graph("tensor_core"),
            entry("ln_gru_backward", "sheeprl_tpu_torch/csrc/ln_gru_bwd.cu", "sheeprl_tpu/models/pallas_gru.py:172",
                  f"{bwd_row['shape']} {bwd_row['dtype']} (DreamerV3-S dynamic scan; {BWD_PER_STEP} launches per gradient step)",
                  training["ln_gru_backward_launches"], bwd_row, max(bwd_row["max_abs_err"].values()))
            | {"in_step_ms": bwd16_in_step_ms, "launches_continuous": cont_counts["backward_by_batch"].get(16, 0)} | in_graph("backward"),
            entry("ln_gru_backward", "sheeprl_tpu_torch/csrc/ln_gru_bwd.cu", "sheeprl_tpu/models/pallas_gru.py:172",
                  f"{bwd_big_row['shape']} {bwd_big_row['dtype']} (DreamerV3-S imagination under the continuous actor's pathwise "
                  f"gradient; {WALKER_BWD_PER_STEP[1024]} launches per gradient step)",
                  cont_counts["backward_by_batch"].get(IMAGINED_BATCH, 0), bwd_big_row, max(bwd_big_row["max_abs_err"].values()))
            | {"in_step_ms": bwd1024_in_step_ms},
            *dv2_entries,
            *p2e_entries,
        ]
    }  # fmt: skip
    report = {
        "card": card,
        "build_s": built,
        "ln_gru": rows,
        "threshold": threshold,
        "ln_gru_backward": bwd_rows,
        "cell_grad_max_abs_err": cell_grad,
        "serving": serving,
        "step_profile": step_profile,
        "reference_max_abs_dh": worst,
        "training": training,
        "train_step_profile": train_profile,
        "train_reference": train_reference,
        "continuous_training": continuous,
        "continuous_step_profile": continuous_profile,
        "resume": resume,
        "continuous_serving": continuous_serving,
        "continuous_reference": continuous_reference,
        "evaluation": evaluation,
        "replay_sample": replay_sample,
        "graph_discrete": graph_discrete,
        "graph_continuous": graph_continuous,
        "fused_training": fused_training,
        "fused_continuous_training": fused_continuous,
        "ppo": ppo_vector,
        "ppo_continuous": ppo_continuous,
        "ppo_profile": ppo_profile,
        "ppo_atari": ppo_pixels,
        "ppo_atari_profile": ppo_atari_profile,
        "ppo_resume": ppo_resume,
        "ppo_serving": ppo_serving,
        "ppo_evaluation": ppo_evaluation,
        "ppo_reference": ppo_reference,
        "ppo_phases_s": ppo_phases_s,
        "sac": sac,
        "sac_reference": sac_reference,
        "droq": droq,
        "offpolicy_ring_profile": offpolicy_graph,
        "offpolicy_host_profile": offpolicy_host,
        "sac_phases_s": sac_phases_s,
        "dv2_kernels": dv2_kernels,
        "dv2_training": dv2_training,
        "dv2_profile": dv2_profile,
        "dv2_reference": dv2_reference,
        "dv1_training": dv1_training,
        "dv2_phases_s": dv2_phases_s,
        "a2c": a2c,
        "a2c_reference": a2c_reference,
        "ppo_recurrent": ppo_recurrent,
        "ppo_recurrent_profile": ppo_recurrent_profile,
        "ppo_recurrent_reference": ppo_recurrent_reference,
        "onpolicy_phases_s": onpolicy_phases_s,
        "p2e_kernels": p2e_kernels,
        "p2e_training": p2e_training,
        "p2e_profile": p2e_profile,
        "p2e_reference": p2e_reference,
        "p2e_dv2_kernels": p2e_dv2_kernels,
        "p2e_dv2": p2e_dv2,
        "p2e_phases_s": p2e_phases_s,
        **last_trainers,
        "kernels": kernels_line["kernels"],
        "phase_s": phase_s,
    }
    log(f"phase seconds: {json.dumps({k: round(v, 2) for k, v in phase_s.items()})}")
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as fp:
        json.dump(report, fp, indent=2)
    print(json.dumps(kernels_line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
