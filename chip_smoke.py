#!/usr/bin/env python3
"""Drive the PyTorch port (sheeprl_tpu_torch) on one CUDA card and check it.

Run from the root of a checkout, on a machine with an H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line; the
``python -m sheeprl_tpu_torch.eval`` runs that phases 8-46 ask for are
queued and run together, each in a process of its own on the card, beside
phase 34 (those of 8-27) and phase 41 (those of 32-46), which time nothing;
phase 34 runs before 32-33, and the Anakin lane, 42-46, before 37-41):

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
   split shows one ln_gru_* launch per call (bf16 at B = 8, 16 and 1024). Then both forward kernels at
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
   ``torch.cuda.set_sync_debug_mode("error")``), then from one snapshot 3
   eager steps twice and 3 replays of the graph (taus 0.02, 0 and 1):
   every parameter, Adam state, the moments and each step's metrics bit
   for bit (or, were the two eager runs to differ, within their
   difference). The graph's nodes, read from the graph itself (libcuda's
   cuGraphGetNodes): 64 + 15 LN-GRU forward and 64 (discrete) or 79 (continuous)
   backward kernel nodes, beside the eager step's 17932 and 18794 device
   operations; the LN-GRU tickets back at zero after the replays. Then 16
   back-to-back replays timed (host wall, CUDA events), 8 profiled (device
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
28. Recurrent PPO's profile: one update (timed whole, its first epoch
   timed and profiled) and one rollout step of the trained agent (host
   wall, device busy, idle share, operations, peak memory).
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
   ensemble of 8, two exploration critics), cut (listed in the output) to 4
   gradient steps (replay ratio 0.5) and a checkpoint after the 2nd; every gradient step
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
42. The Anakin lane's batched envs (CartPole, Pendulum, the pixel
   gridworld): 64 envs x 300 steps of the lane's step with same-step
   autoreset on the card against the CPU, from the CPU's state, with the
   same actions and reset draws: integers, flags and pixels exact, f32
   within 1e-5.
43. The LN-GRU at the lane's DreamerV3-S shapes (D = 1024, H = 512):
   streaming forward and backward at B = 4 (the player) and 8 (the dynamic
   scan) in f32 and bf16 and at B = 256 in f32; the tensor-core forward at
   B = 256 in bf16 (the imagination under bf16-mixed); each held to its
   plain version and timed beside it, its bound and cuBLAS's product.
44. ``exp=dreamer_v3_anakin`` through the CLI at the recipe's widths, the
   100000-row ring (1.23 GB) on the card: the prefill in 16 supersteps,
   then two of training (32 gradient steps each), every rollout one graph
   replay after its first call; the graphs' LN-GRU nodes (16 at B = 4 a
   policy rollout; 47 forwards and 32 backwards a gradient step); both
   rollouts' graphs against their eager runs bit for bit; a superstep and a
   rollout profiled (host wall, busy, idle share, operations, peak memory,
   env steps/s); resumed, ``eval``; then bf16-mixed, the tensor-core kernel
   at B = 256 in the lane.
45-46. ``exp=ppo_anakin`` (one graph replay a superstep, the update inside)
   and ``exp=sac_anakin`` through the CLI on the fused lane and on the host
   lane on the same env and steps: graph replays per superstep, env steps/s
   of both lanes, no LN-GRU launch, each rollout graph against its eager run
   bit for bit, the fused run resumed and evaluated. ``c.phases_42_46(dir)``
   runs 42-46 alone after ``kernels.build()``.
47. The interaction pipeline (``core/interact.py``) with DV3-S's player
   (bf16-mixed, the exp's widths, random weights, 4 dummy envs; the
   variants timed in turns over two windows of 32 env steps each, after 4
   warm-up steps): one slice with the blocking fetch and with the async fetch
   against the serial loop bit for bit (actions, obs, the player's state),
   the async one with no blocking fetch; two slices with the async fetch;
   the LN-GRU launched once a slice an env step; each timed (host wall,
   device busy a env step); two slices against one in 32-true with the
   draws at their modes (actions equal, state within 1e-3); ppo_atari's
   rollout step in the loop as it was before the pipeline, through the
   pipeline at one slice (the default path) and at two slices with the
   async fetch; the streaming kernel at the two-slice player's B = 2 in f32
   and bf16; then ``exp=dreamer_v3_100k_ms_pacman`` and ``exp=sac`` through
   the CLI with the ring, ``fabric.async_fetch=True`` and
   ``env.pipeline_slices=2``, the train calls between the fetch and its
   harvest past the graph's capture: finite losses, no blocking fetch, a
   positive overlap share, and a harvest's wait under a quarter of a train
   call's time.
48. The placement (``core/player.py``): ``auto`` on the card (the probe's
   latency printed), ``host`` playing DV3-S on a CPU copy with no LN-GRU
   launch on the card, the mirror's bytes, issue, landing and load times in
   ``fresh`` and ``async``, and the CPU player from mirrored weights against
   the card's in 32-true (5 steps: actions equal, state within 1e-3).
49-50. ``exp=sac_decoupled`` (fresh and async) and ``exp=ppo_decoupled``
   through the CLI with ``fabric.devices=1 fabric.player_device=host``:
   player on the CPU, no LN-GRU launch, the first train call (update) held
   against the CPU at the SAC (PPO) reference's bounds, resumed from the
   mid-run checkpoint, evaluated; host wall an iteration and the mirror's
   pushes. ``c.phases_47_50(dir)`` runs 47-50 alone after
   ``kernels.build()``.
51. Telemetry through the CLI: DV3-S (``exp=dreamer_v3_100k_ms_pacman``,
   1 env, cut as ``TELE_CUTS`` lists) with ``telemetry=on`` on the host
   path, with a ``torch.profiler`` window over 2 gradient steps and a
   ``/metrics`` exporter scraped mid-run, and on the ring path:
   ``trace.json`` and ``telemetry.jsonl`` written, the spans and counters
   (graph captures, kernel builds and cache hits, transfer bytes) printed,
   ``perf/mfu`` and ``perf/hbm_bw_util`` of every trained interval in
   (0, 1] and the compute/infeed/host breakdown summing to 1 within 0.05,
   the profiler trace's markers and all three LN-GRU kernels in it, every
   LN-GRU kernel launched; one eager DV3-S step at T, B = 16, 8 counted on
   the card (bf16-mixed, the kernels by formula) against the CPU (32-true,
   plain) within 1%.
52. The ring path again with telemetry off: parameters bit for bit, equal
   synchronising calls per gradient step (``set_sync_debug_mode("warn")``)
   and graph node counts; the host wall per gradient step of both.
53. The DV3-S policy server: requests with and without ``traceparent``, the
   request ids on every reply, the client's trace on the batch spans,
   ``GET /metrics``. ``c.phases_51_53(dir)`` runs 51-53 alone after
   ``kernels.build()``.
54. Health: phase 51's two DV3-S runs again with ``health=on``: the
   parameters and Adam states bit for bit with health off, the LN-GRU
   launches and the synchronising calls per gradient step equal, no
   sentinel event; the health-off graph's nodes as recorded (17961); then
   the probed step's graph against its eager step bit for bit and each
   probe within 1e-5 relative of a plain recomputation on the card; the
   host wall health adds per gradient step on each path.
55. Preemption: SAC (host path) and DV3-S (ring path) with a chaos
   ``sigterm``: the checkpoint at the signal's step, ``autoresume.json``
   (signal 15), ``checkpoint.resume_from=auto`` to the end bit for bit the
   uninterrupted run's; DV3-S's run also takes a ``delayed_fetch`` under a
   ``warn`` watchdog (the trip on ``fetch/player_actions``); then a real
   SIGTERM from outside to a SAC trainer subprocess. Drain-to-exit and
   auto-resume seconds.
56. Drills: ``env_step_raise`` under the supervisor (one restart, the
   truncated row stored), a ``checkpoint.before_commit`` fail point (the
   previous checkpoint the newest valid, no staging dir), ``exp=ppo_atari``
   with ``env.grayscale``, ``env.frame_stack=2``, ``env.max_episode_steps=3``
   (C4), and the DV3-S host player's ms per env step at ``num_threads`` 1
   and at torch's default (C5).
57. The DV3-S policy server in the foreground drains on SIGTERM through the
   preemption guard. ``c.phases_54_57(dir)`` runs 54-57 alone after
   ``kernels.build()``.
58. The actor fleet, SAC: ``exp=sac_decoupled`` (phase 49's cuts) with
   ``fleet.replicas=2``, two spawned replicas playing on the CPU (every
   shipment says its replica had no CUDA context), the learner on the card,
   three runs: a ``kill9`` on replica 0 (one restart, generation 1 seeded
   ``replica_seed(seed, 0, 1)``; death to its first shipment; its first
   train call against the CPU at phase 49's bounds); a ``sigterm`` to the
   learner (drain, the save at the signal's step; drain-to-exit); and
   ``checkpoint.resume_from=auto`` to the end with no fault: no row
   dropped, shipments from both replicas, phase 49's gradient-step count,
   ``iter_num`` and buffer position. No LN-GRU launch.
59. The actor fleet, PPO: ``exp=ppo_decoupled`` with ``fleet.replicas=2``
   (3 rounds, one run): every round 2 rollouts of its version; the first update
   replayed on the card bit for bit, each of its Adam steps against the CPU
   from the card's state at ``PPOF_STEP_TOL``, its first 72 steps' losses
   against the CPU's own update; a ``kill9`` on replica 0 whose
   generation 1 ships into a round; the learner's host wall an iteration
   beside phase 50's, the broadcast's bytes and pump send time, the
   replicas' spawn to hello. No LN-GRU launch.
60. DreamerV3's XS, M and L sizes: every LN-GRU shape of each (forward at
   B = 16, 1024 and the player's 1, bf16 and f32, XS's bf16 B = 1024 on the
   tensor cores at a cluster of 4; backward at B = 16 and 1024) against its
   plain version, timed with its bound, plain time and cuBLAS's product;
   then one bf16-mixed gradient step per size through the CLI
   (``exp=dreamer_v3_100k_ms_pacman algo=dreamer_v3_<size>``, ``DV3_SIZE_CUTS``):
   finite losses, DV3-S's launches by batch, host wall, device busy, peak
   memory. ``c.phases_58_60(dir)`` runs 58-60 alone after
   ``kernels.build()``.
61. The env layer: DreamerV3-S at full width (``ENV_LAYER_ARGS``,
   bf16-mixed, 4 envs) on the host buffer and on the ring, its envs in
   worker processes (``env.sync_env=False``) against in-process from the
   same seed: rows, ring and parameters bit for bit, phase 7's LN-GRU
   launches per gradient step, the workers' spawn to ready and the host
   wall per env step of each mode; a fault planted in env 1's thunk
   (``RaiseAtStep``: its env raises in a chosen step inside its worker)
   that ``RestartOnException`` answers, the host buffer's and the ring's
   patched rows, training on with finite losses; the workers' process
   groups with ``env/steps`` spans in the merged trace; ``env=gym``,
   ``mujoco`` and ``dmc`` raising with ``require``'s message where their
   package is missing. Every earlier phase runs its envs in-process
   (``pin_in_process_envs``: ``env.sync_env=True`` unless a run names it),
   as it was measured, and the script fails if any of them built a
   worker-process vector (``async_vectors_built``).
   ``c.pin_in_process_envs(); c.phase_env_layer(dir)`` runs it alone after
   ``kernels.build()``.
62. The data axis (``fabric.devices``, core/runtime.py and core/mesh.py)
   through the trainer's entry point, ``dreamer_v3.main`` with a
   ``Runtime`` as ``cli.run`` calls it (``Runtime.launch``, ``lead`` and
   ``follow``, ``follow_dreamer_v3``, ``replicate_training``), DreamerV3-S at
   full width (``exp=dreamer_v3_100k_ms_pacman``, bf16-mixed, B = 16 x 64)
   for 3 gradient steps: the one-process run, then (a) the same run on a
   one-rank NCCL group, bit for bit (every parameter, Adam state, the
   moments and every logged value), 79 forward and 64 backward launches a
   step; (b) two ranks on the one card over gloo (the backend that
   ``launch`` takes from this script), rank 1 spawned, each taking 8 of the
   16 rows: rank 1's kernels at its shapes (the streaming forward and the
   backward at B = 8, the tensor-core forward at B = 512) against their
   plain versions, each rank's LN-GRU launches counted (64 streaming and
   15 tensor-core forwards, 64 backwards a step), rank 0's run held against
   the one-process run by each module's change (``DP_PARAM_BOUND``) and the
   moments (``DP_MOMENTS_BOUND``), each bound set between the sound reading
   and a planted fault's (the same run with rank 0's gradient left
   unreduced), the two ranks' weights equal; (c) each rank's host wall a
   step, the collectives' share of it and the bytes all-reduced, broadcast
   and gathered, beside the one-process run's step wall.
   ``c.phase_data_parallel(dir)`` runs it alone after ``kernels.build()``.
63. The data axis for the other trainers through their entry points with
   a ``Runtime`` (one ``Runtime.launch`` carries every two-rank run; rank 1
   runs ``cli.follow`` on the config rank 0 sends before each run): (a)
   DreamerV2 (``exp=dreamer_v2_ms_pacman`` at full width, bf16-mixed,
   B = 32 x 50) through ``dreamer_v2.main`` for 3 gradient steps, the
   one-process run, the same run on a one-rank NCCL group bit for bit
   (every parameter, Adam state and logged value), then two gloo ranks on
   the one card, 16 of the 32 rows each: each rank's launches counted (50
   streaming forwards and backwards at B = 16 and 15 at B = 800 a step),
   rank 0's modules held against the one-process run by a bound
   (``DP2_PARAM_BOUND``) between the sound reading and the same run with
   rank 0's gradient unreduced, each rank's step wall, the collectives'
   share and the bytes they move; (b) the P2E-DV2 chain (exploration, then
   finetuning of its checkpoint; 32-true, B = 16 x 50, H = 400) on two
   ranks, 2 gradient steps a phase, launches at B = 8 and 400 counted,
   rank 0 held against the one-process chain (``DPP_PARAM_BOUND``); (c)
   one P2E-DV3 exploration train step at XL width (32-true, B = 16 x 64,
   H = 4096) on two ranks against the one-process step
   (``DPX_PARAM_BOUND``), launches at B = 8 and 512 counted, each rank's
   peak memory. Rank 1 holds the kernels at its shapes against their plain
   versions; they are timed here (``rank_kernel_rows``). DreamerV1,
   P2E-DV1, DroQ, SAC-AE, A2C and recurrent PPO launch no kernel: their two
   ranks are held on the CPU only (tests/test_torch_dp_*_steps.py).
   ``c.phase_data_parallel_rest(dir)`` runs it alone after
   ``kernels.build()``.

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
B = 16 and 800, H = 400; then the Anakin lane's streaming forwards at B =
4, 8 and 256, the tensor-core forward at B = 256 and the backwards at B = 8;
then the streaming forward at the two-slice player's B = 2 in bf16 and f32;
every entry with the P2E-DV1 and SAC-AE runs' launches, 0, the Anakin
runs', and phases 47-50's: the pipeline at one and two slices, the host
player's and the decoupled runs', 0; phases 51 and 54's, telemetry and
health on; phases 58-59's fleet runs', 0); then phase 60's bf16 rows of
DreamerV3 XS, M and L (forward at B = 16, 1024 and 1, backward at B = 16
and 1024) with their CLI step's launches; every entry also with phase
61's worker-process runs' launches on the host and the ring path, and
phase 62's (``launches_dp``: both ranks' sound run, rank 0's player
included; ``launches_dp_one_rank_nccl``: the one-rank NCCL run) and phase
63's (``launches_dp_rest``: both ranks' runs); then phase 63's rows at the
ranks' shapes (DreamerV2's forward and backward at B = 16 and 800, H =
600, bf16; P2E-DV2's at B = 8 and 400, H = 400, and P2E-DV3 XL's forward
at B = 8 and 512 and backward at B = 8, H = 4096, f32) with their runs'
launches; the card's name and power limit,
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
from contextlib import ExitStack, contextmanager, nullcontext

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
    caller's time. Also charges the seconds spent in torch.profiler
    (``profiled`` and the reading of a profile's records, ``read_profile``)
    to the running phase in ``PROFILER_S``."""
    seconds: dict = {}
    depth, phase, inside = [0], [None], [0]

    def timed(name, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            if depth[0] == 0:
                phase[0] = name
            depth[0] += 1
            try:
                return fn(*args, **kwargs)
            finally:
                depth[0] -= 1
                if depth[0] == 0:
                    seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0

        return wrapper

    def charged(fn):
        """``fn``'s wall seconds, outermost calls only, into PROFILER_S under the running phase."""

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            inside[0] += 1
            try:
                return fn(*args, **kwargs)
            finally:
                inside[0] -= 1
                if inside[0] == 0:
                    key = phase[0] if depth[0] else "outside phases"
                    PROFILER_S[key] = PROFILER_S.get(key, 0.0) + time.perf_counter() - t0

        return wrapper

    for name, fn in list(namespace.items()):
        if name.startswith("phase_") and callable(fn):
            namespace[name] = timed(name, fn)
    if callable(namespace.get("profiled")):
        import torch.profiler

        namespace["profiled"] = charged(namespace["profiled"])
        namespace["read_profile"] = charged(namespace["read_profile"])
        for attr in ("key_averages", "events"):
            setattr(torch.profiler.profile, attr, charged(getattr(torch.profiler.profile, attr)))
    return seconds


# Per phase: the wall seconds inside torch.profiler captures (``profiled``)
# and the reading of their records (``read_profile``; torch's ``key_averages``
# and ``events`` where called), filled by the wrappers ``time_phases`` installs.
PROFILER_S: dict = {}


def share_bytecode(build_dir) -> None:
    """Every process the script starts (the evaluations, the fleets'
    replicas, the second rank, the SIGTERM drills) imports torch and the
    port. With ``PYTHONDONTWRITEBYTECODE`` set, as on the card's host, and
    read-only package directories, each would compile their sources again:
    9.2-9.6 s to import torch and register the port's algorithms there,
    5.4-5.7 s from a bytecode cache (H100 host). This process and its children
    keep one under the build directory (``PYTHONPYCACHEPREFIX``, which the
    children inherit), filled by this process's own imports."""
    prefix = os.path.join(str(build_dir), "pycache")
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = prefix
    sys.dont_write_bytecode = False
    sys.pycache_prefix = prefix


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


def profiled(fn, activities=("cuda",), captures: int = 3):
    """torch.profiler over one call of ``fn`` behind the marker kernels that
    absorb the profiler's lost device records
    (:func:`sheeprl_tpu_torch.telemetry.profiling.profiled`); the script fails
    when every capture lost its markers. ``_busy`` and ``kernel_split_ms``
    leave the markers out."""
    from sheeprl_tpu_torch.telemetry import profiling

    try:
        return profiling.profiled(fn, activities, captures, log=log)
    except RuntimeError as err:
        fail(str(err))


def kernel_split_ms(fn, calls: int = 50) -> dict:
    """Device ms and launches per call of each CUDA kernel ``fn`` launches,
    from torch.profiler: {name: {"ms": ..., "launches": ...}}."""
    import torch

    from sheeprl_tpu_torch.telemetry.profiling import MARKER_KERNEL

    fn()
    torch.cuda.synchronize()
    prof = profiled(lambda: [fn() for _ in range(calls)])
    split = {}
    for evt in read_profile(prof)[0]:
        total_us = getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0.0)
        if total_us and evt.count and MARKER_KERNEL not in evt.key:
            found = re.search(r"ln_gru_\w+", evt.key)
            name = found.group(0) if found else evt.key
            entry = split.setdefault(name, {"ms": 0.0, "launches": 0.0})
            entry["ms"] += total_us / calls / 1e3
            entry["launches"] += evt.count / calls
    return split


class _Read:
    """One event, or one key's total, of a profile as :func:`read_profile`
    reads it: the fields of torch's ``FunctionEvent`` and
    ``FunctionEventAvg`` this script uses (``key``/``name``,
    ``device_type``, ``is_user_annotation``, ``count``,
    ``device_time_total`` and ``cpu_time_total`` in us, ``time_range``)."""

    __slots__ = ("key", "device_type", "is_user_annotation", "count", "device_time_total", "cpu_time_total", "time_range")

    @property
    def name(self):
        return self.key


def read_profile(prof):
    """(key averages, events) of a torch.profiler profile, read from its
    raw kineto events: what ``prof.key_averages()`` and ``prof.events()``
    give for the fields :class:`_Read` names, without building torch's
    Python event tree, which took most of a DV3-S step's profile (its CPU
    side's tens of thousands of operations). The same events are left out
    (torch's ``_filter_name``, hidden events), names are demangled, an
    async event has no time, and a key is (name, device type, user
    annotation), as ``key_averages`` groups them."""
    import torch
    from torch.autograd.profiler_util import Interval, _filter_name

    raw = prof.profiler.kineto_results
    origin = raw.trace_start_ns()
    names, averages, events = {}, {}, []
    cuda = torch.autograd.DeviceType.CUDA
    for e in raw.events():
        name = e.name()
        if _filter_name(name) or e.is_hidden_event():
            continue
        if name not in names:
            names[name] = torch._C._demangle(name) if len(name) > 1 else name
        name, device_type, annotation = names[name], e.device_type(), e.is_user_annotation()
        start, end = (e.start_ns() - origin) / 1e3, (e.end_ns() - origin) / 1e3
        timed = not (e.is_async() or e.start_thread_id() != e.end_thread_id())
        evt = _Read()
        evt.key, evt.device_type, evt.is_user_annotation, evt.count, evt.time_range = name, device_type, annotation, 1, Interval(start, end)
        evt.device_time_total = (end - start) if timed and device_type == cuda else 0.0
        evt.cpu_time_total = (end - start) if device_type != cuda else 0.0
        events.append(evt)
        avg = averages.get((name, device_type, annotation))
        if avg is None:
            avg = averages[(name, device_type, annotation)] = _Read()
            avg.key, avg.device_type, avg.is_user_annotation, avg.time_range = name, device_type, annotation, None
            avg.count, avg.device_time_total, avg.cpu_time_total = 0, 0.0, 0.0
        avg.count += 1
        avg.device_time_total += evt.device_time_total
        avg.cpu_time_total += evt.cpu_time_total
    return list(averages.values()), events


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
    # DV3-S at every serving bucket of the default max_batch (1, 2, 4, 8), unaligned, XL (B = 64, off every
    # path, was cut for phase 61) ... and at the training path's B = 16 (dynamic scan) and B = 1024 (imagination).
    shapes = [(1, 1024, 512), (2, 1024, 512), (4, 1024, 512), (8, 1024, 512), (16, 1024, 512), (1024, 1024, 512), (3, 200, 100),
              (8, 5120, 4096)]  # fmt: skip
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
            # The one-launch split at the serving and training path's shapes in bf16 (every row's until phase 62 needed the time).
            split = kernel_split_ms(rotated(args, ln_gru_forward)) if dtype == torch.bfloat16 and (batch, depth, hidden) in SPLIT_SHAPES else None
            if split is not None:
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


SPLIT_SHAPES = ((8, 1024, 512), (16, 1024, 512), (1024, 1024, 512))  # phase_kernels' one-launch splits: the serving bucket, the scan, the imagination
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
    busy_ms, ops_per_step, _ = _busy(read_profile(prof)[0], steps, by_kernel=kernels_ms)
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

    def holding_make_train_step(agent, optimizers, cfg, *rest):
        held["agent"] = agent
        return make_train_step(agent, optimizers, cfg, *rest)

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


# 1 profiled step (3 until the interaction layer's phases 47-50 needed the
# time, 2 until the telemetry phases 51-53 did): profiling a DV3-S step's 18k
# kernels was most of this phase's cost (34.5 of 36.7 s at 2 steps, on an
# NVIDIA H100 80GB HBM3 at 700 W), most of it torch's Python event tree over
# the step's ~105k events, which ``read_profile`` does not build.
TRAIN_PROFILE_STEPS = 1


def phase_train_profile(agent, cfg, steps: int = TRAIN_PROFILE_STEPS, bwd_per_step=None, what: str = "train step profile"):
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
    averages, events = read_profile(prof)
    busy_ms, ops_per_step, annotated_ms = _busy(averages, steps, skip=("dv3/",), by_kernel=kernels_ms)
    for evt in averages:
        total_us = getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0.0)
        if evt.key.startswith("dv3/"):  # the train step's stage spans, host side and their device annotation
            side = "device_span_ms" if evt.device_type == torch.autograd.DeviceType.CUDA else "host_ms"
            stages.setdefault(evt.key, {})[side] = (total_us if side == "device_span_ms" else evt.cpu_time_total) / steps / 1e3
    if busy_ms <= 0.0:
        fail("train profile: torch.profiler saw no device time")
    spans, bwd_kernels = {stage: [] for stage in BWD_STAGE.values()}, []
    for evt in events:
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

    def rows(self, batch, time=1):
        return self.source.rows(batch, time)

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

    def rows(self, batch, time=1):
        """The draws' layout (:meth:`BatchGenerator.rows`): replayed draws need none."""
        return nullcontext()

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


# Evaluations queued by the trainers' phases, and the run directories to
# remove once they have run (:func:`defer_eval`, :func:`evals_beside`).
PENDING_EVALS, REMOVE_AFTER_EVALS = [], []


def defer_eval(ckpt, test_reward, what="eval"):
    """``python -m sheeprl_tpu_torch.eval checkpoint_path=<ckpt>``, queued for
    the next :func:`evals_beside` block: it must log
    ``Test/cumulative_reward`` under ``<run>/<version>/evaluation/version_0``,
    equal to the trainer's own test episode's. Returns the dict that holds
    its result after that block. (Each evaluation ran beside or after its
    trainer's phase until phases 58-60 needed the time; beside a phase that
    times nothing, they leave every timed number to a card of its own.)"""
    box = {}
    PENDING_EVALS.append((ckpt, test_reward, what, box))
    return box


def remove_after_evals(path):
    """``shutil.rmtree(path)`` once the queued evaluations have run (the
    directory holds one of their checkpoints)."""
    REMOVE_AFTER_EVALS.append(path)


# Processes that run a block's evaluations, each its share in turn: a
# process per evaluation would pay a torch import for each of the 17 (7
# and 10 a block) on the host's 8 cores.
EVAL_RUNNERS = 3
# A runner: ``python -m sheeprl_tpu_torch.eval checkpoint_path=<ckpt>`` for
# each of its checkpoints, the module run as ``__main__`` as ``-m`` runs it.
EVAL_RUNNER = """import runpy, sys, time
for ckpt in sys.argv[1:]:
    t0 = time.perf_counter()
    sys.argv = ["sheeprl_tpu_torch.eval", f"checkpoint_path={ckpt}"]
    runpy.run_module("sheeprl_tpu_torch.eval", run_name="__main__", alter_sys=True)
    print(f"eval_s {time.perf_counter() - t0:.3f} {ckpt}", flush=True)
"""


@contextmanager
def evals_beside(what):
    """Every queued evaluation, shared round robin among
    :data:`EVAL_RUNNERS` processes on the card, all started together beside
    the block ``what``, which must time nothing; each checked when the
    block ends."""
    queued = PENDING_EVALS[:]
    PENDING_EVALS.clear()
    t0 = time.perf_counter()
    runners = [queued[i::EVAL_RUNNERS] for i in range(min(EVAL_RUNNERS, len(queued)))]
    started = [(start_evals([q[0] for q in share]), share) for share in runners]
    try:
        yield
        block_s = time.perf_counter() - t0
        for proc, share in started:
            for (ckpt, reward, name, box), result in zip(share, finish_evals(proc, [q[2] for q in share])):
                box.update(check_eval(ckpt, reward, name, result))
    except BaseException:
        for proc, _ in started:
            if proc.poll() is None:
                proc.kill()
        raise
    for path in REMOVE_AFTER_EVALS:
        shutil.rmtree(path, ignore_errors=True)
    REMOVE_AFTER_EVALS.clear()
    log(f"evaluations beside {what}: {len(queued)} in {len(started)} processes, the block {block_s:.1f} s, all done "
        f"{time.perf_counter() - t0:.1f} s after their start")  # fmt: skip


def start_evals(ckpts):
    """The evaluations of ``ckpts``, one after another in a process of its
    own (:data:`EVAL_RUNNER`; its results read by :func:`finish_evals`,
    which the caller must reach, or kill the process)."""
    return subprocess.Popen([sys.executable, "-c", EVAL_RUNNER, *ckpts], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish_evals(proc, whats):
    """Wait for :func:`start_evals`' process: each evaluation's seconds in
    it, in order."""
    try:
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    seconds = [float(line.split()[1]) for line in stdout.splitlines() if line.startswith("eval_s ")]
    if proc.returncode != 0 or len(seconds) != len(whats):
        fail(f"{whats}: exit {proc.returncode} after {len(seconds)} evaluations\n{stdout[-2000:]}\n{stderr[-4000:]}")
    return seconds


def check_eval(ckpt, test_reward, what, wall_s):
    """What an evaluation of ``ckpt`` logged (:func:`evals_beside`)."""
    import numpy as np

    from sheeprl_tpu_torch.utils.logger import read_scalars

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

    def spying_make_train_step(agent, optimizer, cfg, *rest):
        step = make_train_step(agent, optimizer, cfg, *rest)

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
    its own. The update is profiled over its first ``PPO_PROFILED_EPOCHS``
    epochs (GAE and that many epochs of identical minibatch steps), beside
    that part's host wall."""
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

    def update(n_epochs=epochs):
        return step(data, next_obs, minibatch_indices(T * E, mb, n_epochs, gen), clip, ent)

    def busy(prof, n):
        return _busy(read_profile(prof)[0], n, skip=("ppo/",))[:2]

    update()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(2):
        update()
    torch.cuda.synchronize()
    update_ms = (time.perf_counter() - t0) / 2 * 1e3
    update_peak = torch.cuda.max_memory_allocated() / 2**30
    profiled_epochs = min(epochs, PPO_PROFILED_EPOCHS)
    t0 = time.perf_counter()
    for _ in range(2):
        update(profiled_epochs)
    torch.cuda.synchronize()
    profiled_ms = (time.perf_counter() - t0) / 2 * 1e3
    update_busy, update_ops = busy(profiled(lambda: update(profiled_epochs), ("cpu", "cuda")), 1)
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
        "update": {"host_wall_ms": update_ms, "profiled_epochs": profiled_epochs, "epochs": epochs, "profiled_host_wall_ms": profiled_ms,
                   "device_busy_ms": update_busy, "idle_share": 1 - update_busy / profiled_ms, "device_ops": update_ops, "adam_steps": adam_steps,
                   "peak_gib": update_peak},
        "gae": {"host_wall_ms": statistics.median(gae_ms), "device_busy_ms": gae_busy, "device_ops": gae_ops, "T": T, "E": E},
        "rollout_step": {"host_wall_ms": step_ms, "device_busy_ms": step_busy, "idle_share": 1 - step_busy / step_ms,
                         "device_ops": step_ops, "peak_gib": step_peak, "num_envs": E},
    }  # fmt: skip
    log(f"{what}: update ({adam_steps} Adam steps over {T} x {E} rows) {update_ms:.1f} ms host wall, peak {update_peak:.2f} GiB; GAE and its first "
        f"{profiled_epochs} of {epochs} epochs profiled: {profiled_ms:.1f} ms host wall, {update_busy:.1f} ms device busy "
        f"(idle {result['update']['idle_share']:.2f}), {update_ops:.0f} device operations; of it GAE over "
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
    evaluation = defer_eval(out["checkpoints"][-1], out["test_reward"])
    resume = phase_ppo_resume(out, snaps, cfg, log_root)
    obs_shape = _ppo_spaces(cfg)[0]["rgb"].shape
    serving = phase_ppo_serve(out["checkpoints"][-1], obs_shape, workdir)
    return pixels, resume, serving, evaluation, out, cfg


# The fused path: the replay ring in card memory and the train step
# captured as a CUDA graph that samples it (buffer.device=True).
FUSED_CUTS = {"buffer.device": "True (from False)"}
WALKER_FUSED_CUTS = {"buffer.device": "True (from False)", "algo.fused_train_steps": "2 (from 1)"}
GRAPH_RING_ROWS = 1024  # rows per env of the graph-against-eager phase's ring (at the exp's shapes)
# 3 steps: the EMA's blend, its tau-0 and tau-1 cases (8 until the
# interaction layer's phases 47-50 needed the time, 4 until phase 62 did).
GRAPH_TAUS = (0.02, 0.0, 1.0)
GRAPH_LN_GRU = {"discrete": {"streaming": STREAM_PER_STEP, "tensor_core": TC_PER_STEP, "backward": BWD_PER_STEP},
                "continuous": {"streaming": STREAM_PER_STEP, "tensor_core": TC_PER_STEP, "backward": BWD_PER_STEP + TC_PER_STEP}}  # fmt: skip
REPLAYS_PROFILED = 16
# Replays of the DV3-S graph under torch.profiler (16 until the telemetry
# phases 51-53 needed the time: profiling 16 replays of its 18k nodes took
# 35.8 of the phase's 49.7 s on an NVIDIA H100 80GB HBM3 at 700 W; 8 until
# the resilience phases 54-57 needed it); its REPLAYS_PROFILED replays stay
# timed.
GRAPH_REPLAYS_PROFILED = 1  # cut from 4 for phases 58-60 (21.3 s of torch.profiler at 4), from 2 for phase 61 (11.1 s at 2)
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
    moments and the generator's state) 3 eager steps twice (the eager
    path's run-to-run difference) and 3 replays of the graph, with the taus
    ``GRAPH_TAUS``. Every parameter, Adam state, the moments and each step's
    metrics must be equal bit for bit, or, if the two eager runs differ,
    within that difference. The graph must hold ``GRAPH_LN_GRU`` LN-GRU
    kernel nodes. Then ``REPLAYS_PROFILED`` back-to-back replays and 3 eager
    steps from the same state, timed (host wall ending in a synchronize), and
    ``GRAPH_REPLAYS_PROFILED`` replays profiled (device busy, operations)."""
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

    # REPLAYS_PROFILED back-to-back replays, then 3 eager steps, from the state the replays left.
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
        fused(m, ring.state, taus[:GRAPH_REPLAYS_PROFILED])
        torch.cuda.synchronize()
        profiled_wall.append((time.perf_counter() - t) * 1e3 / GRAPH_REPLAYS_PROFILED)

    prof = profiled(replays, ("cpu", "cuda"))
    busy_ms, ops, _ = _busy(read_profile(prof)[0], GRAPH_REPLAYS_PROFILED, skip=("dv3/",))
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
        "eager_vs_eager": eager_gap, "graph_vs_eager": graph_gap, "capture_and_replays_s": capture_and_replay_s,
        "graph_nodes": nodes["nodes"], "graph_nodes_by_type": nodes["by_type"], "graph_ln_gru_nodes": nodes["ln_gru"],
        "ln_gru_tickets_after_replays": left,
        "graph_kernel_nodes": nodes["by_type"].get("kernel", 0), "eager_device_ops_per_step": STEP_OPS[kind],
        "replays_timed": REPLAYS_PROFILED, "replays_profiled": GRAPH_REPLAYS_PROFILED, "fused_host_wall_ms_per_step": wall_ms,
        "fused_event_span_ms_per_step": span_ms,
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
        f"steps (the first under the sync check), then {len(GRAPH_TAUS)} steps from one snapshot: eager vs eager {json.dumps(eager_gap)}; graph vs eager "
        f"{json.dumps(graph_gap)}")  # fmt: skip
    log(f"{what}: the graph holds {nodes['nodes']} nodes ({json.dumps(nodes['by_type'])}), LN-GRU kernel nodes {json.dumps(nodes['ln_gru'])}; "
        f"the eager step runs {STEP_OPS[kind]} device operations")  # fmt: skip
    log(f"{what}: {REPLAYS_PROFILED} back-to-back replays: host wall {wall_ms:.2f} ms/step (events {span_ms:.2f}); "
        f"{GRAPH_REPLAYS_PROFILED} profiled: device busy {busy_ms:.2f} ms/step, {ops:.0f} device ops/step, idle share {out['fused_device_idle_share']:.3f} (under the "
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
    evaluation = defer_eval(out["checkpoints"][-1], out["test_reward"])
    return _sac_after_training(out, host, ckpt, log_root, workdir) | {"evaluation": evaluation}


def _sac_after_training(out, host, ckpt, log_root, workdir):
    """:func:`phase_sac`'s resume, serving and ring path."""
    again, resumed = offpolicy_through_cli([*SAC_ARGS, f"checkpoint.resume_from={ckpt}"], SAC_CUTS, "sac resume", log_root)
    (pa, aa), (pb, ab) = _state_of(out), _state_of(again)
    differ = [k for k in pa if not torch_equal_bits(pa[k], pb[k])] + [k for k in aa if not torch_equal_bits(aa[k], ab[k])]
    if differ or pa.keys() != pb.keys() or aa.keys() != ab.keys() or again["gradient_steps"] != out["gradient_steps"]:
        fail(f"sac resume: the resumed run ends off the uninterrupted one: {differ[:5]}")
    log(f"sac resume: from {os.path.basename(ckpt)} the run ends on the uninterrupted run's {len(pa)} parameter and {len(aa)} Adam tensors "
        "bit for bit")  # fmt: skip
    serving = serve_sac_over_http(out["checkpoints"][-1], out["agent"], workdir)
    _, ring = offpolicy_through_cli(*_cli_cuts(SAC_ARGS, SAC_CUTS, True), "sac ring", log_root)
    return {"host": host, "resume": {**resumed, "tensors_bit_for_bit": len(pa) + len(aa)}, "serving": serving, "ring": ring}


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
    of a profile's key averages (:func:`read_profile`'s, read once by the
    caller). The device ranges of ``record_function`` annotations (the
    trainer's spans, named by ``skip``, and ``Optimizer.step#Adam.step``)
    span kernels counted already: they are left out of the first two and
    summed in the third. ``by_kernel``, a dict, receives each kernel's (the
    first 60 characters of its name) device ms per ``n``. Every profile of
    this script reads its busy time here."""
    import torch

    from sheeprl_tpu_torch.telemetry.profiling import MARKER_KERNEL

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


def _timed_per_step(fn, steps, reps=3, profile=True):
    """Host wall ms per step of ``fn`` (``steps`` steps a call, ending in a
    synchronize; best of ``reps``), its device busy ms and operations per
    step (torch.profiler over one more call, unless ``profile`` is off), the
    idle share and the peak memory."""
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
    wall = statistics.median(walls)
    if not profile:
        return {"host_wall_ms_per_step": wall, "peak_gib": peak, "gradient_steps_per_s": 1e3 / wall}
    busy, ops, annotated = _busy(read_profile(profiled(fn, ("cpu", "cuda")))[0], steps, skip=("sac/", "droq/"))
    if busy <= 0.0:
        fail("torch.profiler saw no device time")
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
    The graphs' nodes (no LN-GRU node); then (e) ``REPLAYS_PROFILED`` back-to-back replays
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

    # (e) REPLAYS_PROFILED back-to-back replays of the (critic) step.
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
    evaluation = defer_eval(out["checkpoints"][-1], out["test_reward"], "dv2 eval")
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
    kernels_ms, averages = {}, read_profile(prof)[0]
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
    evaluation = defer_eval(out["checkpoints"][-1], out["test_reward"], "dv1 eval")
    again, again_steps, _, again_counts = dreamer_through_cli([*DV1_ARGS, f"log_root={log_root}", f"checkpoint.resume_from={ckpt}"],
                                                              "dv1 resume", {}, {})  # fmt: skip
    if [s[0] for s in again_steps] != list(range(DV1_RESUMED_FROM + 1, DV1_STEPS + 1)):
        fail(f"dv1 resume: gradient steps {[s[0] for s in again_steps]}")
    differ = _same_state(out["agent"].state_dict(), again["agent"].state_dict())
    if differ or again_counts["forward"] or again_counts["backward"]:
        fail(f"dv1 resume: {len(differ)} tensors differ, e.g. {differ[:4]}; LN-GRU launches {again_counts}")
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
    evaluation = defer_eval(out["checkpoints"][-1], out["test_reward"], "a2c eval")
    resume = onpolicy_resume(out, snaps, cfg, A2C_ARGS, "a2c", log_root, "a2c resume")
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
    evaluation = defer_eval(out["checkpoints"][-1], out["test_reward"], "ppo_recurrent eval")
    resume = onpolicy_resume(out, snaps, cfg, PPO_REC_ARGS, "ppo_recurrent", log_root, "ppo_recurrent resume")
    return {"training": result, "resume": resume, "evaluation": evaluation}, out["agent"], cfg


def onpolicy_profile(trainer, agent, cfg, what):
    """One update of the trained ``trainer`` agent at the recipe's shapes
    (A2C: GAE over 4 x 5 and 4 minibatches into one RMSprop step; recurrent
    PPO: 512 sequences of 16, 8 epochs of 8 minibatches, 64 AdamW steps),
    and one rollout step of its envs (the player's forward and the one copy
    to the host): host wall (ending in a synchronize), device busy and idle
    share (``_busy``), device operations, peak memory. Recurrent PPO's
    update is profiled over its first ``PPO_REC_PROFILED_EPOCHS`` epochs
    (timed alone for the idle share), its whole update timed."""
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

        def update(epochs_run=epochs):
            return step(data, minibatch_indices(n, mb, epochs, gen)[:epochs_run], clip, ent)

    update()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(2):
        update()
    torch.cuda.synchronize()
    update_ms = (time.perf_counter() - t0) / 2 * 1e3
    update_peak = torch.cuda.max_memory_allocated() / 2**30
    profiled_epochs = epochs if trainer == "a2c" else PPO_REC_PROFILED_EPOCHS
    profiled_ms = update_ms
    if profiled_epochs != epochs:
        t0 = time.perf_counter()
        for _ in range(2):
            update(profiled_epochs)
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) / 2 * 1e3
    part = update if profiled_epochs == epochs else lambda: update(profiled_epochs)
    update_busy, update_ops, _ = _busy(read_profile(profiled(part, ("cpu", "cuda")))[0], 1, skip=(f"{trainer}/",))
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
    step_busy, step_ops, _ = _busy(read_profile(profiled(lambda: [rollout_step() for _ in range(20)], ("cpu", "cuda")))[0], 20,
                                   skip=(f"{trainer}/",))  # fmt: skip
    optimizer_steps = epochs * -(-n // mb) if trainer == "ppo_recurrent" else 1
    result = {
        "update": {"host_wall_ms": update_ms, "profiled_epochs": profiled_epochs, "epochs": epochs, "profiled_host_wall_ms": profiled_ms,
                   "device_busy_ms": update_busy, "idle_share": max(0.0, 1 - update_busy / profiled_ms), "device_ops": update_ops,
                   "optimizer_steps": optimizer_steps, "rows_or_sequences": n, "peak_gib": update_peak},
        "rollout_step": {"host_wall_ms": step_ms, "device_busy_ms": step_busy, "idle_share": max(0.0, 1 - step_busy / step_ms),
                         "device_ops": step_ops, "peak_gib": step_peak, "num_envs": E},
    }  # fmt: skip
    log(f"{what}: update ({optimizer_steps} optimizer step(s) over {n} {'rows' if trainer == 'a2c' else 'sequences'}) {update_ms:.2f} ms host "
        f"wall; its first {profiled_epochs} of {epochs} epoch(s) {profiled_ms:.2f} ms host wall, {update_busy:.3f} ms device busy (idle "
        f"{result['update']['idle_share']:.3f}), {update_ops:.0f} device operations; peak "
        f"{update_peak:.2f} GiB; rollout step (player forward + one copy to the host, {E} envs) {step_ms:.3f} ms host wall, {step_busy:.3f} "
        f"ms busy (idle {result['rollout_step']['idle_share']:.3f}), {step_ops:.0f} operations")  # fmt: skip
    return result


# Recurrent PPO's update is profiled over its first epoch (8 of its 64
# AdamW steps; the whole update until the telemetry phases 51-53 needed the
# time: profiling it took 48.0 of the phase's 53.7 s on an NVIDIA H100
# 80GB HBM3 at 700 W).
PPO_REC_PROFILED_EPOCHS = 1
PPO_PROFILED_EPOCHS = 1  # phase_ppo_profile's profiled part of the update (cut to make room for phases 54-57)


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
# iterations of random prefill (a window is 64 rows), then gradient steps at
# the cut replay ratio (``P2E_CUTS``: 2 in all, one each side of the
# checkpoint at the first training iteration); finetuning plays the
# exploration actor for its 64 prefill iterations (there is no random
# prefill) and takes as many DreamerV3 steps.
P2E_DEPTH, P2E_HIDDEN = 5120, 4096
P2E_BATCH, P2E_SEQ, P2E_HORIZON, P2E_ENVS = 16, 64, 15, 4
P2E_IMAGINED = P2E_BATCH * P2E_SEQ  # 1024
P2E_FWD_BY_BATCH = {P2E_BATCH: P2E_SEQ, P2E_IMAGINED: 2 * P2E_HORIZON}
P2E_BWD_BY_BATCH = {P2E_BATCH: P2E_SEQ}
P2E_FT_FWD_BY_BATCH = {P2E_BATCH: P2E_SEQ, P2E_IMAGINED: P2E_HORIZON}
# Cut to 2 gradient steps (from 8, then 4 for phases 54-57, by the replay
# ratio) to keep the whole script under 1000 s with phases 58-60.
P2E_CUTS = {"algo.learning_starts": "256 (from 1024)", "algo.total_steps": "260 (from 5000000)", "algo.replay_ratio": "0.25 (from 1; 2 gradient steps)",
            "checkpoint.every": "256 (from 100000)", "metric.log_every": "256 (from 5000)"}  # fmt: skip
P2E_ARGS = ["exp=p2e_dv3_exploration", "env=dummy", "algo.learning_starts=256", "algo.total_steps=260", "algo.replay_ratio=0.25",
            "checkpoint.every=256", "metric.log_every=256", "checkpoint.save_last=True"]  # fmt: skip
P2E_STEPS, P2E_RESUMED_FROM = 2, 1
P2E_FT_CUTS = {"algo.learning_starts": "256 (from 16384)", "algo.total_steps": "260 (from 1000000)", "algo.replay_ratio": "0.25 (from 1; 2 gradient steps)",
               "checkpoint.every": "0 (from 100000)", "metric.log_every": "256 (from 5000)"}  # fmt: skip
P2E_FT_ARGS = ["exp=p2e_dv3_finetuning", "env=dummy", "algo.learning_starts=256", "algo.total_steps=260", "algo.replay_ratio=0.25",
               "checkpoint.every=0", "metric.log_every=256", "checkpoint.save_last=True"]  # fmt: skip
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
    evaluation = defer_eval(out["checkpoints"][-1], out["test_reward"], f"{what} eval")
    result = _p2e_resume_and_finetune(what, out, full, ckpt, fwd_by_batch, bwd_by_batch, steps_total, resumed_from, ft_args, ft_cuts,
                                      ft_fwd, ft_bwd, log_root, agent_cls, kernels, ft_resume)  # fmt: skip
    result["evaluation"] = evaluation
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


@contextmanager
def unwritten_checkpoints():
    """The Dreamer loops' checkpoints named but not written, for a run
    whose saves nothing reads (P2E's resumed exploration runs, held
    against the uninterrupted run in memory): each of P2E-XL's is a
    multi-GB write, a sha256 and an fsync."""
    from sheeprl_tpu_torch.algos.dreamer_v2 import dreamer_v2 as dv2
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3

    def named(path, state, keep_last=None, world_size=1):
        return os.path.abspath(path)

    with patched(dv2, "save_checkpoint", named), patched(dv3, "save_checkpoint", named):
        yield


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
    with unwritten_checkpoints():
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
    finetuning["evaluation"] = defer_eval(tuned["checkpoints"][-1], tuned["test_reward"], f"{what} finetuning eval")
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
    remove_after_evals(tuned["log_dir"])
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
    width, cut (``P2E_CUTS``) to 2 gradient steps of 64 + 30 forwards and 64
    backwards each, then its resume, ``eval``, and finetuning (``P2E_FT_CUTS``,
    DreamerV3's 64 + 15 forwards a step) with its ``eval`` (:func:`p2e_chain`)."""
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import DV3Agent

    result, out = p2e_chain("p2e training", P2E_ARGS, P2E_CUTS, P2E_FWD_BY_BATCH, P2E_BWD_BY_BATCH, P2E_TAGS, P2E_FT_ARGS, P2E_FT_CUTS,
                            P2E_FT_FWD_BY_BATCH, P2E_BWD_BY_BATCH, log_root, DV3Agent)  # fmt: skip
    return result, out


# The P2E-DV3-XL step profile's steps (2 until phase 62 needed the time).
P2E_PROFILE_STEPS = 1


def phase_p2e_profile(agent, steps: int = P2E_PROFILE_STEPS):
    """(33) Where one P2E-DV3 exploration step's time goes at XL width
    (32-true, B = 16, T = 64, the trained agent; :func:`step_profile`).
    Alone: ``c.phase_p2e_profile(out["agent"])`` after
    ``c.phase_p2e_training(dir)``."""
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
    kernels_ms, averages = {}, read_profile(prof)[0]
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
    # The same f32 differences and f64 norms, on the card where there is one (the host took 2 s a call on SAC-AE's leaves).
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    gs, gp, ws, wp = ({k: v.to(dev) for k, v in t.items()} for t in (gs, gp, ws, wp))
    leaf = {}
    for k in wp:
        g, w = (gp[k] - gs[k]).double(), (wp[k] - ws[k]).double()
        leaf[k] = ((g - w).norm() / w.norm()).item() if w.norm() > 0 else float(g.norm() > 0)
    mk, top = max(metric, key=metric.get), sorted(leaf, key=leaf.get, reverse=True)[:3]
    w, dg = wp[top[0]], (gp[top[0]] - gs[top[0]]).flatten()
    dw = (w - ws[top[0]]).flatten()
    d = (dg - dw).abs().double()
    ulps = d / (torch.nextafter(w.abs(), torch.tensor(math.inf, device=dev)) - w.abs()).flatten().double()
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

    def late_update(ensemble, optimizer, *rest, **kwargs):
        return real_update(ensemble, Later(optimizer), *rest, **kwargs)

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
    remove_after_evals(out["log_dir"])
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
    remove_after_evals(out["log_dir"])
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
    evaluation = defer_eval(out["checkpoints"][-1], out["test_reward"], "sac_ae eval")
    t0 = time.perf_counter()
    again, resumed = offpolicy_through_cli([*SAC_AE_ARGS, f"checkpoint.resume_from={ckpt}"], SAC_AE_CUTS, "sac_ae resume", log_root)
    resume_s = time.perf_counter() - t0
    (pa, aa), (pb, ab) = _state_of(out), _state_of(again)
    differ = [k for k in pa if not torch_equal_bits(pa[k], pb[k])] + [k for k in aa if not torch_equal_bits(aa[k], ab[k])]
    if differ or pa.keys() != pb.keys() or aa.keys() != ab.keys() or again["gradient_steps"] != out["gradient_steps"]:
        fail(f"sac_ae resume: the resumed run ends off the uninterrupted one: {differ[:5]}")
    log(f"sac_ae resume: from {os.path.basename(ckpt)} the run ends on the uninterrupted run's {len(pa)} parameter and {len(aa)} Adam tensors "
        f"bit for bit, in {resume_s:.1f} s; flags met {len(set(flags))} of 8 combinations over {len(flags)} gradient steps")  # fmt: skip
    remove_after_evals(out["log_dir"])
    shutil.rmtree(again["log_dir"], ignore_errors=True)
    return {"host": host, "resume": {**resumed, "wall_s": resume_s, "tensors_bit_for_bit": len(pa) + len(aa)}, "evaluation": evaluation,
            "flag_combinations": len(set(flags)), "seconds_per_gradient_step": host["wall_s"] / host["gradient_steps"]}  # fmt: skip


SAC_AE_START: dict = {}  # seed -> the CPU-initialised agent's state: its orthogonal init takes about 2.7 s at the recipe's widths


def _sac_ae_setup(where, batch, seed=7):
    """A recipe-width SAC-AE agent on ``where`` (initialised on the CPU from
    ``seed`` once, then loaded from that state), its optimizers and config,
    at ``per_rank_batch_size`` ``batch``."""
    from sheeprl_tpu_torch.algos.sac_ae.agent import build_agent
    from sheeprl_tpu_torch.algos.sac_ae.sac_ae import make_optimizers
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.envs.dummy import ContinuousDummyEnv

    cfg = compose(["exp=sac_ae", "env=dummy", "env.id=continuous_dummy", f"algo.per_rank_batch_size={batch}", f"device={where}"])
    cfg.env.screen_size = 64
    env = ContinuousDummyEnv(action_dim=int(cfg.env.wrapper.action_dim))
    if seed not in SAC_AE_START:
        SAC_AE_START[seed] = build_agent(cfg, env.observation_space, env.action_space, device="cpu", seed=seed).state_dict()
    agent = build_agent(cfg, env.observation_space, env.action_space, agent_state=SAC_AE_START[seed], device=where)
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
        busy, ops, annotated = _busy(read_profile(prof)[0], 1, skip=("sac_ae/",), by_kernel=kernels_ms)
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
    # The evaluations of the P2E chains, SAC-AE and the Anakin lane, beside the card-against-CPU references (which time nothing).
    with evals_beside("new reference"):
        new_reference = phase_new_reference()
    took = time.perf_counter() - t0
    log(f"p2e_dv1, sac_ae: phases 37-41 took {took:.1f} s")
    return {"p2e_dv1": p2e_dv1, "sac_ae": sac_ae, "sac_ae_profile": sac_ae_profile, "new_reference": new_reference, "phases_37_41_s": took}


# The Anakin lane (phases 42-46): the batched envs on the card, the LN-GRU
# at the lane's shapes, and exp=dreamer_v3_anakin, exp=ppo_anakin and
# exp=sac_anakin through the CLI, each rollout one CUDA graph replay.
ANAKIN_ENVS = ("jax_cartpole", "jax_pendulum", "jax_gridworld")
ANAKIN_ENV_BATCH, ANAKIN_ENV_STEPS = 64, 300
ANAKIN_ENV_TOL = {"atol": 1e-5, "rtol": 1e-5}  # f32 physics: the card's sin, cos and modulo against the CPU's
DV3A_DEPTH, DV3A_HIDDEN = 1024, 512
DV3A_ENVS, DV3A_BATCH, DV3A_SEQ, DV3A_HORIZON, DV3A_SUPERSTEP = 4, 8, 32, 15, 16
DV3A_IMAGINED = DV3A_BATCH * DV3A_SEQ  # 256
DV3A_PROFILED_REPLAYS = 1  # of a superstep's 32 gradient-step replays, profiled (cut from 32 for phases 54-57, 8 for 58-60, 4 for 61, 2 for 62)
DV3A_CUTS = {"algo.total_steps": "1152 (from 100000: the 1024 prefill steps, then two supersteps of 64 with 32 gradient steps each)",
             "metric.log_every": "512 (from 5000)"}  # fmt: skip
DV3A_ARGS = ["exp=dreamer_v3_anakin", "algo.total_steps=1152", "metric.log_every=512"]
DV3A_BF16_CUTS = {"fabric.precision": "bf16-mixed (from 32-true)", "algo.learning_starts": "128 (from 1024)",
                  "algo.total_steps": "192 (from 100000: 2 prefill supersteps, then one of training)"}  # fmt: skip
DV3A_BF16_ARGS = ["exp=dreamer_v3_anakin", "fabric.precision=bf16-mixed", "algo.learning_starts=128", "algo.total_steps=192", "metric.log_every=192"]
# LN-GRU kernel nodes of each graph (32-true): the policy rollout's player, one a step at B = 4; a
# gradient step's dynamic scan (B = 8, T = 32) forward and backward and 15 imagined steps at B = 256.
DV3A_ROLLOUT_NODES = {"streaming": DV3A_SUPERSTEP, "tensor_core": 0, "backward": 0}
DV3A_STEP_NODES = {"streaming": DV3A_SEQ + DV3A_HORIZON, "tensor_core": 0, "backward": DV3A_SEQ}
DV3A_BF16_STEP_NODES = {"streaming": DV3A_SEQ, "tensor_core": DV3A_HORIZON, "backward": DV3A_SEQ}
# Cut from 4096 (8 supersteps) and 2048 (4 prefill supersteps, then 4 of
# training) to make room for phases 58-60 under 1000 s: the SAC host lane's
# 1024 training steps took 12 s at its 82 env steps/s.
PPOA_CUTS = {"algo.total_steps": "2048 (from 65536: 4 supersteps of 128 steps x 4 envs)", "metric.log_every": "1024 (from 5000)"}
PPOA_ARGS = ["exp=ppo_anakin", "algo.total_steps=2048", "metric.log_every=1024"]
SACA_CUTS = {"algo.total_steps": "1024 (from 65536: 2 prefill supersteps of 64 x 4 envs, then 2 of training)",
             "algo.learning_starts": "512 (from 1024)", "metric.log_every": "512 (from 5000)"}  # fmt: skip
SACA_ARGS = ["exp=sac_anakin", "algo.total_steps=1024", "algo.learning_starts=512", "metric.log_every=512"]


def phase_anakin_envs():
    """(42) Each batched env on the card against the same env on the CPU:
    ``ANAKIN_ENV_BATCH`` envs, ``ANAKIN_ENV_STEPS`` steps of the lane's
    step with same-step autoreset (``fused_loop.env_step_and_reset``), each
    from the CPU's state copied to the card, with the same actions and the
    same reset draws (made on the CPU, injected through ``reset_with``).
    The step's outputs and the carried state, observation and episode
    stats: integers, flags and pixels exact; f32 within ``ANAKIN_ENV_TOL``."""
    import torch

    from sheeprl_tpu_torch.core.fused_loop import env_step_and_reset
    from sheeprl_tpu_torch.envs.anakin import make_anakin_env

    dev, n = torch.device("cuda"), ANAKIN_ENV_BATCH
    out = {}
    for name in ANAKIN_ENVS:
        cpu_env, card_env = make_anakin_env(name).to("cpu"), make_anakin_env(name).to(dev)
        gen = torch.Generator().manual_seed(7)
        state, obs = cpu_env.reset(gen, n)
        local = {"env": state, "obs": obs, "ep_ret": torch.zeros(n), "ep_len": torch.zeros(n, dtype=torch.int32)}
        worst, ends = 0.0, {"terminated": 0, "truncated": 0}

        def same(got, want, what):
            nonlocal worst
            got = got.cpu()
            if want.dtype.is_floating_point:
                gap = (got - want).abs()
                worst = max(worst, float(gap.max()))
                if not bool((gap <= ANAKIN_ENV_TOL["atol"] + ANAKIN_ENV_TOL["rtol"] * want.abs()).all()):
                    fail(f"anakin env {name}: {what} on the card differs from the CPU's by {float(gap.max())}")
            elif not torch.equal(got, want):
                fail(f"anakin env {name}: {what} on the card differs from the CPU's")

        for t in range(ANAKIN_ENV_STEPS):
            if name == "jax_pendulum":
                actions = torch.rand((n, 1), generator=gen) * 5.0 - 2.5  # past the torque's bounds: clipped
            else:
                actions = torch.randint(0, 2 if name == "jax_cartpole" else 4, (n,), generator=gen)
            draws = cpu_env.sample_reset(gen, n)
            card = {k: ({j: u.to(dev) for j, u in v.items()} if isinstance(v, dict) else v.to(dev)) for k, v in local.items()}
            (new_obs, reward, done, info), stats = env_step_and_reset(cpu_env, local, actions, lambda: cpu_env.reset_with(draws))
            card_draws = draws.to(dev)
            (c_obs, c_reward, c_done, c_info), c_stats = env_step_and_reset(card_env, card, actions.to(dev), lambda: card_env.reset_with(card_draws))
            for what, got, want in (("next obs", c_obs, new_obs), ("reward", c_reward, reward), ("done", c_done, done),
                                    ("terminated", c_info["terminated"], info["terminated"]), ("truncated", c_info["truncated"], info["truncated"]),
                                    ("episode stats", c_stats, stats), ("carried obs", card["obs"], local["obs"]),
                                    ("returns", card["ep_ret"], local["ep_ret"]), ("lengths", card["ep_len"], local["ep_len"]),
                                    *((f"state {k}", card["env"][k], local["env"][k]) for k in local["env"])):  # fmt: skip
                same(got, want, f"step {t}: {what}")
            for k in ends:
                ends[k] += int(info[k].sum())
        torch.cuda.synchronize()
        # The card's step alone, timed: E envs, a step and a reset each.
        card_env_state, card_obs = card_env.reset(torch.Generator(device=dev).manual_seed(0), n)
        card_gen = torch.Generator(device=dev).manual_seed(1)
        act = torch.zeros((n, 1), device=dev) if name == "jax_pendulum" else torch.zeros(n, dtype=torch.long, device=dev)
        step_ms = device_ms(lambda: (card_env.step(card_env_state, act), card_env.reset(card_gen, n)), reps=5, inner=20)[0]
        out[name] = {"envs": n, "steps": ANAKIN_ENV_STEPS, "max_abs_err_f32": worst, "ends": ends, "card_step_and_reset_ms": step_ms}
        log(f"anakin env {name}: {n} envs x {ANAKIN_ENV_STEPS} steps on the card = the CPU's (ints, flags, pixels exact; f32 max |d| {worst:.3g}); "
            f"{ends['terminated']} terminations, {ends['truncated']} truncations; a step and a reset of all {n} on the card {step_ms * 1e3:.1f} us")
    return out


def phase_anakin_kernels():
    """(43) The LN-GRU at the lane's DreamerV3-S shapes (D = 1024, H =
    512): the streaming kernel at B = 4 (the player) and 8 (the dynamic
    scan), f32 and bf16, and at B = 256 (the imagination) in f32, with the
    backward at each (:func:`streaming_rows`); the tensor-core kernel at B =
    256 in bf16 (bf16-mixed's imagination), held to the plain version and
    timed beside it, its bound and cuBLAS's product alone."""
    import torch

    from sheeprl_tpu_torch.models.ln_gru import _aligned, _sm_count, forward_plan, ln_gru_forward, ln_gru_forward_tensor_core, ln_gru_plain

    rows = streaming_rows("anakin", DV3A_DEPTH, DV3A_HIDDEN, ((DV3A_ENVS, "player"), (DV3A_BATCH, "dynamic scan")), (torch.float32, torch.bfloat16), seed=11)
    rows += streaming_rows("anakin", DV3A_DEPTH, DV3A_HIDDEN, ((DV3A_IMAGINED, "imagination"),), (torch.float32,), seed=12)
    args = gru_inputs(DV3A_IMAGINED, DV3A_DEPTH, DV3A_HIDDEN, torch.bfloat16, seed=13)
    what = f"anakin ln_gru B={DV3A_IMAGINED} D={DV3A_DEPTH} H={DV3A_HIDDEN} bfloat16"
    plan = forward_plan(DV3A_IMAGINED, DV3A_DEPTH, DV3A_HIDDEN, torch.bfloat16, _sm_count(0), _aligned(args[0], args[1], args[5]))
    if plan.kernel != "tensor_core":
        fail(f"{what}: forward_plan picks {plan.kernel}")
    errs = check_forward(ln_gru_forward, args, what)
    errs_tc = check_forward(ln_gru_forward_tensor_core, args, f"{what} (tensor-core entry point)")
    kernel = timed(rotated(args, ln_gru_forward))
    plain_ms = device_ms(rotated(args, ln_gru_plain))[0]
    product_ms = device_ms(rotated(args[:2], torch.matmul))[0]
    check_one_launch(what, kernel_split_ms(rotated(args, ln_gru_forward)))
    bound_ms, bound_by = gru_bound(DV3A_IMAGINED, DV3A_DEPTH, DV3A_HIDDEN, "bfloat16")
    tc = {"shape": f"B={DV3A_IMAGINED} D={DV3A_DEPTH} H={DV3A_HIDDEN}", "batch": DV3A_IMAGINED, "dtype": "bfloat16", "kernel": plan.kernel,
          **errs, "tensor_core_entry_point": errs_tc, **kernel, "plain_ms": plain_ms, "product_library_ms": product_ms, "bound_ms": bound_ms,
          "bound_by": bound_by}  # fmt: skip
    log(f"{what} (imagination, bf16-mixed): tensor cores {kernel['ms'] * 1e3:.2f} us [{kernel['ms_min'] * 1e3:.2f}, {kernel['ms_max'] * 1e3:.2f}], "
        f"plain {plain_ms * 1e3:.2f} us, product alone {product_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us ({bound_by}), "
        f"max|dh| {errs['max_abs_err_h']:.3g}")  # fmt: skip
    del args
    torch.cuda.empty_cache()
    return {"streaming": rows, "tensor_core": tc}


def _lean_gaps(a, b):
    """:func:`_gaps` that converts a tensor to compute its max |a - b| only
    where the two differ (a 1.2 GB ring in f64 would take 10 GB)."""
    out = {}
    for group in a:
        same = [torch_equal_bits(x, y) for x, y in zip(a[group], b[group])]
        diffs = [0.0 if e else (x.float() - y.float()).abs().max().item() for e, x, y in zip(same, a[group], b[group])]
        out[group] = {"max_abs": max(diffs, default=0.0), "bit_for_bit": all(same)}
    return out


def _graph_vs_eager(what, rollouts, key):
    """A rollout's graph against its eager run from one snapshot of what it
    writes (``Rollouts.written``: the carry, the ring; PPO's parameters and
    Adam states) and of its generators: two eager runs and one replay, every
    tensor and the rollout's output bit for bit, or within the two eager
    runs' difference. Returns the gaps and the graph's nodes."""
    import torch

    step = rollouts.graphs[key]
    if step.graph is None:
        fail(f"{what}: the rollout {key} was never captured ({step.warmup_calls} eager calls)")
    tensors, gens = rollouts.written(), rollouts.generators
    torch.cuda.synchronize()
    snap = [t.clone() for t in tensors], [g.get_state() for g in gens]

    def restore():
        with torch.no_grad():
            for t, s in zip(tensors, snap[0]):
                t.copy_(s)
        for g, s in zip(gens, snap[1]):
            g.set_state(s)

    def result(output):
        torch.cuda.synchronize()
        return {"written": [t.clone() for t in tensors], "output": [output.clone()]}

    def eagerly():
        with rollouts.around():
            return step.fn()

    restore()
    eager_a = result(eagerly())
    restore()
    eager_b = result(eagerly())
    restore()
    step.graph.replay()
    graph = result(step.output)
    eager_gap, graph_gap = _lean_gaps(eager_a, eager_b), _lean_gaps(eager_a, graph)
    for group, gap in graph_gap.items():
        allowed = 0.0 if eager_gap[group]["bit_for_bit"] else eager_gap[group]["max_abs"]
        if not gap["bit_for_bit"] and gap["max_abs"] > allowed:
            differing = [(i, tuple(x.shape), str(x.dtype).split(".")[-1], (x.float() - y.float()).abs().max().item(), x.float().abs().max().item(),
                          y.float().abs().max().item()) for i, (x, y) in enumerate(zip(eager_a[group], graph[group])) if not torch_equal_bits(x, y)]  # fmt: skip
            fail(f"{what}: the graph's {group} differ from the eager run's by {gap['max_abs']} (two eager runs: {eager_gap[group]}); "
                 f"tensors differing (index, shape, dtype, max |d|, max |eager|, max |graph|): {differing[:12]} of {len(eager_a[group])}")  # fmt: skip
    nodes = {"nodes": step.nodes["nodes"], "by_type": step.nodes["by_type"], "ln_gru": step.nodes["ln_gru"]}
    log(f"{what}: rollout {key} replayed against its eager run from one snapshot ({len(tensors)} tensors written): eager vs eager "
        f"{json.dumps(eager_gap)}; graph vs eager {json.dumps(graph_gap)}; graph nodes {json.dumps(nodes)}")  # fmt: skip
    return {"eager_vs_eager": eager_gap, "graph_vs_eager": graph_gap, "graph": nodes}


def _cuts_text(args, cuts):
    return f"{' '.join(args)} (cut: {json.dumps(cuts)})"


def _check_counts(what, counts, expect_none=False):
    if expect_none and (counts["forward"] or counts["backward"]):
        fail(f"{what}: LN-GRU launches {counts}")


def _steady_env_steps_per_s(stamps, steps_between):
    """Env steps/s between the first and the last callback of a run (the
    first superstep, with its capture, falls before the first stamp)."""
    if len(stamps) < 2:
        return None
    return steps_between * (len(stamps) - 1) / (stamps[-1] - stamps[0])


def phase_dv3_anakin(workdir):
    """(44) ``exp=dreamer_v3_anakin`` through the CLI at the recipe's widths
    (DreamerV3-S, 64x64x3 pixels, 4 envs, batch 8 x 32, horizon 15, 32-true,
    the 100000-row ring on the card), cut as ``DV3A_CUTS``: the prefill in
    16 supersteps, then two training supersteps. Counts zeroed before, read
    after; every gradient step's metrics finite; the graphs' LN-GRU nodes
    (``DV3A_ROLLOUT_NODES`` a policy rollout, ``DV3A_STEP_NODES`` a gradient
    step); both rollouts' graphs against their eager runs; one superstep
    (a rollout replay and 32 gradient steps) and one rollout alone timed and
    profiled. Then a resume (one more superstep, ``algo.learning_starts=0``)
    and ``eval``; then bf16-mixed (``DV3A_BF16_CUTS``): the tensor-core
    kernel at B = 256 in the lane."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch.cli import run

    what = "dreamer_v3_anakin"
    common = [f"log_root={workdir}"]
    steps = []

    def on_step(agent, step, tau, metrics):
        bad = [k for k, v in metrics.items() if not torch.isfinite(v).all()]
        if bad:
            fail(f"{what}: non-finite metrics at gradient step {step}: {bad}")
        steps.append(step)

    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    out = run([*DV3A_ARGS, *common], callback=on_step)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = read_counts()
    stats, rollout = out["run_stats"], out["rollout"]["graphs"]
    if out["policy_steps"] != 1152 or out["gradient_steps"] != 66 or len(steps) != 66 or stats["supersteps"] != 18:
        fail(f"{what}: {out['policy_steps']} policy steps, {out['gradient_steps']} gradient steps, {stats}")
    if set(rollout) != {"c16_r1", "c16_r0"} or rollout["c16_r1"]["replays"] != 15 or rollout["c16_r0"]["replays"] != 1:
        fail(f"{what}: rollout graphs {rollout}")
    policy_nodes, step_nodes = rollout["c16_r0"]["graph"]["ln_gru"], out["fused"]["graph"]["ln_gru"]
    if policy_nodes != DV3A_ROLLOUT_NODES or step_nodes != DV3A_STEP_NODES or any(rollout["c16_r1"]["graph"]["ln_gru"].values()):
        fail(f"{what}: LN-GRU nodes: policy rollout {policy_nodes}, random rollout {rollout['c16_r1']['graph']['ln_gru']}, gradient step {step_nodes}")
    # The policy rollout's eager call and capture; the train step's 3 eager calls and capture (B = 1: the test episode's player).
    want_fwd = {DV3A_ENVS: 2 * DV3A_SUPERSTEP, DV3A_BATCH: 4 * DV3A_SEQ, DV3A_IMAGINED: 4 * DV3A_HORIZON}
    got_fwd = {b: n for b, n in counts["forward_by_batch"].items() if b != 1}
    if got_fwd != want_fwd or counts["backward_by_batch"] != {DV3A_BATCH: 4 * DV3A_SEQ} or counts["tensor_core"]:
        fail(f"{what}: LN-GRU launches {counts}, expected forwards by batch {want_fwd} and backwards {{8: {4 * DV3A_SEQ}}}")
    ring_bytes = out["device_buffer"]["bytes"]
    log(f"{what}: {_cuts_text(DV3A_ARGS, DV3A_CUTS)}; {out['policy_steps']} policy steps, {out['gradient_steps']} gradient steps in "
        f"{stats['supersteps']} supersteps, {wall_s:.1f} s; rollouts {json.dumps({k: {'warmup': v['warmup_calls'], 'replays': v['replays']} for k, v in rollout.items()})}, "
        f"train step {out['fused']['warmup_steps']} eager + {out['fused']['replays']} replays; ring {ring_bytes / 1e9:.3f} GB on the card; LN-GRU launches "
        f"(the eager calls and the captures) {json.dumps(counts)}; graph nodes: policy rollout {json.dumps(rollout['c16_r0']['graph']['by_type'])} with "
        f"LN-GRU {json.dumps(policy_nodes)} ({DV3A_SUPERSTEP} streaming at B = {DV3A_ENVS}: one a step), random rollout "
        f"{json.dumps(rollout['c16_r1']['graph']['by_type'])}, gradient step {json.dumps(out['fused']['graph']['by_type'])} with LN-GRU {json.dumps(step_nodes)}")  # fmt: skip
    graphs = {key: _graph_vs_eager(f"{what} graph vs eager", out["rollouts"], key) for key in ((16, True), (16, False))}

    # One superstep (the policy rollout's replay, then its 32 gradient steps' replays), and the rollout alone.
    rollouts, fused, ring = out["rollouts"], out["train_step"], out["ring"]
    moments = [out["moments"]]
    taus = np.zeros(2 * DV3A_SUPERSTEP, np.float32)

    def superstep(replays=2 * DV3A_SUPERSTEP):
        rollouts(DV3A_SUPERSTEP, False)
        moments[0] = fused(moments[0], ring.state, taus[:replays])[0]

    zero_counts()
    # The whole superstep timed; profiled: its rollout and its first DV3A_PROFILED_REPLAYS gradient-step replays.
    profile = _timed_per_step(superstep, 1, profile=False)
    profile["profiled_part"] = {"train_replays": DV3A_PROFILED_REPLAYS, **_timed_per_step(lambda: superstep(DV3A_PROFILED_REPLAYS), 1)}
    rollout_profile = _timed_per_step(lambda: rollouts(DV3A_SUPERSTEP, False), 1)
    if any(read_counts()[k] for k in ("forward", "backward")):
        fail(f"{what}: replays counted LN-GRU launches {read_counts()}")
    env_steps = DV3A_SUPERSTEP * DV3A_ENVS
    profile["env_steps_per_s"] = env_steps * 1e3 / profile["host_wall_ms_per_step"]
    rollout_profile["env_steps_per_s"] = env_steps * 1e3 / rollout_profile["host_wall_ms_per_step"]
    part = profile["profiled_part"]
    log(f"{what}: superstep (1 rollout replay + {2 * DV3A_SUPERSTEP} gradient-step replays): host wall {profile['host_wall_ms_per_step']:.3f} ms, peak "
        f"{profile['peak_gib']:.3f} GiB, {profile['env_steps_per_s']:.1f} env steps/s; profiled with {DV3A_PROFILED_REPLAYS} gradient-step replays: host wall "
        f"{part['host_wall_ms_per_step']:.3f} ms, device busy {part['device_busy_ms_per_step']:.3f} ms, idle {part['idle_share']:.3f}, "
        f"{part['device_ops_per_step']:.0f} device operations")  # fmt: skip
    p = rollout_profile
    log(f"{what}: rollout alone (16 steps x 4 envs): host wall {p['host_wall_ms_per_step']:.3f} ms, device busy {p['device_busy_ms_per_step']:.3f} ms, idle "
        f"{p['idle_share']:.3f}, {p['device_ops_per_step']:.0f} device operations, peak {p['peak_gib']:.3f} GiB, {p['env_steps_per_s']:.1f} env steps/s")
    ckpt, test_reward = out["checkpoints"][-1], out["test_reward"]
    del rollouts, fused, ring, out, moments, superstep
    gc.collect()
    torch.cuda.empty_cache()

    evaluation = defer_eval(ckpt, test_reward, f"{what} eval")
    zero_counts()
    # Without the ring in the checkpoint the resumed run waits learning_starts (0 here) from its
    # start, and the restored Ratio trains again in the second superstep, as the host lane does.
    resumed = run([*DV3A_ARGS[:1], "algo.total_steps=1280", "algo.learning_starts=0", f"checkpoint.resume_from={ckpt}", *common])
    if resumed["policy_steps"] != 1280 or resumed["gradient_steps"] <= 66:
        fail(f"{what}: resumed to {resumed['policy_steps']} policy steps and {resumed['gradient_steps']} gradient steps, expected 1280 and more than 66")
    resume = {"from": ckpt, "policy_steps": resumed["policy_steps"], "gradient_steps": resumed["gradient_steps"], "run_stats": resumed["run_stats"]}
    del resumed
    gc.collect()
    torch.cuda.empty_cache()

    # bf16-mixed: the tensor-core kernel at B = 256 in the lane.
    zero_counts()
    bf16 = run([*DV3A_BF16_ARGS, *common])
    bf16_counts = read_counts()
    bf16_nodes = bf16["fused"]["graph"]["ln_gru"]
    if bf16_counts["tensor_core"] != 4 * DV3A_HORIZON or bf16_counts["forward_by_batch"].get(DV3A_IMAGINED) != 4 * DV3A_HORIZON or bf16_nodes != DV3A_BF16_STEP_NODES:
        fail(f"{what} bf16-mixed: LN-GRU launches {bf16_counts}, gradient step nodes {bf16_nodes}, expected {4 * DV3A_HORIZON} tensor-core launches "
             f"at B = {DV3A_IMAGINED} and nodes {DV3A_BF16_STEP_NODES}")  # fmt: skip
    log(f"{what} bf16-mixed: {_cuts_text(DV3A_BF16_ARGS, DV3A_BF16_CUTS)}; {bf16['gradient_steps']} gradient steps; LN-GRU launches "
        f"{json.dumps(bf16_counts)}; gradient step graph LN-GRU nodes {json.dumps(bf16_nodes)}")  # fmt: skip
    bf16_out = {"gradient_steps": bf16["gradient_steps"], "ln_gru_launches": bf16_counts, "graph_ln_gru": bf16_nodes, "run_stats": bf16["run_stats"]}
    shutil.rmtree(bf16["log_dir"], ignore_errors=True)
    del bf16
    gc.collect()
    torch.cuda.empty_cache()
    return {"cuts": DV3A_CUTS, "wall_s": wall_s, "run_stats": stats, "rollouts": rollout, "train_step_graph": step_nodes, "ln_gru_launches": counts,
            "ring_bytes": ring_bytes, "graph_vs_eager": {f"c{k[0]}_r{int(k[1])}": v for k, v in graphs.items()}, "superstep_profile": profile,
            "rollout_profile": rollout_profile, "resume": resume, "evaluation": evaluation, "bf16_mixed": bf16_out,
            "replays_per_superstep": {"rollout": 1, "train": 2 * DV3A_SUPERSTEP}}  # fmt: skip


def _lane_run(args, what, log_root, fused):
    """One run of an anakin exp through the CLI on one lane, with a
    timestamp at every callback (a PPO update, a SAC train call)."""
    import torch

    from sheeprl_tpu_torch.cli import run

    stamps = []
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    out = run([*args, f"algo.fused_rollout={fused}", f"log_root={log_root}"], callback=lambda *a: stamps.append(time.perf_counter()))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    _check_counts(what, read_counts(), expect_none=True)
    return out, stamps, wall_s


def cfg_total(args):
    """``algo.total_steps`` of an exp's argument list."""
    return int(next(a for a in args if a.startswith("algo.total_steps=")).split("=")[1])


def phase_onpolicy_offpolicy_anakin(workdir):
    """(45, 46) ``exp=ppo_anakin`` and ``exp=sac_anakin`` through the CLI at
    the recipes' widths (``PPOA_CUTS``, ``SACA_CUTS``) on the fused lane and
    on the host lane (``algo.fused_rollout=false``) on the same env, recipe
    and steps: graph replays per superstep (PPO: 1, its update inside; SAC:
    1 rollout and a replay per gradient step), env steps/s of both lanes
    between their first and last callbacks (PPO: updates; SAC: train
    calls), no LN-GRU launch; each fused rollout graph against its eager
    run; the fused run resumed one superstep further and evaluated."""
    import torch

    from sheeprl_tpu_torch.cli import run

    results = {}
    for algo, args, cuts in (("ppo", PPOA_ARGS, PPOA_CUTS), ("sac", SACA_ARGS, SACA_CUTS)):
        what = f"{algo}_anakin"
        fused, f_stamps, f_wall = _lane_run(args, what, workdir, True)
        host, h_stamps, h_wall = _lane_run(args, f"{what} host lane", workdir, False)
        stats, rollout = fused["run_stats"], fused["rollout"]["graphs"]
        supersteps = int(cfg_total(args)) // (128 * 4 if algo == "ppo" else 64 * 4)
        if algo == "ppo":
            T, E = 128, 4
            per_callback_fused = per_callback_host = T * E
            if not fused["updates"] == host["updates"] == supersteps or stats["rollout_replays"] != supersteps - 1 or rollout["c128_r0"]["graph"] is None:
                fail(f"{what}: {fused['updates']} and {host['updates']} updates, {stats}, {rollout}")
            replays = {"rollout_with_update": 1}
            keys = ((T, False),)
        else:
            E, chunk = 4, 64
            per_callback_fused, per_callback_host = chunk * E, E
            if fused["gradient_steps"] != host["gradient_steps"] or stats["supersteps"] != supersteps or set(rollout) != {"c64_r1", "c64_r0"}:
                fail(f"{what}: {fused['gradient_steps']} and {host['gradient_steps']} gradient steps, {stats}, {rollout}")
            replays = {"rollout": 1, "train_per_gradient_step": 1, "train_per_steady_superstep": chunk * E}
            keys = ((chunk, True), (chunk, False))
        for k, v in rollout.items():
            if v["graph"] is None or any(v["graph"]["ln_gru"].values()):
                fail(f"{what}: rollout {k} graph {v['graph']}")
        graphs = {f"c{k[0]}_r{int(k[1])}": _graph_vs_eager(f"{what} graph vs eager", fused["rollouts"], k) for k in keys}
        fused_sps, host_sps = _steady_env_steps_per_s(f_stamps, per_callback_fused), _steady_env_steps_per_s(h_stamps, per_callback_host)
        whole = (fused["policy_steps"] / f_wall, host["policy_steps"] / h_wall)
        log(f"{what}: {_cuts_text(args, cuts)}; fused lane {fused['policy_steps']} policy steps in {f_wall:.1f} s, run stats "
            f"{json.dumps(stats)}, rollouts {json.dumps({k: {'warmup': v['warmup_calls'], 'replays': v['replays'], 'nodes': v['graph']['nodes']} for k, v in rollout.items()})}; "
            f"graph replays per superstep {json.dumps(replays)}; env steps/s between the first and last callbacks: fused {fused_sps:.1f}, host lane "
            f"{host_sps:.1f} (fused/host {fused_sps / host_sps:.2f}); whole runs {whole[0]:.1f} and {whole[1]:.1f} (set-up, captures and test episode included)")  # fmt: skip
        ckpt, test_reward = fused["checkpoints"][-1], fused["test_reward"]
        total = cfg_total(args) + per_callback_fused
        shutil.rmtree(host["log_dir"], ignore_errors=True)
        del fused, host
        gc.collect()
        torch.cuda.empty_cache()
        starts = ["algo.learning_starts=0"] if algo == "sac" else []
        evaluation = defer_eval(ckpt, test_reward, f"{what} eval")
        resumed = run([args[0], f"algo.total_steps={total}", *starts, f"checkpoint.resume_from={ckpt}", f"log_root={workdir}"])
        if resumed["policy_steps"] != total:
            fail(f"{what}: resumed to {resumed['policy_steps']} policy steps, expected {total}")
        del resumed
        gc.collect()
        torch.cuda.empty_cache()
        results[algo] = {"cuts": cuts, "run_stats": stats, "rollouts": {k: {kk: vv for kk, vv in v.items()} for k, v in rollout.items()},
                         "graph_replays_per_superstep": replays, "graph_vs_eager": graphs, "env_steps_per_s": {"fused": fused_sps, "host": host_sps},
                         "fused_vs_host": fused_sps / host_sps, "whole_run_env_steps_per_s": {"fused": whole[0], "host": whole[1]},
                         "wall_s": {"fused": f_wall, "host": h_wall}, "resumed_to": total, "evaluation": evaluation}  # fmt: skip
    return results


def phases_42_46(workdir):
    """Phases 42-46 (they run alone too, after ``kernels.build()``)."""
    t0 = time.perf_counter()
    envs = phase_anakin_envs()
    kernel_rows = phase_anakin_kernels()
    dv3 = phase_dv3_anakin(workdir)
    lanes = phase_onpolicy_offpolicy_anakin(workdir)
    took = time.perf_counter() - t0
    log(f"anakin lane: phases 42-46 took {took:.1f} s")
    return {"anakin_envs": envs, "anakin_kernels": kernel_rows, "dv3_anakin": dv3, "ppo_anakin": lanes["ppo"], "sac_anakin": lanes["sac"],
            "phases_42_46_s": took}  # fmt: skip


# ------------------------------------------------- phases 47-50: interaction
PIPE_ENVS, PIPE_WARMUP, PIPE_WINDOW, PIPE_PROFILED = 4, 4, 32, 2  # profiled steps 8 -> 4 for phases 54-57, 4 -> 2 for phase 61
PIPE_STEPS = 2 * PIPE_WINDOW  # timed steps of each variant: two windows, taken in turns with the others
PIPE_ARGS = ["exp=dreamer_v3_100k_ms_pacman", "env=dummy", f"env.num_envs={PIPE_ENVS}"]
PIPE_CUTS = {"env.num_envs": "4 (from 1: two slices of 2 envs)"}
PIPE_DEPTH, PIPE_HIDDEN = 1024, 512  # DV3-S's LN-GRU input (stochastic state + actions, through the dense layer) and width
PIPE_REF_TOL = 1e-3  # phase 6's 32-true card-against-CPU bound on the recurrent state
PPO_PIPE_ARGS = ["exp=ppo_atari", "env=dummy", "env.num_envs=4"]
# The loops through the CLI with the train call between the fetch and its
# harvest: the ring's captured step, the async fetch, two slices.
ASYNC_LOOP = ["buffer.device=True", "fabric.async_fetch=True", "env.pipeline_slices=2", "checkpoint.every=0", "checkpoint.save_last=False",
              "algo.run_test=False"]  # fmt: skip
ASYNC_LOOP_ARGS = {
    "dreamer_v3": ["exp=dreamer_v3_100k_ms_pacman", "env=dummy", "env.num_envs=4", "algo.learning_starts=264", "algo.total_steps=280",
                   "metric.log_every=16", *ASYNC_LOOP],
    "sac": ["exp=sac", "env=dummy", "env.id=continuous_dummy", "algo.learning_starts=64", "algo.total_steps=96", "metric.log_every=32", *ASYNC_LOOP],
}  # fmt: skip
ASYNC_LOOP_CUTS = {
    "dreamer_v3": {"env.num_envs": "4 (from 1: two slices of 2)", "algo.learning_starts": "264 (from 1024; 66 rows an env, a sequence is 64)",
                   "algo.total_steps": "280 (from 100000; 20 gradient steps, 12 with the train call in flight)",
                   "checkpoint": "none (from every 2000 and the last)", "algo.run_test": "False (from True)"},
    "sac": {"algo.learning_starts": "64 (from 100)", "algo.total_steps": "96 (from 1000000)", "checkpoint": "none (from every 50000 and the last)",
            "algo.run_test": "False (from True)"},
}  # fmt: skip
HARVEST_SHARE = 0.25  # a harvest's mean wait against a train call's mean time: at most this share
SACD_ARGS = ["exp=sac_decoupled", "env=dummy", "env.id=continuous_dummy", "fabric.devices=1", "fabric.player_device=host",
             "algo.learning_starts=64", "algo.total_steps=128", "checkpoint.every=96", "metric.log_every=32"]  # fmt: skip
SACD_CUTS = {"algo.learning_starts": "64 (from 100)", "algo.total_steps": "128 (from 1000000)", "fabric.devices": "1 (from 2)",
             "fabric.player_device": "host (from auto)"}  # fmt: skip
PPOD_ARGS = ["exp=ppo_decoupled", "env=dummy", "fabric.devices=1", "fabric.player_device=host", "algo.total_steps=1024", "checkpoint.every=512",
             "metric.log_every=512"]  # fmt: skip
PPOD_CUTS = {"algo.total_steps": "1024 (from 65536; 2 updates)", "fabric.devices": "1 (from 2)", "fabric.player_device": "host (from auto)"}


def _constant_draws():
    """A noise source whose uniforms are all 0.5 (Gumbel-max then picks the
    mode) and whose normals are 0: the DV3 player becomes a function of its
    inputs."""
    import torch

    from sheeprl_tpu_torch.utils.distribution import BatchGenerator

    class ConstantDraws(BatchGenerator):
        def __init__(self):
            pass

        def rand(self, shape):
            return torch.full(tuple(shape), 0.5)

        def randn(self, shape):
            return torch.zeros(tuple(shape))

    return ConstantDraws()


def _dv3_player(precision, seed=5):
    """DV3-S's acting modules at ``exp=dreamer_v3_100k_ms_pacman``'s widths
    (random weights from ``seed``) on the card, and the config with 4 envs."""
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.algos.ppo.agent import actions_metadata
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.utils.env import make_vector_env

    cfg = compose([*PIPE_ARGS, "device=cuda"])
    envs = make_vector_env(cfg)
    actions_dim, continuous = actions_metadata(envs.single_action_space)
    return cfg, build_agent(actions_dim, continuous, cfg, envs.single_observation_space, precision=precision, device="cuda", seed=seed)


def _dv3_stepper(cfg, player, rng, slices=1, async_fetch=False, serial=False, greedy=False):
    """``step(n)``: n env steps of DV3's acting loop on ``cfg``'s dummy envs
    with ``player`` (its device is the player's), serially (the loop as it
    was: the player, ``.cpu()`` of its outputs, ``envs.step``) or through
    ``InteractionPipeline.interact`` (``slices``, ``async_fetch``); the done
    envs' state reset. ``trace`` holds each step's actions and state obs,
    ``state()`` the player's state, ``pipeline`` the pipeline."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch.core.interact import InteractionPipeline, tree_concat
    from sheeprl_tpu_torch.utils.env import make_vector_env
    from sheeprl_tpu_torch.utils.utils import normalize_obs, prepare_obs

    cfg.env.pipeline_slices = slices
    envs = make_vector_env(cfg)
    keys, cnn = list(cfg.algo.cnn_keys.encoder) + list(cfg.algo.mlp_keys.encoder), tuple(cfg.algo.cnn_keys.encoder)
    dev, n = next(player.parameters()).device, int(cfg.env.num_envs)

    def prep(o, out=None):
        return prepare_obs({k: o[k] for k in keys}, cnn_keys=cnn, num_envs=len(o[keys[0]]), out=out)

    def act(prepared, state, key):
        obs_t = normalize_obs({k: torch.from_numpy(v).to(dev) for k, v in prepared.items()}, cnn)
        return player.player_step(state, obs_t, key if key is not None else rng, greedy=greedy)

    pipeline = InteractionPipeline(n, slices=slices, async_fetch=async_fetch)
    if not greedy:
        pipeline.set_key(rng)
    pipeline.init_state(lambda m, r: player.init_player_state(m))
    run = {"obs": pipeline.stash_obs(envs.reset(seed=cfg.seed)[0]), "state": player.init_player_state(n)}
    trace = []

    def policy(prepared, state, key):
        actions, real, new_state = act(prepared, state, key)
        return (actions.float(), real), new_state, key

    def step(count):
        for _ in range(count):
            if serial:
                actions_t, real_t, run["state"] = act(prep(run["obs"]), run["state"], rng)
                actions, real = actions_t.float().cpu().numpy(), real_t.cpu().numpy()
                run["obs"], _, terminated, truncated, _ = envs.step(real[:, 0])
            else:
                res = pipeline.interact(envs, run["obs"], policy, prepare=prep, to_env_actions=lambda h, m: h[1][:, 0])
                actions, run["obs"], terminated, truncated = res.outputs[0], res.obs, res.terminated, res.truncated
            mask = torch.from_numpy(np.logical_or(terminated, truncated).astype(np.float32))
            if mask.any():
                if serial:
                    run["state"] = player.reset_player_state(run["state"], mask.to(dev))
                else:
                    pipeline.map_state(lambda st, r: player.reset_player_state(st, mask[r[0] : r[1]].to(dev)))
            trace.append((np.array(actions), np.array(run["obs"]["rgb"][:, 0, 0, 0])))

    step.trace, step.pipeline = trace, pipeline
    step.state = lambda: run["state"] if serial else tree_concat(pipeline.states)
    return step


def _timed_in_turns(steppers, what, profile_steps=PIPE_PROFILED):
    """The variants ``steppers`` (name -> ``step(n)``) on one card in turns:
    ``PIPE_WARMUP`` steps of each, then ``PIPE_WINDOW`` steps of each in
    order and again in reverse order (A B C, C B A), each window's host wall
    ms per env step (ending in a synchronize) and its LN-GRU counts (zeroed
    just before, read just after); then device busy ms and operations per
    step from a profile of ``profile_steps`` more of each (none for a player
    on the host: 0). Per variant: the mean of its two windows, both windows,
    the last window's counts."""
    import torch

    for step in steppers.values():
        step(PIPE_WARMUP)
    walls, counts = {k: [] for k in steppers}, {}
    for name in [*steppers, *reversed(list(steppers))]:
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        steppers[name](PIPE_WINDOW)
        torch.cuda.synchronize()
        walls[name].append((time.perf_counter() - t0) * 1e3 / PIPE_WINDOW)
        counts[name] = read_counts()
    out = {}
    for name, step in steppers.items():
        busy, ops = 0.0, 0
        if profile_steps:
            busy, ops, _ = _busy(read_profile(profiled(lambda: step(profile_steps), ("cpu", "cuda")))[0], profile_steps)
            if busy <= 0.0:
                fail(f"{what} {name}: torch.profiler saw no device time")
        wall = statistics.mean(walls[name])
        out[name] = {"host_wall_ms_per_env_step": wall, "host_wall_ms_windows": walls[name], "device_busy_ms_per_env_step": busy,
                     "idle_share": max(0.0, 1 - busy / wall), "device_ops_per_env_step": ops, "ln_gru_launches": counts[name]}  # fmt: skip
    return out


def phase_pipeline(log_root):
    """(47) The interaction pipeline on the card with DV3-S's player
    (bf16-mixed, ``exp=dreamer_v3_100k_ms_pacman``'s widths, random weights,
    4 dummy envs; the variants timed in turns, ``_timed_in_turns``): one slice with the fetch
    blocking against the serial loop bit for bit (actions, obs, the player's
    state); the async fetch with the same actions bit for bit, no blocking
    fetch and a positive overlap share; two slices with the async fetch;
    the LN-GRU launched once a slice an env step (S at B = 4 / S); each
    timed (host wall, device busy per env step). Then in 32-true with the
    draws at their modes, two slices against one: the same actions, the
    recurrent state within ``PIPE_REF_TOL``. Then ppo_atari's rollout step
    (84x84x4 frames, 4 envs) serially and at two slices with the async
    fetch, and in the loop as it was before the pipeline
    (``_ppo_pipeline_timing``). Then DV3 and SAC through the CLI with the
    train call in flight (``_async_loop_run``), and the LN-GRU at the
    two-slice player's B = 2 in f32 and bf16 (``streaming_rows``)."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch.utils.distribution import BatchGenerator

    t0 = time.perf_counter()
    cfg, agent = _dv3_player("bf16-mixed")
    gen = lambda: BatchGenerator.from_seed(1, "cuda")  # noqa: E731
    serial = _dv3_stepper(cfg, agent, gen(), serial=True)
    runs = {"s1_sync": _dv3_stepper(cfg, agent, gen()), "s1_async": _dv3_stepper(cfg, agent, gen(), async_fetch=True),
            "s2_async": _dv3_stepper(cfg, agent, gen(), slices=2, async_fetch=True)}  # fmt: skip
    timings = _timed_in_turns({"serial": serial, **runs}, "pipeline")
    for name, run in runs.items():
        slices = run.pipeline.slices
        want = {PIPE_ENVS // slices: slices * PIPE_WINDOW}
        got = timings[name]["ln_gru_launches"]
        if got["forward"] != slices * PIPE_WINDOW or got["forward_by_batch"] != want or got["backward"]:
            fail(f"pipeline {name}: LN-GRU launches {got} in a window of {PIPE_WINDOW} env steps, expected {slices} a step ({want})")
        timings[name]["fetch"] = run.pipeline.stats.as_dict()
    n = PIPE_WARMUP + PIPE_STEPS + PIPE_PROFILED
    for name in ("s1_sync", "s1_async"):
        for t, (a, b) in enumerate(zip(serial.trace[:n], runs[name].trace[:n])):
            if not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])):
                fail(f"pipeline {name}: step {t}'s actions or obs differ from the serial loop's")
    for k, v in serial.state().items():
        if not torch.equal(v, runs["s1_sync"].state()[k]):
            fail(f"pipeline s1_sync: the player's {k} differs from the serial loop's after {n} steps")
    fetch = timings["s1_async"]["fetch"]
    if fetch["blocking_fetches"] != 0 or fetch["async_fetches"] != n or not fetch["overlap_fraction"] > 0:
        fail(f"pipeline s1_async: {fetch}")
    if timings["s1_sync"]["fetch"]["blocking_fetches"] != n:
        fail(f"pipeline s1_sync: {timings['s1_sync']['fetch']}")

    cfg32, agent32 = _dv3_player("32-true")
    greedy = {S: _dv3_stepper(cfg32, agent32, _constant_draws(), slices=S, greedy=True) for S in (1, 2)}
    greedy[1](PIPE_STEPS)
    zero_counts()
    greedy[2](PIPE_STEPS)
    greedy_counts = read_counts()
    mismatched = sum(int(not np.array_equal(a[0], b[0])) for a, b in zip(greedy[1].trace, greedy[2].trace))
    dh = max((greedy[1].state()[k].float() - greedy[2].state()[k].float()).abs().max().item() for k in greedy[1].state())
    if mismatched or dh > PIPE_REF_TOL:
        fail(f"pipeline: two slices against one in 32-true with the draws at their modes: {mismatched} steps' actions differ, max |d state| {dh}")
    del agent32, greedy
    ppo = _ppo_pipeline_timing()
    loops = {algo: _async_loop_run(algo, log_root) for algo in ASYNC_LOOP_ARGS}
    kernels_b2 = streaming_rows("pipeline", PIPE_DEPTH, PIPE_HIDDEN, ((PIPE_ENVS // 2, "player, two slices of 4 envs"),), (torch.float32, torch.bfloat16), seed=21)
    took = time.perf_counter() - t0
    for name, tm in timings.items():
        log(f"pipeline (47) DV3-S player, {name}: {tm['host_wall_ms_per_env_step']:.3f} ms host wall a env step (windows "
            f"{[round(w, 3) for w in tm['host_wall_ms_windows']]}), {tm['device_busy_ms_per_env_step']:.3f} ms "
            f"busy (idle {tm['idle_share']:.3f}), {tm['device_ops_per_env_step']:.0f} operations; LN-GRU {tm['ln_gru_launches']['forward_by_batch']}"
            + (f"; fetches {json.dumps({k: round(v, 6) for k, v in tm['fetch'].items()})}" if "fetch" in tm else ""))  # fmt: skip
    log(f"pipeline (47): one slice with the blocking fetch and with the async fetch = the serial loop bit for bit over {n} steps; two slices "
        f"against one in 32-true (greedy, draws at their modes): actions equal over {PIPE_STEPS} steps, max |d state| {dh:.3g} (limit "
        f"{PIPE_REF_TOL}); took {took:.1f} s")  # fmt: skip
    return {"cuts": PIPE_CUTS, "timings": timings, "s2_vs_s1_max_abs_state": dh, "s2_32_true_ln_gru_launches": greedy_counts,
            "ppo_atari_rollout_step": ppo, "async_loops": loops, "kernels_b2": kernels_b2, "took_s": took}  # fmt: skip


def _ppo_pipeline_timing():
    """ppo_atari's rollout step (the player, one copy of its outputs, the
    env step; 84x84 pixels, 4 stacked frames, the recipe's widths, random
    weights), timed in turns: the loop as ``algos/ppo/ppo.py`` ran it before
    the pipeline (``loop``: prepare, the player, ``.cpu()`` of its outputs,
    ``envs.step``) against the pipeline at one slice with the blocking fetch
    (``s1``, the default path), at 4 envs and at one env (PERF.md §5's
    rollout step is at one env), and at 4 envs in two slices with the async
    fetch."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch.algos.ppo.agent import actions_metadata, build_agent
    from sheeprl_tpu_torch.algos.ppo.ppo import rollout_outputs
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.core.interact import InteractionPipeline
    from sheeprl_tpu_torch.utils.env import make_vector_env
    from sheeprl_tpu_torch.utils.distribution import BatchGenerator
    from sheeprl_tpu_torch.utils.utils import prepare_obs

    steppers, pipelines = {}, {}
    variants = (("e4_loop", 4, 1, False), ("e4_s1", 4, 1, False), ("e4_s2_async", 4, 2, True), ("e1_loop", 1, 1, False), ("e1_s1", 1, 1, False))
    for name, envs_n, slices, async_fetch in variants:
        cfg = compose([*PPO_PIPE_ARGS, "device=cuda", f"env.num_envs={envs_n}", f"env.pipeline_slices={slices}", f"fabric.async_fetch={async_fetch}"])
        envs = make_vector_env(cfg)
        actions_dim, continuous = actions_metadata(envs.single_action_space)
        agent = build_agent(actions_dim, continuous, cfg, envs.single_observation_space, precision=cfg.fabric.precision, device="cuda", seed=cfg.seed)
        split, cnn = rollout_outputs(actions_dim, continuous), list(cfg.algo.cnn_keys.encoder)
        keys = cnn + list(cfg.algo.mlp_keys.encoder)
        pipeline = pipelines[name] = InteractionPipeline.from_config(cfg)
        pipeline.set_key(BatchGenerator.from_seed(0, "cuda"))

        @torch.no_grad()
        def policy(prepared, state, rng, agent=agent, continuous=continuous):
            actions, real, logprobs, values = agent.player_step({k: torch.from_numpy(v).to("cuda") for k, v in prepared.items()}, rng)
            return torch.cat([actions.float(), logprobs, values] + ([] if continuous else [real.float()]), -1), state, rng

        obs = {"o": pipeline.stash_obs(envs.reset(seed=cfg.seed)[0])}

        def step(count, envs=envs, pipeline=pipeline, split=split, keys=keys, cnn=cnn, obs=obs, policy=policy):
            for _ in range(count):
                res = pipeline.interact(
                    envs, {k: obs["o"][k] for k in keys}, policy,
                    prepare=lambda o, out=None: prepare_obs(o, cnn_keys=cnn, num_envs=len(o[keys[0]]), out=out),
                    to_env_actions=lambda h, m: split(h)[3].reshape(m),
                )  # fmt: skip
                obs["o"] = res.obs

        rng = BatchGenerator.from_seed(0, "cuda")

        @torch.no_grad()
        def loop_step(count, envs=envs, n=envs_n, split=split, keys=keys, cnn=cnn, obs=obs, agent=agent, continuous=continuous, rng=rng):
            for _ in range(count):
                prepared = prepare_obs({k: obs["o"][k] for k in keys}, cnn_keys=cnn, num_envs=n)
                actions, real, logprobs, values = agent.player_step({k: torch.from_numpy(np.ascontiguousarray(v)).to("cuda") for k, v in prepared.items()}, rng)
                host = torch.cat([actions.float(), logprobs, values] + ([] if continuous else [real.float()]), -1).cpu().numpy()
                obs["o"] = envs.step(split(host)[3].reshape(n))[0]

        steppers[name] = loop_step if name.endswith("_loop") else step
    out = _timed_in_turns(steppers, "ppo_atari rollout")
    for name in out:
        out[name]["fetch"] = pipelines[name].stats.as_dict() if not name.endswith("_loop") else None
        log(f"pipeline (47) ppo_atari rollout step, {name}: {out[name]['host_wall_ms_per_env_step']:.3f} ms host wall (windows "
            f"{[round(w, 3) for w in out[name]['host_wall_ms_windows']]}), {out[name]['device_busy_ms_per_env_step']:.3f} ms busy (idle "
            f"{out[name]['idle_share']:.3f})" + (f"; overlap {out[name]['fetch']['overlap_fraction']:.3f}" if out[name]["fetch"] else ""))  # fmt: skip
    for n in ("e4", "e1"):
        loop, s1 = out[f"{n}_loop"], out[f"{n}_s1"]
        out[f"{n}_s1_against_loop"] = {"ms": s1["host_wall_ms_per_env_step"] - loop["host_wall_ms_per_env_step"],
                                       "ratio": s1["host_wall_ms_per_env_step"] / loop["host_wall_ms_per_env_step"],
                                       "window_spread_ms": [max(v["host_wall_ms_windows"]) - min(v["host_wall_ms_windows"]) for v in (loop, s1)]}  # fmt: skip
        log(f"pipeline (47) ppo_atari rollout step at {n[1:]} env(s): the pipeline at one slice against the loop before it "
            f"{out[f'{n}_s1_against_loop']['ms']:+.3f} ms ({out[f'{n}_s1_against_loop']['ratio']:.3f}x); each one's two windows spread "
            f"{[round(x, 3) for x in out[f'{n}_s1_against_loop']['window_spread_ms']]} ms")  # fmt: skip
    return out


def _async_loop_run(algo, log_root):
    """``algo``'s loop through the CLI with ``ASYNC_LOOP_ARGS``: every train
    call's host wall (``train_timer``'s block, which ends when the call's
    device work has run) and every gradient step's losses (kept on the card
    until the run ends, so the callback syncs nothing); the losses finite, no
    blocking fetch, a positive overlap share, the harvest's mean wait under
    ``HARVEST_SHARE`` of a train call's mean time; the LN-GRU counts zeroed
    just before and read just after."""
    import importlib

    import torch

    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.utils.timer import timer

    module = importlib.import_module({"dreamer_v3": "sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3", "sac": "sheeprl_tpu_torch.algos.sac.sac"}[algo])
    what = f"pipeline (47) {algo} through the CLI, async"
    calls, losses = [], []
    real = module.train_timer

    @contextmanager
    def timed(device, watchdog=None):
        t0 = time.perf_counter()
        with real(device, watchdog):
            yield
        calls.append(time.perf_counter() - t0)

    def on_train(agent, step, *rest):
        for metrics in rest[-1] if isinstance(rest[-1], list) else [rest[-1]]:
            losses.append(torch.stack([v.detach().float().reshape(()) for v in metrics.values()]))

    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    with patched(module, "train_timer", timed):
        out = run([*ASYNC_LOOP_ARGS[algo], f"log_root={log_root}"], callback=on_train)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    stats, fused = out["interaction"], out["fused"]
    finite = bool(losses) and bool(torch.isfinite(torch.stack(losses)).all())
    wait_ms = stats["fetch_blocked_s"] * 1e3 / max(1, stats["async_fetches"])
    train_ms = statistics.mean(calls) * 1e3 if calls else 0.0
    result = {"cuts": ASYNC_LOOP_CUTS[algo], "gradient_steps": out["gradient_steps"], "fused": fused, "train_calls": len(calls),
              "train_call_ms_mean": train_ms, "train_call_ms_max": max(calls) * 1e3 if calls else 0.0, "harvest_wait_ms_mean": wait_ms,
              "timers_on": not timer.disabled, "fetch": stats, "ln_gru_launches": counts, "losses_finite": finite, "wall_s": wall}  # fmt: skip
    if not finite or not fused or fused["replays"] <= 0:
        fail(f"{what}: losses finite {finite}, the ring's graph {fused}")
    if stats["blocking_fetches"] != 0 or stats["async_fetches"] <= 0 or not stats["overlap_fraction"] > 0:
        fail(f"{what}: {stats}")
    if not train_ms or timer.disabled or wait_ms >= HARVEST_SHARE * train_ms:
        fail(f"{what}: a harvest waited {wait_ms:.4f} ms on the mean, a train call took {train_ms:.4f} ms (limit {HARVEST_SHARE} of it; timers on "
             f"{not timer.disabled})")  # fmt: skip
    if algo == "dreamer_v3" and not counts["forward_by_batch"].get(2):
        fail(f"{what}: no LN-GRU launch at the two-slice player's B = 2: {counts}")
    log(f"{what}: {out['gradient_steps']} gradient steps ({fused['replays']} graph replays) in {len(calls)} train calls of "
        f"{train_ms:.3f} ms on the mean; {stats['async_fetches']} async fetches, 0 blocking, overlap {stats['overlap_fraction']:.3f}, "
        f"a harvest waited {wait_ms:.4f} ms on the mean; losses finite; LN-GRU {counts['forward_by_batch']}; {wall:.1f} s")  # fmt: skip
    return result


def phase_placement():
    """(48) The player's placement on the card: ``auto`` resolves to the
    card (the probe's latency printed); ``host`` plays DV3-S on a CPU copy
    (bf16-mixed, the plain LN-GRU) with no LN-GRU launch on the card; the
    mirror's bytes, the host time to issue a push, the time until the copy
    has landed and the load into the CPU copy, in ``fresh`` and in
    ``async``; then in 32-true the CPU player from weights that came through
    the mirror against the card's player, the same draws: 5 steps, the
    same actions, the recurrent state within ``PIPE_REF_TOL``."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v3.agent import PLAYER_STATE
    from sheeprl_tpu_torch.core.player import PlayerPlacement, param_bytes
    from sheeprl_tpu_torch.utils.distribution import BatchGenerator
    from sheeprl_tpu_torch.utils.utils import dotdict, normalize_obs

    t0 = time.perf_counter()
    cuda = torch.device("cuda")
    cfg, agent = _dv3_player("bf16-mixed")
    nbytes = param_bytes(agent, PLAYER_STATE)
    auto = PlayerPlacement.resolve(dotdict({"fabric": {"player_device": "auto", "player_sync": "fresh"}}), cuda, nbytes=nbytes)
    latency = auto.probe_s
    if auto.device.type != "cuda" or not auto.on_mesh or latency is None:
        fail(f"placement: auto resolved to {auto.device} (probe {latency})")
    host = PlayerPlacement.resolve(dotdict({"fabric": {"player_device": "host", "player_sync": "fresh"}}), cuda, nbytes=nbytes)
    cpu_player = host.player(agent, PLAYER_STATE)
    if host.on_mesh or next(cpu_player.parameters()).device.type != "cpu":
        fail("placement: host did not put the player on the CPU")
    host_run = _timed_in_turns({"host": _dv3_stepper(cfg, cpu_player, BatchGenerator.from_seed(1, "cpu"))}, "placement", profile_steps=0)["host"]
    if host_run["ln_gru_launches"]["forward"] or host_run["ln_gru_launches"]["backward"]:
        fail(f"placement: the host player launched LN-GRU kernels on the card: {host_run['ln_gru_launches']}")
    mirror_times = {}
    for sync in ("fresh", "async"):
        placement = PlayerPlacement(torch.device("cpu"), cuda, sync, mode="host")
        placement.player(agent, PLAYER_STATE)
        issue, landed, load = [], [], []
        for _ in range(10):
            torch.cuda.synchronize()
            a = time.perf_counter()
            placement.push()
            b = time.perf_counter()
            placement.mirrors[0]._inflight[-1][0].event.synchronize()
            c = time.perf_counter()
            placement.player(agent, PLAYER_STATE)
            issue.append((b - a) * 1e3)
            landed.append((c - a) * 1e3)
            load.append((time.perf_counter() - c) * 1e3)
        mirror = placement.mirrors[0]
        mirror_times[sync] = {"bytes": mirror.nbytes, "issue_ms": statistics.median(issue), "landed_ms": statistics.median(landed),
                              "load_ms": statistics.median(load), "pushes": mirror.pushes, "skipped": mirror.skipped,
                              "gb_per_s": mirror.nbytes / statistics.median(landed) / 1e6}  # fmt: skip
    # 32-true: weights that came through the mirror on the CPU, against the card.
    _, agent32 = _dv3_player("32-true")
    mirrored = PlayerPlacement(torch.device("cpu"), cuda, "fresh", mode="host")
    mirrored.player(agent32, PLAYER_STATE)
    with torch.no_grad():
        for name, p in agent32.named_parameters():
            if name.startswith(PLAYER_STATE):
                p.mul_(1.01)
    mirrored.push()
    cpu32 = mirrored.player(agent32, PLAYER_STATE)
    if not all(torch.equal(a.cpu(), b) for (n, a), b in zip(agent32.state_dict().items(), cpu32.state_dict().values()) if n.startswith(PLAYER_STATE)):
        fail("placement: the CPU player's weights are not the card's after a push")
    rng = np.random.default_rng(1)
    obs = [torch.from_numpy(rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)) for _ in range(5)]
    traces = {}
    for where, player in (("cuda", agent32), ("cpu", cpu32)):
        draws, state, trace = BatchGenerator.from_seed(3, "cpu"), player.init_player_state(2), []
        for o in obs:
            _, real, state = player.player_step(state, normalize_obs({"rgb": o.to(where)}, ("rgb",)), draws)
            trace.append((state["recurrent_state"].float().cpu(), real.cpu()))
        traces[where] = trace
    worst = max((a[0] - b[0]).abs().max().item() for a, b in zip(traces["cuda"], traces["cpu"]))
    if any(not torch.equal(a[1], b[1]) for a, b in zip(traces["cuda"], traces["cpu"])) or worst > PIPE_REF_TOL:
        fail(f"placement: the CPU player from mirrored weights against the card's: actions differ or max |dh| {worst} > {PIPE_REF_TOL}")
    took = time.perf_counter() - t0
    log(f"placement (48): auto -> {auto.device} (probe: {latency * 1e3:.4f} ms a round trip; above 2 ms the start-up line would name host); host player (DV3-S bf16-mixed on the CPU, "
        f"{torch.get_num_threads()} torch threads): {host_run['host_wall_ms_per_env_step']:.2f} ms a env step, 0 LN-GRU launches on the card; mirror "
        f"{json.dumps({k: {kk: round(vv, 4) for kk, vv in v.items()} for k, v in mirror_times.items()})}; 32-true CPU player from mirrored weights "
        f"against the card: actions equal over 5 steps, max |dh| {worst:.3g}; took {took:.1f} s")  # fmt: skip
    return {"auto_device": str(auto.device), "probe_latency_ms": latency * 1e3, "player_bytes": nbytes, "torch_threads": torch.get_num_threads(),
            "host_player": host_run, "mirror": mirror_times, "cpu_vs_card_max_abs_dh": worst, "took_s": took}  # fmt: skip


def _recording(module, name, record):
    """``module.name`` (a trainer's step factory) wrapped so that its first
    call records the agent's state before and after, its inputs on the CPU,
    the metrics and the optimizers' moments."""
    import torch

    real = getattr(module, name)

    def factory(agent, optimizers, cfg, *rest):
        call = real(agent, optimizers, cfg, *rest)
        opts = optimizers.values() if isinstance(optimizers, dict) else [optimizers]

        def first(*args):
            if record:
                return call(*args)
            record["start"] = {k: v.detach().cpu().clone() for k, v in agent.state_dict().items()}
            record["args"] = [{k: v.detach().cpu().clone() for k, v in a.items()} if isinstance(a, dict) else a.detach().cpu().clone() for a in args]
            out = call(*args)
            names = {id(p): n for n, p in agent.named_parameters()}
            record["end"] = {k: v.detach().cpu().clone() for k, v in agent.state_dict().items()}
            record["metrics"] = {k: float(v) for k, v in out.items()}
            record["moments"] = {f"{m} {names[id(p)]}": opt.state[p][m].detach().cpu().clone() for opt in opts for p in opt.param_groups[0]["params"]
                                 for m in ("exp_avg", "exp_avg_sq")}  # fmt: skip
            return out

        return first

    return patched(module, name, factory)


def _replay_on_cpu(what, record, agent, optimizers, call, tol):
    """The recorded first call replayed on the CPU from the recorded state,
    inputs and fresh optimizers: the losses within ``tol['loss_rtol']``, each
    leaf's change and Adam moments within ``tol``."""
    import torch

    names = {id(p): n for n, p in agent.named_parameters()}
    opts = optimizers.values() if isinstance(optimizers, dict) else [optimizers]
    metrics = {k: float(v) for k, v in call(*record["args"]).items()}
    end = {k: v.detach().clone() for k, v in agent.state_dict().items()}
    moments = {f"{m} {names[id(p)]}": opt.state[p][m] for opt in opts for p in opt.param_groups[0]["params"] for m in ("exp_avg", "exp_avg_sq")}
    for k in metrics:
        if abs(record["metrics"][k] - metrics[k]) > tol["loss_atol"] + tol["loss_rtol"] * abs(metrics[k]):
            fail(f"{what}: {k} {record['metrics'][k]} on the card, {metrics[k]} on the CPU")
    moved = [k for k in end if not torch.equal(end[k], record["start"][k])]
    param = max(((g, k) for k, g in _relative_gaps({k: record["end"][k] for k in moved}, {k: end[k] for k in moved}, record["start"], record["start"]).items()))
    moment = max(((g, k) for k, g in _relative_gaps(record["moments"], moments).items()))
    if param[0] > tol["param_change"] or moment[0] > tol["adam_moment"]:
        fail(f"{what}: card against CPU, worst leaf change {param}, worst Adam moment {moment} (limits {tol})")
    return {"losses_card": record["metrics"], "losses_cpu": metrics, "worst_param_change": {"leaf": param[1], "gap": param[0]},
            "worst_adam_moment": {"leaf": moment[1], "gap": moment[0]}, "tolerance": tol}  # fmt: skip


def _decoupled_run(args, what, log_root):
    """One decoupled CLI run on the card with a host player, timed, its
    LN-GRU counts zeroed just before and read just after."""
    import torch

    from sheeprl_tpu_torch.cli import run

    zero_counts()
    t0 = time.perf_counter()
    out = run([*args, f"log_root={log_root}"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    if out["placement"]["device"] != "cpu" or out["placement"]["on_mesh"] or counts["forward"] or counts["backward"]:
        fail(f"{what}: player on {out['placement']['device']} ({out['placement']}), LN-GRU {counts}")
    params = [v for v in out["agent"].state_dict().values() if v.is_floating_point()]
    if not all(torch.isfinite(p).all() for p in params):
        fail(f"{what}: non-finite parameters")
    return out, wall, counts


def phase_sac_decoupled(log_root):
    """(49) ``exp=sac_decoupled`` on ``env=dummy`` (``continuous_dummy``) at
    the recipe's widths, ``fabric.devices=1 fabric.player_device=host``, in
    ``fresh`` and in ``async``: the player on the CPU, the trainer on the
    card, no LN-GRU launch; the first train call held against the CPU at
    ``phase_sac_reference``'s bounds; the ``fresh`` run resumed from its
    mid-run checkpoint and evaluated; host wall per iteration and the
    mirror's pushes, bytes and issue time."""
    import torch

    from sheeprl_tpu_torch.algos.sac import sac as sac_module
    from sheeprl_tpu_torch.algos.sac.agent import build_agent
    from sheeprl_tpu_torch.algos.sac.sac import make_optimizers, make_train_step
    from sheeprl_tpu_torch.cli import evaluation, run
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.envs.dummy import ContinuousDummyEnv

    t0 = time.perf_counter()
    result = {"cuts": SACD_CUTS}
    for sync in ("fresh", "async"):
        record = {}
        args = [*SACD_ARGS, f"fabric.player_sync={sync}"]
        with _recording(sac_module, "make_train_step", record):
            out, wall, counts = _decoupled_run(args, f"sac_decoupled {sync}", log_root)
        cfg = compose([*args, "device=cpu"])
        env = ContinuousDummyEnv(action_dim=int(cfg.env.wrapper.action_dim))
        agent = build_agent(cfg, env.observation_space, env.action_space, agent_state=record["start"], device="cpu")
        optimizers = make_optimizers(agent, cfg)
        reference = _replay_on_cpu(f"sac_decoupled {sync} first train call", record, agent, optimizers, make_train_step(agent, optimizers, cfg),
                                   {"loss_rtol": 1e-4, "loss_atol": 1e-6, "param_change": SAC_PARAM_CHANGE_TOL, "adam_moment": SAC_MOMENT_TOL})  # fmt: skip
        iters = int(cfg.algo.total_steps) // int(cfg.env.num_envs)
        result[sync] = {"gradient_steps": out["gradient_steps"], "host_wall_s": wall, "host_wall_ms_per_iteration": wall * 1e3 / iters,
                        "placement": out["placement"], "mirror_issue_ms_per_push": out["placement"]["push_s"] * 1e3 / max(1, out["placement"]["pushes"]),
                        "ln_gru_launches": counts, "first_call_card_vs_cpu": reference, "test_reward": out["test_reward"],
                        "last_checkpoint": out["checkpoints"][-1]}  # fmt: skip
        if sync == "fresh":
            mid = next(c for c in out["checkpoints"] if "ckpt_96_" in c)
            resumed = run([*args, f"checkpoint.resume_from={mid}", f"log_root={log_root}"])
            if resumed["gradient_steps"] != out["gradient_steps"]:
                fail(f"sac_decoupled: resumed to {resumed['gradient_steps']} gradient steps, the whole run took {out['gradient_steps']}")
            result[sync]["resumed_gradient_steps"] = resumed["gradient_steps"]
            result[sync]["eval_reward"] = evaluation([f"checkpoint_path={out['checkpoints'][-1]}"])
        log(f"sac_decoupled (49) {sync}: {out['gradient_steps']} gradient steps, {result[sync]['host_wall_ms_per_iteration']:.2f} ms host wall an iteration, "
            f"mirror {out['placement']['pushes']} pushes of {out['placement']['bytes']} bytes, {result[sync]['mirror_issue_ms_per_push']:.3f} ms to issue one, "
            f"{out['placement']['skipped']} skipped; first train call card vs CPU: worst leaf {reference['worst_param_change']}, worst moment "
            f"{reference['worst_adam_moment']}" + (f"; resumed from step 96 to {result[sync]['resumed_gradient_steps']} gradient steps, eval "
            f"{result[sync]['eval_reward']}" if sync == "fresh" else ""))  # fmt: skip
        del out
        torch.cuda.empty_cache()
    result["took_s"] = time.perf_counter() - t0
    return result


def phase_ppo_decoupled(log_root):
    """(50) ``exp=ppo_decoupled`` on ``env=dummy`` at the recipe's widths,
    ``fabric.devices=1 fabric.player_device=host``: the rollout and GAE on the
    CPU player, the update on the card, lockstep (``fresh``); no LN-GRU
    launch; the first update held against the CPU at ``PPO_REF_TOL``;
    resumed from its mid-run checkpoint and evaluated; host wall per
    iteration and the mirror's pushes, bytes and issue time."""
    from sheeprl_tpu_torch.algos.ppo import ppo_decoupled
    from sheeprl_tpu_torch.algos.ppo.agent import build_agent
    from sheeprl_tpu_torch.algos.ppo.ppo import make_update_pool
    from sheeprl_tpu_torch.cli import evaluation, run
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.core.onpolicy import make_optimizer

    t0 = time.perf_counter()
    record = {}
    with _recording(ppo_decoupled, "make_update_pool", record):
        out, wall, counts = _decoupled_run(PPOD_ARGS, "ppo_decoupled", log_root)
    cfg = compose([*PPOD_ARGS, "device=cpu"])
    obs_space, actions_dim, continuous = _ppo_spaces(cfg)
    agent = build_agent(actions_dim, continuous, cfg, obs_space, device="cpu", agent_state=record["start"])
    optimizer, _ = make_optimizer(agent, cfg)
    reference = _replay_on_cpu("ppo_decoupled first update", record, agent, optimizer, make_update_pool(agent, optimizer, cfg), PPO_REF_TOL)
    mid = next(c for c in out["checkpoints"] if "ckpt_512_" in c)
    resumed = run([*PPOD_ARGS, f"checkpoint.resume_from={mid}", f"log_root={log_root}"])
    if resumed["policy_steps"] != out["policy_steps"] or resumed["updates"] != 1:
        fail(f"ppo_decoupled: the resumed run ended at {resumed['policy_steps']} after {resumed['updates']} updates")
    eval_reward = evaluation([f"checkpoint_path={out['checkpoints'][-1]}"])
    updates = out["updates"]
    result = {"cuts": PPOD_CUTS, "updates": updates, "host_wall_s": wall, "host_wall_ms_per_iteration": wall * 1e3 / updates, "placement": out["placement"],
              "mirror_issue_ms_per_push": out["placement"]["push_s"] * 1e3 / max(1, out["placement"]["pushes"]), "ln_gru_launches": counts,
              "first_update_card_vs_cpu": reference, "eval_reward": eval_reward, "took_s": time.perf_counter() - t0}  # fmt: skip
    log(f"ppo_decoupled (50): {updates} updates, {result['host_wall_ms_per_iteration']:.1f} ms host wall an iteration (rollout of "
        f"{cfg.algo.rollout_steps} x {cfg.env.num_envs} on the CPU player, GAE, the update on the card), mirror {out['placement']['pushes']} pushes of "
        f"{out['placement']['bytes']} bytes, {result['mirror_issue_ms_per_push']:.3f} ms to issue one; first update card vs CPU: worst leaf "
        f"{reference['worst_param_change']}, worst moment {reference['worst_adam_moment']}; resumed, eval {eval_reward}")  # fmt: skip
    return result


def phases_47_50(workdir):
    """Phases 47-50 (they run alone too, after ``kernels.build()``)."""
    t0 = time.perf_counter()
    pipeline = phase_pipeline(workdir)
    placement = phase_placement()
    sacd = phase_sac_decoupled(workdir)
    ppod = phase_ppo_decoupled(workdir)
    took = time.perf_counter() - t0
    log(f"interaction layer: phases 47-50 took {took:.1f} s")
    return {"pipeline": pipeline, "placement": placement, "sac_decoupled": sacd, "ppo_decoupled": ppod, "phases_47_50_s": took}


# Phases 51-53: telemetry on the card. DV3-S through the CLI with
# telemetry=on, 1 env: 128 prefill steps then one gradient step per
# iteration. Only these are cut from exp=dreamer_v3_100k_ms_pacman: the
# host path 5 gradient steps with a torch.profiler window over 2 of them
# and a /metrics exporter, the ring path 9 (3 eager warm-ups, the capture, 5
# replays), no checkpoint, no test episode, the buffer in memory.
TELE_CUTS = {"algo.learning_starts": "128 (from 1024)", "algo.total_steps": "132 (host path, 5 gradient steps) and 136 (ring path, 9)",
             "metric.log_every": "128 (from 5000)", "algo.run_test": "False", "checkpoint.every": "0", "checkpoint.save_last": "False",
             "buffer.memmap": "False (from True)"}  # fmt: skip
TELE_ARGS = ["exp=dreamer_v3_100k_ms_pacman", "env=dummy", "algo.learning_starts=128", "metric.log_every=128", "algo.run_test=False",
             "checkpoint.every=0", "checkpoint.save_last=False", "buffer.memmap=False", "telemetry=on"]  # fmt: skip
TELE_HOST = ["algo.total_steps=132", "telemetry.profiler.start_step=129", "telemetry.profiler.stop_step=131"]
TELE_RING = ["algo.total_steps=136", "buffer.device=True"]
TELE_SHARE_TOL = 0.05  # the compute/infeed/host breakdown sums to 1 within this
TELE_FLOP_RTOL = 0.01  # the card's counted step FLOPs against the CPU's
TELE_COUNT_SHAPE = (16, 8)  # (T, B) of the counted card-vs-CPU step: imagination B = 128, the tensor cores' threshold in bf16
TELE_RUNS: dict = {}  # phase 51's host and ring runs: (out, host wall per gradient step, LN-GRU counts[, syncs])


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _telemetry_records(log_dir, what):
    from sheeprl_tpu_torch.telemetry.__main__ import load_records

    for name in ("trace.json", "telemetry.jsonl"):
        if not os.path.isfile(os.path.join(log_dir, name)):
            fail(f"{what}: no {name} in {log_dir}")
    with open(os.path.join(log_dir, "trace.json")) as fp:
        trace = json.load(fp)
    return load_records(os.path.join(log_dir, "telemetry.jsonl")), trace


def _costs(records):
    """The accountant's counted work per key, from the run's perf_costs line."""
    found = [r for r in records if r["type"] == "perf_costs"]
    if not found or found[-1]["failures"]:
        fail(f"telemetry: no counted work, or a failed count: {found[-1:] if found else 'no perf_costs line'}")
    return found[-1]["costs"]


def _check_shares(records, what):
    """Every log point that trained: perf/mfu and perf/hbm_bw_util in (0, 1],
    the breakdown summing to 1 within TELE_SHARE_TOL. Returns those points."""
    trained = [r for r in records if r["type"] == "counters" and r.get("step", -1) >= 0 and r["values"].get("perf/train_steps_per_s", 0) > 0]
    if not trained:
        fail(f"{what}: no log point published the goodput of a trained interval")
    for r in trained:
        v = r["values"]
        for key in ("perf/mfu", "perf/hbm_bw_util"):
            if not 0.0 < v.get(key, -1.0) <= 1.0:
                fail(f"{what}: {key} = {v.get(key)} at step {r['step']}, outside (0, 1]")
        total = sum(v[f"perf/step_time_breakdown_{k}"] for k in ("compute", "infeed", "host"))
        if abs(total - 1.0) > TELE_SHARE_TOL:
            fail(f"{what}: the breakdown sums to {total} at step {r['step']}")
    return [{k: r["values"][k] for k in r["values"] if k.startswith("perf/")} | {"step": r["step"]} for r in trained]


def _telemetry_run(args, what, scrape_port=None, count_syncs=False):
    """One DV3-S run through the CLI on the card: its output, the host wall
    per gradient step between the first and the last callback, the LN-GRU
    counts, the synchronising calls under sync_debug_mode("warn") (those
    between the first and the last callback per gradient step, and the
    run's), and the /metrics body scraped at the third gradient step."""
    import warnings

    import torch

    from sheeprl_tpu_torch.cli import run

    stamps, synced, scraped = [], [], []

    def on_step(agent, step, tau, metrics):
        stamps.append(time.perf_counter())
        synced.append(sum(1 for w in caught if "synchroniz" in str(w.message)))
        if scrape_port is not None and step == 3:
            with urllib.request.urlopen(f"http://127.0.0.1:{scrape_port}/metrics", timeout=30) as resp:
                scraped.append(resp.read().decode())

    torch.cuda.synchronize()
    zero_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if count_syncs:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            out = run(args, callback=on_step)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    counts = read_counts()
    syncs = {"per_gradient_step": (synced[-1] - synced[0]) / (len(synced) - 1) if len(synced) > 1 else float("nan"),
             "run": sum(1 for w in caught if "synchroniz" in str(w.message)), "gradient_steps": out["gradient_steps"]}  # fmt: skip
    wall = (stamps[-1] - stamps[0]) / (len(stamps) - 1) if len(stamps) > 1 else float("nan")
    return out, wall, counts, syncs, scraped[0] if scraped else None


def _counted_step_flops(dev, precision):
    """FLOPs and bytes of one eager DV3-S gradient step at TELE_COUNT_SHAPE on
    ``dev``, counted by the accountant's mode (the kernels by formula)."""
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import make_optimizers, make_train_step
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.serve.spaces import Box, DictSpace
    from sheeprl_tpu_torch.telemetry import perf
    from sheeprl_tpu_torch.utils.distribution import BatchGenerator
    from sheeprl_tpu_torch.utils.ops import init_moments

    cfg = compose(["exp=dreamer_v3_100k_ms_pacman", "env=dummy", f"fabric.precision={precision}"])
    space = DictSpace({"rgb": Box((64, 64, 3), "uint8", 0.0, 255.0)})
    agent = build_agent((9,), False, cfg, space, precision=precision, device=dev, seed=0, training=True)
    step = make_train_step(agent, make_optimizers(agent, cfg), cfg)
    data = _train_batch(*TELE_COUNT_SHAPE, 11, torch.device(dev))
    zero_counts()
    with perf.count_work() as count:
        step(init_moments(torch.device(dev)), data, BatchGenerator.from_seed(0, torch.device(dev)), 1.0)
    if count.reason is not None:
        fail(f"counted step on {dev}: {count.reason}")
    return {"flops": count.flops, "bytes": count.bytes, "ops": count.ops, "ln_gru_launches": read_counts()}


def phase_telemetry_training(workdir):
    """Phase 51: DV3-S through the CLI with telemetry on, the host path (a
    profiler window, a /metrics exporter) and the ring path: the files, the
    spans and counters, perf/mfu, perf/hbm_bw_util and the breakdown of every
    trained interval, the profiler trace's markers and LN-GRU kernels, the
    scrape; then one step's FLOPs counted on the card against the CPU."""
    from sheeprl_tpu_torch.telemetry import default_registry
    from sheeprl_tpu_torch.telemetry.profiling import PROFILE_MARKERS, count_markers

    t0 = time.perf_counter()
    port = _free_port()
    host_args = [*TELE_ARGS, *TELE_HOST, f"telemetry.metrics_port={port}", f"log_root={workdir}"]
    host, host_wall, host_counts, _, scraped = _telemetry_run(host_args, "telemetry host path", scrape_port=port)
    if not all(host_counts[k] for k in ("streaming", "tensor_core", "backward")):
        fail(f"telemetry host path: an LN-GRU kernel was not launched: {host_counts}")
    records, trace = _telemetry_records(host["log_dir"], "telemetry host path")
    host_shares = _check_shares(records, "telemetry host path")
    meta = records[0]
    if meta.get("type") != "meta" or meta.get("backend") != "cuda" or "H100" not in str(meta.get("device")):
        fail(f"telemetry host path: meta line {meta}")
    peaks = meta["peaks"]
    spans = sorted({r["name"] for r in records if r["type"] == "span"})
    final = [r for r in records if r["type"] == "counters"][-1]["values"]
    for name in ("train/dispatch", "train/bound", "replay/sample", "transfer/h2d_sync", "fetch/player_actions", "train/metric_fetch",
                 "interaction/dispatch/slice0", "loop/iteration", "Time/train_time"):  # fmt: skip
        if name not in spans:
            fail(f"telemetry host path: no {name} span in {spans}")
    prof_path = os.path.join(host["log_dir"], "profiler_trace", "trace_129_131.json")
    if not os.path.isfile(prof_path):
        fail(f"telemetry host path: no profiler trace at {prof_path}")
    markers = count_markers(prof_path)
    with open(prof_path) as fp:
        kernel_names = {e["name"] for e in json.load(fp)["traceEvents"] if e.get("cat") == "kernel"}
    ln_gru_names = sorted({m.group(0) for n in kernel_names for m in [re.search(r"ln_gru_\w+", n)] if m})
    if len(ln_gru_names) < 3 or not markers:
        fail(f"telemetry profiler window: {markers} of {PROFILE_MARKERS} markers, LN-GRU kernels {ln_gru_names}")
    if scraped is None or "perf_mfu" not in scraped or "device_get_bytes" not in scraped:
        fail(f"telemetry: the trainer's /metrics scrape lacks perf_mfu or device_get_bytes: {(scraped or '')[:400]}")
    registry = default_registry().snapshot()["counters"]

    ring, ring_wall, ring_counts, ring_syncs, _ = _telemetry_run([*TELE_ARGS, *TELE_RING, f"log_root={workdir}"], "telemetry ring path", count_syncs=True)
    # Phase 54 holds its health=on runs to these two (health off).
    TELE_RUNS.update(host=(host, host_wall, host_counts), ring=(ring, ring_wall, ring_counts, ring_syncs))
    ring_records, _ = _telemetry_records(ring["log_dir"], "telemetry ring path")
    ring_shares = _check_shares(ring_records, "telemetry ring path")
    ring_final = [r for r in ring_records if r["type"] == "counters"][-1]["values"]
    if ring_final.get("graph_captures", 0) < 1 or ring["fused"]["replays"] < 1:
        fail(f"telemetry ring path: {ring_final.get('graph_captures')} graph captures, {ring['fused']['replays']} replays")

    step_costs = {"host": _costs(records), "ring": _costs(ring_records)}
    card = _counted_step_flops("cuda", "bf16-mixed")
    cpu = _counted_step_flops("cpu", "32-true")
    gap = abs(card["flops"] - cpu["flops"]) / cpu["flops"]
    if gap > TELE_FLOP_RTOL or not all(card["ln_gru_launches"][k] for k in ("streaming", "tensor_core", "backward")):
        fail(f"telemetry: the counted step's FLOPs on the card {card['flops']:.6g} against the CPU's {cpu['flops']:.6g} ({gap:.3g}), "
             f"kernels {card['ln_gru_launches']}")  # fmt: skip
    result = {
        "cuts": TELE_CUTS, "peaks": peaks, "card": meta["device"], "power_limit": meta["power_limit"],
        "host": {"gradient_steps": host["gradient_steps"], "host_wall_s_per_gradient_step": host_wall, "shares": host_shares, "spans": spans,
                 "counters": {k: final[k] for k in sorted(final) if not k.startswith("perf/")}, "ln_gru_launches": host_counts,
                 "profiler": {"trace": os.path.relpath(prof_path, workdir), "markers": markers, "of": PROFILE_MARKERS, "ln_gru_kernels": ln_gru_names},
                 "metrics_scrape_lines": len(scraped.splitlines())},
        "ring": {"gradient_steps": ring["gradient_steps"], "host_wall_s_per_gradient_step": ring_wall, "shares": ring_shares,
                 "counters": {k: ring_final[k] for k in sorted(ring_final) if not k.startswith("perf/")}, "graph_nodes": ring["fused"]["graph"]["nodes"],
                 "syncs": ring_syncs, "ln_gru_launches": ring_counts},
        "registry_cuda": {k: v for k, v in registry.items() if k.startswith("cuda/")},
        "counted_step": {"shape": TELE_COUNT_SHAPE, "card_bf16": card, "cpu_32_true": cpu, "flops_rel_gap": gap},
        "run_step_costs": step_costs,
        "took_s": time.perf_counter() - t0,
    }  # fmt: skip
    log(f"telemetry (51): host path {host['gradient_steps']} gradient steps, {host_wall * 1e3:.1f} ms host wall each; perf/mfu "
        f"{[round(s['perf/mfu'], 6) for s in host_shares]}, perf/hbm_bw_util {[round(s['perf/hbm_bw_util'], 6) for s in host_shares]} against "
        f"{peaks['flops']:.4g} FLOP/s and {peaks['bytes_per_s']:.4g} B/s ({peaks['reference']}), breakdown "
        f"{[(round(s['perf/step_time_breakdown_compute'], 3), round(s['perf/step_time_breakdown_infeed'], 3), round(s['perf/step_time_breakdown_host'], 3)) for s in host_shares]}; "
        f"profiler window {markers} of {PROFILE_MARKERS} markers, LN-GRU kernels {ln_gru_names}; /metrics {result['host']['metrics_scrape_lines']} lines; "
        f"spans {spans}")  # fmt: skip
    log(f"telemetry (51): ring path {ring['gradient_steps']} gradient steps, {ring_wall * 1e3:.1f} ms host wall each, perf/mfu "
        f"{[round(s['perf/mfu'], 6) for s in ring_shares]}, perf/hbm_bw_util {[round(s['perf/hbm_bw_util'], 6) for s in ring_shares]}; "
        f"counters {json.dumps(result['ring']['counters'])}; registry {json.dumps(result['registry_cuda'])}")  # fmt: skip
    log(f"telemetry (51): the runs' counted work per train call: {json.dumps(step_costs)}")
    log(f"telemetry (51): one eager step at T, B = {TELE_COUNT_SHAPE}: {card['flops']:.6g} FLOPs on the card (bf16-mixed, the kernels by formula) "
        f"against {cpu['flops']:.6g} on the CPU (32-true, plain), gap {gap:.3g}; bytes {card['bytes']:.4g} / {cpu['bytes']:.4g}")  # fmt: skip
    return result, ring


def phase_telemetry_bits(workdir, ring_on):
    """Phase 52: the ring-path run of phase 51 with telemetry off: the
    synchronising calls per gradient step, the trained parameters and the
    graph's node count equal to the run with it on; host wall per gradient
    step of both (reported, not bounded)."""
    args = [a for a in (*TELE_ARGS, *TELE_RING) if a != "telemetry=on"] + [f"log_root={workdir}"]
    off, off_wall, _, off_syncs, _ = _telemetry_run(args, "telemetry off", count_syncs=True)
    on_out, on_wall, on_syncs = ring_on
    same = off["agent"].state_dict().keys() == on_out["agent"].state_dict().keys() and all(
        torch_equal_bits(a, b) for a, b in zip(off["agent"].state_dict().values(), on_out["agent"].state_dict().values())
    )
    if not same:
        fail("telemetry on and off: the trained parameters differ")
    if off_syncs != on_syncs:
        fail(f"telemetry on and off: synchronising calls {on_syncs} and {off_syncs}")
    if off["fused"]["graph"]["nodes"] != on_out["fused"]["graph"]["nodes"]:
        fail(f"telemetry on and off: the captured graph holds {on_out['fused']['graph']['nodes']} and {off['fused']['graph']['nodes']} nodes")
    if os.path.exists(os.path.join(off["log_dir"], "telemetry.jsonl")):
        fail("telemetry off wrote telemetry.jsonl")
    result = {"syncs": off_syncs, "graph_nodes": off["fused"]["graph"]["nodes"], "parameters_equal": True,
              "host_wall_ms_per_gradient_step": {"on": on_wall * 1e3, "off": off_wall * 1e3}}  # fmt: skip
    log(f"telemetry (52): on and off bit for bit ({len(off['agent'].state_dict())} tensors), {off_syncs['per_gradient_step']:.2f} synchronising calls per gradient "
        f"step after the first ({off_syncs['run']} in the run, prefill's included, over {off_syncs['gradient_steps']} steps) each, graph nodes {off['fused']['graph']['nodes']} each; host wall per gradient step on {on_wall * 1e3:.1f} ms, off "
        f"{off_wall * 1e3:.1f} ms (the ring path's replays, one run each)")  # fmt: skip
    return result


def phase_telemetry_serving(workdir, path=None):
    """Phase 53: the DV3-S policy server with request ids and trace context:
    requests with and without traceparent, the ids on every reply, the
    client's trace on the batch span, GET /metrics."""
    import numpy as np

    from sheeprl_tpu_torch.algos.dreamer_v3.serve import export_random
    from sheeprl_tpu_torch.serve.engine import InferenceEngine
    from sheeprl_tpu_torch.serve.server import PolicyServer
    from sheeprl_tpu_torch.telemetry import trace_context
    from sheeprl_tpu_torch.telemetry import tracer as tracer_mod

    if path is None:
        path = export_random(os.path.join(workdir, "dv3s_tele.policy"), name="dv3s", seed=0, precision="bf16-mixed")
    live = tracer_mod.Tracer()
    previous = tracer_mod.set_current(live)
    engine = InferenceEngine(max_batch=8, batch_window_s=0.002, device="cuda")
    engine.load("dv3s", path)
    server = PolicyServer(engine, host="127.0.0.1", port=0).start()
    client_trace = "ab" * 16
    rng = np.random.default_rng(0)
    replies = []
    try:
        for i in range(4):
            headers = {"Content-Type": "application/json"}
            if i % 2 == 0:
                headers |= {"traceparent": f"00-{client_trace}-{'cd' * 8}-01", "X-Request-Id": f"tele-{i}"}
            body = {"model": "dv3s", "session": "s", "obs": {"rgb": rng.integers(0, 256, (64, 64, 3), dtype=np.uint8).tolist()}}
            req = urllib.request.Request(server.address + "/v1/act", data=json.dumps(body).encode(), headers=headers, method="POST")
            with urllib.request.urlopen(req, timeout=60) as resp:
                replies.append((i, dict(resp.headers), json.loads(resp.read())))
        engine.stats()
        with urllib.request.urlopen(server.address + "/metrics", timeout=60) as resp:
            metrics = resp.read().decode()
    finally:
        server.close(drain=True)
        tracer_mod.set_current(previous)
    for i, headers, body in replies:
        parsed = trace_context.parse_traceparent(headers.get("traceparent"))
        if parsed is None or headers.get("X-Request-Id") != body.get("request_id") or (i % 2 == 0 and (body["request_id"] != f"tele-{i}" or parsed[0] != client_trace)):
            fail(f"telemetry serving: request {i} replied {headers} {body}")
    batches = [s for s in live.spans() if s.name == "serve/batch"]
    linked = [link for s in batches for link in s.args["links"] if link["request_id"] in ("tele-0", "tele-2")]
    if len(linked) != 2 or any(link["trace_id"] != client_trace for link in linked) or not any(s.trace_id == client_trace for s in batches):
        fail(f"telemetry serving: the client's trace is not on the batch spans: {linked}")
    names = sorted({line.split()[2] for line in metrics.splitlines() if line.startswith("# TYPE ")})
    for name in ("serve_requests_total", "serve_latency_s", "serve_batches_total", "perf_step_time_breakdown_compute"):
        if name not in names:
            fail(f"telemetry serving: /metrics lacks {name}: {names}")
    result = {"requests": len(replies), "batch_spans": len(batches), "metrics": names}
    log(f"telemetry (53): {len(replies)} requests, ids and traceparent on every reply, the client's trace on {len(linked)} batch links; "
        f"/metrics names {names}")  # fmt: skip
    return result


def phases_51_53(workdir, path=None):
    """Phases 51-53 (they run alone too, after ``kernels.build()``)."""
    t0 = time.perf_counter()
    training, ring_on = phase_telemetry_training(workdir)
    bits = phase_telemetry_bits(workdir, (ring_on, training["ring"]["host_wall_s_per_gradient_step"], training["ring"]["syncs"]))
    serving = phase_telemetry_serving(workdir, path)
    took = time.perf_counter() - t0
    log(f"telemetry: phases 51-53 took {took:.1f} s")
    return {"telemetry": training, "telemetry_bits": bits, "telemetry_serving": serving, "phases_51_53_s": took}


# Phases 54-57: the resilience layer on the card. The health phase
# runs TELE_ARGS (phase 51's DV3-S runs, telemetry on) with health=on and
# holds each run to phase 51's, health off; the preemption phases cut the
# exps to a few gradient steps around the signal, with the buffer in memory
# at 4096 rows so that a checkpoint holds it (as the resume phases do).
RES_CUTS = {"exp=sac (54-56)": "algo.learning_starts 64, algo.total_steps 128, buffer.size 4096, checkpoint.every 0 (32 in the fail-point drill)",
            "exp=dreamer_v3_100k_ms_pacman (55)": "algo.learning_starts 128, algo.total_steps 136 (9 gradient steps: 3 warm-ups, a capture, 5 replays), buffer.size 4096",
            "exp=ppo_atari (56)": "env.screen_size 64 (from 84), algo.total_steps 256, algo.rollout_steps 32, env.num_envs 2"}  # fmt: skip
HEALTH_ARGS = [*TELE_ARGS, "health=on"]
HEALTH_REL_TOL = 1e-5  # a probe against its plain recomputation on the card from the same trees
DV3S_GRAPH_NODES = 17961  # the DV3-S ring step's captured graph with health off, as phase 52 read it before the probes existed
HEALTH_TAUS = (0.02, 1.0)
PRE_SAC = ["exp=sac", "env=dummy", "env.id=continuous_dummy", "algo.learning_starts=64", "algo.total_steps=128", "buffer.size=4096", "buffer.memmap=False",
           "metric.log_level=0", "algo.run_test=False", "checkpoint.every=0", "checkpoint.save_last=True"]  # fmt: skip
PRE_SAC_SIGNAL = 96
PRE_DV3 = ["exp=dreamer_v3_100k_ms_pacman", "env=dummy", "algo.learning_starts=128", "algo.total_steps=136", "buffer.device=True", "buffer.size=4096",
           "buffer.memmap=False", "metric.log_level=0", "algo.run_test=False", "checkpoint.every=0", "checkpoint.save_last=True"]  # fmt: skip
PRE_DV3_SIGNAL, PRE_DV3_DELAY_AT, PRE_DV3_DELAY_S, PRE_DV3_WATCHDOG_S = 133, 131, 2.5, 1.0
C4_ARGS = ["exp=ppo_atari", "env=dummy", "env.screen_size=64", "env.grayscale=True", "env.frame_stack=2", "env.max_episode_steps=3", "env.num_envs=2",
           "algo.rollout_steps=32", "algo.total_steps=256", "algo.run_test=False", "metric.log_every=64", "checkpoint.every=0", "checkpoint.save_last=False"]  # fmt: skip


def _chaos(*injectors):
    return ["resilience.chaos.enabled=True", "resilience.chaos.injectors=[" + ", ".join(injectors) + "]"]


def _newest(root):
    from sheeprl_tpu_torch.utils.checkpoint import parse_ckpt_name

    found = [p for p in glob_recursive(root, "ckpt_*.ckpt")]
    return sorted(found, key=lambda p: parse_ckpt_name(p)[0])


def glob_recursive(root, pattern):
    import glob

    return [os.path.realpath(p) for p in glob.glob(os.path.join(str(root), "**", pattern), recursive=True)]


def _same_leaves(a_path, b_path, skip=("rb",)):
    """The leaves of two checkpoints but ``skip``'s that differ bit for bit
    (their names), and how many were compared."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch.utils.checkpoint import flatten_arrays, load_checkpoint

    a, b = load_checkpoint(a_path), load_checkpoint(b_path)
    fa = dict(flatten_arrays({k: v for k, v in a.items() if k not in skip}))
    fb = dict(flatten_arrays({k: v for k, v in b.items() if k not in skip}))
    if fa.keys() != fb.keys():
        return sorted(set(fa) ^ set(fb)), len(fa)

    def same(x, y):
        if isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor):
            return torch_equal_bits(x, y)
        return np.array_equal(np.asarray(x), np.asarray(y))

    return [k for k in fa if not same(fa[k], fb[k])], len(fa)


def _health_step_checks():
    """The DV3-S step with health=on on the card (bf16-mixed, phase 10's ring
    and shapes): its captured graph against its eager step bit for bit (or
    within the eager run-to-run gap, as phase 10), and each probe of one
    eager step within ``HEALTH_REL_TOL`` of a plain recomputation on the card
    from the step's own trees (the raw gradients and the parameters before
    and after each update, read at the clip)."""
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.data.device_buffer import DeviceReplayRing
    from sheeprl_tpu_torch.serve.spaces import Box, DictSpace
    from sheeprl_tpu_torch.utils.distribution import BatchGenerator
    from sheeprl_tpu_torch.utils.ops import init_moments

    what = "health (54) step"
    cfg = compose([*TRAIN_ARGS, "health=on"])
    dev = torch.device("cuda")
    agent = build_agent((9,), False, cfg, DictSpace({"rgb": Box((64, 64, 3), "uint8", 0.0, 255.0)}), precision=cfg.fabric.precision, device=dev,
                        seed=cfg.seed, training=True)  # fmt: skip
    optimizers = dv3.make_optimizers(agent, cfg)
    batch, seq = int(cfg.algo.per_rank_batch_size), int(cfg.algo.per_rank_sequence_length)
    ring = DeviceReplayRing(GRAPH_RING_ROWS, 1, cnn_keys=("rgb",), obs_keys=("rgb",), device=dev)
    ring.add(_ring_rows(GRAPH_RING_ROWS, 1, 9, False, 17))
    ring.flush()
    sample = ring.make_sample_fn(batch, seq, time_major=True)
    rng = BatchGenerator.from_seed(cfg.seed, dev)
    fused = dv3.make_fused_train_step(agent, optimizers, cfg, lambda state, r: sample(state, r.generator), rng)
    moments, _ = fused(init_moments(dev), ring.state, [1.0] + [0.02] * (WARMUP_STEPS - 1))
    torch.cuda.synchronize()
    params, adam = _train_state(agent, optimizers)
    snap = {"params": [p.detach().clone() for p in params], "adam": [a.clone() for a in adam],
            "moments": {k: v.clone() for k, v in moments.items()}, "rng": rng.generator.get_state()}  # fmt: skip

    def restore():
        with torch.no_grad():
            for p, v in zip(params, snap["params"]):
                p.copy_(v)
            for a, v in zip(adam, snap["adam"]):
                a.copy_(v)
        rng.generator.set_state(snap["rng"])

    def result(m, per_step):
        p, a = _train_state(agent, optimizers)
        return {"params": [x.detach().clone() for x in p], "adam": [x.clone() for x in a],
                "moments": [m["low"].clone(), m["high"].clone()], "metrics": [torch.stack(per_step)]}  # fmt: skip

    step = dv3.make_train_step(agent, optimizers, cfg)
    tau = torch.zeros((), device=dev)

    def eager_run():
        restore()
        m, per_step = {k: v.clone() for k, v in snap["moments"].items()}, []
        for t in HEALTH_TAUS:
            tau.fill_(t)
            m, metrics = step(m, sample(ring.state, rng.generator), rng, tau)
            per_step.append(torch.stack([metrics[k].float() for k in fused.names]))
        torch.cuda.synchronize()
        return result(m, per_step)

    eager_a, eager_b = eager_run(), eager_run()
    restore()
    per_step = []
    m, _ = fused(snap["moments"], ring.state, HEALTH_TAUS, lambda i, metrics: per_step.append(torch.stack(list(metrics.values()))))
    torch.cuda.synchronize()
    graph = result(m, per_step)
    eager_gap, graph_gap = _gaps(eager_a, eager_b), _gaps(eager_a, graph)
    for group, gap in graph_gap.items():
        allowed = 0.0 if eager_gap[group]["bit_for_bit"] else eager_gap[group]["max_abs"]
        if not gap["bit_for_bit"] and gap["max_abs"] > allowed:
            fail(f"{what}: with the probes the graph's {group} differ from the eager step's by {gap['max_abs']} (two eager runs: {eager_gap[group]})")
    probes = [k for k in fused.names if k.startswith("health/")]
    if len(probes) != 6:
        fail(f"{what}: the captured step's outputs hold the probes {probes}")
    nodes = fused.captured.nodes

    # One eager step, its trees read where the tape reads them.
    restore()
    trees = {"grads": [], "old": [], "new": []}
    modules = []
    clip = dv3._clip

    def reading_clip(module, max_norm):
        modules.append(module)
        trees["grads"] += [p.grad.detach().clone() for p in module.parameters() if p.grad is not None]
        trees["old"] += [p.detach().clone() for p in module.parameters()]
        return clip(module, max_norm)

    with patched(dv3, "_clip", reading_clip):
        tau.fill_(0.02)
        _, metrics = step({k: v.clone() for k, v in snap["moments"].items()}, sample(ring.state, rng.generator), rng, tau)
    trees["new"] = [p.detach().clone() for module in modules for p in module.parameters()]
    torch.cuda.synchronize()

    def norm(leaves):
        return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(x.float()) for x in leaves]))

    param_norm = norm(trees["new"])
    plain = {"health/grad_norm": norm(trees["grads"]), "health/param_norm": param_norm,
             "health/update_ratio": norm([n - o for n, o in zip(trees["new"], trees["old"])]) / (param_norm + 1e-12),
             "health/grad_nonfinite": torch.tensor(float(sum(not bool(torch.isfinite(g).all()) for g in trees["grads"]))),
             "health/param_nonfinite": torch.tensor(float(sum(not bool(torch.isfinite(p).all()) for p in trees["new"]))),
             "health/kl": metrics["State/kl"].float()}  # fmt: skip
    gaps = {}
    for k, want in plain.items():
        got, want = float(metrics[k]), float(want)
        gaps[k] = abs(got - want) / max(abs(want), 1e-30) if want else abs(got)
        if gaps[k] > HEALTH_REL_TOL:
            fail(f"{what}: {k} = {got} against its plain recomputation {want} (relative {gaps[k]:.3g} > {HEALTH_REL_TOL})")
    extra_bytes = sum(p.numel() * p.element_size() for module in modules for p in module.parameters())
    out = {"graph_vs_eager": graph_gap, "eager_vs_eager": eager_gap, "graph_nodes_with_probes": nodes["nodes"], "graph_ln_gru_nodes": nodes["ln_gru"],
           "probes": {k: float(metrics[k]) for k in plain}, "probe_rel_gap": gaps, "tape_copy_bytes_max": extra_bytes}  # fmt: skip
    del fused, ring, agent, optimizers, step, snap, eager_a, eager_b, graph, trees
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_health(workdir):
    """Phase 54: DV3-S (bf16-mixed) through the CLI with health=on, the host
    path (phase 51's profiler window) and the ring path, each held to phase
    51's run with health off: the parameters and Adam states bit for bit,
    the LN-GRU launches per run equal, the synchronising calls per gradient
    step equal (ring path); no health event; the health-off ring graph's
    nodes as recorded (``DV3S_GRAPH_NODES``); the host wall per gradient
    step on and off (reported).
    Then the probed step's graph against its eager step and each probe
    against its plain recomputation (:func:`_health_step_checks`)."""
    t0 = time.perf_counter()
    if "host" not in TELE_RUNS:  # alone: the health-off runs here
        host, host_wall, host_counts, _, _ = _telemetry_run([*TELE_ARGS, *TELE_HOST, f"log_root={workdir}"], "health off host path")
        ring, ring_wall, ring_counts, ring_syncs, _ = _telemetry_run([*TELE_ARGS, *TELE_RING, f"log_root={workdir}"], "health off ring path", count_syncs=True)
        TELE_RUNS.update(host=(host, host_wall, host_counts), ring=(ring, ring_wall, ring_counts, ring_syncs))
    off_host, off_host_wall, off_host_counts = TELE_RUNS["host"]
    off_ring, off_ring_wall, off_ring_counts, off_ring_syncs = TELE_RUNS["ring"]
    on_host, on_host_wall, on_host_counts, _, _ = _telemetry_run([*HEALTH_ARGS, *TELE_HOST, f"log_root={workdir}"], "health host path")
    on_ring, on_ring_wall, on_ring_counts, on_ring_syncs, _ = _telemetry_run([*HEALTH_ARGS, *TELE_RING, f"log_root={workdir}"], "health ring path", count_syncs=True)
    result = {}
    for path, on, off, c_on, c_off in (("host", on_host, off_host, on_host_counts, off_host_counts), ("ring", on_ring, off_ring, on_ring_counts, off_ring_counts)):
        (pa, aa), (pb, ab) = _state_of(on), _state_of(off)
        differ = [k for k in pa if not torch_equal_bits(pa[k], pb[k])] + [k for k in aa if not torch_equal_bits(aa[k], ab[k])]
        if differ or pa.keys() != pb.keys() or aa.keys() != ab.keys() or on["gradient_steps"] != off["gradient_steps"]:
            fail(f"health {path} path: the parameters or Adam states differ with health on and off: {differ[:5]}")
        if c_on != c_off or not all(c_on[k] for k in ("streaming", "tensor_core", "backward")):
            fail(f"health {path} path: LN-GRU launches {c_on} with health on, {c_off} off")
        records, _ = _telemetry_records(on["log_dir"], f"health {path} path")
        events = [r for r in records if r["type"] == "health_event"]
        if events:
            fail(f"health {path} path: sentinel events on a sound run: {events[:3]}")
        result[path] = {"gradient_steps": on["gradient_steps"], "tensors_bit_for_bit": len(pa) + len(aa), "ln_gru_launches": c_on}
    if on_ring_syncs["per_gradient_step"] != off_ring_syncs["per_gradient_step"]:
        fail(f"health ring path: synchronising calls per gradient step {on_ring_syncs} with health on, {off_ring_syncs} off")
    off_nodes, on_nodes = off_ring["fused"]["graph"]["nodes"], on_ring["fused"]["graph"]["nodes"]
    if off_nodes != DV3S_GRAPH_NODES:
        fail(f"health off: the DV3-S ring step's graph holds {off_nodes} nodes, {DV3S_GRAPH_NODES} recorded")
    step = _health_step_checks()
    card = nvidia_smi()
    result.update(
        added_ms_per_gradient_step={"host": (on_host_wall - off_host_wall) * 1e3, "ring": (on_ring_wall - off_ring_wall) * 1e3},
        host_wall_ms_per_gradient_step={"host": {"on": on_host_wall * 1e3, "off": off_host_wall * 1e3}, "ring": {"on": on_ring_wall * 1e3, "off": off_ring_wall * 1e3}},
        syncs={"on": on_ring_syncs, "off": off_ring_syncs}, graph_nodes={"off": off_nodes, "on": on_nodes}, step=step, card=card,
        took_s=time.perf_counter() - t0,
    )  # fmt: skip
    log(f"health (54): DV3-S bf16-mixed health=on against off, {result['host']['tensors_bit_for_bit']} / {result['ring']['tensors_bit_for_bit']} tensors bit "
        f"for bit (host / ring path), LN-GRU launches equal ({on_host_counts['streaming']} streaming, {on_host_counts['tensor_core']} tensor-core, "
        f"{on_host_counts['backward']} backward on the host path); syncs per gradient step {on_ring_syncs['per_gradient_step']:.3f} on, "
        f"{off_ring_syncs['per_gradient_step']:.3f} off; host wall per gradient step host path {on_host_wall * 1e3:.2f} on / {off_host_wall * 1e3:.2f} off ms, "
        f"ring path {on_ring_wall * 1e3:.2f} / {off_ring_wall * 1e3:.2f} ms (one run each, {card}); graph nodes {off_nodes} off ({DV3S_GRAPH_NODES} recorded), "
        f"{on_nodes} with the probes; probed graph vs eager {json.dumps(step['graph_vs_eager'])}; probes against the plain recomputation "
        f"{json.dumps({k: float(f'{v:.3g}') for k, v in step['probe_rel_gap'].items()})}; the tape's copy at most {step['tape_copy_bytes_max']} bytes")  # fmt: skip
    return result


def _first_step_s(args, what):
    """One CLI run of DreamerV3 and the seconds from its start to its first
    gradient step's callback."""
    from sheeprl_tpu_torch.cli import run

    t0, first = time.perf_counter(), []
    out = run(args, callback=lambda *a: first.append(time.perf_counter() - t0) if not first else None)
    if not first:
        fail(f"{what}: no gradient step")
    return out, first[0]


def phase_preemption(workdir):
    """Phase 55: SAC on the host path and DV3-S on the ring path, each with a
    chaos ``sigterm`` at a policy step: the checkpoint at that step and
    ``autoresume.json`` (signal 15); ``checkpoint.resume_from=auto`` to the
    end, where every leaf but the buffer is bit for bit the uninterrupted
    run's. The DV3-S run also carries a ``delayed_fetch`` under a ``warn``
    watchdog (phase 56's drill): the trip counted, the run unchanged. Then
    a real SIGTERM from outside to a SAC trainer subprocess. Drain-to-exit
    and auto-resume seconds printed."""
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.core import chaos
    from sheeprl_tpu_torch.core.resilience import AUTORESUME_NAME, last_guard_stats
    from sheeprl_tpu_torch.utils.checkpoint import parse_ckpt_name

    t0 = time.perf_counter()
    root = os.path.join(workdir, "preemption")
    out = {}
    cases = (
        ("sac_host", PRE_SAC, PRE_SAC_SIGNAL, [], []),
        ("dv3_ring", [*PRE_DV3, "telemetry=on"], PRE_DV3_SIGNAL, [f"{{kind: delayed_fetch, seconds: {PRE_DV3_DELAY_S}, at_step: {PRE_DV3_DELAY_AT}}}"],
         ["resilience.watchdog.enabled=True", f"resilience.watchdog.timeout_s={PRE_DV3_WATCHDOG_S}", "resilience.watchdog.on_trip=warn"]),
    )  # fmt: skip
    for name, args, signal_at, injectors, extra in cases:
        base_root, run_root = os.path.join(root, name, "base"), os.path.join(root, name, "chaos")
        chaos.reset()
        full = run([*args, f"log_root={base_root}"])
        chaos_args = [*extra, *_chaos(f"{{kind: sigterm, at_step: {signal_at}}}", *injectors)]
        t1 = time.perf_counter()
        cut = run([*args, *chaos_args, f"log_root={run_root}"])
        cut_s = time.perf_counter() - t1
        guard = last_guard_stats()
        saved = _newest(run_root)
        pointers = glob_recursive(run_root, AUTORESUME_NAME)
        if not saved or len(pointers) != 1 or not guard["preempted"]:
            fail(f"preemption {name}: checkpoints {saved}, pointers {pointers}, guard {guard}")
        with open(pointers[0]) as fp:
            pointer = json.load(fp)
        step = parse_ckpt_name(saved[-1])[0]
        if pointer["signal"] != 15 or os.path.realpath(pointer["ckpt_path"]) != saved[-1] or not signal_at <= step < signal_at + 8:
            fail(f"preemption {name}: pointer {pointer}, newest checkpoint {saved[-1]} for a signal at {signal_at}")
        chaos.reset()
        if name == "dv3_ring":
            resumed, resume_s = _first_step_s([*args, f"log_root={run_root}", f"checkpoint.resume_from=auto:{run_root}"], f"preemption {name} resume")
        else:
            t1 = time.perf_counter()
            resumed = run([*args, f"log_root={run_root}", f"checkpoint.resume_from=auto:{run_root}"])
            resume_s = time.perf_counter() - t1
        end_full, end_resumed = _newest(base_root)[-1], _newest(run_root)[-1]
        differ, leaves = _same_leaves(end_full, end_resumed)
        if differ or parse_ckpt_name(end_full)[0] != parse_ckpt_name(end_resumed)[0]:
            fail(f"preemption {name}: the resumed run ends off the uninterrupted one ({os.path.basename(end_resumed)}): {differ[:5]}")
        out[name] = {"signal_at": signal_at, "saved_at": step, "pointer": {k: pointer[k] for k in ("policy_step", "signal")},
                     "drain_to_exit_s": guard["drain_to_exit_s"], "preempted_run_s": cut_s, "resumed_run_s": resume_s,
                     "leaves_bit_for_bit": leaves, "gradient_steps": full["gradient_steps"]}  # fmt: skip
        if name == "dv3_ring":
            records, _ = _telemetry_records(cut["log_dir"], "preemption dv3_ring")
            final = [r for r in records if r["type"] == "counters"][-1]["values"]
            labels = [r.get("args", {}).get("label") for r in records if r["type"] == "span" and r["name"] == "resilience/watchdog_trip"]
            if "fetch/player_actions" not in labels or final.get("faults_injected/delay:fetch.harvest", 0) != 1:
                fail(f"drill delayed_fetch: trips {labels}, counters {[(k, v) for k, v in final.items() if 'fault' in k or 'watchdog' in k]}")
            out[name]["delayed_fetch"] = {"watchdog_trips": final.get("watchdog_trips", 0), "trip_labels": labels, "timeout_s": PRE_DV3_WATCHDOG_S,
                                          "delay_s": PRE_DV3_DELAY_S}  # fmt: skip
    out["sigterm_from_outside"] = _sigterm_subprocess(os.path.join(root, "outside"))
    out["took_s"] = time.perf_counter() - t0
    log(f"preemption (55): SAC host path, signal at {out['sac_host']['signal_at']} -> saved at {out['sac_host']['saved_at']}, drain-to-exit "
        f"{out['sac_host']['drain_to_exit_s']:.3f} s, auto-resume run {out['sac_host']['resumed_run_s']:.2f} s, end bit for bit "
        f"({out['sac_host']['leaves_bit_for_bit']} leaves); DV3-S ring path, signal at {out['dv3_ring']['signal_at']} -> saved at "
        f"{out['dv3_ring']['saved_at']}, drain-to-exit {out['dv3_ring']['drain_to_exit_s']:.3f} s, auto-resume to its first gradient step "
        f"{out['dv3_ring']['resumed_run_s']:.2f} s, end bit for bit ({out['dv3_ring']['leaves_bit_for_bit']} leaves); delayed_fetch "
        f"{PRE_DV3_DELAY_S} s under a {PRE_DV3_WATCHDOG_S} s warn watchdog: trips {out['dv3_ring']['delayed_fetch']['trip_labels']}; a SIGTERM from "
        f"outside: {json.dumps(out['sigterm_from_outside'])}; took {out['took_s']:.1f} s")  # fmt: skip
    return out


def _sigterm_subprocess(log_root):
    """A SAC trainer in a subprocess on the card, SIGTERM to its Python pid
    2 s after its ``Player:`` line: exit 0, ``Preemption: exiting cleanly``,
    the pointer with signal 15."""
    import signal

    args = [a for a in PRE_SAC if not a.startswith("algo.total_steps")] + ["algo.total_steps=1000000", "env.sync_env=True", f"log_root={log_root}"]
    code = "import sys; sys.path.insert(0, sys.argv[1]); from sheeprl_tpu_torch.cli import run; run(sys.argv[2:])"
    proc = subprocess.Popen([sys.executable, "-u", "-c", code, REPO, *args], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("Player:"):
                break
        time.sleep(2.0)
        t0 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=120)
        exit_s = time.perf_counter() - t0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = "".join(lines) + rest
    pointers = glob_recursive(log_root, "autoresume.json")
    if proc.returncode != 0 or "Preemption: exiting cleanly" not in text or len(pointers) != 1:
        fail(f"sigterm from outside: rc {proc.returncode}, pointers {pointers}: {text[-2000:]}")
    with open(pointers[0]) as fp:
        pointer = json.load(fp)
    if pointer["signal"] != 15:
        fail(f"sigterm from outside: pointer {pointer}")
    return {"rc": proc.returncode, "signal_to_exit_s": exit_s, "saved_at": pointer["policy_step"]}


def phase_drills(workdir):
    """Phase 56 (the delayed fetch is in phase 55's DV3-S run): an
    ``env_step_raise`` under the supervisor (SAC, ``resilience=on``): one
    restart, a truncated row in the stored buffer at the restart; a
    ``checkpoint.before_commit`` fail point: the previous checkpoint the
    newest valid one, no staging dir; ``exp=ppo_atari`` on the card with
    ``env.grayscale``, ``env.frame_stack=2`` and ``env.max_episode_steps=3``
    (C4): the observation shapes and episode ends; the DV3-S host player's
    ms per env step at ``num_threads`` 1 (the default the CLI now sets) and
    at torch's default (C5)."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.core import chaos
    from sheeprl_tpu_torch.utils.env import make_vector_env
    from sheeprl_tpu_torch.utils.checkpoint import find_latest_valid_checkpoint, load_checkpoint, parse_ckpt_name

    t0 = time.perf_counter()
    root = os.path.join(workdir, "drills")
    out = {}
    # The supervisor: env 0 raises on its 40th step (policy step ~160 of 4 envs: past the prefill).
    chaos.reset()
    sup_root = os.path.join(root, "supervisor")
    sup = run([*PRE_SAC, "algo.total_steps=256", "resilience=on", "resilience.supervisor.backoff_base_s=0.001", "telemetry=on", f"log_root={sup_root}",
               *_chaos("{kind: env_step_raise, env_rank: 0, at_step: 40}")])  # fmt: skip
    records, _ = _telemetry_records(sup["log_dir"], "drill supervisor")
    final = [r for r in records if r["type"] == "counters"][-1]["values"]
    rb = load_checkpoint(_newest(sup_root)[-1])["rb"]
    truncated = np.asarray(rb["arrays"]["truncated"])[: int(rb["pos"])]
    rows = np.nonzero(truncated[:, 0, 0])[0].tolist()
    if final.get("env_restarts", 0) != 1 or 39 not in rows:
        fail(f"drill supervisor: env_restarts {final.get('env_restarts')}, truncated rows of env 0 {rows}")
    out["supervisor"] = {"env_restarts": final["env_restarts"], "truncated_rows_env0": rows, "gradient_steps": sup["gradient_steps"]}
    # A crash inside the commit at step 64: the save at 32 stays the newest.
    chaos.reset()
    fp_root = os.path.join(root, "fail_point")
    try:
        run([*PRE_SAC, "checkpoint.every=32", f"log_root={fp_root}", *_chaos("{kind: fail_point, name: checkpoint.before_commit, at_step: 64}")])
        fail("drill fail point: the run did not raise")
    except chaos.ChaosFault:
        pass
    chaos.reset()
    saved = _newest(fp_root)
    ckpt_dir = os.path.dirname(saved[-1]) if saved else fp_root
    staging = [n for n in os.listdir(ckpt_dir) if n.startswith(".tmp-")]
    if not saved or parse_ckpt_name(saved[-1])[0] != 32 or staging or find_latest_valid_checkpoint(ckpt_dir) != saved[-1]:
        fail(f"drill fail point: checkpoints {saved}, staging {staging}")
    out["fail_point"] = {"newest_valid": os.path.basename(saved[-1]), "staging_left": len(staging)}
    # C4 on the card: ppo_atari with the env keys.
    cfg = compose([*C4_ARGS, "device=cuda"])
    envs = make_vector_env(cfg)
    obs, _ = envs.reset(seed=0)
    shapes, ends = [tuple(obs["rgb"].shape)], []
    for t in range(7):
        obs, _, term, trunc, _ = envs.step(np.zeros(2, np.int64))
        shapes.append(tuple(obs["rgb"].shape))
        ends.append(bool(trunc.all()) and not term.any())
    if set(shapes) != {(2, 64, 64, 2)} or ends != [False, False, True, False, False, True, False]:
        fail(f"drill C4: observation shapes {set(shapes)}, truncations {ends}")
    c4 = run([*C4_ARGS, f"log_root={os.path.join(root, 'c4')}"])
    lengths = {row.get("Game/ep_len_avg") for row in c4["log"] if "Game/ep_len_avg" in row}
    losses = [v for row in c4["log"] for k, v in row.items() if k.startswith("Loss/")]
    if lengths != {3.0} or not losses or not all(math.isfinite(v) for v in losses):
        fail(f"drill C4: episode lengths {lengths}, losses {losses[:4]}")
    out["c4"] = {"rgb_shape": list(shapes[0]), "truncated_every": 3, "ep_len_avg": sorted(lengths), "updates": c4["updates"]}
    # C5: the host player at num_threads 1 (the CLI's default now) and at torch's default.
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import PLAYER_STATE
    from sheeprl_tpu_torch.core.player import PlayerPlacement, param_bytes
    from sheeprl_tpu_torch.utils.distribution import BatchGenerator
    from sheeprl_tpu_torch.utils.utils import dotdict

    pcfg, agent = _dv3_player("bf16-mixed")
    host = PlayerPlacement.resolve(dotdict({"fabric": {"player_device": "host", "player_sync": "fresh"}}), torch.device("cuda"),
                                   nbytes=param_bytes(agent, PLAYER_STATE))  # fmt: skip
    cpu_player = host.player(agent, PLAYER_STATE)
    default_threads = torch.get_num_threads()
    timed = {}
    for threads in (1, default_threads):
        torch.set_num_threads(threads)
        try:
            timed[threads] = _timed_in_turns({"host": _dv3_stepper(pcfg, cpu_player, BatchGenerator.from_seed(1, "cpu"))}, "num_threads", profile_steps=0)["host"]
        finally:
            torch.set_num_threads(default_threads)
    out["num_threads"] = {str(k): {"host_wall_ms_per_env_step": v["host_wall_ms_per_env_step"], "windows": v["host_wall_ms_windows"]} for k, v in timed.items()}
    out["took_s"] = time.perf_counter() - t0
    log(f"drills (56): supervisor {json.dumps(out['supervisor'])}; fail point {json.dumps(out['fail_point'])}; C4 ppo_atari {json.dumps(out['c4'])}; "
        f"host player (DV3-S bf16-mixed on the CPU) {timed[1]['host_wall_ms_per_env_step']:.2f} ms a env step at num_threads=1, "
        f"{timed[default_threads]['host_wall_ms_per_env_step']:.2f} ms at torch's default {default_threads}; took {out['took_s']:.1f} s")  # fmt: skip
    return out


def phase_serving_drain(workdir, path=None):
    """Phase 57: the DV3-S policy server in the foreground
    (``serve_forever``): a request answered, then SIGTERM to this process;
    the guard drains the engine and returns, the handler put back."""
    import signal

    import numpy as np

    from sheeprl_tpu_torch.algos.dreamer_v3.serve import export_random
    from sheeprl_tpu_torch.serve.engine import InferenceEngine
    from sheeprl_tpu_torch.serve.server import PolicyServer

    if path is None:
        path = export_random(os.path.join(workdir, "dv3s_drain.policy"), name="dv3s", seed=0, precision="bf16-mixed")
    engine = InferenceEngine(max_batch=8, batch_window_s=0.002, device="cuda")
    engine.load("dv3s", path)
    server = PolicyServer(engine, host="127.0.0.1", port=0)
    replies, stamps = [], {}

    def client():
        body = json.dumps({"model": "dv3s", "session": "s", "obs": {"rgb": np.random.default_rng(0).integers(0, 256, (64, 64, 3)).tolist()}}).encode()
        for _ in range(200):
            try:
                with urllib.request.urlopen(server.address + "/healthz", timeout=5):
                    break
            except OSError:
                time.sleep(0.05)
        for _ in range(3):
            req = urllib.request.Request(server.address + "/v1/act", data=body, headers={"Content-Type": "application/json"}, method="POST")
            with urllib.request.urlopen(req, timeout=60) as resp:
                replies.append(resp.status)
        stamps["signal"] = time.perf_counter()
        os.kill(os.getpid(), signal.SIGTERM)

    before = signal.getsignal(signal.SIGTERM)
    thread = threading.Thread(target=client, daemon=True)
    thread.start()
    server.serve_forever(poll_s=0.05)
    drain_s = time.perf_counter() - stamps.get("signal", time.perf_counter())
    thread.join(timeout=30)
    if replies != [200] * 3 or signal.getsignal(signal.SIGTERM) is not before or engine.stats()["counters"]["requests"] != 3:
        fail(f"serving drain: replies {replies}, handler restored {signal.getsignal(signal.SIGTERM) is before}")
    log(f"serving drain (57): 3 requests answered, SIGTERM to the serving process, drained and returned in {drain_s:.3f} s, handler restored")
    return {"requests": len(replies), "signal_to_return_s": drain_s}


def phases_54_57(workdir, path=None):
    """Phases 54-57, the resilience layer (they run alone too, after
    ``kernels.build()``; 54 then runs its own health-off runs)."""
    t0 = time.perf_counter()
    health = phase_health(workdir)
    preemption = phase_preemption(workdir)
    drills = phase_drills(workdir)
    serving = phase_serving_drain(workdir, path)
    took = time.perf_counter() - t0
    log(f"resilience: phases 54-57 took {took:.1f} s (cuts {json.dumps(RES_CUTS)})")
    return {"health": health, "preemption": preemption, "drills": drills, "serving_drain": serving, "phases_54_57_s": took}


# Phases 58-60: the actor fleet (exp=sac_decoupled and exp=ppo_decoupled with
# fleet.replicas=2: two replica processes playing on the CPU, the learner on
# the card) and DreamerV3's XS, M and L sizes on the LN-GRU kernels.
FLEET_REPLICAS = 2
SACF_ARGS = [*SACD_ARGS, f"fleet.replicas={FLEET_REPLICAS}", "fleet.param_sync_every=4"]
SACF_CUTS = {**SACD_CUTS, "fleet.replicas": "2 (from 1)", "fleet.param_sync_every": "4 (from 16: a broadcast every 4 of the run's 32 iterations)"}
SACF_KILL_AT = 16  # replica 0's env steps: its 4th shipment
# The kill9 drill runs 1024 policy steps (240 gradient-step iterations), so
# that the restarted generation ships before the run ends. Its first train
# call is the one held against the CPU, and the resumed run of the sigterm
# drill is the no-fault run (a fourth run, SACF_ARGS without a fault, was
# cut to keep the command under its time limit: most of its time was the
# replicas' spawn).
SACF_KILL_ARGS = [*[a for a in SACF_ARGS if not a.startswith("algo.total_steps=")], "algo.total_steps=1024"]
SACF_SIGNAL = 64  # the learner's policy step of the sigterm drill
PPOF_ARGS = [*[a for a in PPOD_ARGS if not a.startswith("algo.total_steps=")], "algo.total_steps=3072", f"fleet.replicas={FLEET_REPLICAS}"]
PPOF_CUTS = {**PPOD_CUTS, "algo.total_steps": "3072 (from 65536; 3 rounds of 2 rollouts of 128 x 4)", "fleet.replicas": "2 (from 1)"}
# One run: rounds 1 and 2 have no fault (round 2, whose replicas are built,
# is the one timed); replica 0 dies shipping its third rollout (its env steps
# reach 1536), so round 3 takes its restart.
PPOF_KILL_AT = 1536
# Each Adam step of the first update from the card's state against one CPU
# step: limits about ten times the readings of every chip run (a leaf's change
# 3.1e-4, an Adam moment 1.6e-4 on an NVIDIA H100 80GB HBM3 at 700 W), so
# that an error of a few percent in the step fails. The card's losses over
# the update's first 72 Adam steps against the CPU's own update, before the
# clip's flip at step 73 parts them: about ten times the worst reading (a
# relative 8.5e-5, value_loss at step 12, on the same card).
PPOF_STEP_TOL = {"loss_rtol": 1e-3, "loss_atol": 1e-5, "param_change": 3e-3, "adam_moment": 3e-3}
PPOF_TRAJECTORY_STEPS = 72
PPOF_TRAJECTORY_TOL = {"loss_rtol": 1e-3, "loss_atol": 1e-4}
DV3_SIZES = {  # (D = H + dense_units: the cell's input is concat[h, x], H) of algo=dreamer_v3_<size>
    "XS": (512, 256), "M": (1664, 1024), "L": (2816, 2048),
}
DV3_SIZE_BATCHES = ((16, "dynamic scan"), (1024, "imagination"), (1, "player"))
# The sizes whose step is profiled for its device busy time: L only, cut for
# phase 61 (XS's and M's steps were busy 52.08-52.17 and 79.22-79.46 ms on an
# NVIDIA H100 80GB HBM3 at 700 W).
DV3_SIZE_PROFILED = ("L",)
DV3_SIZE_BWD = (16, 1024)
DV3_SIZE_ARGS = ["exp=dreamer_v3_100k_ms_pacman", "env=dummy", "algo.learning_starts=128", "algo.total_steps=128", "buffer.size=4096",
                 "buffer.memmap=False", "metric.log_level=0", "algo.run_test=False", "checkpoint.save_last=False"]  # fmt: skip
DV3_SIZE_CUTS = {"algo.learning_starts": "128 (from 1024)", "algo.total_steps": "128 (from 100000; 1 gradient step)",
                 "buffer.size": "4096 in memory (from 100000 memory-mapped)", "algo.run_test": "False", "checkpoint.save_last": "False"}  # fmt: skip


def _fleet_spy():
    """Patches on the fleet supervisor that record, without changing what it
    does: each spawn's replica, generation and seed, each death's time, the
    first shipment each restarted generation hands the learner, and when
    ``start`` returned (every replica said hello)."""
    from sheeprl_tpu_torch.core.fleet import FleetSupervisor

    spy = {"spawns": [], "deaths": [], "first_after_death": {}, "shippers": set(), "cuda_in_replica": []}
    spawn, on_death, hand, start = FleetSupervisor._spawn, FleetSupervisor._on_death, FleetSupervisor._hand_to_learner, FleetSupervisor.start

    def timing_start(self):
        start(self)
        spy["started_at"] = time.perf_counter()

    def spying_spawn(self, slot):
        spawn(self, slot)
        spy["spawns"].append({"replica": slot.index, "generation": slot.generation, "seed": slot.seed})

    def spying_death(self, slot, reason):
        spy["deaths"].append({"replica": slot.index, "generation": slot.generation, "reason": reason, "t": time.perf_counter()})
        on_death(self, slot, reason)

    def spying_hand(self, shipment):
        key = (shipment.replica, shipment.generation)
        spy["shippers"].add(shipment.replica)
        if shipment.meta.get("cuda_initialized", True):
            spy["cuda_in_replica"].append(key)
        if shipment.generation > 0 and key not in spy["first_after_death"]:
            spy["first_after_death"][key] = time.perf_counter()
        return hand(self, shipment)

    stack = ExitStack()
    for name, fn in (("_spawn", spying_spawn), ("_on_death", spying_death), ("_hand_to_learner", spying_hand), ("start", timing_start)):
        stack.enter_context(patched(FleetSupervisor, name, fn))
    return stack, spy


def _fleet_run(args, what, log_root, record_module=None, record_name=None, callback=None):
    """One fleet run through the CLI on the card: the LN-GRU counts zeroed
    just before and read just after (all 0), every shipment's word that its
    replica had no CUDA context (``torch.cuda.is_initialized()`` false there),
    the learner's host wall from the fleet's start (every replica's hello) to
    the run's end, the spy's records, and, with ``record_module``, its first
    train call recorded (``_recording``)."""
    import torch

    from sheeprl_tpu_torch.cli import run

    record = {}
    stack, spy = _fleet_spy()
    with stack, ExitStack() as rec:
        if record_module is not None:
            rec.enter_context(_recording(record_module, record_name, record))
        zero_counts()
        out = run([*args, f"log_root={log_root}"], callback=callback)
        torch.cuda.synchronize()
        wall = time.perf_counter() - spy["started_at"]
    counts = read_counts()
    if counts["forward"] or counts["backward"]:
        fail(f"{what}: LN-GRU launches {counts}")
    if out["fleet"] is None or out["fleet"]["replicas"] != FLEET_REPLICAS:
        fail(f"{what}: the run did not act through a fleet of {FLEET_REPLICAS}: {out.get('fleet')}")
    params = [v for v in out["agent"].state_dict().values() if v.is_floating_point()]
    if not all(torch.isfinite(p).all() for p in params):
        fail(f"{what}: non-finite parameters")
    if spy["cuda_in_replica"]:
        fail(f"{what}: replicas (replica, generation) {sorted(set(spy['cuda_in_replica']))} shipped with a CUDA context open")
    return out, wall, counts, spy, record


def _check_restart(what, spy, replica=0):
    """One death of ``replica``'s generation 0, its generation 1 spawned with
    ``replica_seed(seed, replica, 1)``; returns the death-to-first-shipment
    seconds (None if the run ended before the new generation shipped)."""
    from sheeprl_tpu_torch.core.fleet import replica_seed

    deaths = [d for d in spy["deaths"] if d["replica"] == replica]
    gen1 = [s for s in spy["spawns"] if s["replica"] == replica and s["generation"] == 1]
    if len(spy["deaths"]) != 1 or len(deaths) != 1 or len(gen1) != 1 or gen1[0]["seed"] != replica_seed(5, replica, 1):
        fail(f"{what}: deaths {spy['deaths']}, spawns {spy['spawns']} (expected one death of replica {replica} and its generation 1 seeded "
             f"{replica_seed(5, replica, 1)})")  # fmt: skip
    first = spy["first_after_death"].get((replica, 1))
    return None if first is None else first - deaths[0]["t"]


def phase_sac_fleet(log_root, nonfleet=None):
    """(58) ``exp=sac_decoupled`` (phase 49's cuts) with ``fleet.replicas=2``,
    three runs: a ``kill9`` on replica 0 (``SACF_KILL_ARGS``: one restart,
    its generation 1 seeded ``replica_seed(seed, 0, 1)``, shipments from both
    replicas, the run completes; death to the new generation's first
    shipment printed), whose first train call is held against the CPU at
    phase 49's bounds; a ``sigterm`` to the learner (drain, the save at the
    signal's step; drain-to-exit printed); and ``checkpoint.resume_from=auto``
    to the end, with no fault: no row dropped, shipments from both replicas,
    as many gradient steps as phase 49's non-fleet run, and that run's
    ``iter_num`` and buffer position (``nonfleet``: its gradient steps and
    last checkpoint). No replica opens a CUDA context."""
    import torch

    from sheeprl_tpu_torch.algos.sac import sac as sac_module
    from sheeprl_tpu_torch.algos.sac.agent import build_agent
    from sheeprl_tpu_torch.algos.sac.sac import make_optimizers, make_train_step
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.core import chaos
    from sheeprl_tpu_torch.core.resilience import last_guard_stats
    from sheeprl_tpu_torch.envs.dummy import ContinuousDummyEnv
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint, parse_ckpt_name

    t0 = time.perf_counter()
    root = os.path.join(log_root, "sac_fleet")
    if nonfleet is None:  # run alone: phase 49's no-fault run, taken here
        out = _decoupled_run(SACD_ARGS, "sac_decoupled (58's baseline)", os.path.join(root, "nonfleet"))[0]
        nonfleet = {"gradient_steps": out["gradient_steps"], "last_checkpoint": out["checkpoints"][-1]}
    nonfleet_steps = nonfleet["gradient_steps"]

    chaos.reset()
    killed, kill_wall, counts, kspy, record = _fleet_run(
        [*SACF_KILL_ARGS, "seed=5", *_chaos(f"{{kind: kill9, at_step: {SACF_KILL_AT}, replica: 0}}")], "sac fleet kill9", os.path.join(root, "kill9"),
        sac_module, "make_train_step",
    )  # fmt: skip
    restart_s = _check_restart("sac fleet kill9", kspy)
    if killed["fleet"]["restarts"] != 1 or killed["fleet"]["generations"] != [1, 0] or restart_s is None or kspy["shippers"] != {0, 1}:
        fail(f"sac fleet kill9: {killed['gradient_steps']} gradient steps, fleet {killed['fleet']}, shippers {kspy['shippers']}")
    cfg = compose([*SACF_KILL_ARGS, "device=cpu"])
    env = ContinuousDummyEnv(action_dim=int(cfg.env.wrapper.action_dim))
    agent = build_agent(cfg, env.observation_space, env.action_space, agent_state=record["start"], device="cpu")
    optimizers = make_optimizers(agent, cfg)
    reference = _replay_on_cpu("sac fleet first train call", record, agent, optimizers, make_train_step(agent, optimizers, cfg),
                               {"loss_rtol": 1e-4, "loss_atol": 1e-6, "param_change": SAC_PARAM_CHANGE_TOL, "adam_moment": SAC_MOMENT_TOL})  # fmt: skip

    chaos.reset()
    sig_root = os.path.join(root, "sigterm")
    _fleet_run([*SACF_ARGS, "seed=5", *_chaos(f"{{kind: sigterm, at_step: {SACF_SIGNAL}}}")], "sac fleet sigterm", sig_root)
    guard = last_guard_stats()
    saved = _newest(sig_root)
    if not guard["preempted"] or not saved or parse_ckpt_name(saved[-1])[0] != SACF_SIGNAL:
        fail(f"sac fleet sigterm: guard {guard}, checkpoints {saved}")
    chaos.reset()
    resumed, wall, _, rspy, _ = _fleet_run([*SACF_ARGS, "seed=5", f"checkpoint.resume_from=auto:{sig_root}"], "sac fleet resume", sig_root)
    fleet = resumed["fleet"]
    a, b = load_checkpoint(nonfleet["last_checkpoint"]), load_checkpoint(_newest(sig_root)[-1])
    if a["iter_num"] != b["iter_num"] or a["rb"]["pos"] != b["rb"]["pos"] or resumed["gradient_steps"] != nonfleet_steps:
        fail(f"sac fleet sigterm: resumed to iter {b['iter_num']} pos {b['rb']['pos']} ({resumed['gradient_steps']} gradient steps), phase 49's "
             f"no-fault run iter {a['iter_num']} pos {a['rb']['pos']} ({nonfleet_steps})")  # fmt: skip
    if fleet["rows_dropped"] or fleet["restarts"] or rspy["shippers"] != {0, 1}:
        fail(f"sac fleet resume (no fault): fleet {fleet}, shippers {rspy['shippers']}")
    iters = (cfg_total(SACF_ARGS) - SACF_SIGNAL) // int(cfg.env.num_envs)  # the resumed run's
    result = {"cuts": SACF_CUTS, "gradient_steps": resumed["gradient_steps"], "nonfleet_gradient_steps": nonfleet_steps, "host_wall_s": wall,
              "host_wall_ms_per_iteration": wall * 1e3 / iters, "fleet": fleet, "ln_gru_launches": counts,
              "first_call_card_vs_cpu": reference, "kill9": {"at_step": SACF_KILL_AT, "fleet": killed["fleet"], "death_to_first_shipment_s": restart_s,
              "spawns": kspy["spawns"], "host_wall_s": kill_wall}, "sigterm": {"signal_at": SACF_SIGNAL, "saved_at": parse_ckpt_name(saved[-1])[0],
              "drain_to_exit_s": guard["drain_to_exit_s"], "iter_num": b["iter_num"], "rb_pos": b["rb"]["pos"]},
              "took_s": time.perf_counter() - t0}  # fmt: skip
    log(f"sac fleet (58): resumed no-fault run {resumed['gradient_steps']} gradient steps in all (non-fleet {nonfleet_steps}), {result['host_wall_ms_per_iteration']:.2f} "
        f"ms learner host wall an iteration after its replicas' hellos, replicas' spawn-to-hello {[round(s, 3) for s in fleet['hello_s']]} s, broadcasts "
        f"{fleet['param_bytes']} bytes in {fleet['param_send_s'] * 1e3:.3f} ms of pump sends; first train call (kill9 run) card vs CPU: worst leaf "
        f"{reference['worst_param_change']}, worst moment {reference['worst_adam_moment']}; kill9 at replica 0's step {SACF_KILL_AT}: 1 restart, death to "
        f"first shipment {restart_s:.3f} s; sigterm at {SACF_SIGNAL}: saved at {result['sigterm']['saved_at']}, drain-to-exit "
        f"{guard['drain_to_exit_s']:.3f} s, resumed to iter {b['iter_num']} pos {b['rb']['pos']} (phase 49's no-fault run: the same); took "
        f"{result['took_s']:.1f} s (cuts {json.dumps(SACF_CUTS)})")  # fmt: skip
    torch.cuda.empty_cache()
    return result


def _ppo_steps_on_cpu(what, record, cfg, tol, trajectory_tol, trajectory_steps):
    """The recorded first update replayed on the card from the recorded
    state: it must end bit for bit where the run's ended. Then each of its
    Adam steps is held against one CPU step from the card's own state and
    Adam state at that step (the losses within ``tol['loss_rtol']``, each
    leaf's change and Adam moment within ``tol``), and the card's losses of
    its first ``trajectory_steps`` steps against the CPU's own update from
    the recorded state (within ``trajectory_tol``). Past those steps the
    clipped surrogate's kink parts the two trajectories (on the chip, a ratio
    1.19999967 on the card and 1.20001165 on the CPU at step 73: the two
    sides of the clip), which no bound on rounding covers: the whole
    update's gaps are reported."""
    import torch

    from sheeprl_tpu_torch.algos.ppo.agent import build_agent
    from sheeprl_tpu_torch.algos.ppo.ppo import make_update_pool
    from sheeprl_tpu_torch.core.onpolicy import make_optimizer

    obs_space, actions_dim, continuous = _ppo_spaces(cfg)

    def setup(dev):
        agent = build_agent(actions_dim, continuous, cfg, obs_space, device=dev, agent_state=record["start"])
        optimizer, _ = make_optimizer(agent, cfg)
        return agent, optimizer, make_update_pool(agent, optimizer, cfg)

    def moments(agent, optimizer):
        names = dict(agent.named_parameters())
        return {f"{m} {n}": optimizer.state[p][m].detach().cpu().clone() for n, p in names.items() for m in ("exp_avg", "exp_avg_sq")}

    def gap_of(got, want, k):
        return abs(float(got[k]) - float(want[k]))

    pool, indices, clip, ent = record["args"]
    card, card_opt, card_step = setup("cuda")
    cpu, cpu_opt, cpu_step = setup("cpu")
    whole_cpu, whole_opt, whole_step = setup("cpu")  # the CPU's own update, step by step
    card_pool = {k: v.cuda() for k, v in pool.items()}
    steps = [(e, m) for e in range(indices.shape[0]) for m in range(indices.shape[1])]
    worst_loss, worst_param, worst_moment, worst_trajectory = 0.0, (0.0, ""), (0.0, ""), (0.0, "")
    for i, (e, m) in enumerate(steps):
        start = {k: v.detach().cpu().clone() for k, v in card.state_dict().items()}
        cpu.load_state_dict(start)
        if card_opt.state:
            state = card_opt.state_dict()
            # The CPU's own groups: the card's Adam is capturable, the CPU's not (the learning rate is one through the update).
            cpu_opt.load_state_dict({"state": {i: {k: v.detach().cpu().clone() for k, v in s.items()} for i, s in state["state"].items()},
                                     "param_groups": cpu_opt.state_dict()["param_groups"]})  # fmt: skip
        got = card_step(card_pool, indices[e : e + 1, m : m + 1].cuda(), clip.cuda(), ent.cuda())
        want = cpu_step(pool, indices[e : e + 1, m : m + 1], clip, ent)
        own = whole_step(pool, indices[e : e + 1, m : m + 1], clip, ent)
        for k in want:
            gap = gap_of(got, want, k)
            if gap > tol["loss_atol"] + tol["loss_rtol"] * abs(float(want[k])):
                fail(f"{what}: Adam step {e},{m}: {k} {float(got[k])} on the card, {float(want[k])} on the CPU")
            worst_loss = max(worst_loss, gap)
            if i < trajectory_steps:
                gap = gap_of(got, own, k)
                if gap > trajectory_tol["loss_atol"] + trajectory_tol["loss_rtol"] * abs(float(own[k])):
                    fail(f"{what}: Adam step {i} ({e},{m}) of the update: {k} {float(got[k])} on the card, {float(own[k])} in the CPU's own update "
                         f"(limits {trajectory_tol})")  # fmt: skip
                worst_trajectory = max(worst_trajectory, (gap / (abs(float(own[k])) or 1.0), f"{i} {k}"))
        end_card = {k: v.detach().cpu() for k, v in card.state_dict().items()}
        end_cpu = {k: v.detach().clone() for k, v in cpu.state_dict().items()}
        moved = [k for k in end_cpu if not torch.equal(end_cpu[k], start[k])]
        param = max((g, f"{e},{m} {k}") for k, g in _relative_gaps({k: end_card[k] for k in moved}, {k: end_cpu[k] for k in moved}, start, start).items())
        moment = max((g, f"{e},{m} {k}") for k, g in _relative_gaps(moments(card, card_opt), moments(cpu, cpu_opt)).items())
        worst_param, worst_moment = max(worst_param, param), max(worst_moment, moment)
        if param[0] > tol["param_change"] or moment[0] > tol["adam_moment"]:
            fail(f"{what}: Adam step {e},{m} from the card's state: worst leaf change {param}, worst Adam moment {moment} (limits {tol})")
    replayed = {k: v.detach().cpu() for k, v in card.state_dict().items()}
    differ = [k for k in replayed if not torch_equal_bits(replayed[k], record["end"][k])]
    if differ:
        fail(f"{what}: the update replayed on the card from the recorded state ends off the run's: {differ[:4]}")
    end = {k: v.detach().clone() for k, v in whole_cpu.state_dict().items()}
    moved = [k for k in end if not torch.equal(end[k], record["start"][k])]
    whole = {"worst_param_change": max((g, k) for k, g in _relative_gaps({k: record["end"][k] for k in moved}, {k: end[k] for k in moved},
                                                                            record["start"], record["start"]).items()),
             "worst_adam_moment": max((g, k) for k, g in _relative_gaps(record["moments"], moments(whole_cpu, whole_opt)).items())}  # fmt: skip
    return {"adam_steps": len(steps), "replay_on_card_bit_for_bit": True, "worst_loss_gap": worst_loss,
            "worst_param_change_per_step": {"step_leaf": worst_param[1], "gap": worst_param[0]},
            "worst_adam_moment_per_step": {"step_leaf": worst_moment[1], "gap": worst_moment[0]},
            "trajectory_steps_held": trajectory_steps, "worst_trajectory_loss_gap": {"step_loss": worst_trajectory[1], "relative_gap": worst_trajectory[0]},
            "whole_update_reported": whole, "tolerance": tol, "trajectory_tolerance": trajectory_tol}  # fmt: skip


def phase_ppo_fleet(log_root, nonfleet_ms=None):
    """(59) ``exp=ppo_decoupled`` with ``fleet.replicas=2`` (``PPOF_CUTS``),
    one run: every round gathers 2 rollouts of its version; the first update
    (round 1, no fault yet) on its pool replayed on the card bit for bit and
    each of its Adam steps held against the CPU from the card's state at
    ``PPOF_STEP_TOL``, the losses of its first ``PPOF_TRAJECTORY_STEPS``
    against the CPU's own update (``_ppo_steps_on_cpu``); a ``kill9`` on replica 0 while
    it ships round 3's rollout (one restart, seeded ``replica_seed(seed, 0,
    1)``; its generation 1 ships into a round); the learner's host wall of
    round 2 (between the first two updates; beside phase 50's an iteration),
    the broadcast's bytes and pump send time, the replicas' spawn seconds."""
    from sheeprl_tpu_torch.algos.ppo import ppo_decoupled
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.core import chaos

    t0 = time.perf_counter()
    chaos.reset()
    rounds_done = []
    out, wall, counts, spy, record = _fleet_run([*PPOF_ARGS, "seed=5", *_chaos(f"{{kind: kill9, at_step: {PPOF_KILL_AT}, replica: 0}}")], "ppo fleet",
                                                os.path.join(log_root, "ppo_fleet"), ppo_decoupled, "make_update_pool",
                                                callback=lambda *a: rounds_done.append(time.perf_counter()))  # fmt: skip
    fleet = out["fleet"]
    cfg = compose([*PPOF_ARGS, "device=cpu"])
    rounds = int(cfg.algo.total_steps) // (int(cfg.algo.rollout_steps) * int(cfg.env.num_envs) * FLEET_REPLICAS)
    members = [sorted(tuple(m) for m in ms) for _, ms in fleet["rounds"]]
    if out["updates"] != rounds or any(sorted(r for r, _ in ms) != [0, 1] for ms in members) or members[:2] != [[(0, 0), (1, 0)]] * 2:
        fail(f"ppo fleet: {out['updates']} updates (expected {rounds}), rounds {fleet['rounds']}, fleet {fleet}")
    restart_s = _check_restart("ppo fleet kill9", spy)
    if fleet["restarts"] != 1 or not any((0, 1) in ms for ms in members):
        fail(f"ppo fleet kill9: rounds {fleet['rounds']}, fleet {fleet} (replica 0's generation 1 must ship into a round)")
    reference = _ppo_steps_on_cpu("ppo fleet first update", record, cfg, PPOF_STEP_TOL, PPOF_TRAJECTORY_TOL, PPOF_TRAJECTORY_STEPS)
    round_ms = (rounds_done[1] - rounds_done[0]) * 1e3
    result = {"cuts": PPOF_CUTS, "updates": out["updates"], "host_wall_s": wall, "host_wall_ms_per_iteration": round_ms,
              "nonfleet_host_wall_ms_per_iteration": nonfleet_ms, "fleet": fleet, "ln_gru_launches": counts, "first_update_card_vs_cpu": reference,
              "kill9": {"at_step": PPOF_KILL_AT, "rounds": fleet["rounds"], "death_to_first_shipment_s": restart_s, "spawns": spy["spawns"]},
              "took_s": time.perf_counter() - t0}  # fmt: skip
    log(f"ppo fleet (59): {out['updates']} rounds of {[len(m) for m in members]} rollouts, round 2 (no fault) {round_ms:.1f} ms of learner host "
        f"wall (phase 50, one in-process player: {nonfleet_ms if nonfleet_ms is None else round(nonfleet_ms, 1)} ms an "
        f"iteration), broadcasts {fleet['param_bytes']} bytes in {fleet['param_send_s'] * 1e3:.3f} ms of pump sends, replicas' spawn-to-hello "
        f"{[round(s, 3) for s in fleet['hello_s']]} s; first update replayed on the card bit for bit, its {reference['adam_steps']} Adam "
        f"steps against the CPU from the card's state: worst leaf {reference['worst_param_change_per_step']}, worst moment "
        f"{reference['worst_adam_moment_per_step']}, the first {PPOF_TRAJECTORY_STEPS} steps' losses against the CPU's own update: worst "
        f"{reference['worst_trajectory_loss_gap']} (the whole update, reported: {reference['whole_update_reported']}); kill9 at replica 0's step "
        f"{PPOF_KILL_AT}: rounds {fleet['rounds']}, death to first shipment {restart_s if restart_s is None else round(restart_s, 3)} s; took "
        f"{result['took_s']:.1f} s (cuts {json.dumps(PPOF_CUTS)})")  # fmt: skip
    return result


def size_rows(size, depth, hidden):
    """(60) The LN-GRU entry points at one DreamerV3 size's shapes: the
    forward (the kernel ``forward_plan`` picks) at the scan's B = 16, the
    imagination's B = 1024 and the player's B = 1, bf16 and f32, and the
    backward at B = 16 and 1024, each against its plain version
    (``check_forward``'s and ``check_backward``'s tolerances, its launch
    counted), timed beside its plain version, its bound and, for the
    forward, cuBLAS's product alone. B = 1024 is timed 5 x 4 calls."""
    import torch

    from sheeprl_tpu_torch.models.ln_gru import (
        _aligned,
        _sm_count,
        forward_plan,
        ln_gru_backward,
        ln_gru_backward_plain,
        ln_gru_forward,
        ln_gru_forward_streaming,
        ln_gru_forward_tensor_core,
        ln_gru_plain,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    for batch, where in DV3_SIZE_BATCHES:
        r = (5, 4) if batch >= 1024 else (15, 20)
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            args = gru_inputs(batch, depth, hidden, dtype, seed=11)
            what = f"dv3-{size} ln_gru B={batch} D={depth} H={hidden} {dname}"
            plan = forward_plan(batch, depth, hidden, dtype, _sm_count(0), _aligned(args[0], args[1], args[5]))
            entry_fn = ln_gru_forward_tensor_core if plan.kernel == "tensor_core" else ln_gru_forward_streaming
            before = (ln_gru_forward.launches, entry_fn.launches)
            errs = check_forward(ln_gru_forward, args, what)
            errs_entry = check_forward(entry_fn, args, f"{what} ({plan.kernel} entry point)")
            if (ln_gru_forward.launches, entry_fn.launches) != (before[0] + 1, before[1] + 2):
                fail(f"{what}: ln_gru_forward did not count one launch on the {plan.kernel} kernel")
            fwd = timed(rotated(args, ln_gru_forward), *r)
            plain_ms = device_ms(rotated(args, ln_gru_plain), *r)[0]
            product_ms = device_ms(rotated(args[:2], torch.matmul), *r)[0]
            bound_ms, bound_by = gru_bound(batch, depth, hidden, dname)
            row = {"size": size, "shape": f"B={batch} D={depth} H={hidden}", "batch": batch, "where": where, "dtype": dname, "kernel": plan.kernel,
                   "cluster": plan.cluster, "forward": {**errs, **fwd, "plain_ms": plain_ms, "product_library_ms": product_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, f"{plan.kernel}_entry_point": errs_entry}}  # fmt: skip
            note = (f"{what} ({where}): {plan.kernel} (grid {plan.grid}, cluster {plan.cluster}), forward {fwd['ms'] * 1e3:.2f} us "
                    f"[{fwd['ms_min'] * 1e3:.2f}, {fwd['ms_max'] * 1e3:.2f}], plain {plain_ms * 1e3:.2f} us, product alone {product_ms * 1e3:.2f} us, "
                    f"bound {bound_ms * 1e3:.2f} us ({bound_by}), max|dh| {errs['max_abs_err_h']:.3g}")  # fmt: skip
            if batch in DV3_SIZE_BWD:
                _, z = ln_gru_forward(*args)
                g = gru_inputs(batch, 1, hidden, dtype, seed=12)[5]
                bargs = (g, z, args[3], args[4], args[5])
                berrs = check_backward(bargs, f"{what} ln_gru_backward")
                bwd = timed(rotated(bargs, ln_gru_backward), *r)
                bwd_plain_ms = device_ms(rotated(bargs, ln_gru_backward_plain), *r)[0]
                bwd_bound_ms, bwd_bound_by = gru_bwd_bound(batch, hidden, dname)
                row["backward"] = {"max_abs_err": berrs, **bwd, "plain_ms": bwd_plain_ms, "bound_ms": bwd_bound_ms, "bound_by": bwd_bound_by}
                note += (f"; backward {bwd['ms'] * 1e3:.2f} us, plain {bwd_plain_ms * 1e3:.2f} us, bound {bwd_bound_ms * 1e3:.2f} us ({bwd_bound_by}), "
                         f"max|d| {json.dumps({k: float(f'{v:.3g}') for k, v in berrs.items()})}")  # fmt: skip
                del bargs, z
            rows.append(row)
            log(note)
            del args
            torch.cuda.empty_cache()
    return rows


def size_step(size, log_root):
    """(60) One bf16-mixed gradient step of ``algo=dreamer_v3_<size>`` through
    the CLI (``DV3_SIZE_CUTS``): finite losses, the LN-GRU launches by batch
    (forward 64 at B = 16 and 15 at B = 1024, backward 64 at B = 16, as
    DV3-S; by kernel: the imagination's on the tensor cores for XS, streaming
    for M and L); then one more step of the trained agent on a fixed batch:
    host wall (ending in a synchronize), device busy from torch.profiler
    (CUDA activity only; L's step only, ``DV3_SIZE_PROFILED``), peak
    memory."""
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import make_optimizers, make_train_step
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.utils.distribution import BatchGenerator
    from sheeprl_tpu_torch.utils.ops import init_moments

    args = [*DV3_SIZE_ARGS, f"algo=dreamer_v3_{size}", f"log_root={log_root}"]
    out, steps, wall, counts = dreamer_through_cli(args, f"dv3-{size} gradient step", FWD_BY_BATCH, BWD_BY_BATCH)
    want_tc = TC_PER_STEP if size == "XS" else 0
    if len(steps) != 1 or counts["tensor_core"] != want_tc:
        fail(f"dv3-{size}: {len(steps)} gradient steps, launches {counts} (the imagination's {want_tc} on the tensor cores expected)")
    agent, cfg = out["agent"], compose(args[:-1])
    dev = torch.device("cuda")
    step = make_train_step(agent, make_optimizers(agent, cfg), cfg)
    data = _train_batch(int(cfg.algo.per_rank_sequence_length), int(cfg.algo.per_rank_batch_size), 7, dev, sum(agent.actions_dim), agent.is_continuous)
    rng = BatchGenerator.from_seed(0, dev)
    moments = init_moments(dev)
    moments, _ = step(moments, data, rng, 0.02)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    moments, metrics = step(moments, data, rng, 0.02)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    box = [moments]

    def one():
        box[0], _ = step(box[0], data, rng, 0.02)

    busy_ms, ops = _busy(read_profile(profiled(one))[0], 1, skip=("dv3/",))[:2] if size in DV3_SIZE_PROFILED else (None, None)
    losses = {k: v for k, v in steps[0][2].items() if "loss" in k.lower()}
    if not all(math.isfinite(v) for v in losses.values()):
        fail(f"dv3-{size}: non-finite losses {losses}")
    result = {"size": size, "cuts": DV3_SIZE_CUTS, "gradient_steps": len(steps), "ln_gru_launches": counts, "losses": losses, "cli_wall_s": wall,
              "host_wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy_ms,
              "device_idle_share": None if busy_ms is None else max(0.0, 1.0 - busy_ms / wall_ms),
              "device_ops_per_step": ops, "peak_memory_gib": peak_gib,
              "params": sum(p.numel() for p in agent.parameters())}  # fmt: skip
    busy = "not profiled" if busy_ms is None else f"{busy_ms:.2f} ms/step (idle share {result['device_idle_share']:.3f}, {ops:.0f} device ops)"
    log(f"dv3-{size} gradient step (60): {result['params']} parameters, losses {json.dumps({k: round(v, 4) for k, v in losses.items()})}, LN-GRU "
        f"launches {json.dumps(counts)}, host wall {wall_ms:.2f} ms/step, device busy {busy}, peak memory {peak_gib:.2f} GiB; the CLI run "
        f"took {wall:.1f} s")  # fmt: skip
    del out, agent, step, moments, data
    torch.cuda.empty_cache()
    return result


def phase_dv3_sizes(log_root):
    """(60) XS, M and L: every LN-GRU shape (``size_rows``), then one gradient
    step through the CLI (``size_step``)."""
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.models.ln_gru import tensor_core_fits

    t0 = time.perf_counter()
    out = {}
    for size, (depth, hidden) in DV3_SIZES.items():
        cfg = compose(["exp=dreamer_v3_100k_ms_pacman", f"algo=dreamer_v3_{size}", "env=dummy"])
        rec = int(cfg.algo.world_model.recurrent_model.recurrent_state_size)
        if (rec, rec + int(cfg.algo.dense_units)) != (hidden, depth) or tensor_core_fits(depth, hidden) != (size == "XS"):
            fail(f"dv3-{size}: the composed config gives H = {rec}, D = {rec + int(cfg.algo.dense_units)}; expected {(hidden, depth)}")
        out[size] = {"kernels": size_rows(size, depth, hidden), "step": size_step(size, os.path.join(log_root, f"dv3_{size}"))}
    out["took_s"] = time.perf_counter() - t0
    log(f"dv3 sizes (60): took {out['took_s']:.1f} s (step cuts {json.dumps(DV3_SIZE_CUTS)})")
    return out


def phases_58_60(workdir, nonfleet_sac=None, nonfleet_ppo_ms=None):
    """Phases 58-60 (they run alone too, after ``kernels.build()``; 58 then
    runs phase 49's non-fleet run for its count and checkpoint)."""
    t0 = time.perf_counter()
    sac = phase_sac_fleet(workdir, nonfleet_sac)
    ppo = phase_ppo_fleet(workdir, nonfleet_ppo_ms)
    sizes = phase_dv3_sizes(workdir)
    took = time.perf_counter() - t0
    log(f"fleet and dv3 sizes: phases 58-60 took {took:.1f} s")
    return {"sac_fleet": sac, "ppo_fleet": ppo, "dv3_sizes": sizes, "phases_58_60_s": took}


# The env layer (phase 61): DreamerV3-S at full width on env=dummy with
# its envs in worker processes against in-process, a planted env fault,
# the workers in the run's trace, and the env groups' gates.
ENV_LAYER_ARGS = ["exp=dreamer_v3_100k_ms_pacman", "env=dummy", "fabric.precision=bf16-mixed", "env.num_envs=4", "+env.wrapper.n_steps=100",
                  "algo.learning_starts=256", "algo.total_steps=276", "algo.replay_ratio=0.25", "buffer.size=4096", "buffer.memmap=False",
                  "metric.log_every=8", "algo.run_test=False", "checkpoint.every=0"]  # fmt: skip
ENV_LAYER_CUTS = {"algo.learning_starts": "256 (from 1024: 64 prefill steps of 4 envs, one env/steps span a worker)",
                  "algo.total_steps": "276 (from 100000; 5 policy iterations after the prefill)", "algo.replay_ratio": "0.25 (from 1: one gradient "
                  "step an iteration)", "buffer.size": "4096, in memory", "env.wrapper.n_steps": "100 (from 4: no episode ends within a span window)"}  # fmt: skip
ENV_FAULT_AT = 10  # env 1's 10th step raises inside its worker
ENV_FAULT_ENV = 1
ENV_FAULT_WAIT_S = 0.5  # RestartOnException's wait for the drill (the port's default stays 20 s)
ENV_GATES = {"gym": ("exp=ppo", "gymnasium"), "mujoco": ("exp=ppo_mujoco", "gymnasium"), "dmc": ("exp=dreamer_v3_dmc_walker_walk", "dm_control")}


class RaiseAtStep:
    """An env thunk whose env raises ``RuntimeError`` in its ``at_step``-th
    step, once per thunk object: ``RestartOnException`` rebuilds the env from
    the same thunk in the same worker, and the rebuilt env steps on. It is
    pickled into the worker (a spawned worker imports this script as its
    main module, whose top level imports only the standard library)."""

    def __init__(self, thunk, at_step):
        self.thunk, self.at_step, self.fired = thunk, int(at_step), False

    def __call__(self):
        env = self.thunk()
        if self.fired:
            return env
        inner, steps = env.step, [0]

        def step(action):
            steps[0] += 1
            if steps[0] == self.at_step and not self.fired:
                self.fired = True
                raise RuntimeError(f"planted fault in step {self.at_step}")
            return inner(action)

        env.step = step
        return env


def _env_layer_run(args, what, restart_kwargs=None):
    """One DreamerV3-S CLI run of phase 61: its envs (timed per step), host
    buffer and ring, LN-GRU launches, gradient steps and final parameters."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.data import device_buffer
    from sheeprl_tpu_torch.utils.env import make_vector_env

    seen = {"buffers": [], "rings": [], "envs": [], "step_s": []}

    def timed_envs(cfg, restart_on_exception):
        envs = make_vector_env(cfg, restart_on_exception=restart_kwargs or restart_on_exception)
        step = envs.step

        def timed_step(actions):
            t0 = time.perf_counter()
            out = step(actions)
            seen["step_s"].append(time.perf_counter() - t0)
            return out

        envs.step = timed_step
        seen["envs"].append(envs)
        return envs

    class Recorded(dv3.EnvIndependentReplayBuffer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            seen["buffers"].append(self)

    ring_init = device_buffer.DeviceReplayRing.__init__

    def recording_ring(self, *a, **k):
        ring_init(self, *a, **k)
        seen["rings"].append(self)

    zero_counts()
    t0 = time.perf_counter()
    with patched(dv3, "make_vector_env", timed_envs), patched(dv3, "EnvIndependentReplayBuffer", Recorded), \
            patched(device_buffer.DeviceReplayRing, "__init__", recording_ring):  # fmt: skip
        out = run(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    last = out["log"][-1] if out["log"] else {}
    if out["gradient_steps"] < 1 or not all(math.isfinite(v) for v in last.values()):
        fail(f"{what}: {out['gradient_steps']} gradient steps, last logged {last}")
    envs = seen["envs"][0]
    params = {k: v.detach().cpu().clone() for k, v in out["agent"].state_dict().items()}
    # The rows written (np.empty leaves the rest as it found it).
    rows = [{k: np.asarray(v)[: b.buffer_size if b.full else b._pos].copy() for k, v in b.buffer.items()} for b in seen["buffers"][0].buffer]
    ring = {k: v.detach().cpu().clone() for k, v in seen["rings"][0]._data.items()} if seen["rings"] else None
    step_ms = [s * 1e3 for s in seen["step_s"]]
    return {"out": out, "params": params, "rows": rows, "ring": ring, "counts": counts, "wall_s": wall,
            "spawn_s": getattr(envs, "spawn_s", None), "worker_pids": list(getattr(envs, "worker_pids", [])),
            "env_step_ms_median": statistics.median(step_ms), "env_step_ms_p90": sorted(step_ms)[int(0.9 * (len(step_ms) - 1))],
            "env_steps": len(step_ms)}  # fmt: skip


def _same(a, b, what, where):
    """``a`` and ``b`` (trees of tensors or arrays) equal bit for bit."""
    import numpy as np
    import torch

    if isinstance(a, dict):
        if set(a) != set(b):
            fail(f"{what}: {where} keys differ: {sorted(set(a) ^ set(b))}")
        for k in a:
            _same(a[k], b[k], what, f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, what, f"{where}[{i}]")
    elif isinstance(a, torch.Tensor):
        if a.shape != b.shape or not torch.equal(a, b):
            fail(f"{what}: {where} differs between the in-process and the worker-process envs")
    elif not np.array_equal(a, b):
        fail(f"{what}: {where} differs between the in-process and the worker-process envs")


def phase_env_layer(workdir):
    """(61) The env layer on DreamerV3-S at full width (``ENV_LAYER_ARGS``,
    bf16-mixed, 4 envs): (a) on the host buffer and on the ring
    (``buffer.device=True``), ``env.sync_env=False`` against ``True`` from
    the same seed: every stored row, the ring and the parameters after the
    last gradient step bit for bit, the LN-GRU launches equal and, per
    gradient step, phase 7's; the workers' spawn to ready and the host wall
    per env step of each mode. (b) A fault planted in env 1's thunk
    (:class:`RaiseAtStep`, through ``utils.env.make_env``, as the CPU test
    that holds the patch against the JAX loop plants it): its env raises
    inside its worker at its ``ENV_FAULT_AT``-th step on the ring path:
    ``RestartOnException`` (``wait`` ``ENV_FAULT_WAIT_S``) rebuilds the env,
    the host buffer's and the ring's row read terminated 0, truncated 1,
    is_first 0 and the next row is_first 1, and the run trains on with
    finite losses. (c) The async host run's flight dir: ``aggregate_traces``
    holds one process group per worker pid with ``env/steps`` spans. (d)
    ``env=gym``, ``mujoco`` and ``dmc`` raise with ``require``'s message
    where their package is missing."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.telemetry.flight import aggregate_traces
    from sheeprl_tpu_torch.utils import env as env_mod
    from sheeprl_tpu_torch.utils import imports

    card = nvidia_smi()
    t_phase = time.perf_counter()
    result = {"cuts": ENV_LAYER_CUTS, "card": card}
    # (a) worker processes against in-process, on both paths.
    for path, extra in (("host", []), ("ring", ["buffer.device=True"])):
        runs = {}
        for mode in ("True", "False"):
            what = f"env layer {path} sync_env={mode}"
            runs[mode] = _env_layer_run([*ENV_LAYER_ARGS, *extra, f"env.sync_env={mode}", f"log_root={os.path.join(workdir, 'env_layer', path + mode)}"],
                                        what)  # fmt: skip
        sync, asyn = runs["True"], runs["False"]
        if asyn["spawn_s"] is None or len(set(asyn["worker_pids"])) != 4 or os.getpid() in asyn["worker_pids"]:
            fail(f"env layer {path}: the async run did not step its envs in 4 worker processes ({asyn['worker_pids']})")
        _same(sync["rows"], asyn["rows"], f"env layer {path}", "host buffer")
        _same(sync["ring"], asyn["ring"], f"env layer {path}", "ring")
        _same(sync["params"], asyn["params"], f"env layer {path}", "parameters")
        if sync["counts"] != asyn["counts"] or sync["out"]["gradient_steps"] != asyn["out"]["gradient_steps"]:
            fail(f"env layer {path}: launches {sync['counts']} / {asyn['counts']}, gradient steps {sync['out']['gradient_steps']} / "
                 f"{asyn['out']['gradient_steps']}")  # fmt: skip
        g = asyn["out"]["gradient_steps"]
        per_step = {"forward_by_batch": {b: asyn["counts"]["forward_by_batch"].get(b, 0) / g for b in FWD_BY_BATCH},
                    "backward_by_batch": {b: asyn["counts"]["backward_by_batch"].get(b, 0) / g for b in BWD_BY_BATCH}}  # fmt: skip
        if path == "host" and (per_step["forward_by_batch"] != {b: float(n) for b, n in FWD_BY_BATCH.items()}
                               or per_step["backward_by_batch"] != {b: float(n) for b, n in BWD_BY_BATCH.items()}):  # fmt: skip
            fail(f"env layer host: LN-GRU launches per gradient step {per_step}, phase 7's {FWD_BY_BATCH} / {BWD_BY_BATCH}")
        result[path] = {
            "gradient_steps": g, "policy_steps": asyn["out"]["policy_steps"], "ln_gru_launches": asyn["counts"], "ln_gru_per_gradient_step": per_step,
            "bit_for_bit": ["host buffer rows", "ring" if asyn["ring"] is not None else None, "parameters"],
            "spawn_to_ready_s": asyn["spawn_s"], "env_steps": asyn["env_steps"],
            "host_wall_ms_per_env_step": {"in_process": sync["env_step_ms_median"], "workers": asyn["env_step_ms_median"]},
            "host_wall_ms_per_env_step_p90": {"in_process": sync["env_step_ms_p90"], "workers": asyn["env_step_ms_p90"]},
            "run_wall_s": {"in_process": sync["wall_s"], "workers": asyn["wall_s"]},
        }  # fmt: skip
        log(f"env layer (61) {path} path on {card}: env.sync_env=False equals True bit for bit ({g} gradient steps, "
            f"{asyn['env_steps']} env steps, rows, {'ring, ' if asyn['ring'] is not None else ''}parameters); LN-GRU launches "
            f"{json.dumps(asyn['counts'])}, per gradient step {json.dumps(per_step)}; workers ready {asyn['spawn_s']:.3f} s after spawn; host "
            f"wall per env step (median, p90) in-process {sync['env_step_ms_median']:.3f} / {sync['env_step_ms_p90']:.3f} ms, workers "
            f"{asyn['env_step_ms_median']:.3f} / {asyn['env_step_ms_p90']:.3f} ms; runs {sync['wall_s']:.1f} / {asyn['wall_s']:.1f} s")  # fmt: skip
        if path == "host":
            # (c) the workers in the async run's trace.
            flight_dir = os.path.join(asyn["out"]["log_dir"], "flight")
            merged = aggregate_traces(flight_dir)
            spans = [ev for ev in merged["traceEvents"] if ev.get("ph") == "X"]
            by_pid = {pid: sorted({ev["name"] for ev in spans if ev.get("pid") == pid}) for pid in asyn["worker_pids"]}
            if any("env/steps" not in names for names in by_pid.values()):
                fail(f"env layer (c): the merged trace's worker groups {by_pid}")
            trace_ids = {ev["args"].get("trace_id") for ev in spans if ev.get("pid") in by_pid}
            result["trace"] = {"worker_groups": {str(k): v for k, v in by_pid.items()}, "pids": sorted({ev.get("pid") for ev in spans}),
                               "worker_trace_ids": sorted(t for t in trace_ids if t), "sources": len(merged["metadata"]["sources"])}  # fmt: skip
            log(f"env layer (61c) on {card}: aggregate_traces over {flight_dir}: {len(result['trace']['pids'])} process groups, each of the 4 "
                f"workers with env/steps spans; worker trace ids {result['trace']['worker_trace_ids']}")  # fmt: skip
        del runs, sync, asyn
        torch.cuda.empty_cache()

    # (b) a fault planted in env 1's thunk, raising in its worker, on the ring path (both buffers).
    make_env = env_mod.make_env

    def faulty_make_env(cfg, seed, rank, vector_env_idx=0):
        thunk = make_env(cfg, seed, rank, vector_env_idx=vector_env_idx)
        return RaiseAtStep(thunk, ENV_FAULT_AT) if vector_env_idx == ENV_FAULT_ENV else thunk

    with patched(env_mod, "make_env", faulty_make_env):
        faulted = _env_layer_run(
            [*ENV_LAYER_ARGS, "buffer.device=True", "env.sync_env=False", f"log_root={os.path.join(workdir, 'env_layer', 'fault')}"],
            "env layer fault", restart_kwargs={"wait": ENV_FAULT_WAIT_S})  # fmt: skip
    row, e = ENV_FAULT_AT - 1, ENV_FAULT_ENV
    host = {k: faulted["rows"][e][k][row : row + 2].reshape(2, -1)[:, 0].tolist() for k in ("terminated", "truncated", "is_first")}
    ring = {k: faulted["ring"][k][row : row + 2, e].reshape(2, -1)[:, 0].tolist() for k in ("terminated", "truncated", "is_first")}
    want = {"terminated": [0.0, 0.0], "truncated": [1.0, 0.0], "is_first": [0.0, 1.0]}
    frames = faulted["rows"][e]["rgb"][row : row + 2].reshape(2, -1)[:, 0].tolist()
    if host != want or ring != want or frames != [row, 0]:
        fail(f"env layer (b): rows {row}-{row + 1} of env 1 host {host}, ring {ring}, frames {frames}; expected {want} and frames [{row}, 0]")
    losses = {k: v for k, v in faulted["out"]["log"][-1].items() if "loss" in k.lower()}
    result["fault"] = {"at_step": ENV_FAULT_AT, "wait_s": ENV_FAULT_WAIT_S, "rows": {"host": host, "ring": ring, "frames": frames},
                       "gradient_steps": faulted["out"]["gradient_steps"], "losses": losses, "run_wall_s": faulted["wall_s"]}  # fmt: skip
    log(f"env layer (61b) on {card}: env 1 raised in its worker at its step {ENV_FAULT_AT}, RestartOnException rebuilt it; rows {row}-{row + 1} "
        f"host {json.dumps(host)}, ring {json.dumps(ring)}; then {faulted['out']['gradient_steps']} gradient steps, losses "
        f"{json.dumps({k: round(v, 4) for k, v in losses.items()})}")  # fmt: skip
    del faulted
    torch.cuda.empty_cache()

    # (d) the gates.
    gates = {}
    for group, (exp, package) in ENV_GATES.items():
        flag = {"gymnasium": imports._IS_GYMNASIUM_AVAILABLE, "dm_control": imports._IS_DMC_AVAILABLE}[package]
        if flag:
            gates[group] = f"{package} is importable here: not gated"
            continue
        try:
            run([exp, f"env={group}", f"log_root={os.path.join(workdir, 'env_layer', 'gates')}"])
        except ModuleNotFoundError as exc:
            if f"The '{package}' package is required" not in str(exc):
                fail(f"env layer (d): env={group} raised {exc}")
            gates[group] = str(exc)
        else:
            fail(f"env layer (d): env={group} ran without {package}")
    result["gates"] = gates
    result["took_s"] = time.perf_counter() - t_phase
    log(f"env layer (61d) on {card}: {json.dumps(gates)}; phase 61 took {result['took_s']:.1f} s (cuts {json.dumps(ENV_LAYER_CUTS)})")
    return result


# Phase 62: the data axis (core/runtime.py, core/mesh.py) through the
# trainer's entry point (dreamer_v3.main with a Runtime, as cli.run calls it)
# at DreamerV3-S's full width, bf16-mixed, B = 16 x 64, horizon 15.
DP_CUTS = {"algo.learning_starts": "128 (from 1024)", "algo.total_steps": "130 (from 100000; 3 gradient steps)",
           "algo.run_test": "False (from True)", "checkpoint.save_last": "False (from True)", "buffer.size": "4096 (from 100000)",
           "buffer.memmap": "False (from True)"}  # fmt: skip
DP_ARGS = ["exp=dreamer_v3_100k_ms_pacman", "env=dummy", "algo.learning_starts=128", "algo.total_steps=130", "metric.log_every=8",
           "algo.run_test=False", "checkpoint.save_last=False", "buffer.size=4096", "buffer.memmap=False"]  # fmt: skip
DP_STEPS = 3  # gradient steps of a DP_ARGS run: the first untimed, then DP_STEPS - 1 timed ((c))
DP_T, DP_B, DP_RANKS = 64, 16, 2
# Per rank and gradient step at B = 16 / 2: the scan's 64 streaming forwards and backwards at B = 8, the
# imagination's 15 forwards at B = 8 x 64 = 512 (tensor cores: B >= 128).
DP_RANK_FWD_BY_BATCH = {DP_B // DP_RANKS: 64, DP_T * DP_B // DP_RANKS: 15}
DP_RANK_BWD_BY_BATCH = {DP_B // DP_RANKS: 64}
# (b)'s two readings of rank 0's run against the one-process run, each bound set between the sound reading and
# the planted fault's (rank 0's gradient left unreduced: it steps on its own 8 rows): the largest
# ||d_rank0 - d_one|| / ||d_one|| over the world model, actor and critic (d: a module's change over the run), and
# the larger |d| of the moments' low and high over the larger of their magnitudes. Each bound near the geometric
# mean of its two readings on an NVIDIA H100 80GB HBM3 at 700 W (two runs, the same to the last digit): the module
# gap 0.0471 sound against 0.343 faulted, the moments 0.0104 against 0.0769.
DP_PARAM_BOUND = 0.12
DP_MOMENTS_BOUND = 0.03


def _dp_cfg(log_root):
    from sheeprl_tpu_torch.config import compose

    return compose([*DP_ARGS, f"log_root={log_root}"])


def _dp_state(out) -> dict:
    """Every tensor of a run's training state after it: the modules, the
    Adam states, the moments."""
    import torch

    state = {f"agent.{k}": v.detach().cpu().clone() for k, v in out["agent"].state_dict().items()}
    state |= {f"moments.{k}": v.detach().cpu().clone() for k, v in out["moments"].items()}
    for name, opt in out["optimizers"].items():
        for i, st in enumerate(opt.state.values()):
            state |= {f"{name}.{i}.{k}": v.detach().cpu().clone() for k, v in st.items() if isinstance(v, torch.Tensor)}
    return state


def _dp_modules(agent):
    return _modules(agent, ("world_model", "actor", "critic"))


def _dp_readings(out, start, one) -> dict:
    """A run against the one-process run from the same start: the largest
    module change gap (:data:`DP_PARAM_BOUND`) and the moments' (:data:`DP_MOMENTS_BOUND`:
    the larger gap of low and high over the larger of their magnitudes)."""
    gaps = _module_gap(_dp_modules(out["agent"]), start, one["modules"])
    moments = {k: v.item() for k, v in out["moments"].items()}
    scale = max(abs(one["moments"]["low"]), abs(one["moments"]["high"]))
    moments_rel = max(abs(moments[k] - one["moments"][k]) for k in ("low", "high")) / scale
    return {"param_gap": max(gaps.values()), "param_gaps": gaps, "moments_rel": moments_rel, "moments": moments,
            "gradient_steps": out["gradient_steps"], "digest": _dp_digest(out["agent"])}  # fmt: skip


def _dp_digest(agent) -> str:
    import hashlib

    digest = hashlib.sha256()
    for v in agent.state_dict().values():
        digest.update(v.detach().float().cpu().numpy().tobytes())
    return digest.hexdigest()


class _DPProbe:
    """(c) On one rank, over a run: each train step's host wall (between two
    synchronizes), the collectives inside the steps (each timed between two
    synchronizes) and the bytes each kind moved, and the trained agent
    (``agent``, from the train-step factory it wraps)."""

    def __init__(self, dv3):
        import torch.distributed as dist

        self.dv3, self.dist, self.walls, self.agent = dv3, dist, [], None
        self.in_step, self.spent = False, []
        self.bytes = {"all_reduce": [], "broadcast": [], "all_gather": []}

    def __enter__(self):
        import torch

        self.originals = {name: getattr(self.dist, name) for name in self.bytes} | {"make_train_step": self.dv3.make_train_step}

        def wrap(name, fn):
            def call(first, *args, **kwargs):
                if not self.in_step:
                    return fn(first, *args, **kwargs)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(first, *args, **kwargs)
                torch.cuda.synchronize()
                self.spent[-1] += time.perf_counter() - t0
                tensor = args[0] if name == "all_gather" else first
                self.bytes[name][-1] += tensor.numel() * tensor.element_size() * (len(first) if name == "all_gather" else 1)
                return out

            return call

        def factory(agent, optimizers, cfg, *args, **kwargs):
            step = self.originals["make_train_step"](agent, optimizers, cfg, *args, **kwargs)
            self.agent = agent

            def timed(*a, **kw):
                torch.cuda.synchronize()
                self.spent.append(0.0)
                for v in self.bytes.values():
                    v.append(0)
                self.in_step = True
                t0 = time.perf_counter()
                try:
                    out = step(*a, **kw)
                    torch.cuda.synchronize()
                finally:
                    self.in_step = False
                self.walls.append(time.perf_counter() - t0)
                return out

            return timed

        for name in self.bytes:
            setattr(self.dist, name, wrap(name, self.originals[name]))
        self.dv3.make_train_step = factory
        return self

    def __exit__(self, *exc):
        for name in self.bytes:
            setattr(self.dist, name, self.originals[name])
        self.dv3.make_train_step = self.originals["make_train_step"]

    def timing(self) -> dict:
        """The steps after the first (its warm-up left out)."""
        n = len(self.walls) - 1
        if n < 1:
            fail(f"data parallel (c): {len(self.walls)} timed steps")
        wall = sum(self.walls[1:])
        return {"wall_ms_per_step": wall / n * 1e3, "collective_ms_per_step": sum(self.spent[1:]) / n * 1e3,
                "collective_share": sum(self.spent[1:]) / wall, "steps_timed": n, "first_step_ms": self.walls[0] * 1e3,
                **{f"bytes_{k}_per_step": sum(v[1:]) // n for k, v in (("reduced", self.bytes["all_reduce"]),
                                                                         ("broadcast", self.bytes["broadcast"]), ("gathered", self.bytes["all_gather"]))}}  # fmt: skip


def _keep_local_on_rank0(real):
    """The planted fault: the all-reduce runs (the other rank's matches it),
    and rank 0 then puts its own gradient back."""

    def fault(params, axis, op="mean"):
        params = list(params)
        local = [None if p.grad is None else p.grad.clone() for p in params]
        real(params, axis, op)
        if axis.index == 0:
            for p, g in zip(params, local):
                if g is not None:
                    p.grad.copy_(g)

    return fault


def _dp_follower(runtime, cfg, threads, result_path) -> None:
    """(62b, c) Rank 1 on the one card over gloo: its kernels at its shapes
    against their plain versions (these launches are not the path's), then
    the follower side of two DreamerV3 runs (:func:`sheeprl_tpu_torch.cli.follow`,
    which registers the trainers and runs ``follow_dreamer_v3``): the sound
    run with its LN-GRU launches counted and its steps timed, then rank 0's
    faulted run. Writes what it read to ``result_path``."""
    sys.path.insert(0, REPO)
    import torch

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3
    from sheeprl_tpu_torch.models.ln_gru import _aligned, _sm_count, forward_plan, ln_gru_forward

    rank = runtime.global_rank
    kernels = {}
    for batch in DP_RANK_FWD_BY_BATCH:
        args = gru_inputs(batch, 1024, 512, torch.bfloat16, seed=rank)
        kind = forward_plan(batch, 1024, 512, torch.bfloat16, _sm_count(0), _aligned(args[0], args[1], args[5])).kernel
        kernels[f"forward_b{batch}"] = {"kernel": kind, **check_forward(ln_gru_forward, args, f"rank {rank}: ln_gru B={batch} bf16")}
    inp, w, b, scale, ln_bias, h = gru_inputs(DP_B // DP_RANKS, 1024, 512, torch.bfloat16, seed=3 + rank)
    _, z = ln_gru_forward(inp, w, b, scale, ln_bias, h)
    g = gru_inputs(DP_B // DP_RANKS, 1, 512, torch.bfloat16, seed=4 + rank)[5]
    kernels[f"backward_b{DP_B // DP_RANKS}"] = check_backward((g, z, scale, ln_bias, h), f"rank {rank}: ln_gru_backward B={DP_B // DP_RANKS} bf16")
    torch.cuda.synchronize()
    zero_counts()
    with _DPProbe(dv3) as probe:
        cli.follow(runtime, cfg, threads)
    counts = read_counts()
    result = {"kernels": kernels, "ln_gru_launches": counts, "timing": probe.timing(), "digest": _dp_digest(probe.agent),
              "backend": runtime.group_backend, "device": str(runtime.device)}  # fmt: skip
    cli.follow(runtime, cfg, threads)  # rank 0's faulted run: this rank is sound
    with open(result_path, "w") as fp:
        json.dump(result, fp)


def _dp_kernel_rows() -> list:
    """The kernels at a rank's shapes (bf16, D = 1024, H = 512; the
    streaming forward and the backward at B = 8, the tensor-core forward at
    B = 512), each against its plain version and timed as in phases 3-4
    (:func:`rank_kernel_rows`)."""
    return rank_kernel_rows("dreamer_v3", 1024, 512, "bfloat16", tuple(DP_RANK_FWD_BY_BATCH), tuple(DP_RANK_BWD_BY_BATCH))


def phase_data_parallel(workdir):
    """(62) The data axis on the card through the trainer's entry point
    (``dreamer_v3.main`` with a :class:`Runtime`, as ``cli.run`` calls it:
    ``Runtime.launch``, ``lead``/``follow``, ``follow_dreamer_v3``,
    ``replicate_training``), DreamerV3-S at full width for
    :data:`DP_STEPS` gradient steps: the one-process run without a runtime
    first; (a) the same run on a one-rank NCCL group, bit for bit; (b) two
    ranks on the one card over gloo (the backend ``launch`` takes from this
    script), each taking 8 of the 16 rows, rank 0's run held against the
    one-process run, each rank's LN-GRU launches counted and its kernels
    held against their plain versions at its shapes (and timed at them
    here, :func:`_dp_kernel_rows`), then the same run with rank 0's gradient
    left unreduced, which the bounds must catch; (c) each rank's step wall,
    the collectives' share and the bytes they move.
    ``c.phase_data_parallel(dir)`` runs it alone after ``kernels.build()``."""
    import torch

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3
    from sheeprl_tpu_torch.core.runtime import Runtime

    card = nvidia_smi()
    t_phase = time.perf_counter()
    kernel_rows = _dp_kernel_rows()
    log(f"data parallel: {' '.join(DP_ARGS)} (DV3-S full width, bf16-mixed, B={DP_B} x T={DP_T}); cut: {json.dumps(DP_CUTS)}")

    # The one-process run, its start captured where the trainer builds it.
    start, build = {}, dv3._build_dv3

    def capture(*args, **kwargs):
        trainer = build(*args, **kwargs)
        start.update(_dp_modules(trainer.agent))
        return trainer

    zero_counts()
    with patched(dv3, "_build_dv3", capture), _DPProbe(dv3) as probe:
        plain = dv3.main(_dp_cfg(os.path.join(workdir, "dp_plain")))
    counts_plain = read_counts()
    if plain["gradient_steps"] != DP_STEPS:
        fail(f"data parallel: the one-process run took {plain['gradient_steps']} gradient steps, expected {DP_STEPS}")
    one = {"modules": _dp_modules(plain["agent"]), "moments": {k: v.item() for k, v in plain["moments"].items()}}
    plain_state, plain_log, one_timing = _dp_state(plain), plain["log"], probe.timing()
    del plain

    # (a) One rank on NCCL, through Runtime.launch.
    zero_counts()
    out = Runtime(world_size=1, accelerator="cuda").launch(
        lambda rt: (dv3.main(_dp_cfg(os.path.join(workdir, "dp_one_rank")), runtime=rt), rt.group_backend), cli.follow,
        store_dir=os.path.join(workdir, "dp_store_one"), backend="nccl",
    )  # fmt: skip
    (one_rank, backend), counts_one = out, read_counts()
    state = _dp_state(one_rank)
    differ = [k for k in plain_state if not torch.equal(plain_state[k], state[k])]
    differ += [f"log {i} {k}" for i, (a, b) in enumerate(zip(plain_log, one_rank["log"])) for k in a if not k.startswith("Time/") and a[k] != b.get(k)]
    if backend != "nccl" or differ or one_rank["gradient_steps"] != DP_STEPS:
        fail(f"data parallel (a): the one-rank {backend} run moved {len(differ)} of {len(plain_state)} tensors and log values: {differ[:5]}")
    want = {"forward_by_batch": {DP_B: 64 * DP_STEPS, DP_T * DP_B: 15 * DP_STEPS}, "backward_by_batch": {DP_B: 64 * DP_STEPS}}
    for counts, what in ((counts_plain, "one process"), (counts_one, "one rank")):
        train_fwd = {b: n for b, n in counts["forward_by_batch"].items() if b in want["forward_by_batch"]}
        if train_fwd != want["forward_by_batch"] or counts["backward_by_batch"] != want["backward_by_batch"] or counts["tensor_core"] != 15 * DP_STEPS:
            fail(f"data parallel (a): {what}'s LN-GRU launches {counts}, expected the train steps' {want}")
    log(f"data parallel (a): {DP_STEPS} DV3-S gradient steps through dreamer_v3.main on a one-rank NCCL group (Runtime.launch) equal the "
        f"one-process run bit for bit ({len(plain_state)} tensors: modules, Adam states, moments; every logged value); LN-GRU {counts_one}; {card}")  # fmt: skip
    del one_rank, state, plain_state
    gc.collect()
    torch.cuda.empty_cache()

    # (b) Two ranks on one card over gloo: the sound run, then rank 0's gradient unreduced.
    result_path = os.path.join(workdir, "dp_rank1.json")

    def rank0(rt):
        zero_counts()
        with _DPProbe(dv3) as probe:
            sound = dv3.main(_dp_cfg(os.path.join(workdir, "dp_two")), runtime=rt)
        counts = read_counts()
        readings = _dp_readings(sound, start, one)
        del sound
        rt.lead("stop")  # the follower's first run ends here; launch stops its second
        with patched(dv3, "all_mean_grads", _keep_local_on_rank0(dv3.all_mean_grads)):
            fault = _dp_readings(dv3.main(_dp_cfg(os.path.join(workdir, "dp_fault")), runtime=rt), start, one)
        return {"ln_gru_launches": counts, "sound": readings, "timing": probe.timing(), "backend": rt.group_backend, "device": str(rt.device),
                "fault": fault}  # fmt: skip

    t0 = time.perf_counter()
    runtime = Runtime(world_size=DP_RANKS, accelerator="cuda")
    r0 = runtime.launch(rank0, _dp_follower, (json.loads(json.dumps(_dp_cfg(os.path.join(workdir, "dp_two")))), 1, result_path),
                        store_dir=os.path.join(workdir, "dp_store_two"), backend="gloo")  # fmt: skip
    two_ranks_s = time.perf_counter() - t0
    with open(result_path) as fp:
        r1 = json.load(fp)
    r1["ln_gru_launches"]["forward_by_batch"] = {int(b): n for b, n in r1["ln_gru_launches"]["forward_by_batch"].items()}
    r1["ln_gru_launches"]["backward_by_batch"] = {int(b): n for b, n in r1["ln_gru_launches"]["backward_by_batch"].items()}
    want_fwd = {b: n * DP_STEPS for b, n in DP_RANK_FWD_BY_BATCH.items()}
    want_bwd = {b: n * DP_STEPS for b, n in DP_RANK_BWD_BY_BATCH.items()}
    for rank, got in enumerate((r0, r1)):
        counts = got["ln_gru_launches"]
        if got["backend"] != "gloo" or got["device"] != "cuda:0":
            fail(f"data parallel (b): rank {rank} ran on {got['backend']} / {got['device']}")
        # Rank 0's player runs its forwards at B = num_envs between the steps; the train steps' batches are these.
        train_fwd = {b: n for b, n in counts["forward_by_batch"].items() if b in want_fwd}
        if train_fwd != want_fwd or counts["backward_by_batch"] != want_bwd or counts["tensor_core"] != 15 * DP_STEPS:
            fail(f"data parallel (b): rank {rank}'s LN-GRU launches {counts}, expected forward {want_fwd}, backward {want_bwd}")
    if r1["kernels"][f"forward_b{DP_T * DP_B // DP_RANKS}"]["kernel"] != "tensor_core" or r1["kernels"][f"forward_b{DP_B // DP_RANKS}"]["kernel"] != "streaming":
        fail(f"data parallel (b): rank 1's forward plans {r1['kernels']}")
    sound, fault = r0["sound"], r0["fault"]
    if sound["gradient_steps"] != DP_STEPS or fault["gradient_steps"] != DP_STEPS:
        fail(f"data parallel (b): gradient steps {sound['gradient_steps']}, {fault['gradient_steps']}, expected {DP_STEPS}")
    log(f"data parallel (b): dreamer_v3.main over 2 gloo ranks on one card (Runtime.launch, follow_dreamer_v3), 8 of 16 rows each, "
        f"{DP_STEPS} steps: parameter gap {sound['param_gap']:.4g} (bound {DP_PARAM_BOUND}; rank 0 unreduced {fault['param_gap']:.4g}), "
        f"moments {sound['moments_rel']:.4g} (bound {DP_MOMENTS_BOUND}; unreduced {fault['moments_rel']:.4g}); "
        f"LN-GRU rank 0 {r0['ln_gru_launches']}, rank 1 {r1['ln_gru_launches']}; {two_ranks_s:.1f} s; {card}")  # fmt: skip
    for rank, got in enumerate((r0, r1)):
        t = got["timing"]
        log(f"data parallel (c): rank {rank}: {t['wall_ms_per_step']:.2f} ms a step (one process at B={DP_B}: {one_timing['wall_ms_per_step']:.2f} ms), "
            f"collectives {t['collective_ms_per_step']:.2f} ms ({t['collective_share']:.3f}), {t['bytes_reduced_per_step']} bytes all-reduced, "
            f"{t['bytes_broadcast_per_step']} broadcast, {t['bytes_gathered_per_step']} gathered a step ({t['steps_timed']} steps); {card}")  # fmt: skip
    if sound["digest"] != r1["digest"]:
        fail("data parallel (b): the two ranks' weights differ after the run")
    if not (sound["param_gap"] <= DP_PARAM_BOUND and sound["moments_rel"] <= DP_MOMENTS_BOUND):
        fail(f"data parallel (b): rank 0's run against the one-process run: parameter gap {sound['param_gaps']} (bound {DP_PARAM_BOUND}), "
             f"moments {sound['moments_rel']} (bound {DP_MOMENTS_BOUND})")  # fmt: skip
    if not (fault["param_gap"] > DP_PARAM_BOUND and fault["moments_rel"] > DP_MOMENTS_BOUND):
        fail(f"data parallel (b): rank 0's gradient unreduced passes a bound: parameter gap {fault['param_gap']} (bound {DP_PARAM_BOUND}), "
             f"moments {fault['moments_rel']} (bound {DP_MOMENTS_BOUND})")  # fmt: skip
    took_s = time.perf_counter() - t_phase
    log(f"data parallel: phase 62 took {took_s:.1f} s")
    return {"card": card, "cuts": DP_CUTS, "kernels_at_rank_shapes": kernel_rows,
            "one_rank": {"backend": backend, "steps": DP_STEPS, "tensors_equal": True, "ln_gru_launches": counts_one},
            "one_process": {"ln_gru_launches": counts_plain, "timing": one_timing},
            "two_ranks": [r0, r1], "two_ranks_s": two_ranks_s, "bounds": {"param_gap": DP_PARAM_BOUND, "moments_rel": DP_MOMENTS_BOUND},
            "readings": {"sound_param_gap": sound["param_gap"], "unreduced_param_gap": fault["param_gap"],
                         "sound_moments_rel": sound["moments_rel"], "unreduced_moments_rel": fault["moments_rel"]}, "took_s": took_s}  # fmt: skip


# Phase 63: the data axis for the other trainers (ROADMAP A9, item 7), through
# their entry points with a Runtime as cli.run calls them, each rank's LN-GRU
# kernels at its shapes. (a) DreamerV2 (exp=dreamer_v2_ms_pacman: bf16-mixed,
# B = 32 x 50, horizon 15, H = 600) for 3 gradient steps; (b) the P2E-DV2
# chain (32-true, B = 16 x 50, H = 400), 2 gradient steps a phase; (c) one
# P2E-DV3 exploration train step at the recipe's XL width (32-true, B = 16 x
# 64, H = 4096). DreamerV1, P2E-DV1, DroQ, SAC-AE, A2C and recurrent PPO
# launch no kernel: their two-rank steps are held against the JAX package on
# the CPU (tests/test_torch_dp_*_steps.py).
DP2_CUTS = {"algo.learning_starts": "256 (from 200000)", "algo.total_steps": "304 (from 200000000; 3 gradient steps)",
            "+env.wrapper.n_steps": "62 (the dummy env's episodes: 63 steps)", "algo.run_test": "False (from True)",
            "checkpoint.save_last": "False (from True)", "buffer.size": "4096 (from 2000000)", "buffer.memmap": "False (from True)"}  # fmt: skip
DP2_ARGS = ["exp=dreamer_v2_ms_pacman", "env=dummy", "algo.learning_starts=256", "algo.total_steps=304", "metric.log_every=16",
            "+env.wrapper.n_steps=62", "algo.run_test=False", "checkpoint.save_last=False", "buffer.size=4096", "buffer.memmap=False"]  # fmt: skip
DP2_STEPS = 3
# Per rank and gradient step, at half the batch: phase 23's 50 forwards and backwards of the scan at B = 16 and
# the imagination's 15 at B = 16 x 50 = 800 (all streaming: H = 600).
DP2_RANK_BY_BATCH = {DV2_BATCH // DP_RANKS: DV2_SEQ, DV2_IMAGINED // DP_RANKS: DV2_HORIZON}
DPP_CUTS = {"algo.learning_starts": "200 (from 1000; finetuning from 5000)", "algo.total_steps": "212 (from 5000000; 2 gradient steps a phase)",
            "checkpoint.every": "0 (from 100000)", "algo.run_test": "False (from True)", "buffer.size": "4096 (from 1000000)",
            "buffer.memmap": "False (from True)", "metric.log_level": "0 (from 1: nothing of (b) reads the logs)"}  # fmt: skip
DPP_COMMON = ["env=dummy", "algo.learning_starts=200", "algo.total_steps=212", "metric.log_level=0", "checkpoint.every=0", "algo.run_test=False",
              "buffer.size=4096", "buffer.memmap=False"]  # fmt: skip
DPP_ARGS = ["exp=p2e_dv2_exploration", *DPP_COMMON, "checkpoint.save_last=True"]
DPP_FT_ARGS = ["exp=p2e_dv2_finetuning", *DPP_COMMON, "checkpoint.save_last=False"]
DPP_STEPS = 2
# Per rank and gradient step: the scan's 50 at B = 8; the exploration step's two imaginations (15 each) at
# B = 8 x 50 = 400, the finetuning step's one; every forward differentiated.
DPP_RANK_BY_BATCH = {P2E2_BATCH // DP_RANKS: P2E2_SEQ, P2E2_IMAGINED // DP_RANKS: 2 * P2E_HORIZON}
DPP_FT_RANK_BY_BATCH = {P2E2_BATCH // DP_RANKS: P2E2_SEQ, P2E2_IMAGINED // DP_RANKS: P2E_HORIZON}
DPX_ARGS = ["exp=p2e_dv3_exploration", "env=dummy", "fabric.precision=32-true"]
DPX_T, DPX_B, DPX_TAU = P2E_SEQ, P2E_BATCH, 0.02
# Per rank: the scan's 64 forwards and backwards at B = 8, the two imaginations' 30 forwards at B = 512
# (discrete actions: no gradient through them).
DPX_RANK_FWD_BY_BATCH = {DPX_B // DP_RANKS: DPX_T, DPX_T * DPX_B // DP_RANKS: 2 * P2E_HORIZON}
DPX_RANK_BWD_BY_BATCH = {DPX_B // DP_RANKS: DPX_T}
# Rank 0's modules against the one-process run's, by the largest ||d_rank0 - d_one|| / ||d_one|| over a
# module's leaves (d: its change over the run). (a)'s bound lies near the geometric mean of the sound
# reading and the planted fault's (rank 0's gradient left unreduced): 0.312 (the actor; bf16-mixed rounds
# the two ranks' halves otherwise than the whole batch, and Adam's first steps turn tiny gradients' other
# signs into whole steps) against 1.021, on an NVIDIA H100 80GB HBM3 at 700 W. (b) and (c) are 32-true
# and hold the sound runs at about ten times their readings there: the P2E-DV2 exploration 1.11e-3
# (finetuning 4.8e-6), the P2E-DV3 XL step 3.84e-4.
DP2_PARAM_BOUND = 0.55
DPP_PARAM_BOUND = 1e-2
DPX_PARAM_BOUND = 5e-3
# The kernels at the ranks' shapes: (tag, depth, hidden, dtype, forward batches, backward batches).
DP63_KERNELS = (
    ("dreamer_v2", DV2_DEPTH, DV2_HIDDEN, "bfloat16", tuple(DP2_RANK_BY_BATCH), tuple(DP2_RANK_BY_BATCH)),
    ("p2e_dv2", P2E2_DEPTH, P2E2_HIDDEN, "float32", tuple(DPP_RANK_BY_BATCH), tuple(DPP_RANK_BY_BATCH)),
    ("p2e_dv3_xl", P2E_DEPTH, P2E_HIDDEN, "float32", tuple(DPX_RANK_FWD_BY_BATCH), tuple(DPX_RANK_BWD_BY_BATCH)),
)


def rank_kernel_rows(tag, depth, hidden, dtype_name, fwd_batches, bwd_batches, timing=True) -> list:
    """The LN-GRU kernels at a rank's shapes, each against its plain version
    (``check_forward``, ``check_backward``); with ``timing`` each timed as
    in phases 3-4: kernel, plain, cuBLAS's product alone (forwards) and the
    bound. Without, the kernels' checks alone (a follower's)."""
    import torch

    from sheeprl_tpu_torch.models.ln_gru import (
        _aligned,
        _sm_count,
        forward_plan,
        ln_gru_backward,
        ln_gru_backward_plain,
        ln_gru_forward,
        ln_gru_plain,
    )

    dtype = getattr(torch, dtype_name)
    rows = []
    for batch in fwd_batches:
        args = gru_inputs(batch, depth, hidden, dtype, seed=5)
        kind = forward_plan(batch, depth, hidden, dtype, _sm_count(0), _aligned(args[0], args[1], args[5])).kernel
        row = {"model": tag, "kind": "forward", "kernel": kind, "shape": f"B={batch} D={depth} H={hidden}", "batch": batch, "dtype": dtype_name,
               **check_forward(ln_gru_forward, args, f"{tag}: ln_gru B={batch} {dtype_name}")}  # fmt: skip
        if timing:
            bound_ms, bound_by = gru_bound(batch, depth, hidden, dtype_name)
            row |= {**timed(rotated(args, ln_gru_forward)), "plain_ms": device_ms(rotated(args, ln_gru_plain))[0],
                    "product_library_ms": device_ms(rotated(args[:2], torch.matmul))[0], "bound_ms": bound_ms, "bound_by": bound_by}  # fmt: skip
        rows.append(row)
        del args
    for batch in bwd_batches:
        inp, w, b, scale, ln_bias, h = gru_inputs(batch, depth, hidden, dtype, seed=6)
        _, z = ln_gru_forward(inp, w, b, scale, ln_bias, h)
        args = (gru_inputs(batch, 1, hidden, dtype, seed=7)[5], z, scale, ln_bias, h)
        row = {"model": tag, "kind": "backward", "shape": f"B={batch} H={hidden}", "batch": batch, "dtype": dtype_name,
               "max_abs_err": check_backward(args, f"{tag}: ln_gru_backward B={batch} {dtype_name}")}  # fmt: skip
        if timing:
            bound_ms, bound_by = gru_bwd_bound(batch, hidden, dtype_name)
            row |= {**timed(rotated(args, ln_gru_backward)), "plain_ms": device_ms(rotated(args, ln_gru_backward_plain))[0], "bound_ms": bound_ms,
                    "bound_by": bound_by}  # fmt: skip
        rows.append(row)
        del inp, w, z, args
    torch.cuda.empty_cache()
    for row in rows if timing else ():
        log(f"data parallel: {row['model']} {row['kind']} {row['shape']} {dtype_name}: kernel {row['ms'] * 1e3:.2f} us, plain "
            f"{row['plain_ms'] * 1e3:.2f} us, bound {row['bound_ms'] * 1e3:.2f} us ({row['bound_by']})")  # fmt: skip
    return rows


def _run_state(out) -> dict:
    """Every tensor of a Dreamer run's training state after it: the
    modules and every optimizer's state."""
    import torch

    state = {f"agent.{k}": v.detach().cpu().clone() for k, v in out["agent"].state_dict().items()}
    for name, opt in _optimizer_states(out["optimizers"]).items():
        for i, st in enumerate(opt.state.values()):
            state |= {f"{name}.{i}.{k}": v.detach().cpu().clone() for k, v in st.items() if isinstance(v, torch.Tensor)}
    return state


def _modules(agent, names) -> dict:
    return {name: {k: v.detach().cpu().clone() for k, v in getattr(agent, name).state_dict().items()} for name in names}


def _module_gap(after, start, one, one_start=None) -> dict:
    """Per module: ||d_got - d_one|| / ||d_one|| over its leaves (d: the
    module's change from ``start``; the one-process run's from
    ``one_start``, by default the same)."""
    one_start = start if one_start is None else one_start
    gaps = {}
    for name, state in after.items():
        num = den = 0.0
        for k, v in state.items():
            d_got, d_one = v.double() - start[name][k].double(), one[name][k].double() - one_start[name][k].double()
            num += float(((d_got - d_one) ** 2).sum())
            den += float((d_one**2).sum())
        gaps[name] = math.sqrt(num / den) if den > 0 else float(num > 0)
    return gaps


def _counts_within(counts, fwd, bwd) -> dict:
    """A rank's train-step launches: the forwards at ``fwd``'s batches (rank
    0's player adds its own at B = num_envs) and every backward."""
    return {"forward_by_batch": {b: n for b, n in counts["forward_by_batch"].items() if b in fwd}, "backward_by_batch": counts["backward_by_batch"],
            "tensor_core": counts["tensor_core"]}  # fmt: skip


def _check_rank_counts(what, counts, fwd, bwd, steps):
    got = _counts_within(counts, fwd, bwd)
    want = {"forward_by_batch": {b: n * steps for b, n in fwd.items()}, "backward_by_batch": {b: n * steps for b, n in bwd.items()}, "tensor_core": 0}
    if got != want:
        fail(f"data parallel: {what}'s LN-GRU launches {counts}, expected the train steps' {want}")


def _json_counts(counts) -> dict:
    return counts | {k: {int(b): n for b, n in counts[k].items()} for k in ("forward_by_batch", "backward_by_batch")}


def _xl_step(axis, data, device):
    """(63c) One P2E-DV3 exploration train step at the recipe's XL width
    over ``axis`` (rank 0 holds ``data``) from the weights of the seed:
    (its LN-GRU launches, the modules at the start and after it, the peak
    of the card's memory the process allocated)."""
    import torch

    from sheeprl_tpu_torch.algos.p2e_dv3 import p2e_dv3_exploration as p2e
    from sheeprl_tpu_torch.algos.p2e_dv3.agent import build_agent
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.serve.spaces import Box, DictSpace
    from sheeprl_tpu_torch.utils.distribution import BatchGenerator

    cfg = compose(DPX_ARGS)
    agent = build_agent((2,), False, cfg, DictSpace({"state": Box((10,), "float32", -20.0, 20.0)}), precision="32-true", device=device, seed=3)
    names = [name for name, _ in agent.named_children()]
    start = _modules(agent, names) if axis.index == 0 else None
    step = p2e.make_train_step(agent, p2e.make_optimizers(agent, cfg), cfg, axis)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    step(p2e.init_p2e_moments(agent.critics_cfg, device), data, BatchGenerator.from_seed(3, device), DPX_TAU)
    torch.cuda.synchronize()
    counts, peak = read_counts(), torch.cuda.max_memory_allocated()
    after = _modules(agent, names) if axis.index == 0 else None
    digest = _dp_digest(agent)
    del agent, step
    gc.collect()
    torch.cuda.empty_cache()
    return {"counts": counts, "start": start, "after": after, "peak_bytes": peak, "digest": digest}


def _dp63_follower(runtime, result_path) -> None:
    """(63) Rank 1 on the one card over gloo: its kernels at its shapes
    against their plain versions (launches that are not the path's), then,
    for each of rank 0's runs in turn, the follower side of the trainer
    (:func:`sheeprl_tpu_torch.cli.follow` on the config rank 0 sends) with
    its LN-GRU launches counted, the DreamerV2 run's steps timed; then its
    part of the P2E-DV3 XL step. Writes what it read to ``result_path``."""
    sys.path.insert(0, REPO)
    import torch

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.algos.dreamer_v2 import dreamer_v2 as dv2
    from sheeprl_tpu_torch.core.mesh import all_gather

    result = {"kernels": [row for spec in DP63_KERNELS for row in rank_kernel_rows(*spec, timing=False)], "runs": {},
              "backend": runtime.group_backend, "device": str(runtime.device)}  # fmt: skip
    for what in ("dreamer_v2", "dreamer_v2_unreduced", "p2e_dv2_exploration", "p2e_dv2_finetuning"):
        args = runtime.expect("run")
        torch.cuda.synchronize()
        zero_counts()
        if what == "dreamer_v2":
            with _DPProbe(dv2) as probe:
                cli.follow(runtime, args["cfg"], 1, args["extra"])
            result["runs"][what] = {"timing": probe.timing(), "digest": _dp_digest(probe.agent)}
        else:
            cli.follow(runtime, args["cfg"], 1, args["extra"])
            result["runs"][what] = {}
        result["runs"][what]["ln_gru_launches"] = read_counts()
    runtime.expect("xl")
    xl = _xl_step(runtime.axis, None, runtime.device)
    result["xl"] = {"counts": xl["counts"], "peak_bytes": xl["peak_bytes"], "digest": xl["digest"]}
    all_gather(torch.zeros(1, device=runtime.device), runtime.axis)  # rank 0 reads the peak after this rank's
    with open(result_path, "w") as fp:
        json.dump(result, fp)
    for op, _ in runtime.follow():
        fail(f"data parallel: rank 1 expected rank 0's stop, got {op!r}")


def phase_data_parallel_rest(workdir):
    """(63) The data axis for DreamerV2 and the P2E chains on the card,
    through the trainers' entry points with a :class:`Runtime` as
    ``cli.run`` calls them: (a) DreamerV2 (``dreamer_v2.main``) at full
    width for :data:`DP2_STEPS` gradient steps, the one-process run first,
    the same run on a one-rank NCCL group bit for bit, then two gloo ranks
    on the one card (16 of the 32 rows each), rank 0's modules held against
    the one-process run by a bound between the sound reading and rank 0's
    gradient left unreduced, each rank's launches counted and its step
    wall, the collectives' share and the bytes they move printed; (b) the
    P2E-DV2 chain (exploration, then finetuning of its checkpoint) on two
    ranks, :data:`DPP_STEPS` steps a phase, against the one-process chain;
    (c) one P2E-DV3 exploration train step at XL width on two ranks against
    the one-process step, each rank's peak memory printed. Rank 1 holds its
    kernels against their plain versions at its shapes; they are timed
    here (:func:`rank_kernel_rows`). One ``Runtime.launch`` carries every
    two-rank run. ``c.phase_data_parallel_rest(dir)`` runs it alone after
    ``kernels.build()``."""
    import torch

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.algos.dreamer_v2 import dreamer_v2 as dv2
    from sheeprl_tpu_torch.algos.p2e_dv2 import p2e_dv2_exploration as p2e_expl
    from sheeprl_tpu_torch.algos.p2e_dv2 import p2e_dv2_finetuning as p2e_ft
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.core.mesh import SINGLE, all_gather
    from sheeprl_tpu_torch.core.runtime import Runtime

    card = nvidia_smi()
    t_phase = time.perf_counter()
    kernel_rows = [row for spec in DP63_KERNELS for row in rank_kernel_rows(*spec)]
    log(f"data parallel (a): {' '.join(DP2_ARGS)} (DreamerV2 full width, bf16-mixed, B={DV2_BATCH} x T={DV2_SEQ}); cut: {json.dumps(DP2_CUTS)}")
    log(f"data parallel (b): {' '.join(DPP_ARGS)} then {' '.join(DPP_FT_ARGS)}; cut: {json.dumps(DPP_CUTS)}")

    def cfg_of(args, where, *extra):
        return compose([*args, f"log_root={os.path.join(workdir, where)}", *extra])

    def jsonable(cfg):
        return json.loads(json.dumps(cfg))

    # The one-process runs, their start captured where the trainer builds it.
    start, build = {}, dv2.loop_trainer

    def capture(*args, **kwargs):
        trainer = build(*args, **kwargs)
        start.update(_modules(trainer.agent, MODULES[:3]))
        return trainer

    # The P2E runs' starts, in the order their trainers are built (the one-process chain's, then rank 0's):
    # the exploration's from the seed, the finetuning's from its exploration checkpoint.
    starts = {"exploration": [], "finetuning": []}
    build_expl, build_ft = p2e_expl._build, p2e_ft._build

    def capture_expl(*args, **kwargs):
        trainer = build_expl(*args, **kwargs)
        starts["exploration"].append(_modules(trainer.agent, [name for name, _ in trainer.agent.named_children()]))
        return trainer

    def capture_ft(*args, **kwargs):
        trainer = build_ft(*args, **kwargs)
        starts["finetuning"].append(_modules(trainer.agent, [name for name, _ in trainer.agent.named_children()]))
        return trainer

    zero_counts()
    with patched(dv2, "loop_trainer", capture), _DPProbe(dv2) as probe:
        plain = dv2.main(cfg_of(DP2_ARGS, "dp2_plain"))
    counts_plain, one_timing = read_counts(), probe.timing()
    if plain["gradient_steps"] != DP2_STEPS:
        fail(f"data parallel (a): the one-process run took {plain['gradient_steps']} gradient steps, expected {DP2_STEPS}")
    one = _modules(plain["agent"], MODULES[:3])
    plain_state, plain_log = _run_state(plain), plain["log"]
    del plain
    with patched(p2e_expl, "_build", capture_expl), patched(p2e_ft, "_build", capture_ft):
        expl_one = p2e_expl.main(cfg_of(DPP_ARGS, "dpp_plain"))
        ft_cfg = cfg_of(DPP_FT_ARGS, "dpp_plain_ft", f"checkpoint.exploration_ckpt_path={expl_one['checkpoints'][-1]}")
        ft_one = p2e_ft.main(ft_cfg, exploration_cfg=cli.exploration_chain(ft_cfg))
    p2e_names = [name for name, _ in expl_one["agent"].named_children()]
    ft_names = [name for name, _ in ft_one["agent"].named_children()]
    p2e_one = {"exploration": _modules(expl_one["agent"], p2e_names), "finetuning": _modules(ft_one["agent"], ft_names),
               "steps": (expl_one["gradient_steps"], ft_one["gradient_steps"])}  # fmt: skip
    if p2e_one["steps"] != (DPP_STEPS, DPP_STEPS):
        fail(f"data parallel (b): the one-process chain took {p2e_one['steps']} gradient steps, expected {DPP_STEPS} a phase")
    del expl_one, ft_one
    dev = torch.device("cuda", 0)
    xl_data = _vector_batch(DPX_T, DPX_B, 13, dev)
    xl_one = _xl_step(SINGLE, xl_data, dev)
    gc.collect()
    torch.cuda.empty_cache()

    # (a) One rank on NCCL, through Runtime.launch.
    zero_counts()
    one_rank, backend = Runtime(world_size=1, accelerator="cuda").launch(
        lambda rt: (dv2.main(cfg_of(DP2_ARGS, "dp2_one_rank"), runtime=rt), rt.group_backend), cli.follow,
        store_dir=os.path.join(workdir, "dp2_store_one"), backend="nccl",
    )  # fmt: skip
    counts_one = read_counts()
    state = _run_state(one_rank)
    differ = [k for k in plain_state if not torch.equal(plain_state[k], state[k])]
    differ += [f"log {i} {k}" for i, (a, b) in enumerate(zip(plain_log, one_rank["log"])) for k in a if not k.startswith("Time/") and a[k] != b.get(k)]
    if backend != "nccl" or differ or one_rank["gradient_steps"] != DP2_STEPS or len(plain_log) != len(one_rank["log"]):
        fail(f"data parallel (a): the one-rank {backend} run moved {len(differ)} of {len(plain_state)} tensors and log values: {differ[:5]}")
    for counts, what in ((counts_plain, "one process"), (counts_one, "one rank")):
        _check_rank_counts(f"(a) {what}", counts, {b * DP_RANKS: n for b, n in DP2_RANK_BY_BATCH.items()},
                           {b * DP_RANKS: n for b, n in DP2_RANK_BY_BATCH.items()}, DP2_STEPS)  # fmt: skip
    log(f"data parallel (a): {DP2_STEPS} DreamerV2 gradient steps through dreamer_v2.main on a one-rank NCCL group (Runtime.launch) equal the "
        f"one-process run bit for bit ({len(plain_state)} tensors: modules, Adam states; every logged value); LN-GRU {counts_one}; {card}")  # fmt: skip
    del one_rank, state, plain_state
    gc.collect()
    torch.cuda.empty_cache()

    # Every two-rank run in one launch: rank 0 here, rank 1 spawned.
    result_path = os.path.join(workdir, "dp63_rank1.json")

    def rank0(rt):
        out = {}
        rt.lead("run", cfg=jsonable(cfg_of(DP2_ARGS, "dp2_two")), extra={})
        zero_counts()
        with _DPProbe(dv2) as probe:
            sound = dv2.main(cfg_of(DP2_ARGS, "dp2_two"), runtime=rt)
        rt.lead("stop")
        out["dreamer_v2"] = {"ln_gru_launches": read_counts(), "timing": probe.timing(), "steps": sound["gradient_steps"],
                             "gaps": _module_gap(_modules(sound["agent"], MODULES[:3]), start, one), "digest": _dp_digest(sound["agent"])}  # fmt: skip
        del sound
        rt.lead("run", cfg=jsonable(cfg_of(DP2_ARGS, "dp2_fault")), extra={})
        with patched(dv2, "all_mean_grads", _keep_local_on_rank0(dv2.all_mean_grads)):
            fault = dv2.main(cfg_of(DP2_ARGS, "dp2_fault"), runtime=rt)
        rt.lead("stop")
        out["dreamer_v2_unreduced"] = {"steps": fault["gradient_steps"], "gaps": _module_gap(_modules(fault["agent"], MODULES[:3]), start, one)}
        del fault
        expl_cfg = cfg_of(DPP_ARGS, "dpp_two")
        rt.lead("run", cfg=jsonable(expl_cfg), extra={})
        zero_counts()
        expl = p2e_expl.main(expl_cfg, runtime=rt)
        rt.lead("stop")
        out["p2e_dv2_exploration"] = {"ln_gru_launches": read_counts(), "steps": expl["gradient_steps"],
                                      "gaps": _module_gap(_modules(expl["agent"], p2e_names), starts["exploration"][1], p2e_one["exploration"],
                                                          starts["exploration"][0])}  # fmt: skip
        ft_cfg = cfg_of(DPP_FT_ARGS, "dpp_two_ft", f"checkpoint.exploration_ckpt_path={expl['checkpoints'][-1]}")
        del expl
        exploration_cfg = cli.exploration_chain(ft_cfg)
        rt.lead("run", cfg=jsonable(ft_cfg), extra={"exploration_cfg": jsonable(exploration_cfg)})
        zero_counts()
        ft = p2e_ft.main(ft_cfg, runtime=rt, exploration_cfg=exploration_cfg)
        rt.lead("stop")
        out["p2e_dv2_finetuning"] = {"ln_gru_launches": read_counts(), "steps": ft["gradient_steps"],
                                     "gaps": _module_gap(_modules(ft["agent"], ft_names), starts["finetuning"][1], p2e_one["finetuning"],
                                                         starts["finetuning"][0])}  # fmt: skip
        del ft
        gc.collect()
        torch.cuda.empty_cache()
        rt.lead("xl")
        xl = _xl_step(rt.axis, xl_data, rt.device)
        all_gather(torch.zeros(1, device=rt.device), rt.axis)
        out["xl"] = {"counts": xl["counts"], "peak_bytes": xl["peak_bytes"], "digest": xl["digest"],
                     "gaps": _module_gap(xl["after"], xl_one["start"], xl_one["after"])}  # fmt: skip
        out["backend"], out["device"] = rt.group_backend, str(rt.device)
        return out

    t0 = time.perf_counter()
    with patched(p2e_expl, "_build", capture_expl), patched(p2e_ft, "_build", capture_ft):
        r0 = Runtime(world_size=DP_RANKS, accelerator="cuda").launch(rank0, _dp63_follower, (result_path,), store_dir=os.path.join(workdir, "dp63_store"),
                                                                      backend="gloo")  # fmt: skip
    two_ranks_s = time.perf_counter() - t0
    with open(result_path) as fp:
        r1 = json.load(fp)
    for got in r1["runs"].values():
        got["ln_gru_launches"] = _json_counts(got["ln_gru_launches"])
    r1["xl"]["counts"] = _json_counts(r1["xl"]["counts"])
    for rank, got in enumerate((r0, r1)):
        if got["backend"] != "gloo" or got["device"] != "cuda:0":
            fail(f"data parallel: rank {rank} ran on {got['backend']} / {got['device']}")
    runs = {rank: (r0 if rank == 0 else r1["runs"]) for rank in (0, 1)}
    for rank in (0, 1):
        _check_rank_counts(f"(a) rank {rank}", runs[rank]["dreamer_v2"]["ln_gru_launches"], DP2_RANK_BY_BATCH, DP2_RANK_BY_BATCH, DP2_STEPS)
        _check_rank_counts(f"(b) rank {rank} exploration", runs[rank]["p2e_dv2_exploration"]["ln_gru_launches"], DPP_RANK_BY_BATCH, DPP_RANK_BY_BATCH,
                           DPP_STEPS)  # fmt: skip
        _check_rank_counts(f"(b) rank {rank} finetuning", runs[rank]["p2e_dv2_finetuning"]["ln_gru_launches"], DPP_FT_RANK_BY_BATCH,
                           DPP_FT_RANK_BY_BATCH, DPP_STEPS)  # fmt: skip
        _check_rank_counts(f"(c) rank {rank}", (r0 if rank == 0 else r1)["xl"]["counts"], DPX_RANK_FWD_BY_BATCH, DPX_RANK_BWD_BY_BATCH, 1)
    _check_rank_counts("(c) one process", xl_one["counts"], {b * DP_RANKS: n for b, n in DPX_RANK_FWD_BY_BATCH.items()},
                       {b * DP_RANKS: n for b, n in DPX_RANK_BWD_BY_BATCH.items()}, 1)  # fmt: skip
    for row in r1["kernels"]:
        if row["kind"] == "forward" and row["kernel"] != "streaming":
            fail(f"data parallel: rank 1's forward plan at {row['model']} {row['shape']} is {row['kernel']}")
    sound, fault = r0["dreamer_v2"], r0["dreamer_v2_unreduced"]
    steps = (sound["steps"], fault["steps"], r0["p2e_dv2_exploration"]["steps"], r0["p2e_dv2_finetuning"]["steps"])
    if steps != (DP2_STEPS, DP2_STEPS, DPP_STEPS, DPP_STEPS):
        fail(f"data parallel: gradient steps {steps}")
    if sound["digest"] != r1["runs"]["dreamer_v2"]["digest"] or r0["xl"]["digest"] != r1["xl"]["digest"]:
        fail("data parallel: the two ranks' weights differ after a run")
    readings = {"dreamer_v2": max(sound["gaps"].values()), "dreamer_v2_unreduced": max(fault["gaps"].values()),
                "p2e_dv2_exploration": max(r0["p2e_dv2_exploration"]["gaps"].values()), "p2e_dv2_finetuning": max(r0["p2e_dv2_finetuning"]["gaps"].values()),
                "p2e_dv3_xl": max(r0["xl"]["gaps"].values())}  # fmt: skip
    log(f"data parallel (a): dreamer_v2.main over 2 gloo ranks on one card, 16 of 32 rows each, {DP2_STEPS} steps: module gap "
        f"{readings['dreamer_v2']:.4g} (bound {DP2_PARAM_BOUND}; rank 0 unreduced {readings['dreamer_v2_unreduced']:.4g}) {json.dumps(sound['gaps'])}; "
        f"LN-GRU rank 0 {r0['dreamer_v2']['ln_gru_launches']}, rank 1 {r1['runs']['dreamer_v2']['ln_gru_launches']}; {card}")  # fmt: skip
    for rank, got in enumerate((r0["dreamer_v2"], r1["runs"]["dreamer_v2"])):
        t = got["timing"]
        log(f"data parallel (a): rank {rank}: {t['wall_ms_per_step']:.2f} ms a step (one process at B={DV2_BATCH}: {one_timing['wall_ms_per_step']:.2f} ms), "
            f"collectives {t['collective_ms_per_step']:.2f} ms ({t['collective_share']:.3f}), {t['bytes_reduced_per_step']} bytes all-reduced, "
            f"{t['bytes_broadcast_per_step']} broadcast, {t['bytes_gathered_per_step']} gathered a step ({t['steps_timed']} steps; two gloo ranks "
            f"sharing one card: no figure for NCCL across cards); {card}")  # fmt: skip
    log(f"data parallel (b): the P2E-DV2 chain over 2 gloo ranks, {DPP_STEPS} steps a phase: module gap exploration "
        f"{readings['p2e_dv2_exploration']:.4g}, finetuning {readings['p2e_dv2_finetuning']:.4g} (bound {DPP_PARAM_BOUND}); LN-GRU rank 0 "
        f"{r0['p2e_dv2_exploration']['ln_gru_launches']} / {r0['p2e_dv2_finetuning']['ln_gru_launches']}, rank 1 "
        f"{r1['runs']['p2e_dv2_exploration']['ln_gru_launches']} / {r1['runs']['p2e_dv2_finetuning']['ln_gru_launches']}")  # fmt: skip
    log(f"data parallel (c): one P2E-DV3 XL exploration step over 2 gloo ranks (B={DPX_B} x T={DPX_T}, 32-true): module gap "
        f"{readings['p2e_dv3_xl']:.4g} (bound {DPX_PARAM_BOUND}) {json.dumps(r0['xl']['gaps'])}; peak memory rank 0 {r0['xl']['peak_bytes']} B, rank 1 "
        f"{r1['xl']['peak_bytes']} B (one process {xl_one['peak_bytes']} B); LN-GRU rank 0 {r0['xl']['counts']}, rank 1 {r1['xl']['counts']}")  # fmt: skip
    if not readings["dreamer_v2"] <= DP2_PARAM_BOUND < readings["dreamer_v2_unreduced"]:
        fail(f"data parallel (a): module gap {readings['dreamer_v2']} sound, {readings['dreamer_v2_unreduced']} unreduced: the bound "
             f"{DP2_PARAM_BOUND} must lie between them")  # fmt: skip
    for what, bound in (("p2e_dv2_exploration", DPP_PARAM_BOUND), ("p2e_dv2_finetuning", DPP_PARAM_BOUND), ("p2e_dv3_xl", DPX_PARAM_BOUND)):
        if not readings[what] <= bound:
            fail(f"data parallel: {what}'s rank 0 against the one-process run: module gap {readings[what]} (bound {bound})")
    took_s = time.perf_counter() - t_phase
    log(f"data parallel: phase 63 took {took_s:.1f} s (two ranks {two_ranks_s:.1f} s)")
    return {"card": card, "cuts": {"dreamer_v2": DP2_CUTS, "p2e_dv2": DPP_CUTS}, "kernels_at_rank_shapes": kernel_rows, "rank1_kernels": r1["kernels"],
            "one_rank": {"backend": backend, "steps": DP2_STEPS, "tensors_equal": True, "ln_gru_launches": counts_one},
            "one_process": {"ln_gru_launches": counts_plain, "timing": one_timing, "xl_counts": xl_one["counts"], "xl_peak_bytes": xl_one["peak_bytes"]},
            "two_ranks": {"rank0": {k: v for k, v in r0.items()}, "rank1": r1}, "two_ranks_s": two_ranks_s, "readings": readings,
            "bounds": {"dreamer_v2": DP2_PARAM_BOUND, "p2e_dv2": DPP_PARAM_BOUND, "p2e_dv3_xl": DPX_PARAM_BOUND}, "took_s": took_s}  # fmt: skip


ASYNC_BUILT = [0]


def async_vectors_built():
    """How many worker-process vectors (``AsyncVectorEnv``) this process has
    built since :func:`pin_in_process_envs`."""
    return ASYNC_BUILT[0]


def pin_in_process_envs():
    """Phases 1-60 measured their envs in-process: every trainer's
    composition and CLI run of the script (an ``exp=``) takes
    ``env.sync_env=True`` unless it names ``env.sync_env`` (phase 61 does).
    Every ``AsyncVectorEnv`` built in this process is counted
    (:func:`async_vectors_built`), so ``main`` can check that no earlier
    phase built one by a path the pin does not reach."""
    from sheeprl_tpu_torch import cli, config
    from sheeprl_tpu_torch.envs.vector import AsyncVectorEnv

    init = AsyncVectorEnv.__init__

    @functools.wraps(init)
    def counted(self, *args, **kwargs):
        ASYNC_BUILT[0] += 1
        init(self, *args, **kwargs)

    AsyncVectorEnv.__init__ = counted

    def pinned(fn):
        @functools.wraps(fn)
        def call(args, *rest, **kwargs):
            args = list(args)
            names = [str(a).split("=", 1)[0] for a in args]
            if "exp" in names and "env.sync_env" not in names:
                args.append("env.sync_env=True")
            return fn(args, *rest, **kwargs)

        return call

    cli.run, config.compose = pinned(cli.run), pinned(config.compose)


def main() -> None:
    import warnings

    if not os.path.isdir(os.path.join(REPO, "sheeprl_tpu_torch")):
        fail(f"run from a checkout of the repository: no sheeprl_tpu_torch/ beside {__file__}")
    share_bytecode(os.path.join(REPO, "sheeprl_tpu_torch", "_build"))
    import torch

    warnings.filterwarnings("ignore", message=".*Profiler clears events.*")

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    sys.path.insert(0, REPO)
    from sheeprl_tpu_torch import kernels

    pin_in_process_envs()
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
        evaluation = defer_eval(cont_out["checkpoints"][-1], cont_out["test_reward"])
        resume = phase_resume(cont_out, cont_steps, workdir)
        continuous_serving = phase_export_serve(cont_out["checkpoints"][-1], workdir)
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
        # The evaluations of phases 9-27, beside P2E's card-against-CPU references (which time nothing).
        with evals_beside("p2e reference"):
            p2e_reference = {kind: phase_p2e_reference(kind == "continuous") for kind in ("discrete", "continuous")}
        p2e_training, p2e_out = phase_p2e_training(workdir)
        p2e_profile = phase_p2e_profile(p2e_out["agent"])
        remove_after_evals(p2e_out["log_dir"])
        del p2e_out
        torch.cuda.empty_cache()
        p2e_dv2_kernels, p2e_dv2 = phase_p2e_dv2(workdir)
        p2e_phases_s = time.perf_counter() - p2e_t0
        log(f"p2e_dv3, p2e_dv2: phases 31-36 took {p2e_phases_s:.1f} s")
        # The Anakin lane before phases 37-41, so that its evaluations run beside phase 41.
        anakin = phases_42_46(workdir)
        last_trainers = phases_37_41(workdir)
        interaction = phases_47_50(workdir)
        telemetry = phases_51_53(workdir, path)
        resilience = phases_54_57(workdir, path)
        fleet_sizes = phases_58_60(workdir, interaction["sac_decoupled"]["fresh"], interaction["ppo_decoupled"]["host_wall_ms_per_iteration"])
        if async_vectors_built():
            fail(f"phases 1-60 built {async_vectors_built()} worker-process vector env(s): they are measured in-process")
        env_layer = phase_env_layer(workdir)
        data_parallel = phase_data_parallel(workdir)
        data_parallel_rest = phase_data_parallel_rest(workdir)
        replay_sample = phase_replay_sample()
        if PENDING_EVALS:
            fail(f"evaluations queued and never run: {[e[2] for e in PENDING_EVALS]}")
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

    timings = interaction["pipeline"]["timings"]

    def entry(name, source, replaces, shapes, launches, row, err):
        # The on-policy trainers' runs (phases 26-27), P2E-DV1's and SAC-AE's (37, 39) launch none: checked there, shown here.
        kind = {"ln_gru_forward": "forward", "ln_gru_forward_tensor_core": "tensor_core", "ln_gru_backward": "backward"}[name]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces, "shapes": shapes,
                "launches": launches, "max_abs_err": err, "ms": row["ms"], "ms_min": row["ms_min"], "ms_max": row["ms_max"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": None,
                "launches_a2c": a2c["training"]["ln_gru_launches"][kind],
                "launches_ppo_recurrent": ppo_recurrent["training"]["ln_gru_launches"][kind],
                "launches_p2e_dv1": last_trainers["p2e_dv1"]["ln_gru_launches"][kind],
                "launches_sac_ae": last_trainers["sac_ae"]["host"]["ln_gru_launches"][kind],
                "launches_dv3_anakin": anakin["dv3_anakin"]["ln_gru_launches"][kind],
                "launches_dv3_anakin_bf16": anakin["dv3_anakin"]["bf16_mixed"]["ln_gru_launches"][kind],
                "launches_ppo_anakin": 0, "launches_sac_anakin": 0,
                "launches_pipeline_s1": timings["s1_sync"]["ln_gru_launches"][kind], "launches_pipeline_s2": timings["s2_async"]["ln_gru_launches"][kind],
                "launches_host_player": interaction["placement"]["host_player"]["ln_gru_launches"][kind],
                "launches_sac_decoupled": interaction["sac_decoupled"]["fresh"]["ln_gru_launches"][kind],
                "launches_ppo_decoupled": interaction["ppo_decoupled"]["ln_gru_launches"][kind],
                "launches_telemetry_host": telemetry["telemetry"]["host"]["ln_gru_launches"][kind],
                "launches_telemetry_ring": telemetry["telemetry"]["ring"]["ln_gru_launches"][kind],
                "launches_health_host": resilience["health"]["host"]["ln_gru_launches"][kind],
                "launches_health_ring": resilience["health"]["ring"]["ln_gru_launches"][kind],
                "launches_fleet_sac": fleet_sizes["sac_fleet"]["ln_gru_launches"][kind],
                "launches_fleet_ppo": fleet_sizes["ppo_fleet"]["ln_gru_launches"][kind],
                "launches_env_layer_host": env_layer["host"]["ln_gru_launches"][kind],
                "launches_env_layer_ring": env_layer["ring"]["ln_gru_launches"][kind],
                "launches_dp": sum(r["ln_gru_launches"][kind] for r in data_parallel["two_ranks"]),
                "launches_dp_one_rank_nccl": data_parallel["one_rank"]["ln_gru_launches"][kind],
                "launches_dp_rest": sum(c[kind] for c in dp_rest_counts(None))}  # fmt: skip

    def dp_rest_counts(model):
        """Phase 63's LN-GRU counts of both ranks' runs of ``model`` (every model's with None)."""
        ranks = data_parallel_rest["two_ranks"]
        runs = {"dreamer_v2": ("dreamer_v2",), "p2e_dv2": ("p2e_dv2_exploration", "p2e_dv2_finetuning"), "p2e_dv3_xl": ()}
        out = []
        for m, names in runs.items():
            if model in (None, m):
                out += [ranks["rank0"][n]["ln_gru_launches"] for n in names] + [ranks["rank1"]["runs"][n]["ln_gru_launches"] for n in names]
                out += [ranks["rank0"]["xl"]["counts"], ranks["rank1"]["xl"]["counts"]] if m == "p2e_dv3_xl" else []
        return out

    def dp_rest_entry(row):
        """A kernel's entry at a rank's shapes of phase 63: the launches at
        its batch of both ranks' runs of its model."""
        forward = row["kind"] == "forward"
        key = "forward_by_batch" if forward else "backward_by_batch"
        launches = sum(c[key].get(row["batch"], 0) for c in dp_rest_counts(row["model"]))
        if forward:
            out = entry("ln_gru_forward", "sheeprl_tpu_torch/csrc/ln_gru.cu", "sheeprl_tpu/models/pallas_gru.py:118",
                        f"{row['shape']} {row['dtype']}, {row['kernel']} kernel ({row['model']} at a data-parallel rank's batch, 2 gloo ranks)", launches,
                        row, max(row["max_abs_err_h"], row["max_abs_err_z"]))  # fmt: skip
            return out | {"product_library_ms": row["product_library_ms"]}
        return entry("ln_gru_backward", "sheeprl_tpu_torch/csrc/ln_gru_bwd.cu", "sheeprl_tpu/models/pallas_gru.py:172",
                     f"{row['shape']} {row['dtype']} ({row['model']} at a data-parallel rank's batch, 2 gloo ranks)", launches, row,
                     max(row["max_abs_err"].values()))  # fmt: skip

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
    def anakin_entry(batch, dtype, kind, per, where):
        """A kernel's entry at the Anakin lane's DreamerV3-S shapes: the
        32-true run's launches for f32, the bf16-mixed run's for bf16."""
        dv3a = anakin["dv3_anakin"]
        counts = dv3a["ln_gru_launches"] if dtype == "float32" else dv3a["bf16_mixed"]["ln_gru_launches"]
        if kind == "tensor_core":
            row = anakin["anakin_kernels"]["tensor_core"]
            out = entry("ln_gru_forward_tensor_core", "sheeprl_tpu_torch/csrc/ln_gru_tc.cu", "sheeprl_tpu/models/pallas_gru.py:118",
                        f"{row['shape']} bfloat16, tensor-core kernel (DreamerV3-S Anakin lane {where}, bf16-mixed; {per})", counts["tensor_core"], row,
                        max(row["max_abs_err_h"], row["max_abs_err_z"]))  # fmt: skip
            return out | {"product_library_ms": row["product_library_ms"]}
        row = next(r for r in anakin["anakin_kernels"]["streaming"] if r["batch"] == batch and r["dtype"] == dtype)
        if kind == "forward":
            part = row["forward"]
            out = entry("ln_gru_forward", "sheeprl_tpu_torch/csrc/ln_gru.cu", "sheeprl_tpu/models/pallas_gru.py:118",
                        f"{row['shape']} {dtype}, streaming kernel (DreamerV3-S Anakin lane {where}; {per})", counts["forward_by_batch"].get(batch, 0), part,
                        max(part["max_abs_err_h"], part["max_abs_err_z"]))  # fmt: skip
            return out | {"product_library_ms": part["product_library_ms"]}
        part = row["backward"]
        return entry("ln_gru_backward", "sheeprl_tpu_torch/csrc/ln_gru_bwd.cu", "sheeprl_tpu/models/pallas_gru.py:172",
                     f"B={batch} H={DV3A_HIDDEN} {dtype} (DreamerV3-S Anakin lane {where}; {per})", counts["backward_by_batch"].get(batch, 0), part,
                     max(part["max_abs_err"].values()))  # fmt: skip

    per_rollout = f"{DV3A_SUPERSTEP} launches per rollout superstep, one an env step, inside the rollout's graph"
    per_step = f"{DV3A_SEQ} launches per gradient step"
    per_imagined = f"{DV3A_HORIZON} launches per gradient step"
    anakin_entries = [
        anakin_entry(DV3A_ENVS, "float32", "forward", per_rollout, "player"),
        anakin_entry(DV3A_ENVS, "bfloat16", "forward", per_rollout, "player"),
        anakin_entry(DV3A_BATCH, "float32", "forward", per_step, "dynamic scan"),
        anakin_entry(DV3A_BATCH, "bfloat16", "forward", per_step, "dynamic scan"),
        anakin_entry(DV3A_IMAGINED, "float32", "forward", per_imagined, "imagination"),
        anakin_entry(DV3A_IMAGINED, "bfloat16", "tensor_core", per_imagined, "imagination"),
        anakin_entry(DV3A_BATCH, "float32", "backward", per_step, "dynamic scan"),
        anakin_entry(DV3A_BATCH, "bfloat16", "backward", per_step, "dynamic scan"),
    ]
    dv3a = anakin["dv3_anakin"]
    def pipeline_entry(dtype, launches, where):
        """The streaming forward at the two-slice player's B = 2."""
        row = next(r for r in interaction["pipeline"]["kernels_b2"] if r["dtype"] == dtype)
        part = row["forward"]
        return entry("ln_gru_forward", "sheeprl_tpu_torch/csrc/ln_gru.cu", "sheeprl_tpu/models/pallas_gru.py:118",
                     f"{row['shape']} {dtype}, streaming kernel (DreamerV3-S player, {where}; 2 launches per env step, one a slice)", launches, part,
                     max(part["max_abs_err_h"], part["max_abs_err_z"])) | {"product_library_ms": part["product_library_ms"]}  # fmt: skip

    pipeline_entries = [
        pipeline_entry("bfloat16", timings["s2_async"]["ln_gru_launches"]["forward_by_batch"].get(PIPE_ENVS // 2, 0), "env.pipeline_slices=2 bf16-mixed"),
        pipeline_entry("float32", interaction["pipeline"]["s2_32_true_ln_gru_launches"]["forward_by_batch"].get(PIPE_ENVS // 2, 0),
                       "env.pipeline_slices=2 32-true, against one slice"),
    ]
    # The one-slice player runs at the Anakin player's B = 4 (phase 43's rows).
    anakin_entries[1] |= {"launches_pipeline_s1_b4": timings["s1_sync"]["ln_gru_launches"]["forward_by_batch"].get(PIPE_ENVS, 0)}
    anakin_entries[0] |= {"graph_nodes_per_rollout": dv3a["rollouts"]["c16_r0"]["graph"]["ln_gru"]["streaming"],
                          "launches_by_rollout_replays": dv3a["rollouts"]["c16_r0"]["graph"]["ln_gru"]["streaming"] * dv3a["rollouts"]["c16_r0"]["replays"]}
    def size_entry(size, batch, kind):
        """A kernel's entry at one DreamerV3 size's bf16 shapes (phase 60):
        the launches of its CLI gradient step's run (the player's B = 1
        included)."""
        sized = fleet_sizes["dv3_sizes"][size]
        row = next(r for r in sized["kernels"] if r["batch"] == batch and r["dtype"] == "bfloat16")
        counts = sized["step"]["ln_gru_launches"]
        if kind == "backward":
            part = row["backward"]
            return entry("ln_gru_backward", "sheeprl_tpu_torch/csrc/ln_gru_bwd.cu", "sheeprl_tpu/models/pallas_gru.py:172",
                         f"B={batch} H={row['shape'].rsplit('H=', 1)[1]} bfloat16 (DreamerV3-{size} {row['where']}; "
                         f"{BWD_BY_BATCH.get(batch, 0)} launches per discrete gradient step)", counts["backward_by_batch"].get(batch, 0), part,
                         max(part["max_abs_err"].values()))  # fmt: skip
        part = row["forward"]
        tc = row["kernel"] == "tensor_core"
        name, source = ("ln_gru_forward_tensor_core", "sheeprl_tpu_torch/csrc/ln_gru_tc.cu") if tc else ("ln_gru_forward", "sheeprl_tpu_torch/csrc/ln_gru.cu")
        per = f"{FWD_BY_BATCH[batch]} launches per gradient step" if batch in FWD_BY_BATCH else "1 launch per env step"
        out = entry(name, source, "sheeprl_tpu/models/pallas_gru.py:118",
                    f"{row['shape']} bfloat16, {row['kernel']} kernel (cluster {row['cluster']}; DreamerV3-{size} {row['where']}; {per})",
                    counts["forward_by_batch"].get(batch, 0), part, max(part["max_abs_err_h"], part["max_abs_err_z"]))  # fmt: skip
        return out | {"product_library_ms": part["product_library_ms"]}

    size_entries = [size_entry(size, batch, kind) for size in DV3_SIZES for batch, kind in
                    ((16, "forward"), (1024, "forward"), (1, "forward"), (16, "backward"), (1024, "backward"))]  # fmt: skip
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
            *anakin_entries,
            *pipeline_entries,
            *size_entries,
            *[dp_rest_entry(row) for row in data_parallel_rest["kernels_at_rank_shapes"]],
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
        **anakin,
        **interaction,
        **telemetry,
        **resilience,
        **fleet_sizes,
        "env_layer": env_layer,
        "data_parallel": data_parallel,
        "data_parallel_rest": data_parallel_rest,
        "kernels": kernels_line["kernels"],
        "phase_s": phase_s,
        "profiler_s": PROFILER_S,
    }
    log(f"phase seconds: {json.dumps({k: round(v, 2) for k, v in phase_s.items()})}")
    log(f"torch.profiler seconds by phase: {json.dumps({k: round(v, 2) for k, v in PROFILER_S.items()})}")
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as fp:
        json.dump(report, fp, indent=2)
    print(json.dumps(kernels_line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
