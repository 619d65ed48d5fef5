"""Command lines of the port::

    python -m sheeprl_tpu_torch exp=<ppo | ppo_atari | a2c | ppo_recurrent | sac | droq | sac_ae | dreamer_v3_100k_ms_pacman | dreamer_v2_ms_pacman | ...> env=dummy [key=value ...] [device=cpu]
    python -m sheeprl_tpu_torch exp=<ppo_anakin | sac_anakin | dreamer_v3_anakin> [algo.fused_rollout=false] [key=value ...] [device=cpu]
    python -m sheeprl_tpu_torch exp=<p2e_dv3_finetuning | p2e_dv2_finetuning | p2e_dv1_finetuning> env=dummy checkpoint.exploration_ckpt_path=<exploration run>/version_N/checkpoint/ckpt_<step>_0.ckpt [...]
    python -m sheeprl_tpu_torch exp=<ppo_decoupled | sac_decoupled> env=dummy fabric.devices=1 fabric.player_device=host [...]
    python -m sheeprl_tpu_torch.eval checkpoint_path=<run>/version_N/checkpoint/ckpt_<step>_0.ckpt [key=value ...] [device=cpu]

They run on ``cuda`` unless ``device=cpu`` is given, and raise without a
card. ``telemetry=on`` (or ``telemetry.enabled=True``) traces the run into
``trace.json`` and ``telemetry.jsonl`` in its log dir (``telemetry=profile``
adds a ``torch.profiler`` window); ``health=on`` (or ``health=strict``) adds
the training-health probes and sentinels, and the ``resilience`` group the
preemption guard (on by default), the env supervisor, the watchdog and
fault injection (``core/resilience.py``, ``core/chaos.py``);
``checkpoint.resume_from=auto[:<dir>]`` resumes from a preempted run's
``autoresume.json`` or the newest valid checkpoint under ``<dir>`` (the
working directory by default). The config is composed from the port's tree
(:mod:`sheeprl_tpu_torch.config`, ``sheeprl_tpu_torch/configs/``): any exp
there composes (``ppo``, ``ppo_atari``, ``a2c``, ``ppo_recurrent``, ``sac``, ``droq``,
``sac_ae``, ``dreamer_v3_100k_ms_pacman``, ``dreamer_v3_dmc_walker_walk``,
``dreamer_v3``, ``dreamer_v2_ms_pacman``, ``dreamer_v2``, ``dreamer_v1``,
``p2e_dv3_exploration``, ``p2e_dv3_finetuning``, ``p2e_dv2_exploration``,
``p2e_dv2_finetuning``, ``p2e_dv1_exploration``, ``p2e_dv1_finetuning``,
and the Anakin lane's ``ppo_anakin``, ``sac_anakin``, ``dreamer_v3_anakin``
(``env=jax_cartpole``, ``jax_pendulum``, ``jax_gridworld``: the fused lane,
or the host lane with ``algo.fused_rollout=false``);
SAC, DroQ and SAC-AE want ``env.id=continuous_dummy``; a
P2E finetuning run names its exploration run's checkpoint; the decoupled
``ppo_decoupled`` and ``sac_decoupled`` run on one card with the player on
the host, ``fabric.devices=1 fabric.player_device=host``), an unknown key raises, and
the trainer then raises on an algorithm the port does not train and on an env
group other than ``env=dummy`` and the anakin groups. Keys are those of the composed config, e.g.
``algo.learning_starts=128 algo.total_steps=136 buffer.size=4096``.
"""

from __future__ import annotations

import importlib
import json
import os
import pathlib
import sys
from typing import Any, Dict, Optional, Sequence

import torch

from sheeprl_tpu_torch.config import compose, parse_overrides, set_overrides
from sheeprl_tpu_torch.core.device import resolve_device
from sheeprl_tpu_torch.core.resilience import Resilience, resolve_auto_resume
from sheeprl_tpu_torch.core.resilience import run_scope as resilience_scope
from sheeprl_tpu_torch.registry import algorithm_registry, evaluation_registry, register_all
from sheeprl_tpu_torch.telemetry import Telemetry, run_scope
from sheeprl_tpu_torch.telemetry.health import HealthMonitor
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint, resume_config
from sheeprl_tpu_torch.utils.metric import MetricAggregator
from sheeprl_tpu_torch.utils.timer import timer
from sheeprl_tpu_torch.utils.utils import dotdict


def _prune_metric_keys(cfg, aggregator_keys) -> None:
    """Keep the aggregator's metrics the algorithm logs, and set the timer's
    and the aggregator's ``disabled`` flags from ``metric.log_level`` and
    ``metric.disable_timer`` (reference: cli.py:151-181)."""
    timer.disabled = cfg.metric.log_level == 0 or cfg.metric.disable_timer
    for k in set(cfg.metric.aggregator.metrics) - set(aggregator_keys):
        cfg.metric.aggregator.metrics.pop(k, None)
    MetricAggregator.disabled = cfg.metric.log_level == 0 or len(cfg.metric.aggregator.metrics) == 0


def run(args: Optional[Sequence[str]] = None, callback=None) -> Dict[str, Any]:
    """Compose the config from ``args`` (``sys.argv[1:]`` by default) and
    train with the algorithm ``algo.name`` registers; returns what its
    ``main`` returns (for DreamerV3,
    :func:`sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3.main`). With
    ``checkpoint.resume_from`` the saved run's config is merged in first
    (:func:`resume_config`); a P2E finetuning run then takes its exploration
    run's settings (:func:`exploration_chain`)."""
    argv = list(args) if args is not None else sys.argv[1:]
    if argv and argv[0] in ("-h", "--help"):
        print(__doc__)
        return {}
    register_all()
    cfg = compose(argv)
    entry = algorithm_registry.get(cfg.algo.name)
    if entry is None:
        raise ValueError(f"algo.name={cfg.algo.name} is not ported; the port trains algo.name={' | '.join(sorted(algorithm_registry))}")
    check_anakin(cfg)
    check_decoupled(cfg, entry)
    check_observability(cfg)
    utils_module = importlib.import_module(entry.module.rsplit(".", 1)[0] + ".utils")
    _prune_metric_keys(cfg, utils_module.AGGREGATOR_KEYS)
    num_threads = int(cfg.get("num_threads", 1))
    if str(cfg.checkpoint.resume_from or "").startswith("auto"):
        resolve_auto(cfg)
    if cfg.checkpoint.resume_from:
        cfg = resume_config(cfg)
    # Host threads for the run, both restored after it (reference:
    # cli.py:355): OMP_NUM_THREADS, unless already set, for the processes the
    # run starts, and torch's intra-op pool.
    set_omp = "OMP_NUM_THREADS" not in os.environ
    if set_omp:
        os.environ["OMP_NUM_THREADS"] = str(num_threads)
    previous_threads = torch.get_num_threads()
    torch.set_num_threads(num_threads)
    # The run's observability and fault-tolerance surfaces (reference:
    # cli.py:325-337): the trainer opens them at its log dir and threads
    # them through its loop.
    try:
        with run_scope(Telemetry.from_config(cfg)), resilience_scope(Resilience.from_config(cfg), HealthMonitor.from_config(cfg)):
            if entry.after_exploration:
                return entry.entrypoint(cfg, callback=callback, exploration_cfg=exploration_chain(cfg))
            return entry.entrypoint(cfg, callback=callback)
    finally:
        torch.set_num_threads(previous_threads)
        if set_omp:
            os.environ.pop("OMP_NUM_THREADS", None)


def resolve_auto(cfg) -> None:
    """``checkpoint.resume_from=auto[:<dir>]`` -> the preempted run's
    ``autoresume.json`` target, else the newest valid checkpoint under
    ``<dir>`` (``log_root`` by default; reference: cli.py:356-369)."""
    resolved = resolve_auto_resume(str(cfg.checkpoint.resume_from), cfg.get("log_root"))
    if resolved is None:
        raise FileNotFoundError(
            f"checkpoint.resume_from={cfg.checkpoint.resume_from!r}: no valid checkpoint found (no autoresume.json pointer and no manifest-valid ckpt_*.ckpt)"
        )
    print(f"Auto-resume: resolved {cfg.checkpoint.resume_from!r} -> {resolved}", flush=True)
    cfg.checkpoint.resume_from = resolved


def check_observability(cfg) -> None:
    """The telemetry profiler window must satisfy ``0 <= start_step <
    stop_step`` or be ``-1, -1`` (reference: cli.py:101-110)."""
    tele = cfg.get("telemetry")
    if tele is not None and tele.get("profiler") is not None:
        start = int(tele.profiler.get("start_step", -1))
        stop = int(tele.profiler.get("stop_step", -1))
        if (start >= 0) != (stop >= 0) or (start >= 0 and stop <= start):
            raise ValueError(f"telemetry.profiler window must satisfy 0 <= start_step < stop_step (or both -1 to disable); got [{start}, {stop})")


def check_anakin(cfg) -> None:
    """The Anakin lane's checks (reference: cli.py:171-192):
    ``algo.fused_rollout`` needs ``env.jax_native`` and one of ppo, sac and
    dreamer_v3, ``algo.fused_superstep_steps`` is at least 1, and
    ``env.jax_native`` needs an id of a registered anakin env."""
    if bool(cfg.algo.get("fused_rollout", False)):
        if not bool(cfg.env.get("jax_native", False)):
            raise ValueError(
                "algo.fused_rollout=True requires env.jax_native=True: the fused superstep steps the env inside the "
                "rollout graph, so it must be a batched torch env (sheeprl_tpu_torch/envs/anakin: env=jax_cartpole, env=jax_pendulum, env=jax_gridworld)."
            )
        if cfg.algo.name not in ("ppo", "sac", "dreamer_v3"):
            raise ValueError(
                f"algo.fused_rollout is implemented for ppo, sac and dreamer_v3; got '{cfg.algo.name}'. Run this algorithm on an "
                "anakin env through the host lane (env.jax_native with algo.fused_rollout=false) instead."
            )
        if int(cfg.algo.get("fused_superstep_steps", 64)) < 1:
            raise ValueError("algo.fused_superstep_steps must be >= 1")
    if bool(cfg.env.get("jax_native", False)):
        from sheeprl_tpu_torch.envs.anakin import make_anakin_env

        try:
            make_anakin_env(cfg.env.id)
        except ValueError as err:
            raise ValueError(f"env.jax_native=True but env.id is not a registered anakin env: {err}") from err


def check_decoupled(cfg, entry) -> None:
    """A decoupled run needs a placement it can run (reference:
    cli.py:195-205): the explicit on-mesh split on one device raises here;
    ``auto`` is resolved in the trainer, and raises there if it resolves to
    the mesh (:func:`sheeprl_tpu_torch.core.mesh.split_player_trainer`)."""
    player_device = str(cfg.fabric.get("player_device") or "auto").lower()
    if entry.decoupled and player_device == "mesh" and cfg.fabric.get("devices", 1) in (1, "1"):
        raise RuntimeError(
            f"The decoupled algorithm '{cfg.algo.name}' requires at least 2 devices/processes (one player + at least one trainer), "
            "or fabric.player_device=host to run the player on the host CPU and train on every device."
        )


# The env settings a P2E finetuning run takes from its exploration run.
EXPLORATION_ENV_KEYS = (
    "frame_stack", "screen_size", "action_repeat", "grayscale", "clip_rewards", "frame_stack_dilation", "max_episode_steps",
    "reward_as_observation",
)  # fmt: skip


def exploration_chain(cfg) -> dotdict:
    """P2E's chain (reference: cli.py:267-311): a finetuning run reads its
    exploration run's ``config.json`` (two levels above
    ``checkpoint.exploration_ckpt_path``), refuses another ``env.id``, and
    takes that run's env settings (and, with
    ``buffer.load_from_exploration``, its devices and nodes). Returns the
    exploration run's config."""
    path = cfg.checkpoint.get("exploration_ckpt_path")
    if not path or str(path) == "???":
        raise ValueError(
            "P2E finetuning needs the exploration phase's checkpoint: set 'checkpoint.exploration_ckpt_path=<path-to-exploration-ckpt>'."
        )
    with open(pathlib.Path(path).absolute().parent.parent / "config.json") as fp:
        exploration_cfg = dotdict(json.load(fp))
    if exploration_cfg.env.id != cfg.env.id:
        raise ValueError(
            "This experiment is run with a different environment from the one of the exploration you want to finetune. "
            f"Got '{cfg.env.id}', but the environment used during exploration was {exploration_cfg.env.id}. "
            "Set properly the environment for finetuning the experiment."
        )
    for key in EXPLORATION_ENV_KEYS:
        cfg.env[key] = exploration_cfg.env[key]
    if cfg.buffer.load_from_exploration:
        cfg.fabric.devices = exploration_cfg.fabric.devices
        cfg.fabric.num_nodes = exploration_cfg.fabric.num_nodes
    return exploration_cfg


def evaluation(args: Optional[Sequence[str]] = None) -> Any:
    """Evaluate a checkpoint: the run's ``config.json`` (two levels above the
    checkpoint) with the command line's overrides on top, ``env.num_envs`` 1
    unless set, on ``cuda`` unless ``device=...`` is given, logging under
    ``<run>/<version>/evaluation/version_<N>`` (reference: cli.py:433-)."""
    overrides = list(args) if args is not None else sys.argv[1:]
    ckpt = [o for o in overrides if o.startswith("checkpoint_path=")]
    if not ckpt:
        raise ValueError("You must specify checkpoint_path=<path-to-checkpoint>")
    checkpoint_path = pathlib.Path(ckpt[-1].split("=", 1)[1]).absolute()
    kv = parse_overrides([o for o in overrides if not o.startswith("checkpoint_path=")])
    with open(checkpoint_path.parent.parent / "config.json") as fp:
        cfg = json.load(fp)
    set_overrides(cfg, kv)
    cfg = dotdict(cfg)
    # <run_name>/<version_N>/evaluation beside the evaluated run.
    cfg.root_dir = str(checkpoint_path.parent.parent.parent.parent)
    cfg.run_name = os.path.join(checkpoint_path.parent.parent.parent.name, checkpoint_path.parent.parent.name, "evaluation")
    cfg.checkpoint.resume_from = str(checkpoint_path)
    if "env.num_envs" not in kv:
        cfg.env.num_envs = 1
    if "device" not in kv:
        cfg.device = "cuda"
    resolve_device(cfg.device)
    register_all()
    if cfg.algo.name not in evaluation_registry:
        raise RuntimeError(
            f"Given the algorithm named '{cfg.algo.name}', no evaluation entrypoint has been registered. "
            f"Available: {sorted(evaluation_registry)}"
        )
    state = load_checkpoint(str(checkpoint_path))
    return evaluation_registry[cfg.algo.name].entrypoint(cfg, state)
