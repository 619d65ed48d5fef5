"""Command lines of the port::

    python -m sheeprl_tpu_torch exp=<ppo | ppo_atari | a2c | ppo_recurrent | sac | droq | sac_ae | dreamer_v3_100k_ms_pacman | dreamer_v2_ms_pacman | ...> env=dummy [key=value ...] [device=cpu]
    python -m sheeprl_tpu_torch exp=<p2e_dv3_finetuning | p2e_dv2_finetuning | p2e_dv1_finetuning> env=dummy checkpoint.exploration_ckpt_path=<exploration run>/version_N/checkpoint/ckpt_<step>_0.ckpt [...]
    python -m sheeprl_tpu_torch.eval checkpoint_path=<run>/version_N/checkpoint/ckpt_<step>_0.ckpt [key=value ...] [device=cpu]

They run on ``cuda`` unless ``device=cpu`` is given, and raise without a
card. The config is composed from the port's tree
(:mod:`sheeprl_tpu_torch.config`, ``sheeprl_tpu_torch/configs/``): any exp
there composes (``ppo``, ``ppo_atari``, ``a2c``, ``ppo_recurrent``, ``sac``, ``droq``,
``sac_ae``, ``dreamer_v3_100k_ms_pacman``, ``dreamer_v3_dmc_walker_walk``,
``dreamer_v3``, ``dreamer_v2_ms_pacman``, ``dreamer_v2``, ``dreamer_v1``,
``p2e_dv3_exploration``, ``p2e_dv3_finetuning``, ``p2e_dv2_exploration``,
``p2e_dv2_finetuning``, ``p2e_dv1_exploration``, ``p2e_dv1_finetuning``;
SAC, DroQ and SAC-AE want ``env.id=continuous_dummy``; a
P2E finetuning run names its exploration run's checkpoint), an unknown key raises, and
the trainer then raises on an algorithm the port does not train and on an env
group other than ``env=dummy``. Keys are those of the composed config, e.g.
``algo.learning_starts=128 algo.total_steps=136 buffer.size=4096``.
"""

from __future__ import annotations

import importlib
import json
import os
import pathlib
import sys
from typing import Any, Dict, Optional, Sequence

from sheeprl_tpu_torch.config import compose, parse_overrides, set_overrides
from sheeprl_tpu_torch.core.device import resolve_device
from sheeprl_tpu_torch.registry import algorithm_registry, evaluation_registry, register_all
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
    utils_module = importlib.import_module(entry.module.rsplit(".", 1)[0] + ".utils")
    _prune_metric_keys(cfg, utils_module.AGGREGATOR_KEYS)
    if cfg.checkpoint.resume_from:
        cfg = resume_config(cfg)
    if entry.after_exploration:
        return entry.entrypoint(cfg, callback=callback, exploration_cfg=exploration_chain(cfg))
    return entry.entrypoint(cfg, callback=callback)


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
