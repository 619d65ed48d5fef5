"""The port's experiment configs, as Python dicts.

``exp=dreamer_v3_100k_ms_pacman`` and ``exp=dreamer_v3_dmc_walker_walk`` are
held here as the JAX package composes them from configs/exp/<name>.yaml,
exp/dreamer_v3.yaml, algo/dreamer_v3.yaml, algo/dreamer_v3_S.yaml (DreamerV3-S:
512 units, 2 layers, recurrent state 512, CNN multiplier 32; 64x64 rgb;
bf16-mixed), the ``checkpoint``, ``buffer`` and ``metric`` groups and
configs/config.yaml's run names, cut to the keys the port reads. The
optimizers keep their hyperparameters and drop the JAX package's
``_target_``; the metric aggregator's and the logger's ``_target_`` name the
port's classes (``sheeprl_tpu_torch.utils.metric.MeanMetric`` where the JAX
package has ``sheeprl_tpu.utils.metric.MeanMetric``). Four keys are the
port's own: ``device`` (``cuda`` unless ``device=cpu``), ``env_group`` (the
env chosen with ``env=``), ``env.wrapper.action_dim`` (the dummy env's
action count, a keyword of the JAX package's ``get_dummy_env``) and
``buffer.memmap_mode`` (the mode the buffer's files open in, the JAX
buffer's default ``r+``). A run writes under
``<log_root>/<root_dir>/<run_name>/version_<N>``, ``run_name`` being
``<time>_<algo.name>_<env.id>_<seed>``. Reading YAML is not ported: the
card's host has no PyYAML.

A value ``"${a.b}"`` is the YAML's interpolation: it takes the value of
``a.b`` after the overrides, so ``algo.dense_units=16`` sets every head's
width as it does in the JAX package; ``"${now:<strftime format>}"`` is the
time of :func:`compose`, the same everywhere in one config. :func:`compose`
takes ``exp=...``, ``env=...`` and ``key=value`` overrides, as the JAX
package's command line does.
"""

from __future__ import annotations

import copy
import json
import re
import time
from typing import Any, Callable, Dict, List, Sequence

from sheeprl_tpu_torch.utils.utils import dotdict


def _layer_norm() -> Dict[str, Any]:
    return {"cls": "layer_norm", "kw": {"eps": 1e-3}}


def _adam(lr: float, eps: float) -> Dict[str, Any]:
    return {"lr": lr, "eps": eps, "weight_decay": 0, "betas": [0.9, 0.999]}


# metric/default.yaml's two entries, then exp/dreamer_v3.yaml's thirteen.
AGGREGATOR_METRICS = (
    "Rewards/rew_avg", "Game/ep_len_avg",
    "Loss/world_model_loss", "Loss/value_loss", "Loss/policy_loss", "Loss/observation_loss", "Loss/reward_loss",
    "Loss/state_loss", "Loss/continue_loss", "State/kl", "State/post_entropy", "State/prior_entropy",
    "Grads/world_model", "Grads/actor", "Grads/critic",
)  # fmt: skip


def _metric() -> Dict[str, Any]:
    """metric/default.yaml with exp/dreamer_v3.yaml's aggregator entries and
    logger/tensorboard.yaml."""
    mean = {"_target_": "sheeprl_tpu_torch.utils.metric.MeanMetric", "sync_on_compute": "${metric.sync_on_compute}"}
    return {
        "log_every": 5000,
        "disable_timer": False,
        "log_level": 1,
        "sync_on_compute": False,
        "aggregator": {
            "_target_": "sheeprl_tpu_torch.utils.metric.MetricAggregator",
            "raise_on_missing": False,
            "metrics": {name: dict(mean) for name in AGGREGATOR_METRICS},
        },
        "logger": {
            "_target_": "sheeprl_tpu_torch.utils.logger.TensorBoardLogger",
            "root_dir": "${log_root}/${root_dir}",
            "run_name": "${run_name}",
        },
    }


def _dreamer_v3_s() -> Dict[str, Any]:
    """exp/dreamer_v3.yaml over algo/dreamer_v3_S.yaml: what both exps share."""
    units, layers = "${algo.dense_units}", "${algo.mlp_layers}"
    return {
        "seed": 5,
        "device": "cuda",
        "env_group": None,
        "dry_run": False,
        "exp_name": "${algo.name}_${env.id}",
        "run_name": "${now:%Y-%m-%d_%H-%M-%S}_${exp_name}_${seed}",
        "root_dir": "${algo.name}/${env.id}",
        "log_root": "logs/runs",
        "algo": {
            "name": "dreamer_v3",
            "run_test": True,
            "total_steps": 5000000,
            "per_rank_batch_size": 16,
            "per_rank_sequence_length": 64,
            "learning_starts": 1024,
            "replay_ratio": 1,
            "per_rank_pretrain_steps": 0,
            "fused_train_steps": 1,
            "gamma": 0.996996996996997,
            "lmbda": 0.95,
            "horizon": 15,
            "cnn_keys": {"encoder": ["rgb"], "decoder": ["rgb"]},
            "mlp_keys": {"encoder": [], "decoder": []},
            "cnn_layer_norm": _layer_norm(),
            "mlp_layer_norm": _layer_norm(),
            "dense_units": 512,
            "mlp_layers": 2,
            "unimix": 0.01,
            "world_model": {
                "discrete_size": 32,
                "stochastic_size": 32,
                "kl_dynamic": 0.5,
                "kl_representation": 0.1,
                "kl_free_nats": 1.0,
                "kl_regularizer": 1.0,
                "continue_scale_factor": 1.0,
                "clip_gradients": 1000.0,
                "decoupled_rssm": False,
                "encoder": {"cnn_channels_multiplier": 32, "mlp_layers": layers, "dense_units": units},
                "recurrent_model": {"recurrent_state_size": 512, "dense_units": units},
                "transition_model": {"hidden_size": 512},
                "representation_model": {"hidden_size": 512},
                "observation_model": {
                    "cnn_channels_multiplier": "${algo.world_model.encoder.cnn_channels_multiplier}",
                    "mlp_layers": layers,
                    "dense_units": units,
                },
                "reward_model": {"mlp_layers": layers, "dense_units": units, "bins": 255},
                "discount_model": {"mlp_layers": layers, "dense_units": units},
                "optimizer": _adam(1e-4, 1e-8),
            },
            "actor": {
                "ent_coef": 3e-4,
                "min_std": 0.1,
                "max_std": 1.0,
                "init_std": 2.0,
                "mlp_layers": layers,
                "dense_units": units,
                "clip_gradients": 100.0,
                "action_clip": 1.0,
                "cls": "default",
                "moments": {"decay": 0.99, "max": 1.0, "percentile": {"low": 0.05, "high": 0.95}},
                "optimizer": _adam(8e-5, 1e-5),
            },
            "critic": {
                "mlp_layers": layers,
                "dense_units": units,
                "per_rank_target_network_update_freq": 1,
                "tau": 0.02,
                "bins": 255,
                "clip_gradients": 100.0,
                "optimizer": _adam(8e-5, 1e-5),
            },
        },
        "env": {"id": None, "num_envs": 4, "screen_size": 64, "action_repeat": 1, "clip_rewards": False, "wrapper": {"action_dim": 2}},
        "buffer": {
            "size": 1000000, "memmap": True, "memmap_mode": "r+", "validate_args": False, "checkpoint": True,
            "prefetch": False, "device": False, "device_hbm_fraction": 0.4,
        },  # fmt: skip
        "checkpoint": {"every": 100000, "resume_from": None, "save_last": True, "keep_last": 5},
        "metric": _metric(),
        "fabric": {"precision": "bf16-mixed"},
        "distribution": {"type": "auto"},
    }


def dreamer_v3_100k_ms_pacman() -> Dict[str, Any]:
    """DreamerV3-S on Atari MsPacman, 100K steps (9 actions)."""
    cfg = _dreamer_v3_s()
    cfg["algo"].update(total_steps=100000, learning_starts=1024)
    cfg["env"].update(id="MsPacmanNoFrameskip-v4", num_envs=1, wrapper={"action_dim": 9})
    cfg["buffer"]["size"] = 100000
    cfg["checkpoint"]["every"] = 2000
    return cfg


def dreamer_v3_dmc_walker_walk() -> Dict[str, Any]:
    """DreamerV3-S on DMC walker-walk from pixels, 500K steps: 4 envs,
    action repeat 2, replay ratio 0.5, 6 continuous actions in [-1, 1]. With
    ``env=dummy`` the JAX package composes ``env.id=discrete_dummy``; the port
    stands the continuous dummy in for the walker, so its id is
    ``continuous_dummy``."""
    cfg = _dreamer_v3_s()
    cfg["algo"].update(total_steps=500000, learning_starts=1300, replay_ratio=0.5)
    cfg["env"].update(id="continuous_dummy", num_envs=4, action_repeat=2, wrapper={"action_dim": 6})
    cfg["buffer"]["size"] = 500000
    cfg["checkpoint"]["every"] = 10000
    return cfg


EXPERIMENTS: Dict[str, Callable[[], Dict[str, Any]]] = {
    "dreamer_v3_100k_ms_pacman": dreamer_v3_100k_ms_pacman,
    "dreamer_v3_dmc_walker_walk": dreamer_v3_dmc_walker_walk,
}
ENVS = ("dummy",)


def parse_overrides(overrides: Sequence[str]) -> Dict[str, str]:
    """``key=value`` arguments -> {key: value} (a leading ``+`` is dropped)."""
    out: Dict[str, str] = {}
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"arguments are key=value pairs, got {ov!r}")
        key, value = ov.split("=", 1)
        out[key.lstrip("+")] = value
    return out


def parse_list(value: str) -> List[str]:
    """``[a,b]``, ``["a", "b"]`` or a bare ``a``."""
    value = value.strip()
    if value.startswith("[") and value.endswith("]"):
        try:
            items = json.loads(value)
        except ValueError:
            items = [v.strip().strip("'\"") for v in value[1:-1].split(",")]
        return [str(v) for v in items if str(v)]
    return [value] if value else []


def _coerce(old: Any, text: str, key: str) -> Any:
    """``text`` as the type of the value it replaces."""
    if isinstance(old, bool):
        if text.lower() not in ("true", "false"):
            raise ValueError(f"{key} takes True or False, got {text!r}")
        return text.lower() == "true"
    if isinstance(old, int):
        value = float(text)
        if not value.is_integer():
            raise ValueError(f"{key} takes an integer, got {text!r}")
        return int(value)
    if isinstance(old, float):
        return float(text)
    if isinstance(old, list):
        items = parse_list(text)
        return [type(old[0])(v) for v in items] if old else items
    if old is None or isinstance(old, str):
        return text
    raise ValueError(f"{key} cannot be set from the command line")


def _lookup(cfg: Dict[str, Any], path: str) -> Any:
    node: Any = cfg
    for part in path.split("."):
        if not isinstance(node, dict) or part not in node:
            raise ValueError(f"Unknown config key {path!r}")
        node = node[part]
    return node


_INTERPOLATION = re.compile(r"\$\{([^}]+)\}")
_NOW = re.compile(r"\$\{now:([^}]*)\}")


def _stamp_now(node: Any, now: time.struct_time) -> Any:
    """``node`` with every ``${now:<format>}`` replaced by ``now`` in that format."""
    if isinstance(node, dict):
        return {k: _stamp_now(v, now) for k, v in node.items()}
    if isinstance(node, str):
        return _NOW.sub(lambda m: time.strftime(m.group(1), now), node)
    return node


def _resolve(cfg: Dict[str, Any], value: Any, depth: int = 0) -> Any:
    """A value with its ``${path}`` references resolved: a value that is one
    reference takes the referenced value, type and all; references inside a
    longer string are replaced by their text."""
    if depth > 16:
        raise ValueError("config interpolation too deep (a cycle?)")
    if not isinstance(value, str):
        return value
    whole = _INTERPOLATION.fullmatch(value)
    if whole:
        return _resolve(cfg, _lookup(cfg, whole.group(1)), depth + 1)
    return _INTERPOLATION.sub(lambda m: str(_resolve(cfg, _lookup(cfg, m.group(1)), depth + 1)), value)


def _resolve_tree(cfg: Dict[str, Any], node: Dict[str, Any]) -> Dict[str, Any]:
    return {k: _resolve_tree(cfg, v) if isinstance(v, dict) else copy.deepcopy(_resolve(cfg, v)) for k, v in node.items()}


def compose(args: Sequence[str]) -> dotdict:
    """The config of ``exp=<name> env=<name> [key=value ...]``, with every
    interpolation resolved. Raises on an experiment or env the port does not
    have, and on an unknown key."""
    kv = parse_overrides(args)
    exp = kv.pop("exp", None)
    env = kv.pop("env", None)
    if exp not in EXPERIMENTS:
        raise ValueError(f"exp={exp} is not ported; the port has exp={' | '.join(sorted(EXPERIMENTS))}")
    if env not in ENVS:
        raise ValueError(f"env={env} is not ported; the port has env={' | '.join(ENVS)}")
    cfg = _stamp_now(EXPERIMENTS[exp](), time.localtime())
    cfg["env_group"] = env
    set_overrides(cfg, kv)
    return dotdict(_resolve_tree(cfg, cfg))


def set_overrides(cfg: Dict[str, Any], kv: Dict[str, str]) -> None:
    """Set each ``key`` of ``cfg`` in place to its ``text`` read as the type
    of the value it replaces. Raises on an unknown key."""
    for key, text in kv.items():
        *parents, leaf = key.split(".")
        node = _lookup(cfg, ".".join(parents)) if parents else cfg
        if not isinstance(node, dict) or leaf not in node or isinstance(node[leaf], dict):
            raise ValueError(f"Unknown config key {key!r}")
        node[leaf] = _coerce(_resolve(cfg, node[leaf]), text, key)
