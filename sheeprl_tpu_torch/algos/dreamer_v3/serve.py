"""DreamerV3 policy adapter: stateful sessions (counterpart of
sheeprl_tpu/algos/dreamer_v3/serve.py).

Each session holds ``{player: {recurrent_state, stochastic_state, actions},
generator}``: the player state from ``init_player_state(1)`` and a CPU
``torch.Generator`` seeded from the session's first request. A request
advances its session by one ``player_step``. Sessions batch by stacking
their rows on the leading axis; each row draws its samples from its own
generator, so a row's actions do not depend on which sessions shared its
batch.

:meth:`DreamerV3Policy.export` takes the policy out of a training
checkpoint (for ``serve export``); :func:`export_random` writes a
DreamerV3-S / MsPacman artifact (``exp=dreamer_v3_100k_ms_pacman``) from the
port's seeded initialiser. Discrete actions come back as indices, ``Box``
actions as floats within the bounds (the actor's clip to [-1, 1]).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.algos.dreamer_v3.agent import WorldModel, build_agent
from sheeprl_tpu_torch.utils.utils import normalize_obs
from sheeprl_tpu_torch.algos.ppo.agent import actions_metadata
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.serve.adapter import PolicyAdapterBase
from sheeprl_tpu_torch.serve.artifact import write_artifact
from sheeprl_tpu_torch.serve.registry import register_policy
from sheeprl_tpu_torch.serve.spaces import Box, DictSpace, Discrete
from sheeprl_tpu_torch.utils.distribution import RowGenerators
from sheeprl_tpu_torch.utils.utils import dotdict


@register_policy("dreamer_v3")
class DreamerV3Policy(PolicyAdapterBase):
    stateful = True

    def __init__(self, spec: Dict[str, Any], params: Dict[str, Dict[str, torch.Tensor]], device: torch.device) -> None:
        super().__init__(spec, params, device)
        actions_dim, is_continuous = actions_metadata(self.action_space)
        self.agent = build_agent(
            actions_dim,
            is_continuous,
            self.cfg,
            self.obs_space,
            precision=self.precision,
            device=self.device,
            world_model_state=params["world_model"],
            actor_state=params["actor"],
        )

    @classmethod
    def export(cls, state: Dict[str, Any], cfg) -> Tuple[Dict[str, Dict[str, torch.Tensor]], Dict[str, Any]]:
        """(params, config subtree) of an artifact from a training
        checkpoint's state and the run's config: the world model without its
        decoders and reward and continue heads, the actor, and everything the
        modules' rebuild reads (``algo`` whole), nothing of the training
        side."""
        config = {
            "algo": dict(cfg.algo),
            "distribution": dict(cfg.get("distribution") or {"type": "auto"}),
            "env": {"screen_size": cfg.env.screen_size},
            "precision": str(cfg.fabric.precision),
        }
        world_model = {k: v for k, v in state["world_model"].items() if k.split(".")[0] not in WorldModel.TRAINING_HEADS}
        return {"world_model": world_model, "actor": state["actor"]}, config

    def new_session(self, seed: int) -> Dict[str, Any]:
        return {"player": self.agent.init_player_state(1), "generator": torch.Generator().manual_seed(int(seed))}

    @staticmethod
    def stack_sessions(rows: List[Dict[str, Any]]) -> Dict[str, Any]:
        return {
            "player": {k: torch.cat([r["player"][k] for r in rows]) for k in rows[0]["player"]},
            "generators": [r["generator"] for r in rows],
        }

    @staticmethod
    def session_row(state: Dict[str, Any], i: int) -> Dict[str, Any]:
        return {"player": {k: v[i : i + 1] for k, v in state["player"].items()}, "generator": state["generators"][i]}

    def apply(self, obs: Dict[str, np.ndarray], seeds: np.ndarray, state: Dict[str, Any], greedy: bool):
        obs_t = normalize_obs({k: torch.from_numpy(v).to(self.device) for k, v in obs.items()}, self.cnn_keys)
        rng = RowGenerators(state["generators"], self.device)
        _, real_actions, player = self.agent.player_step(state["player"], obs_t, rng, greedy=greedy)
        if self.agent.is_continuous:
            real_actions = real_actions.float()  # numpy has no bf16
        return real_actions.cpu().numpy(), {"player": player, "generators": state["generators"]}


def dreamer_v3_s_ms_pacman_config(precision: str = "bf16-mixed") -> Dict[str, Any]:
    """The config subtree the adapter reads, taken from the port's
    ``exp=dreamer_v3_100k_ms_pacman`` (composed from sheeprl_tpu_torch/configs/), with the
    given precision."""
    cfg = compose(["exp=dreamer_v3_100k_ms_pacman", "env=dummy"])
    algo, wm, actor = cfg["algo"], cfg["algo"]["world_model"], cfg["algo"]["actor"]

    def pick(node: Dict[str, Any], *keys: str) -> Dict[str, Any]:
        return {k: node[k] for k in keys}

    return {
        "algo": {
            **pick(algo, "name", "cnn_keys", "mlp_keys", "cnn_layer_norm", "mlp_layer_norm", "dense_units", "mlp_layers", "unimix"),
            "world_model": {
                **pick(wm, "discrete_size", "stochastic_size", "decoupled_rssm"),
                "encoder": pick(wm["encoder"], "cnn_channels_multiplier", "mlp_layers", "dense_units"),
                "recurrent_model": pick(wm["recurrent_model"], "recurrent_state_size", "dense_units"),
                "transition_model": pick(wm["transition_model"], "hidden_size"),
                "representation_model": pick(wm["representation_model"], "hidden_size"),
            },
            "actor": pick(actor, "dense_units", "mlp_layers", "init_std", "min_std", "max_std", "action_clip", "cls"),
        },
        "distribution": pick(cfg["distribution"], "type"),
        "env": pick(cfg["env"], "screen_size"),
        "precision": precision,
    }


def export_random(output_path: str, *, name: Optional[str] = None, seed: int = 0, precision: str = "bf16-mixed") -> str:
    """Write a DreamerV3-S / MsPacman artifact (64x64x3 uint8 ``rgb``,
    ``Discrete(9)``) with weights from the seeded initialiser. The weights
    are made on the host, so one seed gives one artifact on every machine."""
    cfg = dreamer_v3_s_ms_pacman_config(precision)
    obs_space = DictSpace({"rgb": Box((64, 64, 3), "uint8", 0.0, 255.0)})
    action_space = Discrete(9)
    agent = build_agent((9,), False, dotdict(cfg), obs_space, precision=precision, device="cpu", seed=seed)
    spec = {
        "name": str(name or f"dreamer_v3_random_{seed}"),
        "algo": "dreamer_v3",
        "stateful": True,
        "policy_step": 0,
        "source_checkpoint": f"random init, seed {int(seed)}",
        "env_id": "MsPacmanNoFrameskip-v4",
        "observation_space": obs_space.to_spec(),
        "action_space": action_space.to_spec(),
        "config": cfg,
    }
    params = {"world_model": agent.world_model.state_dict(), "actor": agent.actor.state_dict()}
    return write_artifact(output_path, params, spec)
