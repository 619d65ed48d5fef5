"""DreamerV3 policy adapter: stateful sessions (counterpart of
sheeprl_tpu/algos/dreamer_v3/serve.py).

Each session holds ``{player: {recurrent_state, stochastic_state, actions},
generator}``: the player state from ``init_player_state(1)`` and a CPU
``torch.Generator`` seeded from the session's first request. A request
advances its session by one ``player_step``. Sessions batch by stacking
their rows on the leading axis; each row draws its samples from its own
generator, so a row's actions do not depend on which sessions shared its
batch.

:func:`export_random` writes a DreamerV3-S / MsPacman artifact
(``exp=dreamer_v3_100k_ms_pacman``) from the port's seeded initialiser.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
from sheeprl_tpu_torch.algos.dreamer_v3.utils import normalize_player_obs
from sheeprl_tpu_torch.algos.ppo.agent import actions_metadata
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
        obs_t = normalize_player_obs({k: torch.from_numpy(v).to(self.device) for k, v in obs.items()}, self.cnn_keys)
        rng = RowGenerators(state["generators"], self.device)
        _, real_actions, player = self.agent.player_step(state["player"], obs_t, rng, greedy=greedy)
        return real_actions.cpu().numpy(), {"player": player, "generators": state["generators"]}


def dreamer_v3_s_ms_pacman_config(precision: str = "bf16-mixed") -> Dict[str, Any]:
    """The config subtree the adapter reads, as ``exp=dreamer_v3_100k_ms_pacman``
    composes it (algo=dreamer_v3_S: 512 units, 2 layers, recurrent 512, CNN
    multiplier 32; 64x64 rgb; LayerNorm eps 1e-3; 1% unimix; bf16-mixed)."""
    ln = {"cls": "layer_norm", "kw": {"eps": 1e-3}}
    return {
        "algo": {
            "name": "dreamer_v3",
            "cnn_keys": {"encoder": ["rgb"], "decoder": ["rgb"]},
            "mlp_keys": {"encoder": [], "decoder": []},
            "cnn_layer_norm": ln,
            "mlp_layer_norm": ln,
            "dense_units": 512,
            "mlp_layers": 2,
            "unimix": 0.01,
            "world_model": {
                "discrete_size": 32,
                "stochastic_size": 32,
                "decoupled_rssm": False,
                "encoder": {"cnn_channels_multiplier": 32, "mlp_layers": 2, "dense_units": 512},
                "recurrent_model": {"recurrent_state_size": 512, "dense_units": 512},
                "transition_model": {"hidden_size": 512},
                "representation_model": {"hidden_size": 512},
            },
            "actor": {"dense_units": 512, "mlp_layers": 2, "init_std": 2.0, "min_std": 0.1, "max_std": 1.0, "action_clip": 1.0, "cls": "default"},
        },
        "distribution": {"type": "auto"},
        "env": {"screen_size": 64},
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
