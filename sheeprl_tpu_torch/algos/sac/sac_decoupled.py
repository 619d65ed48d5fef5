"""SAC with the player split from the trainer (counterpart of
sheeprl_tpu/algos/sac/sac_decoupled.py).

The JAX package keeps both in one process over a split of its devices
(:func:`sheeprl_tpu_torch.core.mesh.split_player_trainer`): here the player
is on the host CPU and the trainer has the card. The loop is SAC's
:func:`sheeprl_tpu_torch.algos.sac.sac.run_off_policy` with
:data:`SAC_DECOUPLED`: the player's actor is a CPU copy of the trainer's
that reads an actor :class:`ParamMirror` (through its
:class:`PlayerPlacement`), refreshed after every train call and following
``fabric.player_sync`` (``fresh`` waits for the newest weights at the next
env step, ``async`` plays the newest snapshot whose copy has landed,
sac_decoupled.py:198-213); the train call runs after the env step, not
inside it; ``Ratio`` counts the gradient steps over ``policy_step -
prefill x num_envs`` and the periodic checkpoints start at
``learning_starts``, as the JAX decoupled loop counts them. Checkpoints
hold SAC's fields and evaluate through SAC's evaluation. Run it on one card
with ``fabric.devices=1 fabric.player_device=host``; the on-mesh split,
several trainer cards and tensor parallelism are ROADMAP A9.

With ``fleet.replicas`` > 1 (or ``fleet.enabled``) the envs move into
supervised replica processes on the player's device
(:mod:`sheeprl_tpu_torch.core.fleet`, :mod:`.fleet_actor`): the same loop
takes one admitted shipment an iteration as its rows, trains only on an
iteration that got one, broadcasts the actor's weights every
``fleet.param_sync_every`` iterations, and drains the fleet before a
preemption's final save (sac_decoupled.py:90-125, :296-336, :380, :434-447,
:505-509 of the JAX package). Its checkpoints hold no envs.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from sheeprl_tpu_torch.algos.sac.agent import SACAgent, build_agent
from sheeprl_tpu_torch.algos.sac.sac import OffPolicyAlgo, SACTrainer, run_off_policy
from sheeprl_tpu_torch.core.device import resolve_device
from sheeprl_tpu_torch.core.mesh import split_player_trainer
from sheeprl_tpu_torch.registry import register_algorithm

Metrics = Dict[str, torch.Tensor]
SAC_DECOUPLED = OffPolicyAlgo("SAC", build_agent, SACTrainer, overlap_train=False, decoupled=True)
# What the player's actor reads of the agent's state.
PLAYER_STATE = SAC_DECOUPLED.player_state


@register_algorithm(decoupled=True)
def main(cfg, callback: Optional[Callable[[SACAgent, int, List[Metrics]], None]] = None) -> Dict[str, Any]:
    """Train decoupled SAC on ``cfg``: the device split checked, then
    :func:`run_off_policy` with :data:`SAC_DECOUPLED` (its callback, files,
    tags, checkpoints and returned dict)."""
    split_player_trainer(
        resolve_device(cfg.device), str(cfg.fabric.get("player_device") or "auto"), devices=int(cfg.fabric.devices),
        model_axis=int(cfg.fabric.get("model_axis", 1) or 1),
    )  # fmt: skip
    return run_off_policy(cfg, callback, SAC_DECOUPLED)
