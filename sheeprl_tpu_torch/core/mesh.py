"""The decoupled trainers' split of the devices into the player's and the
trainer's (counterpart of ``split_player_trainer`` in
sheeprl_tpu/core/mesh.py:71-128; the port has no mesh of its own).

A host player (``fabric.player_device=host``) runs on the CPU and leaves the card to the trainer: the decoupled trainers
then run on one card. The on-mesh split (device 0 plays, the rest train), a
trainer over more than one card and ``fabric.model_axis`` > 1 need
``torch.distributed`` (ROADMAP A9) and raise.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sheeprl_tpu_torch.core.player import resolve_player_device

ONE_DEVICE_MESSAGE = (
    "The decoupled on-mesh split needs at least 2 data rows (one player + at least one trainer row); run with "
    "fabric.devices>=2, or put the player on the host with fabric.player_device=host to train on every device."
)


def split_player_trainer(device: torch.device, player_mode: str = "mesh", *, devices: int = 1, model_axis: int = 1) -> Tuple[torch.device, torch.device]:
    """(the player's device, the trainer's) for ``fabric.player_device`` =
    ``player_mode`` beside a trainer on ``device`` with ``fabric.devices`` =
    ``devices`` and ``fabric.model_axis`` = ``model_axis``. ``auto`` puts
    the player on the mesh, as ``mesh`` does."""
    if int(model_axis) > 1:
        raise NotImplementedError(f"fabric.model_axis={model_axis}: tensor parallelism over the trainer's cards is ROADMAP A9 (torch.distributed)")
    device = torch.device(device)
    player = resolve_player_device(player_mode, device)
    if str(player_mode).lower() == "host":
        if int(devices) > 1:
            raise NotImplementedError(f"fabric.devices={devices}: a decoupled trainer over more than one card is ROADMAP A9 (torch.distributed)")
        return player, device
    if int(devices) < 2:
        raise RuntimeError(ONE_DEVICE_MESSAGE)
    raise NotImplementedError(
        f"fabric.devices={devices} with the player on the mesh: the on-mesh decoupled split is ROADMAP A9 (torch.distributed); "
        "run with fabric.devices=1 fabric.player_device=host"
    )


def check_no_fleet(cfg) -> None:
    """The actor fleet (``fleet.replicas`` > 1, or ``fleet.enabled``) is the
    JAX package's supervised replica processes (``core/fleet.py``): ROADMAP
    A10 (fleet), the slice after the resilience layer."""
    fleet = cfg.get("fleet") or {}
    enabled = fleet.get("enabled", None)
    if (int(fleet.get("replicas", 1) or 1) > 1) if enabled is None else bool(enabled):
        raise NotImplementedError(
            "the actor fleet (fleet.replicas > 1 or fleet.enabled) is not ported: it is ROADMAP A10 (fleet), the next slice after the resilience layer"
        )
