"""Tensor math shared across algorithms (the part of sheeprl_tpu/utils/ops.py the port needs)."""

from __future__ import annotations

import torch


def symlog(x: torch.Tensor) -> torch.Tensor:
    """sign(x) * log(1 + |x|)."""
    return torch.sign(x) * torch.log1p(torch.abs(x))
