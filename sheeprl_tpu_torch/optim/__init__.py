"""Optimizers with the JAX package's hyperparameter names (counterpart of
sheeprl_tpu/optim/__init__.py).

``adam`` is ``torch.optim.Adam``: the update is ``lr * m_hat / (sqrt(v_hat) +
eps)`` and weight decay is folded into the gradient before the moments, as in
the JAX package's ``adam`` (optax ``add_decayed_weights`` then
``scale_by_adam``). Global-norm clipping, which the JAX package chains in
front (``dreamer_v3.py:_make_optimizer``), is ``clip_grad_norm_`` in the
train step.

On CUDA parameters the optimizer is ``capturable``: its step count lives on
the card beside the moments, so an update reads nothing from the host and
can be captured in a CUDA graph (``core/graphs.py``). The eager step is built
the same way, so eager and captured steps do the same arithmetic. CPU
parameters keep the default (a host step count).
"""

from __future__ import annotations

from typing import Iterable, Sequence

import torch


def adam(
    params: Iterable[torch.nn.Parameter],
    lr: float = 2e-4,
    eps: float = 1e-4,
    weight_decay: float = 0.0,
    betas: Sequence[float] = (0.9, 0.999),
) -> torch.optim.Adam:
    params = list(params)
    capturable = any(p.device.type == "cuda" for p in params)
    return torch.optim.Adam(
        params, lr=float(lr), betas=(float(betas[0]), float(betas[1])), eps=float(eps), weight_decay=float(weight_decay),
        capturable=capturable,
    )  # fmt: skip
