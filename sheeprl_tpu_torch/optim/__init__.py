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

from typing import Any, Iterable, Mapping, Sequence

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


def build_optimizer(params: Iterable[torch.nn.Parameter], node: Mapping[str, Any]) -> torch.optim.Optimizer:
    """The optimizer an ``algo.*.optimizer`` config node names with its
    ``_target_`` (one of this module's), over ``params``."""
    from sheeprl_tpu_torch.config.instantiate import instantiate

    if not str(node.get("_target_")).startswith(f"{__name__}."):
        raise ValueError(f"{node['_target_']} is not an optimizer of {__name__}")
    return instantiate(node, params)


def load_optimizer_state(optimizer: torch.optim.Optimizer, saved: Mapping[str, Any]) -> None:
    """Load a saved ``state_dict`` into ``optimizer``, which keeps its own
    ``capturable``: a state saved on the CPU (a host step count) loads into a
    card's optimizer with its step count on the card, and the other way round."""
    saved = dict(saved)
    saved["param_groups"] = [{**g, "capturable": mine["capturable"]} for g, mine in zip(saved["param_groups"], optimizer.param_groups)]
    optimizer.load_state_dict(saved)
