"""Optimizers with the JAX package's hyperparameter names (counterpart of
sheeprl_tpu/optim/__init__.py and sheeprl_tpu/optim/rmsprop_tf.py).

- ``adam`` is ``torch.optim.Adam``: the update is ``lr * m_hat /
  (sqrt(v_hat) + eps)`` and weight decay is folded into the gradient before
  the moments, as in the JAX package's ``adam`` (optax
  ``add_decayed_weights`` then ``scale_by_adam``).
- ``adamw`` is ``torch.optim.AdamW``: decoupled decay, ``p -= lr * (adam
  update + weight_decay * p)``, as ``optax.adamw``.
- ``sgd`` is ``torch.optim.SGD`` without dampening (the JAX package drops
  it): weight decay folded into the gradient, then optax's ``trace``
  (torch's momentum buffer), then ``-lr``.
- ``rmsprop`` and ``rmsprop_tf`` are :class:`RMSprop`, the port's own: the
  JAX package's ``rmsprop`` is ``optax.rmsprop``, whose update is ``g /
  sqrt(nu + eps)`` with eps inside the root, where ``torch.optim.RMSprop``
  computes ``g / (sqrt(nu) + eps)``; ``rmsprop_tf`` also starts its
  accumulator at one.

Global-norm clipping, which the JAX package chains in front
(``dreamer_v3.py:_make_optimizer``), is ``clip_grad_norm_`` in the train
step.

On CUDA parameters Adam and AdamW are ``capturable``: their
step count lives on the card beside the moments, so an update reads nothing
from the host and can be captured in a CUDA graph (``core/graphs.py``); the
eager step is built the same way, so eager and captured steps do the same
arithmetic. CPU parameters keep the default (a host step count). SGD and
:class:`RMSprop` keep no step count and take no ``capturable``: their state
is tensors beside the parameters on either device.
"""

from __future__ import annotations

from typing import Any, Iterable, List, Mapping, Sequence

import torch


def _capturable(params: List[torch.nn.Parameter]) -> bool:
    return any(p.device.type == "cuda" for p in params)


def adam(
    params: Iterable[torch.nn.Parameter],
    lr: float = 2e-4,
    eps: float = 1e-4,
    weight_decay: float = 0.0,
    betas: Sequence[float] = (0.9, 0.999),
) -> torch.optim.Adam:
    params = list(params)
    return torch.optim.Adam(
        params, lr=float(lr), betas=(float(betas[0]), float(betas[1])), eps=float(eps), weight_decay=float(weight_decay),
        capturable=_capturable(params),
    )  # fmt: skip


def adamw(
    params: Iterable[torch.nn.Parameter],
    lr: float = 2e-4,
    eps: float = 1e-8,
    weight_decay: float = 1e-2,
    betas: Sequence[float] = (0.9, 0.999),
) -> torch.optim.AdamW:
    params = list(params)
    return torch.optim.AdamW(
        params, lr=float(lr), betas=(float(betas[0]), float(betas[1])), eps=float(eps), weight_decay=float(weight_decay),
        capturable=_capturable(params),
    )  # fmt: skip


def sgd(
    params: Iterable[torch.nn.Parameter],
    lr: float = 2e-4,
    momentum: float = 0.0,
    weight_decay: float = 0.0,
    nesterov: bool = False,
    dampening: float = 0.0,
) -> torch.optim.SGD:
    del dampening  # the JAX package's sgd takes it for torch's names and drops it
    momentum = float(momentum or 0.0)
    return torch.optim.SGD(params, lr=float(lr), momentum=momentum, weight_decay=float(weight_decay), nesterov=bool(nesterov) and momentum > 0)


class RMSprop(torch.optim.Optimizer):
    """optax's RMSprop, per parameter:

    - ``g = grad + weight_decay * p``;
    - ``square_avg = alpha * square_avg + (1 - alpha) * g**2``, from
      ``initial_scale`` (optax's 0; 1 for ``rmsprop_tf``);
    - ``u = g / sqrt(square_avg + eps)``, or with ``centered``
      ``g / sqrt(square_avg - grad_avg**2 + eps)`` where ``grad_avg`` is the
      same average of ``g``;
    - without momentum ``p -= lr * u``. With ``momentum`` > 0 a trace: for
      ``optax.rmsprop`` it follows the learning rate's scaling,
      ``momentum_buffer = momentum * momentum_buffer - lr * u`` and ``p +=
      momentum_buffer`` (``lr_in_momentum``); for ``rmsprop_tf`` it precedes
      it, ``momentum_buffer = momentum * momentum_buffer + u`` and ``p -= lr
      * momentum_buffer``. The two differ once the learning rate changes.
    """

    def __init__(
        self,
        params: Iterable[torch.nn.Parameter],
        lr: float,
        alpha: float,
        eps: float,
        weight_decay: float = 0.0,
        momentum: float = 0.0,
        centered: bool = False,
        initial_scale: float = 0.0,
        lr_in_momentum: bool = True,
    ):
        defaults = dict(
            lr=float(lr), alpha=float(alpha), eps=float(eps), weight_decay=float(weight_decay or 0.0), momentum=float(momentum or 0.0),
            centered=bool(centered), initial_scale=float(initial_scale), lr_in_momentum=bool(lr_in_momentum),
        )  # fmt: skip
        super().__init__(params, defaults)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            lr, alpha, eps, momentum = group["lr"], group["alpha"], group["eps"], group["momentum"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad if group["weight_decay"] == 0 else p.grad + group["weight_decay"] * p
                state = self.state[p]
                if not state:
                    state["square_avg"] = torch.full_like(p, group["initial_scale"], memory_format=torch.preserve_format)
                    if group["centered"]:
                        state["grad_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                    if momentum > 0:
                        state["momentum_buffer"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                square_avg = state["square_avg"].mul_(alpha).addcmul_(g, g, value=1 - alpha)
                if group["centered"]:
                    grad_avg = state["grad_avg"].mul_(alpha).add_(g, alpha=1 - alpha)
                    denom = square_avg.addcmul(grad_avg, grad_avg, value=-1).add_(eps).sqrt_()
                else:
                    denom = (square_avg + eps).sqrt_()
                u = g / denom
                if momentum <= 0:
                    p.add_(u, alpha=-lr)
                elif group["lr_in_momentum"]:
                    p.add_(state["momentum_buffer"].mul_(momentum).add_(u, alpha=-lr))
                else:
                    p.add_(state["momentum_buffer"].mul_(momentum).add_(u), alpha=-lr)
        return loss


def rmsprop(
    params: Iterable[torch.nn.Parameter],
    lr: float = 7e-4,
    alpha: float = 0.99,
    eps: float = 1e-5,
    weight_decay: float = 0.0,
    momentum: float = 0.0,
    centered: bool = False,
) -> RMSprop:
    return RMSprop(params, lr, alpha, eps, weight_decay, momentum, centered)


def rmsprop_tf(
    params: Iterable[torch.nn.Parameter],
    lr: float = 7e-4,
    alpha: float = 0.99,
    eps: float = 1e-5,
    weight_decay: float = 0.0,
    momentum: float = 0.0,
    centered: bool = False,
) -> RMSprop:
    """TF's RMSprop (the reference's ``RMSpropTF``): the accumulator starts at one."""
    return RMSprop(params, lr, alpha, eps, weight_decay, momentum, centered, initial_scale=1.0, lr_in_momentum=False)


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
    saved["param_groups"] = [
        {**g, **({"capturable": mine["capturable"]} if "capturable" in mine else {})} for g, mine in zip(saved["param_groups"], optimizer.param_groups)
    ]
    optimizer.load_state_dict(saved)
