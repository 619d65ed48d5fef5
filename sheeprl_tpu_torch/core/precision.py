"""Precision policies (counterpart of sheeprl_tpu/core/precision.py).

The same names: ``32-true``, ``bf16-mixed``, ``bf16-true`` and the aliases
``16-mixed`` and ``32``. Parameters are f32 unless bf16-true; activations
and products run in the compute dtype. LayerNorm statistics are always f32
(models.LayerNorm), so bf16-mixed means f32 parameters, bf16 compute and f32
LayerNorm statistics.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

_POLICIES = {
    "32-true": (torch.float32, torch.float32),
    "bf16-mixed": (torch.float32, torch.bfloat16),
    "bf16-true": (torch.bfloat16, torch.bfloat16),
    "16-mixed": (torch.float32, torch.bfloat16),
    "32": (torch.float32, torch.float32),
}


@dataclass(frozen=True)
class Precision:
    name: str
    param_dtype: torch.dtype
    compute_dtype: torch.dtype

    @property
    def is_mixed(self) -> bool:
        return self.param_dtype != self.compute_dtype


def resolve_precision(name: str) -> Precision:
    try:
        param, compute = _POLICIES[str(name)]
    except KeyError:
        raise ValueError(f"Unknown precision '{name}'. Valid: {sorted(_POLICIES)}") from None
    return Precision(str(name), param, compute)


def disable_tf32() -> None:
    """f32 products and convolutions in full f32 under every policy. cuDNN
    runs f32 convolutions in TF32 unless told otherwise, which would move
    32-true results in the third digit away from the reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
