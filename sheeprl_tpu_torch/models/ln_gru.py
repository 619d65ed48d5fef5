"""Fused LayerNorm-GRU cell step: the CUDA kernel's wrapper and its plain version.

Counterpart of ``sheeprl_tpu/models/pallas_gru.py`` (the TPU kernel
``_pallas_ln_gru``). :func:`ln_gru_forward` computes, for inp [B, D] (the
concatenation ``[h, x]``), W [D, 3H], b, scale, ln_bias [3H] and h [B, H]::

    z  = inp @ W + b                                      (f32 sum, returned in f32)
    zn = LayerNorm(z) * scale + ln_bias                   (whole 3H row, eps 1e-5)
    h' = u * tanh(r * zn[H:2H]) + (1 - u) * h,  r = sigmoid(zn[:H]), u = sigmoid(zn[2H:] - 1)

and returns ``(h' in h's dtype, z)``. On a CUDA tensor it launches the
hand-written kernel in ``csrc/ln_gru.cu`` (any B, D, H >= 1) or raises; on a
CPU tensor, and only there, it runs :func:`ln_gru_plain`, the same math in
plain torch.

:func:`ln_gru_backward` is the gradient of the elementwise tail (``_bwd`` in
the TPU module): from ``g = dL/dh'`` and the saved f32 ``z`` it returns
``(dz, dscale, dln_bias, dh_tail)``, through ``csrc/ln_gru_bwd.cu`` on a CUDA
tensor and :func:`ln_gru_backward_plain` on a CPU tensor. :class:`LNGRUFunction`
ties the two together for autograd; the three products of the backward
(``dinp = dz W^T``, ``dW = inp^T dz``, ``db = sum_b dz``) are f32
``torch.matmul``, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

LN_EPS = 1e-5  # models.LayerNorm default, as in the TPU kernel

# Tiling of csrc/ln_gru.cu's projection kernel: 32 lanes x VEC columns per
# block (VEC elements per 16-byte load when the row length allows, else 1),
# kTileB batch rows, D in groups of kGroupD rows.
_TILE_B = 8
_GROUP_D = 64
# Aim for this many projection blocks per SM so every SM streams W.
_BLOCKS_PER_SM = 2
_DTYPES = (torch.float32, torch.bfloat16)


def ln_gru_plain(
    inp: torch.Tensor, w: torch.Tensor, b: torch.Tensor, scale: torch.Tensor, ln_bias: torch.Tensor, h: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain torch: f32 product and statistics,
    gates in f32, h' rounded to h's dtype once at the end."""
    z = torch.matmul(inp.float(), w.float()) + b.float()
    mu = z.mean(-1, keepdim=True)
    var = ((z - mu) ** 2).mean(-1, keepdim=True)
    zn = (z - mu) * torch.rsqrt(var + LN_EPS) * scale.float() + ln_bias.float()
    hidden = h.shape[-1]
    reset = torch.sigmoid(zn[..., :hidden])
    cand = torch.tanh(reset * zn[..., hidden : 2 * hidden])
    update = torch.sigmoid(zn[..., 2 * hidden :] - 1)
    return (update * cand + (1 - update) * h.float()).to(h.dtype), z


def split_plan(batch: int, depth: int, width: int, elem_bytes: int, sm_count: int) -> Tuple[int, int]:
    """(ksplit, depth_per_split) for the projection kernel: split D across
    blocks until the grid has about ``_BLOCKS_PER_SM`` blocks per SM, with
    whole row groups per split and no empty split."""
    vec = 16 // elem_bytes if width % (16 // elem_bytes) == 0 else 1
    blocks = math.ceil(width / (32 * vec)) * math.ceil(batch / _TILE_B)
    want = max(1, math.ceil(_BLOCKS_PER_SM * sm_count / blocks))
    ksplit = max(1, min(want, math.ceil(depth / _GROUP_D)))
    per = math.ceil(math.ceil(depth / ksplit) / _GROUP_D) * _GROUP_D
    return math.ceil(depth / per), per


def _check(inp, w, b, scale, ln_bias, h) -> None:
    tensors = {"inp": inp, "w": w, "b": b, "scale": scale, "ln_bias": ln_bias, "h": h}
    if inp.dim() != 2 or w.dim() != 2 or h.dim() != 2:
        raise ValueError(f"inp, w and h must be 2-D, got {tuple(inp.shape)}, {tuple(w.shape)}, {tuple(h.shape)}")
    batch, depth = inp.shape
    hidden = h.shape[1]
    if batch < 1 or depth < 1 or hidden < 1:
        raise ValueError(f"empty shapes are not supported: B={batch}, D={depth}, H={hidden}")
    want = {"w": (depth, 3 * hidden), "b": (3 * hidden,), "scale": (3 * hidden,), "ln_bias": (3 * hidden,), "h": (batch, hidden)}
    for name, shape in want.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(tensors[name].shape)}, expected {shape}")
    if inp.dtype not in _DTYPES or w.dtype != inp.dtype or h.dtype != inp.dtype:
        raise TypeError(f"inp, w and h must share one dtype of {_DTYPES}, got {inp.dtype}, {w.dtype}, {h.dtype}")
    for name in ("b", "scale", "ln_bias"):
        if tensors[name].dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {tensors[name].dtype}")
    for name, t in tensors.items():
        if t.device != inp.device:
            raise ValueError(f"{name} is on {t.device}, inp on {inp.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    from sheeprl_tpu_torch import kernels

    lib = kernels.load("ln_gru")
    fns = {torch.float32: lib.ln_gru_forward_f32, torch.bfloat16: lib.ln_gru_forward_bf16}
    for fn in fns.values():
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fns


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def ln_gru_forward(
    inp: torch.Tensor, w: torch.Tensor, b: torch.Tensor, scale: torch.Tensor, ln_bias: torch.Tensor, h: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LN-GRU step -> (h' [B, H] in h's dtype, z [B, 3H] f32). Launches
    the CUDA kernel for CUDA tensors, runs :func:`ln_gru_plain` for CPU
    tensors, raises for anything else. ``ln_gru_forward.launches`` counts
    kernel launches."""
    _check(inp, w, b, scale, ln_bias, h)
    if inp.device.type == "cpu":
        return ln_gru_plain(inp, w, b, scale, ln_bias, h)
    if inp.device.type != "cuda":
        raise ValueError(f"ln_gru_forward runs on CUDA or CPU tensors, got {inp.device}")
    batch, depth = inp.shape
    hidden = h.shape[1]
    device_index = inp.device.index if inp.device.index is not None else torch.cuda.current_device()
    ksplit, per = split_plan(batch, depth, 3 * hidden, inp.element_size(), _sm_count(device_index))
    h_out = torch.empty_like(h)
    z = torch.empty((batch, 3 * hidden), dtype=torch.float32, device=inp.device)
    partial = torch.empty((ksplit, batch, 3 * hidden), dtype=torch.float32, device=inp.device)
    stream = torch.cuda.current_stream(inp.device).cuda_stream
    err = _kernel_fns()[inp.dtype](
        inp.data_ptr(), w.data_ptr(), b.data_ptr(), scale.data_ptr(), ln_bias.data_ptr(), h.data_ptr(),
        h_out.data_ptr(), z.data_ptr(), partial.data_ptr(),
        batch, depth, hidden, per, ksplit, device_index, stream,
    )  # fmt: skip
    if err != 0:
        raise RuntimeError(f"ln_gru kernel launch failed with CUDA error {err} (B={batch}, D={depth}, H={hidden})")
    ln_gru_forward.launches += 1
    return h_out, z


ln_gru_forward.launches = 0


def ln_gru_backward_plain(
    g: torch.Tensor, z: torch.Tensor, scale: torch.Tensor, ln_bias: torch.Tensor, h: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's function in plain torch: the VJP of the tail
    ``z -> h'`` of :func:`ln_gru_plain`, written out. Returns (dz [B, 3H] f32,
    dscale [3H] f32, dln_bias [3H] f32, dh_tail [B, H] in h's dtype)."""
    hidden = h.shape[-1]
    mu = z.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((z - mu) ** 2).mean(-1, keepdim=True) + LN_EPS)
    xhat = (z - mu) * rstd
    y = xhat * scale + ln_bias
    y_r, y_c, y_u = y[:, :hidden], y[:, hidden : 2 * hidden], y[:, 2 * hidden :]
    r = torch.sigmoid(y_r)
    c = torch.tanh(r * y_c)
    u = torch.sigmoid(y_u - 1)
    gf = g.float()
    dpre = gf * u * (1 - c * c)
    dy = torch.cat([dpre * y_c * r * (1 - r), dpre * r, gf * (c - h.float()) * u * (1 - u)], dim=-1)
    dxhat = dy * scale
    dz = rstd * (dxhat - dxhat.mean(-1, keepdim=True) - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    return dz, (dy * xhat).sum(0), dy.sum(0), (gf * (1 - u)).to(h.dtype)


def _check_backward(g, z, scale, ln_bias, h) -> None:
    tensors = {"g": g, "z": z, "scale": scale, "ln_bias": ln_bias, "h": h}
    if g.dim() != 2 or h.dim() != 2:
        raise ValueError(f"g and h must be 2-D, got {tuple(g.shape)}, {tuple(h.shape)}")
    batch, hidden = h.shape
    if batch < 1 or hidden < 1:
        raise ValueError(f"empty shapes are not supported: B={batch}, H={hidden}")
    want = {"g": (batch, hidden), "z": (batch, 3 * hidden), "scale": (3 * hidden,), "ln_bias": (3 * hidden,)}
    for name, shape in want.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(tensors[name].shape)}, expected {shape}")
    if h.dtype not in _DTYPES or g.dtype != h.dtype:
        raise TypeError(f"g and h must share one dtype of {_DTYPES}, got {g.dtype}, {h.dtype}")
    for name in ("z", "scale", "ln_bias"):
        if tensors[name].dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {tensors[name].dtype}")
    for name, t in tensors.items():
        if t.device != h.device:
            raise ValueError(f"{name} is on {t.device}, h on {h.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


_BWD_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _backward_fns():
    from sheeprl_tpu_torch import kernels

    lib = kernels.load("ln_gru_bwd")
    fns = {torch.float32: lib.ln_gru_backward_f32, torch.bfloat16: lib.ln_gru_backward_bf16}
    for fn in fns.values():
        fn.argtypes = _BWD_ARGTYPES
        fn.restype = ctypes.c_int
    return fns


def backward_rows(batch: int, sm_count: int) -> int:
    """Batch rows per block of the backward's row kernel: about one block
    per SM, so a large batch does not pay a per-block partial row each."""
    return max(1, math.ceil(batch / sm_count))


def ln_gru_backward(
    g: torch.Tensor, z: torch.Tensor, scale: torch.Tensor, ln_bias: torch.Tensor, h: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradient of the LN-GRU tail -> (dz, dscale, dln_bias, dh_tail).
    Launches the CUDA kernel for CUDA tensors, runs
    :func:`ln_gru_backward_plain` for CPU tensors, raises for anything else.
    ``ln_gru_backward.launches`` counts kernel launches."""
    _check_backward(g, z, scale, ln_bias, h)
    if h.device.type == "cpu":
        return ln_gru_backward_plain(g, z, scale, ln_bias, h)
    if h.device.type != "cuda":
        raise ValueError(f"ln_gru_backward runs on CUDA or CPU tensors, got {h.device}")
    batch, hidden = h.shape
    device_index = h.device.index if h.device.index is not None else torch.cuda.current_device()
    rows = backward_rows(batch, _sm_count(device_index))
    nblocks = math.ceil(batch / rows)
    dz = torch.empty_like(z)
    dh = torch.empty_like(h)
    dscale = torch.empty_like(scale)
    dln_bias = torch.empty_like(ln_bias)
    partial = torch.empty((2, nblocks, 3 * hidden), dtype=torch.float32, device=h.device)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    err = _backward_fns()[h.dtype](
        g.data_ptr(), z.data_ptr(), scale.data_ptr(), ln_bias.data_ptr(), h.data_ptr(),
        dz.data_ptr(), dh.data_ptr(), dscale.data_ptr(), dln_bias.data_ptr(), partial.data_ptr(),
        batch, hidden, rows, device_index, stream,
    )  # fmt: skip
    if err != 0:
        raise RuntimeError(f"ln_gru backward kernel launch failed with CUDA error {err} (B={batch}, H={hidden})")
    ln_gru_backward.launches += 1
    return dz, dscale, dln_bias, dh


ln_gru_backward.launches = 0


class LNGRUFunction(torch.autograd.Function):
    """One LN-GRU step with its gradient (``fused_ln_gru``'s custom VJP).

    Forward: :func:`ln_gru_forward`, saving inp, W, scale, ln_bias, h and the
    f32 z (no recompute in the backward). Backward: :func:`ln_gru_backward`
    for the tail, then ``dinp = dz W^T``, ``dW = inp^T dz`` and
    ``db = sum_b dz`` in f32, each cast back to its input's dtype; inputs
    that need no gradient get ``None``. Both halves launch their kernels on
    CUDA tensors and run the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, inp, w, b, scale, ln_bias, h):
        h_new, z = ln_gru_forward(inp, w, b, scale, ln_bias, h)
        ctx.save_for_backward(inp, w, scale, ln_bias, h, z)
        return h_new

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        inp, w, scale, ln_bias, h, z = ctx.saved_tensors
        dz, dscale, dln_bias, dh = ln_gru_backward(g.contiguous(), z, scale, ln_bias, h)
        need = ctx.needs_input_grad
        dinp = torch.matmul(dz, w.float().t()).to(inp.dtype) if need[0] else None
        dw = torch.matmul(inp.float().t(), dz).to(w.dtype) if need[1] else None
        db = dz.sum(0) if need[2] else None  # b is f32, as dz
        return dinp, dw, db, dscale if need[3] else None, dln_bias if need[4] else None, dh if need[5] else None
