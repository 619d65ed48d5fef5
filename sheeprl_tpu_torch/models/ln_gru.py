"""Fused LayerNorm-GRU cell step: the CUDA kernels' wrappers and their plain versions.

Counterpart of ``sheeprl_tpu/models/pallas_gru.py`` (the TPU kernel
``_pallas_ln_gru``). :func:`ln_gru_forward` computes, for inp [B, D] (the
concatenation ``[h, x]``), W [D, 3H], b, scale, ln_bias [3H] and h [B, H]::

    z  = inp @ W + b                                      (f32 sum, returned in f32)
    zn = LayerNorm(z) * scale + ln_bias                   (whole 3H row, eps 1e-5)
    h' = u * tanh(r * zn[H:2H]) + (1 - u) * h,  r = sigmoid(zn[:H]), u = sigmoid(zn[2H:] - 1)

and returns ``(h' in h's dtype, z)``. On a CUDA tensor it launches one of two
hand-written kernels, picked by the pure function :func:`forward_plan`: the
tensor-core kernel ``csrc/ln_gru_tc.cu`` (bf16 at large batch, the
imagination's B = 1024) or the streaming kernel ``csrc/ln_gru.cu`` (every
other shape: any B, D, H >= 1). On a CPU tensor, and only there, it runs
:func:`ln_gru_plain`, the same math in plain torch. Both kernels are also
exposed on their own (:func:`ln_gru_forward_tensor_core`,
:func:`ln_gru_forward_streaming`) so that they can be timed against each other.

:func:`ln_gru_backward` is the gradient of the elementwise tail (``_bwd`` in
the TPU module): from ``g = dL/dh'`` and the saved f32 ``z`` it returns
``(dz, dscale, dln_bias, dh_tail)``, through ``csrc/ln_gru_bwd.cu`` on a CUDA
tensor (one launch, laid out by :func:`backward_plan`) and
:func:`ln_gru_backward_plain` on a CPU tensor. :class:`LNGRUFunction` ties the
two together for autograd; the three products of the backward
(``dinp = dz W^T``, ``dW = inp^T dz``, ``db = sum_b dz``) are f32
``torch.matmul``, as the JAX package leaves them to XLA.

The kernels are ``ctypes`` launches that a dispatch mode cannot see, so each
launch reports its work to the telemetry's goodput count
(:func:`sheeprl_tpu_torch.telemetry.perf.add_kernel_work`) by
:func:`ln_gru_forward_work` and :func:`ln_gru_backward_work`: the FLOPs that
``torch.utils.flop_counter`` counts for the plain version (its one product,
``inp @ W``; the tail is elementwise and counts none) and the bytes of each
input read once and each output written once.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import math
from typing import Dict, List, Tuple

import torch
from torch.autograd.function import once_differentiable

from sheeprl_tpu_torch.telemetry.perf import add_kernel_work

LN_EPS = 1e-5  # models.LayerNorm default, as in the TPU kernel
SMEM_LIMIT = 232448  # shared memory one block may use on Hopper (227 KB)

# Tiling of csrc/ln_gru.cu, the streaming kernel: 32 lanes x VEC columns per
# block (VEC elements per 16-byte load when the row length allows, else 1),
# _TILE_B batch rows, D in groups of _GROUP_D rows, 256 threads.
_TILE_B = 8
_GROUP_D = 64
_STREAM_THREADS = 256
# Aim for this many streaming blocks per SM so every SM streams W, with at
# most _MAX_SPLIT splits of D (the splits of a column block form one cluster).
_BLOCKS_PER_SM = 2
_MAX_SPLIT = 16

# Tiling of csrc/ln_gru_tc.cu, the tensor-core kernel: a CTA owns TC_ROWS
# batch rows and TC_GATES gate indices (3 * TC_GATES columns of W and z); a
# cluster of H / TC_GATES CTAs covers one row tile's 3H columns.
TC_ROWS = 64
TC_GATES = 64
TC_TILE_K = 64
TC_STAGES = 3
TC_THREADS = 128  # one warpgroup
TC_MAX_CLUSTER = 8  # portable cluster size
TC_SMEM_BYTES = TC_STAGES * 4 * TC_ROWS * TC_TILE_K * 2 + 1024  # the ring (inp + 3 W strips a stage, bf16), aligned
TC_STATIC_SMEM_BYTES = (2 + 1 + 1) * TC_ROWS * 4  # row partials and statistics

# Batches from this size up (bf16, shapes the tile plan takes) run on the
# tensor cores. Set from both kernels timed by chip_smoke.py phase 3
# (`phase_threshold`) at DV3-S (D = 1024, H = 512) bf16 on an NVIDIA H100
# 80GB HBM3 (700 W), device microseconds per call:
#   B               16     64     128    256    1024
#   streaming       12.86  19.88  30.33  52.45  139.17
#   tensor cores    22.12  22.63  22.39  22.33  28.70
# The streaming kernel wins up to B = 64, the tensor cores from B = 128.
TENSOR_CORE_MIN_BATCH = 128

# Backward (csrc/ln_gru_bwd.cu): at least this many rows per block, at most
# this many threads, and the partial rows of dscale and dln_bias are summed
# over clusters of up to _BWD_CLUSTER blocks.
_BWD_MIN_ROWS = 1
_BWD_CLUSTER = 16
_BWD_MAX_THREADS = 256
_DTYPES = (torch.float32, torch.bfloat16)


def ln_gru_forward_work(batch: int, depth: int, hidden: int, elem_bytes: int) -> Tuple[int, int]:
    """(FLOPs, bytes) of one forward call: the product ``inp @ W`` as
    ``FlopCounterMode`` counts an ``mm`` (2 B D 3H); inp, W and h in the
    inputs' dtype, b, scale and ln_bias f32 read, h' and the f32 z written."""
    gates = 3 * hidden
    flops = 2 * batch * depth * gates
    nbytes = (batch * depth + depth * gates + 2 * batch * hidden) * elem_bytes + (3 * gates + batch * gates) * 4
    return flops, nbytes


def ln_gru_backward_work(batch: int, hidden: int, elem_bytes: int) -> Tuple[int, int]:
    """(FLOPs, bytes) of one backward call: no product (the plain version's
    tail is elementwise); g, h and dh_tail in h's dtype, z and dz f32, scale,
    ln_bias read and dscale, dln_bias written in f32."""
    gates = 3 * hidden
    return 0, 3 * batch * hidden * elem_bytes + (2 * batch * gates + 4 * gates) * 4


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
    """(ksplit, depth_per_split) for the streaming kernel: split D across
    blocks until the grid has at most ``_BLOCKS_PER_SM`` blocks per SM, with
    whole row groups per split, no empty split and at most ``_MAX_SPLIT``."""
    vec = 16 // elem_bytes if width % (16 // elem_bytes) == 0 else 1
    blocks = math.ceil(width / (32 * vec)) * math.ceil(batch / _TILE_B)
    want = max(1, _BLOCKS_PER_SM * sm_count // blocks)  # one wave: no second, partial one
    ksplit = max(1, min(want, math.ceil(depth / _GROUP_D), _MAX_SPLIT))
    per = math.ceil(math.ceil(depth / ksplit) / _GROUP_D) * _GROUP_D
    return math.ceil(depth / per), per


@dataclasses.dataclass(frozen=True)
class ForwardPlan:
    """How one forward call is laid out on the card.

    ``kernel`` is "tensor_core" (csrc/ln_gru_tc.cu) or "streaming"
    (csrc/ln_gru.cu). Grid x indexes column blocks, and the CTAs at grid x
    own the z columns :meth:`columns` gives. Tensor core: the gate indices
    ``x * gates ..`` and their three columns, a cluster of ``cluster`` CTAs
    along x covering 3H, the batch tile in grid y. Streaming: contiguous
    column blocks, the split of D in grid y (a cluster of ``cluster`` =
    ``ksplit`` CTAs), the batch tile in grid z. Batch tiles have
    ``row_tile`` rows. ``scratch_floats`` and ``tickets`` are what the
    wrapper allocates for the streaming kernel's row statistics and arrival
    tickets."""

    kernel: str
    grid: Tuple[int, int, int]
    threads: int
    cluster: int
    row_tile: int
    gates: int
    col_tile: int
    vec: int
    ksplit: int
    depth_per_split: int
    smem_bytes: int
    scratch_floats: int
    tickets: int

    def columns(self, x: int, hidden: int) -> List[int]:
        """The z columns the CTAs at grid x own, in the order they hold them."""
        if self.kernel == "tensor_core":
            return [s * hidden + x * self.gates + g for s in range(3) for g in range(self.gates)]
        return list(range(x * self.col_tile, min((x + 1) * self.col_tile, 3 * hidden)))

    def rows(self, tile: int, batch: int) -> range:
        """The batch rows of batch tile ``tile``."""
        return range(tile * self.row_tile, min((tile + 1) * self.row_tile, batch))


def tensor_core_fits(depth: int, hidden: int) -> bool:
    """Whether the tensor-core kernel's tile plan takes D and H: whole gate
    chunks, a cluster of at most 8, 16-byte rows of inp."""
    return hidden % TC_GATES == 0 and hidden // TC_GATES <= TC_MAX_CLUSTER and depth % 8 == 0


def tensor_core_plan(batch: int, depth: int, hidden: int) -> ForwardPlan:
    """The tensor-core kernel's plan; raises ValueError for shapes it does not take."""
    if batch < 1 or depth < 1 or not tensor_core_fits(depth, hidden):
        raise ValueError(f"the tensor-core LN-GRU kernel takes H % {TC_GATES} == 0, H <= {TC_GATES * TC_MAX_CLUSTER} "
                         f"and D % 8 == 0, got B={batch}, D={depth}, H={hidden}")  # fmt: skip
    cluster = hidden // TC_GATES
    return ForwardPlan(
        kernel="tensor_core",
        grid=(cluster, math.ceil(batch / TC_ROWS), 1),
        threads=TC_THREADS,
        cluster=cluster,
        row_tile=TC_ROWS,
        gates=TC_GATES,
        col_tile=3 * TC_GATES,
        vec=8,
        ksplit=1,
        depth_per_split=depth,
        smem_bytes=TC_SMEM_BYTES + TC_STATIC_SMEM_BYTES,
        scratch_floats=0,
        tickets=0,
    )


def streaming_plan(batch: int, depth: int, hidden: int, elem_bytes: int, sm_count: int, aligned: bool = True) -> ForwardPlan:
    """The streaming kernel's plan: any B, D, H >= 1. ``aligned`` is whether
    W starts on 16 bytes (else one element per load)."""
    width = 3 * hidden
    vec = 16 // elem_bytes if aligned and width % (16 // elem_bytes) == 0 else 1
    ksplit, per = split_plan(batch, depth, width, elem_bytes if vec > 1 else 16, sm_count)
    nx = math.ceil(width / (32 * vec))
    tiles = math.ceil(batch / _TILE_B)
    smem = 8 * _TILE_B * 32 * (vec + 1) * 4 + (_GROUP_D * _TILE_B + _TILE_B * 32 * vec + 2 * _TILE_B + 1) * 4
    return ForwardPlan(
        kernel="streaming",
        grid=(nx, ksplit, tiles),
        threads=_STREAM_THREADS,
        cluster=ksplit,
        row_tile=_TILE_B,
        gates=0,
        col_tile=32 * vec,
        vec=vec,
        ksplit=ksplit,
        depth_per_split=per,
        smem_bytes=smem,
        scratch_floats=2 * batch * nx,  # (sum, M2) per row and column block
        tickets=batch,  # one per row
    )


def forward_plan(batch: int, depth: int, hidden: int, dtype: torch.dtype, sm_count: int, aligned: bool = True) -> ForwardPlan:
    """Which kernel runs one forward call, and how: bf16 at batches of
    ``TENSOR_CORE_MIN_BATCH`` and up on shapes the tile plan takes goes to the
    tensor cores; every other call (f32, small batches, unaligned or wide H,
    inputs not on 16-byte boundaries) streams W."""
    if dtype == torch.bfloat16 and aligned and batch >= TENSOR_CORE_MIN_BATCH and tensor_core_fits(depth, hidden):
        return tensor_core_plan(batch, depth, hidden)
    return streaming_plan(batch, depth, hidden, 2 if dtype == torch.bfloat16 else 4, sm_count, aligned)


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


_STREAM_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_TC_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    from sheeprl_tpu_torch import kernels

    lib = kernels.load("ln_gru")
    fns = {torch.float32: lib.ln_gru_forward_f32, torch.bfloat16: lib.ln_gru_forward_bf16}
    for fn in fns.values():
        fn.argtypes = _STREAM_ARGTYPES
        fn.restype = ctypes.c_int
    return fns


@functools.lru_cache(maxsize=None)
def _tensor_core_fn():
    from sheeprl_tpu_torch import kernels

    fn = kernels.load("ln_gru_tc").ln_gru_forward_tc_bf16
    fn.argtypes = _TC_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


# Arrival tickets of the one-launch kernels, zero between calls (each call's
# last block resets what it used), one buffer per (device, stream, kernel):
# kernels on one stream do not overlap, so they can share it.
_TICKETS: Dict[Tuple[int, int, str], torch.Tensor] = {}


def _tickets(device: torch.device, stream: int, kind: str, count: int) -> torch.Tensor:
    key = (device.index, stream, kind)
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < count:
        buf = torch.zeros(max(count, 1024), dtype=torch.int32, device=device)
        _TICKETS[key] = buf
    return buf


def _device_index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None else torch.cuda.current_device()


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _launch(plan: ForwardPlan, inp, w, b, scale, ln_bias, h) -> Tuple[torch.Tensor, torch.Tensor]:
    batch, depth = inp.shape
    hidden = h.shape[1]
    device_index = _device_index(inp)
    h_out = torch.empty_like(h)
    z = torch.empty((batch, 3 * hidden), dtype=torch.float32, device=inp.device)
    stream = torch.cuda.current_stream(inp.device).cuda_stream
    if plan.kernel == "tensor_core":
        err = _tensor_core_fn()(
            inp.data_ptr(), w.data_ptr(), b.data_ptr(), scale.data_ptr(), ln_bias.data_ptr(), h.data_ptr(),
            h_out.data_ptr(), z.data_ptr(), batch, depth, hidden, plan.cluster, device_index, stream,
        )  # fmt: skip
        counter = ln_gru_forward_tensor_core
    else:
        scratch = torch.empty((plan.scratch_floats,), dtype=torch.float32, device=inp.device)
        tickets = _tickets(inp.device, stream, "forward", plan.tickets)
        err = _kernel_fns()[inp.dtype](
            inp.data_ptr(), w.data_ptr(), b.data_ptr(), scale.data_ptr(), ln_bias.data_ptr(), h.data_ptr(),
            h_out.data_ptr(), z.data_ptr(), scratch.data_ptr(), tickets.data_ptr(),
            batch, depth, hidden, plan.vec, plan.depth_per_split, plan.ksplit, device_index, stream,
        )  # fmt: skip
        counter = ln_gru_forward_streaming
    if err != 0:
        raise RuntimeError(f"ln_gru {plan.kernel} kernel launch failed with CUDA error {err} (B={batch}, D={depth}, H={hidden})")
    counter.launches += 1
    add_kernel_work(*ln_gru_forward_work(batch, depth, hidden, inp.element_size()))
    return h_out, z


def _on_cuda(name: str, inp: torch.Tensor) -> None:
    if inp.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, got {inp.device}")


def ln_gru_forward(
    inp: torch.Tensor, w: torch.Tensor, b: torch.Tensor, scale: torch.Tensor, ln_bias: torch.Tensor, h: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LN-GRU step -> (h' [B, H] in h's dtype, z [B, 3H] f32). Launches
    the kernel :func:`forward_plan` picks for CUDA tensors, runs
    :func:`ln_gru_plain` for CPU tensors, raises for anything else.
    ``ln_gru_forward.launches`` counts its kernel launches, and
    ``.launches_by_batch`` them by B (each kernel's launcher also counts its
    own)."""
    _check(inp, w, b, scale, ln_bias, h)
    if inp.device.type == "cpu":
        return ln_gru_plain(inp, w, b, scale, ln_bias, h)
    _on_cuda("ln_gru_forward", inp)
    batch, depth = inp.shape
    hidden = h.shape[1]
    plan = forward_plan(batch, depth, hidden, inp.dtype, _sm_count(_device_index(inp)), _aligned(inp, w, h))
    out = _launch(plan, inp, w, b, scale, ln_bias, h)
    ln_gru_forward.launches += 1
    ln_gru_forward.launches_by_batch[batch] += 1
    return out


def ln_gru_forward_tensor_core(
    inp: torch.Tensor, w: torch.Tensor, b: torch.Tensor, scale: torch.Tensor, ln_bias: torch.Tensor, h: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward on the tensor-core kernel at any batch (bf16, shapes
    :func:`tensor_core_fits` takes; raises otherwise). For CPU tensors, the
    plain version. ``.launches`` counts its kernel's launches."""
    _check(inp, w, b, scale, ln_bias, h)
    if inp.device.type == "cpu":
        return ln_gru_plain(inp, w, b, scale, ln_bias, h)
    _on_cuda("ln_gru_forward_tensor_core", inp)
    if inp.dtype != torch.bfloat16 or not _aligned(inp, w, h):
        raise TypeError(f"the tensor-core LN-GRU kernel takes bf16 inputs on 16-byte boundaries, got {inp.dtype}")
    return _launch(tensor_core_plan(inp.shape[0], inp.shape[1], h.shape[1]), inp, w, b, scale, ln_bias, h)


def ln_gru_forward_streaming(
    inp: torch.Tensor, w: torch.Tensor, b: torch.Tensor, scale: torch.Tensor, ln_bias: torch.Tensor, h: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward on the streaming kernel at any shape. For CPU tensors, the
    plain version. ``.launches`` counts its kernel's launches."""
    _check(inp, w, b, scale, ln_bias, h)
    if inp.device.type == "cpu":
        return ln_gru_plain(inp, w, b, scale, ln_bias, h)
    _on_cuda("ln_gru_forward_streaming", inp)
    batch, depth = inp.shape
    plan = streaming_plan(batch, depth, h.shape[1], inp.element_size(), _sm_count(_device_index(inp)), _aligned(w))
    return _launch(plan, inp, w, b, scale, ln_bias, h)


ln_gru_forward.launches = 0
ln_gru_forward.launches_by_batch = collections.Counter()
ln_gru_forward_tensor_core.launches = 0
ln_gru_forward_streaming.launches = 0


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


_BWD_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _backward_fns():
    from sheeprl_tpu_torch import kernels

    lib = kernels.load("ln_gru_bwd")
    fns = {torch.float32: lib.ln_gru_backward_f32, torch.bfloat16: lib.ln_gru_backward_bf16}
    for fn in fns.values():
        fn.argtypes = _BWD_ARGTYPES
        fn.restype = ctypes.c_int
    return fns


@dataclasses.dataclass(frozen=True)
class BackwardPlan:
    """How one backward call is laid out: ``blocks`` blocks (a multiple of
    ``cluster``; the last ones may have no rows) of ``threads`` threads take
    ``rows`` consecutive batch rows each. Their partial rows of dscale and
    dln_bias are summed over each cluster of ``cluster`` blocks, then over
    the ``clusters`` clusters. ``scratch_floats`` and ``tickets`` are what
    the wrapper allocates."""

    rows: int
    blocks: int
    threads: int
    cluster: int
    clusters: int
    scratch_floats: int
    tickets: int


def backward_plan(batch: int, hidden: int, sm_count: int) -> BackwardPlan:
    """About one block per SM, so a large batch does not pay a partial row
    per row; threads own whole gate indices (up to four each in registers);
    clusters of up to 16 blocks."""
    rows = max(_BWD_MIN_ROWS, math.ceil(batch / sm_count))
    used = math.ceil(batch / rows)
    cluster = min(_BWD_CLUSTER, used)
    clusters = math.ceil(used / cluster)
    threads = min(_BWD_MAX_THREADS, math.ceil(hidden / 32) * 32)
    blocks = clusters * cluster
    return BackwardPlan(rows, blocks, threads, cluster, clusters, (blocks + clusters) * 2 * 3 * hidden, cluster)


def ln_gru_backward(
    g: torch.Tensor, z: torch.Tensor, scale: torch.Tensor, ln_bias: torch.Tensor, h: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradient of the LN-GRU tail -> (dz, dscale, dln_bias, dh_tail).
    Launches the CUDA kernel for CUDA tensors, runs
    :func:`ln_gru_backward_plain` for CPU tensors, raises for anything else.
    ``ln_gru_backward.launches`` counts kernel launches, and
    ``.launches_by_batch`` them by B."""
    _check_backward(g, z, scale, ln_bias, h)
    if h.device.type == "cpu":
        return ln_gru_backward_plain(g, z, scale, ln_bias, h)
    _on_cuda("ln_gru_backward", h)
    batch, hidden = h.shape
    device_index = _device_index(h)
    plan = backward_plan(batch, hidden, _sm_count(device_index))
    dz = torch.empty_like(z)
    dh = torch.empty_like(h)
    out = torch.empty((2, 3 * hidden), dtype=torch.float32, device=h.device)  # dscale, dln_bias
    scratch = torch.empty((plan.scratch_floats,), dtype=torch.float32, device=h.device)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    tickets = _tickets(h.device, stream, "backward", plan.tickets)
    err = _backward_fns()[h.dtype](
        g.data_ptr(), z.data_ptr(), scale.data_ptr(), ln_bias.data_ptr(), h.data_ptr(),
        dz.data_ptr(), dh.data_ptr(), out.data_ptr(), scratch.data_ptr(), tickets.data_ptr(),
        batch, hidden, plan.rows, plan.threads, plan.blocks, plan.cluster, device_index, stream,
    )  # fmt: skip
    if err != 0:
        raise RuntimeError(f"ln_gru backward kernel launch failed with CUDA error {err} (B={batch}, H={hidden})")
    add_kernel_work(*ln_gru_backward_work(batch, hidden, h.element_size()))
    ln_gru_backward.launches += 1
    ln_gru_backward.launches_by_batch[batch] += 1
    return dz, out[0], out[1], dh


ln_gru_backward.launches = 0
ln_gru_backward.launches_by_batch = collections.Counter()


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
