"""The data axis over ``torch.distributed`` and the decoupled trainers' split
of the devices (counterpart of sheeprl_tpu/core/mesh.py).

The JAX package puts every device of one process on a ``(data, model)``
mesh: the batch is sharded over ``data`` (``P(None, DATA_AXIS)`` for a
time-major ``[T, B]`` batch), the params are replicated, and XLA inserts
the gradient's all-reduce. The port runs one process per rank, joined by a
process group (NCCL on the cards, gloo on the CPU; ``core/runtime.py``):

- :func:`shard_batch`: rank 0's batch reaches every rank, which keeps its
  rows along the axis the JAX step shards (rank r the r-th block of
  ``B / N`` rows); :func:`broadcast_tree` sends it whole (PPO's rollout);
- :func:`replicate` (:func:`replicate_training`): rank 0's tensors
  (params, optimizer states, moments, a generator's state) copied into
  every rank's, at start and after a resume;
- :func:`all_mean_grads`: the gradient of the global mean loss, one
  ``all_reduce`` of a flat bucket per dtype divided by N, between
  ``backward`` and the clip, so a global-norm clip sees the global gradient
  as optax's does;
- :func:`all_gather` (rank order), :func:`all_mean`, :func:`global_mean`,
  :func:`global_mean_std` and :func:`broadcast_object`;
- :func:`tensor_leaves` and :func:`optimizer_leaves`: the tensors of a
  nested dict (P2E-DV3's moments) and the optimizers of one (its
  exploration critics' Adams), for :func:`replicate_training`.

Every helper is built on ``broadcast``, ``all_reduce`` and ``all_gather``,
which both NCCL and gloo take for CUDA tensors on the card's torch; none
uses ``scatter`` or ``reduce_scatter``. On a :class:`DataAxis` with no
process group (one process, ``fabric.devices=1``) each helper returns its
input and moves nothing. With the NCCL backend a tensor that lies on the
CPU (a generator's state, Adam's step count) crosses through the rank's
card.

The model axis (``fabric.model_axis`` > 1), the on-mesh decoupled split and
a trainer over more than one card in the decoupled trainers raise (ROADMAP
A9). A host player (``fabric.player_device=host``) runs on the CPU and
leaves the card to the trainer: the decoupled trainers then run on one
card.
"""

from __future__ import annotations

import contextlib
import pickle
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from sheeprl_tpu_torch.core.player import resolve_player_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
# The axis vocabulary, in mesh order (sheeprl_tpu/core/mesh.py:30-36).
AXIS_NAMES = (DATA_AXIS, MODEL_AXIS)

ONE_DEVICE_MESSAGE = (
    "The decoupled on-mesh split needs at least 2 data rows (one player + at least one trainer row); run with "
    "fabric.devices>=2, or put the player on the host with fabric.player_device=host to train on every device."
)


@dataclass(frozen=True)
class DataAxis:
    """The ``data`` axis as one rank sees it: its ``size`` (the ranks),
    this rank's ``index`` on it, whether a process group joins the ranks
    (``joined``: the collectives run only then) and the ``device`` the
    backend takes tensors on (the rank's card for NCCL, else None: where
    the tensor lies)."""

    size: int = 1
    index: int = 0
    joined: bool = False
    device: Optional[torch.device] = None

    def rows(self, n: int) -> slice:
        """This rank's block of ``n`` rows (``n`` divisible by the size)."""
        per = local_batch_size(n, self.size)
        return slice(self.index * per, (self.index + 1) * per)


SINGLE = DataAxis()


def _nearest(n: int, size: int) -> str:
    lo = (n // size) * size
    hi = lo + size
    return str(hi) if lo == 0 else f"{lo} or {hi}"


def local_batch_size(global_batch: int, size: int, dim: int = 0) -> int:
    """A rank's rows of a batch of ``global_batch`` over a ``data`` axis of
    ``size`` ranks; raises naming the axis and the nearest valid batch when
    it does not divide (sheeprl_tpu/core/mesh.py:163-195, :381-385)."""
    n, size = int(global_batch), int(size)
    if size > 1 and n % size != 0:
        raise ValueError(
            f"shard_batch: batch dim {dim} of size {n} is not divisible by the `{DATA_AXIS}` mesh axis (size {size}); "
            f"nearest valid batch size: {_nearest(n, size)}."
        )
    return n // size


def _dist():
    import torch.distributed as dist

    return dist


@contextlib.contextmanager
def _through(tensors: Sequence[torch.Tensor], axis: DataAxis):
    """Flat buckets of ``tensors`` (one a dtype) on the backend's device;
    on leaving, each bucket's contents are copied back into the tensors.
    Yields the buckets."""
    groups: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    buckets = []
    for group in groups.values():
        device = axis.device if axis.device is not None else group[0].device
        buckets.append((group, torch.cat([t.detach().reshape(-1).to(device) for t in group])))
    yield [b for _, b in buckets]
    for group, flat in buckets:
        offset = 0
        for t in group:
            n = t.numel()
            t.detach().copy_(flat[offset : offset + n].view(t.shape))
            offset += n


def broadcast_object(obj: Any, axis: DataAxis) -> Any:
    """Rank 0's picklable ``obj`` on every rank (one ``broadcast`` of its
    length, one of its bytes)."""
    if not axis.joined:
        return obj
    dist = _dist()
    device = axis.device if axis.device is not None else torch.device("cpu")
    payload = pickle.dumps(obj) if axis.index == 0 else b""
    size = torch.tensor([len(payload)], dtype=torch.int64, device=device)
    dist.broadcast(size, 0)
    data = torch.zeros(int(size.item()), dtype=torch.uint8, device=device)
    if axis.index == 0:
        data.copy_(torch.frombuffer(bytearray(payload), dtype=torch.uint8))
    dist.broadcast(data, 0)
    return obj if axis.index == 0 else pickle.loads(data.cpu().numpy().tobytes())


def replicate(tensors: Iterable[torch.Tensor], axis: DataAxis) -> None:
    """Rank 0's values written into every rank's ``tensors`` in place (one
    ``broadcast`` a dtype); every rank passes the same list, by shape and
    dtype."""
    tensors = [t for t in tensors if t.numel() > 0]
    if not axis.joined or not tensors:
        return
    dist = _dist()
    with _through(tensors, axis) as buckets:
        for flat in buckets:
            dist.broadcast(flat, 0)


def replicate_generator(generator: torch.Generator, axis: DataAxis) -> None:
    """Rank 0's generator state in every rank's ``generator``."""
    if not axis.joined:
        return
    state = generator.get_state()
    replicate([state], axis)
    generator.set_state(state)


def replicate_training(axis: DataAxis, modules: Iterable[torch.nn.Module], optimizers: Iterable[torch.optim.Optimizer], tensors: Iterable[torch.Tensor] = (),
                       generators: Iterable[torch.Generator] = ()) -> None:  # fmt: skip
    """Rank 0's training state in every rank's: the ``modules``' states
    (parameters and buffers), the ``optimizers``' states, ``tensors`` and
    the ``generators``' states; every rank passes the same, built alike.
    Only rank 0 loads a checkpoint it resumes from: the other ranks take
    the shapes of its optimizer states (one broadcast object), then the
    values. The JAX step's params and optimizer states are replicated over
    ``data``."""
    if not axis.joined:
        return
    optimizers = list(optimizers)
    _allocate_states(optimizers, broadcast_object(_state_shapes(optimizers) if axis.index == 0 else None, axis))
    every = [t for m in modules for t in m.state_dict().values()] + list(tensors)
    for opt in optimizers:
        for p in _params(opt):
            state = opt.state.get(p, {})
            every += [state[k] for k in sorted(state) if isinstance(state[k], torch.Tensor)]
    replicate(every, axis)
    for generator in generators:
        replicate_generator(generator, axis)


def tensor_leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a nested dict, in key order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tensor_leaves(tree[k])]
    return [tree] if isinstance(tree, torch.Tensor) else []


def optimizer_leaves(tree: Any) -> List[torch.optim.Optimizer]:
    """The optimizers of a nested dict, in key order."""
    if isinstance(tree, dict):
        return [o for k in sorted(tree) for o in optimizer_leaves(tree[k])]
    return [tree] if isinstance(tree, torch.optim.Optimizer) else []


def _params(optimizer: torch.optim.Optimizer) -> List[torch.Tensor]:
    return [p for group in optimizer.param_groups for p in group["params"]]


def _state_shapes(optimizers: Sequence[torch.optim.Optimizer]) -> List[Dict[int, Dict[str, Any]]]:
    """Each optimizer's state by parameter index: a tensor as ``("tensor",
    shape, dtype, on the CPU)``, any other value as it is."""
    return [
        {i: {k: ("tensor", tuple(v.shape), v.dtype, v.device.type == "cpu") if isinstance(v, torch.Tensor) else v for k, v in opt.state[p].items()}
         for i, p in enumerate(_params(opt)) if p in opt.state}
        for opt in optimizers
    ]  # fmt: skip


def _allocate_states(optimizers: Sequence[torch.optim.Optimizer], shapes: List[Dict[int, Dict[str, Any]]]) -> None:
    """An empty state of :func:`_state_shapes`' shapes for each parameter
    that has none (a rank whose optimizer has not stepped)."""
    for opt, states in zip(optimizers, shapes):
        params = _params(opt)
        for i, state in states.items():
            p = params[i]
            if not opt.state.get(p):
                opt.state[p] = {
                    k: torch.empty(v[1], dtype=v[2], device="cpu" if v[3] else p.device) if isinstance(v, tuple) and v[:1] == ("tensor",) else v
                    for k, v in state.items()
                }  # fmt: skip


def broadcast_tree(tree: Optional[Dict[str, torch.Tensor]], axis: DataAxis, device: Optional[torch.device] = None) -> Dict[str, torch.Tensor]:
    """Rank 0's ``tree`` (the other ranks pass None) whole on every rank,
    on ``device`` (the other ranks'; the backend's by default): one
    broadcast of the keys, shapes and dtypes, one a dtype of the values."""
    if not axis.joined:
        return tree
    dist = _dist()
    meta = broadcast_object(None if tree is None else [(k, tuple(v.shape), v.dtype) for k, v in tree.items()], axis)
    if tree is None:
        target = device if device is not None else (axis.device or torch.device("cpu"))
        tree = {k: torch.empty(shape, dtype=dtype, device=target) for k, shape, dtype in meta}
    with _through(list(tree.values()), axis) as buckets:
        for flat in buckets:
            dist.broadcast(flat, 0)
    return tree


def shard_batch(tree: Optional[Dict[str, torch.Tensor]], axis: DataAxis, dim: int = 0, device: Optional[torch.device] = None) -> Dict[str, torch.Tensor]:
    """Rank 0's ``tree`` (the other ranks pass None) on every rank, each
    keeping its block of rows along ``dim`` (contiguous), on ``device``
    (as :func:`broadcast_tree`). Raises where ``dim`` does not divide by
    the axis."""
    if not axis.joined:
        return tree
    if tree is not None:
        for v in tree.values():
            local_batch_size(v.shape[dim], axis.size, dim)
    tree = broadcast_tree(tree, axis, device)
    return {k: v.narrow(dim, axis.index * (v.shape[dim] // axis.size), v.shape[dim] // axis.size).contiguous() for k, v in tree.items()}


def all_mean_grads(params: Iterable[torch.Tensor], axis: DataAxis, op: str = "mean") -> None:
    """The gradients of ``params`` summed over the ranks (one ``all_reduce``
    of a flat bucket a dtype), divided by N for ``op="mean"``: the gradient
    of the global mean loss from each rank's mean over its rows. ``op="sum"``
    is the gradient of a loss summed over the batch."""
    if not axis.joined:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    dist = _dist()
    with _through(grads, axis) as buckets:
        for flat in buckets:
            dist.all_reduce(flat)
            if op == "mean":
                flat.div_(axis.size)


def all_gather(x: torch.Tensor, axis: DataAxis) -> torch.Tensor:
    """Every rank's ``x`` (same shape on each) concatenated along dim 0 in
    rank order."""
    if not axis.joined:
        return x
    dist = _dist()
    local = x.detach().contiguous()
    on = local.to(axis.device) if axis.device is not None else local
    parts = [torch.empty_like(on) for _ in range(axis.size)]
    dist.all_gather(parts, on)
    return torch.cat(parts).to(x.device)


def all_mean(x: torch.Tensor, axis: DataAxis, op: str = "mean") -> torch.Tensor:
    """``x`` summed over the ranks, divided by N for ``op="mean"`` (a new
    tensor)."""
    if not axis.joined:
        return x
    dist = _dist()
    out = x.detach().clone()
    on = out.to(axis.device) if axis.device is not None else out
    dist.all_reduce(on)
    if op == "mean":
        on.div_(axis.size)
    return on.to(x.device)


def all_mean_metrics(metrics: Dict[str, torch.Tensor], axis: DataAxis, op: str = "mean") -> Dict[str, torch.Tensor]:
    """A step's 0-d metrics averaged over the ranks in one ``all_reduce``:
    the losses of the global batch where each rank holds its rows' mean
    (summed, for ``op="sum"``, where each holds its rows' sum)."""
    if not axis.joined or not metrics:
        return metrics
    keys = list(metrics)
    mean = all_mean(torch.stack([metrics[k].detach().float() for k in keys]), axis, op)
    return {k: mean[i] for i, k in enumerate(keys)}


def global_mean(x: torch.Tensor, axis: DataAxis) -> torch.Tensor:
    """``x.mean()`` over every rank's rows (each rank holding as many): in
    value the global mean, in gradient this rank's own mean, which
    :func:`all_mean_grads` then makes the global mean's. A loss that takes a
    nonlinear function of a batch mean (DreamerV1's and DreamerV2's KL
    floored at the free nats after the mean) evaluates it there, as the JAX
    step does on its sharded batch. On one rank, ``x.mean()``."""
    local = x.mean()
    if not axis.joined:
        return local
    return local + (all_mean(local.detach(), axis) - local).detach()


def global_mean_std(x: torch.Tensor, axis: DataAxis) -> Tuple[torch.Tensor, torch.Tensor]:
    """The mean and the unbiased standard deviation of ``x`` over every
    rank's rows (two ``all_reduce``: the sum and count, then the squared
    deviations from the global mean)."""
    if not axis.joined:
        return x.mean(), (x.std() if x.numel() > 1 else torch.zeros((), dtype=x.dtype, device=x.device))
    total = all_mean(torch.stack([x.sum(), torch.tensor(float(x.numel()), dtype=x.dtype, device=x.device)]), axis, op="sum")
    mean = total[0] / total[1]
    n = int(round(float(total[1])))
    if n <= 1:
        return mean, torch.zeros((), dtype=x.dtype, device=x.device)
    sq = all_mean(((x - mean) ** 2).sum(), axis, op="sum")
    return mean, torch.sqrt(sq / (n - 1))


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
