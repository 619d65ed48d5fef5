"""A step captured once as a CUDA graph and replayed (the port's counterpart
of ``jax.jit`` for a train step).

:class:`CapturedStep` wraps ``fn()``, a function of no arguments that reads
and writes tensors at fixed addresses (parameters, optimizer states, a
replay ring, static inputs) and returns a tensor. On a CUDA device its first
``WARMUP_CALLS`` calls run ``fn`` eagerly on the step's own side stream; the
first of them under ``torch.cuda.set_sync_debug_mode("error")``, so that a
host synchronisation inside the step raises instead of being captured. The
warm-up runs on the stream the capture will use, so that whatever the step
allocates once and keeps (gradients of the first backward, the LN-GRU
kernels' arrival tickets, which are kept per stream) exists outside the
graph's memory pool. The next call captures one call of ``fn`` with
``torch.cuda.graph(g, stream=s)``, with every ``torch.Generator`` the step
draws from registered on the graph, so that each replay draws new numbers
and advances the generator as the eager call would; from then on every call
replays the graph and returns the tensor the captured call returned, which
the replay overwrites. A failed capture raises: nothing falls back to the
eager step.

On the CPU there is no graph: every call runs ``fn``, the plain version of
the step, as the kernels have one.

:class:`RingHolder` keeps a step on the replay ring it was captured with,
and :func:`power_of_two_buckets` splits a train call's gradient steps into
the buckets the fused paths run.

The graph's nodes are counted from the graph itself (:func:`graph_nodes`,
with libcuda's graph API): the Python launch counters of the LN-GRU wrappers
count the warm-up and the capture, never a replay.

Telemetry: each capture is a ``cuda_graph_capture`` span and counter
(:func:`sheeprl_tpu_torch.telemetry.cuda_events.graph_captured`, under the
step's ``name``). The goodput accountant's count of a train call
(:mod:`sheeprl_tpu_torch.telemetry.perf`) sees the eager warm-ups as they
run; the step keeps the work of its first counted eager call as
:attr:`CapturedStep.work`, the count pauses around the capture, and each
replay credits that work to an open count.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from sheeprl_tpu_torch.telemetry import perf
from sheeprl_tpu_torch.telemetry.cuda_events import graph_captured

# Eager calls before the capture: the first under the sync check, and two
# more so that lazily built state (optimizer moments, cuBLAS workspaces,
# per-stream tickets) has settled.
WARMUP_CALLS = 3

# Kernel names by the LN-GRU kernel each belongs to (csrc/ln_gru*.cu).
LN_GRU_KERNELS = {"streaming": "ln_gru_stream_forward", "tensor_core": "ln_gru_tc_forward", "backward": "ln_gru_bwd_fused"}

# CUgraphNodeType (cuda.h) by number.
_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph", 5: "empty", 6: "wait_event", 7: "event_record"}


class CapturedStep:
    """``fn()`` captured as a CUDA graph after ``warmup`` eager calls
    (``WARMUP_CALLS`` by default; see the module's docstring; the Anakin
    lane's rollouts take one). ``warmup_calls`` and ``replays`` count
    how each call ran; ``nodes`` is :func:`graph_nodes` of the graph once
    it is captured; ``name`` (``fn``'s qualified name by default) names
    the capture on the telemetry timeline; ``work`` is the FLOPs and bytes
    of one eager call, once a goodput count has seen one."""

    def __init__(
        self,
        fn: Callable[[], torch.Tensor],
        device: torch.device,
        generators: Sequence[torch.Generator] = (),
        warmup: int = WARMUP_CALLS,
        name: Optional[str] = None,
    ):
        self.fn = fn
        self.name = name or getattr(fn, "__qualname__", "step")
        self.work: Optional[Dict[str, float]] = None
        self.warmup = max(int(warmup), 1)
        self.device = torch.device(device)
        self.generators = list(generators)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.stream: Optional[torch.cuda.Stream] = None
        self.output: Optional[torch.Tensor] = None
        self.nodes: Optional[Dict[str, object]] = None
        self.warmup_calls = 0
        self.replays = 0

    def __call__(self) -> torch.Tensor:
        if self.device.type != "cuda":
            return self.fn()
        if self.graph is None and self.warmup_calls < self.warmup:
            return self._warmup()
        if self.graph is None:
            with perf.counting_paused():
                self._capture()
        self.graph.replay()
        self.replays += 1
        perf.credit(self.work)
        return self.output

    def _side_stream(self) -> torch.cuda.Stream:
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.device)
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        return self.stream

    def _warmup(self) -> torch.Tensor:
        stream = self._side_stream()
        before = perf.counted()
        with torch.cuda.stream(stream):
            if self.warmup_calls == 0:
                previous = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    out = self.fn()
                finally:
                    torch.cuda.set_sync_debug_mode(previous)
            else:
                out = self.fn()
        if before is not None and self.work is None:
            self.work = perf.counted_since(before)
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_stream(stream)
        out.record_stream(consumer)
        self.warmup_calls += 1
        return out

    def _capture(self) -> None:
        start = time.perf_counter()
        graph = torch.cuda.CUDAGraph(keep_graph=True)  # kept so that its nodes can be counted
        for generator in self.generators:
            graph.register_generator_state(generator)
        stream = self._side_stream()
        with torch.cuda.graph(graph, stream=stream):
            self.output = self.fn()
        graph.instantiate()
        torch.cuda.current_stream(self.device).wait_stream(stream)
        self.graph = graph
        self.nodes = graph_nodes(graph)
        graph_captured(self.name, time.perf_counter() - start, self.nodes["nodes"])


class RingHolder:
    """The replay ring state a captured step samples: the first state
    passed is held, and another ring's raises, since a replayed graph reads
    the first one's addresses (a state of the same tensors is the same
    ring)."""

    def __init__(self) -> None:
        self.state: Optional[Dict[str, Any]] = None

    def hold(self, ring_state: Dict[str, Any]) -> None:
        if self.state is None:
            self.state = ring_state
        elif self.state is not ring_state and not _same_ring(self.state, ring_state):
            raise ValueError("the fused train step samples the ring it was built with: pass that ring's state")


def _same_ring(a: Dict[str, Any], b: Dict[str, Any]) -> bool:
    return a["pos"] is b["pos"] and a["added"] is b["added"] and a["data"].keys() == b["data"].keys() and all(
        a["data"][k] is b["data"][k] for k in a["data"]
    )


def power_of_two_buckets(steps: int, most: int) -> List[int]:
    """``steps`` gradient steps split into power-of-two buckets of at most
    ``most``, largest first: the JAX package's bounded set of fused shapes
    (``algo.fused_train_steps``)."""
    out, remaining = [], int(steps)
    while remaining > 0:
        k = 1 << (min(remaining, max(int(most), 1)).bit_length() - 1)
        out.append(k)
        remaining -= k
    return out


@functools.lru_cache(maxsize=None)
def _libcuda() -> ctypes.CDLL:
    lib = ctypes.CDLL("libcuda.so.1")
    for name, args in (
        ("cuGraphGetNodes", [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)]),
        ("cuGraphNodeGetType", [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]),
        ("cuGraphKernelNodeGetParams_v2", [ctypes.c_void_p, ctypes.c_void_p]),
        ("cuFuncGetName", [ctypes.POINTER(ctypes.c_char_p), ctypes.c_void_p]),
        ("cuKernelGetName", [ctypes.POINTER(ctypes.c_char_p), ctypes.c_void_p]),
    ):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = ctypes.c_int
    return lib


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 (cuda.h)."""

    _fields_ = [
        ("func", ctypes.c_void_p),
        ("grid", ctypes.c_uint * 3),
        ("block", ctypes.c_uint * 3),
        ("shared_mem_bytes", ctypes.c_uint),
        ("kernel_params", ctypes.c_void_p),
        ("extra", ctypes.c_void_p),
        ("kern", ctypes.c_void_p),
        ("ctx", ctypes.c_void_p),
    ]


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed with CUresult {err}")


def graph_nodes(graph: torch.cuda.CUDAGraph) -> Dict[str, object]:
    """The nodes of a captured graph (kept with ``keep_graph=True``): their
    count, the count by node type, the kernel nodes by kernel name, and the
    LN-GRU kernel nodes by kernel (``LN_GRU_KERNELS``)."""
    lib = _libcuda()
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    _check(lib.cuGraphGetNodes(raw, None, ctypes.byref(count)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * count.value)()
    _check(lib.cuGraphGetNodes(raw, nodes, ctypes.byref(count)), "cuGraphGetNodes")
    by_type: Dict[str, int] = collections.Counter()
    kernels: Dict[str, int] = collections.Counter()
    for node in nodes:
        kind = ctypes.c_int(-1)
        _check(lib.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)), "cuGraphNodeGetType")
        by_type[_NODE_TYPES.get(kind.value, str(kind.value))] += 1
        if kind.value != 0:
            continue
        params = _KernelNodeParams()
        _check(lib.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), ctypes.byref(params)), "cuGraphKernelNodeGetParams")
        name = ctypes.c_char_p()
        if params.func:
            _check(lib.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(params.func)), "cuFuncGetName")
        else:
            _check(lib.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(params.kern)), "cuKernelGetName")
        kernels[(name.value or b"?").decode()] += 1
    ln_gru = {k: sum(n for name, n in kernels.items() if sub in name) for k, sub in LN_GRU_KERNELS.items()}
    return {"nodes": int(count.value), "by_type": dict(by_type), "kernels": dict(kernels), "ln_gru": ln_gru}
