"""Asynchronous host-to-device infeed of replay batches (counterpart of
sheeprl_tpu/data/infeed.py).

The trainer's host path samples a train call's batches from the host replay
buffer and copies them to the card; for DreamerV3 that is 12.6 MB of uint8
pixels per gradient step. :class:`ReplayInfeed` takes that copy off the
critical path, as the JAX package's does:

- ``stage(n)`` runs right after a train call, on the caller's thread: it
  samples the next call's ``n`` batches there (the replay buffer needs no
  lock) and hands them to a worker thread, which copies each through a
  reused pinned buffer to the card on a side CUDA stream and records an
  event, while the caller goes back to stepping the envs.
- ``take_or_sample(n)`` at the next train call returns the staged batches
  when at least ``n`` were staged (a hit: the consumer's stream waits on
  each batch's event, and each tensor is marked as used on that stream with
  ``record_stream``), else samples and copies synchronously (a miss).

With ``prefetch`` a call's batches are sampled one call ahead, before the
newest iteration's rows were added (``buffer.prefetch`` in the JAX
package's configs/buffer/default.yaml). Disabled, ``take_or_sample``
samples right there, in the order of the plain loop. The CNN keys keep
their dtype (uint8 pixels), the others become float32.
"""

from __future__ import annotations

import concurrent.futures
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from sheeprl_tpu_torch.telemetry import tracer as tracer_mod
from sheeprl_tpu_torch.telemetry.cuda_events import transfer

Batch = Dict[str, torch.Tensor]


class AsyncInfeed:
    """Staging of pre-sampled host batches by one worker thread.

    ``put_fn(host_batches) -> staged`` runs on the worker; ``claim_fn(staged
    item) -> batch`` runs on the caller's thread when a batch is taken."""

    def __init__(self, put_fn: Callable[[List[Any]], List[Any]], claim_fn: Callable[[Any], Any] = lambda b: b) -> None:
        self._put_fn, self._claim_fn = put_fn, claim_fn
        self._executor = concurrent.futures.ThreadPoolExecutor(max_workers=1, thread_name_prefix="sheeprl-infeed")
        self._future: Optional[concurrent.futures.Future] = None
        self._staged_count: Optional[int] = None
        self.hits = 0
        self.misses = 0

    def stage(self, host_batches: Sequence[Any]) -> None:
        """Hand sampled host batches to the worker. A staged result that was
        never taken is dropped."""
        batches = list(host_batches)
        _drop(self._future)
        self._staged_count = len(batches)
        self._future = self._executor.submit(self._put_fn, batches)

    def take(self, expected_count: int) -> Optional[List[Any]]:
        """``expected_count`` staged batches, or None. A larger stage serves
        its first ``expected_count`` (the Ratio's step count can drift by one
        between calls); a smaller stage, or none, is a miss."""
        future, count = self._future, self._staged_count
        self._future = self._staged_count = None
        if future is None or count < expected_count:
            _drop(future)
            self.misses += 1
            return None
        self.hits += 1
        return [self._claim_fn(b) for b in future.result()[:expected_count]]

    def close(self) -> None:
        self._executor.shutdown(wait=True, cancel_futures=True)


def _drop(future: Optional[concurrent.futures.Future]) -> None:
    """Discard a staged result: cancel it if it has not started, else wait
    for it so that an error on the worker is raised here."""
    if future is not None and not future.cancel():
        future.result()


class ReplayInfeed:
    """The sample, stage and take protocol of the trainer's host path, over
    a replay buffer's ``sample(batch_size, sequence_length=, n_samples=)``
    (time-major ``[n, T, B, ...]`` arrays)."""

    def __init__(self, rb, batch_size: int, sequence_length: int, cnn_keys, device: torch.device, *, enabled: bool = True) -> None:
        self._rb = rb
        self._batch_size = int(batch_size)
        self._sequence_length = int(sequence_length)
        self._cnn_keys = frozenset(cnn_keys)
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if enabled and self._cuda else None
        # One pinned buffer per staged batch slot, reused across train calls,
        # and the event of the copy that last read it (worker thread only).
        self._pinned: List[Dict[str, torch.Tensor]] = []
        self._copied: List[Optional[torch.cuda.Event]] = []
        self._infeed = AsyncInfeed(self._put, self._claim) if enabled else None

    @property
    def hits(self) -> int:
        return 0 if self._infeed is None else self._infeed.hits

    @property
    def misses(self) -> int:
        return 0 if self._infeed is None else self._infeed.misses

    def _host(self, key: str, value: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(value) if key in self._cnn_keys else np.ascontiguousarray(value, dtype=np.float32)

    def _sample_host(self, n: int) -> List[Dict[str, np.ndarray]]:
        with tracer_mod.current().span("replay/sample", "replay", batch_size=self._batch_size, n_samples=n):
            data = self._rb.sample(self._batch_size, sequence_length=self._sequence_length, n_samples=n)
        return [{k: v[i] for k, v in data.items()} for i in range(n)]

    def _device_batch(self, host_batch: Dict[str, np.ndarray]) -> Batch:
        """The synchronous copy (a miss, or prefetch off)."""
        start = time.perf_counter()
        host = {k: self._host(k, v) for k, v in host_batch.items()}
        out = {k: torch.from_numpy(v).to(self.device) for k, v in host.items()}
        transfer("put", "transfer/h2d_sync", start, sum(v.nbytes for v in host.values()))
        return out

    def _put(self, host_batches: List[Dict[str, np.ndarray]]) -> List[Any]:
        """Worker thread: each batch through its slot's pinned buffer to the
        card on the side stream, with an event recorded after its copies."""
        if not self._cuda:
            return [{k: torch.from_numpy(self._host(k, v)) for k, v in b.items()} for b in host_batches]
        staged, start, nbytes = [], time.perf_counter(), 0
        with torch.cuda.stream(self._stream):
            for i, batch in enumerate(host_batches):
                if i == len(self._pinned):
                    self._pinned.append({})
                    self._copied.append(None)
                if self._copied[i] is not None:
                    self._copied[i].synchronize()  # the slot's previous copy has read it
                slot, out = self._pinned[i], {}
                for k, v in batch.items():
                    host = self._host(k, v)
                    buf = slot.get(k)
                    if buf is None or tuple(buf.shape) != host.shape or buf.numpy().dtype != host.dtype:
                        buf = slot[k] = torch.from_numpy(host).pin_memory()
                    else:
                        buf.numpy()[...] = host
                    out[k] = buf.to(self.device, non_blocking=True)
                    nbytes += host.nbytes
                event = torch.cuda.Event()
                event.record(self._stream)
                self._copied[i] = event
                staged.append((out, event))
        transfer("put", "transfer/h2d_stage", start, nbytes)
        return staged

    def _claim(self, staged: Any) -> Batch:
        """Caller's thread: the consumer stream waits for the batch's copy,
        and the batch's memory is marked as used on that stream."""
        if not self._cuda:
            return staged
        batch, event = staged
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(event)
        for t in batch.values():
            t.record_stream(consumer)
        return batch

    def take_or_sample(self, n: int) -> List[Batch]:
        """The staged batches if ``n`` were staged, else ``n`` sampled and
        copied now."""
        batches = self._infeed.take(n) if self._infeed is not None else None
        if batches is None:
            batches = [self._device_batch(b) for b in self._sample_host(n)]
        return batches

    def stage(self, n: int) -> None:
        """Sample the next call's ``n`` batches now and hand their copies to
        the worker (nothing when prefetch is off)."""
        if self._infeed is not None:
            self._infeed.stage(self._sample_host(n))

    def close(self) -> None:
        if self._infeed is not None:
            self._infeed.close()
