"""W3C-traceparent-style trace contexts: the causality layer under spans
(counterpart of ``sheeprl_tpu/telemetry/trace_context.py``; the same
env-var names, so either package reads the other's carrier).

The tracer records *what* happened and *how long* it took; it says
nothing about *which request / iteration / shipment* a span belongs to, and
nothing survives a process boundary — the decoupled player/trainer loops,
supervised env workers, and the serve engine each produce an uncorrelated
span soup. A :class:`TraceContext` is the missing identity: a 128-bit
``trace_id`` naming one causal story (an HTTP ``/v1/act`` request, one
training iteration, one rollout shipment), a 64-bit ``span_id`` naming the
current operation, and a ``parent_id`` linking it to the operation that
caused it.

Propagation happens at three scopes:

- **in-process** — a :mod:`contextvars` variable holds the active context;
  ``Tracer.span(...)`` derives a child per span and restores the parent on
  exit, so nesting falls out of ordinary ``with`` blocks (and is correct
  across threads spawned with ``contextvars.copy_context``).
- **cross-process** — :func:`inject_env_carrier` publishes the active
  context as ``SHEEPRL_TRACEPARENT`` (plus the flight-spill directory as
  ``SHEEPRL_TRACE_DIR``) in ``os.environ`` *before* env worker processes
  fork, and :func:`adopt_env_carrier` picks it up on the worker side. The
  carrier is the standard W3C ``traceparent`` header format
  (``00-<32 hex trace>-<16 hex span>-<2 hex flags>``), so the same
  parser serves HTTP headers in ``serve/server.py``.
- **cross-thread handoff** — code that completes work on another thread
  (the serve dispatcher, async fetch harvest) captures ``current()`` at
  submit time and passes the context explicitly to
  ``Tracer.add_span(..., ctx=...)``.

ID generation is deliberately cheap: one ``os.urandom`` seed per process
(re-seeded after fork, keyed on pid) and a counter-derived 64-bit span id
per span — no per-span entropy syscalls on the hot path.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import re
import threading
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

__all__ = [
    "TRACEPARENT_ENV",
    "TRACE_DIR_ENV",
    "TraceContext",
    "adopt_env_carrier",
    "current",
    "extract_env_carrier",
    "format_traceparent",
    "inject_env_carrier",
    "mint",
    "new_span_id",
    "parse_traceparent",
    "set_current",
    "use",
]

TRACEPARENT_ENV = "SHEEPRL_TRACEPARENT"
TRACE_DIR_ENV = "SHEEPRL_TRACE_DIR"

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)


@dataclass(frozen=True)
class TraceContext:
    """One node in a causal trace: (trace, this span, the span that caused it)."""

    trace_id: str  # 32 lowercase hex chars — constant across the whole story
    span_id: str  # 16 lowercase hex chars — this operation
    parent_id: Optional[str] = None  # 16 hex chars, or None at the root

    def child(self) -> "TraceContext":
        """A new context for an operation caused by this one."""
        return TraceContext(self.trace_id, new_span_id(), self.span_id)

    def to_traceparent(self) -> str:
        return format_traceparent(self.trace_id, self.span_id)

    @classmethod
    def from_traceparent(cls, header: str) -> Optional["TraceContext"]:
        parsed = parse_traceparent(header)
        if parsed is None:
            return None
        trace_id, span_id = parsed
        return cls(trace_id, span_id, None)


def format_traceparent(trace_id: str, span_id: str, flags: int = 1) -> str:
    """W3C traceparent: ``00-<trace>-<span>-<flags>`` (flags bit 0 = sampled)."""
    return f"00-{trace_id}-{span_id}-{flags:02x}"


def parse_traceparent(header: Optional[str]) -> Optional[Tuple[str, str]]:
    """(trace_id, span_id) from a traceparent header, or None if malformed.

    Per the W3C spec, an all-zero trace or span id is invalid; version
    ``ff`` is forbidden. Unknown (higher) versions are accepted as long as
    the 00-version fields parse — forward compatibility.
    """
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if m is None:
        return None
    version, trace_id, span_id, _flags = m.groups()
    if version == "ff" or trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id


# ------------------------------------------------------------ id generation
# One 64-bit random base per process + a counter: span ids are unique within
# the process without per-span urandom. A forked child (an env worker) reseeds
# in ``os.register_at_fork``'s hook instead of colliding with its parent's
# sequence, so no id asks for the pid (a system call, slow on some sandboxed
# hosts, on every span).
_id_lock = threading.Lock()
_next_value: Optional[int] = None  # guarded by _id_lock


def _reseed_ids() -> None:
    global _id_lock, _next_value
    _id_lock = threading.Lock()  # another thread may have held the parent's at the fork
    _next_value = None


os.register_at_fork(after_in_child=_reseed_ids)


def _next_id64() -> int:
    global _next_value
    with _id_lock:
        if _next_value is None:
            _next_value = int.from_bytes(os.urandom(8), "big") or 1
        value = _next_value
        _next_value = (value + 1) & 0xFFFFFFFFFFFFFFFF or 1
        return value


def new_span_id() -> str:
    return f"{_next_id64():016x}"


def new_trace_id() -> str:
    return f"{_next_id64():016x}{_next_id64():016x}"


def mint(parent: Optional["TraceContext"] = None) -> TraceContext:
    """A fresh context: a child of ``parent`` when given, else a new root."""
    if parent is not None:
        return parent.child()
    return TraceContext(new_trace_id(), new_span_id(), None)


# ----------------------------------------------------------- in-process var
_current_ctx: contextvars.ContextVar[Optional[TraceContext]] = contextvars.ContextVar(
    "sheeprl_trace_context", default=None
)


def current() -> Optional[TraceContext]:
    """The active context in this thread/task, or None outside any trace."""
    return _current_ctx.get()


def set_current(ctx: Optional[TraceContext]) -> contextvars.Token:
    """Install ``ctx`` as the active context; returns the reset token."""
    return _current_ctx.set(ctx)


def reset(token: contextvars.Token) -> None:
    _current_ctx.reset(token)


@contextlib.contextmanager
def use(ctx: Optional[TraceContext]) -> Iterator[Optional[TraceContext]]:
    """``with use(ctx):`` — scope ``ctx`` as the active context."""
    token = _current_ctx.set(ctx)
    try:
        yield ctx
    finally:
        _current_ctx.reset(token)


# ------------------------------------------------------------- env carrier
def inject_env_carrier(ctx: TraceContext, trace_dir: Optional[str] = None) -> None:
    """Publish ``ctx`` (and the flight-spill dir) for child processes.

    Must run before the child processes are spawned — gymnasium's
    AsyncVectorEnv workers inherit ``os.environ`` at fork/spawn time, and
    EnvSupervisor restarts rebuild from the same environment, so one
    injection covers the original workers and every restarted generation.
    """
    os.environ[TRACEPARENT_ENV] = ctx.to_traceparent()
    if trace_dir is not None:
        os.environ[TRACE_DIR_ENV] = str(trace_dir)


def clear_env_carrier() -> None:
    os.environ.pop(TRACEPARENT_ENV, None)
    os.environ.pop(TRACE_DIR_ENV, None)


def extract_env_carrier() -> Optional[TraceContext]:
    """The carrier context from ``os.environ``, if a valid one is present."""
    return TraceContext.from_traceparent(os.environ.get(TRACEPARENT_ENV, ""))


def carrier_trace_dir() -> Optional[str]:
    return os.environ.get(TRACE_DIR_ENV) or None


def adopt_env_carrier() -> Optional[TraceContext]:
    """Worker-side pickup: derive a child of the carrier context and make it
    current, so every span this process emits joins the parent's trace.
    Returns the adopted context (None when no valid carrier is present)."""
    carried = extract_env_carrier()
    if carried is None:
        return None
    ctx = carried.child()
    set_current(ctx)
    return ctx
