"""Pipelined env interaction: the async action fetch, env slices and
double-buffered obs staging (counterpart of sheeprl_tpu/core/interact.py).

A serial loop's env step is::

    obs_t   = prepare(obs).to(device)     # host
    out     = player(obs_t)               # queued on the card
    actions = out.cpu().numpy()           # the host waits for the player and the copy
    envs.step(actions)                    # the card idles

Three switches, each off by default (then :meth:`InteractionPipeline.interact`
is that loop, op for op):

1. ``fabric.async_fetch``: at dispatch the outputs' copy to pinned host
   buffers is issued on a copy stream, ordered after the player's work by an
   event; the harvest just before ``envs.step`` waits on the copy's event,
   so the copy rides under the host work in between (a train dispatch
   there, :attr:`InteractionPipeline.overlap_train`).
2. ``env.pipeline_slices`` = S: the env columns are S vector envs
   (:class:`EnvSliceGroup`); every slice's player is dispatched first, then
   slice k steps on the host while slice k+1's copy is in flight. Recurrent
   player state and generators are kept per slice, and the infos are merged
   back to the whole vector's layout.
3. :class:`ObsStager`: ``prepare`` writes into two buffers in turn instead of
   allocating every step.

On the telemetry tracer (the JAX package's names): spans
``interaction/dispatch/slice<k>`` (the player's dispatch),
``interaction/env_step/slice<k>`` and ``fetch/<label>`` (the harvest, with
its bytes), the ``blocking_fetch_calls`` and ``device_get_*`` counters and
the ``interaction_overlap_fraction`` gauge.
"""

from __future__ import annotations

import time
from contextlib import nullcontext
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.core import chaos
from sheeprl_tpu_torch.envs.dummy import SyncVectorEnv
from sheeprl_tpu_torch.telemetry import trace_context
from sheeprl_tpu_torch.telemetry import tracer as tracer_mod

_MISSING = object()
OVERLAP_GAUGE = "interaction_overlap_fraction"
BLOCKING_CALLS_COUNTER = "blocking_fetch_calls"


# --------------------------------------------------------------------- trees
def split_ranges(num_envs: int, slices: int) -> List[Tuple[int, int]]:
    """``num_envs`` columns in ``slices`` contiguous ranges, the first
    ``num_envs % slices`` one column longer (``np.array_split``'s)."""
    if slices < 1:
        raise ValueError(f"pipeline_slices must be >= 1, got {slices}")
    if slices > num_envs:
        raise ValueError(f"pipeline_slices ({slices}) cannot exceed num_envs ({num_envs})")
    base, extra = divmod(num_envs, slices)
    ranges, start = [], 0
    for k in range(slices):
        stop = start + base + (1 if k < extra else 0)
        ranges.append((start, stop))
        start = stop
    return ranges


def tree_slice(tree: Any, start: int, stop: int) -> Any:
    """Axis 0 of every leaf of a (possibly dict) tree, rows ``start:stop``."""
    if isinstance(tree, dict):
        return {k: tree_slice(v, start, stop) for k, v in tree.items()}
    return tree[start:stop]


def tree_concat(parts: Sequence[Any]) -> Any:
    """Per-slice trees (numpy arrays or tensors) joined back along axis 0."""
    first = parts[0]
    if isinstance(first, dict):
        return {k: tree_concat([p[k] for p in parts]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(tree_concat([p[i] for p in parts]) for i in range(len(first)))
    if isinstance(first, torch.Tensor):
        return torch.cat(list(parts), 0)
    return np.concatenate([np.asarray(p) for p in parts], axis=0)


def merge_infos(infos: Sequence[Dict[str, Any]], ranges: Sequence[Tuple[int, int]]) -> Dict[str, Any]:
    """Per-slice infos of the port's :class:`SyncVectorEnv` merged to the
    whole vector's: ``episode`` (``(env index, return, length)`` per ended
    episode) with each slice's indices offset by its start, in slice order;
    ``final_obs`` and any other per-env list or array joined, a slice that
    lacks the key filled with None (zeros for arrays); anything else the
    first slice's that has it. A slice in which no episode ended adds no
    episode."""
    keys: List[str] = []
    for inf in infos:
        keys += [k for k in inf if k not in keys]
    merged: Dict[str, Any] = {}
    counts = [s1 - s0 for s0, s1 in ranges]
    for key in keys:
        vals = [inf.get(key, _MISSING) for inf in infos]
        if key == "episode":
            merged[key] = [(int(i) + s0, *rest) for v, (s0, _) in zip(vals, ranges) if v is not _MISSING for i, *rest in v]
            continue
        template = next((v for v in vals if v is not _MISSING), None)
        n_template = next(n for v, n in zip(vals, counts) if v is not _MISSING)
        if isinstance(template, list) and len(template) == n_template:
            merged[key] = [x for v, n in zip(vals, counts) for x in ([None] * n if v is _MISSING else v)]
        elif isinstance(template, np.ndarray) and template.ndim >= 1 and len(template) == n_template:
            merged[key] = np.concatenate(
                [np.zeros((n, *template.shape[1:]), template.dtype) if v is _MISSING else np.asarray(v) for v, n in zip(vals, counts)]
            )
        else:
            merged[key] = template
    return merged


# ------------------------------------------------------------ EnvSliceGroup
class EnvSliceGroup:
    """S vector envs (the port's :class:`SyncVectorEnv`) as one vector of
    ``num_envs`` envs. :meth:`step` steps the slices in turn, env by env in
    the whole vector's order; :meth:`step_slice` steps one, which
    :meth:`InteractionPipeline.interact` pipelines against.
    ``reset(seed=s)`` gives slice k ``s + start_k``, so env j sees ``s + j``
    as in one vector; :meth:`sample_actions` draws the whole batch from one
    generator seeded as one vector's, and :meth:`state_dict` is one vector's,
    so a checkpoint moves between sliced and unsliced runs."""

    def __init__(self, envs: Sequence[Any], seed: int = 0) -> None:
        if not envs:
            raise ValueError("EnvSliceGroup needs at least one vector env")
        self.envs = list(envs)
        self.slice_ranges, start = [], 0
        for env in self.envs:
            self.slice_ranges.append((start, start + env.num_envs))
            start += env.num_envs
        self.num_envs = start
        self.single_observation_space = self.envs[0].single_observation_space
        self.single_action_space = self.envs[0].single_action_space
        self._rng = np.random.default_rng(seed)

    # One vector's uniform random actions, from the group's own generator.
    sample_actions = SyncVectorEnv.sample_actions

    @property
    def slices(self) -> int:
        return len(self.envs)

    def reset(self, seed: Optional[int] = None) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
        parts = [env.reset(seed=None if seed is None else seed + s0) for env, (s0, _) in zip(self.envs, self.slice_ranges)]
        return tree_concat([p[0] for p in parts]), merge_infos([p[1] for p in parts], self.slice_ranges)

    def step_slice(self, k: int, actions: Any):
        """Step slice k alone, ``actions`` in its own layout."""
        return self.envs[k].step(actions)

    def close(self) -> None:
        for env in self.envs:
            env.close()

    def step(self, actions: Any):
        return self.merge_step([self.step_slice(k, tree_slice(actions, s0, s1)) for k, (s0, s1) in enumerate(self.slice_ranges)])

    def merge_step(self, results: Sequence[Tuple[Any, Any, Any, Any, Dict[str, Any]]]):
        obs = tree_concat([r[0] for r in results])
        rewards, terminated, truncated = (np.concatenate([np.asarray(r[i]) for r in results]) for i in (1, 2, 3))
        return obs, rewards, terminated, truncated, merge_infos([r[4] for r in results], self.slice_ranges)

    def state_dict(self) -> Dict[str, Any]:
        states = [env.state_dict() for env in self.envs]
        per_env = "states" if "states" in states[0] else "steps"
        return {
            "rng": self._rng.bit_generator.state,
            "returns": [x for s in states for x in s["returns"]], "lengths": [x for s in states for x in s["lengths"]],
            per_env: [x for s in states for x in s[per_env]],
        }  # fmt: skip

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        per_env = "states" if "states" in state else "steps"
        if len(state[per_env]) != self.num_envs:
            raise ValueError(f"the state holds {len(state[per_env])} envs, this vector has {self.num_envs}")
        self._rng.bit_generator.state = state["rng"]
        for env, (s0, s1) in zip(self.envs, self.slice_ranges):
            rng = env._rng.bit_generator.state
            env.load_state_dict({"rng": rng, "returns": state["returns"][s0:s1], "lengths": state["lengths"][s0:s1], per_env: state[per_env][s0:s1]})


# ---------------------------------------------------------------- ObsStager
class ObsStager:
    """Double-buffered staging around ``prepare(obs, out=None) -> tree``:
    the first two calls allocate, later ones write into the two results in
    turn. Two, because step t-1's buffer may still be read (by a copy to the
    card or by the caller) while step t stages."""

    __slots__ = ("_prepare", "_buffers", "_idx")

    def __init__(self, prepare: Callable[..., Any]) -> None:
        self._prepare = prepare
        self._buffers: List[Any] = [None, None]
        self._idx = 0

    def __call__(self, obs: Any) -> Any:
        self._idx ^= 1
        out = self._prepare(obs, out=self._buffers[self._idx])
        self._buffers[self._idx] = out
        return out


# -------------------------------------------------------------------- stats
class FetchStats:
    """One pipeline's account of its fetches and env steps."""

    __slots__ = (
        "steps", "async_fetches", "blocking_fetches", "async_fetch_bytes", "fetch_blocked_s", "fetch_ride_s", "policy_dispatch_s", "env_step_s",
    )  # fmt: skip

    def __init__(self) -> None:
        self.steps = self.async_fetches = self.blocking_fetches = self.async_fetch_bytes = 0
        self.fetch_blocked_s = self.fetch_ride_s = self.policy_dispatch_s = self.env_step_s = 0.0

    @property
    def overlap_fraction(self) -> float:
        """The share of the fetches' time hidden under other host work:
        ride / (ride + blocked); 0 when every fetch blocks."""
        total = self.fetch_ride_s + self.fetch_blocked_s
        return self.fetch_ride_s / total if total > 0 else 0.0

    def as_dict(self) -> Dict[str, float]:
        out = {k: getattr(self, k) for k in self.__slots__}
        out["overlap_fraction"] = self.overlap_fraction
        return out


_LAST_RUN_STATS: Optional[Dict[str, float]] = None


def last_run_stats() -> Optional[Dict[str, float]]:
    """The stats of the last :meth:`InteractionPipeline.publish` in this process."""
    return _LAST_RUN_STATS


# ------------------------------------------------------------- PendingFetch
def _flatten(tree: Any) -> Tuple[List[Any], Callable[[List[Any]], Any]]:
    if isinstance(tree, dict):
        keys = list(tree)
        subs = [_flatten(tree[k]) for k in keys]
        return [x for leaves, _ in subs for x in leaves], lambda xs: dict(zip(keys, _rebuild(subs, xs)))
    if isinstance(tree, (tuple, list)):
        subs = [_flatten(v) for v in tree]
        kind = type(tree)
        return [x for leaves, _ in subs for x in leaves], lambda xs: kind(_rebuild(subs, xs))
    return [tree], lambda xs: xs[0]


def _rebuild(subs, xs: List[Any]) -> List[Any]:
    out, i = [], 0
    for leaves, build in subs:
        out.append(build(xs[i : i + len(leaves)]))
        i += len(leaves)
    return out


class PendingFetch:
    """One copy of a tree of tensors to the host, issued by
    :meth:`InteractionPipeline.fetch`. Async on the card: the copy goes into
    pinned buffers on the pipeline's copy stream once the current stream's
    work so far is done (an event), each source is marked as used on the
    copy stream (``record_stream``) and held until the harvest, and an event
    marks the copy's end. :meth:`harvest` waits on it and returns numpy
    arrays over the pinned buffers; those buffers are written again two
    fetches of the same slot later. Otherwise the harvest is the blocking
    ``.cpu()`` of each leaf. Submit to harvest is the ride, the wait in the
    harvest is the blocked time."""

    __slots__ = ("_pipeline", "_leaves", "_build", "_async", "_host", "_event", "_submit_t", "_result", "_done", "_label", "_ctx")

    def __init__(self, pipeline: "InteractionPipeline", tree: Any, slot: Any, label: str = "player_actions") -> None:
        self._pipeline = pipeline
        self._label = label
        # The fetch span belongs to the iteration that issued it, even when
        # the harvest comes later.
        parent = trace_context.current()
        self._ctx = parent.child() if parent is not None else None
        self._leaves, self._build = _flatten(tree)
        self._async = pipeline.async_fetch
        self._host, self._event, self._result, self._done = None, None, None, False
        if self._async:
            stats = pipeline.stats
            stats.async_fetches += 1
            stats.async_fetch_bytes += sum(t.numel() * t.element_size() for t in self._leaves)
            device = self._leaves[0].device
            if device.type == "cuda":
                self._host = pipeline._pinned(slot, self._leaves)
                stream = pipeline._copy_stream(device)
                stream.wait_stream(torch.cuda.current_stream(device))
                with torch.cuda.stream(stream):
                    for buf, leaf in zip(self._host, self._leaves):
                        buf.copy_(leaf, non_blocking=True)
                        leaf.record_stream(stream)
                    self._event = torch.cuda.Event()
                    self._event.record(stream)
        self._submit_t = time.perf_counter()

    def harvest(self) -> Any:
        """The host tree (numpy arrays); later calls return the same. The
        wait runs under the pipeline's watchdog, after the chaos
        ``fetch.harvest`` delay point."""
        if self._done:
            return self._result
        stats = self._pipeline.stats
        t0 = time.perf_counter()
        watchdog = self._pipeline.watchdog
        with nullcontext() if watchdog is None else watchdog.guard(f"fetch/{self._label}"):
            # Inside the armed window: a delayed_fetch drill looks to the
            # watchdog exactly like a hung wait on the card.
            chaos.maybe_delay("fetch.harvest")
            if self._event is not None:
                self._event.synchronize()
                out = [buf.numpy() for buf in self._host]
            else:
                out = [leaf.detach().cpu().numpy() for leaf in self._leaves]
        t1 = time.perf_counter()
        stats.fetch_blocked_s += t1 - t0
        tracer = tracer_mod.current()
        if self._async:
            stats.fetch_ride_s += t0 - self._submit_t
        else:
            stats.blocking_fetches += 1
            tracer.count(BLOCKING_CALLS_COUNTER, 1)
        if tracer.enabled:
            nbytes = sum(int(a.nbytes) for a in out)
            tracer.add_span(f"fetch/{self._label}", "fetch", t0, t1 - t0, {"bytes": nbytes, "async": self._async}, ctx=self._ctx)
            tracer.count("device_get_calls", 1)
            tracer.count("device_get_bytes", nbytes)
        self._result, self._done, self._leaves = self._build(out), True, None
        return self._result


class InteractionResult(NamedTuple):
    outputs: Any
    obs: Any
    rewards: np.ndarray
    terminated: np.ndarray
    truncated: np.ndarray
    infos: Dict[str, Any]


# ------------------------------------------------------- InteractionPipeline
class InteractionPipeline:
    """One loop's interaction.

    - fetch only (every loop): ``pending = pipeline.fetch(tree)`` where the
      tensors are made, ``pending.harvest()`` where their host values are
      first read; with ``async_fetch`` off it is the blocking copy moved to
      the read, which changes no value.
    - :meth:`interact` (DreamerV3, SAC, DroQ, SAC-AE, PPO): the whole env
      step, per slice: obs sliced and staged, the player dispatched, its
      outputs fetched, the env slice stepped, and the results merged; the
      per-slice player state (:meth:`init_state`, :meth:`map_state`) and
      generators (:meth:`set_key`) are the pipeline's.

    At one slice with ``async_fetch`` off :meth:`interact` is prepare,
    player, ``.cpu()``, ``envs.step``, with the loop's own generator: the
    serial loop, bit for bit."""

    def __init__(self, num_envs: int, *, slices: int = 1, async_fetch: bool = False) -> None:
        self.num_envs, self.slices, self.async_fetch = int(num_envs), int(slices), bool(async_fetch)
        self._ranges = split_ranges(self.num_envs, self.slices)
        self.stats = FetchStats()
        self._states: Optional[List[Any]] = None
        self._keys: Optional[List[Any]] = None
        self._stagers: Dict[int, ObsStager] = {}
        self._obs_bufs: List[Any] = [None, None]
        self._obs_idx = 0
        self._pinned_bufs: Dict[Any, List[Any]] = {}
        self._streams: Dict[str, Any] = {}
        # The loop's DispatchWatchdog (core/resilience.py), armed around each
        # harvest's wait; None leaves the harvest unwatched.
        self.watchdog: Optional[Any] = None

    @classmethod
    def from_config(cls, cfg, num_envs: Optional[int] = None) -> "InteractionPipeline":
        """``env.pipeline_slices`` and ``fabric.async_fetch`` of a run's config."""
        n = int(num_envs if num_envs is not None else cfg.env.num_envs)
        return cls(n, slices=int(cfg.env.get("pipeline_slices", 1) or 1), async_fetch=bool(cfg.fabric.get("async_fetch", False)))

    # ------------------------------------------------------------- fetches
    def _copy_stream(self, device: torch.device):
        key = str(device)
        if key not in self._streams:
            self._streams[key] = torch.cuda.Stream(device)
        return self._streams[key]

    def _pinned(self, slot: Any, leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Pinned host buffers for ``leaves``, two per ``slot`` in turn
        (made again when the shapes change)."""
        entry = self._pinned_bufs.setdefault(slot, [0, None, None])
        entry[0] ^= 1
        bufs = entry[1 + entry[0]]
        if bufs is None or [(b.shape, b.dtype) for b in bufs] != [(t.shape, t.dtype) for t in leaves]:
            bufs = entry[1 + entry[0]] = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in leaves]
        return bufs

    def fetch(self, tree: Any, label: str = "player_actions", slot: int = 0) -> PendingFetch:
        """Issue the copy of ``tree`` now (async when on); ``.harvest()`` the
        handle where the host values are needed."""
        return PendingFetch(self, tree, (label, slot), label)

    @property
    def overlap_train(self) -> bool:
        """Whether a loop dispatches its train call between the fetches'
        submit and their harvest (its batches then lag the buffer by one
        step): only when the fetch is async."""
        return self.async_fetch

    # ---------------------------------------------------------- slice state
    def init_state(self, fn: Callable[[int, Tuple[int, int]], Any]) -> None:
        """Per-slice player state: ``fn(envs in the slice, (start, stop))``."""
        self._states = [fn(s1 - s0, (s0, s1)) for s0, s1 in self._ranges]

    def map_state(self, fn: Callable[[Any, Tuple[int, int]], Any]) -> None:
        """Every slice's state through ``fn(state, (start, stop))``; a mask
        ``fn`` closes over is in the whole vector's columns, which
        ``(start, stop)`` selects."""
        if self._states is None:
            raise RuntimeError("init_state() was never called")
        self._states = [fn(s, rng) for s, rng in zip(self._states, self._ranges)]

    @property
    def states(self) -> Optional[List[Any]]:
        return self._states

    def set_key(self, key: Any) -> None:
        """The loop's generator (a ``torch.Generator`` or a wrapper with a
        ``generator`` attribute, :class:`BatchGenerator`). With one slice it
        passes through untouched; with S it seeds S generators of its type
        on its device from S draws of it."""
        if self.slices == 1:
            self._keys = [key]
            return
        gen = getattr(key, "generator", key)
        seeds = torch.randint(0, 2**62, (self.slices,), generator=gen, device=gen.device).tolist()
        gens = [torch.Generator(device=gen.device).manual_seed(int(s)) for s in seeds]
        self._keys = gens if gen is key else [type(key)(g) for g in gens]

    @property
    def key(self) -> Any:
        return self._keys[0] if self._keys else None

    # ------------------------------------------------------------- interact
    def stash_obs(self, obs: Any) -> Any:
        """The merged next obs copied into the pipeline's two buffers in
        turn, so the obs a loop holds stays valid for an iteration whatever
        the env does with its own buffers; loops call it on the obs of their
        unpipelined branch (the random prefill) too."""

        def _copy_into(buf: Any, src: Any) -> Any:
            if isinstance(src, dict):
                buf = buf if isinstance(buf, dict) else {}
                return {k: _copy_into(buf.get(k), v) for k, v in src.items()}
            src = np.asarray(src)
            if isinstance(buf, np.ndarray) and buf.shape == src.shape and buf.dtype == src.dtype:
                np.copyto(buf, src)
                return buf
            return src.copy()

        self._obs_idx ^= 1
        out = _copy_into(self._obs_bufs[self._obs_idx], obs)
        self._obs_bufs[self._obs_idx] = out
        return out

    def interact(
        self,
        envs: Any,
        obs: Any,
        policy: Callable[[Any, Any, Any], Tuple[Any, Any, Any]],
        *,
        prepare: Optional[Callable[..., Any]] = None,
        to_env_actions: Optional[Callable[[Any, int], Any]] = None,
        before_harvest: Optional[Callable[[], None]] = None,
        label: str = "player_actions",
    ) -> InteractionResult:
        """One env step of every env. ``policy(obs, state, key) ->
        (tensors to fetch, new state, new key)`` runs once per slice (state
        and key None when unused); ``prepare(obs, out=None)`` stages a
        slice's raw obs (double buffered per slice);
        ``to_env_actions(host outputs, n)`` maps a slice's harvested tree to
        its env actions; ``before_harvest`` runs after every slice's player
        is dispatched and its fetch issued, before the first harvest.
        Returns the outputs, next obs (stashed), rewards, flags and infos in
        the whole vector's layout."""
        sliced = self.slices > 1
        if sliced and not (isinstance(envs, EnvSliceGroup) and envs.slices == self.slices):
            raise ValueError(f"pipeline_slices={self.slices} needs an EnvSliceGroup of {self.slices} slices (build the envs with make_vector_env)")
        pendings: List[PendingFetch] = []
        tracer = tracer_mod.current()
        t0 = time.perf_counter()
        for k, (s0, s1) in enumerate(self._ranges):
            obs_k = tree_slice(obs, s0, s1) if sliced else obs
            staged = self._stager(k, prepare)(obs_k) if prepare is not None else obs_k
            state_k = self._states[k] if self._states is not None else None
            key_k = self._keys[k] if self._keys is not None else None
            with tracer.span(f"interaction/dispatch/slice{k}", "interaction"):
                tree, new_state, new_key = policy(staged, state_k, key_k)
            if self._states is not None:
                self._states[k] = new_state
            if self._keys is not None:
                self._keys[k] = new_key
            pendings.append(self.fetch(tree, label=label, slot=k))
        self.stats.policy_dispatch_s += time.perf_counter() - t0
        if before_harvest is not None:
            before_harvest()
        outputs, results = [], []
        for k, (s0, s1) in enumerate(self._ranges):
            host = pendings[k].harvest()
            outputs.append(host)
            actions = to_env_actions(host, s1 - s0) if to_env_actions is not None else host
            t1 = time.perf_counter()
            with tracer.span(f"interaction/env_step/slice{k}", "interaction"):
                results.append(envs.step_slice(k, actions) if sliced else envs.step(actions))
            self.stats.env_step_s += time.perf_counter() - t1
        self.stats.steps += 1
        if self.stats.steps % 128 == 0:
            tracer.set_gauge(OVERLAP_GAUGE, self.stats.overlap_fraction)
        if sliced:
            out = tree_concat(outputs)
            next_obs, rewards, terminated, truncated, infos = envs.merge_step(results)
        else:
            out = outputs[0]
            next_obs, rewards, terminated, truncated, infos = results[0]
        return InteractionResult(out, self.stash_obs(next_obs), rewards, terminated, truncated, infos)

    def _stager(self, k: int, prepare: Callable[..., Any]) -> ObsStager:
        if k not in self._stagers:
            self._stagers[k] = ObsStager(prepare)
        return self._stagers[k]

    def publish(self) -> Dict[str, float]:
        """At the end of a run: the stats into :func:`last_run_stats`, and
        the overlap gauge to the telemetry tracer."""
        global _LAST_RUN_STATS
        _LAST_RUN_STATS = self.stats.as_dict()
        tracer_mod.current().set_gauge(OVERLAP_GAUGE, _LAST_RUN_STATS["overlap_fraction"])
        return _LAST_RUN_STATS
