"""Streaming latency histogram with fixed geometric buckets (counterpart of
``sheeprl_tpu/telemetry/histogram.py``: the same buckets and quantiles).

Counters, gauges, and spans alone are fine for
throughput, useless for tail latency: a mean over an interval hides the p99
that a serving deadline or a dispatch-stall watchdog actually cares about.
:class:`Histogram` is the missing primitive: O(1) thread-safe ``record``,
bounded memory (one int per bucket, values never retained), and quantiles
recovered by linear interpolation inside the containing bucket.

Buckets are geometric — each boundary is ``growth`` times the previous —
because latencies span decades (microsecond cache hits to multi-second
compiles) and geometric spacing gives constant *relative* quantile error
(~growth-1) across the whole range. The defaults cover 1 µs .. ~128 s in
54 buckets at ~1.41× growth, i.e. quantiles are within ~20% of truth,
which is plenty for p50/p95/p99 dashboards.

The class is deliberately unit-agnostic (it histograms floats); the
convention across the repo is seconds.
"""

from __future__ import annotations

import math
import threading
from bisect import bisect_right
from typing import Dict, List, Sequence


def geometric_bounds(lo: float, hi: float, growth: float) -> List[float]:
    """Upper bucket boundaries ``lo * growth**i`` up to and including the
    first boundary >= ``hi``."""
    if lo <= 0.0 or hi <= lo or growth <= 1.0:
        raise ValueError(f"need 0 < lo < hi and growth > 1, got {lo=} {hi=} {growth=}")
    bounds = []
    b = lo
    while b < hi:
        bounds.append(b)
        b *= growth
    bounds.append(b)
    return bounds


class Histogram:
    """Fixed-bucket streaming histogram; values below the first boundary land
    in the first bucket, values above the last in an unbounded overflow
    bucket (quantiles there are reported as the observed max)."""

    DEFAULT_BOUNDS = tuple(geometric_bounds(1e-6, 128.0, math.sqrt(2.0)))

    def __init__(self, bounds: Sequence[float] = DEFAULT_BOUNDS) -> None:
        bounds = list(bounds)
        if not bounds or any(b <= a for a, b in zip(bounds, bounds[1:])):
            raise ValueError("bounds must be non-empty and strictly increasing")
        self._bounds = bounds
        # counts has one extra slot: the overflow bucket past the last bound.
        self._counts = [0] * (len(bounds) + 1)
        self._lock = threading.Lock()
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    # ---------------------------------------------------------------- record
    def record(self, value: float) -> None:
        value = float(value)
        idx = bisect_right(self._bounds, value)
        with self._lock:
            self._counts[idx] += 1
            self.count += 1
            self.total += value
            if value < self.min:
                self.min = value
            if value > self.max:
                self.max = value

    # ----------------------------------------------------------------- query
    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Quantile ``q`` in [0, 100], linearly interpolated within the
        containing bucket and clamped to the observed min/max."""
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"q must be in [0, 100], got {q}")
        with self._lock:
            count = self.count
            counts = list(self._counts)
            lo_obs, hi_obs = self.min, self.max
        if count == 0:
            return 0.0
        rank = q / 100.0 * count
        seen = 0.0
        for idx, c in enumerate(counts):
            if seen + c >= rank and c > 0:
                if idx >= len(self._bounds):
                    return hi_obs  # overflow bucket: best truthful answer
                lo = self._bounds[idx - 1] if idx > 0 else 0.0
                hi = self._bounds[idx]
                frac = (rank - seen) / c
                est = lo + frac * (hi - lo)
                return min(max(est, lo_obs), hi_obs)
            seen += c
        return hi_obs

    def buckets(self):
        """Cumulative-bucket snapshot for Prometheus exposition: a list of
        ``(upper_bound, cumulative_count)`` pairs (the overflow bucket is the
        exporter's ``+Inf`` series), plus the running sum and count — all
        captured under one lock so a concurrent scraper sees a consistent
        view."""
        with self._lock:
            counts = list(self._counts)
            total = self.total
            count = self.count
        cumulative = []
        seen = 0
        for upper, c in zip(self._bounds, counts):
            seen += c
            cumulative.append((upper, seen))
        return cumulative, total, count

    def summary(self) -> Dict[str, float]:
        """One-shot snapshot: count/mean/min/max plus the dashboard trio."""
        if self.count == 0:
            return {"count": 0, "mean": 0.0, "min": 0.0, "max": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0}
        return {
            "count": float(self.count),
            "mean": self.mean,
            "min": self.min,
            "max": self.max,
            "p50": self.percentile(50.0),
            "p95": self.percentile(95.0),
            "p99": self.percentile(99.0),
        }

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * len(self._counts)
            self.count = 0
            self.total = 0.0
            self.min = math.inf
            self.max = -math.inf
