"""Process-wide metrics registry: counters, gauges, fixed-bucket histograms.

The ingest pipeline's observability plane (SURVEY.md section 7: stage-level
metrics are the prerequisite for answering "which stage is the bottleneck?" -
the same layering tf.data uses, arxiv 2101.12127 section 4).  Dependency-free
and lock-cheap by design: instruments take one uncontended lock per update,
updates happen at rowgroup/batch granularity (hundreds per second, not per
row), and the disabled path never reaches this module at all
(``petastorm_tpu_torch.telemetry.NULL_TELEMETRY``).

Instruments are create-once / update-many: components look their instruments
up by name once (``registry.counter(name)`` returns the same object for the
same name) and hold the reference across the hot loop.
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Dict, Optional, Sequence, Tuple

#: default latency buckets (seconds) for stage histograms: 0.1 ms .. 30 s,
#: roughly 3x apart - wide enough for both an in-memory cache hit and a
#: cold remote rowgroup read to land in a resolving bucket
DEFAULT_LATENCY_BUCKETS_S: Tuple[float, ...] = (
    0.0001, 0.0003, 0.001, 0.003, 0.01, 0.03, 0.1, 0.3, 1.0, 3.0, 10.0, 30.0)


class Counter:
    """Monotonic float/int counter (rows emitted, seconds blocked, ...)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def add(self, amount: float = 1.0) -> None:
        """Increment by ``amount`` (thread-safe)."""
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        """Current total."""
        return self._value


class Gauge:
    """Last-value instrument (queue depth, workers alive, ...)."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0

    def set(self, value: float) -> None:
        """Record the latest observation (a plain attribute store: a torn
        read can only observe an older value, which is exactly a gauge's
        contract)."""
        self._value = float(value)

    @property
    def value(self) -> float:
        """Most recently set value."""
        return self._value


class Histogram:
    """Fixed-bucket histogram (per-stage latency distributions).

    ``buckets`` are the upper bounds (inclusive) of each bucket, ascending;
    one implicit overflow bucket catches everything beyond the last bound.
    Fixed buckets keep ``record`` O(log n) with zero allocation - the shape
    never adapts, so snapshots from different workers/runs are mergeable.
    """

    __slots__ = ("name", "buckets", "_counts", "_sum", "_count", "_lock")

    def __init__(self, name: str,
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_S):
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError(f"histogram {name!r} needs ascending, non-empty"
                             f" buckets; got {buckets!r}")
        self.name = name
        self.buckets = tuple(float(b) for b in buckets)
        self._counts = [0] * (len(self.buckets) + 1)  # +1: overflow
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def record(self, value: float) -> None:
        """Count ``value`` into its bucket (thread-safe, O(log buckets))."""
        idx = bisect.bisect_left(self.buckets, value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1

    @property
    def count(self) -> int:
        """Total observations recorded."""
        return self._count

    @property
    def mean(self) -> float:
        """Mean of all recorded values (0 when empty)."""
        return self._sum / self._count if self._count else 0.0

    def quantile(self, q: float) -> float:
        """Approximate quantile: the upper bound of the bucket holding the
        q-th observation (the last finite bound for overflow entries)."""
        with self._lock:
            counts, total = list(self._counts), self._count
        if not total:
            return 0.0
        rank = q * total
        seen = 0
        for i, c in enumerate(counts):
            seen += c
            if seen >= rank:
                return self.buckets[min(i, len(self.buckets) - 1)]
        return self.buckets[-1]

    def snapshot(self) -> Dict:
        """Consistent copy: {buckets, counts, sum, count} (counts has one
        trailing overflow bucket beyond the last bound)."""
        with self._lock:
            return {"buckets": list(self.buckets),
                    "counts": list(self._counts),
                    "sum": self._sum,
                    "count": self._count}


class MetricsRegistry:
    """Name -> instrument map with get-or-create semantics.

    The registry lock guards only instrument CREATION; updates go through the
    per-instrument locks, so the hot path never contends on a global lock.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._t0 = time.perf_counter()

    def counter(self, name: str) -> Counter:
        """The counter named ``name`` (created on first use)."""
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(name))
        return c

    def gauge(self, name: str) -> Gauge:
        """The gauge named ``name`` (created on first use)."""
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(name))
        return g

    def histogram(self, name: str,
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        """The histogram named ``name`` (created on first use with
        ``buckets``, defaulting to DEFAULT_LATENCY_BUCKETS_S; bucket shape is
        fixed at creation - later calls return the existing instance)."""
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(
                    name, Histogram(name,
                                    buckets if buckets is not None
                                    else DEFAULT_LATENCY_BUCKETS_S))
        return h

    @property
    def uptime_s(self) -> float:
        """Seconds since this registry was created (the report's wall
        clock)."""
        return time.perf_counter() - self._t0

    def snapshot(self) -> Dict:
        """Point-in-time dict of every instrument (JSON-serializable)."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
        return {
            "uptime_s": self.uptime_s,
            "counters": {n: c.value for n, c in sorted(counters.items())},
            "gauges": {n: g.value for n, g in sorted(gauges.items())},
            "histograms": {n: h.snapshot()
                           for n, h in sorted(histograms.items())},
        }
