"""Continuous metrics sampling: a time-series ring buffer over a Telemetry.

The registry answers "what happened" (cumulative counters); a production
ingest serving long epochs needs "what is happening NOW" and "what was
happening right before it died" (tf.data's input-pipeline analyzer samples
continuously for exactly this reason - PAPERS.md, arxiv 2101.12127 section 4).
This module adds both:

* :class:`MetricsSampler` - a background daemon thread that snapshots the
  registry every ``interval_s`` (default 1 s) into a bounded ring of
  time-series points: counter deltas become per-second **rates**, gauges keep
  their **last value**, and stage latency histograms yield **per-interval
  p50/p99** (quantiles of only the executions that landed in that interval,
  not the run-so-far blur).  One snapshot per second over a few hundred
  instruments is microseconds of work - cheap enough to leave on in
  production.
* the **flight recorder** (:func:`flight_record` / :func:`dump_flight_record`)
  - on a terminal pipeline failure the last ``window_s`` of sampled series
  plus the tail of the trace buffer are serialized, so the crash artifact
  carries the throughput/queue-depth/stall curves leading INTO the failure,
  not just final counters.  The reader wires this to ``PipelineStallError``,
  terminal ``WorkerError``, ``ErrorBudgetExceededError`` and circuit-open
  aborts (``make_reader(flight_record_path=)`` /
  ``PETASTORM_TPU_FLIGHT_RECORD=``).

Sample-point schema (plain JSON-serializable dicts)::

    {"t": <registry uptime_s>,      # sample time on the report's wall clock
     "wall_time": <time.time()>,    # absolute, for cross-process alignment
     "dt_s": <measured interval>,
     "counters": {name: total},     # raw cumulative totals
     "rates": {name: (total - prev)/dt},         # per-second
     "gauges": {name: last_value},
     "stages": {name: {"count": total, "rate_per_s": ..., "busy_frac": ...,
                       "p50_s": ..., "p99_s": ...}}}   # p50/p99 None when the
                                                       # interval saw no op
"""

from __future__ import annotations

import collections
import json
import logging
import threading
import time
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)

#: default sampling interval; overridable per reader
#: (``make_reader(sample_interval_s=)``) or process-wide via
#: ``PETASTORM_TPU_SAMPLE_INTERVAL_S``
DEFAULT_INTERVAL_S = 1.0

#: default ring capacity: 10 minutes of 1 s points
DEFAULT_MAX_POINTS = 600

#: default flight-recorder window (seconds of sampled series kept)
DEFAULT_FLIGHT_WINDOW_S = 60.0

#: default trace-tail length carried by a flight record
DEFAULT_TRACE_TAIL = 200


def _delta_hist_quantile(prev: Optional[Dict], cur: Dict, q: float
                         ) -> Optional[float]:
    """Quantile of the observations recorded BETWEEN two histogram snapshots
    (fixed buckets make snapshots subtractable); None when the interval saw
    none."""
    counts = cur["counts"]
    if prev is not None:
        counts = [c - p for c, p in zip(counts, prev["counts"])]
    total = sum(counts)
    if total <= 0:
        return None
    buckets = cur["buckets"]
    rank = q * total
    seen = 0
    for i, c in enumerate(counts):
        seen += c
        if seen >= rank:
            return buckets[min(i, len(buckets) - 1)]
    return buckets[-1]


class MetricsSampler:
    """Background thread sampling a Telemetry registry into a bounded ring.

    Thread-safe throughout: the sampling thread appends, any thread may read
    (``series``/``latest``/``tail``) or force an immediate sample
    (``sample_now`` - used by the flight recorder to flush the trailing
    partial interval up to the failure moment).  A sampler over a disabled
    (Null) recorder is inert: ``start()`` is a no-op and every read returns
    empty.
    """

    def __init__(self, telemetry, interval_s: float = DEFAULT_INTERVAL_S,
                 max_points: int = DEFAULT_MAX_POINTS):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s!r}")
        if max_points < 1:
            raise ValueError(f"max_points must be >= 1, got {max_points!r}")
        self.telemetry = telemetry
        self.interval_s = float(interval_s)
        self._points: "collections.deque" = collections.deque(
            maxlen=max_points)
        self._lock = threading.Lock()
        self._stop_event = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._prev: Optional[Dict] = None       # previous snapshot
        self._prev_wall = 0.0

    @property
    def enabled(self) -> bool:
        """False over a Null recorder (nothing to sample)."""
        return bool(getattr(self.telemetry, "enabled", False))

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        """Start the sampling thread (idempotent; no-op when disabled).  The
        baseline snapshot is taken here, so the first point covers the first
        full interval."""
        if not self.enabled or self._thread is not None:
            return
        self._prev = self.telemetry.snapshot()
        self._prev_wall = time.time()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name="petastorm-tpu-metrics-sampler")
        self._thread.start()

    def stop(self) -> None:
        """Stop the sampling thread (idempotent; bounded join)."""
        self._stop_event.set()
        t = self._thread
        if t is not None:
            t.join(timeout=max(2.0, 2 * self.interval_s))
            self._thread = None

    def _run(self) -> None:
        while not self._stop_event.wait(self.interval_s):
            try:
                self.sample_now()
            except Exception:  # noqa: BLE001 - observability must not crash
                logger.warning("metrics sampler tick failed", exc_info=True)

    # -- sampling -------------------------------------------------------------

    def sample_now(self) -> Optional[Dict]:
        """Take one sample immediately and append it to the ring; returns the
        point (None when disabled, not yet started, or the elapsed interval
        is too small to yield meaningful rates)."""
        if not self.enabled:
            return None
        with self._lock:
            prev, prev_wall = self._prev, self._prev_wall
            if prev is None:    # start() not called: establish the baseline
                self._prev = self.telemetry.snapshot()
                self._prev_wall = time.time()
                return None
            cur = self.telemetry.snapshot()
            wall = time.time()
            dt = wall - prev_wall
            if dt < 1e-3:       # sample_now raced the timer tick: skip
                return None
            point = self._build_point(prev, cur, dt, wall)
            self._prev, self._prev_wall = cur, wall
            self._points.append(point)
        return point

    @staticmethod
    def _build_point(prev: Dict, cur: Dict, dt: float, wall: float) -> Dict:
        prev_counters = prev.get("counters", {})
        counters = cur.get("counters", {})
        rates = {n: max(v - prev_counters.get(n, 0.0), 0.0) / dt
                 for n, v in counters.items()}
        prev_hists = prev.get("histograms", {})
        stages: Dict[str, Dict] = {}
        hops: Dict[str, Dict] = {}
        for n, hist in cur.get("histograms", {}).items():
            if n.startswith("service.hop."):
                # per-hop latency decomposition of traced service items:
                # same per-interval quantile treatment as stages, its own
                # section (hops are legs of one item, not pipeline stages)
                hops[n[len("service.hop."):]] = {
                    "count": int(hist.get("count", 0)),
                    "p50_s": _delta_hist_quantile(prev_hists.get(n), hist,
                                                  0.5),
                    "p99_s": _delta_hist_quantile(prev_hists.get(n), hist,
                                                  0.99),
                }
                continue
            if not (n.startswith("stage.") and n.endswith(".latency_s")):
                continue
            stage = n.split(".", 2)[1]
            stages[stage] = {
                "count": int(counters.get(f"stage.{stage}.count", 0)),
                "rate_per_s": rates.get(f"stage.{stage}.count", 0.0),
                "busy_frac": rates.get(f"stage.{stage}.busy_s", 0.0),
                "p50_s": _delta_hist_quantile(prev_hists.get(n), hist, 0.5),
                "p99_s": _delta_hist_quantile(prev_hists.get(n), hist, 0.99),
            }
        # counters already registered as stages render via ``stages``; keep
        # the raw maps complete anyway (flight-record analysis wants totals)
        point = {"t": float(cur.get("uptime_s", 0.0)),
                 "wall_time": wall,
                 "dt_s": dt,
                 "counters": dict(counters),
                 "rates": rates,
                 "gauges": dict(cur.get("gauges", {})),
                 "stages": stages}
        if hops:
            point["hops"] = hops
        return point

    # -- reads ----------------------------------------------------------------

    def series(self) -> List[Dict]:
        """All buffered points, oldest first (a copy)."""
        with self._lock:
            return list(self._points)

    def latest(self) -> Optional[Dict]:
        """The most recent point, or None."""
        with self._lock:
            return self._points[-1] if self._points else None

    def tail(self, seconds: float) -> List[Dict]:
        """Points from the last ``seconds`` of the series (by sample time)."""
        with self._lock:
            points = list(self._points)
        if not points:
            return []
        cutoff = points[-1]["t"] - float(seconds)
        return [p for p in points if p["t"] >= cutoff]

    def __len__(self) -> int:
        with self._lock:
            return len(self._points)


# -- flight recorder ----------------------------------------------------------

def flight_record(sampler: MetricsSampler, reason: str = "",
                  window_s: float = DEFAULT_FLIGHT_WINDOW_S,
                  trace_tail: int = DEFAULT_TRACE_TAIL,
                  fleet_events: Optional[List[Dict]] = None) -> Dict:
    """Capture the last ``window_s`` of sampled series plus the trace tail.

    Called at the moment of a terminal pipeline failure (the reader wires
    this into its stall-abort / worker-error / budget-exhaustion paths); a
    final ``sample_now()`` flushes the partial interval so the series reaches
    the failure moment.  ``fleet_events`` (optional) carries the dispatcher's
    structured event tail fetched at failure time, so one artifact holds the
    local curves AND the fleet's last minute of promotions / requeues /
    autoscale decisions.  Returns a JSON-serializable record::

        {"reason", "wall_time", "window_s", "interval_s",
         "points": [<sample points>...],
         "final": <full Telemetry.snapshot()>,
         "trace_tail": [<last spans, TraceBuffer.tail schema>...],
         "fleet_events": [<dispatcher event dicts>...]}   # may be empty
    """
    sampler.sample_now()
    tele = sampler.telemetry
    trace = getattr(tele, "trace", None)
    return {
        "reason": reason,
        "wall_time": time.time(),
        "window_s": float(window_s),
        "interval_s": sampler.interval_s,
        "points": sampler.tail(window_s),
        "final": tele.snapshot(),
        "trace_tail": trace.tail(trace_tail) if trace is not None else [],
        "fleet_events": list(fleet_events or []),
    }


def dump_flight_record(record: Dict, path: str) -> str:
    """Append ``record`` to ``path`` as JSONL; returns the path.

    One header line (``kind='flight_recorder'``: reason, window, interval),
    one ``kind='point'`` line per sampled point, one ``kind='final_snapshot'``
    line, one ``kind='trace_event'`` line per trace span, then one
    ``kind='fleet_event'`` line per dispatcher event (when the record carries
    a fleet tail).  Append mode:
    a long-lived job that crashes repeatedly accumulates one record per
    incident in the same artifact (header ``wall_time`` separates them).
    """
    with open(path, "a") as f:
        header = {k: record[k] for k in ("reason", "wall_time", "window_s",
                                         "interval_s")}
        header["kind"] = "flight_recorder"
        header["points"] = len(record["points"])
        f.write(json.dumps(header) + "\n")
        for point in record["points"]:
            f.write(json.dumps({"kind": "point", **point}) + "\n")
        f.write(json.dumps({"kind": "final_snapshot",
                            "snapshot": record["final"]}) + "\n")
        for event in record.get("trace_tail", []):
            f.write(json.dumps({"kind": "trace_event", **event}) + "\n")
        for event in record.get("fleet_events", []):
            # nested: dispatcher events carry their OWN "kind" field (the
            # event type), which must not collide with the line discriminator
            f.write(json.dumps({"kind": "fleet_event", "event": event})
                    + "\n")
    return path


def load_flight_records(path: str) -> List[Dict]:
    """Parse a :func:`dump_flight_record` JSONL back into record dicts
    (``points``/``final``/``trace_tail`` re-nested), newest last - the
    post-mortem half of the flight-recorder round trip."""
    records: List[Dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            kind = obj.pop("kind", None)
            if kind == "flight_recorder":
                obj.pop("points", None)
                records.append({**obj, "points": [], "final": {},
                                "trace_tail": [], "fleet_events": []})
            elif not records:
                continue        # tolerate a truncated/foreign prefix
            elif kind == "point":
                records[-1]["points"].append(obj)
            elif kind == "final_snapshot":
                records[-1]["final"] = obj.get("snapshot", {})
            elif kind == "trace_event":
                records[-1]["trace_tail"].append(obj)
            elif kind == "fleet_event":
                records[-1]["fleet_events"].append(obj.get("event", obj))
    return records
