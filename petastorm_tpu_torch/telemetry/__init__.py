"""Pipeline telemetry: metrics registry + stage spans + Chrome-trace export.

The port's copy of ``petastorm_tpu/telemetry/__init__.py:76-369``: the same
classes, series names, environment variables and Prometheus prefix, so a
snapshot, a scrape or a flight record of either package reads the same.

One ``Telemetry`` object observes a whole ingest pipeline (reader ->
executor pool -> decode workers -> ``cuda.CudaDataLoader``).  Components accept a
``telemetry=`` argument and thread it through construction; the default
resolves to the process-wide instance when ``PETASTORM_TPU_TELEMETRY=1`` is
set, else to ``NULL_TELEMETRY`` - a no-op recorder whose hot-path cost is a
single attribute check (``tele.enabled``), so the decode loop pays at most a
branch when telemetry is off.

Usage::

    from petastorm_tpu_torch import telemetry
    tele = telemetry.Telemetry()
    with make_reader(url, telemetry=tele) as reader:
        rows = list(reader)
    print(tele.pipeline_report())        # "dominant stage: decode ..."
    tele.export_chrome_trace("/tmp/ingest_trace.json")   # open in Perfetto

Instrumentation contract used across the repo::

    tele = self._telemetry
    if tele.enabled:                     # the only cost when disabled
        with tele.stage("decode", ordinal=n):
            result = fn(item)
    else:
        result = fn(item)

Stage timers feed three sinks at once: a ``stage.<name>.busy_s`` counter and
``stage.<name>.count`` (the pipeline report's utilization math), a
``stage.<name>.latency_s`` histogram (tail latency), and a trace span (the
Chrome timeline).  Process pools: the parent instruments ventilation and
queue waits; worker-side stage metrics recorded inside spawned worker
processes stay in those processes (the env var is inherited, so they record
independently) - use the thread pool when one merged report matters.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional, Sequence

from petastorm_tpu_torch.telemetry.registry import (DEFAULT_LATENCY_BUCKETS_S, Counter,
                                                    Gauge, Histogram, MetricsRegistry)
from petastorm_tpu_torch.telemetry.report import (STAGE_ORDER, dominant_stage,
                                                  render_pipeline_report)
from petastorm_tpu_torch.telemetry.trace import TraceBuffer

__all__ = [
    "Telemetry", "NullTelemetry", "NULL_TELEMETRY", "MetricsRegistry",
    "Counter", "Gauge", "Histogram", "TraceBuffer", "resolve", "enable",
    "enabled_from_env", "render_pipeline_report", "dominant_stage",
    "STAGE_ORDER", "DEFAULT_LATENCY_BUCKETS_S", "ENV_VAR", "NULL_CONTEXT",
    # live observability layer (imported lazily - see module __getattr__):
    # continuous sampling + flight recorder (telemetry.sampler) and the
    # Prometheus/JSONL export sinks (telemetry.export)
    "MetricsSampler", "flight_record", "dump_flight_record",
    "load_flight_records", "MetricsExportServer", "render_prometheus",
    "write_jsonl",
]

_LAZY = {
    "MetricsSampler": "petastorm_tpu_torch.telemetry.sampler",
    "flight_record": "petastorm_tpu_torch.telemetry.sampler",
    "dump_flight_record": "petastorm_tpu_torch.telemetry.sampler",
    "load_flight_records": "petastorm_tpu_torch.telemetry.sampler",
    "MetricsExportServer": "petastorm_tpu_torch.telemetry.export",
    "render_prometheus": "petastorm_tpu_torch.telemetry.export",
    "write_jsonl": "petastorm_tpu_torch.telemetry.export",
}


def __getattr__(name: str):
    # keep `import petastorm_tpu_torch.telemetry` free of http.server etc. on the
    # hot import path; the observability layer loads on first touch
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(target), name)

#: setting this to 1/true/yes/on enables the process-default recorder
ENV_VAR = "PETASTORM_TPU_TELEMETRY"


class _StageTimer:
    """Context manager recording one stage execution into counters, the
    latency histogram and the trace buffer (see module docstring)."""

    __slots__ = ("_tele", "_name", "_args", "_t0")

    def __init__(self, tele: "Telemetry", name: str, args: Optional[Dict]):
        self._tele = tele
        self._name = name
        self._args = args

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t0 = self._t0
        dur_ns = time.perf_counter_ns() - t0
        self._tele._record_stage(self._name, t0, dur_ns, self._args)
        return False


class _SpanTimer:
    """Context manager recording one trace span (no stage counters)."""

    __slots__ = ("_tele", "_name", "_cat", "_args", "_t0")

    def __init__(self, tele: "Telemetry", name: str, cat: str,
                 args: Optional[Dict]):
        self._tele = tele
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t0 = self._t0
        self._tele.trace.add(self._name, self._cat, t0,
                             time.perf_counter_ns() - t0, self._args)
        return False


class Telemetry:
    """The live recorder: a MetricsRegistry plus a TraceBuffer.

    Thread-safe throughout; one instance is shared by every component of a
    pipeline (and may be shared across pipelines for a process-wide view).
    """

    enabled = True

    def __init__(self, max_trace_events: int = 200_000):
        self.registry = MetricsRegistry()
        self.trace = TraceBuffer(max_events=max_trace_events)
        # per-stage [busy_ns, count] accumulators; mirrored into counters at
        # snapshot time would lose liveness, so they ARE counters directly
        self._stage_lock = threading.Lock()
        self._stage_hists: Dict[str, Histogram] = {}

    # -- instruments ----------------------------------------------------------

    def counter(self, name: str) -> Counter:
        """The counter named ``name`` (created on first use)."""
        return self.registry.counter(name)

    def gauge(self, name: str) -> Gauge:
        """The gauge named ``name`` (created on first use)."""
        return self.registry.gauge(name)

    def histogram(self, name: str,
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        """The histogram named ``name`` (created on first use; ``buckets``
        default to the stage-latency buckets)."""
        return self.registry.histogram(name, buckets)

    def register_stage(self, name: str) -> None:
        """Pre-create stage ``name``'s instruments (zero-valued counters +
        empty histogram) ahead of its first execution, so reports, the
        metrics sampler and ``diagnose --watch`` frames show the stage as
        "no samples yet" instead of omitting it - a short or just-started
        run must not misname the dominant stage by eliding a late-starting
        one.  Components that know their stages call this at construction
        (ventilator, reader, CUDA loader)."""
        self.registry.counter(f"stage.{name}.busy_s")
        self.registry.counter(f"stage.{name}.count")
        with self._stage_lock:
            self._stage_hists.setdefault(
                name, self.registry.histogram(f"stage.{name}.latency_s"))

    # -- spans / stage timers -------------------------------------------------

    def span(self, name: str, cat: str = "span", **args) -> _SpanTimer:
        """Trace-only span (shows on the Chrome timeline, no counters)."""
        return _SpanTimer(self, name, cat, args or None)

    def stage(self, name: str, **args) -> _StageTimer:
        """Span + busy-seconds counter + latency histogram for a pipeline
        stage (``ventilate``/``decode``/``transform``/``host-prep``/
        ``device-transfer``, or any component-private stage name)."""
        return _StageTimer(self, name, args or None)

    def record_stage(self, name: str, start_ns: int, dur_ns: int,
                     args: Optional[Dict] = None) -> None:
        """Record one stage execution with an explicit duration - for callers
        that must adjust the measured time (e.g. the ventilator subtracts
        queue-full wait so a blocked ``put`` is not mistaken for busy work);
        prefer ``stage()`` everywhere else."""
        self._record_stage(name, start_ns, dur_ns, args)

    def _record_stage(self, name: str, t0_ns: int, dur_ns: int,
                      args: Optional[Dict]) -> None:
        dur_s = dur_ns / 1e9
        self.registry.counter(f"stage.{name}.busy_s").add(dur_s)
        self.registry.counter(f"stage.{name}.count").add(1)
        hist = self._stage_hists.get(name)
        if hist is None:
            with self._stage_lock:
                hist = self._stage_hists.setdefault(
                    name, self.registry.histogram(f"stage.{name}.latency_s"))
        hist.record(dur_s)
        self.trace.add(name, "stage", t0_ns, dur_ns, args)

    # -- output ---------------------------------------------------------------

    def snapshot(self) -> Dict:
        """JSON-serializable point-in-time view of every instrument, plus
        trace-buffer accounting (``trace_events``/``trace_dropped``)."""
        snap = self.registry.snapshot()
        snap["trace_events"] = len(self.trace)
        snap["trace_dropped"] = self.trace.dropped
        return snap

    def pipeline_report(self) -> str:
        """Human-readable bottleneck summary (stage utilization, queue-full
        vs queue-empty time, dominant stage)."""
        return render_pipeline_report(self.snapshot())

    def chrome_trace(self) -> Dict:
        """Recorded spans in Chrome ``trace_event`` JSON (Perfetto-loadable)."""
        return self.trace.chrome_trace()

    def export_chrome_trace(self, path: str) -> str:
        """Write ``chrome_trace()`` JSON to ``path``; returns the path."""
        return self.trace.export_chrome_trace(path)


class _NullContext:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _NullInstrument:
    __slots__ = ()
    value = 0.0
    count = 0
    mean = 0.0

    def add(self, amount: float = 1.0) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def record(self, value: float) -> None:
        pass


_NULL_CTX = _NullContext()
#: shared do-nothing context manager: instrumented code paths that already
#: branched on ``tele.enabled`` can keep a single ``with`` statement
#: (``with tele.stage(...) if enabled else NULL_CONTEXT:``)
NULL_CONTEXT = _NULL_CTX
_NULL_INSTRUMENT = _NullInstrument()


class NullTelemetry:
    """The zero-cost disabled recorder (the default).

    Every method returns a shared no-op; instrumented hot loops guard with
    ``if tele.enabled:`` so the disabled path costs one attribute check and
    never allocates.
    """

    enabled = False

    def counter(self, name: str) -> _NullInstrument:
        """The shared no-op instrument."""
        return _NULL_INSTRUMENT

    def gauge(self, name: str) -> _NullInstrument:
        """The shared no-op instrument."""
        return _NULL_INSTRUMENT

    def histogram(self, name: str, buckets=None) -> _NullInstrument:
        """The shared no-op instrument."""
        return _NULL_INSTRUMENT

    def register_stage(self, name: str) -> None:
        """No-op."""

    def span(self, name: str, cat: str = "span", **args) -> _NullContext:
        """The shared do-nothing context manager."""
        return _NULL_CTX

    def stage(self, name: str, **args) -> _NullContext:
        """The shared do-nothing context manager."""
        return _NULL_CTX

    def record_stage(self, name: str, start_ns: int, dur_ns: int,
                     args: Optional[Dict] = None) -> None:
        """No-op."""

    def snapshot(self) -> Dict:
        """Always empty."""
        return {}

    def pipeline_report(self) -> str:
        """A pointer at how to enable telemetry."""
        return ("telemetry disabled - pass telemetry= to make_reader /"
                f" CudaDataLoader or set {ENV_VAR}=1")

    def chrome_trace(self) -> Dict:
        """An empty (but valid) Chrome trace object."""
        return {"traceEvents": []}

    def export_chrome_trace(self, path: str) -> str:
        """Write the empty trace to ``path`` (keeps CLI flows uniform)."""
        import json

        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path


NULL_TELEMETRY = NullTelemetry()

_default_lock = threading.Lock()
_default: Optional[Telemetry] = None


def enabled_from_env() -> bool:
    """True when ``PETASTORM_TPU_TELEMETRY`` opts this process in."""
    return os.environ.get(ENV_VAR, "").strip().lower() in ("1", "true", "yes",
                                                           "on")


def enable() -> Telemetry:
    """The process-default live recorder (created on first use).  Spawned
    worker processes inherit the env var and create their own."""
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = Telemetry()
    return _default


def resolve(telemetry=None):
    """Normalize a component's ``telemetry=`` argument to a recorder.

    ``None`` -> the process default when ``PETASTORM_TPU_TELEMETRY=1``, else
    the no-op recorder; ``True``/``False`` -> process default / no-op
    explicitly; a ``Telemetry`` (or compatible) instance passes through.
    The env var is re-read on every call, so setting it after import works.
    """
    if telemetry is None:
        return enable() if enabled_from_env() else NULL_TELEMETRY
    if telemetry is True:
        return enable()
    if telemetry is False:
        return NULL_TELEMETRY
    return telemetry
