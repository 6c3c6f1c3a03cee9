"""Metrics export: Prometheus text exposition + JSONL push sink.

The port's copy of ``petastorm_tpu/telemetry/export.py:53-421``, with the
same metric names and text.  ``render_fleet_prometheus`` (the ingest
service's fleet families) comes with the service.

Pull: :class:`MetricsExportServer` serves ``GET /metrics`` in Prometheus
text-exposition format (version 0.0.4) from a stdlib ``http.server`` thread
bound to **localhost only** by default - the pipeline's counters, gauges,
per-stage cumulative totals/quantiles and (when a sampler is attached)
per-interval stage rates and p50/p99, including the ``errors.*`` /
``liveness.*`` fault counters.  Wired into readers via
``make_reader(metrics_port=)`` / ``PETASTORM_TPU_METRICS_PORT=`` (``0`` =
ephemeral; the bound port is ``reader.metrics_server.port``).

Push: :func:`write_jsonl` appends sampled points to a JSONL file for
airgapped runs where nothing can scrape.

Name mapping (mechanical, stable - the golden test pins it):

* counter ``errors.skipped_rowgroups`` ->
  ``petastorm_tpu_errors_skipped_rowgroups_total``
* gauge ``pool.results_queue_depth`` ->
  ``petastorm_tpu_pool_results_queue_depth``
* stage instruments fold into labeled families:
  ``petastorm_tpu_stage_busy_seconds_total{stage="decode"}``,
  ``petastorm_tpu_stage_ops_total{stage="decode"}``,
  ``petastorm_tpu_stage_latency_seconds{stage="decode",quantile="0.99"}``
  (cumulative), plus - with a sampler -
  ``petastorm_tpu_stage_rate_per_second{stage=...}`` and
  ``petastorm_tpu_stage_interval_latency_seconds{stage=...,quantile=...}``
  over the last sampled interval.
"""

from __future__ import annotations

import json
import logging
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Iterable, List, Optional

from petastorm_tpu_torch.telemetry.report import _hist_quantile

logger = logging.getLogger(__name__)

PREFIX = "petastorm_tpu"
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")
_STAGE_RE = re.compile(r"^stage\.([^.]+)\.(busy_s|count|latency_s)$")
_HOP_RE = re.compile(r"^service\.hop\.([^.]+)$")
_LABEL_RE = re.compile(r"[^a-zA-Z0-9_\-.:@]")


def _sanitize(name: str) -> str:
    return _NAME_RE.sub("_", name)


def _fmt(value: float) -> str:
    # integers print bare (Prometheus accepts either; bare ints are stable)
    if float(value) == int(value):
        return str(int(value))
    return repr(float(value))


def render_prometheus(snapshot: Dict,
                      sampler_point: Optional[Dict] = None) -> str:
    """Render a ``Telemetry.snapshot()`` (plus an optional sampler point for
    per-interval stage rates) as Prometheus text exposition.  Pure function
    of its inputs; ordering is deterministic so the format can be golden-
    tested."""
    lines: List[str] = []

    def family(name: str, mtype: str, help_text: str,
               samples: Iterable) -> None:
        rendered = list(samples)
        if not rendered:
            return
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {mtype}")
        lines.extend(rendered)

    family(f"{PREFIX}_uptime_seconds", "gauge",
           "Seconds since this pipeline's telemetry registry was created.",
           [f"{PREFIX}_uptime_seconds "
            f"{_fmt(float(snapshot.get('uptime_s', 0.0)))}"])

    counters = snapshot.get("counters", {})
    stage_busy: Dict[str, float] = {}
    stage_count: Dict[str, float] = {}
    plain_counters: Dict[str, float] = {}
    for name, value in counters.items():
        m = _STAGE_RE.match(name)
        if m and m.group(2) == "busy_s":
            stage_busy[m.group(1)] = value
        elif m and m.group(2) == "count":
            stage_count[m.group(1)] = value
        else:
            plain_counters[name] = value

    for name in sorted(plain_counters):
        metric = f"{PREFIX}_{_sanitize(name)}_total"
        family(metric, "counter", f"Cumulative total of {name}.",
               [f"{metric} {_fmt(plain_counters[name])}"])

    gauges = snapshot.get("gauges", {})
    for name in sorted(gauges):
        metric = f"{PREFIX}_{_sanitize(name)}"
        family(metric, "gauge", f"Last observed value of {name}.",
               [f"{metric} {_fmt(gauges[name])}"])

    histograms = snapshot.get("histograms", {})
    stage_hists = {}
    hop_hists = {}
    for name, hist in histograms.items():
        m = _STAGE_RE.match(name)
        hm = _HOP_RE.match(name)
        if m and m.group(2) == "latency_s":
            stage_hists[m.group(1)] = hist
        elif hm:
            hop_hists[hm.group(1)] = hist
        else:
            metric = f"{PREFIX}_{_sanitize(name)}"
            family(metric, "summary", f"Distribution of {name}.",
                   [f"{metric}{{quantile=\"0.5\"}} "
                    f"{_fmt(_hist_quantile(hist, 0.5) if hist['count'] else 0)}",
                    f"{metric}{{quantile=\"0.99\"}} "
                    f"{_fmt(_hist_quantile(hist, 0.99) if hist['count'] else 0)}",
                    f"{metric}_sum {_fmt(hist['sum'])}",
                    f"{metric}_count {_fmt(hist['count'])}"])

    stages = sorted(set(stage_busy) | set(stage_count) | set(stage_hists))
    if stages:
        family(f"{PREFIX}_stage_busy_seconds_total", "counter",
               "Cumulative busy seconds per pipeline stage.",
               [f"{PREFIX}_stage_busy_seconds_total{{stage=\"{s}\"}} "
                f"{_fmt(stage_busy.get(s, 0.0))}" for s in stages])
        family(f"{PREFIX}_stage_ops_total", "counter",
               "Cumulative executions per pipeline stage.",
               [f"{PREFIX}_stage_ops_total{{stage=\"{s}\"}} "
                f"{_fmt(stage_count.get(s, 0.0))}" for s in stages])
        q_samples = []
        for s in stages:
            hist = stage_hists.get(s)
            if not hist or not hist.get("count"):
                continue
            for q in (0.5, 0.99):
                q_samples.append(
                    f"{PREFIX}_stage_latency_seconds"
                    f"{{stage=\"{s}\",quantile=\"{q}\"}} "
                    f"{_fmt(_hist_quantile(hist, q))}")
        family(f"{PREFIX}_stage_latency_seconds", "gauge",
               "Cumulative stage latency quantiles (fixed-bucket upper"
               " bounds).", q_samples)

    if hop_hists:
        # per-hop trace latency decomposition folds into one labeled family
        # (same pattern as stages) rather than N generic summaries
        hq_samples = []
        hc_samples = []
        for h in sorted(hop_hists):
            hist = hop_hists[h]
            hc_samples.append(
                f"{PREFIX}_service_hop_ops_total{{hop=\"{h}\"}} "
                f"{_fmt(hist.get('count', 0))}")
            if not hist.get("count"):
                continue
            for q in (0.5, 0.99):
                hq_samples.append(
                    f"{PREFIX}_service_hop_latency_seconds"
                    f"{{hop=\"{h}\",quantile=\"{q}\"}} "
                    f"{_fmt(_hist_quantile(hist, q))}")
        family(f"{PREFIX}_service_hop_ops_total", "counter",
               "Traced items observed per service hop.", hc_samples)
        family(f"{PREFIX}_service_hop_latency_seconds", "gauge",
               "Per-hop latency quantiles of traced service items"
               " (fixed-bucket upper bounds).", hq_samples)

    if sampler_point:
        point_stages = sorted(sampler_point.get("stages", {}))
        family(f"{PREFIX}_stage_rate_per_second", "gauge",
               "Stage executions per second over the last sampled interval.",
               [f"{PREFIX}_stage_rate_per_second{{stage=\"{s}\"}} "
                f"{_fmt(sampler_point['stages'][s]['rate_per_s'])}"
                for s in point_stages])
        iq_samples = []
        for s in point_stages:
            for q, key in ((0.5, "p50_s"), (0.99, "p99_s")):
                v = sampler_point["stages"][s][key]
                if v is None:
                    continue
                iq_samples.append(
                    f"{PREFIX}_stage_interval_latency_seconds"
                    f"{{stage=\"{s}\",quantile=\"{q}\"}} {_fmt(v)}")
        family(f"{PREFIX}_stage_interval_latency_seconds", "gauge",
               "Stage latency quantiles over the last sampled interval.",
               iq_samples)
        hop_point = sampler_point.get("hops", {})
        hiq_samples = []
        for h in sorted(hop_point):
            for q, key in ((0.5, "p50_s"), (0.99, "p99_s")):
                v = hop_point[h].get(key)
                if v is None:
                    continue
                hiq_samples.append(
                    f"{PREFIX}_service_hop_interval_latency_seconds"
                    f"{{hop=\"{h}\",quantile=\"{q}\"}} {_fmt(v)}")
        family(f"{PREFIX}_service_hop_interval_latency_seconds", "gauge",
               "Per-hop latency quantiles over the last sampled interval.",
               hiq_samples)
        family(f"{PREFIX}_sample_interval_seconds", "gauge",
               "Measured length of the last sampled interval.",
               [f"{PREFIX}_sample_interval_seconds "
                f"{_fmt(sampler_point.get('dt_s', 0.0))}"])

    return "\n".join(lines) + "\n"


class MetricsExportServer:
    """Localhost-only ``/metrics`` pull endpoint on a daemon thread.

    ``port=0`` binds an ephemeral port (read it back via ``.port`` after
    ``start()``).  The handler renders a fresh snapshot per scrape - there
    is no caching, matching the one-scraper-per-host pattern; rendering is
    microseconds for a few hundred instruments.  ``stop()`` shuts the
    listener down; in-flight requests finish (daemon threads).
    """

    def __init__(self, telemetry, sampler=None, port: int = 0,
                 host: str = "127.0.0.1", extra=None):
        self.telemetry = telemetry
        self.sampler = sampler
        #: optional zero-arg callable returning extra exposition text to
        #: append per scrape (the dispatcher's fleet families); a failure
        #: there degrades the scrape to local metrics, never a 500
        self.extra = extra
        self.host = host
        self._requested_port = int(port)
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._bound_port: Optional[int] = None

    @property
    def port(self) -> Optional[int]:
        """The bound port (None before ``start()``; survives ``stop()`` so
        post-mortem diagnostics still name the port that was serving)."""
        return self._bound_port

    def start(self) -> int:
        """Bind and start serving; returns the bound port.  Idempotent."""
        if self._server is not None:
            return self.port
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            server_version = "petastorm-tpu-metrics/1"

            def do_GET(self):  # noqa: N802 - http.server API
                if self.path.split("?", 1)[0] not in ("/metrics", "/"):
                    self.send_error(404, "only /metrics is served")
                    return
                try:
                    point = (outer.sampler.latest()
                             if outer.sampler is not None else None)
                    body = render_prometheus(outer.telemetry.snapshot(),
                                             sampler_point=point)
                except Exception:  # noqa: BLE001 - a scrape must not crash
                    logger.warning("metrics render failed", exc_info=True)
                    self.send_error(500, "metrics render failed")
                    return
                if outer.extra is not None:
                    try:
                        body += outer.extra() or ""
                    except Exception:  # noqa: BLE001
                        logger.warning("extra metrics render failed",
                                       exc_info=True)
                payload = body.encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def log_message(self, fmt, *args):  # quiet: scrapes are routine
                logger.debug("metrics endpoint: " + fmt, *args)

        server = ThreadingHTTPServer((self.host, self._requested_port),
                                     _Handler)
        server.daemon_threads = True
        self._server = server
        self._bound_port = server.server_address[1]
        self._thread = threading.Thread(target=server.serve_forever,
                                        daemon=True,
                                        name="petastorm-tpu-metrics-export")
        self._thread.start()
        logger.info("metrics endpoint serving on http://%s:%d/metrics",
                    self.host, self.port)
        return self.port

    def stop(self) -> None:
        """Shut the listener down (idempotent)."""
        server, self._server = self._server, None
        if server is not None:
            server.shutdown()
            server.server_close()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)


def write_jsonl(points: Iterable[Dict], path: str) -> str:
    """Append sampled points (``MetricsSampler.series()`` / ``.tail()``) to
    ``path`` as one JSON object per line - the push sink for airgapped runs
    where no scraper can reach the pull endpoint.  Returns the path."""
    with open(path, "a") as f:
        for point in points:
            f.write(json.dumps(point) + "\n")
    return path
