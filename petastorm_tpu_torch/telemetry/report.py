"""Human-readable bottleneck summary from a telemetry snapshot.

``render_pipeline_report`` is a pure function of ``Telemetry.snapshot()``
output, so a parent process can render a report from a child's JSON snapshot
(the benchmark CLI's ``--isolated`` mode) and tests can assert on stable
dict inputs rather than live registries.
"""

from __future__ import annotations

from typing import Dict, List

#: canonical pipeline order (SURVEY.md section 7).  Stages outside this list
#: (component-private sub-stages) render after the known ones.  ``service``
#: is the disaggregated-ingest client stage (result receive/decode for
#: ``make_reader(service_address=...)`` readers) - between ventilation and
#: the local decode path it replaces.
STAGE_ORDER = ("ventilate", "service", "decode", "transform",
               "host-assemble", "host-prep", "device-transfer")

#: queue-wait counters -> how the report explains them.  Queue-FULL waits
#: point the finger downstream (the stage after the queue is the bottleneck);
#: queue-EMPTY waits point upstream.
_QUEUE_WAITS = (
    ("queue.input_full_wait_s",
     "ventilator blocked on full input queue (workers saturated - healthy"
     " backpressure)"),
    ("queue.results_full_wait_s",
     "workers blocked on full results queue (consumer is the bottleneck)"),
    ("queue.results_empty_wait_s",
     "consumer starved on empty results queue (worker plane is the"
     " bottleneck)"),
)


def _stage_rows(snapshot: Dict) -> List[Dict]:
    counters = snapshot.get("counters", {})
    histograms = snapshot.get("histograms", {})
    names = {n.split(".", 2)[1] for n in counters
             if n.startswith("stage.") and n.endswith(".busy_s")}
    # stages registered ahead of their first execution
    # (Telemetry.register_stage, or a histogram minted by hedge_after='auto')
    # must still get a row - rendered as "no samples yet", never silently
    # omitted, so early --watch frames and short runs cannot misname the
    # dominant stage by eliding a late-starting one
    names |= {n.split(".", 2)[1] for n in histograms
              if n.startswith("stage.") and n.endswith(".latency_s")}
    ordered = [s for s in STAGE_ORDER if s in names]
    ordered += sorted(names - set(STAGE_ORDER))
    rows = []
    for stage in ordered:
        busy = counters.get(f"stage.{stage}.busy_s", 0.0)
        count = int(counters.get(f"stage.{stage}.count", 0))
        hist = histograms.get(f"stage.{stage}.latency_s")
        p50 = p99 = None
        if hist and hist.get("count"):
            p50 = _hist_quantile(hist, 0.5)
            p99 = _hist_quantile(hist, 0.99)
        rows.append({"stage": stage, "busy_s": busy, "count": count,
                     "mean_ms": (busy / count * 1e3) if count else 0.0,
                     "p50_s": p50, "p99_s": p99})
    return rows


def _hist_quantile(hist: Dict, q: float) -> float:
    total = hist["count"]
    rank = q * total
    seen = 0
    buckets = hist["buckets"]
    for i, c in enumerate(hist["counts"]):
        seen += c
        if seen >= rank:
            return buckets[min(i, len(buckets) - 1)]
    return buckets[-1]


def hist_quantile(hist: Dict, q: float) -> float:
    """Approximate quantile of a ``Histogram.snapshot()`` dict: the upper
    bound of the bucket holding the q-th observation (0.0 when empty).
    Public twin of the report's internal helper - the fleet aggregation
    plane derives per-worker and merged quantiles from wire-shipped
    snapshots with it."""
    if not hist or not hist.get("count"):
        return 0.0
    return _hist_quantile(hist, q)


def merge_hist_snapshots(snaps) -> Dict:
    """Merge fixed-bucket ``Histogram.snapshot()`` dicts element-wise.

    The registry's histograms use a fixed bucket shape precisely so
    snapshots from different processes are mergeable: counts add, sums
    add.  Snapshots whose bucket bounds differ from the first one's are
    skipped (a foreign/fuzzed frame must degrade coverage, not poison the
    merge).  Returns an empty-count snapshot when nothing merges.
    """
    buckets = None
    counts: List[int] = []
    total_sum = 0.0
    total_count = 0
    for snap in snaps:
        if not isinstance(snap, dict):
            continue
        b = snap.get("buckets")
        c = snap.get("counts")
        if not isinstance(b, (list, tuple)) or not isinstance(c, (list,
                                                                  tuple)):
            continue
        if buckets is None:
            buckets = list(b)
            counts = [0] * len(c)
        if list(b) != buckets or len(c) != len(counts):
            continue
        counts = [x + int(y) for x, y in zip(counts, c)]
        total_sum += float(snap.get("sum", 0.0))
        total_count += int(snap.get("count", 0))
    return {"buckets": buckets or [], "counts": counts,
            "sum": total_sum, "count": total_count}


def dominant_stage(snapshot: Dict) -> str:
    """Name of the stage with the most cumulative busy time ('' if none).
    Stages that are registered but have recorded no execution yet are not
    candidates - an early frame must say "nothing yet", not crown whichever
    zero-count stage happened to sort first."""
    rows = [r for r in _stage_rows(snapshot) if r["count"] > 0]
    if not rows:
        return ""
    return max(rows, key=lambda r: r["busy_s"])["stage"]


def render_pipeline_report(snapshot: Dict) -> str:
    """Render the stage-utilization / queue-time bottleneck summary."""
    wall = float(snapshot.get("uptime_s", 0.0)) or 1e-9
    counters = snapshot.get("counters", {})
    lines = ["== petastorm-tpu pipeline report ==",
             f"observed wall clock: {wall:.2f} s"]
    rows = _stage_rows(snapshot)
    if rows:
        lines.append(f"{'stage':<16} {'busy_s':>8} {'util%':>7} {'count':>7}"
                     f" {'mean_ms':>9} {'p50_ms':>8} {'p99_ms':>8}")
        for r in rows:
            if r["count"] == 0:
                # registered but not yet executed: a visible placeholder row
                # beats omission (the stage exists; it just hasn't run)
                lines.append(f"{r['stage']:<16} {'-':>8} {'-':>7} {'-':>7}"
                             f" {'-':>9} {'-':>8} {'-':>8}  (no samples yet)")
                continue
            p50 = f"{r['p50_s'] * 1e3:>8.1f}" if r["p50_s"] is not None else f"{'-':>8}"
            p99 = f"{r['p99_s'] * 1e3:>8.1f}" if r["p99_s"] is not None else f"{'-':>8}"
            lines.append(
                f"{r['stage']:<16} {r['busy_s']:>8.3f}"
                f" {100.0 * r['busy_s'] / wall:>6.1f}% {r['count']:>7d}"
                f" {r['mean_ms']:>9.2f} {p50} {p99}")
        sampled = [r for r in rows if r["count"] > 0]
        if sampled:
            best = max(sampled, key=lambda r: r["busy_s"])
            lines.append(
                f"dominant stage: {best['stage']}"
                f" ({best['busy_s']:.3f} s busy,"
                f" {100.0 * best['busy_s'] / wall:.1f}% of wall;"
                " util% can exceed 100 - stages run on parallel workers)")
        else:
            lines.append("dominant stage: (no samples yet)")
    else:
        lines.append("no stage samples recorded (telemetry enabled but no"
                     " instrumented work ran)")
    queue_lines = []
    for name, meaning in _QUEUE_WAITS:
        v = counters.get(name)
        if v:
            queue_lines.append(f"  {v:>8.3f} s  {meaning}")
    if queue_lines:
        lines.append("queue time:")
        lines.extend(queue_lines)
    # fault ledger: skipped/quarantined rowgroups, requeued work items,
    # transient-IO retries and liveness interventions (hung-worker kills,
    # hedges, circuit opens) get their own section - recurring weather must
    # be visible in the report, not only in scrolled-away log warnings
    faults = {n: v for n, v in counters.items()
              if n.startswith(("errors.", "io.retries", "liveness."))}
    if faults:
        lines.append("faults (skips / requeues / IO retries / liveness):")
        for n, v in sorted(faults.items()):
            lines.append(f"  {n} = {v:g}")
    interesting = {n: v for n, v in counters.items()
                   if not n.startswith(("stage.", "queue.", "errors.",
                                        "io.retries", "liveness."))}
    if interesting:
        lines.append("counters:")
        for n, v in sorted(interesting.items()):
            lines.append(f"  {n} = {v:g}")
    gauges = snapshot.get("gauges", {})
    if gauges:
        lines.append("gauges (last value):")
        for n, v in sorted(gauges.items()):
            lines.append(f"  {n} = {v:g}")
    return "\n".join(lines)
