"""``petastorm-tpu-torch-diagnose``: one-command pipeline bottleneck diagnosis.

Counterpart of ``petastorm_tpu/tools/diagnose.py``.  Runs a short
telemetered read over a dataset (or a generated synthetic one) and prints
the ``pipeline_report()`` bottleneck summary - which stage (ventilate /
decode / transform) dominates, and whether queue time points at the worker
plane or the consumer.  Optionally exports the run's span timeline as Chrome
``trace_event`` JSON for Perfetto.

``--watch`` switches to live mode: the read runs in the background while a
``top``-style view refreshes every ``--interval`` seconds from the reader's
metrics sampler - per-stage rates and interval p50/p99, queue depths,
queue-wait rates, faults/liveness interventions, and the interval's dominant
stage.  ``--duration S`` bounds the capture (the read stops cleanly after S
seconds); ``--metrics-port`` additionally serves the Prometheus endpoint for
the run's lifetime.

Examples::

    petastorm-tpu-torch-diagnose file:///data/imagenet --pool-type thread -w 4
    petastorm-tpu-torch-diagnose --synthetic --trace-out /tmp/trace.json
    petastorm-tpu-torch-diagnose file:///data/imagenet --watch --duration 30
    python -m petastorm_tpu_torch.tools.diagnose --synthetic --json

It drives the reader and pool plane only (no torch device work), so it runs
on any host.  For the device feed, pass ``telemetry=`` to
``cuda.CudaDataLoader`` (its stages join the same report).
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional

from petastorm_tpu_torch.errors import ReaderClosedError
from petastorm_tpu_torch.telemetry import Telemetry, dominant_stage
from petastorm_tpu_torch.telemetry.report import STAGE_ORDER


def _positive_seconds(value: str) -> float:
    """argparse type for strictly-positive second values (an interval of 0
    would busy-spin the watch loop and disable the reader's sampler)."""
    parsed = float(value)
    if parsed <= 0:
        raise argparse.ArgumentTypeError(
            f"must be a positive number of seconds, got {value!r}")
    return parsed


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="petastorm-tpu-torch-diagnose",
        description="Run a short telemetered read and print the pipeline"
                    " bottleneck report")
    parser.add_argument("dataset_url", nargs="?", default=None,
                        help="dataset to read (omit with --synthetic)")
    parser.add_argument("--synthetic", action="store_true",
                        help="generate a small synthetic dataset in a temp"
                             " dir (default when no dataset_url is given)")
    parser.add_argument("--rows", type=int, default=200,
                        help="synthetic dataset size (--synthetic)")
    parser.add_argument("--row-group-size", type=int, default=20,
                        help="synthetic rowgroup size (--synthetic)")
    parser.add_argument("--method", default="batch", choices=("batch", "row"),
                        help="batch=make_batch_reader (columnar),"
                             " row=make_reader")
    parser.add_argument("-p", "--pool-type", default="thread",
                        choices=("thread", "process", "serial"))
    parser.add_argument("-w", "--workers-count", type=int, default=3)
    parser.add_argument("--num-epochs", type=int, default=1)
    parser.add_argument("--max-batches", type=int, default=0,
                        help="stop after N rowgroup batches (0 = read all)")
    parser.add_argument("--trace-out", metavar="PATH", default=None,
                        help="write the run's Chrome trace_event JSON here"
                             " (open in Perfetto / chrome://tracing)")
    parser.add_argument("--json", action="store_true",
                        help="print the raw telemetry snapshot as JSON"
                             " instead of the human-readable report")
    parser.add_argument("--chaos", metavar="SPEC", default=None,
                        help="diagnose under injected faults"
                             " (test_util.chaos.ChaosSpec.parse syntax,"
                             " e.g. 'decode_fail_rate=0.05,"
                             "fail_first_reads=3')")
    parser.add_argument("--on-error", default="raise",
                        choices=("raise", "skip"),
                        help="reader failure policy; 'skip' quarantines"
                             " failing rowgroups (listed in the report)")
    parser.add_argument("--item-deadline", type=float, default=None,
                        metavar="S",
                        help="liveness: SIGKILL+respawn (process pool) or"
                             " abandon (thread pool) a worker hung on one"
                             " item for S seconds; the item is requeued")
    from petastorm_tpu_torch.pool import parse_hedge_after

    parser.add_argument("--hedge-after", default=None, metavar="S|auto",
                        type=parse_hedge_after,
                        help="liveness: speculatively re-issue an item"
                             " running longer than S seconds to an idle"
                             " worker ('auto' = 4x telemetry decode p99)")
    parser.add_argument("--watch", action="store_true",
                        help="live mode: refresh a top-style per-stage"
                             " rate/latency/queue view every --interval"
                             " seconds while the read runs (Ctrl-C stops)")
    parser.add_argument("--interval", type=_positive_seconds, default=1.0,
                        metavar="S",
                        help="sampling + refresh interval for --watch and"
                             " the reader's metrics sampler (default 1s;"
                             " must be > 0)")
    parser.add_argument("--duration", type=float, default=None, metavar="S",
                        help="stop the read cleanly after S seconds (bounded"
                             " capture; mostly with --watch)")
    parser.add_argument("--metrics-port", type=int, default=None, metavar="N",
                        help="serve the run's metrics in Prometheus text"
                             " format on localhost:N for the run's lifetime"
                             " (0 = ephemeral; the bound port is printed)")
    parser.add_argument("--flight-record", metavar="PATH", default=None,
                        help="on a terminal failure, dump the flight record"
                             " (sampled series + trace tail) to PATH as"
                             " JSONL")
    parser.add_argument("--autotune", action="store_true",
                        help="run the closed-loop knob tuner during the read"
                             " (petastorm_tpu_torch.autotune): workers /"
                             " results-queue bound adapt to the live metrics"
                             " sampler; the report lists every decision and"
                             " --watch frames show the autotune.* counters")
    parser.add_argument("--cache-type", default="null",
                        choices=("null", "memory", "local-disk", "shared"),
                        help="decoded-rowgroup cache (docs/operations.md"
                             " 'Warm cache'); 'shared' = the host-wide warm"
                             " tier - --watch then renders a live cache:"
                             " hit/miss/hit-rate line, and re-running the"
                             " command shows the warm profile")
    parser.add_argument("--cache-location", default=None, metavar="PATH",
                        help="names the cache tier (same location = same"
                             " shared tier host-wide; also the disk"
                             " directory)")
    parser.add_argument("--seed", type=int, default=None, metavar="N",
                        help="shuffle the read with this seed (enables"
                             " shuffle_row_groups and, via"
                             " deterministic='auto', seed-stable delivery)")
    parser.add_argument("--deterministic", default="auto",
                        choices=("auto", "seed", "off"),
                        help="delivery-order mode (docs/operations.md"
                             " 'Reproducibility'): 'seed' releases batches"
                             " in plan order so the stream digest is"
                             " bit-identical across configurations")
    parser.add_argument("--service-address", default=None,
                        metavar="HOST:PORT",
                        help="read through the disaggregated ingest service"
                        " at this dispatcher instead of a local pool"
                        " (failover list 'a:p,b:p' accepted)")
    parser.add_argument("--trace-items", type=int, default=None, metavar="N",
                        help="arm per-item DISTRIBUTED tracing on the"
                        " service plane: every Nth item carries a trace"
                        " context through client/dispatcher/worker; the"
                        " merged cross-process timeline lands in"
                        " --trace-out and the service.hop.* decomposition"
                        " renders in --watch (needs --service-address;"
                        " default off)")
    parser.add_argument("--stream-digest", action="store_true",
                        help="print the run's stream certificate as a"
                             " machine-parseable 'stream_digest ...' line -"
                             " run twice (any worker count / pool / chaos)"
                             " and diff the lines to verify seed-stable"
                             " delivery; also under --json")
    return parser


def run_diagnosis(dataset_url: str, method: str = "batch",
                  pool_type: str = "thread", workers_count: int = 3,
                  num_epochs: Optional[int] = 1, max_batches: int = 0,
                  telemetry: Optional[Telemetry] = None,
                  chaos=None, on_error: str = "raise",
                  item_deadline_s: Optional[float] = None,
                  hedge_after_s=None,
                  duration_s: Optional[float] = None,
                  metrics_port: Optional[int] = None,
                  flight_record_path: Optional[str] = None,
                  sample_interval_s: Optional[float] = None,
                  autotune=False,
                  cache_type: str = "null",
                  cache_location: Optional[str] = None,
                  shuffle_seed: Optional[int] = None,
                  deterministic: str = "auto",
                  service_address: Optional[str] = None,
                  trace_items=None,
                  on_reader=None) -> dict:
    """Read ``dataset_url`` with telemetry enabled; returns a result dict
    with ``rows``, ``batches``, ``snapshot``, ``report``,
    ``dominant_stage``, the reader's fault ledger
    (``quarantined_rowgroups``) and a ``liveness`` verdict (hung-kill /
    hedge / circuit counts + slowest observed in-flight item age) - also
    the programmatic entry the tests use.

    ``duration_s`` bounds the read in wall-clock time (the iterator stops
    cleanly once elapsed - the ``--watch --duration`` capture).
    ``metrics_port``/``flight_record_path``/``sample_interval_s`` pass
    through to the reader (docs/operations.md "Live monitoring").
    ``on_reader`` is called with the live Reader right after construction -
    the watch loop uses it to poll ``reader.sampler`` and diagnostics."""
    from petastorm_tpu_torch.reader import make_batch_reader, make_reader

    tele = telemetry or Telemetry()
    factory = make_batch_reader if method == "batch" else make_reader
    rows = 0
    batches = 0
    slowest_inflight = 0.0
    t_start = time.monotonic()
    with factory(dataset_url, reader_pool_type=pool_type,
                 workers_count=workers_count, num_epochs=num_epochs,
                 shuffle_row_groups=shuffle_seed is not None,
                 shuffle_seed=shuffle_seed, deterministic=deterministic,
                 telemetry=tele,
                 chaos=chaos, on_error=on_error,
                 item_deadline_s=item_deadline_s,
                 hedge_after_s=hedge_after_s,
                 metrics_port=metrics_port,
                 flight_record_path=flight_record_path,
                 sample_interval_s=sample_interval_s,
                 cache_type=cache_type, cache_location=cache_location,
                 service_address=service_address, trace_items=trace_items,
                 autotune=autotune or None) as reader:
        if on_reader is not None:
            on_reader(reader)

        def _sample_inflight() -> None:
            # slowest in-flight item age: the number a wedged production
            # pipeline is triaged by (whose item is old, and how old)
            nonlocal slowest_inflight
            for _i, _o, age in reader.diagnostics.get("workers_busy", []):
                slowest_inflight = max(slowest_inflight, age)

        def _out_of_time() -> bool:
            return (duration_s is not None
                    and time.monotonic() - t_start >= duration_s)

        if method == "batch":
            for batch in reader.iter_batches():
                rows += batch.num_rows
                batches += 1
                _sample_inflight()
                if max_batches and batches >= max_batches:
                    break
                if _out_of_time():
                    break
        else:
            for _ in reader:
                rows += 1
                if rows % 50 == 0:  # cheap, but not per-row
                    _sample_inflight()
                # the duration check IS per-row (one clock read, only when a
                # bound is set): a slow decode must not overshoot the
                # "bounded capture" contract by up to 50 rows
                if duration_s is not None and _out_of_time():
                    break
        _sample_inflight()
        quarantined = reader.quarantined_rowgroups
        final_diag = reader.diagnostics
        bound_port = (reader.metrics_server.port
                      if reader.metrics_server is not None else None)
    snapshot = tele.snapshot()
    counters = snapshot.get("counters", {})
    liveness = {
        "hung_workers_killed": final_diag.get("hung_workers_killed", 0),
        "hung_workers_abandoned": final_diag.get("hung_workers_abandoned", 0),
        "hedged_items": final_diag.get("hedged_items", 0),
        "hedge_wins": final_diag.get("hedge_wins", 0),
        "requeued_items": final_diag.get("requeued_items", 0),
        # parent-process view only: spawned process-pool workers hold their
        # own breaker copies and record opens into their own telemetry
        "circuit_opens": int(counters.get("liveness.circuit_opens", 0)),
        "circuit_breaker": final_diag.get("circuit_breaker"),
        # breaker signal that DOES cross the process boundary: rowgroups
        # quarantined because a worker-side circuit was failing fast
        "circuit_open_quarantines": sum(
            1 for e in quarantined if e.get("exc_type") == "CircuitOpenError"),
        "slowest_inflight_age_s": round(slowest_inflight, 3),
    }
    return {"rows": rows, "batches": batches, "snapshot": snapshot,
            "report": tele.pipeline_report(),
            "dominant_stage": dominant_stage(snapshot),
            "quarantined_rowgroups": quarantined,
            "liveness": liveness,
            # knob values + decision log when --autotune tuned the run
            "autotune": final_diag.get("autotune"),
            # the static planner's seed verdict (per-knob provenance:
            # profile / metadata / default / pinned) when it ran
            "planner": final_diag.get("planner"),
            # the run's stream certificate (docs/operations.md
            # "Reproducibility"); operators and the CI determinism smoke
            # share this one code path via --stream-digest
            "stream_digest": final_diag.get("stream_digest"),
            "deterministic": final_diag.get("deterministic"),
            "metrics_port": bound_port,
            "telemetry": tele}


#: watch-frame fault counters worth a line the moment they move (autotune
#: moves ride along so a watched run shows the tuner acting live)
_WATCH_FAULT_PREFIXES = ("errors.", "liveness.", "io.retries", "autotune.")

#: short watch labels per queue-wait counter; the counter LIST itself comes
#: from report._QUEUE_WAITS (one source of truth - a new queue-wait counter
#: added there shows up in watch frames automatically, with its report
#: meaning until a short label is added here)
_WATCH_QUEUE_LABELS = {
    "queue.input_full_wait_s": "ventilator blocked (workers saturated)",
    "queue.results_full_wait_s": "workers blocked (consumer-bound)",
    "queue.results_empty_wait_s": "consumer starved (worker-bound)",
}


def _watch_queue_waits():
    from petastorm_tpu_torch.telemetry.report import _QUEUE_WAITS

    return [(name, _WATCH_QUEUE_LABELS.get(name, meaning))
            for name, meaning in _QUEUE_WAITS]


def render_watch_frame(point: Dict, diagnostics: Optional[Dict] = None,
                       elapsed_s: float = 0.0) -> str:
    """One ``--watch`` frame from a sampler point (+ optional live reader
    diagnostics): per-stage rate and interval p50/p99, queue depths and
    wait rates, fault/liveness counters, and the interval's dominant stage.
    Pure function of its inputs (tests render from canned points)."""
    lines = [f"== petastorm-tpu watch  t={elapsed_s:6.1f}s  "
             f"interval={point.get('dt_s', 0.0):.2f}s =="]
    rates = point.get("rates", {})
    rows_rate = rates.get("reader.rows_emitted", 0.0)
    batches_rate = rates.get("reader.batches_consumed", 0.0)
    lines.append(f"rows/s: {rows_rate:10.1f}    batches/s:"
                 f" {batches_rate:7.2f}    total rows:"
                 f" {point.get('counters', {}).get('reader.rows_emitted', 0):.0f}")
    stages = point.get("stages", {})
    if stages:
        ordered = [s for s in STAGE_ORDER if s in stages]
        ordered += sorted(set(stages) - set(STAGE_ORDER))
        lines.append(f"{'stage':<16} {'rate/s':>8} {'p50_ms':>8}"
                     f" {'p99_ms':>8} {'busy%':>7}")
        busiest, busiest_frac = "", 0.0
        for name in ordered:
            st = stages[name]
            if st["count"] == 0 and st["rate_per_s"] == 0.0:
                lines.append(f"{name:<16} {'-':>8} {'-':>8} {'-':>8} {'-':>7}"
                             "  (no samples yet)")
                continue
            p50 = (f"{st['p50_s'] * 1e3:>8.1f}"
                   if st.get("p50_s") is not None else f"{'-':>8}")
            p99 = (f"{st['p99_s'] * 1e3:>8.1f}"
                   if st.get("p99_s") is not None else f"{'-':>8}")
            frac = st.get("busy_frac", 0.0)
            lines.append(f"{name:<16} {st['rate_per_s']:>8.2f} {p50} {p99}"
                         f" {100.0 * frac:>6.1f}%")
            if frac > busiest_frac:
                busiest, busiest_frac = name, frac
        lines.append(f"dominant stage (this interval): "
                     f"{busiest or '(no samples yet)'}")
    waits = [(label, rates.get(name, 0.0))
             for name, label in _watch_queue_waits() if rates.get(name)]
    if waits:
        lines.append("queue wait (blocked-seconds/second):")
        lines.extend(f"  {rate:6.2f}  {label}" for label, rate in waits)
    gauges = point.get("gauges", {})
    depth_parts = [f"{name.split('.', 1)[1]}={gauges[name]:g}"
                   for name in sorted(gauges)
                   if "depth" in name or "queue" in name]
    if depth_parts:
        lines.append("queue depths: " + "  ".join(depth_parts))
    counters = point.get("counters", {})
    if counters.get("cache.hits") or counters.get("cache.misses") \
            or counters.get("cache.l2_hits"):
        # the shared warm tier's pulse: per-interval hit/miss rates, the
        # cumulative hit-rate gauge, resident L1 bytes and eviction total
        hit_rate = gauges.get("cache.hit_rate", 0.0)
        lines.append(
            f"cache: {rates.get('cache.hits', 0.0):6.1f} hit/s"
            f"  {rates.get('cache.misses', 0.0):6.1f} miss/s"
            f"  {rates.get('cache.l2_hits', 0.0):5.1f} l2hit/s"
            f"  hit-rate {100.0 * hit_rate:5.1f}%"
            f"  L1 {gauges.get('cache.bytes', 0.0) / 2 ** 20:.0f}MB"
            f"  evictions {counters.get('cache.evictions', 0):g}"
            # post-transform entries (decode AND transform skipped on a hit)
            f"  xform {counters.get('cache.transform_hits', 0):g}h"
            f"/{counters.get('cache.transform_stores', 0):g}s")
    if any(n.startswith("service.") for n in counters) \
            or any(n.startswith("service.") for n in gauges):
        # the disaggregated ingest plane's pulse (client-side series): a
        # just-started fleet with nothing delivered yet renders an explicit
        # "(no samples yet)" line instead of vanishing from the frame
        results_total = counters.get("service.results", 0)
        if results_total:
            lines.append(
                f"service: {rates.get('service.results', 0.0):6.1f} results/s"
                f"  {rates.get('service.frame_bytes_received', 0.0) / 2 ** 10:8.1f} KB/s in"
                # wire-encoding mix: a hot pickle fallback (pkl > 0 and
                # climbing) means the binary plane is NOT carrying the data
                # path - visible here, not just in a slow bench
                f"  wire bin={counters.get('service.frames_binary', 0):g}"
                f"/shm={counters.get('service.frames_shm', 0):g}"
                f"/pkl={counters.get('service.frames_pickle_fallback', 0):g}"
                f"  requeued {counters.get('service.requeued_items', 0):g}"
                f"  reconnects {counters.get('service.reconnects', 0):g}"
                f"  connected {gauges.get('service.connected', 0):g}")
        else:
            lines.append("service: (no samples yet)")
    hops = point.get("hops", {})
    if hops:
        # per-hop latency decomposition of traced service items, in wire
        # order (the seven legs telescope to the end-to-end 'total')
        hop_order = ("client_serialize", "dispatcher_queue", "relay",
                     "worker_queue", "worker_exec", "return_relay",
                     "client_deserialize", "total")
        ordered_hops = [h for h in hop_order if h in hops]
        ordered_hops += sorted(set(hops) - set(hop_order))
        parts = []
        for name in ordered_hops:
            h = hops[name]
            p50 = h.get("p50_s")
            parts.append(f"{name}={p50 * 1e3:.1f}ms"
                         if p50 is not None else f"{name}=-")
        lines.append("hops p50 (traced items): " + "  ".join(parts))
    faults = {n: v for n, v in counters.items()
              if n.startswith(_WATCH_FAULT_PREFIXES) and v}
    if faults:
        lines.append("faults/liveness (totals): " + "  ".join(
            f"{n}={v:g}" for n, v in sorted(faults.items())))
    if diagnostics:
        if diagnostics.get("planner"):
            # where this run's starting knobs came from (one compact line;
            # the full provenance rides the post-run report)
            lines.append(render_planner_verdict(diagnostics["planner"],
                                                compact=True))
        busy = diagnostics.get("workers_busy", [])
        if busy:
            oldest = max(age for _i, _o, age in busy)
            lines.append(f"in-flight: {len(busy)} worker(s) busy, oldest item"
                         f" {oldest:.1f}s (worker, item, age):"
                         f" {busy[:6]}")
        lines.append(
            f"consumed {diagnostics.get('consumed_items', 0)}"
            f"/{diagnostics.get('expected_items', '?')} items"
            f"  requeued={diagnostics.get('requeued_items', 0)}"
            f"  hedged={diagnostics.get('hedged_items', 0)}"
            f"  hung_killed={diagnostics.get('hung_workers_killed', 0)}"
            f"  skipped={diagnostics.get('skipped_rowgroups', 0)}")
    return "\n".join(lines)


def _watch(args, url: str, chaos) -> int:
    """Drive ``run_diagnosis`` in a background thread while rendering watch
    frames from the reader's sampler every ``--interval`` seconds."""
    tele = Telemetry()
    box: Dict = {}
    reader_box: Dict = {}
    num_epochs = args.num_epochs if args.num_epochs > 0 else None
    # completion is signaled via an Event, NOT Thread.join/is_alive: a
    # Thread.join(timeout) interrupted by Ctrl-C corrupts the thread state on
    # this interpreter (cpython bpo-45274: is_alive() then reports False
    # while the thread still runs), which silently dropped the final report
    done = threading.Event()

    def _run() -> None:
        try:
            box["result"] = run_diagnosis(
                url, method=args.method, pool_type=args.pool_type,
                workers_count=args.workers_count, num_epochs=num_epochs,
                max_batches=args.max_batches, telemetry=tele, chaos=chaos,
                on_error=args.on_error, item_deadline_s=args.item_deadline,
                hedge_after_s=args.hedge_after, duration_s=args.duration,
                metrics_port=args.metrics_port,
                flight_record_path=args.flight_record,
                sample_interval_s=args.interval,
                autotune=args.autotune,
                cache_type=args.cache_type,
                cache_location=args.cache_location,
                shuffle_seed=args.seed,
                deterministic=args.deterministic,
                service_address=args.service_address,
                trace_items=args.trace_items,
                on_reader=lambda r: reader_box.update(reader=r))
        except BaseException as exc:  # noqa: BLE001 - reported on main thread
            box["error"] = exc
        finally:
            done.set()

    thread = threading.Thread(target=_run, daemon=True,
                              name="petastorm-tpu-torch-diagnose-read")
    thread.start()
    t0 = time.monotonic()
    interrupted = False
    clear = "\x1b[H\x1b[2J" if sys.stdout.isatty() else ""
    try:
        while not done.wait(timeout=args.interval):
            reader = reader_box.get("reader")
            sampler = getattr(reader, "sampler", None)
            point = sampler.latest() if sampler is not None else None
            if point is None:
                continue
            try:
                diag = reader.diagnostics
            except Exception:  # noqa: BLE001 - reader may be mid-teardown
                diag = None
            frame = render_watch_frame(point, diag,
                                       elapsed_s=time.monotonic() - t0)
            if reader is not None and reader.metrics_server is not None:
                frame += (f"\nmetrics: http://127.0.0.1:"
                          f"{reader.metrics_server.port}/metrics")
            print(f"{clear}{frame}" + ("" if clear else "\n"), flush=True)
    except KeyboardInterrupt:
        interrupted = True
        reader = reader_box.get("reader")
        if reader is not None:
            reader.stop()
        done.wait(timeout=10)
    if args.trace_out:
        tele.export_chrome_trace(args.trace_out)
        print(f"chrome trace written to {args.trace_out}"
              " (load in Perfetto / chrome://tracing)")
    if not box:
        # the read thread neither returned nor raised within the post-Ctrl-C
        # grace (a wedged pipeline the stop could not unwedge): that is a
        # failure - never a silent success exit
        print("watch aborted: the read did not stop within 10s of Ctrl-C"
              " (pipeline wedged?); state below is the last observed",
              file=sys.stderr)
        print(tele.pipeline_report())
        return 1
    error = box.get("error")
    if interrupted and isinstance(error, ReaderClosedError):
        # Ctrl-C is the documented way to END a watch, not a failure: our
        # own stop() is what raised ReaderClosedError in the read thread
        print("watch stopped")
        print(tele.pipeline_report())
        return 0
    if error is not None:
        print(f"read failed: {type(error).__name__}: {error}",
              file=sys.stderr)
        diag = getattr(error, "diagnostics", None)
        if isinstance(diag, dict) and diag.get("flight_recorder"):
            print(f"flight record captured"
                  f" ({len(diag['flight_recorder']['points'])} points"
                  + (f"; written to {args.flight_record}"
                     if args.flight_record else "") + ")",
                  file=sys.stderr)
        print(tele.pipeline_report())
        return 1
    result = box.get("result")
    if result is not None:
        # a Ctrl-C'd batch read ends CLEANLY (iter_batches absorbs the
        # stop), so it reaches here too - name it a stop, not a finish
        print(f"watch {'stopped' if interrupted else 'finished'}:"
              f" read {result['rows']} rows")
        print(result["report"])
        print(render_liveness_verdict(result["liveness"]))
        if result.get("planner"):
            print(render_planner_verdict(result["planner"]))
        if result.get("autotune"):
            print(render_autotune_verdict(result["autotune"]))
    return 0


def render_planner_verdict(planner: dict, compact: bool = False) -> str:
    """The static planner's seed verdict as text: every planned knob with
    its provenance, plus (non-compact) the flight profile it planned from.
    ``compact=True`` is the one-line ``--watch`` form."""
    knobs = planner.get("knobs", {})
    parts = [f"{name}={knob['value']}({knob['source']})"
             for name, knob in sorted(knobs.items())]
    line = "planner: " + ("  ".join(parts) if parts else "(no knobs planned)")
    if compact:
        return line
    lines = [line]
    for name, knob in sorted(knobs.items()):
        lines.append(f"  {name}={knob['value']} [{knob['source']}]"
                     f" {knob.get('why', '')}")
    profile = planner.get("profile")
    if profile:
        observed = profile.get("observed_rows_per_sec")
        lines.append(
            f"  flight profile: {planner.get('profile_path')}"
            + (f" (observed {observed:.0f} rows/s)"
               if isinstance(observed, (int, float)) else ""))
    else:
        lines.append(
            "  no flight profile yet (written at reader stop; next cold"
            f" start seeds from {planner.get('profile_path')})")
    return "\n".join(lines)


def render_autotune_verdict(autotune: dict) -> str:
    """Compact summary of what the tuner did: final knob values plus the
    per-decision trail (knob, move, rates, kept/reverted)."""
    knobs = "  ".join(f"{k}={v}" for k, v in
                      sorted(autotune.get("knobs", {}).items()))
    lines = [f"autotune: {autotune.get('moves_applied', 0)} move(s),"
             f" {autotune.get('moves_kept', 0)} kept,"
             f" {autotune.get('moves_reverted', 0)} reverted;"
             f" final knobs: {knobs or '(none)'}"]
    for d in autotune.get("decisions", []):
        rate = (f"{d['measured_rate']:.0f}/s"
                if d.get("measured_rate") is not None else "?")
        lines.append(f"  {d['action']} {d['knob']} {d['from']}->{d['to']}"
                     f" ({d['reason']}): {d['outcome']} @ {rate}")
    return "\n".join(lines)


def render_stream_digest(digest: Optional[dict],
                         deterministic: Optional[str] = None) -> str:
    """Machine-parseable one-liner for the run's stream certificate - the
    line the CI determinism smoke (and an operator diffing two runs) greps
    and compares (docs/operations.md "Reproducibility")."""
    if not digest:
        return "stream_digest unavailable"
    epochs = " ".join(f"e{e}={v}"
                      for e, v in sorted(digest.get("epochs", {}).items()))
    return ("stream_digest"
            + (f" mode={deterministic}" if deterministic else "")
            + f" combined={digest.get('combined')}"
            + f" batches={digest.get('batches')} rows={digest.get('rows')}"
            + (f" {epochs}" if epochs else ""))


def render_liveness_verdict(liveness: dict) -> str:
    """One-line liveness triage verdict from ``run_diagnosis``'s
    ``liveness`` dict - the answer to "is this pipeline wedged, and on
    what?" from one command."""
    interventions = []
    if liveness.get("hung_workers_killed"):
        interventions.append(
            f"{liveness['hung_workers_killed']} hung worker(s) killed+respawned")
    if liveness.get("hung_workers_abandoned"):
        interventions.append(
            f"{liveness['hung_workers_abandoned']} hung thread slot(s) abandoned")
    if liveness.get("hedged_items"):
        interventions.append(
            f"{liveness['hedged_items']} item(s) hedged"
            f" ({liveness.get('hedge_wins', 0)} hedge win(s))")
    if liveness.get("circuit_opens"):
        interventions.append(
            f"storage circuit opened {liveness['circuit_opens']}x")
    if liveness.get("circuit_open_quarantines"):
        # worker-side breaker activity: visible through the quarantine
        # ledger even when the breaker lives in spawned worker processes
        interventions.append(
            f"{liveness['circuit_open_quarantines']} rowgroup(s) quarantined"
            " on an open storage circuit")
    breaker = liveness.get("circuit_breaker")
    if breaker and breaker.get("state") != "closed":
        interventions.append(f"circuit breaker {breaker['state']}")
    verdict = ("liveness: " + ("; ".join(interventions) if interventions
                               else "OK (no hung-worker kills, no hedges,"
                                    " circuit closed)"))
    verdict += (f"; slowest in-flight item age observed:"
                f" {liveness.get('slowest_inflight_age_s', 0.0):.1f}s")
    return verdict


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.watch and args.json:
        # watch is a human-paced frame stream; silently printing the human
        # report under --json would break any script parsing stdout
        parser.error("--watch and --json are incompatible (watch renders"
                     " refreshing frames; use --watch with --metrics-port"
                     " for machine-readable live series)")
    if args.dataset_url is None and not args.synthetic:
        args.synthetic = True
    tmpdir = None
    url = args.dataset_url
    try:
        if url is None:
            from petastorm_tpu_torch.test_util.synthetic import create_test_dataset

            tmpdir = tempfile.mkdtemp(prefix="petastorm_tpu_torch_diagnose_")
            create_test_dataset(tmpdir, num_rows=args.rows,
                                row_group_size_rows=args.row_group_size)
            url = tmpdir
        chaos = None
        if args.chaos:
            from petastorm_tpu_torch.test_util.chaos import ChaosSpec

            chaos = ChaosSpec.parse(args.chaos)
        if args.watch:
            return _watch(args, url, chaos)
        result = run_diagnosis(url, method=args.method,
                               pool_type=args.pool_type,
                               workers_count=args.workers_count,
                               num_epochs=args.num_epochs,
                               max_batches=args.max_batches,
                               chaos=chaos, on_error=args.on_error,
                               item_deadline_s=args.item_deadline,
                               hedge_after_s=args.hedge_after,
                               duration_s=args.duration,
                               metrics_port=args.metrics_port,
                               flight_record_path=args.flight_record,
                               sample_interval_s=args.interval,
                               autotune=args.autotune,
                               cache_type=args.cache_type,
                               cache_location=args.cache_location,
                               shuffle_seed=args.seed,
                               deterministic=args.deterministic,
                               service_address=args.service_address,
                               trace_items=args.trace_items)
        if args.trace_out:
            result["telemetry"].export_chrome_trace(args.trace_out)
        if args.json:
            print(json.dumps({"rows": result["rows"],
                              "batches": result["batches"],
                              "dominant_stage": result["dominant_stage"],
                              "quarantined_rowgroups":
                                  result["quarantined_rowgroups"],
                              "liveness": result["liveness"],
                              "autotune": result["autotune"],
                              "planner": result["planner"],
                              "stream_digest": result["stream_digest"],
                              "deterministic": result["deterministic"],
                              "snapshot": result["snapshot"]}))
        else:
            what = "synthetic dataset" if tmpdir else url
            print(f"read {result['rows']} rows"
                  + (f" in {result['batches']} rowgroup batches"
                     if args.method == "batch" else "")
                  + f" from {what}")
            print(result["report"])
            print(render_liveness_verdict(result["liveness"]))
            if result.get("planner"):
                print(render_planner_verdict(result["planner"]))
            if args.stream_digest:
                print(render_stream_digest(result["stream_digest"],
                                           result["deterministic"]))
            if result.get("autotune"):
                print(render_autotune_verdict(result["autotune"]))
            for entry in result["quarantined_rowgroups"]:
                print(f"quarantined: {entry['path']}#{entry['row_group']}"
                      f" (work item {entry['ordinal']}, {entry['kind']}"
                      f" error: {entry['error']})")
            if args.trace_out:
                print(f"chrome trace written to {args.trace_out}"
                      " (load in Perfetto / chrome://tracing)")
        return 0
    finally:
        if tmpdir is not None:
            shutil.rmtree(tmpdir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
