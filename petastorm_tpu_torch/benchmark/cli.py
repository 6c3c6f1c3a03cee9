"""``petastorm-tpu-torch-throughput`` CLI.

Counterpart of ``petastorm_tpu/benchmark/cli.py`` (reference:
petastorm/benchmark/cli.py:30-112): flags for the dataset URL, field
regexes, warm-up and measured cycles, pool type and size, plus the
fresh-process isolation mode the reference buries in throughput.py:69-91;
``--method cuda`` measures the device feed through ``CudaDataLoader`` on
``--device`` (``cuda`` by default; ``cpu`` runs it on the host).

Examples::

    petastorm-tpu-torch-throughput file:///data/imagenet --method batch -w 7
    petastorm-tpu-torch-throughput file:///data/imagenet --method cuda \\
        --batch-size 256 --decode-device image --simulated-step-ms 140 --json
    python -m petastorm_tpu_torch.benchmark.cli file:///data/imagenet \\
        --method cuda --device cpu --isolated
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="petastorm-tpu-torch-throughput",
        description="Measure reader / device-loader throughput on a dataset")
    parser.add_argument("dataset_url", help="file:// or fsspec URL of the dataset")
    parser.add_argument("-f", "--field-regex", nargs="+", default=None,
                        help="only read fields matching these regexes")
    parser.add_argument("-n", "--warmup-cycles", type=int, default=200)
    parser.add_argument("-m", "--measure-cycles", type=int, default=1000)
    parser.add_argument("-p", "--pool-type", default="thread",
                        choices=("thread", "process", "serial"))
    parser.add_argument("-w", "--workers-count", type=int, default=3)
    parser.add_argument("--method", default="row", choices=("row", "batch", "cuda"),
                        help="row=make_reader, batch=make_batch_reader, "
                             "cuda=device feed via CudaDataLoader")
    parser.add_argument("--device", default="cuda",
                        help="the device feed's device (--method cuda only);"
                             " 'cpu' runs the loader on the host, 'cuda'"
                             " without a GPU is an error")
    parser.add_argument("--batch-size", type=int, default=32,
                        help="device batch size (--method cuda only)")
    parser.add_argument("--simulated-step-ms", type=float, default=0.0,
                        help="emulate an N-ms training step between batches;"
                             " the report's input_stall_percent then reads as"
                             " device-idle%% (--method cuda only)")
    parser.add_argument("--decode-device", nargs="+", default=(),
                        metavar="FIELD",
                        help="finish these jpeg fields' decode on the card"
                             " (decode_placement='device', kernel B2;"
                             " --method cuda only)")
    parser.add_argument("--prefetch", type=int, default=None,
                        help="loader queue depth per producer stage"
                             " (--method cuda only; default: the pipeline"
                             " planner's verdict under --autotune, else 2)")
    parser.add_argument("--no-shuffle", action="store_true",
                        help="disable rowgroup shuffling")
    parser.add_argument("--telemetry", action="store_true",
                        help="record pipeline telemetry over the reader's"
                             " whole life (warmup INCLUDED - stage counters"
                             " will exceed the measured-cycle sample count):"
                             " metrics ride the JSON output as 'metrics' and"
                             " the human output appends the pipeline"
                             " bottleneck report")
    parser.add_argument("--trace-out", metavar="PATH", default=None,
                        help="write a Chrome trace_event JSON of the run to"
                             " PATH (open in Perfetto); implies --telemetry")
    parser.add_argument("--json", action="store_true",
                        help="print one JSON line instead of human-readable text")
    parser.add_argument("--isolated", action="store_true",
                        help="re-run in a fresh interpreter for clean RSS")
    parser.add_argument("--chaos", metavar="SPEC", default=None,
                        help="measure throughput UNDER injected faults:"
                             " comma-separated ChaosSpec fields, e.g."
                             " 'decode_fail_rate=0.01,kill_ordinals=3;7,"
                             "fail_first_reads=5,seed=1' (ordinal lists use"
                             " ';'). Pair with --on-error skip so the run"
                             " survives the injected data errors"
                             " (petastorm_tpu_torch.test_util.chaos)")
    parser.add_argument("--on-error", default="raise",
                        choices=("raise", "skip"),
                        help="reader failure policy: 'skip' quarantines"
                             " failing rowgroups and keeps reading (counts"
                             " ride telemetry as errors.*)")
    parser.add_argument("--item-deadline", type=float, default=None,
                        metavar="S",
                        help="liveness: kill+respawn (process pool) or"
                             " abandon (thread pool) a worker hung on one"
                             " work item for S seconds and requeue the item;"
                             " pair with --chaos 'hang_ordinals=...' to"
                             " measure throughput under hang recovery"
                             " (counts ride telemetry as liveness.*)")
    from petastorm_tpu_torch.pool import parse_hedge_after

    parser.add_argument("--hedge-after", default=None, metavar="S|auto",
                        type=parse_hedge_after,
                        help="liveness: speculatively re-issue a work item"
                             " running longer than S seconds to an idle"
                             " worker, first result wins ('auto' = 4x the"
                             " telemetry decode p99; needs --telemetry)")
    parser.add_argument("--metrics-port", type=int, default=None, metavar="N",
                        help="serve live metrics in Prometheus text format"
                             " on localhost:N for the benchmark's lifetime"
                             " (0 = ephemeral); auto-enables telemetry")
    parser.add_argument("--flight-record", metavar="PATH", default=None,
                        help="on a terminal reader failure, dump the flight"
                             " record (sampled series + trace tail) to PATH"
                             " as JSONL; auto-enables telemetry")
    parser.add_argument("--autotune", action="store_true",
                        help="run the closed-loop knob tuner during the"
                             " measurement: workers / results-queue bound /"
                             " prefetch adapt to the live metrics sampler"
                             " (petastorm_tpu_torch.autotune; decisions ride"
                             " telemetry as autotune.*)")
    parser.add_argument("--cache-type", default="null",
                        choices=("null", "memory", "local-disk", "shared"),
                        help="decoded-rowgroup cache: 'shared' = the"
                             " host-wide warm tier"
                             " (petastorm_tpu_torch.cache_shared) - repeat"
                             " this command (or run it concurrently) to"
                             " measure warm-vs-cold; cache.* telemetry shows"
                             " the hit rate")
    parser.add_argument("--cache-location", default=None, metavar="PATH",
                        help="names the cache tier (same location = same"
                             " shared tier host-wide; also the disk"
                             " directory)")
    parser.add_argument("--cache-size-mb", type=int, default=None,
                        metavar="MB",
                        help="cache size cap (shared: the L1 shm arena;"
                             " memory/local-disk: the tier's byte cap)")
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    telemetry = None
    if args.telemetry or args.trace_out:
        from petastorm_tpu_torch.telemetry import Telemetry
        telemetry = Telemetry()

    chaos = None
    if args.chaos:
        from petastorm_tpu_torch.test_util.chaos import ChaosSpec
        chaos = ChaosSpec.parse(args.chaos)

    cache_kwargs = dict(
        cache_type=args.cache_type, cache_location=args.cache_location,
        cache_size_limit=(args.cache_size_mb * 2 ** 20
                          if args.cache_size_mb else None))

    if args.isolated:
        from petastorm_tpu_torch.benchmark.throughput import run_isolated
        forwarded = [a for a in (argv if argv is not None else sys.argv[1:])
                     if a not in ("--isolated", "--json")]
        result = run_isolated(forwarded)
    elif args.method == "cuda":
        from petastorm_tpu_torch.benchmark.throughput import cuda_loader_throughput
        result = cuda_loader_throughput(
            args.dataset_url, batch_size=args.batch_size,
            warmup_batches=max(args.warmup_cycles // 25, 2),
            measure_batches=max(args.measure_cycles // 25, 8),
            pool_type=args.pool_type, workers_count=args.workers_count,
            field_regex=args.field_regex,
            shuffle_row_groups=not args.no_shuffle,
            simulated_step_s=args.simulated_step_ms / 1000.0,
            device_decode_fields=args.decode_device,
            prefetch=args.prefetch, telemetry=telemetry,
            chaos=chaos, on_error=args.on_error,
            item_deadline_s=args.item_deadline, hedge_after_s=args.hedge_after,
            metrics_port=args.metrics_port,
            flight_record_path=args.flight_record,
            autotune=args.autotune, device=args.device, **cache_kwargs)
    else:
        from petastorm_tpu_torch.benchmark.throughput import reader_throughput
        result = reader_throughput(
            args.dataset_url, field_regex=args.field_regex,
            warmup_cycles=args.warmup_cycles, measure_cycles=args.measure_cycles,
            pool_type=args.pool_type, workers_count=args.workers_count,
            read_method=args.method, shuffle_row_groups=not args.no_shuffle,
            telemetry=telemetry, chaos=chaos, on_error=args.on_error,
            item_deadline_s=args.item_deadline, hedge_after_s=args.hedge_after,
            metrics_port=args.metrics_port,
            flight_record_path=args.flight_record,
            autotune=args.autotune, **cache_kwargs)

    if telemetry is not None and args.trace_out and not args.isolated:
        telemetry.export_chrome_trace(args.trace_out)

    if args.json:
        print(result.to_json())
    else:
        line = (f"{result.samples_per_sec:.2f} samples/sec "
                f"({result.samples} samples in {result.wall_s:.2f}s), "
                f"RSS {result.rss_mb:.1f} MB, CPU {result.cpu_percent:.1f}%")
        if result.input_stall_percent is not None:
            line += (f", input stall {result.input_stall_percent:.1f}%"
                     f" (prefetch depth {result.prefetch_depth_avg:.1f})")
        print(line)
        if result.planner:
            # the static planner's seed verdict (per-knob provenance), so an
            # --autotune run shows where its starting knobs came from
            from petastorm_tpu_torch.tools.diagnose import render_planner_verdict
            print(render_planner_verdict(result.planner))
        if result.metrics:
            # metrics may come from THIS process' recorder or from the
            # isolated child's JSON snapshot; the report renders either
            from petastorm_tpu_torch.telemetry import render_pipeline_report
            print(render_pipeline_report(result.metrics))
        if args.trace_out:
            print(f"chrome trace written to {args.trace_out}"
                  " (load in Perfetto / chrome://tracing)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
