"""Reader and device-loader throughput measurement.

Counterpart of ``petastorm_tpu/benchmark/throughput.py`` (reference:
petastorm/benchmark/throughput.py): warm-up then measured cycles, samples/s,
RSS and CPU %, and a fresh-process mode for a clean RSS.

``cuda_loader_throughput`` measures the device feed: host Parquet ->
``ColumnBatch`` -> ``cuda.loader.CudaDataLoader`` -> tensors on the card,
synchronised a batch, which is the number that says whether the feed keeps a
training step busy (samples/s alone ignores the copy's overlap).
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import List, Optional, Sequence

WorkerPoolType = ("thread", "process", "serial")


@dataclasses.dataclass
class BenchmarkResult:
    """What one measurement run produced (``petastorm_tpu/benchmark/throughput.py:30-58``)."""
    samples_per_sec: float
    wall_s: float
    samples: int
    rss_mb: float
    cpu_percent: float
    #: percent of wall time the consumer was blocked waiting for the next
    #: batch: the device-idle share of the feed; ~0 means the host pipeline
    #: keeps the card busy
    input_stall_percent: "float | None" = None
    #: mean prefetch-queue depth sampled at each batch (capacity = healthy)
    prefetch_depth_avg: "float | None" = None
    #: telemetry snapshot (``telemetry.Telemetry.snapshot()``) when the run
    #: was telemetered; ``telemetry.render_pipeline_report()`` renders it
    metrics: "dict | None" = None
    #: static planner verdict (``planner.PlanVerdict.to_dict()``) when the
    #: run was autotuned: planned knobs with per-knob provenance
    planner: "dict | None" = None

    def to_json(self) -> str:
        d = {k: v for k, v in dataclasses.asdict(self).items() if v is not None}
        return json.dumps(d)


def _rss_mb() -> float:
    """Resident set size of this process, in MB (linux /proc)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


class _CpuClock:
    """CPU%% over a wall interval = (user+sys delta) / wall delta * 100."""

    def start(self) -> None:
        t = os.times()
        self._cpu0, self._wall0 = t.user + t.system, time.perf_counter()

    def stop(self) -> float:
        t = os.times()
        wall = time.perf_counter() - self._wall0
        return 100.0 * (t.user + t.system - self._cpu0) / max(wall, 1e-9)


def _print_metrics_endpoint(reader) -> None:
    if reader.metrics_server is not None:
        # stderr so --json stdout stays one parseable line; an ephemeral
        # --metrics-port 0 endpoint is reachable only through this line
        print("metrics endpoint: http://127.0.0.1:"
              f"{reader.metrics_server.port}/metrics", file=sys.stderr)


def reader_throughput(dataset_url: str,
                      field_regex: Optional[Sequence[str]] = None,
                      warmup_cycles: int = 200,
                      measure_cycles: int = 1000,
                      pool_type: str = "thread",
                      workers_count: int = 3,
                      read_method: str = "row",
                      shuffle_row_groups: bool = True,
                      transform_spec=None,
                      storage_options: Optional[dict] = None,
                      telemetry=None, chaos=None,
                      on_error="raise",
                      item_deadline_s: Optional[float] = None,
                      hedge_after_s=None,
                      metrics_port: Optional[int] = None,
                      flight_record_path: Optional[str] = None,
                      autotune=False,
                      cache_type: str = "null",
                      cache_location: Optional[str] = None,
                      cache_size_limit: Optional[int] = None) -> BenchmarkResult:
    """Raw reader throughput in samples/s.

    ``read_method='row'`` counts one sample a ``next()`` (``make_reader``);
    ``'batch'`` iterates ``make_batch_reader`` and counts the rows of each
    columnar batch.  ``telemetry``: a recorder whose snapshot rides back on
    ``BenchmarkResult.metrics``.  ``chaos``/``on_error``: throughput under
    injected faults (``test_util.chaos``).  ``autotune``: the closed-loop knob
    tuner runs during the measurement (True or an ``AutotunePolicy``).
    """
    from petastorm_tpu_torch.reader import make_batch_reader, make_reader
    from petastorm_tpu_torch.telemetry import resolve as _resolve_telemetry

    if read_method not in ("row", "batch"):
        raise ValueError(f"read_method must be 'row' or 'batch', got {read_method!r}")
    factory = make_reader if read_method == "row" else make_batch_reader
    tele = _resolve_telemetry(telemetry)
    clock = _CpuClock()
    with factory(dataset_url, schema_fields=list(field_regex) if field_regex else None,
                 reader_pool_type=pool_type, workers_count=workers_count,
                 shuffle_row_groups=shuffle_row_groups, num_epochs=None,
                 transform_spec=transform_spec,
                 storage_options=storage_options, telemetry=tele,
                 chaos=chaos, on_error=on_error,
                 item_deadline_s=item_deadline_s,
                 hedge_after_s=hedge_after_s,
                 metrics_port=metrics_port,
                 flight_record_path=flight_record_path,
                 cache_type=cache_type, cache_location=cache_location,
                 cache_size_limit=cache_size_limit,
                 autotune=autotune or None) as reader:
        _print_metrics_endpoint(reader)
        it = iter(reader)

        def consume(cycles: int) -> int:
            n = 0
            for _ in range(cycles):
                item = next(it)
                n += len(item[0]) if read_method == "batch" else 1
            return n

        consume(warmup_cycles)
        clock.start()
        t0 = time.perf_counter()
        samples = consume(measure_cycles)
        wall = time.perf_counter() - t0
        cpu = clock.stop()
        planner = reader.planner.to_dict() if reader.planner is not None else None
    return BenchmarkResult(samples_per_sec=samples / wall, wall_s=wall,
                           samples=samples, rss_mb=_rss_mb(), cpu_percent=cpu,
                           metrics=tele.snapshot() if tele.enabled else None,
                           planner=planner)


def cuda_loader_throughput(dataset_url: str,
                           batch_size: int = 32,
                           warmup_batches: int = 8,
                           measure_batches: int = 64,
                           pool_type: str = "thread",
                           workers_count: int = 3,
                           field_regex: Optional[Sequence[str]] = None,
                           shuffle_row_groups: bool = True,
                           storage_options: Optional[dict] = None,
                           simulated_step_s: float = 0.0,
                           device_decode_fields: Sequence[str] = (),
                           prefetch: Optional[int] = None,
                           telemetry=None, chaos=None,
                           on_error="raise",
                           item_deadline_s: Optional[float] = None,
                           hedge_after_s=None,
                           metrics_port: Optional[int] = None,
                           flight_record_path: Optional[str] = None,
                           autotune=False,
                           cache_type: str = "null",
                           cache_location: Optional[str] = None,
                           cache_size_limit: Optional[int] = None,
                           device="cuda") -> BenchmarkResult:
    """The device feed: batches landing as tensors on ``device``.

    Each batch is synchronised (the loader device's current stream, on which
    the delivered tensors are ordered after the copy and B2), so the number
    is host decode plus transfer: the ceiling on how fast this loader can
    feed a training step.  ``device_decode_fields`` finish those JPEG fields
    on the card (``decode_placement='device'``, B2; its plain version on the
    CPU).

    ``simulated_step_s`` sleeps that long after each batch, as a training
    step would; ``input_stall_percent`` then answers "would this feed keep a
    card with an N-ms step busy?".  At 0 the feed runs flat out and the stall
    share is by construction near 100 (every moment is waiting).
    ``device="cuda"`` without a GPU raises.
    """
    import torch

    from petastorm_tpu_torch.cuda.loader import CudaDataLoader
    from petastorm_tpu_torch.device import resolve_device
    from petastorm_tpu_torch.reader import make_batch_reader
    from petastorm_tpu_torch.telemetry import resolve as _resolve_telemetry

    device = resolve_device(device)
    tele = _resolve_telemetry(telemetry)
    clock = _CpuClock()
    reader = make_batch_reader(
        dataset_url, schema_fields=list(field_regex) if field_regex else None,
        reader_pool_type=pool_type, workers_count=workers_count,
        shuffle_row_groups=shuffle_row_groups,
        num_epochs=None, storage_options=storage_options,
        decode_placement=({f: "device" for f in device_decode_fields}
                          if device_decode_fields else None),
        telemetry=tele, chaos=chaos, on_error=on_error,
        item_deadline_s=item_deadline_s, hedge_after_s=hedge_after_s,
        metrics_port=metrics_port, flight_record_path=flight_record_path,
        cache_type=cache_type, cache_location=cache_location,
        cache_size_limit=cache_size_limit,
        autotune=autotune or None)
    _print_metrics_endpoint(reader)
    try:
        loader = CudaDataLoader(reader, batch_size=batch_size, device=device,
                                prefetch=prefetch)
    except Exception:
        # the reader's executor threads would poll forever otherwise
        reader.stop()
        reader.join()
        raise
    stream = torch.cuda.current_stream(device) if device.type == "cuda" else None
    wait_s = 0.0
    depth_sum = 0
    depth_n = 0
    with loader:
        it = iter(loader)

        def consume(n_batches: int) -> int:
            nonlocal wait_s, depth_sum, depth_n
            n = 0
            for _ in range(n_batches):
                t1 = time.perf_counter()
                batch = next(it)
                if stream is not None:
                    stream.synchronize()
                wait_s += time.perf_counter() - t1
                depth_sum += loader.diagnostics()["prefetch_depth"]
                depth_n += 1
                first = next(iter(batch.values()))
                n += int(first.shape[0])
                if simulated_step_s:
                    time.sleep(simulated_step_s)
            return n

        consume(warmup_batches)
        wait_s, depth_sum, depth_n = 0.0, 0, 0
        clock.start()
        t0 = time.perf_counter()
        samples = consume(measure_batches)
        wall = time.perf_counter() - t0
        cpu = clock.stop()
        planner = reader.planner.to_dict() if reader.planner is not None else None
    return BenchmarkResult(samples_per_sec=samples / wall, wall_s=wall,
                           samples=samples, rss_mb=_rss_mb(), cpu_percent=cpu,
                           input_stall_percent=100.0 * wait_s / wall,
                           prefetch_depth_avg=depth_sum / max(depth_n, 1),
                           metrics=tele.snapshot() if tele.enabled else None,
                           planner=planner)


def run_isolated(cli_args: List[str]) -> BenchmarkResult:
    """Run the benchmark CLI in a fresh interpreter and parse its JSON line.

    Reference: throughput.py:69-91 re-execs for an RSS untainted by the
    parent (dataset generation, test fixtures, a CUDA context).  The child
    loads the kernels already built under ``petastorm_tpu_torch/_lib/``.
    """
    out = subprocess.run(
        [sys.executable, "-m", "petastorm_tpu_torch.benchmark.cli", "--json", *cli_args],
        capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"the isolated benchmark exited with {out.returncode}:\n"
                           f"{out.stderr[-4000:]}")
    line = out.stdout.strip().splitlines()[-1]
    return BenchmarkResult(**json.loads(line))
