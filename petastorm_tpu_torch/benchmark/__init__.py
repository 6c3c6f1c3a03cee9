"""Throughput harness: the reader, the device loader, the ops and worker scaling.

Counterpart of ``petastorm_tpu/benchmark/``: ``reader_throughput`` and
``cuda_loader_throughput`` (``throughput.py``, warm-up then measured cycles,
samples/s, RSS and CPU %), the ``petastorm-tpu-torch-throughput`` CLI
(``cli.py``, with a fresh-process mode for a clean RSS), a loader-only
microbench over a synthetic reader (``dummy_reader.py``), the
``petastorm-tpu-torch-scaling`` worker-count sweep (``scaling.py``) and the
on-card op timings of B1, B3 and B2 (``ops_microbench.py``).  Every entry
point runs on ``cuda`` unless it is given ``device="cpu"``.
"""

from petastorm_tpu_torch.benchmark.throughput import (BenchmarkResult, WorkerPoolType,
                                                      cuda_loader_throughput,
                                                      reader_throughput)

__all__ = ["BenchmarkResult", "WorkerPoolType", "reader_throughput",
           "cuda_loader_throughput"]
