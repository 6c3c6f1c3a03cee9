"""Loader-only microbenchmark: no Parquet, no IO, just the delivery layer.

Counterpart of ``petastorm_tpu/benchmark/dummy_reader.py`` (reference:
petastorm/benchmark/dummy_reader.py:25-85): a synthetic reader
(``test_util.reader_mock.ReaderMock``) feeds the loaders, so their own
overhead (shuffle buffer, collate, device copy) is measured across batch
sizes.
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence

import numpy as np

from petastorm_tpu_torch.schema import Field, Schema
from petastorm_tpu_torch.test_util.reader_mock import ReaderMock

#: feature sizes roughly matching the reference microbench payload
#: (dummy_reader.py:30-38: one flat float feature vector + int label)
BENCH_SCHEMA = Schema("LoaderBench", [
    Field("feature", np.float32, (64,)),
    Field("label", np.int64),
])


def _measure(loader, warmup_batches: int, measure_batches: int,
             block=None) -> float:
    it = iter(loader)

    def consume(n: int) -> int:
        rows = 0
        for _ in range(n):
            batch = next(it)
            if block is not None:
                block(batch)
            first = batch[next(iter(batch))] if isinstance(batch, dict) else batch[0]
            rows += int(first.shape[0])
        return rows

    consume(warmup_batches)
    t0 = time.perf_counter()
    rows = consume(measure_batches)
    return rows / (time.perf_counter() - t0)


def loader_microbench(batch_sizes: Sequence[int] = (10, 100, 1000, 10000),
                      warmup_batches: int = 5,
                      measure_batches: int = 50,
                      shuffling_queue_capacity: int = 0,
                      kinds: Sequence[str] = ("torch", "torch_batched", "cuda"),
                      device="cuda") -> List[Dict]:
    """samples/s of each delivery loader at each batch size.

    ``torch`` and ``torch_batched`` are the reference's adapters
    (``pytorch.DataLoader``, ``pytorch.BatchedDataLoader``), on the host;
    ``cuda`` is ``cuda.loader.CudaDataLoader`` on ``device``, each batch
    synchronised on that device's current stream (``device="cuda"`` without
    a GPU raises).
    """
    results: List[Dict] = []
    for batch_size in batch_sizes:
        for kind in kinds:
            reader = ReaderMock(BENCH_SCHEMA, batch_size=batch_size,
                                num_batches=None)
            if kind == "torch":
                from petastorm_tpu_torch.pytorch import DataLoader
                loader = DataLoader(reader, batch_size=batch_size,
                                    shuffling_queue_capacity=shuffling_queue_capacity)
                rate = _measure(loader, warmup_batches, measure_batches)
            elif kind == "torch_batched":
                from petastorm_tpu_torch.pytorch import BatchedDataLoader
                loader = BatchedDataLoader(
                    reader, batch_size=batch_size,
                    shuffling_queue_capacity=shuffling_queue_capacity)
                rate = _measure(loader, warmup_batches, measure_batches)
            elif kind == "cuda":
                import torch

                from petastorm_tpu_torch.cuda.loader import CudaDataLoader
                from petastorm_tpu_torch.device import resolve_device

                dev = resolve_device(device)
                with CudaDataLoader(reader, batch_size=batch_size, device=dev) as loader:
                    block = ((lambda _: torch.cuda.current_stream(dev).synchronize())
                             if dev.type == "cuda" else None)
                    rate = _measure(loader, warmup_batches, measure_batches, block=block)
            else:
                raise ValueError(f"unknown loader kind {kind!r}")
            reader.stop()
            results.append({"loader": kind, "batch_size": batch_size,
                            "samples_per_sec": rate})
    return results


def main() -> None:
    import argparse

    parser = argparse.ArgumentParser(
        description="Microbenchmark delivery loaders over a synthetic reader")
    parser.add_argument("--batch-sizes", type=int, nargs="+",
                        default=[10, 100, 1000, 10000])
    parser.add_argument("--kinds", nargs="+",
                        default=["torch", "torch_batched", "cuda"])
    parser.add_argument("--measure-batches", type=int, default=50)
    parser.add_argument("--shuffling-queue-capacity", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="the cuda loader's device ('cpu' runs it on the host)")
    args = parser.parse_args()
    for r in loader_microbench(batch_sizes=args.batch_sizes, kinds=args.kinds,
                               measure_batches=args.measure_batches,
                               shuffling_queue_capacity=args.shuffling_queue_capacity,
                               device=args.device):
        print(f"{r['loader']:>14}  batch={r['batch_size']:<6} "
              f"{r['samples_per_sec']:>12.1f} samples/sec")


if __name__ == "__main__":
    main()
