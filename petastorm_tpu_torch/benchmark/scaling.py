"""``petastorm-tpu-torch-scaling``: worker-count scaling microbenchmark.

Counterpart of ``petastorm_tpu/benchmark/scaling.py``.  Prints one JSON line
a worker count (samples/s of the batch reader over a synthetic JPEG dataset,
or ``--dataset-url``), so an operator picks ``workers_count`` for their host
instead of trusting a default: on a host with few cores fewer threads
usually win.  The reader plane only: no device is touched.

Examples::

    petastorm-tpu-torch-scaling --workers 1 2 4 8
    python -m petastorm_tpu_torch.benchmark.scaling --pool-type process \\
        --workers 1 7 --dataset-url file:///data/imagenet --epochs 1
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from typing import List, Optional


def build_dataset(url: str, rows: int, height: int, width: int) -> None:
    """``rows`` rows of ``id`` and a (height, width, 3) JPEG q85 of
    ``test_util.synthetic.synthetic_rgb_image``, 16 rowgroups."""
    import numpy as np

    from petastorm_tpu_torch.codecs import CompressedImageCodec
    from petastorm_tpu_torch.etl.writer import write_dataset
    from petastorm_tpu_torch.schema import Field, Schema
    from petastorm_tpu_torch.test_util.synthetic import synthetic_rgb_image

    schema = Schema("Scaling", [
        Field("id", np.int64),
        Field("image", np.uint8, (height, width, 3),
              CompressedImageCodec("jpeg", quality=85)),
    ])
    write_dataset(url, schema,
                  [{"id": i, "image": synthetic_rgb_image(i, height, width,
                                                          noise=5.0)}
                   for i in range(rows)],
                  row_group_size_rows=max(rows // 16, 1))


def measure(url: str, pool_type: str, workers: int, epochs: int) -> dict:
    """Rows/s of ``make_batch_reader`` over ``epochs`` epochs, and whether
    its batches came through the process pool's shared-memory arena."""
    from petastorm_tpu_torch.reader import make_batch_reader

    n = 0
    with make_batch_reader(url, reader_pool_type=pool_type,
                           workers_count=workers, num_epochs=epochs,
                           shuffle_row_groups=False) as r:
        # the timer starts after the reader and pool are built, as the JAX
        # tool's does; a process pool's workers are still starting then (the
        # pool does not wait for them), so its rate includes their spawn
        t0 = time.perf_counter()
        for batch in r.iter_batches():
            n += batch.num_rows
        wall = time.perf_counter() - t0
        diag = r.diagnostics
    return {"pool": pool_type, "workers": workers,
            "samples_per_sec": round(n / wall, 2), "samples": n,
            "wall_s": round(wall, 3),
            "shm_transport": bool(diag.get("shm_transport", False))}


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="petastorm-tpu-torch-scaling",
        description="Measure reader throughput across worker counts")
    parser.add_argument("--workers", nargs="+", type=int,
                        default=[1, 2, 4, 8, 16])
    parser.add_argument("--pool-type", default="thread",
                        choices=("thread", "process"))
    parser.add_argument("--rows", type=int, default=512)
    parser.add_argument("--image-size", type=int, nargs=2, default=(128, 128),
                        metavar=("H", "W"))
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--dataset-url", default=None,
                        help="reuse an existing dataset instead of generating")
    args = parser.parse_args(argv)

    url = args.dataset_url
    tmp = None
    if url is None:
        tmp = tempfile.mkdtemp(prefix="pst_scaling_")
        url = tmp + "/ds"
        build_dataset(url, args.rows, *args.image_size)
    try:
        for w in args.workers:
            print(json.dumps(measure(url, args.pool_type, w, args.epochs)),
                  flush=True)
    finally:
        if tmp is not None:
            import shutil

            shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
