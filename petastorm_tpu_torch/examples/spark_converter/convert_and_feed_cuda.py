"""Spark DataFrame -> cached Parquet -> the card and torch, via the converter.

Port of ``examples/spark_converter/convert_and_feed.py`` (reference:
examples/spark_dataset_converter/): a converter made from a DataFrame feeds
``CudaDataLoader`` on ``device`` (the card by default) where the JAX example
feeds a ``JaxDataLoader``, then the torch adapter and a row read; the cache
is deleted at the end.  Without pyspark the DataFrame is the pinned mock of
``test_util.mock_pyspark`` (installed into ``sys.modules`` for the run
only), the surface the tests hold the converter to; with pyspark it is a
local SparkSession's, and the converter's path is the same.  Run ``python -m
petastorm_tpu_torch.examples.spark_converter.convert_and_feed_cuda [--device
cpu] [--rows N]``; ``main`` returns what each feed delivered.
"""

import argparse
import contextlib
import tempfile
import warnings

import numpy as np
import torch


def _pyspark_available() -> bool:
    try:
        import pyspark  # noqa: F401

        return True
    except ImportError:
        return False


def build_dataframe(n: int):
    """(dataframe, cleanup) of a local SparkSession (needs pyspark)."""
    from pyspark.ml.linalg import Vectors
    from pyspark.sql import SparkSession

    spark = (SparkSession.builder.master("local[2]")
             .appName("petastorm-tpu-torch-converter-example").getOrCreate())
    df = spark.createDataFrame([(i, float(i) / n, Vectors.dense([i, i + 0.5, i + 0.25]))
                                for i in range(n)], ["id", "x", "vec"])
    print(f"real SparkSession (local[2]), {n} rows")
    return df, spark.stop


def main(cache_dir: str = None, rows: int = 32, device="cuda") -> dict:
    """Convert, feed the card, the torch adapter and a row read, convert
    again (the plan's cache hit), delete.  Returns ``{"rows", "files",
    "cuda_rows", "cuda_ids", "vec_sum", "torch_rows", "row5_vec",
    "cache_hit"}``."""
    from petastorm_tpu_torch.converter import make_converter

    cache_dir = cache_dir or tempfile.mkdtemp(prefix="pst_torch_converter_cache_")
    if _pyspark_available():
        mock_ctx = contextlib.nullcontext()
        df, cleanup = build_dataframe(rows)
    else:
        from petastorm_tpu_torch.test_util.mock_pyspark import (installed_mock_pyspark,
                                                                mock_spark_dataframe)

        print(f"pyspark not installed - using the pinned mock"
              f" (petastorm_tpu_torch.test_util.mock_pyspark), {rows} rows")
        mock_ctx = installed_mock_pyspark()
        df, cleanup = mock_spark_dataframe(rows), (lambda: None)
    out = {}
    with mock_ctx:
        with warnings.catch_warnings():
            # VectorUDT columns convert to float32 arrays with a warning
            warnings.simplefilter("ignore", UserWarning)
            conv = make_converter(df, cache_dir_url=cache_dir)
        try:
            out.update(rows=len(conv), files=len(conv.file_urls))
            print(f"converted: {len(conv)} rows in {len(conv.file_urls)} parquet file(s)"
                  " (executor-side materialization)")

            # the card: CudaDataLoader batches; the vectors are one length,
            # declared as the field's pad target
            ids, vec_sum = [], 0.0
            with conv.make_cuda_loader(
                    batch_size=8, device=device, pad_shapes={"vec": (3,)},
                    reader_kwargs={"num_epochs": 1, "workers_count": 1,
                                   "shuffle_row_groups": False}) as loader:
                for batch in loader:
                    vec = batch["vec"]
                    assert vec.device.type == torch.device(device).type
                    assert vec.dtype == torch.float32  # VectorUDT -> float32
                    valid = int(batch.get("_valid_rows", vec.shape[0]))
                    ids += batch["id"][:valid].tolist()
                    vec_sum += float(vec[:valid].double().sum())
            out.update(cuda_rows=len(ids), cuda_ids=ids, vec_sum=vec_sum)
            print(f"CudaDataLoader delivered {len(ids)} rows on {device}"
                  f" (vec float32, sum {vec_sum})")

            # torch: the reference example's shape
            seen = 0
            with conv.make_torch_dataloader(
                    batch_size=8, reader_kwargs={"num_epochs": 1, "workers_count": 1,
                                                 "shuffle_row_groups": False}) as dl:
                for batch in dl:
                    seen += batch["id"].shape[0]
                    assert isinstance(batch["vec"], torch.Tensor)
            out["torch_rows"] = seen
            print(f"torch DataLoader delivered {seen} rows")

            # a row read: the values survived the trip exactly
            with conv.make_reader(reader_pool_type="serial", num_epochs=1,
                                  shuffle_row_groups=False) as r:
                row5 = [row for row in r if row.id == 5][0]
            np.testing.assert_allclose(np.asarray(row5.vec), [5.0, 5.5, 5.25])
            out["row5_vec"] = np.asarray(row5.vec).tolist()
            print("row 5 vec == [5.0, 5.5, 5.25] - roundtrip exact")

            # the same DataFrame again: the plan's cache entry, no write
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                again = make_converter(df, cache_dir_url=cache_dir)
            out["cache_hit"] = again.cache_url == conv.cache_url
            assert out["cache_hit"]
            print("second make_converter() hit the cache (no re-materialization)")
        finally:
            conv.delete()
            cleanup()
    print("done (cache deleted)")
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--cache-dir", default=None)
    parser.add_argument("--rows", type=int, default=32)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    main(args.cache_dir, args.rows, args.device)
