"""Generate the hello-world dataset: an id, a PNG image and a variable 4-D array.

Port of ``examples/hello_world/generate_dataset.py`` over the port's
``write_dataset``: the same ``HelloWorldSchema``, rows and seed.  Run
``python -m petastorm_tpu_torch.examples.hello_world.generate_dataset [URL]``.
"""

import argparse

import numpy as np

from petastorm_tpu_torch.codecs import CompressedImageCodec, NdarrayCodec, ScalarCodec
from petastorm_tpu_torch.etl.writer import write_dataset
from petastorm_tpu_torch.schema import Field, Schema

HelloWorldSchema = Schema("HelloWorld", [
    Field("id", np.int32, (), ScalarCodec()),
    Field("image1", np.uint8, (128, 256, 3), CompressedImageCodec("png")),
    Field("array_4d", np.uint8, (None, 128, 30, None), NdarrayCodec()),
])


def row_generator(i: int, rng: np.random.Generator) -> dict:
    return {
        "id": i,
        "image1": rng.integers(0, 255, (128, 256, 3), dtype=np.uint8),
        "array_4d": rng.integers(0, 255, (4, 128, 30, 3), dtype=np.uint8),
    }


def generate_hello_world_dataset(output_url: str, rows_count: int = 10, seed: int = 1) -> None:
    rng = np.random.default_rng(seed)
    write_dataset(output_url, HelloWorldSchema,
                  (row_generator(i, rng) for i in range(rows_count)),
                  row_group_size_mb=256, mode="overwrite")


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("output_url", nargs="?", default="/tmp/hello_world_dataset")
    parser.add_argument("--rows", type=int, default=10)
    args = parser.parse_args()
    generate_hello_world_dataset(args.output_url, args.rows)
    print(f"wrote {args.rows} rows to {args.output_url}")
