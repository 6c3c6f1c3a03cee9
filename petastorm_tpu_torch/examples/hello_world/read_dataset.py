"""Read the hello-world dataset three ways: rows, columnar batches, the card.

Port of ``examples/hello_world/read_dataset.py``: ``make_reader`` rows,
``make_batch_reader`` batches of ``id``, and a ``CudaDataLoader`` feed of
``id`` and ``image1`` onto ``device`` (the card by default), where the JAX
example feeds a ``JaxDataLoader``; the ragged ``array_4d`` stays out of the
feed.  Each function prints what it reads and returns it.  Run ``python -m
petastorm_tpu_torch.examples.hello_world.read_dataset [URL] [--device cpu]``.
"""

import argparse

from petastorm_tpu_torch.cuda.loader import CudaDataLoader
from petastorm_tpu_torch.reader import make_batch_reader, make_reader


def python_hello_world(dataset_url: str) -> list:
    """Every row's ``(id, image1 shape, array_4d shape)``."""
    out = []
    with make_reader(dataset_url, num_epochs=1) as reader:
        for row in reader:
            print(f"row id={row.id}: image1 {row.image1.shape} array_4d {row.array_4d.shape}")
            out.append((int(row.id), row.image1.shape, row.array_4d.shape))
    return out


def columnar_hello_world(dataset_url: str) -> list:
    """The ``id`` column of each rowgroup."""
    out = []
    with make_batch_reader(dataset_url, num_epochs=1, schema_fields=["id"]) as reader:
        for batch in reader:
            print(f"columnar batch: ids {list(batch.id)}")
            out.append([int(i) for i in batch.id])
    return out


def cuda_hello_world(dataset_url: str, device="cuda") -> list:
    """Batches of 4 ``id``/``image1`` rows on ``device`` (the last padded,
    with ``'_valid_rows'``): each batch's tensors."""
    out = []
    reader = make_reader(dataset_url, num_epochs=1)
    # images land on the device; the ragged 4-D field stays out of the feed
    with CudaDataLoader(reader, batch_size=4, device=device, fields=["id", "image1"],
                        drop_last=False) as loader:
        for batch in loader:
            img = batch["image1"]
            print(f"device batch: image1 {tuple(img.shape)} {img.dtype} on {img.device}")
            out.append(batch)
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("dataset_url", nargs="?", default="/tmp/hello_world_dataset")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    python_hello_world(args.dataset_url)
    columnar_hello_world(args.dataset_url)
    cuda_hello_world(args.dataset_url, args.device)
