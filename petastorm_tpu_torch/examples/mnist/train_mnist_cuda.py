"""MNIST-style training on one CUDA GPU: dataset -> CudaDataLoader -> MLP.

Port of ``examples/mnist/train_mnist_jax.py`` with the same ``MnistSchema``,
``generate_dataset``, CLI and defaults.  Each epoch reads the dataset with
``make_reader(shuffle_seed=epoch)`` into ``CudaDataLoader(fields=["image",
"digit"], shuffling_queue_capacity=256, buffer_seed=epoch)``; the uint8
digits arrive on the card and the step (:class:`TrainStep`) normalizes them
there with ``normalize_images(image[..., None], mean=0.5, std=0.5)`` (kernel
B1, bf16 out, as in the JAX step), runs the MLP in float32, takes the mean
one-hot cross-entropy and one ``torch.optim.Adam(lr=1e-3)`` step.  The
dataset is synthetic: 28x28 noise with a bright class-coded blob, so the
digits are learnable.  ``device='cuda'`` is the default; ``device='cpu'``
runs B1's plain version (for tests).  Run ``python -m
petastorm_tpu_torch.examples.mnist.train_mnist_cuda --help``.

optax's Adam divides by ``sqrt(nu / (1 - b2^t)) + eps`` and torch's by
``sqrt(nu) / sqrt(1 - b2^t) + eps``: the same value, rounded in another
order.  ``tests/test_torch_mlp.py`` holds two steps to the JAX example's.
"""

from __future__ import annotations

import argparse
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
from petastorm_tpu_torch.cuda.loader import CudaDataLoader
from petastorm_tpu_torch.device import resolve_device
from petastorm_tpu_torch.etl.writer import write_dataset
from petastorm_tpu_torch.models import MLP
from petastorm_tpu_torch.ops import normalize_images
from petastorm_tpu_torch.reader import make_reader
from petastorm_tpu_torch.schema import Field, Schema

MnistSchema = Schema("Mnist", [
    Field("idx", np.int64, (), ScalarCodec()),
    Field("digit", np.int64, (), ScalarCodec()),
    Field("image", np.uint8, (28, 28), NdarrayCodec()),
])
CLASSES = 10


def generate_dataset(url: str, rows: int, seed: int = 0) -> None:
    """Synthetic digits: a class-dependent blob position plus noise (the JAX
    example's rows, drawn in the same order from the same seed)."""
    rng = np.random.default_rng(seed)

    def row(i):
        digit = int(rng.integers(0, 10))
        img = rng.integers(0, 40, (28, 28)).astype(np.uint8)
        r, c = divmod(digit, 5)
        img[4 + r * 12: 12 + r * 12, 2 + c * 5: 7 + c * 5] += 180
        return {"idx": i, "digit": digit, "image": img}

    write_dataset(url, MnistSchema, (row(i) for i in range(rows)),
                  row_group_size_rows=max(rows // 8, 1), mode="overwrite")


class TrainStep:
    """One training step on explicit batches: ``step(image_u8, digit)``
    takes a uint8 ``(N, 28, 28)`` tensor and int64 labels on the model's
    device and returns the batch's ``(loss, accuracy)`` as 0-d tensors, not
    synchronized.  ``normalize_images`` (B1) runs once a call."""

    def __init__(self, model: MLP, lr: float = 1e-3):
        self.model = model
        self.optimizer = torch.optim.Adam(model.parameters(), lr=lr)

    def __call__(self, image_u8: torch.Tensor, digit: torch.Tensor):
        # on-card u8 -> bf16 normalize (one channel: scalar mean and std)
        x = normalize_images(image_u8[..., None], mean=0.5, std=0.5)[..., 0]
        logits = self.model(x)
        onehot = F.one_hot(digit, CLASSES).to(logits.dtype)
        loss = -(F.log_softmax(logits, dim=-1) * onehot).sum(-1).mean()
        acc = (logits.argmax(-1) == digit).float().mean()
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return loss.detach(), acc


def make_step(device="cuda", lr: float = 1e-3) -> TrainStep:
    """A :class:`TrainStep` over a fresh ``MLP`` (784 -> 128 -> 64 -> 10)
    drawn from seed 0."""
    model = MLP(28 * 28, num_classes=CLASSES, device=device,
                generator=torch.Generator().manual_seed(0))
    return TrainStep(model, lr)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(dataset_url: str, epochs: int = 3, batch_size: int = 32, lr: float = 1e-3,
          shuffling_queue_capacity: int = 256, device="cuda", verbose: bool = True) -> Dict:
    """``epochs`` epochs over the dataset; returns ``{"accuracy": <the last
    epoch's mean batch accuracy>, "epochs": [...]}``, one dict an epoch with
    its ``loss``, ``accuracy``, ``steps``, ``seconds``, ``samples_per_s`` and
    ``consumer_wait_share`` (the loader's ``consumer_wait_s`` over the wall
    time), both taken after the epoch's first step."""
    device = resolve_device(device)
    step = make_step(device, lr)
    history: List[Dict] = []
    for epoch in range(epochs):
        reader = make_reader(dataset_url, num_epochs=1, shuffle_seed=epoch)
        losses, accs = [], []
        with CudaDataLoader(reader, batch_size=batch_size, device=device,
                            fields=["image", "digit"],
                            shuffling_queue_capacity=shuffling_queue_capacity,
                            buffer_seed=epoch) as loader:
            for batch in loader:
                loss, acc = step(batch["image"], batch["digit"])
                losses.append(loss)
                accs.append(acc)
                if len(losses) == 1:
                    _sync(device)
                    start, wait0 = time.perf_counter(), loader.diagnostics()["consumer_wait_s"]
            _sync(device)
            seconds = time.perf_counter() - start
            wait = loader.diagnostics()["consumer_wait_s"] - wait0
        stats = {"epoch": epoch, "loss": torch.stack(losses).float().mean().item(),
                 "accuracy": torch.stack(accs).mean().item(), "steps": len(losses),
                 "seconds": seconds,
                 "samples_per_s": (len(losses) - 1) * batch_size / seconds,
                 "consumer_wait_share": wait / seconds}
        history.append(stats)
        if verbose:
            print(f"epoch {epoch}: loss {stats['loss']:.4f} acc {stats['accuracy']:.3f}")
    return {"accuracy": history[-1]["accuracy"], "epochs": history}


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset-url", default=None)
    parser.add_argument("--rows", type=int, default=2048)
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    url = args.dataset_url or tempfile.mkdtemp(prefix="mnist_cuda_") + "/mnist"
    generate_dataset(url, args.rows)
    final = train(url, epochs=args.epochs, batch_size=args.batch_size, device=args.device)
    print(f"final train accuracy: {final['accuracy']:.3f}")
