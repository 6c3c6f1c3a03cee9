"""Preemption-safe training on one CUDA GPU: exact mid-epoch checkpoints
through ``loader.drain()``.

Port of ``examples/preemption/train_with_preemption.py``.  A linear
classifier trains from ``make_batch_reader`` -> ``CudaDataLoader(
drop_last=False)``; the loss of every batch is weighted by the loader's
valid mask, so the zero-padded tail trains on its real rows only.

1. Train until the "preemption signal" (``--preempt-at`` steps).
2. ``loader.drain()``: train on every batch already in flight; the loader's
   cursor is then exact.  Save the model, the optimizer and the cursor with
   ``checkpoint.save_checkpoint`` (the JAX example keeps the cursor beside
   its jax state; orbax's counterpart here is a ``torch.save`` a step).
3. Restart: restore into a fresh model, optimizer, reader and loader
   (``checkpoint.resume_reader_kwargs``) and finish the epoch: every row is
   seen exactly once across the two incarnations.

Run ``python -m
petastorm_tpu_torch.examples.preemption.train_with_preemption_cuda --help``.
"""

import argparse
import os
import tempfile
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from petastorm_tpu_torch.checkpoint import (make_checkpoint_manager, restore_checkpoint,
                                            resume_reader_kwargs, save_checkpoint)
from petastorm_tpu_torch.codecs import NdarrayCodec
from petastorm_tpu_torch.cuda.loader import CudaDataLoader
from petastorm_tpu_torch.device import resolve_device
from petastorm_tpu_torch.etl.writer import write_dataset
from petastorm_tpu_torch.reader import make_batch_reader
from petastorm_tpu_torch.schema import Field, Schema

FEATS, CLASSES = 16, 4
MASK = "mask"


def generate_dataset(url: str, rows: int = 512, seed: int = 0) -> None:
    """The JAX example's rows: standard-normal features, labels from a
    random linear map."""
    rng = np.random.default_rng(seed)
    schema = Schema("Preempt", [
        Field("x", np.float32, (FEATS,), NdarrayCodec()),
        Field("y", np.int64),
    ])
    w = rng.standard_normal((FEATS, CLASSES))
    xs = rng.standard_normal((rows, FEATS)).astype(np.float32)
    ys = (xs @ w).argmax(axis=1)
    write_dataset(url, schema, [{"x": xs[i], "y": int(ys[i])} for i in range(rows)],
                  row_group_size_rows=16)


class Trainer:
    """A linear classifier ``x @ w + b`` from zeros and its SGD optimizer;
    ``step(x, y, mask)`` takes one step on the mask-weighted mean
    cross-entropy and returns the loss."""

    def __init__(self, device, lr: float = 0.1):
        self.w = torch.zeros(FEATS, CLASSES, device=device, requires_grad=True)
        self.b = torch.zeros(CLASSES, device=device, requires_grad=True)
        self.optimizer = torch.optim.SGD([self.w, self.b], lr=lr)

    def step(self, x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        losses = F.cross_entropy(x @ self.w + self.b, y, reduction="none")
        loss = (losses * mask).sum() / mask.sum().clamp(min=1.0)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def state_dict(self) -> dict:
        return {"w": self.w.detach().clone(), "b": self.b.detach().clone(),
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        with torch.no_grad():
            self.w.copy_(state["w"])
            self.b.copy_(state["b"])
        self.optimizer.load_state_dict(state["optimizer"])


def _loader(url, batch_size, device, resume_kwargs=None):
    reader = make_batch_reader(url, reader_pool_type="thread", workers_count=2,
                               results_queue_size=4, shuffle_seed=7, num_epochs=1,
                               **(resume_kwargs or {}))
    return CudaDataLoader(reader, batch_size=batch_size, device=device, drop_last=False,
                          valid_mask_field=MASK)


def _train_on(trainer, batch, on_rows):
    loss = trainer.step(batch["x"], batch["y"], batch[MASK])
    rows = int(batch.get("_valid_rows", batch["x"].shape[0]))
    if on_rows is not None:
        on_rows(batch["x"][:rows].cpu().numpy())
    return loss, rows


def train(url: str, batch_size: int = 32, preempt_at: int = 3, lr: float = 0.1,
          ckpt_dir: Optional[str] = None, device="cuda", verbose: bool = True,
          on_rows: Optional[Callable[[np.ndarray], None]] = None):
    """Returns ``(rows seen before the preemption, rows seen after it, the
    final loss)``.  ``on_rows`` is called with the real rows of ``x`` of
    every trained batch, in both incarnations."""
    device = resolve_device(device)
    manager = make_checkpoint_manager(ckpt_dir or tempfile.mkdtemp(prefix="preempt_ckpt_"))

    # --- incarnation 1: train until the "preemption signal" -----------------
    trainer, seen_a, steps = Trainer(device, lr), 0, 0
    with _loader(url, batch_size, device) as loader:
        it = iter(loader)
        for _ in range(preempt_at):
            try:
                batch = next(it)
            except StopIteration:
                break  # the epoch is shorter than preempt_at: nothing left to cut
            loss, rows = _train_on(trainer, batch, on_rows)
            seen_a, steps = seen_a + rows, steps + 1
        # preemption: train on what is in flight, then the cursor is exact.
        # Every drained batch trains with its mask (a padded tail's zero
        # rows weigh nothing), so no control flow depends on '_valid_rows'
        for batch in loader.drain():
            loss, rows = _train_on(trainer, batch, on_rows)
            seen_a, steps = seen_a + rows, steps + 1
        save_checkpoint(manager, steps, trainer.state_dict(), loader)
    if verbose:
        print(f"preempted after {seen_a} rows; exact cursor saved at step {steps}")

    # --- incarnation 2: restore into fresh objects and finish the epoch ------
    trainer = Trainer(device, lr)
    state, loader_state = restore_checkpoint(manager, template={"w": trainer.w.detach(),
                                                                "b": trainer.b.detach()})
    if not loader_state["reader"]["ordinal_exact"]:
        raise RuntimeError("the drained cursor is not exact")
    trainer.load_state_dict(state)
    seen_b = 0
    with _loader(url, batch_size, device, resume_reader_kwargs(loader_state)) as loader:
        for batch in loader:
            loss, rows = _train_on(trainer, batch, on_rows)
            seen_b += rows
    if verbose:
        print(f"resumed run saw {seen_b} rows; loss {float(loss):.4f}")
    return seen_a, seen_b, float(loss)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--rows", type=int, default=512)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--preempt-at", type=int, default=3)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    tmp = tempfile.mkdtemp(prefix="preempt_example_")
    url = os.path.join(tmp, "ds")
    generate_dataset(url, rows=args.rows)
    seen_a, seen_b, _ = train(url, batch_size=args.batch_size, preempt_at=args.preempt_at,
                              ckpt_dir=os.path.join(tmp, "ckpt"), device=args.device)
    total = seen_a + seen_b
    print(f"rows: {seen_a} before + {seen_b} after preemption = {total}"
          f" (dataset has {args.rows}; zero re-reads, zero loss)")
    if total != args.rows:
        raise SystemExit(f"{total} rows trained, expected {args.rows}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
