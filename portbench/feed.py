"""The run's context and the feed every job drives: ``make_reader`` ->
``CudaDataLoader``, set as the traffic file says, and :class:`FeedJob`, the
feed side every job shares."""

from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, List, Optional

import numpy as np


def sub_seed(seed: int, name: str, bits: int = 63) -> int:
    """A seed for one use (``name``) derived from the run's seed, which may
    be any whole number >= 0, larger than 64 bits too."""
    words = [seed >> (32 * i) & 0xFFFFFFFF for i in range(max(1, (seed.bit_length() + 31) // 32))]
    state = np.random.SeedSequence(words + [zlib.crc32(name.encode())]).generate_state(
        1, np.uint64)[0]
    return int(state) & ((1 << bits) - 1)


@dataclasses.dataclass
class Context:
    """What a job is given: the cell's configuration and traffic, the seed,
    the device, the corpus and, in a traced run, the telemetry recorder."""

    config: Dict
    traffic: Dict
    seed: int
    device: object
    corpus: object
    telemetry: Optional[object] = None

    def seed_for(self, name: str, bits: int = 63) -> int:
        return sub_seed(self.seed, name, bits)


def make_feed(ctx: Context):
    """The reader over the corpus and the loader over it, on ``ctx.device``:
    every row once an epoch, epochs without end, in the order of the run's
    seed, images padded to the configuration's ``pad_to``; the traffic's
    ``reader`` and ``loader`` entries are the two calls' further arguments."""
    from petastorm_tpu_torch import make_reader
    from petastorm_tpu_torch.cuda.loader import CudaDataLoader

    reader = make_reader(ctx.corpus.path, num_epochs=None,
                         shuffle_seed=ctx.seed_for("reader", 31), telemetry=ctx.telemetry,
                         **ctx.traffic["reader"])
    loader = CudaDataLoader(reader, batch_size=int(ctx.config["batch"]), device=ctx.device,
                            pad_shapes={"image": tuple(ctx.config["pad_to"])},
                            **ctx.traffic["loader"])
    return reader, loader


class FeedJob:
    """The feed side of a job: batches taken from the loader, each batch's
    row ids and crop boxes since :meth:`forget`, the loader's counters.

    A job sets ``kind``, ``rate_metric`` (the end-to-end metric its window's
    samples a second are reported as), ``trace_units`` (the units of its
    profiled stretch), ``antialias`` (its crop), and implements ``setup``,
    ``unit``, ``close`` and the check."""

    kind = ""
    rate_metric = ""
    trace_units = 0
    antialias = False

    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.config = ctx.config
        self.batch = int(ctx.config["batch"])
        self.delivered = 0          # batches taken from the loader
        self.pulled: List = []      # row ids of batches pulled_from.. on
        self.pulled_from = 0
        self.boxes: List = []       # each batch's crop boxes since forget()

    def start_feed(self) -> None:
        self.reader, self.loader = make_feed(self.ctx)
        self.it = iter(self.loader)

    def _next(self) -> Dict:
        from portbench import trace

        with trace.host_range("portbench.next_batch"):
            batch = next(self.it)
        self.pulled.append(batch["row_id"])
        self.delivered += 1
        return batch

    def pull(self) -> None:
        """Take one batch and do nothing with it (after the window)."""
        self._next()

    def forget(self) -> None:
        """Drop the per-batch records so far."""
        self.pulled, self.boxes = [], []
        self.pulled_from = self.delivered

    def wait_s(self) -> float:
        return self.loader.diagnostics()["consumer_wait_s"]

    def staged_units(self) -> int:
        return self.loader.diagnostics()["units_staged"]

    def pool_note(self) -> str:
        """The reader's pool as the run left it: the autotune controller's
        knobs and moves where ``workers_count='auto'`` armed it."""
        diag = self.reader.diagnostics
        tuned = diag.get("autotune")
        if not tuned:
            return f"pool: {dict(self.ctx.traffic['reader'])}"
        return (f"pool: autotune knobs {tuned['knobs']}, moves applied {tuned['moves_applied']},"
                f" kept {tuned['moves_kept']}, reverted {tuned['moves_reverted']}")

    def stop_feed(self) -> None:
        """Stop the loader's threads and the reader's pool."""
        self.loader.stop()
        del self.loader, self.reader, self.it
        self.pulled, self.boxes = [], []

    def crop_work(self, first: int, last: int) -> Dict[str, float]:
        """B3's bytes and operations over units ``first`` .. ``last - 1``."""
        from portbench import roofline

        side = int(self.config["image_side"])
        total = {"bytes": 0.0, "flops": 0.0}
        for boxes in self.boxes[first:last]:
            work = roofline.resample_work(self.config["pad_to"], boxes.cpu(), (side, side),
                                          antialias=self.antialias)
            total = {k: total[k] + work[k] for k in total}
        return total
