"""Probability-weighted mixing of several readers.

Counterpart of ``petastorm_tpu/weighted_sampling.py`` (the reference's
petastorm/weighted_sampling_reader.py): ``WeightedSamplingReader`` draws the
next row or batch from reader ``i`` with probability ``probabilities[i]``,
after checking that the readers agree (``batched_output``, NGram, schema,
decode placement).  The draw is seeded (``seed_stream(seed, 0,
'weighted_sampling')``), rows (``__next__``) and batches (``iter_batches``)
share one list of live readers, and every draw folds into an
order-sensitive crc chain, the mixture digest, beside each sub-reader's own
stream digest (``Reader.stream_digest``): over the same readers and seeds
it equals the JAX mixer's bit for bit.  ``deterministic='auto'`` derives a
mixer seed from the first reader's ``shuffle_seed`` when every sub-reader
runs seed-stable delivery and the mixer was given none.  The JAX mixer's
``telemetry`` property is not part of this package yet (telemetry is not).
"""

from __future__ import annotations

import logging
import struct
import zlib
from typing import List, Optional, Sequence

import numpy as np

from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.seeding import derive_seed, seed_stream

logger = logging.getLogger(__name__)


class WeightedSamplingReader:
    """Mix several compatible readers into one stream, drawing each next
    row/batch from reader ``i`` with probability ``probabilities[i]``
    (normalized; seeded for reproducibility).  Schemas must agree on the
    delivered fields; exhausted readers drop out and the remaining weights
    renormalize (reference weighted_sampling_reader semantics).

    ``deterministic`` (the mixer-side analog of ``make_reader``'s knob):
    under ``'auto'`` (default), when EVERY sub-reader runs
    ``deterministic='seed'`` delivery but ``seed`` is None, an unseeded
    mixer would be the one stage defeating stream reproducibility - so the
    mixer seed is derived from the first reader's ``shuffle_seed``
    (``seeding.derive_seed``, domain ``'weighted_sampling.auto'``), with
    one warning naming the derivation.  ``'off'`` keeps ``seed=None``
    unseeded (each run mixes differently) and warns once that the mix
    defeats reproducibility when the sub-readers were all seeded.  An
    explicit ``seed`` always wins and silences both.

    Every draw (including the draws that discover an exhausted reader)
    folds into the **mixture digest** - see :attr:`diagnostics`.
    """

    def __init__(self, readers: Sequence, probabilities: Sequence[float],
                 seed: Optional[int] = None, deterministic: str = "auto"):
        if len(readers) != len(probabilities) or not readers:
            raise PetastormTpuError("readers and probabilities must be same non-zero length")
        if deterministic not in ("auto", "off"):
            raise PetastormTpuError(
                f"deterministic must be 'auto' or 'off'; got"
                f" {deterministic!r}")
        p = np.asarray(probabilities, dtype=np.float64)
        if (p < 0).any() or p.sum() <= 0:
            raise PetastormTpuError(f"Invalid probabilities {probabilities}")
        self._p = p / p.sum()
        self._readers = list(readers)
        all_seeded = all(getattr(r, "deterministic", "off") == "seed"
                         for r in self._readers)
        if seed is None and all_seeded:
            if deterministic == "auto":
                # the sub-readers each deliver a seed-stable stream; an
                # unseeded mixer would be the single stage making the MIXED
                # stream irreproducible.  Derive the mixer seed from the
                # first reader's seed root so the whole mix is a pure
                # function of it (pass an explicit seed to pin, or
                # deterministic='off' to keep unseeded mixing).
                root = getattr(self._readers[0], "shuffle_seed", None)
                seed = derive_seed(root, 0, "weighted_sampling.auto")
                logger.warning(
                    "WeightedSamplingReader: every sub-reader runs"
                    " deterministic='seed' delivery but the mixer got"
                    " seed=None, which would defeat stream reproducibility;"
                    " deriving the mixer seed from the first reader's"
                    " shuffle_seed (%r). Pass seed=... to pin it, or"
                    " deterministic='off' to keep unseeded mixing.", root)
            else:
                logger.warning(
                    "WeightedSamplingReader: every sub-reader runs"
                    " deterministic='seed' delivery but the mix is unseeded"
                    " (seed=None, deterministic='off') - the MIXED stream"
                    " differs every run, defeating stream reproducibility."
                    " Pass seed=... for a reproducible mixture.")
        #: the resolved mixer seed (None = unseeded); diagnostics surface it
        self.seed = seed
        #: the adapters' view, as a Reader's: delivery through this mixer is
        #: seed-stable exactly when the mixer is seeded and every sub-reader
        #: is; ``shuffle_seed`` is the root the loaders derive their buffer
        #: seeds from (``seeding.reader_buffer_seed``)
        self.deterministic = ("seed" if seed is not None and all_seeded
                              else "off")
        self.shuffle_seed = seed if self.deterministic == "seed" else None
        # a seeded mix draws a stream independent of every other seeded
        # stage; None keeps the unseeded each-run-differs behavior
        self._rng = (seed_stream(seed, 0, "weighted_sampling")
                     if seed is not None else np.random.default_rng())
        # readers not yet exhausted by __next__; persists across calls so dead
        # readers are not re-drawn/re-polled on every remaining row
        self._alive: List[int] = list(range(len(self._readers)))
        # mixture certificate: order-sensitive crc chain over the draw
        # sequence (draw ordinal, chosen reader, exhaustion markers) - the
        # certified record of WHICH corpus each delivered unit came from
        self._draw_crc = 0
        self._draw_count = 0

        first = readers[0]
        self.batched_output = first.batched_output
        self.ngram = getattr(first, "ngram", None)
        self.schema = first.schema
        self.output_schema = getattr(first, "output_schema", first.schema)
        #: decode_placement='device' fields propagate so CudaDataLoader
        #: finds and finishes the coefficient-plane columns; every sub-reader
        #: must agree (a planes stream and a pixels stream cannot batch)
        self.device_decode_fields = list(
            getattr(first, "device_decode_fields", ()) or ())
        self.device_decode_mixed = frozenset(
            getattr(first, "device_decode_mixed", ()) or ())
        for r in readers[1:]:
            if r.batched_output != self.batched_output:
                raise PetastormTpuError("All readers must share batched_output mode")
            if getattr(r, "ngram", None) != self.ngram:
                raise PetastormTpuError(
                    "All readers must share an identical NGram spec (same"
                    " offsets, fields, delta_threshold, timestamp settings)")
            if list(r.schema.fields) != list(self.schema.fields):
                raise PetastormTpuError(
                    f"Schema mismatch: {list(r.schema.fields)} vs"
                    f" {list(self.schema.fields)}")
            if (list(getattr(r, "device_decode_fields", ()) or ())
                    != self.device_decode_fields
                    or frozenset(getattr(r, "device_decode_mixed", ()) or ())
                    != self.device_decode_mixed):
                raise PetastormTpuError(
                    "All readers must share the same decode_placement: one"
                    f" ships {self.device_decode_fields or 'pixels'} and"
                    f" another {getattr(r, 'device_decode_fields', []) or 'pixels'}"
                    " (mixed-geometry mode must also match)")

    @property
    def last_row_consumed(self) -> bool:
        """True once every underlying reader finished its epochs."""
        return all(r.last_row_consumed for r in self._readers)

    # -- mixture certificate ------------------------------------------------

    def _record_draw(self, reader_index: int, exhausted: bool = False) -> None:
        self._draw_crc = zlib.crc32(
            struct.pack("<3q", self._draw_count, int(reader_index),
                        1 if exhausted else 0), self._draw_crc)
        self._draw_count += 1

    @property
    def mixture_digest(self) -> dict:
        """The mixture-side stream certificate: the draw-sequence chain plus
        a combined value folding every sub-reader's own StreamDigest - two
        mixed runs are diffed in O(1) like single-reader ones.  ``combined``
        is only configuration-stable when the mixer is seeded and every
        sub-reader runs ``deterministic='seed'``."""
        combined = self._draw_crc
        readers = []
        for r in self._readers:
            # the JAX mixer reads diagnostics['stream_digest']; the port's
            # Reader gives the same summary as ``stream_digest``
            digest = getattr(r, "stream_digest", None)
            sub = digest.get("combined") if isinstance(digest, dict) else None
            readers.append(sub)
            combined = zlib.crc32(
                (sub or "-").encode("ascii", "replace"), combined)
        return {"draws": f"{self._draw_crc:08x}",
                "draw_count": self._draw_count,
                "readers": readers,
                "combined": f"{combined:08x}"}

    @property
    def diagnostics(self) -> dict:
        """Mixer diagnostics: the mixture digest, resolved seed and
        per-reader aliveness (sub-reader diagnostics stay on the readers)."""
        return {"mixture_digest": self.mixture_digest,
                "seed": self.seed,
                "alive_readers": list(self._alive),
                "num_readers": len(self._readers)}

    def __iter__(self):
        return self

    def __next__(self):
        if self.device_decode_fields:
            raise PetastormTpuError(
                f"fields {self.device_decode_fields} use"
                " decode_placement='device' (coefficient planes, not pixels);"
                " consume through petastorm_tpu_torch.cuda.CudaDataLoader or use"
                " decode_placement='host'")
        while self._alive:
            weights = self._p[self._alive] / self._p[self._alive].sum()
            i = int(self._rng.choice(len(self._alive), p=weights))
            try:
                row = next(self._readers[self._alive[i]])
            except StopIteration:
                self._record_draw(self._alive[i], exhausted=True)
                self._alive.pop(i)
            else:
                self._record_draw(self._alive[i])
                return row
        raise StopIteration

    def iter_batches(self):
        """Columnar batches drawn from the mixed stream (device-feed path).
        Shares the aliveness ledger with ``__next__`` (one consumption mode
        per instance), so ``diagnostics['alive_readers']`` stays truthful
        for batch consumers too."""
        sources = [r.iter_batches() for r in self._readers]
        alive = self._alive
        while alive:
            weights = self._p[alive] / self._p[alive].sum()
            i = int(self._rng.choice(len(alive), p=weights))
            try:
                batch = next(sources[alive[i]])
            except StopIteration:
                self._record_draw(alive[i], exhausted=True)
                alive.pop(i)
            else:
                self._record_draw(alive[i])
                yield batch

    def stop(self) -> None:
        """Stop every underlying reader."""
        for r in self._readers:
            r.stop()

    def join(self) -> None:
        """Wait for every underlying reader to exit (after stop())."""
        for r in self._readers:
            r.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        self.join()
