"""Columnar shuffling buffers between the rowgroup reads and batch emission.

The port's copy of ``petastorm_tpu/shuffle.py``: ``iter_batched`` ``:29``,
``iter_batched_multi`` ``:69``, ``ShufflingBufferBase`` ``:158``,
``NoopShufflingBuffer`` ``:196`` and ``RandomShufflingBuffer`` ``:246``
with its coefficient-plane geometry guard (``:296-305``).  Rows live in
per-column numpy arrays; a retrieve gathers ``n`` rows drawn by numpy's
``default_rng`` with one fancy index a column and fills the holes by
swap-remove.  Host shuffling is numpy work in both packages, so with the same
seed and the same arrival order this copy gives the JAX package's batches row
for row.
"""

from __future__ import annotations

import queue
from collections import deque
from typing import Dict, Optional

import numpy as np

from petastorm_tpu_torch.batch import ColumnBatch
from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.native.image import COEF_COLUMN_SEP, _MIXED_GEOMETRY_GUIDANCE


def iter_batched(source, buffer: "ShufflingBufferBase", batch_size: int):
    """Pump ColumnBatches from ``source`` through a shuffling buffer, yielding
    batches of exactly ``batch_size`` rows (smaller ones only as the stream's
    tail drains after the source is exhausted).

    The one fill/retrieve/finish/drain engine of the loader and the torch
    adapter: adds stay within ``free_space``, retrieval above the
    decorrelation floor, and the tail drains after ``finish()``.
    """
    pending = None  # chunk not yet fully added to the buffer
    exhausted = False
    while True:
        while buffer.can_retrieve(batch_size):
            # after finish() this also drains the (possibly partial) tail
            yield buffer.retrieve(batch_size)
        if exhausted:
            return
        if pending is None:
            try:
                pending = next(source)
            except StopIteration:
                exhausted = True
                buffer.finish()
                continue
        if pending.num_rows == 0:
            pending = None
            continue
        room = buffer.free_space
        if room <= 0:
            # full yet not retrievable: capacity < min_after + batch_size
            raise PetastormTpuError(
                "Shuffling buffer deadlock: capacity cannot hold"
                " min_after_retrieve + one batch; raise the buffer capacity or"
                " lower min_after_retrieve/batch_size")
        take = int(min(room, pending.num_rows))
        buffer.add(pending.slice_rows(0, take))
        pending = (pending.slice_rows(take, pending.num_rows)
                   if take < pending.num_rows else None)


def iter_batched_multi(next_fn, route_fn, buffer_factory, batch_size: int,
                       straggler_release_s=None, on_straggler_release=None):
    """:func:`iter_batched` generalized two ways:

    * **form partitioning** - ``route_fn(batch)`` keys each source batch into
      its own shuffling buffer, and batches only ever assemble within a key.
      A constant route is exactly ``iter_batched``.
    * **straggler release** - ``next_fn`` is called with
      ``straggler_release_s`` as a timeout; when the source times
      out (raises ``queue.Empty``) while a buffer already holds a full batch
      that only the shuffle decorrelation floor (``min_after_retrieve``) is
      withholding, the floor is bypassed and the batch released.  A slow
      rowgroup then stops gating batch assembly; its rows ride a later batch
      when they arrive.  ``None`` disables (``next_fn`` is then called with
      ``None`` = block).

    ``next_fn(timeout)`` returns the next batch, raises ``StopIteration`` at
    end of stream, or raises ``queue.Empty`` on timeout.  Buffer invariants
    (bounded adds, floor-gated retrieval, tail drain after finish) match
    :func:`iter_batched`.
    """
    states: dict = {}  # route key -> {"buffer": ..., "pending": ...}

    def _state(key):
        st = states.get(key)
        if st is None:
            st = states[key] = {"buffer": buffer_factory(), "pending": None}
        return st

    exhausted = False
    while True:
        progressed = True
        while progressed:
            progressed = False
            for st in states.values():
                buf = st["buffer"]
                while buf.can_retrieve(batch_size):
                    yield buf.retrieve(batch_size)
                    progressed = True
                pending = st["pending"]
                if pending is None:
                    continue
                room = buf.free_space
                if room <= 0:
                    if buf.can_retrieve(batch_size):
                        continue  # next sweep retrieves, making room
                    raise PetastormTpuError(
                        "Shuffling buffer deadlock: capacity cannot hold"
                        " min_after_retrieve + one batch; raise the buffer"
                        " capacity or lower min_after_retrieve/batch_size")
                take = int(min(room, pending.num_rows))
                buf.add(pending.slice_rows(0, take))
                st["pending"] = (pending.slice_rows(take, pending.num_rows)
                                 if take < pending.num_rows else None)
                progressed = True
        if exhausted:
            for st in states.values():
                st["buffer"].finish()
            for st in states.values():
                buf = st["buffer"]
                while buf.can_retrieve(batch_size):
                    yield buf.retrieve(batch_size)
            return
        try:
            nxt = next_fn(straggler_release_s)
        except StopIteration:
            exhausted = True
            continue
        except queue.Empty:
            # source straggling: release any full batch that only the
            # decorrelation floor is holding back (force bypasses it)
            for st in states.values():
                buf = st["buffer"]
                if (buf.size >= batch_size
                        and not buf.can_retrieve(batch_size)):
                    if on_straggler_release is not None:
                        on_straggler_release()
                    yield buf.retrieve(batch_size, force=True)
            continue
        if nxt.num_rows == 0:
            continue
        _state(route_fn(nxt))["pending"] = nxt


class ShufflingBufferBase:
    def add(self, batch: ColumnBatch) -> None:
        """Accept one columnar batch into the buffer (caller checked
        ``can_add``)."""
        raise NotImplementedError

    def retrieve(self, n: int, force: bool = False) -> ColumnBatch:
        """Remove and return exactly ``n`` rows (caller checked
        ``can_retrieve(n)``).  ``force=True`` bypasses the decorrelation
        floor (straggler release: a slow source must not gate assembly when
        a full batch is already buffered)."""
        raise NotImplementedError

    def finish(self) -> None:
        """No more adds; drain whatever remains."""
        raise NotImplementedError

    @property
    def size(self) -> int:
        """Rows currently buffered."""
        raise NotImplementedError

    @property
    def can_add(self) -> bool:
        """True while the buffer has room for another batch."""
        raise NotImplementedError

    @property
    def free_space(self) -> float:
        """Rows that may still be added (inf for unbounded buffers)."""
        raise NotImplementedError

    def can_retrieve(self, n: int) -> bool:
        """True when ``n`` rows can be retrieved now (respects the
        ``min_after_retrieve`` mixing floor until ``finish``)."""
        raise NotImplementedError


class NoopShufflingBuffer(ShufflingBufferBase):
    """FIFO pass-through (reference NoopShufflingBuffer)."""

    def __init__(self):
        self._batches: deque = deque()
        self._size = 0
        self._finished = False

    def add(self, batch: ColumnBatch) -> None:
        if self._finished:
            raise PetastormTpuError("add() after finish()")
        if batch.num_rows:
            self._batches.append(batch)
            self._size += batch.num_rows

    def retrieve(self, n: int, force: bool = False) -> ColumnBatch:
        out = []
        need = n
        while need > 0 and self._batches:
            head = self._batches[0]
            if head.num_rows <= need:
                out.append(self._batches.popleft())
                need -= head.num_rows
            else:
                out.append(head.slice_rows(0, need))
                self._batches[0] = head.slice_rows(need, head.num_rows)
                need = 0
        got = ColumnBatch.concat(out)
        self._size -= got.num_rows
        return got

    def finish(self) -> None:
        self._finished = True

    @property
    def size(self) -> int:
        return self._size

    @property
    def can_add(self) -> bool:
        return not self._finished

    @property
    def free_space(self) -> float:
        return float("inf")

    def can_retrieve(self, n: int) -> bool:
        return self._size >= n or (self._finished and self._size > 0)


class RandomShufflingBuffer(ShufflingBufferBase):
    """Uniform-without-replacement batch sampling from a bounded columnar pool.

    ``capacity``: max buffered rows (backpressure bound).
    ``min_after_retrieve``: decorrelation floor - retrieval is refused until the
    pool holds ``min_after_retrieve + n`` rows (until ``finish()``), matching the
    reference's shuffling_queue_capacity/min_after_dequeue semantics
    (shuffling_buffer.py:96-118).
    """

    def __init__(self, capacity: int, min_after_retrieve: int = 0,
                 seed: Optional[int] = None):
        if capacity < 1:
            raise PetastormTpuError("capacity must be >= 1")
        if min_after_retrieve > capacity:
            raise PetastormTpuError("min_after_retrieve cannot exceed capacity")
        self._capacity = capacity
        self._min_after = min_after_retrieve
        # seed: an int (preferably seeding.derive_seed output - the
        # centralized derivation every stochastic stage shares) or None
        # (each run mixes differently).  With a seed and deterministic
        # delivery, every retrieve is a pure function of (seed, retrieval
        # position), never of arrival timing.  default_rng also passes a
        # pre-built Generator through unchanged.
        self._rng = np.random.default_rng(seed)
        self._columns: Optional[Dict[str, np.ndarray]] = None
        self._size = 0
        self._finished = False

    def _allocate(self, batch: ColumnBatch) -> None:
        self._columns = {}
        for name, col in batch.columns.items():
            if col.dtype == object:
                self._columns[name] = np.empty(self._capacity, dtype=object)
            else:
                self._columns[name] = np.empty((self._capacity,) + col.shape[1:],
                                               dtype=col.dtype)

    def add(self, batch: ColumnBatch) -> None:
        if self._finished:
            raise PetastormTpuError("add() after finish()")
        if not batch.num_rows:
            return
        if self._columns is None:
            self._allocate(batch)
        n = batch.num_rows
        if self._size + n > self._capacity:
            raise PetastormTpuError(
                f"Buffer overflow: {self._size}+{n} > capacity {self._capacity}."
                " Check can_add before adding (caller must keep adds <= capacity).")
        for name, col in batch.columns.items():
            buf = self._columns[name]
            if buf.dtype != object and col.shape[1:] != buf.shape[1:]:
                if COEF_COLUMN_SEP in name:
                    raise PetastormTpuError(
                        f"Column {name!r}: coefficient-plane shapes differ"
                        f" between rowgroups: {_MIXED_GEOMETRY_GUIDANCE}")
                raise PetastormTpuError(
                    f"Column {name!r} row-shape {col.shape[1:]} does not match"
                    f" buffer {buf.shape[1:]}; pad variable fields before shuffling")
            buf[self._size:self._size + n] = col
        self._size += n

    def retrieve(self, n: int, force: bool = False) -> ColumnBatch:
        if not force and not self.can_retrieve(n):
            raise PetastormTpuError("retrieve() refused: below decorrelation floor")
        n = min(n, self._size)
        pick = self._rng.choice(self._size, size=n, replace=False)
        # fancy indexing already copies; swap-remove moves tail rows into holes
        out = {name: buf[pick] for name, buf in self._columns.items()}
        keep_tail = np.setdiff1d(np.arange(self._size - n, self._size), pick,
                                 assume_unique=True)
        holes = np.sort(pick[pick < self._size - n])
        tail_sorted = np.sort(keep_tail)
        for buf in self._columns.values():
            buf[holes] = buf[tail_sorted]
        self._size -= n
        return ColumnBatch(out, n)

    def finish(self) -> None:
        self._finished = True

    @property
    def size(self) -> int:
        return self._size

    @property
    def can_add(self) -> bool:
        return not self._finished and self._size < self._capacity

    @property
    def free_space(self) -> float:
        return self._capacity - self._size

    def can_retrieve(self, n: int) -> bool:
        if self._size == 0:
            return False
        if self._finished:
            return True
        return self._size - n >= self._min_after
