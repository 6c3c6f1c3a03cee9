"""ColumnBatch transport over the shared-memory arena: the process pool's
data plane.

The port's copy of ``petastorm_tpu/native/transport.py:42-369``.  A worker
encodes each result batch into the arena (one copy on the producer side, or
none for a column the codec decoded straight into an arena slot); the
consumer decodes it by wrapping numpy arrays over the shared memory (no copy),
and each block is freed when the last array over it dies (:class:`_Lease`).

Object columns (strings, ragged cells, a ``'device-mixed'`` field's cells)
travel inside the descriptor, pickled.  So does a whole batch wider than half
the arena, or one that finds the arena full for ``max_wait_s`` (10 s): the
pool counts such batches (``pickled_batches``), so a run can prove that none
did.

Batch slots (``codecs.decode_options(batch_slots=True)``, ``worker.py``): the
encoder installs a :class:`SlotAllocator` on the worker's thread around each
item, the image codec allocates its batch-shaped output from it, and
``encode_batch`` ships that column as a ``("slot", ...)`` reference with no
copy at all.  The worker arms slots only where no cache keeps references to
its batches.

The result wrapper counts nothing itself: worker processes do not share
Python counters with the consumer.  It writes the arena's use after each
encode into a shared cell (``peak_cell``), from which the pool reads the
high-water mark.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

from petastorm_tpu_torch.batch import ColumnBatch
from petastorm_tpu_torch.native import SharedArena

logger = logging.getLogger(__name__)

_ALIGN = 64
_ALLOC_RETRY_S = 0.01


def _align(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


@dataclasses.dataclass
class ShmBatchRef:
    """Picklable descriptor of a batch whose raw columns live in the arena.

    ``columns``: name -> ``("shm", dtype, shape, rel_offset)`` (packed into
    the one block at ``offset`` by ``encode_batch``), ``("slot", dtype,
    shape, abs_offset, nbytes)`` (decoded into its own block by the worker),
    or ``("inline", value)`` (pickled with the descriptor).  ``offset`` is
    None when nothing was packed."""
    offset: Optional[int]
    total_bytes: int
    num_rows: int
    columns: Dict[str, Tuple]


class _Lease:
    """Owns one arena block; numpy arrays built over it keep it alive (PEP 688
    buffer protocol), and the block is freed when the last of them dies."""

    def __init__(self, arena: SharedArena, offset: int, size: int):
        self._arena = arena
        self._offset = offset
        self._mv = arena.view(offset, size)

    def __buffer__(self, flags):
        return memoryview(self._mv)

    def __del__(self):
        try:
            self._mv.release()
            if not self._arena.closed:
                self._arena.free(self._offset)
        except Exception:  # noqa: BLE001 - never raise from gc
            pass


def is_arena_backed(array: Any) -> bool:
    """True when ``array`` is a view of an arena block (a :class:`_Lease`
    down its chain of bases)."""
    base = array
    while base is not None:
        if isinstance(base, _Lease):
            return True
        base = base.obj if isinstance(base, memoryview) else getattr(base, "base", None)
    return False


# -- batch-slot decode: the codec's output allocated in the arena ------------

_SLOT_TLS = threading.local()


def current_slot_allocator() -> Optional["SlotAllocator"]:
    """The :class:`SlotAllocator` active on this thread (installed by the
    process pool's result encoder around the worker function), or None."""
    return getattr(_SLOT_TLS, "allocator", None)


class SlotAllocator:
    """Arena-backed output allocator for decode-into-slot
    (``petastorm_tpu/native/transport.py:99``).

    One a work item, on the worker's thread: a codec asks :meth:`alloc` for
    its batch-shaped output (None when the arena is full or the request is
    wider than half of it: the codec then allocates plain memory);
    ``encode_batch`` claims the columns that are live slot arrays (by
    identity); :meth:`finalize` frees every unclaimed slot, after replacing
    any array of a pickled fallback batch that still aliases one by a copy
    (a freed block may be reused by another worker while the batch is still
    being pickled)."""

    def __init__(self, arena: SharedArena):
        self._arena = arena
        #: offset -> (nbytes, array); the strong refs keep identities valid
        self._slots: Dict[int, Tuple[int, np.ndarray]] = {}
        self._claimed: set = set()

    def alloc(self, shape: Tuple[int, ...], dtype) -> Optional[np.ndarray]:
        dtype = np.dtype(dtype)
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        if nbytes <= 0 or nbytes > self._arena.size // 2:
            return None
        offset = self._arena.alloc(_align(nbytes))
        if offset is None:
            return None
        arr = np.frombuffer(self._arena.view(offset, nbytes), dtype=dtype,
                            count=nbytes // dtype.itemsize).reshape(shape)
        self._slots[offset] = (nbytes, arr)
        return arr

    def claim(self, col: np.ndarray) -> Optional[Tuple[int, int]]:
        """``(offset, nbytes)`` when ``col`` is a live slot array, marking it
        shipped: the consumer's lease frees its block, not :meth:`finalize`."""
        for offset, (nbytes, arr) in self._slots.items():
            if arr is col and offset not in self._claimed:
                self._claimed.add(offset)
                return offset, nbytes
        return None

    def rollback_claims(self) -> None:
        """Un-claim everything (an encode that fell back to pickling ships
        no block reference)."""
        self._claimed.clear()

    def finalize(self, result: Any) -> Any:
        """Free the unclaimed slots, detaching any column of ``result`` that
        aliases one first; returns the (possibly rewritten) result."""
        unclaimed = [(off, arr) for off, (_, arr) in self._slots.items()
                     if off not in self._claimed]
        if unclaimed and isinstance(result, ColumnBatch):
            hit = {name: col.copy() for name, col in result.columns.items()
                   if isinstance(col, np.ndarray) and col.dtype != object
                   and any(np.shares_memory(col, arr) for _, arr in unclaimed)}
            if hit:
                result = ColumnBatch({**result.columns, **hit}, result.num_rows)
        for offset, _arr in unclaimed:
            try:
                self._arena.free(offset)
            except Exception:  # noqa: BLE001 - teardown best-effort
                logger.debug("slot free failed", exc_info=True)
        self._slots = {}
        return result


class _slot_scope:
    """Context manager installing a :class:`SlotAllocator` on this thread."""

    def __init__(self, allocator: Optional[SlotAllocator]):
        self._allocator = allocator

    def __enter__(self):
        self._prev = getattr(_SLOT_TLS, "allocator", None)
        _SLOT_TLS.allocator = self._allocator
        return self._allocator

    def __exit__(self, *exc):
        _SLOT_TLS.allocator = self._prev


def encode_batch(arena: SharedArena, batch: Any, stop_check=None,
                 max_wait_s: float = 10.0,
                 slots: Optional[SlotAllocator] = None) -> Any:
    """A :class:`ShmBatchRef` for ``batch`` (``petastorm_tpu/native/
    transport.py:201``): slot columns claimed in place, the other raw columns
    packed into one fresh block.  Returns ``batch`` itself when it is not a
    ColumnBatch, has no raw column, is wider than half the arena, or finds
    the arena full for ``max_wait_s`` (``stop_check()`` ends that wait
    early): such a batch travels pickled."""
    if not isinstance(batch, ColumnBatch):
        return batch
    shm_cols = {}
    meta: Dict[str, Tuple] = {}
    total = 0
    n_slots = 0
    for name, col in batch.columns.items():
        if isinstance(col, np.ndarray) and col.dtype != object and col.nbytes > 0:
            claimed = slots.claim(col) if slots is not None else None
            if claimed is not None:
                meta[name] = ("slot", str(col.dtype), col.shape, claimed[0], claimed[1])
                n_slots += 1
                continue
            meta[name] = ("shm", str(col.dtype), col.shape, total)
            shm_cols[name] = col
            total += _align(col.nbytes)
        else:
            meta[name] = ("inline", col)

    def _fallback(value):
        if slots is not None:
            slots.rollback_claims()
        return value

    if not shm_cols and not n_slots:
        return batch
    if total > arena.size // 2:
        logger.warning("batch of %d bytes exceeds half the shm arena (%d);"
                       " falling back to queue pickling", total, arena.size)
        return _fallback(batch)
    offset = None
    if shm_cols:
        offset = arena.alloc(total)
        deadline = time.monotonic() + max_wait_s
        while offset is None:
            if stop_check is not None and stop_check():
                return _fallback(batch)
            if time.monotonic() > deadline:
                logger.warning("shm arena full for %.0fs; shipping batch via"
                               " queue pickling", max_wait_s)
                return _fallback(batch)
            time.sleep(_ALLOC_RETRY_S)
            offset = arena.alloc(total)
        view = arena.view(offset, total)
        for name, col in shm_cols.items():
            dst = np.frombuffer(view, dtype=col.dtype, count=col.size,
                                offset=meta[name][3]).reshape(col.shape)
            np.copyto(dst, col)
        del dst, view  # drop the buffer exports so arena.close() can unmap
    return ShmBatchRef(offset=offset, total_bytes=total, num_rows=batch.num_rows,
                       columns=meta)


def decode_batch(arena: SharedArena, ref: Any) -> Any:
    """The ColumnBatch of a :class:`ShmBatchRef`, its raw columns zero-copy
    views of the arena; any other value passes through."""
    if not isinstance(ref, ShmBatchRef):
        return ref
    lease = (_Lease(arena, ref.offset, ref.total_bytes)
             if ref.offset is not None else None)
    cols: Dict[str, np.ndarray] = {}
    for name, entry in ref.columns.items():
        if entry[0] == "inline":
            cols[name] = entry[1]
            continue
        dtype = np.dtype(entry[1])
        shape = entry[2]
        count = int(np.prod(shape, dtype=np.int64)) if shape else 1
        if entry[0] == "shm":
            cols[name] = np.frombuffer(lease, dtype=dtype, count=count,
                                       offset=entry[3]).reshape(shape)
        else:
            cols[name] = np.frombuffer(_Lease(arena, entry[3], entry[4]), dtype=dtype,
                                       count=count).reshape(shape)
    return ColumnBatch(cols, ref.num_rows)


def slot_column_count(ref: Any) -> int:
    """``("slot", ...)`` columns in an encoded batch (0 for anything else):
    the JAX package's ``decode.batch_slots`` counter."""
    if not isinstance(ref, ShmBatchRef):
        return 0
    return sum(1 for entry in ref.columns.values() if entry[0] == "slot")


def slot_row_count(ref: Any) -> int:
    """Rows decoded into slots: the leading dimension summed over an encoded
    batch's ``("slot", ...)`` columns."""
    if not isinstance(ref, ShmBatchRef):
        return 0
    return sum(int(entry[2][0]) for entry in ref.columns.values()
               if entry[0] == "slot" and entry[2])


def carries_raw_columns(value: Any) -> bool:
    """True for a ColumnBatch with a non-empty raw (non-object) column: what
    the arena would have carried, had it been shipped through it."""
    return isinstance(value, ColumnBatch) and any(
        isinstance(col, np.ndarray) and col.dtype != object and col.nbytes > 0
        for col in value.columns.values())


class _ShmEncodingFn:
    """The worker process's function: ``fn(item)`` with a fresh
    :class:`SlotAllocator` installed, its result encoded into the arena.
    ``stop_event`` (a shutdown aborts a wait on a full arena) and
    ``peak_cell`` (``(shared double array, index)``: the largest arena use
    this worker saw after an encode) are bound by the pool's worker loop."""

    def __init__(self, fn, arena: SharedArena):
        self._fn = fn
        self._arena = arena
        self.stop_event = None
        self.peak_cell = None
        #: the wrapped function takes the pool's ``VentilatedItem`` (chaos)
        self.takes_ventilated_items = getattr(fn, "takes_ventilated_items", False)

    def _stopped(self) -> bool:
        return self.stop_event is not None and self.stop_event.is_set()

    def __call__(self, item):
        allocator = SlotAllocator(self._arena)
        try:
            with _slot_scope(allocator):
                result = self._fn(item)
            out = encode_batch(self._arena, result, stop_check=self._stopped,
                               slots=allocator)
            out = allocator.finalize(out)
        except BaseException:
            allocator.finalize(None)  # a failed item frees its slots
            raise
        if self.peak_cell is not None and isinstance(out, ShmBatchRef):
            cells, index = self.peak_cell
            cells[index] = max(cells[index], float(self._arena.used_bytes()))
        return out


class ShmResultEncoder:
    """Worker factory wrapper whose functions arena-encode their results.
    Picklable for spawn: it holds the arena's name and the inner factory; the
    arena is attached in the worker process."""

    def __init__(self, worker_factory, arena_name: str):
        self._worker_factory = worker_factory
        self._arena_name = arena_name

    def __call__(self):
        return _ShmEncodingFn(self._worker_factory(), SharedArena.attach(self._arena_name))
