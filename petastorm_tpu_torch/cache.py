"""Read-through caches of decoded rowgroup batches.

Counterpart of ``petastorm_tpu/cache.py``: ``CacheBase``, ``NullCache``,
``InMemoryCache`` (an LRU bounded by estimated bytes) and ``LocalDiskCache``
(sha1-named pickle files, evicted by mtime against a size cap), with the
same contracts.  An entry is a whole decoded ``ColumnBatch``, so a hit skips
the Parquet read and the decode of a rowgroup (on the hybrid route, the
entropy decode: the entry holds the coefficient planes).  Each cache counts
its lookups in ``hits`` and ``misses`` (the JAX package's ``cache.hits`` and
``cache.misses`` telemetry counters; telemetry itself is not part of this
package yet, nor is the host-wide ``'shared'`` tier).

The default local-disk directory is the port's own, and the worker's keys
carry a port tag, so a directory shared with the JAX package never serves
one package the other's pickles (which name the other package's classes).
"""

from __future__ import annotations

import copy
import hashlib
import logging
import os
import pickle
import shutil
import sys
import tempfile
import threading
import time
from abc import ABC, abstractmethod
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional

import numpy as np

from petastorm_tpu_torch.errors import PetastormTpuError

logger = logging.getLogger(__name__)

_MISSING = object()  # sentinel: a miss, as opposed to an entry that is None

#: ``make_cache``'s defaults (``petastorm_tpu/cache.py:337``, ``:340``)
DISK_SIZE_LIMIT = 10 * 2 ** 30
MEMORY_SIZE_LIMIT = 4 * 2 ** 30


class CacheBase(ABC):
    """``get(key, fill)`` returns the cached value or computes and stores
    ``fill()``; ``hits`` and ``misses`` count the lookups."""

    def __init__(self):
        self.hits = 0
        self.misses = 0
        self._count_lock = threading.Lock()

    @abstractmethod
    def get(self, key: str, fill_cache_func: Callable[[], Any]) -> Any:
        """Return the cached value or compute and store ``fill_cache_func()``."""

    def cleanup(self) -> None:
        """Release the cache's resources (files, memory); the cache is
        unusable afterwards.  No-op by default."""

    def _record_lookup(self, hit: bool) -> None:
        with self._count_lock:
            if hit:
                self.hits += 1
            else:
                self.misses += 1

    def stats(self) -> Dict[str, int]:
        """``hits`` and ``misses`` so far."""
        with self._count_lock:
            return {"hits": self.hits, "misses": self.misses}


class NullCache(CacheBase):
    """No cache: every ``get`` fills.  It counts nothing."""

    def get(self, key: str, fill_cache_func: Callable[[], Any]) -> Any:
        return fill_cache_func()


class InMemoryCache(CacheBase):
    """Process-local LRU cache of decoded batches, capped by estimated bytes.

    An entry larger than the cap is served uncached.  Stored entries and
    served hits are private copies, so a consumer that mutates a batch in
    place cannot corrupt the cache; the copies are made outside the lock,
    so the pool's threads do not serialize on them.
    """

    def __init__(self, size_limit_bytes: int = MEMORY_SIZE_LIMIT):
        super().__init__()
        self._entries: "OrderedDict[str, Any]" = OrderedDict()
        self._sizes: Dict[str, int] = {}
        self._size_limit = size_limit_bytes
        self._total = 0
        self._lock = threading.Lock()

    @classmethod
    def _array_size(cls, col: Any) -> int:
        if isinstance(col, np.ndarray):
            if col.dtype == object:
                # nbytes counts 8 bytes a pointer for object arrays; sum the
                # payloads (ragged cells, a mixed-geometry field's tuples of
                # planes) or the cap is a no-op
                return int(col.nbytes) + sum(cls._array_size(c) for c in col.ravel())
            return int(col.nbytes)
        if isinstance(col, tuple):
            return sys.getsizeof(col) + sum(cls._array_size(c) for c in col)
        return sys.getsizeof(col)

    @classmethod
    def _estimate_size(cls, value: Any) -> int:
        columns = getattr(value, "columns", None)
        if isinstance(columns, dict):
            return sum(cls._array_size(col) for col in columns.values())
        return sys.getsizeof(value)

    @staticmethod
    def _copy_value(value: Any) -> Any:
        """A private copy; an object column's cells are copied too."""
        def copy_cell(cell):
            if isinstance(cell, np.ndarray):
                return cell.copy()
            if isinstance(cell, tuple):  # a mixed-geometry cell: (planes, qtab, meta)
                return tuple(copy_cell(c) for c in cell)
            return cell

        def copy_col(c):
            if isinstance(c, np.ndarray):
                if c.dtype == object:
                    out = np.empty(len(c), dtype=object)
                    for i, cell in enumerate(c):
                        out[i] = copy_cell(cell)
                    return out
                return c.copy()
            return copy.deepcopy(c)

        columns = getattr(value, "columns", None)
        if isinstance(columns, dict):
            copied = {n: copy_col(c) for n, c in columns.items()}
            return type(value)(copied, value.num_rows)
        return copy.deepcopy(value)

    def get(self, key: str, fill_cache_func: Callable[[], Any]) -> Any:
        with self._lock:
            entry = self._entries.get(key, _MISSING)
            if entry is not _MISSING:
                self._entries.move_to_end(key)
        self._record_lookup(entry is not _MISSING)
        if entry is not _MISSING:
            return self._copy_value(entry)
        value = fill_cache_func()
        size = self._estimate_size(value)
        if size > self._size_limit:
            return value
        stored = self._copy_value(value)
        with self._lock:
            if key not in self._entries:
                self._entries[key] = stored
                self._sizes[key] = size
                self._total += size
                while self._total > self._size_limit and len(self._entries) > 1:
                    old_key, _ = self._entries.popitem(last=False)
                    self._total -= self._sizes.pop(old_key)
        return value

    def stats(self) -> Dict[str, int]:
        """``hits``, ``misses``, and the ``entries`` and estimated ``bytes``
        resident."""
        with self._lock:
            resident = {"entries": len(self._entries), "bytes": self._total}
        return {**super().stats(), **resident}

    def cleanup(self) -> None:
        with self._lock:
            self._entries.clear()
            self._sizes.clear()
            self._total = 0


class LocalDiskCache(CacheBase):
    """File-per-key pickle cache with a byte-size cap.

    Persistent across runs unless ``cleanup()`` is called.  Keys are hashed,
    so any string key works.  Safe under concurrent readers and writers of
    one directory: entries appear atomically (temp file, then rename), a
    young ``.tmp`` is never evicted (a partner deleting a writer's temp file
    would fail its rename) but one older than ``ORPHAN_TMP_S`` is (a crashed
    writer's), and every path tolerates a partner having deleted the entry
    first.  Eviction is best effort: a sweep runs every ``SWEEP_EVERY``
    stores, so the cap may be overshot by that many entries between sweeps.
    """

    #: a ``.tmp`` older than this is a crashed writer's orphan: evictable
    ORPHAN_TMP_S = 300.0
    #: stores between full eviction sweeps (a sweep lists and stats the whole
    #: directory; on every store a cold epoch would go quadratic)
    SWEEP_EVERY = 16

    def __init__(self, path: str, size_limit_bytes: int = DISK_SIZE_LIMIT):
        super().__init__()
        self._dir = path
        self._size_limit = size_limit_bytes
        # a race between two threads only shifts the sweep cadence by one
        self._stores_since_sweep = 0
        os.makedirs(path, exist_ok=True)

    def _entry_path(self, key: str) -> str:
        return os.path.join(self._dir, hashlib.sha1(key.encode()).hexdigest() + ".bin")

    def lookup(self, key: str) -> Any:
        """The stored value, or ``_MISSING`` (never fills)."""
        path = self._entry_path(key)
        try:
            with open(path, "rb") as f:
                value = pickle.load(f)
        except FileNotFoundError:
            return _MISSING
        except Exception as exc:  # noqa: BLE001 - a corrupt entry is recomputed
            logger.warning("Dropping corrupt cache entry %s: %s", path, exc)
            try:
                os.remove(path)
            except OSError:
                pass
            return _MISSING
        try:
            os.utime(path)  # the LRU touch
        except OSError:
            pass  # a partner evicted it after the read: the value is still good
        return value

    def store(self, key: str, value: Any) -> None:
        """Publish ``value`` under ``key`` atomically (the last rename of
        concurrent writers wins) and run the amortized eviction sweep."""
        tmp_fd, tmp_path = tempfile.mkstemp(dir=self._dir, suffix=".tmp")
        try:
            with os.fdopen(tmp_fd, "wb") as f:
                pickle.dump(value, f, protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(tmp_path, self._entry_path(key))
        except BaseException:
            try:
                os.remove(tmp_path)
            except OSError:
                pass
            raise
        self._stores_since_sweep += 1
        if self._stores_since_sweep >= self.SWEEP_EVERY:
            self._stores_since_sweep = 0
            self._maybe_evict()

    def get(self, key: str, fill_cache_func: Callable[[], Any]) -> Any:
        value = self.lookup(key)
        self._record_lookup(value is not _MISSING)
        if value is not _MISSING:
            return value
        value = fill_cache_func()
        self.store(key, value)
        return value

    def _maybe_evict(self) -> None:
        entries, total, now = [], 0, time.time()
        for name in os.listdir(self._dir):
            p = os.path.join(self._dir, name)
            try:
                st = os.stat(p)
            except OSError:
                continue  # a partner evicted it between listdir and stat
            if name.endswith(".tmp") and now - st.st_mtime < self.ORPHAN_TMP_S:
                continue  # a live writer's temp file
            total += st.st_size
            entries.append((st.st_mtime, st.st_size, p))
        if total <= self._size_limit:
            return
        entries.sort()  # oldest first
        for _mtime, size, p in entries:
            try:
                os.remove(p)
                total -= size
            except OSError:
                continue  # a partner's sweep got there first
            if total <= self._size_limit:
                return

    def cleanup(self) -> None:
        shutil.rmtree(self._dir, ignore_errors=True)


def make_cache(cache_type: Optional[str] = "null", cache_location: Optional[str] = None,
               cache_size_limit: Optional[int] = None) -> CacheBase:
    """``'null'`` | ``'memory'`` | ``'local-disk'``
    (``petastorm_tpu/cache.py:320``).  ``cache_location`` is the local-disk
    directory (default ``<tmp>/petastorm_tpu_torch_cache``);
    ``cache_size_limit`` caps the bytes (defaults 4 GiB in memory, 10 GiB on
    disk)."""
    if cache_type in (None, "null", "none"):
        return NullCache()
    if cache_type == "local-disk":
        if not cache_location:
            cache_location = os.path.join(tempfile.gettempdir(), "petastorm_tpu_torch_cache")
        return LocalDiskCache(cache_location, cache_size_limit or DISK_SIZE_LIMIT)
    if cache_type == "memory":
        return InMemoryCache(cache_size_limit or MEMORY_SIZE_LIMIT)
    if cache_type == "shared":
        raise PetastormTpuError(
            "cache_type='shared' (the host-wide warm tier of petastorm_tpu/cache_shared.py,"
            " beside the process pool) is not part of this package yet: ROADMAP queue A"
            " item 11. Use cache_type='memory' or 'local-disk'.")
    raise ValueError(f"Unknown cache_type {cache_type!r}")
