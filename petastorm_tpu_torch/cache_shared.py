"""Host-wide shared warm-cache tier: content-addressed decoded rowgroups.

The port's copy of ``petastorm_tpu/cache_shared.py:83-748``
(``make_reader(cache_type='shared')``).  ``cache.py``'s caches are
per-reader and per-process: epoch 2+ of every run, and every concurrent
reader on a host, re-pays full IO + decode (under the process pool each
spawned worker even holds its own empty copy).  This tier is shared across
workers, epochs, readers and jobs on one host:

* **L1** - decoded rowgroup batches packed as columns into blocks of a named
  :class:`~petastorm_tpu_torch.native.SharedArena` (the C allocator the
  process-pool transport uses), with a fixed-slot content-addressed index in
  a second named shared-memory segment.  Every process on the host that
  derives the same namespace (same ``cache_location``) attaches the same
  segments: a rowgroup decoded once by ANY worker of ANY job is a memcpy for
  every other.  Hits copy out of the arena, straight into a transport batch
  slot when the process pool has one armed.
* **L2** - a bounded on-disk tier (:class:`~petastorm_tpu_torch.cache.
  LocalDiskCache`) behind L1, so warm state survives reader restarts and L1
  eviction overflows gracefully.  An L1 miss that hits L2 is promoted back
  into L1.

Two choices differ from the JAX tier on purpose:

* the namespace carries a port tag: the segment names hash
  ``petastorm_tpu_torch:<location>``, the disk tier is
  ``<location>/l2_torch``, and the default location is
  ``<tmp>/petastorm_tpu_torch_warm``, so a JAX reader and a port reader on
  one host never attach each other's segments or read each other's entries
  (whose pickles name the other package's classes);
* without the arena library there is no tier: construction raises, as the
  process pool does, where the JAX tier degrades to its disk level alone.

Concurrency model
-----------------

Index mutations happen under ``fcntl.flock`` on a per-namespace lockfile
(works across unrelated processes - jobs, not just one pool's children) plus
a per-instance thread lock; critical sections only touch the fixed-size
index, never payload bytes.  Readers PIN an entry (refcount in its index
slot) for the duration of the copy-out, so eviction never frees a block
mid-read; a pin held by a crashed process ages out after
:data:`STALE_PIN_S`.  Eviction is LRU by a shared logical clock, bounded by a
soft residency target (``target_bytes`` in the shared header) that the
autotune ``cache_mem`` knob moves.

Lifecycle
---------

The first process to use a namespace creates the segments; others attach
(create/attach races resolve under the lockfile).  ``close()`` detaches
without unlinking - the tier outlives any one reader; the creating process's
resource-tracker registration reclaims the segments at ITS exit, and the L2
disk tier carries warm state beyond that.  ``cleanup()`` force-unlinks the
segments and deletes the L2 directory (the explicit host-wide purge).

Counters (hits/misses/evictions/resident bytes/...) live in the shared index
header so every process's activity lands in one ledger; the owning reader
periodically folds deltas into its telemetry registry
(:meth:`SharedWarmCache.publish_telemetry`) as the ``cache.*`` series.
"""

from __future__ import annotations

import hashlib
import logging
import os
import pickle
import tempfile
import threading
import time
from typing import Any, Callable, Dict, Optional

import numpy as np

from petastorm_tpu_torch.batch import ColumnBatch
from petastorm_tpu_torch.cache import _MISSING, CacheBase, LocalDiskCache
from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.telemetry import resolve as _resolve_telemetry

logger = logging.getLogger(__name__)

#: default L1 arena size (decoded rowgroups resident in shared memory)
DEFAULT_L1_BYTES = 256 * 2 ** 20
#: default L2 disk-tier cap
DEFAULT_L2_BYTES = 10 * 2 ** 30
#: index capacity (entries); 64 bytes/slot
DEFAULT_SLOTS = 4096
#: a pin older than this belongs to a crashed reader: eviction may reclaim
STALE_PIN_S = 30.0
#: default host-wide namespace root (same default location = same tier for
#: every job on the host)
DEFAULT_LOCATION = os.path.join(tempfile.gettempdir(), "petastorm_tpu_torch_warm")
#: hashed into the namespace: the JAX tier under the same location derives
#: other segment names
_NAMESPACE_TAG = "petastorm_tpu_torch:"
#: prefix of the segment and lockfile names (the JAX tier's is ``psw-``)
SEGMENT_PREFIX = "pswt-"

_MAGIC = 0x70737763_61636831  # "pswcach1"
_ALIGN = 64

_HEADER_DTYPE = np.dtype([
    ("magic", "<u8"), ("nslots", "<u8"), ("tick", "<u8"),
    ("hits", "<u8"), ("misses", "<u8"), ("l2_hits", "<u8"),
    ("stores", "<u8"), ("rejected_stores", "<u8"), ("evictions", "<u8"),
    ("bytes", "<u8"), ("target_bytes", "<u8"),
    # post-transform entries: lookups of transform-stage keys, refined out
    # of hits/misses so operators can tell the tiers apart
    ("transform_hits", "<u8"), ("transform_stores", "<u8"), ("pad", "V24")])

_SLOT_DTYPE = np.dtype([
    ("digest0", "<u8"), ("digest1", "<u8"),
    ("state", "<u4"), ("pins", "<u4"),
    ("offset", "<u8"), ("nbytes", "<u8"),
    ("tick", "<u8"), ("pin_wall", "<f8"), ("pad", "V8")])

_EMPTY, _VALID = 0, 1

#: shared-header counters the owning reader folds into telemetry as the
#: ``cache.*`` series (publish_telemetry); one list, three consumers
#: (publish baseline, publish loop, stats)
_PUBLISHED_COUNTERS = ("hits", "misses", "l2_hits", "stores", "evictions",
                       "transform_hits", "transform_stores")

assert _HEADER_DTYPE.itemsize == 128 and _SLOT_DTYPE.itemsize == 64


def _digest_pair(key: str):
    d = hashlib.md5(key.encode()).digest()
    return (int.from_bytes(d[:8], "little"), int.from_bytes(d[8:], "little"))


def _align(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


class _FileLock:
    """Cross-process mutex via ``flock`` on a lockfile (works between
    unrelated processes, unlike multiprocessing locks) combined with a
    thread lock (flock does not exclude threads sharing one fd)."""

    def __init__(self, path: str):
        self._path = path
        self._fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o666)
        self._tlock = threading.Lock()

    def __enter__(self):
        import fcntl

        self._tlock.acquire()
        try:
            fcntl.flock(self._fd, fcntl.LOCK_EX)
        except BaseException:
            self._tlock.release()
            raise
        return self

    def __exit__(self, *exc):
        import fcntl

        try:
            fcntl.flock(self._fd, fcntl.LOCK_UN)
        finally:
            self._tlock.release()

    def close(self) -> None:
        try:
            os.close(self._fd)
        except OSError:
            pass


class SharedWarmCache(CacheBase):
    """Two-tier host-wide read-through cache (module docstring has the full
    design).  ``make_cache('shared')`` / ``make_reader(cache_type='shared')``
    construct it; every reader/job passing the same ``location`` shares one
    tier.

    Picklable across spawn: a process-pool worker's copy re-attaches the
    named segments lazily on first use.  Never retains references to the
    values it serves or stores (everything crosses as copies through the
    arena / pickle), so the zero-copy batch-slot decode stays armed under it
    (``retains_value_references``).
    """

    #: worker.py consults this to keep arena batch-slot decode armed: the
    #: tier stores byte copies, never references to delivered arrays
    retains_value_references = False

    def __init__(self, location: Optional[str] = None,
                 l1_bytes: int = DEFAULT_L1_BYTES,
                 l2_bytes: int = DEFAULT_L2_BYTES,
                 slots: int = DEFAULT_SLOTS,
                 l2_enabled: bool = True,
                 telemetry=None):
        self._location = os.path.abspath(location or DEFAULT_LOCATION)
        self._l1_bytes = int(l1_bytes)
        self._l2_bytes = int(l2_bytes)
        self._nslots = int(slots)
        self._l2_enabled = bool(l2_enabled)
        self._telemetry = _resolve_telemetry(telemetry)
        # namespace: same location string => same segments, host-wide
        ns = hashlib.md5((_NAMESPACE_TAG + self._location).encode()).hexdigest()[:12]
        self._arena_name = f"{SEGMENT_PREFIX}{ns}"
        self._index_name = f"{SEGMENT_PREFIX}{ns}-idx"
        self._lock_path = os.path.join(tempfile.gettempdir(),
                                       f"{SEGMENT_PREFIX}{ns}.lock")
        self._ready = False
        self._l1_failed = False
        self._l1_error = ""
        self._arena = None
        self._index_shm = None
        self._header = None
        self._slots_arr = None
        self._lock = None
        self._l2: Optional[LocalDiskCache] = None
        # per-instance publish baseline: deltas folded into telemetry cover
        # tier activity observed during THIS instance's lifetime
        self._published: Dict[str, int] = {}
        if not self._ensure_ready():
            raise PetastormTpuError(
                f"cache_type='shared' needs its shared-memory level: {self._l1_error}."
                " The tier has no fallback (petastorm_tpu_torch/native/shm_arena.cpp builds"
                " with g++ at first use); use cache_type='local-disk' on this host")

    @property
    def segment_names(self) -> tuple:
        """The names of the arena and index segments (under ``/dev/shm``)."""
        return (self._arena_name, self._index_name)

    # -- attachment -----------------------------------------------------------

    def _ensure_ready(self) -> bool:
        """Attach (or create) the shared segments; returns L1 availability.
        Called lazily so unpickled copies re-attach in their own process.
        The constructing process raises when L1 fails; a process-pool worker
        whose attach fails (the tier purged under it) serves from L2."""
        if self._ready:
            return not self._l1_failed
        if self._l2_enabled and self._l2 is None:
            os.makedirs(self._location, exist_ok=True)
            self._l2 = LocalDiskCache(os.path.join(self._location, "l2_torch"),
                                      self._l2_bytes, telemetry=False)
        if self._l1_failed:
            return False
        try:
            self._attach_l1()
            self._ready = True
            # baseline for publish deltas: tier activity before this
            # instance existed belongs to other readers' ledgers
            self._published = {k: int(self._header[k][0])
                               for k in _PUBLISHED_COUNTERS}
            return True
        except Exception as exc:  # noqa: BLE001 - degrade, never break reads
            self._l1_error = f"{type(exc).__name__}: {exc}"
            logger.warning(
                "shared warm cache L1 unavailable (%s); running %s", exc,
                "disk-tier only" if self._l2 is not None else "uncached")
            self._l1_failed = True
            self._ready = True
            return False

    def _attach_l1(self) -> None:
        from multiprocessing import shared_memory

        from petastorm_tpu_torch.native import SharedArena, attach_shared_memory, load_arena

        load_arena()  # raises when the library cannot be built
        self._lock = _FileLock(self._lock_path)
        index_size = _HEADER_DTYPE.itemsize + self._nslots * _SLOT_DTYPE.itemsize
        with self._lock:
            created = False
            try:
                self._index_shm = shared_memory.SharedMemory(
                    name=self._index_name, create=True, size=index_size)
                created = True
            except FileExistsError:
                self._index_shm = attach_shared_memory(self._index_name)
            buf = self._index_shm.buf
            self._header = np.frombuffer(buf, dtype=_HEADER_DTYPE, count=1)
            nslots = (self._nslots if created
                      else int(self._header["nslots"][0]) or self._nslots)
            self._slots_arr = np.frombuffer(
                buf, dtype=_SLOT_DTYPE, count=nslots,
                offset=_HEADER_DTYPE.itemsize)
            self._nslots = nslots
            if not created and int(self._header["magic"][0]) != _MAGIC:
                # the index exists but was never initialized: its creator
                # died between create and magic-set.  Init happens under
                # THIS lock, so holding it with no magic means the creator
                # is gone - adopt the orphan and initialize it ourselves
                created = True
            if created:
                try:
                    self._arena = SharedArena.create(self._l1_bytes,
                                                     name=self._arena_name)
                except FileExistsError:
                    # a previous creator died without its tracker firing (or
                    # raced us past the index create): reuse the live arena
                    self._arena = SharedArena.attach(self._arena_name)
                self._arena.disown()
                self._header["nslots"] = self._nslots
                self._header["target_bytes"] = int(0.8 * self._arena.size)
                self._header["magic"] = _MAGIC  # magic LAST: init is visible
            else:
                self._arena = SharedArena.attach(self._arena_name)
                self._arena.disown()

    # -- pickling (spawned process-pool workers) ------------------------------

    def __getstate__(self):
        state = dict(self.__dict__)
        for name in ("_telemetry", "_arena", "_index_shm", "_header",
                     "_slots_arr", "_lock"):
            state[name] = None
        state["_ready"] = False
        # a parent-side L1 failure is environmental (lib/shm missing) and
        # would recur in the child; a child retries only the attach itself
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._telemetry = _resolve_telemetry(None)

    # -- CacheBase ------------------------------------------------------------

    def get(self, key: str, fill_cache_func: Callable[[], Any]) -> Any:
        l1 = self._ensure_ready()
        if l1:
            value = self._l1_lookup(key)
            if value is not _MISSING:
                self._bump("hits", tick=True)
                return value
        if self._l2 is not None:
            value = self._l2.lookup(key)
            if value is not _MISSING:
                self._bump("l2_hits", tick=True)
                if l1:
                    self._l1_store(key, value)  # promote for the next reader
                return value
        self._bump("misses", tick=True)
        value = fill_cache_func()
        if l1:
            self._l1_store(key, value)
        if self._l2 is not None:
            try:
                self._l2.store(key, value)
            except Exception:  # noqa: BLE001 - the tier is an optimization
                logger.warning("L2 store failed for %s", key, exc_info=True)
        return value

    def cleanup(self) -> None:
        """Host-wide purge: unlink the shared segments and delete the disk
        tier.  Affects every job sharing this namespace - this is the
        explicit operator action, not a per-reader close."""
        # unlink the NAMES first (idempotent - already-purged is success),
        # THEN detach this process's mappings: a close deferred by live
        # views must not skip the unlink
        for handle, name in (
                (self._index_shm, self._index_name),
                (getattr(self._arena, "_shm", None), self._arena_name)):
            try:
                if handle is None:
                    from petastorm_tpu_torch.native import attach_shared_memory

                    handle = attach_shared_memory(name)
                handle.unlink()
            except Exception:  # noqa: BLE001 - already gone is success
                pass
        self._detach()
        if self._l2 is not None:
            self._l2.cleanup()
            self._l2 = None
        try:
            os.remove(self._lock_path)
        except OSError:
            pass

    def close(self) -> None:
        """Detach this process's mapping; the tier stays alive for other
        readers/jobs (see module docstring, Lifecycle)."""
        self._detach()

    def _detach(self) -> None:
        self._ready = False
        self._header = None
        self._slots_arr = None
        if self._index_shm is not None:
            import gc

            gc.collect()  # release numpy views over the buffer first
            try:
                self._index_shm.close()
            except BufferError:
                logger.debug("index segment still has live views; leaving"
                             " mapped until process exit")
            self._index_shm = None
        if self._arena is not None:
            self._arena.close()
            self._arena = None
        if self._lock is not None:
            self._lock.close()
            self._lock = None

    def __del__(self):  # best-effort; explicit close() is the supported path
        try:
            self._detach()
        except Exception:  # noqa: BLE001 - never raise from gc
            pass

    # -- L1: index + arena ----------------------------------------------------

    def _find(self, d0: int, d1: int) -> Optional[int]:
        """Slot index of a VALID entry with this digest (no lock here: the
        caller holds it).  Vectorized scan - 4096 slots is microseconds."""
        s = self._slots_arr
        match = np.nonzero((s["digest0"] == d0) & (s["digest1"] == d1)
                           & (s["state"] == _VALID))[0]
        return int(match[0]) if len(match) else None

    def _l1_lookup(self, key: str) -> Any:
        d0, d1 = _digest_pair(key)
        s = self._slots_arr
        with self._lock:
            i = self._find(d0, d1)
            if i is None:
                return _MISSING
            # pin: eviction skips pinned entries, so the block cannot be
            # freed or reused while we copy out of it
            s["pins"][i] += 1
            s["pin_wall"][i] = time.time()
            self._header["tick"] += 1
            s["tick"][i] = self._header["tick"][0]
            offset, nbytes = int(s["offset"][i]), int(s["nbytes"][i])
        try:
            return self._materialize(offset, nbytes)
        except Exception:  # noqa: BLE001 - a torn entry must read as a miss
            logger.warning("dropping unreadable warm-cache entry",
                           exc_info=True)
            with self._lock:
                j = self._find(d0, d1)
                if j is not None and int(s["offset"][j]) == offset:
                    self._evict_slot(j)
            return _MISSING
        finally:
            with self._lock:
                j = self._find(d0, d1)
                if j is not None and s["pins"][j] > 0:
                    s["pins"][j] -= 1

    def _materialize(self, offset: int, nbytes: int) -> Any:
        """Rebuild a ColumnBatch from an arena block (copying out - the
        returned arrays are private).  When the process-pool transport has a
        batch slot allocator armed for the current item, fixed-shape columns
        are copied STRAIGHT into arena batch slots (one shm->shm memcpy,
        then shipped zero-copy)."""
        from petastorm_tpu_torch.native.transport import current_slot_allocator

        view = self._arena.view(offset, nbytes)
        try:
            (meta_len,) = np.frombuffer(view, dtype="<u8", count=1)
            meta = pickle.loads(bytes(view[8:8 + int(meta_len)]))
            if "pickled" in meta:
                off, length = meta["pickled"]
                return pickle.loads(bytes(view[off:off + length]))
            allocator = current_slot_allocator()
            columns: Dict[str, Any] = {}
            for entry in meta["cols"]:
                name, kind = entry[0], entry[1]
                if kind == "nd":
                    _, _, dtype_str, shape, rel, length = entry
                    dtype = np.dtype(dtype_str)
                    count = int(np.prod(shape, dtype=np.int64)) if shape else 1
                    src = np.frombuffer(view, dtype=dtype, count=count,
                                        offset=rel).reshape(shape)
                    out = allocator.alloc(shape, dtype) \
                        if allocator is not None else None
                    if out is None:
                        out = np.empty(shape, dtype=dtype)
                    np.copyto(out, src)
                    columns[name] = out
                else:
                    _, _, rel, length = entry
                    columns[name] = pickle.loads(bytes(view[rel:rel + length]))
            return ColumnBatch(columns, meta["num_rows"])
        finally:
            view.release()

    def _l1_store(self, key: str, value: Any) -> bool:
        try:
            payload = self._pack_plan(value)
        except Exception:  # noqa: BLE001 - unpicklable values just skip L1
            logger.debug("warm-cache store skipped (unpackable value)",
                         exc_info=True)
            return False
        meta_blob, parts, total = payload
        target = int(self._header["target_bytes"][0])
        if total > min(target, self._arena.size // 2):
            self._bump("rejected_stores")
            return False
        offset = self._alloc_with_eviction(total, target)
        if offset is None:
            self._bump("rejected_stores")
            return False
        try:
            view = self._arena.view(offset, total)
            np.frombuffer(view, dtype="<u8", count=1)[0] = len(meta_blob)
            view[8:8 + len(meta_blob)] = meta_blob
            for rel, data in parts:
                if isinstance(data, np.ndarray):
                    count = data.size if data.size else 1
                    dst = np.frombuffer(view, dtype=data.dtype,
                                        count=data.size, offset=rel)
                    np.copyto(dst.reshape(data.shape), data)
                else:
                    view[rel:rel + len(data)] = data
            del view
        except Exception:  # noqa: BLE001 - never lose the read to the store
            self._arena.free(offset)
            raise
        d0, d1 = _digest_pair(key)
        s = self._slots_arr
        with self._lock:
            if self._find(d0, d1) is not None:
                # another writer raced us to the same rowgroup: keep theirs
                self._arena.free(offset)
                return True
            empty = np.nonzero(s["state"] == _EMPTY)[0]
            if not len(empty):
                i = self._pick_victim()
                if i is None:  # everything pinned: give up on this store
                    self._arena.free(offset)
                    return False
                self._evict_slot(i)
            else:
                i = int(empty[0])
            self._header["tick"] += 1
            s[i] = (d0, d1, _VALID, 0, offset, total,
                    self._header["tick"][0], 0.0, b"")
            self._header["stores"] += 1
            self._header["bytes"] += total
        return True

    @staticmethod
    def _pack_plan(value: Any):
        """(meta_blob, [(rel_offset, ndarray | bytes)...], total_bytes) for
        one arena block: ``[u64 meta_len][meta pickle][aligned payloads]``."""
        if isinstance(value, ColumnBatch):
            cols, parts = [], []
            cursor = None  # assigned after meta length is known

            entries = []
            for name, col in value.columns.items():
                if (isinstance(col, np.ndarray) and col.dtype != object
                        and col.nbytes > 0):
                    entries.append((name, "nd", col))
                else:
                    entries.append((name, "obj", pickle.dumps(
                        col, protocol=pickle.HIGHEST_PROTOCOL)))
            # two-pass: sizes first (meta pickles rel offsets), then offsets
            sizes = [(e[2].nbytes if e[1] == "nd" else len(e[2]))
                     for e in entries]
            # meta size depends on offsets which depend on meta size; pin
            # the payload start by padding the meta to an aligned bound
            probe = pickle.dumps(
                {"num_rows": value.num_rows,
                 "cols": [(e[0], e[1], str(getattr(e[2], "dtype", "")),
                           tuple(getattr(e[2], "shape", ())),
                           2 ** 62, 2 ** 62) for e in entries]},
                protocol=pickle.HIGHEST_PROTOCOL)
            payload_start = _align(8 + len(probe) + 64)
            cursor = payload_start
            for entry, size in zip(entries, sizes):
                name, kind, data = entry
                if kind == "nd":
                    cols.append((name, "nd", str(data.dtype),
                                 tuple(data.shape), cursor, size))
                else:
                    cols.append((name, "obj", cursor, size))
                parts.append((cursor, data))
                cursor = _align(cursor + size)
            meta_blob = pickle.dumps({"num_rows": value.num_rows,
                                      "cols": cols},
                                     protocol=pickle.HIGHEST_PROTOCOL)
            if 8 + len(meta_blob) > payload_start:
                raise RuntimeError("meta overflow")  # 64B headroom: cannot
            return meta_blob, parts, cursor
        blob = pickle.dumps(value, protocol=pickle.HIGHEST_PROTOCOL)
        meta_probe = pickle.dumps({"pickled": (2 ** 62, 2 ** 62)},
                                  protocol=pickle.HIGHEST_PROTOCOL)
        start = _align(8 + len(meta_probe) + 64)
        meta_blob = pickle.dumps({"pickled": (start, len(blob))},
                                 protocol=pickle.HIGHEST_PROTOCOL)
        return meta_blob, [(start, blob)], start + len(blob)

    def _alloc_with_eviction(self, total: int, target: int) -> Optional[int]:
        """Arena block for ``total`` bytes, evicting LRU entries as needed to
        respect ``target`` resident bytes and to free arena space."""
        for _ in range(3):
            with self._lock:
                # soft target first (the autotune knob): shrink residency
                while (int(self._header["bytes"][0]) + total > target):
                    i = self._pick_victim()
                    if i is None:
                        break
                    self._evict_slot(i)
            offset = self._arena.alloc(total)
            if offset is not None:
                return offset
            # arena itself is full (fragmentation / leaked blocks): evict
            # more entries and retry
            with self._lock:
                freed = 0
                while freed < total:
                    i = self._pick_victim()
                    if i is None:
                        return None
                    freed += int(self._slots_arr["nbytes"][i])
                    self._evict_slot(i)
        return self._arena.alloc(total)

    def _pick_victim(self) -> Optional[int]:
        """LRU unpinned valid slot (stale pins - crashed readers - count as
        unpinned); None when nothing is evictable.  Caller holds the lock."""
        s = self._slots_arr
        now = time.time()
        evictable = ((s["state"] == _VALID)
                     & ((s["pins"] == 0)
                        | (now - s["pin_wall"] > STALE_PIN_S)))
        idx = np.nonzero(evictable)[0]
        if not len(idx):
            return None
        return int(idx[np.argmin(s["tick"][idx])])

    def _evict_slot(self, i: int) -> None:
        """Free slot ``i``'s block and mark it empty (caller holds lock)."""
        s = self._slots_arr
        nbytes = int(s["nbytes"][i])
        offset = int(s["offset"][i])
        s["state"][i] = _EMPTY
        s["pins"][i] = 0
        self._header["evictions"] += 1
        self._header["bytes"] -= min(nbytes,
                                     int(self._header["bytes"][0]))
        try:
            self._arena.free(offset)
        except Exception:  # noqa: BLE001 - leaked block beats a dead reader
            logger.debug("arena free failed for evicted entry", exc_info=True)

    # -- shared counters / autotune knob --------------------------------------

    def _bump(self, name: str, tick: bool = False) -> None:
        if self._header is None:
            return
        with self._lock:
            self._header[name] += 1
            if tick:
                self._header["tick"] += 1

    def note_transform_event(self, hit: bool) -> None:
        """Count one POST-TRANSFORM cache lookup (worker.py calls this right
        after a transform-stage ``get``).  These refine hits/misses: a warm
        transform hit skipped decode AND transform, a transform store just
        paid both once for every later reader on the tier.  Lands in the
        shared header, so process-pool workers' events survive the process
        boundary and publish through the owning reader like every cache.*
        counter."""
        if not self._ensure_ready():
            # L1 down (disk-only tier): keep counting - the header is gone,
            # so fall back to this instance's telemetry directly
            tele = self._telemetry
            if tele is not None and tele.enabled:
                tele.counter("cache.transform_hits" if hit
                             else "cache.transform_stores").add(1)
            return
        self._bump("transform_hits" if hit else "transform_stores")

    @property
    def l1_enabled(self) -> bool:
        """True when the shared-memory level is live (attached or
        attachable); False = degraded to the disk tier (or passthrough)."""
        return self._ensure_ready()

    @property
    def l1_size_bytes(self) -> int:
        """Arena capacity (the hard ceiling for ``target_bytes``)."""
        return self._arena.size if self._arena is not None else 0

    def get_target_bytes(self) -> int:
        """The L1 soft residency cap (shared across every job on the tier;
        the autotune ``cache_mem`` knob reads this).  0 when L1 is down."""
        if not self._ensure_ready():
            return 0
        return int(self._header["target_bytes"][0])

    def set_target_bytes(self, n: int) -> int:
        """Move the L1 residency cap (the autotune ``cache_mem`` knob; shared
        across every job on the tier).  Shrinking evicts down immediately.
        Returns the clamped value."""
        if not self._ensure_ready():
            return 0
        n = max(2 ** 20, min(int(n), int(0.8 * self._arena.size)))
        with self._lock:
            self._header["target_bytes"] = n
            while int(self._header["bytes"][0]) > n:
                i = self._pick_victim()
                if i is None:
                    break
                self._evict_slot(i)
        return n

    def stats(self) -> dict:
        """Point-in-time tier statistics (shared across every process using
        the namespace) - surfaced in ``Reader.diagnostics['cache']``."""
        if not self._ensure_ready():
            return {"l1_enabled": False,
                    "l2_enabled": self._l2 is not None,
                    "location": self._location}
        with self._lock:
            h = self._header
            s = self._slots_arr
            hits, misses = int(h["hits"][0]), int(h["misses"][0])
            lookups = hits + misses + int(h["l2_hits"][0])
            return {
                "l1_enabled": True,
                "l2_enabled": self._l2 is not None,
                "location": self._location,
                "hits": hits, "misses": misses,
                "l2_hits": int(h["l2_hits"][0]),
                "stores": int(h["stores"][0]),
                "rejected_stores": int(h["rejected_stores"][0]),
                "evictions": int(h["evictions"][0]),
                "transform_hits": int(h["transform_hits"][0]),
                "transform_stores": int(h["transform_stores"][0]),
                "bytes": int(h["bytes"][0]),
                "target_bytes": int(h["target_bytes"][0]),
                "arena_bytes": self._arena.size,
                "entries": int(np.count_nonzero(s["state"] == _VALID)),
                "hit_rate": ((hits + int(h["l2_hits"][0])) / lookups
                             if lookups else 0.0),
            }

    def publish_telemetry(self) -> None:
        """Fold shared-header counter deltas (since the last publish, starting
        at this instance's attach) into the owning telemetry registry as the
        ``cache.*`` series, plus the resident-bytes / hit-rate gauges.  Called
        periodically by the Reader's consume loop (one publisher per reader -
        workers only bump the shared header, so nothing double-counts)."""
        tele = self._telemetry
        if tele is None or not tele.enabled or not self._ensure_ready():
            return
        with self._lock:
            current = {k: int(self._header[k][0])
                       for k in _PUBLISHED_COUNTERS}
            resident = int(self._header["bytes"][0])
            target = int(self._header["target_bytes"][0])
        for name, value in current.items():
            delta = value - self._published.get(name, 0)
            if delta > 0:
                tele.counter(f"cache.{name}").add(delta)
        self._published = current
        lookups = current["hits"] + current["misses"] + current["l2_hits"]
        tele.gauge("cache.bytes").set(resident)
        tele.gauge("cache.target_bytes").set(target)
        if lookups:
            tele.gauge("cache.hit_rate").set(
                (current["hits"] + current["l2_hits"]) / lookups)
