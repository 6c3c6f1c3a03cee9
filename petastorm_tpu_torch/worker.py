"""Rowgroup decode worker: a parquet rowgroup -> a decoded ColumnBatch.

Counterpart of ``petastorm_tpu/worker.py:47 RowGroupDecoderWorker``.  A work item reads
only its row slice (``row_slice()``: the whole rowgroup, or one row-drop
partition, ``:512-515``).  Image columns decode in one native call each
(``codecs.CompressedImageCodec.decode_column``), fanned out over
``decode_threads`` and cropped to the field's ``decode_roi``
(``:447-479``, ``:545-551``).  A field read with ``decode_placement='device'``
leaves the worker in the coefficient wire form (``:527-541``): the entropy
half of the JPEG decode runs here, over ``decode_threads`` too, and the field
travels as its derived plane columns (``native.image.pack_coef_columns``);
the loader finishes the decode on the device.  A field under the live split
(``decode_placement='auto'``) reads the reader's shared split cell once a
rowgroup (``:438-444``): 1 ships the coefficient form, 0 the decoded pixels,
and the value is part of the rowgroup's cache key (``:393-396``).

A predicate splits the read (``:581-680``): its columns are read and decoded
first, the mask filters the other columns' arrow table before their decode
(so on the hybrid route the entropy decode runs only on the rows that
survive), and an item whose rows are all masked gives a 0-row batch, which
the reader folds into its cursor and never delivers.  A ``TransformSpec``
runs after the decode, never on a 0-row batch (``:353-364``).

An ``NGram`` reader forms its windows after the transform, over the
post-transform schema, never on a 0-row batch (``:283-301``, ``:357-364``).
With ``timestamp_overlap=True`` a row-drop slice reads ``length - 1``
lookahead rows past its end (clipped to the rowgroup) and anchors the window
starts inside the slice, so every window is formed by exactly one slice; with
``timestamp_overlap=False`` every slice reads the whole rowgroup (the greedy
non-overlapping pick is a property of the whole rowgroup) and keeps the
starts inside its own rows.

A field the file does not store is a hive partition key: its column is
the rowgroup's path value in the field's dtype (``:552-560``); any other
missing field is refused.  ``verify_checksums`` verifies the Parquet page
checksums on read (``:218``), so a corrupt page fails as a data error.

Every rowgroup is looked up in the reader's cache first (``:342-346``),
under a key built as ``:384-412`` builds it: the dataset URL's md5, the
file, the rowgroup, the row span it loads (an ngram's lookahead included,
so readers of two ngram lengths never serve each other's entries), a tag
over the read fields, the device-decode fields, ``decode_roi`` and the
transform's signature, and the file's size and mtime.  A hit skips the
Parquet read and the decode: on the hybrid route the entry holds the
coefficient planes, so only the entropy decode is skipped.  When
``transform.transform_cache_info`` finds the transform's output cacheable
(and the reader has no ngram, ``:153-155``), the entry is the transform's
output, under the key with a stage tag (``:313-341``): a warm epoch then
decodes and transforms nothing, and the worker counts those hits and
misses.  The pool's threads fill a key once: a rowgroup read again while
its first read still decodes (the next epoch's items are issued before
this one's are done) waits for that read and hits, so a warm epoch
decodes nothing.

Files are opened through the reader's ``fs.FilesystemFactory``
(``:56-94``): a local file is memory-mapped; a file on any other filesystem
is opened through an ``io_window.WindowedFile`` (``:185-221``), which
fetches the byte span of a rowgroup's needed column chunks in one ranged
read before ``read_row_group`` (``:494-497``; ``pre_buffer`` stays on for
spans the window refuses).  The rowgroup read runs under
``retry.retry_call`` (``:225-253``) with the reader's retry policy and
shared circuit breaker; a retry drops the cached file handle.  The worker
counts the retries, the raw reads and the rowgroups read
(``io_stats()``), and with telemetry records them as the JAX worker's
``io.*`` series.

Telemetry (``petastorm_tpu/worker.py:179-271``, ``:304-364``): the worker
records the ``decode`` and ``transform`` stage spans of every item,
``worker.rowgroups_decoded`` and ``worker.rows_decoded``, the native
decoder's counters as ``decode.*``, the retries, and the rows a predicate
dropped before the payload decode (``sequence.rows_filtered``).  The
recorder is resolved where the worker runs: a process-pool worker's is its
own (``PETASTORM_TPU_TELEMETRY``), so its stages stay in its process.

Under the process pool the factory is pickled into every worker process
(its locks recreated there, its counters then per process), and a host
decode writes its image column straight into an arena slot of the
shared-memory transport (``batch_slots``, ``:125-131``, ``:545-551``), so
the column ships with no copy.  Slots are armed only where the cache keeps
no reference to the batches it is given (``cache.CacheBase.
retains_value_references``).
"""

from __future__ import annotations

import hashlib
import logging
import os
import threading
from typing import Callable, Dict, Mapping, Optional, Sequence

import numpy as np
import pyarrow as pa
import pyarrow.fs as pafs
import pyarrow.parquet as pq

from petastorm_tpu_torch import transform as transform_mod
from petastorm_tpu_torch.batch import ColumnBatch
from petastorm_tpu_torch.cache import CacheBase, NullCache
from petastorm_tpu_torch.codecs import decode_options
from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.io_window import WindowedFile, rowgroup_span
from petastorm_tpu_torch.native import image as native_image
from petastorm_tpu_torch.plan import WorkItem
from petastorm_tpu_torch.retry import retry_call
from petastorm_tpu_torch.schema import Schema
from petastorm_tpu_torch.seeding import seed_stream
from petastorm_tpu_torch.telemetry import NULL_CONTEXT
from petastorm_tpu_torch.telemetry import resolve as _resolve_telemetry

logger = logging.getLogger(__name__)

_MAX_OPEN_FILES = 8
#: part of every cache key: a directory the JAX package's cache also uses
#: never serves one package the other's entries
_CACHE_KEY_TAG = "petastorm_tpu_torch:1"
#: cache-key stage tag of post-transform entries (``petastorm_tpu/worker.py:44``)
_TRANSFORM_STAGE = "xform1"


def _partition_column(field, value: str, n: int) -> np.ndarray:
    """``n`` copies of a partition value, in the field's dtype (a string
    field keeps the path's string, as an object column)."""
    if field.dtype.kind not in ("U", "S", "O"):
        return np.full(n, field.dtype.type(value), dtype=field.dtype)
    col = np.empty(n, dtype=object)
    col[:] = value
    return col


class RowGroupDecoderWorker:
    """Worker factory: ``worker()`` returns a ``process(WorkItem) -> ColumnBatch``
    closure that keeps its own file handles (memory-mapped locally, windowed
    elsewhere), so each pool thread calls the factory once.

    ``fs_factory`` gives the dataset's filesystem (default: the local one);
    ``retry_policy`` (``retry.RetryPolicy`` or None) and ``circuit_breaker``
    (``retry.CircuitBreaker`` or None, shared by the reader's workers)
    govern the rowgroup reads."""

    def __init__(self, schema: Schema, read_fields: Sequence[str],
                 device_decode_fields: Sequence[str] = (), mixed_fields: Sequence[str] = (),
                 decode_threads: int = 1,
                 decode_roi: Optional[Mapping[str, tuple]] = None,
                 cache: Optional[CacheBase] = None, dataset_url: str = "",
                 predicate=None, transform: Optional[transform_mod.TransformSpec] = None,
                 transform_cache_info=None, ngram=None, ngram_schema: Optional[Schema] = None,
                 verify_checksums: bool = False, fs_factory=None, retry_policy=None,
                 circuit_breaker=None, telemetry=None, split_fields: Sequence[str] = (),
                 decode_split=None):
        self._schema = schema
        #: resolved in ``__call__``, where the worker runs
        self._telemetry = _resolve_telemetry(telemetry) if telemetry is not None else None
        #: the ``'auto'`` fields and the reader's shared split cell (0 host
        #: pixels, 1 device coefficient planes)
        self._split_fields = frozenset(split_fields)
        self._decode_split = decode_split
        self._fs_factory = fs_factory
        self._retry_policy = retry_policy
        self._circuit_breaker = circuit_breaker
        #: retries taken, raw reads issued through windows, rowgroups read
        #: through windows (``petastorm_tpu/worker.py:500-505``'s counters)
        self._io = {"retries": 0, "read_calls": 0, "rowgroups_read": 0}
        #: verify the Parquet page checksums on read (``petastorm_tpu/worker.py:218``)
        self._verify_checksums = bool(verify_checksums)
        self._read_fields = list(read_fields)
        #: fields shipped as coefficient planes (decode_placement='device')
        self._device_decode_fields = frozenset(device_decode_fields)
        #: the subset shipped as one object cell a row, any geometry
        #: (decode_placement='device-mixed')
        self._mixed_fields = frozenset(mixed_fields)
        #: fan-out of the native decode inside this worker (its share of the
        #: host's cores; the pool gives the parallelism between workers)
        self._decode_threads = max(1, int(decode_threads))
        #: field -> ROI spec ((y, x, h, w) | ('center', h, w) | ('random', h, w))
        self._decode_roi = dict(decode_roi or {})
        self._predicate = predicate
        self._transform = transform
        #: window spec (``ngram.NGram``) and the post-transform schema its
        #: windows are formed over
        self._ngram = ngram
        self._ngram_schema = ngram_schema or schema
        self._stats_lock = threading.Lock()
        self._stats = dict.fromkeys(native_image.decode_stats(), 0)
        #: the reader's rowgroup cache (``cache.make_cache``)
        self.cache = cache or NullCache()
        self._cache_is_null = isinstance(self.cache, NullCache)
        #: decode-into-slot is safe only when the cache keeps no reference to
        #: a decoded batch (``petastorm_tpu/worker.py:125-131``)
        self._allow_batch_slots = not getattr(self.cache, "retains_value_references", True)
        self._cache_prefix = hashlib.md5(dataset_url.encode()).hexdigest()
        # one analysis walk a reader (it md5s bytecode and captured arrays):
        # make_reader passes the triple in, a direct construction computes it
        if transform_cache_info is None:
            transform_cache_info = transform_mod.transform_cache_info(transform)
        self._transform_signature, cacheable, reason = transform_cache_info
        #: the cache holds the transform's output (``:149-164``)
        self._transform_output_cached = False
        if transform is not None and not self._cache_is_null and ngram is None:
            # an ngram reader's windows form after the transform with
            # slice-dependent anchors: its transform output is not cached
            if cacheable:
                self._transform_output_cached = True
                logger.info("post-transform output caching armed (%s; signature %s,"
                            " stage tag %r)", reason, self._transform_signature,
                            _TRANSFORM_STAGE)
            else:
                transform_mod.log_output_cache_disabled(transform, reason,
                                                        self._transform_signature)
        self._transform_events = {"transform_hits": 0, "transform_misses": 0}
        tag = (",".join(self._read_fields)
               # the stored form of a device-decode field is its coefficient planes
               + "|rawcoef1:" + ",".join(sorted(self._device_decode_fields))
               # a mixed read stores object cells, a 'device' read plane columns
               + "|mixedcoef1:" + ",".join(sorted(self._mixed_fields))
               + "|roi:" + repr(sorted((k, tuple(v)) for k, v in self._decode_roi.items()))
               # the key carries the transform's signature at either stage
               + "|tf:" + self._transform_signature
               + "|" + _CACHE_KEY_TAG)
        # the live split changes the stored form: one tag a side
        splits = (None,) if decode_split is None else (0, 1)
        self._fields_tags = {
            v: hashlib.md5((tag + ("" if v is None else f"|split:{v}")).encode()).hexdigest()[:8]
            for v in splits}
        self._transform_fields_tag = hashlib.md5(
            (tag + "|stage:" + _TRANSFORM_STAGE).encode()).hexdigest()[:8]
        self._file_fps: Dict[str, str] = {}
        #: key -> [lock, users]: the fill in progress of each key
        self._filling: Dict[str, list] = {}
        self._filling_lock = threading.Lock()

    def __getstate__(self):
        # into a process-pool worker: its locks are recreated there, and its
        # recorder is resolved from that process's environment
        state = dict(self.__dict__)
        for name in ("_stats_lock", "_filling_lock", "_filling"):
            del state[name]
        state["_telemetry"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._stats_lock = threading.Lock()
        self._filling_lock = threading.Lock()
        self._filling = {}

    def decode_stats(self) -> dict:
        """The native decode counters (``native.image.decode_stats`` keys)
        summed over every rowgroup this worker factory's threads decoded."""
        with self._stats_lock:
            return dict(self._stats)

    def io_stats(self) -> dict:
        """``retries`` (rowgroup reads retried), ``read_calls`` and
        ``rowgroups_read`` (raw reads and rowgroups through a remote file's
        window) and ``reads_per_rowgroup``, their ratio (1.0 when the window
        covers every rowgroup; None when nothing was read remotely)."""
        with self._stats_lock:
            out = dict(self._io)
        out["reads_per_rowgroup"] = (out["read_calls"] / out["rowgroups_read"]
                                     if out["rowgroups_read"] else None)
        return out

    def transform_cache_stats(self) -> dict:
        """``transform_hits`` and ``transform_misses``, the lookups of cached
        transform output (both 0 unless the output is cached); ``{}``
        without a transform."""
        if self._transform is None:
            return {}
        with self._stats_lock:
            return dict(self._transform_events)

    def _roi_for(self, name: str, item: WorkItem, n: int):
        """A field's decode-ROI spec as ``(ys, xs, crop_h, crop_w)`` for the
        ``n`` rows decoded from this item (after a predicate's mask).
        ``'random'`` offsets come from the rowgroup's dataset-global index
        and the item's slice start, so a re-read decodes the same crops."""
        spec = self._decode_roi.get(name)
        if spec is None:
            return None
        full_h, full_w = self._schema[name].shape[:2]
        if spec[0] == "center":
            _, crop_h, crop_w = spec
            return ((full_h - crop_h) // 2, (full_w - crop_w) // 2, crop_h, crop_w)
        if spec[0] == "random":
            _, crop_h, crop_w = spec
            lo, _ = item.row_slice()
            rng = seed_stream(0, 0, "worker.decode_roi", item.row_group.global_index, lo)
            ys = rng.integers(0, full_h - crop_h + 1, n, dtype=np.int32)
            xs = rng.integers(0, full_w - crop_w + 1, n, dtype=np.int32)
            return (ys, xs, crop_h, crop_w)
        y, x, crop_h, crop_w = spec
        return (int(y), int(x), crop_h, crop_w)

    def _file_fingerprint(self, path: str, fs=None) -> str:
        """``size:mtime_ns`` of a dataset file, memoized per path: a file
        rewritten in place changes the key (``petastorm_tpu/worker.py:366``).
        A file of a remote filesystem is asked through ``fs``."""
        fp = self._file_fps.get(path)
        if fp is None:
            try:
                if fs is None or isinstance(fs, pafs.LocalFileSystem):
                    st = os.stat(path)
                    fp = f"{st.st_size}:{st.st_mtime_ns}"
                else:
                    info = fs.get_file_info(path)
                    fp = f"{info.size}:{info.mtime_ns}"
            except OSError:
                fp = "?"
            self._file_fps[path] = fp
        return fp

    def _cache_key(self, item: WorkItem, stage: str = "decode",
                   span: Optional[tuple] = None, fs=None, split: Optional[int] = None) -> str:
        """The cache key of one work item (``petastorm_tpu/worker.py:384``)
        over the rows ``span`` it loads (default: its row slice), with the
        split side it decodes under; ``stage=_TRANSFORM_STAGE`` keys the
        transform's output."""
        start, stop = span if span is not None else item.row_slice()
        rg = item.row_group
        tag = self._fields_tags[split] if stage == "decode" else self._transform_fields_tag
        return (f"{self._cache_prefix}:{rg.path}:{rg.row_group}:{start}:{stop}"
                f":{tag}:{self._file_fingerprint(rg.path, fs)}")

    def _cached(self, key: str, fill: Callable[[], ColumnBatch]) -> ColumnBatch:
        """``cache.get(key, fill)``, one thread at a time for one key."""
        with self._filling_lock:
            entry = self._filling.setdefault(key, [threading.Lock(), 0])
            entry[1] += 1
        try:
            with entry[0]:
                return self.cache.get(key, fill)
        finally:
            with self._filling_lock:
                entry[1] -= 1
                if not entry[1]:
                    del self._filling[key]

    def _note_transform_cache(self, hit: bool) -> None:
        """One post-transform cache lookup: in the shared tier's header, or
        in this worker's telemetry (``petastorm_tpu/worker.py:417-429``)."""
        note = getattr(self.cache, "note_transform_event", None)
        if note is not None:
            note(hit)
            return
        tele = self._telemetry
        if tele is not None and tele.enabled:
            tele.counter("cache.transform_hits" if hit else "cache.transform_stores").add(1)

    def _ships_coefficients(self, name: str, split: Optional[int]) -> bool:
        """Whether field ``name`` leaves this rowgroup in the coefficient
        form: a ``'device'`` field always, an ``'auto'`` one when the split
        read for the rowgroup is 1."""
        if name not in self._device_decode_fields:
            return False
        return name not in self._split_fields or split != 0

    def _apply_transform(self, batch: ColumnBatch) -> ColumnBatch:
        """The transform on a decoded batch; a 0-row batch passes untouched
        (a transform may stack or reduce over rows)."""
        if self._transform is None or batch.num_rows == 0:
            return batch
        cols = self._transform(batch.columns)
        nrows = len(next(iter(cols.values()))) if cols else 0
        return ColumnBatch(cols, nrows)

    def _empty_batch(self) -> ColumnBatch:
        """Zero-row batch carrying every read field with its dtype
        (``petastorm_tpu/worker.py:569``)."""
        cols = {}
        for name in self._read_fields:
            field = self._schema[name]
            if field.is_fixed_shape and field.dtype.kind not in ("U", "S", "O"):
                cols[name] = np.empty((0,) + field.shape, dtype=field.dtype)
            else:
                cols[name] = np.empty(0, dtype=object)
        return ColumnBatch(cols, 0)

    def __call__(self) -> Callable[[WorkItem], ColumnBatch]:
        if self._telemetry is None:
            self._telemetry = _resolve_telemetry(None)
        tele = self._telemetry
        fs = self._fs_factory() if self._fs_factory is not None else pafs.LocalFileSystem()
        local = isinstance(fs, pafs.LocalFileSystem)
        open_files: Dict[str, tuple] = {}
        #: the split side of the item this thread decodes (read once an item)
        current = {"split": None}

        def stage(name: str, item: Optional[WorkItem] = None):
            if not tele.enabled:
                return NULL_CONTEXT
            if item is None:
                return tele.stage(name)
            return tele.stage(name, path=item.row_group.path, rowgroup=item.row_group.row_group)

        def parquet_file(path: str) -> tuple:
            """(ParquetFile, the names of the columns it stores, its
            ``WindowedFile`` or None)."""
            entry = open_files.get(path)
            if entry is None:
                if len(open_files) >= _MAX_OPEN_FILES:
                    open_files.pop(next(iter(open_files)))[0].close()
                window = None
                if local:
                    source = pa.memory_map(path)
                else:
                    # one ranged read a rowgroup (io_window); pre_buffer
                    # coalesces the spans the window refuses, and its reads
                    # land inside the window when one is armed
                    window = WindowedFile(fs.open_input_file(path))
                    source = pa.PythonFile(window, mode="r")
                pf = pq.ParquetFile(source, pre_buffer=not local,
                                    page_checksum_verification=self._verify_checksums)
                entry = open_files[path] = (pf, frozenset(pf.schema_arrow.names), window)
            return entry

        def load(item: WorkItem, fields: Sequence[str],
                 mask: Optional[np.ndarray] = None,
                 row_range: Optional[tuple] = None) -> ColumnBatch:
            """Read the rows ``row_range`` (default: the item's row slice) of
            ``fields``, keep the ``mask``ed rows, then decode them
            (``petastorm_tpu/worker.py:481``)."""
            rg = item.row_group
            pf, file_cols, window = parquet_file(rg.path)
            stored = [f for f in fields if f in file_cols]
            reads_before = window.raw_reads if window is not None else 0
            if window is not None and stored:
                span = rowgroup_span(pf.metadata, rg.row_group, stored)
                if span is not None:
                    window.prefetch(span[0], span[1])
            # the pool provides the parallelism; arrow's own fan-out per read
            # only adds handoff cost
            table = pf.read_row_group(rg.row_group, columns=stored, use_threads=False)
            if window is not None:
                window.discard_window()  # the table owns the bytes now
                reads = window.raw_reads - reads_before
                with self._stats_lock:
                    self._io["read_calls"] += reads
                    self._io["rowgroups_read"] += 1
                if tele.enabled:
                    tele.counter("io.read_calls").add(reads)
                    tele.counter("io.rowgroups_read").add(1)
                    tele.gauge("io.reads_per_rowgroup").set(reads)
            start, stop = row_range if row_range is not None else item.row_slice()
            if (start, stop) != (0, table.num_rows):
                table = table.slice(start, stop - start)
            if mask is not None:
                table = table.filter(pa.array(mask))
            n = table.num_rows
            columns = {}
            for name in stored:
                field = self._schema[name]
                chunk = table.column(name).combine_chunks()
                if self._ships_coefficients(name, current["split"]):
                    pack = (native_image.pack_coef_columns_mixed if name in self._mixed_fields
                            else native_image.pack_coef_columns)
                    columns.update(pack(name, chunk, field, nthreads=self._decode_threads))
                else:
                    with decode_options(nthreads=self._decode_threads,
                                        roi=self._roi_for(name, item, n),
                                        batch_slots=self._allow_batch_slots):
                        columns[name] = field.codec.decode_column(field, chunk)
            # fields the file does not store: hive partition keys, constant
            # over the rowgroup, from its path (``:552-560``)
            pvals = dict(rg.partition_values)
            for name in fields:
                if name in file_cols:
                    continue
                if name not in pvals:
                    raise PetastormTpuError(
                        f"Field {name!r} is neither stored in {rg.path!r}"
                        " nor a partition key")
                columns[name] = _partition_column(self._schema[name], pvals[name], n)
            return ColumnBatch(columns, n)

        def load_with_predicate(item: WorkItem,
                                row_range: Optional[tuple] = None) -> ColumnBatch:
            """The split read (``petastorm_tpu/worker.py:581-623``)."""
            pred_fields = list(self._predicate.get_fields())
            missing = [f for f in pred_fields if f not in self._schema]
            if missing:
                raise PetastormTpuError(f"Predicate references unknown fields {missing}")
            # phase 1: the predicate's columns only
            pred_batch = load(item, pred_fields, row_range=row_range)
            mask = np.asarray(self._predicate.do_include_vectorized(pred_batch.columns),
                              dtype=bool)
            if tele.enabled:
                # rows dropped before the payload decode (``petastorm_tpu/worker.py:591-599``)
                tele.counter("sequence.rows_filtered").add(int(mask.size - mask.sum()))
            if not mask.any():
                return self._empty_batch()
            # phase 2: the other columns, filtered by the mask before decode
            remaining = [f for f in self._read_fields if f not in pred_fields]
            columns = {f: pred_batch.columns[f][mask] for f in pred_fields}
            if remaining:
                columns.update(load(item, remaining, mask=mask, row_range=row_range).columns)
            # the read fields only, in schema order (a device-decode field
            # travels as its derived '<name>#...' coefficient columns)
            kept: Dict[str, np.ndarray] = {}
            for f in self._read_fields:
                if f in columns:
                    kept[f] = columns[f]
                elif f in self._device_decode_fields:
                    prefix = f + native_image.COEF_COLUMN_SEP
                    kept.update((k, c) for k, c in columns.items() if k.startswith(prefix))
            return ColumnBatch(kept, int(mask.sum()))

        def transformed(batch: ColumnBatch) -> ColumnBatch:
            if self._transform is None or batch.num_rows == 0:
                return batch
            with stage("transform"):
                return self._apply_transform(batch)

        def decode(item: WorkItem) -> ColumnBatch:
            if self._predicate is not None:
                # the reader refuses a cache beside a predicate
                with stage("decode", item):
                    batch = load_with_predicate(item)
                return transformed(batch)
            if self._transform_output_cached:
                filled = []

                def decode_and_transform() -> ColumnBatch:
                    # the spans live inside the fill: a warm hit records none
                    filled.append(True)
                    with stage("decode", item):
                        fresh = load(item, self._read_fields)
                    return transformed(fresh)

                batch = self._cached(self._cache_key(item, _TRANSFORM_STAGE, fs=fs),
                                     decode_and_transform)
                with self._stats_lock:
                    self._transform_events["transform_misses" if filled
                                           else "transform_hits"] += 1
                self._note_transform_cache(hit=not filled)
                return batch
            with stage("decode", item):
                if self._cache_is_null:
                    batch = load(item, self._read_fields)
                else:
                    batch = self._cached(self._cache_key(item, fs=fs, split=current["split"]),
                                         lambda: load(item, self._read_fields))
            return transformed(batch)

        def decode_windows(item: WorkItem) -> ColumnBatch:
            """An ngram item: its rows (and lookahead), transformed, then
            windowed (``petastorm_tpu/worker.py:283-301``, ``:357-364``)."""
            lo, hi = item.row_slice()
            whole = WorkItem(item.row_group)
            if self._ngram.timestamp_overlap:
                row_range = (lo, min(hi + self._ngram.length - 1, item.row_group.num_rows))
                anchor = (0, hi - lo)
            else:
                row_range, anchor = whole.row_slice(), (lo, hi)
            with stage("decode", item):
                if self._predicate is not None:
                    batch = load_with_predicate(whole, row_range)
                elif self._cache_is_null:
                    batch = load(whole, self._read_fields, row_range=row_range)
                else:
                    batch = self._cached(self._cache_key(whole, span=row_range, fs=fs),
                                         lambda: load(whole, self._read_fields,
                                                      row_range=row_range))
            if batch.num_rows == 0:
                return batch
            with stage("transform"):
                return self._ngram.form_windows(self._ngram_schema,
                                                self._apply_transform(batch),
                                                anchor_range=anchor)

        def drop_handle(path: str) -> None:
            """Count a retry and drop the file's cached handle: the failure
            may have poisoned its stream (``petastorm_tpu/worker.py:232-240``)."""
            with self._stats_lock:
                self._io["retries"] += 1
            entry = open_files.pop(path, None)
            if entry is not None:
                try:
                    entry[0].close()
                except Exception:  # noqa: BLE001 - already failing
                    pass

        def process(item: WorkItem) -> ColumnBatch:
            before = native_image.decode_stats()
            run = decode if self._ngram is None else decode_windows
            rg = item.row_group
            cell = self._decode_split
            current["split"] = None if cell is None else int(cell.value)
            batch = retry_call(lambda: run(item), self._retry_policy,
                               what=f"rowgroup {rg.path}#{rg.row_group}",
                               on_retry=lambda _exc: drop_handle(rg.path),
                               telemetry=tele, breaker=self._circuit_breaker)
            # this thread's counters: a hit decoded nothing and adds nothing
            after = native_image.decode_stats()
            with self._stats_lock:
                for key, value in after.items():
                    self._stats[key] += value - before[key]
            if tele.enabled:
                tele.counter("worker.rowgroups_decoded").add(1)
                tele.counter("worker.rows_decoded").add(batch.num_rows)
                for key, value in after.items():
                    if value - before[key]:
                        tele.counter(f"decode.{key}").add(value - before[key])
            return batch

        return process
