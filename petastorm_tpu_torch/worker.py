"""Rowgroup decode worker: a parquet rowgroup -> a decoded ColumnBatch.

Counterpart of ``petastorm_tpu/worker.py:47 RowGroupDecoderWorker``, without
the cache tiers, predicates and transforms.  Image columns decode in one
native call each (``codecs.CompressedImageCodec.decode_column``), fanned out
over ``decode_threads`` and cropped to the field's ``decode_roi``
(``:447-479``, ``:545-551``).  A field read with ``decode_placement='device'``
leaves the worker in the coefficient wire form (``:527-541``): the entropy
half of the JPEG decode runs here, over ``decode_threads`` too, and the field
travels as its derived plane columns (``native.image.pack_coef_columns``);
the loader finishes the decode on the device.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Mapping, Optional, Sequence

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from petastorm_tpu_torch.batch import ColumnBatch
from petastorm_tpu_torch.codecs import decode_options
from petastorm_tpu_torch.native import image as native_image
from petastorm_tpu_torch.plan import WorkItem
from petastorm_tpu_torch.schema import Schema
from petastorm_tpu_torch.seeding import seed_stream

_MAX_OPEN_FILES = 8


class RowGroupDecoderWorker:
    """Worker factory: ``worker()`` returns a ``process(WorkItem) -> ColumnBatch``
    closure that keeps its own memory-mapped file handles, so each pool
    thread calls the factory once."""

    def __init__(self, schema: Schema, read_fields: Sequence[str],
                 device_decode_fields: Sequence[str] = (), decode_threads: int = 1,
                 decode_roi: Optional[Mapping[str, tuple]] = None):
        self._schema = schema
        self._read_fields = list(read_fields)
        #: fields shipped as coefficient planes (decode_placement='device')
        self._device_decode_fields = frozenset(device_decode_fields)
        #: fan-out of the native decode inside this worker (its share of the
        #: host's cores; the pool gives the parallelism between workers)
        self._decode_threads = max(1, int(decode_threads))
        #: field -> ROI spec ((y, x, h, w) | ('center', h, w) | ('random', h, w))
        self._decode_roi = dict(decode_roi or {})
        self._stats_lock = threading.Lock()
        self._stats = dict.fromkeys(native_image.decode_stats(), 0)

    def decode_stats(self) -> dict:
        """The native decode counters (``native.image.decode_stats`` keys)
        summed over every rowgroup this worker factory's threads decoded."""
        with self._stats_lock:
            return dict(self._stats)

    def _roi_for(self, name: str, item: WorkItem, n: int):
        """A field's decode-ROI spec as ``(ys, xs, crop_h, crop_w)`` for this
        rowgroup's ``n`` rows.  ``'random'`` offsets come from the
        rowgroup's dataset-global index, so a re-read decodes the same crops."""
        spec = self._decode_roi.get(name)
        if spec is None:
            return None
        full_h, full_w = self._schema[name].shape[:2]
        if spec[0] == "center":
            _, crop_h, crop_w = spec
            return ((full_h - crop_h) // 2, (full_w - crop_w) // 2, crop_h, crop_w)
        if spec[0] == "random":
            _, crop_h, crop_w = spec
            # a WorkItem is a whole rowgroup: its row slice starts at 0
            rng = seed_stream(0, 0, "worker.decode_roi", item.row_group.global_index, 0)
            ys = rng.integers(0, full_h - crop_h + 1, n, dtype=np.int32)
            xs = rng.integers(0, full_w - crop_w + 1, n, dtype=np.int32)
            return (ys, xs, crop_h, crop_w)
        y, x, crop_h, crop_w = spec
        return (int(y), int(x), crop_h, crop_w)

    def __call__(self) -> Callable[[WorkItem], ColumnBatch]:
        open_files: Dict[str, pq.ParquetFile] = {}

        def parquet_file(path: str) -> pq.ParquetFile:
            pf = open_files.get(path)
            if pf is None:
                if len(open_files) >= _MAX_OPEN_FILES:
                    open_files.pop(next(iter(open_files))).close()
                pf = open_files[path] = pq.ParquetFile(pa.memory_map(path))
            return pf

        def process(item: WorkItem) -> ColumnBatch:
            rg = item.row_group
            before = native_image.decode_stats()
            # the pool provides the parallelism; arrow's own fan-out per read
            # only adds handoff cost
            table = parquet_file(rg.path).read_row_group(
                rg.row_group, columns=self._read_fields, use_threads=False)
            n = table.num_rows
            columns = {}
            for name in self._read_fields:
                field = self._schema[name]
                chunk = table.column(name).combine_chunks()
                if name in self._device_decode_fields:
                    columns.update(native_image.pack_coef_columns(
                        name, chunk, field, nthreads=self._decode_threads))
                else:
                    with decode_options(nthreads=self._decode_threads,
                                        roi=self._roi_for(name, item, n)):
                        columns[name] = field.codec.decode_column(field, chunk)
            after = native_image.decode_stats()
            with self._stats_lock:
                for key, value in after.items():
                    self._stats[key] += value - before[key]
            return ColumnBatch(columns, n)

        return process
