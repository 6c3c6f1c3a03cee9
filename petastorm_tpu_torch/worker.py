"""Rowgroup decode worker: a parquet rowgroup -> a decoded ColumnBatch.

Counterpart of ``petastorm_tpu/worker.py:47 RowGroupDecoderWorker``, without
the cache tiers, decode ROI, predicates and transforms.  A field read with
``decode_placement='device'`` leaves the worker in the coefficient wire form
(``petastorm_tpu/worker.py:527-541``): the entropy half of the JPEG decode
runs here and the field travels as its derived plane columns
(``native.image.pack_coef_columns``); the loader finishes the decode on the
device.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import pyarrow as pa
import pyarrow.parquet as pq

from petastorm_tpu_torch.batch import ColumnBatch
from petastorm_tpu_torch.native.image import pack_coef_columns
from petastorm_tpu_torch.plan import WorkItem
from petastorm_tpu_torch.schema import Schema

_MAX_OPEN_FILES = 8


class RowGroupDecoderWorker:
    """Worker factory: ``worker()`` returns a ``process(WorkItem) -> ColumnBatch``
    closure that keeps its own memory-mapped file handles, so each pool
    thread calls the factory once."""

    def __init__(self, schema: Schema, read_fields: Sequence[str],
                 device_decode_fields: Sequence[str] = ()):
        self._schema = schema
        self._read_fields = list(read_fields)
        #: fields shipped as coefficient planes (decode_placement='device')
        self._device_decode_fields = frozenset(device_decode_fields)

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
            # the pool provides the parallelism; arrow's own fan-out per read
            # only adds handoff cost
            table = parquet_file(rg.path).read_row_group(
                rg.row_group, columns=self._read_fields, use_threads=False)
            columns = {}
            for name in self._read_fields:
                field = self._schema[name]
                chunk = table.column(name).combine_chunks()
                if name in self._device_decode_fields:
                    columns.update(pack_coef_columns(name, chunk, field))
                else:
                    columns[name] = field.codec.decode_column(field, chunk)
            return ColumnBatch(columns, table.num_rows)

        return process
