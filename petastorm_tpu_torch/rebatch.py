"""Exact-size batch assembly across input-batch boundaries.

Counterpart of ``petastorm_tpu/rebatch.py``, which mirrors the reference's
``BatchingTableQueue`` (petastorm/pyarrow_helpers/batching_table_queue.py):
a FIFO of batches whose ``get()`` slices exact-size batches spanning input
boundaries.  A host building block: no path of the reader or the loader
uses it; it serves consumers that need strictly fixed-size batches from an
arbitrary stream of :class:`ColumnBatch` or arrow data.  The errors carry
the JAX package's messages.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Optional, Union

import pyarrow as pa

from petastorm_tpu_torch.batch import ColumnBatch
from petastorm_tpu_torch.errors import PetastormTpuError


def _to_column_batch(data) -> ColumnBatch:
    if isinstance(data, ColumnBatch):
        return data
    if isinstance(data, pa.RecordBatch):
        data = pa.Table.from_batches([data])
    if isinstance(data, pa.Table):
        return ColumnBatch({name: data.column(name).to_numpy(zero_copy_only=False)
                            for name in data.column_names}, data.num_rows)
    raise PetastormTpuError(
        f"BatchingQueue accepts ColumnBatch/pa.Table/pa.RecordBatch, got {type(data)}")


class BatchingQueue:
    """FIFO that re-slices an arbitrary stream of batches into exact-size ones.

    ``put`` appends batches of any size; ``get`` returns exactly
    ``batch_size`` rows assembled across input boundaries (it raises when
    fewer are buffered: check :meth:`can_get`); ``flush`` returns the ragged
    remainder.  Slices stay views until a batch spans two inputs.
    """

    def __init__(self, batch_size: int):
        if batch_size < 1:
            raise PetastormTpuError(f"batch_size must be >= 1, got {batch_size}")
        self._batch_size = batch_size
        self._queue: Deque[ColumnBatch] = deque()
        self._head_offset = 0  # rows of queue[0] already taken
        self._buffered = 0

    def __len__(self) -> int:
        """Rows currently buffered."""
        return self._buffered

    @property
    def batch_size(self) -> int:
        return self._batch_size

    def empty(self) -> bool:
        return self._buffered == 0

    def can_get(self) -> bool:
        return self._buffered >= self._batch_size

    def put(self, data: Union[ColumnBatch, "pa.Table", "pa.RecordBatch"]) -> None:
        batch = _to_column_batch(data)
        if batch.num_rows == 0:
            return
        self._queue.append(batch)
        self._buffered += batch.num_rows

    def _take(self, nrows: int) -> ColumnBatch:
        parts = []
        need = nrows
        while need > 0:
            head = self._queue[0]
            take = min(head.num_rows - self._head_offset, need)
            parts.append(head.slice_rows(self._head_offset, self._head_offset + take))
            need -= take
            self._head_offset += take
            if self._head_offset == head.num_rows:
                self._queue.popleft()
                self._head_offset = 0
        self._buffered -= nrows
        return parts[0] if len(parts) == 1 else ColumnBatch.concat(parts)

    def get(self) -> ColumnBatch:
        if not self.can_get():
            raise PetastormTpuError(
                f"BatchingQueue has {self._buffered} rows buffered; need"
                f" {self._batch_size} (check can_get(), or flush() the tail)")
        return self._take(self._batch_size)

    def flush(self) -> Optional[ColumnBatch]:
        """Everything still buffered as one batch (after ``get`` has taken the
        exact-size batches, the ragged tail), or None."""
        if self._buffered == 0:
            return None
        return self._take(self._buffered)
