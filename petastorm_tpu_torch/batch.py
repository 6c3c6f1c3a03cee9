"""ColumnBatch: the unit of data between the decode workers and the loader.

Counterpart of ``petastorm_tpu/batch.py:19``: a dict of numpy arrays,
batch-major and contiguous for fixed-shape fields.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np


@dataclasses.dataclass
class ColumnBatch:
    columns: Dict[str, np.ndarray]
    num_rows: int

    def __post_init__(self):
        for name, col in self.columns.items():
            if len(col) != self.num_rows:
                raise ValueError(
                    f"Column {name!r} has {len(col)} rows, expected {self.num_rows}")

    def slice_rows(self, start: int, stop: int) -> "ColumnBatch":
        stop = min(stop, self.num_rows)
        return ColumnBatch({n: c[start:stop] for n, c in self.columns.items()},
                           max(stop - start, 0))

    @staticmethod
    def concat(batches: Sequence["ColumnBatch"]) -> "ColumnBatch":
        """Row-wise concatenation; a single batch passes through uncopied."""
        batches = [b for b in batches if b.num_rows]
        if not batches:
            return ColumnBatch({}, 0)
        if len(batches) == 1:
            return batches[0]
        out = {}
        for name in batches[0].columns:
            cols = [b.columns[name] for b in batches]
            if all(c.dtype != object for c in cols):
                out[name] = np.concatenate(cols)
            else:
                merged = np.empty(sum(len(c) for c in cols), dtype=object)
                i = 0
                for c in cols:
                    merged[i:i + len(c)] = c
                    i += len(c)
                out[name] = merged
        return ColumnBatch(out, sum(b.num_rows for b in batches))
