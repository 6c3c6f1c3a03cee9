"""Schema-driven synthetic Reader stand-in (no parquet, no IO).

Counterpart of ``petastorm_tpu/test_util/reader_mock.py`` (reference:
petastorm/test_util/reader_mock.py:19-82): a fake reader that generates
schema-conformant rows, so the adapters (``CudaDataLoader``, the torch and
tf adapters) can be tested without storage.  It speaks the real reader's
columnar protocol (``iter_batches()`` yielding ``ColumnBatch``), so the
loaders' hot path runs unchanged; from one seed it draws the JAX mock's
values.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from petastorm_tpu_torch.batch import ColumnBatch
from petastorm_tpu_torch.schema import Schema


def schema_data_generator(schema: Schema, rng: np.random.Generator,
                          batch_size: int) -> Dict[str, np.ndarray]:
    """Random column dict conformant to ``schema`` (fixed shapes only)."""
    cols: Dict[str, np.ndarray] = {}
    for f in schema:
        shape = tuple(d if d is not None else 3 for d in f.shape)
        full = (batch_size,) + shape
        if f.dtype.kind == "O":
            cols[f.name] = np.asarray(
                [f"{f.name}_{i}" for i in range(batch_size)], dtype=object)
        elif f.dtype.kind in "ui":
            cols[f.name] = rng.integers(0, 127, full).astype(f.dtype)
        elif f.dtype.kind == "b":
            cols[f.name] = rng.integers(0, 2, full).astype(bool)
        else:
            cols[f.name] = rng.standard_normal(full).astype(f.dtype)
    return cols


class ReaderMock:
    """Duck-typed Reader: same iteration/lifecycle surface, synthetic data.

    ``generator(schema, rng, batch_size) -> {name: array}`` may be supplied to
    control values; by default `schema_data_generator` is used.  A finite
    ``num_batches`` makes the mock iterable to exhaustion like a 1-epoch reader;
    ``None`` streams forever (benchmark mode).
    """

    def __init__(self, schema: Schema,
                 generator: Optional[Callable] = None,
                 batch_size: int = 16,
                 num_batches: Optional[int] = 64,
                 seed: int = 0):
        self.schema = schema
        self.output_schema = schema
        self.batched_output = True
        self.last_row_consumed = False
        self.ngram = None
        self._generator = generator or schema_data_generator
        self._batch_size = batch_size
        self._num_batches = num_batches
        self._rng = np.random.default_rng(seed)
        self._produced = 0
        self._stopped = False
        self._namedtuple_type = schema.make_namedtuple_type()
        self._pending_rows: Optional[ColumnBatch] = None
        self._pending_pos = 0

    # -- columnar protocol (what the jax/pytorch/tf loaders consume) ----------

    def _make_batch(self) -> ColumnBatch:
        cols = self._generator(self.schema, self._rng, self._batch_size)
        return ColumnBatch(cols, self._batch_size)

    def iter_batches(self):
        while not self._stopped:
            if (self._num_batches is not None
                    and self._produced >= self._num_batches):
                self.last_row_consumed = True
                return
            self._produced += 1
            yield self._make_batch()

    # -- row protocol ---------------------------------------------------------

    def __iter__(self):
        return self

    def __next__(self):
        if self._pending_rows is None or self._pending_pos >= self._pending_rows.num_rows:
            if (self._num_batches is not None
                    and self._produced >= self._num_batches):
                self.last_row_consumed = True
                raise StopIteration
            self._produced += 1
            self._pending_rows = self._make_batch()
            self._pending_pos = 0
        row = {name: col[self._pending_pos] for name, col in self._pending_rows.columns.items()}
        self._pending_pos += 1
        return self._namedtuple_type(**{n: row[n] for n in self.schema.fields})

    # -- lifecycle ------------------------------------------------------------

    def reset(self) -> None:
        self._produced = 0
        self._pending_rows = None
        self._pending_pos = 0
        self.last_row_consumed = False

    def stop(self) -> None:
        self._stopped = True

    def join(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        self.join()

    @property
    def diagnostics(self) -> dict:
        return {"produced_batches": self._produced}
