"""Readers: a dataset URL -> decoded rows or column batches.

Counterpart of ``petastorm_tpu/reader.py:73 make_reader``,
``:374 make_batch_reader`` and ``:1159 Reader``, with the arguments the
ImageNet feed uses: field selection, the thread or serial pool, rowgroup
shuffling by seed, epochs and static sharding.  Delivery follows the read
plan's order with either pool, as the JAX reader does when it is given a
``shuffle_seed``.  Predicates, selectors, caches, transforms, resume, ngrams,
decode placement, telemetry and the ingest service are not part of this
package yet.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

from petastorm_tpu_torch.batch import ColumnBatch
from petastorm_tpu_torch.errors import NoDataAvailableError, PetastormTpuError, ReaderClosedError
from petastorm_tpu_torch.etl.metadata import infer_or_load_schema, open_dataset
from petastorm_tpu_torch.plan import ReadPlan, WorkItem
from petastorm_tpu_torch.pool import make_executor
from petastorm_tpu_torch.schema import Schema
from petastorm_tpu_torch.worker import RowGroupDecoderWorker

_DEFAULT_RESULTS_QUEUE_BATCHES = 10


def make_reader(dataset_url: str,
                schema_fields: Optional[Sequence] = None,
                reader_pool_type: str = "thread",
                workers_count: int = 4,
                results_queue_size: Optional[int] = None,
                shuffle_row_groups: bool = True,
                shuffle_seed: Optional[int] = None,
                num_epochs: Optional[int] = 1,
                cur_shard: Optional[int] = None,
                shard_count: Optional[int] = None) -> "Reader":
    """Row reader for datasets that carry a stored schema: yields one
    namedtuple per row; ``iter_batches()`` yields whole decoded rowgroups
    (the loader's path).  ``num_epochs=None`` reads forever."""
    return _make_reader(dataset_url, schema_fields, reader_pool_type, workers_count,
                        results_queue_size, shuffle_row_groups, shuffle_seed,
                        num_epochs, cur_shard, shard_count, batched_output=False)


def make_batch_reader(dataset_url: str,
                      schema_fields: Optional[Sequence] = None,
                      reader_pool_type: str = "thread",
                      workers_count: int = 4,
                      results_queue_size: Optional[int] = None,
                      shuffle_row_groups: bool = True,
                      shuffle_seed: Optional[int] = None,
                      num_epochs: Optional[int] = 1,
                      cur_shard: Optional[int] = None,
                      shard_count: Optional[int] = None) -> "Reader":
    """Batch reader: yields one namedtuple of column arrays per rowgroup.
    Plain parquet stores (no stored schema) are read with inferred scalar
    fields."""
    return _make_reader(dataset_url, schema_fields, reader_pool_type, workers_count,
                        results_queue_size, shuffle_row_groups, shuffle_seed,
                        num_epochs, cur_shard, shard_count, batched_output=True)


def _make_reader(dataset_url, schema_fields, reader_pool_type, workers_count,
                 results_queue_size, shuffle_row_groups, shuffle_seed, num_epochs,
                 cur_shard, shard_count, batched_output) -> "Reader":
    if num_epochs is not None and num_epochs < 1:
        raise PetastormTpuError("num_epochs must be >= 1 or None (infinite)")
    info = open_dataset(dataset_url, require_stored_schema=not batched_output)
    full_schema = infer_or_load_schema(info)
    schema = full_schema.view(schema_fields) if schema_fields is not None else full_schema
    plan = ReadPlan(info.row_groups, shard_index=cur_shard, shard_count=shard_count,
                    shuffle_row_groups=shuffle_row_groups, shuffle_seed=shuffle_seed)
    if not plan.epoch_items(0):
        raise NoDataAvailableError(f"No rowgroups to read in {dataset_url!r}")
    if results_queue_size is None:
        results_queue_size = _DEFAULT_RESULTS_QUEUE_BATCHES
    executor = make_executor(reader_pool_type, workers_count, results_queue_size)
    worker = RowGroupDecoderWorker(full_schema, [f.name for f in schema])
    return Reader(schema, plan, executor, worker, num_epochs, batched_output)


class Reader:
    """Iterates decoded data of one plan through one executor.

    Iterate rows (or per-rowgroup batches with ``batched_output``), or call
    :meth:`iter_batches` for raw ColumnBatches; do not mix the two on one
    reader.  A context manager: leaving it stops the workers.
    """

    def __init__(self, schema: Schema, plan: ReadPlan, executor, worker,
                 num_epochs: Optional[int], batched_output: bool):
        self.schema = schema
        self.plan = plan
        self.num_epochs = num_epochs
        self.batched_output = batched_output
        self._executor = executor
        self._executor.start(worker)
        self._batches: Optional[Iterator[ColumnBatch]] = None
        self._rows: Iterator = iter(())
        self._namedtuple_type = schema.make_namedtuple_type()
        self._stopped = False

    def _items(self) -> Iterator[WorkItem]:
        epoch = 0
        while self.num_epochs is None or epoch < self.num_epochs:
            yield from self.plan.epoch_items(epoch)
            epoch += 1

    def _next_batch(self) -> ColumnBatch:
        if self._stopped:
            raise ReaderClosedError("Reader is stopped")
        if self._batches is None:
            self._batches = self._executor.imap(self._items())
        return next(self._batches)

    def iter_batches(self) -> Iterator[ColumnBatch]:
        """Yield decoded rowgroups as ColumnBatches; ends cleanly on stop."""
        while True:
            try:
                yield self._next_batch()
            except (StopIteration, ReaderClosedError):
                return

    def __iter__(self):
        return self

    def __next__(self):
        if self.batched_output:
            batch = self._next_batch()
            return self._namedtuple_type(**{n: batch.columns[n] for n in self.schema.fields})
        for row in self._rows:
            return row
        cols = self._next_batch().columns
        self._rows = map(self._namedtuple_type._make,
                         zip(*[cols[n] for n in self.schema.fields]))
        return next(self)

    def stop(self) -> None:
        self._stopped = True
        self._executor.stop()

    def join(self) -> None:
        self._executor.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        self.join()
