"""PyTorch delivery layer: reader -> shuffled batches of torch tensors.

The port's copy of ``petastorm_tpu/pytorch.py`` (``_sanitize_column``,
``_column_to_torch``, ``decimal_friendly_collate``, ``LoaderBase``,
``DataLoader`` ``:120`` and ``BatchedDataLoader`` ``:214``) over the port's
reader and ``shuffle.py``.  Rowgroups land in the columnar numpy shuffling
buffer and every emitted batch is a dict of CPU torch tensors made with
``torch.from_numpy``; ``BatchedDataLoader``'s ``transform_fn`` moves them
where the caller wants (``lambda b: {k: v.to("cuda") for k, v in b.items()}``).
``CudaDataLoader`` (``cuda/loader.py``) is the port's pinned, copy-stream
feed for the card.  Readers with ``decode_placement='device'`` are refused,
as the reference refuses them.  A non-stacked ngram reader's
``'<offset>/<field>'`` columns are collated into ``{offset: {field:
tensor}}`` (``:152-157``, ``:189-197``); a ``stack_timesteps`` reader keeps
the flat dict of ``(batch, k, ...)`` tensors.
"""

from __future__ import annotations

import decimal
from typing import Callable, Dict, Optional

import numpy as np
import torch

from petastorm_tpu_torch.batch import ColumnBatch
from petastorm_tpu_torch.dtypes import _TORCH_FEED_PROMOTIONS
from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.ngram import NGRAM_KEY_SEP
from petastorm_tpu_torch.seeding import reader_buffer_seed
from petastorm_tpu_torch.shuffle import NoopShufflingBuffer, RandomShufflingBuffer, iter_batched



def _sanitize_column(name: str, col: np.ndarray) -> np.ndarray:
    """Promote dtypes torch lacks; reject strings (reference pytorch.py:57-69)."""
    if col.dtype == object:
        return col
    if col.dtype.kind in "US":
        raise TypeError(
            f"Field {name!r} is a string array: strings are not supported by"
            " torch tensors (reference contract, pytorch.py:61-66). Exclude it"
            " via schema_fields or transform it to a numeric type.")
    promoted = _TORCH_FEED_PROMOTIONS.get(col.dtype)
    if promoted is not None:
        return col.astype(promoted)
    return col


def _column_to_torch(name: str, col: np.ndarray):
    """One column -> torch tensor (fixed shape) or list (variable/object rows)."""
    col = _sanitize_column(name, col)
    if col.dtype != object:
        return torch.from_numpy(np.ascontiguousarray(col))
    out = []
    for value in col:
        if isinstance(value, decimal.Decimal):
            out.append(float(value))
        elif isinstance(value, str):
            raise TypeError(
                f"Field {name!r} contains strings, unsupported by torch"
                " (reference contract, pytorch.py:61-66)")
        elif isinstance(value, np.ndarray):
            out.append(torch.from_numpy(
                np.ascontiguousarray(_sanitize_column(name, value))))
        else:
            out.append(value)
    if out and isinstance(out[0], float) and all(
            isinstance(v, float) for v in out):
        return torch.tensor(out, dtype=torch.float64)
    return out


def decimal_friendly_collate(batch):
    """Collate that turns ``decimal.Decimal`` into floats before stacking
    (reference pytorch.py:72-94); useful with hand-rolled row loops."""
    if isinstance(batch, decimal.Decimal):
        return float(batch)
    if isinstance(batch, (list, tuple)) and batch and isinstance(
            batch[0], decimal.Decimal):
        return torch.tensor([float(v) for v in batch], dtype=torch.float64)
    if isinstance(batch, (list, tuple)) and batch and isinstance(batch[0], dict):
        return {k: decimal_friendly_collate([r[k] for r in batch])
                for k in batch[0]}
    from torch.utils.data._utils.collate import default_collate
    return default_collate(batch)


class LoaderBase:
    """Single-pass iteration guard + error latch (reference pytorch.py:102-127)."""

    def __init__(self):
        self._in_iter: Optional[bool] = None
        self._error: Optional[BaseException] = None

    def __iter__(self):
        if self._error is not None:
            raise RuntimeError(
                "Cannot start a new epoch: a previous iteration failed"
            ) from self._error
        if self._in_iter:
            raise RuntimeError("Loader is already being iterated")
        self._in_iter = True
        try:
            yield from self._iter_impl()
        except Exception as exc:
            self._error = exc
            raise
        finally:
            self._in_iter = False

    def _iter_impl(self):
        raise NotImplementedError


class DataLoader(LoaderBase):
    """Shuffling, batching torch loader over a petastorm_tpu_torch Reader.

    Yields dicts ``{field: torch.Tensor | list}`` of ``batch_size`` rows.
    ``shuffling_queue_capacity`` > 0 enables the row-level random buffer with a
    ``min_after_retrieve`` decorrelation floor at half capacity (reference
    shuffling_queue_capacity/min_after_dequeue, pytorch.py:143-189).  Without
    a ``seed``, a reader under ``deterministic='seed'`` seeds the buffer
    (domain ``"pytorch.shuffle_buffer"``).  A non-stacked ngram reader yields
    ``{offset: {field: tensor}}``; a ``stack_timesteps`` one keeps the flat
    dict, its stacked fields ``(batch, k, ...)`` tensors.
    """

    def __init__(self, reader, batch_size: int = 1,
                 shuffling_queue_capacity: int = 0,
                 seed: Optional[int] = None,
                 collate_fn: Optional[Callable[[Dict], Dict]] = None):
        super().__init__()
        if getattr(reader, "device_decode_fields", None):
            raise PetastormTpuError(
                f"fields {reader.device_decode_fields} use"
                " decode_placement='device' (coefficient planes finished on"
                " the card by cuda.CudaDataLoader); torch loaders need"
                " decode_placement='host'")
        if batch_size < 1:
            raise PetastormTpuError("batch_size must be >= 1")
        self.reader = reader
        self.batch_size = batch_size
        self.shuffling_queue_capacity = shuffling_queue_capacity
        self._seed = seed
        self._collate_fn = collate_fn
        ngram = getattr(reader, "ngram", None)
        #: a non-stacked ngram reader's offsets: its columns are collated
        #: back into {offset: {field: tensor}}
        self._ngram_offsets = (ngram.offsets if ngram is not None
                               and not ngram.stack_timesteps else None)

    # -- engine ---------------------------------------------------------------

    def _make_buffer(self):
        if self.shuffling_queue_capacity > 0:
            capacity = max(self.shuffling_queue_capacity, self.batch_size)
            # under deterministic='seed' an unseeded buffer derives its RNG
            # from the reader's seed root, as the loader's does; an explicit
            # seed wins
            return RandomShufflingBuffer(
                capacity=capacity + self.batch_size,
                min_after_retrieve=capacity // 2,
                seed=reader_buffer_seed(self.reader,
                                        "pytorch.shuffle_buffer",
                                        self._seed))
        return NoopShufflingBuffer()

    def _transform_batch(self, batch: Dict):
        return batch

    def _iter_impl(self):
        source = self.reader.iter_batches()
        for batch in iter_batched(source, self._make_buffer(), self.batch_size):
            yield self._emit(batch)

    def _emit(self, batch: ColumnBatch) -> Dict:
        out = {name: _column_to_torch(name, col)
               for name, col in batch.columns.items()}
        if self._ngram_offsets is not None:
            nested: Dict[int, Dict] = {off: {} for off in self._ngram_offsets}
            for key, value in out.items():
                off, _, field = key.partition(NGRAM_KEY_SEP)
                nested[int(off)][field] = value
            out = nested
        if self._collate_fn is not None:
            out = self._collate_fn(out)
        return self._transform_batch(out)

    # -- lifecycle ------------------------------------------------------------

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.reader.stop()
        self.reader.join()

    def __len__(self):
        raise TypeError("DataLoader length is not known up front")


class BatchedDataLoader(DataLoader):
    """DataLoader + whole-batch ``transform_fn`` (reference pytorch.py:257-367).

    The reference needed a separate class because its row DataLoader moved
    python objects one at a time; the columnar engine here is already batched,
    so this subclass only adds the transform hook (e.g. device placement:
    ``transform_fn=lambda b: {k: v.cuda() for k, v in b.items()}``).
    """

    def __init__(self, reader, batch_size: int = 1,
                 shuffling_queue_capacity: int = 0,
                 seed: Optional[int] = None,
                 transform_fn: Optional[Callable[[Dict], Dict]] = None):
        super().__init__(reader, batch_size=batch_size,
                         shuffling_queue_capacity=shuffling_queue_capacity,
                         seed=seed)
        self._transform_fn = transform_fn

    def _transform_batch(self, batch: Dict):
        if self._transform_fn is not None:
            return self._transform_fn(batch)
        return batch
