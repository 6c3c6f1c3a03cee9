"""Exact-size batches from a Reader, delivered as torch tensors on a device.

Counterpart of ``petastorm_tpu/jax/loader.py:140 JaxDataLoader`` (batch
assembly ``_assemble`` ``:757``, transfer ``:811``, ``_emit`` ``:923``) for
one CUDA device.  A producer thread assembles batches of exactly
``batch_size`` rows across rowgroup boundaries, writes each straight into a
pinned host staging buffer, and copies it to the device with ``non_blocking``
copies on a dedicated ``torch.cuda.Stream``.  The consumer's current stream
waits on the copy's CUDA event, and the delivered tensors are marked with
``record_stream`` so the caching allocator keeps them alive for the
consumer's work.  A staging buffer is written again only after the event of
its previous copy has completed: overwriting pinned memory that a copy is
still reading would corrupt a batch silently.

A field the reader decodes with ``decode_placement='device'`` arrives as
its coefficient planes (``native.image.pack_coef_columns``): they are staged
and copied like any column (the quant tables widened to int32), and the
decode is finished on the device by kernel B2 (``ops.jpeg``) on the copy
stream, before the copy's event is recorded; the counterpart of
``petastorm_tpu/jax/loader.py:1411 _decode_on_device`` without the mesh.

With ``device="cpu"`` the same batches are delivered as plain CPU tensors,
with no pinned memory and no streams, and the decode runs B2's plain
version.  Host shuffling buffers, padding buckets, transforms, stacked
delivery, drain and checkpoint state are not part of this package yet.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from petastorm_tpu_torch.batch import ColumnBatch
from petastorm_tpu_torch.device import resolve_device
from petastorm_tpu_torch.dtypes import torch_feed_dtype
from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.native.image import COEF_COLUMN_SEP, JpegCoefLayout, coef_layout
from petastorm_tpu_torch.ops.jpeg import decode_from_layout

_POLL_S = 0.05

#: key of the true row count on a zero-padded last batch (``drop_last=False``)
VALID_ROWS = "_valid_rows"


class _Done:
    pass


class _Error:
    def __init__(self, exc: BaseException):
        self.exc = exc


def iter_assembled(source: Iterator[ColumnBatch], batch_size: int
                   ) -> Iterator[List[Tuple[ColumnBatch, int, int]]]:
    """Group a stream of ColumnBatches into pieces ``(batch, start, stop)``
    totalling exactly ``batch_size`` rows; the last group may be shorter."""
    pieces: List[Tuple[ColumnBatch, int, int]] = []
    have = 0
    for batch in source:
        start = 0
        while start < batch.num_rows:
            take = min(batch_size - have, batch.num_rows - start)
            pieces.append((batch, start, start + take))
            have += take
            start += take
            if have == batch_size:
                yield pieces
                pieces, have = [], 0
    if pieces:
        yield pieces


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


class _Slot:
    """One set of host staging buffers (pinned for CUDA) and the event of the
    last device copy that read them."""

    def __init__(self, layout: Dict[str, Tuple[tuple, np.dtype]], batch_size: int,
                 pin: bool):
        self.host = {name: torch.empty((batch_size,) + shape, dtype=_torch_dtype(dtype),
                                       pin_memory=pin)
                     for name, (shape, dtype) in layout.items()}
        self.copied: Optional[torch.cuda.Event] = None


class CudaDataLoader:
    """Iterate ``{field: tensor}`` batches of ``batch_size`` rows on ``device``.

    ``fields``: the reader fields to deliver (default: all).  Integer columns
    torch lacks are widened (uint16 -> int32, uint32 -> int64); strings and
    variable-shape fields are refused.  A field the reader decodes on the
    device (``reader.device_decode_fields``) is delivered as uint8
    (N, H, W, 3), or with the rank its schema declares for grayscale.
    ``drop_last=False`` zero-pads the last short batch to ``batch_size`` rows
    (a device-decoded field's padding rows are flat gray, 128) and adds
    ``'_valid_rows'`` (an int) with its true row count.  ``prefetch``:
    batches in flight ahead of the consumer.  ``diagnostics()['consumer_wait_s']`` is the time
    ``__next__`` spent waiting for the producer: the input-bound share of a
    training loop.
    """

    def __init__(self, reader, batch_size: int, device="cuda",
                 fields: Optional[Sequence[str]] = None, drop_last: bool = True,
                 prefetch: int = 2):
        if batch_size < 1:
            raise PetastormTpuError("batch_size must be >= 1")
        if prefetch < 1:
            raise PetastormTpuError("prefetch must be >= 1")
        self._reader = reader
        self._batch_size = batch_size
        self._device = resolve_device(device)
        self._cuda = self._device.type == "cuda"
        self._fields = list(fields) if fields is not None else list(reader.schema.fields)
        device_decode = set(getattr(reader, "device_decode_fields", ()))
        #: fields finished on the device; their staged columns are the derived
        #: plane and quant-table columns, sized from the first batch
        self._decode_fields = [name for name in self._fields if name in device_decode]
        self._geometry: Dict[str, np.ndarray] = {}  # name -> the first batch's layout meta row
        #: staged columns: (per-row shape, dtype)
        self._layout: Dict[str, Tuple[tuple, np.dtype]] = {}
        for name in self._fields:
            if name in device_decode:
                continue
            field = reader.schema[name]
            if not field.is_fixed_shape:
                raise PetastormTpuError(
                    f"field {name!r} has a variable shape {field.shape}; it cannot be"
                    " stacked into a batch tensor")
            self._layout[name] = (field.shape, torch_feed_dtype(field.dtype))
        self._drop_last = drop_last
        self._out: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._prefetch = prefetch
        self._slots: List[_Slot] = []  # made at the first batch
        self._copy_stream = torch.cuda.Stream(self._device) if self._cuda else None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, daemon=True,
                                        name="petastorm-torch-loader")
        self._started = False
        self._finished = False
        self._consumer_wait_s = 0.0
        self._delivered = 0

    # -- producer ---------------------------------------------------------

    def _coef_layouts(self, pieces) -> Dict[str, JpegCoefLayout]:
        """Each device-decode field's geometry in this batch, which must be
        the first batch's (the staging slots are sized from it); at the first
        batch its derived columns join the staged layout."""
        layouts = {}
        for name in self._decode_fields:
            meta_name = f"{name}{COEF_COLUMN_SEP}m"
            if name not in self._geometry:
                batch = pieces[0][0]
                self._geometry[name] = batch.columns[meta_name][:1].copy()
                for col, values in batch.columns.items():
                    if col.startswith(name + COEF_COLUMN_SEP) and col != meta_name:
                        self._layout[col] = (values.shape[1:], torch_feed_dtype(values.dtype))
            layouts[name] = coef_layout(name, np.concatenate(
                [self._geometry[name]] + [b.columns[meta_name][s:e] for b, s, e in pieces]))
        return layouts

    def _fill(self, dest: Dict[str, torch.Tensor], pieces) -> int:
        """Copy the pieces' rows into ``dest`` and pad the rest (zeros; quant
        tables with 1, so padded coefficient rows decode to flat gray);
        returns the row count."""
        rows = 0
        for batch, start, stop in pieces:
            for name in self._layout:
                dest[name].numpy()[rows:rows + stop - start] = batch.columns[name][start:stop]
            rows += stop - start
        if rows < self._batch_size:
            qtabs = {f"{name}{COEF_COLUMN_SEP}q" for name in self._decode_fields}
            for name in self._layout:
                dest[name].numpy()[rows:] = 1 if name in qtabs else 0
        return rows

    def _finish(self, staged: Dict[str, torch.Tensor],
                layouts: Dict[str, JpegCoefLayout]) -> Dict[str, torch.Tensor]:
        """The delivered batch: staged columns as they are, device-decode
        fields decoded from their planes (kernel B2 on a CUDA device)."""
        out = {}
        for name in self._fields:
            layout = layouts.get(name)
            if layout is None:
                out[name] = staged[name]
                continue
            planes = [staged[f"{name}{COEF_COLUMN_SEP}p{c}"]
                      for c in range(len(layout.components))]
            image = decode_from_layout(planes, staged[f"{name}{COEF_COLUMN_SEP}q"], layout)
            if len(self._reader.schema[name].shape) == 3 and image.dim() == 3:
                image = image[..., None]  # a declared (H, W, 1) grayscale shape
            out[name] = image
        return out

    def _produce(self) -> None:
        try:
            slot_index = 0
            for pieces in iter_assembled(self._reader.iter_batches(), self._batch_size):
                if self._stop.is_set():
                    return
                rows = sum(stop - start for _, start, stop in pieces)
                if rows < self._batch_size and self._drop_last:
                    break
                layouts = self._coef_layouts(pieces)
                if self._cuda:
                    if not self._slots:
                        self._slots = [_Slot(self._layout, self._batch_size, True)
                                       for _ in range(self._prefetch + 1)]
                    slot = self._slots[slot_index]
                    slot_index = (slot_index + 1) % len(self._slots)
                    if slot.copied is not None:
                        slot.copied.synchronize()  # its last copy has read the buffer
                    self._fill(slot.host, pieces)
                    with torch.cuda.stream(self._copy_stream):
                        staged = {name: host.to(self._device, non_blocking=True)
                                  for name, host in slot.host.items()}
                        # the decode runs on the copy stream, after the copy
                        # and before the event the consumer waits on
                        batch = self._finish(staged, layouts)
                        slot.copied = torch.cuda.Event()
                        slot.copied.record(self._copy_stream)
                    item = (batch, slot.copied)
                else:
                    staged = {name: torch.empty((self._batch_size,) + shape,
                                                dtype=_torch_dtype(dt))
                              for name, (shape, dt) in self._layout.items()}
                    self._fill(staged, pieces)
                    item = (self._finish(staged, layouts), None)
                if rows < self._batch_size:
                    item[0][VALID_ROWS] = rows
                self._put(item)
            self._put(_Done())
        except BaseException as exc:  # noqa: BLE001 - delivered to the consumer
            self._put(_Error(exc))

    def _put(self, value) -> None:
        while not self._stop.is_set():
            try:
                self._out.put(value, timeout=_POLL_S)
                return
            except queue.Full:
                continue

    # -- consumer ---------------------------------------------------------

    def __iter__(self):
        if not self._started:
            self._started = True
            self._thread.start()
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        if self._finished:
            raise StopIteration
        iter(self)
        t0 = time.perf_counter()
        while True:
            try:
                value = self._out.get(timeout=_POLL_S)
                break
            except queue.Empty:
                if self._stop.is_set() or not self._thread.is_alive() and self._out.empty():
                    self._finished = True
                    raise StopIteration from None
        self._consumer_wait_s += time.perf_counter() - t0
        if isinstance(value, _Done):
            self._finished = True
            raise StopIteration
        if isinstance(value, _Error):
            self._finished = True
            raise value.exc
        batch, copied = value
        if copied is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(copied)
            for name in self._fields:
                batch[name].record_stream(stream)
        self._delivered += 1
        return batch

    def diagnostics(self) -> Dict[str, float]:
        return {"consumer_wait_s": self._consumer_wait_s,
                "batches_delivered": self._delivered}

    def stop(self) -> None:
        """Stop the producer and the reader, and wait for their threads."""
        self._stop.set()
        self._reader.stop()
        if self._started:
            self._thread.join(timeout=10.0)
        self._reader.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
