"""Exact-size batches from a Reader, delivered as torch tensors on a device.

Counterpart of ``petastorm_tpu/jax/loader.py:140 JaxDataLoader`` for one
CUDA device, with its two-stage producer:

* the assembly thread (``_assemble``, the counterpart of ``:757``) fetches
  the reader's rowgroups (through ``_TimedSource`` ``:80`` when straggler
  release is on), selects and pads the fields (``_prepare`` ``:699``), pumps
  them through a shuffling buffer (``shuffle.py``) into batches of exactly
  ``batch_size`` rows, cuts the short tail under ``drop_last``, and runs
  ``transform_fn`` and the valid mask (``_prep_cols`` ``:893``);
* the transfer thread (``_transfer``, ``:811``) writes each batch into a
  pinned host staging buffer, pads its rows to ``batch_size``, copies it to
  the device with ``non_blocking`` copies on a dedicated ``torch.cuda.Stream``,
  finishes device-decode fields there with kernel B2, and records the event
  the consumer waits on.

Both queues hold ``prefetch`` batches.  The consumer's current stream waits
on the copy's CUDA event, and the delivered tensors are marked with
``record_stream`` so the caching allocator keeps them alive for the
consumer's work.  The staging buffers are keyed by the batch's (field, row
shape, dtype) signature, because padding buckets and ``transform_fn`` may
change a column's shape or dtype from batch to batch; a buffer is written
again only after the event of its previous copy has completed: overwriting
pinned memory that a copy is still reading would corrupt a batch silently.

A field the reader decodes with ``decode_placement='device'`` arrives as
its coefficient planes (``native.image.pack_coef_columns``): they ride the
shuffling buffer together, are staged and copied like any column (the quant
tables widened to int32; padding rows get zero planes and quant tables of 1,
which decode to flat gray), and the decode is finished on the device by
kernel B2 (``ops.jpeg``) on the copy stream, before the copy's event is
recorded: the counterpart of ``petastorm_tpu/jax/loader.py:1411
_decode_on_device`` without the mesh.

With ``device="cpu"`` the same two threads deliver plain CPU tensors, with
no pinned memory and no streams, and the decode runs B2's plain version.
Stacked delivery, the device shuffle buffer, drain and checkpoint state,
``transfer_commit``, ``trace_dir``, telemetry and ``set_prefetch`` are not
part of this package yet.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import queue
import threading
import time
from typing import Callable, Deque, Dict, Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from petastorm_tpu_torch.batch import ColumnBatch
from petastorm_tpu_torch.device import resolve_device
from petastorm_tpu_torch.dtypes import torch_feed_dtype
from petastorm_tpu_torch.errors import CodecError, PetastormTpuError
from petastorm_tpu_torch.native.image import (COEF_COLUMN_SEP, JpegCoefLayout,
                                              _MIXED_GEOMETRY_GUIDANCE, coef_layout)
from petastorm_tpu_torch.ops.jpeg import decode_from_layout
from petastorm_tpu_torch.seeding import reader_buffer_seed
from petastorm_tpu_torch.shuffle import (NoopShufflingBuffer, RandomShufflingBuffer,
                                         iter_batched, iter_batched_multi)

logger = logging.getLogger(__name__)

_POLL_S = 0.05
#: straggler_release_s='auto' with a decorrelation floor
_DEFAULT_STRAGGLER_RELEASE_S = 2.0

#: key of the true row count on a zero-padded last batch (``drop_last=False``)
VALID_ROWS = "_valid_rows"


class _Done:
    pass


class _Error:
    def __init__(self, exc: BaseException):
        self.exc = exc


class _TimedSource:
    """Runs the prepared-batch generator on its own thread so that the
    assembly pump can poll it with a timeout (straggler release must notice
    "no rowgroup for T seconds" while the reader call is still blocked).

    ``get(timeout)`` returns the next batch, raises ``queue.Empty`` on
    timeout, ``StopIteration`` at the end of the stream, or re-raises the
    generator's failure.  The thread honours the loader's stop event.
    """

    _DONE = object()

    def __init__(self, gen, stop_event: threading.Event):
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._stop = stop_event
        self._thread = threading.Thread(target=self._run, args=(gen,), daemon=True,
                                        name="petastorm-torch-fetch")
        self._thread.start()

    def _run(self, gen) -> None:
        try:
            for item in gen:
                if self._stop.is_set():
                    return
                self._put(item)
            self._put(self._DONE)
        except BaseException as exc:  # noqa: BLE001 - forwarded to the pump
            self._put(_Error(exc))

    def _put(self, value) -> None:
        while not self._stop.is_set():
            try:
                self._q.put(value, timeout=_POLL_S)
                return
            except queue.Full:
                continue

    def get(self, timeout: Optional[float]):
        while True:
            try:
                value = self._q.get(timeout=timeout if timeout is not None else _POLL_S)
            except queue.Empty:
                if self._stop.is_set():
                    raise StopIteration from None
                if timeout is not None:
                    raise
                continue
            if value is self._DONE:
                raise StopIteration
            if isinstance(value, _Error):
                raise value.exc
            return value

    def join(self, timeout: float = 2.0) -> None:
        self._thread.join(timeout=timeout)


@dataclasses.dataclass
class _HostBatch:
    """One assembled batch, handed from the assembly to the transfer thread.
    Every column holds ``rows`` rows; the transfer stage pads them."""

    cols: Dict[str, np.ndarray]      # delivered as they are (after transform_fn, mask)
    coef: Dict[str, np.ndarray]      # device-decode fields' planes and quant tables
    layouts: Dict[str, JpegCoefLayout]
    host: Dict[str, np.ndarray]      # host_fields, delivered as numpy
    rows: int


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

    The arguments follow ``JaxDataLoader``'s (``jax/loader.py:193-216``):

    * ``fields``: the reader fields to deliver (default: all but
      ``host_fields``).  Integer columns torch lacks are widened (uint16 ->
      int32, uint32 -> int64); ``keep_wide_dtypes=False`` also narrows int64
      to int32 and float64 to float32, as the JAX package feeds them.
      Strings and objects are refused; a variable-shape field needs a
      ``pad_shapes`` entry.  A field the reader decodes on the device
      (``reader.device_decode_fields``) is delivered as uint8 (N, H, W, 3),
      or with the rank its schema declares for grayscale.
    * ``host_fields``: delivered as the batch's numpy column (strings and
      objects too), not padded.  Device-decode fields cannot be host fields.
    * ``shuffling_queue_capacity`` > 0 shuffles rows in a host buffer of that
      many rows, retrieving only above ``min_after_retrieve`` buffered rows
      (default: half the capacity) until the stream ends.  ``buffer_seed``
      seeds it; without one it derives from the reader's ``shuffle_seed``
      under ``deterministic='seed'``, as the JAX loader does.
    * ``straggler_release_s`` (default ``'auto'``: 2 s when the buffer has a
      floor, never under ``deterministic='seed'``): when no rowgroup arrives
      for this long while the buffer holds a full batch that only its floor
      withholds, the batch is released.  ``None`` disables.
    * ``pad_shapes``: field -> one target row shape, or a list of buckets
      (the smallest that fits each rowgroup is taken); rows are padded with
      ``pad_values`` (a number or field -> number) and clipped to the target.
    * ``transform_fn``: ``{field: np.ndarray} -> {field: np.ndarray}`` on each
      assembled batch before staging; device-decode fields bypass it.
    * ``drop_last=False`` zero-pads the last short batch to ``batch_size``
      rows (a device-decoded field's padding rows are flat gray, 128) and
      adds ``'_valid_rows'`` (an int) with its true row count.
      ``valid_mask_field`` adds a float32 tensor of that name on the device:
      1.0 for real rows, 0.0 for padding.
    * ``prefetch``: batches each stage holds ahead of the consumer (``None``:
      2).

    ``diagnostics()['consumer_wait_s']`` is the time ``__next__`` spent
    waiting for the producer: the input-bound share of a training loop;
    ``assemble_s`` and ``transfer_s`` are the seconds each producer thread
    spent working, not waiting on its queues or the reader.
    """

    def __init__(self, reader, batch_size: int, device="cuda",
                 fields: Optional[Sequence[str]] = None, drop_last: bool = True,
                 prefetch: Optional[int] = None,
                 host_fields: Sequence[str] = (),
                 shuffling_queue_capacity: int = 0,
                 min_after_retrieve: Optional[int] = None,
                 buffer_seed: Optional[int] = None,
                 pad_shapes: Optional[Dict[str, Sequence]] = None,
                 pad_values: Union[float, Dict[str, float]] = 0,
                 keep_wide_dtypes: bool = True,
                 transform_fn: Optional[Callable[[Dict[str, np.ndarray]],
                                                 Dict[str, np.ndarray]]] = None,
                 valid_mask_field: Optional[str] = None,
                 straggler_release_s: Union[None, float, str] = "auto"):
        if batch_size < 1:
            raise PetastormTpuError("batch_size must be >= 1")
        prefetch = 2 if prefetch is None else prefetch
        if prefetch < 1:
            raise PetastormTpuError("prefetch must be >= 1")
        self._reader = reader
        self._batch_size = batch_size
        self._device = resolve_device(device)
        self._cuda = self._device.type == "cuda"
        schema = reader.schema
        self._schema = schema
        self._host_fields = list(host_fields)
        self._fields = list(fields) if fields is not None else [
            name for name in schema.fields if name not in self._host_fields]
        unknown = [f for f in self._fields + self._host_fields if f not in schema]
        if unknown:
            raise PetastormTpuError(f"Unknown fields {unknown}; schema has"
                                    f" {list(schema.fields)}")
        device_decode = set(getattr(reader, "device_decode_fields", ()))
        host_device = [f for f in self._host_fields if f in device_decode]
        if host_device:
            raise PetastormTpuError(
                f"fields {host_device} use decode_placement='device' (the workers ship"
                " coefficient planes, not pixels) and cannot be delivered host-side; use"
                " decode_placement='host' or drop them from host_fields")
        if not self._fields:
            raise PetastormTpuError(
                "CudaDataLoader needs at least one device-deliverable field (all schema"
                " fields were excluded or routed to host_fields)")
        #: fields finished on the device from their coefficient planes
        self._decode_fields = [name for name in self._fields if name in device_decode]
        self._geometry: Dict[str, np.ndarray] = {}  # name -> the first rowgroup's layout meta
        self._pad_shapes = {name: _normalize_buckets(name, spec)
                            for name, spec in (pad_shapes or {}).items()}
        self._pad_values = pad_values
        for name in self._fields:
            if name in device_decode:
                continue
            field = schema[name]
            if field.dtype.kind in ("U", "S", "O", "M", "m"):
                raise PetastormTpuError(
                    f"Field {name!r} (dtype {field.dtype}) cannot be fed to a device."
                    " Exclude it with fields=, or keep it host-side via host_fields=.")
            if not field.is_fixed_shape and name not in self._pad_shapes:
                raise PetastormTpuError(
                    f"Field {name!r} has variable shape {field.shape}; a batch tensor"
                    " needs one row shape - give it a pad_shapes entry (pad-to-bucket)"
                    " or exclude it.")
        self._valid_mask = valid_mask_field
        if valid_mask_field is not None:
            if valid_mask_field in schema:
                raise PetastormTpuError(
                    f"valid_mask_field {valid_mask_field!r} collides with a schema field;"
                    " pick an unused name")
            if valid_mask_field == VALID_ROWS:
                raise PetastormTpuError(
                    f"valid_mask_field cannot be {VALID_ROWS!r}: that key is reserved for"
                    " the valid-row count")
        self._drop_last = drop_last
        self._keep_wide = keep_wide_dtypes
        self._transform_fn = transform_fn

        if straggler_release_s == "auto":
            self._straggler_s: Optional[float] = (
                _DEFAULT_STRAGGLER_RELEASE_S
                if shuffling_queue_capacity and (min_after_retrieve is None
                                                 or min_after_retrieve > 0)
                else None)
        else:
            self._straggler_s = float(straggler_release_s) if straggler_release_s else None
        if self._straggler_s is not None and getattr(reader, "deterministic", "off") == "seed":
            # a release fires on wall-clock time, so it would move rows across
            # batch boundaries between runs of a seed-stable reader
            logger.warning(
                "straggler_release_s is a timing-driven floor bypass and is disabled under"
                " deterministic='seed' delivery (it would move rows across batch boundaries"
                " between runs); pass deterministic='off' to the reader if straggler"
                " release matters more than bit-identical batches")
            self._straggler_s = None
        buffer_seed = reader_buffer_seed(reader, "loader.shuffle_buffer", buffer_seed)
        if shuffling_queue_capacity and shuffling_queue_capacity > 0:
            min_after = (min_after_retrieve if min_after_retrieve is not None
                         else shuffling_queue_capacity // 2)
            self._make_buffer = lambda: RandomShufflingBuffer(
                shuffling_queue_capacity, min_after, seed=buffer_seed)
            self._shuffling = True
        else:
            self._make_buffer = NoopShufflingBuffer
            self._shuffling = False

        self._prefetch = prefetch
        self._host_q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._out: "queue.Queue" = queue.Queue(maxsize=prefetch)
        #: staging slots of each (column, row shape, dtype) signature
        self._slots: Dict[tuple, Deque[_Slot]] = {}
        self._copy_stream = torch.cuda.Stream(self._device) if self._cuda else None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._assemble, daemon=True,
                                        name="petastorm-torch-assembly")
        self._transfer_thread = threading.Thread(target=self._transfer, daemon=True,
                                                 name="petastorm-torch-transfer")
        self._started = False
        self._finished = False
        self._failure: Optional[BaseException] = None
        self._sentinel_pending = False
        self._consumer_wait_s = 0.0
        self._delivered = 0
        self._straggler_releases = 0
        #: seconds of work of each producer stage (each written by one thread:
        #: the assembly thread, the fetch thread's _prepare, the transfer thread)
        self._assemble_s = 0.0
        self._fetch_prepare_s = 0.0
        self._transfer_s = 0.0

    # -- assembly stage ---------------------------------------------------

    def _check_geometry(self, name: str, meta: np.ndarray) -> None:
        """Every rowgroup of a device-decode field must have the first one's
        JPEG geometry: a batch is decoded in one launch of one geometry."""
        if not len(meta):
            return
        first = self._geometry.setdefault(name, meta[0].copy())
        if not (meta == first).all():
            raise CodecError(
                f"field {name!r}: jpeg geometry changes between rowgroups of this dataset:"
                f" {_MIXED_GEOMETRY_GUIDANCE}")

    def _prepare(self, batch: ColumnBatch) -> ColumnBatch:
        """Field selection and pad-to-bucket of one rowgroup; a device-decode
        field passes as its derived columns, its geometry checked."""
        cols: Dict[str, np.ndarray] = {}
        for name in self._fields + self._host_fields:
            if name in self._decode_fields:
                self._check_geometry(name, batch.columns[f"{name}{COEF_COLUMN_SEP}m"])
                for key, col in batch.columns.items():
                    if key.startswith(name + COEF_COLUMN_SEP):
                        cols[key] = col
                continue
            col = batch.columns[name]
            if name in self._pad_shapes:
                target = _pick_bucket(col, self._pad_shapes[name])
                col = _pad_to(col, target, self._pad_value_for(name), self._schema[name].dtype)
            cols[name] = col
        return ColumnBatch(cols, batch.num_rows)

    def _pad_value_for(self, name: str):
        if isinstance(self._pad_values, dict):
            return self._pad_values.get(name, 0)
        return self._pad_values

    def _on_straggler_release(self) -> None:
        self._straggler_releases += 1
        if self._straggler_releases == 1:
            logger.warning(
                "straggler release: emitted a buffered batch past the shuffle decorrelation"
                " floor (no rowgroup for %.1fs). Frequent releases mean the source is"
                " uniformly slower than straggler_release_s and the min_after_retrieve"
                " floor is being bypassed", self._straggler_s)

    def _prep_cols(self, batch: ColumnBatch) -> _HostBatch:
        """Per-batch host prep: the delivered columns through ``transform_fn``,
        the valid mask, and each device-decode field's planes and geometry."""
        cols = {n: batch.columns[n] for n in self._fields if n not in self._decode_fields}
        if self._transform_fn is not None:
            cols = {k: np.asarray(v) for k, v in self._transform_fn(cols).items()}
            if self._valid_mask is not None and self._valid_mask in cols:
                raise PetastormTpuError(
                    f"transform_fn produced a field named {self._valid_mask!r}, which"
                    " collides with valid_mask_field; rename one")
        if self._valid_mask is not None:
            cols[self._valid_mask] = np.ones(batch.num_rows, np.float32)
        coef, layouts = {}, {}
        for name in self._decode_fields:
            meta_name = f"{name}{COEF_COLUMN_SEP}m"
            layouts[name] = coef_layout(name, batch.columns[meta_name])
            for key, col in batch.columns.items():
                if key.startswith(name + COEF_COLUMN_SEP) and key != meta_name:
                    coef[key] = col
        host = {n: batch.columns[n] for n in self._host_fields}
        return _HostBatch(cols, coef, layouts, host, batch.num_rows)

    def _assemble(self) -> None:
        """Stage 1: reader rowgroups -> assembled host batches."""
        fetcher = None
        waited = [0.0]  # this thread's seconds blocked on the reader or the fetcher
        try:
            def prepared(on_fetch_thread: bool):
                batches = self._reader.iter_batches()
                while True:
                    t0 = time.perf_counter()
                    raw = next(batches, None)
                    t1 = time.perf_counter()
                    if raw is None or self._stop.is_set():
                        return
                    out = self._prepare(raw)
                    if on_fetch_thread:
                        self._fetch_prepare_s += time.perf_counter() - t1
                    else:
                        waited[0] += t1 - t0
                    yield out

            if self._straggler_s is not None:
                fetcher = _TimedSource(prepared(True), self._stop)

                def next_fn(timeout):
                    t0 = time.perf_counter()
                    try:
                        return fetcher.get(timeout)
                    finally:
                        waited[0] += time.perf_counter() - t0

                batches: Iterator[ColumnBatch] = iter_batched_multi(
                    next_fn, lambda _batch: (), self._make_buffer, self._batch_size,
                    straggler_release_s=self._straggler_s,
                    on_straggler_release=self._on_straggler_release)
            else:
                batches = iter_batched(prepared(False), self._make_buffer(), self._batch_size)
            t0, w0 = time.perf_counter(), waited[0]
            for out in batches:
                if self._stop.is_set():
                    break
                if out.num_rows < self._batch_size and self._drop_last:
                    continue  # the short tail is dropped
                item = self._prep_cols(out)
                self._assemble_s += time.perf_counter() - t0 - (waited[0] - w0)
                self._host_push(item)
                t0, w0 = time.perf_counter(), waited[0]
            self._host_push(_Done())
        except BaseException as exc:  # noqa: BLE001 - delivered to the consumer
            self._host_push(_Error(exc))
        finally:
            if fetcher is not None:
                fetcher.join()

    def _host_push(self, value) -> None:
        while not self._stop.is_set():
            try:
                self._host_q.put(value, timeout=_POLL_S)
                return
            except queue.Full:
                continue

    # -- transfer stage ---------------------------------------------------

    def _layout(self, item: _HostBatch) -> Dict[str, Tuple[tuple, np.dtype]]:
        """The staged columns of one batch: (row shape, feed dtype) each."""
        return {name: (col.shape[1:], torch_feed_dtype(col.dtype, self._keep_wide))
                for name, col in {**item.cols, **item.coef}.items()}

    def _fill(self, dest: Dict[str, torch.Tensor], item: _HostBatch) -> None:
        """Copy the batch's rows into ``dest`` (cast to the feed dtypes) and
        pad the rest: zeros, and 1 for quant tables, so that padded
        coefficient rows decode to flat gray."""
        rows = item.rows
        for name, col in {**item.cols, **item.coef}.items():
            out = dest[name].numpy()
            out[:rows] = col
            if rows < self._batch_size:
                is_qtab = name in item.coef and name.endswith(f"{COEF_COLUMN_SEP}q")
                out[rows:] = 1 if is_qtab else 0

    def _finish(self, staged: Dict[str, torch.Tensor],
                item: _HostBatch) -> Dict[str, torch.Tensor]:
        """The delivered batch: staged columns as they are, device-decode
        fields decoded from their planes (kernel B2 on a CUDA device)."""
        out = {name: staged[name] for name in item.cols}
        for name, layout in item.layouts.items():
            planes = [staged[f"{name}{COEF_COLUMN_SEP}p{c}"]
                      for c in range(len(layout.components))]
            image = decode_from_layout(planes, staged[f"{name}{COEF_COLUMN_SEP}q"], layout)
            if len(self._schema[name].shape) == 3 and image.dim() == 3:
                image = image[..., None]  # a declared (H, W, 1) grayscale shape
            out[name] = image
        return out

    def _slot(self, layout: Dict[str, Tuple[tuple, np.dtype]]) -> _Slot:
        """The next staging slot of this layout's ring (made at its first
        batch), once the last copy that read it has completed."""
        key = tuple((name, shape, dtype.str) for name, (shape, dtype) in layout.items())
        ring = self._slots.get(key)
        if ring is None:
            ring = self._slots[key] = collections.deque(
                _Slot(layout, self._batch_size, True) for _ in range(self._prefetch + 1))
        slot = ring[0]
        ring.rotate(-1)
        if slot.copied is not None:
            slot.copied.synchronize()  # its last copy has read the buffer
        return slot

    def _stage(self, item: _HostBatch):
        """Host batch -> (device batch, the event its copy and decode record)."""
        layout = self._layout(item)
        if self._cuda:
            slot = self._slot(layout)
            self._fill(slot.host, item)
            with torch.cuda.device(self._device), torch.cuda.stream(self._copy_stream):
                staged = {name: host.to(self._device, non_blocking=True)
                          for name, host in slot.host.items()}
                # the decode runs on the copy stream, after the copy and
                # before the event the consumer waits on
                batch = self._finish(staged, item)
                slot.copied = torch.cuda.Event()
                slot.copied.record(self._copy_stream)
            copied = slot.copied
        else:
            staged = {name: torch.empty((self._batch_size,) + shape, dtype=_torch_dtype(dt))
                      for name, (shape, dt) in layout.items()}
            self._fill(staged, item)
            batch, copied = self._finish(staged, item), None
        batch.update(item.host)
        if item.rows < self._batch_size:
            batch[VALID_ROWS] = item.rows
        return batch, copied

    def _transfer(self) -> None:
        """Stage 2: host batches -> staged, copied (and decoded) batches."""
        try:
            while not self._stop.is_set():
                try:
                    item = self._host_q.get(timeout=_POLL_S)
                except queue.Empty:
                    continue
                if isinstance(item, _Error):
                    self._push(item)
                    self._sentinel_pending = True
                    self._abort_upstream()
                    return
                if isinstance(item, _Done):
                    break
                t0 = time.perf_counter()
                value = self._stage(item)
                self._transfer_s += time.perf_counter() - t0
                self._push(value)
            else:
                return  # stopped
            self._push(_Done())
            self._sentinel_pending = True
        except BaseException as exc:  # noqa: BLE001 - delivered to the consumer
            self._push(_Error(exc))
            self._sentinel_pending = True
            self._abort_upstream()

    def _abort_upstream(self) -> None:
        """A producer stage failed: stop the other stage and the reader (the
        error is already queued for the consumer, which drains the queue
        before it reads the stop)."""
        self._stop.set()
        try:
            self._reader.stop()
        except Exception:  # noqa: BLE001 - teardown is best-effort
            logger.debug("reader stop during abort failed", exc_info=True)

    def _push(self, value) -> None:
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
            self._transfer_thread.start()
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        if self._failure is not None:
            raise self._failure
        if self._finished:
            raise StopIteration
        iter(self)
        t0 = time.perf_counter()
        while True:
            try:
                value = self._out.get(timeout=_POLL_S)
                break
            except queue.Empty:
                if self._stop.is_set():
                    self._finished = True
                    raise StopIteration from None
                if not self._transfer_thread.is_alive():
                    try:  # the sentinel may have landed after the timeout
                        value = self._out.get_nowait()
                        break
                    except queue.Empty:
                        self._failure = PetastormTpuError(
                            "Loader transfer thread died silently")
                        raise self._failure from None
        self._consumer_wait_s += time.perf_counter() - t0
        if isinstance(value, _Done):
            self._finished = True
            self._sentinel_pending = False
            raise StopIteration
        if isinstance(value, _Error):
            self._failure = value.exc
            self._sentinel_pending = False
            raise value.exc
        batch, copied = value
        if copied is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(copied)
            for tensor in batch.values():
                if isinstance(tensor, torch.Tensor):
                    tensor.record_stream(stream)
        self._delivered += 1
        return batch

    def diagnostics(self) -> Dict[str, float]:
        """Queue depths, delivery counts and the seconds of each stage."""
        depth = self._out.qsize()
        if self._sentinel_pending:  # the end-of-stream marker is not a batch
            depth = max(depth - 1, 0)
        return {"consumer_wait_s": self._consumer_wait_s,
                "batches_delivered": self._delivered,
                "prefetch_depth": depth,
                "prefetch_capacity": self._out.maxsize,
                "host_queue_depth": self._host_q.qsize(),
                "straggler_releases": self._straggler_releases,
                "assemble_s": self._assemble_s + self._fetch_prepare_s,
                "transfer_s": self._transfer_s}

    def stop(self) -> None:
        """Stop both producer threads and the reader, and wait for them."""
        self._stop.set()
        self._reader.stop()
        if self._started:
            for thread in (self._thread, self._transfer_thread):
                thread.join(timeout=10.0)
                if thread.is_alive():
                    logger.warning("loader thread %s did not stop within 10 s", thread.name)
        self._reader.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


def _normalize_buckets(name: str, spec) -> list:
    """A ``pad_shapes`` entry -> a non-empty list of bucket tuples of one
    rank, sorted by size (``petastorm_tpu/jax/loader.py:1975``)."""
    buckets = [tuple(spec)] if spec and not isinstance(spec[0], (list, tuple)) \
        else [tuple(b) for b in spec]
    if not buckets:
        raise PetastormTpuError(f"pad_shapes[{name!r}] is empty")
    ranks = {len(b) for b in buckets}
    if len(ranks) != 1:
        raise PetastormTpuError(
            f"pad_shapes[{name!r}] buckets must share one rank, got {buckets}")
    return sorted(buckets, key=lambda b: (int(np.prod(b)), b))


def _pick_bucket(col: np.ndarray, buckets: list) -> Tuple[int, ...]:
    """The smallest bucket that fits every row of this column, else the
    largest (rows are then clipped) (``jax/loader.py:1989``)."""
    if len(buckets) == 1:
        return buckets[0]
    if col.dtype != object:
        need = col.shape[1:]
    else:
        shapes = np.array([np.asarray(r).shape for r in col])
        need = tuple(shapes.max(axis=0)) if len(shapes) else buckets[0]
    for b in buckets:
        if len(b) == len(need) and all(t >= n for t, n in zip(b, need)):
            return b
    return buckets[-1]


def _pad_to(col: np.ndarray, target: Tuple[int, ...], pad_value, dtype) -> np.ndarray:
    """Pad or clip each row to ``target`` (``jax/loader.py:2005``)."""
    n = len(col)
    target = tuple(target)
    if col.dtype != object:
        if col.shape[1:] == target:
            return col
        if col.ndim - 1 != len(target):
            raise PetastormTpuError(
                f"pad_shapes rank mismatch: rows have shape {col.shape[1:]}, target {target}")
        out = np.full((n,) + target, pad_value, dtype=dtype)
        clipped = tuple(slice(0, min(a, b)) for a, b in zip(col.shape[1:], target))
        out[(slice(None),) + clipped] = col[(slice(None),) + clipped]
        return out
    out = np.full((n,) + target, pad_value, dtype=dtype)
    for i in range(n):
        row = np.asarray(col[i])
        if row.ndim != len(target):
            raise PetastormTpuError(
                f"pad_shapes rank mismatch: row has shape {row.shape}, target {target}")
        clipped = tuple(slice(0, min(a, b)) for a, b in zip(row.shape, target))
        out[(i,) + clipped] = row[clipped]
    return out
