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
  the consumer waits on.  With ``stack_batches=K`` it groups K consecutive
  batches into one ``(K, batch_size, ...)`` unit first (``:986
  _emit_stack``): one staging buffer and one copy per field, and one B2
  launch over the K batches' images.  With ``device_shuffle_capacity`` the
  full batches then pass through the device shuffle buffer
  (``device_buffer.py``), on the copy stream and before the event.

Both queues hold ``prefetch`` batches (units, when stacked).  The consumer's
current stream waits on the copy's CUDA event, and the delivered tensors are
marked with ``record_stream`` so the caching allocator keeps them alive for
the consumer's work.  The staging buffers are keyed by the batch's (field,
row shape, dtype) signature, because padding buckets and ``transform_fn``
may change a column's shape or dtype from batch to batch; a buffer is written
again only after the event of its previous copy has completed: overwriting
pinned memory that a copy is still reading would corrupt a batch silently.

A field the reader decodes with ``decode_placement='device'`` arrives as
its coefficient planes (``native.image.pack_coef_columns``): they ride the
shuffling buffer together, are staged and copied like any column (the quant
tables widened to int32; padding rows get zero planes and quant tables of 1,
which decode to flat gray), and the decode is finished on the device by
kernel B2 (``ops.jpeg``) on the copy stream, before the copy's event is
recorded: the counterpart of ``petastorm_tpu/jax/loader.py:1411
_decode_on_device`` (and ``:1145 _decode_stack``) without the mesh.

A field read with ``decode_placement='device-mixed'`` arrives as one object
cell a row (``native.image.pack_coef_columns_mixed``), any JPEG geometry.
The transfer stage groups a unit's cells by geometry, packs each bucket's
planes, quant tables and row indices back to back into one grow-only pinned
byte arena of the staging slot, copies the arena in one ``non_blocking``
copy, and on the copy stream runs B2 once a bucket on views of it, writing
each bucket's images into their rows of a zeroed ``(rows, *target)``
tensor: cropped or zero-padded to the target, grayscale repeated to its
channels (``jax/loader.py:1199-1361``, without the power-of-two bucket
padding that bounds XLA's compiles: each bucket decodes at its exact size).

``drain()`` and ``state_dict()`` (``:1617``, ``:1816``) give the training
job its data cursor: drain quiesces the reader and yields what is in flight,
after which the reader's cursor is exact.

The fields delivered are those of the reader's ``output_schema`` (its
``schema``, or an ngram reader's window columns: ``'<offset>/<field>'``
keys, and a stacked field's ``(k, ...)`` rows, staged like any column).

With ``device="cpu"`` the same two threads deliver plain CPU tensors, with
no pinned memory and no streams, and the decode runs B2's plain version.

With a ``mesh`` (one process per card, ``jax/loader.py:196-197``) the
loader delivers this rank's block of each global batch as an ordinary
tensor on its card: the rows of its batch-axis block and, for a field
sharded on a second axis, its range of that axis (``_placement_for``,
``:1461-1486``).

A reader with a ``decode_placement='auto'`` field (the live host/device
split) hands over rowgroups in either form: the decoded pixels under the
field's name, or its coefficient planes.  The assembly keeps the two forms
in separate shuffling buffers (``shuffle.iter_batched_multi``), so no batch
mixes them (``jax/loader.py:703-733``); a device-form batch runs B2 on the
copy stream exactly as a ``'device'`` field's does, a host-form batch stages
its pixels like any column.  ``last_decode_form`` names the form of the
unit ``__next__`` returned last.

Telemetry (``jax/loader.py:217-236``, ``:1499-1583``): the loader records
into the reader's recorder by default - the ``host-assemble`` (a rowgroup's
selection and padding), ``host-prep`` (a batch's transform and mask) and
``device-transfer`` (staging, copy and device decode) stages,
``loader.consumer_wait_s``, ``loader.batches_delivered``,
``loader.straggler_releases`` and the ``loader.host_queue_depth`` and
``loader.prefetch_depth`` gauges.  ``prefetch`` and :meth:`set_prefetch`
move both stage queues' bound while the loader runs (autotune's third knob:
a loader over an autotuned reader attaches itself).  ``transfer_commit``
says whether the transfer thread waits on each unit's copy event before it
takes the next (``True``, ``False``, or ``'auto'``, which times that wait
once on an idle stream and turns it off when it costs more than 20 ms, as
the JAX loader probes its readiness sync; a commit that costs far more than
its bytes explain twice in a row turns it off too).  ``trace_dir`` brackets
the loader's life in a ``torch.profiler`` trace with CUDA activity, written
there as a Chrome trace at the end, where the JAX loader calls
``jax.profiler.start_trace``.

A reader on the process pool (``reader_pool_type='process'``) hands over
batches whose columns are views of its shared-memory arena.  The loader
copies them into its staging (the host shuffle buffer copies rows into its
own store, and host fields are copied out) and then drops them, so each
arena block goes back as soon as its batch is staged and no view of the
arena reaches the consumer.  ``diagnostics()`` then carries the pool's
``shm_batches``, ``pickled_batches`` and ``shm_high_water_bytes`` (and all
of ``Reader.transport_stats()`` under ``transport``).
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import os
import queue
import threading
import time
from typing import Callable, Deque, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from petastorm_tpu_torch.batch import ColumnBatch
from petastorm_tpu_torch.cuda.device_buffer import DeviceShufflingBuffer
from petastorm_tpu_torch.device import resolve_device
from petastorm_tpu_torch.dtypes import torch_feed_dtype
from petastorm_tpu_torch.errors import CodecError, PetastormTpuError
from petastorm_tpu_torch.native.image import (COEF_COLUMN_SEP, MIXED_CELL_SUFFIX, JpegCoefLayout,
                                              _MIXED_GEOMETRY_GUIDANCE, _layout_from_meta,
                                              coef_layout)
from petastorm_tpu_torch.ops.jpeg import decode_from_layout
from petastorm_tpu_torch.parallel.mesh import (Placements, group_device, mesh_coordinate,
                                               mesh_dim_names, mesh_group, shard_slices,
                                               sharding_for_batch)
from petastorm_tpu_torch.seeding import reader_buffer_seed
from petastorm_tpu_torch.native.transport import is_arena_backed
from petastorm_tpu_torch.shuffle import (NoopShufflingBuffer, RandomShufflingBuffer,
                                         iter_batched, iter_batched_multi)
from petastorm_tpu_torch.telemetry import NULL_CONTEXT
from petastorm_tpu_torch.telemetry import resolve as _resolve_telemetry

logger = logging.getLogger(__name__)

_POLL_S = 0.05
#: straggler_release_s='auto' with a decorrelation floor
_DEFAULT_STRAGGLER_RELEASE_S = 2.0
#: seconds ``join()`` waits for each producer thread before abandoning it
_JOIN_TIMEOUT_S = 10.0

#: key of the true row count on a zero-padded last batch (``drop_last=False``)
VALID_ROWS = "_valid_rows"
#: transfer_commit='auto' turns the commit off when an idle event wait costs
#: more than this (``jax/loader.py:1129``'s probe threshold)
_COMMIT_PROBE_THRESHOLD_S = 0.02


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
    mixed: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)  # object cells


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


class _Slot:
    """One set of host staging buffers (pinned for CUDA), the byte arenas of
    the mixed-geometry fields, and the event of the last device copy that
    read them."""

    def __init__(self, layout: Dict[str, Tuple[tuple, np.dtype]], lead: tuple, pin: bool):
        self.host = {name: torch.empty(lead + shape, dtype=_torch_dtype(dtype),
                                       pin_memory=pin)
                     for name, (shape, dtype) in layout.items()}
        self.pin = pin
        self.arenas: Dict[str, torch.Tensor] = {}
        self.copied: Optional[torch.cuda.Event] = None

    def arena(self, name: str, nbytes: int) -> torch.Tensor:
        """The first ``nbytes`` of the field's arena, grown (an eighth over)
        when it is too small: a unit's bucket sizes change from unit to unit,
        so one arena a slot serves them all without a new pinned buffer
        each unit."""
        buf = self.arenas.get(name)
        if buf is None or buf.numel() < nbytes:
            buf = self.arenas[name] = torch.empty(nbytes + nbytes // 8, dtype=torch.uint8,
                                                  pin_memory=self.pin)
        return buf[:nbytes]


_ARENA_ALIGN = 16  # B2 copies planes and quant tables in 16-byte units


@dataclasses.dataclass
class _Bucket:
    """One geometry bucket of a unit's mixed-geometry cells: its layout and
    the byte offsets in the staging arena of its planes (int16 (k, bh, bw,
    64) each), quant tables (int32 (k, ncomp, 64)) and rows (int64 (k,),
    the flat row of each cell in the unit)."""

    layout: JpegCoefLayout
    cells: List[int]
    planes: List[Tuple[int, tuple]]
    qtabs: Tuple[int, tuple]
    rows: Tuple[int, tuple]


def _arena_view(arena: torch.Tensor, spec: Tuple[int, tuple], dtype: torch.dtype) -> torch.Tensor:
    offset, shape = spec
    nbytes = int(np.prod(shape)) * torch.empty(0, dtype=dtype).element_size()
    return arena[offset:offset + nbytes].view(dtype).view(shape)


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
      or with the rank its schema declares for grayscale.  A
      ``'device-mixed'`` field (``reader.device_decode_mixed``) is delivered
      as uint8 ``(N, *target)``: the schema's fixed shape, else its one
      ``pad_shapes`` target (refused otherwise, with ``"ONE pad_shapes
      target"``); each image is cropped or zero-padded to it, a grayscale one
      repeated to its channels, and padding rows are zero.
      ``diagnostics()`` adds ``mixed_decode_geometries`` (distinct geometries
      decoded a field), ``mixed_buckets`` (B2 launches so far) and
      ``mixed_decode_s`` (host seconds grouping, packing and launching); a
      geometry missing from ``reader.declared_geometries`` is warned about
      once.
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
    * ``stack_batches=K`` (``jax/loader.py:157-167``): each delivered unit
      stacks K consecutive batches as ``(K, batch_size, ...)`` tensors,
      shipped in one pinned staging copy per field, for a consumer that runs
      K training steps per launch (the trainer's ``scan_steps``: a CUDA
      graph of K steps).  ``transform_fn`` runs per batch, before stacking.
      A device-decode field's K batches decode in one B2 launch over
      ``K * batch_size`` images.  ``drop_last=True`` also drops a final
      short stack; with ``drop_last=False`` the missing steps and rows are
      zero-padded, ``'_valid_rows'`` becomes an int64 ``(K,)`` tensor (on
      the host) and the valid mask is ``(K, batch_size)``;
      ``drain()`` and ``state_dict()`` count whole stacks.  Host fields
      stack to ``(K, batch_size, ...)`` numpy arrays (missing rows: zeros,
      or None for objects).  Multi-bucket ``pad_shapes`` are refused (the K
      batches could take different buckets), and so is the device shuffle
      buffer, which holds single batches.
    * ``device_shuffle_capacity`` > 0 (``jax/loader.py:211-212``) shuffles
      whole batches on the device as well: an exchange buffer of that many
      batches (``device_buffer.DeviceShufflingBuffer``) on the copy stream,
      after the staging copy and B2 and before the event ``__next__`` waits
      on, so its store never leaves the card.  ``device_shuffle_seed`` seeds
      it; without one it derives from the reader's ``shuffle_seed`` under
      ``deterministic='seed'``.  At the stream's end the resident batches
      drain (shuffled), then the zero-padded tail (``'_valid_rows'``), which
      skips the buffer, then the end.  Refused with ``stack_batches``,
      ``host_fields`` and multi-bucket ``pad_shapes``, as the JAX loader
      refuses them.

    * ``mesh`` and ``shardings`` (``jax/loader.py:143-144``, ``:196-197``): a
      ``torch.distributed.device_mesh.DeviceMesh`` with named dimensions,
      and for each field one ``torch.distributed.tensor`` placement per mesh
      dimension (a dict of field -> placements, or one tuple for every
      field; a field without an entry gets ``Shard(0)`` on the mesh's first
      dimension, JAX's ``P(mesh.axis_names[0])``).  ``batch_size`` is then
      the GLOBAL batch: this rank stages and delivers only its block of it
      (``parallel.mesh.local_data_slice``), as an ordinary tensor.  The
      reader must deliver this rank's rows (shard it by the rank's block of
      the batch axis: ``make_cuda_loader`` does).  JAX's ``P("data",
      "seq")`` on a ``(B, S)`` field is ``(Shard(0), Shard(1))`` on a
      ``("data", "seq")`` mesh: each rank keeps its rows' range of the
      sequence.  Every field must shard the batch axis alike; a device-decode
      field may shard only the batch axis.  ``stack_batches=K`` prepends an
      unsharded axis (``:1467``); the valid mask and ``'_valid_rows'``
      count this rank's rows.

    * ``telemetry``: the recorder (default: the reader's), ``trace_dir``: a
      ``torch.profiler`` Chrome trace of the loader's life, and
      ``transfer_commit``: ``True``, ``False`` or ``'auto'`` (module
      docstring).  A live-split field (``decode_placement='auto'``) cannot be
      stacked (``stack_batches > 1``), as in the JAX loader.

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
                 straggler_release_s: Union[None, float, str] = "auto",
                 stack_batches: int = 1,
                 device_shuffle_capacity: int = 0,
                 device_shuffle_seed: Optional[int] = None,
                 mesh=None,
                 shardings: Union[None, Placements, Dict[str, Placements]] = None,
                 trace_dir: Optional[str] = None,
                 transfer_commit: Union[bool, str] = "auto",
                 telemetry=None):
        if batch_size < 1:
            raise PetastormTpuError("batch_size must be >= 1")
        if not any(transfer_commit is v for v in (True, False, "auto")):
            raise PetastormTpuError(
                f"transfer_commit must be True, False or 'auto'; got {transfer_commit!r}")
        if stack_batches < 1:
            raise PetastormTpuError("stack_batches must be >= 1")
        self._stack = int(stack_batches)
        prefetch = 2 if prefetch is None else prefetch
        if prefetch < 1:
            raise PetastormTpuError("prefetch must be >= 1")
        self._reader = reader
        self._global_batch = batch_size
        self._mesh = mesh
        self._specs = shardings
        #: (field, trailing shape) -> the slice of the trailing dims this rank keeps
        self._placement_cache: Dict[tuple, Tuple[slice, ...]] = {}
        self._device = resolve_device(device)
        self._cuda = self._device.type == "cuda"
        # the columns iter_batches yields: an ngram reader's window columns
        # (``jax/loader.py:333-335``)
        schema = getattr(reader, "output_schema", None) or reader.schema
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
        #: the subset in the mixed-geometry object format, decoded a geometry
        #: bucket at a time and fitted to a static target each
        self._mixed_fields = frozenset(getattr(reader, "device_decode_mixed", ()) or ()
                                       ).intersection(self._decode_fields)
        #: the subset under the live split: a rowgroup carries its pixels
        #: (host form) or its planes (device form)
        self._split_fields = frozenset(getattr(reader, "device_decode_split", ()) or ()
                                       ).intersection(self._decode_fields)
        if self._stack > 1 and self._split_fields:
            raise PetastormTpuError(
                f"stack_batches={self._stack} cannot be combined with the"
                f" live decode split (decode_placement='auto' fields"
                f" {sorted(self._split_fields)}): the K stacked batches could"
                " straddle a split flip and mix wire forms. Pin the split"
                " with decode_placement='host'/'device' for scan-feed"
                " delivery.")
        #: geometries decoded a mixed field (layout-meta bytes), the (field, h,
        #: w, channels) already warned about, and the dataset's stamped contract
        self._mixed_geometries: Dict[str, set] = {}
        self._geom_warned: set = set()
        self._declared_geometries = dict(getattr(reader, "declared_geometries", None) or {})
        self._mixed_buckets = 0
        self._mixed_decode_s = 0.0
        self._geometry: Dict[str, np.ndarray] = {}  # name -> the first rowgroup's layout meta
        self._pad_shapes = {name: _normalize_buckets(name, spec)
                            for name, spec in (pad_shapes or {}).items()}
        self._pad_values = pad_values
        self._mixed_targets = {name: self._mixed_target(name) for name in self._mixed_fields}
        if self._stack > 1:
            bucketed = [n for n, b in self._pad_shapes.items() if len(b) > 1]
            if bucketed:
                raise PetastormTpuError(
                    f"stack_batches={self._stack} needs one static shape per"
                    f" field, but {bucketed} use multi-bucket pad_shapes (the"
                    " bucket choice could differ between the K stacked"
                    " batches); give them a single pad target instead.")
            if device_shuffle_capacity:
                raise PetastormTpuError(
                    "stack_batches cannot be combined with"
                    " device_shuffle_capacity: the HBM exchange buffer holds"
                    " single batches. Use the host shuffling buffer"
                    " (shuffling_queue_capacity) instead.")
        for name in self._fields:
            if name in device_decode:
                continue
            field = schema[name]
            if field.dtype.kind in ("U", "S", "O", "M", "m"):
                raise PetastormTpuError(
                    f"Field {name!r} (dtype {field.dtype}) cannot be fed to a device."
                    " Exclude it with fields=, or keep it host-side via host_fields=."
                    " (A hive partition key of a dataset without a stored schema is"
                    " such a field when its values are not numbers: the path's"
                    " strings.)")
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
        #: this rank's coordinate in the mesh, and the rows of the global
        #: batch it materializes
        self._coord = mesh_coordinate(mesh) if mesh is not None else None
        self._batch_size = self._local_rows() if mesh is not None else batch_size
        #: leading dims of every staged column: (K, batch) stacked, else (batch,)
        self._lead = ((self._stack,) if self._stack > 1 else ()) + (self._batch_size,)
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
        self._device_buffer: Optional[DeviceShufflingBuffer] = None
        if device_shuffle_capacity:
            device_shuffle_seed = reader_buffer_seed(
                reader, "loader.device_shuffle", device_shuffle_seed)
            if self._host_fields:
                raise PetastormTpuError(
                    "device_shuffle_capacity cannot be combined with"
                    " host_fields: host-side values cannot live in the HBM"
                    " buffer. Use the host shuffling buffer"
                    " (shuffling_queue_capacity) instead.")
            bucketed = [n for n, b in self._pad_shapes.items() if len(b) > 1]
            if bucketed:
                raise PetastormTpuError(
                    f"device_shuffle_capacity needs uniform batch shapes, but"
                    f" {bucketed} use multi-bucket pad_shapes; give them a"
                    " single pad target instead.")
            self._device_buffer = DeviceShufflingBuffer(
                device_shuffle_capacity, seed=device_shuffle_seed, device=self._device)
        #: padded tail units held back to follow the device buffer's drain
        self._tail_units: List[tuple] = []
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
        self._telemetry = _resolve_telemetry(
            telemetry if telemetry is not None else getattr(reader, "telemetry", None))
        tele = self._telemetry
        self._m_consumer_wait = tele.counter("loader.consumer_wait_s")
        self._m_delivered = tele.counter("loader.batches_delivered")
        self._m_straggler = tele.counter("loader.straggler_releases")
        self._g_host_depth = tele.gauge("loader.host_queue_depth")
        self._g_prefetch_depth = tele.gauge("loader.prefetch_depth")
        if tele.enabled:
            for stage in ("host-assemble", "host-prep", "device-transfer"):
                tele.register_stage(stage)
        self._trace_dir = trace_dir
        self._profiler = None
        #: the written trace (``trace_dir``), once the loader ends or stops
        self.trace_path: Optional[str] = None
        #: the commit policy and its state (``jax/loader.py:307-321``, ``:496-510``)
        self._commit_mode = transfer_commit
        self._commit_transfers = transfer_commit is not False
        self._commit_probed = transfer_commit != "auto"
        self._commit_probe_ms: Optional[float] = None
        self._commit_count = 0
        self._commit_breaches = 0
        #: units delivered in each split form, and the last one's form
        self._forms = {"host": 0, "device": 0}
        self.last_decode_form: Optional[str] = None
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
        self._delivered = 0  # units: batches, or stacks of K
        self._units_staged = 0
        self._straggler_releases = 0
        #: producer threads that outlived join()'s bounded wait
        self._unquiesced: List[dict] = []
        #: delivered tensor field -> (row shape, dtype) of the last unit: the
        #: shapes of drain()'s alignment pads when no unit is left to copy
        self._emitted_layout: Dict[str, Tuple[tuple, torch.dtype]] = {}
        #: seconds of work of each producer stage (each written by one thread:
        #: the assembly thread, the fetch thread's _prepare, the transfer thread)
        self._assemble_s = 0.0
        self._fetch_prepare_s = 0.0
        self._transfer_s = 0.0
        controller = getattr(reader, "autotune", None)
        if controller is not None:
            # the prefetch depth becomes the autotune controller's third knob
            controller.attach_loader(self)

    # -- the prefetch knob (``jax/loader.py:524-552``) ---------------------

    @property
    def prefetch(self) -> int:
        """The bound of both producer-stage queues."""
        return self._out.maxsize

    def set_prefetch(self, depth: int) -> int:
        """Move both stage queues' bound in place: a wider bound wakes a
        blocked producer at once, a narrower one drops nothing (puts wait
        until the consumer is below it).  The autotune controller's prefetch
        knob; safe while the loader runs.  Returns the new depth."""
        depth = max(1, int(depth))
        for q in (self._host_q, self._out):
            with q.not_full:
                q.maxsize = depth
                q.not_full.notify_all()
        return depth

    @property
    def telemetry(self):
        """The recorder this loader records into (the reader's by default)."""
        return self._telemetry

    def _form_route(self, batch: ColumnBatch) -> tuple:
        """The assembly key of a rowgroup: the live-split fields it carries
        as pixels (``jax/loader.py:728-735``); () without split fields."""
        if not self._split_fields:
            return ()
        return tuple(n for n in sorted(self._split_fields) if n in batch.columns)

    def _mixed_target(self, name: str) -> Tuple[int, ...]:
        """The static (H, W[, C]) every image of a 'device-mixed' field is
        cropped or padded to (``jax/loader.py:556``): the schema's shape when
        fixed, else its one ``pad_shapes`` target."""
        field = self._schema[name]
        if field.is_fixed_shape:
            return tuple(field.shape)
        buckets = self._pad_shapes.get(name)
        if not buckets or len(buckets) != 1:
            raise PetastormTpuError(
                f"decode_placement='device-mixed' field {name!r} has variable"
                f" shape {field.shape}: give it ONE pad_shapes target (H, W"
                "[, C]) so every geometry bucket decodes+pads to a static"
                " shape" + (f"; got {len(buckets)} buckets" if buckets else ""))
        target = tuple(buckets[0])
        if len(target) != len(field.shape):
            raise PetastormTpuError(
                f"pad_shapes[{name!r}] target {target} rank differs from the"
                f" field shape {field.shape}")
        return target

    # -- mesh placement -----------------------------------------------------

    def _placements(self, name: str) -> Placements:
        """The placements of field ``name`` (``jax/loader.py:610 _spec_for``):
        its ``shardings`` entry, else ``Shard(0)`` on the mesh's first
        dimension; the valid mask without an entry shards its one axis as the
        first field shards its batch axis."""
        specs = self._specs
        if name == self._valid_mask and (not isinstance(specs, dict) or name not in specs):
            return _batch_axis_only(self._placements(self._fields[0]))
        spec = specs.get(name) if isinstance(specs, dict) else specs
        if spec is None:
            return sharding_for_batch(self._mesh, mesh_dim_names(self._mesh)[:1])
        return tuple(spec)

    def _local_rows(self) -> int:
        """Rows of the global batch this rank materializes (``jax/loader.py:676
        _local_layout``); every field must shard the batch axis alike."""
        local_rows = None
        names = self._fields + ([self._valid_mask] if self._valid_mask else [])
        for name in names:
            placements = self._placements(name)
            if name in self._decode_fields and any(
                    isinstance(p, Shard) and p.dim != 0 for p in placements):
                raise PetastormTpuError(
                    f"field {name!r} is decoded on the device and may shard only its batch"
                    f" axis; got placements {placements}")
            sl = shard_slices(tuple(self._mesh.shape), self._coord,
                              _batch_axis_only(placements), (self._global_batch,))
            rows = sl[0].stop - sl[0].start
            if local_rows is None:
                local_rows = rows
            elif local_rows != rows:
                raise PetastormTpuError(
                    "All delivered fields must shard the batch axis identically"
                    f" (field {name!r} wants {rows} local rows, others {local_rows})")
        return int(local_rows)

    def _trailing_slice(self, name: str, trailing: Tuple[int, ...]) -> Tuple[slice, ...]:
        """This rank's slice of a field's per-row dims (``jax/loader.py:1476
        _placement_for``): the block of ``(global batch,) + trailing`` past
        its batch axis."""
        key = (name, trailing)
        hit = self._placement_cache.get(key)
        if hit is None:
            hit = self._placement_cache[key] = shard_slices(
                tuple(self._mesh.shape), self._coord, self._placements(name),
                (self._global_batch,) + tuple(trailing))[1:]
        return hit

    def _local_cols(self, cols: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Each column cut to this rank's range of its sharded per-row dims."""
        if self._mesh is None:
            return cols
        out = {}
        for name, col in cols.items():
            sl = self._trailing_slice(name, tuple(col.shape[1:]))
            whole = all(s.start == 0 and s.stop == d for s, d in zip(sl, col.shape[1:]))
            out[name] = col if whole else col[(slice(None),) + sl]
        return out

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
            if name in self._split_fields and name in batch.columns:
                # the host form of a live-split field: its pixels, staged
                # like any column
                cols[name] = batch.columns[name]
                continue
            if name in self._decode_fields:
                if name not in self._mixed_fields:
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
        self._m_straggler.add(1)
        if self._straggler_releases == 1:
            logger.warning(
                "straggler release: emitted a buffered batch past the shuffle decorrelation"
                " floor (no rowgroup for %.1fs). Frequent releases mean the source is"
                " uniformly slower than straggler_release_s and the min_after_retrieve"
                " floor is being bypassed", self._straggler_s)

    def _prep_cols(self, batch: ColumnBatch) -> _HostBatch:
        """Per-batch host prep: the delivered columns through ``transform_fn``,
        the valid mask, and each device-decode field's planes and geometry."""
        cols = {n: batch.columns[n] for n in self._fields
                if n not in self._decode_fields or n in batch.columns}
        if self._transform_fn is not None:
            cols = {k: np.asarray(v) for k, v in self._transform_fn(cols).items()}
            if self._valid_mask is not None and self._valid_mask in cols:
                raise PetastormTpuError(
                    f"transform_fn produced a field named {self._valid_mask!r}, which"
                    " collides with valid_mask_field; rename one")
        cols = self._local_cols(cols)
        if self._valid_mask is not None:
            cols[self._valid_mask] = np.ones(batch.num_rows, np.float32)
        coef, layouts, mixed = {}, {}, {}
        for name in self._decode_fields:
            if name in batch.columns:
                continue  # a live-split field in its host form
            if name in self._mixed_fields:
                mixed[name] = batch.columns[f"{name}{COEF_COLUMN_SEP}{MIXED_CELL_SUFFIX}"]
                continue
            meta_name = f"{name}{COEF_COLUMN_SEP}m"
            layouts[name] = coef_layout(name, batch.columns[meta_name])
            for key, col in batch.columns.items():
                if key.startswith(name + COEF_COLUMN_SEP) and key != meta_name:
                    coef[key] = col
        # host fields are delivered as they are: a view of the process
        # pool's arena is copied out, so no lease outlives the staging copy
        host = {n: _detached(batch.columns[n]) for n in self._host_fields}
        return _HostBatch(cols, coef, layouts, host, batch.num_rows, mixed)

    def _assemble(self) -> None:
        """Stage 1: reader rowgroups -> assembled host batches."""
        fetcher = None
        waited = [0.0]  # this thread's seconds blocked on the reader or the fetcher
        tele = self._telemetry
        try:
            def prepared(on_fetch_thread: bool):
                batches = self._reader.iter_batches()
                while True:
                    t0 = time.perf_counter()
                    raw = next(batches, None)
                    t1 = time.perf_counter()
                    if raw is None or self._stop.is_set():
                        return
                    with (tele.stage("host-assemble", rows=raw.num_rows)
                          if tele.enabled else NULL_CONTEXT):
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
                    next_fn, self._form_route, self._make_buffer, self._batch_size,
                    straggler_release_s=self._straggler_s,
                    on_straggler_release=self._on_straggler_release)
            elif self._split_fields:
                # the two forms of a live split assemble in their own buffers
                source = prepared(False)
                batches = iter_batched_multi(lambda _timeout: next(source), self._form_route,
                                             self._make_buffer, self._batch_size)
            else:
                batches = iter_batched(prepared(False), self._make_buffer(), self._batch_size)
            t0, w0 = time.perf_counter(), waited[0]
            for out in batches:
                if self._stop.is_set():
                    break
                if out.num_rows < self._batch_size and self._drop_last:
                    continue  # the short tail is dropped
                with (tele.stage("host-prep", rows=out.num_rows)
                      if tele.enabled else NULL_CONTEXT):
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
                if self._telemetry.enabled:
                    self._g_host_depth.set(self._host_q.qsize())
                return
            except queue.Full:
                continue

    # -- transfer stage ---------------------------------------------------

    def _layout(self, item: _HostBatch) -> Dict[str, Tuple[tuple, np.dtype]]:
        """The staged columns of one batch: (row shape, feed dtype) each."""
        return {name: (col.shape[1:], torch_feed_dtype(col.dtype, self._keep_wide))
                for name, col in {**item.cols, **item.coef}.items()}

    def _fill(self, dest: Dict[str, torch.Tensor], group: List[_HostBatch]) -> None:
        """Copy the batches' rows into ``dest`` (cast to the feed dtypes) and
        pad the rest, missing steps of a short stack included: zeros, and 1
        for quant tables, so that padded coefficient rows decode to flat
        gray."""
        for name, buf in dest.items():
            steps = buf.numpy()
            if self._stack == 1:
                steps = steps[None]
            is_qtab = name.endswith(f"{COEF_COLUMN_SEP}q") and name in group[0].coef
            pad = 1 if is_qtab else 0
            for k, item in enumerate(group):
                steps[k, :item.rows] = item.cols[name] if name in item.cols else item.coef[name]
                steps[k, item.rows:] = pad
            steps[len(group):] = pad

    def _finish(self, staged: Dict[str, torch.Tensor], item: _HostBatch,
                mixed: Dict[str, Tuple[torch.Tensor, List[_Bucket]]]) -> Dict[str, torch.Tensor]:
        """The delivered unit: staged columns as they are, device-decode
        fields decoded from their planes (kernel B2 on a CUDA device), all
        steps of a stack in one launch; a mixed-geometry field one launch a
        bucket (``mixed``: its staged arena and buckets)."""
        out = {name: staged[name] for name in item.cols}
        for name, (arena, buckets) in mixed.items():
            out[name] = self._decode_mixed(name, arena, buckets)
        lead = self._lead
        for name, layout in item.layouts.items():
            planes = [staged[f"{name}{COEF_COLUMN_SEP}p{c}"]
                      for c in range(len(layout.components))]
            qtabs = staged[f"{name}{COEF_COLUMN_SEP}q"]
            if len(lead) > 1:  # (K, B, ...) -> (K * B, ...): one launch for the stack
                planes = [p.reshape((-1,) + p.shape[2:]) for p in planes]
                qtabs = qtabs.reshape((-1,) + qtabs.shape[2:])
            image = decode_from_layout(planes, qtabs, layout)
            image = image.reshape(lead + image.shape[1:])
            if len(self._schema[name].shape) == 3 and image.dim() == len(lead) + 2:
                image = image[..., None]  # a declared (H, W, 1) grayscale shape
            out[name] = image
        return out

    def _pack_mixed(self, name: str, group: List[_HostBatch],
                    arena_for: Callable[[str, int], torch.Tensor]
                    ) -> Tuple[torch.Tensor, List[_Bucket]]:
        """Group a unit's mixed-geometry cells by geometry (``jax/loader.py:1257
        _decode_mixed_flat``) and pack each bucket's planes, quant tables
        (widened to int32) and flat rows back to back, 16-byte aligned, into
        the byte arena ``arena_for(name, nbytes)`` gives.  Returns the arena
        and the buckets in order of first appearance."""
        t0 = time.perf_counter()
        cells: List[tuple] = []
        rows: List[int] = []
        for k, item in enumerate(group):
            cells.extend(item.mixed[name])
            rows.extend(range(k * self._batch_size, k * self._batch_size + item.rows))
        groups: Dict[bytes, List[int]] = {}
        for i, cell in enumerate(cells):
            groups.setdefault(cell[2].tobytes(), []).append(i)
        self._mixed_geometries.setdefault(name, set()).update(groups)
        total = 0

        def place(shape, itemsize):
            nonlocal total
            spec = (total, shape)
            total += -(-int(np.prod(shape)) * itemsize // _ARENA_ALIGN) * _ARENA_ALIGN
            return spec

        buckets = []
        for key, idxs in groups.items():
            layout = _layout_from_meta(np.frombuffer(key, dtype=np.int32))
            self._check_declared_geometry(name, layout)
            k, ncomp = len(idxs), len(layout.components)
            buckets.append(_Bucket(layout, idxs,
                                   [place((k, bh, bw, 64), 2) for (_, _, bw, bh) in layout.components],
                                   place((k, ncomp, 64), 4), place((k,), 8)))
        arena = arena_for(name, total)
        host = arena.numpy()

        def view(spec, dtype):
            offset, shape = spec
            return host[offset:offset + int(np.prod(shape)) * np.dtype(dtype).itemsize
                        ].view(dtype).reshape(shape)

        for b in buckets:
            for c, spec in enumerate(b.planes):
                np.stack([cells[i][0][c] for i in b.cells], out=view(spec, np.int16))
            view(b.qtabs, np.int32)[...] = np.stack([cells[i][1] for i in b.cells])
            view(b.rows, np.int64)[...] = [rows[i] for i in b.cells]
        self._mixed_decode_s += time.perf_counter() - t0
        return arena, buckets

    def _decode_mixed(self, name: str, arena: torch.Tensor,
                      buckets: List[_Bucket]) -> torch.Tensor:
        """A unit's mixed-geometry images from its staged arena: B2 once a
        bucket (the plain version on the CPU), each bucket's images written
        into their rows of a zeroed ``(*lead, *target)`` tensor, cropped to
        the target and grayscale repeated to its channels, so padding and
        missing rows stay zero (``jax/loader.py:1297-1338``)."""
        t0 = time.perf_counter()
        target = self._mixed_targets[name]
        out = torch.zeros((int(np.prod(self._lead)),) + target, dtype=torch.uint8,
                          device=arena.device)
        for b in buckets:
            layout = b.layout
            planes = [_arena_view(arena, spec, torch.int16) for spec in b.planes]
            image = decode_from_layout(planes, _arena_view(arena, b.qtabs, torch.int32), layout)
            self._mixed_buckets += 1
            channels = 3 if image.dim() == 4 else 1
            if len(target) == 3:
                if image.dim() == 3:
                    image = image[..., None]
                if channels != target[2] and channels != 1:
                    raise PetastormTpuError(
                        f"field {name!r}: a stored jpeg decodes to {channels}-channel images"
                        f" but the target {target} wants {target[2]} channel(s); declare a"
                        " (H, W, 3) shape/target or store grayscale jpegs")
            elif channels != 1:
                raise PetastormTpuError(
                    f"field {name!r}: stored jpeg decodes to {channels}-channel images but"
                    f" the target {target} is 2-D; declare a (H, W, C) shape/target")
            h, w = min(layout.height, target[0]), min(layout.width, target[1])
            # the crop, the channel repeat (a broadcast) and the scatter back
            # to row order in one indexed write
            out[_arena_view(arena, b.rows, torch.int64), :h, :w] = image[:, :h, :w]
        self._mixed_decode_s += time.perf_counter() - t0
        return out.view(self._lead + target)

    def _check_declared_geometry(self, name: str, layout: JpegCoefLayout) -> None:
        """Warn once a geometry when a batch holds an image geometry missing
        from the dataset's stamped contract (``jax/loader.py:1340``), keyed
        ``(h, w, channels)``: the set of geometries, and so of B2 launches a
        unit, is then no longer bounded by the declared set."""
        shapes = self._declared_geometries.get(name)
        if not shapes:
            return  # no contract stamped (a dataset written by another tool)
        hwc = {(s[0], s[1], s[2] if len(s) > 2 else 1) for s in shapes}
        seen = (layout.height, layout.width, len(layout.components))
        key = (name,) + seen
        if seen not in hwc and key not in self._geom_warned:
            self._geom_warned.add(key)
            logger.warning(
                "field %r: jpeg geometry %s (h, w, channels) is not in the dataset's"
                " declared geometry contract %s - the launches a unit are no longer bounded"
                " by the declared set; re-stamp it (generate_metadata --scan-geometries)"
                " after changing the dataset", name, seen, sorted(hwc))

    def _slot(self, layout: Dict[str, Tuple[tuple, np.dtype]]) -> _Slot:
        """The next staging slot of this layout's ring (made at its first
        unit), once the last copy that read it has completed."""
        key = tuple((name, shape, dtype.str) for name, (shape, dtype) in layout.items())
        ring = self._slots.get(key)
        if ring is None:
            ring = self._slots[key] = collections.deque(
                _Slot(layout, self._lead, True) for _ in range(self._prefetch + 1))
        slot = ring[0]
        ring.rotate(-1)
        if slot.copied is not None:
            slot.copied.synchronize()  # its last copy has read the buffer
        return slot

    def _check_stack(self, group: List[_HostBatch],
                     layout: Dict[str, Tuple[tuple, np.dtype]]) -> None:
        """The K batches of a stack need one staged layout and, for a
        device-decode field, one JPEG geometry (``jax/loader.py:1157``)."""
        for item in group[1:]:
            if self._layout(item) != layout:
                raise PetastormTpuError(
                    f"stack_batches={self._stack}: the stacked batches have different"
                    f" column shapes or dtypes ({self._layout(item)} after {layout}); a"
                    " transform_fn must give every batch the same layout")
            for name, lay in item.layouts.items():
                first = group[0].layouts[name]
                if ((lay.height, lay.width, lay.components)
                        != (first.height, first.width, first.components)):
                    raise PetastormTpuError(
                        f"field {name!r}: jpeg geometry changed between stacked"
                        " batches - decode_placement='device' requires one"
                        " geometry dataset-wide (use 'device-mixed')")

    def _shuffle_on_device(self, batch: Dict[str, torch.Tensor],
                           item: _HostBatch) -> Optional[Dict[str, torch.Tensor]]:
        """A full batch through the device shuffle buffer, when there is one:
        the batch it emits, or None while it fills.  The padded tail skips
        it."""
        if self._device_buffer is None or item.rows < self._batch_size:
            return batch
        return self._device_buffer.push(batch)

    def _drain_device_buffer(self) -> List[tuple]:
        """The device buffer's resident batches (shuffled) and the held-back
        tails, as (unit, event) pairs, in the order they are delivered."""
        if self._device_buffer is None:
            return []
        t0 = time.perf_counter()
        if self._cuda:
            with torch.cuda.device(self._device), torch.cuda.stream(self._copy_stream):
                residents = list(self._device_buffer.drain())
                drained = torch.cuda.Event()
                drained.record(self._copy_stream)
        else:
            residents, drained = list(self._device_buffer.drain()), None
        self._transfer_s += time.perf_counter() - t0
        units = [(batch, drained, None) for batch in residents] + self._tail_units
        self._tail_units = []
        return units

    def _stage(self, group: List[_HostBatch]):
        """One batch, or the K batches of a stack -> (device unit, the event
        its copy and decode record), or None when the device shuffle buffer
        keeps it."""
        item = group[0]
        layout = self._layout(item)
        if self._stack > 1:
            self._check_stack(group, layout)
        form = None
        if self._split_fields:
            form = "host" if any(n in item.cols for n in self._split_fields) else "device"
        if self._cuda:
            slot = self._slot(layout)
            self._fill(slot.host, group)
            packed = {name: self._pack_mixed(name, group, slot.arena) for name in item.mixed}
            with torch.cuda.device(self._device), torch.cuda.stream(self._copy_stream):
                staged = {name: host.to(self._device, non_blocking=True)
                          for name, host in slot.host.items()}
                mixed = {name: (arena.to(self._device, non_blocking=True), buckets)
                         for name, (arena, buckets) in packed.items()}
                # the decode and the device shuffle run on the copy stream,
                # after the copy and before the event the consumer waits on
                batch = self._shuffle_on_device(self._finish(staged, item, mixed), item)
                slot.copied = torch.cuda.Event()
                slot.copied.record(self._copy_stream)
            copied = slot.copied
            self._commit(copied, slot)
        else:
            staged = {name: torch.empty(self._lead + shape, dtype=_torch_dtype(dt))
                      for name, (shape, dt) in layout.items()}
            self._fill(staged, group)
            mixed = {name: self._pack_mixed(name, group,
                                            lambda _, n: torch.empty(n, dtype=torch.uint8))
                     for name in item.mixed}
            batch = self._shuffle_on_device(self._finish(staged, item, mixed), item)
            copied = None
        if batch is None:
            return None  # the device buffer took the batch and emitted none
        for name, tensor in batch.items():
            self._emitted_layout[name] = (tuple(tensor.shape[len(self._lead):]), tensor.dtype)
        if self._stack == 1:
            batch.update(item.host)
            if item.rows < self._batch_size:
                batch[VALID_ROWS] = item.rows
                if self._device_buffer is not None:
                    # a consumer reads the padded tail as the epoch's end:
                    # it follows the buffer's drain (jax/loader.py:973-983)
                    self._tail_units.append((batch, copied, form))
                    return None
            return batch, copied, form
        valids = [it.rows for it in group]
        missing = self._stack - len(group)
        for name in self._host_fields:
            steps = [_pad_host_col(it.host[name], self._batch_size) for it in group]
            batch[name] = np.stack(steps + [_host_filler(steps[-1])] * missing)
        if missing or any(v < self._batch_size for v in valids):
            batch[VALID_ROWS] = torch.tensor(valids + [0] * missing, dtype=torch.int64)
        return batch, copied, form

    def _transfer(self) -> None:
        """Stage 2: host batches -> staged, copied (and decoded) units.  With
        ``stack_batches=K`` it groups K consecutive batches into one unit; a
        short final group is zero-padded (``drop_last=False``) or dropped."""
        group: List[_HostBatch] = []
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
                group.append(item)
                if len(group) == self._stack:
                    self._stage_and_push(group)
                    group = []
            else:
                return  # stopped
            if group and not self._drop_last:
                self._stage_and_push(group)
            for unit in self._drain_device_buffer():
                self._push(unit)
            self._push(_Done())
            self._sentinel_pending = True
        except BaseException as exc:  # noqa: BLE001 - delivered to the consumer
            self._push(_Error(exc))
            self._sentinel_pending = True
            self._abort_upstream()

    def _commit(self, copied: "torch.cuda.Event", slot: _Slot) -> None:
        """Wait for the unit's copy event before the next unit, when the
        commit is on (``jax/loader.py:1070-1120``).  A first wait is
        warm-up; a later one that costs more than 0.1 s plus its bytes at
        100 MB/s, twice in a row, turns the commit off for good."""
        if not self._commit_probed:
            self._probe_commit_cost()
        if not self._commit_transfers:
            return
        t0 = time.perf_counter()
        copied.synchronize()
        took = time.perf_counter() - t0
        self._commit_count += 1
        if self._commit_count == 1:
            return
        nbytes = sum(t.numel() * t.element_size() for t in slot.host.values())
        if took > 0.1 + nbytes / 100e6:
            self._commit_breaches += 1
            if self._commit_breaches >= 2:
                self._commit_transfers = False
                logger.warning(
                    "transfer commit took %.0f ms for %.1f MB (twice in a row);"
                    " disabling the per-unit commit", took * 1e3, nbytes / 1e6)
        else:
            self._commit_breaches = 0

    def _probe_commit_cost(self) -> None:
        """``transfer_commit='auto'``: the least of three waits on an event
        of the idle copy stream (after one warm-up); above 20 ms the commit
        starts off (``jax/loader.py:1122-1142``)."""
        self._commit_probed = True
        costs = []
        for _ in range(4):
            event = torch.cuda.Event()
            event.record(self._copy_stream)
            t0 = time.perf_counter()
            event.synchronize()
            costs.append(time.perf_counter() - t0)
        cost = min(costs[1:])
        self._commit_probe_ms = cost * 1e3
        if cost > _COMMIT_PROBE_THRESHOLD_S:
            self._commit_transfers = False
            logger.info("an idle event wait costs %.0f ms; starting without the per-unit"
                        " commit (transfer_commit=True pins it)", cost * 1e3)

    def _stage_and_push(self, group: List[_HostBatch]) -> None:
        t0 = time.perf_counter()
        tele = self._telemetry
        with (tele.stage("device-transfer", rows=sum(it.rows for it in group))
              if tele.enabled else NULL_CONTEXT):
            value = self._stage(group)
        self._units_staged += 1
        self._transfer_s += time.perf_counter() - t0
        if value is not None:
            self._push(value)

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
            if self._trace_dir:
                self._start_trace()  # before the producers: their first launches count
            self._thread.start()
            self._transfer_thread.start()
        return self

    def _start_trace(self) -> None:
        """A ``torch.profiler`` trace of the host and the card (CUDA activity
        is recorded process-wide, so the copy stream's B2 launches are in
        it) until the loader ends or stops (``jax/loader.py:1557-1565``).
        One that cannot start (another profiler is running) is warned about
        and the loader runs untraced."""
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self._cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        try:
            profiler = torch.profiler.profile(activities=activities)
            profiler.__enter__()
            self._profiler = profiler
        except (RuntimeError, OSError) as exc:
            logger.warning("trace_dir=%r: could not start the torch profiler: %s",
                           self._trace_dir, exc)

    def _stop_trace(self) -> Optional[str]:
        """End the trace and write it as ``<trace_dir>/loader_trace.json``;
        returns the path (None when nothing was traced)."""
        profiler, self._profiler = self._profiler, None
        if profiler is None:
            return None
        if self._cuda:
            torch.cuda.synchronize(self._device)
        profiler.__exit__(None, None, None)
        os.makedirs(self._trace_dir, exist_ok=True)
        path = os.path.join(self._trace_dir, "loader_trace.json")
        profiler.export_chrome_trace(path)
        self.trace_path = path
        return path

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
                if self._telemetry.enabled:
                    self._m_consumer_wait.add(time.perf_counter() - t0)
                    self._g_prefetch_depth.set(self._out.qsize())
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
                        self._stop_trace()
                        raise self._failure from None
        self._consumer_wait_s += time.perf_counter() - t0
        if isinstance(value, _Done):
            self._finished = True
            self._sentinel_pending = False
            self._stop_trace()  # the end of the stream writes the trace
            raise StopIteration
        if isinstance(value, _Error):
            self._failure = value.exc
            self._sentinel_pending = False
            self._stop_trace()
            raise value.exc
        batch, copied, form = value
        self.last_decode_form = form
        if form is not None:
            self._forms[form] += 1
        if copied is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(copied)
            for tensor in batch.values():
                if isinstance(tensor, torch.Tensor) and tensor.is_cuda:
                    tensor.record_stream(stream)
        self._delivered += 1
        self._m_delivered.add(1)
        return batch

    def diagnostics(self) -> Dict[str, float]:
        """Queue depths, delivery counts and the seconds of each stage."""
        depth = self._out.qsize()
        if self._sentinel_pending:  # the end-of-stream marker is not a batch
            depth = max(depth - 1, 0)
        out = {"consumer_wait_s": self._consumer_wait_s,
               "batches_delivered": self._delivered,
               "units_staged": self._units_staged,
               "prefetch_depth": depth,
               "prefetch_capacity": self._out.maxsize,
               "host_queue_depth": self._host_q.qsize(),
               "straggler_releases": self._straggler_releases,
               "assemble_s": self._assemble_s + self._fetch_prepare_s,
               "transfer_s": self._transfer_s,
               "transfer_commit": self._commit_transfers and self._cuda,
               "transfer_commit_probe_ms": self._commit_probe_ms,
               "unquiesced_threads": list(self._unquiesced)}
        if self._split_fields:
            # units delivered in each form of the live split
            out["decode_split_batches"] = dict(self._forms)
        if self._stack > 1:
            out["stack_batches"] = self._stack
        if self._mixed_geometries:
            out["mixed_decode_geometries"] = {
                name: len(keys) for name, keys in self._mixed_geometries.items()}
            out["mixed_buckets"] = self._mixed_buckets
            out["mixed_decode_s"] = self._mixed_decode_s
            if self._declared_geometries:
                out["declared_geometries"] = {
                    name: len(shapes) for name, shapes in self._declared_geometries.items()}
        transport = getattr(self._reader, "transport_stats", None)
        stats = transport() if callable(transport) else {}
        if stats:
            # the process pool's arena: batches through it and pickled, and
            # its high-water mark (the JAX loader reads the telemetry counter
            # ``decode.batch_slots`` for the slot decode, ``pool.py:1990``)
            out["transport"] = stats
            for key in ("shm_batches", "pickled_batches", "shm_high_water_bytes"):
                out[key] = stats[key]
        reader_diag = getattr(self._reader, "diagnostics", None)
        if isinstance(reader_diag, dict):
            # the reader's own (a packed token feed's ``packing`` stats among
            # them), and a feed degraded under an on_error skip policy shows
            # it at this level too (``petastorm_tpu/jax/loader.py:1540-1549``)
            out["reader"] = reader_diag
            if reader_diag.get("skipped_rowgroups"):
                out["skipped_rowgroups"] = reader_diag["skipped_rowgroups"]
                out["quarantined_rowgroups"] = reader_diag.get("quarantined_rowgroups", [])
        return out

    # -- checkpoint and resume ----------------------------------------------

    def drain(self, all_gather_counts: Optional[Callable[[int], Sequence[int]]] = None):
        """Quiesce the reader and return an iterator over every unit still in
        flight: the assembled ones, the remainders of the host and device
        shuffle buffers and, under ``drop_last=False``, the zero-padded tail.
        Once it is consumed the loader is exhausted and ``state_dict()`` is an
        exact cursor: a resume re-reads no row.  The quiesce happens in this call, not at the first
        ``next``::

            for unit in loader.drain():   # train on what is already in flight
                step(unit)
            save(loader.state_dict())     # exact

        ``all_gather_counts``: processes drain unequal counts, and a step
        that runs collectives would hang the short ones.  Given this
        callable (own count -> every process's count), the loader drains
        locally, and the processes short of the largest count yield zero
        units carrying ``'_valid_rows': 0`` (a zero ``(K,)`` tensor when
        stacked) and a zero valid mask, shaped like the last unit (or, when
        none was emitted, from the schema).  ``'_valid_rows'`` is local to a
        process: a consumer weights by ``valid_mask_field`` and runs every
        step.  ``None``: on a mesh of several ranks, an ``all_gather`` of
        the counts over the mesh's group (the default collective); else one
        process.

        With ``drop_last=True`` a final partial batch's rows are dropped as at
        an epoch end, and with ``stack_batches=K`` the short stack too: up to
        K-1 full batches whose rows the reader's cursor has passed are lost.
        A job that checkpoints mid-epoch should use ``drop_last=False``.
        """
        if not hasattr(self._reader, "quiesce"):
            raise PetastormTpuError(
                f"Reader {type(self._reader).__name__} does not support"
                " quiesce(); drain-to-cursor needs a petastorm_tpu_torch Reader")
        self._reader.quiesce()

        def _rest():
            while True:
                try:
                    yield next(self)
                except StopIteration:
                    return

        if all_gather_counts is None and self._mesh is not None and self._mesh.mesh.numel() > 1:
            all_gather_counts = self._all_gather_counts
        if all_gather_counts is None:
            return _rest()
        local = list(_rest())
        target = int(max(all_gather_counts(len(local))))

        def _aligned():
            yield from local
            template = local[-1] if local else None
            layout = None
            for _ in range(target - len(local)):
                if template is not None:
                    pad = {name: (torch.zeros_like(value) if isinstance(value, torch.Tensor)
                                  else value)  # host fields pass through
                           for name, value in template.items() if name != VALID_ROWS}
                else:
                    # this process drained nothing while a peer did: the pads
                    # come from the schema, so it still steps with its peers
                    layout = layout or self._pad_batch_layout()
                    pad = {name: (torch.zeros(shape, dtype=dtype, device=self._device)
                                  if isinstance(dtype, torch.dtype) else np.zeros(shape, dtype))
                           for name, (shape, dtype) in layout.items()}
                pad[VALID_ROWS] = (torch.zeros(self._stack, dtype=torch.int64)
                                   if self._stack > 1 else 0)
                yield pad
        return _aligned()

    def _all_gather_counts(self, count: int) -> List[int]:
        """Every process's drained count: one int64 gathered over the mesh's group."""
        group = mesh_group(self._mesh)
        device = group_device(group)
        mine = torch.tensor([count], dtype=torch.int64, device=device)
        counts = torch.empty(dist.get_world_size(group), dtype=torch.int64, device=device)
        dist.all_gather_into_tensor(counts, mine, group=group)
        return counts.tolist()

    def _pad_batch_layout(self) -> Dict[str, Tuple[tuple, object]]:
        """field -> (shape, dtype) of a drain pad when this process delivered
        no unit (``jax/loader.py:1748``): a torch dtype for a device tensor, a
        numpy dtype for a host field.  The last emitted unit's layout wins
        (it reflects ``transform_fn``); else the schema's shapes."""
        layout: Dict[str, Tuple[tuple, object]] = {}
        names = list(self._emitted_layout) if self._emitted_layout else list(self._fields)
        if self._valid_mask is not None and self._valid_mask not in names:
            names.append(self._valid_mask)
        for name in names:
            if name in self._emitted_layout:
                trailing, dtype = self._emitted_layout[name]
            elif name == self._valid_mask:
                trailing, dtype = (), torch.float32
            elif name in self._decode_fields:
                trailing = self._mixed_targets.get(name, tuple(self._schema[name].shape))
                dtype = torch.uint8
            else:
                if self._transform_fn is not None:
                    raise PetastormTpuError(
                        "drain() alignment on a zero-batch host cannot derive"
                        f" the padded shape of field {name!r}: a transform_fn"
                        " is set and no batch was ever emitted here to learn"
                        " its output shape - checkpoint at a step boundary"
                        " instead")
                buckets = self._pad_shapes.get(name)
                if buckets and len(buckets) > 1:
                    raise PetastormTpuError(
                        "drain() alignment on a zero-batch host cannot pick a"
                        f" pad bucket for field {name!r} (multi-bucket"
                        " pad_shapes): peers pad from their own last batch's"
                        " bucket, so a guess here could silently diverge the"
                        " pod's global shapes - checkpoint at a step boundary"
                        " instead")
                field = self._schema[name]
                trailing = tuple(buckets[0]) if buckets else tuple(field.shape)
                if self._mesh is not None:
                    trailing = tuple(s.stop - s.start
                                     for s in self._trailing_slice(name, trailing))
                dtype = _torch_dtype(torch_feed_dtype(field.dtype, self._keep_wide))
            layout[name] = (self._lead + trailing, dtype)
        for name in self._host_fields:
            field = self._schema[name]
            shape = tuple(d if d is not None else 0 for d in field.shape)
            dtype = field.dtype if field.dtype.kind not in "USOMm" else np.dtype(object)
            layout[name] = (self._lead + shape, dtype)
        return layout

    def state_dict(self) -> Dict:
        """Data cursor to save beside a training checkpoint
        (``jax/loader.py:1816``): ``reader`` is the reader's cursor (for
        ``make_reader(..., resume_from=...)``, see
        ``checkpoint.resume_reader_kwargs``), ``delivered_batches`` counts
        delivered units (stacks when ``stack_batches=K``).  Mid-epoch the
        reader's cursor runs ahead of the units delivered by the in-flight
        window: both stage queues (2x ``prefetch``), the host shuffle buffer,
        the accumulating stack, and all ``device_shuffle_capacity`` resident
        batches of the device buffer.  Keep the buffers small (or zero) where
        a tight resume matters, or call ``drain()`` first for an exact one."""
        if not hasattr(self._reader, "state_dict"):
            raise PetastormTpuError(
                f"Reader {type(self._reader).__name__} does not support"
                " state_dict(); checkpoint/resume needs a petastorm_tpu_torch Reader")
        return {"reader": self._reader.state_dict(),
                "delivered_batches": self._delivered,
                "global_batch": self._global_batch,
                "stack_batches": self._stack}

    def stop(self) -> None:
        """Stop both producer threads and the reader, then :meth:`join` them:
        code that calls ``stop()`` alone leaves no running thread behind."""
        self._stop.set()
        self._reader.stop()
        self.join()
        self._stop_trace()

    def join(self) -> None:
        """Wait for the producer threads and the reader to exit, after
        ``stop()`` (``jax/loader.py:1856``).  Each thread gets a bounded
        join; one that fails to quiesce (wedged in a ``transform_fn``, a copy
        that never completes) is abandoned with a warning naming it and its
        stage, and recorded in ``diagnostics()['unquiesced_threads']``; a
        later ``join()`` does not wait for it again.  The threads are daemons,
        so an abandoned one cannot block the exit."""
        if self._started:
            for thread, stage in ((self._thread, "host-assemble"),
                                  (self._transfer_thread, "device-transfer")):
                entry = {"thread": thread.name, "stage": stage}
                if entry in self._unquiesced:
                    continue
                thread.join(timeout=_JOIN_TIMEOUT_S)
                if thread.is_alive():
                    self._unquiesced.append(entry)
                    logger.warning(
                        "Loader producer thread %s (stage %s) failed to quiesce within %s s"
                        " of stop(); abandoning the daemon thread. queue depths: host=%d"
                        " out=%d", thread.name, stage, _JOIN_TIMEOUT_S, self._host_q.qsize(),
                        self._out.qsize())
        self._reader.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        self.join()


def make_cuda_loader(dataset_url: str,
                     batch_size: int,
                     mesh=None,
                     shardings=None,
                     reader_factory=None,
                     shard_by_process: bool = True,
                     **kwargs) -> CudaDataLoader:
    """One-call path: dataset URL -> sharded reader -> ``CudaDataLoader``
    (``petastorm_tpu/jax/loader.py:1889 make_jax_loader``).

    Reader kwargs (``predicate``, ``num_epochs``, ``shuffle_seed``, ...) and
    loader kwargs (``device``, ``shuffling_queue_capacity``, ``pad_shapes``,
    ...) are split by the loader's signature; ``schema_fields`` defaults to
    the delivered fields (``fields`` and ``host_fields``), so no column is
    read only to be dropped.  The reader (``reader_factory``, default
    ``make_batch_reader``) is sharded unless ``cur_shard`` is given: on a
    mesh by this rank's block of the batch axis (``parallel.mesh.batch_block``),
    so ranks that differ only on a ``seq`` dimension read the same rows;
    without a mesh by ``(rank, world_size)``.  The JAX function shards by
    ``jax.process_index()`` whatever the mesh (``:1923-1926``), which gives two
    processes of one ``seq`` ring different rows (ROADMAP.md §C).  A loader
    that fails to build stops the reader.
    """
    import inspect

    from petastorm_tpu_torch.parallel.mesh import reader_shard, shard_options_from_torch
    from petastorm_tpu_torch.reader import make_batch_reader

    loader_params = set(inspect.signature(CudaDataLoader.__init__).parameters) - {
        "self", "reader", "batch_size", "mesh", "shardings"}
    loader_kwargs = {k: kwargs.pop(k) for k in list(kwargs) if k in loader_params}
    if "telemetry" in loader_kwargs:
        # one recorder observes the whole pipeline: the reader gets it too
        # (``jax/loader.py:1912-1915``)
        kwargs["telemetry"] = loader_kwargs["telemetry"]
    if "schema_fields" not in kwargs:
        wanted = list(loader_kwargs.get("fields") or [])
        wanted += list(loader_kwargs.get("host_fields") or [])
        if wanted:
            kwargs["schema_fields"] = wanted
    if shard_by_process and "cur_shard" not in kwargs:
        if mesh is not None:
            cur, count = reader_shard(mesh, shardings)
        else:
            cur, count = shard_options_from_torch()
        if count > 1:
            kwargs["cur_shard"], kwargs["shard_count"] = cur, count
    factory = reader_factory or make_batch_reader
    reader = factory(dataset_url, **kwargs)
    try:
        return CudaDataLoader(reader, batch_size, mesh=mesh, shardings=shardings,
                              **loader_kwargs)
    except BaseException:
        # the loader never came to own the reader: shut it down, or its
        # pool threads would poll forever
        reader.stop()
        reader.join()
        raise


def _batch_axis_only(placements: Placements) -> Placements:
    """``placements`` with every mesh dimension that does not shard dim 0
    replicated: how the batch axis alone is laid out."""
    return tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in placements)


def _detached(col: np.ndarray) -> np.ndarray:
    """``col``, copied when it is a view of the process pool's arena."""
    return col.copy() if is_arena_backed(col) else col


def _host_filler(tmpl: np.ndarray) -> np.ndarray:
    """A missing stack step of a host field (``jax/loader.py:1952``): None
    cells for objects, zeros otherwise."""
    if tmpl.dtype == object:
        return np.full(tmpl.shape, None, dtype=object)
    return np.zeros_like(tmpl)


def _pad_host_col(col: np.ndarray, rows: int) -> np.ndarray:
    """A host field's column padded to ``rows`` for stacking
    (``jax/loader.py:1960``), with :func:`_host_filler`'s policy."""
    col = np.asarray(col)
    if len(col) >= rows:
        return col
    return np.concatenate([col, _host_filler(np.empty((rows - len(col),) + col.shape[1:],
                                                      col.dtype))])


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
