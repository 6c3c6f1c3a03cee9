"""Readers: a dataset URL -> decoded rows or column batches.

Counterpart of ``petastorm_tpu/reader.py:73 make_reader``,
``:374 make_batch_reader`` and ``:1159 Reader``, with the arguments the
ImageNet feed uses: field selection, the thread or serial pool, rowgroup
shuffling by seed, epochs and static sharding.  Delivery follows the read
plan's order with either pool, as the JAX reader does when it is given a
``shuffle_seed``; ``deterministic`` takes the JAX reader's three values and
``'off'`` keeps the plan order too (one of the orders ``'off'`` allows).  ``decode_placement`` takes ``'host'``, ``'device'``
and ``'device-mixed'`` (the hybrid JPEG decode: entropy decode in the pool
workers, the rest on the card in the loader; one geometry, or a bucket a
geometry).  Host decode of image columns is the batched native
decode, fanned out over ``decode_threads`` and cropped by ``decode_roi``
(``petastorm_tpu/reader.py:740-802``, ``:966-1049``).  Rows are chosen
and reshaped as the JAX reader chooses them (``:73-108``, ``:374-398``):
``rowgroup_selector`` keeps the rowgroups a stored index selects before the
plan is built (``:652-657``), ``shuffle_row_drop_partitions`` splits each
rowgroup into row-drop partitions and ``shard_mode='epoch'`` re-deals the
rowgroups to the shards every epoch (``plan.py``), ``predicate`` masks rows
in the workers before the rest of the row is decoded, and ``transform_spec``
reshapes each decoded rowgroup (the reader's ``schema`` is
``transform.transform_schema``'s, ``:639-640``).  A rowgroup the predicate
empties is folded into the cursor and the stream digest and never delivered
(``:1686-1700``).  A reader resumes
from a cursor (``resume_from``, ``:865-890``), also under a new shard layout
(``elastic_resume``, ``:349``, ``:684-700``), and gives its cursor
(``Reader.quiesce`` ``:1925``, ``Reader.state_dict`` ``:1938``) and its
stream certificate (``Reader.stream_digest`` ``:1743``, folded as ``:1662``
folds it).  ``cache_type`` caches decoded rowgroups in memory or on local
disk (``cache.py``), a cacheable transform's output included.  ``ngram``
reads sliding windows of consecutive timesteps (``ngram.NGram``,
``:595-649``): the reader's ``schema`` is then the post-transform full
schema, ``output_schema`` the window columns ``iter_batches`` yields, and a
row is one window as ``{offset: namedtuple}`` (``:1421-1451``).
``on_error`` is the failure policy (``:583``, ``:1801-1880``): under a skip
policy a work item that fails with a data error is quarantined
(``quarantined_rowgroups``, ``diagnostics``), folded into the cursor and
the digest at its plan position, and held to the policy's budgets.  A
dataset is a directory (hive partitions included) or, for
``make_batch_reader``, a list of URLs; a predicate over partition keys alone
is pushed down to the partitions (``:659-681``).  The shared cache tier,
the ``'auto'`` placement, telemetry, chaos injection, liveness and the
ingest service are not part of this package yet (ROADMAP.md queue A item
11).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import FrozenSet, Iterator, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from petastorm_tpu_torch.batch import ColumnBatch
from petastorm_tpu_torch.cache import make_cache
from petastorm_tpu_torch.codecs import CompressedImageCodec, native_decodable
from petastorm_tpu_torch.errors import (EpochNotFinishedError, ErrorBudgetExceededError,
                                        ErrorPolicy, NoDataAvailableError, PetastormTpuError,
                                        ReaderClosedError, resolve_error_policy)
from petastorm_tpu_torch.etl.indexing import get_row_group_indexes
from petastorm_tpu_torch.etl.metadata import (declared_geometries, infer_or_load_schema,
                                              open_dataset)
from petastorm_tpu_torch.native import image as native_image
from petastorm_tpu_torch.plan import (ElasticResumePlan, ReadPlan, WorkItem, elastic_resume_plan,
                                      resolve_cursor)
from petastorm_tpu_torch.pool import WorkerError, make_executor
from petastorm_tpu_torch.schema import Schema
from petastorm_tpu_torch.seeding import StreamDigest, resolve_deterministic
from petastorm_tpu_torch.sequence.dataset import is_sequence_field
from petastorm_tpu_torch.transform import (TransformSpec, transform_cache_info,
                                           transform_schema)
from petastorm_tpu_torch.worker import RowGroupDecoderWorker

logger = logging.getLogger(__name__)

_DEFAULT_RESULTS_QUEUE_BATCHES = 10
#: entries of the quarantine ledger ``Reader.diagnostics`` carries (the
#: ``quarantined_rowgroups`` property has them all)
_DIAGNOSTICS_QUARANTINE_TAIL = 20


def make_reader(dataset_url: str,
                schema_fields: Optional[Sequence] = None,
                reader_pool_type: str = "thread",
                workers_count: Union[int, str] = 4,
                results_queue_size: Optional[int] = None,
                shuffle_row_groups: bool = True,
                shuffle_seed: Optional[int] = None,
                num_epochs: Optional[int] = 1,
                cur_shard: Optional[int] = None,
                shard_count: Optional[int] = None,
                decode_placement: Optional[Mapping[str, str]] = None,
                deterministic: Optional[str] = "auto",
                decode_threads: Union[int, str] = "auto",
                decode_roi: Optional[Mapping[str, tuple]] = None,
                resume_from: Optional[dict] = None,
                cache_type: str = "null",
                cache_location: Optional[str] = None,
                cache_size_limit: Optional[int] = None,
                shuffle_row_drop_partitions: int = 1,
                predicate=None,
                rowgroup_selector=None,
                shard_mode: str = "static",
                transform_spec: Optional[TransformSpec] = None,
                ngram=None,
                on_error="raise",
                verify_checksums: bool = False) -> "Reader":
    """Row reader for datasets that carry a stored schema: yields one
    namedtuple per row; ``iter_batches()`` yields whole decoded rowgroups
    (the loader's path).  ``num_epochs=None`` reads forever.

    ``decode_placement``: field -> ``'host'``, ``'device'`` or
    ``'device-mixed'``.  A ``'device'`` field (a fixed-shape JPEG image of
    one geometry) is entropy-decoded in the workers and finished on the card
    by ``cuda.CudaDataLoader``; such a reader is consumed through that loader
    only.  A ``'device-mixed'`` field may mix JPEG sizes and subsamplings and
    may declare wildcard dims (``(None, None, 3)``): its rows travel as
    object cells (``native.image.pack_coef_columns_mixed``) and the loader
    decodes each geometry bucket of a batch in one B2 launch and fits it to
    one target shape (the schema's, else one ``pad_shapes`` entry).

    ``deterministic``: ``'seed'``, ``'off'`` or ``'auto'`` (``'seed'`` when a
    ``shuffle_seed`` is given).  Under ``'seed'`` an unseeded loader shuffle
    buffer derives its seed from ``shuffle_seed``, and the loader's
    straggler release is off.

    ``workers_count``: pool threads; ``'auto'`` is ``max(1, min(10, cores -
    1))`` of the usable cores.  ``decode_threads``: fan-out of the native
    image decode (and of the entropy decode) inside each worker; ``'auto'``
    is ``cores // workers_count``, at least 1.

    ``decode_roi``: partial image decode - decode only the pixels a crop
    keeps.  ``{'image': (y, x, h, w)}`` decodes a fixed window,
    ``('center', h, w)`` centers it, ``('random', h, w)`` draws per-image
    offsets (seeded per rowgroup, so a re-read decodes the same crops).  The
    delivered column, and the reader's ``schema``, have shape ``(h, w[,
    C])``; the result is byte-identical to slicing a full decode.

    ``resume_from``: a ``Reader.state_dict()`` (or ``loader.state_dict()
    ['reader']``) to start at that cursor, with the dataset, shard, seed,
    shuffle and epoch settings of the run that took it; its stream digest
    continues.  ``elastic_resume(states)`` resumes under another shard
    layout.

    ``cache_type``: decoded-rowgroup cache.  ``'null'`` (default) decodes
    every read; ``'memory'`` keeps decoded rowgroups in this process (an LRU
    capped at ``cache_size_limit`` bytes, default 4 GiB) and
    ``'local-disk'`` as pickle files in ``cache_location`` (default
    ``<tmp>/petastorm_tpu_torch_cache``, capped at 10 GiB), so epochs after
    the first skip the Parquet read and the decode.  A
    ``decode_placement='device'`` field is cached as its coefficient planes:
    a hit skips the entropy decode, and the loader still finishes the decode
    on the device.  ``Reader.cache_stats()`` counts the hits and misses.
    The host-wide ``'shared'`` tier is not part of this package yet.

    ``rowgroup_selector``: a ``selectors`` object resolved against the
    dataset's stored indexes (``etl.indexing.build_rowgroup_index``); only
    the rowgroups it selects are planned.  ``predicate``: a ``predicates``
    object; the workers decode its fields first and the rest of each row only
    where it is true (a rowgroup it empties is never delivered).  It cannot
    be combined with a cache.  ``shuffle_row_drop_partitions=N``: each
    rowgroup is read as N work items of about 1/N of its rows each, so a
    shuffle mixes finer.  ``shard_mode``: ``'static'`` (rowgroup ``i`` on
    shard ``i % shard_count`` in every epoch) or ``'epoch'`` (each epoch's
    permutation dealt round-robin to the shards).  ``transform_spec``: a
    ``transform.TransformSpec`` run in the workers on each decoded rowgroup;
    ``schema`` shows its edits.  With a cache and a transform that
    ``transform.transform_cache_info`` finds deterministic, the cache holds
    the transform's output, and ``cache_stats()`` adds ``transform_hits``
    and ``transform_misses``.  A ``decode_placement='device'`` field cannot
    be transformed, nor read by a predicate.

    ``ngram``: an ``ngram.NGram``; the reader yields windows of consecutive
    timesteps formed inside each rowgroup (sorted by its timestamp field)
    after the transform.  A row is one window, ``{offset: namedtuple}``;
    ``iter_batches()`` yields ``'<offset>/<field>'`` columns, or with
    ``stack_timesteps`` one ``(windows, length, ...)`` column a field read at
    every offset (such a reader is columnar only).  It takes no
    ``schema_fields`` (the NGram names its fields), no ``decode_roi``, no
    ``decode_placement='device'``, and no predicate beside
    ``shuffle_row_drop_partitions > 1``.

    ``on_error``: the worker-failure policy (``petastorm_tpu/reader.py:210``).
    ``'raise'`` (default) fails the read on the first worker failure (a
    ``pool.WorkerError`` from the thread pool, the worker's own exception
    from the serial pool).  ``'skip'`` quarantines work items that fail with
    *data* errors (a corrupt file or image, a codec or transform exception)
    and keeps reading; an ``errors.ErrorPolicy`` adds budgets
    (``max_skipped_rowgroups``, ``max_skipped_fraction``; exceeded ->
    ``errors.ErrorBudgetExceededError``).  A skipped item counts in the
    cursor and the stream digest at its position; its rows are missing,
    never duplicated.  An in-worker ``MemoryError`` is retried up to
    ``max_requeue_attempts`` times first.  ``Reader.diagnostics`` and
    ``quarantined_rowgroups`` list what was skipped.

    ``verify_checksums``: verify the Parquet page checksums the writer
    stamps; a corrupt page then fails as a data error.

    A predicate whose fields are all hive partition keys filters rowgroups
    by their directory values before the plan is made, and the workers get
    no predicate (``petastorm_tpu/reader.py:659-681``)."""
    return _make_reader(dataset_url, schema_fields, reader_pool_type, workers_count,
                        results_queue_size, shuffle_row_groups, shuffle_seed,
                        num_epochs, cur_shard, shard_count, decode_placement,
                        deterministic, decode_threads, decode_roi, resume_from,
                        cache_type, cache_location, cache_size_limit,
                        shuffle_row_drop_partitions, predicate, rowgroup_selector, shard_mode,
                        transform_spec, ngram, on_error, verify_checksums,
                        batched_output=False)


def make_batch_reader(dataset_url_or_urls: Union[str, Sequence[str]],
                      schema_fields: Optional[Sequence] = None,
                      reader_pool_type: str = "thread",
                      workers_count: Union[int, str] = 4,
                      results_queue_size: Optional[int] = None,
                      shuffle_row_groups: bool = True,
                      shuffle_seed: Optional[int] = None,
                      num_epochs: Optional[int] = 1,
                      cur_shard: Optional[int] = None,
                      shard_count: Optional[int] = None,
                      decode_placement: Optional[Mapping[str, str]] = None,
                      deterministic: Optional[str] = "auto",
                      decode_threads: Union[int, str] = "auto",
                      decode_roi: Optional[Mapping[str, tuple]] = None,
                      resume_from: Optional[dict] = None,
                      cache_type: str = "null",
                      cache_location: Optional[str] = None,
                      cache_size_limit: Optional[int] = None,
                      shuffle_row_drop_partitions: int = 1,
                      predicate=None,
                      rowgroup_selector=None,
                      shard_mode: str = "static",
                      transform_spec: Optional[TransformSpec] = None,
                      ngram=None,
                      on_error="raise",
                      verify_checksums: bool = False) -> "Reader":
    """Batch reader: yields one namedtuple of column arrays per rowgroup.
    Plain parquet stores (no stored schema) are read with an inferred schema:
    scalar columns, list-of-scalar columns as ``(None,)`` ``ScalarListCodec``
    fields, and hive partition keys as fields of their discovered type.
    ``dataset_url_or_urls`` is a dataset directory or a list of parquet file
    (or directory) URLs; a list's root is the common directory above any
    ``key=value`` segments, so its partition values and ``_common_metadata``
    are found.  The other arguments as for :func:`make_reader`; ``ngram`` is
    refused, as the JAX package refuses it."""
    return _make_reader(dataset_url_or_urls, schema_fields, reader_pool_type, workers_count,
                        results_queue_size, shuffle_row_groups, shuffle_seed,
                        num_epochs, cur_shard, shard_count, decode_placement,
                        deterministic, decode_threads, decode_roi, resume_from,
                        cache_type, cache_location, cache_size_limit,
                        shuffle_row_drop_partitions, predicate, rowgroup_selector, shard_mode,
                        transform_spec, ngram, on_error, verify_checksums,
                        batched_output=True)


def elastic_resume(states: Sequence[dict]) -> dict:
    """``resume_from`` token for resuming under another shard layout.

    ``states``: every old shard's ``Reader.state_dict()``, ordered by old
    shard index.  Pass the token to ``make_reader(...,
    resume_from=elastic_resume(states), cur_shard=<new>, shard_count=<new>,
    num_epochs=<epochs remaining, counting the partial one>)`` on every new
    shard, with the other plan settings of the checkpointed run.  The
    leftover of the epoch in progress is dealt across the new shards; the
    resumed reader's cursor records the translation, and a cursor taken
    inside the leftover epoch is refused when resumed again.
    """
    return {"elastic": {"states": [dict(s) for s in states]}}


def _validate_decode_placement(decode_placement: Optional[Mapping[str, str]], schema: Schema,
                               read_fields: Sequence[str], transform_spec=None,
                               predicate=None, ngram=None) -> Tuple[List[str], FrozenSet[str]]:
    """The fields to decode on the device and the subset of them in the
    mixed-geometry format (``'device-mixed'``); raises on a placement the
    port does not take.  The checks of ``petastorm_tpu/reader.py:1052-1145``
    for ``'host'``, ``'device'`` and ``'device-mixed'``; ``'auto'`` (the live
    host/device split) is not part of this package yet."""
    device_fields: List[str] = []
    mixed_fields = set()
    for name, place in (decode_placement or {}).items():
        if place == "auto":
            raise PetastormTpuError(
                f"decode_placement[{name!r}]='auto' (the live host/device split) is not part"
                " of this package yet: use 'host', 'device' or 'device-mixed'")
        if place not in ("host", "device", "device-mixed"):
            raise PetastormTpuError(
                f"decode_placement[{name!r}] must be 'host', 'device' or 'device-mixed',"
                f" got {place!r}")
        if name not in schema:
            raise PetastormTpuError(f"decode_placement field {name!r} not in"
                                    f" schema {list(schema.fields)}")
        if place == "host":
            continue
        field = schema[name]
        if is_sequence_field(field):
            raise PetastormTpuError(
                f"decode_placement field {name!r} is a variable-length"
                f" sequence field (shape {field.shape}, codec {field.codec!r}):"
                " device decode placement is for jpeg image columns (the worker"
                " ships coefficient planes). Token columns decode host-side;"
                " deliver them through petastorm_tpu_torch.sequence (packing +"
                " CudaDataLoader).")
        codec = field.codec
        if not (isinstance(codec, CompressedImageCodec) and codec.image_codec == "jpeg"):
            raise PetastormTpuError(
                f"decode_placement={place!r} requires a jpeg CompressedImageCodec field;"
                f" {name!r} has {type(codec).__name__}"
                + (f"({codec.image_codec})" if isinstance(codec, CompressedImageCodec) else "")
                + ". PNG's deflate stream cannot be entropy-split for decode on the"
                " device - store images as jpeg for device decode.")
        if place == "device" and not field.is_fixed_shape:
            raise PetastormTpuError(
                f"decode_placement='device' field {name!r} needs a fixed shape (got"
                f" {field.shape}): a batch is decoded in one launch of one geometry. For"
                " mixed-geometry datasets use decode_placement='device-mixed'")
        if len(field.shape) not in (2, 3) or (len(field.shape) == 3
                                              and field.shape[2] not in (1, 3)):
            raise PetastormTpuError(
                f"decode_placement={place!r} field {name!r} must be (H, W), (H, W, 1) or"
                f" (H, W, 3); got {field.shape}")
        if ngram is not None:
            raise PetastormTpuError(
                f"decode_placement={place!r} is not supported with ngram readers")
        if transform_spec is not None:
            raise PetastormTpuError(
                f"decode_placement={place!r} cannot be combined with a"
                " transform_spec: the transform would see raw jpeg bytes, not"
                " pixels. Decode on host, or transform on device after the"
                " loader.")
        if predicate is not None and name in predicate.get_fields():
            raise PetastormTpuError(
                f"predicate field {name!r} uses decode_placement={place!r}:"
                " the predicate would see coefficient planes, not pixels."
                " Decode it on host, or predicate on other fields.")
        if name not in read_fields:
            raise PetastormTpuError(
                f"decode_placement={place!r} field {name!r} is not being read (excluded by"
                " schema_fields); drop it from decode_placement or add it to schema_fields")
        device_fields.append(name)
        if place == "device-mixed":
            mixed_fields.add(name)
    if device_fields:
        # the entropy half's library: a missing g++ or libjpeg raises here,
        # not in the first worker
        native_image.load()
    return device_fields, frozenset(mixed_fields)


_ROI_MODES = ("center", "random")


def _normalize_roi_spec(name: str, spec) -> tuple:
    """Validate/normalize one decode_roi entry; returns the spec tuple."""
    spec = tuple(spec)
    if len(spec) == 3 and spec[0] in _ROI_MODES:
        mode, h, w = spec
        if not (isinstance(h, int) and isinstance(w, int) and h > 0 and w > 0):
            raise PetastormTpuError(
                f"decode_roi[{name!r}]: ({mode!r}, h, w) needs positive int"
                f" crop dims; got {spec}")
        return spec
    if len(spec) == 4 and all(isinstance(v, int) for v in spec):
        y, x, h, w = spec
        if y < 0 or x < 0 or h < 1 or w < 1:
            raise PetastormTpuError(
                f"decode_roi[{name!r}]: (y, x, h, w) needs y, x >= 0 and"
                f" h, w >= 1; got {spec}")
        return spec
    raise PetastormTpuError(
        f"decode_roi[{name!r}] must be (y, x, h, w), ('center', h, w) or"
        f" ('random', h, w); got {spec!r}")


def _roi_crop_hw(spec: tuple) -> tuple:
    return (spec[1], spec[2]) if spec[0] in _ROI_MODES else (spec[2], spec[3])


def _validate_decode_roi(decode_roi, schema: Schema, read_fields, decode_placement,
                        ngram=None) -> None:
    """The checks of ``petastorm_tpu/reader.py:988`` that apply to the port,
    with the same messages."""
    if ngram is not None:
        raise PetastormTpuError("decode_roi is not supported with ngram"
                                " readers")
    for name, spec in decode_roi.items():
        spec = _normalize_roi_spec(name, spec)
        if name not in schema:
            raise PetastormTpuError(f"decode_roi field {name!r} not in schema"
                                    f" {[f.name for f in schema]}")
        if name not in read_fields:
            raise PetastormTpuError(
                f"decode_roi field {name!r} is not being read (excluded by"
                " schema_fields)")
        if decode_placement and decode_placement.get(name, "host") != "host":
            raise PetastormTpuError(
                f"decode_roi field {name!r} cannot also use decode_placement="
                f"{decode_placement[name]!r}: coefficient planes carry the"
                " full image (crop on-device instead, ops/augment.py)")
        field = schema[name]
        if is_sequence_field(field):
            raise PetastormTpuError(
                f"decode_roi field {name!r} is a variable-length sequence"
                f" field (shape {field.shape}, codec {field.codec!r}):"
                " decode_roi is a partial IMAGE decode and does not apply to"
                " token columns. Filter documents with a predicate (pushed"
                " down before decode) or slice tokens in the packer"
                " (petastorm_tpu_torch.sequence).")
        if not (field.is_fixed_shape and field.dtype == np.dtype("uint8")
                and isinstance(field.codec, CompressedImageCodec)
                and len(field.shape) in (2, 3)):
            raise PetastormTpuError(
                f"decode_roi field {name!r} must be a fixed-shape uint8"
                f" CompressedImageCodec image; got {field.codec!r} shape"
                f" {field.shape} dtype {field.dtype}")
        full_h, full_w = field.shape[:2]
        crop_h, crop_w = _roi_crop_hw(spec)
        y0 = 0 if spec[0] in _ROI_MODES else spec[0]
        x0 = 0 if spec[0] in _ROI_MODES else spec[1]
        if y0 + crop_h > full_h or x0 + crop_w > full_w:
            raise PetastormTpuError(
                f"decode_roi[{name!r}] crop {spec} exceeds the stored image"
                f" geometry ({full_h}, {full_w})")


def _apply_roi_schema(schema: Schema, decode_roi) -> Schema:
    """Crop-shaped view of ``schema``: decode_roi fields' leading (H, W)
    become the crop dims (what the delivered columns actually are)."""
    fields = []
    for f in schema:
        spec = decode_roi.get(f.name)
        if spec is not None:
            f = dataclasses.replace(f, shape=_roi_crop_hw(spec) + tuple(f.shape[2:]))
        fields.append(f)
    return Schema(schema.name, fields)


def _usable_cores() -> int:
    """Cores this process may run on (affinity-aware)."""
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:
        return os.cpu_count() or 1


def _size_pool(workers_count, decode_threads) -> tuple:
    """``(workers, decode_threads)`` with ``'auto'`` resolved as the JAX
    reader does: one core left for the consumer and at most 10 workers;
    each worker's decode fans out over its share of the cores."""
    cores = _usable_cores()
    if workers_count == "auto":
        workers_count = max(1, min(10, cores - 1))
    if decode_threads == "auto":
        decode_threads = max(1, cores // max(1, int(workers_count)))
    return int(workers_count), int(decode_threads)


def _make_reader(dataset_url, schema_fields, reader_pool_type, workers_count,
                 results_queue_size, shuffle_row_groups, shuffle_seed, num_epochs,
                 cur_shard, shard_count, decode_placement, deterministic, decode_threads,
                 decode_roi, resume_from, cache_type, cache_location, cache_size_limit,
                 shuffle_row_drop_partitions, predicate, rowgroup_selector, shard_mode,
                 transform_spec, ngram, on_error, verify_checksums,
                 batched_output) -> "Reader":
    if num_epochs is not None and num_epochs < 1:
        raise PetastormTpuError("num_epochs must be >= 1 or None (infinite)")
    if ngram is not None and batched_output:
        raise PetastormTpuError(
            "NGram is not supported by make_batch_reader (reference parity,"
            " arrow_reader_worker.py:104); use make_reader")
    if ngram is not None and schema_fields is not None:
        raise PetastormTpuError(
            "schema_fields and ngram are mutually exclusive: the NGram spec"
            " already defines the fields read at each timestep offset")
    if (ngram is not None and predicate is not None
            and shuffle_row_drop_partitions > 1):
        raise PetastormTpuError(
            "ngram + predicate + shuffle_row_drop_partitions > 1 is not"
            " supported: the lookahead rows borrowed across a partition"
            " boundary are computed before the predicate masks rows, so"
            " windows spanning masked rows would be silently lost. Use"
            " shuffle_row_drop_partitions=1.")
    error_policy = resolve_error_policy(on_error)
    deterministic = resolve_deterministic(deterministic, shuffle_seed)
    # one analysis walk a reader: the worker's cache signature and
    # output-caching verdict both come from this triple
    tf_cache_info = transform_cache_info(transform_spec)
    info = open_dataset(dataset_url, require_stored_schema=not batched_output)
    full_schema = infer_or_load_schema(info)
    # a predicate over partition keys alone filters rowgroups by their path
    # values before the plan is made; the workers then get none
    worker_predicate = (None if predicate is not None and _partition_predicate(predicate, info)
                        else predicate)
    view = full_schema.view(schema_fields) if schema_fields is not None else full_schema
    if decode_roi:
        _validate_decode_roi(decode_roi, full_schema, [f.name for f in view], decode_placement,
                             ngram)
        # the delivered columns are crop-shaped; the worker keeps the full
        # schema (it needs the stored geometry to place the crops)
        view = _apply_roi_schema(view, decode_roi)
    schema = transform_schema(view, transform_spec) if transform_spec is not None else view
    ngram_schema = None
    if ngram is not None:
        # the NGram selects its fields from the post-transform full schema;
        # only the stored ones are read (``petastorm_tpu/reader.py:641-649``)
        ngram_schema = (transform_schema(full_schema, transform_spec)
                        if transform_spec is not None else full_schema)
        required = ngram.required_fields(ngram_schema)
        view = full_schema.view([n for n in required if n in full_schema])
        schema = ngram_schema
    read_fields = [f.name for f in view]
    device_fields, mixed_fields = _validate_decode_placement(
        decode_placement, full_schema, read_fields, transform_spec, worker_predicate, ngram)
    if any(native_decodable(full_schema[f]) for f in read_fields if f not in device_fields):
        # the batched decode's library: a missing g++, libjpeg or libpng
        # raises here, not in the first worker
        native_image.load_decoder()
    row_groups = info.row_groups
    if rowgroup_selector is not None:
        selected = rowgroup_selector.select_row_groups(get_row_group_indexes(info))
        row_groups = [rg for rg in row_groups if rg.global_index in selected]
        if not row_groups:
            raise NoDataAvailableError("Rowgroup selector selected no rowgroups")
    if worker_predicate is None and predicate is not None:
        row_groups = _push_down(predicate, row_groups, full_schema)
    plan_kwargs = dict(shuffle_row_groups=shuffle_row_groups, shuffle_seed=shuffle_seed,
                       shuffle_row_drop_partitions=shuffle_row_drop_partitions,
                       shard_mode=shard_mode)
    if resume_from is not None and "elastic" in resume_from:
        # the old shards' cursors determine the leftover of the epoch in
        # progress; every other plan setting (the selector and the
        # predicate too) must be the checkpointed run's
        plan = elastic_resume_plan(
            row_groups, resume_from["elastic"]["states"],
            new_shard_index=cur_shard if cur_shard is not None else 0,
            new_shard_count=shard_count if shard_count is not None else 1, **plan_kwargs)
    else:
        plan = ReadPlan(row_groups, shard_index=cur_shard, shard_count=shard_count,
                        **plan_kwargs)
        if not plan.epoch_items(0):
            raise NoDataAvailableError(f"No rowgroups to read in {dataset_url!r}")
    if cache_type not in (None, "null", "none") and worker_predicate is not None:
        # a cached rowgroup would hold the rows of one predicate (reference
        # py_dict_reader_worker.py:145-150)
        raise PetastormTpuError("cache_type cannot be combined with a predicate")
    start_item, digest_state = 0, None
    if resume_from is not None and "elastic" not in resume_from:
        # the digest chain continues across the split (an elastic resume
        # deals several old shards' leftovers: it starts a fresh chain)
        digest_state = resume_from.get("stream_digest")
        if "elastic_rebased" in resume_from:
            # a cursor of an elastically resumed reader: its rebased
            # coordinates translated back to this plan's item stream
            start_item, base_ipe = resolve_cursor(resume_from)
            plan_ipe = len(plan.epoch_items(0))
            if plan_ipe != base_ipe:
                raise PetastormTpuError(
                    f"cursor was taken under a layout with {base_ipe}"
                    f" items/epoch but this reader's plan has {plan_ipe};"
                    " shard count or plan settings differ - use"
                    " elastic_resume() with every shard's state instead")
        else:
            start_item = int(resume_from.get("position", 0))
    if results_queue_size is None:
        results_queue_size = _DEFAULT_RESULTS_QUEUE_BATCHES
    workers_count, decode_threads = _size_pool(workers_count, decode_threads)
    cache = make_cache(cache_type, cache_location, cache_size_limit)
    # raise mode takes the default pool; a skip policy's keeps running past
    # a failure, so the reader can quarantine the item (``:832-852``)
    executor = make_executor(reader_pool_type, workers_count, results_queue_size,
                             **({} if error_policy is None else dict(
                                 stop_on_failure=False,
                                 max_requeue_attempts=error_policy.max_requeue_attempts)))
    worker = RowGroupDecoderWorker(full_schema, read_fields, device_fields,
                                   mixed_fields=mixed_fields, decode_threads=decode_threads, decode_roi=decode_roi,
                                   cache=cache, dataset_url=_url_key(dataset_url),
                                   predicate=worker_predicate, transform=transform_spec,
                                   transform_cache_info=tf_cache_info,
                                   ngram=ngram, ngram_schema=ngram_schema,
                                   verify_checksums=verify_checksums)
    return Reader(schema, plan, executor, worker, num_epochs, batched_output, device_fields,
                  deterministic=deterministic, shuffle_seed=shuffle_seed,
                  start_item=start_item, digest_state=digest_state, ngram=ngram,
                  error_policy=error_policy, declared_geometries=declared_geometries(info),
                  device_decode_mixed=mixed_fields, dataset_info=info)


def _url_key(url_or_urls) -> str:
    """The dataset's identity in cache keys: its URL, or its URL list."""
    return url_or_urls if isinstance(url_or_urls, str) else "\n".join(url_or_urls)


def _partition_predicate(predicate, info) -> bool:
    """True when every field of ``predicate`` is a hive partition key."""
    fields = set(predicate.get_fields())
    return bool(fields) and fields <= set(info.partition_keys)


def _push_down(predicate, row_groups, schema: Schema) -> list:
    """The rowgroups whose partition values ``predicate`` keeps
    (``petastorm_tpu/reader.py:659-681``).  Path values are strings; a
    field of a numeric type gets its dtype back, so the predicate sees the
    values the worker would deliver."""
    fields = set(predicate.get_fields())
    kept = []
    for rg in row_groups:
        pvals = dict(rg.partition_values)
        cols = {}
        for name in fields:
            value = pvals[name]
            field = schema[name] if name in schema else None
            if field is not None and field.dtype.kind not in ("U", "S", "O"):
                value = field.dtype.type(value)
            cols[name] = np.asarray([value], dtype=object)
        if bool(predicate.do_include_vectorized(cols)[0]):
            kept.append(rg)
    if not kept:
        raise NoDataAvailableError("Predicate filtered out all partitions")
    return kept


class Reader:
    """Iterates decoded data of one plan through one executor.

    Iterate rows (or per-rowgroup batches with ``batched_output``), or call
    :meth:`iter_batches` for raw ColumnBatches; do not mix the two on one
    reader.  A context manager: leaving it stops the workers.

    ``ngram`` is the reader's ``ngram.NGram`` (None for other readers);
    ``output_schema`` is the schema of the batches ``iter_batches`` yields:
    ``schema``, or the NGram's window columns.  ``last_row_consumed``
    turns true once the last row (or batch) of a finite stream is out.
    """

    def __init__(self, schema: Schema, plan: ReadPlan, executor, worker,
                 num_epochs: Optional[int], batched_output: bool,
                 device_decode_fields: Sequence[str] = (), deterministic: str = "off",
                 shuffle_seed: Optional[int] = None, start_item: int = 0,
                 digest_state: Optional[dict] = None, ngram=None,
                 error_policy: Optional[ErrorPolicy] = None,
                 declared_geometries: Optional[dict] = None,
                 device_decode_mixed: FrozenSet[str] = frozenset(),
                 dataset_info=None):
        if start_item < 0:
            raise PetastormTpuError("start_item must be >= 0")
        #: the opened dataset (``etl.metadata.DatasetInfo``): files, rowgroups,
        #: the stored schema (``petastorm_tpu/reader.py:1192``)
        self.dataset_info = dataset_info
        self.schema = schema
        self.ngram = ngram
        self.output_schema = schema
        if ngram is not None:
            self._ngram_views = ngram.resolve_schema(schema)
            self._ngram_types = ngram.make_namedtuple_types(schema)
            self.output_schema = ngram.output_schema(schema)
        #: ``'seed'`` or ``'off'`` (``make_reader``'s ``deterministic``, resolved)
        self.deterministic = deterministic
        self.shuffle_seed = shuffle_seed
        self.plan = plan
        self.num_epochs = num_epochs
        self.batched_output = batched_output
        self._executor = executor
        self._executor.start(worker)
        self._batches: Optional[Iterator[ColumnBatch]] = None
        self._rows: Iterator = iter(())
        self._rows_left = 0
        #: an ngram reader's current batch of windows and the next one's index
        self._windows: Optional[ColumnBatch] = None
        self._window_pos = 0
        self.last_row_consumed = False
        self._namedtuple_type = schema.make_namedtuple_type()
        self._stopped = False
        #: fields read with decode_placement='device': their batches carry
        #: coefficient planes, which only cuda.CudaDataLoader finishes
        self.device_decode_fields: List[str] = list(device_decode_fields)
        #: the subset in the mixed-geometry object format ('device-mixed'),
        #: decoded a geometry bucket at a time (``reader.py:900-901``)
        self.device_decode_mixed: FrozenSet[str] = frozenset(device_decode_mixed)
        self._worker = worker
        #: cursor: the pool delivers in plan order, so the items consumed
        #: are exactly the prefix [0, start_item + consumed) of the stream
        self._start_item = start_item
        self._consumed_items = 0
        self._items_per_epoch = len(plan.epoch_items(0))
        self._epoch_items_cache: dict = {}
        self._digest = StreamDigest(digest_state)
        #: items this reader delivers (None: it reads forever)
        self._expected_items = (None if num_epochs is None else
                                max(plan.total_items(num_epochs) - start_item, 0))
        #: resolved ``on_error`` policy (None: raise mode)
        self._error_policy = error_policy
        #: quarantine ledger: one entry per skipped work item
        self._quarantine: List[dict] = []
        self._declared_geometries = dict(declared_geometries or {})

    def decode_stats(self) -> dict:
        """The native decode counters (``batch_calls``, ``batch_images``,
        ``roi_calls``, ``roi_images``, ``coef_batch_calls``,
        ``coef_batch_images``) summed over every rowgroup the workers
        decoded so far: the proof that image columns took the batched path."""
        return self._worker.decode_stats()

    def cache_stats(self) -> dict:
        """The rowgroup cache's ``hits`` and ``misses`` (and, for
        ``cache_type='memory'``, the ``entries`` and estimated ``bytes``
        resident); zeros without a cache.  A reader with a
        ``transform_spec`` adds ``transform_hits`` and ``transform_misses``,
        the lookups of cached transform output."""
        return {**self._worker.cache.stats(), **self._worker.transform_cache_stats()}

    def _items(self) -> Iterator[WorkItem]:
        """The item stream from ``start_item``: whole epochs skipped, then an
        offset into the first (``petastorm_tpu/pool.py:2203``)."""
        ipe = self._items_per_epoch
        epoch, offset = divmod(self._start_item, ipe) if ipe > 0 else (0, 0)
        while self.num_epochs is None or epoch < self.num_epochs:
            yield from self.plan.epoch_items(epoch)[offset:]
            offset = 0
            epoch += 1

    def _next_batch(self) -> ColumnBatch:
        if self._stopped:
            raise ReaderClosedError("Reader is stopped")
        if self._batches is None:
            self._batches = self._executor.imap(self._items(), start=self._start_item)
        while True:
            try:
                batch = next(self._batches)
            except StopIteration:
                if self._all_items_consumed():
                    self.last_row_consumed = True
                raise
            ordinal = self._start_item + self._consumed_items
            if isinstance(batch, WorkerError):
                # a skip policy's pool yields the failure at its position
                self._skip_or_raise(batch, ordinal)
                continue
            self._digest_deliver(ordinal, batch)
            self._consumed_items += 1
            # a rowgroup the predicate emptied counts in the cursor and the
            # digest and is never delivered (``petastorm_tpu/reader.py:1686``)
            if batch.num_rows:
                if self.batched_output and self._all_items_consumed():
                    # the row path flags only once its last row is out
                    self.last_row_consumed = True
                return batch

    def _all_items_consumed(self) -> bool:
        return (self._expected_items is not None
                and self._consumed_items >= self._expected_items)

    # -- cursor and stream certificate --------------------------------------

    def _locate_ordinal(self, ordinal: int):
        """(epoch, index within it) of an absolute item ordinal."""
        plan = self.plan
        if isinstance(plan, ElasticResumePlan):
            leftover = plan.leftover_len
            if ordinal < leftover:
                return 0, ordinal
            ipe = plan.base_items_per_epoch
            if ipe <= 0:
                return 0, ordinal
            return 1 + (ordinal - leftover) // ipe, (ordinal - leftover) % ipe
        ipe = self._items_per_epoch
        if ipe <= 0:
            return 0, ordinal
        return ordinal // ipe, ordinal % ipe

    def _work_item_for(self, ordinal: int):
        """(epoch, WorkItem or None) behind an absolute ordinal, recomputed
        from the plan (two epochs of items cached)."""
        epoch, idx = self._locate_ordinal(ordinal)
        items = self._epoch_items_cache.get(epoch)
        if items is None:
            while len(self._epoch_items_cache) >= 2:
                self._epoch_items_cache.pop(min(self._epoch_items_cache))
            items = self._epoch_items_cache[epoch] = self.plan.epoch_items(epoch)
        return epoch, (items[idx] if 0 <= idx < len(items) else None)

    def _digest_deliver(self, ordinal: int, batch: ColumnBatch) -> None:
        """Fold one delivered batch into the stream certificate."""
        epoch, item = self._work_item_for(ordinal)
        if item is not None:
            start, stop = item.row_slice()
            self._digest.record_batch(epoch, ordinal, item.row_group.global_index,
                                      item.row_group.row_group, start, stop, batch.num_rows)
        else:
            self._digest.record_batch(epoch, ordinal, -1, -1, 0, 0, batch.num_rows)

    def _skip(self, ordinal: int) -> None:
        """Fold one policy-skipped work item into the stream certificate and
        the cursor (``petastorm_tpu/reader.py:1681``)."""
        epoch, item = self._work_item_for(ordinal)
        self._digest.record_skip(epoch, ordinal,
                                 item.row_group.global_index if item is not None else -1,
                                 item.row_group.row_group if item is not None else -1)
        self._consumed_items += 1

    def _skip_or_raise(self, exc: WorkerError, ordinal: int) -> None:
        """Quarantine a worker failure a skip policy's pool yielded
        (``petastorm_tpu/reader.py:1801-1880``); an unattributable one
        propagates, after ``stop()``.  A skipped item counts in the cursor and the digest
        at its plan position, so the epoch ends at the same count with the
        quarantined rows missing - never duplicated."""
        if exc.item is None:  # the item source failed: nothing to skip
            self.stop()
            raise exc
        policy = self._error_policy
        rg = exc.item.row_group
        entry = {"ordinal": exc.ordinal, "path": rg.path, "row_group": rg.row_group,
                 "kind": exc.kind, "exc_type": exc.exc_type,
                 # last traceback line: the remote exception's message
                 "error": str(exc).splitlines()[-1]}
        self._quarantine.append(entry)
        logger.warning("Skipping work item %s (rowgroup %s#%s) after %s error: %s",
                       exc.ordinal, entry["path"], entry["row_group"], exc.kind,
                       entry["error"])
        # the JAX reader folds a skip at once without a seed, and at its plan
        # position (after the budget check) under deterministic='seed'
        if self.deterministic != "seed":
            self._skip(ordinal)
        skipped = len(self._quarantine)
        over = None
        if (policy.max_skipped_rowgroups is not None
                and skipped > policy.max_skipped_rowgroups):
            over = (f"{skipped} skipped work items exceed"
                    f" max_skipped_rowgroups={policy.max_skipped_rowgroups}")
        if over is None and policy.max_skipped_fraction is not None:
            # a reader with no total (num_epochs=None) divides by the items
            # consumed so far, floored at one epoch: a steady per-epoch
            # corruption rate reads as a steady fraction
            denom = self._expected_items
            if denom is None:
                denom = max(self._items_per_epoch, self._consumed_items)
            if denom and skipped / denom > policy.max_skipped_fraction:
                over = (f"{skipped}/{denom} skipped work items exceed"
                        f" max_skipped_fraction={policy.max_skipped_fraction}")
        if over is not None:
            diag = self.diagnostics  # the snapshot before stop()
            self.stop()
            raise ErrorBudgetExceededError(
                f"Error budget exceeded: {over}. Quarantined rowgroups: "
                + ", ".join(f"{e['path']}#{e['row_group']}" for e in self._quarantine),
                diagnostics=diag) from exc
        if self.deterministic == "seed":
            self._skip(ordinal)

    @property
    def diagnostics(self) -> dict:
        """Items per epoch, consumed and expected, the stream digest, the
        infra retries of the pool and the fault ledger: the skip count and
        the last 20 quarantine entries (``petastorm_tpu/reader.py:2113-2132``;
        :attr:`quarantined_rowgroups` has them all)."""
        return {"items_per_epoch": self._items_per_epoch,
                "consumed_items": self._consumed_items,
                "expected_items": self._expected_items,
                "deterministic": self.deterministic,
                "stream_digest": self._digest.summary(),
                "requeued_items": self._executor.requeued_items,
                "skipped_rowgroups": len(self._quarantine),
                "quarantined_rowgroups": list(
                    self._quarantine[-_DIAGNOSTICS_QUARANTINE_TAIL:])}

    @property
    def quarantined_rowgroups(self) -> list:
        """Skipped-work-item ledger under an ``on_error`` skip policy: one
        dict per skip (ordinal, path, row_group, kind, exc_type, error)."""
        return list(self._quarantine)

    @property
    def declared_geometries(self) -> dict:
        """{field: [shape tuples]} stamped at write time, or {}: the
        dataset-level geometry contract (``etl.metadata.declared_geometries``)."""
        return dict(self._declared_geometries)

    @property
    def stream_digest(self) -> dict:
        """The stream certificate so far (``StreamDigest.summary()``): crc
        chains per epoch and combined over the delivered work items and batch
        boundaries.  Two readers of the same plan that delivered the same
        items give the same value, whatever their worker counts."""
        return self._digest.summary()

    def quiesce(self) -> int:
        """Issue no further work item; the issued ones still deliver, and
        iteration ends after the last of them.  ``state_dict()`` is then an
        exact cursor once the stream is consumed: resuming re-reads no row.
        Returns the absolute ordinal the stream stops at."""
        return self._executor.quiesce(self._start_item)

    def state_dict(self) -> dict:
        """Work-item cursor for ``make_reader(..., resume_from=state)``.

        ``position`` counts the items delivered, a prefix of the item stream
        (the pool delivers in plan order).  Under a loader it can run ahead
        of the batches the loader delivered by the loader's in-flight window;
        ``loader.drain()`` makes it exact.  ``ordinal_exact`` is always true
        here (the JAX reader's is false when a transport dropped the
        ordinals).  ``stream_digest`` is the chain state a resume continues.
        """
        state = {"position": self._start_item + self._consumed_items,
                 "items_per_epoch": self._items_per_epoch,
                 "ordinal_exact": True,
                 "stream_digest": self._digest.state()}
        if isinstance(self.plan, ElasticResumePlan):
            # rebased coordinates: the translation lets this cursor resume
            # (plainly or elastically) once past the leftover epoch
            state["elastic_rebased"] = {
                "leftover_len": self.plan.leftover_len,
                "resume_epoch": self.plan.resume_epoch,
                "base_items_per_epoch": self.plan.base_items_per_epoch,
            }
        return state

    # -- epoch control ------------------------------------------------------

    def reset(self) -> None:
        """Read the stream again from its first item, with a fresh cursor and
        stream digest (``petastorm_tpu/reader.py:1885``): a reset run equals
        a fresh reader's.  Only legal once the stream is consumed; mid-stream
        it raises ``EpochNotFinishedError``, as in-flight items would leak
        into the next pass."""
        if self._stopped:
            raise ReaderClosedError("Reader is stopped")
        if not self._all_items_consumed():
            raise EpochNotFinishedError(
                "reset() called mid-epoch: in-flight work items would leak into"
                " the next epoch. Consume the iterator fully first.")
        self._start_item = 0
        self._consumed_items = 0
        self._expected_items = self.plan.total_items(self.num_epochs)
        self._epoch_items_cache.clear()
        self._digest = StreamDigest()
        self._batches = None
        self._rows = iter(())
        self._rows_left = 0
        self._windows = None
        self._window_pos = 0
        self.last_row_consumed = False

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
        if self.device_decode_fields:
            # the workers shipped coefficient planes for these fields; yielding
            # here would hand out planes where the schema promises pixels
            raise PetastormTpuError(
                f"fields {self.device_decode_fields} use decode placement on the device: their"
                " batches carry JPEG coefficient planes, not pixels. Consume this reader"
                " through petastorm_tpu_torch.cuda.CudaDataLoader (which finishes the"
                " decode on the device), or use decode_placement='host' for row access.")
        if self.batched_output:
            batch = self._next_batch()
            return self._namedtuple_type(**{n: batch.columns[n] for n in self.schema.fields})
        if self.ngram is not None:
            return self._next_window()
        for row in self._rows:
            self._rows_left -= 1
            if not self._rows_left and self._all_items_consumed():
                self.last_row_consumed = True
            return row
        batch = self._next_batch()
        cols = batch.columns
        self._rows = map(self._namedtuple_type._make,
                         zip(*[cols[n] for n in self.schema.fields]))
        self._rows_left = batch.num_rows
        return next(self)

    def _next_window(self) -> dict:
        """One window as ``{offset: namedtuple}`` (``petastorm_tpu/reader.py:1436-1451``)."""
        if self._windows is None or self._window_pos >= self._windows.num_rows:
            self._windows = self._next_batch()
            self._window_pos = 0
        pos = self._window_pos
        self._window_pos += 1
        if self._window_pos >= self._windows.num_rows and self._all_items_consumed():
            self.last_row_consumed = True
        if self.ngram.stack_timesteps:
            raise PetastormTpuError(
                "stack_timesteps NGram readers are columnar-only: use"
                " iter_batches() or the jax loader")
        return self.ngram.row(self._ngram_views, self._ngram_types, self._windows, pos)

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
