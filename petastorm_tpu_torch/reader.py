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
is pushed down to the partitions (``:659-681``).  Remote stores are read
through ``fs.py`` with ``io_retries`` and one ranged read a rowgroup
(``worker.py``, ``io_window.py``).  Liveness
(``item_deadline_s``, ``hedge_after_s``) and the stall watchdog
(``stall_warn_s``, ``stall_abort_s``, ``:1470-1580``) guard the pools
against hung and straggling workers; ``reader_pool_type='process'`` runs
the workers as spawned processes over a shared-memory transport
(``pool.ProcessExecutor``); ``chaos`` injects faults for tests
(``test_util.chaos``).  ``telemetry`` observes the whole pipeline, with a
sampler, a localhost metrics endpoint and a flight recorder
(``telemetry/``, ``:1179-1396``); ``autotune`` (implied by
``workers_count='auto'``) runs the static planner (``planner.py``) and then
the runtime controller (``autotune.py``); ``cache_type='shared'`` is the
host-wide warm tier (``cache_shared.py``); ``decode_placement='auto'`` is
the live host/device decode split (``:715-731``, ``:2015-2060``).  The
ingest service is not part of this package yet (ROADMAP.md queue A item
11).
"""

from __future__ import annotations

import dataclasses
import logging
import multiprocessing
import os
import shutil
import time
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
from petastorm_tpu_torch.fs import FilesystemFactory, get_filesystem_and_path
from petastorm_tpu_torch.native import image as native_image
from petastorm_tpu_torch.plan import (ElasticResumePlan, ReadPlan, WorkItem, elastic_resume_plan,
                                      resolve_cursor)
from petastorm_tpu_torch.pool import (PipelineStallError, SerialExecutor, WorkerError,
                                      env_seconds, make_executor)
from petastorm_tpu_torch.retry import make_circuit_breaker, resolve_retry_policy
from petastorm_tpu_torch.schema import Schema
from petastorm_tpu_torch.seeding import StreamDigest, resolve_deterministic
from petastorm_tpu_torch.sequence.dataset import is_sequence_field
from petastorm_tpu_torch.telemetry import dominant_stage
from petastorm_tpu_torch.telemetry import resolve as _resolve_telemetry
from petastorm_tpu_torch.transform import (TransformSpec, transform_cache_info,
                                           transform_schema)
from petastorm_tpu_torch.worker import RowGroupDecoderWorker

logger = logging.getLogger(__name__)

_DEFAULT_RESULTS_QUEUE_BATCHES = 10
#: stall watchdog defaults; the environment (``PETASTORM_TPU_STALL_WARN_S``,
#: ``PETASTORM_TPU_STALL_ABORT_S``) is read again whenever a reader is made
_STALL_WARN_S = 120.0
_STALL_ABORT_S = 0.0
#: entries of the quarantine ledger ``Reader.diagnostics`` carries (the
#: ``quarantined_rowgroups`` property has them all)
_DIAGNOSTICS_QUARANTINE_TAIL = 20
#: the pool's keys ``Reader.diagnostics`` carries (``petastorm_tpu/pool.py:
#: 555-562``, ``:1275-1301``, ``:2043-2076``)
_POOL_DIAGNOSTICS = ("ventilated", "consumed", "in_queue_size", "reorder_held", "stopped",
                     "results_queue_bound", "workers_retired",
                     "requeued_items", "hung_workers_killed", "hung_workers_abandoned",
                     "hedged_items", "hedge_wins", "workers_busy", "workers_abandoned",
                     "workers_count", "workers_alive", "shm_transport")
#: the process pool's transport counters (``Reader.transport_stats``)
_TRANSPORT_STATS = ("shm_size_bytes", "shm_free_bytes", "shm_high_water_bytes", "shm_batches",
                    "pickled_batches", "slot_columns", "slot_rows", "worker_spawn_s",
                    "worker_rss_bytes")


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
                verify_checksums: bool = False,
                storage_options: Optional[dict] = None,
                filesystem=None,
                io_retries="auto",
                item_deadline_s: Optional[float] = None,
                hedge_after_s=None,
                stall_warn_s: Optional[float] = None,
                stall_abort_s: Optional[float] = None,
                chaos=None,
                telemetry=None,
                metrics_port: Optional[int] = None,
                flight_record_path: Optional[str] = None,
                sample_interval_s: Optional[float] = None,
                autotune=None,
                trace_items=None) -> "Reader":
    """Row reader for datasets that carry a stored schema: yields one
    namedtuple per row; ``iter_batches()`` yields whole decoded rowgroups
    (the loader's path).  ``num_epochs=None`` reads forever.

    ``decode_placement``: field -> ``'host'``, ``'device'``,
    ``'device-mixed'`` or ``'auto'``.  A ``'device'`` field (a fixed-shape JPEG image of
    one geometry) is entropy-decoded in the workers and finished on the card
    by ``cuda.CudaDataLoader``; such a reader is consumed through that loader
    only.  A ``'device-mixed'`` field may mix JPEG sizes and subsamplings and
    may declare wildcard dims (``(None, None, 3)``): its rows travel as
    object cells (``native.image.pack_coef_columns_mixed``) and the loader
    decodes each geometry bucket of a batch in one B2 launch and fits it to
    one target shape (the schema's, else one ``pad_shapes`` entry).  An
    ``'auto'`` field (fixed shape, as ``'device'``) is the live host/device
    split: each rowgroup ships the coefficient planes or the decoded pixels,
    as the reader's split cell says when a worker takes it (``'device'`` at
    start, or the planner's profile); ``Reader.set_decode_split`` moves it,
    and so does an armed autotune controller.  The loader assembles the two
    forms apart, so no batch mixes them.

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
    ``'shared'`` is the host-wide warm tier (``cache_shared.SharedWarmCache``):
    decoded rowgroups in a shared-memory arena that every worker, reader and
    job on the host naming the same ``cache_location`` (default
    ``<tmp>/petastorm_tpu_torch_warm``) hits, over a disk tier;
    ``cache_size_limit`` sizes the arena (default 256 MiB).  It raises when
    the arena's library cannot be built.

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
    no predicate (``petastorm_tpu/reader.py:659-681``).

    ``storage_options`` / ``filesystem``: how the URL's filesystem is
    resolved (``fs.get_filesystem_and_path``: GCS, S3, HDFS, fsspec, or a
    filesystem of the caller's, used as is).  ``io_retries``: the transient
    remote-IO policy (``retry.resolve_retry_policy``): ``'auto'`` retries
    with backoff on any filesystem that is not local and arms the shared
    circuit breaker (``reader.circuit_breaker``), an int sets the attempt
    budget, a ``RetryPolicy`` customizes it, ``None`` disables it
    (``:713-738``).  ``io_stats()`` counts the retries and the ranged reads
    a rowgroup cost.

    ``reader_pool_type``: ``'thread'`` (default), ``'process'`` or
    ``'serial'``.  ``'process'`` spawns ``workers_count`` worker processes
    (they import no ``torch``) whose result batches travel through a
    shared-memory arena sized to hold the ``workers_count +
    results_queue_size`` rowgroups in flight and four more the consumer may
    still hold (``_arena_bytes``); a batch that finds it full for 10 s
    travels pickled (``transport_stats()['pickled_batches']``).  A
    host-decoded image column is decoded straight into the arena.  It raises
    when the arena's library cannot be built.  Under it ``decode_stats()``,
    ``io_stats()`` and ``cache_stats()`` count this process's work only
    (none): the workers count theirs in their own processes.

    ``item_deadline_s`` / ``hedge_after_s``: the liveness layer
    (``petastorm_tpu/reader.py:222-233``).  An item that gives no result for
    ``item_deadline_s`` gets its worker SIGKILLed and respawned (process
    pool) or its slot abandoned (thread pool), and is requeued through the
    ``on_error`` requeue budget; an item that hangs every attempt ends as a
    data error, which a skip policy quarantines.  ``hedge_after_s`` re-issues
    an item busy for that many seconds to an idle worker, first result wins;
    ``'auto'`` is 4x the p99 of the recorded decode latency, at least 0.5 s,
    once 20 decodes are recorded here (nothing before that, without
    telemetry, or under the process pool, whose decodes are recorded in its
    workers).  Both
    do nothing on the serial pool.  ``diagnostics`` counts
    ``requeued_items``, ``hung_workers_killed``, ``hung_workers_abandoned``,
    ``hedged_items`` and ``hedge_wins``.

    ``stall_warn_s`` / ``stall_abort_s``: the stall watchdog.  When no result
    arrives for ``stall_warn_s`` seconds (default 120) a warning names the
    busy workers and their items; past ``stall_abort_s`` (default 0, off)
    the reader stops and raises ``pool.PipelineStallError`` carrying its
    ``diagnostics``.  None reads ``PETASTORM_TPU_STALL_WARN_S`` /
    ``PETASTORM_TPU_STALL_ABORT_S``; 0 disables.  The serial pool cannot
    abort (its work runs inline) and warns from its own watchdog.

    ``chaos``: a ``test_util.chaos.ChaosSpec``, deterministic fault injection
    for tests; its worker faults wrap the worker (``ChaosWorker``) and its
    filesystem faults the dataset's filesystem (``latency_fs``).

    ``telemetry``: a ``telemetry.Telemetry`` recorder for the whole pipeline
    (None: the process default when ``PETASTORM_TPU_TELEMETRY=1``, else the
    no-op recorder), ``Reader.telemetry``.  ``metrics_port`` serves the
    Prometheus text on localhost (0: any free port, ``reader.metrics_server.
    port``; ``PETASTORM_TPU_METRICS_PORT``), ``flight_record_path`` writes
    the sampled series and the trace tail on a terminal failure
    (``PETASTORM_TPU_FLIGHT_RECORD``), ``sample_interval_s`` sets the
    sampler's cadence (``PETASTORM_TPU_SAMPLE_INTERVAL_S``, 1 s; <= 0 stops
    it).  Any of them, ``autotune`` or a positive ``sample_interval_s``
    makes a private recorder when none is enabled.  ``trace_items`` is the
    ingest service's per-item tracing and raises without it.

    ``autotune``: ``True``, an ``autotune.AutotunePolicy``, or ``False``;
    None arms it for ``workers_count='auto'`` only.  The planner seeds the
    worker count, decode fan-out, results bound, loader prefetch, the shared
    tier's residency and the split side from the footer and the dataset's
    recorded profile (``Reader.diagnostics['planner']``); the controller
    then moves them from the sampler's queue waits
    (``Reader.diagnostics['autotune']``).  Under ``deterministic='seed'``
    the split is not tuned.  Inoperative on the serial pool."""
    return _make_reader(dataset_url, schema_fields, reader_pool_type, workers_count,
                        results_queue_size, shuffle_row_groups, shuffle_seed,
                        num_epochs, cur_shard, shard_count, decode_placement,
                        deterministic, decode_threads, decode_roi, resume_from,
                        cache_type, cache_location, cache_size_limit,
                        shuffle_row_drop_partitions, predicate, rowgroup_selector, shard_mode,
                        transform_spec, ngram, on_error, verify_checksums,
                        storage_options, filesystem, io_retries, batched_output=False,
                        item_deadline_s=item_deadline_s, hedge_after_s=hedge_after_s,
                        stall_warn_s=stall_warn_s, stall_abort_s=stall_abort_s, chaos=chaos,
                        telemetry=telemetry, metrics_port=metrics_port,
                        flight_record_path=flight_record_path,
                        sample_interval_s=sample_interval_s, autotune=autotune,
                        trace_items=trace_items)


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
                      verify_checksums: bool = False,
                      storage_options: Optional[dict] = None,
                      filesystem=None,
                      io_retries="auto",
                      item_deadline_s: Optional[float] = None,
                      hedge_after_s=None,
                      stall_warn_s: Optional[float] = None,
                      stall_abort_s: Optional[float] = None,
                      chaos=None,
                      telemetry=None,
                      metrics_port: Optional[int] = None,
                      flight_record_path: Optional[str] = None,
                      sample_interval_s: Optional[float] = None,
                      autotune=None,
                      trace_items=None) -> "Reader":
    """Batch reader: yields one namedtuple of column arrays per rowgroup.
    Plain parquet stores (no stored schema) are read with an inferred schema:
    scalar columns, list-of-scalar columns as ``(None,)`` ``ScalarListCodec``
    fields, and hive partition keys as fields of their discovered type.
    ``dataset_url_or_urls`` is a dataset directory or a list of parquet file
    (or directory) URLs; a list's root is the common directory above any
    ``key=value`` segments, so its partition values and ``_common_metadata``
    are found.  The other arguments (telemetry, autotune and the shared tier
    included) as for :func:`make_reader`; ``ngram`` is refused, as the JAX
    package refuses it."""
    return _make_reader(dataset_url_or_urls, schema_fields, reader_pool_type, workers_count,
                        results_queue_size, shuffle_row_groups, shuffle_seed,
                        num_epochs, cur_shard, shard_count, decode_placement,
                        deterministic, decode_threads, decode_roi, resume_from,
                        cache_type, cache_location, cache_size_limit,
                        shuffle_row_drop_partitions, predicate, rowgroup_selector, shard_mode,
                        transform_spec, ngram, on_error, verify_checksums,
                        storage_options, filesystem, io_retries, batched_output=True,
                        item_deadline_s=item_deadline_s, hedge_after_s=hedge_after_s,
                        stall_warn_s=stall_warn_s, stall_abort_s=stall_abort_s, chaos=chaos,
                        telemetry=telemetry, metrics_port=metrics_port,
                        flight_record_path=flight_record_path,
                        sample_interval_s=sample_interval_s, autotune=autotune,
                        trace_items=trace_items)


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
                               predicate=None, ngram=None
                               ) -> Tuple[List[str], FrozenSet[str], FrozenSet[str]]:
    """The fields to decode on the device, the subset of them in the
    mixed-geometry format (``'device-mixed'``) and the subset under the live
    split (``'auto'``); raises on a placement the port does not take (the
    checks of ``petastorm_tpu/reader.py:1052-1145``)."""
    device_fields: List[str] = []
    mixed_fields = set()
    split_fields = set()
    for name, place in (decode_placement or {}).items():
        if place not in ("host", "device", "device-mixed", "auto"):
            raise PetastormTpuError(
                f"decode_placement[{name!r}] must be 'host', 'device',"
                f" 'device-mixed' or 'auto', got {place!r}")
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
        if place in ("device", "auto") and not field.is_fixed_shape:
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
        elif place == "auto":
            split_fields.add(name)
    if device_fields:
        # the entropy half's library: a missing g++ or libjpeg raises here,
        # not in the first worker
        native_image.load()
    return device_fields, frozenset(mixed_fields), frozenset(split_fields)


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
                 storage_options, filesystem, io_retries, batched_output,
                 item_deadline_s=None, hedge_after_s=None, stall_warn_s=None,
                 stall_abort_s=None, chaos=None, telemetry=None, metrics_port=None,
                 flight_record_path=None, sample_interval_s=None, autotune=None,
                 trace_items=None) -> "Reader":
    from petastorm_tpu_torch.autotune import resolve_autotune

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
    if trace_items:
        raise PetastormTpuError(
            "trace_items arms DISTRIBUTED per-item tracing across the"
            " ingest service's processes and needs service_address; local"
            " pools already trace every stage span into the telemetry"
            " trace buffer")
    telemetry = _resolve_telemetry(telemetry)
    deterministic = resolve_deterministic(deterministic, shuffle_seed)
    # None is the default bound; an explicit int, even the default's value,
    # is pinned and the planner never moves it (``petastorm_tpu/reader.py:489``)
    results_queue_pinned = results_queue_size is not None
    if results_queue_size is None:
        results_queue_size = _DEFAULT_RESULTS_QUEUE_BATCHES
    autotune_policy = resolve_autotune(autotune, workers_count, reader_pool_type)
    if (deterministic == "seed" and autotune_policy is not None
            and "decode_split" not in autotune_policy.exclude_knobs):
        # a live split flip changes which form a rowgroup ships by when a
        # worker took it: no seed-stable stream survives it (``:503-514``)
        autotune_policy = dataclasses.replace(
            autotune_policy, exclude_knobs=autotune_policy.exclude_knobs | {"decode_split"})
    if not flight_record_path:
        flight_record_path = os.environ.get("PETASTORM_TPU_FLIGHT_RECORD", "").strip() or None
    if metrics_port is None:
        raw_port = os.environ.get("PETASTORM_TPU_METRICS_PORT", "").strip()
        if raw_port:
            try:
                metrics_port = int(raw_port)
            except ValueError:
                logger.warning("Ignoring non-integer PETASTORM_TPU_METRICS_PORT=%r", raw_port)
    if ((flight_record_path or metrics_port is not None or autotune_policy is not None
         or (sample_interval_s is not None and sample_interval_s > 0))
            and not telemetry.enabled):
        # the observability knobs and the autotune loop need a live
        # recorder: a private one (``:559-568``)
        from petastorm_tpu_torch.telemetry import Telemetry

        telemetry = Telemetry()
    if telemetry.enabled:
        # the stages this pipeline runs, shown as "no samples yet" until then
        telemetry.register_stage("decode")
        if transform_spec is not None:
            telemetry.register_stage("transform")
    error_policy = resolve_error_policy(on_error)
    if chaos is not None and chaos.affects_filesystem():
        # transient-IO chaos sits in the filesystem layer, beneath the real
        # retry paths; the wrapper is not local, so io_retries='auto' arms
        # as it would on a remote store (``petastorm_tpu/reader.py:584-594``)
        base_fs, _ = get_filesystem_and_path(
            dataset_url if isinstance(dataset_url, str) else dataset_url[0],
            storage_options, filesystem)
        filesystem = chaos.wrap_filesystem(base_fs)
    # one analysis walk a reader: the worker's cache signature and
    # output-caching verdict both come from this triple
    tf_cache_info = transform_cache_info(transform_spec)
    info = open_dataset(dataset_url, storage_options=storage_options, filesystem=filesystem,
                        require_stored_schema=not batched_output, io_retries=io_retries,
                        telemetry=telemetry)
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
    device_fields, mixed_fields, split_fields = _validate_decode_placement(
        decode_placement, full_schema, read_fields, transform_spec, worker_predicate, ngram)
    if any(native_decodable(full_schema[f]) for f in read_fields
           if f not in device_fields or f in split_fields):
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
        # py_dict_reader_worker.py:145-150); refused before make_cache, which
        # makes the shared tier's segments
        raise PetastormTpuError("cache_type cannot be combined with a predicate")
    if cache_type == "memory" and reader_pool_type == "process":
        raise PetastormTpuError(
            "cache_type='memory' is process-local: every spawned worker would"
            " hold its own empty cache, giving zero hits while multiplying"
            " memory. Use reader_pool_type='thread' (the cache is shared and"
            " thread-safe), cache_type='shared' or cache_type='local-disk' with the"
            " process pool.")
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
    decode_split_cell = None
    if split_fields:
        # one shared int cell every worker reads a rowgroup (0 host pixels, 1
        # device planes); a spawn-context Value crosses into process-pool
        # workers with their arguments.  It starts on the device side
        # (``petastorm_tpu/reader.py:719-731``)
        decode_split_cell = multiprocessing.get_context("spawn").Value("i", 1, lock=False)
    planner_verdict = None
    if autotune_policy is not None and autotune_policy.planner:
        from petastorm_tpu_torch import planner as _planner

        try:
            planner_verdict = _planner.plan_reader(
                info, read_fields, policy=autotune_policy, cores=_usable_cores(),
                cache_type=cache_type, cache_location=cache_location,
                transform_signature=tf_cache_info[0], split_fields=split_fields,
                workers_count=workers_count, decode_threads=decode_threads,
                results_queue_size=results_queue_size,
                results_queue_pinned=results_queue_pinned,
                image_fields=[f.name for f in view
                              if isinstance(f.codec, CompressedImageCodec)])
        except Exception:  # noqa: BLE001 - planning must not fail the read
            logger.warning("pipeline planner failed; starting from static defaults",
                           exc_info=True)
    if planner_verdict is not None:
        # the knob resolution order pinned > profile > metadata > default
        # (``petastorm_tpu/reader.py:770-790``)
        planned = planner_verdict.knobs
        if workers_count == "auto" and "workers" in planned:
            workers_count = planned["workers"].value
        if decode_threads == "auto" and "decode_threads" in planned:
            decode_threads = planned["decode_threads"].value
        if ("results_queue" in planned
                and planned["results_queue"].source in ("profile", "metadata")):
            results_queue_size = planned["results_queue"].value
        if ("decode_split" in planned and decode_split_cell is not None
                and "decode_split" not in autotune_policy.exclude_knobs):
            decode_split_cell.value = planned["decode_split"].value
    workers_count, decode_threads = _size_pool(workers_count, decode_threads)
    cache = make_cache(cache_type, cache_location, cache_size_limit, telemetry=telemetry)
    # raise mode takes the default pool; a skip policy's keeps running past
    # a failure, so the reader can quarantine the item (``:832-852``)
    pool_kwargs = {} if error_policy is None else dict(
        stop_on_failure=False, max_requeue_attempts=error_policy.max_requeue_attempts)
    # only what is set: the defaults stay the pool's own
    pool_kwargs.update({k: v for k, v in (("item_deadline_s", item_deadline_s),
                                          ("hedge_after_s", hedge_after_s),
                                          ("stall_warn_s", stall_warn_s)) if v is not None})
    if reader_pool_type == "process":
        # resize slots up to the autotune ceiling are made at start
        max_workers = autotune_policy.max_workers if autotune_policy is not None else None
        pool_kwargs["max_workers"] = max_workers
        pool_kwargs["shm_size_bytes"] = _arena_bytes(
            full_schema, read_fields, device_fields, decode_roi or {}, plan,
            max(workers_count, max_workers or 0) + max(results_queue_size, 1), ngram)
    executor = make_executor(reader_pool_type, workers_count, results_queue_size,
                             telemetry=telemetry, **pool_kwargs)
    # one breaker for every worker of the reader: a store that is down fails
    # fast with CircuitOpenError instead of each worker spending its whole
    # retry budget (``petastorm_tpu/reader.py:731-738``)
    retry_policy = resolve_retry_policy(io_retries, info.filesystem)
    circuit_breaker = make_circuit_breaker(retry_policy)
    fs_factory = FilesystemFactory(dataset_url if isinstance(dataset_url, str)
                                   else dataset_url[0], storage_options, filesystem=filesystem)
    worker = RowGroupDecoderWorker(full_schema, read_fields, device_fields,
                                   mixed_fields=mixed_fields, decode_threads=decode_threads, decode_roi=decode_roi,
                                   cache=cache, dataset_url=_url_key(dataset_url),
                                   predicate=worker_predicate, transform=transform_spec,
                                   transform_cache_info=tf_cache_info,
                                   ngram=ngram, ngram_schema=ngram_schema,
                                   verify_checksums=verify_checksums, fs_factory=fs_factory,
                                   retry_policy=retry_policy, circuit_breaker=circuit_breaker,
                                   telemetry=telemetry, split_fields=split_fields,
                                   decode_split=decode_split_cell)
    pool_worker = worker
    if chaos is not None and chaos.affects_worker():
        from petastorm_tpu_torch.test_util.chaos import ChaosWorker

        pool_worker = ChaosWorker(worker, chaos)
    reader = Reader(schema, plan, executor, worker, num_epochs, batched_output, device_fields,
                    deterministic=deterministic, shuffle_seed=shuffle_seed,
                    start_item=start_item, digest_state=digest_state, ngram=ngram,
                    error_policy=error_policy, declared_geometries=declared_geometries(info),
                    device_decode_mixed=mixed_fields, dataset_info=info,
                    pool_worker=pool_worker, stall_warn_s=stall_warn_s,
                    stall_abort_s=stall_abort_s, telemetry=telemetry,
                    metrics_port=metrics_port, flight_record_path=flight_record_path,
                    sample_interval_s=sample_interval_s, autotune_policy=autotune_policy,
                    device_decode_split=split_fields, decode_split_cell=decode_split_cell,
                    planner=planner_verdict)
    reader.circuit_breaker = circuit_breaker
    from petastorm_tpu_torch.cache_shared import SharedWarmCache

    if isinstance(cache, SharedWarmCache):
        # the reader publishes the tier's cache.* series and shows its stats
        reader.warm_cache = cache
        if (planner_verdict is not None and "cache_mem" in planner_verdict.knobs
                and cache.get_target_bytes() == int(0.8 * cache.l1_size_bytes)
                and cache.stats().get("bytes", 0)
                <= planner_verdict.knobs["cache_mem"].value * 2 ** 20):
            # seed the residency target only while it sits at its creation
            # default and applying it evicts nothing: it lives in the tier's
            # shared header, for every job on it (``:917-930``)
            cache.set_target_bytes(planner_verdict.knobs["cache_mem"].value * 2 ** 20)
        if reader.autotune is not None:
            mb = 2 ** 20
            reader.autotune.attach_cache_memory(
                get=lambda: max(1, cache.get_target_bytes() // mb),
                set_=lambda n: cache.set_target_bytes(n * mb) // mb,
                lo_mb=16, hi_mb=max(16, int(0.8 * cache.l1_size_bytes) // mb))
    if decode_split_cell is not None and reader.autotune is not None:
        # the split as a live knob: a starved consumer pushes the decode to
        # the device, a consumer-bound pipeline pulls it back (``:940-947``)
        reader.autotune.attach_decode_split(get=lambda: int(decode_split_cell.value),
                                            set_=reader.set_decode_split)
    return reader


#: the process pool's smallest arena (the JAX pool's fixed size)
_MIN_ARENA_BYTES = 256 * 2 ** 20
#: result batches the consumer may hold past the pool's window (the loader's
#: queue, the batch being staged, a stack being filled)
_ARENA_SLACK_BATCHES = 4


def _arena_bytes(schema: Schema, read_fields, device_fields, decode_roi, plan, window: int,
                 ngram=None, shm_dir: str = "/dev/shm") -> int:
    """The process pool's arena: ``window`` result batches in flight and
    ``_ARENA_SLACK_BATCHES`` more, each of the plan's largest item at the
    fixed-shape fields' widths (a ``decode_roi`` field at its crop, a
    ``'device'`` field at twice its pixels: its int16 coefficient planes are
    1x its pixels at 4:2:0 and 2x at 4:4:4; a ragged or object field travels
    pickled and takes none), at least 256 MiB, and at most half the free
    space of ``shm_dir``: a segment larger than its filesystem's room would
    fault when written, where a batch that does not fit travels pickled."""
    per_row = 0
    for name in read_fields:
        field = schema[name]
        if not field.is_fixed_shape or field.dtype.kind in ("O", "U", "S"):
            continue
        shape = field.shape
        if name in decode_roi:
            shape = _roi_crop_hw(_normalize_roi_spec(name, decode_roi[name])) + tuple(shape[2:])
        nbytes = int(np.prod(shape, dtype=np.int64)) * field.dtype.itemsize
        per_row += 2 * nbytes if name in device_fields else nbytes
    if ngram is not None:
        per_row *= ngram.length  # a window carries a row a timestep
    rows = max((stop - start for start, stop in
                (item.row_slice() for item in plan.epoch_items(0))), default=0)
    size = max(_MIN_ARENA_BYTES, (window + _ARENA_SLACK_BATCHES) * rows * per_row)
    try:
        size = min(size, max(shutil.disk_usage(shm_dir).free // 2, 1 << 20))
    except OSError:
        pass  # no such filesystem here: the estimate stands
    return int(size)


def _native_diagnostics() -> dict:
    """Whether the batched image decode and the arena libraries load here
    (built at first use), why the shared-memory transport is or is not
    available, and the command that builds them; the JAX reader's keys
    (``petastorm_tpu/reader.py:2136-2150``)."""
    from petastorm_tpu_torch.native import load_arena

    def loads(load) -> Optional[str]:
        try:
            load()
            return None
        except Exception as exc:  # noqa: BLE001 - reported, not raised
            return f"{type(exc).__name__}: {exc}"

    arena_error = loads(load_arena)
    return {"image_decode": loads(native_image.load_decoder) is None,
            "shm_arena": arena_error is None,
            "shm_transport": {"available": arena_error is None,
                              "reason": "ok" if arena_error is None else arena_error},
            "build_command": native_image.BUILD_COMMAND}


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
                 dataset_info=None, pool_worker=None,
                 stall_warn_s: Optional[float] = None,
                 stall_abort_s: Optional[float] = None,
                 telemetry=None, metrics_port: Optional[int] = None,
                 flight_record_path: Optional[str] = None,
                 sample_interval_s: Optional[float] = None, autotune_policy=None,
                 device_decode_split: FrozenSet[str] = frozenset(),
                 decode_split_cell=None, planner=None):
        if start_item < 0:
            raise PetastormTpuError("start_item must be >= 0")
        #: the pipeline's recorder (``telemetry.Telemetry``, or the no-op one);
        #: ``reader.telemetry.pipeline_report()`` names the dominant stage
        self.telemetry = _resolve_telemetry(telemetry)
        tele = self.telemetry
        self._m_results_empty = tele.counter("queue.results_empty_wait_s")
        self._m_rows_emitted = tele.counter("reader.rows_emitted")
        self._m_batches = tele.counter("reader.batches_consumed")
        self._m_skipped = tele.counter("errors.skipped_rowgroups")
        self._g_digest = tele.gauge("stream.digest")
        tele.counter("reader.reordered_batches")  # the pools count it
        #: the fields under the live host/device split, and its shared cell
        self.device_decode_split: FrozenSet[str] = frozenset(device_decode_split)
        self._decode_split_cell = decode_split_cell
        #: the static planner's verdict (``planner.PlanVerdict``), or None;
        #: ``stop()`` writes the run's profile from it
        self.planner = planner
        self._profile_written = False
        #: the shared warm tier (``cache_type='shared'``), set by make_reader;
        #: the reader publishes its ``cache.*`` series
        self.warm_cache = None
        self._cache_publish_at = 0.0
        #: the sampler (``telemetry.MetricsSampler``), the localhost metrics
        #: endpoint and the autotune controller, each None unless armed
        self.sampler = None
        self.metrics_server = None
        self.autotune = None
        self._flight_record_path = flight_record_path
        self._flight_record: Optional[dict] = None
        self._final_snapshot: Optional[dict] = None
        self._observability_closed = False
        self._native: Optional[dict] = None
        # an explicit argument wins; None reads the environment, whose
        # absence leaves the module defaults (``petastorm_tpu/reader.py:1211``)
        self._stall_warn_s = (float(stall_warn_s) if stall_warn_s is not None
                              else env_seconds("PETASTORM_TPU_STALL_WARN_S", _STALL_WARN_S))
        self._stall_abort_s = (float(stall_abort_s) if stall_abort_s is not None
                               else env_seconds("PETASTORM_TPU_STALL_ABORT_S", _STALL_ABORT_S))
        self._stall_warned_at = 0.0
        self._stall_last = 0.0
        if isinstance(executor, SerialExecutor) and self._stall_abort_s > 0:
            # work runs inline inside the consumer's next(): nothing can
            # watch it from outside (``petastorm_tpu/reader.py:1222-1234``)
            logger.warning(
                "stall_abort_s=%.0f is inoperative with reader_pool_type='serial': work"
                " runs inline inside the consumer's next(), so a wedged work item blocks"
                " the stall loop itself (the serial watchdog still WARNS via"
                " stall_warn_s). Use the thread or process pool when stall abort"
                " matters.", self._stall_abort_s)
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
        # the pool runs the chaos wrapper when there is one; the counters
        # are the worker's own
        self._executor.start(pool_worker if pool_worker is not None else worker)
        self._batches: Optional[Iterator[ColumnBatch]] = None
        self._rows: Iterator = iter(())
        self._rows_left = 0
        #: an ngram reader's current batch of windows and the next one's index
        self._windows: Optional[ColumnBatch] = None
        self._window_pos = 0
        self.last_row_consumed = False
        self._namedtuple_type = schema.make_namedtuple_type()
        self._stopped = False
        self._stall_aborted = False
        #: fields read with decode_placement='device': their batches carry
        #: coefficient planes, which only cuda.CudaDataLoader finishes
        self.device_decode_fields: List[str] = list(device_decode_fields)
        #: the subset in the mixed-geometry object format ('device-mixed'),
        #: decoded a geometry bucket at a time (``reader.py:900-901``)
        self.device_decode_mixed: FrozenSet[str] = frozenset(device_decode_mixed)
        self._worker = worker
        self._start_observability(sample_interval_s, metrics_port, autotune_policy)
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
        #: the storage circuit breaker its workers share (``retry``), set by
        #: make_reader when ``io_retries`` arms one; None otherwise
        self.circuit_breaker = None

    # -- observability (``petastorm_tpu/reader.py:1318-1396``) ---------------

    def _start_observability(self, sample_interval_s, metrics_port, autotune_policy) -> None:
        """The sampler, the metrics endpoint and the autotune controller; on
        a failure (a port already bound) they and the pool are stopped before
        the error propagates, so a retry loop leaks no thread or port."""
        try:
            if self.telemetry.enabled:
                from petastorm_tpu_torch.telemetry.sampler import (DEFAULT_INTERVAL_S,
                                                                   MetricsSampler)

                interval = (float(sample_interval_s) if sample_interval_s is not None
                            else env_seconds("PETASTORM_TPU_SAMPLE_INTERVAL_S",
                                             DEFAULT_INTERVAL_S))
                if interval > 0:  # <= 0 keeps telemetry, samples nothing
                    self.sampler = MetricsSampler(self.telemetry, interval_s=interval)
                    self.sampler.start()
            if self._flight_record_path and self.sampler is None:
                logger.warning(
                    "flight_record_path=%r is inert: sampling is disabled"
                    " (sample_interval_s <= 0 or telemetry has no sampler);"
                    " no flight record will be written on failure",
                    self._flight_record_path)
            if metrics_port is not None:
                from petastorm_tpu_torch.telemetry.export import MetricsExportServer

                self.metrics_server = MetricsExportServer(self.telemetry, sampler=self.sampler,
                                                          port=metrics_port)
                self.metrics_server.start()
            if autotune_policy is not None:
                if self.sampler is None:
                    logger.warning(
                        "autotune is inert: sampling is disabled"
                        " (sample_interval_s <= 0); the pipeline runs with"
                        " its static knobs")
                else:
                    from petastorm_tpu_torch.autotune import AutotuneController

                    self.autotune = AutotuneController(self._executor, self.sampler,
                                                       self.telemetry, policy=autotune_policy)
                    self.autotune.start()
        except BaseException:
            self._close_observability()
            self._executor.stop()
            raise

    def _close_observability(self) -> None:
        """Stop the controller, take the last sample, latch the final
        snapshot and stop the endpoint; idempotent."""
        if self._observability_closed:
            return
        self._observability_closed = True
        if self.autotune is not None:
            try:
                self.autotune.stop()
            except Exception:  # noqa: BLE001 - teardown is best-effort
                logger.debug("autotune stop failed", exc_info=True)
        if self.sampler is not None:
            try:  # the trailing partial interval
                self.sampler.sample_now()
            except Exception:  # noqa: BLE001 - teardown is best-effort
                logger.debug("final sample failed", exc_info=True)
            self.sampler.stop()
        if self.telemetry.enabled and self._final_snapshot is None:
            self._final_snapshot = self.telemetry.snapshot()
        if self.metrics_server is not None:
            self.metrics_server.stop()

    def _maybe_publish_cache(self, now: float) -> None:
        """Fold the shared tier's counters into this reader's telemetry, at
        most every 0.5 s (the tier's lock is not taken a batch)."""
        if now - self._cache_publish_at < 0.5:
            return
        self._cache_publish_at = now
        try:
            self.warm_cache.publish_telemetry()
        except Exception:  # noqa: BLE001 - observability must not break reads
            logger.debug("warm-cache telemetry publish failed", exc_info=True)

    def _record_flight(self, reason: str) -> None:
        """The flight record (the sampled series and the trace tail), once,
        at the first terminal failure, written to ``flight_record_path``
        when set (``petastorm_tpu/reader.py:1767-1799``)."""
        if self._flight_record is not None or self.sampler is None:
            return
        try:
            from petastorm_tpu_torch.telemetry.sampler import dump_flight_record, flight_record

            self._flight_record = flight_record(self.sampler, reason=reason)
            self._flight_record["stream_digest"] = self._digest.summary()
            if self._flight_record_path:
                dump_flight_record(self._flight_record, self._flight_record_path)
                logger.warning("Flight record (%d sampled points) written to %s",
                               len(self._flight_record["points"]), self._flight_record_path)
        except Exception:  # noqa: BLE001 - diagnostics must not mask the failure
            logger.warning("flight-record capture failed", exc_info=True)

    def _stalled_stage(self) -> str:
        """The telemetry's dominant stage, or '' without telemetry."""
        if not self.telemetry.enabled:
            return ""
        try:
            return dominant_stage(self.telemetry.snapshot())
        except Exception:  # noqa: BLE001 - diagnostics must not mask a stall
            return ""

    # -- the live host/device split (``petastorm_tpu/reader.py:2015-2056``) --

    @property
    def decode_split(self) -> Optional[str]:
        """``'host'`` or ``'device'`` for the ``decode_placement='auto'``
        fields; None when the reader has none."""
        if self._decode_split_cell is None:
            return None
        return "device" if int(self._decode_split_cell.value) else "host"

    def set_decode_split(self, mode) -> int:
        """Move the live split: ``'host'``/0 ships decoded pixels (the host
        decode in the workers), ``'device'``/1 the coefficient planes (the
        loader finishes them on the card).  It takes effect a rowgroup at a
        time: rowgroups already decoded keep their form, and the loader
        assembles the two forms apart.  The autotune controller's
        ``decode_split`` knob; safe while the reader runs.  Returns 0 or 1."""
        if self._decode_split_cell is None:
            raise PetastormTpuError(
                "set_decode_split needs a decode_placement='auto' field"
                " (no live-split field on this reader)")
        if mode in ("host", 0, False):
            value = 0
        elif mode in ("device", 1, True):
            value = 1
        else:
            raise PetastormTpuError(
                f"decode split mode must be 'host'/0 or 'device'/1,"
                f" got {mode!r}")
        self._decode_split_cell.value = value
        if self.telemetry.enabled:
            self.telemetry.gauge("decode.split").set(value)
            self.telemetry.counter(f"decode.split_to_{'device' if value else 'host'}").add(1)
        return value

    def decode_stats(self) -> dict:
        """The native decode counters (``batch_calls``, ``batch_images``,
        ``roi_calls``, ``roi_images``, ``coef_batch_calls``,
        ``coef_batch_images``) summed over every rowgroup the workers
        decoded so far: the proof that image columns took the batched path."""
        return self._worker.decode_stats()

    def io_stats(self) -> dict:
        """Remote-IO counters: ``retries`` (the dataset open's and the
        workers' rowgroup reads'), ``read_calls`` and ``rowgroups_read``
        through the workers' one-read windows, and ``reads_per_rowgroup``
        (None on a local filesystem).  With telemetry the same counts are
        the ``io.retries``, ``io.read_calls``, ``io.rowgroups_read`` and
        ``io.reads_per_rowgroup`` series, as in the JAX reader."""
        out = self._worker.io_stats()
        if self.dataset_info is not None:
            out["retries"] += self.dataset_info.retries
        return out

    def transport_stats(self) -> dict:
        """The process pool's shared-memory transport (``{}`` under another
        pool): the arena's size, free bytes and high-water mark, the batches
        that came through it (``shm_batches``) and those that travelled
        pickled (``pickled_batches``), the columns and rows decoded straight
        into arena slots, and the workers' spawn seconds and resident sets.
        With telemetry the slot columns are also the ``decode.batch_slots``
        series, as in the JAX reader."""
        pool = self._executor.diagnostics
        return {k: pool[k] for k in _TRANSPORT_STATS if k in pool}

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
            self._batches = self._executor.imap(self._items(), start=self._start_item,
                                                on_idle=self._on_idle)
        tele = self.telemetry
        while True:
            # time blocked on the pool is the consumer starving: the worker
            # plane is the bottleneck (``petastorm_tpu/reader.py:1530-1581``)
            t0 = time.perf_counter() if tele.enabled else None
            try:
                batch = next(self._batches)
            except StopIteration:
                if self._all_items_consumed():
                    self.last_row_consumed = True
                raise
            except WorkerError as exc:
                if exc.item is None or self._error_policy is None:
                    self._record_flight(f"WorkerError ({exc.exc_type or 'unattributable'},"
                                        f" kind={exc.kind})")
                if exc.item is None:
                    # unattributable (every worker died, a stall): nothing
                    # to skip, and the pool must not run on
                    self.stop()
                raise
            finally:
                if t0 is not None:
                    self._m_results_empty.add(time.perf_counter() - t0)
            if self.warm_cache is not None:
                self._maybe_publish_cache(time.monotonic())
            ordinal = self._start_item + self._consumed_items
            if isinstance(batch, WorkerError):
                # a skip policy's pool yields the failure at its position
                self._skip_or_raise(batch, ordinal)
                continue
            self._digest_deliver(ordinal, batch)
            self._consumed_items += 1
            if tele.enabled:
                self._m_batches.add(1)
                self._m_rows_emitted.add(batch.num_rows)
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
        if self.telemetry.enabled:
            self._g_digest.set(self._digest.combined)

    def _skip(self, ordinal: int) -> None:
        """Fold one policy-skipped work item into the stream certificate and
        the cursor (``petastorm_tpu/reader.py:1681``)."""
        epoch, item = self._work_item_for(ordinal)
        self._digest.record_skip(epoch, ordinal,
                                 item.row_group.global_index if item is not None else -1,
                                 item.row_group.row_group if item is not None else -1)
        self._consumed_items += 1
        if self.telemetry.enabled:
            self._g_digest.set(self._digest.combined)

    def _skip_or_raise(self, exc: WorkerError, ordinal: int) -> None:
        """Quarantine a worker failure a skip policy's pool yielded
        (``petastorm_tpu/reader.py:1801-1880``); an unattributable one
        propagates, after ``stop()``.  A skipped item counts in the cursor and the digest
        at its plan position, so the epoch ends at the same count with the
        quarantined rows missing - never duplicated."""
        if exc.item is None:  # the item source failed: nothing to skip
            self._record_flight(f"WorkerError (unattributable, kind={exc.kind})")
            self.stop()
            raise exc
        policy = self._error_policy
        rg = exc.item.row_group
        entry = {"ordinal": exc.ordinal, "path": rg.path, "row_group": rg.row_group,
                 "kind": exc.kind, "exc_type": exc.exc_type,
                 # last traceback line: the remote exception's message
                 "error": str(exc).splitlines()[-1]}
        self._quarantine.append(entry)
        self._m_skipped.add(1)
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
            self._record_flight(f"ErrorBudgetExceededError: {over}")
            diag = self.diagnostics  # the snapshot before stop()
            self.stop()
            raise ErrorBudgetExceededError(
                f"Error budget exceeded: {over}. Quarantined rowgroups: "
                + ", ".join(f"{e['path']}#{e['row_group']}" for e in self._quarantine),
                diagnostics=diag) from exc
        if self.deterministic == "seed":
            self._skip(ordinal)

    def _on_idle(self, stalled: float) -> None:
        """The stall watchdog (``petastorm_tpu/reader.py:1481-1580``), called
        by the pool while it waits with the seconds since its last result:
        a warning every ``stall_warn_s``, a :class:`pool.PipelineStallError`
        past ``stall_abort_s``, after the reader has stopped and joined its
        pool (bounded: hung workers are killed or abandoned)."""
        if stalled < self._stall_last:  # a new wait
            self._stall_warned_at = 0.0
        self._stall_last = stalled
        if self._stall_abort_s > 0 and stalled > self._stall_abort_s:
            self._stall_aborted = True
            # the flight record before the snapshot, so the error carries it
            self._record_flight(f"PipelineStallError: no result for {stalled:.0f}s")
            diag = self.diagnostics  # the snapshot before stop()
            stage = self._stalled_stage()
            self.stop()
            # the stuck workers will not finish: a short, bounded join
            self._executor.join(timeout=1.0)
            shown = {k: v for k, v in diag.items() if k not in ("flight_recorder", "telemetry")}
            raise PipelineStallError(
                f"No result for {stalled:.0f}s (stall_abort_s={self._stall_abort_s:.0f})"
                + (f"; busiest stage: {stage}" if stage else "")
                + f"; pipeline state: {shown}", diagnostics=diag)
        if (self._stall_warn_s > 0 and stalled > self._stall_warn_s
                and stalled - self._stall_warned_at > self._stall_warn_s):
            self._stall_warned_at = stalled
            stage = self._stalled_stage()
            logger.warning("Reader has produced no batch for %.0fs%s; pipeline state: %s",
                           stalled, f" (busiest stage: {stage})" if stage else "",
                           self.diagnostics)

    @property
    def diagnostics(self) -> dict:
        """Items per epoch, consumed and expected, the stream digest, the
        fault ledger (the skip count and the last 20 quarantine entries,
        ``petastorm_tpu/reader.py:2113-2180``; :attr:`quarantined_rowgroups`
        has them all), the pool's keys (``ventilated``, ``consumed``,
        ``in_queue_size``, the requeues, hung workers killed or abandoned,
        hedges and their wins, and the busy workers: worker, ordinal, seconds
        on it), the native libraries (``native``), and, where armed, the
        planner's verdict (``planner``), the autotune controller's knobs and
        decisions (``autotune``), the split side (``decode_split``), the
        shared tier's stats (``cache``), the flight record
        (``flight_recorder``), the final telemetry snapshot (``telemetry``,
        latched at stop) and the metrics port.  Every key is one of the JAX
        reader's; the process pool's arena counters are
        :meth:`transport_stats`."""
        out = {"items_per_epoch": self._items_per_epoch,
               "consumed_items": self._consumed_items,
               "expected_items": self._expected_items,
               "deterministic": self.deterministic,
               "stream_digest": self._digest.summary(),
               "skipped_rowgroups": len(self._quarantine),
               "quarantined_rowgroups": list(
                   self._quarantine[-_DIAGNOSTICS_QUARANTINE_TAIL:])}
        pool = self._executor.diagnostics
        out.update((k, pool[k]) for k in _POOL_DIAGNOSTICS if k in pool)
        if self._native is None:  # probed once a reader: a failed build is not retried
            self._native = _native_diagnostics()
        out["native"] = dict(self._native)
        if self.circuit_breaker is not None:
            out["circuit_breaker"] = self.circuit_breaker.snapshot()
        if self._decode_split_cell is not None:
            out["decode_split"] = self.decode_split
        if self.warm_cache is not None:
            try:
                out["cache"] = self.warm_cache.stats()
            except Exception:  # noqa: BLE001 - diagnostics must not raise
                logger.debug("warm-cache stats failed", exc_info=True)
        if self.autotune is not None:
            out["autotune"] = self.autotune.diagnostics
        if self.planner is not None:
            out["planner"] = self.planner.to_dict()
        if self._flight_record is not None:
            out["flight_recorder"] = self._flight_record
        if self._final_snapshot is not None:
            out["telemetry"] = self._final_snapshot
        if self.metrics_server is not None:
            out["metrics_port"] = self.metrics_server.port
        return out

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
        """Stop the pool.  Every close path ends here, so this is where the
        run's profile is written (an autotuned reader), the shared tier's
        counters are folded in a last time, and the final telemetry
        snapshot is latched into ``diagnostics['telemetry']``
        (``petastorm_tpu/reader.py:1974-2013``)."""
        self._stopped = True
        if self.planner is not None and not self._profile_written:
            self._profile_written = True
            try:
                from petastorm_tpu_torch import planner as _planner

                _planner.write_profile(self)
            except Exception:  # noqa: BLE001 - teardown is best-effort
                logger.debug("flight-profile write failed", exc_info=True)
        if self.warm_cache is not None:
            try:
                self.warm_cache.publish_telemetry()
            except Exception:  # noqa: BLE001 - teardown is best-effort
                logger.debug("final warm-cache publish failed", exc_info=True)
        if self.autotune is not None:
            # before the pool: a tick mid-close must not resize a stopped pool
            try:
                self.autotune.stop()
            except Exception:  # noqa: BLE001 - teardown is best-effort
                logger.debug("autotune stop failed", exc_info=True)
        self._executor.stop()
        self._close_observability()

    def join(self) -> None:
        """Wait for the pool (bounded after a stall abort)."""
        if self._stall_aborted:
            self._executor.join(timeout=5.0)
            return
        self._executor.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        self.join()
