"""In-memory data -> cached Parquet -> loaders: the dataset converter.

The port's copy of ``petastorm_tpu/converter.py``, the counterpart of
upstream petastorm's ``make_spark_converter(df).make_torch_dataloader()``.
``make_converter(data, cache_dir_url)`` takes a pandas DataFrame or a
pyarrow Table, casts its floats to ``dtype`` (``:82-110``), fingerprints its
content and write parameters (sha256 over the schema, the column buffers
and their offsets, ``:361-377``), and writes it once under the cache
directory as ``converted-<fingerprint>``: into a temporary directory first,
published by one rename (``:184-220``), a stale directory at the target
moved aside (``:223-240``).  A second conversion of the same content in
this process returns the same handle, and one in another process reuses
the published files.  Converters are deleted at interpreter exit unless
``delete_at_exit=False`` (``:57-70``).  The handle's loaders:
``make_cuda_loader`` (``cuda.CudaDataLoader``, on the card unless
``device='cpu'``, in place of ``make_jax_loader``), ``make_torch_dataloader``
(``pytorch.BatchedDataLoader``) and ``make_reader``; each warns when the
shard arguments disagree with the launcher's rank (``:380-414``).

The cache directory may be remote (``storage_options``, ``:283-355``: any
URL ``fs.get_filesystem_and_path`` resolves); the handle's readers take the
same ``storage_options``.  ``make_tf_dataset`` wraps the cached dataset in a
``tf.data.Dataset`` (``tf.make_petastorm_dataset``; it needs tensorflow).  A
Spark DataFrame is materialized on the executors by ``df.write.parquet``
into a temporary directory published by one rename, deduplicated by its
analyzed plan, with MLlib vectors turned into arrays and the floats cast per
``dtype`` by Spark column expressions (``:116-358``): the data is never
collected into the calling process.
"""

from __future__ import annotations

import atexit
import hashlib
import logging
import os
import posixpath
import time
import uuid
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.fs as pafs
import pyarrow.parquet as pq

from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.etl.writer import DEFAULT_ROW_GROUP_SIZE_MB, stamp_dataset_metadata
from petastorm_tpu_torch.fs import get_filesystem_and_path, normalize_dir_url
from petastorm_tpu_torch.reader import make_reader
from petastorm_tpu_torch.schema import SCHEMA_METADATA_KEY, Schema

logger = logging.getLogger(__name__)

#: the environment variable naming the parent cache directory (the reference's
#: spark conf key 'petastorm.spark.converter.parentCacheDirUrl')
CACHE_DIR_ENV_VAR = "PETASTORM_TPU_CONVERTER_CACHE_DIR"

_MIN_ADVISED_FILE_SIZE_BYTES = 50 * 1024 * 1024

#: converters made in this process that delete their files at exit
_registered_converters: List["DatasetConverter"] = []
#: the live converter of each cache URL: a dedup hit returns the same handle,
#: so one delete() cannot remove a dataset another handle still reads
_converters_by_url: Dict[str, "DatasetConverter"] = {}

#: the launchers' rank and size variables, in the order they are read; torchrun's last
_LAUNCHER_ENV = (("HOROVOD_RANK", "HOROVOD_SIZE"),
                 ("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE"),
                 ("PMI_RANK", "PMI_SIZE"),
                 ("RANK", "WORLD_SIZE"))


def _cleanup_at_exit() -> None:
    for conv in list(_registered_converters):
        try:
            conv.delete()
        except Exception:  # noqa: BLE001 - best-effort cleanup at interpreter exit
            logger.warning("Failed to clean converter cache %s", conv.cache_url, exc_info=True)


atexit.register(_cleanup_at_exit)


def _is_spark_dataframe(data) -> bool:
    """Duck-typed, as the reference: a pyspark DataFrame has a writer, a
    schema and ``toPandas``."""
    return hasattr(data, "write") and hasattr(data, "schema") and hasattr(data, "toPandas")


def _to_arrow_table(data, dtype: Optional[str]) -> pa.Table:
    """A pandas DataFrame or pyarrow Table as a Table, its float64 columns
    (and lists of them) cast to float32 under ``dtype='float32'``, float32
    ones to float64 under ``'float64'``."""
    if isinstance(data, pa.Table):
        table = data
    elif hasattr(data, "columns") and hasattr(data, "dtypes"):  # pandas
        table = pa.Table.from_pandas(data, preserve_index=False)
    else:
        raise PetastormTpuError(
            f"Unsupported input type {type(data).__name__}: expected a pandas"
            " DataFrame, pyarrow Table, or Spark DataFrame")
    if dtype is None:
        return table
    if dtype not in ("float32", "float64"):
        raise PetastormTpuError(f"dtype must be 'float32', 'float64' or None, got {dtype!r}")
    target = pa.float32() if dtype == "float32" else pa.float64()
    source = pa.float64() if dtype == "float32" else pa.float32()
    fields, changed = [], False
    for f in table.schema:
        if f.type == source:
            fields.append(pa.field(f.name, target, f.nullable))
            changed = True
        elif pa.types.is_list(f.type) and f.type.value_type == source:
            fields.append(pa.field(f.name, pa.list_(target), f.nullable))
            changed = True
        else:
            fields.append(f)
    return table.cast(pa.schema(fields)) if changed else table


def _spark_prepare_df(df, dtype: Optional[str]):
    """The DataFrame's columns normalised by Spark column expressions, at
    write time on the executors (``petastorm_tpu/converter.py:116-152``):
    MLlib ``VectorUDT`` columns become arrays (with a warning: sparse vectors
    densify), and the floats take ``dtype``'s precision."""
    if dtype not in (None, "float32", "float64"):
        raise PetastormTpuError(f"dtype must be 'float32', 'float64' or None, got {dtype!r}")
    target_scalar = {"float32": "float", "float64": "double"}.get(dtype)
    source_scalar = {"float32": "DoubleType", "float64": "FloatType"}.get(dtype)
    for field in df.schema.fields:
        type_name = type(field.dataType).__name__
        if type_name == "VectorUDT":
            from pyspark.ml.functions import vector_to_array
            from pyspark.sql.functions import col

            warnings.warn(f"Column {field.name!r} is an MLlib vector; converting to an"
                          f" array of {dtype or 'float64'} (sparse vectors densify)")
            df = df.withColumn(field.name, vector_to_array(col(field.name),
                                                           dtype=dtype or "float64"))
        elif dtype is not None and type_name == source_scalar:
            from pyspark.sql.functions import col

            df = df.withColumn(field.name, col(field.name).cast(target_scalar))
        elif (dtype is not None and type_name == "ArrayType"
              and type(field.dataType.elementType).__name__ == source_scalar):
            from pyspark.sql.functions import col

            df = df.withColumn(field.name, col(field.name).cast(f"array<{target_scalar}>"))
    return df


def _spark_fingerprint(df, params: Dict) -> str:
    """A Spark DataFrame's cache key: its analyzed logical plan and the
    parameters (hashing its content would collect it); a stand-in without a
    JVM gives its schema and semantic hash, and one without either a fresh
    key, so no dedup."""
    try:
        plan = df._jdf.queryExecution().analyzed().toString()  # noqa: SLF001
    except Exception:  # noqa: BLE001 - a stand-in without a JVM
        plan = None
    if not plan:
        try:
            plan = f"{df.schema.json()}|semantic:{df.semanticHash()}"
        except Exception:  # noqa: BLE001
            plan = f"{df.schema.json()}|uuid:{uuid.uuid4().hex}"
    digest = hashlib.sha256()
    digest.update(plan.encode())
    digest.update(repr(sorted(params.items())).encode())
    return digest.hexdigest()[:20]


def _publish_dir(fs: pafs.FileSystem, tmp_root: str, root: str) -> None:
    """Publish ``tmp_root`` at ``root`` by one rename.  A lost race (another
    process published the same content first) keeps the winner, recognised
    by its outcome: a directory at ``root`` holding at least as many Parquet
    files as ours.  A bare debris directory is not a winner."""
    def parquet_count(path: str) -> int:
        try:
            return sum(1 for i in fs.get_file_info(pafs.FileSelector(path))
                       if i.type == pafs.FileType.File and i.path.endswith(".parquet"))
        except (OSError, FileNotFoundError):
            return 0

    ours = parquet_count(tmp_root)
    try:
        fs.move(tmp_root, root)
    except Exception as move_exc:  # noqa: BLE001 - raised again unless a winner is seen
        try:
            won = (fs.get_file_info(root).type == pafs.FileType.Directory
                   and parquet_count(root) >= max(ours, 1))
        except Exception:  # noqa: BLE001 - the check itself failed
            raise move_exc
        if not won:
            raise
        logger.info("Lost publish race for %s; keeping the winner", root)
        fs.delete_dir(tmp_root)


def _move_debris_aside(fs: pafs.FileSystem, root: str, ds_url: str) -> None:
    """Move a directory without published Parquet at the cache target aside
    and delete it there, so that a publish landing meanwhile is taken out of
    the way (and written again from the same content), not destroyed."""
    logger.warning("Clearing incomplete materialization at %s", ds_url)
    aside = posixpath.join(posixpath.dirname(root),
                           f".stale-{posixpath.basename(root)}-{uuid.uuid4().hex[:8]}")
    try:
        fs.move(root, aside)
        fs.delete_dir(aside)
    except FileNotFoundError:
        pass  # another process cleared it first


def _materialize_spark_df(df, ds_url: str, cache_dir_url: str, fs: pafs.FileSystem,
                          root: str, compression_codec: str, row_group_size_mb: float) -> None:
    """``df.write.parquet`` on the executors into a temporary directory, then
    one rename publishes it: a crashed job leaves a ``.tmp-*`` directory,
    never a partial dataset at the cache URL (``parquet.block.size`` sets
    the rowgroup size)."""
    tag = posixpath.basename(root)
    tmp_url = posixpath.join(cache_dir_url, f".tmp-{tag}-{uuid.uuid4().hex[:8]}")
    _, tmp_root = get_filesystem_and_path(tmp_url)
    (df.write.mode("overwrite")
       .option("compression", compression_codec)
       .option("parquet.block.size", int(row_group_size_mb * 2**20))
       .parquet(tmp_url))
    if not _parquet_files(fs, tmp_root):
        fs.delete_dir(tmp_root)
        raise PetastormTpuError(f"Spark wrote no parquet files for {ds_url!r} (empty DataFrame?)")
    _publish_dir(fs, tmp_root, root)


def _share_live_handle(ds_url: str, delete_at_exit: bool):
    """The live handle of the same content converted earlier in this process,
    or None.  Keeping the files wins: ``delete_at_exit=False`` on either call
    takes the handle off the exit cleanup."""
    live = _converters_by_url.get(ds_url)
    if live is None or live._deleted:  # noqa: SLF001
        return None
    if not delete_at_exit and live._owns_cache:  # noqa: SLF001
        live._owns_cache = False
        if live in _registered_converters:
            _registered_converters.remove(live)
    elif delete_at_exit and not live._owns_cache:  # noqa: SLF001
        warnings.warn(f"Cache {ds_url} was already created with delete_at_exit=False;"
                      " it will be kept despite this call's delete_at_exit=True.")
    return live


def _register_converter(conv: "DatasetConverter", delete_at_exit: bool) -> None:
    _converters_by_url[conv.cache_url] = conv
    if delete_at_exit:
        _registered_converters.append(conv)


def _make_spark_converter(df, cache_dir_url: str, *, dtype, compression_codec,
                          row_group_size_mb, delete_at_exit,
                          storage_options) -> "DatasetConverter":
    """A Spark DataFrame's converter (``petastorm_tpu/converter.py:281-357``):
    materialized on the executors, reused when a complete materialization of
    the same plan is published (``_SUCCESS`` or ``_common_metadata`` beside
    its part files), its schema and row count read from the written
    footers."""
    df = _spark_prepare_df(df, dtype)
    compression_codec = compression_codec or "snappy"
    params = {"codec": compression_codec, "rg_mb": row_group_size_mb, "v": 2,
              "engine": "spark"}
    tag = _spark_fingerprint(df, params)
    ds_url = posixpath.join(cache_dir_url, f"converted-{tag}")
    fs, root = get_filesystem_and_path(ds_url, storage_options)

    live = _share_live_handle(ds_url, delete_at_exit)
    if live is not None:
        return live

    def published_files():
        if fs.get_file_info(root).type != pafs.FileType.Directory:
            return []
        entries = [i for i in fs.get_file_info(pafs.FileSelector(root))
                   if i.type == pafs.FileType.File]
        if not {"_SUCCESS", "_common_metadata"} & {posixpath.basename(i.path) for i in entries}:
            return []  # a crashed or foreign write: never adopted
        return [i.path for i in entries if i.path.endswith(".parquet")]

    files = published_files()
    if not files and fs.get_file_info(root).type == pafs.FileType.Directory:
        # look again (a publish may have landed), then move the debris aside
        files = published_files()
        if not files:
            _move_debris_aside(fs, root, ds_url)
    if not files:
        _materialize_spark_df(df, ds_url, cache_dir_url, fs, root, compression_codec,
                              row_group_size_mb)
        files = published_files()
        if not files:
            raise PetastormTpuError(
                f"Materialized Spark dataset at {ds_url!r} has no complete"
                " parquet output (committer wrote no _SUCCESS marker?)")
    else:
        logger.info("Reusing cached converted dataset %s", ds_url)
    _wait_files_available(fs, files)
    num_rows, arrow_schema = 0, None
    for path in files:
        with fs.open_input_file(path) as f:
            meta = pq.ParquetFile(f)
            num_rows += meta.metadata.num_rows
            if arrow_schema is None:
                arrow_schema = meta.schema_arrow
    schema = Schema.from_arrow_schema(arrow_schema, name=f"Converted_{tag[:8]}")
    stamp_dataset_metadata(ds_url, schema, storage_options=storage_options)
    _advise_on_file_sizes(fs, files)
    conv = DatasetConverter(ds_url, files, num_rows, schema, _owns_cache=delete_at_exit,
                            storage_options=storage_options)
    _register_converter(conv, delete_at_exit)
    return conv


def _fingerprint(table: pa.Table, params: Dict) -> str:
    """Content hash: the write parameters, the schema, the row count and
    every column buffer with its offset and length (zero-copy slices share
    their parent's buffers, so without those every slice would collide)."""
    h = hashlib.sha256()
    h.update(str(sorted(params.items())).encode())
    h.update(table.schema.serialize().to_pybytes())
    h.update(str(table.num_rows).encode())
    for batch in table.to_batches():
        for col in batch.columns:
            h.update(f"{col.offset}:{len(col)};".encode())
            for buf in col.buffers():
                if buf is not None:
                    h.update(buf)
    return h.hexdigest()[:24]


def _launcher_rank() -> Tuple[Optional[int], Optional[int]]:
    """(rank, size) from the launcher's environment (Horovod, OpenMPI, PMI,
    then torchrun's ``RANK``/``WORLD_SIZE``), else from an initialized
    ``torch.distributed`` of more than one process, else (None, None)."""
    for rank_var, size_var in _LAUNCHER_ENV:
        if rank_var in os.environ:
            return int(os.environ[rank_var]), int(os.environ.get(size_var, 0)) or None
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return dist.get_rank(), dist.get_world_size()
    return None, None


def _check_shard_rank_env(cur_shard: Optional[int], shard_count: Optional[int]) -> None:
    """Warn (never fail) when ``cur_shard``/``shard_count`` disagree with the
    launcher's rank and size (the reference's rank discovery,
    ``petastorm_tpu/converter.py:380-414``, where ``jax.process_count()``
    stands in place of ``torch.distributed``)."""
    env_rank, env_size = _launcher_rank()
    if env_rank is None:
        return
    of = f" of {env_size}" if env_size else ""
    if cur_shard is None and shard_count is None:
        warnings.warn(f"A distributed launcher is active (rank {env_rank}{of}) but no"
                      " cur_shard/shard_count was given: every process will read ALL the data.")
    elif cur_shard != env_rank or (env_size is not None and shard_count != env_size):
        warnings.warn(f"cur_shard={cur_shard}/shard_count={shard_count} disagrees with the"
                      f" launcher (rank {env_rank}{of}); double-check your sharding arguments.")


def _wait_files_available(fs: pafs.FileSystem, paths: Sequence[str],
                          timeout_s: float = 30.0) -> None:
    """Poll until every path exists: object stores are eventually consistent."""
    deadline = time.monotonic() + timeout_s
    missing = list(paths)
    while missing:
        missing = [i.path for i in fs.get_file_info(missing)
                   if i.type == pafs.FileType.NotFound]
        if not missing:
            return
        if time.monotonic() > deadline:
            raise PetastormTpuError(
                f"Timed out after {timeout_s}s waiting for {len(missing)}"
                f" dataset files (e.g. {missing[0]!r}) to become visible")
        time.sleep(0.25)


def _advise_on_file_sizes(fs: pafs.FileSystem, paths: Sequence[str]) -> None:
    sizes = [i.size for i in fs.get_file_info(list(paths)) if i.type == pafs.FileType.File]
    if sizes and float(np.median(sizes)) < _MIN_ADVISED_FILE_SIZE_BYTES:
        logger.warning(
            "The median converted file size is %.1f MB (< %d MB). Small files"
            " hurt IO throughput; consider converting more data at once or"
            " raising row_group_size_mb.",
            float(np.median(sizes)) / 2**20, _MIN_ADVISED_FILE_SIZE_BYTES // 2**20)


def _parquet_files(fs: pafs.FileSystem, root: str) -> List[str]:
    return [i.path for i in fs.get_file_info(pafs.FileSelector(root))
            if i.type == pafs.FileType.File and i.path.endswith(".parquet")]


class _TfDatasetContextManager:
    """Owns the reader behind a ``tf.data.Dataset``; stops it on exit."""

    def __init__(self, reader, make_dataset):
        self._reader = reader
        self.dataset = make_dataset(reader)

    def __enter__(self):
        return self.dataset

    def __exit__(self, *exc):
        self._reader.stop()
        self._reader.join()


class DatasetConverter:
    """Handle on a converted (cached) dataset and its loader factories
    (the reference's ``SparkDatasetConverter``)."""

    def __init__(self, cache_url: str, file_urls: List[str], dataset_size: int,
                 schema: Schema, _owns_cache: bool = True,
                 storage_options: Optional[dict] = None):
        self.cache_url = cache_url
        self.file_urls = list(file_urls)
        self.dataset_size = dataset_size
        self.schema = schema
        self.storage_options = storage_options
        self._owns_cache = _owns_cache
        self._deleted = False

    def __len__(self) -> int:
        return self.dataset_size

    def _checked_reader(self, reader_kwargs: Optional[Dict]):
        reader_kwargs = dict(reader_kwargs or {})
        _check_shard_rank_env(reader_kwargs.get("cur_shard"), reader_kwargs.get("shard_count"))
        reader_kwargs.setdefault("storage_options", self.storage_options)
        return make_reader(self.cache_url, **reader_kwargs)

    def make_reader(self, **kwargs):
        """A ``petastorm_tpu_torch`` Reader over the cached dataset."""
        return self._checked_reader(kwargs)

    def _wrap(self, reader, make_loader):
        try:
            return make_loader(reader)
        except Exception:
            # otherwise the reader's pool threads poll forever
            reader.stop()
            reader.join()
            raise

    def make_cuda_loader(self, batch_size: int, device="cuda", mesh=None, shardings=None,
                         reader_kwargs: Optional[Dict] = None, **loader_kwargs):
        """``cuda.CudaDataLoader`` over the cached dataset, delivering batches
        on ``device`` (the card by default); a context manager.  The
        counterpart of ``make_jax_loader`` (``petastorm_tpu/converter.py:493``):
        with a ``mesh``, ``batch_size`` is global and each rank gets its
        block (``shardings``: placements, as ``CudaDataLoader`` takes them);
        the reader shard (``cur_shard``/``shard_count``) is the caller's, as
        in the JAX converter."""
        from petastorm_tpu_torch.cuda.loader import CudaDataLoader

        return self._wrap(self._checked_reader(reader_kwargs),
                          lambda reader: CudaDataLoader(reader, batch_size, device=device,
                                                        mesh=mesh, shardings=shardings,
                                                        **loader_kwargs))

    def make_torch_dataloader(self, batch_size: int = 32, shuffling_queue_capacity: int = 0,
                              reader_kwargs: Optional[Dict] = None, **loader_kwargs):
        """``pytorch.BatchedDataLoader`` over the cached dataset (the
        reference's ``make_torch_dataloader``): CPU tensors."""
        from petastorm_tpu_torch.pytorch import BatchedDataLoader

        return self._wrap(self._checked_reader(reader_kwargs),
                          lambda reader: BatchedDataLoader(
                              reader, batch_size=batch_size,
                              shuffling_queue_capacity=shuffling_queue_capacity,
                              **loader_kwargs))

    def make_tf_dataset(self, reader_kwargs: Optional[Dict] = None):
        """A context manager yielding a ``tf.data.Dataset`` over the cached
        dataset (``tf.make_petastorm_dataset``), its reader stopped on exit
        (the reference's ``TFDatasetContextManager``); ImportError without
        tensorflow."""
        from petastorm_tpu_torch.tf import make_petastorm_dataset

        return self._wrap(self._checked_reader(reader_kwargs),
                          lambda reader: _TfDatasetContextManager(reader,
                                                                  make_petastorm_dataset))

    def delete(self) -> None:
        """Remove the cached dataset's files (unless the handle does not own them)."""
        if self._deleted or not self._owns_cache:
            self._deleted = True
            return
        fs, root = get_filesystem_and_path(self.cache_url, self.storage_options)
        try:
            fs.delete_dir(root)
        except FileNotFoundError:
            pass
        self._deleted = True
        if self in _registered_converters:
            _registered_converters.remove(self)
        if _converters_by_url.get(self.cache_url) is self:
            del _converters_by_url[self.cache_url]


def make_converter(data, cache_dir_url: Optional[str] = None, *,
                   dtype: Optional[str] = "float32",
                   compression_codec: Optional[str] = None,
                   row_group_size_mb: float = DEFAULT_ROW_GROUP_SIZE_MB,
                   delete_at_exit: bool = True,
                   storage_options: Optional[dict] = None) -> DatasetConverter:
    """Write in-memory data to cached Parquet once and return its handle.

    ``data``: a pandas DataFrame, a pyarrow Table or a Spark DataFrame
    (written by its executors, deduplicated by its analyzed plan).
    ``cache_dir_url`` (else
    ``$PETASTORM_TPU_CONVERTER_CACHE_DIR``): a directory URL, local or
    remote (``storage_options`` go to its filesystem).  The same
    content and parameters give the same ``converted-<fingerprint>``
    directory as the JAX package's converter.
    """
    cache_dir_url = cache_dir_url or os.environ.get(CACHE_DIR_ENV_VAR)
    if not cache_dir_url:
        raise PetastormTpuError(
            f"No cache directory: pass cache_dir_url= or set ${CACHE_DIR_ENV_VAR}"
            " (the reference's petastorm.spark.converter.parentCacheDirUrl)")
    cache_dir_url = normalize_dir_url(cache_dir_url)
    if _is_spark_dataframe(data):
        return _make_spark_converter(data, cache_dir_url, dtype=dtype,
                                     compression_codec=compression_codec,
                                     row_group_size_mb=row_group_size_mb,
                                     delete_at_exit=delete_at_exit,
                                     storage_options=storage_options)

    table = _to_arrow_table(data, dtype)
    # the write below uses snappy when no codec is given: the parameters say
    # so, or an explicit 'snappy' would write a second, identical entry
    compression_codec = compression_codec or "snappy"
    params = {"codec": compression_codec, "rg_mb": row_group_size_mb, "v": 2}
    tag = _fingerprint(table, params)
    ds_url = posixpath.join(cache_dir_url, f"converted-{tag}")
    fs, root = get_filesystem_and_path(ds_url, storage_options)
    schema = Schema.from_arrow_schema(table.schema, name=f"Converted_{tag[:8]}")

    live = _share_live_handle(ds_url, delete_at_exit)
    if live is not None:
        return live
    if fs.get_file_info(root).type == pafs.FileType.Directory:
        files = _parquet_files(fs, root)
        if files:  # another process converted this content
            logger.info("Reusing cached converted dataset %s", ds_url)
            conv = DatasetConverter(ds_url, files, table.num_rows, schema,
                                    _owns_cache=delete_at_exit,
                                    storage_options=storage_options)
            _register_converter(conv, delete_at_exit)
            return conv
        _move_debris_aside(fs, root, ds_url)

    # a temporary directory, then one rename: converters of the same content
    # race benignly (one rename wins, both see a whole dataset)
    _, cache_root = get_filesystem_and_path(cache_dir_url, storage_options)
    tmp_root = posixpath.join(cache_root, f".tmp-{tag}-{uuid.uuid4().hex[:8]}")
    fs.create_dir(tmp_root, recursive=True)
    rows_per_group = max(1, int(row_group_size_mb * 2**20
                                / max(table.nbytes / max(table.num_rows, 1), 1)))
    stamped = table.replace_schema_metadata({SCHEMA_METADATA_KEY: schema.to_json().encode()})
    pq.write_table(stamped, posixpath.join(tmp_root, "part-00000.parquet"), filesystem=fs,
                   row_group_size=rows_per_group, compression=compression_codec)
    _publish_dir(fs, tmp_root, root)
    stamp_dataset_metadata(ds_url, schema, storage_options=storage_options)
    files = _parquet_files(fs, root)
    _wait_files_available(fs, files)
    _advise_on_file_sizes(fs, files)
    conv = DatasetConverter(ds_url, files, table.num_rows, schema, _owns_cache=delete_at_exit,
                            storage_options=storage_options)
    _register_converter(conv, delete_at_exit)
    return conv
