"""Dataset writer: rows -> Parquet files + stamped metadata.

Counterpart of ``petastorm_tpu/etl/writer.py:48-386``.  Rows are encoded
through the schema's codecs a rowgroup at a time and written with pyarrow;
``_common_metadata`` then carries the schema JSON, the per-file rowgroup
counts and the image-geometry contract under the same keys as the JAX
package, so either package reads the result.  ``partition_by`` writes hive
``key=value`` directories, buffering rows per partition so rows that
interleave across partitions make no runt rowgroups; ``mode='append'`` adds
files beside the existing ones and re-stamps the metadata over all of them;
a failed write deletes the files it made.  ``materialize_dataset`` stamps and
validates the metadata of parquet written inside its block by any engine.
"""

from __future__ import annotations

import contextlib
import json
import logging
import posixpath
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Union

import numpy as np
import pyarrow as pa
import pyarrow.fs as pafs
import pyarrow.parquet as pq

from petastorm_tpu_torch.codecs import CompressedImageCodec
from petastorm_tpu_torch.errors import MetadataError, SchemaError
from petastorm_tpu_torch.etl.metadata import (GEOMETRIES_METADATA_KEY, ROW_GROUPS_METADATA_KEY,
                                              collect_row_group_counts, hive_partition_segment,
                                              list_data_files, open_dataset, read_kv_metadata,
                                              write_metadata_file)
from petastorm_tpu_torch.fs import get_filesystem_and_path
from petastorm_tpu_torch.schema import SCHEMA_METADATA_KEY, Schema

logger = logging.getLogger(__name__)

DEFAULT_ROW_GROUP_SIZE_MB = 32
_ESTIMATE_CHUNK = 1024  # rows encoded to estimate bytes/row for MB-based sizing


def default_compression(schema: Schema, exclude: Optional[set] = None) -> Dict[str, str]:
    """Snappy, but no parquet compression for already entropy-coded columns;
    the ``exclude``d (partition) columns are not in the files."""
    exclude = exclude or set()
    return {f.name: ("NONE" if f.codec.precompressed else "SNAPPY")
            for f in schema if f.name not in exclude}


def _delete_files_best_effort(fs: pafs.FileSystem, paths: Iterable[str]) -> None:
    for path in paths:
        try:
            fs.delete_file(path)
        except Exception:  # noqa: BLE001 - already failing
            logger.warning("could not delete partial file %s after failed write", path,
                           exc_info=True)


def write_dataset(url: str,
                  schema: Schema,
                  rows: Iterable[dict],
                  row_group_size_rows: Optional[int] = None,
                  row_group_size_mb: Optional[float] = None,
                  rows_per_file: Optional[int] = None,
                  file_prefix: str = "part",
                  mode: str = "error",
                  encode_workers: int = 1,
                  partition_by: Sequence[str] = (),
                  compression: Optional[Union[str, Dict[str, str]]] = None,
                  stamp_metadata: bool = True,
                  geometry_sink: Optional[Dict[str, set]] = None,
                  filesystem: Optional[pafs.FileSystem] = None,
                  storage_options: Optional[dict] = None) -> List[str]:
    """Encode and write ``rows`` (dicts) as a dataset under ``url``; returns the files.

    Rowgroups hold ``row_group_size_rows`` rows, or as many as fit in
    ``row_group_size_mb`` (default 32) estimated from the first encoded chunk.
    ``mode`` is ``"error"`` (refuse a directory that holds data),
    ``"overwrite"`` (delete its contents first) or ``"append"`` (add files
    beside the existing ones; the metadata stamp then covers old and new).
    ``encode_workers`` > 1 encodes rows on a thread pool (the image encoders
    release the GIL); the output is the same either way.

    ``partition_by`` names scalar fields written as hive ``key=value``
    directories (a row needs a non-null value for each); they are not stored
    in the files.  ``compression``: a parquet codec name or ``{column:
    codec}``; by default snappy, except columns whose codec is
    ``precompressed`` (images, compressed ndarrays), which are stored
    uncompressed.  Every page carries a checksum (read back with
    ``make_reader(verify_checksums=True)``).

    The distinct shapes of variable-shape ``CompressedImageCodec`` fields
    are stamped as the dataset's geometry contract
    (``etl.metadata.declared_geometries``), merged over any already stamped;
    ``geometry_sink`` (``{field: set}``) collects them for a caller that
    stamps several writers' files at once (``stamp_metadata=False``).  A
    failed write deletes the files it made.

    ``filesystem`` / ``storage_options``: as for
    ``fs.get_filesystem_and_path`` (a remote URL, or a filesystem of the
    caller's, such as a credentialed S3 or an fsspec store).
    """
    if mode not in ("error", "overwrite", "append"):
        raise ValueError(f"mode must be 'error', 'overwrite' or 'append', got {mode!r}")
    for pcol in partition_by:
        if pcol not in schema:
            raise SchemaError(f"partition_by field {pcol!r} not in schema")
        if schema[pcol].shape != ():
            raise SchemaError(f"partition_by field {pcol!r} must be scalar")
    fs, root = get_filesystem_and_path(url, storage_options, filesystem)
    if mode != "append" and fs.get_file_info(root).type == pafs.FileType.Directory:
        existing = list_data_files(fs, root)
        if existing and mode == "error":
            raise SchemaError(
                f"Dataset path {url!r} already contains {len(existing)} data"
                " file(s); pass mode='overwrite' to replace or mode='append'"
                " to add to it")
        if existing:
            fs.delete_dir_contents(root)
    fs.create_dir(root, recursive=True)

    partitioned = set(partition_by)
    storage = schema.as_arrow_schema()
    file_schema = pa.schema([storage.field(f.name) for f in schema if f.name not in partitioned],
                            metadata={SCHEMA_METADATA_KEY: schema.to_json()})
    if compression is None:
        compression = default_compression(schema, exclude=partitioned)
    # the dataset-level geometry contract: the distinct shapes of
    # variable-shape image fields, recorded while the rows stream by
    geom_fields = [f.name for f in schema if isinstance(f.codec, CompressedImageCodec)
                   and not f.is_fixed_shape]
    geom_seen: Dict[str, set] = geometry_sink if geometry_sink is not None else {}
    for name in geom_fields:
        geom_seen.setdefault(name, set())

    writers: Dict[str, pq.ParquetWriter] = {}
    rows_written: Dict[str, int] = {}
    files: List[str] = []
    pending: Dict[tuple, List[dict]] = {}
    rows_per_group = row_group_size_rows

    def encode(chunk: List[dict]) -> pa.Table:
        encoded = list(pool.map(schema.encode_row, chunk) if pool else
                       map(schema.encode_row, chunk))
        return pa.Table.from_arrays(
            [pa.array([r[name] for r in encoded], type=file_schema.field(name).type)
             for name in file_schema.names], schema=file_schema)

    def writer_for(key: str) -> pq.ParquetWriter:
        if key not in writers:
            subdir = posixpath.join(root, key) if key else root
            fs.create_dir(subdir, recursive=True)
            path = posixpath.join(subdir, f"{file_prefix}-{len(files):05d}-"
                                          f"{uuid.uuid4().hex[:8]}.parquet")
            writers[key] = pq.ParquetWriter(path, file_schema, filesystem=fs,
                                            compression=compression, write_page_checksum=True)
            files.append(path)
            rows_written[key] = 0
        return writers[key]

    def flush(pv: tuple, final: bool) -> None:
        """Write full rowgroups from a partition's buffer; keep the rest."""
        nonlocal rows_per_group
        buf = pending.get(pv, [])
        threshold = rows_per_group or _ESTIMATE_CHUNK
        key = "/".join(hive_partition_segment(k, v) for k, v in pv)
        while buf and (final or len(buf) >= threshold):
            chunk, buf = buf[:threshold], buf[threshold:]
            table = encode(chunk)
            if rows_per_group is None:
                per_row = max(table.nbytes, 1) / max(table.num_rows, 1)
                rows_per_group = threshold = max(1, int(
                    (row_group_size_mb or DEFAULT_ROW_GROUP_SIZE_MB) * 1024 * 1024 / per_row))
            writer_for(key).write_table(table, row_group_size=rows_per_group)
            rows_written[key] += table.num_rows
            if rows_per_file and rows_written[key] >= rows_per_file:
                writers.pop(key).close()
                rows_written[key] = 0
        pending[pv] = buf

    pool = ThreadPoolExecutor(encode_workers) if encode_workers > 1 else None
    failed = False
    try:
        for row in rows:
            for k in partition_by:
                if row.get(k) is None:
                    raise SchemaError(f"Row is missing a value for partition field {k!r}"
                                      " (partition values must be non-null)")
            pv = tuple((k, str(row[k])) for k in partition_by)
            for name in geom_fields:
                value = row.get(name)
                if value is not None:
                    geom_seen[name].add(tuple(np.asarray(value).shape))
            pending.setdefault(pv, []).append(row)
            if len(pending[pv]) >= (rows_per_group or _ESTIMATE_CHUNK):
                flush(pv, final=False)
        for pv in list(pending):
            flush(pv, final=True)
    except BaseException:
        failed = True
        raise
    finally:
        if pool is not None:
            pool.shutdown(wait=True)
        if failed:
            # closing writes footers: the debris would parse as complete
            # parquet that a later append or stamp adopts, so delete it
            for w in writers.values():
                try:
                    w.close()
                except Exception:  # noqa: BLE001 - already failing
                    logger.warning("could not close parquet writer after failed write",
                                   exc_info=True)
            _delete_files_best_effort(fs, files)
    close_exc = None
    for w in writers.values():
        try:
            w.close()
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            if close_exc is None:
                close_exc = exc
    if close_exc is not None:
        # a footer failed: none of this call's files may survive to be adopted
        _delete_files_best_effort(fs, files)
        raise close_exc
    if not files:
        logger.warning("write_dataset(%s): no rows were written; dataset left empty", url)
        return []
    if stamp_metadata:
        stamp_dataset_metadata(url, schema, geometries={n: s for n, s in geom_seen.items()
                                                        if s} or None,
                               filesystem=filesystem, storage_options=storage_options)
    return files


def stamp_dataset_metadata(url: str, schema: Optional[Schema] = None,
                           validate: bool = True,
                           geometries: Optional[Dict[str, Iterable]] = None,
                           merge_geometries: bool = True,
                           filesystem: Optional[pafs.FileSystem] = None,
                           storage_options: Optional[dict] = None) -> None:
    """Write or refresh ``_common_metadata``: the schema JSON (``schema``,
    or the one the data files carry), the per-file rowgroup counts and, with
    ``geometries`` (``{field: shapes}``), the geometry contract, merged over
    the shapes already stamped unless ``merge_geometries=False`` (a full
    rescan, which replaces them).  ``validate`` reopens the dataset.
    (``petastorm_tpu/etl/writer.py:310``.)"""
    fs, root = get_filesystem_and_path(url, storage_options, filesystem)
    files = list_data_files(fs, root)
    if not files:
        raise MetadataError(f"No data files under {url!r} to stamp metadata for")
    counts = collect_row_group_counts(fs, root, files)
    with fs.open_input_file(files[0]) as f:
        arrow_schema = pq.ParquetFile(f).schema_arrow
    if schema is None:
        file_kv = arrow_schema.metadata or {}
        if SCHEMA_METADATA_KEY not in file_kv:
            raise MetadataError(
                "No schema given and data files carry no petastorm-tpu schema;"
                " pass schema= explicitly")
        schema = Schema.from_json(file_kv[SCHEMA_METADATA_KEY])
    kv = {SCHEMA_METADATA_KEY: schema.to_json().encode(),
          ROW_GROUPS_METADATA_KEY: json.dumps({"files": counts}).encode()}
    # an empty authoritative rescan must replace the stamped contract
    if geometries or (geometries is not None and not merge_geometries):
        merged: Dict[str, set] = {n: {tuple(int(d) for d in s) for s in shapes}
                                  for n, shapes in geometries.items()}
        existing = (read_kv_metadata(fs, root).get(GEOMETRIES_METADATA_KEY)
                    if merge_geometries else None)
        if existing:
            try:
                for n, shapes in json.loads(existing).items():
                    merged.setdefault(n, set()).update(tuple(int(d) for d in s)
                                                       for s in shapes)
            except (ValueError, TypeError):
                logger.warning("discarding unparseable stamped geometry metadata"
                               " during re-stamp")
        kv[GEOMETRIES_METADATA_KEY] = json.dumps(
            {n: sorted(list(s) for s in shapes) for n, shapes in merged.items()}).encode()
    write_metadata_file(fs, root, arrow_schema, kv)
    if validate:
        info = open_dataset(url, storage_options, filesystem, require_stored_schema=True)
        if not info.row_groups:
            raise MetadataError(f"Validation failed: no rowgroups visible at {url!r}")


@contextlib.contextmanager
def materialize_dataset(url: str, schema: Schema,
                        filesystem: Optional[pafs.FileSystem] = None,
                        storage_options: Optional[dict] = None) -> Iterator[None]:
    """Context manager: write parquet under ``url`` inside the block by any
    engine (cells in the schema's storage types: ``schema.encode_row``);
    the metadata is stamped and validated on exit, through ``filesystem`` /
    ``storage_options`` as ``write_dataset`` takes them."""
    yield
    stamp_dataset_metadata(url, schema, filesystem=filesystem, storage_options=storage_options)
