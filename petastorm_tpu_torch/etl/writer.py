"""Dataset writer: rows -> Parquet files + stamped metadata.

Counterpart of ``petastorm_tpu/etl/writer.py:84-300``.  Rows are encoded
through the schema's codecs a rowgroup at a time and written with pyarrow;
``_common_metadata`` then carries the schema JSON and the per-file rowgroup
counts under the same keys as the JAX package, so either package reads the
result.  Hive partitioning, appends and the image-geometry stamp are not part
of this package yet.
"""

from __future__ import annotations

import json
import posixpath
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, List, Optional

import pyarrow as pa
import pyarrow.fs as pafs
import pyarrow.parquet as pq

from petastorm_tpu_torch.errors import SchemaError
from petastorm_tpu_torch.etl.metadata import (ROW_GROUPS_METADATA_KEY,
                                              collect_row_group_counts,
                                              list_data_files, write_metadata_file)
from petastorm_tpu_torch.fs import get_filesystem_and_path
from petastorm_tpu_torch.schema import SCHEMA_METADATA_KEY, Schema

DEFAULT_ROW_GROUP_SIZE_MB = 32
_ESTIMATE_CHUNK = 1024  # rows encoded to estimate bytes/row for MB-based sizing


def default_compression(schema: Schema) -> Dict[str, str]:
    """Snappy, but no parquet compression for already entropy-coded columns."""
    return {f.name: ("NONE" if f.codec.precompressed else "SNAPPY") for f in schema}


def write_dataset(url: str,
                  schema: Schema,
                  rows: Iterable[dict],
                  row_group_size_rows: Optional[int] = None,
                  row_group_size_mb: Optional[float] = None,
                  rows_per_file: Optional[int] = None,
                  file_prefix: str = "part",
                  mode: str = "error",
                  encode_workers: int = 1) -> List[str]:
    """Encode and write ``rows`` (dicts) as a dataset under ``url``; returns the files.

    Rowgroups hold ``row_group_size_rows`` rows, or as many as fit in
    ``row_group_size_mb`` (default 32) estimated from the first encoded chunk.
    ``mode`` is ``"error"`` (refuse a directory that holds data) or
    ``"overwrite"``.  ``encode_workers`` > 1 encodes rows on a thread pool
    (the image encoders release the GIL); the output is the same either way.
    """
    if mode not in ("error", "overwrite"):
        raise ValueError(f"mode must be 'error' or 'overwrite', got {mode!r}")
    fs, root = get_filesystem_and_path(url)
    if fs.get_file_info(root).type == pafs.FileType.Directory:
        existing = list_data_files(fs, root)
        if existing and mode == "error":
            raise SchemaError(
                f"Dataset path {url!r} already contains {len(existing)} data"
                " file(s); pass mode='overwrite' to replace it")
        fs.delete_dir_contents(root)
    fs.create_dir(root, recursive=True)

    file_schema = schema.as_arrow_schema().with_metadata(
        {SCHEMA_METADATA_KEY: schema.to_json()})
    compression = default_compression(schema)
    files: List[str] = []
    writer: Optional[pq.ParquetWriter] = None
    rows_in_file = 0
    rows_per_group = row_group_size_rows

    def encode(chunk: List[dict]) -> pa.Table:
        encoded = list(pool.map(schema.encode_row, chunk) if pool else
                       map(schema.encode_row, chunk))
        return pa.Table.from_arrays(
            [pa.array([r[f.name] for r in encoded], type=file_schema.field(f.name).type)
             for f in schema], schema=file_schema)

    def flush(chunk: List[dict]) -> None:
        nonlocal writer, rows_in_file, rows_per_group
        table = encode(chunk)
        if rows_per_group is None:
            per_row = max(table.nbytes, 1) / max(table.num_rows, 1)
            rows_per_group = max(1, int((row_group_size_mb or DEFAULT_ROW_GROUP_SIZE_MB)
                                        * 1024 * 1024 / per_row))
        if writer is None:
            path = posixpath.join(root, f"{file_prefix}-{len(files):05d}-"
                                        f"{uuid.uuid4().hex[:8]}.parquet")
            writer = pq.ParquetWriter(path, file_schema, filesystem=fs,
                                      compression=compression, write_page_checksum=True)
            files.append(path)
        writer.write_table(table, row_group_size=rows_per_group)
        rows_in_file += table.num_rows
        if rows_per_file and rows_in_file >= rows_per_file:
            writer.close()
            writer, rows_in_file = None, 0

    pool = ThreadPoolExecutor(encode_workers) if encode_workers > 1 else None
    try:
        pending: List[dict] = []
        for row in rows:
            pending.append(row)
            if len(pending) >= (rows_per_group or _ESTIMATE_CHUNK):
                flush(pending)
                pending = []
        if pending:
            flush(pending)
    finally:
        if pool is not None:
            pool.shutdown(wait=True)
        if writer is not None:
            writer.close()
    if files:
        stamp_dataset_metadata(url, schema)
    return files


def stamp_dataset_metadata(url: str, schema: Schema) -> None:
    """Write ``_common_metadata``: the schema JSON and per-file rowgroup counts."""
    fs, root = get_filesystem_and_path(url)
    files = list_data_files(fs, root)
    with fs.open_input_file(files[0]) as f:
        arrow_schema = pq.ParquetFile(f).schema_arrow
    kv = {SCHEMA_METADATA_KEY: schema.to_json().encode(),
          ROW_GROUPS_METADATA_KEY: json.dumps(
              {"files": collect_row_group_counts(fs, root, files)}).encode()}
    write_metadata_file(fs, root, arrow_schema, kv)
