"""Dataset discovery: schema and rowgroup enumeration.

Counterpart of ``petastorm_tpu/etl/metadata.py:52-345``: the same key-value
metadata keys (schema JSON, per-file rowgroup row counts in
``_common_metadata``) and the same rowgroup order (files path-sorted,
rowgroups in file order), so ``RowGroupRef.global_index`` - the ordinal the
read plan permutes - agrees between the two packages.  Hive partitions,
legacy petastorm metadata and retries are not part of this package yet.
"""

from __future__ import annotations

import dataclasses
import json
import posixpath
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import pyarrow as pa
import pyarrow.fs as pafs
import pyarrow.parquet as pq

from petastorm_tpu_torch.errors import MetadataError
from petastorm_tpu_torch.fs import get_filesystem_and_path
from petastorm_tpu_torch.schema import SCHEMA_METADATA_KEY, Schema

#: Parquet KV key: JSON ``{"files": {relative_path: [rows_in_rg0, ...]}}``
ROW_GROUPS_METADATA_KEY = b"petastorm-tpu.row_groups_per_file.v1"
#: Parquet KV key: JSON rowgroup index (``etl/indexing.py``)
ROWGROUP_INDEX_METADATA_KEY = b"petastorm-tpu.rowgroup_index.v1"
#: Parquet KV key of the legacy petastorm rowgroup index (pickled; read by
#: the JAX package's ``interop.py``, which this package has not ported)
LEGACY_INDEX_KEY = b"dataset-toolkit.rowgroups_index.v1"

_METADATA_FILENAMES = ("_common_metadata", "_metadata")
_FOOTER_READ_THREADS = 10


@dataclasses.dataclass(frozen=True)
class RowGroupRef:
    """One unit of read work: a single rowgroup of a single file."""

    path: str
    row_group: int
    num_rows: int
    #: ordinal across the dataset (files path-sorted, rowgroups in file order)
    global_index: int


@dataclasses.dataclass
class DatasetInfo:
    """Resolved dataset: filesystem, files, schemas, rowgroups, KV metadata."""

    url: str
    filesystem: pafs.FileSystem
    root_path: str
    files: List[str]
    arrow_schema: pa.Schema
    kv_metadata: Dict[bytes, bytes]
    row_groups: List[RowGroupRef]
    stored_schema: Optional[Schema]


def is_data_file(path: str) -> bool:
    name = posixpath.basename(path)
    return not (name.startswith("_") or name.startswith(".") or name.endswith(".crc"))


def list_data_files(fs: pafs.FileSystem, root: str) -> List[str]:
    return sorted(f.path for f in fs.get_file_info(pafs.FileSelector(root, recursive=True))
                  if f.type == pafs.FileType.File and is_data_file(f.path))


def read_kv_metadata(fs: pafs.FileSystem, root: str) -> Dict[bytes, bytes]:
    """KV metadata of ``_common_metadata``/``_metadata`` if present, else {}."""
    for name in _METADATA_FILENAMES:
        mpath = posixpath.join(root, name)
        if fs.get_file_info(mpath).type == pafs.FileType.File:
            return dict(pq.read_metadata(mpath, filesystem=fs).metadata or {})
    return {}


def _footer_row_groups(fs: pafs.FileSystem, path: str) -> List[int]:
    with fs.open_input_file(path) as f:
        md = pq.ParquetFile(f).metadata
        return [md.row_group(i).num_rows for i in range(md.num_row_groups)]


def collect_row_group_counts(fs: pafs.FileSystem, root: str,
                             files: List[str]) -> Dict[str, List[int]]:
    """Per-file rowgroup row counts keyed by path relative to ``root``."""
    files = sorted(files)
    with ThreadPoolExecutor(max_workers=_FOOTER_READ_THREADS) as pool:
        results = list(pool.map(lambda p: _footer_row_groups(fs, p), files))
    return {posixpath.relpath(f, root): counts for f, counts in zip(files, results)}


def load_row_groups(fs: pafs.FileSystem, root: str, files: List[str],
                    kv_metadata: Dict[bytes, bytes]) -> List[RowGroupRef]:
    """Enumerate rowgroups of path-sorted ``files``: from the stamped counts
    when they cover every file, else from the file footers."""
    files = sorted(files)
    counts = None
    if ROW_GROUPS_METADATA_KEY in kv_metadata:
        counts = json.loads(kv_metadata[ROW_GROUPS_METADATA_KEY])["files"]
        if any(posixpath.relpath(f, root) not in counts for f in files):
            counts = None
    if counts is None:
        counts = collect_row_group_counts(fs, root, files)
    refs: List[RowGroupRef] = []
    for f in files:
        for rg_idx, nrows in enumerate(counts[posixpath.relpath(f, root)]):
            refs.append(RowGroupRef(f, rg_idx, nrows, len(refs)))
    return refs


def open_dataset(url: str, require_stored_schema: bool = False) -> DatasetInfo:
    """Resolve a dataset directory (or one parquet file) to a DatasetInfo."""
    fs, root = get_filesystem_and_path(url)
    info = fs.get_file_info(root)
    if info.type == pafs.FileType.NotFound:
        raise MetadataError(f"Dataset path not found: {url!r}")
    if info.type == pafs.FileType.File:
        files, root = [root], posixpath.dirname(root)
    else:
        files = list_data_files(fs, root)
    if not files:
        raise MetadataError(f"No parquet data files found under {url!r}")
    kv = read_kv_metadata(fs, root)
    with fs.open_input_file(files[0]) as f:
        arrow_schema = pq.ParquetFile(f).schema_arrow
    if SCHEMA_METADATA_KEY not in kv and SCHEMA_METADATA_KEY in (arrow_schema.metadata or {}):
        kv = {**arrow_schema.metadata, **kv}
    stored_schema = (Schema.from_json(kv[SCHEMA_METADATA_KEY])
                     if SCHEMA_METADATA_KEY in kv else None)
    if require_stored_schema and stored_schema is None:
        raise MetadataError(
            f"Dataset at {url!r} has no petastorm-tpu schema metadata; use"
            " make_batch_reader for plain parquet stores")
    return DatasetInfo(url, fs, root, files, arrow_schema.remove_metadata(), kv,
                       load_row_groups(fs, root, files, kv), stored_schema)


def infer_or_load_schema(info: DatasetInfo) -> Schema:
    """The stored schema if present, else one inferred from the arrow schema."""
    if info.stored_schema is not None:
        return info.stored_schema
    return Schema.from_arrow_schema(info.arrow_schema)


def write_metadata_file(fs: pafs.FileSystem, root: str, arrow_schema: pa.Schema,
                        kv_metadata: Dict[bytes, bytes]) -> None:
    """Write ``_common_metadata`` with the KV merged over any existing one."""
    merged = {**read_kv_metadata(fs, root), **kv_metadata}
    pq.write_metadata(arrow_schema.with_metadata(merged),
                      posixpath.join(root, "_common_metadata"), filesystem=fs)
