"""Dataset discovery: schema and rowgroup enumeration.

Counterpart of ``petastorm_tpu/etl/metadata.py:52-381``: the same key-value
metadata keys (schema JSON, per-file rowgroup row counts and image
geometries in ``_common_metadata``) and the same rowgroup order (files
path-sorted, rowgroups in file order), so ``RowGroupRef.global_index`` - the
ordinal the read plan permutes - agrees between the two packages.  A dataset
is a directory (hive ``key=value`` partition directories included) or a
list of file or directory URLs; each rowgroup carries its file's partition
values, and the dataset's arrow schema is discovered with
``HivePartitioning``, so it holds the partition keys too.  On a remote
filesystem the listing, the key-value metadata and the footer reads go
through ``retry.retry_call`` (``:205-325``; ``io_retries='auto'`` retries on
any filesystem that is not local).  A dataset written by the original
Petastorm carries a pickled Unischema instead of the schema JSON: it is
loaded through ``interop.load_legacy_schema`` (``:302-318``), and its
per-file rowgroup counts cross-check the footers (``:146-170``).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import posixpath
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple, Union
from urllib.parse import quote, unquote

import pyarrow as pa
import pyarrow.dataset as pads
import pyarrow.fs as pafs
import pyarrow.parquet as pq

from petastorm_tpu_torch.errors import MetadataError
from petastorm_tpu_torch.fs import get_filesystem_and_path_or_paths
from petastorm_tpu_torch.retry import resolve_retry_policy, retry_call
from petastorm_tpu_torch.schema import SCHEMA_METADATA_KEY, Schema

logger = logging.getLogger(__name__)

#: Parquet KV key: JSON ``{"files": {relative_path: [rows_in_rg0, ...]}}``
ROW_GROUPS_METADATA_KEY = b"petastorm-tpu.row_groups_per_file.v1"
#: Parquet KV key: per-field distinct image shapes of variable-shape image
#: fields, stamped at write time: JSON ``{field: [[h, w, c], ...]}``
GEOMETRIES_METADATA_KEY = b"petastorm-tpu.image_geometries.v1"
#: Parquet KV key: JSON rowgroup index (``etl/indexing.py``)
ROWGROUP_INDEX_METADATA_KEY = b"petastorm-tpu.rowgroup_index.v1"

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
    #: the file's hive ``key=value`` pairs, in path order
    partition_values: Tuple[Tuple[str, str], ...] = ()


@dataclasses.dataclass
class DatasetInfo:
    """Resolved dataset: filesystem, files, schemas, rowgroups, KV metadata.

    ``url`` and ``path`` are what was opened (one, or a list); ``root_path``
    is the dataset root above any partition directories, where
    ``_common_metadata`` lives and partition parsing anchors."""

    url: Union[str, List[str]]
    filesystem: pafs.FileSystem
    path: Union[str, List[str]]
    root_path: str
    files: List[str]
    arrow_schema: pa.Schema
    kv_metadata: Dict[bytes, bytes]
    row_groups: List[RowGroupRef]
    stored_schema: Optional[Schema]
    #: transient failures retried while the dataset was opened
    retries: int = 0

    @property
    def partition_keys(self) -> List[str]:
        """Hive partition key names, in first-seen rowgroup order."""
        keys: List[str] = []
        for rg in self.row_groups:
            for k, _ in rg.partition_values:
                if k not in keys:
                    keys.append(k)
        return keys


def hive_partition_segment(key: str, value) -> str:
    """``key=value`` path segment with the value percent-encoded, so '/',
    '=' and '%' in a value cannot corrupt the path structure."""
    return f"{key}={quote(str(value), safe='')}"


def parse_hive_partitions(root: str, file_path: str) -> Tuple[Tuple[str, str], ...]:
    """The hive ``key=value`` pairs of the directories between ``root`` and
    ``file_path``."""
    rel = file_path[len(root):].lstrip("/") if file_path.startswith(root) else file_path
    pairs = []
    for seg in rel.split("/")[:-1]:
        if "=" in seg:
            k, _, v = seg.partition("=")
            pairs.append((k, unquote(v)))
    return tuple(pairs)


def is_data_file(path: str) -> bool:
    name = posixpath.basename(path)
    return not (name.startswith("_") or name.startswith(".") or name.endswith(".crc"))


def list_data_files(fs: pafs.FileSystem, root: str) -> List[str]:
    return sorted(f.path for f in fs.get_file_info(pafs.FileSelector(root, recursive=True))
                  if f.type == pafs.FileType.File and is_data_file(f.path))


def read_kv_metadata(fs: pafs.FileSystem, root: str) -> Dict[bytes, bytes]:
    """KV metadata of ``_common_metadata``/``_metadata`` if present, else {}.
    A probe that fails counts as absent, as in the JAX package (``:127``)."""
    for name in _METADATA_FILENAMES:
        mpath = posixpath.join(root, name)
        try:
            info = fs.get_file_info(mpath)
        except (OSError, pa.ArrowInvalid):
            continue
        if info.type == pafs.FileType.File:
            try:
                return dict(pq.read_metadata(mpath, filesystem=fs).metadata or {})
            except (pa.ArrowInvalid, OSError) as exc:
                logger.warning("Failed reading %s: %s", mpath, exc)
    return {}


def _footer_row_groups(fs: pafs.FileSystem, path: str) -> List[int]:
    with fs.open_input_file(path) as f:
        md = pq.ParquetFile(f).metadata
        return [md.row_group(i).num_rows for i in range(md.num_row_groups)]


def _check_legacy_row_group_counts(kv_metadata: Dict[bytes, bytes], root: str,
                                   counts: Dict[str, List[int]]) -> None:
    """Warn when a legacy petastorm
    ``dataset-toolkit.num_row_groups_per_file.v1`` payload (``{relpath:
    count}``) disagrees with the footers' rowgroup counts: the files were
    rewritten after the metadata (``petastorm_tpu/etl/metadata.py:146-170``).
    It holds no row counts, so it never replaces the footer reads."""
    from petastorm_tpu_torch.interop import LEGACY_ROW_GROUPS_KEY

    raw = kv_metadata.get(LEGACY_ROW_GROUPS_KEY)
    if not raw:
        return
    try:
        legacy_counts = json.loads(raw)
    except ValueError:
        logger.warning("Corrupt legacy %s payload; ignoring", LEGACY_ROW_GROUPS_KEY)
        return
    for rel, rg_rows in counts.items():
        if rel in legacy_counts and legacy_counts[rel] != len(rg_rows):
            logger.warning(
                "Legacy petastorm metadata is stale for %s: recorded %d rowgroups,"
                " file has %d (dataset rewritten after materialize?)",
                rel, legacy_counts[rel], len(rg_rows))


def collect_row_group_counts(fs: pafs.FileSystem, root: str,
                             files: List[str], retry=None) -> Dict[str, List[int]]:
    """Per-file rowgroup row counts keyed by path relative to ``root``."""
    files = sorted(files)

    def footer(p: str) -> List[int]:
        if retry is None:
            return _footer_row_groups(fs, p)
        return retry(lambda: _footer_row_groups(fs, p), f"footer of {p}")

    with ThreadPoolExecutor(max_workers=_FOOTER_READ_THREADS) as pool:
        results = list(pool.map(footer, files))
    return {posixpath.relpath(f, root): counts for f, counts in zip(files, results)}


def load_row_groups(fs: pafs.FileSystem, root: str, files: List[str],
                    kv_metadata: Dict[bytes, bytes], retry=None) -> List[RowGroupRef]:
    """Enumerate rowgroups of path-sorted ``files``: from the stamped counts
    when they cover every file, else from the file footers (each footer
    read through ``retry(fn, what)`` when given)."""
    files = sorted(files)
    counts = None
    if ROW_GROUPS_METADATA_KEY in kv_metadata:
        try:
            counts = json.loads(kv_metadata[ROW_GROUPS_METADATA_KEY])["files"]
        except (ValueError, KeyError) as exc:
            logger.warning("Corrupt %s payload (%s); falling back to footer reads",
                           ROW_GROUPS_METADATA_KEY, exc)
        if counts is not None and any(posixpath.relpath(f, root) not in counts
                                      for f in files):
            counts = None
    if counts is None:
        counts = collect_row_group_counts(fs, root, files, retry)
        _check_legacy_row_group_counts(kv_metadata, root, counts)
    refs: List[RowGroupRef] = []
    for f in files:
        parts = parse_hive_partitions(root, f)
        for rg_idx, nrows in enumerate(counts[posixpath.relpath(f, root)]):
            refs.append(RowGroupRef(f, rg_idx, nrows, len(refs), parts))
    return refs


def _list_files(fs: pafs.FileSystem, url_or_urls, path_or_paths,
                list_info=None) -> Tuple[List[str], str]:
    """(the path-sorted data files, the dataset root) of a directory, a
    file, or a list of files and directories (``:246-284``).  A list's root
    is its files' common directory with trailing ``key=value`` segments
    stripped: partition values survive for a list spanning partitions and
    for one drawn from a single partition, and ``_common_metadata`` at the
    true root is found.  ``list_info`` stands in for ``fs.get_file_info``
    (the retried listing)."""
    list_info = list_info or fs.get_file_info

    def data_files(root: str) -> List[str]:
        return sorted(f.path for f in list_info(pafs.FileSelector(root, recursive=True))
                      if f.type == pafs.FileType.File and is_data_file(f.path))

    if isinstance(path_or_paths, str):
        root = path_or_paths
        info = list_info(root)
        if info.type == pafs.FileType.NotFound:
            raise MetadataError(f"Dataset path not found: {url_or_urls!r}")
        if info.type == pafs.FileType.File:
            return [root], posixpath.dirname(root)
        return data_files(root), root
    files: List[str] = []
    for p in path_or_paths:
        info = list_info(p)
        if info.type == pafs.FileType.NotFound:
            raise MetadataError(f"Dataset path not found: {p!r}")
        files.extend([p] if info.type == pafs.FileType.File else data_files(p))
    files = sorted(files)
    dirs = [posixpath.dirname(f) for f in files]
    root = posixpath.commonpath(dirs) if len(set(dirs)) > 1 else (dirs[0] if dirs else "")
    while root and "=" in posixpath.basename(root):
        root = posixpath.dirname(root)
    return files, root


def open_dataset(url_or_urls: Union[str, Sequence[str]],
                 storage_options: Optional[dict] = None,
                 filesystem: Optional[pafs.FileSystem] = None,
                 require_stored_schema: bool = False,
                 io_retries="auto", telemetry=None) -> DatasetInfo:
    """Resolve a dataset directory, one parquet file, or a list of file or
    directory URLs to a DatasetInfo (``petastorm_tpu/etl/metadata.py:221``).

    ``storage_options`` and ``filesystem`` as for
    ``fs.get_filesystem_and_path``.  ``io_retries``: the transient-failure
    policy of the listing, key-value and footer reads
    (``retry.resolve_retry_policy``: ``'auto'`` retries on remote
    filesystems only); ``DatasetInfo.retries`` counts the retries taken, and
    ``telemetry`` as ``io.retries``."""
    fs, path_or_paths = get_filesystem_and_path_or_paths(url_or_urls, storage_options,
                                                         filesystem)
    policy = resolve_retry_policy(io_retries, fs)
    retried = [0]

    def count(_exc) -> None:
        retried[0] += 1

    def retry(fn, what: str):
        return retry_call(fn, policy, what=what, on_retry=count, telemetry=telemetry)

    def list_info(selector):
        return retry(lambda: fs.get_file_info(selector),
                     f"listing {getattr(selector, 'base_dir', selector)}")

    files, root = _list_files(fs, url_or_urls, path_or_paths, list_info)
    if not files:
        raise MetadataError(f"No parquet data files found under {url_or_urls!r}")
    kv = retry(lambda: read_kv_metadata(fs, root), f"metadata of {root}")
    if SCHEMA_METADATA_KEY not in kv:
        # the schema may be stamped in the data files' footers instead
        def file_kv():
            with fs.open_input_file(files[0]) as f:
                return pq.ParquetFile(f).schema_arrow.metadata or {}

        footer_kv = retry(file_kv, f"schema footer of {files[0]}")
        if SCHEMA_METADATA_KEY in footer_kv:
            kv = {**footer_kv, **kv}
    stored_schema = (Schema.from_json(kv[SCHEMA_METADATA_KEY])
                     if SCHEMA_METADATA_KEY in kv else None)
    if stored_schema is None:
        # written by the original Petastorm: a pickled Unischema under
        # dataset-toolkit.unischema.v1
        from petastorm_tpu_torch import interop

        legacy_blob = kv.get(interop.LEGACY_UNISCHEMA_KEY)
        if legacy_blob:
            # an undecodable blob (a codec outside the unpickler's list) must
            # not break make_batch_reader, which reads such a dataset by
            # inference
            try:
                stored_schema = interop.load_legacy_schema(legacy_blob)
                logger.info("Loaded legacy petastorm unischema %r from %s",
                            stored_schema.name, url_or_urls)
            except Exception as exc:
                logger.warning(
                    "Dataset at %s has a legacy petastorm unischema that could"
                    " not be converted (%s); falling back to arrow schema"
                    " inference", url_or_urls, exc)
    if require_stored_schema and stored_schema is None:
        raise MetadataError(
            f"Dataset at {url_or_urls!r} has no petastorm-tpu schema metadata; use"
            " make_batch_reader for plain parquet stores, or regenerate metadata with"
            " etl.generate_metadata")
    dset = retry(lambda: pads.dataset(files, filesystem=fs, format="parquet",
                                      partitioning=pads.HivePartitioning.discover()),
                 f"dataset schema of {root}")
    row_groups = load_row_groups(fs, root, files, kv, retry)
    return DatasetInfo(url_or_urls, fs, path_or_paths, root, files, dset.schema, kv,
                       row_groups, stored_schema, retries=retried[0])


def infer_or_load_schema(info: DatasetInfo) -> Schema:
    """The stored schema if present, else one inferred from the arrow
    schema, with the partition keys as fields."""
    if info.stored_schema is not None:
        return info.stored_schema
    return Schema.from_arrow_schema(info.arrow_schema, name="inferred",
                                    partition_columns=info.partition_keys)


def declared_geometries(info: DatasetInfo) -> Dict[str, List[tuple]]:
    """Per-field distinct image shapes from the dataset's KV metadata, or {}
    (``petastorm_tpu/etl/metadata.py:347``): the dataset-level geometry
    contract stamped for variable-shape ``CompressedImageCodec`` fields."""
    raw = info.kv_metadata.get(GEOMETRIES_METADATA_KEY)
    if not raw:
        return {}
    try:
        parsed = json.loads(raw)
    except (ValueError, TypeError):
        logger.warning("unparseable %s metadata ignored", GEOMETRIES_METADATA_KEY)
        return {}
    return {name: [tuple(int(d) for d in shape) for shape in shapes]
            for name, shapes in parsed.items()}


def write_metadata_file(fs: pafs.FileSystem, root: str, arrow_schema: pa.Schema,
                        kv_metadata: Dict[bytes, bytes]) -> None:
    """Write ``_common_metadata`` with the KV merged over any existing one."""
    merged = {**read_kv_metadata(fs, root), **kv_metadata}
    pq.write_metadata(arrow_schema.with_metadata(merged),
                      posixpath.join(root, "_common_metadata"), filesystem=fs)
