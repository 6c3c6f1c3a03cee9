"""Rowgroup indexing: value -> rowgroup lookups stored in the dataset's metadata.

Counterpart of ``petastorm_tpu/etl/indexing.py``: ``RowGroupIndexer``,
``SingleFieldIndexer``, ``FieldNotNullIndexer`` and their registry;
``build_rowgroup_index``, one pyarrow scan of the indexed columns (decoded
with this package's codecs) that stores JSON under
``ROWGROUP_INDEX_METADATA_KEY``; ``get_row_group_indexes``.  A stored index
is the same JSON whichever package built it, and each package reads the
other's.  A hive partition column is indexed from each rowgroup's path
value.  The legacy petastorm index (``dataset-toolkit.rowgroups_index.v1``,
read through the JAX package's ``interop.py``) is not part of this package
yet: a dataset that carries only the legacy index raises.
"""

from __future__ import annotations

import json
import logging
from abc import ABC, abstractmethod
from typing import Dict, List, Sequence, Set

import numpy as np
import pyarrow.parquet as pq

from petastorm_tpu_torch.errors import MetadataError
from petastorm_tpu_torch.etl.metadata import (LEGACY_INDEX_KEY, ROWGROUP_INDEX_METADATA_KEY,
                                              DatasetInfo, open_dataset, write_metadata_file)

logger = logging.getLogger(__name__)

_INDEXER_REGISTRY: Dict[str, type] = {}


def _register(cls):
    _INDEXER_REGISTRY[cls.indexer_type] = cls
    return cls


def _norm_key(value):
    if isinstance(value, (np.generic,)):
        value = value.item()
    if isinstance(value, bool) or isinstance(value, (int, float, str)):
        return value
    return str(value)


class RowGroupIndexer(ABC):
    """Reference: RowGroupIndexerBase (petastorm/etl/__init__.py:19-29)."""

    indexer_type: str = ""

    def __init__(self, index_name: str):
        self._index_name = index_name

    @property
    def index_name(self) -> str:
        return self._index_name

    @property
    @abstractmethod
    def column_names(self) -> List[str]:
        """Columns this indexer needs read during the build."""

    @abstractmethod
    def process_row_group(self, row_group_index: int, columns: Dict[str, np.ndarray]):
        """Fold one rowgroup's column arrays into the index during the build
        scan (called once per rowgroup, in global-index order)."""

    @abstractmethod
    def indexed_values(self) -> List:
        """Every distinct value the index maps (sorted where orderable)."""

    @abstractmethod
    def get_row_group_indexes(self, value=None) -> Set[int]:
        """Global rowgroup ordinals holding ``value`` (or any indexed value
        when ``value`` is None)."""

    @abstractmethod
    def to_json(self) -> dict:
        """JSON-native payload stored under the dataset's index KV key;
        inverted by ``from_json``."""

    @classmethod
    @abstractmethod
    def from_json(cls, obj: dict) -> "RowGroupIndexer":
        ...


@_register
class SingleFieldIndexer(RowGroupIndexer):
    """value -> set(rowgroup ordinals) for one field
    (reference: petastorm/etl/rowgroup_indexers.py:21-75)."""

    indexer_type = "single_field"

    def __init__(self, index_name: str, index_field: str):
        super().__init__(index_name)
        self._field = index_field
        self._index: Dict[object, Set[int]] = {}

    @property
    def column_names(self) -> List[str]:
        return [self._field]

    def process_row_group(self, row_group_index: int, columns: Dict[str, np.ndarray]):
        for v in columns[self._field]:
            if v is None:
                continue
            self._index.setdefault(_norm_key(v), set()).add(row_group_index)

    def indexed_values(self) -> List:
        return sorted(self._index, key=lambda v: (str(type(v)), str(v)))

    def get_row_group_indexes(self, value=None) -> Set[int]:
        if value is None:
            raise MetadataError(f"Index {self.index_name!r} requires a lookup value")
        return set(self._index.get(_norm_key(value), set()))

    def to_json(self) -> dict:
        return {"type": self.indexer_type, "name": self.index_name, "field": self._field,
                "index": [[k, sorted(v)] for k, v in sorted(
                    self._index.items(), key=lambda kv: (str(type(kv[0])), str(kv[0])))]}

    @classmethod
    def from_json(cls, obj: dict) -> "SingleFieldIndexer":
        out = cls(obj["name"], obj["field"])
        out._index = {k: set(v) for k, v in obj["index"]}
        return out


@_register
class FieldNotNullIndexer(RowGroupIndexer):
    """Rowgroups where the field has at least one non-null value
    (reference: petastorm/etl/rowgroup_indexers.py:78-124)."""

    indexer_type = "field_not_null"

    def __init__(self, index_name: str, index_field: str):
        super().__init__(index_name)
        self._field = index_field
        self._row_groups: Set[int] = set()

    @property
    def column_names(self) -> List[str]:
        return [self._field]

    def process_row_group(self, row_group_index: int, columns: Dict[str, np.ndarray]):
        col = columns[self._field]
        if any(v is not None for v in col):
            self._row_groups.add(row_group_index)

    def indexed_values(self) -> List:
        return ["not_null"]

    def get_row_group_indexes(self, value=None) -> Set[int]:
        return set(self._row_groups)

    def to_json(self) -> dict:
        return {"type": self.indexer_type, "name": self.index_name, "field": self._field,
                "row_groups": sorted(self._row_groups)}

    @classmethod
    def from_json(cls, obj: dict) -> "FieldNotNullIndexer":
        out = cls(obj["name"], obj["field"])
        out._row_groups = set(obj["row_groups"])
        return out


def build_rowgroup_index(url: str, indexers: Sequence[RowGroupIndexer]) -> None:
    """Scan the dataset once, feed the indexers, and store the result in
    ``_common_metadata`` beside any index already stored (an index of the
    same name is replaced)."""
    info = open_dataset(url, require_stored_schema=True)
    schema = info.stored_schema
    needed = sorted({c for ix in indexers for c in ix.column_names})
    missing = [c for c in needed if c not in schema]
    if missing:
        raise MetadataError(f"Indexed fields {missing} not in dataset schema")

    by_file: Dict[str, List] = {}
    for rg in info.row_groups:
        by_file.setdefault(rg.path, []).append(rg)
    for path, refs in by_file.items():
        with info.filesystem.open_input_file(path) as f:
            pf = pq.ParquetFile(f)
            in_file = [c for c in needed if c in pf.schema_arrow.names]
            for ref in refs:
                table = pf.read_row_group(ref.row_group, columns=in_file)
                columns = {}
                for name in needed:
                    field = schema[name]
                    if name in in_file:
                        columns[name] = field.codec.decode_column(
                            field, table.column(name).combine_chunks())
                        continue
                    # a partition column: constant over the rowgroup, from
                    # its path (``petastorm_tpu/etl/indexing.py:196-215``)
                    pvals = dict(ref.partition_values)
                    if name not in pvals:
                        raise MetadataError(
                            f"Indexed field {name!r} is neither stored in"
                            f" {path!r} nor a partition key")
                    value = pvals[name]
                    if field.dtype.kind not in ("U", "S", "O"):
                        value = field.dtype.type(value)
                    columns[name] = np.full(ref.num_rows, value, dtype=object)
                for ix in indexers:
                    ix.process_row_group(ref.global_index, columns)

    payload = {"version": 1, "indexes": [ix.to_json() for ix in indexers]}
    existing = info.kv_metadata.get(ROWGROUP_INDEX_METADATA_KEY)
    if existing:
        try:
            old = {ix["name"]: ix for ix in json.loads(existing)["indexes"]}
            new_names = {ix.index_name for ix in indexers}
            payload["indexes"] = [v for k, v in old.items() if k not in new_names] + \
                payload["indexes"]
        except (ValueError, KeyError):
            logger.warning("Dropping corrupt existing rowgroup index payload")
    write_metadata_file(info.filesystem, info.root_path, info.arrow_schema,
                        {ROWGROUP_INDEX_METADATA_KEY: json.dumps(payload).encode()})


def get_row_group_indexes(info: DatasetInfo) -> Dict[str, RowGroupIndexer]:
    """The dataset's stored indexes by name (reference:
    rowgroup_indexing.py:138-160); ``{}`` when it stores none."""
    raw = info.kv_metadata.get(ROWGROUP_INDEX_METADATA_KEY)
    if not raw:
        if info.kv_metadata.get(LEGACY_INDEX_KEY):
            raise MetadataError(
                f"Dataset {info.url!r} carries only a legacy petastorm rowgroup index"
                f" ({LEGACY_INDEX_KEY.decode()}); reading it (interop.py) is not part of"
                " this package yet (ROADMAP.md queue A item 11). Rebuild the index with"
                " build_rowgroup_index().")
        return {}
    payload = json.loads(raw)
    out = {}
    for obj in payload.get("indexes", []):
        cls = _INDEXER_REGISTRY.get(obj.get("type"))
        if cls is None:
            logger.warning("Unknown indexer type %r in stored index", obj.get("type"))
            continue
        ix = cls.from_json(obj)
        out[ix.index_name] = ix
    return out
