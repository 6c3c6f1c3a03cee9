"""Datasets laid out as the original Petastorm writes them, without Petastorm.

The reference stamps ``_common_metadata`` with a pickled
``petastorm.unischema.Unischema`` (its codecs pickled inside, a
``ScalarCodec`` holding a pickled ``pyspark.sql.types`` instance), JSON
rowgroup counts a file, and a pickled dict of rowgroup indexers (reference
etl/dataset_metadata.py:35-36,195-242, etl/rowgroup_indexing.py:33-81).
:func:`fake_petastorm` installs throwaway ``petastorm``/``pyspark`` modules
whose classes carry the reference's module paths and attribute layouts, so
``pickle.dumps`` of their instances gives the reference's byte streams; it is
the layout of ``tests/test_interop.py``'s fake modules.
:func:`make_legacy_dataset` copies a dataset of this package's own format
into that layout: the same rowgroups, with none of this package's metadata.
"""

from __future__ import annotations

import contextlib
import json
import os
import pickle
import sys
import types
from collections import OrderedDict, defaultdict, namedtuple
from typing import Dict, Iterator, Sequence

import numpy as np
import pyarrow.parquet as pq

from petastorm_tpu_torch.codecs import (CompressedImageCodec, CompressedNdarrayCodec,
                                        NdarrayCodec)
from petastorm_tpu_torch.interop import (LEGACY_INDEX_KEY, LEGACY_ROW_GROUPS_KEY,
                                         LEGACY_UNISCHEMA_KEY)
from petastorm_tpu_torch.schema import Schema

#: pyspark type classes the fake ``pyspark.sql.types`` offers
SPARK_TYPES = ("IntegerType", "LongType", "StringType", "DoubleType", "FloatType",
               "BooleanType", "ShortType", "ByteType", "BinaryType", "DecimalType")


def _modules() -> Dict[str, types.ModuleType]:
    uni = types.ModuleType("petastorm.unischema")

    class UnischemaField(namedtuple("UnischemaField",
                                    ["name", "numpy_dtype", "shape", "codec", "nullable"])):
        pass

    UnischemaField.__new__.__defaults__ = (None, False)

    class Unischema(object):
        def __init__(self, name, fields):
            self._name = name
            self._fields = OrderedDict((f.name, f) for f in fields)
            for f in fields:
                if not hasattr(self, f.name):
                    setattr(self, f.name, f)

    for cls in (UnischemaField, Unischema):
        cls.__module__ = "petastorm.unischema"
        cls.__qualname__ = cls.__name__
        setattr(uni, cls.__name__, cls)

    cod = types.ModuleType("petastorm.codecs")

    class NdarrayCodec(object):
        pass

    class CompressedNdarrayCodec(object):
        pass

    class CompressedImageCodec(object):
        def __init__(self, image_codec="png", quality=80):
            self._image_codec = "." + image_codec
            self._quality = quality

    class ScalarCodec(object):
        def __init__(self, spark_type):
            self._spark_type = spark_type

    for cls in (NdarrayCodec, CompressedNdarrayCodec, CompressedImageCodec, ScalarCodec):
        cls.__module__ = "petastorm.codecs"
        cls.__qualname__ = cls.__name__
        setattr(cod, cls.__name__, cls)

    idx = types.ModuleType("petastorm.etl.rowgroup_indexers")

    class SingleFieldIndexer(object):
        def __init__(self, index_name, index_field):
            self._index_name = index_name
            self._column_name = index_field
            self._index_data = defaultdict(set)

    class FieldNotNullIndexer(object):
        def __init__(self, index_name, index_field):
            self._index_name = index_name
            self._column_name = index_field
            self._index_data = set()

    for cls in (SingleFieldIndexer, FieldNotNullIndexer):
        cls.__module__ = "petastorm.etl.rowgroup_indexers"
        cls.__qualname__ = cls.__name__
        setattr(idx, cls.__name__, cls)

    spark = types.ModuleType("pyspark.sql.types")
    for name in SPARK_TYPES:
        setattr(spark, name, type(name, (object,), {"__module__": "pyspark.sql.types",
                                                    "__init__": lambda self, *a, **k: None}))
    return {"petastorm": types.ModuleType("petastorm"), "petastorm.unischema": uni,
            "petastorm.codecs": cod, "petastorm.etl": types.ModuleType("petastorm.etl"),
            "petastorm.etl.rowgroup_indexers": idx, "pyspark": types.ModuleType("pyspark"),
            "pyspark.sql": types.ModuleType("pyspark.sql"), "pyspark.sql.types": spark}


@contextlib.contextmanager
def fake_petastorm() -> Iterator[Dict[str, types.ModuleType]]:
    """The fake reference modules in ``sys.modules`` for the block (pickle
    finds a class through its module there); whatever those names held
    before is put back after."""
    mods = _modules()
    saved = {name: sys.modules.get(name) for name in mods}
    sys.modules.update(mods)
    try:
        yield mods
    finally:
        for name, module in saved.items():
            if module is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = module


def _spark_type(mods, dtype: np.dtype):
    spark = mods["pyspark.sql.types"]
    name = {"i": {1: "ByteType", 2: "ShortType", 4: "IntegerType", 8: "LongType"},
            "u": {1: "ShortType", 2: "IntegerType", 4: "LongType", 8: "LongType"},
            "f": {4: "FloatType", 8: "DoubleType"}}.get(dtype.kind, {}).get(dtype.itemsize)
    name = name or {"b": "BooleanType", "S": "BinaryType"}.get(dtype.kind, "StringType")
    return getattr(spark, name)()


def legacy_unischema(mods, schema: Schema):
    """The reference's Unischema of ``schema`` (fake-module instances): each
    field's numpy scalar type (``np.str_`` for a string), shape, codec and
    nullability."""
    uni, cod = mods["petastorm.unischema"], mods["petastorm.codecs"]
    fields = []
    for f in schema.fields.values():
        codec = f.codec
        if isinstance(codec, CompressedImageCodec):
            legacy = cod.CompressedImageCodec(codec.image_codec, codec._quality)
        elif isinstance(codec, CompressedNdarrayCodec):
            legacy = cod.CompressedNdarrayCodec()
        elif isinstance(codec, NdarrayCodec):
            legacy = cod.NdarrayCodec()
        else:
            legacy = cod.ScalarCodec(_spark_type(mods, f.dtype))
        dtype = np.str_ if f.dtype.kind in ("O", "U") else f.dtype.type
        fields.append(uni.UnischemaField(f.name, dtype, tuple(f.shape), legacy, f.nullable))
    return uni.Unischema(schema.name, fields)


def make_legacy_dataset(src: str, dst: str, schema: Schema,
                        index_fields: Sequence[str] = ()) -> Dict[str, Dict]:
    """Copy the data files of ``src`` (a local dataset of this package) to
    ``dst``, rowgroup for rowgroup and file name for file name, without this
    package's metadata, and stamp ``dst/_common_metadata`` as the reference
    does: the pickled Unischema of ``schema``, the rowgroup counts a file and
    a ``SingleFieldIndexer`` a field of ``index_fields`` (rowgroups by value,
    ordinals across the path-sorted files).  Returns the indexes as written,
    ``{name: {value: set(ordinals)}}``."""
    names = sorted(f for f in os.listdir(src) if f.endswith(".parquet"))
    os.makedirs(dst, exist_ok=True)
    counts, ordinal = {}, 0
    indexes = {name: defaultdict(set) for name in index_fields}
    arrow_schema = None
    for name in names:
        pf = pq.ParquetFile(os.path.join(src, name))
        arrow_schema = pf.schema_arrow.with_metadata(None)
        with pq.ParquetWriter(os.path.join(dst, name), arrow_schema) as writer:
            for rg in range(pf.num_row_groups):
                table = pf.read_row_group(rg).replace_schema_metadata(None)
                writer.write_table(table, row_group_size=table.num_rows)
                for field in index_fields:
                    for value in table.column(field).to_pylist():
                        indexes[field][value].add(ordinal)
                ordinal += 1
        counts[name] = pf.num_row_groups
    with fake_petastorm() as mods:
        indexers = {}
        for field in index_fields:
            ix = mods["petastorm.etl.rowgroup_indexers"].SingleFieldIndexer(field, field)
            for value, ordinals in indexes[field].items():
                ix._index_data[value] |= ordinals
            indexers[field] = ix
        kv = {LEGACY_UNISCHEMA_KEY: pickle.dumps(legacy_unischema(mods, schema)),
              LEGACY_ROW_GROUPS_KEY: json.dumps(counts).encode()}
        if indexers:
            kv[LEGACY_INDEX_KEY] = pickle.dumps(indexers, pickle.HIGHEST_PROTOCOL)
    pq.write_metadata(arrow_schema.with_metadata(kv), os.path.join(dst, "_common_metadata"))
    return {field: dict(indexes[field]) for field in index_fields}


__all__ = ["SPARK_TYPES", "fake_petastorm", "legacy_unischema", "make_legacy_dataset"]
