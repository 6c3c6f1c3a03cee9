"""Interop: read datasets created by the **original Petastorm** library.

Counterpart of ``petastorm_tpu/interop.py``, with the same restricted
unpickler: it resolves the same globals and refuses every other one.

The reference stamps its schema into parquet ``_common_metadata`` as a **pickle**
of a ``petastorm.unischema.Unischema`` instance under the KV key
``dataset-toolkit.unischema.v1`` (reference: etl/dataset_metadata.py:35-36,195-206),
per-file rowgroup counts as JSON under ``dataset-toolkit.num_row_groups_per_file.v1``
(dataset_metadata.py:209-242), and rowgroup indexes as a pickled indexer dict under
``dataset-toolkit.rowgroups_index.v1`` (etl/rowgroup_indexing.py:33-81).  Codec
instances are pickled inside the schema (codecs.py:20-21), and ``ScalarCodec``
embeds a pickled ``pyspark.sql.types`` instance (codecs.py:192-197).

This module decodes those payloads **without petastorm, pyspark, or cv2 installed**
via a restricted unpickler: only an explicit whitelist of symbols resolves, each to
a local shim class; any other global in the stream raises ``UnpicklingError``.
Pre-petastorm package names (``av.ml.dataset_toolkit`` etc., reference
etl/legacy.py:22-45) resolve through the same suffix-based mapping.

Storage formats are bit-compatible with our codecs (``np.save`` bytes for
ndarrays, ``np.savez_compressed`` for compressed ndarrays, standard PNG/JPEG
streams for images, native parquet scalars), so after schema conversion the
normal read path works unchanged: ``make_reader(legacy_url)`` just works.
"""

from __future__ import annotations

import io
import logging
import pickle
from collections import namedtuple
from decimal import Decimal
from typing import Dict, Optional

import numpy as np

from petastorm_tpu_torch.codecs import (Codec, CompressedImageCodec,
                                  CompressedNdarrayCodec, NdarrayCodec,
                                  ScalarCodec)
from petastorm_tpu_torch.errors import MetadataError
from petastorm_tpu_torch.schema import Field, Schema

logger = logging.getLogger(__name__)

#: KV keys written by the reference (etl/dataset_metadata.py:35-36,
#: etl/rowgroup_indexing.py:30).
LEGACY_UNISCHEMA_KEY = b"dataset-toolkit.unischema.v1"
LEGACY_ROW_GROUPS_KEY = b"dataset-toolkit.num_row_groups_per_file.v1"
LEGACY_INDEX_KEY = b"dataset-toolkit.rowgroups_index.v1"


# ---------------------------------------------------------------------------
# Shim classes the restricted unpickler instantiates in place of the
# reference's own.  Attribute names match what the reference pickles.
# ---------------------------------------------------------------------------

class _ShimUnischemaField(namedtuple("UnischemaField",
                                     ["name", "numpy_dtype", "shape", "codec",
                                      "nullable"])):
    """Pickles as (class, field-values) - reference unischema.py:51-85."""


_ShimUnischemaField.__new__.__defaults__ = (None, False)


class _ShimUnischema:
    """State arrives via pickle BUILD into ``__dict__``: ``_name``, ``_fields``
    (OrderedDict name -> UnischemaField) plus one attr per field
    (reference unischema.py:179-197)."""


class _ShimNdarrayCodec:
    pass


class _ShimCompressedNdarrayCodec:
    pass


class _ShimCompressedImageCodec:
    """Attrs ``_image_codec`` ('.png'/'.jpeg'/'.jpg') and ``_quality``
    (reference codecs.py:54-63)."""


class _ShimScalarCodec:
    """Attr ``_spark_type``: a pyspark type instance (reference codecs.py:192-197)."""


class _ShimSingleFieldIndexer:
    """Attrs ``_index_name``, ``_column_name``, ``_index_data`` (defaultdict
    value -> set(rowgroup ordinal)) - reference rowgroup_indexers.py:28-31."""


class _ShimFieldNotNullIndexer:
    """Attrs ``_index_name``, ``_column_name``, ``_index_data`` (a plain set of
    rowgroup ordinals) - reference rowgroup_indexers.py:83-86."""


class _SparkTypeStub:
    """Stands in for any ``pyspark.sql.types`` class.  Only the class *name*
    (and ctor args, e.g. DecimalType(precision, scale)) matter for decoding."""

    spark_name = "UnknownType"

    def __init__(self, *args, **kwargs):
        self.args = args
        self.kwargs = kwargs


_SPARK_TYPE_STUBS: Dict[str, type] = {}


def _spark_type_stub(name: str) -> type:
    cls = _SPARK_TYPE_STUBS.get(name)
    if cls is None:
        cls = type(name, (_SparkTypeStub,), {"spark_name": name})
        _SPARK_TYPE_STUBS[name] = cls
    return cls


# ---------------------------------------------------------------------------
# Restricted unpickler
# ---------------------------------------------------------------------------

#: Reference + pre-petastorm legacy module names, matched by suffix
#: (etl/legacy.py:31-33 lists the av.* legacy packages).
_PETASTORM_SHIMS = {
    ("unischema", "Unischema"): _ShimUnischema,
    ("unischema", "UnischemaField"): _ShimUnischemaField,
    ("codecs", "NdarrayCodec"): _ShimNdarrayCodec,
    ("codecs", "CompressedNdarrayCodec"): _ShimCompressedNdarrayCodec,
    ("codecs", "CompressedImageCodec"): _ShimCompressedImageCodec,
    ("codecs", "ScalarCodec"): _ShimScalarCodec,
    ("rowgroup_indexers", "SingleFieldIndexer"): _ShimSingleFieldIndexer,
    ("rowgroup_indexers", "FieldNotNullIndexer"): _ShimFieldNotNullIndexer,
}

_SAFE_GLOBALS = {
    ("collections", "OrderedDict"),
    ("collections", "defaultdict"),
    ("builtins", "set"), ("builtins", "frozenset"), ("builtins", "list"),
    ("builtins", "dict"), ("builtins", "tuple"), ("builtins", "int"),
    ("builtins", "float"), ("builtins", "bool"), ("builtins", "str"),
    ("builtins", "bytes"), ("builtins", "bytearray"), ("builtins", "complex"),
    ("copyreg", "_reconstructor"),
    ("builtins", "object"),
    ("decimal", "Decimal"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
}


class _RestrictedUnpickler(pickle.Unpickler):
    """Resolves ONLY whitelisted globals; everything else raises."""

    def find_class(self, module: str, name: str):
        # python2-era streams (protocol <= 2) use py2 module names; apply the
        # same 2->3 mapping the stock Unpickler does before whitelisting
        from _compat_pickle import IMPORT_MAPPING, NAME_MAPPING

        if (module, name) in NAME_MAPPING:
            module, name = NAME_MAPPING[(module, name)]
        elif module in IMPORT_MAPPING:
            module = IMPORT_MAPPING[module]
        tail = module.rsplit(".", 1)[-1]
        shim = _PETASTORM_SHIMS.get((tail, name))
        if shim is not None and ("petastorm" in module or "dataset_toolkit" in module):
            return shim
        if module.startswith("pyspark.sql.types") or module == "pyspark.sql.types":
            return _spark_type_stub(name)
        if (module, name) in _SAFE_GLOBALS:
            import importlib

            return getattr(importlib.import_module(module), name)
        if module == "numpy":
            attr = getattr(np, name, None)
            if attr is np.dtype or attr is np.ndarray or (
                    isinstance(attr, type) and issubclass(attr, np.generic)):
                return attr
        raise pickle.UnpicklingError(
            f"Legacy petastorm metadata references disallowed global "
            f"{module}.{name}; refusing to unpickle")


def _restricted_loads(blob: bytes):
    return _RestrictedUnpickler(io.BytesIO(blob)).load()


# ---------------------------------------------------------------------------
# Conversion to this package's types
# ---------------------------------------------------------------------------

def _convert_dtype(numpy_dtype) -> np.dtype:
    """UnischemaField.numpy_dtype may be a scalar type (np.int64), a dtype
    instance, Decimal, or a string type (np.str_/np.bytes_)."""
    if numpy_dtype is Decimal:
        return np.dtype("object")
    if isinstance(numpy_dtype, np.dtype):
        if numpy_dtype.kind in ("U", "S"):
            return np.dtype("object")
        return numpy_dtype
    if isinstance(numpy_dtype, type) and issubclass(numpy_dtype, (np.str_, np.bytes_)):
        return np.dtype("object")
    try:
        return np.dtype(numpy_dtype)
    except TypeError as exc:
        raise MetadataError(f"Unsupported legacy field dtype {numpy_dtype!r}") from exc


def _convert_codec(codec, dtype: np.dtype) -> Optional[Codec]:
    if codec is None or isinstance(codec, _ShimScalarCodec):
        return ScalarCodec()
    if isinstance(codec, _ShimNdarrayCodec):
        return NdarrayCodec()
    if isinstance(codec, _ShimCompressedNdarrayCodec):
        return CompressedNdarrayCodec()
    if isinstance(codec, _ShimCompressedImageCodec):
        fmt = getattr(codec, "_image_codec", ".png").lstrip(".")
        quality = int(getattr(codec, "_quality", 80))
        return CompressedImageCodec("jpeg" if fmt == "jpg" else fmt, quality)
    raise MetadataError(f"Unsupported legacy codec {type(codec).__name__}")


def convert_unischema(shim) -> Schema:
    """``_ShimUnischema`` -> :class:`petastorm_tpu_torch.schema.Schema`."""
    name = getattr(shim, "_name", "legacy")
    legacy_fields = getattr(shim, "_fields", None)
    if not legacy_fields:
        raise MetadataError("Legacy unischema has no fields")
    fields = []
    for fname, lf in legacy_fields.items():
        dtype = _convert_dtype(lf.numpy_dtype)
        fields.append(Field(name=fname, dtype=dtype,
                            shape=tuple(lf.shape or ()),
                            codec=_convert_codec(lf.codec, dtype),
                            nullable=bool(lf.nullable)))
    return Schema(name, fields)


def load_legacy_schema(blob: bytes) -> Schema:
    """Decode a ``dataset-toolkit.unischema.v1`` payload into a Schema."""
    shim = _restricted_loads(blob)
    if not isinstance(shim, _ShimUnischema):
        raise MetadataError(
            f"Legacy unischema payload decoded to {type(shim).__name__}, "
            "expected a Unischema")
    return convert_unischema(shim)


def load_legacy_indexes(blob: bytes) -> Dict[str, "RowGroupIndexer"]:
    """Decode ``dataset-toolkit.rowgroups_index.v1`` into our indexer types,
    usable with :mod:`petastorm_tpu_torch.selectors` unchanged."""
    from petastorm_tpu_torch.etl.indexing import (FieldNotNullIndexer,
                                            SingleFieldIndexer, _norm_key)

    raw = _restricted_loads(blob)
    if not isinstance(raw, dict):
        raise MetadataError("Legacy rowgroup index payload is not a dict")
    out: Dict[str, object] = {}
    for name, shim in raw.items():
        if isinstance(shim, _ShimSingleFieldIndexer):
            idx = SingleFieldIndexer(shim._index_name, shim._column_name)
            for value, pieces in getattr(shim, "_index_data", {}).items():
                idx._index.setdefault(_norm_key(value), set()).update(
                    int(p) for p in pieces)
            out[name] = idx
        elif isinstance(shim, _ShimFieldNotNullIndexer):
            idx = FieldNotNullIndexer(shim._index_name, shim._column_name)
            idx._row_groups.update(int(p) for p in getattr(shim, "_index_data", ()))
            out[name] = idx
        else:
            logger.warning("Skipping unrecognized legacy indexer %r (%s)",
                           name, type(shim).__name__)
    return out
