"""Dtype mapping between numpy, Arrow and torch.

Counterpart of ``petastorm_tpu/dtypes.py:54-117``.  The storage mapping is the
same table; the device-feed policy follows the JAX package's torch loader
(``petastorm_tpu/pytorch.py:30-75``): torch has no uint16/uint32/uint64, so
they widen to int32/int64/int64, and 64-bit types are kept as they are.
``keep_wide=False`` applies the JAX package's feed table instead
(``petastorm_tpu/dtypes.py:92-115``: int64 -> int32, float64 -> float32 as
well).  Strings, objects and datetimes never go to a device.
"""

from __future__ import annotations

import decimal

import numpy as np
import pyarrow as pa

from petastorm_tpu_torch.errors import SchemaError

_NUMPY_TO_ARROW = {
    np.dtype("bool"): pa.bool_(),
    np.dtype("int8"): pa.int8(),
    np.dtype("int16"): pa.int16(),
    np.dtype("int32"): pa.int32(),
    np.dtype("int64"): pa.int64(),
    np.dtype("uint8"): pa.uint8(),
    np.dtype("uint16"): pa.uint16(),
    np.dtype("uint32"): pa.uint32(),
    np.dtype("uint64"): pa.uint64(),
    np.dtype("float16"): pa.float16(),
    np.dtype("float32"): pa.float32(),
    np.dtype("float64"): pa.float64(),
}

_ARROW_TO_NUMPY = {
    **{v: k for k, v in _NUMPY_TO_ARROW.items()},
    pa.string(): np.dtype("object"),
    pa.large_string(): np.dtype("object"),
    pa.binary(): np.dtype("object"),
    pa.large_binary(): np.dtype("object"),
    pa.date32(): np.dtype("datetime64[D]"),
    pa.date64(): np.dtype("datetime64[ms]"),
}

#: numpy dtypes torch cannot represent -> the dtype they widen to (also the
#: torch adapter's promotions, reference pytorch.py:39-56)
_TORCH_FEED_PROMOTIONS = {
    np.dtype("uint16"): np.dtype("int32"),
    np.dtype("uint32"): np.dtype("int64"),
    np.dtype("uint64"): np.dtype("int64"),
}

#: the JAX package's device-feed table, taken with ``keep_wide=False``
_NARROW_FEED_PROMOTIONS = {
    **_TORCH_FEED_PROMOTIONS,
    np.dtype("int64"): np.dtype("int32"),
    np.dtype("float64"): np.dtype("float32"),
}


def numpy_to_arrow(dtype) -> pa.DataType:
    """Arrow storage type for a numpy scalar dtype."""
    dtype = np.dtype(dtype)
    if dtype in _NUMPY_TO_ARROW:
        return _NUMPY_TO_ARROW[dtype]
    if dtype.kind in ("U", "S", "O"):
        return pa.string()
    if dtype.kind == "M":
        return pa.timestamp("ns")
    raise SchemaError(f"No arrow mapping for numpy dtype {dtype!r}")


def arrow_to_numpy(atype: pa.DataType) -> np.dtype:
    """Numpy dtype for a flat arrow type; raises SchemaError otherwise."""
    if atype in _ARROW_TO_NUMPY:
        return _ARROW_TO_NUMPY[atype]
    if pa.types.is_timestamp(atype):
        return np.dtype(f"datetime64[{atype.unit}]")
    if pa.types.is_decimal(atype):
        return np.dtype("object")  # decimal.Decimal cells
    if pa.types.is_dictionary(atype):
        return arrow_to_numpy(atype.value_type)
    raise SchemaError(f"No numpy mapping for arrow type {atype!r}")


def is_list_of_scalars(atype: pa.DataType) -> bool:
    """An arrow list (or large list) of a non-nested type."""
    return (pa.types.is_list(atype) or pa.types.is_large_list(atype)) and not (
        pa.types.is_nested(atype.value_type))


def torch_feed_dtype(dtype, keep_wide: bool = True) -> np.dtype:
    """Dtype a column is cast to before it becomes a torch tensor: 64-bit
    types kept (``keep_wide=True``) or narrowed to 32 bits as the JAX
    package feeds them (``keep_wide=False``)."""
    dtype = np.dtype(dtype)
    if dtype.kind in ("U", "S", "O", "M", "m"):
        raise SchemaError(
            f"dtype {dtype!r} cannot be fed to a device; keep it host-side or"
            " convert it to a numeric type")
    table = _TORCH_FEED_PROMOTIONS if keep_wide else _NARROW_FEED_PROMOTIONS
    return table.get(dtype, dtype)


def sanitize_value(value, dtype):
    """Coerce one python value to ``dtype`` for encoding, refusing lossy ints;
    a ``Decimal`` passes through as it is."""
    if isinstance(value, decimal.Decimal):
        return value
    dtype = np.dtype(dtype)
    if dtype.kind in ("U", "S"):
        return str(value)
    if dtype.kind == "O":
        return value
    try:
        arr = np.asarray(value)
        out = arr.astype(dtype)
    except (OverflowError, TypeError, ValueError) as exc:
        raise SchemaError(f"Value {value!r} cannot be stored as dtype {dtype}: {exc}") from exc
    if dtype.kind in "uib" and not np.array_equal(out.astype(np.float64), arr.astype(np.float64)):
        raise SchemaError(f"Value {value!r} does not fit dtype {dtype} without loss")
    return out.item()
