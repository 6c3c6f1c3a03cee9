"""Column codecs: how a logical tensor field is stored in Parquet.

Counterpart of ``petastorm_tpu/codecs.py:150-620``, with its five codecs:
``ScalarCodec``, ``NdarrayCodec``, ``CompressedNdarrayCodec``,
``ScalarListCodec`` and ``CompressedImageCodec``.  Codecs serialize to the
same JSON (``{"codec": name, **params}``) and store the same bytes
(``np.save`` and ``np.savez_compressed`` payloads, arrow lists, standard RGB
PNG/JPEG streams), so a dataset written by either package decodes in the
other.

A fixed-shape uint8 image column decodes in one native call
(``native.image.decode_column_native``: libjpeg/libpng with the GIL
released, optionally only each image's crop window), as
``petastorm_tpu/codecs.py:589-627``; every other image column decodes per
cell through OpenCV, with PIL where OpenCV is missing, which is also the
native decode's plain version.  The worker threads its options down to
``decode_column`` through :func:`decode_options` (``:46-113``), with the
process pool's ``batch_slots``: the native decode then writes into an
arena slot of the shared-memory transport (``:630``), so the column ships
with no copy.
"""

from __future__ import annotations

import ast
import contextlib
import io
import logging
import os
import threading
from abc import ABC, abstractmethod
from typing import Any, Dict, Optional, Tuple, Type

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from petastorm_tpu_torch import dtypes
from petastorm_tpu_torch.errors import CodecError
from petastorm_tpu_torch.native import image as native_image

_CODEC_REGISTRY: Dict[str, Type["Codec"]] = {}

_DECODE_THREADS: Optional[int] = None


def _decode_threads() -> int:
    """``PETASTORM_TPU_DECODE_THREADS``: the native decode's fan-out for a
    caller that sets none (a worker passes its own through
    :func:`decode_options`).  Parsed once; a malformed value warns and
    gives 1."""
    global _DECODE_THREADS
    if _DECODE_THREADS is None:
        raw = os.environ.get("PETASTORM_TPU_DECODE_THREADS", "1")
        try:
            _DECODE_THREADS = max(1, int(raw))
        except ValueError:
            logging.getLogger(__name__).warning(
                "Ignoring malformed PETASTORM_TPU_DECODE_THREADS=%r; using 1", raw)
            _DECODE_THREADS = 1
    return _DECODE_THREADS


_DECODE_CTX = threading.local()


class DecodeOptions:
    """Options the rowgroup worker threads down to ``decode_column`` without
    widening every codec's signature:

    * ``nthreads`` - fan-out of the native batched decode (the worker sizes
      it to its share of the host's cores; overrides the
      ``PETASTORM_TPU_DECODE_THREADS`` default);
    * ``roi`` - ``(crop_ys, crop_xs, crop_h, crop_w)`` partial decode of
      image columns (``make_reader(decode_roi=...)``): only the kept window
      is decoded (native path) or sliced (per-cell path) - output rows are
      ``(crop_h, crop_w[, C])``;
    * ``batch_slots`` - allocate the native decode's output from the active
      shared-memory ``native.transport.SlotAllocator`` (a process-pool
      worker), so the pool ships it with no further copy; the worker arms it
      only where no cache would keep a reference to the arena-backed array.
    """

    __slots__ = ("nthreads", "roi", "batch_slots")

    def __init__(self, nthreads: Optional[int] = None, roi: Optional[Tuple] = None,
                 batch_slots: bool = False):
        self.nthreads = nthreads
        self.roi = roi
        self.batch_slots = batch_slots


@contextlib.contextmanager
def decode_options(nthreads: Optional[int] = None, roi: Optional[Tuple] = None,
                   batch_slots: bool = False):
    """Install :class:`DecodeOptions` for decode calls on this thread."""
    prev = getattr(_DECODE_CTX, "opts", None)
    _DECODE_CTX.opts = DecodeOptions(nthreads=nthreads, roi=roi, batch_slots=batch_slots)
    try:
        yield
    finally:
        _DECODE_CTX.opts = prev


def _current_opts() -> DecodeOptions:
    opts = getattr(_DECODE_CTX, "opts", None)
    return opts if opts is not None else _DEFAULT_OPTS


_DEFAULT_OPTS = DecodeOptions()


def register_codec(cls: Type["Codec"]) -> Type["Codec"]:
    """Class decorator: make a Codec JSON-round-trippable by ``codec_name``."""
    _CODEC_REGISTRY[cls.codec_name] = cls
    return cls


def codec_from_json(obj: Dict[str, Any]) -> "Codec":
    obj = dict(obj)
    name = obj.pop("codec")
    if name not in _CODEC_REGISTRY:
        raise CodecError(f"Unknown codec {name!r}; known: {sorted(_CODEC_REGISTRY)}")
    return _CODEC_REGISTRY[name].from_json(obj)


def check_shape_compliance(field, value: np.ndarray) -> None:
    """Validate ndarray rank/dims against the field shape; None dims are wildcards."""
    expected = field.shape
    if len(expected) != value.ndim:
        raise CodecError(
            f"field {field.name!r}: rank mismatch, schema {expected} vs value {value.shape}")
    for want, got in zip(expected, value.shape):
        if want is not None and want != got:
            raise CodecError(
                f"field {field.name!r}: shape mismatch, schema {expected} vs value {value.shape}")


def _check_array(field, value) -> np.ndarray:
    value = np.asarray(value)
    check_shape_compliance(field, value)
    if value.dtype != field.dtype:
        raise CodecError(
            f"field {field.name!r}: dtype mismatch {value.dtype} vs schema {field.dtype}")
    return value


def _slice_roi(decoded: np.ndarray, roi: Tuple) -> np.ndarray:
    """Per-cell ROI: crop a fully decoded stacked column to the ROI windows
    (the native partial decode's result, without its savings)."""
    ys, xs, crop_h, crop_w = roi
    n = len(decoded)
    ys = np.broadcast_to(np.asarray(ys, dtype=np.int64), (n,))
    xs = np.broadcast_to(np.asarray(xs, dtype=np.int64), (n,))
    if decoded.dtype == object:
        out = np.empty(n, dtype=object)
        for i in range(n):
            # a null cell passes through uncropped
            out[i] = (None if decoded[i] is None else np.ascontiguousarray(
                decoded[i][ys[i]:ys[i] + crop_h, xs[i]:xs[i] + crop_w]))
        return out
    out = np.empty((n, crop_h, crop_w) + decoded.shape[3:], decoded.dtype)
    for i in range(n):
        out[i] = decoded[i, ys[i]:ys[i] + crop_h, xs[i]:xs[i] + crop_w]
    return out


def _stack_cells(field, cells) -> np.ndarray:
    if field.is_fixed_shape and not any(c is None for c in cells):
        if not cells:
            return np.empty((0,) + field.shape, dtype=field.dtype)
        return np.stack(cells)
    out = np.empty(len(cells), dtype=object)
    for i, c in enumerate(cells):
        out[i] = c
    return out


class Codec(ABC):
    """Field storage codec: ``encode``/``decode`` one cell, ``decode_column`` a column."""

    codec_name: str = ""
    #: encoded cells are already entropy-coded: the writer stores the column
    #: without parquet-level compression
    precompressed: bool = False

    @abstractmethod
    def storage_type(self, field) -> pa.DataType:
        """Arrow type this codec stores the field as."""

    @abstractmethod
    def encode(self, field, value) -> Any:
        """One cell's python value -> the storage value handed to pyarrow."""

    @abstractmethod
    def decode(self, field, value) -> Any:
        """Invert :meth:`encode` for one stored cell."""

    def decode_column(self, field, column: pa.Array) -> np.ndarray:
        """Decode an arrow column; fixed-shape fields stack into one array."""
        cells = [None if v is None else self.decode(field, v) for v in column.to_pylist()]
        return _stack_cells(field, cells)

    def to_json(self) -> Dict[str, Any]:
        return {"codec": self.codec_name}

    @classmethod
    def from_json(cls, obj: Dict[str, Any]) -> "Codec":
        return cls(**obj)

    def __eq__(self, other):
        return type(self) is type(other) and self.to_json() == other.to_json()

    def __hash__(self):
        return hash((type(self).__name__, tuple(sorted(self.to_json().items()))))

    def __repr__(self):
        params = {k: v for k, v in self.to_json().items() if k != "codec"}
        return f"{type(self).__name__}({', '.join(f'{k}={v!r}' for k, v in params.items())})"


@register_codec
class ScalarCodec(Codec):
    """Plain scalar column in arrow-native storage (optionally ``store_dtype``)."""

    codec_name = "scalar"

    def __init__(self, store_dtype: Optional[str] = None):
        self._store_dtype = np.dtype(store_dtype) if store_dtype else None

    def storage_type(self, field) -> pa.DataType:
        return dtypes.numpy_to_arrow(self._store_dtype or field.dtype)

    def encode(self, field, value):
        if field.shape != ():
            raise CodecError(f"ScalarCodec on non-scalar field {field.name!r} {field.shape}")
        return dtypes.sanitize_value(value, self._store_dtype or field.dtype)

    def decode(self, field, value):
        if field.dtype.kind in ("U", "S", "O"):
            return value
        return field.dtype.type(value)

    def decode_column(self, field, column: pa.Array) -> np.ndarray:
        if column.null_count > 0:
            # an int column with nulls would come back as float64 + NaN
            return super().decode_column(field, column)
        arr = column.to_numpy(zero_copy_only=False)
        if field.dtype.kind not in ("U", "S", "O") and arr.dtype != field.dtype:
            arr = arr.astype(field.dtype)
        return arr

    def to_json(self):
        out = {"codec": self.codec_name}
        if self._store_dtype is not None:
            out["store_dtype"] = self._store_dtype.name
        return out


def _npy_header(value: bytes) -> Optional[Tuple[int, np.dtype, Tuple[int, ...]]]:
    """(payload offset, dtype, shape) of ``np.save`` bytes, or None if unusual."""
    if not value.startswith(b"\x93NUMPY") or len(value) < 12:
        return None
    major = value[6]
    if major == 1:
        hlen, off = int.from_bytes(value[8:10], "little"), 10
    elif major in (2, 3):
        hlen, off = int.from_bytes(value[8:12], "little"), 12
    else:
        return None
    try:
        d = ast.literal_eval(value[off:off + hlen].decode("latin1"))
    except (ValueError, SyntaxError):
        return None
    dtype = np.dtype(d["descr"])
    if d.get("fortran_order") or dtype.hasobject:
        return None
    return off + hlen, dtype, tuple(d["shape"])


@register_codec
class NdarrayCodec(Codec):
    """ndarray <-> ``np.save`` bytes."""

    codec_name = "ndarray"

    def storage_type(self, field) -> pa.DataType:
        return pa.binary()

    def encode(self, field, value) -> bytes:
        value = _check_array(field, value)
        buf = io.BytesIO()
        np.save(buf, value)
        return buf.getvalue()

    def decode(self, field, value: bytes) -> np.ndarray:
        return np.load(io.BytesIO(value), allow_pickle=False)

    def decode_column(self, field, column: pa.Array) -> np.ndarray:
        """A fixed-shape column whose cells share one header decodes as one
        strided view of the arrow data buffer, copied once."""
        n = len(column)
        if (not field.is_fixed_shape or column.null_count or n == 0
                or column.type != pa.binary()):
            return super().decode_column(field, column)
        _, offsets_buf, data_buf = column.buffers()
        offsets = np.frombuffer(offsets_buf, dtype=np.int32, count=n + 1,
                                offset=column.offset * 4)
        lens = np.diff(offsets)
        cell_len = int(lens[0])
        parsed = _npy_header(column[0].as_py())
        if parsed is None or not (lens == cell_len).all():
            return super().decode_column(field, column)
        hdr_len, dtype, shape = parsed
        if dtype != field.dtype or shape != field.shape:
            return super().decode_column(field, column)
        cells = np.frombuffer(data_buf, dtype=np.uint8, count=n * cell_len,
                              offset=int(offsets[0])).reshape(n, cell_len)
        if not (cells[:, :hdr_len] == cells[0, :hdr_len]).all():
            return super().decode_column(field, column)
        return cells[:, hdr_len:].view(field.dtype).reshape((n,) + field.shape).copy()


@register_codec
class CompressedNdarrayCodec(Codec):
    """ndarray <-> ``np.savez_compressed`` bytes, petastorm-compatible
    (``petastorm_tpu/codecs.py:420``)."""

    codec_name = "compressed_ndarray"
    precompressed = True

    def storage_type(self, field) -> pa.DataType:
        return pa.binary()

    def encode(self, field, value) -> bytes:
        value = np.asarray(value)
        check_shape_compliance(field, value)
        if value.dtype != field.dtype:
            raise CodecError(
                f"field {field.name!r}: dtype mismatch {value.dtype} vs schema {field.dtype}"
            )
        buf = io.BytesIO()
        np.savez_compressed(buf, arr=value)
        return buf.getvalue()

    def decode(self, field, value: bytes) -> np.ndarray:
        with np.load(io.BytesIO(value), allow_pickle=False) as npz:
            return npz["arr"]


@register_codec
class ScalarListCodec(Codec):
    """1-D variable-length list of scalars stored as an arrow list column
    (``petastorm_tpu/codecs.py:449``): what schema inference gives a
    list-of-scalar column of a plain Parquet store."""

    codec_name = "scalar_list"

    def storage_type(self, field) -> pa.DataType:
        return pa.list_(dtypes.numpy_to_arrow(field.dtype))

    def encode(self, field, value):
        arr = np.asarray(value)
        if arr.ndim != 1:
            raise CodecError(f"Field {field.name!r}: ScalarListCodec stores 1-D values")
        return arr.astype(field.dtype).tolist()

    def decode(self, field, value):
        return np.asarray(value, dtype=field.dtype)

    def decode_column(self, field, column: pa.Array) -> np.ndarray:
        """Lists of one length without nulls reshape from the arrow values
        buffer in one copy; ragged or nullable columns decode per cell into
        an object array (a column of one length and no nulls stacks)."""
        n = len(column)
        if n and column.null_count == 0 and field.dtype.kind not in ("U", "S", "O"):
            try:
                lengths = np.unique(pc.list_value_length(column).to_numpy())
                if len(lengths) == 1:
                    arr = (column.combine_chunks()
                           if isinstance(column, pa.ChunkedArray) else column)
                    flat = arr.flatten().to_numpy(zero_copy_only=False)
                    return flat.reshape(n, int(lengths[0])).astype(field.dtype, copy=True)
            except (pa.ArrowInvalid, pa.ArrowNotImplementedError):
                pass
        pylist = column.to_pylist()
        lens = {len(v) for v in pylist if v is not None}
        if len(lens) == 1 and None not in pylist:
            return np.asarray(pylist, dtype=field.dtype)
        out = np.empty(len(pylist), dtype=object)
        for i, v in enumerate(pylist):
            out[i] = None if v is None else np.asarray(v, dtype=field.dtype)
        return out


@register_codec
class CompressedImageCodec(Codec):
    """Image <-> PNG/JPEG stream through OpenCV, with PIL as the fallback.

    Streams are standard RGB files: cv2 is BGR-native, so 3-channel images
    are swapped on the way in and out.
    """

    codec_name = "compressed_image"
    precompressed = True

    def __init__(self, image_codec: str = "png", quality: int = 80):
        if image_codec not in ("png", "jpeg", "jpg"):
            raise CodecError(f"Unsupported image codec {image_codec!r}")
        self._format = "jpeg" if image_codec == "jpg" else image_codec
        self._quality = int(quality)

    @property
    def image_codec(self) -> str:
        """``'png'`` or ``'jpeg'``."""
        return self._format

    def storage_type(self, field) -> pa.DataType:
        return pa.binary()

    @staticmethod
    def _cv2():
        try:
            import cv2
        except ImportError:
            return None
        return cv2

    def encode(self, field, value) -> bytes:
        value = _check_array(field, value)
        if value.dtype not in (np.dtype("uint8"), np.dtype("uint16")):
            raise CodecError("CompressedImageCodec supports uint8/uint16 images only")
        if self._format == "jpeg" and value.dtype != np.dtype("uint8"):
            raise CodecError("JPEG supports uint8 only")
        cv2 = self._cv2()
        if cv2 is None:
            from PIL import Image

            buf = io.BytesIO()
            Image.fromarray(value).save(buf, format="JPEG" if self._format == "jpeg" else "PNG",
                                        quality=self._quality)
            return buf.getvalue()
        bgr = value[..., ::-1] if value.ndim == 3 and value.shape[2] == 3 else value
        if self._format == "jpeg":
            ok, enc = cv2.imencode(".jpeg", bgr, [int(cv2.IMWRITE_JPEG_QUALITY), self._quality])
        else:
            ok, enc = cv2.imencode(".png", bgr)
        if not ok:
            raise CodecError(f"cv2.imencode failed for field {field.name!r}")
        return enc.tobytes()

    def decode(self, field, value: bytes) -> np.ndarray:
        # (h, w, 1) fields are grayscale streams: decode single-channel
        single_channel = len(field.shape) == 3 and field.shape[2] == 1
        cv2 = self._cv2()
        if cv2 is None:
            img = self._pil_decode(field, value)
        else:
            flags = cv2.IMREAD_UNCHANGED if field.dtype == np.dtype("uint16") else (
                cv2.IMREAD_COLOR if len(field.shape) == 3 and not single_channel
                else cv2.IMREAD_GRAYSCALE)
            img = cv2.imdecode(np.frombuffer(value, dtype=np.uint8), flags)
            if img is None:
                raise CodecError(f"cv2.imdecode failed for field {field.name!r}")
            if img.ndim == 3 and img.shape[2] == 3:
                img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        if single_channel and img.ndim == 2:
            img = img[..., None]
        return np.ascontiguousarray(img.astype(field.dtype, copy=False))

    def decode_column(self, field, column: pa.Array) -> np.ndarray:
        """A fixed-shape uint8 image column decodes in one native call,
        into one contiguous array, cropped to the active ROI if there is
        one; every other column decodes per cell (then crops)."""
        opts = _current_opts()
        roi = opts.roi
        if native_decodable(field) and column.null_count == 0:
            if roi is not None:
                ys, xs, crop_h, crop_w = roi
                out = self._alloc_output((len(column), crop_h, crop_w) + field.shape[2:], opts)
                native_roi, full_shape = (ys, xs), field.shape[:2]
            else:
                out = self._alloc_output((len(column),) + field.shape, opts)
                native_roi, full_shape = None, None
            nthreads = opts.nthreads if opts.nthreads is not None else _decode_threads()
            if native_image.decode_column_native(column, out, nthreads=nthreads,
                                                 roi=native_roi, full_shape=full_shape):
                return out
        decoded = super().decode_column(field, column)
        if roi is not None:
            decoded = _slice_roi(decoded, roi)
        return decoded

    @staticmethod
    def _alloc_output(shape, opts: DecodeOptions) -> np.ndarray:
        """The native decode's output: an arena slot under ``batch_slots``
        when one is free, else plain memory (``petastorm_tpu/codecs.py:630``)."""
        if opts.batch_slots:
            from petastorm_tpu_torch.native.transport import current_slot_allocator

            allocator = current_slot_allocator()
            if allocator is not None:
                out = allocator.alloc(shape, np.uint8)
                if out is not None:
                    return out
        return np.empty(shape, dtype=np.uint8)

    @staticmethod
    def _pil_decode(field, value: bytes) -> np.ndarray:
        from PIL import Image

        img = Image.open(io.BytesIO(value))
        single_channel = len(field.shape) <= 2 or (
            len(field.shape) == 3 and field.shape[2] == 1)
        if single_channel and img.mode not in ("L", "I;16", "I"):
            img = img.convert("L")
        elif len(field.shape) == 3 and field.shape[2] == 3 and img.mode != "RGB":
            img = img.convert("RGB")
        return np.asarray(img).astype(field.dtype, copy=False)

    def to_json(self):
        return {"codec": self.codec_name, "image_codec": self._format, "quality": self._quality}


def native_decodable(field) -> bool:
    """Whether ``field``'s columns decode in one native call (those without
    nulls): a fixed-shape uint8 ``CompressedImageCodec`` image of shape (H,
    W), (H, W, 1) or (H, W, 3)."""
    return (isinstance(field.codec, CompressedImageCodec) and field.is_fixed_shape
            and field.dtype == np.dtype("uint8")
            and (len(field.shape) == 2 or (len(field.shape) == 3 and field.shape[2] in (1, 3))))
