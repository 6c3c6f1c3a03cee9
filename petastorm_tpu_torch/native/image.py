"""Host halves of the image decode, over the port's native libraries.

The port's own copy of ``petastorm_tpu/native/image.py``:

- the batched host decode: ``decode_column_native`` (``:170``) decodes a
  whole arrow column of PNG/JPEG streams into one preallocated uint8 array
  in one C call (``image_decode.cpp``), reading the streams zero-copy out of
  the arrow buffer, optionally only each image's crop window;
- the entropy half of the hybrid JPEG decode (``_column_pointers`` ``:145``,
  ``JpegCoefLayout`` ``:247``, ``jpeg_coef_layout`` ``:268``,
  ``read_jpeg_coefficients`` ``:291``, ``pack_coef_columns`` ``:338``,
  ``_diagnose_coef_failure`` ``:379``, ``pack_coef_columns_mixed`` ``:414``,
  ``unpack_coef_columns`` ``:461``,
  ``read_jpeg_coefficients_column`` ``:482``) over ``jpeg_coef.cpp``:
  only libjpeg's entropy decoder runs here, and kernel B2
  (``ops/jpeg.py``) finishes the decode on the card;
- the per-thread decode counters and ``decode_stats`` (``:27-56``).

Both libraries are built by ``native/build.py`` at first use.  ctypes
releases the GIL for each C call, so the reader's thread pool decodes in
parallel.  A library that cannot be built raises: there is no fallback
(the JAX package warns once and decodes per cell instead).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from petastorm_tpu_torch.errors import CodecError
from petastorm_tpu_torch.native import build

_JPEG_MAX_COMPS = 4
_JPEG_META_LEN = 3 + 4 * _JPEG_MAX_COMPS

#: separator of the derived column names: a device-decode field ``img``
#: travels from the pool workers to the loader as ``img#p0..img#p{ncomp-1}``
#: (int16 block planes), ``img#q`` (uint16 quant tables) and ``img#m`` (int32
#: layout meta, the same in every row).  They are fixed-shape numpy columns,
#: so batch assembly treats them as any other column.
COEF_COLUMN_SEP = "#"

#: per-thread native decode counters (monotonic).  The reader's workers fold
#: each rowgroup's delta into the reader's totals (``Reader.decode_stats``);
#: thread-local, so a worker's delta never holds a sibling thread's decodes.
_STATS_TLS = threading.local()
_STAT_KEYS = ("batch_calls", "batch_images", "roi_calls", "roi_images",
              "coef_batch_calls", "coef_batch_images")


def _tls_stats() -> dict:
    stats = getattr(_STATS_TLS, "stats", None)
    if stats is None:
        stats = _STATS_TLS.stats = {k: 0 for k in _STAT_KEYS}
    return stats


def _count(**deltas) -> None:
    stats = _tls_stats()
    for name, d in deltas.items():
        stats[name] += d


def decode_stats() -> dict:
    """Snapshot of THIS thread's cumulative native-decode counters."""
    return dict(_tls_stats())


#: the one command that builds the batched decode library
BUILD_COMMAND = ("python -c \"from petastorm_tpu_torch.native import build;"
                 " print(build.build('image_decode'))\"")


def _configure(lib: ctypes.CDLL) -> None:
    lib.pst_jpeg_coef_layout.restype = ctypes.c_int
    lib.pst_jpeg_coef_layout.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_void_p]
    lib.pst_jpeg_read_coefs.restype = ctypes.c_int
    lib.pst_jpeg_read_coefs.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_void_p,
                                        ctypes.c_void_p]
    lib.pst_jpeg_coef_batch.restype = ctypes.c_int
    lib.pst_jpeg_coef_batch.argtypes = [
        ctypes.c_void_p,  # const uint8_t* const* srcs (uint64 array)
        ctypes.c_void_p,  # const uint64_t* lens
        ctypes.c_int,     # n
        ctypes.c_void_p,  # int16_t* const* outs
        ctypes.c_void_p,  # const uint64_t* plane_strides
        ctypes.c_void_p,  # uint16_t* qtabs
        ctypes.c_void_p,  # const int32_t* meta
        ctypes.c_int,     # nthreads
    ]


def _configure_decode(lib: ctypes.CDLL) -> None:
    lib.pst_decode_image_batch.restype = ctypes.c_int
    lib.pst_decode_image_batch.argtypes = [
        ctypes.c_void_p,  # const uint8_t* const* srcs (uint64 array)
        ctypes.c_void_p,  # const uint64_t* lens
        ctypes.c_int,     # n
        ctypes.c_void_p,  # uint8_t* out
        ctypes.c_uint64,  # stride
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # h, w, c
        ctypes.c_int,     # nthreads
    ]
    lib.pst_decode_image.restype = ctypes.c_int
    lib.pst_decode_image.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_void_p,
                                     ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.pst_decode_image_batch_roi.restype = ctypes.c_int
    lib.pst_decode_image_batch_roi.argtypes = [
        ctypes.c_void_p,  # srcs
        ctypes.c_void_p,  # lens
        ctypes.c_int,     # n
        ctypes.c_void_p,  # out
        ctypes.c_uint64,  # stride
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # full h, w, c
        ctypes.c_void_p,  # crop_ys (int32)
        ctypes.c_void_p,  # crop_xs (int32)
        ctypes.c_int, ctypes.c_int,  # crop_h, crop_w
        ctypes.c_int,     # nthreads
    ]


def load() -> ctypes.CDLL:
    """The entropy half's library, built at first use; raises when it cannot be built."""
    return build.load("jpeg_coef", _configure)


def load_decoder() -> ctypes.CDLL:
    """The batched decode library, built at first use.  Raises when it cannot
    be built, saying how to build it: a column the native path takes never
    drops to the per-cell decode."""
    try:
        return build.load("image_decode", _configure_decode)
    except RuntimeError as exc:
        raise RuntimeError(f"the native image decode library is unavailable: {exc}\n"
                           f"Build it once with: {BUILD_COMMAND}") from exc


def _column_pointers(column) -> Optional[tuple]:
    """(ptrs uint64 array, lens uint64 array) for a binary arrow array, zero-copy."""
    import pyarrow as pa

    if column.null_count:
        return None
    typ = column.type
    if typ == pa.binary():
        off_dtype = np.int32
    elif typ == pa.large_binary():
        off_dtype = np.int64
    else:
        return None
    buffers = column.buffers()  # [validity, offsets, data]
    if len(buffers) != 3 or buffers[1] is None or buffers[2] is None:
        return None
    n = len(column)
    offsets = np.frombuffer(
        buffers[1], dtype=off_dtype, count=n + 1,
        offset=column.offset * np.dtype(off_dtype).itemsize).astype(np.uint64)
    ptrs = np.uint64(buffers[2].address) + offsets[:-1]
    lens = offsets[1:] - offsets[:-1]
    return ptrs, lens


def decode_column_native(column, out: np.ndarray, nthreads: int = 1,
                         roi: Optional[tuple] = None,
                         full_shape: Optional[tuple] = None) -> bool:
    """Decode a binary arrow column of PNG/JPEG streams into ``out``.

    ``out`` must be contiguous uint8 of shape (n, h, w, c) or (n, h, w).
    ``nthreads > 1`` fans the batch out over the library's own threads (the
    whole call releases the GIL either way).

    ROI (partial) decode: with ``roi=(crop_ys, crop_xs)`` (per-image int
    offsets, scalars broadcast) and ``full_shape=(H, W)`` (the stored image
    geometry), each image decodes only the ``out``-shaped window anchored at
    its offset - rows below the crop are never entropy-decoded, and the
    result is byte-identical to slicing a full decode (crops need not be
    8x8-block aligned).

    Returns False (without touching ``out``) when the column does not fit
    the native path: nulls, another dtype or channel count, a non-binary
    arrow type.  Raises CodecError naming the cell on a decode failure, and
    RuntimeError when the library cannot be built.
    """
    if out.dtype != np.uint8 or not out.flags.c_contiguous:
        return False
    if out.ndim == 3:
        n, h, w = out.shape
        c = 1
    elif out.ndim == 4:
        n, h, w, c = out.shape
    else:
        return False
    if c not in (1, 3, 4):
        return False
    pointers = _column_pointers(column)
    if pointers is None:
        return False
    ptrs, lens = pointers
    if len(ptrs) != n:
        return False
    lib = load_decoder()
    if n == 0:
        return True
    if roi is not None:
        full_h, full_w = full_shape
        ys = np.ascontiguousarray(np.broadcast_to(np.asarray(roi[0], dtype=np.int32), (n,)))
        xs = np.ascontiguousarray(np.broadcast_to(np.asarray(roi[1], dtype=np.int32), (n,)))
        rc = lib.pst_decode_image_batch_roi(
            ptrs.ctypes.data, lens.ctypes.data, n, out.ctypes.data, np.uint64(out.strides[0]),
            full_h, full_w, c, ys.ctypes.data, xs.ctypes.data, h, w, nthreads)
        if rc == 0:
            _count(roi_calls=1, roi_images=n)
    else:
        rc = lib.pst_decode_image_batch(
            ptrs.ctypes.data, lens.ctypes.data, n, out.ctypes.data, np.uint64(out.strides[0]),
            h, w, c, nthreads)
        if rc == 0:
            _count(batch_calls=1, batch_images=n)
    if rc != 0:
        raise CodecError(
            f"native image decode failed at cell {rc - 1} (expected shape ({h}, {w}, {c}) uint8"
            + (f" cropped from {full_shape}" if roi is not None else "")
            + "; corrupt stream, crop outside image, or shape mismatch)")
    return True


class JpegCoefLayout:
    """Geometry of one JPEG's coefficient planes (all values in 8x8 blocks)."""

    __slots__ = ("width", "height", "components")

    def __init__(self, width: int, height: int, components):
        self.width = width
        self.height = height
        #: per component: (h_samp, v_samp, blocks_w, blocks_h)
        self.components = components

    @property
    def sampling(self) -> tuple:
        """Per component ``(h_samp, v_samp)``."""
        return tuple((h, v) for (h, v, _, _) in self.components)

    def __eq__(self, other):
        return (isinstance(other, JpegCoefLayout)
                and (self.width, self.height, self.components)
                == (other.width, other.height, other.components))

    def __repr__(self):
        return f"JpegCoefLayout({self.width}x{self.height}, comps={self.components})"


def jpeg_coef_layout(buf: bytes) -> JpegCoefLayout:
    """Parse a JPEG header into its coefficient-plane geometry (no entropy decode)."""
    meta = np.zeros(_JPEG_META_LEN, dtype=np.int32)
    rc = load().pst_jpeg_coef_layout(bytes(buf), len(buf), meta.ctypes.data)
    if rc != 0:
        raise CodecError(f"not a decodable JPEG (rc={rc})")
    return _layout_from_meta(meta)


def _layout_from_meta(meta) -> JpegCoefLayout:
    """Inverse of ``_layout_meta``: int32 meta vector -> JpegCoefLayout."""
    ncomp = int(meta[0])
    comps = tuple(tuple(int(v) for v in meta[3 + 4 * c: 7 + 4 * c]) for c in range(ncomp))
    return JpegCoefLayout(int(meta[1]), int(meta[2]), comps)


def _layout_meta(layout: JpegCoefLayout) -> np.ndarray:
    meta = np.zeros(_JPEG_META_LEN, dtype=np.int32)
    meta[0] = len(layout.components)
    meta[1] = layout.width
    meta[2] = layout.height
    for c, comp in enumerate(layout.components):
        meta[3 + 4 * c: 7 + 4 * c] = comp
    return meta


def read_jpeg_coefficients(buf: bytes, layout: Optional[JpegCoefLayout] = None):
    """Entropy-decode one JPEG into quantized DCT coefficient planes.

    Returns ``(planes, qtabs, layout)``: ``planes[c]`` is int16
    (blocks_h, blocks_w, 64) in natural order, ``qtabs`` is uint16 (ncomp, 64).
    """
    lib = load()
    if layout is None:
        layout = jpeg_coef_layout(buf)
    planes = [np.empty((bh, bw, 64), dtype=np.int16) for (_, _, bw, bh) in layout.components]
    qtabs = np.empty((len(layout.components), 64), dtype=np.uint16)
    outs = (ctypes.c_void_p * len(planes))(*[p.ctypes.data for p in planes])
    rc = lib.pst_jpeg_read_coefs(bytes(buf), len(buf), ctypes.cast(outs, ctypes.c_void_p),
                                 qtabs.ctypes.data)
    if rc != 0:
        raise CodecError(f"JPEG coefficient read failed (rc={rc})")
    return planes, qtabs, layout


def read_jpeg_coefficients_column(column, nthreads: int = 1):
    """Entropy-decode a column of same-geometry JPEGs into stacked planes.

    One GIL-released C call over the whole column, reading the streams
    zero-copy out of the arrow buffer when ``column`` is an arrow binary
    array (or a list of bytes).  Returns ``(planes, qtabs, layout)``:
    ``planes[c]`` is int16 (n, blocks_h, blocks_w, 64), ``qtabs`` uint16
    (n, ncomp, 64).  Raises CodecError when a stream is corrupt or the
    geometries differ.
    """
    lib = load()
    if isinstance(column, (list, tuple)):
        cells = [np.frombuffer(b, dtype=np.uint8) for b in column]
        ptrs = np.array([c.ctypes.data for c in cells], dtype=np.uint64)
        lens = np.array([len(c) for c in cells], dtype=np.uint64)
        first = column[0] if column else b""
    else:
        pointers = _column_pointers(column)
        if pointers is None:  # chunked or typed otherwise: copies of the cells
            return read_jpeg_coefficients_column(column.to_pylist(), nthreads=nthreads)
        ptrs, lens = pointers
        first = column[0].as_py() if len(column) else b""
    n = len(ptrs)
    if n == 0:
        raise CodecError("empty column")
    layout = jpeg_coef_layout(first)
    ncomp = len(layout.components)
    planes = [np.empty((n, bh, bw, 64), dtype=np.int16) for (_, _, bw, bh) in layout.components]
    qtabs = np.empty((n, ncomp, 64), dtype=np.uint16)
    outs = (ctypes.c_void_p * ncomp)(*[p.ctypes.data for p in planes])
    strides = np.array([p.strides[0] // 2 for p in planes], dtype=np.uint64)
    meta = _layout_meta(layout)
    rc = lib.pst_jpeg_coef_batch(ptrs.ctypes.data, lens.ctypes.data, n,
                                 ctypes.cast(outs, ctypes.c_void_p), strides.ctypes.data,
                                 qtabs.ctypes.data, meta.ctypes.data, nthreads)
    if rc != 0:
        raise CodecError(f"JPEG coefficient batch failed at cell {rc - 1} (corrupt stream"
                         f" or geometry differs from {layout})")
    _count(coef_batch_calls=1, coef_batch_images=n)
    return planes, qtabs, layout


def pack_coef_columns(name: str, column, field=None, nthreads: int = 1) -> dict:
    """Entropy-decode a jpeg column into its derived plane columns.

    Worker side of ``decode_placement='device'``: one GIL-released C call per
    rowgroup.  ``field`` (a Schema field) enables the check of the stored
    size against the schema's.  Raises CodecError naming the cell and what to
    do when a cell is corrupt or the column's geometry is not uniform.
    """
    try:
        planes, qtabs, layout = read_jpeg_coefficients_column(column, nthreads=nthreads)
    except CodecError as exc:
        raise CodecError(f"decode_placement='device' field {name!r}:"
                         f" {_diagnose_coef_failure(column, exc)}") from exc
    if field is not None and (layout.height, layout.width) != tuple(field.shape[:2]):
        raise CodecError(f"field {name!r}: stored jpeg is {layout.height}x{layout.width},"
                         f" schema says {tuple(field.shape[:2])}")
    n = len(qtabs)
    out = {f"{name}{COEF_COLUMN_SEP}p{c}": p for c, p in enumerate(planes)}
    out[f"{name}{COEF_COLUMN_SEP}q"] = qtabs
    out[f"{name}{COEF_COLUMN_SEP}m"] = np.broadcast_to(_layout_meta(layout), (n, _JPEG_META_LEN))
    return out


_MIXED_GEOMETRY_GUIDANCE = (
    "decode_placement='device' requires every stored jpeg to share one geometry and"
    " subsampling (the card decodes a batch of one geometry in one launch)."
    " Use decode_placement='device-mixed' (one launch a geometry bucket), re-encode"
    " the images uniformly, or use decode_placement='host'")


def _diagnose_coef_failure(column, exc) -> str:
    """Turn a batch coefficient-read failure into guidance: a corrupt cell
    (host decode would fail too) or mixed geometry (host decode works)."""
    cells = column if isinstance(column, (list, tuple)) else column.to_pylist()
    first = None
    for i, cell in enumerate(cells):
        try:
            lay = jpeg_coef_layout(bytes(cell))
        except CodecError:
            return f"cell {i} is not a decodable jpeg (corrupt or truncated stream): {exc}"
        if first is None:
            first = lay
        elif lay != first:
            return f"cell {i} has geometry {lay} but cell 0 has {first}: {_MIXED_GEOMETRY_GUIDANCE}"
    # headers parse and agree: corruption inside the entropy-coded data
    return f"{exc}. If the dataset mixes jpeg geometries: {_MIXED_GEOMETRY_GUIDANCE}."


#: suffix of the mixed-geometry wire column (``decode_placement='device-mixed'``):
#: one object cell a row, ``(per-component plane tuple, qtab (ncomp, 64),
#: layout-meta int32 vector)``.  Object columns ride batching and the shuffle
#: buffer like any other.
MIXED_CELL_SUFFIX = "x"


def pack_coef_columns_mixed(name: str, column, field=None, nthreads: int = 1) -> dict:
    """Entropy-decode a jpeg column of mixed geometries into one object column
    (``petastorm_tpu/native/image.py:414``).

    Worker side of ``decode_placement='device-mixed'``: the cells are grouped
    by coefficient-plane geometry (a header parse each), every group is
    entropy-decoded in one GIL-released C call, and every row becomes one
    object cell ``(planes, qtab, meta)``.  The loader groups the assembled
    batch by geometry again and runs kernel B2 once a geometry bucket.  A
    fixed-shape schema field must match every stored geometry; declare
    wildcard dims (``(None, None, 3)``) for a mixed dataset.
    """
    cells = list(column) if isinstance(column, (list, tuple)) else column.to_pylist()
    if not cells:
        raise CodecError(f"field {name!r}: empty jpeg column")
    groups: dict = {}
    for i, buf in enumerate(cells):
        try:
            layout = jpeg_coef_layout(bytes(buf))
        except CodecError as exc:
            raise CodecError(
                f"decode_placement='device-mixed' field {name!r}: cell {i} is not a"
                f" decodable jpeg (corrupt or truncated stream): {exc}") from exc
        if field is not None and field.is_fixed_shape and (
                layout.height, layout.width) != tuple(field.shape[:2]):
            raise CodecError(
                f"field {name!r}: stored jpeg is {layout.height}x{layout.width}, schema says"
                f" {tuple(field.shape[:2])}; declare wildcard dims (None, None, ...) for"
                " mixed-geometry datasets")
        groups.setdefault(_layout_meta(layout).tobytes(), []).append(i)
    out = np.empty(len(cells), dtype=object)
    for key, idxs in groups.items():
        planes, qtabs, _ = read_jpeg_coefficients_column([cells[i] for i in idxs],
                                                         nthreads=nthreads)
        meta = np.frombuffer(key, dtype=np.int32)
        for j, i in enumerate(idxs):
            out[i] = (tuple(p[j] for p in planes), qtabs[j], meta)
    return {f"{name}{COEF_COLUMN_SEP}{MIXED_CELL_SUFFIX}": out}


def coef_layout(name: str, meta_col: np.ndarray) -> JpegCoefLayout:
    """The one geometry of a batch's layout-meta rows (the ``#m`` column).
    Raises when the rows disagree: batch assembly may have joined rowgroups
    of different geometries."""
    if len(meta_col) == 0:
        raise CodecError(f"field {name!r}: empty coefficient batch")
    if not (meta_col == meta_col[0]).all():
        raise CodecError(
            f"field {name!r}: jpeg geometry changes between rowgroups of this dataset;"
            " the device decode path needs one uniform geometry - use"
            " decode_placement='host'.")
    return _layout_from_meta(meta_col[0])


def unpack_coef_columns(name: str, columns: dict):
    """Consumer side: the derived columns of one assembled batch ->
    ``(planes, qtabs, layout)``, the rows' geometry checked by :func:`coef_layout`."""
    layout = coef_layout(name, columns[f"{name}{COEF_COLUMN_SEP}m"])
    planes = [columns[f"{name}{COEF_COLUMN_SEP}p{c}"] for c in range(len(layout.components))]
    return planes, columns[f"{name}{COEF_COLUMN_SEP}q"], layout
