"""Binary wire encoding for the ingest service: pickle-free, self-describing.

The port's copy of ``petastorm_tpu/service/wire.py:37-472``: every frame is
the JAX package's byte for byte, so a frame one package writes, the other
reads.

Two frame kinds cross every service socket (``protocol.FrameSocket`` adds
the 4-byte length prefix):

* **CTRL** (:data:`KIND_CTRL`): one control message - a dict encoded with
  the bounded tag-length-value codec below (:func:`dumps`/:func:`loads`).
  Hellos, heartbeats, acks, work assignment, failures, stats: everything
  that is not a result batch.
* **BATCH** (:data:`KIND_BATCH`): one result payload - a CTRL-encoded
  header (column names/dtypes/shapes/offsets, row count, ordinal/attempt,
  codec id) followed by the raw column buffers, in exactly the column-major
  packed form :mod:`petastorm_tpu_torch.native.transport` uses for its shm blocks.
  Decoding builds numpy views over the received buffer - zero copies past
  the socket read - and **validates every spec against the actual buffer**
  (dtype sanity, shape/length agreement, bounds) before any array is built.

Security contract: decoding is **pure data** - no ``pickle``, no code
execution, no unbounded recursion/allocation.  Every malformed input path
raises :class:`WireFormatError` (a classified
:class:`~petastorm_tpu_torch.errors.PetastormTpuError`), never desyncs the
stream, and never interprets attacker bytes as python objects.  Object
dtypes are refused outright (a ``dtype='O'`` buffer view would be an
unpickle in disguise).  The only remaining pickle on the service wire is
the client->worker job plane (worker factory + work-item blobs), which the
dispatcher relays as opaque bytes and only an auth-gated client's worker
ever unpickles - see the protocol module's trust-boundary notes.

Compression: BATCH bodies may be compressed end-to-end (worker encodes,
client decodes; the dispatcher relays either way).  The codec is negotiated
per (worker, client) pair at job time - ``'zlib'`` for cross-host hops,
off for co-located pairs - see :func:`negotiate_codec`.
"""

from __future__ import annotations

import struct
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from petastorm_tpu_torch.errors import PetastormTpuError

#: wire-format generation, carried in every hello (bumped on incompatible
#: change; peers with a different value are refused loudly at hello time)
WIRE_VERSION = 2

#: frame-kind bytes (first payload byte after the length prefix)
KIND_CTRL = 0x01
KIND_BATCH = 0x02
#: pickle protocol >= 2 opcode: a frame starting with this byte is a legacy
#: v1 (pickled) peer - detected and refused without ever unpickling it
PICKLE_PROTO_BYTE = 0x80

#: codecs this build can (de)compress, in preference order (stdlib only)
SUPPORTED_CODECS = ("zlib",)
#: zlib level for BATCH bodies: speed over ratio (pixel data is large and
#: the wire is usually the bottleneck only cross-host)
_ZLIB_LEVEL = 1

# -- decode hardening bounds (all raise WireFormatError when exceeded) --------
_MAX_DEPTH = 32
_MAX_ITEMS = 1 << 20          # elements per container
_MAX_COLUMNS = 4096           # columns per batch frame
_MAX_NDIM = 16
_MAX_BODY_BYTES = 1 << 30     # matches protocol.MAX_FRAME_BYTES


class WireFormatError(PetastormTpuError):
    """A frame failed wire-format validation (truncated/corrupt header,
    unknown tag, bounds violation, dtype/shape vs buffer mismatch, refused
    payload kind).  Classified like any worker data failure - the peer that
    produced it gets a failure frame, never a desynced stream."""


_U8 = struct.Struct("!B")
_I64 = struct.Struct("!q")
_F64 = struct.Struct("!d")
_U32 = struct.Struct("!I")

_T_NONE = 0x00
_T_TRUE = 0x01
_T_FALSE = 0x02
_T_INT = 0x03
_T_FLOAT = 0x04
_T_STR = 0x05
_T_BYTES = 0x06
_T_LIST = 0x07
_T_DICT = 0x08
_T_NDARRAY = 0x09
_T_OBJARRAY = 0x0A


# -- control codec: encode ----------------------------------------------------

def _encode(out: bytearray, value: Any, depth: int) -> None:
    if depth > _MAX_DEPTH:
        raise WireFormatError("control value nests deeper than "
                              f"{_MAX_DEPTH} levels")
    if value is None:
        out += _U8.pack(_T_NONE)
    elif value is True:
        out += _U8.pack(_T_TRUE)
    elif value is False:
        out += _U8.pack(_T_FALSE)
    elif isinstance(value, (int, np.integer)):
        try:
            out += _U8.pack(_T_INT) + _I64.pack(int(value))
        except struct.error as exc:
            raise WireFormatError(
                f"int {value!r} does not fit the 64-bit wire int") from exc
    elif isinstance(value, (float, np.floating)):
        out += _U8.pack(_T_FLOAT) + _F64.pack(float(value))
    elif isinstance(value, str):
        raw = value.encode("utf-8")
        out += _U8.pack(_T_STR) + _U32.pack(len(raw)) + raw
    elif isinstance(value, (bytes, bytearray)):
        out += _U8.pack(_T_BYTES) + _U32.pack(len(value))
        out += value
    elif isinstance(value, memoryview):
        # len() of a non-byte-format/multi-dim view counts ELEMENTS, not
        # bytes - materialize so the length prefix and the body agree
        raw = bytes(value)
        out += _U8.pack(_T_BYTES) + _U32.pack(len(raw)) + raw
    elif isinstance(value, np.ndarray):
        _encode_array(out, value, depth)
    elif isinstance(value, (list, tuple)):
        if len(value) > _MAX_ITEMS:
            raise WireFormatError(f"list of {len(value)} exceeds wire bounds")
        out += _U8.pack(_T_LIST) + _U32.pack(len(value))
        for item in value:
            _encode(out, item, depth + 1)
    elif isinstance(value, dict):
        if len(value) > _MAX_ITEMS:
            raise WireFormatError(f"dict of {len(value)} exceeds wire bounds")
        out += _U8.pack(_T_DICT) + _U32.pack(len(value))
        for key, item in value.items():
            if not isinstance(key, str):
                raise WireFormatError(
                    f"wire dict keys must be str, got {type(key).__name__}")
            raw = key.encode("utf-8")
            out += _U32.pack(len(raw)) + raw
            _encode(out, item, depth + 1)
    else:
        raise WireFormatError(
            f"{type(value).__name__} is not wire-encodable (the binary"
            " control codec carries None/bool/int/float/str/bytes/list/"
            "dict/ndarray only)")


def _encode_array(out: bytearray, arr: np.ndarray, depth: int) -> None:
    if arr.ndim > _MAX_NDIM:
        raise WireFormatError(f"{arr.ndim}-d array exceeds wire bounds")
    if arr.dtype == object:
        if arr.size > _MAX_ITEMS:
            raise WireFormatError(
                f"object array of {arr.size} elements exceeds wire bounds")
        out += _U8.pack(_T_OBJARRAY) + _U8.pack(arr.ndim)
        for dim in arr.shape:
            out += _U32.pack(dim)
        for item in arr.ravel():
            _encode(out, item, depth + 1)
        return
    if arr.dtype.hasobject:
        raise WireFormatError("structured dtypes holding objects are not"
                              " wire-encodable")
    dtype_s = arr.dtype.str.encode("ascii")
    # cast("B") rejects empty arrays (zeros in shape/strides): fall back to
    # tobytes for those and for strided views (tobytes emits C order, which
    # is what decode's reshape assumes)
    raw = (memoryview(arr).cast("B")
           if arr.flags.c_contiguous and arr.nbytes else arr.tobytes())
    out += _U8.pack(_T_NDARRAY) + _U8.pack(len(dtype_s)) + dtype_s
    out += _U8.pack(arr.ndim)
    for dim in arr.shape:
        out += _U32.pack(dim)
    out += _U32.pack(arr.nbytes)
    out += raw


def dumps(value: Any) -> bytes:
    """Encode one control value (raises :class:`WireFormatError` for types
    outside the wire domain - the caller decides whether that means a bug
    or a pickle fallback)."""
    out = bytearray()
    _encode(out, value, 0)
    return bytes(out)


# -- control codec: decode ----------------------------------------------------

class _Reader:
    __slots__ = ("buf", "pos", "end")

    def __init__(self, buf, start: int = 0, end: Optional[int] = None):
        self.buf = buf
        self.pos = start
        self.end = len(buf) if end is None else end

    def take(self, n: int) -> memoryview:
        if n < 0 or self.pos + n > self.end:
            raise WireFormatError(
                f"truncated control frame (wanted {n} bytes at offset"
                f" {self.pos}, have {self.end - self.pos})")
        view = memoryview(self.buf)[self.pos:self.pos + n]
        self.pos += n
        return view

    def u8(self) -> int:
        return _U8.unpack(self.take(1))[0]

    def u32(self) -> int:
        return _U32.unpack(self.take(4))[0]


def _decode(r: _Reader, depth: int) -> Any:
    if depth > _MAX_DEPTH:
        raise WireFormatError("control frame nests deeper than "
                              f"{_MAX_DEPTH} levels")
    tag = r.u8()
    if tag == _T_NONE:
        return None
    if tag == _T_TRUE:
        return True
    if tag == _T_FALSE:
        return False
    if tag == _T_INT:
        return _I64.unpack(r.take(8))[0]
    if tag == _T_FLOAT:
        return _F64.unpack(r.take(8))[0]
    if tag == _T_STR:
        try:
            return str(r.take(r.u32()), "utf-8")
        except UnicodeDecodeError as exc:
            raise WireFormatError(f"invalid utf-8 in wire string: {exc}") \
                from exc
    if tag == _T_BYTES:
        return bytes(r.take(r.u32()))
    if tag == _T_LIST:
        count = r.u32()
        if count > _MAX_ITEMS:
            raise WireFormatError(f"wire list claims {count} items")
        return [_decode(r, depth + 1) for _ in range(count)]
    if tag == _T_DICT:
        count = r.u32()
        if count > _MAX_ITEMS:
            raise WireFormatError(f"wire dict claims {count} items")
        out = {}
        for _ in range(count):
            try:
                key = str(r.take(r.u32()), "utf-8")
            except UnicodeDecodeError as exc:
                raise WireFormatError(
                    f"invalid utf-8 in wire dict key: {exc}") from exc
            out[key] = _decode(r, depth + 1)
        return out
    if tag == _T_NDARRAY:
        dtype = _checked_dtype(str(r.take(r.u8()), "ascii", "replace"))
        shape = _decode_shape(r)
        nbytes = r.u32()
        count = _shape_count(shape)
        if count * dtype.itemsize != nbytes:
            raise WireFormatError(
                f"wire array claims {nbytes} bytes but dtype {dtype} x"
                f" shape {shape} needs {count * dtype.itemsize}")
        raw = r.take(nbytes)
        # .copy() detaches from the frame buffer AND yields a writable
        # array (consumers mutate batches in place, batch.py concat note)
        return np.frombuffer(raw, dtype=dtype,
                             count=count).reshape(shape).copy()
    if tag == _T_OBJARRAY:
        shape = _decode_shape(r)
        count = _shape_count(shape)
        if count > _MAX_ITEMS:
            # bound BEFORE np.empty: the shape alone must not command a
            # multi-GB pointer-array allocation from a 6-byte frame (the
            # same cap lists and dicts enforce)
            raise WireFormatError(f"wire object array claims {count} items")
        out = np.empty(count, dtype=object)
        for i in range(count):
            out[i] = _decode(r, depth + 1)
        return out.reshape(shape)
    raise WireFormatError(f"unknown control tag 0x{tag:02x}")


def _decode_shape(r: _Reader) -> Tuple[int, ...]:
    ndim = r.u8()
    if ndim > _MAX_NDIM:
        raise WireFormatError(f"wire array claims {ndim} dimensions")
    return tuple(r.u32() for _ in range(ndim))


def _shape_count(shape: Sequence[int]) -> int:
    count = 1
    for dim in shape:
        count *= dim
        if count > _MAX_BODY_BYTES:
            raise WireFormatError(f"wire array shape {tuple(shape)} is"
                                  " implausibly large")
    return count


def _checked_dtype(dtype_s: str) -> np.dtype:
    try:
        dtype = np.dtype(dtype_s)
    except TypeError as exc:
        raise WireFormatError(f"bad wire dtype {dtype_s!r}") from exc
    if dtype.hasobject:
        # a dtype-'O' view would deserialize pointers = an unpickle in
        # disguise; the wire refuses it no matter what the header claims
        raise WireFormatError("object dtypes are not allowed on the wire")
    if dtype.itemsize == 0 or dtype.itemsize > (1 << 20):
        raise WireFormatError(f"implausible wire dtype {dtype_s!r}")
    return dtype


def loads(data, start: int = 0, end: Optional[int] = None) -> Any:
    """Decode one control value; the encoded object must span exactly
    ``data[start:end]`` (trailing garbage = a framing bug = refused)."""
    r = _Reader(data, start, end)
    value = _decode(r, 0)
    if r.pos != r.end:
        raise WireFormatError(
            f"{r.end - r.pos} trailing byte(s) after the control value")
    return value


# -- batch frames: header + raw column buffers --------------------------------

def encode_batch_parts(batch, codec: str = "") -> Optional[Tuple[Dict, List]]:
    """Split a ColumnBatch into a BATCH-frame header dict + body buffers.

    Raw fixed-shape columns become zero-copy body parts referenced by
    ``(dtype, shape, offset, nbytes)`` specs; object/empty columns ride
    inline in the header via the control codec (strings, bytes, ragged
    arrays).  Returns None when the batch cannot travel binary (a column
    holds values outside the wire domain) - the caller's cue for the
    counted pickle fallback.  ``codec`` compresses the assembled body
    end-to-end (the dispatcher relays it opaque either way).
    """
    from petastorm_tpu_torch.batch import ColumnBatch

    if not isinstance(batch, ColumnBatch):
        return None
    cols: Dict[str, Any] = {}
    parts: List[Any] = []
    offset = 0
    for name, col in batch.columns.items():
        if (isinstance(col, np.ndarray) and col.dtype != object
                and not col.dtype.hasobject and col.nbytes > 0):
            parts.append(col.data.cast("B") if col.flags.c_contiguous
                         else col.tobytes())
            cols[name] = ["raw", col.dtype.str, list(col.shape), offset,
                          col.nbytes]
            offset += col.nbytes
        else:
            try:
                dumps(col)  # probe: is this column inside the wire domain?
            except WireFormatError:
                return None
            cols[name] = ["inline", col]
    # "bord" (batch ordinal) not "ordinal": result frames merge this header
    # with frame-level fields, and the work item's ordinal must not clobber
    # the batch's own (None for non-decode workers)
    header = {"rows": batch.num_rows, "bord": batch.ordinal,
              "cols": cols, "blen": offset, "codec": codec or ""}
    if codec:
        if codec not in SUPPORTED_CODECS:
            raise WireFormatError(f"unknown wire codec {codec!r}")
        parts = [zlib.compress(b"".join(parts), _ZLIB_LEVEL)]
    return header, parts


def decode_batch_body(header: Dict, body) -> Any:
    """Rebuild a ColumnBatch from a BATCH frame (validated; numpy columns
    are writable views over the received buffer - zero further copies when
    uncompressed).  Raises :class:`WireFormatError` on any header/buffer
    disagreement."""
    from petastorm_tpu_torch.batch import ColumnBatch

    codec = header.get("codec") or ""
    blen = header.get("blen")
    if not isinstance(blen, int) or blen < 0 or blen > _MAX_BODY_BYTES:
        raise WireFormatError(f"batch frame claims body of {blen!r} bytes")
    if codec:
        if codec not in SUPPORTED_CODECS:
            raise WireFormatError(
                f"batch frame compressed with unknown codec {codec!r}"
                f" (this build supports {SUPPORTED_CODECS})")
        d = zlib.decompressobj()
        try:
            body = bytearray(d.decompress(bytes(body), blen + 1))
        except zlib.error as exc:
            raise WireFormatError(f"corrupt {codec} batch body: {exc}") \
                from exc
    if len(body) != blen:
        raise WireFormatError(
            f"batch body is {len(body)} bytes, header claims {blen}")
    rows = header.get("rows")
    if not isinstance(rows, int) or rows < 0:
        raise WireFormatError(f"batch frame claims {rows!r} rows")
    specs = header.get("cols")
    if not isinstance(specs, dict) or len(specs) > _MAX_COLUMNS:
        raise WireFormatError("batch frame column table missing or oversize"
                              f" ({0 if not isinstance(specs, dict) else len(specs)}"
                              f" of max {_MAX_COLUMNS})")
    view = memoryview(body)
    columns: Dict[str, Any] = {}
    for name, spec in specs.items():
        if not isinstance(spec, (list, tuple)) or not spec:
            raise WireFormatError(f"column {name!r} has a malformed spec")
        if spec[0] == "raw":
            try:
                _, dtype_s, shape, offset, nbytes = spec
            except ValueError as exc:
                raise WireFormatError(
                    f"column {name!r} raw spec has {len(spec)} fields") \
                    from exc
            dtype = _checked_dtype(dtype_s)
            if (not isinstance(shape, (list, tuple)) or len(shape) > _MAX_NDIM
                    or not all(isinstance(d, int) and d >= 0 for d in shape)):
                raise WireFormatError(f"column {name!r} has bad shape"
                                      f" {shape!r}")
            count = _shape_count(shape)
            if (not isinstance(offset, int) or not isinstance(nbytes, int)
                    or count * dtype.itemsize != nbytes):
                raise WireFormatError(
                    f"column {name!r}: dtype {dtype} x shape {tuple(shape)}"
                    f" needs {count * dtype.itemsize} bytes, spec claims"
                    f" {nbytes!r} at {offset!r}")
            if offset < 0 or offset + nbytes > len(body):
                raise WireFormatError(
                    f"column {name!r} spans [{offset}, {offset + nbytes})"
                    f" outside the {len(body)}-byte body")
            columns[name] = np.frombuffer(
                view, dtype=dtype, count=count,
                offset=offset).reshape(shape)
        elif spec[0] == "inline":
            if len(spec) != 2:
                raise WireFormatError(
                    f"column {name!r} inline spec has {len(spec)} fields")
            columns[name] = spec[1]
        else:
            raise WireFormatError(
                f"column {name!r} has unknown spec kind {spec[0]!r}")
    try:
        return ColumnBatch(columns, rows, ordinal=header.get("bord"))
    except (ValueError, TypeError) as exc:
        raise WireFormatError(f"batch columns disagree with the claimed"
                              f" {rows} rows: {exc}") from exc


def negotiate_codec(preference: str, same_host: bool,
                    client_codecs: Sequence[str],
                    worker_codecs: Sequence[str]) -> str:
    """The per-(worker, client) BATCH-body codec: '' (off) or a member of
    :data:`SUPPORTED_CODECS` both ends advertised.

    ``preference`` is the dispatcher's policy knob: ``'auto'`` compresses
    cross-host hops only (loopback/shm pairs skip the CPU tax), ``'off'``
    never compresses, a codec name forces it for every hop that supports
    it.  Unknown peers' codec lists are intersected, so a client built
    without a codec degrades to uncompressed, never to a frame it cannot
    decode."""
    if preference == "off" or (preference == "auto" and same_host):
        return ""
    common = [c for c in SUPPORTED_CODECS
              if c in (client_codecs or ()) and c in (worker_codecs or ())]
    if preference == "auto":
        return common[0] if common else ""
    return preference if preference in common else ""
