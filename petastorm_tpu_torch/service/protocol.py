"""Wire protocol for the disaggregated ingest service.

The port's copy of ``petastorm_tpu/service/protocol.py:128-805``, speaking
the JAX package's frames.  The ``"shm"`` payloads go over the port's arena
(``native/transport.py``), whose descriptor carries the same fields.

Lifts ``pool.py``'s ventilate/results contract onto length-prefixed socket
frames carrying the **v2 binary wire** (:mod:`petastorm_tpu_torch.service.wire`):
control messages are self-describing binary dicts, result batches are
schema'd column frames (header + raw buffers), and nothing that arrives on
a service socket is ever unpickled to be *parsed* - the data plane is
pickle-free end to end.

Frame format: a 4-byte big-endian payload length, a 1-byte frame kind,
then the body:

* ``KIND_CTRL``: one control dict (:func:`wire.dumps`).  All non-result
  messages - tagged by ``"t"``:

  ======================  =====================================================
  ``client_hello``        client -> dispatcher: client_id, opaque worker
                          factory blob, hostname, shm capability, accepted
                          codecs, requeue budget, ``resume`` flag.  The
                          ``hello_ok`` reply carries the dispatcher's
                          ``boot`` id (clients count
                          ``service.dispatcher_restarts`` off a change)
                          and the ``known`` ordinal list (a journal-armed
                          warm restart tells the client which resync
                          re-sends to skip)
  ``enqueue``             client -> dispatcher: one work item
                          (:class:`WireItem` fields - structural ordinal/
                          attempt/rowgroup metadata + an opaque item blob)
  ``resync``              client -> dispatcher after a reconnect: every item
                          still in the client's in-flight ledger (dispatcher
                          dedups by ordinal against its own state)
  ``ack``                 client -> dispatcher: delivered ordinals (frees the
                          dispatcher's redelivery buffer)
  ``client_stats``        client -> dispatcher: consumer starved-seconds delta
                          (fleet-size pressure - Dispatcher.scaling_signal)
  ``bye``                 client -> dispatcher: clean goodbye (purge state)
  ``worker_hello``        worker -> dispatcher: name, capacity, hostname,
                          codecs; on a REJOIN (dispatcher restart / link
                          blip survived with ``reconnect_attempts``) also
                          ``resume`` plus the ``assignments`` it is still
                          executing and the client ``jobs`` it holds - the
                          dispatcher records claims so a reconnecting
                          client's resync re-attaches instead of
                          double-assigning
  ``heartbeat``           worker -> dispatcher: busy count + telemetry counter
                          deltas (folded into ``service.fleet.*``)
  ``failure``             worker -> dispatcher -> client: one item's classified
                          failure (formatted traceback + kind + exc_type as
                          plain fields; the client recovers the failed item
                          from its own ledger - no object rides the wire)
  ``job``                 dispatcher -> worker: a client's opaque factory blob
                          plus the negotiated shm flag and wire codec for the
                          pair (sent once per (worker, client))
  ``job_done``            dispatcher -> worker: drop that client's factory
  ``work``                dispatcher -> worker: one assigned item (WireItem)
  ``requeued``            dispatcher -> client: an in-flight item was requeued
                          off a dead worker (accounting notice)
  ``stats?``/``stats``    any -> dispatcher: state snapshot (CLI, tests)
  ``hb_ok``               dispatcher -> worker: heartbeat reply carrying the
                          dispatcher ``epoch`` (split-brain fencing: a
                          deposed primary's lower epoch is refused -
                          ``hello_ok`` carries the same field)
  ``drained?``            retiring worker -> dispatcher: "is anything still
                          assigned to me?"; answered ``drain_ok`` (send the
                          goodbye) or ``drain_wait`` (results still in
                          flight) - the drain handshake is structural, not
                          a timing window
  ``standby_hello``       standby dispatcher -> primary: subscribe to the
                          journal tail.  The ``standby_ok`` reply carries
                          the primary's ``epoch`` + ``boot``; then the
                          primary streams ``journal_sync`` frames
  ``journal_sync``        primary -> standby: journal records over the wire.
                          ``k``: ``snap`` (snapshot chunk, ``recs`` list) /
                          ``snap_end`` (snapshot complete) / ``rec`` (one
                          live tail record) / ``ping`` (idle keepalive);
                          every frame carries the primary's journal ``seq``
                          so the standby can meter its lag
                          (``service.standby_lag_items``)
  ======================  =====================================================

* ``KIND_BATCH``: one ``result`` outcome - a CTRL-encoded header (``t``,
  ordinal/attempt/rows, payload kind ``pk``, column specs, codec id)
  followed by the raw column buffers.  The dispatcher **relays the body as
  opaque bytes** (it parses only the header); the client rebuilds numpy
  columns as writable views over the received buffer - zero pickle, zero
  extra copies on the hot path.

Result payload kinds (``pk`` in the result header):

* ``"bin"`` - schema'd binary columns (the portable hot path, any host;
  body optionally compressed with the pair's negotiated codec);
* ``"shm"`` - the co-located fast path: the batch was encoded once into a
  named shared-memory arena (:mod:`petastorm_tpu_torch.native.transport`) and
  only the descriptor crosses the socket.  Armed when both ends share a
  host AND the native transport plane is available (python >= 3.12
  PEP 688, like the process pool's shm transport);
* ``"pickle"`` - the counted fallback for results outside the wire domain
  (arbitrary worker-function outputs, unencodable transform columns).
  Decoding it is the ONE place a client may unpickle service bytes, it is
  metered (``service.frames_pickle_fallback``) so a hot fallback is
  visible, and ``ServiceExecutor(allow_pickle_results=False)`` (or
  ``PETASTORM_TPU_SERVICE_ALLOW_PICKLE=0``) refuses it outright as a
  classified failure.

.. note:: **Trust boundary (v2).**  No service endpoint unpickles anything
   to parse the wire: hellos, control frames, and result batches decode
   through the bounded binary codec, so reaching the dispatcher port no
   longer means code execution - a malicious peer can at worst present bad
   credentials or feed bogus tensors, which fail validation as classified
   errors.  ``pickle`` remains in exactly two trusted places: (1) the
   client->worker job plane - the worker factory and work-item blobs a
   token-holding client ships for the fleet to execute, relayed by the
   dispatcher as opaque bytes and unpickled only inside workers (running
   client code IS the service's job); (2) the client-side ``"pickle"``
   result fallback described above.  The handshake secret
   (:data:`AUTH_TOKEN_ENV` / ``auth_token=``) gates who may ship jobs;
   network isolation still applies for defense in depth - see
   docs/operations.md "Disaggregated ingest service".

Legacy peers: a v1 (pickled-frame) peer is detected by its first payload
byte (the pickle protocol opcode) without unpickling it, answered with a
v1-readable error frame, and disconnected - old clients fail loudly with
"protocol version mismatch" instead of desyncing.
"""

from __future__ import annotations

import hmac
import logging
import os
import pickle
import select
import socket
import struct
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from petastorm_tpu_torch.batch import ColumnBatch
from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.service import wire
from petastorm_tpu_torch.service.wire import (KIND_BATCH, KIND_CTRL,
                                        PICKLE_PROTO_BYTE, SUPPORTED_CODECS,
                                        WireFormatError)

logger = logging.getLogger(__name__)

#: protocol version, checked at hello time (bumped on incompatible change;
#: 2 = the pickle-free binary wire)
PROTOCOL_VERSION = 2

_LEN = struct.Struct("!I")
_U32 = struct.Struct("!I")
#: frames larger than this are refused (a decoded rowgroup batch is tens of
#: MB; anything approaching this is a corrupt length prefix, not data)
MAX_FRAME_BYTES = 1 << 30
#: a peer that cannot drain a frame for this long is declared dead (a
#: paused/SIGSTOPped trainer with a full TCP buffer must not wedge the
#: dispatcher thread sending to it - see FrameSocket send paths)
SEND_TIMEOUT_S = 30.0
#: non-blocking-send flag (0 where unsupported: send then degrades to the
#: old unbounded blocking behavior rather than breaking)
_MSG_DONTWAIT = getattr(socket, "MSG_DONTWAIT", 0)
#: environment variable all parties read their shared handshake secret
#: from (the CLI's --auth-token-file overrides it)
AUTH_TOKEN_ENV = "PETASTORM_TPU_SERVICE_TOKEN"
#: set to 0/false to make clients refuse ``"pickle"`` result payloads as
#: classified failures (hardened deployments; binary/shm results only)
ALLOW_PICKLE_ENV = "PETASTORM_TPU_SERVICE_ALLOW_PICKLE"

_KIND_CTRL_B = bytes([KIND_CTRL])
_KIND_BATCH_B = bytes([KIND_BATCH])


def resolve_auth_token(explicit: Optional[str] = None) -> Optional[str]:
    """The handshake secret: the explicit value if given, else
    :data:`AUTH_TOKEN_ENV`, else None (auth disabled)."""
    if explicit is not None:
        return explicit
    return os.environ.get(AUTH_TOKEN_ENV) or None


def resolve_allow_pickle(explicit: Optional[bool] = None) -> bool:
    """Whether this client accepts ``"pickle"`` result payloads: the
    explicit value if given, else :data:`ALLOW_PICKLE_ENV` (default on -
    arbitrary worker-function results need it; the binary plane carries
    every ColumnBatch regardless)."""
    if explicit is not None:
        return bool(explicit)
    return os.environ.get(ALLOW_PICKLE_ENV, "1").strip().lower() not in (
        "0", "false", "no", "off")


def token_matches(expected: Optional[str], presented: Any) -> bool:
    """Constant-time handshake token check (True when auth is off)."""
    if expected is None:
        return True
    if not isinstance(presented, str):
        return False
    return hmac.compare_digest(expected.encode(), presented.encode())


class FrameClosedError(PetastormTpuError):
    """The peer closed the connection (EOF mid-stream or before a frame)."""


class LegacyPickleFrameError(WireFormatError):
    """The peer sent a v1 pickled frame (detected by its first byte, never
    unpickled).  Listeners answer with a v1-readable refusal so the old
    peer fails loudly with a version message instead of desyncing."""


class WireItem:
    """Dispatcher-side view of one ventilated work item.

    The structural fields the dispatcher schedules on - ``ordinal``,
    ``attempt``, and the rowgroup-affinity key ``rg`` (``[path, index]`` or
    None) - travel as plain wire values; the work item itself is an opaque
    ``blob`` the dispatcher **never unpickles** (only the assigned worker
    does, to run the client's job - the same trust plane as the factory
    bootstrap).

    ``tc`` is the optional distributed-trace context: ``{"id": <trace id>,
    "hops": [[who, name, attempt, t_ns, off_ns], ...]}``.  Untraced items
    (the default) carry no ``tc`` key at all, so tracing is free on the
    wire when disarmed.  Every hop stamp records the stamping process
    (``who``: ``"d"`` for the dispatcher, else the worker name), the hop
    name, the item attempt it belongs to, a ``perf_counter_ns`` timestamp
    in the stamper's own clock, and that process's estimated offset to the
    dispatcher clock (``off_ns``; 0 for dispatcher stamps) - enough for
    the client to map every stamp into its own monotonic domain and merge
    the whole cross-process timeline into one Chrome trace.
    """

    __slots__ = ("ordinal", "attempt", "blob", "rg", "tc")

    def __init__(self, ordinal: int, attempt: int, blob: bytes, rg=None,
                 tc=None):
        self.ordinal = ordinal
        self.attempt = attempt
        self.blob = blob
        self.rg = rg
        self.tc = tc

    @classmethod
    def from_wire(cls, msg: Dict[str, Any]) -> "WireItem":
        ordinal, attempt = msg.get("o"), msg.get("a", 0)
        blob = msg.get("blob")
        if not isinstance(ordinal, int) or not isinstance(attempt, int) \
                or not isinstance(blob, (bytes, bytearray)):
            raise WireFormatError(f"malformed work item frame: {msg!r}")
        tc = msg.get("tc")
        if tc is not None and not isinstance(tc, dict):
            tc = None
        return cls(ordinal, attempt, bytes(blob), msg.get("rg"), tc)

    def to_wire(self) -> Dict[str, Any]:
        """Wire fields for a ``work`` frame (the inverse of
        :meth:`from_wire`)."""
        out = {"o": self.ordinal, "a": self.attempt, "blob": self.blob}
        if self.rg is not None:
            out["rg"] = self.rg
        if self.tc is not None:
            out["tc"] = self.tc
        return out

    @staticmethod
    def encode(item: Any, trace_id: Optional[int] = None) -> Dict[str, Any]:
        """Client-side: one pool ``VentilatedItem`` -> wire fields (the
        work payload is pickled into the opaque blob; rowgroup affinity
        metadata is lifted out structurally for the dispatcher).  Passing
        ``trace_id`` arms distributed tracing for this item: downstream
        hops append timing stamps to ``tc["hops"]`` and return them with
        the result."""
        work = getattr(item, "item", None)
        out = {"o": int(item.ordinal),
               "a": int(getattr(item, "attempt", 0)),
               "blob": pickle.dumps(work, protocol=pickle.HIGHEST_PROTOCOL)}
        rg = getattr(work, "row_group", None)
        if rg is not None:
            out["rg"] = [str(getattr(rg, "path", "")),
                         int(getattr(rg, "row_group", 0))]
        if trace_id is not None:
            out["tc"] = {"id": int(trace_id), "hops": []}
        return out


class _PayloadPool:
    """Recycles large frame-payload buffers for one FrameSocket.

    A data-plane socket receives a steady stream of near-identical multi-MB
    result frames; allocating and freeing each through malloc makes hot-path
    throughput hostage to process-wide allocator tuning (a raised
    ``MALLOC_MMAP_THRESHOLD_``, set for the decode plane's pooling,
    measurably slowed the relay).  The pool retains up to ``MAX`` slabs and
    lends one out when **no other reference exists** (``sys.getrefcount`` -
    the numpy views a decoded batch builds over the buffer keep its
    refcount elevated exactly as long as the data is alive, so a slab is
    reused only after its previous frame's consumers are done).  Single
    consumer per socket, like ``recv`` itself - no locking.
    """

    MAX_SLABS = 16
    MIN_BYTES = 1 << 20

    __slots__ = ("_slabs",)

    def __init__(self):
        self._slabs: List[bytearray] = []

    def take(self, length: int) -> bytearray:
        if length < self.MIN_BYTES:
            return bytearray(length)
        stale = None
        for i, ba in enumerate(self._slabs):
            # 3 = the slabs-list entry, the loop variable, and the
            # getrefcount argument: nothing else holds this slab
            if sys.getrefcount(ba) == 3:
                if len(ba) == length:
                    return ba
                if stale is None:
                    stale = i
        out = bytearray(length)
        if stale is not None:
            # variable-size streams (compressed bodies, uneven rowgroups)
            # rarely repeat a length: REPLACE a free wrong-size slab so the
            # pool never pins dead multi-MB buffers for the connection's
            # lifetime
            self._slabs[stale] = out
        elif len(self._slabs) < self.MAX_SLABS:
            self._slabs.append(out)
        return out

    def clear(self) -> None:
        self._slabs.clear()


class FrameSocket:
    """A socket speaking length-prefixed v2 binary frames.

    Sends are thread-safe (one lock per socket: the dispatcher's pump and
    reply paths send to the same worker from different threads).  ``recv``
    has a single consumer per socket (each connection gets one reader
    thread) and keeps partial frames across timeouts.

    ``send_timeout_s`` bounds how long one send may block on a peer that
    stops draining its TCP buffer; expiry declares the peer dead (the
    socket is closed - a partial frame would desync the stream anyway) and
    raises OSError, which every caller already treats as a dead peer.
    """

    def __init__(self, sock: socket.socket,
                 send_timeout_s: float = SEND_TIMEOUT_S):
        try:
            # small control frames must not sit in Nagle buffers behind a
            # large result frame; best-effort (AF_UNIX sockets refuse it)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        # multi-MB result frames: default loopback socket buffers (~200KB)
        # force dozens of wakeup round-trips per frame, which on a shared
        # core serializes against decode; best-effort enlarge
        for opt in (socket.SO_SNDBUF, socket.SO_RCVBUF):
            try:
                sock.setsockopt(socket.SOL_SOCKET, opt, 1 << 22)
            except OSError:
                pass
        # blocking mode, permanently: recv timeouts use select (see
        # _recv_some), so a send can never inherit a recv timeout and die
        # mid-frame
        sock.settimeout(None)
        self._sock = sock
        self._send_lock = threading.Lock()
        # partial-frame state, kept across recv timeouts: the 4-byte length
        # prefix, then the exact-size payload bytearray filled IN PLACE by
        # recv_into - one user-space copy per received byte, total (the
        # decoded numpy views alias this same buffer)
        self._hdr = bytearray(_LEN.size)
        self._hdr_filled = 0
        self._payload: Optional[bytearray] = None
        self._payload_filled = 0
        self._pool = _PayloadPool()
        self._closed = False
        self.send_timeout_s = send_timeout_s
        #: cumulative frame bytes (telemetry: service.frame_bytes_*)
        self.bytes_sent = 0
        self.bytes_received = 0

    # -- sending --------------------------------------------------------------

    def send(self, msg: Dict[str, Any]) -> int:
        """Encode + frame + bounded write of one control dict; returns the
        frame size in bytes.  Raises OSError when the connection is gone or
        the peer stops draining for longer than ``send_timeout_s`` (the
        socket is then closed: a partially-written frame cannot be
        resumed); :class:`WireFormatError` when ``msg`` holds values
        outside the wire domain (a caller bug, not a peer failure)."""
        return self._write_frame([_KIND_CTRL_B + wire.dumps(msg)])

    def send_batch(self, header: Dict[str, Any], parts: List[Any]) -> int:
        """Send one BATCH frame: a control-encoded ``header`` followed by
        raw body buffers, written **vectored** - the (possibly tens-of-MB)
        parts are never concatenated into a staging buffer.  Parts may be
        bytes/bytearray/memoryview (e.g. views straight over numpy column
        memory or a relayed body)."""
        encoded = wire.dumps(header)
        head = _KIND_BATCH_B + _U32.pack(len(encoded)) + encoded
        return self._write_frame([head, *parts])

    def send_legacy_error(self, message: str) -> int:
        """Answer a v1 (pickled-protocol) peer in the ONE format it can
        read: a pickled error frame.  ``pickle.dumps`` of our own literal
        is safe (only ``loads`` of attacker bytes is not); this exists so
        old clients fail loudly with the version message instead of
        crashing on undecodable bytes."""
        payload = pickle.dumps({"t": "error", "error": message}, protocol=2)
        return self._write_frame([payload])

    def _write_frame(self, chunks: List[Any]) -> int:
        total = sum(len(c) for c in chunks)
        if total > MAX_FRAME_BYTES:
            raise PetastormTpuError(
                f"frame of {total} bytes exceeds MAX_FRAME_BYTES")
        # the length prefix rides the first (always small) chunk so a
        # control frame is one send() syscall
        chunks = [_LEN.pack(total) + bytes(chunks[0]), *chunks[1:]]
        with self._send_lock:
            if self._closed:
                raise OSError("frame socket is closed")
            deadline = (None if self.send_timeout_s is None
                        else time.monotonic() + self.send_timeout_s)
            for chunk in chunks:
                deadline = self._drain(memoryview(chunk).cast("B"), deadline,
                                       total)
            self.bytes_sent += _LEN.size + total
        return _LEN.size + total

    def _drain(self, view: memoryview, deadline: Optional[float],
               frame_size: int) -> Optional[float]:
        """Write one chunk with the bounded-stall policy; returns the
        (possibly re-armed) deadline for the next chunk.  Caller holds the
        send lock."""
        while view:
            if deadline is None:
                remaining = None
            else:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self.close()
                    raise OSError(
                        f"peer did not drain a {frame_size}-byte frame"
                        f" within {self.send_timeout_s}s; declaring it"
                        " dead")
            try:
                # non-blocking attempt first, select only on a full
                # buffer: AF_UNIX sockets report not-writable long
                # before a blocking send would block, so select-first
                # would falsely time out on merely-slow local peers
                sent = self._sock.send(view, _MSG_DONTWAIT)
                view = view[sent:]
                if sent and deadline is not None:
                    # the timeout bounds a DRAIN STALL, not the whole
                    # frame: a peer accepting bytes - however slowly -
                    # is alive, so progress re-arms the deadline (a
                    # tens-of-MB result on a slow link must not be
                    # declared dead mid-transfer)
                    deadline = time.monotonic() + self.send_timeout_s
            except BlockingIOError:
                # buffer genuinely full: wait for drain with a deadline
                # so a stalled peer blocks HERE boundedly, never inside
                # a blocking sendall.  Short slices, because AF_UNIX
                # writability is stricter than EAGAIN - a slowly
                # draining peer can accept sends while select still
                # reports not-writable
                wait = 0.05 if remaining is None else min(remaining, 0.05)
                try:
                    select.select([], [self._sock], [], wait)
                except ValueError as exc:
                    # select on a concurrently-closed socket (fd -1)
                    raise OSError(
                        f"frame socket closed mid-send: {exc}") from exc
        return deadline

    # -- receiving ------------------------------------------------------------

    def recv(self, timeout: Optional[float] = None) -> Optional[Dict[str, Any]]:
        """Next message, or None on timeout (partial frames are kept and
        completed by later calls).  Raises FrameClosedError on EOF and
        :class:`WireFormatError` on an undecodable frame (the frame was
        fully consumed first, so the stream itself stays synced).  BATCH
        frames return their header dict with the raw body attached under
        ``"_body"`` (a writable buffer - the zero-copy decode substrate).
        One deadline covers header AND body: the call returns within
        ``timeout`` total, not per fill."""
        if self._closed:
            raise FrameClosedError("frame socket is closed")
        deadline = None if timeout is None else time.monotonic() + timeout
        while self._hdr_filled < _LEN.size:
            n = self._recv_some(
                memoryview(self._hdr)[self._hdr_filled:], deadline)
            if n is None:
                return None
            self._hdr_filled += n
        if self._payload is None:
            (length,) = _LEN.unpack(self._hdr)
            if length > MAX_FRAME_BYTES:
                raise PetastormTpuError(
                    f"incoming frame claims {length} bytes (corrupt"
                    " stream?)")
            self._payload = self._pool.take(length)
            self._payload_filled = 0
        view = memoryview(self._payload)
        while self._payload_filled < len(self._payload):
            n = self._recv_some(view[self._payload_filled:], deadline)
            if n is None:
                return None
            self._payload_filled += n
        payload = self._payload
        del view
        self._payload = None
        self._hdr_filled = 0
        self.bytes_received += _LEN.size + len(payload)
        return self._parse(payload)

    @staticmethod
    def _parse(payload) -> Dict[str, Any]:
        if not len(payload):
            raise WireFormatError("empty frame")
        kind = payload[0]
        if kind == KIND_CTRL:
            msg = wire.loads(payload, 1)
            if not isinstance(msg, dict):
                raise WireFormatError(
                    f"control frame decodes to {type(msg).__name__},"
                    " expected a message dict")
            return msg
        if kind == KIND_BATCH:
            if len(payload) < 1 + _U32.size:
                raise WireFormatError("truncated batch frame header")
            (hlen,) = _U32.unpack_from(payload, 1)
            body_at = 1 + _U32.size + hlen
            if body_at > len(payload):
                raise WireFormatError(
                    f"batch frame claims a {hlen}-byte header inside a"
                    f" {len(payload)}-byte payload")
            msg = wire.loads(payload, 1 + _U32.size, body_at)
            if not isinstance(msg, dict):
                raise WireFormatError("batch header is not a message dict")
            # writable view, zero-copy: numpy columns decode straight over
            # the received buffer (the bytearray stays alive via the view)
            msg["_body"] = memoryview(payload)[body_at:]
            return msg
        if kind == PICKLE_PROTO_BYTE:
            raise LegacyPickleFrameError(
                "peer sent a v1 pickled frame; this endpoint speaks the v2"
                " binary wire (pickle frames are refused, never loaded -"
                " upgrade the peer)")
        raise WireFormatError(f"unknown frame kind 0x{kind:02x}")

    def _recv_some(self, view: memoryview, deadline: Optional[float]):
        """Receive up to ``len(view)`` bytes INTO ``view`` (one user-space
        copy, straight from the kernel); returns the byte count, or None
        once ``deadline`` (an absolute monotonic instant) passes.  Raises
        FrameClosedError on EOF.

        Non-blocking attempt first, select only when the buffer is empty.
        Timeouts come from ``select``, NOT ``settimeout``: a socket timeout
        is socket-global, so setting one for recv would also arm it for a
        concurrent send on another thread - which can then raise after a
        PARTIAL write of a large frame and permanently desync the
        length-prefixed stream."""
        while True:
            if not _MSG_DONTWAIT:
                # platform without MSG_DONTWAIT: select-first so the
                # blocking recv_into below cannot ignore the deadline
                remaining = (None if deadline is None
                             else max(0.0, deadline - time.monotonic()))
                try:
                    readable, _, _ = select.select([self._sock], [], [],
                                                   remaining)
                except ValueError as exc:
                    raise FrameClosedError(
                        f"frame socket closed locally: {exc}") from exc
                if not readable:
                    return None
            try:
                n = self._sock.recv_into(view, min(len(view), 1 << 22),
                                         _MSG_DONTWAIT)
            except BlockingIOError:
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                else:
                    remaining = None
                try:
                    readable, _, _ = select.select([self._sock], [], [],
                                                   remaining)
                except ValueError as exc:
                    # select on a locally-closed socket (fd -1, e.g. a
                    # send-timeout death on another thread): same terminal
                    # condition as EOF, and it must map to FrameClosedError
                    # so read loops reconnect instead of crashing
                    raise FrameClosedError(
                        f"frame socket closed locally: {exc}") from exc
                if not readable:
                    return None
                continue
            except OSError as exc:
                raise FrameClosedError(f"connection lost: {exc}") from exc
            except ValueError as exc:
                raise FrameClosedError(
                    f"frame socket closed locally: {exc}") from exc
            if n == 0:
                raise FrameClosedError("peer closed the connection")
            return n

    def close(self) -> None:
        """Shutdown + close; a blocked peer recv sees EOF immediately."""
        self._closed = True
        self._pool.clear()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


def connect_frames(address: Tuple[str, int],
                   timeout: float = 10.0) -> FrameSocket:
    """Open a FrameSocket to ``(host, port)`` (connect-timeout bounded)."""
    sock = socket.create_connection(address, timeout=timeout)
    sock.settimeout(None)
    return FrameSocket(sock)


def parse_address(address) -> Tuple[str, int]:
    """'host:port' / (host, port) -> (host, port).  The one place the CLI,
    client and tests agree on the address syntax."""
    if isinstance(address, (tuple, list)) and len(address) == 2:
        return str(address[0]), int(address[1])
    if isinstance(address, str) and ":" in address:
        host, _, port = address.rpartition(":")
        return host or "127.0.0.1", int(port)
    raise PetastormTpuError(
        f"service address must be 'host:port' or (host, port); got {address!r}")


def parse_address_list(address) -> List[Tuple[str, int]]:
    """Failover address syntax: ``'a:p'``/``(host, port)`` (one address) or
    ``'a:p,b:p'`` - a primary-then-standby list clients, workers and the
    autoscale prober rotate through on connection loss (docs/operations.md
    "Dispatcher HA")."""
    if isinstance(address, str) and "," in address:
        parts = [p.strip() for p in address.split(",") if p.strip()]
        if not parts:
            raise PetastormTpuError(
                f"service address list is empty: {address!r}")
        return [parse_address(p) for p in parts]
    return [parse_address(address)]


# -- result payload encoding --------------------------------------------------

def shm_transport_available() -> bool:
    """True when the native arena transport can carry local-fast-path
    payloads in this process (same gate as the process pool's shm plane)."""
    from petastorm_tpu_torch.native import is_available

    return is_available()


def _ref_to_wire(ref) -> Dict[str, Any]:
    """ShmBatchRef -> wire fields (tuples become lists; inline values ride
    the control codec)."""
    return {"offset": ref.offset, "total": ref.total_bytes,
            "rows": ref.num_rows, "ordinal": ref.ordinal,
            "cols": {name: list(entry) for name, entry in ref.columns.items()}}


def _ref_from_wire(msg: Any):
    """Wire fields -> ShmBatchRef (bounds beyond these shapes are enforced
    by the arena view math in :func:`native.transport.decode_batch`)."""
    from petastorm_tpu_torch.native.transport import ShmBatchRef

    if not isinstance(msg, dict) or not isinstance(msg.get("cols"), dict):
        raise WireFormatError(f"malformed shm batch descriptor: {msg!r}")
    return ShmBatchRef(
        offset=msg.get("offset"), total_bytes=int(msg.get("total", 0)),
        num_rows=int(msg.get("rows", 0)),
        columns={name: tuple(entry)
                 for name, entry in msg["cols"].items()},
        ordinal=msg.get("ordinal"))


def _wire_safe_inline(batch: ColumnBatch) -> bool:
    """True when every column that would ride inline (object dtype, empty,
    non-array) is inside the binary wire domain - checked BEFORE an arena
    encode so a doomed descriptor never strands an allocated block."""
    import numpy as np  # deferred with the rest of the batch plane

    for col in batch.columns.values():
        if (isinstance(col, np.ndarray) and col.dtype != object
                and not col.dtype.hasobject and col.nbytes > 0):
            continue
        try:
            wire.dumps(col)
        except WireFormatError:
            return False
    return True


def encode_result(value: Any, arena=None, stop_check=None,
                  codec: str = "") -> Tuple[Dict[str, Any], List[Any]]:
    """Worker-side payload encoding -> ``(header fields, body parts)``.

    With a live ``arena`` (local fast path negotiated) ColumnBatches go
    through :func:`petastorm_tpu_torch.native.transport.encode_batch` - one
    producer-side copy into shared memory, a small ``"shm"`` descriptor on
    the wire.  Otherwise ColumnBatches travel as ``"bin"`` schema'd column
    frames (header + raw buffers, optionally ``codec``-compressed) - zero
    pickle.  Anything outside the wire domain (arbitrary worker results,
    unencodable columns) ships as the counted ``"pickle"`` fallback.
    """
    if isinstance(value, ColumnBatch):
        # the inline pre-probe runs ONLY before an arena encode (a doomed
        # descriptor would strand an allocated block); the plain binary
        # path lets encode_batch_parts run its own probe once
        if arena is not None and _wire_safe_inline(value):
            from petastorm_tpu_torch.native.transport import ShmBatchRef, \
                encode_batch

            ref = encode_batch(arena, value, stop_check=stop_check)
            if isinstance(ref, ShmBatchRef):
                return ({"pk": "shm", "arena": arena.name,
                         "ref": _ref_to_wire(ref)}, [])
            value = ref  # encode fell back (arena full): go binary
        enc = wire.encode_batch_parts(value, codec=codec)
        if enc is not None:
            header, parts = enc
            header["pk"] = "bin"
            return header, parts
    return ({"pk": "pickle"},
            [pickle.dumps(value, protocol=pickle.HIGHEST_PROTOCOL)])


class PayloadDecoder:
    """Client-side payload decoding; caches attached arenas by name so the
    local fast path attaches each worker's arena once, not per batch.

    ``allow_pickle=False`` turns ``"pickle"`` fallback payloads into
    classified :class:`WireFormatError` failures instead of unpickling
    (the hardened posture - see :func:`resolve_allow_pickle`)."""

    def __init__(self, allow_pickle: bool = True):
        self._arenas: Dict[str, Any] = {}
        self._lock = threading.Lock()
        self.allow_pickle = allow_pickle

    def decode(self, msg: Dict[str, Any]) -> Any:
        """Rebuild one result payload from its frame header (+ attached
        ``"_body"`` buffer): ``"bin"`` builds zero-copy numpy views,
        ``"shm"`` attaches the named arena and decodes the descriptor,
        ``"pickle"`` unpickles (only when allowed)."""
        pk = msg.get("pk")
        body = msg.get("_body") or b""
        if pk == "bin":
            return wire.decode_batch_body(msg, body)
        if pk == "shm":
            from petastorm_tpu_torch.native import SharedArena
            from petastorm_tpu_torch.native.transport import decode_batch

            name = msg.get("arena")
            if not isinstance(name, str):
                raise WireFormatError("shm payload without an arena name")
            with self._lock:
                arena = self._arenas.get(name)
                if arena is None:
                    arena = SharedArena.attach(name)
                    self._arenas[name] = arena
            return decode_batch(arena, _ref_from_wire(msg.get("ref")))
        if pk == "pickle":
            if not self.allow_pickle:
                raise WireFormatError(
                    "peer sent a pickle-fallback result and this client"
                    " refuses them (allow_pickle_results=False /"
                    f" ${ALLOW_PICKLE_ENV}=0); only binary/shm payloads"
                    " are accepted")
            return pickle.loads(bytes(body))
        raise WireFormatError(f"unknown payload kind {pk!r}")

    def close(self) -> None:
        """Detach every cached arena (held zero-copy views stay valid
        until collected, like the process pool's arena close)."""
        with self._lock:
            for arena in self._arenas.values():
                try:
                    arena.close()
                except Exception:  # noqa: BLE001 - teardown best-effort
                    pass
            self._arenas.clear()
