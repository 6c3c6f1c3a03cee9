"""Deterministic network-fault injection at the FrameSocket boundary.

The port's copy of ``petastorm_tpu/test_util/netchaos.py:43-332``: the same
seed gives the same fault schedule.

The service plane's failure story (reconnect-with-resync, requeue, replay,
ledger dedup - :mod:`petastorm_tpu_torch.service`) is only real if it survives
the network failing in *network* ways: connections cut mid-frame, whole
frames lost with a dying connection, frames delayed past timeouts, frames
duplicated by a replaying middlebox, and full partitions that later heal.
This module injects exactly those, ``test_util.chaos`` style - decisions
are pure functions of ``(seed, fault kind, frame index)``, so a chaos run
is reproducible and its assertions exact, not statistical.

The injection point is a **frame-aware TCP proxy** (:class:`ChaosProxy`):
it parses the 4-byte length prefix of the service's wire frames (and
nothing else - payloads stay opaque), so it can cut a connection halfway
through a frame body (the receiver dies mid-``recv_into``; the sender may
die mid-``sendall``), drop a complete frame *and then* cut (TCP cannot
lose bytes on a live connection - a lost frame IS a lost connection, which
is precisely the case the client ledger + resync recover), duplicate a
complete frame (framing-valid; the per-ordinal ledgers must dedup), or
hold a frame for ``delay_s`` (timeout/heartbeat pressure).  A proxy-level
:meth:`ChaosProxy.partition` cuts every live pipe and refuses new ones
until :meth:`ChaosProxy.heal` - the partition-heal cell of the
determinism matrix.

Frame indices count per (proxy, direction) across all connections, so a
spec like ``cut_frames=(9,)`` means "the 10th client-bound frame through
this proxy dies mid-body" regardless of how reconnects re-shuffle
connections.  With concurrent connections the index a given frame gets is
scheduling-dependent; the *matrix* invariant does not care (every cell
must deliver the bit-identical stream no matter where the faults land),
and single-connection tests get exact placement.

Usage::

    proxy = ChaosProxy(("127.0.0.1", dispatcher.port),
                       NetChaosSpec(dup_rate=0.2, delay_rate=0.2,
                                    cut_frames=(9,))).start()
    make_reader(url, service_address=proxy.address, ...)
"""

from __future__ import annotations

import dataclasses
import logging
import socket
import struct
import threading
import time
import zlib
from typing import Optional, Tuple

from petastorm_tpu_torch.errors import PetastormTpuError

logger = logging.getLogger(__name__)

_LEN = struct.Struct("!I")
#: directions a spec clause may target
DIRECTIONS = ("both", "c2s", "s2c")


@dataclasses.dataclass(frozen=True)
class NetChaosSpec:
    """Declarative, seeded network-fault plan for one :class:`ChaosProxy`.

    Rates are deterministic per ``(seed, kind, frame index)``; explicit
    ``*_frames`` tuples pick exact frames for precise tests.  ``direction``
    limits every clause to client->server (``'c2s'``), server->client
    (``'s2c'``) or ``'both'`` (default).
    """

    seed: int = 0
    #: cut the connection midway through this frame's body (receiver dies
    #: inside recv_into, sender may die inside its vectored send)
    cut_frames: Tuple[int, ...] = ()
    cut_rate: float = 0.0
    #: drop the whole frame, then cut (a send lost with its connection -
    #: the resync/replay recovery target)
    drop_frames: Tuple[int, ...] = ()
    drop_rate: float = 0.0
    #: forward the frame twice (framing-valid; ledgers must dedup)
    dup_frames: Tuple[int, ...] = ()
    dup_rate: float = 0.0
    #: hold the frame for delay_s before forwarding
    delay_frames: Tuple[int, ...] = ()
    delay_rate: float = 0.0
    delay_s: float = 0.05
    direction: str = "both"

    def __post_init__(self):
        if self.direction not in DIRECTIONS:
            raise PetastormTpuError(
                f"NetChaosSpec.direction must be one of {DIRECTIONS}")
        for name in ("cut_rate", "drop_rate", "dup_rate", "delay_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise PetastormTpuError(
                    f"NetChaosSpec.{name} must be in [0, 1]")
        for name in ("cut_frames", "drop_frames", "dup_frames",
                     "delay_frames"):
            v = getattr(self, name)
            if isinstance(v, int):
                object.__setattr__(self, name, (v,))
            elif not isinstance(v, tuple):
                object.__setattr__(self, name, tuple(v))

    def _roll(self, kind: str, index: int, rate: float) -> bool:
        if rate <= 0.0:
            return False
        h = zlib.crc32(f"{self.seed}:{kind}:{index}".encode())
        return h / 0xFFFFFFFF < rate

    def _applies(self, direction: str) -> bool:
        return self.direction in ("both", direction)

    def decide(self, direction: str, index: int) -> str:
        """The fault for one ``(direction, frame index)``: ``'cut'`` |
        ``'drop'`` | ``'dup'`` | ``'delay'`` | ``'none'`` (first match
        wins, in that severity order)."""
        if not self._applies(direction):
            return "none"
        if index in self.cut_frames or self._roll("cut", index,
                                                  self.cut_rate):
            return "cut"
        if index in self.drop_frames or self._roll("drop", index,
                                                   self.drop_rate):
            return "drop"
        if index in self.dup_frames or self._roll("dup", index,
                                                  self.dup_rate):
            return "dup"
        if index in self.delay_frames or self._roll("delay", index,
                                                    self.delay_rate):
            return "delay"
        return "none"


class _Pipe:
    """One proxied connection: a client socket + its upstream socket and
    the two pump threads between them."""

    def __init__(self, down: socket.socket, up: socket.socket):
        self.down = down
        self.up = up
        self.closed = False
        self._lock = threading.Lock()

    def cut(self) -> None:
        with self._lock:
            if self.closed:
                return
            self.closed = True
        for sock in (self.down, self.up):
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass


class ChaosProxy:
    """Frame-aware chaos TCP proxy in front of a service endpoint (module
    docstring).  ``stats`` counts what actually fired, per direction -
    tests assert the chaos HAPPENED, not just that nothing broke."""

    def __init__(self, target, spec: Optional[NetChaosSpec] = None,
                 host: str = "127.0.0.1"):
        from petastorm_tpu_torch.service.protocol import parse_address

        self._target = parse_address(target)
        self._spec = spec or NetChaosSpec()
        self._host = host
        self._listener: Optional[socket.socket] = None
        self._stop = threading.Event()
        self._partitioned = threading.Event()
        self._pipes: list = []
        self._pipes_lock = threading.Lock()
        self._seq = {"c2s": 0, "s2c": 0}
        self._seq_lock = threading.Lock()
        self.port: Optional[int] = None
        self.stats = {"frames": 0, "cuts": 0, "drops": 0, "dups": 0,
                      "delays": 0, "connections": 0,
                      "partition_refusals": 0}

    @property
    def address(self) -> str:
        return f"{self._host}:{self.port}"

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "ChaosProxy":
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind((self._host, 0))
        listener.listen(32)
        listener.settimeout(0.2)
        self._listener = listener
        self.port = listener.getsockname()[1]
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="petastorm-torch-chaos-proxy").start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        with self._pipes_lock:
            pipes = list(self._pipes)
        for pipe in pipes:
            pipe.cut()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    # -- partition / heal ------------------------------------------------------

    def partition(self) -> None:
        """Full partition: cut every live pipe and refuse new connections
        until :meth:`heal` (accepted sockets are closed immediately, so
        peers see a connect-then-EOF - the half-dead-network shape their
        reconnect loops must absorb)."""
        self._partitioned.set()
        with self._pipes_lock:
            pipes = list(self._pipes)
        for pipe in pipes:
            pipe.cut()
        logger.info("chaos proxy: PARTITIONED (%d pipe(s) cut)", len(pipes))

    def heal(self) -> None:
        self._partitioned.clear()
        logger.info("chaos proxy: healed")

    # -- pumping ---------------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                down, _addr = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            if self._partitioned.is_set():
                self.stats["partition_refusals"] += 1
                try:
                    down.close()
                except OSError:
                    pass
                continue
            try:
                up = socket.create_connection(self._target, timeout=5.0)
            except OSError:
                try:
                    down.close()
                except OSError:
                    pass
                continue
            pipe = _Pipe(down, up)
            with self._pipes_lock:
                self._pipes = [p for p in self._pipes if not p.closed]
                self._pipes.append(pipe)
            self.stats["connections"] += 1
            for src, dst, direction in ((down, up, "c2s"),
                                        (up, down, "s2c")):
                threading.Thread(target=self._pump, daemon=True,
                                 args=(pipe, src, dst, direction),
                                 name=f"petastorm-torch-chaos-{direction}"
                                 ).start()

    def _recv_exact(self, sock: socket.socket, n: int) -> Optional[bytes]:
        buf = bytearray()
        while len(buf) < n:
            try:
                chunk = sock.recv(n - len(buf))
            except OSError:
                return None
            if not chunk:
                return None
            buf += chunk
        return bytes(buf)

    def _pump(self, pipe: _Pipe, src: socket.socket, dst: socket.socket,
              direction: str) -> None:
        try:
            while not self._stop.is_set() and not pipe.closed:
                hdr = self._recv_exact(src, _LEN.size)
                if hdr is None:
                    break
                (length,) = _LEN.unpack(hdr)
                payload = self._recv_exact(src, length)
                if payload is None:
                    break
                with self._seq_lock:
                    index = self._seq[direction]
                    self._seq[direction] += 1
                self.stats["frames"] += 1
                fault = self._spec.decide(direction, index)
                if fault == "cut":
                    # forward the prefix so the receiver dies MID-BODY,
                    # then kill the pair
                    self.stats["cuts"] += 1
                    try:
                        dst.sendall(hdr + payload[:max(1, length // 2)])
                    except OSError:
                        pass
                    pipe.cut()
                    return
                if fault == "drop":
                    # a frame lost WITH its connection (TCP cannot lose
                    # bytes on a live stream)
                    self.stats["drops"] += 1
                    pipe.cut()
                    return
                if fault == "delay":
                    self.stats["delays"] += 1
                    time.sleep(self._spec.delay_s)
                try:
                    dst.sendall(hdr + payload)
                    if fault == "dup":
                        self.stats["dups"] += 1
                        dst.sendall(hdr + payload)
                except OSError:
                    break
        finally:
            pipe.cut()
