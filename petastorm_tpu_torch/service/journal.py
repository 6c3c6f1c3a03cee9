"""Dispatcher session journal: optional warm restarts that skip re-sends.

The port's copy of ``petastorm_tpu/service/journal.py:72-327``: its records
are the JAX package's byte for byte, so either package's dispatcher restarts
from the other's journal.

Dispatcher crash recovery does NOT need this file: a fresh dispatcher
reconstructs its sessions from its peers (clients re-hello with their job
blob and re-send unresolved ledger items; workers rejoin and report what
they are still executing - see :mod:`petastorm_tpu_torch.service.dispatcher`).
The journal is the *warm* variant: with ``Dispatcher(journal_path=...)``
(CLI ``--journal``) the control-plane events that define a session -
client hellos, enqueued work items, acks, purges - are appended to a
length-prefixed :mod:`petastorm_tpu_torch.service.wire` record file, and a
restarted dispatcher replays it into ready-to-serve client sessions before
it accepts a single connection.  A reconnecting client is then told (via
``hello_ok``'s ``known`` ordinal list) which of its ledger items the
dispatcher already holds, so its resync skips re-sending them - the
restart costs one reconnect handshake instead of a window's worth of
re-enqueues.

Only control-plane state is journaled.  Result *bodies* (the multi-MB
column payloads in the redelivery buffer) never touch the journal: a
journal-restored item that was delivered-but-unacked at crash time simply
re-executes, and the client's per-ordinal ledger drops the duplicate -
exactly the cold-recovery semantics, paid only for the ack-batch-sized
tail.  Requeue ``attempt`` counters restore from the *enqueued* value, so
a restart is slightly generous to items that were mid-requeue (documented,
deliberate: the budget is a safety valve, not an exactness invariant).

Durability is flush-per-record by default: a host power-loss can truncate
the tail, and :meth:`ServiceJournal.load` stops cleanly at the first
short/undecodable record (peer reconstruction covers whatever the tail
lost).  ``fsync=True`` (CLI ``--journal-fsync``) additionally fsyncs every
record - each append then pays a device round-trip (metered as
``service.journal_fsyncs``), in exchange for a tail no OS buffer can eat;
size that tradeoff against how much a hot-standby's re-fetch of a lost
tail costs (docs/operations.md "Dispatcher HA").  The file auto-compacts -
acked items are dropped and the journal rewritten - once the append log
outgrows its live state 4x.

Beyond the file, the journal doubles as the dispatcher's **live session
mirror** (``path=None`` keeps the mirror with no file at all), and
:meth:`attach_tail` exposes it as a stream: a subscriber receives a
state-reconstructing snapshot plus every subsequent logical record, in
order, regardless of file compaction (compaction rewrites bytes, never
live state - which is exactly why the tail is logical records, not file
offsets).  The hot-standby dispatcher tails this stream over the wire as
``journal_sync`` frames to keep warm (:mod:`petastorm_tpu_torch.service.
dispatcher`).  A monotonic ``epoch`` record persists the split-brain
fencing epoch across restarts.
"""

from __future__ import annotations

import collections
import logging
import os
import struct
import threading
from typing import Any, Dict, Optional

from petastorm_tpu_torch.service import wire
from petastorm_tpu_torch.service.wire import WireFormatError

logger = logging.getLogger(__name__)

_LEN = struct.Struct("!I")
#: a single journal record larger than this is a corrupt length prefix
#: (records are hellos and work-item stubs, tens of KB at most)
_MAX_RECORD = 64 << 20
#: compact when the file exceeds this AND 4x the live-state size
_COMPACT_MIN_BYTES = 4 << 20


class _Session:
    """In-memory mirror of one client's journaled state (the compaction
    source and the restart payload)."""

    __slots__ = ("hello", "items")

    def __init__(self, hello: Dict[str, Any]):
        self.hello = hello
        #: ordinal -> work-item wire fields, insertion-ordered (the replay
        #: re-enqueues in the order the client ventilated)
        self.items: "collections.OrderedDict[int, Dict]" = \
            collections.OrderedDict()


class ServiceJournal:
    """Append-only session journal for one dispatcher (see module doc).

    Lifecycle: ``load()`` parses any existing file into session dicts (the
    dispatcher turns them into client states), then ``open()`` compacts and
    starts appending.  All methods are thread-safe; appends flush so an
    ordinary process death (the recovery scenario) loses nothing.
    """

    def __init__(self, path: Optional[str], *, fsync: bool = False,
                 fsync_counter=None):
        #: ``path=None`` is a pure in-memory mirror: ``load``/``open`` are
        #: no-ops and appends only update live state (what a journal-less
        #: dispatcher feeds its hot standby from, and what a standby
        #: accumulates before promotion).
        self._path = path
        self._fsync = bool(fsync)
        self._fsync_counter = fsync_counter
        self.fsyncs = 0
        self._lock = threading.Lock()
        self._fh = None
        self._bytes = 0
        self._sessions: Dict[str, _Session] = {}
        #: count of logical records applied (monotonic; tail stream position)
        self.seq = 0
        #: split-brain fencing epoch, 0 until a dispatcher stamps one
        self.epoch = 0
        self._tails = []

    # -- restart side ----------------------------------------------------------

    def load(self) -> Dict[str, _Session]:
        """Parse the journal (tolerating a truncated tail) into sessions;
        returns ``{client_id: _Session}``.  Call before :meth:`open`."""
        if self._path is None or not os.path.exists(self._path):
            return {}
        records = 0
        with open(self._path, "rb") as fh:
            while True:
                hdr = fh.read(_LEN.size)
                if len(hdr) < _LEN.size:
                    break
                (length,) = _LEN.unpack(hdr)
                if length > _MAX_RECORD:
                    logger.warning("journal %s: corrupt record length %d;"
                                   " stopping replay here", self._path, length)
                    break
                body = fh.read(length)
                if len(body) < length:
                    break  # crash-truncated tail: expected, not an error
                try:
                    rec = wire.loads(body)
                except WireFormatError:
                    logger.warning("journal %s: undecodable record after %d"
                                   " good one(s); stopping replay here",
                                   self._path, records)
                    break
                if isinstance(rec, dict):
                    self._apply(rec)
                    records += 1
        logger.info("journal %s: replayed %d record(s) into %d session(s),"
                    " %d unresolved item(s)", self._path, records,
                    len(self._sessions),
                    sum(len(s.items) for s in self._sessions.values()))
        return dict(self._sessions)

    def _apply(self, rec: Dict[str, Any]) -> None:
        kind, cid = rec.get("r"), rec.get("client")
        if kind == "epoch":
            value = rec.get("epoch")
            if isinstance(value, int) and value > self.epoch:
                self.epoch = value
            return
        if not isinstance(cid, str):
            return
        if kind == "hello":
            session = self._sessions.get(cid)
            if session is None:
                self._sessions[cid] = _Session(rec)
            else:
                session.hello = rec  # reconnects refresh the job blob
        elif kind == "enq":
            session = self._sessions.get(cid)
            item = rec.get("item")
            if session is not None and isinstance(item, dict) \
                    and isinstance(item.get("o"), int):
                self._sessions[cid].items[item["o"]] = item
        elif kind == "ack":
            session = self._sessions.get(cid)
            if session is not None:
                for ordinal in rec.get("ordinals") or ():
                    session.items.pop(ordinal, None)
        elif kind == "purge":
            self._sessions.pop(cid, None)

    # -- append side -----------------------------------------------------------

    def open(self) -> "ServiceJournal":
        """Compact-rewrite the loaded state and start appending (no-op for
        an in-memory mirror)."""
        with self._lock:
            if self._path is not None:
                self._rewrite_locked()
        return self

    def append_hello(self, cid: str, hello: Dict[str, Any]) -> None:
        self._append(dict(hello, r="hello", client=cid))

    def append_enqueue(self, cid: str, item: Dict[str, Any]) -> None:
        self._append({"r": "enq", "client": cid, "item": item})

    def append_ack(self, cid: str, ordinals) -> None:
        self._append({"r": "ack", "client": cid, "ordinals": list(ordinals)})

    def append_purge(self, cid: str) -> None:
        self._append({"r": "purge", "client": cid})

    def set_epoch(self, epoch: int) -> None:
        """Stamp (and persist, if file-backed) the fencing epoch."""
        self._append({"r": "epoch", "epoch": int(epoch)})

    def ingest(self, rec) -> None:
        """Apply one record received over the wire (standby sync path)."""
        if isinstance(rec, dict):
            self._append(rec)

    def _append(self, rec: Dict[str, Any]) -> None:
        encoded = None
        if self._fh is not None:
            try:
                encoded = wire.dumps(rec)
            except WireFormatError:
                # a hello with out-of-domain extras must not kill the
                # control plane; the session just won't warm-restart
                logger.warning("journal: unencodable record dropped (%r)",
                               rec.get("r"))
                return
        with self._lock:
            self._apply(rec)
            self.seq += 1
            if self._fh is not None:
                if encoded is None:
                    try:
                        encoded = wire.dumps(rec)
                    except WireFormatError:
                        encoded = None
                if encoded is not None:
                    self._fh.write(_LEN.pack(len(encoded)) + encoded)
                    self._fh.flush()
                    if self._fsync:
                        os.fsync(self._fh.fileno())
                        self.fsyncs += 1
                        if self._fsync_counter is not None:
                            self._fsync_counter.add(1)
                    self._bytes += _LEN.size + len(encoded)
                    if self._bytes > _COMPACT_MIN_BYTES \
                            and self._bytes > 4 * self._live_bytes_locked():
                        self._rewrite_locked()
            for fn in list(self._tails):
                try:
                    fn(self.seq, rec)
                except Exception:  # noqa: BLE001 - a broken tail must not
                    self._tails.remove(fn)  # stall the control plane

    # -- streaming tail (hot-standby sync) -------------------------------------

    def attach_tail(self, fn):
        """Subscribe ``fn(seq, rec)`` to every subsequent logical record.

        Returns ``(snapshot_records, seq)``: replaying the snapshot then the
        streamed records reconstructs this journal's live state exactly.
        ``fn`` runs under the journal lock and must never block (push to a
        bounded queue; a raising tail is detached).
        """
        with self._lock:
            records = self._snapshot_records_locked()
            self._tails.append(fn)
            return records, self.seq

    def detach_tail(self, fn) -> None:
        with self._lock:
            try:
                self._tails.remove(fn)
            except ValueError:
                pass

    def _snapshot_records_locked(self):
        records = []
        if self.epoch:
            records.append({"r": "epoch", "epoch": self.epoch})
        for cid, session in self._sessions.items():
            records.append(session.hello)
            records.extend({"r": "enq", "client": cid, "item": item}
                           for item in session.items.values())
        return records

    def sessions(self) -> Dict[str, _Session]:
        with self._lock:
            return dict(self._sessions)

    def reset(self) -> None:
        """Drop all mirrored state (a standby starting a fresh re-sync)."""
        with self._lock:
            self._sessions.clear()
            self.epoch = 0

    def _live_bytes_locked(self) -> int:
        total = 0
        for session in self._sessions.values():
            total += len(session.hello.get("factory") or b"") + 256
            for item in session.items.values():
                total += len(item.get("blob") or b"") + 64
        return total

    def _rewrite_locked(self) -> None:
        """Rewrite the file from the live mirror (compaction + open)."""
        if self._fh is not None:
            self._fh.close()
        tmp = self._path + ".tmp"
        with open(tmp, "wb") as fh:
            size = 0
            for rec in self._snapshot_records_locked():
                try:
                    encoded = wire.dumps(rec)
                except WireFormatError:
                    logger.warning("journal: unencodable record dropped in"
                                   " rewrite (%r)", rec.get("r"))
                    continue
                fh.write(_LEN.pack(len(encoded)) + encoded)
                size += _LEN.size + len(encoded)
            if self._fsync:
                fh.flush()
                os.fsync(fh.fileno())
        os.replace(tmp, self._path)
        self._fh = open(self._path, "ab")
        self._bytes = size

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
