"""Remote ingest worker: runs client worker-factories against dispatched items.

The port's copy of ``petastorm_tpu/service/worker.py:73-832``.  It imports
no ``torch``: a worker process loads the port's host modules only, as the
process pool's spawned workers do.  A worker function gets the bare work
item unless it sets ``takes_ventilated_items`` (the port's pool contract,
``pool._call``).

One ``ServiceWorker`` process serves every client of its dispatcher: for
each client it unpickles the client's worker factory (the exact
``pool.WorkerFactory`` the in-process executors would have started -
normally a :class:`~petastorm_tpu_torch.worker.RowGroupDecoderWorker`, possibly
chaos-wrapped) and runs ``fn(VentilatedItem) -> ColumnBatch`` over its
assigned items on ``capacity`` processor threads (pyarrow IO and native
decode release the GIL, same reasoning as the in-process thread pool).

Decode-once sharing: a factory carrying ``cache_type='shared'`` attaches
this host's warm tier on unpickle, so co-located workers (and repeated
epochs, and other clients' jobs with matching cache keys) decode each
rowgroup once fleet-wide - the tier IS the cross-worker data plane
(docs/operations.md "Warm cache").

Heartbeats carry the worker's busy count plus telemetry counter deltas
(``decode.*`` / ``worker.*`` / ``cache.*``), which the dispatcher folds
into its registry as ``service.fleet.*`` - the fleet-wide observable proof
that each rowgroup decoded at most once.

Crash semantics match the process pool: an exception whose
``petastorm_tpu_simulated_crash`` attribute is set (the chaos harness's
hard-kill injection) exits the process with ``os._exit`` - no result, no
goodbye - and the dispatcher's death detection requeues the in-flight
items onto surviving workers.

Dispatcher-restart survival (``reconnect_attempts > 0``): losing the
dispatcher connection does NOT drop this worker's state.  The processor
threads keep executing their in-flight items through the outage; finished
outcomes buffer in a bounded outbox; and the rejoin hello reports the
still-held assignments plus the client jobs this process already holds -
the restarted dispatcher records them as claims so a reconnecting client's
resync re-attaches those ordinals here instead of double-assigning them,
then the outbox flushes (docs/operations.md "Fault domains").  An outcome
the outbox must shed (overflow) simply forgets its assignment: the
client's resync re-enqueues that item and it re-executes - correctness by
re-fetch, never by unbounded buffering.
"""

from __future__ import annotations

import collections
import logging
import os
import pickle
import queue
import socket
import threading
import time
from typing import Any, Dict, Optional, Tuple

from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.pool import VentilatedItem, _call, _Failure
from petastorm_tpu_torch.service.protocol import (PROTOCOL_VERSION,
                                            FrameClosedError, FrameSocket,
                                            connect_frames, encode_result,
                                            parse_address_list,
                                            resolve_auth_token,
                                            shm_transport_available)
from petastorm_tpu_torch.service.wire import SUPPORTED_CODECS, WireFormatError
from petastorm_tpu_torch.telemetry import Telemetry
from petastorm_tpu_torch.telemetry import resolve as _resolve_telemetry

logger = logging.getLogger(__name__)

#: outbox bounds while disconnected: results past these are shed oldest-
#: first (their assignments are forgotten, so clients re-fetch them)
OUTBOX_MAX_ITEMS = 512
OUTBOX_MAX_BYTES = 256 << 20


def _inject_telemetry(factory: Any, telemetry) -> None:
    """Point a (possibly wrapped) worker factory at this process's recorder.

    ``RowGroupDecoderWorker`` resolves its recorder lazily in ``__call__``
    when ``_telemetry`` is None (the pickled state always is - see its
    ``__getstate__``); chaos wrappers hold the real factory in ``_inner``.
    Best-effort by design: an opaque factory just runs unrecorded.
    """
    seen = set()
    while factory is not None and id(factory) not in seen:
        seen.add(id(factory))
        if hasattr(factory, "_telemetry"):
            factory._telemetry = telemetry  # noqa: SLF001 - documented hook
        factory = getattr(factory, "_inner", None) or getattr(
            factory, "_worker_factory", None)


class ServiceWorker:
    """One remote worker process/thread of the ingest-service fleet.

    ``capacity``: concurrent items this worker accepts (the dispatcher
    assigns at most this many in flight); each runs on its own processor
    thread.  ``shm_size_bytes`` > 0 arms the local fast path: results for
    co-located clients are encoded into a named shared-memory arena
    (descriptor on the wire, zero-copy decode client-side) when the native
    transport plane is available - remote clients always get plain frame
    payloads.  ``reconnect_attempts`` > 0 makes a lost dispatcher
    connection a recoverable event instead of a worker exit: in-flight
    work keeps executing, registration retries every
    ``reconnect_backoff_s``, and the rejoin reports held assignments/jobs
    (module docstring).

    ``address`` may be a comma-separated failover list
    (``'primary:port,standby:port'``): registration rotates through it,
    so when a hot-standby dispatcher promotes, the same retry loop lands
    on the survivor with the worker's held state intact.  Epoch fencing
    rides the same handshake: every ``hello_ok``/``hb_ok`` carries the
    dispatcher's fencing epoch, and a dispatcher advertising an epoch
    *below* the highest this worker has seen is a deposed primary - its
    registration is refused (``service.stale_epoch_refusals``) and the
    rotation moves on, so a partitioned ex-primary can never hand this
    worker work its successor also assigned.
    """

    def __init__(self, address, capacity: int = 2, name: Optional[str] = None,
                 telemetry=None, heartbeat_interval_s: float = 2.0,
                 shm_size_bytes: int = 0, auth_token: Optional[str] = None,
                 reconnect_attempts: int = 0,
                 reconnect_backoff_s: float = 1.0):
        if capacity < 1:
            raise PetastormTpuError("ServiceWorker capacity must be >= 1")
        self._addresses = parse_address_list(address)
        self._addr_index = 0
        self._address = self._addresses[0]
        #: highest fencing epoch any dispatcher has advertised to us; a
        #: hello_ok below this is a deposed primary and is refused
        self._dispatcher_epoch = 0
        #: handshake secret (default $PETASTORM_TPU_SERVICE_TOKEN); must
        #: match the dispatcher's when it enforces one
        self._auth_token = resolve_auth_token(auth_token)
        self._capacity = int(capacity)
        self._name = name
        #: a private recorder by default: heartbeat counter deltas must not
        #: entangle with (or pollute) any client telemetry in this process
        self.telemetry = (_resolve_telemetry(telemetry)
                          if telemetry is not None else Telemetry())
        self._hb_interval = float(heartbeat_interval_s)
        self._shm_size_bytes = int(shm_size_bytes)
        self._arena = None
        self._stop_event = threading.Event()
        self._reconnect_attempts = int(reconnect_attempts)
        self._reconnect_backoff_s = float(reconnect_backoff_s)
        self._conn: Optional[FrameSocket] = None
        self._conn_lock = threading.Lock()
        self._connected = threading.Event()
        self._work: "queue.Queue[tuple]" = queue.Queue()
        self._busy = 0
        self._busy_lock = threading.Lock()
        self._jobs: Dict[str, Dict] = {}   # cid -> {"factory": blob, "shm_ok"}
        self._fns: Dict[str, Any] = {}     # cid -> built fn
        self._fn_lock = threading.Lock()
        #: (cid, ordinal) -> attempt for every item this worker holds -
        #: queued or executing - until its outcome reaches a LIVE
        #: connection.  Reported on rejoin so nothing is double-assigned.
        self._held: Dict[Tuple[str, int], int] = {}
        self._held_lock = threading.Lock()
        #: outcomes finished while disconnected: (kind, header, parts, key)
        self._outbox: "collections.deque" = collections.deque()
        self._outbox_bytes = 0
        self._hb_snapshot: Dict[str, float] = {}
        #: estimated offset of the dispatcher's perf_counter_ns clock from
        #: ours (handshake round-trip midpoint; error ~ RTT/2).  Rides every
        #: trace hop stamp we emit so the client can map our stamps into
        #: its own clock domain through the dispatcher's.
        self._clock_offset_ns = 0
        #: structured events to piggyback on the next heartbeat (folded
        #: into the dispatcher's bounded fleet event log under our name)
        self._pending_events: "collections.deque" = collections.deque(
            maxlen=32)
        self._threads = []
        self._threads_started = False
        self.worker_name: Optional[str] = None
        self.items_processed = 0
        self.dispatcher_reconnects = 0
        #: graceful retirement state (begin_retire/retire): the heartbeat
        #: thread drives the drain so arming it is signal-safe
        self._retiring = threading.Event()
        self._retire_acked = threading.Event()
        self._retire_sent = False
        #: dispatcher confirmed (drain_ok) that nothing is in flight
        #: toward us - the structural half of the drain handshake
        self._drain_confirmed = threading.Event()
        self.retired_gracefully = False

    # -- lifecycle ------------------------------------------------------------

    def stop(self) -> None:
        """Stop serving: close the dispatcher connection (in-flight items
        are requeued onto surviving workers by the dispatcher)."""
        self._stop_event.set()
        self._connected.clear()
        conn = self._conn
        if conn is not None:
            conn.close()

    def begin_retire(self) -> None:
        """Arm **graceful retirement** (idempotent, signal-safe: only sets
        a flag).  The heartbeat thread then runs the drain protocol: send
        ``retiring`` (the dispatcher stops assigning to us and acks with
        ``retire_ok``), finish every held item, flush the outbox, say
        ``bye``, and exit - nothing is dropped or requeued, so
        ``deterministic='seed'`` streams ride a scale-down untouched.
        A retirement that cannot finish (dispatcher gone for good) is
        force-resolved by the caller's timeout (:meth:`retire`) - the
        dispatcher's death detection requeues whatever was left."""
        self._retiring.set()

    def retire(self, timeout: Optional[float] = None) -> bool:
        """Blocking graceful retirement: arm the drain and wait up to
        ``timeout`` (None = forever) for it to complete.  Returns True when
        the worker drained and said goodbye; False on timeout (the caller
        decides whether to :meth:`stop` it hard)."""
        self.begin_retire()
        self._stop_event.wait(timeout)
        return self.retired_gracefully

    def run(self) -> int:
        """Connect, register, and serve until the dispatcher goes away
        (for longer than the reconnect budget) or :meth:`stop` is called.
        Returns an exit code (0 = clean, 1 = never registered)."""
        attempts_left = self._reconnect_attempts
        registered_once = False
        try:
            while not self._stop_event.is_set():
                conn = None
                addr = self._addresses[self._addr_index
                                       % len(self._addresses)]
                self._address = addr
                try:
                    conn = connect_frames(addr)
                    self._register(conn)
                except (OSError, PetastormTpuError) as exc:
                    # covers unreachable/refused dispatchers AND a
                    # dispatcher mid-restart that accepts then resets
                    # inside the hello; a standby refuses worker hellos
                    # until promoted, which lands here too - the rotation
                    # below walks the failover list until the live
                    # (highest-epoch) dispatcher answers
                    if conn is not None:
                        conn.close()
                    self._addr_index += 1
                    if attempts_left <= 0:
                        if registered_once:
                            logger.warning(
                                "Dispatcher gone and the reconnect budget"
                                " is spent; worker exiting (%s)", exc)
                            return 0
                        logger.error("Cannot register with dispatcher at"
                                     " %s:%d: %s", addr[0], addr[1], exc)
                        return 1
                    attempts_left -= 1
                    # a multi-address fleet retries the next address
                    # immediately (the whole point of a hot standby is
                    # failing over in heartbeat time, not backoff time);
                    # only a full rotation with no winner backs off
                    if len(self._addresses) == 1 \
                            or self._addr_index % len(self._addresses) == 0:
                        logger.info("Dispatcher unavailable (%s); retrying"
                                    " registration in %.1fs (%d attempt(s)"
                                    " left)", exc, self._reconnect_backoff_s,
                                    attempts_left + 1)
                        self._stop_event.wait(self._reconnect_backoff_s)
                    continue
                if registered_once:
                    self.dispatcher_reconnects += 1
                registered_once = True
                attempts_left = self._reconnect_attempts  # reset on success
                self._start_threads()
                self._attach(conn)
                self._serve(conn)
                with self._conn_lock:
                    self._connected.clear()
                conn.close()
                if self._stop_event.is_set() or attempts_left <= 0:
                    break
        finally:
            self.stop()
            if self._arena is not None:
                self._arena.close()
        return 0 if registered_once else 1

    def _register(self, conn: FrameSocket) -> None:
        """One registration handshake; raises OSError/PetastormTpuError on
        refusal.  A re-registration (rejoin) reports held assignments and
        jobs so the dispatcher can re-attach instead of double-assigning."""
        with self._held_lock:
            assignments = [[cid, ordinal, attempt]
                           for (cid, ordinal), attempt in self._held.items()]
        with self._fn_lock:
            jobs = list(self._jobs)
        resume = self.worker_name is not None
        t0 = time.perf_counter_ns()
        conn.send({"t": "worker_hello", "protocol": PROTOCOL_VERSION,
                   "worker": self._name or self.worker_name,
                   "capacity": self._capacity,
                   "hostname": socket.gethostname(), "pid": os.getpid(),
                   "codecs": list(SUPPORTED_CODECS),
                   "token": self._auth_token,
                   "resume": resume,
                   "assignments": assignments, "jobs": jobs})
        hello = conn.recv(timeout=10.0)
        t1 = time.perf_counter_ns()
        if not hello or hello.get("t") != "hello_ok":
            raise PetastormTpuError(
                f"dispatcher refused registration: {hello!r}")
        epoch = hello.get("epoch")
        if isinstance(epoch, int):
            if epoch < self._dispatcher_epoch:
                # split-brain fencing: this is a deposed primary (its
                # epoch predates one we already worked under) - refuse
                # it and let the rotation find the promoted standby
                self.telemetry.counter(
                    "service.stale_epoch_refusals").add(1)
                raise PetastormTpuError(
                    f"dispatcher at {self._address[0]}:{self._address[1]}"
                    f" advertises stale epoch {epoch} <"
                    f" {self._dispatcher_epoch}: refusing a deposed"
                    " primary")
            self._dispatcher_epoch = epoch
        clock_ns = hello.get("clock_ns")
        if isinstance(clock_ns, int):
            # offset estimate: the dispatcher stamped clock_ns somewhere
            # inside our [t0, t1] round-trip; the midpoint bounds the
            # error at RTT/2 (per-hop histogram deltas never use this -
            # only the merged cross-process trace timeline does)
            self._clock_offset_ns = clock_ns - (t0 + t1) // 2
        self.worker_name = hello.get("worker")
        if resume:
            self._pending_events.append(
                {"kind": "worker_rejoin",
                 "held_items": len(assignments),
                 "buffered_outcomes": len(self._outbox)})
            logger.info("Rejoined dispatcher as %s (still holding %d"
                        " item(s), %d buffered outcome(s))",
                        self.worker_name, len(assignments),
                        len(self._outbox))
        else:
            logger.info("Registered with dispatcher as %s (capacity %d)",
                        self.worker_name, self._capacity)

    def _start_threads(self) -> None:
        if self._threads_started:
            return
        self._threads_started = True
        for i in range(self._capacity):
            t = threading.Thread(target=self._processor_loop, daemon=True,
                                 name=f"petastorm-torch-service-proc-{i}")
            t.start()
            self._threads.append(t)
        hb = threading.Thread(target=self._heartbeat_loop, daemon=True,
                              name="petastorm-torch-service-heartbeat")
        hb.start()
        self._threads.append(hb)

    def _attach(self, conn: FrameSocket) -> None:
        """Swap the live connection in and flush buffered outcomes."""
        with self._conn_lock:
            self._conn = conn
            self._connected.set()
        # a retirement armed across a reconnect must re-announce itself to
        # the (possibly restarted) dispatcher before the drain can finish
        self._retire_sent = False
        self._retire_acked.clear()
        self._drain_confirmed.clear()
        self._flush_outbox()

    def _serve(self, conn: FrameSocket) -> None:
        """The dispatcher read loop for one connection; returns when it is
        lost (the run loop decides between reconnect and exit)."""
        try:
            while not self._stop_event.is_set():
                msg = conn.recv(timeout=1.0)
                if msg is None:
                    continue
                kind = msg.get("t")
                if kind == "job":
                    with self._fn_lock:
                        self._jobs[msg["client"]] = {
                            "factory": msg["factory"],
                            "shm_ok": bool(msg.get("shm_ok")),
                            # negotiated BATCH-body compression for this
                            # (worker, client) pair ('' = off)
                            "codec": msg.get("codec") or ""}
                elif kind == "work":
                    # the item blob is the trusted client->worker job plane:
                    # this is the ONE place (beyond the factory bootstrap)
                    # service bytes are unpickled, and only for items the
                    # auth-gated dispatcher assigned to us
                    wi = msg["item"]
                    item = VentilatedItem(wi["o"], pickle.loads(wi["blob"]),
                                          wi.get("a", 0))
                    cid = msg["client"]
                    tc = wi.get("tc")
                    if isinstance(tc, dict):
                        # traced item: stamp its arrival (the worker-queue
                        # hop opens here); our clock offset rides each
                        # stamp so the client can remap it
                        tc.setdefault("hops", []).append(
                            [self.worker_name or "w?", "recv",
                             item.attempt, time.perf_counter_ns(),
                             self._clock_offset_ns])
                    else:
                        tc = None
                    with self._held_lock:
                        self._held[(cid, item.ordinal)] = item.attempt
                    self._work.put((cid, item, tc))
                elif kind == "job_done":
                    with self._fn_lock:
                        self._jobs.pop(msg["client"], None)
                        self._fns.pop(msg["client"], None)
                elif kind == "retire_ok":
                    # the dispatcher marked us draining (no new work will
                    # be assigned); the heartbeat thread completes the
                    # drain once everything held has been delivered
                    self._retire_acked.set()
                elif kind == "hb_ok":
                    epoch = msg.get("epoch")
                    if isinstance(epoch, int) \
                            and epoch > self._dispatcher_epoch:
                        self._dispatcher_epoch = epoch
                elif kind == "drain_ok":
                    # dispatcher-confirmed: nothing is in flight toward
                    # us (recorded-before-send on its side makes this
                    # structural, not a timing window)
                    self._drain_confirmed.set()
                elif kind == "drain_wait":
                    self._drain_confirmed.clear()
                elif kind == "stop":
                    self._stop_event.set()
                    break
        except FrameClosedError:
            if not self._stop_event.is_set():
                logger.warning("Dispatcher connection closed")
        except WireFormatError:
            if not self._stop_event.is_set():
                logger.warning("Dispatcher sent an undecodable frame;"
                               " dropping the connection", exc_info=True)

    # -- processing -----------------------------------------------------------

    def _fn_for(self, cid: str):
        """The built worker function for one client (built once, under a
        lock: factories open datasets lazily so the build is cheap, but two
        processor threads must not race it).

        A work frame can arrive moments BEFORE its client's job frame: two
        dispatcher threads pumping the same worker send job+work1 and work2
        concurrently, and only bytes - not cross-thread order - are
        serialized.  The job frame is guaranteed in flight (the dispatcher
        marks the pair before sending any work for it), so wait briefly
        for it instead of failing the item; the wait loop releases the lock
        so the read loop can register the arriving job."""
        deadline = time.monotonic() + 5.0
        while True:
            with self._fn_lock:
                fn = self._fns.get(cid)
                if fn is not None:
                    return fn
                job = self._jobs.get(cid)
                if job is not None:
                    factory = pickle.loads(job["factory"])
                    _inject_telemetry(factory, self.telemetry)
                    fn = factory()
                    self._fns[cid] = fn
                    return fn
            if time.monotonic() > deadline or self._stop_event.is_set():
                raise PetastormTpuError(
                    f"work for unknown client {cid!r} (no job spec received"
                    " within 5s)")
            time.sleep(0.01)

    def _arena_for(self, cid: str):
        """The shm arena for local-fast-path encoding, or None (remote
        client, shm disabled, or the native plane is unavailable)."""
        if self._shm_size_bytes <= 0 or not shm_transport_available():
            return None
        with self._fn_lock:
            job = self._jobs.get(cid)
            if job is None or not job["shm_ok"]:
                return None
            if self._arena is None:
                from petastorm_tpu_torch.native import SharedArena

                self._arena = SharedArena.create(self._shm_size_bytes)
            return self._arena

    def _codec_for(self, cid: str) -> str:
        """The negotiated BATCH-body codec for one client ('' = off)."""
        with self._fn_lock:
            job = self._jobs.get(cid)
            return job["codec"] if job else ""

    def _trace_stamp(self, tc: Dict, name: str, attempt: int,
                     prev: Optional[str] = None,
                     hop: Optional[str] = None) -> int:
        """Append one hop stamp to a traced item's context; when ``prev``/
        ``hop`` name the stamp that opened this hop, record the same-
        process monotonic delta into the ``service.hop.<hop>`` histogram
        (skew-free - both ends are our own clock)."""
        now_ns = time.perf_counter_ns()
        hops = tc.setdefault("hops", [])
        if prev is not None and self.telemetry.enabled:
            for who, hname, _a, t_ns, _off in reversed(hops):
                if hname == prev and who != "d":
                    self.telemetry.histogram(f"service.hop.{hop}").record(
                        max(0, now_ns - t_ns) / 1e9)
                    break
        hops.append([self.worker_name or "w?", name, attempt, now_ns,
                     self._clock_offset_ns])
        return now_ns

    def _processor_loop(self) -> None:
        tele = self.telemetry
        while not self._stop_event.is_set():
            try:
                cid, item, tc = self._work.get(timeout=0.05)
            except queue.Empty:
                continue
            with self._busy_lock:
                self._busy += 1
            ordinal = getattr(item, "ordinal", None)
            attempt = getattr(item, "attempt", 0)
            try:
                try:
                    if tc is not None:
                        self._trace_stamp(tc, "start", attempt,
                                          prev="recv", hop="worker_queue")
                    fn = self._fn_for(cid)
                    result = _call(fn, item, getattr(fn, "takes_ventilated_items", False))
                except BaseException as exc:  # noqa: BLE001 - forwarded
                    if getattr(exc, "petastorm_tpu_simulated_crash", False):
                        # chaos harness: die like the OOM killer struck -
                        # no result, no goodbye; the dispatcher's death
                        # detection requeues our in-flight items
                        os._exit(137)
                    self._send_failure(cid, ordinal, attempt, exc, item)
                else:
                    try:
                        t0 = (time.perf_counter_ns() if tele.enabled
                              else None)
                        header, parts = encode_result(
                            result, arena=self._arena_for(cid),
                            stop_check=self._stop_event.is_set,
                            codec=self._codec_for(cid))
                        header.update({
                            "t": "result", "client": cid,
                            "ordinal": ordinal, "attempt": attempt,
                            "rows": getattr(result, "num_rows", 0)})
                        if tc is not None:
                            # exec+encode done: close the worker-exec hop
                            # and return the accumulated timeline with the
                            # result header
                            self._trace_stamp(tc, "done", attempt,
                                              prev="start", hop="worker_exec")
                            header["tc"] = tc
                        if t0 is not None:
                            # outbound wire-encoding cost, per direction
                            # (the client records service.decode)
                            tele.record_stage(
                                "service.encode", t0,
                                time.perf_counter_ns() - t0,
                                {"ordinal": ordinal, "pk": header["pk"]})
                        self._deliver("batch", header, parts,
                                      key=(cid, ordinal))
                    except Exception as exc:  # noqa: BLE001 - must answer
                        # an unencodable result (unpicklable transform
                        # output, oversize frame) must become a classified
                        # failure, not a silently-dead processor thread and
                        # a forever-hanging client ordinal
                        logger.warning("result for item %s not encodable;"
                                       " forwarding as failure", ordinal,
                                       exc_info=True)
                        self._send_failure(cid, ordinal, attempt, exc, item)
                    else:
                        self.items_processed += 1
                        if tele.enabled:
                            tele.counter("service.worker_results").add(1)
                            tele.counter(
                                "service.frames_binary"
                                if header["pk"] == "bin" else
                                "service.frames_shm"
                                if header["pk"] == "shm" else
                                "service.frames_pickle_fallback").add(1)
            finally:
                with self._busy_lock:
                    self._busy -= 1

    # -- outcome delivery (live or buffered across a dispatcher outage) -------

    def _deliver(self, kind: str, header: Dict, parts,
                 key: Optional[Tuple[str, int]] = None) -> None:
        """Send one outcome on the live connection, or buffer it in the
        bounded outbox while disconnected.  ``key`` is the held-assignment
        entry the outcome resolves; it is released only once the outcome
        reaches a live connection (or is shed with its outcome)."""
        with self._conn_lock:
            conn = self._conn if self._connected.is_set() else None
        if conn is not None:
            try:
                if kind == "batch":
                    conn.send_batch(header, parts)
                else:
                    conn.send(header)
                self._release_held(key)
                return
            except OSError:
                with self._conn_lock:
                    if self._conn is conn:
                        self._connected.clear()
                conn.close()
        if self._reconnect_attempts <= 0:
            # no rejoin coming: the dispatcher's death detection requeues
            # our items; buffering would just hold memory until exit
            self._release_held(key)
            return
        self._outbox_push(kind, header, parts, key)

    def _release_held(self, key) -> None:
        if key is None:
            return
        with self._held_lock:
            self._held.pop(key, None)

    def _outbox_push(self, kind: str, header: Dict, parts, key) -> None:
        size = sum(len(p) for p in parts or ())
        with self._held_lock:
            self._outbox.append((kind, header, parts, key, size))
            self._outbox_bytes += size
            while self._outbox and (len(self._outbox) > OUTBOX_MAX_ITEMS
                                    or self._outbox_bytes > OUTBOX_MAX_BYTES):
                _k, _h, _p, old_key, old_size = self._outbox.popleft()
                self._outbox_bytes -= old_size
                if old_key is not None:
                    # shedding the outcome forgets the assignment too: the
                    # client's resync re-enqueues it (re-fetch, not a hang)
                    self._held.pop(old_key, None)
                self._pending_events.append({"kind": "outbox_shed",
                                             "outbox_items":
                                                 len(self._outbox)})
                logger.warning("outbox overflow while disconnected: shed one"
                               " buffered outcome (client will re-fetch)")

    def _flush_outbox(self) -> None:
        """Drain buffered outcomes onto the fresh connection (rejoin)."""
        while True:
            with self._held_lock:
                if not self._outbox:
                    return
                kind, header, parts, key, size = self._outbox.popleft()
                self._outbox_bytes -= size
            with self._conn_lock:
                conn = self._conn if self._connected.is_set() else None
            if conn is None:
                with self._held_lock:
                    self._outbox.appendleft((kind, header, parts, key, size))
                    self._outbox_bytes += size
                return
            try:
                if kind == "batch":
                    conn.send_batch(header, parts)
                else:
                    conn.send(header)
                self._release_held(key)
            except OSError:
                with self._held_lock:
                    self._outbox.appendleft((kind, header, parts, key, size))
                    self._outbox_bytes += size
                with self._conn_lock:
                    if self._conn is conn:
                        self._connected.clear()
                return

    def _send(self, msg: Dict) -> None:
        """Best-effort control send on the live connection (heartbeats):
        never buffered, dropped while disconnected."""
        with self._conn_lock:
            conn = self._conn if self._connected.is_set() else None
        if conn is None:
            return
        try:
            conn.send(msg)
        except OSError:
            # dispatcher gone mid-send: the read loop notices EOF and the
            # run loop reconnects (or exits); it requeues whatever we held
            logger.debug("send failed (dispatcher gone?)")

    def _send_failure(self, cid: str, ordinal, attempt, exc: BaseException,
                      item) -> None:
        """Forward one classified failure as plain wire fields (the pool's
        ``_Failure`` envelope supplies the formatting/classification; no
        object crosses the socket - the client recovers the item from its
        own ledger)."""
        failure = _Failure(exc, ordinal=ordinal, item=item)
        self._deliver("ctrl", {"t": "failure", "client": cid,
                               "ordinal": ordinal, "attempt": attempt,
                               "formatted": failure.formatted,
                               "kind": failure.kind,
                               "exc_type": failure.exc_type},
                      None, key=(cid, ordinal))

    # -- heartbeat ------------------------------------------------------------

    def _counter_deltas(self) -> Dict[str, float]:
        """Per-heartbeat deltas of this process's decode/cache/worker
        counters (FLEET_COUNTER_PREFIXES on the dispatcher side)."""
        if not self.telemetry.enabled:
            return {}
        counters = self.telemetry.snapshot().get("counters", {})
        deltas = {}
        for name, value in counters.items():
            prev = self._hb_snapshot.get(name, 0.0)
            if value > prev:
                deltas[name] = value - prev
            self._hb_snapshot[name] = value
        return deltas

    def _hb_hists(self) -> Dict[str, Dict]:
        """Cumulative histogram snapshots to ship with the heartbeat:
        stage latencies plus our same-process trace hops.  Cumulative (not
        deltas) - the dispatcher keeps the latest per worker and merges
        fleet-wide via the fixed shared bucket bounds."""
        if not self.telemetry.enabled:
            return {}
        hists = self.telemetry.snapshot().get("histograms", {})
        return {n: s for n, s in hists.items()
                if n.startswith("service.hop.")
                or (n.startswith("stage.") and n.endswith(".latency_s"))}

    def _heartbeat_loop(self) -> None:
        # wakes every 0.25s so a drain completes promptly, but heartbeats
        # still go out only every _hb_interval
        next_hb = 0.0
        while not self._stop_event.wait(0.25):
            now = time.monotonic()
            if self._retiring.is_set():
                if not self._retire_sent and self._connected.is_set():
                    self._retire_sent = True
                    self._send({"t": "retiring"})
                if self._check_drained(now):
                    return
            if now < next_hb:
                continue
            next_hb = now + self._hb_interval
            if not self._connected.is_set():
                continue
            with self._busy_lock:
                busy = self._busy + self._work.qsize()
            hb = {"t": "heartbeat", "busy": busy,
                  "counters": self._counter_deltas()}
            hists = self._hb_hists()
            if hists:
                hb["hists"] = hists
            evs = []
            while self._pending_events:
                try:
                    evs.append(self._pending_events.popleft())
                except IndexError:
                    break
            if evs:
                hb["events"] = evs
            self._send(hb)

    def _check_drained(self, now: float) -> bool:
        """Drain-completion check (heartbeat thread): everything this
        worker held has reached the dispatcher, AND the dispatcher has
        confirmed - via the ``drained?``/``drain_ok`` probe - that it has
        nothing recorded in flight toward us.  Because the dispatcher
        records an assignment *before* sending its work frame and stops
        assigning once it acks ``retiring``, a ``drain_ok`` structurally
        rules out a work frame racing our goodbye - no timing window to
        tune.  On completion: ``bye``, stop, done."""
        if not self._retire_acked.is_set():
            return False
        with self._held_lock:
            empty = not self._held and not self._outbox
        if not empty:
            # a straggler work frame landed since the last probe; any
            # earlier confirmation is stale
            self._drain_confirmed.clear()
            return False
        if self._drain_confirmed.is_set():
            logger.info("Worker %s drained; retiring gracefully",
                        self.worker_name or "?")
            # stopped before the goodbye: the dispatcher closes the link
            # as it reads ``bye``, and a run loop that saw that close
            # before the stop would rejoin and be assigned work it never
            # does (requeued when it then exits)
            self.retired_gracefully = True
            self._stop_event.set()
            self._send({"t": "bye"})
            self.stop()
            return True
        self._send({"t": "drained?"})
        return False


def run_worker(address, capacity: int = 2, name: Optional[str] = None,
               shm_size_bytes: int = 0,
               reconnect_attempts: int = 0,
               reconnect_backoff_s: float = 1.0,
               auth_token: Optional[str] = None,
               install_signal_handlers: bool = False) -> int:
    """Blocking worker entry (the CLI's ``worker`` subcommand).

    ``reconnect_attempts`` > 0 makes the worker survive dispatcher
    restarts WITHOUT dropping its in-flight work: registration retries
    that many times with a fixed backoff, and every successful rejoin
    resets the budget (elastic fleets keep workers running while the
    control plane reschedules - see the module docstring for what a
    rejoin reports).

    ``install_signal_handlers``: SIGTERM triggers **graceful retirement**
    (drain in-flight items, flush, goodbye - the autoscale supervisor's
    scale-down path); a second SIGTERM stops hard.  Main-thread only (the
    CLI sets it)."""
    worker = ServiceWorker(address, capacity=capacity, name=name,
                           shm_size_bytes=shm_size_bytes,
                           auth_token=auth_token,
                           reconnect_attempts=reconnect_attempts,
                           reconnect_backoff_s=reconnect_backoff_s)
    if install_signal_handlers:
        import signal as _signal

        def _on_term(_signum, _frame):
            if worker._retiring.is_set():  # noqa: SLF001 - own module
                worker.stop()  # second SIGTERM: stop hard
            else:
                worker.begin_retire()

        try:
            _signal.signal(_signal.SIGTERM, _on_term)
        except ValueError:
            logger.warning("not the main thread; SIGTERM graceful-drain"
                           " handler not installed")
    return worker.run()
