"""Client executor: the trainer-side plane of the disaggregated service.

The port's counterpart of ``petastorm_tpu/service/client.py:61-997``.  The
JAX client subclasses ``petastorm_tpu.pool.ExecutorBase`` and hands results
to the reader in completion order, for its reorder stage.  The port has no
such stage: its pools deliver in plan order behind one in-flight window
(``pool._LedgerExecutor``).  So :class:`ServiceExecutor` is a
``_LedgerExecutor`` whose workers are the dispatcher's fleet: the
ventilator thread sends each ``VentilatedItem`` of the plan as an
``enqueue`` frame once it holds a window slot, a receiver thread turns the
dispatcher's frames into arrivals, and ``imap`` delivers them in plan order,
so a service reader's stream is the local reader's, item for item, and its
cursor (``quiesce``) is exact.  ``ordinal_exact`` stays true for service
readers too.

What the service plane does for the ledger: the dispatcher requeues items
off dead workers (``requeued`` frames count ``requeued_items`` here) and
spends the requeue budget for infra failures, so every failure frame that
arrives is final and lands at its item's position.  ``item_deadline_s`` and
``hedge_after_s`` are the fleet's concern and are not taken.

Graceful degrade: a lost dispatcher connection enters a reconnect-with-
backoff window (a :class:`~petastorm_tpu_torch.retry.RetryPolicy`); on
reconnect the client resyncs its in-flight ledger (items whose ``enqueue``
died with the old connection are re-sent; the dispatcher replays unacked
results, which the ledger dedups).  A window that closes without a
connection raises :class:`ServiceConnectionError`, a classified
infrastructure ``WorkerError`` carrying ``.diagnostics``, instead of hanging
the epoch.
"""

from __future__ import annotations

import logging
import os
import queue
import socket
import threading
import time
import uuid
from typing import Any, Dict, Optional

from petastorm_tpu_torch.errors import DEFAULT_REQUEUE_ATTEMPTS, PetastormTpuError
from petastorm_tpu_torch.pool import VentilatedItem, WorkerError, _Failure, _LedgerExecutor
from petastorm_tpu_torch.retry import RetryPolicy
from petastorm_tpu_torch.service.protocol import (PROTOCOL_VERSION, FrameClosedError,
                                                  FrameSocket, PayloadDecoder, WireItem,
                                                  connect_frames, parse_address_list,
                                                  resolve_allow_pickle, resolve_auth_token)
from petastorm_tpu_torch.service.wire import SUPPORTED_CODECS, WIRE_VERSION

logger = logging.getLogger(__name__)

_POLL_S = 0.05
#: default bound on items in flight at the dispatcher per client (the
#: service-plane analog of the pool's worker part of the window)
DEFAULT_WINDOW = 16
#: cadence of client_stats frames (the starved-seconds fleet-pressure feed)
_STATS_INTERVAL_S = 1.0
#: results per ack frame (batched: the ack only frees the dispatcher's
#: redelivery buffer, so latency costs nothing but a slightly longer
#: replay on reconnect - the per-ordinal ledger dedups it regardless)
_ACK_BATCH = 8


class ServiceConnectionError(WorkerError):
    """The dispatcher connection was lost and could not be re-established
    within the reconnect-with-backoff window.

    Kind ``'infra'`` and unattributable (no single work item to blame), so
    it is terminal under every ``on_error`` policy - a trainer must fail
    loudly, not hang, when its ingest control plane is gone.  Carries the
    executor's ``diagnostics`` snapshot (connection history, in-flight
    window state) taken at raise time.
    """

    def __init__(self, message: str, diagnostics: Optional[dict] = None):
        super().__init__(message, kind="infra")
        self.diagnostics = diagnostics or {}


class _ConnLost:
    """Receiver-thread -> consumer sentinel: reconnect window exhausted."""

    __slots__ = ("message",)

    def __init__(self, message: str):
        self.message = message


class ServiceExecutor(_LedgerExecutor):
    """A ``_LedgerExecutor`` over a dispatcher connection (module docstring).

    ``window``: items issued to the dispatcher and not yet delivered, beside
    ``results_queue_size`` more held for their turn (the in-flight window's
    two parts, as in the local pools); the ventilator waits past it, which
    keeps it from streaming a whole epoch ahead.  ``reconnect_policy``:
    backoff schedule for the lost-connection window (``max_attempts``
    reconnect tries before :class:`ServiceConnectionError`).
    ``max_requeue_attempts`` travels to the dispatcher in the hello, so the
    service plane enforces the same per-item budget the local pools would.

    QoS: ``weight`` (default 1.0, or ``$PETASTORM_TPU_SERVICE_WEIGHT``) is
    this client's long-run assignment share within its priority tier -
    weighted deficit-round-robin dispatcher-side; ``priority`` (default 0,
    or ``$PETASTORM_TPU_SERVICE_PRIORITY``) is a **strict** tier - a lower
    tier is served only while no higher tier has pending work.

    Tracing: ``trace_items`` (default off; ``True`` = 1-in-16, int N =
    1-in-N, env ``$PETASTORM_TPU_TRACE_ITEMS``) arms per-item distributed
    tracing - sampled ordinals carry a trace context through the wire,
    every hop stamps it, and the returned timeline merges into this
    process's trace buffer as cross-process spans plus ``service.hop.*``
    latency-decomposition histograms.
    """

    _VENTILATOR_NAME = "petastorm-torch-service-ventilator"

    def __init__(self, address, telemetry=None, stop_on_failure: bool = True,
                 max_requeue_attempts: int = DEFAULT_REQUEUE_ATTEMPTS,
                 window: int = DEFAULT_WINDOW, results_queue_size: int = 1,
                 reconnect_policy: Optional[RetryPolicy] = None,
                 client_id: Optional[str] = None,
                 auth_token: Optional[str] = None,
                 allow_pickle_results: Optional[bool] = None,
                 weight: Optional[float] = None,
                 priority: Optional[int] = None,
                 trace_items=None):
        if window < 1:
            raise PetastormTpuError("ServiceExecutor window must be >= 1")
        super().__init__(int(window), results_queue_size, stop_on_failure,
                         max_requeue_attempts, None, None, telemetry)
        # multi-tenant QoS identity, carried by the hello: `weight` is this
        # client's long-run share within its strict-priority tier (weighted
        # deficit-round-robin dispatcher-side), `priority` its tier (higher
        # is served first).  Env fallbacks let a deployment tier trainers
        # without touching reader call sites.
        if weight is None:
            weight = float(os.environ.get(
                "PETASTORM_TPU_SERVICE_WEIGHT", "1.0") or 1.0)
        if priority is None:
            priority = int(os.environ.get(
                "PETASTORM_TPU_SERVICE_PRIORITY", "0") or 0)
        if weight <= 0:
            raise PetastormTpuError(
                f"service client weight must be > 0; got {weight}")
        self.weight = float(weight)
        self.priority = int(priority)
        # per-item distributed tracing (default OFF): every Nth ventilated
        # ordinal carries a trace context through the wire; dispatcher and
        # workers stamp per-hop monotonic timestamps into it and the result
        # returns the merged timeline, which we map into this process's
        # clock (handshake offset estimate + per-hop monotonic deltas) and
        # record as cross-process spans + service.hop.* histograms.
        # `trace_items=True` samples 1-in-16; an int N samples 1-in-N;
        # env fallback $PETASTORM_TPU_TRACE_ITEMS.
        if trace_items is None:
            env = os.environ.get("PETASTORM_TPU_TRACE_ITEMS", "").strip()
            trace_items = int(env) if env else 0
        if isinstance(trace_items, bool):
            trace_items = 16 if trace_items else 0
        self._trace_every = max(int(trace_items), 0)
        self._tracing = (self._trace_every > 0
                         and getattr(self._telemetry, "enabled", False)
                         and getattr(self._telemetry, "trace", None)
                         is not None)
        self._trace_lock = threading.Lock()
        #: ordinal -> {"id", "put_ns", "sent_ns"} for armed in-flight items
        self._traces: Dict[Any, Dict] = {}
        #: synthetic pid per remote process name (merged-trace tracks)
        self._trace_pids: Dict[str, int] = {}
        #: handshake clock-offset estimate: dispatcher perf_counter_ns
        #: minus ours (error ~ hello RTT/2); remote stamps map through it
        self._disp_clock_offset_ns = 0
        #: perf_counter_ns when the connection was last lost (rollover span)
        self._lost_at_ns: Optional[int] = None
        #: failover list ('a:p' or 'a:p,b:p' - primary then hot standby);
        #: every (re)connect rotates through it starting at the last
        #: address that worked (docs/operations.md "Dispatcher HA")
        self._addresses = parse_address_list(address)
        self._addr_index = 0
        self._address = self._addresses[0]
        #: handshake secret (default $PETASTORM_TPU_SERVICE_TOKEN); must
        #: match the dispatcher's when it enforces one
        self._auth_token = resolve_auth_token(auth_token)
        self._reconnect_policy = reconnect_policy or RetryPolicy(
            max_attempts=5, initial_backoff_s=0.2, max_backoff_s=2.0)
        self.client_id = client_id or uuid.uuid4().hex[:16]
        self._conn: Optional[FrameSocket] = None
        self._conn_lock = threading.Lock()      # connection swap + sends
        self._connected = threading.Event()
        #: set when the receiver's reconnect window closed for good (the
        #: _ConnLost sentinel is queued); a waiting ventilator stops waiting then
        self._conn_failed = threading.Event()
        #: the receiver's arrivals for the consumer: ("ok", ordinal,
        #: attempt, value), failure frames, local _Failures, _ConnLost
        self._arrivals: "queue.SimpleQueue[Any]" = queue.SimpleQueue()
        self._recv_thread: Optional[threading.Thread] = None
        #: ``"pickle"`` fallback payload gate (hardened deployments refuse:
        #: allow_pickle_results=False / $PETASTORM_TPU_SERVICE_ALLOW_PICKLE=0)
        self._decoder = PayloadDecoder(
            allow_pickle=resolve_allow_pickle(allow_pickle_results))
        self._factory_blob: Optional[bytes] = None
        self._reconnects = 0
        #: dispatcher boot id from the last hello_ok: a CHANGED boot on
        #: reconnect means the dispatcher restarted and this session was
        #: reconstructed from our ledger (service.dispatcher_restarts)
        self._dispatcher_boot: Optional[str] = None
        self._dispatcher_restarts = 0
        #: highest fencing epoch any hello_ok advertised: a dispatcher
        #: below it is a DEPOSED primary and is refused (split-brain
        #: fencing - the reconnect rotation moves on to its successor)
        self._dispatcher_epoch: Optional[int] = None
        self._warned_pickle_fallback = False
        self._last_connect_error: Optional[str] = None
        self._bytes_in_folded = 0
        self._starved_s = 0.0
        self._stats_sent_at = 0.0
        #: delivered ordinals awaiting an ack flush (receiver-thread state;
        #: acks are batched so a 2000-results/s stream does not pay a
        #: dispatcher wakeup per result - flushed every _ACK_BATCH results
        #: and whenever the receive loop goes idle)
        self._ack_pending: list = []
        #: results by payload kind as they arrive, with or without telemetry
        self._payloads = {"shm": 0, "bin": 0, "pickle": 0}
        # service.* client-side series (docs/operations.md): the stage span
        # is registered up front so reports/--watch render "(no samples
        # yet)" for a just-started service reader instead of omitting it
        if self._telemetry.enabled:
            self._telemetry.register_stage("service")
            # inbound wire-decoding cost, per direction (workers record
            # service.encode on their side)
            self._telemetry.register_stage("service.decode")
        self._m_bytes_out = self._telemetry.counter("service.frame_bytes_sent")
        self._m_bytes_in = self._telemetry.counter(
            "service.frame_bytes_received")
        self._m_results = self._telemetry.counter("service.results")
        self._m_reconnects = self._telemetry.counter("service.reconnects")
        self._m_srv_requeued = self._telemetry.counter(
            "service.requeued_items")
        self._g_connected = self._telemetry.gauge("service.connected")
        # wire-encoding mix of received results (mirrors the dispatcher's
        # relay counters; rendered on the `service:` diagnose --watch line)
        self._m_frames_bin = self._telemetry.counter("service.frames_binary")
        self._m_frames_pkl = self._telemetry.counter(
            "service.frames_pickle_fallback")
        self._m_frames_shm = self._telemetry.counter("service.frames_shm")
        self._m_frames_z = self._telemetry.counter(
            "service.frames_compressed")
        self._m_disp_restarts = self._telemetry.counter(
            "service.dispatcher_restarts")
        self._m_epoch_refused = self._telemetry.counter(
            "service.stale_epoch_refusals")

    # -- lifecycle ------------------------------------------------------------

    def start(self, worker_factory) -> None:
        """Connect, register this client, and ship the pickled worker
        factory the fleet will run."""
        import pickle

        if self._recv_thread is not None:
            raise PetastormTpuError("Executor already started")
        try:
            self._factory_blob = pickle.dumps(
                worker_factory, protocol=pickle.HIGHEST_PROTOCOL)
        except Exception as exc:
            raise PetastormTpuError(
                "service_address readers ship the worker factory to remote"
                f" workers, so it must be picklable: {exc}") from exc
        self._connect_any(resume=False)
        # imap refuses to run before this is set (the local pools' contract)
        self._factory = worker_factory
        self._recv_thread = threading.Thread(
            target=self._receiver_loop, daemon=True,
            name="petastorm-torch-service-recv")
        self._recv_thread.start()

    def _connect_any(self, resume: bool) -> None:
        """Hello against the failover address list: each address is tried
        once per call, starting at the last one that worked (the deposed
        primary's refusals - connection errors, standby refusals, stale
        epochs - rotate on to its successor).  Raises the last per-address
        error when the whole list fails."""
        last_exc: Optional[BaseException] = None
        n = len(self._addresses)
        for i in range(n):
            idx = (self._addr_index + i) % n
            self._address = self._addresses[idx]
            try:
                self._connect(resume)
            except (OSError, PetastormTpuError) as exc:
                last_exc = exc
                self._last_connect_error = str(exc)
                continue
            self._addr_index = idx
            return
        assert last_exc is not None
        raise last_exc

    def _connect(self, resume: bool) -> None:
        from petastorm_tpu_torch.native import transport_availability

        shm = transport_availability()
        conn = connect_frames(self._address)
        hs_t0 = time.perf_counter_ns()
        conn.send({"t": "client_hello", "protocol": PROTOCOL_VERSION,
                   "client": self.client_id, "factory": self._factory_blob,
                   "hostname": socket.gethostname(),
                   "shm_ok": shm["available"],
                   "codecs": list(SUPPORTED_CODECS),
                   "max_requeue": self._max_requeue,
                   "weight": self.weight, "priority": self.priority,
                   "resume": resume, "token": self._auth_token})
        hello = conn.recv(timeout=10.0)
        hs_t1 = time.perf_counter_ns()
        if not hello or hello.get("t") != "hello_ok":
            conn.close()
            raise OSError(f"dispatcher refused client hello: {hello!r}")
        clock_ns = hello.get("clock_ns")
        if isinstance(clock_ns, int):
            # offset_cd = dispatcher clock - our clock, sampled at the
            # handshake midpoint; remote trace stamps map into our
            # monotonic domain as t - offset_cd (dispatcher) or
            # t + worker_offset - offset_cd (worker)
            self._disp_clock_offset_ns = clock_ns - (hs_t0 + hs_t1) // 2
        epoch = hello.get("epoch")
        if isinstance(epoch, int):
            if self._dispatcher_epoch is not None \
                    and epoch < self._dispatcher_epoch:
                # split-brain fencing: a lower epoch is a deposed primary
                # that came back after its standby took over - refusing it
                # (and rotating on) keeps the fleet on the successor
                conn.close()
                self._m_epoch_refused.add(1)
                raise OSError(
                    f"dispatcher at {self._address[0]}:{self._address[1]}"
                    f" advertises stale epoch {epoch} <"
                    f" {self._dispatcher_epoch}: refusing a deposed primary")
            self._dispatcher_epoch = epoch
        boot = hello.get("boot")
        if boot is not None:
            if self._dispatcher_boot is not None \
                    and boot != self._dispatcher_boot:
                # a NEW dispatcher process answered: our session is being
                # reconstructed from this client's ledger (the resync
                # below re-sends whatever the new dispatcher lacks)
                self._dispatcher_restarts += 1
                self._m_disp_restarts.add(1)
                logger.warning(
                    "dispatcher restarted (boot %s -> %s); reconstructing"
                    " the session from the client ledger",
                    self._dispatcher_boot, boot)
            self._dispatcher_boot = boot
        #: ordinals the dispatcher already holds (journal warm restart /
        #: unacked replay): the resync skips re-sending these
        known = set(hello.get("known") or ())
        # which data plane this client can get, and WHY - so a silently
        # dark shm fast path (e.g. python < 3.12) is visible in the log,
        # not just in a bench ratio months later
        logger.info(
            "service wire negotiated with %s:%d: binary v%d frames, codecs"
            " %s, pickle fallback %s, shm fast path %s", self._address[0],
            self._address[1], WIRE_VERSION, list(SUPPORTED_CODECS),
            "accepted" if self._decoder.allow_pickle else "refused",
            "available (arms when a worker shares this host)"
            if shm["available"] else f"unavailable ({shm['reason']})")
        with self._conn_lock:
            old, self._conn = self._conn, conn
            self._bytes_in_folded = 0
        if old is not None:
            old.close()
        self._connected.set()
        self._g_connected.set(1)
        if resume:
            # re-send every ledger item the dispatcher may never have seen
            # (an enqueue lost with the dying connection, or an entire
            # session lost with a dead dispatcher); the dispatcher dedups
            # by ordinal against its pending/inflight/unacked state.
            # Ordinals the hello_ok reported as `known` are skipped - a
            # journal-armed dispatcher restart costs no re-sends at all
            with self._inflight_lock:
                items = [i for i in self._inflight.values()
                         if getattr(i, "ordinal", None) not in known]
                skipped = len(self._inflight) - len(items)
            if skipped:
                logger.info("resync skipped %d item(s) the dispatcher"
                            " already holds (warm restart)", skipped)
            if items:
                self._send({"t": "resync",
                            "items": [self._encode_item(i) for i in items]})

    def stop(self) -> None:
        """Stop consuming: best-effort goodbye, close the connection."""
        super().stop()
        self._connected.set()  # release a waiting ventilator into the stop check
        conn = self._conn
        if conn is not None:
            try:
                conn.send({"t": "bye"})
            except OSError:
                pass
            conn.close()

    def join(self, timeout: float = 5.0) -> None:
        """Wait for the ventilator and the receiver and release the payload
        arenas."""
        if not self._stopped:
            raise PetastormTpuError("call stop() before join()")
        for thread in (self._ventilator, self._recv_thread):
            if thread is not None:
                thread.join(timeout=timeout)
        self._decoder.close()

    # -- sending --------------------------------------------------------------

    def _send(self, msg: Dict) -> None:
        """Send on the current connection; OSError propagates (callers
        decide between waiting out a reconnect and raising)."""
        with self._conn_lock:
            conn = self._conn
            if conn is None:
                raise OSError("not connected")
            self._m_bytes_out.add(conn.send(msg))

    def _encode_item(self, item) -> Dict:
        """Wire-encode one ledger item, re-arming its trace context when the
        ordinal is registered as traced (a resync after a reconnect must not
        silently drop tracing mid-item)."""
        ordinal = getattr(item, "ordinal", None)
        if self._tracing and ordinal is not None:
            with self._trace_lock:
                entry = self._traces.get(ordinal)
            if entry is not None:
                return WireItem.encode(item, trace_id=entry["id"])
        return WireItem.encode(item)

    def _issue(self, vitem: VentilatedItem) -> bool:
        """Send one ventilated item (the ventilator holds its window slot and
        its ledger entry, which doubles as the resync source after a
        reconnect).  False withdraws it: the executor stopped, or a
        ``quiesce`` came while the connection was down."""
        ordinal = vitem.ordinal
        traced = self._tracing and ordinal % self._trace_every == 0
        if traced:
            # the ordinal doubles as the trace id: unique per run, and a
            # requeued attempt keeps the SAME id (one item, one trace)
            with self._trace_lock:
                self._traces[ordinal] = {"id": ordinal,
                                         "put_ns": time.perf_counter_ns()}
        try:
            self._send({"t": "enqueue", "item": self._encode_item(vitem)})
        except OSError:
            # connection mid-drop: the item is in the ledger, so the
            # receiver's reconnect resync re-sends it; wait for the window
            # to settle rather than failing ventilation immediately
            if not self._await_reconnect():
                if self._stop.is_set() or self._pause.is_set():
                    with self._trace_lock:
                        self._traces.pop(ordinal, None)
                    return False
                # the reconnect window closed: the receiver queued the
                # _ConnLost the consumer raises; the item stays in flight
                return True
            try:
                # a resync (ordinal-deduped dispatcher-side, unlike enqueue)
                # covers the race where the receiver's reconnect resync ran
                # before this item reached the ledger
                self._send({"t": "resync", "items": [self._encode_item(vitem)]})
            except OSError:
                pass  # the next drop repeats the recovery
        if traced:
            with self._trace_lock:
                if ordinal in self._traces:
                    self._traces[ordinal]["sent_ns"] = time.perf_counter_ns()
        return True

    def _try_enqueue(self, vitem: VentilatedItem) -> bool:
        return False  # the dispatcher requeues; the client never re-issues

    def _await_reconnect(self) -> bool:
        """Block until the receiver re-established the connection (True) or
        the executor stopped or quiesced, or the receiver's reconnect window
        closed for good (False).  Driven by the receiver's own signals -
        ``_connected`` and ``_conn_failed`` - not an independent timer: a
        timer shorter than the receiver's real window (backoffs PLUS a
        connect timeout per attempt) would cancel ventilation while the
        receiver later reconnects fine.  The generous deadline below is only
        a backstop against a wedged receiver thread."""
        deadline = time.monotonic() + self._reconnect_budget_s()
        while time.monotonic() < deadline:
            if self._stop.is_set() or self._pause.is_set() or self._conn_failed.is_set():
                return False
            if self._connected.wait(timeout=_POLL_S):
                return True
        self._conn_failed.set()
        self._arrivals.put(_ConnLost("service receiver did not reconnect within"
                                     f" {self._reconnect_budget_s():.0f}s"))
        return False

    # -- distributed tracing --------------------------------------------------

    def _trace_pid(self, proc: str) -> int:
        """Stable synthetic pid for a remote process name (dispatcher or a
        worker) - the merged Chrome trace renders each as its own named
        process track."""
        pid = self._trace_pids.get(proc)
        if pid is None:
            pid = 900001 + len(self._trace_pids)
            self._trace_pids[proc] = pid
        return pid

    def _finish_trace(self, msg: Dict, tc: Dict, recv_ns: int,
                      done_ns: int) -> None:
        """Merge one returned hop timeline into the local trace buffer and
        record the ``service.hop.*`` latency decomposition.

        Remote stamps are ``[who, name, attempt, t_ns, off_ns]`` where
        ``t_ns`` is the stamper's own ``perf_counter_ns`` and ``off_ns`` its
        handshake offset to the DISPATCHER clock (0 for the dispatcher
        itself).  Mapping into our clock: dispatcher ``t - offset_cd``,
        worker ``t + off_ns - offset_cd``.  Same-process hop pairs are
        monotonic deltas (skew-free); only the cross-process segments absorb
        the ~RTT/2 handshake error - and the seven hops still telescope
        exactly to the observed end-to-end (c.done - c.put) because every
        boundary is used once as an end and once as a start.
        """
        ordinal = msg.get("ordinal")
        with self._trace_lock:
            entry = self._traces.pop(ordinal, None)
        if entry is None:
            return
        trace = self._telemetry.trace
        off_cd = self._disp_clock_offset_ns
        put_ns = entry["put_ns"]
        sent_ns = entry.get("sent_ns", put_ns)
        args = {"trace_id": entry["id"], "ordinal": ordinal}
        disp_proc = f"dispatcher@{self._address[0]}:{self._address[1]}"
        mapped = []
        for hop in tc.get("hops") or ():
            if not isinstance(hop, (list, tuple)) or len(hop) != 5:
                continue
            who, name, attempt, t_ns, off_ns = hop
            if not isinstance(t_ns, int):
                continue
            ct = (t_ns - off_cd if who == "d"
                  else t_ns + int(off_ns or 0) - off_cd)
            mapped.append((str(who), str(name), int(attempt or 0), ct))
        # whole-item span + local hops on the client's own track
        trace.add("service.item", "service.trace", put_ns,
                  max(done_ns - put_ns, 0),
                  {**args, "attempt": msg.get("attempt", 0),
                   "hops": len(mapped)})
        trace.add("client.serialize", "service.trace", put_ns,
                  max(sent_ns - put_ns, 0), args)
        trace.add("client.deserialize", "service.trace", recv_ns,
                  max(done_ns - recv_ns, 0), args)
        # remote spans: pair up the stamp sequence; a requeued attempt
        # opens a SECOND dispatch/worker span tree under the same trace id,
        # annotated as a requeue
        last: Dict[str, tuple] = {}
        lasts = {}      # last mapped time per stamp kind (hop histograms)
        for who, name, attempt, ct in mapped:
            if who == "d":
                pid = self._trace_pid(disp_proc)
                if name in ("recv", "requeue"):
                    last["open"] = (name, attempt, ct)
                elif name == "assign":
                    opened = last.pop("open", None)
                    if opened is not None:
                        span = ("dispatch.requeue"
                                if opened[0] == "requeue"
                                else "dispatch.queue")
                        trace.add(span, "service.trace", opened[2],
                                  max(ct - opened[2], 0),
                                  {**args, "attempt": attempt,
                                   "requeued": opened[0] == "requeue"},
                                  pid=pid, proc=disp_proc, tid=1)
                    last["assign"] = (attempt, ct)
                    lasts["assign"] = ct
                elif name == "relay":
                    done = last.pop("wdone", None)
                    start = done[1] if done is not None else ct
                    trace.add("return.relay", "service.trace", start,
                              max(recv_ns - start, 0),
                              {**args, "attempt": attempt},
                              pid=pid, proc=disp_proc, tid=1)
            else:
                proc = f"worker:{who}"
                pid = self._trace_pid(proc)
                if name == "recv":
                    assigned = last.pop("assign", None)
                    if assigned is not None:
                        trace.add("relay", "service.trace", assigned[1],
                                  max(ct - assigned[1], 0),
                                  {**args, "attempt": attempt},
                                  pid=self._trace_pid(disp_proc),
                                  proc=disp_proc, tid=1)
                    last["wrecv"] = (attempt, ct)
                    lasts["wrecv"] = ct
                elif name == "start":
                    received = last.pop("wrecv", None)
                    if received is not None:
                        trace.add("worker.queue", "service.trace",
                                  received[1], max(ct - received[1], 0),
                                  {**args, "attempt": attempt},
                                  pid=pid, proc=proc, tid=1)
                    last["wstart"] = (attempt, ct)
                    lasts["wstart"] = ct
                elif name == "done":
                    started = last.pop("wstart", None)
                    if started is not None:
                        trace.add("worker.exec", "service.trace",
                                  started[1], max(ct - started[1], 0),
                                  {**args, "attempt": attempt},
                                  pid=pid, proc=proc, tid=1)
                    last["wdone"] = (attempt, ct)
                    lasts["wdone"] = ct
        # hop latency decomposition: boundaries of the item's FINAL attempt
        # chain (earlier requeued attempts fold into dispatcher_queue, where
        # the item was waiting from this client's point of view); recorded
        # only when the full chain stamped, so partial timelines cannot
        # skew the histograms
        hist = self._telemetry.histogram
        hop_ns = {"client_serialize": sent_ns - put_ns,
                  "client_deserialize": done_ns - recv_ns}
        if all(k in lasts for k in ("assign", "wrecv", "wstart", "wdone")):
            hop_ns.update({
                "dispatcher_queue": lasts["assign"] - sent_ns,
                "relay": lasts["wrecv"] - lasts["assign"],
                "worker_queue": lasts["wstart"] - lasts["wrecv"],
                "worker_exec": lasts["wdone"] - lasts["wstart"],
                "return_relay": recv_ns - lasts["wdone"],
            })
        hop_ns["total"] = done_ns - put_ns
        for name, ns in hop_ns.items():
            hist(f"service.hop.{name}").record(max(ns, 0) / 1e9)

    def fetch_fleet_events(self, n: int = 256,
                           timeout: float = 5.0) -> list:
        """Best-effort fetch of the dispatcher's structured fleet-event tail
        (``events?`` frame) over a short-lived side connection - the crash-
        artifact path: a terminal failure folds the fleet's last ~60s of
        promotions / requeues / autoscale decisions into this client's
        flight record.  Returns ``[]`` on any error; post-mortem enrichment
        must never mask the original failure."""
        try:
            conn = connect_frames(self._address)
        except OSError:
            return []
        try:
            conn.send({"t": "events?", "n": int(n),
                       "token": self._auth_token})
            msg = conn.recv(timeout=timeout)
            if isinstance(msg, dict) and msg.get("t") == "events":
                events = msg.get("events")
                if isinstance(events, list):
                    return events
            return []
        except (OSError, PetastormTpuError):
            return []
        finally:
            conn.close()

    def _reconnect_budget_s(self) -> float:
        """Upper bound on the receiver's reconnect window: per attempt, the
        capped backoff plus the 10s connect timeout, plus slack.  A
        BACKSTOP only - _await_reconnect normally exits on the receiver's
        _connected/_conn_failed signals long before this."""
        p = self._reconnect_policy
        total, backoff = 10.0, p.initial_backoff_s
        for _ in range(p.max_attempts):
            total += min(backoff, p.max_backoff_s) + 10.0
            backoff *= p.backoff_multiplier
        return total

    # -- receiving ------------------------------------------------------------

    def _receiver_loop(self) -> None:
        try:
            self._receiver_loop_impl()
        except BaseException:  # noqa: BLE001 - the consumer must never hang
            if not self._stopped:
                # whatever killed the receiver, the consumer must learn it
                # is alone (a silently-dead receiver = a wedged epoch)
                logger.warning("service receiver thread failed",
                               exc_info=True)
                self._conn_failed.set()
                self._arrivals.put(_ConnLost(
                    "service receiver thread failed (see log)"))

    def _receiver_loop_impl(self) -> None:
        while not self._stopped:
            conn = self._conn
            if conn is None:
                break
            try:
                msg = conn.recv(timeout=0.2)
            except (FrameClosedError, PetastormTpuError, OSError):
                if self._stopped:
                    return
                self._g_connected.set(0)
                self._connected.clear()
                if not self._reconnect():
                    self._conn_failed.set()  # release a waiting ventilator first
                    # the last per-attempt error distinguishes a dead/
                    # unreachable dispatcher from a deterministic refusal
                    # (e.g. 'bad auth token' after a dispatcher restart
                    # with a new secret) - without it the operator debugs
                    # the network instead of the token
                    detail = (f" (last attempt: {self._last_connect_error})"
                              if self._last_connect_error else "")
                    addrs = ",".join(f"{h}:{p}" for h, p in self._addresses)
                    self._arrivals.put(_ConnLost(
                        f"dispatcher connection to {addrs} lost and"
                        f" {self._reconnect_policy.max_attempts} reconnect"
                        f" attempt(s) failed{detail}"))
                    return
                continue
            if msg is None:
                self._flush_acks()  # idle moment: free the redelivery buffer
                continue
            self._dispatch_frame(conn, msg)

    def _dispatch_frame(self, conn: FrameSocket, msg: Dict) -> None:
        kind = msg.get("t")
        if conn.bytes_received > self._bytes_in_folded:
            self._m_bytes_in.add(conn.bytes_received - self._bytes_in_folded)
            self._bytes_in_folded = conn.bytes_received
        if kind == "result":
            if msg.get("pk") in self._payloads:
                self._payloads[msg["pk"]] += 1
            t0 = time.perf_counter_ns() if self._telemetry.enabled else None
            try:
                value = self._decoder.decode(msg)
            except Exception as exc:  # noqa: BLE001 - surfaced to consumer
                # malformed/refused payload: a CLASSIFIED failure for this
                # ordinal (the frame was already fully consumed, so the
                # stream stays synced and other ordinals keep flowing).
                # Still ACKED: the outcome was consumed, and an unacked
                # result would pin its multi-MB body in the dispatcher's
                # redelivery buffer forever and replay on every reconnect
                # just to be refused again
                self._arrivals.put(_Failure(exc, ordinal=msg.get("ordinal")))
                self._ack_pending.append(msg.get("ordinal"))
                self._flush_acks()
                return
            if t0 is not None:
                dur = time.perf_counter_ns() - t0
                # the 'service' stage: client-side cost of receiving one
                # result (payload decode; the wire wait shows up as the
                # reader's queue.results_empty_wait_s, not busy time here)
                self._telemetry.record_stage(
                    "service", t0, dur, {"ordinal": msg.get("ordinal")})
                self._telemetry.record_stage(
                    "service.decode", t0, dur,
                    {"ordinal": msg.get("ordinal"), "pk": msg.get("pk")})
                self._m_results.add(1)
                tc = msg.get("tc")
                if self._tracing and isinstance(tc, dict):
                    try:
                        self._finish_trace(msg, tc, t0, t0 + dur)
                    except Exception:  # noqa: BLE001 - tracing never fatal
                        logger.debug("trace merge failed for ordinal %s",
                                     msg.get("ordinal"), exc_info=True)
            pk = msg.get("pk")
            if pk == "bin":
                self._m_frames_bin.add(1)
                if msg.get("codec"):
                    self._m_frames_z.add(1)
            elif pk == "shm":
                self._m_frames_shm.add(1)
            elif pk == "pickle":
                self._m_frames_pkl.add(1)
                if not self._warned_pickle_fallback:
                    # once, on the FIRST fallback: a hot pickle path should
                    # be a deliberate choice, not a silent default
                    self._warned_pickle_fallback = True
                    logger.warning(
                        "service result for ordinal %s arrived as a PICKLE"
                        " fallback (outside the binary wire domain) and was"
                        " unpickled; this is metered"
                        " (service.frames_pickle_fallback) and refusable -"
                        " set ServiceExecutor(allow_pickle_results=False)"
                        " or $PETASTORM_TPU_SERVICE_ALLOW_PICKLE=0 (the"
                        " knob make_reader service readers resolve) to"
                        " refuse such results as classified failures",
                        msg.get("ordinal"))
            self._arrivals.put(("ok", msg.get("ordinal"),
                               msg.get("attempt", 0), value))
            self._ack_pending.append(msg.get("ordinal"))
            if len(self._ack_pending) >= _ACK_BATCH:
                self._flush_acks()
            try:
                self._maybe_send_stats()
            except OSError:
                pass  # the read side will notice and reconnect
        elif kind == "failure":
            self._arrivals.put(msg)
            # failures free the dispatcher's redelivery buffer exactly
            # like results - an unacked failure would be buffered
            # forever and replayed on every reconnect
            self._ack_pending.append(msg.get("ordinal"))
            self._flush_acks()
        elif kind == "requeued":
            # accounting notice: the dispatcher moved one of our in-flight
            # items off a dead worker (the item itself stays in flight)
            self._requeued_items += 1
            self._m_requeued.add(1)
            self._m_srv_requeued.add(1)
            if self._tracing:
                # instant annotation in the local timeline; the full
                # requeued attempt arrives later inside the item's merged
                # hop timeline (same trace id, second span tree)
                self._telemetry.trace.add(
                    "service.requeued", "service.trace",
                    time.perf_counter_ns(), 0,
                    {"ordinal": msg.get("ordinal"),
                     "attempt": msg.get("attempt")})

    def _reconnect(self) -> bool:
        """Reconnect-with-backoff window (retry.py policy shape); True when
        a connection was re-established and the ledger resynced."""
        p = self._reconnect_policy
        backoff = p.initial_backoff_s
        self._lost_at_ns = time.perf_counter_ns()
        for attempt in range(1, p.max_attempts + 1):
            if self._stopped:
                return False
            logger.warning(
                "Dispatcher connection lost; reconnect attempt %d/%d in"
                " %.2fs", attempt, p.max_attempts, backoff)
            deadline = time.monotonic() + min(backoff, p.max_backoff_s)
            while time.monotonic() < deadline:
                if self._stopped:
                    return False
                time.sleep(_POLL_S)
            try:
                self._connect_any(resume=True)
            except (OSError, PetastormTpuError) as exc:
                # OSError = refused/unreachable; PetastormTpuError covers a
                # half-dead accept (FrameClosedError mid-hello: the listener
                # backlog accepted us, then the dying dispatcher reset)
                self._last_connect_error = str(exc)
                backoff *= p.backoff_multiplier
                continue
            self._reconnects += 1
            self._m_reconnects.add(1)
            if self._tracing and self._lost_at_ns is not None:
                # annotated gap: a dispatcher failover / restart shows up
                # in the merged trace as a distinct rollover span covering
                # the whole dark window, not an unexplained hole
                now = time.perf_counter_ns()
                self._telemetry.trace.add(
                    "service.rollover", "service.trace", self._lost_at_ns,
                    max(now - self._lost_at_ns, 0),
                    {"attempts": attempt,
                     "address":
                         f"{self._address[0]}:{self._address[1]}",
                     "dispatcher_restarts": self._dispatcher_restarts,
                     "epoch": self._dispatcher_epoch})
            self._lost_at_ns = None
            logger.info("Reconnected to dispatcher (attempt %d)", attempt)
            return True
        return False

    def _flush_acks(self) -> None:
        """Send any batched delivered-ordinal acks (receiver thread only).
        A send failure keeps them pending: the dispatcher replays unacked
        outcomes on reconnect and the ledger dedups."""
        if not self._ack_pending:
            return
        ordinals, self._ack_pending = self._ack_pending, []
        try:
            self._send({"t": "ack", "ordinals": ordinals})
        except OSError:
            self._ack_pending = ordinals + self._ack_pending

    def _maybe_send_stats(self) -> None:
        """Piggyback the consumer starved-seconds delta (the fleet-pressure
        signal) on the ack path, at most once per _STATS_INTERVAL_S."""
        now = time.monotonic()
        if now - self._stats_sent_at < _STATS_INTERVAL_S:
            return
        self._stats_sent_at = now
        starved, self._starved_s = self._starved_s, 0.0
        if starved > 0:
            self._send({"t": "client_stats", "starved_s": starved})

    # -- consuming ------------------------------------------------------------

    def _next_arrival(self, timeout: float):
        """One arrival from the receiver; raises ``queue.Empty``.  The wait
        is the consumer's starved time the fleet-pressure signal reads."""
        t0 = time.monotonic()
        try:
            return self._arrivals.get(timeout=timeout)
        except queue.Empty:
            self._starved_s += time.monotonic() - t0
            raise

    def _service_faults(self) -> None:
        """The fleet's faults are the dispatcher's: nothing to sweep here."""

    def _in_queue_depth(self) -> int:
        with self._inflight_lock:
            return len(self._inflight)

    def _accept(self, entry) -> None:
        """Settle one arrival (consumer thread): a result is held for its
        turn (a redelivery duplicate is dropped), a failure is stored at its
        item's position, a lost connection raises."""
        if isinstance(entry, _ConnLost):
            if self._stop_on_failure:
                self.stop()
            raise ServiceConnectionError(
                f"{entry.message}; epoch cannot complete",
                diagnostics=self.diagnostics)
        if isinstance(entry, _Failure):
            # local failure (payload decode): classified like a pool one
            entry = {"t": "failure", "ordinal": entry.ordinal, "failure": entry}
        if isinstance(entry, dict):  # forwarded failure frame
            self._handle_failure_frame(entry)
            return
        _tag, ordinal, attempt, value = entry
        if not self._settle(ordinal):
            return  # redelivery duplicate (reconnect replay)
        if ordinal != self._awaited:
            self._m_reordered.add(1)
        self._note_delivery(ordinal, attempt)
        self._store(ordinal, value)

    def _handle_failure_frame(self, msg: Dict) -> None:
        """Store one forwarded failure at its item's position (a duplicate
        for an already-settled ordinal is dropped).  Data failures surface
        as classified WorkerErrors for the reader's ``on_error`` policy; the
        dispatcher already ran the requeue budget for infra failures, so
        whatever arrives here is final.

        Failure frames carry only plain fields (formatted traceback, kind,
        exc_type) - the failed work item itself never crosses the wire
        back; it is recovered from this executor's own in-flight ledger for
        the quarantine record."""
        ordinal = msg.get("ordinal")
        if self._tracing:
            with self._trace_lock:
                self._traces.pop(ordinal, None)
        with self._inflight_lock:
            vitem = self._inflight.get(ordinal)
        if not self._settle(ordinal):
            return
        failure = msg.get("failure")  # local decode _Failure, never wire
        if failure is not None:
            message = f"Worker failed:\n{failure.formatted}"
            kind = failure.kind
            exc_type = failure.exc_type
        elif msg.get("formatted") is not None:
            message = f"Worker failed:\n{msg['formatted']}"
            kind = msg.get("kind", "data")
            exc_type = msg.get("exc_type")
        else:
            message = msg.get("message", "service worker failure")
            kind = msg.get("kind", "infra")
            exc_type = None
        err = WorkerError(message, kind=kind, ordinal=ordinal,
                          item=vitem.item if vitem is not None else None,
                          exc_type=exc_type)
        if failure is not None:
            err.__cause__ = failure.exc
        self._store(ordinal, err)

    @property
    def diagnostics(self) -> dict:
        """The ledger's counters plus connection state (address, reconnects,
        in-flight window usage)."""
        return {**super().diagnostics,
                "service_address": f"{self._address[0]}:{self._address[1]}",
                "service_addresses": ",".join(f"{h}:{p}"
                                              for h, p in self._addresses),
                "client_id": self.client_id,
                "connected": self._connected.is_set() and not self._stopped,
                "reconnects": self._reconnects,
                "dispatcher_restarts": self._dispatcher_restarts,
                "dispatcher_epoch": self._dispatcher_epoch,
                "window": self._window.size,
                "window_in_use": self._in_queue_depth(),
                "trace_items": self._trace_every,
                "payloads": dict(self._payloads)}
