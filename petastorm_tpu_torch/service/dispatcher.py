"""Ingest-service dispatcher: worker registry + per-client work assignment.

The port's copy of ``petastorm_tpu/service/dispatcher.py:158-2222``: the same
assignment, QoS, recovery and HA decisions on the same inputs.  It imports
no ``torch``.

The dispatcher owns each client's deterministic plan stream (the client's
Ventilator feeds it :class:`~petastorm_tpu_torch.pool.VentilatedItem`\\ s over the
wire, in exactly the order the seeded :class:`~petastorm_tpu_torch.plan.ReadPlan`
produced them) and assigns items to registered workers, with the same
fault-tolerance semantics the in-process pools implement:

* a worker that disconnects or misses heartbeats has its in-flight items
  **requeued** onto surviving workers through the per-item attempt budget
  (``VentilatedItem.attempt`` rides the wire, so chaos injection and
  quarantine classification behave identically to the local pools);
* an item whose budget is spent surfaces to its client as a classified
  infrastructure failure (the client raises the same ``WorkerError`` the
  pools would);
* in-worker *data* failures (corrupt rowgroup, codec error) are forwarded
  to the client unchanged - ``on_error`` skip policies quarantine them
  client-side exactly as with a local pool.

Data-plane role: the dispatcher is a **buffer relay**.  Result frames are
parsed only to their control header (ordinal, rows, payload kind); the
column payload - the ~MBs of pixel data - is forwarded to the owning
client as opaque bytes, never decoded, never unpickled
(:mod:`petastorm_tpu_torch.service.protocol`).  Work items likewise cross the
dispatcher as :class:`~petastorm_tpu_torch.service.protocol.WireItem`\\ s:
structural scheduling metadata (ordinal, attempt, rowgroup-affinity key)
plus an opaque blob only the assigned worker opens.  The wire-encoding mix
is metered per relayed result (``service.frames_binary`` /
``frames_pickle_fallback`` / ``frames_shm``) so a hot pickle fallback is
visible, not silent.

Delivery is exactly-once per client: results are buffered until the client
**acks** them, so a dropped client connection replays unacked results on
reconnect and the client-side per-ordinal ledger dedups any overlap.

Rowgroup affinity: items are routed by a stable hash of their rowgroup so
repeated reads of one rowgroup (two clients on one dataset) prefer the same
worker - and co-located workers sharing a ``cache_type='shared'`` warm tier
decode each rowgroup once fleet-wide regardless.

Fleet sizing: clients piggyback their consumer starved-seconds (the
``queue.results_empty_wait_s`` signal petastorm_tpu_torch.autotune drives worker
counts with) and :meth:`Dispatcher.scaling_signal` turns the aggregate into
a grow/ok/shrink recommendation plus a ``service.scale_pressure`` gauge.
:class:`~petastorm_tpu_torch.service.autoscale.AutoscaleSupervisor` (CLI
``petastorm-tpu-torch-service autoscale``) closes the loop: it polls the signal
and spawns/retires local worker processes (or invokes an ``--exec-hook``
for k8s-style orchestrators).  Retirement is **graceful**: a worker sends a
``retiring`` frame, the dispatcher marks it draining (no new assignments),
the worker finishes its in-flight items, flushes its outbox, and says
``bye`` - so ``deterministic='seed'`` streams stay bit-identical through
scale events (docs/operations.md "Fleet autoscaling & QoS").

Multi-tenant QoS: client hellos carry a ``weight`` (long-run share within a
priority tier) and a ``priority`` (strict tiers: a lower tier is served
only while no higher tier has pending work).  Assignment is weighted
deficit-round-robin, so a greedy trainer cannot starve its peers - and
admission control (``max_clients``, ``max_client_inflight``) bounds what
any one client (or an unbounded client herd) can occupy.  Per-client
weights/priorities/assigned shares are exact and unbounded in
``stats()['qos']``; refusals and cap deferrals ride ``service.qos.*``
counters.

Crash recovery (docs/operations.md "Fault domains"): the dispatcher's
state is **reconstructible from its peers**, so its own death is a
recoverable event, not an epoch abort.  A fresh dispatcher starts empty;
then

* clients re-hello with their job blob and resync their per-ordinal
  in-flight ledgers (unresolved items are re-sent; the ledger and the
  client's in-order delivery keep delivery exactly-once and
  ``deterministic='seed'`` streams bit-identical through the outage) -
  counted as ``service.sessions_reconstructed``;
* workers rejoin (``--reconnect-attempts``) *without dropping their
  in-flight work*: the rejoin hello reports the assignments they are
  still executing, which the dispatcher records as **claims** so a
  client's resync re-attaches those ordinals to the executing worker
  instead of double-assigning them (``service.worker_rejoins`` /
  ``service.recovered_assignments``);
* a result finishing before its client has reconnected is buffered as an
  **orphan** (``service.orphan_results_buffered``) and replayed the moment
  the client's hello lands.

``journal_path`` arms the optional warm restart
(:mod:`petastorm_tpu_torch.service.journal`): sessions replay from disk before
the listener opens, and reconnecting clients are told which ordinals are
already held (``hello_ok``'s ``known`` list) so their resync skips
re-sends.

High availability (docs/operations.md "Dispatcher HA"): a second
dispatcher started with ``standby_of='host:port'`` (CLI ``--standby-of``)
is a **hot standby** - it tails the primary's session journal over the
wire (``standby_hello`` -> ``journal_sync`` frames, fed from
:meth:`ServiceJournal.attach_tail`; the journal mirror is live even
without a ``--journal`` file) and keeps every client session warm.  While
standing by it refuses client/worker hellos (serving only ``stats?``,
which reports its sync lag); when the primary dies - connection lost AND
re-sync probes refused, after at least one successful sync - it
**promotes**: adopts the mirrored sessions, bumps the fencing *epoch*
past the primary's, and serves.  Clients and workers reach it through a
failover address list (``service_address='primary:p,standby:p'``), so a
failover costs one re-hello against already-warm state instead of a full
peer reconstruction (``service.failovers`` counts promotions;
``service.standby_lag_items`` meters how far a standby trails).

Split-brain fencing: every ``hello_ok`` and heartbeat reply (``hb_ok``)
carries the dispatcher's monotonic **epoch**.  A plain restart keeps its
journal-stored epoch (peers accept an equal epoch); a promotion bumps to
``primary_epoch + 1``; peers remember the highest epoch they have seen
and refuse anything lower (``service.stale_epoch_refusals``) - so a
deposed primary that comes back after its standby took over is refused
by its own fleet, no matter how often it restarts from its own journal.

Redelivery-buffer bound: unacked result *bodies* are capped at
``replay_buffer_bytes`` (gauge ``service.replay_buffer_bytes``).  On
overflow the oldest already-sent (or disconnected-client) bodies degrade
to header-only tombstones (``service.replay_bodies_dropped``): they are
dropped from the replay set and from ``known`` ordinals, which forces the
client's resync to re-enqueue exactly those items - re-fetch instead of
replay, bounded memory instead of an unbounded body buffer.
"""

from __future__ import annotations

import collections
import logging
import os
import queue
import socket
import threading
import time
import uuid
import zlib
from typing import Any, Deque, Dict, List, Optional, Set, Tuple

from petastorm_tpu_torch.errors import DEFAULT_REQUEUE_ATTEMPTS, PetastormTpuError
from petastorm_tpu_torch.pool import VentilatedItem
from petastorm_tpu_torch.service.protocol import (PROTOCOL_VERSION,
                                            FrameClosedError, FrameSocket,
                                            LegacyPickleFrameError, WireItem,
                                            connect_frames, parse_address_list,
                                            resolve_auth_token, token_matches)
from petastorm_tpu_torch.service.wire import (SUPPORTED_CODECS, WireFormatError,
                                        negotiate_codec)
from petastorm_tpu_torch.telemetry import resolve as _resolve_telemetry

logger = logging.getLogger(__name__)

#: telemetry counter prefixes a worker heartbeat may fold into the
#: dispatcher's registry as ``service.fleet.<name>`` (fleet-wide decode /
#: cache accounting - the observable proof of decode-once sharing; the
#: ``service.`` entry folds the workers' own wire-encoding mix and stage
#: counters so encode-side behavior is visible at the control plane)
FLEET_COUNTER_PREFIXES = ("decode.", "worker.", "cache.", "io.", "service.",
                          "stage.service.")


def compute_recommendation(pressure: float, threshold: float, pending: int,
                           capacity: int, busy_fraction: float,
                           clients: int) -> str:
    """The grow/ok/shrink rule, shared by :meth:`Dispatcher.scaling_signal`
    and the autoscale supervisor's remote ``stats`` probes (so a supervisor
    overriding ``starved_threshold`` re-judges the same raw fields the
    dispatcher published, with no second copy of the rule).

    * ``grow``: connected clients are starved past ``threshold`` (or there
      is no capacity at all) **and work is actually queued** - growing a
      fleet with an empty queue adds idle workers no matter how starved
      the consumers are (their bottleneck is elsewhere, e.g. their own
      in-flight window or the wire).
    * ``shrink``: capacity exists but is essentially idle (busy < 10%,
      nothing pending, pressure well under threshold) - including a fleet
      whose clients all left.
    * else ``ok``.
    """
    if clients and pending > 0 and (pressure > threshold or not capacity):
        return "grow"
    if capacity and busy_fraction < 0.1 and pending == 0 \
            and pressure < threshold / 4:
        return "shrink"
    return "ok"


class _WorkerState:
    __slots__ = ("name", "conn", "capacity", "hostname", "inflight",
                 "last_heartbeat", "busy", "jobs_sent", "gone", "codecs",
                 "draining", "counters", "hists")

    def __init__(self, name: str, conn: FrameSocket, capacity: int,
                 hostname: str, codecs=()):
        self.name = name
        self.conn = conn
        self.capacity = max(1, int(capacity))
        self.hostname = hostname
        #: wire codecs this worker can compress BATCH bodies with
        self.codecs = tuple(codecs or ())
        #: (client_id, ordinal) assignments awaiting a result
        self.inflight: Set[Tuple[str, int]] = set()
        self.last_heartbeat = time.monotonic()
        self.busy = 0
        self.jobs_sent: Set[str] = set()
        self.gone = False
        #: graceful retirement: a draining worker finishes its in-flight
        #: items but is never assigned new ones (the ``retiring`` frame)
        self.draining = False
        #: fleet aggregation: cumulative per-worker counter totals (folded
        #: from heartbeat deltas) and the latest cumulative histogram
        #: snapshots the worker shipped - the raw material for the
        #: ``fleet?`` frame and the per-worker-labeled Prometheus families
        self.counters: Dict[str, float] = {}
        self.hists: Dict[str, Dict] = {}


class _Assignment:
    __slots__ = ("item", "worker", "assigned_at")

    def __init__(self, item: VentilatedItem, worker: str):
        self.item = item
        self.worker = worker
        self.assigned_at = time.monotonic()


class _ClientState:
    __slots__ = ("client_id", "conn", "factory", "hostname", "shm_ok",
                 "max_requeue", "pending", "inflight", "unacked", "rows",
                 "results", "requeued", "connected", "disconnected_at",
                 "codecs", "weight", "priority", "deficit", "assigned")

    def __init__(self, client_id: str, conn: Optional[FrameSocket],
                 factory: bytes, hostname: str, shm_ok: bool,
                 max_requeue: int, codecs=(), weight: float = 1.0,
                 priority: int = 0):
        self.client_id = client_id
        #: None for a journal-restored session awaiting its reconnect
        self.conn = conn
        self.factory = factory
        self.hostname = hostname
        self.shm_ok = shm_ok
        self.max_requeue = max_requeue
        #: wire codecs this client can decompress BATCH bodies of
        self.codecs = tuple(codecs or ())
        #: items awaiting assignment (requeues go to the FRONT so a
        #: recovered item does not wait behind a whole epoch)
        self.pending: Deque[WireItem] = collections.deque()
        #: ordinal -> _Assignment at a worker
        self.inflight: Dict[int, _Assignment] = {}
        #: ordinal -> outcome frame delivered but not yet acked (replayed
        #: verbatim on reconnect; bounded by the client's in-flight window)
        self.unacked: Dict[int, Dict] = {}
        self.rows = 0
        self.results = 0
        self.requeued = 0
        self.connected = True
        self.disconnected_at: Optional[float] = None
        #: QoS: long-run share within this client's priority tier (weighted
        #: deficit-round-robin) and its strict-priority tier (higher first)
        self.weight = max(1e-6, float(weight))
        self.priority = int(priority)
        #: the WDRR deficit counter: refilled by ``weight`` per scheduler
        #: round, spent one unit per assigned item, reset when the client's
        #: pending queue empties (classic DRR - no idle-time credit burst)
        self.deficit = 0.0
        #: total items ever assigned (exact + unbounded - the per-client
        #: telemetry counter names are capped, this is not)
        self.assigned = 0

    def known_ordinals(self) -> Set[int]:
        """Ordinals a resync must NOT re-enqueue.  Body-dropped unacked
        tombstones (``_stale``) are excluded on purpose: their outcome can
        no longer be replayed, so the resync re-enqueueing them IS the
        documented re-fetch path of the bounded redelivery buffer."""
        known = set(self.inflight)
        known.update(o for o, out in self.unacked.items()
                     if not out.get("_stale"))
        known.update(i.ordinal for i in self.pending)
        return known


class Dispatcher:
    """The ingest-service control plane (one process serves many clients).

    ``heartbeat_timeout_s``: a worker silent this long is declared dead and
    its in-flight items requeue (socket EOF - the common death - is
    detected immediately; the timeout covers a worker whose heartbeat
    thread died with the process).  A worker wedged INSIDE user decode/IO
    code keeps heartbeating - that failure mode needs
    ``assignment_deadline_s``: when set, an assignment with no outcome for
    that long declares its worker hung and drops it (connection closed ->
    the worker process exits; its items requeue through the budget) - the
    service-plane analog of the process pool's SIGKILL-and-respawn.  Off
    by default, like ``item_deadline_s`` locally; size it WELL above the
    slowest legitimate rowgroup decode.
    ``client_grace_s``: a disconnected client's state (pending + in-flight
    + unacked results) is kept this long for a reconnect before purging.
    ``max_requeue_attempts``: default per-item budget; each client's hello
    may carry its own (the reader's ``on_error`` policy budget travels with
    the job, keeping service and in-process semantics identical).
    ``auth_token``: shared handshake secret; defaults to
    ``$PETASTORM_TPU_SERVICE_TOKEN``.  When set, every hello (worker,
    client, stats) must present it or the connection is refused.  The v2
    wire is pickle-free binary frames (the token gates who may ship jobs
    to the fleet, not frame parsing) - see the protocol module's
    trust-boundary notes.
    ``wire_codec``: BATCH-body compression policy, negotiated per
    (worker, client) pair at job time - ``'auto'`` (default; compress
    cross-host hops only), ``'off'``, or a codec name to force it
    everywhere both ends support it.  Defaults to
    ``$PETASTORM_TPU_SERVICE_COMPRESSION`` when unset.
    ``journal_path``: arm the warm-restart session journal (CLI
    ``--journal``; see :mod:`petastorm_tpu_torch.service.journal`) - cold
    recovery from peers works without it.
    ``journal_fsync``: fsync the journal file per appended record (CLI
    ``--journal-fsync``; metered as ``service.journal_fsyncs``).  Default
    off: the flush-per-record journal already survives a process death,
    and the fsync only buys back the OS-buffered tail a host power-loss
    would eat - at a device round-trip per control-plane record.  Turn it
    on when a standby will warm-restart from this file and the host (not
    just the process) is in the fault model.
    ``standby_of``: run as a HOT STANDBY of the primary at this
    ``'host:port'`` (or failover list): tail its journal over the wire,
    refuse client/worker hellos until the primary dies, then promote with
    a bumped fencing epoch (module docstring; CLI ``--standby-of``).
    ``replay_buffer_bytes``: cap on retained unacked result *bodies*
    across all clients; overflow degrades the oldest to header-only
    tombstones whose clients re-fetch on reconnect (module docstring).
    ``starved_threshold``: the pressure level (starved-seconds per second)
    above which :meth:`scaling_signal` recommends ``grow`` (CLI
    ``--starved-threshold``); defaults to the in-process autotune loop's
    ``AutotunePolicy.starved_threshold`` so the fleet and a local pool
    judge "the worker plane is the bottleneck" identically.
    ``max_clients``: admission control - a NEW client hello past this many
    CONNECTED sessions is refused (``service.qos.admission_refused``;
    reconnects of admitted sessions always pass, and a crashed trainer
    riding out its reconnect grace does not hold a seat against its
    replacement).  Note a dispatcher restart re-admits sessions
    first-come-first-served, so a herd larger than the cap can lose
    members across a restart.  Default None = unbounded.
    ``max_client_inflight``: per-client cap on items in flight at workers;
    a client at the cap is skipped by the assignment loop until results
    return (``service.qos.capped_deferrals``), so one greedy trainer with
    a huge window degrades itself, not the fleet.  Default None = bounded
    only by the client's own window.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 telemetry=None,
                 heartbeat_timeout_s: float = 10.0,
                 client_grace_s: float = 30.0,
                 max_requeue_attempts: int = DEFAULT_REQUEUE_ATTEMPTS,
                 assignment_deadline_s: Optional[float] = None,
                 metrics_port: Optional[int] = None,
                 auth_token: Optional[str] = None,
                 wire_codec: Optional[str] = None,
                 journal_path: Optional[str] = None,
                 journal_fsync: bool = False,
                 standby_of: Optional[str] = None,
                 replay_buffer_bytes: int = 256 << 20,
                 starved_threshold: Optional[float] = None,
                 max_clients: Optional[int] = None,
                 max_client_inflight: Optional[int] = None):
        if assignment_deadline_s is not None and assignment_deadline_s <= 0:
            raise PetastormTpuError(
                "assignment_deadline_s must be > 0 or None")
        if starved_threshold is not None and starved_threshold < 0:
            raise PetastormTpuError("starved_threshold must be >= 0 or None")
        if max_clients is not None and max_clients < 1:
            raise PetastormTpuError("max_clients must be >= 1 or None")
        if max_client_inflight is not None and max_client_inflight < 1:
            raise PetastormTpuError(
                "max_client_inflight must be >= 1 or None")
        if wire_codec is None:
            wire_codec = os.environ.get(
                "PETASTORM_TPU_SERVICE_COMPRESSION", "auto")
        if wire_codec not in ("auto", "off") + SUPPORTED_CODECS:
            raise PetastormTpuError(
                f"wire_codec must be 'auto', 'off' or one of"
                f" {SUPPORTED_CODECS}; got {wire_codec!r}")
        self._wire_codec = wire_codec
        self._host = host
        self._requested_port = port
        self._heartbeat_timeout_s = float(heartbeat_timeout_s)
        self._client_grace_s = float(client_grace_s)
        self._assignment_deadline_s = assignment_deadline_s
        self._starved_threshold = starved_threshold
        self._max_clients = max_clients
        self._max_client_inflight = max_client_inflight
        self._max_requeue = int(max_requeue_attempts)
        self._auth_token = resolve_auth_token(auth_token)
        self.telemetry = _resolve_telemetry(telemetry)
        self._lock = threading.RLock()
        self._workers: Dict[str, _WorkerState] = {}
        self._clients: Dict[str, _ClientState] = {}
        self._client_order: List[str] = []  # round-robin fairness cursor
        self._rr = 0
        self._stop_event = threading.Event()
        self._threads: List[threading.Thread] = []
        self._listener: Optional[socket.socket] = None
        self.port: Optional[int] = None
        self._started_at = time.monotonic()
        #: (monotonic, starved_s delta) reports from clients - the fleet
        #: pressure window (scaling_signal)
        self._starved_reports: Deque[Tuple[float, float]] = collections.deque(
            maxlen=512)
        self._worker_seq = 0
        self._client_counter_ids: Set[str] = set()
        self._counter_cap_warned = False
        self._metrics_port = metrics_port
        self.metrics_server = None
        #: identifies THIS dispatcher process across restarts: rides every
        #: client hello_ok so peers can count service.dispatcher_restarts
        self.boot_id = uuid.uuid4().hex[:12]
        #: (client_id, ordinal) -> (worker name, claimed-at) for rejoining
        #: workers' still-executing assignments whose client has not
        #: reconnected yet (honored at resync; swept after client_grace_s)
        self._claims: Dict[Tuple[str, int], Tuple[str, float]] = {}
        #: (client_id, ordinal) -> (outcome frame, buffered-at) for results
        #: that finished before their client reconnected
        self._orphan_results: Dict[Tuple[str, int], Tuple[Dict, float]] = {}
        #: retained result-body accounting (the bounded redelivery buffer):
        #: insertion-ordered (cid, outcome-dict) refs + live byte total
        self._replay_order: Deque[Tuple[str, Dict]] = collections.deque()
        self._replay_bytes = 0
        self._replay_cap = int(replay_buffer_bytes)
        self._journal = None
        self._journal_path = journal_path
        self._journal_fsync = bool(journal_fsync)
        # -- hot-standby HA state (module docstring "High availability") --
        self._standby_of = standby_of
        if standby_of is not None:
            parse_address_list(standby_of)  # fail fast on a bad address
        #: True while this dispatcher is a warm follower (refusing client/
        #: worker hellos); flips False exactly once, at promotion
        self._standby = standby_of is not None
        #: split-brain fencing epoch: rides every hello_ok / hb_ok; a
        #: restart keeps its journal-stored value, a promotion bumps past
        #: the primary's, and peers refuse anything below their max seen
        self.epoch = 1
        #: set when a standby promotes itself to primary (tests/operators)
        self.standby_promoted = threading.Event()
        self._primary_epoch = 0
        self._primary_boot: Optional[str] = None
        self._standby_synced = 0
        self._standby_lag = 0
        self._sync_warned = False
        #: primary-side standby health: peer address -> last journal seq
        #: fed to it (stats()['ha'] derives standby_lag_items from the gap
        #: to the live journal seq, so an operator sees standby sync state
        #: from the PRIMARY's one-shot stats probe)
        self._standby_feeds: Dict[str, int] = {}
        #: bounded fleet event log (tentpole d): structured control-plane
        #: events (promotions, fencing refusals, requeues, drains, worker
        #: lifecycle, autoscale decisions) - served by the ``events?``
        #: frame so a failing client can capture the fleet's last ~60s
        self._events: Deque[Dict] = collections.deque(maxlen=512)
        # -- service.* telemetry (rides the registry -> Prometheus/--watch) --
        tele = self.telemetry
        self._g_workers = tele.gauge("service.registered_workers")
        self._g_clients = tele.gauge("service.connected_clients")
        self._g_pending = tele.gauge("service.pending_items")
        self._g_inflight = tele.gauge("service.inflight_items")
        self._g_pressure = tele.gauge("service.scale_pressure")
        self._m_assigned = tele.counter("service.assigned_items")
        self._m_completed = tele.counter("service.completed_items")
        self._m_requeued = tele.counter("service.requeued_items")
        self._m_failures = tele.counter("service.forwarded_failures")
        self._m_dup = tele.counter("service.duplicate_results")
        self._m_bytes_in = tele.counter("service.frame_bytes_received")
        self._m_bytes_out = tele.counter("service.frame_bytes_sent")
        self._m_rows = tele.counter("service.client_rows")
        # wire-encoding mix of relayed results: the pickle fallback being
        # hot must be VISIBLE (ci.sh asserts frames_pickle_fallback == 0
        # on the result path of its smoke topology)
        self._m_frames_bin = tele.counter("service.frames_binary")
        self._m_frames_pkl = tele.counter("service.frames_pickle_fallback")
        self._m_frames_shm = tele.counter("service.frames_shm")
        # -- crash-recovery observability (module docstring) --
        self._m_sessions_rec = tele.counter("service.sessions_reconstructed")
        self._m_worker_rejoins = tele.counter("service.worker_rejoins")
        self._m_recovered = tele.counter("service.recovered_assignments")
        self._m_resync_restored = tele.counter(
            "service.resync_items_restored")
        self._m_orphans = tele.counter("service.orphan_results_buffered")
        self._m_replay_dropped = tele.counter("service.replay_bodies_dropped")
        self._m_refetches = tele.counter("service.replay_refetches_forced")
        self._m_journal_items = tele.counter("service.journal_items_restored")
        self._g_replay_bytes = tele.gauge("service.replay_buffer_bytes")
        # -- multi-tenant QoS observability (module docstring) --
        self._m_admission_refused = tele.counter(
            "service.qos.admission_refused")
        self._m_capped_deferrals = tele.counter("service.qos.capped_deferrals")
        self._m_drains = tele.counter("service.qos.workers_draining")
        self._g_priority_tiers = tele.gauge("service.qos.priority_tiers")
        # -- hot-standby HA observability (module docstring) --
        self._m_failovers = tele.counter("service.failovers")
        self._m_journal_fsyncs = tele.counter("service.journal_fsyncs")
        self._m_standby_refused = tele.counter("service.standby_hello_refused")
        self._g_standby_lag = tele.gauge("service.standby_lag_items")
        self._g_epoch = tele.gauge("service.epoch")

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "Dispatcher":
        """Bind the listener (``self.port`` is then live) and start the
        accept + monitor threads; returns self for chaining.  With a
        ``journal_path``, sessions replay from disk BEFORE the listener
        opens - a reconnecting client never races its own restoration."""
        if self._standby:
            # a standby's state arrives over journal_sync, never from its
            # own file: the journal stays an unloaded in-memory mirror
            # until promotion opens (and compacts warm state into) the file
            from petastorm_tpu_torch.service.journal import ServiceJournal

            self._journal = ServiceJournal(
                self._journal_path, fsync=self._journal_fsync,
                fsync_counter=self._m_journal_fsyncs)
        else:
            self._restore_journal()
        self._g_epoch.set(self.epoch)
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind((self._host, self._requested_port))
        listener.listen(64)
        listener.settimeout(0.2)
        self._listener = listener
        self.port = listener.getsockname()[1]
        for target, name in ((self._accept_loop, "accept"),
                             (self._monitor_loop, "monitor")):
            t = threading.Thread(target=target, daemon=True,
                                 name=f"petastorm-torch-dispatcher-{name}")
            t.start()
            self._threads.append(t)
        if self._metrics_port is not None and self.telemetry.enabled:
            from petastorm_tpu_torch.telemetry.export import MetricsExportServer

            self.metrics_server = MetricsExportServer(
                self.telemetry, port=self._metrics_port,
                extra=self._fleet_prometheus)
            self.metrics_server.start()
        logger.info("Dispatcher listening on %s:%d", self._host, self.port)
        if self._standby:
            t = threading.Thread(target=self._standby_loop, daemon=True,
                                 name="petastorm-torch-dispatcher-standby")
            t.start()
            self._threads.append(t)
            logger.info("Dispatcher is a hot STANDBY of %s (refusing client/"
                        "worker hellos until promotion)", self._standby_of)
        if self._auth_token is None and self._host not in (
                "127.0.0.1", "localhost", "::1"):
            logger.warning(
                "Dispatcher is listening on %s with NO auth token: anyone"
                " who can reach this port can register as a client and ship"
                " a worker factory the fleet will execute (the v2 binary"
                " wire removed unpickle-on-parse, not the execute-client-"
                "jobs feature).  Restrict to a trusted network and set"
                " $PETASTORM_TPU_SERVICE_TOKEN (docs/operations.md"
                " 'Disaggregated ingest service').", self._host)
        return self

    def _restore_journal(self) -> None:
        """Warm restart: rebuild client sessions from the journal file (see
        :mod:`petastorm_tpu_torch.service.journal`).  Restored clients start
        disconnected with the grace timer running - one that never
        reconnects purges like any dropped client.  With ``journal_path``
        None the journal is still created as a pure in-memory mirror - the
        live record stream a hot standby tails needs no file."""
        from petastorm_tpu_torch.service.journal import ServiceJournal

        self._journal = ServiceJournal(
            self._journal_path, fsync=self._journal_fsync,
            fsync_counter=self._m_journal_fsyncs)
        sessions = self._journal.load()
        with self._lock:
            restored_items = self._adopt_sessions_locked(sessions)
        # a plain restart KEEPS its stored epoch (peers accept an equal
        # epoch): only promotions bump, so a deposed primary can restart
        # from its own journal forever and still sit below its successor
        self.epoch = self._journal.epoch or 1
        self._journal.set_epoch(self.epoch)
        self._journal.open()
        if sessions:
            logger.info("journal restored %d session(s) with %d unresolved"
                        " item(s); clients have %.0fs to reconnect",
                        len(sessions), restored_items, self._client_grace_s)

    def _adopt_sessions_locked(self, sessions) -> int:
        """Turn journal-mirror sessions into disconnected client states
        awaiting their re-hello (warm restart AND standby promotion; caller
        holds the lock).  Sessions already registered - a client whose
        hello raced a promotion - are left alone."""
        now = time.monotonic()
        restored_items = 0
        for cid, session in sessions.items():
            if cid in self._clients:
                continue
            hello = session.hello
            client = _ClientState(
                cid, None, hello.get("factory"),
                hello.get("hostname", ""), bool(hello.get("shm_ok")),
                int(hello.get("max_requeue", self._max_requeue)),
                codecs=hello.get("codecs") or (),
                weight=hello.get("weight", 1.0),
                priority=hello.get("priority", 0))
            client.connected = False
            client.disconnected_at = now
            for item in session.items.values():
                try:
                    client.pending.append(WireItem.from_wire(item))
                except WireFormatError:
                    continue  # fuzzed/foreign record: skip, don't crash
                restored_items += 1
            self._clients[cid] = client
            self._client_order.append(cid)
        if restored_items:
            self._m_journal_items.add(restored_items)
        return restored_items

    # -- fleet event log (tentpole d) ------------------------------------------

    def _event(self, kind: str, src: str = "dispatcher", **fields) -> None:
        """Append one structured event to the bounded fleet log.  Wall-clock
        stamped (events are read by humans correlating across machines);
        the deque's maxlen drops the oldest on overflow - the log is a
        flight-data tail, not an audit trail."""
        ev = {"ts": round(time.time(), 3), "src": src, "kind": kind}
        ev.update(fields)
        self._events.append(ev)

    def events_tail(self, n: int = 256) -> List[Dict]:
        """The last ``n`` fleet events, oldest first (the ``events?``
        frame's payload; also folded into client flight records on a
        terminal failure)."""
        with self._lock:
            evs = list(self._events)
        return evs[-max(0, int(n)):]

    def _on_peer_event(self, msg: Dict, src: Optional[str] = None) -> None:
        """Fold one event reported by a peer (autoscale supervisor ``event``
        frames, worker heartbeat piggybacks) into the fleet log.  Only
        plain scalar fields are kept and the field count is capped - a
        peer cannot bloat the bounded log's entries."""
        if not isinstance(msg, dict):
            return
        kind = msg.get("kind")
        if not isinstance(kind, str) or not kind:
            return
        fields = {}
        for k, v in msg.items():
            if k in ("t", "kind", "token", "ts", "src"):
                continue
            if isinstance(v, (str, int, float, bool)) and len(fields) < 8:
                fields[str(k)[:32]] = v[:200] if isinstance(v, str) else v
        self._event(kind[:64], src=src or str(msg.get("src", "peer"))[:64],
                    **fields)

    # -- hot-standby HA (module docstring "High availability") -----------------

    #: live-tail records a slow standby may queue before the primary drops
    #: it (the standby then reconnects and re-snapshots - bounded memory
    #: beats an unbounded backlog for a follower that cannot keep up)
    _STANDBY_QUEUE_MAX = 10000
    #: snapshot records per journal_sync frame (a frame stays control-sized)
    _SYNC_CHUNK = 256
    #: consecutive failed re-sync attempts (connect + standby_ok) before a
    #: once-synced standby declares the primary dead and promotes
    _PROMOTE_AFTER_FAILS = 3

    def _standby_feed_loop(self, conn: FrameSocket, hello: Dict) -> None:
        """Primary side: stream the journal (snapshot, then the live tail)
        to one subscribed standby as ``journal_sync`` frames.  Runs on the
        standby's connection thread until either end dies or the standby
        falls irrecoverably behind (queue overflow -> disconnect; it
        reconnects and re-snapshots)."""
        if hello.get("protocol") != PROTOCOL_VERSION:
            conn.send({"t": "error", "error": "protocol version mismatch"})
            conn.close()
            return
        peer = hello.get("standby") or "?"
        q: "queue.Queue" = queue.Queue(maxsize=self._STANDBY_QUEUE_MAX)
        overflow = threading.Event()

        def tail(seq: int, rec: Dict) -> None:
            try:
                q.put_nowait((seq, rec))
            except queue.Full:
                overflow.set()

        snapshot, seq = self._journal.attach_tail(tail)
        with self._lock:
            self._standby_feeds[peer] = 0
        self._event("standby_subscribed", standby=peer,
                    snapshot_records=len(snapshot))
        logger.info("Standby %s subscribed to the journal tail (%d snapshot"
                    " record(s), seq %d)", peer, len(snapshot), seq)
        try:
            conn.send({"t": "standby_ok", "epoch": self.epoch,
                       "boot": self.boot_id})
            for i in range(0, len(snapshot), self._SYNC_CHUNK):
                chunk = snapshot[i:i + self._SYNC_CHUNK]
                try:
                    conn.send({"t": "journal_sync", "k": "snap",
                               "recs": chunk, "seq": seq})
                except WireFormatError:
                    # a record outside the wire domain poisons its whole
                    # chunk: retry singly so one bad hello costs one
                    # session's warmth, not the sync
                    for rec in chunk:
                        try:
                            conn.send({"t": "journal_sync", "k": "snap",
                                       "recs": [rec], "seq": seq})
                        except WireFormatError:
                            logger.warning("journal_sync: unencodable"
                                           " snapshot record skipped (%r)",
                                           rec.get("r"))
            conn.send({"t": "journal_sync", "k": "snap_end", "seq": seq})
            with self._lock:
                self._standby_feeds[peer] = seq
            while not self._stop_event.is_set():
                if overflow.is_set():
                    logger.warning(
                        "Standby %s fell > %d record(s) behind the journal"
                        " tail; disconnecting it to force a re-snapshot",
                        peer, self._STANDBY_QUEUE_MAX)
                    break
                try:
                    rec_seq, rec = q.get(timeout=0.5)
                except queue.Empty:
                    # idle keepalive: carries the LIVE journal seq, so the
                    # standby can meter any backlog as lag.  An empty feed
                    # queue means the standby has everything we appended -
                    # record it as fully fed
                    live_seq = self._journal.seq
                    conn.send({"t": "journal_sync", "k": "ping",
                               "seq": live_seq})
                    with self._lock:
                        self._standby_feeds[peer] = live_seq
                    continue
                try:
                    conn.send({"t": "journal_sync", "k": "rec", "rec": rec,
                               "seq": rec_seq})
                    with self._lock:
                        self._standby_feeds[peer] = rec_seq
                except WireFormatError:
                    logger.warning("journal_sync: unencodable tail record"
                                   " skipped (%r)", rec.get("r"))
        except (OSError, FrameClosedError):
            pass  # standby went away; it reconnects (or promoted)
        finally:
            self._journal.detach_tail(tail)
            with self._lock:
                self._standby_feeds.pop(peer, None)
            self._event("standby_unsubscribed", standby=peer)
            conn.close()

    def _standby_loop(self) -> None:
        """Standby side: keep a sync session against the primary; when the
        primary is gone (connection lost AND :data:`_PROMOTE_AFTER_FAILS`
        consecutive re-sync attempts fail) promote.  Never promotes before
        the FIRST successful sync: a standby that cannot reach a healthy
        primary at boot must wait, not seize an empty fleet."""
        targets = parse_address_list(self._standby_of)
        synced_ever = False
        fails = 0
        while not self._stop_event.is_set() and self._standby:
            contact = False
            for addr in targets:
                if self._standby_sync(addr):
                    synced_ever = True
                    fails = 0
                    contact = True
                    break
            if self._stop_event.is_set() or not self._standby:
                return
            if not contact:
                fails += 1
                if synced_ever and fails >= self._PROMOTE_AFTER_FAILS:
                    self._promote(f"primary {self._standby_of} unreachable"
                                  f" after {fails} re-sync attempt(s)")
                    return
            self._stop_event.wait(0.3)

    def _standby_sync(self, addr: Tuple[str, int]) -> bool:
        """One sync session: subscribe, ingest the snapshot, follow the
        tail until the stream dies.  Returns True when the primary
        answered ``standby_ok`` (contact - even if the stream later broke:
        only answer-less attempts count toward promotion)."""
        try:
            conn = connect_frames(addr, timeout=2.0)
        except OSError:
            return False
        contact = False
        try:
            conn.send({"t": "standby_hello", "protocol": PROTOCOL_VERSION,
                       "token": self._auth_token,
                       "standby": f"{self._host}:{self.port}"})
            ok = conn.recv(timeout=5.0)
            if not isinstance(ok, dict) or ok.get("t") != "standby_ok":
                if isinstance(ok, dict) and ok.get("t") == "error":
                    self._m_standby_refused.add(1)
                    logger.warning("Primary refused the standby"
                                   " subscription: %s", ok.get("error"))
                return False
            contact = True
            self._primary_epoch = max(self._primary_epoch,
                                      int(ok.get("epoch") or 1))
            self._primary_boot = ok.get("boot")
            # fresh snapshot incoming: drop whatever the last session left
            self._journal.reset()
            self._standby_synced = 0
            stream_pos = 0
            last_rx = time.monotonic()
            silence_limit = max(2.0, self._heartbeat_timeout_s)
            while not self._stop_event.is_set() and self._standby:
                msg = conn.recv(timeout=0.5)
                now = time.monotonic()
                if msg is None:
                    if now - last_rx > silence_limit:
                        logger.warning("journal_sync stream from %s:%d went"
                                       " silent for %.1fs; dropping it",
                                       addr[0], addr[1], now - last_rx)
                        return True
                    continue
                last_rx = now
                if not isinstance(msg, dict) or msg.get("t") != "journal_sync":
                    continue
                k, seq = msg.get("k"), msg.get("seq")
                if k == "snap":
                    for rec in msg.get("recs") or ():
                        self._journal.ingest(rec)
                        self._standby_synced += 1
                elif k == "rec":
                    self._journal.ingest(msg.get("rec"))
                    self._standby_synced += 1
                    if isinstance(seq, int):
                        stream_pos = seq
                elif k == "snap_end":
                    if isinstance(seq, int):
                        stream_pos = seq
                    self._standby_lag = 0
                    self._g_standby_lag.set(0)
                    logger.info("Standby warm: %d record(s) synced from"
                                " %s:%d (primary epoch %d)",
                                self._standby_synced, addr[0], addr[1],
                                self._primary_epoch)
                elif k == "ping" and isinstance(seq, int):
                    # ping carries the primary's LIVE seq; anything above
                    # our stream position is backlog we have not received
                    self._standby_lag = max(0, seq - stream_pos)
                    self._g_standby_lag.set(self._standby_lag)
        except (OSError, FrameClosedError):
            pass  # stream died: the outer loop probes, then promotes
        except (WireFormatError, PetastormTpuError) as exc:
            # mid-stream garbage (a cut frame, an undecodable record): the
            # warm mirror can no longer be trusted.  Degrade to a cold
            # re-snapshot - warned ONCE, never a crash or a desynced mirror
            if not self._sync_warned:
                self._sync_warned = True
                logger.warning(
                    "journal_sync stream from %s:%d was undecodable (%s);"
                    " dropping the warm mirror and re-snapshotting (a"
                    " promotion before the re-sync completes falls back to"
                    " cold peer reconstruction)", addr[0], addr[1], exc)
            self._journal.reset()
            self._standby_synced = 0
        finally:
            conn.close()
        return contact

    def _promote(self, reason: str) -> None:
        """Standby -> primary: adopt the mirrored sessions, fence the old
        primary out by bumping the epoch past anything it ever advertised,
        and start serving hellos."""
        with self._lock:
            if not self._standby:
                return
            self._standby = False
            self.epoch = max(self.epoch, self._primary_epoch + 1,
                             self._journal.epoch + 1)
            sessions = self._journal.sessions()
            restored = self._adopt_sessions_locked(sessions)
        self._journal.set_epoch(self.epoch)
        try:
            # persist the adopted state (and the new epoch) to this
            # dispatcher's OWN journal file, when it has one
            self._journal.open()
        except OSError:
            logger.warning("could not open the journal file after"
                           " promotion; serving without one", exc_info=True)
        self._m_failovers.add(1)
        self._g_epoch.set(self.epoch)
        self._g_standby_lag.set(0)
        self._event("promotion", reason=reason, epoch=self.epoch,
                    sessions=len(sessions), restored_items=restored)
        self.standby_promoted.set()
        logger.warning(
            "STANDBY PROMOTED to primary (%s): epoch %d, %d warm session(s)"
            " with %d pending item(s); serving at %s:%d", reason, self.epoch,
            len(sessions), restored, self._host, self.port)
        self._stamp_gauges()

    def stop(self) -> None:
        """Close the listener and every live connection; workers and
        clients see EOF immediately."""
        self._stop_event.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        with self._lock:
            conns = ([w.conn for w in self._workers.values()]
                     + [c.conn for c in self._clients.values()
                        if c.connected and c.conn is not None])
        for conn in conns:
            conn.close()
        if self.metrics_server is not None:
            self.metrics_server.stop()
        if self._journal is not None:
            self._journal.close()

    def join(self, timeout: float = 5.0) -> None:
        """Bounded wait for the service threads after :meth:`stop`."""
        deadline = time.monotonic() + timeout
        for t in self._threads:
            t.join(max(0.0, deadline - time.monotonic()))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        self.join()

    # -- connection handling --------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop_event.is_set():
            try:
                sock, _addr = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listener closed at stop
            t = threading.Thread(target=self._serve_conn,
                                 args=(FrameSocket(sock),), daemon=True,
                                 name="petastorm-torch-dispatcher-conn")
            t.start()
            # prune finished connection threads as we go: a long-lived
            # dispatcher probed by `stats` every few seconds would otherwise
            # accumulate dead Thread objects for its whole lifetime
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)

    def _serve_conn(self, conn: FrameSocket) -> None:
        try:
            hello = conn.recv(timeout=10.0)
        except LegacyPickleFrameError:
            # a v1 (pickled-wire) peer, detected WITHOUT unpickling it:
            # answer in the one format it can read so it fails loudly with
            # the version message instead of desyncing or hanging
            logger.warning("Refusing legacy v1 (pickled-frame) peer: this"
                           " dispatcher speaks the v2 binary wire")
            try:
                conn.send_legacy_error(
                    "protocol version mismatch: this dispatcher speaks the"
                    f" v2 binary wire (PROTOCOL_VERSION {PROTOCOL_VERSION});"
                    " upgrade the client/worker")
            except OSError:
                pass
            conn.close()
            return
        except Exception:  # noqa: BLE001 - drop bad conns (EOF, garbage)
            conn.close()
            return
        if hello is None or self._stop_event.is_set():
            # a connection that raced the accept loop against stop() must be
            # refused here: sending hello_ok and then never reading would
            # leave the peer waiting on a silent live socket
            conn.close()
            return
        kind = hello.get("t")
        if not token_matches(self._auth_token, hello.get("token")):
            # auth gate before ANY hello processing: an untokened peer gets
            # a refusal and a closed socket, never a registered state
            logger.warning("Refusing %r connection: bad/missing auth token",
                           kind)
            if self.telemetry.enabled:
                self.telemetry.counter("service.auth_rejected").add(1)
            try:
                conn.send({"t": "error", "error": "bad auth token"})
            except OSError:
                pass
            conn.close()
            return
        try:
            if self._standby and kind in ("worker_hello", "client_hello"):
                # a standby serves stats? and journal subscriptions only;
                # peers treat this refusal as a failed attempt and rotate
                # to the next address in their failover list
                self._event("fencing_refusal", peer=kind,
                            why="standing by", epoch=self.epoch)
                try:
                    conn.send({"t": "error", "error":
                               "dispatcher is a hot standby (of"
                               f" {self._standby_of}); not serving until"
                               " promoted"})
                except OSError:
                    pass
                conn.close()
            elif kind == "worker_hello":
                self._worker_loop(conn, hello)
            elif kind == "client_hello":
                self._client_loop(conn, hello)
            elif kind == "standby_hello":
                self._standby_feed_loop(conn, hello)
            elif kind == "stats?":
                conn.send({"t": "stats", "stats": self.stats()})
                conn.close()
            elif kind == "fleet?":
                conn.send({"t": "fleet", "fleet": self.fleet_stats()})
                conn.close()
            elif kind == "events?":
                n = hello.get("n")
                conn.send({"t": "events", "events": self.events_tail(
                    n if isinstance(n, int) else 256)})
                conn.close()
            elif kind == "event":
                # control-plane peers (the autoscale supervisor) report
                # decisions into the fleet event log over one-shot conns
                self._on_peer_event(hello)
                conn.send({"t": "event_ok"})
                conn.close()
            else:
                logger.warning("Dropping connection with bad hello %r", kind)
                conn.close()
        except FrameClosedError:
            pass
        except Exception:  # noqa: BLE001 - one bad conn must not kill serving
            if not self._stop_event.is_set():
                logger.warning("Dispatcher connection handler failed",
                               exc_info=True)

    # -- worker side ----------------------------------------------------------

    def _worker_loop(self, conn: FrameSocket, hello: Dict) -> None:
        if hello.get("protocol") != PROTOCOL_VERSION:
            conn.send({"t": "error", "error": "protocol version mismatch"})
            conn.close()
            return
        with self._lock:
            self._worker_seq += 1
            name = hello.get("worker") or f"worker-{self._worker_seq}"
            if name in self._workers:
                name = f"{name}-{self._worker_seq}"
            state = _WorkerState(name, conn, hello.get("capacity", 1),
                                 hello.get("hostname", ""),
                                 codecs=hello.get("codecs") or ())
            self._workers[name] = state
            self._g_workers.set(len(self._workers))
            recovered = self._absorb_worker_rejoin_locked(state, hello)
        # clock_ns: the dispatcher's monotonic clock at reply time - peers
        # estimate their offset to it from the handshake round-trip, the
        # skew anchor for merging cross-process trace stamps
        conn.send({"t": "hello_ok", "worker": name, "epoch": self.epoch,
                   "clock_ns": time.perf_counter_ns()})
        self._event("worker_join", worker=name,
                    rejoin=bool(hello.get("resume")),
                    capacity=state.capacity)
        if hello.get("resume"):
            self._m_worker_rejoins.add(1)
            logger.info("Worker %s REJOINED still executing %d item(s)"
                        " (%d re-attached, rest claimed for reconnecting"
                        " clients)", name,
                        len(hello.get("assignments") or ()), recovered)
        else:
            logger.info("Worker %s registered (capacity %d, host %s)", name,
                        state.capacity, state.hostname or "?")
        self._pump()
        bytes_folded = 0
        try:
            while not self._stop_event.is_set():
                msg = conn.recv(timeout=1.0)
                if conn.bytes_received > bytes_folded:
                    self._m_bytes_in.add(conn.bytes_received - bytes_folded)
                    bytes_folded = conn.bytes_received
                if msg is None:
                    continue
                kind = msg.get("t")
                if kind == "heartbeat":
                    self._on_heartbeat(state, msg)
                elif kind == "result":
                    self._on_result(state, msg)
                elif kind == "failure":
                    self._on_worker_failure(state, msg)
                elif kind == "retiring":
                    self._on_retiring(state)
                elif kind == "drained?":
                    self._on_drain_probe(state)
                elif kind == "bye":
                    break
        except FrameClosedError:
            pass
        finally:
            self._worker_gone(name)

    def _absorb_worker_rejoin_locked(self, state: _WorkerState,
                                     hello: Dict) -> int:
        """Re-attach a rejoining worker's still-executing assignments so
        nothing is double-assigned (caller holds the lock).

        Three cases per reported ``(client, ordinal, attempt)``:

        * the client is known and the ordinal is in-flight at a worker
          that no longer exists (the pre-restart assignment) - or pending
          (journal-restored) - the assignment moves to this worker;
        * the client is known and the ordinal is in-flight at a LIVE other
          worker: the dispatcher already requeued it past this worker (a
          worker-link blip, not a dispatcher restart) - the claim is
          stale, this worker's eventual result dedups;
        * the client is unknown (it has not reconnected yet): recorded in
          ``_claims`` and honored when its resync arrives.

        ``jobs`` marks which client factories the worker still holds, so
        the pump does not re-ship them.
        """
        state.jobs_sent.update(str(c) for c in hello.get("jobs") or ())
        now = time.monotonic()
        recovered = 0
        for entry in hello.get("assignments") or ():
            if not (isinstance(entry, (list, tuple)) and len(entry) >= 2):
                continue
            cid, ordinal = str(entry[0]), entry[1]
            if not isinstance(ordinal, int):
                continue
            client = self._clients.get(cid)
            if client is None:
                self._claims[(cid, ordinal)] = (state.name, now)
                continue
            assign = client.inflight.get(ordinal)
            if assign is not None:
                holder = self._workers.get(assign.worker)
                if holder is None or holder is state:
                    assign.worker = state.name
                    assign.assigned_at = now
                    state.inflight.add((cid, ordinal))
                    recovered += 1
                continue
            if ordinal in client.unacked:
                continue  # already completed: the worker's copy will dedup
            for i, item in enumerate(client.pending):
                if item.ordinal == ordinal:
                    del client.pending[i]
                    client.inflight[ordinal] = _Assignment(item, state.name)
                    state.inflight.add((cid, ordinal))
                    recovered += 1
                    break
            else:
                # client reconnected but its resync has not landed yet:
                # claim now, honor at resync
                self._claims[(cid, ordinal)] = (state.name, now)
        if recovered:
            self._m_recovered.add(recovered)
        return recovered

    def _on_retiring(self, state: _WorkerState) -> None:
        """Graceful retirement, phase 1: the worker asked to drain.  Mark
        it draining (the assignment loop never picks it again), then ack -
        the worker finishes its in-flight items, flushes, and says ``bye``.
        Because nothing is dropped or requeued on this path, a
        ``deterministic='seed'`` stream rides a graceful shrink untouched.
        """
        with self._lock:
            already = state.draining
            state.draining = True
            inflight = len(state.inflight)
        if not already:
            self._m_drains.add(1)
            self._event("worker_drain", worker=state.name, inflight=inflight)
            logger.info("Worker %s is retiring (draining %d in-flight"
                        " item(s); no new assignments)", state.name, inflight)
        try:
            state.conn.send({"t": "retire_ok"})
        except OSError:
            pass  # dying connection: _worker_gone's requeue path covers it

    def _on_drain_probe(self, state: _WorkerState) -> None:
        """Graceful retirement, phase 2: the worker's held/outbox sets are
        empty and it asks whether the DISPATCHER still has anything
        assigned to it.  The dispatcher's in-flight set is the source of
        truth (an assignment is recorded there before its ``work`` frame is
        even sent), so ``drain_ok`` structurally proves nothing is - or
        ever will be - outstanding: the worker may say ``bye`` with no
        timing window (a fixed quiet period would race results still
        crossing the wire)."""
        with self._lock:
            remaining = len(state.inflight)
        try:
            if remaining == 0:
                state.conn.send({"t": "drain_ok"})
            else:
                state.conn.send({"t": "drain_wait", "inflight": remaining})
        except OSError:
            pass  # dying connection: _worker_gone's requeue path covers it

    def _on_heartbeat(self, state: _WorkerState, msg: Dict) -> None:
        state.last_heartbeat = time.monotonic()
        state.busy = int(msg.get("busy", 0))
        deltas = msg.get("counters") or {}
        if self.telemetry.enabled:
            for cname, delta in deltas.items():
                if delta and cname.startswith(FLEET_COUNTER_PREFIXES):
                    self.telemetry.counter(f"service.fleet.{cname}").add(delta)
        # fleet aggregation: fold the deltas into this worker's cumulative
        # totals and keep its latest cumulative histogram snapshots - the
        # per-worker truth behind fleet_stats() and the labeled Prometheus
        # families (the delta fold above only keeps fleet-wide sums)
        for cname, delta in deltas.items():
            if isinstance(delta, (int, float)) and delta:
                state.counters[cname] = state.counters.get(cname, 0) + delta
        hists = msg.get("hists")
        if isinstance(hists, dict):
            state.hists = hists
        for ev in msg.get("events") or ():
            self._on_peer_event(ev, src=state.name)
        try:
            # the heartbeat reply carries the fencing epoch, so a fleet
            # learns about a failover even between reconnects
            state.conn.send({"t": "hb_ok", "epoch": self.epoch})
        except OSError:
            pass  # dying connection: the read loop handles it

    # -- bounded redelivery buffer (replay_buffer_bytes) ------------------------

    def _retain_body_locked(self, cid: str, out: Dict) -> None:
        """Account one buffered outcome's body toward the replay cap and
        enforce the cap (caller holds the lock).  Only ``_body``-carrying
        outcomes (results) count; failure frames are header-sized."""
        body = out.get("_body")
        if body is None:
            return
        self._replay_bytes += len(body)
        self._replay_order.append((cid, out))
        if self._replay_bytes <= self._replay_cap:
            return
        # ONE oldest-first pass, dropping as many eligible bodies as the
        # overflow needs (re-walking the ineligible prefix per drop would
        # be O(n) per retained result, under the dispatcher lock, on the
        # relay hot path)
        deferred = []
        while self._replay_order and self._replay_bytes > self._replay_cap:
            ocid, old = self._replay_order.popleft()
            if old.get("_body") is None:
                continue  # already acked/released: drop the tombstone
            client = self._clients.get(ocid)
            if old is out or (client is not None and client.connected
                              and not old.get("_sent")):
                # never degrade the newest entry or one still awaiting its
                # FIRST send to a live client (the client would simply
                # never see it); re-check next overflow
                deferred.append((ocid, old))
                continue
            self._replay_bytes -= len(old["_body"])
            del old["_body"]
            old["_stale"] = True
            self._m_replay_dropped.add(1)
        self._replay_order.extendleft(reversed(deferred))

    def _release_body_locked(self, out: Optional[Dict]) -> None:
        """Free one outcome's body accounting (ack, purge, replay drop).
        The deque entry stays behind as a tombstone; the overflow sweep
        skips released entries."""
        if out is None:
            return
        body = out.get("_body")
        if body is not None:
            self._replay_bytes -= len(body)
            del out["_body"]

    def _on_result(self, state: _WorkerState, msg: Dict) -> None:
        cid, ordinal = msg["client"], msg["ordinal"]
        state.last_heartbeat = time.monotonic()
        tc = msg.get("tc")
        if isinstance(tc, dict):
            # traced item: stamp the dispatcher's result-receive time into
            # the returning hop timeline (the client closes the
            # return-relay hop against its own receive stamp)
            tc.setdefault("hops", []).append(
                ["d", "relay", int(msg.get("attempt", 0)),
                 time.perf_counter_ns(), 0])
        duplicate = False
        orphaned = False
        # ONE critical section from duplicate check to outcome recording:
        # splitting them would let _purge_client (grace expiry, bye) pop
        # the client in between, silently losing the result into an
        # orphaned _ClientState
        with self._lock:
            state.inflight.discard((cid, ordinal))
            client = self._clients.get(cid)
            if client is None:
                conn = None
                claim = self._claims.pop((cid, ordinal), None)
                if claim is not None:
                    # a rejoined worker finished an item whose client has
                    # not reconnected yet: buffer the outcome and replay it
                    # the moment the client's hello lands (bounded by the
                    # replay cap + the grace sweep)
                    out = {k: v for k, v in msg.items() if k != "client"}
                    out["worker"] = state.name
                    self._orphan_results[(cid, ordinal)] = (
                        out, time.monotonic())
                    self._retain_body_locked(cid, out)
                    orphaned = True
                else:
                    duplicate = True
            elif client.inflight.pop(ordinal, None) is None:
                claim = self._claims.pop((cid, ordinal), None)
                if claim is not None:
                    # a claimed item's result landed after the client's
                    # hello but before its resync: record + deliver it now;
                    # popping the claim keeps the resync from re-attaching
                    # an ordinal the worker already finished (which would
                    # wedge the client waiting on a result that never
                    # comes again)
                    out = {k: v for k, v in msg.items() if k != "client"}
                    out["worker"] = state.name
                    client.unacked[ordinal] = out
                    client.results += 1
                    client.rows += int(msg.get("rows", 0))
                    self._retain_body_locked(cid, out)
                    conn = client.conn if client.connected else None
                else:
                    # late duplicate (the ordinal was requeued and its
                    # sibling delivered first, or the client was purged):
                    # drop - the client-side ledger would drop it anyway
                    duplicate = True
                    conn = None
            else:
                # buffer relay: forward the worker's result header verbatim
                # (minus its routing field) with the column payload as
                # opaque bytes - the dispatcher never decodes it
                out = {k: v for k, v in msg.items() if k != "client"}
                out["worker"] = state.name
                client.unacked[ordinal] = out
                client.results += 1
                client.rows += int(msg.get("rows", 0))
                self._retain_body_locked(cid, out)
                conn = client.conn if client.connected else None
        pk = msg.get("pk")
        if pk == "bin":
            self._m_frames_bin.add(1)
        elif pk == "shm":
            self._m_frames_shm.add(1)
        elif pk == "pickle":
            self._m_frames_pkl.add(1)
        if duplicate:
            # outside the lock: _pump's sends must never run while this
            # thread holds the dispatcher lock (a worker with a full TCP
            # buffer would stall every other connection's thread)
            self._m_dup.add(1)
            self._stamp_gauges()
            self._pump()
            return
        if orphaned:
            self._m_orphans.add(1)
            self._m_completed.add(1)
            self._m_rows.add(int(msg.get("rows", 0)))
            self._pump()
            return
        self._m_completed.add(1)
        self._m_rows.add(int(msg.get("rows", 0)))
        self._count_client_rows(cid, int(msg.get("rows", 0)))
        if conn is not None:
            self._send_to_client(cid, conn, out)
        # no _stamp_gauges here: the monitor loop stamps every 0.5s, and a
        # per-result lock+scan on the relay hot path costs real throughput
        # on a core shared with decode
        self._pump()

    def _count_client_rows(self, cid: str, rows: int) -> None:
        """Per-client delivered-row telemetry under a bounded name set: a
        dispatcher serving an unbounded client churn must not grow the
        registry forever.  The cap applies ONLY to registry counter names -
        ``stats()`` per-client counts and the ``qos`` share report come
        from ``_ClientState`` and stay exact and unbounded past it; the
        first capped client logs a warning so the silent gap in the
        ``service.client.*`` series is explained."""
        if not self.telemetry.enabled:
            return
        if cid in self._client_counter_ids \
                or len(self._client_counter_ids) < 100:
            self._client_counter_ids.add(cid)
            self.telemetry.counter(
                f"service.client.{cid[:12]}.rows").add(rows)
        elif not self._counter_cap_warned:
            self._counter_cap_warned = True
            logger.warning(
                "per-client counter cap reached (100 clients): client %s"
                " (and later arrivals) will NOT get a service.client.<id>"
                ".rows registry counter; per-client counts in stats() and"
                " the stats()['qos'] share report remain exact and"
                " unbounded", cid)

    def _on_worker_failure(self, state: _WorkerState, msg: Dict) -> None:
        cid, ordinal = msg["client"], msg["ordinal"]
        state.last_heartbeat = time.monotonic()
        with self._lock:
            state.inflight.discard((cid, ordinal))
            # drop any claim for this item: a claimed item failing is
            # resolved by the client's resync re-enqueueing it (the fresh
            # dispatcher never saw the blob, so re-execution IS its
            # requeue path) - a dangling claim would re-attach the ordinal
            # to a worker that no longer holds it and wedge the client
            claim = self._claims.pop((cid, ordinal), None)
            client = self._clients.get(cid)
            if client is None:
                return
            assign = client.inflight.pop(ordinal, None)
            if assign is None:
                if claim is None:
                    self._m_dup.add(1)
                return
        # failures are plain fields on the wire (formatted traceback, kind,
        # exc_type) - no object envelope; the client recovers the failed
        # item from its own in-flight ledger
        if msg.get("kind", "data") == "infra":
            # in-worker infra failure (e.g. MemoryError): the item is
            # healthy, the worker wasn't - same treatment as a death
            self._requeue_or_fail(
                cid, ordinal, assign,
                f"in-worker infra failure ({msg.get('exc_type')})")
        else:
            self._forward_failure(cid, ordinal,
                                  formatted=msg.get("formatted"),
                                  kind=msg.get("kind", "data"),
                                  exc_type=msg.get("exc_type"))
        self._pump()

    def _worker_gone(self, name: str) -> None:
        with self._lock:
            state = self._workers.pop(name, None)
            if state is None or state.gone:
                return
            state.gone = True
            lost = list(state.inflight)
            self._g_workers.set(len(self._workers))
        state.conn.close()
        self._event("worker_gone", worker=name, lost_inflight=len(lost))
        if lost:
            logger.warning("Worker %s lost with %d in-flight item(s);"
                           " requeueing", name, len(lost))
        for cid, ordinal in lost:
            with self._lock:
                client = self._clients.get(cid)
                assign = client.inflight.pop(ordinal, None) if client else None
            if assign is not None:
                self._requeue_or_fail(cid, ordinal, assign,
                                      f"worker {name} death")
        self._pump()

    def _requeue_or_fail(self, cid: str, ordinal: int, assign: _Assignment,
                         why: str) -> None:
        """Pool `_requeue_lost` semantics across the wire: re-ventilate
        through the attempt budget, else surface a classified infra failure."""
        with self._lock:
            client = self._clients.get(cid)
            if client is None:
                return
            attempt = getattr(assign.item, "attempt", 0)
            if attempt < client.max_requeue:
                # a traced item's context survives the requeue: the same
                # trace id accumulates the retry's hop stamps, so the
                # merged trace shows both attempts as sibling span trees
                tc = getattr(assign.item, "tc", None)
                if isinstance(tc, dict):
                    tc.setdefault("hops", []).append(
                        ["d", "requeue", attempt + 1,
                         time.perf_counter_ns(), 0])
                retry = WireItem(ordinal, attempt + 1, assign.item.blob,
                                 assign.item.rg, tc)
                client.pending.appendleft(retry)
                client.requeued += 1
                conn = client.conn if client.connected else None
                notice = {"t": "requeued", "ordinal": ordinal,
                          "attempt": attempt + 1, "why": why}
            else:
                conn = None
                notice = None
        if notice is not None:
            self._m_requeued.add(1)
            self._event("requeue", client=cid, ordinal=ordinal,
                        attempt=attempt + 1, why=why)
            logger.warning("Requeueing work item %s for client %s after %s"
                           " (attempt %d/%d)", ordinal, cid, why, attempt + 1,
                           client.max_requeue)
            if conn is not None:
                self._send_to_client(cid, conn, notice)
            return
        self._event("item_failed", client=cid, ordinal=ordinal, why=why,
                    attempts=attempt)
        self._forward_failure(
            cid, ordinal, message=(
                f"Work item {ordinal} lost to {why}; requeue budget exhausted"
                f" ({attempt} requeue(s) of max {client.max_requeue})"
                " - possible crash/OOM"),
            kind="infra")

    def _forward_failure(self, cid: str, ordinal: int,
                         formatted: Optional[str] = None,
                         message: Optional[str] = None, kind: str = "data",
                         exc_type: Optional[str] = None) -> None:
        with self._lock:
            client = self._clients.get(cid)
            if client is None:
                return
            out = {"t": "failure", "ordinal": ordinal, "kind": kind}
            if formatted is not None:
                out["formatted"] = formatted
            if message is not None:
                out["message"] = message
            if exc_type is not None:
                out["exc_type"] = exc_type
            client.unacked[ordinal] = out
            conn = client.conn if client.connected else None
        self._m_failures.add(1)
        if conn is not None:
            self._send_to_client(cid, conn, out)

    # -- client side ----------------------------------------------------------

    def _client_loop(self, conn: FrameSocket, hello: Dict) -> None:
        if hello.get("protocol") != PROTOCOL_VERSION:
            conn.send({"t": "error", "error": "protocol version mismatch"})
            conn.close()
            return
        cid = hello["client"]
        resumed = bool(hello.get("resume"))
        refetch = 0
        with self._lock:
            client = self._clients.get(cid)
            # admission control: a NEW session past the cap is refused
            # inside the registration critical section (two racing hellos
            # cannot both squeeze under the cap) and before any state
            # exists for it; reconnects of admitted sessions never hit
            # this - their state is live above.  Only CONNECTED sessions
            # count toward the cap: a crashed trainer riding out its
            # reconnect grace (or a journal-restored session that never
            # came back) must not block its replacement's seat.
            admitted = (client is not None or self._max_clients is None
                        or sum(1 for c in self._clients.values()
                               if c.connected) < self._max_clients)
            if not admitted:
                pass  # refusal send/close happens outside the lock, below
            elif client is None:
                client = _ClientState(
                    cid, conn, hello.get("factory"),
                    hello.get("hostname", ""), bool(hello.get("shm_ok")),
                    int(hello.get("max_requeue", self._max_requeue)),
                    codecs=hello.get("codecs") or (),
                    weight=hello.get("weight", 1.0),
                    priority=hello.get("priority", 0))
                self._clients[cid] = client
                self._client_order.append(cid)
                if resumed:
                    # a client that WAS mid-session re-helloing to a
                    # dispatcher that has never seen it: the restart
                    # recovery path (its resync reconstructs the session)
                    self._m_sessions_rec.add(1)
                    logger.info("Client %s session reconstructed after a"
                                " dispatcher restart", cid)
                else:
                    logger.info("Client %s registered", cid)
            else:
                # reconnect: swap the connection in, replay unacked outcomes
                old = client.conn
                client.conn = conn
                client.connected = True
                client.disconnected_at = None
                if old is not None and old is not conn:
                    old.close()
                logger.info("Client %s reconnected (%d unacked outcome(s)"
                            " to replay)", cid, len(client.unacked))
            replay: List[Dict] = []
            known: List[int] = []
            if admitted:
                # adopt any orphan results a rejoined worker finished while
                # this client was away (they replay below like unacked ones)
                for key in [k for k in self._orphan_results if k[0] == cid]:
                    out, _ts = self._orphan_results.pop(key)
                    if not out.get("_stale"):
                        client.unacked[key[1]] = out
                        client.results += 1
                        client.rows += int(out.get("rows", 0))
                for ordinal in list(client.unacked):
                    out = client.unacked[ordinal]
                    if out.get("_stale"):
                        # body degraded under the replay cap: cannot replay;
                        # dropping it here + excluding it from `known`
                        # forces the client's resync to re-enqueue it
                        # (re-fetch)
                        del client.unacked[ordinal]
                        refetch += 1
                    else:
                        replay.append(out)
                known = sorted(client.known_ordinals())
                self._g_clients.set(
                    sum(1 for c in self._clients.values() if c.connected))
        if not admitted:
            self._m_admission_refused.add(1)
            logger.warning("Refusing client %s: admission control"
                           " (max_clients=%d sessions live)", cid,
                           self._max_clients)
            try:
                conn.send({"t": "error", "error":
                           "admission refused: this dispatcher caps"
                           f" sessions at max_clients={self._max_clients}"})
            except OSError:
                pass
            conn.close()
            return
        if refetch:
            self._m_refetches.add(refetch)
        if self._journal is not None:
            self._journal.append_hello(cid, {
                "factory": hello.get("factory"),
                "hostname": hello.get("hostname", ""),
                "shm_ok": bool(hello.get("shm_ok")),
                "max_requeue": int(hello.get("max_requeue",
                                             self._max_requeue)),
                "codecs": list(hello.get("codecs") or ()),
                "weight": client.weight, "priority": client.priority})
        # `boot` lets the client count dispatcher restarts; `known` lets a
        # warm-restarted (journaled) session skip resync re-sends; `epoch`
        # is the fencing token (a deposed primary's lower value is refused)
        # `clock_ns` anchors the client's handshake clock-offset estimate
        # (distributed tracing maps dispatcher/worker stamps into the
        # client's monotonic domain through it)
        conn.send({"t": "hello_ok", "client": cid, "boot": self.boot_id,
                   "epoch": self.epoch, "known": known,
                   "clock_ns": time.perf_counter_ns()})
        for out in replay:
            self._send_to_client(cid, conn, out)
        self._pump()
        bytes_folded = 0
        try:
            while not self._stop_event.is_set():
                msg = conn.recv(timeout=1.0)
                if conn.bytes_received > bytes_folded:
                    self._m_bytes_in.add(conn.bytes_received - bytes_folded)
                    bytes_folded = conn.bytes_received
                if msg is None:
                    continue
                kind = msg.get("t")
                if kind == "enqueue":
                    item = WireItem.from_wire(msg["item"])
                    if item.tc is not None:
                        # traced item: stamp its arrival at the control
                        # plane (the dispatcher-queue hop opens here)
                        item.tc.setdefault("hops", []).append(
                            ["d", "recv", item.attempt,
                             time.perf_counter_ns(), 0])
                    with self._lock:
                        client.pending.append(item)
                    if self._journal is not None:
                        self._journal.append_enqueue(cid, item.to_wire())
                    self._pump()
                elif kind == "ack":
                    with self._lock:
                        for ordinal in msg["ordinals"]:
                            self._release_body_locked(
                                client.unacked.pop(ordinal, None))
                    if self._journal is not None:
                        self._journal.append_ack(cid, msg["ordinals"])
                elif kind == "resync":
                    self._on_resync(client, msg)
                elif kind == "client_stats":
                    starved = float(msg.get("starved_s", 0.0))
                    if starved > 0:
                        self._starved_reports.append(
                            (time.monotonic(), starved))
                elif kind == "stats?":
                    conn.send({"t": "stats", "stats": self.stats()})
                elif kind == "bye":
                    self._purge_client(cid, reason="clean goodbye")
                    return
        except FrameClosedError:
            pass
        finally:
            with self._lock:
                current = self._clients.get(cid)
                if current is not None and current.conn is conn:
                    current.connected = False
                    current.disconnected_at = time.monotonic()
                    self._g_clients.set(sum(1 for c in self._clients.values()
                                            if c.connected))
            if self._stop_event.is_set():
                # stop-path exit (not a client-side drop): close the socket
                # so the peer sees EOF instead of an idle live connection
                conn.close()

    def _on_resync(self, client: _ClientState, msg: Dict) -> None:
        """Reconnect recovery: re-enqueue any ledger item the dispatcher
        has no record of (an ``enqueue`` frame lost in the dying
        connection, or a whole session lost with a dead dispatcher).  An
        item a rejoined worker CLAIMED re-attaches to that worker instead
        of pending - the executing copy is the assignment; nothing is
        double-assigned."""
        cid = client.client_id
        journal_items = []
        with self._lock:
            known = client.known_ordinals()
            restored = reattached = 0
            for entry in msg.get("items", ()):
                item = WireItem.from_wire(entry)
                if item.ordinal in known:
                    continue
                claim = self._claims.pop((cid, item.ordinal), None)
                worker = (self._workers.get(claim[0])
                          if claim is not None else None)
                if worker is not None and not worker.gone:
                    client.inflight[item.ordinal] = _Assignment(
                        item, worker.name)
                    worker.inflight.add((cid, item.ordinal))
                    reattached += 1
                else:
                    client.pending.append(item)
                    restored += 1
                journal_items.append(item.to_wire())
        if self._journal is not None:
            for fields in journal_items:
                self._journal.append_enqueue(cid, fields)
        if reattached:
            self._m_recovered.add(reattached)
        if restored:
            self._m_resync_restored.add(restored)
        if restored or reattached:
            logger.info("Client %s resync restored %d lost work item(s)"
                        " (+%d re-attached to executing workers)",
                        cid, restored, reattached)
        self._pump()

    def _send_to_client(self, cid: str, conn: FrameSocket, out: Dict) -> None:
        try:
            body = out.get("_body")
            if body is not None:
                # result relay: re-frame the header, forward the payload
                # bytes untouched (vectored write - no staging copy).
                # Underscore keys are dispatcher-local bookkeeping
                # (_body/_sent/_stale) and never ride the wire.
                header = {k: v for k, v in out.items()
                          if not k.startswith("_")}
                self._m_bytes_out.add(conn.send_batch(header, [body]))
            else:
                self._m_bytes_out.add(conn.send(
                    {k: v for k, v in out.items()
                     if not k.startswith("_")}))
            # a sent body is eligible for the replay-cap degrade: losing
            # it costs a re-fetch only if the delivery ALSO got lost
            out["_sent"] = True
        except OSError:
            # connection died mid-send: the outcome stays in unacked and
            # replays on reconnect; the client read loop marks disconnect
            logger.debug("send to client %s failed (kept for replay)", cid)

    def _purge_client(self, cid: str, reason: str) -> None:
        notify = []
        with self._lock:
            client = self._clients.pop(cid, None)
            if client is None:
                return
            if cid in self._client_order:
                self._client_order.remove(cid)
            dropped = len(client.pending) + len(client.inflight)
            for out in client.unacked.values():
                self._release_body_locked(out)
            for key in [k for k in self._claims if k[0] == cid]:
                del self._claims[key]
            for key in [k for k in self._orphan_results if k[0] == cid]:
                out, _ts = self._orphan_results.pop(key)
                self._release_body_locked(out)
            for worker in self._workers.values():
                worker.inflight = {(c, o) for c, o in worker.inflight
                                   if c != cid}
                if cid in worker.jobs_sent:
                    notify.append(worker.conn)
            self._g_clients.set(sum(1 for c in self._clients.values()
                                    if c.connected))
        if self._journal is not None:
            self._journal.append_purge(cid)
        for conn in notify:  # sends stay outside the dispatcher lock
            try:
                conn.send({"t": "job_done", "client": cid})
            except OSError:
                pass
        if client.conn is not None:
            client.conn.close()
        self._event("client_purged", client=cid, reason=reason,
                    dropped_items=dropped)
        logger.info("Client %s purged (%s; %d undelivered item(s) dropped)",
                    cid, reason, dropped)
        self._stamp_gauges()

    # -- assignment -----------------------------------------------------------

    def _pick_worker(self, item: VentilatedItem, free: List[_WorkerState],
                     stable: Optional[List[str]] = None) -> _WorkerState:
        """Rowgroup-affine choice among workers with spare capacity: the
        same rowgroup prefers the same worker (warm-tier locality), falling
        back to least-loaded.

        The affine worker is ``crc32(path:rowgroup)`` modulo the stable
        name-sorted list of ALL live workers - a deterministic digest
        (built-in ``hash()`` is PYTHONHASHSEED-randomized per process) over
        a membership-stable list (indexing the momentary free list would
        move the mapping whenever fleet load shifts), so affinity survives
        dispatcher restarts and load churn.  Only when the affine worker is
        saturated does the item go to the least-loaded free one.

        ``stable`` lets _pump hoist the sorted name list out of its
        assignment loop (membership cannot change while it holds the lock).
        """
        if isinstance(item, WireItem):
            # the wire plane lifts the affinity key out structurally so the
            # dispatcher never opens the item blob
            rg_key = (f"{item.rg[0]}:{item.rg[1]}"
                      if isinstance(item.rg, (list, tuple))
                      and len(item.rg) == 2 else None)
        else:
            # direct VentilatedItem (tests, in-process callers)
            work = getattr(item, "item", None)
            rg = getattr(work, "row_group", None)
            rg_key = (f"{getattr(rg, 'path', '')}:"
                      f"{getattr(rg, 'row_group', 0)}"
                      if rg is not None else None)
        if rg_key is not None:
            if stable is None:
                stable = sorted(w.name for w in self._workers.values()
                                if not w.gone)
            key = zlib.crc32(rg_key.encode())
            affine = self._workers.get(stable[key % len(stable)])
            if affine is not None and affine in free:
                return affine
        return min(free, key=lambda w: len(w.inflight))

    #: WDRR burst bound: a client's deficit never exceeds this many times
    #: its (floored-at-1) weight, so credit earned while briefly unscheduled
    #: cannot pile into an unbounded burst later
    _DEFICIT_BURST = 2.0

    def _next_client_locked(self) -> Optional[str]:
        """Pick the next client to assign for: **strict-priority tiers**
        (the highest tier with eligible pending work is served exclusively)
        and **weighted deficit-round-robin** within the tier (each refill
        adds credit proportional to ``weight``; one assignment spends one
        unit; an emptied queue resets its deficit - classic DRR, so
        long-run shares converge to the weight ratio and every positive
        weight keeps making progress).  A client at
        ``max_client_inflight`` is skipped (``service.qos.capped_deferrals``
        counts pumps where ONLY capped clients had pending work).  Caller
        holds the lock; returns None when nothing is assignable."""
        eligible = []
        capped_only = False
        for cid in self._client_order:
            c = self._clients[cid]
            if not c.pending:
                continue
            if self._max_client_inflight is not None \
                    and len(c.inflight) >= self._max_client_inflight:
                capped_only = True
                continue
            eligible.append(cid)
        if not eligible:
            if capped_only:
                self._m_capped_deferrals.add(1)
            return None
        top = max(self._clients[cid].priority for cid in eligible)
        tier = [cid for cid in eligible if self._clients[cid].priority == top]
        if len(tier) == 1:
            return tier[0]
        if all(self._clients[cid].deficit < 1.0 for cid in tier):
            # proportional refill sized so the first client to afford one
            # item lands exactly at 1.0 (virtual-time DRR: credit per
            # refill is weight-proportional; no fixed quantum to tune, no
            # refill loop that crawls for tiny weights)
            quantum = min((1.0 - self._clients[cid].deficit)
                          / self._clients[cid].weight for cid in tier)
            for cid in tier:
                c = self._clients[cid]
                c.deficit = min(c.deficit + c.weight * quantum,
                                self._DEFICIT_BURST * max(1.0, c.weight))
        affordable = [cid for cid in tier
                      if self._clients[cid].deficit >= 1.0] or tier
        # rotate the tie-break start so equal-deficit clients alternate
        self._rr = (self._rr + 1) % len(affordable)
        rotated = affordable[self._rr:] + affordable[:self._rr]
        return max(rotated, key=lambda cid: self._clients[cid].deficit)

    def _pump(self) -> None:
        """Assign pending items to free workers (strict-priority weighted
        deficit-round-robin across clients - :meth:`_next_client_locked`).
        Sends happen outside the lock; assignment state is recorded first,
        so a failed send surfaces as a worker death whose requeue path
        recovers the item."""
        sends: List[Tuple[_WorkerState, Dict]] = []
        with self._lock:
            stable = sorted(w.name for w in self._workers.values()
                            if not w.gone)
            while True:
                free = [w for w in self._workers.values()
                        if not w.gone and not w.draining
                        and len(w.inflight) < w.capacity]
                if not free:
                    break
                cid = self._next_client_locked()
                if cid is None:
                    break
                client = self._clients[cid]
                item = client.pending.popleft()
                client.deficit = max(0.0, client.deficit - 1.0)
                client.assigned += 1
                if not client.pending:
                    # DRR: an emptied queue forfeits its residual credit
                    # (idle time must not bank into a later burst)
                    client.deficit = 0.0
                tc = getattr(item, "tc", None)
                if isinstance(tc, dict):
                    # traced item: close the dispatcher-queue hop (receive/
                    # requeue -> assignment, same-process monotonic delta -
                    # skew-free) and stamp the assignment for the merged
                    # trace's relay hop
                    now_ns = time.perf_counter_ns()
                    hops = tc.setdefault("hops", [])
                    if self.telemetry.enabled:
                        for who, hname, _a, t_ns, _off in reversed(hops):
                            if who == "d" and hname in ("recv", "requeue"):
                                self.telemetry.histogram(
                                    "service.hop.dispatcher_queue").record(
                                        max(0, now_ns - t_ns) / 1e9)
                                break
                    hops.append(["d", "assign",
                                 getattr(item, "attempt", 0), now_ns, 0])
                worker = self._pick_worker(item, free, stable)
                client.inflight[item.ordinal] = _Assignment(item, worker.name)
                worker.inflight.add((cid, item.ordinal))
                if cid not in worker.jobs_sent:
                    worker.jobs_sent.add(cid)
                    same_host = bool(client.hostname
                                     and client.hostname == worker.hostname)
                    sends.append((worker, {
                        "t": "job", "client": cid, "factory": client.factory,
                        "shm_ok": client.shm_ok and same_host,
                        # BATCH-body compression for this pair: off for
                        # co-located hops, negotiated for cross-host ones
                        "codec": negotiate_codec(
                            self._wire_codec, same_host, client.codecs,
                            worker.codecs)}))
                sends.append((worker, {"t": "work", "client": cid,
                                       "item": item.to_wire()}))
                self._m_assigned.add(1)
        for worker, msg in sends:
            try:
                self._m_bytes_out.add(worker.conn.send(msg))
            except OSError:
                # dying worker: its read loop will run _worker_gone, which
                # requeues everything it held (including this item)
                logger.debug("send to worker %s failed", worker.name)
        if sends:
            self._stamp_gauges()

    def _stamp_gauges(self) -> None:
        with self._lock:
            pending = sum(len(c.pending) for c in self._clients.values())
            inflight = sum(len(c.inflight) for c in self._clients.values())
            tiers = len({c.priority for c in self._clients.values()
                         if c.connected})
            replay_bytes = self._replay_bytes
            # drop released tombstones off the front of the accounting
            # deque so it tracks live entries, not history
            while self._replay_order \
                    and self._replay_order[0][1].get("_body") is None:
                self._replay_order.popleft()
        self._g_pending.set(pending)
        self._g_inflight.set(inflight)
        self._g_priority_tiers.set(tiers)
        self._g_replay_bytes.set(replay_bytes)

    # -- monitoring / scaling -------------------------------------------------

    def _monitor_loop(self) -> None:
        while not self._stop_event.wait(0.5):
            now = time.monotonic()
            dead = []
            hung = {}
            with self._lock:
                for name, w in self._workers.items():
                    if now - w.last_heartbeat > self._heartbeat_timeout_s:
                        dead.append(name)
                if self._assignment_deadline_s is not None:
                    # liveness backstop for workers wedged INSIDE user code:
                    # they keep heartbeating (the heartbeat thread is
                    # independent), so a stuck ASSIGNMENT is the signal
                    for c in self._clients.values():
                        for ordinal, assign in c.inflight.items():
                            age = now - assign.assigned_at
                            if (age > self._assignment_deadline_s
                                    and assign.worker in self._workers):
                                hung.setdefault(assign.worker,
                                                (ordinal, age))
                expired = [cid for cid, c in self._clients.items()
                           if not c.connected and c.disconnected_at is not None
                           and now - c.disconnected_at > self._client_grace_s]
                # recovery leftovers whose client never reconnected: claims
                # and orphan results age out on the same grace clock
                for key in [k for k, (_w, ts) in self._claims.items()
                            if now - ts > self._client_grace_s]:
                    del self._claims[key]
                for key in [k for k, (_o, ts) in self._orphan_results.items()
                            if now - ts > self._client_grace_s]:
                    out, _ts = self._orphan_results.pop(key)
                    self._release_body_locked(out)
            for name in dead:
                logger.warning("Worker %s missed heartbeats for %.0fs;"
                               " declaring it dead", name,
                               self._heartbeat_timeout_s)
                self._worker_gone(name)
            for name, (ordinal, age) in hung.items():
                if name in dead:
                    continue
                logger.warning(
                    "Worker %s has held item %s for %.1fs >"
                    " assignment_deadline_s=%.1f; declaring it hung and"
                    " dropping it (its items requeue; the remote process"
                    " exits on the closed connection)", name, ordinal, age,
                    self._assignment_deadline_s)
                if self.telemetry.enabled:
                    self.telemetry.counter(
                        "service.hung_workers_dropped").add(1)
                self._worker_gone(name)
            for cid in expired:
                self._purge_client(cid, reason="reconnect grace expired")
            self._g_pressure.set(self.scaling_signal()["pressure"])
            self._stamp_gauges()

    def scaling_signal(self, window_s: float = 10.0,
                       threshold: Optional[float] = None) -> Dict[str, Any]:
        """Fleet-size pressure from the clients' queue-wait signals.

        ``pressure`` is the aggregate consumer starved-seconds per second
        over the last ``window_s`` (clients report their
        ``queue.results_empty_wait_s`` deltas - the exact signal
        petastorm_tpu_torch.autotune grows local worker pools on).  Crossing
        ``threshold`` with work queued means the fleet is the bottleneck
        -> ``'grow'``; an idle fleet with nothing pending -> ``'shrink'``;
        else ``'ok'`` (:func:`compute_recommendation` is the exact rule -
        the autoscale supervisor applies the same one to remote
        ``stats`` probes).

        ``threshold`` defaults to the dispatcher's configured
        ``starved_threshold`` (ctor / ``--starved-threshold``), which
        itself defaults to the in-process ``AutotunePolicy``'s value - so
        service fleets and local pools judge starvation identically unless
        an operator tunes them apart.
        """
        if threshold is None:
            threshold = self._starved_threshold
        if threshold is None:
            from petastorm_tpu_torch.autotune import AutotunePolicy

            threshold = AutotunePolicy.starved_threshold
        now = time.monotonic()
        with self._lock:
            starved = sum(delta for t, delta in self._starved_reports
                          if now - t <= window_s)
            pending = sum(len(c.pending) for c in self._clients.values())
            inflight = sum(len(c.inflight) for c in self._clients.values())
            # draining workers are leaving: they finish their in-flight
            # items but take no new ones, so they are not capacity
            capacity = sum(w.capacity for w in self._workers.values()
                           if not w.draining)
            workers = sum(1 for w in self._workers.values()
                          if not w.draining)
            clients = sum(1 for c in self._clients.values() if c.connected)
        pressure = starved / window_s
        busy_frac = (inflight / capacity) if capacity else 0.0
        recommendation = compute_recommendation(
            pressure=pressure, threshold=threshold, pending=pending,
            capacity=capacity, busy_fraction=busy_frac, clients=clients)
        return {"pressure": round(pressure, 4),
                "starved_threshold": threshold,
                "busy_fraction": round(busy_frac, 4),
                "pending_items": pending, "worker_capacity": capacity,
                "workers": workers, "connected_clients": clients,
                "recommendation": recommendation}

    def fleet_stats(self) -> Dict[str, Any]:
        """Fleet aggregation snapshot (the ``fleet?`` frame; also the raw
        material of the per-worker-labeled Prometheus families and the
        ``stats --watch`` fleet view): per-worker cumulative counters and
        stage-histogram quantiles, fleet-merged histograms (fixed buckets
        merge element-wise - :func:`merge_hist_snapshots`), the fleet
        event tail, and the scaling signal."""
        from petastorm_tpu_torch.telemetry.report import (hist_quantile,
                                                    merge_hist_snapshots)

        now = time.monotonic()
        with self._lock:
            workers = {}
            hist_groups: Dict[str, List[Dict]] = {}
            for name, w in self._workers.items():
                stages = {}
                for hname, snap in (w.hists or {}).items():
                    if not isinstance(snap, dict):
                        continue
                    hist_groups.setdefault(hname, []).append(snap)
                    if snap.get("count"):
                        stages[hname] = {
                            "count": int(snap.get("count", 0)),
                            "p50_s": hist_quantile(snap, 0.5),
                            "p99_s": hist_quantile(snap, 0.99)}
                workers[name] = {
                    "busy": w.busy, "capacity": w.capacity,
                    "inflight": len(w.inflight), "draining": w.draining,
                    "hostname": w.hostname,
                    "heartbeat_age_s": round(now - w.last_heartbeat, 2),
                    "counters": dict(w.counters), "hists": stages}
            events = list(self._events)[-64:]
        merged = {}
        for hname, snaps in hist_groups.items():
            m = merge_hist_snapshots(snaps)
            if m.get("count"):
                merged[hname] = {"count": m["count"],
                                 "p50_s": hist_quantile(m, 0.5),
                                 "p99_s": hist_quantile(m, 0.99),
                                 "snapshot": m}
        fleet_counters = {}
        if self.telemetry.enabled:
            prefix = "service.fleet."
            fleet_counters = {
                k[len(prefix):]: v for k, v in
                self.telemetry.snapshot()["counters"].items()
                if k.startswith(prefix)}
        return {"boot": self.boot_id, "epoch": self.epoch,
                "uptime_s": round(now - self._started_at, 1),
                "workers": workers, "merged_hists": merged,
                "fleet_counters": fleet_counters, "events": events,
                "scaling": self.scaling_signal()}

    def _fleet_prometheus(self) -> str:
        """Extra text block for the ``--metrics-port`` scrape: the
        per-worker-labeled and fleet-merged families."""
        from petastorm_tpu_torch.telemetry.export import render_fleet_prometheus

        return render_fleet_prometheus(self.fleet_stats())

    def stats(self) -> Dict[str, Any]:
        """Point-in-time service snapshot (CLI ``stats`` / tests /
        operators): fleet membership, per-client progress, counters, and
        the scaling signal."""
        with self._lock:
            workers = {name: {"capacity": w.capacity, "busy": w.busy,
                              "inflight": len(w.inflight),
                              "hostname": w.hostname,
                              "draining": w.draining,
                              "heartbeat_age_s": round(
                                  time.monotonic() - w.last_heartbeat, 2)}
                       for name, w in self._workers.items()}
            clients = {cid: {"connected": c.connected,
                             "pending": len(c.pending),
                             "inflight": len(c.inflight),
                             "unacked": len(c.unacked),
                             "rows": c.rows, "results": c.results,
                             "requeued": c.requeued}
                       for cid, c in self._clients.items()}
            # per-client QoS share report: exact + unbounded (the registry
            # caps per-client counter names; THIS is the canonical
            # per-client accounting, whatever the registry capped)
            total_assigned = sum(c.assigned for c in self._clients.values())
            qos = {cid: {"weight": c.weight, "priority": c.priority,
                         "assigned": c.assigned,
                         "share": round(c.assigned / total_assigned, 4)
                         if total_assigned else 0.0}
                   for cid, c in self._clients.items()}
        counters = {}
        if self.telemetry.enabled:
            counters = {k: v for k, v in
                        self.telemetry.snapshot()["counters"].items()
                        if k.startswith("service.")}
        with self._lock:
            recovery = {"claims": len(self._claims),
                        "orphan_results": len(self._orphan_results),
                        "replay_buffer_bytes": self._replay_bytes,
                        "journal": self._journal_path}
        out = {"uptime_s": round(time.monotonic() - self._started_at, 1),
               "port": self.port, "boot": self.boot_id, "epoch": self.epoch,
               "workers": workers, "clients": clients, "qos": qos,
               "recovery": recovery,
               "counters": counters, "scaling": self.scaling_signal()}
        # HA health from EITHER role's one-shot stats probe: a primary
        # reports the sync position of every subscribed standby (journal
        # seq fed vs live - standby_lag_items without scraping the standby
        # process), a standby reports its own view of the stream
        jseq = self._journal.seq if self._journal is not None else 0
        with self._lock:
            feeds = dict(self._standby_feeds)
        ha: Dict[str, Any] = {
            "role": "standby" if self._standby else "primary",
            "epoch": self.epoch, "journal_seq": jseq,
            "standbys": {peer: {"synced_seq": pos,
                                "standby_lag_items": max(0, jseq - pos)}
                         for peer, pos in feeds.items()}}
        if self._standby_of is not None:
            ha["standby_lag_items"] = self._standby_lag
            ha["synced_records"] = self._standby_synced
        out["ha"] = ha
        if self._standby_of is not None:
            out["standby"] = {
                "standby": self._standby,
                "of": self._standby_of,
                "promoted": self.standby_promoted.is_set(),
                "primary_epoch": self._primary_epoch,
                "primary_boot": self._primary_boot,
                "synced_records": self._standby_synced,
                "lag_items": self._standby_lag}
        return out
