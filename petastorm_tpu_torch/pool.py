"""Executors that run the rowgroup decode worker over a stream of work items.

Counterpart of ``petastorm_tpu/pool.py:572 SerialExecutor``, ``:749
ThreadedExecutor`` and ``:1525 _ProcessExecutor``.  Every pool delivers
results in the order the items were ventilated, so a reader's output is a
pure function of its plan whatever the worker count, the pool type, the
retries and the hedges (the JAX reader gets the same from its
``deterministic='seed'`` reorder stage).  ``quiesce()`` is the counterpart of
``:2265 Ventilator.pause_and_join``: no item is issued after it, every item
issued before it still delivers, and it returns the exact count issued.
``imap`` takes the absolute ordinal of its first item (``start``), so that
count is an absolute position in the item stream.

Failures follow the JAX pools' contract (``:61 WorkerError``, ``:178
_Failure``, ``:215 _worker_error``): a worker's exception becomes a
:class:`WorkerError` carrying its ``kind`` (``errors.classify_error``), the
item's absolute ``ordinal``, the ``item`` and the ``exc_type``, with the
formatted remote traceback in its message and, where it pickles, the
worker's own exception as its ``__cause__``.  With ``stop_on_failure`` (the
reader's ``on_error='raise'``) the thread and process pools raise the
``WorkerError`` and stop, and the serial pool raises the worker's bare
exception; without it (a skip policy) they yield the ``WorkerError`` at the
item's position and keep going, so the reader can quarantine the item.

The in-flight ledger (``:334-514``) tracks every issued item from its
ventilation to its delivery.  It requeues an item whose worker failed with
an ``'infra'`` error (an in-worker ``MemoryError``), died (a crashed
process, a chaos kill) or hung past ``item_deadline_s``, up to
``max_requeue_attempts`` times (``requeued_items``); a budget spent on
deaths gives an ``'infra'`` ``WorkerError``, one spent on hangs a
``'data'`` one, which a skip policy quarantines.  The ledger also drops the
late duplicate of an item that was requeued or hedged: each item is
delivered once, at its plan position.

Liveness (``item_deadline_s``, ``hedge_after_s``): the thread pool abandons
a slot busy on one item past the deadline (a thread cannot be killed) and
requeues the item onto a sibling; it does not respawn the slot, as the JAX
pool does not outside autotune's resizing, so when every slot is dead or
abandoned it raises instead of wedging.  The process pool SIGKILLs a hung
worker that is not mid-delivery, respawns it in its slot, and requeues the
item; a worker process that dies is not respawned, and its item is requeued
from its heartbeat.  ``hedge_after_s`` re-issues an item busy past that
many seconds to an idle worker, first result wins (``hedged_items``,
``hedge_wins``).  ``'auto'`` is ``max(4 x p99 of stage.decode.latency_s,
0.5)`` seconds once 20 decodes are recorded in this process's telemetry, and
no hedging before that or without telemetry (``petastorm_tpu/pool.py:
440-457``); the process pool's decodes are recorded in its workers, so
there it hedges nothing.  The serial pool runs work inline, so it takes both
with a warning that they do nothing, and watches its own items for
``stall_warn_s``.

The process pool (``ProcessExecutor``) spawns its workers (never forks: a
fork after CUDA is initialised is broken) and moves their results through
the shared-memory arena (``native/transport.py``), whose library it builds
at construction and without which it raises.  Its workers import neither
``torch`` nor anything that touches CUDA.  Spawn re-runs the parent's main
script in every child; the pool lets its workers do so only when the
pickled worker factory refers to something defined there (a transform
written in the script).  Otherwise they start from the package alone, so a
training script that imports ``torch`` at its top level does not load it
into every worker (seconds of start-up, and gigabytes of resident memory,
a worker).

Telemetry (``petastorm_tpu/pool.py:312-330``): the pools record the
``ventilate`` stage, the ventilator's waits for an in-flight slot, the
queue-depth gauges and the ``errors.requeued_items`` and ``liveness.*``
counters.  The ventilator's wait is where backpressure shows here (the
thread pool's input queue is unbounded; the in-flight window bounds what is
issued): a wait that begins with the results part of the window full of
undelivered batches is the consumer's (``queue.results_full_wait_s``), any
other the workers' (``queue.input_full_wait_s``).  The process pool counts
``decode.batch_slots``, the columns its workers decoded straight into arena
slots.

Autotune's knobs (``petastorm_tpu/pool.py:849-960``, ``:1681``):
``resize_workers`` grows or shrinks both pools in place (a retired worker
finishes its item first), the process pool up to ``max_workers`` slots made
at construction; ``set_results_bound`` resizes the thread pool's results
part of the window; a thread pool under target management
(``_heal_to_target``) respawns the slots it loses to deaths and abandoned
hangs.
"""

from __future__ import annotations

import contextlib
import logging
import os
import pickle
import queue
import threading
import time
import traceback
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

from petastorm_tpu_torch.errors import (DEFAULT_REQUEUE_ATTEMPTS, PetastormTpuError,
                                        ReaderClosedError, classify_error)
from petastorm_tpu_torch.telemetry import resolve as _resolve_telemetry

logger = logging.getLogger(__name__)

_POLL_S = 0.05
_MISSING = object()

WorkerFactory = Callable[[], Callable[[Any], Any]]
#: called by ``imap`` while it waits, with the seconds since the last result
#: arrived; may raise (the reader's stall watchdog)
IdleCallback = Callable[[float], None]


def env_seconds(name: str, default: float) -> float:
    """A float environment variable, or ``default`` (with a warning when it
    does not parse) (``petastorm_tpu/pool.py:48``)."""
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    try:
        return float(raw)
    except ValueError:
        logger.warning("Ignoring non-numeric %s=%r (using %.0f)", name, raw, default)
        return default


class WorkerError(PetastormTpuError):
    """A worker failed; the message includes the remote traceback.

    ``kind``: ``'data'`` (a property of the work item, skip-eligible) or
    ``'infra'`` (a property of the worker).  ``ordinal`` (the item's
    absolute position in the stream), ``item`` (the ``plan.WorkItem``) and
    ``exc_type`` are set when the failure is attributable to one work item;
    an unattributable failure (the item source failed, every worker died, a
    stall abort) keeps the defaults and is never skipped.
    """

    def __init__(self, message: str, kind: str = "infra", ordinal=None,
                 item=None, exc_type: Optional[str] = None):
        super().__init__(message)
        self.kind = kind
        self.ordinal = ordinal
        self.item = item
        self.exc_type = exc_type


class PipelineStallError(WorkerError):
    """The reader produced no result for ``stall_abort_s`` seconds and
    aborted (``make_reader(stall_abort_s=...)``,
    ``PETASTORM_TPU_STALL_ABORT_S``; ``petastorm_tpu/pool.py:83``).  An
    unattributable ``'infra'`` :class:`WorkerError` carrying the reader's
    ``diagnostics`` at the abort, which name the stuck workers and items."""

    def __init__(self, message: str, diagnostics: Optional[dict] = None):
        super().__init__(message, kind="infra")
        self.diagnostics = diagnostics or {}


class _Failure:
    """A worker exception on its way to the consumer.  ``exc`` is dropped
    (None) where it does not pickle across the process boundary."""

    __slots__ = ("exc", "formatted", "kind", "exc_type", "ordinal", "item")

    def __init__(self, exc: BaseException, ordinal=None, item=None):
        self.exc = exc
        self.formatted = "".join(traceback.format_exception(type(exc), exc, exc.__traceback__))
        self.kind = classify_error(exc)
        self.exc_type = type(exc).__name__
        self.ordinal = ordinal
        self.item = item

    def error(self) -> WorkerError:
        """The classified WorkerError, with the worker's exception as its cause."""
        err = WorkerError(f"Worker failed:\n{self.formatted}", kind=self.kind,
                          ordinal=self.ordinal, item=self.item, exc_type=self.exc_type)
        err.__cause__ = self.exc
        return err


class _Ok:
    """A result tagged with its item's ordinal and the attempt that made it
    (``petastorm_tpu/pool.py:191``): the ledger settles the first and drops
    a duplicate, and the attempt tells whether a hedge copy won."""

    __slots__ = ("ordinal", "value", "attempt")

    def __init__(self, ordinal, value, attempt: int = 0):
        self.ordinal = ordinal
        self.value = value
        self.attempt = attempt


class VentilatedItem:
    """A work item tagged with its absolute ordinal and its attempt (0 = the
    first issue; each requeue or hedge adds one) (``petastorm_tpu/pool.py:
    228``).  Worker functions get the bare ``item`` unless they set
    ``takes_ventilated_items`` (``test_util.chaos.ChaosWorker``'s do: its
    faults key on the ordinal and the attempt)."""

    __slots__ = ("ordinal", "item", "attempt")

    def __init__(self, ordinal: int, item: Any, attempt: int = 0):
        self.ordinal = ordinal
        self.item = item
        self.attempt = attempt

    def __getstate__(self):
        return (self.ordinal, self.item, self.attempt)

    def __setstate__(self, state):
        self.ordinal, self.item, self.attempt = state


def _call(fn, vitem: VentilatedItem, takes_ventilated: bool):
    return fn(vitem if takes_ventilated else vitem.item)


def _crashed(exc: BaseException) -> bool:
    """A chaos kill on a thread or the serial pool (``test_util.chaos``)."""
    return bool(getattr(exc, "petastorm_tpu_simulated_crash", False))


def _check_liveness_args(item_deadline_s, hedge_after_s) -> None:
    """The argument checks of ``petastorm_tpu/pool.py:282-289``."""
    if item_deadline_s is not None and item_deadline_s <= 0:
        raise PetastormTpuError("item_deadline_s must be > 0 or None")
    if not (hedge_after_s is None or hedge_after_s == "auto"
            or (isinstance(hedge_after_s, (int, float)) and hedge_after_s > 0)):
        raise PetastormTpuError(
            "hedge_after_s must be a positive number, 'auto', or None;"
            f" got {hedge_after_s!r}")


class _Window:
    """The in-flight window: a counting semaphore whose bound can move
    (autotune's worker and results-queue knobs).  ``bound`` is the results
    part alone (what ``set_results_bound`` sets); the window holds
    ``workers + bound`` slots."""

    def __init__(self, workers: int, results: int):
        self._cond = threading.Condition()
        self._workers = workers
        self.bound = results
        self._taken = 0

    @property
    def size(self) -> int:
        return self._workers + self.bound

    def resize(self, workers: Optional[int] = None, results: Optional[int] = None) -> None:
        with self._cond:
            if workers is not None:
                self._workers = workers
            if results is not None:
                self.bound = results
            self._cond.notify_all()

    def acquire(self, timeout: Optional[float] = None) -> bool:
        with self._cond:
            if self._taken >= self.size and not self._cond.wait_for(
                    lambda: self._taken < self.size, timeout):
                return False
            self._taken += 1
            return True

    def release(self) -> None:
        with self._cond:
            self._taken -= 1
            self._cond.notify()


class _LedgerExecutor:
    """The thread and process pools' shared part: the ventilator thread, the
    in-flight ledger and the in-order delivery of ``imap``.

    Consumer-thread state, as in the JAX pools: the ledger's requeues,
    hedges and liveness sweeps run in ``imap`` while it waits, so no sweep
    races another.  ``_results`` holds each settled ordinal's outcome until
    its turn; an ordinal holds one in-flight slot (``_window``) from its
    ventilation to its delivery, however many attempts it takes.
    """

    _VENTILATOR_NAME = "petastorm-torch-ventilator"

    def __init__(self, workers_count: int, results_queue_size: int,
                 stop_on_failure: bool, max_requeue_attempts: int,
                 item_deadline_s: Optional[float], hedge_after_s, telemetry=None):
        if workers_count < 1:
            raise PetastormTpuError("workers_count must be >= 1")
        _check_liveness_args(item_deadline_s, hedge_after_s)
        self._workers_count = workers_count
        self._stop_on_failure = stop_on_failure
        self._max_requeue = max_requeue_attempts
        self._item_deadline_s = item_deadline_s
        self._hedge_after = hedge_after_s
        self._window = _Window(workers_count, max(results_queue_size, 1))
        #: resize_workers and the heal sweep, against each other
        self._resize_lock = threading.RLock()
        #: set by the first resize_workers: the worker count is then a target
        self._target_managed = False
        #: slots told to exit at their next item boundary, and slots that did
        #: (resize_workers' shrink; a grow reuses a retired slot)
        self._retiring: set = set()
        self._retired: set = set()
        self._telemetry = tele = _resolve_telemetry(telemetry)
        self._m_input_full = tele.counter("queue.input_full_wait_s")
        self._m_results_full = tele.counter("queue.results_full_wait_s")
        self._g_in_depth = tele.gauge("pool.in_queue_depth")
        self._g_out_depth = tele.gauge("pool.results_queue_depth")
        self._m_requeued = tele.counter("errors.requeued_items")
        self._m_hung_killed = tele.counter("liveness.hung_workers_killed")
        self._m_hung_abandoned = tele.counter("liveness.hung_workers_abandoned")
        self._m_hedged = tele.counter("liveness.hedged_items")
        self._m_hedge_wins = tele.counter("liveness.hedge_wins")
        #: arrivals ahead of their turn, held for in-order delivery (the JAX
        #: reader's reorder-stage counter, ``petastorm_tpu/reader.py:1590``)
        self._m_reordered = tele.counter("reader.reordered_batches")
        self._awaited = 0
        if tele.enabled:
            tele.register_stage("ventilate")
        #: ordinal -> latest in-flight VentilatedItem
        self._inflight: Dict[int, VentilatedItem] = {}
        self._inflight_lock = threading.Lock()
        #: ordinal -> (outcome, holds a window slot), settled, not delivered
        self._results: Dict[int, tuple] = {}
        self._results_lock = threading.Lock()
        self._total: Optional[int] = None  # items ventilated, once the source ends
        self._stop = threading.Event()
        self._pause = threading.Event()
        self._ventilator: Optional[threading.Thread] = None
        #: makes creating, starting and publishing the ventilator one step
        #: to quiesce(): it finds no ventilator, or a started one
        self._ventilator_lock = threading.Lock()
        self._start = 0
        self._factory: Optional[WorkerFactory] = None
        self._pending_requeue: list = []
        #: ordinal -> attempt number of its hedge copy, until first delivery
        self._hedged_attempt: Dict[int, int] = {}
        self._requeued_items = 0
        self._hung_workers_killed = 0
        self._hung_workers_abandoned = 0
        self._hedged_items = 0
        self._hedge_wins = 0
        self._ventilated = 0
        self._consumed = 0
        self._stopped = False

    @property
    def requeued_items(self) -> int:
        """Items re-ventilated after an infra failure, a death or a hang."""
        return self._requeued_items

    @property
    def _out_slots(self) -> _Window:
        """The window, whose ``bound`` is the results part (the autotune
        controller reads ``_out_slots.bound``, as of the JAX pool)."""
        return self._window

    def set_results_bound(self, n: int) -> int:
        """Resize the results part of the in-flight window in place
        (``petastorm_tpu/pool.py:949``, autotune's queue knob); a smaller
        bound only holds the ventilator back until the consumer catches up.
        Returns the new bound."""
        n = max(1, int(n))
        self._window.resize(results=n)
        return n

    # -- the ventilator ------------------------------------------------------

    def _take_slot(self) -> bool:
        """Wait for an in-flight slot; False once stopped or quiesced.  The
        wait is recorded as the consumer's (``queue.results_full_wait_s``)
        when it began with the results part of the window full of
        undelivered batches, else as the workers'
        (``queue.input_full_wait_s``)."""
        if not self._window.acquire(timeout=0):
            t0 = time.perf_counter()
            with self._results_lock:
                consumer_bound = len(self._results) >= self._window.bound
            try:
                while not self._window.acquire(timeout=_POLL_S):
                    if self._stop.is_set() or self._pause.is_set():
                        return False
            finally:
                if self._telemetry.enabled:
                    (self._m_results_full if consumer_bound
                     else self._m_input_full).add(time.perf_counter() - t0)
        if self._stop.is_set() or self._pause.is_set():
            self._window.release()
            return False
        return True

    def _ventilate(self, items: Iterable[Any]) -> None:
        issued = 0
        tele = self._telemetry
        try:
            for item in items:
                if tele.enabled:
                    # the stage's busy time leaves out the waits for a slot,
                    # which the queue counters hold (``petastorm_tpu/pool.py:2230``)
                    t0 = time.perf_counter_ns()
                    waited0 = self._m_input_full.value + self._m_results_full.value
                if not self._take_slot():
                    break
                vitem = VentilatedItem(self._start + issued, item)
                # ledger entry before the enqueue: a fast result must find it
                with self._inflight_lock:
                    self._inflight[vitem.ordinal] = vitem
                if not self._issue(vitem):
                    # withdrawn (quiesce or stop while the queue was full)
                    self._settle(vitem.ordinal)
                    self._window.release()
                    break
                if tele.enabled:
                    waited = (self._m_input_full.value + self._m_results_full.value
                              - waited0)
                    tele.record_stage("ventilate", t0,
                                      max(time.perf_counter_ns() - t0 - int(waited * 1e9), 0),
                                      {"ordinal": vitem.ordinal})
                self._ventilated += 1
                issued += 1
        except BaseException as exc:  # noqa: BLE001 - delivered to the consumer
            # the item source failed: no work item to blame, never skipped;
            # it holds no slot, so the consumer releases none for it
            with self._results_lock:
                self._results[self._start + issued] = (_Failure(exc), False)
            issued += 1
        with self._results_lock:
            self._total = issued
        self._wake()

    def _issue(self, vitem: VentilatedItem) -> bool:
        """Hand a fresh item to the workers; False when withdrawn."""
        raise NotImplementedError

    def _try_enqueue(self, vitem: VentilatedItem) -> bool:
        """Non-blocking enqueue of a requeue or hedge; False when full."""
        raise NotImplementedError

    def _wake(self) -> None:
        """Wake a consumer waiting for arrivals (the source ended)."""

    # -- the in-flight ledger (``petastorm_tpu/pool.py:334-514``) -----------

    def _settle(self, ordinal) -> bool:
        """Remove ``ordinal`` from the ledger; False = already settled (this
        arrival is a duplicate of a requeued or hedged item)."""
        with self._inflight_lock:
            return self._inflight.pop(ordinal, _MISSING) is not _MISSING

    def _try_requeue(self, ordinal, why: str) -> bool:
        """Re-ventilate the in-flight item for ``ordinal`` with its attempt
        bumped; False when it is not in flight or its budget is spent."""
        if ordinal is None:
            return False
        with self._inflight_lock:
            vitem = self._inflight.get(ordinal)
        if vitem is None or vitem.attempt >= self._max_requeue:
            return False
        retry = VentilatedItem(ordinal, vitem.item, vitem.attempt + 1)
        with self._inflight_lock:
            self._inflight[ordinal] = retry
        # a requeue supersedes an outstanding hedge of this ordinal
        self._hedged_attempt.pop(ordinal, None)
        self._requeued_items += 1
        self._m_requeued.add(1)
        logger.warning("Requeueing work item %s after %s (attempt %d/%d)",
                       ordinal, why, retry.attempt, self._max_requeue)
        if not self._try_enqueue(retry):
            self._pending_requeue.append(retry)
        return True

    def _flush_pending_requeues(self) -> None:
        while self._pending_requeue and self._try_enqueue(self._pending_requeue[0]):
            self._pending_requeue.pop(0)

    def _requeue_lost(self, ordinal, why: str, exhausted_kind: str = "infra") -> None:
        """A worker died or hung holding ``ordinal``: requeue it, or settle it
        as a :class:`WorkerError` delivered at its position once its budget
        is spent (``'data'`` for hangs: an item that hung every worker that
        took it quarantines under a skip policy)."""
        if ordinal is None or self._try_requeue(ordinal, why):
            return
        with self._inflight_lock:
            vitem = self._inflight.pop(ordinal, None)
        if vitem is None:
            return  # delivered before the worker died: nothing lost
        self._hedged_attempt.pop(ordinal, None)
        err = WorkerError(
            f"Work item {ordinal} lost to {why}; requeue budget exhausted"
            f" ({vitem.attempt} requeue(s) of max {self._max_requeue})"
            + (" - repeatedly hung item, quarantine-eligible"
               if exhausted_kind == "data" else " - possible crash/OOM"),
            kind=exhausted_kind, ordinal=ordinal, item=vitem.item)
        self._store(ordinal, err)

    def _hedge_threshold(self) -> Optional[float]:
        """The hedge age in seconds, or None (``petastorm_tpu/pool.py:
        438-457``).  ``'auto'`` is 4x the p99 of this process's recorded
        decode latency, floored at 0.5 s, once 20 decodes are recorded; None
        before that and without telemetry."""
        h = self._hedge_after
        if h is None:
            return None
        if h == "auto":
            if not self._telemetry.enabled:
                return None
            hist = self._telemetry.histogram("stage.decode.latency_s")
            if getattr(hist, "count", 0) < 20:
                return None
            return max(4.0 * hist.quantile(0.99), 0.5)
        return float(h)

    def _hedge(self, ordinal, why: str) -> bool:
        """Re-issue the in-flight item for ``ordinal`` speculatively (attempt
        bumped); the ledger drops whichever copy finishes second."""
        if ordinal is None or ordinal in self._hedged_attempt:
            return False
        with self._inflight_lock:
            vitem = self._inflight.get(ordinal)
        if vitem is None or vitem.attempt >= self._max_requeue:
            return False
        copy = VentilatedItem(ordinal, vitem.item, vitem.attempt + 1)
        if not self._try_enqueue(copy):
            return False  # no room: re-evaluated on the next sweep
        with self._inflight_lock:
            self._inflight[ordinal] = copy
        self._hedged_attempt[ordinal] = copy.attempt
        self._hedged_items += 1
        self._m_hedged.add(1)
        logger.info("Hedging work item %s after %s (speculative attempt %d/%d;"
                    " first result wins)", ordinal, why, copy.attempt, self._max_requeue)
        return True

    def _note_delivery(self, ordinal, attempt: int) -> None:
        """First arrival for ``ordinal``: count a hedge win when the hedge
        copy's attempt (or a later one) made it."""
        hedged_at = self._hedged_attempt.pop(ordinal, None)
        if hedged_at is not None and attempt >= hedged_at:
            self._hedge_wins += 1
            self._m_hedge_wins.add(1)

    def _store(self, ordinal: int, outcome: Any) -> None:
        with self._results_lock:
            self._results[ordinal] = (outcome, True)

    def _accept(self, result) -> None:
        """Settle one arrival (consumer thread): absorb an infra failure by a
        requeue, drop a duplicate, else hold the outcome for its turn."""
        if isinstance(result, _Failure):
            ordinal = result.ordinal
            if result.kind == "infra" and self._try_requeue(
                    ordinal, f"in-worker infra failure ({result.exc_type})"):
                return
            self._hedged_attempt.pop(ordinal, None)
            if not self._settle(ordinal):
                logger.warning("Dropping duplicate failure for already-delivered work item"
                               " %s (%s)", ordinal, result.exc_type)
                return
            self._store(ordinal, result)
            return
        value = self._unwrap(result.value)
        if not self._settle(result.ordinal):
            return  # duplicate: the first arrival was kept
        if result.ordinal != self._awaited:
            self._m_reordered.add(1)
        self._note_delivery(result.ordinal, result.attempt)
        self._count_delivery(result.value)
        self._store(result.ordinal, value)

    def _unwrap(self, value: Any) -> Any:
        return value

    def _count_delivery(self, raw: Any) -> None:
        pass

    # -- the consumer ----------------------------------------------------------

    def _next_arrival(self, timeout: float):
        """One result from the workers; raises ``queue.Empty``."""
        raise NotImplementedError

    def _service_faults(self) -> None:
        """Reap dead workers, sweep liveness, flush parked requeues; raises
        an unattributable WorkerError when no worker is left."""
        raise NotImplementedError

    def imap(self, items: Iterable[Any], start: int = 0,
             on_idle: Optional[IdleCallback] = None) -> Iterator[Any]:
        """Yield ``worker(item)`` for each item, in order (or, under a skip
        policy, a ``WorkerError`` for a failed one); the first is item
        ``start`` of the stream.  While it waits it services the workers'
        faults and calls ``on_idle`` with the seconds since the last
        arrival."""
        if self._factory is None:
            raise PetastormTpuError("Executor not started")
        self._start = start
        with self._results_lock:  # a reader's reset() maps a second stream
            self._total = None
        with self._ventilator_lock:
            if self._pause.is_set():  # a quiesce() came first: issue nothing
                return
            ventilator = threading.Thread(target=self._ventilate, args=(items,),
                                          name=self._VENTILATOR_NAME, daemon=True)
            ventilator.start()
            self._ventilator = ventilator
        ordinal = start
        last_arrival = time.monotonic()
        while True:
            self._awaited = ordinal
            with self._results_lock:
                entry = self._results.pop(ordinal, None)
                ended = (entry is None and self._total is not None
                         and ordinal >= start + self._total)
            if ended:
                return
            if entry is None:
                if self._stop.is_set():
                    raise ReaderClosedError("Executor is stopped")
                try:
                    self._accept(self._next_arrival(_POLL_S))
                    last_arrival = time.monotonic()
                    if self._telemetry.enabled:
                        self._stamp_depths()
                except queue.Empty:
                    self._service_faults()
                    if on_idle is not None:
                        on_idle(self._idle_seconds(last_arrival))
                continue
            outcome, held_slot = entry
            if held_slot:
                self._window.release()
            ordinal += 1
            if isinstance(outcome, (_Failure, WorkerError)):
                err = outcome.error() if isinstance(outcome, _Failure) else outcome
                if self._stop_on_failure:
                    self.stop()
                    raise err
                yield err
                continue
            self._consumed += 1
            yield outcome

    def _idle_seconds(self, last_arrival: float) -> float:
        """The seconds ``imap`` has waited that count as a stall: since the
        last arrival (or since ``imap`` began)."""
        return time.monotonic() - last_arrival

    def _in_queue_depth(self) -> int:
        raise NotImplementedError

    def _stamp_depths(self) -> None:
        """The queue-depth gauges, at an arrival (``petastorm_tpu/pool.py:1215``)."""
        with self._results_lock:
            self._g_out_depth.set(len(self._results))
        try:
            self._g_in_depth.set(self._in_queue_depth())
        except (NotImplementedError, OSError):
            pass

    def quiesce(self, start: int = 0) -> int:
        """Stop ventilating and wait for the ventilator; returns the absolute
        count of items issued (``start`` if ``imap`` has not begun).  The
        issued items still deliver: ``imap`` ends after the last of them."""
        with self._ventilator_lock:
            self._pause.set()
            ventilator = self._ventilator
        if ventilator is None:
            return start
        ventilator.join()  # _total is final once the ventilator has ended
        return self._start + (self._total or 0)

    def _raise_no_workers(self, message: str) -> None:
        if self._stop_on_failure:
            self.stop()
        raise WorkerError(message, kind="infra")

    def stop(self) -> None:
        self._stopped = True
        self._stop.set()
        self._wake()

    @property
    def diagnostics(self) -> dict:
        """The ledger's counters (``petastorm_tpu/pool.py:555-562``)."""
        with self._results_lock:
            held = len(self._results)
        return {"ventilated": self._ventilated, "consumed": self._consumed,
                "requeued_items": self._requeued_items,
                "hung_workers_killed": self._hung_workers_killed,
                "hung_workers_abandoned": self._hung_workers_abandoned,
                "hedged_items": self._hedged_items,
                "hedge_wins": self._hedge_wins,
                "reorder_held": held,
                "workers_count": self._workers_count,
                "workers_retired": len(self._retired),
                "stopped": self._stopped}


class SerialExecutor:
    """Runs every item inline, in the consumer's thread
    (``petastorm_tpu/pool.py:572``).

    ``item_deadline_s`` and ``hedge_after_s`` are accepted with a warning
    that they do nothing: there is no other worker to kill, abandon or
    hedge onto.  A watchdog thread, started at the first item, logs a
    warning naming an item that has run inside the worker function for
    longer than ``stall_warn_s`` (default ``PETASTORM_TPU_STALL_WARN_S``,
    120 s); the reader's ``stall_abort_s`` cannot interrupt inline work.
    An ``'infra'`` failure (a ``MemoryError``, a chaos kill) is retried
    inline up to ``max_requeue_attempts`` times.
    """

    def __init__(self, stop_on_failure: bool = True,
                 max_requeue_attempts: int = DEFAULT_REQUEUE_ATTEMPTS,
                 item_deadline_s: Optional[float] = None, hedge_after_s=None,
                 stall_warn_s: Optional[float] = None, telemetry=None):
        _check_liveness_args(item_deadline_s, hedge_after_s)
        self._telemetry = tele = _resolve_telemetry(telemetry)
        self._m_requeued = tele.counter("errors.requeued_items")
        # the JAX serial pool's instruments, so its series names are the
        # thread pool's (nothing waits or hedges here: they stay 0)
        for name in ("queue.input_full_wait_s", "queue.results_full_wait_s",
                     "liveness.hung_workers_killed", "liveness.hung_workers_abandoned",
                     "liveness.hedged_items", "liveness.hedge_wins"):
            tele.counter(name)
        for name in ("pool.in_queue_depth", "pool.results_queue_depth"):
            tele.gauge(name)
        if tele.enabled:
            tele.register_stage("ventilate")
        if item_deadline_s is not None or hedge_after_s is not None:
            logger.warning(
                "item_deadline_s/hedge_after_s are inoperative on the serial"
                " executor (work runs inline on the consumer thread); use the"
                " thread or process pool for liveness recovery")
        self._factory: Optional[WorkerFactory] = None
        self._stop_on_failure = stop_on_failure
        self._max_requeue = max_requeue_attempts
        self._stopped = False
        self._paused = False
        self._issued = 0
        self._consumed = 0
        self._lock = threading.Lock()  # quiesce comes from another thread
        self.requeued_items = 0
        self._stall_warn_s = (float(stall_warn_s) if stall_warn_s is not None
                              else env_seconds("PETASTORM_TPU_STALL_WARN_S", 120.0))
        self._watch_thread: Optional[threading.Thread] = None
        self._watch_item: Optional[VentilatedItem] = None  # None: no item in flight
        self._watch_since = 0.0
        self._watch_gen = 0  # one warning an item

    def start(self, worker_factory: WorkerFactory) -> None:
        self._factory = worker_factory

    def _watch_loop(self) -> None:
        warned_gen = -1
        poll_s = min(max(self._stall_warn_s / 4.0, 0.05), 5.0)
        while not self._stopped:
            time.sleep(poll_s)
            item = self._watch_item
            if item is None:
                continue
            gen, elapsed = self._watch_gen, time.monotonic() - self._watch_since
            if elapsed > self._stall_warn_s and gen != warned_gen:
                warned_gen = gen
                logger.warning(
                    "Serial executor work item %s has run for %.0fs inside its"
                    " worker function (PETASTORM_TPU_STALL_WARN_S=%.0f);"
                    " pipeline state: %s", item.ordinal, elapsed, self._stall_warn_s,
                    self.diagnostics)

    def _watch(self, vitem: Optional[VentilatedItem]) -> None:
        """Stamp the watchdog's slot: the time and generation before the
        item, so a non-None read sees the current ones."""
        if vitem is not None:
            self._watch_since = time.monotonic()
            self._watch_gen += 1
        self._watch_item = vitem

    def imap(self, items: Iterable[Any], start: int = 0,
             on_idle: Optional[IdleCallback] = None) -> Iterator[Any]:
        """Yield ``worker(item)`` for each item (or, under a skip policy, a
        ``WorkerError`` for a failed one); the first is item ``start`` of
        the stream.  ``on_idle`` is never called: nothing waits here."""
        if self._factory is None:
            raise PetastormTpuError("Executor not started")
        fn = self._factory()
        takes_ventilated = getattr(fn, "takes_ventilated_items", False)
        if self._stall_warn_s > 0 and self._watch_thread is None:
            self._watch_thread = threading.Thread(
                target=self._watch_loop, daemon=True, name="petastorm-torch-serial-watchdog")
            self._watch_thread.start()
        self._issued = start
        tele = self._telemetry
        for item in items:
            t0 = time.perf_counter_ns() if tele.enabled else 0
            with self._lock:
                if self._stopped or self._paused:
                    return
                ordinal = self._issued
                self._issued += 1
            if tele.enabled:
                tele.record_stage("ventilate", t0, time.perf_counter_ns() - t0,
                                  {"ordinal": ordinal})
            vitem = VentilatedItem(ordinal, item)
            while True:
                self._watch(vitem if self._stall_warn_s > 0 else None)
                try:
                    result = _call(fn, vitem, takes_ventilated)
                    break
                except BaseException as exc:  # noqa: BLE001 - classified below
                    if not _crashed(exc) and not isinstance(exc, Exception):
                        # KeyboardInterrupt and the like are the consumer's
                        # control flow here: they propagate untouched
                        raise
                    failure = _Failure(exc, ordinal, item)
                    if _crashed(exc):
                        failure.kind = "infra"
                    if failure.kind == "infra" and vitem.attempt < self._max_requeue:
                        # no other worker to move the item to: retry inline
                        vitem = VentilatedItem(ordinal, item, vitem.attempt + 1)
                        self.requeued_items += 1
                        self._m_requeued.add(1)
                        logger.warning("Serial worker infra failure on item %s (%s);"
                                       " retrying inline (attempt %d/%d)", ordinal,
                                       failure.exc_type, vitem.attempt, self._max_requeue)
                        continue
                    if self._stop_on_failure and failure.kind == "data":
                        raise  # raise mode: the original exception as-is
                    result = failure.error()
                    break
                finally:
                    self._watch_item = None
            if isinstance(result, WorkerError) and self._stop_on_failure:
                raise result
            if not isinstance(result, WorkerError):
                self._consumed += 1
            yield result

    def quiesce(self, start: int = 0) -> int:
        """Issue no further item; returns the absolute count issued (``start``
        if ``imap`` has not begun).  An item is issued as it is taken, so
        every issued item delivers."""
        with self._lock:
            self._paused = True
            return max(self._issued, start)

    def stop(self) -> None:
        self._stopped = True

    def join(self, timeout: Optional[float] = None) -> None:
        pass

    @property
    def diagnostics(self) -> dict:
        return {"ventilated": self._issued, "consumed": self._consumed,
                "requeued_items": self.requeued_items,
                "hung_workers_killed": 0, "hung_workers_abandoned": 0,
                "hedged_items": 0, "hedge_wins": 0, "stopped": self._stopped}


class ThreadedExecutor(_LedgerExecutor):
    """A pool of decode threads behind a ventilator thread
    (``petastorm_tpu/pool.py:749``).

    pyarrow reads and the native decode release the GIL, so threads scale
    with cores.  At most ``workers_count + results_queue_size`` items are in
    flight (queued, decoding, or decoded but not yet delivered), which
    bounds memory while the consumer restores ventilation order.
    """

    def __init__(self, workers_count: int = 4, results_queue_size: int = 10,
                 stop_on_failure: bool = True,
                 max_requeue_attempts: int = DEFAULT_REQUEUE_ATTEMPTS,
                 item_deadline_s: Optional[float] = None, hedge_after_s=None,
                 telemetry=None):
        super().__init__(workers_count, results_queue_size, stop_on_failure,
                         max_requeue_attempts, item_deadline_s, hedge_after_s, telemetry)
        self._in_q: "queue.Queue" = queue.Queue()
        #: worker results and the ventilator's end marker, for the consumer
        self._arrivals: "queue.SimpleQueue" = queue.SimpleQueue()
        self._threads: list = []
        #: per-slot heartbeat [ordinal or None, monotonic since], written
        #: only by the slot's thread (timestamp before ordinal)
        self._worker_state: list = []
        self._reaped: set = set()
        #: slot -> the ordinal it was abandoned on (consumer-thread state);
        #: it clears itself if the thread recovers and takes a new item
        self._abandoned: Dict[int, Any] = {}
        #: slots a join gave up on (wedged): not waited for again
        self._unjoined: set = set()

    def start(self, worker_factory: WorkerFactory) -> None:
        self._factory = worker_factory
        with self._resize_lock:
            for _ in range(self._workers_count):
                self._spawn_slot()

    def _in_queue_depth(self) -> int:
        return self._in_q.qsize()

    def _spawn_slot(self) -> int:
        """Start a worker thread, in a cleanly retired slot when one is free
        (hold ``_resize_lock``; ``petastorm_tpu/pool.py:883``)."""
        for i in sorted(self._retired):
            if not self._threads[i].is_alive():
                self._retired.discard(i)
                self._reaped.discard(i)
                self._worker_state[i] = [None, time.monotonic()]
                break
        else:
            i = len(self._worker_state)
            # state before thread: readers index states by thread index
            self._worker_state.append([None, time.monotonic()])
            self._threads.append(None)
        t = threading.Thread(target=self._work, args=(i,), name=f"petastorm-torch-worker-{i}",
                             daemon=True)
        self._threads[i] = t
        t.start()
        return i

    def _active_slots(self) -> list:
        """The slots of the live worker plane."""
        return [i for i, t in enumerate(self._threads)
                if i not in self._retired and i not in self._retiring
                and i not in self._abandoned and t.is_alive()]

    def resize_workers(self, n: int) -> int:
        """Grow or shrink the worker plane to ``n`` threads in place
        (``petastorm_tpu/pool.py:849``, autotune's worker knob).  A grow
        starts threads (in retired slots first); a shrink marks the highest
        live slots, each of which finishes its item and exits, so no item is
        dropped or repeated.  The window follows: ``n`` plus the results
        bound.  From the first call the count is a target the pool heals to.
        Returns the new count."""
        n = max(1, int(n))
        with self._resize_lock:
            self._target_managed = True
            if self._factory is not None:
                active = self._active_slots()
                if len(active) < n:
                    for _ in range(n - len(active)):
                        self._spawn_slot()
                else:
                    self._retiring.update(sorted(active, reverse=True)[:len(active) - n])
            self._workers_count = n
            self._window.resize(workers=n)
            return n

    def _heal_to_target(self) -> None:
        """Respawn the slots lost to deaths and abandoned hangs, up to the
        target, once ``resize_workers`` manages the count (``petastorm_tpu/
        pool.py:921``): a requeued item needs a live worker to land on."""
        if not self._target_managed or self._factory is None or self._stop.is_set():
            return
        with self._resize_lock:
            for _ in range(self._workers_count - len(self._active_slots())):
                self._spawn_slot()

    def _try_enqueue(self, vitem: VentilatedItem) -> bool:
        self._in_q.put(vitem)  # unbounded: the window bounds what is issued
        return True

    _issue = _try_enqueue

    def _wake(self) -> None:
        self._arrivals.put(None)

    def _work(self, index: int) -> None:
        state = self._worker_state[index]
        try:
            fn = self._factory()
            takes_ventilated = getattr(fn, "takes_ventilated_items", False)
        except BaseException as exc:  # noqa: BLE001 - delivered with each item
            fn, factory_exc, takes_ventilated = None, exc, False
        while not self._stop.is_set():
            if index in self._retiring:
                # retire at the item boundary, marked before the exit so the
                # reap sweep never takes it for a death
                with self._resize_lock:
                    self._retiring.discard(index)
                    self._retired.add(index)
                return
            try:
                vitem = self._in_q.get(timeout=_POLL_S)
            except queue.Empty:
                continue
            state[1] = time.monotonic()
            state[0] = vitem.ordinal
            try:
                if fn is None:
                    raise factory_exc
                result = _Ok(vitem.ordinal, _call(fn, vitem, takes_ventilated), vitem.attempt)
            except BaseException as exc:  # noqa: BLE001 - delivered to the consumer
                if _crashed(exc):
                    # die like a killed worker: no result, heartbeat left
                    # naming the item so the consumer requeues it
                    return
                result = _Failure(exc, vitem.ordinal, vitem.item)
            self._arrivals.put(result)
            state[0] = None
            state[1] = time.monotonic()

    def _next_arrival(self, timeout: float):
        result = self._arrivals.get(timeout=timeout)
        if result is None:  # the ventilator ended: look at the total again
            raise queue.Empty
        return result

    def _service_faults(self) -> None:
        """``petastorm_tpu/pool.py:1075``: reap dead threads and requeue their
        items, sweep the deadlines and hedges, and raise once every slot is
        dead or abandoned."""
        self._flush_pending_requeues()
        if self._stop.is_set():
            return
        for i, t in enumerate(self._threads):
            if t.is_alive() or i in self._reaped or i in self._retired:
                continue
            self._reaped.add(i)
            ordinal = self._worker_state[i][0]
            logger.warning("Worker thread %d died while on item %s", i, ordinal)
            self._worker_state[i][1] = time.monotonic()
            self._worker_state[i][0] = None
            self._requeue_lost(ordinal, f"worker thread {i} death")
        self._check_liveness()
        self._heal_to_target()
        if ((self._reaped or self._abandoned) and self._threads
                and all(not t.is_alive() or i in self._abandoned
                        for i, t in enumerate(self._threads) if i not in self._retired)
                and self._arrivals.empty()):
            self._raise_no_workers("All worker threads died or were abandoned as"
                                   " hung; no result will arrive")

    def _check_liveness(self) -> None:
        """``petastorm_tpu/pool.py:1123``: a slot busy on one item past
        ``item_deadline_s`` is abandoned and its item requeued; one busy past
        the hedge threshold has its item re-issued when a worker is idle."""
        deadline = self._item_deadline_s
        hedge_s = self._hedge_threshold()
        if deadline is None and hedge_s is None:
            return
        now = time.monotonic()
        idle = any(s[0] is None for i, s in enumerate(self._worker_state)
                   if i not in self._abandoned and self._threads[i].is_alive())
        for i, t in enumerate(self._threads):
            s = self._worker_state[i]
            ordinal = s[0]
            if ordinal is None:
                if self._abandoned.pop(i, None) is not None:
                    self._trim_recovered(i)  # recovered and went idle
                continue
            if self._abandoned.get(i) == ordinal:
                continue  # this hang is handled
            self._abandoned.pop(i, None)  # recovered onto a new item
            if not t.is_alive():
                continue  # the reap path owns dead workers
            elapsed = max(0.0, now - s[1])
            if deadline is not None and elapsed > deadline:
                self._abandoned[i] = ordinal
                self._hung_workers_abandoned += 1
                self._m_hung_abandoned.add(1)
                logger.warning(
                    "Worker thread %d hung on item %s for %.1fs > item_deadline_s=%.1f;"
                    " abandoning the slot and requeueing the item onto a sibling worker",
                    i, ordinal, elapsed, deadline)
                self._requeue_lost(ordinal, f"hung worker thread {i} (exceeded item"
                                   f" deadline {deadline:.1f}s)", exhausted_kind="data")
                continue
            if (hedge_s is not None and elapsed > hedge_s and idle
                    and self._hedge(ordinal, f"straggling {elapsed:.1f}s on worker thread"
                                    f" {i} (hedge threshold {hedge_s:.1f}s)")):
                idle = False  # one speculative copy a sweep

    def _trim_recovered(self, index: int) -> None:
        """Retire a recovered abandoned slot that overshoots the managed
        target (its replacement was healed in meanwhile;
        ``petastorm_tpu/pool.py:935``)."""
        if not self._target_managed:
            return
        with self._resize_lock:
            if len(self._active_slots()) > self._workers_count:
                self._retiring.add(index)

    def join(self, timeout: float = 5.0) -> None:
        """Wait for the threads, ``timeout`` seconds in all.  Not waited for:
        an abandoned (hung) slot, a slot still busy on an item that was
        already delivered (a hedge's loser), and a slot an earlier
        ``join`` gave up on.  The threads are daemons: one wedged inside
        user code cannot block the exit, and a warning names it."""
        with self._ventilator_lock:
            ventilator = self._ventilator
        with self._inflight_lock:
            inflight = set(self._inflight)
        skip = set(self._abandoned) | self._unjoined | {
            i for i, s in enumerate(self._worker_state)
            if s[0] is not None and s[0] not in inflight}
        deadline = time.monotonic() + timeout
        for i, t in enumerate(self._threads + ([ventilator] if ventilator is not None else [])):
            if i not in skip:
                t.join(max(0.0, deadline - time.monotonic()))
        alive = [i for i, t in enumerate(self._threads) if t.is_alive() and i not in skip]
        if alive:
            self._unjoined.update(alive)
            logger.warning("Abandoning %d wedged daemon worker thread(s) %s after %.0fs",
                           len(alive), [self._threads[i].name for i in alive], timeout)

    @property
    def diagnostics(self) -> dict:
        now = time.monotonic()
        busy = []
        for i, s in enumerate(self._worker_state):
            ordinal = s[0]  # read once: the worker may clear it meanwhile
            if ordinal is not None:
                busy.append((i, ordinal, round(max(0.0, now - s[1]), 3)))
        return {**super().diagnostics,
                "in_queue_size": self._in_q.qsize(),
                "results_queue_bound": self._window.bound,
                # [(worker index, item ordinal, seconds on it)]: a stalled
                # pipeline names the exact worker and work item
                "workers_busy": busy,
                "workers_abandoned": sorted(self._abandoned)}


class _CrashSafeResultsChannel:
    """Bounded results transport whose writes happen in the worker's only
    thread (``petastorm_tpu/pool.py:1304``).

    An ``mp.Queue`` sends through a feeder thread under a lock shared by
    every writer; a worker that dies abruptly while its feeder holds the
    lock wedges every other worker.  Here ``put`` sends from the worker's
    main thread under a cross-process lock, and the pool never kills a
    worker that is mid-delivery (its heartbeat says so), so no kill of the
    pool's lands inside ``send``.  A slot semaphore, acquired by the writer
    and released by the consumer after ``recv``, bounds the channel.
    """

    def __init__(self, ctx, bound: int):
        self._rx, self._tx = ctx.Pipe(duplex=False)
        self._wlock = ctx.Lock()
        self._slots = ctx.BoundedSemaphore(bound)

    def put(self, obj, stop_event) -> bool:
        """Worker side; False = dropped (shutdown or closed channel)."""
        while not self._slots.acquire(timeout=_POLL_S):
            if stop_event.is_set():
                return False
        try:
            with self._wlock:
                self._tx.send(obj)
        except (OSError, ValueError):
            try:
                self._slots.release()
            except ValueError:
                pass
            return False
        return True

    def get(self, timeout: Optional[float] = None):
        """Consumer side; raises ``queue.Empty`` on timeout."""
        if not self._rx.poll(timeout):
            raise queue.Empty
        obj = self._rx.recv()
        try:
            self._slots.release()
        except ValueError:
            pass
        return obj

    def worker_init(self) -> None:
        """Child side: drop the inherited read end, so that the parent's
        :meth:`close` turns a blocked ``send`` into an error."""
        try:
            self._rx.close()
        except OSError:
            pass

    def close(self) -> None:
        for conn in (self._rx, self._tx):
            try:
                conn.close()
            except OSError:
                pass


def _portable_failure(exc: BaseException, ordinal=None, item=None) -> _Failure:
    """A failure to send across the process boundary: without its exception
    when that does not pickle (the formatted traceback travels anyway)."""
    failure = _Failure(exc, ordinal, item)
    try:
        pickle.dumps(exc)
    except Exception:  # noqa: BLE001 - the cause stays behind
        failure.exc = None
    return failure


def _process_worker_main(worker_factory, in_queue, out_queue, stop_event, index,
                         heartbeats, ready, peaks, retire_flags):
    """A worker process's loop (``petastorm_tpu/pool.py:1419``).

    ``heartbeats``: shared doubles, three a slot: [ordinal (-1 idle), wall
    clock since, ordinal being delivered (-1 none)].  The timestamp is
    written before the ordinal; the parent reads ordinal, time, ordinal
    again.  The ordinal stays set until the result is sent, so a worker that
    dies names the item it held.  ``ready``: the wall clock at which this
    worker's function was built (its spawn time, read by the parent).
    ``peaks``: the largest arena use this worker saw after an encode.
    ``retire_flags``: a set flag makes the worker exit at its next item
    boundary (``resize_workers``' shrink).
    """
    out_queue.worker_init()
    try:
        fn = worker_factory()
    except BaseException as exc:  # noqa: BLE001
        out_queue.put(_portable_failure(exc), stop_event)
        return
    fn.stop_event = stop_event  # the shm encoder ends a full-arena wait on stop
    fn.peak_cell = (peaks, index)
    takes_ventilated = fn.takes_ventilated_items
    ready[index] = time.time()
    base = 3 * index
    while not stop_event.is_set():
        if retire_flags[index]:
            return
        try:
            vitem = in_queue.get(timeout=_POLL_S)
        except queue.Empty:
            continue
        heartbeats[base + 1] = time.time()
        heartbeats[base] = float(vitem.ordinal)
        try:
            result = _Ok(vitem.ordinal, _call(fn, vitem, takes_ventilated), vitem.attempt)
        except BaseException as exc:  # noqa: BLE001
            if _crashed(exc):
                os._exit(17)  # die like an OOM kill: no result, heartbeat set
            result = _portable_failure(exc, vitem.ordinal, vitem.item)
        heartbeats[base + 2] = float(vitem.ordinal)  # delivering: not killed
        out_queue.put(result, stop_event)
        heartbeats[base] = -1.0
        heartbeats[base + 1] = time.time()
        heartbeats[base + 2] = -1.0


#: one spawn at a time may run without the main script (see _without_main)
_SPAWN_LOCK = threading.Lock()


def _refers_to_main(obj) -> bool:
    """Whether ``obj`` pickles with a reference into the main script: a
    worker then needs that script run, as spawn does by default.  A false
    positive (a string that merely contains the name) only costs a slower
    start."""
    from multiprocessing.reduction import ForkingPickler

    data = bytes(ForkingPickler.dumps(obj))
    return b"__main__" in data or b"__mp_main__" in data


@contextlib.contextmanager
def _without_main():
    """Spawn children that skip the parent's main script: the preparation
    data spawn sends them loses its main-module keys while this holds."""
    from multiprocessing import spawn

    with _SPAWN_LOCK:
        prepare = spawn.get_preparation_data

        def without_main(name):
            data = prepare(name)
            data.pop("init_main_from_path", None)
            data.pop("init_main_from_name", None)
            return data

        spawn.get_preparation_data = without_main
        try:
            yield
        finally:
            spawn.get_preparation_data = prepare


def _rss_bytes(pid: int) -> Optional[int]:
    """Resident set of a process (``/proc/<pid>/status`` ``VmRSS``)."""
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


class ProcessExecutor(_LedgerExecutor):
    """Spawned worker processes whose results travel through a shared-memory
    arena (``petastorm_tpu/pool.py:1525``).

    Raises at construction when the arena library cannot be built (the JAX
    pool falls back to plain queues then).  ``shm_size_bytes`` sizes the
    arena (default 256 MiB, the JAX pool's): it must hold the in-flight
    window of result batches, ``workers_count + results_queue_size``, and
    what the consumer still holds, or batches wait for room and after 10 s
    travel pickled (``diagnostics()['pickled_batches']``).  ``diagnostics()``
    also counts the batches that came through the arena (``shm_batches``),
    the columns and rows decoded straight into arena slots
    (``slot_columns``, ``slot_rows``), the arena's high-water mark
    (``shm_high_water_bytes``, the largest use a worker saw after an encode
    or the consumer at a delivery), and the workers' spawn seconds and
    resident sets.

    The workers' start-up is not a stall: the idle seconds ``imap`` hands to
    ``on_idle`` (the reader's stall watchdog) count from the later of the
    last arrival and the moment the first worker came up, and stay 0 while
    none has.  The JAX pool counts the spawn too, so a ``stall_abort_s``
    shorter than the spawn (seconds when the parent's main script imports
    torch) aborted a healthy pool before its first batch.  A pool whose
    workers all die while starting still raises (``_service_faults``).
    """

    DEFAULT_SHM_BYTES = 256 * 2 ** 20

    def __init__(self, workers_count: int = 4, results_queue_size: int = 10,
                 stop_on_failure: bool = True,
                 max_requeue_attempts: int = DEFAULT_REQUEUE_ATTEMPTS,
                 item_deadline_s: Optional[float] = None, hedge_after_s=None,
                 shm_size_bytes: Optional[int] = None, telemetry=None,
                 max_workers: Optional[int] = None):
        super().__init__(workers_count, results_queue_size, stop_on_failure,
                         max_requeue_attempts, item_deadline_s, hedge_after_s, telemetry)
        from petastorm_tpu_torch.native import load_arena

        load_arena()  # raises when the library cannot be built
        import multiprocessing as mp

        self._ctx = mp.get_context("spawn")
        self._shm_size = int(shm_size_bytes or self.DEFAULT_SHM_BYTES)
        #: worker slots made at start: resize_workers grows up to this many
        self._slot_capacity = max(workers_count, int(max_workers or workers_count))
        cap = self._slot_capacity
        self._in_queue = self._ctx.Queue(cap + 2)
        window = cap + max(results_queue_size, 1)
        # room for the window and for duplicates of requeued or hedged items
        self._out_queue = _CrashSafeResultsChannel(self._ctx, window + 2 * cap)
        self._stop_event = self._ctx.Event()
        self._procs: list = []
        self._spawned_at: list = []
        self._reaped: set = set()
        self._arena = None
        self._needs_main = True
        self._heartbeats = None
        self._ready = None
        self._peaks = None
        self._consumer_peak = 0
        self._up_at = None  # time.monotonic() when the parent first saw a worker up
        self._shm_batches = 0
        self._pickled_batches = 0
        self._slot_columns = 0
        self._slot_rows = 0
        self._retire_flags = None

    @property
    def max_resize_workers(self) -> int:
        """The most workers ``resize_workers`` can run (the slots made at
        start); the autotune controller caps its worker knob here."""
        return self._slot_capacity

    def _in_queue_depth(self) -> int:
        return self._in_queue.qsize()

    def start(self, worker_factory: WorkerFactory) -> None:
        if self._procs:
            raise PetastormTpuError("Executor already started")
        from petastorm_tpu_torch.native import SharedArena
        from petastorm_tpu_torch.native.transport import ShmResultEncoder

        self._arena = SharedArena.create(self._shm_size)
        self._factory = ShmResultEncoder(worker_factory, self._arena.name)
        self._needs_main = _refers_to_main(self._factory)
        cap = self._slot_capacity
        self._heartbeats = self._ctx.RawArray("d", 3 * cap)
        self._ready = self._ctx.RawArray("d", cap)
        self._peaks = self._ctx.RawArray("d", cap)
        self._retire_flags = self._ctx.RawArray("b", cap)
        for i in range(cap):
            self._heartbeats[3 * i] = -1.0
            self._heartbeats[3 * i + 2] = -1.0
        with self._resize_lock:
            for i in range(self._workers_count):
                self._procs.append(None)
                self._spawned_at.append(0.0)
                self._spawn_worker(i)

    def resize_workers(self, n: int) -> int:
        """Grow or shrink the worker processes to ``n`` in place
        (``petastorm_tpu/pool.py:1681``), at most :attr:`max_resize_workers`.
        A grow respawns retired slots, then spawns into unused ones; a
        shrink flags the highest live slots, each of which delivers its item
        and exits at the item boundary.  Returns the new count."""
        n = max(1, min(int(n), self._slot_capacity))
        with self._resize_lock:
            self._target_managed = True
            if self._procs:
                self._reap_retired()
                active = [i for i, p in enumerate(self._procs)
                          if i not in self._retired and i not in self._retiring
                          and i not in self._reaped and p.is_alive()]
                if len(active) < n:
                    for i in sorted(self._retired):
                        if len(active) >= n:
                            break
                        self._retired.discard(i)
                        self._retire_flags[i] = 0
                        self._clear_heartbeat(i)
                        self._spawn_worker(i)
                        active.append(i)
                    while len(active) < n and len(self._procs) < self._slot_capacity:
                        i = len(self._procs)
                        self._procs.append(None)
                        self._spawned_at.append(0.0)
                        self._spawn_worker(i)
                        active.append(i)
                elif len(active) > n:
                    for i in sorted(active, reverse=True)[:len(active) - n]:
                        self._retiring.add(i)
                        self._retire_flags[i] = 1
            self._workers_count = n
            self._window.resize(workers=n)
            return n

    def _reap_retired(self) -> None:
        """Move the flagged slots whose worker has exited to ``_retired``."""
        for i in list(self._retiring):
            if not self._procs[i].is_alive():
                self._procs[i].join(timeout=0)
                self._retiring.discard(i)
                self._retired.add(i)

    def _spawn_worker(self, index: int) -> None:
        """Spawn (or respawn, once its predecessor is dead) slot ``index``."""
        self._ready[index] = 0.0
        p = self._ctx.Process(
            target=_process_worker_main,
            args=(self._factory, self._in_queue, self._out_queue, self._stop_event, index,
                  self._heartbeats, self._ready, self._peaks, self._retire_flags),
            name=f"petastorm-torch-worker-{index}", daemon=True)
        self._spawned_at[index] = time.time()
        with contextlib.nullcontext() if self._needs_main else _without_main():
            p.start()
        self._procs[index] = p

    def _issue(self, vitem: VentilatedItem) -> bool:
        while True:
            try:
                self._in_queue.put(vitem, timeout=_POLL_S)
                return True
            except queue.Full:
                if self._stop.is_set() or self._pause.is_set():
                    return False

    def _try_enqueue(self, vitem: VentilatedItem) -> bool:
        try:
            self._in_queue.put_nowait(vitem)
            return True
        except queue.Full:
            return False

    def _next_arrival(self, timeout: float):
        return self._out_queue.get(timeout=timeout)

    def _idle_seconds(self, last_arrival: float) -> float:
        now = time.monotonic()
        if self._up_at is None:
            if not any(self._ready[i] for i in range(len(self._procs))):
                return 0.0  # still starting: no worker has built its function
            self._up_at = now
        return now - max(last_arrival, self._up_at)

    def _accept(self, result) -> None:
        if isinstance(result, _Failure) and result.ordinal is None:
            # a worker's factory failed: no item to blame
            self._raise_no_workers(f"Worker process failed to start:\n{result.formatted}")
        super()._accept(result)

    def _unwrap(self, value: Any) -> Any:
        from petastorm_tpu_torch.native.transport import decode_batch

        # duplicates are decoded too: their leases free the arena blocks
        return decode_batch(self._arena, value)

    def _count_delivery(self, raw: Any) -> None:
        from petastorm_tpu_torch.native.transport import (ShmBatchRef, carries_raw_columns,
                                                          slot_column_count, slot_row_count)

        if isinstance(raw, ShmBatchRef):
            self._shm_batches += 1
            slots = slot_column_count(raw)
            self._slot_columns += slots
            if slots and self._telemetry.enabled:
                # the parent's proof of decode-into-slot (``petastorm_tpu/pool.py:1984``)
                self._telemetry.counter("decode.batch_slots").add(slots)
            self._slot_rows += slot_row_count(raw)
            self._consumer_peak = max(self._consumer_peak, self._arena.used_bytes())
        elif carries_raw_columns(raw):
            self._pickled_batches += 1

    def _read_heartbeat(self, index: int):
        """``(ordinal, since)`` of slot ``index``, torn-read safe: ordinal,
        time, ordinal again (``petastorm_tpu/pool.py:1758``)."""
        hb = self._heartbeats
        base = 3 * index
        ordinal, since = hb[base], hb[base + 1]
        for _ in range(3):
            again = hb[base]
            if again == ordinal:
                break
            ordinal, since = again, hb[base + 1]
        return ordinal, since

    def _is_delivering(self, index: int) -> bool:
        return self._heartbeats[3 * index + 2] != -1.0

    def _clear_heartbeat(self, index: int) -> None:
        self._heartbeats[3 * index + 1] = time.time()
        self._heartbeats[3 * index] = -1.0
        self._heartbeats[3 * index + 2] = -1.0

    def _service_faults(self) -> None:
        """``petastorm_tpu/pool.py:1793``: a dead worker's item, named by its
        heartbeat, is requeued onto the others; then the liveness sweep."""
        self._flush_pending_requeues()
        if self._stop.is_set():
            return
        with self._resize_lock:
            self._reap_retired()
        for i, p in enumerate(self._procs):
            if p.is_alive() or i in self._reaped or i in self._retired:
                continue
            self._reaped.add(i)
            hb_ordinal, _since = self._read_heartbeat(i)
            ordinal = int(hb_ordinal) if hb_ordinal >= 0 else None
            logger.warning("Worker process %d (pid %s) died with exit code %s while on item"
                           " %s (possible crash/OOM)", i, p.pid, p.exitcode,
                           ordinal if ordinal is not None else "<none>")
            self._clear_heartbeat(i)
            self._requeue_lost(ordinal, f"worker process {i} death (exit code {p.exitcode})")
        self._check_liveness()
        if self._procs and not any(p.is_alive() for i, p in enumerate(self._procs)
                                   if i not in self._retired):
            self._raise_no_workers("All worker processes died (possible crash/OOM);"
                                   " no result will arrive")

    def _check_liveness(self) -> None:
        """``petastorm_tpu/pool.py:1869``: a worker busy on one item past
        ``item_deadline_s`` and not delivering is SIGKILLed and respawned in
        its slot, and its item requeued; hedging as in the thread pool."""
        deadline = self._item_deadline_s
        hedge_s = self._hedge_threshold()
        if deadline is None and hedge_s is None:
            return
        now = time.time()  # heartbeats are wall clock: comparable across processes
        idle, busy = False, []
        for i, p in enumerate(self._procs):
            if not p.is_alive():
                continue
            hb_ordinal, since = self._read_heartbeat(i)
            if hb_ordinal == -1.0:
                idle = True
            else:
                busy.append((i, p, int(hb_ordinal), max(0.0, now - since)))
        for i, p, ordinal, elapsed in busy:
            if self._is_delivering(i):
                continue  # its result is moments away; a kill could orphan the send lock
            if deadline is not None and elapsed > deadline:
                logger.warning("Worker process %d (pid %s) hung on item %s for %.1fs >"
                               " item_deadline_s=%.1f; SIGKILLing and respawning",
                               i, p.pid, ordinal, elapsed, deadline)
                if self._is_delivering(i):
                    continue
                p.kill()
                p.join(timeout=10)
                # the post-mortem heartbeat is the crash ledger: the worker
                # may have moved on before the signal landed
                hb_ordinal, _since = self._read_heartbeat(i)
                self._clear_heartbeat(i)
                self._hung_workers_killed += 1
                self._m_hung_killed.add(1)
                self._spawn_worker(i)
                self._requeue_lost(int(hb_ordinal) if hb_ordinal >= 0 else None,
                                   f"hung worker process {i} SIGKILLed after exceeding item"
                                   f" deadline {deadline:.1f}s", exhausted_kind="data")
                continue
            if (hedge_s is not None and elapsed > hedge_s and idle
                    and self._hedge(ordinal, f"straggling {elapsed:.1f}s on worker process {i}"
                                    f" (hedge threshold {hedge_s:.1f}s)")):
                idle = False

    def stop(self) -> None:
        super().stop()
        self._stop_event.set()

    def join(self, timeout: float = 5.0) -> None:
        """Close the results channel, wait for the workers (``timeout`` in
        all), terminate and then kill what is left (a worker hung in user
        code never sees the stop event), and unmap the arena once no view of
        it is alive."""
        if not self._stopped:
            raise PetastormTpuError("call stop() before join()")
        with self._ventilator_lock:
            ventilator = self._ventilator
        if ventilator is not None:
            ventilator.join(timeout)
        self._out_queue.close()
        deadline = time.monotonic() + min(timeout, 2.0)
        for p in self._procs:
            p.join(max(0.0, deadline - time.monotonic()))
        for signal_fn in ("terminate", "kill"):
            left = [p for p in self._procs if p.is_alive()]
            if not left:
                break
            for p in left:
                getattr(p, signal_fn)()
            for p in left:
                p.join(timeout=2.0)
        self._in_queue.cancel_join_thread()
        self._in_queue.close()
        if self._arena is not None:
            self._arena.close()

    def high_water_bytes(self) -> int:
        """The largest arena use seen: by a worker after an encode, or by the
        consumer at a delivery."""
        peaks = [float(v) for v in self._peaks] if self._peaks is not None else []
        return int(max(peaks + [float(self._consumer_peak)]))

    @property
    def diagnostics(self) -> dict:
        diag = super().diagnostics
        diag["workers_alive"] = sum(p.is_alive() for p in self._procs)
        diag["shm_transport"] = self._arena is not None
        try:
            diag["in_queue_size"] = self._in_queue.qsize()
        except (NotImplementedError, OSError):
            pass
        if self._heartbeats is not None:
            now = time.time()
            busy = []
            for i in range(len(self._procs)):
                ordinal, since = self._read_heartbeat(i)
                if ordinal != -1.0:
                    busy.append((i, int(ordinal), round(max(0.0, now - since), 3)))
            diag["workers_busy"] = busy
            diag["worker_spawn_s"] = [
                round(self._ready[i] - self._spawned_at[i], 3) if self._ready[i] else None
                for i in range(len(self._procs))]
            diag["worker_rss_bytes"] = [_rss_bytes(p.pid) if p.is_alive() else None
                                        for p in self._procs]
        if self._arena is not None:
            diag.update(shm_size_bytes=self._arena.size,
                        shm_free_bytes=self._arena.free_bytes(),
                        shm_high_water_bytes=self.high_water_bytes(),
                        shm_batches=self._shm_batches,
                        pickled_batches=self._pickled_batches,
                        slot_columns=self._slot_columns,
                        slot_rows=self._slot_rows)
        return diag


def parse_hedge_after(value: str):
    """A CLI string -> ``hedge_after_s``: ``'auto'`` or a positive float;
    anything else raises ValueError (``petastorm_tpu/pool.py:2079``)."""
    if value == "auto":
        return "auto"
    try:
        parsed = float(value)
    except ValueError:
        raise ValueError(f"expected a number of seconds or 'auto', got {value!r}")
    if parsed <= 0:
        raise ValueError("hedge threshold must be > 0 seconds")
    return parsed


def make_executor(kind: str = "thread", workers_count: int = 4, results_queue_size: int = 10,
                  stop_on_failure: bool = True,
                  max_requeue_attempts: int = DEFAULT_REQUEUE_ATTEMPTS,
                  item_deadline_s: Optional[float] = None, hedge_after_s=None,
                  stall_warn_s: Optional[float] = None,
                  shm_size_bytes: Optional[int] = None, telemetry=None,
                  max_workers: Optional[int] = None):
    """``'thread'``, ``'process'`` or ``'serial'`` (``'dummy'``, upstream
    petastorm's name for it) (``petastorm_tpu/pool.py:2096``).

    ``stop_on_failure=False`` keeps the pool running past a delivered
    failure (the reader's ``on_error`` skip policies);
    ``max_requeue_attempts`` bounds the requeues of an item.
    ``item_deadline_s`` and ``hedge_after_s`` arm the liveness layer (the
    serial pool warns that they do nothing).  ``stall_warn_s`` reaches the
    serial pool's watchdog; the thread and process pools take their stall
    thresholds from the reader.  ``shm_size_bytes`` sizes the process
    pool's arena, and ``max_workers`` its worker slots (autotune's ceiling).
    ``telemetry`` records the pool's series.
    """
    common = dict(stop_on_failure=stop_on_failure, max_requeue_attempts=max_requeue_attempts,
                  item_deadline_s=item_deadline_s, hedge_after_s=hedge_after_s,
                  telemetry=telemetry)
    if kind == "thread":
        return ThreadedExecutor(workers_count, results_queue_size, **common)
    if kind == "process":
        return ProcessExecutor(workers_count, results_queue_size,
                               shm_size_bytes=shm_size_bytes, max_workers=max_workers,
                               **common)
    if kind in ("serial", "dummy"):
        return SerialExecutor(stall_warn_s=stall_warn_s, **common)
    raise PetastormTpuError(
        f"reader_pool_type must be 'process', 'thread', 'serial' or 'dummy', got {kind!r}")
