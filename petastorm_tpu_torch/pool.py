"""Executors that run the rowgroup decode worker over a stream of work items.

Counterpart of ``petastorm_tpu/pool.py:572 SerialExecutor`` and
``:749 ThreadedExecutor``.  Both deliver results in the order the items were
ventilated, so a reader's output is a pure function of its plan whatever the
worker count (the JAX reader gets the same from its ``deterministic='seed'``
reorder stage).  ``quiesce()`` is the counterpart of ``:2265
Ventilator.pause_and_join``: no item is issued after it, every item issued
before it still delivers, and it returns the exact count issued.  ``imap``
takes the absolute ordinal of its first item (``start``), so that count is
an absolute position in the item stream.

Failures follow the JAX pools' contract (``:61 WorkerError``, ``:178
_Failure``, ``:215 _worker_error``): a worker's exception becomes a
:class:`WorkerError` carrying its ``kind`` (``errors.classify_error``), the
item's absolute ``ordinal``, the ``item`` and the ``exc_type``, with the
formatted remote traceback in its message and the worker's own exception as
its ``__cause__``.  An ``'infra'`` failure (an in-worker ``MemoryError``) is
retried up to ``max_requeue_attempts`` times first (on a worker thread, or
inline on the serial pool) and counted in ``requeued_items``.  With
``stop_on_failure`` (the reader's ``on_error='raise'``) the thread pool
raises the ``WorkerError`` and stops, and the serial pool raises the
worker's bare exception (a spent infra budget raises a ``WorkerError`` on
both); without it (a skip policy) both yield the ``WorkerError`` at the
item's position and keep going, so the reader can quarantine the item.  The
process pool, hedging, liveness and telemetry are not part of this package
yet (ROADMAP.md queue A item 11).
"""

from __future__ import annotations

import logging
import queue
import threading
import traceback
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

from petastorm_tpu_torch.errors import (DEFAULT_REQUEUE_ATTEMPTS, PetastormTpuError,
                                        ReaderClosedError, classify_error)

logger = logging.getLogger(__name__)

_POLL_S = 0.05

WorkerFactory = Callable[[], Callable[[Any], Any]]


class WorkerError(PetastormTpuError):
    """A worker failed; the message includes the remote traceback.

    ``kind``: ``'data'`` (a property of the work item, skip-eligible) or
    ``'infra'`` (a property of the worker).  ``ordinal`` (the item's
    absolute position in the stream), ``item`` (the ``plan.WorkItem``) and
    ``exc_type`` are set when the failure is attributable to one work item;
    an unattributable failure (the item source itself failed) keeps the
    defaults and is never skipped.
    """

    def __init__(self, message: str, kind: str = "infra", ordinal=None,
                 item=None, exc_type: Optional[str] = None):
        super().__init__(message)
        self.kind = kind
        self.ordinal = ordinal
        self.item = item
        self.exc_type = exc_type


class _Failure:
    """A worker exception on its way to the consumer."""

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


class SerialExecutor:
    """Runs every item inline, in the consumer's thread."""

    def __init__(self, stop_on_failure: bool = True,
                 max_requeue_attempts: int = DEFAULT_REQUEUE_ATTEMPTS):
        self._factory: Optional[WorkerFactory] = None
        self._stop_on_failure = stop_on_failure
        self._max_requeue = max_requeue_attempts
        self._stopped = False
        self._paused = False
        self._issued = 0
        self._lock = threading.Lock()  # quiesce comes from another thread
        self.requeued_items = 0

    def start(self, worker_factory: WorkerFactory) -> None:
        self._factory = worker_factory

    def imap(self, items: Iterable[Any], start: int = 0) -> Iterator[Any]:
        """Yield ``worker(item)`` for each item (or, under a skip policy, a
        ``WorkerError`` for a failed one); the first is item ``start`` of
        the stream."""
        if self._factory is None:
            raise PetastormTpuError("Executor not started")
        fn = self._factory()
        self._issued = start
        for item in items:
            with self._lock:
                if self._stopped or self._paused:
                    return
                ordinal = self._issued
                self._issued += 1
            attempt = 0
            while True:
                try:
                    result = fn(item)
                    break
                except Exception as exc:  # noqa: BLE001 - classified below
                    # a BaseException (KeyboardInterrupt, ...) is the
                    # consumer's control flow here and propagates untouched
                    failure = _Failure(exc, ordinal, item)
                    if failure.kind == "infra" and attempt < self._max_requeue:
                        # no other worker to move the item to: retry inline
                        attempt += 1
                        self.requeued_items += 1
                        logger.warning("Serial worker infra failure on item %s (%s);"
                                       " retrying inline (attempt %d/%d)", ordinal,
                                       failure.exc_type, attempt, self._max_requeue)
                        continue
                    if self._stop_on_failure and failure.kind == "data":
                        raise  # raise mode: the original exception as-is
                    result = failure.error()
                    break
            if isinstance(result, WorkerError) and self._stop_on_failure:
                raise result
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

    def join(self) -> None:
        pass


class ThreadedExecutor:
    """A pool of decode threads behind a ventilator thread.

    pyarrow reads and OpenCV decode release the GIL, so threads scale with
    cores.  At most ``workers_count + results_queue_size`` items are in flight
    (queued, decoding or decoded but not yet consumed), which bounds memory
    while the consumer restores ventilation order.  An item holds its slot
    from ventilation until the consumer takes its result (or failure), however
    many attempts it takes, so a skipped item frees its slot like a delivered
    one.
    """

    def __init__(self, workers_count: int = 4, results_queue_size: int = 10,
                 stop_on_failure: bool = True,
                 max_requeue_attempts: int = DEFAULT_REQUEUE_ATTEMPTS):
        if workers_count < 1:
            raise PetastormTpuError("workers_count must be >= 1")
        self._workers_count = workers_count
        self._stop_on_failure = stop_on_failure
        self._max_requeue = max_requeue_attempts
        self._window = threading.Semaphore(workers_count + max(results_queue_size, 1))
        self._in_q: "queue.Queue" = queue.Queue()
        self._results: Dict[int, Any] = {}
        self._done = threading.Condition()
        self._total: Optional[int] = None  # items ventilated, once the source ends
        self._stop = threading.Event()
        self._pause = threading.Event()
        self._ventilator: Optional[threading.Thread] = None
        #: makes creating, starting and publishing the ventilator one step
        #: to quiesce(): it finds no ventilator, or a started one
        self._ventilator_lock = threading.Lock()
        self._start = 0
        self._threads = []
        self._factory: Optional[WorkerFactory] = None
        #: infra failures retried on a worker thread
        self.requeued_items = 0

    def start(self, worker_factory: WorkerFactory) -> None:
        self._factory = worker_factory
        for i in range(self._workers_count):
            t = threading.Thread(target=self._work, name=f"petastorm-torch-worker-{i}",
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _take_slot(self) -> bool:
        """Wait for an in-flight slot; False once stopped or quiesced."""
        while not self._window.acquire(timeout=_POLL_S):
            if self._stop.is_set() or self._pause.is_set():
                return False
        if self._stop.is_set() or self._pause.is_set():
            self._window.release()
            return False
        return True

    def _ventilate(self, items: Iterable[Any]) -> None:
        ordinal = 0
        try:
            for item in items:
                if not self._take_slot():
                    break
                self._in_q.put((ordinal, item, 0))
                ordinal += 1
        except BaseException as exc:  # noqa: BLE001 - delivered to the consumer
            # the item source failed: no work item to blame, never skipped;
            # it holds no slot, so the consumer releases none for it
            self._publish(ordinal, (_Failure(exc), False))
            ordinal += 1
        with self._done:
            self._total = ordinal
            self._done.notify_all()

    def _work(self) -> None:
        try:
            fn = self._factory()
        except BaseException as exc:  # noqa: BLE001 - delivered to the consumer
            fn, factory_exc = None, exc
        while not self._stop.is_set():
            try:
                ordinal, item, attempt = self._in_q.get(timeout=_POLL_S)
            except queue.Empty:
                continue
            try:
                if fn is None:
                    raise factory_exc
                result = fn(item)
            except BaseException as exc:  # noqa: BLE001 - delivered to the consumer
                result = _Failure(exc, self._start + ordinal, item)
                if result.kind == "infra" and attempt < self._max_requeue:
                    with self._done:
                        self.requeued_items += 1
                    logger.warning("Requeueing work item %s after in-worker infra failure"
                                   " (%s) (attempt %d/%d)", result.ordinal, result.exc_type,
                                   attempt + 1, self._max_requeue)
                    self._in_q.put((ordinal, item, attempt + 1))
                    continue
            self._publish(ordinal, (result, True))

    def _publish(self, ordinal: int, result: Any) -> None:
        with self._done:
            self._results[ordinal] = result
            self._done.notify_all()

    def imap(self, items: Iterable[Any], start: int = 0) -> Iterator[Any]:
        """Yield ``worker(item)`` for each item, in order (or, under a skip
        policy, a ``WorkerError`` for a failed one); the first is item
        ``start`` of the stream."""
        if self._factory is None:
            raise PetastormTpuError("Executor not started")
        self._start = start
        with self._done:  # a reader's reset() maps a second stream
            self._total = None
        with self._ventilator_lock:
            if self._pause.is_set():  # a quiesce() came first: issue nothing
                return
            ventilator = threading.Thread(target=self._ventilate, args=(items,),
                                          name="petastorm-torch-ventilator", daemon=True)
            ventilator.start()
            self._ventilator = ventilator
        ordinal = 0
        while True:
            with self._done:
                while ordinal not in self._results:
                    if self._stop.is_set():
                        raise ReaderClosedError("Executor is stopped")
                    if self._total is not None and ordinal >= self._total:
                        return
                    self._done.wait(_POLL_S)
                result, held_slot = self._results.pop(ordinal)
            if held_slot:
                self._window.release()
            ordinal += 1
            if isinstance(result, _Failure):
                result = result.error()
                if self._stop_on_failure:
                    self.stop()
                    raise result
            yield result

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

    def stop(self) -> None:
        self._stop.set()
        with self._done:
            self._done.notify_all()

    def join(self, timeout: float = 5.0) -> None:
        with self._ventilator_lock:
            ventilator = self._ventilator
        for t in self._threads + ([ventilator] if ventilator is not None else []):
            t.join(timeout)


def make_executor(kind: str, workers_count: int, results_queue_size: int,
                  stop_on_failure: bool = True,
                  max_requeue_attempts: int = DEFAULT_REQUEUE_ATTEMPTS):
    if kind == "thread":
        return ThreadedExecutor(workers_count, results_queue_size,
                                stop_on_failure=stop_on_failure,
                                max_requeue_attempts=max_requeue_attempts)
    if kind in ("serial", "dummy"):  # 'dummy': upstream petastorm's name for it
        return SerialExecutor(stop_on_failure=stop_on_failure,
                              max_requeue_attempts=max_requeue_attempts)
    raise PetastormTpuError(
        f"reader_pool_type must be 'thread', 'serial' or 'dummy', got {kind!r}")
