"""Executors that run the rowgroup decode worker over a stream of work items.

Counterpart of ``petastorm_tpu/pool.py:572 SerialExecutor`` and
``:749 ThreadedExecutor``.  Both deliver results in the order the items were
ventilated, so a reader's output is a pure function of its plan whatever the
worker count (the JAX reader gets the same from its ``deterministic='seed'``
reorder stage).  ``quiesce()`` is the counterpart of ``:2265
Ventilator.pause_and_join``: no item is issued after it, every item issued
before it still delivers, and it returns the exact count issued.  ``imap``
takes the absolute ordinal of its first item (``start``), so that count is
an absolute position in the item stream.  The process pool, hedging,
liveness and requeue machinery are not part of this package yet.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

from petastorm_tpu_torch.errors import PetastormTpuError, ReaderClosedError

_POLL_S = 0.05

WorkerFactory = Callable[[], Callable[[Any], Any]]


class SerialExecutor:
    """Runs every item inline, in the consumer's thread."""

    def __init__(self):
        self._factory: Optional[WorkerFactory] = None
        self._stopped = False
        self._paused = False
        self._issued = 0
        self._lock = threading.Lock()  # quiesce comes from another thread

    def start(self, worker_factory: WorkerFactory) -> None:
        self._factory = worker_factory

    def imap(self, items: Iterable[Any], start: int = 0) -> Iterator[Any]:
        """Yield ``worker(item)`` for each item; the first is item ``start``
        of the stream."""
        if self._factory is None:
            raise PetastormTpuError("Executor not started")
        fn = self._factory()
        self._issued = start
        for item in items:
            with self._lock:
                if self._stopped or self._paused:
                    return
                self._issued += 1
            yield fn(item)

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


class _Failure:
    def __init__(self, exc: BaseException):
        self.exc = exc


class ThreadedExecutor:
    """A pool of decode threads behind a ventilator thread.

    pyarrow reads and OpenCV decode release the GIL, so threads scale with
    cores.  At most ``workers_count + results_queue_size`` items are in flight
    (queued, decoding or decoded but not yet consumed), which bounds memory
    while the consumer restores ventilation order.
    """

    def __init__(self, workers_count: int = 4, results_queue_size: int = 10):
        if workers_count < 1:
            raise PetastormTpuError("workers_count must be >= 1")
        self._workers_count = workers_count
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
                self._in_q.put((ordinal, item))
                ordinal += 1
        except BaseException as exc:  # noqa: BLE001 - delivered to the consumer
            self._publish(ordinal, _Failure(exc))
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
                ordinal, item = self._in_q.get(timeout=_POLL_S)
            except queue.Empty:
                continue
            if fn is None:
                self._publish(ordinal, _Failure(factory_exc))
                continue
            try:
                result = fn(item)
            except BaseException as exc:  # noqa: BLE001 - delivered to the consumer
                result = _Failure(exc)
            self._publish(ordinal, result)

    def _publish(self, ordinal: int, result: Any) -> None:
        with self._done:
            self._results[ordinal] = result
            self._done.notify_all()

    def imap(self, items: Iterable[Any], start: int = 0) -> Iterator[Any]:
        """Yield ``worker(item)`` for each item, in order; the first is item
        ``start`` of the stream."""
        if self._factory is None:
            raise PetastormTpuError("Executor not started")
        self._start = start
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
                result = self._results.pop(ordinal)
            self._window.release()
            ordinal += 1
            if isinstance(result, _Failure):
                raise result.exc
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
        for t in self._threads:
            t.join(timeout)


def make_executor(kind: str, workers_count: int, results_queue_size: int):
    if kind == "thread":
        return ThreadedExecutor(workers_count, results_queue_size)
    if kind == "serial":
        return SerialExecutor()
    raise PetastormTpuError(f"reader_pool_type must be 'thread' or 'serial', got {kind!r}")
