"""The thread pool's ``quiesce()`` against ``imap``'s start-up, interleaved
deterministically.

``ThreadedExecutor.imap`` creates, starts and publishes its ventilator
thread; a ``quiesce()`` from another thread must either stop ``imap`` before
any item is issued or join a started ventilator and return the exact count
it issued.  The ventilator's ``start()`` is held here until the quiescing
thread has had its chance to run, which is the window in which a
``quiesce()`` once found a published thread that was not started yet.
``tests/test_torch_checkpoint.py::test_quiesce_under_stress_delivers_exactly_what_it_issued``
hits the same window by chance under load.
"""

import threading

import pytest

from petastorm_tpu_torch import pool
from petastorm_tpu_torch.pool import ThreadedExecutor

_VENTILATOR = "petastorm-torch-ventilator"


class _HeldStart(threading.Thread):
    """A thread whose ``start()``, for the ventilator only, first lets the
    test's quiescing thread run: it announces itself and waits (bounded)
    until that thread has returned from ``quiesce()``."""

    entered = None   # set when the ventilator's start() is reached
    release = None   # set once quiesce() has returned (or failed)

    def start(self):
        if self.name == _VENTILATOR:
            type(self).entered.set()
            type(self).release.wait(timeout=1.0)
        super().start()


@pytest.mark.parametrize("start", [0, 3])
def test_quiesce_during_ventilator_start_returns_the_exact_count(monkeypatch, start):
    monkeypatch.setattr(_HeldStart, "entered", threading.Event())
    monkeypatch.setattr(_HeldStart, "release", threading.Event())
    monkeypatch.setattr(pool.threading, "Thread", _HeldStart)
    executor = ThreadedExecutor(workers_count=2, results_queue_size=2)
    executor.start(lambda: (lambda item: 2 * item))
    got, outcome = [], {}

    def consume():
        got.extend(executor.imap(iter(range(start, start + 1000)), start=start))

    def quiesce():
        assert _HeldStart.entered.wait(timeout=10)
        try:
            outcome["issued"] = executor.quiesce(start)
        except BaseException as exc:  # noqa: BLE001 - reported by the assertion below
            outcome["error"] = exc
        finally:
            _HeldStart.release.set()

    quiescer = threading.Thread(target=quiesce)
    consumer = threading.Thread(target=consume)
    quiescer.start()
    consumer.start()
    quiescer.join(timeout=30)
    consumer.join(timeout=30)
    executor.stop()
    assert not quiescer.is_alive() and not consumer.is_alive()
    assert "error" not in outcome, f"quiesce() raised {outcome.get('error')!r}"
    issued = outcome["issued"]
    assert start <= issued < start + 1000
    assert got == [2 * i for i in range(start, issued)]
    assert executor.quiesce(start) == issued  # a second quiesce changes nothing


def test_quiesce_before_imap_issues_nothing():
    """A ``quiesce()`` that wins the race: ``imap`` ends before any item is
    issued and the count is the start offset."""
    executor = ThreadedExecutor(workers_count=2, results_queue_size=2)
    executor.start(lambda: (lambda item: item))
    taken = []

    def items():
        for i in range(10):
            taken.append(i)
            yield i

    assert executor.quiesce(5) == 5
    assert list(executor.imap(items(), start=5)) == []
    assert taken == []
    assert executor.quiesce(5) == 5
    executor.stop()
