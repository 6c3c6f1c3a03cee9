"""Deterministic stub worker factories for pool tests.

Counterpart of ``petastorm_tpu/test_util/stub_workers.py`` (reference:
petastorm/workers_pool/tests/stub_workers.py:14-84: coefficient multiplier,
sleeper, exception raiser).  Module-level classes, so the process pool can
pickle them for spawn.
"""

import os
import time


class MultiplierWorker:
    """process(x) -> coefficient * x."""

    def __init__(self, coefficient: int = 2):
        self.coefficient = coefficient

    def __call__(self):
        coeff = self.coefficient
        return lambda x: coeff * x


class SleepyWorker:
    def __init__(self, sleep_s: float = 0.01):
        self.sleep_s = sleep_s

    def __call__(self):
        def fn(x):
            time.sleep(self.sleep_s)
            return x
        return fn


class ExplodingWorker:
    """Raises on items equal to the trigger value."""

    def __init__(self, trigger=13):
        self.trigger = trigger

    def __call__(self):
        trigger = self.trigger

        def fn(x):
            if x == trigger:
                raise RuntimeError(f"boom on {x}")
            return x
        return fn


class PidWorker:
    """Returns the worker's process id - proves process isolation."""

    def __call__(self):
        return lambda _x: os.getpid()


class BlockingWorker:
    """Wedges on items equal to the trigger until ``release`` is set —
    drives the stall-detection diagnostics (thread pool only: the event is
    shared in-process)."""

    def __init__(self, release, trigger=1):
        self.release = release
        self.trigger = trigger

    def __call__(self):
        def fn(x):
            if getattr(x, "item", x) == self.trigger:
                self.release.wait()
            return x
        return fn


class HardCrashWorker:
    """Simulates an OOM-kill/segfault: the worker PROCESS dies without a
    traceback (os._exit bypasses exception handling entirely)."""

    def __init__(self, trigger=7):
        self.trigger = trigger

    def __call__(self):
        trigger = self.trigger

        def fn(x):
            if x == trigger:
                os._exit(17)
            return x
        return fn
