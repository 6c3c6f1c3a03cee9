"""Bounded retry with backoff for transient remote-IO failures, and the
storage circuit breaker.

Counterpart of ``petastorm_tpu/retry.py``: ``RetryPolicy`` (``:41``),
``CircuitBreaker`` (``:73-200``), ``make_circuit_breaker``, ``is_transient``,
``retry_call`` (``:218``) and ``resolve_retry_policy`` (``:328``), the same
arithmetic and messages.  What retries: rowgroup reads in the decode
workers (the possibly poisoned file handle dropped between attempts) and
metadata opens (listing, key-value read, footer reads).  What does not:
durable errors (``FileNotFoundError``, ``PermissionError``, corrupt data,
``CodecError``), which fail at once, and local filesystems by default
(``io_retries='auto'``), where a failed read is a fault, not weather.
"""

from __future__ import annotations

import dataclasses
import logging
import random
import threading
import time
from typing import Callable, Optional, Union

import pyarrow.fs as pafs

from petastorm_tpu_torch.errors import CircuitOpenError, PetastormTpuError

logger = logging.getLogger(__name__)

#: OSError subclasses that indicate a durable condition, not transient
#: weather.  CircuitOpenError is here by construction: the breaker exists to
#: STOP retries, so its fail-fast error must never itself be retried.
_NON_TRANSIENT = (FileNotFoundError, PermissionError, IsADirectoryError,
                  NotADirectoryError, FileExistsError, CircuitOpenError)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff: ``initial * multiplier^attempt``, capped, jittered.

    ``circuit_threshold``/``circuit_cooldown_s`` configure the storage
    circuit breaker layered OVER the per-call retry: ``circuit_threshold``
    consecutive transient failures (across calls and workers sharing the
    breaker) open the circuit and subsequent calls fail fast with
    :class:`~petastorm_tpu_torch.errors.CircuitOpenError` instead of compounding
    retry storms; after ``circuit_cooldown_s`` a single probe call is let
    through (half-open) and its success closes the circuit.
    ``circuit_threshold=None`` disables the breaker.
    """

    max_attempts: int = 4
    initial_backoff_s: float = 0.2
    backoff_multiplier: float = 2.0
    max_backoff_s: float = 5.0
    jitter_frac: float = 0.25
    circuit_threshold: Optional[int] = 10
    circuit_cooldown_s: float = 30.0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise PetastormTpuError("RetryPolicy.max_attempts must be >= 1")
        if self.circuit_threshold is not None and self.circuit_threshold < 1:
            raise PetastormTpuError(
                "RetryPolicy.circuit_threshold must be >= 1 or None")
        if self.circuit_cooldown_s < 0:
            raise PetastormTpuError(
                "RetryPolicy.circuit_cooldown_s must be >= 0")


class CircuitBreaker:
    """Shared consecutive-transient-failure breaker (docs/operations.md
    "Liveness & stragglers").

    closed -> (``threshold`` CONSECUTIVE transient failures) -> open ->
    (``cooldown_s`` elapses; ONE probe allowed) -> half-open ->
    probe success closes / probe failure re-opens.

    One instance is shared by every worker of a reader (thread pools share
    it directly; spawned process-pool workers each unpickle their own copy,
    so the threshold is then per-process - documented, still bounded).
    Success anywhere resets the consecutive count: the breaker reacts to a
    store that is DOWN, not to scattered weather, which the per-call retry
    layer already absorbs.  Thread-safe; picklable (lock recreated).
    """

    def __init__(self, threshold: int = 10, cooldown_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        if threshold < 1:
            raise PetastormTpuError("CircuitBreaker threshold must be >= 1")
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._lock = threading.Lock()
        self._consecutive_failures = 0
        self._opened_at: Optional[float] = None  # None = closed
        self._probing = False                    # half-open probe in flight
        self.opens = 0          # cumulative open transitions
        self.failfasts = 0      # calls rejected while open

    def __getstate__(self):
        state = dict(self.__dict__)
        del state["_lock"]
        state["_clock"] = None  # a custom clock (tests) is process-local
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()
        if self._clock is None:
            self._clock = time.monotonic

    @property
    def state(self) -> str:
        """``'closed'``, ``'open'``, or ``'half-open'`` (cooldown elapsed,
        probe eligible or in flight)."""
        with self._lock:
            if self._opened_at is None:
                return "closed"
            if self._probing or (self._clock() - self._opened_at
                                 >= self.cooldown_s):
                return "half-open"
            return "open"

    def before_call(self, what: str = "io") -> bool:
        """Gate one IO call: raises :class:`CircuitOpenError` while open.
        Once ``cooldown_s`` has elapsed, exactly one caller is admitted as
        the half-open probe (returns True; everyone else gets False);
        concurrent callers keep failing fast until the probe settles.  A
        probe caller whose call ends without a transient verdict (a
        non-transient error, an interrupt) MUST call :meth:`release_probe`
        or the slot would stay claimed forever."""
        with self._lock:
            if self._opened_at is None:
                return False
            elapsed = self._clock() - self._opened_at
            if elapsed >= self.cooldown_s and not self._probing:
                self._probing = True  # this caller is the probe
                return True
            self.failfasts += 1
            remaining = max(self.cooldown_s - elapsed, 0.0)
            raise CircuitOpenError(
                f"storage circuit breaker is open ({what}):"
                f" {self._consecutive_failures} consecutive transient IO"
                f" failures >= threshold {self.threshold};"
                + (" half-open probe in flight" if self._probing
                   else f" next probe in {remaining:.1f}s")
                + f" (opened {self.opens}x, {self.failfasts} calls"
                " failed fast)")

    def release_probe(self) -> None:
        """The half-open probe exited without a transient verdict (its call
        raised a NON-transient error, or was interrupted): free the probe
        slot so a later call can probe, leaving the open/cooldown state
        untouched.  Without this, an expired-credential PermissionError
        during the probe would wedge the breaker open forever."""
        with self._lock:
            self._probing = False

    def record_success(self) -> None:
        """A gated call succeeded: close the circuit / reset the count."""
        with self._lock:
            self._consecutive_failures = 0
            self._opened_at = None
            self._probing = False

    def record_failure(self) -> bool:
        """A gated call failed transiently; True when this failure OPENED
        (or re-opened) the circuit - the caller logs the outage then."""
        with self._lock:
            self._consecutive_failures += 1
            if self._probing:
                # failed half-open probe: restart the cooldown clock
                self._probing = False
                self._opened_at = self._clock()
                self.opens += 1
                return True
            if (self._opened_at is None
                    and self._consecutive_failures >= self.threshold):
                self._opened_at = self._clock()
                self.opens += 1
                return True
            return False

    @property
    def is_open(self) -> bool:
        """True while calls would fail fast (cooldown not yet elapsed)."""
        with self._lock:
            return (self._opened_at is not None and not self._probing
                    and self._clock() - self._opened_at < self.cooldown_s)

    def snapshot(self) -> dict:
        """Diagnostics view: state, consecutive failures, opens, failfasts."""
        with self._lock:
            consecutive = self._consecutive_failures
            opens, failfasts = self.opens, self.failfasts
        return {"state": self.state, "consecutive_failures": consecutive,
                "opens": opens, "failfasts": failfasts}


def make_circuit_breaker(policy: Optional[RetryPolicy]
                         ) -> Optional[CircuitBreaker]:
    """One breaker per reader from its retry policy (None when retries or
    the breaker are disabled)."""
    if policy is None or policy.circuit_threshold is None:
        return None
    return CircuitBreaker(policy.circuit_threshold, policy.circuit_cooldown_s)


def is_transient(exc: BaseException) -> bool:
    """Transient = OSError family (incl. pyarrow ArrowIOError and fsspec
    backends' errors, which derive from it) minus the durable subclasses."""
    return isinstance(exc, OSError) and not isinstance(exc, _NON_TRANSIENT)


def retry_call(fn: Callable, policy: Optional[RetryPolicy], *, what: str = "io",
               on_retry: Optional[Callable[[BaseException], None]] = None,
               sleep: Callable[[float], None] = time.sleep,
               telemetry=None, breaker: Optional[CircuitBreaker] = None):
    """Run ``fn``, retrying transient failures per ``policy`` (None = no retry).

    ``on_retry(exc)`` runs before each re-attempt - the hook where callers
    drop possibly-poisoned cached handles/connections.

    ``breaker``: optional shared :class:`CircuitBreaker`.  Every attempt is
    gated through it (open circuit -> immediate
    :class:`~petastorm_tpu_torch.errors.CircuitOpenError`, no retry loop),
    every transient failure feeds it, and a failure that trips it open
    short-cuts the remaining backoff so the outage surfaces now, not after
    the full retry budget.

    ``telemetry`` counts each retry (``io.retries`` and
    ``io.retries.<first word of what>``) and each circuit-open transition
    (``liveness.circuit_opens``), with a trace event each, as
    ``petastorm_tpu/retry.py:298-326`` does; resolved only on those paths.
    """
    if policy is None and breaker is None:
        return fn()
    max_attempts = policy.max_attempts if policy is not None else 1
    backoff = policy.initial_backoff_s if policy is not None else 0.0
    for attempt in range(1, max_attempts + 1):
        probing = False
        if breaker is not None:
            probing = breaker.before_call(what)
        try:
            result = fn()
        except BaseException as exc:  # noqa: BLE001 - filtered below
            if not isinstance(exc, Exception) or not is_transient(exc):
                # no transient verdict for the breaker (non-transient error,
                # KeyboardInterrupt, ...): a claimed probe slot must be
                # released or the breaker wedges open forever
                if probing:
                    breaker.release_probe()
                raise
            if breaker is not None and breaker.record_failure():
                logger.error(
                    "Storage circuit breaker OPENED during %s: consecutive"
                    " transient IO failures reached threshold %d; failing"
                    " fast for %.0fs instead of retrying", what,
                    breaker.threshold, breaker.cooldown_s)
                _record_circuit_open(telemetry, what, exc)
            if attempt >= max_attempts:
                raise
            if breaker is not None and breaker.is_open:
                # the circuit opened under this call's failures: surface the
                # outage immediately rather than sleeping out the backoff
                # against a store the breaker just declared down.  If the
                # cooldown happens to elapse in this very instant,
                # before_call ADMITS us as the half-open probe instead of
                # raising - release the slot (we are mid-backoff, not
                # probing) so the next attempt can claim it properly
                if breaker.before_call(what):
                    breaker.release_probe()
            delay = min(backoff, policy.max_backoff_s)
            delay *= 1 + policy.jitter_frac * random.random()
            logger.warning("Transient IO failure in %s (attempt %d/%d): %s;"
                           " retrying in %.2fs", what, attempt,
                           policy.max_attempts, exc, delay)
            _record_retry(telemetry, what, exc)
            if on_retry is not None:
                try:
                    on_retry(exc)
                except Exception:  # noqa: BLE001 - cleanup is best-effort
                    logger.debug("on_retry hook failed", exc_info=True)
            sleep(delay)
            backoff *= policy.backoff_multiplier
        else:
            if breaker is not None:
                breaker.record_success()
            return result


def _record_circuit_open(telemetry, what: str, exc: BaseException) -> None:
    """Count one circuit-open transition."""
    from petastorm_tpu_torch.telemetry import resolve as _resolve_telemetry

    tele = _resolve_telemetry(telemetry)
    if not tele.enabled:
        return
    tele.counter("liveness.circuit_opens").add(1)
    trace = getattr(tele, "trace", None)
    if trace is not None:
        trace.add("circuit-open", "fault", time.perf_counter_ns(), 0,
                  {"what": what, "error": str(exc)})


def _record_retry(telemetry, what: str, exc: BaseException) -> None:
    """Count one retry."""
    from petastorm_tpu_torch.telemetry import resolve as _resolve_telemetry

    tele = _resolve_telemetry(telemetry)
    if not tele.enabled:
        return
    tele.counter("io.retries").add(1)
    category = what.split(" ", 1)[0] if what else "io"
    tele.counter(f"io.retries.{category}").add(1)
    trace = getattr(tele, "trace", None)
    if trace is not None:
        trace.add("io-retry", "fault", time.perf_counter_ns(), 0,
                  {"what": what, "error": str(exc)})


def resolve_retry_policy(io_retries: Union[None, bool, int, str, RetryPolicy],
                         filesystem: Optional[pafs.FileSystem]
                         ) -> Optional[RetryPolicy]:
    """User-facing ``io_retries`` knob -> concrete policy (or None = off).

    ``'auto'`` (the default everywhere): retries on for any non-local
    filesystem, off for LocalFileSystem.  An int sets ``max_attempts`` with
    default backoff; a RetryPolicy passes through; None/False/0 disables.
    """
    if io_retries is None or io_retries is False or io_retries == 0:
        return None
    if isinstance(io_retries, RetryPolicy):
        return io_retries
    if io_retries == "auto":
        if filesystem is not None and isinstance(filesystem, pafs.LocalFileSystem):
            return None
        return RetryPolicy()
    if isinstance(io_retries, bool):  # True
        return RetryPolicy()
    if isinstance(io_retries, int):
        return RetryPolicy(max_attempts=io_retries)
    raise PetastormTpuError(
        f"io_retries must be 'auto', None/False, an int (max attempts) or a"
        f" RetryPolicy; got {io_retries!r}")
