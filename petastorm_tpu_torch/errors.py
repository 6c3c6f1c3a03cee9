"""Exception types and the failure policy of the port's ingest path.

Counterpart of ``petastorm_tpu/errors.py:20-182``: the same class names,
messages and policy, so an error from either package reads the same.  The
fault-tolerance layer (``make_reader(on_error=...)``) lives here: the
:class:`ErrorPolicy` knob, its budget-exhaustion error, and the
data-vs-infrastructure classification the pool applies to worker failures.
A long epoch must not die on one corrupt JPEG, and skipping half the
dataset must not look like success: hence explicit budgets.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

#: default infra-failure requeue budget (attempts beyond the first
#: delivery), shared by both pools and by ErrorPolicy
DEFAULT_REQUEUE_ATTEMPTS = 2


class PetastormTpuError(Exception):
    """Base class for all errors of this package."""


class NoDataAvailableError(PetastormTpuError):
    """A shard/predicate/selector combination selects no rowgroups."""


class SchemaError(PetastormTpuError):
    """Schema definition, serialization, or validation failure."""


class CodecError(PetastormTpuError):
    """Codec encode/decode failure (bad dtype, non-compliant shape, ...)."""


class MetadataError(PetastormTpuError):
    """Dataset metadata is missing or unreadable."""


class ReaderClosedError(PetastormTpuError):
    """Operation on a reader that has been stopped."""


class EpochNotFinishedError(PetastormTpuError):
    """reset() called mid-epoch (in-flight work items would leak across
    epochs)."""


class ErrorBudgetExceededError(PetastormTpuError):
    """An ``on_error`` skip policy ran out of budget.

    Raised by the reader when the number (or fraction) of skipped rowgroups
    exceeds the :class:`ErrorPolicy` limits.  ``diagnostics``: the reader's
    snapshot taken at abort time (items consumed and expected, the stream
    digest, the quarantine ledger).
    """

    def __init__(self, message: str, diagnostics: Optional[dict] = None):
        super().__init__(message)
        self.diagnostics = diagnostics or {}


class CircuitOpenError(OSError, PetastormTpuError):
    """The storage circuit breaker is open.  The breaker belongs to the
    remote-filesystem retry layer, which is not part of this package yet
    (ROADMAP.md queue A item 11); the type is kept so the failure taxonomy
    (an ``OSError``, classified ``'data'``) reads as the JAX package's."""


@dataclasses.dataclass(frozen=True)
class ErrorPolicy:
    """Skip-and-account failure policy for ``make_reader(on_error=...)``.

    With a policy in force, *data* errors (corrupt rowgroup, codec or
    transform failure - see :func:`classify_error`) no longer kill the read:
    the failing work item is skipped, quarantined in ``Reader.diagnostics``
    (``quarantined_rowgroups``), and iteration continues.  *Infrastructure*
    errors (an in-worker ``MemoryError``) are first requeued onto a worker
    up to ``max_requeue_attempts``; only an item that exhausts its attempts
    is handed to the skip path.  (The JAX package also counts both in
    telemetry, ``errors.skipped_rowgroups`` and ``errors.requeued_items``;
    telemetry is not part of this package yet, ROADMAP.md queue A item 11.)

    ``max_skipped_rowgroups``: absolute skip budget (None = unlimited).
    ``max_skipped_fraction``: skipped / expected items (None = unlimited);
    the denominator is the total expected item count, or - for
    ``num_epochs=None`` readers, which have no total - the items consumed
    so far, floored at one epoch.  Exceeding either raises
    :class:`ErrorBudgetExceededError`.
    """

    max_skipped_rowgroups: Optional[int] = None
    max_skipped_fraction: Optional[float] = None
    max_requeue_attempts: int = DEFAULT_REQUEUE_ATTEMPTS

    def __post_init__(self):
        if (self.max_skipped_rowgroups is not None
                and self.max_skipped_rowgroups < 0):
            raise PetastormTpuError(
                "ErrorPolicy.max_skipped_rowgroups must be >= 0 or None")
        if (self.max_skipped_fraction is not None
                and not 0.0 <= self.max_skipped_fraction <= 1.0):
            raise PetastormTpuError(
                "ErrorPolicy.max_skipped_fraction must be in [0, 1] or None")
        if self.max_requeue_attempts < 0:
            raise PetastormTpuError(
                "ErrorPolicy.max_requeue_attempts must be >= 0")


def resolve_error_policy(on_error) -> Optional[ErrorPolicy]:
    """User-facing ``on_error`` knob -> concrete policy (None = raise mode).

    ``'raise'``/None fails fast; ``'skip'`` is an unbudgeted
    :class:`ErrorPolicy`; an ``ErrorPolicy`` passes through.
    """
    if on_error is None or on_error == "raise":
        return None
    if on_error == "skip":
        return ErrorPolicy()
    if isinstance(on_error, ErrorPolicy):
        return on_error
    raise PetastormTpuError(
        f"on_error must be 'raise', 'skip' or an ErrorPolicy; got {on_error!r}")


def classify_error(exc: BaseException) -> str:
    """Classify a worker failure: ``'data'`` (skip-eligible) vs ``'infra'``.

    Anything raised inside a worker function - CodecError, pyarrow
    ArrowInvalid, transform exceptions, an IO error - is a property of the
    work item: retrying it would fail identically, so the only recovery is
    skip and quarantine.  A ``MemoryError`` is a property of the worker: the
    item itself is healthy and is requeued.
    """
    if isinstance(exc, MemoryError):
        return "infra"
    return "data"
