"""Exception types raised by the port's ingest path.

Counterpart of ``petastorm_tpu/errors.py:27-60``: the same class names, so an
error from either package reads the same.  The fault-tolerance policy
(``ErrorPolicy``, ``on_error``) is not part of this package yet.
"""

from __future__ import annotations


class PetastormTpuError(Exception):
    """Base class for all errors of this package."""


class NoDataAvailableError(PetastormTpuError):
    """A shard/selection combination selects no rowgroups."""


class SchemaError(PetastormTpuError):
    """Schema definition, serialization, or validation failure."""


class CodecError(PetastormTpuError):
    """Codec encode/decode failure (bad dtype, non-compliant shape, ...)."""


class MetadataError(PetastormTpuError):
    """Dataset metadata is missing or unreadable."""


class ReaderClosedError(PetastormTpuError):
    """Operation on a reader that has been stopped."""
