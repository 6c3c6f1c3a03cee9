"""Seed derivation for the read plan.

Counterpart of ``petastorm_tpu/seeding.py:47-103``, ``:104
reader_buffer_seed`` and ``:215 resolve_deterministic``.  The derivation is
bit-identical to the JAX package's (same version tag, same blake2b key
encoding), because the plan's epoch order and the shuffle buffers' draws come
from it: a dataset read with the same seed visits its rowgroups in the same
order, and an unseeded buffer under ``deterministic='seed'`` draws the same
rows, in both packages.  ``StreamDigest`` is the counterpart of
``:126``: the stream certificate, folded from the same payloads, so the
two packages' readers give the same digest for the same delivered stream.
"""

from __future__ import annotations

import hashlib
import struct
import zlib
from typing import Dict, Optional

import numpy as np

from petastorm_tpu_torch.errors import PetastormTpuError

_DERIVE_VERSION = b"petastorm-tpu-seed-stream-v1"


def _mix_part(h, part) -> None:
    """Fold one key part into the hash with a type tag and its length."""
    if isinstance(part, (bool, int, np.integer)):
        h.update(b"i")
        h.update(struct.pack("<q", int(part)))
    elif isinstance(part, str):
        raw = part.encode("utf-8")
        h.update(b"s")
        h.update(struct.pack("<q", len(raw)))
        h.update(raw)
    elif isinstance(part, bytes):
        h.update(b"b")
        h.update(struct.pack("<q", len(part)))
        h.update(part)
    else:
        raise PetastormTpuError(
            f"seed_stream key parts must be int, str or bytes; got"
            f" {type(part).__name__} ({part!r})")


def derive_seed(seed: Optional[int], epoch: int, domain: str, *extra) -> int:
    """A 63-bit child seed, a pure function of ``(seed, epoch, domain, *extra)``.

    ``seed=None`` maps to 0.  Stable across processes and ``PYTHONHASHSEED``.
    """
    h = hashlib.blake2b(_DERIVE_VERSION, digest_size=8)
    _mix_part(h, int(seed) if seed is not None else 0)
    _mix_part(h, int(epoch))
    _mix_part(h, str(domain))
    for part in extra:
        _mix_part(h, part)
    return int.from_bytes(h.digest(), "little") & (2 ** 63 - 1)


def seed_stream(seed: Optional[int], epoch: int, domain: str,
                *extra) -> np.random.Generator:
    """A numpy Generator seeded by :func:`derive_seed`."""
    return np.random.default_rng(derive_seed(seed, epoch, domain, *extra))


def reader_buffer_seed(reader, domain: str,
                       explicit_seed: Optional[int] = None) -> Optional[int]:
    """The buffer seed every delivery adapter uses: an ``explicit_seed``
    wins; otherwise, when ``reader`` runs ``deterministic='seed'`` delivery,
    a seed derived from the reader's ``shuffle_seed`` for ``domain``;
    otherwise ``None`` (each run mixes differently)."""
    if explicit_seed is not None:
        return explicit_seed
    if getattr(reader, "deterministic", "off") != "seed":
        return None
    return derive_seed(getattr(reader, "shuffle_seed", None), 0, domain)


#: StreamDigest record kinds (first field of every packed payload)
_REC_BATCH = 1
_REC_SKIP = 2


class StreamDigest:
    """Running crc32 chain over a delivered work-item stream.

    Each delivered batch folds its work item's identity (the rowgroup's
    ``global_index`` and ``row_group`` and the row slice, not the file path)
    and its row count into a chain per epoch and a combined chain; a skipped
    item folds a skip marker.  ``state()`` round-trips through
    ``Reader.state_dict()``, so a resumed run continues the chain and its
    combined digest equals an uninterrupted run's.
    """

    def __init__(self, state: Optional[dict] = None):
        state = state or {}
        self._combined = int(state.get("combined", 0))
        self._epochs: Dict[int, int] = {int(e): int(v)
                                        for e, v in state.get("epochs", {}).items()}
        self._batches = int(state.get("batches", 0))
        self._rows = int(state.get("rows", 0))

    def _mix(self, epoch: int, payload: bytes) -> None:
        self._combined = zlib.crc32(payload, self._combined)
        self._epochs[epoch] = zlib.crc32(payload, self._epochs.get(epoch, 0))

    def record_batch(self, epoch: int, ordinal: Optional[int], global_index: int,
                     row_group: int, start: int, stop: int, num_rows: int) -> None:
        """Fold one delivered batch: its work item and its row count."""
        self._mix(int(epoch), struct.pack(
            "<7q", _REC_BATCH, -1 if ordinal is None else int(ordinal), int(global_index),
            int(row_group), int(start), int(stop), int(num_rows)))
        self._batches += 1
        self._rows += int(num_rows)

    def record_skip(self, epoch: int, ordinal: Optional[int], global_index: int = -1,
                    row_group: int = -1) -> None:
        """Fold one skipped work item."""
        self._mix(int(epoch), struct.pack(
            "<4q", _REC_SKIP, -1 if ordinal is None else int(ordinal), int(global_index),
            int(row_group)))
        self._batches += 1

    @property
    def combined(self) -> int:
        """The combined chain value (0: nothing recorded)."""
        return self._combined

    @property
    def batches(self) -> int:
        """Records folded so far (delivered batches and skips)."""
        return self._batches

    def summary(self) -> dict:
        """Hex chain values per epoch and combined, and the record and row totals."""
        return {"combined": f"{self._combined:08x}",
                "epochs": {e: f"{v:08x}" for e, v in sorted(self._epochs.items())},
                "batches": self._batches,
                "rows": self._rows}

    def state(self) -> dict:
        """JSON-serializable chain state; ``StreamDigest(state=...)`` continues it."""
        return {"combined": self._combined,
                "epochs": {str(e): v for e, v in self._epochs.items()},
                "batches": self._batches,
                "rows": self._rows}


def resolve_deterministic(deterministic, shuffle_seed: Optional[int]) -> str:
    """``make_reader(deterministic=)`` as ``'seed'`` or ``'off'``: ``'auto'``
    (or ``None``) is ``'seed'`` exactly when a ``shuffle_seed`` was given."""
    if deterministic in (None, "auto"):
        return "seed" if shuffle_seed is not None else "off"
    if deterministic in ("seed", "off"):
        return deterministic
    raise PetastormTpuError(
        f"deterministic must be 'seed', 'off' or 'auto'; got {deterministic!r}")
