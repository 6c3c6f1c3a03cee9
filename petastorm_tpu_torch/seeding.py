"""Seed derivation for the read plan.

Counterpart of ``petastorm_tpu/seeding.py:47-103``, ``:104
reader_buffer_seed`` and ``:215 resolve_deterministic``.  The derivation is
bit-identical to the JAX package's (same version tag, same blake2b key
encoding), because the plan's epoch order and the shuffle buffers' draws come
from it: a dataset read with the same seed visits its rowgroups in the same
order, and an unseeded buffer under ``deterministic='seed'`` draws the same
rows, in both packages.  The stream certificate (``StreamDigest``) is not
part of this package yet.
"""

from __future__ import annotations

import hashlib
import struct
from typing import Optional

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


def resolve_deterministic(deterministic, shuffle_seed: Optional[int]) -> str:
    """``make_reader(deterministic=)`` as ``'seed'`` or ``'off'``: ``'auto'``
    (or ``None``) is ``'seed'`` exactly when a ``shuffle_seed`` was given."""
    if deterministic in (None, "auto"):
        return "seed" if shuffle_seed is not None else "off"
    if deterministic in ("seed", "off"):
        return deterministic
    raise PetastormTpuError(
        f"deterministic must be 'seed', 'off' or 'auto'; got {deterministic!r}")
