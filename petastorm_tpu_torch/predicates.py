"""Row predicates: vectorized row filtering pushed down to the reader's workers.

Counterpart of all of ``petastorm_tpu/predicates.py``: ``PredicateBase``
(``get_fields``, ``do_include``, ``do_include_vectorized``), the combinators
``in_set``, ``in_intersection``, ``in_lambda``, ``in_negate`` and
``in_reduce``, and ``in_pseudorandom_split`` with its md5 bucketing in both
modes (``:148-207``).  The masks equal the JAX package's bit for bit: the
bucket arithmetic (``sys.maxsize``, float bounds) is copied as it is.  The
worker reads a predicate's fields first and decodes the other fields only
for the rows the mask keeps (``worker.py``).
"""

from __future__ import annotations

import hashlib
from abc import ABC, abstractmethod
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np

from petastorm_tpu_torch.errors import PetastormTpuError


class PredicateBase(ABC):
    @abstractmethod
    def get_fields(self) -> List[str]:
        """Field names this predicate reads (the reader decodes these FIRST
        and masks rows before decoding the rest - the split-read)."""

    def do_include(self, row: Dict) -> bool:
        """Per-row check; default delegates to the vectorized form."""
        cols = {k: np.asarray([v], dtype=object) for k, v in row.items()}
        return bool(self.do_include_vectorized(cols)[0])

    def do_include_vectorized(self, columns: Dict[str, np.ndarray]) -> np.ndarray:
        """Boolean mask over the batch; default loops ``do_include``."""
        names = self.get_fields()
        n = len(next(iter(columns.values())))
        return np.fromiter(
            (self.do_include({k: columns[k][i] for k in names}) for i in range(n)),
            dtype=bool, count=n)


class in_set(PredicateBase):
    """Keep rows whose field value is in a set (predicates.py:44-67)."""

    def __init__(self, values: Iterable, field_name: str):
        self._values = set(values)
        self._field = field_name

    def get_fields(self) -> List[str]:
        return [self._field]

    def do_include_vectorized(self, columns: Dict[str, np.ndarray]) -> np.ndarray:
        col = columns[self._field]
        return np.isin(col, list(self._values))


class in_intersection(PredicateBase):
    """Keep rows where ALL listed fields' values fall in the set (predicates.py:70-92)."""

    def __init__(self, values: Iterable, field_names: Sequence[str]):
        self._values = set(values)
        self._fields = list(field_names)

    def get_fields(self) -> List[str]:
        return list(self._fields)

    def do_include_vectorized(self, columns: Dict[str, np.ndarray]) -> np.ndarray:
        mask = None
        values = list(self._values)
        for f in self._fields:
            m = np.isin(columns[f], values)
            mask = m if mask is None else (mask & m)
        return mask


class in_lambda(PredicateBase):
    """Arbitrary user predicate over named fields, with optional shared state
    (predicates.py:95-118).  ``vectorized=True`` marks the function as taking
    column arrays and returning a mask directly."""

    def __init__(self, fields: Sequence[str], func: Callable, state=None,
                 vectorized: bool = False):
        self._fields = list(fields)
        self._func = func
        self._state = state
        self._vectorized = vectorized

    def get_fields(self) -> List[str]:
        return list(self._fields)

    def do_include(self, row: Dict) -> bool:
        if self._vectorized:
            return super().do_include(row)
        args = {k: row[k] for k in self._fields}
        return bool(self._func(args, self._state) if self._state is not None
                    else self._func(args))

    def do_include_vectorized(self, columns: Dict[str, np.ndarray]) -> np.ndarray:
        cols = {k: columns[k] for k in self._fields}
        if self._vectorized:
            out = (self._func(cols, self._state) if self._state is not None
                   else self._func(cols))
            return np.asarray(out, dtype=bool)
        n = len(next(iter(cols.values())))
        return np.fromiter(
            (self.do_include({k: cols[k][i] for k in self._fields}) for i in range(n)),
            dtype=bool, count=n)


class in_negate(PredicateBase):
    """Logical NOT of another predicate (predicates.py:121-130)."""

    def __init__(self, predicate: PredicateBase):
        self._p = predicate

    def get_fields(self) -> List[str]:
        return self._p.get_fields()

    def do_include_vectorized(self, columns: Dict[str, np.ndarray]) -> np.ndarray:
        return ~self._p.do_include_vectorized(columns)


class in_reduce(PredicateBase):
    """Reduce multiple predicates with np.all / np.any / custom (predicates.py:133-141)."""

    def __init__(self, predicates: Sequence[PredicateBase], reduce_func=np.all):
        self._preds = list(predicates)
        self._reduce = reduce_func

    def get_fields(self) -> List[str]:
        out: List[str] = []
        for p in self._preds:
            for f in p.get_fields():
                if f not in out:
                    out.append(f)
        return out

    def do_include_vectorized(self, columns: Dict[str, np.ndarray]) -> np.ndarray:
        masks = np.stack([p.do_include_vectorized(columns) for p in self._preds])
        return np.asarray(self._reduce(masks, axis=0), dtype=bool)


class in_pseudorandom_split(PredicateBase):
    """Deterministic fractional split by md5-hash bucketing of a key field.

    Reference: predicates.py:144-182 - hash(value) maps each row to [0,1);
    ``fractions`` partition the unit interval; rows land in the sub-range of
    ``subset_index``.  Deterministic across runs/hosts, so train/val/test splits
    are stable properties of the data, not of the run.
    """

    def __init__(self, fractions: Sequence[float], subset_index: int,
                 field_name: str, compat: Optional[str] = None):
        """``compat='reference'`` reproduces the original petastorm's bucket
        membership bit-exactly (md5-of-str mod sys.maxsize against
        fraction*(sys.maxsize-1) bounds, reference predicates.py:39-41,
        171-182) so an existing train/val/test split migrates with identical
        row assignment.  Default (None) uses this library's native bucketing
        (md5-first-8-hex / 2^32) - same statistics, different membership.
        """
        if not 0 <= subset_index < len(fractions):
            raise PetastormTpuError(f"subset_index {subset_index} out of range")
        if sum(fractions) > 1.0 + 1e-9:
            raise PetastormTpuError(f"fractions sum to {sum(fractions)} > 1")
        if compat not in (None, "reference"):
            raise PetastormTpuError(
                f"compat must be None or 'reference', got {compat!r}")
        self._field = field_name
        self._compat = compat == "reference"
        lo = float(sum(fractions[:subset_index]))
        hi = lo + float(fractions[subset_index])
        self._lo, self._hi = lo, hi

    def get_fields(self) -> List[str]:
        return [self._field]

    @staticmethod
    def _hash01(value) -> float:
        digest = hashlib.md5(str(value).encode()).hexdigest()[:8]
        return int(digest, 16) / float(0xFFFFFFFF)

    @staticmethod
    def _reference_bucket(value) -> int:
        """Reference ``_string_to_bucket`` (predicates.py:39-41)."""
        import sys as _sys

        return int(hashlib.md5(str(value).encode("utf-8")).hexdigest(),
                   16) % _sys.maxsize

    def do_include_vectorized(self, columns: Dict[str, np.ndarray]) -> np.ndarray:
        col = columns[self._field]
        if self._compat:
            import sys as _sys

            # exact reference arithmetic: float bounds, full-int bucket
            # (reference predicates.py:171-182)
            lo = self._lo * (_sys.maxsize - 1)
            hi = self._hi * (_sys.maxsize - 1)
            return np.fromiter((lo <= self._reference_bucket(v) < hi
                                for v in col), dtype=bool, count=len(col))
        h = np.fromiter((self._hash01(v) for v in col), dtype=np.float64, count=len(col))
        return (h >= self._lo) & (h < self._hi)
