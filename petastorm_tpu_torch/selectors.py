"""Rowgroup selectors: whole-rowgroup filtering through stored indexes.

Counterpart of ``petastorm_tpu/selectors.py``: ``RowGroupSelectorBase``,
``SingleIndexSelector``, ``IntersectIndexSelector`` and
``UnionIndexSelector``, resolved against the indexes
``etl.indexing.get_row_group_indexes`` loads; ``make_reader(rowgroup_selector=)``
keeps the selected rowgroups before the read plan is built.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict, List, Sequence, Set

from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.etl.indexing import RowGroupIndexer


class RowGroupSelectorBase(ABC):
    @abstractmethod
    def get_index_names(self) -> List[str]:
        """Names of the stored rowgroup indexes this selector consults."""
        ...

    @abstractmethod
    def select_row_groups(self, indexes: Dict[str, RowGroupIndexer]) -> Set[int]:
        """Global rowgroup indexes to read, resolved against the dataset's
        stored indexes (missing index names raise with the available set)."""
        ...

    def _require(self, indexes: Dict[str, RowGroupIndexer], name: str) -> RowGroupIndexer:
        if name not in indexes:
            raise PetastormTpuError(
                f"Index {name!r} is not stored in this dataset; available:"
                f" {sorted(indexes)}. Build it with build_rowgroup_index().")
        return indexes[name]


class SingleIndexSelector(RowGroupSelectorBase):
    """Union of rowgroups holding any of the given values of one index."""

    def __init__(self, index_name: str, values: Sequence):
        self._name = index_name
        self._values = list(values)

    def get_index_names(self) -> List[str]:
        return [self._name]

    def select_row_groups(self, indexes: Dict[str, RowGroupIndexer]) -> Set[int]:
        ix = self._require(indexes, self._name)
        out: Set[int] = set()
        for v in self._values:
            out |= ix.get_row_group_indexes(v)
        return out


class IntersectIndexSelector(RowGroupSelectorBase):
    """Rowgroups selected by ALL child selectors."""

    def __init__(self, selectors: Sequence[RowGroupSelectorBase]):
        self._selectors = list(selectors)

    def get_index_names(self) -> List[str]:
        return [n for s in self._selectors for n in s.get_index_names()]

    def select_row_groups(self, indexes: Dict[str, RowGroupIndexer]) -> Set[int]:
        sets = [s.select_row_groups(indexes) for s in self._selectors]
        return set.intersection(*sets) if sets else set()


class UnionIndexSelector(RowGroupSelectorBase):
    """Rowgroups selected by ANY child selector."""

    def __init__(self, selectors: Sequence[RowGroupSelectorBase]):
        self._selectors = list(selectors)

    def get_index_names(self) -> List[str]:
        return [n for s in self._selectors for n in s.get_index_names()]

    def select_row_groups(self, indexes: Dict[str, RowGroupIndexer]) -> Set[int]:
        out: Set[int] = set()
        for s in self._selectors:
            out |= s.select_row_groups(indexes)
        return out
