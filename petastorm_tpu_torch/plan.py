"""Read plan: a seeded, sharded ordering of rowgroup work items.

Counterpart of ``petastorm_tpu/plan.py:38-157``, trimmed to whole rowgroups and
static sharding (rowgroup ``i`` belongs to shard ``i % shard_count``).  The
epoch order is drawn from the same ``seed_stream`` domain as the JAX plan, so
both packages visit the rowgroups in the same order for the same arguments.
Row-drop partitions, epoch re-dealing and elastic resume are not part of this
package yet.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from petastorm_tpu_torch.errors import NoDataAvailableError, PetastormTpuError
from petastorm_tpu_torch.etl.metadata import RowGroupRef
from petastorm_tpu_torch.seeding import seed_stream


@dataclasses.dataclass(frozen=True)
class WorkItem:
    """One unit of executor work: a whole rowgroup."""

    row_group: RowGroupRef

    @property
    def num_rows(self) -> int:
        return self.row_group.num_rows


class ReadPlan:
    """Epoch-indexed, shard-filtered, seeded ordering over rowgroups."""

    def __init__(self, row_groups: Sequence[RowGroupRef],
                 shard_index: Optional[int] = None,
                 shard_count: Optional[int] = None,
                 shuffle_row_groups: bool = True,
                 shuffle_seed: Optional[int] = None):
        if (shard_index is None) != (shard_count is None):
            raise PetastormTpuError("shard_index and shard_count must be set together")
        if shard_count is not None:
            if not 0 <= shard_index < shard_count:
                raise PetastormTpuError(
                    f"shard_index {shard_index} out of range for shard_count {shard_count}")
            if shard_count > len(row_groups):
                raise NoDataAvailableError(
                    f"Dataset has {len(row_groups)} rowgroups but {shard_count} shards"
                    " were requested; some shards would be empty")
        self._row_groups = list(row_groups)
        self._shard_index = shard_index
        self._shard_count = shard_count
        self._shuffle = shuffle_row_groups
        self._seed = 0 if shuffle_seed is None else shuffle_seed

    def epoch_items(self, epoch: int) -> List[WorkItem]:
        """The ordered work items of one epoch of this shard."""
        n = len(self._row_groups)
        if self._shuffle:
            order = seed_stream(self._seed, epoch, "plan.permutation").permutation(n)
        else:
            order = np.arange(n)
        if self._shard_count is not None:
            order = order[order % self._shard_count == self._shard_index]
        return [WorkItem(self._row_groups[int(gi)]) for gi in order]

    def rows_per_epoch(self) -> int:
        return sum(item.num_rows for item in self.epoch_items(0))
