"""Read plan: a seeded, sharded ordering of rowgroup work items.

Counterpart of ``petastorm_tpu/plan.py``.  A work item is a rowgroup, or one
of its ``shuffle_row_drop_partitions`` row-drop partitions (``:39-70``).
Two shard modes: ``'static'`` (rowgroup ``i`` belongs to shard ``i %
shard_count`` in every epoch) and ``'epoch'`` (the epoch's permutation dealt
round-robin to the shards, so the deal changes every epoch, ``:136-137``).
The epoch order, and the re-permutation of the partitions
(``plan.drop-shuffle``, ``:147-151``), are drawn from the same
``seed_stream`` domains as the JAX plan, so both packages give the same
items in the same order for the same arguments.  The resume arithmetic
(``:154 total_items``, ``:159 ElasticResumePlan``, ``:212 resolve_cursor``,
``:243 elastic_resume_plan``) is copied with the same error messages.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from petastorm_tpu_torch.errors import NoDataAvailableError, PetastormTpuError
from petastorm_tpu_torch.etl.metadata import RowGroupRef
from petastorm_tpu_torch.seeding import seed_stream


@dataclasses.dataclass(frozen=True)
class WorkItem:
    """One unit of executor work: a rowgroup, or the rows ``[start, stop)``
    of one of its row-drop partitions (``drop_partition = (index, count)``)."""

    row_group: RowGroupRef
    drop_partition: Optional[Tuple[int, int]] = None

    @property
    def num_rows(self) -> int:
        start, stop = self.row_slice()
        return stop - start

    def row_slice(self) -> Tuple[int, int]:
        """The rows the item reads, which the stream digest folds."""
        if self.drop_partition is None:
            return 0, self.row_group.num_rows
        idx, count = self.drop_partition
        return _drop_slice(self.row_group.num_rows, idx, count)


def _drop_slice(num_rows: int, idx: int, count: int) -> Tuple[int, int]:
    base = num_rows // count
    extra = num_rows % count
    start = idx * base + min(idx, extra)
    stop = start + base + (1 if idx < extra else 0)
    return start, stop


class ReadPlan:
    """Epoch-indexed, shard-filtered, seeded ordering over rowgroups."""

    def __init__(self, row_groups: Sequence[RowGroupRef],
                 shard_index: Optional[int] = None,
                 shard_count: Optional[int] = None,
                 shuffle_row_groups: bool = True,
                 shuffle_seed: Optional[int] = None,
                 shuffle_row_drop_partitions: int = 1,
                 shard_mode: str = "static"):
        if (shard_index is None) != (shard_count is None):
            raise PetastormTpuError("shard_index and shard_count must be set together")
        if shard_count is not None:
            if not 0 <= shard_index < shard_count:
                raise PetastormTpuError(
                    f"shard_index {shard_index} out of range for shard_count {shard_count}")
            if shard_count > len(row_groups):
                raise NoDataAvailableError(
                    f"Dataset has {len(row_groups)} rowgroups but {shard_count} shards"
                    " were requested; some shards would be empty. Write the dataset"
                    " with more/smaller rowgroups or reduce shard_count.")
        if shard_mode not in ("static", "epoch"):
            raise PetastormTpuError(f"Unknown shard_mode {shard_mode!r}")
        if shuffle_row_drop_partitions < 1:
            raise PetastormTpuError("shuffle_row_drop_partitions must be >= 1")
        self._row_groups = list(row_groups)
        self.row_groups = self._row_groups
        self._shard_index = shard_index
        self._shard_count = shard_count
        self._shuffle = shuffle_row_groups
        self._seed = 0 if shuffle_seed is None else shuffle_seed
        self._drop_partitions = shuffle_row_drop_partitions
        self._shard_mode = shard_mode

    def epoch_items(self, epoch: int) -> List[WorkItem]:
        """The ordered work items of one epoch of this shard."""
        n = len(self._row_groups)
        if n == 0:
            return []
        if self._shuffle:
            order = seed_stream(self._seed, epoch, "plan.permutation").permutation(n)
        else:
            order = np.arange(n)
        if self._shard_count is None:
            mine = order
        elif self._shard_mode == "static":
            # membership fixed by the global index; the permutation orders it
            mine = order[order % self._shard_count == self._shard_index]
        else:
            # epoch mode: the permuted sequence dealt round-robin to the shards
            mine = order[self._shard_index::self._shard_count]
        items: List[WorkItem] = []
        for gi in mine:
            rg = self._row_groups[int(gi)]
            if self._drop_partitions == 1:
                items.append(WorkItem(rg))
            else:
                items.extend(WorkItem(rg, (k, self._drop_partitions))
                             for k in range(self._drop_partitions))
        if self._shuffle and self._drop_partitions > 1:
            # a rowgroup's partitions do not stay adjacent
            sub = seed_stream(self._seed, epoch, "plan.drop-shuffle").permutation(len(items))
            items = [items[int(i)] for i in sub]
        return items

    def rows_per_epoch(self) -> int:
        return sum(item.num_rows for item in self.epoch_items(0))

    def total_items(self, num_epochs: int) -> int:
        """Items across ``num_epochs`` epochs (uniform epoch length)."""
        return len(self.epoch_items(0)) * num_epochs


class ElasticResumePlan:
    """Plan for resuming a partially consumed epoch under a new shard layout.

    Every old shard's epoch order is a pure function of (seed, epoch, shard),
    so the unconsumed remainder of the epoch in progress follows from the
    old shards' cursors alone.  Epochs are rebased: ``epoch_items(0)`` is
    this new shard's deal of the leftover items, ``epoch_items(e >= 1)`` the
    old layout's epoch ``resume_epoch + e`` under the new shard layout.
    """

    def __init__(self, base: ReadPlan, resume_epoch: int, leftover: Sequence[WorkItem]):
        self._base = base
        self._resume_epoch = resume_epoch
        self._leftover = list(leftover)
        self.row_groups = base.row_groups

    @property
    def resume_epoch(self) -> int:
        return self._resume_epoch

    @property
    def leftover_len(self) -> int:
        return len(self._leftover)

    @property
    def base_items_per_epoch(self) -> int:
        return len(self._base.epoch_items(0))

    def epoch_items(self, epoch: int) -> List[WorkItem]:
        if epoch == 0:
            return list(self._leftover)
        return self._base.epoch_items(self._resume_epoch + epoch)

    def rows_per_epoch(self) -> int:
        return sum(item.num_rows for item in self._leftover)

    def total_items(self, num_epochs: int) -> int:
        if num_epochs <= 0:
            return 0
        return len(self._leftover) + self._base.total_items(num_epochs - 1)


def resolve_cursor(state: dict, shard: Optional[int] = None) -> Tuple[int, int]:
    """(absolute position, items_per_epoch) of a cursor in base-plan
    coordinates, translating a cursor taken from an elastically resumed
    reader.  A cursor inside the leftover epoch has no such equivalent and is
    refused."""
    who = f"old shard {shard}: " if shard is not None else ""
    if "items_per_epoch" not in state:
        raise PetastormTpuError(
            f"{who}cursor lacks 'items_per_epoch' - pass the full"
            " Reader.state_dict() (older/stripped cursors cannot be"
            " safety-checked and are refused)")
    pos = int(state["position"])
    ipe = int(state["items_per_epoch"])
    rebased = state.get("elastic_rebased")
    if rebased is None:
        return pos, ipe
    leftover = int(rebased["leftover_len"])
    if pos < leftover:
        raise PetastormTpuError(
            f"{who}cursor is mid-way through an elastic leftover epoch"
            f" (position {pos} < leftover {leftover}); it cannot be mapped"
            " back to per-shard coordinates. Checkpoint again after the"
            " leftover epoch finishes.")
    base_ipe = int(rebased["base_items_per_epoch"])
    base_pos = (int(rebased["resume_epoch"]) + 1) * base_ipe + (pos - leftover)
    return base_pos, base_ipe


def elastic_resume_plan(row_groups: Sequence[RowGroupRef], states: Sequence[dict],
                        new_shard_index: int, new_shard_count: int,
                        shuffle_row_groups: bool = True,
                        shuffle_seed: Optional[int] = None,
                        shuffle_row_drop_partitions: int = 1,
                        shard_mode: str = "static") -> ElasticResumePlan:
    """The resume plan of one new shard from every old shard's cursor.

    ``states``: each old shard's ``Reader.state_dict()``, ordered by old
    shard index.  The plan arguments (shuffle, seed, drop partitions, shard
    mode) must be the original run's: the orders
    are recomputed, not stored.  The epoch in progress is the earliest epoch
    an old shard had not finished; a shard ahead of it contributes nothing
    to the leftover (its next-epoch items are re-read, never lost).
    """
    old_count = len(states)
    if old_count < 1:
        raise PetastormTpuError("elastic resume needs at least one old state")
    if not 0 <= new_shard_index < new_shard_count:
        raise PetastormTpuError(
            f"new_shard_index {new_shard_index} out of range for"
            f" {new_shard_count}")

    def shard_plan(idx: int, count: Optional[int]) -> ReadPlan:
        return ReadPlan(row_groups, shard_index=idx if count else None, shard_count=count,
                        shuffle_row_groups=shuffle_row_groups, shuffle_seed=shuffle_seed,
                        shuffle_row_drop_partitions=shuffle_row_drop_partitions,
                        shard_mode=shard_mode)

    cursors = []  # (epoch, offset, plan) per old shard
    for s, state in enumerate(states):
        plan_s = shard_plan(s, old_count) if old_count > 1 else shard_plan(0, None)
        ipe = len(plan_s.epoch_items(0))
        pos, stored_ipe = resolve_cursor(state, shard=s)
        if stored_ipe != ipe:
            raise PetastormTpuError(
                f"old shard {s}: checkpoint says {stored_ipe} items/epoch but"
                f" the recomputed plan has {ipe} - dataset contents or plan"
                " settings (seed/shuffle/drop/shard_mode) changed since the"
                " checkpoint")
        epoch, off = (pos // ipe, pos % ipe) if ipe else (0, 0)
        cursors.append((epoch, off, plan_s))

    resume_epoch = min(epoch for epoch, _, _ in cursors)
    leftover: List[WorkItem] = []
    for epoch, off, plan_s in cursors:
        if epoch == resume_epoch:
            leftover.extend(plan_s.epoch_items(resume_epoch)[off:])
    dealt = leftover[new_shard_index::new_shard_count]
    base = shard_plan(new_shard_index, new_shard_count if new_shard_count > 1 else None)
    return ElasticResumePlan(base, resume_epoch, dealt)
