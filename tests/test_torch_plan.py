"""The port's read plan against the JAX package's, on the CPU.

``ReadPlan.epoch_items`` and ``elastic_resume_plan`` of both packages over
the same rowgroups, across a grid of shard counts (none, 2, 3), shard modes
(``'static'``, ``'epoch'``), row-drop partitions (1, 2, 3), shuffle on and
off, seeds and epochs: the items (rowgroup, drop partition, row slice,
rows) must be equal and in the same order, and the validation errors must
carry the same messages.
"""

import itertools

import pytest

import petastorm_tpu.plan as jax_plan
from petastorm_tpu.errors import PetastormTpuError as JaxError
from petastorm_tpu.etl import metadata as jax_metadata

import petastorm_tpu_torch.plan as torch_plan
from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.etl import metadata as torch_metadata

#: rows per rowgroup: uneven, so the drop slices differ in length
_ROWS = [7, 5, 9, 4, 8, 3, 6, 10, 2, 7, 5, 11]


def _row_groups(mod, n=len(_ROWS)):
    return [mod.RowGroupRef(f"/d/part-{i // 5}.parquet", i % 5, _ROWS[i], i) for i in range(n)]


def _items(items):
    return [(w.row_group.global_index, w.row_group.path, w.row_group.row_group,
             w.drop_partition, w.row_slice(), w.num_rows) for w in items]


GRID = list(itertools.product([None, 2, 3], ["static", "epoch"], [1, 2, 3], [True, False],
                              [None, 5]))


@pytest.mark.parametrize("shards,mode,drop,shuffle,seed", GRID)
def test_epoch_items_equal(shards, mode, drop, shuffle, seed):
    kw = dict(shuffle_row_groups=shuffle, shuffle_seed=seed,
              shuffle_row_drop_partitions=drop, shard_mode=mode)
    for shard in range(shards or 1):
        if shards:
            kw.update(shard_index=shard, shard_count=shards)
        want = jax_plan.ReadPlan(_row_groups(jax_metadata), **kw)
        got = torch_plan.ReadPlan(_row_groups(torch_metadata), **kw)
        for epoch in range(3):
            assert _items(got.epoch_items(epoch)) == _items(want.epoch_items(epoch))
        assert got.rows_per_epoch() == want.rows_per_epoch()
        assert got.total_items(3) == want.total_items(3)


def test_epoch_mode_redeals_and_covers_every_rowgroup():
    """Two shards in epoch mode are disjoint within an epoch, cover every
    rowgroup, and are dealt differently in another epoch."""
    deals = []
    for epoch in range(2):
        per_shard = [{w.row_group.global_index for w in torch_plan.ReadPlan(
            _row_groups(torch_metadata), shard_index=s, shard_count=2, shuffle_seed=3,
            shard_mode="epoch").epoch_items(epoch)} for s in range(2)]
        assert not per_shard[0] & per_shard[1]
        assert per_shard[0] | per_shard[1] == set(range(len(_ROWS)))
        deals.append(per_shard[0])
    assert deals[0] != deals[1]


@pytest.mark.parametrize("drop", [1, 2, 3])
def test_drop_partitions_cover_each_rowgroup_once(drop):
    items = torch_plan.ReadPlan(_row_groups(torch_metadata), shuffle_seed=1,
                                shuffle_row_drop_partitions=drop).epoch_items(0)
    for i, rows in enumerate(_ROWS):
        slices = sorted(w.row_slice() for w in items if w.row_group.global_index == i)
        assert len(slices) == drop
        assert slices[0][0] == 0 and slices[-1][1] == rows
        assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))


def _state(position, ipe):
    return {"position": position, "items_per_epoch": ipe}


@pytest.mark.parametrize("old,new,mode,drop,positions", [
    (1, 2, "static", 2, [5]),
    (2, 3, "static", 3, [4, 7]),
    (2, 3, "epoch", 1, [3, 2]),
    (3, 2, "epoch", 2, [1, 9, 4]),
    (2, 1, "epoch", 3, [20, 11]),
    (3, 3, "static", 1, [0, 4, 8]),
])
def test_elastic_resume_plan_equal(old, new, mode, drop, positions):
    kw = dict(shuffle_row_groups=True, shuffle_seed=11, shuffle_row_drop_partitions=drop,
              shard_mode=mode)
    ipes = []
    for s in range(old):
        shard = dict(shard_index=s, shard_count=old) if old > 1 else {}
        ipes.append(len(jax_plan.ReadPlan(_row_groups(jax_metadata), **shard, **kw)
                        .epoch_items(0)))
    states = [_state(p, ipe) for p, ipe in zip(positions, ipes)]
    for shard in range(new):
        want = jax_plan.elastic_resume_plan(_row_groups(jax_metadata), states, shard, new, **kw)
        got = torch_plan.elastic_resume_plan(_row_groups(torch_metadata), states, shard, new,
                                             **kw)
        assert (got.resume_epoch, got.leftover_len, got.base_items_per_epoch) == \
            (want.resume_epoch, want.leftover_len, want.base_items_per_epoch)
        for epoch in range(3):
            assert _items(got.epoch_items(epoch)) == _items(want.epoch_items(epoch))
        assert got.total_items(3) == want.total_items(3)
        assert got.rows_per_epoch() == want.rows_per_epoch()


@pytest.mark.parametrize("kwargs", [
    {"shard_mode": "round-robin"},
    {"shuffle_row_drop_partitions": 0},
    {"shard_index": 0},
    {"shard_index": 3, "shard_count": 3},
    {"shard_index": 0, "shard_count": 3, "shard_mode": "global"},
])
def test_plan_refusals_match(kwargs):
    with pytest.raises(JaxError) as want:
        jax_plan.ReadPlan(_row_groups(jax_metadata), **kwargs)
    with pytest.raises(PetastormTpuError) as got:
        torch_plan.ReadPlan(_row_groups(torch_metadata), **kwargs)
    assert str(got.value) == str(want.value)


def test_too_many_shards_message_matches():
    with pytest.raises(JaxError) as want:
        jax_plan.ReadPlan(_row_groups(jax_metadata, 2), shard_index=0, shard_count=3)
    with pytest.raises(PetastormTpuError) as got:
        torch_plan.ReadPlan(_row_groups(torch_metadata, 2), shard_index=0, shard_count=3)
    assert type(got.value).__name__ == type(want.value).__name__ == "NoDataAvailableError"
    assert str(got.value) == str(want.value)


def test_elastic_refuses_a_changed_drop_setting_like_jax():
    ipe = len(torch_plan.ReadPlan(_row_groups(torch_metadata),
                                  shuffle_row_drop_partitions=2).epoch_items(0))
    states = [_state(3, ipe)]
    with pytest.raises(JaxError) as want:
        jax_plan.elastic_resume_plan(_row_groups(jax_metadata), states, 0, 2,
                                     shuffle_row_drop_partitions=3)
    with pytest.raises(PetastormTpuError) as got:
        torch_plan.elastic_resume_plan(_row_groups(torch_metadata), states, 0, 2,
                                       shuffle_row_drop_partitions=3)
    assert str(got.value) == str(want.value)
    assert "seed/shuffle/drop/shard_mode" in str(got.value)
