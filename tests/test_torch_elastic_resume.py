"""Elastic resume of the port against the JAX package.

Mirrors ``tests/test_elastic_resume.py:55-175`` on the serial and thread
pools.  Several shards are simulated by several readers in one process.
Each new shard of an elastic resume must be dealt exactly the rows the JAX
package deals it (the old cursors are taken from each package's own readers,
which agree on the serial pool), every row must be read as many times as
there are epochs, and the refusals carry the JAX package's messages.
"""

import collections

import numpy as np
import pytest

from petastorm_tpu.errors import PetastormTpuError as JaxPetastormTpuError
from petastorm_tpu.reader import elastic_resume as jax_elastic_resume
from petastorm_tpu.reader import make_batch_reader as jax_make_batch_reader

from petastorm_tpu_torch import Field, Schema, make_batch_reader, write_dataset
from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.etl.metadata import open_dataset
from petastorm_tpu_torch.plan import ReadPlan
from petastorm_tpu_torch.reader import elastic_resume

SEED = 7
ROWS = 64  # 16 rowgroups x 4 rows
PACKAGES = {"port": (make_batch_reader, elastic_resume),
            "jax": (jax_make_batch_reader, jax_elastic_resume)}


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    url = str(tmp_path_factory.mktemp("elastic") / "ds")
    write_dataset(url, Schema("Elastic", [Field("id", np.int64)]),
                  [{"id": i} for i in range(ROWS)], row_group_size_rows=4)
    return url


def _reader(package, url, shard, count, num_epochs, resume=None, pool="serial"):
    make = PACKAGES[package][0]
    kwargs = {"workers_count": 3} if pool == "thread" else {}
    return make(url, reader_pool_type=pool, shuffle_row_groups=True, shuffle_seed=SEED,
                cur_shard=shard, shard_count=count, num_epochs=num_epochs,
                resume_from=resume, **kwargs)


def _consume(reader, n_items=None):
    """Take ``n_items`` batches (or all); returns the row ids of each."""
    out = []
    for batch in reader.iter_batches():
        out.append([int(v) for v in batch.columns["id"]])
        if n_items is not None and len(out) >= n_items:
            break
    return out


def _flat(batches):
    return [i for b in batches for i in b]


@pytest.mark.parametrize("pool", ["serial", "thread"])
@pytest.mark.parametrize("old_count,new_count", [(4, 2), (2, 4), (4, 4), (3, 5)])
def test_mid_epoch_reshard_deals_the_jax_rows(ds, old_count, new_count, pool):
    """Old shards consume different prefixes (shard s takes s items); the new
    shards of each package then read the same rows, no row lost or doubled
    over the two epochs."""
    dealt, seen = {}, []
    for package in PACKAGES:
        states, head = [], []
        for s in range(old_count):
            with _reader(package, ds, s, old_count, 2) as r:
                head.extend(_flat(_consume(r, n_items=s)))
                states.append(r.state_dict())
        token = PACKAGES[package][1](states)
        dealt[package] = []
        for j in range(new_count):
            with _reader(package, ds, j, new_count, 2, resume=token, pool=pool) as r:
                dealt[package].append(_consume(r))
        if package == "port":
            seen = head + _flat(_flat(dealt[package]))
    assert dealt["port"] == dealt["jax"]
    counts = collections.Counter(seen)
    assert sorted(counts) == list(range(ROWS))
    assert set(counts.values()) == {2}, collections.Counter(counts.values())


@pytest.mark.parametrize("pool", ["serial", "thread"])
def test_epoch_boundary_reshard_exact(ds, pool):
    """Epoch 0 finished on 4 shards, epoch 1 on 2: each new shard reads the
    JAX package's rows, and the resumed epoch is the old epoch 1."""
    dealt = {}
    for package in PACKAGES:
        seen, states = [], []
        for s in range(4):
            with _reader(package, ds, s, 4, 1) as r:
                seen.extend(_flat(_consume(r)))
                states.append(r.state_dict())
        assert sorted(seen) == list(range(ROWS))
        token = PACKAGES[package][1](states)
        dealt[package] = []
        for j in range(2):
            with _reader(package, ds, j, 2, 1, resume=token, pool=pool) as r:
                dealt[package].append(_consume(r))
    assert dealt["port"] == dealt["jax"]
    assert sorted(_flat(_flat(dealt["port"]))) == list(range(ROWS))
    rgs = open_dataset(ds).row_groups
    e0, e1 = ([it.row_group.global_index for it in ReadPlan(rgs, shuffle_seed=SEED).epoch_items(e)]
              for e in (0, 1))
    assert e0 != e1  # the orders differ between epochs, so the epoch was not replayed


@pytest.mark.parametrize("pool", ["serial", "thread"])
def test_re_resume_past_leftover_epoch(ds, pool):
    """Past the leftover epoch an elastic reader's cursor resumes elastically
    again (4 -> 2 -> 3) to the JAX package's rows, no row lost or doubled."""
    dealt = {}
    for package in PACKAGES:
        seen, states = [], []
        for s in range(4):
            with _reader(package, ds, s, 4, 3) as r:
                seen.extend(_flat(_consume(r, n_items=s)))
                states.append(r.state_dict())
        token = PACKAGES[package][1](states)
        states2 = []
        for j in range(2):
            with _reader(package, ds, j, 2, 3, resume=token) as r:
                leftover_items = len(r.plan.epoch_items(0) if package == "port"
                                     else r._plan.epoch_items(0))
                seen.extend(_flat(_consume(r, n_items=leftover_items + 2)))
                states2.append(r.state_dict())
        assert all("elastic_rebased" in st for st in states2)
        token2 = PACKAGES[package][1](states2)
        dealt[package] = []
        for k in range(3):
            with _reader(package, ds, k, 3, 2, resume=token2, pool=pool) as r:
                dealt[package].append(_consume(r))
        seen.extend(_flat(_flat(dealt[package])))
        counts = collections.Counter(seen)
        assert sorted(counts) == list(range(ROWS))
        assert set(counts.values()) == {3}  # 3 epochs, each id 3 times
        if package == "port":
            port_states2 = states2
        else:
            assert port_states2 == states2  # the rebased cursors are equal too
    assert dealt["port"] == dealt["jax"]


def _refusal(package, build):
    try:
        build(package)
    except (PetastormTpuError, JaxPetastormTpuError) as exc:
        return str(exc)
    raise AssertionError(f"{package}: no refusal")


def _same_refusal(build, match):
    got, want = _refusal("port", build), _refusal("jax", build)
    assert got == want and match in got, (got, want)


def test_changed_settings_refused_with_the_jax_message(ds):
    with _reader("port", ds, 0, 4, 1) as r:
        _consume(r, n_items=1)
        state = r.state_dict()
    bad = dict(state, items_per_epoch=state["items_per_epoch"] + 1)
    _same_refusal(lambda p: PACKAGES[p][0](ds, shuffle_seed=SEED, cur_shard=0, shard_count=2,
                                           resume_from=PACKAGES[p][1]([bad] * 4)),
                  "changed since")


def test_mid_leftover_re_resume_refused_with_the_jax_message(ds):
    states = []
    for s in range(2):
        with _reader("port", ds, s, 2, 3) as r:
            _consume(r, n_items=3)
            states.append(r.state_dict())
    with _reader("port", ds, 0, 4, 3, resume=elastic_resume(states)) as r:
        _consume(r, n_items=1)
        mid = r.state_dict()
    assert "elastic_rebased" in mid
    _same_refusal(lambda p: PACKAGES[p][0](ds, shuffle_seed=SEED, cur_shard=0, shard_count=2,
                                           resume_from=PACKAGES[p][1]([mid] * 4)),
                  "mid-way through")
    _same_refusal(lambda p: PACKAGES[p][0](ds, shuffle_seed=SEED, cur_shard=0, shard_count=4,
                                           resume_from=mid), "mid-way through")


def test_stripped_cursor_refused_with_the_jax_message(ds):
    with _reader("port", ds, 0, 2, 1) as r:
        _consume(r, n_items=1)
        stripped = {"position": r.state_dict()["position"]}
    _same_refusal(lambda p: PACKAGES[p][0](ds, shuffle_seed=SEED, cur_shard=0, shard_count=2,
                                           resume_from=PACKAGES[p][1]([stripped] * 2)),
                  "lacks 'items_per_epoch'")


def test_rebased_cursor_under_another_layout_refused_with_the_jax_message(ds):
    """A cursor past the leftover epoch resumes plainly only under its own
    layout; under another the JAX message says to resume elastically."""
    states = []
    for s in range(2):
        with _reader("port", ds, s, 2, 3) as r:
            _consume(r, n_items=1)
            states.append(r.state_dict())
    with _reader("port", ds, 0, 4, 3, resume=elastic_resume(states)) as r:
        _consume(r, n_items=len(r.plan.epoch_items(0)) + 1)
        past = r.state_dict()
    _same_refusal(lambda p: PACKAGES[p][0](ds, shuffle_seed=SEED, cur_shard=0, shard_count=2,
                                           resume_from=past), "use elastic_resume()")


def test_thread_pool_resume_is_exact(ds):
    """The port's thread pool delivers in plan order: a cursor taken after n
    batches resumes with no row lost and none doubled."""
    for trial in range(3):
        kwargs = dict(reader_pool_type="thread", workers_count=4, shuffle_seed=SEED + trial,
                      num_epochs=1)
        with make_batch_reader(ds, **kwargs) as r:
            first = _flat(_consume(r, n_items=5))
            state = r.state_dict()
        with make_batch_reader(ds, resume_from=state, **kwargs) as r:
            rest = _flat(_consume(r))
        assert sorted(first + rest) == list(range(ROWS))
