"""The port's shuffling buffers and seed derivation against the JAX package's.

Host shuffling is numpy work in both packages (``default_rng``, the same
draws and the same swap-remove), so the same source with the same seed gives
the same batches row for row: every comparison here is exact.
"""

import queue
import types

import numpy as np
import pytest

from petastorm_tpu import seeding as jax_seeding
from petastorm_tpu import shuffle as jax_shuffle
from petastorm_tpu.batch import ColumnBatch as JaxColumnBatch

from petastorm_tpu_torch import seeding, shuffle
from petastorm_tpu_torch.batch import ColumnBatch
from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.native.image import _MIXED_GEOMETRY_GUIDANCE


def _columns(start, n):
    """Rows ``start..start+n`` of a few column kinds: scalars, a row shape,
    python objects."""
    ids = np.arange(start, start + n)
    names = np.empty(n, dtype=object)
    names[:] = [f"row{i}" for i in ids]
    return {"id": ids.astype(np.int64),
            "vec": np.stack([ids * 1.5, ids * -2.0, ids + 0.25], axis=1).astype(np.float32),
            "name": names}


def _sources(sizes):
    """The same stream of rowgroups as port and JAX ColumnBatches."""
    port, ref, start = [], [], 0
    for n in sizes:
        port.append(ColumnBatch(_columns(start, n), n))
        ref.append(JaxColumnBatch(_columns(start, n), n))
        start += n
    return port, ref


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.num_rows == w.num_rows
        assert set(g.columns) == set(w.columns)
        for name in w.columns:
            np.testing.assert_array_equal(g.columns[name], w.columns[name])


SIZES = [7, 5, 9, 3, 11, 6, 8]


@pytest.mark.parametrize("capacity,min_after,batch", [(16, 8, 4), (25, 0, 8), (12, 5, 7),
                                                      (40, 20, 5), (64, 32, 16)])
@pytest.mark.parametrize("seed", [0, 1, 12345])
def test_random_buffer_batches_equal_jax_row_for_row(capacity, min_after, batch, seed):
    port_src, ref_src = _sources(SIZES)
    got = list(shuffle.iter_batched(
        iter(port_src), shuffle.RandomShufflingBuffer(capacity, min_after, seed=seed), batch))
    want = list(jax_shuffle.iter_batched(
        iter(ref_src), jax_shuffle.RandomShufflingBuffer(capacity, min_after, seed=seed), batch))
    _assert_same_batches(got, want)
    ids = np.concatenate([b.columns["id"] for b in got])
    assert sorted(ids.tolist()) == list(range(sum(SIZES)))
    assert ids.tolist() != list(range(sum(SIZES)))


@pytest.mark.parametrize("batch", [1, 4, 13, 100])
def test_noop_buffer_batches_equal_jax(batch):
    port_src, ref_src = _sources(SIZES)
    got = list(shuffle.iter_batched(iter(port_src), shuffle.NoopShufflingBuffer(), batch))
    want = list(jax_shuffle.iter_batched(iter(ref_src), jax_shuffle.NoopShufflingBuffer(), batch))
    _assert_same_batches(got, want)
    assert np.concatenate([b.columns["id"] for b in got]).tolist() == list(range(sum(SIZES)))


def _next_fn(batches, empties=()):
    """A source for ``iter_batched_multi``: the batches in order, raising
    ``queue.Empty`` (a timed-out fetch) before each position in
    ``empties``; no clock involved."""
    state = {"i": 0, "empties": list(empties)}

    def next_fn(_timeout):
        if state["empties"] and state["empties"][0] == state["i"]:
            state["empties"].pop(0)
            raise queue.Empty
        if state["i"] == len(batches):
            raise StopIteration
        state["i"] += 1
        return batches[state["i"] - 1]

    return next_fn


@pytest.mark.parametrize("routed", [False, True], ids=["one-route", "two-routes"])
@pytest.mark.parametrize("seed", [0, 9])
def test_multi_buffer_batches_equal_jax(routed, seed):
    """Partitioned assembly: batches assemble within a route key only."""
    port_src, ref_src = _sources(SIZES)
    route = (lambda b: int(b.columns["id"][0]) % 2) if routed else (lambda b: ())

    def run(mod, src):
        return list(mod.iter_batched_multi(
            _next_fn(src), route, lambda: mod.RandomShufflingBuffer(20, 6, seed=seed), 5))

    got, want = run(shuffle, port_src), run(jax_shuffle, ref_src)
    _assert_same_batches(got, want)
    if routed:
        starts = np.cumsum([0] + SIZES[:-1])
        for b in got:  # rows of odd-starting and even-starting rowgroups never mix
            owners = np.searchsorted(starts, b.columns["id"], side="right") - 1
            assert len(set((starts[owners] % 2).tolist())) == 1


def test_straggler_release_bypasses_the_floor_as_jax_does():
    """A timed-out fetch while a full batch sits behind the floor releases
    it, once per time-out, with the JAX package's rows."""
    port_src, ref_src = _sources([6, 6, 6])
    results = {}
    for mod, src in ((shuffle, port_src), (jax_shuffle, ref_src)):
        released = []
        batches = list(mod.iter_batched_multi(
            _next_fn(src, empties=[2, 2]), lambda b: (),
            lambda: mod.RandomShufflingBuffer(16, 8, seed=4), 4,
            straggler_release_s=1.0, on_straggler_release=lambda: released.append(1)))
        results[mod.__name__] = (batches, len(released))
    (got, got_releases), (want, want_releases) = results.values()
    _assert_same_batches(got, want)
    # 12 rows buffered: one batch above the floor of 8, then each of the two
    # time-outs releases one more from the 8 the floor withholds
    assert got_releases == want_releases == 2
    assert sum(b.num_rows for b in got) == 18


def test_no_release_without_a_full_batch_or_above_the_floor():
    port_src, _ = _sources([3])
    released = []
    batches = list(shuffle.iter_batched_multi(
        _next_fn(port_src, empties=[1, 1, 1]), lambda b: (),
        lambda: shuffle.RandomShufflingBuffer(16, 8, seed=0), 4,
        straggler_release_s=1.0, on_straggler_release=lambda: released.append(1)))
    assert not released  # 3 rows never make a batch of 4 before the end
    assert [b.num_rows for b in batches] == [3]


@pytest.mark.parametrize("multi", [False, True], ids=["iter_batched", "iter_batched_multi"])
def test_deadlock_is_an_error(multi):
    """A buffer that cannot hold its floor plus one batch would never emit."""
    src, _ = _sources([10, 10, 10])
    with pytest.raises(PetastormTpuError, match="Shuffling buffer deadlock"):
        if multi:
            list(shuffle.iter_batched_multi(
                _next_fn(src), lambda b: (), lambda: shuffle.RandomShufflingBuffer(10, 8), 4))
        else:
            list(shuffle.iter_batched(iter(src), shuffle.RandomShufflingBuffer(10, 8), 4))


def test_coefficient_plane_geometry_guard():
    """Planes of another geometry cannot share the buffer: the guidance error
    names the fix, not a shape mismatch further down."""
    buf = shuffle.RandomShufflingBuffer(32, seed=0)
    buf.add(ColumnBatch({"image#p1": np.zeros((4, 14, 14, 64), np.int16)}, 4))
    with pytest.raises(PetastormTpuError, match="coefficient-plane shapes differ") as err:
        buf.add(ColumnBatch({"image#p1": np.zeros((4, 28, 28, 64), np.int16)}, 4))
    assert _MIXED_GEOMETRY_GUIDANCE in str(err.value)
    buf = shuffle.RandomShufflingBuffer(32, seed=0)
    buf.add(ColumnBatch({"x": np.zeros((4, 3))}, 4))
    with pytest.raises(PetastormTpuError, match="pad variable fields before shuffling"):
        buf.add(ColumnBatch({"x": np.zeros((4, 5))}, 4))


def test_buffer_contract_errors():
    with pytest.raises(PetastormTpuError, match="capacity must be"):
        shuffle.RandomShufflingBuffer(0)
    with pytest.raises(PetastormTpuError, match="cannot exceed capacity"):
        shuffle.RandomShufflingBuffer(4, 5)
    buf = shuffle.RandomShufflingBuffer(4, 2, seed=0)
    buf.add(ColumnBatch({"x": np.arange(3)}, 3))
    with pytest.raises(PetastormTpuError, match="Buffer overflow"):
        buf.add(ColumnBatch({"x": np.arange(2)}, 2))
    with pytest.raises(PetastormTpuError, match="below decorrelation floor"):
        buf.retrieve(2)
    assert buf.retrieve(2, force=True).num_rows == 2
    buf.finish()
    assert buf.can_retrieve(5) and buf.retrieve(5).num_rows == 1
    with pytest.raises(PetastormTpuError, match="after finish"):
        buf.add(ColumnBatch({"x": np.arange(1)}, 1))


# -- seeding ---------------------------------------------------------------------


@pytest.mark.parametrize("seed,epoch,domain,extra", [
    (0, 0, "loader.shuffle_buffer", ()), (None, 3, "pytorch.shuffle_buffer", ()),
    (2 ** 40 + 7, 1, "plan.permutation", ()), (5, 0, "x", (1, "a", b"b", True)),
    (-3, 17, "", (np.int64(4),))])
def test_derive_seed_equals_jax(seed, epoch, domain, extra):
    assert seeding.derive_seed(seed, epoch, domain, *extra) == \
        jax_seeding.derive_seed(seed, epoch, domain, *extra)
    np.testing.assert_array_equal(
        seeding.seed_stream(seed, epoch, domain, *extra).integers(0, 2 ** 31, 8),
        jax_seeding.seed_stream(seed, epoch, domain, *extra).integers(0, 2 ** 31, 8))


@pytest.mark.parametrize("deterministic,shuffle_seed,explicit", [
    ("seed", 7, None), ("seed", None, None), ("off", 7, None), ("seed", 7, 99),
    ("off", None, 3), (None, 4, None)])
def test_reader_buffer_seed_equals_jax(deterministic, shuffle_seed, explicit):
    reader = types.SimpleNamespace(shuffle_seed=shuffle_seed)
    if deterministic is not None:
        reader.deterministic = deterministic
    for domain in ("loader.shuffle_buffer", "pytorch.shuffle_buffer"):
        assert seeding.reader_buffer_seed(reader, domain, explicit) == \
            jax_seeding.reader_buffer_seed(reader, domain, explicit)


@pytest.mark.parametrize("deterministic", ["auto", None, "seed", "off"])
@pytest.mark.parametrize("shuffle_seed", [None, 0, 11])
def test_resolve_deterministic_equals_jax(deterministic, shuffle_seed):
    assert seeding.resolve_deterministic(deterministic, shuffle_seed) == \
        jax_seeding.resolve_deterministic(deterministic, shuffle_seed)


def test_resolve_deterministic_refuses_other_values():
    with pytest.raises(PetastormTpuError, match="'seed', 'off' or 'auto'"):
        seeding.resolve_deterministic("on", 1)
