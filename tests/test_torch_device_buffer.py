"""The device shuffle buffer of the port against the JAX package's, on the CPU.

``DeviceShufflingBuffer`` takes its draws from a draw source.  Fed the JAX
buffer's own key schedule (``jax.random.split``, ``randint``, ``fold_in(key,
1)``, ``permutation``, replayed by ``JaxDraws`` below), the port's buffer must
give every ``push`` and ``drain`` output bit for bit as
``petastorm_tpu.jax.device_buffer.DeviceShufflingBuffer`` does; so must
``CudaDataLoader(device_shuffle_capacity=...)`` against ``JaxDataLoader`` on
the serial pool.  The port's own draws (torch generators) are held to the
JAX tests' assertions (every row once, shuffled, the same order for the
same seed), to the rank-correlation check of the JAX buffer's quality test
and to a chi-square check of the slot draws.
"""

import collections

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P
from scipy import stats

from petastorm_tpu.errors import PetastormTpuError as JaxPetastormTpuError
from petastorm_tpu.jax import JaxDataLoader
from petastorm_tpu.jax import device_buffer as jax_device_buffer
from petastorm_tpu.reader import make_batch_reader as jax_make_batch_reader
from petastorm_tpu.test_util.shuffling_analysis import rank_correlation

from petastorm_tpu_torch import Field, Schema, make_batch_reader, make_reader, write_dataset
from petastorm_tpu_torch.cuda import device_buffer
from petastorm_tpu_torch.cuda.device_buffer import DeviceShufflingBuffer, TorchDraws
from petastorm_tpu_torch.cuda.loader import VALID_ROWS, CudaDataLoader
from petastorm_tpu_torch.errors import PetastormTpuError


class JaxDraws:
    """The JAX buffer's draws (``petastorm_tpu/jax/device_buffer.py:93``,
    ``:120-123``, ``:137``, ``:67-68``) as a draw source of the port's buffer."""

    def __init__(self, seed):
        self._key = jax.random.PRNGKey(seed)

    def _next_key(self):
        self._key, sub = jax.random.split(self._key)
        return sub

    def push(self, capacity, rows):
        key = self._next_key()
        slot = int(jax.random.randint(key, (), 0, capacity))
        return slot, _torch(jax.random.permutation(jax.random.fold_in(key, 1), rows))

    def drain(self, slots, rows):
        key = self._next_key()
        return (_torch(jax.random.permutation(key, slots)),
                _torch(jax.random.permutation(jax.random.fold_in(key, 1), rows)))


def _torch(jax_array):
    return torch.from_numpy(np.asarray(jax_array).astype(np.int64))


def _batches(n, rows=4, seed=0):
    """``n`` batches of three fields as numpy, ids unique across batches."""
    rng = np.random.default_rng(seed)
    return [{"id": np.arange(i * rows, (i + 1) * rows, dtype=np.int32),
             "x": rng.standard_normal((rows, 3)).astype(np.float32),
             "img": rng.integers(0, 256, (rows, 2, 2, 3), dtype=np.uint8)}
            for i in range(n)]


def _assert_batch_equal(got, want):
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), err_msg=name)


# -- the buffer against the JAX buffer -----------------------------------------------


@pytest.mark.parametrize("capacity,pushes", [(1, 6), (3, 9), (5, 3)],
                         ids=["capacity1", "capacity3", "partial_fill"])
@pytest.mark.parametrize("seed", [0, 17])
def test_buffer_equals_jax_buffer_with_its_draws(capacity, pushes, seed):
    want_buf = jax_device_buffer.DeviceShufflingBuffer(capacity, seed=seed)
    got_buf = DeviceShufflingBuffer(capacity, device="cpu", draws=JaxDraws(seed))
    emitted = 0
    for batch in _batches(pushes):
        want = want_buf.push({k: jax.numpy.asarray(v) for k, v in batch.items()})
        got = got_buf.push({k: torch.from_numpy(v) for k, v in batch.items()})
        assert (got is None) == (want is None)
        if want is not None:
            _assert_batch_equal(got, want)
            emitted += 1
    assert emitted == max(pushes - capacity, 0)
    drained_want, drained_got = list(want_buf.drain()), list(got_buf.drain())
    assert len(drained_got) == len(drained_want) == min(capacity, pushes)
    for got, want in zip(drained_got, drained_want):
        _assert_batch_equal(got, want)
    assert list(got_buf.drain()) == []  # the buffer ends empty


def test_exchange_and_self_shuffle_equal_jax():
    batches = _batches(4, rows=6, seed=3)
    jax_store = {k: jax.numpy.stack([b[k] for b in batches[:3]]) for k in batches[0]}
    store = {k: torch.from_numpy(np.stack([b[k] for b in batches[:3]])) for k in batches[0]}
    incoming = batches[3]
    key = jax.random.PRNGKey(5)
    want_store, want_out = jax_device_buffer._exchange(
        jax_store, {k: jax.numpy.asarray(v) for k, v in incoming.items()}, 2, key)
    got_out = device_buffer._exchange(store, {k: torch.from_numpy(v) for k, v in incoming.items()},
                                      2, _torch(jax.random.permutation(key, 12)))
    _assert_batch_equal(got_out, want_out)
    _assert_batch_equal(store, want_store)  # the slot was written in place

    key = jax.random.PRNGKey(9)
    want = jax_device_buffer._self_shuffle(want_store, key)
    got = device_buffer._self_shuffle(store, _torch(jax.random.permutation(key, 3)),
                                      _torch(jax.random.permutation(jax.random.fold_in(key, 1),
                                                                    6)))
    _assert_batch_equal(got, want)


def test_capacity_below_one_raises_the_jax_message():
    with pytest.raises(PetastormTpuError, match="device shuffle capacity must be >= 1"):
        DeviceShufflingBuffer(0, device="cpu")


def test_buffer_without_seed_draws_one():
    """``seed=None`` draws from OS entropy: two buffers differ (with
    overwhelming probability over eight pushes of 2x16 rows)."""
    outs = []
    for _ in range(2):
        buf = DeviceShufflingBuffer(2, device="cpu")
        rows = []
        for batch in _batches(8, rows=16):
            out = buf.push({"id": torch.from_numpy(batch["id"])})
            if out is not None:
                rows += out["id"].tolist()
        rows += [v for out in buf.drain() for v in out["id"].tolist()]
        outs.append(rows)
    assert sorted(outs[0]) == sorted(outs[1]) and outs[0] != outs[1]


def test_slot_draws_are_uniform():
    """Chi-square of 40,000 slot draws over 8 slots, at p = 0.001 (critical
    value 24.32 with 7 degrees of freedom); every permutation a permutation."""
    draws = TorchDraws(123, torch.device("cpu"))
    slots = np.empty(40_000, np.int64)
    for i in range(len(slots)):
        slots[i], perm = draws.push(8, 6)
        if i < 100:
            assert sorted(perm.tolist()) == list(range(6))
    counts = np.bincount(slots, minlength=8)
    assert len(counts) == 8
    chi2 = stats.chisquare(counts).statistic
    assert chi2 < stats.chi2.ppf(0.999, 7), counts
    firsts = np.bincount([int(draws.drain(5, 4)[0][0]) for _ in range(5_000)], minlength=5)
    assert stats.chisquare(firsts).statistic < stats.chi2.ppf(0.999, 4), firsts


# -- the loader against JaxDataLoader --------------------------------------------------


@pytest.fixture(scope="module")
def num_ds(tmp_path_factory):
    """64 rows in rowgroups of 8, as the JAX loader tests' dataset."""
    url = str(tmp_path_factory.mktemp("device_buffer") / "num")
    rng = np.random.default_rng(0)
    schema = Schema("Num", [Field("idx", np.int64), Field("vec", np.float32, (6,)),
                            Field("tag", np.dtype("object"))])
    write_dataset(url, schema, [{"idx": i, "vec": rng.standard_normal(6).astype(np.float32),
                                 "tag": f"t{i}"} for i in range(64)], row_group_size_rows=8)
    return url


@pytest.fixture(scope="module")
def ordered_ds(tmp_path_factory):
    """256 rows in rowgroups of 8, as the JAX buffer's quality test's."""
    url = str(tmp_path_factory.mktemp("device_buffer_q") / "ds")
    write_dataset(url, Schema("Q", [Field("id", np.int64)]), [{"id": i} for i in range(256)],
                  row_group_size_rows=8)
    return url


def _port_ids(url, batch_size=4, field="idx", jax_draws=None, **kwargs):
    """Every delivered batch's ids (the padded tail cut to its valid rows)
    and whether each batch carried ``'_valid_rows'``."""
    with make_batch_reader(url, shuffle_row_groups=False, reader_pool_type="serial",
                           num_epochs=1) as r:
        with CudaDataLoader(r, batch_size, device="cpu", fields=[field], **kwargs) as loader:
            if jax_draws is not None:
                loader._device_buffer._draws = JaxDraws(jax_draws)
            batches = list(loader)
    return ([b[field][:b.get(VALID_ROWS, batch_size)].tolist() for b in batches],
            [VALID_ROWS in b for b in batches])


def _flat(batches):
    return [v for b in batches for v in b]


@pytest.mark.parametrize("capacity,batch_size,drop_last", [(4, 4, True), (2, 24, False),
                                                           (3, 5, False), (100, 4, True)])
def test_loader_equals_jax_loader_with_its_draws(num_ds, capacity, batch_size, drop_last):
    """The JAX loader with a one-device mesh (its padded-tail form) and the
    port with the JAX buffer's draws: the same batches, the tail last."""
    got, got_tail = _port_ids(num_ds, batch_size, drop_last=drop_last,
                              device_shuffle_capacity=capacity, jax_draws=3)
    with jax_make_batch_reader(num_ds, shuffle_row_groups=False, reader_pool_type="serial",
                               num_epochs=1) as r:
        with JaxDataLoader(r, batch_size=batch_size, fields=["idx"], drop_last=drop_last,
                           mesh=Mesh(np.asarray(jax.devices()[:1]), ("data",)),
                           shardings=P("data"), device_shuffle_capacity=capacity,
                           device_shuffle_seed=3) as loader:
            batches = list(loader)
    want = [np.asarray(b["idx"])[:b.get(VALID_ROWS, batch_size)].tolist() for b in batches]
    assert got == want
    assert got_tail == [VALID_ROWS in b for b in batches]


def test_device_shuffle_buffer_delivers_all_rows_shuffled(num_ds):
    plain = _flat(_port_ids(num_ds)[0])
    shuffled = _flat(_port_ids(num_ds, device_shuffle_capacity=4, device_shuffle_seed=3)[0])
    assert sorted(shuffled) == sorted(plain)
    assert shuffled != plain
    assert _flat(_port_ids(num_ds, device_shuffle_capacity=4, device_shuffle_seed=3)[0]) \
        == shuffled
    assert _flat(_port_ids(num_ds, device_shuffle_capacity=4, device_shuffle_seed=9)[0]) \
        != shuffled


def test_device_shuffle_seed_derives_from_the_reader(num_ds):
    """No ``device_shuffle_seed`` under ``deterministic='seed'``: the seed
    derives from the reader's ``shuffle_seed`` (domain
    ``loader.device_shuffle``), as the JAX loader's does."""
    def run(shuffle_seed):
        with make_batch_reader(num_ds, shuffle_seed=shuffle_seed, reader_pool_type="serial",
                               num_epochs=1) as r:
            with CudaDataLoader(r, 4, device="cpu", fields=["idx"],
                                device_shuffle_capacity=4) as loader:
                return [v for b in loader for v in b["idx"].tolist()]

    first = run(5)
    assert run(5) == first and run(6) != first
    assert sorted(first) == list(range(64))


def test_device_shuffle_partial_fill_still_shuffles(num_ds):
    got = _flat(_port_ids(num_ds, device_shuffle_capacity=100, device_shuffle_seed=5)[0])
    assert sorted(got) == list(range(64))
    assert got != list(range(64))  # drained shuffled, not insertion order


def test_device_shuffle_tail_batch_stays_last(num_ds):
    batches, tails = _port_ids(num_ds, 24, drop_last=False, device_shuffle_capacity=2,
                               device_shuffle_seed=7)
    # 64 rows / 24 = 2 full + 1 padded tail; the '_valid_rows' batch ends the
    # stream even though the resident batches drained after it was staged
    assert tails == [False, False, True]
    assert sorted(_flat(batches)) == list(range(64))


def test_valid_mask_rides_device_shuffle_buffer(tmp_path):
    schema = Schema("M", [Field("id", np.int64)])
    url = str(tmp_path / "ds")
    write_dataset(url, schema, [{"id": i} for i in range(72)], row_group_size_rows=8)
    with make_reader(url, shuffle_row_groups=False, reader_pool_type="serial") as reader:
        with CudaDataLoader(reader, 16, device="cpu", device_shuffle_capacity=2,
                            device_shuffle_seed=1, valid_mask_field="mask",
                            drop_last=False) as loader:
            batches = list(loader)
    assert len(batches) == 5  # 4 full + the 8-row padded tail
    tail = batches[-1]
    assert tail[VALID_ROWS] == 8
    assert tail["mask"].tolist() == [1.0] * 8 + [0.0] * 8
    for b in batches[:-1]:
        assert b["mask"].tolist() == [1.0] * 16
    ids = sorted(int(i) for b in batches for i, m in zip(b["id"], b["mask"]) if m == 1.0)
    assert ids == list(range(72))


@pytest.mark.parametrize("kwargs,message", [
    (dict(stack_batches=2), "stack_batches cannot be combined with device_shuffle_capacity"),
    (dict(host_fields=["tag"]), "device_shuffle_capacity cannot be combined with host_fields"),
    (dict(pad_shapes={"vec": [(3,), (6,)]}),
     r"device_shuffle_capacity needs uniform batch shapes, but \['vec'\] use multi-bucket"),
], ids=["stack_batches", "host_fields", "pad_buckets"])
def test_device_shuffle_refusals_carry_the_jax_messages(num_ds, kwargs, message):
    fields = ["idx", "vec"]
    with make_batch_reader(num_ds, reader_pool_type="serial", num_epochs=1) as r:
        with pytest.raises(PetastormTpuError, match=message):
            CudaDataLoader(r, 4, device="cpu", fields=fields, device_shuffle_capacity=2,
                           **kwargs)
    with jax_make_batch_reader(num_ds, reader_pool_type="serial", num_epochs=1) as r:
        with pytest.raises(JaxPetastormTpuError, match=message):
            JaxDataLoader(r, batch_size=4, fields=fields, device_shuffle_capacity=2, **kwargs)


def test_device_buffer_shuffle_quality(ordered_ds):
    """The rank-correlation check of the JAX buffer's quality test, at its
    threshold: the buffer decorrelates read order, not only rows within a
    batch."""
    assert abs(rank_correlation(np.arange(256))) > 0.99  # sequential baseline
    order = _flat(_port_ids(ordered_ds, 8, field="id", device_shuffle_capacity=8,
                            device_shuffle_seed=11)[0])
    assert sorted(order) == list(range(256))
    assert abs(rank_correlation(np.asarray(order))) < 0.5


@pytest.mark.parametrize("pool", ["thread", "serial"])
def test_drain_with_a_warm_device_buffer_is_an_exact_cursor(tmp_path, pool):
    """``drain()`` with resident batches in the device buffer: they drain,
    and ``state_dict()`` resumes to the rest of an uninterrupted epoch's
    rows with its stream digest."""
    url = str(tmp_path / "ds")
    write_dataset(url, Schema("D", [Field("id", np.int64)]), [{"id": i} for i in range(512)],
                  row_group_size_rows=2)
    kwargs = dict(reader_pool_type=pool, shuffle_seed=5, num_epochs=1)
    if pool == "thread":
        kwargs.update(workers_count=4, results_queue_size=4)
    seen = []
    with make_batch_reader(url, **kwargs) as r:
        with CudaDataLoader(r, 8, device="cpu", drop_last=False, device_shuffle_capacity=3,
                            device_shuffle_seed=0) as loader:
            it = iter(loader)
            for _ in range(4):  # past the warm-up: the buffer holds 3 batches
                seen.extend(next(it)["id"].tolist())
            drained = list(loader.drain())
            assert len(drained) >= 3
            for b in drained:
                seen.extend(b["id"][:b.get(VALID_ROWS, 8)].tolist())
            state = loader.state_dict()
    resumed = []
    with make_batch_reader(url, resume_from=state["reader"], **kwargs) as r:
        with CudaDataLoader(r, 8, device="cpu", drop_last=False) as loader:
            for b in loader:
                resumed.extend(b["id"][:b.get(VALID_ROWS, 8)].tolist())
        digest = r.stream_digest
    counts = collections.Counter(seen + resumed)
    assert sorted(counts) == list(range(512)), "rows lost"
    assert max(counts.values()) == 1, "rows re-read: the cursor was not exact"
    assert resumed, "the drain consumed everything; the resume proved nothing"
    with make_batch_reader(url, **kwargs) as r:
        uninterrupted = [v for b in r.iter_batches() for v in b.columns["id"].tolist()]
        assert r.stream_digest == digest
    assert sorted(seen + resumed) == sorted(uninterrupted)
