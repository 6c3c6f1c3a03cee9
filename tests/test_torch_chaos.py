"""The port's chaos injection (``petastorm_tpu_torch/test_util/chaos.py``)
against the JAX package's (``petastorm_tpu/test_util/chaos.py``).

The rolls are CRC32 hashes of the seed, the fault kind and the ordinal, so
the same spec injects the same faults in both packages: every ``should_*``
decision is held equal over 1000 ordinals and several seeds, and
``ChaosSpec.parse`` gives the same spec.  Then ``make_reader(chaos=)`` on
the thread and serial pools: decode failures quarantined under a skip
policy, simulated kills requeued, and transient filesystem failures
absorbed by ``io_retries``, each with the JAX reader's rows and counters.
"""

import dataclasses
import multiprocessing

import numpy as np
import pytest

from petastorm_tpu import reader as jax_reader
from petastorm_tpu.test_util import chaos as jax_chaos

from petastorm_tpu_torch import Field, Schema, pool, reader
from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.etl.writer import write_dataset
from petastorm_tpu_torch.test_util import chaos

SCHEMA = Schema("Chaos", [Field("x", np.int64)])
N_ROWS, RG_ROWS = 40, 4  # 10 rowgroups of 4 rows
ORDINALS = range(1000)
PKG = {"jax": (jax_reader, jax_chaos), "torch": (reader, chaos)}


@pytest.fixture(autouse=True)
def _no_child_left():
    yield
    assert multiprocessing.active_children() == []


def _write(tmp_path):
    url = str(tmp_path / "ds")
    write_dataset(url, SCHEMA, [{"x": i} for i in range(N_ROWS)], row_group_size_rows=RG_ROWS)
    return url


def _specs(mod, seed):
    return [mod.ChaosSpec(seed=seed, decode_fail_rate=0.05, slow_rate=0.1, kill_rate=0.02,
                          hang_rate=0.03),
            mod.ChaosSpec(seed=seed, decode_fail_rate=0.5, slow_ordinals=(3, 9),
                          kill_ordinals=(1,), kill_on_retry=True, hang_ordinals=(7,),
                          hang_on_retry=True),
            mod.ChaosSpec(seed=seed)]


@pytest.mark.parametrize("seed", [0, 1, 7, 12345])
def test_every_decision_equals_jax_over_1000_ordinals(seed):
    for ours, theirs in zip(_specs(chaos, seed), _specs(jax_chaos, seed)):
        for attempt in (0, 1):
            assert ([ours.should_kill(o, attempt) for o in ORDINALS]
                    == [theirs.should_kill(o, attempt) for o in ORDINALS])
            assert ([ours.should_hang(o, attempt) for o in ORDINALS]
                    == [theirs.should_hang(o, attempt) for o in ORDINALS])
        assert ([ours.should_fail_decode(o) for o in ORDINALS]
                == [theirs.should_fail_decode(o) for o in ORDINALS])
        assert [ours.should_slow(o) for o in ORDINALS] == [theirs.should_slow(o) for o in ORDINALS]
        assert ours.affects_worker() == theirs.affects_worker()
        assert ours.affects_filesystem() == theirs.affects_filesystem()
    # a rate that injects: the draws are not all one way
    assert 0 < sum(_specs(chaos, seed)[0].should_fail_decode(o) for o in ORDINALS) < 1000


@pytest.mark.parametrize("text", [
    "decode_fail_rate=0.01,kill_ordinals=3;7,seed=2",
    "hang_ordinals=5,hang_on_retry=true,hang_s=2.5",
    "slow_rate=0.25,slow_s=0.1,kill_on_retry=yes",
    "fail_first_reads=2,fail_first_opens=1,io_latency_s=0.01",
    "",
])
def test_parse_equals_jax(text):
    ours, theirs = chaos.ChaosSpec.parse(text), jax_chaos.ChaosSpec.parse(text)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


@pytest.mark.parametrize("text", ["nokey", "bogus=1"])
def test_parse_refusals_equal_jax(text):
    with pytest.raises(Exception) as want:
        jax_chaos.ChaosSpec.parse(text)
    with pytest.raises(PetastormTpuError) as got:
        chaos.ChaosSpec.parse(text)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("field", ["decode_fail_rate", "slow_rate", "kill_rate", "hang_rate"])
def test_rate_out_of_range_refused_like_jax(field):
    with pytest.raises(Exception) as want:
        jax_chaos.ChaosSpec(**{field: 1.5})
    with pytest.raises(PetastormTpuError) as got:
        chaos.ChaosSpec(**{field: 1.5})
    assert str(got.value) == str(want.value)


def test_ordinal_fields_take_ints_and_lists():
    spec = chaos.ChaosSpec(kill_ordinals=4, hang_ordinals=[1, 2])
    assert spec.kill_ordinals == (4,) and spec.hang_ordinals == (1, 2)


def _read(pkg, url, **kwargs):
    mod, chaos_mod = PKG[pkg]
    spec = chaos_mod.ChaosSpec(**kwargs.pop("chaos"))
    with mod.make_batch_reader(url, shuffle_row_groups=False, chaos=spec, **kwargs) as r:
        rows = [int(x) for b in r.iter_batches() for x in b.columns["x"]]
        diag = r.diagnostics
        quarantine = [(e["ordinal"], e["kind"], e["exc_type"]) for e in r.quarantined_rowgroups]
    return rows, diag, quarantine


@pytest.mark.parametrize("pool_type", ["thread", "serial"])
def test_decode_failures_quarantine_like_jax(tmp_path, pool_type):
    url = _write(tmp_path)
    kwargs = dict(reader_pool_type=pool_type, workers_count=2, on_error="skip",
                  chaos=dict(seed=3, decode_fail_ordinals=(2, 6)))
    rows, diag, quarantine = _read("torch", url, **kwargs)
    want_rows, want_diag, want_quarantine = _read("jax", url, **kwargs)
    assert sorted(rows) == sorted(want_rows)
    assert rows == [x for x in range(N_ROWS) if x // RG_ROWS not in (2, 6)]
    assert quarantine == sorted(want_quarantine) == [(2, "data", "CodecError"),
                                                     (6, "data", "CodecError")]
    assert diag["skipped_rowgroups"] == want_diag["skipped_rowgroups"] == 2


@pytest.mark.parametrize("pool_type", ["thread", "serial"])
def test_simulated_kill_is_requeued_like_jax(tmp_path, pool_type):
    url = _write(tmp_path)
    kwargs = dict(reader_pool_type=pool_type, workers_count=3, chaos=dict(kill_ordinals=(4,)))
    rows, diag, _ = _read("torch", url, **kwargs)
    want_rows, want_diag, _ = _read("jax", url, **kwargs)
    assert rows == list(range(N_ROWS)) and sorted(want_rows) == rows
    assert diag["requeued_items"] == want_diag["requeued_items"] == 1


def test_kill_on_every_attempt_spends_the_budget_like_jax(tmp_path):
    """Every attempt at the item kills its thread: after the budget the read
    fails with an infra WorkerError naming the ordinal, in both packages."""
    url = _write(tmp_path)
    kwargs = dict(reader_pool_type="thread", workers_count=4,
                  chaos=dict(kill_ordinals=(5,), kill_on_retry=True))
    errors = {}
    for pkg in ("jax", "torch"):
        with pytest.raises(Exception) as info:
            _read(pkg, url, **kwargs)
        errors[pkg] = info.value
    assert isinstance(errors["torch"], pool.WorkerError)
    for err in errors.values():
        assert (err.kind, err.ordinal) == ("infra", 5)
        assert "requeue budget exhausted (2 requeue(s) of max 2)" in str(err)


@pytest.mark.parametrize("pool_type", ["thread", "serial"])
def test_filesystem_chaos_is_absorbed_by_io_retries_like_jax(tmp_path, pool_type):
    url = _write(tmp_path)
    kwargs = dict(reader_pool_type=pool_type, workers_count=1,
                  chaos=dict(fail_first_reads=2, fail_first_opens=1, io_latency_s=0.001))
    rows, _, _ = _read("torch", url, **kwargs)
    want_rows, _, _ = _read("jax", url, **kwargs)
    assert rows == list(range(N_ROWS)) and sorted(want_rows) == rows
    spec = chaos.ChaosSpec(fail_first_reads=2, io_latency_s=0.001)
    with reader.make_batch_reader(url, reader_pool_type=pool_type, workers_count=1,
                                  shuffle_row_groups=False, chaos=spec) as r:
        assert [int(x) for b in r.iter_batches() for x in b.columns["x"]] == rows
        stats = r.io_stats()
    # the dataset's open meets both failures: the _common_metadata probe
    # takes one without a retry (as in the JAX package), the footer read the
    # other, retried; the workers read a store that is not local
    assert stats["retries"] == 1 and stats["reads_per_rowgroup"] is not None


def test_chaos_worker_hands_the_inner_function_the_bare_item():
    seen = []

    def factory():
        return lambda item: seen.append(item) or item

    fn = chaos.ChaosWorker(factory, chaos.ChaosSpec(slow_ordinals=(0,), slow_s=0.0))()
    assert fn.takes_ventilated_items
    assert fn(pool.VentilatedItem(0, "payload")) == "payload" and seen == ["payload"]
    with pytest.raises(chaos.SimulatedWorkerCrash):
        chaos.ChaosWorker(factory, chaos.ChaosSpec(kill_ordinals=(3,)))()(
            pool.VentilatedItem(3, "x"))
