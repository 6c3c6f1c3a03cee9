"""The port's liveness layer against the JAX package's, on the CPU.

After ``tests/test_liveness.py``: per-item deadlines (``item_deadline_s``)
abandon a hung thread slot and requeue its item, an item that hangs every
attempt quarantines as a data error under a skip policy, a pool whose every
slot is abandoned raises instead of wedging, a straggler past
``hedge_after_s`` is re-issued and delivered once, and the stall watchdog
(``stall_warn_s``, ``stall_abort_s``) warns and aborts with a
``PipelineStallError`` carrying the diagnostics.  The hangs are chaos
injections (``test_util.chaos``), the same in both packages; every scenario
that waits on a hang has its own bound.
"""

import logging
import multiprocessing
import re
import time

import numpy as np
import pytest

from petastorm_tpu import pool as jax_pool
from petastorm_tpu import reader as jax_reader
from petastorm_tpu.errors import ErrorPolicy as JaxErrorPolicy
from petastorm_tpu.test_util import chaos as jax_chaos

from petastorm_tpu_torch import Field, Schema, pool, reader
from petastorm_tpu_torch.errors import ErrorPolicy, PetastormTpuError
from petastorm_tpu_torch.etl.writer import write_dataset
from petastorm_tpu_torch.test_util import chaos

SCHEMA = Schema("Liveness", [Field("x", np.int64)])
N_ROWS, RG_ROWS = 40, 4  # 10 rowgroups of 4 rows
PKG = {"jax": (jax_reader, jax_chaos, jax_pool, JaxErrorPolicy),
       "torch": (reader, chaos, pool, ErrorPolicy)}
#: a hang lasts this long: past every deadline (0.5 s) and stall abort
#: (1.5 s) here, and short enough that the hung thread ends soon after
HANG_S = 3


@pytest.fixture(autouse=True)
def _no_child_left():
    yield
    assert multiprocessing.active_children() == []


@pytest.fixture
def url(tmp_path):
    path = str(tmp_path / "ds")
    write_dataset(path, SCHEMA, [{"x": i} for i in range(N_ROWS)], row_group_size_rows=RG_ROWS)
    return path


def _rows_without(groups):
    return [x for x in range(N_ROWS) if x // RG_ROWS not in groups]


def _read(pkg, url, spec, bound_s=30, **kwargs):
    """Rows, diagnostics and sorted quarantine of one read, within ``bound_s``."""
    mod, chaos_mod = PKG[pkg][:2]
    t0 = time.monotonic()
    with mod.make_batch_reader(url, shuffle_row_groups=False,
                               chaos=chaos_mod.ChaosSpec(**spec), **kwargs) as r:
        rows = [int(x) for b in r.iter_batches() for x in b.columns["x"]]
        diag = r.diagnostics
        quarantine = sorted(r.quarantined_rowgroups, key=lambda e: e["ordinal"])
    assert time.monotonic() - t0 < bound_s
    return rows, diag, quarantine


def _worker_index_free(entries):
    """Quarantine entries with the worker index and the package name of the
    message read alike: which thread took an item is a matter of timing."""
    def clean(k, v):
        if k != "error":
            return v
        return re.sub(r"worker thread \d+", "worker thread N",
                      v.replace("petastorm_tpu_torch.", "petastorm_tpu."))
    return [{k: clean(k, v) for k, v in e.items()} for e in entries]


# -- arguments -----------------------------------------------------------------


@pytest.mark.parametrize("kind", ["thread", "process", "serial"])
@pytest.mark.parametrize("kwargs", [dict(item_deadline_s=0), dict(item_deadline_s=-1.0),
                                    dict(hedge_after_s="sometimes"), dict(hedge_after_s=-1),
                                    dict(hedge_after_s=0)])
def test_make_executor_rejects_bad_liveness_args_like_jax(kind, kwargs):
    with pytest.raises(Exception) as want:
        jax_pool.make_executor(kind, **kwargs)
    with pytest.raises(PetastormTpuError) as got:
        pool.make_executor(kind, **kwargs)
    assert str(got.value) == str(want.value)


def test_make_executor_takes_good_liveness_args():
    ex = pool.make_executor("thread", item_deadline_s=5.0, hedge_after_s="auto")
    assert ex.diagnostics["hung_workers_killed"] == 0 and ex.diagnostics["hedged_items"] == 0
    # 'auto' needs the recorded decode p99: without telemetry, no hedging
    assert ex._hedge_threshold() is None
    assert pool.make_executor("thread", hedge_after_s=2.5)._hedge_threshold() == 2.5
    # with 20 recorded decodes it is 4x their p99, at least 0.5 s, as in JAX
    from petastorm_tpu import telemetry as jax_telemetry

    from petastorm_tpu_torch import telemetry

    got = []
    for pool_mod, tele_mod, scale in ((jax_pool, jax_telemetry, 0.4), (pool, telemetry, 0.4),
                                      (jax_pool, jax_telemetry, 0.01), (pool, telemetry, 0.01)):
        tele = tele_mod.Telemetry()
        for i in range(20):
            tele.histogram("stage.decode.latency_s").record(scale * (1 + i % 5))
        got.append(pool_mod.make_executor("thread", hedge_after_s="auto",
                                          telemetry=tele)._hedge_threshold())
    assert got[1] == got[0] > 0.5 and got[3] == got[2] == 0.5


@pytest.mark.parametrize("value", ["auto", "1.5", "0.01", "0", "-2", "soon", "nan"])
def test_parse_hedge_after_equals_jax(value):
    try:
        want = jax_pool.parse_hedge_after(value)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            pool.parse_hedge_after(value)
        assert str(got.value) == str(exc)
        return
    got = pool.parse_hedge_after(value)
    assert got == want or (got != got and want != want)  # nan passes through both


def test_serial_executor_accepts_liveness_with_a_warning(caplog):
    with caplog.at_level(logging.WARNING, logger="petastorm_tpu_torch.pool"):
        ex = pool.make_executor("serial", item_deadline_s=1.0, hedge_after_s=0.5)
    assert any("inoperative" in rec.message for rec in caplog.records)
    ex.start(lambda: (lambda item: item * 2))
    assert list(ex.imap(range(3))) == [0, 2, 4]


# -- hangs -----------------------------------------------------------------------


def test_thread_pool_hang_is_abandoned_and_the_epoch_is_exact_like_jax(url):
    spec = dict(hang_ordinals=(3,), hang_s=HANG_S)
    kwargs = dict(reader_pool_type="thread", workers_count=2, item_deadline_s=0.5)
    rows, diag, _ = _read("torch", url, spec, **kwargs)
    want_rows, want_diag, _ = _read("jax", url, spec, **kwargs)
    assert rows == list(range(N_ROWS)) and sorted(want_rows) == rows
    for key in ("hung_workers_abandoned", "requeued_items", "hung_workers_killed"):
        assert diag[key] == want_diag[key], key
    assert diag["hung_workers_abandoned"] == 1 and diag["requeued_items"] == 1


def test_repeatedly_hung_item_quarantines_as_data_like_jax(url):
    spec = dict(hang_ordinals=(3,), hang_on_retry=True, hang_s=HANG_S)
    results = {}
    for pkg in ("jax", "torch"):
        results[pkg] = _read(pkg, url, spec, reader_pool_type="thread", workers_count=3,
                             item_deadline_s=0.5,
                             on_error=PKG[pkg][3](max_requeue_attempts=1))
    rows, diag, quarantine = results["torch"]
    want_rows, want_diag, want_quarantine = results["jax"]
    assert rows == _rows_without({3}) and sorted(want_rows) == rows
    # attempt 0 and its requeue both hung: two slots abandoned
    assert diag["hung_workers_abandoned"] == want_diag["hung_workers_abandoned"] == 2
    assert diag["skipped_rowgroups"] == want_diag["skipped_rowgroups"] == 1
    assert _worker_index_free(quarantine) == _worker_index_free(want_quarantine)
    assert quarantine[0]["ordinal"] == 3 and quarantine[0]["kind"] == "data"


def test_every_thread_slot_abandoned_raises_instead_of_wedging():
    ex = pool.ThreadedExecutor(workers_count=1, results_queue_size=2, item_deadline_s=0.3,
                               max_requeue_attempts=2)
    ex.start(chaos.ChaosWorker(lambda: (lambda item: item),
                               chaos.ChaosSpec(hang_ordinals=(0,), hang_s=HANG_S)))
    t0 = time.monotonic()
    try:
        with pytest.raises(pool.WorkerError, match="abandoned as hung"):
            list(ex.imap(range(2)))
    finally:
        ex.stop()
        ex.join()
    assert time.monotonic() - t0 < 15


# -- hedging ---------------------------------------------------------------------


def test_hedged_straggler_is_delivered_once_like_jax(url):
    spec = dict(hang_ordinals=(4,), hang_s=1.5)
    kwargs = dict(reader_pool_type="thread", workers_count=2, hedge_after_s=0.4)
    rows, diag, _ = _read("torch", url, spec, **kwargs)
    want_rows, want_diag, _ = _read("jax", url, spec, **kwargs)
    assert rows == list(range(N_ROWS)) and sorted(want_rows) == rows
    assert diag["hedged_items"] == want_diag["hedged_items"] == 1
    assert diag["hedge_wins"] == want_diag["hedge_wins"] == 1


def test_a_hedged_items_late_duplicate_is_dropped():
    """Both copies of a hedged item finish; the second is dropped, so every
    item is delivered exactly once and in order.  The slow roll has no
    attempt gate, so the hedge copy is slow too and the original, which
    started first, wins."""
    def items():
        yield from range(5)
        time.sleep(1.5)  # the consumer keeps draining while the slow original lands
        yield 5

    ex = pool.ThreadedExecutor(workers_count=2, results_queue_size=4, hedge_after_s=0.3)
    ex.start(chaos.ChaosWorker(lambda: (lambda item: item),
                               chaos.ChaosSpec(slow_ordinals=(2,), slow_s=1.2)))
    try:
        out = list(ex.imap(items()))
    finally:
        ex.stop()
        ex.join()
    diag = ex.diagnostics
    assert out == list(range(6))
    assert diag["consumed"] == 6 and diag["hedged_items"] == 1 and diag["hedge_wins"] == 0
    assert diag["reorder_held"] == 0


# -- the stall watchdog ----------------------------------------------------------


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_stall_warns_then_aborts_with_the_diagnostics(url, pkg, caplog):
    """No deadline, an item hung on every attempt: ``stall_warn_s`` warns
    naming the stuck ordinal, ``stall_abort_s`` raises PipelineStallError
    carrying the diagnostics, in both packages."""
    mod, chaos_mod, pool_mod, _ = PKG[pkg]
    spec = chaos_mod.ChaosSpec(hang_ordinals=(2,), hang_on_retry=True, hang_s=HANG_S)
    t0 = time.monotonic()
    with caplog.at_level(logging.WARNING):
        with pytest.raises(pool_mod.PipelineStallError) as info:
            with mod.make_batch_reader(url, reader_pool_type="thread", workers_count=2,
                                       shuffle_row_groups=False, chaos=spec,
                                       stall_warn_s=0.3, stall_abort_s=1.5) as r:
                list(r.iter_batches())
    assert time.monotonic() - t0 < 15
    err = info.value
    assert isinstance(err, pool_mod.WorkerError) and err.kind == "infra"
    assert [b[1] for b in err.diagnostics["workers_busy"]] == [2]
    warnings = [rec.getMessage() for rec in caplog.records
                if "produced no batch" in rec.getMessage()]
    assert warnings and "'workers_busy': [(" in warnings[0]


def test_stall_kwargs_override_the_environment_like_jax(url, monkeypatch):
    monkeypatch.setenv("PETASTORM_TPU_STALL_WARN_S", "77")
    monkeypatch.setenv("PETASTORM_TPU_STALL_ABORT_S", "88")
    for mod in (jax_reader, reader):
        with mod.make_batch_reader(url, reader_pool_type="serial") as r:
            assert (r._stall_warn_s, r._stall_abort_s) == (77.0, 88.0)
        with mod.make_batch_reader(url, reader_pool_type="serial", stall_warn_s=5.0,
                                   stall_abort_s=9.0) as r:
            assert (r._stall_warn_s, r._stall_abort_s) == (5.0, 9.0)
        with mod.make_batch_reader(url, reader_pool_type="serial", stall_abort_s=0) as r:
            assert r._stall_abort_s == 0.0
    monkeypatch.delenv("PETASTORM_TPU_STALL_WARN_S")
    monkeypatch.delenv("PETASTORM_TPU_STALL_ABORT_S")
    with reader.make_batch_reader(url) as r:  # the defaults: warn at 120 s, never abort
        assert (r._stall_warn_s, r._stall_abort_s) == (120.0, 0.0)


def test_the_serial_watchdog_takes_stall_warn_s(url, monkeypatch, caplog):
    monkeypatch.setenv("PETASTORM_TPU_STALL_WARN_S", "120")
    with reader.make_batch_reader(url, reader_pool_type="serial", stall_warn_s=7.0) as r:
        assert r._executor._stall_warn_s == 7.0
    assert pool.make_executor("serial", stall_warn_s=3.0)._stall_warn_s == 3.0
    spec = chaos.ChaosSpec(slow_ordinals=(2,), slow_s=1.0)
    with caplog.at_level(logging.WARNING, logger="petastorm_tpu_torch"):
        with reader.make_batch_reader(url, reader_pool_type="serial", shuffle_row_groups=False,
                                      chaos=spec, stall_warn_s=0.2, stall_abort_s=5) as r:
            rows = [int(x) for b in r.iter_batches() for x in b.columns["x"]]
    assert rows == list(range(N_ROWS))
    messages = [rec.getMessage() for rec in caplog.records]
    assert any("stall_abort_s=5 is inoperative" in m for m in messages)
    assert any(m.startswith("Serial executor work item 2 has run for") for m in messages)
