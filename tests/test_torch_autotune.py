"""The port's autotune controller and its knobs against the JAX package's,
on the CPU.

``AutotunePolicy`` validation and ``resolve_autotune`` give the JAX results
and error text.  One scripted sampler series and one fake clock drive a
controller of each package to the same decision log (knob, action, from,
to, reason and outcome) through kept moves, a revert, a blocked direction,
the consumer-bound branch and exploration.  ``resize_workers`` grows and
shrinks both pools mid-read without losing or repeating a row, and the
stream digest is unchanged; ``set_prefetch`` resizes a live
``CudaDataLoader``.
"""

import logging
import multiprocessing

import numpy as np
import pytest

from petastorm_tpu import autotune as jax_autotune
from petastorm_tpu import pool as jax_pool
from petastorm_tpu import telemetry as jax_telemetry

from petastorm_tpu_torch import Field, Schema, autotune, pool, reader, telemetry
from petastorm_tpu_torch.cuda.loader import CudaDataLoader
from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.etl.writer import write_dataset
from petastorm_tpu_torch.test_util.chaos import ChaosSpec

PKG = {"jax": (jax_autotune, jax_pool, jax_telemetry),
       "torch": (autotune, pool, telemetry)}


@pytest.fixture(autouse=True)
def _no_child_left():
    yield
    assert multiprocessing.active_children() == []


# -- policy and resolution ----------------------------------------------------------


@pytest.mark.parametrize("kwargs", [
    dict(min_workers=0), dict(min_workers=4, max_workers=2), dict(min_results_queue=0),
    dict(min_prefetch=3, max_prefetch=2), dict(tick_s=-1), dict(settle_s=-0.5),
    dict(eval_points=0), dict(revert_threshold=0.0), dict(revert_threshold=1.0),
    dict(cooldown_s=-1.0), dict(warmup_s=-2)])
def test_policy_validation_equals_jax(kwargs):
    with pytest.raises(Exception) as want:
        jax_autotune.AutotunePolicy(**kwargs)
    with pytest.raises(PetastormTpuError) as got:
        autotune.AutotunePolicy(**kwargs)
    assert str(got.value) == str(want.value)


def test_policy_defaults_and_exclusions_equal_jax():
    want, got = jax_autotune.AutotunePolicy(), autotune.AutotunePolicy()
    assert {k: v for k, v in vars(got).items()} == {k: v for k, v in vars(want).items()}
    assert autotune.AutotunePolicy(exclude_knobs=["workers"]).exclude_knobs == \
        frozenset({"workers"})
    assert autotune.THROUGHPUT_COUNTER == jax_autotune.THROUGHPUT_COUNTER


@pytest.mark.parametrize("value,workers,pool_type", [
    (None, 4, "thread"), (None, "auto", "thread"), (True, 4, "process"),
    (False, "auto", "thread"), ("policy", 4, "thread"), (None, "auto", "serial"),
    (True, 4, "dummy")])
def test_resolve_autotune_equals_jax(value, workers, pool_type, caplog):
    results = []
    for mod in (jax_autotune, autotune):
        arg = mod.AutotunePolicy(max_workers=3) if value == "policy" else value
        with caplog.at_level(logging.WARNING):
            policy = mod.resolve_autotune(arg, workers, pool_type)
        results.append(None if policy is None else vars(policy))
    assert results[1] == results[0]
    if pool_type in ("serial", "dummy") and value is not False:
        assert "inoperative with reader_pool_type='serial'" in caplog.text


def test_resolve_autotune_error_text_equals_jax():
    with pytest.raises(Exception) as want:
        jax_autotune.resolve_autotune("yes", 4, "thread")
    with pytest.raises(PetastormTpuError) as got:
        autotune.resolve_autotune("yes", 4, "thread")
    assert str(got.value) == str(want.value)


# -- one scripted series, one clock --------------------------------------------------


class FakeSampler:
    def __init__(self):
        self.points = []

    def series(self):
        return list(self.points)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class FakeLoader:
    def __init__(self):
        self.prefetch = 2

    def set_prefetch(self, depth):
        self.prefetch = depth
        return depth


def _point(rate, starved=0.0, blocked=0.0):
    return {"dt_s": 1.0, "rates": {"reader.rows_emitted": rate,
                                   "queue.results_empty_wait_s": starved,
                                   "queue.results_full_wait_s": blocked},
            "gauges": {}, "counters": {}, "stages": {}}


#: (points before the step, clock advance before the step): a grow that is
#: kept, a grow that regresses and reverts, the blocked direction falling
#: through to the next knob, consumer-bound moves, exploration, and a
#: pass with every candidate blocked
SCRIPT = ([([_point(100, starved=0.9)] * 2, 0.0), ([], 1.01), ([_point(150)] * 2, 0.0),
           ([_point(150, starved=0.9)] * 2, 0.0), ([], 1.01), ([_point(60)] * 2, 0.0),
           ([_point(100, starved=0.9)] * 2, 10.0), ([], 1.01), ([_point(90)] * 2, 0.0),
           ([_point(100, starved=0.9)] * 2, 10.0), ([], 1.01), ([_point(40)] * 2, 0.0),
           ([_point(100, blocked=0.8)] * 2, 10.0), ([], 1.01), ([_point(101)] * 2, 0.0),
           ([_point(100, blocked=0.8)] * 2, 10.0), ([], 1.01), ([_point(50)] * 2, 0.0),
           ([_point(100)] * 2, 10.0), ([], 1.01), ([_point(100)] * 2, 0.0),
           ([_point(100)] * 2, 10.0), ([], 1.01), ([_point(10)] * 2, 0.0),
           ([_point(100, starved=0.9)] * 2, 10.0), ([], 1.01), ([_point(100)] * 2, 0.0)]
          + [([_point(100, starved=0.9)] * 2, 10.0)] * 6)


def _decisions(pkg):
    auto_mod, pool_mod, tele_mod = PKG[pkg]
    tele = tele_mod.Telemetry()
    sampler, clock = FakeSampler(), FakeClock()
    ex = pool_mod.ThreadedExecutor(workers_count=2, results_queue_size=8)  # not started
    policy = auto_mod.AutotunePolicy(max_workers=4, max_results_queue=32, max_prefetch=4,
                                     settle_s=1.0, eval_points=2, cooldown_s=0.0,
                                     block_rounds=2)
    ctl = auto_mod.AutotuneController(ex, sampler, tele, policy=policy, clock=clock)
    ctl.attach_loader(FakeLoader())
    split = {"v": 1}
    ctl.attach_decode_split(get=lambda: split["v"],
                            set_=lambda v: split.__setitem__("v", v) or v)
    mem = {"mb": 64}
    ctl.attach_cache_memory(get=lambda: mem["mb"],
                            set_=lambda n: mem.__setitem__("mb", n) or n, lo_mb=16, hi_mb=256)
    for points, advance in SCRIPT:
        sampler.points.extend(points)
        clock.t += advance
        ctl.step()
    log = [{k: e[k] for k in ("knob", "action", "from", "to", "reason", "outcome")}
           for e in ctl.decisions]
    diag = ctl.diagnostics
    return log, {k: diag[k] for k in ("knobs", "bounds", "moves_applied", "moves_kept",
                                      "moves_reverted")}, tele.snapshot()


def test_scripted_series_gives_the_jax_decision_log():
    want_log, want_diag, want_snap = _decisions("jax")
    got_log, got_diag, got_snap = _decisions("torch")
    assert got_log == want_log
    assert got_diag == want_diag
    outcomes = [e["outcome"] for e in got_log]
    assert "kept" in outcomes and "reverted" in outcomes
    assert {e["action"] for e in got_log} == {"grow", "shrink"}
    # a reverted (knob, direction) is blocked: the next starved move takes
    # another knob
    first_revert = outcomes.index("reverted")
    assert got_log[first_revert + 1]["knob"] != got_log[first_revert]["knob"]
    for kind in ("counters", "gauges"):
        autotune_series = {k: v for k, v in want_snap[kind].items()
                           if k.startswith("autotune.")}
        assert {k: got_snap[kind][k] for k in autotune_series} == autotune_series


def test_controller_knob_guards_equal_jax():
    for workers, results in ((20, 8), (2, 500)):
        knobs = []
        for pkg in ("jax", "torch"):
            auto_mod, pool_mod, tele_mod = PKG[pkg]
            ex = pool_mod.ThreadedExecutor(workers_count=workers, results_queue_size=results)
            ctl = auto_mod.AutotuneController(ex, FakeSampler(), tele_mod.Telemetry(),
                                              policy=auto_mod.AutotunePolicy(max_workers=16))
            loader = FakeLoader()
            loader.prefetch = 40
            ctl.attach_loader(loader)
            knobs.append(ctl.knobs())
        assert knobs[1] == knobs[0]


# -- the pools' resize ------------------------------------------------------------------


@pytest.fixture(scope="module")
def url(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("autotune") / "ds")
    write_dataset(path, Schema("S", [Field("x", np.int64)]), [{"x": i} for i in range(240)],
                  row_group_size_rows=4)
    return path


def _read(url, resize=(), **kwargs):
    with reader.make_batch_reader(url, shuffle_seed=2, **kwargs) as r:
        rows = []
        for i, b in enumerate(r.iter_batches()):
            rows.extend(int(v) for v in b.columns["x"])
            for at, n in resize:
                if i == at:
                    assert r._executor.resize_workers(n) == n  # noqa: SLF001
        return rows, r.stream_digest, r.state_dict(), r.diagnostics


def test_thread_pool_resize_keeps_every_row_once_and_the_digest(url):
    want = _read(url, reader_pool_type="thread", workers_count=2)
    got = _read(url, resize=((3, 6), (20, 1), (40, 3)), reader_pool_type="thread",
                workers_count=2, chaos=ChaosSpec(kill_ordinals=(25,)))
    assert got[0] == want[0] and sorted(got[0]) == list(range(240))
    assert got[1] == want[1]
    assert got[2]["position"] == want[2]["position"] == 60
    assert got[3]["workers_count"] == 3 and got[3]["requeued_items"] == 1


def test_thread_pool_heals_to_target_after_a_death(url):
    with reader.make_batch_reader(url, shuffle_seed=2, reader_pool_type="thread",
                                  workers_count=2,
                                  chaos=ChaosSpec(kill_ordinals=(2, 3, 4))) as r:
        r._executor.resize_workers(2)  # noqa: SLF001 - the count is now a target
        rows = [int(v) for b in r.iter_batches() for v in b.columns["x"]]
        alive = len(r._executor._active_slots())  # noqa: SLF001
    assert sorted(rows) == list(range(240))
    assert alive == 2


def test_process_pool_resize_keeps_every_row_once_and_the_digest(url):
    want = _read(url, reader_pool_type="thread", workers_count=2)
    policy = autotune.AutotunePolicy(max_workers=4, warmup_s=1e6)
    got = _read(url, resize=((2, 4), (12, 1), (30, 2)), reader_pool_type="process",
                workers_count=2, autotune=policy)
    assert got[0] == want[0] and got[1] == want[1]
    assert got[3]["workers_count"] == 2
    ex = pool.ProcessExecutor(workers_count=2, max_workers=3)
    assert ex.max_resize_workers == 3 and ex.resize_workers(10) == 3


def test_results_bound_resize_live(url):
    with reader.make_batch_reader(url, shuffle_seed=2, workers_count=2,
                                  results_queue_size=4) as r:
        ex = r._executor  # noqa: SLF001
        assert ex._out_slots.bound == 4  # noqa: SLF001
        rows = []
        for i, b in enumerate(r.iter_batches()):
            rows.extend(int(v) for v in b.columns["x"])
            if i == 5:
                assert ex.set_results_bound(32) == 32
            if i == 30:
                assert ex.set_results_bound(0) == 1
        assert r.diagnostics["results_queue_bound"] == 1
    assert sorted(rows) == list(range(240))


# -- the loader's prefetch knob ----------------------------------------------------------


def test_set_prefetch_on_a_live_loader(url):
    with reader.make_batch_reader(url, shuffle_seed=2, workers_count=2) as r:
        loader = CudaDataLoader(r, 8, device="cpu", prefetch=1)
        rows = []
        with loader:
            for i, b in enumerate(loader):
                rows.extend(int(v) for v in b["x"])
                if i == 2:
                    assert loader.set_prefetch(4) == 4
                    assert loader.prefetch == 4
                if i == 20:
                    assert loader.set_prefetch(0) == 1
            assert loader.diagnostics()["prefetch_capacity"] == 1
    assert sorted(rows) == list(range(240))


def test_an_autotuned_reader_arms_the_controller_and_the_loader_attaches(url):
    policy = autotune.AutotunePolicy(warmup_s=1e6)
    with reader.make_batch_reader(url, shuffle_seed=2, workers_count="auto",
                                  autotune=policy) as r:
        assert r.telemetry.enabled and r.sampler is not None
        assert set(r.autotune.knobs()) == {"workers", "results_queue"}
        with CudaDataLoader(r, 8, device="cpu") as loader:
            assert r.autotune.knobs()["prefetch"] == loader.prefetch
            assert sum(1 for _ in loader) == 30
        diag = r.diagnostics
    assert diag["autotune"]["moves_applied"] == 0
    assert diag["planner"]["knobs"]["workers"]["source"] in ("metadata", "default", "profile")
    assert "autotune.workers" in diag["telemetry"]["gauges"]
    with reader.make_batch_reader(url, workers_count="auto", autotune=False) as r:
        assert r.autotune is None and r.planner is None


def test_workers_auto_arms_autotune_and_serial_refuses_it(url, caplog):
    with reader.make_batch_reader(url, workers_count="auto") as r:
        assert r.autotune is not None and r.planner is not None
    with caplog.at_level(logging.WARNING):
        with reader.make_batch_reader(url, workers_count="auto",
                                      reader_pool_type="serial") as r:
            assert r.autotune is None
    assert "inoperative with reader_pool_type='serial'" in caplog.text
