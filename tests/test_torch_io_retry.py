"""Transient remote-IO resilience in the port: ``retry.py``, the worker's
retried rowgroup read and the retried dataset open.

The JAX suite's cases (``tests/test_io_retry.py`` and the circuit-breaker
cases of ``tests/test_liveness.py``) on the port's modules, with the
telemetry case counted by ``Reader.io_stats()``; and the rows and their
order through a flaky or failing filesystem held equal to the JAX reader's.
"""

import numpy as np
import pytest

from petastorm_tpu_torch.errors import CircuitOpenError, PetastormTpuError, classify_error
from petastorm_tpu_torch.etl.metadata import open_dataset
from petastorm_tpu_torch.etl.writer import write_dataset
from petastorm_tpu_torch.reader import make_batch_reader, make_reader
from petastorm_tpu_torch.retry import (CircuitBreaker, RetryPolicy, is_transient,
                                       make_circuit_breaker, resolve_retry_policy, retry_call)
from petastorm_tpu_torch.schema import Field, Schema

fsspec = pytest.importorskip("fsspec")

FAST = RetryPolicy(max_attempts=4, initial_backoff_s=0.01, max_backoff_s=0.02)


# -- retry_call unit behavior -------------------------------------------------

def test_retry_call_retries_transient_then_succeeds():
    calls, slept = [], []
    def fn():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("simulated 503")
        return "ok"
    assert retry_call(fn, FAST, sleep=slept.append) == "ok"
    assert len(calls) == 3 and len(slept) == 2
    assert all(s > 0 for s in slept)


def test_retry_call_exhausts_budget():
    def fn():
        raise TimeoutError("still down")  # OSError subclass
    with pytest.raises(TimeoutError):
        retry_call(fn, FAST, sleep=lambda s: None)


def test_retry_call_does_not_retry_durable_errors():
    calls = []
    def fn():
        calls.append(1)
        raise FileNotFoundError("gone")
    with pytest.raises(FileNotFoundError):
        retry_call(fn, FAST, sleep=lambda s: None)
    assert len(calls) == 1  # no second attempt


def test_retry_call_none_policy_is_passthrough():
    calls = []
    def fn():
        calls.append(1)
        raise OSError("boom")
    with pytest.raises(OSError):
        retry_call(fn, None, sleep=lambda s: None)
    assert len(calls) == 1


def test_resolve_policy_auto_local_off_remote_on(tmp_path):
    import pyarrow.fs as pafs

    assert resolve_retry_policy("auto", pafs.LocalFileSystem()) is None
    remote = pafs.PyFileSystem(pafs.FSSpecHandler(fsspec.filesystem("memory")))
    assert isinstance(resolve_retry_policy("auto", remote), RetryPolicy)
    assert resolve_retry_policy(None, remote) is None
    assert resolve_retry_policy(6, remote).max_attempts == 6
    assert resolve_retry_policy(FAST, remote) is FAST
    with pytest.raises(PetastormTpuError):
        resolve_retry_policy("always", remote)
    with pytest.raises(PetastormTpuError):
        RetryPolicy(max_attempts=0)


# -- end-to-end fault injection over memory:// --------------------------------

SCHEMA = Schema("Flaky", [Field("id", np.int64),
                          Field("x", np.float32, (3,))])
N_ROWS = 32


@pytest.fixture()
def flaky_ds():
    memfs = fsspec.filesystem("memory")
    url = "memory://flaky_ds"
    rng = np.random.default_rng(0)
    # rows_per_file=8 -> 4 separate files, so mid-epoch failures hit fresh
    # open() calls (the worker caches one ParquetFile per file)
    write_dataset(url, SCHEMA,
                  [{"id": i, "x": rng.standard_normal(3).astype(np.float32)}
                   for i in range(N_ROWS)],
                  row_group_size_rows=4, rows_per_file=8)
    orig_open = memfs.open
    state = {"fail_reads": 0, "failed": 0}

    def flaky_open(path, mode="rb", **kw):
        if "r" in mode and state["fail_reads"] > 0:
            state["fail_reads"] -= 1
            state["failed"] += 1
            raise OSError(f"simulated transient 503 opening {path}")
        return orig_open(path, mode, **kw)

    memfs.open = flaky_open
    try:
        yield url, state
    finally:
        memfs.open = orig_open
        memfs.store.clear()


def test_mid_epoch_transient_read_recovers_exactly(flaky_ds):
    """Transient open failures mid-epoch: every row delivered exactly once,
    and the end-of-epoch cursor is exact (no loss, no duplication)."""
    url, state = flaky_ds
    with make_reader(url, reader_pool_type="serial", num_epochs=1,
                     shuffle_row_groups=False, io_retries=FAST) as r:
        it = iter(r)
        first = [next(it).id for _ in range(4)]   # one file's worth, cleanly
        state["fail_reads"] = 3                   # then the weather rolls in
        rest = [row.id for row in it]
        state_dict = r.state_dict()
    assert state["failed"] >= 1                   # injection really fired
    assert sorted(first + rest) == list(range(N_ROWS))
    assert state_dict["ordinal_exact"]


def test_exhausted_retries_surface_the_error(flaky_ds):
    url, state = flaky_ds
    state["fail_reads"] = 10**6                   # outage, not weather
    policy = RetryPolicy(max_attempts=2, initial_backoff_s=0.01,
                         max_backoff_s=0.01)
    with pytest.raises(OSError, match="503"):
        with make_reader(url, reader_pool_type="serial", num_epochs=1,
                         shuffle_row_groups=False, io_retries=policy) as r:
            list(r)


def test_io_retries_disabled_fails_fast(flaky_ds):
    url, state = flaky_ds
    with pytest.raises(OSError, match="503"):
        with make_reader(url, reader_pool_type="serial", num_epochs=1,
                         shuffle_row_groups=False, io_retries=None) as r:
            # inject AFTER construction so the failure hits a worker read,
            # not the metadata open (whose _common_metadata probe degrades
            # gracefully by design)
            state["fail_reads"] = 1
            list(r)
    assert state["fail_reads"] == 0               # exactly one attempt, no retry


def test_metadata_open_retries_injected_open_failures(tmp_path):
    """latency_fs ``fail_first_opens``: the metadata-open path (footer/KV
    reads through ``open_input_file``) really exercises the retry policy -
    not just the per-read path."""
    from petastorm_tpu_torch.test_util.latency_fs import latent_filesystem

    url = str(tmp_path / "ds")
    write_dataset(url, SCHEMA,
                  [{"id": i, "x": np.zeros(3, np.float32)} for i in range(8)],
                  row_group_size_rows=4)
    fs, stats = latent_filesystem(latency_s=0.0, fail_first_opens=2)
    info = open_dataset(url, filesystem=fs, io_retries=FAST)
    assert sum(rg.num_rows for rg in info.row_groups) == 8
    assert stats.failures_injected >= 2


def test_metadata_open_failures_fail_fast_without_retries(tmp_path):
    from petastorm_tpu_torch.test_util.latency_fs import latent_filesystem

    url = str(tmp_path / "ds")
    write_dataset(url, SCHEMA,
                  [{"id": i, "x": np.zeros(3, np.float32)} for i in range(8)],
                  row_group_size_rows=4)
    # >1: the first failure may land on the _common_metadata probe, which
    # degrades gracefully by design; later ones hit required footer opens
    fs, _stats = latent_filesystem(latency_s=0.0, fail_first_opens=4)
    with pytest.raises(OSError, match="injected transient open failure"):
        open_dataset(url, filesystem=fs, io_retries=None)


def test_retries_are_counted_in_io_stats(flaky_ds):
    """The retries the JAX reader counts as ``io.retries`` telemetry are
    counted by the port's ``Reader.io_stats()``, and every row arrives
    once."""
    url, state = flaky_ds
    with make_reader(url, reader_pool_type="serial", num_epochs=1,
                     shuffle_row_groups=False, io_retries=FAST) as r:
        it = iter(r)
        first = [next(it).id for _ in range(4)]
        state["fail_reads"] = 2
        rest = [row.id for row in it]
        stats = r.io_stats()
    assert sorted(first + rest) == list(range(N_ROWS))
    assert stats["retries"] == state["failed"] == 2
    assert stats["rowgroups_read"] == N_ROWS // 4
    # one ranged read a rowgroup through the window
    assert stats["reads_per_rowgroup"] == 1.0


def test_metadata_open_retries_listing_failures():
    memfs = fsspec.filesystem("memory")
    url = "memory://flaky_meta"
    write_dataset(url, SCHEMA,
                  [{"id": i, "x": np.zeros(3, np.float32)} for i in range(8)],
                  row_group_size_rows=4)
    orig_info = memfs.info
    state = {"fail": 2}

    def flaky_info(path, **kw):
        if state["fail"] > 0:
            state["fail"] -= 1
            raise OSError("simulated transient 503 on info")
        return orig_info(path, **kw)

    memfs.info = flaky_info
    try:
        info = open_dataset(url, io_retries=FAST)
        assert sum(rg.num_rows for rg in info.row_groups) == 8
        assert state["fail"] == 0
    finally:
        memfs.info = orig_info
        memfs.store.clear()


# -- the circuit breaker (the cases of tests/test_liveness.py) --------------------

import time  # noqa: E402

_X_SCHEMA = Schema("X", [Field("x", np.int64)])
N_X = 16


class _FakeClock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


def test_circuit_breaker_opens_half_opens_closes():
    clock = _FakeClock()
    b = CircuitBreaker(threshold=3, cooldown_s=10.0, clock=clock)
    assert b.state == "closed"
    for _ in range(2):
        b.before_call()
        assert not b.record_failure()
    b.before_call()
    assert b.record_failure()  # third consecutive failure OPENS
    assert b.state == "open" and b.is_open and b.opens == 1
    with pytest.raises(CircuitOpenError, match="circuit breaker is open"):
        b.before_call("rowgroup read")
    assert b.failfasts == 1
    # cooldown elapses: exactly ONE caller is admitted as the probe,
    # concurrent callers keep failing fast
    clock.now += 10.0
    b.before_call("probe")
    assert b.state == "half-open"
    with pytest.raises(CircuitOpenError, match="probe in flight"):
        b.before_call("concurrent")
    # probe fails -> re-opens and restarts the cooldown
    assert b.record_failure()
    assert b.state == "open" and b.opens == 2
    clock.now += 10.0
    b.before_call("probe2")
    b.record_success()  # probe succeeds -> closed, count reset
    assert b.state == "closed" and not b.is_open
    b.before_call()
    snap = b.snapshot()
    assert snap["state"] == "closed" and snap["opens"] == 2
    # a success anywhere resets the consecutive count
    b.record_failure()
    b.record_success()
    assert b.snapshot()["consecutive_failures"] == 0


def test_circuit_breaker_policy_resolution_and_validation():
    assert make_circuit_breaker(None) is None
    assert make_circuit_breaker(
        RetryPolicy(circuit_threshold=None)) is None
    b = make_circuit_breaker(RetryPolicy(circuit_threshold=5,
                                         circuit_cooldown_s=1.0))
    assert b.threshold == 5 and b.cooldown_s == 1.0
    with pytest.raises(PetastormTpuError):
        RetryPolicy(circuit_threshold=0)
    with pytest.raises(PetastormTpuError):
        RetryPolicy(circuit_cooldown_s=-1)
    # CircuitOpenError is an OSError (classifies 'data', skip-eligible) but
    # must never itself be retried as transient
    err = CircuitOpenError("open")
    assert isinstance(err, OSError)
    assert classify_error(err) == "data"
    assert not is_transient(err)


def test_retry_call_fails_fast_once_circuit_opens():
    """A failure that trips the breaker mid-retry surfaces the outage NOW
    (CircuitOpenError before the next backoff sleep), and later calls fail
    fast without invoking the function at all."""
    breaker = CircuitBreaker(threshold=2, cooldown_s=60.0)
    calls = []

    def flaky():
        calls.append(1)
        raise OSError("injected transient weather")

    with pytest.raises(CircuitOpenError):
        retry_call(flaky, RetryPolicy(max_attempts=5, initial_backoff_s=0.0),
                   what="rowgroup test", sleep=lambda s: None,
                   breaker=breaker)
    # opened after 2 consecutive failures: the remaining 3 attempts of the
    # budget were NOT burned against the down store
    assert len(calls) == 2
    calls.clear()
    with pytest.raises(CircuitOpenError):
        retry_call(flaky, RetryPolicy(max_attempts=5),
                   what="rowgroup test2", sleep=lambda s: None,
                   breaker=breaker)
    assert calls == []  # not even one call while open
    assert breaker.opens == 1


def test_circuit_breaker_under_scripted_latency_fs_weather(tmp_path):
    """Scripted storage weather through the REAL filesystem layer: latent_fs
    fails the first 4 opens; the breaker opens mid-storm (short-cutting the
    retry budget), fails fast without issuing IO, re-opens on failed
    half-open probes, and closes on the first healthy probe."""
    from petastorm_tpu_torch.test_util.latency_fs import latent_filesystem

    victim = tmp_path / "blob.bin"
    victim.write_bytes(b"\x01" * 128)
    fs, stats = latent_filesystem(latency_s=0.0, fail_first_opens=4)
    breaker = CircuitBreaker(threshold=2, cooldown_s=0.05)
    policy = RetryPolicy(max_attempts=3, initial_backoff_s=0.0)

    def read_once():
        with fs.open_input_file(str(victim)) as f:
            return f.read()

    def call():
        return retry_call(read_once, policy, what="blob",
                          sleep=lambda s: None, breaker=breaker)

    # injected failures 1+2 trip the threshold on the second attempt; the
    # third attempt of the budget is NOT burned - CircuitOpenError now
    with pytest.raises(CircuitOpenError):
        call()
    assert breaker.state == "open" and breaker.opens == 1
    assert stats.failures_injected == 2
    with pytest.raises(CircuitOpenError):  # open: fail fast, zero IO issued
        call()
    assert stats.failures_injected == 2
    for expected_opens in (2, 3):  # two failed half-open probes re-open
        time.sleep(0.06)
        with pytest.raises(CircuitOpenError):
            call()
        assert breaker.opens == expected_opens
    assert stats.failures_injected == 4  # the scripted storm is spent
    time.sleep(0.06)  # healthy probe closes the circuit
    assert call() == b"\x01" * 128
    assert breaker.state == "closed"
    assert call() == b"\x01" * 128  # and stays closed


def test_failed_probe_with_non_transient_error_releases_slot():
    """A half-open probe whose call dies with a NON-transient error (expired
    credentials, deleted file) must release the probe slot - otherwise the
    breaker reports 'probe in flight' forever and never recovers."""
    clock = _FakeClock()
    b = CircuitBreaker(threshold=1, cooldown_s=5.0, clock=clock)
    with pytest.raises(CircuitOpenError):
        retry_call(lambda: (_ for _ in ()).throw(OSError("weather")),
                   RetryPolicy(max_attempts=2, initial_backoff_s=0.0),
                   what="t", sleep=lambda s: None, breaker=b)
    clock.now += 5.0

    def durable_failure():
        raise PermissionError("token expired")

    with pytest.raises(PermissionError):  # probe call, non-transient outcome
        retry_call(durable_failure, RetryPolicy(max_attempts=2),
                   what="t", sleep=lambda s: None, breaker=b)
    # the slot was released: a later caller can still probe (and close)
    assert b.state == "half-open"
    retry_call(lambda: "ok", RetryPolicy(), what="t", breaker=b)
    assert b.state == "closed"


# -- executor-level liveness ---------------------------------------------------


def test_reader_diagnostics_include_circuit_breaker(tmp_path):
    """A reader whose io_retries armed a breaker surfaces its state in
    diagnostics (local fs never arms one; a latent 'remote' fs does)."""
    from petastorm_tpu_torch.test_util.latency_fs import latent_filesystem

    url = str(tmp_path / "ds")
    write_dataset(url, _X_SCHEMA, [{"x": i} for i in range(N_X)], row_group_size_rows=4)
    with make_batch_reader(url, reader_pool_type="serial",
                           shuffle_row_groups=False) as r:
        assert r.circuit_breaker is None  # local fs: no retries, no breaker
    fs, _stats = latent_filesystem(latency_s=0.0)
    with make_batch_reader(url, reader_pool_type="serial",
                           shuffle_row_groups=False, filesystem=fs) as r:
        rows = sorted(x for b in r.iter_batches() for x in b.columns["x"])
        assert r.circuit_breaker is not None
        diag = r.diagnostics
    assert rows == list(range(N_X))
    assert diag["circuit_breaker"]["state"] == "closed"
    assert diag["circuit_breaker"]["opens"] == 0


# -- parity with the JAX package ---------------------------------------------------

def _ids(factory, url, **kwargs):
    """Every delivered row's id, in order, through a batch reader."""
    with factory(url, reader_pool_type="serial", num_epochs=1, shuffle_row_groups=True,
                 shuffle_seed=3, **kwargs) as r:
        return [int(i) for b in r.iter_batches() for i in b.columns["x"]]


@pytest.mark.parametrize("fail_reads,fail_opens,latency", [(0, 0, 0.0), (2, 0, 0.0),
                                                           (0, 2, 0.001), (2, 1, 0.002)])
def test_rows_and_order_through_a_failing_filesystem_equal_the_jax_readers(
        tmp_path, fail_reads, fail_opens, latency):
    """Through a latent filesystem failing its first reads and opens (the
    dataset open's and the rowgroup reads' retries), the port delivers the
    JAX reader's rows in the JAX reader's order, and both fakes saw the same
    injected failures."""
    from petastorm_tpu.reader import make_batch_reader as jax_make_batch_reader
    from petastorm_tpu.retry import RetryPolicy as JaxRetryPolicy
    from petastorm_tpu.test_util.latency_fs import latent_filesystem as jax_latent
    from petastorm_tpu_torch.test_util.latency_fs import latent_filesystem

    url = str(tmp_path / "ds")
    write_dataset(url, _X_SCHEMA, [{"x": i} for i in range(N_X)], row_group_size_rows=4,
                  rows_per_file=8)
    fs, stats = latent_filesystem(latency_s=latency, fail_first_reads=fail_reads,
                                  fail_first_opens=fail_opens)
    jfs, jstats = jax_latent(latency_s=latency, fail_first_reads=fail_reads,
                             fail_first_opens=fail_opens)
    policy = dict(max_attempts=4, initial_backoff_s=0.001, max_backoff_s=0.002)
    got = _ids(make_batch_reader, url, filesystem=fs, io_retries=RetryPolicy(**policy))
    want = _ids(jax_make_batch_reader, url, filesystem=jfs,
                io_retries=JaxRetryPolicy(**policy))
    assert got == want and sorted(got) == list(range(N_X))
    assert stats.failures_injected == jstats.failures_injected == fail_reads + fail_opens


def test_an_outage_exhausts_the_budget_in_both_packages(tmp_path):
    """Five failures in a row on the dataset open: io_retries='auto' (four
    attempts) cannot absorb them, and both packages raise the fake's OSError
    (the _common_metadata probe swallows one, then the schema footer read
    meets the other four)."""
    from petastorm_tpu.reader import make_batch_reader as jax_make_batch_reader
    from petastorm_tpu.test_util.latency_fs import latent_filesystem as jax_latent
    from petastorm_tpu_torch.test_util.latency_fs import latent_filesystem

    url = str(tmp_path / "ds")
    write_dataset(url, _X_SCHEMA, [{"x": i} for i in range(N_X)], row_group_size_rows=4)
    for factory, make_fs in ((make_batch_reader, latent_filesystem),
                             (jax_make_batch_reader, jax_latent)):
        fs, stats = make_fs(latency_s=0.0, fail_first_reads=3, fail_first_opens=2)
        with pytest.raises(OSError, match="injected transient"):
            factory(url, filesystem=fs, io_retries="auto", reader_pool_type="serial")
        assert stats.failures_injected == 5


def test_an_always_failing_store_opens_the_circuit(tmp_path):
    """A filesystem whose every read fails: the rowgroup reads open the
    shared breaker and the reader raises CircuitOpenError, as the JAX
    reader does, without spending every worker's whole budget."""
    from petastorm_tpu.errors import CircuitOpenError as JaxCircuitOpenError
    from petastorm_tpu.reader import make_batch_reader as jax_make_batch_reader
    from petastorm_tpu.retry import RetryPolicy as JaxRetryPolicy
    from petastorm_tpu.test_util.latency_fs import latent_filesystem as jax_latent
    from petastorm_tpu_torch.test_util.latency_fs import latent_filesystem

    url = str(tmp_path / "ds")
    write_dataset(url, _X_SCHEMA, [{"x": i} for i in range(N_X)], row_group_size_rows=4)
    policy = dict(max_attempts=5, initial_backoff_s=0.0, circuit_threshold=2,
                  circuit_cooldown_s=60.0)
    for factory, make_fs, err, policy_type in (
            (make_batch_reader, latent_filesystem, CircuitOpenError, RetryPolicy),
            (jax_make_batch_reader, jax_latent, JaxCircuitOpenError, JaxRetryPolicy)):
        fs, stats = make_fs(latency_s=0.0)
        reader = factory(url, filesystem=fs, io_retries=policy_type(**policy),
                         reader_pool_type="serial", workers_count=1)
        fs.handler._fail_reads[0] = 10 ** 6  # the store goes down after the open
        fs.handler._fail_opens[0] = 10 ** 6
        with reader:
            with pytest.raises(err):
                list(reader.iter_batches())
        assert reader.circuit_breaker.opens == 1
        assert stats.failures_injected == policy["circuit_threshold"]
