"""Recovery of the port's ingest service against the JAX package's, on the
CPU: the session journal, a dispatcher restart, orphan results, the hot
standby with epoch fencing, and network chaos on the client link.

After ``tests/test_service_recovery.py``: a journal written by the JAX
``ServiceJournal`` loads in the port's with the same sessions and ordinals,
and the reverse (the files are equal byte for byte for the same records); a
truncated tail and foreign or corrupt records are tolerated as in the JAX
journal; a dispatcher restarted mid-epoch recovers with no item executed
twice; a result that finishes before its client reconnects is buffered and
replayed; the hot standby takes over exactly once and a deposed primary is
refused; ``NetChaosSpec`` schedules equal the JAX package's, and a read
through ``ChaosProxy`` on the client link survives.  Every wait is bounded.
The fleets are the determinism matrix's handles
(``test_util.matrix.recoverable_fleet`` and ``ha_fleet``).
"""

import struct
import threading
import time

import numpy as np
import pytest

from petastorm_tpu.service.journal import ServiceJournal as JaxServiceJournal
from petastorm_tpu.test_util.netchaos import NetChaosSpec as JaxNetChaosSpec

from petastorm_tpu_torch import reader
from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.etl.writer import write_dataset
from petastorm_tpu_torch.retry import RetryPolicy
from petastorm_tpu_torch.schema import Field, Schema
from petastorm_tpu_torch.service.client import ServiceExecutor
from petastorm_tpu_torch.service.dispatcher import Dispatcher
from petastorm_tpu_torch.service.journal import ServiceJournal
from petastorm_tpu_torch.service.protocol import PROTOCOL_VERSION, connect_frames
from petastorm_tpu_torch.service.worker import ServiceWorker
from petastorm_tpu_torch.telemetry import Telemetry
from petastorm_tpu_torch.test_util.chaos import ChaosSpec
from petastorm_tpu_torch.test_util.matrix import ha_fleet, recoverable_fleet
from petastorm_tpu_torch.test_util.netchaos import NetChaosSpec

FAST_RECONNECT = RetryPolicy(max_attempts=6, initial_backoff_s=0.05,
                             backoff_multiplier=1.5, max_backoff_s=0.4)

_EXECUTIONS: dict = {}
_EXECUTIONS_LOCK = threading.Lock()


class CountingSlowFactory:
    """Counts executions per ordinal (in-process fleet workers share this
    interpreter): the double-assignment detector."""

    def __init__(self, sleep_s: float = 0.0, tag: str = "t"):
        self.sleep_s = sleep_s
        self.tag = tag

    def __call__(self):
        sleep_s, tag = self.sleep_s, self.tag

        def fn(vitem):
            with _EXECUTIONS_LOCK:
                _EXECUTIONS.setdefault(tag, []).append(vitem.ordinal)
            if sleep_s:
                time.sleep(sleep_s)
            return ("done", vitem.ordinal)

        fn.takes_ventilated_items = True
        return fn


def _wait_for(cond, timeout=15.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


@pytest.fixture(scope="module")
def int_dataset(tmp_path_factory):
    url = str(tmp_path_factory.mktemp("rec") / "ds")
    write_dataset(url, Schema("RecInts", [Field("x", np.int64)]),
                  [{"x": i} for i in range(200)], row_group_size_rows=10)
    return url


def _consume(ex, items):
    """Run ``ex.imap(items)`` on a thread; returns (thread, outputs dict)."""
    out = {}

    def run():
        try:
            out["got"] = list(ex.imap(items))
        except BaseException as exc:  # noqa: BLE001 - inspected by the test
            out["err"] = exc

    t = threading.Thread(target=run)
    t.start()
    return t, out


# -- the journal -----------------------------------------------------------------------------

def _write_journal(cls, path):
    j = cls(path)
    j.open()
    j.set_epoch(3)
    j.append_hello("c1", {"factory": b"fac", "hostname": "h", "shm_ok": False,
                          "max_requeue": 2, "codecs": ["zlib"], "weight": 2.0, "priority": 1})
    for o in range(5):
        j.append_enqueue("c1", {"o": o, "a": 0, "blob": f"item{o}".encode(),
                                "rg": ["/d/p.parquet", o]})
    j.append_hello("c2", {"factory": b"fac2", "hostname": "h2", "shm_ok": True,
                          "max_requeue": 0, "codecs": []})
    j.append_enqueue("c2", {"o": 0, "a": 1, "blob": b"x"})
    j.append_ack("c1", [0, 2])
    j.append_purge("c2")
    j.close()


def _sessions(cls, path):
    j = cls(path)
    sessions = j.load()
    return j.epoch, {cid: (dict(s.hello), {o: dict(i) for o, i in s.items.items()})
                     for cid, s in sessions.items()}


@pytest.mark.parametrize("writer,loader", [("jax", "torch"), ("torch", "jax")])
def test_a_journal_loads_in_the_other_package(tmp_path, writer, loader):
    classes = {"jax": JaxServiceJournal, "torch": ServiceJournal}
    path = str(tmp_path / "svc.journal")
    _write_journal(classes[writer], path)
    epoch, sessions = _sessions(classes[loader], path)
    assert (epoch, sessions) == _sessions(classes[writer], path)
    assert epoch == 3 and list(sessions) == ["c1"]
    assert sorted(sessions["c1"][1]) == [1, 3, 4]
    assert sessions["c1"][0]["weight"] == 2.0


def test_journal_records_are_the_jax_bytes(tmp_path):
    paths = [str(tmp_path / "jax.journal"), str(tmp_path / "torch.journal")]
    _write_journal(JaxServiceJournal, paths[0])
    _write_journal(ServiceJournal, paths[1])
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("tail", [struct.pack("!I", 500) + b"torn",
                                  struct.pack("!I", 1 << 30) + b"junk",
                                  struct.pack("!I", 5) + b"\xff\xfe\xfd\xfc\xfb", b"\x00\x00"])
def test_a_truncated_or_corrupt_tail_is_tolerated_as_in_jax(tmp_path, tail):
    out = []
    for cls in (JaxServiceJournal, ServiceJournal):
        path = str(tmp_path / f"{cls.__module__}.journal")
        _write_journal(cls, path)
        with open(path, "ab") as fh:
            fh.write(tail)
        out.append(_sessions(cls, path))
        # the journal stays appendable after the damaged load
        j = cls(path)
        j.load()
        j.open()
        j.append_ack("c1", [1])
        j.close()
        assert sorted(cls(path).load()["c1"].items) == [3, 4]
    assert out[0] == out[1] and sorted(out[1][1]["c1"][1]) == [1, 3, 4]


def test_foreign_records_apply_as_no_ops_as_in_jax(tmp_path):
    out = []
    for cls in (JaxServiceJournal, ServiceJournal):
        path = str(tmp_path / f"{cls.__module__}.journal")
        j = cls(path)
        j.open()
        j.append_hello("c1", {"factory": b"fac", "hostname": "h", "shm_ok": False,
                              "max_requeue": 2, "codecs": []})
        j.append_enqueue("c1", {"o": 0, "a": 0, "blob": b"item0"})
        j.ingest({"r": "v99-frobnicate", "client": "c1", "payload": b"x"})
        j.ingest({"r": "enq", "client": "c1", "item": {"o": "NaN"}})
        j.ingest({"r": "hello", "client": 7})
        j.ingest({"r": "epoch", "epoch": "seven"})
        j.append_enqueue("c1", {"o": 1, "a": 0, "blob": b"item1"})
        j.close()
        out.append(_sessions(cls, path))
    assert out[0] == out[1]
    assert out[1][0] == 0 and sorted(out[1][1]["c1"][1]) == [0, 1]


# -- dispatcher restart ----------------------------------------------------------------------

def test_a_dispatcher_restart_mid_epoch_recovers(int_dataset):
    with recoverable_fleet() as f:
        tele = Telemetry()
        # the items after the restart (rows 40 on) are held back half a second
        # each, so it lands mid-stream: results are still owed, and only a
        # reconnect to the new dispatcher brings them
        held = ChaosSpec(slow_ordinals=tuple(range(4, 20)), slow_s=0.5)
        r = reader.make_batch_reader(int_dataset, service_address=f.address, shuffle_seed=2,
                                     telemetry=tele, chaos=held)
        r._executor._reconnect_policy = FAST_RECONNECT  # noqa: SLF001
        rows, restarted = [], False
        try:
            for b in r.iter_batches():
                rows += [int(x) for x in b.columns["x"]]
                if not restarted and len(rows) >= 40:
                    restarted = True
                    f.restart_dispatcher()
            diag = r.diagnostics
        finally:
            r.stop()
            r.join()
        with reader.make_batch_reader(int_dataset, shuffle_seed=2) as local:
            expect = [int(x) for b in local.iter_batches() for x in b.columns["x"]]
        assert rows == expect  # exactly once, in plan order
        assert diag["dispatcher_restarts"] == 1 and diag["reconnects"] >= 1
        assert tele.snapshot()["counters"]["service.dispatcher_restarts"] == 1
        dc = f.dispatcher.stats()["counters"]
        assert dc.get("service.sessions_reconstructed", 0) >= 1, dc
        assert dc.get("service.worker_rejoins", 0) >= 1, dc


def test_no_item_executes_twice_through_a_restart():
    tag = "restart-exactly-once"
    _EXECUTIONS.pop(tag, None)
    with recoverable_fleet(n_workers=1, capacity=2, worker_reconnect_backoff_s=0.1) as f:
        ex = ServiceExecutor(f.address, telemetry=Telemetry(), window=8,
                             reconnect_policy=FAST_RECONNECT)
        try:
            ex.start(CountingSlowFactory(sleep_s=1.2, tag=tag))
            t, out = _consume(ex, [f"p{i}" for i in range(6)])
            time.sleep(0.2)  # the worker is executing the first wave
            f.restart_dispatcher()
            t.join(timeout=30)
            assert out.get("got") == [("done", i) for i in range(6)], out
            assert sorted(_EXECUTIONS.get(tag, [])) == list(range(6))
            dc = f.dispatcher.stats()["counters"]
            assert dc.get("service.recovered_assignments", 0) >= 1, dc
        finally:
            ex.stop()
            ex.join()


def test_an_orphan_result_is_buffered_until_its_client_reconnects():
    tag = "orphan"
    _EXECUTIONS.pop(tag, None)
    slow_client = RetryPolicy(max_attempts=4, initial_backoff_s=2.0,
                              backoff_multiplier=1.0, max_backoff_s=2.0)
    with recoverable_fleet(n_workers=1, capacity=1, worker_reconnect_backoff_s=0.1) as f:
        ex = ServiceExecutor(f.address, telemetry=Telemetry(), window=2,
                             reconnect_policy=slow_client)
        try:
            ex.start(CountingSlowFactory(sleep_s=1.2, tag=tag))
            t, out = _consume(ex, ["slow"])
            time.sleep(0.3)  # executing now
            f.restart_dispatcher(downtime_s=0.05)
            t.join(timeout=30)
            assert out.get("got") == [("done", 0)], out
            assert _EXECUTIONS.get(tag) == [0]
            dc = f.dispatcher.stats()["counters"]
            assert dc.get("service.orphan_results_buffered", 0) >= 1, dc
        finally:
            ex.stop()
            ex.join()


def test_a_journal_warm_restart_skips_resends(tmp_path, caplog):
    import logging

    journal = str(tmp_path / "svc.journal")
    tag = "journal"
    _EXECUTIONS.pop(tag, None)
    with recoverable_fleet(n_workers=1, capacity=1, worker_reconnect_backoff_s=0.1,
                           dispatcher_kwargs={"journal_path": journal}) as f:
        ex = ServiceExecutor(f.address, telemetry=Telemetry(), window=8,
                             reconnect_policy=FAST_RECONNECT)
        try:
            ex.start(CountingSlowFactory(sleep_s=0.3, tag=tag))
            with caplog.at_level(logging.INFO, logger="petastorm_tpu_torch.service.client"):
                t, out = _consume(ex, [f"p{i}" for i in range(6)])
                time.sleep(0.15)  # journaled, some assigned
                f.restart_dispatcher(downtime_s=0.0)
                t.join(timeout=30)
            assert out.get("got") == [("done", i) for i in range(6)], out
            assert f.dispatcher.telemetry.snapshot()["counters"].get(
                "service.journal_items_restored", 0) >= 1
            assert any("resync skipped" in r.getMessage() for r in caplog.records)
            assert sorted(_EXECUTIONS.get(tag, [])) == list(range(6))
        finally:
            ex.stop()
            ex.join()


# -- the hot standby -------------------------------------------------------------------------

def test_the_hot_standby_takes_over_exactly_once():
    tag = "ha-warm"
    _EXECUTIONS.pop(tag, None)
    patient = RetryPolicy(max_attempts=20, initial_backoff_s=0.1, backoff_multiplier=1.5,
                          max_backoff_s=0.5)
    # ha_fleet yields once its worker is on the primary and the standby synced
    with ha_fleet(n_workers=1, capacity=2) as ha:
        primary, standby = ha.primary, ha.standby
        ex = ServiceExecutor(ha.address, telemetry=Telemetry(), window=8,
                             reconnect_policy=patient)
        try:
            assert len(primary.stats()["workers"]) == 1
            assert standby.stats()["standby"]["primary_epoch"] >= 1
            # a standby refuses work hellos until it promotes
            probe = connect_frames(("127.0.0.1", standby.port))
            probe.send({"t": "worker_hello", "protocol": PROTOCOL_VERSION, "token": None,
                        "capacity": 1, "resume": False, "assignments": [], "jobs": []})
            refusal = probe.recv(timeout=5.0)
            probe.close()
            assert refusal["t"] == "error" and "standby" in refusal["error"]
            ex.start(CountingSlowFactory(sleep_s=0.3, tag=tag))
            t, out = _consume(ex, [f"p{i}" for i in range(6)])
            _wait_for(lambda: standby.stats()["standby"]["synced_records"] >= 8
                      and standby.stats()["standby"]["lag_items"] == 0,
                      what="standby caught up before the kill")
            ha.failover(timeout_s=20.0)  # the primary dies; the standby promotes
            assert standby.standby_promoted.is_set() and ha.dispatcher is standby
            t.join(timeout=30)
            assert out.get("got") == [("done", i) for i in range(6)], out
            stats = standby.stats()
            assert stats["counters"].get("service.failovers", 0) == 1
            assert stats["counters"].get("service.journal_items_restored", 0) >= 1
            assert stats["epoch"] >= 2
            assert sorted(_EXECUTIONS.get(tag, [])) == list(range(6))
        finally:
            ex.stop()
            ex.join()


def test_epoch_fencing_refuses_a_deposed_primary(tmp_path):
    stamped = str(tmp_path / "stamped.journal")
    j = ServiceJournal(stamped)
    j.open()
    j.set_epoch(5)
    j.close()
    d_new = Dispatcher(telemetry=Telemetry(), heartbeat_timeout_s=5.0,
                       journal_path=stamped).start()
    d_old = Dispatcher(telemetry=Telemetry(), heartbeat_timeout_s=5.0).start()
    ex = None
    try:
        assert (d_new.stats()["epoch"], d_old.stats()["epoch"]) == (5, 1)
        worker = ServiceWorker(f"127.0.0.1:{d_new.port}", capacity=1)
        conn = connect_frames(("127.0.0.1", d_new.port))
        worker._register(conn)  # noqa: SLF001
        conn.close()
        conn = connect_frames(("127.0.0.1", d_old.port))
        try:
            with pytest.raises(PetastormTpuError, match="stale epoch"):
                worker._register(conn)  # noqa: SLF001
        finally:
            conn.close()
        assert worker.telemetry.snapshot()["counters"]["service.stale_epoch_refusals"] == 1
        ctele = Telemetry()
        ex = ServiceExecutor(f"127.0.0.1:{d_new.port},127.0.0.1:{d_old.port}",
                             telemetry=ctele, window=4, reconnect_policy=FAST_RECONNECT)
        ex.start(CountingSlowFactory(tag="fence"))
        assert ex.diagnostics["dispatcher_epoch"] == 5
        d_new.stop()
        d_new.join()
        t, out = _consume(ex, ["x"])
        t.join(timeout=30)
        assert isinstance(out.get("err"), PetastormTpuError), out
        assert "epoch cannot complete" in str(out["err"])
        assert ctele.snapshot()["counters"].get("service.stale_epoch_refusals", 0) >= 1
    finally:
        if ex is not None:
            ex.stop()
            ex.join()
        for d in (d_old, d_new):
            d.stop()
            d.join()


# -- network chaos ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("direction", ["both", "c2s", "s2c"])
def test_netchaos_schedules_equal_the_jax_package(seed, direction):
    kwargs = dict(seed=seed, dup_rate=0.2, delay_rate=0.25, drop_rate=0.05,
                  cut_rate=0.02, cut_frames=(7, 40), direction=direction)
    spec, jax_spec = NetChaosSpec(**kwargs), JaxNetChaosSpec(**kwargs)
    for way in ("c2s", "s2c"):
        assert ([spec.decide(way, i) for i in range(512)]
                == [jax_spec.decide(way, i) for i in range(512)])


@pytest.mark.parametrize("bad", [dict(direction="up"), dict(dup_rate=1.5),
                                 dict(delay_rate=-0.1), dict(cut_frames=5)])
def test_netchaos_validation_as_in_jax(bad):
    outs = []
    for cls in (JaxNetChaosSpec, NetChaosSpec):
        try:
            outs.append(("ok", cls(**bad).cut_frames))
        except Exception as exc:  # noqa: BLE001 - the outcome under test
            outs.append((type(exc).__name__, str(exc)))
    assert outs[0] == outs[1]


def test_a_read_through_chaos_on_the_client_link_survives(int_dataset):
    spec = NetChaosSpec(seed=11, dup_rate=0.1, delay_rate=0.15, delay_s=0.01,
                        cut_frames=(12,))
    # the fleet's chaos proxy sits on the client link: f.address dials it
    with recoverable_fleet(net_spec=spec) as f:
        assert f.address == f.proxy.address
        tele = Telemetry()
        r = reader.make_batch_reader(int_dataset, service_address=f.address,
                                     shuffle_seed=5, telemetry=tele)
        r._executor._reconnect_policy = FAST_RECONNECT  # noqa: SLF001
        try:
            rows = [int(x) for b in r.iter_batches() for x in b.columns["x"]]
        finally:
            r.stop()
            r.join()
        with reader.make_batch_reader(int_dataset, shuffle_seed=5) as local:
            assert rows == [int(x) for b in local.iter_batches() for x in b.columns["x"]]
        stats = f.proxy.stats
        assert stats["dups"] >= 1 and stats["cuts"] >= 1, stats
        assert tele.snapshot()["counters"]["service.reconnects"] >= 1
