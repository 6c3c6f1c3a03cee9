"""Fleet sizing and multi-tenant QoS of the port's ingest service against the
JAX package's, on the CPU.

After ``tests/test_service_autoscale.py``: ``compute_recommendation``,
``Dispatcher.scaling_signal`` (its window, its threshold and its purged
clients) and the ``AutoscaleSupervisor``'s decisions under scripted probes
equal the JAX package's on the same inputs; weighted shares, strict
priority tiers, admission control and the per-client in-flight cap give the
JAX dispatcher's assignment sequence (or refusal) for the same enqueue
script; and a graceful retire finishes the retiring worker's in-flight
items.  Every wait is bounded.
"""

import itertools
import threading
import time
import types

import pytest

from petastorm_tpu.service import autoscale as jax_autoscale
from petastorm_tpu.service import client as jax_client
from petastorm_tpu.service import dispatcher as jax_dispatcher
from petastorm_tpu.service import worker as jax_worker
from petastorm_tpu.pool import VentilatedItem as JaxVentilatedItem
from petastorm_tpu.telemetry import Telemetry as JaxTelemetry

from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.service import autoscale, client, dispatcher, worker
from petastorm_tpu_torch.telemetry import Telemetry

PKGS = {"jax": types.SimpleNamespace(autoscale=jax_autoscale, client=jax_client,
                                     dispatcher=jax_dispatcher, worker=jax_worker,
                                     Telemetry=JaxTelemetry),
        "torch": types.SimpleNamespace(autoscale=autoscale, client=client,
                                       dispatcher=dispatcher, worker=worker,
                                       Telemetry=Telemetry)}

#: serve order observed at the worker, per package (in-process workers
#: share this interpreter)
SERVED = {"jax": [], "torch": []}


class OrderRecordingFactory:
    """Echo that records each item as the worker runs it; the JAX worker
    hands it a ``VentilatedItem``, the port's the bare item."""

    def __init__(self, tag):
        self.tag = tag

    def __call__(self):
        tag = self.tag

        def fn(item):
            value = getattr(item, "item", item)
            SERVED[tag].append(value)
            return value

        return fn


class SlowEchoFactory:
    def __init__(self, delay_s=0.01):
        self.delay_s = delay_s

    def __call__(self):
        delay = self.delay_s

        def fn(item):
            time.sleep(delay)
            return getattr(item, "item", item)

        return fn


def _wait_for(cond, timeout=15.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _start_worker(p, addr, capacity=1, name=None):
    w = p.worker.ServiceWorker(addr, capacity=capacity, name=name, heartbeat_interval_s=0.3)
    threading.Thread(target=w.run, daemon=True).start()
    return w


def _feed(name, ex, items):
    """Issue ``items`` to a started executor of either package; returns a
    zero-argument collector of every result (bounded)."""
    if name == "jax":
        for i, v in enumerate(items):
            ex.put(JaxVentilatedItem(i, v))
        return lambda: [ex.get(timeout=30.0) for _ in items]
    out = {}

    def run():
        try:
            out["got"] = list(ex.imap(items))
        except Exception as exc:  # noqa: BLE001 - a stopped executor ends its feed
            out["err"] = exc

    t = threading.Thread(target=run)
    t.start()

    def collect():
        t.join(timeout=60.0)
        return out["got"]

    return collect


# -- scripted decisions ----------------------------------------------------------------------

@pytest.mark.parametrize("pressure,pending,capacity,busy,clients", list(itertools.product(
    [0.0, 0.1, 0.2, 1.0], [0, 3], [0, 2, 4], [0.0, 0.5, 1.0], [0, 1])))
def test_compute_recommendation_as_in_jax(pressure, pending, capacity, busy, clients):
    args = (pressure, 0.2, pending, capacity, busy, clients)
    assert (dispatcher.compute_recommendation(*args)
            == jax_dispatcher.compute_recommendation(*args))


_SIGNAL_KEYS = ("pressure", "starved_threshold", "busy_fraction", "pending_items",
                "worker_capacity", "workers", "connected_clients", "recommendation")


@pytest.mark.parametrize("reports,window_s,threshold", [
    ((), 10.0, None),
    (((30.0, 50.0), (0.1, 0.5)), 10.0, None),
    (((0.1, 1.0),), 10.0, 0.05),
    (((0.1, 3.0), (2.0, 4.0)), 5.0, 0.9),
    (((9.0, 2.0),), 10.0, None)])
def test_scaling_signal_on_scripted_reports_as_in_jax(reports, window_s, threshold):
    sigs = []
    for name in ("jax", "torch"):
        p = PKGS[name]
        disp = p.dispatcher.Dispatcher(telemetry=p.Telemetry())  # never started
        now = time.monotonic()
        with disp._lock:  # noqa: SLF001
            for age, starved in reports:
                disp._starved_reports.append((now - age, starved))  # noqa: SLF001
        sig = disp.scaling_signal(window_s=window_s, threshold=threshold)
        sigs.append({k: sig[k] for k in _SIGNAL_KEYS})
    assert sigs[0] == sigs[1]


@pytest.mark.parametrize("threshold", [None, 0.33])
def test_the_dispatcher_threshold_default_as_in_jax(threshold):
    outs = []
    for name in ("jax", "torch"):
        p = PKGS[name]
        disp = p.dispatcher.Dispatcher(telemetry=p.Telemetry(), starved_threshold=threshold)
        outs.append(disp.scaling_signal()["starved_threshold"])
    assert outs[0] == outs[1]


def test_a_purged_clients_reports_never_grow_as_in_jax():
    verdicts = []
    for name in ("jax", "torch"):
        p = PKGS[name]
        disp = p.dispatcher.Dispatcher(telemetry=p.Telemetry()).start()
        addr = f"127.0.0.1:{disp.port}"
        try:
            ex = p.client.ServiceExecutor(addr, telemetry=p.Telemetry(), window=4)
            ex.start(SlowEchoFactory())
            collect = _feed(name, ex, ["queued"])  # no workers: stays pending
            _wait_for(lambda: any(c["pending"] for c in disp.stats()["clients"].values()),
                      what="pending at the dispatcher")
            ex._starved_s = 50.0  # noqa: SLF001 - the reader's starved-consumer report
            ex._stats_sent_at = 0.0  # noqa: SLF001
            ex._maybe_send_stats()  # noqa: SLF001
            _wait_for(lambda: disp.scaling_signal()["pressure"] > 1.0, what="report folded")
            before = disp.scaling_signal()["recommendation"]
            ex.stop()  # a clean bye purges the session
            ex.join()
            _wait_for(lambda: not disp.stats()["clients"], what="client purged")
            sig = disp.scaling_signal()
            verdicts.append((before, sig["recommendation"], sig["pressure"] > 1.0))
            del collect
        finally:
            disp.stop()
            disp.join()
    assert verdicts[0] == verdicts[1] == ("grow", "ok", True)


def _sig(recommendation, pressure=0.5, pending=4, capacity=2, busy=0.0, clients=1):
    return {"pressure": pressure, "starved_threshold": 0.2, "busy_fraction": busy,
            "pending_items": pending, "worker_capacity": capacity, "workers": capacity,
            "connected_clients": clients, "recommendation": recommendation}


class FakeDispatcher:
    """Canned scaling signals, one a poll (the last repeats)."""

    port = 0

    def __init__(self, signals):
        self.signals = list(signals)

    def scaling_signal(self, window_s=10.0, threshold=None):
        return self.signals.pop(0) if len(self.signals) > 1 else self.signals[0]


class FakeSpawner:
    external = False

    def __init__(self, retire_ok=True, die_after=None):
        self.log = []
        self.retire_ok = retire_ok
        self.dead = set()
        self.die_after = die_after

    def spawn(self, name):
        self.log.append(("spawn", name))
        return name

    def alive(self, handle):
        return handle not in self.dead

    def retire(self, handle, timeout_s):
        self.log.append(("retire", handle))
        return self.retire_ok

    def kill(self, handle):
        self.log.append(("kill", handle))


SCRIPTS = {
    "sustained": ([_sig("grow"), _sig("ok"), _sig("grow"), _sig("grow")] + [_sig("ok")] * 3, {}),
    "ceiling": ([_sig("grow")] * 6, dict(grow_windows=1, max_workers=2)),
    "shrink": ([_sig("grow"), _sig("shrink")] + [_sig("shrink")] * 5,
               dict(grow_windows=1, shrink_windows=2)),
    "force_kill": ([_sig("grow"), _sig("shrink"), _sig("shrink")] + [_sig("ok")] * 2,
                   dict(grow_windows=1, shrink_windows=2, drain_timeout_s=0.1)),
    "floor": ([_sig("ok")] * 5, dict(min_workers=2)),
    "idle_floor": ([_sig("shrink", pressure=0.0, pending=0, busy=0.0, clients=0)] * 6,
                   dict(min_workers=1, shrink_windows=1)),
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_supervisor_decisions_on_scripted_probes_as_in_jax(script):
    signals, policy = SCRIPTS[script]
    runs = []
    for name in ("jax", "torch"):
        a = PKGS[name].autoscale
        spawner = FakeSpawner(retire_ok=script != "force_kill")
        kwargs = dict(min_workers=0, max_workers=4, grow_windows=2, shrink_windows=2,
                      settle_s=0.0, poll_interval_s=0.05)
        kwargs.update(policy)
        sup = a.AutoscaleSupervisor(dispatcher=FakeDispatcher(signals), spawner=spawner,
                                    policy=a.AutoscalePolicy(**kwargs))
        steps = []
        for k in range(len(signals)):
            if script == "floor" and k == 2:
                spawner.dead.add(spawner.log[0][1])  # one dies on its own
            steps.append(sup.step())
        runs.append((steps, spawner.log, sup.summary()["counters"], sup.fleet_size(None)))
    assert runs[0] == runs[1]


def test_settle_after_a_scale_event_as_in_jax():
    runs = []
    for name in ("jax", "torch"):
        a = PKGS[name].autoscale
        sup = a.AutoscaleSupervisor(
            dispatcher=FakeDispatcher([_sig("grow")]), spawner=FakeSpawner(),
            policy=a.AutoscalePolicy(min_workers=0, max_workers=4, grow_windows=2,
                                     settle_s=0.5, poll_interval_s=0.05))
        steps = [sup.step() for _ in range(4)]
        time.sleep(0.6)
        steps += [sup.step(), sup.step()]
        runs.append((steps, sup.spawner.log))
    assert runs[0] == runs[1]
    assert runs[1][0] == [None, "scale-up", None, None, None, "scale-up"]


@pytest.mark.parametrize("case", ["no_target", "both_targets", "no_spawner", "bounds",
                                  "empty_hook", "weight"])
def test_constructor_refusals_as_in_jax(case):
    outs = []
    for name in ("jax", "torch"):
        p = PKGS[name]
        a = p.autoscale
        make = {"no_target": lambda: a.AutoscaleSupervisor(),
                "both_targets": lambda: a.AutoscaleSupervisor("127.0.0.1:1",
                                                              dispatcher=FakeDispatcher([])),
                "no_spawner": lambda: a.AutoscaleSupervisor(dispatcher=FakeDispatcher([])),
                "bounds": lambda: a.AutoscalePolicy(min_workers=4, max_workers=2),
                "empty_hook": lambda: a.ExecHookSpawner("  "),
                "weight": lambda: p.client.ServiceExecutor("127.0.0.1:1", weight=0.0)}[case]
        with pytest.raises(Exception) as info:
            make()
        outs.append((type(info.value).__name__, str(info.value)))
    assert outs[0] == outs[1]


def test_the_exec_hook_contract_as_in_jax(tmp_path):
    events = []
    for name in ("jax", "torch"):
        a = PKGS[name].autoscale
        out = tmp_path / f"{name}.jsonl"
        sup = a.AutoscaleSupervisor(
            dispatcher=FakeDispatcher([_sig("grow", capacity=1)]),
            spawner=a.ExecHookSpawner(f"cat >> {out}"),
            policy=a.AutoscalePolicy(min_workers=0, max_workers=4, grow_windows=1,
                                     settle_s=0.0, poll_interval_s=0.05))
        assert sup.step() == "scale-up"
        events.append(out.read_text())
    assert events[0] == events[1]


def test_the_supervisor_probes_a_live_dispatcher_as_in_jax():
    sigs = []
    for name in ("jax", "torch"):
        p = PKGS[name]
        disp = p.dispatcher.Dispatcher(telemetry=p.Telemetry()).start()
        try:
            now = time.monotonic()
            with disp._lock:  # noqa: SLF001
                disp._starved_reports.append((now, 1.0))  # noqa: SLF001
            sup = p.autoscale.AutoscaleSupervisor(
                f"127.0.0.1:{disp.port}", spawner=FakeSpawner(),
                policy=p.autoscale.AutoscalePolicy(min_workers=0, starved_threshold=0.05))
            sig = sup.signal()
            dead = p.autoscale.AutoscaleSupervisor(
                "127.0.0.1:1", spawner=FakeSpawner(),
                policy=p.autoscale.AutoscalePolicy(min_workers=0))
            sigs.append(({k: sig[k] for k in _SIGNAL_KEYS if k != "pressure"},
                         dead.signal(), dead.summary()["counters"]["probe_failures"]))
        finally:
            disp.stop()
            disp.join()
    assert sigs[0] == sigs[1]


# -- QoS -------------------------------------------------------------------------------------

def _served_sequence(name, n, weights=(1.0, 1.0), priorities=(0, 0)):
    """Two clients' whole backlogs pending before any worker exists, then
    one capacity-1 worker: the order the worker runs the items in."""
    p = PKGS[name]
    SERVED[name].clear()
    disp = p.dispatcher.Dispatcher(telemetry=p.Telemetry(), heartbeat_timeout_s=5.0).start()
    addr = f"127.0.0.1:{disp.port}"
    executors, collectors = [], []
    try:
        for tag, weight, prio in zip("ab", weights, priorities):
            ex = p.client.ServiceExecutor(addr, telemetry=p.Telemetry(), window=2 * n,
                                          client_id=f"client-{tag}", weight=weight,
                                          priority=prio)
            ex.start(OrderRecordingFactory(name))
            executors.append(ex)
            collectors.append(_feed(name, ex, [f"{tag}-{i}" for i in range(n)]))
            _wait_for(lambda k=len(executors): sum(
                c["pending"] for c in disp.stats()["clients"].values()) == k * n,
                what="backlog pending")
        _start_worker(p, addr, capacity=1)
        results = [c() for c in collectors]
        qos = disp.stats()["qos"]
    finally:
        for ex in executors:
            ex.stop()
            ex.join()
        disp.stop()
        disp.join()
    assert sorted(results[0]) == sorted(f"a-{i}" for i in range(n))
    assert sorted(results[1]) == sorted(f"b-{i}" for i in range(n))
    return list(SERVED[name]), {cid: (q["weight"], q["priority"]) for cid, q in qos.items()}


@pytest.mark.parametrize("weights,priorities", [((3.0, 1.0), (0, 0)), ((1.0, 1.0), (0, 0)),
                                                ((1.0, 1.0), (0, 1)), ((5.0, 2.0), (1, 1))])
def test_qos_assignment_sequence_as_in_jax(weights, priorities):
    n = 16
    jax_seq, jax_qos = _served_sequence("jax", n, weights, priorities)
    seq, qos = _served_sequence("torch", n, weights, priorities)
    assert seq == jax_seq and qos == jax_qos
    if priorities == (0, 1):  # strict tiers: every high-tier item first
        assert all(v.startswith("b-") for v in seq[:n])


def test_admission_control_as_in_jax():
    outs = []
    for name in ("jax", "torch"):
        p = PKGS[name]
        disp = p.dispatcher.Dispatcher(telemetry=p.Telemetry(), max_clients=1).start()
        addr = f"127.0.0.1:{disp.port}"
        try:
            _start_worker(p, addr)
            ex = p.client.ServiceExecutor(addr, telemetry=p.Telemetry(), window=4)
            ex.start(SlowEchoFactory(0.0))
            first = _feed(name, ex, ["first"])()
            refused = p.client.ServiceExecutor(addr, telemetry=p.Telemetry(), window=4)
            with pytest.raises(OSError) as info:
                refused.start(SlowEchoFactory(0.0))
            outs.append((first, str(info.value),
                         disp.stats()["counters"].get("service.qos.admission_refused", 0)))
            ex.stop()
            ex.join()
        finally:
            disp.stop()
            disp.join()
    assert outs[0] == outs[1] and "admission refused" in outs[1][1]


def test_the_per_client_inflight_cap_holds_as_in_jax():
    outs = []
    for name in ("jax", "torch"):
        p = PKGS[name]
        disp = p.dispatcher.Dispatcher(telemetry=p.Telemetry(), max_client_inflight=2).start()
        addr = f"127.0.0.1:{disp.port}"
        try:
            _start_worker(p, addr, capacity=4)
            _wait_for(lambda: len(disp.stats()["workers"]) == 1)
            ex = p.client.ServiceExecutor(addr, telemetry=p.Telemetry(), window=16)
            ex.start(SlowEchoFactory(0.03))
            n = 16
            collect = _feed(name, ex, [f"i-{i}" for i in range(n)])
            max_seen, stop = [0], threading.Event()

            def watch():
                while not stop.is_set():
                    for c in disp.stats()["clients"].values():
                        max_seen[0] = max(max_seen[0], c["inflight"])
                    time.sleep(0.005)

            w = threading.Thread(target=watch)
            w.start()
            got = collect()
            stop.set()
            w.join(timeout=5)
            outs.append((sorted(got), max_seen[0] <= 2,
                         disp.stats()["counters"].get("service.qos.capped_deferrals", 0) >= 1))
            ex.stop()
            ex.join()
        finally:
            disp.stop()
            disp.join()
    assert outs[0] == outs[1] == (sorted(f"i-{i}" for i in range(16)), True, True)


# -- graceful retire -------------------------------------------------------------------------

def test_a_graceful_retire_finishes_its_inflight_items():
    disp = dispatcher.Dispatcher(telemetry=Telemetry(), heartbeat_timeout_s=5.0).start()
    addr = f"127.0.0.1:{disp.port}"
    w = worker.ServiceWorker(addr, capacity=2, heartbeat_interval_s=0.3)
    thread = threading.Thread(target=w.run, daemon=True)
    thread.start()
    _wait_for(lambda: len(disp.stats()["workers"]) == 1)
    ex = client.ServiceExecutor(addr, telemetry=Telemetry(), window=8)
    ex.start(SlowEchoFactory(0.05))
    n = 10
    try:
        it = ex.imap([f"i-{i}" for i in range(n)])
        got = [next(it)]  # the worker is mid-stream now
        done = {}
        retirer = threading.Thread(target=lambda: done.update(graceful=w.retire(timeout=30.0)))
        retirer.start()
        _wait_for(lambda: disp.stats()["workers"].get(w.worker_name, {}).get("draining", False)
                  or w.worker_name not in disp.stats()["workers"], what="draining")
        _start_worker(PKGS["torch"], addr, capacity=2, name="replacement")
        got += list(it)
        retirer.join(timeout=30.0)
        assert done.get("graceful") is True and w.retired_gracefully
        assert got == [f"i-{i}" for i in range(n)]  # plan order, every item once
        counters = disp.stats()["counters"]
        assert counters.get("service.requeued_items", 0) == 0, counters
        assert counters.get("service.qos.workers_draining", 0) == 1
        thread.join(timeout=5.0)
        assert not thread.is_alive()
    finally:
        ex.stop()
        ex.join()
        disp.stop()
        disp.join()


def test_an_inprocess_spawner_grows_and_retires_a_fleet():
    disp = dispatcher.Dispatcher(telemetry=Telemetry(), heartbeat_timeout_s=5.0).start()
    addr = f"127.0.0.1:{disp.port}"
    spawner = autoscale.InProcessSpawner(addr, capacity=1, heartbeat_interval_s=0.2)
    sup = autoscale.AutoscaleSupervisor(
        dispatcher=disp, spawner=spawner,
        policy=autoscale.AutoscalePolicy(min_workers=2, max_workers=3, settle_s=0.0,
                                         poll_interval_s=0.05))
    try:
        assert sup.step() == "floor"
        _wait_for(lambda: len(disp.stats()["workers"]) == 2, what="floor spawned")
        sup.stop()
        assert sup.fleet_size(None) == 0
        _wait_for(lambda: not disp.stats()["workers"], what="fleet retired")
    finally:
        disp.stop()
        disp.join()


def test_client_weight_and_priority_from_the_environment(monkeypatch):
    monkeypatch.setenv("PETASTORM_TPU_SERVICE_WEIGHT", "2.5")
    monkeypatch.setenv("PETASTORM_TPU_SERVICE_PRIORITY", "3")
    ex = client.ServiceExecutor("127.0.0.1:1")
    jax_ex = jax_client.ServiceExecutor("127.0.0.1:1")
    assert (ex.weight, ex.priority) == (jax_ex.weight, jax_ex.priority) == (2.5, 3)
    with pytest.raises(PetastormTpuError, match="weight must be > 0"):
        client.ServiceExecutor("127.0.0.1:1", weight=-1.0)


def test_the_cli_starts_a_dispatcher_a_supervisor_and_its_worker():
    """``python -m petastorm_tpu_torch.service.cli``: a dispatcher, an
    autoscale supervisor holding a floor of one worker (a worker process it
    spawns), ``stats``, then SIGTERM drains the supervisor's fleet."""
    import json
    import os
    import signal
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cli = [sys.executable, "-m", "petastorm_tpu_torch.service.cli"]
    disp = subprocess.Popen(cli + ["dispatcher", "--host", "127.0.0.1", "--port", "0"],
                            cwd=root, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                            text=True)
    procs = [disp]
    try:
        line = disp.stdout.readline()
        assert "listening on" in line, line
        addr = line.split("listening on")[1].strip()
        sup = subprocess.Popen(cli + ["autoscale", "--address", addr, "--min-workers", "1",
                                      "--max-workers", "1", "--poll-interval", "0.2",
                                      "--capacity", "1", "--drain-timeout", "10"],
                               cwd=root, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                               text=True)
        procs.append(sup)
        stats = {}

        def one_worker():
            out = subprocess.run(cli + ["stats", "--address", addr], cwd=root,
                                 capture_output=True, text=True, timeout=30)
            stats.update(json.loads(out.stdout))
            return len(stats["workers"]) == 1

        _wait_for(one_worker, timeout=40.0, what="the supervisor's worker registered")
        assert next(iter(stats["workers"])).startswith("autoscale-")
        sup.send_signal(signal.SIGTERM)
        events = [json.loads(l) for l in sup.communicate(timeout=40)[0].splitlines()
                  if l.startswith("{")]
        assert events[0]["event"] == "supervising" and events[-1]["event"] == "stopped"
        assert events[-1]["summary"]["counters"].get("workers_spawned", 0) >= 1
        _wait_for(lambda: not json.loads(subprocess.run(
            cli + ["stats", "--address", addr], cwd=root, capture_output=True, text=True,
            timeout=30).stdout)["workers"], timeout=30.0, what="the fleet drained")
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGINT)
            try:
                p.wait(timeout=15)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=10)
