"""Distributed item tracing and the fleet view of the port's ingest service
against the JAX package's, on the CPU.

After ``tests/test_service_trace.py``: the client's merge of a returned hop
timeline gives the JAX span names, process tracks and ``service.hop.*``
sums on the same canned timeline; a traced read through a real fleet gives
one trace with client, dispatcher and worker tracks and the JAX hop series
names; ``render_fleet_prometheus`` and ``render_fleet_frame`` of the same
fleet dicts give equal text; the dispatcher's fleet view folds the workers'
heartbeats; the flight record of a failed service read carries the fleet
events; and tracing on and off give bit-identical digests.  Every wait is
bounded.
"""

import threading
import time
import types

import numpy as np
import pytest

from petastorm_tpu.service import client as jax_client
from petastorm_tpu.service import dispatcher as jax_dispatcher
from petastorm_tpu.service.cli import render_fleet_frame as jax_render_fleet_frame
from petastorm_tpu.telemetry import Telemetry as JaxTelemetry
from petastorm_tpu.telemetry.export import render_fleet_prometheus as jax_render_fleet

from petastorm_tpu_torch import reader
from petastorm_tpu_torch.etl.writer import write_dataset
from petastorm_tpu_torch.schema import Field, Schema
from petastorm_tpu_torch.service import client, dispatcher
from petastorm_tpu_torch.service.cli import render_fleet_frame
from petastorm_tpu_torch.service.dispatcher import Dispatcher
from petastorm_tpu_torch.service.protocol import connect_frames
from petastorm_tpu_torch.service.worker import ServiceWorker
from petastorm_tpu_torch.telemetry import Telemetry
from petastorm_tpu_torch.telemetry.export import render_fleet_prometheus
from petastorm_tpu_torch.test_util.chaos import ChaosSpec

PKGS = {"jax": types.SimpleNamespace(client=jax_client, dispatcher=jax_dispatcher,
                                     Telemetry=JaxTelemetry),
        "torch": types.SimpleNamespace(client=client, dispatcher=dispatcher,
                                       Telemetry=Telemetry)}
HOPS = ("client_serialize", "dispatcher_queue", "relay", "worker_queue", "worker_exec",
        "return_relay", "client_deserialize")


def _wait_for(cond, timeout=15.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


@pytest.fixture(scope="module")
def int_dataset(tmp_path_factory):
    url = str(tmp_path_factory.mktemp("trace") / "ds")
    write_dataset(url, Schema("TraceInts", [Field("x", np.int64)]),
                  [{"x": i} for i in range(200)], row_group_size_rows=10)
    return url


class _Fleet:
    def __init__(self, n=2):
        self.disp = Dispatcher(telemetry=Telemetry(), heartbeat_timeout_s=5.0).start()
        self.addr = f"127.0.0.1:{self.disp.port}"
        self.workers = [ServiceWorker(self.addr, capacity=2, name=f"fw{i}",
                                      heartbeat_interval_s=0.2, telemetry=Telemetry())
                        for i in range(n)]
        for w in self.workers:
            threading.Thread(target=w.run, daemon=True).start()
        _wait_for(lambda: len(self.disp.stats()["workers"]) == n, what="workers registered")

    def close(self):
        for w in self.workers:
            w.stop()
        self.disp.stop()
        self.disp.join()


@pytest.fixture
def fleet():
    f = _Fleet()
    try:
        yield f
    finally:
        f.close()


# -- the merge -------------------------------------------------------------------------------

def _canned_timeline():
    ms = 1_000_000
    woff, d = 500, 1000

    def w(t_ns):
        return t_ns + 1000 - woff

    hops = [["d", "recv", 0, 2 * ms + d, 0], ["d", "assign", 0, 3 * ms + d, 0],
            ["w0", "recv", 0, w(4 * ms), woff], ["w0", "start", 0, w(5 * ms), woff],
            ["d", "requeue", 1, 8 * ms + d, 0], ["d", "assign", 1, 9 * ms + d, 0],
            ["w1", "recv", 1, w(10 * ms), woff], ["w1", "start", 1, w(11 * ms), woff],
            ["w1", "done", 1, w(17 * ms), woff], ["d", "relay", 1, 18 * ms + d, 0]]
    return hops, 20 * ms, 21 * ms


def _merge(name, trace_items=1):
    p = PKGS[name]
    tele = p.Telemetry()
    ex = p.client.ServiceExecutor("127.0.0.1:7", telemetry=tele, trace_items=trace_items)
    ex._disp_clock_offset_ns = 1000  # noqa: SLF001 - the dispatcher's clock is ours + 1000
    ex._traces[5] = {"id": 5, "put_ns": 0, "sent_ns": 1_000_000}  # noqa: SLF001
    hops, recv, done = _canned_timeline()
    ex._finish_trace({"ordinal": 5, "attempt": 1}, {"id": 5, "hops": hops}, recv, done)  # noqa: SLF001
    return tele


def test_the_merged_timeline_has_the_jax_spans_and_tracks():
    outs = []
    for name in ("jax", "torch"):
        tele = _merge(name)
        events = sorted(tele.trace._events, key=lambda e: (e[3], e[0]))  # noqa: SLF001
        chrome = tele.trace.chrome_trace()
        tracks = sorted(e["args"]["name"] for e in chrome["traceEvents"]
                        if e.get("name") == "process_name")
        hists = {n: (h["count"], round(h["sum"], 12))
                 for n, h in tele.snapshot()["histograms"].items()
                 if n.startswith("service.hop.")}
        outs.append(([(e[0], e[1], e[3], e[4], e[5], e[6]) for e in events], tracks, hists))
    assert outs[0] == outs[1]
    spans = {e[0] for e in outs[1][0]}
    assert {"service.item", "dispatch.queue", "dispatch.requeue", "worker.queue",
            "worker.exec", "return.relay", "relay", "client.serialize",
            "client.deserialize"} <= spans
    assert {"dispatcher@127.0.0.1:7", "worker:w0", "worker:w1"} <= set(outs[1][1])
    hist = outs[1][2]
    assert sum(hist[f"service.hop.{h}"][1] for h in HOPS) == pytest.approx(
        hist["service.hop.total"][1])


@pytest.mark.parametrize("trace_items,env", [(None, None), (True, None), (4, None),
                                             (None, "8"), (False, "8"), (0, None)])
def test_trace_sampling_resolves_as_in_jax(trace_items, env, monkeypatch):
    if env is None:
        monkeypatch.delenv("PETASTORM_TPU_TRACE_ITEMS", raising=False)
    else:
        monkeypatch.setenv("PETASTORM_TPU_TRACE_ITEMS", env)
    outs = []
    for name in ("jax", "torch"):
        p = PKGS[name]
        ex = p.client.ServiceExecutor("127.0.0.1:7", telemetry=p.Telemetry(),
                                      trace_items=trace_items)
        outs.append((ex._trace_every, ex._tracing, ex.diagnostics["trace_items"]))  # noqa: SLF001
    assert outs[0] == outs[1]


# -- end to end ------------------------------------------------------------------------------

def _traced_read(url, addr, tele, **kwargs):
    with reader.make_batch_reader(url, service_address=addr, shuffle_seed=3, telemetry=tele,
                                  **kwargs) as r:
        rows = [int(x) for b in r.iter_batches() for x in b.columns["x"]]
        return rows, r.stream_digest, r.diagnostics


def test_a_traced_read_merges_client_dispatcher_and_worker_tracks(int_dataset, fleet):
    tele = Telemetry()
    rows, _digest, diag = _traced_read(int_dataset, fleet.addr, tele, trace_items=1)
    assert sorted(rows) == list(range(200)) and diag["trace_items"] == 1
    chrome = tele.trace.chrome_trace()
    spans = [e for e in chrome["traceEvents"]
             if e.get("cat") == "service.trace" and e.get("ph") == "X"]
    assert len({e["pid"] for e in spans}) >= 3
    named = {e["args"]["name"] for e in chrome["traceEvents"] if e.get("name") == "process_name"}
    assert any(n.startswith("dispatcher@") for n in named)
    assert any(n.startswith("worker:") for n in named)
    assert {"service.item", "dispatch.queue", "worker.exec", "return.relay"} <= {
        e["name"] for e in spans}
    hists = tele.snapshot()["histograms"]
    hop = {n[len("service.hop."):]: h for n, h in hists.items() if n.startswith("service.hop.")}
    assert set(HOPS) | {"total"} == set(hop)  # the JAX series names, no others
    assert len({hop[h]["count"] for h in HOPS}) == 1
    assert sum(hop[h]["sum"] for h in HOPS) == pytest.approx(hop["total"]["sum"], rel=0.05)


def test_tracing_on_and_off_give_bit_identical_digests(int_dataset, fleet):
    plain = _traced_read(int_dataset, fleet.addr, Telemetry(), num_epochs=2)
    traced = _traced_read(int_dataset, fleet.addr, Telemetry(), num_epochs=2, trace_items=1)
    assert traced[0] == plain[0] and traced[1] == plain[1]


def test_the_fleet_view_folds_the_heartbeats(int_dataset, fleet):
    rows, _, _ = _traced_read(int_dataset, fleet.addr, Telemetry(), trace_items=1)
    assert sorted(rows) == list(range(200))
    _wait_for(lambda: any(w.get("hists") for w in fleet.disp.fleet_stats()["workers"].values()),
              what="heartbeat histogram fold")
    view = fleet.disp.fleet_stats()
    assert set(view["workers"]) == {"fw0", "fw1"}
    assert view["merged_hists"] and view["fleet_counters"].get("worker.rowgroups_decoded", 0) > 0
    conn = connect_frames(("127.0.0.1", fleet.disp.port), timeout=5.0)
    try:
        conn.send({"t": "fleet?"})
        reply = conn.recv(timeout=5.0)
    finally:
        conn.close()
    assert reply["t"] == "fleet" and set(reply["fleet"]["workers"]) == {"fw0", "fw1"}
    # the dispatcher's /metrics body ends with the fleet families
    text = fleet.disp._fleet_prometheus()  # noqa: SLF001
    assert 'petastorm_tpu_fleet_worker_up{worker="fw0"} 1' in text


def test_the_flight_record_carries_the_fleet_events(int_dataset, fleet):
    fleet.disp._event("requeue", client="c0", ordinal=7, attempt=1)  # noqa: SLF001
    with pytest.raises(Exception):  # noqa: B017 - any terminal failure
        with reader.make_batch_reader(int_dataset, service_address=fleet.addr,
                                      shuffle_seed=0, telemetry=Telemetry(),
                                      chaos=ChaosSpec(decode_fail_ordinals=tuple(range(20))),
                                      on_error="raise") as r:
            list(r.iter_batches())
    record = r.diagnostics["flight_recorder"]
    assert "requeue" in [e["kind"] for e in record["fleet_events"]]


def test_fetch_fleet_events_as_in_jax():
    outs = []
    for name in ("jax", "torch"):
        p = PKGS[name]
        disp = p.dispatcher.Dispatcher(telemetry=p.Telemetry()).start()
        try:
            disp._event("requeue", client="c0", ordinal=7, attempt=1)  # noqa: SLF001
            ex = p.client.ServiceExecutor(f"127.0.0.1:{disp.port}", telemetry=p.Telemetry())
            events = ex.fetch_fleet_events()
            outs.append([{k: v for k, v in e.items() if k != "ts"} for e in events])
            dead = p.client.ServiceExecutor("127.0.0.1:1", telemetry=p.Telemetry())
            assert dead.fetch_fleet_events(timeout=1.0) == []
        finally:
            disp.stop()
            disp.join()
    assert outs[0] == outs[1] and outs[1][-1]["kind"] == "requeue"


# -- renderers -------------------------------------------------------------------------------

def _fleet_dict(seed):
    rng = np.random.default_rng(seed)
    workers = {}
    for i in range(int(rng.integers(0, 4))):
        hists = {}
        if rng.random() < 0.7:
            hists["service.hop.worker_exec"] = {"count": int(rng.integers(1, 50)),
                                                "p50_s": float(rng.random() / 100),
                                                "p99_s": float(rng.random() / 10)}
        workers[f"w{i}"] = {"busy": int(rng.integers(0, 3)), "capacity": 2,
                            "inflight": int(rng.integers(0, 3)),
                            "heartbeat_age_s": float(rng.random()),
                            "draining": bool(rng.random() < 0.3),
                            "counters": {"worker.rowgroups_decoded": float(rng.integers(0, 99)),
                                         "decode.rows": float(rng.integers(0, 999))},
                            "hists": hists}
    fleet = {"workers": workers, "uptime_s": float(rng.random() * 100),
             "merged_hists": {"service.hop.worker_exec": {"count": 9, "p50_s": 0.004,
                                                          "p99_s": 0.02},
                              "stage.decode.latency_s": {"count": 3, "p50_s": 0.1,
                                                         "p99_s": None}},
             "fleet_counters": {"worker.rowgroups_decoded": float(rng.integers(0, 99)),
                                "service.frames_shm": 4.0},
             "events": [{"ts": 1.0, "src": "autoscale", "kind": "autoscale.scale_up",
                         "spawned": 1}],
             "scaling": {"recommendation": "grow", "pressure": 0.4, "workers": len(workers)}}
    if seed % 2:
        fleet["epoch"] = seed
    return fleet


@pytest.mark.parametrize("seed", range(6))
def test_render_fleet_prometheus_is_the_jax_text(seed):
    fleet = _fleet_dict(seed)
    assert render_fleet_prometheus(fleet) == jax_render_fleet(fleet)


def test_render_fleet_prometheus_of_nothing_is_empty():
    assert render_fleet_prometheus({}) == jax_render_fleet({}) == ""


@pytest.mark.parametrize("seed", range(4))
def test_render_fleet_frame_is_the_jax_text(seed):
    stats = {"ha": {"role": "primary", "epoch": 2, "journal_seq": 40,
                    "standbys": {"sb": {"synced_seq": 37, "standby_lag_items": 3}}}}
    fleet, prev = _fleet_dict(seed), _fleet_dict(seed + 10)
    args = (stats, fleet, prev)
    assert (render_fleet_frame(*args, dt_s=2.0, elapsed_s=4.0)
            == jax_render_fleet_frame(*args, dt_s=2.0, elapsed_s=4.0))
    assert render_fleet_frame(None, None) == jax_render_fleet_frame(None, None)


def test_the_dispatchers_metrics_endpoint_ends_with_the_fleet_families(int_dataset):
    import urllib.request

    disp = Dispatcher(telemetry=Telemetry(), heartbeat_timeout_s=5.0, metrics_port=0).start()
    addr = f"127.0.0.1:{disp.port}"
    w = ServiceWorker(addr, capacity=2, name="mw0", heartbeat_interval_s=0.2,
                      telemetry=Telemetry())
    threading.Thread(target=w.run, daemon=True).start()
    try:
        _wait_for(lambda: len(disp.stats()["workers"]) == 1, what="worker registered")
        rows, _, _ = _traced_read(int_dataset, addr, Telemetry())
        assert sorted(rows) == list(range(200))
        _wait_for(lambda: disp.fleet_stats()["fleet_counters"], what="heartbeat fold")
        url = f"http://127.0.0.1:{disp.metrics_server.port}/metrics"
        with urllib.request.urlopen(url, timeout=10) as resp:
            body = resp.read().decode()
        assert 'petastorm_tpu_fleet_worker_up{worker="mw0"} 1' in body
        assert "petastorm_tpu_fleet_counter_total" in body
        # a live view renders to the JAX renderer's text
        view = disp.fleet_stats()
        assert render_fleet_prometheus(view) == jax_render_fleet(view)
    finally:
        w.stop()
        disp.stop()
        disp.join()
