"""The port's telemetry against the JAX package's, on the CPU.

The recorder alone is held to the JAX recorder exactly: the same
observations give the same counters, gauges, histogram buckets and
quantiles, the same Prometheus text, report and dominant stage, Chrome-trace
events with the same names and fields, and flight records each package
loads from the other.  A reader of the same dataset and seed records a
stated subset of the JAX reader's series, and every count-valued series is
equal (rows, rowgroups, skips, requeues, retries, cache hits and misses);
timings cannot match and are not compared.  ``metrics_port`` is scraped over
localhost, and ``hedge_after_s='auto'`` resolves as the JAX pool resolves it.
"""

import json
import multiprocessing
import threading
import time
import urllib.request

import numpy as np
import pytest

from petastorm_tpu import pool as jax_pool
from petastorm_tpu import reader as jax_reader
from petastorm_tpu import telemetry as jax_telemetry
from petastorm_tpu.telemetry import export as jax_export
from petastorm_tpu.telemetry import sampler as jax_sampler
from petastorm_tpu.test_util import chaos as jax_chaos
from petastorm_tpu.test_util import latency_fs as jax_latency_fs

from petastorm_tpu_torch import Field, Schema, pool, reader, telemetry
from petastorm_tpu_torch.codecs import CompressedImageCodec
from petastorm_tpu_torch.cuda.loader import CudaDataLoader
from petastorm_tpu_torch.etl.writer import write_dataset
from petastorm_tpu_torch.telemetry import export, report, sampler
from petastorm_tpu_torch.test_util import chaos, latency_fs

PKG = {"jax": (jax_telemetry, jax_reader, jax_chaos, jax_latency_fs),
       "torch": (telemetry, reader, chaos, latency_fs)}
N_ROWS, RG_ROWS = 40, 4  # 10 rowgroups


@pytest.fixture(autouse=True)
def _no_child_left():
    yield
    assert multiprocessing.active_children() == []


@pytest.fixture(scope="module")
def url(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("telemetry") / "ds")
    rng = np.random.default_rng(3)
    schema = Schema("Telemetry", [
        Field("x", np.int64),
        Field("image", np.uint8, (16, 16, 3), CompressedImageCodec("png")),
    ])
    write_dataset(path, schema, [{"x": i, "image": rng.integers(0, 256, (16, 16, 3),
                                                                  dtype=np.uint8)}
                                 for i in range(N_ROWS)], row_group_size_rows=RG_ROWS)
    return path


# -- the recorder alone ---------------------------------------------------------------


def _observe(tele_mod):
    """One fixed sequence of observations into a fresh recorder."""
    rng = np.random.default_rng(11)
    tele = tele_mod.Telemetry()
    for i in range(50):
        tele.counter("reader.rows_emitted").add(4)
        tele.counter("queue.results_empty_wait_s").add(float(rng.uniform(0, 0.01)))
        tele.gauge("pool.results_queue_depth").set(i % 7)
        tele.histogram("custom.latency_s").record(float(rng.exponential(0.02)))
        for stage, scale in (("decode", 3e6), ("transform", 1e6), ("ventilate", 1e4)):
            tele.record_stage(stage, 1_000_000 * i, int(rng.exponential(scale)) + 1,
                              {"ordinal": i})
    tele.register_stage("host-prep")
    return tele


def test_recorder_counters_gauges_and_histograms_equal_jax():
    want, got = _observe(jax_telemetry).snapshot(), _observe(telemetry).snapshot()
    assert got["counters"] == want["counters"]
    assert got["gauges"] == want["gauges"]
    assert set(got["histograms"]) == set(want["histograms"])
    for name, hist in want["histograms"].items():
        assert got["histograms"][name] == hist, name
        for q in (0.5, 0.9, 0.99):
            assert report.hist_quantile(got["histograms"][name], q) == \
                jax_telemetry.report.hist_quantile(hist, q)
    for q in (0.5, 0.99):
        assert (telemetry.Telemetry().histogram("h").quantile(q)
                == jax_telemetry.Telemetry().histogram("h").quantile(q))
    assert telemetry.DEFAULT_LATENCY_BUCKETS_S == jax_telemetry.DEFAULT_LATENCY_BUCKETS_S
    assert telemetry.STAGE_ORDER == jax_telemetry.STAGE_ORDER
    assert report._QUEUE_WAITS == jax_telemetry.report._QUEUE_WAITS


def test_prometheus_report_and_dominant_stage_of_one_snapshot_equal_jax():
    snap = _observe(jax_telemetry).snapshot()
    assert export.render_prometheus(snap) == jax_export.render_prometheus(snap)
    assert report.render_pipeline_report(snap) == jax_telemetry.render_pipeline_report(snap)
    assert report.dominant_stage(snap) == jax_telemetry.dominant_stage(snap) == "decode"
    merged = report.merge_hist_snapshots([snap["histograms"]["stage.decode.latency_s"]] * 2)
    assert merged == jax_telemetry.report.merge_hist_snapshots(
        [snap["histograms"]["stage.decode.latency_s"]] * 2)
    # the port's own snapshot renders as the JAX recorder's does
    port = _observe(telemetry).snapshot()
    assert (export.render_prometheus(port).splitlines()
            == jax_export.render_prometheus(port).splitlines())


def test_null_recorder_and_resolution_equal_jax(monkeypatch):
    monkeypatch.delenv(telemetry.ENV_VAR, raising=False)
    assert telemetry.ENV_VAR == jax_telemetry.ENV_VAR == "PETASTORM_TPU_TELEMETRY"
    assert telemetry.resolve(None) is telemetry.NULL_TELEMETRY
    assert not telemetry.NULL_TELEMETRY.enabled
    assert telemetry.NULL_TELEMETRY.snapshot() == jax_telemetry.NULL_TELEMETRY.snapshot()
    assert (telemetry.NULL_TELEMETRY.chrome_trace()
            == jax_telemetry.NULL_TELEMETRY.chrome_trace())
    with telemetry.NULL_TELEMETRY.stage("decode") as ctx:
        assert ctx is telemetry.NULL_CONTEXT
    explicit = telemetry.Telemetry()
    assert telemetry.resolve(explicit) is explicit
    assert telemetry.resolve(False) is telemetry.NULL_TELEMETRY
    monkeypatch.setenv(telemetry.ENV_VAR, "1")
    assert telemetry.enabled_from_env() and jax_telemetry.enabled_from_env()
    assert telemetry.resolve(None) is telemetry.enable()


def test_chrome_trace_has_the_jax_event_names_and_fields():
    traces = {}
    for name, mod in (("jax", jax_telemetry), ("torch", telemetry)):
        tele = mod.Telemetry()
        with tele.stage("decode", path="p", rowgroup=3):
            pass
        with tele.span("fetch", cat="io", bytes=12):
            pass
        tele.trace.add("io-retry", "fault", 5, 0, {"what": "w"})
        traces[name] = tele.chrome_trace()
    want, got = traces["jax"], traces["torch"]
    assert set(got) == set(want)

    def shape(trace):
        return [(e["name"], e.get("cat"), e["ph"], tuple(sorted(e)),
                 tuple(sorted(e.get("args", {})))) for e in trace["traceEvents"]]

    assert shape(got) == shape(want)
    meta = [e for e in got["traceEvents"] if e["ph"] == "M"]
    assert meta == [e for e in want["traceEvents"] if e["ph"] == "M"]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_flight_records_cross_load(tmp_path, writer):
    mods = {"jax": (jax_telemetry, jax_sampler), "torch": (telemetry, sampler)}
    tele_mod, write_mod = mods[writer]
    tele = _observe(tele_mod)
    smp = write_mod.MetricsSampler(tele, interval_s=60.0)
    smp.sample_now()  # the baseline
    for _ in range(2):
        time.sleep(0.01)
        tele.counter("reader.rows_emitted").add(8)
        smp.sample_now()
    record = write_mod.flight_record(smp, reason="test")
    path = str(tmp_path / "flight.jsonl")
    write_mod.dump_flight_record(record, path)
    for _, load_mod in mods.values():
        loaded = load_mod.load_flight_records(path)
        assert len(loaded) == 1 and loaded[0]["reason"] == "test"
        assert len(loaded[0]["points"]) == len(record["points"]) == 2
        assert loaded[0]["points"][-1]["counters"] == json.loads(
            json.dumps(record["points"][-1]["counters"]))


def test_sampler_points_have_the_jax_keys():
    points = {}
    for name, (tele_mod, smp_mod) in (("jax", (jax_telemetry, jax_sampler)),
                                      ("torch", (telemetry, sampler))):
        tele = _observe(tele_mod)
        smp = smp_mod.MetricsSampler(tele, interval_s=60.0)
        smp.sample_now()  # the baseline
        time.sleep(0.01)
        tele.record_stage("decode", 0, 1000)
        smp.sample_now()
        points[name] = smp.series()[-1]
    assert sorted(points["torch"]) == sorted(points["jax"])
    assert sorted(points["torch"]["stages"]) == sorted(points["jax"]["stages"])
    assert sorted(points["torch"]["rates"]) == sorted(points["jax"]["rates"])


# -- a reader on the same dataset and seed ----------------------------------------------


def _read(pkg, url, **kwargs):
    """(rows, telemetry snapshot, diagnostics) of one read with a recorder."""
    tele_mod, mod = PKG[pkg][:2]
    tele = tele_mod.Telemetry()
    with mod.make_batch_reader(url, shuffle_seed=5, telemetry=tele, **kwargs) as r:
        rows = sorted(int(x) for b in r for x in b.x)
    return rows, tele.snapshot(), r.diagnostics


#: series the port does not record, and why: none in these reads
PORT_LACKS = frozenset()
#: count-valued series, equal between the packages on the same read
COUNTS = ("reader.rows_emitted", "reader.batches_consumed", "worker.rowgroups_decoded",
          "worker.rows_decoded", "stage.decode.count", "stage.ventilate.count",
          "decode.batch_calls", "decode.batch_images", "errors.skipped_rowgroups",
          "errors.requeued_items", "liveness.hedged_items", "liveness.hung_workers_killed",
          "liveness.hung_workers_abandoned")


def _names(snap):
    return {kind: set(snap.get(kind, {})) for kind in ("counters", "gauges", "histograms")}


def _check_series(want, got):
    for kind, names in _names(want).items():
        missing = names - _names(got)[kind]
        assert missing <= PORT_LACKS, (kind, sorted(missing))
        assert _names(got)[kind] <= names, (kind, sorted(_names(got)[kind] - names))
    for name in COUNTS:
        assert got["counters"].get(name) == want["counters"].get(name), name


@pytest.mark.parametrize("pool_type", ["thread", "serial", "process"])
def test_reader_series_are_the_jax_readers_and_counts_equal(url, pool_type):
    kwargs = dict(reader_pool_type=pool_type, workers_count=2)
    want_rows, want, _ = _read("jax", url, **kwargs)
    got_rows, got, diag = _read("torch", url, **kwargs)
    assert got_rows == want_rows == list(range(N_ROWS))
    if pool_type == "process":
        # the workers' stage series stay in the workers, in both packages
        # (``petastorm_tpu/telemetry/__init__.py:31-36``)
        for snap in (want, got):
            assert "worker.rowgroups_decoded" not in snap["counters"]
    _check_series(want, got)
    assert diag["telemetry"]["counters"]["reader.rows_emitted"] == N_ROWS


def test_skip_policy_and_requeues_count_as_jax(url):
    counts = {}
    for pkg in ("jax", "torch"):
        chaos_mod = PKG[pkg][2]
        spec = chaos_mod.ChaosSpec(decode_fail_ordinals=(2, 7), kill_ordinals=(4,))
        rows, snap, diag = _read(pkg, url, reader_pool_type="thread", workers_count=2,
                                 on_error="skip", chaos=spec)
        counts[pkg] = (rows, {n: snap["counters"].get(n) for n in COUNTS})
        assert snap["counters"]["errors.skipped_rowgroups"] == 2
        assert snap["counters"]["errors.requeued_items"] == 1
    assert counts["torch"] == counts["jax"]


def test_io_retries_count_as_jax(url):
    counts = {}
    for pkg in ("jax", "torch"):
        fs, _stats = PKG[pkg][3].latent_filesystem(latency_s=0.0, fail_first_reads=3)
        rows, snap, _ = _read(pkg, url, reader_pool_type="serial", filesystem=fs)
        counts[pkg] = (rows, snap["counters"].get("io.retries"),
                       snap["counters"].get("io.rowgroups_read"),
                       snap["gauges"].get("io.reads_per_rowgroup"))
    assert counts["torch"] == counts["jax"]
    # the first failed read is the optional _common_metadata one (not retried)
    assert counts["torch"][1] == 2 and counts["torch"][2] == N_ROWS // RG_ROWS


@pytest.mark.parametrize("cache_type", ["memory", "local-disk"])
def test_cache_hits_and_misses_count_as_jax(url, tmp_path, cache_type):
    counts = {}
    for pkg in ("jax", "torch"):
        rows, snap, _ = _read(pkg, url, reader_pool_type="serial", num_epochs=3,
                              cache_type=cache_type, cache_location=str(tmp_path / pkg))
        counts[pkg] = (rows, snap["counters"]["cache.hits"], snap["counters"]["cache.misses"])
    assert counts["torch"] == counts["jax"]
    assert counts["torch"][1:] == (20, 10)


def test_loader_records_the_jax_loader_series(url):
    tele = telemetry.Telemetry()
    with reader.make_reader(url, shuffle_seed=0, telemetry=tele, workers_count=2,
                            schema_fields=["x", "image"]) as r:
        loader = CudaDataLoader(r, 8, device="cpu", prefetch=3)
        assert loader.telemetry is tele and loader.prefetch == 3
        with loader:
            delivered = sum(1 for _ in loader)
    snap = tele.snapshot()
    assert delivered == N_ROWS // 8
    assert snap["counters"]["loader.batches_delivered"] == delivered
    assert snap["counters"]["loader.consumer_wait_s"] > 0
    assert {"loader.host_queue_depth", "loader.prefetch_depth"} <= set(snap["gauges"])
    for stage in ("host-assemble", "host-prep", "device-transfer"):
        assert snap["counters"][f"stage.{stage}.count"] > 0, stage
    assert telemetry.dominant_stage(snap) in telemetry.STAGE_ORDER


def test_reader_diagnostics_carry_the_jax_keys(url):
    with jax_reader.make_batch_reader(url, shuffle_seed=5, workers_count=2) as r:
        list(r)
        want = set(r.diagnostics)
    with reader.make_batch_reader(url, shuffle_seed=5, workers_count=2,
                                  telemetry=telemetry.Telemetry()) as r:
        list(r)
    got = set(r.diagnostics)
    assert {"ventilated", "consumed", "in_queue_size", "native", "telemetry"} <= got
    # the JAX thread pool's bounded input queue and results queue: the port's
    # input queue is unbounded and its results are the window's
    # (``results_queue_bound``)
    assert want - got == {"in_queue_bound", "results_queue_size"}, sorted(want - got)


# -- the metrics endpoint and the flight recorder --------------------------------------


def test_metrics_port_scrape_over_localhost(url):
    with reader.make_batch_reader(url, shuffle_seed=5, workers_count=2, metrics_port=0,
                                  sample_interval_s=0.05) as r:
        assert r.telemetry.enabled and r.sampler is not None
        port = r.metrics_server.port
        assert r.diagnostics["metrics_port"] == port
        list(r)
        r.sampler.sample_now()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as resp:
            text = resp.read().decode()
            assert resp.headers["Content-Type"] == export.CONTENT_TYPE
    assert 'petastorm_tpu_stage_busy_seconds_total{stage="decode"}' in text
    assert "petastorm_tpu_queue_results_empty_wait_s_total" in text
    assert f"petastorm_tpu_reader_rows_emitted_total {N_ROWS}" in text


def test_flight_record_on_a_terminal_failure(url, tmp_path):
    path = str(tmp_path / "flight.jsonl")
    spec = chaos.ChaosSpec(decode_fail_ordinals=(3,))
    with reader.make_batch_reader(url, shuffle_seed=5, reader_pool_type="thread",
                                  workers_count=2, chaos=spec, flight_record_path=path,
                                  sample_interval_s=0.05) as r:
        with pytest.raises(Exception):
            list(r)
        diag = r.diagnostics
    assert "WorkerError" in diag["flight_recorder"]["reason"]
    # the JAX package loads the port's record
    records = jax_sampler.load_flight_records(path)
    assert len(records) == 1 and records[0]["points"]


def test_trace_items_needs_the_service_as_in_jax(url):
    for mod in (jax_reader, reader):
        with pytest.raises(Exception, match="trace_items arms DISTRIBUTED"):
            mod.make_batch_reader(url, trace_items=True)
    # with an address, each package's reader traces through its own fleet:
    # the same rows, and the merged cross-process spans in its trace buffer
    from petastorm_tpu.service.dispatcher import Dispatcher as JaxDispatcher
    from petastorm_tpu.service.worker import ServiceWorker as JaxServiceWorker

    from petastorm_tpu_torch.service.dispatcher import Dispatcher
    from petastorm_tpu_torch.service.worker import ServiceWorker

    rows = []
    for mod, disp_cls, worker_cls, tele_mod in (
            (jax_reader, JaxDispatcher, JaxServiceWorker, jax_telemetry),
            (reader, Dispatcher, ServiceWorker, telemetry)):
        disp = disp_cls(telemetry=tele_mod.Telemetry()).start()
        addr = f"127.0.0.1:{disp.port}"
        worker = worker_cls(addr, capacity=2)
        thread = threading.Thread(target=worker.run, daemon=True)
        thread.start()
        tele = tele_mod.Telemetry()
        try:
            with mod.make_batch_reader(url, shuffle_seed=5, service_address=addr,
                                       trace_items=True, telemetry=tele) as r:
                rows.append([int(x) for b in r for x in b.x])
                assert r.diagnostics["trace_items"] == 16
        finally:
            worker.stop()
            thread.join(timeout=10)
            disp.stop()
            disp.join()
        spans = [e for e in tele.trace.chrome_trace()["traceEvents"]
                 if e.get("cat") == "service.trace" and e.get("ph") == "X"]
        assert {"service.item", "worker.exec"} <= {e["name"] for e in spans}
    assert rows[0] == rows[1]


# -- hedge_after_s='auto' ---------------------------------------------------------------


@pytest.mark.parametrize("decodes", [0, 19, 20, 200])
@pytest.mark.parametrize("scale", [0.001, 0.5])
def test_hedge_auto_resolves_as_the_jax_pool(decodes, scale):
    rng = np.random.default_rng(decodes)
    latencies = rng.exponential(scale, decodes)
    thresholds = []
    for pool_mod, tele_mod in ((jax_pool, jax_telemetry), (pool, telemetry)):
        tele = tele_mod.Telemetry()
        for lat in latencies:
            tele.histogram("stage.decode.latency_s").record(float(lat))
        ex = pool_mod.make_executor("thread", hedge_after_s="auto", telemetry=tele)
        thresholds.append(ex._hedge_threshold())  # noqa: SLF001
    assert thresholds[1] == thresholds[0]
    if decodes < 20:
        assert thresholds[1] is None
    else:
        assert thresholds[1] >= 0.5


def test_hedge_auto_without_telemetry_hedges_nothing():
    for pool_mod in (jax_pool, pool):
        ex = pool_mod.make_executor("thread", hedge_after_s="auto")
        assert ex._hedge_threshold() is None  # noqa: SLF001


def test_loader_trace_dir_writes_a_torch_profiler_chrome_trace(url, tmp_path):
    trace_dir = str(tmp_path / "trace")
    with reader.make_reader(url, shuffle_seed=0, workers_count=2,
                            schema_fields=["x", "image"]) as r:
        with CudaDataLoader(r, 8, device="cpu", trace_dir=trace_dir) as loader:
            for _ in loader:
                pass
            path = loader.trace_path
    with open(path) as f:
        trace = json.load(f)
    assert path.startswith(trace_dir) and trace["traceEvents"]
    assert any(e.get("ph") == "X" for e in trace["traceEvents"])
