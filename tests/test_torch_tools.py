"""The port's operator CLIs and test utilities against the JAX package's, on
the CPU.

* ``show_metadata``: the ``--json`` document (and the human text) of the
  same dataset equal to the JAX tool's, package names aside;
* ``copy_dataset``: a copy by either package reads back, through either
  reader, as the other package's copy does, row for row;
* ``diagnose``: the ``--json`` document's keys, its snapshot's counter and
  stage names, rows, batches and stream digest equal to the JAX tool's on a
  serial read; each rendering (the ``--watch`` frame from one sampler
  point, the planner, autotune, liveness and digest verdicts) equal to the
  JAX tool's string for string;
* ``synthetic.create_test_dataset``/``random_row``, ``ReaderMock`` and the
  stub workers: the same rows and results from one seed.

Exact equality throughout: these are host computations over the same data.
"""

import copy
import json
import os
import re
import threading

import numpy as np
import pytest

from petastorm_tpu.reader import make_reader as jax_make_reader
from petastorm_tpu.test_util import reader_mock as jax_reader_mock
from petastorm_tpu.test_util import stub_workers as jax_stub_workers
from petastorm_tpu.test_util import synthetic as jax_synthetic
from petastorm_tpu.tools import copy_dataset as jax_copy
from petastorm_tpu.tools import diagnose as jax_diagnose
from petastorm_tpu.tools import show_metadata as jax_show
from petastorm_tpu_torch.etl.indexing import SingleFieldIndexer, build_rowgroup_index
from petastorm_tpu_torch.reader import make_reader
from petastorm_tpu_torch.test_util import reader_mock, stub_workers, synthetic
from petastorm_tpu_torch.tools import copy_dataset, diagnose, show_metadata

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def test_dataset(tmp_path_factory):
    url = str(tmp_path_factory.mktemp("tools") / "ds")
    rows = synthetic.create_test_dataset(url, num_rows=40, row_group_size_rows=8)
    build_rowgroup_index(url, [SingleFieldIndexer("by_sensor", "sensor_name")])
    return url, rows


def _normalize(obj):
    """The document with the port's package name read as the JAX one's."""
    return json.loads(json.dumps(obj).replace("petastorm_tpu_torch", "petastorm_tpu"))


def _plain(value):
    if isinstance(value, np.ndarray):
        return (value.dtype.str, value.shape, value.tobytes())
    if isinstance(value, (float, np.floating)) and np.isnan(value):
        return "nan"
    return value


def _rows(factory, url, **kwargs):
    """The rows of a serial unshuffled read, in file order."""
    with factory(url, reader_pool_type="serial", shuffle_row_groups=False, **kwargs) as r:
        return [{k: _plain(v) for k, v in row._asdict().items()} for row in r]


# -- show_metadata -----------------------------------------------------------------------

@pytest.mark.parametrize("flags", [[], ["--schema-only"], ["--rowgroups"]],
                         ids=["default", "schema-only", "rowgroups"])
def test_show_metadata_json_equals_the_jax_tools(test_dataset, capsys, flags):
    url, _ = test_dataset
    docs = []
    for tool in (show_metadata, jax_show):
        assert tool.main(["show", url, "--json", *flags]) == 0
        docs.append(json.loads(capsys.readouterr().out))
    assert _normalize(docs[0]) == docs[1]
    assert docs[0]["schema_source"] == "stored"
    if not flags:
        assert [ix["name"] for ix in docs[0]["indexes"]] == ["by_sensor"]


@pytest.mark.parametrize("flags", [[], ["--schema-only"], ["--rowgroups"]],
                         ids=["default", "schema-only", "rowgroups"])
def test_show_metadata_text_equals_the_jax_tools(test_dataset, capsys, flags):
    url, _ = test_dataset
    outs = []
    for tool in (show_metadata, jax_show):
        assert tool.main(["show", url, *flags]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]


def test_show_metadata_of_a_legacy_dataset_equals_the_jax_tools(tmp_path):
    from petastorm_tpu_torch.test_util.legacy_petastorm import make_legacy_dataset

    src, dst = str(tmp_path / "src"), str(tmp_path / "legacy")
    schema = synthetic.TEST_SCHEMA.view(["id", "id2", "image_png", "matrix", "sensor_name"])
    synthetic.create_test_dataset(src, num_rows=20, row_group_size_rows=5, schema=schema)
    make_legacy_dataset(src, dst, schema, index_fields=["id2"])
    port, jax = show_metadata.describe(dst), jax_show.describe(dst)
    assert _normalize(port) == jax
    assert port["schema_source"] == "stored" and port["indexes"][0]["name"] == "id2"


def test_the_tools_name_the_ports_commands():
    assert show_metadata.main.__module__ == "petastorm_tpu_torch.tools.show_metadata"
    assert diagnose.build_parser().prog == "petastorm-tpu-torch-diagnose"
    assert copy_dataset.build_parser().prog == "petastorm-tpu-torch-copy-dataset"
    for module in (show_metadata, copy_dataset, diagnose):
        text = open(module.__file__).read()
        assert not re.search(r"petastorm-tpu-(metadata|copy-dataset|diagnose)\b", text)
    scripts = open(os.path.join(ROOT, "pyproject.toml")).read()
    for name, target in [("metadata", "show_metadata"), ("copy-dataset", "copy_dataset"),
                         ("diagnose", "diagnose")]:
        assert (f'petastorm-tpu-torch-{name} = "petastorm_tpu_torch.tools.{target}:main"'
                in scripts)


# -- copy_dataset ------------------------------------------------------------------------

@pytest.mark.parametrize("kwargs", [
    {}, {"field_regex": ["id", "matrix", "image_png"]}, {"not_null_fields": ["nullable_float"]},
    {"jpeg_quality": 70, "field_regex": ["id", "sensor_name"]}],
    ids=["full", "fields", "not-null", "quality"])
def test_copy_dataset_round_trips_as_the_jax_tools(test_dataset, tmp_path, kwargs):
    url, rows = test_dataset
    port_copy, jax_copy_url = str(tmp_path / "port"), str(tmp_path / "jax")
    n_port = copy_dataset.copy_dataset(url, port_copy, **kwargs)
    n_jax = jax_copy.copy_dataset(url, jax_copy_url, **kwargs)
    assert n_port == n_jax
    if "not_null_fields" in kwargs:
        assert n_port == sum(r["nullable_float"] is not None for r in rows)
    else:
        assert n_port == len(rows)
    got = _rows(make_reader, port_copy)
    assert got == _rows(jax_make_reader, port_copy)
    # the JAX thread pool hands the JAX copy its rows in completion order
    jax_rows = _rows(make_reader, jax_copy_url)
    assert jax_rows == _rows(jax_make_reader, jax_copy_url)
    assert sorted(got, key=lambda r: r["id"]) == sorted(jax_rows, key=lambda r: r["id"])
    assert [r["id"] for r in got] == sorted(r["id"] for r in got)


def test_copy_dataset_cli_and_overwrite_guard(test_dataset, tmp_path, capsys):
    from petastorm_tpu_torch.errors import SchemaError

    url, rows = test_dataset
    target = str(tmp_path / "cli")
    assert copy_dataset.main([url, target, "--field-regex", "id", "matrix"]) == 0
    assert f"copied {len(rows)} rows" in capsys.readouterr().out
    with pytest.raises(SchemaError, match="already contains"):
        copy_dataset.copy_dataset(url, target)
    assert copy_dataset.copy_dataset(url, target, overwrite_output=True) == len(rows)


# -- diagnose ----------------------------------------------------------------------------

def _diagnose_json(tool, capsys, args):
    assert tool.main(args) == 0
    return json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("extra", [[], ["--method", "row"], ["--seed", "5"]],
                         ids=["batch", "row", "seeded"])
def test_diagnose_json_keys_and_stages_equal_the_jax_tools(test_dataset, capsys, extra):
    url, rows = test_dataset
    args = [url, "--json", "--pool-type", "serial", *extra]
    port = _diagnose_json(diagnose, capsys, args)
    jax = _diagnose_json(jax_diagnose, capsys, args)
    assert sorted(port) == sorted(jax)
    assert (port["rows"], port["batches"]) == (jax["rows"], jax["batches"])
    assert port["rows"] == len(rows)
    assert port["dominant_stage"] == jax["dominant_stage"]
    assert port["stream_digest"] == jax["stream_digest"]
    assert port["liveness"] == jax["liveness"]
    assert port["quarantined_rowgroups"] == jax["quarantined_rowgroups"] == []
    for part in ("counters", "histograms"):
        assert sorted(port["snapshot"][part]) == sorted(jax["snapshot"][part]), part
    stages = [k for k in port["snapshot"]["counters"] if k.startswith("stage.")]
    assert stages and all(port["snapshot"]["counters"][k] == jax["snapshot"]["counters"][k]
                          for k in stages if k.endswith(".count"))


def test_diagnose_synthetic_writes_the_jax_tools_dataset(capsys):
    args = ["--synthetic", "--rows", "30", "--row-group-size", "10", "--json",
            "--pool-type", "serial", "--seed", "1"]
    port = _diagnose_json(diagnose, capsys, args)
    jax = _diagnose_json(jax_diagnose, capsys, args)
    assert port["rows"] == jax["rows"] == 30
    assert port["snapshot"]["counters"]["stage.decode.count"] == 3
    assert port["stream_digest"] == jax["stream_digest"]


def test_diagnose_trace_out_and_text_report(test_dataset, tmp_path, capsys):
    url, rows = test_dataset
    trace = tmp_path / "trace.json"
    assert diagnose.main([url, "--pool-type", "thread", "-w", "2", "--stream-digest",
                          "--trace-out", str(trace)]) == 0
    out = capsys.readouterr().out
    assert f"read {len(rows)} rows" in out and "liveness: OK" in out
    assert re.search(r"^stream_digest mode=\S+ combined=", out, re.M)
    assert any(e.get("name") == "decode" for e in json.loads(trace.read_text())["traceEvents"])


def test_diagnose_watch_is_bounded_by_its_duration(test_dataset, capsys):
    url, _ = test_dataset
    rc = diagnose.main([url, "--watch", "--interval", "0.2", "--duration", "3",
                        "--workers-count", "2", "--num-epochs", "0"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "petastorm-tpu watch" in out and "watch finished" in out
    assert "dominant stage" in out


def test_diagnose_refuses_watch_with_json(capsys):
    for tool in (diagnose, jax_diagnose):
        with pytest.raises(SystemExit):
            tool.main(["--synthetic", "--watch", "--json"])
    assert capsys.readouterr().err.count("--watch and --json are incompatible") == 2


_PLANNER = {"knobs": {"workers": {"value": 4, "source": "profile",
                                  "why": "recorded flight profile"},
                      "prefetch": {"value": 2, "source": "default",
                                   "why": "static default depth"}},
            "profile": {"written_at": 1.0, "observed_rows_per_sec": 1234.0,
                        "knobs": {"workers": 4}},
            "profile_path": "/tmp/p.json"}

_POINTS = {
    "stages and faults": (
        {"t": 5.0, "dt_s": 1.0,
         "counters": {"reader.rows_emitted": 500, "errors.skipped_rowgroups": 2,
                      "autotune.moves": 1},
         "rates": {"reader.rows_emitted": 100.0, "reader.batches_consumed": 10.0,
                   "queue.results_empty_wait_s": 0.8, "queue.input_full_wait_s": 0.1},
         "gauges": {"pool.results_queue_depth": 3.0, "pool.in_queue_depth": 1.0},
         "stages": {"decode": {"count": 50, "rate_per_s": 10.0, "busy_frac": 1.9,
                               "p50_s": 0.01, "p99_s": 0.1},
                    "transform": {"count": 0, "rate_per_s": 0.0, "busy_frac": 0.0,
                                  "p50_s": None, "p99_s": None},
                    "custom": {"count": 2, "rate_per_s": 2.0, "busy_frac": 0.1,
                               "p50_s": None, "p99_s": 0.2}}},
        {"workers_busy": [(0, 7, 2.5), (1, 8, 0.5)], "consumed_items": 49,
         "expected_items": 60, "requeued_items": 1, "hedged_items": 0,
         "hung_workers_killed": 0, "skipped_rowgroups": 2, "planner": _PLANNER}),
    "cache": (
        {"dt_s": 1.0, "rates": {"reader.rows_emitted": 100.0, "cache.hits": 12.0,
                                "cache.misses": 3.0},
         "counters": {"reader.rows_emitted": 100, "cache.hits": 12, "cache.misses": 3,
                      "cache.evictions": 2, "cache.transform_hits": 4},
         "gauges": {"cache.hit_rate": 0.8, "cache.bytes": 64 * 2 ** 20}, "stages": {}},
        None),
    "service and hops": (
        {"dt_s": 2.0, "rates": {"service.results": 4.0, "service.frame_bytes_received": 9000.0},
         "counters": {"service.results": 8, "service.frames_binary": 6,
                      "service.frames_shm": 2, "service.requeued_items": 1},
         "gauges": {"service.connected": 1.0},
         "hops": {"worker_exec": {"count": 4, "p50_s": 0.004, "p99_s": 0.02},
                  "total": {"count": 4, "p50_s": 0.01, "p99_s": 0.05},
                  "odd_hop": {"count": 1, "p50_s": None, "p99_s": None}}},
        {"consumed_items": 3}),
    "service, nothing yet": ({"dt_s": 1.0, "rates": {}, "counters": {},
                              "gauges": {"service.connected": 0.0}}, None),
    "empty": ({"dt_s": 1.0}, None),
}


@pytest.mark.parametrize("name", sorted(_POINTS))
def test_a_watch_frame_equals_the_jax_tools(name):
    point, diag = _POINTS[name]
    got = diagnose.render_watch_frame(copy.deepcopy(point), copy.deepcopy(diag), elapsed_s=5.0)
    want = jax_diagnose.render_watch_frame(copy.deepcopy(point), copy.deepcopy(diag),
                                           elapsed_s=5.0)
    assert got == want
    assert got.startswith("== petastorm-tpu watch")


def test_a_watch_frame_from_a_live_sampler_point_equals_the_jax_tools(test_dataset):
    url, _ = test_dataset
    with make_reader(url, reader_pool_type="serial", sample_interval_s=0.05,
                     telemetry=__import__("petastorm_tpu_torch.telemetry",
                                          fromlist=["Telemetry"]).Telemetry()) as r:
        for _ in r:
            pass
        point = r.sampler.sample_now() if r.sampler is not None else None
        diag = r.diagnostics
    assert point is not None
    assert (diagnose.render_watch_frame(point, diag, 1.0)
            == jax_diagnose.render_watch_frame(point, diag, 1.0))


def test_the_verdicts_equal_the_jax_tools():
    autotune = {"moves_applied": 2, "moves_kept": 1, "moves_reverted": 1,
                "knobs": {"workers": 6, "results_queue": 8},
                "decisions": [{"action": "grow", "knob": "workers", "from": 4, "to": 6,
                               "reason": "decode-bound", "outcome": "kept",
                               "measured_rate": 1520.4},
                              {"action": "grow", "knob": "results_queue", "from": 8,
                               "to": 16, "reason": "consumer", "outcome": "reverted",
                               "measured_rate": None}]}
    liveness = [{"slowest_inflight_age_s": 0.0},
                {"hung_workers_killed": 1, "hung_workers_abandoned": 2, "hedged_items": 3,
                 "hedge_wins": 1, "circuit_opens": 2, "circuit_open_quarantines": 1,
                 "circuit_breaker": {"state": "open"}, "slowest_inflight_age_s": 4.25}]
    digests = [(None, None), ({"combined": 12, "batches": 3, "rows": 30,
                               "epochs": {1: 5, 0: 7}}, "seed")]
    for planner in (_PLANNER, {**_PLANNER, "profile": None}, {"knobs": {}}):
        for compact in (False, True):
            assert (diagnose.render_planner_verdict(planner, compact)
                    == jax_diagnose.render_planner_verdict(planner, compact))
    assert (diagnose.render_autotune_verdict(autotune)
            == jax_diagnose.render_autotune_verdict(autotune))
    for live in liveness:
        assert (diagnose.render_liveness_verdict(live)
                == jax_diagnose.render_liveness_verdict(live))
    for digest, mode in digests:
        assert (diagnose.render_stream_digest(digest, mode)
                == jax_diagnose.render_stream_digest(digest, mode))


def test_diagnose_planner_and_autotune_run_as_in_the_jax_tool(test_dataset, tmp_path):
    url, _ = test_dataset
    result = diagnose.run_diagnosis(url, workers_count=2, autotune=True,
                                    sample_interval_s=0.1,
                                    cache_location=str(tmp_path / "loc"))
    want = jax_diagnose.run_diagnosis(url, workers_count=2, autotune=True,
                                      sample_interval_s=0.1,
                                      cache_location=str(tmp_path / "jloc"))
    assert result["rows"] == want["rows"] == 40
    assert sorted(result["planner"]["knobs"]) == sorted(want["planner"]["knobs"])
    assert (result["planner"]["knobs"]["workers"]["source"]
            == want["planner"]["knobs"]["workers"]["source"] == "pinned")
    assert sorted(result["autotune"]) == sorted(want["autotune"])


# -- synthetic data, the reader mock, the stub workers -----------------------------------

@pytest.mark.parametrize("seed", [0, 1234])
def test_create_test_dataset_writes_the_jax_packages_rows(tmp_path, seed):
    port = synthetic.create_test_dataset(str(tmp_path / "p"), num_rows=25,
                                         row_group_size_rows=7, seed=seed)
    jax = jax_synthetic.create_test_dataset(str(tmp_path / "j"), num_rows=25,
                                            row_group_size_rows=7, seed=seed)

    def plain(rows):
        return [{k: _plain(v) for k, v in r.items()} for r in rows]

    assert plain(port) == plain(jax)
    assert ([(f.name, f.dtype, f.shape, type(f.codec).__name__, f.nullable)
             for f in synthetic.TEST_SCHEMA]
            == [(f.name, f.dtype, f.shape, type(f.codec).__name__, f.nullable)
                for f in jax_synthetic.TEST_SCHEMA])
    assert (_rows(make_reader, str(tmp_path / "p"))
            == _rows(jax_make_reader, str(tmp_path / "j")))


def test_synthetic_jpeg_bytes_equal_the_jax_packages():
    port = synthetic.synthetic_jpeg_bytes(3, 24, 32, quality=85)
    assert port == jax_synthetic.synthetic_jpeg_bytes(3, 24, 32, quality=85)
    assert all(b[:2] == b"\xff\xd8" for b in port)


def test_the_reader_mock_draws_the_jax_mocks_rows():
    view = ["id", "matrix", "sensor_name", "python_primitive_uint8"]
    port = reader_mock.ReaderMock(synthetic.TEST_SCHEMA.view(view), batch_size=4,
                                  num_batches=3, seed=9)
    jax = jax_reader_mock.ReaderMock(jax_synthetic.TEST_SCHEMA.view(view), batch_size=4,
                                     num_batches=3, seed=9)
    got, want = list(port), list(jax)
    assert len(got) == len(want) == 12 and port.last_row_consumed
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    port.reset()
    jax.reset()
    for a, b in zip(port.iter_batches(), jax.iter_batches()):
        for name in b.columns:
            np.testing.assert_array_equal(a.columns[name], b.columns[name])
    assert port.diagnostics == jax.diagnostics == {"produced_batches": 3}


def test_the_stub_workers_compute_what_the_jax_ones_do():
    for cls, args, items in [("MultiplierWorker", (3,), [1, 2, 5]),
                             ("SleepyWorker", (0.001,), [4, 6]),
                             ("ExplodingWorker", (13,), [1, 12]),
                             ("BlockingWorker", (threading.Event(), 1), [2, 3])]:
        port = getattr(stub_workers, cls)(*args)()
        jax = getattr(jax_stub_workers, cls)(*args)()
        assert [port(x) for x in items] == [jax(x) for x in items]
    for module in (stub_workers, jax_stub_workers):
        with pytest.raises(RuntimeError, match="boom on 13"):
            module.ExplodingWorker(13)()(13)
    assert stub_workers.PidWorker()()(0) == os.getpid()
