"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name: configurations, traffic, limits and metric readers."""

import json
import os
import re

import pytest

from portbench import run

ROOT = run.ROOT
SPEC = run.load_json(os.path.join(ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_command_and_paths():
    assert set(SPEC) == TOP_KEYS
    assert SPEC["paths"] == ["portbench"]
    assert SPEC["command"][:3] == ["python3", "-m", "portbench.run"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_the_check_fits_its_time_with_the_full_24_cells():
    per_run = SPEC["run_seconds"] + 60
    assert (2 + 14 * 24) * per_run + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda e: e["name"])
def test_configuration_entries(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and all(NAME.match(k) for k in entry["reduced"])
    assert entry["file"] == f"portbench/configs/{entry['name']}.json"
    config = run.load_json(os.path.join(ROOT, entry["file"]))
    assert config["name"] == entry["name"] and config["source"] == entry["source"]
    assert config["reduced"] == entry["reduced"]
    assert all(k in config for k in entry["reduced"])
    assert any(c["config"] == entry["name"] for c in SPEC["workloads"])


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_every_cell_loads_its_files_by_name(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and cell["chips"] in (1, 4) and len(cell["why"]) <= 200
    files = run.load_cell(cell["name"])
    assert files["config"]["name"] == cell["config"]
    assert files["traffic"]["name"] == cell["traffic"]
    assert os.path.exists(os.path.join(ROOT, "portbench", "jobs", f"{files['config']['job']}.py"))
    numbers = {"train": {"loss_gap", "grad1_gap", "delta3_gap"}, "eval": {"logit_gap"}}
    assert set(files["limits"]) == numbers[files["config"]["job"]]
    e2e = {m["name"] for m in run.cell_metrics(SPEC, cell["name"], "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert run.cell_metrics(SPEC, cell["name"], "per_layer")


def test_cells_are_distinct_pairs_and_at_most_a_quarter_on_four_chips():
    pairs = [(c["config"], c["traffic"]) for c in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert sum(c["chips"] == 4 for c in SPEC["workloads"]) <= max(1, len(pairs) // 4)


@pytest.mark.parametrize("metric", SPEC["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metrics(metric):
    assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25


def test_the_end_to_end_metrics_are_the_rates_and_set_up():
    assert {m["name"] for m in SPEC["end_to_end"]} == {
        "train_samples_per_s", "eval_samples_per_s", "setup_s"}


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metrics_have_readers_that_agree(metric):
    assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["source"] in SOURCES and metric["better"] in ("lower", "higher")
    reader = run.load_metric(metric["name"])
    assert (reader.LAYER, reader.UNIT, reader.MOVES) == (
        metric["layer"], metric["unit"], metric["moves"])
    for cell in metric.get("workloads", ()):
        e2e = {m["name"] for m in run.cell_metrics(SPEC, cell, "end_to_end")}
        assert metric["moves"] in e2e, f"{cell} does not report {metric['moves']}"
    if "roofline" in metric["name"] or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_metric_and_cell_names_are_unique():
    for section in ("configs", "workloads"):
        names = [e["name"] for e in SPEC[section]]
        assert len(set(names)) == len(names)
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(names)) == len(names)


def test_one_layer_name_per_layer():
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert all("\n" not in x and "\t" not in x and len(x) <= 200 for x in layers)
    assert layers <= {reader.LAYER for reader in
                      (run.load_metric(m["name"]) for m in SPEC["per_layer"])}


def test_a_metric_missing_its_file_is_not_found():
    with pytest.raises(FileNotFoundError):
        run.load_metric("no_such_metric")


def test_the_spec_round_trips_through_json():
    assert json.loads(json.dumps(SPEC)) == SPEC
