"""Whole runs of the harness on the CPU at a tiny size (the plain versions
of the port's kernels): the result line, the correctness check against its
control and the planted faults, and a configuration, a cell and a metric
that exist only under this directory."""

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import check, controls, run
from portbench.reference import resnet as ref_resnet

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixture")
SEED = 2**40 + 17


def tiny(cell, seconds=1.0, traced=False, control=None):
    return run.run_cell(cell, SEED, seconds, traced, device="cpu", root=FIXTURE, control=control)


@pytest.fixture(scope="module")
def train_run():
    return tiny("tiny_train.host", traced=True, control=ref_resnet.FP8)


@pytest.fixture(scope="module")
def eval_run():
    return tiny("tiny_eval.host", seconds=2.0, traced=True, control=ref_resnet.FP8)


def test_a_sound_training_run_is_correct_and_reports_its_metrics(train_run):
    assert train_run["correct"] is True and train_run["failed"] == 0
    assert list(train_run) == ["correct", "attempted", "failed", "metrics", "device",
                               "breakdown", "control", "control_correct", "checks"]
    # a configuration, a cell and a metric that exist only under portbench/tests/
    assert train_run["metrics"]["rows_per_unit"] == {"value": 8.0, "unit": "rows"}
    assert {"decode_ms_per_row.train", "mfu.train"} <= set(train_run["metrics"])
    assert set(train_run["checks"]) == {"loss_gap", "grad1_gap", "delta3_gap"}
    assert train_run["checks"]["grad1_gap"]["leaves"] > 0


def test_the_training_control_fails(train_run):
    limits = run.load_cell("tiny_train.host", FIXTURE)["limits"]
    assert not check.judge(train_run["control"], limits)
    assert train_run["control_correct"] is False


def test_an_evaluation_run_answers_every_sampled_row(eval_run):
    assert eval_run["correct"] is True and eval_run["failed"] == 0
    assert eval_run["checks"]["logit_gap"]["rows"] == 8
    assert set(eval_run["metrics"]) == {"input_wait_pct.eval", "mfu.eval"}
    limits = run.load_cell("tiny_eval.host", FIXTURE)["limits"]
    assert not check.judge(eval_run["control"], limits)
    assert eval_run["control_correct"] is False


def test_the_untraced_run_prints_its_end_to_end_metrics():
    result = tiny("tiny_train.mixed")
    assert result["correct"] is True
    assert set(result["metrics"]) == {"train_samples_per_s", "setup_s"}
    assert result["device"] == {"platform": "cpu", "kind": "cpu", "count": 1,
                                "memory_peak_bytes": 0}


@pytest.mark.parametrize("cell, fault", [("tiny_train.host", "half_batch"),
                                         ("tiny_train.host", "unchanged"),
                                         ("tiny_eval.host", "altered_answers")])
def test_a_planted_fault_is_not_correct(cell, fault):
    with controls.planted(fault):
        result = tiny(cell, seconds=2.0)
    assert result["correct"] is False


def test_the_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "rn50_eval.host",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=run.ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [c["name"] for c in run.load_json(
    os.path.join(run.ROOT, "BENCHMARK.json"))["workloads"]])
def test_the_control_fails_at_the_cells_size_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the cells run the port's kernels")
    result = run.run_cell(cell, 2**35 + 1, 9.0, False, control=ref_resnet.FP8)
    assert result["correct"] is True
    assert not check.judge(result["control"], run.load_cell(cell)["limits"])
    assert result["control_correct"] is False
    json.dumps(result)
