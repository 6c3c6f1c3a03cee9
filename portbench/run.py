"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything the run needs is found by name from ``BENCHMARK.json``: the
cell's configuration (``portbench/configs/<config>.json``), its traffic
(``portbench/traffic/<traffic>.json``), its limits
(``portbench/limits/<cell>.json``), the configuration's job
(``portbench/jobs/<job>.py``) and each per-layer metric's reader
(``portbench/metrics/<metric>.py``).

A run: write the corpus from the seed into a fresh directory under
``TMPDIR``; set the job up (the program's reader, loader and model with the
benchmark's weights, its first steps, its warm-up); measure for
``--seconds`` (each unit's end an event on the card, the window closed by
a synchronise); with ``--trace 1`` also a profiled stretch after the window;
read the peak memory, free the program, run the plain reference and compare;
print one JSON line last on standard output, and each compared number with
its limit last on standard error.  Exits 2 without a result when no CUDA
card (or fewer than the cell asks for) is there, or when JAX or the JAX
package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from typing import Dict, List  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "petastorm_tpu")


class Refused(Exception):
    """The run cannot give a result (no card, a forbidden module)."""


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def find(root: str, kind: str, name: str, suffix: str) -> str:
    """``<root>/portbench/<kind>/<name><suffix>``, else this checkout's."""
    for base in dict.fromkeys((root, ROOT)):
        path = os.path.join(base, "portbench", kind, name + suffix)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no portbench/{kind}/{name}{suffix} under {root} or {ROOT}")


def load_cell(name: str, root: str = ROOT) -> Dict:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` and its files: ``cell``,
    ``config``, ``traffic``, ``limits``, ``spec`` (the whole file)."""
    spec = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {c["name"]: c for c in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json ({sorted(cells)})")
    cell = cells[name]
    return {"spec": spec, "cell": cell,
            "config": load_json(find(root, "configs", cell["config"], ".json")),
            "traffic": load_json(find(root, "traffic", cell["traffic"], ".json")),
            "limits": load_json(find(root, "limits", name, ".json"))}


def load_metric(name: str, root: str = ROOT):
    """The reader module of per-layer metric ``name``."""
    path = find(root, "metrics", name, ".py")
    module_spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module


def cell_metrics(spec: Dict, cell: str, section: str) -> List[Dict]:
    """The metrics of ``section`` this cell reports: those that list it, and
    those without a list whose moved metric (per-layer) or which
    (end-to-end) the cell reports."""
    e2e = [m for m in spec["end_to_end"] if "workloads" not in m or cell in m["workloads"]]
    if section == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if cell in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in names)]


def foreign_modules() -> List[str]:
    """Modules of JAX or the JAX package loaded in this process, by whole
    top-level name (``petastorm_tpu_torch`` is not ``petastorm_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def note(text: str) -> None:
    print(f"portbench: {text}", file=sys.stderr, flush=True)


def units_by_sixth(intervals_ms: List[float]) -> List[int]:
    """How many units ended in each sixth of the window's span of unit ends:
    a drift within the window shows as a trend."""
    import numpy as np

    if not intervals_ms:
        return []
    ends = np.cumsum(intervals_ms)
    return np.bincount(np.minimum((6 * ends / ends[-1]).astype(int), 5), minlength=6).tolist()


class Clock:
    """Unit ends: events on the card's current stream, or the host's clock."""

    def __init__(self, device):
        import torch

        self.torch = torch
        self.cuda = torch.device(device).type == "cuda"
        self.device = device
        self.marks: List[object] = []

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize(self.device)

    def mark(self) -> None:
        if self.cuda:
            ev = self.torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> List[float]:
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        return [1e3 * (b - a) for a, b in zip(self.marks, self.marks[1:])]


def measure(job, seconds: float, device) -> Dict:
    """The window: units until ``seconds`` have passed on the host's clock,
    then a synchronise, which ends it."""
    clock = Clock(device)
    clock.sync()
    wait0 = job.wait_s()
    clock.mark()
    t0 = time.perf_counter()
    samples = units = 0
    while time.perf_counter() - t0 < seconds:
        samples += job.unit()
        units += 1
        clock.mark()
    clock.sync()
    window_s = time.perf_counter() - t0
    return {"window_s": window_s, "samples": samples, "units": units,
            "intervals_ms": clock.intervals_ms(), "input_wait_s": job.wait_s() - wait0}


def decode_counters(tele) -> Dict[str, float]:
    reg = tele.registry
    return {"busy_s": reg.counter("stage.decode.busy_s").value,
            "items": reg.counter("stage.decode.count").value}


def trace_record(ctx, job, device) -> Dict:
    """The traced run's raw facts after the window: the decode spans of the
    window, a profiled stretch and the work of the kernels in it."""
    from portbench import roofline, trace

    job.forget()
    warm = job.trace_units // 2
    facts = trace.profile_stretch(job.unit, job.trace_units, device, warm=warm,
                                  count=job.staged_units)
    staged0, staged1 = facts["counts"]
    while job.delivered < staged1:  # the batches the stretch staged ahead
        job.pull()
    corpus = ctx.corpus
    b2 = {"bytes": 0.0, "flops": 0.0}
    for ids in job.pulled[staged0 - job.pulled_from:staged1 - job.pulled_from]:
        for row in ids.cpu().numpy():
            work = roofline.jpeg_work(int(corpus.heights[row]), int(corpus.widths[row]),
                                      corpus.sampling(row))
            b2 = {k: b2[k] + work[k] for k in b2}
    facts["work"] = {"b3": job.crop_work(warm, warm + facts["units"]), "b2": b2}
    return facts


def run_cell(name: str, seed: int, seconds: float, traced: bool, device=None,
             root: str = ROOT, control=None) -> Dict:
    """One run of cell ``name``; returns the result line's object.  ``device``
    None takes ``cuda`` and refuses without enough cards.  ``control``: a
    lower precision for the reference's products (``reference.resnet.FP8``);
    the result then also holds ``control``, the numbers of the reference so
    computed put in the program's place, and ``control_correct``, their
    verdict against the cell's limits."""
    files = load_cell(name, root)
    cell, config = files["cell"], files["config"]
    import torch

    from portbench import check, roofline
    from portbench.corpus import write_corpus
    from portbench.feed import Context, sub_seed

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            raise Refused(f"the cell asks for {cell['chips']} CUDA card(s);"
                          f" torch sees {torch.cuda.device_count()}")
        device = "cuda"
    device = torch.device(device)
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        t0 = time.perf_counter()
        corpus = write_corpus(config["corpus"], int(config["rows"]), sub_seed(seed, "corpus"),
                              tmp)
        note(f"corpus: {corpus.rows} rows, mean stream {corpus.mean_stream_bytes():.0f} bytes,"
             f" written in {time.perf_counter() - t0:.2f} s")
        tele = None
        if traced:
            from petastorm_tpu_torch.telemetry import Telemetry

            tele = Telemetry()
        ctx = Context(config, files["traffic"], seed, device, corpus, tele)
        job = importlib.import_module(f"portbench.jobs.{config['job']}").Job(ctx)
        job.setup()
        Clock(device).sync()
        setup_s = time.perf_counter() - T_START
        job.forget()
        decode0 = decode_counters(tele) if tele else None
        window = measure(job, seconds, device)
        record = {"kind": job.kind, "window": window,
                  "samples_per_s": window["samples"] / window["window_s"],
                  "flops_per_sample": job.flops_per_sample(),
                  "peak_flops": roofline.BF16_FLOPS_PER_S}
        if traced:
            decode1 = decode_counters(tele)
            record["decode"] = {k: decode1[k] - decode0[k] for k in decode1}
            record["decode"]["rows_per_item"] = int(config["corpus"]["rows_per_group"])
            record["trace"] = trace_record(ctx, job, device)
        peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
        note(job.pool_note())
        job.close()
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        reference = job.reference_numbers()
        numbers = job.compare(job.program_numbers(), reference)
        correct = check.judge(numbers, files["limits"])
        if control is not None:
            controlled = job.compare(job.reference_numbers(control), reference)
            control_correct = check.judge(controlled, files["limits"])
        unanswered = job.unanswered()
        correct = correct and unanswered == 0
        note(f"setup {setup_s:.2f} s, window {window['window_s']:.2f} s, reference and check"
             f" {time.perf_counter() - t0:.2f} s; units a sixth of the window:"
             f" {units_by_sixth(window['intervals_ms'])}")
        if traced:
            note(f"ms a unit: window {1e3 * window['window_s'] / max(window['units'], 1):.1f},"
                 f" profiled stretch {record['trace']['ms_per_unit']:.1f}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    candidates = {"setup_s": ("s", setup_s),
                  job.rate_metric: ("samples/s", record["samples_per_s"])}
    metrics: Dict[str, Dict] = {}
    if traced:
        for entry in cell_metrics(files["spec"], name, "per_layer"):
            value = load_metric(entry["name"], root).read(record)
            if value is not None:
                metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    else:
        for entry in cell_metrics(files["spec"], name, "end_to_end"):
            if entry["name"] in candidates:
                unit, value = candidates[entry["name"]]
                metrics[entry["name"]] = {"value": value, "unit": unit}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": int(window["samples"]),
              "failed": int(unanswered), "metrics": metrics, "device": dev}
    if traced:
        facts = record["trace"]
        dev["busy_s"], dev["window_s"] = facts["busy_s"], facts["window_s"]
        ops = sorted(facts["kernels"].items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [[n[:160], t] for n, t in ops],
                               "idle_gaps": [[n, t] for n, t in facts["idle_gaps"][:10]]}
    if control is not None:
        result["control"] = controlled
        result["control_correct"] = bool(control_correct)
    result["checks"] = numbers
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    if args.seed < 0:
        parser.error("--seed must be >= 0")
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
        found = foreign_modules()
        if found:
            raise Refused(f"modules of JAX or the JAX package were loaded: {found}")
    except Refused as exc:
        note(f"no result: {exc}")
        return 2
    for number, entry in result["checks"].items():
        print(f"check {number} {entry['value']!r} limit {entry['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
