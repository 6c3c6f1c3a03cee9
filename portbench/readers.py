"""The reductions the per-layer metrics share: from a traced run's record
(``run.py``: the window, the decode spans' counters over it, the profiled
stretch after it and the work of its kernels) to one number, or None where
the run has nothing to read."""

from __future__ import annotations

from typing import Dict, Optional

from portbench import roofline, trace

B3_KERNELS = ("resized_crop", "resample_")   # the tiled crop; the separable pair
B2_KERNELS = ("jpeg_decode",)


def decode_ms_per_row(record: Dict) -> Optional[float]:
    """The workers' ``decode`` stage seconds in the window over the rows they
    decoded (a stage span covers a rowgroup's read and decode)."""
    decode = record.get("decode")
    if not decode or not decode["items"]:
        return None
    return 1e3 * decode["busy_s"] / (decode["items"] * decode["rows_per_item"])


def input_wait_pct(record: Dict) -> Optional[float]:
    """The loader's ``consumer_wait_s`` over the window, as a share of it."""
    window = record["window"]
    return 100.0 * window["input_wait_s"] / window["window_s"]


def mfu_pct(record: Dict) -> Optional[float]:
    """The model's operations a sample at the window's rate, as a share of
    the chip's bf16 peak."""
    return 100.0 * record["flops_per_sample"] * record["samples_per_s"] / record["peak_flops"]


def device_idle_pct(record: Dict) -> Optional[float]:
    """The share of the profiled stretch in which nothing ran on the device."""
    facts = record.get("trace")
    if not facts or facts["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - facts["busy_s"] / facts["window_s"])


def roofline_pct(record: Dict, work: str, kernels) -> Optional[float]:
    """The least time of the stretch's ``work`` over its kernels' device time."""
    facts = record.get("trace")
    if not facts:
        return None
    seconds = trace.kernel_seconds(facts, *kernels)
    amount = facts["work"].get(work)
    if seconds is None or not amount or not amount["bytes"]:
        return None
    return 100.0 * roofline.least_seconds(amount) / seconds
