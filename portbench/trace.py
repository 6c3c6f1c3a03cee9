"""A profiled stretch of a run and its reduction to device facts.

:func:`profile_stretch` runs ``warm`` units and then ``units`` units of a job
with ``torch.profiler`` recording the device's activity alone (CUDA: kernels,
copies, memsets; the host's operators are not recorded, so the host, which
paces a step of eager launches, runs as it does in the window).  What the host does is kept by
:func:`host_range` on the host's own clock: each unit is a
``portbench.unit`` range, and a job marks its waits for a batch
``portbench.next_batch``.  The stretch opens after the ``warm`` units, which
take the batches the feed ran ahead while the profiler started, and it opens
and closes with a marker kernel launched on an idle device
(``torch.cuda._sleep``), which bounds the stretch on the device's timeline and
maps the host's ranges onto it.
:func:`reduce_events` turns the events into:

- ``window_s``: the stretch's length, from the first marker to the last;
- ``busy_s``: the union of the intervals in which a kernel, copy or memset
  ran on the device (the markers left out);
- ``kernels``: device seconds by kernel name;
- ``idle_gaps``: each gap between busy intervals longer than 20 us, named by
  the innermost ``portbench.*`` host range running at its midpoint.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

GAP_FLOOR_S = 20e-6
MARKER = "spin_kernel"      # torch.cuda._sleep's kernel
MARKER_CYCLES = 1000
TAIL_S = 0.05               # host time between the last marker and the profiler's stop

_ranges: Optional[List[Tuple[str, int, int]]] = None   # the recording stretch's host ranges


@contextlib.contextmanager
def host_range(name: str):
    """Record ``name`` over the block on the host's clock while a stretch is
    profiled; costs a test of one global otherwise."""
    if _ranges is None:
        yield
        return
    start = time.perf_counter_ns()
    try:
        yield
    finally:
        _ranges.append((name, start, time.perf_counter_ns()))


def _device_events(prof) -> List[Tuple[str, int, int]]:
    """``(name, start ns, end ns)`` of every event that ran on the device."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CPU or e.is_user_annotation():
            continue  # host work, or a host range mirrored on the device's timeline
        start = e.start_ns()
        out.append((e.name(), start, start + e.duration_ns()))
    return out


def reduce_events(events: List[Tuple[str, bool, int, int]], stretch: Tuple[int, int]) -> Dict:
    """Device facts of ``events`` (``(name, on the device, start ns, end
    ns)``; host events are the ``portbench.*`` ranges) inside ``stretch``
    (start, end ns), all on one timeline."""
    lo, hi = stretch
    device = sorted((max(s, lo), min(e, hi), name) for name, dev, s, e in events
                    if dev and e > lo and s < hi)
    kernels: Dict[str, float] = {}
    for s, e, name in device:
        kernels[name] = kernels.get(name, 0.0) + (e - s) / 1e9
    merged: List[List[int]] = []
    for s, e, _ in device:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged) / 1e9
    ranges = sorted((s, e, name) for name, dev, s, e in events
                    if not dev and name.startswith("portbench."))
    gaps = []
    edges = [lo] + [x for pair in merged for x in pair] + [hi]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if (g1 - g0) / 1e9 < GAP_FLOOR_S:
            continue
        mid = (g0 + g1) // 2
        inner = [r for r in ranges if r[0] <= mid < r[1]]
        # the innermost range: the latest to start, then the first to end
        label = (max(inner, key=lambda r: (r[0], -r[1]))[2] if inner
                 else "outside portbench ranges")
        gaps.append((label, (g1 - g0) / 1e9))
    gaps.sort(key=lambda g: -g[1])
    return {"window_s": (hi - lo) / 1e9, "busy_s": busy, "kernels": kernels,
            "idle_gaps": gaps}


def profile_stretch(unit: Callable[[], int], units: int, device, warm: int = 0,
                    count: Callable[[], int] = lambda: 0) -> Dict:
    """Run ``warm`` and then ``units`` calls of ``unit`` with the device's
    activity profiled; the stretch is the ``units`` calls.  Returns
    :func:`reduce_events`' facts, ``units``, ``ms_per_unit`` (the stretch's
    length over its units, to hold beside the window's) and ``counts``,
    ``count()`` at the stretch's two ends."""
    from torch.profiler import ProfilerActivity, profile

    global _ranges
    cuda = torch.device(device).type == "cuda"

    def marker() -> int:
        """Launch the marker on an idle device; the host's time of the launch."""
        torch.cuda.synchronize(device)
        launched = time.perf_counter_ns()
        torch.cuda._sleep(MARKER_CYCLES)
        return launched

    activities = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    _ranges = []
    try:
        with profile(activities=activities) as prof:
            for _ in range(warm):
                unit()
            first = marker() if cuda else time.perf_counter_ns()
            counts = [count()]
            for _ in range(units):
                with host_range("portbench.unit"):
                    unit()
            last = marker() if cuda else time.perf_counter_ns()
            counts.append(count())
            if cuda:
                torch.cuda.synchronize(device)
            # the profiler can drop a kernel that ends right at its stop
            time.sleep(TAIL_S)
        ranges = _ranges
    finally:
        _ranges = None
    device_events = _device_events(prof) if cuda else []
    events = [(name, True, s, e) for name, s, e in device_events if MARKER not in name]
    offset = _offset(sorted(s for name, s, _ in device_events if MARKER in name),
                     first, last, max((e[2] for e in events), default=0)) if cuda else 0
    stretch = (first + offset, last + offset)
    events += [(name, False, s + offset, e + offset) for name, s, e in ranges]
    facts = reduce_events(events, stretch)
    facts["units"], facts["counts"] = units, counts
    facts["ms_per_unit"] = 1e3 * facts["window_s"] / units
    return facts


def _offset(marks: List[int], first: int, last: int, latest: int) -> int:
    """The host's clock onto the device's timeline: a marker starts as it is
    launched on an idle device (a launch's latency, some us).  With one of the
    two markers lost, the one left is the first if device work follows it."""
    if not marks:
        raise RuntimeError("the profiler recorded neither of the stretch's markers")
    if len(marks) == 1 and marks[0] > latest:
        return marks[0] - last
    return marks[0] - first


def kernel_seconds(facts: Dict, *fragments: str) -> Optional[float]:
    """Device seconds of the kernels whose name holds any of ``fragments``;
    None when the stretch ran none."""
    total = sum(t for name, t in facts.get("kernels", {}).items()
                if any(f in name for f in fragments))
    return total if total > 0 else None
