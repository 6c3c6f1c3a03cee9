"""Closed-loop pipeline autotuning: runtime-adaptive workers, queue bounds,
prefetch depth, the warm tier's residency and the live decode split, driven
by the live metrics sampler.

The port's copy of ``petastorm_tpu/autotune.py:78-642``: the same policy,
knobs, thresholds and decision log, so one scripted sampler series and one
clock give both packages the same decisions.

:class:`AutotuneController` runs a background thread over the reader's
sampler time-series and actuates these knobs:

* **workers** - ``ThreadedExecutor.resize_workers`` (threads spawn/retire in
  place) or ``ProcessExecutor.resize_workers`` (grow spawns into spare
  slots, shrink retires a slot at its next item boundary);
* **results_queue** - ``ThreadedExecutor.set_results_bound`` (the resizable
  results part of the in-flight window);
* **prefetch** - ``cuda.CudaDataLoader.set_prefetch`` (both producer-stage
  queue bounds), attached when a loader wraps an autotuned reader;
* **cache_mem** - the shared warm tier's L1 residency target
  (``cache_type='shared'``);
* **decode_split** - the live host/device decode split
  (``decode_placement={'image': 'auto'}``).

The policy is bottleneck-directed hill climbing with hysteresis:

1. read the sampled queue-wait rates: ``queue.results_empty_wait_s``
   (consumer starved -> the worker plane is the bottleneck) and
   ``queue.results_full_wait_s`` (workers blocked -> the consumer is);
2. pick ONE move in the indicated direction (grow workers when starved;
   shrink workers / widen the results queue when consumer-bound; gentle
   exploration probes when neither signal dominates);
3. apply it, wait a settle window, then measure delivered samples/s
   (``reader.rows_emitted`` rate) over fresh sampler points and compare to
   the pre-move baseline;
4. REVERT when the move regressed beyond ``revert_threshold`` and block
   that (knob, direction) for ``block_rounds`` decisions - the hysteresis
   that keeps a drifting host from driving oscillation.

Every decision is observable: ``autotune.*`` counters and per-knob gauges
(so the sampler's frames - and therefore flight records - carry the knob
trajectory), a trace event per move, and a bounded decision log in
``Reader.diagnostics['autotune']``.

Usage::

    make_reader(url, autotune=True)              # default policy
    make_reader(url, autotune=AutotunePolicy(max_workers=8))
    make_reader(url, workers_count='auto')       # planner seed + runtime loop
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import threading
import time
from typing import Callable, Dict, List, Optional

from petastorm_tpu_torch.errors import PetastormTpuError

logger = logging.getLogger(__name__)

#: the delivered-throughput counter every move is judged by
THROUGHPUT_COUNTER = "reader.rows_emitted"

#: sentinel distinguishing "evaluation not anchored yet" from "anchored on an
#: empty series" in a pending move (None is a valid anchor)
_UNANCHORED = object()


@dataclasses.dataclass
class AutotunePolicy:
    """Knob bounds, pacing and hysteresis for :class:`AutotuneController`.

    The defaults are deliberately conservative (seconds-scale settle and
    evaluation windows): a decision judged on too few sampler points would
    chase host noise - and the revert machinery only protects against moves it can
    measure.  Tests and benchmarks shrink the windows for speed.
    """

    #: worker-count bounds (the process pool additionally caps growth at its
    #: pre-allocated slot capacity, sized from this max at construction)
    min_workers: int = 1
    max_workers: int = 16
    #: results-queue bound limits (thread pool only; mp queues are fixed)
    min_results_queue: int = 2
    max_results_queue: int = 128
    #: loader prefetch-depth limits (applies once a loader attaches)
    min_prefetch: int = 1
    max_prefetch: int = 16
    #: controller poll cadence (decision opportunities, not decisions)
    tick_s: float = 0.25
    #: leave the pipeline alone this long after start (pipelines ramp)
    warmup_s: float = 3.0
    #: after applying a move, discard this much settling time before judging
    settle_s: float = 2.0
    #: sampler points averaged per throughput measurement (baseline + after)
    eval_points: int = 3
    #: revert a move whose measured rate fell below (1 - this) x baseline
    revert_threshold: float = 0.08
    #: consumer-starved fraction (blocked-seconds/second) that indicates the
    #: worker plane is the bottleneck
    starved_threshold: float = 0.20
    #: workers-blocked-on-full-results fraction indicating a bound consumer
    blocked_threshold: float = 0.20
    #: after a revert, do not retry that (knob, direction) for this many
    #: subsequent decisions (oscillation damping)
    block_rounds: int = 3
    #: pause between decisions after a kept move (2x after a revert)
    cooldown_s: float = 1.0
    #: probe a shrink/grow even without a queue-wait signal (finds optima
    #: that do not show up as queue waits, e.g. GIL contention); reverts
    #: clean up wrong guesses
    explore: bool = True
    #: run the STATIC pipeline planner (petastorm_tpu_torch.planner) at reader
    #: construction: one parquet-footer pass + the recorded per-dataset
    #: flight profile seed the initial knob values, so this runtime loop
    #: starts near the optimum and only fine-tunes (docs/operations.md
    #: "Transform caching & the pipeline planner").  False = the old
    #: explore-from-static-defaults cold start.
    planner: bool = True
    #: knob names the controller must never attach or move ('workers',
    #: 'results_queue', 'prefetch', 'cache_mem', 'decode_split').  Set by
    #: make_reader for knobs whose moves would change delivered CONTENT
    #: rather than just throughput: ``deterministic='seed'`` readers exclude
    #: 'decode_split' - a mid-epoch host<->device flip changes which wire
    #: form each rowgroup ships based on WHEN a worker decoded it, which no
    #: reorder stage can undo (docs/operations.md "Reproducibility")
    exclude_knobs: frozenset = frozenset()

    def __post_init__(self):
        if self.min_workers < 1 or self.max_workers < self.min_workers:
            raise PetastormTpuError(
                "AutotunePolicy needs 1 <= min_workers <= max_workers; got"
                f" [{self.min_workers}, {self.max_workers}]")
        for lo, hi, what in ((self.min_results_queue, self.max_results_queue,
                              "results_queue"),
                             (self.min_prefetch, self.max_prefetch,
                              "prefetch")):
            if lo < 1 or hi < lo:
                raise PetastormTpuError(
                    f"AutotunePolicy needs 1 <= min_{what} <= max_{what};"
                    f" got [{lo}, {hi}]")
        for name in ("tick_s", "warmup_s", "settle_s", "cooldown_s"):
            if getattr(self, name) < 0:
                raise PetastormTpuError(f"AutotunePolicy.{name} must be >= 0")
        if self.eval_points < 1:
            raise PetastormTpuError("AutotunePolicy.eval_points must be >= 1")
        if not 0.0 < self.revert_threshold < 1.0:
            raise PetastormTpuError(
                "AutotunePolicy.revert_threshold must be in (0, 1)")
        if not isinstance(self.exclude_knobs, frozenset):
            # tolerate lists/sets/tuples from callers
            self.exclude_knobs = frozenset(self.exclude_knobs)


def resolve_autotune(autotune, workers_count,
                     reader_pool_type: str) -> Optional[AutotunePolicy]:
    """Normalize ``make_reader(autotune=)`` to a policy or None (off).

    ``True`` -> default policy; an :class:`AutotunePolicy` passes through;
    ``None`` defaults to OFF except for ``workers_count='auto'``, which now
    means "seed from the core-count heuristic AND keep tuning at runtime"
    (``autotune=False`` restores the old static-only 'auto').  The serial
    pool has no worker plane to resize (work runs inline on the consumer),
    so autotune is refused there with a warning.
    """
    if autotune is False:
        return None
    if autotune is True:
        policy = AutotunePolicy()
    elif isinstance(autotune, AutotunePolicy):
        policy = autotune
    elif autotune is None:
        policy = AutotunePolicy() if workers_count == "auto" else None
    else:
        raise PetastormTpuError(
            "autotune must be True/False/None or an AutotunePolicy; got"
            f" {autotune!r}")
    if policy is not None and reader_pool_type in ("serial", "dummy"):
        logger.warning(
            "autotune is inoperative with reader_pool_type='serial' (work"
            " runs inline on the consumer thread; there is no worker plane"
            " or queue bound to tune) - running untuned")
        return None
    return policy


class _Knob:
    """One actuatable pipeline parameter: name, accessor, applier, bounds."""

    __slots__ = ("name", "get", "set", "lo", "hi", "step_kind")

    def __init__(self, name: str, get: Callable[[], int],
                 set_: Callable[[int], int], lo: int, hi: int,
                 step_kind: str = "add"):
        self.name = name
        self.get = get
        self.set = set_
        self.lo = lo
        self.hi = hi
        #: 'add' = +-1 steps (workers, prefetch); 'mul' = double/halve
        #: (queue bounds, where the useful range spans orders of magnitude)
        self.step_kind = step_kind

    def target(self, direction: int) -> int:
        cur = self.get()
        if self.step_kind == "mul":
            to = cur * 2 if direction > 0 else cur // 2
        else:
            to = cur + direction
        return max(self.lo, min(self.hi, to))


class AutotuneController:
    """The closed loop: samples in, knob moves out (see module docstring).

    Lifecycle mirrors the sampler's: ``start()`` launches a daemon thread,
    ``stop()`` joins it (both idempotent); the reader owns both.  All
    decision state lives on the controller thread - ``step()`` is the whole
    loop body and is public so tests can drive it deterministically with an
    injected clock and canned sampler points.
    """

    def __init__(self, executor, sampler, telemetry,
                 policy: Optional[AutotunePolicy] = None,
                 throughput_counter: str = THROUGHPUT_COUNTER,
                 clock: Callable[[], float] = time.monotonic):
        self.policy = policy or AutotunePolicy()
        self._executor = executor
        self._sampler = sampler
        self._telemetry = telemetry
        self._counter_name = throughput_counter
        self._clock = clock
        self._stop_event = threading.Event()
        self._thread: Optional[threading.Thread] = None

        p = self.policy
        self._knobs: Dict[str, _Knob] = {}
        if "workers" in p.exclude_knobs:
            logger.info("autotune: 'workers' knob excluded by policy")
        elif hasattr(executor, "resize_workers"):
            hi = min(p.max_workers,
                     getattr(executor, "max_resize_workers", p.max_workers))
            cur = int(getattr(executor, "_workers_count", 0))
            if cur > hi:
                # same hazard as the results-queue guard below: _Knob.target
                # clamps into [lo, hi], so with the plane already ABOVE the
                # policy ceiling (explicit workers_count > max_workers) the
                # first "grow" move would actually collapse it to hi.  An
                # explicitly oversized plane is pinned, not tuned.
                logger.info(
                    "autotune: current worker count %d exceeds"
                    " max_workers=%d (explicitly pinned wide) - not tuning"
                    " workers", cur, hi)
            else:
                self._knobs["workers"] = _Knob(
                    "workers",
                    get=lambda: int(getattr(executor, "_workers_count", 0)),
                    set_=executor.resize_workers,
                    lo=p.min_workers, hi=hi)
                # declare ownership of the worker plane NOW: a resize (even
                # a no-op one) puts the pool under target management, so a
                # worker lost to a crash or a hung-abandonment before the
                # first tuning move is replaced instead of silently
                # shrinking the plane the controller is about to optimize
                executor.resize_workers(self._knobs["workers"].get())
        if ("results_queue" not in p.exclude_knobs
                and hasattr(executor, "set_results_bound")):
            # a bound above the policy ceiling (notably results_queue_size
            # <= 0, implemented as an effectively-unbounded semaphore) must
            # not be tuned: any move would CLAMP it down to max_results_queue,
            # so a "grow" would actually collapse a deliberately unbounded
            # queue to 128 deep.  Leave such queues alone.
            if int(executor._out_slots.bound) <= p.max_results_queue:
                self._knobs["results_queue"] = _Knob(
                    "results_queue",
                    get=lambda: int(executor._out_slots.bound),
                    set_=executor.set_results_bound,
                    lo=p.min_results_queue, hi=p.max_results_queue,
                    step_kind="mul")
            else:
                logger.info(
                    "autotune: results queue bound %d exceeds"
                    " max_results_queue=%d (unbounded or pinned wide) - not"
                    " tuning it", int(executor._out_slots.bound),
                    p.max_results_queue)

        #: bounded decision log (newest last); every entry also went out as
        #: counters + a trace event, this is the programmatic/diagnostics view
        self.decisions: "collections.deque" = collections.deque(maxlen=256)
        self._pending: Optional[dict] = None
        self._blocked: Dict[tuple, int] = {}
        self._cooldown_until = 0.0
        self._explore_dir = -1  # first exploration probes a shrink
        self._m_applied = telemetry.counter("autotune.moves_applied")
        self._m_kept = telemetry.counter("autotune.moves_kept")
        self._m_reverted = telemetry.counter("autotune.moves_reverted")
        self._gauges = {}
        for name in ("workers", "results_queue", "prefetch", "decode_split",
                     "cache_mem"):
            self._gauges[name] = telemetry.gauge(f"autotune.{name}")
        self._stamp_gauges()

    # -- wiring ---------------------------------------------------------------

    def attach_loader(self, loader) -> None:
        """Register a :class:`cuda.CudaDataLoader`'s prefetch depth as a knob
        (called by the loader's constructor when it wraps an autotuned
        reader); idempotent per loader, latest loader wins."""
        p = self.policy
        if "prefetch" in p.exclude_knobs:
            logger.info("autotune: 'prefetch' knob excluded by policy")
            return
        if int(loader.prefetch) > p.max_prefetch:
            # same collapse hazard as the workers/results-queue guards: a
            # "grow" from above the ceiling would clamp DOWN to max_prefetch
            logger.info(
                "autotune: loader prefetch %d exceeds max_prefetch=%d"
                " (explicitly pinned deep) - not tuning prefetch",
                int(loader.prefetch), p.max_prefetch)
            return
        self._knobs["prefetch"] = _Knob(
            "prefetch",
            get=lambda: int(loader.prefetch),
            set_=loader.set_prefetch,
            lo=p.min_prefetch, hi=p.max_prefetch)
        self._stamp_gauges()

    def attach_cache_memory(self, get: Callable[[], int],
                            set_: Callable[[int], int],
                            lo_mb: int, hi_mb: int) -> None:
        """Register the shared warm tier's L1 residency cap as a knob
        (called by make_reader for ``cache_type='shared'`` readers; values
        in MB - the knob plane is integer).

        The memory-vs-worker-count trade (ROADMAP item 5): a starved
        consumer first widens the worker plane; once those moves are blocked
        or bounded, growing the warm tier's residency turns repeat reads
        into memcpys instead of decodes (same bottleneck, different lever).
        A consumer-bound pipeline shrinks the tier - decoded-batch memcpys
        and eviction churn spend host memory bandwidth the consumer needs.
        Doubling/halving steps (the useful range spans orders of magnitude);
        judged and reverted on delivered throughput like every knob.  NOTE:
        the cap lives in the tier's shared header, so a move applies to
        every job on the tier - pin it (docs/operations.md "Warm cache")
        when jobs must not tune each other.
        """
        if "cache_mem" in self.policy.exclude_knobs:
            logger.info("autotune: 'cache_mem' knob excluded by policy")
            return
        if hi_mb < lo_mb or hi_mb < 1:
            return
        self._knobs["cache_mem"] = _Knob(
            "cache_mem", get=get, set_=set_, lo=max(1, lo_mb), hi=hi_mb,
            step_kind="mul")
        self._stamp_gauges()

    def attach_decode_split(self, get: Callable[[], int],
                            set_: Callable[[int], int]) -> None:
        """Register the live host<->device decode split as a knob (called by
        make_reader when a ``decode_placement='auto'`` field exists).

        Binary: 0 = full decode on host workers, 1 = entropy-only on host +
        dequant/IDCT on the device.  A starved consumer (worker plane is the
        bottleneck) pushes toward the device - each rowgroup then costs the
        workers only the entropy half; a consumer-bound pipeline pulls the
        work back onto the (idle) workers.  Judged and reverted on delivered
        throughput exactly like every other knob; the
        ``autotune.decode_split`` gauge rides the sampled frames, so flight
        records and ``--watch`` carry the split trajectory.

        Never attached under ``deterministic='seed'`` readers (make_reader
        puts 'decode_split' in ``AutotunePolicy.exclude_knobs``): a live
        flip changes which wire form each rowgroup ships based on worker
        timing, breaking the seed-stable stream certificate.
        """
        if "decode_split" in self.policy.exclude_knobs:
            logger.info("autotune: 'decode_split' knob excluded by policy"
                        " (deterministic delivery)")
            return
        self._knobs["decode_split"] = _Knob(
            "decode_split", get=get, set_=set_, lo=0, hi=1)
        self._stamp_gauges()

    def _stamp_gauges(self) -> None:
        for name, knob in self._knobs.items():
            try:
                self._gauges[name].set(knob.get())
            except Exception:  # noqa: BLE001 - observability must not raise
                pass

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        """Launch the controller thread (idempotent)."""
        if self._thread is not None:
            return
        self._warmup_until = self._clock() + self.policy.warmup_s
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="petastorm-tpu-autotune")
        self._thread.start()

    def stop(self) -> None:
        """Stop the controller thread (idempotent; bounded join).  Knobs are
        left at their current (tuned) values - reverting them on close would
        discard the converged configuration mid-epoch."""
        self._stop_event.set()
        t = self._thread
        if t is not None:
            t.join(timeout=max(2.0, 4 * self.policy.tick_s))
            self._thread = None

    def _run(self) -> None:
        while not self._stop_event.wait(self.policy.tick_s):
            if self._clock() < self._warmup_until:
                continue
            try:
                self.step()
            except Exception:  # noqa: BLE001 - tuning must not kill the read
                logger.warning("autotune step failed", exc_info=True)

    # -- measurement ----------------------------------------------------------

    def _throughput(self, points: List[dict]) -> Optional[float]:
        """Interval-weighted mean delivered rate over ``points`` (None when
        empty)."""
        total_dt = sum(pt.get("dt_s", 0.0) for pt in points)
        if not points or total_dt <= 0:
            return None
        delivered = sum(pt.get("rates", {}).get(self._counter_name, 0.0)
                        * pt.get("dt_s", 0.0) for pt in points)
        return delivered / total_dt

    def _recent_points(self, k: int) -> List[dict]:
        series = self._sampler.series()
        return series[-k:] if series else []

    @staticmethod
    def _mean_rate(points: List[dict], name: str) -> float:
        total_dt = sum(pt.get("dt_s", 0.0) for pt in points)
        if total_dt <= 0:
            return 0.0
        return sum(pt.get("rates", {}).get(name, 0.0) * pt.get("dt_s", 0.0)
                   for pt in points) / total_dt

    # -- the decision loop ----------------------------------------------------

    def step(self) -> Optional[dict]:
        """One loop body: either progress the pending move's evaluation or
        pick and apply a new move.  Returns the decision entry it resolved
        or applied this call, else None.  Called by the controller thread;
        tests call it directly."""
        now = self._clock()
        if self._pending is not None:
            return self._evaluate_pending(now)
        if now < self._cooldown_until:
            return None
        points = self._recent_points(self.policy.eval_points)
        if len(points) < self.policy.eval_points:
            return None  # not enough signal yet
        move = self._pick_move(points)
        if move is None:
            if self._blocked:
                # a decision opportunity that found no admissible move is
                # still a round: age the hysteresis blocks here too,
                # otherwise a controller whose every (knob, direction) got
                # reverted on a noisy host can never reach the resolved-
                # decision aging below and wedges permanently inert
                self._blocked = {k: v - 1
                                 for k, v in self._blocked.items() if v > 1}
                self._cooldown_until = now + self.policy.cooldown_s
            return None
        knob_name, direction, reason = move
        knob = self._knobs[knob_name]
        frm = knob.get()
        to = knob.target(direction)
        baseline = self._throughput(points)
        knob.set(to)
        self._gauges[knob_name].set(to)
        self._m_applied.add(1)
        entry = {"t": time.time(), "knob": knob_name,
                 "action": "grow" if direction > 0 else "shrink",
                 "from": frm, "to": to, "reason": reason,
                 "baseline_rate": baseline, "measured_rate": None,
                 "outcome": "pending"}
        self.decisions.append(entry)
        self._trace(entry)
        logger.info("autotune: %s %s %d -> %d (%s; baseline %.1f/s)",
                    entry["action"], knob_name, frm, to, reason,
                    baseline or 0.0)
        self._pending = {"entry": entry, "knob": knob, "direction": direction,
                         "settle_until": now + self.policy.settle_s,
                         "eval_anchor": _UNANCHORED}
        return entry

    @staticmethod
    def _points_after(series: List[dict], anchor) -> List[dict]:
        """Points sampled after ``anchor`` (matched by identity).  The
        sampler's ring is a bounded deque, so length-based slicing would
        return nothing forever once the ring fills (len pins at maxlen);
        an anchor that has aged out of the ring means every buffered point
        is newer than it."""
        if anchor is None:
            return series
        for i in range(len(series) - 1, -1, -1):
            if series[i] is anchor:
                return series[i + 1:]
        return series

    def _evaluate_pending(self, now: float) -> Optional[dict]:
        pending = self._pending
        if now < pending["settle_until"]:
            return None
        if pending["eval_anchor"] is _UNANCHORED:
            # settle window over: only points sampled from HERE on judge the
            # move (points that straddle the transition are discarded)
            series = self._sampler.series()
            pending["eval_anchor"] = series[-1] if series else None
            return None
        series = self._sampler.series()
        fresh = self._points_after(series, pending["eval_anchor"])
        if len(fresh) < self.policy.eval_points:
            return None
        entry = pending["entry"]
        knob, direction = pending["knob"], pending["direction"]
        after = self._throughput(fresh[:self.policy.eval_points])
        baseline = entry["baseline_rate"]
        entry["measured_rate"] = after
        regressed = (baseline is not None and after is not None
                     and baseline > 0
                     and after < baseline * (1 - self.policy.revert_threshold))
        # existing (knob, direction) blocks age by one RESOLVED decision
        self._blocked = {k: v - 1 for k, v in self._blocked.items() if v > 1}
        if regressed:
            knob.set(entry["from"])
            self._gauges[knob.name].set(entry["from"])
            self._m_reverted.add(1)
            entry["outcome"] = "reverted"
            self._blocked[(knob.name, direction)] = self.policy.block_rounds
            self._cooldown_until = now + 2 * self.policy.cooldown_s
            logger.info(
                "autotune: reverted %s %s %d -> %d (%.1f/s vs baseline"
                " %.1f/s)", entry["action"], knob.name, entry["to"],
                entry["from"], after or 0.0, baseline or 0.0)
        else:
            self._m_kept.add(1)
            entry["outcome"] = "kept"
            self._cooldown_until = now + self.policy.cooldown_s
        self._trace(entry)
        self._pending = None
        return entry

    def _pick_move(self, points: List[dict]):
        """(knob, direction, reason) for the bottleneck the samples point
        at, or None.  Exactly one move at a time - multi-knob moves cannot
        be attributed (and therefore cannot be safely reverted)."""
        starved = self._mean_rate(points, "queue.results_empty_wait_s")
        blocked = self._mean_rate(points, "queue.results_full_wait_s")
        p = self.policy
        if starved >= p.starved_threshold and starved >= blocked:
            reason = f"consumer starved {starved:.0%} of wall"
            # decode_split last: widening the plane is the cheaper, reversible
            # first move; shipping the decode to the device only gets tried
            # once the structural knobs are blocked or at their bounds
            candidates = [("workers", +1, reason),
                          ("prefetch", +1, reason),
                          ("results_queue", +1, reason),
                          ("cache_mem", +1, reason),
                          ("decode_split", +1, reason)]
        elif blocked >= p.blocked_threshold:
            # the consumer can't keep up: free CPU for it (fewer workers),
            # let the workers run ahead (wider results bound), shrink the
            # warm tier (its memcpys/eviction churn compete for the memory
            # bandwidth the consumer needs), or pull the decode back onto
            # the idle worker plane (split toward host)
            reason = f"workers blocked on full results {blocked:.0%} of wall"
            candidates = [("workers", -1, reason),
                          ("results_queue", +1, reason),
                          ("cache_mem", -1, reason),
                          ("decode_split", -1, reason)]
        elif p.explore:
            # no queue-wait signal: probe around the current point - some
            # optima (GIL contention, memory pressure) never show up as
            # queue waits.  Alternate directions; reverts undo bad guesses.
            reason = "exploration probe"
            direction = self._explore_dir
            self._explore_dir = -direction  # alternate for the next probe
            candidates = [("workers", direction, reason),
                          ("prefetch", direction, reason)]
        else:
            return None
        for name, direction, reason in candidates:
            knob = self._knobs.get(name)
            if knob is None:
                continue
            if self._blocked.get((name, direction)):
                continue
            if knob.target(direction) == knob.get():
                continue  # already at the bound
            return name, direction, reason
        return None

    def _trace(self, entry: dict) -> None:
        trace = getattr(self._telemetry, "trace", None)
        if trace is None:
            return
        try:
            trace.add(f"autotune.{entry['knob']}.{entry['action']}",
                      "autotune", time.perf_counter_ns(), 0,
                      {k: entry[k] for k in ("from", "to", "reason",
                                             "outcome")})
        except Exception:  # noqa: BLE001 - observability must not raise
            pass

    # -- introspection --------------------------------------------------------

    def knobs(self) -> Dict[str, int]:
        """Current value of every attached knob."""
        return {name: knob.get() for name, knob in self._knobs.items()}

    @property
    def diagnostics(self) -> dict:
        """JSON-serializable controller state: knob values + bounds, move
        counters and the bounded decision log (latched into
        ``Reader.diagnostics['autotune']``)."""
        return {
            "knobs": self.knobs(),
            "bounds": {name: [knob.lo, knob.hi]
                       for name, knob in self._knobs.items()},
            "moves_applied": int(self._m_applied.value),
            "moves_kept": int(self._m_kept.value),
            "moves_reverted": int(self._m_reverted.value),
            "decisions": list(self.decisions),
        }
