"""Deterministic chaos injection for the ingest pipeline.

The port's copy of ``petastorm_tpu/test_util/chaos.py``.  It injects the
five failure modes a production feed meets - poisoned data (decode
failures), slow items, transient IO errors, hard worker kills (OOM,
segfault) and hung workers (a stuck blocking read or a C-level deadlock that
never returns nor raises) - by seed and work-item ordinal, so a chaos run
is reproducible and its assertions are exact.  The per-ordinal rolls are
CRC32 hashes of ``"{seed}:{kind}:{ordinal}"``, not random streams: the JAX
package and the port inject the same faults for the same spec.

Injection points exercise the real recovery paths:

* decode failures raise ``errors.CodecError`` inside the worker function:
  a *data* error, which an ``on_error`` skip policy quarantines;
* hard kills end a process-pool worker with ``os._exit`` (like an OOM
  kill) and raise :class:`SimulatedWorkerCrash` on a thread or the serial
  pool; the pool's crash ledger requeues the lost item;
* hangs block inside the worker function until the liveness layer
  (``item_deadline_s``) kills or abandons the worker, or the stall watchdog
  (``stall_abort_s``) aborts the read;
* transient IO failures and latency are injected in the filesystem layer
  (``test_util.latency_fs``), beneath the worker's retried read, so
  ``io_retries`` absorbs them as it absorbs real object-store weather.

Kills and hangs are gated on ``attempt == 0`` by default: a requeued item
does not trigger them again, so "one kill" means one.  ``kill_on_retry`` and
``hang_on_retry`` lift the gate.

The port's pools hand a worker function the bare work item;
:class:`ChaosWorker`'s function says it takes the pool's
``pool.VentilatedItem`` instead (``takes_ventilated_items``), reads the
ordinal and the attempt from it, and hands the bare item on.
"""

from __future__ import annotations

import dataclasses
import os
import time
import zlib
from typing import Tuple

from petastorm_tpu_torch.errors import CodecError, PetastormTpuError


class SimulatedWorkerCrash(BaseException):
    """Simulates a hard worker death in pools that cannot lose a real
    process (thread/serial).  BaseException so ordinary ``except Exception``
    user code cannot swallow it; the pool worker loop recognizes the marker
    attribute and dies without delivering a result, exactly like a crashed
    process (heartbeat left set -> item requeued from the crash ledger)."""

    petastorm_tpu_simulated_crash = True


def _in_process_pool_worker() -> bool:
    """True inside one of THIS library's spawned pool worker processes.

    Keyed on the worker process name the pool assigns
    (``petastorm-torch-worker-N``), not on merely having a multiprocessing
    parent - a thread/serial-pool reader running inside someone else's mp
    child (a torch DataLoader worker, an mp-based test harness) must get
    the simulated crash, never an ``os._exit`` of the host process.
    """
    import multiprocessing as mp

    return (mp.parent_process() is not None
            and mp.current_process().name.startswith("petastorm-torch-worker"))


@dataclasses.dataclass(frozen=True)
class ChaosSpec:
    """Declarative, seeded fault-injection plan.

    Rates are deterministic per (seed, fault-kind, ordinal) - the same spec
    over the same plan injects the same faults every run, in every worker,
    on both sides of a process boundary.  Explicit ``*_ordinals`` tuples
    pick exact items for precise tests.
    """

    seed: int = 0
    #: decode failures (CodecError -> data error -> skip/quarantine path)
    decode_fail_rate: float = 0.0
    decode_fail_ordinals: Tuple[int, ...] = ()
    #: slow items (sleep slow_s before processing)
    slow_rate: float = 0.0
    slow_ordinals: Tuple[int, ...] = ()
    slow_s: float = 0.05
    #: hard worker kills (process: os._exit; thread/serial: SimulatedWorkerCrash)
    kill_rate: float = 0.0
    kill_ordinals: Tuple[int, ...] = ()
    kill_on_retry: bool = False
    #: hung workers (block inside the worker function for hang_s seconds -
    #: effectively forever at test timescales): the liveness layer's target
    #: failure mode (stuck GCS read, pathological decode, C-level deadlock).
    #: Gated on attempt == 0 like kills, so the item requeued after a
    #: deadline kill completes on its second attempt; ``hang_on_retry=True``
    #: hangs every attempt (testing budget exhaustion -> quarantine).
    hang_rate: float = 0.0
    hang_ordinals: Tuple[int, ...] = ()
    hang_on_retry: bool = False
    hang_s: float = 3600.0
    #: transient IO failures + latency, injected via test_util.latency_fs
    fail_first_reads: int = 0
    fail_first_opens: int = 0
    io_latency_s: float = 0.0

    def __post_init__(self):
        for name in ("decode_fail_rate", "slow_rate", "kill_rate",
                     "hang_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise PetastormTpuError(f"ChaosSpec.{name} must be in [0, 1]")
        # tolerate bare ints / lists in the ordinal fields (CLI parsing,
        # hand-written tests)
        for name in ("decode_fail_ordinals", "slow_ordinals", "kill_ordinals",
                     "hang_ordinals"):
            v = getattr(self, name)
            if isinstance(v, int):
                object.__setattr__(self, name, (v,))
            elif not isinstance(v, tuple):
                object.__setattr__(self, name, tuple(v))

    # -- parsing (benchmark CLI --chaos) --------------------------------------

    @classmethod
    def parse(cls, text: str) -> "ChaosSpec":
        """Parse ``'key=value,key=value'`` (ordinal lists use ``;``):
        ``'decode_fail_rate=0.01,kill_ordinals=3;7,seed=2'``."""
        kwargs = {}
        fields = {f.name: f for f in dataclasses.fields(cls)}
        for part in filter(None, (p.strip() for p in text.split(","))):
            if "=" not in part:
                raise PetastormTpuError(
                    f"--chaos entries must be key=value, got {part!r}")
            key, _, raw = part.partition("=")
            key = key.strip()
            if key not in fields:
                raise PetastormTpuError(
                    f"Unknown chaos key {key!r}; valid: {sorted(fields)}")
            if key.endswith("_ordinals"):
                kwargs[key] = tuple(int(v) for v in raw.split(";") if v)
            elif key in ("kill_on_retry", "hang_on_retry"):
                kwargs[key] = raw.strip().lower() in ("1", "true", "yes", "on")
            elif key in ("seed", "fail_first_reads", "fail_first_opens"):
                kwargs[key] = int(raw)
            else:
                kwargs[key] = float(raw)
        return cls(**kwargs)

    # -- what this spec touches -----------------------------------------------

    def affects_worker(self) -> bool:
        """True when the spec injects worker-side faults (decode failures,
        slow items, kills, hangs) - make_reader wraps the worker factory
        then."""
        return bool(self.decode_fail_rate or self.decode_fail_ordinals
                    or self.slow_rate or self.slow_ordinals
                    or self.kill_rate or self.kill_ordinals
                    or self.hang_rate or self.hang_ordinals)

    def affects_filesystem(self) -> bool:
        """True when the spec injects filesystem faults (transient IO
        failures, latency) - make_reader wraps the filesystem then."""
        return bool(self.fail_first_reads or self.fail_first_opens
                    or self.io_latency_s)

    def wrap_filesystem(self, base):
        """The transient-IO injection layer over ``base`` (a latency_fs
        wrapper: non-local, picklable, counted)."""
        from petastorm_tpu_torch.test_util.latency_fs import latent_filesystem

        fs, _stats = latent_filesystem(base, latency_s=self.io_latency_s,
                                       fail_first_reads=self.fail_first_reads,
                                       fail_first_opens=self.fail_first_opens)
        return fs

    # -- per-item decisions (deterministic) -----------------------------------

    def _roll(self, kind: str, ordinal: int, rate: float) -> bool:
        if rate <= 0.0:
            return False
        h = zlib.crc32(f"{self.seed}:{kind}:{ordinal}".encode())
        return h / 0xFFFFFFFF < rate

    def should_fail_decode(self, ordinal: int) -> bool:
        """Deterministic per-ordinal decision: inject a decode failure?"""
        return (ordinal in self.decode_fail_ordinals
                or self._roll("decode", ordinal, self.decode_fail_rate))

    def should_slow(self, ordinal: int) -> bool:
        """Deterministic per-ordinal decision: sleep ``slow_s`` first?"""
        return (ordinal in self.slow_ordinals
                or self._roll("slow", ordinal, self.slow_rate))

    def should_kill(self, ordinal: int, attempt: int = 0) -> bool:
        """Deterministic decision: hard-kill the worker handling this item?

        Gated on ``attempt == 0`` unless ``kill_on_retry``: the requeued
        item must land on a surviving worker, or "one kill" cascades."""
        if attempt > 0 and not self.kill_on_retry:
            return False
        return (ordinal in self.kill_ordinals
                or self._roll("kill", ordinal, self.kill_rate))

    def should_hang(self, ordinal: int, attempt: int = 0) -> bool:
        """Deterministic decision: hang the worker handling this item?

        Gated on ``attempt == 0`` unless ``hang_on_retry``: the copy
        requeued after a deadline kill (or issued as a hedge) completes, so
        "one hang" is recoverable; ``hang_on_retry=True`` makes the item
        hang every attempt (the poisoned-slow-item quarantine scenario)."""
        if attempt > 0 and not self.hang_on_retry:
            return False
        return (ordinal in self.hang_ordinals
                or self._roll("hang", ordinal, self.hang_rate))


class ChaosWorker:
    """Pool worker-factory wrapper injecting the spec's worker-side faults.

    Picklable (``pool.WorkerFactory``) so the process pool spawns it;
    decisions are pure functions of (spec, ordinal, attempt), so every
    worker - thread or spawned process - injects identically.  Its function
    takes the pool's ``VentilatedItem`` and calls the inner one with the
    bare work item.
    """

    def __init__(self, inner, spec: ChaosSpec):
        self._inner = inner
        self.spec = spec

    def __call__(self):
        fn = self._inner()
        spec = self.spec

        def chaotic(item):
            ordinal = getattr(item, "ordinal", None)
            if ordinal is not None:
                attempt = getattr(item, "attempt", 0)
                if spec.should_kill(ordinal, attempt):
                    if _in_process_pool_worker():
                        # the real thing: die like the OOM killer struck -
                        # no result, no traceback, no cleanup
                        os._exit(137)
                    raise SimulatedWorkerCrash(
                        f"chaos: hard-killed worker on item {ordinal}")
                if spec.should_hang(ordinal, attempt):
                    # wedge like a stuck blocking read / C-level deadlock:
                    # no result, no exception, heartbeat left naming the
                    # item.  Only the liveness layer (SIGKILL + respawn for
                    # process workers, slot abandonment for threads) or
                    # stall-abort gets past this.  hang_s (default 1h) is
                    # "forever" at test timescales while still letting an
                    # abandoned daemon thread eventually exit.
                    deadline = time.monotonic() + spec.hang_s
                    while time.monotonic() < deadline:
                        time.sleep(min(1.0, max(deadline - time.monotonic(),
                                                0.01)))
                if spec.should_slow(ordinal):
                    time.sleep(spec.slow_s)
                if spec.should_fail_decode(ordinal):
                    raise CodecError(
                        f"chaos: injected decode failure on item {ordinal}")
            return fn(getattr(item, "item", item))

        chaotic.takes_ventilated_items = True
        return chaotic
