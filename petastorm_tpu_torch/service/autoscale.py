"""Closed-loop fleet autoscaling: the actuator for ``scaling_signal()``.

The port's copy of ``petastorm_tpu/service/autoscale.py:100-747``: the same
decisions on the same probes.  The supervisor imports no ``torch``.

The dispatcher aggregates client starvation into grow/ok/shrink verdicts
(:meth:`~petastorm_tpu_torch.service.dispatcher.Dispatcher.scaling_signal` -
the ``service.scale_pressure`` gauge); this module acts on them, the service
analog of the in-process :class:`~petastorm_tpu_torch.autotune.
AutotuneController` (same judgment shape: sustained signal -> one bounded
move -> settle window -> hysteresis), and the "shared elastic input
processing sized by consumer demand" loop of the tf.data service paper
(arXiv:2210.14826) with tf.data's demand-driven tuning rule
(arXiv:2101.12127) deciding *when*.

How it works
------------

:class:`AutoscaleSupervisor` polls the dispatcher's scaling signal every
``poll_interval_s`` - directly when handed a ``Dispatcher`` object,
over a ``stats`` probe frame when given an address (so it runs anywhere,
not just on the dispatcher host) - and actuates through a **spawner**:

* ``grow`` verdicts for ``grow_windows`` consecutive polls -> spawn
  ``grow_step`` worker(s), up to ``max_workers``;
* ``shrink`` verdicts for ``shrink_windows`` consecutive polls -> retire
  ONE worker, down to ``min_workers`` - **gracefully**: the worker drains
  its in-flight assignments, flushes its outbox, then exits
  (:meth:`~petastorm_tpu_torch.service.worker.ServiceWorker.retire`), so
  ``deterministic='seed'`` streams stay bit-identical through scale
  events; only a drain that misses ``drain_timeout_s`` is force-killed
  (``service.autoscale.workers_force_killed`` - the requeue path then
  recovers its items);
* after ANY scale event the verdict streaks reset and a ``settle_s``
  window passes before new verdicts accumulate - the same
  settle+hysteresis shape that keeps the in-process autotune loop from
  oscillating on a drifting host;
* the ``min_workers`` floor is **self-healing**: a spawned worker that
  died on its own is reaped (``service.autoscale.workers_lost``) and the
  floor respawns it on the next poll, no verdict needed.

Spawners
--------

:class:`SubprocessSpawner` runs real ``petastorm-tpu-torch-service worker``
processes (the CLI ``autoscale`` mode's default; SIGTERM = graceful
drain).  :class:`InProcessSpawner` runs :class:`~petastorm_tpu_torch.service.
worker.ServiceWorker` threads (tests, single-process deployments).
:class:`ExecHookSpawner` replaces local spawning with a user command for
k8s-style orchestrators (``--exec-hook``): each scale event writes one
JSON object to the command's stdin::

    {"action": "scale_up" | "scale_down",
     "address": "host:7737",        # the dispatcher the fleet serves
     "workers": 3,                  # observed non-draining workers
     "target": 4,                   # desired fleet size after this event
     "pressure": 0.41,              # starved-seconds/sec (the signal)
     "recommendation": "grow",
     "reason": "pressure 0.41 > threshold 0.20 for 3 polls",
     "policy": {"min_workers": 1, "max_workers": 8}}

The command must exit 0; scale-down implementations should deliver
SIGTERM (graceful drain) rather than SIGKILL.  With an exec hook the
supervisor sizes against the *observed* worker count from the signal;
with local spawners it sizes its own spawned fleet (pre-existing static
workers are extra capacity it never touches).

Usage::

    petastorm-tpu-torch-service autoscale --address HOST:7737 \\
        --min-workers 1 --max-workers 8 --capacity 2
    # or, k8s-style:
    petastorm-tpu-torch-service autoscale --address HOST:7737 \\
        --exec-hook 'kubectl scale deploy ingest-workers --replicas=$(jq .target)'

Runbook: docs/operations.md "Fleet autoscaling & QoS".
"""

from __future__ import annotations

import dataclasses
import json
import logging
import subprocess
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.service.dispatcher import compute_recommendation
from petastorm_tpu_torch.service.protocol import (connect_frames,
                                            parse_address_list,
                                            resolve_auth_token)
from petastorm_tpu_torch.telemetry import Telemetry
from petastorm_tpu_torch.telemetry import resolve as _resolve_telemetry

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class AutoscalePolicy:
    """Bounds, pacing and hysteresis for :class:`AutoscaleSupervisor`.

    The defaults are deliberately conservative (multi-second settle, several
    consecutive verdicts per move): worker processes cost seconds to spawn
    and warm, so chasing a noisy pressure signal would thrash the fleet.
    Tests and smokes shrink every window for speed.
    """

    #: fleet-size floor the supervisor maintains (self-healing: dead
    #: spawned workers are respawned to hold it) and ceiling it never
    #: exceeds.  With an exec hook these bound the OBSERVED worker count;
    #: with local spawners, the supervisor's own spawned fleet.
    min_workers: int = 1
    max_workers: int = 8
    #: scaling-signal poll cadence (verdict opportunities, not verdicts)
    poll_interval_s: float = 1.0
    #: consecutive ``grow`` verdicts required before a scale-up (sustained
    #: pressure, not one starved sample)
    grow_windows: int = 3
    #: consecutive ``shrink`` verdicts required before a scale-down (idling
    #: capacity costs less than re-warming a retired worker, so shrinking
    #: is slower than growing by default)
    shrink_windows: int = 6
    #: workers spawned per scale-up event (scale-down always retires one)
    grow_step: int = 1
    #: after any scale event, let the fleet settle this long before verdict
    #: streaks accumulate again (spawn/registration/warmup latency must not
    #: read as "still starved -> grow again")
    settle_s: float = 5.0
    #: ``capacity`` for spawned workers (concurrent items each accepts)
    worker_capacity: int = 2
    #: pressure threshold override threaded into the scaling signal
    #: (``--starved-threshold``); None = the dispatcher's configured value
    starved_threshold: Optional[float] = None
    #: graceful-drain budget per retirement; a worker still holding work
    #: past it is force-killed (its items requeue through the attempt
    #: budget - correct, just not graceful)
    drain_timeout_s: float = 30.0

    def __post_init__(self):
        if self.min_workers < 0:
            raise PetastormTpuError("min_workers must be >= 0")
        if self.max_workers < max(1, self.min_workers):
            raise PetastormTpuError(
                "max_workers must be >= max(1, min_workers)")
        if self.poll_interval_s <= 0:
            raise PetastormTpuError("poll_interval_s must be > 0")
        if self.grow_windows < 1 or self.shrink_windows < 1:
            raise PetastormTpuError(
                "grow_windows/shrink_windows must be >= 1")
        if self.grow_step < 1:
            raise PetastormTpuError("grow_step must be >= 1")
        if self.worker_capacity < 1:
            raise PetastormTpuError("worker_capacity must be >= 1")
        if self.starved_threshold is not None and self.starved_threshold < 0:
            raise PetastormTpuError("starved_threshold must be >= 0 or None")


# -- spawners -----------------------------------------------------------------

class SubprocessSpawner:
    """Spawn fleet workers as real ``petastorm-tpu-torch-service worker``
    subprocesses on this host (the CLI default).  Retirement delivers
    SIGTERM - the worker CLI's graceful-drain signal - and falls back to
    SIGKILL past the timeout."""

    external = False

    def __init__(self, address: str, capacity: int = 2, shm_size_mb: int = 0,
                 auth_token_file: Optional[str] = None,
                 reconnect_attempts: int = 5,
                 name_prefix: str = "autoscale",
                 env: Optional[Dict[str, str]] = None):
        self._address = address
        self._capacity = int(capacity)
        self._shm_size_mb = int(shm_size_mb)
        self._auth_token_file = auth_token_file
        self._reconnect_attempts = int(reconnect_attempts)
        self._name_prefix = name_prefix
        #: subprocess environment (None = inherit); benches pass a clean
        #: allocator env so spawned workers match statically-started ones
        self._env = env

    def spawn(self, name: str):
        """Start one ``worker`` subprocess; returns its Popen handle."""
        cmd = [sys.executable, "-m", "petastorm_tpu_torch.service.cli", "worker",
               "--address", self._address,
               "--capacity", str(self._capacity),
               "--name", f"{self._name_prefix}-{name}",
               "--reconnect-attempts", str(self._reconnect_attempts)]
        if self._shm_size_mb:
            cmd += ["--shm-size-mb", str(self._shm_size_mb)]
        if self._auth_token_file:
            cmd += ["--auth-token-file", self._auth_token_file]
        return subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL, env=self._env)

    def alive(self, handle) -> bool:
        """True while the worker process is still running."""
        return handle.poll() is None

    def retire(self, handle, timeout_s: float) -> bool:
        """SIGTERM (graceful drain) and wait; True when it exited in
        time, False when the drain missed the budget."""
        if handle.poll() is not None:
            return True
        handle.terminate()  # SIGTERM -> run_worker's graceful drain
        try:
            handle.wait(timeout=timeout_s)
            return True
        except subprocess.TimeoutExpired:
            return False

    def kill(self, handle) -> None:
        """SIGKILL the worker process (the post-drain-timeout fallback;
        its in-flight items recover through the requeue path)."""
        if handle.poll() is None:
            handle.kill()
            try:
                handle.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                pass


class InProcessSpawner:
    """Spawn :class:`~petastorm_tpu_torch.service.worker.ServiceWorker` threads
    inside this process (tests, notebooks, single-process deployments -
    decode releases the GIL, so thread workers pull real weight)."""

    external = False

    def __init__(self, address: str, capacity: int = 2,
                 reconnect_attempts: int = 5,
                 heartbeat_interval_s: float = 0.5):
        self._address = address
        self._capacity = int(capacity)
        self._reconnect_attempts = int(reconnect_attempts)
        self._hb = float(heartbeat_interval_s)

    def spawn(self, name: str):
        """Start one :class:`ServiceWorker` daemon thread; returns the
        ``(worker, thread)`` handle pair."""
        from petastorm_tpu_torch.service.worker import ServiceWorker

        worker = ServiceWorker(self._address, capacity=self._capacity,
                               name=name,
                               heartbeat_interval_s=self._hb,
                               reconnect_attempts=self._reconnect_attempts)
        thread = threading.Thread(target=worker.run, daemon=True,
                                  name=f"petastorm-torch-autoscale-{name}")
        thread.start()
        return (worker, thread)

    def alive(self, handle) -> bool:
        """True while the worker thread is still running."""
        return handle[1].is_alive()

    def retire(self, handle, timeout_s: float) -> bool:
        """Graceful drain via :meth:`ServiceWorker.retire`; True when the
        worker drained and exited within the budget."""
        worker, thread = handle
        if not thread.is_alive():
            return True
        if not worker.retire(timeout=timeout_s):
            return False
        thread.join(timeout=2.0)
        return True

    def kill(self, handle) -> None:
        """Hard-stop the worker thread (post-drain-timeout fallback)."""
        worker, thread = handle
        worker.stop()
        thread.join(timeout=2.0)


class ExecHookSpawner:
    """Delegate scale events to a user command (``--exec-hook``) for
    orchestrators that own the worker fleet (k8s Deployments, slurm,
    docker-compose...).  Each event runs ``command`` through the shell
    with ONE JSON object on stdin (the contract in the module docstring);
    a non-zero exit is counted (``service.autoscale.exec_hook_failures``)
    and logged, never raised - the next verdict retries."""

    external = True

    def __init__(self, command: str, timeout_s: float = 30.0):
        if not command or not command.strip():
            raise PetastormTpuError("exec hook command must be non-empty")
        self.command = command
        self._timeout_s = float(timeout_s)

    def invoke(self, payload: Dict[str, Any]) -> bool:
        """Run the hook once; True on exit 0."""
        try:
            proc = subprocess.run(
                self.command, shell=True, input=json.dumps(payload),
                capture_output=True, text=True, timeout=self._timeout_s)
        except subprocess.TimeoutExpired:
            logger.warning("exec hook timed out after %.0fs: %r",
                           self._timeout_s, self.command)
            return False
        if proc.returncode != 0:
            logger.warning("exec hook exited %d: %r (stderr: %s)",
                           proc.returncode, self.command,
                           proc.stderr.strip()[-500:])
            return False
        if proc.stdout.strip():
            logger.debug("exec hook stdout: %s", proc.stdout.strip()[-500:])
        return True


# -- the supervisor -----------------------------------------------------------

class AutoscaleSupervisor:
    """The closed-loop fleet actuator (module docstring).

    ``dispatcher``: an in-process :class:`~petastorm_tpu_torch.service.
    dispatcher.Dispatcher` to poll directly, OR ``address`` of a remote
    one to probe with ``stats`` frames (exactly one must be given).
    ``spawner``: how workers are spawned/retired - defaults to a
    :class:`SubprocessSpawner` against ``address`` (an ``address`` is then
    required).  ``on_event``: optional callable receiving one dict per
    scale event / probe failure (the CLI prints them as JSON lines).

    Run blocking with :meth:`run` (the CLI) or in the background with
    :meth:`start` / :meth:`stop` (tests, benches, embedding next to a
    trainer).  :meth:`stop` retires every spawned worker gracefully by
    default - a supervisor's fleet leaves with it.
    """

    def __init__(self, address: Optional[str] = None, *,
                 dispatcher=None,
                 policy: Optional[AutoscalePolicy] = None,
                 spawner=None,
                 telemetry=None,
                 auth_token: Optional[str] = None,
                 on_event: Optional[Callable[[Dict], None]] = None):
        if (address is None) == (dispatcher is None):
            raise PetastormTpuError(
                "give exactly one of address= (remote stats probes) or"
                " dispatcher= (direct in-process polling)")
        self.policy = policy or AutoscalePolicy()
        self._dispatcher = dispatcher
        self._address = address
        #: the probe rotates through a comma-separated failover list
        #: ('primary:p,standby:p') and remembers the last answering
        #: address, so a dispatcher failover reads as one slow poll, not
        #: a dead fleet (docs/operations.md "Dispatcher HA")
        self._probe_addresses = (parse_address_list(address)
                                 if address is not None else [])
        self._probe_index = 0
        self._auth_token = resolve_auth_token(auth_token)
        if spawner is None:
            if address is None:
                raise PetastormTpuError(
                    "an in-process dispatcher needs an explicit spawner"
                    " (the default SubprocessSpawner dials an address)")
            spawner = SubprocessSpawner(
                address, capacity=self.policy.worker_capacity)
        self.spawner = spawner
        self.telemetry = (_resolve_telemetry(telemetry)
                          if telemetry is not None else Telemetry())
        self._on_event = on_event
        self._stop_event = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._handles: List[Dict[str, Any]] = []
        self._spawn_seq = 0
        self._grow_streak = 0
        self._shrink_streak = 0
        self._settle_until = 0.0
        self._probe_failures_run = 0
        self.last_signal: Optional[Dict[str, Any]] = None
        tele = self.telemetry
        self._m_spawned = tele.counter("service.autoscale.workers_spawned")
        self._m_retired = tele.counter("service.autoscale.workers_retired")
        self._m_forced = tele.counter("service.autoscale.workers_force_killed")
        self._m_lost = tele.counter("service.autoscale.workers_lost")
        self._m_scale_ups = tele.counter("service.autoscale.scale_ups")
        self._m_scale_downs = tele.counter("service.autoscale.scale_downs")
        self._m_probe_failures = tele.counter(
            "service.autoscale.probe_failures")
        self._m_hook_failures = tele.counter(
            "service.autoscale.exec_hook_failures")
        self._g_fleet = tele.gauge("service.autoscale.fleet_size")
        self._g_pressure = tele.gauge("service.autoscale.pressure")

    # -- signal ---------------------------------------------------------------

    def signal(self) -> Optional[Dict[str, Any]]:
        """One scaling-signal sample, or None on a probe failure.  The
        verdict is re-judged locally when the policy overrides
        ``starved_threshold`` (same :func:`~petastorm_tpu_torch.service.
        dispatcher.compute_recommendation` rule, different threshold)."""
        try:
            if self._dispatcher is not None:
                sig = self._dispatcher.scaling_signal(
                    threshold=self.policy.starved_threshold)
            else:
                sig = self._probe_scaling()
                if self.policy.starved_threshold is not None:
                    threshold = self.policy.starved_threshold
                    sig = dict(sig)
                    sig["starved_threshold"] = threshold
                    sig["recommendation"] = compute_recommendation(
                        pressure=sig["pressure"], threshold=threshold,
                        pending=sig["pending_items"],
                        capacity=sig["worker_capacity"],
                        busy_fraction=sig["busy_fraction"],
                        clients=sig.get("connected_clients", 0))
        except (OSError, PetastormTpuError, KeyError) as exc:
            self._m_probe_failures.add(1)
            self._probe_failures_run += 1
            if self._probe_failures_run in (1, 10):
                logger.warning("scaling-signal probe failed (%s); the"
                               " supervisor keeps polling", exc)
            self._emit({"event": "probe-failed", "error": str(exc)})
            return None
        self._probe_failures_run = 0
        self.last_signal = sig
        self._g_pressure.set(sig["pressure"])
        return sig

    def _probe_scaling(self) -> Dict[str, Any]:
        """One remote ``stats?`` probe, rotating through the failover
        address list: the first dispatcher that answers with a live
        (non-standby) signal wins, and later probes start there.  An
        unpromoted standby answers stats but is not the fleet - its reply
        is skipped like a dead address.  Raises only when EVERY address
        failed."""
        last_exc: Exception = PetastormTpuError(
            f"no dispatcher address to probe: {self._address!r}")
        for offset in range(len(self._probe_addresses)):
            idx = (self._probe_index + offset) % len(self._probe_addresses)
            addr = self._probe_addresses[idx]
            try:
                conn = connect_frames(addr, timeout=5.0)
                try:
                    conn.send({"t": "stats?", "token": self._auth_token})
                    reply = conn.recv(timeout=5.0)
                finally:
                    conn.close()
                if not reply or reply.get("t") != "stats":
                    raise PetastormTpuError(
                        f"unexpected stats reply: {reply!r}")
                stats = reply["stats"]
                standby = stats.get("standby") or {}
                if standby.get("standby") and not standby.get("promoted"):
                    raise PetastormTpuError(
                        f"dispatcher at {addr[0]}:{addr[1]} is an"
                        " unpromoted standby")
                sig = stats["scaling"]
            except (OSError, PetastormTpuError, KeyError) as exc:
                last_exc = exc
                continue
            self._probe_index = idx
            return sig
        raise last_exc

    # -- fleet accounting -----------------------------------------------------

    def _reap_dead(self) -> None:
        """Drop handles whose worker died on its own (crash/OOM): the
        min-floor respawn on the next poll is the self-healing path."""
        dead = [h for h in self._handles
                if not self.spawner.alive(h["handle"])]
        for h in dead:
            self._handles.remove(h)
            self._m_lost.add(1)
            logger.warning("spawned worker %s died on its own; the"
                           " min_workers floor will respawn", h["name"])
            self._emit({"event": "worker-lost", "worker": h["name"]})

    def fleet_size(self, sig: Optional[Dict[str, Any]]) -> int:
        """The worker count the bounds apply to: observed (signal) for an
        external/exec-hook fleet, the supervisor's own spawned fleet for
        local spawners."""
        if self.spawner.external:
            if sig is not None:
                return int(sig.get("workers", 0))
            return int((self.last_signal or {}).get("workers", 0))
        return len(self._handles)

    # -- actuation ------------------------------------------------------------

    def _emit(self, event: Dict[str, Any]) -> None:
        if self._on_event is not None:
            try:
                self._on_event(dict(event))
            except Exception:  # noqa: BLE001 - observer must not kill the loop
                logger.warning("on_event observer failed", exc_info=True)

    def _notify_dispatcher(self, kind: str, **fields) -> None:
        """Fold one structured autoscale decision into the dispatcher's
        fleet event log (one-shot ``event`` frame): the supervisor usually
        runs on a different host than any failing client, and the event
        log is how its scale decisions end up in that client's crash
        artifact.  Best-effort - a dead dispatcher is already the loop's
        problem, not this notification's."""
        if self._dispatcher is not None:
            # direct in-process polling: no wire hop, fold straight in
            try:
                self._dispatcher._on_peer_event(
                    {"kind": f"autoscale.{kind}", **fields}, src="autoscale")
            except Exception:  # noqa: BLE001 - best-effort notification
                logger.debug("autoscale event notification failed",
                             exc_info=True)
            return
        addr = self._probe_addresses[self._probe_index
                                     % len(self._probe_addresses)]
        try:
            conn = connect_frames(addr, timeout=5.0)
            try:
                conn.send({"t": "event", "kind": f"autoscale.{kind}",
                           "src": "autoscale", "token": self._auth_token,
                           **fields})
                conn.recv(timeout=5.0)
            finally:
                conn.close()
        except (OSError, PetastormTpuError):
            logger.debug("autoscale event notification failed",
                         exc_info=True)

    def _scale_up(self, sig: Dict[str, Any], reason: str,
                  target: Optional[int] = None) -> None:
        fleet = self.fleet_size(sig)
        if target is None:
            target = fleet + self.policy.grow_step
        target = min(self.policy.max_workers, target)
        if target <= fleet:
            return
        if self.spawner.external:
            payload = self._hook_payload("scale_up", sig, fleet, target,
                                         reason)
            if not self.spawner.invoke(payload):
                self._m_hook_failures.add(1)
                return
            spawned = target - fleet
        else:
            spawned = 0
            for _ in range(target - fleet):
                self._spawn_seq += 1
                name = f"as{self._spawn_seq}"
                try:
                    handle = self.spawner.spawn(name)
                except Exception:  # noqa: BLE001 - spawn env may be broken
                    logger.warning("worker spawn failed", exc_info=True)
                    break
                self._handles.append({"handle": handle, "name": name,
                                      "spawned_at": time.monotonic()})
                spawned += 1
        if not spawned:
            return
        self._m_spawned.add(spawned)
        self._m_scale_ups.add(1)
        self._g_fleet.set(self.fleet_size(None))
        logger.info("scale-up: +%d worker(s) -> %d (%s)", spawned,
                    self.fleet_size(None), reason)
        self._emit({"event": "scale-up", "spawned": spawned,
                    "fleet": self.fleet_size(None), "reason": reason,
                    "pressure": sig.get("pressure")})
        self._notify_dispatcher("scale_up", spawned=spawned,
                                fleet=self.fleet_size(None), reason=reason,
                                pressure=float(sig.get("pressure") or 0.0))
        self._after_scale_event()

    def _scale_down(self, sig: Dict[str, Any], reason: str) -> None:
        fleet = self.fleet_size(sig)
        target = max(self.policy.min_workers, fleet - 1)
        if target >= fleet:
            return
        if self.spawner.external:
            payload = self._hook_payload("scale_down", sig, fleet, target,
                                         reason)
            if not self.spawner.invoke(payload):
                self._m_hook_failures.add(1)
                return
            graceful = True
            name = None
        else:
            if not self._handles:
                return  # nothing of ours to retire (static workers stay)
            entry = self._handles.pop()  # newest first: LIFO keeps the
            #                              longest-warm caches serving
            name = entry["name"]
            graceful = self.spawner.retire(entry["handle"],
                                           self.policy.drain_timeout_s)
            if not graceful:
                logger.warning("worker %s missed the %.0fs drain budget;"
                               " force-killing (its items requeue)", name,
                               self.policy.drain_timeout_s)
                self.spawner.kill(entry["handle"])
                self._m_forced.add(1)
        self._m_retired.add(1)
        self._m_scale_downs.add(1)
        self._g_fleet.set(self.fleet_size(None))
        logger.info("scale-down: -1 worker (%s) -> %d (%s%s)", name or "?",
                    self.fleet_size(None), reason,
                    "" if graceful else "; FORCED")
        self._emit({"event": "scale-down", "worker": name,
                    "graceful": graceful, "fleet": self.fleet_size(None),
                    "reason": reason, "pressure": sig.get("pressure")})
        self._notify_dispatcher("scale_down", worker=name or "?",
                                graceful=graceful,
                                fleet=self.fleet_size(None), reason=reason,
                                pressure=float(sig.get("pressure") or 0.0))
        self._after_scale_event()

    def _hook_payload(self, action: str, sig: Dict[str, Any], fleet: int,
                      target: int, reason: str) -> Dict[str, Any]:
        return {"action": action,
                "address": self._address
                or (f"127.0.0.1:{self._dispatcher.port}"
                    if self._dispatcher is not None else None),
                "workers": fleet, "target": target,
                "pressure": sig.get("pressure"),
                "recommendation": sig.get("recommendation"),
                "reason": reason,
                "policy": {"min_workers": self.policy.min_workers,
                           "max_workers": self.policy.max_workers}}

    def _after_scale_event(self) -> None:
        self._grow_streak = 0
        self._shrink_streak = 0
        self._settle_until = time.monotonic() + self.policy.settle_s

    # -- the loop -------------------------------------------------------------

    def step(self) -> Optional[str]:
        """One poll + decision; returns the action taken ('scale-up',
        'scale-down', 'floor', None).  Exposed for tests and for embedding
        the loop elsewhere."""
        if not self.spawner.external:
            self._reap_dead()
        sig = self.signal()
        self._g_fleet.set(self.fleet_size(sig))
        fleet = self.fleet_size(sig)
        p = self.policy
        # bounds enforcement needs no verdict: hold the floor (self-healing
        # respawn rides this) and respect the ceiling
        if fleet < p.min_workers:
            if self.spawner.external:
                # an external fleet is sized off the OBSERVED worker count:
                # a failed probe makes that count a guess, and guessing 0
                # would hand the orchestrator target=min_workers - shrinking
                # a healthy fleet it cannot see.  Hold the floor only on a
                # live signal, and give each event its settle window
                # (registration lags the next probe; without it the hook
                # would re-fire every poll until the count catches up).
                if sig is None or time.monotonic() < self._settle_until:
                    return None
            self._scale_up(sig or {}, target=p.min_workers,
                           reason=f"fleet {fleet} < min_workers"
                           f" {p.min_workers}")
            return "floor"
        if sig is None:
            self._grow_streak = 0
            self._shrink_streak = 0
            return None
        if time.monotonic() < self._settle_until:
            return None  # let the last event settle before judging again
        verdict = sig.get("recommendation")
        if verdict == "grow":
            self._grow_streak += 1
            self._shrink_streak = 0
            if self._grow_streak >= p.grow_windows and fleet < p.max_workers:
                self._scale_up(sig, reason=(
                    f"pressure {sig['pressure']:.2f} >= threshold"
                    f" {sig['starved_threshold']:.2f} with"
                    f" {sig['pending_items']} queued item(s) for"
                    f" {self._grow_streak} poll(s)"))
                return "scale-up"
        elif verdict == "shrink":
            self._shrink_streak += 1
            self._grow_streak = 0
            if self._shrink_streak >= p.shrink_windows \
                    and fleet > p.min_workers:
                self._scale_down(sig, reason=(
                    f"idle fleet (busy {sig['busy_fraction']:.2f}, 0"
                    f" pending) for {self._shrink_streak} poll(s)"))
                return "scale-down"
        else:
            self._grow_streak = 0
            self._shrink_streak = 0
        return None

    def run(self, stop_event: Optional[threading.Event] = None) -> None:
        """Blocking supervision loop (the CLI mode); returns when
        ``stop_event`` (or :meth:`stop`) fires."""
        stop = stop_event or self._stop_event
        self.step()  # immediate first poll: the min_workers floor comes up
        #              without waiting out an interval
        while not stop.wait(self.policy.poll_interval_s):
            if self._stop_event.is_set():
                break
            self.step()

    def start(self) -> "AutoscaleSupervisor":
        """Run the loop in a background thread (tests / embedding)."""
        if self._thread is not None:
            raise PetastormTpuError("supervisor already started")
        self._thread = threading.Thread(
            target=self.run, daemon=True, name="petastorm-torch-autoscale")
        self._thread.start()
        return self

    def stop(self, retire_workers: bool = True,
             drain_timeout_s: Optional[float] = None) -> None:
        """Stop the loop; by default gracefully retire every worker this
        supervisor spawned (a supervisor's fleet leaves with it - pass
        ``retire_workers=False`` to hand the fleet off instead)."""
        self._stop_event.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        if not retire_workers or self.spawner.external:
            return
        budget = (self.policy.drain_timeout_s if drain_timeout_s is None
                  else drain_timeout_s)
        while self._handles:
            entry = self._handles.pop()
            if not self.spawner.alive(entry["handle"]):
                continue
            if not self.spawner.retire(entry["handle"], budget):
                self.spawner.kill(entry["handle"])
                self._m_forced.add(1)
            self._m_retired.add(1)
            self._emit({"event": "shutdown-retire", "worker": entry["name"]})
        self._g_fleet.set(0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    def summary(self) -> Dict[str, Any]:
        """Counters + state snapshot (the CLI prints it as its last line)."""
        counters = {}
        if self.telemetry.enabled:
            counters = {
                k.rsplit(".", 1)[-1]: int(v)
                for k, v in self.telemetry.snapshot()["counters"].items()
                if k.startswith("service.autoscale.")}
        return {"fleet": self.fleet_size(None),
                "spawned_names": [h["name"] for h in self._handles],
                "last_signal": self.last_signal,
                "counters": counters}
