"""``petastorm-tpu-torch-service``: run a dispatcher or a fleet worker.

The port's copy of ``petastorm_tpu/service/cli.py:51-512``, with the same
flags (``python -m petastorm_tpu_torch.service.cli ...``).

Usage::

    petastorm-tpu-torch-service dispatcher --port 7737 [--metrics-port 9100]
    petastorm-tpu-torch-service worker --address HOST:7737 [--capacity 4]
    petastorm-tpu-torch-service autoscale --address HOST:7737 --max-workers 8
    petastorm-tpu-torch-service stats --address HOST:7737 [--watch]

``autoscale`` runs the closed-loop fleet supervisor
(:mod:`petastorm_tpu_torch.service.autoscale`): it polls the dispatcher's
scaling signal and spawns/retires local worker subprocesses (or invokes
``--exec-hook`` for k8s-style orchestrators), printing one JSON line per
scale event and a final counters summary.  SIGTERM/Ctrl-C drains the
spawned fleet gracefully before exiting.  A ``worker`` process retires
gracefully on SIGTERM too (drain in-flight, flush, goodbye).

Topology and sizing guidance: docs/operations.md "Disaggregated ingest
service".  Trainers connect with ``make_reader(...,
service_address='HOST:7737')``.

The dispatcher binds loopback by default.  The v2 wire is pickle-free
binary frames (parsing service bytes can no longer execute code), but the
service's *job* is running client-shipped worker factories on the fleet -
so the handshake secret (``$PETASTORM_TPU_SERVICE_TOKEN`` or
``--auth-token-file``) decides who may ship code to workers.  Bind
non-loopback interfaces only on trusted networks, with the token set on
every party.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from typing import List, Optional


_TRUST_WARNING = (
    "SECURITY: the v2 wire is pickle-free binary frames (merely reaching"
    " the port no longer yields code execution), but workers execute the"
    " worker factory each REGISTERED client ships - that is the service's"
    " job.  Set a shared secret via $PETASTORM_TPU_SERVICE_TOKEN or"
    " --auth-token-file (all parties must agree) to decide who may"
    " register, and expose non-loopback interfaces only on trusted"
    " networks.  See docs/operations.md 'Disaggregated ingest service'.")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="petastorm-tpu-torch-service",
        description="Disaggregated ingest service: dispatcher + workers",
        epilog=_TRUST_WARNING)
    sub = parser.add_subparsers(dest="command", required=True)

    d = sub.add_parser("dispatcher", help="run the dispatcher control plane",
                       epilog=_TRUST_WARNING)
    d.add_argument("--host", default="127.0.0.1",
                   help="bind address (default loopback; binding a"
                   " non-loopback interface exposes remote code execution"
                   " to that network - see the SECURITY note below)")
    d.add_argument("--port", type=int, default=7737,
                   help="listen port (0 = ephemeral, printed at start)")
    d.add_argument("--heartbeat-timeout", type=float, default=10.0,
                   metavar="S", help="declare a silent worker dead after"
                   " this many seconds (default 10)")
    d.add_argument("--client-grace", type=float, default=30.0, metavar="S",
                   help="keep a disconnected client's state this long for a"
                   " reconnect (default 30)")
    d.add_argument("--max-requeue-attempts", type=int, default=None,
                   help="default per-item requeue budget for clients that"
                   " do not bring their own")
    d.add_argument("--assignment-deadline", type=float, default=None,
                   metavar="S", help="liveness backstop: drop a worker"
                   " whose assigned item produced no outcome for S seconds"
                   " (it keeps heartbeating while wedged in user code);"
                   " size WELL above the slowest legitimate decode."
                   " Default off")
    d.add_argument("--metrics-port", type=int, default=None, metavar="N",
                   help="serve service.* series in Prometheus text format"
                   " on localhost:N (0 = ephemeral)")
    d.add_argument("--stats-interval", type=float, default=0.0, metavar="S",
                   help="print a JSON stats line (fleet, clients, scaling"
                   " signal) every S seconds (0 = off)")
    d.add_argument("--auth-token-file", default=None, metavar="PATH",
                   help="file holding the shared handshake secret every"
                   " hello must present (overrides"
                   " $PETASTORM_TPU_SERVICE_TOKEN)")
    d.add_argument("--journal", default=None, metavar="PATH",
                   help="session journal file for WARM restarts: client"
                   " sessions + unresolved work items replay from it on"
                   " start, and reconnecting clients skip re-sending what"
                   " it restored.  Crash recovery works WITHOUT it (peers"
                   " reconstruct the state); the journal just makes a"
                   " restart cheaper (docs/operations.md 'Fault domains')")
    d.add_argument("--journal-fsync", action="store_true",
                   help="fsync every journal record (power-loss-proof tail"
                   " at a device round-trip per append, metered as"
                   " service.journal_fsyncs; default off - flush-only, a"
                   " host power loss can truncate the tail and peers/"
                   "standby re-fetch the difference)")
    d.add_argument("--standby-of", default=None, metavar="HOST:PORT",
                   help="run as the HOT STANDBY of the primary dispatcher"
                   " at HOST:PORT: tail its session journal over the wire"
                   " (journal_sync frames), refuse client/worker hellos"
                   " while it lives, and promote with warm state when it"
                   " dies.  Point peers at a failover list"
                   " 'primary:port,standby:port' so they rotate here on"
                   " promotion (docs/operations.md 'Dispatcher HA')")
    d.add_argument("--replay-buffer-mb", type=int, default=256, metavar="MB",
                   help="cap on unacked result BODIES retained for"
                   " reconnect replay, across all clients (default 256);"
                   " overflow degrades the oldest to header-only and the"
                   " owning client re-fetches on reconnect"
                   " (service.replay_bodies_dropped)")
    d.add_argument("--compression", default=None,
                   choices=["auto", "off", "zlib"],
                   help="result-batch body compression, negotiated per"
                   " (worker, client) pair: 'auto' (default) compresses"
                   " cross-host hops only, 'off' never, 'zlib' wherever"
                   " both ends support it (defaults to"
                   " $PETASTORM_TPU_SERVICE_COMPRESSION)")
    d.add_argument("--starved-threshold", type=float, default=None,
                   metavar="X", help="scaling-signal pressure (starved-"
                   "seconds per second) above which the signal recommends"
                   " grow (default: the in-process autotune policy's"
                   " starved_threshold)")
    d.add_argument("--max-clients", type=int, default=None, metavar="N",
                   help="admission control: refuse NEW client sessions past"
                   " N live ones (reconnects always pass; default"
                   " unbounded)")
    d.add_argument("--max-client-inflight", type=int, default=None,
                   metavar="N", help="per-client cap on items in flight at"
                   " workers: a client at the cap waits for its own results"
                   " before being assigned more, so one greedy trainer"
                   " degrades itself, not the fleet (default: bounded only"
                   " by each client's window)")

    w = sub.add_parser("worker", help="run one fleet worker",
                       epilog=_TRUST_WARNING)
    w.add_argument("--address", required=True, metavar="HOST:PORT",
                   help="dispatcher address; a comma-separated failover"
                   " list 'primary:port,standby:port' makes registration"
                   " rotate onto the promoted standby when the primary"
                   " dies (pair with --reconnect-attempts)")
    w.add_argument("--capacity", type=int, default=2,
                   help="concurrent work items this worker accepts"
                   " (default 2)")
    w.add_argument("--name", default=None, help="worker name (default"
                   " assigned by the dispatcher)")
    w.add_argument("--shm-size-mb", type=int, default=0, metavar="MB",
                   help="arm the co-located-client shared-memory fast path"
                   " with an arena this large (0 = plain frame payloads;"
                   " needs the native transport plane)")
    w.add_argument("--reconnect-attempts", type=int, default=0,
                   help="survive dispatcher restarts: retry registration"
                   " this many times (default 0 = exit with the dispatcher)")
    w.add_argument("--auth-token-file", default=None, metavar="PATH",
                   help="file holding the dispatcher's shared handshake"
                   " secret (overrides $PETASTORM_TPU_SERVICE_TOKEN)")

    a = sub.add_parser(
        "autoscale", help="run the closed-loop fleet supervisor",
        epilog="The supervisor spawns `worker` subprocesses against"
               " --address (or invokes --exec-hook) off the dispatcher's"
               " grow/ok/shrink scaling signal.  Scale-down is graceful:"
               " the worker drains its in-flight items before exiting, so"
               " deterministic streams ride scale events untouched.  See"
               " docs/operations.md 'Fleet autoscaling & QoS'.")
    a.add_argument("--address", required=True, metavar="HOST:PORT",
                   help="dispatcher address to supervise; a comma-"
                   "separated failover list 'primary:port,standby:port'"
                   " keeps the supervisor probing through a dispatcher"
                   " failover instead of reporting a dead fleet")
    a.add_argument("--min-workers", type=int, default=1,
                   help="fleet floor, held self-healingly (default 1)")
    a.add_argument("--max-workers", type=int, default=8,
                   help="fleet ceiling (default 8)")
    a.add_argument("--poll-interval", type=float, default=1.0, metavar="S",
                   help="scaling-signal poll cadence (default 1s)")
    a.add_argument("--grow-windows", type=int, default=3, metavar="N",
                   help="consecutive grow verdicts before a scale-up"
                   " (default 3)")
    a.add_argument("--shrink-windows", type=int, default=6, metavar="N",
                   help="consecutive shrink verdicts before a scale-down"
                   " (default 6)")
    a.add_argument("--settle", type=float, default=5.0, metavar="S",
                   help="post-scale-event settle window before verdicts"
                   " accumulate again (default 5s)")
    a.add_argument("--capacity", type=int, default=2,
                   help="capacity of spawned workers (default 2)")
    a.add_argument("--starved-threshold", type=float, default=None,
                   metavar="X", help="override the grow pressure threshold"
                   " for this supervisor (default: whatever the dispatcher"
                   " reports)")
    a.add_argument("--drain-timeout", type=float, default=30.0, metavar="S",
                   help="graceful-drain budget per retirement before a"
                   " force-kill (default 30s)")
    a.add_argument("--shm-size-mb", type=int, default=0, metavar="MB",
                   help="arm spawned workers' co-located shm fast path"
                   " (default 0 = off)")
    a.add_argument("--exec-hook", default=None, metavar="CMD",
                   help="replace local spawning: run CMD through the shell"
                   " with one JSON scale event on stdin ({action:"
                   " scale_up|scale_down, address, workers, target,"
                   " pressure, recommendation, reason, policy}) - the"
                   " orchestrator owns the fleet; bounds then apply to the"
                   " OBSERVED worker count")
    a.add_argument("--auth-token-file", default=None, metavar="PATH",
                   help="file holding the dispatcher's shared handshake"
                   " secret (overrides $PETASTORM_TPU_SERVICE_TOKEN)")

    s = sub.add_parser(
        "stats", help="print one dispatcher stats snapshot (or a live"
        " top-style fleet view with --watch)")
    s.add_argument("--address", required=True, metavar="HOST:PORT")
    s.add_argument("--watch", action="store_true",
                   help="refresh a top-style fleet view (per-worker load,"
                   " fleet-merged stage/hop latencies, counter rates, the"
                   " structured event tail) every --interval seconds"
                   " instead of printing one JSON snapshot")
    s.add_argument("--interval", type=float, default=2.0, metavar="S",
                   help="--watch refresh cadence (default 2s)")
    s.add_argument("--auth-token-file", default=None, metavar="PATH",
                   help="file holding the dispatcher's shared handshake"
                   " secret (overrides $PETASTORM_TPU_SERVICE_TOKEN)")
    return parser


def _auth_token(args) -> Optional[str]:
    """The handshake secret for this invocation: --auth-token-file wins,
    else $PETASTORM_TPU_SERVICE_TOKEN (resolved by each component)."""
    if args.auth_token_file is None:
        return None
    with open(args.auth_token_file, encoding="utf-8") as f:
        token = f.read().strip()
    if not token:
        raise SystemExit(f"auth token file {args.auth_token_file} is empty")
    return token


def _run_dispatcher(args) -> int:
    from petastorm_tpu_torch.errors import DEFAULT_REQUEUE_ATTEMPTS
    from petastorm_tpu_torch.service.dispatcher import Dispatcher
    from petastorm_tpu_torch.telemetry import Telemetry

    dispatcher = Dispatcher(
        host=args.host, port=args.port, telemetry=Telemetry(),
        heartbeat_timeout_s=args.heartbeat_timeout,
        client_grace_s=args.client_grace,
        max_requeue_attempts=(args.max_requeue_attempts
                              if args.max_requeue_attempts is not None
                              else DEFAULT_REQUEUE_ATTEMPTS),
        assignment_deadline_s=args.assignment_deadline,
        metrics_port=args.metrics_port,
        auth_token=_auth_token(args),
        wire_codec=args.compression,
        journal_path=args.journal,
        journal_fsync=args.journal_fsync,
        standby_of=args.standby_of,
        replay_buffer_bytes=args.replay_buffer_mb * 2 ** 20,
        starved_threshold=args.starved_threshold,
        max_clients=args.max_clients,
        max_client_inflight=args.max_client_inflight)
    dispatcher.start()
    print(f"dispatcher listening on {args.host}:{dispatcher.port}",
          flush=True)
    if args.standby_of:
        print(f"standby of {args.standby_of}", flush=True)
    if dispatcher.metrics_server is not None:
        print(f"metrics: http://127.0.0.1:{dispatcher.metrics_server.port}"
              "/metrics", flush=True)
    try:
        while True:
            time.sleep(args.stats_interval or 3600.0)
            if args.stats_interval:
                print(json.dumps(dispatcher.stats()), flush=True)
    except KeyboardInterrupt:
        print("dispatcher stopping", flush=True)
    finally:
        dispatcher.stop()
        dispatcher.join()
    return 0


def _run_worker(args) -> int:
    from petastorm_tpu_torch.service.worker import run_worker

    try:
        return run_worker(args.address, capacity=args.capacity,
                          name=args.name,
                          shm_size_bytes=args.shm_size_mb * 2 ** 20,
                          reconnect_attempts=args.reconnect_attempts,
                          auth_token=_auth_token(args),
                          # SIGTERM = graceful drain (the autoscale
                          # supervisor's scale-down path); 2nd = hard stop
                          install_signal_handlers=True)
    except KeyboardInterrupt:
        return 0


def _run_autoscale(args) -> int:
    from petastorm_tpu_torch.service.autoscale import (AutoscalePolicy,
                                                 AutoscaleSupervisor,
                                                 ExecHookSpawner,
                                                 SubprocessSpawner)

    policy = AutoscalePolicy(
        min_workers=args.min_workers, max_workers=args.max_workers,
        poll_interval_s=args.poll_interval, grow_windows=args.grow_windows,
        shrink_windows=args.shrink_windows, settle_s=args.settle,
        worker_capacity=args.capacity,
        starved_threshold=args.starved_threshold,
        drain_timeout_s=args.drain_timeout)
    if args.exec_hook:
        spawner = ExecHookSpawner(args.exec_hook)
    else:
        spawner = SubprocessSpawner(
            args.address, capacity=args.capacity,
            shm_size_mb=args.shm_size_mb,
            auth_token_file=args.auth_token_file)
    supervisor = AutoscaleSupervisor(
        args.address, policy=policy, spawner=spawner,
        auth_token=_auth_token(args),
        on_event=lambda e: print(json.dumps(e), flush=True))
    print(json.dumps({"event": "supervising", "address": args.address,
                      "min_workers": policy.min_workers,
                      "max_workers": policy.max_workers,
                      "exec_hook": bool(args.exec_hook)}), flush=True)

    import signal as _signal

    def _on_term(_signum, _frame):
        raise KeyboardInterrupt  # unify SIGTERM with Ctrl-C: drain + exit

    try:
        _signal.signal(_signal.SIGTERM, _on_term)
    except ValueError:
        pass
    try:
        supervisor.run()
    except KeyboardInterrupt:
        print(json.dumps({"event": "stopping"}), flush=True)
    finally:
        supervisor.stop()  # graceful fleet drain (bounded per worker)
        print(json.dumps({"event": "stopped",
                          "summary": supervisor.summary()}), flush=True)
    return 0


def _probe(address: str, token, kind: str, timeout: float = 10.0):
    """One-shot dispatcher probe (``stats?`` / ``fleet?`` / ``events?``):
    short-lived connection, one reply frame, payload or None."""
    from petastorm_tpu_torch.service.protocol import connect_frames, parse_address

    conn = connect_frames(parse_address(address))
    try:
        conn.send({"t": kind, "token": token})
        reply = conn.recv(timeout=timeout)
    finally:
        conn.close()
    if not isinstance(reply, dict):
        return None
    return reply.get(kind.rstrip("?"))


def render_fleet_frame(stats: Optional[dict], fleet: Optional[dict],
                       prev_fleet: Optional[dict] = None,
                       dt_s: float = 0.0, elapsed_s: float = 0.0) -> str:
    """One ``stats --watch`` frame: the fleet aggregation plane rendered
    top-style.  Pure function of two probe payloads (plus the previous
    fleet snapshot for counter rates) so tests render from canned dicts."""
    lines = []
    fleet = fleet or {}
    stats = stats or {}
    workers = fleet.get("workers", {}) or {}
    lines.append(
        f"== petastorm-tpu fleet  t={elapsed_s:6.1f}s"
        f"  epoch={fleet.get('epoch', '?')}"
        f"  uptime={fleet.get('uptime_s', 0.0):.0f}s"
        f"  workers={len(workers)} ==")
    ha = stats.get("ha") or {}
    if ha:
        parts = [f"role={ha.get('role', '?')}",
                 f"journal_seq={ha.get('journal_seq', 0)}"]
        for peer, st in sorted((ha.get("standbys") or {}).items()):
            parts.append(f"standby {peer}:"
                         f" lag={st.get('standby_lag_items', '?')} item(s)")
        if ha.get("role") == "standby":
            parts.append(f"lag={ha.get('standby_lag_items', '?')} item(s)")
        lines.append("ha: " + "  ".join(parts))
    if workers:
        lines.append(f"{'worker':<14} {'busy/cap':>9} {'infl':>5}"
                     f" {'hb_age':>7} {'exec_p50ms':>11} {'exec_p99ms':>11}")
        for name in sorted(workers):
            w = workers[name]
            hists = w.get("hists", {}) or {}
            ex = (hists.get("service.hop.worker_exec")
                  or hists.get("stage.service.encode.latency_s") or {})
            p50 = (f"{ex['p50_s'] * 1e3:>11.1f}"
                   if ex.get("p50_s") is not None and ex.get("count")
                   else f"{'-':>11}")
            p99 = (f"{ex['p99_s'] * 1e3:>11.1f}"
                   if ex.get("p99_s") is not None and ex.get("count")
                   else f"{'-':>11}")
            drain = "  (draining)" if w.get("draining") else ""
            lines.append(
                f"{name:<14} {w.get('busy', 0):>4}/{w.get('capacity', 0):<4}"
                f" {w.get('inflight', 0):>5}"
                f" {w.get('heartbeat_age_s', 0.0):>6.1f}s {p50} {p99}"
                f"{drain}")
    else:
        lines.append("workers: (none registered)")
    merged = fleet.get("merged_hists", {}) or {}
    hops = {n: h for n, h in merged.items() if n.startswith("service.hop.")}
    if hops:
        hop_parts = []
        for n in sorted(hops):
            h = hops[n]
            if not h.get("count"):
                continue
            hop_parts.append(f"{n[len('service.hop.'):]}"
                             f"={h.get('p50_s', 0.0) * 1e3:.1f}"
                             f"/{h.get('p99_s', 0.0) * 1e3:.1f}ms")
        if hop_parts:
            lines.append("fleet hop p50/p99: " + "  ".join(hop_parts))
    counters = fleet.get("fleet_counters", {}) or {}
    if prev_fleet and dt_s > 0:
        prev_counters = prev_fleet.get("fleet_counters", {}) or {}
        rates = sorted(
            ((n, (v - prev_counters.get(n, 0.0)) / dt_s)
             for n, v in counters.items()),
            key=lambda kv: -kv[1])
        top = [f"{n}={r:.1f}/s" for n, r in rates[:6] if r > 0]
        if top:
            lines.append("fleet rates: " + "  ".join(top))
    scaling = fleet.get("scaling") or stats.get("scaling") or {}
    if scaling:
        lines.append(
            f"scaling: {scaling.get('recommendation', '?')}"
            f"  pressure={scaling.get('pressure', 0.0):.2f}"
            f"  workers={scaling.get('workers', len(workers))}")
    events = fleet.get("events") or ()
    if events:
        lines.append("events (newest last):")
        for ev in list(events)[-8:]:
            extra = "  ".join(
                f"{k}={v}" for k, v in sorted(ev.items())
                if k not in ("ts", "src", "kind"))
            lines.append(f"  [{ev.get('src', '?'):>10}]"
                         f" {ev.get('kind', '?')}"
                         + (f"  {extra}" if extra else ""))
    return "\n".join(lines)


def _run_stats(args) -> int:
    from petastorm_tpu_torch.service.protocol import resolve_auth_token

    token = resolve_auth_token(_auth_token(args))
    if not args.watch:
        payload = _probe(args.address, token, "stats?")
        if payload is None:
            print("unexpected reply from dispatcher", file=sys.stderr)
            return 1
        print(json.dumps(payload, indent=2, sort_keys=True))
        return 0
    clear = "\x1b[H\x1b[2J" if sys.stdout.isatty() else ""
    prev_fleet, prev_t = None, None
    t0 = time.monotonic()
    try:
        while True:
            try:
                stats = _probe(args.address, token, "stats?")
                fleet = _probe(args.address, token, "fleet?")
            except OSError as exc:
                print(f"{clear}dispatcher unreachable: {exc}", flush=True)
                time.sleep(args.interval)
                continue
            now = time.monotonic()
            frame = render_fleet_frame(
                stats, fleet, prev_fleet,
                dt_s=(now - prev_t) if prev_t is not None else 0.0,
                elapsed_s=now - t0)
            print(f"{clear}{frame}" + ("" if clear else "\n"), flush=True)
            prev_fleet, prev_t = fleet, now
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


def main(argv: Optional[List[str]] = None) -> int:
    # dispatcher/worker processes are I/O pumps with a few cooperating
    # threads; the default 5ms GIL switch interval adds whole milliseconds
    # of convoy latency per relayed frame on busy hosts
    sys.setswitchinterval(0.001)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    args = build_parser().parse_args(argv)
    if args.command == "dispatcher":
        return _run_dispatcher(args)
    if args.command == "worker":
        return _run_worker(args)
    if args.command == "autoscale":
        return _run_autoscale(args)
    return _run_stats(args)


if __name__ == "__main__":
    sys.exit(main())
