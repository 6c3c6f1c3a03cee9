"""The port's ingest service (``petastorm_tpu_torch/service/``) end to end,
against local reads of the port and of the JAX package, on the CPU.

After ``tests/test_service.py``: a service read of phase 6's shape at test
size (labelled JPEGs, several rowgroups) gives the rows, the order and the
``stream_digest`` of a local port read and of a local JAX read, under a
seed, over shuffled epochs and from a resume cursor; two clients get their
exact row multisets; with ``cache_type='shared'`` the fleet decodes each
rowgroup once, as the JAX fleet does; ``on_error='skip'`` quarantines what
the JAX service quarantines; a worker process killed by SIGKILL, a dropped
client connection and an assignment deadline lose and repeat no row; a lost
dispatcher, a spent requeue budget and an unpicklable result raise; a
co-located worker with an arena sends ``"shm"`` payloads; the reader's
errors and warnings are the JAX text; a service worker process imports no
``torch``; and the device route through the service gives a local read's
pixels through B2's plain version.  The fleets run in-process (dispatcher
and workers on threads) unless a test needs a process to die.  Every wait
is bounded.
"""

import functools
import logging
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import uuid

import numpy as np
import pytest

from petastorm_tpu import reader as jax_reader
from petastorm_tpu.service.dispatcher import Dispatcher as JaxDispatcher
from petastorm_tpu.service.worker import ServiceWorker as JaxServiceWorker
from petastorm_tpu.telemetry import Telemetry as JaxTelemetry
from petastorm_tpu.test_util.chaos import ChaosSpec as JaxChaosSpec

from petastorm_tpu_torch import CompressedImageCodec, Field, Schema, reader
from petastorm_tpu_torch.cuda.loader import CudaDataLoader
from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.etl.writer import write_dataset
from petastorm_tpu_torch.ops import jpeg as jpeg_ops
from petastorm_tpu_torch.pool import WorkerError
from petastorm_tpu_torch.retry import RetryPolicy
from petastorm_tpu_torch.service.client import ServiceConnectionError, ServiceExecutor
from petastorm_tpu_torch.service.dispatcher import Dispatcher
from petastorm_tpu_torch.service.worker import ServiceWorker
from petastorm_tpu_torch.telemetry import Telemetry
from petastorm_tpu_torch.test_util.chaos import ChaosSpec
from petastorm_tpu_torch.test_util.synthetic import synthetic_rgb_image

N_ROWS, RG_ROWS, SIDE = 96, 8, 32  # 12 rowgroups of 32x32 JPEGs
FAST_RECONNECT = RetryPolicy(max_attempts=3, initial_backoff_s=0.05,
                             backoff_multiplier=1.5, max_backoff_s=0.3)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class SleepForeverFactory:
    def __call__(self):
        def fn(item):  # noqa: ARG001 - pretends to work forever
            time.sleep(3600)

        return fn


class HangFirstAttemptFactory:
    """Wedges attempt 0 of every item; a requeued attempt completes."""

    def __call__(self):
        def fn(vitem):
            if vitem.attempt == 0:
                time.sleep(3600)
            return ("recovered", vitem.ordinal)

        fn.takes_ventilated_items = True
        return fn


class UnpicklableResultFactory:
    def __call__(self):
        return lambda item: threading.Lock()


ECHO = functools.partial(eval, "lambda item: ('echo', item)")


@pytest.fixture(scope="module")
def url(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("svc") / "jpegs")
    schema = Schema("SvcJpeg", [
        Field("label", np.int64),
        Field("image", np.uint8, (SIDE, SIDE, 3), CompressedImageCodec("jpeg", quality=90))])
    labels = np.random.default_rng(6).permutation(N_ROWS)
    write_dataset(path, schema, [{"label": int(lab), "image": synthetic_rgb_image(int(lab), SIDE, SIDE)}
                                 for lab in labels], row_group_size_rows=RG_ROWS)
    return path


def _wait_for(cond, timeout=15.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


class _Fleet:
    """A dispatcher and ``n`` workers on threads, in either package."""

    def __init__(self, jax=False, n=2, capacity=2, shm_size_bytes=0, **disp_kwargs):
        disp_cls, worker_cls, tele = ((JaxDispatcher, JaxServiceWorker, JaxTelemetry) if jax
                                      else (Dispatcher, ServiceWorker, Telemetry))
        self.disp = disp_cls(telemetry=tele(), heartbeat_timeout_s=5.0, **disp_kwargs).start()
        self.addr = f"127.0.0.1:{self.disp.port}"
        kw = {"shm_size_bytes": shm_size_bytes} if shm_size_bytes else {}
        self.workers = [worker_cls(self.addr, capacity=capacity, name=f"w{i}",
                                   heartbeat_interval_s=0.2, **kw) for i in range(n)]
        self.threads = [threading.Thread(target=w.run, daemon=True) for w in self.workers]
        for t in self.threads:
            t.start()
        _wait_for(lambda: len(self.disp.stats()["workers"]) == n, what="workers registered")

    def close(self):
        for w in self.workers:
            w.stop()
        for t in self.threads:
            t.join(timeout=10.0)
        self.disp.stop()
        self.disp.join()


@pytest.fixture
def fleet():
    f = _Fleet()
    try:
        yield f
    finally:
        f.close()


def _read(mod, url, **kwargs):
    """(labels in delivery order, stream digest, diagnostics) of one read."""
    with mod.make_batch_reader(url, schema_fields=["label"], **kwargs) as r:
        labels = [int(x) for b in r.iter_batches() for x in b.columns["label"]]
        return labels, r.stream_digest, r.diagnostics


# -- one client ------------------------------------------------------------------------------

@pytest.mark.parametrize("epochs,seed", [(1, 3), (3, 5), (2, None)])
def test_a_service_read_is_the_local_reads(url, fleet, epochs, seed):
    kw = dict(num_epochs=epochs, shuffle_seed=seed, shuffle_row_groups=seed is not None)
    svc, svc_digest, diag = _read(reader, url, service_address=fleet.addr, **kw)
    local, local_digest, _ = _read(reader, url, **kw)
    jax_local, jax_digest, _ = _read(jax_reader, url, **kw)
    assert svc == local and svc_digest == local_digest
    assert sorted(svc) == sorted(jax_local) == sorted(list(range(N_ROWS)) * epochs)
    if seed is not None:  # unseeded, the JAX reader delivers in completion order
        assert svc == jax_local and svc_digest == jax_digest
    assert diag["consumed"] == epochs * N_ROWS // RG_ROWS
    assert diag["payloads"] == {"shm": 0, "bin": epochs * N_ROWS // RG_ROWS, "pickle": 0}


def test_a_service_cursor_resumes_as_the_local_one(url, fleet):
    kw = dict(shuffle_seed=7, num_epochs=2)
    with reader.make_batch_reader(url, schema_fields=["label"], service_address=fleet.addr,
                                  **kw) as r:
        it = r.iter_batches()
        head = [int(x) for _ in range(5) for x in next(it).columns["label"]]
        issued = r.quiesce()
        head += [int(x) for b in it for x in b.columns["label"]]
        state = r.state_dict()
    assert state["ordinal_exact"] and state["position"] == issued
    rest, digest, _ = _read(reader, url, service_address=fleet.addr, resume_from=state, **kw)
    local, local_digest, _ = _read(reader, url, **kw)
    assert head + rest == local and digest == local_digest
    with jax_reader.make_batch_reader(url, schema_fields=["label"], resume_from=state,
                                      **kw) as r:
        assert [int(x) for b in r.iter_batches() for x in b.columns["label"]] == rest
        assert r.stream_digest == digest


def test_two_clients_get_their_exact_multisets(url, fleet):
    out = {}

    def read(tag, epochs, seed):
        out[tag] = _read(reader, url, service_address=fleet.addr, num_epochs=epochs,
                         shuffle_seed=seed)[0]

    threads = [threading.Thread(target=read, args=("a", 1, 0)),
               threading.Thread(target=read, args=("b", 2, 1))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert out["a"] == _read(reader, url, shuffle_seed=0)[0]
    assert sorted(out["b"]) == sorted(list(range(N_ROWS)) * 2)


def test_the_fleet_decodes_each_rowgroup_once_as_the_jax_fleet(url, tmp_path):
    results = {}
    for name, mod in (("jax", jax_reader), ("torch", reader)):
        f = _Fleet(jax=name == "jax")
        loc = str(tmp_path / f"tier_{name}_{uuid.uuid4().hex[:8]}")
        try:
            reads = [_read(mod, url, service_address=f.addr, shuffle_seed=1, cache_type="shared",
                           cache_location=loc, telemetry=(JaxTelemetry if name == "jax"
                                                          else Telemetry)())
                     for _ in range(2)]
            _wait_for(lambda: f.disp.stats()["counters"].get(
                "service.fleet.worker.rowgroups_decoded", 0) >= 2 * N_ROWS // RG_ROWS,
                what="fleet heartbeat counters")
            stats = reads[1][2]["cache"]
            results[name] = ([r[0] for r in reads], stats["misses"],
                             stats["hits"] + stats.get("l2_hits", 0))
        finally:
            f.close()
            _unlink_tier(loc, name == "jax")
    assert results["torch"][0][0] == results["torch"][0][1] == results["jax"][0][0]
    # every rowgroup decoded once, by the first client; the second is served by the tier
    assert results["torch"][1:] == results["jax"][1:] == (N_ROWS // RG_ROWS, N_ROWS // RG_ROWS)


def _unlink_tier(location, jax):
    """Remove a shared tier's segments (named after its location)."""
    from petastorm_tpu import cache_shared as jax_cache_shared
    from petastorm_tpu_torch import cache_shared

    mod = jax_cache_shared if jax else cache_shared
    mod.SharedWarmCache(location=location, l1_bytes=2 ** 20).cleanup()


def test_two_concurrent_tenants_decode_each_rowgroup_once_on_the_shared_tier(url, tmp_path):
    """The port's tier fills a key once host-wide (``cache_shared.FILL_STRIPES``):
    two tenants reading at once through the fleet miss each rowgroup once."""
    f = _Fleet(n=3, capacity=2)
    loc = str(tmp_path / f"tier_{uuid.uuid4().hex[:8]}")
    out = {}

    def read(tag, seed):
        out[tag] = _read(reader, url, service_address=f.addr, shuffle_seed=seed,
                         cache_type="shared", cache_location=loc)

    try:
        threads = [threading.Thread(target=read, args=(t, s)) for t, s in (("a", 0), ("b", 1))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        from petastorm_tpu_torch.cache_shared import SharedWarmCache

        stats = SharedWarmCache(location=loc, l1_bytes=2 ** 20).stats()
    finally:
        f.close()
        _unlink_tier(loc, False)
    assert out["a"][0] == _read(reader, url, shuffle_seed=0)[0]
    assert sorted(out["b"][0]) == list(range(N_ROWS))
    groups = N_ROWS // RG_ROWS
    assert stats["misses"] == groups and stats["hits"] + stats["l2_hits"] == groups, stats


def test_on_error_skip_quarantines_what_the_jax_service_does(url, fleet):
    jf = _Fleet(jax=True)
    try:
        jax_out = _read(jax_reader, url, service_address=jf.addr, shuffle_seed=2,
                        on_error="skip", chaos=JaxChaosSpec(decode_fail_ordinals=(3,)))
    finally:
        jf.close()
    out = _read(reader, url, service_address=fleet.addr, shuffle_seed=2, on_error="skip",
                chaos=ChaosSpec(decode_fail_ordinals=(3,)))
    assert out[0] == sorted(jax_out[0], key=out[0].index) and len(out[0]) == N_ROWS - RG_ROWS
    assert out[1] == jax_out[1]
    for diag in (out[2], jax_out[2]):
        assert diag["skipped_rowgroups"] == 1
    keys = ("ordinal", "path", "row_group", "kind", "exc_type")
    assert ([{k: e[k] for k in keys} for e in out[2]["quarantined_rowgroups"]]
            == [{k: e[k] for k in keys} for e in jax_out[2]["quarantined_rowgroups"]])


# -- failures --------------------------------------------------------------------------------

def _spawn_worker_proc(addr, name, capacity=2, shm_mb=0):
    cmd = [sys.executable, "-m", "petastorm_tpu_torch.service.cli", "worker",
           "--address", addr, "--capacity", str(capacity), "--name", name]
    if shm_mb:
        cmd += ["--shm-size-mb", str(shm_mb)]
    return subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)


def _reap(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait(timeout=10)


def test_a_worker_process_killed_by_sigkill_loses_and_repeats_no_row(url):
    disp = Dispatcher(telemetry=Telemetry(), heartbeat_timeout_s=5.0).start()
    addr = f"127.0.0.1:{disp.port}"
    procs = [_spawn_worker_proc(addr, f"w{i}") for i in range(2)]
    try:
        _wait_for(lambda: len(disp.stats()["workers"]) == 2, timeout=30.0,
                  what="worker processes registered")
        out = {}
        # ordinal 4 hangs its first attempt: whichever worker holds it dies
        spec = ChaosSpec(hang_ordinals=(4,), hang_s=60.0)

        def read():
            out["run"] = _read(reader, url, service_address=addr, shuffle_seed=4, chaos=spec)

        t = threading.Thread(target=read)
        t.start()

        def holder():
            for name, w in list(disp._workers.items()):  # noqa: SLF001
                if any(o == 4 for _c, o in list(w.inflight)):
                    return name
            return None

        _wait_for(lambda: holder() is not None, timeout=30.0, what="ordinal 4 assigned")
        victim = procs[int(holder()[1:])]
        os.kill(victim.pid, signal.SIGKILL)
        t.join(timeout=60)
        assert not t.is_alive()
        labels, digest, diag = out["run"]
        local, local_digest, _ = _read(reader, url, shuffle_seed=4)
        assert labels == local and digest == local_digest
        assert diag["requeued_items"] >= 1
        assert disp.stats()["counters"].get("service.requeued_items", 0) >= 1
    finally:
        _reap(procs)
        disp.stop()
        disp.join()


def test_a_dropped_client_connection_recovers(url, fleet):
    tele = Telemetry()
    # the items after the cut are held back a second each, so the cut lands
    # mid-stream: results are still to come, and only a reconnect brings them
    held = ChaosSpec(slow_ordinals=tuple(range(4, N_ROWS // RG_ROWS)), slow_s=1.0)
    r = reader.make_batch_reader(url, schema_fields=["label"], service_address=fleet.addr,
                                 shuffle_seed=8, telemetry=tele, chaos=held)
    r._executor._reconnect_policy = FAST_RECONNECT  # noqa: SLF001
    labels = []
    try:
        for i, b in enumerate(r.iter_batches()):
            labels += [int(x) for x in b.columns["label"]]
            if i == 3:
                r._executor._conn._sock.shutdown(socket.SHUT_RDWR)  # noqa: SLF001
        diag = r.diagnostics
    finally:
        r.stop()
        r.join()
    assert labels == _read(reader, url, shuffle_seed=8)[0]
    assert diag["reconnects"] >= 1
    assert tele.snapshot()["counters"]["service.reconnects"] >= 1


def test_the_assignment_deadline_drops_a_hung_worker():
    f = _Fleet(capacity=1, assignment_deadline_s=1.0)
    ex = ServiceExecutor(f.addr, telemetry=Telemetry(), window=2)
    try:
        ex.start(HangFirstAttemptFactory())
        assert list(ex.imap(["wedge-me"])) == [("recovered", 0)]
        counters = f.disp.stats()["counters"]
        assert counters.get("service.hung_workers_dropped", 0) >= 1, counters
        assert counters.get("service.requeued_items", 0) >= 1, counters
        assert ex.requeued_items >= 1
    finally:
        ex.stop()
        ex.join()
        f.close()


def test_a_lost_dispatcher_raises_service_connection_error(url):
    f = _Fleet(n=1)
    r = reader.make_batch_reader(url, service_address=f.addr, shuffle_seed=0,
                                 schema_fields=["label"], results_queue_size=1)
    r._executor._reconnect_policy = FAST_RECONNECT  # noqa: SLF001
    try:
        with pytest.raises(ServiceConnectionError) as info:
            for i, _b in enumerate(r.iter_batches()):
                if i == 1:
                    f.disp.stop()
        assert info.value.kind == "infra"
        assert info.value.diagnostics["service_address"] == f.addr
        assert info.value.diagnostics["connected"] is False
    finally:
        r.stop()
        r.join()
        f.close()


def test_a_spent_requeue_budget_raises_worker_error(fleet):
    ex = ServiceExecutor(fleet.addr, telemetry=Telemetry(), window=2, max_requeue_attempts=0)
    ex.start(SleepForeverFactory())
    got = {}

    def consume():
        try:
            list(ex.imap(["doomed"]))
        except WorkerError as exc:
            got["err"] = exc

    t = threading.Thread(target=consume)
    t.start()
    try:
        _wait_for(lambda: sum(w["inflight"] for w in fleet.disp.stats()["workers"].values()) > 0,
                  what="item assigned")
        for w in fleet.workers:
            w.stop()
        t.join(timeout=30)
        assert "requeue budget exhausted" in str(got["err"])
        assert got["err"].kind == "infra"
        assert ex._stopped  # noqa: SLF001 - stop_on_failure honoured
    finally:
        ex.stop()
        t.join(timeout=10)
        ex.join()


def test_an_unpicklable_result_is_a_failure_not_a_hang(fleet):
    ex = ServiceExecutor(fleet.addr, telemetry=Telemetry(), window=2)
    ex.start(UnpicklableResultFactory())
    try:
        with pytest.raises(WorkerError, match="TypeError|pickle|cannot"):
            list(ex.imap(["unpicklable"]))
    finally:
        ex.stop()
        ex.join()


# -- payloads --------------------------------------------------------------------------------

def test_a_colocated_worker_with_an_arena_sends_shm_payloads(url):
    f = _Fleet(shm_size_bytes=64 << 20)
    try:
        labels, digest, diag = _read(reader, url, service_address=f.addr, shuffle_seed=9,
                                     num_epochs=2)
    finally:
        f.close()
    local, local_digest, _ = _read(reader, url, shuffle_seed=9, num_epochs=2)
    assert labels == local and digest == local_digest
    assert diag["payloads"] == {"shm": 2 * N_ROWS // RG_ROWS, "bin": 0, "pickle": 0}


@pytest.mark.parametrize("allow", [True, False])
def test_the_pickle_fallback_is_counted_and_refused_when_asked(fleet, allow):
    tele = Telemetry()
    ex = ServiceExecutor(fleet.addr, telemetry=tele, window=4, stop_on_failure=False,
                         allow_pickle_results=allow)
    ex.start(ECHO)
    try:
        out = list(ex.imap(["p0", "p1", "p2"]))
    finally:
        ex.stop()
        ex.join()
    if allow:
        assert out == [("echo", "p0"), ("echo", "p1"), ("echo", "p2")]
    else:
        assert all(isinstance(e, WorkerError) and "refuses" in str(e) for e in out)
    # every arrival is counted by its kind; the telemetry counts what was decoded
    assert ex.diagnostics["payloads"] == {"shm": 0, "bin": 0, "pickle": 3}
    assert tele.snapshot()["counters"]["service.frames_pickle_fallback"] == (3 if allow else 0)
    # refused outcomes are acked all the same (no pinned redelivery buffer)
    _wait_for(lambda: all(c["unacked"] == 0 for c in fleet.disp.stats()["clients"].values()),
              what="results acked")


# -- reader validation -----------------------------------------------------------------------

_NOWHERE = "127.0.0.1:1"


@pytest.mark.parametrize("case", ["memory_cache", "qos_without_address",
                                  "priority_without_address", "trace_without_address"])
def test_the_reader_refuses_what_the_jax_reader_refuses(url, case):
    kwargs = {"memory_cache": dict(service_address=_NOWHERE, cache_type="memory"),
              "qos_without_address": dict(service_weight=2.0),
              "priority_without_address": dict(service_priority=1),
              "trace_without_address": dict(trace_items=True)}[case]
    messages = []
    for mod in (jax_reader, reader):
        with pytest.raises(Exception) as info:
            mod.make_batch_reader(url, **kwargs)
        messages.append(str(info.value))
    assert messages[0] == messages[1]
    assert type(info.value) is PetastormTpuError


@pytest.mark.parametrize("case", ["autotune", "liveness"])
def test_the_reader_warns_as_the_jax_reader_warns(url, case, caplog):
    kwargs = {"autotune": dict(autotune=True),
              "liveness": dict(item_deadline_s=5.0, hedge_after_s=2.0)}[case]
    warned = []
    for mod in (jax_reader, reader):
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            with pytest.raises(OSError):  # nothing listens there
                mod.make_batch_reader(url, service_address=_NOWHERE, **kwargs)
        warned.append([r.getMessage() for r in caplog.records
                       if "inoperative with service_address" in r.getMessage()])
    assert warned[0] == warned[1] and len(warned[1]) == 1


def test_a_service_reader_drops_the_liveness_knobs_and_reads(url, fleet):
    labels, _, diag = _read(reader, url, service_address=fleet.addr, shuffle_seed=0,
                            item_deadline_s=5.0, hedge_after_s=2.0, workers_count="auto",
                            reader_pool_type="process")
    assert labels == _read(reader, url, shuffle_seed=0)[0]
    assert diag["connected"] is True and diag["service_address"] == fleet.addr


def test_the_service_stage_is_registered_up_front(url, fleet):
    tele = Telemetry()
    with reader.make_batch_reader(url, service_address=fleet.addr, telemetry=tele) as r:
        assert "stage.service.count" in tele.snapshot()["counters"]
        sum(b.num_rows for b in r.iter_batches())
    assert tele.snapshot()["counters"]["service.results"] == N_ROWS // RG_ROWS


# -- processes -------------------------------------------------------------------------------

_PROBE = ("lambda item: sorted({m.split('.')[0] for m in __import__('sys').modules}"
          " & {'torch', 'jax', 'petastorm_tpu', 'petastorm_tpu_torch'})")


def test_a_service_worker_process_imports_no_torch():
    assert "torch" in sys.modules  # this process has it
    disp = Dispatcher(telemetry=Telemetry()).start()
    addr = f"127.0.0.1:{disp.port}"
    procs = [_spawn_worker_proc(addr, "probe")]
    ex = ServiceExecutor(addr, telemetry=Telemetry(), window=2)
    try:
        _wait_for(lambda: len(disp.stats()["workers"]) == 1, timeout=30.0,
                  what="worker process registered")
        ex.start(functools.partial(eval, _PROBE))
        assert list(ex.imap([0])) == [["petastorm_tpu_torch"]]
    finally:
        ex.stop()
        ex.join()
        _reap(procs)
        disp.stop()
        disp.join()


def test_the_service_processes_modules_import_no_torch():
    code = ("import sys\n"
            "from petastorm_tpu_torch.service import autoscale, cli, dispatcher, journal, worker\n"
            "from petastorm_tpu_torch.test_util import netchaos\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'torch', 'jax', 'petastorm_tpu'}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# -- the device route ------------------------------------------------------------------------

def test_the_device_route_through_the_service_gives_a_local_reads_pixels(url, fleet,
                                                                         monkeypatch):
    calls = []
    plain = jpeg_ops._decode_reference  # noqa: SLF001

    def counted(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)

    monkeypatch.setattr(jpeg_ops, "_decode_reference", counted)

    def batches(**kwargs):
        out = []
        with reader.make_batch_reader(url, shuffle_seed=1, **kwargs) as r:
            with CudaDataLoader(r, 16, device="cpu") as loader:
                for b in loader:
                    out.append((b["label"].numpy().copy(), b["image"].numpy().copy()))
        return out

    svc = batches(service_address=fleet.addr, decode_placement={"image": "device"})
    local = batches(decode_placement={"image": "device"})
    host = batches()
    assert calls and len(svc) == len(local) == len(host) == N_ROWS // 16
    for (sl, si), (ll, li), (hl, hi) in zip(svc, local, host):
        assert (sl == ll).all() and (sl == hl).all()
        assert (si == li).all()  # the same planes, the same plain decode
        diff = np.abs(si.astype(int) - hi.astype(int))
        assert diff.max() <= 6 and diff.mean() < 1.0  # the JAX tolerance
