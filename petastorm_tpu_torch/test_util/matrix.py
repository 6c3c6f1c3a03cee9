"""Chaos-matrix determinism harness: run one (seed, epoch) read under an
arbitrary configuration cell and certify the delivered stream.

Counterpart of ``petastorm_tpu/test_util/matrix.py`` over the port's reader,
pools and ``service/``.  The reproducibility invariant is only real if it is
*tested across the whole configuration space*: the same (seed, epochs) read
across {worker counts} x {executor flavors} x {chaos kinds} x {mid-epoch
resize} x {in-process, service transport} x {uninterrupted, quiesce/resume
split} must produce a bit-identical stream in every cell - via two
independent certificates:

* the reader's own :class:`~petastorm_tpu_torch.seeding.StreamDigest` (cheap,
  metadata-level: work-item identity + batch boundaries), and
* ``content_crc`` - a crc chain over the delivered column BYTES in
  delivery order, computed here in the harness.  This is the adversarial
  check on the reader's certificate: if delivery were reordered in a way
  the digest failed to capture (or decoded bytes differed), the content
  chain would diverge even if the digest lied.

Usable from tests and from ad-hoc triage (run two cells by hand, diff the
dicts).  ``run_cell(..., loader=...)`` certifies what a loader delivers
from the cell's reader instead (``CudaDataLoader`` batches, moved to the
host), so the device feed is held to the same certificates.
"""

from __future__ import annotations

import contextlib
import dataclasses
import signal
import subprocess
import sys
import time
import zlib
from typing import Optional

import numpy as np

from petastorm_tpu_torch.errors import PetastormTpuError

#: chaos kinds a cell may name (see cell_kwargs for the exact injections)
CHAOS_KINDS = ("none", "kill", "hang", "hedge")
#: service-plane disruptions a cell may name (fired mid-read by run_cell's
#: ``disruptor`` callable, normally one of the FleetHandle methods);
#: ``elastic-fleet``: a new worker joins AND an original gracefully drains
#: mid-epoch (the autoscale supervisor's grow + retire moves);
#: ``failover``: the primary dispatcher dies mid-epoch (SIGKILL-equivalent
#: or partition) and the hot standby promotes, with peers rotating through
#: their failover address lists (:func:`ha_fleet`)
DISRUPTION_KINDS = ("none", "dispatcher-restart", "netsplit", "netchaos",
                    "elastic-fleet", "failover")


@dataclasses.dataclass(frozen=True)
class MatrixCell:
    """One configuration cell of the determinism matrix."""

    workers: int = 2
    pool: str = "thread"          # thread | process | serial
    chaos: str = "none"           # none | kill | hang | hedge
    resize: bool = False          # mid-epoch executor resize (autotune shape)
    transport: str = "local"      # local | service
    split: str = "none"           # none | quiesce (mid-epoch quiesce+resume)
    disruption: str = "none"      # none | dispatcher-restart | netsplit
    #                             # | netchaos (service transport only)

    def __post_init__(self):
        if self.chaos not in CHAOS_KINDS:
            raise PetastormTpuError(f"unknown chaos kind {self.chaos!r}")
        if self.transport not in ("local", "service"):
            raise PetastormTpuError(f"unknown transport {self.transport!r}")
        if self.split not in ("none", "quiesce"):
            raise PetastormTpuError(f"unknown split {self.split!r}")
        if self.disruption not in DISRUPTION_KINDS:
            raise PetastormTpuError(
                f"unknown disruption {self.disruption!r}")
        if self.disruption != "none" and self.transport != "service":
            raise PetastormTpuError(
                "disruption cells target the service control plane; use"
                " transport='service'")

    def label(self) -> str:
        """Compact cell name for test ids and triage output, e.g.
        ``'3w-thread-kill-resize'``."""
        parts = [f"{self.workers}w", self.pool, self.chaos]
        if self.resize:
            parts.append("resize")
        if self.transport != "local":
            parts.append(self.transport)
        if self.split != "none":
            parts.append(self.split)
        if self.disruption != "none":
            parts.append(self.disruption)
        return "-".join(parts)


@dataclasses.dataclass
class CellResult:
    """What one cell delivered: both certificates + row accounting."""

    digest: dict        # Reader.diagnostics['stream_digest'] summary
    content_crc: int    # crc chain over delivered column bytes, in order
    batch_rows: tuple   # per-delivered-batch row counts (batch boundaries)
    rows: int


def content_crc(crc: int, columns: dict) -> int:
    """Fold one delivered batch's column bytes (sorted field order) into a
    crc chain - the harness-side, content-level certificate."""
    for name in sorted(columns):
        col = columns[name]
        crc = zlib.crc32(name.encode("utf-8"), crc)
        arr = np.asarray(col)
        if arr.dtype == object:
            # object cells (variable shapes / bytes): hash each element's
            # repr - stable across runs for the bytes/ndarray payloads the
            # pipeline ships
            for cell in arr.ravel():
                if isinstance(cell, np.ndarray):
                    crc = zlib.crc32(np.ascontiguousarray(cell).tobytes(), crc)
                elif isinstance(cell, (bytes, bytearray)):
                    crc = zlib.crc32(bytes(cell), crc)
                else:
                    crc = zlib.crc32(repr(cell).encode("utf-8"), crc)
        else:
            crc = zlib.crc32(np.ascontiguousarray(arr).tobytes(), crc)
    return crc


def _host_columns(batch: dict):
    """A loader's batch as host arrays, with its row count (the valid rows
    of a padded tail batch when it says so)."""
    columns = {}
    for name, value in batch.items():
        if hasattr(value, "detach"):
            value = value.detach().cpu().numpy()
        columns[name] = value
    valid = columns.pop("_valid_rows", None)
    rows = (int(np.asarray(valid).sum()) if valid is not None
            else len(next(iter(columns.values()))))
    return columns, rows


def cell_kwargs(cell: MatrixCell) -> dict:
    """``make_batch_reader`` kwargs injecting the cell's chaos flavor.

    Chaos choices are content-preserving on purpose: kills/hangs requeue
    through the attempt budget and hedges dedup, so EVERY cell must deliver
    the identical stream - that is the invariant under test.  (Data-error
    quarantine changes delivered content by design; its determinism is
    tested separately with the same spec on both sides.)
    """
    from petastorm_tpu_torch.test_util.chaos import ChaosSpec

    kwargs: dict = {}
    if cell.chaos == "kill":
        kwargs["chaos"] = ChaosSpec(kill_ordinals=(2, 7))
    elif cell.chaos == "hang":
        # one permanent first-attempt hang; the deadline kills/abandons the
        # worker and the requeued attempt completes
        kwargs["chaos"] = ChaosSpec(hang_ordinals=(3,), hang_s=3600.0)
        kwargs["item_deadline_s"] = 1.0
    elif cell.chaos == "hedge":
        kwargs["chaos"] = ChaosSpec(slow_ordinals=(1, 4), slow_s=0.3)
        kwargs["hedge_after_s"] = 0.05
    return kwargs


def _cell_transport_kwargs(cell: MatrixCell,
                           service_address: Optional[str]) -> dict:
    """The cell's chaos + transport reader kwargs - shared by
    :func:`run_cell` and :func:`run_sequence_cell` so a new cell knob
    (or a new client-side-no-op to drop on the service plane) is handled
    in ONE place."""
    kwargs = cell_kwargs(cell)
    if cell.transport == "service":
        if service_address is None:
            raise PetastormTpuError(
                "transport='service' cells need a service_address")
        kwargs["service_address"] = service_address
        # liveness knobs are client-side no-ops on the service plane; the
        # reader drops them with a warning - drop quietly here
        kwargs.pop("item_deadline_s", None)
        kwargs.pop("hedge_after_s", None)
    else:
        kwargs["reader_pool_type"] = cell.pool
        kwargs["workers_count"] = cell.workers
    return kwargs


def run_cell(dataset_url: str, seed: int, cell: MatrixCell,
             num_epochs: int = 2,
             service_address: Optional[str] = None,
             action_at_batch: int = 5,
             reader_kwargs: Optional[dict] = None,
             disruptor=None, loader=None) -> CellResult:
    """Run one cell's full read and return its certificates.

    ``action_at_batch``: delivered-batch index at which the cell's mid-epoch
    action fires (resize up for ``resize=True`` cells - resized back down at
    ``2 * action_at_batch`` - or quiesce for ``split='quiesce'`` cells).
    ``service_address`` must point at a running dispatcher for
    ``transport='service'`` cells (see :func:`service_fleet`).
    ``disruptor``: zero-arg callable fired ONCE at ``action_at_batch`` for
    ``disruption`` cells - normally :meth:`FleetHandle.restart_dispatcher`
    or :meth:`FleetHandle.netsplit` from :func:`recoverable_fleet`.
    ``loader``: a callable taking the cell's reader and returning an
    iterable of batches, each a dict of tensors or arrays (for example
    ``lambda r: CudaDataLoader(r, 256, device='cuda')``); the certificates
    then cover what it delivers, each tensor moved to the host, and the
    batch rows are its batches' sizes.  Not with ``split='quiesce'``.
    """
    from petastorm_tpu_torch.reader import make_batch_reader

    if cell.disruption != "none" and disruptor is None:
        raise PetastormTpuError(
            f"cell {cell.label()} needs a disruptor callable")
    if loader is not None and cell.split != "none":
        raise PetastormTpuError("a loader cell cannot take a quiesce/resume split")

    kwargs = dict(shuffle_row_groups=True, shuffle_seed=seed,
                  deterministic="seed", num_epochs=num_epochs)
    kwargs.update(_cell_transport_kwargs(cell, service_address))
    kwargs.update(reader_kwargs or {})

    crc = 0
    batch_rows: list = []
    rows = 0
    resumed_digest: Optional[dict] = None
    state: Optional[dict] = None
    disrupted = False

    with make_batch_reader(dataset_url, **kwargs) as reader:
        it = reader.iter_batches() if loader is None else loader(reader)
        delivered = 0
        quiesced = False
        for batch in it:
            columns, num_rows = ((batch.columns, batch.num_rows) if loader is None
                                 else _host_columns(batch))
            crc = content_crc(crc, columns)
            batch_rows.append(num_rows)
            rows += num_rows
            delivered += 1
            if cell.resize and hasattr(reader._executor, "resize_workers"):
                # the autotune-shaped perturbation: grow mid-epoch, shrink
                # back later; delivered order must not notice
                if delivered == action_at_batch:
                    reader._executor.resize_workers(cell.workers * 2)
                elif delivered == 2 * action_at_batch:
                    reader._executor.resize_workers(max(1, cell.workers - 1))
            if (cell.disruption != "none" and disruptor is not None
                    and not disrupted and delivered == action_at_batch):
                # the cell's service-plane disruption (dispatcher restart /
                # partition / ...) fires exactly once, mid-epoch, while
                # this client holds in-flight work
                disruptor()
                disrupted = True
            if (cell.split == "quiesce" and not quiesced
                    and delivered == action_at_batch):
                # stop issuing work; the already-ventilated tail drains
                # through the loop, then state_dict() is an exact cursor
                reader.quiesce()
                quiesced = True
        if cell.split == "quiesce":
            state = reader.state_dict()
        else:
            resumed_digest = reader.diagnostics["stream_digest"]

    if cell.split == "quiesce":
        assert state is not None
        with make_batch_reader(dataset_url, resume_from=state, **kwargs) as reader:
            for batch in reader.iter_batches():
                crc = content_crc(crc, batch.columns)
                batch_rows.append(batch.num_rows)
                rows += batch.num_rows
            # the digest chain continued from the checkpointed state: the
            # resumed reader's combined value IS the whole-stream value
            resumed_digest = reader.diagnostics["stream_digest"]

    return CellResult(digest=resumed_digest, content_crc=crc,
                      batch_rows=tuple(batch_rows), rows=rows)


# -- token-dataset cell family (sequence pipeline) ----------------------------

@dataclasses.dataclass
class SequenceCellResult:
    """What one token cell's packed read delivered: the packed-stream
    certificate + packing accounting (+ the mixture certificate for mixed
    cells)."""

    packed_crc: int     # crc chain over the packed block stream, in order
    rows: int           # packed (seq_len,) rows emitted
    tokens: int         # real tokens packed
    fill_rate: float
    mixture: Optional[dict]   # WeightedSamplingReader.mixture_digest or None


def run_sequence_cell(dataset_urls, seed: int, cell: MatrixCell,
                      seq_len: int = 128, rows_per_block: int = 4,
                      num_epochs: int = 1,
                      service_address: Optional[str] = None,
                      weights=None,
                      reader_kwargs: Optional[dict] = None
                      ) -> SequenceCellResult:
    """Run one token-pipeline cell: read (one corpus or an N-corpus seeded
    mixture) under the cell's configuration, pack deterministically, and
    return the packed-stream certificate.

    The invariant under test: the PACKED stream - not just the
    raw rowgroup stream - is bit-identical across worker counts, executor
    flavors, chaos kills and the service hop, because the packer is a pure
    function of the plan-ordered document stream.  ``split='quiesce'``
    cells are not part of this family (the packer's open bins have no
    mid-stream cursor).
    """
    from petastorm_tpu_torch.sequence.dataset import (iter_documents,
                                                make_sequence_reader)
    from petastorm_tpu_torch.sequence.mixing import make_mixed_sequence_reader
    from petastorm_tpu_torch.sequence.packing import (SequencePacker,
                                                iter_packed_blocks,
                                                packed_stream_digest)

    if cell.split != "none":
        raise PetastormTpuError(
            "token cells do not support quiesce/resume splits (the packer"
            " holds open bins a cursor cannot express)")
    urls = ([dataset_urls] if isinstance(dataset_urls, str)
            else list(dataset_urls))
    kwargs = dict(shuffle_row_groups=True, num_epochs=num_epochs)
    kwargs.update(_cell_transport_kwargs(cell, service_address))
    kwargs.update(reader_kwargs or {})

    if len(urls) == 1:
        source = make_sequence_reader(urls[0], shuffle_seed=seed,
                                      deterministic="seed", **kwargs)
    else:
        source = make_mixed_sequence_reader(urls, weights=weights, seed=seed,
                                            **kwargs)
    with source:
        packer = SequencePacker(seq_len)
        crc = packed_stream_digest(iter_packed_blocks(
            iter_documents(source, "tokens"), seq_len, rows_per_block,
            packer=packer))
        stats = packer.stats()
        mixture = (source.mixture_digest
                   if hasattr(source, "mixture_digest") else None)
    return SequenceCellResult(packed_crc=crc, rows=stats["rows"],
                              tokens=stats["tokens"],
                              fill_rate=stats["fill_rate"], mixture=mixture)


# -- in-process / subprocess service fleets -----------------------------------

@contextlib.contextmanager
def service_fleet(n_workers: int = 2, subprocess_workers: bool = False,
                  capacity: int = 2):
    """A dispatcher + worker fleet for ``transport='service'`` cells; yields
    ``(dispatcher, address, workers)``.

    ``subprocess_workers=True`` runs each worker as a real
    ``petastorm-tpu-torch-service worker`` subprocess - required for chaos kill
    cells (the injection ``os._exit``\\ s the worker process) and for
    SIGKILL-the-worker tests; ``workers`` is then the list of Popen handles.
    In-process thread workers (the default) are cheaper for no-kill cells.
    """
    import threading

    from petastorm_tpu_torch.service.dispatcher import Dispatcher
    from petastorm_tpu_torch.service.worker import ServiceWorker
    from petastorm_tpu_torch.telemetry import Telemetry

    disp = Dispatcher(telemetry=Telemetry(), heartbeat_timeout_s=5.0).start()
    addr = f"127.0.0.1:{disp.port}"
    workers: list = []
    threads: list = []
    try:
        if subprocess_workers:
            for i in range(n_workers):
                workers.append(subprocess.Popen(
                    [sys.executable, "-m", "petastorm_tpu_torch.service.cli",
                     "worker", "--address", addr, "--capacity", str(capacity),
                     "--name", f"mw{i}"],
                    stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))
        else:
            for i in range(n_workers):
                w = ServiceWorker(addr, capacity=capacity, name=f"mw{i}")
                workers.append(w)
                t = threading.Thread(target=w.run, daemon=True)
                threads.append(t)
                t.start()
        deadline = time.monotonic() + 20.0
        while len(disp.stats()["workers"]) < n_workers:
            if time.monotonic() >= deadline:
                raise PetastormTpuError(
                    f"service fleet: {n_workers} workers did not register")
            time.sleep(0.05)
        yield disp, addr, workers
    finally:
        for w in workers:
            if subprocess_workers:
                with contextlib.suppress(Exception):
                    if w.poll() is None:
                        w.send_signal(signal.SIGTERM)
                        try:
                            w.wait(timeout=5)
                        except subprocess.TimeoutExpired:
                            w.kill()
                            w.wait(timeout=5)
            else:
                w.stop()
        disp.stop()
        disp.join()


# -- recoverable fleets (dispatcher-restart / network-chaos cells) -------------

class FleetHandle:
    """A restartable service topology for disruption cells: a dispatcher
    the harness can kill and restart ON THE SAME PORT, in-process workers
    that rejoin (``reconnect_attempts``), and - when armed - a
    :class:`~petastorm_tpu_torch.test_util.netchaos.ChaosProxy` on the
    client<->dispatcher link.  ``address`` is what clients should dial
    (the proxy when present, else the dispatcher)."""

    def __init__(self, dispatcher, workers, proxy=None,
                 dispatcher_kwargs=None):
        self.dispatcher = dispatcher
        self.workers = workers
        self.proxy = proxy
        self.port = dispatcher.port
        self._dispatcher_kwargs = dispatcher_kwargs or {}
        self.restarts = 0
        self._extra_seq = 0

    @property
    def address(self) -> str:
        if self.proxy is not None:
            return self.proxy.address
        return f"127.0.0.1:{self.port}"

    def kill_dispatcher(self) -> None:
        """Abrupt dispatcher death: every session, ledger and redelivery
        buffer in its memory is gone; peers must reconstruct."""
        self.dispatcher.stop()
        self.dispatcher.join()

    def start_dispatcher(self) -> None:
        """A FRESH dispatcher process-equivalent on the same port (empty
        state; recovery comes from the peers - or its journal)."""
        from petastorm_tpu_torch.service.dispatcher import Dispatcher
        from petastorm_tpu_torch.telemetry import Telemetry

        kwargs = dict(self._dispatcher_kwargs)
        kwargs.setdefault("telemetry", Telemetry())
        kwargs.setdefault("heartbeat_timeout_s", 5.0)
        self.dispatcher = Dispatcher(port=self.port, **kwargs).start()
        self.restarts += 1

    def restart_dispatcher(self, downtime_s: float = 0.2) -> None:
        """The dispatcher-SIGKILL+restart disruption: kill, stay dark for
        ``downtime_s`` (clients and workers must ride their reconnect
        windows), then start the replacement."""
        self.kill_dispatcher()
        if downtime_s:
            time.sleep(downtime_s)
        self.start_dispatcher()

    def netsplit(self, duration_s: float = 0.5) -> None:
        """Partition the client link for ``duration_s``, then heal (needs
        the fleet's proxy)."""
        if self.proxy is None:
            raise PetastormTpuError("netsplit needs net_spec/proxy armed")
        self.proxy.partition()
        time.sleep(duration_s)
        self.proxy.heal()

    # -- elastic-fleet moves (autoscale grow / graceful shrink) ---------------

    def scale_up(self, n: int = 1, capacity: int = 2,
                 timeout_s: float = 20.0) -> None:
        """Grow the fleet by ``n`` in-process workers (the supervisor's
        scale-up move) and wait until they are registered."""
        import threading

        from petastorm_tpu_torch.service.worker import ServiceWorker

        target = len(self.dispatcher.stats()["workers"]) + n
        for _ in range(n):
            self._extra_seq += 1
            w = ServiceWorker(f"127.0.0.1:{self.port}", capacity=capacity,
                              name=f"ew{self._extra_seq}",
                              heartbeat_interval_s=0.5,
                              reconnect_attempts=60,
                              reconnect_backoff_s=0.25)
            self.workers.append(w)
            threading.Thread(target=w.run, daemon=True).start()
        deadline = time.monotonic() + timeout_s
        while len(self.dispatcher.stats()["workers"]) < target:
            if time.monotonic() >= deadline:
                raise PetastormTpuError("scale_up: new worker(s) did not"
                                        " register")
            time.sleep(0.05)

    def retire_worker(self, index: int = 0, timeout_s: float = 30.0) -> None:
        """Gracefully retire one worker (the supervisor's scale-down move):
        it drains its in-flight assignments, flushes, and exits - nothing
        requeues, so a deterministic stream must not notice."""
        worker = self.workers.pop(index)
        if not worker.retire(timeout=timeout_s):
            raise PetastormTpuError(
                "retire_worker: graceful drain missed its timeout")

    def elastic_event(self) -> None:
        """The elastic-fleet disruption: a new worker joins mid-epoch, then
        an ORIGINAL worker (holding live assignments) gracefully drains
        out - the exact grow+retire sequence an autoscale supervisor
        drives, compressed into one mid-read event."""
        self.scale_up(1)
        self.retire_worker(0)


# -- hot-standby HA fleets (failover / split-brain cells) ----------------------

class HAFleetHandle(FleetHandle):
    """A :class:`FleetHandle` with a hot-standby dispatcher pair:
    ``primary`` feeds ``standby`` over ``journal_sync``, workers and
    clients dial the failover address list, and the harness can kill the
    primary outright (:meth:`failover`) or partition it away
    (:meth:`partition_primary`, ``ha_fleet(partitionable=True)``) to
    exercise promotion and split-brain fencing.  ``self.dispatcher``
    tracks the LIVE side: the primary until a promotion, the standby
    after."""

    def __init__(self, primary, standby, workers, client_address,
                 sync_proxy=None, peer_proxy=None):
        super().__init__(primary, workers, proxy=None)
        self.primary = primary
        self.standby = standby
        self.sync_proxy = sync_proxy
        self.peer_proxy = peer_proxy
        self._client_address = client_address
        self.primary_direct = f"127.0.0.1:{primary.port}"
        self.standby_direct = f"127.0.0.1:{standby.port}"

    @property
    def address(self) -> str:
        """The failover address list clients should dial
        (``'primary:p,standby:p'`` - the proxied primary when armed)."""
        return self._client_address

    def wait_promoted(self, timeout_s: float = 20.0) -> None:
        """Block until the standby promoted; ``self.dispatcher`` then
        points at it."""
        if not self.standby.standby_promoted.wait(timeout_s):
            raise PetastormTpuError(
                f"standby did not promote within {timeout_s:.0f}s")
        self.dispatcher = self.standby

    def failover(self, timeout_s: float = 20.0) -> None:
        """SIGKILL-equivalent primary death (listener + every connection
        drops, memory gone from the fleet's point of view), then wait for
        the standby to notice and promote."""
        self.primary.stop()
        self.primary.join()
        self.wait_promoted(timeout_s)

    def partition_primary(self) -> None:
        """Partition the primary away from standby AND peers (both proxy
        links): the standby promotes while the deposed primary stays alive
        on the far side of the split."""
        if self.sync_proxy is None or self.peer_proxy is None:
            raise PetastormTpuError(
                "partition_primary needs ha_fleet(partitionable=True)")
        self.sync_proxy.partition()
        self.peer_proxy.partition()

    def heal_primary(self) -> None:
        """Heal the partition: the deposed primary is reachable again -
        and must now be REFUSED by its own fleet (epoch fencing)."""
        self.sync_proxy.heal()
        self.peer_proxy.heal()


@contextlib.contextmanager
def ha_fleet(n_workers: int = 2, capacity: int = 2,
             partitionable: bool = False,
             dispatcher_kwargs: Optional[dict] = None,
             worker_reconnect_attempts: int = 240,
             worker_reconnect_backoff_s: float = 0.25):
    """A primary + hot-standby dispatcher pair with rejoining workers for
    ``disruption='failover'`` cells; yields an :class:`HAFleetHandle`.

    Workers (and the yielded client ``address``) dial the failover list
    ``'primary,standby'``; the standby refuses their hellos until it
    promotes, so the rotation naturally parks everyone on the primary and
    rolls them over at failover.  ``partitionable=True`` interposes
    :class:`~petastorm_tpu_torch.test_util.netchaos.ChaosProxy` pairs on both
    the standby's sync link and the peers' primary link, so
    :meth:`HAFleetHandle.partition_primary` can split the brain without
    killing the primary.  The manager waits for the standby's first
    successful sync before yielding - promotion is armed from the start.
    """
    import threading

    from petastorm_tpu_torch.service.dispatcher import Dispatcher
    from petastorm_tpu_torch.service.worker import ServiceWorker
    from petastorm_tpu_torch.telemetry import Telemetry

    kwargs = dict(dispatcher_kwargs or {})
    kwargs.setdefault("telemetry", Telemetry())
    kwargs.setdefault("heartbeat_timeout_s", 5.0)
    primary = Dispatcher(**kwargs).start()
    primary_direct = f"127.0.0.1:{primary.port}"
    sync_proxy = peer_proxy = None
    primary_for_standby = primary_for_peers = primary_direct
    if partitionable:
        from petastorm_tpu_torch.test_util.netchaos import ChaosProxy

        sync_proxy = ChaosProxy(primary_direct).start()
        peer_proxy = ChaosProxy(primary_direct).start()
        primary_for_standby = sync_proxy.address
        primary_for_peers = peer_proxy.address
    standby = Dispatcher(telemetry=Telemetry(),
                         heartbeat_timeout_s=kwargs["heartbeat_timeout_s"],
                         standby_of=primary_for_standby).start()
    peer_list = f"{primary_for_peers},127.0.0.1:{standby.port}"
    workers = [ServiceWorker(
        peer_list, capacity=capacity, name=f"haw{i}",
        heartbeat_interval_s=0.5,
        reconnect_attempts=worker_reconnect_attempts,
        reconnect_backoff_s=worker_reconnect_backoff_s)
        for i in range(n_workers)]
    for w in workers:
        threading.Thread(target=w.run, daemon=True).start()
    handle = HAFleetHandle(primary, standby, workers, peer_list,
                           sync_proxy=sync_proxy, peer_proxy=peer_proxy)
    try:
        deadline = time.monotonic() + 20.0
        while (len(primary.stats()["workers"]) < n_workers
               or standby.stats()["standby"]["primary_epoch"] < 1):
            if time.monotonic() >= deadline:
                raise PetastormTpuError(
                    f"ha fleet: {n_workers} worker(s) + a synced standby"
                    " did not come up")
            time.sleep(0.05)
        yield handle
    finally:
        for w in workers:
            w.stop()
        for proxy in (sync_proxy, peer_proxy):
            if proxy is not None:
                proxy.stop()
        for disp in (standby, primary):
            disp.stop()
            disp.join()


@contextlib.contextmanager
def recoverable_fleet(n_workers: int = 2, capacity: int = 2,
                      net_spec=None, dispatcher_kwargs: Optional[dict] = None,
                      worker_reconnect_attempts: int = 60,
                      worker_reconnect_backoff_s: float = 0.25):
    """A dispatcher + rejoining in-process workers (+ an optional chaos
    proxy on the client link) for disruption cells; yields a
    :class:`FleetHandle`.

    Workers connect DIRECTLY to the dispatcher with a generous rejoin
    budget, so a dispatcher restart finds them claiming their in-flight
    work; ``net_spec`` (a :class:`~petastorm_tpu_torch.test_util.netchaos.
    NetChaosSpec`) interposes the proxy on the CLIENT link only - worker-
    link faults are the dispatcher's worker-death machinery, already a
    matrix axis.
    """
    import threading

    from petastorm_tpu_torch.service.dispatcher import Dispatcher
    from petastorm_tpu_torch.service.worker import ServiceWorker
    from petastorm_tpu_torch.telemetry import Telemetry

    kwargs = dict(dispatcher_kwargs or {})
    kwargs.setdefault("telemetry", Telemetry())
    kwargs.setdefault("heartbeat_timeout_s", 5.0)
    disp = Dispatcher(**kwargs).start()
    direct = f"127.0.0.1:{disp.port}"
    proxy = None
    if net_spec is not None:
        from petastorm_tpu_torch.test_util.netchaos import ChaosProxy

        proxy = ChaosProxy(direct, net_spec).start()
    workers = [ServiceWorker(
        direct, capacity=capacity, name=f"rw{i}",
        reconnect_attempts=worker_reconnect_attempts,
        reconnect_backoff_s=worker_reconnect_backoff_s)
        for i in range(n_workers)]
    threads = [threading.Thread(target=w.run, daemon=True) for w in workers]
    for t in threads:
        t.start()
    handle = FleetHandle(disp, workers, proxy=proxy,
                         dispatcher_kwargs=kwargs)
    try:
        deadline = time.monotonic() + 20.0
        while len(handle.dispatcher.stats()["workers"]) < n_workers:
            if time.monotonic() >= deadline:
                raise PetastormTpuError(
                    f"recoverable fleet: {n_workers} workers did not"
                    " register")
            time.sleep(0.05)
        yield handle
    finally:
        for w in workers:
            w.stop()
        if proxy is not None:
            proxy.stop()
        handle.dispatcher.stop()
        handle.dispatcher.join()
