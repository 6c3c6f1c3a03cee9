"""The port's process pool (``reader_pool_type='process'``) against the JAX
package's and the port's thread pool, on the CPU.

After ``tests/test_pool.py``, ``tests/test_fault_tolerance.py``,
``tests/test_liveness.py`` and ``tests/test_process_pool_matrix.py``: the
process pool reads the JAX process pool's rows in its order with its
``stream_digest``, and the thread pool's batches byte for byte (the hybrid
route's coefficient planes included); ``quiesce()`` gives an exact cursor to
resume from; a hung worker is SIGKILLed and replaced, a killed one's item is
requeued, a spent budget raises, an item that hangs every attempt
quarantines as data with the JAX ledger, and a stall aborts.  The pool
refuses to start without its arena library, and its workers never import
``torch``.  Every test that spawns bounds its wait, and leaves no child
process behind.  The card's case (the process pool feeding
``CudaDataLoader`` under a chaos hang) is in
``tests/test_torch_cuda_kernels.py``, which imports nothing of JAX.
"""

import functools
import gc
import multiprocessing
import os
import re
import time

import numpy as np
import pytest
import torch

from petastorm_tpu import reader as jax_reader
from petastorm_tpu.errors import ErrorPolicy as JaxErrorPolicy
from petastorm_tpu.test_util import chaos as jax_chaos

from petastorm_tpu_torch import CompressedImageCodec, Field, Schema, pool, reader
from petastorm_tpu_torch.errors import ErrorPolicy
from petastorm_tpu_torch.etl.writer import write_dataset
from petastorm_tpu_torch.native import build as native_build
from petastorm_tpu_torch.test_util import chaos

N_ROWS, RG_ROWS = 32, 4  # 8 rowgroups
WORKERS = 2
PKG = {"jax": (jax_reader, jax_chaos, JaxErrorPolicy), "torch": (reader, chaos, ErrorPolicy)}


@pytest.fixture(autouse=True)
def _no_child_left():
    yield
    assert multiprocessing.active_children() == []


@pytest.fixture(scope="module")
def url(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pp") / "ds")
    schema = Schema("Proc", [Field("x", np.int64),
                             Field("image", np.uint8, (16, 16, 3), CompressedImageCodec("png"))])
    rng = np.random.default_rng(5)
    write_dataset(path, schema, [{"x": i, "image": rng.integers(0, 255, (16, 16, 3),
                                                                dtype=np.uint8)}
                                 for i in range(N_ROWS)], row_group_size_rows=RG_ROWS)
    return path


@pytest.fixture(scope="module")
def jpeg_url(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pp_jpeg") / "ds")
    schema = Schema("Jpeg", [Field("label", np.int64),
                             Field("image", np.uint8, (32, 48, 3), CompressedImageCodec("jpeg", 90))])
    rng = np.random.default_rng(6)
    base = np.clip(rng.normal(128, 50, (32, 48, 3)), 0, 255).astype(np.uint8)
    write_dataset(path, schema, [{"label": i, "image": np.roll(base, i, axis=1)}
                                 for i in range(N_ROWS)], row_group_size_rows=RG_ROWS)
    return path


def _read(mod, url, bound_s=60, **kwargs):
    t0 = time.monotonic()
    with mod.make_batch_reader(url, **kwargs) as r:
        batches = list(r.iter_batches())
        out = {"x": [int(v) for b in batches for v in b.columns["x"]],
               "digest": r.stream_digest, "diag": r.diagnostics,
               "transport": getattr(r, "transport_stats", dict)(),
               "quarantine": sorted(r.quarantined_rowgroups, key=lambda e: e["ordinal"]),
               "batches": batches}
    assert time.monotonic() - t0 < bound_s
    return out


def test_read_equals_the_jax_process_pool(url):
    kwargs = dict(reader_pool_type="process", workers_count=WORKERS, shuffle_seed=3)
    got, want = _read(reader, url, **kwargs), _read(jax_reader, url, **kwargs)
    assert got["x"] == want["x"] and sorted(got["x"]) == list(range(N_ROWS))
    assert got["x"] != list(range(N_ROWS))  # shuffled, in the plan's order
    assert got["digest"] == want["digest"]
    # workers_busy is left out: a worker clears its slot just after it sends
    for key in ("requeued_items", "hung_workers_killed", "hedged_items", "workers_count",
                "workers_alive", "shm_transport"):
        assert got["diag"][key] == want["diag"][key], key
    assert set(got["diag"]) <= set(want["diag"])
    stats = got["transport"]
    assert stats["shm_batches"] == N_ROWS // RG_ROWS and stats["pickled_batches"] == 0
    # the PNG column decoded natively, straight into arena slots
    assert stats["slot_rows"] == N_ROWS


@pytest.mark.parametrize("placement", ["host", "device"])
def test_read_equals_the_thread_pool_byte_for_byte(jpeg_url, placement):
    kwargs = dict(workers_count=WORKERS, shuffle_seed=1, decode_placement={"image": placement})
    runs = {}
    for kind in ("thread", "process"):
        with reader.make_batch_reader(jpeg_url, reader_pool_type=kind, **kwargs) as r:
            runs[kind] = ([b.columns for b in r.iter_batches()], r.stream_digest)
    (want, want_digest), (got, digest) = runs["thread"], runs["process"]
    assert digest == want_digest and len(got) == len(want) == N_ROWS // RG_ROWS
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        if placement == "device":
            assert any(k.startswith("image#") for k in g)  # coefficient planes
        for name in w:
            assert g[name].dtype == w[name].dtype and np.array_equal(g[name], w[name]), name


def test_quiesce_is_exact_and_resumes_under_the_process_pool(tmp_path):
    """``quiesce()`` then the rest of the stream gives an exact cursor with
    workers finishing out of order; the resumed reader reads the rest once
    (``tests/test_process_pool_matrix.py:101``)."""
    path = str(tmp_path / "many")
    write_dataset(path, Schema("Many", [Field("x", np.int64)]),
                  [{"x": i} for i in range(48)], row_group_size_rows=2)
    seen = []
    with reader.make_reader(path, reader_pool_type="process", workers_count=WORKERS,
                            results_queue_size=2, shuffle_seed=11) as r:
        it = iter(r)
        seen += [next(it).x for _ in range(10)]
        stop = r.quiesce()
        seen += [row.x for row in it]
        state = r.state_dict()
    assert state["ordinal_exact"] and state["position"] == stop < 24
    with reader.make_reader(path, reader_pool_type="process", workers_count=WORKERS,
                            shuffle_seed=11, resume_from=state) as r:
        resumed = [row.x for row in r]
    assert resumed and sorted(seen + resumed) == list(range(48))
    with reader.make_reader(path, reader_pool_type="thread", shuffle_seed=11) as r:
        assert seen + resumed == [row.x for row in r]  # the plan's order, split


def test_a_hung_worker_is_killed_and_replaced(url):
    spec = chaos.ChaosSpec(hang_ordinals=(2,), hang_s=60)
    t0 = time.monotonic()
    got = _read(reader, url, reader_pool_type="process", workers_count=WORKERS,
                shuffle_row_groups=False, chaos=spec, item_deadline_s=1.0)
    assert time.monotonic() - t0 < 40  # not the 60 s hang
    assert got["x"] == list(range(N_ROWS))
    diag = got["diag"]
    assert diag["hung_workers_killed"] == 1 and diag["requeued_items"] == 1
    assert diag["workers_alive"] == WORKERS  # the killed worker was respawned


def test_a_killed_workers_item_is_requeued(url):
    spec = chaos.ChaosSpec(kill_ordinals=(3,))
    got = _read(reader, url, reader_pool_type="process", workers_count=WORKERS,
                shuffle_row_groups=False, chaos=spec)
    assert got["x"] == list(range(N_ROWS))
    assert got["diag"]["requeued_items"] == 1
    assert got["diag"]["workers_alive"] == WORKERS - 1  # a death is not respawned


def test_a_spent_budget_raises_a_worker_error(url):
    spec = chaos.ChaosSpec(kill_ordinals=(1,), kill_on_retry=True)
    t0 = time.monotonic()
    with pytest.raises(pool.WorkerError) as info:
        _read(reader, url, reader_pool_type="process", workers_count=4,
              shuffle_row_groups=False, chaos=spec)
    assert time.monotonic() - t0 < 40
    err = info.value
    assert (err.kind, err.ordinal) == ("infra", 1)
    assert "requeue budget exhausted (2 requeue(s) of max 2) - possible crash/OOM" in str(err)


def _worker_index_free(entries):
    def clean(k, v):
        if k != "error":
            return v
        return re.sub(r"worker process \d+", "worker process N",
                      v.replace("petastorm_tpu_torch.", "petastorm_tpu."))
    return [{k: clean(k, v) for k, v in e.items()} for e in entries]


def test_an_item_hung_on_every_attempt_quarantines_like_jax(url):
    runs = {}
    for pkg in ("jax", "torch"):
        mod, chaos_mod, policy = PKG[pkg]
        runs[pkg] = _read(mod, url, reader_pool_type="process", workers_count=WORKERS,
                          shuffle_row_groups=False, item_deadline_s=0.8,
                          chaos=chaos_mod.ChaosSpec(hang_ordinals=(5,), hang_on_retry=True,
                                                    hang_s=60),
                          on_error=policy(max_requeue_attempts=1))
    got, want = runs["torch"], runs["jax"]
    assert got["x"] == [x for x in range(N_ROWS) if x // RG_ROWS != 5]
    assert sorted(want["x"]) == got["x"]
    # both attempts hung and were killed; the item is a data error
    assert got["diag"]["hung_workers_killed"] == want["diag"]["hung_workers_killed"] == 2
    assert _worker_index_free(got["quarantine"]) == _worker_index_free(want["quarantine"])
    assert got["quarantine"][0]["kind"] == "data"


def test_a_stall_aborts_and_leaves_no_worker(url):
    spec = chaos.ChaosSpec(hang_ordinals=(2,), hang_on_retry=True, hang_s=60)
    t0 = time.monotonic()
    with pytest.raises(pool.PipelineStallError) as info:
        with reader.make_batch_reader(url, reader_pool_type="process", workers_count=WORKERS,
                                      shuffle_row_groups=False, chaos=spec,
                                      stall_abort_s=1.5) as r:
            list(r.iter_batches())
    assert time.monotonic() - t0 < 30
    assert 2 in [b[1] for b in info.value.diagnostics["workers_busy"]]


def test_the_workers_start_up_is_not_a_stall():
    """The idle seconds the stall watchdog sees start when the first worker
    is up: a start-up longer than ``stall_abort_s`` aborts nothing."""
    ex = pool.ProcessExecutor(workers_count=1, results_queue_size=1)
    ex.start(functools.partial(eval, "(__import__('time').sleep(2.0), lambda item: item)[-1]"))
    seen = []
    t0 = time.monotonic()
    try:
        assert list(ex.imap([0, 1], on_idle=seen.append)) == [0, 1]
    finally:
        ex.stop()
        ex.join()
    assert time.monotonic() - t0 > 2.0
    assert seen and max(seen) < 1.0


def test_the_process_pool_raises_without_its_arena_library(url, tmp_path, monkeypatch):
    """No fallback to plain queues: without g++ (and nothing built) the
    process pool is refused when the reader is made."""
    monkeypatch.setattr(native_build, "LIB_DIR", str(tmp_path / "empty_lib"))
    monkeypatch.setattr(native_build, "_loaded", {})
    monkeypatch.setattr(native_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        reader.make_batch_reader(url, reader_pool_type="process", workers_count=WORKERS)


#: a worker function made in the worker: the top-level packages it has loaded
_PROBE = ("(__import__('petastorm_tpu_torch.worker'), __import__('petastorm_tpu_torch.reader'),"
          " lambda item: sorted({m.split('.')[0] for m in __import__('sys').modules}"
          " & {'torch', 'jax', 'petastorm_tpu', 'petastorm_tpu_torch'}))[-1]")


def test_a_spawned_worker_imports_no_torch():
    assert "torch" in __import__("sys").modules  # this process has it
    ex = pool.ProcessExecutor(workers_count=1, results_queue_size=1)
    ex.start(functools.partial(eval, _PROBE))
    try:
        assert list(ex.imap([0])) == [["petastorm_tpu_torch"]]
    finally:
        ex.stop()
        ex.join()


def test_the_arena_holds_the_window_and_reports_its_use(url):
    with reader.make_batch_reader(url, reader_pool_type="process", workers_count=1) as r:
        assert sum(b.num_rows for b in r.iter_batches()) == N_ROWS
        stats = r.transport_stats()
    # a small dataset gets the floor, the JAX pool's fixed 256 MiB
    assert stats["shm_size_bytes"] == reader._MIN_ARENA_BYTES and stats["pickled_batches"] == 0
    assert 0 < stats["shm_high_water_bytes"] < reader._MIN_ARENA_BYTES
    assert stats["worker_spawn_s"][0] > 0 and stats["worker_rss_bytes"][0] > 0


def test_the_arena_is_sized_from_the_window_and_the_widest_item(tmp_path):
    """(window + 4) batches of the plan's largest item at the fixed-shape
    fields' widths: a ROI at its crop, a device field at twice its pixels,
    a ragged field at none; at least 256 MiB; capped by half the shm
    filesystem's free space (none here: the estimate stands)."""
    schema = Schema("Wide", [Field("label", np.int64),
                             Field("image", np.uint8, (1024, 1024, 3), CompressedImageCodec("jpeg")),
                             Field("tokens", np.int32, (None,))])
    path = str(tmp_path / "wide")
    write_dataset(path, Schema("Wide", [Field("label", np.int64)]),
                  [{"label": i} for i in range(64)], row_group_size_rows=32)
    plan = reader.ReadPlan(reader.open_dataset(path).row_groups, shuffle_row_drop_partitions=2)
    fields, nowhere = ["label", "image", "tokens"], str(tmp_path / "none")
    pixels = 1024 * 1024 * 3

    def size(device=(), roi=None, window=17, shm_dir=nowhere):
        return reader._arena_bytes(schema, fields, list(device), roi or {}, plan, window,
                                   shm_dir=shm_dir)

    assert size() == 21 * 16 * (8 + pixels)  # 16 rows an item: 2 drop partitions of 32
    assert size(device=["image"]) == 21 * 16 * (8 + 2 * pixels)
    assert size(roi={"image": ("center", 224, 224)}) == reader._MIN_ARENA_BYTES
    free = __import__("shutil").disk_usage(str(tmp_path)).free
    assert size(window=10 ** 9, shm_dir=str(tmp_path)) == free // 2


# -- the arena's segments across readers (tests/test_endurance.py:66-82) -----------


def _segment_exists(name: str) -> bool:
    return os.path.exists(os.path.join("/dev/shm", name.lstrip("/")))


def test_readers_reclaim_their_own_arena_segments(url):
    """Each process-pool reader's arena segment is gone once the reader is
    closed: after a full read, an early stop, and a read through a killed
    and a hung worker.  Only this test's own segments are counted (other
    processes share ``/dev/shm``)."""
    names = []
    for case in ("full", "full", "early", "faults"):
        kwargs = dict(reader_pool_type="process", workers_count=WORKERS, shuffle_seed=3)
        if case == "faults":
            kwargs.update(item_deadline_s=1.0,
                          chaos=chaos.ChaosSpec(kill_ordinals=(2,), hang_ordinals=(5,),
                                                hang_s=30))
        with reader.make_batch_reader(url, **kwargs) as r:
            arena = r._executor._arena  # noqa: SLF001
            names.append(arena.name)
            assert _segment_exists(arena.name)
            if case == "early":
                next(r.iter_batches())
            else:
                assert sum(len(b.columns["x"]) for b in r.iter_batches()) == N_ROWS
        gc.collect()
        assert not _segment_exists(names[-1]), case
    assert len(set(names)) == len(names)
    assert not any(_segment_exists(n) for n in names)


def test_batched_data_loader_over_the_process_pool_keeps_its_leases(url):
    """``pytorch.BatchedDataLoader`` tensors are views of the arena
    (``torch.from_numpy``): they stay valid after the reader closes, and the
    arena unmaps once they are gone."""
    from petastorm_tpu_torch.pytorch import BatchedDataLoader

    with reader.make_reader(url, reader_pool_type="thread", workers_count=WORKERS,
                            shuffle_seed=3) as r:
        want = [{k: v.clone() for k, v in b.items()} for b in BatchedDataLoader(r, RG_ROWS)]
    with reader.make_reader(url, reader_pool_type="process", workers_count=WORKERS,
                            shuffle_seed=3) as r:
        arena = r._executor._arena  # noqa: SLF001
        got = list(BatchedDataLoader(r, RG_ROWS))
        assert r.transport_stats()["shm_batches"] == N_ROWS // RG_ROWS
    # the reader is closed: the arena's name is gone, its mapping is not
    assert not _segment_exists(arena.name) and not arena._unmapped  # noqa: SLF001
    assert len(got) == len(want) == N_ROWS // RG_ROWS
    assert all(set(g) == set(w) and all(torch.equal(g[k], w[k]) for k in w)
               for g, w in zip(got, want))
    del got, r  # the reader's exhausted generator held the last batch
    gc.collect()
    arena.close()
    assert arena._unmapped  # noqa: SLF001
