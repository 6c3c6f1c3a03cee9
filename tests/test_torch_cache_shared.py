"""The port's shared warm-cache tier (``cache_type='shared'``) on the CPU.

After ``tests/test_cache_shared.py``: a shared-tier read gives the rows and
the stream digest of an uncached read and of the JAX package's shared-tier
read; a second epoch, a second reader and a reader in a spawned process hit
the shared-memory level on every rowgroup; a small arena evicts and the disk
tier promotes back; ``cleanup()`` removes the segments.  The port's
namespace never meets the JAX tier's under one ``cache_location``, and
without the arena library the tier raises.  Every test names its own
``cache_location`` and counts only its own segments.
"""

import json
import multiprocessing
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from petastorm_tpu import cache_shared as jax_cache_shared
from petastorm_tpu import reader as jax_reader

from petastorm_tpu_torch import Field, Schema, reader
from petastorm_tpu_torch import native
from petastorm_tpu_torch.cache import make_cache
from petastorm_tpu_torch.cache_shared import DEFAULT_LOCATION, SharedWarmCache
from petastorm_tpu_torch.codecs import CompressedImageCodec
from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.etl.writer import write_dataset
from petastorm_tpu_torch.telemetry import Telemetry

N_ROWS, RG_ROWS = 40, 4  # 10 rowgroups
SHM = "/dev/shm"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_child_left():
    yield
    assert multiprocessing.active_children() == []


@pytest.fixture(scope="module")
def url(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("shared") / "ds")
    rng = np.random.default_rng(5)
    schema = Schema("Shared", [
        Field("x", np.int64),
        Field("image", np.uint8, (16, 16, 3), CompressedImageCodec("png")),
    ])
    write_dataset(path, schema, [{"x": i, "image": rng.integers(0, 256, (16, 16, 3),
                                                                  dtype=np.uint8)}
                                 for i in range(N_ROWS)], row_group_size_rows=RG_ROWS)
    return path


@pytest.fixture
def location(tmp_path):
    """A cache location of this test alone; its segments are gone after it."""
    loc = str(tmp_path / "warm")
    yield loc
    tier = SharedWarmCache(location=loc, l1_bytes=2 ** 20)
    names = tier.segment_names
    tier.cleanup()
    assert not any(os.path.exists(os.path.join(SHM, n)) for n in names)


def _read(mod, url, epochs=1, **kwargs):
    """Rows (x and an image sum, in delivery order), the digest and the
    reader's cache stats."""
    with mod.make_batch_reader(url, shuffle_seed=9, num_epochs=epochs,
                               reader_pool_type=kwargs.pop("pool", "serial"), **kwargs) as r:
        rows = [(int(x), int(img.astype(np.int64).sum()))
                for b in r for x, img in zip(b.x, b.image)]
        stats = r.cache_stats() if hasattr(r, "cache_stats") else None
        return rows, r.stream_digest, stats, r.diagnostics


def test_shared_read_equals_an_uncached_read_and_the_jax_shared_read(url, location, tmp_path):
    plain = _read(reader, url, epochs=2)
    shared = _read(reader, url, epochs=2, cache_type="shared", cache_location=location)
    jax_loc = str(tmp_path / "jax_warm")
    want = _read(jax_reader, url, epochs=2, cache_type="shared", cache_location=jax_loc)
    jax_cache_shared.SharedWarmCache(location=jax_loc).cleanup()
    assert shared[0] == plain[0] == want[0]
    assert shared[1] == plain[1] == want[1]
    assert shared[2]["misses"] == 10 and shared[2]["hits"] == 10
    assert shared[3]["cache"]["entries"] == 10


def test_epoch_two_a_second_reader_and_a_spawned_process_hit_l1(url, location):
    tele = Telemetry()
    first = _read(reader, url, epochs=2, cache_type="shared", cache_location=location,
                  pool="thread", workers_count=3, telemetry=tele)
    assert (first[2]["misses"], first[2]["hits"]) == (10, 10)
    assert tele.snapshot()["counters"]["cache.hits"] == 10
    second = _read(reader, url, cache_type="shared", cache_location=location)
    assert second[0] == first[0][:N_ROWS]
    assert (second[2]["misses"], second[2]["hits"]) == (10, 20)
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from petastorm_tpu_torch import reader\n"
        f"with reader.make_batch_reader({url!r}, shuffle_seed=9, reader_pool_type='serial',"
        f" cache_type='shared', cache_location={location!r}) as r:\n"
        "    rows = [int(x) for b in r for x in b.x]\n"
        "    print(json.dumps({'rows': rows, 'stats': r.cache_stats()}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True)
    child = json.loads(out.stdout.strip().splitlines()[-1])
    assert child["rows"] == [x for x, _ in first[0][:N_ROWS]]
    assert (child["stats"]["misses"], child["stats"]["hits"]) == (10, 30)


def test_process_pool_hits_land_in_transport_slots(url, location):
    with reader.make_batch_reader(url, shuffle_seed=9, num_epochs=2, workers_count=2,
                                  reader_pool_type="process", cache_type="shared",
                                  cache_location=location) as r:
        rows = [(int(x), int(img.astype(np.int64).sum()))
                for b in r for x, img in zip(b.x, b.image)]
        transport = r.transport_stats()
        stats = r.diagnostics["cache"]
    assert rows == _read(reader, url, epochs=2)[0]
    assert (stats["misses"], stats["hits"]) == (10, 10)
    # epoch 1 decodes its images into slots (10 columns); epoch 2's hits
    # copy both columns of every rowgroup out of the tier into slots (20)
    assert transport["slot_columns"] == 30 and transport["pickled_batches"] == 0


@pytest.fixture(scope="module")
def wide_url(tmp_path_factory):
    """10 rowgroups of about 196 KiB decoded each."""
    path = str(tmp_path_factory.mktemp("shared_wide") / "ds")
    rng = np.random.default_rng(6)
    schema = Schema("Wide", [Field("x", np.int64), Field("image", np.uint8, (64, 64, 3))])
    write_dataset(path, schema, [{"x": i, "image": rng.integers(0, 256, (64, 64, 3),
                                                                  dtype=np.uint8)}
                                 for i in range(160)], row_group_size_rows=16)
    return path


def test_small_arena_evicts_and_the_disk_tier_promotes(wide_url, location):
    plain = _read(reader, wide_url, epochs=2)
    got = _read(reader, wide_url, epochs=2, cache_type="shared", cache_location=location,
                cache_size_limit=2 ** 20)
    assert got[0] == plain[0] and got[1] == plain[1]
    stats = got[3]["cache"]
    assert stats["evictions"] > 0 and stats["bytes"] <= stats["target_bytes"]
    # evicted rowgroups of epoch 1 come back from disk and are promoted
    assert stats["l2_hits"] > 0 and stats["stores"] > 10
    assert stats["misses"] == 10


def test_target_bytes_and_publish_telemetry(url, location):
    tele = Telemetry()
    tier = make_cache("shared", location, 4 * 2 ** 20, telemetry=tele)
    assert tier.l1_size_bytes == 4 * 2 ** 20
    assert tier.get_target_bytes() == int(0.8 * tier.l1_size_bytes)
    assert tier.set_target_bytes(1) == 2 ** 20
    assert tier.set_target_bytes(2 ** 40) == int(0.8 * tier.l1_size_bytes)
    tier.get("k", lambda: 1)
    tier.get("k", lambda: 2)
    tier.publish_telemetry()
    counters = tele.snapshot()["counters"]
    assert (counters["cache.hits"], counters["cache.misses"], counters["cache.stores"]) == (1, 1, 1)
    tier.close()


def test_cleanup_removes_the_segments(location):
    tier = SharedWarmCache(location=location, l1_bytes=2 ** 20)
    names = tier.segment_names
    assert all(os.path.exists(os.path.join(SHM, n)) for n in names)
    tier.get("k", lambda: np.arange(3))
    tier.cleanup()
    assert not any(os.path.exists(os.path.join(SHM, n)) for n in names)
    assert not os.path.exists(os.path.join(location, "l2_torch"))


def test_the_port_and_jax_namespaces_are_distinct(url, location):
    port = SharedWarmCache(location=location, l1_bytes=2 ** 20)
    jax_tier = jax_cache_shared.SharedWarmCache(location=location, l1_bytes=2 ** 20)
    try:
        assert not set(port.segment_names) & {jax_tier._arena_name,  # noqa: SLF001
                                              jax_tier._index_name}  # noqa: SLF001
        port.get("key", lambda: "port")
        jax_tier.get("key", lambda: "jax")
        assert port.get("key", lambda: "again") == "port"
        assert jax_tier.get("key", lambda: "again") == "jax"
        assert DEFAULT_LOCATION != jax_cache_shared.DEFAULT_LOCATION
        assert DEFAULT_LOCATION.endswith("petastorm_tpu_torch_warm")
    finally:
        jax_tier.cleanup()
        port.close()


def test_without_the_arena_library_the_tier_raises(url, location, monkeypatch):
    def no_library():
        raise RuntimeError("g++ failed for shm_arena.cpp")

    monkeypatch.setattr(native, "load_arena", no_library)
    with pytest.raises(PetastormTpuError, match="cache_type='shared' needs its shared-memory"):
        make_cache("shared", location)
    with pytest.raises(PetastormTpuError, match="g\\+\\+ failed"):
        reader.make_batch_reader(url, cache_type="shared", cache_location=location)


def test_shared_tier_refuses_a_predicate_before_making_segments(url, location):
    from petastorm_tpu_torch import predicates

    with pytest.raises(PetastormTpuError, match="cannot be combined with a predicate"):
        reader.make_batch_reader(url, cache_type="shared", cache_location=location,
                                 predicate=predicates.in_lambda(["x"], lambda x: x > 3))


def test_concurrent_misses_of_one_key_fill_it_once(location):
    """A choice of the port's tier (``FILL_STRIPES``): threads and processes
    that miss one key at once wait for one fill; the JAX tier fills it in
    each of them."""
    import threading

    tier = SharedWarmCache(location=location, l1_bytes=2 ** 20)
    fills, barrier = [], threading.Barrier(4)

    def fill():
        fills.append(1)
        time.sleep(0.2)
        return np.arange(8)

    def get():
        barrier.wait(timeout=10)
        got.append(tier.get("one-key", fill))

    got = []
    threads = [threading.Thread(target=get) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert len(fills) == 1 and len(got) == 4
    assert all((g == np.arange(8)).all() for g in got)
    stats = tier.stats()
    assert (stats["misses"], stats["hits"]) == (1, 3)
    tier.close()
