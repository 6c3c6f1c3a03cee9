"""The port's rowgroup caches against the JAX package's, on the CPU.

The cache classes' tests are the JAX package's (``tests/test_end_to_end.py``
round trips, LRU eviction, isolation from in-place mutation, object-column
sizing; ``tests/test_warm_cache.py`` eviction sweeps of ``LocalDiskCache``),
run on the port's classes.  Through the reader: three epochs with
``cache_type='memory'`` or ``'local-disk'`` deliver the same rows, in the
same order, with the same stream digest as ``'null'`` and as the JAX
reader, on the host-decode route and on the hybrid route (coefficient planes
cached, the loader's plain B2 decode equal to the uncached run's), with one
miss and two hits a rowgroup and the native decode called in the first epoch
only.  A directory the JAX package's ``LocalDiskCache`` filled gives the
port only misses.
"""

import os
import time

import numpy as np
import pytest
import torch

import petastorm_tpu as jax_package
from petastorm_tpu.reader import make_batch_reader as jax_make_batch_reader

import petastorm_tpu_torch as torch_package

from petastorm_tpu_torch import CompressedImageCodec, Field, Schema, make_batch_reader, \
    make_reader, write_dataset
from petastorm_tpu_torch.batch import ColumnBatch
from petastorm_tpu_torch.cache import InMemoryCache, LocalDiskCache, NullCache, make_cache
from petastorm_tpu_torch.cuda.loader import CudaDataLoader
from petastorm_tpu_torch.errors import PetastormTpuError

N_ROWS, GROUP = 40, 8  # 5 rowgroups


def _smooth(h, w, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * 5 + seed * 7) % 256, (y * 3 + seed) % 256, (x + y) * 2 % 256], -1)
    return np.clip(base + rng.integers(-8, 9, base.shape), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cache") / "ds")
    schema = Schema("Cache", [
        Field("id", np.int64), Field("vec", np.float32, (3,)),
        Field("image", np.uint8, (24, 32, 3), CompressedImageCodec("jpeg", quality=90)),
    ])
    write_dataset(path, schema, [{"id": i, "vec": np.full(3, i, np.float32),
                                  "image": _smooth(24, 32, i)} for i in range(N_ROWS)],
                  row_group_size_rows=GROUP)
    return path


# -- the cache classes ----------------------------------------------------------------


@pytest.mark.parametrize("cache_type", ["local-disk", "memory"])
def test_cache_roundtrip(dataset, tmp_path, cache_type):
    """``tests/test_end_to_end.py:202-219``: a second pass is served from the
    cache (a second reader for the disk, a second epoch in memory)."""
    kwargs = dict(cache_type=cache_type, shuffle_row_groups=False, workers_count=1,
                  schema_fields=["id", "vec"])
    if cache_type == "local-disk":
        kwargs["cache_location"] = str(tmp_path / "cache")
        for _pass in range(2):
            with make_reader(dataset, **kwargs) as reader:
                ids = sorted(r.id for r in reader)
                stats = reader.cache_stats()
            assert ids == list(range(N_ROWS))
        assert stats == {"hits": 5, "misses": 0}
    else:
        with make_reader(dataset, num_epochs=2, **kwargs) as reader:
            ids = sorted(r.id for r in reader)
            stats = reader.cache_stats()
        assert ids == sorted(list(range(N_ROWS)) * 2)
        assert stats["hits"] == stats["misses"] == 5


def test_memory_cache_lru_eviction_and_hits():
    calls = {"n": 0}

    def make_batch(tag):
        def fill():
            calls["n"] += 1
            return ColumnBatch({"x": np.full(1000, tag, np.int64)}, 1000)
        return fill

    cache = InMemoryCache(size_limit_bytes=20_000)  # fits 2 x 8KB batches
    cache.get("a", make_batch(1))
    cache.get("b", make_batch(2))
    cache.get("a", make_batch(1))          # hit
    assert calls["n"] == 2
    cache.get("c", make_batch(3))          # evicts 'b' (LRU)
    cache.get("a", make_batch(1))          # still cached
    assert calls["n"] == 3
    cache.get("b", make_batch(2))          # miss again after eviction
    assert calls["n"] == 4
    assert cache.stats() == {"hits": 2, "misses": 4, "entries": 2, "bytes": 16_000}
    # oversized entries are served uncached, not stored
    big = InMemoryCache(size_limit_bytes=100)
    big.get("huge", make_batch(9))
    big.get("huge", make_batch(9))
    assert calls["n"] == 6


def test_memory_cache_isolated_from_inplace_mutation():
    cache = InMemoryCache()
    fixed = np.arange(6, dtype=np.float64)
    ragged = np.empty(2, dtype=object)
    ragged[0], ragged[1] = np.ones(3), np.ones(5)
    v1 = cache.get("k", lambda: ColumnBatch({"a": fixed[:2], "r": ragged}, 2))
    v1.columns["a"] /= 2.0          # consumer mutates in place
    v1.columns["r"][0] *= 100.0
    v2 = cache.get("k", lambda: (_ for _ in ()).throw(AssertionError("miss")))
    np.testing.assert_array_equal(v2.columns["a"], [0.0, 1.0])
    np.testing.assert_array_equal(v2.columns["r"][0], np.ones(3))


def test_memory_cache_object_column_sizing():
    big = np.empty(2, dtype=object)
    big[0] = np.zeros(300_000, np.uint8)  # 300KB payload behind 8-byte pointer
    big[1] = np.zeros(300_000, np.uint8)
    batch = ColumnBatch({"r": big}, 2)
    assert InMemoryCache._estimate_size(batch) > 500_000
    # cap smaller than the true payload: entry must be served uncached
    cache = InMemoryCache(size_limit_bytes=100_000)
    calls = {"n": 0}

    def fill():
        calls["n"] += 1
        return batch
    cache.get("k", fill)
    cache.get("k", fill)
    assert calls["n"] == 2


def test_disk_cache_eviction_spares_live_tmp_sweeps_orphans(tmp_path):
    cache = LocalDiskCache(str(tmp_path / "d"), size_limit_bytes=100)
    live_tmp = os.path.join(cache._dir, "writer.tmp")  # noqa: SLF001
    with open(live_tmp, "wb") as f:
        f.write(b"x" * 400)
    orphan_tmp = os.path.join(cache._dir, "orphan.tmp")  # noqa: SLF001
    with open(orphan_tmp, "wb") as f:
        f.write(b"x" * 400)
    old = time.time() - LocalDiskCache.ORPHAN_TMP_S - 10
    os.utime(orphan_tmp, (old, old))
    cache.store("k", "v" * 200)
    cache._maybe_evict()  # noqa: SLF001 - sweeps are amortized (SWEEP_EVERY)
    assert os.path.exists(live_tmp), "live writer temp was evicted"
    assert not os.path.exists(orphan_tmp), "crashed-writer orphan leaked"


def test_disk_cache_sweep_is_amortized(tmp_path):
    cache = LocalDiskCache(str(tmp_path / "d"), size_limit_bytes=10)
    for i in range(LocalDiskCache.SWEEP_EVERY - 1):
        cache.store(f"k{i}", "v" * 100)
    # over the cap, but no sweep yet: entries survive between sweeps
    assert len(os.listdir(cache._dir)) == LocalDiskCache.SWEEP_EVERY - 1  # noqa: SLF001
    cache.store("trigger", "v" * 100)         # SWEEP_EVERY-th store sweeps
    assert len(os.listdir(cache._dir)) <= 1  # noqa: SLF001


def test_disk_cache_tolerates_a_partner_deleting_the_entry(tmp_path):
    """An entry deleted between the read and the LRU touch is still a hit;
    a corrupt entry is dropped and refilled."""
    cache = LocalDiskCache(str(tmp_path / "d"))
    assert cache.get("k", lambda: "value") == "value"
    path = cache._entry_path("k")  # noqa: SLF001
    real_utime = os.utime

    def racing_utime(p, *a, **kw):
        os.remove(path)
        return real_utime(p, *a, **kw)

    import unittest.mock as mock

    with mock.patch("os.utime", racing_utime):
        assert cache.get("k", lambda: "refilled") == "value"
    assert cache.get("k", lambda: "refilled") == "refilled"
    with open(path, "wb") as f:
        f.write(b"not a pickle")
    assert cache.get("k", lambda: "again") == "again"
    assert cache.stats() == {"hits": 1, "misses": 3}


def test_make_cache_types_and_defaults(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", None)
    assert isinstance(make_cache("null"), NullCache) and isinstance(make_cache(None), NullCache)
    memory = make_cache("memory")
    assert isinstance(memory, InMemoryCache) and memory._size_limit == 4 * 2 ** 30  # noqa: SLF001
    disk = make_cache("local-disk")
    assert disk._dir == str(tmp_path / "petastorm_tpu_torch_cache")  # noqa: SLF001
    assert disk._size_limit == 10 * 2 ** 30  # noqa: SLF001
    assert make_cache("memory", cache_size_limit=123)._size_limit == 123  # noqa: SLF001
    with pytest.raises(ValueError, match="Unknown cache_type 'bogus'"):
        make_cache("bogus")
    # cleanup() releases what each tier holds
    memory.get("k", lambda: ColumnBatch({"x": np.zeros(4)}, 4))
    memory.cleanup()
    assert memory.stats()["entries"] == 0 and memory.stats()["bytes"] == 0
    disk.get("k", lambda: "v")
    disk.cleanup()
    assert not os.path.exists(disk._dir)  # noqa: SLF001


def test_shared_cache_type_raises_naming_the_missing_tier(dataset):
    with pytest.raises(PetastormTpuError, match=r"cache_type='shared'.*queue A item 11"):
        make_cache("shared")
    with pytest.raises(PetastormTpuError, match="cache_type='shared'"):
        make_reader(dataset, cache_type="shared")


# -- the reader with a cache against the reader without -------------------------------


def _read(module, dataset, place, epochs=3, **kwargs):
    """Every rowgroup's columns over ``epochs`` epochs, the stream digest,
    the decode counters and the cache counters (the port only)."""
    reader = module.make_batch_reader(dataset, reader_pool_type="serial", shuffle_seed=4,
                                      num_epochs=epochs, decode_placement={"image": place},
                                      **kwargs)
    with reader:
        batches = [{k: np.asarray(v) for k, v in b.columns.items()}
                   for b in reader.iter_batches()]
        digest = reader.stream_digest
        extra = ((reader.decode_stats(), reader.cache_stats())
                 if hasattr(reader, "cache_stats") else (None, None))
    return batches, digest, extra


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("place", ["host", "device"])
@pytest.mark.parametrize("cache_type", ["memory", "local-disk"])
def test_cached_reader_equals_uncached_and_jax_reader(dataset, tmp_path, place, cache_type):
    kwargs = {"cache_type": cache_type}
    if cache_type == "local-disk":
        kwargs["cache_location"] = str(tmp_path / "cache")
    got, digest, (decoded, cached) = _read(torch_package, dataset, place,
                                           **kwargs)
    plain, plain_digest, (plain_decoded, plain_cached) = _read(
        torch_package, dataset, place)
    want, want_digest, _ = _read(jax_package, dataset, place)
    _assert_same_batches(got, plain)
    _assert_same_batches(got, want)
    assert digest == plain_digest == want_digest
    assert len(got) == 15
    assert cached == {"hits": 10, "misses": 5, **({"entries": 5, "bytes": cached["bytes"]}
                                                  if cache_type == "memory" else {})}
    assert plain_cached == {"hits": 0, "misses": 0}
    kind = "batch" if place == "host" else "coef_batch"
    # the native decode ran in the first epoch only: a hit decodes nothing
    assert decoded[f"{kind}_images"] == N_ROWS
    assert plain_decoded[f"{kind}_images"] == 3 * N_ROWS


def test_cached_hybrid_route_images_equal_the_uncached_ones(dataset):
    """Through the loader on the hybrid route (B2's plain version on the
    CPU): three epochs from cached coefficient planes give the uncached
    run's images bit for bit."""
    def images(cache_type):
        reader = make_reader(dataset, reader_pool_type="thread", workers_count=4,
                             shuffle_seed=4, num_epochs=3,
                             decode_placement={"image": "device"}, cache_type=cache_type)
        with CudaDataLoader(reader, 8, device="cpu") as loader:
            out = [(b["id"].clone(), b["image"].clone()) for b in loader]
        return out, reader.cache_stats(), reader.decode_stats()

    got, cached, decoded = images("memory")
    want, _, _ = images("null")
    assert len(got) == len(want) == 15
    for (gi, gim), (wi, wim) in zip(got, want):
        assert torch.equal(gi, wi) and torch.equal(gim, wim)
    # the window (14 items) spans all 3 epochs of 5 rowgroups: reads of one
    # rowgroup overlap, and the later ones wait for the first fill
    assert cached["hits"] == 10 and cached["misses"] == 5
    assert decoded["coef_batch_images"] == N_ROWS


def test_random_roi_hit_equals_a_redecode(dataset):
    """A random ``decode_roi`` is seeded per rowgroup, so a cached crop is
    the crop a second decode gives; another ROI is another key."""
    roi = {"image": ("random", 16, 20)}
    got, _, (_, cached) = _read(torch_package, dataset, "host",
                                cache_type="memory", decode_roi=roi)
    plain, _, _ = _read(torch_package, dataset, "host", decode_roi=roi)
    _assert_same_batches(got, plain)
    assert cached["hits"] == 10
    assert got[0]["image"].shape == (GROUP, 16, 20, 3)


def test_cache_key_covers_fields_roi_placement_and_file(dataset, tmp_path):
    """Readers of other fields, ROI or placement miss on one directory; a
    reader of the same settings hits."""
    location = str(tmp_path / "cache")

    def stats(**kwargs):
        with make_batch_reader(dataset, reader_pool_type="serial", shuffle_seed=4,
                               cache_type="local-disk", cache_location=location,
                               **kwargs) as reader:
            for _ in reader.iter_batches():
                pass
            return reader.cache_stats()

    assert stats() == {"hits": 0, "misses": 5}
    assert stats() == {"hits": 5, "misses": 0}
    assert stats(schema_fields=["id", "image"]) == {"hits": 0, "misses": 5}
    assert stats(decode_roi={"image": ("center", 16, 16)}) == {"hits": 0, "misses": 5}
    assert stats(decode_placement={"image": "device"}) == {"hits": 0, "misses": 5}
    assert stats() == {"hits": 5, "misses": 0}


def test_directory_filled_by_the_jax_cache_gives_only_misses(dataset, tmp_path):
    """The JAX package's ``LocalDiskCache`` pickles ``petastorm_tpu``
    classes; the port's keys differ, so it never reads them."""
    location = str(tmp_path / "shared_dir")
    for _ in range(2):  # the second JAX pass is served from the directory
        with jax_make_batch_reader(dataset, reader_pool_type="serial", shuffle_seed=4,
                                   cache_type="local-disk",
                                   cache_location=location) as reader:
            want = [b.columns["id"].tolist() for b in reader.iter_batches()]
    jax_entries = set(os.listdir(location))
    assert len(jax_entries) == 5
    with make_batch_reader(dataset, reader_pool_type="serial", shuffle_seed=4,
                           cache_type="local-disk", cache_location=location) as reader:
        got = [b.columns["id"].tolist() for b in reader.iter_batches()]
        assert reader.cache_stats() == {"hits": 0, "misses": 5}
    assert got == want
    assert len(set(os.listdir(location)) - jax_entries) == 5


def test_concurrent_reads_of_one_rowgroup_fill_once(dataset, monkeypatch):
    """Threads that read one rowgroup at once decode it once: the later ones
    wait for the first fill and hit."""
    import threading

    from petastorm_tpu_torch.plan import WorkItem
    from petastorm_tpu_torch.worker import RowGroupDecoderWorker

    with make_batch_reader(dataset, reader_pool_type="serial") as reader:
        item = reader.plan.epoch_items(0)[0]
        schema = reader._worker._schema  # noqa: SLF001 - the worker's full schema
    cache = InMemoryCache()
    worker = RowGroupDecoderWorker(schema, ["id", "vec"], cache=cache, dataset_url=dataset)
    gate, fills = threading.Event(), []
    real_get = cache.get

    def slow_get(key, fill):
        def gated_fill():
            fills.append(key)
            gate.wait(timeout=10)
            return fill()
        return real_get(key, gated_fill)

    monkeypatch.setattr(cache, "get", slow_get)
    process = worker()
    out = [None] * 4

    def read(i):
        out[i] = process(WorkItem(item.row_group))

    threads = [threading.Thread(target=read, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.2)
    gate.set()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(fills) == 1 and cache.stats()["hits"] == 3 and cache.stats()["misses"] == 1
    for o in out[1:]:
        np.testing.assert_array_equal(o.columns["id"], out[0].columns["id"])
    assert worker._filling == {}  # noqa: SLF001 - no key left behind
