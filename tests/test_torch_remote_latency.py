"""The port's readers over non-local filesystems: fsspec's ``memory://``, a
``dir::`` store resolved from ``storage_options``, and the latency-injecting
fake (``test_util/latency_fs.py``).

The JAX suite's cases (``tests/test_fs_remote.py``, ``tests/test_remote_latency.py``)
on the port, with ``CudaDataLoader`` on the CPU where they feed
``JaxDataLoader`` and the port's process pool where they spawn the JAX
one; rows and order through a latent filesystem
held equal to the JAX reader's; and the parameter names of the seven
functions that take remote storage held to the JAX package's.
"""

import inspect
import pickle
import time

import numpy as np
import pytest

from petastorm_tpu_torch.codecs import NdarrayCodec
from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.etl.writer import write_dataset
from petastorm_tpu_torch.fs import FilesystemFactory, get_filesystem_and_path
from petastorm_tpu_torch.reader import make_batch_reader, make_reader
from petastorm_tpu_torch.schema import Field, Schema
from petastorm_tpu_torch.test_util.latency_fs import latent_filesystem
from petastorm_tpu_torch.test_util.synthetic import write_wide_dataset

fsspec = pytest.importorskip("fsspec")

ROWS = 32
N_COLS = 8
N_ROWGROUPS = 8
ROWS_PER_RG = 32


def _schema():
    return Schema("Remote", [
        Field("id", np.int64),
        Field("vec", np.float32, (4,), NdarrayCodec()),
    ])


def _rows(n=ROWS, base=0):
    return [{"id": base + i, "vec": np.full(4, base + i, np.float32)} for i in range(n)]


@pytest.fixture()
def memfs():
    fs = fsspec.filesystem("memory")
    yield fs
    fs.store.clear()


# -- tests/test_fs_remote.py --------------------------------------------------------

def test_memory_scheme_write_stamp_read(memfs):
    import pyarrow.fs as pafs

    url = "memory://ds_a"
    write_dataset(url, _schema(), _rows(), row_group_size_rows=8)
    fs, _ = get_filesystem_and_path(url)
    assert isinstance(fs, pafs.PyFileSystem)
    with make_reader(url, reader_pool_type="thread", workers_count=2, num_epochs=1,
                     shuffle_row_groups=False) as r:
        rows = list(r)
    assert [row.id for row in rows] == list(range(ROWS))  # the port delivers in plan order
    by_id = {int(row.id): row.vec for row in rows}
    np.testing.assert_array_equal(by_id[5], np.full(4, 5, np.float32))


def test_memory_scheme_cuda_loader_feed(memfs):
    from petastorm_tpu_torch.cuda.loader import CudaDataLoader

    url = "memory://ds_feed"
    write_dataset(url, _schema(), _rows(), row_group_size_rows=8)
    with make_batch_reader(url, reader_pool_type="thread", num_epochs=1,
                           shuffle_row_groups=False) as r:
        with CudaDataLoader(r, batch_size=8, device="cpu") as loader:
            batches = list(loader)
    assert len(batches) == 4
    got = np.concatenate([b["id"].numpy() for b in batches])
    assert sorted(got.tolist()) == list(range(ROWS))
    assert batches[0]["vec"].shape == (8, 4)


def test_memory_scheme_multi_url_expansion(memfs):
    url_a, url_b = "memory://multi/ds_a", "memory://multi/ds_b"
    files_a = write_dataset(url_a, _schema(), _rows(16, base=0), row_group_size_rows=8)
    files_b = write_dataset(url_b, _schema(), _rows(16, base=16), row_group_size_rows=8)
    urls = [f"memory://{p}" for p in files_a + files_b]
    with make_batch_reader(urls, reader_pool_type="serial", num_epochs=1,
                           shuffle_row_groups=False) as r:
        ids = [int(i) for b in r.iter_batches() for i in b.columns["id"]]
    assert sorted(ids) == list(range(32))


def test_memory_scheme_mixed_authority_rejected(memfs):
    with pytest.raises(PetastormTpuError, match="share scheme"):
        make_batch_reader(["memory://x/a.parquet", "other://x/b.parquet"])


def test_dir_scheme_factory_pickles_and_re_resolves(tmp_path):
    """The fsspec filesystem re-resolves from (url, storage_options) after a
    pickle round trip, the FilesystemFactory contract, and inside spawned
    process-pool workers (``tests/test_fs_remote.py:106``)."""
    backing = tmp_path / "backing"
    backing.mkdir()
    url = "dir://ds"
    opts = {"path": str(backing), "target_protocol": "file"}
    write_dataset(url, _schema(), _rows(), row_group_size_rows=8, storage_options=opts)
    assert (backing / "ds" / "_common_metadata").exists()
    clone = pickle.loads(pickle.dumps(FilesystemFactory(url, opts)))
    assert clone().get_file_info("ds/_common_metadata").is_file
    with make_reader(url, reader_pool_type="process", workers_count=2, num_epochs=1,
                     shuffle_row_groups=False, storage_options=opts) as r:
        rows = list(r)
    assert [row.id for row in rows] == list(range(ROWS))


# -- tests/test_remote_latency.py ---------------------------------------------------

@pytest.fixture(scope="module")
def wide_ds(tmp_path_factory):
    url = str(tmp_path_factory.mktemp("latent") / "wide")
    write_wide_dataset(url, n_cols=N_COLS, n_rowgroups=N_ROWGROUPS, rows_per_rg=ROWS_PER_RG)
    return url


def _read_all(url, fs, factory=make_batch_reader, **kwargs):
    ids = []
    with factory(url, filesystem=fs, shuffle_row_groups=False, num_epochs=1, **kwargs) as r:
        for cb in r.iter_batches():
            ids.extend(np.asarray(cb.columns["id"]).astype(int).tolist())
        stats = r.io_stats() if hasattr(r, "io_stats") else None
    return ids, stats


def test_reads_per_rowgroup_bounded(wide_ds):
    """The window: each rowgroup's column chunks arrive in ONE ranged read."""
    fs, stats = latent_filesystem(latency_s=0.0)
    ids, io = _read_all(wide_ds, fs, reader_pool_type="serial")
    assert ids == list(range(N_ROWGROUPS * ROWS_PER_RG))
    s = stats.snapshot()
    assert s["reads"] / N_ROWGROUPS < N_COLS / 2, s
    assert s["opens"] <= 4, s
    assert io["rowgroups_read"] == N_ROWGROUPS and io["reads_per_rowgroup"] == 1.0


def test_latency_hidden_by_workers_and_prefetch(wide_ds):
    t0 = time.perf_counter()
    fs0, _ = latent_filesystem(latency_s=0.0)
    ids, _ = _read_all(wide_ds, fs0, reader_pool_type="thread", workers_count=4)
    local_wall = time.perf_counter() - t0
    assert ids == list(range(N_ROWGROUPS * ROWS_PER_RG))
    fs, stats = latent_filesystem(latency_s=0.02)
    t0 = time.perf_counter()
    ids, _ = _read_all(wide_ds, fs, reader_pool_type="thread", workers_count=4)
    wall = time.perf_counter() - t0
    assert ids == list(range(N_ROWGROUPS * ROWS_PER_RG))
    s = stats.snapshot()
    assert s["slept_s"] > 0.2, s
    assert wall < 0.75 * s["slept_s"] + local_wall + 0.5, (wall, s, local_wall)
    assert wall < 6.0 * local_wall + 1.0, (wall, local_wall)


def test_io_retries_compose_with_slow_failing_calls(wide_ds):
    fs, stats = latent_filesystem(latency_s=0.02, fail_first_reads=3)
    ids, io = _read_all(wide_ds, fs, reader_pool_type="serial")
    assert ids == list(range(N_ROWGROUPS * ROWS_PER_RG))
    assert stats.snapshot()["failures_injected"] == 3
    # the _common_metadata probe takes the first failure without a retry (it
    # reads the key-value metadata as absent, as the JAX package does); the
    # schema footer's read retries the other two
    assert io["retries"] == 2


def test_io_retries_off_surfaces_failure(wide_ds):
    fs, _ = latent_filesystem(latency_s=0.0, fail_first_reads=50)
    with pytest.raises((OSError, PetastormTpuError)):
        _read_all(wide_ds, fs, reader_pool_type="serial", io_retries=0)


def test_row_reader_over_latent_fs(wide_ds):
    fs, stats = latent_filesystem(latency_s=0.005)
    with make_reader(wide_ds, filesystem=fs, shuffle_row_groups=False, num_epochs=1,
                     reader_pool_type="serial", schema_fields=["id"]) as r:
        ids = [int(row.id) for row in r]
    assert ids == list(range(N_ROWGROUPS * ROWS_PER_RG))
    assert stats.snapshot()["reads"] > 0


# -- parity with the JAX package ----------------------------------------------------

@pytest.mark.parametrize("pool,fail_reads,fail_opens", [("serial", 0, 0), ("serial", 2, 1),
                                                        ("thread", 0, 0), ("thread", 1, 0)])
def test_latent_rows_and_order_equal_the_jax_readers(wide_ds, pool, fail_reads, fail_opens):
    """A seeded shuffled read through a latent (and failing) filesystem: the
    port's ids and vectors, in order, equal the JAX reader's."""
    from petastorm_tpu.reader import make_batch_reader as jax_make_batch_reader
    from petastorm_tpu.test_util.latency_fs import latent_filesystem as jax_latent

    def read(factory, make_fs):
        fs, _ = make_fs(latency_s=0.002, fail_first_reads=fail_reads,
                        fail_first_opens=fail_opens)
        out = []
        with factory(wide_ds, filesystem=fs, shuffle_row_groups=True, shuffle_seed=5,
                     num_epochs=1, reader_pool_type=pool, workers_count=2) as r:
            for cb in r.iter_batches():
                out.extend(zip(np.asarray(cb.columns["id"]).tolist(),
                               np.asarray(cb.columns["c0"]).tolist()))
        return out

    got = read(make_batch_reader, latent_filesystem)
    want = read(jax_make_batch_reader, jax_latent)
    if pool == "thread":
        # the JAX thread pool delivers in completion order; the port in plan order
        assert sorted(got) == sorted(want)
    else:
        assert got == want
    assert sorted(i for i, _ in got) == list(range(N_ROWGROUPS * ROWS_PER_RG))


_STORAGE_ARGS = ("filesystem", "storage_options", "io_retries")
_FUNCTIONS = [("reader", "make_reader"), ("reader", "make_batch_reader"),
              ("etl.metadata", "open_dataset"), ("etl.writer", "write_dataset"),
              ("etl.writer", "materialize_dataset"), ("etl.indexing", "build_rowgroup_index"),
              ("converter", "make_converter")]


@pytest.mark.parametrize("module,name", _FUNCTIONS, ids=lambda x: str(x))
def test_storage_parameters_equal_the_jax_functions(module, name):
    """Each function takes the JAX function's storage parameters, with its
    defaults: the same names of (filesystem, storage_options, io_retries)."""
    import importlib

    def storage_params(pkg):
        fn = getattr(importlib.import_module(f"{pkg}.{module}"), name)
        params = inspect.signature(fn).parameters
        return {p: params[p].default for p in _STORAGE_ARGS if p in params}

    want = storage_params("petastorm_tpu")
    assert want, f"the JAX {name} takes none of {_STORAGE_ARGS}"
    assert storage_params("petastorm_tpu_torch") == want
