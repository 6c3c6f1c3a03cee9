"""URL -> filesystem resolution in the port (``petastorm_tpu_torch/fs.py``).

The JAX suite's cases (``tests/test_fs.py``) on the port's module, and the
port's answers held equal to the JAX module's: the filesystem type and path
of every URL of a battery, with and without a caller's filesystem.
"""

import pickle

import pyarrow as pa
import pyarrow.fs as pafs
import pytest

from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.fs import (FilesystemFactory, get_filesystem_and_path,
                              get_filesystem_and_path_or_paths,
                              normalize_dir_url)


def test_normalize_dir_url():
    assert normalize_dir_url("file:///tmp/ds/") == "file:///tmp/ds"
    assert normalize_dir_url("/tmp/ds///") == "/tmp/ds"
    assert normalize_dir_url("/") == "/"
    with pytest.raises(PetastormTpuError):
        normalize_dir_url(123)


def test_local_no_scheme(tmp_path):
    fs, path = get_filesystem_and_path(str(tmp_path))
    assert isinstance(fs, pafs.LocalFileSystem)
    assert path == str(tmp_path)


def test_local_file_scheme(tmp_path):
    fs, path = get_filesystem_and_path(f"file://{tmp_path}")
    assert isinstance(fs, pafs.LocalFileSystem)
    assert path == str(tmp_path)
    # resolved fs actually works
    (tmp_path / "x").write_text("hi")
    assert fs.get_file_info(path + "/x").type == pafs.FileType.File


def test_explicit_filesystem_path_conventions():
    fs = pafs.LocalFileSystem()
    # bucket-style scheme: bucket is part of the path
    got_fs, path = get_filesystem_and_path("s3://bucket/key/ds", filesystem=fs)
    assert got_fs is fs and path == "bucket/key/ds"
    got_fs, path = get_filesystem_and_path("gs://bucket/ds", filesystem=fs)
    assert got_fs is fs and path == "bucket/ds"
    # hdfs authority is a host/nameservice, NOT part of the path
    got_fs, path = get_filesystem_and_path("hdfs://ns1/user/ds", filesystem=fs)
    assert got_fs is fs and path == "/user/ds"
    # schemeless: path passed through
    got_fs, path = get_filesystem_and_path("/plain/path", filesystem=fs)
    assert got_fs is fs and path == "/plain/path"


def test_fsspec_fallback_scheme():
    # 'memory' is not a pyarrow-native scheme; resolution must fall through to
    # fsspec wrapped in PyFileSystem
    import fsspec

    mem = fsspec.filesystem("memory")
    mem.pipe("/probe/a.bin", b"data")
    fs, path = get_filesystem_and_path("memory://probe/a.bin")
    assert isinstance(fs, pafs.PyFileSystem)
    with fs.open_input_file(path) as f:
        assert f.read() == b"data"


def test_unresolvable_scheme_error_mentions_both_causes():
    with pytest.raises(PetastormTpuError, match="pyarrow said.*fsspec said"):
        get_filesystem_and_path("no-such-scheme://whatever/ds")


def test_multi_url_resolution(tmp_path):
    urls = [f"file://{tmp_path}/a", f"file://{tmp_path}/b"]
    fs, paths = get_filesystem_and_path_or_paths(urls)
    assert isinstance(fs, pafs.LocalFileSystem)
    assert paths == [f"{tmp_path}/a", f"{tmp_path}/b"]
    # single string in -> single path out
    fs, path = get_filesystem_and_path_or_paths(urls[0])
    assert path == f"{tmp_path}/a"


def test_multi_url_mixed_schemes_rejected(tmp_path):
    with pytest.raises(PetastormTpuError, match="share scheme"):
        get_filesystem_and_path_or_paths([f"file://{tmp_path}/a", "s3://b/c"])
    with pytest.raises(PetastormTpuError, match="[Ee]mpty"):
        get_filesystem_and_path_or_paths([])


def test_filesystem_factory_pickles(tmp_path):
    factory = FilesystemFactory(f"file://{tmp_path}/ds/")
    assert factory.url == f"file://{tmp_path}/ds"  # normalized
    clone = pickle.loads(pickle.dumps(factory))
    assert isinstance(clone(), pafs.LocalFileSystem)


def test_filesystem_factory_explicit_fs_returned_verbatim():
    fs = pafs.LocalFileSystem()
    factory = FilesystemFactory("anything://x/y", filesystem=fs)
    assert factory() is fs


def test_remote_store_round_trip_memory_fs(tmp_path):
    """Full write -> stamp -> read cycle on a non-local (fsspec) filesystem -
    the code path GCS/S3 URLs take, exercised against memory://."""
    import numpy as np

    from petastorm_tpu_torch.codecs import CompressedImageCodec
    from petastorm_tpu_torch.etl.writer import write_dataset
    from petastorm_tpu_torch.reader import make_reader
    from petastorm_tpu_torch.schema import Field, Schema

    rng = np.random.default_rng(0)
    schema = Schema("Remote", [
        Field("id", np.int64),
        Field("img", np.uint8, (16, 16, 3), CompressedImageCodec("png")),
    ])
    rows = [{"id": i, "img": rng.integers(0, 255, (16, 16, 3), dtype=np.uint8)}
            for i in range(12)]
    url = "memory://bucket/torch_remote_ds"
    files = write_dataset(url, schema, rows, row_group_size_rows=4,
                          mode="overwrite")
    assert files and all(f.startswith("bucket/") for f in files)
    with make_reader(url, shuffle_row_groups=False, num_epochs=1,
                     cur_shard=0, shard_count=3) as r:
        shard0 = [int(row.id) for row in r]
    with make_reader(url, shuffle_row_groups=False, num_epochs=1) as r:
        got = {int(row.id): np.asarray(row.img) for row in r}
    assert sorted(got) == list(range(12))
    assert len(shard0) == 4  # 1 of 3 rowgroup shards
    for i, src in enumerate(rows):
        assert np.array_equal(got[i], src["img"])


_URLS = ["/plain/path", "/plain/path/", "file:///tmp/ds", "file:///tmp/ds//", "s3://bucket/key/ds",
         "gs://bucket/ds", "hdfs://ns1/user/ds", "hdfs:///user/ds", "memory://probe/x",
         "dir::file:///x"]


@pytest.mark.parametrize("url", _URLS)
def test_explicit_filesystem_paths_equal_the_jax_modules(url):
    from petastorm_tpu import fs as jax_fs

    fs = pafs.LocalFileSystem()
    assert get_filesystem_and_path(url, filesystem=fs) == jax_fs.get_filesystem_and_path(
        url, filesystem=fs)


@pytest.mark.parametrize("url", ["/tmp/ds", "file:///tmp/ds/", "memory://bucket/ds",
                                 "no-such-scheme://x/ds"])
def test_resolution_equals_the_jax_modules(url):
    from petastorm_tpu import fs as jax_fs

    def resolve(fn):
        try:
            fs, path = fn(url)
            return type(fs).__name__, path
        except Exception as exc:  # noqa: BLE001 - compared by type and cause
            return type(exc).__name__, str(exc).split(":")[0]

    assert resolve(get_filesystem_and_path) == resolve(jax_fs.get_filesystem_and_path)


def test_a_missing_fsspec_package_raises_and_names_it(monkeypatch):
    """A scheme only fsspec resolves, with fsspec missing: a PetastormTpuError
    naming the package, never the local disk."""
    import builtins

    real_import = builtins.__import__

    def no_fsspec(name, *args, **kwargs):
        if name == "fsspec" or name.startswith("fsspec."):
            raise ModuleNotFoundError("No module named 'fsspec'", name="fsspec")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_fsspec)
    with pytest.raises(PetastormTpuError, match="fsspec"):
        get_filesystem_and_path("memory://bucket/ds")


def test_the_jax_reader_reads_the_ports_remote_write_and_back():
    """A dataset the port writes to memory:// reads the same through the JAX
    reader, and one the JAX package writes reads the same through the port's."""
    import numpy as np

    from petastorm_tpu.etl.writer import write_dataset as jax_write
    from petastorm_tpu.reader import make_reader as jax_make_reader
    from petastorm_tpu.schema import Field as JaxField
    from petastorm_tpu.schema import Schema as JaxSchema
    from petastorm_tpu_torch.etl.writer import write_dataset
    from petastorm_tpu_torch.reader import make_reader
    from petastorm_tpu_torch.schema import Field, Schema

    rng = np.random.default_rng(3)
    rows = [{"id": i, "x": rng.standard_normal(3).astype(np.float32)} for i in range(10)]

    def read(factory, url):
        with factory(url, shuffle_row_groups=False, reader_pool_type="serial") as r:
            return [(int(row.id), np.asarray(row.x).tolist()) for row in r]

    write_dataset("memory://xfs/torch_written", Schema("X", [Field("id", np.int64),
                                                             Field("x", np.float32, (3,))]),
                  rows, row_group_size_rows=4)
    jax_write("memory://xfs/jax_written", JaxSchema("X", [JaxField("id", np.int64),
                                                         JaxField("x", np.float32, (3,))]),
              rows, row_group_size_rows=4)
    for url in ("memory://xfs/torch_written", "memory://xfs/jax_written"):
        assert read(make_reader, url) == read(jax_make_reader, url)
        assert [i for i, _ in read(make_reader, url)] == list(range(10))
