"""The port's dataset converter against the JAX package's, on the CPU.

The cases of ``tests/test_converter.py`` that apply to the port, on
``petastorm_tpu_torch.converter``, plus parity: from the same pandas frame
and arrow table both packages compute the same fingerprint and cache
directory name and deliver the same rows.  ``make_cuda_loader`` takes the
place of ``make_jax_loader``; ``make_tf_dataset`` and Spark frames raise.
"""

import logging
import os
import threading
import time

import cv2
import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

from petastorm_tpu import converter as jax_converter
from petastorm_tpu.test_util.mock_pyspark import mock_spark_dataframe

from petastorm_tpu_torch import converter
from petastorm_tpu_torch.converter import (CACHE_DIR_ENV_VAR, _registered_converters,
                                           make_converter)
from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.native import image as native_image
from petastorm_tpu_torch.transform import TransformSpec

LAUNCHER_VARS = ("HOROVOD_RANK", "HOROVOD_SIZE", "OMPI_COMM_WORLD_RANK",
                 "OMPI_COMM_WORLD_SIZE", "PMI_RANK", "PMI_SIZE", "RANK", "WORLD_SIZE")


@pytest.fixture(autouse=True)
def _no_launcher(monkeypatch):
    """The tests set the launcher variables they need, and no others."""
    for var in LAUNCHER_VARS:
        monkeypatch.delenv(var, raising=False)


def _df(n=64):
    return pd.DataFrame({
        "id": np.arange(n, dtype=np.int64),
        "x": np.linspace(0, 1, n).astype(np.float64),
        "label": (np.arange(n) % 3).astype(np.int32),
    })


def _rows(conv, **kwargs):
    with conv.make_reader(reader_pool_type="serial", shuffle_row_groups=False, num_epochs=1,
                          **kwargs) as reader:
        return [row._asdict() for row in reader]


def test_requires_cache_dir(monkeypatch):
    monkeypatch.delenv(CACHE_DIR_ENV_VAR, raising=False)
    with pytest.raises(PetastormTpuError, match="cache"):
        make_converter(_df())


@pytest.mark.parametrize("kind", ["pandas", "arrow"])
def test_fingerprint_and_rows_equal_the_jax_converters(tmp_path, kind):
    data = _df() if kind == "pandas" else pa.table({"id": np.arange(40, dtype=np.int64),
                                                   "y": np.linspace(0, 2, 40)})
    port = make_converter(data, cache_dir_url=str(tmp_path / "port"))
    ref = jax_converter.make_converter(data, cache_dir_url=str(tmp_path / "jax"))
    try:
        assert os.path.basename(port.cache_url) == os.path.basename(ref.cache_url)
        assert os.path.basename(port.cache_url).startswith("converted-")
        assert len(port) == len(ref) == (64 if kind == "pandas" else 40)
        assert [f.name for f in port.schema] == [f.name for f in ref.schema]
        assert [f.dtype for f in port.schema] == [f.dtype for f in ref.schema]
        got = _rows(port)
        with ref.make_reader(reader_pool_type="serial", shuffle_row_groups=False,
                             num_epochs=1) as reader:
            want = [row._asdict() for row in reader]
        assert len(got) == len(want) and got
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for name in g:
                np.testing.assert_array_equal(g[name], w[name])
        # each package reads the other's converted directory
        fs_tag = os.path.basename(port.cache_url)
        other = make_converter(data, cache_dir_url=str(tmp_path / "jax"),
                               delete_at_exit=False)
        assert other.cache_url.endswith(fs_tag) and _rows(other) == got
    finally:
        port.delete(), ref.delete()


def test_materialize_and_read_back(tmp_path):
    conv = make_converter(_df(), cache_dir_url=str(tmp_path / "cache"))
    try:
        assert len(conv) == 64
        assert [row["id"] for row in _rows(conv)] == list(range(64))
    finally:
        conv.delete()
    assert not os.path.exists(conv.cache_url)


def test_float64_downcast_default_and_opt_out(tmp_path):
    conv32 = make_converter(_df(), cache_dir_url=str(tmp_path / "c32"))
    conv64 = make_converter(_df(), cache_dir_url=str(tmp_path / "c64"), dtype=None)
    list_table = pa.table({"v": pa.array([[0.5, 1.5], [2.5]], pa.list_(pa.float32()))})
    conv_list = make_converter(list_table, cache_dir_url=str(tmp_path / "cl"), dtype="float64")
    try:
        assert conv32.schema["x"].dtype == np.float32
        assert conv64.schema["x"].dtype == np.float64
        assert conv_list.schema["v"].dtype == np.float64
        with pytest.raises(PetastormTpuError, match="dtype must be"):
            make_converter(_df(), cache_dir_url=str(tmp_path / "bad"), dtype="float16")
    finally:
        conv32.delete(), conv64.delete(), conv_list.delete()


def test_dedup_by_content(tmp_path):
    cache = str(tmp_path / "cache")
    a = make_converter(_df(), cache_dir_url=cache)
    b = make_converter(_df(), cache_dir_url=cache)        # same content
    c = make_converter(_df(32), cache_dir_url=cache)      # different content
    d = make_converter(_df(), cache_dir_url=cache, row_group_size_mb=1)
    try:
        assert a is b  # shared handle: delete() on one cannot orphan the other
        assert a.cache_url != c.cache_url
        assert a.cache_url != d.cache_url  # params are part of the fingerprint
    finally:
        for conv in (a, b, c, d):
            conv.delete()
    e = make_converter(_df(), cache_dir_url=cache)
    try:
        assert e is not a and len(_rows(e)) == 64
    finally:
        e.delete()


def test_second_process_reuses_the_published_files(tmp_path):
    """A converter of the same content in a fresh process (here: the live
    registry emptied) adopts the published directory without writing."""
    cache = str(tmp_path / "cache")
    a = make_converter(_df(), cache_dir_url=cache, delete_at_exit=False)
    mtimes = {f: os.stat(f).st_mtime_ns for f in a.file_urls}
    converter._converters_by_url.clear()
    b = make_converter(_df(), cache_dir_url=cache)
    try:
        assert b is not a and b.cache_url == a.cache_url
        assert {f: os.stat(f).st_mtime_ns for f in b.file_urls} == mtimes
    finally:
        b.delete()


def test_env_var_cache_dir(tmp_path, monkeypatch):
    monkeypatch.setenv(CACHE_DIR_ENV_VAR, str(tmp_path / "envcache"))
    conv = make_converter(_df())
    try:
        assert str(tmp_path / "envcache") in conv.cache_url
    finally:
        conv.delete()


def test_arrow_table_input(tmp_path):
    table = pa.table({"id": np.arange(10, dtype=np.int64), "y": np.ones(10, np.float32)})
    conv = make_converter(table, cache_dir_url=str(tmp_path / "cache"))
    try:
        assert len(_rows(conv)) == 10
    finally:
        conv.delete()


def test_unsupported_input_rejected(tmp_path):
    with pytest.raises(PetastormTpuError, match="Unsupported input"):
        make_converter([1, 2, 3], cache_dir_url=str(tmp_path / "cache"))


def test_make_torch_dataloader(tmp_path):
    conv = make_converter(_df(), cache_dir_url=str(tmp_path / "cache"))
    try:
        with conv.make_torch_dataloader(batch_size=16, reader_kwargs={"num_epochs": 1}) as loader:
            batches = list(loader)
        assert sum(len(b["id"]) for b in batches) == 64
        assert isinstance(batches[0]["x"], torch.Tensor)
    finally:
        conv.delete()


def test_make_cuda_loader_on_the_cpu(tmp_path):
    conv = make_converter(_df(), cache_dir_url=str(tmp_path / "cache"))
    try:
        with conv.make_cuda_loader(batch_size=16, device="cpu",
                                   reader_kwargs={"num_epochs": 1, "shuffle_seed": 0}) as loader:
            batch = next(iter(loader))
        assert isinstance(batch["x"], torch.Tensor) and batch["x"].shape == (16,)
        assert batch["x"].dtype == torch.float32 and batch["id"].dtype == torch.int64
    finally:
        conv.delete()


def _decode_jpegs(cols):
    """The converter's JPEG bytes column decoded in one native call."""
    images = np.empty((len(cols["image"]), 224, 224, 3), np.uint8)
    native_image.decode_column_native(pa.array(list(cols["image"]), pa.binary()), images)
    return {"label": cols["label"], "image": images}


def test_make_cuda_loader_delivers_phase4_shaped_batches(tmp_path):
    """Phase 22's feed at a small size: an arrow table of 224 x 224 JPEG
    bytes and labels -> ``make_cuda_loader`` -> uint8 (8, 224, 224, 3) images
    (the bytes decoded by a ``TransformSpec``: the converter's inferred
    schema carries them as binary, as the reference's does) and int64
    labels, each image cv2's decode of its bytes."""
    rng = np.random.default_rng(0)
    images = [cv2.resize(rng.integers(0, 256, (7, 7, 3)).astype(np.float32), (224, 224))
              .astype(np.uint8) for _ in range(16)]
    bufs = [cv2.imencode(".jpeg", img)[1].tobytes() for img in images]
    table = pa.table({"label": np.arange(16, dtype=np.int64), "image": pa.array(bufs)})
    conv = make_converter(table, cache_dir_url=str(tmp_path / "cache"))
    spec = TransformSpec(_decode_jpegs, edit_fields=[("image", np.uint8, (224, 224, 3), False)])
    try:
        with conv.make_cuda_loader(batch_size=8, device="cpu", reader_kwargs={
                "num_epochs": 1, "shuffle_seed": 0, "transform_spec": spec}) as loader:
            batches = list(loader)
        assert len(batches) == 2
        for b in batches:
            assert b["image"].dtype == torch.uint8 and b["image"].shape == (8, 224, 224, 3)
            assert b["label"].dtype == torch.int64
            for label, image in zip(b["label"].tolist(), b["image"].numpy()):
                want = cv2.imdecode(np.frombuffer(bufs[label], np.uint8), cv2.IMREAD_COLOR)
                np.testing.assert_array_equal(image, want[..., ::-1])
    finally:
        conv.delete()


@pytest.mark.parametrize("rank_var, size_var", [
    ("HOROVOD_RANK", "HOROVOD_SIZE"), ("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE"),
    ("PMI_RANK", "PMI_SIZE"), ("RANK", "WORLD_SIZE")])
def test_rank_mismatch_warns(tmp_path, monkeypatch, rank_var, size_var):
    monkeypatch.setenv(rank_var, "1")
    monkeypatch.setenv(size_var, "4")
    conv = make_converter(_df(2000), cache_dir_url=str(tmp_path / "cache"),
                          row_group_size_mb=0.001)
    try:
        with pytest.warns(UserWarning, match="disagrees"):
            with conv.make_reader(cur_shard=0, shard_count=4, num_epochs=1) as r:
                next(iter(r))
        with pytest.warns(UserWarning, match="ALL the data"):
            with conv.make_reader(num_epochs=1) as r:
                next(iter(r))
        with pytest.warns(UserWarning, match="disagrees"):
            conv.make_cuda_loader(8, device="cpu", reader_kwargs={
                "cur_shard": 1, "shard_count": 2}).stop()
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("error")
            with conv.make_reader(cur_shard=1, shard_count=4, num_epochs=1) as r:
                next(iter(r))
    finally:
        conv.delete()


def test_no_launcher_no_warning(tmp_path):
    import warnings

    conv = make_converter(_df(), cache_dir_url=str(tmp_path / "cache"))
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            with conv.make_reader(num_epochs=1) as r:
                next(iter(r))
    finally:
        conv.delete()


def test_atexit_registration(tmp_path):
    conv = make_converter(_df(), cache_dir_url=str(tmp_path / "cache"))
    assert conv in _registered_converters
    conv.delete()
    assert conv not in _registered_converters
    keep = make_converter(_df(), cache_dir_url=str(tmp_path / "cache2"), delete_at_exit=False)
    assert keep not in _registered_converters
    keep.delete()  # not the owner: the files stay
    assert os.path.exists(keep.cache_url)
    doomed = make_converter(_df(16), cache_dir_url=str(tmp_path / "cache3"))
    converter._cleanup_at_exit()
    assert not os.path.exists(doomed.cache_url) and doomed not in _registered_converters


def test_make_tf_dataset_raises(tmp_path):
    conv = make_converter(_df(), cache_dir_url=str(tmp_path / "cache"))
    try:
        with pytest.raises(PetastormTpuError, match="not part of this package yet"):
            conv.make_tf_dataset(reader_kwargs={"num_epochs": 1})
    finally:
        conv.delete()


def test_spark_frame_raises(tmp_path):
    with pytest.raises(PetastormTpuError, match="Spark DataFrame"):
        make_converter(mock_spark_dataframe(), cache_dir_url=str(tmp_path))


def test_slices_get_distinct_fingerprints(tmp_path):
    t = pa.table({"x": np.arange(100, dtype=np.int64)})
    c1 = make_converter(t.slice(0, 50), str(tmp_path), dtype=None)
    c2 = make_converter(t.slice(50, 50), str(tmp_path), dtype=None)
    c3 = make_converter(t, str(tmp_path), dtype=None)
    try:
        assert len({c1.cache_url, c2.cache_url, c3.cache_url}) == 3
        assert sorted(row["x"] for row in _rows(c2)) == list(range(50, 100))
    finally:
        c1.delete(), c2.delete(), c3.delete()


def test_arrow_path_clears_debris_dir(tmp_path):
    t = pa.table({"x": np.arange(40, dtype=np.int64)})
    tag = converter._fingerprint(t, {"codec": "snappy", "rg_mb": 128.0, "v": 2})
    assert tag == jax_converter._fingerprint(t, {"codec": "snappy", "rg_mb": 128.0, "v": 2})
    debris = tmp_path / f"converted-{tag}"
    debris.mkdir()
    (debris / "stray.txt").write_text("junk")
    conv = make_converter(t, str(tmp_path), row_group_size_mb=128.0)
    try:
        assert conv.file_urls and all(u.endswith(".parquet") for u in conv.file_urls)
        assert sorted(row["x"] for row in _rows(conv)) == list(range(40))
        assert not (debris / "stray.txt").exists()
    finally:
        conv.delete()


def test_dedup_persistence_wins(tmp_path):
    conv1 = make_converter(_df(), str(tmp_path))
    assert conv1 in _registered_converters
    conv2 = make_converter(_df(), str(tmp_path), delete_at_exit=False)
    assert conv2 is conv1
    assert conv1 not in _registered_converters and not conv1._owns_cache
    with pytest.warns(UserWarning, match="delete_at_exit=False"):
        make_converter(_df(), str(tmp_path), delete_at_exit=True)
    assert conv1 not in _registered_converters


def test_explicit_snappy_reuses_default_cache(tmp_path):
    c1 = make_converter(_df(), str(tmp_path))
    c2 = make_converter(_df(), str(tmp_path), compression_codec="snappy")
    try:
        assert c2 is c1
    finally:
        c1.delete()


def test_small_files_advice(tmp_path, caplog):
    with caplog.at_level(logging.WARNING, logger="petastorm_tpu_torch.converter"):
        conv = make_converter(_df(), str(tmp_path))
    try:
        assert any("median converted file size" in r.getMessage() for r in caplog.records)
    finally:
        conv.delete()


def test_wait_files_available_times_out(tmp_path):
    import pyarrow.fs as pafs

    with pytest.raises(PetastormTpuError, match="Timed out"):
        converter._wait_files_available(pafs.LocalFileSystem(), [str(tmp_path / "missing")],
                                        timeout_s=0.3)


def test_loader_factory_failure_does_not_leak_reader(tmp_path):
    conv = make_converter(_df(), str(tmp_path))
    before = threading.active_count()
    try:
        with pytest.raises(PetastormTpuError):
            conv.make_cuda_loader(batch_size=0, device="cpu")
        deadline = 50
        while threading.active_count() > before and deadline:
            time.sleep(0.1)
            deadline -= 1
        assert threading.active_count() <= before
    finally:
        conv.delete()
