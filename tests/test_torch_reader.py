"""The port's host plane against the JAX package's, on the CPU.

Datasets written by either package's writer are read by both packages'
readers; with the serial pool and the same seed, shard and epochs both yield
identical arrays in identical order.  Scalars, ndarrays and PNG images must
match exactly.  JPEG must match exactly too: the port decodes through OpenCV,
and the JAX package here decodes through its native libjpeg build
(``petastorm_tpu/native``), falling back to OpenCV without it; both give the
same pixels for these streams, and ``test_jpeg_port_decodes_like_cv2`` pins
the port to OpenCV itself.
"""

import sys
import threading

import cv2
import numpy as np
import pytest
import torch

import petastorm_tpu.dtypes as jax_dtypes
import petastorm_tpu.plan as jax_plan
import petastorm_tpu.reader as jax_reader
import petastorm_tpu.seeding as jax_seeding
from petastorm_tpu import codecs as jax_codecs
from petastorm_tpu import schema as jax_schema
from petastorm_tpu.etl import metadata as jax_metadata
from petastorm_tpu.etl.writer import write_dataset as jax_write_dataset

import petastorm_tpu_torch.dtypes as torch_dtypes
import petastorm_tpu_torch.plan as torch_plan
import petastorm_tpu_torch.reader as torch_reader
import petastorm_tpu_torch.seeding as torch_seeding
from petastorm_tpu_torch import codecs as torch_codecs
from petastorm_tpu_torch import schema as torch_schema
from petastorm_tpu_torch.cuda.loader import CudaDataLoader
from petastorm_tpu_torch.errors import NoDataAvailableError, SchemaError
from petastorm_tpu_torch.etl import metadata as torch_metadata
from petastorm_tpu_torch.etl.writer import write_dataset as torch_write_dataset

N_ROWS, ROWS_PER_GROUP = 60, 7


def _schema(mod, codecs):
    return mod.Schema("Mixed", [
        mod.Field("label", np.int64),
        mod.Field("score", np.float32),
        mod.Field("vec", np.float32, (4,), codecs.NdarrayCodec()),
        mod.Field("png", np.uint8, (8, 10, 3), codecs.CompressedImageCodec("png")),
        mod.Field("jpeg", np.uint8, (16, 24, 3), codecs.CompressedImageCodec("jpeg", 90)),
        mod.Field("gray", np.uint16, (6, 5, 1), codecs.CompressedImageCodec("png")),
    ])


def _rows(seed):
    rng = np.random.default_rng(seed)
    return [{"label": i,
             "score": np.float32(rng.standard_normal()),
             "vec": rng.standard_normal(4).astype(np.float32),
             "png": rng.integers(0, 256, (8, 10, 3), dtype=np.uint8),
             "jpeg": rng.integers(0, 256, (16, 24, 3), dtype=np.uint8),
             "gray": rng.integers(0, 65536, (6, 5, 1), dtype=np.uint16)}
            for i in range(N_ROWS)]


@pytest.fixture(scope="module", params=["written_by_jax", "written_by_port"])
def dataset(request, tmp_path_factory):
    path = str(tmp_path_factory.mktemp(request.param) / "ds")
    if request.param == "written_by_jax":
        jax_write_dataset(path, _schema(jax_schema, jax_codecs), _rows(0),
                          row_group_size_rows=ROWS_PER_GROUP)
    else:
        torch_write_dataset(path, _schema(torch_schema, torch_codecs), _rows(0),
                            row_group_size_rows=ROWS_PER_GROUP)
    return path


def _read_rows(mod, path, **kwargs):
    with mod.make_reader(path, **kwargs) as reader:
        return [row._asdict() for row in reader]


def _assert_rows_equal(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert ra.keys() == rb.keys()
        for name in ra:
            np.testing.assert_array_equal(np.asarray(ra[name]), np.asarray(rb[name]), err_msg=name)
            assert np.asarray(ra[name]).dtype == np.asarray(rb[name]).dtype, name


@pytest.mark.parametrize("kwargs", [
    dict(shuffle_seed=0, num_epochs=1),
    dict(shuffle_seed=7, num_epochs=2),
    dict(shuffle_row_groups=False, num_epochs=1),
    dict(shuffle_seed=3, num_epochs=2, cur_shard=1, shard_count=3),
    dict(shuffle_seed=5, num_epochs=1, cur_shard=0, shard_count=2,
         schema_fields=["label", "jpeg"]),
], ids=["seed0", "seed7-2ep", "noshuffle", "shard1of3", "fields"])
def test_serial_rows_identical_in_both_directions(dataset, kwargs):
    want = _read_rows(jax_reader, dataset, reader_pool_type="serial", **kwargs)
    got = _read_rows(torch_reader, dataset, reader_pool_type="serial", **kwargs)
    _assert_rows_equal(got, want)
    assert len(got) > 0


@pytest.mark.parametrize("workers", [1, 3, 8])
def test_thread_pool_same_row_multiset(dataset, workers):
    kwargs = dict(shuffle_seed=11, num_epochs=2, workers_count=workers)
    want = _read_rows(jax_reader, dataset, reader_pool_type="thread", **kwargs)
    got = _read_rows(torch_reader, dataset, reader_pool_type="thread", **kwargs)
    assert sorted(r["label"] for r in got) == sorted(r["label"] for r in want)
    by_label = {}
    for r in want:
        by_label.setdefault(int(r["label"]), r)
    for r in got:
        _assert_rows_equal([r], [by_label[int(r["label"])]])
    # the port's thread pool delivers in plan order, like its serial pool
    serial = _read_rows(torch_reader, dataset, reader_pool_type="serial", shuffle_seed=11,
                        num_epochs=2)
    _assert_rows_equal(got, serial)


def test_batch_reader_matches_jax(dataset):
    kwargs = dict(reader_pool_type="serial", shuffle_seed=2, num_epochs=1)
    with jax_reader.make_batch_reader(dataset, **kwargs) as r:
        want = [b._asdict() for b in r]
    with torch_reader.make_batch_reader(dataset, **kwargs) as r:
        got = [b._asdict() for b in r]
    assert [len(b["label"]) for b in got] == [len(b["label"]) for b in want]
    for gb, wb in zip(got, want):
        for name in wb:
            np.testing.assert_array_equal(gb[name], wb[name], err_msg=name)


def test_jpeg_port_decodes_like_cv2(dataset):
    field = _schema(torch_schema, torch_codecs)["jpeg"]
    info = torch_metadata.open_dataset(dataset)
    import pyarrow.parquet as pq

    column = pq.read_table(info.files[0], columns=["jpeg"]).column("jpeg").combine_chunks()
    got = field.codec.decode_column(field, column)
    want = np.stack([cv2.cvtColor(cv2.imdecode(np.frombuffer(v.as_py(), np.uint8),
                                               cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
                     for v in column])
    np.testing.assert_array_equal(got, want)


def test_metadata_agrees(dataset):
    jinfo = jax_metadata.open_dataset(dataset)
    tinfo = torch_metadata.open_dataset(dataset)
    assert [(r.path, r.row_group, r.num_rows, r.global_index) for r in tinfo.row_groups] == \
        [(r.path, r.row_group, r.num_rows, r.global_index) for r in jinfo.row_groups]
    assert tinfo.stored_schema.to_json() == jinfo.stored_schema.to_json()


def test_schema_json_identical():
    j = _schema(jax_schema, jax_codecs)
    t = _schema(torch_schema, torch_codecs)
    assert t.to_json() == j.to_json()
    assert torch_schema.Schema.from_json(j.to_json()).to_json() == j.to_json()
    assert jax_schema.Schema.from_json(t.to_json()).to_json() == t.to_json()
    assert torch_schema.SCHEMA_METADATA_KEY == jax_schema.SCHEMA_METADATA_KEY
    assert torch_metadata.ROW_GROUPS_METADATA_KEY == jax_metadata.ROW_GROUPS_METADATA_KEY


@pytest.mark.parametrize("seed,epoch,domain,extra", [
    (None, 0, "plan.permutation", ()), (0, 0, "plan.permutation", ()),
    (7, 3, "plan.permutation", ()), (2 ** 40 + 5, 11, "loader.shuffle", ()),
    (-3, 1, "x", (5, "rg", b"\x00\x01")), (1, 2, "worker.decode_roi", (17, 0)),
    (True, 0, "", ()), (np.int64(9), np.int32(4), "plan.drop-shuffle", ("é",)),
])
def test_seed_stream_bit_identical(seed, epoch, domain, extra):
    assert torch_seeding.derive_seed(seed, epoch, domain, *extra) == \
        jax_seeding.derive_seed(seed, epoch, domain, *extra)
    a = torch_seeding.seed_stream(seed, epoch, domain, *extra)
    b = jax_seeding.seed_stream(seed, epoch, domain, *extra)
    np.testing.assert_array_equal(a.permutation(50), b.permutation(50))
    np.testing.assert_array_equal(a.integers(0, 2 ** 31, 10), b.integers(0, 2 ** 31, 10))


def test_seed_stream_refuses_like_jax():
    for mod in (torch_seeding, jax_seeding):
        with pytest.raises(Exception, match="int, str or bytes"):
            mod.derive_seed(0, 0, "d", 1.5)


@pytest.mark.parametrize("n,seed,shard", [(10, 0, None), (33, 4, (1, 3)), (5, 9, (4, 5)),
                                          (16, None, (0, 2))])
def test_plan_order_identical(n, seed, shard):
    rgs_t = [torch_metadata.RowGroupRef(f"f{i // 4}", i % 4, 3, i) for i in range(n)]
    rgs_j = [jax_metadata.RowGroupRef(f"f{i // 4}", i % 4, 3, i) for i in range(n)]
    kw = dict(shuffle_seed=seed)
    if shard:
        kw.update(shard_index=shard[0], shard_count=shard[1])
    tp, jp = torch_plan.ReadPlan(rgs_t, **kw), jax_plan.ReadPlan(rgs_j, **kw)
    for epoch in range(3):
        assert [w.row_group.global_index for w in tp.epoch_items(epoch)] == \
            [w.row_group.global_index for w in jp.epoch_items(epoch)]


def test_too_many_shards_refused_like_jax():
    rgs = [torch_metadata.RowGroupRef("f", i, 1, i) for i in range(2)]
    with pytest.raises(NoDataAvailableError):
        torch_plan.ReadPlan(rgs, shard_index=0, shard_count=3)


@pytest.mark.parametrize("dtype,want", [
    ("uint8", "uint8"), ("uint16", "int32"), ("uint32", "int64"), ("uint64", "int64"),
    ("int64", "int64"), ("float64", "float64"), ("float16", "float16"), ("bool", "bool")])
def test_torch_feed_dtype_follows_torch_loader(dtype, want):
    assert torch_dtypes.torch_feed_dtype(dtype) == np.dtype(want)
    # the JAX package's own torch loader promotes the same way
    from petastorm_tpu.pytorch import _sanitize_column

    assert _sanitize_column("x", np.zeros(1, dtype)).dtype == np.dtype(want)


@pytest.mark.parametrize("dtype", ["U4", "S3", "O", "datetime64[ns]"])
def test_torch_feed_dtype_refuses_like_jax_feed(dtype):
    with pytest.raises(SchemaError):
        torch_dtypes.torch_feed_dtype(dtype)
    with pytest.raises(Exception):
        jax_dtypes.jax_feed_dtype(dtype)


def test_writer_refuses_existing_data(dataset):
    with pytest.raises(SchemaError):
        torch_write_dataset(dataset, _schema(torch_schema, torch_codecs), _rows(1)[:3])


def test_thread_pool_stress_exactly_once(tmp_path):
    """More workers than cores and a short switch interval: every row of every
    epoch arrives exactly once, in plan order."""
    schema = torch_schema.Schema("S", [torch_schema.Field("label", np.int64)])
    path = str(tmp_path / "ds")
    torch_write_dataset(path, schema, [{"label": i} for i in range(400)], row_group_size_rows=3)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        result = {}

        def run():
            result["thread"] = _read_rows(torch_reader, path, reader_pool_type="thread",
                                          workers_count=16, results_queue_size=2,
                                          shuffle_seed=1, num_epochs=3)

        t = threading.Thread(target=run, daemon=True)
        t.start()
        t.join(timeout=120)
        assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    serial = _read_rows(torch_reader, path, reader_pool_type="serial", shuffle_seed=1,
                        num_epochs=3)
    assert [r["label"] for r in result["thread"]] == [r["label"] for r in serial]
    assert sorted(r["label"] for r in serial) == sorted(list(range(400)) * 3)


def test_worker_failure_reaches_consumer(tmp_path):
    schema = torch_schema.Schema("S", [torch_schema.Field("label", np.int64)])
    path = str(tmp_path / "ds")
    torch_write_dataset(path, schema, [{"label": i} for i in range(20)], row_group_size_rows=5)
    reader = torch_reader.make_reader(path, reader_pool_type="thread", num_epochs=1)
    import os

    for f in torch_metadata.open_dataset(path).files:
        with open(f, "r+b") as fh:  # corrupt every data page
            fh.seek(4)
            fh.write(b"\xff" * (os.path.getsize(f) - 12))
    with reader, pytest.raises(Exception):
        list(reader)


def test_reader_stop_ends_loader_cleanly(dataset):
    reader = torch_reader.make_reader(dataset, reader_pool_type="thread", num_epochs=None,
                                      shuffle_seed=0)
    loader = CudaDataLoader(reader, batch_size=8, device="cpu")
    batches = [next(iter(loader)) for _ in range(5)]
    assert all(b["label"].shape == (8,) and b["label"].dtype == torch.int64 for b in batches)
    loader.stop()
    assert not loader._thread.is_alive()
