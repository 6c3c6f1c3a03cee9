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


# -- selection and transforms: predicate, rowgroup selector, row-drop
# partitions, shard_mode='epoch', transform_spec ---------------------------

import shutil  # noqa: E402

import petastorm_tpu.predicates as jax_predicates  # noqa: E402
import petastorm_tpu.selectors as jax_selectors  # noqa: E402
import petastorm_tpu.transform as jax_transform  # noqa: E402
from petastorm_tpu.errors import PetastormTpuError as JaxPetastormTpuError  # noqa: E402

import petastorm_tpu_torch.predicates as torch_predicates  # noqa: E402
import petastorm_tpu_torch.selectors as torch_selectors  # noqa: E402
import petastorm_tpu_torch.transform as torch_transform  # noqa: E402
from petastorm_tpu_torch.errors import PetastormTpuError  # noqa: E402
from petastorm_tpu_torch.etl.indexing import SingleFieldIndexer, build_rowgroup_index  # noqa: E402

JAX_SELECTION = (jax_reader, jax_predicates, jax_selectors, jax_transform)
PORT_SELECTION = (torch_reader, torch_predicates, torch_selectors, torch_transform)
#: labels of rowgroups 1, 4 and 8 (rows of 7): the selector's choice
SELECTED_LABELS = [7, 8, 29, 56]


def _not_multiple_of_3(cols):
    return cols["label"] % 3 != 0


def _outside_14_35(cols):
    # rowgroups 2, 3 and 4 (labels 14-34) lose every row
    return (cols["label"] < 14) | (cols["label"] >= 35)


def _only_rowgroup_6(cols):
    return (cols["label"] >= 42) & (cols["label"] < 49)


def _bright(cols):
    return cols["jpeg"].reshape(len(cols["jpeg"]), -1).mean(1) > 127.5


def _sum_and_drop(cols):
    out = dict(cols)
    out["jsum"] = cols["jpeg"].reshape(len(cols["jpeg"]), -1).sum(1).astype(np.int64)
    out["label"] = cols["label"] * 10
    return out


def _predicate(mods, kind):
    p = mods[1]
    if kind == "lambda":
        return p.in_lambda(["label"], _not_multiple_of_3, vectorized=True)
    if kind == "empties":
        return p.in_lambda(["label"], _outside_14_35, vectorized=True)
    if kind == "split":
        return p.in_pseudorandom_split([0.6, 0.4], 0, "label")
    if kind == "bright":
        return p.in_lambda(["jpeg"], _bright, vectorized=True)
    if kind == "reduce":
        return p.in_reduce([p.in_lambda(["label"], _not_multiple_of_3, vectorized=True),
                            p.in_set(list(range(0, 60, 2)), "label")], np.any)
    raise AssertionError(kind)


def _transform(mods):
    return mods[3].TransformSpec(_sum_and_drop, edit_fields=[("jsum", np.int64, (), False)],
                                 removed_fields=["png", "gray"])


@pytest.fixture(scope="module")
def indexed(dataset, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("indexed") / "ds")
    shutil.copytree(dataset, path)
    build_rowgroup_index(path, [SingleFieldIndexer("label_ix", "label")])
    return path


def _selection_kwargs(mods, case):
    kw = dict(reader_pool_type="serial", shuffle_seed=5, num_epochs=2)
    parts = case.split("+")
    for part in parts:
        if part in ("lambda", "empties", "split", "bright", "reduce"):
            kw["predicate"] = _predicate(mods, part)
        elif part == "selector":
            kw["rowgroup_selector"] = mods[2].SingleIndexSelector("label_ix", SELECTED_LABELS)
        elif part.startswith("drop"):
            kw["shuffle_row_drop_partitions"] = int(part[4:])
        elif part == "epoch":
            kw.update(shard_mode="epoch", cur_shard=1, shard_count=2)
        elif part == "transform":
            kw["transform_spec"] = _transform(mods)
        elif part == "roi":
            kw["decode_roi"] = {"jpeg": ("random", 8, 12)}
        elif part == "noshuffle":
            kw["shuffle_row_groups"] = False
        else:
            raise AssertionError(part)
    return kw


def _run_rows(mods, path, **kw):
    with mods[0].make_reader(path, **kw) as reader:
        rows = [row._asdict() for row in reader]
        return rows, reader.stream_digest, reader.state_dict(), list(reader.schema.fields)


SELECTION_CASES = ["lambda", "empties", "split", "selector", "drop2", "drop3+noshuffle",
                   "epoch", "transform", "roi+drop2+lambda", "epoch+drop2",
                   "selector+lambda+drop2+transform",
                   "selector+empties+drop3+epoch+transform", "reduce+transform+roi",
                   "bright+roi+drop2", "bright+transform"]


@pytest.mark.parametrize("case", SELECTION_CASES)
def test_selection_rows_digest_and_cursor_equal_jax(indexed, case):
    want = _run_rows(JAX_SELECTION, indexed, **_selection_kwargs(JAX_SELECTION, case))
    got = _run_rows(PORT_SELECTION, indexed, **_selection_kwargs(PORT_SELECTION, case))
    _assert_rows_equal(got[0], want[0])
    assert got[1] == want[1]  # stream digest
    assert got[2] == want[2]  # cursor
    assert got[3] == want[3]  # the output schema's fields
    assert len(got[0]) > 0


def test_selection_cases_select(indexed):
    """What each knob does, on the port alone."""
    def labels(case):
        rows = _run_rows(PORT_SELECTION, indexed, **_selection_kwargs(PORT_SELECTION, case))[0]
        return [int(r["label"]) for r in rows]
    assert sorted(set(labels("lambda"))) == [i for i in range(N_ROWS) if i % 3]
    assert not set(labels("empties")) & set(range(14, 35))
    assert sorted(set(labels("selector"))) == [i for i in range(N_ROWS)
                                               if i // 7 in (1, 4, 8)]
    assert sorted(labels("drop2")) == sorted(list(range(N_ROWS)) * 2)
    assert {v // 10 for v in labels("transform")} == set(range(N_ROWS))


@pytest.mark.parametrize("batched", [False, True], ids=["rows", "batches"])
def test_empty_rowgroups_counted_never_delivered(indexed, batched):
    """Rowgroups the predicate empties advance the cursor and the digest and
    deliver nothing, on both iteration paths."""
    kw = _selection_kwargs(PORT_SELECTION, "empties")
    kw["num_epochs"] = 1
    if batched:
        with torch_reader.make_batch_reader(indexed, **kw) as r:
            sizes = [len(b.label) for b in r]
            state, digest = r.state_dict(), r.stream_digest
        kw_j = _selection_kwargs(JAX_SELECTION, "empties")
        kw_j["num_epochs"] = 1
        with jax_reader.make_batch_reader(indexed, **kw_j) as r:
            assert sizes == [len(b.label) for b in r]
            assert (state, digest) == (r.state_dict(), r.stream_digest)
        assert 0 not in sizes and len(sizes) == 6
    else:
        rows, digest, state, _ = _run_rows(PORT_SELECTION, indexed, **kw)
        assert len(rows) == N_ROWS - 21
    assert state["position"] == 9 and digest["batches"] == 9


def test_predicate_decodes_only_surviving_rows(indexed):
    """The split read: the masked rows reach no image decode, on the host
    route (batched native decode) and on the hybrid route (entropy decode)."""
    kw = dict(reader_pool_type="serial", shuffle_seed=5, num_epochs=1)
    with torch_reader.make_reader(indexed, **kw) as r:
        list(r)
        full = r.decode_stats()["batch_images"]
    kw["predicate"] = _predicate(PORT_SELECTION, "empties")
    with torch_reader.make_reader(indexed, **kw) as r:
        survivors = len(list(r))
        assert r.decode_stats()["batch_images"] * N_ROWS == full * survivors
    kw["predicate"] = _predicate(PORT_SELECTION, "lambda")
    with torch_reader.make_batch_reader(indexed, decode_placement={"jpeg": "device"},
                                        **kw) as r:
        survivors = sum(b.num_rows for b in r.iter_batches())
        assert r.decode_stats()["coef_batch_images"] == survivors == N_ROWS - 20


def test_roi_crops_follow_the_slice_and_the_mask(indexed):
    """'random' crops are drawn for the rows after the mask, from the item's
    slice start: equal to the JAX reader's and to slices of a full decode."""
    kw = _selection_kwargs(PORT_SELECTION, "roi+drop2+lambda")
    rows = _run_rows(PORT_SELECTION, indexed, **kw)[0]
    kw.pop("decode_roi")
    full = {int(r["label"]): r["jpeg"] for r in _run_rows(PORT_SELECTION, indexed, **kw)[0]}
    for r in rows:
        img = full[int(r["label"])]
        hits = [(y, x) for y in range(16 - 8 + 1) for x in range(24 - 12 + 1)
                if np.array_equal(img[y:y + 8, x:x + 12], r["jpeg"])]
        assert hits, int(r["label"])
    offsets = {tuple(np.asarray(r["jpeg"]).ravel()[:4]) for r in rows}
    assert len(offsets) > 1


@pytest.mark.parametrize("take", [3, 10])
def test_resume_mid_epoch_under_drop_partitions_equals_jax(indexed, take):
    kw_p = _selection_kwargs(PORT_SELECTION, "lambda+drop3")
    kw_j = _selection_kwargs(JAX_SELECTION, "lambda+drop3")
    states = []
    for mods, kw in ((PORT_SELECTION, kw_p), (JAX_SELECTION, kw_j)):
        with mods[0].make_batch_reader(indexed, **kw) as r:
            it = r.iter_batches()
            head = [next(it).columns["label"].tolist() for _ in range(take)]
            states.append((head, r.state_dict()))
    assert states[0] == states[1]
    state = states[0][1]
    runs = []
    for mods, kw in ((PORT_SELECTION, kw_p), (JAX_SELECTION, kw_j)):
        with mods[0].make_batch_reader(indexed, resume_from=state, **kw) as r:
            runs.append(([b.columns["label"].tolist() for b in r.iter_batches()],
                         r.state_dict(), r.stream_digest))
    assert runs[0] == runs[1]
    with torch_reader.make_batch_reader(indexed, **kw_p) as r:
        whole = [b.columns["label"].tolist() for b in r.iter_batches()]
        assert states[0][0] + runs[0][0] == whole
        assert r.stream_digest == runs[0][2]


def test_elastic_resume_under_epoch_mode_equals_jax(indexed):
    def kwargs(mods, shard, count, **extra):
        kw = _selection_kwargs(mods, "drop2")
        kw.update(shard_mode="epoch", cur_shard=shard, shard_count=count, num_epochs=2, **extra)
        return kw

    results = []
    for mods in (PORT_SELECTION, JAX_SELECTION):
        states = []
        for shard, take in ((0, 4), (1, 6)):
            with mods[0].make_batch_reader(indexed, **kwargs(mods, shard, 2)) as r:
                it = r.iter_batches()
                for _ in range(take):
                    next(it)
                states.append(r.state_dict())
        token = mods[0].elastic_resume(states)
        per_shard = []
        for shard in range(3):
            with mods[0].make_batch_reader(indexed, **kwargs(mods, shard, 3,
                                                             resume_from=token)) as r:
                per_shard.append(([b.columns["label"].tolist() for b in r.iter_batches()],
                                  r.state_dict(), r.stream_digest))
        results.append(per_shard)
    assert results[0] == results[1]


@pytest.mark.parametrize("refusal", ["cache+predicate", "device+transform",
                                     "device+predicate", "drop0", "shard_mode",
                                     "selector_none"])
def test_selection_refusals_equal_jax(indexed, refusal):
    def kwargs(mods):
        kw = dict(reader_pool_type="serial", shuffle_seed=1)
        if refusal == "cache+predicate":
            kw.update(cache_type="memory", predicate=_predicate(mods, "lambda"))
        elif refusal == "device+transform":
            kw.update(decode_placement={"jpeg": "device"}, transform_spec=_transform(mods))
        elif refusal == "device+predicate":
            kw.update(decode_placement={"jpeg": "device"},
                      predicate=mods[1].in_lambda(["jpeg"], _not_multiple_of_3))
        elif refusal == "drop0":
            kw.update(shuffle_row_drop_partitions=0)
        elif refusal == "shard_mode":
            kw.update(shard_mode="global")
        else:
            kw.update(rowgroup_selector=mods[2].SingleIndexSelector("label_ix", [999]))
        return kw
    with pytest.raises(JaxPetastormTpuError) as want:
        jax_reader.make_reader(indexed, **kwargs(JAX_SELECTION))
    with pytest.raises(PetastormTpuError) as got:
        torch_reader.make_reader(indexed, **kwargs(PORT_SELECTION))
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("cache_type", ["memory", "local-disk"])
def test_cached_transform_output_skips_decode_and_transform(indexed, tmp_path, cache_type):
    """A deterministic transform's output is cached: the later epochs decode
    and transform nothing, and the rows equal the JAX reader's."""
    calls = []

    def counting(cols):
        calls.append(len(cols["label"]))
        return _sum_and_drop(cols)

    kw = dict(reader_pool_type="serial", shuffle_seed=5, num_epochs=3, cache_type=cache_type,
              cache_location=str(tmp_path / "cache"))
    spec = torch_transform.TransformSpec(_sum_and_drop, edit_fields=[("jsum", np.int64, (),
                                                                       False)],
                                         removed_fields=["png", "gray"])
    with torch_reader.make_reader(indexed, transform_spec=spec, **kw) as r:
        rows = [row._asdict() for row in r]
        stats, decoded = r.cache_stats(), r.decode_stats()
    groups = -(-N_ROWS // ROWS_PER_GROUP)
    assert (stats["transform_misses"], stats["transform_hits"]) == (groups, 2 * groups)
    assert (stats["misses"], stats["hits"]) == (groups, 2 * groups)
    with torch_reader.make_reader(indexed, **dict(kw, num_epochs=1, cache_type="null")) as r:
        list(r)
        assert decoded == r.decode_stats()  # one epoch's decode
    want = _run_rows(JAX_SELECTION, indexed, transform_spec=_transform(JAX_SELECTION),
                     **dict(kw, cache_location=str(tmp_path / "jax_cache")))[0]
    _assert_rows_equal(rows, want)
    # the counting transform closes over a list: its output is never cached,
    # so it runs every epoch on the cached decode
    spec = torch_transform.TransformSpec(counting, edit_fields=[("jsum", np.int64, (), False)],
                                         removed_fields=["png", "gray"])
    assert not torch_transform.transform_cache_info(spec)[1]
    with torch_reader.make_reader(indexed, transform_spec=spec,
                                  **dict(kw, cache_location=str(tmp_path / "c2"))) as r:
        _assert_rows_equal([row._asdict() for row in r], want)
        stats = r.cache_stats()
    assert len(calls) == 3 * groups
    assert (stats["transform_misses"], stats["transform_hits"]) == (0, 0)
    assert (stats["misses"], stats["hits"]) == (groups, 2 * groups)


def test_no_transform_keeps_cache_stats_keys(indexed):
    with torch_reader.make_reader(indexed, reader_pool_type="serial", cache_type="memory") as r:
        list(r)
        assert set(r.cache_stats()) == {"hits", "misses", "entries", "bytes"}
