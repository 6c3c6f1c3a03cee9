"""``CudaDataLoader(device="cpu")`` against ``JaxDataLoader`` on one CPU device.

Both loaders read the same dataset with the serial pool and the same seeds,
so the rowgroups arrive in the same order and the shuffling buffers draw the
same rows: labels, vectors, padded fields, host fields and transformed
columns are equal batch for batch.  Images decoded on the device are held to
the 1-LSB bound of ``test_torch_jpeg.py``.  The mesh-only features of the
JAX loader (the zero-padded tail and ``valid_mask_field``) are compared with
its mesh form on a one-device CPU mesh.  The rest checks what only the port
has: its dtype default, its two producer threads, and their errors and stop.
"""

import threading

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from petastorm_tpu.jax import JaxDataLoader
from petastorm_tpu.reader import make_reader as jax_make_reader

from petastorm_tpu_torch import CompressedImageCodec, Field, NdarrayCodec, Schema, make_reader, \
    write_dataset
from petastorm_tpu_torch.batch import ColumnBatch
from petastorm_tpu_torch.cuda.loader import VALID_ROWS, CudaDataLoader
from petastorm_tpu_torch.errors import CodecError, PetastormTpuError, SchemaError

from test_torch_jpeg import _assert_bytes_close, _bufs, _smooth, _write_raw

N_ROWS, GROUP, BATCH = 46, 6, 8


def _rows():
    for i in range(N_ROWS):
        yield {"label": i, "vec": np.arange(4, dtype=np.float32) * i - 3,
               "f64": i * 0.25, "u16": 60000 + i, "name": f"row{i}",
               "var": np.full(((i // 8) % 4 + 1, 3), i, np.float32)}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("loader") / "ds")
    schema = Schema("Loader", [
        Field("label", np.int64), Field("vec", np.float32, (4,), NdarrayCodec()),
        Field("f64", np.float64), Field("u16", np.uint16), Field("name", np.dtype("object")),
        Field("var", np.float32, (None, 3), NdarrayCodec())])
    write_dataset(path, schema, list(_rows()), row_group_size_rows=GROUP)
    return path


@pytest.fixture(scope="module")
def bucket_dataset(tmp_path_factory):
    """Rowgroups of one batch each, so that every batch read in order takes
    the bucket of its own rowgroup (in both packages a batch spanning two
    buckets cannot be concatenated)."""
    path = str(tmp_path_factory.mktemp("buckets") / "ds")
    schema = Schema("Buckets", [Field("label", np.int64),
                                Field("var", np.float32, (None, 3), NdarrayCodec())])
    write_dataset(path, schema, [{"label": r["label"], "var": r["var"]} for r in _rows()],
                  row_group_size_rows=BATCH)
    return path


@pytest.fixture(scope="module")
def jpeg_dataset(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("loader_jpeg") / "ds")
    schema = Schema("Jpeg", [Field("label", np.int64),
                             Field("image", np.uint8, (21, 30, 3),
                                   CompressedImageCodec("jpeg", quality=90))])
    write_dataset(path, schema, [{"label": i, "image": _smooth(21, 30, i)}
                                 for i in range(N_ROWS)], row_group_size_rows=GROUP)
    return path


def _numpy(value):
    return value.numpy() if isinstance(value, torch.Tensor) else np.asarray(value)


def _port(path, reader_kwargs=None, **kwargs):
    reader = make_reader(path, reader_pool_type="serial", num_epochs=1,
                         **({"shuffle_seed": 3} | (reader_kwargs or {})))
    with CudaDataLoader(reader, BATCH, device="cpu", **kwargs) as loader:
        return [{k: (v if k == VALID_ROWS else _numpy(v)) for k, v in b.items()}
                for b in loader]


def _jax(path, reader_kwargs=None, mesh=False, **kwargs):
    reader = jax_make_reader(path, reader_pool_type="serial", num_epochs=1,
                             **({"shuffle_seed": 3} | (reader_kwargs or {})))
    if mesh:
        kwargs.update(mesh=Mesh(np.asarray(jax.devices()[:1]), ("data",)),
                      shardings=P("data"))
    with JaxDataLoader(reader, batch_size=BATCH, **kwargs) as loader:
        return [{k: (v if k == VALID_ROWS else np.asarray(v)) for k, v in b.items()}
                for b in loader]


def _assert_equal_batches(got, want, keys):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for k in keys:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


# -- exact against JaxDataLoader ---------------------------------------------------


@pytest.mark.parametrize("capacity,min_after,seed", [(16, None, 0), (20, 4, 7), (9, 0, 3),
                                                     (48, 40, 11)])
def test_shuffle_with_buffer_seed_equals_jax(dataset, capacity, min_after, seed):
    kwargs = dict(fields=["label", "vec", "f64", "u16"], shuffling_queue_capacity=capacity,
                  min_after_retrieve=min_after, buffer_seed=seed, straggler_release_s=None)
    got, want = _port(dataset, **kwargs), _jax(dataset, **kwargs)
    _assert_equal_batches(got, want, ["label", "vec", "f64", "u16"])
    labels = np.concatenate([g["label"] for g in got])
    assert labels.tolist() != sorted(labels.tolist())


@pytest.mark.parametrize("shuffle_seed", [0, 5])
def test_shuffle_with_seed_derived_from_the_reader_equals_jax(dataset, shuffle_seed):
    """No buffer_seed: both derive it from the reader's root under
    deterministic='seed' (domain "loader.shuffle_buffer")."""
    kwargs = dict(fields=["label", "vec"], shuffling_queue_capacity=16)
    reader_kwargs = {"shuffle_seed": shuffle_seed, "deterministic": "seed"}
    got = _port(dataset, reader_kwargs, **kwargs)
    want = _jax(dataset, reader_kwargs, **kwargs)
    _assert_equal_batches(got, want, ["label", "vec"])
    again = _port(dataset, reader_kwargs, **kwargs)
    _assert_equal_batches(again, got, ["label", "vec"])


def test_device_decode_shuffle_matches_jax(jpeg_dataset):
    """The coefficient planes ride the buffer with the labels: labels exact,
    images within 1 LSB of the JAX package's decode."""
    kwargs = dict(shuffling_queue_capacity=24, buffer_seed=2)
    reader_kwargs = {"decode_placement": {"image": "device"}}
    got = _port(jpeg_dataset, reader_kwargs, **kwargs)
    want = _jax(jpeg_dataset, reader_kwargs, **kwargs)
    assert len(got) == len(want) == N_ROWS // BATCH
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["label"], w["label"])
        assert g["image"].dtype == np.uint8 and g["image"].shape == (BATCH, 21, 30, 3)
        _assert_bytes_close(g["image"], w["image"])
    host = _port(jpeg_dataset, {"decode_placement": {"image": "host"}}, **kwargs)
    for g, h in zip(got, host):  # the same rows as the host route, in the same order
        np.testing.assert_array_equal(g["label"], h["label"])
        diff = np.abs(g["image"].astype(int) - h["image"].astype(int))
        assert diff.max() <= 6 and diff.mean() < 1.0


def test_pad_shapes_single_target_equals_jax(dataset):
    kwargs = dict(fields=["label", "var"], pad_shapes={"var": (3, 3)}, pad_values=-1.5,
                  shuffling_queue_capacity=16, buffer_seed=1, straggler_release_s=None)
    got, want = _port(dataset, **kwargs), _jax(dataset, **kwargs)
    _assert_equal_batches(got, want, ["label", "var"])
    for g in got:
        assert g["var"].shape == (BATCH, 3, 3) and g["var"].dtype == np.float32
        for label, row in zip(g["label"], g["var"]):
            n = min((label // 8) % 4 + 1, 3)  # the written rows, clipped at 3
            assert (row[:n] == label).all() and (row[n:] == -1.5).all()


def test_pad_shapes_buckets_equal_jax(bucket_dataset):
    buckets = [(8, 3), (2, 3), (4, 3)]
    kwargs = dict(pad_shapes={"var": buckets}, pad_values={"var": 7.0})
    in_order = {"shuffle_row_groups": False}  # the short last rowgroup stays the tail
    got = _port(bucket_dataset, in_order, **kwargs)
    want = _jax(bucket_dataset, in_order, **kwargs)
    _assert_equal_batches(got, want, ["label", "var"])
    for g in got:
        rows = (g["label"][0] // 8) % 4 + 1
        assert g["var"].shape == (BATCH, 2 if rows <= 2 else 4, 3)  # the smallest that fits
        assert (g["var"][:, rows:] == 7.0).all()
    assert {g["var"].shape[1] for g in got} == {2, 4}


@pytest.mark.parametrize("capacity", [0, 16], ids=["in-order", "shuffled"])
def test_host_fields_equal_jax(dataset, capacity):
    kwargs = dict(fields=["label"], host_fields=["name"], shuffling_queue_capacity=capacity,
                  buffer_seed=4, straggler_release_s=None)
    got, want = _port(dataset, **kwargs), _jax(dataset, **kwargs)
    _assert_equal_batches(got, want, ["label", "name"])
    for g in got:
        assert isinstance(g["name"], np.ndarray) and g["name"].dtype == object
        assert g["name"].tolist() == [f"row{i}" for i in g["label"]]


def _transform(cols):
    return {"label": cols["label"] * 2, "vec_sum": cols["vec"].sum(axis=1),
            "scaled": (cols["vec"] * 0.5).astype(np.float32)}


@pytest.mark.parametrize("capacity", [0, 16], ids=["in-order", "shuffled"])
def test_transform_fn_equals_jax(dataset, capacity):
    kwargs = dict(fields=["label", "vec"], transform_fn=_transform,
                  shuffling_queue_capacity=capacity, buffer_seed=6, straggler_release_s=None)
    got, want = _port(dataset, **kwargs), _jax(dataset, **kwargs)
    _assert_equal_batches(got, want, ["label", "vec_sum", "scaled"])
    assert set(got[0]) == {"label", "vec_sum", "scaled"}


@pytest.mark.parametrize("capacity", [0, 16], ids=["in-order", "shuffled"])
def test_valid_mask_and_padded_tail_equal_jax_mesh_form(dataset, capacity):
    """The port pads the tail without a mesh; the JAX loader does so with one."""
    kwargs = dict(fields=["label", "vec"], drop_last=False, valid_mask_field="mask",
                  shuffling_queue_capacity=capacity, buffer_seed=8, straggler_release_s=None)
    reader_kwargs = {"schema_fields": ["label", "vec"]}
    got = _port(dataset, reader_kwargs, **kwargs)
    want = _jax(dataset, reader_kwargs, mesh=True, **kwargs)
    _assert_equal_batches(got, want, ["label", "vec", "mask"])
    assert [g.get(VALID_ROWS) for g in got] == [w.get(VALID_ROWS) for w in want]
    tail = got[-1]
    valid = N_ROWS % BATCH
    assert tail["mask"].dtype == np.float32
    assert (tail["mask"][:valid] == 1).all() and not tail["mask"][valid:].any()
    assert not tail["label"][valid:].any()


# -- what only the port has -----------------------------------------------------------


@pytest.mark.parametrize("keep_wide", [True, False], ids=["wide", "jax-feed"])
def test_keep_wide_dtypes(dataset, keep_wide):
    """The port keeps 64-bit types by default (torch has them, and
    cross-entropy wants int64 labels); ``keep_wide_dtypes=False`` narrows
    them as the JAX package's feed table does."""
    (first, *_) = _port(dataset, fields=["label", "f64", "u16", "vec"],
                        keep_wide_dtypes=keep_wide)
    want = ({"label": np.int64, "f64": np.float64} if keep_wide
            else {"label": np.int32, "f64": np.float32})
    assert first["label"].dtype == want["label"] and first["f64"].dtype == want["f64"]
    assert first["u16"].dtype == np.int32 and first["vec"].dtype == np.float32
    assert first["u16"].tolist() == [60000 + i for i in first["label"]]
    jax_first = _jax(dataset, fields=["label", "f64", "u16"])[0]
    if not keep_wide:
        for k in ("label", "f64", "u16"):
            assert first[k].dtype == jax_first[k].dtype, k


@pytest.mark.parametrize("drop_last", [True, False])
def test_drop_last_under_shuffle(dataset, drop_last):
    got = _port(dataset, fields=["label"], shuffling_queue_capacity=16, buffer_seed=0,
                drop_last=drop_last)
    labels = [g["label"][:g.get(VALID_ROWS, BATCH)] for g in got]
    assert all(len(g["label"]) == BATCH for g in got)
    if drop_last:
        assert len(got) == N_ROWS // BATCH and VALID_ROWS not in got[-1]
        assert len(set(np.concatenate(labels).tolist())) == N_ROWS // BATCH * BATCH
    else:
        assert len(got) == -(-N_ROWS // BATCH) and got[-1][VALID_ROWS] == N_ROWS % BATCH
        assert sorted(np.concatenate(labels).tolist()) == list(range(N_ROWS))


def _wait_dead(*threads):
    for t in threads:
        t.join(timeout=10)
    return not any(t.is_alive() for t in threads)


def test_assembly_error_reaches_the_consumer_and_stops_everything(dataset):
    def boom(cols):
        raise ValueError("transform failed")

    reader = make_reader(dataset, reader_pool_type="thread", num_epochs=None)
    loader = CudaDataLoader(reader, BATCH, device="cpu", fields=["label"], transform_fn=boom)
    with pytest.raises(ValueError, match="transform failed"):
        next(iter(loader))
    with pytest.raises(ValueError, match="transform failed"):  # latched
        next(loader)
    assert _wait_dead(loader._thread, loader._transfer_thread)
    assert reader._stopped
    loader.stop()


def test_transfer_error_reaches_the_consumer_and_stops_everything(dataset):
    """A column that cannot be staged fails in the transfer thread."""
    reader = make_reader(dataset, reader_pool_type="thread", num_epochs=None)
    loader = CudaDataLoader(reader, BATCH, device="cpu", fields=["label"],
                            transform_fn=lambda c: {"label": c["label"].astype(object)})
    with pytest.raises(SchemaError, match="cannot be fed to a device"):
        next(iter(loader))
    assert _wait_dead(loader._thread, loader._transfer_thread)
    assert reader._stopped
    loader.stop()


def test_stop_ends_both_threads_mid_stream(dataset):
    reader = make_reader(dataset, reader_pool_type="thread", num_epochs=None, shuffle_seed=0)
    loader = CudaDataLoader(reader, BATCH, device="cpu", fields=["label"], prefetch=1,
                            shuffling_queue_capacity=16, buffer_seed=0)
    batches = [next(iter(loader)) for _ in range(3)]
    assert all(b["label"].shape == (BATCH,) for b in batches)
    loader.stop()
    assert not loader._thread.is_alive() and not loader._transfer_thread.is_alive()
    with pytest.raises(StopIteration):
        while True:  # what was queued before the stop, then the end
            next(loader)


def test_stop_iteration_repeats_after_the_end(dataset):
    reader = make_reader(dataset, reader_pool_type="serial", num_epochs=1)
    with CudaDataLoader(reader, BATCH, device="cpu", fields=["label"]) as loader:
        assert len(list(loader)) == N_ROWS // BATCH
        for _ in range(3):
            with pytest.raises(StopIteration):
                next(loader)
        diag = loader.diagnostics()
    assert diag["batches_delivered"] == N_ROWS // BATCH
    assert diag["prefetch_capacity"] == 2 and diag["prefetch_depth"] == 0
    assert diag["host_queue_depth"] == 0 and diag["straggler_releases"] == 0
    assert diag["assemble_s"] > 0 and diag["transfer_s"] > 0


class _BlockingReader:
    """Two rowgroups of 6 rows, then blocked until ``release`` is set, then
    one more: a straggling source driven by an event, not by a clock race."""

    deterministic = "off"
    device_decode_fields = ()

    def __init__(self):
        self.schema = Schema("S", [Field("x", np.int64)])
        self.release = threading.Event()

    def iter_batches(self):
        for start in (0, 6):
            yield ColumnBatch({"x": np.arange(start, start + 6)}, 6)
        self.release.wait()
        yield ColumnBatch({"x": np.arange(12, 18)}, 6)

    def stop(self):
        self.release.set()

    def join(self):
        pass


def test_straggler_release_through_the_loader():
    """12 rows buffered: one batch of 4 clears the floor of 8; the second is
    released while the source is still blocked."""
    reader = _BlockingReader()
    watchdog = threading.Timer(30.0, reader.release.set)  # never hang the run
    watchdog.start()
    try:
        with CudaDataLoader(reader, 4, device="cpu", shuffling_queue_capacity=16,
                            min_after_retrieve=8, buffer_seed=0,
                            straggler_release_s=0.05) as loader:
            it = iter(loader)
            first = next(it)
            second = next(it)
            released_while_blocked = not reader.release.is_set()
            assert loader.diagnostics()["straggler_releases"] >= 1
            reader.release.set()
            rest = list(it)
    finally:
        watchdog.cancel()
    assert released_while_blocked
    rows = torch.cat([first["x"], second["x"]] + [b["x"][:b.get(VALID_ROWS, 4)]
                                                  for b in rest])
    # 18 rows in 4 full batches: the short tail of 2 is dropped
    assert len(rows) == 16 and set(rows.tolist()) < set(range(18))


def test_straggler_release_auto(dataset):
    def straggler(**kwargs):
        reader = make_reader(dataset, reader_pool_type="serial", num_epochs=1,
                             **({"deterministic": "off"} | kwargs.pop("reader", {})))
        with CudaDataLoader(reader, BATCH, device="cpu", fields=["label"], **kwargs) as ld:
            return ld._straggler_s

    assert straggler(shuffling_queue_capacity=16) == 2.0
    assert straggler(shuffling_queue_capacity=16, min_after_retrieve=0) is None
    assert straggler() is None
    assert straggler(shuffling_queue_capacity=16, straggler_release_s=0.5) == 0.5
    # a timing-driven release would break seed-stable batches
    assert straggler(shuffling_queue_capacity=16, reader={"shuffle_seed": 1,
                                                          "deterministic": "seed"}) is None


def test_mixed_geometry_under_shuffle_raises_the_guidance(tmp_path):
    path = _write_raw(tmp_path, _bufs("420", 4) + _bufs("444", 4), rows_per_group=4)
    reader = make_reader(path, num_epochs=1, shuffle_row_groups=False,
                         decode_placement={"image": "device"})
    with CudaDataLoader(reader, 2, device="cpu", shuffling_queue_capacity=8,
                        buffer_seed=0) as loader:
        with pytest.raises(CodecError, match="changes between rowgroups.*decode_placement="
                                             "'host'"):
            list(loader)


def test_constructor_refusals(dataset, jpeg_dataset):
    def build(path=dataset, **kwargs):
        reader = make_reader(path, reader_pool_type="serial", num_epochs=1,
                             **kwargs.pop("reader", {}))
        try:
            CudaDataLoader(reader, BATCH, **({"device": "cpu"} | kwargs)).stop()
        finally:
            reader.stop()

    with pytest.raises(PetastormTpuError, match="Unknown fields"):
        build(fields=["nope"])
    with pytest.raises(PetastormTpuError, match="cannot be fed to a device"):
        build(fields=["name"])
    with pytest.raises(PetastormTpuError, match="pad_shapes entry"):
        build(fields=["var"])
    with pytest.raises(PetastormTpuError, match="collides with a schema field"):
        build(fields=["label"], valid_mask_field="vec")
    with pytest.raises(PetastormTpuError, match="reserved"):
        build(fields=["label"], valid_mask_field=VALID_ROWS)
    with pytest.raises(PetastormTpuError, match="at least one"):
        build(fields=[], host_fields=["name"])
    with pytest.raises(PetastormTpuError, match="share one rank"):
        build(fields=["var"], pad_shapes={"var": [(2, 3), (4,)]})
    with pytest.raises(PetastormTpuError, match="cannot be delivered host-side"):
        build(jpeg_dataset, host_fields=["image"], reader={"decode_placement": {"image":
                                                                                "device"}})
    with pytest.raises(PetastormTpuError, match="prefetch"):
        build(fields=["label"], prefetch=0)
    if not torch.cuda.is_available():  # no CPU fallback
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            build(fields=["label"], device="cuda")


def test_transform_minting_the_mask_name_is_refused(dataset):
    with pytest.raises(PetastormTpuError, match="collides with valid_mask_field"):
        _port(dataset, fields=["label"], valid_mask_field="mask",
              transform_fn=lambda c: {"label": c["label"], "mask": c["label"]})
