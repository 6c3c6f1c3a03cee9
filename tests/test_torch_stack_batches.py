"""``CudaDataLoader(stack_batches=K, device="cpu")`` against ``JaxDataLoader(stack_batches=K)``.

Mirrors ``tests/test_stack_batches.py``.  Both loaders read the same dataset
with the serial pool and the same seeds, so the delivered ``(K, B, ...)``
units are equal value for value: the fields, ``'_valid_rows'``, the valid
mask (held against the JAX loader's mesh form on a one-device CPU mesh, the
only form in which it makes one), host fields and ``transform_fn`` output,
under both ``drop_last`` settings.  Images decoded on the device (B2's plain
version here) are held to the JAX ``_decode_stack`` within the 1-LSB bound
of ``test_torch_jpeg.py``.
"""

import collections

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from petastorm_tpu.errors import PetastormTpuError as JaxPetastormTpuError
from petastorm_tpu.jax import JaxDataLoader
from petastorm_tpu.reader import make_reader as jax_make_reader

from petastorm_tpu_torch import CompressedImageCodec, Field, Schema, make_batch_reader, \
    make_reader, write_dataset
from petastorm_tpu_torch.cuda import loader as loader_mod
from petastorm_tpu_torch.cuda.loader import VALID_ROWS, CudaDataLoader
from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.native.image import JpegCoefLayout

from test_torch_jpeg import _assert_bytes_close, _smooth

SCHEMA = Schema("Stack", [
    Field("idx", np.int64),
    Field("vec", np.float32, (6,)),
    Field("tag", np.dtype("object")),
])
N_ROWS = 64


@pytest.fixture(scope="module")
def stack_ds(tmp_path_factory):
    url = str(tmp_path_factory.mktemp("stack") / "ds")
    rng = np.random.default_rng(0)
    write_dataset(url, SCHEMA,
                  [{"idx": i, "vec": rng.standard_normal(6).astype(np.float32), "tag": f"t{i}"}
                   for i in range(N_ROWS)], row_group_size_rows=8)
    return url


@pytest.fixture(scope="module")
def jpeg_ds(tmp_path_factory):
    url = str(tmp_path_factory.mktemp("stack_jpeg") / "ds")
    schema = Schema("StackJpeg", [
        Field("idx", np.int64),
        Field("image", np.uint8, (24, 32, 3), CompressedImageCodec("jpeg", quality=92))])
    write_dataset(url, schema, [{"idx": i, "image": _smooth(24, 32, i)} for i in range(32)],
                  row_group_size_rows=8)
    return url


def _values(unit):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in unit.items()}


def _port(url, reader_kwargs=None, **kwargs):
    reader = make_reader(url, reader_pool_type="serial", num_epochs=1,
                         **({"shuffle_row_groups": False} | (reader_kwargs or {})))
    with CudaDataLoader(reader, kwargs.pop("batch_size", 8), device="cpu", **kwargs) as loader:
        units = list(loader)
        return [_values(u) for u in units], loader.diagnostics()


def _jax(url, reader_kwargs=None, mesh=False, **kwargs):
    reader = jax_make_reader(url, reader_pool_type="serial", num_epochs=1,
                             **({"shuffle_row_groups": False} | (reader_kwargs or {})))
    if mesh:
        kwargs.update(mesh=Mesh(np.asarray(jax.devices()[:1]), ("data",)), shardings=P("data"))
    with JaxDataLoader(reader, batch_size=kwargs.pop("batch_size", 8), **kwargs) as loader:
        return [_values(u) for u in loader], loader.diagnostics


def _assert_units_equal(got, want, keys):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (VALID_ROWS in g) == (VALID_ROWS in w)
        for k in keys + ([VALID_ROWS] if VALID_ROWS in w else []):
            assert g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_stack_shapes_and_order_equal_jax(stack_ds):
    kwargs = dict(fields=["idx", "vec"], stack_batches=4)
    reader_kwargs = {"schema_fields": ["idx", "vec"]}
    (got, diag), (want, jax_diag) = _port(stack_ds, reader_kwargs, **kwargs), \
        _jax(stack_ds, reader_kwargs, **kwargs)
    _assert_units_equal(got, want, ["idx", "vec"])
    assert len(got) == 2  # 8 batches of 8 rows -> 2 stacks of 4
    assert got[0]["idx"].shape == (4, 8) and got[0]["vec"].shape == (4, 8, 6)
    assert got[0]["vec"].dtype == np.float32
    flat = np.concatenate([u["idx"].reshape(-1) for u in got])
    assert flat.tolist() == list(range(N_ROWS))  # the stack keeps the feed order
    assert diag["stack_batches"] == jax_diag["stack_batches"] == 4
    assert diag["batches_delivered"] == jax_diag["delivered_batches"] == 2  # units
    assert diag["units_staged"] == 2


@pytest.mark.parametrize("drop_last", [True, False])
def test_stack_drop_last_equal_jax(stack_ds, drop_last):
    # 64 rows / batch 8 = 8 batches; K=3: 2 full stacks and 2 batches left over
    kwargs = dict(fields=["idx"], stack_batches=3, drop_last=drop_last)
    got, _ = _port(stack_ds, {"schema_fields": ["idx"]}, **kwargs)
    want, _ = _jax(stack_ds, {"schema_fields": ["idx"]}, **kwargs)
    _assert_units_equal(got, want, ["idx"])
    if drop_last:
        assert len(got) == 2 and all(VALID_ROWS not in u for u in got)
    else:
        assert len(got) == 3
        tail = got[-1]
        assert tail[VALID_ROWS].tolist() == [8, 8, 0] and tail[VALID_ROWS].dtype == np.int64
        assert tail["idx"][2].tolist() == [0] * 8  # the zero-padded step


@pytest.mark.parametrize("shuffle", [False, True], ids=["in-order", "shuffled"])
def test_stack_valid_mask_and_partial_rows_equal_jax(stack_ds, shuffle):
    # 64 rows / batch 24 -> 2 full + 1 partial (16); K=2: the second stack is
    # [partial(16), missing]
    kwargs = dict(batch_size=24, fields=["idx", "vec"], stack_batches=2, drop_last=False,
                  valid_mask_field="mask")
    reader_kwargs = {"schema_fields": ["idx", "vec"]}
    if shuffle:
        reader_kwargs.update(shuffle_row_groups=True, shuffle_seed=5)
        kwargs.update(shuffling_queue_capacity=48, min_after_retrieve=16, buffer_seed=3)
    got, _ = _port(stack_ds, reader_kwargs, **kwargs)
    want, _ = _jax(stack_ds, reader_kwargs, mesh=True, **kwargs)
    _assert_units_equal(got, want, ["idx", "vec", "mask"])
    tail = got[1]
    assert tail[VALID_ROWS].tolist() == [16, 0]
    assert tail["mask"].shape == (2, 24) and tail["mask"].dtype == np.float32
    assert tail["mask"][0].tolist() == [1.0] * 16 + [0.0] * 8
    assert tail["mask"][1].tolist() == [0.0] * 24
    ids = np.concatenate([u["idx"][u["mask"] > 0] for u in got])
    assert sorted(ids.tolist()) == list(range(N_ROWS))


def test_stack_host_fields_and_transform_equal_jax(stack_ds):
    calls = {"port": [], "jax": []}

    def xform(who):
        def fn(cols):
            calls[who].append(len(cols["idx"]))  # per batch, before stacking
            return {**cols, "idx": cols["idx"] * 2}
        return fn

    reader_kwargs = {"schema_fields": ["idx", "tag"]}
    kwargs = dict(fields=["idx"], host_fields=["tag"], stack_batches=2)
    got, _ = _port(stack_ds, reader_kwargs, transform_fn=xform("port"), **kwargs)
    want, _ = _jax(stack_ds, reader_kwargs, transform_fn=xform("jax"), **kwargs)
    _assert_units_equal(got, want, ["idx", "tag"])
    assert calls["port"] == calls["jax"] == [8] * 8
    u = got[0]
    assert u["tag"].shape == (2, 8) and u["tag"].dtype == object
    assert u["tag"][0, 0] == "t0" and u["tag"][1, 0] == "t8"
    assert u["idx"][0].tolist() == [2 * i for i in range(8)]


def test_stack_host_fields_pad_short_stack_equal_jax(stack_ds):
    # batch 24, K=2, drop_last=False: the tail stack [16 rows, missing]
    reader_kwargs = {"schema_fields": ["idx", "tag"]}
    kwargs = dict(batch_size=24, fields=["idx"], host_fields=["tag"], stack_batches=2,
                  drop_last=False)
    got, _ = _port(stack_ds, reader_kwargs, **kwargs)
    want, _ = _jax(stack_ds, reader_kwargs, **kwargs)
    _assert_units_equal(got, want, ["idx", "tag"])
    assert got[1]["tag"][0, 16:].tolist() == [None] * 8
    assert got[1]["tag"][1].tolist() == [None] * 24


def test_stack_drain_exact_resume(tmp_path):
    """drain()/state_dict() at stack granularity: zero rows re-read, none lost."""
    url = str(tmp_path / "drain_ds")
    rng = np.random.default_rng(1)
    n_rows = 128
    write_dataset(url, SCHEMA,
                  [{"idx": i, "vec": rng.standard_normal(6).astype(np.float32), "tag": f"t{i}"}
                   for i in range(n_rows)], row_group_size_rows=2)

    def rows(unit):
        valid = unit.get(VALID_ROWS, torch.tensor([4, 4])).tolist()
        return [v for k, step in enumerate(unit["idx"].tolist()) for v in step[:valid[k]]]

    seen = []
    with make_batch_reader(url, reader_pool_type="thread", workers_count=2,
                           results_queue_size=2, shuffle_seed=7, num_epochs=1) as r:
        with CudaDataLoader(r, 4, device="cpu", stack_batches=2, fields=["idx", "vec"],
                            drop_last=False) as loader:
            seen.extend(rows(next(iter(loader))))
            for u in loader.drain():
                seen.extend(rows(u))
            state = loader.state_dict()
    assert state["reader"]["ordinal_exact"]
    assert state["stack_batches"] == 2 and state["global_batch"] == 4

    resumed = []
    with make_batch_reader(url, reader_pool_type="thread", workers_count=2, shuffle_seed=7,
                           num_epochs=1, resume_from=state["reader"]) as r:
        with CudaDataLoader(r, 4, device="cpu", stack_batches=2, fields=["idx", "vec"],
                            drop_last=False) as loader:
            for u in loader:
                resumed.extend(rows(u))
    counts = collections.Counter(seen + resumed)
    assert sorted(counts) == list(range(n_rows)), "rows lost"
    assert max(counts.values()) == 1, "rows re-read: cursor was not exact"
    assert resumed, "drain consumed everything; resume proved nothing"


def test_stack_drain_alignment_pads(stack_ds):
    """Short processes pad with zero stacks: '_valid_rows' a (K,) zero tensor,
    an all-zero mask, the last unit's shapes."""
    with make_batch_reader(stack_ds, shuffle_row_groups=False, num_epochs=1,
                           reader_pool_type="serial") as r:
        with CudaDataLoader(r, 16, device="cpu", stack_batches=2, drop_last=False,
                            fields=["idx", "vec"], valid_mask_field="mask") as loader:
            next(iter(loader))
            drained = list(loader.drain(all_gather_counts=lambda mine: [mine, mine + 2]))
    assert len(drained) == 3  # one real stack left, two pads
    for pad in drained[-2:]:
        assert pad[VALID_ROWS].tolist() == [0, 0] and pad[VALID_ROWS].dtype == torch.int64
        assert pad["idx"].shape == (2, 16) and pad["vec"].shape == (2, 16, 6)
        assert pad["mask"].sum() == 0 and pad["vec"].abs().sum() == 0


def test_stack_refusals_carry_the_jax_messages(stack_ds):
    def messages(build):
        try:
            build()
        except (PetastormTpuError, JaxPetastormTpuError) as exc:
            return str(exc)
        raise AssertionError("no refusal")

    bucketed = dict(fields=["vec"], stack_batches=2, pad_shapes={"vec": [(6,), (8,)]})
    with make_reader(stack_ds, schema_fields=["idx", "vec"], reader_pool_type="serial") as r, \
            jax_make_reader(stack_ds, schema_fields=["idx", "vec"],
                            reader_pool_type="serial") as jr:
        for kwargs, match in ((dict(stack_batches=0), "stack_batches must be"),
                              (bucketed, "multi-bucket")):
            got = messages(lambda: CudaDataLoader(r, 8, device="cpu", **kwargs))
            want = messages(lambda: JaxDataLoader(jr, batch_size=8, **kwargs))
            assert got == want and match in got


def test_stack_device_decode_equals_jax_decode_stack(jpeg_ds):
    """decode_placement='device' + stack_batches=2: one (K * B)-image decode a
    unit (the plain version of B2 on the CPU), images within 1 LSB of the
    JAX package's ``_decode_stack``."""
    reader_kwargs = {"decode_placement": {"image": "device"}}
    kwargs = dict(fields=["idx", "image"], stack_batches=2)
    calls = []
    real = loader_mod.decode_from_layout

    def counting(planes, qtabs, layout, *args, **kw):
        calls.append(planes[0].shape[0])
        return real(planes, qtabs, layout, *args, **kw)

    loader_mod.decode_from_layout = counting
    try:
        got, diag = _port(jpeg_ds, reader_kwargs, **kwargs)
    finally:
        loader_mod.decode_from_layout = real
    want, _ = _jax(jpeg_ds, reader_kwargs, **kwargs)
    assert calls == [16, 16] and diag["units_staged"] == 2  # one decode of K * B a unit
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["idx"], w["idx"])
        assert g["image"].shape == w["image"].shape == (2, 8, 24, 32, 3)
        assert g["image"].dtype == np.uint8
        _assert_bytes_close(g["image"], w["image"])


def test_stack_device_decode_partial_tail(jpeg_ds):
    """Short final stack and partial rows with the device decode: the padded
    rows decode to flat gray, the missing step to gray, '_valid_rows' and the
    mask mark exactly the real rows (the JAX loader's mesh form)."""
    reader_kwargs = {"decode_placement": {"image": "device"}}
    kwargs = dict(batch_size=24, fields=["idx", "image"], stack_batches=2, drop_last=False,
                  valid_mask_field="mask")
    got, _ = _port(jpeg_ds, reader_kwargs, **kwargs)
    want, _ = _jax(jpeg_ds, reader_kwargs, mesh=True, **kwargs)
    assert len(got) == len(want) == 1
    g, w = got[0], want[0]
    assert g[VALID_ROWS].tolist() == w[VALID_ROWS].tolist() == [24, 8]
    np.testing.assert_array_equal(g["mask"], w["mask"])
    np.testing.assert_array_equal(g["idx"], w["idx"])
    _assert_bytes_close(g["image"][g["mask"] > 0], w["image"][w["mask"] > 0])
    assert (g["image"][1, 8:] == 128).all()


def test_stack_geometry_change_raises_the_jax_message(jpeg_ds):
    reader = make_reader(jpeg_ds, reader_pool_type="serial",
                         decode_placement={"image": "device"})
    with CudaDataLoader(reader, 8, device="cpu", stack_batches=2) as loader:
        def host_batch(height):
            layout = JpegCoefLayout(32, height, ((2, 2, 4, 4), (1, 1, 2, 2), (1, 1, 2, 2)))
            return loader_mod._HostBatch({}, {}, {"image": layout}, {}, 8)

        with pytest.raises(PetastormTpuError,
                           match="jpeg geometry changed between stacked batches"):
            loader._check_stack([host_batch(24), host_batch(32)], {})
