"""``decode_placement='device-mixed'`` in the port against the JAX package, on the CPU.

The datasets of ``tests/test_jpeg_mixed_device.py``: three geometries
interleaved so one rowgroup mixes them, a 4:4:4 and 4:2:0 pair of one size,
and a grayscale cell among color ones.  Each is read by both packages
(``make_batch_reader(..., decode_placement={'image': 'device-mixed'})`` into
``JaxDataLoader`` and ``CudaDataLoader(device='cpu')``); the JAX decode runs
as its own CPU tests run it (XLA on the CPU), the port's through B2's plain
version (``ops.jpeg._decode_reference``).

Tolerance: the delivered pixels at most 1 LSB apart on at most 0.1 % of the
bytes (``tests/test_torch_jpeg.py``: the same float32 arithmetic, the IDCT
summed in another order); rows, ``idx``, the pad region and the geometry
counts exactly equal.
"""

import logging
import os

import cv2
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from petastorm_tpu.codecs import CompressedImageCodec as JaxImageCodec
from petastorm_tpu.errors import PetastormTpuError as JaxPetastormTpuError
from petastorm_tpu.etl.writer import write_dataset as jax_write_dataset
from petastorm_tpu.jax import JaxDataLoader
from petastorm_tpu.reader import make_batch_reader as jax_make_batch_reader
from petastorm_tpu.schema import Field as JaxField, Schema as JaxSchema

from petastorm_tpu_torch import CompressedImageCodec, Field, Schema, make_batch_reader
from petastorm_tpu_torch.cuda.loader import VALID_ROWS, CudaDataLoader
from petastorm_tpu_torch.errors import CodecError, PetastormTpuError
from petastorm_tpu_torch.etl.writer import stamp_dataset_metadata, write_dataset
from petastorm_tpu_torch.native import image as native
from petastorm_tpu_torch.pool import WorkerError

#: three geometries, interleaved so single rowgroups mix them
GEOMETRIES = [(64, 96), (48, 64), (32, 32)]
TARGET = (64, 96, 3)
N_ROWS, GROUP, BATCH = 24, 6, 8


def _smooth_rgb(h, w, seed=0):
    x, y = np.meshgrid(np.arange(w), np.arange(h))
    img = np.stack([(np.sin(x / (9.0 + seed)) + np.cos(y / 7.0)) * 60 + 120,
                    (np.sin(x / 5.0) + seed * 0.1) * 50 + 128,
                    np.cos(x / 11.0) * np.sin(y / 13.0) * 55 + 120], -1)
    return img.clip(0, 255).astype(np.uint8)


def _encode(img, sampling=None):
    params = [int(cv2.IMWRITE_JPEG_QUALITY), 90]
    if sampling is not None:
        params += [int(cv2.IMWRITE_JPEG_SAMPLING_FACTOR), int(sampling)]
    src = img if img.ndim == 2 else cv2.cvtColor(img, cv2.COLOR_RGB2BGR)
    ok, enc = cv2.imencode(".jpeg", src, params)
    assert ok
    return enc.tobytes()


def _assert_bytes_close(got, want):
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() <= 1e-3, (diff > 0).mean()


def _mixed_schema():
    return Schema("MixedGeo", [
        Field("idx", np.int64),
        Field("image", np.uint8, (None, None, 3), CompressedImageCodec("jpeg", quality=92))])


@pytest.fixture(scope="module")
def mixed_ds(tmp_path_factory):
    """The JAX suite's mixed dataset, written by the JAX package's writer."""
    schema = JaxSchema("MixedGeo", [
        JaxField("idx", np.int64),
        JaxField("image", np.uint8, (None, None, 3), JaxImageCodec("jpeg", quality=92))])
    rows = [{"idx": i, "image": _smooth_rgb(*GEOMETRIES[i % len(GEOMETRIES)], seed=i)}
            for i in range(N_ROWS)]
    url = str(tmp_path_factory.mktemp("mixed_geo") / "ds")
    jax_write_dataset(url, schema, rows, row_group_size_rows=GROUP)
    return url


def _write_raw(path, bufs, shape, rows_per_group):
    """A dataset of hand-encoded JPEG cells (a writer would re-encode them)."""
    schema = Schema("Raw", [Field("idx", np.int64),
                            Field("image", np.uint8, shape, CompressedImageCodec("jpeg"))])
    os.makedirs(path)
    table = pa.Table.from_pylist([{"idx": i, "image": b} for i, b in enumerate(bufs)],
                                 schema=schema.as_arrow_schema())
    pq.write_table(table, os.path.join(path, "part-00000.parquet"), row_group_size=rows_per_group)
    stamp_dataset_metadata(path, schema)
    return path


@pytest.fixture(scope="module")
def sampling_ds(tmp_path_factory):
    """One size (32 x 32, a fixed schema shape), 4:2:0 and 4:4:4 alternating."""
    bufs = [_encode(_smooth_rgb(32, 32, seed=i),
                    cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444 if i % 2 else None) for i in range(8)]
    return _write_raw(str(tmp_path_factory.mktemp("mixed_samp") / "ds"), bufs, (32, 32, 3), 4)


@pytest.fixture(scope="module")
def gray_ds(tmp_path_factory):
    """Color cells of two sizes and one grayscale cell, in a (None, None, 3) field."""
    bufs = []
    for i in range(12):
        img = _smooth_rgb(40 if i % 2 else 24, 56, seed=i)
        bufs.append(_encode(img[..., 0] if i == 5 else img))
    return _write_raw(str(tmp_path_factory.mktemp("mixed_gray") / "ds"), bufs,
                      (None, None, 3), 4)


def _jax_batches(url, batch, target=None, **loader_kwargs):
    with jax_make_batch_reader(url, shuffle_row_groups=False, shuffle_seed=0, num_epochs=1,
                               decode_placement={"image": "device-mixed"}) as reader:
        kwargs = {} if target is None else {"pad_shapes": {"image": target}}
        with JaxDataLoader(reader, batch_size=batch, fields=["idx", "image"], **kwargs,
                           **loader_kwargs) as loader:
            out = [{k: np.asarray(v) for k, v in b.items()} for b in loader]
            return out, loader.diagnostics


def _port_batches(url, batch, target=None, reader_kwargs=None, **loader_kwargs):
    reader = make_batch_reader(url, shuffle_row_groups=False, shuffle_seed=0, num_epochs=1,
                               decode_placement={"image": "device-mixed"},
                               **(reader_kwargs or {}))
    assert reader.device_decode_mixed == frozenset({"image"})
    kwargs = {} if target is None else {"pad_shapes": {"image": target}}
    with CudaDataLoader(reader, batch, device="cpu", fields=["idx", "image"], **kwargs,
                        **loader_kwargs) as loader:
        out = [dict(b) for b in loader]
        return out, loader.diagnostics()


def _assert_pad_zero(images, idx, geometry_of):
    for img, i in zip(images, idx):
        h, w = geometry_of(int(i))
        assert not img[h:].any() and not img[:, w:].any(), i


@pytest.mark.parametrize("ds, batch, target", [
    ("mixed_ds", BATCH, TARGET), ("sampling_ds", 4, None), ("gray_ds", 4, (40, 56, 3))])
def test_mixed_route_matches_jax_loader(ds, batch, target, request):
    url = request.getfixturevalue(ds)
    got, gdiag = _port_batches(url, batch, target)
    want, wdiag = _jax_batches(url, batch, target)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["idx"].numpy(), w["idx"])
        assert g["image"].dtype == torch.uint8
        assert tuple(g["image"].shape) == w["image"].shape
        _assert_bytes_close(g["image"].numpy(), w["image"])
    assert gdiag["mixed_decode_geometries"] == wdiag["mixed_decode_geometries"]
    assert gdiag["mixed_buckets"] >= len(got)


def test_mixed_route_pads_with_zero_and_counts_geometries(mixed_ds):
    got, diag = _port_batches(mixed_ds, BATCH, TARGET)
    assert diag["mixed_decode_geometries"] == {"image": len(GEOMETRIES)}
    # every batch of 8 interleaved rows holds all three geometries
    assert diag["mixed_buckets"] == len(GEOMETRIES) * len(got)
    assert diag["declared_geometries"] == {"image": len(GEOMETRIES)}
    for b in got:
        _assert_pad_zero(b["image"].numpy(), b["idx"].numpy(),
                         lambda i: GEOMETRIES[i % len(GEOMETRIES)])
    # each row against cv2's decode of its stored stream, the reference's bound
    with make_batch_reader(mixed_ds, shuffle_row_groups=False, num_epochs=1) as reader:
        host = {int(i): img for b in reader.iter_batches()
                for i, img in zip(b.columns["idx"], b.columns["image"])}
    for b in got:
        for i, img in zip(b["idx"].tolist(), b["image"].numpy()):
            h, w = GEOMETRIES[i % len(GEOMETRIES)]
            diff = np.abs(img[:h, :w].astype(int) - host[i].astype(int))
            assert diff.max() <= 6 and diff.mean() < 1.0, i


def test_grayscale_cell_repeats_to_three_equal_channels(gray_ds):
    got, diag = _port_batches(gray_ds, 4, (40, 56, 3))
    image = {i: img for b in got for i, img in zip(b["idx"].tolist(), b["image"].numpy())}
    assert np.array_equal(image[5][..., 0], image[5][..., 1])
    assert np.array_equal(image[5][..., 0], image[5][..., 2])
    assert not image[4][24:].any()  # a 24-row image padded to 40 rows
    assert diag["mixed_decode_geometries"] == {"image": 3}


def test_tail_and_short_stack_rows_are_zero(mixed_ds):
    got, _ = _port_batches(mixed_ds, 16, TARGET, drop_last=False, valid_mask_field="mask")
    assert len(got) == 2 and got[1][VALID_ROWS] == 8
    assert not got[1]["image"][8:].any()
    assert got[1]["mask"].tolist() == [1.0] * 8 + [0.0] * 8
    stacked, _ = _port_batches(mixed_ds, 5, TARGET, drop_last=False, stack_batches=2)
    flat, _ = _port_batches(mixed_ds, 5, TARGET, drop_last=False)
    assert [tuple(u["image"].shape) for u in stacked] == [(2, 5) + TARGET] * 3
    last = stacked[-1]
    assert last[VALID_ROWS].tolist() == [4, 0]
    assert not last["image"][0, 4:].any() and not last["image"][1].any()
    for k, unit in enumerate(stacked):
        for j in range(2):
            if 2 * k + j < len(flat):
                assert torch.equal(unit["image"][j], flat[2 * k + j]["image"])


def test_stacked_units_match_jax_loader(mixed_ds):
    got, _ = _port_batches(mixed_ds, 4, TARGET, stack_batches=2)
    want, _ = _jax_batches(mixed_ds, 4, TARGET, stack_batches=2)
    assert len(got) == len(want) == N_ROWS // 8
    for g, w in zip(got, want):
        assert tuple(g["image"].shape) == w["image"].shape == (2, 4) + TARGET
        np.testing.assert_array_equal(g["idx"].numpy(), w["idx"])
        _assert_bytes_close(g["image"].numpy(), w["image"])


def test_host_shuffle_buffer_delivers_the_same_rows(mixed_ds):
    plain, _ = _port_batches(mixed_ds, 4, TARGET)
    shuffled, _ = _port_batches(mixed_ds, 4, TARGET, shuffling_queue_capacity=12,
                                buffer_seed=3)
    rows = lambda bs: {int(i): img for b in bs  # noqa: E731
                       for i, img in zip(b["idx"], b["image"].numpy())}
    order = [int(i) for b in shuffled for i in b["idx"]]
    assert sorted(order) == list(range(N_ROWS)) and order != list(range(N_ROWS))
    a, b = rows(plain), rows(shuffled)
    assert all(np.array_equal(a[i], b[i]) for i in range(N_ROWS))


def test_memory_cache_warm_epoch_equals_cold(mixed_ds):
    reader = make_batch_reader(mixed_ds, shuffle_row_groups=False, num_epochs=2,
                               cache_type="memory",
                               decode_placement={"image": "device-mixed"})
    with CudaDataLoader(reader, BATCH, device="cpu", fields=["idx", "image"],
                        pad_shapes={"image": TARGET}) as loader:
        batches = [dict(b) for b in loader]
    per_epoch = N_ROWS // BATCH
    assert len(batches) == 2 * per_epoch
    for cold, warm in zip(batches[:per_epoch], batches[per_epoch:]):
        assert torch.equal(cold["idx"], warm["idx"])
        assert torch.equal(cold["image"], warm["image"])
    stats = reader.cache_stats()
    assert (stats["misses"], stats["hits"]) == (N_ROWS // GROUP, N_ROWS // GROUP)
    assert reader.decode_stats()["coef_batch_images"] == N_ROWS


def test_cache_keeps_a_mixed_read_apart_from_a_device_read(sampling_ds, tmp_path):
    """The same rowgroups read as 'device' and then as 'device-mixed' through
    one local-disk cache directory: the second read misses (its stored form
    is object cells, not plane columns) and both deliver their images."""
    path = _write_raw(str(tmp_path / "uniform"),
                      [_encode(_smooth_rgb(32, 32, seed=i)) for i in range(8)], (32, 32, 3), 4)
    cache = {"cache_type": "local-disk", "cache_location": str(tmp_path / "cache")}
    got = {}
    for place in ("device", "device-mixed", "device-mixed"):
        reader = make_batch_reader(path, shuffle_row_groups=False, num_epochs=1,
                                   decode_placement={"image": place}, **cache)
        with CudaDataLoader(reader, 4, device="cpu", fields=["idx", "image"]) as loader:
            got.setdefault(place, []).append(
                (torch.cat([b["image"] for b in loader]), reader.cache_stats()))
    (device, dstats), = got["device"]
    (mixed, mstats), (warm, wstats) = got["device-mixed"]
    assert (dstats["misses"], mstats["misses"], wstats["hits"]) == (2, 2, 2)
    assert torch.equal(mixed, warm)
    _assert_bytes_close(mixed.numpy(), device.numpy())


@pytest.mark.parametrize("targets", [None, [(32, 32, 3), (64, 96, 3)]],
                         ids=["no-target", "two-buckets"])
def test_variable_field_needs_one_pad_target(mixed_ds, targets):
    kwargs = {} if targets is None else {"pad_shapes": {"image": targets}}
    place = {"decode_placement": {"image": "device-mixed"}}
    with make_batch_reader(mixed_ds, num_epochs=1, **place) as reader:
        with pytest.raises(PetastormTpuError, match="ONE pad_shapes target"):
            CudaDataLoader(reader, BATCH, device="cpu", fields=["idx", "image"], **kwargs)
    with jax_make_batch_reader(mixed_ds, num_epochs=1, **place) as reader:
        with pytest.raises(JaxPetastormTpuError, match="ONE pad_shapes target"):
            JaxDataLoader(reader, batch_size=BATCH, fields=["idx", "image"], **kwargs)


def test_device_placement_on_a_mixed_dataset_points_at_device_mixed(mixed_ds):
    for factory, error in ((make_batch_reader, PetastormTpuError),
                           (jax_make_batch_reader, JaxPetastormTpuError)):
        with pytest.raises(error, match="device-mixed"):
            factory(mixed_ds, num_epochs=1, decode_placement={"image": "device"})


def test_device_placement_on_mixed_subsampling_points_at_device_mixed(sampling_ds):
    reader = make_batch_reader(sampling_ds, shuffle_row_groups=False, num_epochs=1,
                               decode_placement={"image": "device"})
    # the worker meets both subsamplings in one rowgroup
    with pytest.raises(WorkerError, match="Use decode_placement='device-mixed'") as info:
        with CudaDataLoader(reader, 8, device="cpu") as loader:
            list(loader)
    assert isinstance(info.value.__cause__, CodecError)


@pytest.mark.parametrize("case", ["ngram", "transform_spec", "predicate", "not-read"])
def test_refusals_match_the_jax_reader(mixed_ds, tmp_path, case):
    """Each package's reader refuses the same 'device-mixed' combinations
    with the same words."""
    import petastorm_tpu.ngram as jax_ngram
    import petastorm_tpu.predicates as jax_predicates
    import petastorm_tpu.reader as jax_reader
    import petastorm_tpu.transform as jax_transform
    from petastorm_tpu_torch import predicates, reader, transform
    from petastorm_tpu_torch import ngram as torch_ngram

    url = mixed_ds
    if case == "ngram":
        url = str(tmp_path / "frames")
        schema = JaxSchema("Frames", [JaxField("ts", np.int64),
                                      JaxField("image", np.uint8, (None, None, 3),
                                               JaxImageCodec("jpeg"))])
        jax_write_dataset(url, schema, [{"ts": i, "image": _smooth_rgb(16, 16, i)}
                                        for i in range(4)])
    place = {"decode_placement": {"image": "device-mixed"}}
    for mod, ng, pred, tf, error in (
            (reader, torch_ngram, predicates, transform, PetastormTpuError),
            (jax_reader, jax_ngram, jax_predicates, jax_transform, JaxPetastormTpuError)):
        kwargs, factory, match = {
            "ngram": ({"ngram": ng.NGram({0: ["ts", "image"], 1: ["ts"]}, 1, "ts")},
                      mod.make_reader, "not supported with ngram readers"),
            "transform_spec": ({"transform_spec": tf.TransformSpec(lambda c: c)},
                               mod.make_batch_reader, "cannot be combined with a transform_spec"),
            "predicate": ({"predicate": pred.in_lambda(["image"], lambda image: True)},
                          mod.make_batch_reader, "predicate field 'image' uses"),
            "not-read": ({"schema_fields": ["idx"]}, mod.make_batch_reader, "not being read"),
        }[case]
        with pytest.raises(error, match=match):
            factory(url, **place, **kwargs)


def test_auto_placement_raises_until_the_live_split_is_ported(mixed_ds):
    """The live split (``'auto'``) needs one fixed geometry, as ``'device'``
    does: on the mixed dataset it raises the JAX package's error."""
    with pytest.raises(PetastormTpuError, match="needs a fixed shape") as got:
        make_batch_reader(mixed_ds, decode_placement={"image": "auto"})
    with pytest.raises(JaxPetastormTpuError, match="needs a fixed shape"):
        jax_make_batch_reader(mixed_ds, decode_placement={"image": "auto"})
    assert "decode_placement='device' field 'image'" in str(got.value)


def test_auto_placement_reads_a_fixed_geometry_through_the_loader(tmp_path):
    """``'auto'`` on a fixed-geometry JPEG field: both forms of the live
    split deliver every row, as ``'device'`` and ``'host'`` do."""
    schema = Schema("Fixed", [Field("idx", np.int64),
                              Field("image", np.uint8, (32, 48, 3), CompressedImageCodec("jpeg"))])
    url = str(tmp_path / "fixed")
    write_dataset(url, schema, [{"idx": i, "image": _smooth_rgb(32, 48, seed=i)}
                                for i in range(24)], row_group_size_rows=4)
    got = {}
    for place in ("auto", "device", "host"):
        with make_batch_reader(url, shuffle_row_groups=False, workers_count=1,
                               results_queue_size=1, decode_placement={"image": place}) as r:
            if place == "auto":
                assert r.decode_split == "device"
            with CudaDataLoader(r, 8, device="cpu") as loader:
                got[place] = [(b["idx"].clone(), b["image"].clone()) for b in loader]
    assert len(got["auto"]) == 3
    for (ai, aim), (di, dim) in zip(got["auto"], got["device"]):
        assert torch.equal(ai, di) and torch.equal(aim, dim)


def test_rows_of_a_mixed_field_are_refused(mixed_ds):
    with make_batch_reader(mixed_ds, num_epochs=1,
                           decode_placement={"image": "device-mixed"}) as reader:
        with pytest.raises(PetastormTpuError, match="CudaDataLoader"):
            next(reader)


def test_worker_refuses_a_corrupt_cell_and_a_wrong_fixed_shape():
    bufs = [_encode(_smooth_rgb(32, 32, seed=i)) for i in range(3)]
    with pytest.raises(CodecError, match="cell 1 is not a decodable jpeg"):
        native.pack_coef_columns_mixed("image", [bufs[0], bufs[1][:40], bufs[2]])
    field = Field("image", np.uint8, (16, 32, 3), CompressedImageCodec("jpeg"))
    with pytest.raises(CodecError, match="declare wildcard dims"):
        native.pack_coef_columns_mixed("image", bufs, field)
    cells = native.pack_coef_columns_mixed("image", bufs)["image" + native.COEF_COLUMN_SEP
                                                          + native.MIXED_CELL_SUFFIX]
    planes, qtabs, layout = native.read_jpeg_coefficients_column(bufs)
    for j, (cell_planes, qtab, meta) in enumerate(cells):
        assert all(np.array_equal(p, q[j]) for p, q in zip(cell_planes, planes))
        assert np.array_equal(qtab, qtabs[j])
        assert native._layout_from_meta(meta) == layout


def test_undeclared_geometry_warns_once_each(mixed_ds, tmp_path, caplog):
    import shutil

    url = str(tmp_path / "ds")
    shutil.copytree(mixed_ds, url)
    stamp_dataset_metadata(url, _mixed_schema(), geometries={"image": [(64, 96, 3)]},
                           merge_geometries=False)
    reader = make_batch_reader(url, shuffle_row_groups=False, num_epochs=2,
                               decode_placement={"image": "device-mixed"})
    assert reader.declared_geometries == {"image": [(64, 96, 3)]}
    with caplog.at_level(logging.WARNING, logger="petastorm_tpu_torch.cuda.loader"):
        with CudaDataLoader(reader, BATCH, device="cpu", fields=["idx", "image"],
                            pad_shapes={"image": TARGET}) as loader:
            assert len(list(loader)) == 2 * N_ROWS // BATCH
            diag = loader.diagnostics()
    warned = [r.getMessage() for r in caplog.records if "declared geometry" in r.getMessage()]
    assert len(warned) == 2
    assert any("(48, 64, 3)" in m for m in warned) and any("(32, 32, 3)" in m for m in warned)
    assert diag["declared_geometries"] == {"image": 1}
