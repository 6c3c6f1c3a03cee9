"""The port's batched native host decode against the JAX package's, on the CPU.

``petastorm_tpu_torch.native.image.decode_column_native`` (the port's own
``native/image_decode.cpp``, built by its own ``native/build.py``) must give
the JAX package's ``decode_column_native`` byte for byte, full and ROI, at
every JPEG sampling and PNG kind here, with one thread or four, and equal the
port's per-cell cv2 decode (its plain version) and, for a ROI, the slice of a
full decode.  The reader's ``decode_roi``, ``decode_threads`` and
``workers_count='auto'`` are held to the JAX reader's rows, schema, errors
and sizing.  No tolerance: every comparison is exact.
"""

import os
import re

import cv2
import numpy as np
import pyarrow as pa
import pytest

import petastorm_tpu.reader as jax_reader
from petastorm_tpu import codecs as jax_codecs
from petastorm_tpu import schema as jax_schema
from petastorm_tpu.errors import PetastormTpuError as JaxPetastormTpuError
from petastorm_tpu.etl.writer import write_dataset as jax_write_dataset
from petastorm_tpu.native import image as jax_native

import petastorm_tpu_torch.reader as torch_reader
from petastorm_tpu_torch import CompressedImageCodec, Field, Schema
from petastorm_tpu_torch import codecs as torch_codecs
from petastorm_tpu_torch.codecs import decode_options
from petastorm_tpu_torch.cuda.loader import CudaDataLoader
from petastorm_tpu_torch.errors import CodecError, PetastormTpuError
from petastorm_tpu_torch.native import build as native_build
from petastorm_tpu_torch.native import image as native
from petastorm_tpu_torch.plan import WorkItem
from petastorm_tpu_torch.worker import RowGroupDecoderWorker


def _smooth(h, w, seed):
    """A smooth random field plus noise: image content like a photograph's."""
    rng = np.random.default_rng(seed)
    low = rng.integers(0, 256, (5, 5, 3)).astype(np.float32)
    img = cv2.resize(low, (w, h), interpolation=cv2.INTER_CUBIC)
    return np.clip(img + rng.normal(0, 10, (h, w, 3)), 0, 255).astype(np.uint8)


def _jpeg(img, sampling=None, progressive=False):
    params = [int(cv2.IMWRITE_JPEG_QUALITY), 90]
    if sampling is not None:
        params += [int(cv2.IMWRITE_JPEG_SAMPLING_FACTOR), int(sampling)]
    if progressive:
        params += [int(cv2.IMWRITE_JPEG_PROGRESSIVE), 1]
    src = img if img.ndim == 2 else cv2.cvtColor(img, cv2.COLOR_RGB2BGR)
    ok, enc = cv2.imencode(".jpeg", src, params)
    assert ok
    return enc.tobytes()


def _png(img):
    ok, enc = cv2.imencode(".png", img if img.ndim == 2 else cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    assert ok
    return enc.tobytes()


# name -> (codec, field shape, encode one (h, w, 3) image into a stream)
CASES = {
    "jpeg-444": ("jpeg", (48, 72, 3), lambda im: _jpeg(im, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)),
    "jpeg-422": ("jpeg", (48, 72, 3), lambda im: _jpeg(im, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422)),
    "jpeg-420": ("jpeg", (48, 72, 3), lambda im: _jpeg(im, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420)),
    "jpeg-420-37x53": ("jpeg", (37, 53, 3), _jpeg),
    "jpeg-gray": ("jpeg", (40, 56), lambda im: _jpeg(im[..., 0])),
    "jpeg-gray-hw1": ("jpeg", (40, 56, 1), lambda im: _jpeg(im[..., 0])),
    "jpeg-progressive": ("jpeg", (48, 72, 3), lambda im: _jpeg(im, progressive=True)),
    "png-rgb": ("png", (30, 45, 3), _png),
    "png-gray": ("png", (30, 45), lambda im: _png(im[..., 1])),
    # a color stream into a grayscale field: libpng's rgb_to_gray with cv2's weights
    "png-color-to-gray": ("png", (30, 45), _png),
}
N_IMAGES = 7


def _case(name, n=N_IMAGES):
    codec, shape, encode = CASES[name]
    bufs = [encode(_smooth(shape[0], shape[1], seed)) for seed in range(n)]
    field = Field("image", np.uint8, shape, CompressedImageCodec(codec, 90))
    return field, pa.array(bufs, type=pa.binary())


def _native(module, column, shape, **kwargs):
    out = np.empty((len(column),) + tuple(shape), np.uint8)
    assert module.decode_column_native(column, out, **kwargs)
    return out


def _per_cell(field, column):
    """The plain version: the port's per-cell cv2 decode."""
    return np.stack([field.codec.decode(field, v) for v in column.to_pylist()])


def _roi_offsets(field, crop_hw, n, seed):
    rng = np.random.default_rng(seed)
    h, w = field.shape[:2]
    ys = rng.integers(0, h - crop_hw[0] + 1, n).astype(np.int32)
    xs = rng.integers(0, w - crop_hw[1] + 1, n).astype(np.int32)
    return ys, xs


def _crop_hw(field):
    """A crop whose edges fall inside 8x8 blocks (and MCUs) of the image."""
    h, w = field.shape[:2]
    return h - 11, w - 13


@pytest.mark.parametrize("nthreads", [1, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_native_decode_equals_jax_package_and_per_cell(name, nthreads):
    field, column = _case(name)
    got = _native(native, column, field.shape, nthreads=nthreads)
    np.testing.assert_array_equal(got, _native(jax_native, column, field.shape,
                                               nthreads=nthreads))
    np.testing.assert_array_equal(got.reshape((N_IMAGES,) + field.shape), _per_cell(field, column))


@pytest.mark.parametrize("name", ["jpeg-420", "jpeg-gray", "png-rgb", "png-color-to-gray"])
def test_native_decode_reads_a_sliced_column(name):
    field, column = _case(name)
    sliced = column.slice(2, 4)
    assert sliced.offset == 2
    got = _native(native, sliced, field.shape, nthreads=2)
    np.testing.assert_array_equal(got, _native(jax_native, sliced, field.shape))
    np.testing.assert_array_equal(got, _native(native, column, field.shape)[2:6])


@pytest.mark.parametrize("nthreads", [1, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_roi_decode_equals_jax_package_and_a_sliced_full_decode(name, nthreads):
    field, column = _case(name)
    crop_h, crop_w = _crop_hw(field)
    ys, xs = _roi_offsets(field, (crop_h, crop_w), N_IMAGES, seed=5)
    assert (ys % 8).any() and (xs % 8).any()  # block-unaligned windows
    shape = (crop_h, crop_w) + field.shape[2:]
    kwargs = dict(nthreads=nthreads, roi=(ys, xs), full_shape=field.shape[:2])
    got = _native(native, column, shape, **kwargs)
    np.testing.assert_array_equal(got, _native(jax_native, column, shape, **kwargs))
    full = _native(native, column, field.shape)
    for i in range(N_IMAGES):
        np.testing.assert_array_equal(got[i], full[i, ys[i]:ys[i] + crop_h, xs[i]:xs[i] + crop_w])


def test_roi_covering_the_whole_image_is_a_full_decode():
    field, column = _case("jpeg-420")
    got = _native(native, column, field.shape, roi=(0, 0), full_shape=field.shape[:2])
    np.testing.assert_array_equal(got, _native(native, column, field.shape))


@pytest.mark.parametrize("bad,match", [
    (lambda b: b[:len(b) // 4], "cell 2"),                  # truncated inside the header
    (lambda b: b"\x00\x01" + b[2:], "cell 2"),              # no known magic
    (lambda b: b[:8] + bytes(len(b) - 8), "cell 2"),        # a zeroed PNG
])
@pytest.mark.parametrize("codec", ["jpeg", "png"])
def test_corrupt_stream_raises_naming_the_cell(codec, bad, match):
    field, column = _case("jpeg-420" if codec == "jpeg" else "png-rgb", n=4)
    cells = column.to_pylist()
    cells[2] = bad(cells[2])
    column = pa.array(cells, type=pa.binary())
    out = np.empty((4,) + field.shape, np.uint8)
    for module in (native, jax_native):
        with pytest.raises(Exception, match=match) as info:
            module.decode_column_native(column, out, nthreads=2)
        assert type(info.value).__name__ == "CodecError"
    with pytest.raises(CodecError, match=match):
        field.codec.decode_column(field, column)


@pytest.mark.parametrize("name", ["jpeg-420", "png-rgb"])
def test_shape_mismatch_raises_naming_the_cell(name):
    field, column = _case(name, n=3)
    h, w, c = field.shape
    with pytest.raises(CodecError, match=r"cell 0 \(expected shape \(8, 8, 3\)"):
        native.decode_column_native(column, np.empty((3, 8, 8, 3), np.uint8))
    # a cell of another size, at index 1
    cells = column.to_pylist()
    cells[1] = CASES[name][2](_smooth(h + 8, w, 9))
    with pytest.raises(CodecError, match="cell 1"):
        native.decode_column_native(pa.array(cells, type=pa.binary()),
                                    np.empty((3, h, w, c), np.uint8))


def test_columns_off_the_native_path_return_false():
    field, column = _case("jpeg-420", n=2)
    out = np.empty((2,) + field.shape, np.uint8)
    assert not native.decode_column_native(column, out.astype(np.float32))  # dtype
    assert not native.decode_column_native(column, np.empty((2, 48, 72, 2), np.uint8))  # channels
    assert not native.decode_column_native(pa.array([1, 2], type=pa.int64()), out)  # not binary
    with_null = pa.array(column.to_pylist()[:1] + [None], type=pa.binary())
    assert not native.decode_column_native(with_null, out)


def test_nulls_and_wide_dtypes_decode_per_cell():
    """A column with nulls, and a uint16 PNG, take the per-cell path; the
    port's result equals the JAX codec's and the native counters stay put."""
    field, column = _case("jpeg-420", n=3)
    with_null = pa.array(column.to_pylist()[:2] + [None], type=pa.binary())
    jax_field = jax_schema.Field("image", np.uint8, field.shape,
                                 jax_codecs.CompressedImageCodec("jpeg", 90))
    before = native.decode_stats()
    got = field.codec.decode_column(field, with_null)
    assert native.decode_stats() == before
    want = jax_field.codec.decode_column(jax_field, with_null)
    assert got.dtype == object and got[2] is None and want[2] is None
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w)

    wide = Field("depth", np.uint16, (6, 5), CompressedImageCodec("png"))
    img = np.random.default_rng(0).integers(0, 65536, (6, 5), dtype=np.uint16)
    col = pa.array([wide.codec.encode(wide, img)] * 2, type=pa.binary())
    np.testing.assert_array_equal(wide.codec.decode_column(wide, col), np.stack([img, img]))
    assert native.decode_stats() == before


def test_decode_stats_count_each_native_call():
    field, column = _case("png-rgb", n=5)
    before = native.decode_stats()
    assert set(before) == {"batch_calls", "batch_images", "roi_calls", "roi_images",
                           "coef_batch_calls", "coef_batch_images"}
    assert set(before) == set(jax_native.decode_stats())
    field.codec.decode_column(field, column)
    with decode_options(roi=(1, 2, 20, 30)):
        crop = field.codec.decode_column(field, column)
    assert crop.shape == (5, 20, 30, 3)
    jpeg_field, jpeg_column = _case("jpeg-420", n=3)
    native.read_jpeg_coefficients_column(jpeg_column)
    after = native.decode_stats()
    assert {k: after[k] - before[k] for k in after} == {
        "batch_calls": 1, "batch_images": 5, "roi_calls": 1, "roi_images": 5,
        "coef_batch_calls": 1, "coef_batch_images": 3}


def test_codec_decode_column_takes_the_native_path_with_the_options():
    """CompressedImageCodec.decode_column: one native call, the threads and
    ROI of decode_options, the same array as the JAX codec's."""
    field, column = _case("jpeg-422")
    jax_field = jax_schema.Field("image", np.uint8, field.shape,
                                 jax_codecs.CompressedImageCodec("jpeg", 90))
    ys, xs = _roi_offsets(field, (30, 41), N_IMAGES, seed=1)
    before = native.decode_stats()
    with decode_options(nthreads=3, roi=(ys, xs, 30, 41)):
        got = field.codec.decode_column(field, column)
    with jax_codecs.decode_options(nthreads=3, roi=(ys, xs, 30, 41)):
        want = jax_field.codec.decode_column(jax_field, column)
    np.testing.assert_array_equal(got, want)
    after = native.decode_stats()
    assert (after["roi_calls"] - before["roi_calls"], after["batch_calls"]
            - before["batch_calls"]) == (1, 0)
    # the per-cell plain version, cropped as the codec crops a per-cell column
    np.testing.assert_array_equal(
        got, torch_codecs._slice_roi(_per_cell(field, column), (ys, xs, 30, 41)))


def test_decode_threads_environment_default(monkeypatch):
    monkeypatch.setattr(torch_codecs, "_DECODE_THREADS", None)
    monkeypatch.setenv("PETASTORM_TPU_DECODE_THREADS", "auto")
    assert torch_codecs._decode_threads() == 1
    monkeypatch.setattr(torch_codecs, "_DECODE_THREADS", None)
    monkeypatch.setenv("PETASTORM_TPU_DECODE_THREADS", "4")
    assert torch_codecs._decode_threads() == 4
    monkeypatch.setattr(torch_codecs, "_DECODE_THREADS", None)


def test_decode_library_links_pillows_libraries():
    """The H100 machines have no system libjpeg or libpng: the library links
    the ones Pillow's wheel bundles, with the vendored headers, and decodes
    the same bytes."""
    import ctypes

    libjpeg, libpng = native_build.pillow_libjpeg(), native_build.pillow_libpng()
    assert libjpeg is not None and libpng is not None and ".so.16" in libpng
    lib = native_build.load("image_decode", native._configure_decode,
                            libjpeg=libjpeg, libpng=libpng)
    for name in ("jpeg-420", "png-rgb", "png-color-to-gray"):
        field, column = _case(name, n=2)
        want = _native(native, column, field.shape)
        for i, buf in enumerate(column.to_pylist()):
            out = np.empty(field.shape, np.uint8)
            c = field.shape[2] if len(field.shape) == 3 else 1
            assert lib.pst_decode_image(buf, len(buf), out.ctypes.data_as(ctypes.c_void_p),
                                        field.shape[0], field.shape[1], c) == 0
            np.testing.assert_array_equal(out, want[i])


def _fresh_build(monkeypatch, tmp_path):
    monkeypatch.setattr(native_build, "LIB_DIR", str(tmp_path))
    monkeypatch.setattr(native_build, "_loaded", {})


def test_decode_build_raises_without_a_libpng(monkeypatch, tmp_path, image_dataset):
    """No libpng: the build raises and the reader refuses to start, where the
    JAX package warns once and decodes per cell."""
    _fresh_build(monkeypatch, tmp_path)
    monkeypatch.setattr(native_build, "_SYSTEM_LIB_DIRS", ())
    monkeypatch.setattr(native_build, "pillow_libpng", lambda: None)
    with pytest.raises(RuntimeError, match="no libpng16.so.16"):
        native_build.build("image_decode")
    with pytest.raises(RuntimeError, match=re.escape(native.BUILD_COMMAND)):
        torch_reader.make_batch_reader(image_dataset, reader_pool_type="serial")
    field, column = _case("jpeg-420", n=2)
    with pytest.raises(RuntimeError, match="native image decode library is unavailable"):
        field.codec.decode_column(field, column)
    assert not os.listdir(tmp_path)


def test_decode_build_raises_without_a_compiler(monkeypatch, tmp_path):
    _fresh_build(monkeypatch, tmp_path)
    monkeypatch.setattr(native_build.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native_build.build("image_decode")
    field, column = _case("png-rgb", n=2)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.decode_column_native(column, np.empty((2,) + field.shape, np.uint8))


def test_decode_library_is_keyed_by_what_it_links(tmp_path):
    linked = {"libjpeg": "/a/libjpeg.so.62", "libpng": "/a/libpng16.so.16"}
    path = native_build.lib_path("image_decode", linked)
    assert os.path.basename(path).startswith("libimage_decode-")
    assert native_build.lib_path("image_decode", dict(linked, libpng="/b/libpng16.so.16")) != path
    assert native_build.lib_path("jpeg_coef", {"libjpeg": "/a/libjpeg.so.62"}) != path


# -- the reader ---------------------------------------------------------------

N_ROWS, ROWS_PER_GROUP = 30, 7


@pytest.fixture(scope="module")
def image_dataset(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("roi") / "ds")
    schema = jax_schema.Schema("Imgs", [
        jax_schema.Field("label", np.int64),
        jax_schema.Field("image", np.uint8, (40, 56, 3),
                         jax_codecs.CompressedImageCodec("jpeg", 90)),
        jax_schema.Field("png", np.uint8, (24, 20), jax_codecs.CompressedImageCodec("png")),
    ])
    rows = [{"label": i, "image": _smooth(40, 56, i), "png": _smooth(24, 20, 100 + i)[..., 2]}
            for i in range(N_ROWS)]
    jax_write_dataset(path, schema, rows, row_group_size_rows=ROWS_PER_GROUP)
    return path


ROI_SPECS = [
    {"image": (3, 5, 29, 37)},
    {"image": ("center", 33, 41)},
    {"image": ("random", 30, 30), "png": ("random", 11, 13)},
    {"png": ("center", 17, 9)},
]


def _batches(mod, path, **kwargs):
    with mod.make_batch_reader(path, reader_pool_type="serial", shuffle_seed=3,
                               **kwargs) as reader:
        schema = getattr(reader, "output_schema", None) or reader.schema
        shapes = {f.name: tuple(f.shape) for f in schema}
        return [dict(b._asdict()) for b in reader], shapes


@pytest.mark.parametrize("decode_roi", ROI_SPECS, ids=lambda s: repr(s))
def test_batch_reader_roi_matches_jax_reader(image_dataset, decode_roi):
    got, got_shapes = _batches(torch_reader, image_dataset, decode_roi=decode_roi)
    want, want_shapes = _batches(jax_reader, image_dataset, decode_roi=decode_roi)
    assert got_shapes == want_shapes
    for name, spec in decode_roi.items():
        crop = spec[1:] if isinstance(spec[0], str) else spec[2:]
        assert got_shapes[name][:2] == crop
    assert len(got) == len(want) == -(-N_ROWS // ROWS_PER_GROUP)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for name in g:
            np.testing.assert_array_equal(np.asarray(g[name]), np.asarray(w[name]))
            assert g[name].shape[1:] == got_shapes[name]


@pytest.mark.parametrize("decode_roi", ROI_SPECS[1:3], ids=lambda s: repr(s))
def test_row_reader_roi_matches_jax_reader(image_dataset, decode_roi):
    def rows(mod):
        with mod.make_reader(image_dataset, reader_pool_type="serial", shuffle_seed=5,
                             decode_roi=decode_roi) as reader:
            return [r._asdict() for r in reader]

    got, want = rows(torch_reader), rows(jax_reader)
    assert len(got) == len(want) == N_ROWS
    for g, w in zip(got, want):
        for name in g:
            np.testing.assert_array_equal(np.asarray(g[name]), np.asarray(w[name]))


def test_random_roi_is_the_same_on_a_reread_and_slices_the_full_decode(image_dataset):
    spec = {"image": ("random", 30, 30)}

    def by_label(batches):
        return {int(lab): img for b in batches for lab, img in zip(b["label"], b["image"])}

    two_epochs, _ = _batches(torch_reader, image_dataset, decode_roi=spec, num_epochs=2,
                             decode_threads=3)
    n = len(two_epochs) // 2
    crops = by_label(_batches(torch_reader, image_dataset, decode_roi=spec)[0])
    for epoch in (two_epochs[:n], two_epochs[n:]):
        got = by_label(epoch)
        assert set(got) == set(crops) == set(range(N_ROWS))
        for lab, img in got.items():
            np.testing.assert_array_equal(img, crops[lab])
    # the offsets are the worker's _roi_for draws, different per row
    full = by_label(_batches(torch_reader, image_dataset)[0])
    info = torch_reader.open_dataset(image_dataset)
    worker = RowGroupDecoderWorker(torch_reader.infer_or_load_schema(info), ["image"],
                                   decode_roi=spec)
    offsets = set()
    for rg in info.row_groups:
        ys, xs, h, w = worker._roi_for("image", WorkItem(rg), rg.num_rows)
        for i in range(rg.num_rows):
            lab = rg.global_index * ROWS_PER_GROUP + i  # labels were written in order
            np.testing.assert_array_equal(crops[lab],
                                          full[lab][ys[i]:ys[i] + h, xs[i]:xs[i] + w])
            offsets.add((int(ys[i]), int(xs[i])))
    assert len(offsets) > N_ROWS // 2


def test_roi_reader_counts_roi_decodes_and_loader_stages_the_crop(image_dataset):
    spec = {"image": ("center", 33, 41)}
    reader = torch_reader.make_reader(image_dataset, reader_pool_type="thread",
                                      workers_count=3, shuffle_seed=0, decode_roi=spec)
    assert reader.schema["image"].shape == (33, 41, 3)
    with CudaDataLoader(reader, batch_size=8, device="cpu", drop_last=False) as loader:
        batches = list(loader)
    stats = reader.decode_stats()
    assert stats["roi_images"] == N_ROWS and stats["batch_images"] == N_ROWS  # png full
    assert stats["roi_calls"] == stats["batch_calls"] == -(-N_ROWS // ROWS_PER_GROUP)
    assert all(b["image"].shape == (8, 33, 41, 3) for b in batches)
    full, _ = _batches(torch_reader, image_dataset)
    by_label = {int(lab): img for b in full for lab, img in zip(b["label"], b["image"])}
    y0, x0 = (40 - 33) // 2, (56 - 41) // 2
    for b in batches:
        n = int(b.get("_valid_rows", 8))
        for lab, img in zip(b["label"][:n].tolist(), b["image"][:n].numpy()):
            np.testing.assert_array_equal(img, by_label[lab][y0:y0 + 33, x0:x0 + 41])


def test_torch_adapter_delivers_the_cropped_shape(image_dataset):
    from petastorm_tpu_torch.pytorch import BatchedDataLoader

    spec = {"image": (3, 5, 29, 37), "png": ("center", 17, 9)}
    want, _ = _batches(torch_reader, image_dataset, decode_roi=spec)
    reader = torch_reader.make_reader(image_dataset, reader_pool_type="serial",
                                      shuffle_seed=3, decode_roi=spec)
    with BatchedDataLoader(reader, batch_size=4) as loader:
        got = list(loader)
    assert all(g["image"].shape[1:] == (29, 37, 3) and g["png"].shape[1:] == (17, 9)
               for g in got)
    for name in ("label", "image", "png"):
        np.testing.assert_array_equal(np.concatenate([g[name].numpy() for g in got]),
                                      np.concatenate([w[name] for w in want]))


@pytest.mark.parametrize("kwargs,match", [
    (dict(decode_roi={"image": (20, 20, 33, 41)}), "exceeds the stored"),
    (dict(decode_roi={"image": ("diag", 8, 8)}), "must be"),
    (dict(decode_roi={"nope": (0, 0, 8, 8)}), "not in schema"),
    (dict(decode_roi={"image": (0, 0, 8, 8)}, decode_placement={"image": "device"}),
     "decode_placement"),
    (dict(decode_roi={"label": (0, 0, 1, 1)}), "fixed-shape uint8"),
    (dict(decode_roi={"image": ("center", 0, 8)}), "positive int"),
    (dict(decode_roi={"image": (0, 0, 8, 8)}, schema_fields=["label"]), "not being read"),
])
def test_roi_validation_errors_match_jax_reader(image_dataset, kwargs, match):
    with pytest.raises(PetastormTpuError, match=match) as got:
        torch_reader.make_batch_reader(image_dataset, **kwargs)
    with pytest.raises(JaxPetastormTpuError) as want:
        jax_reader.make_batch_reader(image_dataset, **kwargs)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("cores", [1, 2, 8, 32])
@pytest.mark.parametrize("workers_count,decode_threads", [
    ("auto", "auto"), (3, "auto"), (1, "auto"), ("auto", 2), (4, 1)])
def test_auto_sizing_matches_jax_reader(monkeypatch, image_dataset, cores, workers_count,
                                        decode_threads):
    monkeypatch.setattr(os, "sched_getaffinity", lambda _: set(range(cores)))
    seen = {}

    def spy(mod, key):
        real = mod.RowGroupDecoderWorker

        def make(*args, **kwargs):
            seen[key] = kwargs["decode_threads"]
            return real(*args, **kwargs)

        monkeypatch.setattr(mod, "RowGroupDecoderWorker", make)

    spy(jax_reader, "jax")
    spy(torch_reader, "torch")
    real_executor = torch_reader.make_executor

    def executor(kind, workers, queue, **pool_kwargs):
        seen["torch_workers"] = workers
        return real_executor(kind, workers, queue, **pool_kwargs)

    monkeypatch.setattr(torch_reader, "make_executor", executor)
    kwargs = dict(workers_count=workers_count, decode_threads=decode_threads)
    # 'auto' arms autotune in both packages: the static sizing is compared
    with torch_reader.make_batch_reader(image_dataset, autotune=False, **kwargs):
        pass
    with jax_reader.make_batch_reader(image_dataset, autotune=False, **kwargs) as r:
        jax_workers = r.diagnostics["workers_count"]
    assert seen["torch"] == seen["jax"]
    assert seen["torch_workers"] == jax_workers
    if workers_count == "auto":
        assert jax_workers == max(1, min(10, cores - 1))


def test_entropy_half_fans_out_over_decode_threads(image_dataset):
    def planes(threads):
        with torch_reader.make_batch_reader(image_dataset, reader_pool_type="serial",
                                            shuffle_seed=0, decode_threads=threads,
                                            decode_placement={"image": "device"}) as reader:
            return list(reader.iter_batches()), reader.decode_stats()

    one, one_stats = planes(1)
    four, four_stats = planes(4)
    assert len(one) == len(four)
    for a, b in zip(one, four):
        assert set(a.columns) == set(b.columns)
        for name in a.columns:
            np.testing.assert_array_equal(a.columns[name], b.columns[name])
    assert one_stats == four_stats
    assert one_stats["coef_batch_images"] == N_ROWS
    assert one_stats["batch_images"] == N_ROWS  # the png column, on the host


def test_host_decode_takes_the_native_path_for_every_image(image_dataset):
    with torch_reader.make_reader(image_dataset, workers_count=4, shuffle_seed=1,
                                  num_epochs=2) as reader:
        rows = list(reader)
        stats = reader.decode_stats()
    assert len(rows) == 2 * N_ROWS
    groups = -(-N_ROWS // ROWS_PER_GROUP)
    assert stats == {"batch_calls": 2 * 2 * groups, "batch_images": 2 * 2 * N_ROWS,
                     "roi_calls": 0, "roi_images": 0, "coef_batch_calls": 0,
                     "coef_batch_images": 0}


def test_schema_of_a_roi_reader_keeps_the_stored_schema_for_the_worker(image_dataset):
    full = torch_reader.infer_or_load_schema(torch_reader.open_dataset(image_dataset))
    cropped = torch_reader._apply_roi_schema(full, {"png": (1, 2, 3, 4)})
    assert cropped["png"].shape == (3, 4) and full["png"].shape == (24, 20)
    assert cropped["image"] == full["image"]
    assert isinstance(cropped, Schema)
