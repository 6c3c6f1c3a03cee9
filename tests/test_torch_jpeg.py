"""The hybrid JPEG decode of the port against the JAX package's, on the CPU.

Host half: the port's entropy decode (``native/jpeg_coef.cpp``, its own
build) gives the JAX package's coefficient planes and quant tables int for
int, at every sampling the reference takes.

Device half: the plain version ``ops.jpeg._decode_reference`` (what a CPU
tensor runs; kernel B2 on the card is held to it by ``chip_smoke.py`` and
``test_torch_cuda_kernels.py``) against ``petastorm_tpu.ops.jpeg.
decode_coefficients`` on the same planes.

Tolerances:

* uint8: at most 1 LSB apart, on at most 0.1 % of the bytes.  Both sides
  compute the same float32 values but sum the IDCT in other orders (XLA's
  dot against torch's ``einsum``), which moves a float by an ulp, and a
  rounded byte moves only where the value sits at a .5 boundary.  Measured
  over the geometries here: at most 1 LSB on 0.0018 % of the bytes (one
  byte of the progressive case).
* float32: within 2e-3 on values of 0-255.  The same sums in another order
  over 64 products of coefficients up to ~2^11 times quant steps; measured
  at most 7.6e-5.
* Against cv2 (libjpeg's fixed-point pipeline): max 6, mean below 1, the
  reference's own bound (``tests/test_jpeg_hybrid.py:80-81``).
"""

import os

import cv2
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from petastorm_tpu.jax import JaxDataLoader
from petastorm_tpu.native import image as jax_native
from petastorm_tpu.ops import jpeg as jax_jpeg
from petastorm_tpu.reader import make_reader as jax_make_reader

from petastorm_tpu_torch import CompressedImageCodec, Field, Schema, make_batch_reader, \
    make_reader, write_dataset
from petastorm_tpu_torch.cuda.loader import VALID_ROWS, CudaDataLoader
from petastorm_tpu_torch.errors import CodecError, PetastormTpuError
from petastorm_tpu_torch.etl.writer import stamp_dataset_metadata
from petastorm_tpu_torch.native import build as native_build
from petastorm_tpu_torch.native import image as native
from petastorm_tpu_torch.ops import jpeg
from petastorm_tpu_torch.pool import WorkerError

UINT8_MAX_SHARE = 1e-3
FLOAT_ATOL = 2e-3


def _smooth(h, w, seed, channels=3):
    """A smooth random field plus noise: JPEG content like a photograph's."""
    rng = np.random.default_rng(seed)
    low = rng.integers(0, 256, (5, 5, 3)).astype(np.float32)
    img = cv2.resize(low, (w, h), interpolation=cv2.INTER_CUBIC)
    img = np.clip(img + rng.normal(0, 10, (h, w, 3)), 0, 255).astype(np.uint8)
    return img if channels == 3 else img[..., 0]


def _encode(img, sampling=None, progressive=False, quality=90):
    params = [int(cv2.IMWRITE_JPEG_QUALITY), quality]
    if sampling is not None:
        params += [int(cv2.IMWRITE_JPEG_SAMPLING_FACTOR), int(sampling)]
    if progressive:
        params += [int(cv2.IMWRITE_JPEG_PROGRESSIVE), 1]
    src = img if img.ndim == 2 else cv2.cvtColor(img, cv2.COLOR_RGB2BGR)
    ok, enc = cv2.imencode(".jpeg", src, params)
    assert ok
    return enc.tobytes()


def _cv2_decode(buf, gray):
    out = cv2.imdecode(np.frombuffer(buf, np.uint8),
                       cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR)
    return out if gray else cv2.cvtColor(out, cv2.COLOR_BGR2RGB)


# name -> (cv2 sampling flag, (h, w), grayscale, progressive)
GEOMETRIES = {
    "444": (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, (64, 96), False, False),
    "422": (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422, (64, 96), False, False),
    "420": (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, (64, 96), False, False),
    "411": (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411, (64, 96), False, False),
    "440": (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440, (64, 96), False, False),
    "gray": (None, (40, 56), True, False),
    "progressive": (None, (64, 96), False, True),
    "37x53": (None, (37, 53), False, False),
    "37x53-422": (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422, (37, 53), False, False),
}


def _bufs(name, n=3):
    sampling, (h, w), gray, progressive = GEOMETRIES[name]
    return [_encode(_smooth(h, w, seed, 1 if gray else 3), sampling, progressive)
            for seed in range(n)]


def _torch_planes(planes, qtabs):
    return [torch.from_numpy(p) for p in planes], torch.from_numpy(qtabs.astype(np.int32))


# -- host half ----------------------------------------------------------------


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_entropy_half_equals_jax_package(name):
    bufs = _bufs(name)
    planes, qtabs, layout = native.read_jpeg_coefficients_column(bufs)
    want_planes, want_qtabs, want_layout = jax_native.read_jpeg_coefficients_column(bufs)
    assert (layout.width, layout.height, layout.components) == (
        want_layout.width, want_layout.height, want_layout.components)
    assert len(planes) == len(want_planes)
    for got, want in zip(planes, want_planes):
        assert got.dtype == want.dtype == np.int16
        np.testing.assert_array_equal(got, want)
    assert qtabs.dtype == want_qtabs.dtype == np.uint16
    np.testing.assert_array_equal(qtabs, want_qtabs)
    # one image at a time, and the header alone, agree too
    one, one_q, one_layout = native.read_jpeg_coefficients(bufs[1])
    for got, want in zip(one, planes):
        np.testing.assert_array_equal(got, want[1])
    np.testing.assert_array_equal(one_q, qtabs[1])
    assert one_layout == native.jpeg_coef_layout(bufs[1]) == layout


def test_entropy_half_reads_arrow_columns_zero_copy():
    bufs = _bufs("420", 4)
    column = pa.array(bufs, type=pa.binary())
    for col in (column, column.slice(1, 3), pa.array(bufs, type=pa.large_binary())):
        planes, qtabs, _ = native.read_jpeg_coefficients_column(col, nthreads=2)
        want, want_q, _ = jax_native.read_jpeg_coefficients_column(col.to_pylist())
        for got, w in zip(planes, want):
            np.testing.assert_array_equal(got, w)
        np.testing.assert_array_equal(qtabs, want_q)


def test_entropy_half_links_pillows_libjpeg():
    """Where a machine has no system libjpeg (the H100 machines the port
    runs on have none), the library links the 6.2-ABI libjpeg-turbo that
    Pillow's wheel bundles, with the vendored headers.  Built that way, it
    decodes the same planes."""
    bundled = native_build.pillow_libjpeg()
    assert bundled is not None and ".so.62" in bundled
    lib = native_build.load("jpeg_coef", native._configure, libjpeg=bundled)
    buf = _bufs("37x53", 1)[0]
    layout = native.jpeg_coef_layout(buf)
    planes = [np.empty((bh, bw, 64), np.int16) for (_, _, bw, bh) in layout.components]
    qtabs = np.empty((3, 64), np.uint16)
    import ctypes

    outs = (ctypes.c_void_p * 3)(*[p.ctypes.data for p in planes])
    assert lib.pst_jpeg_read_coefs(buf, len(buf), ctypes.cast(outs, ctypes.c_void_p),
                                   qtabs.ctypes.data) == 0
    want, want_q, _ = native.read_jpeg_coefficients(buf)
    for got, w in zip(planes, want):
        np.testing.assert_array_equal(got, w)
    np.testing.assert_array_equal(qtabs, want_q)


def test_entropy_build_raises_without_a_compiler(monkeypatch, tmp_path):
    monkeypatch.setattr(native_build, "LIB_DIR", str(tmp_path))
    monkeypatch.setattr(native_build.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native_build.build()


def test_entropy_build_raises_without_a_libjpeg(monkeypatch):
    monkeypatch.setattr(native_build, "_SYSTEM_LIB_DIRS", ())
    monkeypatch.setattr(native_build, "pillow_libjpeg", lambda: None)
    with pytest.raises(RuntimeError, match="no libjpeg.so.62"):
        native_build.find_libjpeg()


def test_non_jpeg_and_mixed_column_raise():
    with pytest.raises(CodecError):
        native.jpeg_coef_layout(b"\x89PNG\r\n\x1a\nnot a jpeg")
    bufs = [_bufs("420", 1)[0], _bufs("444", 1)[0]]
    with pytest.raises(CodecError, match="geometry"):
        native.read_jpeg_coefficients_column(bufs)


# -- device half: the plain version against the JAX package --------------------


def _assert_bytes_close(got, want):
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() <= UINT8_MAX_SHARE, (diff > 0).mean()


@pytest.mark.parametrize("fancy", [True, False], ids=["fancy", "nearest"])
@pytest.mark.parametrize("out", ["uint8", "float32"])
@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_plain_decode_matches_jax(name, out, fancy):
    planes, qtabs, layout = native.read_jpeg_coefficients_column(_bufs(name))
    size = (layout.height, layout.width)
    want = np.asarray(jax_jpeg.decode_coefficients(
        tuple(jnp.asarray(p) for p in planes), jnp.asarray(qtabs), image_size=size,
        sampling=layout.sampling, out_dtype=getattr(jnp, out), fancy_upsampling=fancy))
    got = jpeg.decode_coefficients(*_torch_planes(planes, qtabs), size, layout.sampling,
                                   out_dtype=getattr(torch, out), fancy_upsampling=fancy)
    assert got.dtype == getattr(torch, out) and tuple(got.shape) == want.shape
    if out == "uint8":
        _assert_bytes_close(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FLOAT_ATOL)


@pytest.mark.parametrize("name", ["420", "gray", "37x53", "progressive"])
def test_decode_close_to_cv2(name):
    bufs = _bufs(name)
    gray = GEOMETRIES[name][2]
    got = jpeg.decode_jpeg_column(bufs, device="cpu").numpy()
    want = np.stack([_cv2_decode(b, gray) for b in bufs])
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 6 and diff.mean() < 1.0, (diff.max(), diff.mean())
    # the column form is decode_coefficients of the port's own planes
    jax_got = np.asarray(jax_jpeg.decode_jpeg_column(bufs))
    _assert_bytes_close(got, jax_got)


def test_decode_takes_leading_batch_dims():
    planes, qtabs, layout = native.read_jpeg_coefficients_column(_bufs("420", 4))
    tp, tq = _torch_planes(planes, qtabs)
    flat = jpeg.decode_from_layout(tp, tq, layout, out_dtype=torch.float32)
    stacked = jpeg.decode_from_layout([p.reshape(2, 2, *p.shape[1:]) for p in tp],
                                      tq.reshape(2, 2, 3, 64), layout, out_dtype=torch.float32)
    assert stacked.shape == (2, 2, layout.height, layout.width, 3)
    torch.testing.assert_close(stacked.reshape(flat.shape), flat, rtol=0, atol=0)


def test_zero_planes_decode_to_flat_gray():
    """The loader pads a short batch's planes with zeros and its quant
    tables with 1: such rows decode to 128 everywhere."""
    layout = native.JpegCoefLayout(53, 37, ((2, 2, 7, 5), (1, 1, 4, 3), (1, 1, 4, 3)))
    planes = [torch.zeros((2, bh, bw, 64), dtype=torch.int16)
              for (_, _, bw, bh) in layout.components]
    out = jpeg.decode_from_layout(planes, torch.ones((2, 3, 64), dtype=torch.int32), layout)
    assert out.shape == (2, 37, 53, 3) and bool((out == 128).all())


def test_decode_refuses_what_it_does_not_take():
    planes, qtabs, layout = native.read_jpeg_coefficients_column(_bufs("420", 2))
    tp, tq = _torch_planes(planes, qtabs)
    size = (layout.height, layout.width)
    with pytest.raises(TypeError, match="uint8 or float32"):
        jpeg.decode_coefficients(tp, tq, size, layout.sampling, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="component count"):
        jpeg.decode_coefficients(tp[:2], tq[:, :2], size, layout.sampling[:2])
    with pytest.raises(ValueError, match="does not divide"):
        jpeg.decode_coefficients(tp, tq, size, ((3, 2), (2, 1), (1, 1)))
    with pytest.raises(ValueError, match="does not cover"):
        jpeg.decode_coefficients(tp, tq, (layout.height + 16, layout.width), layout.sampling)
    # the kernel's wrapper takes CUDA tensors only: no path back to the plain version
    with pytest.raises(ValueError, match="CUDA"):
        jpeg.jpeg_decode_kernel(tp, tq, size, layout.sampling)


def test_bound_at_the_imagenet_batch():
    """Kernel B2's bound at the training batch (256 images of 224x224, 4:2:0):
    38.5 MB of coefficients read, 38.5 MB of pixels written."""
    layout = native.JpegCoefLayout(224, 224, ((2, 2, 28, 28), (1, 1, 14, 14), (1, 1, 14, 14)))
    import chip_smoke

    read, written, flops = chip_smoke.jpeg_bound(layout, 256)
    assert read == 256 * 1176 * 128 + 256 * 3 * 64 * 4
    assert written == 256 * 224 * 224 * 3
    assert 0.6e9 < flops < 1.0e9


# -- kernel B2's tiled kernel: its launch plan, on the CPU ---------------------------
#
# The tiled kernel runs only on the card (``test_torch_cuda_kernels.py`` holds
# it equal to the general kernel there); its plan is a plain function of the
# shapes, so the tiles it cuts are checked here against what the reference
# reads.

# name -> (cv2 sampling flag, (h, w), grayscale): the geometries of the card
# tests' JPEG_CASES, then a 1x1 image, 9x17, and widths around a tile's
PLAN_CASES = {
    "main-420": (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, (224, 224), False),
    "444": (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, (224, 224), False),
    "422": (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422, (224, 224), False),
    "411": (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411, (37, 53), False),
    "440": (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440, (37, 53), False),
    "gray": (None, (224, 224), True),
    "37x53": (None, (37, 53), False),
    "wide-600": (None, (40, 600), False),
    "1x1": (None, (1, 1), False),
    "9x17": (None, (9, 17), False),
    "w255": (None, (24, 255), False),
    "w256": (None, (24, 256), False),
    "w257": (None, (24, 257), False),
    "17x600": (None, (17, 600), False),
    "422-17x600": (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422, (17, 600), False),
}


def _plan_layout(name, n=1):
    flag, (h, w), gray = PLAN_CASES[name]
    bufs = [_encode(_smooth(h, w, seed, 1 if gray else 3), flag) for seed in range(n)]
    return bufs, native.jpeg_coef_layout(bufs[0])


def _reads(lo, hi, f, fancy, size):
    """The sample indices the reference reads for outputs [lo, hi) along an
    axis upsampled by f (``_upsample_to``): the triangle filter's own and
    neighbour samples, replicated at the edge, or nearest."""
    out = np.arange(lo, hi)
    if fancy:
        own = np.minimum(out // 2, size - 1)
        nb = np.clip(np.where(out % 2, out // 2 + 1, out // 2 - 1), 0, size - 1)
        return np.concatenate([own, nb])
    return out // f


@pytest.mark.parametrize("fancy", [True, False], ids=["fancy", "nearest"])
@pytest.mark.parametrize("name", list(PLAN_CASES))
def test_tile_plan_stages_exactly_the_blocks_each_tile_reads(name, fancy):
    _, layout = _plan_layout(name)
    size, sampling = (layout.height, layout.width), layout.sampling
    blocks = tuple((bh, bw) for (_, _, bw, bh) in layout.components)
    plan = jpeg.decode_launch_plan(256, size, sampling, blocks, fancy)
    max_h = max(h for h, _ in sampling)
    max_v = max(v for _, v in sampling)
    assert plan.tile_rows % (8 * max_v) == 0 and plan.tile_cols % (8 * max_h) == 0
    assert plan.tiles_y == -(-size[0] // plan.tile_rows)
    assert plan.tiles_x == -(-size[1] // plan.tile_cols)
    assert plan.stage_bytes == 256 * len(sampling) + sum(128 * r * c for r, c in plan.stage_blocks)
    assert plan.shared_bytes <= jpeg.MAX_SHARED_BYTES
    assert 1 <= plan.ctas <= 256 * plan.tiles_y * plan.tiles_x
    for ty in range(plan.tiles_y):
        for tx in range(plan.tiles_x):
            (y0, y1, x0, x1), spans = jpeg.tile_spans(plan, size, sampling, fancy, ty, tx)
            assert y1 == min(y0 + plan.tile_rows, size[0]) and x1 == min(x0 + plan.tile_cols,
                                                                       size[1])
            for c, ((h, v), span) in enumerate(zip(sampling, spans)):
                fy, fx = max_v // v, max_h // h
                ch, cw = -(-size[0] * v // max_v), -(-size[1] * h // max_h)
                rows = _reads(y0, y1, fy, fancy and fy == 2, ch)
                cols = _reads(x0, x1, fx, fancy and fx == 2, cw)
                # the samples read, their blocks staged, nothing else
                assert span.rows == (rows.min(), rows.max())
                assert span.cols == (cols.min(), cols.max())
                assert span.block_rows == (rows.min() // 8, rows.max() // 8 - rows.min() // 8 + 1)
                assert span.block_cols == (cols.min() // 8, cols.max() // 8 - cols.min() // 8 + 1)
                # inside the plane, the stage and the region
                (sb0, nsb), (sc0, nsc) = span.block_rows, span.block_cols
                bh, bw = blocks[c]
                assert 0 <= sb0 and sb0 + nsb <= bh and 0 <= sc0 and sc0 + nsc <= bw
                assert nsb <= plan.stage_blocks[c][0] and nsc <= plan.stage_blocks[c][1]
                assert span.rows[1] - span.rows[0] < plan.region_rows[c]
                assert 8 * nsc <= plan.region_strides[c]


def test_tile_plan_at_the_imagenet_batch():
    """256 x 224 x 224 at 4:2:0: tiles of one MCU row across the width; the
    chroma stages its block row and the halo rows above and below; both
    stages and the regions fit three blocks an SM (at least the two the
    kernel needs)."""
    plan = jpeg.decode_launch_plan(256, (224, 224), ((2, 2), (1, 1), (1, 1)),
                                   ((28, 28), (14, 14), (14, 14)))
    assert (plan.kind, plan.tile_rows, plan.tile_cols) == ("420", 16, 224)
    assert (plan.tiles_y, plan.tiles_x) == (14, 1)
    assert plan.stage_blocks == ((2, 28), (3, 14), (3, 14))
    assert plan.stage_bytes == 3 * 256 + 128 * (2 * 28 + 2 * 3 * 14)
    assert plan.region_rows == (16, 10, 10)
    assert plan.shared_bytes == 72192 <= jpeg.MAX_SHARED_BYTES
    per_sm = jpeg.SM_SHARED_BYTES // (plan.shared_bytes + 1024)
    assert per_sm >= 3 >= 2
    assert plan.ctas == 132 * 3
    assert plan.ints() == [16, 224, 396, plan.stage_bytes, 72192, 2, 28, 3, 14, 3, 14]


@pytest.mark.parametrize("sampling,kind", [
    (((2, 2), (1, 1), (1, 1)), ("420", "generic")),
    (((2, 1), (1, 1), (1, 1)), ("422", "generic")),
    (((1, 1), (1, 1), (1, 1)), ("444", "444")),
    (((1, 1),), ("gray", "gray")),
    (((4, 1), (1, 1), (1, 1)), ("generic", "generic")),
    (((1, 2), (1, 1), (1, 1)), ("generic", "generic")),
])
def test_tile_plan_picks_the_instance(sampling, kind):
    blocks = tuple((8 * v, 8 * h) for h, v in sampling)
    got = tuple(jpeg.decode_launch_plan(4, (64, 64), sampling, blocks, fancy).kind
                for fancy in (True, False))
    assert got == kind


def _tile_walk_decode(planes, qtabs, layout, plan, fancy):
    """Each tile of ``plan`` decoded in numpy from its staged blocks alone:
    the IDCT of those blocks (the plain version's), the tile's pixels
    upsampled from samples read only inside them, the color, the rounding."""
    size, sampling = (layout.height, layout.width), layout.sampling
    max_h = max(h for h, _ in sampling)
    max_v = max(v for _, v in sampling)
    n = qtabs.shape[0]
    out = np.zeros((n, *size, len(sampling)), np.float32)
    for ty in range(plan.tiles_y):
        for tx in range(plan.tiles_x):
            (y0, y1, x0, x1), spans = jpeg.tile_spans(plan, size, sampling, fancy, ty, tx)
            for c, ((h, v), span) in enumerate(zip(sampling, spans)):
                (sb0, nsb), (sc0, nsc) = span.block_rows, span.block_cols
                staged = torch.from_numpy(planes[c][:, sb0:sb0 + nsb, sc0:sc0 + nsc])
                samples = jpeg._idct_blocks(staged, torch.from_numpy(qtabs[:, c].astype(np.int32)))
                samples = samples.numpy()
                fy, fx = max_v // v, max_h // h
                ch, cw = -(-size[0] * v // max_v), -(-size[1] * h // max_h)

                def index(lo, hi, f, fancy_axis, extent, first):
                    o = np.arange(lo, hi)
                    if fancy_axis:
                        a = np.minimum(o // 2, extent - 1)
                        b = np.clip(np.where(o % 2, o // 2 + 1, o // 2 - 1), 0, extent - 1)
                    else:
                        a = b = o // f
                    a, b = a - 8 * first, b - 8 * first
                    assert a.min() >= 0 and b.min() >= 0  # read inside the staged blocks
                    return a, b

                ra, rb = index(y0, y1, fy, fancy and fy == 2, ch, sb0)
                ca, cb = index(x0, x1, fx, fancy and fx == 2, cw, sc0)
                assert max(ra.max(), rb.max()) < 8 * nsb and max(ca.max(), cb.max()) < 8 * nsc
                tri = lambda near, far: (np.float32(3) * near + far) * np.float32(0.25)  # noqa
                va = samples[:, ra][:, :, ca]
                vb = samples[:, ra][:, :, cb]
                if fancy and fy == 2:
                    va = tri(va, samples[:, rb][:, :, ca])
                    vb = tri(vb, samples[:, rb][:, :, cb])
                out[:, y0:y1, x0:x1, c] = tri(va, vb) if fancy and fx == 2 else va
    if len(sampling) == 3:
        out = (out - np.float32([0, 128, 128])) @ jpeg._YCC_TO_RGB.T
    return np.clip(np.round(out), 0, 255).astype(np.uint8).squeeze(-1 if len(sampling) == 1
                                                                    else ())


@pytest.mark.parametrize("fancy", [True, False], ids=["fancy", "nearest"])
@pytest.mark.parametrize("name", ["main-420", "444", "422", "411", "440", "gray", "37x53",
                                  "17x600", "422-17x600", "1x1", "9x17"])
def test_tile_walk_from_staged_blocks_matches_plain_decode(name, fancy):
    bufs, _ = _plan_layout(name, n=2)
    planes, qtabs, layout = native.read_jpeg_coefficients_column(bufs)
    size, sampling = (layout.height, layout.width), layout.sampling
    blocks = tuple(tuple(p.shape[1:3]) for p in planes)
    plan = jpeg.decode_launch_plan(2, size, sampling, blocks, fancy)
    got = _tile_walk_decode(planes, qtabs, layout, plan, fancy)
    want = jpeg._decode_reference(*_torch_planes(planes, qtabs), size, sampling,
                                  fancy_upsampling=fancy).numpy()
    assert got.shape == want.shape
    _assert_bytes_close(got, want)


def test_launch_refuses_unknown_kernels_and_cpu_tensors():
    planes, qtabs, layout = native.read_jpeg_coefficients_column(_bufs("420", 2))
    tp, tq = _torch_planes(planes, qtabs)
    size = (layout.height, layout.width)
    with pytest.raises(ValueError, match="kernel must be one of"):
        jpeg.launch_jpeg_decode(tp, tq, size, layout.sampling, kernel="fast")
    for kernel in jpeg.JPEG_DECODE_KERNELS:
        with pytest.raises(ValueError, match="CUDA"):
            jpeg.launch_jpeg_decode(tp, tq, size, layout.sampling, kernel=kernel)
    assert jpeg.JPEG_DECODE_KERNELS == ("tiled", "general")


# -- the route through the reader and the loader ---------------------------------


N_ROWS, GROUP, BATCH = 44, 6, 8


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jpeg_route") / "ds")
    schema = Schema("JpegRoute", [
        Field("label", np.int64),
        Field("image", np.uint8, (37, 53, 3), CompressedImageCodec("jpeg", quality=90)),
    ])
    write_dataset(path, schema, [{"label": i, "image": _smooth(37, 53, i)}
                                 for i in range(N_ROWS)], row_group_size_rows=GROUP)
    return path


def _port_batches(path, place, drop_last=True, **kwargs):
    reader = make_reader(path, shuffle_seed=0, num_epochs=1, workers_count=3,
                         decode_placement={"image": place}, **kwargs)
    with CudaDataLoader(reader, BATCH, device="cpu", drop_last=drop_last) as loader:
        return [dict(b) for b in loader]


def test_device_route_matches_jax_loader(dataset):
    got = _port_batches(dataset, "device")
    reader = jax_make_reader(dataset, shuffle_seed=0, num_epochs=1, workers_count=3,
                             decode_placement={"image": "device"})
    with JaxDataLoader(reader, batch_size=BATCH) as loader:
        want = [{k: np.asarray(v) for k, v in b.items()} for b in loader]
    assert len(got) == len(want) == N_ROWS // BATCH
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["label"].numpy(), w["label"])
        assert g["image"].dtype == torch.uint8 and tuple(g["image"].shape) == w["image"].shape
        _assert_bytes_close(g["image"].numpy(), w["image"])


def test_device_route_close_to_host_route(dataset):
    host = _port_batches(dataset, "host")
    device = _port_batches(dataset, "device")
    assert len(host) == len(device) == N_ROWS // BATCH
    for h, d in zip(host, device):
        assert torch.equal(h["label"], d["label"])
        assert d["image"].shape == (BATCH, 37, 53, 3) and d["image"].dtype == torch.uint8
        diff = (h["image"].int() - d["image"].int()).abs()
        assert int(diff.max()) <= 6 and float(diff.float().mean()) < 1.0


def test_device_route_pads_the_tail_with_flat_gray(dataset):
    batches = _port_batches(dataset, "device", drop_last=False)
    host = _port_batches(dataset, "host", drop_last=False)
    tail, valid = batches[-1], N_ROWS % BATCH
    assert tail[VALID_ROWS] == host[-1][VALID_ROWS] == valid
    assert bool((tail["image"][valid:] == 128).all())
    assert not tail["label"][valid:].any()
    diff = (tail["image"][:valid].int() - host[-1]["image"][:valid].int()).abs()
    assert int(diff.max()) <= 6


def test_grayscale_hw1_field_keeps_rank(tmp_path):
    schema = Schema("G", [Field("image", np.uint8, (32, 48, 1), CompressedImageCodec("jpeg"))])
    path = str(tmp_path / "ds")
    write_dataset(path, schema, [{"image": _smooth(32, 48, i)[..., :1]} for i in range(8)])
    batches = _port_batches(path, "device")
    assert batches[0]["image"].shape == (8, 32, 48, 1)
    host = _port_batches(path, "host")
    assert int((batches[0]["image"].int() - host[0]["image"].int()).abs().max()) <= 6


def test_host_placement_is_the_plain_route(dataset):
    reader = make_reader(dataset, num_epochs=1, decode_placement={"image": "host"})
    with reader:
        assert reader.device_decode_fields == []
        row = next(reader)
    assert row.image.shape == (37, 53, 3)


# -- what the reader refuses ------------------------------------------------------


def test_decode_placement_validation_errors(dataset, tmp_path):
    with pytest.raises(PetastormTpuError, match="not in"):
        make_batch_reader(dataset, decode_placement={"imge": "host"})  # typo
    with pytest.raises(PetastormTpuError, match="not being read"):
        make_reader(dataset, schema_fields=["label"], decode_placement={"image": "device"})
    with pytest.raises(PetastormTpuError, match="'host', 'device', 'device-mixed' or 'auto'"):
        make_reader(dataset, decode_placement={"image": "chip"})
    with pytest.raises(PetastormTpuError, match="jpeg"):
        make_reader(dataset, decode_placement={"label": "device"})
    png = Schema("P", [Field("image", np.uint8, (16, 16, 3), CompressedImageCodec("png"))])
    write_dataset(str(tmp_path / "png"), png, [{"image": _smooth(16, 16, 0)}])
    with pytest.raises(PetastormTpuError, match="PNG"):
        make_reader(str(tmp_path / "png"), decode_placement={"image": "device"})
    var = Schema("V", [Field("image", np.uint8, (None, None, 3), CompressedImageCodec("jpeg"))])
    write_dataset(str(tmp_path / "var"), var, [{"image": _smooth(16, 24, 0)}])
    for place in ("device", "auto"):
        with pytest.raises(PetastormTpuError, match="fixed shape"):
            make_reader(str(tmp_path / "var"), decode_placement={"image": place})


def test_rows_of_a_device_field_are_refused(dataset):
    for factory in (make_reader, make_batch_reader):
        with factory(dataset, num_epochs=1, decode_placement={"image": "device"}) as reader:
            assert reader.device_decode_fields == ["image"]
            with pytest.raises(PetastormTpuError, match="CudaDataLoader"):
                next(reader)


def _write_raw(tmp_path, bufs, rows_per_group, shape=(64, 96, 3)):
    """A dataset of hand-encoded JPEG bytes (the writer would re-encode them)."""
    schema = Schema("Raw", [Field("idx", np.int64),
                            Field("image", np.uint8, shape, CompressedImageCodec("jpeg"))])
    path = str(tmp_path / "raw")
    os.makedirs(path)
    table = pa.Table.from_pylist([{"idx": i, "image": b} for i, b in enumerate(bufs)],
                                 schema=schema.as_arrow_schema())
    pq.write_table(table, os.path.join(path, "part-00000.parquet"),
                   row_group_size=rows_per_group)
    stamp_dataset_metadata(path, schema)
    return path


def _drain(path, batch):
    reader = make_reader(path, num_epochs=1, shuffle_row_groups=False,
                         decode_placement={"image": "device"})
    with CudaDataLoader(reader, batch, device="cpu") as loader:
        return list(loader)


def test_mixed_geometry_within_rowgroup_diagnosed(tmp_path):
    bufs = _bufs("420", 6)
    bufs[3] = _bufs("444", 4)[3]
    path = _write_raw(tmp_path, bufs, rows_per_group=6)
    # a worker's failure reaches the consumer of the thread pool as the JAX
    # pool delivers it: a WorkerError naming the worker's exception type
    with pytest.raises(WorkerError, match=r"cell 3 has geometry.*decode_placement='host'") as info:
        _drain(path, 6)
    assert info.value.exc_type == "CodecError"
    assert isinstance(info.value.__cause__, CodecError)


def test_mixed_geometry_across_rowgroups_guided(tmp_path):
    path = _write_raw(tmp_path, _bufs("420", 4) + _bufs("444", 4), rows_per_group=4)
    with pytest.raises(CodecError, match="changes between rowgroups.*decode_placement='host'"):
        _drain(path, 8)


def test_corrupt_jpeg_cell_diagnosed(tmp_path):
    bufs = _bufs("420", 4)
    bufs[2] = bufs[2][:40]  # cut inside the header
    path = _write_raw(tmp_path, bufs, rows_per_group=4)
    with pytest.raises(WorkerError,
                       match="cell 2 is not a decodable jpeg.*corrupt or truncated") as info:
        _drain(path, 4)
    assert info.value.exc_type == "CodecError"
    assert isinstance(info.value.__cause__, CodecError)


def test_wrong_size_jpeg_raises_clear_error(tmp_path):
    path = _write_raw(tmp_path, _bufs("420", 4), rows_per_group=4, shape=(32, 96, 3))
    with pytest.raises(WorkerError, match="schema says") as info:
        _drain(path, 4)
    assert info.value.exc_type == "CodecError"
    assert isinstance(info.value.__cause__, CodecError)
