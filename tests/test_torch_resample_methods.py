"""The port's cubic, Lanczos and nearest resampling against the JAX package's,
on the CPU, and the card's kernels against their plain versions.

``resize_images`` and ``random_resized_crop`` with ``method=`` ``cubic``
(and its aliases ``bicubic``, ``tricubic``), ``lanczos3`` and ``lanczos5``,
antialias off and on, and ``resize_images(method='nearest')``, against
``petastorm_tpu/ops/augment.py`` on the same images and crop boxes (the
JAX op's draws, re-derived from its key).  Tolerances:

* uint8: at most 1 LSB apart on at most 1 % of bytes.  The weights are the
  same float32 expressions, but XLA rewrites a division by a constant into
  a product with its reciprocal, sums in another order and evaluates ``sin``
  with its own polynomial, which moves a float32 sum by an ulp and so a
  byte at a .5 boundary.  Measured: at most 0.17 % of bytes.
* float32 ``resize_images``: within 1e-5 of max|x| (measured 6.6e-7).
* float32 ``random_resized_crop``: within 2e-5 of max|x| (measured
  8.7e-6): as for bilinear, the compiled JAX op's sample positions can lie
  an ulp from the port's, and on random images a one-ulp shift of a sample
  near 60 moves an output by about 255 x 4e-6.
* float16 and bfloat16 (both packages resample in float32 and cast back):
  the float32 bound, plus one ulp of the type at 255 (0.125 and 1), or at
  the value where a cubic or Lanczos lobe overshoots past 256: two float32
  sums that far apart may round to neighbouring values of the type.
* ``nearest``: exact (a gather).

An unknown method raises ``ValueError`` in both packages, and so does
``random_resized_crop(method='nearest')``, with jax's messages.  The
separable tiled kernel's launch plan (``augment.aa_launch_plan``) is checked
here: its tap tables and spans hold every nonzero tap of the plain weight
matrices, and it is a plan the kernel's entry takes at any shape.  The
``cuda``-marked tests hold each kernel (the separable tiled kernel with the
cubic, Lanczos 3 and Lanczos 5 filters for uint8 and float32, and the
nearest gather) against its plain version on the card, within the uint8
bound above and 1e-5 of max|x| for float32, the separable kernel against the
general kernel's uint8 instance byte for byte, and count their launches.
Which kernel and element type each dtype and filter takes is pinned on the
CPU (``augment.resample_route``).
"""

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from petastorm_tpu.ops import augment as jax_augment
    from test_torch_augment import _jax_boxes, _jax_flips
except ImportError:  # the card has no jax: only its cuda tests run there
    jax = None

from petastorm_tpu_torch.ops import augment

needs_jax = pytest.mark.skipif(jax is None, reason="the JAX reference is not installed")

METHODS = ["cubic", "bicubic", "tricubic", "lanczos3", "lanczos5"]


def _images(seed, shape, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return (rng.random(shape) * 255).astype(dtype)


#: the mantissa bits of the narrow float types the tests take, by name
_NARROW = {"float16": 10, "bfloat16": 7}
FLOAT_DTYPES = ["float32", "float16", "bfloat16"]


def _float_pair(seed, shape, dtype):
    """The same images in ``dtype`` (a name of ``FLOAT_DTYPES``) for JAX and
    for the port: values of [0, 255) made in float32 and cast by JAX."""
    images = jnp.asarray(_images(seed, shape, np.float32)).astype(dtype)
    return images, torch.from_numpy(np.array(images.astype(jnp.float32))).to(
        getattr(torch, dtype))


def _assert_close(got, want, dtype, float_bound):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    if dtype == np.uint8:
        assert diff.max() <= 1, diff.max()
        assert np.mean(diff > 0) <= 0.01, np.mean(diff > 0)
    else:
        bound = float_bound * 255
        if dtype in _NARROW:  # one ulp of the type at max(|want|, 255)
            exp = np.floor(np.log2(np.maximum(np.abs(want), 255.0)))
            bound = bound + 2.0 ** (exp - _NARROW[dtype])
        assert (diff <= bound).all(), diff.max()


def _inputs(seed, shape, dtype):
    """(JAX images, port images) of ``dtype``: np.uint8, np.float32 or a
    name of ``_NARROW``."""
    if dtype in _NARROW:
        return _float_pair(seed, shape, dtype)
    images = _images(seed, shape, dtype)
    return jnp.asarray(images), torch.from_numpy(images)


def _port_values(got):
    return got.float().numpy() if got.dtype == torch.bfloat16 else got.numpy()


_DTYPES = [np.uint8, np.float32, "float16", "bfloat16"]
_DTYPE_IDS = ["uint8", "float32", "float16", "bfloat16"]


@needs_jax
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize("dtype", _DTYPES, ids=_DTYPE_IDS)
@pytest.mark.parametrize("shape,out_hw", [
    ((3, 64, 48, 3), (32, 20)), ((2, 40, 30, 3), (80, 70)), ((2, 31, 17, 1), (31, 9)),
    ((2, 20, 17, 2), (9, 17)), ((2, 12, 10, 3), (12, 10))],
    ids=["down", "up", "rows-kept", "cols-kept", "identity"])
def test_resize_images_matches_jax(method, antialias, dtype, shape, out_hw):
    jax_images, images = _inputs(5, shape, dtype)
    want = jax_augment.resize_images(jax_images, out_hw, method=method, antialias=antialias)
    got = augment.resize_images(images, out_hw, method=method, antialias=antialias)
    assert got.dtype == images.dtype and str(want.dtype) == str(images.dtype).split(".")[1]
    _assert_close(_port_values(got), np.asarray(want.astype(jnp.float32)), dtype, 1e-5)


@needs_jax
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize("dtype", _DTYPES, ids=_DTYPE_IDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_random_resized_crop_matches_jax(method, antialias, dtype, seed):
    shape, out_hw = (4, 64, 80, 3), (40, 40)
    jax_images, images = _inputs(seed, shape, dtype)
    key = jax.random.PRNGKey(seed)
    want = jax_augment.random_resized_crop(jax_images, key, out_hw, method=method,
                                           antialias=antialias)
    got = augment.random_resized_crop(images, None, out_hw, method=method,
                                      antialias=antialias, boxes=_jax_boxes(key, *shape[:3]))
    assert got.dtype == images.dtype and str(want.dtype) == str(images.dtype).split(".")[1]
    _assert_close(_port_values(got), np.asarray(want.astype(jnp.float32)), dtype, 2e-5)


@needs_jax
@pytest.mark.parametrize("method", ["cubic", "lanczos3", "lanczos5"])
def test_random_resized_crop_flips_after_the_crop_as_jax(method):
    images = _images(4, (6, 40, 36, 3))
    key = jax.random.PRNGKey(4)
    k1, k2 = jax.random.split(key)
    want = np.asarray(jax_augment.random_flip(
        jax_augment.random_resized_crop(jnp.asarray(images), k1, (24, 24), method=method), k2))
    got = augment.random_resized_crop(torch.from_numpy(images), None, (24, 24), method=method,
                                      boxes=_jax_boxes(k1, 6, 40, 36), flips=_jax_flips(k2, 6))
    _assert_close(got.numpy(), want, np.uint8, 0)


@needs_jax
@pytest.mark.parametrize("dtype", [np.uint8, np.float32, np.int16, "float16", "bfloat16"],
                         ids=str)
@pytest.mark.parametrize("shape,out_hw", [((3, 64, 48, 3), (32, 20)), ((2, 40, 30, 3), (80, 70)),
                                          ((2, 7, 5, 2), (7, 13)), ((1, 5, 9, 1), (160, 2))],
                         ids=["down", "up", "one-axis", "far-up"])
@pytest.mark.parametrize("antialias", [False, True])
def test_resize_nearest_matches_jax_exactly(dtype, shape, out_hw, antialias):
    if dtype in _NARROW:
        jax_images, images = _float_pair(9, shape, dtype)
    else:
        jax_images = jnp.asarray(_images(9, shape, np.uint8).astype(dtype))
        images = torch.from_numpy(np.array(jax_images))
    want = jax_augment.resize_images(jax_images, out_hw, method="nearest", antialias=antialias)
    got = augment.resize_images(images, out_hw, method="nearest", antialias=antialias)
    assert got.dtype == images.dtype and str(want.dtype) == str(images.dtype).split(".")[1]
    np.testing.assert_array_equal(_port_values(got), np.asarray(want.astype(jnp.float32)))


@needs_jax
@pytest.mark.parametrize("method", ["nearest", "bogus", "Cubic", "lanczos4", ""])
def test_refusals_match_jax(method):
    images = np.zeros((1, 8, 8, 3), np.uint8)
    key = jax.random.PRNGKey(0)
    calls = [(lambda: jax_augment.random_resized_crop(jnp.asarray(images), key, (4, 4),
                                                      method=method),
              lambda: augment.random_resized_crop(torch.from_numpy(images), None, (4, 4),
                                                  method=method,
                                                  boxes=torch.tensor([[0.0, 0.0, 8.0, 8.0]])))]
    if method != "nearest":
        calls.append((lambda: jax_augment.resize_images(jnp.asarray(images), (4, 4),
                                                        method=method),
                      lambda: augment.resize_images(torch.from_numpy(images), (4, 4),
                                                    method=method)))
    for jax_call, port_call in calls:
        with pytest.raises(ValueError) as want:
            jax_call()
        with pytest.raises(ValueError) as got:
            port_call()
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("names,method", [
    (("linear", "bilinear", "trilinear", "triangle"), "linear"),
    (("cubic", "bicubic", "tricubic"), "cubic"), (("lanczos3",), "lanczos3"),
    (("lanczos5",), "lanczos5"), (("nearest",), "nearest")])
def test_method_names_are_jax_image_resize_methods(names, method):
    for name in names:
        assert augment.resize_method(name) == method
    if jax is not None:
        for name in names:
            assert (jax.image.ResizeMethod.from_string(name).name.lower()
                    == {"linear": "linear", "cubic": "cubic"}.get(method, method))


def test_the_filters_are_jaxs_kernel_functions():
    if jax is None:
        pytest.skip("the JAX reference is not installed")
    from jax._src.image import scale as jax_scale

    x = np.concatenate([np.linspace(0, 6, 601, dtype=np.float32),
                        np.float32([1e-4, 1e-3, 2e-3, 3.0, 5.0, 5.0001])])
    for method, fn in [("linear", jax_scale._fill_triangle_kernel),
                       ("cubic", jax_scale._fill_keys_cubic_kernel),
                       ("lanczos3", lambda v: jax_scale._fill_lanczos_kernel(3.0, v)),
                       ("lanczos5", lambda v: jax_scale._fill_lanczos_kernel(5.0, v))]:
        got = augment._filter(method, torch.from_numpy(x)).numpy()
        want = np.asarray(jax.jit(fn)(x))
        np.testing.assert_allclose(got, want, rtol=0, atol=4e-7, err_msg=method)


def test_the_plain_versions_take_cpu_tensors_and_the_kernels_refuse_them():
    x = torch.zeros((2, 8, 8, 3), dtype=torch.uint8)
    params = torch.tensor([[1.0, 0.0, 1.0, 0.0]] * 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        augment.launch_resized_crop(x, params, None, (4, 4), False, "general", method="cubic")
    with pytest.raises(ValueError, match="CUDA tensor"):
        augment.nearest_kernel(x, (4, 4))
    for kernel, method in (("tiled", "cubic"), ("tiled", "lanczos3"), ("aa", "bicubic"),
                           ("general", "bicubic")):
        with pytest.raises(ValueError, match=f"cannot take method '{method}'"):
            augment.launch_resized_crop(x, params, None, (4, 4), kernel == "aa", kernel,
                                        method=method)
    with pytest.raises(ValueError, match="CUDA tensor"):
        augment.launch_resized_crop(x, params, None, (4, 4), False, "aa", method="lanczos3")
    k = augment.resized_crop_kernel
    launches = (k.launches, k.launches_lanczos3, augment.nearest_kernel.launches)
    augment.resize_images(x, (4, 4), method="lanczos3")
    augment.resize_images(x, (4, 4), method="nearest")
    assert (k.launches, k.launches_lanczos3, augment.nearest_kernel.launches) == launches


# -- the route a CUDA image takes -------------------------------------------------------------

_ELEMENT_DTYPES = [torch.uint8, torch.float32, torch.float16, torch.bfloat16]
_ROUND_TRIP_DTYPES = [torch.int8, torch.int16, torch.int32, torch.int64, torch.float64]


@pytest.mark.parametrize("dtype", _ELEMENT_DTYPES + _ROUND_TRIP_DTYPES, ids=str)
@pytest.mark.parametrize("method", ["linear", "cubic", "lanczos3", "lanczos5", "nearest"])
@pytest.mark.parametrize("antialias", [False, True])
def test_the_route_of_every_dtype_and_filter(dtype, method, antialias):
    """Which kernel a CUDA image takes, and in which dtype: bilinear without
    antialias the tiled kernel, any other filter the separable tiled kernel,
    nearest the gather; uint8, float32, float16 and bfloat16 in their own
    instances, other dtypes through float32 (the gather also moves int8 and
    int16 as they are)."""
    kernel, kernel_dtype = augment.resample_route(dtype, method, antialias)
    assert kernel == ("nearest" if method == "nearest"
                      else "tiled" if method == "linear" and not antialias else "aa")
    as_is = (_ELEMENT_DTYPES + [torch.int8, torch.int16] if method == "nearest"
             else _ELEMENT_DTYPES)
    assert kernel_dtype == (dtype if dtype in as_is else torch.float32)
    if kernel != "nearest":
        # the entries of csrc/resized_crop.cu the wrapper calls for it
        assert augment.ELEMENTS[kernel_dtype] == {
            torch.uint8: "u8", torch.float32: "f32", torch.float16: "f16",
            torch.bfloat16: "bf16"}[kernel_dtype]


def test_the_route_refuses_an_unknown_filter():
    with pytest.raises(ValueError, match="Unknown resize method"):
        augment.resample_route(torch.float32, "bilinear", False)  # a name, not a filter


def test_every_element_type_has_its_launch_counts():
    k = augment.resized_crop_kernel
    for kernel in ("tiled", "separable"):
        for element in augment.ELEMENTS.values():
            assert f"_{kernel}_{element}" in augment.LAUNCH_COUNTERS
            assert getattr(k, f"launches_{kernel}_{element}") >= 0


# -- the separable tiled kernel's launch plan -------------------------------------------------

def _nonzero_ranges(mats):
    """(first, last) nonzero tap of every output position of (N, in, out)
    weight matrices, and whether it has any."""
    nz = mats != 0
    any_ = nz.any(1)
    idx = torch.arange(mats.shape[1])[None, :, None]
    first = torch.where(nz, idx, mats.shape[1]).min(1).values
    last = torch.where(nz, idx, -1).max(1).values
    return first, last, any_


@pytest.mark.parametrize("method", ["linear", "cubic", "lanczos3", "lanczos5"])
@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize("hw", [(64, 48), (37, 91)], ids=["64x48", "37x91"])
def test_the_plan_holds_every_nonzero_tap(method, antialias, hw):
    """For drawn and full-image boxes and resize_images' params, at scales
    from 0.05 to 4: every output row's and column's taps, from its first to
    its last nonzero weight, fit the plan's tables (cap_y, cap_x), and the
    taps of every column tile fit one span."""
    h, w = hw
    gen = torch.Generator().manual_seed(h * w)
    n = 24
    for scale in (0.05, 0.1, 0.3, 0.55, 0.9, 1.0, 1.7, 4.0):
        oh, ow = max(1, round(h * scale)), max(1, round(w * scale))
        plan = augment.aa_launch_plan(h, w, 3, oh, ow, method, antialias)
        params = [augment.crop_params(augment.draw_crop_boxes(n, h, w, gen, device="cpu"),
                                      (oh, ow)),
                  augment.crop_params(augment.draw_crop_boxes(n, h, w, gen, scale=(1.0, 1.0),
                                                              device="cpu"), (oh, ow)),
                  torch.tensor([1.0 / (oh / h), 0.0, 1.0 / (ow / w), 0.0]).expand(n, 4)]
        for p in params:
            for size, out, col, cap in ((h, oh, 0, plan.cap_y), (w, ow, 2, plan.cap_x)):
                mats = augment._weight_mats(size, out, p[:, col], p[:, col + 1], antialias,
                                            method)
                first, last, any_ = _nonzero_ranges(mats)
                taps = torch.where(any_, last - first + 1, 0)
                assert int(taps.max()) <= cap, (scale, col, int(taps.max()), cap)
                if col == 2:  # each tile of plan.cols columns within one span
                    for x0 in range(0, ow, plan.cols):
                        tile = slice(x0, x0 + plan.cols)
                        if bool(any_[:, tile].any()):
                            lo = torch.where(any_[:, tile], first[:, tile], w).min(1).values
                            hi = torch.where(any_[:, tile], last[:, tile], -1).max(1).values
                            assert int((hi - lo + 1).max()) <= plan.span, (scale, x0)


@pytest.mark.parametrize("method", ["linear", "cubic", "lanczos3", "lanczos5"])
@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize("shape", [
    (256, 256, 3, 224, 224), (224, 224, 3, 160, 160), (1, 20, 3, 1, 13), (5, 1, 672, 9, 1),
    (7, 9, 3, 300, 2), (16, 4096, 3, 16, 16), (8, 8, 70000, 8, 8), (10 ** 6, 10 ** 6, 3, 1, 1),
    (1, 2 ** 20, 4, 1, 3), (5000, 5000, 64, 2, 2), (3, 3, 1, 2 ** 20, 2 ** 20)], ids=str)
def test_the_plan_is_one_the_separable_entry_takes(method, antialias, shape):
    """Every shape the general kernel takes gets a plan that
    ``pst_resample_separable_u8`` accepts (its checks, in
    csrc/resized_crop.cu): positive sizes, a channel group of at most 4 and
    of no more than the channels, and a block's shared memory; the kernel
    walks longer spans in chunks and computes taps past a table."""
    h, w, c, oh, ow = shape
    plan = augment.aa_launch_plan(h, w, c, oh, ow, method, antialias)
    assert min(plan.rows, plan.cols, plan.cap_y, plan.cap_x, plan.span) >= 1
    assert 1 <= plan.group <= min(4, c)
    assert plan.shared_bytes <= augment.AA_MAX_SHARED_BYTES
    assert plan.rows <= oh and plan.cols <= ow
    assert plan.scratch_bytes(2, oh, ow) > 0


def test_the_plan_keeps_the_bilinear_plan_and_widens_for_wider_filters():
    assert (augment.aa_launch_plan(256, 256, 3, 224, 224)
            == augment.aa_launch_plan(256, 256, 3, 224, 224, "linear", True))
    caps = [augment.aa_launch_plan(224, 224, 3, 160, 160, m, True).cap_x
            for m in ("linear", "cubic", "lanczos3", "lanczos5")]
    assert caps == sorted(caps) and caps[-1] >= 15  # Lanczos 5 at 224 -> 160: ~15 taps
    assert augment.aa_launch_plan(256, 256, 3, 224, 224, "lanczos5", False).cap_x >= 11


# -- on the card ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["cubic", "lanczos3", "lanczos5"])
@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize("shape,out_hw,scale", [
    ((8, 96, 128, 3), (64, 64), (0.08, 1.0)), ((5, 33, 37, 1), (50, 61), (0.08, 1.0)),
    ((3, 300, 517, 3), (37, 301), (0.5, 1.0)), ((2, 40, 50, 5), (19, 30), (1.0, 1.0))])
def test_the_resample_kernels_match_the_plain_version_on_the_card(method, antialias, shape,
                                                                  out_hw, scale):
    gen = _card()
    n, h, w, _ = shape
    x = torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda", generator=gen)
    boxes = augment.draw_crop_boxes(n, h, w, gen, scale=scale, device="cuda")
    flips = augment.draw_flips(n, gen, "cuda")
    params = augment.crop_params(boxes, out_hw)
    # uint8 and float32 take the separable kernel's instances, the general kernel none
    k = augment.resized_crop_kernel
    for images, element in ((x, "u8"), (x.float(), "f32")):
        counters = (f"launches_{method}", f"launches_separable_{element}",
                    f"launches_general_{method}")
        before = [getattr(k, c) for c in counters]
        got = augment.random_resized_crop(images, None, out_hw, method=method,
                                          antialias=antialias, boxes=boxes, flips=flips)
        assert [getattr(k, c) for c in counters] == [before[0] + 1, before[1] + 1, before[2]]
        want = augment._resized_crop_reference(images, params, flips, out_hw, antialias, method)
        assert got.dtype == images.dtype and got.is_cuda
        _assert_close(got.cpu().numpy(), want.cpu().numpy(),
                      np.uint8 if images.dtype == torch.uint8 else np.float32, 1e-5)
    resized = augment.resize_images(x, out_hw, method=method, antialias=antialias)
    inv = torch.tensor([1.0 / (out_hw[0] / h), 0.0, 1.0 / (out_hw[1] / w), 0.0],
                       device="cuda").expand(n, 4)
    _assert_close(resized.cpu().numpy(), augment._resized_crop_reference(
        x, inv, None, out_hw, antialias, method).cpu().numpy(), np.uint8, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["cubic", "lanczos3", "lanczos5"])
@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize("shape,out_hw,scale", [
    ((8, 96, 128, 3), (64, 64), (0.08, 1.0)), ((5, 33, 37, 1), (50, 61), (0.08, 1.0)),
    ((3, 300, 517, 3), (37, 301), (0.5, 1.0)), ((2, 40, 50, 5), (19, 30), (1.0, 1.0))])
def test_the_separable_kernel_equals_the_general_kernel_on_the_card(method, antialias, shape,
                                                                    out_hw, scale):
    """The separable tiled kernel gives the general kernel's uint8 instance's
    bytes (its byte oracle), with flips and without, through the wrapper and
    through resize_images; the oracle's own counter counts its launches."""
    gen = _card()
    n, h, w, _ = shape
    x = torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda", generator=gen)
    boxes = augment.draw_crop_boxes(n, h, w, gen, scale=scale, device="cuda")
    params = augment.crop_params(boxes, out_hw)
    resize = torch.tensor([1.0 / (out_hw[0] / h), 0.0, 1.0 / (out_hw[1] / w), 0.0],
                          device="cuda").expand(n, 4)
    k = augment.resized_crop_kernel
    for p, flips in ((params, augment.draw_flips(n, gen, "cuda")), (params, None), (resize, None)):
        new = augment.launch_resized_crop(x, p, flips, out_hw, antialias, kernel="aa",
                                          method=method)
        before = getattr(k, f"launches_general_{method}")
        oracle = augment.launch_resized_crop(x, p, flips, out_hw, antialias, kernel="general",
                                             method=method)
        assert getattr(k, f"launches_general_{method}") == before + 1
        assert torch.equal(new, oracle)
    assert torch.equal(augment.resize_images(x, out_hw, method=method, antialias=antialias),
                       oracle)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32, torch.int16], ids=str)
@pytest.mark.parametrize("shape,out_hw", [
    ((4, 64, 48, 3), (32, 20)), ((3, 17, 23, 5), (51, 7)), ((3, 17, 23, 1), (40, 60)),
    ((2, 40, 30, 3), (80, 70)), ((2, 1, 9, 3), (5, 1)), ((2, 7, 1, 5), (1, 13)),
    ((2, 224, 224, 3), (160, 160)), ((1, 3, 5000, 1), (2, 4100))],
    ids=["down", "C=5", "C=1-up", "up", "one-row", "one-column", "eval", "wide"])
def test_the_nearest_kernel_matches_the_plain_version_on_the_card(dtype, shape, out_hw):
    gen = _card()
    x = torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda", generator=gen).to(dtype)
    before = augment.nearest_kernel.launches
    got = augment.resize_images(x, out_hw, method="nearest")
    assert augment.nearest_kernel.launches == before + 1
    assert torch.equal(got, augment._resize_nearest_reference(x, out_hw))
