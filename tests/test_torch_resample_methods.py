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
* ``nearest``: exact (a gather).

An unknown method raises ``ValueError`` in both packages, and so does
``random_resized_crop(method='nearest')``, with jax's messages.  The
``cuda``-marked tests hold each kernel (the general kernel's cubic,
Lanczos 3 and Lanczos 5 instances, uint8 and float32, and the nearest
gather) against its plain version on the card, within the uint8 bound above
and 1e-5 of max|x| for float32, and count their launches.
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


def _assert_close(got, want, dtype, float_bound):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    if dtype == np.uint8:
        assert diff.max() <= 1, diff.max()
        assert np.mean(diff > 0) <= 0.01, np.mean(diff > 0)
    else:
        assert diff.max() <= float_bound * 255, diff.max()


@needs_jax
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=["uint8", "float32"])
@pytest.mark.parametrize("shape,out_hw", [
    ((3, 64, 48, 3), (32, 20)), ((2, 40, 30, 3), (80, 70)), ((2, 31, 17, 1), (31, 9)),
    ((2, 20, 17, 2), (9, 17)), ((2, 12, 10, 3), (12, 10))],
    ids=["down", "up", "rows-kept", "cols-kept", "identity"])
def test_resize_images_matches_jax(method, antialias, dtype, shape, out_hw):
    images = _images(5, shape, dtype)
    want = np.asarray(jax_augment.resize_images(jnp.asarray(images), out_hw, method=method,
                                                antialias=antialias))
    got = augment.resize_images(torch.from_numpy(images), out_hw, method=method,
                                antialias=antialias)
    assert got.dtype == torch.from_numpy(images).dtype
    _assert_close(got.numpy(), want, dtype, 1e-5)


@needs_jax
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=["uint8", "float32"])
@pytest.mark.parametrize("seed", [0, 1])
def test_random_resized_crop_matches_jax(method, antialias, dtype, seed):
    shape, out_hw = (4, 64, 80, 3), (40, 40)
    images = _images(seed, shape, dtype)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax_augment.random_resized_crop(jnp.asarray(images), key, out_hw,
                                                      method=method, antialias=antialias))
    got = augment.random_resized_crop(torch.from_numpy(images), None, out_hw, method=method,
                                      antialias=antialias, boxes=_jax_boxes(key, *shape[:3]))
    _assert_close(got.numpy(), want, dtype, 2e-5)


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
@pytest.mark.parametrize("dtype", [np.uint8, np.float32, np.int16], ids=str)
@pytest.mark.parametrize("shape,out_hw", [((3, 64, 48, 3), (32, 20)), ((2, 40, 30, 3), (80, 70)),
                                          ((2, 7, 5, 2), (7, 13)), ((1, 5, 9, 1), (160, 2))],
                         ids=["down", "up", "one-axis", "far-up"])
@pytest.mark.parametrize("antialias", [False, True])
def test_resize_nearest_matches_jax_exactly(dtype, shape, out_hw, antialias):
    images = _images(9, shape, np.uint8).astype(dtype)
    want = np.asarray(jax_augment.resize_images(jnp.asarray(images), out_hw, method="nearest",
                                                antialias=antialias))
    got = augment.resize_images(torch.from_numpy(images), out_hw, method="nearest",
                                antialias=antialias)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


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
    for kernel, method in (("tiled", "cubic"), ("aa", "lanczos3"), ("general", "bicubic")):
        with pytest.raises(ValueError, match=f"cannot take method '{method}'"):
            augment.launch_resized_crop(x, params, None, (4, 4), kernel == "aa", kernel,
                                        method=method)
    k = augment.resized_crop_kernel
    launches = (k.launches, k.launches_lanczos3, augment.nearest_kernel.launches)
    augment.resize_images(x, (4, 4), method="lanczos3")
    augment.resize_images(x, (4, 4), method="nearest")
    assert (k.launches, k.launches_lanczos3, augment.nearest_kernel.launches) == launches


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
    for images in (x, x.float()):
        before = getattr(augment.resized_crop_kernel, f"launches_{method}")
        got = augment.random_resized_crop(images, None, out_hw, method=method,
                                          antialias=antialias, boxes=boxes, flips=flips)
        assert getattr(augment.resized_crop_kernel, f"launches_{method}") == before + 1
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
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32, torch.int16], ids=str)
@pytest.mark.parametrize("shape,out_hw", [((4, 64, 48, 3), (32, 20)), ((3, 17, 23, 5), (51, 7))])
def test_the_nearest_kernel_matches_the_plain_version_on_the_card(dtype, shape, out_hw):
    gen = _card()
    x = torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda", generator=gen).to(dtype)
    before = augment.nearest_kernel.launches
    got = augment.resize_images(x, out_hw, method="nearest")
    assert augment.nearest_kernel.launches == before + 1
    assert torch.equal(got, augment._resize_nearest_reference(x, out_hw))
