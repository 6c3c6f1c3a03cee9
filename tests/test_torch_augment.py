"""The port's augmentation ops against the JAX package's, on the CPU.

Each JAX op draws from a key; the test re-derives those draws with the same
``jax.random`` calls as ``petastorm_tpu/ops/augment.py`` and hands them to the
port's explicit-draws form, so both compute the same function.

Tolerances:

* ``random_crop``, ``random_flip``, ``random_crop_flip``, ``cutmix``: pure
  selections, exact (``cutmix``'s kept-area ``lam`` too).
* ``random_resized_crop``: at most 1 LSB apart, at most 0.1 % of bytes
  differing.  The weight matrices are bit-identical; the two sides sum the
  products in other orders (XLA's dot against torch's ``einsum``, with and
  without FMAs), which moves a float32 sum by an ulp, and that changes the
  rounded byte only where the sum sits at a .5 boundary.  Measured over the
  four shapes and seeds here: at most 0.028 % of bytes differ (the 224x224
  batch), 0.0 % at the antialiased shape.
* ``resize_images`` uint8: at most 1 LSB apart, at most 1 % of bytes.  The
  scale is static here, and XLA folds and rewrites the constant weight
  matrices (a division by a constant becomes a product with its reciprocal),
  so antialiased downscales carry weights an ulp off the written formula; and
  a fixed rational scale puts many outputs near exact .5 values, where the
  summation order decides the rounded byte.  Measured at most 0.54 % (3 of
  558 bytes, the 31x17 -> 31x9 one-axis downscale), 0.14 % on the larger
  shapes.  float32: within 8 float32 ulp of 256 (2.4e-4): the same weight
  and summation-order differences over up to 5 antialiased taps per axis
  (measured at most 4 ulp).
* ``mixup`` uint8: at most 1 LSB, at most 0.1 % of bytes (XLA fuses
  ``lam * x + (1 - lam) * y`` and may contract it into an FMA; torch rounds
  each product; measured 0.0 %).  float32: within 2 float32 ulp of 255.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petastorm_tpu.ops import augment as jax_augment
from petastorm_tpu_torch.ops import augment


def _jax_boxes(key, n, h, w, scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0)):
    """The crop boxes of ``augment.py:166-178`` for ``key``, as (N, 4) ``(y0, x0, crop_h, crop_w)``."""
    @jax.jit
    def draw(key):
        k_area, k_ratio, k_y, k_x = jax.random.split(key, 4)
        area_frac = jax.random.uniform(k_area, (n,), minval=scale[0], maxval=scale[1])
        log_r = jax.random.uniform(k_ratio, (n,), minval=jnp.log(ratio[0]),
                                   maxval=jnp.log(ratio[1]))
        r = jnp.exp(log_r)
        area = area_frac * (h * w)
        crop_w = jnp.clip(jnp.sqrt(area * r), 1.0, float(w))
        crop_h = jnp.clip(jnp.sqrt(area / r), 1.0, float(h))
        y0 = jax.random.uniform(k_y, (n,)) * (h - crop_h)
        x0 = jax.random.uniform(k_x, (n,)) * (w - crop_w)
        return jnp.stack([y0, x0, crop_h, crop_w], axis=1)

    return torch.from_numpy(np.array(draw(key)))


def _jax_flips(key, n):
    return torch.from_numpy(np.array(jax.random.bernoulli(key, 0.5, (n,))))


def _jax_offsets(key, n, h, w, crop_hw):
    ky, kx = jax.random.split(key)
    return (torch.from_numpy(np.array(jax.random.randint(ky, (n,), 0, h - crop_hw[0] + 1))),
            torch.from_numpy(np.array(jax.random.randint(kx, (n,), 0, w - crop_hw[1] + 1))))


def _images(seed, shape, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return (rng.random(shape) * 255).astype(dtype)


def _assert_bytes_close(got, want, share):
    diff = np.abs(np.asarray(got, np.int64) - np.asarray(want, np.int64))
    assert diff.max() <= 1, diff.max()
    assert np.mean(diff > 0) <= share, np.mean(diff > 0)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("shape,out_hw,antialias", [
    ((8, 64, 64, 3), (48, 48), False),
    ((7, 97, 131, 3), (50, 61), False),
    ((5, 64, 64, 1), (17, 23), True),
    ((4, 224, 224, 3), (224, 224), False),
    ((2, 96, 160, 3), (40, 50), True),
], ids=["64to48", "ragged", "antialias", "224", "antialias-past-2x"])
def test_random_resized_crop_matches_jax(seed, shape, out_hw, antialias):
    images = _images(seed, shape)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax_augment.random_resized_crop(jnp.asarray(images), key, out_hw,
                                                      antialias=antialias))
    boxes = _jax_boxes(key, *shape[:3])
    got = augment.random_resized_crop(torch.from_numpy(images), None, out_hw,
                                      antialias=antialias, boxes=boxes)
    assert got.dtype == torch.uint8 and got.shape == want.shape
    _assert_bytes_close(got.numpy(), want, 0.001)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("shape,out_hw", [((4, 64, 80, 3), (48, 48)), ((3, 40, 30, 3), (56, 44))],
                         ids=["down", "up"])
def test_random_resized_crop_full_image_boxes_antialiased_matches_jax(seed, shape, out_hw):
    # scale=(1, 1): boxes of the whole image up to the drawn aspect ratio, so
    # inv_scale lands on (or an ulp beside) in/out
    images = _images(seed, shape)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax_augment.random_resized_crop(jnp.asarray(images), key, out_hw,
                                                      scale=(1.0, 1.0), antialias=True))
    boxes = _jax_boxes(key, *shape[:3], scale=(1.0, 1.0))
    got = augment.random_resized_crop(torch.from_numpy(images), None, out_hw,
                                      scale=(1.0, 1.0), antialias=True, boxes=boxes)
    assert got.dtype == torch.uint8 and got.shape == want.shape
    _assert_bytes_close(got.numpy(), want, 0.001)


def test_random_resized_crop_flips_after_the_crop():
    images = _images(4, (6, 40, 36, 3))
    key = jax.random.PRNGKey(4)
    k1, k2 = jax.random.split(key)
    want = np.asarray(jax_augment.random_flip(
        jax_augment.random_resized_crop(jnp.asarray(images), k1, (24, 24)), k2))
    got = augment.random_resized_crop(torch.from_numpy(images), None, (24, 24),
                                      boxes=_jax_boxes(k1, 6, 40, 36), flips=_jax_flips(k2, 6))
    _assert_bytes_close(got.numpy(), want, 0.001)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("shape,out_hw", [
    ((3, 64, 48, 3), (32, 20)), ((2, 40, 30, 3), (80, 70)), ((2, 31, 17, 1), (31, 9)),
], ids=["down", "up", "one-axis"])
@pytest.mark.parametrize("antialias", [True, False])
def test_resize_images_matches_jax(dtype, shape, out_hw, antialias):
    images = _images(5, shape, dtype)
    want = np.asarray(jax_augment.resize_images(jnp.asarray(images), out_hw,
                                                antialias=antialias))
    got = augment.resize_images(torch.from_numpy(images), out_hw, antialias=antialias)
    assert got.dtype == torch.from_numpy(images).dtype and got.shape == want.shape
    if dtype == np.uint8:
        _assert_bytes_close(got.numpy(), want, 0.01)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=8 * 2.0 ** -15)


# dtype -> (jax dtype, torch dtype, bound).  float32: within 2e-3.  The
# crop's sample coordinate ((o + 0.5) * inv_scale - translation * inv_scale -
# 0.5) may round an ulp apart between XLA and torch (up to 2^-18 at
# coordinates below 64), which moves a weight by that much and the value by
# it times the step between neighbouring pixels (up to 255): about 1e-3 an
# axis; measured 9.0e-4 (the uint8 results hide it: a byte moves only at a
# .5 boundary).  A narrower type within one of its ulps at 255 (both sides
# round such float32 values); int16 within 1 (round half to even of them).
_RESAMPLE_DTYPES = {
    "float32": (jnp.float32, torch.float32, 2e-3),
    "float16": (jnp.float16, torch.float16, 0.125),
    "bfloat16": (jnp.bfloat16, torch.bfloat16, 1.0),
    "int16": (jnp.int16, torch.int16, 1.0),
}


@pytest.mark.parametrize("dtype", list(_RESAMPLE_DTYPES))
@pytest.mark.parametrize("antialias", [True, False])
def test_resample_keeps_the_dtype_like_jax(dtype, antialias):
    """resize_images and random_resized_crop resample any dtype in float32
    and bring it back: floats are cast, integers rounded and clipped."""
    jdt, tdt, bound = _RESAMPLE_DTYPES[dtype]
    images = _images(3, (3, 40, 36, 3), np.float32)
    x_jax = jnp.asarray(images).astype(jdt)
    x = torch.from_numpy(np.array(x_jax.astype(jnp.float32))).to(tdt)
    key = jax.random.PRNGKey(3)
    for got, want in [
            (augment.resize_images(x, (24, 30), antialias=antialias),
             jax_augment.resize_images(x_jax, (24, 30), antialias=antialias)),
            (augment.random_resized_crop(x, None, (24, 24), antialias=antialias,
                                         boxes=_jax_boxes(key, 3, 40, 36)),
             jax_augment.random_resized_crop(x_jax, key, (24, 24), antialias=antialias))]:
        assert got.dtype == tdt and str(want.dtype) == dtype and got.shape == want.shape
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                                   rtol=0, atol=bound)


@pytest.mark.parametrize("method", ["bicubic", "lanczos3", "nearest"])
def test_other_methods_are_not_ported(method):
    images = torch.zeros((1, 8, 8, 3), dtype=torch.uint8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        augment.resize_images(images, (4, 4), method=method)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        augment.random_resized_crop(images, torch.Generator(), (4, 4), method=method)


@pytest.mark.parametrize("seed", [0, 1])
def test_random_crop_matches_jax(seed):
    images = _images(seed, (6, 20, 17, 3))
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax_augment.random_crop(jnp.asarray(images), key, (11, 9)))
    got = augment.random_crop(torch.from_numpy(images), None, (11, 9),
                              offsets=_jax_offsets(key, 6, 20, 17, (11, 9)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_random_flip_matches_jax(seed):
    images = _images(seed, (16, 5, 7, 2))
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax_augment.random_flip(jnp.asarray(images), key))
    got = augment.random_flip(torch.from_numpy(images), None, flips=_jax_flips(key, 16))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("crop_hw", [(6, 5), None])
def test_random_crop_flip_matches_jax(crop_hw):
    images = _images(3, (8, 9, 8, 3))
    key = jax.random.PRNGKey(3)
    k1, k2 = jax.random.split(key)
    want = np.asarray(jax_augment.random_crop_flip(jnp.asarray(images), key, crop_hw))
    offsets = None if crop_hw is None else _jax_offsets(k1, 8, 9, 8, crop_hw)
    got = augment.random_crop_flip(torch.from_numpy(images), None, crop_hw, offsets=offsets,
                                   flips=_jax_flips(k2, 8))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cutmix_matches_jax(seed):
    n, h, w, alpha = 6, 20, 24, 1.0
    images = _images(seed, (n, h, w, 3))
    labels = np.arange(n, dtype=np.int32) * 3
    key = jax.random.PRNGKey(seed)
    want = jax_augment.cutmix(jnp.asarray(images), jnp.asarray(labels), key, alpha)
    # the box and permutation of augment.py:97-110
    k_lam, k_perm, k_y, k_x = jax.random.split(key, 4)
    cut = jnp.sqrt(1.0 - jax.random.beta(k_lam, alpha, alpha))
    bh, bw = int((cut * h).astype(jnp.int32)), int((cut * w).astype(jnp.int32))
    cy, cx = int(jax.random.randint(k_y, (), 0, h)), int(jax.random.randint(k_x, (), 0, w))
    box = (np.clip(cy - bh // 2, 0, h), np.clip(cy + bh // 2, 0, h),
           np.clip(cx - bw // 2, 0, w), np.clip(cx + bw // 2, 0, w))
    perm = torch.from_numpy(np.array(jax.random.permutation(k_perm, n)))
    got = augment.cutmix(torch.from_numpy(images), torch.from_numpy(labels), None, alpha,
                         box=box, perm=perm)
    for g, wt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wt))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("seed", [0, 1])
def test_mixup_matches_jax(dtype, seed):
    n = 8
    images = _images(seed, (n, 12, 10, 3), dtype)
    labels = np.arange(n, dtype=np.int32)
    key = jax.random.PRNGKey(seed)
    want = jax_augment.mixup(jnp.asarray(images), jnp.asarray(labels), key, 0.2)
    k_lam, k_perm = jax.random.split(key)
    perm = torch.from_numpy(np.array(jax.random.permutation(k_perm, n)))
    got = augment.mixup(torch.from_numpy(images), torch.from_numpy(labels), None, 0.2,
                        lam=float(want[3]), perm=perm)
    assert float(got[3]) == float(want[3])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    if dtype == np.uint8:
        assert got[0].dtype == torch.uint8
        _assert_bytes_close(got[0].numpy(), np.asarray(want[0]), 0.001)
    else:
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                                   atol=2 * 2.0 ** -16)


def test_mixup_rounds_half_to_even():
    images = torch.tensor([1, 2, 3], dtype=torch.uint8).view(3, 1, 1, 1)
    mixed = augment.mixup(images, torch.arange(3), None, lam=0.5,
                          perm=torch.tensor([1, 2, 0]))[0]
    want = jax_augment._restore_dtype(jnp.asarray([1.5, 2.5, 2.0]), jnp.uint8)
    assert mixed.flatten().tolist() == np.asarray(want).tolist() == [2, 2, 2]


def test_random_draws_have_the_documented_distribution():
    n, side = 40000, 512
    gen = torch.Generator().manual_seed(0)
    # a scale range whose boxes never reach the image border, so no clipping
    boxes = augment.draw_crop_boxes(n, side, side, gen, scale=(0.08, 0.7),
                                    device="cpu").double()
    y0, x0, ch, cw = boxes.unbind(1)
    frac = (ch * cw / side ** 2).numpy()
    log_r = torch.log(cw / ch).numpy()
    lo, hi = np.log(3 / 4), np.log(4 / 3)

    def uniform_ok(v, a, b):
        # mean and variance of U(a, b), within 5 standard errors
        assert a - 1e-4 <= v.min() and v.max() <= b + 1e-4
        assert abs(v.mean() - (a + b) / 2) < 5 * (b - a) / np.sqrt(12 * n)
        assert abs(v.var() - (b - a) ** 2 / 12) < 5 * (b - a) ** 2 / np.sqrt(180 * n)

    uniform_ok(frac, 0.08, 0.7)
    uniform_ok(log_r, lo, hi)
    uniform_ok((y0 / (side - ch)).numpy(), 0.0, 1.0)
    uniform_ok((x0 / (side - cw)).numpy(), 0.0, 1.0)
    # default range: sides clipped to the image, every box inside it
    boxes = augment.draw_crop_boxes(n, 37, 53, gen, device="cpu")
    y0, x0, ch, cw = boxes.unbind(1)
    assert bool((y0 >= 0).all() and (x0 >= 0).all() and (ch >= 1).all() and (cw >= 1).all())
    assert bool((y0 + ch <= 37 + 1e-4).all() and (x0 + cw <= 53 + 1e-4).all())
    rate = augment.draw_flips(n, gen, "cpu").double().mean().item()
    assert abs(rate - 0.5) < 5 * 0.5 / np.sqrt(n)


def test_mix_draws_have_the_documented_distribution():
    gen = torch.Generator().manual_seed(1)
    images = torch.zeros((4, 10, 10, 1), dtype=torch.uint8)
    lams = torch.stack([augment.mixup(images, torch.arange(4), gen, 0.2)[3]
                        for _ in range(2000)]).double()
    # lam = max(b, 1 - b), b ~ Beta(0.2, 0.2): E[lam] = 1/2 + E|b - 1/2|
    b = np.random.default_rng(0).beta(0.2, 0.2, 200000)
    assert bool((lams >= 0.5).all() and (lams <= 1).all())
    assert abs(lams.mean().item() - np.maximum(b, 1 - b).mean()) < 0.01
    box = augment.draw_cutmix_box(10, 10, gen, device="cpu")
    assert box.dtype == torch.int32 and bool(((box >= 0) & (box <= 10)).all())
    assert box[0] <= box[1] and box[2] <= box[3]


def test_explicit_draws_reproduce_the_random_form():
    images = torch.from_numpy(_images(6, (5, 30, 40, 3)))
    got = augment.random_resized_crop(images, torch.Generator().manual_seed(3), (16, 16))
    boxes = augment.draw_crop_boxes(5, 30, 40, torch.Generator().manual_seed(3), device="cpu")
    assert torch.equal(got, augment.random_resized_crop(images, None, (16, 16), boxes=boxes))


@pytest.mark.parametrize("draw", [lambda: augment.draw_crop_boxes(4, 30, 40, None),
                                  lambda: augment.draw_flips(4, None),
                                  lambda: augment.draw_cutmix_box(10, 10, None)],
                         ids=["boxes", "flips", "cutmix-box"])
def test_draws_default_to_the_card(draw, monkeypatch):
    # without a GPU the default device raises instead of drawing on the host
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        draw()


def test_kernel_wrapper_refuses_cpu_tensors():
    images = torch.zeros((2, 8, 8, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        augment.resized_crop_kernel(images, torch.zeros(2, 4), None, (4, 4), False)
