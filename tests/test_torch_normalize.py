"""The port's normalize_images against the JAX package's, on the CPU.

Both run on the same uint8 batches made from a numpy seed.  The port's CPU
path is the plain PyTorch version that ``chip_smoke.py`` also holds the CUDA
kernel against on the card.  Tolerances: float32 within 2 ulp (the CUDA
kernel contracts ``x*s+b`` into one FMA while torch and XLA on the CPU may
round the product first, and that rounding is of the addends' size, so the
ulp is taken at the larger of |out| and |bias|); bfloat16 and float16 within
1 ulp of their type at |out| on top of that float32 difference (one more
rounding of float32 values that already differ by up to 2 ulp).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from petastorm_tpu.ops import normalize as jax_normalize
from petastorm_tpu_torch.ops import normalize as torch_normalize

from test_torch_cuda_kernels import assert_within_ulp as _assert_within_ulp

MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def _images(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _port(images_np, out_dtype, mean=MEAN, std=STD):
    out = torch_normalize.normalize_images(torch.from_numpy(images_np), mean, std, out_dtype)
    return out.float().numpy()


def _xla(images_np, out_dtype, mean=MEAN, std=STD):
    out = jax_normalize.normalize_images(jnp.asarray(images_np), mean, std, out_dtype)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("shape", [(4, 8, 8, 3), (8, 16, 8, 3), (7, 9, 11, 3),
                                   (5, 31, 17, 1), (3, 16, 16, 4), (6, 12)])
@pytest.mark.parametrize("dtypes", [(torch.float32, jnp.float32, np.float32),
                                    (torch.bfloat16, jnp.bfloat16, "bfloat16"),
                                    (torch.float16, jnp.float16, np.float16)],
                         ids=["f32", "bf16", "f16"])
def test_matches_xla(shape, dtypes):
    # (7, 9, 11, 3), (5, 31, 17, 1) and (6, 12) are shapes the Pallas path
    # refuses (N % 8, H*W*C % 128): the JAX package runs XLA there too
    torch_dt, jax_dt, ulp_dt = dtypes
    c = shape[-1]
    mean, std = ((0.5, 0.4, 0.3, 0.6)[:c], (0.2, 0.25, 0.3, 0.35)[:c]) if c <= 4 else (0.5, 0.2)
    imgs = _images(shape, seed=sum(shape))
    _, bias = torch_normalize.channel_constants(mean, std, c)
    _assert_within_ulp(_port(imgs, torch_dt, mean, std), _xla(imgs, jax_dt, mean, std),
                       ulp_dt, bias)


@pytest.mark.parametrize("out", [(torch.float32, jnp.float32, np.float32),
                                 (torch.bfloat16, jnp.bfloat16, "bfloat16")],
                         ids=["f32", "bf16"])
def test_matches_pallas_kernel_interpret(out):
    # the Pallas kernel itself, run in interpret mode as tests/test_ops_models.py does
    from jax.experimental import pallas as pl

    torch_dt, jax_dt, ulp_dt = out
    n, h, w, c = 8, 16, 8, 3
    imgs = _images((n, h, w, c), seed=11)
    length = h * w * c
    mean, std = np.asarray(MEAN, np.float32), np.asarray(STD, np.float32)
    scale = np.tile(1.0 / (255.0 * std), length // c).astype(np.float32)[None, :]
    bias = np.tile(-mean / std, length // c).astype(np.float32)[None, :]
    block = jax_normalize._choose_block(n, length)
    assert block is not None
    want = pl.pallas_call(
        jax_normalize._normalize_kernel,
        out_shape=jax.ShapeDtypeStruct((n, length), jax_dt),
        grid=(n // block[0], length // block[1]),
        in_specs=[pl.BlockSpec(block, lambda i, j: (i, j)),
                  pl.BlockSpec((1, block[1]), lambda i, j: (0, j)),
                  pl.BlockSpec((1, block[1]), lambda i, j: (0, j))],
        out_specs=pl.BlockSpec(block, lambda i, j: (i, j)),
        interpret=True,
    )(imgs.reshape(n, length), jnp.asarray(scale), jnp.asarray(bias))
    want = np.asarray(want.astype(jnp.float32)).reshape(n, h, w, c)
    _assert_within_ulp(_port(imgs, torch_dt), want, ulp_dt, bias[0, :c])


@pytest.mark.parametrize("mean,std,c", [(MEAN, STD, 3), ((0.5,), (0.25,), 3),
                                        (0.5, 0.2, 1), ((0.1, 0.2, 0.3, 0.4), (1, 2, 3, 4), 4)])
def test_constants_bit_identical(mean, std, c):
    scale, bias = torch_normalize.channel_constants(mean, std, c)
    # the JAX package's expressions (petastorm_tpu/ops/normalize.py:98-110)
    m = np.asarray(mean, np.float32)
    s = np.asarray(std, np.float32)
    if m.size == 1:
        m = np.full(c, float(m.reshape(())), np.float32)
    if s.size == 1:
        s = np.full(c, float(s.reshape(())), np.float32)
    want_scale = np.tile(1.0 / (255.0 * s), 5).astype(np.float32)
    want_bias = np.tile(-m / s, 5).astype(np.float32)
    assert scale.dtype == bias.dtype == np.float32
    np.testing.assert_array_equal(np.tile(scale, 5).view(np.uint32), want_scale.view(np.uint32))
    np.testing.assert_array_equal(np.tile(bias, 5).view(np.uint32), want_bias.view(np.uint32))


def test_default_output_is_bf16_like_jax():
    imgs = _images((2, 4, 4, 3), seed=3)
    out = torch_normalize.normalize_images(torch.from_numpy(imgs))
    assert out.dtype == torch.bfloat16 and out.shape == imgs.shape
    assert jax_normalize.normalize_images(jnp.asarray(imgs)).dtype == jnp.bfloat16


@pytest.mark.parametrize("bad,exc", [
    (lambda: torch.zeros((2, 4, 4, 3), dtype=torch.float32), TypeError),
    (lambda: torch.zeros((2, 4, 4, 3), dtype=torch.int16), TypeError),
    (lambda: torch.zeros((5,), dtype=torch.uint8), TypeError),
])
def test_refusals_match_jax(bad, exc):
    x = bad()
    with pytest.raises(exc):
        torch_normalize.normalize_images(x)
    with pytest.raises(exc):
        jax_normalize.normalize_images(jnp.asarray(x.numpy()))


@pytest.mark.parametrize("mean,std", [((0.5, 0.5), STD), (MEAN, (0.2, 0.2))])
def test_channel_mismatch_refused_like_jax(mean, std):
    x = np.zeros((2, 4, 4, 3), np.uint8)
    with pytest.raises(ValueError):
        torch_normalize.normalize_images(torch.from_numpy(x), mean, std)
    with pytest.raises(ValueError):
        jax_normalize.normalize_images(jnp.asarray(x), mean, std)


def test_cpu_tensor_uses_plain_version_not_kernel():
    before = torch_normalize.normalize_kernel.launches
    torch_normalize.normalize_images(torch.from_numpy(_images((2, 4, 4, 3), seed=5)))
    assert torch_normalize.normalize_kernel.launches == before


def test_kernel_wrapper_refuses_cpu_tensor():
    scale, bias = torch_normalize.channel_constants(MEAN, STD, 3)
    with pytest.raises(ValueError):
        torch_normalize.normalize_kernel(torch.zeros((1, 2, 2, 3), dtype=torch.uint8),
                                         scale, bias, torch.bfloat16)
