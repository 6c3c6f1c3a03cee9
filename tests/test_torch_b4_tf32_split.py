"""B4's error-compensated TF32 arithmetic, emulated on the CPU.

The tensor-core kernels of ``petastorm_tpu_torch/csrc/block_attention.cu``
take every float32 product as three TF32 products summed in float32
("3xTF32"): each operand x is split into big = tf32(x), rounded to nearest
with ties away from zero (``cvt.rna.tf32.f32``, which the kernel computes as
the int32 pattern plus 0x1000 with the low 13 bits cleared), and small =
x - big, which the tensor core reads as TF32 by dropping its low 13 bits; a
product is big.big + (big.small + small.big).  Here that split runs in torch
through B4's forward (scores, softmax, p.v and the merge into a running
(o, l, m)) and backward (dv, dp, ds, dq, dk from the saved lse and delta) at
the sizes of the card tests' ``_B4_CASES``, and is held to the card's
tolerances: the forward's o, l and m within 1e-5 of their largest |value|,
the gradients within 1e-4, against the port's plain versions and against
the JAX package's ``_block_attention``, ``_merge`` and ``jax.grad``.  One
TF32 pass (big.big alone) falls outside 1e-5 at D = 128, so the card
tolerance would catch a kernel that dropped the compensation.

The emulation sums each product in float32 by the CPU's matmul; the tensor
core truncates its accumulations instead, which the kernel keeps short (a
tile at a time, big.big apart from the small terms): what this file checks
is the split, not the kernel's summation order.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petastorm_tpu_torch.ops import ring_attention as ra

jax_ring = importlib.import_module("petastorm_tpu.ops.ring_attention")

#: (B, H, Sq, Sk, D, causal, q_offset, k_offset): tests/test_torch_cuda_kernels.py's _B4_CASES
CASES = [
    (2, 4, 128, 128, 64, False, 0, 0),
    (2, 4, 128, 128, 64, True, 0, 0),
    (1, 3, 100, 77, 40, True, 77, 0),
    (1, 2, 96, 160, 128, True, 0, 32),
    (2, 32, 256, 256, 128, True, 256, 256),
    (1, 3, 130, 70, 36, False, 0, 0),
    (1, 2, 75, 90, 33, True, 20, 0),
    (1, 2, 200, 333, 96, True, 300, 150),
]
SCALE = 0.125
_LOW13 = -8192  # 0xffffe000 as an int32: clears the 13 bits TF32 drops


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` of finite float32 values: nearest, ties away from zero."""
    return ((x.view(torch.int32) + 0x1000) & _LOW13).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """The TF32 value the tensor core reads from a float32 register."""
    return (x.view(torch.int32) & _LOW13).view(torch.float32)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel takes it: big.big + (big.small + small.big)."""
    a_big, b_big = tf32_rna(a), tf32_rna(b)
    a_small, b_small = tf32_trunc(a - a_big), tf32_trunc(b - b_big)
    return a_big @ b_big + (a_small @ b_big + a_big @ b_small)


def mm_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in one TF32 pass (big.big alone)."""
    return tf32_rna(a) @ tf32_rna(b)


def _inputs(case, seed=0):
    b, h, sq, sk, d = case[:5]
    rng = np.random.default_rng(seed)
    q, k, v, dout = (rng.standard_normal(shape).astype(np.float32)
                     for shape in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d), (b, h, sq, d)))
    k0, v0 = (rng.standard_normal((b, h, 64, d)).astype(np.float32) for _ in range(2))
    return q, k, v, dout, k0, v0


def _mask(case):
    sq, sk, causal, qo, ko = case[2], case[3], *case[5:]
    return ra.causal_mask(qo, ko, sq, sk).numpy() if causal else None


def emulated_fwd(mm, q, k, v, o, l, m, case):
    """B4's forward with products ``mm``: one block's (o, l, m), merged
    into the running ``(o, l, m)``; returns the merged triple."""
    mask = _mask(case)
    scores = mm(q, k.transpose(-1, -2)) * SCALE
    if mask is not None:
        scores = torch.where(torch.from_numpy(mask), scores, -torch.inf)
    m_new = scores.amax(dim=-1)
    finite = torch.isfinite(m_new)
    p = torch.exp(scores - torch.where(finite, m_new, 0.0)[..., None])
    if mask is not None:
        p = torch.where(torch.from_numpy(mask), p, 0.0)
    o_new = mm(p, v)
    return ra._merge(o, l, m, o_new, p.sum(dim=-1), torch.where(finite, m_new, -torch.inf))


def emulated_bwd(mm, q, k, v, dout, lse, delta, case):
    """B4's backward with products ``mm``: (dq, dk, dv) of one block."""
    mask = _mask(case)
    scores = mm(q, k.transpose(-1, -2)) * SCALE
    ok = torch.isfinite(lse)[..., None]
    if mask is not None:
        ok = ok & torch.from_numpy(mask)
    p = torch.where(ok, torch.exp(scores - torch.where(torch.isfinite(lse), lse, 0.0)[..., None]),
                    0.0)
    dv = mm(p.transpose(-1, -2), dout)
    ds = p * (mm(dout, v.transpose(-1, -2)) - delta[..., None])
    return mm(ds, k) * SCALE, mm(ds.transpose(-1, -2), q) * SCALE, dv


def _first_block(q, k0, v0):
    """The running (o, l, m) after an earlier, unmasked 64-key block."""
    b, h, sq, _ = q.shape
    state = [torch.zeros_like(q), torch.zeros(b, h, sq), torch.full((b, h, sq), -torch.inf)]
    ra.block_attention_fwd_reference(q, k0, v0, *state, SCALE)
    return state


def _assert_within(got, want, rel):
    """|got - want| within ``rel`` of the largest finite |want|, the
    infinities in the same places."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.array_equal(np.isinf(got), np.isinf(want))
    finite = np.isfinite(want)
    err = float(np.abs(got[finite] - want[finite]).max())
    assert err <= rel * float(np.abs(want[finite]).max()), (err, rel)
    return err


def test_split_rounds_as_cvt_rna_and_keeps_about_21_bits():
    # ties go away from zero: 1 + 2^-11 is half a TF32 ulp above 1
    tie = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12, 3.0], dtype=torch.float32)
    assert tf32_rna(tie).tolist() == [1 + 2 ** -10, -(1 + 2 ** -10), 1.0, 3.0]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(100_000).astype(np.float32))
    big = tf32_rna(x)
    assert torch.equal(tf32_trunc(big), big)
    assert float(((x - big).abs() / x.abs()).max()) <= 2 ** -11
    rest = (x - big - tf32_trunc(x - big)).abs() / x.abs()
    assert float(rest.max()) <= 2 ** -21
    # a product's error: at most about 2.5 * 2^-21 against 2^-11 for one pass
    y = torch.from_numpy(np.random.default_rng(1).standard_normal(100_000).astype(np.float32))
    exact = x.double() * y.double()
    three = mm_3xtf32(x[:, None, None], y[:, None, None])[:, 0, 0].double()
    one = mm_1xtf32(x[:, None, None], y[:, None, None])[:, 0, 0].double()
    assert float(((three - exact).abs() / exact.abs()).max()) <= 3 * 2 ** -21
    assert float(((one - exact).abs() / exact.abs()).max()) > 2 ** -13


@pytest.mark.parametrize("case", CASES, ids=str)
def test_3xtf32_forward_within_the_card_tolerance(case):
    q, k, v, _, k0, v0 = map(torch.from_numpy, _inputs(case))
    causal, qo, ko = case[5:]
    start = _first_block(q, k0, v0)
    got = emulated_fwd(mm_3xtf32, q, k, v, *start, case)
    plain = [t.clone() for t in start]
    ra.block_attention_fwd_reference(q, k, v, *plain, SCALE, causal, qo, ko)
    mask = _mask(case)
    first = jax_ring._block_attention(q.numpy(), k0.numpy(), v0.numpy(), SCALE, None)
    block = jax_ring._block_attention(q.numpy(), k.numpy(), v.numpy(), SCALE,
                                      None if mask is None else jnp.asarray(mask))
    want_jax = jax_ring._merge(*first, *block)
    for g, p, w in zip(got, plain, want_jax):
        _assert_within(g, p, 1e-5)
        _assert_within(g, w, 1e-5)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_3xtf32_backward_within_the_card_tolerance(case):
    q, k, v, dout, _, _ = map(torch.from_numpy, _inputs(case))
    causal, qo, ko = case[5:]
    b, h, sq, _ = q.shape
    state = [torch.zeros_like(q), torch.zeros(b, h, sq), torch.full((b, h, sq), -torch.inf)]
    ra.block_attention_fwd_reference(q, k, v, *state, SCALE, causal, qo, ko)
    out, lse = ra._finish(*state)
    delta = ra.attention_row_delta_reference(out, dout)
    got = emulated_bwd(mm_3xtf32, q, k, v, dout, lse, delta, case)
    plain = [torch.zeros_like(t) for t in (q, k, v)]
    ra.block_attention_bwd_reference(q, k, v, dout, lse, delta, *plain, SCALE, causal, qo, ko)

    mask = _mask(case)

    def loss(q, k, v):  # the block's normalized output against dout; empty rows give 0
        o, l, _ = jax_ring._block_attention(q, k, v, SCALE,
                                            None if mask is None else jnp.asarray(mask))
        seen = (l > 0)[..., None]
        return (jnp.where(seen, o / jnp.where(seen, l[..., None], 1.0), 0.0) * dout.numpy()).sum()

    want_jax = jax.grad(loss, argnums=(0, 1, 2))(q.numpy(), k.numpy(), v.numpy())
    for g, p, w in zip(got, plain, want_jax):
        _assert_within(g, p, 1e-4)
        _assert_within(g, w, 1e-4)


def test_one_tf32_pass_falls_outside_the_forward_tolerance():
    """At D = 128 one TF32 pass (big.big alone) moves the forward by more
    than 1e-5 of its largest value, which 3xTF32 keeps inside."""
    case = CASES[4]
    q, k, v, _, k0, v0 = map(torch.from_numpy, _inputs(case))
    causal, qo, ko = case[5:]
    start = _first_block(q, k0, v0)
    plain = [t.clone() for t in start]
    ra.block_attention_fwd_reference(q, k, v, *plain, SCALE, causal, qo, ko)
    three = emulated_fwd(mm_3xtf32, q, k, v, *start, case)
    one = emulated_fwd(mm_1xtf32, q, k, v, *start, case)
    err3 = _assert_within(three[0], plain[0], 1e-5)
    err1 = float((one[0] - plain[0]).abs().max())
    assert err1 > 1e-5 * float(plain[0].abs().max()) > err3
