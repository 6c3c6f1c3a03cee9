"""Context parallelism in the port against the JAX package, on the CPU.

* ``parallel.mesh``: each rank's block (``shard_slices``, the arithmetic of
  ``local_data_slice``) equals JAX's ``devices_indices_map`` for the device at
  the same coordinate of the virtual 8-device mesh, for (1, 2), (2, 1),
  (2, 2) and (1, 4) meshes;
* B4's plain versions (``_block_attention``, ``_merge``, the fused forward
  and the backward) against JAX's ``_block_attention``/``_merge`` and
  ``jax.grad``, with no mask, causal, offset and fully masked rows, within
  2e-6 * max|o|;
* ``ring_attention`` and ``ulysses_attention`` over 2 and 4 gloo processes
  against JAX's on a (1, P) virtual mesh: forward within 2e-5 (JAX's own
  bound, ``tests/test_ring_attention.py:43``), gradients within 1e-4
  (``:63``), bf16 inputs within 2e-2 (``tests/test_ulysses.py:119``), and the
  indivisible-heads refusal;
* two steps of the long-context trainer against the JAX example's
  ``train_step`` (``examples/long_context/train_ring_attention.py:57-72``)
  from the same params on the same batches.

The multi-process cases run ``tests/torch_dist_worker.py`` in subprocesses
with a timeout of their own; a failed worker fails the test.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from examples.long_context import train_ring_attention as jax_lc
from petastorm_tpu_torch.convert import (jax_from_long_context_params,
                                         long_context_params_from_jax)
from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.examples.long_context import train_ring_attention_cuda as lc
from petastorm_tpu_torch.ops import ring_attention as ra
from petastorm_tpu_torch.parallel import mesh as pmesh
from torch_dist_worker import launch

# the modules, not the functions ``petastorm_tpu.ops`` exports under their names
jax_ring = importlib.import_module("petastorm_tpu.ops.ring_attention")
jax_ulysses = importlib.import_module("petastorm_tpu.ops.ulysses")

MESHES = [(1, 2), (2, 1), (2, 2), (1, 4)]
#: (JAX spec, port placements, global shape) on a ("data", "seq") mesh
SPECS = [
    (P("data", "seq"), (Shard(0), Shard(1)), (8, 16)),
    (P("data"), (Shard(0), Replicate()), (8, 16, 3)),
    (P(("data", "seq")), (Shard(0), Shard(0)), (8,)),
    (P(None, "seq"), (Replicate(), Shard(1)), (4, 8, 2)),
    (P("seq", "data"), (Shard(1), Shard(0)), (8, 4)),
]


def _jax_mesh(shape):
    devs = np.asarray(jax.devices()[:shape[0] * shape[1]]).reshape(shape)
    return Mesh(devs, ("data", "seq"))


# -- parallel.mesh ------------------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("spec,placements,global_shape", SPECS, ids=lambda x: str(x))
def test_rank_blocks_match_jax_device_indices(shape, spec, placements, global_shape):
    mesh = _jax_mesh(shape)
    indices = NamedSharding(mesh, spec).devices_indices_map(global_shape)
    for coord in np.ndindex(*shape):
        want = tuple(slice(s.start or 0, s.stop if s.stop is not None else n)
                     for s, n in zip(indices[mesh.devices[coord]], global_shape))
        assert pmesh.shard_slices(shape, coord, placements, global_shape) == want, coord


def test_uneven_split_raises_as_a_jax_mesh_refuses_it():
    with pytest.raises(PetastormTpuError, match="divide evenly"):
        pmesh.shard_slices((1, 4), (0, 1), (Shard(0), Shard(1)), (2, 6))
    with pytest.raises(ValueError):
        NamedSharding(_jax_mesh((1, 4)), P("data", "seq")).shard_shape((2, 6))
    with pytest.raises(PetastormTpuError, match="one placement per mesh dimension"):
        pmesh.shard_slices((1, 4), (0, 1), (Shard(0),), (2, 8))


class _StubMesh:
    """What ``batch_block``/``local_data_slice`` read of a DeviceMesh."""

    def __init__(self, shape, coord, names=("data", "seq")):
        self.shape, self._coord, self.mesh_dim_names = shape, coord, names

    def get_coordinate(self):
        return list(self._coord)


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_batch_block_is_the_data_coordinate(shape):
    """The reader shard of a rank: its block of the batch axis, the same for
    every rank of one ``seq`` ring (``make_cuda_loader``'s sharding)."""
    for coord in np.ndindex(*shape):
        mesh = _StubMesh(shape, coord)
        assert pmesh.batch_block(mesh, (Shard(0), Shard(1))) == (coord[0], shape[0])
        assert pmesh.batch_block(mesh, (Shard(0), Shard(0))) == (
            coord[0] * shape[1] + coord[1], shape[0] * shape[1])
        assert pmesh.local_data_slice(mesh, (Shard(0), Shard(1)), (8, 16)) == \
            pmesh.shard_slices(shape, coord, (Shard(0), Shard(1)), (8, 16))


def test_shard_options_and_sharding_for_batch_without_a_group():
    assert pmesh.shard_options_from_torch() == (0, 1)
    mesh = _StubMesh((2, 2), (0, 0))
    assert pmesh.sharding_for_batch(mesh) == (Shard(0), Replicate())
    assert pmesh.sharding_for_batch(mesh, ("data", "seq")) == (Shard(0), Shard(0))
    with pytest.raises(PetastormTpuError, match="not dimensions"):
        pmesh.sharding_for_batch(mesh, ("model",))
    with pytest.raises(PetastormTpuError, match="initialized"):
        pmesh.data_parallel_mesh(device_type="cpu")


# -- B4's plain versions --------------------------------------------------------------

def _qkv(rng, b=2, h=3, sq=12, sk=20, d=8):
    return (rng.standard_normal((b, h, sq, d)).astype(np.float32),
            rng.standard_normal((b, h, sk, d)).astype(np.float32),
            rng.standard_normal((b, h, sk, d)).astype(np.float32))


def _assert_close(got, want, scale_of=None):
    """Within 2e-6 of the largest finite |value| (of ``scale_of``, else of
    ``want``), with the infinities in the same places: float32 dot products
    summed in another order than XLA's."""
    got, want = np.asarray(got), np.asarray(want)
    ref = np.asarray(want if scale_of is None else scale_of)
    assert np.array_equal(np.isinf(got), np.isinf(want))
    finite = np.isfinite(want)
    bound = 2e-6 * float(np.abs(ref[np.isfinite(ref)]).max())
    np.testing.assert_allclose(got[finite], want[finite], rtol=0, atol=bound)


def _masks(sq, sk):
    """(name, mask or None, q_offset, k_offset, causal) of the block cases."""
    def causal(qo, ko):
        return (ko + np.arange(sk))[None, :] <= (qo + np.arange(sq))[:, None]
    return [("none", None, 0, 0, False), ("causal", causal(0, 0), 0, 0, True),
            ("offset", causal(16, 8), 16, 8, True),
            ("masked_rows", causal(0, 5), 0, 5, True)]


@pytest.mark.parametrize("case", range(4), ids=["none", "causal", "offset", "masked_rows"])
def test_block_attention_and_merge_match_jax(case):
    rng = np.random.default_rng(case)
    q, k, v = _qkv(rng)
    name, mask, qo, ko, causal = _masks(12, 20)[case]
    if name == "masked_rows":
        assert not mask[:5].any(axis=1).any()  # rows 0-4 see no key of this block
    scale = 1 / np.sqrt(8)
    want = jax_ring._block_attention(q, k, v, scale, None if mask is None else jnp.asarray(mask))
    got = ra._block_attention(*map(torch.from_numpy, (q, k, v)), scale,
                              None if mask is None else torch.from_numpy(mask))
    for a, b in zip(got, want):
        _assert_close(a.numpy(), b)
    if name == "masked_rows":
        assert np.all(got[2].numpy()[:, :, :5] == -np.inf)
        assert np.all(got[1].numpy()[:, :, :5] == 0) and np.all(got[0].numpy()[:, :, :5] == 0)

    # merged into a running result from another block, in place (the fused
    # forward), against JAX's _merge of the two blocks
    q2, k2, v2 = _qkv(np.random.default_rng(10 + case))
    first = jax_ring._block_attention(q, k2, v2, scale, None)
    want_o, want_l, want_m = jax_ring._merge(*first, *want)
    o, l, m = (torch.from_numpy(np.array(x)) for x in first)
    ra.block_attention_fwd_reference(*map(torch.from_numpy, (q, k, v)), o, l, m, scale,
                                     causal, qo, ko)
    for a, b in ((o, want_o), (l, want_l), (m, want_m)):
        _assert_close(a.numpy(), b)


def test_merge_of_an_empty_side_weighs_it_zero():
    rng = np.random.default_rng(3)
    o = rng.standard_normal((1, 1, 4, 2)).astype(np.float32)
    l = rng.random((1, 1, 4)).astype(np.float32) + 0.5
    m = rng.standard_normal((1, 1, 4)).astype(np.float32)
    empty = (np.zeros_like(o), np.zeros_like(l), np.full_like(m, -np.inf))
    want = jax_ring._merge(o, l, m, *empty)
    got = ra._merge(*map(torch.from_numpy, (o, l, m)), *map(torch.from_numpy, empty))
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))
    both = ra._merge(*map(torch.from_numpy, empty), *map(torch.from_numpy, empty))
    assert np.all(both[0].numpy() == 0) and np.all(both[1].numpy() == 0)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_one_block_attention_and_gradient_match_jax(causal):
    """``ops.ring_attention.attention`` (B4's plain forward and backward over
    one block) against JAX's ``_full_attention`` and its ``jax.grad``."""
    rng = np.random.default_rng(int(causal))
    q, k, v = _qkv(rng, sq=20, sk=20)
    w = rng.standard_normal(q.shape).astype(np.float32)
    scale = 1 / np.sqrt(8)

    def loss(q, k, v):
        return (jax_ulysses._full_attention(q, k, v, scale, causal) * w).sum()

    want = jax_ulysses._full_attention(q, k, v, scale, causal)
    grads = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = ra.attention(tq, tk, tv, causal=causal)
    (out * torch.from_numpy(w)).sum().backward()
    _assert_close(out.detach().numpy(), want)
    for t, g in zip((tq, tk, tv), grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-4, atol=1e-4)


def test_kernel_wrappers_refuse_cpu_and_count_nothing_on_the_plain_path():
    """On a CPU tensor the wrappers take the plain version (no launch); the
    kernel's checks refuse a CPU tensor outright."""
    ra.reset_launch_counts()
    q, k, v = (torch.from_numpy(x) for x in _qkv(np.random.default_rng(0)))
    o = torch.zeros_like(q)
    l = torch.zeros(q.shape[:3])
    m = torch.full_like(l, -torch.inf)
    ra.block_attention_fwd(q, k, v, o, l, m, 0.5)
    assert ra.block_attention_fwd.launches == 0
    assert ra.block_attention_fwd_reference.cuda_calls == 0
    with pytest.raises(ValueError, match="CUDA tensor"):
        ra._check("block_attention_fwd", {"q": q}, {"q": q.shape})


# -- ring and Ulysses over gloo processes --------------------------------------------

def _jax_reference(fn, q, k, v, w, mesh, causal):
    def loss(q, k, v):
        return (fn(q, k, v, mesh=mesh, causal=causal) * w).sum()

    return fn(q, k, v, mesh=mesh, causal=causal), jax.grad(loss, argnums=(0, 1, 2))(q, k, v)


@pytest.mark.parametrize("nprocs", [2, 4])
def test_ring_and_ulysses_over_gloo_match_jax(nprocs, tmp_path):
    rng = np.random.default_rng(nprocs)
    b, h, s, d = 2, 4, 32, 8
    q, k, v, w = (rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(4))
    inputs = str(tmp_path / "inputs.npz")
    np.savez(inputs, q=q, k=k, v=v, w=w)
    launch("attention", nprocs, {"inputs": inputs, "out": str(tmp_path)}, timeout=120)
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(nprocs)]

    def whole(key):  # the ranks' sequence slices, concatenated
        return np.concatenate([r[key] for r in ranks], axis=2)

    mesh = _jax_mesh((1, nprocs))
    for name, fn in (("ring", jax_ring.ring_attention), ("ulysses", jax_ulysses.ulysses_attention)):
        for causal in (False, True):
            out, grads = _jax_reference(fn, q, k, v, w, mesh, causal)
            key = f"{name}_{int(causal)}"
            np.testing.assert_allclose(whole(f"{key}_out"), np.asarray(out),
                                       rtol=2e-5, atol=2e-5)
            for n, g in zip("qkv", grads):
                np.testing.assert_allclose(whole(f"{key}_d{n}"), np.asarray(g),
                                           rtol=1e-4, atol=1e-4)
        bf16 = fn(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), mesh=mesh, causal=True)
        np.testing.assert_allclose(whole(f"{name}_bf16_out"), np.asarray(bf16, np.float32),
                                   rtol=2e-2, atol=2e-2)
    with pytest.raises(ValueError, match="divisible") as refused:
        jax_ulysses.ulysses_attention(q[:, :3], q[:, :3], q[:, :3], mesh=mesh)
    if 3 % nprocs:
        for r in ranks:
            assert str(r["indivisible"]) == str(refused.value)


# -- the long-context trainer ---------------------------------------------------------

def test_generated_dataset_equals_the_jax_examples(tmp_path):
    from petastorm_tpu.reader import make_reader as jax_make_reader
    from petastorm_tpu_torch.reader import make_reader

    urls = [str(tmp_path / "port"), str(tmp_path / "jax")]
    lc.generate_dataset(urls[0], 16, 32, 50)
    jax_lc.generate_dataset(urls[1], 16, 32, 50)
    rows = []
    for make, url in zip((make_reader, jax_make_reader), urls):
        with make(url, reader_pool_type="serial", shuffle_row_groups=False) as reader:
            rows.append([r.tokens.tobytes() for r in reader])
    assert rows[0] == rows[1] and len(rows[0]) == 16


def test_long_context_params_round_trip():
    rng = np.random.default_rng(0)
    params = {"embed": rng.standard_normal((10, 4)).astype(np.float32),
              "out": rng.standard_normal((4, 10)).astype(np.float32)}
    torch_params = long_context_params_from_jax(params)
    assert torch_params["embed"].shape == (10, 4) and torch_params["out"].dtype == torch.float32
    back = jax_from_long_context_params(torch_params)
    assert all(np.array_equal(back[k], params[k]) for k in params)
    with pytest.raises(ValueError, match="leaves"):
        long_context_params_from_jax({"embed": params["embed"]})


def _jax_train_step(monkeypatch, url, global_batch, seq_len, vocab, heads, head_dim, strategy):
    """The JAX example's ``train_step`` for ``strategy``: ``train(steps=0)``
    builds it (and its (2, 4) mesh) and trains nothing; the step is taken
    from its ``jax.jit`` call (it then fails on ``losses[0]`` of no step)."""
    captured = []
    real_jit = jax.jit

    def recording_jit(fn, *args, **kwargs):
        captured.append(fn)
        return real_jit(fn, *args, **kwargs)

    monkeypatch.setattr(jax, "jit", recording_jit)
    with pytest.raises(IndexError):
        jax_lc.train(url, 0, global_batch, seq_len, vocab, heads=heads, head_dim=head_dim,
                     strategy=strategy)
    monkeypatch.setattr(jax, "jit", real_jit)
    (step,) = [fn for fn in captured if fn.__name__ == "train_step"]
    return real_jit(step)


def test_two_long_context_steps_match_the_jax_example(tmp_path, monkeypatch):
    """From the same params on the same two batches, on a (2, 2) mesh of
    gloo ranks against the JAX example's (2, 4) virtual mesh: the losses
    within 1e-5 relative and every leaf after each strategy's two Adam steps
    within 1e-6 + 1e-3 * lr of the JAX leaf (Adam's first updates are about
    lr * sign(g) for any gradient's size, so a leaf's error is a share of
    lr where a gradient is near Adam's eps)."""
    gb, seq, vocab, heads, hd = 8, 32, 50, 4, 16
    url = str(tmp_path / "seqs")
    lc.generate_dataset(url, 16, seq, vocab)
    rng = np.random.default_rng(5)
    params = {"embed": (rng.standard_normal((vocab, heads * hd)) * 0.02).astype(np.float32),
              "out": (rng.standard_normal((heads * hd, vocab)) * 0.02).astype(np.float32)}
    np.savez(tmp_path / "params.npz", **params)
    launch("trainer", 4, {"url": url, "params": str(tmp_path / "params.npz"),
                          "global_batch": gb, "seq_len": seq, "vocab": vocab, "heads": heads,
                          "head_dim": hd, "data_par": 2, "out": str(tmp_path)}, timeout=150)
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(4)]
    from petastorm_tpu.reader import make_reader as jax_make_reader

    with jax_make_reader(url, reader_pool_type="serial", shuffle_row_groups=False) as reader:
        tokens = np.stack([r.tokens for r in reader])
    for strategy in ("ring", "ulysses"):
        step = _jax_train_step(monkeypatch, url, gb, seq, vocab, heads, hd, strategy)
        p = {k: jnp.asarray(v) for k, v in params.items()}
        opt = optax.adam(1e-3).init(p)
        losses = []
        for i in range(2):
            p, opt, loss = step(p, opt, tokens[i * gb:(i + 1) * gb])
            losses.append(float(loss))
        for r in ranks:
            np.testing.assert_allclose(r[f"{strategy}_losses"], losses, rtol=1e-5)
            for k in params:
                np.testing.assert_allclose(r[f"{strategy}_{k}"], np.asarray(p[k]), rtol=0,
                                           atol=1e-6 + 1e-3 * 1e-3)
