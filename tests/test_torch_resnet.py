"""The port's ResNet against the flax ResNet of the JAX package, on the CPU.

Every flax leaf is redrawn from a numpy seed before conversion - BatchNorm
scales, biases, means and positive variances included - because flax's own
init zeroes each block's last BatchNorm scale, and with those weights every
block passes only its residual and a wrong 3x3 conv would go unseen.

Tolerances: float32 logits within rtol 1e-4, atol 1e-4 (both run float32
convolutions on the CPU; they differ only in summation order).  bfloat16
logits within 0.02 * max|logit| + 0.01: both bodies round every conv and
BatchNorm output to bf16 (8 bits of mantissa, ~0.4 % each), but at other
places in the two frameworks, and those roundings compound over the layers
(the largest gap seen on these seeds was 0.75 % of the largest logit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petastorm_tpu.models.resnet import ResNet as FlaxResNet
from petastorm_tpu.models.resnet import ResNet50 as FlaxResNet50
from petastorm_tpu_torch.convert import resnet_state_from_flax
from petastorm_tpu_torch.models.resnet import ResNet, ResNet50, _same_pad


def _randomized(variables, seed):
    """Every leaf redrawn from numpy: kernels ~ N(0, 1/fan_in), BN scale and
    bias ~ N(0, 0.5) around 1 and 0, means ~ N(0, 0.3), variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        leaf = np.asarray(leaf)
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.5 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return (0.3 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, jax.device_get(variables))


def _small_pair(dtype_flax, dtype_torch, seed):
    flax_model = FlaxResNet(stage_sizes=[1, 1], num_filters=8, num_classes=10, dtype=dtype_flax)
    x = np.random.default_rng(seed).integers(0, 256, (4, 32, 32, 3)).astype(np.float32) / 64.0
    variables = _randomized(flax_model.init(jax.random.PRNGKey(seed), jnp.asarray(x)), seed + 1)
    torch_model = ResNet([1, 1], num_classes=10, num_filters=8, dtype=dtype_torch, device="cpu")
    torch_model.load_state_dict(resnet_state_from_flax(variables), strict=True)
    want = np.asarray(flax_model.apply(variables, jnp.asarray(x)), np.float32)
    with torch.inference_mode():
        got = torch_model(torch.from_numpy(x)).numpy()
    return got, want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_small_resnet_f32_matches_flax(seed):
    got, want = _small_pair(jnp.float32, torch.float32, seed)
    assert got.shape == want.shape == (4, 10)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_small_resnet_bf16_matches_flax(seed):
    got, want = _small_pair(jnp.bfloat16, torch.bfloat16, seed)
    assert got.dtype == np.float32  # the head runs in float32 in both
    np.testing.assert_allclose(got, want, rtol=0, atol=0.02 * np.abs(want).max() + 0.01)


def test_resnet50_conversion_consumes_every_leaf():
    flax_model = FlaxResNet50(num_classes=1000, dtype=jnp.float32)
    variables = jax.device_get(
        flax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3), jnp.float32)))
    leaves = jax.tree_util.tree_leaves(variables)
    state = resnet_state_from_flax(variables)
    torch_model = ResNet50(num_classes=1000, dtype=torch.float32, device="cpu")
    result = torch_model.load_state_dict(state, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    n_bn = sum(1 for k in state if k.endswith("num_batches_tracked"))
    assert len(state) == len(leaves) + n_bn  # one torch tensor per flax leaf
    flax_params = sum(np.asarray(x).size for x in jax.tree_util.tree_leaves(variables["params"]))
    torch_params = sum(p.numel() for p in torch_model.parameters())
    assert flax_params == torch_params == 25_557_032


@pytest.mark.parametrize("bad", [
    lambda v: {**v, "extra": {}},
    lambda v: {**v, "params": {**v["params"], "Dense_1": v["params"]["Dense_0"]}},
    lambda v: {**v, "params": {**v["params"], "conv_init": {"kernel": np.zeros((3, 3))}}},
    lambda v: {**v, "params": {**v["params"], "bn_init": {**v["params"]["bn_init"],
                                                           "gamma": np.ones(8)}}},
])
def test_conversion_refuses_unknown_leaves(bad):
    flax_model = FlaxResNet(stage_sizes=[1], num_filters=8, num_classes=4, dtype=jnp.float32)
    variables = jax.device_get(flax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3))))
    with pytest.raises((KeyError, ValueError)):
        resnet_state_from_flax(bad(variables))


def test_missing_flax_leaf_fails_strict_load():
    flax_model = FlaxResNet(stage_sizes=[1], num_filters=8, num_classes=4, dtype=jnp.float32)
    variables = jax.device_get(flax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3))))
    del variables["batch_stats"]["bn_init"]["var"]
    model = ResNet([1], num_classes=4, num_filters=8, dtype=torch.float32, device="cpu")
    with pytest.raises(RuntimeError):
        model.load_state_dict(resnet_state_from_flax(variables), strict=True)


@pytest.mark.parametrize("size,kernel,stride,want", [
    (56, 3, 2, (0, 1)), (57, 3, 2, (1, 1)), (56, 3, 1, (1, 1)), (112, 3, 2, (0, 1)),
    (56, 1, 2, (0, 0)), (7, 1, 1, (0, 0))])
def test_same_padding_matches_xla(size, kernel, stride, want):
    x = torch.zeros((1, 1, size, size))
    padded = _same_pad(x, kernel, stride)
    assert padded.shape[-1] == size + sum(want)
    out = jax.lax.conv_general_dilated(
        jnp.ones((1, 1, size, size)), jnp.ones((1, 1, kernel, kernel)), (stride, stride),
        "SAME")
    assert out.shape[-1] == (padded.shape[-1] - kernel) // stride + 1


def test_model_refuses_cuda_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError):
        ResNet([1], num_filters=8, num_classes=4)


def test_inference_mode_reuses_cast_kernels_until_they_change():
    model = ResNet([1], num_classes=4, num_filters=8, dtype=torch.bfloat16, device="cpu")
    assert all(p.dtype == torch.float32 for p in model.state_dict().values())
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 16, 16, 3),
                                                                  dtype=np.float32))
    with torch.inference_mode():
        first = model(x)
        cast = model.conv_init._cast[2]
        assert cast.dtype == torch.bfloat16 and torch.equal(model(x), first)
        assert model.conv_init._cast[2] is cast
    with torch.no_grad():
        model.conv_init.weight.mul_(2.0)  # an update must not leave a stale cast behind
    with torch.inference_mode():
        again = model(x)
        assert model.conv_init._cast[2] is not cast
        cast = model.conv_init._cast[2]
    with torch.no_grad():  # outside inference_mode the kernels are cast at every call
        assert torch.equal(again, model(x))
    # a new storage behind the same parameter (as .to() gives) is seen too
    model.conv_init.weight.data = model.conv_init.weight.data * 0.5
    with torch.inference_mode():
        assert torch.equal(model(x), first) and model.conv_init._cast[2] is not cast
        assert torch.equal(model.conv_init._cast[2], model.conv_init.weight.to(torch.bfloat16))


def test_forward_ab_variants_agree_and_restore_the_model():
    from petastorm_tpu_torch.examples.imagenet import forward_ab
    from petastorm_tpu_torch.models.resnet import BatchNorm, _Conv

    flax_model = FlaxResNet(stage_sizes=[1, 1], num_filters=8, num_classes=10,
                            dtype=jnp.bfloat16)
    x = np.random.default_rng(3).integers(0, 256, (4, 32, 32, 3)).astype(np.float32) / 64.0
    variables = _randomized(flax_model.init(jax.random.PRNGKey(3), jnp.asarray(x)), 4)
    model = ResNet([1, 1], num_classes=10, num_filters=8, dtype=torch.bfloat16, device="cpu")
    model.load_state_dict(resnet_state_from_flax(variables), strict=True)
    saved = _Conv._kernel, BatchNorm.forward
    with torch.inference_mode():
        base = model(torch.from_numpy(x))
        got = {}
        for name in forward_ab.VARIANTS:
            with forward_ab.variant(name):
                got[name] = model(torch.from_numpy(x))
                got[name + " again"] = model(torch.from_numpy(x))
    assert (_Conv._kernel, BatchNorm.forward) == saved
    # the casts are the same values whether cached or not
    for name in ("cast_per_call", "cast_cached", "cast_cached again"):
        assert torch.equal(got[name], base), name
    # the explicit formula rounds its last float32 bit elsewhere: the module's bf16 bound
    tol = 0.02 * base.abs().max().item() + 0.01
    assert (got["bn_explicit"] - base).abs().max().item() <= tol


#: ``train=True`` bounds, relative to the largest value compared.  The
#: float32 convolutions sum in other orders in XLA and torch (2.6e-7 and
#: 3.9e-7 of the largest logit in inference on these seeds); a BatchNorm on
#: the batch's statistics divides each channel by the batch's own spread, and
#: the backward through it subtracts the channel's mean gradient, so those
#: differences grow: measured at most 1.8e-6 (logits), 2.2e-6 (running
#: statistics) and 1.4e-5 (gradients) over two seeds.  Computing the
#: statistics in float64 moved none of them, so they are not the sums of the
#: statistics themselves.
TRAIN_MODE_TOL, GRAD_TOL = 1e-5, 1e-4


def _train_mode_pair(seed):
    flax_model = FlaxResNet(stage_sizes=[1, 1], num_filters=8, num_classes=10,
                            dtype=jnp.float32)
    x = np.random.default_rng(seed).integers(0, 256, (6, 32, 32, 3)).astype(np.float32) / 64.0
    variables = _randomized(flax_model.init(jax.random.PRNGKey(seed), jnp.asarray(x)), seed + 1)
    model = ResNet([1, 1], num_classes=10, num_filters=8, dtype=torch.float32, device="cpu")
    model.load_state_dict(resnet_state_from_flax(variables), strict=True)
    return flax_model, variables, model, x


def _flat(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(jax.device_get(tree))}


@pytest.mark.parametrize("seed", [0, 1])
def test_train_mode_batch_statistics_match_flax(seed):
    """``forward(train=True)`` against flax's ``apply(..., train=True,
    mutable=['batch_stats'])`` on the same converted float32 weights: the
    logits and the updated running statistics within TRAIN_MODE_TOL of their
    largest value, the gradient of every parameter within GRAD_TOL of its
    largest (the statistics' own gradients are zero in flax and None in
    torch: a train-mode forward does not read them); then ``train=False``
    reads the updated statistics as flax does and updates nothing."""
    from petastorm_tpu_torch.convert import flax_from_resnet_state

    flax_model, variables, model, x = _train_mode_pair(seed)
    cot = np.random.default_rng(seed + 5).standard_normal((6, 10)).astype(np.float32)

    def loss(v):
        logits, updated = flax_model.apply(v, jnp.asarray(x), train=True,
                                           mutable=["batch_stats"])
        return (logits * cot).sum(), (logits, updated)

    (_, (want_logits, updated)), want_grads = jax.value_and_grad(loss, has_aux=True)(variables)
    for stat in model.batch_stats():
        stat.requires_grad_(True)
    logits = model(torch.from_numpy(x), train=True)
    (logits * torch.from_numpy(cot)).sum().backward()

    def close(got, want, name, tol=TRAIN_MODE_TOL):
        np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max(),
                                   err_msg=name)

    close(logits.detach().numpy(), np.asarray(want_logits), "logits")
    got_stats = _flat({"batch_stats": flax_from_resnet_state(model.state_dict())["batch_stats"]})
    want_stats = _flat({"batch_stats": updated["batch_stats"]})
    assert got_stats.keys() == want_stats.keys() and got_stats
    for name, want in want_stats.items():
        close(got_stats[name], want, name)
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
             for k, v in {**dict(model.named_parameters()),
                          **dict(model.named_buffers())}.items()
             if v.dtype == torch.float32}
    got_grads = _flat(flax_from_resnet_state(grads))
    want_grads = _flat(want_grads)
    assert got_grads.keys() == want_grads.keys()
    for name, want in want_grads.items():
        if "batch_stats" in name:
            assert not want.any() and not got_grads[name].any(), name
        else:
            close(got_grads[name], want, name, GRAD_TOL)

    new_variables = {"params": variables["params"], "batch_stats": updated["batch_stats"]}
    with torch.no_grad():
        before = [t.clone() for t in model.batch_stats()]
        eval_logits = model(torch.from_numpy(x))
        assert all(torch.equal(a, b) for a, b in zip(before, model.batch_stats()))
    want_eval = np.asarray(flax_model.apply(new_variables, jnp.asarray(x)))
    np.testing.assert_allclose(eval_logits.numpy(), want_eval, rtol=1e-4, atol=1e-4)


def test_train_mode_is_not_torch_batchnorm2d():
    """The running variance moves by the batch's biased variance (flax), not
    the unbiased one ``nn.BatchNorm2d`` keeps."""
    from petastorm_tpu_torch.models.resnet import BatchNorm

    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 4, 3, 3)).astype(np.float32))
    bn = BatchNorm(4)
    bn(x, train=True)
    biased = x.permute(1, 0, 2, 3).reshape(4, -1).var(dim=1, unbiased=False)
    np.testing.assert_allclose(bn.var.numpy(), (0.9 + 0.1 * biased).numpy(), rtol=1e-6)
    np.testing.assert_allclose(bn.mean.numpy(), (0.1 * x.mean(dim=(0, 2, 3))).numpy(),
                               rtol=1e-6, atol=1e-7)
