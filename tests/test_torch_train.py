"""The port's training step, trainer and BatchNorm against the JAX package, on the CPU.

The JAX reference step is written here from the JAX package's public
functions exactly as ``examples/imagenet/train_resnet_tpu.py::_step_math``
composes them: ``random_resized_crop`` and ``random_flip`` from a split key,
``normalize_images`` (bf16), the flax ResNet in float32 with BatchNorm on
its running statistics, the one-hot cross-entropy, and ``optax.sgd(0.1,
momentum=0.9)`` over the whole variables dict.  The port's step gets the
boxes and flips that the key gives.

Step tolerances, float32, after two steps.  On the JAX step's own
normalized inputs (``jax-inputs``) the model, loss and SGD-momentum update
are the same float32 arithmetic in other summation orders: loss within 1e-6
relative, every leaf within 1e-6 * max|leaf| (measured 1.4e-7 and 1.7e-7;
the updates themselves within 1e-5 of their largest element).  Through the
port's own augment and normalize (``augment``) the inputs differ slightly:
one or two crop bytes by 1 LSB (``test_torch_augment.py``) and a few bf16
inputs by one bf16 ulp (``test_torch_normalize.py``), and a perturbed
activation can cross a ReLU or max-pool kink and move a gradient by a
discrete step: loss within 1e-4 relative and every leaf, ``params`` and
``batch_stats``, within 5e-3 * max|leaf| (measured at most 1.6e-5 and
1.3e-3 over four seeds).

BatchNorm tolerance: the same float32 formula; float32 output within 4 ulp
of the largest of |out|, |(x - mean) * mul| and |bias| (``rsqrt`` may differ
by an ulp between XLA and torch, and the product and the sum each round
once), bf16 output within 1 bf16 ulp of |out| on top.
"""

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from petastorm_tpu.models.resnet import ResNet as FlaxResNet
from petastorm_tpu.ops import normalize_images as jax_normalize_images
from petastorm_tpu.ops import random_flip as jax_random_flip
from petastorm_tpu.ops import random_resized_crop as jax_random_resized_crop
from petastorm_tpu_torch.convert import flax_from_resnet_state, resnet_state_from_flax
from petastorm_tpu_torch.examples.imagenet import train_resnet_cuda as trainer
from petastorm_tpu_torch.models.resnet import BatchNorm, ResNet

from test_torch_augment import _jax_boxes, _jax_flips
from test_torch_resnet import _randomized

SIDE, CLASSES = 32, 10


def _jax_step_fn(model):
    tx = optax.sgd(0.1, momentum=0.9)

    @jax.jit
    def step(p, o, image_u8, label, key):
        def loss_fn(pp):
            k1, k2 = jax.random.split(key)
            imgs = jax_random_resized_crop(image_u8, k1, (SIDE, SIDE))
            imgs = jax_random_flip(imgs, k2)
            x = jax_normalize_images(imgs)
            logits = model.apply(pp, x)
            onehot = jax.nn.one_hot(label, CLASSES)
            return -(jax.nn.log_softmax(logits) * onehot).sum(-1).mean()

        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, o = tx.update(grads, o, p)
        return optax.apply_updates(p, updates), o, loss

    return tx, step


def _leaves(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("feed", ["augment", "jax-inputs"])
def test_two_steps_match_the_jax_step(feed, seed):
    """``augment``: the whole port step on the boxes and flips of the JAX key.
    ``jax-inputs``: the port's model, loss and optimizer on the JAX step's
    own normalized inputs (:meth:`TrainStep.update`)."""
    flax_model = FlaxResNet(stage_sizes=[1, 1], num_filters=8, num_classes=CLASSES,
                            dtype=jnp.float32)
    variables = _randomized(flax_model.init(jax.random.PRNGKey(seed),
                                            jnp.zeros((1, SIDE, SIDE, 3), jnp.float32)), seed + 7)
    model = ResNet([1, 1], num_classes=CLASSES, num_filters=8, dtype=torch.float32,
                   device="cpu")
    model.load_state_dict(resnet_state_from_flax(variables), strict=True)
    step = trainer.TrainStep(model, CLASSES, SIDE)
    tx, jax_step = _jax_step_fn(flax_model)
    params, opt_state = variables, tx.init(variables)
    loss_rtol, leaf_tol = (1e-4, 5e-3) if feed == "augment" else (1e-6, 1e-6)

    rng = np.random.default_rng(seed)
    for i in range(2):
        images = rng.integers(0, 256, (6, 40, 48, 3), dtype=np.uint8)
        labels = rng.integers(0, CLASSES, 6).astype(np.int32)
        labels[i] = CLASSES + 3  # out of range: a zero one-hot row, as jax.nn.one_hot gives
        key = jax.random.fold_in(jax.random.PRNGKey(17), i)
        params, opt_state, want_loss = jax_step(params, opt_state, jnp.asarray(images),
                                                jnp.asarray(labels), key)
        k1, k2 = jax.random.split(key)
        torch_labels = torch.from_numpy(labels).long()
        if feed == "augment":
            loss = step(torch.from_numpy(images), torch_labels,
                        boxes=_jax_boxes(k1, 6, 40, 48), flips=_jax_flips(k2, 6))
        else:
            x = jax_normalize_images(jax_random_flip(
                jax_random_resized_crop(jnp.asarray(images), k1, (SIDE, SIDE)), k2))
            x = torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
            loss = step.update(x, torch_labels)
        assert abs(float(loss) - float(want_loss)) <= loss_rtol * abs(float(want_loss))

    want = _leaves(jax.device_get(params))
    got = _leaves(flax_from_resnet_state(model.state_dict()))
    assert got.keys() == want.keys()
    assert any("batch_stats" in k for k in got)
    for name, w in want.items():
        g = got[name]
        assert g.dtype == np.float32 and g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0, atol=leaf_tol * np.abs(w).max(), err_msg=name)
    # the running statistics moved, as the JAX step moves them
    start = _leaves(variables)
    moved = [k for k in want if "batch_stats" in k and not np.array_equal(start[k], want[k])]
    assert moved and all(not np.array_equal(start[k], got[k]) for k in moved)


def test_out_of_range_labels_give_zero_rows():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((5, CLASSES)).astype(np.float32)
    labels = np.array([0, CLASSES, -1, 9, 2 * CLASSES], np.int32)
    want = -(jax.nn.log_softmax(jnp.asarray(logits))
             * jax.nn.one_hot(jnp.asarray(labels), CLASSES)).sum(-1).mean()
    got = trainer.softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                        CLASSES)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    only_bad = trainer.softmax_cross_entropy(torch.from_numpy(logits[1:3]),
                                             torch.from_numpy(labels[1:3]), CLASSES)
    assert float(only_bad) == 0.0


def test_trainer_runs_on_cpu(tmp_path):
    url = str(tmp_path / "imagenet")
    trainer.generate_dataset(url, rows=16, side=64)
    m = trainer.train(url, steps=2, global_batch=8, side=64, num_classes=10, device="cpu")
    assert m["samples_per_sec"] > 0 and m["steps"] == 2 and m["global_batch"] == 8
    assert 0.0 <= m["device_idle_pct"] <= 100.0 and 0.0 <= m["input_stall_pct"] <= 100.0
    assert m["compute_floor_wall_s"] > 0
    assert m["diagnostics"]["batches_delivered"] >= m["steps"] + 2
    assert np.isfinite(m["final_loss"])
    assert m["flops_per_sample"] > 0
    assert m["measured_peak_flops"] is None and m["device_kind"] == "cpu"


@pytest.mark.parametrize("decode", ["host", "device"])
def test_trainer_cache_flag_runs_on_cpu(tmp_path, decode):
    """``cache='memory'`` (``train_resnet_tpu.py:244-249``): one worker reads
    the 8 rowgroups once each, and every later read is a hit (the 4 units of
    8 rows read 2 epochs at least)."""
    url = str(tmp_path / "imagenet")
    trainer.generate_dataset(url, rows=16, side=64)
    m = trainer.train(url, steps=2, global_batch=8, side=64, num_classes=10, device="cpu",
                      decode=decode, workers=1, cache="memory")
    assert m["cache"] == "memory" and m["steps"] == 2 and np.isfinite(m["final_loss"])
    stats = m["cache_stats"]
    assert stats["misses"] == 8 and stats["hits"] >= 8 and stats["entries"] == 8


def test_flops_counted_for_a_step_cover_forward_and_backward():
    model = ResNet([1, 1], num_classes=CLASSES, num_filters=8, dtype=torch.float32,
                   device="cpu")
    step = trainer.TrainStep(model, CLASSES, SIDE, generator=torch.Generator().manual_seed(0))
    images = torch.randint(0, 256, (4, SIDE, SIDE, 3), dtype=torch.uint8)
    flops, loss = trainer.count_flops(step, images, torch.arange(4))
    forward, _ = trainer.count_flops(lambda x: model(x), torch.zeros(4, SIDE, SIDE, 3))
    # backward: a gradient for the input and one for the weights of every
    # layer but the first conv, whose input needs none
    assert 2 * forward < flops <= 3 * forward
    assert torch.isfinite(loss)


def test_leaves_stay_float32_and_take_gradients():
    model = ResNet([1], num_classes=4, num_filters=8, dtype=torch.bfloat16, device="cpu")
    step = trainer.TrainStep(model, 4, 16, generator=torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step(torch.randint(0, 256, (2, 20, 20, 3), dtype=torch.uint8), torch.tensor([0, 3]))
    state = model.state_dict()
    assert all(v.dtype == torch.float32 for v in state.values())
    assert all(not torch.equal(before[k], state[k]) for k in ("bn_init.mean", "bn_init.var",
                                                              "conv_init.weight"))
    assert len(step.leaves) == len(state)  # every leaf is updated


def test_flax_tree_round_trip():
    flax_model = FlaxResNet(stage_sizes=[1, 1], num_filters=8, num_classes=4, dtype=jnp.float32)
    variables = _randomized(flax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3))), 3)
    back = flax_from_resnet_state(resnet_state_from_flax(variables))
    want, got = _leaves(jax.device_get(variables)), _leaves(back)
    assert want.keys() == got.keys()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def _bn_pair(seed, c=16):
    rng = np.random.default_rng(seed)
    x = (3 * rng.standard_normal((4, 6, 5, c))).astype(np.float32)
    stats = {"mean": rng.standard_normal(c).astype(np.float32),
             "var": rng.uniform(0.2, 2.0, c).astype(np.float32)}
    params = {"scale": (1 + 0.5 * rng.standard_normal(c)).astype(np.float32),
              "bias": rng.standard_normal(c).astype(np.float32)}
    bn = BatchNorm(c)
    with torch.no_grad():
        for name, value in {**stats, **params}.items():
            getattr(bn, name).copy_(torch.from_numpy(value))
    return x, {"params": params, "batch_stats": stats}, bn


@pytest.mark.parametrize("grad", [True, False], ids=["autograd", "no-grad"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_batchnorm_matches_flax(dtype, grad):
    x, variables, bn = _bn_pair(0)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    flax_bn = flax_nn.BatchNorm(use_running_average=True, momentum=0.9, epsilon=1e-5, dtype=jdt)
    want = np.asarray(flax_bn.apply(variables, jnp.asarray(x, jdt)).astype(jnp.float32))
    x_t = torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2)
    with torch.set_grad_enabled(grad):
        out = bn(x_t)
    assert out.dtype == tdt
    got = out.permute(0, 2, 3, 1).float().detach().numpy()
    mul = variables["params"]["scale"] / np.sqrt(variables["batch_stats"]["var"] + 1e-5)
    x_in = np.asarray(jnp.asarray(x, jdt).astype(jnp.float32))
    size = np.maximum(np.abs(want), np.abs((x_in - variables["batch_stats"]["mean"]) * mul))
    size = np.maximum(size, np.abs(variables["params"]["bias"]))
    bound = 4 * np.spacing(size.astype(np.float32))
    if dtype == "bfloat16":
        bound = bound + np.abs(want) * 2.0 ** -8
    assert np.all(np.abs(got - want) <= bound)


def test_batchnorm_gradients_match_flax():
    x, variables, bn = _bn_pair(1)
    cot = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    flax_bn = flax_nn.BatchNorm(use_running_average=True, epsilon=1e-5, dtype=jnp.float32)

    def loss(v, x):
        return (flax_bn.apply(v, x) * cot).sum()

    want_v, want_x = jax.grad(loss, argnums=(0, 1))(variables, jnp.asarray(x))
    for t in (bn.mean, bn.var):
        t.requires_grad_(True)
    x_t = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    (bn(x_t) * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum().backward()
    for collection, names in (("params", ("scale", "bias")), ("batch_stats", ("mean", "var"))):
        for name in names:
            np.testing.assert_allclose(getattr(bn, name).grad.numpy(),
                                       np.asarray(want_v[collection][name]), rtol=1e-4,
                                       atol=1e-4, err_msg=name)
    np.testing.assert_allclose(x_t.grad.permute(0, 2, 3, 1).numpy(), np.asarray(want_x),
                               rtol=1e-5, atol=1e-5)


# -- scan_steps: K steps per unit -------------------------------------------------

SCAN_K = 3


def _port_pair(variables):
    """Two port trainers on the same flax weights."""
    steps = []
    for _ in range(2):
        model = ResNet([1, 1], num_classes=CLASSES, num_filters=8, dtype=torch.float32,
                       device="cpu")
        model.load_state_dict(resnet_state_from_flax(variables), strict=True)
        steps.append(trainer.TrainStep(model, CLASSES, SIDE))
    return steps


@pytest.mark.parametrize("seed", [0, 1])
def test_scan_steps_equal_single_steps_and_the_jax_steps(seed):
    """K eager steps through :class:`ScanStep` on the CPU, with explicit draws,
    equal K single ``TrainStep`` calls exactly (loss and every leaf), and stay
    within this file's ``augment`` bounds of K JAX ``_step_math`` steps."""
    flax_model = FlaxResNet(stage_sizes=[1, 1], num_filters=8, num_classes=CLASSES,
                            dtype=jnp.float32)
    variables = _randomized(flax_model.init(jax.random.PRNGKey(seed),
                                            jnp.zeros((1, SIDE, SIDE, 3), jnp.float32)), seed + 7)
    scanned, single = _port_pair(variables)
    scan = trainer.ScanStep(scanned, SCAN_K)
    tx, jax_step = _jax_step_fn(flax_model)
    params, opt_state = variables, tx.init(variables)

    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (SCAN_K, 6, 40, 48, 3), dtype=np.uint8)
    labels = rng.integers(0, CLASSES, (SCAN_K, 6)).astype(np.int32)
    boxes, flips, want_losses = [], [], []
    for i in range(SCAN_K):
        key = jax.random.fold_in(jax.random.PRNGKey(17), i)
        params, opt_state, want_loss = jax_step(params, opt_state, jnp.asarray(images[i]),
                                                jnp.asarray(labels[i]), key)
        want_losses.append(float(want_loss))
        k1, k2 = jax.random.split(key)
        boxes.append(_jax_boxes(k1, 6, 40, 48))
        flips.append(_jax_flips(k2, 6))
    images_t, labels_t = torch.from_numpy(images), torch.from_numpy(labels).long()
    losses = scan(images_t, labels_t, boxes=torch.stack(boxes), flips=torch.stack(flips))
    assert losses.shape == (SCAN_K,) and scan.flops_per_step > 0
    single_losses = torch.stack([single(images_t[i], labels_t[i], boxes=boxes[i], flips=flips[i])
                                 for i in range(SCAN_K)])
    assert torch.equal(losses, single_losses)
    for a, b in zip(scanned.leaves, single.leaves):
        assert torch.equal(a, b)
    for got, want in zip(losses.tolist(), want_losses):
        assert abs(got - want) <= 1e-4 * abs(want)
    want = _leaves(jax.device_get(params))
    got = _leaves(flax_from_resnet_state(scanned.model.state_dict()))
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0, atol=5e-3 * np.abs(w).max(),
                                   err_msg=name)


def test_scan_draws_equal_the_eager_loop():
    """Without explicit draws, a unit draws its K boxes and flips as K eager
    steps draw them, from the same generator."""
    model = ResNet([1], num_classes=4, num_filters=8, dtype=torch.float32, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    scan = trainer.ScanStep(trainer.TrainStep(model, 4, 16,
                                              generator=torch.Generator().manual_seed(17)), 2)
    gen = torch.Generator().manual_seed(17)
    boxes, flips = scan.draw(3, 20, 24, "cpu")
    for k in range(2):
        assert torch.equal(boxes[k], trainer.draw_crop_boxes(3, 20, 24, gen, device="cpu"))
        assert torch.equal(flips[k], trainer.draw_flips(3, gen, "cpu"))
    with pytest.raises(ValueError, match="stack of 2 steps"):
        scan(torch.zeros((3, 2, 20, 24, 3), dtype=torch.uint8), torch.zeros((3, 2)).long())


def test_trainer_scan_steps_runs_on_cpu(tmp_path):
    url = str(tmp_path / "imagenet")
    trainer.generate_dataset(url, rows=32, side=64)
    m = trainer.train(url, steps=4, global_batch=4, side=64, num_classes=10, device="cpu",
                      decode="host", scan_steps=2)
    assert m["scan_steps"] == 2 and m["steps"] == 4 and m["global_batch"] == 4
    assert m["diagnostics"]["stack_batches"] == 2
    assert m["diagnostics"]["batches_delivered"] >= 1 + 2 + 1  # warm-up, timed, resident
    assert m["flops_per_sample"] > 0 and np.isfinite(m["final_loss"])

