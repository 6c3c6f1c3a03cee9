"""The MLP path of the port against the JAX package's, on the CPU.

* ``models.MLP`` against flax's ``petastorm_tpu.models.MLP`` from the same
  weights (``convert.mlp_state_from_flax``);
* two MNIST training steps of ``examples/mnist/train_mnist_cuda.TrainStep``
  against the JAX example's own jitted ``train_step`` (taken from
  ``examples/mnist/train_mnist_jax.train``) on the same batches, from the
  same weights;
* the MNIST, hello-world and preemption examples end to end with
  ``device="cpu"``, against their JAX counterparts where those print or
  return the same things.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from examples.hello_world import generate_dataset as jax_hw_generate
from examples.hello_world import read_dataset as jax_hw_read
from examples.mnist import train_mnist_jax
from examples.preemption import train_with_preemption as jax_preemption
from petastorm_tpu.models import MLP as FlaxMLP
from petastorm_tpu.reader import make_reader as jax_make_reader

from petastorm_tpu_torch.convert import flax_from_mlp_state, mlp_state_from_flax
from petastorm_tpu_torch.examples.hello_world import generate_dataset as hw_generate
from petastorm_tpu_torch.examples.hello_world import read_dataset as hw_read
from petastorm_tpu_torch.examples.mnist import train_mnist_cuda as mnist
from petastorm_tpu_torch.examples.preemption import train_with_preemption_cuda as preemption
from petastorm_tpu_torch.models import MLP
from petastorm_tpu_torch.reader import make_reader


def _flax_params(seed=0, features=(128, 64), num_classes=10, in_features=28 * 28):
    model = FlaxMLP(features=features, num_classes=num_classes)
    return model, model.init(jax.random.PRNGKey(seed), jnp.zeros((1, in_features)))


def _tree_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("features,num_classes,shape", [((128, 64), 10, (5, 28, 28)),
                                                        ((16,), 3, (4, 7, 3)),
                                                        ((32, 32, 8), 5, (2, 12))])
def test_mlp_logits_equal_flax_from_converted_weights(features, num_classes, shape):
    """Logits within 1e-5 of the largest |logit| (float32 matmuls in
    another summation order); the input is flattened and cast to float32
    first in both, so uint8 and bf16 inputs give the same logits."""
    in_features = int(np.prod(shape[1:]))
    flax_model, variables = _flax_params(1, features, num_classes, in_features)
    model = MLP(in_features, features, num_classes, device="cpu")
    model.load_state_dict(mlp_state_from_flax(_tree_numpy(variables)), strict=True)
    rng = np.random.default_rng(2)
    for x in (rng.integers(0, 256, shape).astype(np.uint8),
              rng.standard_normal(shape).astype(np.float32)):
        want = np.asarray(flax_model.apply(variables, jnp.asarray(x)))
        got = model(torch.from_numpy(x)).detach().numpy()
        assert got.dtype == np.float32 and got.shape == (shape[0], num_classes)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_mlp_state_round_trips_through_flax():
    _, variables = _flax_params(3)
    flat = _tree_numpy(variables)
    back = flax_from_mlp_state(mlp_state_from_flax(flat))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(flat)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(flat)):
        np.testing.assert_array_equal(a, b)
    state = mlp_state_from_flax(flat)
    assert state["dense.0.weight"].shape == (128, 784)  # flax (in, out) transposed
    with pytest.raises(KeyError):
        mlp_state_from_flax({"params": {"Conv_0": {"kernel": np.zeros((3, 3)),
                                                   "bias": np.zeros(3)}}})


def test_mlp_init_matches_flax_lecun_normal_statistics():
    """Kernels drawn as flax's lecun-normal draws them (truncated at two
    standard deviations, variance 1 / fan_in), biases zero."""
    model = MLP(784, (512,), 10, device="cpu", generator=torch.Generator().manual_seed(0))
    w = model.dense[0].weight.detach().numpy()
    _, variables = _flax_params(0, (512,), 10)
    k = np.asarray(variables["params"]["Dense_0"]["kernel"])
    for arr in (w, k):
        assert abs(arr.std() * np.sqrt(784) - 1) < 0.01
        assert np.abs(arr).max() <= 2 / np.sqrt(784) / 0.87962566103423978 + 1e-6
    assert not model.dense[0].bias.detach().any()


def test_mlp_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        MLP(784)


# -- the MNIST example ----------------------------------------------------------


@pytest.fixture(scope="module")
def mnist_dataset(tmp_path_factory):
    url = str(tmp_path_factory.mktemp("mnist") / "mnist")
    mnist.generate_dataset(url, 256)
    return url


def _jax_train_step(monkeypatch):
    """The JAX example's jitted ``train_step`` and its initial params and
    optimizer state: ``train(epochs=0)`` builds the step and trains nothing;
    the step is taken from its ``jax.jit`` call."""
    captured = []
    real_jit = jax.jit

    def recording_jit(fn, *args, **kwargs):
        captured.append(fn)
        return real_jit(fn, *args, **kwargs)

    monkeypatch.setattr(jax, "jit", recording_jit)
    train_mnist_jax.train("unused://", epochs=0)
    monkeypatch.setattr(jax, "jit", real_jit)
    (step,) = [fn for fn in captured if fn.__name__ == "train_step"]
    params = FlaxMLP(num_classes=10).init(jax.random.PRNGKey(0), jnp.zeros((1, 28 * 28)))
    return real_jit(step), params, optax.adam(1e-3).init(params)


def test_generated_dataset_equals_the_jax_examples(mnist_dataset, tmp_path):
    jax_url = str(tmp_path / "jax_mnist")
    train_mnist_jax.generate_dataset(jax_url, 256)
    rows = []
    for make, url in ((make_reader, mnist_dataset), (jax_make_reader, jax_url)):
        with make(url, reader_pool_type="serial", shuffle_row_groups=False) as reader:
            rows.append([(int(r.idx), int(r.digit), r.image.tobytes()) for r in reader])
    assert rows[0] == rows[1] and len(rows[0]) == 256


def test_two_mnist_steps_match_the_jax_example(mnist_dataset, monkeypatch):
    """From the same weights, on the same two batches: the losses and
    accuracies, and every leaf after each step.

    Bounds: the loss within 1e-5 relative, the accuracy equal, and every
    leaf within 1e-6 + 1e-3 * lr of the JAX leaf.  Adam's first updates are
    about ``lr * sign(g)`` per element, whatever the gradient's size, so a
    leaf's error is a share of ``lr``: optax divides by ``sqrt(nu / (1 -
    b2^t)) + eps`` and torch by ``sqrt(nu) / sqrt(1 - b2^t) + eps``, equal
    in exact arithmetic, and the float32 gradients differ by summation
    order.  B1's plain version and the JAX op agree on 255 of the 256
    uint8 levels at ``mean=std=0.5`` and differ by one bf16 ulp on level 127
    (the JAX op's fused multiply-add; checked here first), which moves the
    first layer's gradient there.  Measured: every leaf within 3.4e-7, the
    losses within 1.2e-7 relative."""
    jax_step, params, opt_state = _jax_train_step(monkeypatch)
    from petastorm_tpu.ops import normalize_images as jax_normalize
    from petastorm_tpu_torch.ops import normalize_images

    levels = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)
    got_levels = normalize_images(torch.from_numpy(levels), mean=0.5, std=0.5).float().numpy()
    want_levels = np.asarray(jax_normalize(jnp.asarray(levels), mean=0.5,
                                           std=0.5)).astype(np.float32)
    differ = np.flatnonzero(got_levels != want_levels)
    assert len(differ) <= 1
    bf16_ulp = 2.0 ** (np.floor(np.log2(np.abs(want_levels.ravel()[differ]))) - 7)
    assert (np.abs(got_levels - want_levels).ravel()[differ] <= bf16_ulp).all()

    step = mnist.make_step(device="cpu")
    step.model.load_state_dict(mlp_state_from_flax(_tree_numpy(params)), strict=True)
    with make_reader(mnist_dataset, reader_pool_type="serial", shuffle_seed=0) as reader:
        rows = list(reader)
    lr = 1e-3
    for i in range(2):
        batch = rows[32 * i:32 * (i + 1)]
        image = np.stack([r.image for r in batch])
        digit = np.asarray([r.digit for r in batch], np.int64)
        params, opt_state, jloss, jacc = jax_step(params, opt_state, jnp.asarray(image),
                                                  jnp.asarray(digit))
        loss, acc = step(torch.from_numpy(image), torch.from_numpy(digit))
        assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
        assert acc.item() == float(jacc)
        want = mlp_state_from_flax(_tree_numpy(params))
        got = step.model.state_dict()
        for key in want:
            err = (got[key] - want[key]).abs().max().item()
            assert err <= 1e-6 + 1e-3 * lr, (i, key, err)


def test_mnist_train_on_the_cpu_learns(mnist_dataset):
    result = mnist.train(mnist_dataset, epochs=3, device="cpu", verbose=False)
    first, _, last = result["epochs"]
    assert first["steps"] == last["steps"] == 256 // 32
    assert 0 <= last["consumer_wait_share"] <= 1 and last["samples_per_s"] > 0
    assert last["loss"] < first["loss"] and result["accuracy"] == last["accuracy"] > 0.9


def test_mnist_step_on_the_cpu_takes_b1s_plain_version(mnist_dataset):
    """On a CPU tensor the step normalizes with B1's plain version: the
    kernel's launch counter stays put (on the card it moves once a step,
    ``test_torch_cuda_kernels.py``)."""
    from petastorm_tpu_torch.ops import normalize

    before = normalize.normalize_kernel.launches
    step = mnist.make_step(device="cpu")
    step(torch.zeros(4, 28, 28, dtype=torch.uint8), torch.zeros(4, dtype=torch.int64))
    assert normalize.normalize_kernel.launches == before


# -- hello world and preemption ---------------------------------------------------


def test_hello_world_reads_as_the_jax_example(tmp_path, capsys):
    url = str(tmp_path / "hw")
    hw_generate.generate_hello_world_dataset(url, rows_count=10)
    rows = hw_read.python_hello_world(url)
    columns = hw_read.columnar_hello_world(url)
    batches = hw_read.cuda_hello_world(url, device="cpu")
    port_out = capsys.readouterr().out.splitlines()

    jax_url = str(tmp_path / "hw_jax")
    jax_hw_generate.generate_hello_world_dataset(jax_url, rows_count=10)
    jax_hw_read.python_hello_world(jax_url)
    jax_hw_read.columnar_hello_world(jax_url)
    jax_hw_read.jax_hello_world(jax_url)
    jax_out = capsys.readouterr().out.splitlines()
    # rows and columnar batches print the same lines; the device lines
    # differ only in the device's name and the dtype's spelling
    assert port_out[:11] == jax_out[:11]
    assert len(port_out) == len(jax_out) == 14
    assert sorted(r[0] for r in rows) == list(range(10)) == sum(columns, [])
    ids = np.concatenate([b["id"][:b.get("_valid_rows", 4)].numpy() for b in batches])
    assert sorted(ids.tolist()) == list(range(10))
    assert [b.get("_valid_rows", 4) for b in batches] == [4, 4, 2]
    assert all(b["image1"].shape == (4, 128, 256, 3) and b["image1"].dtype == torch.uint8
               for b in batches)
    with make_reader(url, reader_pool_type="serial", shuffle_row_groups=False) as a, \
            jax_make_reader(jax_url, reader_pool_type="serial",
                            shuffle_row_groups=False) as b:
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.image1, y.image1)
            np.testing.assert_array_equal(x.array_4d, y.array_4d)


@pytest.mark.parametrize("rows,batch_size,preempt_at", [(512, 32, 3), (200, 32, 2),
                                                        (96, 32, 9)])
def test_preemption_sees_every_row_once(tmp_path, rows, batch_size, preempt_at):
    url = str(tmp_path / "ds")
    preemption.generate_dataset(url, rows=rows)
    seen = []
    seen_a, seen_b, loss = preemption.train(url, batch_size=batch_size, preempt_at=preempt_at,
                                            ckpt_dir=str(tmp_path / "ckpt"), device="cpu",
                                            verbose=False, on_rows=seen.append)
    assert seen_a + seen_b == rows and np.isfinite(loss)
    got = np.concatenate(seen)
    with make_reader(url, reader_pool_type="serial", shuffle_row_groups=False) as reader:
        want = np.stack([r.x for r in reader])
    assert sorted(map(bytes, got)) == sorted(map(bytes, want))
    assert len(set(map(bytes, got))) == rows
    # the first incarnation trains at least its preempt_at batches before the
    # drain; how many more it drains depends on what is in flight
    assert seen_a >= min(preempt_at * batch_size, rows)
    # the JAX example, over its own copy of the dataset, also trains every
    # row once; its split is as timing-dependent, so only its total is held
    jax_url = str(tmp_path / "jax_ds")
    jax_preemption.generate_dataset(jax_url, rows=rows)
    jax_a, jax_b, _ = jax_preemption.train(jax_url, batch_size=batch_size,
                                           preempt_at=preempt_at, verbose=False)
    assert (jax_a + jax_b) == rows
