"""The data-parallel training step of the port against the JAX step over the
global batch on the CPU.

Two gloo ranks each run the port's ``TrainStep`` on their block of the
global batch (``group=``, ``block=``: the gradients and the loss averaged
over the ranks by one all-reduce), for two steps of a narrow ResNet.  The
reference is ``_step_math`` of ``examples/imagenet/train_resnet_tpu.py``
jitted over the 8-device CPU mesh of ``tests/conftest.py``: the variables
replicated (``P()``), the batch sharded over ``"data"`` (``P("data")``), as
``train_resnet_tpu.py:171-176`` and ``:256-257`` place them.  The draws are
the JAX key's, given to the port explicitly.

Bounds, ``tests/test_torch_train.py``'s: on the JAX step's own normalized
inputs (``jax-inputs``) every leaf within 1e-6 * max|leaf| and the loss
within 1e-6 relative; through the port's own augment and normalize
(``augment``) within 5e-3 * max|leaf| and 1e-4.  The ranks end with
identical leaves, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from petastorm_tpu.models.resnet import ResNet as FlaxResNet
from petastorm_tpu.ops import normalize_images as jax_normalize_images
from petastorm_tpu.ops import random_flip as jax_random_flip
from petastorm_tpu.ops import random_resized_crop as jax_random_resized_crop
from petastorm_tpu_torch.convert import resnet_state_from_flax

from test_torch_augment import _jax_boxes, _jax_flips
from test_torch_resnet import _randomized
from test_torch_train import CLASSES, SIDE, _jax_step_fn, _leaves
from torch_dist_worker import launch

GLOBAL_BATCH, RANKS, STEPS = 8, 2, 2


@pytest.mark.parametrize("feed", ["augment", "jax-inputs"])
def test_two_data_parallel_ranks_match_the_jax_step_over_the_global_batch(tmp_path, feed):
    seed = 4
    flax_model = FlaxResNet(stage_sizes=[1, 1], num_filters=8, num_classes=CLASSES,
                            dtype=jnp.float32)
    variables = _randomized(flax_model.init(jax.random.PRNGKey(seed),
                                            jnp.zeros((1, SIDE, SIDE, 3), jnp.float32)), seed + 7)
    torch.save(resnet_state_from_flax(variables), tmp_path / "state.pt")
    devices = jax.devices()
    assert len(devices) == 8, "tests/conftest.py sets up an 8-device CPU mesh"
    mesh = Mesh(np.asarray(devices), ("data",))
    replicated, sharded = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
    tx, jax_step = _jax_step_fn(flax_model)
    params = jax.device_put(variables, replicated)
    opt_state = tx.init(params)

    rng = np.random.default_rng(seed)
    inputs = {"images": [], "labels": [], "boxes": [], "flips": [], "x": []}
    want_losses = []
    for i in range(STEPS):
        images = rng.integers(0, 256, (GLOBAL_BATCH, 40, 48, 3), dtype=np.uint8)
        labels = rng.integers(0, CLASSES, GLOBAL_BATCH).astype(np.int32)
        key = jax.random.fold_in(jax.random.PRNGKey(17), i)
        params, opt_state, loss = jax_step(params, opt_state,
                                           jax.device_put(jnp.asarray(images), sharded),
                                           jax.device_put(jnp.asarray(labels), sharded), key)
        want_losses.append(float(loss))
        k1, k2 = jax.random.split(key)
        x = jax_normalize_images(jax_random_flip(
            jax_random_resized_crop(jnp.asarray(images), k1, (SIDE, SIDE)), k2))
        inputs["images"].append(images)
        inputs["labels"].append(labels)
        inputs["boxes"].append(_jax_boxes(k1, GLOBAL_BATCH, 40, 48).numpy())
        inputs["flips"].append(_jax_flips(k2, GLOBAL_BATCH).numpy())
        inputs["x"].append(np.array(x.astype(jnp.float32)))
    np.savez(tmp_path / "inputs.npz", **{k: np.stack(v) for k, v in inputs.items()})
    assert params["params"]["Dense_0"]["kernel"].sharding.is_fully_replicated

    launch("dp_step", RANKS, {"out": str(tmp_path), "inputs": str(tmp_path / "inputs.npz"),
                              "state": str(tmp_path / "state.pt"), "feed": feed,
                              "classes": CLASSES, "side": SIDE}, timeout=180)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(RANKS)]
    # the ranks' leaves are one replicated state, bit for bit
    assert str(ranks[0]["digest"]) == str(ranks[1]["digest"])
    for name, value in ranks[0].items():
        assert np.array_equal(value, ranks[1][name]), name

    loss_rtol, leaf_tol = (1e-4, 5e-3) if feed == "augment" else (1e-6, 1e-6)
    np.testing.assert_allclose(ranks[0]["losses"], want_losses, rtol=loss_rtol)
    from petastorm_tpu_torch.convert import flax_from_resnet_state

    got = _leaves(flax_from_resnet_state({k: torch.from_numpy(v) for k, v in ranks[0].items()
                                          if k not in ("losses", "digest")}))
    want = _leaves(jax.device_get(params))
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0, atol=leaf_tol * np.abs(w).max(),
                                   err_msg=name)


def test_one_rank_steps_are_the_one_card_steps():
    """``block=(0, 1)`` and no group: the trainer of one card, draw for draw."""
    from petastorm_tpu_torch.examples.imagenet import train_resnet_cuda as trainer
    from petastorm_tpu_torch.models.resnet import ResNet

    def run(**kwargs):
        model = ResNet([1], num_classes=4, num_filters=8, dtype=torch.float32, device="cpu",
                       generator=torch.Generator().manual_seed(0))
        step = trainer.TrainStep(model, 4, 16, generator=torch.Generator().manual_seed(5),
                                 **kwargs)
        images = torch.randint(0, 256, (4, 20, 24, 3), dtype=torch.uint8,
                               generator=torch.Generator().manual_seed(1))
        losses = [float(step(images, torch.arange(4))) for _ in range(2)]
        return losses, trainer.leaves_digest(step), step.last_draws

    a, b = run(), run(block=(0, 1))
    assert a[0] == b[0] and a[1] == b[1]
    assert all(torch.equal(x, y) for x, y in zip(a[2], b[2]))


def test_a_rank_draws_its_block_of_the_global_draws():
    """Each rank keeps its block of the draws of the whole global batch, so
    the ranks' draws together are one process's draws for it."""
    from petastorm_tpu_torch.examples.imagenet import train_resnet_cuda as trainer
    from petastorm_tpu_torch.models.resnet import ResNet

    model = ResNet([1], num_classes=4, num_filters=8, dtype=torch.float32, device="cpu")
    blocks = []
    for index in range(4):
        step = trainer.TrainStep(model, 4, 16, generator=torch.Generator().manual_seed(9),
                                 block=(index, 4))
        blocks.append(step.draw(3, 20, 24, "cpu"))
    whole = trainer.TrainStep(model, 4, 16, generator=torch.Generator().manual_seed(9))
    boxes, flips = whole.draw(12, 20, 24, "cpu")
    assert torch.equal(torch.cat([b for b, _ in blocks]), boxes)
    assert torch.equal(torch.cat([f for _, f in blocks]), flips)


def test_scan_steps_over_a_host_staged_transport_raise(tmp_path, monkeypatch):
    """scan_steps > 1 over gloo with CUDA tensors (ranks sharing a card)
    would capture a host-staged collective: the trainer refuses and names
    the transport."""
    import torch.distributed as dist

    from petastorm_tpu_torch.examples.imagenet import train_resnet_cuda as trainer

    class _Mesh:
        pass

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "gloo")
    monkeypatch.setattr(trainer, "resolve_device", lambda d: torch.device("cuda", 0))
    monkeypatch.setattr(trainer.mesh_ops, "data_parallel_mesh", lambda **k: _Mesh())
    monkeypatch.setattr(trainer.mesh_ops, "mesh_group", lambda m: None)
    with pytest.raises(ValueError, match="gloo, host-staged"):
        trainer.train(str(tmp_path / "unused"), steps=4, global_batch=8, side=16,
                      device="cuda", scan_steps=4)
