"""The whole ImageNet-feed slice, JAX package against port, on the CPU.

JAX side: ``make_reader`` -> ``JaxDataLoader`` on one CPU device ->
``normalize_images(out_dtype=float32)`` -> the small flax ResNet.
Port side: ``make_reader`` -> ``CudaDataLoader(device="cpu")`` ->
``normalize_images`` -> the small torch ResNet with the converted weights.
Both read the same JPEG dataset with the serial pool and the same seed:
labels and images are equal batch for batch, and logits agree within the
float32 bound of ``test_torch_resnet.py`` (rtol 1e-4, atol 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from petastorm_tpu.jax import JaxDataLoader
from petastorm_tpu.models.resnet import ResNet as FlaxResNet
from petastorm_tpu.ops import normalize_images as jax_normalize_images
from petastorm_tpu.reader import make_reader as jax_make_reader

from petastorm_tpu_torch import CompressedImageCodec, Field, Schema, make_reader, write_dataset
from petastorm_tpu_torch.convert import resnet_state_from_flax
from petastorm_tpu_torch.cuda.loader import VALID_ROWS, CudaDataLoader
from petastorm_tpu_torch.batch import ColumnBatch
from petastorm_tpu_torch.shuffle import NoopShufflingBuffer, iter_batched
from petastorm_tpu_torch.models.resnet import ResNet
from petastorm_tpu_torch.ops import normalize_images

from test_torch_resnet import _randomized

N_ROWS, GROUP, BATCH = 44, 6, 8


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("slice") / "ds")
    rng = np.random.default_rng(0)
    schema = Schema("ImageNetTiny", [
        Field("label", np.int64),
        Field("image", np.uint8, (32, 32, 3), CompressedImageCodec("jpeg", quality=90)),
    ])
    write_dataset(path, schema, [{"label": int(i),
                                  "image": rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)}
                                 for i in range(N_ROWS)], row_group_size_rows=GROUP)
    return path


@pytest.fixture(scope="module")
def models():
    flax_model = FlaxResNet(stage_sizes=[1, 1], num_filters=8, num_classes=10,
                            dtype=jnp.float32)
    variables = _randomized(flax_model.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 32, 32, 3), jnp.float32)), 5)
    torch_model = ResNet([1, 1], num_classes=10, num_filters=8, dtype=torch.float32,
                         device="cpu")
    torch_model.load_state_dict(resnet_state_from_flax(variables), strict=True)
    return flax_model, variables, torch_model


def _jax_run(path, drop_last, flax_model, variables):
    kwargs = dict(batch_size=BATCH, drop_last=drop_last)
    if not drop_last:
        # '_valid_rows' and the zero-padded tail come with a mesh
        kwargs.update(mesh=Mesh(np.asarray(jax.devices()[:1]), ("data",)),
                      shardings=P("data"))
    reader = jax_make_reader(path, reader_pool_type="serial", shuffle_seed=3, num_epochs=1)
    out = []
    with JaxDataLoader(reader, **kwargs) as loader:
        for batch in loader:
            x = jax_normalize_images(batch["image"], out_dtype=jnp.float32)
            out.append((np.asarray(batch["label"]), np.asarray(batch["image"]),
                        np.asarray(flax_model.apply(variables, x)),
                        batch.get(VALID_ROWS)))
    return out


def _port_run(path, drop_last, torch_model):
    reader = make_reader(path, reader_pool_type="serial", shuffle_seed=3, num_epochs=1)
    out = []
    with CudaDataLoader(reader, BATCH, device="cpu", drop_last=drop_last) as loader, \
            torch.inference_mode():
        for batch in loader:
            x = normalize_images(batch["image"], out_dtype=torch.float32)
            out.append((batch["label"].numpy(), batch["image"].numpy(),
                        torch_model(x).numpy(), batch.get(VALID_ROWS)))
    return out


@pytest.mark.parametrize("drop_last", [True, False], ids=["drop_last", "padded_tail"])
def test_slice_matches_jax(dataset, models, drop_last):
    flax_model, variables, torch_model = models
    want = _jax_run(dataset, drop_last, flax_model, variables)
    got = _port_run(dataset, drop_last, torch_model)
    assert len(got) == len(want) == (N_ROWS // BATCH if drop_last else -(-N_ROWS // BATCH))
    for (gl, gi, glog, gv), (wl, wi, wlog, wv) in zip(got, want):
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(glog, wlog, rtol=1e-4, atol=1e-4)
        assert gv == wv
    if not drop_last:
        assert got[-1][3] == N_ROWS % BATCH
        assert not got[-1][0][N_ROWS % BATCH:].any()  # zero padding
    labels = np.concatenate([g[0][:g[3] or BATCH] for g in got])
    assert len(set(labels.tolist())) == len(labels)


def test_staging_never_aliases_delivered_batches(dataset):
    """The CPU loader hands out fresh tensors: holding every batch of an
    epoch, none was overwritten by a later one."""
    reader = make_reader(dataset, reader_pool_type="thread", shuffle_seed=1, num_epochs=2)
    with CudaDataLoader(reader, BATCH, device="cpu", prefetch=1) as loader:
        held = list(loader)
        snapshot = [b["label"].clone() for b in held]
    for b, s in zip(held, snapshot):
        assert torch.equal(b["label"], s)
    labels = torch.cat(snapshot).tolist()
    assert len(labels) == (2 * N_ROWS // BATCH) * BATCH
    assert max(labels.count(i) for i in set(labels)) == 2


def _batches(sizes):
    start = 0
    for n in sizes:
        yield ColumnBatch({"x": np.arange(start, start + n)}, n)
        start += n


@pytest.mark.parametrize("sizes,batch", [([5, 5, 5], 4), ([3], 8), ([8, 8], 8),
                                         ([1, 1, 1, 1, 1], 2), ([0, 7, 0, 2], 3)])
def test_assembly_exact_sizes_in_order(sizes, batch):
    rows = [b.columns["x"] for b in iter_batched(_batches(sizes), NoopShufflingBuffer(), batch)]
    assert all(len(r) == batch for r in rows[:-1])
    assert 0 < len(rows[-1]) <= batch
    np.testing.assert_array_equal(np.concatenate(rows), np.arange(sum(sizes)))


class _FakeEvent:
    """Stands in for a CUDA copy event: 'completes' only when synchronized."""

    def __init__(self, log):
        self.log, self.done = log, False

    def synchronize(self):
        self.done = True
        self.log.append("sync")


def test_pinned_slot_reused_only_after_its_copy_completed(dataset, monkeypatch):
    """The rotation over staging slots waits on each slot's previous copy
    event before writing into it again (checked without a GPU by swapping the
    copy for a recorder and running both producer stages in turn)."""
    import queue

    from petastorm_tpu_torch.cuda import loader as loader_mod

    reader = make_reader(dataset, reader_pool_type="serial", shuffle_seed=0, num_epochs=1)
    ld = CudaDataLoader(reader, BATCH, device="cpu", prefetch=2)
    ld._cuda = True
    log, events = [], []
    original_fill = ld._fill

    def fill(dest, item):
        slot = next(s for ring in ld._slots.values() for s in ring if s.host is dest)
        assert slot.copied is None or slot.copied.done, "slot overwritten before its copy ended"
        log.append("fill")
        return original_fill(dest, item)

    class _Context:
        def __init__(self, *args):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            pass

    def make_event():
        ev = _FakeEvent(log)
        ev.record = lambda stream: None
        events.append(ev)
        return ev

    class _UnpinnedSlot(loader_mod._Slot):
        def __init__(self, layout, batch_size, pin):
            super().__init__(layout, batch_size, pin=False)

    monkeypatch.setattr(loader_mod, "_Slot", _UnpinnedSlot)
    monkeypatch.setattr(torch.cuda, "stream", _Context)
    monkeypatch.setattr(torch.cuda, "device", _Context)
    monkeypatch.setattr(torch.cuda, "Event", make_event)
    ld._fill = fill
    # both stages in turn on this thread, through unbounded queues
    ld._host_q, ld._out = queue.Queue(), queue.Queue()
    ld._assemble()
    ld._transfer()
    delivered = [ld._out.get_nowait() for _ in range(ld._out.qsize())]
    n_batches = N_ROWS // BATCH
    assert log.count("fill") == n_batches
    (ring,) = ld._slots.values()
    assert log.count("sync") == n_batches - len(ring)
    assert len(events) == n_batches
    assert isinstance(delivered[-1], loader_mod._Done)
    assert [copied for _, copied in delivered[:-1]] == events


# -- the filtered and transformed feed: selector, predicate, row-drop
# partitions and a transform, through the loaders and the training step -----

import shutil  # noqa: E402

import petastorm_tpu.predicates as jax_predicates  # noqa: E402
import petastorm_tpu.selectors as jax_selectors  # noqa: E402
import petastorm_tpu.transform as jax_transform  # noqa: E402
from petastorm_tpu import pytorch as jax_pytorch  # noqa: E402

import petastorm_tpu_torch.predicates as torch_predicates  # noqa: E402
import petastorm_tpu_torch.selectors as torch_selectors  # noqa: E402
import petastorm_tpu_torch.transform as torch_transform  # noqa: E402
from petastorm_tpu_torch import pytorch as torch_pytorch  # noqa: E402
from petastorm_tpu_torch.etl.indexing import SingleFieldIndexer, build_rowgroup_index  # noqa: E402
from petastorm_tpu_torch.convert import flax_from_resnet_state  # noqa: E402
from petastorm_tpu_torch.examples.imagenet import train_resnet_cuda as trainer  # noqa: E402

from test_torch_augment import _jax_boxes, _jax_flips  # noqa: E402
from test_torch_train import CLASSES, _jax_step_fn, _leaves  # noqa: E402

FILTERED_ROWS, FILTERED_GROUP = 96, 8
#: labels of 9 of the 12 rowgroups: the selector's choice
FILTERED_SELECTED = [g * FILTERED_GROUP + 3 for g in (0, 1, 2, 4, 5, 7, 8, 10, 11)]


@pytest.fixture(scope="module")
def filtered_dataset(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("filtered") / "ds")
    rng = np.random.default_rng(1)
    schema = Schema("ImageNetTiny", [
        Field("label", np.int64),
        Field("image", np.uint8, (32, 32, 3), CompressedImageCodec("jpeg", quality=90)),
    ])
    write_dataset(path, schema, [{"label": int(i),
                                  "image": rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)}
                                 for i in range(FILTERED_ROWS)],
                  row_group_size_rows=FILTERED_GROUP)
    copy = str(tmp_path_factory.mktemp("filtered_indexed") / "ds")
    shutil.copytree(path, copy)
    build_rowgroup_index(copy, [SingleFieldIndexer("label_ix", "label")])
    return copy


def _target(cols):
    return {"image": cols["image"], "target": cols["label"] % CLASSES}


def _filtered_kwargs(predicates, selectors, decode, transform=None, **extra):
    kw = dict(reader_pool_type="serial", shuffle_seed=0, num_epochs=1,
              decode_placement={"image": decode},
              rowgroup_selector=selectors.SingleIndexSelector("label_ix", FILTERED_SELECTED),
              predicate=predicates.in_pseudorandom_split([0.75, 0.25], 0, "label"),
              shuffle_row_drop_partitions=2, **extra)
    if transform is not None:
        kw["transform_spec"] = transform.TransformSpec(
            _target, edit_fields=[("target", np.int64, (), False)], removed_fields=["label"])
    return kw


def test_filtered_device_decode_feed_trains_like_jax(filtered_dataset):
    """Selector + predicate + drop partitions with decode_placement='device':
    two training steps of the port (CudaDataLoader on the CPU, B2's plain
    version, TrainStep) against JaxDataLoader + the JAX step, within
    ``test_torch_train.py``'s ``augment`` bounds."""
    flax_model = FlaxResNet(stage_sizes=[1, 1], num_filters=8, num_classes=CLASSES,
                             dtype=jnp.float32)
    variables = _randomized(flax_model.init(jax.random.PRNGKey(3),
                                            jnp.zeros((1, 32, 32, 3), jnp.float32)), 11)
    model = ResNet([1, 1], num_classes=CLASSES, num_filters=8, dtype=torch.float32,
                   device="cpu")
    model.load_state_dict(resnet_state_from_flax(variables), strict=True)
    step = trainer.TrainStep(model, CLASSES, 32)
    tx, jax_step = _jax_step_fn(flax_model)
    params, opt_state = variables, tx.init(variables)

    jax_reader = jax_make_reader(filtered_dataset, **_filtered_kwargs(
        jax_predicates, jax_selectors, "device"))
    reader = make_reader(filtered_dataset, **_filtered_kwargs(
        torch_predicates, torch_selectors, "device"))
    with JaxDataLoader(jax_reader, batch_size=BATCH) as jax_loader, \
            CudaDataLoader(reader, BATCH, device="cpu") as loader:
        pairs = list(zip(jax_loader, loader))
        coef_images = reader.decode_stats()["coef_batch_images"]
    survivors = [int(v) for v in range(FILTERED_ROWS)
                 if v in {x for g in FILTERED_SELECTED for x in range(
                     g - 3, g - 3 + FILTERED_GROUP)}
                 and torch_predicates.in_pseudorandom_split([0.75, 0.25], 0, "label")
                 .do_include({"label": v})]
    assert coef_images == len(survivors)  # the masked rows were never entropy-decoded
    assert len(pairs) == len(survivors) // BATCH >= 2
    for i, (want, got) in enumerate(pairs[:2]):
        np.testing.assert_array_equal(got["label"].numpy(), np.asarray(want["label"]))
        _assert_decoded_close(got["image"].numpy(), np.asarray(want["image"]))
        labels = np.asarray(want["label"]) % CLASSES
        key = jax.random.fold_in(jax.random.PRNGKey(17), i)
        params, opt_state, want_loss = jax_step(params, opt_state, want["image"],
                                                jnp.asarray(labels), key)
        k1, k2 = jax.random.split(key)
        loss = step(got["image"], torch.from_numpy(labels).long(),
                    boxes=_jax_boxes(k1, BATCH, 32, 32), flips=_jax_flips(k2, BATCH))
        assert abs(float(loss) - float(want_loss)) <= 1e-4 * abs(float(want_loss))
    want_leaves = _leaves(jax.device_get(params))
    got_leaves = _leaves(flax_from_resnet_state(model.state_dict()))
    assert got_leaves.keys() == want_leaves.keys()
    for name, w in want_leaves.items():
        np.testing.assert_allclose(got_leaves[name], w, rtol=0, atol=5e-3 * np.abs(w).max(),
                                   err_msg=name)


def _assert_decoded_close(got, want):
    """B2's plain version against the JAX package's device decode: within
    1 LSB (``test_torch_jpeg.py``'s bound)."""
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1


def _jax_batches(path, batch_size=BATCH, **loader_kwargs):
    reader = jax_make_reader(path, **_filtered_kwargs(jax_predicates, jax_selectors, "host",
                                                      jax_transform))
    kwargs = dict(batch_size=batch_size, drop_last=False,
                  mesh=Mesh(np.asarray(jax.devices()[:1]), ("data",)), shardings=P("data"))
    kwargs.update(loader_kwargs)
    with JaxDataLoader(reader, **kwargs) as loader:
        return [{k: np.asarray(v) for k, v in b.items()} for b in loader]


def _port_batches(path, batch_size=BATCH, **loader_kwargs):
    reader = make_reader(path, **_filtered_kwargs(torch_predicates, torch_selectors, "host",
                                                  torch_transform))
    with CudaDataLoader(reader, batch_size, device="cpu", drop_last=False,
                        **loader_kwargs) as loader:
        return [{k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
                 for k, v in b.items()} for b in loader], reader


@pytest.mark.parametrize("stack", [None, 2])
def test_filtered_transformed_host_feed_equals_jax(filtered_dataset, stack):
    """Uneven rowgroups (drop partitions cut by the predicate) with a
    transform that adds, retypes and removes fields assemble into the JAX
    loader's batches, also stacked."""
    extra = {"stack_batches": stack} if stack else {}
    want = _jax_batches(filtered_dataset, **extra)
    got, reader = _port_batches(filtered_dataset, **extra)
    assert list(reader.schema.fields) == ["image", "target"]
    assert len(got) == len(want) >= 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    flat = np.concatenate([b["target"].reshape(-1) for b in got])
    assert flat.max() < CLASSES


def test_filtered_feed_through_the_device_shuffle_buffer(filtered_dataset):
    """The device shuffle buffer over predicate-cut rowgroups: full batches,
    the unshuffled feed's rows in another order."""
    plain, _ = _port_batches(filtered_dataset)
    shuffled, _ = _port_batches(filtered_dataset, device_shuffle_capacity=2,
                                device_shuffle_seed=0)

    def rows(batches):
        out = []
        for b in batches:
            n = int(b.get(VALID_ROWS, len(b["target"])))
            out += [(int(t), int(img.sum())) for t, img in zip(b["target"][:n], b["image"][:n])]
        return out

    assert sorted(rows(shuffled)) == sorted(rows(plain))
    assert rows(shuffled) != rows(plain)
    assert all(b["target"].shape == (BATCH,) for b in shuffled)


def test_torch_adapter_takes_a_transformed_reader(filtered_dataset):
    """``pytorch.BatchedDataLoader`` over a reader with a transform_spec: the
    JAX package's adapter's batches, shuffled by the same seed."""
    out = []
    for make, preds, sels, tf, adapter in (
            (jax_make_reader, jax_predicates, jax_selectors, jax_transform, jax_pytorch),
            (make_reader, torch_predicates, torch_selectors, torch_transform, torch_pytorch)):
        reader = make(filtered_dataset, **_filtered_kwargs(preds, sels, "host", tf))
        with adapter.BatchedDataLoader(reader, batch_size=BATCH, shuffling_queue_capacity=16,
                                       seed=0) as loader:
            out.append([{k: v.numpy() for k, v in b.items()} for b in loader])
    want, got = out
    assert len(got) == len(want) >= 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["image", "target"]
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
