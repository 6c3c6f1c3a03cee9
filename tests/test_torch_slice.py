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
