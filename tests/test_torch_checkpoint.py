"""Cursor, drain, resume and checkpoints of the port against the JAX package.

Mirrors ``tests/test_checkpoint.py``.  On the serial pool both readers
deliver the plan's items in order, so after the same batches their
``state_dict()``s (``position``, ``items_per_epoch``, ``ordinal_exact``,
``stream_digest``) are equal, and so are the streams resumed from them.
Through a loader the cursor runs ahead of the delivered batches by a
timing-dependent window in both packages; the loaders' states are compared
where that window is empty (at exhaustion).  ``drain()`` makes the port's
cursor exact: drained and resumed rows cover the dataset once, and the
resumed reader's combined digest equals an uninterrupted reader's.
"""

import collections
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from petastorm_tpu.jax import JaxDataLoader
from petastorm_tpu.jax.checkpoint import resume_reader_kwargs as jax_resume_reader_kwargs
from petastorm_tpu.reader import make_batch_reader as jax_make_batch_reader

from petastorm_tpu_torch import Field, Schema, make_batch_reader, write_dataset
from petastorm_tpu_torch.checkpoint import (make_checkpoint_manager, restore_checkpoint,
                                            resume_reader_kwargs, save_checkpoint)
from petastorm_tpu_torch.cuda.loader import VALID_ROWS, CudaDataLoader
from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.examples.imagenet import train_resnet_cuda as trainer
from petastorm_tpu_torch.models.resnet import ResNet
from petastorm_tpu_torch.pool import make_executor
from petastorm_tpu_torch.seeding import StreamDigest

SCHEMA = Schema("Ckpt", [Field("id", np.int64), Field("x", np.float32, (4,))])
N_ROWS, RG_ROWS = 64, 8  # 8 rowgroups


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    url = str(tmp_path_factory.mktemp("ckpt") / "ds")
    rng = np.random.default_rng(0)
    write_dataset(url, SCHEMA, [{"id": i, "x": rng.standard_normal(4).astype(np.float32)}
                                for i in range(N_ROWS)], row_group_size_rows=RG_ROWS)
    return url


@pytest.fixture(scope="module")
def big_ds(tmp_path_factory):
    """Enough rowgroups that the in-flight window cannot hold the dataset."""
    url = str(tmp_path_factory.mktemp("ckpt_big") / "ds")
    rng = np.random.default_rng(1)
    write_dataset(url, SCHEMA, [{"id": i, "x": rng.standard_normal(4).astype(np.float32)}
                                for i in range(512)], row_group_size_rows=2)
    return url


class _Opaque:
    """A class a ``weights_only`` load must refuse to build."""


def _ids(batch):
    ids = batch["id"]
    valid = batch.get(VALID_ROWS, len(ids))
    return [int(v) for v in ids[:valid]]


# -- the reader's cursor and digest against the JAX reader ------------------------


@pytest.mark.parametrize("n", [0, 1, 5, 8, 13])
@pytest.mark.parametrize("layout", ["whole", "shard-1-of-3", "unshuffled"])
def test_reader_state_dict_equals_jax(ds, n, layout):
    kwargs = dict(reader_pool_type="serial", shuffle_seed=7, num_epochs=2)
    if layout == "shard-1-of-3":
        kwargs.update(cur_shard=1, shard_count=3)
        n = min(n, 5)  # 3 items an epoch on this shard
    elif layout == "unshuffled":
        kwargs.update(shuffle_row_groups=False)
    states = []
    for make in (make_batch_reader, jax_make_batch_reader):
        with make(ds, **kwargs) as r:
            it = r.iter_batches()
            ids = [next(it).columns["id"].tolist() for _ in range(n)]
            states.append((ids, r.state_dict(), r.stream_digest))
    (ids, state, digest), (want_ids, want_state, want_digest) = states
    assert ids == want_ids
    assert state == want_state
    assert set(state) == {"position", "items_per_epoch", "ordinal_exact", "stream_digest"}
    assert digest == want_digest and digest["batches"] == n


def test_resumed_stream_equals_jax(ds):
    """A cursor taken mid-epoch resumes to the same rows and the same digest in
    both packages; the resumed digest equals an uninterrupted reader's."""
    kwargs = dict(reader_pool_type="serial", shuffle_seed=3, num_epochs=2)
    with make_batch_reader(ds, **kwargs) as r:
        it = r.iter_batches()
        head = [next(it).columns["id"].tolist() for _ in range(11)]
        state = json.loads(json.dumps(r.state_dict()))  # a checkpoint's round trip
    runs = []
    for make in (make_batch_reader, jax_make_batch_reader):
        with make(ds, resume_from=state, **kwargs) as r:
            runs.append(([b.columns["id"].tolist() for b in r.iter_batches()],
                         r.state_dict(), r.stream_digest))
    (rest, end_state, digest), (want_rest, want_end, want_digest) = runs
    assert rest == want_rest and end_state == want_end and digest == want_digest
    with make_batch_reader(ds, **kwargs) as r:
        whole = [b.columns["id"].tolist() for b in r.iter_batches()]
        assert head + rest == whole
        assert r.stream_digest == digest  # the chain continued across the split
    assert end_state["position"] == 2 * (N_ROWS // RG_ROWS)


def test_stream_digest_folds_what_jax_folds():
    """The certificate's payloads, byte for byte: the same records give the
    same chain and summary, and its state round-trips."""
    from petastorm_tpu.seeding import StreamDigest as JaxStreamDigest

    ours, theirs = StreamDigest(), JaxStreamDigest()
    for d in (ours, theirs):
        d.record_batch(0, 0, 5, 1, 0, 8, 8)
        d.record_batch(0, 1, 2, 0, 0, 8, 7)
        d.record_skip(1, 2, 3, 0)
        d.record_batch(1, None, -1, -1, 0, 0, 4)
    assert ours.summary() == theirs.summary() and ours.state() == theirs.state()
    assert ours.combined == theirs.combined and ours.batches == 4
    assert StreamDigest(ours.state()).state() == ours.state()


# -- the pool's quiesce -------------------------------------------------------------


@pytest.mark.parametrize("kind", ["thread", "serial"])
def test_quiesce_under_stress_delivers_exactly_what_it_issued(kind):
    """More workers than cores, a short switch interval, and a quiesce from
    another thread at a random point: the consumer gets exactly the items
    the returned count says were issued, in order, from the start offset."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        rng = np.random.default_rng(0)
        for _ in range(20):
            executor = make_executor(kind, 2 * (os.cpu_count() or 4), 4)
            executor.start(lambda: (lambda item: 2 * item))
            start = int(rng.integers(0, 5))
            got = []
            consumer = threading.Thread(target=lambda: got.extend(
                executor.imap(iter(range(start, start + 10_000)), start=start)))
            consumer.start()
            time.sleep(float(rng.uniform(0, 0.01)))
            issued = executor.quiesce(start)
            consumer.join(timeout=30)
            executor.stop()
            assert not consumer.is_alive(), "the consumer did not finish after the quiesce"
            assert executor.quiesce(start) == issued  # a second quiesce changes nothing
            assert got == [2 * i for i in range(start, issued)]
    finally:
        sys.setswitchinterval(interval)


# -- the loader's cursor ------------------------------------------------------------


@pytest.mark.parametrize("stack", [1, 2])
def test_loader_state_dict_equals_jax_at_exhaustion(ds, stack):
    states = []
    for make, loader_cls in ((make_batch_reader, CudaDataLoader),
                             (jax_make_batch_reader, JaxDataLoader)):
        reader = make(ds, reader_pool_type="serial", shuffle_seed=5, num_epochs=1)
        extra = {"device": "cpu"} if loader_cls is CudaDataLoader else {}
        with loader_cls(reader, batch_size=8, stack_batches=stack, **extra) as loader:
            n = sum(1 for _ in loader)
            states.append((n, loader.state_dict()))
    (n, state), (want_n, want_state) = states
    assert n == want_n == 8 // stack
    assert state == want_state
    assert state["delivered_batches"] == n and state["stack_batches"] == stack
    assert state["reader"]["position"] == N_ROWS // RG_ROWS


def test_loader_state_dict_shape(ds):
    reader = make_batch_reader(ds, shuffle_row_groups=False, num_epochs=1)
    with CudaDataLoader(reader, 8, device="cpu") as loader:
        next(iter(loader))
        state = loader.state_dict()
    assert state["delivered_batches"] == 1 and state["global_batch"] == 8
    assert state["stack_batches"] == 1
    assert set(state["reader"]) == {"position", "items_per_epoch", "ordinal_exact",
                                    "stream_digest"}


def test_state_dict_and_drain_require_a_real_reader():
    class NoCursor:
        schema = SCHEMA

        def iter_batches(self):
            return iter(())

        def stop(self):
            pass

        def join(self):
            pass

    with CudaDataLoader(NoCursor(), 4, device="cpu") as loader:
        with pytest.raises(PetastormTpuError, match="state_dict"):
            loader.state_dict()
        with pytest.raises(PetastormTpuError, match="quiesce"):
            loader.drain()


@pytest.mark.parametrize("pool", ["thread", "serial"])
def test_drain_to_cursor_exact_resume(big_ds, pool):
    """drain() + state_dict() is an exact cursor: the resume re-reads no row
    and loses none, and the two halves' digest equals one uninterrupted
    reader's."""
    kwargs = dict(reader_pool_type=pool, shuffle_seed=5, num_epochs=1)
    if pool == "thread":
        kwargs.update(workers_count=4, results_queue_size=4)
    seen = []
    with make_batch_reader(big_ds, **kwargs) as r:
        with CudaDataLoader(r, 8, device="cpu", drop_last=False,
                            shuffling_queue_capacity=24, buffer_seed=0) as loader:
            it = iter(loader)
            for _ in range(2):
                seen.extend(_ids(next(it)))
            for b in loader.drain():
                seen.extend(_ids(b))
            state = loader.state_dict()
    assert state["reader"]["ordinal_exact"]
    resumed = []
    with make_batch_reader(big_ds, resume_from=state["reader"], **kwargs) as r:
        with CudaDataLoader(r, 8, device="cpu", drop_last=False) as loader:
            for b in loader:
                resumed.extend(_ids(b))
        digest = r.stream_digest
    counts = collections.Counter(seen + resumed)
    assert sorted(counts) == list(range(512)), "rows lost"
    assert max(counts.values()) == 1, "rows re-read: cursor was not exact"
    assert resumed, "the drain consumed everything; the resume proved nothing"
    with make_batch_reader(big_ds, **kwargs) as r:
        for _ in r.iter_batches():
            pass
        assert r.stream_digest == digest


def test_drain_after_exhaustion_is_empty(ds):
    with make_batch_reader(ds, num_epochs=1) as r:
        with CudaDataLoader(r, 8, device="cpu") as loader:
            assert sum(1 for _ in loader) == 8
            assert list(loader.drain()) == []
            assert loader.state_dict()["reader"]["position"] == 8


def test_drain_with_saturated_pipeline_no_deadlock(big_ds):
    """Every bounded stage full and the ventilator blocked on its window:
    drain() withdraws the blocked issue and flushes, and the cursor stays
    exact."""
    kwargs = dict(reader_pool_type="thread", workers_count=4, shuffle_seed=3, num_epochs=1)
    seen = []
    with make_batch_reader(big_ds, results_queue_size=4, **kwargs) as r:
        with CudaDataLoader(r, 8, device="cpu", drop_last=False) as loader:
            seen.extend(_ids(next(iter(loader))))
            time.sleep(1.0)  # let every bounded stage fill
            t0 = time.perf_counter()
            for b in loader.drain():
                seen.extend(_ids(b))
            assert time.perf_counter() - t0 < 30, "drain deadlocked"
            state = loader.state_dict()
    resumed = []
    with make_batch_reader(big_ds, resume_from=state["reader"], **kwargs) as r:
        with CudaDataLoader(r, 8, device="cpu", drop_last=False) as loader:
            for b in loader:
                resumed.extend(_ids(b))
    counts = collections.Counter(seen + resumed)
    assert sorted(counts) == list(range(512)) and max(counts.values()) == 1
    assert resumed


def test_drain_alignment_pads_carry_zero_masks(ds):
    """A peer drained 3 more units: this process pads with zero units, the
    last unit's shapes, '_valid_rows' 0 and a zero valid mask."""
    with make_batch_reader(ds, reader_pool_type="serial", shuffle_seed=1, num_epochs=1) as r:
        with CudaDataLoader(r, 8, device="cpu", drop_last=False,
                            valid_mask_field="mask") as loader:
            first = next(iter(loader))
            assert first["mask"].tolist() == [1.0] * 8
            drained = list(loader.drain(all_gather_counts=lambda mine: [mine, mine + 3]))
    real = [b for b in drained if b.get(VALID_ROWS, -1) != 0]
    pads = [b for b in drained if b.get(VALID_ROWS, -1) == 0]
    assert len(pads) == 3 and len(real) == len(drained) - 3
    for p in pads:
        assert p["id"].shape == real[-1]["id"].shape and p["id"].dtype == real[-1]["id"].dtype
        assert p["id"].sum() == 0 and p["x"].abs().sum() == 0
        assert p["mask"].tolist() == [0.0] * 8


def test_drain_zero_unit_process_synthesizes_pads(ds):
    """A process that drained nothing (quiesced before its first item) still
    yields pads, shaped from the schema, with the zero mask and host fields."""
    with make_batch_reader(ds, reader_pool_type="serial", num_epochs=1,
                           shuffle_row_groups=False) as r:
        with CudaDataLoader(r, 8, device="cpu", drop_last=False, fields=["x"],
                            host_fields=["id"], valid_mask_field="mask",
                            stack_batches=2) as loader:
            drained = list(loader.drain(all_gather_counts=lambda mine: [mine, 2]))
    assert len(drained) == 2
    for p in drained:
        assert p[VALID_ROWS].tolist() == [0, 0]
        assert p["x"].shape == (2, 8, 4) and p["x"].dtype == torch.float32
        assert p["mask"].shape == (2, 8) and p["mask"].sum() == 0
        assert isinstance(p["id"], np.ndarray) and p["id"].shape == (2, 8)
    assert loader.state_dict()["reader"]["position"] == 0


def test_drain_zero_unit_process_refuses_what_it_cannot_shape(ds):
    with make_batch_reader(ds, reader_pool_type="serial", num_epochs=1) as r:
        with CudaDataLoader(r, 8, device="cpu", transform_fn=lambda cols: cols) as loader:
            with pytest.raises(PetastormTpuError, match="transform_fn"):
                list(loader.drain(all_gather_counts=lambda mine: [mine, 1]))


# -- checkpoints ---------------------------------------------------------------


def test_checkpoint_round_trip(ds, tmp_path):
    """Train state and loader cursor in one step directory; the resume kwargs
    plug into a new reader and give the rest of the epoch."""
    train_state = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3), "step": 3,
                   "nested": {"g": torch.tensor([1, 2], dtype=torch.uint8)}}
    reader = make_batch_reader(ds, reader_pool_type="serial", shuffle_row_groups=False,
                               num_epochs=1)
    with CudaDataLoader(reader, 8, device="cpu") as loader:
        it = iter(loader)
        seen = _ids(next(it)) + _ids(next(it))
        drained = [i for b in loader.drain() for i in _ids(b)]
        manager = make_checkpoint_manager(str(tmp_path / "ckpts"), max_to_keep=2)
        assert save_checkpoint(manager, 3, train_state, loader)
    restored, loader_state = restore_checkpoint(manager, template=train_state)
    assert torch.equal(restored["w"], train_state["w"]) and restored["step"] == 3
    assert torch.equal(restored["nested"]["g"], train_state["nested"]["g"])
    assert loader_state["delivered_batches"] == 2 + len(drained) // 8
    kwargs = resume_reader_kwargs(loader_state)
    assert kwargs["resume_from"]["position"] == loader_state["reader"]["position"]
    with make_batch_reader(ds, reader_pool_type="serial", shuffle_row_groups=False,
                           num_epochs=1, **kwargs) as r:
        with CudaDataLoader(r, 8, device="cpu", drop_last=False) as loader2:
            rest = [i for b in loader2 for i in _ids(b)]
    assert seen + drained + rest == list(range(N_ROWS))


def test_checkpoint_max_to_keep_and_atomic_replace(tmp_path, monkeypatch):
    manager = make_checkpoint_manager(str(tmp_path / "c"), max_to_keep=2)
    for step in (1, 2, 3):
        save_checkpoint(manager, step, {"v": torch.tensor([step])}, {"reader": {"position": step}})
    assert manager.all_steps() == [2, 3] and manager.latest_step() == 3
    # saving a step again replaces it whole
    save_checkpoint(manager, 3, {"v": torch.tensor([30])}, {"reader": {"position": 30}})
    state, loader_state = restore_checkpoint(manager)
    assert state["v"].item() == 30 and loader_state["reader"]["position"] == 30
    assert restore_checkpoint(manager, step=2)[0]["v"].item() == 2
    assert sorted(os.listdir(manager.directory)) == ["2", "3"]  # no temporary left
    # a save that fails half way leaves the step as it was
    with pytest.raises(TypeError):
        save_checkpoint(manager, 3, {"v": torch.tensor([31])}, {"reader": object()})
    assert restore_checkpoint(manager)[0]["v"].item() == 30
    assert sorted(os.listdir(manager.directory)) == ["2", "3"]
    # a relative directory is made absolute up front
    monkeypatch.chdir(tmp_path)
    assert make_checkpoint_manager("rel", max_to_keep=1).directory == str(tmp_path / "rel")


def test_restore_refuses_a_mismatched_template_and_unsafe_pickles(tmp_path):
    manager = make_checkpoint_manager(str(tmp_path / "c"))
    save_checkpoint(manager, 0, {"w": torch.zeros(2, 3)}, {"reader": {}})
    with pytest.raises(PetastormTpuError, match="template"):
        restore_checkpoint(manager, template={"w": torch.zeros(3, 2)})
    with pytest.raises(PetastormTpuError, match="template has keys"):
        restore_checkpoint(manager, template={"w": torch.zeros(2, 3), "b": torch.zeros(1)})
    with pytest.raises(ValueError, match="No checkpoint"):
        restore_checkpoint(make_checkpoint_manager(str(tmp_path / "empty")))
    # weights_only loads refuse arbitrary objects
    save_checkpoint(manager, 1, {"obj": _Opaque()}, {"reader": {}})
    with pytest.raises(Exception, match="[Ww]eights"):
        restore_checkpoint(manager, step=1)


@pytest.mark.parametrize("state", [
    {"reader": {"position": 5, "items_per_epoch": 8, "ordinal_exact": True,
                "stream_digest": {"combined": 1, "epochs": {"0": 1}, "batches": 5, "rows": 40}},
     "delivered_batches": 4, "global_batch": 8, "stack_batches": 1},
    {"position": 3, "items_per_epoch": 4,
     "elastic_rebased": {"leftover_len": 2, "resume_epoch": 0, "base_items_per_epoch": 4}},
], ids=["loader-state", "reader-state"])
def test_resume_reader_kwargs_equals_jax(state):
    assert resume_reader_kwargs(state) == jax_resume_reader_kwargs(state)


def test_train_state_round_trip_is_bit_exact(tmp_path):
    """Model, optimizer momentum and augment generator through a checkpoint:
    equal bit for bit, and the next step of the restored trainer equals the
    next step of the saved one."""
    def fresh():
        model = ResNet([1], num_classes=4, num_filters=8, dtype=torch.float32, device="cpu",
                       generator=torch.Generator().manual_seed(0))
        return trainer.TrainStep(model, 4, 16, generator=torch.Generator().manual_seed(17))

    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 256, (3, 2, 20, 20, 3), dtype=np.uint8))
    labels = torch.tensor([[0, 3], [1, 2], [3, 3]])
    step = fresh()
    for i in range(2):
        step(images[i], labels[i])
    manager = make_checkpoint_manager(str(tmp_path / "c"))
    save_checkpoint(manager, 2, step.state_dict(), {"reader": {"position": 2}})
    restored = fresh()
    train_state, _ = restore_checkpoint(manager, template=restored.state_dict())
    restored.load_state_dict(train_state)
    for a, b in zip(step.leaves + step.momentum(), restored.leaves + restored.momentum()):
        assert torch.equal(a, b)
    assert torch.equal(step.generator.get_state(), restored.generator.get_state())
    assert torch.equal(step(images[2], labels[2]), restored(images[2], labels[2]))
    assert all(torch.equal(a, b) for a, b in zip(step.leaves, restored.leaves))
