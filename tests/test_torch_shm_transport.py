"""The port's shared-memory arena and batch transport against the JAX
package's (``petastorm_tpu/native/shm_arena.cpp``, ``native/transport.py``).

Both arena libraries build here with g++: the same sequence of allocations
and frees gives the same offsets, free bytes and largest free block.  The
transport round-trips a batch (object columns inline, an oversized batch
pickled), frees a block when the last array over it dies, and ships a
column decoded straight into an arena slot (``batch_slots``) with no copy,
equal to the plain decode.  Last, ``CudaDataLoader`` over a process-pool
reader: the batches of the thread pool, no arena view in what it delivers,
and its transport counters.
"""

import multiprocessing

import numpy as np
import pyarrow as pa
import pytest
import torch

from petastorm_tpu.native import SharedArena as JaxArena

from petastorm_tpu_torch import CompressedImageCodec, Field, Schema, codecs, reader
from petastorm_tpu_torch.batch import ColumnBatch
from petastorm_tpu_torch.cuda.loader import CudaDataLoader
from petastorm_tpu_torch.etl.writer import write_dataset
from petastorm_tpu_torch.native import SharedArena
from petastorm_tpu_torch.native import transport


@pytest.fixture(autouse=True)
def _no_child_left():
    yield
    assert multiprocessing.active_children() == []


@pytest.fixture
def arena():
    a = SharedArena.create(1 << 20)
    yield a
    a.close()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_alloc_free_sequence_equals_jax(seed):
    ours, theirs = SharedArena.create(1 << 20), JaxArena.create(1 << 20)
    try:
        rng = np.random.default_rng(seed)
        live = []
        for _ in range(400):
            if live and rng.random() < 0.45:
                off = live.pop(int(rng.integers(len(live))))
                ours.free(off)
                theirs.free(off)
            else:
                size = int(rng.integers(1, 64 << 10))
                off = ours.alloc(size)
                assert off == theirs.alloc(size)
                if off is not None:
                    assert off % 64 == 0
                    live.append(off)
            assert ours.free_bytes() == theirs.free_bytes()
            assert ours.largest_free() == theirs.largest_free()
        for off in live:
            ours.free(off)
            theirs.free(off)
        assert ours.free_bytes() == theirs.free_bytes() == ours.largest_free()
    finally:
        ours.close()
        theirs.close()


def test_double_free_and_a_full_arena_are_refused(arena):
    off = arena.alloc(1000)
    arena.free(off)
    with pytest.raises(RuntimeError, match="psa_free"):
        arena.free(off)
    assert arena.alloc(arena.size) is None  # no block fits


def test_round_trip_with_object_columns(arena):
    cells = np.empty(3, dtype=object)
    cells[:] = [b"a", b"bc", None]
    batch = ColumnBatch({"x": np.arange(3, dtype=np.int64),
                         "img": np.arange(3 * 4 * 5, dtype=np.uint8).reshape(3, 4, 5),
                         "cells": cells, "empty": np.zeros((3, 0), np.float32)}, 3)
    ref = transport.encode_batch(arena, batch)
    assert isinstance(ref, transport.ShmBatchRef)
    assert {k: v[0] for k, v in ref.columns.items()} == {
        "x": "shm", "img": "shm", "cells": "inline", "empty": "inline"}
    out = transport.decode_batch(arena, ref)
    assert out.num_rows == 3
    for name, col in batch.columns.items():
        assert out.columns[name].dtype == col.dtype
        assert list(out.columns[name]) == list(col) if col.dtype == object else \
            np.array_equal(out.columns[name], col)
    assert transport.is_arena_backed(out.columns["img"])
    assert not transport.is_arena_backed(out.columns["cells"])
    assert not transport.carries_raw_columns(ref) and transport.carries_raw_columns(batch)


def test_an_oversized_batch_and_a_full_arena_travel_pickled(arena, caplog):
    wide = ColumnBatch({"x": np.zeros(arena.size // 2 + 64, np.uint8)}, arena.size // 2 + 64)
    assert transport.encode_batch(arena, wide) is wide
    hog = arena.alloc(arena.size - 4096)
    small = ColumnBatch({"x": np.ones(8192, np.uint8)}, 8192)
    assert transport.encode_batch(arena, small, max_wait_s=0.05) is small
    arena.free(hog)
    assert isinstance(transport.encode_batch(arena, small), transport.ShmBatchRef)
    assert transport.encode_batch(arena, "not a batch") == "not a batch"


def test_a_lease_is_freed_with_the_last_array_over_it(arena):
    full = arena.free_bytes()
    batch = ColumnBatch({"a": np.arange(1000, dtype=np.int64),
                         "b": np.ones((1000, 3), np.float32)}, 1000)
    out = transport.decode_batch(arena, transport.encode_batch(arena, batch))
    a, b = out.columns["a"], out.columns["b"][10:20]
    del out
    assert arena.free_bytes() < full
    del a
    assert arena.free_bytes() < full  # b still holds the block
    del b
    assert arena.free_bytes() == full


def _jpeg_column(n=6, h=24, w=32):
    rng = np.random.default_rng(0)
    field = Field("image", np.uint8, (h, w, 3), CompressedImageCodec("jpeg", 90))
    images = [np.clip(rng.normal(128, 40, (h, w, 3)), 0, 255).astype(np.uint8) for _ in range(n)]
    cells = [field.codec.encode(field, img) for img in images]
    return field, pa.array(cells, pa.binary())


@pytest.mark.parametrize("roi", [None, (2, 3, 16, 20)])
def test_batch_slot_decode_equals_plain_decode_and_ships_without_a_copy(arena, roi):
    field, column = _jpeg_column()
    with codecs.decode_options(roi=roi):
        plain = field.codec.decode_column(field, column)
    slots = transport.SlotAllocator(arena)
    with transport._slot_scope(slots), codecs.decode_options(roi=roi, batch_slots=True):
        slotted = field.codec.decode_column(field, column)
    assert np.array_equal(slotted, plain)
    batch = ColumnBatch({"image": slotted, "label": np.arange(6)}, 6)
    ref = slots.finalize(transport.encode_batch(arena, batch, slots=slots))
    assert ref.columns["image"][0] == "slot" and transport.slot_column_count(ref) == 1
    assert transport.slot_row_count(ref) == 6
    del slotted, batch
    out = transport.decode_batch(arena, ref)
    assert np.array_equal(out.columns["image"], plain)
    del out
    assert arena.free_bytes() == arena.largest_free()  # every block back


def test_unclaimed_slots_are_freed_and_aliases_detached(arena):
    full = arena.free_bytes()
    slots = transport.SlotAllocator(arena)
    a = slots.alloc((4, 8), np.uint8)
    a[:] = 7
    # a transform kept a view of the slot; the batch falls back to pickling
    batch = ColumnBatch({"v": a[:, :4]}, 4)
    out = slots.finalize(batch)
    assert not np.shares_memory(out.columns["v"], a) and (out.columns["v"] == 7).all()
    assert arena.free_bytes() == full
    assert slots.alloc((arena.size,), np.uint8) is None  # wider than half the arena


def _image_dataset(tmp_path, n=32, rg=8):
    url = str(tmp_path / "images")
    schema = Schema("Img", [Field("image", np.uint8, (16, 16, 3), CompressedImageCodec("png")),
                            Field("label", np.int64)])
    rng = np.random.default_rng(1)
    write_dataset(url, schema, [{"image": rng.integers(0, 255, (16, 16, 3), dtype=np.uint8),
                                 "label": i} for i in range(n)], row_group_size_rows=rg)
    return url


def test_loader_over_the_process_pool_equals_the_thread_pool(tmp_path):
    url = _image_dataset(tmp_path)
    runs = {}
    for kind in ("thread", "process"):
        r = reader.make_reader(url, reader_pool_type=kind, workers_count=2, shuffle_seed=0)
        with CudaDataLoader(r, 8, device="cpu", host_fields=["label"]) as loader:
            batches = [{k: (v.clone() if isinstance(v, torch.Tensor) else v)
                        for k, v in b.items()} for b in loader]
            diag = loader.diagnostics()
        runs[kind] = (batches, diag)
    (want, _), (got, diag) = runs["thread"], runs["process"]
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert torch.equal(g["image"], w["image"])
        assert np.array_equal(g["label"], w["label"])
        # a host field is copied out of the arena before it is delivered
        assert not transport.is_arena_backed(g["label"])
    assert diag["shm_batches"] == 4 and diag["pickled_batches"] == 0
    assert 0 < diag["shm_high_water_bytes"] <= diag["transport"]["shm_size_bytes"]
    # PNG decodes natively into arena slots: every image went through one
    assert diag["transport"]["slot_rows"] == 32 and diag["transport"]["slot_columns"] == 4
