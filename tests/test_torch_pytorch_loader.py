"""The port's torch adapter (``petastorm_tpu_torch.pytorch``).

The non-ngram cases of ``tests/test_pytorch_loader.py`` run against the
port, and the port's ``DataLoader`` is held batch for batch to
``petastorm_tpu.pytorch.DataLoader`` on the same dataset with the same
seeds: both shuffle with numpy's ``default_rng`` over the same arrival
order, so the comparison is exact.
"""

import decimal

import numpy as np
import pytest
import torch

from petastorm_tpu import pytorch as jax_pytorch
from petastorm_tpu.reader import make_reader as jax_make_reader

from petastorm_tpu_torch import CompressedImageCodec, Field, NdarrayCodec, Schema, make_reader, \
    write_dataset
from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.pytorch import BatchedDataLoader, DataLoader, decimal_friendly_collate

NUM_ROWS = 40


@pytest.fixture(scope="module")
def torch_dataset(tmp_path_factory):
    url = str(tmp_path_factory.mktemp("torch_ds") / "ds")
    schema = Schema("TorchSchema", [
        Field("id", np.int64),
        Field("val_u16", np.uint16),
        Field("val_u32", np.uint32),
        Field("vec", np.float32, (3,), NdarrayCodec()),
    ])
    rows = [{"id": i, "val_u16": i * 2, "val_u32": i * 3,
             "vec": np.full(3, i, np.float32)} for i in range(NUM_ROWS)]
    write_dataset(url, schema, rows, row_group_size_rows=8)
    return url


def _collect(loader):
    batches = list(loader)
    ids = torch.cat([b["id"] for b in batches]).tolist()
    return batches, ids


@pytest.mark.parametrize("batch_size,sizes", [(8, [8] * 5), (7, [7, 7, 7, 7, 7, 5])],
                         ids=["whole", "partial-final"])
def test_round_trip_values_and_batching(torch_dataset, batch_size, sizes):
    with make_reader(torch_dataset, shuffle_row_groups=False,
                     reader_pool_type="serial", num_epochs=1) as r:
        with DataLoader(r, batch_size=batch_size) as loader:
            batches, ids = _collect(loader)
    assert ids == list(range(NUM_ROWS))
    assert [len(b["id"]) for b in batches] == sizes
    first = batches[0]
    assert first["vec"].shape == (batch_size, 3)
    assert torch.equal(first["vec"][3], torch.full((3,), 3.0))


def test_dtype_promotions(torch_dataset):
    with make_reader(torch_dataset, num_epochs=1) as r:
        with DataLoader(r, batch_size=4) as loader:
            batch = next(iter(loader))
    assert batch["val_u16"].dtype == torch.int32
    assert batch["val_u32"].dtype == torch.int64
    assert batch["val_u16"].tolist() == [2 * i for i in batch["id"].tolist()]


def test_shuffling_changes_order_and_is_seeded(torch_dataset):
    def read(seed):
        with make_reader(torch_dataset, shuffle_row_groups=False,
                         reader_pool_type="serial", num_epochs=1) as r:
            with DataLoader(r, batch_size=8, shuffling_queue_capacity=20,
                            seed=seed) as loader:
                return _collect(loader)[1]

    a, b, c = read(7), read(7), read(8)
    assert sorted(a) == list(range(NUM_ROWS))
    assert a != list(range(NUM_ROWS))
    assert a == b
    assert a != c


def test_batched_loader_transform_fn(torch_dataset):
    with make_reader(torch_dataset, num_epochs=1) as r:
        with BatchedDataLoader(
                r, batch_size=8,
                transform_fn=lambda b: {"id_f": b["id"].float() * 2}) as loader:
            batch = next(iter(loader))
    assert batch["id_f"].dtype == torch.float32


def test_error_latch_and_reiteration_guard(torch_dataset):
    with make_reader(torch_dataset, num_epochs=1) as r:
        loader = DataLoader(r, batch_size=4,
                            collate_fn=lambda b: 1 / 0)  # raises in emit
        with pytest.raises(ZeroDivisionError):
            next(iter(loader))
        with pytest.raises(RuntimeError, match="previous iteration failed"):
            iter(loader).__next__()
        r.stop(), r.join()


def test_iterating_twice_at_once_is_refused(torch_dataset):
    with make_reader(torch_dataset, num_epochs=1) as r:
        loader = DataLoader(r, batch_size=4)
        first = iter(loader)
        next(first)
        with pytest.raises(RuntimeError, match="already being iterated"):
            next(iter(loader))
        with pytest.raises(TypeError, match="not known up front"):
            len(loader)


def test_string_fields_rejected(tmp_path):
    url = str(tmp_path / "str_ds")
    schema = Schema("S", [Field("id", np.int64),
                          Field("name", np.dtype("object"))])
    write_dataset(url, schema,
                  [{"id": i, "name": f"n{i}"} for i in range(10)],
                  row_group_size_rows=5)
    with make_reader(url, num_epochs=1) as r:
        with DataLoader(r, batch_size=2) as loader:
            with pytest.raises(TypeError, match="string"):
                next(iter(loader))


def test_variable_shape_becomes_list(tmp_path):
    url = str(tmp_path / "var_ds")
    schema = Schema("V", [Field("id", np.int64),
                          Field("pts", np.float32, (None, 2), NdarrayCodec())])
    rows = [{"id": i, "pts": np.ones((i + 1, 2), np.float32)}
            for i in range(6)]
    write_dataset(url, schema, rows, row_group_size_rows=3)
    with make_reader(url, shuffle_row_groups=False,
                     reader_pool_type="serial", num_epochs=1) as r:
        with DataLoader(r, batch_size=3) as loader:
            batch = next(iter(loader))
    assert isinstance(batch["pts"], list)
    assert batch["pts"][2].shape == (3, 2)


def test_decimal_friendly_collate():
    rows = [{"d": decimal.Decimal("1.5"), "x": torch.tensor(1)},
            {"d": decimal.Decimal("2.5"), "x": torch.tensor(2)}]
    out = decimal_friendly_collate(rows)
    assert torch.equal(out["d"], torch.tensor([1.5, 2.5], dtype=torch.float64))
    assert out["x"].tolist() == [1, 2]
    assert decimal_friendly_collate(decimal.Decimal("0.25")) == 0.25


# -- batch for batch against the JAX package's adapter --------------------------------


def _run(make, loader_cls, path, reader_kwargs, **kwargs):
    with make(path, reader_pool_type="serial", num_epochs=1, **reader_kwargs) as r:
        with loader_cls(r, **kwargs) as loader:
            return [{k: v.numpy() for k, v in b.items()} for b in loader]


@pytest.mark.parametrize("batch_size,capacity,seed,reader_kwargs", [
    (8, 0, None, {"shuffle_seed": 1}),
    (7, 20, 7, {"shuffle_row_groups": False}),
    (5, 12, 0, {"shuffle_seed": 4}),
    (16, 64, 123, {"shuffle_seed": 2}),
    (8, 20, None, {"shuffle_seed": 9}),     # seed derived from the reader's root
    (6, 16, None, {"shuffle_seed": 3, "deterministic": "seed"}),
], ids=["in-order", "seeded", "small", "wide", "derived", "derived-explicit"])
def test_data_loader_equals_jax_adapter(torch_dataset, batch_size, capacity, seed,
                                        reader_kwargs):
    kwargs = dict(batch_size=batch_size, shuffling_queue_capacity=capacity, seed=seed)
    got = _run(make_reader, DataLoader, torch_dataset, reader_kwargs, **kwargs)
    want = _run(jax_make_reader, jax_pytorch.DataLoader, torch_dataset, reader_kwargs,
                **kwargs)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
            assert g[k].dtype == w[k].dtype
    ids = np.concatenate([g["id"] for g in got])
    assert sorted(ids.tolist()) == list(range(NUM_ROWS))


def test_batched_loader_equals_jax_adapter(torch_dataset):
    def transform(b):
        return {"id2": b["id"] * 2, "vec": b["vec"] + 1}

    kwargs = dict(batch_size=8, shuffling_queue_capacity=16, seed=5, transform_fn=transform)
    got = _run(make_reader, BatchedDataLoader, torch_dataset, {"shuffle_seed": 0}, **kwargs)
    want = _run(jax_make_reader, jax_pytorch.BatchedDataLoader, torch_dataset,
                {"shuffle_seed": 0}, **kwargs)
    assert len(got) == len(want) == NUM_ROWS // 8
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["id2"], w["id2"])
        np.testing.assert_array_equal(g["vec"], w["vec"])


# -- what the adapter refuses ----------------------------------------------------------


def test_device_decode_readers_are_refused(tmp_path):
    schema = Schema("J", [Field("image", np.uint8, (16, 16, 3), CompressedImageCodec("jpeg"))])
    path = str(tmp_path / "ds")
    write_dataset(path, schema, [{"image": np.full((16, 16, 3), i, np.uint8)}
                                 for i in range(4)])
    with make_reader(path, num_epochs=1, decode_placement={"image": "device"}) as r:
        with pytest.raises(PetastormTpuError, match="decode_placement='host'"):
            DataLoader(r, batch_size=2)


def test_ngram_readers_and_bad_batch_sizes_are_refused(torch_dataset):
    """An ngram reader is no longer refused: a flat one is collated into
    ``{offset: {field: tensor}}``, a stacked one keeps the flat dict.  A bad
    batch size is still refused."""
    from petastorm_tpu_torch.ngram import NGram

    flat = NGram({0: ["id", "vec"], 1: ["id"]}, 1, "id")
    with make_reader(torch_dataset, num_epochs=1, shuffle_row_groups=False,
                     reader_pool_type="serial", ngram=flat) as r:
        batch = next(iter(DataLoader(r, batch_size=2)))
    assert set(batch) == {0, 1} and set(batch[0]) == {"id", "vec"} and set(batch[1]) == {"id"}
    assert torch.equal(batch[1]["id"], batch[0]["id"] + 1)
    stacked = NGram({0: ["id"], 1: ["id"]}, 1, "id", stack_timesteps=True)
    with make_reader(torch_dataset, num_epochs=1, shuffle_row_groups=False,
                     reader_pool_type="serial", ngram=stacked) as r:
        batch = next(iter(DataLoader(r, batch_size=2)))
        assert set(batch) == {"id"} and batch["id"].shape == (2, 2)
        with pytest.raises(PetastormTpuError, match="batch_size must be"):
            BatchedDataLoader(r, batch_size=0)
