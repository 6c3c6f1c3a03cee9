"""The port's ``BatchingQueue`` against ``petastorm_tpu.rebatch``, on the CPU.

The same stream of inputs of random sizes, as ``ColumnBatch``es,
``pa.Table``s or ``pa.RecordBatch``es, goes into both queues; the same
``get``/``flush`` calls must give the same exact-size batches, column for
column and byte for byte (integers, floats, fixed-shape arrays and object
cells), and the same refusals with the same messages.
"""

import numpy as np
import pyarrow as pa
import pytest

from petastorm_tpu import rebatch as jax_rebatch
from petastorm_tpu.batch import ColumnBatch as JaxColumnBatch
from petastorm_tpu.errors import PetastormTpuError as JaxError

from petastorm_tpu_torch import rebatch as torch_rebatch
from petastorm_tpu_torch.batch import ColumnBatch
from petastorm_tpu_torch.errors import PetastormTpuError


def _inputs(seed, n_inputs, kind):
    """``n_inputs`` batches of 0-9 rows; ids run on across them."""
    rng = np.random.default_rng(seed)
    out, start = [], 0
    for _ in range(n_inputs):
        n = int(rng.integers(0, 10))
        ids = np.arange(start, start + n, dtype=np.int64)
        start += n
        cols = {"id": ids, "x": rng.standard_normal(n).astype(np.float32),
                "vec": rng.integers(0, 255, (n, 3), dtype=np.uint8)}
        if kind == "column_batch":
            txt = np.empty(n, dtype=object)
            txt[:] = [f"r{i}" for i in ids]
            cols["txt"] = txt
            out.append(cols)
        else:
            table = pa.table({"id": ids, "x": cols["x"], "txt": [f"r{i}" for i in ids]})
            out.append(table if kind == "table" else
                       (table.to_batches()[0] if n else pa.RecordBatch.from_pylist(
                           [], schema=table.schema)))
    return out


def _wrap(item, batch_cls):
    return batch_cls(dict(item), len(item["id"])) if isinstance(item, dict) else item


def _drive(mod, batch_cls, inputs, batch_size, flush_every):
    """Put every input; take every full batch after each put; flush every
    ``flush_every`` inputs and at the end."""
    q = mod.BatchingQueue(batch_size)
    out = []
    for i, item in enumerate(inputs):
        q.put(_wrap(item, batch_cls))
        while q.can_get():
            out.append(("get", q.get(), len(q)))
        if flush_every and (i + 1) % flush_every == 0:
            out.append(("flush", q.flush(), len(q)))
    out.append(("flush", q.flush(), len(q)))
    out.append(("empty", q.empty(), q.batch_size))
    return out


def _assert_same(got, want):
    assert len(got) == len(want)
    for (g_op, g, g_len), (w_op, w, w_len) in zip(got, want):
        assert (g_op, g_len) == (w_op, w_len)
        if w is None or isinstance(w, bool):
            assert g == w
            continue
        assert g.num_rows == w.num_rows and list(g.columns) == list(w.columns)
        for name in w.columns:
            a, b = g.columns[name], w.columns[name]
            assert a.dtype == b.dtype and a.shape == b.shape
            if a.dtype == object:
                assert list(a) == list(b)
            else:
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["column_batch", "table", "record_batch"])
@pytest.mark.parametrize("batch_size", [1, 4, 7, 32])
@pytest.mark.parametrize("seed,flush_every", [(0, 0), (1, 3), (2, 0)])
def test_same_slices_as_jax(kind, batch_size, seed, flush_every):
    inputs = _inputs(seed, 12, kind)
    want = _drive(jax_rebatch, JaxColumnBatch, inputs, batch_size, flush_every)
    got = _drive(torch_rebatch, ColumnBatch, inputs, batch_size, flush_every)
    _assert_same(got, want)
    ids = np.concatenate([b.columns["id"] for op, b, _ in got if op != "empty" and b])
    total = sum(len(item["id"]) if isinstance(item, dict) else item.num_rows for item in inputs)
    np.testing.assert_array_equal(ids, np.arange(total))
    assert all(b.num_rows == batch_size for op, b, _ in got if op == "get")


def test_exact_batches_across_boundaries():
    q = torch_rebatch.BatchingQueue(4)
    q.put(ColumnBatch({"id": np.arange(3)}, 3))
    assert not q.can_get() and len(q) == 3
    q.put(pa.table({"id": np.arange(3, 9)}))
    assert q.get().columns["id"].tolist() == [0, 1, 2, 3]
    assert q.get().columns["id"].tolist() == [4, 5, 6, 7]
    assert q.flush().columns["id"].tolist() == [8]
    assert q.empty() and q.flush() is None


@pytest.mark.parametrize("case", ["batch_size", "bad_input", "get_short"])
def test_refusals_equal_jax(case):
    def run(mod, batch_cls):
        if case == "batch_size":
            mod.BatchingQueue(0)
        q = mod.BatchingQueue(4)
        if case == "bad_input":
            q.put({"id": np.arange(3)})
        q.put(batch_cls({"id": np.arange(3)}, 3))
        q.get()

    with pytest.raises(JaxError) as want:
        run(jax_rebatch, JaxColumnBatch)
    with pytest.raises(PetastormTpuError) as got:
        run(torch_rebatch, ColumnBatch)
    assert str(got.value) == str(want.value)
