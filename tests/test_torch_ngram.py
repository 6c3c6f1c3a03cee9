"""The port's NGram reader against ``petastorm_tpu.ngram`` and the JAX reader.

On the CPU, with numpy-seeded inputs: ``window_starts`` and ``form_windows``
(stacked and flat) over random timestamp sequences with gaps, ties and
unsorted rows; ``output_schema`` and the namedtuple types; and
``make_reader(ngram=...)`` end to end on one dataset, read by both packages
with the serial pool and the same seeds, with and without row-drop
partitions, without overlap, under a shuffle seed, with a predicate and
with a transform whose output is windowed.  Every output is an integer, a
gathered row or a key, so everything must match exactly: the same window
starts, the same gathered rows, the same keys in the same order, the same
stream digest.  The loaders over an ngram reader (``CudaDataLoader`` on the
CPU and the torch adapter) are held to the JAX package's loaders, and every
refusal to the JAX message.
"""

import numpy as np
import pytest
import torch

from petastorm_tpu import ngram as jax_ngram
from petastorm_tpu import schema as jax_schema
from petastorm_tpu.batch import ColumnBatch as JaxColumnBatch
from petastorm_tpu.errors import PetastormTpuError as JaxError
from petastorm_tpu.jax import JaxDataLoader
from petastorm_tpu.predicates import in_lambda as jax_in_lambda
from petastorm_tpu.pytorch import DataLoader as JaxTorchDataLoader
from petastorm_tpu.reader import make_batch_reader as jax_make_batch_reader
from petastorm_tpu.reader import make_reader as jax_make_reader
from petastorm_tpu.transform import TransformSpec as JaxTransformSpec

from petastorm_tpu_torch import codecs as torch_codecs
from petastorm_tpu_torch import ngram as torch_ngram
from petastorm_tpu_torch import schema as torch_schema
from petastorm_tpu_torch.batch import ColumnBatch
from petastorm_tpu_torch.cuda.loader import CudaDataLoader
from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.etl.writer import write_dataset
from petastorm_tpu_torch.predicates import in_lambda
from petastorm_tpu_torch.pytorch import DataLoader
from petastorm_tpu_torch.reader import make_batch_reader, make_reader
from petastorm_tpu_torch.transform import TransformSpec

MODS = {"jax": (jax_ngram, jax_schema, JaxColumnBatch),
        "torch": (torch_ngram, torch_schema, ColumnBatch)}


def _ts_sequence(rng, n, ties=True):
    """Sorted timestamps: runs of deltas 0-2 (0 only with ``ties``) broken by
    gaps of 5-20."""
    deltas = rng.choice([0, 1, 1, 2] if ties else [1, 1, 2], n)
    gaps = rng.random(n) < 0.15
    deltas = np.where(gaps, rng.integers(5, 21, n), deltas)
    return np.cumsum(deltas).astype(np.int64)


def _field_schema(mod):
    return mod.Schema("TS", [
        mod.Field("ts", np.int64),
        mod.Field("value", np.float32, (2,)),
        mod.Field("aux", np.int32),
        mod.Field("txt", np.dtype(object)),
        mod.Field("maybe", np.int64, nullable=True),
        mod.Field("var", np.float32, (None,)),
    ])


def _columns(rng, ts):
    n = len(ts)
    txt = np.empty(n, dtype=object)
    txt[:] = [f"t{i}" for i in range(n)]
    var = np.empty(n, dtype=object)
    var[:] = [np.full(i % 3 + 1, i, np.float32) for i in range(n)]
    return {"ts": ts, "value": rng.standard_normal((n, 2)).astype(np.float32),
            "aux": np.arange(n, dtype=np.int32), "txt": txt,
            "maybe": rng.integers(0, 9, n).astype(np.int64), "var": var}


def _assert_batches_equal(got, want):
    assert got.num_rows == want.num_rows
    assert list(got.columns) == list(want.columns)
    for name, w in want.columns.items():
        g = got.columns[name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if w.dtype == object:
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


SPECS = {
    "pair": ({0: ["value"], 1: ["value"]}, 1),
    "triple_ts": ({0: ["ts", "value"], 1: ["value"], 2: ["value", "aux"]}, 2),
    "negative": ({-1: ["value", "txt"], 0: ["value", "aux", "maybe"], 1: ["var"]}, 1),
    "single": ({0: ["value", "aux"]}, 0),
    "regex": ({0: ["v.*", "aux"], 1: ["v.*"], 2: ["v.*", "ts"], 3: ["value"]}, 2),
    "ties_zero": ({0: ["aux"], 1: ["aux"], 2: ["aux"]}, 0),
}


def _ngram(mod, spec, **kwargs):
    fields, delta = SPECS[spec]
    return mod.NGram(fields, delta, "ts", **kwargs)


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("spec", sorted(SPECS))
@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "no_overlap"])
def test_window_starts_equal_jax(seed, spec, overlap):
    rng = np.random.default_rng(seed)
    ts = _ts_sequence(rng, int(rng.integers(0, 60)))
    lo = int(rng.integers(0, max(len(ts), 1)))
    hi = int(rng.integers(lo, len(ts) + 2))
    for anchor in (None, (lo, hi)):
        want = _ngram(jax_ngram, spec, timestamp_overlap=overlap).window_starts(ts, anchor)
        got = _ngram(torch_ngram, spec, timestamp_overlap=overlap).window_starts(ts, anchor)
        assert got.dtype == want.dtype == np.int64
        np.testing.assert_array_equal(got, want)
    if not overlap and len(got) > 1:
        assert (np.diff(got) >= torch_ngram.NGram(*SPECS[spec][:1], 0, "ts").length).all()


def test_window_starts_examples():
    ng = torch_ngram.NGram({0: ["value"], 1: ["value"]}, delta_threshold=2, timestamp_field="ts")
    assert ng.window_starts(np.array([0, 1, 2, 10, 11])).tolist() == [0, 1, 3]
    assert ng.window_starts(np.arange(10), anchor_range=(3, 6)).tolist() == [3, 4, 5]
    no = torch_ngram.NGram({0: ["v"], 1: ["v"]}, 10, "ts", timestamp_overlap=False)
    assert no.window_starts(np.arange(6)).tolist() == [0, 2, 4]
    # the greedy pick runs before the anchor filter: a slice starting at an
    # odd row keeps the global picks, not its own
    assert no.window_starts(np.arange(6), anchor_range=(1, 6)).tolist() == [2, 4]


@pytest.mark.parametrize("seed", range(4))
def test_unsorted_window_starts_refused_like_jax(seed):
    rng = np.random.default_rng(seed)
    ts = rng.permutation(_ts_sequence(rng, 12, ties=False))
    with pytest.raises(JaxError) as want:
        _ngram(jax_ngram, "pair").window_starts(ts)
    with pytest.raises(PetastormTpuError) as got:
        _ngram(torch_ngram, "pair").window_starts(ts)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("spec", sorted(SPECS))
@pytest.mark.parametrize("stack", [False, True], ids=["flat", "stacked"])
@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "no_overlap"])
def test_form_windows_equal_jax(seed, spec, stack, overlap):
    """Unsorted rows (with ties: the stable sort keeps their order), anchors
    on half the seeds."""
    rng = np.random.default_rng(100 + seed)
    ts = _ts_sequence(rng, int(rng.integers(1, 40)))
    cols = _columns(rng, ts)
    order = rng.permutation(len(ts)) if seed % 2 else np.arange(len(ts))
    cols = {k: v[order] for k, v in cols.items()}
    anchor = (2, len(ts) - 1) if seed % 4 >= 2 else None
    outs = []
    for mod, smod, batch_cls in MODS.values():
        ng = _ngram(mod, spec, timestamp_overlap=overlap, stack_timesteps=stack)
        outs.append(ng.form_windows(_field_schema(smod), batch_cls(dict(cols), len(ts)),
                                    anchor_range=anchor))
    want, got = outs
    _assert_batches_equal(got, want)


@pytest.mark.parametrize("spec", sorted(SPECS))
@pytest.mark.parametrize("stack", [False, True], ids=["flat", "stacked"])
def test_output_schema_and_types_equal_jax(spec, stack):
    got_ng = _ngram(torch_ngram, spec, stack_timesteps=stack)
    want_ng = _ngram(jax_ngram, spec, stack_timesteps=stack)
    got_s = got_ng.output_schema(_field_schema(torch_schema))
    want_s = want_ng.output_schema(_field_schema(jax_schema))
    assert got_s.to_json() == want_s.to_json()
    assert got_ng.required_fields(_field_schema(torch_schema)) == \
        want_ng.required_fields(_field_schema(jax_schema))
    got_t = got_ng.make_namedtuple_types(_field_schema(torch_schema))
    want_t = want_ng.make_namedtuple_types(_field_schema(jax_schema))
    assert {k: v._fields for k, v in got_t.items()} == {k: v._fields for k, v in want_t.items()}
    assert got_ng.offsets == want_ng.offsets and got_ng.length == want_ng.length


def test_output_schema_of_the_stacked_example():
    ng = torch_ngram.NGram({0: ["value", "ts"], 1: ["value"]}, 5, "ts", stack_timesteps=True)
    out = ng.output_schema(_field_schema(torch_schema))
    assert [f.name for f in out] == ["value", "0/ts"] and out["value"].shape == (2, 2)


def test_equality_hash_and_refusals_equal_jax():
    for mod in (jax_ngram, torch_ngram):
        a = mod.NGram({0: ["v"], 1: ["v"]}, 5, "ts")
        assert a == mod.NGram({0: ["v"], 1: ["v"]}, 5, "ts")
        assert hash(a) == hash(mod.NGram({1: ["v"], 0: ["v"]}, 5, "ts"))
        for other in (mod.NGram({0: ["v"], 1: ["v"], 2: ["v"]}, 5, "ts"),
                      mod.NGram({0: ["v"], 1: ["v"]}, 4, "ts"),
                      mod.NGram({0: ["v"], 1: ["v"]}, 5, "ts", timestamp_overlap=False),
                      mod.NGram({0: ["v"], 1: ["v"]}, 5, "ts", stack_timesteps=True)):
            assert a != other
    assert torch_ngram.NGram({0: ["v"]}, 1, torch_schema.Field("ts", np.int64)).timestamp_field \
        == "ts"
    for fields in ({}, {0: ["v"], 2: ["v"]}):
        with pytest.raises(JaxError) as want:
            jax_ngram.NGram(fields, 1, "ts")
        with pytest.raises(PetastormTpuError) as got:
            torch_ngram.NGram(fields, 1, "ts")
        assert str(got.value) == str(want.value)


# -- make_reader(ngram=...) end to end ------------------------------------------

GROUP = 16


def _dataset_schema():
    return torch_schema.Schema("Frames", [
        torch_schema.Field("ts", np.int64),
        torch_schema.Field("label", np.int64),
        torch_schema.Field("value", np.float32, (2,), torch_codecs.NdarrayCodec()),
        torch_schema.Field("img", np.uint8, (4, 5, 3), torch_codecs.CompressedImageCodec("png")),
    ])


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """6 rowgroups of 16 rows, stored sorted by ``ts``: clips of consecutive
    timestamps with gaps (and a tie) inside rowgroups."""
    rng = np.random.default_rng(7)
    ts = _ts_sequence(rng, 6 * GROUP)
    rows = [{"ts": int(t), "label": i, "value": np.full(2, i, np.float32),
             "img": rng.integers(0, 256, (4, 5, 3), dtype=np.uint8)} for i, t in enumerate(ts)]
    path = str(tmp_path_factory.mktemp("ngram") / "ds")
    write_dataset(path, _dataset_schema(), rows, row_group_size_rows=GROUP)
    return path


def _double_value(cols):
    return {**cols, "twice": cols["value"] * 2}


def _reader_kwargs(which, case):
    """Both packages' arguments of one end-to-end case."""
    ngram_mod, spec_mod = {"jax": (jax_ngram, jax_schema), "torch": (torch_ngram, torch_schema)}[
        which]
    pred_fn = jax_in_lambda if which == "jax" else in_lambda
    spec_cls = JaxTransformSpec if which == "jax" else TransformSpec
    fields = {0: ["ts", "label", "value"], 1: ["value", "img"], 2: ["ts", "value"]}
    kw = dict(shuffle_row_groups=False)
    ng = {}
    if case == "drop2":
        kw = dict(shuffle_seed=0, shuffle_row_drop_partitions=2)
    elif case == "drop3_no_overlap":
        kw = dict(shuffle_seed=1, shuffle_row_drop_partitions=3)
        ng = dict(timestamp_overlap=False)
    elif case == "no_overlap":
        ng = dict(timestamp_overlap=False)
    elif case == "seeded":
        kw = dict(shuffle_seed=5)
    elif case == "stacked_seeded":
        kw = dict(shuffle_seed=2, shuffle_row_drop_partitions=2)
        ng = dict(stack_timesteps=True)
        fields = {0: ["ts", "label", "img"], 1: ["ts", "img"], 2: ["ts", "img"]}
    elif case == "predicate":
        kw = dict(shuffle_seed=3, predicate=pred_fn(["label"], lambda c: c["label"] % 7 != 3,
                                                    vectorized=True))
    elif case == "transform":
        kw = dict(shuffle_seed=4, shuffle_row_drop_partitions=2,
                  transform_spec=spec_cls(_double_value,
                                          edit_fields=[("twice", np.float32, (2,), False)]))
        # the transform sees only the fields the NGram reads: 'value' too
        fields = {0: ["ts", "value", "twice"], 1: ["twice", "label"], 2: ["twice"]}
    elif case == "regex_fields":
        fields = {0: ["l.*", spec_mod.Field("ts", np.int64)], 1: ["value"]}
    return dict(reader_pool_type="serial", num_epochs=2, **kw,
                ngram=ngram_mod.NGram(fields, 2, "ts", **ng))


CASES = ["plain", "drop2", "drop3_no_overlap", "no_overlap", "seeded", "stacked_seeded",
         "predicate", "transform", "regex_fields"]


def _batches(factory, path, kwargs):
    with factory(path, **kwargs) as r:
        out = list(r.iter_batches())
        return out, r.stream_digest, [f.to_json() for f in r.output_schema], r.last_row_consumed


@pytest.mark.parametrize("case", CASES)
def test_windows_equal_jax_reader(dataset, case):
    want, want_digest, want_schema, want_last = _batches(jax_make_reader, dataset,
                                                         _reader_kwargs("jax", case))
    got, got_digest, got_schema, got_last = _batches(make_reader, dataset,
                                                     _reader_kwargs("torch", case))
    assert got_schema == want_schema
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)
    assert got_digest == want_digest
    assert got_last == want_last


@pytest.mark.parametrize("case", ["plain", "drop2", "no_overlap", "predicate", "transform"])
def test_window_rows_equal_jax_reader(dataset, case):
    """The row path: one window as ``{offset: namedtuple}``, and
    ``last_row_consumed`` after each window."""
    def rows(factory, kwargs):
        out = []
        with factory(dataset, **kwargs) as r:
            for window in r:
                out.append(({off: (type(nt).__name__, nt._fields,
                                   [np.asarray(v).tolist() for v in nt])
                             for off, nt in window.items()}, r.last_row_consumed))
        return out

    want = rows(jax_make_reader, _reader_kwargs("jax", case))
    got = rows(make_reader, _reader_kwargs("torch", case))
    assert got == want and got[-1][1] and not got[0][1]


def test_drop_partitions_lose_and_double_no_window(dataset):
    """Two drop partitions give each valid window of a rowgroup once."""
    ng = torch_ngram.NGram({0: ["ts", "label"], 1: ["ts"], 2: ["ts"]}, 2, "ts")
    with make_reader(dataset, reader_pool_type="serial", shuffle_seed=0,
                     shuffle_row_drop_partitions=2, ngram=ng) as r:
        starts = sorted(int(v) for b in r.iter_batches() for v in b.columns["0/label"])
    with make_reader(dataset, reader_pool_type="serial", shuffle_row_groups=False) as r:
        want = [int(g * GROUP + s) for g, b in enumerate(r.iter_batches())
                for s in ng.window_starts(b.columns["ts"])]
    assert starts == sorted(want) and len(set(starts)) == len(starts)


def test_stacked_reader_refuses_row_access_like_jax(dataset):
    with jax_make_reader(dataset, **_reader_kwargs("jax", "stacked_seeded")) as r:
        with pytest.raises(JaxError) as want:
            next(r)
    with make_reader(dataset, **_reader_kwargs("torch", "stacked_seeded")) as r:
        with pytest.raises(PetastormTpuError) as got:
            next(r)
    assert str(got.value) == str(want.value)


def test_reader_schema_and_ngram_attributes(dataset):
    kwargs = _reader_kwargs("torch", "transform")
    with make_reader(dataset, **kwargs) as r:
        assert r.ngram == kwargs["ngram"]
        assert list(r.schema.fields) == ["ts", "label", "value", "img", "twice"]
        assert [f.name for f in r.output_schema] == ["0/ts", "0/value", "0/twice", "1/twice",
                                                     "1/label", "2/twice"]
    with make_reader(dataset, reader_pool_type="serial") as r:
        assert r.ngram is None and r.output_schema is r.schema


def test_cache_keys_include_the_lookahead_span(dataset, tmp_path):
    """Two readers of two ngram lengths sharing one disk cache must not
    serve each other's (differently sized) lookahead spans."""
    cache_dir = str(tmp_path / "cache")

    def count(factory, mod, k):
        ng = mod.NGram({o: ["value"] for o in range(k)}, 2, "ts")
        with factory(dataset, ngram=ng, shuffle_row_drop_partitions=2, shuffle_seed=0,
                     cache_type="local-disk", cache_location=cache_dir,
                     reader_pool_type="serial") as r:
            return sum(b.num_rows for b in r.iter_batches())

    want = [count(jax_make_reader, jax_ngram, k) for k in (2, 3, 2)]
    assert want[0] != want[1]
    assert [count(make_reader, torch_ngram, k) for k in (2, 3, 2)] == want


def test_memory_cache_serves_the_same_windows(dataset):
    ng = torch_ngram.NGram({0: ["label"], 1: ["label"], 2: ["label"]}, 2, "ts")
    with make_reader(dataset, reader_pool_type="serial", shuffle_seed=0, num_epochs=3,
                     shuffle_row_drop_partitions=2, ngram=ng, cache_type="memory") as r:
        epochs = [b.columns["0/label"].tolist() for b in r.iter_batches()]
        stats = r.cache_stats()
    ipe = len(epochs) // 3
    assert sorted(sum(epochs[:ipe], [])) == sorted(sum(epochs[ipe:2 * ipe], []))
    assert stats["misses"] == ipe and stats["hits"] == 2 * ipe


REFUSALS = ["batch_reader", "schema_fields", "predicate_drop", "decode_roi", "device_decode"]


@pytest.mark.parametrize("refusal", REFUSALS)
def test_refusals_equal_jax(tmp_path, refusal):
    path = str(tmp_path / "jpeg")
    schema = torch_schema.Schema("J", [
        torch_schema.Field("ts", np.int64),
        torch_schema.Field("image", np.uint8, (8, 8, 3),
                           torch_codecs.CompressedImageCodec("jpeg"))])
    write_dataset(path, schema, [{"ts": i, "image": np.full((8, 8, 3), i, np.uint8)}
                                 for i in range(4)])

    def build(which):
        ngram_mod = jax_ngram if which == "jax" else torch_ngram
        ng = ngram_mod.NGram({0: ["image"], 1: ["image"]}, 1, "ts")
        pred = (jax_in_lambda if which == "jax" else in_lambda)(["ts"], lambda c: c["ts"] >= 0,
                                                                vectorized=True)
        factory = jax_make_reader if which == "jax" else make_reader
        if refusal == "batch_reader":
            return (jax_make_batch_reader if which == "jax" else make_batch_reader)(
                path, ngram=ng)
        kw = {"schema_fields": dict(schema_fields=["image"]),
              "predicate_drop": dict(predicate=pred, shuffle_row_drop_partitions=2),
              "decode_roi": dict(decode_roi={"image": (0, 0, 4, 4)}),
              "device_decode": dict(decode_placement={"image": "device"})}[refusal]
        return factory(path, ngram=ng, **kw)

    with pytest.raises(JaxError) as want:
        build("jax")
    with pytest.raises(PetastormTpuError) as got:
        build("torch")
    assert str(got.value) == str(want.value)


# -- the loaders over an ngram reader ------------------------------------------------


@pytest.mark.parametrize("batch_size,shuffle", [(8, 0), (5, 24)])
def test_cuda_loader_on_cpu_over_a_stacked_reader_equals_jax_loader(dataset, batch_size,
                                                                    shuffle):
    loader_kwargs = dict(shuffling_queue_capacity=shuffle, buffer_seed=1) if shuffle else {}
    with jax_make_reader(dataset, **_reader_kwargs("jax", "stacked_seeded")) as r:
        with JaxDataLoader(r, batch_size=batch_size, **loader_kwargs) as loader:
            want = [{k: np.asarray(v) for k, v in b.items()} for b in loader]
    with make_reader(dataset, **_reader_kwargs("torch", "stacked_seeded")) as r:
        with CudaDataLoader(r, batch_size, device="cpu", **loader_kwargs) as loader:
            got = [{k: v.numpy() for k, v in b.items()} for b in loader]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert list(g) == ["ts", "img", "0/label"] and set(w) == set(g)
        assert g["img"].shape == (batch_size, 3, 4, 5, 3) and g["img"].dtype == np.uint8
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert (g["ts"][:, 1:] >= g["ts"][:, :1]).all()


@pytest.mark.parametrize("case", ["plain", "drop2", "transform"])
def test_torch_adapter_collates_flat_windows_like_jax(dataset, case):
    def run(factory, loader_cls, which):
        with factory(dataset, **_reader_kwargs(which, case)) as r:
            return list(loader_cls(r, batch_size=6, shuffling_queue_capacity=12, seed=3))

    want = run(jax_make_reader, JaxTorchDataLoader, "jax")
    got = run(make_reader, DataLoader, "torch")
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert list(g) == list(w) == [0, 1, 2]
        for off in w:
            assert list(g[off]) == list(w[off])
            for field in w[off]:
                assert g[off][field].dtype == w[off][field].dtype
                assert torch.equal(g[off][field], w[off][field]), (off, field)
