"""The port's token feed (``petastorm_tpu_torch.sequence``) against the JAX
package's (``petastorm_tpu.sequence``), on the cases of
``tests/test_sequence_{reader,packing,mixing,loader}.py``.

Both packages read the same corpora (numpy-seeded, written once) and pack
the same document streams: documents, packed rows and blocks, ragged
batches, ``packed_stream_digest``, mixture digests and draws must be equal
exactly, and ``make_packed_sequence_loader(..., device="cpu")`` must deliver
``JaxDataLoader``'s batches (its mesh form where the tail is padded).  The
JAX cases that read telemetry (``sequence.*`` counters,
``worker.rows_decoded``) or the ``'process'`` pool are held here another
way: they compare the port's ``stats()`` with the JAX series, count the rows
the port's list codec decodes, and read the JAX process pool against the
port's thread pool, as each test says.
"""

import logging

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from petastorm_tpu import sequence as jseq
from petastorm_tpu.etl.writer import write_dataset as jax_write_dataset
from petastorm_tpu.predicates import in_lambda as jax_in_lambda, in_set as jax_in_set
from petastorm_tpu.reader import make_batch_reader as jax_make_batch_reader, \
    make_reader as jax_make_reader
from petastorm_tpu.schema import Field as JaxField, Schema as JaxSchema
from petastorm_tpu.telemetry import Telemetry
from petastorm_tpu.test_util.synthetic import write_token_corpus
from petastorm_tpu.weighted_sampling import WeightedSamplingReader as JaxWeightedSamplingReader

from petastorm_tpu_torch import sequence as tseq
from petastorm_tpu_torch.codecs import ScalarListCodec
from petastorm_tpu_torch.cuda.loader import VALID_ROWS
from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.etl.writer import write_dataset
from petastorm_tpu_torch.predicates import in_lambda, in_set
from petastorm_tpu_torch.reader import make_batch_reader, make_reader
from petastorm_tpu_torch.schema import Field, Schema
from petastorm_tpu_torch.seeding import derive_seed
from petastorm_tpu_torch.weighted_sampling import WeightedSamplingReader

#: every wire form of a variable-length column: ragged, empty, None cells
VARLEN_ROWS = [
    {"id": 0, "tokens": [1, 2, 3]},
    {"id": 1, "tokens": []},
    {"id": 2, "tokens": None},
    {"id": 3, "tokens": [7]},
    {"id": 4, "tokens": [5, 5, 5, 5, 5]},
    {"id": 5, "tokens": [9, 8]},
    {"id": 6, "tokens": []},
    {"id": 7, "tokens": [4, 4, 4]},
]


def _cells(batches, key="tokens"):
    return [None if c is None else np.asarray(c).tolist()
            for b in batches for c in b.columns[key]]


@pytest.fixture(scope="module")
def varlen_dataset(tmp_path_factory):
    """Written by the port's writer with the port's ``token_field``."""
    url = str(tmp_path_factory.mktemp("varlen") / "ds")
    schema = Schema("VarLen", [Field("id", np.int64), tseq.token_field("tokens", nullable=True)])
    write_dataset(url, schema, VARLEN_ROWS, row_group_size_rows=2)
    return url


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """Two corpora of ``tests/test_sequence_mixing.py``'s shape."""
    base = tmp_path_factory.mktemp("torch_mix_corpora")
    urls = []
    for i in range(2):
        url = str(base / f"c{i}")
        write_token_corpus(url, n_docs=60, rows_per_rg=10, mean_len=12, max_len=40,
                           seed=30 + i)
        urls.append(url)
    return urls


@pytest.fixture(scope="module")
def loader_corpora(tmp_path_factory):
    """Two corpora of ``tests/test_sequence_loader.py``'s shape."""
    base = tmp_path_factory.mktemp("torch_loader_corpora")
    urls = []
    for i in range(2):
        url = str(base / f"c{i}")
        write_token_corpus(url, n_docs=60, rows_per_rg=10, mean_len=20, max_len=80,
                           seed=60 + i)
        urls.append(url)
    return urls


@pytest.fixture(scope="module")
def labeled_corpus(tmp_path_factory):
    url = str(tmp_path_factory.mktemp("torch_labeled") / "corpus")
    write_token_corpus(url, n_docs=120, rows_per_rg=10, mean_len=16, max_len=64, seed=9)
    return url


def _assert_rows_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


# -- dataset (tests/test_sequence_reader.py) ---------------------------------------


@pytest.mark.parametrize("pool,jax_pool", [("thread", "thread"), ("serial", "serial"),
                                           ("dummy", "dummy"), ("process", "process")])
def test_varlen_roundtrip_batch_reader_equals_jax(varlen_dataset, pool, jax_pool):
    """The port's cells equal the JAX reader's, None cells and empty lists
    included, pool for pool (the process pools' ragged cells travel
    pickled)."""
    kwargs = dict(workers_count=2, shuffle_row_groups=False, num_epochs=1)

    def cells_by_id(batches):
        return dict(zip((int(i) for b in batches for i in b.columns["id"]), _cells(batches)))

    with make_batch_reader(varlen_dataset, reader_pool_type=pool, **kwargs) as reader:
        assert tseq.is_sequence_field(reader.schema["tokens"])
        got = cells_by_id(list(reader.iter_batches()))
    with jax_make_batch_reader(varlen_dataset, reader_pool_type=jax_pool, **kwargs) as reader:
        want = cells_by_id(list(reader.iter_batches()))
    assert got == want == {r["id"]: r["tokens"] for r in VARLEN_ROWS}


@pytest.mark.parametrize("pool", ["thread", "serial"])
def test_varlen_roundtrip_row_reader_equals_jax(varlen_dataset, pool):
    def rows(factory):
        with factory(varlen_dataset, reader_pool_type=pool, workers_count=2,
                     shuffle_row_groups=False, num_epochs=1) as reader:
            return {int(r.id): None if r.tokens is None else np.asarray(r.tokens).tolist()
                    for r in reader}

    assert rows(make_reader) == rows(jax_make_reader) == {r["id"]: r["tokens"]
                                                          for r in VARLEN_ROWS}


def test_uniform_rowgroup_fast_path_reaches_iter_documents_as_in_jax(tmp_path):
    """A rowgroup whose lists share one length decodes to one 2-D array in
    both packages, and ``iter_documents`` yields the same int32 rows."""
    url = str(tmp_path / "uniform")
    schema = Schema("U", [Field("id", np.int64), tseq.token_field("tokens")])
    write_dataset(url, schema, [{"id": i, "tokens": [i] * 4} for i in range(12)],
                  row_group_size_rows=4)
    kwargs = dict(shuffle_row_groups=False, num_epochs=1)
    with make_batch_reader(url, **kwargs) as reader:
        got_cols = [b.columns["tokens"] for b in reader.iter_batches()]
    with jax_make_batch_reader(url, **kwargs) as reader:
        want_cols = [b.columns["tokens"] for b in reader.iter_batches()]
    assert [(c.dtype, c.shape) for c in got_cols] == [(c.dtype, c.shape) for c in want_cols]
    assert all(c.dtype != object for c in got_cols)
    with tseq.make_sequence_reader(url, deterministic="seed", **kwargs) as reader:
        got = list(tseq.iter_documents(reader, "tokens"))
    with jseq.make_sequence_reader(url, deterministic="seed", **kwargs) as reader:
        want = list(jseq.iter_documents(reader, "tokens"))
    assert [d.tolist() for d in got] == [d.tolist() for d in want] == [[i] * 4
                                                                        for i in range(12)]
    assert all(d.dtype == np.int32 for d in got)


@pytest.mark.parametrize("max_documents", [None, 2, 5])
def test_iter_documents_equals_jax(varlen_dataset, max_documents):
    """None cells skipped, empty lists yielded, ``max_documents`` honoured."""
    kwargs = dict(shuffle_row_groups=False, deterministic="seed", num_epochs=1)
    with tseq.make_sequence_reader(varlen_dataset, **kwargs) as reader:
        got = [d.tolist() for d in tseq.iter_documents(reader, "tokens",
                                                        max_documents=max_documents)]
    with jseq.make_sequence_reader(varlen_dataset, **kwargs) as reader:
        want = [d.tolist() for d in jseq.iter_documents(reader, "tokens",
                                                         max_documents=max_documents)]
    assert got == want
    assert len(got) == (max_documents or 7)


@pytest.mark.parametrize("field,match", [("nope", "not in the dataset schema"),
                                         ("id", "not a variable-length sequence column")])
def test_sequence_reader_refusals_equal_jax(varlen_dataset, field, match):
    with pytest.raises(PetastormTpuError, match=match):
        tseq.make_sequence_reader(varlen_dataset, tokens_field=field)
    with pytest.raises(Exception, match=match):
        jseq.make_sequence_reader(varlen_dataset, tokens_field=field)


def test_token_field_equals_jax():
    got, want = tseq.token_field("t", dtype=np.int64, nullable=True), \
        jseq.token_field("t", dtype=np.int64, nullable=True)
    assert (got.name, got.dtype, got.shape, got.nullable) == \
        (want.name, want.dtype, want.shape, want.nullable)
    assert isinstance(got.codec, ScalarListCodec)
    assert got.codec.storage_type(got) == want.codec.storage_type(want)
    assert tseq.is_sequence_field(got) and not tseq.is_sequence_field(Field("x", np.int64))
    assert tseq.is_sequence_field(Field("v", np.float32, (None,), ScalarListCodec()))


def _first_sentence(exc):
    return str(exc.value).split(":")[0]


def test_decode_roi_on_sequence_field_refused_as_in_jax(varlen_dataset):
    with pytest.raises(PetastormTpuError, match="variable-length sequence field") as got:
        make_batch_reader(varlen_dataset, decode_roi={"tokens": (0, 0, 4, 4)})
    with pytest.raises(Exception, match="variable-length sequence field") as want:
        jax_make_batch_reader(varlen_dataset, decode_roi={"tokens": (0, 0, 4, 4)})
    assert _first_sentence(got) == _first_sentence(want)


@pytest.mark.parametrize("place", ["device", "device-mixed"])
def test_decode_placement_on_sequence_field_refused_as_in_jax(varlen_dataset, place):
    with pytest.raises(PetastormTpuError, match="variable-length sequence field") as got:
        make_reader(varlen_dataset, decode_placement={"tokens": place})
    with pytest.raises(Exception, match="variable-length sequence field") as want:
        jax_make_reader(varlen_dataset, decode_placement={"tokens": place})
    assert _first_sentence(got) == _first_sentence(want)


def test_predicate_pushdown_decodes_only_survivors(labeled_corpus, monkeypatch):
    """The JAX test reads ``sequence.rows_filtered`` and
    ``worker.rows_decoded`` (telemetry).  Here the rows the
    port's list codec decodes are counted instead: only the survivors reach
    it, and they are the JAX reader's survivors."""
    decoded = []
    original = ScalarListCodec.decode_column

    def counting(self, field, column):
        decoded.append(len(column))
        return original(self, field, column)

    monkeypatch.setattr(ScalarListCodec, "decode_column", counting)
    kwargs = dict(shuffle_row_groups=False, num_epochs=1, reader_pool_type="serial")
    with make_batch_reader(labeled_corpus, predicate=in_set({"l0"}, "lang"),
                           **kwargs) as reader:
        got = [int(i) for b in reader.iter_batches() for i in b.columns["doc_id"]]
    with jax_make_batch_reader(labeled_corpus, predicate=jax_in_set({"l0"}, "lang"),
                               **kwargs) as reader:
        want = [int(i) for b in reader.iter_batches() for i in b.columns["doc_id"]]
    assert got == want and 0 < len(got) < 120
    assert sum(decoded) == len(got)


def test_predicate_on_doc_length_column_equals_jax(labeled_corpus):
    def run(make, lam):
        pred = lam(["n_tokens"], lambda cols: cols["n_tokens"] >= 16, vectorized=True)
        with make(labeled_corpus, shuffle_row_groups=False, num_epochs=1,
                  reader_pool_type="serial", predicate=pred) as reader:
            return [(int(i), np.asarray(t).tolist()) for b in reader.iter_batches()
                    for i, t in zip(b.columns["doc_id"], b.columns["tokens"])]

    got = run(make_batch_reader, in_lambda)
    assert got == run(jax_make_batch_reader, jax_in_lambda)
    assert got and all(len(t) >= 16 for _, t in got)


def test_port_written_corpus_reads_the_same_in_jax(tmp_path):
    """A corpus the port writes with ``token_field`` is the JAX package's
    corpus: the JAX writer's files and the port's give the same documents."""
    rng = np.random.default_rng(4)
    docs = [rng.integers(0, 50257, int(n), dtype=np.int32) for n in rng.integers(1, 30, 40)]
    rows = [{"doc_id": i, "tokens": d} for i, d in enumerate(docs)]
    port_url, jax_url = str(tmp_path / "port"), str(tmp_path / "jax")
    write_dataset(port_url, Schema("C", [Field("doc_id", np.int64), tseq.token_field()]),
                  rows, row_group_size_rows=8)
    jax_write_dataset(jax_url, JaxSchema("C", [JaxField("doc_id", np.int64),
                                               jseq.token_field()]),
                      rows, row_group_size_rows=8)
    streams = []
    for url in (port_url, jax_url):
        for make, it in ((tseq.make_sequence_reader, tseq.iter_documents),
                         (jseq.make_sequence_reader, jseq.iter_documents)):
            with make(url, shuffle_seed=2, num_epochs=1) as reader:
                streams.append([d.tolist() for d in it(reader)])
    assert all(s == streams[0] for s in streams)
    assert sorted(map(tuple, streams[0])) == sorted(tuple(d.tolist()) for d in docs)


# -- packing (tests/test_sequence_packing.py) --------------------------------------


def _docs(*lengths, base=100):
    return [np.full(n, base + i, dtype=np.int32) for i, n in enumerate(lengths)]


def _random_docs(seed, n, max_len, vocab=1000, dtype=np.int32):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(k), dtype=dtype) for k in rng.integers(0, max_len, n)]


PACKING_CASES = {
    "masks_segments_positions": (_docs(3, 4, 9), dict(seq_len=8)),
    "padding": (_docs(6, 6), dict(seq_len=10)),
    "multiset": (_random_docs(3, 200, 50), dict(seq_len=64)),
    "long_split": (_docs(20), dict(seq_len=8, long_docs="split")),
    "long_truncate": (_docs(20), dict(seq_len=8, long_docs="truncate")),
    "eviction": ([np.full(7, 1, np.int32), np.full(5, 2, np.int32), np.full(6, 3, np.int32)],
                 dict(seq_len=10, open_bins=2)),
    "one_bin": (_random_docs(5, 150, 40), dict(seq_len=32, open_bins=1)),
    "many_bins_pad": (_random_docs(6, 300, 90), dict(seq_len=64, open_bins=32, pad_token=7)),
    "int64_f16_mask": (_random_docs(7, 120, 70, dtype=np.int64),
                       dict(seq_len=48, tokens_dtype=np.int64, mask_dtype=np.float16)),
    "seq_len_1": (_random_docs(8, 20, 4), dict(seq_len=1)),
}


@pytest.mark.parametrize("case", sorted(PACKING_CASES))
def test_packed_rows_and_stats_equal_jax(case):
    docs, kwargs = PACKING_CASES[case][0], dict(PACKING_CASES[case][1])
    seq_len = kwargs.pop("seq_len")
    got_p, want_p = tseq.SequencePacker(seq_len, **kwargs), \
        jseq.SequencePacker(seq_len, **kwargs)
    got = list(tseq.iter_packed_rows(iter(docs), seq_len, packer=got_p))
    want = list(jseq.iter_packed_rows(iter(docs), seq_len, packer=want_p))
    _assert_rows_equal(got, want)
    assert got_p.stats() == want_p.stats()
    assert got_p.fill_rate == want_p.fill_rate


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("open_bins,long_docs", [(8, "split"), (3, "truncate"), (1, "split")])
def test_packed_blocks_and_digest_equal_jax(seed, open_bins, long_docs):
    """Random lognormal-ish streams with Nones and empties, in blocks of 4
    with and without the short tail: equal blocks, equal digests."""
    rng = np.random.default_rng(100 + seed)
    docs = [None if rng.random() < 0.05 else rng.integers(0, 50257, int(n), dtype=np.int32)
            for n in np.clip(rng.lognormal(np.log(24), 0.9, 160), 0, 150)]
    for drop_last in (False, True):
        kwargs = dict(open_bins=open_bins, long_docs=long_docs, drop_last=drop_last)
        got = list(tseq.iter_packed_blocks(iter(docs), 64, 4, **kwargs))
        want = list(jseq.iter_packed_blocks(iter(docs), 64, 4, **kwargs))
        _assert_rows_equal(got, want)
        assert tseq.packed_stream_digest(got) == jseq.packed_stream_digest(want)
        assert tseq.packed_stream_digest(want) == jseq.packed_stream_digest(got)


def test_digest_is_order_and_content_sensitive_as_in_jax():
    docs = _random_docs(5, 150, 40)
    a = list(tseq.iter_packed_blocks(iter(docs), 32, 4))
    c = list(tseq.iter_packed_blocks(iter(docs[::-1]), 32, 4))
    assert tseq.packed_stream_digest(a) != tseq.packed_stream_digest(c)
    crc = 0
    for block in a:
        crc = tseq.packed_stream_digest([block], crc=crc)
    assert crc == tseq.packed_stream_digest(a) == jseq.packed_stream_digest(a)
    mutated = [dict(a[0], tokens=a[0]["tokens"] + 1)] + a[1:]
    assert tseq.packed_stream_digest(mutated) == jseq.packed_stream_digest(mutated) \
        != tseq.packed_stream_digest(a)


def test_packer_reuse_with_finish_false_equals_jax():
    def run(mod):
        p = mod.SequencePacker(8)
        first = list(mod.iter_packed_rows(_docs(6), 8, packer=p, finish=False))
        rows = list(mod.iter_packed_rows(iter(_docs(2, 8, base=200)), 8, packer=p))
        return first, rows, p.stats()

    got, want = run(tseq), run(jseq)
    assert got[0] == want[0] == []
    _assert_rows_equal(got[1], want[1])
    assert got[2] == want[2]


def test_empty_none_and_feed_after_finish_as_in_jax():
    for mod in (tseq, jseq):
        p = mod.SequencePacker(8)
        assert p.feed(None) == [] and p.feed(np.empty(0, np.int32)) == []
        assert p.feed(np.asarray([1, 2], np.int32)) == []
        assert len(p.finish()) == 1
        assert p.stats()["docs_empty"] == 2 and p.stats()["docs"] == 1
        with pytest.raises(Exception, match="after finish"):
            p.feed(np.asarray([1], np.int32))


@pytest.mark.parametrize("docs,kwargs", [(_docs(6, 6, 20), {}),
                                         (_docs(20), dict(long_docs="truncate"))])
def test_packer_stats_equal_the_jax_telemetry_series(docs, kwargs):
    """The JAX packer's ``sequence.*`` series against the port's
    ``stats()``: the same numbers, monotonic token counts under truncation
    included."""
    tele = Telemetry()
    jp = jseq.SequencePacker(8, telemetry=tele, **kwargs)
    list(jseq.iter_packed_rows(iter(docs), 8, packer=jp))
    tp = tseq.SequencePacker(8, **kwargs)
    list(tseq.iter_packed_rows(iter(docs), 8, packer=tp))
    snap, stats = tele.snapshot(), tp.stats()
    assert snap["counters"]["sequence.docs_packed"] == stats["docs"]
    assert snap["counters"]["sequence.tokens_packed"] == stats["tokens"]
    assert snap["counters"].get("sequence.docs_split", 0) == stats["docs_split"]
    assert snap["counters"]["sequence.rows_emitted"] == stats["rows"]
    assert snap["counters"].get("sequence.pad_tokens", 0) == stats["rows"] * 8 - stats["tokens"]
    assert snap["gauges"]["sequence.fill_rate"] == pytest.approx(tp.fill_rate)


@pytest.mark.parametrize("batch_docs", [1, 3, 7])
def test_ragged_batches_equal_jax(batch_docs):
    docs = [np.asarray([1, 2, 3], np.int64), None, np.asarray([4], np.int64),
            np.asarray([5, 6], np.int64), np.asarray([], np.int64), np.asarray([7], np.int64)]
    docs += _random_docs(9, 20, 12, dtype=np.int64)
    got = list(tseq.iter_ragged_batches(iter(docs), batch_docs))
    want = list(jseq.iter_ragged_batches(iter(docs), batch_docs))
    _assert_rows_equal(got, want)
    assert got[0]["tokens"].dtype == np.int32


def test_invalid_packing_args_refused_as_in_jax():
    for mod in (tseq, jseq):
        for make in (lambda: mod.SequencePacker(0), lambda: mod.SequencePacker(8, open_bins=0),
                     lambda: mod.SequencePacker(8, long_docs="explode"),
                     lambda: list(mod.iter_packed_blocks(iter([]), 8, 0)),
                     lambda: list(mod.iter_ragged_batches(iter([]), 0))):
            with pytest.raises(Exception):
                make()
        with pytest.raises(Exception, match="1-D"):
            mod.SequencePacker(8).feed(np.zeros((2, 2), np.int32))
        with pytest.raises(Exception, match="long_docs='error'"):
            list(mod.iter_packed_rows(_docs(20), 8, long_docs="error"))
        with pytest.raises(Exception, match="seq_len"):
            list(mod.iter_packed_rows(_docs(2), 8, packer=mod.SequencePacker(4)))
        with pytest.raises(Exception, match="packer_kwargs"):
            list(mod.iter_packed_rows(_docs(2), 8, packer=mod.SequencePacker(8), open_bins=2))


# -- mixing (tests/test_sequence_mixing.py) ----------------------------------------


def _doc_stream(mod, urls, seed, weights=None, **kwargs):
    with mod.make_mixed_sequence_reader(urls, weights=weights, seed=seed, **kwargs) as mixer:
        docs = [d.tolist() for d in mod.iter_documents(mixer, "tokens")]
        return docs, mixer.mixture_digest, mixer.diagnostics


@pytest.mark.parametrize("seed,weights", [(7, None), (8, None), (3, None), (3, [0.95, 0.05]),
                                          (11, [0.8, 0.2])])
def test_mixture_documents_and_digest_equal_jax(corpora, seed, weights):
    got_docs, got_dig, got_diag = _doc_stream(tseq, corpora, seed, weights)
    want_docs, want_dig, want_diag = _doc_stream(jseq, corpora, seed, weights)
    assert got_docs == want_docs
    assert got_dig == want_dig
    assert got_diag["seed"] == want_diag["seed"] is not None
    assert got_dig["draw_count"] > 0 and len(got_dig["readers"]) == 2


def test_mixture_is_a_pure_function_of_the_seed(corpora):
    a, b, c = (_doc_stream(tseq, corpora, s) for s in (7, 7, 8))
    assert a[0] == b[0] and a[1] == b[1]
    assert c[0] != a[0] and c[1]["draws"] != a[1]["draws"]
    # exhaustion renormalizes: every document arrives exactly once
    skew = _doc_stream(tseq, corpora, 3, [0.95, 0.05])[0]
    assert len(skew) == len(a[0]) == 120 and skew != _doc_stream(tseq, corpora, 3)[0]


def test_mixer_exposes_the_adapter_surface(corpora):
    from petastorm_tpu_torch.seeding import reader_buffer_seed

    with tseq.make_mixed_sequence_reader(corpora, seed=7) as mixer:
        assert mixer.deterministic == "seed"
        assert mixer.shuffle_seed == mixer.seed is not None
        assert reader_buffer_seed(mixer, "loader.shuffle_buffer") is not None
        list(mixer.iter_batches())
    with tseq.make_mixed_sequence_reader(corpora) as mixer:
        assert mixer.deterministic == "off" and mixer.shuffle_seed is None
        assert reader_buffer_seed(mixer, "loader.shuffle_buffer") is None
        list(mixer.iter_batches())


def test_corpus_seeds_equal_jax():
    assert tseq.corpus_seed(None, 0) is None
    for seed in (0, 7, 2 ** 40):
        for i in range(3):
            assert tseq.corpus_seed(seed, i) == jseq.corpus_seed(seed, i) \
                == derive_seed(seed, 0, "sequence.corpus", i)
    assert tseq.corpus_seed(7, 0) != tseq.corpus_seed(7, 1)


@pytest.mark.parametrize("kwargs,match", [
    (dict(seed=1, shuffle_seed=2), "not shuffle_seed"),
    (dict(weights=[1.0], seed=1), "weights"),
])
def test_mixture_refusals_equal_jax(corpora, kwargs, match):
    with pytest.raises(PetastormTpuError, match=match):
        tseq.make_mixed_sequence_reader(corpora, **kwargs)
    with pytest.raises(Exception, match=match):
        jseq.make_mixed_sequence_reader(corpora, **kwargs)


def test_mixture_of_no_corpus_refused():
    with pytest.raises(PetastormTpuError, match="at least one corpus"):
        tseq.make_mixed_sequence_reader([], seed=1)


def _seeded_readers(mod, urls, base):
    return [mod.make_sequence_reader(u, shuffle_seed=base + i, deterministic="seed")
            for i, u in enumerate(urls)]


def test_unseeded_mixer_over_seeded_readers_derives_as_in_jax(corpora, caplog):
    with caplog.at_level(logging.WARNING, logger="petastorm_tpu_torch.weighted_sampling"):
        with WeightedSamplingReader(_seeded_readers(tseq, corpora, 40), [0.5, 0.5]) as got:
            assert any("defeat stream reproducibility" in r.message for r in caplog.records)
            assert got.seed == derive_seed(40, 0, "weighted_sampling.auto")
            got_ids = [int(x) for b in got.iter_batches() for x in b.columns["doc_id"]]
            got_dig = got.mixture_digest
    with JaxWeightedSamplingReader(_seeded_readers(jseq, corpora, 40), [0.5, 0.5]) as want:
        want_ids = [int(x) for b in want.iter_batches() for x in b.columns["doc_id"]]
        assert got_dig == want.mixture_digest
    assert got_ids == want_ids


def test_unseeded_mixer_deterministic_off_warns_and_stays_unseeded(corpora, caplog):
    with caplog.at_level(logging.WARNING, logger="petastorm_tpu_torch.weighted_sampling"):
        with WeightedSamplingReader(_seeded_readers(tseq, corpora, 50), [0.5, 0.5],
                                    deterministic="off") as mixer:
            assert mixer.seed is None
            assert any("defeating stream reproducibility" in r.message for r in caplog.records)
            list(mixer.iter_batches())


def test_next_path_mixture_equals_jax(corpora):
    """``__next__`` mixing folds draws and exhaustion markers, as in JAX."""
    with WeightedSamplingReader(_seeded_readers(tseq, corpora, 70), [0.5, 0.5],
                                seed=5) as mixer:
        got = [np.asarray(nt.doc_id).tolist() for nt in mixer]
        got_dig = mixer.mixture_digest
    with JaxWeightedSamplingReader(_seeded_readers(jseq, corpora, 70), [0.5, 0.5],
                                   seed=5) as mixer:
        want = [np.asarray(nt.doc_id).tolist() for nt in mixer]
        assert got_dig == mixer.mixture_digest
    assert got == want
    assert sorted(i for ids in got for i in ids) == sorted(list(range(60)) * 2)
    assert got_dig["draw_count"] == len(got) + 2


# -- loader (tests/test_sequence_loader.py) ----------------------------------------


def test_packed_reader_protocol(loader_corpora):
    source = tseq.make_sequence_reader(loader_corpora[0], shuffle_seed=3)
    with tseq.PackedSequenceReader(source, seq_len=64, rows_per_batch=8) as packed:
        assert [f.name for f in packed.schema] == list(tseq.PACKED_FIELDS)
        assert all(f.shape == (64,) for f in packed.schema)
        assert packed.deterministic == "seed" and packed.shuffle_seed == 3
        assert packed.batched_output and packed.ngram is None
        assert packed.output_schema is packed.schema
        assert packed.device_decode_fields == [] and not packed.device_decode_mixed
        assert packed.declared_geometries == {}
        batches = list(packed.iter_batches())
        assert packed.last_row_consumed
        assert all(b.columns["tokens"].shape[1] == 64 for b in batches)
        assert all(b.columns["tokens"].dtype == np.int32 for b in batches)
        diag = packed.diagnostics
        assert diag["packing"]["rows"] == sum(b.num_rows for b in batches)
        assert diag["packing"]["fill_rate"] > 0 and "source" in diag
        for refused in (packed.quiesce, packed.state_dict):
            with pytest.raises(PetastormTpuError, match="quiesce"):
                refused()


def test_packed_reader_batches_equal_jax(loader_corpora):
    def run(mod):
        source = mod.make_mixed_sequence_reader(loader_corpora, seed=5)
        with mod.PackedSequenceReader(source, seq_len=48, rows_per_batch=5,
                                      open_bins=4) as packed:
            blocks = [b.columns for b in packed.iter_batches()]
            return blocks, packed.diagnostics["packing"]

    got, want = run(tseq), run(jseq)
    _assert_rows_equal(got[0], want[0])
    assert got[1] == want[1]


def _port_loader_batches(urls, **kwargs):
    with tseq.make_packed_sequence_loader(urls, device="cpu", **kwargs) as loader:
        return [{k: (v if k == VALID_ROWS else v.numpy()) for k, v in b.items()}
                for b in loader]


def _jax_loader_batches(urls, mesh=False, **kwargs):
    if mesh:
        kwargs["loader_kwargs"] = dict(kwargs.get("loader_kwargs") or {},
                                       mesh=Mesh(np.asarray(jax.devices()[:1]), ("data",)),
                                       shardings=P("data"))
    with jseq.make_packed_sequence_loader(urls, **kwargs) as loader:
        return [{k: (v if k == VALID_ROWS else np.asarray(v)) for k, v in b.items()}
                for b in loader]


@pytest.mark.parametrize("workers", [1, 2, 4])
def test_loader_batches_equal_jax(loader_corpora, workers):
    kwargs = dict(batch_size=8, seq_len=64, seed=11, workers_count=workers)
    got = _port_loader_batches(loader_corpora, **kwargs)
    want = _jax_loader_batches(loader_corpora, **kwargs)
    assert got
    _assert_rows_equal(got, want)
    for b in got:
        assert set(b) == set(tseq.PACKED_FIELDS)
        assert all(v.shape == (8, 64) for v in b.values())
        assert ((b["segment_ids"] > 0) == (b["loss_mask"] > 0)).all()
        assert (b["tokens"][b["loss_mask"] == 0] == 0).all()


def test_loader_delivers_torch_tensors_on_the_cpu(loader_corpora):
    with tseq.make_packed_sequence_loader(loader_corpora, batch_size=8, seq_len=64, seed=11,
                                          device="cpu") as loader:
        batch = next(iter(loader))
        assert {k: (v.device.type, v.dtype) for k, v in batch.items()} == {
            "tokens": ("cpu", torch.int32), "segment_ids": ("cpu", torch.int32),
            "positions": ("cpu", torch.int32), "loss_mask": ("cpu", torch.float32)}


def test_loader_diagnostics_carry_the_packing_stats_as_jax(loader_corpora):
    """The packer's ``stats()`` reach the loader's ``diagnostics()`` under
    ``['reader']['packing']``, as in ``JaxDataLoader.diagnostics`` (a
    property there, a method here)."""
    def run(mod, **kwargs):
        with mod.make_packed_sequence_loader(loader_corpora, batch_size=8, seq_len=64,
                                             seed=11, **kwargs) as loader:
            rows = sum(len(b["tokens"]) for b in loader)
            diag = loader.diagnostics
            return rows, (diag() if callable(diag) else diag)["reader"]

    (rows, got), (_, want) = run(tseq, device="cpu"), run(jseq)
    assert got["packing"] == want["packing"] and got["packing"]["rows"] >= rows > 0
    assert got["source"]["mixture_digest"] == want["source"]["mixture_digest"]


def test_loader_padded_tail_equals_jax_mesh_form(loader_corpora):
    """``drop_last=False``: the port pads the tail with ``'_valid_rows'`` and
    a valid mask without a mesh; the JAX loader does so with one."""
    kwargs = dict(batch_size=8, seq_len=64, seed=11, workers_count=2,
                  loader_kwargs=dict(drop_last=False, valid_mask_field="valid"))
    got = _port_loader_batches(loader_corpora, **kwargs)
    want = _jax_loader_batches(loader_corpora, mesh=True, **kwargs)
    _assert_rows_equal([{k: v for k, v in b.items() if k != VALID_ROWS} for b in got],
                       [{k: v for k, v in b.items() if k != VALID_ROWS} for b in want])
    assert [b.get(VALID_ROWS, 8) for b in got] == [b.get(VALID_ROWS, 8) for b in want]
    assert got[-1][VALID_ROWS] < 8


@pytest.mark.parametrize("workers", [2, 4])
def test_loader_shuffle_buffer_seeded_for_mixed_sources_equals_jax(loader_corpora, workers):
    kwargs = dict(batch_size=4, seq_len=64, seed=9, workers_count=workers,
                  loader_kwargs={"shuffling_queue_capacity": 32})
    got = _port_loader_batches(loader_corpora, **kwargs)
    _assert_rows_equal(got, _jax_loader_batches(loader_corpora, **kwargs))
    _assert_rows_equal(got, _port_loader_batches(loader_corpora, **dict(kwargs,
                                                                       workers_count=1)))


def test_loader_single_corpus_and_seed_sensitivity_equal_jax(loader_corpora):
    def run(seed, mod_run):
        return mod_run(loader_corpora[0], batch_size=4, seq_len=64, seed=seed, workers_count=2)

    a, c = run(5, _port_loader_batches), run(6, _port_loader_batches)
    _assert_rows_equal(a, run(5, _jax_loader_batches))
    assert any((x["tokens"] != y["tokens"]).any() for x, y in zip(a, c))


def test_loader_rejects_shuffle_seed_kwarg(loader_corpora):
    with pytest.raises(PetastormTpuError, match="shuffle_seed"):
        tseq.make_packed_sequence_loader(loader_corpora[0], batch_size=4, seq_len=64,
                                         shuffle_seed=3, device="cpu")


def test_loader_defaults_to_the_card(loader_corpora):
    """``device`` defaults to ``"cuda"``: without a card it raises, and the
    readers it opened are closed."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(Exception, match="(?i)cuda"):
        tseq.make_packed_sequence_loader(loader_corpora, batch_size=4, seq_len=64, seed=1)
