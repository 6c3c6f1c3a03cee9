"""The port's ``WeightedSamplingReader`` against ``petastorm_tpu.weighted_sampling``.

On the CPU: the same datasets are read by both packages' readers (serial
pool, the same seeds) and mixed by both packages' mixers with the same
probabilities and seed.  The rows from ``__next__``, the batches from
``iter_batches`` and ``mixture_digest`` (draw chain, draw count, each
sub-reader's digest, the combined value) must be equal, through the
exhaustion of every reader and the renormalisation of the weights; so must
the ``deterministic='auto'`` derived seed, both warnings and every refusal
with its message.  A mix feeds ``CudaDataLoader(device='cpu')`` as a mix of
the JAX package feeds ``JaxDataLoader``: labels exact, and a device-decode
mix's images (B2's plain version) within the 1 LSB of ``test_torch_jpeg.py``.
"""

import logging

import numpy as np
import pytest

from petastorm_tpu import weighted_sampling as jax_ws
from petastorm_tpu.errors import PetastormTpuError as JaxError
from petastorm_tpu.jax import JaxDataLoader
from petastorm_tpu.ngram import NGram as JaxNGram
from petastorm_tpu.reader import make_batch_reader as jax_make_batch_reader
from petastorm_tpu.reader import make_reader as jax_make_reader

from petastorm_tpu_torch import weighted_sampling as torch_ws
from petastorm_tpu_torch.codecs import CompressedImageCodec, NdarrayCodec
from petastorm_tpu_torch.cuda.loader import CudaDataLoader
from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.etl.writer import write_dataset
from petastorm_tpu_torch.ngram import NGram
from petastorm_tpu_torch.reader import make_batch_reader, make_reader
from petastorm_tpu_torch.schema import Field, Schema

from test_torch_jpeg import _assert_bytes_close, _smooth

PACKAGES = {"jax": (jax_ws, jax_make_reader, jax_make_batch_reader, JaxError),
            "torch": (torch_ws, make_reader, make_batch_reader, PetastormTpuError)}


def _schema():
    return Schema("W", [Field("id", np.int64), Field("src", np.int64),
                        Field("vec", np.float32, (3,), NdarrayCodec())])


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """Three datasets of one schema: 40, 24 and 9 rows in rowgroups of 5 and 4."""
    root = tmp_path_factory.mktemp("mix")
    paths = []
    for src, (n, group) in enumerate([(40, 5), (24, 4), (9, 4)]):
        path = str(root / f"c{src}")
        write_dataset(path, _schema(), [{"id": 100 * src + i, "src": src,
                                         "vec": np.full(3, i, np.float32)} for i in range(n)],
                      row_group_size_rows=group)
        paths.append(path)
    return paths


def _readers(which, paths, batch=False, **kwargs):
    _, row_factory, batch_factory, _ = PACKAGES[which]
    factory = batch_factory if batch else row_factory
    return [factory(p, reader_pool_type="serial", **{"shuffle_seed": 3 + i, **kwargs})
            for i, p in enumerate(paths)]


MIXES = [([0.5, 0.5], 0, 2, {}), ([0.8, 0.2], 1, 2, {}), ([0.1, 0.3, 0.6], 7, 3, {}),
         ([1.0, 0.2, 1.0], 2, 3, {}), ([3.0, 1.0], 11, 2, {"num_epochs": 2}),
         ([0.25, 0.75], 5, 2, {"shuffle_row_drop_partitions": 2})]


@pytest.mark.parametrize("probs,seed,n,kwargs", MIXES)
def test_rows_and_mixture_digest_equal_jax(corpora, probs, seed, n, kwargs):
    out = {}
    for which in PACKAGES:
        ws = PACKAGES[which][0]
        with ws.WeightedSamplingReader(_readers(which, corpora[:n], **kwargs), probs,
                                       seed=seed) as mixed:
            rows = [(int(r.id), int(r.src), r.vec.tolist()) for r in mixed]
            out[which] = (rows, mixed.mixture_digest, mixed.diagnostics, mixed.last_row_consumed)
    got, want = out["torch"], out["jax"]
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2] and got[2]["alive_readers"] == []
    assert got[3] is want[3] is True
    assert got[1]["readers"][0] is not None


@pytest.mark.parametrize("probs,seed,n,kwargs", MIXES)
@pytest.mark.parametrize("batch", [False, True], ids=["make_reader", "make_batch_reader"])
def test_batches_and_mixture_digest_equal_jax(corpora, probs, seed, n, kwargs, batch):
    out = {}
    for which in PACKAGES:
        ws = PACKAGES[which][0]
        with ws.WeightedSamplingReader(_readers(which, corpora[:n], batch, **kwargs), probs,
                                       seed=seed) as mixed:
            batches = [(b.num_rows, b.columns["id"].tolist(), b.columns["vec"].tolist())
                       for b in mixed.iter_batches()]
            out[which] = (batches, mixed.mixture_digest, mixed.diagnostics)
    assert out["torch"] == out["jax"]
    # every rowgroup of every reader is one draw, and each reader's
    # exhaustion one more
    assert out["torch"][1]["draw_count"] == len(out["torch"][0]) + n


def test_zero_weight_reader_left_alone_fails_like_jax(corpora):
    """Once only zero-weight readers are alive the weights are 0/0: both
    packages raise numpy's ValueError from the draw, after the same rows."""
    out = {}
    for which in PACKAGES:
        ws = PACKAGES[which][0]
        rows = []
        with ws.WeightedSamplingReader(_readers(which, corpora[1:]), [1.0, 0.0],
                                       seed=0) as mixed:
            with pytest.raises(ValueError) as exc:
                for r in mixed:
                    rows.append(int(r.id))
            out[which] = (rows, str(exc.value), mixed.mixture_digest)
    assert out["torch"] == out["jax"] and len(out["torch"][0]) == 24


def test_draws_follow_the_seeded_stream(corpora):
    """With two live readers the first draws are ``seed_stream(seed, 0,
    'weighted_sampling').choice(2, p=...)``, reader by reader."""
    from petastorm_tpu_torch.seeding import seed_stream

    with torch_ws.WeightedSamplingReader(_readers("torch", corpora[:2], num_epochs=None),
                                         [0.7, 0.3], seed=9) as mixed:
        srcs = [int(next(mixed).src) for _ in range(30)]
    rng = seed_stream(9, 0, "weighted_sampling")
    assert srcs == [int(rng.choice(2, p=[0.7, 0.3])) for _ in range(30)]


def test_rows_and_batches_share_the_alive_list(corpora):
    with torch_ws.WeightedSamplingReader(_readers("torch", corpora[1:]), [0.5, 0.5],
                                         seed=4) as mixed:
        n = sum(b.num_rows for b in mixed.iter_batches())
        assert n == 33 and mixed.diagnostics["alive_readers"] == []
        with pytest.raises(StopIteration):
            next(mixed)


@pytest.mark.parametrize("deterministic", ["auto", "off"])
@pytest.mark.parametrize("seeded_readers", [True, False])
def test_deterministic_seed_and_warnings_equal_jax(corpora, caplog, deterministic,
                                                   seeded_readers):
    kwargs = {} if seeded_readers else {"shuffle_seed": None}
    out = {}
    for which in PACKAGES:
        ws = PACKAGES[which][0]
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            mixed = ws.WeightedSamplingReader(_readers(which, corpora[:2], **kwargs),
                                              [0.5, 0.5], deterministic=deterministic)
        with mixed:
            draws = ([int(r.src) for r in mixed] if mixed.seed is not None else None)
            out[which] = (mixed.seed, mixed.deterministic, mixed.shuffle_seed,
                          [r.getMessage() for r in caplog.records
                           if "WeightedSamplingReader" in r.getMessage()], draws,
                          mixed.mixture_digest if mixed.seed is not None else None)
    assert out["torch"] == out["jax"]
    seed, det, root, warnings, _, _ = out["torch"]
    if seeded_readers:
        assert len(warnings) == 1
        if deterministic == "auto":
            assert seed is not None and det == "seed" and root == seed
        else:
            assert seed is None and det == "off" and root is None
    else:
        assert warnings == [] and seed is None


def test_explicit_seed_silences_both_warnings(corpora, caplog):
    with caplog.at_level(logging.WARNING):
        for deterministic in ("auto", "off"):
            with torch_ws.WeightedSamplingReader(_readers("torch", corpora[:2]), [1, 1], seed=0,
                                                 deterministic=deterministic) as mixed:
                assert mixed.deterministic == "seed" and mixed.shuffle_seed == 0
    assert not [r for r in caplog.records if "WeightedSamplingReader" in r.getMessage()]


REFUSALS = ["lengths", "empty", "negative", "zero_sum", "deterministic", "batched_output",
            "ngram", "schema", "placement"]


@pytest.mark.parametrize("refusal", REFUSALS)
def test_refusals_equal_jax(corpora, tmp_path, refusal):
    other = str(tmp_path / "other")
    write_dataset(other, Schema("X", [Field("zzz", np.int64)]), [{"zzz": 1}])
    jpeg = str(tmp_path / "jpeg")
    write_dataset(jpeg, Schema("J", [Field("id", np.int64),
                                     Field("image", np.uint8, (8, 8, 3),
                                           CompressedImageCodec("jpeg"))]),
                  [{"id": i, "image": np.full((8, 8, 3), i, np.uint8)} for i in range(4)])

    def build(which):
        ws, row_factory, batch_factory, _ = PACKAGES[which]
        ngram_cls = JaxNGram if which == "jax" else NGram
        a = row_factory(corpora[0], reader_pool_type="serial")
        b = {"batched_output": lambda: batch_factory(corpora[1], reader_pool_type="serial"),
             "ngram": lambda: row_factory(corpora[1], reader_pool_type="serial",
                                          ngram=ngram_cls({0: ["id"], 1: ["id"]}, 1, "id")),
             "schema": lambda: row_factory(other, reader_pool_type="serial")}.get(
            refusal, lambda: row_factory(corpora[1], reader_pool_type="serial"))()
        if refusal == "placement":
            a = row_factory(jpeg, reader_pool_type="serial", decode_placement={"image": "device"})
            b = row_factory(jpeg, reader_pool_type="serial")
        args = {"lengths": ([a, b], [1.0]), "empty": ([], []), "negative": ([a, b], [1, -1]),
                "zero_sum": ([a, b], [0, 0])}.get(refusal, ([a, b], [1, 1]))
        try:
            ws.WeightedSamplingReader(*args, seed=0,
                                      **({"deterministic": "seed"}
                                         if refusal == "deterministic" else {}))
        finally:
            for r in (a, b):
                r.stop()
                r.join()

    with pytest.raises(JaxError) as want:
        build("jax")
    with pytest.raises(PetastormTpuError) as got:
        build("torch")
    assert str(got.value) == str(want.value)


def test_row_access_to_a_device_decode_mix_names_the_loader(tmp_path):
    path = str(tmp_path / "jpeg")
    write_dataset(path, Schema("J", [Field("id", np.int64),
                                     Field("image", np.uint8, (8, 8, 3),
                                           CompressedImageCodec("jpeg"))]),
                  [{"id": i, "image": np.full((8, 8, 3), i, np.uint8)} for i in range(4)])
    readers = [make_reader(path, reader_pool_type="serial", decode_placement={"image": "device"})
               for _ in range(2)]
    with torch_ws.WeightedSamplingReader(readers, [1, 1], seed=0) as mixed:
        with pytest.raises(PetastormTpuError, match="cuda.CudaDataLoader"):
            next(mixed)


@pytest.mark.parametrize("shuffle", [0, 16])
def test_cuda_loader_on_cpu_over_a_mix_equals_jax_loader(corpora, shuffle):
    """cf. ``tests/test_weighted_and_shuffle_quality.py:132``: a mix of
    infinite readers through the loader, 12 batches."""
    loader_kwargs = dict(shuffling_queue_capacity=shuffle, buffer_seed=5) if shuffle else {}
    out = {}
    for which, loader in (("jax", None), ("torch", None)):
        ws = PACKAGES[which][0]
        mixed = ws.WeightedSamplingReader(
            _readers(which, corpora[:2], batch=True, num_epochs=None), [0.7, 0.3], seed=4)
        if which == "jax":
            loader = JaxDataLoader(mixed, batch_size=8, **loader_kwargs)
        else:
            loader = CudaDataLoader(mixed, 8, device="cpu", **loader_kwargs)
        with loader:
            it = iter(loader)
            out[which] = [(np.asarray(b["id"]).tolist(), np.asarray(b["vec"]).tolist())
                          for b in (next(it) for _ in range(12))]
    assert out["torch"] == out["jax"]
    sources = [i // 100 for ids, _ in out["torch"] for i in ids]
    assert set(sources) == {0, 1}


def test_device_decode_mix_through_the_loader_on_cpu(tmp_path):
    """Two JPEG corpora with ``decode_placement={'image': 'device'}``: labels
    equal to the JAX mix through ``JaxDataLoader``, images (B2's plain
    version) within 1 LSB of the JAX package's decode, the mixture digest
    equal."""
    schema = Schema("J", [Field("label", np.int64),
                          Field("image", np.uint8, (16, 24, 3),
                                CompressedImageCodec("jpeg", quality=90))])
    paths = []
    for src, n in enumerate((24, 12)):
        path = str(tmp_path / f"j{src}")
        write_dataset(path, schema, [{"label": 1000 * src + i,
                                      "image": _smooth(16, 24, src * 50 + i)}
                                     for i in range(n)], row_group_size_rows=6)
        paths.append(path)
    out = {}
    for which in PACKAGES:
        ws = PACKAGES[which][0]
        readers = _readers(which, paths, decode_placement={"image": "device"})
        mixed = ws.WeightedSamplingReader(readers, [0.75, 0.25], seed=2)
        loader = (JaxDataLoader(mixed, batch_size=6) if which == "jax"
                  else CudaDataLoader(mixed, 6, device="cpu"))
        with loader:
            out[which] = ([(np.asarray(b["label"]), np.asarray(b["image"])) for b in loader],
                          mixed.mixture_digest)
    (got, got_digest), (want, want_digest) = out["torch"], out["jax"]
    assert len(got) == len(want) == 6
    for (gl, gi), (wl, wi) in zip(got, want):
        np.testing.assert_array_equal(gl, wl)
        assert gi.dtype == np.uint8 and gi.shape == (6, 16, 24, 3)
        _assert_bytes_close(gi, wi)
    assert got_digest == want_digest and got_digest["draw_count"] == 8
