"""``CompressedNdarrayCodec`` and ``ScalarListCodec`` in the port, against
the JAX package's (``petastorm_tpu/codecs.py:420``, ``:449``): the encoded
bytes and values, the JSON each package reads of the other's schema, the
fixed-width fast path and the ragged fallback of the list decode, and
list-column inference through ``make_batch_reader``.
"""

import io

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from petastorm_tpu import codecs as jax_codecs
from petastorm_tpu import reader as jax_reader
from petastorm_tpu import schema as jax_schema

from petastorm_tpu_torch import codecs, reader, schema
from petastorm_tpu_torch.errors import CodecError
from petastorm_tpu_torch.etl.writer import write_dataset

RNG = np.random.default_rng(11)
ARRAYS = [RNG.random((14, 14)).astype(np.float32), (RNG.random((14, 14)) > 0.5).astype(np.uint8),
          RNG.integers(-9, 9, (3, 4, 5)).astype(np.int16), np.arange(7, dtype=np.float64),
          np.zeros((0, 3), np.int32)]


@pytest.mark.parametrize("value", ARRAYS, ids=lambda a: f"{a.dtype}{a.shape}")
def test_compressed_ndarray_bytes_and_values_match_jax(value):
    field = schema.Field("a", value.dtype, value.shape, codecs.CompressedNdarrayCodec())
    jfield = jax_schema.Field("a", value.dtype, value.shape, jax_codecs.CompressedNdarrayCodec())
    got = field.codec.encode(field, value)
    assert got == jfield.codec.encode(jfield, value)
    with np.load(io.BytesIO(got)) as npz:  # petastorm's format: one 'arr' member
        np.testing.assert_array_equal(npz["arr"], value)
    for f, c in ((field, field.codec), (jfield, jfield.codec)):
        out = c.decode(f, got)
        assert out.dtype == value.dtype and out.shape == value.shape
        np.testing.assert_array_equal(out, value)
    column = pa.array([got, got], type=pa.binary())
    np.testing.assert_array_equal(field.codec.decode_column(field, column),
                                  jfield.codec.decode_column(jfield, column))
    assert field.codec.precompressed == jfield.codec.precompressed is True


def test_compressed_ndarray_refusals_match_jax():
    field = schema.Field("a", np.float32, (2, 2), codecs.CompressedNdarrayCodec())
    jfield = jax_schema.Field("a", np.float32, (2, 2), jax_codecs.CompressedNdarrayCodec())
    for bad, match in ((np.zeros((2, 3), np.float32), "shape mismatch"),
                       (np.zeros((2, 2), np.float64), "dtype mismatch"),
                       (np.zeros(4, np.float32), "rank mismatch")):
        with pytest.raises(CodecError, match=match) as info:
            field.codec.encode(field, bad)
        with pytest.raises(Exception) as jinfo:
            jfield.codec.encode(jfield, bad)
        assert str(info.value) == str(jinfo.value)


LISTS = {
    "fixed": [[1, 2, 3], [4, 5, 6], [7, 8, 9]],
    "ragged": [[1], [2, 3], [], [4, 5, 6]],
    "nulls": [[1, 2], None, [3, 4]],
    "empty": [],
    "fixed-empty": [[], []],
}


@pytest.mark.parametrize("case", sorted(LISTS))
@pytest.mark.parametrize("dtype", [np.int32, np.float64, np.int64])
def test_scalar_list_decode_matches_jax(case, dtype):
    values = LISTS[case]
    field = schema.Field("s", dtype, (None,), codecs.ScalarListCodec(), nullable=True)
    jfield = jax_schema.Field("s", dtype, (None,), jax_codecs.ScalarListCodec(), nullable=True)
    column = pa.array(values, type=field.codec.storage_type(field))
    assert column.type == jfield.codec.storage_type(jfield)
    got = field.codec.decode_column(field, column)
    want = jfield.codec.decode_column(jfield, column)
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == object:
        for a, b in zip(got, want):
            assert (a is None) == (b is None)
            if a is not None:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_array_equal(got, want)
        assert got.flags.writeable


def test_scalar_list_fixed_width_takes_the_one_copy_path():
    field = schema.Field("s", np.float32, (None,), codecs.ScalarListCodec())
    column = pa.array([[1.0, 2.0]] * 5, type=pa.list_(pa.float32()))
    out = field.codec.decode_column(field, column)
    assert out.shape == (5, 2) and out.dtype == np.float32 and out.flags.writeable
    sliced = column.slice(1, 3)
    np.testing.assert_array_equal(field.codec.decode_column(field, sliced), out[1:4])


@pytest.mark.parametrize("value", [[1, 2, 3], np.arange(4, dtype=np.int8), []])
def test_scalar_list_encode_matches_jax(value):
    field = schema.Field("s", np.int32, (None,), codecs.ScalarListCodec())
    jfield = jax_schema.Field("s", np.int32, (None,), jax_codecs.ScalarListCodec())
    assert field.codec.encode(field, value) == jfield.codec.encode(jfield, value)
    np.testing.assert_array_equal(field.codec.decode(field, [1, 2]),
                                  jfield.codec.decode(jfield, [1, 2]))
    with pytest.raises(CodecError, match="1-D"):
        field.codec.encode(field, np.zeros((2, 2)))


def _json_schema(mod_schema, mod_codecs):
    return mod_schema.Schema("Both", [
        mod_schema.Field("mask", np.uint8, (14, 14), mod_codecs.CompressedNdarrayCodec()),
        mod_schema.Field("seq", np.int64, (None,), mod_codecs.ScalarListCodec(), nullable=True),
        mod_schema.Field("label", np.int64)])


def test_codec_json_round_trips_across_the_packages():
    ours, theirs = _json_schema(schema, codecs), _json_schema(jax_schema, jax_codecs)
    assert ours.to_json() == theirs.to_json()
    read = schema.Schema.from_json(theirs.to_json())
    assert [type(f.codec).__name__ for f in read] == [
        "CompressedNdarrayCodec", "ScalarListCodec", "ScalarCodec"]
    assert list(read) == list(ours)
    for obj in ({"codec": "compressed_ndarray"}, {"codec": "scalar_list"}):
        assert codecs.codec_from_json(obj).to_json() == jax_codecs.codec_from_json(obj).to_json()


def test_a_jax_written_dataset_of_both_codecs_reads_the_same(tmp_path):
    from petastorm_tpu.etl.writer import write_dataset as jax_write

    rng = np.random.default_rng(3)
    rows = [{"mask": (rng.random((14, 14)) > 0.5).astype(np.uint8),
             "seq": rng.integers(0, 9, i % 4), "label": i} for i in range(20)]
    url = str(tmp_path / "ds")
    jax_write(url, _json_schema(jax_schema, jax_codecs), rows, row_group_size_rows=8)
    out = {}
    for mod in (jax_reader, reader):
        with mod.make_reader(url, reader_pool_type="serial", shuffle_seed=1) as r:
            out[mod.__name__] = [(int(row.label), row.mask.tobytes(), row.seq.tolist())
                                 for row in r]
    assert out["petastorm_tpu_torch.reader"] == out["petastorm_tpu.reader"]
    for label, mask, seq in out["petastorm_tpu_torch.reader"]:
        assert mask == rows[label]["mask"].tobytes() and seq == rows[label]["seq"].tolist()
    # and the port's writer gives the JAX reader the same rows
    url2 = str(tmp_path / "ds2")
    write_dataset(url2, _json_schema(schema, codecs), rows, row_group_size_rows=8)
    with jax_reader.make_reader(url2, reader_pool_type="serial", shuffle_seed=1) as r:
        assert [(int(row.label), row.mask.tobytes(), row.seq.tolist()) for row in r] == \
            out["petastorm_tpu.reader"]


@pytest.mark.parametrize("ragged", [False, True])
def test_list_column_inference_through_make_batch_reader(tmp_path, ragged):
    """A plain parquet store with list columns: the inferred field and the
    delivered columns equal the JAX package's (the port refused list
    columns before)."""
    n = 24
    seq = [list(range(i, i + (1 + i % 3 if ragged else 3))) for i in range(n)]
    table = pa.table({"id": pa.array(range(n), pa.int64()),
                      "seq": pa.array(seq, pa.list_(pa.float32())),
                      "big": pa.array([[i] * 2 for i in range(n)], pa.large_list(pa.int16()))})
    url = str(tmp_path / "plain")
    import os
    os.makedirs(url)
    pq.write_table(table, os.path.join(url, "part-0.parquet"), row_group_size=8)
    out = {}
    for mod in (jax_reader, reader):
        with mod.make_batch_reader(url, reader_pool_type="serial", shuffle_seed=2) as r:
            fields = [(f.name, f.dtype, f.shape, type(f.codec).__name__) for f in r.schema]
            batches = [(b.columns["id"].tolist(),
                        [np.asarray(v).tolist() for v in b.columns["seq"]],
                        b.columns["seq"].dtype.kind,
                        np.asarray(b.columns["big"]).tolist()) for b in r.iter_batches()]
        out[mod.__name__] = (fields, batches)
    assert out["petastorm_tpu_torch.reader"] == out["petastorm_tpu.reader"]
    fields = out["petastorm_tpu_torch.reader"][0]
    assert ("seq", np.dtype("float32"), (None,), "ScalarListCodec") in fields
    assert ("big", np.dtype("int16"), (None,), "ScalarListCodec") in fields
