"""The port's Spark interop against the JAX package's, on the CPU, through the
mocked pyspark (``test_util.mock_pyspark``; pyspark is not installed here).

* ``spark.as_spark_schema``, ``dict_to_spark_row``, ``decode_row`` and
  ``dataset_as_rdd``: the JAX module's struct types, encoded rows and decoded
  RDD rows, exactly, with the port's mock in ``sys.modules`` for both;
* the converter's Spark DataFrame input: the JAX converter's cache directory
  name, the same pinned writer chain, the same rows read back, dedup by plan,
  a crashed write never adopted, nothing collected into the calling process;
* the port's mock against the JAX mock: the same frames and writer checks.
"""

import sys
import warnings

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from petastorm_tpu import converter as jax_converter
from petastorm_tpu import spark as jax_spark
from petastorm_tpu.codecs import CompressedImageCodec as JaxImageCodec
from petastorm_tpu.codecs import NdarrayCodec as JaxNdarrayCodec
from petastorm_tpu.codecs import ScalarCodec as JaxScalarCodec
from petastorm_tpu.schema import Field as JaxField
from petastorm_tpu.schema import Schema as JaxSchema
from petastorm_tpu.test_util import mock_pyspark as jax_mock
from petastorm_tpu_torch import converter, spark
from petastorm_tpu_torch.codecs import CompressedImageCodec, NdarrayCodec, ScalarCodec
from petastorm_tpu_torch.errors import SchemaError
from petastorm_tpu_torch.schema import Field, Schema
from petastorm_tpu_torch.test_util import mock_pyspark
from petastorm_tpu_torch.test_util.synthetic import create_test_dataset


@pytest.fixture()
def mocked(monkeypatch):
    """The port's mocked pyspark in ``sys.modules`` for the test."""
    mods = mock_pyspark.build_mock_pyspark_modules()
    for name, mod in mods.items():
        monkeypatch.setitem(sys.modules, name, mod)
    return mods


def _schemas():
    def build(F, S, Scalar, Image, Nd):
        return S("S", [F("id", np.int64, (), Scalar()),
                       F("name", np.str_, (), Scalar(), nullable=True),
                       F("img", np.uint8, (8, 8, 3), Image("png")),
                       F("vec", np.float32, (4,), Nd()),
                       F("flag", np.bool_, (), Scalar()),
                       F("small", np.uint8, (), Scalar()),
                       F("f", np.float64, (), Scalar(), nullable=True)])

    return (build(Field, Schema, ScalarCodec, CompressedImageCodec, NdarrayCodec),
            build(JaxField, JaxSchema, JaxScalarCodec, JaxImageCodec, JaxNdarrayCodec))


def test_as_spark_schema_equals_the_jax_modules(mocked):
    port, jax = _schemas()
    got, want = spark.as_spark_schema(port), jax_spark.as_spark_schema(jax)
    assert got == want
    kinds = {f.name: type(f.dataType).__name__ for f in got.fields}
    assert kinds == {"id": "LongType", "name": "StringType", "img": "BinaryType",
                     "vec": "BinaryType", "flag": "BooleanType", "small": "ShortType",
                     "f": "DoubleType"}
    assert [f.nullable for f in got.fields] == [f.nullable for f in want.fields]


def test_dict_to_spark_row_equals_the_jax_modules(mocked):
    port, jax = _schemas()
    value = {"id": 7, "name": None, "img": np.full((8, 8, 3), 9, np.uint8),
             "vec": np.ones(4, np.float32), "flag": True, "small": 3, "f": 0.5}
    got = spark.dict_to_spark_row(port, value).asDict()
    want = jax_spark.dict_to_spark_row(jax, value).asDict()
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    bad = dict(value, id=None)
    with pytest.raises(SchemaError) as got_err:
        spark.dict_to_spark_row(port, bad)
    with pytest.raises(Exception) as want_err:
        jax_spark.dict_to_spark_row(jax, bad)
    assert str(got_err.value) == str(want_err.value)


def _rdd_rows(module, url, fields=None):
    rows = module.dataset_as_rdd(url, mock_pyspark.MockSparkSession(),
                                 schema_fields=fields).collect()
    return [{k: (v.tobytes() if isinstance(v, np.ndarray) else
                 "nan" if isinstance(v, float) and np.isnan(v) else v)
             for k, v in row._asdict().items()} for row in rows]


@pytest.mark.parametrize("fields", [None, ["id", "matrix", "image_png"]],
                         ids=["all", "subset"])
def test_dataset_as_rdd_decodes_the_jax_modules_rows(mocked, tmp_path, fields):
    url = str(tmp_path / "ds")
    written = create_test_dataset(url, num_rows=12, row_group_size_rows=4)
    got, want = _rdd_rows(spark, url, fields), _rdd_rows(jax_spark, url, fields)
    assert got == want and len(got) == 12
    assert sorted(r["id"] for r in got) == [r["id"] for r in written]
    if fields:
        assert sorted(got[0]) == sorted(fields)


def test_dataset_as_rdd_of_a_legacy_dataset_equals_the_jax_modules(mocked, tmp_path):
    from petastorm_tpu_torch.test_util.legacy_petastorm import make_legacy_dataset
    from petastorm_tpu_torch.test_util.synthetic import TEST_SCHEMA

    src, dst = str(tmp_path / "src"), str(tmp_path / "legacy")
    schema = TEST_SCHEMA.view(["id", "id2", "image_png", "matrix", "sensor_name"])
    create_test_dataset(src, num_rows=10, row_group_size_rows=5, schema=schema)
    make_legacy_dataset(src, dst, schema)
    assert _rdd_rows(spark, dst) == _rdd_rows(jax_spark, dst)


def test_decode_row_equals_the_jax_modules(tmp_path):
    port, jax = _schemas()
    encoded = port.encode_row({"id": 3, "name": "x", "img": np.full((8, 8, 3), 2, np.uint8),
                               "vec": np.arange(4, dtype=np.float32), "flag": False,
                               "small": 1, "f": None})
    got, want = spark.decode_row(encoded, port), jax_spark.decode_row(encoded, jax)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(np.asarray(got[name], dtype=object),
                                      np.asarray(want[name], dtype=object))


def test_without_pyspark_both_refuse_the_same_way(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "pyspark", None)
    messages = []
    for module in (spark, jax_spark):
        with pytest.raises(NotImplementedError, match="pyspark") as err:
            module.dataset_as_rdd(str(tmp_path), mock_pyspark.MockSparkSession())
        messages.append(type(err.value))
    assert messages[0] is messages[1]


# -- the converter's Spark DataFrame input -----------------------------------------------

def _convert(module, frame, cache, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return module.make_converter(frame, cache_dir_url=str(cache), **kwargs)


def _read(conv):
    with conv.make_reader(reader_pool_type="serial", num_epochs=1,
                          shuffle_row_groups=False) as r:
        return [(int(row.id), float(row.x), np.asarray(row.vec).tolist()) for row in r]


@pytest.mark.parametrize("dtype", ["float32", "float64", None])
def test_a_spark_frame_converts_as_in_the_jax_converter(mocked, tmp_path, dtype):
    port = _convert(converter, mock_pyspark.mock_spark_dataframe(), tmp_path / "p", dtype=dtype)
    jax = _convert(jax_converter, jax_mock.mock_spark_dataframe(), tmp_path / "j", dtype=dtype)
    try:
        assert port.cache_url.rsplit("/", 1)[1] == jax.cache_url.rsplit("/", 1)[1]
        assert (len(port), len(port.file_urls)) == (len(jax), len(jax.file_urls)) == (32, 2)
        assert _read(port) == _read(jax)
        assert ([(f.name, f.dtype, f.shape) for f in port.schema]
                == [(f.name, f.dtype, f.shape) for f in jax.schema])
        if dtype == "float32":
            assert port.schema["x"].dtype == np.float32
            np.testing.assert_allclose(_read(port)[5][2], [5.0, 5.5, 5.25])
    finally:
        port.delete()
        jax.delete()


def test_the_writer_chain_is_the_jax_converters(mocked, tmp_path):
    chains = []
    for module, mock, cache in ((converter, mock_pyspark, tmp_path / "p"),
                                (jax_converter, jax_mock, tmp_path / "j")):
        mock.MockSparkDataFrame.write_calls.clear()
        conv = _convert(module, mock.mock_spark_dataframe(), cache, row_group_size_mb=32.0)
        try:
            written = [c for c in mock.MockSparkDataFrame.write_calls if c]
            assert len(written) == 1
            calls = written[0]
            assert calls[3][0] == "parquet" and "/.tmp-" in calls[3][1]
            chains.append(calls[:3] + [calls[3][0]])
        finally:
            mock.MockSparkDataFrame.write_calls.clear()
            conv.delete()
    assert chains[0] == chains[1] == [("mode", "overwrite"), ("option", "compression", "snappy"),
                                      ("option", "parquet.block.size", 32 * 2 ** 20), "parquet"]


def test_a_vector_column_warns_and_nothing_is_collected(mocked, tmp_path):
    frame = mock_pyspark.mock_spark_dataframe()
    with pytest.raises(AssertionError, match="collection into the calling process"):
        frame.toPandas()
    with pytest.warns(UserWarning, match="MLlib vector"):
        conv = converter.make_converter(frame, cache_dir_url=str(tmp_path))
    conv.delete()


def test_plan_dedup_and_a_crashed_write_as_in_the_jax_converter(mocked, tmp_path):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        prepared = converter._spark_prepare_df(mock_pyspark.mock_spark_dataframe(), "float32")
        jax_prepared = jax_converter._spark_prepare_df(jax_mock.mock_spark_dataframe(),
                                                       "float32")
    params = {"codec": "snappy", "rg_mb": 32.0, "v": 2, "engine": "spark"}
    tag = converter._spark_fingerprint(prepared, params)
    assert tag == jax_converter._spark_fingerprint(jax_prepared, params)
    stale = tmp_path / f"converted-{tag}"
    stale.mkdir()
    pq.write_table(pa.table({"id": [999]}), str(stale / "part-00000.parquet"))
    a = _convert(converter, mock_pyspark.mock_spark_dataframe(), tmp_path,
                 row_group_size_mb=32.0)
    try:
        assert len(a) == 32 and sorted(r[0] for r in _read(a)) == list(range(32))
        b = _convert(converter, mock_pyspark.mock_spark_dataframe(), tmp_path,
                     row_group_size_mb=32.0)
        c = _convert(converter, mock_pyspark.mock_spark_dataframe(16), tmp_path,
                     row_group_size_mb=32.0)
        assert b is a and c is not a
        c.delete()
    finally:
        a.delete()


def test_the_ports_mock_frames_are_the_jax_mocks():
    port, jax = mock_pyspark.mock_spark_dataframe(8), jax_mock.mock_spark_dataframe(8)
    assert port.schema.json() == jax.schema.json()
    assert port._jdf.queryExecution().analyzed().toString() == \
        jax._jdf.queryExecution().analyzed().toString()
    assert port._pdf["id"].tolist() == jax._pdf["id"].tolist()
    assert [v.toArray().tolist() for v in port._pdf["vec"]] == \
        [v.toArray().tolist() for v in jax._pdf["vec"]]
    mods = mock_pyspark.build_mock_pyspark_modules()
    with pytest.raises(AssertionError, match="column-name string"):
        mods["pyspark.sql.functions"].col("")
    with pytest.raises(AssertionError, match="dtype"):
        mods["pyspark.ml.functions"].vector_to_array(mods["pyspark.sql.functions"].col("v"),
                                                     "int8")
    with pytest.raises(AssertionError, match="write mode"):
        port.write.mode("append")
