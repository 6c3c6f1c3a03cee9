"""A mocked pyspark pinned to the exact API surface the port uses.

Counterpart of ``petastorm_tpu/test_util/mock_pyspark.py``: pyspark is not
installed here, so the Spark-DataFrame path of ``make_converter`` and the
``spark`` module run against this duck-typed stand-in, pinned to the pyspark
3.5 signatures:

* ``pyspark.sql.functions.col(name: str)``
* ``pyspark.ml.functions.vector_to_array(col: Column, dtype)`` with dtype in
  {'float32', 'float64'}
* ``Column.cast('float' | 'double' | 'array<float>' | 'array<double>')``
* ``DataFrame.withColumn`` / ``.schema.fields`` / ``.schema.json()`` /
  ``._jdf.queryExecution().analyzed().toString()`` (plan fingerprint)
* ``DataFrameWriter.mode('overwrite').option('compression', codec)
  .option('parquet.block.size', bytes).parquet(url)``
* ``pyspark.sql.types`` (the scalar types, ``ArrayType``, ``StructField``,
  ``StructType``) and ``pyspark.sql.Row``, for ``spark.as_spark_schema`` and
  ``spark.dict_to_spark_row``;
* ``SparkSession.read.parquet(url)`` -> a DataFrame with ``select`` and
  ``rdd.map(...).collect()`` over storage-form rows, for
  ``spark.dataset_as_rdd`` (:class:`MockSparkSession`).

Every mock rejects calls outside those signatures (assertion) instead of
silently accepting drift.  ``MockSparkDataFrame.toPandas()`` raises: the
converter must materialize on the "executors" (``df.write.parquet``), never
collect into the calling process (reference spark_dataset_converter.py:546-562).
Used by the port's tests and ``examples/spark_converter/``.
"""

from __future__ import annotations

import contextlib
import os
import sys
import types

import numpy as np
import pyarrow as pa


class MockVector:
    """Stand-in for a pyspark.ml.linalg Vector (VectorUDT cell)."""

    def __init__(self, values):
        self._values = np.asarray(values, dtype=np.float64)

    def toArray(self):
        return self._values


class MockType:
    def __init__(self, name, element=None):
        self._name = name
        self.elementType = element

    @property
    def type_name(self):
        return self._name


def mock_type(name, element=None):
    t = MockType(name, element)
    t.__class__ = type(name, (MockType,), {})  # type(x).__name__ drives code
    return t


class MockField:
    def __init__(self, name, data_type):
        self.name = name
        self.dataType = data_type


class MockSchema:
    def __init__(self, fields):
        self.fields = fields

    def json(self):
        return "|".join(f"{f.name}:{type(f.dataType).__name__}"
                        for f in self.fields)


class MockCol:
    def __init__(self, name):
        self.name = name

    def cast(self, target):
        return ("cast", self.name, target)


def build_mock_pyspark_modules() -> dict:
    """{module name: module} for the pinned pyspark surface; install into
    ``sys.modules`` (tests use monkeypatch.setitem, the example uses
    ``installed_mock_pyspark``)."""
    root = types.ModuleType("pyspark")
    sql = types.ModuleType("pyspark.sql")
    sqlf = types.ModuleType("pyspark.sql.functions")
    ml = types.ModuleType("pyspark.ml")
    mlf = types.ModuleType("pyspark.ml.functions")

    def _col(name):
        assert isinstance(name, str) and name, \
            f"pyspark.sql.functions.col takes a column-name string, got {name!r}"
        return MockCol(name)

    def _vector_to_array(col, dtype="float64"):
        assert isinstance(col, MockCol), \
            f"vector_to_array takes a Column (from col()), got {type(col)}"
        assert dtype in ("float32", "float64"), \
            f"vector_to_array dtype must be 'float32'/'float64', got {dtype!r}"
        return ("v2a", col.name, dtype)

    sqlf.col = _col
    mlf.vector_to_array = _vector_to_array
    types_mod = _mock_sql_types()
    sql.types = types_mod
    sql.Row = MockRow
    sql.SparkSession = MockSparkSession
    return {"pyspark": root, "pyspark.sql": sql,
            "pyspark.sql.functions": sqlf, "pyspark.ml": ml,
            "pyspark.ml.functions": mlf, "pyspark.sql.types": types_mod}


class _SparkType:
    """A ``pyspark.sql.types`` data type: equal to another of its class with
    the same arguments."""

    def __init__(self, *args):
        self.args = args

    def __eq__(self, other):
        return type(self) is type(other) and self.args == other.args

    def __hash__(self):
        return hash((type(self).__name__, self.args))

    def __repr__(self):
        return f"{type(self).__name__}{self.args if self.args else '()'}"


def _mock_sql_types() -> types.ModuleType:
    mod = types.ModuleType("pyspark.sql.types")
    for name in ("BinaryType", "StringType", "BooleanType", "ByteType", "ShortType",
                 "IntegerType", "LongType", "FloatType", "DoubleType", "DateType",
                 "TimestampType", "DecimalType"):
        setattr(mod, name, type(name, (_SparkType,), {"__module__": "pyspark.sql.types"}))

    class ArrayType(_SparkType):
        def __init__(self, elementType):
            super().__init__(elementType)
            self.elementType = elementType

    class StructField(_SparkType):
        def __init__(self, name, dataType, nullable=True):
            assert isinstance(name, str) and isinstance(dataType, _SparkType), (name, dataType)
            super().__init__(name, dataType, nullable)
            self.name, self.dataType, self.nullable = name, dataType, nullable

    class StructType(_SparkType):
        def __init__(self, fields):
            assert all(isinstance(f, StructField) for f in fields), fields
            super().__init__(tuple(fields))
            self.fields = list(fields)

    for cls in (ArrayType, StructField, StructType):
        cls.__module__ = "pyspark.sql.types"
        setattr(mod, cls.__name__, cls)
    return mod


class MockRow:
    """``pyspark.sql.Row(**fields)``: ``asDict()`` gives the fields back."""

    def __init__(self, **fields):
        self._fields = fields

    def asDict(self):
        return dict(self._fields)


class _MockRdd:
    def __init__(self, rows):
        self._rows = rows

    def map(self, fn):
        return _MockRdd([fn(r) for r in self._rows])

    def collect(self):
        return list(self._rows)


class _MockReadFrame:
    """What ``SparkSession.read.parquet`` gives: storage-form rows (encoded
    binary cells), as Spark reads them, with ``select`` and ``rdd``."""

    def __init__(self, rows, columns):
        self._rows = rows
        self.columns = list(columns)

    def select(self, *names):
        assert all(isinstance(n, str) and n in self.columns for n in names), names
        return _MockReadFrame([{k: r[k] for k in names} for r in self._rows], names)

    @property
    def rdd(self):
        return _MockRdd([MockRow(**r) for r in self._rows])


class MockSparkSession:
    """``SparkSession`` whose ``read.parquet(url)`` reads the data files (not
    ``_``-prefixed ones) under a local path or ``file://`` URL with pyarrow,
    in path order."""

    class _Reader:
        def parquet(self, url):
            import pyarrow.parquet as pq

            assert isinstance(url, str), url
            path = url[len("file://"):] if url.startswith("file://") else url
            files = sorted(os.path.join(d, f) for d, _, names in os.walk(path) for f in names
                           if f.endswith(".parquet") and not f.startswith("_"))
            table = pa.concat_tables([pq.read_table(f) for f in files])
            return _MockReadFrame(table.to_pylist(), table.column_names)

    @property
    def read(self):
        return self._Reader()


@contextlib.contextmanager
def installed_mock_pyspark():
    """Context manager installing the mock modules into ``sys.modules`` (and
    removing them after) - for scripts; tests prefer monkeypatch.setitem."""
    mods = build_mock_pyspark_modules()
    saved = {name: sys.modules.get(name) for name in mods}
    sys.modules.update(mods)
    try:
        yield
    finally:
        for name, old in saved.items():
            if old is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = old


class MockSparkDataFrame:
    """Pandas-backed stand-in: withColumn applies the mock expressions, write
    splits into two 'executor' part files, toPandas() is forbidden."""

    def __init__(self, pdf, schema, plan_tag):
        self._pdf = pdf
        self.schema = schema
        self._plan_tag = plan_tag

        class _QE:
            def queryExecution(self_inner):
                class _A:
                    def analyzed(self2):
                        class _S:
                            def toString(self3):
                                return plan_tag
                        return _S()
                return _A()
        self._jdf = _QE()

    def toPandas(self):
        raise AssertionError("collection into the calling process: the Spark path must"
                             " materialize on executors")

    def withColumn(self, name, expr):
        pdf = self._pdf.copy()
        fields = list(self.schema.fields)
        idx = next(i for i, f in enumerate(fields) if f.name == name)
        kind = expr[0]
        if kind == "v2a":
            _, src, dtype = expr
            np_t = np.float32 if dtype == "float32" else np.float64
            pdf[name] = [np.asarray(v.toArray(), dtype=np_t)
                         for v in pdf[src]]
            fields[idx] = MockField(name, mock_type(
                "ArrayType", mock_type(
                    "FloatType" if dtype == "float32" else "DoubleType")))
        elif kind == "cast":
            _, src, target = expr
            # pin cast targets to valid Spark SQL type strings (Column.cast
            # accepts a DDL-formatted type name)
            assert target in ("float", "double", "array<float>",
                              "array<double>"), \
                f"Column.cast called with non-Spark type string {target!r}"
            if target in ("float", "double"):
                np_t = np.float32 if target == "float" else np.float64
                pdf[name] = pdf[src].astype(np_t)
                fields[idx] = MockField(name, mock_type(
                    "FloatType" if target == "float" else "DoubleType"))
            else:  # array<float> / array<double>
                np_t = np.float32 if "float" in target else np.float64
                pdf[name] = [np.asarray(v, dtype=np_t) for v in pdf[src]]
                fields[idx] = MockField(name, mock_type(
                    "ArrayType", mock_type(
                        "FloatType" if "float" in target else "DoubleType")))
        else:
            raise AssertionError(f"unknown mock expr {expr!r}")
        return MockSparkDataFrame(pdf, MockSchema(fields),
                                  self._plan_tag + f"+{name}:{kind}")

    #: DataFrameWriter call sequences, one list per .write chain (pinned-API
    #: assertion surface; cleared by tests that inspect it)
    write_calls = []

    @property
    def write(self):
        df = self
        calls = []
        MockSparkDataFrame.write_calls.append(calls)

        class _Writer:
            def mode(self_inner, m):
                # converter.py must write mode('overwrite') into its fresh tmp
                # dir (DataFrameWriter.mode accepts a saveMode string)
                assert m == "overwrite", f"unexpected write mode {m!r}"
                calls.append(("mode", m))
                return self_inner

            def option(self_inner, k, v):
                # the two options the reference sets (spark_dataset_converter
                # .py:553-555): parquet codec + target block size
                assert k in ("compression", "parquet.block.size"), \
                    f"unexpected DataFrameWriter.option key {k!r}"
                if k == "parquet.block.size":
                    assert isinstance(v, int) and v > 0, v
                else:
                    assert isinstance(v, str) and v, v
                calls.append(("option", k, v))
                return self_inner

            def parquet(self_inner, url):
                assert isinstance(url, str) and "://" in url or url.startswith("/"), \
                    f"DataFrameWriter.parquet takes a path/URL string, got {url!r}"
                calls.append(("parquet", url))
                path = url[len("file://"):] if url.startswith("file://") else url
                os.makedirs(path, exist_ok=True)
                n = len(df._pdf)
                for part, sl in enumerate((slice(0, n // 2), slice(n // 2, n))):
                    table = pa.Table.from_pandas(df._pdf.iloc[sl],
                                                 preserve_index=False)
                    import pyarrow.parquet as pq
                    pq.write_table(table,
                                   os.path.join(path, f"part-{part:05d}.parquet"))
                open(os.path.join(path, "_SUCCESS"), "w").close()
        return _Writer()


def mock_spark_dataframe(n=32):
    """A small MockSparkDataFrame with long/double/VectorUDT columns - the
    three Spark types the converter's dtype/vector handling covers."""
    import pandas as pd

    pdf = pd.DataFrame({
        "id": np.arange(n, dtype=np.int64),
        "x": np.linspace(0, 1, n).astype(np.float64),
        "vec": [MockVector([i, i + 0.5, i + 0.25]) for i in range(n)],
    })
    schema = MockSchema([
        MockField("id", mock_type("LongType")),
        MockField("x", mock_type("DoubleType")),
        MockField("vec", mock_type("VectorUDT")),
    ])
    return MockSparkDataFrame(pdf, schema, plan_tag=f"mock-plan-{n}")
