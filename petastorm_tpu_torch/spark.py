"""Spark interop: decoded-row RDD over a dataset of this package (or a legacy
petastorm one).

Counterpart of ``petastorm_tpu/spark.py`` (reference:
petastorm/spark_utils.py:23-53): ``dataset_as_rdd`` reads the parquet store
as a Spark DataFrame and decodes each row with the dataset schema's codecs on
the executors, yielding schema namedtuples; ``as_spark_schema`` and
``dict_to_spark_row`` build a DataFrame to write through Spark.

pyspark is not a dependency of this package; everything here gates on its
presence at call time.  The Spark *writer* path is :mod:`converter`
(``make_converter`` takes a pyspark DataFrame).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

from petastorm_tpu_torch.etl.metadata import open_dataset
from petastorm_tpu_torch.schema import Schema


def _require_pyspark():
    try:
        import pyspark  # noqa: F401
    except ImportError as exc:
        raise NotImplementedError(
            "dataset_as_rdd requires pyspark, which is not installed. The"
            " port's consumers are make_reader/CudaDataLoader; Spark"
            " interop is optional.") from exc


def decode_row(row: Dict[str, Any], schema: Schema) -> Dict[str, Any]:
    """Apply each field's codec to one storage-form row dict.

    Row-level analog of the columnar decode plane (``worker.py``);
    exists for executors that hand us rows, like Spark (reference
    utils.py:54-87).
    """
    out = {}
    for field in schema:
        value = row.get(field.name)
        out[field.name] = None if value is None else field.codec.decode(field, value)
    return out


def as_spark_schema(schema: Schema):
    """``pyspark.sql.types.StructType`` for a Schema's STORAGE form.

    Reference parity: ``Unischema.as_spark_schema`` (unischema.py:264-281) -
    the schema handed to ``spark.createDataFrame`` when building a dataset
    from encoded rows (see :func:`dict_to_spark_row`).  Spark types derive
    from each codec's arrow storage type, so images/ndarrays map to
    BinaryType and scalars to their Spark scalar type.
    """
    _require_pyspark()
    from pyspark.sql import types as T

    fields = []
    for field in schema:
        arrow_type = field.codec.storage_type(field)
        fields.append(T.StructField(field.name, _arrow_to_spark_type(arrow_type),
                                    nullable=field.nullable))
    return T.StructType(fields)


def _arrow_to_spark_type(arrow_type):
    import pyarrow as pa
    from pyspark.sql import types as T

    scalars = {
        pa.binary(): T.BinaryType, pa.large_binary(): T.BinaryType,
        pa.string(): T.StringType, pa.large_string(): T.StringType,
        pa.bool_(): T.BooleanType,
        pa.int8(): T.ByteType, pa.int16(): T.ShortType,
        pa.int32(): T.IntegerType, pa.int64(): T.LongType,
        # Spark has no unsigned types: widen to the next signed type
        pa.uint8(): T.ShortType, pa.uint16(): T.IntegerType,
        pa.uint32(): T.LongType, pa.uint64(): T.LongType,
        pa.float16(): T.FloatType, pa.float32(): T.FloatType,
        pa.float64(): T.DoubleType,
        pa.date32(): T.DateType,
    }
    if arrow_type in scalars:
        return scalars[arrow_type]()
    if pa.types.is_timestamp(arrow_type):
        return T.TimestampType()
    if pa.types.is_decimal(arrow_type):
        return T.DecimalType(arrow_type.precision, arrow_type.scale)
    if pa.types.is_list(arrow_type) or pa.types.is_large_list(arrow_type):
        return T.ArrayType(_arrow_to_spark_type(arrow_type.value_type))
    raise NotImplementedError(
        f"No Spark type mapping for arrow storage type {arrow_type}")


def dict_to_spark_row(schema: Schema, row: Dict[str, Any]):
    """Encode one value dict through the schema's codecs into a pyspark Row.

    Reference parity: ``dict_to_spark_row`` (unischema.py:356-403) - the map
    function for building a Spark DataFrame to write through Spark::

        rows_rdd = sc.parallelize(dicts).map(
            lambda d: dict_to_spark_row(schema, d))
        df = spark.createDataFrame(rows_rdd, as_spark_schema(schema))

    Nullability is enforced (a None in a non-nullable field raises, as the
    reference does); missing nullable fields become explicit nulls.
    """
    _require_pyspark()
    from pyspark.sql import Row

    encoded = schema.encode_row(row)
    return Row(**encoded)


def dataset_as_rdd(dataset_url: str, spark_session,
                   schema_fields: Optional[Sequence] = None):
    """Decoded-row RDD of schema namedtuples for a dataset.

    :param dataset_url: dataset URL (any scheme Spark itself can read)
    :param spark_session: a ``pyspark.sql.SparkSession``
    :param schema_fields: optional field names/regexes/Field objects to subset
    """
    _require_pyspark()
    info = open_dataset(dataset_url, require_stored_schema=True)
    schema = info.stored_schema
    df = spark_session.read.parquet(dataset_url)
    if schema_fields is not None:
        schema = schema.view(schema_fields)
        df = df.select(*list(schema.fields))
    # default arguments freeze the objects Spark must ship to executors; the
    # lambda itself must not close over `info` (holds a live filesystem)
    return df.rdd.map(
        lambda row, _schema=schema: _schema.make_namedtuple_type()(
            **decode_row(row.asDict(), _schema)))


__all__ = ["dataset_as_rdd", "decode_row", "as_spark_schema",
           "dict_to_spark_row"]
