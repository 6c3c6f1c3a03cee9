"""TensorFlow delivery layer (optional: requires tensorflow to be installed).

Counterpart of ``petastorm_tpu/tf.py`` (reference: petastorm/tf_utils.py).
Both of the reference's APIs are provided: ``make_petastorm_dataset``
(``tf.data.Dataset.from_generator``, tf_utils.py:329-399), the TF2 path, and
graph-mode ``tf_tensors`` (py_func + RandomShuffleQueue + QueueRunner,
tf_utils.py:202-319) via ``tf.compat.v1`` for session-based training loops,
with the NGram flatten/unflatten across the py_func boundary
(tf_utils.py:141-183,402-433) and the shuffling queue's size node under a
well-known name (tf_utils.py:46-48,206-210).  The port's first-class
consumer is ``cuda.CudaDataLoader``; this module serves TensorFlow training
loops from the port's readers.

TensorFlow is not a dependency of petastorm_tpu_torch; importing this module
without it raises ImportError.
"""

from __future__ import annotations

import datetime
from decimal import Decimal

import numpy as np

from petastorm_tpu_torch.errors import PetastormTpuError

try:
    import tensorflow as tf
except ImportError as _exc:
    raise ImportError(
        "petastorm_tpu_torch.tf requires tensorflow, which is not installed. The"
        " port's consumers are petastorm_tpu_torch.cuda (CudaDataLoader) and"
        " petastorm_tpu_torch.pytorch; install tensorflow only if you need tf.data"
        " interop.") from _exc


def _tf_dtype(numpy_dtype: np.dtype) -> "tf.DType":
    """numpy -> tf dtype incl. the reference's promotions (tf_utils.py:27-44):
    uint16 -> int32, uint32 -> int64, str/Decimal -> string, datetime64 -> int64."""
    numpy_dtype = np.dtype(numpy_dtype)
    if numpy_dtype == np.uint16:
        return tf.int32
    if numpy_dtype == np.uint32:
        return tf.int64
    if numpy_dtype.kind in ("U", "S", "O"):
        return tf.string
    if numpy_dtype.kind == "M":
        return tf.int64
    return tf.as_dtype(numpy_dtype)


def _sanitize_value(value):
    """Row value -> something tf can ingest (reference tf_utils.py:58-97)."""
    if isinstance(value, Decimal):
        return str(value)
    if isinstance(value, (datetime.date, datetime.datetime)):
        # TZ-explicit epoch nanoseconds (naive datetimes are treated as UTC,
        # deterministically across hosts)
        return np.datetime64(value).astype("datetime64[ns]").astype(np.int64)
    if isinstance(value, (np.ndarray, np.generic)):
        # same promotions for arrays AND scalar cells: py_func type-checks
        # exactly, unlike tf.data's from_generator casting
        if value.dtype == np.uint16:
            return value.astype(np.int32)
        if value.dtype == np.uint32:
            return value.astype(np.int64)
        if value.dtype.kind == "M":
            return value.astype("datetime64[ns]").astype(np.int64)
    return value


#: Well-known graph-node name for the shuffling queue's size op, for external
#: diagnostics (reference tf_utils.py:46-48,206-210).
RANDOM_SHUFFLING_QUEUE_SIZE = "petastorm_tpu_random_shuffling_queue_size"


def _sanitize_row_values(row, schema) -> list:
    return [_sanitize_value(getattr(row, f.name)) for f in schema]


def _apply_shuffling_queue(fields_as_list, dtypes, capacity, min_after_dequeue):
    """RandomShuffleQueue + single-thread QueueRunner (tf_utils.py:202-220)."""
    v1 = tf.compat.v1
    shuffling_queue = v1.RandomShuffleQueue(capacity, min_after_dequeue, dtypes)
    # side effect: creates a graph node readable by well-known name
    shuffling_queue.size(name=RANDOM_SHUFFLING_QUEUE_SIZE)
    runner = v1.train.QueueRunner(shuffling_queue,
                                  [shuffling_queue.enqueue(fields_as_list)])
    v1.train.add_queue_runner(runner)
    dequeued = shuffling_queue.dequeue()
    # a 1-component queue dequeues a bare Tensor, not a list
    return dequeued if isinstance(dequeued, (list, tuple)) else [dequeued]


def _set_static_shapes(tensors: dict, schema, batched: bool) -> None:
    for name, tensor in tensors.items():
        field = schema[name]
        if tensor.get_shape().dims is None:
            shape = (None,) + field.shape if batched else field.shape
            tensor.set_shape(shape)


def tf_tensors(reader, shuffling_queue_capacity: int = 0,
               min_after_dequeue: int = 0):
    """Graph-mode tensors pulling from ``next(reader)`` (tf_utils.py:270-319).

    Returns a namedtuple of tensors (or, for NGram readers, a dict of
    ``{timestep: namedtuple}``); each evaluation dequeues one row.  Requires a
    TF1-style graph/session (``tf.compat.v1``); in eager TF2 use
    :func:`make_petastorm_dataset` instead.
    """
    if tf.executing_eagerly():
        raise PetastormTpuError(
            "tf_tensors builds graph-mode queue machinery; call it inside a"
            " tf.compat.v1.Graph (with tf.compat.v1.Session) or use"
            " make_petastorm_dataset for eager TF2")
    v1 = tf.compat.v1
    schema = reader.schema
    ngram = getattr(reader, "ngram", None)
    batched = getattr(reader, "batched_output", False)
    if batched and shuffling_queue_capacity > 0:
        raise PetastormTpuError(
            "shuffling_queue_capacity shuffles QUEUE ELEMENTS, and a batch"
            " reader's elements are whole rowgroup batches - rows inside each"
            " batch would keep their on-disk order. Use make_reader for"
            " row-level shuffling, or shuffle downstream.")

    if ngram is None:
        dtypes = [_tf_dtype(f.dtype) for f in schema]
        fields_as_list = v1.py_func(
            lambda _: _sanitize_row_values(next(reader), schema),
            [tf.constant(1)], dtypes)
        if shuffling_queue_capacity > 0:
            fields_as_list = _apply_shuffling_queue(
                fields_as_list, dtypes, shuffling_queue_capacity, min_after_dequeue)
        names = [f.name for f in schema]
        tensors = dict(zip(names, fields_as_list))
        _set_static_shapes(tensors, schema, batched)
        return schema.make_namedtuple_type()(**tensors)

    # NGram: flatten {timestep: namedtuple} to one ordered list across the
    # py_func boundary, unflatten back after (reference tf_utils.py:141-183)
    timestep_schemas = ngram.resolve_schema(schema)
    timesteps = sorted(timestep_schemas)
    dtypes = [_tf_dtype(f.dtype)
              for ts in timesteps for f in timestep_schemas[ts]]

    def _flatten_next(_):
        window = next(reader)
        return [_sanitize_value(getattr(window[ts], f.name))
                for ts in timesteps for f in timestep_schemas[ts]]

    fields_as_list = v1.py_func(_flatten_next, [tf.constant(1)], dtypes)
    if shuffling_queue_capacity > 0:
        fields_as_list = _apply_shuffling_queue(
            fields_as_list, dtypes, shuffling_queue_capacity, min_after_dequeue)
    result, pos = {}, 0
    for ts in timesteps:
        ts_schema = timestep_schemas[ts]
        names = [f.name for f in ts_schema]
        tensors = dict(zip(names, fields_as_list[pos:pos + len(names)]))
        pos += len(names)
        _set_static_shapes(tensors, ts_schema, batched)
        result[ts] = ts_schema.make_namedtuple_type()(**tensors)
    return result


def make_petastorm_dataset(reader) -> "tf.data.Dataset":
    """``tf.data.Dataset`` over a Reader (reference tf_utils.py:329-399).

    Row readers yield one element per row; batch readers yield one element per
    rowgroup (unbatch/rebatch downstream, as the reference's converter does,
    spark_dataset_converter.py:320-336).  NGram readers are not supported on
    the tf path (use ``tf_tensors``, or ``CudaDataLoader``'s window delivery).
    """
    if getattr(reader, "ngram", None) is not None:
        raise PetastormTpuError(
            "NGram readers are not supported by make_petastorm_dataset; use"
            " tf_tensors, or CudaDataLoader's window delivery, instead")
    schema = reader.schema
    fields = [f.name for f in schema]
    batched = getattr(reader, "batched_output", False)

    def _spec(f):
        shape = tuple(None if d is None else d for d in f.shape)
        if f.dtype.kind == "O" and not shape:
            shape = None  # object cells can hold arrays of unknown rank
        if batched:
            shape = (None,) + shape if shape is not None else None
        return tf.TensorSpec(shape=shape, dtype=_tf_dtype(f.dtype))

    signature = tuple(_spec(schema[f]) for f in fields)

    def _generator():
        for item in reader:
            yield tuple(_sanitize_value(getattr(item, f)) for f in fields)

    dataset = tf.data.Dataset.from_generator(_generator,
                                             output_signature=signature)
    named = schema.make_namedtuple_type()
    return dataset.map(lambda *row: named(*row))
