"""The port's TensorFlow delivery layer against the JAX package's, on the CPU.

The same dataset through ``make_petastorm_dataset`` and graph-mode
``tf_tensors`` of both packages: the ``tf.data`` element specs equal, every
element equal exactly (the reference's promotions: uint16 -> int32, strings
-> bytes), the graph tensors' static shapes and the rows a session pulls
equal, the NGram window flattening equal, the shuffling queue's size node
under the same name, and the same refusals.  The converter's
``make_tf_dataset`` gives the JAX converter's elements from one frame.
tensorflow and torch share the process.
"""

import datetime
from decimal import Decimal

import numpy as np
import pandas as pd
import pytest

tf = pytest.importorskip("tensorflow")

from petastorm_tpu import converter as jax_converter  # noqa: E402
from petastorm_tpu import tf as jax_tf  # noqa: E402
from petastorm_tpu.ngram import NGram as JaxNGram  # noqa: E402
from petastorm_tpu.reader import make_batch_reader as jax_make_batch_reader  # noqa: E402
from petastorm_tpu.reader import make_reader as jax_make_reader  # noqa: E402
from petastorm_tpu_torch import converter, tf as port_tf  # noqa: E402
from petastorm_tpu_torch.codecs import NdarrayCodec  # noqa: E402
from petastorm_tpu_torch.errors import PetastormTpuError  # noqa: E402
from petastorm_tpu_torch.etl.writer import write_dataset  # noqa: E402
from petastorm_tpu_torch.ngram import NGram  # noqa: E402
from petastorm_tpu_torch.reader import make_batch_reader, make_reader  # noqa: E402
from petastorm_tpu_torch.schema import Field, Schema  # noqa: E402


@pytest.fixture(scope="module")
def tf_dataset_url(tmp_path_factory):
    url = str(tmp_path_factory.mktemp("torch_tf_ds") / "ds")
    schema = Schema("TfSchema", [
        Field("id", np.int64),
        Field("u16", np.uint16),
        Field("name", np.dtype("object")),
        Field("vec", np.float32, (3,), NdarrayCodec()),
        Field("mat", np.int16, (2, 2), NdarrayCodec()),
    ])
    rows = [{"id": i, "u16": i * 2, "name": f"row_{i}", "vec": np.full(3, i, np.float32),
             "mat": np.arange(4, dtype=np.int16).reshape(2, 2) * i} for i in range(20)]
    write_dataset(url, schema, rows, row_group_size_rows=5)
    return url


def _plain(v):
    if isinstance(v, np.ndarray):
        return (v.tolist() if v.dtype == object else v.tobytes(), v.dtype.str, v.shape)
    return (v, type(v).__name__)


def _items(ds):
    return [{k: _plain(v) for k, v in item._asdict().items()} for item in ds.as_numpy_iterator()]


@pytest.mark.parametrize("batched", [False, True], ids=["rows", "batches"])
def test_the_tf_dataset_equals_the_jax_packages(tf_dataset_url, batched):
    kwargs = dict(reader_pool_type="serial", shuffle_row_groups=False, num_epochs=1)
    out = []
    for make, module in (((make_batch_reader if batched else make_reader), port_tf),
                         ((jax_make_batch_reader if batched else jax_make_reader), jax_tf)):
        with make(tf_dataset_url, **kwargs) as reader:
            ds = module.make_petastorm_dataset(reader)
            out.append((ds.element_spec, _items(ds)))
    (port_spec, port_items), (jax_spec, jax_items) = out
    assert [(s.shape.as_list() if s.shape.rank is not None else None, s.dtype)
            for s in port_spec] == [(s.shape.as_list() if s.shape.rank is not None else None,
                                     s.dtype) for s in jax_spec]
    assert port_items == jax_items
    assert len(port_items) == (4 if batched else 20)
    if not batched:
        assert port_items[3]["u16"] == (6, "int32") and port_items[3]["name"] == (b"row_3",
                                                                                   "bytes")


def test_tf_data_pipelines_over_both_reduce_equally(tf_dataset_url):
    sums = []
    for make, module in ((make_reader, port_tf), (jax_make_reader, jax_tf)):
        with make(tf_dataset_url, reader_pool_type="serial", shuffle_row_groups=False,
                  num_epochs=1) as reader:
            ds = module.make_petastorm_dataset(reader).map(
                lambda row: {"id": row.id, "vec": row.vec}).batch(5)

            @tf.function
            def epoch_sum(dataset):
                total = tf.constant(0, tf.int64)
                vec_sum = tf.zeros((3,), tf.float32)
                for batch in dataset:
                    total += tf.reduce_sum(batch["id"])
                    vec_sum += tf.reduce_sum(batch["vec"], axis=0)
                return total, vec_sum

            total, vec_sum = epoch_sum(ds)
            sums.append((int(total), vec_sum.numpy().tolist()))
    assert sums[0] == sums[1] == (190, [190.0] * 3)


def _graph_rows(make, module, url, n, **reader_kwargs):
    """The static shapes of ``tf_tensors`` and ``n`` rows a session pulls."""
    def shapes_of(row):
        return {k: v.get_shape().as_list() for k, v in row._asdict().items()}

    graph = tf.Graph()
    with graph.as_default():
        with make(url, reader_pool_type="serial", shuffle_row_groups=False,
                  **reader_kwargs) as reader:
            tensors = module.tf_tensors(reader)
            shapes = ({ts: shapes_of(t) for ts, t in tensors.items()}
                      if isinstance(tensors, dict) else shapes_of(tensors))
            with tf.compat.v1.Session() as sess:
                rows = [sess.run(tensors) for _ in range(n)]
    return shapes, rows


def _plain_row(row):
    return {k: (np.asarray(v).tobytes(), np.asarray(v).dtype.str)
            for k, v in row._asdict().items()}


def test_graph_mode_tensors_equal_the_jax_packages(tf_dataset_url):
    port_shapes, port_rows = _graph_rows(make_reader, port_tf, tf_dataset_url, 20,
                                         num_epochs=1)
    jax_shapes, jax_rows = _graph_rows(jax_make_reader, jax_tf, tf_dataset_url, 20,
                                       num_epochs=1)
    assert port_shapes == jax_shapes and port_shapes["vec"] == [3]
    assert [_plain_row(r) for r in port_rows] == [_plain_row(r) for r in jax_rows]
    assert [int(r.id) for r in port_rows] == list(range(20))


def test_graph_mode_ngram_windows_equal_the_jax_packages(tf_dataset_url):
    out = []
    for make, module, ngram_cls in ((make_reader, port_tf, NGram),
                                    (jax_make_reader, jax_tf, JaxNGram)):
        ngram = ngram_cls({0: ["id", "vec"], 1: ["id"]}, 1, "id")
        shapes, windows = _graph_rows(make, module, tf_dataset_url, 3, num_epochs=1,
                                      ngram=ngram)
        out.append((shapes, [{ts: _plain_row(w[ts]) for ts in sorted(w)} for w in windows]))
    assert out[0] == out[1]
    assert sorted(out[0][0]) == [0, 1] and "vec" not in out[0][0][1]


def test_the_shuffling_queue_node_and_refusals_are_the_jax_packages(tf_dataset_url):
    assert port_tf.RANDOM_SHUFFLING_QUEUE_SIZE == jax_tf.RANDOM_SHUFFLING_QUEUE_SIZE
    graph = tf.Graph()
    with graph.as_default():
        with make_reader(tf_dataset_url, reader_pool_type="serial", shuffle_row_groups=False,
                         num_epochs=None) as reader:
            row = port_tf.tf_tensors(reader, shuffling_queue_capacity=10, min_after_dequeue=2)
            assert graph.get_operation_by_name(port_tf.RANDOM_SHUFFLING_QUEUE_SIZE) is not None
            with tf.compat.v1.Session() as sess:
                coord = tf.compat.v1.train.Coordinator()
                threads = tf.compat.v1.train.start_queue_runners(sess, coord)
                ids = [int(sess.run(row).id) for _ in range(40)]
                coord.request_stop()
                coord.join(threads, stop_grace_period_secs=5)
    assert set(ids) <= set(range(20)) and ids[:20] != list(range(20))
    messages = []
    for make, batch_make, module in ((make_reader, make_batch_reader, port_tf),
                                     (jax_make_reader, jax_make_batch_reader, jax_tf)):
        with make(tf_dataset_url, num_epochs=1) as reader:
            with pytest.raises(Exception, match="graph") as eager:
                module.tf_tensors(reader)
        graph = tf.Graph()
        with graph.as_default():
            with batch_make(tf_dataset_url, num_epochs=1) as reader:
                with pytest.raises(Exception, match="rowgroup batches") as batched:
                    module.tf_tensors(reader, shuffling_queue_capacity=100)
        messages.append((str(eager.value), str(batched.value)))
    assert messages[0] == messages[1]
    ngram = NGram({0: ["vec"], 1: ["vec"]}, 1, "id")
    with make_reader(tf_dataset_url, ngram=ngram, num_epochs=1) as reader:
        with pytest.raises(PetastormTpuError, match="NGram"):
            port_tf.make_petastorm_dataset(reader)


@pytest.mark.parametrize("value", [
    Decimal("1.50"), datetime.date(2021, 3, 4), datetime.datetime(2021, 3, 4, 5, 6, 7),
    np.uint16(7), np.arange(3, dtype=np.uint32), np.datetime64("2020-01-01", "D"),
    np.array(["2020-01-01T00:00:01", "2021-05-06T07:08:09"], dtype="datetime64[s]"), "text", 3,
    np.float32(1.25)],
    ids=lambda v: type(v).__name__)
def test_values_are_sanitized_as_in_the_jax_package(value):
    got, want = port_tf._sanitize_value(value), jax_tf._sanitize_value(value)
    assert type(got) is type(want)
    assert np.asarray(got).dtype == np.asarray(want).dtype
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("dtype", [np.uint16, np.uint32, np.int8, np.float64, np.bool_,
                                   np.dtype("object"), np.dtype("U3"),
                                   np.dtype("datetime64[ns]")],
                         ids=str)
def test_tf_dtypes_equal_the_jax_packages(dtype):
    assert port_tf._tf_dtype(dtype) == jax_tf._tf_dtype(dtype)


def test_the_converters_tf_dataset_equals_the_jax_converters(tmp_path):
    frame = pd.DataFrame({"id": np.arange(12, dtype=np.int64),
                          "x": np.linspace(0.0, 1.0, 12),
                          "v": [np.arange(3, dtype=np.float64) + i for i in range(12)]})
    out = []
    for module, cache in ((converter, tmp_path / "port"), (jax_converter, tmp_path / "jax")):
        conv = module.make_converter(frame, cache_dir_url=str(cache))
        try:
            with conv.make_tf_dataset(reader_kwargs={"num_epochs": 1,
                                                     "reader_pool_type": "serial",
                                                     "shuffle_row_groups": False}) as ds:
                out.append((posix_name(conv.cache_url), _items(ds)))
        finally:
            conv.delete()
    assert out[0] == out[1]
    assert len(out[0][1]) == 12 and out[0][1][3]["x"][0] == np.float32(3 / 11)


def posix_name(url):
    return url.rstrip("/").rsplit("/", 1)[-1]
