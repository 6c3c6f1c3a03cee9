"""Five faults found in the port against the JAX package, each repaired and
held to the JAX package here (each case failed on the port before):

1. timestamp, date and decimal columns (``dtypes.py``);
2. ``Reader.reset()``;
3. ``reader_pool_type='dummy'``;
4. ``CudaDataLoader.join()`` and ``diagnostics()['unquiesced_threads']``;
5. the public names ``TransformSpec``, ``PetastormTpuError``,
   ``NoDataAvailableError``, ``__version__``, ``schema.insert_explicit_nulls``
   and ``Reader.dataset_info``.
"""

import datetime
import decimal
import logging
import threading

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import petastorm_tpu
from petastorm_tpu import dtypes as jax_dtypes
from petastorm_tpu import pytorch as jax_pytorch
from petastorm_tpu.converter import make_converter as jax_make_converter
from petastorm_tpu.etl.writer import write_dataset as jax_write_dataset
from petastorm_tpu.reader import make_batch_reader as jax_make_batch_reader, \
    make_reader as jax_make_reader
from petastorm_tpu.schema import Field as JaxField, Schema as JaxSchema, \
    insert_explicit_nulls as jax_insert_explicit_nulls

import petastorm_tpu_torch
from petastorm_tpu_torch import dtypes, pytorch
from petastorm_tpu_torch.converter import make_converter
from petastorm_tpu_torch.cuda import loader as loader_module
from petastorm_tpu_torch.cuda.loader import CudaDataLoader
from petastorm_tpu_torch.errors import (EpochNotFinishedError, PetastormTpuError,
                                        ReaderClosedError, SchemaError)
from petastorm_tpu_torch.etl.writer import write_dataset
from petastorm_tpu_torch.reader import make_batch_reader, make_reader
from petastorm_tpu_torch.schema import Field, Schema, insert_explicit_nulls

N = 20


@pytest.fixture(scope="module")
def temporal_parquet(tmp_path_factory):
    """Plain Parquet (no stored schema) with timestamp, date and decimal columns."""
    root = tmp_path_factory.mktemp("temporal")
    table = pa.table({
        "id": pa.array(np.arange(N, dtype=np.int64)),
        "ts_us": pa.array([datetime.datetime(2020, 1, 1, 0, 0, i) for i in range(N)],
                          pa.timestamp("us")),
        "ts_ns": pa.array(np.arange(N, dtype=np.int64) * 1001 + 5, pa.timestamp("ns")),
        "d32": pa.array([datetime.date(2021, 1, 1 + i) for i in range(N)], pa.date32()),
        "d64": pa.array([datetime.date(2022, 3, 1 + i) for i in range(N)], pa.date64()),
        "dec": pa.array([decimal.Decimal(f"{i}.{i:02d}") for i in range(N)],
                        pa.decimal128(10, 2)),
    })
    pq.write_table(table, str(root / "part-0.parquet"), row_group_size=5)
    return str(root)


# -- 1. timestamp, date and decimal columns ----------------------------------------


@pytest.mark.parametrize("atype", [pa.timestamp("s"), pa.timestamp("ms"), pa.timestamp("us"),
                                   pa.timestamp("ns"), pa.timestamp("us", tz="UTC"),
                                   pa.date32(), pa.date64(), pa.decimal128(10, 2),
                                   pa.decimal256(40, 5), pa.dictionary(pa.int8(), pa.date32())])
def test_arrow_to_numpy_equals_jax(atype):
    assert dtypes.arrow_to_numpy(atype) == jax_dtypes.arrow_to_numpy(atype)


@pytest.mark.parametrize("dtype", ["datetime64[ns]", "datetime64[us]", "datetime64[D]"])
def test_numpy_datetime_to_arrow_equals_jax(dtype):
    assert dtypes.numpy_to_arrow(dtype) == jax_dtypes.numpy_to_arrow(dtype) == \
        pa.timestamp("ns")


def test_sanitize_value_passes_decimals_as_jax():
    value = decimal.Decimal("3.25")
    for dtype in ("object", "float64", "int64"):
        assert dtypes.sanitize_value(value, dtype) is value
        assert jax_dtypes.sanitize_value(value, dtype) is value


@pytest.mark.parametrize("pool", ["serial", "thread"])
def test_batch_reader_reads_temporal_and_decimal_columns_as_jax(temporal_parquet, pool):
    def read(make):
        with make(temporal_parquet, reader_pool_type=pool, shuffle_seed=1,
                  num_epochs=1) as reader:
            fields = {f.name: (f.dtype, f.shape) for f in reader.schema}
            return fields, [b.columns for b in reader.iter_batches()]

    got_fields, got = read(make_batch_reader)
    want_fields, want = read(jax_make_batch_reader)
    assert got_fields == want_fields
    assert got_fields["ts_us"][0] == np.dtype("datetime64[us]")
    assert got_fields["d32"][0] == np.dtype("datetime64[D]")
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for name in w:
            assert g[name].dtype == w[name].dtype, name
            np.testing.assert_array_equal(g[name], w[name], err_msg=name)
    assert isinstance(got[0]["dec"][3], decimal.Decimal)


def test_converter_takes_a_pandas_frame_with_a_datetime_column(tmp_path):
    frame = pd.DataFrame({"id": np.arange(12),
                          "t": pd.date_range("2020-01-01", periods=12, freq="h"),
                          "v": np.linspace(0, 1, 12)})
    conv = make_converter(frame, cache_dir_url=str(tmp_path / "port"))
    jax_conv = jax_make_converter(frame, cache_dir_url=str(tmp_path / "jax"))
    with conv.make_reader(reader_pool_type="serial", shuffle_row_groups=False) as reader:
        got = {int(r.id): r.t for r in reader}
    with jax_make_reader(jax_conv.cache_url, reader_pool_type="serial",
                         shuffle_row_groups=False) as reader:
        want = {int(r.id): r.t for r in reader}
    assert got == want and len(got) == 12
    assert got[3] == np.datetime64("2020-01-01T03:00")
    conv.delete()
    jax_conv.delete()


def test_datetime_field_round_trips_through_the_port_writer(tmp_path):
    stamps = np.datetime64("2024-02-29T12:00:00", "ns") + np.arange(8) * np.timedelta64(7, "s")
    rows = [{"id": i, "t": stamps[i]} for i in range(8)]
    url = str(tmp_path / "ds")
    write_dataset(url, Schema("T", [Field("id", np.int64),
                                    Field("t", np.dtype("datetime64[ns]"))]),
                  rows, row_group_size_rows=3)
    jax_url = str(tmp_path / "jax_ds")
    jax_write_dataset(jax_url, JaxSchema("T", [JaxField("id", np.int64),
                                               JaxField("t", np.dtype("datetime64[ns]"))]),
                      rows, row_group_size_rows=3)
    for make, path in ((make_reader, url), (jax_make_reader, url), (make_reader, jax_url)):
        with make(path, reader_pool_type="serial", shuffle_row_groups=False) as reader:
            assert [(int(r.id), r.t) for r in reader] == [(i, stamps[i]) for i in range(8)]
    assert pq.read_schema(f"{url}/{sorted(p.name for p in (tmp_path / 'ds').glob('*.parquet'))[0]}"
                          ).field("t").type == pa.timestamp("ns")


def test_decimal_friendly_collate_sees_a_decimal(temporal_parquet):
    with make_batch_reader(temporal_parquet, reader_pool_type="serial",
                           shuffle_row_groups=False, schema_fields=["dec"]) as reader:
        rows = [{"dec": d} for b in reader.iter_batches() for d in b.columns["dec"]]
    assert isinstance(rows[0]["dec"], decimal.Decimal)
    got = pytorch.decimal_friendly_collate(rows)
    want = jax_pytorch.decimal_friendly_collate(rows)
    assert got["dec"].dtype == want["dec"].dtype == torch.float64
    torch.testing.assert_close(got["dec"], want["dec"], rtol=0, atol=0)
    with make_batch_reader(temporal_parquet, reader_pool_type="serial",
                           shuffle_row_groups=False, schema_fields=["id", "dec"]) as reader:
        batches = list(pytorch.BatchedDataLoader(reader, batch_size=8))
    assert batches[0]["dec"].dtype == torch.float64
    assert batches[0]["dec"][:3].tolist() == [0.0, 1.01, 2.02]


# -- 2. Reader.reset() --------------------------------------------------------------


@pytest.fixture(scope="module")
def small_dataset(tmp_path_factory):
    url = str(tmp_path_factory.mktemp("reset") / "ds")
    write_dataset(url, Schema("S", [Field("id", np.int64)]), [{"id": i} for i in range(36)],
                  row_group_size_rows=5)
    return url


@pytest.mark.parametrize("pool", ["serial", "thread"])
@pytest.mark.parametrize("batched", [False, True])
def test_reset_after_epoch_equals_jax(small_dataset, pool, batched):
    """``tests/test_end_to_end.py:145``: the reset pass equals the first, and
    its stream digest a fresh reader's."""
    def read(reader):
        if batched:
            return [int(i) for b in reader.iter_batches() for i in b.columns["id"]]
        return [int(r.id) for r in reader]

    factory, jax_factory = ((make_batch_reader, jax_make_batch_reader) if batched
                            else (make_reader, jax_make_reader))
    kwargs = dict(reader_pool_type=pool, shuffle_seed=4, num_epochs=1)
    with factory(small_dataset, **kwargs) as reader:
        first = read(reader)
        digest = reader.stream_digest
        assert reader.last_row_consumed
        reader.reset()
        assert not reader.last_row_consumed
        second = read(reader)
        assert reader.stream_digest == digest and reader.last_row_consumed
        assert reader.state_dict()["position"] == len(reader.plan.epoch_items(0))
    with jax_factory(small_dataset, **kwargs) as reader:
        jax_first = read(reader)
        reader.reset()
        assert read(reader) == jax_first
    assert first == second == jax_first and sorted(first) == list(range(36))


@pytest.mark.parametrize("pool", ["serial", "thread"])
def test_reset_mid_epoch_raises_as_jax(small_dataset, pool):
    """``tests/test_end_to_end.py:155``."""
    with make_reader(small_dataset, shuffle_row_groups=False, reader_pool_type=pool) as reader:
        next(reader)
        with pytest.raises(EpochNotFinishedError):
            reader.reset()
    with jax_make_reader(small_dataset, shuffle_row_groups=False,
                         reader_pool_type=pool) as reader:
        next(reader)
        with pytest.raises(petastorm_tpu.errors.EpochNotFinishedError):
            reader.reset()


def test_reset_of_a_stopped_reader_raises(small_dataset):
    reader = make_reader(small_dataset, reader_pool_type="serial")
    list(reader)
    reader.stop()
    reader.join()
    with pytest.raises(ReaderClosedError):
        reader.reset()


def test_reset_of_an_endless_reader_raises(small_dataset):
    with make_reader(small_dataset, reader_pool_type="serial", num_epochs=None) as reader:
        next(reader)
        with pytest.raises(EpochNotFinishedError):
            reader.reset()


# -- 3. reader_pool_type='dummy' ----------------------------------------------------


@pytest.mark.parametrize("factory,jax_factory", [(make_reader, jax_make_reader),
                                                 (make_batch_reader, jax_make_batch_reader)])
def test_dummy_pool_is_the_serial_pool_as_in_jax(small_dataset, factory, jax_factory):
    def ids(make, pool):
        with make(small_dataset, reader_pool_type=pool, shuffle_seed=2) as reader:
            return [int(i) for b in reader.iter_batches() for i in b.columns["id"]]

    assert ids(factory, "dummy") == ids(factory, "serial") == ids(jax_factory, "dummy")
    with pytest.raises(PetastormTpuError, match="'thread', 'serial' or 'dummy'"):
        factory(small_dataset, reader_pool_type="bogus")


# -- 4. CudaDataLoader.join() -------------------------------------------------------


def _loader_threads():
    return [t for t in threading.enumerate()
            if t.is_alive() and t.name.startswith("petastorm-torch-")]


def test_loader_stop_then_join_as_jax(small_dataset):
    reader = make_reader(small_dataset, reader_pool_type="thread", num_epochs=None)
    loader = CudaDataLoader(reader, 4, device="cpu")
    next(iter(loader))
    loader.stop()
    loader.join()
    loader.join()  # idempotent
    assert loader.diagnostics()["unquiesced_threads"] == []
    assert not loader._thread.is_alive() and not loader._transfer_thread.is_alive()


def test_loader_stop_alone_leaves_no_thread(small_dataset):
    before = set(_loader_threads())
    reader = make_reader(small_dataset, reader_pool_type="thread", num_epochs=None)
    loader = CudaDataLoader(reader, 4, device="cpu")
    next(iter(loader))
    loader.stop()
    assert not loader._thread.is_alive() and not loader._transfer_thread.is_alive()
    assert set(_loader_threads()) <= before


def test_loader_join_records_a_thread_that_fails_to_quiesce(small_dataset, monkeypatch,
                                                            caplog):
    """A ``transform_fn`` wedged past ``stop()``: ``join()`` abandons the
    assembly thread after its bounded wait, warns, and records it."""
    monkeypatch.setattr(loader_module, "_JOIN_TIMEOUT_S", 0.2)
    release, entered, wedging = threading.Event(), threading.Event(), threading.Event()

    def wedged(cols):
        if entered.is_set():
            wedging.set()
            release.wait(30)
        entered.set()
        return cols

    reader = make_reader(small_dataset, reader_pool_type="serial", num_epochs=None)
    loader = CudaDataLoader(reader, 4, device="cpu", transform_fn=wedged)
    try:
        it = iter(loader)
        next(it)
        assert wedging.wait(10)  # the assembly thread is inside the transform
        with caplog.at_level(logging.WARNING, logger="petastorm_tpu_torch.cuda.loader"):
            loader.stop()
            loader.join()
        entries = loader.diagnostics()["unquiesced_threads"]
        assert entries == [{"thread": loader._thread.name, "stage": "host-assemble"}]
        # stop() joined once and abandoned it; the later join() neither
        # waits for it again nor warns twice
        assert sum("failed to quiesce" in r.message for r in caplog.records) == 1
    finally:
        release.set()
        loader._thread.join(10)
    assert not loader._thread.is_alive()


def test_loader_exit_calls_stop_then_join(small_dataset, monkeypatch):
    calls = []
    reader = make_reader(small_dataset, reader_pool_type="serial")
    loader = CudaDataLoader(reader, 4, device="cpu")
    real_stop, real_join = loader.stop, loader.join
    monkeypatch.setattr(loader, "stop", lambda: (calls.append("stop"), real_stop())[1])
    monkeypatch.setattr(loader, "join", lambda: (calls.append("join"), real_join())[1])
    with loader:
        list(loader)
    assert calls[0] == "stop" and calls[-1] == "join"  # stop() joins too


# -- 5. public names ------------------------------------------------------------------


def test_package_exports_the_jax_packages_names():
    from petastorm_tpu_torch import (NoDataAvailableError, PetastormTpuError as P,  # noqa: F401
                                     TransformSpec, __version__)

    assert __version__ == petastorm_tpu.__version__
    assert set(petastorm_tpu.__all__) <= set(petastorm_tpu_torch.__all__)
    for name in petastorm_tpu.__all__:
        assert hasattr(petastorm_tpu_torch, name), name
    assert issubclass(NoDataAvailableError, P)
    assert TransformSpec is petastorm_tpu_torch.transform.TransformSpec


def test_insert_explicit_nulls_equals_jax():
    fields = [("id", np.int64, False), ("name", np.dtype("object"), False),
              ("maybe", np.float32, True)]
    schema = Schema("s", [Field(n, d, nullable=k) for n, d, k in fields])
    jax_schema = JaxSchema("s", [JaxField(n, d, nullable=k) for n, d, k in fields])
    row = {"id": 1, "name": "n"}
    assert insert_explicit_nulls(schema, row) == jax_insert_explicit_nulls(jax_schema, row) \
        == {"id": 1, "name": "n", "maybe": None}
    assert row == {"id": 1, "name": "n"}  # a copy, not the caller's dict
    with pytest.raises(SchemaError, match="missing and not nullable"):
        insert_explicit_nulls(schema, {"name": "n"})


def test_reader_dataset_info_equals_jax(small_dataset, temporal_parquet):
    for url, make, jax_make in ((small_dataset, make_reader, jax_make_reader),
                                (temporal_parquet, make_batch_reader, jax_make_batch_reader)):
        with make(url, reader_pool_type="serial") as reader, \
                jax_make(url, reader_pool_type="serial") as jax_reader:
            got, want = reader.dataset_info, jax_reader.dataset_info
            assert got.files == want.files and got.root_path == want.root_path
            assert got.arrow_schema == want.arrow_schema
            assert [(rg.path, rg.row_group, rg.num_rows) for rg in got.row_groups] == \
                [(rg.path, rg.row_group, rg.num_rows) for rg in want.row_groups]
            assert (got.stored_schema is None) == (want.stored_schema is None)
