"""The port's legacy-Petastorm interop against the JAX package's, on the CPU.

Datasets "written by the original Petastorm" are ``tests/test_interop.py``'s:
fake ``petastorm``/``pyspark`` modules pickle the reference's byte streams
into ``_common_metadata``.  Both packages read them:

* the schema converted from the pickled Unischema: equal field by field
  (name, dtype, shape, codec class and parameters, nullability);
* rows through ``make_reader``/``make_batch_reader`` on the serial and
  thread pools under one seed: equal exactly, in order;
* the legacy rowgroup index: the same rowgroups for every value, and the
  same rows through a ``SingleIndexSelector``;
* the restricted unpickler: the same payloads refused with the same message,
  the same ones accepted with the same result.

``test_util.legacy_petastorm.make_legacy_dataset`` (the card check's writer)
is held to the JAX reader the same way.
"""

import logging
import os
import pickle
import subprocess
import sys
import types
from collections import Counter, OrderedDict, defaultdict
from decimal import Decimal

import numpy as np
import pyarrow.parquet as pq
import pytest
import torch

from petastorm_tpu import interop as jax_interop
from petastorm_tpu.etl import get_row_group_indexes as jax_get_indexes
from petastorm_tpu.etl import open_dataset as jax_open_dataset
from petastorm_tpu.reader import make_batch_reader as jax_make_batch_reader
from petastorm_tpu.reader import make_reader as jax_make_reader
from petastorm_tpu.selectors import SingleIndexSelector as JaxIndexSelector
from petastorm_tpu_torch import CompressedImageCodec, Field, Schema, interop, write_dataset
from petastorm_tpu_torch.cuda.loader import CudaDataLoader
from petastorm_tpu_torch.errors import MetadataError
from petastorm_tpu_torch.etl.indexing import get_row_group_indexes
from petastorm_tpu_torch.etl.metadata import open_dataset
from petastorm_tpu_torch.reader import make_batch_reader, make_reader
from petastorm_tpu_torch.selectors import SingleIndexSelector
from petastorm_tpu_torch.test_util.legacy_petastorm import fake_petastorm as port_fake
from petastorm_tpu_torch.test_util.legacy_petastorm import make_legacy_dataset
from test_interop import fake_petastorm, legacy_dataset  # noqa: F401  (fixtures)


def _field_facts(field):
    codec = field.codec
    params = {k: v for k, v in sorted(vars(codec).items())} if codec is not None else None
    return (field.name, np.dtype(field.dtype), tuple(field.shape),
            type(codec).__name__, params, bool(field.nullable))


def _assert_schemas_equal(port, jax):
    assert port.name == jax.name
    assert list(port.fields) == list(jax.fields)
    for name in jax.fields:
        assert _field_facts(port.fields[name]) == _field_facts(jax.fields[name]), name


def _row_tuple(row):
    out = []
    for value in row:
        if isinstance(value, np.ndarray):
            out.append((value.dtype.str, value.shape, value.tobytes()))
        elif isinstance(value, np.generic):
            out.append(value.item())
        else:
            out.append(value)
    return tuple(out)


def test_legacy_schema_equals_the_jax_packages(legacy_dataset):  # noqa: F811
    url, _ = legacy_dataset
    port, jax = open_dataset(url).stored_schema, jax_open_dataset(url).stored_schema
    assert port is not None and port.name == "LegacySchema"
    _assert_schemas_equal(port, jax)


@pytest.mark.parametrize("pool", ["serial", "thread"])
def test_legacy_rows_equal_the_jax_readers(legacy_dataset, pool):  # noqa: F811
    url, rows = legacy_dataset
    kwargs = dict(reader_pool_type=pool, workers_count=2, shuffle_seed=0, num_epochs=1)
    with make_reader(url, **kwargs) as reader:
        port = [_row_tuple(r) for r in reader]
    with jax_make_reader(url, **kwargs) as reader:
        jax = [_row_tuple(r) for r in reader]
    # the JAX thread pool delivers in completion order, the port in plan order
    assert (port == jax) if pool == "serial" else (sorted(port) == sorted(jax))
    assert len(port) == 20
    with make_reader(url, reader_pool_type="serial", shuffle_row_groups=False) as reader:
        by_id = {int(r.id): r for r in reader}
    for i in range(20):
        np.testing.assert_array_equal(by_id[i].image, rows["images"][i])
        np.testing.assert_array_equal(by_id[i].embedding, rows["embeddings"][i])


def test_legacy_batch_reader_equals_the_jax_one(legacy_dataset):  # noqa: F811
    url, _ = legacy_dataset
    kwargs = dict(reader_pool_type="serial", shuffle_seed=3, num_epochs=1)
    with make_batch_reader(url, **kwargs) as reader:
        port = [{k: np.asarray(v) for k, v in b.columns.items()} for b in reader.iter_batches()]
    with jax_make_batch_reader(url, **kwargs) as reader:
        jax = [{k: np.asarray(v) for k, v in b.columns.items()} for b in reader.iter_batches()]
    assert len(port) == len(jax) == 4
    for p, j in zip(port, jax):
        assert sorted(p) == sorted(j)
        for name in j:
            if j[name].dtype == object:
                assert [np.asarray(c).tobytes() if isinstance(c, np.ndarray) else c
                        for c in p[name]] == [np.asarray(c).tobytes()
                                              if isinstance(c, np.ndarray) else c
                                              for c in j[name]]
            else:
                np.testing.assert_array_equal(p[name], j[name])


def test_legacy_index_selects_the_jax_packages_rowgroups(legacy_dataset):  # noqa: F811
    url, _ = legacy_dataset
    port, jax = get_row_group_indexes(open_dataset(url)), jax_get_indexes(jax_open_dataset(url))
    assert sorted(port) == sorted(jax) == ["by_name", "name_not_null"]
    for value in [f"row_{i}" for i in range(20)] + ["missing"]:
        assert (port["by_name"].get_row_group_indexes(value)
                == jax["by_name"].get_row_group_indexes(value))
    assert (port["name_not_null"].get_row_group_indexes()
            == jax["name_not_null"].get_row_group_indexes() == {0, 1, 2, 3})
    kwargs = dict(reader_pool_type="serial", shuffle_seed=0)
    with make_reader(url, rowgroup_selector=SingleIndexSelector("by_name", ["row_12", "row_3"]),
                     **kwargs) as r:
        got = [int(row.id) for row in r]
    with jax_make_reader(url, rowgroup_selector=JaxIndexSelector("by_name", ["row_12", "row_3"]),
                         **kwargs) as r:
        want = [int(row.id) for row in r]
    assert got == want and sorted(got) == list(range(0, 5)) + list(range(10, 15))


def test_stale_legacy_row_group_counts_warn_as_in_the_jax_package(tmp_path, fake_petastorm,  # noqa: F811
                                                                  caplog):
    uni = fake_petastorm["petastorm.unischema"]
    schema = uni.Unischema("S", [uni.UnischemaField("x", np.int64, (), None, False)])
    table = __import__("pyarrow").table({"x": np.arange(10, dtype=np.int64)})
    root = tmp_path / "stale"
    root.mkdir()
    pq.write_table(table, root / "part-0.parquet", row_group_size=5)
    pq.write_metadata(table.schema.with_metadata({
        interop.LEGACY_UNISCHEMA_KEY: pickle.dumps(schema),
        interop.LEGACY_ROW_GROUPS_KEY: b'{"part-0.parquet": 7}'}), root / "_common_metadata")
    with caplog.at_level(logging.WARNING):
        port = open_dataset(str(root))
        jax = jax_open_dataset(str(root))
    assert len(port.row_groups) == len(jax.row_groups) == 2
    stale = [r.getMessage() for r in caplog.records if "stale" in r.getMessage()]
    assert len(stale) == 2 and stale[0] == stale[1]


def test_legacy_package_names_and_dtypes_convert_as_in_the_jax_package(fake_petastorm):  # noqa: F811
    uni = fake_petastorm["petastorm.unischema"]
    old = pickle.dumps(uni.Unischema("Old", [uni.UnischemaField("x", np.int32, (), None, False)]),
                       protocol=0)
    old = old.replace(b"petastorm.unischema", b"av.ml.dataset_toolkit.unischema")
    _assert_schemas_equal(interop.load_legacy_schema(old), jax_interop.load_legacy_schema(old))
    blob = pickle.dumps(uni.Unischema("D", [
        uni.UnischemaField("d", Decimal, (), None, False),
        uni.UnischemaField("f", np.dtype("float64"), (), None, True),
        uni.UnischemaField("s", np.dtype("U10"), (), None, False),
        uni.UnischemaField("b", np.bytes_, (), None, False)]))
    _assert_schemas_equal(interop.load_legacy_schema(blob), jax_interop.load_legacy_schema(blob))
    for bad in (pickle.dumps({"not": "a schema"}), pickle.dumps(uni.Unischema("E", []))):
        with pytest.raises(MetadataError) as got:
            interop.load_legacy_schema(bad)
        with pytest.raises(Exception) as want:
            jax_interop.load_legacy_schema(bad)
        assert str(got.value) == str(want.value)


class _Evil:
    def __reduce__(self):
        return (eval, ("1+1",))


class _GetAttr:
    def __reduce__(self):
        return (getattr, (Decimal("1"), "sqrt"))


class _Popen:
    def __reduce__(self):
        return (subprocess.Popen, (["true"],))


def _named_elsewhere(module, name):
    """A pickle of an instance of a class ``name`` in ``module`` (installed
    for the dump only)."""
    parts = module.split(".")
    made = []
    for i in range(1, len(parts) + 1):
        mod = ".".join(parts[:i])
        if mod not in sys.modules:
            sys.modules[mod] = types.ModuleType(mod)
            made.append(mod)
    cls = type(name, (object,), {"__module__": module})
    setattr(sys.modules[module], name, cls)
    cls.__qualname__ = name
    try:
        return pickle.dumps(cls())
    finally:
        for mod in made:
            del sys.modules[mod]


def _payloads():
    out = {
        "os.system": pickle.dumps(os.system),
        "eval reduce": pickle.dumps(_Evil()),
        "getattr reduce": pickle.dumps(_GetAttr()),
        "subprocess.Popen": pickle.dumps(_Popen()),
        "numpy.load": pickle.dumps(np.load),
        "collections.Counter": pickle.dumps(Counter("ab")),
        "builtins.exec": pickle.dumps(exec),
        "evil.unischema.Unischema": _named_elsewhere("evil.unischema", "Unischema"),
        "petastorm.codecs.Evil": _named_elsewhere("petastorm.codecs", "Evil"),
        "protocol 0 bytes": pickle.dumps(b"abc", protocol=0),
        # accepted by both
        "ndarray": pickle.dumps(np.arange(6, dtype=np.int16).reshape(2, 3)),
        "numpy scalar": pickle.dumps(np.float32(1.5)),
        "containers": pickle.dumps({"a": OrderedDict(b=[1, 2.5, True, None]),
                                    "c": defaultdict(set, {1: {2, 3}}),
                                    "d": (Decimal("1.25"), frozenset({1}), b"x", 1j)}),
    }
    return out


@pytest.mark.parametrize("name", ["os.system", "eval reduce", "getattr reduce",
                                  "subprocess.Popen", "numpy.load", "collections.Counter",
                                  "builtins.exec", "evil.unischema.Unischema",
                                  "petastorm.codecs.Evil", "protocol 0 bytes", "ndarray",
                                  "numpy scalar", "containers"])
def test_the_unpickler_refuses_what_the_jax_one_refuses(name):
    blob = _payloads()[name]
    outcome = {}
    for side, loads in (("port", interop._restricted_loads),
                        ("jax", jax_interop._restricted_loads)):
        try:
            outcome[side] = ("ok", pickle.dumps(loads(blob)))
        except Exception as exc:  # noqa: BLE001 - the outcome is compared
            outcome[side] = (type(exc).__name__, str(exc))
    assert outcome["port"] == outcome["jax"]
    refused = name not in ("ndarray", "numpy scalar", "containers")
    assert (outcome["port"][0] == "UnpicklingError") == refused, outcome["port"]


def test_shimmed_classes_and_spark_types_resolve_as_in_the_jax_package(fake_petastorm):  # noqa: F811
    cod = fake_petastorm["petastorm.codecs"]
    spark = fake_petastorm["pyspark.sql.types"]
    blob = pickle.dumps([cod.CompressedImageCodec("jpeg", 95), cod.ScalarCodec(spark.LongType()),
                         cod.NdarrayCodec(), cod.CompressedNdarrayCodec()])
    port, jax = interop._restricted_loads(blob), jax_interop._restricted_loads(blob)
    assert [type(c).__name__ for c in port] == [type(c).__name__ for c in jax]
    assert port[0]._image_codec == jax[0]._image_codec == ".jpeg"
    assert type(port[1]._spark_type).__name__ == "LongType"
    assert port[1]._spark_type.spark_name == jax[1]._spark_type.spark_name == "LongType"


@pytest.fixture(scope="module")
def port_jpeg_dataset(tmp_path_factory):
    rng = np.random.default_rng(23)
    schema = Schema("LegacyJpeg", [
        Field("label", np.int64),
        Field("name", np.str_),
        Field("image", np.uint8, (32, 24, 3), CompressedImageCodec("jpeg", quality=90))])
    path = str(tmp_path_factory.mktemp("port_format") / "ds")
    yy, xx = np.mgrid[0:32, 0:24]
    rows = [{"label": int(i % 5), "name": f"n{i}",
             "image": np.stack([(yy * 7 + xx * 3 + i) % 256, (xx * 9 + i * 5) % 256,
                                (yy * 4 + rng.integers(0, 8)) % 256], -1).astype(np.uint8)}
            for i in range(40)]
    write_dataset(path, schema, rows, row_group_size_rows=8)
    legacy = str(tmp_path_factory.mktemp("legacy_format") / "ds")
    written = make_legacy_dataset(path, legacy, schema, index_fields=["label"])
    return path, legacy, schema, written


def test_make_legacy_dataset_reads_as_the_jax_package_reads_it(port_jpeg_dataset):
    path, legacy, schema, written = port_jpeg_dataset
    port_info, jax_info = open_dataset(legacy), jax_open_dataset(legacy)
    assert interop.LEGACY_UNISCHEMA_KEY in port_info.kv_metadata
    assert not any(k.startswith(b"petastorm_tpu") for k in port_info.kv_metadata)
    _assert_schemas_equal(port_info.stored_schema, jax_info.stored_schema)
    # the source schema's, with a string field's dtype object (as the JAX
    # package converts the reference's np.str_)
    source = Schema(schema.name, [Field(f.name, object if f.dtype.kind == "U" else f.dtype,
                                        f.shape, f.codec, f.nullable)
                                  for f in schema.fields.values()])
    _assert_schemas_equal(port_info.stored_schema, source)
    assert ([(r.path.rsplit("/", 1)[1], r.row_group, r.num_rows) for r in port_info.row_groups]
            == [(r.path.rsplit("/", 1)[1], r.row_group, r.num_rows)
                for r in open_dataset(path).row_groups])
    port, jax = get_row_group_indexes(port_info), jax_get_indexes(jax_info)
    assert sorted(port) == sorted(jax) == ["label"]
    for value in range(6):
        assert (port["label"].get_row_group_indexes(value)
                == jax["label"].get_row_group_indexes(value)
                == written["label"].get(value, set()))
    kwargs = dict(reader_pool_type="serial", shuffle_seed=0, num_epochs=1)
    with make_reader(legacy, **kwargs) as r:
        got = [_row_tuple(row) for row in r]
    with jax_make_reader(legacy, **kwargs) as r:
        want = [_row_tuple(row) for row in r]
    with make_reader(path, **kwargs) as r:
        own = [_row_tuple(row) for row in r]
    assert got == want == own and len(got) == 40


def test_a_legacy_jpeg_dataset_feeds_the_loader_as_the_ports_own_format(port_jpeg_dataset):
    path, legacy, _, _ = port_jpeg_dataset
    out = []
    for url in (legacy, path):
        reader = make_reader(url, reader_pool_type="serial", shuffle_seed=0, num_epochs=1,
                             decode_placement={"image": "device"})
        with CudaDataLoader(reader, batch_size=8, device="cpu", fields=["label", "image"]) as loader:
            out.append([(b["label"].clone(), b["image"].clone()) for b in loader])
    assert len(out[0]) == len(out[1]) == 5
    for (la, ia), (lb, ib) in zip(*out):
        assert torch.equal(la, lb) and torch.equal(ia, ib) and ia.dtype == torch.uint8


def test_port_fake_modules_pickle_the_jax_tests_byte_streams(fake_petastorm):  # noqa: F811
    # the port's fake reference modules and tests/test_interop.py's give the
    # same pickle bytes for the same Unischema
    def unischema(mods):
        uni, cod = mods["petastorm.unischema"], mods["petastorm.codecs"]
        spark = mods["pyspark.sql.types"]
        return pickle.dumps(uni.Unischema("S", [
            uni.UnischemaField("id", np.int64, (), cod.ScalarCodec(spark.LongType()), False),
            uni.UnischemaField("img", np.uint8, (4, 4, 3), cod.CompressedImageCodec("png"),
                               False)]))

    want = unischema(fake_petastorm)
    with port_fake() as mods:
        got = unischema(mods)
    assert got == want
