"""Hive partitions, URL lists and the writer's remainder in the port,
against the JAX package on the CPU.

``partition_by`` writes (``petastorm_tpu/etl/writer.py``), the rowgroup
enumeration of a partitioned directory or a list of URLs
(``petastorm_tpu/etl/metadata.py:221-333``), the worker's partition values
(``petastorm_tpu/worker.py:552-560``), the partition-level predicate
pushdown (``petastorm_tpu/reader.py:659-681``), the index over a partition
column (``petastorm_tpu/etl/indexing.py:196-215``), schema inference with
partition columns, the geometry stamp, ``materialize_dataset`` and
``generate_metadata``.  Both packages read one directory on disk; rows,
orders, dtypes, digests, rowgroup lists and stamped KV must be equal.  Files
written by two calls carry different uuids in their names, so nothing here
compares names of files written by two calls.
"""

import json
import os
import shutil

import cv2
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from petastorm_tpu import predicates as jax_predicates
from petastorm_tpu import reader as jax_reader
from petastorm_tpu.codecs import CompressedImageCodec as JaxImageCodec
from petastorm_tpu.etl import generate_metadata as jax_generate
from petastorm_tpu.etl import indexing as jax_indexing
from petastorm_tpu.etl import metadata as jax_metadata
from petastorm_tpu.etl import writer as jax_writer
from petastorm_tpu.schema import Field as JaxField
from petastorm_tpu.schema import Schema as JaxSchema

from petastorm_tpu_torch import CompressedImageCodec, Field, Schema, predicates, reader
from petastorm_tpu_torch.errors import MetadataError, NoDataAvailableError, SchemaError
from petastorm_tpu_torch.etl import generate_metadata, indexing, metadata, writer

N_ROWS = 48
PKG = {"jax": (jax_reader, jax_writer, jax_metadata, jax_predicates, JaxSchema, JaxField),
       "torch": (reader, writer, metadata, predicates, Schema, Field)}


def _schema(pkg):
    S, F = PKG[pkg][4], PKG[pkg][5]
    return S("Parts", [F("x", np.int64), F("split", np.int64), F("name", np.str_),
                       F("v", np.float32, (3,))])


def _rows(n=N_ROWS, offset=0):
    # the partitions interleave row by row: per-partition buffering must
    # still fill whole rowgroups
    return [{"x": offset + i, "split": (offset + i) % 3, "name": f"r{offset + i}",
             "v": np.full(3, offset + i, np.float32)} for i in range(n)]


def _write(pkg, url, rows=None, **kwargs):
    kwargs.setdefault("row_group_size_rows", 4)
    return PKG[pkg][1].write_dataset(url, _schema(pkg), rows if rows is not None else _rows(),
                                     partition_by=["split"], **kwargs)


def _refs(pkg, url_or_urls):
    info = PKG[pkg][2].open_dataset(url_or_urls)
    return info, [(r.path, r.row_group, r.num_rows, r.global_index, r.partition_values)
                  for r in info.row_groups]


def _concat(parts):
    """Batches of one column as one array (rows of a ragged list column, or
    of fixed-width ones of several widths, as an object array of rows)."""
    if len({p.shape[1:] for p in parts}) == 1:
        return np.concatenate(parts)
    rows = [row for p in parts for row in p]
    out = np.empty(len(rows), dtype=object)
    out[:] = rows
    return out


def _read(pkg, url_or_urls, **kwargs):
    with PKG[pkg][0].make_batch_reader(url_or_urls, **kwargs) as r:
        cols = {}
        for b in r.iter_batches():
            for name, col in b.columns.items():
                cols.setdefault(name, []).append(col)
        out = {name: _concat(parts) for name, parts in cols.items()}
        return out, r.stream_digest, r.state_dict()["position"]


def _assert_same_read(url_or_urls, **kwargs):
    want, want_digest, want_pos = _read("jax", url_or_urls, **kwargs)
    got, digest, pos = _read("torch", url_or_urls, **kwargs)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        if got[name].dtype == object:
            assert len(got[name]) == len(want[name]), name
            for a, b in zip(got[name], want[name]):
                np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert (digest, pos) == (want_digest, want_pos)
    return got


# -- a partitioned dataset, whichever package wrote it ----------------------------

@pytest.mark.parametrize("writer_pkg", ["jax", "torch"])
@pytest.mark.parametrize("pool_type", ["serial", "thread"])
def test_partitioned_dataset_reads_like_jax(tmp_path, writer_pkg, pool_type):
    """The port reads the partition key from the path, in the stored dtype
    (the parent commit opened a JAX-written partitioned dataset and then
    failed inside the worker: the key is not stored in the files)."""
    url = str(tmp_path / "ds")
    _write(writer_pkg, url)
    got = _assert_same_read(url, reader_pool_type=pool_type, workers_count=3, shuffle_seed=7)
    assert got["split"].dtype == np.int64
    np.testing.assert_array_equal(got["split"], got["x"] % 3)
    assert sorted(got["x"].tolist()) == list(range(N_ROWS))
    assert not np.array_equal(got["x"], np.sort(got["x"]))  # shuffled by the seed
    # make_reader too (rows as namedtuples)
    rows = {}
    for pkg in ("jax", "torch"):
        with PKG[pkg][0].make_reader(url, reader_pool_type=pool_type, shuffle_seed=7) as r:
            rows[pkg] = [(int(row.x), int(row.split), str(row.name)) for row in r]
    assert rows["torch"] == rows["jax"]


def test_jax_written_partitioned_dataset_rowgroups_match(tmp_path):
    url = str(tmp_path / "ds")
    _write("jax", url)
    jinfo, want = _refs("jax", url)
    info, got = _refs("torch", url)
    assert got == want
    assert info.partition_keys == jinfo.partition_keys == ["split"]
    assert info.root_path == jinfo.root_path and info.path == jinfo.path
    assert info.files == jinfo.files
    assert info.arrow_schema == jinfo.arrow_schema


def test_port_writer_buffers_per_partition(tmp_path):
    """Rows interleaving across partitions make whole rowgroups: 16 rows a
    partition in rowgroups of 4 (no runts), as the JAX writer writes them."""
    for pkg in ("jax", "torch"):
        url = str(tmp_path / pkg)
        files = _write(pkg, url, rows_per_file=8)
        parts = sorted(os.path.relpath(f, url).split("/")[0] for f in files)
        assert parts == ["split=0"] * 2 + ["split=1"] * 2 + ["split=2"] * 2
        counts = json.loads(pq.read_metadata(os.path.join(url, "_common_metadata"))
                            .metadata[metadata.ROW_GROUPS_METADATA_KEY])["files"]
        assert sorted(counts.values()) == [[4, 4]] * 6
        for f in files:  # the partition key is not stored in the files
            assert pq.ParquetFile(f).schema_arrow.names == ["x", "name", "v"]


def test_writer_stamps_the_jax_kv(tmp_path):
    """The schema JSON and the per-partition rowgroup counts both writers
    stamp (file names differ by their uuids: compared per directory)."""
    kv = {}
    for pkg in ("jax", "torch"):
        url = str(tmp_path / pkg)
        _write(pkg, url, rows_per_file=8)
        raw = pq.read_metadata(os.path.join(url, "_common_metadata")).metadata
        counts = json.loads(raw[metadata.ROW_GROUPS_METADATA_KEY])["files"]
        kv[pkg] = (raw[b"petastorm-tpu.schema.v1"],
                   sorted((os.path.dirname(k), v) for k, v in counts.items()),
                   sorted(k for k in raw if k != b"ARROW:schema"))
    assert kv["torch"] == kv["jax"]


@pytest.mark.parametrize("bad,error,match", [
    (dict(partition_by=["nope"]), SchemaError, "not in schema"),
    (dict(partition_by=["v"]), SchemaError, "must be scalar"),
    (dict(rows=[{"x": 0, "split": None, "name": "a", "v": np.zeros(3, np.float32)}]),
     SchemaError, "partition values must be non-null"),
    (dict(mode="nope"), ValueError, "mode must be"),
])
def test_writer_refusals_like_jax(tmp_path, bad, error, match):
    for pkg in ("jax", "torch"):
        url = str(tmp_path / pkg)
        kwargs = dict(bad)
        rows = kwargs.pop("rows", _rows(8))
        partition_by = kwargs.pop("partition_by", ["split"])
        with pytest.raises(Exception, match=match) as info:
            PKG[pkg][1].write_dataset(url, _schema(pkg), rows, partition_by=partition_by,
                                      row_group_size_rows=4, **kwargs)
        assert type(info.value).__name__ == error.__name__
        # a failed write leaves no data file behind
        assert not [f for _, _, fs in os.walk(url) for f in fs if f.endswith(".parquet")]


def test_modes_error_overwrite_append_like_jax(tmp_path):
    out = {}
    for pkg in ("jax", "torch"):
        url = str(tmp_path / pkg)
        _write(pkg, url, rows=_rows(24))
        with pytest.raises(Exception, match="already contains") as info:
            _write(pkg, url, rows=_rows(24))
        assert type(info.value).__name__ == "SchemaError"
        _write(pkg, url, rows=_rows(12), mode="overwrite")
        _write(pkg, url, rows=_rows(24, offset=100), mode="append")
        with PKG[pkg][0].make_batch_reader(url, reader_pool_type="serial",
                                           shuffle_row_groups=False) as r:
            out[pkg] = sorted(int(x) for b in r.iter_batches() for x in b.columns["x"])
        info = PKG[pkg][2].open_dataset(url)
        assert len(info.row_groups) == 3 + 6
    assert out["torch"] == out["jax"] == list(range(12)) + list(range(100, 124))


def test_failed_write_deletes_its_files(tmp_path):
    url = str(tmp_path / "ds")
    _write("torch", url, rows=_rows(12))

    def rows():
        yield from _rows(8, offset=50)
        raise RuntimeError("the row source failed")

    with pytest.raises(RuntimeError, match="row source failed"):
        _write("torch", url, rows=rows(), mode="append")
    info = metadata.open_dataset(url)
    assert sum(r.num_rows for r in info.row_groups) == 12


# -- URL lists -----------------------------------------------------------------------

def _files(url, part=None):
    return sorted(os.path.join(d, f) for d, _, fs in os.walk(url) for f in fs
                  if f.endswith(".parquet") and (part is None or f"split={part}" in d))


@pytest.mark.parametrize("which", ["all", "one_partition", "two_partitions", "directories"])
def test_url_lists_like_jax(tmp_path, which):
    url = str(tmp_path / "ds")
    _write("jax", url, rows_per_file=8)
    urls = {"all": _files(url),
            "one_partition": _files(url, 2),
            "two_partitions": _files(url, 0) + _files(url, 1),
            "directories": [os.path.join(url, "split=1"), os.path.join(url, "split=2")]}[which]
    urls = ["file://" + u for u in urls] if which == "all" else urls
    jinfo, want = _refs("jax", urls)
    info, got = _refs("torch", urls)
    assert got == want and info.root_path == jinfo.root_path == url
    got = _assert_same_read(urls, reader_pool_type="serial", shuffle_seed=3)
    splits = {"all": {0, 1, 2}, "one_partition": {2}, "two_partitions": {0, 1},
              "directories": {1, 2}}[which]
    assert set(got["split"].tolist()) == splits
    assert set(got["x"].tolist()) == {x for x in range(N_ROWS) if x % 3 in splits}


def test_url_list_refusals(tmp_path):
    from petastorm_tpu_torch.errors import PetastormTpuError

    url = str(tmp_path / "ds")
    _write("torch", url)
    with pytest.raises(PetastormTpuError, match="Empty URL list"):
        metadata.open_dataset([])
    with pytest.raises(PetastormTpuError, match="share scheme"):
        metadata.open_dataset(["file:///a/b.parquet", "hdfs://x/b.parquet"])
    with pytest.raises(MetadataError, match="not found"):
        metadata.open_dataset([os.path.join(url, "nope.parquet")])


# -- the partition pushdown -------------------------------------------------------

@pytest.mark.parametrize("values", [{1}, {0, 2}, {5}])
def test_partition_pushdown_like_jax(tmp_path, values):
    url = str(tmp_path / "ds")
    _write("torch", url)
    if values == {5}:
        for pkg in ("jax", "torch"):
            with pytest.raises(Exception, match="Predicate filtered out all partitions") as info:
                PKG[pkg][0].make_batch_reader(url, predicate=PKG[pkg][3].in_set(values, "split"))
            assert type(info.value).__name__ == "NoDataAvailableError"
        assert issubclass(NoDataAvailableError, Exception)
        return
    kept = {}
    for pkg in ("jax", "torch"):
        with PKG[pkg][0].make_batch_reader(url, shuffle_seed=2,
                                           predicate=PKG[pkg][3].in_set(values, "split")) as r:
            kept[pkg] = [(i.row_group.global_index, i.row_group.row_group)
                         for i in r.plan.epoch_items(0)] if pkg == "torch" else None
    got = _assert_same_read(url, shuffle_seed=2, reader_pool_type="serial",
                            predicate=predicates.in_set(values, "split"))
    assert set(got["split"].tolist()) == values
    info = metadata.open_dataset(url)
    want = sorted((r.global_index, r.row_group) for r in info.row_groups
                  if int(dict(r.partition_values)["split"]) in values)
    assert sorted(kept["torch"]) == want
    # the workers get no predicate: the rows come whole from the kept rowgroups
    assert len(got["x"]) == sum(r.num_rows for r in info.row_groups
                                if int(dict(r.partition_values)["split"]) in values)


def test_pushdown_is_not_taken_for_a_mixed_predicate(tmp_path):
    url = str(tmp_path / "ds")
    _write("jax", url)
    mixed = {p: PKG[p][3].in_lambda(["split", "x"], lambda r: r["split"] == 1 and r["x"] > 20)
             for p in PKG}
    want, _, _ = _read("jax", url, reader_pool_type="serial", shuffle_seed=0,
                       predicate=mixed["jax"])
    got, _, _ = _read("torch", url, reader_pool_type="serial", shuffle_seed=0,
                      predicate=mixed["torch"])
    np.testing.assert_array_equal(got["x"], want["x"])
    assert set(got["x"].tolist()) == {x for x in range(21, N_ROWS) if x % 3 == 1}


# -- the index over a partition column -----------------------------------------------

def test_index_over_a_partition_column_like_jax(tmp_path):
    urls = {}
    for pkg in ("jax", "torch"):
        urls[pkg] = str(tmp_path / pkg)
    _write("torch", urls["jax"])
    shutil.copytree(urls["jax"], urls["torch"])
    jax_indexing.build_rowgroup_index(urls["jax"], [
        jax_indexing.SingleFieldIndexer("split_ix", "split"),
        jax_indexing.SingleFieldIndexer("name_ix", "name")])
    indexing.build_rowgroup_index(urls["torch"], [
        indexing.SingleFieldIndexer("split_ix", "split"),
        indexing.SingleFieldIndexer("name_ix", "name")])
    stored = {pkg: json.loads(pq.read_metadata(os.path.join(u, "_common_metadata"))
                              .metadata[metadata.ROWGROUP_INDEX_METADATA_KEY])
              for pkg, u in urls.items()}
    assert stored["torch"] == stored["jax"]
    ix = indexing.get_row_group_indexes(metadata.open_dataset(urls["torch"]))["split_ix"]
    info = metadata.open_dataset(urls["torch"])
    assert ix.get_row_group_indexes(2) == {r.global_index for r in info.row_groups
                                           if dict(r.partition_values)["split"] == "2"}


# -- schema inference with partition columns ----------------------------------------

def _plain_partitioned(tmp_path):
    """A plain parquet store (no stored schema) partitioned by a string key
    and an int key, with a list-of-scalar column."""
    url = str(tmp_path / "plain")
    table = pa.table({"x": pa.array(range(24), pa.int64()),
                      "seq": pa.array([[i, i + 1, i + 2][:1 + i % 3] for i in range(24)],
                                      pa.list_(pa.int32())),
                      "color": ["red", "green", "blue"] * 8,
                      "bucket": [i % 2 for i in range(24)]})
    pq.write_to_dataset(table, url, partition_cols=["color", "bucket"])
    return url


def test_inferred_schema_with_partition_columns_like_jax(tmp_path):
    url = _plain_partitioned(tmp_path)
    schemas = {}
    for pkg in ("jax", "torch"):
        info = PKG[pkg][2].open_dataset(url)
        s = PKG[pkg][2].infer_or_load_schema(info)
        schemas[pkg] = [(f.name, f.dtype, f.shape, type(f.codec).__name__, f.nullable)
                        for f in s]
    assert schemas["torch"] == schemas["jax"]
    assert ("seq", np.dtype("int32"), (None,), "ScalarListCodec", True) in schemas["torch"]
    got = _assert_same_read(url, reader_pool_type="serial", shuffle_seed=4)
    assert set(got["color"].tolist()) == {"red", "green", "blue"}
    assert got["color"].dtype == object


def test_partition_key_with_a_stored_schema_missing_raises_like_jax(tmp_path):
    """A field neither stored in the file nor a partition key is refused in
    the worker, with the JAX message."""
    url = str(tmp_path / "ds")
    _write("torch", url)
    wider = Schema("Parts", list(_schema("torch")) + [Field("extra", np.int64)])
    writer.stamp_dataset_metadata(url, wider, validate=False)
    with pytest.raises(Exception, match="neither stored in") as info:
        with reader.make_batch_reader(url, reader_pool_type="serial") as r:
            list(r.iter_batches())
    assert "nor a partition key" in str(info.value)


# -- the geometry stamp, materialize_dataset and generate_metadata -------------------

def _image_schema(pkg):
    S, F = PKG[pkg][4], PKG[pkg][5]
    codec = (JaxImageCodec if pkg == "jax" else CompressedImageCodec)("png")
    return S("Imgs", [F("idx", np.int64), F("img", np.uint8, (None, None, 3), codec)])


def _image_rows():
    rng = np.random.default_rng(0)
    shapes = [(8, 12), (16, 8), (8, 12), (5, 7)]
    return [{"idx": i, "img": rng.integers(0, 255, shapes[i % 4] + (3,), dtype=np.uint8)}
            for i in range(12)]


def _kv(url):
    raw = dict(pq.read_metadata(os.path.join(url, "_common_metadata")).metadata)
    raw.pop(b"ARROW:schema", None)
    return raw


def test_geometry_stamp_like_jax(tmp_path):
    kv = {}
    for pkg in ("jax", "torch"):
        url = str(tmp_path / pkg)
        PKG[pkg][1].write_dataset(url, _image_schema(pkg), _image_rows()[:6],
                                  row_group_size_rows=4)
        PKG[pkg][1].write_dataset(url, _image_schema(pkg), _image_rows()[6:],
                                  row_group_size_rows=4, mode="append")
        kv[pkg] = _kv(url)
        reader_geoms = (reader.make_batch_reader(url).declared_geometries if pkg == "torch"
                        else jax_reader.make_batch_reader(url).declared_geometries)
        kv[pkg + "_declared"] = reader_geoms
    key = metadata.GEOMETRIES_METADATA_KEY
    assert kv["torch"][key] == kv["jax"][key]
    assert json.loads(kv["torch"][key]) == {"img": [[5, 7, 3], [8, 12, 3], [16, 8, 3]]}
    assert kv["torch_declared"] == kv["jax_declared"] == {"img": [(5, 7, 3), (8, 12, 3),
                                                                  (16, 8, 3)]}


@pytest.mark.parametrize("merge", [True, False])
def test_stamp_dataset_metadata_kv_like_jax(tmp_path, merge):
    urls = {pkg: str(tmp_path / pkg) for pkg in ("jax", "torch")}
    writer.write_dataset(urls["jax"], _image_schema("torch"), _image_rows(),
                         row_group_size_rows=4)
    shutil.copytree(urls["jax"], urls["torch"])
    for pkg, url in urls.items():
        PKG[pkg][1].stamp_dataset_metadata(url, geometries={"img": [(2, 2, 3)]},
                                           merge_geometries=merge)
    assert _kv(urls["torch"]) == _kv(urls["jax"])
    shapes = json.loads(_kv(urls["torch"])[metadata.GEOMETRIES_METADATA_KEY])["img"]
    assert ([2, 2, 3] in shapes) and ((len(shapes) == 4) == merge)


def test_materialize_dataset_like_jax(tmp_path):
    urls = {pkg: str(tmp_path / pkg) for pkg in ("jax", "torch")}
    rows = _rows(16)
    for pkg, url in urls.items():
        schema = _schema(pkg)
        with PKG[pkg][1].materialize_dataset(url, schema):
            os.makedirs(url)
            table = pa.Table.from_pylist([schema.encode_row(r) for r in rows],
                                         schema=schema.as_arrow_schema())
            pq.write_table(table, os.path.join(url, "part-0.parquet"), row_group_size=4)
    assert _kv(urls["torch"]) == _kv(urls["jax"])
    _assert_same_read(urls["torch"], reader_pool_type="serial", shuffle_seed=0)


@pytest.mark.parametrize("how", ["function", "main", "main-scan", "main-infer",
                                 "main-schema-from"])
def test_generate_metadata_kv_like_jax(tmp_path, how, capsys):
    src = str(tmp_path / "src")
    writer.write_dataset(src, _image_schema("torch"), _image_rows(), row_group_size_rows=4,
                         partition_by=["idx"] if how == "main-infer" else ())
    urls = {pkg: str(tmp_path / pkg) for pkg in ("jax", "torch")}
    for url in urls.values():
        shutil.copytree(src, url)
        os.remove(os.path.join(url, "_common_metadata"))
    args = {"main": [], "main-scan": ["--scan-geometries"], "main-infer": ["--infer"],
            "main-schema-from": ["--schema-from", src]}.get(how)
    for pkg, url in urls.items():
        mod = jax_generate if pkg == "jax" else generate_metadata
        if args is None:
            mod.generate_metadata(url)
        else:
            assert mod.main([url] + args) == 0
    assert _kv(urls["torch"]) == _kv(urls["jax"])
    if how == "main":
        assert "metadata stamped" in capsys.readouterr().out
    if how == "main-scan":
        geoms = json.loads(_kv(urls["torch"])[metadata.GEOMETRIES_METADATA_KEY])
        assert geoms == {"img": [[5, 7, 3], [8, 12, 3], [16, 8, 3]]}
    # the rebuilt metadata reads the dataset as the original did
    before = [(r.path.replace(src, ""), r.row_group, r.num_rows, r.global_index)
              for r in metadata.open_dataset(src).row_groups]
    after = [(r.path.replace(urls["torch"], ""), r.row_group, r.num_rows, r.global_index)
             for r in metadata.open_dataset(urls["torch"]).row_groups]
    assert after == before


def test_scan_geometries_reads_headers_like_jax(tmp_path):
    url = str(tmp_path / "ds")
    writer.write_dataset(url, _image_schema("torch"), _image_rows(), row_group_size_rows=4)
    assert generate_metadata.scan_geometries(url) == jax_generate.scan_geometries(url)
    ok, jpeg = cv2.imencode(".jpg", np.zeros((9, 14, 3), np.uint8))
    assert generate_metadata._image_dims(jpeg.tobytes()) == (9, 14, 3)
    assert generate_metadata._image_dims(b"\x00" * 40) is None
    assert (generate_metadata.build_parser().parse_args(["u", "--infer"]).infer
            == jax_generate.build_parser().parse_args(["u", "--infer"]).infer)
