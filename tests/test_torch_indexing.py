"""The port's rowgroup indexes and selectors against the JAX package's, on the CPU.

Each package builds the same indexes over copies of one dataset: the stored
JSON is equal byte for byte, each package reads the index the other built,
and single, intersect and union selectors select equal rowgroup sets.  A
dataset that carries only the legacy petastorm index raises in the port
(reading it is not ported); the build refusals carry the JAX messages.
"""

import json
import shutil

import numpy as np
import pyarrow.parquet as pq
import pytest

import petastorm_tpu.selectors as jax_selectors
from petastorm_tpu.errors import PetastormTpuError as JaxError
from petastorm_tpu.etl import indexing as jax_indexing
from petastorm_tpu.etl import metadata as jax_metadata

import petastorm_tpu_torch.selectors as torch_selectors
from petastorm_tpu_torch import CompressedImageCodec, Field, Schema, write_dataset
from petastorm_tpu_torch.errors import MetadataError, PetastormTpuError
from petastorm_tpu_torch.etl import indexing as torch_indexing
from petastorm_tpu_torch.etl import metadata as torch_metadata

ROWS, GROUP = 90, 12


def _rows():
    rng = np.random.default_rng(0)
    out = []
    for i in range(ROWS):
        out.append({"id": i, "bucket": int(rng.integers(0, 6)) if i < 60 else 10 + i // 30,
                    "name": f"n{i // 20}" if i % 11 else None,
                    "img": rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)})
    return out


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("indexing") / "ds")
    schema = Schema("Indexed", [
        Field("id", np.int64),
        Field("bucket", np.int32),
        Field("name", np.str_, (), nullable=True),
        Field("img", np.uint8, (8, 8, 3), CompressedImageCodec("png")),
    ])
    write_dataset(path, schema, _rows(), row_group_size_rows=GROUP)
    return path


def _indexers(mod):
    return [mod.SingleFieldIndexer("bucket_ix", "bucket"),
            mod.SingleFieldIndexer("name_ix", "name"),
            mod.FieldNotNullIndexer("name_nn", "name")]


def _stored(path):
    return dict(pq.read_metadata(f"{path}/_common_metadata").metadata)[
        torch_metadata.ROWGROUP_INDEX_METADATA_KEY]


@pytest.fixture(scope="module")
def built(dataset, tmp_path_factory):
    """Copies of the dataset indexed by each package (the second call adds
    an index beside the first, as a user would)."""
    out = {}
    for name, mod in (("jax", jax_indexing), ("port", torch_indexing)):
        path = str(tmp_path_factory.mktemp(f"built_by_{name}") / "ds")
        shutil.copytree(dataset, path)
        ixs = _indexers(mod)
        mod.build_rowgroup_index(path, ixs[:2])
        mod.build_rowgroup_index(path, ixs[2:])
        out[name] = path
    return out


def test_key_equals_jax():
    assert torch_metadata.ROWGROUP_INDEX_METADATA_KEY == jax_metadata.ROWGROUP_INDEX_METADATA_KEY


def test_stored_index_bytes_equal(built):
    assert _stored(built["port"]) == _stored(built["jax"])
    names = [ix["name"] for ix in json.loads(_stored(built["port"]))["indexes"]]
    assert names == ["bucket_ix", "name_ix", "name_nn"]


def test_rebuilding_an_index_replaces_it(built, tmp_path):
    path = str(tmp_path / "ds")
    shutil.copytree(built["port"], path)
    torch_indexing.build_rowgroup_index(path, [torch_indexing.SingleFieldIndexer("bucket_ix",
                                                                                 "id")])
    names = [ix["name"] for ix in json.loads(_stored(path))["indexes"]]
    assert names == ["name_ix", "name_nn", "bucket_ix"]


def _loaded(pkg, path):
    if pkg == "jax":
        return jax_indexing.get_row_group_indexes(jax_metadata.open_dataset(path))
    return torch_indexing.get_row_group_indexes(torch_metadata.open_dataset(path))


@pytest.mark.parametrize("built_by", ["jax", "port"])
def test_each_package_reads_the_others_index(built, built_by):
    want = _loaded("jax", built[built_by])
    got = _loaded("port", built[built_by])
    assert sorted(got) == sorted(want)
    for name in want:
        assert type(got[name]).__name__ == type(want[name]).__name__
        assert got[name].to_json() == want[name].to_json()
        assert got[name].indexed_values() == want[name].indexed_values()
    assert got["bucket_ix"].get_row_group_indexes(np.int64(3)) == \
        want["bucket_ix"].get_row_group_indexes(3)
    assert got["name_nn"].get_row_group_indexes() == want["name_nn"].get_row_group_indexes()


def _selector(mod, case):
    single = {
        "bucket": lambda: mod.SingleIndexSelector("bucket_ix", [12, 13]),
        "name": lambda: mod.SingleIndexSelector("name_ix", ["n3", "n9"]),
        "not_null": lambda: mod.SingleIndexSelector("name_nn", ["any"]),
        "empty": lambda: mod.SingleIndexSelector("bucket_ix", [99]),
    }
    if case in single:
        return single[case]()
    parts = [single["bucket"](), single["name"]()]
    if case == "intersect":
        return mod.IntersectIndexSelector(parts)
    if case == "union":
        return mod.UnionIndexSelector(parts)
    return mod.UnionIndexSelector([mod.IntersectIndexSelector(parts), single["empty"]()])


@pytest.mark.parametrize("case", ["bucket", "name", "not_null", "empty", "intersect",
                                  "union", "nested"])
def test_selected_sets_equal(built, case):
    want = _selector(jax_selectors, case).select_row_groups(_loaded("jax", built["jax"]))
    got = _selector(torch_selectors, case).select_row_groups(_loaded("port", built["port"]))
    assert got == want
    assert _selector(torch_selectors, case).get_index_names() == \
        _selector(jax_selectors, case).get_index_names()
    if case in ("bucket", "name", "intersect", "union", "nested"):
        assert 0 < len(got) < -(-ROWS // GROUP)


def test_missing_index_refused_like_jax(built):
    with pytest.raises(JaxError) as want:
        jax_selectors.SingleIndexSelector("nope", [1]).select_row_groups(
            _loaded("jax", built["jax"]))
    with pytest.raises(PetastormTpuError) as got:
        torch_selectors.SingleIndexSelector("nope", [1]).select_row_groups(
            _loaded("port", built["port"]))
    assert str(got.value) == str(want.value)


def test_build_refusals_match(dataset, tmp_path):
    path = str(tmp_path / "ds")
    shutil.copytree(dataset, path)
    with pytest.raises(JaxError) as want:
        jax_indexing.build_rowgroup_index(path, [jax_indexing.SingleFieldIndexer("x", "nope")])
    with pytest.raises(MetadataError) as got:
        torch_indexing.build_rowgroup_index(path, [torch_indexing.SingleFieldIndexer("x",
                                                                                     "nope")])
    assert str(got.value) == str(want.value)
    with pytest.raises(MetadataError, match="requires a lookup value"):
        torch_indexing.SingleFieldIndexer("x", "id").get_row_group_indexes()


def test_legacy_only_index_raises(dataset, tmp_path):
    path = str(tmp_path / "ds")
    shutil.copytree(dataset, path)
    info = torch_metadata.open_dataset(path)
    torch_metadata.write_metadata_file(info.filesystem, info.root_path, info.arrow_schema,
                                       {torch_metadata.LEGACY_INDEX_KEY: b"\x80\x04legacy"})
    assert torch_metadata.LEGACY_INDEX_KEY == b"dataset-toolkit.rowgroups_index.v1"
    with pytest.raises(MetadataError, match="queue A item 11"):
        torch_indexing.get_row_group_indexes(torch_metadata.open_dataset(path))
    # an index of this package beside the legacy one is read
    torch_indexing.build_rowgroup_index(path, _indexers(torch_indexing)[:1])
    assert sorted(_loaded("port", path)) == ["bucket_ix"]


def test_no_index_gives_empty(dataset):
    assert _loaded("port", dataset) == {} == _loaded("jax", dataset)
