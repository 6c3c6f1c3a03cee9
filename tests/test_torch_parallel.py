"""Multi-process delivery and writing in the port against the JAX package.

* ``CudaDataLoader(mesh=, shardings=)``: every rank's block equals the JAX
  loader's global array at that rank's mesh coordinate, exactly, for (1, 2),
  (2, 1), (2, 2) and (1, 4) meshes (each coordinate in this process through a
  stand-in mesh, which is all the loader reads of a DeviceMesh; the (2, 2)
  mesh also over 4 gloo processes with a real ``DeviceMesh``), stacked and
  with the zero-padded tail too;
* ``make_cuda_loader``: the reader and loader kwargs split as
  ``make_jax_loader`` splits them, and the reader sharded by the rank's block
  of the batch axis, where the JAX function shards by process whatever the
  mesh (a defect of the reference, pinned here by host arithmetic);
* the unequal drain through the default collective over 2 gloo processes;
* ``distributed_write_dataset`` with a ``threading.Barrier`` sync: the same
  rows, metadata and refusals as the JAX function with the same arguments;
* the port's selfcheck: its three checks at 2 processes.

Multi-process cases run subprocesses with a timeout of their own; a failed
worker fails the test.
"""

import inspect
import os
import sys
import threading
import time

import jax
import numpy as np
import pyarrow.parquet as pq
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from petastorm_tpu.jax import loader as jax_loader_mod
from petastorm_tpu.jax.loader import JaxDataLoader, make_jax_loader
from petastorm_tpu.parallel.write import distributed_write_dataset as jax_distributed_write
from petastorm_tpu.reader import make_reader as jax_make_reader
from petastorm_tpu_torch import converter as torch_converter
from petastorm_tpu_torch.codecs import CompressedImageCodec
from petastorm_tpu_torch.cuda.loader import VALID_ROWS, CudaDataLoader, make_cuda_loader
from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.etl.writer import write_dataset
from petastorm_tpu_torch.parallel import launch as launch_mod
from petastorm_tpu_torch.parallel import mesh as pmesh
from petastorm_tpu_torch.parallel import selfcheck
from petastorm_tpu_torch.parallel.write import distributed_write_dataset
from petastorm_tpu_torch.reader import make_batch_reader, make_reader
from petastorm_tpu_torch.schema import Field, Schema
from torch_dist_worker import launch

GB, SEQ, ROWS, GROUP = 8, 16, 32, 4
MESHES = [(1, 2), (2, 1), (2, 2), (1, 4)]


class StubMesh:
    """What the loader and ``make_cuda_loader`` read of a DeviceMesh: its
    shape, dimension names and this rank's coordinate."""

    def __init__(self, shape, coord):
        self.shape, self._coord = tuple(shape), tuple(coord)
        self.mesh_dim_names = ("data", "seq")
        self.mesh = torch.arange(int(np.prod(shape))).reshape(shape)

    def get_coordinate(self):
        return list(self._coord)


@pytest.fixture(scope="module")
def tokens_url(tmp_path_factory):
    """32 rows of an id and 16 tokens, in rowgroups of 4 (a rank's rows)."""
    url = str(tmp_path_factory.mktemp("cp") / "tokens")
    write_dataset(url, Schema("Tok", [Field("id", np.int64), Field("tokens", np.int32, (SEQ,))]),
                  [{"id": np.int64(i), "tokens": (np.arange(SEQ) + 100 * i).astype(np.int32)}
                   for i in range(ROWS)], row_group_size_rows=GROUP)
    return url


def _jax_batches(url, shape, rows=ROWS, **loader_kwargs):
    devs = np.asarray(jax.devices()[:shape[0] * shape[1]]).reshape(shape)
    mesh = Mesh(devs, ("data", "seq"))
    reader = jax_make_reader(url, shuffle_row_groups=False, workers_count=1, num_epochs=1)
    with JaxDataLoader(reader, batch_size=GB, mesh=mesh, keep_wide_dtypes=True,
                       shardings={"tokens": P("data", "seq"), "id": P("data")},
                       **loader_kwargs) as loader:
        return [{k: (np.asarray(v) if isinstance(v, jax.Array) else v) for k, v in b.items()}
                for b in loader]


def _port_batches(url, mesh, **loader_kwargs):
    with make_cuda_loader(url, GB, mesh=mesh, shardings={"tokens": (Shard(0), Shard(1))},
                          reader_factory=make_reader, device="cpu", fields=["tokens", "id"],
                          shuffle_row_groups=False, workers_count=1, num_epochs=1,
                          **loader_kwargs) as loader:
        return list(loader)


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_every_rank_block_equals_the_jax_global_array(tokens_url, shape):
    jax_batches = _jax_batches(tokens_url, shape)
    assert len(jax_batches) == ROWS // GB
    for coord in np.ndindex(*shape):
        sl = pmesh.shard_slices(shape, coord, (Shard(0), Shard(1)), (GB, SEQ))
        got = _port_batches(tokens_url, StubMesh(shape, coord))
        assert len(got) == len(jax_batches)
        for b, want in zip(got, jax_batches):
            assert b["tokens"].dtype == torch.int32
            assert np.array_equal(b["tokens"].numpy(), want["tokens"][sl]), coord
            assert np.array_equal(b["id"].numpy(), want["id"][sl[0]]), coord


@pytest.mark.parametrize("shape,rows,drop_last", [((2, 2), 32, True), ((1, 4), 28, False)],
                         ids=["(2, 2)", "(1, 4) padded"])
def test_stacked_and_padded_blocks_equal_the_jax_global_array(tmp_path, shape, rows, drop_last):
    """``stack_batches=2`` prepends an unsharded axis; with ``drop_last=False``
    (28 rows: the last global batch holds 4 of 8 rows, on a mesh that does
    not shard the rows, so every rank reads all of them) the tail is
    zero-padded and the valid mask shards like the batch axis."""
    url = str(tmp_path / "tok")
    write_dataset(url, Schema("Tok", [Field("id", np.int64), Field("tokens", np.int32, (SEQ,))]),
                  [{"id": np.int64(i), "tokens": (np.arange(SEQ) + 100 * i).astype(np.int32)}
                   for i in range(rows)], row_group_size_rows=GROUP)
    for stack in (1, 2):
        want = _jax_batches(url, shape, drop_last=drop_last, valid_mask_field="mask",
                            stack_batches=stack)
        lead = (slice(None),) if stack > 1 else ()
        for coord in np.ndindex(*shape):
            sl = pmesh.shard_slices(shape, coord, (Shard(0), Shard(1)), (GB, SEQ))
            got = _port_batches(url, StubMesh(shape, coord), drop_last=drop_last,
                                valid_mask_field="mask", stack_batches=stack)
            assert len(got) == len(want)
            for b, w in zip(got, want):
                assert np.array_equal(b["tokens"].numpy(), w["tokens"][lead + sl])
                assert np.array_equal(b["id"].numpy(), w["id"][lead + sl[:1]])
                assert np.array_equal(b["mask"].numpy(), w["mask"][lead + sl[:1]])
                assert (VALID_ROWS in b) == ("_valid_rows" in w)
                if VALID_ROWS in b:
                    assert np.array_equal(np.asarray(b[VALID_ROWS]), np.asarray(w["_valid_rows"]))
        if not drop_last:
            assert "_valid_rows" in want[-1]


def test_the_real_device_mesh_over_four_gloo_ranks(tokens_url, tmp_path):
    """The same blocks from a real (2, 2) DeviceMesh in 4 processes."""
    launch("loader", 4, {"url": tokens_url, "mesh": [2, 2], "global_batch": GB,
                         "seq_len": SEQ, "out": str(tmp_path)}, timeout=120)
    want = _jax_batches(tokens_url, (2, 2))
    for rank in range(4):
        got = np.load(tmp_path / f"rank{rank}.npz")
        coord = tuple(got["coord"])
        assert coord == divmod(rank, 2)
        sl = pmesh.shard_slices((2, 2), coord, (Shard(0), Shard(1)), (GB, SEQ))
        assert [list(s) for s in got["slice"]] == [[s.start, s.stop] for s in sl]
        assert tuple(got["block"]) == (coord[0], 2)
        for k, w in enumerate(want):
            assert np.array_equal(got["tokens"][k], w["tokens"][sl])
            assert np.array_equal(got["ids"][k], w["id"][sl[0]])


def test_loader_refuses_meshes_it_cannot_deliver(tokens_url):
    reader = make_reader(tokens_url, workers_count=1, num_epochs=1)
    try:
        with pytest.raises(PetastormTpuError, match="divide evenly"):
            CudaDataLoader(reader, 6, device="cpu", mesh=StubMesh((4, 1), (0, 0)))
        with pytest.raises(PetastormTpuError, match="shard the batch axis identically"):
            CudaDataLoader(reader, 8, device="cpu", mesh=StubMesh((2, 2), (0, 0)),
                           shardings={"tokens": (Shard(0), Shard(1)),
                                      "id": (Replicate(), Replicate())})
        with pytest.raises(PetastormTpuError, match="one placement per mesh dimension"):
            CudaDataLoader(reader, 8, device="cpu", mesh=StubMesh((2, 2), (0, 0)),
                           shardings=(Shard(0),))
    finally:
        reader.stop()
        reader.join()


# -- make_cuda_loader -------------------------------------------------------------------

class _Captured(Exception):
    pass


def _capture(sink):
    def factory(url, **kwargs):
        sink.update(kwargs)
        raise _Captured
    return factory


def test_make_jax_loader_shards_by_process_whatever_the_mesh(monkeypatch):
    """The reference's defect, by host arithmetic: on a (1, 2) mesh over two
    processes both processes hold every row of the batch (each device's
    block of ``P("data", "seq")`` spans rows [0, B)), yet ``make_jax_loader``
    gives them the reader shards 0 and 1 of 2 (``jax/loader.py:1923-1926``):
    the two halves of each global row would come from different rows."""
    devs = np.asarray(jax.devices()[:2]).reshape(1, 2)
    mesh = Mesh(devs, ("data", "seq"))
    indices = jax.sharding.NamedSharding(mesh, P("data", "seq")).devices_indices_map((GB, SEQ))
    assert {(s[0].start or 0, s[0].stop or GB) for s in indices.values()} == {(0, GB)}
    shards = []
    for pid in range(2):
        monkeypatch.setattr(jax, "process_index", lambda pid=pid: pid)
        monkeypatch.setattr(jax, "process_count", lambda: 2)
        seen = {}
        with pytest.raises(_Captured):
            make_jax_loader("unused", GB, mesh=mesh, shardings={"tokens": P("data", "seq")},
                            reader_factory=_capture(seen))
        shards.append((seen["cur_shard"], seen["shard_count"]))
    assert shards == [(0, 2), (1, 2)]
    # the port: both ranks of the seq ring read the same (unsharded) rows
    for coord in ((0, 0), (0, 1)):
        seen = {}
        with pytest.raises(_Captured):
            make_cuda_loader("unused", GB, mesh=StubMesh((1, 2), coord),
                             shardings={"tokens": (Shard(0), Shard(1))},
                             reader_factory=_capture(seen))
        assert "cur_shard" not in seen
    for coord in np.ndindex(2, 2):
        seen = {}
        with pytest.raises(_Captured):
            make_cuda_loader("unused", GB, mesh=StubMesh((2, 2), coord),
                             shardings={"tokens": (Shard(0), Shard(1))},
                             reader_factory=_capture(seen))
        assert (seen["cur_shard"], seen["shard_count"]) == (coord[0], 2)


def test_make_cuda_loader_splits_kwargs_like_make_jax_loader():
    jax_params = set(inspect.signature(JaxDataLoader.__init__).parameters)
    port_params = set(inspect.signature(CudaDataLoader.__init__).parameters)
    # every JAX loader knob, trace_dir, transfer_commit and telemetry included
    assert jax_params - port_params == set()
    assert port_params - jax_params == {"device"}
    kwargs = dict(fields=["tokens"], host_fields=["id"], shuffling_queue_capacity=16,
                  pad_shapes={"tokens": (SEQ,)}, drop_last=False, predicate=None,
                  num_epochs=2, shuffle_seed=3, workers_count=1)
    seen_jax, seen_port = {}, {}
    with pytest.raises(_Captured):
        make_jax_loader("unused", GB, reader_factory=_capture(seen_jax), **dict(kwargs))
    with pytest.raises(_Captured):
        make_cuda_loader("unused", GB, reader_factory=_capture(seen_port), **dict(kwargs))
    assert seen_port == seen_jax == {"predicate": None, "num_epochs": 2, "shuffle_seed": 3,
                                     "workers_count": 1, "schema_fields": ["tokens", "id"]}
    assert set(inspect.signature(make_cuda_loader).parameters) == \
        set(inspect.signature(make_jax_loader).parameters)
    # a loader's recorder observes the reader too, in both packages
    recorder = object()
    seen_jax, seen_port = {}, {}
    with pytest.raises(_Captured):
        make_jax_loader("unused", GB, reader_factory=_capture(seen_jax), telemetry=recorder)
    with pytest.raises(_Captured):
        make_cuda_loader("unused", GB, reader_factory=_capture(seen_port), telemetry=recorder)
    assert seen_port["telemetry"] is seen_jax["telemetry"] is recorder


def test_make_cuda_loader_stops_the_reader_when_the_loader_fails(tokens_url):
    made = []

    def factory(url, **kwargs):
        made.append(make_reader(url, **kwargs))
        return made[-1]

    with pytest.raises(PetastormTpuError, match="Unknown fields"):
        make_cuda_loader(tokens_url, GB, reader_factory=factory, device="cpu",
                         fields=["nope"], schema_fields=None, workers_count=1)
    assert made and made[0]._stopped


def test_converter_loader_takes_a_mesh_as_the_jax_converter_does():
    from petastorm_tpu import converter as jax_converter

    jax_sig = inspect.signature(jax_converter.DatasetConverter.make_jax_loader).parameters
    port_sig = inspect.signature(torch_converter.DatasetConverter.make_cuda_loader).parameters
    assert {"mesh", "shardings"} <= set(jax_sig) & set(port_sig)


# -- the drain's default collective ------------------------------------------------------

def test_unequal_drain_through_the_default_collective(tmp_path):
    """Rank 0 reads 3 rowgroups of 4 rows, rank 1 two (5 rowgroups, a (2, 1)
    mesh, a global batch of 8): after one batch each, rank 0 drains 2 and
    rank 1 one real batch and one zero pad with ``'_valid_rows': 0`` and a
    zero mask, found by ``all_gather_into_tensor`` over the mesh's group."""
    url = str(tmp_path / "tok")
    write_dataset(url, Schema("Tok", [Field("id", np.int64), Field("tokens", np.int32, (SEQ,))]),
                  [{"id": np.int64(i), "tokens": np.full(SEQ, i, np.int32)} for i in range(20)],
                  row_group_size_rows=GROUP)
    launch("drain", 2, {"url": url, "global_batch": GB, "settle": 1.0, "out": str(tmp_path)},
           timeout=120)
    r0, r1 = (np.load(tmp_path / f"rank{r}.npz") for r in range(2))
    assert r0["first_ids"].tolist() == [0, 1, 2, 3] and r1["first_ids"].tolist() == [4, 5, 6, 7]
    assert len(r0["valid"]) == len(r1["valid"]) == 2
    assert r0["valid"].tolist() == [-1, -1] and r1["valid"].tolist() == [-1, 0]
    assert r0["ids"].tolist() == [[8, 9, 10, 11], [16, 17, 18, 19]]
    assert r1["ids"][0].tolist() == [12, 13, 14, 15] and r1["ids"][1].tolist() == [0] * 4
    assert r1["masks"][1].tolist() == [0.0] * 4 and r0["masks"].min() == 1.0
    assert r1["tokens_shape"].tolist() == [[4, SEQ]] * 2


# -- distributed_write_dataset ----------------------------------------------------------

def _write_rows(n=16):
    rng = np.random.default_rng(7)
    return [{"id": np.int32(i),
             "image": rng.integers(0, 255, ((16, 24) if i % 2 else (24, 16)) + (3,),
                                   dtype=np.uint8)} for i in range(n)]


def _run_hosts(fn, url, schema, rows, count=2, **kwargs):
    """``fn`` on ``count`` threads with a ``threading.Barrier`` sync; returns
    each host's result or exception."""
    barrier = threading.Barrier(count, timeout=60)
    results = [None] * count

    def host(i):
        try:
            results[i] = fn(url, schema, rows[i::count], process_index=i, process_count=count,
                            sync_fn=lambda tag: barrier.wait(), **kwargs)
        except BaseException as exc:  # noqa: BLE001 - compared by the test
            results[i] = exc

    threads = [threading.Thread(target=host, args=(i,)) for i in range(count)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(90)
    return results


def _schemas():
    from petastorm_tpu.codecs import CompressedImageCodec as JaxImageCodec
    from petastorm_tpu.schema import Field as JaxField, Schema as JaxSchema

    port = Schema("W", [Field("id", np.int32), Field("image", np.uint8, (None, None, 3),
                                                     CompressedImageCodec("png"))])
    ref = JaxSchema("W", [JaxField("id", np.int32), JaxField("image", np.uint8, (None, None, 3),
                                                             JaxImageCodec("png"))])
    return port, ref


def _read_back(url):
    with make_batch_reader(url, num_epochs=1, workers_count=1,
                           shuffle_row_groups=False) as reader:
        declared = reader.declared_geometries
        rows = {}
        for cb in reader.iter_batches():
            for i, img in zip(cb.columns["id"], cb.columns["image"]):
                rows[int(i)] = np.asarray(img).tobytes()
    return rows, {k: sorted(v) for k, v in declared.items()}


def test_distributed_write_matches_the_jax_function(tmp_path):
    port_schema, jax_schema = _schemas()
    rows = _write_rows()
    port_files = _run_hosts(distributed_write_dataset, str(tmp_path / "port"), port_schema,
                            rows, row_group_size_rows=4)
    jax_files = _run_hosts(jax_distributed_write, str(tmp_path / "jax"), jax_schema, rows,
                           row_group_size_rows=4)
    for got, want in zip(port_files, jax_files):
        assert not isinstance(got, BaseException) and not isinstance(want, BaseException)
        assert [os.path.basename(p).split("-")[:3] for p in got] == \
            [os.path.basename(p).split("-")[:3] for p in want]
    port_rows, port_geoms = _read_back(str(tmp_path / "port"))
    jax_rows, jax_geoms = _read_back(str(tmp_path / "jax"))
    assert port_rows == jax_rows and sorted(port_rows) == list(range(16))
    assert port_geoms == jax_geoms == {"image": [(16, 24, 3), (24, 16, 3)]}
    for url in (tmp_path / "port", tmp_path / "jax"):
        names = sorted(os.listdir(url))
        assert "_common_metadata" in names
        assert not [n for n in names if n.startswith(("_image_geometries",
                                                      "_distributed_write_failed"))]
    port_meta = pq.read_metadata(str(tmp_path / "port" / "_common_metadata")).metadata
    jax_meta = pq.read_metadata(str(tmp_path / "jax" / "_common_metadata")).metadata
    assert set(port_meta) == set(jax_meta)


def _same_refusal(got, want):
    assert type(got).__name__ == type(want).__name__, (got, want)
    assert str(got) == str(want)


@pytest.mark.parametrize("kwargs", [dict(mode="append"), dict(file_prefix="x"),
                                    dict(process_index=2, process_count=2)],
                         ids=["append", "owned", "index"])
def test_distributed_write_refuses_as_the_jax_function(tmp_path, kwargs):
    port_schema, jax_schema = _schemas()
    kwargs = {**dict(process_index=0, process_count=1, sync_fn=lambda tag: None), **kwargs}
    errors = []
    for fn, schema, url in ((distributed_write_dataset, port_schema, tmp_path / "p"),
                            (jax_distributed_write, jax_schema, tmp_path / "j")):
        with pytest.raises(ValueError) as info:
            fn(str(url), schema, _write_rows(2), **kwargs)
        errors.append(info.value)
    _same_refusal(*errors)


def test_distributed_write_preflight_and_failed_host_as_the_jax_function(tmp_path):
    port_schema, jax_schema = _schemas()
    rows = _write_rows()
    results = {}
    for name, fn, schema in (("port", distributed_write_dataset, port_schema),
                             ("jax", jax_distributed_write, jax_schema)):
        url = str(tmp_path / name)
        first = _run_hosts(fn, url, schema, rows, row_group_size_rows=4)
        assert not any(isinstance(r, BaseException) for r in first)
        # mode='error' on a dataset that holds data: host 0's preflight refuses
        # and every host raises
        again = _run_hosts(fn, url, schema, rows, row_group_size_rows=4)
        # a host whose rows cannot be encoded: no stamp, every host raises
        bad = list(rows)
        bad[1] = {"id": np.int32(1), "image": np.zeros((4, 4), np.uint8)}
        failed = _run_hosts(fn, str(tmp_path / f"{name}_bad"), schema, bad,
                            row_group_size_rows=4)
        results[name] = (again, failed, sorted(os.listdir(tmp_path / f"{name}_bad")))
    for (p_again, p_failed, p_names), (j_again, j_failed, j_names) in [
            (results["port"], results["jax"])]:
        for got, want in zip(p_again, j_again):
            assert type(got).__name__ == type(want).__name__ == "PetastormTpuError"
            assert str(got).replace(str(tmp_path / "port"), "URL") == \
                str(want).replace(str(tmp_path / "jax"), "URL")
        assert [isinstance(r, BaseException) for r in p_failed] == [True, True]
        assert [isinstance(r, BaseException) for r in j_failed] == [True, True]
        assert "_common_metadata" not in p_names and "_common_metadata" not in j_names
        assert [n for n in p_names if n.startswith("_distributed")] == \
            [n for n in j_names if n.startswith("_distributed")] == ["_distributed_write_failed.1"]


# -- the selfcheck -------------------------------------------------------------------------

def _assert_ok(report):
    assert report["ok"], report["failures"]


def test_selfcheck_pipeline_drain_and_elastic_resume(tmp_path):
    report = selfcheck.run_selfcheck(num_processes=2, n_batches=12, settle=1.0, timeout=120,
                                     workdir=str(tmp_path), device="cpu")
    _assert_ok(report)
    assert report["consumed_rows"] + report["resumed_rows"] == 12 * 8


def test_selfcheck_distributed_write(tmp_path):
    report = selfcheck.run_distributed_write_check(num_processes=2, timeout=120,
                                                   workdir=str(tmp_path), device="cpu")
    _assert_ok(report)
    assert report["rows_read"] == 64


def test_selfcheck_context_parallel(tmp_path):
    report = selfcheck.run_context_parallel_check(num_processes=2, timeout=120,
                                                  workdir=str(tmp_path), device="cpu")
    _assert_ok(report)
    assert report["err_ring"] < 2e-4 and report["err_uly"] < 2e-4
    assert report["transport"] == "gloo"


def test_selfcheck_runs_on_the_card_unless_asked(monkeypatch, tmp_path):
    """Every check defaults to device='cuda' and refuses to fall back to the
    host when no card is present."""
    for fn in (selfcheck.run_selfcheck, selfcheck.run_distributed_write_check,
               selfcheck.run_context_parallel_check):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (selfcheck.run_selfcheck, selfcheck.run_distributed_write_check,
               selfcheck.run_context_parallel_check):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            fn(num_processes=2, workdir=str(tmp_path))
    assert os.listdir(tmp_path) == []  # refused before any worker or dataset


@pytest.mark.parametrize("cards,ranks,want", [(4, 2, "nccl"), (2, 2, "nccl"), (1, 2, "gloo"),
                                              (2, 3, "gloo")])
def test_selfcheck_backend_follows_the_cards(monkeypatch, cards, ranks, want):
    """NCCL when every rank has a card of its own, gloo when ranks share one
    (as the long-context trainer chooses); the host always takes gloo."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert selfcheck._backend("cuda", ranks, None) == want
    assert selfcheck._backend("cuda", ranks, "gloo") == "gloo"
    assert selfcheck._backend("cpu", ranks, None) == "gloo"
    with pytest.raises(ValueError, match="device"):
        selfcheck._backend("tpu", ranks, None)


def _rank_script(tmp_path, body):
    script = tmp_path / "rank.py"
    script.write_text("import os, sys, time\nrank = int(os.environ['RANK'])\n" + body)
    return [sys.executable, str(script)]


def test_run_ranks_gives_each_rank_torchruns_variables(tmp_path):
    cmd = _rank_script(tmp_path, "print(rank, os.environ['WORLD_SIZE'], os.environ['LOCAL_RANK'],"
                                 " os.environ['MASTER_PORT'], os.environ['EXTRA'])\n")
    assert launch_mod.run_ranks(cmd, 3, 30, str(tmp_path / "ok"), env={"EXTRA": "x"}) is None
    lines = [open(launch_mod.log_path(str(tmp_path / "ok"), r)).read().split()
             for r in range(3)]
    assert [line[:3] for line in lines] == [[str(r), "3", str(r)] for r in range(3)]
    assert len({line[3] for line in lines}) == 1 and {line[4] for line in lines} == {"x"}


def test_run_ranks_fails_on_a_failed_or_late_rank(tmp_path):
    """A rank that exits non-zero fails the job at once (the others, blocked,
    are killed); a rank past the deadline fails it too."""
    cmd = _rank_script(tmp_path, "if rank == 1:\n    print('boom'); sys.exit(3)\n"
                                 "time.sleep(60)\n")
    t0 = time.monotonic()
    error = launch_mod.run_ranks(cmd, 2, 30, str(tmp_path / "fail"))
    assert time.monotonic() - t0 < 20
    assert "rank 1 exited with code 3" in error and "boom" in error
    cmd = _rank_script(tmp_path, "time.sleep(60)\n")
    error = launch_mod.run_ranks(cmd, 2, 1.0, str(tmp_path / "late"))
    assert "timed out after 1 s" in error


def test_jax_loader_module_still_shards_by_process_index():
    """The line the port departs from (``jax/loader.py:1923-1926``)."""
    src = inspect.getsource(jax_loader_mod.make_jax_loader)
    assert "jax.process_index(), jax.process_count()" in src


# -- the selfcheck's shuffled, mixed-decode and 2-D mesh checks ----------------------------

def test_selfcheck_shuffled_stacked_delivery_and_drain(tmp_path):
    report = selfcheck.run_shuffled_check(num_processes=2, timeout=120,
                                          workdir=str(tmp_path), device="cpu")
    _assert_ok(report)
    assert report["rho_global"] <= 0.5 and report["devices"] == ["cpu"]


def test_selfcheck_shuffled_over_four_ranks(tmp_path):
    """The JAX check's four processes, a rank each."""
    report = selfcheck.run_shuffled_check(num_processes=4, timeout=180,
                                          workdir=str(tmp_path), device="cpu")
    _assert_ok(report)


def test_selfcheck_mixed_decode(tmp_path):
    report = selfcheck.run_mixed_check(num_processes=2, timeout=120, workdir=str(tmp_path),
                                       device="cpu")
    _assert_ok(report)
    assert report["max_pixel_err"] <= 6 and report["mean_pixel_err"] < 1.0
    assert all(g == {"image": 2} for g in report["geometries_per_rank"])


def test_selfcheck_mesh2d(tmp_path):
    report = selfcheck.run_mesh2d_check(num_processes=2, devices_per_process=2, timeout=120,
                                        workdir=str(tmp_path), device="cpu")
    _assert_ok(report)
    assert report["mesh"] == {"data": 2, "model": 2} and report["rel_err"] < 1e-5


def test_the_new_selfcheck_checks_run_on_the_card_unless_asked(monkeypatch, tmp_path):
    fns = (selfcheck.run_shuffled_check, selfcheck.run_mixed_check,
           selfcheck.run_mesh2d_check)
    for fn in fns:
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in fns:
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            fn(num_processes=2, workdir=str(tmp_path))
    assert os.listdir(tmp_path) == []


# -- the packed token loader over a mesh ---------------------------------------------------

def _jax_packed_rows(urls, seq_len, seed, shard, count, weights=None):
    """The JAX PackedSequenceReader's rows over one shard, in one process."""
    from petastorm_tpu.sequence.dataset import make_sequence_reader as jax_sequence_reader
    from petastorm_tpu.sequence.loader import PackedSequenceReader as JaxPacked
    from petastorm_tpu.sequence.mixing import make_mixed_sequence_reader as jax_mixed

    kwargs = dict(cur_shard=shard, shard_count=count, workers_count=1)
    source = (jax_sequence_reader(urls[0], shuffle_seed=seed, **kwargs) if len(urls) == 1
              else jax_mixed(urls, weights=weights, seed=seed, **kwargs))
    out = {}
    with JaxPacked(source, seq_len, rows_per_batch=4) as packed:
        for block in packed.iter_batches():
            for k, v in block.columns.items():
                out.setdefault(k, []).append(np.asarray(v))
    return {k: np.concatenate(v) for k, v in out.items()}


@pytest.mark.parametrize("mesh,corpora", [((2, 1), 1), ((2, 1), 2), ((1, 2), 1)],
                         ids=["data2", "data2-mixed", "seq2"])
def test_packed_loader_blocks_equal_the_jax_packing_of_each_shard(tmp_path, mesh, corpora):
    """Each rank's delivered block of every batch is, in order, the JAX
    PackedSequenceReader's rows over the shard of its batch-axis block (ranks
    of one ``seq`` ring read and pack the same rows)."""
    from petastorm_tpu_torch.test_util.synthetic import write_token_corpus

    urls = []
    for c in range(corpora):
        url = str(tmp_path / f"corpus{c}")
        write_token_corpus(url, n_docs=96, rows_per_rg=8, vocab=500, mean_len=12.0,
                           max_len=40, seed=c)
        urls.append(url)
    weights = [0.7, 0.3] if corpora > 1 else None
    global_batch, seq_len, seed = 4, 16, 3
    launch("packed", 2, {"out": str(tmp_path), "urls": urls, "mesh": list(mesh),
                         "global_batch": global_batch, "seq_len": seq_len, "seed": seed,
                         "weights": weights}, timeout=120)
    data_par = mesh[0]
    local = global_batch // data_par
    for rank in range(2):
        got = dict(np.load(tmp_path / f"rank{rank}.npz"))
        block = rank // mesh[1]
        want = _jax_packed_rows(urls, seq_len, seed, block, data_par, weights)
        n = got["tokens"].shape[0]
        assert n > 0 and n % local == 0
        for field in ("tokens", "segment_ids", "positions", "loss_mask"):
            np.testing.assert_array_equal(got[field], want[field][:n], err_msg=field)
