"""The port's determinism matrix against the JAX package's, on the CPU.

``test_util.matrix.run_cell`` over the port's reader, pools and service:
each cell's certificates (the reader's stream digest, per epoch and
combined, and the harness's crc chain over the delivered column bytes, with
the batch boundaries) equal those of the JAX ``run_cell`` on the same
dataset, seed and baseline cell, exactly; so the port's cells are
bit-identical to each other.  The token family (``run_sequence_cell``)
gives the JAX packed-stream crc and mixture certificate.  ``run_cell(...,
loader=)`` certifies ``CudaDataLoader``'s delivery (on the CPU here), equal
across pools, chaos and the service transport.
"""

import numpy as np
import pytest

from petastorm_tpu.test_util import matrix as jax_matrix
from petastorm_tpu_torch.cuda.loader import CudaDataLoader
from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.etl.writer import write_dataset
from petastorm_tpu_torch.schema import Field, Schema
from petastorm_tpu_torch.test_util.matrix import (CellResult, MatrixCell, cell_kwargs,
                                                  content_crc, ha_fleet,
                                                  recoverable_fleet, run_cell,
                                                  run_sequence_cell, service_fleet)
from petastorm_tpu_torch.test_util.netchaos import NetChaosSpec
from petastorm_tpu_torch.test_util.synthetic import write_token_corpus

SEED = 7
EPOCHS = 2


@pytest.fixture(scope="module")
def matrix_dataset(tmp_path_factory):
    """The JAX matrix's dataset: 200 int rows in 20 rowgroups."""
    url = str(tmp_path_factory.mktemp("torch_matrix") / "ds")
    write_dataset(url, Schema("DetMatrix", [Field("x", np.int64)]),
                  [{"x": i} for i in range(200)], row_group_size_rows=10)
    return url


@pytest.fixture(scope="module")
def jax_baseline(matrix_dataset):
    """The JAX package's reference stream: 2 thread workers, no chaos."""
    return jax_matrix.run_cell(matrix_dataset, SEED, jax_matrix.MatrixCell(workers=2),
                               num_epochs=EPOCHS)


def _assert_matches(result, base, label):
    assert isinstance(result, CellResult), label
    assert result.rows == base.rows == 2 * 200, label
    assert result.batch_rows == base.batch_rows, f"{label}: batch boundaries differ"
    assert result.digest["combined"] == base.digest["combined"], label
    assert result.digest["epochs"] == base.digest["epochs"], label
    assert result.content_crc == base.content_crc, f"{label}: delivered bytes differ"


LOCAL_CELLS = [
    MatrixCell(workers=2, pool="thread"),
    MatrixCell(workers=1, pool="thread"),
    MatrixCell(workers=4, pool="thread"),
    MatrixCell(workers=2, pool="serial"),
    MatrixCell(workers=3, pool="thread", chaos="kill"),
    MatrixCell(workers=3, pool="thread", chaos="hang"),
    MatrixCell(workers=3, pool="thread", chaos="hedge"),
    MatrixCell(workers=2, pool="thread", resize=True),
    MatrixCell(workers=4, pool="thread", chaos="kill", resize=True),
    MatrixCell(workers=2, pool="thread", split="quiesce"),
    MatrixCell(workers=3, pool="thread", chaos="kill", split="quiesce"),
]


@pytest.mark.parametrize("cell", LOCAL_CELLS, ids=lambda c: c.label())
def test_local_cells_give_the_jax_matrixs_stream(matrix_dataset, jax_baseline, cell):
    _assert_matches(run_cell(matrix_dataset, SEED, cell, num_epochs=EPOCHS), jax_baseline,
                    cell.label())


@pytest.mark.parametrize("cell", [MatrixCell(workers=2, pool="process"),
                                  MatrixCell(workers=3, pool="process", chaos="kill")],
                         ids=lambda c: c.label())
def test_process_cells_give_the_jax_matrixs_stream(matrix_dataset, jax_baseline, cell):
    _assert_matches(run_cell(matrix_dataset, SEED, cell, num_epochs=EPOCHS), jax_baseline,
                    cell.label())


def test_service_cells_give_the_jax_matrixs_stream(matrix_dataset, jax_baseline):
    with service_fleet(n_workers=2) as (_disp, addr, workers):
        assert len(workers) == 2
        for split in ("none", "quiesce"):
            cell = MatrixCell(transport="service", split=split)
            _assert_matches(run_cell(matrix_dataset, SEED, cell, num_epochs=EPOCHS,
                                     service_address=addr), jax_baseline, cell.label())


def test_the_dispatcher_restart_cell_gives_the_jax_matrixs_stream(matrix_dataset,
                                                                    jax_baseline):
    cell = MatrixCell(transport="service", disruption="dispatcher-restart")
    with recoverable_fleet(n_workers=2, worker_reconnect_backoff_s=0.1) as fleet:
        result = run_cell(matrix_dataset, SEED, cell, num_epochs=EPOCHS,
                          service_address=fleet.address,
                          disruptor=lambda: fleet.restart_dispatcher(downtime_s=0.2))
        _assert_matches(result, jax_baseline, cell.label())
        assert fleet.restarts == 1


@pytest.mark.parametrize("kind", ["netchaos", "netsplit"])
def test_the_network_chaos_cells_give_the_jax_matrixs_stream(matrix_dataset, jax_baseline,
                                                             kind):
    if kind == "netchaos":
        spec, cell = (NetChaosSpec(seed=3, dup_rate=0.1, delay_rate=0.1, delay_s=0.005),
                      MatrixCell(transport="service", disruption="netchaos"))
    else:
        spec, cell = NetChaosSpec(), MatrixCell(transport="service", disruption="netsplit")
    with recoverable_fleet(n_workers=2, net_spec=spec) as fleet:
        result = run_cell(matrix_dataset, SEED, cell, num_epochs=EPOCHS,
                          service_address=fleet.address,
                          disruptor=(lambda: fleet.netsplit(duration_s=0.4))
                          if kind == "netsplit" else (lambda: None))
        _assert_matches(result, jax_baseline, cell.label())
        assert fleet.proxy.stats["connections"] >= 1


def test_the_elastic_fleet_cell_gives_the_jax_matrixs_stream(matrix_dataset, jax_baseline):
    cell = MatrixCell(transport="service", disruption="elastic-fleet")
    with recoverable_fleet(n_workers=2) as fleet:
        result = run_cell(matrix_dataset, SEED, cell, num_epochs=EPOCHS,
                          service_address=fleet.address, disruptor=fleet.elastic_event)
        _assert_matches(result, jax_baseline, cell.label())
        dc = fleet.dispatcher.stats()["counters"]
        assert dc.get("service.requeued_items", 0) == 0, dc
        assert len(fleet.dispatcher.stats()["workers"]) == 2


def test_the_failover_cell_gives_the_jax_matrixs_stream(matrix_dataset, jax_baseline):
    cell = MatrixCell(transport="service", disruption="failover")
    with ha_fleet(n_workers=2) as fleet:
        result = run_cell(matrix_dataset, SEED, cell, num_epochs=EPOCHS,
                          service_address=fleet.address, disruptor=fleet.failover)
        _assert_matches(result, jax_baseline, cell.label())
        assert fleet.dispatcher is fleet.standby
        assert fleet.dispatcher.stats()["counters"].get("service.failovers", 0) == 1


@pytest.mark.parametrize("bad", [dict(chaos="boom"), dict(transport="carrier"),
                                 dict(split="halves"), dict(disruption="quake"),
                                 dict(disruption="netsplit")])
def test_cell_validation_as_in_the_jax_matrix(bad):
    outs = []
    for cls in (MatrixCell, jax_matrix.MatrixCell):
        with pytest.raises(Exception) as err:
            cls(**bad)
        outs.append(str(err.value))
    assert outs[0] == outs[1]
    with pytest.raises(PetastormTpuError):
        MatrixCell(**bad)


@pytest.mark.parametrize("cell", LOCAL_CELLS[:1] + LOCAL_CELLS[4:7],
                         ids=lambda c: c.label())
def test_cell_labels_and_kwargs_equal_the_jax_matrixs(cell):
    jax_cell = jax_matrix.MatrixCell(**{f: getattr(cell, f) for f in (
        "workers", "pool", "chaos", "resize", "transport", "split", "disruption")})
    assert cell.label() == jax_cell.label()
    port, jax = cell_kwargs(cell), jax_matrix.cell_kwargs(jax_cell)
    assert sorted(port) == sorted(jax)
    if "chaos" in port:
        assert vars(port["chaos"]) == vars(jax["chaos"])


def test_content_crc_equals_the_jax_one():
    cols = {"x": np.arange(7, dtype=np.int64), "s": np.asarray(["a", b"b", None], object),
            "o": np.asarray([np.zeros((2, 2), np.float32), np.ones(3)], object)}
    assert content_crc(11, cols) == jax_matrix._crc_batch(11, cols)


# -- the token family --------------------------------------------------------------------

@pytest.fixture(scope="module")
def token_corpora(tmp_path_factory):
    base = tmp_path_factory.mktemp("torch_tokens")
    urls = []
    for i in range(2):
        url = str(base / f"c{i}")
        write_token_corpus(url, n_docs=80, rows_per_rg=10, mean_len=24, max_len=100,
                           seed=40 + i)
        urls.append(url)
    return urls


@pytest.fixture(scope="module")
def jax_token_baseline(token_corpora):
    return jax_matrix.run_sequence_cell(token_corpora, SEED, jax_matrix.MatrixCell(workers=2),
                                        num_epochs=EPOCHS)


@pytest.mark.parametrize("cell", [MatrixCell(workers=2), MatrixCell(workers=1),
                                  MatrixCell(workers=2, pool="serial"),
                                  MatrixCell(workers=3, chaos="kill")],
                         ids=lambda c: c.label())
def test_token_cells_give_the_jax_packed_stream(token_corpora, jax_token_baseline, cell):
    result = run_sequence_cell(token_corpora, SEED, cell, num_epochs=EPOCHS)
    base = jax_token_baseline
    assert (result.tokens, result.rows) == (base.tokens, base.rows)
    assert result.packed_crc == base.packed_crc
    assert result.mixture == base.mixture
    assert result.fill_rate == base.fill_rate


def test_token_cells_refuse_a_split(token_corpora):
    with pytest.raises(PetastormTpuError, match="quiesce"):
        run_sequence_cell(token_corpora, SEED, MatrixCell(split="quiesce"))


# -- loader cells ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def image_dataset(tmp_path_factory):
    from petastorm_tpu_torch import CompressedImageCodec

    url = str(tmp_path_factory.mktemp("torch_matrix_img") / "ds")
    yy, xx = np.mgrid[0:16, 0:16]
    write_dataset(url, Schema("MatrixImages", [
        Field("label", np.int64),
        Field("image", np.uint8, (16, 16, 3), CompressedImageCodec("jpeg", quality=90))]),
        [{"label": i, "image": np.stack([(yy * 5 + i) % 256, (xx * 7) % 256,
                                         (yy + xx + 3 * i) % 256], -1).astype(np.uint8)}
         for i in range(96)], row_group_size_rows=8)
    return url


def _loader_cell(url, cell, **kwargs):
    return run_cell(url, SEED, cell, num_epochs=1,
                    reader_kwargs={"decode_placement": {"image": "device"}},
                    loader=lambda r: CudaDataLoader(r, batch_size=16, device="cpu"), **kwargs)


def test_loader_cells_are_bit_identical_across_pools_chaos_and_the_service(image_dataset):
    base = _loader_cell(image_dataset, MatrixCell(workers=2))
    assert base.rows == 96 and base.batch_rows == (16,) * 6
    cells = [MatrixCell(workers=1), MatrixCell(workers=3, chaos="kill"),
             MatrixCell(workers=2, pool="serial")]
    results = [_loader_cell(image_dataset, cell) for cell in cells]
    with service_fleet(n_workers=2) as (_disp, addr, _workers):
        results.append(_loader_cell(image_dataset, MatrixCell(transport="service"),
                                    service_address=addr))
    for cell, result in zip(cells + [MatrixCell(transport="service")], results):
        assert result.content_crc == base.content_crc, cell.label()
        assert result.digest["combined"] == base.digest["combined"], cell.label()
        assert result.batch_rows == base.batch_rows, cell.label()


def test_a_loader_cell_refuses_a_split(image_dataset):
    with pytest.raises(PetastormTpuError, match="split"):
        _loader_cell(image_dataset, MatrixCell(split="quiesce"))
