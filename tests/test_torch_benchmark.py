"""The port's throughput harness (``petastorm_tpu_torch/benchmark/``) against
the JAX package's (``petastorm_tpu/benchmark/``), on the CPU.

* ``reader_throughput``: the same ``samples`` and ``to_json()`` keys, row and
  batch; telemetered on the serial pool without shuffling, the same
  ``stage.*`` counter names and an equal ``stage.decode.count``;
* ``cuda_loader_throughput(device="cpu")`` against ``jax_loader_throughput``:
  the same ``samples``, with host decode and with ``device_decode_fields``
  (B2's plain version against the JAX decode);
* the CLI: every JAX option with the same dest, default and type (only
  ``--method``'s choices and ``--device`` differ), the JAX harness's CLI
  tests ported, ``--isolated --device cpu`` in a child without jax;
* ``loader_microbench`` for its three kinds; ``scaling``'s dataset read back
  by the JAX reader, and ``measure`` equal to the JAX one on both pools;
* ``ops_microbench`` at a small shape: the JAX tool's metric names and keys
  (renamed), its normalize within 2 float32 ulp plus 1 bfloat16 ulp of the
  JAX normalize and its hybrid decode within 1 LSB of the JAX decode.

The ``cuda`` cases run ``ops_microbench`` on the card and skip here.
"""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp

    from petastorm_tpu.benchmark import cli as jax_cli
    from petastorm_tpu.benchmark import dummy_reader as jax_dummy
    from petastorm_tpu.benchmark import scaling as jax_scaling
    from petastorm_tpu.benchmark import throughput as jax_throughput
    from petastorm_tpu.native import image as jax_native
    from petastorm_tpu.ops import jpeg as jax_jpeg
    from petastorm_tpu.ops import normalize as jax_normalize
    from petastorm_tpu.reader import make_batch_reader as jax_make_batch_reader
    from petastorm_tpu.telemetry import Telemetry as JaxTelemetry
    from test_torch_cuda_kernels import assert_within_ulp
except ImportError:  # the card has no jax: only the cuda cases run there
    jnp = None

from petastorm_tpu_torch.benchmark import cli, dummy_reader, ops_microbench, scaling, throughput
from petastorm_tpu_torch.codecs import NdarrayCodec
from petastorm_tpu_torch.etl.writer import write_dataset
from petastorm_tpu_torch.ops import normalize
from petastorm_tpu_torch.schema import Field, Schema
from petastorm_tpu_torch.telemetry import Telemetry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
needs_jax = pytest.mark.skipif(jnp is None, reason="the JAX reference is not installed")

SMALL_SCHEMA = Schema("Small", [
    Field("id", np.int64),
    Field("value", np.float32, (3,), NdarrayCodec()),
    Field("opt", np.float64, nullable=True),
])
JPEG_ROWS, JPEG_SIDE = 64, 32
#: a small (N, H, W, C) for ops_microbench: crops of 36x36 images, 2 JPEGs
SMALL_SHAPE = (8, 32, 32, 3)


def _small_rows(n):
    rng = np.random.default_rng(7)
    return [{"id": i, "value": rng.standard_normal(3).astype(np.float32),
             "opt": None if i % 3 == 0 else float(i)} for i in range(n)]


@pytest.fixture(scope="module")
def small_ds(tmp_path_factory):
    url = str(tmp_path_factory.mktemp("bench") / "small")
    rows = _small_rows(30)
    write_dataset(url, SMALL_SCHEMA, rows, row_group_size_rows=5)
    return url, rows


@pytest.fixture(scope="module")
def jpeg_ds(tmp_path_factory):
    """``scaling.build_dataset``'s JPEG dataset: 64 rows of 32x32, 16 rowgroups."""
    url = str(tmp_path_factory.mktemp("bench") / "jpeg")
    scaling.build_dataset(url, JPEG_ROWS, JPEG_SIDE, JPEG_SIDE)
    return url


# -- the JAX harness's own tests, ported (tests/test_cli_tools.py:49-90) -------------------

def test_reader_throughput_row(small_ds):
    url, _ = small_ds
    res = throughput.reader_throughput(url, warmup_cycles=5, measure_cycles=20,
                                       workers_count=2)
    assert res.samples == 20
    assert res.samples_per_sec > 0
    assert res.rss_mb > 0


def test_reader_throughput_batch(small_ds):
    url, _ = small_ds
    res = throughput.reader_throughput(url, warmup_cycles=1, measure_cycles=4,
                                       read_method="batch", workers_count=2)
    assert res.samples >= 4  # rows, counted per columnar batch
    assert res.samples_per_sec > 0


def test_cuda_loader_throughput(small_ds):
    url, _ = small_ds
    res = throughput.cuda_loader_throughput(url, batch_size=8, warmup_batches=1,
                                            measure_batches=3, workers_count=2,
                                            field_regex=["id", "value"], device="cpu")
    assert res.samples == 3 * 8
    assert res.samples_per_sec > 0
    assert res.input_stall_percent is not None and res.prefetch_depth_avg is not None


def test_throughput_cli_json(small_ds, capsys):
    url, _ = small_ds
    rc = cli.main([url, "-n", "2", "-m", "10", "--json"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["samples"] == 10


def test_loader_microbench_smoke():
    results = dummy_reader.loader_microbench(batch_sizes=(8,), warmup_batches=1,
                                             measure_batches=3,
                                             kinds=("torch", "torch_batched", "cuda"),
                                             device="cpu")
    assert [r["loader"] for r in results] == ["torch", "torch_batched", "cuda"]
    assert all(r["samples_per_sec"] > 0 and r["batch_size"] == 8 for r in results)


# -- tests/test_liveness.py:536-551, ported -----------------------------------------------

def test_cli_parsers_accept_liveness_flags(capsys):
    from petastorm_tpu_torch.tools.diagnose import build_parser as diag_parser

    args = cli.build_parser().parse_args(
        ["file:///ds", "--item-deadline", "30", "--hedge-after", "auto"])
    assert args.item_deadline == 30.0 and args.hedge_after == "auto"
    args = diag_parser().parse_args(
        ["--synthetic", "--item-deadline", "10", "--hedge-after", "2.5"])
    assert args.item_deadline == 10.0 and args.hedge_after == 2.5
    # malformed values are argparse usage errors, not raw tracebacks
    for parser, argv in ((cli.build_parser(), ["file:///ds"]),
                         (diag_parser(), ["--synthetic"])):
        with pytest.raises(SystemExit):
            parser.parse_args(argv + ["--hedge-after", "2s"])
        assert "hedge-after" in capsys.readouterr().err


# -- parity with the JAX harness ---------------------------------------------------------

def _options(parser):
    return {tuple(a.option_strings) or (a.dest,): a for a in parser._actions}


@needs_jax
def test_the_parser_has_every_jax_option():
    jax_opts, port_opts = _options(jax_cli.build_parser()), _options(cli.build_parser())
    assert set(port_opts) - set(jax_opts) == {("--device",)}
    assert port_opts[("--device",)].default == "cuda"
    for names, want in jax_opts.items():
        got = port_opts[names]
        assert (got.dest, got.default, got.nargs) == (want.dest, want.default, want.nargs), names
        assert getattr(got.type, "__name__", got.type) == getattr(want.type, "__name__",
                                                                  want.type), names
        if names == ("--method",):
            assert (want.choices, got.choices) == (("row", "batch", "jax"),
                                                   ("row", "batch", "cuda"))
        else:
            assert got.choices == want.choices, names
    assert cli.build_parser().prog == "petastorm-tpu-torch-throughput"


@needs_jax
@pytest.mark.parametrize("method,cycles", [("row", (5, 20)), ("batch", (1, 4))])
def test_reader_throughput_matches_jax(small_ds, method, cycles):
    url, _ = small_ds
    kwargs = dict(warmup_cycles=cycles[0], measure_cycles=cycles[1], workers_count=2,
                  read_method=method)
    got = throughput.reader_throughput(url, **kwargs)
    want = jax_throughput.reader_throughput(url, **kwargs)
    assert got.samples == want.samples
    assert sorted(json.loads(got.to_json())) == sorted(json.loads(want.to_json()))


@needs_jax
@pytest.mark.parametrize("method", ["row", "batch"])
def test_telemetered_serial_read_counts_the_jax_stages(jpeg_ds, method):
    kwargs = dict(warmup_cycles=2, measure_cycles=6, pool_type="serial",
                  shuffle_row_groups=False, read_method=method)
    got = throughput.reader_throughput(jpeg_ds, telemetry=Telemetry(), **kwargs)
    want = jax_throughput.reader_throughput(jpeg_ds, telemetry=JaxTelemetry(), **kwargs)
    assert got.samples == want.samples

    def stages(metrics):
        return {k: v for k, v in metrics["counters"].items() if k.startswith("stage.")}

    assert sorted(stages(got.metrics)) == sorted(stages(want.metrics))
    assert got.metrics["counters"]["stage.decode.count"] == \
        want.metrics["counters"]["stage.decode.count"] > 0
    assert sorted(json.loads(got.to_json())) == sorted(json.loads(want.to_json()))


@needs_jax
@pytest.mark.parametrize("decode_device", [(), ("image",)], ids=["host", "device"])
def test_cuda_loader_throughput_matches_jax_loader(jpeg_ds, decode_device):
    kwargs = dict(batch_size=8, warmup_batches=1, measure_batches=4, workers_count=2,
                  device_decode_fields=decode_device)
    got = throughput.cuda_loader_throughput(jpeg_ds, device="cpu", **kwargs)
    want = jax_throughput.jax_loader_throughput(jpeg_ds, **kwargs)
    assert got.samples == want.samples == 4 * 8
    assert sorted(json.loads(got.to_json())) == sorted(json.loads(want.to_json()))
    assert 0 <= got.input_stall_percent <= 100


def test_the_device_feed_refuses_cuda_without_a_gpu(small_ds):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a GPU")
    url, _ = small_ds
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        cli.main([url, "--method", "cuda", "-n", "2", "-m", "10"])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        dummy_reader.loader_microbench(batch_sizes=(8,), kinds=("cuda",))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        ops_microbench.run(shape=SMALL_SHAPE)


def test_isolated_cuda_method_on_the_cpu_imports_no_jax(jpeg_ds, tmp_path, monkeypatch,
                                                         capsys):
    """``--isolated`` re-runs the CLI in a fresh interpreter: its JSON line
    comes back, and that interpreter never imported jax (a ``sitecustomize``
    on its path writes its module table at exit)."""
    probe = tmp_path / "probe"
    probe.mkdir()
    modules = tmp_path / "modules.txt"
    (probe / "sitecustomize.py").write_text(
        "import atexit, os, sys\n"
        "atexit.register(lambda: open(os.environ['PST_MODULES_OUT'], 'w').write("
        "'\\n'.join(sorted(sys.modules))))\n")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        p for p in (str(probe), os.environ.get("PYTHONPATH")) if p))
    monkeypatch.setenv("PST_MODULES_OUT", str(modules))
    rc = cli.main([jpeg_ds, "--method", "cuda", "--device", "cpu", "--batch-size", "8",
                   "-n", "25", "-m", "200", "-w", "2", "--isolated", "--json"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["samples"] == 8 * 8 and "input_stall_percent" in out
    loaded = modules.read_text().split()
    assert "petastorm_tpu_torch.cuda.loader" in loaded  # the child ran the device feed
    assert not [m for m in loaded if m.split(".")[0] in ("jax", "jaxlib", "petastorm_tpu")]


@needs_jax
def test_loader_microbench_kinds_match_jax():
    kwargs = dict(batch_sizes=(8, 32), warmup_batches=1, measure_batches=3)
    got = dummy_reader.loader_microbench(device="cpu", **kwargs)
    want = jax_dummy.loader_microbench(**kwargs)
    assert [(r["loader"], r["batch_size"]) for r in got] == \
        [({"jax": "cuda"}.get(r["loader"], r["loader"]), r["batch_size"]) for r in want]
    assert all(r["samples_per_sec"] > 0 for r in got)
    assert dummy_reader.BENCH_SCHEMA.fields.keys() == jax_dummy.BENCH_SCHEMA.fields.keys()


@needs_jax
def test_scaling_dataset_reads_back_as_the_jax_one(jpeg_ds, tmp_path):
    """Both packages' writers encode the same frames through the same image
    library: the JAX reader gives the same ids and the same pixels, byte for
    byte, from either dataset."""
    want_url = str(tmp_path / "jax")
    jax_scaling.build_dataset(want_url, JPEG_ROWS, JPEG_SIDE, JPEG_SIDE)

    def read(url):
        with jax_make_batch_reader(url, reader_pool_type="serial", shuffle_row_groups=False,
                                   num_epochs=1) as r:
            batches = list(r.iter_batches())
        return (np.concatenate([b.columns["id"] for b in batches]),
                np.concatenate([b.columns["image"] for b in batches]))

    (got_ids, got_px), (want_ids, want_px) = read(jpeg_ds), read(want_url)
    np.testing.assert_array_equal(got_ids, np.arange(JPEG_ROWS))
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_array_equal(got_px, want_px)


@needs_jax
@pytest.mark.parametrize("pool", ["thread", "process"])
def test_scaling_measure_matches_jax(jpeg_ds, pool):
    got = scaling.measure(jpeg_ds, pool, 2, 2)
    want = jax_scaling.measure(jpeg_ds, pool, 2, 2)
    assert sorted(got) == sorted(want)
    assert (got["samples"], got["shm_transport"]) == (want["samples"], want["shm_transport"])
    assert got["samples"] == 2 * JPEG_ROWS and got["shm_transport"] == (pool == "process")


def test_scaling_cli_prints_a_line_a_worker_count(jpeg_ds, capsys):
    assert scaling.main(["--workers", "1", "2", "--dataset-url", jpeg_ds, "--epochs", "1"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert [(x["pool"], x["workers"], x["samples"]) for x in lines] == \
        [("thread", 1, JPEG_ROWS), ("thread", 2, JPEG_ROWS)]


# -- ops_microbench ------------------------------------------------------------------------

#: the port's names for the JAX tool's (petastorm_tpu/benchmark/ops_microbench.py)
RENAMES = {"pallas_engaged": "kernel_engaged", "pallas": "kernel", "device": "kernel",
           "xla_fallback": "plain"}


def _jax_records():
    """(metric, keys) of every line the JAX tool prints, read from its source:
    each ``json.dumps({...})`` literal, a conditional key giving both names."""
    path = os.path.join(ROOT, "petastorm_tpu", "benchmark", "ops_microbench.py")
    tree = ast.parse(open(path).read())
    out = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "dumps"
                and node.args and isinstance(node.args[0], ast.Dict)):
            fields = dict(zip(node.args[0].keys, node.args[0].values))
            keys = set()
            for key in fields:
                options = (key.body, key.orelse) if isinstance(key, ast.IfExp) else (key,)
                keys |= {RENAMES.get(k.value, k.value) for k in options}
            metric = next(v.value for k, v in fields.items()
                          if isinstance(k, ast.Constant) and k.value == "metric")
            out.append((node.lineno, RENAMES.get(metric, metric), sorted(keys)))
    return [(metric, keys) for _, metric, keys in sorted(out)]


@pytest.fixture(scope="module")
def ops_run():
    outputs = {}
    records = ops_microbench.run("cpu", SMALL_SHAPE, outputs=outputs)
    return records, outputs


@needs_jax
def test_ops_microbench_prints_the_jax_metrics(ops_run):
    records, _ = ops_run
    assert [(r["metric"], sorted(r)) for r in records] == _jax_records()
    assert records[0] == {"metric": "kernel_engaged", "value": False, "backend": "cpu"}
    for r in records[1:]:
        assert all(v > 0 for k, v in r.items() if k != "metric"), r


@needs_jax
def test_ops_microbench_normalize_matches_jax(ops_run):
    images, out = ops_run[1]["normalize"]
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == SMALL_SHAPE
    want = jax_normalize.normalize_images(jnp.asarray(images.numpy()), ops_microbench.MEAN,
                                          ops_microbench.STD)
    _, bias = normalize.channel_constants(ops_microbench.MEAN, ops_microbench.STD, 3)
    assert_within_ulp(out.float().numpy(), np.asarray(want.astype(jnp.float32)), "bfloat16",
                      bias)


@needs_jax
def test_ops_microbench_hybrid_decode_matches_jax(ops_run):
    bufs, planes, qtabs, layout, out = ops_run[1]["jpeg"]
    n, h, w, _ = SMALL_SHAPE
    assert out.dtype == torch.uint8 and tuple(out.shape) == (n // 4, h, w, 3)
    jp, jq, jlay = jax_native.read_jpeg_coefficients_column(bufs)
    want = np.asarray(jax_jpeg.decode_coefficients(
        tuple(jnp.asarray(p) for p in jp), jnp.asarray(jq), image_size=(jlay.height, jlay.width),
        sampling=tuple((hs, vs) for (hs, vs, _, _) in jlay.components)))
    assert int(np.abs(out.numpy().astype(np.int32) - want.astype(np.int32)).max()) <= 1


def test_ops_microbench_crops_are_the_plain_resample(ops_run):
    """The crops it timed, with their drawn boxes and flips, are the plain
    resample of those draws on the CPU (the card's check is chip_smoke.py's)."""
    from petastorm_tpu_torch.ops import augment

    for key, antialias in (("crop", False), ("crop_aa", True)):
        big, boxes, flips, out = ops_run[1][key]
        hw = SMALL_SHAPE[1:3]
        assert tuple(big.shape) == (SMALL_SHAPE[0], 36, 36, 3)
        want = augment._resized_crop_reference(big, augment.crop_params(boxes, hw), flips, hw,
                                               antialias)
        assert torch.equal(out, want)


def test_ops_microbench_cli_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "petastorm_tpu_torch.benchmark.ops_microbench", "--device",
         "cpu", "--shape", "4", "16", "16", "3"],
        capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = [json.loads(x) for x in out.stdout.strip().splitlines()]
    assert [x["metric"] for x in lines][:2] == ["kernel_engaged", "normalize_ms_per_256imgs"]
    assert len(lines) == 5


def test_console_scripts_name_the_ports_entry_points():
    import importlib
    import tomllib

    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    for name, target in [("throughput", "petastorm_tpu_torch.benchmark.cli:main"),
                         ("scaling", "petastorm_tpu_torch.benchmark.scaling:main"),
                         ("selfcheck", "petastorm_tpu_torch.parallel.selfcheck:_main")]:
        assert scripts[f"petastorm-tpu-torch-{name}"] == target
        module, attr = target.split(":")
        assert callable(getattr(importlib.import_module(module), attr))


# -- on the card ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("shape", [SMALL_SHAPE, ops_microbench.SHAPE], ids=["small", "jax_shape"])
def test_ops_microbench_engages_the_kernels_on_the_card(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the Hopper kernels have no CPU mode")
    before = ops_microbench.launch_counts()
    records = ops_microbench.run("cuda", shape)
    assert records[0] == {"metric": "kernel_engaged", "value": True, "backend": "cuda"}
    assert all(v > before[k] for k, v in ops_microbench.launch_counts().items())
    assert records[1]["kernel"] > 0 and len(records) == 5
