"""The port and chip_smoke.py import nothing of JAX or of the JAX package.

An AST scan, not a ``sys.modules`` check: the test process imports jax at
start-up (tests/conftest.py), so a module-table check would say nothing.
"""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "petastorm_tpu")


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.join(ROOT, "petastorm_tpu_torch")):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__") and node.args
                and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = sorted(set(_imported_roots(tree)) & set(FORBIDDEN))
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_scan_sees_forbidden_imports():
    tree = ast.parse("import jax.numpy as jnp\nfrom petastorm_tpu.ops import x\n"
                     "from petastorm_tpu_torch import y\nimport importlib\n"
                     "importlib.import_module('flax.linen')\n")
    assert set(_imported_roots(tree)) & set(FORBIDDEN) == {"jax", "petastorm_tpu", "flax"}


def test_every_port_module_is_scanned():
    names = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for required in ("chip_smoke.py", "petastorm_tpu_torch/ops/normalize.py",
                     "petastorm_tpu_torch/cuda/loader.py", "petastorm_tpu_torch/reader.py",
                     "petastorm_tpu_torch/models/resnet.py", "petastorm_tpu_torch/ops/augment.py",
                     "petastorm_tpu_torch/examples/imagenet/train_resnet_cuda.py",
                     "petastorm_tpu_torch/ops/jpeg.py", "petastorm_tpu_torch/worker.py",
                     "petastorm_tpu_torch/native/__init__.py",
                     "petastorm_tpu_torch/native/build.py",
                     "petastorm_tpu_torch/native/image.py", "petastorm_tpu_torch/shuffle.py",
                     "petastorm_tpu_torch/pytorch.py", "petastorm_tpu_torch/seeding.py",
                     "petastorm_tpu_torch/checkpoint.py", "petastorm_tpu_torch/plan.py",
                     "petastorm_tpu_torch/pool.py", "petastorm_tpu_torch/predicates.py",
                     "petastorm_tpu_torch/selectors.py", "petastorm_tpu_torch/transform.py",
                     "petastorm_tpu_torch/etl/indexing.py",
                     "petastorm_tpu_torch/etl/metadata.py", "petastorm_tpu_torch/ngram.py",
                     "petastorm_tpu_torch/weighted_sampling.py",
                     "petastorm_tpu_torch/rebatch.py", "petastorm_tpu_torch/errors.py",
                     "petastorm_tpu_torch/etl/writer.py",
                     "petastorm_tpu_torch/etl/generate_metadata.py",
                     "petastorm_tpu_torch/converter.py", "petastorm_tpu_torch/cache.py",
                     "petastorm_tpu_torch/examples/imagenet/forward_ab.py",
                     "petastorm_tpu_torch/sequence/__init__.py",
                     "petastorm_tpu_torch/sequence/dataset.py",
                     "petastorm_tpu_torch/sequence/packing.py",
                     "petastorm_tpu_torch/sequence/mixing.py",
                     "petastorm_tpu_torch/sequence/loader.py",
                     "petastorm_tpu_torch/models/mlp.py", "petastorm_tpu_torch/convert.py",
                     "petastorm_tpu_torch/examples/mnist/train_mnist_cuda.py",
                     "petastorm_tpu_torch/examples/hello_world/generate_dataset.py",
                     "petastorm_tpu_torch/examples/hello_world/read_dataset.py",
                     "petastorm_tpu_torch/examples/preemption/train_with_preemption_cuda.py",
                     "petastorm_tpu_torch/parallel/__init__.py",
                     "petastorm_tpu_torch/parallel/mesh.py",
                     "petastorm_tpu_torch/parallel/write.py",
                     "petastorm_tpu_torch/parallel/selfcheck.py",
                     "petastorm_tpu_torch/parallel/launch.py",
                     "petastorm_tpu_torch/ops/ring_attention.py",
                     "petastorm_tpu_torch/ops/ulysses.py",
                     "petastorm_tpu_torch/examples/long_context/__init__.py",
                     "petastorm_tpu_torch/examples/long_context/train_ring_attention_cuda.py",
                     "petastorm_tpu_torch/fs.py", "petastorm_tpu_torch/hdfs.py",
                     "petastorm_tpu_torch/retry.py", "petastorm_tpu_torch/io_window.py",
                     "petastorm_tpu_torch/test_util/__init__.py",
                     "petastorm_tpu_torch/test_util/synthetic.py",
                     "petastorm_tpu_torch/test_util/shuffling_analysis.py",
                     "petastorm_tpu_torch/test_util/latency_fs.py",
                     "petastorm_tpu_torch/test_util/chaos.py",
                     "petastorm_tpu_torch/native/transport.py",
                     "petastorm_tpu_torch/pool.py",
                     "petastorm_tpu_torch/telemetry/__init__.py",
                     "petastorm_tpu_torch/telemetry/registry.py",
                     "petastorm_tpu_torch/telemetry/report.py",
                     "petastorm_tpu_torch/telemetry/trace.py",
                     "petastorm_tpu_torch/telemetry/sampler.py",
                     "petastorm_tpu_torch/telemetry/export.py",
                     "petastorm_tpu_torch/cache_shared.py",
                     "petastorm_tpu_torch/autotune.py",
                     "petastorm_tpu_torch/planner.py",
                     "petastorm_tpu_torch/service/__init__.py",
                     "petastorm_tpu_torch/service/wire.py",
                     "petastorm_tpu_torch/service/protocol.py",
                     "petastorm_tpu_torch/service/journal.py",
                     "petastorm_tpu_torch/service/worker.py",
                     "petastorm_tpu_torch/service/dispatcher.py",
                     "petastorm_tpu_torch/service/client.py",
                     "petastorm_tpu_torch/service/autoscale.py",
                     "petastorm_tpu_torch/service/cli.py",
                     "petastorm_tpu_torch/test_util/netchaos.py"):
        assert required in names
