"""The plain reference against the port's plain versions at a tiny size,
and the scan that keeps JAX, the JAX package and the program out of what
must not import them."""

import ast
import os

import numpy as np
import pytest
import torch

from portbench import corpus as corpus_mod
from portbench import run
from portbench.reference import preprocess, resnet, steps

BENCH = os.path.join(run.ROOT, "portbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "petastorm_tpu"}


def imported_top_names(path):
    """Top-level names of every absolute import in a Python file."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def python_files(top):
    for base, _, files in os.walk(top):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(base, name)


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    files = list(python_files(BENCH))
    assert len(files) > 20
    for path in files:
        assert not imported_top_names(path) & FORBIDDEN, path


def test_the_whole_name_is_compared_not_a_prefix(tmp_path):
    path = tmp_path / "m.py"
    path.write_text("import petastorm_tpu_torch\nfrom petastorm_tpu_torch.ops import x\n")
    assert not imported_top_names(str(path)) & FORBIDDEN
    path.write_text("from petastorm_tpu.ops import x\n")
    assert imported_top_names(str(path)) & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    for path in python_files(os.path.join(BENCH, "reference")):
        assert imported_top_names(path) <= {"__future__", "math", "typing", "contextlib",
                                            "concurrent", "numpy", "torch", "cv2", "portbench"}
        with open(path) as f:
            assert "petastorm_tpu" not in f.read(), path


def test_the_run_refuses_a_loaded_jax_package(monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "petastorm_tpu.fake", object())
    assert run.foreign_modules() == ["petastorm_tpu"]


def test_the_forward_equals_the_ports_float32_model():
    from petastorm_tpu_torch.models import ResNet50

    leaves = resnet.make_leaves(5, "cpu", num_classes=10)
    model = ResNet50(num_classes=10, dtype=torch.float32, device="cpu")
    model.load_state_dict(leaves)
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    got = model(x)
    want = resnet.forward(leaves, x)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())


def test_one_training_step_equals_the_ports_step_in_float32():
    from petastorm_tpu_torch.examples.imagenet.train_resnet_cuda import TrainStep
    from petastorm_tpu_torch.models import ResNet50

    leaves = resnet.make_leaves(6, "cpu", num_classes=10)
    # a nonzero last scale in each block, so every leaf takes a gradient
    leaves = {k: (torch.full_like(v, 0.5) if k.endswith("bn2.scale") else v)
              for k, v in leaves.items()}
    model = ResNet50(num_classes=10, dtype=torch.float32, device="cpu")
    model.load_state_dict(leaves)
    step = TrainStep(model, 10, 32)
    names = {id(t): n for n, t in model.state_dict(keep_vars=True).items()}
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(4, 32, 32, 3, generator=gen)
    labels = torch.randint(0, 10, (4,), generator=gen)
    loss = float(step.update(x, labels))
    got = {names[id(leaf)]: float(b.double().norm()) for leaf, b in
           zip(step.leaves, step.momentum())}
    want = steps.train_steps(leaves, [(x, labels)], 0.1, 0.9)
    assert loss == pytest.approx(want["losses"][0], rel=1e-5)
    for name, norm in want["grad1"].items():
        assert got[name] == pytest.approx(norm, rel=1e-3, abs=1e-6 * max(want["grad1"].values()))


@pytest.mark.parametrize("antialias", [False, True])
def test_the_crop_equals_the_ports_plain_crop(antialias):
    from petastorm_tpu_torch.ops import random_resized_crop

    gen = torch.Generator().manual_seed(3)
    images = torch.randint(0, 256, (5, 40, 48, 3), dtype=torch.uint8, generator=gen)
    boxes = torch.tensor([[0.0, 0.0, 40.0, 48.0], [3.5, 7.25, 20.0, 30.0],
                          [10.0, 1.0, 12.0, 9.0], [0.0, 20.0, 40.0, 28.0],
                          [5.0, 5.0, 33.0, 41.0]])
    flips = torch.tensor([False, True, False, True, True])
    got = random_resized_crop(images, None, (24, 24), antialias=antialias, boxes=boxes,
                              flips=flips)
    want = preprocess.resized_crop(images, boxes, (24, 24), flips, antialias=antialias)
    assert (got.int() - want.int()).abs().max() <= 1
    assert (got != want).float().mean() <= 0.001


def test_normalize_equals_the_ports_plain_normalize():
    from petastorm_tpu_torch.ops import normalize_images

    images = torch.arange(256, dtype=torch.uint8).repeat(3).view(1, 16, 16, 3)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    got = normalize_images(images, mean, std, out_dtype=torch.float32)
    want = preprocess.normalize(images, mean, std)
    assert torch.allclose(got, want, atol=2e-6)


def test_decode_and_pad_equal_the_ports_host_feed(tmp_path):
    from petastorm_tpu_torch import make_reader
    from petastorm_tpu_torch.cuda.loader import CudaDataLoader

    config = run.load_json(os.path.join(BENCH, "tests", "fixture", "portbench", "configs",
                                        "tiny_train.json"))
    written = corpus_mod.write_corpus(config["corpus"], 16, 9, str(tmp_path), threads=2)
    reader = make_reader(written.path, num_epochs=1, shuffle_seed=1, workers_count=2,
                         decode_placement={"image": "host"})
    with CudaDataLoader(reader, batch_size=8, device="cpu",
                        pad_shapes={"image": tuple(config["pad_to"])}) as loader:
        for batch in loader:
            ids = batch["row_id"].numpy()
            want = steps.decoded([written.streams[i] for i in ids], config["pad_to"], threads=2)
            assert np.array_equal(batch["image"].numpy(), want)
            assert np.array_equal(batch["label"].numpy(), written.labels[ids])
