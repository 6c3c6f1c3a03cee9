"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and ``nvcc`` (the kernels have no CPU mode)
and skip without one.  The file imports nothing of JAX, so on a GPU machine
without JAX it runs on its own:
``python -m pytest --noconftest tests/test_torch_cuda_kernels.py -m cuda -q``.

Resized-crop tolerance: at most 1 LSB, at most 0.1 % of bytes differing: the
kernel and the plain version use the same float32 weights and sum the same
products in other orders (the plain version through cuBLAS), which moves a
byte only where the sum sits at a .5 boundary.  The tiled kernel (no
antialias) and the general kernel must agree on every byte.

Normalize tolerance: float32 within 2 ulp taken at the larger of |out| and
|bias| (the kernel contracts ``x*s+b`` into one FMA, the plain version rounds
the product first, and that rounding is of the addends' size); bfloat16 and
float16 within 1 ulp of their type at |out| on top of that.
"""

import numpy as np
import pytest
import torch

from petastorm_tpu_torch.ops import augment
from petastorm_tpu_torch.ops import normalize as torch_normalize


def _ulp(x: np.ndarray, dtype) -> np.ndarray:
    """The spacing of ``dtype`` at each |x|, in float64."""
    info = {np.float32: (23, -126), "bfloat16": (7, -126), np.float16: (10, -14)}[dtype]
    mant, emin = info
    exp = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** emin)))
    return 2.0 ** (exp - mant)


def assert_within_ulp(got, want, dtype, bias):
    """|got - want| <= 2 float32 ulp at max(|want|, |bias|), plus 1 ulp of
    ``dtype`` at |want| when ``dtype`` is narrower than float32; ``bias``
    broadcasts over the channel axis."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    bound = 2 * _ulp(np.maximum(np.abs(want), np.abs(bias)), np.float32)
    if dtype is not np.float32:
        bound = bound + _ulp(want, dtype)
    assert np.all(np.abs(got - want) <= bound), np.max(np.abs(got - want) / bound)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 224, 224, 3), (7, 225, 223, 3), (5, 31, 17, 1),
                                   (3, 16, 16, 4)])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32, torch.float16])
@pytest.mark.parametrize("offset", [0, 1, 7], ids=["aligned", "off1", "off7"])
def test_kernel_matches_plain_on_card(shape, out_dtype, offset):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the Hopper kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    n = int(np.prod(shape))
    flat = torch.randint(0, 256, (n + offset,), dtype=torch.uint8, device="cuda", generator=gen)
    x = flat[offset:].view(shape)  # a view starting `offset` bytes past an aligned address
    c = shape[-1]
    mean, std = (0.5, 0.4, 0.3, 0.6)[:c], (0.2, 0.25, 0.3, 0.35)[:c]
    scale, bias = torch_normalize.channel_constants(mean, std, c)
    got = torch_normalize.normalize_images(x, mean, std, out_dtype)
    want = torch_normalize._normalize_reference(x, scale, bias, out_dtype)
    ulp_dt = {torch.float32: np.float32, torch.bfloat16: "bfloat16",
              torch.float16: np.float16}[out_dtype]
    assert_within_ulp(got.float().cpu().numpy(), want.float().cpu().numpy(), ulp_dt, bias)
    with pytest.raises(TypeError):
        torch_normalize.normalize_images(x, mean, std, torch.float64)


@pytest.mark.cuda
def test_loader_delivers_every_row_once_on_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from petastorm_tpu_torch import Field, Schema, make_reader, write_dataset
    from petastorm_tpu_torch.cuda.loader import VALID_ROWS, CudaDataLoader

    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (300, 12, 10, 3), dtype=np.uint8)
    schema = Schema("S", [Field("label", np.int64), Field("image", np.uint8, (12, 10, 3))])
    write_dataset(str(tmp_path / "ds"), schema,
                  [{"label": i, "image": images[i]} for i in range(300)], row_group_size_rows=7)
    reader = make_reader(str(tmp_path / "ds"), workers_count=4, shuffle_seed=0, num_epochs=2)
    labels, seen = [], []
    with CudaDataLoader(reader, batch_size=32, device="cuda", drop_last=False,
                        prefetch=1) as loader:
        for batch in loader:
            n = batch.get(VALID_ROWS, 32)
            assert batch["image"].is_cuda and batch["image"].dtype == torch.uint8
            labels.append(batch["label"][:n])
            seen.append(batch["image"][:n])
    labels = torch.cat(labels).cpu().numpy()
    seen = torch.cat(seen).cpu().numpy()
    assert sorted(labels.tolist()) == sorted(list(range(300)) * 2)
    np.testing.assert_array_equal(seen, images[labels])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,out_hw,antialias", [
    ((256, 224, 224, 3), (224, 224), False), ((7, 97, 131, 3), (50, 61), False),
    ((5, 64, 64, 1), (17, 23), True), ((3, 20, 30, 5), (41, 7), True),
    ((6, 40, 50, 1), (21, 33), False), ((6, 40, 50, 4), (19, 30), False),
    ((5, 33, 37, 3), (20, 27), False),     # a row of 111 bytes: not a multiple of 16
    ((3, 300, 517, 3), (37, 301), False),  # oh not a multiple of 8, two column tiles
    ((4, 512, 640, 3), (40, 50), False),   # downscale past 8x: taps far apart
    ((3, 20, 30, 5), (41, 7), False),      # C = 5: two channel chunks, C not known at compile time
    ((0, 30, 40, 3), (9, 11), False)])
@pytest.mark.parametrize("flipped", [True, False], ids=["flips", "no-flips"])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "off1"])
def test_resized_crop_kernel_matches_plain_on_card(shape, out_hw, antialias, flipped, offset):
    """Without antialias the tiled kernel runs, and must equal the general
    kernel on every byte (same arithmetic by construction)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the Hopper kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    n, h, w, _ = shape
    flat = torch.randint(0, 256, (int(np.prod(shape)) + offset,), dtype=torch.uint8,
                         device="cuda", generator=gen)
    x = flat[offset:].view(shape)  # a view starting `offset` bytes past an aligned address
    # a downscale by more than 8x: boxes of at least half the image, so that
    # neighbouring output pixels read source pixels far apart
    scale = (0.5, 1.0) if out_hw[1] * 8 < w else (0.08, 1.0)
    boxes = augment.draw_crop_boxes(n, h, w, gen, scale=scale, device="cuda")
    flips = augment.draw_flips(n, gen, "cuda") if flipped else None
    before = augment.resized_crop_kernel.launches
    got = augment.random_resized_crop(x, None, out_hw, antialias=antialias, boxes=boxes,
                                      flips=flips)
    assert augment.resized_crop_kernel.launches == before + (1 if n else 0)
    assert got.shape == (n, *out_hw, shape[-1])
    params = augment.crop_params(boxes, out_hw)
    if not antialias:
        general = augment.launch_resized_crop(x, params, flips, out_hw, False, tiled=False)
        assert torch.equal(got, general)
    want = augment._resized_crop_reference(x, params, flips, out_hw, antialias)
    if n:
        diff = (got.int() - want.int()).abs()
        assert int(diff.max()) <= 1
        assert float((diff > 0).float().mean()) <= 0.001
    resized = augment.resize_images(x, out_hw, antialias=antialias)
    assert resized.shape == (n, *out_hw, shape[-1]) and resized.dtype == torch.uint8
    with pytest.raises(TypeError):
        augment.resize_images(x.float(), out_hw)


@pytest.mark.cuda
def test_resized_crop_kernel_routes_by_antialias_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the Hopper kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randint(0, 256, (3, 40, 50, 3), dtype=torch.uint8, device="cuda", generator=gen)
    k = augment.resized_crop_kernel

    def counts():
        return k.launches, k.launches_tiled, k.launches_general

    total, tiled, general = counts()
    augment.random_resized_crop(x, gen, (16, 16), antialias=False)
    assert counts() == (total + 1, tiled + 1, general)
    augment.resize_images(x, (16, 16), antialias=True)
    assert counts() == (total + 2, tiled + 1, general + 1)
    with pytest.raises(ValueError, match="no antialias"):
        augment.launch_resized_crop(x, torch.ones(3, 4, device="cuda"), None, (16, 16), True,
                                    tiled=True)


@pytest.mark.cuda
def test_trainer_runs_on_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from petastorm_tpu_torch.examples.imagenet import train_resnet_cuda as trainer

    url = str(tmp_path / "imagenet")
    trainer.generate_dataset(url, rows=64, side=64)
    before = augment.resized_crop_kernel.launches
    m = trainer.train(url, steps=2, global_batch=16, side=64, num_classes=10)
    assert augment.resized_crop_kernel.launches - before == 1 + 2 * m["steps"]
    assert m["samples_per_sec"] > 0 and np.isfinite(m["final_loss"])
    assert m["measured_peak_flops"] > 0 and m["flops_per_sample"] > 0
    assert m["device_kind"] == torch.cuda.get_device_name(0)


def test_crop_ab_parses_variant_files():
    # the A/B tool times the package's source (as_is) against other versions
    # of the file, named on its command line
    from petastorm_tpu_torch.cuda import build
    from petastorm_tpu_torch.examples.imagenet import crop_ab

    variants = crop_ab.parse_variants(["old=a/resized_crop.cu", "c_at_run_time=b.cu"])
    assert variants == {"as_is": f"{build.SOURCE_DIR}/resized_crop.cu",
                        "old": "a/resized_crop.cu", "c_at_run_time": "b.cu"}
    for bad in (["old"], ["=a.cu"], ["old="], ["as_is=a.cu"], ["general=a.cu"],
                ["old=a.cu", "old=b.cu"]):
        with pytest.raises(ValueError):
            crop_ab.parse_variants(bad)
