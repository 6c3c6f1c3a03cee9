"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and ``nvcc`` (the kernels have no CPU mode)
and skip without one.  The file imports nothing of JAX, so on a GPU machine
without JAX it runs on its own:
``python -m pytest --noconftest tests/test_torch_cuda_kernels.py -m cuda -q``.

Resized-crop tolerance: at most 1 LSB, at most 0.1 % of bytes differing: the
kernel and the plain version use the same float32 weights and sum the same
products in other orders (the plain version through cuBLAS), which moves a
byte only where the sum sits at a .5 boundary.  The tiled kernel (no
antialias) and the antialiased tiled kernel must each agree with the
general kernel on every byte.

Resample of other dtypes (the general kernel's float32 instance): float32
within 8 float32 ulp of 256 (the same weights, the sums in other orders); a
narrower float type within one of its ulps at 255 on top (both round such
float32 values); an integer type within 1.

Normalize tolerance: float32 within 2 ulp taken at the larger of |out| and
|bias| (the kernel contracts ``x*s+b`` into one FMA, the plain version rounds
the product first, and that rounding is of the addends' size); bfloat16 and
float16 within 1 ulp of their type at |out| on top of that.

JPEG decode (kernel B2) against its plain version: uint8 at most 1 LSB apart
on at most 0.1 % of the bytes, float32 within 2e-3 on values of 0-255 (the
same float32 arithmetic, the IDCT's sums in other orders: the plain version
contracts through cuBLAS); against cv2 max 6 and mean below 1, the
reference's bound.  B2's tiled kernel, which every path takes, must equal
its general kernel on every byte (uint8) and bit (float32): the same float
operations in the same order.

The trainer's K-step CUDA graph (``ScanStep``) against the same steps run
eagerly: the draws equal bit for bit, the losses and leaves within twice
the spread of two eager runs (cuDNN's backward need not be bit-deterministic,
so two eager runs are the measure of what may differ; a spread of 0 asks for
equality).
"""

import numpy as np
import pytest
import torch

from petastorm_tpu_torch.examples.imagenet import train_resnet_cuda as trainer
from petastorm_tpu_torch.models.resnet import ResNet
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
@pytest.mark.parametrize("channels", [65, 300])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32, torch.float16])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "off1"])
def test_kernel_takes_any_channel_count_on_card(channels, out_dtype, offset):
    """Above 64 channels the constants reach the kernel through a device buffer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the Hopper kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = (3, 7, 5, channels)
    flat = torch.randint(0, 256, (int(np.prod(shape)) + offset,), dtype=torch.uint8,
                         device="cuda", generator=gen)
    x = flat[offset:].view(shape)
    mean, std = np.linspace(0.1, 0.9, channels), np.linspace(0.2, 0.5, channels)
    scale, bias = torch_normalize.channel_constants(mean, std, channels)
    before = torch_normalize.normalize_kernel.launches
    got = torch_normalize.normalize_images(x, mean, std, out_dtype)
    assert torch_normalize.normalize_kernel.launches == before + 1
    want = torch_normalize._normalize_reference(x, scale, bias, out_dtype)
    ulp_dt = {torch.float32: np.float32, torch.bfloat16: "bfloat16",
              torch.float16: np.float16}[out_dtype]
    assert_within_ulp(got.float().cpu().numpy(), want.float().cpu().numpy(), ulp_dt, bias)


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
    """Without antialias the tiled kernel runs, with it the antialiased tiled
    kernel; each must equal the general kernel on every byte (same arithmetic
    by construction)."""
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
    general = augment.launch_resized_crop(x, params, flips, out_hw, antialias, kernel="general")
    assert torch.equal(got, general)
    want = augment._resized_crop_reference(x, params, flips, out_hw, antialias)
    if n:
        diff = (got.int() - want.int()).abs()
        assert int(diff.max()) <= 1
        assert float((diff > 0).float().mean()) <= 0.001
    resized = augment.resize_images(x, out_hw, antialias=antialias)
    assert resized.shape == (n, *out_hw, shape[-1]) and resized.dtype == torch.uint8
    # float32 images take the general kernel's float32 instance, unrounded
    general_launches = augment.resized_crop_kernel.launches_general
    resized = augment.resize_images(x.float(), out_hw, antialias=antialias)
    assert resized.dtype == torch.float32
    assert augment.resized_crop_kernel.launches_general == general_launches + (1 if n else 0)
    if n:
        inv = torch.tensor([1.0 / (out_hw[0] / h), 0.0, 1.0 / (out_hw[1] / w), 0.0],
                           device="cuda")  # as resize_images
        want = augment._resized_crop_reference(x.float(), inv.expand(n, 4), None, out_hw,
                                               antialias)
        torch.testing.assert_close(resized, want, rtol=0, atol=8 * 2.0 ** -15)


_FLOAT_RESAMPLE = {torch.float32: 8 * 2.0 ** -15, torch.float16: 0.125 + 8 * 2.0 ** -15,
                   torch.bfloat16: 1.0 + 8 * 2.0 ** -15, torch.int16: 1.0, torch.int32: 1.0}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(_FLOAT_RESAMPLE), ids=str)
@pytest.mark.parametrize("shape,out_hw,antialias", [
    ((256, 224, 224, 3), (224, 224), False), ((7, 97, 131, 3), (50, 61), True),
    ((3, 20, 30, 5), (41, 7), True), ((6, 40, 50, 1), (21, 33), False)])
@pytest.mark.parametrize("flipped", [True, False], ids=["flips", "no-flips"])
def test_other_dtypes_resample_on_card(dtype, shape, out_hw, antialias, flipped):
    """Images that are not uint8 are resampled in float32 by the general
    kernel and brought back to their dtype, as the plain version does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the Hopper kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    n, h, w, _ = shape
    x = (torch.rand(shape, generator=gen, device="cuda") * 255).to(dtype)
    boxes = augment.draw_crop_boxes(n, h, w, gen, device="cuda")
    flips = augment.draw_flips(n, gen, "cuda") if flipped else None
    k = augment.resized_crop_kernel
    before = (k.launches_tiled, k.launches_aa, k.launches_general)
    got = augment.random_resized_crop(x, None, out_hw, antialias=antialias, boxes=boxes,
                                      flips=flips)
    assert (k.launches_tiled, k.launches_aa, k.launches_general) == (before[0], before[1],
                                                                     before[2] + 1)
    assert got.dtype == dtype and got.shape == (n, *out_hw, shape[-1])
    params = augment.crop_params(boxes, out_hw)
    want = augment._resized_crop_reference(x, params, flips, out_hw, antialias)
    err = (got.double() - want.double()).abs().max().item()
    assert err <= _FLOAT_RESAMPLE[dtype], err
    resized = augment.resize_images(x, out_hw, antialias=antialias)
    assert resized.dtype == dtype and resized.shape == (n, *out_hw, shape[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,out_hw,boxes", [
    ((256, 256, 256, 3), (224, 224), None),        # the evaluation resize
    ((256, 224, 224, 3), (224, 224), (0.08, 1.0)),  # random_resized_crop(antialias=True)
    ((256, 224, 224, 3), (224, 224), (1.0, 1.0)),   # full-image boxes
    ((5, 64, 64, 1), (17, 23), (0.08, 1.0)),
    ((3, 20, 30, 5), (41, 7), (0.08, 1.0)),         # C = 5: a group of 4 and one of 1
    ((6, 40, 50, 4), (19, 30), (0.08, 1.0)),
    ((3, 300, 517, 3), (37, 301), (0.08, 1.0)),
    ((4, 512, 640, 3), (40, 50), (0.5, 1.0)),       # downscale past 8x
    ((2, 16, 4096, 3), (16, 16), None),             # 256x on one axis: the span in chunks
], ids=["eval-resize", "rrc", "rrc-full-boxes", "c1", "c5", "c4", "wide", "past-8x",
        "256x-one-axis"])
@pytest.mark.parametrize("flipped", [True, False], ids=["flips", "no-flips"])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "off1"])
def test_aa_kernel_equals_general_kernel_on_card(shape, out_hw, boxes, flipped, offset):
    """The antialiased tiled kernel gives the general kernel's bytes, at
    resize_images' scale (``boxes`` None) and at drawn crop boxes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the Hopper kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    n, h, w, _ = shape
    flat = torch.randint(0, 256, (int(np.prod(shape)) + offset,), dtype=torch.uint8,
                         device="cuda", generator=gen)
    x = flat[offset:].view(shape)
    if boxes is None:
        inv = [1.0 / (out_hw[0] / h), 0.0, 1.0 / (out_hw[1] / w), 0.0]  # as resize_images
        params = torch.tensor(inv, device="cuda").expand(n, 4)
    else:
        params = augment.crop_params(
            augment.draw_crop_boxes(n, h, w, gen, scale=boxes, device="cuda"), out_hw)
    flips = augment.draw_flips(n, gen, "cuda") if flipped else None
    k = augment.resized_crop_kernel
    before = (k.launches_aa, k.launches_general)
    got = augment.resized_crop_kernel(x, params, flips, out_hw, True)
    assert (k.launches_aa, k.launches_general) == (before[0] + 1, before[1])
    general = augment.launch_resized_crop(x, params, flips, out_hw, True, kernel="general")
    assert torch.equal(got, general)
    want = augment._resized_crop_reference(x, params, flips, out_hw, True)
    diff = (got.int() - want.int()).abs()
    assert int(diff.max()) <= 1
    assert float((diff > 0).float().mean()) <= 0.001


@pytest.mark.cuda
def test_resized_crop_kernel_routes_by_antialias_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the Hopper kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randint(0, 256, (3, 40, 50, 3), dtype=torch.uint8, device="cuda", generator=gen)
    k = augment.resized_crop_kernel

    def counts():
        return k.launches, k.launches_tiled, k.launches_aa, k.launches_general

    total, tiled, aa, general = counts()
    augment.random_resized_crop(x, gen, (16, 16), antialias=False)
    assert counts() == (total + 1, tiled + 1, aa, general)
    augment.resize_images(x, (16, 16), antialias=True)
    assert counts() == (total + 2, tiled + 1, aa + 1, general)
    # an upscale and a steep downscale take the same kernel: no route by shape
    augment.resize_images(x, (90, 7), antialias=True)
    augment.random_resized_crop(x, gen, (64, 64), antialias=True)
    assert counts() == (total + 4, tiled + 1, aa + 3, general)
    augment.launch_resized_crop(x, torch.ones(3, 4, device="cuda"), None, (16, 16), True,
                                kernel="general")
    assert counts() == (total + 5, tiled + 1, aa + 3, general + 1)
    with pytest.raises(ValueError, match="no antialias"):
        augment.launch_resized_crop(x, torch.ones(3, 4, device="cuda"), None, (16, 16), True,
                                    kernel="tiled")
    with pytest.raises(ValueError, match="antialias only"):
        augment.launch_resized_crop(x, torch.ones(3, 4, device="cuda"), None, (16, 16), False,
                                    kernel="aa")


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


def test_crop_ab_reports_ptxas_of_the_chosen_entry():
    from petastorm_tpu_torch.examples.imagenet import crop_ab

    stderr = "\n".join([
        "ptxas info    : Compiling entry function '_ZN4_GLOBAL_resized_crop_u8_kernelE' for 'sm_90a'",
        "ptxas info    : Used 40 registers",
        "ptxas info    : Compiling entry function '_ZN4_GLOBAL_resized_crop_u8_tiled_kernelE' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 32 registers, 256 bytes smem",
        "ptxas info    : Compiling entry function '_ZN4_GLOBAL_resized_crop_u8_aa_tiled_kernelILi3EEE' for 'sm_90a'",
        "ptxas info    : Used 48 registers, 8 bytes smem"])
    tiled = crop_ab.ptxas_report("tiled", stderr)
    aa = crop_ab.ptxas_report("aa", stderr)
    assert len(tiled) == 3 and "u8_tiled_kernel" in tiled[0] and "32 registers" in tiled[2]
    assert len(aa) == 2 and "aa_tiled" in aa[0] and "48 registers" in aa[1]


# -- the antialiased tiled kernel's launch plan, on the CPU ------------------

_PLAN_SHAPES = [((256, 256, 3), (224, 224)), ((224, 224, 3), (224, 224)),
                ((64, 64, 1), (17, 23)), ((20, 30, 5), (41, 7)), ((40, 50, 4), (19, 30)),
                ((300, 517, 3), (37, 301)), ((512, 640, 3), (40, 50)),
                ((16, 4096, 3), (16, 16)), ((96, 160, 3), (40, 50)), ((7, 9, 3), (300, 2))]


def _most_nonzero_taps(in_size, out_size, inv, translation):
    """The most nonzero weights any output position has in _weight_mats."""
    mats = augment._weight_mats(in_size, out_size, inv, translation, True)
    return int((mats != 0).sum(1).max())


@pytest.mark.parametrize("hwc,out_hw", _PLAN_SHAPES, ids=[f"{a}->{b}" for a, b in _PLAN_SHAPES])
@pytest.mark.parametrize("params", ["boxes", "full-boxes", "resize", "ulp-above"])
def test_aa_plan_holds_every_tap_within_shared_memory(hwc, out_hw, params):
    """The plan's tap capacities hold every nonzero tap the entry points can
    give (drawn boxes, full-image boxes, resize_images' scale, and a scale one
    float32 ulp above in/out), and its shared memory fits a block."""
    h, w, c = hwc
    oh, ow = out_hw
    plan = augment.aa_launch_plan(h, w, c, oh, ow)
    n = 64
    if params == "resize":
        p = torch.tensor([1.0 / (oh / h), 0.0, 1.0 / (ow / w), 0.0]).expand(n, 4)
    elif params == "ulp-above":
        up = [float(np.nextafter(np.float32(h / oh), np.float32(np.inf))),
              float(np.nextafter(np.float32(w / ow), np.float32(np.inf)))]
        p = torch.tensor([up[0], 0.0, up[1], 0.0]).expand(n, 4)
    else:
        scale = (1.0, 1.0) if params == "full-boxes" else (0.08, 1.0)
        gen = torch.Generator().manual_seed(0)
        boxes = augment.draw_crop_boxes(n, h, w, gen, scale=scale, device="cpu")
        p = augment.crop_params(boxes, out_hw)
    assert _most_nonzero_taps(h, oh, p[:, 0], p[:, 1]) <= plan.cap_y
    assert _most_nonzero_taps(w, ow, p[:, 2], p[:, 3]) <= plan.cap_x
    assert plan.shared_bytes <= augment.AA_MAX_SHARED_BYTES
    assert 1 <= plan.rows <= oh and 1 <= plan.cols <= ow and plan.span >= 1
    assert plan.group == min(c, 4)


@pytest.mark.parametrize("shape", [(8, 8, 70000, 8, 8), (10 ** 6, 10 ** 6, 3, 1, 1),
                                   (1, 2 ** 20, 4, 1, 3), (5000, 5000, 64, 2, 2)])
def test_aa_plan_fits_a_block_at_any_shape(shape):
    """Past the table sizes a block can hold the plan cuts the span and the
    tap tables (the kernel walks chunks and computes taps past a table)."""
    plan = augment.aa_launch_plan(*shape)
    assert plan.shared_bytes <= augment.AA_MAX_SHARED_BYTES
    assert min(plan) >= 1


def test_aa_plan_at_the_evaluation_resize():
    # one column tile of 224 spans the whole source row; 5 taps cover kernel_scale 8/7
    plan = augment.aa_launch_plan(256, 256, 3, 224, 224)
    assert plan == augment.AaPlan(rows=8, cols=224, cap_y=5, cap_x=5, span=256, group=3)
    assert plan.shared_bytes == 24 * (8 + 224) + 4 * (8 * 256 * 3 + 8 * 224 * 3)
    assert plan.scratch_bytes(256, 224, 224) == 256 * 448 * 24 + 4 * 256 * (224 * 5 + 224 * 5)


def test_launch_refuses_unknown_kernels_and_cpu_tensors():
    images = torch.zeros((2, 8, 8, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="kernel must be one of"):
        augment.launch_resized_crop(images, torch.zeros(2, 4), None, (4, 4), True, kernel="x")
    for kernel in augment.RESIZED_CROP_KERNELS:
        with pytest.raises(ValueError, match="CUDA"):
            augment.launch_resized_crop(images, torch.zeros(2, 4), None, (4, 4), True,
                                        kernel=kernel)


# -- kernel B2: the device half of the hybrid JPEG decode ----------------------


def _jpeg_planes(n, h, w, sampling=None, gray=False, progressive=False, seed=0):
    """Coefficient planes of ``n`` cv2-encoded JPEGs (q90), from the port's
    own entropy decode: (planes, qtabs, layout, streams)."""
    import cv2

    from petastorm_tpu_torch.native import image as native

    rng = np.random.default_rng(seed)
    bufs = []
    for _ in range(n):
        low = rng.integers(0, 256, (7, 7, 3)).astype(np.float32)
        img = cv2.resize(low, (w, h), interpolation=cv2.INTER_CUBIC)
        img = np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(np.uint8)
        params = [int(cv2.IMWRITE_JPEG_QUALITY), 90]
        if sampling is not None:
            params += [int(cv2.IMWRITE_JPEG_SAMPLING_FACTOR), int(getattr(cv2, sampling))]
        if progressive:
            params += [int(cv2.IMWRITE_JPEG_PROGRESSIVE), 1]
        bufs.append(cv2.imencode(".jpeg", img[..., 0] if gray else img, params)[1].tobytes())
    planes, qtabs, layout = native.read_jpeg_coefficients_column(bufs, nthreads=4)
    return planes, qtabs, layout, bufs


# (n, h, w, cv2 sampling flag, grayscale, progressive): the phase-3 shapes of
# chip_smoke.py, and the samplings and widths a tile meets (4:1:1, 4:4:0, a
# row wider than one tile)
JPEG_CASES = {
    "main-420": (256, 224, 224, None, False, False),
    "444": (16, 224, 224, "IMWRITE_JPEG_SAMPLING_FACTOR_444", False, False),
    "422": (16, 224, 224, "IMWRITE_JPEG_SAMPLING_FACTOR_422", False, False),
    "411": (5, 37, 53, "IMWRITE_JPEG_SAMPLING_FACTOR_411", False, False),
    "440": (5, 37, 53, "IMWRITE_JPEG_SAMPLING_FACTOR_440", False, False),
    "gray": (16, 224, 224, None, True, False),
    "37x53": (7, 37, 53, None, False, False),
    "progressive": (16, 224, 224, None, False, True),
    "wide-600": (3, 40, 600, None, False, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("fancy", [True, False], ids=["fancy", "nearest"])
@pytest.mark.parametrize("out_dtype", [torch.uint8, torch.float32], ids=["u8", "f32"])
@pytest.mark.parametrize("case", list(JPEG_CASES))
def test_jpeg_decode_kernel_matches_plain_on_card(case, out_dtype, fancy):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the Hopper kernel has no CPU mode")
    from petastorm_tpu_torch.ops import jpeg

    planes, qtabs, layout, _ = _jpeg_planes(*JPEG_CASES[case])
    dp = [torch.from_numpy(p).cuda() for p in planes]
    dq = torch.from_numpy(qtabs.astype(np.int32)).cuda()
    before = jpeg.jpeg_decode_kernel.launches
    got = jpeg.decode_from_layout(dp, dq, layout, out_dtype, fancy_upsampling=fancy)
    assert jpeg.jpeg_decode_kernel.launches == before + 1
    want = jpeg._decode_reference(dp, dq, (layout.height, layout.width), layout.sampling,
                                  out_dtype, fancy)
    assert got.dtype == want.dtype == out_dtype and got.shape == want.shape
    diff = (got.double() - want.double()).abs()
    if out_dtype == torch.uint8:
        assert diff.max().item() <= 1 and (diff > 0).double().mean().item() <= 1e-3
    else:
        assert diff.max().item() <= 2e-3, diff.max().item()


# the edges of the tiled kernel's plan: one pixel, and a row wider than a tile
JPEG_EDGE_CASES = {"1x1": (2, 1, 1, None, False, False), "17x600": (2, 17, 600, None, False, False)}


@pytest.mark.cuda
@pytest.mark.parametrize("fancy", [True, False], ids=["fancy", "nearest"])
@pytest.mark.parametrize("out_dtype", [torch.uint8, torch.float32], ids=["u8", "f32"])
@pytest.mark.parametrize("case", list(JPEG_CASES) + list(JPEG_EDGE_CASES))
def test_jpeg_tiled_kernel_equals_general_on_card(case, out_dtype, fancy):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the Hopper kernel has no CPU mode")
    from petastorm_tpu_torch.ops import jpeg

    planes, qtabs, layout, _ = _jpeg_planes(*{**JPEG_CASES, **JPEG_EDGE_CASES}[case])
    dp = [torch.from_numpy(p).cuda() for p in planes]
    dq = torch.from_numpy(qtabs.astype(np.int32)).cuda()
    size = (layout.height, layout.width)
    tiled = jpeg.launch_jpeg_decode(dp, dq, size, layout.sampling, out_dtype, fancy,
                                    kernel="tiled")
    general = jpeg.launch_jpeg_decode(dp, dq, size, layout.sampling, out_dtype, fancy,
                                      kernel="general")
    assert tiled.dtype == general.dtype == out_dtype and tiled.shape == general.shape
    if out_dtype == torch.float32:
        tiled, general = tiled.view(torch.int32), general.view(torch.int32)
    assert torch.equal(tiled, general), int((tiled != general).sum())


@pytest.mark.cuda
def test_jpeg_decode_path_takes_the_tiled_kernel_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the Hopper kernel has no CPU mode")
    from petastorm_tpu_torch.ops import jpeg

    planes, qtabs, layout, bufs = _jpeg_planes(4, 37, 53)
    dp = [torch.from_numpy(p).cuda() for p in planes]
    dq = torch.from_numpy(qtabs.astype(np.int32)).cuda()
    k = jpeg.jpeg_decode_kernel
    before = (k.launches, k.launches_tiled, k.launches_general)
    jpeg.decode_from_layout(dp, dq, layout)
    jpeg.decode_jpeg_column(bufs, device="cuda")
    assert (k.launches, k.launches_tiled, k.launches_general) == (
        before[0] + 2, before[1] + 2, before[2])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["main-420", "444", "gray", "37x53", "progressive"])
def test_jpeg_decode_kernel_close_to_cv2_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the Hopper kernel has no CPU mode")
    import cv2

    from petastorm_tpu_torch.ops import jpeg

    n, h, w, sampling, gray, progressive = JPEG_CASES[case]
    _, _, _, bufs = _jpeg_planes(min(n, 16), h, w, sampling, gray, progressive)
    got = jpeg.decode_jpeg_column(bufs, device="cuda").cpu().numpy()
    flag = cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR
    want = np.stack([cv2.imdecode(np.frombuffer(b, np.uint8), flag) for b in bufs])
    if not gray:
        want = want[..., ::-1]  # cv2 decodes to BGR
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 6 and diff.mean() < 1.0, (diff.max(), diff.mean())


@pytest.mark.cuda
def test_jpeg_decode_kernel_refuses_what_it_does_not_take_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the Hopper kernel has no CPU mode")
    from petastorm_tpu_torch.ops import jpeg

    planes, qtabs, layout, _ = _jpeg_planes(2, 37, 53)
    dp = [torch.from_numpy(p).cuda() for p in planes]
    dq = torch.from_numpy(qtabs.astype(np.int32)).cuda()
    with pytest.raises(TypeError):
        jpeg.decode_from_layout(dp, dq, layout, torch.float16)
    with pytest.raises(TypeError):
        jpeg.decode_from_layout([p.int() for p in dp], dq, layout)
    with pytest.raises(ValueError):
        jpeg.decode_from_layout([dp[0].cpu(), dp[1], dp[2]], dq, layout)
    # a plane view off a 16-byte boundary is copied, not refused
    flat = torch.zeros(dp[0].numel() + 1, dtype=torch.int16, device="cuda")
    shifted = flat[1:].view(dp[0].shape)
    shifted.copy_(dp[0])
    got = jpeg.decode_from_layout([shifted, dp[1], dp[2]], dq, layout)
    assert torch.equal(got, jpeg.decode_from_layout(dp, dq, layout))
    # uint16 quant tables as the host half writes them are taken too
    assert torch.equal(jpeg.decode_from_layout(dp, torch.from_numpy(qtabs).cuda(), layout), got)


@pytest.mark.cuda
def test_loader_stages_native_roi_decode_on_card(tmp_path):
    """Host decode with a random decode_roi: the workers decode each image's
    crop window natively, and CudaDataLoader stages the cropped rowgroups
    onto the card equal to a CPU run of the same reader."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from petastorm_tpu_torch import CompressedImageCodec, Field, Schema, make_reader, \
        write_dataset
    from petastorm_tpu_torch.cuda.loader import CudaDataLoader

    rng = np.random.default_rng(0)
    schema = Schema("S", [Field("label", np.int64),
                          Field("image", np.uint8, (45, 61, 3), CompressedImageCodec("jpeg", 90))])
    rows = [{"label": i, "image": rng.integers(0, 256, (45, 61, 3), dtype=np.uint8)}
            for i in range(40)]
    write_dataset(str(tmp_path / "ds"), schema, rows, row_group_size_rows=8)

    def run(device):
        reader = make_reader(str(tmp_path / "ds"), workers_count=3, shuffle_seed=0,
                             num_epochs=1, decode_roi={"image": ("random", 27, 35)})
        with CudaDataLoader(reader, 8, device=device) as loader:
            batches = [{k: v.cpu() for k, v in b.items()} for b in loader]
        return batches, reader.decode_stats()

    card, stats = run("cuda")
    cpu, _ = run("cpu")
    assert stats["roi_images"] == 40 and stats["batch_images"] == 0
    assert len(card) == len(cpu) == 5
    for c, h in zip(card, cpu):
        assert c["image"].shape == (8, 27, 35, 3) and c["image"].dtype == torch.uint8
        assert torch.equal(c["label"], h["label"]) and torch.equal(c["image"], h["image"])


@pytest.mark.cuda
@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_finishes_device_decode_on_card(tmp_path, drop_last):
    """decode_placement='device' through the reader and CudaDataLoader: one
    B2 launch a batch, labels in the host route's order, images within the
    reference's bound of the host route, flat gray padding."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    import cv2

    from petastorm_tpu_torch import CompressedImageCodec, Field, Schema, make_reader, \
        write_dataset
    from petastorm_tpu_torch.cuda.loader import VALID_ROWS, CudaDataLoader
    from petastorm_tpu_torch.ops import jpeg

    rng = np.random.default_rng(0)
    schema = Schema("S", [Field("label", np.int64),
                          Field("image", np.uint8, (37, 53, 3), CompressedImageCodec("jpeg", 90))])
    rows = []
    for i in range(70):
        low = rng.integers(0, 256, (5, 5, 3)).astype(np.float32)
        img = np.clip(cv2.resize(low, (53, 37)) + rng.normal(0, 8, (37, 53, 3)), 0, 255)
        rows.append({"label": i, "image": img.astype(np.uint8)})
    write_dataset(str(tmp_path / "ds"), schema, rows, row_group_size_rows=9)

    def run(place):
        reader = make_reader(str(tmp_path / "ds"), workers_count=3, shuffle_seed=0,
                             num_epochs=1, decode_placement={"image": place})
        with CudaDataLoader(reader, 16, device="cuda", drop_last=drop_last) as loader:
            return [{k: (v.cpu() if torch.is_tensor(v) else v) for k, v in b.items()}
                    for b in loader]

    before = jpeg.jpeg_decode_kernel.launches_tiled
    device = run("device")
    assert jpeg.jpeg_decode_kernel.launches_tiled - before == len(device)
    host = run("host")
    assert len(device) == len(host) == (4 if drop_last else 5)
    for d, h in zip(device, host):
        assert torch.equal(d["label"], h["label"])
        assert d["image"].dtype == torch.uint8 and d["image"].shape == (16, 37, 53, 3)
        n = d.get(VALID_ROWS, 16)
        diff = (d["image"][:n].int() - h["image"][:n].int()).abs()
        assert diff.max().item() <= 6 and diff.float().mean().item() < 1.0
        assert bool((d["image"][n:] == 128).all())


@pytest.mark.cuda
def test_shuffled_device_decode_loader_matches_cpu_run_on_card(tmp_path):
    """The loader's shuffle buffer over coefficient planes, finished by B2 on
    the card, against the same loader on the CPU (B2's plain version): the
    same labels in the same order, the same padded tail and valid mask, and
    images within B2's bound of its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    import cv2

    from petastorm_tpu_torch import CompressedImageCodec, Field, Schema, make_reader, \
        write_dataset
    from petastorm_tpu_torch.cuda.loader import VALID_ROWS, CudaDataLoader
    from petastorm_tpu_torch.ops import jpeg

    rng = np.random.default_rng(1)
    schema = Schema("S", [Field("label", np.int64),
                          Field("image", np.uint8, (37, 53, 3), CompressedImageCodec("jpeg", 90))])
    rows = []
    for i in range(70):
        low = rng.integers(0, 256, (5, 5, 3)).astype(np.float32)
        img = np.clip(cv2.resize(low, (53, 37)) + rng.normal(0, 8, (37, 53, 3)), 0, 255)
        rows.append({"label": i, "image": img.astype(np.uint8)})
    write_dataset(str(tmp_path / "ds"), schema, rows, row_group_size_rows=9)

    def run(device):
        reader = make_reader(str(tmp_path / "ds"), workers_count=3, shuffle_seed=0,
                             num_epochs=1, decode_placement={"image": "device"})
        with CudaDataLoader(reader, 16, device=device, drop_last=False,
                            shuffling_queue_capacity=40, buffer_seed=1,
                            valid_mask_field="mask") as loader:
            return [{k: (v.cpu() if torch.is_tensor(v) else v) for k, v in b.items()}
                    for b in loader]

    before = jpeg.jpeg_decode_kernel.launches_tiled
    card = run("cuda")
    assert jpeg.jpeg_decode_kernel.launches_tiled - before == len(card) == 5
    cpu = run("cpu")
    assert len(cpu) == len(card)
    for c, p in zip(card, cpu):
        assert torch.equal(c["label"], p["label"]) and torch.equal(c["mask"], p["mask"])
        assert c.get(VALID_ROWS) == p.get(VALID_ROWS)
        diff = (c["image"].int() - p["image"].int()).abs()
        assert diff.max().item() <= 1 and (diff > 0).double().mean().item() <= 1e-3
    labels = torch.cat([c["label"][:c.get(VALID_ROWS, 16)] for c in card])
    assert sorted(labels.tolist()) == list(range(70)) and labels.tolist() != list(range(70))


# -- the build's compiler report (no card needed) --------------------------------


PTXAS_REPORT = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z6kernelILi0EEv6Params' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelILi0EEv6Params
    16 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 920 bytes cmem[0]
ptxas info    : Compiling entry function '_Z7generalv' for 'sm_90a'
ptxas info    : Function properties for _Z7generalv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 55 registers, used 1 barriers, 64 bytes smem, 848 bytes cmem[0]
"""


def test_ptxas_report_is_read_per_kernel(tmp_path, monkeypatch):
    from petastorm_tpu_torch.cuda import build

    monkeypatch.setattr(build, "LIB_DIR", str(tmp_path))
    lib = build.lib_path("jpeg_decode")
    open(lib, "w").close()  # stands for the built library
    with open(lib[:-len(".so")] + ".ptxas.txt", "w") as f:
        f.write(PTXAS_REPORT)
    assert build.ptxas_report("jpeg_decode") == {
        "_Z6kernelILi0EEv6Params": {"stack_bytes": 16, "spill_stores": 8, "spill_loads": 4,
                                    "registers": 80, "shared_bytes": 0},
        "_Z7generalv": {"stack_bytes": 0, "spill_stores": 0, "spill_loads": 0,
                        "registers": 55, "shared_bytes": 64}}


def test_sass_counts_need_the_toolkits_cuobjdump(tmp_path, monkeypatch):
    from petastorm_tpu_torch.cuda import build

    monkeypatch.setattr(build, "nvcc_path", lambda: str(tmp_path / "nvcc"))
    assert build.sass_instruction_counts("jpeg_decode") == {}


@pytest.mark.cuda
def test_device_shuffle_loader_on_card(tmp_path):
    """``device_shuffle_capacity`` on the card, after B2 on the copy stream:
    every row once (each label's image equal to the unshuffled run's), in
    another order, the same order again for the same seed, the padded tail
    last; a push of the buffer alone synchronizes nothing with the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from petastorm_tpu_torch import CompressedImageCodec, Field, Schema, make_reader, \
        write_dataset
    from petastorm_tpu_torch.cuda.device_buffer import DeviceShufflingBuffer
    from petastorm_tpu_torch.cuda.loader import VALID_ROWS, CudaDataLoader

    rng = np.random.default_rng(0)
    schema = Schema("S", [Field("label", np.int64),
                          Field("image", np.uint8, (48, 64, 3), CompressedImageCodec("jpeg", 90))])
    write_dataset(str(tmp_path / "ds"), schema,
                  [{"label": i, "image": rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)}
                   for i in range(100)], row_group_size_rows=8)

    def run(**kwargs):
        reader = make_reader(str(tmp_path / "ds"), workers_count=3, shuffle_seed=0,
                             num_epochs=1, decode_placement={"image": "device"})
        with CudaDataLoader(reader, 8, device="cuda", drop_last=False, **kwargs) as loader:
            batches = [{k: (v.cpu() if isinstance(v, torch.Tensor) else v)
                        for k, v in b.items()} for b in loader]
        labels = torch.cat([b["label"][:b.get(VALID_ROWS, 8)] for b in batches])
        images = torch.cat([b["image"][:b.get(VALID_ROWS, 8)] for b in batches])
        return batches, labels, images

    plain, plain_labels, plain_images = run()
    batches, labels, images = run(device_shuffle_capacity=4, device_shuffle_seed=3)
    assert [VALID_ROWS in b for b in batches] == [False] * 12 + [True]
    assert sorted(labels.tolist()) == sorted(plain_labels.tolist()) == list(range(100))
    assert labels.tolist() != plain_labels.tolist()
    by_label = plain_images[torch.argsort(plain_labels)]
    assert torch.equal(images, by_label[labels])
    _, again, _ = run(device_shuffle_capacity=4, device_shuffle_seed=3)
    assert torch.equal(again, labels)

    buf = DeviceShufflingBuffer(4, seed=0, device="cuda")
    batch = {"image": torch.zeros((256, 224, 224, 3), dtype=torch.uint8, device="cuda"),
             "label": torch.arange(256, device="cuda")}
    for _ in range(4):
        buf.push(batch)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(8):
            out = buf.push(batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out["image"].shape == (256, 224, 224, 3) and out["label"].shape == (256,)


@pytest.mark.cuda
def test_scan_graph_replay_equals_eager_loop_on_the_card():
    """On the card: the captured K-step graph against the same unit run as K
    eager steps from the same weights, momentum and draws.  Draws equal bit
    for bit; losses and leaves within twice the spread of two eager runs
    (cuDNN's backward need not be bit-deterministic; a spread of 0 asks for
    equality)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    classes, side, scan_k = 10, 32, 3
    model = ResNet([1, 1], num_classes=classes, num_filters=8, dtype=torch.bfloat16,
                   device="cuda", generator=torch.Generator().manual_seed(0))
    step = trainer.TrainStep(model, classes, side,
                             generator=torch.Generator(device="cuda").manual_seed(17))
    scan = trainer.ScanStep(step, scan_k)
    gen = torch.Generator(device="cuda").manual_seed(3)
    images = torch.randint(0, 256, (scan_k, 8, 40, 48, 3), dtype=torch.uint8, device="cuda",
                           generator=gen)
    labels = torch.randint(0, classes, (scan_k, 8), device="cuda", generator=gen)
    scan(images, labels)  # warm-up and capture
    scan(images, labels)
    snapshot = ([t.detach().clone() for t in step.leaves + step.momentum()],
                step.generator.get_state())

    def restore():
        with torch.no_grad():
            for t, saved in zip(step.leaves + step.momentum(), snapshot[0]):
                t.copy_(saved)
        step.generator.set_state(snapshot[1])

    def flat():
        return torch.cat([t.detach().flatten().double() for t in step.leaves])

    restore()
    graph_losses = scan(images, labels).double()
    graph_draws = scan.last_draws
    graph_leaves = flat()
    eager = []
    for _ in range(2):
        restore()
        losses, draws = [], []
        for k in range(scan_k):
            losses.append(step(images[k], labels[k]))
            draws.append(step.last_draws)
        eager.append((torch.stack(losses).double(), flat(),
                      torch.stack([b for b, _ in draws]), torch.stack([f for _, f in draws])))
    assert torch.equal(graph_draws[0], eager[0][2]) and torch.equal(graph_draws[1], eager[0][3])
    loss_spread = (eager[0][0] - eager[1][0]).abs().max().item()
    leaf_spread = (eager[0][1] - eager[1][1]).abs().max().item()
    assert (graph_losses - eager[0][0]).abs().max().item() <= 2 * loss_spread
    assert (graph_leaves - eager[0][1]).abs().max().item() <= 2 * leaf_spread
    assert scan.replays == 2


@pytest.mark.cuda
def test_filtered_device_decode_loader_matches_cpu_run_on_card(tmp_path):
    """Phase 15's loader path at a small size: a rowgroup selector, a
    pseudorandom split and row-drop partitions over a device-decode reader,
    B2 on the card against the same loader on the CPU (B2's plain version):
    the same labels in the same order, one B2 launch a batch, images within
    B2's bound of its plain version, and only the surviving rows
    entropy-decoded.  Then two shards in ``shard_mode='epoch'``: disjoint in
    each epoch, their union the filtered set, dealt differently each epoch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    import shutil

    from petastorm_tpu_torch import CompressedImageCodec, Field, Schema, make_reader, \
        write_dataset
    from petastorm_tpu_torch.cuda.loader import CudaDataLoader
    from petastorm_tpu_torch.etl.indexing import SingleFieldIndexer, build_rowgroup_index
    from petastorm_tpu_torch.ops import jpeg
    from petastorm_tpu_torch.predicates import in_pseudorandom_split
    from petastorm_tpu_torch.selectors import SingleIndexSelector

    rng = np.random.default_rng(2)
    labels = rng.permutation(128)
    schema = Schema("S", [Field("label", np.int64),
                          Field("image", np.uint8, (40, 48, 3), CompressedImageCodec("jpeg", 90))])
    write_dataset(str(tmp_path / "ds"), schema,
                  [{"label": int(v), "image": rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)}
                   for v in labels], row_group_size_rows=16)
    path = str(tmp_path / "indexed")
    shutil.copytree(str(tmp_path / "ds"), path)
    build_rowgroup_index(path, [SingleFieldIndexer("label_ix", "label")])
    kept_groups = [0, 1, 3, 4, 6, 7]
    split = in_pseudorandom_split([0.75, 0.25], 0, "label")
    want = {int(v) for g in kept_groups for v in labels[g * 16:(g + 1) * 16]
            if split.do_include({"label": int(v)})}

    def kwargs(**extra):
        return dict(workers_count=3, shuffle_seed=0, decode_placement={"image": "device"},
                    rowgroup_selector=SingleIndexSelector(
                        "label_ix", [int(labels[g * 16]) for g in kept_groups]),
                    predicate=in_pseudorandom_split([0.75, 0.25], 0, "label"),
                    shuffle_row_drop_partitions=2, **extra)

    def run(device, **extra):
        reader = make_reader(path, **kwargs(**extra))
        with CudaDataLoader(reader, 8, device=device) as loader:
            batches = [{k: (v.cpu() if torch.is_tensor(v) else v) for k, v in b.items()}
                       for b in loader]
        return batches, reader

    before = jpeg.jpeg_decode_kernel.launches_tiled
    card, reader = run("cuda", num_epochs=2)
    assert jpeg.jpeg_decode_kernel.launches_tiled - before == len(card) == 2 * len(want) // 8
    assert reader.decode_stats()["coef_batch_images"] == 2 * len(want)
    cpu, _ = run("cpu", num_epochs=2)
    assert len(cpu) == len(card)
    for c, p in zip(card, cpu):
        assert torch.equal(c["label"], p["label"])
        diff = (c["image"].int() - p["image"].int()).abs()
        assert diff.max().item() <= 1 and (diff > 0).double().mean().item() <= 1e-3
    assert set(torch.cat([c["label"] for c in card]).tolist()) <= want

    deals = []
    for shard in range(2):
        reader = make_reader(path, **kwargs(num_epochs=2, shard_mode="epoch", cur_shard=shard,
                                            shard_count=2))
        with reader:
            per_epoch = [set(), set()]
            for b in reader.iter_batches():
                # the cursor names the epoch of the item just delivered
                epoch = (reader.state_dict()["position"] - 1) // reader._items_per_epoch
                per_epoch[epoch].update(b.columns["label"].tolist())
        deals.append(per_epoch)
    for epoch in range(2):
        assert not deals[0][epoch] & deals[1][epoch]
        assert deals[0][epoch] | deals[1][epoch] == want
    assert deals[0][0] != deals[0][1]


@pytest.mark.cuda
def test_stacked_ngram_batches_on_the_card_equal_the_cpu_delivery(tmp_path):
    """Phase 18's loader path at a small size: a stacked NGram over a host
    decode reader with two drop partitions; each (batch, k, H, W, 3) uint8
    frame tensor staged on the card equals the CPU delivery byte for byte,
    and its timestamps step by one inside every window."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from petastorm_tpu_torch import CompressedImageCodec, Field, Schema, make_reader, \
        write_dataset
    from petastorm_tpu_torch.cuda.loader import CudaDataLoader
    from petastorm_tpu_torch.ngram import NGram

    rng = np.random.default_rng(3)
    schema = Schema("Frames", [Field("ts", np.int64), Field("label", np.int64),
                               Field("frame", np.uint8, (32, 40, 3),
                                     CompressedImageCodec("jpeg", 90))])
    # rowgroups of 32 frames, two clips of 16 consecutive timestamps each
    rows = [{"ts": (i // 16) * 1000 + i % 16, "label": i // 16,
             "frame": rng.integers(0, 256, (32, 40, 3), dtype=np.uint8)} for i in range(128)]
    path = str(tmp_path / "frames")
    write_dataset(path, schema, rows, row_group_size_rows=32)
    ngram = NGram({0: ["frame", "ts", "label"], 1: ["frame", "ts"], 2: ["frame", "ts"]},
                  delta_threshold=1, timestamp_field="ts", stack_timesteps=True)

    def run(device):
        reader = make_reader(path, workers_count=3, shuffle_seed=0, ngram=ngram,
                             shuffle_row_drop_partitions=2)
        with CudaDataLoader(reader, 8, device=device) as loader:
            return [{k: v.cpu() for k, v in b.items()} for b in loader]

    card, cpu = run("cuda"), run("cpu")
    assert len(card) == len(cpu) == 4 * 2 * 14 // 8  # 14 windows a clip
    for c, p in zip(card, cpu):
        assert c["frame"].shape == (8, 3, 32, 40, 3) and c["frame"].dtype == torch.uint8
        for k in ("frame", "ts", "0/label"):
            assert torch.equal(c[k], p[k]), k
        assert torch.equal(c["ts"], c["ts"][:, :1] + torch.arange(3))


@pytest.mark.cuda
def test_device_decode_mix_on_the_card_matches_the_plain_path(tmp_path):
    """Phase 17's feed at a small size: two device-decode readers mixed
    0.75/0.25 through the loader, B2 on the card against the same mix on
    the CPU (B2's plain version): the same labels in the same order, one B2
    launch a batch, images within B2's bound of its plain version, and the
    same mixture digest."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from petastorm_tpu_torch import CompressedImageCodec, Field, Schema, make_reader, \
        write_dataset
    from petastorm_tpu_torch.cuda.loader import CudaDataLoader
    from petastorm_tpu_torch.ops import jpeg
    from petastorm_tpu_torch.weighted_sampling import WeightedSamplingReader

    rng = np.random.default_rng(4)
    schema = Schema("S", [Field("label", np.int64),
                          Field("image", np.uint8, (40, 48, 3), CompressedImageCodec("jpeg", 90))])
    paths = []
    for src, n in enumerate((96, 48)):
        paths.append(str(tmp_path / f"c{src}"))
        write_dataset(paths[-1], schema,
                      [{"label": 1000 * src + i,
                        "image": rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)}
                       for i in range(n)], row_group_size_rows=16)

    def run(device):
        readers = [make_reader(p, workers_count=3, shuffle_seed=i,
                               decode_placement={"image": "device"})
                   for i, p in enumerate(paths)]
        mixed = WeightedSamplingReader(readers, [0.75, 0.25], seed=1)
        with CudaDataLoader(mixed, 16, device=device) as loader:
            batches = [{k: v.cpu() for k, v in b.items()} for b in loader]
        return batches, mixed.mixture_digest

    before = jpeg.jpeg_decode_kernel.launches_tiled
    card, card_digest = run("cuda")
    assert jpeg.jpeg_decode_kernel.launches_tiled - before == len(card) == 9
    cpu, cpu_digest = run("cpu")
    assert card_digest == cpu_digest and card_digest["draw_count"] == 11
    for c, p in zip(card, cpu):
        assert torch.equal(c["label"], p["label"])
        diff = (c["image"].int() - p["image"].int()).abs()
        assert diff.max().item() <= 1 and (diff > 0).double().mean().item() <= 1e-3


@pytest.mark.cuda
def test_skipped_rowgroups_on_the_device_decode_route_on_the_card(tmp_path):
    """Phase 20's route at a small size: one JPEG cell cut inside its header
    and one garbage file under ``on_error='skip'``; the card's loader (B2)
    delivers the CPU loader's labels in its order, one B2 launch a batch,
    images within B2's bound of its plain version, and both quarantine the
    same two rowgroups."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    import os

    import pyarrow as pa
    import pyarrow.parquet as pq

    from petastorm_tpu_torch import CompressedImageCodec, Field, Schema, make_reader, \
        write_dataset
    from petastorm_tpu_torch.cuda.loader import CudaDataLoader
    from petastorm_tpu_torch.ops import jpeg

    rng = np.random.default_rng(5)
    schema = Schema("S", [Field("label", np.int64),
                          Field("image", np.uint8, (40, 48, 3), CompressedImageCodec("jpeg", 90))])
    path = str(tmp_path / "ds")
    write_dataset(path, schema, [{"label": i, "image": rng.integers(0, 256, (40, 48, 3),
                                                                   dtype=np.uint8)}
                                 for i in range(128)], row_group_size_rows=16, rows_per_file=16)
    files = sorted(os.path.join(path, f) for f in os.listdir(path) if f.endswith(".parquet"))
    table = pq.ParquetFile(files[2]).read()
    cells = table.column("image").to_pylist()
    cells[3] = cells[3][:40]
    pq.write_table(table.set_column(1, "image", pa.array(cells, pa.binary())), files[2])
    with open(files[5], "wb") as f:
        f.write(b"\x13" * 1000)

    def run(device):
        reader = make_reader(path, workers_count=3, shuffle_seed=0, on_error="skip",
                             decode_placement={"image": "device"})
        with CudaDataLoader(reader, 16, device=device) as loader:
            batches = [{k: v.cpu() for k, v in b.items()} for b in loader]
            diag = loader.diagnostics()
        return batches, diag, reader

    before = jpeg.jpeg_decode_kernel.launches_tiled
    card, card_diag, reader = run("cuda")
    assert jpeg.jpeg_decode_kernel.launches_tiled - before == len(card) == 6
    assert reader.state_dict()["position"] == 8
    cpu, cpu_diag, _ = run("cpu")
    assert card_diag["quarantined_rowgroups"] == cpu_diag["quarantined_rowgroups"]
    assert sorted(e["path"] for e in card_diag["quarantined_rowgroups"]) == [files[2], files[5]]
    for c, p in zip(card, cpu):
        assert torch.equal(c["label"], p["label"])
        diff = (c["image"].int() - p["image"].int()).abs()
        assert diff.max().item() <= 1 and (diff > 0).double().mean().item() <= 1e-3


@pytest.mark.cuda
def test_partitioned_read_with_pushdown_on_the_card(tmp_path):
    """Phase 19's feed at a small size: a ``partition_by`` dataset with a
    ``CompressedNdarrayCodec`` host field, a predicate pushed down to the
    partitions, B2 on the card against the CPU loader: the kept splits'
    labels in the same order, their masks as written, images within B2's
    bound."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from petastorm_tpu_torch import CompressedImageCodec, CompressedNdarrayCodec, Field, \
        Schema, make_reader, write_dataset
    from petastorm_tpu_torch.cuda.loader import CudaDataLoader
    from petastorm_tpu_torch.ops import jpeg
    from petastorm_tpu_torch.predicates import in_set

    rng = np.random.default_rng(6)
    schema = Schema("S", [Field("label", np.int64), Field("split", np.int64),
                          Field("image", np.uint8, (40, 48, 3), CompressedImageCodec("jpeg", 90)),
                          Field("mask", np.uint8, (6, 6), CompressedNdarrayCodec())])
    rows = [{"label": i, "split": i % 4, "image": rng.integers(0, 256, (40, 48, 3), np.uint8),
             "mask": np.full((6, 6), i % 251, np.uint8)} for i in range(128)]
    path = str(tmp_path / "parts")
    write_dataset(path, schema, rows, partition_by=["split"], row_group_size_rows=16)

    def run(device):
        reader = make_reader(path, workers_count=3, shuffle_seed=0,
                             decode_placement={"image": "device"},
                             predicate=in_set({1, 3}, "split"))
        with CudaDataLoader(reader, 16, device=device, host_fields=["mask"]) as loader:
            return [{k: (v.cpu() if torch.is_tensor(v) else v) for k, v in b.items()}
                    for b in loader]

    before = jpeg.jpeg_decode_kernel.launches_tiled
    card = run("cuda")
    assert jpeg.jpeg_decode_kernel.launches_tiled - before == len(card) == 4
    cpu = run("cpu")
    for c, p in zip(card, cpu):
        assert torch.equal(c["label"], p["label"]) and torch.equal(c["split"], p["split"])
        assert set(c["split"].tolist()) <= {1, 3}
        np.testing.assert_array_equal(c["mask"][:, 0, 0], c["label"].numpy() % 251)
        diff = (c["image"].int() - p["image"].int()).abs()
        assert diff.max().item() <= 1 and (diff > 0).double().mean().item() <= 1e-3


@pytest.mark.cuda
def test_mixed_geometry_arena_decode_on_the_card_matches_the_plain_path(tmp_path):
    """``decode_placement='device-mixed'`` at a small size: four geometries
    (two 4:2:0 sizes, a 4:4:4 one and grayscale) in one (None, None, 3)
    field, staged through the pinned arena and decoded by B2 a bucket on the
    card, against the same loader on the CPU (B2's plain version on views of
    an unpinned arena): the same rows in the same order, one B2 launch a
    bucket, images within B2's bound, the pad region zero, grayscale rows
    with three equal channels; then a stacked run (``stack_batches=2``)
    equal to the flat one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    import os

    import cv2
    import pyarrow as pa
    import pyarrow.parquet as pq

    from petastorm_tpu_torch import CompressedImageCodec, Field, Schema, make_batch_reader
    from petastorm_tpu_torch.cuda.loader import CudaDataLoader
    from petastorm_tpu_torch.etl.writer import stamp_dataset_metadata
    from petastorm_tpu_torch.ops import jpeg

    rng = np.random.default_rng(7)
    kinds = [((40, 56), None, False), ((56, 40), None, False),
             ((48, 48), cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, False), ((40, 56), None, True)]
    bufs, geometry = [], []
    for i in range(96):
        (h, w), sampling, gray = kinds[rng.integers(0, len(kinds))]
        img = cv2.resize(rng.integers(0, 256, (5, 5, 3)).astype(np.float32), (w, h))
        img = np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(np.uint8)
        params = [int(cv2.IMWRITE_JPEG_QUALITY), 90]
        if sampling is not None:
            params += [int(cv2.IMWRITE_JPEG_SAMPLING_FACTOR), int(sampling)]
        bufs.append(cv2.imencode(".jpeg", img[..., 0] if gray else img, params)[1].tobytes())
        geometry.append((h, w, gray))
    schema = Schema("S", [Field("idx", np.int64),
                          Field("image", np.uint8, (None, None, 3), CompressedImageCodec("jpeg"))])
    path = str(tmp_path / "ds")
    os.makedirs(path)
    pq.write_table(pa.Table.from_pylist([{"idx": i, "image": b} for i, b in enumerate(bufs)],
                                        schema=schema.as_arrow_schema()),
                   os.path.join(path, "part-00000.parquet"), row_group_size=16)
    stamp_dataset_metadata(path, schema)

    def run(device, stack=1):
        reader = make_batch_reader(path, workers_count=3, shuffle_seed=0,
                                   decode_placement={"image": "device-mixed"})
        with CudaDataLoader(reader, 16, device=device, pad_shapes={"image": (56, 56, 3)},
                            stack_batches=stack) as loader:
            units = [{k: v.cpu() for k, v in b.items()} for b in loader]
            return units, loader.diagnostics()

    before = jpeg.jpeg_decode_kernel.launches_tiled
    card, diag = run("cuda")
    assert jpeg.jpeg_decode_kernel.launches_tiled - before == diag["mixed_buckets"]
    assert diag["mixed_decode_geometries"] == {"image": 4}
    cpu, _ = run("cpu")
    assert len(card) == len(cpu) == 6
    for c, p in zip(card, cpu):
        assert torch.equal(c["idx"], p["idx"])
        diff = (c["image"].int() - p["image"].int()).abs()
        assert diff.max().item() <= 1 and (diff > 0).double().mean().item() <= 1e-3
        for i, img in zip(c["idx"].tolist(), c["image"]):
            h, w, gray = geometry[i]
            assert not img[h:].any() and not img[:, w:].any()
            if gray:
                assert torch.equal(img[..., 0], img[..., 1])
                assert torch.equal(img[..., 0], img[..., 2])
    stacked, _ = run("cuda", stack=2)
    assert torch.equal(torch.cat([u["image"].flatten(0, 1) for u in stacked]),
                       torch.cat([c["image"] for c in card]))


def _token_corpus(path, n_docs, seed, rows_per_group=32):
    """A token corpus written by the port: lognormal lengths (median 24, cut
    at 200), int32 ids in [0, 50257)."""
    from petastorm_tpu_torch import Field, Schema, write_dataset
    from petastorm_tpu_torch.sequence import token_field

    rng = np.random.default_rng(seed)
    lengths = np.clip(rng.lognormal(np.log(24), 0.9, n_docs), 1, 200).astype(np.int64)
    rows = [{"doc_id": i, "tokens": rng.integers(0, 50257, int(n), dtype=np.int32)}
            for i, n in enumerate(lengths)]
    write_dataset(path, Schema("Tokens", [Field("doc_id", np.int64), token_field()]), rows,
                  row_group_size_rows=rows_per_group)


@pytest.mark.cuda
def test_packed_token_feed_on_the_card_equals_the_cpu_packing(tmp_path):
    """``make_packed_sequence_loader(device="cuda")`` over a 0.8 / 0.2
    mixture: every column on the card with its dtype, the batches equal to
    the same loader's on the CPU, and the valid rows' digest equal to
    ``iter_packed_blocks`` over the mixed document stream on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from petastorm_tpu_torch.sequence import (iter_documents, iter_packed_blocks,
                                              make_mixed_sequence_reader,
                                              make_packed_sequence_loader,
                                              packed_stream_digest)

    urls = [str(tmp_path / "a"), str(tmp_path / "b")]
    _token_corpus(urls[0], 400, 1)
    _token_corpus(urls[1], 100, 2)
    kwargs = dict(batch_size=8, seq_len=128, weights=[0.8, 0.2], seed=7, long_docs="split",
                  loader_kwargs=dict(drop_last=False))

    def run(device):
        with make_packed_sequence_loader(urls, device=device, **kwargs) as loader:
            out = []
            for batch in loader:
                for name in ("tokens", "segment_ids", "positions", "loss_mask"):
                    assert batch[name].device.type == torch.device(device).type
                    assert batch[name].shape == (8, 128)
                out.append({k: (v if k == "_valid_rows" else v.cpu()) for k, v in batch.items()})
            return out

    card, cpu = run("cuda"), run("cpu")
    assert len(card) == len(cpu) > 10
    for c, p in zip(card, cpu):
        assert c.keys() == p.keys()
        for k in c:
            assert (c[k] == p[k]) if k == "_valid_rows" else torch.equal(c[k], p[k])
    assert {k: v.dtype for k, v in card[0].items()} == {
        "tokens": torch.int32, "segment_ids": torch.int32, "positions": torch.int32,
        "loss_mask": torch.float32}
    valid = [{k: v[:b.get("_valid_rows", 8)].numpy() for k, v in b.items()
              if k != "_valid_rows"} for b in card]
    with make_mixed_sequence_reader(urls, weights=[0.8, 0.2], seed=7,
                                    reader_pool_type="serial") as mixer:
        want = packed_stream_digest(iter_packed_blocks(iter_documents(mixer), 128, 8,
                                                       long_docs="split"))
    assert packed_stream_digest(valid) == want


@pytest.mark.cuda
def test_mnist_step_on_the_card_matches_the_plain_step(tmp_path):
    """Two MNIST steps on the card (B1 once a step, no plain normalize) from
    the weights of two on the CPU (the plain normalize), on the same
    batches of uniform random digits: the losses within 1e-5 relative, the
    accuracies equal, every leaf within 1e-6 + 2e-2 * lr.  B1 fuses its
    multiply-add and the plain version does not, so at ``mean=std=0.5`` the
    two differ by one bf16 ulp on uint8 level 127 (0.8 % of its value); Adam
    moves a weight by about ``lr * g / |g|``, so where a first-layer
    gradient lies near zero that input difference moves the update by a
    share of ``lr``.  Measured on an H100: 9.76e-6 (0.98 % of lr) on
    ``dense.0.weight``; the other leaves within the float32 summation
    bound of ``tests/test_torch_mlp.py``, 1e-6 + 1e-3 * lr."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from petastorm_tpu_torch.examples.mnist import train_mnist_cuda as mnist

    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (2, 32, 28, 28)).astype(np.uint8)
    digits = rng.integers(0, 10, (2, 32)).astype(np.int64)
    card, cpu = mnist.make_step("cuda"), mnist.make_step("cpu")
    card.model.load_state_dict(cpu.model.state_dict())
    calls = []
    real_plain = torch_normalize._normalize_reference

    def counting_plain(x, *args):
        calls.append(x.device.type)
        return real_plain(x, *args)

    torch_normalize._normalize_reference = counting_plain
    try:
        before = torch_normalize.normalize_kernel.launches
        for i in range(2):
            loss, acc = card(torch.from_numpy(images[i]).cuda(), torch.from_numpy(digits[i]).cuda())
            want_loss, want_acc = cpu(torch.from_numpy(images[i]), torch.from_numpy(digits[i]))
            assert abs(loss.item() - want_loss.item()) <= 1e-5 * abs(want_loss.item())
            assert acc.item() == want_acc.item()
        assert torch_normalize.normalize_kernel.launches - before == 2
    finally:
        torch_normalize._normalize_reference = real_plain
    assert calls == ["cpu", "cpu"]
    want = cpu.model.state_dict()
    for key, value in card.model.state_dict().items():
        err = (value.cpu() - want[key]).abs().max().item()
        assert err <= 1e-6 + (2e-2 if key == "dense.0.weight" else 1e-3) * 1e-3, (key, err)
