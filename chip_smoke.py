"""Drives the PyTorch/CUDA port on one NVIDIA GPU and checks it.

Run from the root of a checkout with ``python3 chip_smoke.py`` on a machine
with a CUDA GPU and ``nvcc``.  Phases, each printing one line:

1. env: torch/CUDA versions, and the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives them;
2. build: every ``petastorm_tpu_torch/csrc/*.cu`` compiled from the checkout,
   one ``nvcc`` per source, all at once;
3. kernels: each kernel against its plain PyTorch version on the card at the
   main path's shapes (and ragged and unaligned ones), with its time, the
   plain version's time and the least time the card could take;
4. main path: an ImageNet-shaped JPEG dataset (4096 rows of 224x224x3, 16
   rowgroups) through ``make_reader`` -> ``CudaDataLoader(batch_size=256)`` ->
   ``normalize_images`` -> ``ResNet50`` (bf16, seeded random weights) for one
   epoch: samples/s, the consumer's input-wait share, peak device memory, the
   delivered labels against the written ones, finite logits, the kernels'
   launch counts, and the first images' logits against a float32 run of the
   plain path.

Then a ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": ...}``.
Any failed check raises, so the script exits non-zero and prints no result;
without a CUDA GPU it exits non-zero at once.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

if __name__ == "__main__" and not torch.cuda.is_available():
    sys.exit("chip_smoke.py needs a CUDA GPU: torch.cuda.is_available() is False")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from petastorm_tpu_torch import CompressedImageCodec, Field, Schema, make_reader, write_dataset  # noqa: E402
from petastorm_tpu_torch.cuda import build  # noqa: E402
from petastorm_tpu_torch.cuda.loader import CudaDataLoader  # noqa: E402
from petastorm_tpu_torch.models import ResNet50  # noqa: E402
from petastorm_tpu_torch.ops import normalize  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
N_ROWS, ROWS_PER_GROUP, BATCH, WARMUP_STEPS = 4096, 256, 256, 2
MAIN_SHAPE = (BATCH, 224, 224, 3)


def phase(name, **fields):
    print(json.dumps({"phase": name, **fields}), flush=True)


def time_ms(fn, samples=21, launches=10, warmup=3):
    """Median over ``samples`` of the mean time of ``launches`` back-to-back
    launches between two CUDA events, after warm-up (back to back, the card
    does not wait on the host's launch overhead)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return float(np.median(times))


def ulp(x, mantissa_bits):
    exp = torch.floor(torch.log2(torch.clamp(x.abs(), min=2.0 ** -126)))
    return torch.pow(2.0, exp - mantissa_bits)


def check_normalize(x, mean, std, out_dtype):
    """Kernel vs plain version; bound: 2 float32 ulp at max(|out|, |bias|)
    (FMA contraction), plus 1 ulp of a narrower output type at |out|."""
    scale, bias = normalize.channel_constants(mean, std, x.shape[-1])
    got = normalize.normalize_images(x, mean, std, out_dtype).float()
    want = normalize._normalize_reference(x, scale, bias, out_dtype).float()
    torch.cuda.synchronize()
    b = torch.from_numpy(np.abs(bias)).to(x.device)
    bound = 2 * ulp(torch.maximum(want.abs(), b), 23)
    if out_dtype != torch.float32:
        bound = bound + ulp(want, {torch.bfloat16: 7, torch.float16: 10}[out_dtype])
    err = (got - want).abs()
    if not bool((err <= bound).all()):
        raise AssertionError(f"normalize kernel disagrees at {tuple(x.shape)} {out_dtype}:"
                             f" max err {err.max().item()}")
    return err.max().item()


def kernels_phase():
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for shape, dtypes in [(MAIN_SHAPE, (torch.bfloat16, torch.float32)),
                          ((7, 225, 223, 3), (torch.bfloat16, torch.float32, torch.float16)),
                          ((5, 31, 17, 1), (torch.bfloat16, torch.float32)),
                          ((3, 16, 16, 4), (torch.bfloat16, torch.float32))]:
        c = shape[-1]
        mean, std = ((MEAN, STD) if c == 3 else
                     ((0.5, 0.4, 0.3, 0.6)[:c], (0.2, 0.25, 0.3, 0.35)[:c]))
        x = torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda", generator=gen)
        flat = torch.randint(0, 256, (x.numel() + 1,), dtype=torch.uint8, device="cuda",
                             generator=gen)
        unaligned = flat[1:].view(shape)  # starts one byte past an aligned address
        for dt in dtypes:
            results[f"{shape} {dt}"] = check_normalize(x, mean, std, dt)
        results[f"{shape} unaligned bf16"] = check_normalize(unaligned, mean, std,
                                                             torch.bfloat16)
    x = torch.randint(0, 256, MAIN_SHAPE, dtype=torch.uint8, device="cuda", generator=gen)
    try:
        normalize.normalize_images(x, MEAN, STD, out_dtype=torch.float64)
        raise AssertionError("normalize kernel accepted a float64 output")
    except TypeError:
        pass
    scale, bias = normalize.channel_constants(MEAN, STD, 3)
    n = x.numel()
    bound_ms = 1e3 * max(3 * n / HBM_BYTES_PER_S, 2 * n / F32_FLOPS_PER_S)
    entry = {
        "name": "normalize_u8", "route": "cuda",
        "source": "petastorm_tpu_torch/csrc/normalize.cu",
        "replaces": "petastorm_tpu/ops/normalize.py:44",
        "max_abs_err": results[f"{MAIN_SHAPE} {torch.bfloat16}"],
        "ms": time_ms(lambda: normalize.normalize_kernel(x, scale, bias, torch.bfloat16)),
        "plain_ms": time_ms(lambda: normalize._normalize_reference(x, scale, bias,
                                                                   torch.bfloat16)),
        "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
    }
    phase("kernels", normalize_u8={"max_abs_err": results, "ms": entry["ms"],
                                   "plain_ms": entry["plain_ms"], "bound_ms": bound_ms,
                                   "shape": list(MAIN_SHAPE), "out": "bfloat16"})
    return {"normalize_u8": entry}


def smooth_image(rng):
    """A smooth random field plus noise, so JPEG sizes look like photographs'."""
    import cv2

    low = rng.integers(0, 256, (7, 7, 3)).astype(np.float32)
    img = cv2.resize(low, (224, 224), interpolation=cv2.INTER_CUBIC)
    img += rng.normal(0.0, 8.0, img.shape).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def main_path_phase(tmp, kernels):
    cores = os.cpu_count() or 2
    rng = np.random.default_rng(0)
    labels = rng.permutation(N_ROWS).astype(np.int64)
    schema = Schema("ImageNetJpeg", [
        Field("label", np.int64),
        Field("image", np.uint8, (224, 224, 3), CompressedImageCodec("jpeg", quality=90)),
    ])
    path = os.path.join(tmp, "imagenet_jpeg")
    t0 = time.perf_counter()
    write_dataset(path, schema, ({"label": int(lab), "image": smooth_image(rng)}
                                 for lab in labels),
                  row_group_size_rows=ROWS_PER_GROUP, encode_workers=cores)
    data_bytes = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
    write_s = time.perf_counter() - t0

    model = ResNet50(num_classes=1000, dtype=torch.bfloat16, device="cuda",
                     generator=torch.Generator().manual_seed(0))
    model = model.to(memory_format=torch.channels_last)
    workers = max(1, min(cores - 1, 16))
    reader = make_reader(path, workers_count=workers, shuffle_seed=0, num_epochs=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    normalize.normalize_kernel.launches = 0
    delivered, steps, first = [], 0, None
    with CudaDataLoader(reader, batch_size=BATCH, device="cuda") as loader, \
            torch.inference_mode():
        start = time.perf_counter()
        for batch in loader:
            logits = model(normalize.normalize_images(batch["image"], MEAN, STD))
            delivered.append(batch["label"])
            if not bool(torch.isfinite(logits).all()) or logits.shape != (BATCH, 1000):
                raise AssertionError(f"step {steps}: bad logits {tuple(logits.shape)}")
            if first is None:
                first = (batch["image"][:8].clone(), logits[:8].float().clone())
            steps += 1
            if steps == WARMUP_STEPS:
                torch.cuda.synchronize()
                timed_start, wait0 = time.perf_counter(), loader.diagnostics()["consumer_wait_s"]
        torch.cuda.synchronize()
        end = time.perf_counter()
        wait = loader.diagnostics()["consumer_wait_s"] - wait0
    launches = {"normalize_u8": normalize.normalize_kernel.launches}
    peak = torch.cuda.max_memory_allocated()

    want_steps = N_ROWS // BATCH
    if steps != want_steps:
        raise AssertionError(f"{steps} steps, expected {want_steps}")
    for name, count in launches.items():
        if count != steps:
            raise AssertionError(f"kernel {name} launched {count} times in {steps} steps")
        kernels[name]["launches"] = count
    got_labels = torch.sort(torch.cat(delivered)).values.cpu().numpy()
    if not np.array_equal(got_labels, np.sort(labels)):
        raise AssertionError("labels delivered over the epoch differ from the labels written")

    # the plain path in float32 (TF32 off) on the first images of the epoch:
    # bf16 rounds every layer, so logits agree within 5 % of the largest + 0.02
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ref_model = ResNet50(num_classes=1000, dtype=torch.float32, device="cuda",
                         generator=torch.Generator().manual_seed(0))
    scale, bias = normalize.channel_constants(MEAN, STD, 3)
    with torch.inference_mode():
        ref = ref_model(normalize._normalize_reference(first[0], scale, bias, torch.float32))
    ref_err = (first[1] - ref).abs().max().item()
    ref_tol = 0.05 * ref.abs().max().item() + 0.02
    if not ref_err <= ref_tol:
        raise AssertionError(f"bf16 logits differ from the float32 plain path by {ref_err}"
                             f" (bound {ref_tol})")

    timed = end - timed_start
    phase("main_path", steps=steps, timed_steps=steps - WARMUP_STEPS, batch=BATCH,
          workers=workers, samples_per_s=(steps - WARMUP_STEPS) * BATCH / timed,
          epoch_s=end - start, consumer_wait_share=wait / timed,
          peak_device_memory_bytes=peak, launches=launches,
          dataset_bytes=data_bytes, dataset_write_s=write_s,
          labels_match=True, logits_vs_f32_plain={"max_abs_err": ref_err, "bound": ref_tol})


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    phase("env", torch=torch.__version__, cuda=torch.version.cuda,
          python=sys.version.split()[0], cpu_count=os.cpu_count())
    print(smi.splitlines()[0], flush=True)

    t0 = time.perf_counter()
    libs = build.build_all()
    phase("build", seconds=time.perf_counter() - t0,
          libraries={k: os.path.relpath(v) for k, v in libs.items()})

    kernels = kernels_phase()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        main_path_phase(tmp, kernels)

    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
