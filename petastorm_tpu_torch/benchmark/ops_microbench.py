"""``python -m petastorm_tpu_torch.benchmark.ops_microbench``: on-card op timings.

Counterpart of ``petastorm_tpu/benchmark/ops_microbench.py``.  Times, on the
card, the device ops of the feed at the JAX tool's shapes: normalize (B1,
``csrc/normalize.cu``) against its plain version on the same CUDA tensor and
against host numpy plus a float32 copy to the card; flip then normalize; the
random resized crop (B3, and B3 aa with ``antialias=True``, the flips in the
same launch) and the crop -> normalize chain; and the hybrid JPEG decode
(the entropy half on the host, B2 on the card) against the native host
decode plus the copy, each half timed.  Prints one JSON line a measurement,
with the JAX tool's metric names and keys (``pallas_engaged`` is
``kernel_engaged``, the ``pallas``/``device`` key ``kernel``, ``xla_fallback``
``plain``).  A time is the mean of 20 calls (5 of the antialiased crop and of
the host normalize, 10 of each decode) between two synchronisations, after
one warm call, as the JAX tool takes it.

``kernel_engaged`` is true only when the launch counters of B1, B3 and B2
moved on a CUDA device; on a CUDA device where they did not, the tool exits
non-zero.  ``--device cpu`` runs the ops' plain versions on the host (the
counters stay put there).  The native host libraries are built at first use;
where they cannot be, the tool raises.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, List, Optional, Sequence

#: (N, H, W, C) of the normalized batch, and the crops' and decodes' output
#: side; as in the JAX tool, the crops read N images of 8/7 of H (256 for
#: 224) and the hybrid decode takes N/4 JPEGs (64 for 256)
SHAPE = (256, 224, 224, 3)
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def launch_counts() -> Dict[str, int]:
    """The launch counters of the kernels this tool drives."""
    from petastorm_tpu_torch.ops import augment, jpeg, normalize

    return {"normalize": normalize.normalize_kernel.launches,
            "resized_crop": augment.resized_crop_kernel.launches,
            "jpeg_decode": jpeg.jpeg_decode_kernel.launches}


def _timeit(fn: Callable, sync: Callable[[], None], n: int = 20) -> float:
    """Mean ms of ``n`` calls between two synchronisations, after a warm call."""
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    sync()
    return (time.perf_counter() - t0) / n * 1000


def jpeg_streams(n: int, height: int, width: int, quality: int = 90) -> List[bytes]:
    """``n`` JPEG streams of ``test_util.synthetic.synthetic_rgb_image`` frames,
    encoded by the package's image codec."""
    import numpy as np

    from petastorm_tpu_torch.codecs import CompressedImageCodec
    from petastorm_tpu_torch.schema import Field
    from petastorm_tpu_torch.test_util.synthetic import synthetic_rgb_image

    codec = CompressedImageCodec("jpeg", quality=quality)
    field = Field("image", np.uint8, (height, width, 3), codec)
    return [codec.encode(field, synthetic_rgb_image(i, height, width)) for i in range(n)]


def run(device="cuda", shape: Sequence[int] = SHAPE,
        outputs: Optional[dict] = None) -> List[dict]:
    """Every measurement, each record printed as a JSON line as it is taken;
    returns the records.

    ``outputs``, when given, receives the inputs and the last output of each
    op: ``normalize`` ``(images, out)``, ``crop`` and ``crop_aa`` ``(images,
    boxes, flips, out)``, ``jpeg`` ``(streams, planes, qtabs, layout, out)``
    (the planes on ``device``), so a caller can hold them to the plain
    versions.  Raises SystemExit on a CUDA device whose kernels did not
    launch."""
    import numpy as np
    import pyarrow as pa
    import torch

    from petastorm_tpu_torch.device import resolve_device
    from petastorm_tpu_torch.native.image import (decode_column_native,
                                                  read_jpeg_coefficients_column)
    from petastorm_tpu_torch.ops import augment, normalize
    from petastorm_tpu_torch.ops.jpeg import decode_coefficients

    device = resolve_device(device)
    on_cuda = device.type == "cuda"
    records: List[dict] = []
    outputs = {} if outputs is None else outputs

    def report(record: dict) -> None:
        records.append(record)
        print(json.dumps(record), flush=True)

    def sync() -> None:
        if on_cuda:
            torch.cuda.synchronize(device)

    b, h, w, c = shape
    crop_source, jpeg_images = h * 8 // 7, max(1, b // 4)
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=device).manual_seed(0)
    imgs_host = rng.integers(0, 255, (b, h, w, c), dtype=np.uint8)
    imgs = torch.from_numpy(imgs_host).to(device)
    big = torch.from_numpy(rng.integers(0, 255, (b, crop_source, crop_source, c),
                                        dtype=np.uint8)).to(device)
    # normalize_images takes torchvision-style [0,1]-unit mean/std; the host
    # baseline below computes the SAME function, so the timings compare like
    # for like
    mean = np.array(MEAN, np.float32)
    std = np.array(STD, np.float32)
    scale, bias = normalize.channel_constants(mean, std, c)

    def norm(x):
        out = normalize.normalize_images(x, mean, std)
        outputs["normalize"] = (x, out)
        return out

    def crop(antialias: bool):
        boxes = augment.draw_crop_boxes(b, crop_source, crop_source, gen, device=device)
        flips = augment.draw_flips(b, gen, device)
        out = augment.random_resized_crop(big, None, (h, w), antialias=antialias,
                                          boxes=boxes, flips=flips)
        outputs["crop_aa" if antialias else "crop"] = (big, boxes, flips, out)
        return out

    bufs = jpeg_streams(jpeg_images, h, w, quality=90)
    col = pa.array(bufs, type=pa.binary())
    decoded = np.empty((jpeg_images, h, w, 3), np.uint8)

    def host_path():
        if not decode_column_native(col, decoded, nthreads=1):
            raise RuntimeError("the native host decode refused the JPEG column")
        return torch.from_numpy(decoded).to(device)

    def to_device(planes, qtabs):
        return ([torch.from_numpy(p).to(device) for p in planes],
                torch.from_numpy(qtabs.astype(np.int32)).to(device))

    def chip_half(planes, qtabs, layout):
        out = decode_coefficients(planes, qtabs, (layout.height, layout.width),
                                  layout.sampling)
        outputs["jpeg"] = (bufs, planes, qtabs, layout, out)
        return out

    def hybrid_path():
        p, q, lay = read_jpeg_coefficients_column(bufs)
        return chip_half(*to_device(p, q), lay)

    # one call of each kernel first: the tool's numbers are the kernels' only
    # if every counter moved (the JAX tool checks the Pallas path the same way)
    before = launch_counts()
    norm(imgs)
    crop(False)
    hybrid_path()
    sync()
    moved = {k: v - before[k] for k, v in launch_counts().items()}
    kernel_engaged = on_cuda and all(moved.values())
    report({"metric": "kernel_engaged", "value": kernel_engaged, "backend": device.type})
    if on_cuda and not kernel_engaged:
        raise SystemExit(
            f"on a CUDA device but the kernels did not all launch (launches {moved});"
            " the kernel numbers cannot be reproduced")

    t_main = _timeit(lambda: norm(imgs), sync)
    t_plain = _timeit(lambda: normalize._normalize_reference(imgs, scale, bias, torch.bfloat16),
                      sync)

    def host_norm():
        return torch.from_numpy((imgs_host.astype(np.float32) / 255.0 - mean) / std).to(device)

    t_host = _timeit(host_norm, sync, n=5)
    report({"metric": "normalize_ms_per_256imgs", "kernel": t_main, "plain": t_plain,
            "host_numpy_plus_f32_transfer": t_host})

    t_aug = _timeit(lambda: normalize.normalize_images(augment.random_flip(imgs, gen), mean, std),
                    sync)
    report({"metric": "flip_plus_normalize_ms_per_256imgs", "value": t_aug})

    t_rrc = _timeit(lambda: crop(False), sync)
    t_rrc_aa = _timeit(lambda: crop(True), sync, n=5)
    t_full = _timeit(lambda: normalize.normalize_images(crop(False), mean, std), sync)
    report({"metric": "random_resized_crop_ms_per_256imgs_256to224", "value": t_rrc,
            "antialiased": t_rrc_aa, "crop_flip_normalize_chain": t_full})

    planes, qtabs, layout = read_jpeg_coefficients_column(bufs)
    dp, dq = to_device(planes, qtabs)
    t_hostdec = _timeit(host_path, sync, n=10)
    t_hyb = _timeit(hybrid_path, sync, n=10)
    t_chip = _timeit(lambda: chip_half(dp, dq, layout), sync, n=10)
    t0 = time.perf_counter()
    for _ in range(10):
        read_jpeg_coefficients_column(bufs)
    t_entropy = (time.perf_counter() - t0) / 10 * 1000
    report({"metric": "jpeg_decode_ms_per_64imgs_224",
            "host_decode_plus_transfer": t_hostdec, "hybrid_total": t_hyb,
            "hybrid_host_entropy_half": t_entropy, "hybrid_chip_half": t_chip})
    return records


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m petastorm_tpu_torch.benchmark.ops_microbench",
        description="Time the feed's device ops (B1, B3, B2) on the card")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the kernels; an error without a GPU) or"
                             " 'cpu' (the plain versions on the host)")
    parser.add_argument("--shape", type=int, nargs=4, default=list(SHAPE),
                        metavar=("N", "H", "W", "C"),
                        help="the normalized batch (C = 3); the crops read N"
                             " images of 8/7 H and give H x W, the decode N/4")
    args = parser.parse_args(argv)
    run(args.device, tuple(args.shape))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
