"""Times builds of the JPEG decode kernel (B2) against each other on one CUDA GPU.

Run from the root of a checkout: ``python3 -m
petastorm_tpu_torch.examples.imagenet.jpeg_ab [--n 256] [--size 224,224]
[--sampling 420|422|444|gray] [--nearest] [--float32] [--ctas N] [--rounds 15]
[--sass DIR] [NAME=FILE.cu ...]``.
``as_is`` is the package's ``csrc/jpeg_decode.cu``; each ``NAME=FILE.cu`` is
another version of that file (an earlier revision, or one with a line
changed) whose tiled entry takes the same arguments.  Every source is built
by ``nvcc`` with the package's flags into a temporary directory, all at once.

Inputs: ``--n`` smooth seeded images (a random 7x7 field resized, plus
noise, as ``chip_smoke.py`` makes them) encoded by cv2 at quality 90 with
the given chroma sampling, entropy-decoded by the port's own library into
coefficient planes.  Each build's tiled entry, with the package's launch
plan (``--ctas``: another number of persistent blocks; a build whose
layout differs from the package's refuses the plan), and the general
kernel through the package run in rounds whose order rotates: 10
back-to-back launches between two CUDA events after 2 warm-up launches.  The general kernel must give the bytes of ``as_is``; for every
other build the result says whether it does (a build that leaves work out
will not).  Prints the card's name and power limit as ``nvidia-smi`` gives
them, then one JSON line: per build the median, min and max ms per launch
over the rounds, whether its output equals ``as_is``'s, and ptxas's report
on its B2 kernels.  ``--sass DIR`` writes each build's ``cuobjdump -sass``
to ``DIR/<name>.sass``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from petastorm_tpu_torch.cuda import build
from petastorm_tpu_torch.native import image as native_image
from petastorm_tpu_torch.ops import jpeg

SAMPLINGS = {"420": "IMWRITE_JPEG_SAMPLING_FACTOR_420", "422": "IMWRITE_JPEG_SAMPLING_FACTOR_422",
             "444": "IMWRITE_JPEG_SAMPLING_FACTOR_444", "gray": None}


def parse_variants(args: list[str]) -> dict[str, str]:
    """``["NAME=FILE.cu", ...]`` -> {name: source path}, ``as_is`` (the
    package's source) first."""
    variants = {"as_is": os.path.join(build.SOURCE_DIR, "jpeg_decode.cu")}
    for arg in args:
        name, sep, path = arg.partition("=")
        if not sep or not name or not path:
            raise ValueError(f"expected NAME=FILE.cu, got {arg!r}")
        if name in variants or name == "general":
            raise ValueError(f"variant name {name!r} is taken")
        variants[name] = path
    return variants


def coefficient_planes(n: int, size: tuple, sampling: str, seed: int = 1):
    """Coefficient planes, quant tables and layout of ``n`` seeded images."""
    import cv2

    rng = np.random.default_rng(seed)
    h, w = size
    params = [int(cv2.IMWRITE_JPEG_QUALITY), 90]
    if SAMPLINGS[sampling]:
        params += [int(cv2.IMWRITE_JPEG_SAMPLING_FACTOR), int(getattr(cv2, SAMPLINGS[sampling]))]
    bufs = []
    for _ in range(n):
        low = rng.integers(0, 256, (7, 7, 3)).astype(np.float32)
        img = cv2.resize(low, (w, h), interpolation=cv2.INTER_CUBIC)
        img = np.clip(img + rng.normal(0.0, 8.0, img.shape), 0, 255).astype(np.uint8)
        bufs.append(cv2.imencode(".jpeg", img[..., 0] if sampling == "gray" else img,
                                 params)[1].tobytes())
    return native_image.read_jpeg_coefficients_column(bufs, nthreads=os.cpu_count() or 1)


def ptxas_lines(stderr: str) -> list[str]:
    """ptxas's registers, stack and spills for each B2 kernel."""
    lines, report = stderr.splitlines(), []
    for i, line in enumerate(lines):
        if "Compiling entry" in line and "jpeg_decode" in line:
            report.append(line.strip())
            for ln in lines[i + 1:i + 5]:
                if "Compiling entry" in ln:
                    break
                if "registers" in ln or "spill" in ln:
                    report.append(ln.strip())
    return report


def _build(name: str, source: str, tmp: str, sass_dir: str | None):
    lib = os.path.join(tmp, f"lib{name}.so")
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, source, "-o", lib],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for variant {name}:\n{proc.stderr}")
    if sass_dir:
        tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
        with open(os.path.join(sass_dir, f"{name}.sass"), "w") as f:
            subprocess.run([tool, "-sass", lib], stdout=f, check=True)
    return lib, ptxas_lines(proc.stderr)


def main(variants: dict[str, str], rounds: int, n: int = 256, size=(224, 224),
         sampling: str = "420", fancy: bool = True, out_dtype=torch.uint8,
         sass_dir: str | None = None, ctas: int | None = None, launches: int = 10) -> dict:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    planes, qtabs, layout = coefficient_planes(n, tuple(size), sampling)
    dp = [torch.from_numpy(p).cuda() for p in planes]
    dq = torch.from_numpy(qtabs.astype(np.int32)).cuda()
    image_size = (layout.height, layout.width)
    blocks = tuple(tuple(p.shape[1:3]) for p in dp)
    plan = jpeg.decode_launch_plan(n, image_size, tuple(layout.sampling), blocks, fancy,
                                   jpeg._sm_count(torch.cuda.current_device()))
    if ctas:
        plan = plan._replace(ctas=ctas)
    ints = plan.ints()
    channels = 3 if len(dp) == 3 else 1
    if sass_dir:
        os.makedirs(sass_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="jpeg_ab_") as tmp:
        with ThreadPoolExecutor(max_workers=len(variants)) as pool:
            built = dict(zip(variants, pool.map(
                lambda name: _build(name, variants[name], tmp, sass_dir), variants)))
        calls, outs = {}, {}
        ptrs = (ctypes.c_void_p * 3)(*[p.data_ptr() for p in dp])
        cblocks = (ctypes.c_int * 6)(*[d for b in blocks for d in b])
        samp = (ctypes.c_int * 6)(*[f for s in layout.sampling for f in s])
        cplan = (ctypes.c_int * len(ints))(*ints)
        basis = jpeg._idct_basis()
        for name, (path, _) in built.items():
            lib = ctypes.CDLL(path)
            jpeg._configure(lib)
            out = torch.empty((n, *image_size, channels), dtype=out_dtype, device="cuda")
            outs[name] = out

            def call(lib=lib, out=out):
                err = lib.pst_jpeg_decode_tiled(
                    len(dp), ctypes.addressof(ptrs), ctypes.addressof(cblocks),
                    ctypes.addressof(samp), dq.data_ptr(), n, *image_size, int(fancy),
                    basis.ctypes.data, out.data_ptr(), jpeg._OUT_DTYPES[out_dtype], cplan,
                    len(ints), torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f"launch failed (error {err})")
            calls[name] = call
        calls["general"] = lambda: jpeg.launch_jpeg_decode(dp, dq, image_size, layout.sampling,
                                                           out_dtype, fancy, kernel="general")
        for call in calls.values():
            call()
        torch.cuda.synchronize()
        bits = (lambda t: t.view(torch.int32)) if out_dtype == torch.float32 else (lambda t: t)
        equal = {name: torch.equal(bits(out), bits(outs["as_is"])) for name, out in outs.items()}
        general = calls["general"]().reshape(outs["as_is"].shape)
        if not torch.equal(bits(general), bits(outs["as_is"])):
            raise AssertionError("the general kernel gives another output than the tiled one")
        times = {name: [] for name in calls}
        names = list(calls)
        for r in range(rounds):
            for name in names[r % len(names):] + names[:r % len(names)]:
                for _ in range(2):
                    calls[name]()
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(launches):
                    calls[name]()
                end.record()
                end.synchronize()
                times[name].append(start.elapsed_time(end) / launches)
    result = {"n": n, "size": list(image_size), "sampling": list(layout.sampling),
              "fancy": fancy, "out_dtype": str(out_dtype), "plan": plan._asdict(),
              "rounds": rounds, "launches_per_timing": launches,
              "device": torch.cuda.get_device_name(0)}
    for name, ms in times.items():
        result[name] = {"median_ms": float(np.median(ms)), "min_ms": min(ms), "max_ms": max(ms),
                        "equals_as_is": equal.get(name, True),
                        "ptxas": built[name][1] if name in built else None}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ints = lambda text: [int(v) for v in text.split(",")]  # noqa: E731
    parser.add_argument("--n", type=int, default=256)
    parser.add_argument("--size", type=ints, default=[224, 224], help="H,W of the images")
    parser.add_argument("--sampling", choices=list(SAMPLINGS), default="420")
    parser.add_argument("--nearest", action="store_true", help="fancy_upsampling=False")
    parser.add_argument("--float32", action="store_true", help="float32 output")
    parser.add_argument("--ctas", type=int, help="persistent blocks instead of the plan's")
    parser.add_argument("--rounds", type=int, default=15)
    parser.add_argument("--sass", metavar="DIR", help="write each build's SASS to DIR")
    parser.add_argument("variants", nargs="*", metavar="NAME=FILE.cu",
                        help="other versions of csrc/jpeg_decode.cu to time against it")
    args = parser.parse_args()
    main(parse_variants(args.variants), args.rounds, args.n, args.size, args.sampling,
         not args.nearest, torch.float32 if args.float32 else torch.uint8, args.sass, args.ctas)
