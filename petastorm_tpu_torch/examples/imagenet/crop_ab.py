"""Times builds of a resized-crop kernel against each other on one CUDA GPU.

Run from the root of a checkout: ``python3 -m
petastorm_tpu_torch.examples.imagenet.crop_ab [--entry tiled|aa] [--shape
N,H,W,C] [--out OH,OW] [--crop] [--plan R,TW,CAP_Y,CAP_X,SPAN,GROUP] [--rounds 15]
[NAME=FILE.cu ...]``.
``as_is`` is the package's ``csrc/resized_crop.cu``; each ``NAME=FILE.cu`` is
another version of that file (an earlier revision, or one with a line
changed) whose entry takes the same arguments.  Every source is built by ``nvcc`` with the package's flags (plus
``-Xptxas -v``) into a temporary directory, all at once.

``--entry`` picks the kernel: ``tiled`` (no antialias; default inputs the
training step's: 256 seeded uint8 images of 224x224x3, boxes and flips drawn
as ``chip_smoke.py`` phase 3 draws them, out 224x224) or ``aa`` (the
antialiased tiled kernel; default inputs the evaluation resize: 256 images
of 256x256x3 to 224x224 with ``resize_images``' scale, or drawn boxes and
flips with ``--crop``).  Each build's entry, with the package's launch plan
(or ``--plan``'s),
and the general kernel through the package run in rounds whose order
rotates: 10 back-to-back launches between two CUDA events after 2 warm-up
launches.  The general kernel must give the bytes of ``as_is``; for every
other build the result says whether it does (a build that leaves work out
will not).  Prints the card's name and power limit as ``nvidia-smi`` gives
them, then one JSON line: per build the median, min and max ms per launch
over the rounds, whether its bytes equal ``as_is``'s, and ptxas's report on
the entry's kernels.
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
from petastorm_tpu_torch.ops import augment


def parse_variants(args: list[str]) -> dict[str, str]:
    """``["NAME=FILE.cu", ...]`` -> {name: source path}, ``as_is`` (the
    package's source) first."""
    variants = {"as_is": os.path.join(build.SOURCE_DIR, "resized_crop.cu")}
    for arg in args:
        name, sep, path = arg.partition("=")
        if not sep or not name or not path:
            raise ValueError(f"expected NAME=FILE.cu, got {arg!r}")
        if name in variants or name == "general":
            raise ValueError(f"variant name {name!r} is taken")
        variants[name] = path
    return variants


ENTRIES = ("tiled", "aa")
DEFAULT_SHAPES = {"tiled": ((256, 224, 224, 3), (224, 224)),
                  "aa": ((256, 256, 256, 3), (224, 224))}


def entry_kernel(entry: str, line: str) -> bool:
    """Whether ptxas's ``Compiling entry`` line is a kernel of ``entry``."""
    if entry == "aa":
        return "aa_tiled" in line
    return "tiled" in line and "aa_tiled" not in line


def ptxas_report(entry: str, stderr: str) -> list[str]:
    """ptxas's registers, spills and shared memory for each kernel of ``entry``."""
    lines, report = stderr.splitlines(), []
    for i, line in enumerate(lines):
        if "Compiling entry" in line and entry_kernel(entry, line):
            report.append(line.strip())
            for ln in lines[i + 1:i + 5]:
                if "Compiling entry" in ln:
                    break
                if "registers" in ln or "spill" in ln:
                    report.append(ln.strip())
    return report


def _build(name: str, source: str, tmp: str, entry: str):
    lib = os.path.join(tmp, f"lib{name}.so")
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", source,
                           "-o", lib], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for variant {name}:\n{proc.stderr}")
    return lib, ptxas_report(entry, proc.stderr)


def main(variants: dict[str, str], rounds: int, entry: str = "tiled", shape=None, out_hw=None,
         crop: bool = False, plan=None, launches: int = 10) -> dict:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    shape = tuple(shape or DEFAULT_SHAPES[entry][0])
    out_hw = tuple(out_hw or DEFAULT_SHAPES[entry][1])
    batch, h, w, c = shape
    antialias = entry == "aa"
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda", generator=gen)
    if antialias and not crop:
        # resize_images' params, no flips
        inv = [1.0 / (out_hw[0] / h), 0.0, 1.0 / (out_hw[1] / w), 0.0]
        params = torch.tensor(inv, device="cuda").expand(batch, 4).contiguous()
        flips = None
    else:
        boxes = augment.draw_crop_boxes(batch, h, w, gen, device="cuda")
        flips = augment.draw_flips(batch, gen, "cuda").to(torch.uint8)
        params = augment.crop_params(boxes, out_hw).contiguous()
    plan = augment.AaPlan(*plan) if plan else augment.aa_launch_plan(h, w, c, *out_hw)
    scratch = torch.empty(plan.scratch_bytes(batch, *out_hw), dtype=torch.uint8, device="cuda")
    with tempfile.TemporaryDirectory(prefix="crop_ab_") as tmp:
        with ThreadPoolExecutor(max_workers=len(variants)) as pool:
            built = dict(zip(variants, pool.map(lambda n: _build(n, variants[n], tmp, entry),
                                                variants)))
        calls, outs = {}, {}
        for name, (path, _) in built.items():
            lib = ctypes.CDLL(path)
            augment._configure_tiled(lib)
            out = torch.empty((batch, *out_hw, c), dtype=torch.uint8, device="cuda")
            outs[name] = out

            def call(lib=lib, out=out):
                args = (x.data_ptr(), out.data_ptr(), batch, h, w, c, *out_hw, params.data_ptr(),
                        None if flips is None else flips.data_ptr())
                stream = torch.cuda.current_stream().cuda_stream
                if antialias:
                    err = lib.pst_resized_crop_aa_u8(*args, *plan, scratch.data_ptr(),
                                                     scratch.numel(), stream)
                else:
                    err = lib.pst_resized_crop_tiled_u8(*args, stream)
                if err != 0:
                    raise RuntimeError(f"launch failed (error {err})")
            calls[name] = call
        calls["general"] = lambda: augment.launch_resized_crop(x, params, flips, out_hw, antialias,
                                                               kernel="general")
        for call in calls.values():
            call()
        torch.cuda.synchronize()
        equal = {name: torch.equal(out, outs["as_is"]) for name, out in outs.items()}
        if not torch.equal(calls["general"](), outs["as_is"]):
            raise AssertionError(f"the general kernel gives other bytes than the {entry} one")
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
    result = {"entry": entry, "shape": list(shape), "out_hw": list(out_hw),
              "inputs": "boxes and flips" if flips is not None else "resize_images' scale",
              "plan": plan._asdict() if antialias else None, "rounds": rounds,
              "launches_per_timing": launches, "device": torch.cuda.get_device_name(0)}
    for name, ms in times.items():
        result[name] = {"median_ms": float(np.median(ms)), "min_ms": min(ms), "max_ms": max(ms),
                        "equals_as_is": equal.get(name, True),
                        "ptxas": built[name][1] if name in built else None}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ints = lambda text: [int(v) for v in text.split(",")]  # noqa: E731
    parser.add_argument("--entry", choices=ENTRIES, default="tiled")
    parser.add_argument("--shape", type=ints, help="N,H,W,C of the input")
    parser.add_argument("--out", type=ints, help="OH,OW of the output")
    parser.add_argument("--crop", action="store_true",
                        help="aa: drawn boxes and flips instead of resize_images' scale")
    parser.add_argument("--plan", type=ints, help="aa: the launch plan instead of the package's")
    parser.add_argument("--rounds", type=int, default=15)
    parser.add_argument("variants", nargs="*", metavar="NAME=FILE.cu",
                        help="other versions of csrc/resized_crop.cu to time against it")
    args = parser.parse_args()
    main(parse_variants(args.variants), args.rounds, args.entry, args.shape, args.out, args.crop,
         args.plan)
