"""Times builds of the tiled resized-crop kernel against each other on one CUDA GPU.

Run from the root of a checkout: ``python3 -m
petastorm_tpu_torch.examples.imagenet.crop_ab [--rounds 15] [NAME=FILE.cu ...]``.
``as_is`` is the package's ``csrc/resized_crop.cu``; each ``NAME=FILE.cu`` is
another version of that file (an earlier revision, or one with a line
changed).  Every source is built by ``nvcc`` with the package's flags (plus
``-Xptxas -v``) into a temporary directory, all at once.

On the training step's inputs (256 seeded uint8 images of 224x224x3, boxes
and flips drawn as ``chip_smoke.py`` phase 3 draws them, out 224x224) each
build's tiled entry, and the general kernel through the package, run in
rounds whose order rotates: 10 back-to-back launches between two CUDA events
after 2 warm-up launches.  The general kernel must give the bytes of
``as_is``; for every other build the result says whether it does (a build
that leaves work out will not).  Prints the card's name and power limit as
``nvidia-smi`` gives them, then one JSON line: per build the median, min and
max ms per launch over the rounds, whether its bytes equal ``as_is``'s, and
ptxas's report on its tiled kernel.
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


def _build(name: str, source: str, tmp: str):
    lib = os.path.join(tmp, f"lib{name}.so")
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", source,
                           "-o", lib], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for variant {name}:\n{proc.stderr}")
    lines = proc.stderr.splitlines()
    at = next(i for i, line in enumerate(lines) if "Compiling entry" in line and "tiled" in line)
    return lib, [line.strip() for line in lines[at + 1:at + 5]
                 if "registers" in line or "spill" in line]


def main(variants: dict[str, str], rounds: int, batch: int = 256, side: int = 224,
         launches: int = 10) -> dict:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randint(0, 256, (batch, side, side, 3), dtype=torch.uint8, device="cuda",
                      generator=gen)
    boxes = augment.draw_crop_boxes(batch, side, side, gen, device="cuda")
    flips = augment.draw_flips(batch, gen, "cuda").to(torch.uint8)
    params = augment.crop_params(boxes, (side, side)).contiguous()
    out_hw = (side, side)
    with tempfile.TemporaryDirectory(prefix="crop_ab_") as tmp:
        with ThreadPoolExecutor(max_workers=len(variants)) as pool:
            built = dict(zip(variants, pool.map(lambda n: _build(n, variants[n], tmp),
                                                variants)))
        calls, outs = {}, {}
        for name, (path, _) in built.items():
            lib = ctypes.CDLL(path)
            augment._configure(lib)
            out = torch.empty((batch, side, side, 3), dtype=torch.uint8, device="cuda")
            outs[name] = out

            def call(lib=lib, out=out):
                err = lib.pst_resized_crop_tiled_u8(
                    x.data_ptr(), out.data_ptr(), batch, side, side, 3, side, side,
                    params.data_ptr(), flips.data_ptr(), torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f"launch failed (error {err})")
            calls[name] = call
        calls["general"] = lambda: augment.launch_resized_crop(x, params, flips, out_hw, False,
                                                               tiled=False)
        for call in calls.values():
            call()
        torch.cuda.synchronize()
        equal = {name: torch.equal(out, outs["as_is"]) for name, out in outs.items()}
        if not torch.equal(calls["general"](), outs["as_is"]):
            raise AssertionError("the general kernel gives other bytes than the tiled one")
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
    result = {"batch": batch, "side": side, "rounds": rounds, "launches_per_timing": launches,
              "device": torch.cuda.get_device_name(0)}
    for name, ms in times.items():
        result[name] = {"median_ms": float(np.median(ms)), "min_ms": min(ms), "max_ms": max(ms),
                        "equals_as_is": equal.get(name, True),
                        "ptxas": built[name][1] if name in built else None}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=15)
    parser.add_argument("variants", nargs="*", metavar="NAME=FILE.cu",
                        help="other versions of csrc/resized_crop.cu to time against it")
    args = parser.parse_args()
    main(parse_variants(args.variants), args.rounds)
