"""Times variants of the ResNet-50 inference forward against each other on one CUDA GPU.

Run from the root of a checkout: ``python3 -m
petastorm_tpu_torch.examples.imagenet.forward_ab [--rounds 15]``.  On one
resident batch of 256 seeded uint8 images at 224x224, ``normalize_images`` +
``ResNet50`` (bf16 compute, float32 leaves, channels_last, seed-0 weights)
run under ``torch.inference_mode()``, as ``chip_smoke.py`` phase 4 runs them,
in three variants that alternate round by round on one model in one process:

- ``cast_per_call``: each conv casts its float32 kernel to bf16 at every
  call; every BatchNorm runs one ``F.batch_norm`` (the model's no-grad path);
- ``cast_cached``: the model as it is: each conv keeps its bf16 kernel and
  casts again only when its float32 kernel changes (``_Conv._kernel``);
- ``bn_explicit``: casts at every call, and every BatchNorm runs flax's
  formula as float32 torch ops (``BatchNorm.explicit``, the form the
  training path differentiates).

Each round times, for each variant, 10 back-to-back forwards between two CUDA
events after 2 warm-up forwards; the variants' order rotates every round.
Prints the card's name and power limit as ``nvidia-smi`` gives them, then one
JSON line: per variant the median, min and max ms per forward over the
rounds, and the largest logit difference from ``cast_per_call``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess

import numpy as np
import torch

from petastorm_tpu_torch.models import ResNet50
from petastorm_tpu_torch.models.resnet import BatchNorm, _Conv
from petastorm_tpu_torch.ops import normalize_images


def _cast_per_call(conv: _Conv, dtype: torch.dtype) -> torch.Tensor:
    return conv.weight.to(dtype)


def _bn_explicit(bn: BatchNorm, x: torch.Tensor, train: bool = False) -> torch.Tensor:
    return bn.explicit(x)


VARIANTS = {
    "cast_per_call": (_cast_per_call, BatchNorm.forward),
    "cast_cached": (_Conv._kernel, BatchNorm.forward),
    "bn_explicit": (_cast_per_call, _bn_explicit),
}


@contextlib.contextmanager
def variant(name: str):
    kernel, bn_forward = VARIANTS[name]
    saved = _Conv._kernel, BatchNorm.forward
    _Conv._kernel, BatchNorm.forward = kernel, bn_forward
    try:
        yield
    finally:
        _Conv._kernel, BatchNorm.forward = saved


def main(rounds: int, batch: int = 256, side: int = 224, launches: int = 10) -> dict:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    model = ResNet50(num_classes=1000, dtype=torch.bfloat16, device="cuda",
                     generator=torch.Generator().manual_seed(0))
    model = model.to(memory_format=torch.channels_last)
    images = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (batch, side, side, 3), dtype=np.uint8)).cuda()

    def forward():
        return model(normalize_images(images))

    times = {name: [] for name in VARIANTS}
    logits = {}
    names = list(VARIANTS)
    with torch.inference_mode():
        for r in range(rounds):
            for name in names[r % len(names):] + names[:r % len(names)]:
                with variant(name):
                    for _ in range(2):
                        out = forward()
                    logits.setdefault(name, out.float())
                    torch.cuda.synchronize()
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(launches):
                        forward()
                    end.record()
                    end.synchronize()
                    times[name].append(start.elapsed_time(end) / launches)
    base = logits["cast_per_call"]
    result = {"batch": batch, "side": side, "rounds": rounds,
              "forwards_per_timing": launches, "device": torch.cuda.get_device_name(0)}
    for name, ms in times.items():
        result[name] = {"median_ms": float(np.median(ms)), "min_ms": min(ms), "max_ms": max(ms),
                        "ms": ms,
                        "max_logit_diff": (logits[name] - base).abs().max().item()}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=15)
    main(parser.parse_args().rounds)
