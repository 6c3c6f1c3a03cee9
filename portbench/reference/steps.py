"""The reference's training steps and evaluation forward, float32 with TF32
off, in blocks of rows so that they fit beside nothing else.

:func:`images` rebuilds a batch's network input from the corpus streams
alone: decode, pad to the loader's canvas, crop-resize with the boxes and
flips the benchmark drew, normalize.  :func:`train_steps` runs SGD with
momentum over every leaf for as many batches as it is given and returns
each step's loss, each leaf's first gradient norm (the momentum buffer after
the first step) and each leaf's change after the last step.
"""

from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from portbench.reference import preprocess, resnet


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matrix products and convolutions, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def decoded(streams: Sequence[bytes], canvas: Sequence[int], threads: int = 8) -> np.ndarray:
    """uint8 ``(N, *canvas)``: each stream decoded and zero-padded."""
    with ThreadPoolExecutor(max_workers=threads) as pool:
        return np.stack(list(pool.map(
            lambda s: preprocess.pad(preprocess.decode(s), canvas), streams)))


def images(streams: Sequence[bytes], boxes: torch.Tensor, flips: Optional[torch.Tensor],
           config: Dict, antialias: bool, device) -> torch.Tensor:
    """The normalized float32 NHWC network input of ``streams``."""
    canvas = decoded(streams, config["pad_to"])
    side = int(config["image_side"])
    crops = preprocess.resized_crop(torch.from_numpy(canvas).to(device), boxes.to(device),
                                    (side, side), flips, antialias=antialias)
    norm = config["normalize"]
    return preprocess.normalize(crops, norm["mean"], norm["std"])


def train_steps(leaves0: resnet.Leaves, batches: List[Tuple[torch.Tensor, torch.Tensor]],
                lr: float, momentum: float,
                quantize: Optional[resnet.Fp8] = None, chunk: int = 64) -> Dict:
    """SGD with momentum (``buf = g`` at the first step, then ``buf =
    momentum * buf + g``; ``p -= lr * buf``) over every leaf, one step per
    batch ``(images, labels)``, the loss the mean cross-entropy over the
    batch.  Returns ``losses`` (floats), ``grad1`` and ``delta`` (leaf name
    -> float64 norm)."""
    params = {n: t.detach().clone().requires_grad_(True) for n, t in leaves0.items()}
    bufs: Dict[str, torch.Tensor] = {}
    losses, grad1 = [], {}
    with exact_float32():
        for k, (x, labels) in enumerate(batches):
            n = x.shape[0]
            total = torch.zeros((), dtype=torch.float64, device=x.device)
            for p in params.values():
                p.grad = None
            for c0 in range(0, n, chunk):
                logits = resnet.forward(params, x[c0:c0 + chunk], quantize)
                loss = resnet.cross_entropy_sum(logits, labels[c0:c0 + chunk]) / n
                loss.backward()
                total += loss.detach().double()
            losses.append(float(total))
            with torch.no_grad():
                for name, p in params.items():
                    g = p.grad if p.grad is not None else torch.zeros_like(p)
                    bufs[name] = g.clone() if k == 0 else bufs[name].mul_(momentum).add_(g)
                    p.add_(bufs[name], alpha=-lr)
            if k == 0:
                grad1 = {n: float(b.double().norm()) for n, b in bufs.items()}
    delta = {n: float((p.detach().double() - leaves0[n].double()).norm())
             for n, p in params.items()}
    return {"losses": losses, "grad1": grad1, "delta": delta}


def eval_logits(leaves: resnet.Leaves, x: torch.Tensor, quantize: Optional[resnet.Fp8] = None,
                chunk: int = 64) -> torch.Tensor:
    """float32 logits of normalized ``x``."""
    with exact_float32(), torch.no_grad():
        return torch.cat([resnet.forward(leaves, x[c0:c0 + chunk], quantize)
                          for c0 in range(0, x.shape[0], chunk)])
