"""ResNet-50 v1.5, plain float32 PyTorch: the reference of the training and
evaluation cells.

ResNet-50 v1.5 (He et al. 2016, with the stride of each downsampling
bottleneck on its 3x3 convolution), written from the published description
as functions over a dict of float32 leaves.  It follows what the program
under test states it computes, and each departure from torchvision's model
is the program's:

- BatchNorm normalizes with its running statistics,
  ``bias + (x - mean) * (rsqrt(var + eps) * scale)``, also while training,
  and all four of its leaves take gradient steps;
- a 3x3 convolution and the max-pool pad as XLA's ``"SAME"`` (the odd
  padding element after), the stem pads 3 on each side;
- the head is a float32 dense layer over the mean of the last feature map.

The weights are made here from a seed (:func:`make_leaves`), on the device
and in a few large calls: lecun-normal convolution and dense kernels (not
truncated), unit BatchNorm scales but a zero scale on each block's last
BatchNorm, zero biases and means, unit variances.  The benchmark hands the
same leaves to the program and keeps them for this reference.

``quantize`` (the control): rounds each convolution's and the dense
layer's operands and the gradient of their outputs, as :class:`Fp8` does.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

STAGES = (3, 4, 6, 3)
WIDTH = 64
EXPANSION = 4
BN_EPS = 1e-5

Leaves = Dict[str, torch.Tensor]


def leaf_specs(num_classes: int = 1000) -> List[Tuple[str, tuple, str]]:
    """Every leaf as ``(name, shape, init)``, in the order of the model:
    ``init`` is ``'lecun'``, ``'zeros'``, ``'ones'``."""
    specs: List[Tuple[str, tuple, str]] = []

    def bn(prefix: str, channels: int, zero_scale: bool = False) -> None:
        specs.extend([(f"{prefix}.scale", (channels,), "zeros" if zero_scale else "ones"),
                      (f"{prefix}.bias", (channels,), "zeros"),
                      (f"{prefix}.mean", (channels,), "zeros"),
                      (f"{prefix}.var", (channels,), "ones")])

    specs.append(("conv_init.weight", (WIDTH, 3, 7, 7), "lecun"))
    bn("bn_init", WIDTH)
    cin, index = WIDTH, 0
    for stage, count in enumerate(STAGES):
        filters = WIDTH * 2 ** stage
        for j in range(count):
            p = f"blocks.{index}"
            specs.append((f"{p}.conv0.weight", (filters, cin, 1, 1), "lecun"))
            bn(f"{p}.bn0", filters)
            specs.append((f"{p}.conv1.weight", (filters, filters, 3, 3), "lecun"))
            bn(f"{p}.bn1", filters)
            specs.append((f"{p}.conv2.weight", (filters * EXPANSION, filters, 1, 1), "lecun"))
            bn(f"{p}.bn2", filters * EXPANSION, zero_scale=True)
            if j == 0:
                specs.append((f"{p}.conv_proj.weight", (filters * EXPANSION, cin, 1, 1),
                              "lecun"))
                bn(f"{p}.norm_proj", filters * EXPANSION)
            cin = filters * EXPANSION
            index += 1
    specs.append(("dense.weight", (num_classes, cin), "lecun"))
    specs.append(("dense.bias", (num_classes,), "zeros"))
    return specs


def make_leaves(seed: int, device, num_classes: int = 1000) -> Leaves:
    """The float32 leaves for ``seed``: one normal draw on ``device`` for every
    kernel, scaled by each kernel's ``fan_in ** -0.5``."""
    specs = leaf_specs(num_classes)
    kernels = [(name, shape) for name, shape, init in specs if init == "lecun"]
    sizes = [math.prod(shape) for _, shape in kernels]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    scales = torch.tensor([math.prod(shape[1:]) ** -0.5 for _, shape in kernels],
                          device=device)
    flat.mul_(torch.repeat_interleave(scales, torch.tensor(sizes, device=device)))
    leaves: Leaves = {}
    for (name, shape), part in zip(kernels, torch.split(flat, sizes)):
        leaves[name] = part.view(shape)
    for name, shape, init in specs:
        if init == "zeros":
            leaves[name] = torch.zeros(shape, device=device)
        elif init == "ones":
            leaves[name] = torch.ones(shape, device=device)
    return {name: leaves[name] for name, _, _ in specs}


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` under a per-tensor scale that maps its
    largest magnitude to the format's largest, and back to float32."""
    top = torch.finfo(dtype).max
    scale = top / x.abs().amax().clamp_min(1e-30)
    return (x * scale).to(dtype).float() / scale


class _Operand(torch.autograd.Function):
    """float8 e4m3 in the forward; the gradient passes straight through."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, grad):
        return grad


class _Output(torch.autograd.Function):
    """The identity in the forward; its gradient rounded to float8 e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, torch.float8_e5m2)


class Fp8:
    """Products computed in float8, the recipe of float8 training: e4m3
    operands (input and kernel) in the forward, e5m2 output gradients into
    the backward's products, each tensor under its own scale; float32
    accumulation and everything outside the products in float32."""

    operand = staticmethod(_Operand.apply)
    output = staticmethod(_Output.apply)


FP8 = Fp8()


def _same_pad(x: torch.Tensor, kernel: int, stride: int, value: float = 0.0) -> torch.Tensor:
    pads = []
    for size in (x.shape[3], x.shape[2]):
        total = max((math.ceil(size / stride) - 1) * stride + kernel - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value)


def _conv(x, w, stride, padding, q):
    if q is not None:
        x, w = q.operand(x), q.operand(w)
    if padding == "same":
        x = _same_pad(x, w.shape[-1], stride)
        padding = 0
    y = F.conv2d(x, w, stride=stride, padding=padding)
    return y if q is None else q.output(y)


def _bn(x, leaves, prefix):
    shape = (1, -1, 1, 1)
    mul = torch.rsqrt(leaves[f"{prefix}.var"] + BN_EPS) * leaves[f"{prefix}.scale"]
    return (leaves[f"{prefix}.bias"].view(shape)
            + (x - leaves[f"{prefix}.mean"].view(shape)) * mul.view(shape))


def forward(leaves: Leaves, images: torch.Tensor, quantize: Optional[Fp8] = None
            ) -> torch.Tensor:
    """float32 logits of normalized NHWC float32 ``images``."""
    q = quantize
    x = images.permute(0, 3, 1, 2)
    x = F.relu(_bn(_conv(x, leaves["conv_init.weight"], 2, 3, q), leaves, "bn_init"))
    x = F.max_pool2d(_same_pad(x, 3, 2, float("-inf")), 3, 2)
    index = 0
    for stage, count in enumerate(STAGES):
        for j in range(count):
            p = f"blocks.{index}"
            stride = 2 if stage > 0 and j == 0 else 1
            y = F.relu(_bn(_conv(x, leaves[f"{p}.conv0.weight"], 1, 0, q), leaves, f"{p}.bn0"))
            y = F.relu(_bn(_conv(y, leaves[f"{p}.conv1.weight"], stride, "same", q), leaves,
                           f"{p}.bn1"))
            y = _bn(_conv(y, leaves[f"{p}.conv2.weight"], 1, 0, q), leaves, f"{p}.bn2")
            if j == 0:
                x = _bn(_conv(x, leaves[f"{p}.conv_proj.weight"], stride, 0, q), leaves,
                        f"{p}.norm_proj")
            x = F.relu(x + y)
            index += 1
    x = x.mean(dim=(2, 3))
    w = leaves["dense.weight"]
    if q is None:
        return F.linear(x, w, leaves["dense.bias"])
    return q.output(F.linear(q.operand(x), q.operand(w), leaves["dense.bias"]))


def cross_entropy_sum(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Summed ``-log_softmax(logits)[label]`` over the rows."""
    return -torch.log_softmax(logits, dim=-1).gather(1, labels[:, None]).sum()
