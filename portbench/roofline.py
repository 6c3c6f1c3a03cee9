"""The yardstick's arithmetic: peaks of the chip, ResNet-50 v1.5's operations,
and the bytes and operations B2 and B3 need, all from shapes and boxes.

Peaks are NVIDIA's published figures for one H100 SXM (dense, at its full
700 W): 989 TFLOP/s bf16, 67 TFLOP/s float32 outside the tensor cores,
3.35 TB/s of HBM3.  A kernel's least time is the larger of its bytes over
the bandwidth and its operations over the float32 rate, the rule of
``chip_smoke.py`` phase 3 (``resample_bound``, ``jpeg_bound``), whose
arithmetic is copied here so that later changes to the program cannot move
it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12

STAGES = (3, 4, 6, 3)


def _same_out(size: int, stride: int) -> int:
    return math.ceil(size / stride)


def resnet50_layers(side: int = 224, num_classes: int = 1000) -> List[Tuple[str, int]]:
    """``(layer, multiply-adds a sample)`` of every convolution and the dense
    layer of ResNet-50 v1.5 at ``side`` x ``side`` input (stride on the 3x3
    convolution, "SAME" output sizes)."""
    layers = []
    s = _same_out(side, 2)                       # the 7x7 stem, stride 2
    layers.append(("conv_init", s * s * 64 * 3 * 7 * 7))
    s = _same_out(s, 2)                          # the 3x3 max-pool, stride 2
    cin = 64
    for stage, count in enumerate(STAGES):
        filters = 64 * 2 ** stage
        for j in range(count):
            stride = 2 if stage > 0 and j == 0 else 1
            out = _same_out(s, stride)
            name = f"stage{stage}.block{j}"
            layers.append((f"{name}.conv0", s * s * filters * cin))
            layers.append((f"{name}.conv1", out * out * filters * filters * 9))
            layers.append((f"{name}.conv2", out * out * filters * 4 * filters))
            if j == 0:
                layers.append((f"{name}.proj", out * out * filters * 4 * cin))
            cin, s = filters * 4, out
    layers.append(("dense", cin * num_classes))
    return layers


def resnet50_forward_flops(side: int = 224, num_classes: int = 1000) -> float:
    """Operations of one sample's forward: 2 per multiply-add of the
    convolutions and the dense layer (nothing else is counted)."""
    return 2.0 * sum(macs for _, macs in resnet50_layers(side, num_classes))


def resnet50_train_flops(side: int = 224, num_classes: int = 1000) -> float:
    """A training sample: the forward and the backward's two products, 3x."""
    return 3.0 * resnet50_forward_flops(side, num_classes)


# -- B3: the resized crop ------------------------------------------------------


def _taps(in_size: int, out_size: int, inv_scale: torch.Tensor, translation: torch.Tensor,
          antialias: bool) -> torch.Tensor:
    """(N, in, out) bool: where the bilinear weight of a source pixel for an
    output pixel is nonzero (the triangle's open support, widened by the
    downscale with ``antialias``, and only for samples inside the image)."""
    inv_scale = inv_scale.double()[:, None]
    scale = torch.clamp_min(inv_scale, 1.0) if antialias else torch.ones_like(inv_scale)
    o = torch.arange(out_size, dtype=torch.float64, device=inv_scale.device)
    sample = (o + 0.5) * inv_scale - translation.double()[:, None] * inv_scale - 0.5
    i = torch.arange(in_size, dtype=torch.float64, device=inv_scale.device)
    near = torch.abs(sample[:, None, :] - i[None, :, None]) < scale[:, :, None]
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return near & inside[:, None, :]


def crop_params(boxes: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Boxes ``(y0, x0, crop_h, crop_w)`` -> ``(inv_scale_y, translation_y,
    inv_scale_x, translation_x)``: ``scale = out / crop``, ``translation =
    -corner * scale``."""
    y0, x0, ch, cw = boxes.double().unbind(1)
    oh, ow = out_hw
    return torch.stack([ch / oh, -y0 * oh / ch, cw / ow, -x0 * ow / cw], dim=1)


def resample_work(canvas: Sequence[int], boxes: torch.Tensor, out_hw: Tuple[int, int],
                  antialias: bool, element_bytes: int = 1) -> Dict[str, float]:
    """B3's bytes and operations for one launch over ``boxes`` (N, 4) on
    ``canvas`` ``(H, W, C)`` images: each image's source rows x columns with
    a nonzero weight read once and the output written once, and 2 operations
    a multiply-add of the separable form over the nonzero taps, each image
    in the cheaper of its two orders."""
    h, w, c = canvas
    oh, ow = out_hw
    params = crop_params(boxes, out_hw)
    wy = _taps(h, oh, params[:, 0], params[:, 1], antialias)
    wx = _taps(w, ow, params[:, 2], params[:, 3], antialias)
    rows_used, cols_used = wy.any(2).sum(1).double(), wx.any(2).sum(1).double()
    read = float((rows_used * cols_used).sum()) * c * element_bytes
    written = float(len(boxes) * oh * ow * c * element_bytes)
    taps_y, taps_x = wy.sum((1, 2)).double(), wx.sum((1, 2)).double()
    rows_first = taps_y * cols_used + oh * taps_x
    cols_first = taps_x * rows_used + ow * taps_y
    flops = 2.0 * c * float(torch.minimum(rows_first, cols_first).sum())
    return {"bytes": read + written, "flops": flops}


# -- B2: the JPEG decode's device half -------------------------------------------

SAMPLING_FACTORS = {"4:2:0": ((2, 2), (1, 1), (1, 1)), "4:4:4": ((1, 1), (1, 1), (1, 1)),
                    "gray": ((1, 1),)}


def jpeg_work(height: int, width: int, sampling: str) -> Dict[str, float]:
    """B2's bytes and operations for one baseline JPEG: the int16 coefficient
    planes (whole MCUs) and the int32 quant tables read once, the pixels
    written once (one channel for grayscale); per 8x8 block 64 dequantizing
    products, the separable IDCT's 2 x 512 multiply-adds and 64 level-shift
    adds, per sample of a triangle upsampling step three, per RGB pixel eight
    for the color conversion."""
    factors = SAMPLING_FACTORS[sampling]
    max_h = max(h for h, _ in factors)
    max_v = max(v for _, v in factors)
    mcu_cols = math.ceil(width / (8 * max_h))
    mcu_rows = math.ceil(height / (8 * max_v))
    flops = 0
    blocks = 0
    for h_samp, v_samp in factors:
        bw, bh = mcu_cols * h_samp, mcu_rows * v_samp
        blocks += bw * bh
        flops += bh * bw * (64 + 2 * 2 * 512 + 64)
        cw = -(-width * h_samp // max_h)
        if max_v // v_samp == 2:
            flops += 3 * height * cw
        if max_h // h_samp == 2:
            flops += 3 * height * width
    channels = 3 if len(factors) == 3 else 1
    if channels == 3:
        flops += 8 * height * width
    read = blocks * 64 * 2 + len(factors) * 64 * 4
    written = height * width * channels
    return {"bytes": float(read + written), "flops": float(flops)}


def least_seconds(work: Dict[str, float]) -> float:
    """The larger of the bytes at the HBM rate and the operations at the
    float32 rate."""
    return max(work["bytes"] / HBM_BYTES_PER_S, work["flops"] / F32_FLOPS_PER_S)
