"""ResNet-50 as torch ``nn.Module``s, the consumer of the ImageNet feed.

Counterpart of ``petastorm_tpu/models/resnet.py:18-73``: bottleneck ResNet
v1.5 (the stride sits in the 3x3 conv), a body in ``dtype`` (bf16 by
default), the head ``Linear`` in float32, and BatchNorm in inference mode
(training is not part of this package yet).  The public call takes NHWC
input, as the flax model does; inside, an NHWC tensor permuted to NCHW is
already in ``channels_last`` memory order, which cuDNN prefers.

flax pads ``"SAME"`` asymmetrically at stride 2 (more padding after than
before), where ``nn.Conv2d(padding=1)`` pads both sides, so every 3x3 conv and
the max-pool pad explicitly with :func:`_same_pad` and run unpadded.  The
module names follow the flax tree (``conv_init``, ``bn_init``, blocks in
order, ``Conv_j``/``BatchNorm_j`` as ``convj``/``bnj``, ``conv_proj``,
``norm_proj``, ``Dense_0`` as ``dense``) so :mod:`petastorm_tpu_torch.convert`
maps leaves one to one.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from petastorm_tpu_torch.device import resolve_device

_BN_EPS = 1e-5


def _same_pad(x: torch.Tensor, kernel: int, stride: int, value: float = 0.0) -> torch.Tensor:
    """Pad NCHW ``x`` as XLA's ``"SAME"`` does: ``ceil(size/stride)`` outputs,
    the odd padding element after."""
    pads = []
    for size in (x.shape[3], x.shape[2]):  # F.pad lists the last dim first
        total = max((math.ceil(size / stride) - 1) * stride + kernel - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value) if any(pads) else x


class _SameConv(nn.Conv2d):
    """Bias-free square conv with flax ``"SAME"`` padding."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1):
        super().__init__(cin, cout, kernel, stride, padding=0, bias=False)

    def forward(self, x):
        return super().forward(_same_pad(x, self.kernel_size[0], self.stride[0]))


def _bn(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=_BN_EPS, momentum=0.1)


class BottleneckBlock(nn.Module):
    def __init__(self, cin: int, filters: int, stride: int):
        super().__init__()
        self.conv0 = _SameConv(cin, filters, 1)
        self.bn0 = _bn(filters)
        self.conv1 = _SameConv(filters, filters, 3, stride)
        self.bn1 = _bn(filters)
        self.conv2 = _SameConv(filters, filters * 4, 1)
        self.bn2 = _bn(filters * 4)
        if cin != filters * 4 or stride != 1:
            self.conv_proj = _SameConv(cin, filters * 4, 1, stride)
            self.norm_proj = _bn(filters * 4)
        else:
            self.conv_proj = self.norm_proj = None

    def forward(self, x):
        y = F.relu(self.bn0(self.conv0(x)))
        y = F.relu(self.bn1(self.conv1(y)))
        y = self.bn2(self.conv2(y))
        residual = x if self.conv_proj is None else self.norm_proj(self.conv_proj(x))
        return F.relu(residual + y)


class ResNet(nn.Module):
    """Bottleneck ResNet; ``forward`` takes NHWC images and returns float32 logits.

    Weights are drawn from ``generator`` (a CPU ``torch.Generator``; seed 0
    when None) with flax's initializers: lecun-normal conv and dense kernels
    (not truncated), unit BatchNorm scales except a zero scale on each
    block's last BatchNorm, zero biases, zero means and unit variances.
    """

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 num_filters: int = 64, dtype: torch.dtype = torch.bfloat16,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        with torch.device("meta"):
            self.conv_init = nn.Conv2d(3, num_filters, 7, 2, padding=3, bias=False)
            self.bn_init = _bn(num_filters)
            blocks = []
            cin = num_filters
            for i, count in enumerate(stage_sizes):
                for j in range(count):
                    filters = num_filters * 2 ** i
                    blocks.append(BottleneckBlock(cin, filters, 2 if i > 0 and j == 0 else 1))
                    cin = filters * 4
            self.blocks = nn.Sequential(*blocks)
            self.dense = nn.Linear(cin, num_classes)
        self.to_empty(device="cpu")
        self._init_weights(generator)
        self.to(device)
        for name, module in self.named_children():
            if name != "dense":
                module.to(dtype)
        self.eval()

    @torch.no_grad()
    def _init_weights(self, generator: Optional[torch.Generator]) -> None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for module in self.modules():
            if isinstance(module, (nn.Conv2d, nn.Linear)):
                fan_in = module.weight[0].numel()
                module.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, nn.BatchNorm2d):
                module.reset_parameters()
        for block in self.blocks:
            block.bn2.weight.zero_()

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.to(self.dtype).permute(0, 3, 1, 2)  # NHWC -> NCHW, channels_last
        x = F.relu(self.bn_init(self.conv_init(x)))
        x = F.max_pool2d(_same_pad(x, 3, 2, float("-inf")), 3, 2)
        x = self.blocks(x)
        x = x.mean(dim=(2, 3))
        return self.dense(x.float())


def ResNet50(num_classes: int = 1000, dtype: torch.dtype = torch.bfloat16,
             device="cuda", generator: Optional[torch.Generator] = None) -> ResNet:
    return ResNet([3, 4, 6, 3], num_classes=num_classes, dtype=dtype, device=device,
                  generator=generator)
