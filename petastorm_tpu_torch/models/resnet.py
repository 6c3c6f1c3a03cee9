"""ResNet-50 as torch ``nn.Module``s, the consumer of the ImageNet feed.

Counterpart of ``petastorm_tpu/models/resnet.py:18-73``: bottleneck ResNet
v1.5 (the stride sits in the 3x3 conv), the head ``Linear`` in float32, and
BatchNorm with the running statistics (flax's ``use_running_average=True``,
the mode of the JAX training step, which does not pass ``train=True``), or,
with ``forward(images, train=True)``, with the batch's statistics and the
running ones updated (flax's ``use_running_average=False, momentum=0.9``).  The
public call takes NHWC input, as the flax model does; inside, an NHWC tensor
permuted to NCHW is already in ``channels_last`` memory order, which cuDNN
prefers.

flax's dtype split: every leaf is float32 (``param_dtype``) and the body
computes in ``dtype`` (bf16 by default).  Each conv casts its float32 kernel
to the input's dtype at the call, so gradients land on the float32 leaves;
:class:`BatchNorm` computes in float32 and casts its output, as flax's does.
The four BatchNorm leaves are all trainable: ``scale`` and ``bias`` are
parameters (flax's ``params``), ``mean`` and ``var`` are buffers (flax's
``batch_stats``) that the training step also differentiates and updates,
because the JAX step does (see :meth:`ResNet.batch_stats`).

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
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from petastorm_tpu_torch.device import resolve_device

_BN_EPS = 1e-5
_BN_MOMENTUM = 0.9


def _same_pad(x: torch.Tensor, kernel: int, stride: int, value: float = 0.0) -> torch.Tensor:
    """Pad NCHW ``x`` as XLA's ``"SAME"`` does: ``ceil(size/stride)`` outputs,
    the odd padding element after."""
    pads = []
    for size in (x.shape[3], x.shape[2]):  # F.pad lists the last dim first
        total = max((math.ceil(size / stride) - 1) * stride + kernel - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value) if any(pads) else x


class _Conv(nn.Conv2d):
    """Bias-free square conv whose float32 kernel is cast to the input's dtype
    at the call; flax ``"SAME"`` padding unless ``padding`` is given.

    Under ``torch.inference_mode()`` the cast kernel is kept and reused until
    the float32 kernel changes: in place (its version counter) or by a new
    storage (its address; the cache holds the old storage, so no other tensor
    can take that address meanwhile).  Casting the 53 kernels at every call
    cost 1 % of the batch-256 inference forward on an H100
    (``examples/imagenet/forward_ab.py``)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: Optional[int] = None):
        super().__init__(cin, cout, kernel, stride, padding=padding or 0, bias=False)
        self.same = padding is None
        self._cast: Optional[Tuple[tuple, torch.Tensor, torch.Tensor]] = None

    def _kernel(self, dtype: torch.dtype) -> torch.Tensor:
        weight = self.weight
        if weight.dtype == dtype or not torch.is_inference_mode_enabled():
            return weight.to(dtype)
        key = (dtype, weight.data_ptr(), weight._version)
        if self._cast is None or self._cast[0] != key:
            self._cast = (key, weight.detach(), weight.to(dtype))
        return self._cast[2]

    def forward(self, x):
        if self.same:
            x = _same_pad(x, self.kernel_size[0], self.stride[0])
        return self._conv_forward(x, self._kernel(x.dtype), None)


class BatchNorm(nn.Module):
    """flax ``BatchNorm(use_running_average=True)`` on NCHW input:
    ``((x - mean) * (rsqrt(var + eps) * scale) + bias)`` in float32, cast
    back to the input's dtype.

    With autograd on, the formula runs as written, so ``mean`` and ``var``
    take gradients (``F.batch_norm`` refuses to differentiate its running
    statistics).  Without it, one ``F.batch_norm`` kernel computes the same
    float32 formula in one pass (its rounding differs in the last float32
    bit), which keeps the inference feed as fast as a stock BatchNorm.

    ``forward(x, train=True)`` is flax's ``use_running_average=False``: the
    formula on the batch's float32 mean and biased variance over N, H and W
    (flax's fast variance, ``max(0, E[x^2] - E[x]^2)``, not
    ``nn.BatchNorm2d``'s), and the running statistics updated in place to
    ``momentum * running + (1 - momentum) * batch`` (flax's mutable
    ``batch_stats``), outside autograd.
    """

    def __init__(self, channels: int, eps: float = _BN_EPS):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def reset_parameters(self) -> None:
        with torch.no_grad():
            for leaf, value in ((self.scale, 1.0), (self.bias, 0.0), (self.mean, 0.0),
                                (self.var, 1.0)):
                leaf.fill_(value)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            return self.batch_statistics_forward(x)
        if not torch.is_grad_enabled():
            return F.batch_norm(x, self.mean, self.var, self.scale, self.bias, False, 0.0,
                                self.eps)
        return self.explicit(x)

    def explicit(self, x: torch.Tensor) -> torch.Tensor:
        """flax's formula as float32 torch ops, differentiable in all four leaves."""
        return self._normalize(x, self.mean, self.var)

    def _normalize(self, x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
        per_channel = (1, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(var + self.eps) * self.scale
        y = torch.addcmul(self.bias.view(per_channel), x - mean.view(per_channel),
                          mul.view(per_channel))
        return y.to(x.dtype)

    def batch_statistics_forward(self, x: torch.Tensor) -> torch.Tensor:
        """The formula on the batch's statistics (``flax.linen.normalization.
        _compute_stats``: float32, the fast variance clipped at 0), then the
        running statistics' update in place."""
        dims = (0,) + tuple(range(2, x.dim()))
        xf = x.float()
        mean = xf.mean(dims)
        var = torch.clamp_min((xf * xf).mean(dims) - mean * mean, 0.0)
        with torch.no_grad():
            self.mean.copy_(_BN_MOMENTUM * self.mean + (1 - _BN_MOMENTUM) * mean)
            self.var.copy_(_BN_MOMENTUM * self.var + (1 - _BN_MOMENTUM) * var)
        return self._normalize(x, mean, var)


class BottleneckBlock(nn.Module):
    def __init__(self, cin: int, filters: int, stride: int):
        super().__init__()
        self.conv0 = _Conv(cin, filters, 1)
        self.bn0 = BatchNorm(filters)
        self.conv1 = _Conv(filters, filters, 3, stride)
        self.bn1 = BatchNorm(filters)
        self.conv2 = _Conv(filters, filters * 4, 1)
        self.bn2 = BatchNorm(filters * 4)
        if cin != filters * 4 or stride != 1:
            self.conv_proj = _Conv(cin, filters * 4, 1, stride)
            self.norm_proj = BatchNorm(filters * 4)
        else:
            self.conv_proj = self.norm_proj = None

    def forward(self, x, train: bool = False):
        y = F.relu(self.bn0(self.conv0(x), train))
        y = F.relu(self.bn1(self.conv1(y), train))
        y = self.bn2(self.conv2(y), train)
        residual = x if self.conv_proj is None else self.norm_proj(self.conv_proj(x), train)
        return F.relu(residual + y)


class ResNet(nn.Module):
    """Bottleneck ResNet; ``forward`` takes NHWC images and returns float32 logits.

    Every leaf is float32; ``dtype`` is the body's compute type.  Weights are drawn from ``generator`` (a CPU ``torch.Generator``; seed 0
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
            self.conv_init = _Conv(3, num_filters, 7, 2, padding=3)
            self.bn_init = BatchNorm(num_filters)
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
        self.eval()

    def batch_stats(self) -> List[torch.Tensor]:
        """Every BatchNorm's ``mean`` and ``var`` (flax's ``batch_stats``), in
        module order: the leaves the training step updates besides ``parameters()``."""
        return [t for m in self.modules() if isinstance(m, BatchNorm) for t in (m.mean, m.var)]

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
            elif isinstance(module, BatchNorm):
                module.reset_parameters()
        for block in self.blocks:
            block.bn2.scale.zero_()

    def forward(self, images: torch.Tensor, train: bool = False) -> torch.Tensor:
        """Logits of NHWC ``images``; ``train=True`` normalizes with each
        batch's statistics and updates every BatchNorm's running ones (flax's
        ``apply(..., train=True, mutable=['batch_stats'])``)."""
        x = images.to(self.dtype).permute(0, 3, 1, 2)  # NHWC -> NCHW, channels_last
        x = F.relu(self.bn_init(self.conv_init(x), train))
        x = F.max_pool2d(_same_pad(x, 3, 2, float("-inf")), 3, 2)
        for block in self.blocks:
            x = block(x, train)
        x = x.mean(dim=(2, 3))
        return self.dense(x.float())


def ResNet50(num_classes: int = 1000, dtype: torch.dtype = torch.bfloat16,
             device="cuda", generator: Optional[torch.Generator] = None) -> ResNet:
    return ResNet([3, 4, 6, 3], num_classes=num_classes, dtype=dtype, device=device,
                  generator=generator)
