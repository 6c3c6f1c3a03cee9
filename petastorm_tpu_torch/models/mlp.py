"""A small MLP: the consumer of the MNIST example.

Counterpart of ``petastorm_tpu/models/mlp.py``: the input is flattened to
``(N, -1)`` and cast to float32 first (``:17``), then ``Dense -> relu`` for
each width of ``features`` and a last ``Dense`` to ``num_classes`` logits.
Weights are drawn as flax's defaults draw them: kernels from lecun-normal
(a normal of variance ``1 / fan_in`` truncated at two standard deviations),
biases zero.  ``convert.mlp_state_from_flax`` maps flax weights onto it.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from petastorm_tpu_torch.device import resolve_device

#: std of the unit normal truncated to [-2, 2]: lecun-normal divides by it
#: so the truncated draw keeps variance 1 / fan_in (``jax.nn.initializers``)
_TRUNC_STD = 0.87962566103423978


class MLP(nn.Module):
    """``features`` hidden widths with relu, then ``num_classes`` logits;
    ``dense[i]`` is flax's ``Dense_i``."""

    def __init__(self, in_features: int, features: Sequence[int] = (128, 64),
                 num_classes: int = 10, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        widths = [int(in_features), *map(int, features), int(num_classes)]
        self.dense = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths, widths[1:]))
        with torch.no_grad():
            for layer in self.dense:
                std = 1.0 / math.sqrt(layer.in_features) / _TRUNC_STD
                nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                layer.bias.zero_()
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1).float()
        for layer in self.dense[:-1]:
            x = torch.relu(layer(x))
        return self.dense[-1](x)
