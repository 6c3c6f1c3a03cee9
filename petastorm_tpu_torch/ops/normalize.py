"""uint8 -> float image normalization on the device.

Counterpart of ``petastorm_tpu/ops/normalize.py:83 normalize_images``: NHWC
uint8 in, ``(x/255 - mean[c]) / std[c]`` out, bf16 by default.  Shipping uint8
to the card and normalizing there moves a quarter of the float32 bytes over
PCIe.

On a CUDA tensor the work runs in the hand-written Hopper kernel of
``csrc/normalize.cu`` (which replaces the Pallas kernel
``_normalize_kernel``), and in nothing else: a dtype or layout the kernel does
not take raises.  On a CPU tensor it runs the plain PyTorch version
``_normalize_reference``, which the tests hold against the JAX package and
which ``chip_smoke.py`` holds the kernel against.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from petastorm_tpu_torch.cuda import build

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_CHANNELS = 64  # kMaxChannels in csrc/normalize.cu: constants passed by value


def _configure(lib: ctypes.CDLL) -> None:
    for entry in (lib.pst_normalize_u8, lib.pst_normalize_u8_channels):
        entry.restype = ctypes.c_int
        entry.argtypes = [
            ctypes.c_void_p,     # const uint8_t* in
            ctypes.c_void_p,     # void* out
            ctypes.c_longlong,   # n elements
            ctypes.c_int,        # channels
            ctypes.c_void_p,     # const float* scale (`channels` floats: host for
                                 # pst_normalize_u8, device for _channels)
            ctypes.c_void_p,     # const float* bias (likewise)
            ctypes.c_int,        # out dtype code
            ctypes.c_void_p,     # cudaStream_t
        ]


def channel_constants(mean, std, channels: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-channel float32 ``(scale, bias)``, with the JAX package's expressions
    (``petastorm_tpu/ops/normalize.py:98-110``) so the constants are
    bit-identical.  Raises ValueError when the sizes do not match ``channels``."""
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    if mean.size == 1:
        mean = np.full(channels, mean.item(), np.float32)
    if std.size == 1:
        std = np.full(channels, std.item(), np.float32)
    if mean.size != channels or std.size != channels:
        raise ValueError(f"mean/std size {mean.size}/{std.size} != channels {channels}")
    scale = (1.0 / (255.0 * std)).astype(np.float32)
    bias = (-mean / std).astype(np.float32)
    return scale, bias


def _normalize_reference(images: torch.Tensor, scale: np.ndarray, bias: np.ndarray,
                         out_dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version: ``(x.float() * scale + bias).to(out_dtype)``."""
    s = torch.from_numpy(scale).to(images.device)
    b = torch.from_numpy(bias).to(images.device)
    return (images.float() * s + b).to(out_dtype)


def normalize_kernel(images: torch.Tensor, scale: np.ndarray, bias: np.ndarray,
                     out_dtype: torch.dtype) -> torch.Tensor:
    """Launch ``csrc/normalize.cu`` on a contiguous CUDA uint8 tensor, on the
    current stream; ``normalize_kernel.launches`` counts the launches.  Up to
    64 channels the constants go to the kernel by value; above, through a
    device buffer."""
    if images.device.type != "cuda":
        raise ValueError(f"normalize_kernel takes a CUDA tensor, got {images.device}")
    if out_dtype not in _KERNEL_DTYPES:
        raise TypeError(f"normalize kernel writes float32, bfloat16 or float16,"
                        f" not {out_dtype}")
    if not images.is_contiguous():
        raise ValueError("normalize kernel takes a contiguous tensor; call .contiguous()")
    channels = images.shape[-1]
    lib = build.load("normalize", _configure)
    out = torch.empty(images.shape, dtype=out_dtype, device=images.device)
    scale = np.ascontiguousarray(scale, np.float32)
    bias = np.ascontiguousarray(bias, np.float32)
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream(images.device)
        if channels <= _MAX_CHANNELS:
            err = lib.pst_normalize_u8(images.data_ptr(), out.data_ptr(), images.numel(),
                                       channels, scale.ctypes.data, bias.ctypes.data,
                                       _KERNEL_DTYPES[out_dtype], stream.cuda_stream)
        else:
            # copied on the current stream, so the kernel reads them after the copy
            constants = torch.from_numpy(np.stack([scale, bias])).to(images.device)
            err = lib.pst_normalize_u8_channels(
                images.data_ptr(), out.data_ptr(), images.numel(), channels,
                constants[0].data_ptr(), constants[1].data_ptr(), _KERNEL_DTYPES[out_dtype],
                stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"normalize kernel launch failed (error {err})")
    if images.numel():
        normalize_kernel.launches += 1
    return out


normalize_kernel.launches = 0


def normalize_images(images: torch.Tensor,
                     mean: Sequence[float] = (0.485, 0.456, 0.406),
                     std: Sequence[float] = (0.229, 0.224, 0.225),
                     out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``(images/255 - mean) / std`` per channel; images are NHWC uint8.

    mean/std are in [0, 1] units (the torchvision convention).  Runs the
    Hopper kernel on a CUDA tensor and the plain version on a CPU tensor.
    """
    if not isinstance(images, torch.Tensor) or images.dtype != torch.uint8:
        raise TypeError(f"normalize_images expects a uint8 tensor, got"
                        f" {getattr(images, 'dtype', type(images))}")
    if images.dim() < 2:
        raise TypeError("normalize_images expects at least (N, ...) images")
    scale, bias = channel_constants(mean, std, images.shape[-1])
    if images.device.type == "cpu":
        return _normalize_reference(images, scale, bias, out_dtype)
    return normalize_kernel(images, scale, bias, out_dtype)
