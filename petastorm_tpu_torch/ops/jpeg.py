"""Hybrid JPEG decode, device half: dequant + IDCT + upsample + color.

Counterpart of ``petastorm_tpu/ops/jpeg.py`` (``decode_coefficients``
``:103``, ``decode_from_layout`` ``:148``, ``decode_jpeg_column`` ``:161``).
The host half (``native/image.py``) runs only libjpeg's entropy decode and
ships quantized DCT coefficient planes; everything arithmetic happens here:

* dequantize: each coefficient times its quant table entry;
* inverse DCT: ``A^T X A`` per 8x8 block, plus 128;
* each component cropped to its sampled size ``ceil(H*v/max_v) x
  ceil(W*h/max_h)``, then upsampled to (H, W), vertically first: libjpeg's
  "fancy" triangle filter with edge replication for 2x factors, nearest for
  4x (and for ``fancy_upsampling=False``);
* BT.601 YCbCr -> RGB, then round half to even and clip for uint8.

On a CUDA tensor the whole function runs in kernel B2, the hand-written
Hopper kernel of ``csrc/jpeg_decode.cu``, and in nothing else: what the
kernel does not take raises.  On a CPU tensor it runs the plain PyTorch
version ``_decode_reference``, which writes out the reference's
``_idct_basis`` (``:38``), ``_idct_blocks`` (``:48``),
``_upsample_axis_fancy`` (``:66``), ``_upsample_to`` (``:81``) and
``_YCC_TO_RGB`` (``:96``) in float32 torch ops; the tests hold it against the
JAX package and ``chip_smoke.py`` holds the kernel against it.

Accuracy: the float IDCT, triangle upsample and color differ from libjpeg's
fixed-point pipeline by a few levels (max <= 6, mean < 1 against cv2), as
the reference does.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from petastorm_tpu_torch.cuda import build
from petastorm_tpu_torch.device import resolve_device

_OUT_DTYPES = {torch.uint8: 0, torch.float32: 1}
_MAX_COMPS = 3  # kMaxComps in csrc/jpeg_decode.cu


@functools.lru_cache(maxsize=None)
def _idct_basis() -> np.ndarray:
    """A[u, x] = c(u)/2 * cos((2x+1) u pi / 16); spatial = A^T @ X @ A."""
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    a = 0.5 * np.cos((2 * x + 1) * u * np.pi / 16)
    a[0] *= 1 / np.sqrt(2)
    return a.astype(np.float32)


# JFIF YCbCr -> RGB (ITU-R BT.601)
_YCC_TO_RGB = np.array([[1.0, 0.0, 1.402],
                        [1.0, -0.344136286, -0.714136286],
                        [1.0, 1.772, 0.0]], dtype=np.float32)


def _idct_blocks(coefs: torch.Tensor, qtab: torch.Tensor) -> torch.Tensor:
    """(..., bh, bw, 64) coefs + (..., 64) qtab -> (..., bh*8, bw*8) float32,
    level-shifted (+128) and unclipped."""
    *lead, bh, bw, _ = coefs.shape
    x = coefs.float() * qtab.float()[..., None, None, :]
    x = x.reshape(*lead, bh, bw, 8, 8)
    a = torch.from_numpy(_idct_basis()).to(coefs.device)
    # spatial[k, l] = sum_uv X[u, v] A[u, k] A[v, l]
    s = torch.einsum("...uv,uk,vl->...kl", x, a, a) + 128.0
    # (..., bh, bw, 8, 8) -> (..., bh, 8, bw, 8) -> (..., bh*8, bw*8)
    return s.movedim(-2, -3).reshape(*lead, bh * 8, bw * 8)


def _upsample_axis_fancy(x: torch.Tensor, axis: int) -> torch.Tensor:
    """libjpeg's 'fancy' (triangle) 2x upsample along one axis:
    out[2i] = (3*x[i] + x[i-1]) / 4, out[2i+1] = (3*x[i] + x[i+1]) / 4, with
    edge replication."""
    x = x.movedim(axis, -1)
    prev = torch.cat([x[..., :1], x[..., :-1]], dim=-1)
    nxt = torch.cat([x[..., 1:], x[..., -1:]], dim=-1)
    even = (3.0 * x + prev) * 0.25
    odd = (3.0 * x + nxt) * 0.25
    out = torch.stack([even, odd], dim=-1).reshape(*x.shape[:-1], -1)
    return out.movedim(-1, axis)


def _upsample_to(plane: torch.Tensor, factors: Tuple[int, int], height: int, width: int,
                 fancy: bool) -> torch.Tensor:
    """Upsample (..., ch, cw) by integer ``factors``, rows first, and crop to (height, width)."""
    for axis, f in ((-2, factors[0]), (-1, factors[1])):
        if f == 1:
            continue
        if fancy and f == 2:
            plane = _upsample_axis_fancy(plane, axis)
        else:  # nearest for 4x factors (and fancy=False)
            plane = plane.repeat_interleave(f, dim=axis)
    return plane[..., :height, :width]


def _check_geometry(planes, qtabs, image_size, sampling):
    """The factors and cropped sizes of each component; raises on shapes the
    function does not take."""
    height, width = image_size
    ncomp = len(planes)
    if ncomp not in (1, 3):
        raise ValueError(f"unsupported component count {ncomp}")
    if len(sampling) != ncomp:
        raise ValueError(f"{len(sampling)} sampling factors for {ncomp} planes")
    if qtabs.shape[-2:] != (ncomp, 64):
        raise ValueError(f"qtabs must be (..., {ncomp}, 64), got {tuple(qtabs.shape)}")
    max_h = max(s[0] for s in sampling)
    max_v = max(s[1] for s in sampling)
    comps = []
    for c, (plane, (h_samp, v_samp)) in enumerate(zip(planes, sampling)):
        if max_h % h_samp or max_v % v_samp:
            raise ValueError(f"component {c}: sampling {sampling[c]} does not divide"
                             f" the largest ({max_h}, {max_v})")
        ch = -(-height * v_samp // max_v)  # ceil
        cw = -(-width * h_samp // max_h)
        if plane.shape[-1] != 64 or plane.shape[-3] * 8 < ch or plane.shape[-2] * 8 < cw:
            raise ValueError(f"component {c}: plane {tuple(plane.shape)} does not cover"
                             f" {ch}x{cw} samples")
        if plane.shape[:-3] != qtabs.shape[:-2]:
            raise ValueError(f"component {c}: leading dims {tuple(plane.shape[:-3])} differ"
                             f" from the qtabs' {tuple(qtabs.shape[:-2])}")
        comps.append((max_v // v_samp, max_h // h_samp, ch, cw))
    return comps


def _decode_reference(planes: Sequence[torch.Tensor], qtabs: torch.Tensor,
                      image_size: Tuple[int, int], sampling: Tuple[Tuple[int, int], ...],
                      out_dtype: torch.dtype = torch.uint8,
                      fancy_upsampling: bool = True) -> torch.Tensor:
    """Plain version of the kernel, in float32 torch ops (see the module
    docstring); any leading batch dims."""
    height, width = image_size
    comps = []
    for c, (fy, fx, ch, cw) in enumerate(_check_geometry(planes, qtabs, image_size, sampling)):
        spatial = _idct_blocks(planes[c], qtabs[..., c, :])[..., :ch, :cw]
        comps.append(_upsample_to(spatial, (fy, fx), height, width, fancy_upsampling))
    if len(comps) == 1:
        out = comps[0]
    else:
        ycc = torch.stack(comps, dim=-1)
        ycc = ycc - torch.tensor([0.0, 128.0, 128.0], device=ycc.device)
        out = ycc @ torch.from_numpy(_YCC_TO_RGB).to(ycc.device).T
    if not out_dtype.is_floating_point:
        out = torch.clamp(torch.round(out), 0, 255)
    return out.to(out_dtype)


def _configure(lib: ctypes.CDLL) -> None:
    lib.pst_jpeg_decode.restype = ctypes.c_int
    lib.pst_jpeg_decode.argtypes = [
        ctypes.c_int,                      # ncomp
        ctypes.c_void_p,                   # const int16_t* const* planes (device pointers)
        ctypes.c_void_p,                   # const int* blocks_h, blocks_w per component
        ctypes.c_void_p,                   # const int* h_samp, v_samp per component
        ctypes.c_void_p,                   # const int32_t* qtabs (device, n x ncomp x 64)
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # n, height, width
        ctypes.c_int,                      # fancy upsampling
        ctypes.c_void_p,                   # const float* idct basis (host, 64)
        ctypes.c_void_p,                   # void* out (device, n x H x W x channels)
        ctypes.c_int,                      # out dtype code
        ctypes.c_void_p,                   # cudaStream_t
    ]


def jpeg_decode_kernel(planes: Sequence[torch.Tensor], qtabs: torch.Tensor,
                       image_size: Tuple[int, int], sampling: Tuple[Tuple[int, int], ...],
                       out_dtype: torch.dtype = torch.uint8,
                       fancy_upsampling: bool = True) -> torch.Tensor:
    """Launch kernel B2 (``csrc/jpeg_decode.cu``) on CUDA planes, on the
    current stream: int16 (N, bh, bw, 64) planes and (N, ncomp, 64) integer
    quant tables (int32 as the loader delivers them; other integer types are
    converted) -> (N, H, W, 3) or, for one component, (N, H, W).
    ``jpeg_decode_kernel.launches`` counts the launches."""
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"jpeg decode kernel writes uint8 or float32, not {out_dtype}")
    _check_geometry(planes, qtabs, image_size, sampling)
    device = qtabs.device
    if device.type != "cuda" or any(p.device != device for p in planes):
        raise ValueError(f"jpeg_decode_kernel takes CUDA tensors on one device, got"
                         f" {[str(p.device) for p in planes]} and {device}")
    if any(p.dtype != torch.int16 for p in planes):
        raise TypeError(f"coefficient planes must be int16, got {[p.dtype for p in planes]}")
    if qtabs.dtype.is_floating_point or qtabs.dtype == torch.bool:
        raise TypeError(f"quant tables must be integers, got {qtabs.dtype}")
    height, width = image_size
    if min(height, width) < 1:
        raise ValueError(f"image size {image_size}")
    lead = tuple(qtabs.shape[:-2])
    n = int(np.prod(lead)) if lead else 1
    qtabs = qtabs.reshape(n, len(planes), 64).to(torch.int32).contiguous()
    flat = []
    for p in planes:
        p = p.reshape(n, *p.shape[-3:]).contiguous()
        if p.data_ptr() % 16:  # the kernel reads a block row as one 16-byte vector
            p = p.clone()
        flat.append(p)
    channels = 3 if len(planes) == 3 else 1
    out = torch.empty((n, height, width, channels), dtype=out_dtype, device=device)
    if n:
        lib = build.load("jpeg_decode", _configure)
        ptrs = (ctypes.c_void_p * _MAX_COMPS)(*[p.data_ptr() for p in flat])
        blocks = (ctypes.c_int * (2 * _MAX_COMPS))(*[d for p in flat for d in p.shape[1:3]])
        samp = (ctypes.c_int * (2 * _MAX_COMPS))(*[f for s in sampling for f in s])
        basis = _idct_basis()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = lib.pst_jpeg_decode(len(planes), ctypes.addressof(ptrs),
                                      ctypes.addressof(blocks), ctypes.addressof(samp),
                                      qtabs.data_ptr(), n,
                                      height, width, int(bool(fancy_upsampling)),
                                      basis.ctypes.data, out.data_ptr(),
                                      _OUT_DTYPES[out_dtype], stream)
        if err != 0:
            raise RuntimeError(f"jpeg decode kernel launch failed (error {err})")
        jpeg_decode_kernel.launches += 1
    out = out.reshape(*lead, height, width, channels)
    return out if channels == 3 else out[..., 0]


jpeg_decode_kernel.launches = 0


def decode_coefficients(planes: Sequence[torch.Tensor], qtabs: torch.Tensor,
                        image_size: Tuple[int, int], sampling: Tuple[Tuple[int, int], ...],
                        out_dtype: torch.dtype = torch.uint8,
                        fancy_upsampling: bool = True) -> torch.Tensor:
    """Quantized DCT coefficient planes -> decoded image batch.

    Args:
      planes: per component, int16 (N, blocks_h, blocks_w, 64) in natural
        order (``native.image.read_jpeg_coefficients_column``); extra leading
        batch dims are fine.
      qtabs: integer (N, ncomp, 64) quant tables in natural order, with the
        planes' leading dims.
      image_size: (height, width) of the full image.
      sampling: per component (h_samp, v_samp).
      out_dtype: ``torch.uint8`` (default) or ``torch.float32`` (unrounded,
        unclipped, for a normalize stage).

    Returns (N, H, W, 3) RGB for 3 components, (N, H, W) for one.  Runs
    kernel B2 on CUDA tensors and the plain version on CPU tensors.
    """
    if qtabs.device.type == "cpu":
        if out_dtype not in _OUT_DTYPES:
            raise TypeError(f"jpeg decode writes uint8 or float32, not {out_dtype}")
        return _decode_reference(planes, qtabs, image_size, sampling, out_dtype,
                                 fancy_upsampling)
    return jpeg_decode_kernel(planes, qtabs, image_size, sampling, out_dtype, fancy_upsampling)


def decode_from_layout(planes, qtabs, layout, out_dtype: torch.dtype = torch.uint8,
                       fancy_upsampling: bool = True) -> torch.Tensor:
    """Decode planes already on their device, given a ``native.image.JpegCoefLayout``."""
    return decode_coefficients(planes, qtabs, (layout.height, layout.width), layout.sampling,
                               out_dtype=out_dtype, fancy_upsampling=fancy_upsampling)


def decode_jpeg_column(column, out_dtype: torch.dtype = torch.uint8,
                       fancy_upsampling: bool = True, device="cuda") -> torch.Tensor:
    """An arrow column or list of same-geometry JPEG streams -> a decoded
    batch on ``device``: the entropy decode on the host, the rest on the
    device (kernel B2 on CUDA, the plain version on the CPU)."""
    from petastorm_tpu_torch.native.image import read_jpeg_coefficients_column

    device = resolve_device(device)
    planes, qtabs, layout = read_jpeg_coefficients_column(column)
    planes = [torch.from_numpy(p).to(device) for p in planes]
    qtabs = torch.from_numpy(qtabs.astype(np.int32)).to(device)
    return decode_from_layout(planes, qtabs, layout, out_dtype, fancy_upsampling)
