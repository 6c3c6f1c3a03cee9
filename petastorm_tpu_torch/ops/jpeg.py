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

On a CUDA tensor the whole function runs in kernel B2, a hand-written
Hopper kernel of ``csrc/jpeg_decode.cu``, and in nothing else: what the
kernel does not take raises.  The source has two kernels with the same float
operations in the same order, so equal outputs: the tiled kernel, which every
launch takes (its launch plan is :func:`decode_launch_plan`, a plain function
of the shapes), and the general kernel of the first port, reached only by
``launch_jpeg_decode(..., kernel="general")``, the byte oracle and timing
yardstick of ``chip_smoke.py`` and the card tests.  On a CPU tensor it runs the plain PyTorch
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
import math
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from petastorm_tpu_torch.cuda import build
from petastorm_tpu_torch.device import resolve_device

_OUT_DTYPES = {torch.uint8: 0, torch.float32: 1}
_MAX_COMPS = 3  # kMaxComps in csrc/jpeg_decode.cu

JPEG_DECODE_KERNELS = ("tiled", "general")
# the tiled kernel's layout (csrc/jpeg_decode.cu: kHeaderBytes, the warps'
# scratch of kTiledThreads / 8 blocks of kScratchStride floats,
# kTiledBlocksPerSM, kMaxSharedBytes) and the card's shared memory
_HEADER_BYTES = 2048
_SCRATCH_BYTES = 256 // 8 * 72 * 4
TILED_BLOCKS_PER_SM = 3
MAX_SHARED_BYTES = 232448       # one block's dynamic shared memory on sm_90
SM_SHARED_BYTES = 233472        # an H100 SM's shared memory
_BLOCK_RESERVED_BYTES = 1024    # kept by the runtime for each resident block
# the most a block may take so that TILED_BLOCKS_PER_SM blocks share an SM
TILED_TARGET_SHARED_BYTES = SM_SHARED_BYTES // TILED_BLOCKS_PER_SM - _BLOCK_RESERVED_BYTES
H100_SMS = 132
_TARGET_TILE_ROWS = 16


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


class DecodePlan(NamedTuple):
    """The tiled kernel's launch plan (``csrc/jpeg_decode.cu``,
    ``make_tiled_params`` checks it against its own)."""
    kind: str                 # the instance: "420", "422", "444", "gray" or "generic"
    tile_rows: int            # output rows of a tile (whole MCU rows)
    tile_cols: int            # output columns of a tile (whole MCUs)
    tiles_y: int
    tiles_x: int
    ctas: int                 # persistent blocks
    stage_blocks: Tuple[Tuple[int, int], ...]  # per component: block rows, columns staged at most
    region_rows: Tuple[int, ...]   # per component: rows of its region of samples
    region_strides: Tuple[int, ...]  # per component: floats between region rows
    stage_bytes: int          # one of the two stages: quant tables and staged blocks
    shared_bytes: int         # a block's dynamic shared memory

    def ints(self) -> list:
        """The plan as ``pst_jpeg_decode_tiled`` takes it."""
        return [self.tile_rows, self.tile_cols, self.ctas, self.stage_bytes, self.shared_bytes,
                *[x for rc in self.stage_blocks for x in rc]]


def _tiled_kind(factors: Sequence[Tuple[int, int]], fancy: bool) -> str:
    """The tiled kernel's instance for components upsampled by ``factors``
    ((fy, fx) each): luma at full size and two chroma components alike get a
    fused instance, everything else the generic one."""
    if len(factors) == 1:
        return "gray"
    (fy0, fx0), (fy1, fx1), (fy2, fx2) = factors
    if (fy0, fx0) == (1, 1) and (fy1, fx1) == (fy2, fx2):
        if (fy1, fx1) == (1, 1):
            return "444"
        if fancy and (fy1, fx1) == (2, 2):
            return "420"
        if fancy and (fy1, fx1) == (1, 2):
            return "422"
    return "generic"


def _region_stride(width: int, rem: int) -> int:
    """region_stride in the source: >= width and ``rem`` more than a multiple of 32."""
    return width + ((rem - width % 32) + 32) % 32


@functools.lru_cache(maxsize=64)
def decode_launch_plan(n: int, image_size: Tuple[int, int],
                       sampling: Tuple[Tuple[int, int], ...],
                       blocks: Tuple[Tuple[int, int], ...], fancy: bool = True,
                       sms: int = H100_SMS) -> DecodePlan:
    """The tiled kernel's plan from the shapes alone: ``n`` images of
    ``image_size``, per component its (h, v) ``sampling`` and its plane's
    (blocks_h, blocks_w) ``blocks``; ``sms`` multiprocessors.

    A tile is whole MCU rows, about 16 output rows, by the image's whole
    width in MCUs, narrowed by halves while a block's shared memory exceeds
    ``TILED_TARGET_SHARED_BYTES`` (three blocks an SM).  A component stages
    the block rows (columns) of its tile's samples: ``v * mcu_rows`` (``h *
    mcu_cols``), two more where the triangle filter reads a neighbour beyond
    the tile, never more than its plane has; its region holds the samples the
    tile reads.  At the ImageNet batch (256 x 224 x 224, 4:2:0): tiles of
    16 x 224, 72,192 bytes, 396 blocks on 132 SMs."""
    height, width = image_size
    max_h = max(h for h, _ in sampling)
    max_v = max(v for _, v in sampling)
    factors = tuple((max_v // v, max_h // h) for h, v in sampling)
    kind = _tiled_kind(factors, fancy)
    mcu_rows = max(1, _TARGET_TILE_ROWS // (8 * max_v))

    def plan(mcu_cols: int) -> DecodePlan:
        tile_rows, tile_cols = 8 * max_v * mcu_rows, 8 * max_h * mcu_cols
        stage, r_floats = 256 * len(sampling), 0
        caps, region_rows, strides = [], [], []
        for (h, v), (fy, fx), (bh, bw) in zip(sampling, factors, blocks):
            fancy_y, fancy_x = int(fancy and fy == 2), int(fancy and fx == 2)
            rows = min(v * mcu_rows + 2 * fancy_y, bh)
            cols = min(h * mcu_cols + 2 * fancy_x, bw)
            caps.append((rows, cols))
            stage += 128 * rows * cols
            # rows a fast instance reads 8 at once as float4s start in 8 bank groups
            rows8 = kind != "generic" and (fy, fx) == (1, 1)
            region_rows.append(8 * v * mcu_rows + 2 * fancy_y)
            strides.append(_region_stride(8 * cols, 4 if rows8 else 16))
            r_floats += region_rows[-1] * strides[-1]
        shared = _HEADER_BYTES + 2 * stage + _SCRATCH_BYTES + 4 * r_floats
        tiles_y, tiles_x = -(-height // tile_rows), -(-width // tile_cols)
        per_sm = max(1, min(TILED_BLOCKS_PER_SM,
                            SM_SHARED_BYTES // (shared + _BLOCK_RESERVED_BYTES)))
        return DecodePlan(kind, tile_rows, tile_cols, tiles_y, tiles_x,
                          max(1, min(n * tiles_y * tiles_x, sms * per_sm)), tuple(caps),
                          tuple(region_rows), tuple(strides), stage, shared)

    mcu_cols = -(-width // (8 * max_h))
    p = plan(mcu_cols)
    while p.shared_bytes > TILED_TARGET_SHARED_BYTES and mcu_cols > 1:
        mcu_cols = -(-mcu_cols // 2)
        p = plan(mcu_cols)
    if p.shared_bytes > MAX_SHARED_BYTES:
        raise ValueError(f"no tile of the tiled JPEG decode kernel fits {image_size} {sampling}")
    return p


class TileSpan(NamedTuple):
    """One component's share of a tile (``comp_tile`` in the source):
    the samples it reads and the blocks staged for them."""
    rows: Tuple[int, int]     # first and last sample row, clamped to the cropped plane
    cols: Tuple[int, int]
    block_rows: Tuple[int, int]  # staged: first block row, count
    block_cols: Tuple[int, int]


def _axis_span(lo: int, hi: int, f: int, fancy: bool, size: int) -> Tuple[int, int]:
    first, last = (lo // 2 - 1, (hi - 1) // 2 + 1) if fancy else (lo // f, (hi - 1) // f)
    return min(max(first, 0), size - 1), min(max(last, 0), size - 1)


def tile_spans(plan: DecodePlan, image_size: Tuple[int, int],
               sampling: Tuple[Tuple[int, int], ...], fancy: bool, ty: int,
               tx: int) -> Tuple[Tuple[int, int, int, int], Tuple[TileSpan, ...]]:
    """Tile (ty, tx) of ``plan``: its output rows and columns (y0, y1, x0,
    x1) and each component's :class:`TileSpan`, as the kernel works them out."""
    height, width = image_size
    y0, x0 = ty * plan.tile_rows, tx * plan.tile_cols
    y1, x1 = min(y0 + plan.tile_rows, height), min(x0 + plan.tile_cols, width)
    max_h = max(h for h, _ in sampling)
    max_v = max(v for _, v in sampling)
    spans = []
    for h, v in sampling:
        fy, fx = max_v // v, max_h // h
        ch, cw = -(-height * v // max_v), -(-width * h // max_h)
        rows = _axis_span(y0, y1, fy, fancy and fy == 2, ch)
        cols = _axis_span(x0, x1, fx, fancy and fx == 2, cw)
        spans.append(TileSpan(rows, cols, (rows[0] // 8, rows[1] // 8 - rows[0] // 8 + 1),
                              (cols[0] // 8, cols[1] // 8 - cols[0] // 8 + 1)))
    return (y0, y1, x0, x1), tuple(spans)


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
    common = [
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
    ]
    lib.pst_jpeg_decode.restype = ctypes.c_int
    lib.pst_jpeg_decode.argtypes = common + [ctypes.c_void_p]  # cudaStream_t
    lib.pst_jpeg_decode_tiled.restype = ctypes.c_int
    lib.pst_jpeg_decode_tiled.argtypes = common + [
        ctypes.c_void_p,                   # const int* plan (host)
        ctypes.c_int,                      # plan length
        ctypes.c_void_p,                   # cudaStream_t
    ]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_jpeg_decode(planes: Sequence[torch.Tensor], qtabs: torch.Tensor,
                       image_size: Tuple[int, int], sampling: Tuple[Tuple[int, int], ...],
                       out_dtype: torch.dtype = torch.uint8, fancy_upsampling: bool = True,
                       kernel: str = "tiled") -> torch.Tensor:
    """Launch one kernel of ``csrc/jpeg_decode.cu`` on CUDA planes, on the
    current stream: ``"tiled"`` (the kernel every path takes, with
    :func:`decode_launch_plan`) or ``"general"`` (the first port's kernel,
    equal to it on every byte, for comparisons).  int16 (N, bh, bw, 64)
    planes and (N, ncomp, 64) integer quant tables (int32 as the loader
    delivers them; other integer types are converted) -> (N, H, W, 3) or, for
    one component, (N, H, W).  Each launch adds one to
    ``jpeg_decode_kernel.launches`` and to its kernel's own count
    (``launches_tiled`` or ``launches_general``)."""
    if kernel not in JPEG_DECODE_KERNELS:
        raise ValueError(f"kernel must be one of {JPEG_DECODE_KERNELS}, got {kernel!r}")
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

    def aligned(t):  # the tiled kernel copies planes and quant tables in 16-byte units
        t = t.contiguous()
        return t.clone() if t.data_ptr() % 16 else t

    qtabs = aligned(qtabs.reshape(n, len(planes), 64).to(torch.int32))
    flat = [aligned(p.reshape(n, *p.shape[-3:])) for p in planes]
    channels = 3 if len(planes) == 3 else 1
    out = torch.empty((n, height, width, channels), dtype=out_dtype, device=device)
    if n:
        lib = build.load("jpeg_decode", _configure)
        ptrs = (ctypes.c_void_p * _MAX_COMPS)(*[p.data_ptr() for p in flat])
        blocks = tuple(tuple(p.shape[1:3]) for p in flat)
        cblocks = (ctypes.c_int * (2 * _MAX_COMPS))(*[d for b in blocks for d in b])
        samp = (ctypes.c_int * (2 * _MAX_COMPS))(*[f for s in sampling for f in s])
        basis = _idct_basis()
        args = (len(planes), ctypes.addressof(ptrs), ctypes.addressof(cblocks),
                ctypes.addressof(samp), qtabs.data_ptr(), n, height, width,
                int(bool(fancy_upsampling)), basis.ctypes.data, out.data_ptr(),
                _OUT_DTYPES[out_dtype])
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            if kernel == "tiled":
                plan = decode_launch_plan(n, (height, width), tuple(map(tuple, sampling)), blocks,
                                          bool(fancy_upsampling), _sm_count(device.index))
                ints = plan.ints()
                err = lib.pst_jpeg_decode_tiled(*args, (ctypes.c_int * len(ints))(*ints),
                                                len(ints), stream)
            else:
                err = lib.pst_jpeg_decode(*args, stream)
        if err != 0:
            raise RuntimeError(f"jpeg decode {kernel} kernel launch failed (error {err})")
        jpeg_decode_kernel.launches += 1
        counter = f"launches_{kernel}"
        setattr(jpeg_decode_kernel, counter, getattr(jpeg_decode_kernel, counter) + 1)
    out = out.reshape(*lead, height, width, channels)
    return out if channels == 3 else out[..., 0]


def jpeg_decode_kernel(planes: Sequence[torch.Tensor], qtabs: torch.Tensor,
                       image_size: Tuple[int, int], sampling: Tuple[Tuple[int, int], ...],
                       out_dtype: torch.dtype = torch.uint8,
                       fancy_upsampling: bool = True) -> torch.Tensor:
    """Kernel B2 on CUDA planes: the tiled kernel (see
    :func:`launch_jpeg_decode`).  ``jpeg_decode_kernel.launches`` counts
    every B2 launch, ``.launches_tiled`` and ``.launches_general`` each
    kernel's."""
    return launch_jpeg_decode(planes, qtabs, image_size, sampling, out_dtype, fancy_upsampling,
                              kernel="tiled")


jpeg_decode_kernel.launches = 0
jpeg_decode_kernel.launches_tiled = 0
jpeg_decode_kernel.launches_general = 0


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
