"""Batched image augmentation on the device: crops, flips, mixes, resizes.

Counterpart of ``petastorm_tpu/ops/augment.py``: the ImageNet training
transforms run on the card after delivery, uint8 in and uint8 out, with
per-image randomness, so the host workers stay decode-only.

Randomness: every random op takes a ``torch.Generator`` on the images' device
and draws there.  Torch's Philox and JAX's threefry give different numbers
from one seed, so each op also takes its draws explicitly (keyword-only: crop
offsets, flip bits, a permutation, a mixing weight, a box, crop boxes); given
those, it is a deterministic function that the tests hold against the JAX
package.  When every draw is given, the generator is not used.

The resample of ``random_resized_crop`` and ``resize_images`` is
``jax.image.scale_and_translate`` with one of jax's filters: triangle
(``bilinear``), Keys cubic (``cubic``, a = -0.5), ``lanczos3`` or
``lanczos5``; ``resize_images`` also takes ``nearest`` (a gather).  The method
names are ``jax.image.ResizeMethod.from_string``'s, and an unknown one raises
``ValueError`` as there.  On a CUDA tensor the resample runs in a hand-written
Hopper kernel of ``csrc/resized_crop.cu`` (which replaces the XLA-compiled
dense weight matrices of ``jax/_src/image/scale.py::compute_weight_mat``),
with an optional per-image horizontal flip fused in.  Bilinear uint8 takes the
tiled kernel without antialias and the antialiased tiled kernel with it.
The file's general kernel takes every bilinear image that is not uint8, in
its float32 instance (other dtypes are converted to float32 and back, as the
reference does); its bilinear uint8 instance is reachable only by naming it
to :func:`launch_resized_crop`: it is the byte oracle of the card checks.
The other filters run in the general kernel's instance for that filter
(``launch_resized_crop(..., kernel="general", method=...)``), uint8 and
float32 alike, and ``nearest`` in a gather kernel (:func:`nearest_kernel`); a
CUDA tensor takes a kernel or raises.  On a CPU tensor the plain PyTorch version runs:
``_scale_and_translate`` builds the same weight matrices with the same
float32 expressions and contracts rows, then columns, and
``_resize_nearest_reference`` gathers.  Crop, flip, mixup and cutmix are
selections or blends and stay torch ops on both devices.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from petastorm_tpu_torch.cuda import build
from petastorm_tpu_torch.device import resolve_device

_F32_EPS = float(np.finfo(np.float32).eps)

#: jax.image.ResizeMethod.from_string's names, by the port's filter name
_METHOD_NAMES = {"nearest": ("nearest",),
                 "linear": ("linear", "bilinear", "trilinear", "triangle"),
                 "lanczos3": ("lanczos3",), "lanczos5": ("lanczos5",),
                 "cubic": ("cubic", "bicubic", "tricubic")}
_METHODS = {name: method for method, names in _METHOD_NAMES.items() for name in names}
#: the filter number of each method ``pst_resample_u8``/``_f32`` take (csrc/resized_crop.cu)
FILTERS = {"linear": 0, "cubic": 1, "lanczos3": 2, "lanczos5": 3}


_COMMON_ARGS = [
    ctypes.c_void_p,     # const uint8_t* in, NHWC
    ctypes.c_void_p,     # uint8_t* out, NHWC
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # n, h, w, c
    ctypes.c_int, ctypes.c_int,                              # oh, ow
    ctypes.c_void_p,     # const float* params (device, n x 4)
    ctypes.c_void_p,     # const uint8_t* flips (device, n) or null
]


def _configure_tiled(lib: ctypes.CDLL) -> None:
    """The entries of the two tiled kernels, which every revision of
    ``csrc/resized_crop.cu`` has (``examples/imagenet/crop_ab.py`` times
    earlier ones)."""
    lib.pst_resized_crop_tiled_u8.restype = ctypes.c_int
    lib.pst_resized_crop_tiled_u8.argtypes = _COMMON_ARGS + [ctypes.c_void_p]  # cudaStream_t
    lib.pst_resized_crop_aa_u8.restype = ctypes.c_int
    lib.pst_resized_crop_aa_u8.argtypes = _COMMON_ARGS + [ctypes.c_int] * 6 + [  # the plan
        ctypes.c_void_p,     # scratch (device) for the pre-pass's axis tables
        ctypes.c_longlong,   # its bytes
        ctypes.c_void_p]     # cudaStream_t


def _configure(lib: ctypes.CDLL) -> None:
    for general in (lib.pst_resample_u8, lib.pst_resample_f32):
        general.restype = ctypes.c_int
        general.argtypes = _COMMON_ARGS + [ctypes.c_int,      # filter (FILTERS)
                                           ctypes.c_int,      # antialias
                                           ctypes.c_void_p]   # cudaStream_t
    _configure_tiled(lib)
    lib.pst_resize_nearest.restype = ctypes.c_int
    lib.pst_resize_nearest.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,                # in, out (NHWC)
        ctypes.c_int, ctypes.c_int, ctypes.c_int,        # n, h, w
        ctypes.c_int,                                    # bytes a pixel
        ctypes.c_int, ctypes.c_int,                      # oh, ow
        ctypes.c_void_p]                                 # cudaStream_t


def resize_method(method: str) -> str:
    """The filter of a jax.image method name: ``'nearest'``, ``'linear'``,
    ``'cubic'``, ``'lanczos3'`` or ``'lanczos5'``; ``ValueError`` for a name
    ``jax.image.ResizeMethod.from_string`` does not know (its message)."""
    try:
        return _METHODS[method]
    except (KeyError, TypeError):
        raise ValueError(f'Unknown resize method "{method}"') from None


def _restore_dtype(out: torch.Tensor, src_dtype: torch.dtype) -> torch.Tensor:
    """float32 result -> the source dtype: round half to even and clip for integers."""
    if not src_dtype.is_floating_point:
        info = torch.iinfo(src_dtype)
        return torch.clamp(torch.round(out), info.min, info.max).to(src_dtype)
    return out.to(src_dtype)


# -- selections ----------------------------------------------------------


def random_crop(images: torch.Tensor, generator: Optional[torch.Generator],
                crop_hw: Tuple[int, int], *,
                offsets: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """Per-image random crop of an (N, H, W, C) batch to (N, ch, cw, C).

    ``offsets``: the (ys, xs) integer corners, each of shape (N,); drawn
    uniformly from ``[0, H - ch]`` and ``[0, W - cw]`` when None."""
    n, h, w, _ = images.shape
    ch, cw = crop_hw
    if ch > h or cw > w:
        raise ValueError(f"crop {tuple(crop_hw)} larger than image {(h, w)}")
    if offsets is None:
        offsets = (torch.randint(0, h - ch + 1, (n,), generator=generator, device=images.device),
                   torch.randint(0, w - cw + 1, (n,), generator=generator, device=images.device))
    ys, xs = (torch.as_tensor(o, device=images.device).long() for o in offsets)
    rows = (ys[:, None] + torch.arange(ch, device=images.device))[:, :, None]
    cols = (xs[:, None] + torch.arange(cw, device=images.device))[:, None, :]
    return images[torch.arange(n, device=images.device)[:, None, None], rows, cols]


def draw_flips(n: int, generator: Optional[torch.Generator],
               device="cuda") -> torch.Tensor:
    """(N,) bool on ``device``: each image flipped with probability 0.5."""
    return torch.rand(n, generator=generator, device=resolve_device(device)) < 0.5


def random_flip(images: torch.Tensor, generator: Optional[torch.Generator], *,
                flips: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-image horizontal flip with probability 0.5, (N, H, W, C).

    ``flips``: (N,) bools; drawn when None."""
    if flips is None:
        flips = draw_flips(images.shape[0], generator, images.device)
    flips = torch.as_tensor(flips, device=images.device).bool()
    return torch.where(flips[:, None, None, None], images.flip(2), images)


def random_crop_flip(images: torch.Tensor, generator: Optional[torch.Generator],
                     crop_hw: Optional[Tuple[int, int]] = None, *,
                     offsets: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                     flips: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Crop (when ``crop_hw`` is set) then flip: the ImageNet train pair."""
    if crop_hw is not None:
        images = random_crop(images, generator, crop_hw, offsets=offsets)
    return random_flip(images, generator, flips=flips)


# -- mixing --------------------------------------------------------------


def _beta(alpha: float, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """One Beta(alpha, alpha) draw, float32, as the ratio of two Gamma draws."""
    a = torch.full((2,), float(alpha), dtype=torch.float32, device=device)
    g = torch._standard_gamma(a, generator=generator)
    return g[0] / (g[0] + g[1])


def mixup(images: torch.Tensor, labels: torch.Tensor, generator: Optional[torch.Generator],
          alpha: float = 0.2, *, lam=None, perm: Optional[torch.Tensor] = None):
    """Batch mixup (Zhang et al. 2017): blend each image with a permuted
    partner using one weight per batch, ``lam = max(b, 1 - b)`` with
    ``b ~ Beta(alpha, alpha)``.

    Returns ``(mixed_images, labels, permuted_labels, lam)``.  uint8 images
    mix in float32 and come back uint8 (round half to even, clip); float
    images keep their dtype.  ``lam`` (the weight after the max) and ``perm``
    are drawn when None."""
    device = images.device
    if lam is None:
        b = _beta(alpha, generator, device)
        lam = torch.maximum(b, 1.0 - b)
    lam = torch.as_tensor(lam, dtype=torch.float32, device=device)
    if perm is None:
        perm = torch.randperm(images.shape[0], generator=generator, device=device)
    perm = torch.as_tensor(perm, device=device).long()
    x = images.float()
    mixed = lam * x + (1.0 - lam) * x[perm]
    return _restore_dtype(mixed, images.dtype), labels, labels[perm], lam


def draw_cutmix_box(h: int, w: int, generator: Optional[torch.Generator], alpha: float = 1.0,
                    device="cuda") -> torch.Tensor:
    """(4,) int32 ``(y0, y1, x0, x1)`` on ``device``: a box of side fraction
    ``sqrt(1 - b)``, ``b ~ Beta(alpha, alpha)``, centred uniformly and clipped
    to the image."""
    device = resolve_device(device)
    cut = torch.sqrt(1.0 - _beta(alpha, generator, device))
    half = torch.stack([(cut * h).int(), (cut * w).int()]) // 2
    centre = torch.stack([torch.randint(0, h, (), generator=generator, device=device),
                          torch.randint(0, w, (), generator=generator, device=device)]).int()
    hw = torch.tensor([h, w], dtype=torch.int32, device=device)
    lo = torch.minimum(torch.clamp_min(centre - half, 0), hw)
    hi = torch.minimum(torch.clamp_min(centre + half, 0), hw)
    return torch.stack([lo[0], hi[0], lo[1], hi[1]])


def cutmix(images: torch.Tensor, labels: torch.Tensor, generator: Optional[torch.Generator],
           alpha: float = 1.0, *, box=None, perm: Optional[torch.Tensor] = None):
    """Batch CutMix (Yun et al. 2019): paste one box from a permuted partner
    into every image (one box per batch, the paper's formulation).

    Returns ``(mixed_images, labels, permuted_labels, lam)`` with ``lam`` the
    kept-area fraction of the box ``(y0, y1, x0, x1)``.  The dtype is kept
    exactly (pure selection).  ``box`` and ``perm`` are drawn when None."""
    n, h, w, _ = images.shape
    device = images.device
    if box is None:
        box = draw_cutmix_box(h, w, generator, alpha, device)
    if perm is None:
        perm = torch.randperm(n, generator=generator, device=device)
    perm = torch.as_tensor(perm, device=device).long()
    y0, y1, x0, x1 = torch.as_tensor(box, device=device).int().unbind()
    rows = torch.arange(h, device=device)[None, :, None, None]
    cols = torch.arange(w, device=device)[None, None, :, None]
    in_box = (rows >= y0) & (rows < y1) & (cols >= x0) & (cols < x1)
    mixed = torch.where(in_box, images[perm], images)
    area = ((y1 - y0) * (x1 - x0)).float()
    lam = 1.0 - area / torch.tensor(float(h * w), device=device)
    return mixed, labels, labels[perm], lam


# -- resample ------------------------------------------------------------


def _filter(method: str, x: torch.Tensor) -> torch.Tensor:
    """jax's kernel function of ``method`` on float32 ``x`` >= 0
    (``jax/_src/image/scale.py``: ``_fill_triangle_kernel``,
    ``_fill_keys_cubic_kernel``, ``_fill_lanczos_kernel(radius, x)``), in its
    float32 expressions and order."""
    if method == "linear":
        return torch.clamp_min(1.0 - torch.abs(x), 0.0)
    if method == "cubic":
        out = ((1.5 * x - 2.5) * x) * x + 1.0
        out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
        return torch.where(x >= 2.0, torch.zeros_like(x), out)
    radius = {"lanczos3": 3.0, "lanczos5": 5.0}[method]
    y = radius * torch.sin(np.pi * x) * torch.sin(np.pi * x / radius)
    safe = torch.where(x != 0, np.pi ** 2 * x ** 2, torch.ones_like(x))
    out = torch.where(x > 1e-3, y / safe, torch.ones_like(x))
    return torch.where(x > radius, torch.zeros_like(x), out)


def _weight_mats(in_size: int, out_size: int, inv_scale: torch.Tensor,
                 translation: torch.Tensor, antialias: bool,
                 method: str = "linear") -> torch.Tensor:
    """(N, in, out) float32 weights of ``method``'s filter, one matrix per
    image, with the float32 expressions of
    ``jax/_src/image/scale.py::compute_weight_mat`` in its order."""
    device = inv_scale.device
    inv_scale = inv_scale[:, None]
    kernel_scale = (torch.clamp_min(inv_scale, 1.0) if antialias
                    else torch.ones_like(inv_scale))
    o = torch.arange(out_size, dtype=torch.float32, device=device)
    sample_f = ((o + 0.5) * inv_scale - translation[:, None] * inv_scale) - 0.5  # (N, out)
    i = torch.arange(in_size, dtype=torch.float32, device=device)
    x = torch.abs(sample_f[:, None, :] - i[None, :, None]) / kernel_scale[:, :, None]
    weights = _filter(method, x)
    total = torch.sum(weights, dim=1, keepdim=True)
    weights = torch.where(torch.abs(total) > 1000.0 * _F32_EPS,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[:, None, :], weights, torch.zeros_like(weights))


def _scale_and_translate(x: torch.Tensor, out_hw: Tuple[int, int], params: torch.Tensor,
                         antialias: bool, method: str = "linear") -> torch.Tensor:
    """Plain version of the resample: float32 (N, H, W, C) -> (N, oh, ow, C).

    ``params`` is (N, 4) float32 ``(inv_scale_y, translation_y, inv_scale_x,
    translation_x)``; output pixel ``o`` samples input coordinate
    ``(o + 0.5) * inv_scale - translation * inv_scale - 0.5``.  Contracts the
    rows, then the columns."""
    _, h, w, _ = x.shape
    oh, ow = out_hw
    wy = _weight_mats(h, oh, params[:, 0], params[:, 1], antialias, method)
    wx = _weight_mats(w, ow, params[:, 2], params[:, 3], antialias, method)
    rows = torch.einsum("nhwc,nho->nowc", x, wy)
    return torch.einsum("nowc,nwp->nopc", rows, wx)


def _resized_crop_reference(images: torch.Tensor, params: torch.Tensor,
                            flips: Optional[torch.Tensor], out_hw: Tuple[int, int],
                            antialias: bool, method: str = "linear") -> torch.Tensor:
    """Plain version of the kernel: resample, flip the flagged outputs, back to the source dtype."""
    out = _scale_and_translate(images.float(), out_hw, params, antialias, method)
    if flips is not None:
        out = torch.where(flips.bool()[:, None, None, None], out.flip(2), out)
    return _restore_dtype(out, images.dtype)


def _nearest_offsets(in_size: int, out_size: int, device) -> torch.Tensor:
    """``floor(float32((o + 0.5) * in / out))`` for each output position, in
    float32 as ``jax/_src/image/scale.py::_resize_nearest`` computes it,
    clamped to the input as jax's gather clamps an index."""
    o = torch.arange(out_size, dtype=torch.float32, device=device)
    return torch.clamp(torch.floor((o + 0.5) * in_size / out_size).long(), 0, in_size - 1)


def _resize_nearest_reference(images: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Plain version of the nearest kernel: one source pixel an output pixel."""
    _, h, w, _ = images.shape
    rows = _nearest_offsets(h, out_hw[0], images.device)
    cols = _nearest_offsets(w, out_hw[1], images.device)
    return images[:, rows][:, :, cols]


# Launch plan of the antialiased tiled kernel (csrc/resized_crop.cu).
AA_MAX_SHARED_BYTES = 232448     # an sm_90 block's dynamic shared memory
AA_TARGET_SHARED_BYTES = 64 * 1024   # several blocks an SM
_AA_AXIS_BYTES = 24              # sizeof(Axis) in the kernel
_AA_GROUP = 4                    # channels accumulated in registers (kChunk)
_AA_ROWS, _AA_COLS, _AA_MIN_COLS = 8, 256, 32
_AA_MAX_CAP = 1024               # taps past a table's capacity are computed in the kernel
_AA_SCALE_MARGIN = 1.0 + 2.0 ** -16  # inv_scale above in/out by float rounding


class AaPlan(NamedTuple):
    """Sizes of one launch of the antialiased tiled kernel: a tile of
    ``rows`` x ``cols`` output pixels, row and column weight tables of
    ``cap_y`` and ``cap_x`` taps (built by its pre-pass in device memory),
    vertical sums over ``span`` source columns at a time, ``group`` channels
    at a time."""
    rows: int
    cols: int
    cap_y: int
    cap_x: int
    span: int
    group: int

    @property
    def shared_bytes(self) -> int:
        """Dynamic shared memory of a block (the kernel's aa_shared_bytes)."""
        return (_AA_AXIS_BYTES * (self.rows + self.cols)
                + 4 * (self.rows * self.span * self.group + self.rows * self.cols * self.group))

    def scratch_bytes(self, n: int, oh: int, ow: int) -> int:
        """Device scratch of the pre-pass's tables: every image's oh + ow axes
        and their weights (the kernel's aa_scratch_bytes)."""
        return n * (oh + ow) * _AA_AXIS_BYTES + 4 * n * (oh * self.cap_y + ow * self.cap_x)


def _aa_taps(in_size: int, out_size: int) -> int:
    """Most taps [lo, hi] an output position walks: kernel_scale is at most
    max(1, in/out) up to float rounding (a box is no larger than the image,
    and resize_images sets inv_scale = in/out), and hi - lo <= 2 * kernel_scale + 2;
    at most ``_AA_MAX_CAP``."""
    kernel_scale = max(1.0, in_size / out_size) * _AA_SCALE_MARGIN
    return min(in_size, _AA_MAX_CAP, math.floor(2.0 * kernel_scale) + 3)


@functools.lru_cache(maxsize=64)
def aa_launch_plan(h: int, w: int, c: int, oh: int, ow: int) -> AaPlan:
    """The antialiased tiled kernel's plan from the shapes alone (reading
    ``params`` back would make the host wait on the card).

    Column tiles of at most 256 (a block's threads) split ``ow`` evenly; a
    span holds the source columns of a tile's taps.  Over
    ``AA_TARGET_SHARED_BYTES`` the tile narrows to 32 columns, then the span
    is cut (the kernel walks it in chunks), then the channel group and the
    rows.  Any plan is correct: the sizes only trade speed."""
    rows, group = min(_AA_ROWS, oh), min(c, _AA_GROUP)
    cap_y, cap_x = _aa_taps(h, oh), _aa_taps(w, ow)
    spacing = (w / ow) * _AA_SCALE_MARGIN  # source columns between neighbouring outputs

    def plan(rows, cols, group, span=None):
        if span is None:
            span = min(w, math.ceil((cols - 1) * spacing) + cap_x + 2)
        return AaPlan(rows, cols, cap_y, cap_x, span, group)

    p = plan(rows, -(-ow // -(-ow // _AA_COLS)), group)
    while p.shared_bytes > AA_TARGET_SHARED_BYTES and p.cols > min(ow, _AA_MIN_COLS):
        p = plan(rows, max(min(ow, _AA_MIN_COLS), -(-p.cols // 2)), group)
    if p.shared_bytes > AA_TARGET_SHARED_BYTES:  # the kernel walks the span in chunks
        fixed = plan(rows, p.cols, group, span=0).shared_bytes
        p = plan(rows, p.cols, group, span=max(1, (AA_TARGET_SHARED_BYTES - fixed)
                                               // (4 * rows * group)))
    while p.shared_bytes > AA_MAX_SHARED_BYTES and p.group > 1:
        p = plan(p.rows, p.cols, max(1, p.group // 2), p.span)
    while p.shared_bytes > AA_MAX_SHARED_BYTES and p.cols > 1:
        p = plan(p.rows, max(1, p.cols // 2), p.group, p.span)
    while p.shared_bytes > AA_MAX_SHARED_BYTES and p.rows > 1:
        p = plan(max(1, p.rows // 2), p.cols, p.group, p.span)
    return p


RESIZED_CROP_KERNELS = ("tiled", "aa", "general")


def launch_resized_crop(images: torch.Tensor, params: torch.Tensor,
                        flips: Optional[torch.Tensor], out_hw: Tuple[int, int],
                        antialias: bool, kernel: str, method: str = "linear") -> torch.Tensor:
    """Launch one kernel of ``csrc/resized_crop.cu`` on a contiguous CUDA
    NHWC tensor, on the current stream: ``"tiled"`` (bilinear uint8, two taps
    per axis, so ``antialias`` must be False), ``"aa"`` (the antialiased tiled
    kernel, bilinear uint8, so ``antialias`` must be True) or ``"general"``
    (one thread a pixel, either; uint8 or float32, with ``method``'s filter:
    ``linear``, ``cubic``, ``lanczos3`` or ``lanczos5``; it writes the source
    dtype, uint8 rounded half to even and clipped, float32 unrounded).
    Each launch adds one to ``resized_crop_kernel.launches`` and to its
    kernel's own count (``launches_tiled``, ``launches_aa``,
    ``launches_general`` for the general kernel's bilinear instance, or
    ``launches_<method>`` for its other filters).

    ``params``: (N, 4) float32 as for :func:`_scale_and_translate`, on the
    same device; ``flips``: (N,) flags (nonzero = mirror the output columns) or None."""
    if kernel not in RESIZED_CROP_KERNELS:
        raise ValueError(f"kernel must be one of {RESIZED_CROP_KERNELS}, got {kernel!r}")
    if method not in FILTERS or (kernel != "general" and method != "linear"):
        raise ValueError(f"the {kernel} resized-crop kernel cannot take method {method!r}")
    if images.device.type != "cuda":
        raise ValueError(f"resized_crop_kernel takes a CUDA tensor, got {images.device}")
    dtypes = (torch.uint8, torch.float32) if kernel == "general" else (torch.uint8,)
    if images.dtype not in dtypes or images.dim() != 4:
        raise TypeError(f"the {kernel} resized-crop kernel takes"
                        f" {' or '.join(str(d) for d in dtypes)} NHWC images, got"
                        f" {images.dtype} {tuple(images.shape)}")
    if not images.is_contiguous():
        raise ValueError("resized-crop kernel takes a contiguous tensor; call .contiguous()")
    if kernel == "tiled" and antialias:
        raise ValueError("the tiled resized-crop kernel takes two taps per axis: no antialias")
    if kernel == "aa" and not antialias:
        raise ValueError("the antialiased tiled resized-crop kernel takes antialias only")
    n, h, w, c = images.shape
    oh, ow = out_hw
    if min(h, w, c, oh, ow) < 1 or max(n, h, w, c, oh, ow) >= 2 ** 31:
        raise ValueError(f"resized-crop kernel cannot take {tuple(images.shape)} -> {out_hw}")
    params = params.to(device=images.device, dtype=torch.float32).contiguous()
    if params.shape != (n, 4):
        raise ValueError(f"params must be ({n}, 4), got {tuple(params.shape)}")
    if flips is not None:
        flips = flips.to(device=images.device, dtype=torch.uint8).contiguous()
        if flips.shape != (n,):
            raise ValueError(f"flips must be ({n},), got {tuple(flips.shape)}")
    lib = build.load("resized_crop", _configure)
    out = torch.empty((n, oh, ow, c), dtype=images.dtype, device=images.device)
    args = (images.data_ptr(), out.data_ptr(), n, h, w, c, oh, ow, params.data_ptr(),
            None if flips is None else flips.data_ptr())
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream(images.device).cuda_stream
        if kernel == "tiled":
            err = lib.pst_resized_crop_tiled_u8(*args, stream)
        elif kernel == "aa":
            plan = aa_launch_plan(h, w, c, oh, ow)
            scratch = torch.empty(plan.scratch_bytes(n, oh, ow), dtype=torch.uint8,
                                  device=images.device)
            err = lib.pst_resized_crop_aa_u8(*args, *plan, scratch.data_ptr(), scratch.numel(),
                                             stream)
        else:
            general = (lib.pst_resample_u8 if images.dtype == torch.uint8
                       else lib.pst_resample_f32)
            err = general(*args, FILTERS[method], int(antialias), stream)
    if err != 0:
        raise RuntimeError(f"resized-crop kernel launch failed (error {err})")
    if n:
        resized_crop_kernel.launches += 1
        counter = f"launches_{kernel if method == 'linear' else method}"
        setattr(resized_crop_kernel, counter, getattr(resized_crop_kernel, counter) + 1)
    return out


def resized_crop_kernel(images: torch.Tensor, params: torch.Tensor,
                        flips: Optional[torch.Tensor], out_hw: Tuple[int, int],
                        antialias: bool) -> torch.Tensor:
    """The resample on a CUDA tensor: the tiled kernel without antialias (every
    crop of the training step), the antialiased tiled kernel with it.  The
    choice reads only the flag, never ``params``, so the host does not wait on
    the card.  ``resized_crop_kernel.launches`` counts every kernel's
    launches, ``.launches_tiled``, ``.launches_aa``, ``.launches_general``,
    ``.launches_cubic``, ``.launches_lanczos3`` and ``.launches_lanczos5``
    each one's (see :func:`launch_resized_crop`)."""
    return launch_resized_crop(images, params, flips, out_hw, antialias,
                               kernel="aa" if antialias else "tiled")


resized_crop_kernel.launches = 0
resized_crop_kernel.launches_tiled = 0
resized_crop_kernel.launches_aa = 0
resized_crop_kernel.launches_general = 0
resized_crop_kernel.launches_cubic = 0
resized_crop_kernel.launches_lanczos3 = 0
resized_crop_kernel.launches_lanczos5 = 0


def nearest_kernel(images: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """``resize_images(method='nearest')`` on a contiguous CUDA uint8 or
    float32 NHWC tensor, on the current stream: one launch of the gather
    kernel (``csrc/resized_crop.cu``, ``pst_resize_nearest``), which copies
    each output pixel's source pixel whole.  Each launch adds one to
    ``nearest_kernel.launches``."""
    if images.device.type != "cuda":
        raise ValueError(f"the nearest kernel takes a CUDA tensor, got {images.device}")
    if images.dtype not in (torch.uint8, torch.float32) or images.dim() != 4:
        raise TypeError(f"the nearest kernel takes uint8 or float32 NHWC images, got"
                        f" {images.dtype} {tuple(images.shape)}")
    if not images.is_contiguous():
        raise ValueError("the nearest kernel takes a contiguous tensor; call .contiguous()")
    n, h, w, c = images.shape
    oh, ow = out_hw
    pixel_bytes = c * images.element_size()
    if min(h, w, c, oh, ow) < 1 or max(n, h, w, pixel_bytes, oh, ow) >= 2 ** 31:
        raise ValueError(f"nearest kernel cannot take {tuple(images.shape)} -> {out_hw}")
    lib = build.load("resized_crop", _configure)
    out = torch.empty((n, oh, ow, c), dtype=images.dtype, device=images.device)
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream(images.device).cuda_stream
        err = lib.pst_resize_nearest(images.data_ptr(), out.data_ptr(), n, h, w, pixel_bytes,
                                     oh, ow, stream)
    if err != 0:
        raise RuntimeError(f"nearest kernel launch failed (error {err})")
    if n:
        nearest_kernel.launches += 1
    return out


nearest_kernel.launches = 0


def _resample(images: torch.Tensor, params: torch.Tensor, flips: Optional[torch.Tensor],
              out_hw: Tuple[int, int], antialias: bool, method: str = "linear") -> torch.Tensor:
    """The kernel on a CUDA tensor, the plain version on a CPU tensor.  On the
    card bilinear uint8 takes the tiled kernels; everything else takes the
    general kernel's instance for its filter, uint8 and float32 as they are,
    any other dtype resampled in float32 and brought back to its dtype."""
    if images.device.type == "cpu":
        return _resized_crop_reference(images, params, flips, out_hw, antialias, method)
    if method == "linear" and images.dtype == torch.uint8:
        return resized_crop_kernel(images, params, flips, out_hw, antialias)
    x = images if images.dtype in (torch.uint8, torch.float32) else images.float()
    out = launch_resized_crop(x.contiguous(), params, flips, out_hw, antialias,
                              kernel="general", method=method)
    return _restore_dtype(out, images.dtype)


def _resize_nearest(images: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize: the gather kernel on a CUDA tensor (uint8 and float32
    as they are, any other dtype through float32 as the reference does), the
    plain version on a CPU tensor."""
    if images.device.type == "cpu":
        if images.dtype in (torch.uint8, torch.float32):
            return _resize_nearest_reference(images, out_hw)
        return _restore_dtype(_resize_nearest_reference(images.float(), out_hw), images.dtype)
    if images.dtype in (torch.uint8, torch.float32):
        return nearest_kernel(images.contiguous(), out_hw)
    return _restore_dtype(nearest_kernel(images.float().contiguous(), out_hw), images.dtype)


def resize_images(images: torch.Tensor, out_hw: Tuple[int, int], method: str = "bilinear",
                  antialias: bool = True) -> torch.Tensor:
    """Batched resize of (N, H, W, C) to (N, oh, ow, C), ``jax.image.resize``
    semantics (antialiased by default; ``antialias`` has no effect on
    ``nearest``).  uint8 comes back uint8, float dtypes are kept, other
    integers are rounded and clipped back.

    As ``jax.image.resize``, the cubic and Lanczos filters leave an axis whose
    size does not change alone (a Lanczos weight at a whole-pixel distance is
    ``sin`` of a float32 multiple of pi, not 0): such an axis becomes an axis
    of one pixel, the other one's pixels its channels or its images."""
    method = resize_method(method)
    n, h, w, c = images.shape
    oh, ow = out_hw
    if method == "nearest":
        return _resize_nearest(images, out_hw)

    def params(inv_y, inv_x, count):
        # jax.image.resize: scale = out/in and 1/scale in float64, then float32
        inv = torch.tensor([inv_y, 0.0, inv_x, 0.0], dtype=torch.float32)
        return inv.expand(count, 4).to(images.device)

    if method != "linear" and (h == oh or w == ow):
        if h == oh and w == ow:
            return images.clone()
        if h == oh:  # each row an image of one row
            rows = images.reshape(n * h, 1, w, c)
            out = _resample(rows, params(1.0, 1.0 / (ow / w), n * h), None, (1, ow),
                            antialias, method)
            return out.reshape(n, oh, ow, c)
        cols = images.reshape(n, h, 1, w * c)  # a row's pixels its channels
        out = _resample(cols, params(1.0 / (oh / h), 1.0, n), None, (oh, 1), antialias, method)
        return out.reshape(n, oh, ow, c)
    return _resample(images, params(1.0 / (oh / h), 1.0 / (ow / w), n), None, out_hw,
                     antialias, method)


def draw_crop_boxes(n: int, h: int, w: int, generator: Optional[torch.Generator],
                    scale: Tuple[float, float] = (0.08, 1.0),
                    ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
                    device="cuda") -> torch.Tensor:
    """(N, 4) float32 boxes ``(y0, x0, crop_h, crop_w)`` on ``device``: area
    fraction uniform in ``scale``, aspect ratio log-uniform in ``ratio``, sides
    clipped to the image, corner placed uniformly
    (``petastorm_tpu/ops/augment.py:166-178``)."""
    u = torch.rand((4, n), generator=generator, device=resolve_device(device))
    area = (scale[0] + (scale[1] - scale[0]) * u[0]) * (h * w)
    log_lo, log_hi = float(np.log(ratio[0])), float(np.log(ratio[1]))
    r = torch.exp(log_lo + (log_hi - log_lo) * u[1])
    crop_w = torch.clamp(torch.sqrt(area * r), 1.0, float(w))
    crop_h = torch.clamp(torch.sqrt(area / r), 1.0, float(h))
    y0 = u[2] * (h - crop_h)
    x0 = u[3] * (w - crop_w)
    return torch.stack([y0, x0, crop_h, crop_w], dim=1)


def crop_params(boxes: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Boxes ``(y0, x0, crop_h, crop_w)`` -> (N, 4) ``(inv_scale_y,
    translation_y, inv_scale_x, translation_x)`` in float32, as the compiled
    JAX op computes them: ``s = out / crop`` and ``t = -corner * s``, and
    ``inv_scale = 1 / s`` in the form XLA's algebraic simplifier gives it,
    ``crop * fl(1 / out)`` (the form written in the source, an IEEE ``1 / s``,
    differs from it in the last bit for about half the boxes)."""
    boxes = boxes.float()
    y0, x0, ch, cw = boxes.unbind(1)
    oh, ow = out_hw
    # true division: python_scalar / tensor would be reciprocal-then-multiply
    sy, sx = torch.full_like(ch, float(oh)) / ch, torch.full_like(cw, float(ow)) / cw
    inv_oh, inv_ow = (float(np.float32(1.0) / np.float32(v)) for v in out_hw)
    return torch.stack([ch * inv_oh, -y0 * sy, cw * inv_ow, -x0 * sx], dim=1)


def random_resized_crop(images: torch.Tensor, generator: Optional[torch.Generator],
                        out_hw: Tuple[int, int],
                        scale: Tuple[float, float] = (0.08, 1.0),
                        ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
                        method: str = "bilinear", antialias: bool = False, *,
                        boxes: Optional[torch.Tensor] = None,
                        flips: Optional[torch.Tensor] = None) -> torch.Tensor:
    """torchvision-style RandomResizedCrop, batched: each image's box
    ``(y0, x0, crop_h, crop_w)`` (drawn by :func:`draw_crop_boxes` when
    ``boxes`` is None) is resampled to ``out_hw`` with ``method``'s filter
    (``jax.image.scale_and_translate``, which refuses ``nearest`` with a
    ``ValueError``; so does this).

    ``flips`` (N,) mirrors the flagged outputs in the same pass (the JAX
    training step's ``random_flip`` after the crop); None flips nothing.
    On a CUDA tensor: one launch of a resized-crop kernel (bilinear: the
    tiled kernels for uint8, the general kernel in float32 for any other
    dtype; the other filters: their general kernel instance)."""
    method = resize_method(method)
    if method == "nearest":
        raise ValueError("Nearest neighbor resampling is not currently supported for"
                         " scale_and_translate.")
    n, h, w, _ = images.shape
    if boxes is None:
        boxes = draw_crop_boxes(n, h, w, generator, scale, ratio, images.device)
    params = crop_params(torch.as_tensor(boxes, device=images.device), out_hw)
    if flips is not None:
        flips = torch.as_tensor(flips, device=images.device)
    return _resample(images, params, flips, out_hw, antialias, method)
