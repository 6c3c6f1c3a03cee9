"""Plain decode, pad, crop-resize and normalize: the reference's input side.

- :func:`decode`: a JPEG stream to uint8 RGB ``(H, W, 3)`` by OpenCV's
  libjpeg (a grayscale stream repeated to three channels).
- :func:`pad`: an image zero-padded at the bottom and right to the
  loader's target, which is the canvas every crop of the program samples.
- :func:`resized_crop`: ``jax.image.scale_and_translate``'s bilinear
  resample as float32 weight matrices (the triangle filter, widened by
  the downscale with ``antialias``, normalized by its sum, zero for
  samples outside the image), contracted over rows then columns, a flip of
  the flagged outputs, rounded half to even and clipped to uint8, as the
  program's crop writes uint8.  ``boxes`` are ``(y0, x0, crop_h, crop_w)``;
  output pixel ``o`` samples ``(o + 0.5) * inv_scale - translation *
  inv_scale - 0.5`` with ``scale = out / crop``, ``translation = -corner *
  scale``.
- :func:`normalize`: ``(x / 255 - mean) / std`` in float32.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

_F32_EPS = float(np.finfo(np.float32).eps)


def decode(stream: bytes) -> np.ndarray:
    import cv2

    img = cv2.imdecode(np.frombuffer(stream, np.uint8), cv2.IMREAD_COLOR)
    if img is None:
        raise ValueError("cv2.imdecode could not decode a corpus stream")
    return np.ascontiguousarray(img[..., ::-1])


def pad(img: np.ndarray, target: Sequence[int]) -> np.ndarray:
    out = np.zeros(tuple(target), np.uint8)
    h, w = min(img.shape[0], target[0]), min(img.shape[1], target[1])
    out[:h, :w] = img[:h, :w]
    return out


def _weights(in_size: int, out_size: int, inv_scale: torch.Tensor, translation: torch.Tensor,
             antialias: bool) -> torch.Tensor:
    """(N, in, out) float32 bilinear weights."""
    device = inv_scale.device
    inv_scale = inv_scale[:, None]
    kernel_scale = torch.clamp_min(inv_scale, 1.0) if antialias else torch.ones_like(inv_scale)
    o = torch.arange(out_size, dtype=torch.float32, device=device)
    sample = ((o + 0.5) * inv_scale - translation[:, None] * inv_scale) - 0.5
    i = torch.arange(in_size, dtype=torch.float32, device=device)
    x = torch.abs(sample[:, None, :] - i[None, :, None]) / kernel_scale[:, :, None]
    w = torch.clamp_min(1.0 - x, 0.0)
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * _F32_EPS,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[:, None, :], w, torch.zeros_like(w))


def crop_params(boxes: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """(N, 4) ``(inv_scale_y, translation_y, inv_scale_x, translation_x)``
    float32: ``inv_scale = crop * fl(1 / out)``, ``translation = -corner *
    (out / crop)``."""
    y0, x0, ch, cw = boxes.float().unbind(1)
    oh, ow = out_hw
    sy, sx = torch.full_like(ch, float(oh)) / ch, torch.full_like(cw, float(ow)) / cw
    inv_oh, inv_ow = (float(np.float32(1.0) / np.float32(v)) for v in out_hw)
    return torch.stack([ch * inv_oh, -y0 * sy, cw * inv_ow, -x0 * sx], dim=1)


def resized_crop(images: torch.Tensor, boxes: torch.Tensor, out_hw: Tuple[int, int],
                 flips=None, antialias: bool = False) -> torch.Tensor:
    """uint8 ``(N, H, W, C)`` -> uint8 ``(N, oh, ow, C)``."""
    n, h, w, _ = images.shape
    params = crop_params(boxes, out_hw)
    wy = _weights(h, out_hw[0], params[:, 0], params[:, 1], antialias)
    wx = _weights(w, out_hw[1], params[:, 2], params[:, 3], antialias)
    rows = torch.einsum("nhwc,nho->nowc", images.float(), wy)
    out = torch.einsum("nowc,nwp->nopc", rows, wx)
    if flips is not None:
        out = torch.where(torch.as_tensor(flips, device=out.device).bool()[:, None, None, None],
                          out.flip(2), out)
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


def normalize(images_u8: torch.Tensor, mean: Sequence[float],
              std: Sequence[float]) -> torch.Tensor:
    mean_t = torch.tensor(mean, dtype=torch.float32, device=images_u8.device)
    std_t = torch.tensor(std, dtype=torch.float32, device=images_u8.device)
    return (images_u8.float() / 255.0 - mean_t) / std_t
