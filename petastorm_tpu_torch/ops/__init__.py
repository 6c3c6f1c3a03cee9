"""On-device ops."""

from petastorm_tpu_torch.ops.normalize import normalize_images

__all__ = ["normalize_images"]
