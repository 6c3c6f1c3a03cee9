"""On-device ops."""

from petastorm_tpu_torch.ops.augment import (cutmix, draw_crop_boxes, draw_flips, mixup,
                                             random_crop, random_crop_flip, random_flip,
                                             random_resized_crop, resize_images)
from petastorm_tpu_torch.ops.normalize import normalize_images

__all__ = ["cutmix", "draw_crop_boxes", "draw_flips", "mixup", "normalize_images",
           "random_crop", "random_crop_flip", "random_flip", "random_resized_crop",
           "resize_images"]
