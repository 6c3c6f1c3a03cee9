"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; a CUDA device without a visible GPU raises
    instead of falling back to the CPU (pass ``device="cpu"`` for that)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but no CUDA GPU is available;"
            " pass device='cpu' to run on the host")
    return device
