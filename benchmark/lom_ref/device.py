"""Device resolution of the reference (the port's ``device.py`` without its
kernel switch: the reference has no kernels)."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device."""
    return torch.device("cuda" if device is None else device)
