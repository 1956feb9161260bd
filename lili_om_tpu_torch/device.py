"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device. A CUDA device that is not present
    raises: the port never drops to the CPU on its own — pass
    ``device="cpu"`` to ask for it."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "lili_om_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run on the CPU")
    return device
