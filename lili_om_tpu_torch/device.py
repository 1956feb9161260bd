"""Device resolution shared by every entry point of the port, the switch
that holds the CUDA kernels against their plain versions, and the cache of
constant tensors."""
from __future__ import annotations

import contextlib

import torch

_FORCE_PLAIN = False
_CONSTS: dict = {}


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


@contextlib.contextmanager
def plain_kernels():
    """Every dispatcher (``knn_auto``, ``segment_sum_auto``) runs its plain
    version on CUDA tensors too — for holding the kernels against it
    (chip_smoke.py); never used by the pipeline itself."""
    global _FORCE_PLAIN
    prev, _FORCE_PLAIN = _FORCE_PLAIN, True
    try:
        yield
    finally:
        _FORCE_PLAIN = prev


def use_kernel(x: torch.Tensor) -> bool:
    """Whether a dispatcher launches its CUDA kernel for tensor ``x``: it is
    on a CUDA device and :func:`plain_kernels` is not active."""
    return x.device.type == "cuda" and not _FORCE_PLAIN


def const(values: tuple, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, uploaded once
    per (values, dtype, device) and shared by every caller, who never
    writes to it. A loop that reads it uploads nothing, so it neither
    synchronizes nor stops a CUDA graph's capture."""
    key = (values, dtype, device)
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.tensor(values, dtype=dtype, device=device)
    return t
