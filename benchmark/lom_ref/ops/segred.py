"""Sorted segment sum, plain PyTorch only: the port's ``ops/segred.py``
with its CUDA route removed (``index_add_`` on every device)."""
from __future__ import annotations

import torch


def segment_sum_sorted_plain(payload: torch.Tensor, seg_id: torch.Tensor,
                             num_out: int) -> torch.Tensor:
    """The plain version: rows with an id ≥ ``num_out`` land in one extra
    row, which is cut off."""
    out = torch.zeros((num_out + 1,) + payload.shape[1:], dtype=payload.dtype,
                      device=payload.device)
    return out.index_add_(0, torch.clamp(seg_id, max=num_out), payload)[:num_out]




def segment_sum_auto(payload, seg_id, num_out: int) -> torch.Tensor:
    """The plain :func:`segment_sum_sorted_plain` on every device."""
    return segment_sum_sorted_plain(payload, seg_id, num_out)
