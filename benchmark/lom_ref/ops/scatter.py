"""Scatter with an explicit rule for duplicate indices.

``img[index] = values`` on a CUDA tensor does not promise which of several
rows written to one cell wins. JAX's ``.at[index].set(values)`` keeps the
last writer (on the CPU, ``zeros(5).at[[3,1,3,3,0,1]].set(arange(6))`` is
``[4,5,0,3,0]``), and the binning of the feature extractors relies on it:
rejected points write zeros into cell 0 after or before valid ones.
"""
from __future__ import annotations

import torch


def scatter_last(index: torch.Tensor, n: int, *values: torch.Tensor):
    """For each value array (N, ...), the (n, ...) array holding at cell
    ``index[r]`` the row of the largest stream index ``r`` written there,
    and zeros where nothing was written. The winner is picked once for all
    arrays: ``scatter_reduce_(..., "amax")`` over ``arange(N)``, then a
    gather."""
    dev = index.device
    winner = torch.full((n,), -1, dtype=torch.int64, device=dev)
    winner.scatter_reduce_(0, index.to(torch.int64),
                           torch.arange(index.shape[0], dtype=torch.int64, device=dev),
                           reduce="amax")
    hit = winner >= 0
    rows = torch.clamp(winner, min=0)
    out = []
    for v in values:
        if v.shape[0] == 0:
            out.append(v.new_zeros((n,) + v.shape[1:]))
            continue
        h = hit.reshape((n,) + (1,) * (v.dim() - 1))
        out.append(torch.where(h, v[rows], torch.zeros((), dtype=v.dtype, device=dev)))
    return tuple(out)
