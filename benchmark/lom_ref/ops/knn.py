"""Exact k-nearest-neighbour search, plain PyTorch only: the port's
``ops/knn.py`` with its CUDA routes removed. Every dispatcher runs the plain
:func:`knn` on any device.

Contract: (d² (Q,k) ascending, ties to the lower index, idx (Q,k) int64);
masked points never match; slots without a neighbour and rows of invalid
queries give (+inf, 0).
"""
from __future__ import annotations

import torch

from ..utils.math import quat_rotate


def knn(queries: torch.Tensor, points: torch.Tensor, k: int = 5,
        q_mask: torch.Tensor | None = None, p_mask: torch.Tensor | None = None,
        tile_elems: int = 1 << 24):
    """Exact k-NN of each query among the (masked) points, plain PyTorch.

    The map is walked in tiles of at most 8192 points (fewer for many
    queries, so one tile's distance block stays ≤ ``tile_elems`` entries)."""
    Q, P = queries.shape[0], points.shape[0]
    dev, dtype = queries.device, queries.dtype
    best_d = torch.full((Q, k), float("inf"), dtype=dtype, device=dev)
    best_i = torch.zeros((Q, k), dtype=torch.int64, device=dev)
    tile = max(256, min(8192, tile_elems // max(Q, 1)))
    qx, qy, qz = (queries[:, j:j + 1] for j in range(3))
    for s in range(0, P, tile):
        e = min(P, s + tile)
        p = points[s:e]
        # ((dx²+dy²)+dz²) as separate multiplies and adds: the CUDA kernel
        # sums in this order without FMA, so the two agree bit for bit
        d = qx - p[None, :, 0]
        d.mul_(d)
        for j, c in ((1, qy), (2, qz)):
            t = c - p[None, :, j]
            d.add_(t.mul_(t))
        if p_mask is not None:
            d.masked_fill_(~p_mask[None, s:e], float("inf"))
        # the tile's own k best (argmin: first minimum, so lower index wins)
        ds, is_ = [], []
        for _ in range(min(k, e - s)):
            a = torch.argmin(d, dim=1, keepdim=True)
            ds.append(torch.gather(d, 1, a))
            is_.append(a + s)
            d.scatter_(1, a, float("inf"))
        # merge with the running best; the best holds lower indices, so a
        # stable sort keeps it first among equal distances
        cat_d = torch.cat([best_d] + ds, dim=1)
        cat_i = torch.cat([best_i] + is_, dim=1)
        cat_d, order = torch.sort(cat_d, dim=1, stable=True)
        best_d = cat_d[:, :k]
        best_i = torch.gather(cat_i, 1, order[:, :k])
    if q_mask is not None:
        best_d = torch.where(q_mask[:, None], best_d, float("inf"))
    best_i = torch.where(torch.isfinite(best_d), best_i, 0)
    return best_d, best_i


def gather_neighbors(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(P,3), (Q,k) → (Q,k,3)."""
    return points[idx]



def knn_auto(queries, points, k: int = 5, p_mask=None, q_mask=None):
    """The plain :func:`knn` on every device."""
    return knn(queries, points, k=k, q_mask=q_mask, p_mask=p_mask)


def searcher(points, p_mask, queries, q_mask):
    """``search(pw, k)``: :func:`knn_auto` of a moving copy ``pw`` of
    ``queries`` against one fixed map, as ICP searches."""
    return lambda pw, k: knn_auto(pw, points, k=k, p_mask=p_mask, q_mask=q_mask)


def world_knn_auto(t, q, scan_q, points, k: int = 5, p_mask=None, q_mask=None):
    """``pw = R(q)·scan_q + t``, then :func:`knn_auto`. Returns (pw, d², idx)."""
    pw = quat_rotate(q[None, :], scan_q) + t[None, :]
    d2, idx = knn_auto(pw, points, k=k, p_mask=p_mask, q_mask=q_mask)
    return pw, d2, idx


def knn_pair_auto(q1, p1, m1, q2, p2, m2, k: int = 5, qm1=None, qm2=None):
    """Two independent searches (the fusion surf + edge pair).
    Returns (d²₁, idx₁, d²₂, idx₂)."""
    return (knn_auto(q1, p1, k=k, p_mask=m1, q_mask=qm1)
            + knn_auto(q2, p2, k=k, p_mask=m2, q_mask=qm2))
