"""Voxel-hash-grid kNN (port of ``lili_om_tpu/ops/hashgrid.py``): a
large-map association with a fixed candidate budget per query. Plain
PyTorch: the JAX package has no Pallas kernel here either.

* build: points hash into C buckets by voxel cell (open hashing: colliding
  cells share a bucket, which only adds far-away candidates that lose the
  distance race; a bucket keeps its first ``bucket_cap`` points in point
  order, the rest are dropped);
* query: each query gathers the 27 neighbour-cell buckets and merges them
  into its running top-k by k min-extractions, as the plain kNN does.

Every true neighbour within ``cell_size`` of a query is found (the 3×3×3
neighbourhood covers that radius) when the query's 27 cells fall in 27
distinct buckets; two cells sharing a bucket bring its points twice, and a
point returned twice can push a true neighbour out of the top k (in both
packages; :func:`neighbour_buckets` tells those queries apart). Beyond the
cell the result may be approximate, the regime the pipeline's NN gates
discard anyway. Buckets, slots and indices equal the JAX package's: the
spatial hash is computed with int32 wrap-around (the products mod 2³², as
``ops/voxel.py`` computes its scramble), ``abs`` keeps INT32_MIN negative
and ``%`` is a floor mod.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .voxel import _M32, _mul32, _to_i32

_P1, _P2, _P3 = 73856093, 19349669, 83492791  # classic spatial-hash primes
_I32_MIN = -(2**31)


class VoxelHashGrid(NamedTuple):
    bucket_pts: torch.Tensor  # (C, B, 3)
    bucket_mask: torch.Tensor  # (C, B)
    bucket_idx: torch.Tensor  # (C, B) int32 original point indices
    cell_size: torch.Tensor  # ()


def _hash_cells(cells: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """int32 cells (...,3) → bucket ids (...,) int64, as JAX's int32
    ``abs((c0·P1) ^ (c1·P2) ^ (c2·P3)) % n_buckets``."""
    c = cells.to(torch.int64) & _M32
    h = (_to_i32(_mul32(c[..., 0], _P1)).to(torch.int64)
         ^ _to_i32(_mul32(c[..., 1], _P2)).to(torch.int64)
         ^ _to_i32(_mul32(c[..., 2], _P3)).to(torch.int64))
    h = torch.where(h == _I32_MIN, h, torch.abs(h))  # int32 abs wraps at INT32_MIN
    return torch.remainder(h, n_buckets)


def build_grid(pts: torch.Tensor, mask: torch.Tensor, cell_size: float,
               n_buckets: int = 65536, bucket_cap: int = 8) -> VoxelHashGrid:
    """Scatter points into hash buckets (one stable sort and a rank per
    point); invalid and overflowing points go to a scratch bucket that is
    cut off at the end."""
    N = pts.shape[0]
    dev = pts.device
    cells = torch.floor(pts / cell_size).to(torch.int32)
    h = torch.where(mask, _hash_cells(cells, n_buckets), n_buckets)
    order = torch.argsort(h, stable=True)
    h_s = h[order]
    arange = torch.arange(N, device=dev)
    starts = torch.ones(N, dtype=torch.bool, device=dev)
    starts[1:] = h_s[1:] != h_s[:-1]
    seg_start = torch.cummax(torch.where(starts, arange, 0), dim=0).values
    rank = arange - seg_start
    ok = (h_s < n_buckets) & (rank < bucket_cap)
    b = torch.where(ok, h_s, n_buckets)
    r = torch.where(ok, rank, 0)
    bucket_pts = pts.new_zeros((n_buckets + 1, bucket_cap, 3))
    bucket_pts[b, r] = torch.where(ok[:, None], pts[order], 0.0)
    bucket_mask = torch.zeros((n_buckets + 1, bucket_cap), dtype=torch.bool, device=dev)
    bucket_mask[b, r] = ok
    bucket_idx = torch.zeros((n_buckets + 1, bucket_cap), dtype=torch.int32, device=dev)
    bucket_idx[b, r] = torch.where(ok, order, 0).to(torch.int32)
    return VoxelHashGrid(bucket_pts[:n_buckets], bucket_mask[:n_buckets],
                         bucket_idx[:n_buckets],
                         torch.tensor(cell_size, dtype=pts.dtype, device=dev))


def _merge(best_d, best_i, cand_d, cand_i, k: int):
    cat_d = torch.cat([best_d, cand_d], dim=1)
    cat_i = torch.cat([best_i, cand_i], dim=1)
    cols = torch.arange(cat_d.shape[1], device=cat_d.device)[None, :]
    out_d, out_i = [], []
    for _ in range(k):
        j = torch.argmin(cat_d, dim=1)  # the first minimum
        out_d.append(torch.gather(cat_d, 1, j[:, None])[:, 0])
        out_i.append(torch.gather(cat_i, 1, j[:, None])[:, 0])
        cat_d = torch.where(cols == j[:, None], float("inf"), cat_d)
    return torch.stack(out_d, dim=1), torch.stack(out_i, dim=1)


def neighbour_buckets(queries: torch.Tensor, grid: VoxelHashGrid) -> torch.Tensor:
    """(Q, 27) bucket ids of each query's 3×3×3 neighbour cells, in the
    search's order (dx, then dy, then dz over −1, 0, 1)."""
    cells_q = torch.floor(queries / grid.cell_size).to(torch.int32)
    offs = torch.tensor([(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                         for dz in (-1, 0, 1)], dtype=torch.int32, device=queries.device)
    return _hash_cells(cells_q[:, None, :] + offs[None], grid.bucket_pts.shape[0])


def hashgrid_knn(queries: torch.Tensor, grid: VoxelHashGrid, k: int = 5):
    """kNN among the 27-cell neighbourhood candidates of each query.

    Returns (d² (Q,k) ascending, idx (Q,k) int64), the plain kNN's contract;
    a query with fewer than k candidates pads with (+inf, 0)."""
    Q = queries.shape[0]
    best_d = torch.full((Q, k), float("inf"), dtype=queries.dtype, device=queries.device)
    best_i = torch.zeros((Q, k), dtype=torch.int64, device=queries.device)
    for hb in neighbour_buckets(queries, grid).unbind(1):
        d = torch.sum((queries[:, None, :] - grid.bucket_pts[hb]) ** 2, dim=-1)
        d = torch.where(grid.bucket_mask[hb], d, float("inf"))
        best_d, best_i = _merge(best_d, best_i, d, grid.bucket_idx[hb].to(torch.int64), k)
    return best_d, best_i
