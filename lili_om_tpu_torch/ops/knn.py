"""Exact k-nearest-neighbour map association (port of ``lili_om_tpu/ops/knn.py``).

* :func:`knn` is the plain PyTorch version of the contract: direct
  ``(q−p)²`` distances, tiled over the map so memory stays O(Q·tile), and a
  running top-k merged by k min-extractions (``argmin`` returns the first
  minimum, so the lower index wins ties).
* :func:`knn_counted_cuda` / :func:`knn_dense_cuda` launch the hand-written
  CUDA kernel (``csrc/knn.cu``), the counterparts of the Pallas kernels
  ``knn_pallas_counted`` and ``knn_pallas``.
* :func:`knn_pruned_cuda` launches the Morton-sorted, bound-pruned kernel
  (``csrc/knn_pruned.cu``), the counterpart of ``knn_pallas_pruned``;
  :func:`knn_pruned_schedule` is its plain version for the CPU tests: the
  same pre-pass, tile order and skip test.
* :func:`knn_auto`, :func:`world_knn_auto` and :func:`knn_pair_auto` are what
  the pipeline calls: on a CUDA tensor they launch a kernel (or raise), on
  a CPU tensor they run the plain version. ``LILI_OM_KNN_PRUNED=1``, the JAX
  package's switch, read at each call, sends every CUDA search to the
  pruned kernel.

Contract: (d² (Q,k) ascending, ties to the lower index, idx (Q,k) int64);
masked points never match; slots without a neighbour and rows of invalid
queries give (+inf, 0).
"""
from __future__ import annotations

import collections
import ctypes
import os
from typing import NamedTuple

import torch

from ..device import use_kernel
from ..utils.math import quat_rotate

# resident-map bound of the count-bounded kernel, as in the JAX dispatch
# (lili_om_tpu/ops/knn.py:_COUNTED_MAX_P); larger or unmasked maps take the
# dense launch
COUNTED_MAX_P = 65536

# kernel launches since the last reset_launch_counts(), keyed by
# (wrapper name, queries Q, map points P, k): one key per call site of the path
LAUNCHES: collections.Counter = collections.Counter()


def reset_launch_counts():
    LAUNCHES.clear()


def launch_count(name: str | None = None) -> int:
    """Launches of wrapper ``name`` ("knn_counted" / "knn_dense" /
    "knn_pruned"; None: all)."""
    return sum(n for key, n in LAUNCHES.items() if name is None or key[0] == name)


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


def _check(queries, points, k, p_mask, q_mask):
    if queries.device.type != "cuda" or points.device != queries.device:
        raise ValueError("the CUDA kNN needs queries and points on one CUDA device")
    if queries.dtype != torch.float32 or points.dtype != torch.float32:
        raise TypeError("the CUDA kNN takes float32 queries and points only")
    if queries.dim() != 2 or queries.shape[1] != 3 or points.dim() != 2 \
            or points.shape[1] != 3:
        raise ValueError("queries and points must be (Q,3) and (P,3)")
    if not queries.is_contiguous():
        raise ValueError("queries must be contiguous")
    if not 1 <= k <= 8:
        raise ValueError("the CUDA kNN supports 1 ≤ k ≤ 8")
    for m, n, what in ((p_mask, points.shape[0], "p_mask"),
                       (q_mask, queries.shape[0], "q_mask")):
        if m is not None and (m.dtype != torch.bool or m.shape != (n,)
                              or m.device != queries.device
                              or not m.is_contiguous()):
            raise ValueError(f"{what} must be a contiguous bool ({n},) tensor "
                             "on the queries' device")


def _library():
    from ..cuda_build import load

    lib = load("knn")
    fn = lib.lili_knn_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    return fn


def kernel_inputs(queries, points, k: int = 5, p_mask=None, q_mask=None,
                  counted: bool = True):
    """Check the arguments and build what the kernel reads: the map as
    (P,4) float4 rows with the mask in lane 3 (0 valid, +inf masked) and,
    for the count-bounded launch, the walk bound (one past the last valid
    row) as a device scalar — torch ops only, no host sync."""
    _check(queries, points, k, p_mask, q_mask)
    P, dev = points.shape[0], queries.device
    pts4 = torch.empty((P, 4), dtype=torch.float32, device=dev)
    pts4[:, :3] = points
    pts4[:, 3] = 0.0 if p_mask is None else torch.where(p_mask, 0.0, float("inf"))
    n_pts = None
    if counted:
        rows = torch.arange(1, P + 1, dtype=torch.int32, device=dev)
        src = rows if p_mask is None else torch.where(p_mask, rows, 0)
        n_pts = (src.max().reshape(1) if P
                 else torch.zeros(1, dtype=torch.int32, device=dev))
    return queries, pts4, (q_mask if counted else None), n_pts


def launch_kernel(queries, pts4, q_mask, n_pts, k: int):
    """One launch on the current stream; allocates the outputs only."""
    Q, P, dev = queries.shape[0], pts4.shape[0], queries.device
    out_d = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int64, device=dev)
    err = _library()(queries.data_ptr(), pts4.data_ptr(),
                     None if q_mask is None else q_mask.data_ptr(),
                     None if n_pts is None else n_pts.data_ptr(),
                     P, Q, k, out_d.data_ptr(), out_i.data_ptr(),
                     torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"knn kernel launch failed: CUDA error {err}")
    return out_d, out_i


def _launch(queries, points, k, p_mask, q_mask, counted: bool):
    out_d, out_i = launch_kernel(*kernel_inputs(queries, points, k, p_mask, q_mask,
                                                counted), k)
    LAUNCHES["knn_counted" if counted else "knn_dense", queries.shape[0],
             points.shape[0], k] += 1
    if not counted and q_mask is not None:
        out_d = torch.where(q_mask[:, None], out_d, float("inf"))
        out_i = torch.where(q_mask[:, None], out_i, 0)
    return out_d, out_i


def knn_counted_cuda(queries, points, k: int = 5, p_mask=None, q_mask=None):
    """The count-bounded kernel (replaces ``knn_pallas_counted``): walks the
    map only up to its last valid row and skips blocks of invalid queries."""
    return _launch(queries, points, k, p_mask, q_mask, counted=True)


def knn_dense_cuda(queries, points, k: int = 5, p_mask=None, q_mask=None):
    """The dense launch (replaces ``knn_pallas``): the same kernel over the
    whole map capacity with every query active."""
    return _launch(queries, points, k, p_mask, q_mask, counted=False)


# --- B3: Morton-sorted, bound-pruned search ------------------------------

# queries per block and map points per tile of csrc/knn_pruned.cu (kBlock,
# kTile); the pre-pass lays its inputs out for them
PRUNED_BLOCK, PRUNED_TILE = 64, 1024
# a tile is skipped only when lb·(1−2⁻¹¹) > the block's worst distance
PRUNE_MARGIN = 1.0 - 2.0 ** -11
_I32_MAX = 2**31 - 1


def pruned_enabled() -> bool:
    """``LILI_OM_KNN_PRUNED=1``: every CUDA search takes the pruned kernel."""
    return os.environ.get("LILI_OM_KNN_PRUNED", "0") == "1"


def _spread10(x: torch.Tensor) -> torch.Tensor:
    """Interleave a 10-bit int into every 3rd bit (Morton component)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    return (x | (x << 2)) & 0x9249249


def morton30(pts: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """30-bit Morton key (int32) over the valid points' bounding box."""
    if pts.shape[0] == 0:
        return torch.zeros((0,), dtype=torch.int32, device=pts.device)
    inf = float("inf")
    lo = torch.where(valid[:, None], pts, inf).amin(dim=0)
    hi = torch.where(valid[:, None], pts, -inf).amax(dim=0)
    # a tensor numerator: ``1023.0 / t`` is taken as 1023·(1/t), which can
    # round differently from the division
    scale = torch.full_like(lo, 1023.0) / torch.clamp(hi - lo, min=1e-6)
    cells = torch.clamp((pts - lo) * scale, 0.0, 1023.0).to(torch.int32)
    return (_spread10(cells[:, 0]) << 2) | (_spread10(cells[:, 1]) << 1) \
        | _spread10(cells[:, 2])


def block_bounds(pts: torch.Tensor, valid: torch.Tensor, block: int):
    """(n_blocks, 3) lo/hi over the valid rows of each contiguous block, and
    whether the block has one."""
    p = pts.reshape(-1, block, 3)
    v = valid.reshape(-1, block, 1)
    inf = float("inf")
    return (torch.where(v, p, inf).amin(dim=1), torch.where(v, p, -inf).amax(dim=1),
            v.any(dim=2).any(dim=1))


class PrunedInputs(NamedTuple):
    """What the pruned kernel reads (see ``csrc/knn_pruned.cu``)."""

    qs: torch.Tensor  # (Q,3) Morton-sorted queries
    q_ok: torch.Tensor  # (Q,) bool, sorted
    q_pos: torch.Tensor  # (Q,) int64 original row of each sorted query
    pts4: torch.Tensor  # (n_tiles·tile, 4) sorted map, lane 3: 0 valid / +inf
    p_idx: torch.Tensor  # (n_tiles·tile,) int32 original map index
    order: torch.Tensor  # (n_blocks, n_tiles) int32, ascending bound
    lb: torch.Tensor  # (n_blocks, n_tiles) the bounds in that order
    q_any: torch.Tensor  # (n_blocks,) block has a valid query
    p_any: torch.Tensor  # (n_tiles,) tile has a valid point


def pruned_inputs(queries, points, p_mask=None, q_mask=None,
                  q_block: int = PRUNED_BLOCK, tile_p: int = PRUNED_TILE) -> PrunedInputs:
    """The pruned search's pre-pass, in torch ops with no host sync: stable
    Morton sorts (invalid rows last), the map padded to whole tiles, box
    lower bounds ``lb[i, j]`` between query block i and map tile j summed
    as ((gx²+gy²)+gz²) in the kernel's order, and each block's tiles sorted
    by bound."""
    Q, P, dev, dtype = queries.shape[0], points.shape[0], queries.device, queries.dtype
    q_valid = (torch.ones((Q,), dtype=torch.bool, device=dev) if q_mask is None
               else q_mask)
    p_valid = (torch.ones((P,), dtype=torch.bool, device=dev) if p_mask is None
               else p_mask)
    _, q_pos = torch.sort(torch.where(q_valid, morton30(queries, q_valid), _I32_MAX),
                          stable=True)
    _, p_pos = torch.sort(torch.where(p_valid, morton30(points, p_valid), _I32_MAX),
                          stable=True)
    qs, q_ok = queries[q_pos], q_valid[q_pos]

    ni, nj = -(-Q // q_block), -(-P // tile_p)
    Pp = nj * tile_p
    pts4 = torch.zeros((Pp, 4), dtype=dtype, device=dev)
    pts4[:P, :3] = points[p_pos]
    pts4[:, 3] = float("inf")
    pts4[:P, 3] = torch.where(p_valid[p_pos], 0.0, float("inf"))
    p_idx = torch.zeros((Pp,), dtype=torch.int32, device=dev)
    p_idx[:P] = p_pos.to(torch.int32)

    q_pad = torch.zeros((ni * q_block, 3), dtype=dtype, device=dev)
    q_pad[:Q] = qs
    ok_pad = torch.zeros((ni * q_block,), dtype=torch.bool, device=dev)
    ok_pad[:Q] = q_ok
    qlo, qhi, q_any = block_bounds(q_pad, ok_pad, q_block)
    plo, phi, p_any = block_bounds(pts4[:, :3], pts4[:, 3] == 0.0, tile_p)
    gap = torch.clamp(torch.maximum(qlo[:, None] - phi[None], plo[None] - qhi[:, None]),
                      min=0.0)
    lb = (gap[..., 0] * gap[..., 0] + gap[..., 1] * gap[..., 1]) + gap[..., 2] * gap[..., 2]
    lb = torch.where(q_any[:, None] & p_any[None, :], lb, float("inf"))
    order = torch.argsort(lb, dim=1, stable=True)
    return PrunedInputs(qs.contiguous(), q_ok.contiguous(), q_pos, pts4, p_idx,
                        order.to(torch.int32).contiguous(),
                        torch.gather(lb, 1, order).contiguous(), q_any, p_any)


def _sq_dist(qx, qy, qz, p):
    """((dx²+dy²)+dz²) + mask lane, as separate operations (the kernel's order)."""
    d = qx - p[..., 0]
    d = d * d
    t = qy - p[..., 1]
    d = d + t * t
    t = qz - p[..., 2]
    return (d + t * t) + p[..., 3]


def knn_pruned_schedule(queries, points, k: int = 5, p_mask=None, q_mask=None,
                        q_block: int = PRUNED_BLOCK, tile_p: int = PRUNED_TILE):
    """The pruned kernel's plain version (CPU tests): the same pre-pass, each
    query block walking its tiles nearest-first and stopping at the kernel's
    skip test, the top-k kept by (d², original index). Equals :func:`knn`
    bit for bit. Returns (d², idx, share of (valid block, valid tile) pairs
    skipped)."""
    prep = pruned_inputs(queries, points, p_mask, q_mask, q_block, tile_p)
    Q, dev, dtype = queries.shape[0], queries.device, queries.dtype
    ni, nj = prep.order.shape
    inf = float("inf")
    qs = torch.zeros((ni * q_block, 3), dtype=dtype, device=dev)
    qs[:Q] = prep.qs
    ok = torch.zeros((ni * q_block,), dtype=torch.bool, device=dev)
    ok[:Q] = prep.q_ok
    qs, ok = qs.reshape(ni, q_block, 1, 3), ok.reshape(ni, q_block)
    tiles = prep.pts4.reshape(nj, tile_p, 4)
    tile_idx = prep.p_idx.reshape(nj, tile_p).to(torch.int64)
    best_d = torch.full((ni, q_block, k), inf, dtype=dtype, device=dev)
    best_i = torch.zeros((ni, q_block, k), dtype=torch.int64, device=dev)
    alive = torch.ones((ni,), dtype=torch.bool, device=dev)
    visits = torch.zeros((), dtype=torch.int64, device=dev)
    for t in range(nj):
        worst = torch.where(ok, best_d[..., k - 1], -inf).amax(dim=1)
        b = prep.lb[:, t]
        alive = alive & (b < inf) & ~(b * PRUNE_MARGIN > worst)
        if not bool(alive.any()):
            break
        tid = prep.order[:, t].to(torch.int64)
        d = _sq_dist(qs[..., 0], qs[..., 1], qs[..., 2], tiles[tid][:, None])
        d = torch.where(ok[..., None], d, inf)
        cat_d = torch.cat([best_d, d], dim=-1)
        cat_i = torch.cat([best_i, tile_idx[tid][:, None].expand(-1, q_block, -1)], dim=-1)
        o = torch.argsort(cat_i, dim=-1, stable=True)  # then by d: (d, idx) order
        cat_d, cat_i = torch.gather(cat_d, -1, o), torch.gather(cat_i, -1, o)
        o = torch.argsort(cat_d, dim=-1, stable=True)[..., :k]
        keep = alive[:, None, None]
        best_d = torch.where(keep, torch.gather(cat_d, -1, o), best_d)
        best_i = torch.where(keep, torch.gather(cat_i, -1, o), best_i)
        visits = visits + alive.sum()
    d_out = torch.empty((Q, k), dtype=dtype, device=dev)
    i_out = torch.empty((Q, k), dtype=torch.int64, device=dev)
    d_out[prep.q_pos] = best_d.reshape(-1, k)[:Q]
    i_out[prep.q_pos] = best_i.reshape(-1, k)[:Q]
    i_out = torch.where(torch.isfinite(d_out), i_out, 0)
    possible = int(prep.q_any.sum()) * int(prep.p_any.sum())
    return d_out, i_out, (1.0 - int(visits) / possible if possible else 0.0)


def _pruned_library():
    from ..cuda_build import load

    lib = load("knn_pruned")
    if (lib.lili_knn_pruned_block(), lib.lili_knn_pruned_tile()) != (PRUNED_BLOCK,
                                                                     PRUNED_TILE):
        raise RuntimeError("csrc/knn_pruned.cu block/tile sizes differ from ops/knn.py")
    fn = lib.lili_knn_pruned_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
    return fn


def pruned_kernel_inputs(queries, points, k: int = 5, p_mask=None, q_mask=None):
    """Check the arguments (as the other kernels do) and run the pre-pass."""
    _check(queries, points, k, p_mask, q_mask)
    return pruned_inputs(queries, points, p_mask, q_mask)


def launch_pruned_kernel(prep: PrunedInputs, k: int):
    """One launch on the current stream; allocates the outputs only.
    Returns (d², idx, tiles scanned per query block)."""
    Q, dev = prep.qs.shape[0], prep.qs.device
    ni, nj = prep.order.shape
    out_d = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int64, device=dev)
    visited = torch.empty((ni,), dtype=torch.int32, device=dev)
    err = _pruned_library()(prep.qs.data_ptr(), prep.q_ok.data_ptr(), prep.q_pos.data_ptr(),
                            prep.pts4.data_ptr(), prep.p_idx.data_ptr(),
                            prep.order.data_ptr(), prep.lb.data_ptr(), Q, nj, k,
                            out_d.data_ptr(), out_i.data_ptr(), visited.data_ptr(),
                            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pruned knn kernel launch failed: CUDA error {err}")
    return out_d, out_i, visited


def knn_pruned_cuda(queries, points, k: int = 5, p_mask=None, q_mask=None):
    """The pruned kernel (replaces ``knn_pallas_pruned``); same contract as
    :func:`knn_counted_cuda`, same result bit for bit."""
    out_d, out_i, _ = launch_pruned_kernel(
        pruned_kernel_inputs(queries, points, k, p_mask, q_mask), k)
    LAUNCHES["knn_pruned", queries.shape[0], points.shape[0], k] += 1
    return out_d, out_i


def knn_auto(queries, points, k: int = 5, p_mask=None, q_mask=None):
    """Device-dispatching kNN: a CUDA kernel for CUDA tensors — the pruned
    one under ``LILI_OM_KNN_PRUNED=1``, else count-bounded when a mask is
    given and P ≤ 65536 and dense otherwise, as the JAX dispatch picks its
    Pallas kernels — and the plain version for CPU tensors."""
    if use_kernel(queries):
        if pruned_enabled():
            return knn_pruned_cuda(queries, points, k, p_mask, q_mask)
        if points.shape[0] <= COUNTED_MAX_P and (p_mask is not None or q_mask is not None):
            return knn_counted_cuda(queries, points, k, p_mask, q_mask)
        return knn_dense_cuda(queries, points, k, p_mask, q_mask)
    if queries.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kNN for device {queries.device}")
    return knn(queries, points, k=k, q_mask=q_mask, p_mask=p_mask)


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
