"""Exact k-nearest-neighbour map association (port of ``lili_om_tpu/ops/knn.py``).

* :func:`knn` is the plain PyTorch version of the contract: direct
  ``(q−p)²`` distances, tiled over the map so memory stays O(Q·tile), and a
  running top-k merged by k min-extractions (``argmin`` returns the first
  minimum, so the lower index wins ties).
* :func:`knn_counted_cuda` / :func:`knn_dense_cuda` launch the hand-written
  CUDA kernel (``csrc/knn.cu``), the counterparts of the Pallas kernels
  ``knn_pallas_counted`` and ``knn_pallas``.
* :func:`knn_auto`, :func:`world_knn_auto` and :func:`knn_pair_auto` are what
  the pipeline calls: on a CUDA tensor they launch the kernel (or raise), on
  a CPU tensor they run the plain version.

Contract: (d² (Q,k) ascending, idx (Q,k) int64); masked points never match;
slots without a neighbour and rows of invalid queries give (+inf, 0).
"""
from __future__ import annotations

import collections
import contextlib
import ctypes

import torch

from ..utils.math import quat_rotate

# resident-map bound of the count-bounded kernel, as in the JAX dispatch
# (lili_om_tpu/ops/knn.py:_COUNTED_MAX_P); larger or unmasked maps take the
# dense launch
COUNTED_MAX_P = 65536

# kernel launches since the last reset_launch_counts(), keyed by
# (wrapper name, queries Q, map points P): one key per call site of the path
LAUNCHES: collections.Counter = collections.Counter()

_FORCE_PLAIN = False


def reset_launch_counts():
    LAUNCHES.clear()


def launch_count(name: str | None = None) -> int:
    """Launches of wrapper ``name`` ("knn_counted" / "knn_dense"; None: all)."""
    return sum(n for (w, _, _), n in LAUNCHES.items() if name is None or w == name)


@contextlib.contextmanager
def plain_knn():
    """Run the plain version on CUDA tensors too — for holding the kernel
    against it (chip_smoke.py); never used by the pipeline itself."""
    global _FORCE_PLAIN
    prev, _FORCE_PLAIN = _FORCE_PLAIN, True
    try:
        yield
    finally:
        _FORCE_PLAIN = prev


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
             points.shape[0]] += 1
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


def knn_auto(queries, points, k: int = 5, p_mask=None, q_mask=None):
    """Device-dispatching kNN: the CUDA kernel for CUDA tensors (count-
    bounded when a mask is given and P ≤ 65536, dense otherwise, as the JAX
    dispatch picks its Pallas kernels), the plain version for CPU tensors."""
    if queries.device.type == "cuda" and not _FORCE_PLAIN:
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
