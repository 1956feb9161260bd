"""Exact k-nearest-neighbour map association (port of ``lili_om_tpu/ops/knn.py``).

* :func:`knn` is the plain PyTorch version of the contract: direct
  ``(q−p)²`` distances, tiled over the map so memory stays O(Q·tile), and a
  running top-k merged by k min-extractions (``argmin`` returns the first
  minimum, so the lower index wins ties).
* :func:`knn_counted_cuda` / :func:`knn_dense_cuda` launch the hand-written
  CUDA search (``csrc/knn.cu``), the counterparts of the Pallas kernels
  ``knn_pallas_counted`` and ``knn_pallas``, on a map that :func:`knn_map`
  prepares once (one kernel: float4 rows and the walk bound), or on raw
  points prepared inside the call; :func:`knn_lanes_schedule` is the
  search's plain version for the CPU tests (the same lane shares and
  merge).
* :func:`knn_pruned_cuda` launches the Morton-sorted, bound-pruned search
  (``csrc/knn_pruned.cu``), the counterpart of ``knn_pallas_pruned``, on a
  map that :func:`pruned_map` prepares once (two kernels and one sort) and
  queries in an order that :func:`query_order` gives once;
  :func:`knn_pruned_schedule` is its plain version for the CPU tests: the
  same prepared map, block layout, tile order and skip test, and the same
  visits per block.
* :func:`knn_auto`, :func:`world_knn_auto` and :func:`knn_pair_auto` are what
  the pipeline calls: on a CUDA tensor they launch a kernel (or raise), on
  a CPU tensor they run the plain version. ``LILI_OM_KNN_PRUNED=1``, the JAX
  package's switch, read at each call, sends every CUDA search to the
  pruned kernel. :func:`searcher` prepares ICP's fixed target once for
  whichever kernel its searches take.

Contract: (d² (Q,k) ascending, ties to the lower index, idx (Q,k) int64);
masked points never match; slots without a neighbour and rows of invalid
queries give (+inf, 0).
"""
from __future__ import annotations

import collections
import ctypes
import functools
import os
import threading
from typing import NamedTuple

import torch

from .. import cuda_build
from ..device import use_kernel
from ..utils.math import quat_rotate

# resident-map bound of the count-bounded kernel, as in the JAX dispatch
# (lili_om_tpu/ops/knn.py:_COUNTED_MAX_P); larger or unmasked maps take the
# dense launch
COUNTED_MAX_P = 65536

# kernel launches since the last reset_launch_counts(), keyed by
# (wrapper name, queries Q, map points P, k): one key per call site of the path
LAUNCHES: collections.Counter = collections.Counter()
_LAUNCHES_LOCK = threading.Lock()


def count_launch(*key):
    """One launch at ``key``; the runtime launches from several threads."""
    with _LAUNCHES_LOCK:
        LAUNCHES[key] += 1


def reset_launch_counts():
    with _LAUNCHES_LOCK:
        LAUNCHES.clear()


def launch_count(name: str | None = None) -> int:
    """Launches of wrapper ``name`` ("knn_map" / "knn_counted" / "knn_dense" /
    "knn_pruned" / "pruned_keys" / "pruned_scatter"; None: all)."""
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


def gather_neighbors(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(P,3), (Q,k) → (Q,k,3)."""
    return points[idx]


def _check_cloud(pts, mask, what: str, device=None, contiguous: bool = True):
    """A cloud a kernel reads: float32 (n, 3) on the CUDA device ``device``
    (default its own), contiguous where the kernel reads it in place (else
    its rows contiguous: strides (s, 1)), its mask a contiguous bool (n,)
    there."""
    device = pts.device if device is None else device
    if pts.device.type != "cuda" or pts.device != device:
        raise ValueError(f"the CUDA kNN needs {what} on the queries' CUDA device")
    if pts.dtype != torch.float32:
        raise TypeError(f"the CUDA kNN takes float32 {what} only")
    if pts.dim() != 2 or pts.shape[1] != 3 or (
            not pts.is_contiguous() if contiguous else pts.stride(1) != 1):
        raise ValueError(f"{what} must be a {'contiguous ' if contiguous else ''}(n, 3) "
                         f"tensor{'' if contiguous else ' with contiguous rows'}")
    if mask is not None and (mask.dtype != torch.bool or mask.shape != (pts.shape[0],)
                             or mask.device != device or not mask.is_contiguous()):
        raise ValueError(f"the mask of {what} must be a contiguous bool "
                         f"({pts.shape[0]},) tensor on the queries' device")


def _check_k(k: int):
    if not 1 <= k <= 8:
        raise ValueError("the CUDA kNN supports 1 ≤ k ≤ 8")


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


# --- B1/B2: the map prepared once, lanes per query ---------------------------

# lanes per query of csrc/knn.cu (kLanes): a warp per query
LANES = 32


class KnnMap(NamedTuple):
    """A map prepared for B1/B2 (:func:`knn_map`), built once per map and
    searched any number of times: the counterpart of ``knn_pallas_counted``'s
    pre-pass."""

    pts4: torch.Tensor  # (P, 4) rows, lane 3: 0 valid / +inf masked
    bound: torch.Tensor  # (1,) int32, one past the last valid row (0: none)
    n_points: int  # rows of the map


def knn_map_plain(points, p_mask=None) -> KnnMap:
    """:func:`knn_map` in torch ops (the same tensors)."""
    P, dev = points.shape[0], points.device
    pts4 = torch.empty((P, 4), dtype=points.dtype, device=dev)
    pts4[:, :3] = points
    pts4[:, 3] = 0.0 if p_mask is None else torch.where(p_mask, 0.0, float("inf"))
    if p_mask is None or P == 0:
        bound = torch.full((1,), P, dtype=torch.int32, device=dev)
    else:
        rows = torch.arange(1, P + 1, dtype=torch.int32, device=dev)
        bound = torch.where(p_mask, rows, 0).amax().reshape(1)
    return KnnMap(pts4, bound, P)


@functools.cache
def _library() -> dict:
    """The B1/B2 kernels' ctypes functions, bound once."""
    lib = cuda_build.load("knn")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fns = {}
    for name, args in (("map", [ptr, i64, ptr, i32, ptr, ptr, ptr]),
                       ("f32", [ptr, ptr, i32, ptr, ptr, i32, i32] + [ptr] * 3)):
        fn = getattr(lib, f"lili_knn_{name}")
        fn.restype, fn.argtypes = i32, args
        fns[name] = fn
    return fns


def launch_map_kernel(points, p_mask, kmap: KnnMap) -> KnnMap:
    """One launch of the preparation into the tensors of ``kmap``."""
    _raise_on(_library()["map"](
        points.data_ptr(), points.stride(0), None if p_mask is None else p_mask.data_ptr(),
        points.shape[0], kmap.pts4.data_ptr(), kmap.bound.data_ptr(),
        cuda_build.stream_ptr(points.device)), "knn map")
    return kmap


def knn_map_cuda(points, p_mask=None) -> KnnMap:
    """:func:`knn_map` on the card: one launch of the preparation kernel."""
    _check_cloud(points, p_mask, "points", contiguous=False)
    P, dev = points.shape[0], points.device
    kmap = launch_map_kernel(points, p_mask, KnnMap(
        torch.empty((P, 4), dtype=torch.float32, device=dev),
        torch.empty((1,), dtype=torch.int32, device=dev), P))
    count_launch("knn_map", 0, P, 0)
    return kmap


def knn_map(points, p_mask=None) -> KnnMap:
    """The map prepared for :func:`knn_counted_cuda` / :func:`knn_dense_cuda`,
    once per map: float4 rows with the mask in lane 3 (0 valid, +inf
    masked) and the walk bound, one past the last valid row (the row count
    without a mask, 0 for an empty or all-masked map), as a device int32.
    The kernel on a CUDA tensor, torch ops on a CPU one (the same bits)."""
    if use_kernel(points):
        return knn_map_cuda(points, p_mask)
    return knn_map_plain(points, p_mask)


def knn_lanes_schedule(queries, points, k: int = 5, p_mask=None, q_mask=None,
                       lanes: int = LANES):
    """The B1/B2 search's plain version (CPU tests): the same prepared map
    (``points`` as a :class:`KnnMap`, or raw points prepared here) walked up
    to its bound; lane l of a query takes the rows r ≡ l (mod ``lanes``) in
    ascending order and keeps their top-k by (d², row), an unfilled slot
    (+inf, 0); the lanes' lists are merged by (d², row). Equals :func:`knn`
    bit for bit."""
    kmap = points if isinstance(points, KnnMap) else knn_map_plain(points, p_mask)
    n = min(int(kmap.bound[0]), kmap.n_points)
    Q, dev, dtype = queries.shape[0], queries.device, queries.dtype
    inf = float("inf")
    qx, qy, qz = (queries[:, j:j + 1] for j in range(3))
    lists_d, lists_i = [], []
    for lane in range(lanes):
        rows = torch.arange(lane, max(n, lane), lanes, device=dev)
        d = torch.full((Q, k), inf, dtype=dtype, device=dev)
        i = torch.zeros((Q, k), dtype=torch.int64, device=dev)
        if rows.numel():
            dl = _sq_dist(qx, qy, qz, kmap.pts4[rows][None])
            o = torch.argsort(dl, dim=1, stable=True)[:, :k]  # rows ascend: (d², row)
            m = o.shape[1]
            d[:, :m] = torch.gather(dl, 1, o)
            i[:, :m] = torch.where(torch.isfinite(d[:, :m]), rows[o], 0)
        lists_d.append(d)
        lists_i.append(i)
    cat_d, cat_i = torch.cat(lists_d, dim=1), torch.cat(lists_i, dim=1)
    o = torch.argsort(cat_i, dim=1, stable=True)  # then by d: the (d², row) order
    cat_d, cat_i = torch.gather(cat_d, 1, o), torch.gather(cat_i, 1, o)
    o = torch.argsort(cat_d, dim=1, stable=True)[:, :k]
    best_d, best_i = torch.gather(cat_d, 1, o), torch.gather(cat_i, 1, o)
    if q_mask is not None:
        best_d = torch.where(q_mask[:, None], best_d, inf)
    return best_d, torch.where(torch.isfinite(best_d), best_i, 0)


def _check_search(queries, kmap: KnnMap, k: int, q_mask):
    _check_cloud(queries, q_mask, "queries")
    P = kmap.n_points
    if (kmap.pts4.device != queries.device or kmap.pts4.dtype != torch.float32
            or kmap.pts4.shape != (P, 4) or not kmap.pts4.is_contiguous()
            or kmap.bound.device != queries.device or kmap.bound.dtype != torch.int32
            or kmap.bound.shape != (1,)):
        raise ValueError("the map must be prepared by knn_map on the queries' device")
    _check_k(k)


def launch_kernel(queries, kmap: KnnMap, q_mask, k: int):
    """One launch of the search on the current stream; allocates the outputs
    only."""
    Q, dev = queries.shape[0], queries.device
    out_d = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int64, device=dev)
    _raise_on(_library()["f32"](
        queries.data_ptr(), None if q_mask is None else q_mask.data_ptr(), Q,
        kmap.pts4.data_ptr(), kmap.bound.data_ptr(), kmap.n_points, k,
        out_d.data_ptr(), out_i.data_ptr(),
        cuda_build.stream_ptr(dev)), "knn")
    return out_d, out_i


def _search(name: str, queries, points, k, p_mask, q_mask):
    if isinstance(points, KnnMap):
        if p_mask is not None:
            raise ValueError("a KnnMap carries its mask: pass p_mask=None")
        kmap = points
    else:
        kmap = knn_map_cuda(points, p_mask)
    _check_search(queries, kmap, k, q_mask)
    out = launch_kernel(queries, kmap, q_mask, k)
    count_launch(name, queries.shape[0], kmap.n_points, k)
    return out


def knn_counted_cuda(queries, points, k: int = 5, p_mask=None, q_mask=None):
    """B1 (replaces ``knn_pallas_counted``): the search walks the map up to
    its last valid row and skips blocks of invalid queries. ``points`` is the
    map as (P, 3) points with ``p_mask``, prepared here (then a call is two
    launches), or a :class:`KnnMap` from :func:`knn_map` (one launch)."""
    return _search("knn_counted", queries, points, k, p_mask, q_mask)


def knn_dense_cuda(queries, points, k: int = 5, p_mask=None, q_mask=None):
    """B2 (replaces ``knn_pallas``, taken for P > 65536 or without a mask):
    the same search and the same result as :func:`knn_counted_cuda`, under
    its own launch name. The walk is bounded by the prepared bound as well
    (the map's row count without a mask)."""
    return _search("knn_dense", queries, points, k, p_mask, q_mask)


# --- B3: Morton-sorted, bound-pruned search ------------------------------

# queries per block, map points per tile and the most tiles of
# csrc/knn_pruned.cu (kQB, kTile, kMaxTiles); the map is laid out for them
PRUNED_BLOCK, PRUNED_TILE, PRUNED_MAX_TILES = 32, 512, 2048
# a tile is skipped only when lb·(1−2⁻¹¹) > the block's worst distance
PRUNE_MARGIN = 1.0 - 2.0 ** -11
_I32_MAX = 2**31 - 1
_ROW_BITS = 0xFFFFFFFF


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


class PrunedMap(NamedTuple):
    """A map prepared for the pruned search (:func:`pruned_map`), built once
    per map and searched any number of times: the counterpart of
    ``knn_pallas_pruned``'s ``sorted_p`` promise."""

    pts4: torch.Tensor  # (n_tiles·tile, 4) Morton-sorted map, lane 3: 0 valid / +inf
    p_idx: torch.Tensor  # (n_tiles·tile,) int32 original row of each sorted row
    tile_lo: torch.Tensor  # (n_tiles, 3) each tile's valid box (+inf without one)
    tile_hi: torch.Tensor  # (n_tiles, 3) (−inf without one)
    tile_any: torch.Tensor  # (n_tiles,) bool, the tile has a valid point
    n_points: int  # rows of the original map
    tile: int  # points per tile


def pruned_map_plain(points, p_mask=None, tile: int = PRUNED_TILE) -> PrunedMap:
    """:func:`pruned_map` in torch ops: the map sorted on its Morton keys,
    padded to whole tiles of masked rows, and each tile's valid box."""
    P, dev, dtype = points.shape[0], points.device, points.dtype
    pos = morton_order_plain(points, p_mask)
    Pp = -(-P // tile) * tile
    pts4 = torch.zeros((Pp, 4), dtype=dtype, device=dev)
    pts4[:, 3] = float("inf")
    pts4[:P, :3] = points[pos]
    if p_mask is None:
        pts4[:P, 3] = 0.0
    else:
        pts4[:P, 3] = torch.where(p_mask[pos], 0.0, float("inf"))
    p_idx = torch.zeros((Pp,), dtype=torch.int32, device=dev)
    p_idx[:P] = pos.to(torch.int32)
    lo, hi, any_ = block_bounds(pts4[:, :3], pts4[:, 3] == 0.0, tile)
    return PrunedMap(pts4, p_idx, lo, hi, any_, P, tile)


@functools.cache
def _pruned_library() -> dict:
    """The pruned kernels' ctypes functions, bound once."""
    lib = cuda_build.load("knn_pruned")
    if (lib.lili_knn_pruned_block(), lib.lili_knn_pruned_tile(),
            lib.lili_knn_pruned_max_tiles()) != (PRUNED_BLOCK, PRUNED_TILE, PRUNED_MAX_TILES):
        raise RuntimeError("csrc/knn_pruned.cu block/tile sizes differ from ops/knn.py")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fns = {}
    for name, args in (("keys", [ptr, ptr, i32, ptr, ptr]),
                       ("scatter", [ptr, ptr, i32, i32] + [ptr] * 6),
                       ("f32", [ptr] * 3 + [i32] + [ptr] * 5 + [i32, i32] + [ptr] * 4)):
        fn = getattr(lib, f"lili_knn_pruned_{name}")
        fn.restype, fn.argtypes = i32, args
        fns[name] = fn
    return fns


def launch_keys_kernel(pts, valid, keys):
    """One launch of the keys kernel into ``keys`` (n,) int64."""
    _raise_on(_pruned_library()["keys"](
        pts.data_ptr(), None if valid is None else valid.data_ptr(), pts.shape[0],
        keys.data_ptr(), cuda_build.stream_ptr(pts.device)), "pruned keys")
    return keys


def morton_keys_cuda(pts, valid=None) -> torch.Tensor:
    """The keys kernel: (n,) int64 ``(morton30 << 32) | row`` over the valid
    box, ``(INT32_MAX << 32) | row`` for an invalid row. Every key is
    unique, so one ``torch.sort`` of them gives the stable Morton order
    (the row in the low 32 bits)."""
    _check_cloud(pts, valid, "points")
    keys = launch_keys_kernel(pts, valid, torch.empty((pts.shape[0],), dtype=torch.int64,
                                                      device=pts.device))
    count_launch("pruned_keys", 0, pts.shape[0], 0)
    return keys


def morton_keys_plain(pts, valid=None) -> torch.Tensor:
    """:func:`morton_keys_cuda` in torch ops."""
    n = pts.shape[0]
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=pts.device)
    key = torch.where(valid, morton30(pts, valid).to(torch.int64), _I32_MAX)
    return (key << 32) | torch.arange(n, device=pts.device)


def morton_order_plain(pts, valid=None) -> torch.Tensor:
    """(n,) int64 rows in stable Morton order over the valid box, invalid
    rows last: the keys sorted, their rows kept (as on the card)."""
    return torch.sort(morton_keys_plain(pts, valid)).values & _ROW_BITS


def launch_scatter_kernel(points, sorted_keys, pmap: PrunedMap) -> PrunedMap:
    """One launch of the scatter kernel into the tensors of ``pmap``."""
    _raise_on(_pruned_library()["scatter"](
        points.data_ptr(), sorted_keys.data_ptr(), points.shape[0], pmap.tile_any.shape[0],
        *(t.data_ptr() for t in pmap[:5]), cuda_build.stream_ptr(points.device)),
        "pruned map scatter")
    return pmap


def pruned_map_cuda(points, p_mask=None) -> PrunedMap:
    """:func:`pruned_map` on the card in three launches: the keys kernel, one
    ``torch.sort`` of the keys, and the scatter kernel, which writes the
    sorted map as float4 tiles and each tile's box."""
    P, dev = points.shape[0], points.device
    nj = -(-P // PRUNED_TILE)
    if nj > PRUNED_MAX_TILES:
        raise ValueError(f"the pruned kNN takes at most {PRUNED_MAX_TILES * PRUNED_TILE} "
                         f"map points, got {P}")
    order = torch.sort(morton_keys_cuda(points, p_mask)).values
    Pp = nj * PRUNED_TILE
    pmap = launch_scatter_kernel(points, order, PrunedMap(
        torch.empty((Pp, 4), dtype=torch.float32, device=dev),
        torch.empty((Pp,), dtype=torch.int32, device=dev),
        torch.empty((nj, 3), dtype=torch.float32, device=dev),
        torch.empty((nj, 3), dtype=torch.float32, device=dev),
        torch.empty((nj,), dtype=torch.bool, device=dev), P, PRUNED_TILE))
    count_launch("pruned_scatter", 0, P, 0)
    return pmap


def pruned_map(points, p_mask=None) -> PrunedMap:
    """The map prepared for :func:`knn_pruned_cuda`, once per map: sorted
    on a 30-bit Morton key over its valid box (stable, masked rows last),
    padded to whole 512-point tiles as float4 rows with the mask in lane 3,
    each row's original index beside it, and each tile's valid box. The
    kernels on a CUDA tensor, torch ops on a CPU one (the same bits)."""
    if use_kernel(points):
        return pruned_map_cuda(points, p_mask)
    return pruned_map_plain(points, p_mask)


def query_order(queries, q_mask=None) -> torch.Tensor:
    """(Q,) int64 permutation: the queries' stable Morton order over their
    valid box, invalid queries last — the order in which the pruned search
    groups them into blocks. Any order gives the same result; a compact one
    prunes more. The keys kernel and one sort on a CUDA tensor."""
    if use_kernel(queries):
        return torch.sort(morton_keys_cuda(queries, q_mask)).values & _ROW_BITS
    return morton_order_plain(queries, q_mask)


class PrunedPlan(NamedTuple):
    """The walk of each query block, as the kernel lays it out."""

    qs: torch.Tensor  # (n_blocks, q_block, 3) the block's queries
    ok: torch.Tensor  # (n_blocks, q_block) valid query
    order: torch.Tensor  # (n_blocks, n_tiles) int64 tiles nearest-first
    lb: torch.Tensor  # (n_blocks, n_tiles) their box lower bounds
    rows: torch.Tensor  # (Q,) int64 original row of each walk position


def pruned_plan(queries, pmap: PrunedMap, q_mask=None, q_order=None,
                q_block: int = PRUNED_BLOCK) -> PrunedPlan:
    """The kernel's per-block preparation in torch ops: the queries in walk
    order cut into blocks, each block's valid box, its bound against every
    tile box summed as ((gx²+gy²)+gz²) in the kernel's order (+inf for a
    block without a valid query or a tile without a valid point), and the
    tiles ranked by (lb, tile id)."""
    Q, dev, dtype = queries.shape[0], queries.device, queries.dtype
    rows = (morton_order_plain(queries, q_mask) if q_order is None
            else q_order & _ROW_BITS)
    ni = -(-Q // q_block)
    qs = torch.zeros((ni * q_block, 3), dtype=dtype, device=dev)
    qs[:Q] = queries[rows]
    ok = torch.zeros((ni * q_block,), dtype=torch.bool, device=dev)
    ok[:Q] = True if q_mask is None else q_mask[rows]
    qlo, qhi, q_any = block_bounds(qs, ok, q_block)
    gap = torch.clamp(torch.maximum(qlo[:, None] - pmap.tile_hi[None],
                                    pmap.tile_lo[None] - qhi[:, None]), min=0.0)
    lb = (gap[..., 0] * gap[..., 0] + gap[..., 1] * gap[..., 1]) + gap[..., 2] * gap[..., 2]
    lb = torch.where(q_any[:, None] & pmap.tile_any[None, :], lb, float("inf"))
    order = torch.argsort(lb, dim=1, stable=True)
    return PrunedPlan(qs.reshape(ni, q_block, 3), ok.reshape(ni, q_block), order,
                      torch.gather(lb, 1, order), rows)


def _sq_dist(qx, qy, qz, p):
    """((dx²+dy²)+dz²) + mask lane, as separate operations (the kernel's order)."""
    d = qx - p[..., 0]
    d = d * d
    t = qy - p[..., 1]
    d = d + t * t
    t = qz - p[..., 2]
    return (d + t * t) + p[..., 3]


def knn_pruned_schedule(queries, points, k: int = 5, p_mask=None, q_mask=None,
                        q_order=None, q_block: int = PRUNED_BLOCK, tile_p: int = PRUNED_TILE):
    """The pruned kernel's plain version (CPU tests, and the card's yardstick
    for its visits): the same prepared map (``points`` as a
    :class:`PrunedMap`, or raw points prepared here with tiles of
    ``tile_p``), the same query order (``q_order``, or the queries' own
    Morton order), each query block walking its tiles nearest-first and
    stopping at the kernel's skip test, the top-k kept by (d², original
    index). Equals :func:`knn` bit for bit. Returns (d², idx, tiles scanned
    per query block (int32))."""
    pmap = points if isinstance(points, PrunedMap) else pruned_map_plain(points, p_mask, tile_p)
    plan = pruned_plan(queries, pmap, q_mask, q_order, q_block)
    Q, dev, dtype = queries.shape[0], queries.device, queries.dtype
    ni, nj = plan.order.shape
    inf = float("inf")
    qs = plan.qs[:, :, None, :]
    tiles = pmap.pts4.reshape(nj, pmap.tile, 4)
    tile_idx = pmap.p_idx.reshape(nj, pmap.tile).to(torch.int64)
    best_d = torch.full((ni, q_block, k), inf, dtype=dtype, device=dev)
    best_i = torch.zeros((ni, q_block, k), dtype=torch.int64, device=dev)
    alive = torch.ones((ni,), dtype=torch.bool, device=dev)
    visited = torch.zeros((ni,), dtype=torch.int32, device=dev)
    for t in range(nj):
        worst = torch.where(plan.ok, best_d[..., k - 1], -inf).amax(dim=1)
        b = plan.lb[:, t]
        alive = alive & (b < inf) & ~(b * PRUNE_MARGIN > worst)
        if not bool(alive.any()):
            break
        tid = plan.order[:, t]
        d = _sq_dist(qs[..., 0], qs[..., 1], qs[..., 2], tiles[tid][:, None])
        d = torch.where(plan.ok[..., None], d, inf)
        cat_d = torch.cat([best_d, d], dim=-1)
        cat_i = torch.cat([best_i, tile_idx[tid][:, None].expand(-1, q_block, -1)], dim=-1)
        o = torch.argsort(cat_i, dim=-1, stable=True)  # then by d: (d, idx) order
        cat_d, cat_i = torch.gather(cat_d, -1, o), torch.gather(cat_i, -1, o)
        o = torch.argsort(cat_d, dim=-1, stable=True)[..., :k]
        keep = alive[:, None, None]
        best_d = torch.where(keep, torch.gather(cat_d, -1, o), best_d)
        best_i = torch.where(keep, torch.gather(cat_i, -1, o), best_i)
        visited += alive.to(torch.int32)
    d_out = torch.empty((Q, k), dtype=dtype, device=dev)
    i_out = torch.empty((Q, k), dtype=torch.int64, device=dev)
    d_out[plan.rows] = best_d.reshape(-1, k)[:Q]
    i_out[plan.rows] = best_i.reshape(-1, k)[:Q]
    i_out = torch.where(torch.isfinite(d_out), i_out, 0)
    return d_out, i_out, visited


def pruned_skipped_share(visited: torch.Tensor, pmap: PrunedMap) -> float:
    """Share of the (block with a valid query, tile with a valid point) pairs
    that a walk skipped. A block with a valid query scans at least its
    first tile when the map has a valid one, so such blocks are those with
    a visit."""
    possible = int((visited > 0).sum()) * int(pmap.tile_any.sum())
    return 1.0 - int(visited.sum()) / possible if possible else 0.0


def _check_pruned(queries, pmap: PrunedMap, k: int, q_mask, q_order):
    _check_cloud(queries, q_mask, "queries")
    if pmap.pts4.device != queries.device or pmap.tile != PRUNED_TILE:
        raise ValueError("the map must be prepared by pruned_map on the queries' device")
    if pmap.tile_any.shape[0] > PRUNED_MAX_TILES:
        raise ValueError(f"the pruned kNN takes at most {PRUNED_MAX_TILES} tiles")
    _check_k(k)
    if q_order is not None and (q_order.dtype != torch.int64
                                or q_order.shape != (queries.shape[0],)
                                or q_order.device != queries.device
                                or not q_order.is_contiguous()):
        raise ValueError("q_order must be a contiguous int64 (Q,) tensor on the queries' "
                         "device")


def launch_pruned_kernel(queries, pmap: PrunedMap, q_mask, q_order, k: int):
    """One launch of the search on the current stream; allocates the outputs
    only. ``q_order``: (Q,) int64 whose low 32 bits give the original row
    of each walk position (a permutation, or sorted keys). Returns (d²,
    idx, tiles scanned per query block)."""
    Q, dev = queries.shape[0], queries.device
    out_d = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int64, device=dev)
    visited = torch.empty((-(-Q // PRUNED_BLOCK),), dtype=torch.int32, device=dev)
    _raise_on(_pruned_library()["f32"](
        queries.data_ptr(), None if q_mask is None else q_mask.data_ptr(), q_order.data_ptr(),
        Q, pmap.pts4.data_ptr(), pmap.p_idx.data_ptr(), pmap.tile_lo.data_ptr(),
        pmap.tile_hi.data_ptr(), pmap.tile_any.data_ptr(), pmap.tile_any.shape[0], k,
        out_d.data_ptr(), out_i.data_ptr(), visited.data_ptr(),
        cuda_build.stream_ptr(dev)), "pruned knn")
    return out_d, out_i, visited


def knn_pruned_cuda(queries, points, k: int = 5, p_mask=None, q_mask=None, q_order=None):
    """The pruned search (replaces ``knn_pallas_pruned``); same contract as
    :func:`knn_counted_cuda`, same result bit for bit. ``points`` is the
    map as (P, 3) points with ``p_mask``, prepared here, or a
    :class:`PrunedMap` from :func:`pruned_map` (its mask inside). The
    queries are walked in ``q_order`` (from :func:`query_order`), or in
    their own Morton order, found here (the keys kernel and one sort). With
    both prepared, a search is one launch."""
    if isinstance(points, PrunedMap):
        if p_mask is not None:
            raise ValueError("a PrunedMap carries its mask: pass p_mask=None")
        pmap = points
    else:
        pmap = pruned_map_cuda(points, p_mask)
    _check_pruned(queries, pmap, k, q_mask, q_order)
    if q_order is None:
        q_order = torch.sort(morton_keys_cuda(queries, q_mask)).values
    out_d, out_i, _ = launch_pruned_kernel(queries, pmap, q_mask, q_order, k)
    count_launch("knn_pruned", queries.shape[0], pmap.n_points, k)
    return out_d, out_i


def _takes_pruned(queries) -> bool:
    """Whether a search of ``queries`` takes the pruned kernel."""
    return use_kernel(queries) and pruned_enabled()


def _dense_route(n_points: int, masked: bool):
    """B1's or B2's wrapper, as the JAX dispatch picks its Pallas kernels:
    count-bounded when a mask is given and P ≤ 65536, dense otherwise (the
    same result; the launch name keeps each TPU kernel's counterpart)."""
    return knn_counted_cuda if n_points <= COUNTED_MAX_P and masked else knn_dense_cuda


def knn_auto(queries, points, k: int = 5, p_mask=None, q_mask=None):
    """Device-dispatching kNN: a CUDA kernel for CUDA tensors — the pruned
    one under ``LILI_OM_KNN_PRUNED=1``, else B1 or B2 by the JAX rule
    (:func:`_dense_route`) — and the plain version for CPU tensors."""
    if _takes_pruned(queries):
        return knn_pruned_cuda(queries, points, k, p_mask, q_mask)
    if use_kernel(queries):
        masked = p_mask is not None or q_mask is not None
        return _dense_route(points.shape[0], masked)(queries, points, k, p_mask, q_mask)
    if queries.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kNN for device {queries.device}")
    return knn(queries, points, k=k, q_mask=q_mask, p_mask=p_mask)


def searcher(points, p_mask, queries, q_mask):
    """``search(pw, k)``: :func:`knn_auto` of a moving copy ``pw`` of
    ``queries`` (rows and mask kept) against one fixed map, as ICP searches.
    On the card the map is prepared once, here, for the kernel the searches
    take (the switch read once): B3's map and the queries' Morton order,
    taken in their own frame (a rigid motion keeps Morton neighbours close;
    any order is exact, only the pruning depends on it), or B1/B2's
    :class:`KnnMap`. Each search is then one launch."""
    if _takes_pruned(queries):
        pmap, order = pruned_map(points, p_mask), query_order(queries, q_mask)
        return lambda pw, k: knn_pruned_cuda(pw, pmap, k, q_mask=q_mask, q_order=order)
    if use_kernel(queries):
        search = _dense_route(points.shape[0], p_mask is not None or q_mask is not None)
        kmap = knn_map(points, p_mask)
        return lambda pw, k: search(pw, kmap, k, q_mask=q_mask)
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
