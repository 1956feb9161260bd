"""Fixed-shape voxel-grid downsampling (port of ``lili_om_tpu/ops/voxel.py``:
the functions on the per-scan path, the host-side exact downsample of the
loop-closure submaps, and the helpers no path calls, the occupancy-tiered
merge and the close-point filter).

Centroid per voxel, computed as one sort by a scrambled voxel key plus one
sorted segment sum (``ops/segred.py``, kernel B4 on the card), with a
static output capacity and a validity mask. Keys pack
3×10-bit cells relative to the cloud's minimum cell, exactly as the JAX
package does, so the output slots come out in the same order: ascending
scrambled key. Rows inside one voxel segment may be summed in another order
than in the JAX package; that changes only the rounding of the sums.

All tables come out valid-first (valid segments occupy the leading rows),
which the kNN kernel's tile bound relies on.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .segred import segment_sum_auto

_BITS = 10  # cells per axis = 1024
_I32_MAX = 2**31 - 1
_I32_MIN = -(2**31)
_M32 = 0xFFFFFFFF


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a value mod 2³² → the int32 with the same low bits."""
    return (((x & _M32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h · c) mod 2³² for 0 ≤ h < 2³², in int64 without overflow: the
    constant is split in 16-bit halves so every partial product is < 2⁴⁸."""
    lo = (h * (c & 0xFFFF)) & _M32
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _scramble(key: torch.Tensor) -> torch.Tensor:
    """Bijective int32 bit-mix of the voxel key (the "lowbias32" finalizer,
    computed mod 2³² in int64). The sign bit is flipped at the end, as in
    the JAX package, so the int32 order equals the uint32 order of the mix."""
    h = key.to(torch.int64) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    return _to_i32(h ^ 0x80000000)


def _group_mix(scram: torch.Tensor, groups: torch.Tensor) -> torch.Tensor:
    """``_scramble(scram ^ (group · −1640531527))`` with int32 wrap-around."""
    g = _to_i32(groups.to(torch.int64) * -1640531527)
    return _scramble(scram ^ g)


def voxel_keys(pts: torch.Tensor, leaf: float, mask: torch.Tensor) -> torch.Tensor:
    """int32 packed voxel key per point, relative to the cloud's min cell."""
    cells = torch.floor(pts / leaf).to(torch.int32)
    cmin = torch.min(torch.where(mask[..., None], cells, 2**30), dim=-2).values
    rel = torch.clamp(cells - cmin, 0, (1 << _BITS) - 1)
    return (rel[..., 0] << (2 * _BITS)) | (rel[..., 1] << _BITS) | rel[..., 2]


def _starts(key_s: torch.Tensor, grp_s: Optional[torch.Tensor] = None) -> torch.Tensor:
    change = key_s[1:] != key_s[:-1]
    if grp_s is not None:
        change = change | (grp_s[1:] != grp_s[:-1])
    return torch.cat([torch.ones(1, dtype=torch.bool, device=key_s.device), change])


def _key_order(scram: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Stable sort order by scrambled key, invalid rows strictly last (an
    int64 key: as an int32 ``I32_MAX`` fill, a valid row whose grouped mix
    equals ``I32_MAX`` would sort among the invalid ones, split its voxel
    and break the non-decreasing segment ids the segment sum takes)."""
    return torch.argsort(torch.where(valid, scram.to(torch.int64), 2**31), stable=True)


def _segment_reduce(vals: torch.Tensor, seg: torch.Tensor, n: int, how: str,
                    init: int) -> torch.Tensor:
    out = torch.full((n,), init, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, seg, vals, reduce=how, include_self=True)


def voxel_downsample(pts: torch.Tensor, mask: torch.Tensor, leaf: float, max_out: int,
                     feats: Optional[torch.Tensor] = None,
                     groups: Optional[torch.Tensor] = None):
    """Downsample to ≤ ``max_out`` voxel centroids; overflow drops voxels in
    scrambled-key order. ``feats`` (N,F) are averaged alongside xyz;
    ``groups`` (N,) keep points of different groups in different voxels.

    Returns (out (max_out,3), out_mask) or (out, out_feats, out_mask)."""
    key = voxel_keys(pts, leaf, mask)
    key = torch.where(mask, key, _I32_MAX)
    scram = _scramble(key) if groups is None else _group_mix(_scramble(key), groups)
    order = _key_order(scram, mask)
    key_s = key[order]
    pts_s = pts[order]
    valid_s = key_s != _I32_MAX
    grp_s = None
    if groups is not None:
        grp = torch.where(mask, groups.to(torch.int32), -1)
        grp_s = torch.where(valid_s, grp[order], -1)
    seg_id = torch.cumsum(_starts(key_s, grp_s).to(torch.int32), 0) - 1
    in_cap = (seg_id < max_out) & valid_s
    seg_id_c = torch.where(in_cap, seg_id, max_out).to(torch.int64)

    ones = in_cap.to(pts.dtype)
    payload = [pts_s]
    if feats is not None:
        payload.append(feats[order].to(pts.dtype))
    payload.append(ones[:, None])
    stacked = torch.cat(payload, dim=1) * ones[:, None]
    sums = segment_sum_auto(stacked, seg_id_c, max_out)
    return _centroids(sums, feats is not None)


def _centroids(sums: torch.Tensor, with_feats: bool):
    cnt = sums[:, -1]
    out_mask = cnt > 0
    denom = torch.clamp(cnt, min=1.0)[:, None]
    out = torch.where(out_mask[:, None], sums[:, 0:3] / denom, 0.0)
    if with_feats:
        fout = torch.where(out_mask[:, None], sums[:, 3:-1] / denom, 0.0)
        return out, fout, out_mask
    return out, out_mask


def voxel_downsample_ordered(pts: torch.Tensor, mask: torch.Tensor, leaf: float,
                             max_out: int, feats: Optional[torch.Tensor] = None,
                             groups: Optional[torch.Tensor] = None,
                             runs_cap: Optional[int] = None):
    """Exact voxel downsample for scan-ordered clouds, same contract and
    results as :func:`voxel_downsample` up to summation order: consecutive
    points of one (voxel, group) first merge into runs without a sort, then
    the run table goes through the hash-ordered merge."""
    N = pts.shape[0]
    dev = pts.device
    if runs_cap is None:
        runs_cap = min(N, max(4 * max_out, N // 3))
    key = voxel_keys(pts, leaf, mask)
    key = torch.where(mask, key, _I32_MAX)
    if groups is None:
        grp = torch.zeros((N,), dtype=torch.int32, device=dev)
    else:
        grp = torch.where(mask, groups.to(torch.int32), -1)
    run_id = torch.cumsum(_starts(key, grp).to(torch.int32), 0) - 1
    in_cap = run_id < runs_cap
    run_id_c = torch.where(in_cap, run_id, runs_cap).to(torch.int64)

    ones = (mask & in_cap).to(pts.dtype)
    payload = [pts]
    if feats is not None:
        payload.append(feats.to(pts.dtype))
    payload.append(ones[:, None])
    stacked = torch.cat(payload, dim=1) * ones[:, None]
    run_sums = segment_sum_auto(stacked, run_id_c, runs_cap)
    run_key = _segment_reduce(torch.where(in_cap, key, _I32_MAX), run_id_c,
                              runs_cap + 1, "amin", _I32_MAX)[:runs_cap]
    run_grp = _segment_reduce(torch.where(in_cap, grp, _I32_MIN), run_id_c,
                              runs_cap + 1, "amax", _I32_MIN)[:runs_cap]
    run_valid = run_sums[:, -1] > 0

    # stage 2: the hash-ordered merge over runs
    run_key = torch.where(run_valid, run_key, _I32_MAX)
    scram = (_scramble(run_key) if groups is None
             else _group_mix(_scramble(run_key), run_grp))
    order = _key_order(scram, run_valid)
    key_s = run_key[order]
    sums_s = run_sums[order]
    valid_s = key_s != _I32_MAX
    grp_s = None
    if groups is not None:
        grp_s = torch.where(valid_s, torch.where(run_valid, run_grp, -1)[order], -1)
    seg_id = torch.cumsum(_starts(key_s, grp_s).to(torch.int32), 0) - 1
    in_cap2 = (seg_id < max_out) & valid_s
    seg_id_c = torch.where(in_cap2, seg_id, max_out).to(torch.int64)
    sums = segment_sum_auto(sums_s * in_cap2[:, None].to(sums_s.dtype), seg_id_c, max_out)
    return _centroids(sums, feats is not None)


def merge_voxel_entries(cells, sums, cnt, valid, num_out: int,
                        second_sel=None, primary_sel=None):
    """Merge weighted voxel entries by absolute cell coordinates — the
    primitive behind the persistent local-map tables. Entries with equal
    cells merge by one scrambled-key sort + segment sum; output segments come
    out in hash order and entries whose merged count cancels come out
    invalid. ``primary_sel``/``second_sel`` select the rows of two
    reductions taken at the same segment positions.

    Returns (cells, sums, cnt, valid) [+ the same for ``second_sel``]."""
    N = cells.shape[0]
    dev = cells.device
    cmin = torch.min(torch.where(valid[:, None], cells, 2**30), dim=0).values
    rel = torch.clamp(cells - cmin, 0, (1 << _BITS) - 1)
    key = (rel[..., 0] << (2 * _BITS)) | (rel[..., 1] << _BITS) | rel[..., 2]
    key = torch.where(valid, key, _I32_MAX)
    order = _key_order(_scramble(key), valid)
    key_s = key[order]
    payload = torch.cat([sums, cnt[:, None]], dim=1)[order]
    selbits = None
    if primary_sel is not None or second_sel is not None:
        p = (torch.ones((N,), dtype=torch.int32, device=dev) if primary_sel is None
             else primary_sel.to(torch.int32))
        s = (torch.zeros((N,), dtype=torch.int32, device=dev) if second_sel is None
             else second_sel.to(torch.int32))
        selbits = (p | (s << 1))[order]
    seg_id = torch.cumsum(_starts(key_s).to(torch.int32), 0) - 1
    in_cap = (seg_id < num_out) & (key_s != _I32_MAX)
    seg_id_c = torch.where(in_cap, seg_id, num_out).to(torch.int64)
    w = in_cap.to(sums.dtype)

    def reduce(sel_w):
        s = segment_sum_auto(payload * sel_w[:, None], seg_id_c, num_out)
        c = s[:, -1]
        return s[:, :-1], c, c > 0.5  # integer counts; fp residue of add/sub

    wp = w if selbits is None else w * (selbits & 1).to(sums.dtype)
    out_sums, out_cnt, out_valid = reduce(wp)
    out_key = _segment_reduce(torch.where(in_cap, key_s, _I32_MAX), seg_id_c,
                              num_out + 1, "amin", _I32_MAX)[:num_out]
    mask10 = (1 << _BITS) - 1
    out_cells = torch.stack([out_key >> (2 * _BITS), (out_key >> _BITS) & mask10,
                             out_key & mask10], dim=1) + cmin
    out_cells = torch.where(out_valid[:, None], out_cells, 0)
    if second_sel is None:
        return out_cells, out_sums, out_cnt, out_valid
    s2, c2, v2 = reduce(w * ((selbits >> 1) & 1).to(sums.dtype))
    cells2 = torch.where(v2[:, None], out_cells, 0)
    return (out_cells, out_sums, out_cnt, out_valid), (cells2, s2, c2, v2)


def merge_voxel_entries_tiered(cells, sums, cnt, valid, num_out: int, table_rows: int,
                               tiers: tuple = (), second_sel=None, primary_sel=None):
    """:func:`merge_voxel_entries` sorting only the smallest ``tier`` of the
    table that provably holds the merge (not the production default, as in
    the JAX package). Rows ``[0:table_rows)`` are the table, the rest delta
    rows (always included). Tier ``B`` is taken iff no valid table row lies
    at or past ``B`` and ``n_valid(table[:B]) + n_valid(delta) ≤ B``; then
    the output is the sliced merge padded with invalid zero rows to
    ``num_out``, equal to the full merge's (sums up to the summation order
    inside a segment).

    JAX decides the tier on the device (nested ``lax.cond``); eager PyTorch
    cannot branch without reading the predicate, so this reads one boolean
    per tier to the host (one sync a call)."""
    cand = sorted(b for b in tiers if b < num_out)
    chosen = None
    if cand:
        d_valid = torch.sum(valid[table_rows:].to(torch.int32))
        fits = torch.stack([
            ~torch.any(valid[b:table_rows])
            & (torch.sum(valid[:b].to(torch.int32)) + d_valid <= b) for b in cand])
        chosen = next((b for b, ok in zip(cand, fits.tolist()) if ok), None)
    if chosen is None:
        return merge_voxel_entries(cells, sums, cnt, valid, num_out,
                                   second_sel=second_sel, primary_sel=primary_sel)
    B = chosen
    cut = lambda x: None if x is None else torch.cat([x[:B], x[table_rows:]])
    out = merge_voxel_entries(cut(cells), cut(sums), cut(cnt), cut(valid), B,
                              second_sel=cut(second_sel), primary_sel=cut(primary_sel))
    pad = num_out - B

    def padded(*outs):
        return tuple(torch.cat([x, x.new_zeros((pad,) + x.shape[1:])]) for x in outs)

    if second_sel is None:
        return padded(*out)
    return tuple(padded(*o) for o in out)


def remove_close_points(pts: torch.Tensor, mask: torch.Tensor, min_range: float) -> torch.Tensor:
    """Validity update dropping points closer than ``min_range`` and
    non-finite ones (removeClosedPointCloud: LiLi-OM Preprocessing.cpp:225-226
    [0.1 m], ROT Preprocessing.cpp:281 [3.0 m])."""
    r2 = torch.sum(pts * pts, dim=-1)
    return mask & (r2 >= min_range * min_range) & torch.all(torch.isfinite(pts), dim=-1)


def pad_cloud(pts: torch.Tensor, mask: torch.Tensor, cap: int):
    """Pad or truncate a (N,3) cloud + mask to a static capacity."""
    n = pts.shape[0]
    if n >= cap:
        return pts[:cap], mask[:cap]
    pad = cap - n
    return (torch.cat([pts, pts.new_zeros((pad, 3))]),
            torch.cat([mask, mask.new_zeros((pad,))]))


def voxel_downsample_np(pts, leaf: float):
    """Host-side exact voxel-centroid downsample (numpy, unbounded extent),
    for clouds whose span exceeds the 1024-cell axis budget of the device
    keys (loop-closure submaps). int64 keys give 2²¹ cells per axis;
    ``np.unique`` groups them, so centroids come out in key order."""
    pts = np.asarray(pts)
    if len(pts) == 0:
        return pts.reshape(0, 3)
    cells = np.floor(pts / leaf).astype(np.int64)
    cells -= cells.min(axis=0)
    key = (cells[:, 0] << 42) | (cells[:, 1] << 21) | cells[:, 2]
    uniq, inv, cnt = np.unique(key, return_inverse=True, return_counts=True)
    sums = np.zeros((len(uniq), 3), pts.dtype)
    np.add.at(sums, inv, pts)
    return sums / cnt[:, None]
