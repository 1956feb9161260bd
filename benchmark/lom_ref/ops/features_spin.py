"""Spinning-LiDAR (LOAM-style) feature extraction as fixed-shape tensor ops
(port of ``lili_om_tpu/ops/features_spin.py``): an 11-tap curvature stencil
along each ring, non-maximum suppression, per-sector top-k edge and flat
picks, and a per-ring voxel downsample of the remaining (less-flat) points.

``jax.lax.top_k`` breaks ties toward the lower index; the port sorts with
``torch.sort(..., stable=True)`` and slices, which gives the same order.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..utils.math import exp_so3, quat_conj, quat_mul, quat_normalize, quat_rotate, quat_slerp
from .scatter import scatter_last
from .voxel import voxel_downsample, voxel_downsample_ordered


class SpinFeatureConfig(NamedTuple):
    """Knobs of the ROT preprocessing (field for field as in the JAX package)."""

    n_sectors: int = 6
    edge_thres: float = 2.0
    flat_thres: float = 0.1
    max_sharp: int = 2
    max_less_sharp: int = 10
    max_flat: int = 4
    suppress_radius: int = 5
    min_range: float = 0.5
    min_input_range: float = 3.0
    ds_leaf: float = 0.6
    ds_rate: int = 1
    surf_cap: int = 8192
    edge_window: int = 5
    per_ring_ds: bool = True
    ordered_ds: bool = True
    carry_rel_time: bool = False


class FeatureClouds(NamedTuple):
    edge_pts: torch.Tensor  # (E,3) less-sharp edges (includes sharp)
    edge_mask: torch.Tensor  # (E,)
    sharp_mask: torch.Tensor  # (E,)
    flat_pts: torch.Tensor  # (F,3)
    flat_mask: torch.Tensor  # (F,)
    surf_pts: torch.Tensor  # (S,3) less-flat cloud, voxel-downsampled
    surf_mask: torch.Tensor  # (S,)
    full_pts: torch.Tensor  # (N,3)
    full_mask: torch.Tensor  # (N,)
    full_rel_time: torch.Tensor  # (N,)
    surf_rel_time: torch.Tensor | None = None
    edge_rel_time: torch.Tensor | None = None


def integrate_gyro(dts: torch.Tensor, gyrs: torch.Tensor, mask=None) -> torch.Tensor:
    """Midpoint gyro-only rotation over the scan (a sequential loop)."""
    if mask is None:
        mask = torch.ones(dts.shape, dtype=torch.bool, device=dts.device)
    g_prev = torch.cat([gyrs[:1], gyrs[:-1]], dim=0)
    un_gyr = 0.5 * (g_prev + gyrs)
    q = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=gyrs.dtype, device=gyrs.device)
    for i in range(dts.shape[0]):
        dt = torch.where(mask[i], dts[i], 0.0)
        q = quat_normalize(quat_mul(q, exp_so3(un_gyr[i] * dt)))
    return q


def undistort(pts: torch.Tensor, rel_time: torch.Tensor, q_scan: torch.Tensor,
              q_lb: torch.Tensor | None = None, t_scan: torch.Tensor | None = None):
    """Rotate each point into the scan-start frame by the slerp fraction of
    the scan rotation, optionally conjugated by the lidar←IMU extrinsic and
    with linear translation deskew ``+ ratio·t_scan``."""
    n = pts.shape[0]
    ratio = torch.clamp(rel_time, 0.0, 1.0)
    qid = torch.tensor([1.0, 0, 0, 0], dtype=pts.dtype, device=pts.device).expand(n, 4)
    q_si = quat_slerp(qid, q_scan.expand(n, 4), ratio)
    if q_lb is not None:
        q_lb = q_lb.expand(n, 4)
        q_si = quat_mul(quat_mul(q_lb, q_si), quat_conj(q_lb))
    out = quat_rotate(q_si, pts)
    if t_scan is not None:
        out = out + ratio[:, None] * t_scan[None, :]
    return out


def ring_from_angle(pts: torch.Tensor, n_rings: int):
    """Ring id from vertical angle (16/32/64-line formulas). Returns (ring, ok)."""
    xy = torch.sqrt(pts[:, 0] ** 2 + pts[:, 1] ** 2)
    ang = torch.rad2deg(torch.atan2(pts[:, 2], xy))
    if n_rings == 16:
        ring = torch.round((ang + 15.0) / 2.0 + 0.5).to(torch.int32)
    elif n_rings == 32:
        ring = torch.round((ang + 92.0 / 3.0) * 3.0 / 4.0).to(torch.int32)
    elif n_rings == 64:
        ring = torch.where(ang >= -8.83, torch.round((2.0 - ang) * 3.0 + 0.5),
                           torch.round((-8.83 - ang) * 2.0 + 0.5) + 32.0).to(torch.int32)
        ok = (ang < 2.0) & (ang > -24.33) & (ring <= 50) & (ring >= 0)
        return ring, ok
    else:
        raise ValueError(f"unsupported ring count {n_rings}")
    return ring, (ring >= 0) & (ring < n_rings)


def organize_cloud(pts: torch.Tensor, valid: torch.Tensor, n_rings: int, n_cols: int):
    """Scatter an unorganized cloud into a (rings × azimuth-columns) image;
    the last writer wins on collisions (``ops/scatter.py``)."""
    ring, ok = ring_from_angle(pts, n_rings)
    az = torch.atan2(pts[:, 1], pts[:, 0])
    col = torch.remainder(torch.floor((az + math.pi) / (2 * math.pi) * n_cols).to(torch.int64), n_cols)
    ok = ok & valid
    ring = ring.to(torch.int64)
    # as the JAX scatter: rejected points write zeros at pixel (0, 0)
    flat = torch.where(ok, ring * n_cols + col, 0)
    rel = (az + math.pi) / (2 * math.pi)
    img, rel_img = scatter_last(flat, n_rings * n_cols, torch.where(ok[:, None], pts, 0.0),
                                torch.where(ok, rel, 0.0))
    img_valid = torch.zeros((n_rings * n_cols,), dtype=torch.int32, device=pts.device)
    img_valid.scatter_reduce_(0, flat, ok.to(torch.int32), reduce="amax")
    return (img.reshape(n_rings, n_cols, 3), (img_valid > 0).reshape(n_rings, n_cols),
            rel_img.reshape(n_rings, n_cols))


def _shift(x: torch.Tensor, s: int, dim: int, fill=0.0):
    """Shift along ``dim`` with fill (no wrap): positive s pulls from the right."""
    rolled = torch.roll(x, -s, dims=dim)
    n = x.shape[dim]
    idx = torch.arange(n, device=x.device) + s
    ok = (idx >= 0) & (idx < n)
    shape = [1] * x.dim()
    shape[dim] = n
    return torch.where(ok.reshape(shape), rolled, fill)


def curvature_image(img: torch.Tensor, valid: torch.Tensor, window: int = 5):
    """LOAM curvature ‖Σ_{±w} p_j − 2w·p_i‖² along each ring. Returns
    (curv (R,C), ok (R,C)); ok needs the full ±w window valid."""
    acc = -2.0 * window * img
    ok = valid
    for s in range(-window, window + 1):
        if s == 0:
            continue
        acc = acc + _shift(img, s, dim=1)
        ok = ok & _shift(valid, s, dim=1, fill=False)
    curv = torch.sum(acc * acc, dim=-1)
    return torch.where(ok, curv, 0.0), ok


def _local_extremum(curv: torch.Tensor, ok: torch.Tensor, radius: int, mode: str):
    """A pick candidate must be the extremum of its ±radius ring window."""
    if mode == "max":
        x = torch.where(ok, curv, float("-inf"))
        ext = F.max_pool1d(x[:, None, :], 2 * radius + 1, stride=1,
                           padding=radius)[:, 0, :]
    else:
        x = torch.where(ok, curv, float("inf"))
        ext = -F.max_pool1d(-x[:, None, :], 2 * radius + 1, stride=1,
                            padding=radius)[:, 0, :]
    return ok & (x == ext)


def _top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last dim: descending, ties to the lower index."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def extract_features_spin(img: torch.Tensor, valid: torch.Tensor, rel_time: torch.Tensor,
                          cfg: SpinFeatureConfig = SpinFeatureConfig(),
                          device=None) -> FeatureClouds:
    """Full ROT feature extraction over an organized (R,C,3) scan image.
    Runs on ``device`` (None = the CUDA device)."""
    dev = resolve_device(device)
    img, valid, rel_time = img.to(dev), valid.to(dev), rel_time.to(dev)
    full_mask_src = valid & (torch.sum(img * img, dim=-1) >= cfg.min_range ** 2)
    full_pts_src, full_rel_src = img, rel_time
    if cfg.ds_rate > 1:
        # the reference strides the feature loop over rings
        img = img[::cfg.ds_rate]
        valid = valid[::cfg.ds_rate]
        rel_time = rel_time[::cfg.ds_rate]
    R, C, _ = img.shape
    S = cfg.n_sectors
    Csec = C // S
    dtype = img.dtype

    rng2 = torch.sum(img * img, dim=-1)
    base_ok = valid & (rng2 >= cfg.min_range ** 2)
    curv, win_ok = curvature_image(img, valid, cfg.edge_window)
    ok = base_ok & win_ok

    # --- edge picks: curvature > thres, local max, top-k per sector ---
    edge_cand = _local_extremum(curv, ok & (curv > cfg.edge_thres), cfg.suppress_radius, "max")
    curv_sec = curv.reshape(R, S, Csec)
    masked = torch.where(edge_cand.reshape(R, S, Csec), curv_sec, float("-inf"))
    top_v, top_i = _top_k(masked, cfg.max_less_sharp)  # (R,S,10)
    pick_ok = torch.isfinite(top_v)
    rank = torch.arange(top_v.shape[-1], device=dev)
    sharp = pick_ok & (rank < cfg.max_sharp)
    sec0 = (torch.arange(S, device=dev) * Csec)[None, :, None]
    col_idx = (top_i + sec0).reshape(R, -1)
    flat_img = img.reshape(R, C, 3)
    edge_pts = torch.gather(flat_img, 1, col_idx[..., None].expand(R, col_idx.shape[1], 3))
    edge_pts = edge_pts.reshape(-1, 3)
    edge_mask = pick_ok.reshape(-1)
    sharp_mask = sharp.reshape(-1)
    edge_rel = None
    if cfg.carry_rel_time:
        edge_rel = torch.gather(rel_time.reshape(R, C), 1, col_idx).reshape(-1).to(dtype)

    # --- flat picks: curvature < thres, local min, bottom-k per sector ---
    flat_cand = _local_extremum(curv, ok & (curv < cfg.flat_thres), cfg.suppress_radius, "min")
    fmask = torch.where(flat_cand.reshape(R, S, Csec), -curv_sec, float("-inf"))
    fv, fi = _top_k(fmask, cfg.max_flat)
    fcol = (fi + sec0).reshape(R, -1)
    flat_pts = torch.gather(flat_img, 1, fcol[..., None].expand(R, fcol.shape[1], 3)).reshape(-1, 3)
    flat_mask = torch.isfinite(fv).reshape(-1)

    # --- less-flat: everything valid not picked as an edge, downsampled ---
    edge_label = torch.zeros((R, S, Csec), dtype=torch.int32, device=dev)
    edge_label.scatter_reduce_(2, top_i, pick_ok.to(torch.int32), reduce="amax")
    less_flat_mask = ok & (edge_label.reshape(R, C) == 0)
    ds = voxel_downsample_ordered if cfg.ordered_ds else voxel_downsample
    ds_feats = rel_time.reshape(-1, 1).to(dtype) if cfg.carry_rel_time else None
    groups = None
    if cfg.per_ring_ds:
        # per-ring filtering: voxels never merge across rings
        groups = torch.arange(R, dtype=torch.int32, device=dev)[:, None].expand(R, C).reshape(-1)
    out = ds(img.reshape(-1, 3), less_flat_mask.reshape(-1), cfg.ds_leaf,
             cfg.surf_cap, feats=ds_feats, groups=groups)
    surf_rel = None
    if cfg.carry_rel_time:
        surf_pts, surf_feats, surf_mask = out
        surf_rel = surf_feats[:, 0]
    else:
        surf_pts, surf_mask = out

    return FeatureClouds(
        edge_pts=edge_pts.to(dtype), edge_mask=edge_mask, sharp_mask=sharp_mask,
        flat_pts=flat_pts.to(dtype), flat_mask=flat_mask,
        surf_pts=surf_pts.to(dtype), surf_mask=surf_mask,
        full_pts=full_pts_src.reshape(-1, 3), full_mask=full_mask_src.reshape(-1),
        full_rel_time=full_rel_src.reshape(-1),
        surf_rel_time=surf_rel, edge_rel_time=edge_rel,
    )
