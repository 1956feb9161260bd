"""LiDAR scan simulator (port of ``lili_om_tpu/sim/lidar.py``): the spinning
and the Livox Horizon patterns and ``simulate_scan``. Each ray is cast from
the sensor's pose at its own time stamp, so clouds carry real motion
distortion."""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..utils.math import quat_mul, quat_normalize, quat_rotate
from .world import World, ray_cast


class ScanPattern(NamedTuple):
    dirs: torch.Tensor  # (K,3) unit ray directions, sensor frame
    rel_time: torch.Tensor  # (K,) in [0,1): fraction of the scan period
    line: torch.Tensor  # (K,) int32 ring id


class Scan(NamedTuple):
    pts: torch.Tensor  # (K,3) sensor frame at measurement time
    rel_time: torch.Tensor  # (K,)
    line: torch.Tensor  # (K,) int32
    reflectivity: torch.Tensor  # (K,)
    valid: torch.Tensor  # (K,) bool
    stamp: torch.Tensor  # () scan start time


def spinning_pattern(n_rings: int = 16, n_cols: int = 1800,
                     elev_min_deg: float = -15.0, elev_max_deg: float = 15.0,
                     dtype=torch.float32, device=None) -> ScanPattern:
    """Rings × azimuth columns, one full 2π sweep per scan period."""
    elev = torch.deg2rad(torch.linspace(elev_min_deg, elev_max_deg, n_rings, dtype=dtype,
                                        device=device))
    az = torch.arange(n_cols, dtype=torch.float64, device=device) * (2.0 * math.pi / n_cols)
    az = az.to(dtype)
    el_g, az_g = torch.meshgrid(elev, az, indexing="ij")
    ce = torch.cos(el_g)
    dirs = torch.stack([ce * torch.cos(az_g), ce * torch.sin(az_g), torch.sin(el_g)], dim=-1)
    rel = (az / (2.0 * math.pi)).expand(n_rings, n_cols)
    line = torch.arange(n_rings, dtype=torch.int32, device=device)[:, None].expand(n_rings, n_cols)
    return ScanPattern(dirs.reshape(-1, 3), rel.reshape(-1).to(dtype), line.reshape(-1))


def livox_pattern(n_lines: int = 6, pts_per_line: int = 4000,
                  fov_h_deg: float = 81.7, fov_v_deg: float = 25.1,
                  f_fast: float = 50.0, f_slow: float = 7.3, period: float = 0.1,
                  dtype=torch.float32, device=None) -> ScanPattern:
    """Livox-Horizon-like non-repetitive pattern: the 6 lines share one fast
    azimuth sweep of the 81.7° field (they are stacked vertically and move
    together, as the 6-line × 6-column patches need) and each wobbles in
    its own elevation band; points are ordered in time along each line."""
    t = (torch.arange(pts_per_line, dtype=torch.float64, device=device)
         / pts_per_line).to(dtype)
    li = torch.arange(n_lines, dtype=dtype, device=device)
    phase = 2.0 * math.pi * li / n_lines
    tt = t[None, :] * period
    az = math.radians(fov_h_deg / 2) * torch.sin(2 * math.pi * f_fast * tt) \
        * torch.ones_like(phase[:, None])
    band = math.radians(fov_v_deg) * ((li + 0.5) / n_lines - 0.5)
    el = band[:, None] + math.radians(fov_v_deg / (2 * n_lines)) * torch.sin(
        2 * math.pi * f_slow * tt + 2.3 * phase[:, None])
    ce = torch.cos(el)
    dirs = torch.stack([ce * torch.cos(az), ce * torch.sin(az), torch.sin(el)], dim=-1)
    rel = t[None, :].expand(n_lines, pts_per_line)
    line = torch.arange(n_lines, dtype=torch.int32, device=device)[:, None].expand(
        n_lines, pts_per_line)
    return ScanPattern(dirs.reshape(-1, 3), rel.reshape(-1), line.reshape(-1))


def simulate_scan(world: World, traj, t_start: float, pattern: ScanPattern,
                  period: float = 0.1, min_range: float = 0.5, max_range: float = 150.0,
                  t_sl=None, q_sl=None) -> Scan:
    """Cast one sweep; points come back in the sensor frame at their own
    measurement instant. ``t_sl, q_sl``: optional body←sensor extrinsic."""
    stamps = t_start + pattern.rel_time * period
    ps, qs = traj(stamps)
    qs = quat_normalize(qs)
    if t_sl is not None:
        t_sl = torch.as_tensor(t_sl, dtype=ps.dtype).to(ps.device)
        q_sl = torch.as_tensor(q_sl, dtype=qs.dtype).to(qs.device)
        ps = ps + quat_rotate(qs, t_sl)
        qs = quat_normalize(quat_mul(qs, q_sl.expand_as(qs)))
    dirs_world = quat_rotate(qs, pattern.dirs)
    rng = ray_cast(world, ps, dirs_world, min_range=min_range, max_range=max_range)
    valid = torch.isfinite(rng)
    rng_safe = torch.where(valid, rng, 1.0)
    pts = pattern.dirs * rng_safe[:, None]
    refl = 5.0 + 10.0 / (1.0 + rng_safe / 20.0) + 0.3 * pattern.line.to(pts.dtype)
    return Scan(pts=pts, rel_time=pattern.rel_time, line=pattern.line, reflectivity=refl,
                valid=valid, stamp=torch.tensor(t_start, dtype=pts.dtype, device=pts.device))
