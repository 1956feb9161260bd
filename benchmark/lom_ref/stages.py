"""The system's glue around the stages, as plain functions: frozen copies of
what ``LiliOmSystem`` (``models/system.py`` of the port) does between a
sweep and the stage calls — the IMU slices, the spin and Livox
preprocessing, the keyframe's IMU interval and the translation deskew's
clamp — over the log's raw IMU stream instead of the system's buffer —
and the loop closure's host submaps over the keyframe archive."""
from __future__ import annotations

import numpy as np
import torch

from .ops.features_livox import bin_livox_image, extract_features_livox
from .ops.features_spin import extract_features_spin, integrate_gyro, undistort
from .ops.voxel import pad_cloud, voxel_downsample
from .utils.math import quat_conj_np, quat_rotate_np


def _np_dtype(dtype):
    return torch.empty(0, dtype=dtype).numpy().dtype


def _on(x, device, dtype):
    """A host array, list or tensor as a tensor on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device=device, dtype=dtype)


def imu_slice(imu, t0: float, t1: float):
    """Samples with t0 < stamp ≤ t1, plus dts (the first from t0)."""
    s, accs, gyrs = imu
    idx = np.where((s > t0) & (s <= t1))[0]
    if len(idx) == 0:
        return None
    stamps = s[idx]
    dts = stamps - np.concatenate([[t0], stamps[:-1]])
    return dts, accs[idx], gyrs[idx]


def padded_imu(sl, cap: int, dtype, device):
    """A slice padded to ``cap`` samples as device tensors (dts, accs, gyrs,
    mask)."""
    npd = _np_dtype(dtype)
    d = np.zeros((cap,), npd)
    a = np.zeros((cap, 3), npd)
    g = np.zeros((cap, 3), npd)
    m = np.zeros((cap,), bool)
    if sl is not None:
        n = min(len(sl[0]), cap)
        d[:n], a[:n], g[:n], m[:n] = sl[0][:n], sl[1][:n], sl[2][:n], True
    return (_on(d, device, dtype), _on(a, device, dtype), _on(g, device, dtype),
            _on(m, device, torch.bool))


def gyro_slice_padded(imu, stamp: float, period: float, dtype, device, cap: int = 64):
    """Fixed-capacity (dts, gyrs, mask) over the sweep [stamp, stamp+period]."""
    dts, _, gyrs, mask = padded_imu(imu_slice(imu, stamp, stamp + period), cap, dtype, device)
    return dts, gyrs, mask


def deskew_translation(rel_t, max_sweep_translation: float = 1.0) -> np.ndarray:
    """The translation deskew of the next sweep from this sweep's odometry
    ``rel_t``: bounded to ``max_sweep_translation`` (None: no sweep yet)."""
    if rel_t is None:
        return np.zeros(3)
    rt = np.asarray(rel_t.detach().cpu().numpy() if isinstance(rel_t, torch.Tensor) else rel_t)
    nrm = float(np.linalg.norm(rt))
    if nrm > max_sweep_translation:
        rt = rt * (max_sweep_translation / nrm)
    return rt


def preprocess_spin(img, valid, rel_time, imu, stamp, t_scan, q_lb, cfg, period, dtype, device):
    """Gyro undistortion + feature extraction of one organized sweep.
    Returns the ``FeatureClouds``."""
    dts, gyrs, mask = gyro_slice_padded(imu, stamp, period, dtype, device)
    q_scan = integrate_gyro(dts, gyrs, mask)
    img, rel_time = _on(img, device, dtype), _on(rel_time, device, dtype)
    flat = undistort(img.reshape(-1, 3), rel_time.reshape(-1), q_scan,
                     q_lb=_on(q_lb, device, dtype), t_scan=_on(t_scan, device, dtype))
    return extract_features_spin(flat.reshape(img.shape), valid.to(device=device, dtype=torch.bool),
                                 rel_time, cfg, device=device)


def preprocess_livox(pts, line, ratio, refl, valid, imu, stamp, t_scan, cfg, scan_cap: int,
                     kf_edge_cap: int, period, dtype, device):
    """Undistortion (gyro, plus ``t_scan`` when the deskew is on), binning,
    eigen-patch features and the 0.3 m surf downsample of one Livox sweep.
    Returns (surf, surf_mask, surf_refl, edge, edge_mask) as the odometry
    and a keyframe's fusion get them."""
    pts, ratio = _on(pts, device, dtype), _on(ratio, device, dtype)
    valid = valid.to(device=device, dtype=torch.bool)
    dts, gyrs, mask = gyro_slice_padded(imu, stamp, period, dtype, device)
    q_scan = integrate_gyro(dts, gyrs, mask)
    t_scan = None if t_scan is None else _on(t_scan, device, dtype)
    pts = undistort(pts, ratio, q_scan, t_scan=t_scan)
    img, img_curv, img_valid = bin_livox_image(pts, line.to(device=device, dtype=torch.int32),
                                               ratio, 0.1 * _on(refl, device, dtype), valid, cfg)
    lf = extract_features_livox(img, img_curv, img_valid, cfg, device=device)
    surf, surf_refl, surf_mask = voxel_downsample(lf.surf_pts, lf.surf_mask, 0.3, scan_cap,
                                                  feats=lf.surf_curv[:, None])
    edge, edge_mask = pad_cloud(lf.edge_pts, lf.edge_mask, kf_edge_cap)
    return surf, surf_mask, surf_refl[:, 0], edge, edge_mask


def keyframe_imu(imu, prev_stamp, stamp: float, cap: int, dtype, device):
    """The keyframe's IMU interval as fusion gets it: since the previous
    keyframe, or for the first keyframe the one sample at its stamp (a
    dt = 0 step that seeds the midpoint chain)."""
    if prev_stamp is None:
        s, accs, gyrs = imu
        sl = None
        if len(s) > 0:
            near = np.searchsorted(s, stamp)
            j = min(max(near - 1, 0), len(s) - 1)
            sl = (np.zeros(1), accs[j:j + 1], gyrs[j:j + 1])
    else:
        sl = imu_slice(imu, prev_stamp, stamp)
    return padded_imu(sl, cap, dtype, device)


def voxel_downsample_np(pts, leaf: float):
    """Host-side exact voxel-centroid downsample (numpy, unbounded extent):
    int64 keys of 2²¹ cells per axis grouped by ``np.unique``, so the
    centroids come out in key order."""
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


def world_cloud(c, t, q, q_lb, t_lb):
    """A sensor-frame keyframe cloud (host) in the world: the lidar→body
    extrinsic, then the keyframe's pose (t, q)."""
    if len(c) == 0:
        return c.reshape(0, 3)
    q_lb, t_lb = np.asarray(q_lb, c.dtype), np.asarray(t_lb, c.dtype)
    cb = quat_rotate_np(quat_conj_np(q_lb)[None, :], c - t_lb[None, :])
    return quat_rotate_np(np.broadcast_to(np.asarray(q, c.dtype), (len(cb), 4)), cb) \
        + np.asarray(t, c.dtype)


def submap(clouds, g_t, g_q, q_lb, t_lb, leaf: float, cap: int, dtype, device):
    """A loop closure's world-frame submap: ``clouds`` [(keyframe index,
    sensor-frame cloud)] at the graph poses, downsampled exactly on the host
    and padded to ``cap`` rows (over capacity the key-ordered voxels are
    decimated by stride); (pts, mask), or None with no point."""
    pts = [w for i, c in clouds if len(w := world_cloud(c, g_t[i], g_q[i], q_lb, t_lb))]
    if not pts:
        return None
    ds = voxel_downsample_np(np.concatenate(pts), leaf)
    if len(ds) > cap:
        ds = ds[::-(-len(ds) // cap)][:cap]
    out = np.zeros((cap, 3), _np_dtype(dtype))
    out[:len(ds)] = ds
    return (torch.as_tensor(out).to(device), torch.as_tensor(np.arange(cap) < len(ds)).to(device))
