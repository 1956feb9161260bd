"""Trajectory evaluation: TUM-format I/O, ATE and RPE (port of
``lili_om_tpu/utils/evaluation.py``).

Trajectories are exported in the TUM tools' ``stamp tx ty tz qx qy qz qw``
format, byte for byte as the JAX package writes them; ATE (after the
closed-form SE(3) alignment of Horn/Umeyama) and RPE follow the TUM
scripts' definitions. Everything here is numpy on the host: positions and
quaternions may arrive as tensors on the card (``system.graph.t``) and are
copied to the host at the boundary (:func:`host`).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .math import quat_conj_np, quat_rotate_np


def host(x) -> np.ndarray:
    """A tensor (on any device), list or array → a numpy array on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def export_tum(path: str, stamps: Sequence[float], ts, qs) -> None:
    """Write TUM format: ``stamp tx ty tz qx qy qz qw`` (one line a pose).
    ``qs`` in the w,x,y,z convention, reordered on write."""
    ts = host(ts).astype(float).reshape(-1, 3)
    qs = host(qs).astype(float).reshape(-1, 4)
    with open(path, "w") as f:
        f.write("# stamp tx ty tz qx qy qz qw\n")
        for s, t, q in zip(host(stamps).tolist(), ts, qs):
            f.write(f"{s:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                    f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}\n")


def load_tum(path: str):
    """Read TUM format → (stamps (N,), t (N,3), q_wxyz (N,4))."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rows.append([float(x) for x in line.split()][:8])
    a = np.asarray(rows)
    if len(a) == 0:
        return np.zeros(0), np.zeros((0, 3)), np.zeros((0, 4))
    q = np.stack([a[:, 7], a[:, 4], a[:, 5], a[:, 6]], axis=1)
    return a[:, 0], a[:, 1:4], q


def associate(est_stamps, gt_stamps, max_dt: float = 0.02):
    """Nearest-stamp association (the TUM associate.py rule; on a tie the
    later ground-truth stamp wins). Returns index pairs (i_est, i_gt)."""
    est_stamps = host(est_stamps)
    gt_stamps = host(gt_stamps)
    j = np.searchsorted(gt_stamps, est_stamps)
    j = np.clip(j, 0, len(gt_stamps) - 1)
    jm = np.clip(j - 1, 0, len(gt_stamps) - 1)
    pick = np.where(np.abs(gt_stamps[j] - est_stamps)
                    <= np.abs(gt_stamps[jm] - est_stamps), j, jm)
    ok = np.abs(gt_stamps[pick] - est_stamps) <= max_dt
    return np.nonzero(ok)[0], pick[ok]


def align_umeyama(est_t, gt_t, with_scale: bool = False):
    """Closed-form SE(3) (optionally Sim(3)) alignment est→gt minimizing
    ‖gt − (s·R·est + t)‖² (Umeyama 1991). Returns (s, R, t)."""
    est_t, gt_t = host(est_t), host(gt_t)
    mu_e = est_t.mean(axis=0)
    mu_g = gt_t.mean(axis=0)
    xe = est_t - mu_e
    xg = gt_t - mu_g
    C = xg.T @ xe / len(est_t)
    U, D, Vt = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    Rm = U @ S @ Vt
    if with_scale:
        var_e = (xe**2).sum() / len(est_t)
        s = float(np.trace(np.diag(D) @ S) / var_e)
    else:
        s = 1.0
    t = mu_g - s * Rm @ mu_e
    return s, Rm, t


def ate_rmse(est_stamps, est_t, gt_stamps, gt_t, align: bool = True,
             max_dt: float = 0.02) -> dict:
    """Absolute trajectory error after association (and, with ``align``,
    SE(3) alignment). Returns {"rmse", "mean", "max", "n"} in meters."""
    ie, ig = associate(est_stamps, gt_stamps, max_dt)
    if len(ie) < 2:
        return {"rmse": float("nan"), "mean": float("nan"),
                "max": float("nan"), "n": int(len(ie))}
    e = host(est_t)[ie]
    g = host(gt_t)[ig]
    if align:
        s, Rm, t = align_umeyama(e, g)
        e = (s * (Rm @ e.T)).T + t
    d = np.linalg.norm(e - g, axis=1)
    return {"rmse": float(np.sqrt((d**2).mean())), "mean": float(d.mean()),
            "max": float(d.max()), "n": int(len(d))}


def rpe(est_stamps, est_t, est_q, gt_stamps, gt_t, gt_q,
        delta: int = 10, max_dt: float = 0.02) -> dict:
    """Relative pose error over a fixed frame delta: translational drift of
    est against gt over matching intervals. Returns per-interval stats (m)."""
    ie, ig = associate(est_stamps, gt_stamps, max_dt)
    if len(ie) <= delta:
        return {"rmse": float("nan"), "n": 0}
    e_t = host(est_t)[ie]
    e_q = host(est_q)[ie]
    g_t = host(gt_t)[ig]
    g_q = host(gt_q)[ig]

    def rel(t0, q0, t1):
        return quat_rotate_np(quat_conj_np(q0), t1 - t0)

    errs = np.asarray([np.linalg.norm(rel(e_t[i], e_q[i], e_t[i + delta])
                                      - rel(g_t[i], g_q[i], g_t[i + delta]))
                       for i in range(len(e_t) - delta)])
    return {"rmse": float(np.sqrt((errs**2).mean())), "mean": float(errs.mean()),
            "max": float(errs.max()), "n": int(len(errs))}


def export_system_tum(system, path_frames: str | None = None,
                      path_keyframes: str | None = None) -> None:
    """Export a LiliOmSystem's trajectories: the densified every-frame poses
    (``dense_trajectory``) and the loop-corrected keyframe graph poses."""
    if path_frames is not None and system.dense_trajectory:
        dense = list(system.dense_trajectory)
        export_tum(path_frames, [d[0] for d in dense],
                   np.stack([host(d[1]) for d in dense]),
                   np.stack([host(d[2]) for d in dense]))
    if path_keyframes is not None and system.kf_stamps:
        n = len(system.kf_stamps)
        export_tum(path_keyframes, system.kf_stamps, system.graph.t[:n], system.graph.q[:n])
