"""Frontend scan-to-map odometry (port of ``lili_om_tpu/models/odometry.py``).

Per frame: constant-velocity pose prior; the local map from a persistent
voxel table (the last ``n_recent_frames`` frames' downsampled clouds, merged
incrementally); the scan downsampled into queries; ``n_rounds`` rounds of
5-NN search (the CUDA kernel on the card) → centered plane fits with the
reference's gates → Gauss-Newton with Huber IRLS weights; the divergence and
keyframe gates; the ring-buffer and table update.

The ``gn_tol`` early exit, a ``while_loop`` in JAX, is a host loop here: one
device sync per GN iteration to read the step norm. It stops exactly where
the JAX loop stops.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device
from ..factors.lidar import PlaneFactorBatch, huber_weight, plane_residual
from ..ops.fitting import eig3_symmetric, fit_plane
from ..ops.knn import world_knn_auto
from ..ops.voxel import merge_voxel_entries, voxel_downsample
from ..solver.gn import block_hessian, solve_normal
from ..utils.math import (exp_so3, pose_relative, quat_conj, quat_mul, quat_normalize,
                          quat_rotate, unify_quaternion)
from ..utils.metrics import count, host_read


class OdometryConfig(NamedTuple):
    """Field for field as ``lili_om_tpu.models.odometry.OdometryConfig``."""

    n_recent_frames: int = 20
    scan_cap: int = 8192
    query_cap: int = 4096
    map_cap: int = 32768
    frame_cap: int = 4096
    ds_leaf: float = 0.4
    map_table_cap: int = 0
    k: int = 5
    nn_gate: float = 1.0
    plane_tol: float = 0.06
    min_weight: float = 0.4
    huber: float = 0.1
    max_rounds: int = 8
    scan_match_cnt: int = 2
    gn_iters: int = 4
    gn_tol: float = 1e-5
    kf_dist: float = 0.2
    kf_angle: float = 0.1
    max_step_t: float = 0.5
    max_step_r: float = 0.2
    max_frame_jump: float = 2.0
    plane_fit: str = "centered"


class OdometryState(NamedTuple):
    frames_pts: torch.Tensor  # (F, S, 3) recent downsampled frames, world
    frames_mask: torch.Tensor  # (F, S)
    map_cells: torch.Tensor  # (T, 3) int32 absolute voxel cells
    map_sums: torch.Tensor  # (T, 3)
    map_cnt: torch.Tensor  # (T,)
    map_valid: torch.Tensor  # (T,)
    write_idx: torch.Tensor  # () int32 ring cursor
    frame_id: torch.Tensor  # () int32
    t: torch.Tensor  # (3,)
    q: torch.Tensor  # (4,)
    t_prev: torch.Tensor
    q_prev: torch.Tensor
    kf_t: torch.Tensor
    kf_q: torch.Tensor
    kf_frame: torch.Tensor  # () int32


class OdometryOut(NamedTuple):
    t: torch.Tensor
    q: torch.Tensor
    rel_t: torch.Tensor
    rel_q: torch.Tensor
    is_keyframe: torch.Tensor  # () bool
    n_corr: torch.Tensor  # () int32


def _table_cap(cfg: OdometryConfig) -> int:
    return cfg.map_table_cap or (cfg.map_cap + 2 * cfg.frame_cap)


def init_state(cfg: OdometryConfig, dtype=torch.float32, device=None) -> OdometryState:
    dev = resolve_device(device)
    F, S, T = cfg.n_recent_frames, cfg.frame_cap, _table_cap(cfg)
    qid = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=dev)
    z3 = torch.zeros(3, dtype=dtype, device=dev)
    i0 = torch.zeros((), dtype=torch.int32, device=dev)
    return OdometryState(
        frames_pts=torch.zeros((F, S, 3), dtype=dtype, device=dev),
        frames_mask=torch.zeros((F, S), dtype=torch.bool, device=dev),
        map_cells=torch.zeros((T, 3), dtype=torch.int32, device=dev),
        map_sums=torch.zeros((T, 3), dtype=dtype, device=dev),
        map_cnt=torch.zeros((T,), dtype=dtype, device=dev),
        map_valid=torch.zeros((T,), dtype=torch.bool, device=dev),
        write_idx=i0, frame_id=i0.clone(),
        t=z3, q=qid, t_prev=z3.clone(), q_prev=qid.clone(),
        kf_t=z3.clone(), kf_q=qid.clone(), kf_frame=i0.clone(),
    )


def _map_from_table(state: OdometryState, cfg: OdometryConfig):
    """Match map = the table's first map_cap hash-ordered voxel centroids."""
    cnt = torch.clamp(state.map_cnt[:cfg.map_cap], min=1.0)
    return state.map_sums[:cfg.map_cap] / cnt[:, None], state.map_valid[:cfg.map_cap]


def _update_map_table(state: OdometryState, ws_ds, wm_ds, cfg: OdometryConfig):
    """Merge the new frame in and the evicted ring frame out of the table."""
    leaf = cfg.ds_leaf
    ev_pts = state.frames_pts[state.write_idx.long()]
    ev_mask = state.frames_mask[state.write_idx.long()]
    cells = torch.cat([state.map_cells,
                       torch.floor(ws_ds / leaf).to(torch.int32),
                       torch.floor(ev_pts / leaf).to(torch.int32)])
    sums = torch.cat([state.map_sums, ws_ds, -ev_pts])
    cnt = torch.cat([state.map_cnt, wm_ds.to(ws_ds.dtype), -ev_mask.to(ws_ds.dtype)])
    valid = torch.cat([state.map_valid, wm_ds, ev_mask])
    return merge_voxel_entries(cells, sums, cnt, valid, _table_cap(cfg))


def plane_correspondences(scan_q, scan_q_mask, pw, nbrs, d2,
                          cfg: OdometryConfig) -> PlaneFactorBatch:
    """Plane fits + the reference's gates on precomputed k-NN candidates."""
    nn_ok = d2[:, cfg.k - 1] < cfg.nn_gate
    if cfg.plane_fit == "centered":
        ctr = torch.mean(nbrs, dim=-2)
        dd = nbrs - ctr[:, None, :]
        cov = torch.einsum("qki,qkj->qij", dd, dd)
        _, evecs = eig3_symmetric(cov)
        normal = evecs[..., :, 0]
        d_off = -torch.sum(normal * ctr, dim=-1)
    else:
        fp = fit_plane(nbrs, torch.ones(nbrs.shape[:-1], dtype=torch.bool, device=nbrs.device),
                       dist_thres=cfg.plane_tol)
        normal, d_off = fp.normal, fp.d
    pd_nbr = torch.abs(torch.einsum("qki,qi->qk", nbrs, normal) + d_off[:, None])
    plane_ok = torch.all(pd_nbr <= cfg.plane_tol, dim=-1)
    pd = torch.sum(normal * pw, dim=-1) + d_off
    # reference quirk: the decay length is √‖p_world‖
    pw_norm = torch.sqrt(torch.clamp(torch.linalg.norm(pw, dim=-1), min=1e-9))
    weight = 1.0 - 0.9 * torch.abs(pd) / pw_norm
    keep = scan_q_mask & nn_ok & plane_ok & (weight > cfg.min_weight)
    return PlaneFactorBatch(pts=scan_q, normals=normal, offsets=d_off,
                            scores=torch.where(keep, weight, 0.0), mask=keep)


def clamp_step(delta, cfg: OdometryConfig):
    """Trust region: per-step clamps of the translation and rotation norms."""
    tn = torch.linalg.norm(delta[:3])
    rn = torch.linalg.norm(delta[3:6])
    scale = torch.clamp(torch.minimum(cfg.max_step_t / torch.clamp(tn, min=1e-12),
                                      cfg.max_step_r / torch.clamp(rn, min=1e-12)),
                        max=1.0)
    return delta * scale


def _fit_and_gn(t, q, scan_q, scan_q_mask, pw, nbrs, d2, cfg: OdometryConfig,
                reduce=None):
    """Plane fits + gates + up to ``gn_iters`` GN steps. ``reduce``: a sum
    over the ranks of a query-sharded round (``parallel/sharded.py``),
    applied to each step's normal equations and to the correspondence
    count; the solve then runs on the same sums on every rank."""
    batch = plane_correspondences(scan_q, scan_q_mask, pw, nbrs, d2, cfg)

    def gn_step(t, q):
        r, J = plane_residual(t, q, batch)
        H, b = block_hessian(J, r, huber_weight(r * r, cfg.huber))
        if reduce is not None:
            H, b = reduce(H), reduce(b)
        delta = clamp_step(solve_normal(H, b, 1e-8), cfg)
        return t + delta[:3], quat_normalize(quat_mul(q, exp_so3(delta[3:6]))), \
            torch.linalg.norm(delta)

    n_steps = cfg.gn_iters
    if cfg.gn_tol > 0.0:
        # host loop: stops where the JAX while_loop stops (one sync per step)
        for n_steps in range(1, cfg.gn_iters + 1):
            t, q, step = gn_step(t, q)
            with host_read("odometry_gn"):
                go_on = bool(step > cfg.gn_tol)
            if not go_on:
                break
    else:
        for _ in range(cfg.gn_iters):
            t, q, _ = gn_step(t, q)
    count("odometry.gn_steps", n_steps)
    n_corr = torch.sum(batch.mask.to(torch.int32)).to(torch.int32)
    return t, q, n_corr if reduce is None else reduce(n_corr)


def _frame_from_scan(scan_q, scan_q_mask, surf_pts, surf_mask, t, q, cfg: OdometryConfig):
    """World-frame ring entry (the query set itself when frame_cap == query_cap)."""
    if cfg.frame_cap == cfg.query_cap:
        return quat_rotate(q[None, :], scan_q) + t[None, :], scan_q_mask
    world = quat_rotate(q[None, :], surf_pts) + t[None, :]
    return voxel_downsample(world, surf_mask, cfg.ds_leaf, cfg.frame_cap)


def _odo_prepare(state: OdometryState, surf_pts, surf_mask, cfg: OdometryConfig):
    """Before the matching rounds: the constant-velocity pose prior, the
    match map from the table and the scan downsampled into queries.
    Returns (t_guess, q_guess, scan_q, scan_q_mask, map_pts, map_mask)."""
    rel_t, rel_q = pose_relative(state.t_prev, state.q_prev, state.t, state.q)
    t_guess = state.t + quat_rotate(state.q, rel_t)
    q_guess = quat_normalize(quat_mul(state.q, rel_q))
    map_pts, map_mask = _map_from_table(state, cfg)
    scan_q, scan_q_mask = voxel_downsample(surf_pts, surf_mask, cfg.ds_leaf, cfg.query_cap)
    return t_guess, q_guess, scan_q, scan_q_mask, map_pts, map_mask


def _odo_finalize(state: OdometryState, scan_q, scan_q_mask, surf_pts, surf_mask,
                  t_guess, q_guess, t, q, n_corr, cfg: OdometryConfig):
    """After the matching rounds: the divergence gate, the keyframe
    decision and the ring-buffer and table update. Returns (new_state,
    OdometryOut)."""
    F = cfg.n_recent_frames
    dtype = scan_q.dtype

    # divergence gate: fall back to the prior when matching collapsed
    diverged = torch.linalg.norm(t - t_guess) > cfg.max_frame_jump
    t = torch.where(diverged, t_guess, t)
    q = unify_quaternion(torch.where(diverged, q_guess, q))

    # keyframe decision
    dis = torch.linalg.norm(t - state.kf_t)
    dq = quat_mul(quat_conj(state.kf_q), q)
    ang = 2.0 * torch.acos(torch.clamp(torch.abs(dq[0]), -1.0, 1.0))
    since = state.frame_id - state.kf_frame
    is_kf = ((((dis > cfg.kf_dist) | (ang > cfg.kf_angle)) & (since > 1))
             | (since > 2) | (state.frame_id <= 1))
    kf_t = torch.where(is_kf, t, state.kf_t)
    kf_q = torch.where(is_kf, q, state.kf_q)
    kf_frame = torch.where(is_kf, state.frame_id, state.kf_frame)

    out_rel_t, out_rel_q = pose_relative(state.t, state.q, t, q)

    ws_ds, wm_ds = _frame_from_scan(scan_q, scan_q_mask, surf_pts, surf_mask, t, q, cfg)
    ws_ds = ws_ds.to(dtype)
    map_cells, map_sums, map_cnt, map_valid = _update_map_table(state, ws_ds, wm_ds, cfg)
    wi = state.write_idx.long()
    frames_pts = state.frames_pts.index_put((wi,), ws_ds)
    frames_mask = state.frames_mask.index_put((wi,), wm_ds)

    new_state = OdometryState(
        frames_pts=frames_pts, frames_mask=frames_mask,
        map_cells=map_cells, map_sums=map_sums, map_cnt=map_cnt, map_valid=map_valid,
        write_idx=(state.write_idx + 1) % F, frame_id=state.frame_id + 1,
        t=t, q=q, t_prev=state.t, q_prev=state.q,
        kf_t=kf_t, kf_q=kf_q, kf_frame=kf_frame,
    )
    out = OdometryOut(t=t, q=q, rel_t=out_rel_t, rel_q=out_rel_q,
                      is_keyframe=is_kf, n_corr=n_corr)
    return new_state, out


def odometry_step(state: OdometryState, surf_pts: torch.Tensor, surf_mask: torch.Tensor,
                  cfg: OdometryConfig = OdometryConfig(), n_rounds: int | None = None,
                  device=None):
    """Process one frame's surf-feature cloud (sensor frame at scan start):
    :func:`_odo_prepare`, ``n_rounds`` matching rounds (default
    ``cfg.scan_match_cnt``), :func:`_odo_finalize`. Runs on ``device``
    (None = the CUDA device). Returns (new_state, OdometryOut)."""
    dev = resolve_device(device)
    surf_pts, surf_mask = surf_pts.to(dev), surf_mask.to(dev)
    t_guess, q_guess, scan_q, scan_q_mask, map_pts, map_mask = _odo_prepare(
        state, surf_pts, surf_mask, cfg)
    if n_rounds is None:
        n_rounds = cfg.scan_match_cnt
    t, q = t_guess, q_guess
    n_corr = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(n_rounds):
        pw, d2, idx = world_knn_auto(t, q, scan_q, map_pts, k=cfg.k,
                                     p_mask=map_mask, q_mask=scan_q_mask)
        t, q, n_corr = _fit_and_gn(t, q, scan_q, scan_q_mask, pw, map_pts[idx], d2, cfg)
    return _odo_finalize(state, scan_q, scan_q_mask, surf_pts, surf_mask, t_guess, q_guess,
                         t, q, n_corr, cfg)
