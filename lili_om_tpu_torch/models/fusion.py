"""Backend sliding-window LiDAR-inertial fusion (port of
``lili_om_tpu/models/fusion.py``: incremental map tables, rebuilt from the
keyframe ring after a loop closure).

Per keyframe: IMU propagation + preintegration; window shift; the keyframe
inserted into the ring buffer; match maps and updated mature tables from one
merge per feature kind; the surf and edge 5-NN searches over the flattened
window (the CUDA kernel on the card); plane and line fits with the
reference's gates; the window problem (marginalization prior, speed-bias
priors, IMU factors, Cauchy-weighted lidar factors) solved by adaptive
Levenberg-Marquardt; guarded write-back; Schur marginalization of the
exiting keyframe.

Two parity rules of the JAX package hold here too: the edge query is built
in the body frame (:func:`_edge_query_world`) while the edge factor takes
the raw sensor points, and the speed-bias priors of the marginalization
problem anchor at the post-solve values.

The ``gn_tol`` early exit is a host loop (one device sync per iteration to
read the step norm), stopping exactly where the JAX ``while_loop`` stops.
One iteration is one body (:func:`_lm_iteration`): on a CUDA device it is
captured once as a CUDA graph per :func:`lm_graph_key` and replayed each
iteration (:class:`_LMGraph`); elsewhere it runs eagerly.

``incremental_map=False`` builds both match maps from the whole ring at
every keyframe instead (:func:`_build_maps`, :func:`default_map_and_match`).
``fusion_step(match_fn=…)`` takes the map build and the searches from the
caller: the map-sharded backend (``parallel/map_fusion.py``) passes one
that searches each rank's share of the ring and merges the candidates.
"""
from __future__ import annotations

import threading
from typing import NamedTuple

import torch

from ..device import const, resolve_device
from ..factors.imu import imu_factor_analytic, retract_state
from ..factors.lidar import (EdgeFactorBatch, PlaneFactorBatch, body_points,
                             cauchy_weight, edge_residual, plane_residual)
from ..factors.prior import MarginalPrior, marginal_prior_residual, speed_bias_prior
from ..ops.fitting import eig3_symmetric, fit_line, fit_plane
from ..ops.knn import knn_auto, knn_pair_auto
from ..ops.marginalization import schur_marginalize
from ..ops.preintegration import (ImuNoise, Preint, init_preint, integrate_parallel,
                                  propagate_world_parallel, sqrt_info)
from ..ops.voxel import merge_voxel_entries, voxel_downsample
from ..solver.gn import solve_normal, solve_normal_lm
from ..utils.math import quat_conj, quat_mul, quat_normalize, quat_rotate, unify_quaternion
from ..utils.metrics import count, host_read, span


class FusionConfig(NamedTuple):
    """Field for field as ``lili_om_tpu.models.fusion.FusionConfig``."""

    window: int = 3
    local_map_width: int = 40
    map_slots_pad: int = 0
    kf_surf_cap: int = 2048
    kf_edge_cap: int = 1024
    map_surf_cap: int = 32768
    map_edge_cap: int = 8192
    surf_leaf: float = 0.4
    edge_leaf: float = 0.2
    imu_cap: int = 256
    k: int = 5
    kd_max_radius: float = 1.0
    edge_nn_gate: float = 1.0
    surf_dist_thres: float = 0.12
    reflect_thres: float = 15.0
    lidar_const: float = 20.0
    cauchy_c: float = 1.0
    max_num_iter: int = 15
    gn_tol: float = 1e-4
    use_reflectivity: bool = True
    weight_gate: float = 0.2
    sb_weights: tuple = (15.0,) * 9
    damping: float = 1e-6
    lm_lam0: float = 1e-4
    lm_up: float = 10.0
    lm_down: float = 0.5
    lm_max: float = 1e2
    plane_fit: str = "centered"
    incremental_map: bool = True
    q_lb: tuple = (1.0, 0.0, 0.0, 0.0)
    t_lb: tuple = (0.0, 0.0, 0.0)


class FusionState(NamedTuple):
    t: torch.Tensor  # (W,3) sliding window
    q: torch.Tensor  # (W,4)
    v: torch.Tensor
    ba: torch.Tensor
    bg: torch.Tensor
    preints: Preint  # stacked (W-1) intervals
    prior: MarginalPrior  # over window[0..W-2]
    sb_anchor_on: torch.Tensor  # () bool
    hist_surf: torch.Tensor  # (M, Sc, 3) keyframe ring, sensor frame
    hist_surf_mask: torch.Tensor
    hist_surf_refl: torch.Tensor
    hist_edge: torch.Tensor  # (M, Ec, 3)
    hist_edge_mask: torch.Tensor
    hist_t: torch.Tensor  # (M, 3)
    hist_q: torch.Tensor  # (M, 4)
    hist_valid: torch.Tensor  # (M,)
    write_idx: torch.Tensor  # () int32
    kf_count: torch.Tensor  # () int32
    msurf_cells: torch.Tensor  # (Ts,3) mature-keyframe surf table
    msurf_sums: torch.Tensor  # (Ts,4)
    msurf_cnt: torch.Tensor
    msurf_valid: torch.Tensor
    medge_cells: torch.Tensor  # (Te,3)
    medge_sums: torch.Tensor
    medge_cnt: torch.Tensor
    medge_valid: torch.Tensor
    acc0: torch.Tensor  # (3,) last consumed IMU sample
    gyr0: torch.Tensor


class FusionOut(NamedTuple):
    t_latest: torch.Tensor
    q_latest: torch.Tensor
    t_mature: torch.Tensor
    q_mature: torch.Tensor
    v_latest: torch.Tensor
    ba_latest: torch.Tensor
    bg_latest: torch.Tensor
    n_surf_corr: torch.Tensor  # () int32
    n_edge_corr: torch.Tensor


def _table_caps(cfg: FusionConfig):
    if not cfg.incremental_map:
        return 1, 1
    return cfg.map_surf_cap + 2 * cfg.kf_surf_cap, cfg.map_edge_cap + 2 * cfg.kf_edge_cap


def _tensor(x, dtype, dev):
    return torch.as_tensor(x, dtype=dtype).to(dev)


def init_fusion_state(cfg: FusionConfig, noise: ImuNoise, t0=None, q0=None, v0=None,
                      dtype=torch.float32, device=None) -> FusionState:
    """Fresh state; ``q0`` seeds the first orientation. Lives on ``device``
    (None = the CUDA device)."""
    dev = resolve_device(device)
    W, M = cfg.window, cfg.local_map_width + cfg.map_slots_pad
    Sc, Ec = cfg.kf_surf_cap, cfg.kf_edge_cap
    z = lambda *s: torch.zeros(s, dtype=dtype, device=dev)
    zb = lambda *s: torch.zeros(s, dtype=torch.bool, device=dev)
    qid = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=dev)
    t0 = z(3) if t0 is None else _tensor(t0, dtype, dev)
    q0 = qid if q0 is None else _tensor(q0, dtype, dev)
    v0 = z(3) if v0 is None else _tensor(v0, dtype, dev)
    pre0 = init_preint(z(3), z(3), noise)
    preints = Preint(*[a.expand((W - 1,) + a.shape).clone() for a in pre0])
    D = 15 * (W - 1)
    prior = MarginalPrior(J=z(D, D), r0=z(D), t0=z(W - 1, 3), q0=qid.repeat(W - 1, 1),
                          v0=z(W - 1, 3), ba0=z(W - 1, 3), bg0=z(W - 1, 3),
                          valid=zb())
    Ts, Te = _table_caps(cfg)
    return FusionState(
        t=t0.repeat(W, 1), q=q0.repeat(W, 1), v=v0.repeat(W, 1),
        ba=z(W, 3), bg=z(W, 3), preints=preints, prior=prior, sb_anchor_on=zb(),
        hist_surf=z(M, Sc, 3), hist_surf_mask=zb(M, Sc), hist_surf_refl=z(M, Sc),
        hist_edge=z(M, Ec, 3), hist_edge_mask=zb(M, Ec),
        hist_t=z(M, 3), hist_q=qid.repeat(M, 1), hist_valid=zb(M),
        write_idx=torch.zeros((), dtype=torch.int32, device=dev),
        kf_count=torch.zeros((), dtype=torch.int32, device=dev),
        msurf_cells=torch.zeros((Ts, 3), dtype=torch.int32, device=dev),
        msurf_sums=z(Ts, 4), msurf_cnt=z(Ts), msurf_valid=zb(Ts),
        medge_cells=torch.zeros((Te, 3), dtype=torch.int32, device=dev),
        medge_sums=z(Te, 3), medge_cnt=z(Te), medge_valid=zb(Te),
        acc0=z(3), gyr0=z(3),
    )


def clamp_accel(accs: torch.Tensor) -> torch.Tensor:
    """Reference accel clamping: ±15 m/s² on x/y, ±18 on z."""
    lim = torch.tensor([15.0, 15.0, 18.0], dtype=accs.dtype, device=accs.device)
    return torch.clamp(accs, -lim, lim)


# ---------------------------------------------------------------------------
# Correspondences (flattened over all window keyframes)
# ---------------------------------------------------------------------------


def surf_fit_and_gate(pts_b, pw, pts_mask, refl, d2, nbrs, nbr_refl,
                      cfg: FusionConfig) -> PlaneFactorBatch:
    """Plane fit + the reference's gates on precomputed k-NN candidates."""
    nn_ok = d2[:, cfg.k - 1] < cfg.kd_max_radius
    if cfg.use_reflectivity:
        dcurv = torch.clamp(torch.abs(refl[:, None] - nbr_refl), min=1e-6)
        sum_w = torch.sum(dcurv, dim=-1)
        vec_w = (1.0 / dcurv) / sum_w[:, None]
        refl_ok = sum_w <= cfg.reflect_thres
    else:
        sum_w = torch.zeros(pts_b.shape[0], dtype=pts_b.dtype, device=pts_b.device)
        vec_w = torch.ones(d2.shape, dtype=pts_b.dtype, device=pts_b.device)
        refl_ok = torch.ones(pts_b.shape[0], dtype=torch.bool, device=pts_b.device)

    if cfg.plane_fit == "centered":
        w2 = vec_w * vec_w
        wsum = torch.clamp(torch.sum(w2, dim=-1, keepdim=True), min=1e-12)
        ctr = torch.einsum("qk,qki->qi", w2, nbrs) / wsum
        dd = nbrs - ctr[:, None, :]
        cov = torch.einsum("qk,qki,qkj->qij", w2, dd, dd)
        _, evecs = eig3_symmetric(cov)
        normal = evecs[..., :, 0]
        d_off = -torch.sum(normal * ctr, dim=-1)
    else:
        fp = fit_plane(nbrs, torch.ones(nbrs.shape[:-1], dtype=torch.bool, device=nbrs.device),
                       dist_thres=cfg.surf_dist_thres, weights=vec_w * vec_w)
        normal, d_off = fp.normal, fp.d
    pd_nbr = torch.abs(torch.einsum("qki,qi->qk", nbrs, normal) + d_off[:, None])
    plane_ok = torch.all(pd_nbr <= cfg.surf_dist_thres, dim=-1)

    pd = torch.sum(normal * pw, dim=-1) + d_off
    pw_norm = torch.sqrt(torch.clamp(torch.linalg.norm(pw, dim=-1), min=1e-9))
    weight = 1.0 - 0.9 * torch.abs(pd) / pw_norm
    keep = pts_mask & nn_ok & refl_ok & plane_ok & (weight > cfg.weight_gate)
    if cfg.use_reflectivity:
        score = cfg.lidar_const * (weight + torch.exp(-sum_w)) * weight
    else:
        score = cfg.lidar_const * weight
    return PlaneFactorBatch(pts=pts_b, normals=normal, offsets=d_off,
                            scores=torch.where(keep, score, 0.0), mask=keep)


def edge_fit_and_gate(pts_b, pts_mask, d2, nbrs, cfg: FusionConfig) -> EdgeFactorBatch:
    """Line fit with the λ₂>3λ₁ gate; virtual points at centroid ± 0.1·dir."""
    nn_ok = d2[:, cfg.k - 1] < cfg.edge_nn_gate
    fl = fit_line(nbrs, torch.ones(nbrs.shape[:-1], dtype=torch.bool, device=nbrs.device),
                  ratio_thres=3.0)
    keep = pts_mask & nn_ok & fl.valid
    return EdgeFactorBatch(pts=pts_b, point_a=fl.centroid + 0.1 * fl.direction,
                           point_b=fl.centroid - 0.1 * fl.direction,
                           scores=torch.where(keep, cfg.lidar_const, 0.0).to(pts_b.dtype),
                           mask=keep)


def _surf_correspondences(pts_b, pw, pts_mask, refl, map_pts, map_mask, map_refl,
                          cfg: FusionConfig) -> PlaneFactorBatch:
    """One 5-NN search of the flattened window's surf points against the
    map (B1 on the card), then :func:`surf_fit_and_gate`. Masked queries
    are not searched (the JAX search takes them and the gate drops them:
    the factors are the same)."""
    d2, idx = knn_auto(pw, map_pts, k=cfg.k, p_mask=map_mask, q_mask=pts_mask)
    return surf_fit_and_gate(pts_b, pw, pts_mask, refl, d2, map_pts[idx], map_refl[idx], cfg)


def _edge_correspondences(pts_b, pw, pts_mask, map_pts, map_mask,
                          cfg: FusionConfig) -> EdgeFactorBatch:
    """The edge counterpart of :func:`_surf_correspondences`."""
    d2, idx = knn_auto(pw, map_pts, k=cfg.k, p_mask=map_mask, q_mask=pts_mask)
    return edge_fit_and_gate(pts_b, pts_mask, d2, map_pts[idx], cfg)


def _extrinsic(cfg: FusionConfig, dtype, dev):
    return (torch.tensor(cfg.t_lb, dtype=dtype, device=dev),
            torch.tensor(cfg.q_lb, dtype=dtype, device=dev))


def _edge_query_world(ts, qs, win_edge_b, cfg: FusionConfig):
    """World-frame edge queries: the extrinsic is applied at the query (the
    reference's composed search pose), not in the factor."""
    t_lb, q_lb = _extrinsic(cfg, win_edge_b.dtype, win_edge_b.device)
    eb = body_points(win_edge_b, t_lb, q_lb)
    return quat_rotate(qs[:, None, :], eb) + ts[:, None, :]


def _rebuilt_tables(state: FusionState, clouds, masks, refl, leaf, Tcap, prevwin, M):
    """The ``rebuild`` merge: every ring keyframe at its current ring pose.
    The match map is the whole ring; the table is the next step's mature
    set, every slot but the post-insert window {wi−W+1..wi}."""
    dev = state.t.device
    pts = (quat_rotate(state.hist_q[:, None, :], clouds)
           + state.hist_t[:, None, :]).reshape(-1, 3)
    msk = (masks & state.hist_valid[:, None]).reshape(-1)
    nextwin = (prevwin + 1) % M
    in_next = torch.any(torch.arange(masks.shape[0], device=dev)[:, None]
                        == nextwin[None, :], dim=1)
    sel_table = (~in_next)[:, None].expand(masks.shape).reshape(-1)
    sums = pts if refl is None else torch.cat([pts, refl.reshape(-1, 1)], dim=1)
    return merge_voxel_entries(torch.floor(pts / leaf).to(torch.int32),
                               sums * msk[:, None].to(pts.dtype), msk.to(pts.dtype), msk,
                               Tcap, second_sel=sel_table)


def _incremental_maps(state: FusionState, cfg: FusionConfig, rebuild: bool = False):
    """Match maps + updated mature tables from one merge per feature kind,
    on the pre-insert state: match map = table ∪ the W previous-window
    keyframes at their ring poses; table' = table + slot (wi−W) − the old
    content of slot wi. ``rebuild``: both from the whole ring instead (a
    loop closure moved the mature poses, see :func:`_rebuilt_tables`)."""
    M, W = cfg.local_map_width, cfg.window
    dtype, dev = state.t.dtype, state.t.device
    wi = state.write_idx.long()
    Ts, Te = _table_caps(cfg)
    prevwin = (wi - W + torch.arange(W, device=dev)) % M
    t_lb, q_lb = _extrinsic(cfg, dtype, dev)

    def world(slots, clouds):
        return quat_rotate(state.hist_q[slots][:, None, :], clouds[slots]) \
            + state.hist_t[slots][:, None, :]

    def build(clouds, masks, refl, table, leaf, Tcap, map_cap):
        clouds = body_points(clouds, t_lb, q_lb)
        if rebuild:
            return finish(*_rebuilt_tables(state, clouds, masks, refl, leaf, Tcap, prevwin,
                                           M), refl, map_cap)
        S1 = clouds.shape[1]
        K = W * S1
        live = world(prevwin, clouds).reshape(K, 3)
        live_mask = (masks[prevwin] & state.hist_valid[prevwin, None]).reshape(-1)
        ev = world(wi[None], clouds).reshape(S1, 3)
        ev_mask = masks[wi] & state.hist_valid[wi]
        if refl is None:
            live_sums, ev_sums = live, ev
        else:
            live_sums = torch.cat([live, refl[prevwin].reshape(-1, 1)], dim=1)
            ev_sums = torch.cat([ev, refl[wi].reshape(-1, 1)], dim=1)
        cells = torch.cat([table[0], torch.floor(live / leaf).to(torch.int32),
                           torch.floor(ev / leaf).to(torch.int32)])
        sums = torch.cat([table[1], live_sums * live_mask[:, None].to(dtype),
                          -(ev_sums * ev_mask[:, None].to(dtype))])
        cnt = torch.cat([table[2], live_mask.to(dtype), -ev_mask.to(dtype)])
        valid = torch.cat([table[3], live_mask, ev_mask])
        ones = lambda n: torch.ones((n,), dtype=torch.bool, device=dev)
        zeros = lambda n: torch.zeros((n,), dtype=torch.bool, device=dev)
        live_rows = torch.arange(K, device=dev) < S1  # prevwin[0]: the maturing slot
        sel_match = torch.cat([ones(Tcap), ones(K), zeros(S1)])
        sel_table = torch.cat([ones(Tcap), live_rows, ones(S1)])
        return finish(*merge_voxel_entries(cells, sums, cnt, valid, Tcap,
                                           primary_sel=sel_match, second_sel=sel_table),
                      refl, map_cap)

    def finish(match, table, refl, map_cap):
        (mc, ms, mn, mv), (tc, tsum, tn, tv) = match, table
        den = torch.clamp(mn, min=1.0)[:, None]
        map_pts = (ms[:, :3] / den)[:map_cap].to(dtype)
        map_mask = mv[:map_cap]
        map_refl = (ms[:, 3] / den[:, 0])[:map_cap].to(dtype) if refl is not None else None
        return map_pts, map_refl, map_mask, (tc, tsum.to(dtype), tn.to(dtype), tv)

    map_surf, map_refl, map_surf_mask, surf_table = build(
        state.hist_surf, state.hist_surf_mask, state.hist_surf_refl,
        (state.msurf_cells, state.msurf_sums, state.msurf_cnt, state.msurf_valid),
        cfg.surf_leaf, Ts, cfg.map_surf_cap)
    map_edge, _, map_edge_mask, edge_table = build(
        state.hist_edge, state.hist_edge_mask, None,
        (state.medge_cells, state.medge_sums, state.medge_cnt, state.medge_valid),
        cfg.edge_leaf, Te, cfg.map_edge_cap)
    enough_map = (torch.sum(map_surf_mask.to(torch.int32)) > 50) & \
        (torch.sum(map_edge_mask.to(torch.int32)) > 0)
    return (map_surf, map_refl, map_surf_mask, map_edge, map_edge_mask,
            enough_map, surf_table, edge_table)


def _build_maps(state: FusionState, cfg: FusionConfig, block: slice = slice(None),
                surf_cap: int | None = None, edge_cap: int | None = None):
    """Match maps from the ring slots ``block`` (all physical slots by
    default): each keyframe's sensor-frame clouds through the lidar→body
    extrinsic and its ring pose, voxel-downsampled to ``surf_cap`` /
    ``edge_cap`` centroids (the config's map caps by default).

    Returns (map_surf, map_refl, surf_mask, map_edge, edge_mask, enough_map)."""
    dtype, dev = state.t.dtype, state.t.device
    t_lb, q_lb = _extrinsic(cfg, dtype, dev)
    hq, ht, hvalid = state.hist_q[block], state.hist_t[block], state.hist_valid[block]

    def world(clouds, masks):
        pts = quat_rotate(hq[:, None, :], body_points(clouds[block], t_lb, q_lb)) \
            + ht[:, None, :]
        return pts.reshape(-1, 3), (masks[block] & hvalid[:, None]).reshape(-1)

    map_surf, map_refl, surf_mask = voxel_downsample(
        *world(state.hist_surf, state.hist_surf_mask), cfg.surf_leaf,
        surf_cap or cfg.map_surf_cap, feats=state.hist_surf_refl[block].reshape(-1, 1))
    map_edge, edge_mask = voxel_downsample(
        *world(state.hist_edge, state.hist_edge_mask), cfg.edge_leaf,
        edge_cap or cfg.map_edge_cap)
    enough_map = (torch.sum(surf_mask.to(torch.int32)) > 50) & \
        (torch.sum(edge_mask.to(torch.int32)) > 0)
    return map_surf, map_refl[:, 0], surf_mask, map_edge, edge_mask, enough_map


def window_queries(ts, qs, win_surf_b, win_edge_b, cfg: FusionConfig):
    """World-frame surf and edge queries of the flattened window:
    (W·Sc, 3) and (W·Ec, 3)."""
    pw_surf = (quat_rotate(qs[:, None, :], win_surf_b) + ts[:, None, :]).reshape(-1, 3)
    return pw_surf, _edge_query_world(ts, qs, win_edge_b, cfg).reshape(-1, 3)


def window_batches(sb_flat: PlaneFactorBatch, eb_flat: EdgeFactorBatch, cfg: FusionConfig):
    """Flattened-window factor batches back to (W, S, ·)."""
    W, Sc, Ec = cfg.window, cfg.kf_surf_cap, cfg.kf_edge_cap
    return (PlaneFactorBatch(*[a.reshape((W, Sc) + a.shape[1:]) for a in sb_flat]),
            EdgeFactorBatch(*[a.reshape((W, Ec) + a.shape[1:]) for a in eb_flat]))


def default_map_and_match(state: FusionState, ts, qs, win_surf_b, win_surf_mask,
                          win_surf_refl, win_edge_b, win_edge_mask, cfg: FusionConfig):
    """The map build and searches of ``incremental_map=False``: both maps
    from the whole pre-insert ring (:func:`_build_maps`), then one surf and
    one edge search of the flattened window. The signature is the
    ``match_fn`` one of :func:`fusion_step`.

    Returns (surf_batches, edge_batches, enough_map)."""
    map_surf, map_refl, surf_mask, map_edge, edge_mask, enough_map = _build_maps(state, cfg)
    pw_surf, pw_edge = window_queries(ts, qs, win_surf_b, win_edge_b, cfg)
    sb_flat = _surf_correspondences(win_surf_b.reshape(-1, 3), pw_surf,
                                    win_surf_mask.reshape(-1), win_surf_refl.reshape(-1),
                                    map_surf, surf_mask, map_refl, cfg)
    eb_flat = _edge_correspondences(win_edge_b.reshape(-1, 3), pw_edge,
                                    win_edge_mask.reshape(-1), map_edge, edge_mask, cfg)
    return window_batches(sb_flat, eb_flat, cfg) + (enough_map,)


# ---------------------------------------------------------------------------
# Window problem assembly
# ---------------------------------------------------------------------------


def _assemble(ts, qs, vs, bas, bgs, preints, preint_Ws, prior, sb_on, sb_anchor,
              surf_batches, edge_batches, noise, cfg: FusionConfig,
              imu_first_only: bool = False):
    """(H, g) of the full-window GN system (D = 15·W), g = +ΣJᵀr.
    ``imu_first_only``: only the 0→1 IMU factor (the marginalization problem)."""
    W = cfg.window
    D = 15 * W
    dtype, dev = ts.dtype, ts.device
    H = torch.zeros((D, D), dtype=dtype, device=dev)
    g = torch.zeros((D,), dtype=dtype, device=dev)

    rp, Jp = marginal_prior_residual(prior, ts[:-1], qs[:-1], vs[:-1], bas[:-1], bgs[:-1])
    Dp = 15 * (W - 1)
    H[:Dp, :Dp] += Jp.T @ Jp
    g[:Dp] += Jp.T @ rp

    v0a, ba0a, bg0a = sb_anchor
    on = sb_on.to(dtype)
    sbw = const(tuple(cfg.sb_weights), dtype, dev)
    for i in range(W - 1):
        rsb, Jsb = speed_bias_prior(vs[i], bas[i], bgs[i], v0a[i], ba0a[i], bg0a[i],
                                    weights=sbw)
        o = 15 * i + 6
        H[o:o + 9, o:o + 9] += on * (Jsb.T @ Jsb)
        g[o:o + 9] += on * (Jsb.T @ rsb)

    for i in range(1 if imu_first_only else W - 1):
        pre_i = Preint(*[a[i] for a in preints])
        r, Ji, Jj = imu_factor_analytic(pre_i, noise, ts[i], qs[i], vs[i], bas[i], bgs[i],
                                        ts[i + 1], qs[i + 1], vs[i + 1], bas[i + 1],
                                        bgs[i + 1], W=preint_Ws[i])
        oi, oj = 15 * i, 15 * (i + 1)
        H[oi:oi + 15, oi:oi + 15] += Ji.T @ Ji
        H[oj:oj + 15, oj:oj + 15] += Jj.T @ Jj
        H[oi:oi + 15, oj:oj + 15] += Ji.T @ Jj
        H[oj:oj + 15, oi:oi + 15] += Jj.T @ Ji
        g[oi:oi + 15] += Ji.T @ r
        g[oj:oj + 15] += Jj.T @ r

    # lidar factors per window keyframe, Cauchy IRLS
    for j in range(W):
        o = 15 * j
        for residual, batches in ((plane_residual, surf_batches),
                                  (edge_residual, edge_batches)):
            r, J = residual(ts[j], qs[j], type(batches)(*[a[j] for a in batches]))
            w = cauchy_weight(r * r, cfg.cauchy_c)
            Jw = J * w[:, None]
            H[o:o + 6, o:o + 6] += Jw.T @ Jw
            g[o:o + 6] += Jw.T @ (r * w)
    return H, g


def _retract_window(ts, qs, vs, bas, bgs, delta):
    return retract_state(ts, qs, vs, bas, bgs, delta.reshape(ts.shape[0], 15))


# ---------------------------------------------------------------------------
# The LM loop: one iteration body, run eagerly or replayed as a CUDA graph
# ---------------------------------------------------------------------------


class LMInputs(NamedTuple):
    """What an LM iteration reads besides the window states: fixed over one
    keyframe's loop."""

    preints: Preint
    preint_Ws: torch.Tensor  # (W-1,15,15) sqrt_info(preints)
    prior: MarginalPrior
    sb_on: torch.Tensor
    sb_anchor: tuple  # (v, ba, bg) of window[0..W-2], pre-solve
    surf: PlaneFactorBatch
    edge: EdgeFactorBatch


def _leaves(tree) -> list:
    """The tensors of a nest of tuples, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for x in tree for leaf in _leaves(x)]


def _clone_tree(tree):
    """A copy of a nest of tuples with every tensor cloned."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    vals = [_clone_tree(x) for x in tree]
    return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)


def _lm_iteration(cur, lam, prev_step, fixed: LMInputs, noise: ImuNoise, cfg: FusionConfig,
                  adaptive: bool):
    """One LM iteration: assemble, solve, λ update, retract. Adaptive: the
    Marquardt-damped solve, λ ×lm_up when the step norm grew, ×lm_down
    otherwise; else the ``damping`` solve. Returns (window states, λ, step
    norm)."""
    H, g = _assemble(*cur, fixed.preints, fixed.preint_Ws, fixed.prior, fixed.sb_on,
                     fixed.sb_anchor, fixed.surf, fixed.edge, noise, cfg)
    delta = solve_normal_lm(H, -g, lam) if adaptive else solve_normal(H, -g, cfg.damping)
    step = torch.linalg.norm(delta)
    lam = torch.clamp(torch.where(step > prev_step, lam * cfg.lm_up, lam * cfg.lm_down),
                      1e-8, cfg.lm_max)
    return _retract_window(*cur, delta), lam, step


def _lm_converged(step: torch.Tensor, cfg: FusionConfig) -> bool:
    with host_read("fusion_lm"):
        return not bool(step > cfg.gn_tol)


def _use_graph(dev: torch.device) -> bool:
    """Whether the LM loop replays a captured graph: on a CUDA device."""
    return dev.type == "cuda"


def _lm_solve(cur, fixed: LMInputs, noise: ImuNoise, cfg: FusionConfig):
    """The window's LM loop from the states ``cur``: up to ``max_num_iter``
    iterations; with ``gn_tol`` > 0 one host read an iteration, stopping
    once the step norm is ≤ ``gn_tol``. Returns (states, iterations run)."""
    adaptive = cfg.gn_tol > 0.0 and cfg.lm_lam0 > 0.0
    if _use_graph(cur[0].device):
        return _LMGraph.get(cur, fixed, noise, cfg, adaptive).solve(cur, fixed, cfg)
    dtype, dev = cur[0].dtype, cur[0].device
    lam = torch.full((), cfg.lm_lam0, dtype=dtype, device=dev)
    step = torch.full((), float("inf"), dtype=dtype, device=dev)
    n_iter = 0
    for n_iter in range(1, cfg.max_num_iter + 1):
        cur, lam, step = _lm_iteration(cur, lam, step, fixed, noise, cfg, adaptive)
        if cfg.gn_tol > 0.0 and _lm_converged(step, cfg):
            break
    return cur, n_iter


def lm_graph_key(cur, fixed: LMInputs, noise: ImuNoise, cfg: FusionConfig,
                 adaptive: bool) -> tuple:
    """Everything a captured LM iteration bakes in: the device, the shape
    and dtype of every input (so W and the keyframe caps), the kind of
    solve, and the floats of ``cfg`` and ``noise`` that reach its kernels
    as scalars or as constant tensors. ``lm_lam0`` and the step norm are
    filled into buffers at each loop's start; ``gn_tol`` and
    ``max_num_iter`` act on the host."""
    leaves = _leaves((cur, fixed))
    return (leaves[0].device, tuple((x.shape, x.dtype) for x in leaves), adaptive,
            cfg.cauchy_c, tuple(cfg.sb_weights), cfg.damping, cfg.lm_up, cfg.lm_down,
            cfg.lm_max, noise.g_norm)


_LM_GRAPHS: dict = {}  # lm_graph_key -> _LMGraph
_LM_GRAPHS_LOCK = threading.Lock()


class _LMGraph:
    """One LM iteration captured as a CUDA graph over static buffers. The
    window states, λ and the step norm are read and written back in place,
    so one replay feeds the next; the fixed inputs are copied in once a
    keyframe. The lock keeps two systems' copy-in, replays and copy-out
    from interleaving on the host, and an event orders them on the card
    when the callers' streams differ."""

    @classmethod
    def get(cls, cur, fixed, noise, cfg, adaptive) -> "_LMGraph":
        key = lm_graph_key(cur, fixed, noise, cfg, adaptive)
        with _LM_GRAPHS_LOCK:
            graph = _LM_GRAPHS.get(key)
            if graph is None:
                graph = _LM_GRAPHS[key] = cls(cur, fixed, noise, cfg, adaptive)
                count("fusion.lm_captures", 1)
        return graph

    def __init__(self, cur, fixed, noise, cfg, adaptive):
        dtype, self.dev = cur[0].dtype, cur[0].device
        self.lock = threading.Lock()
        self.cur = tuple(x.clone() for x in cur)
        self.fixed = _clone_tree(fixed)
        self.lam = torch.full((), cfg.lm_lam0, dtype=dtype, device=self.dev)
        self.step = torch.full((), float("inf"), dtype=dtype, device=self.dev)
        self.inputs = _leaves((self.cur, self.fixed))
        self.done = torch.cuda.Event()  # the last loop's copy-out

        def body():
            new = _lm_iteration(self.cur, self.lam, self.step, self.fixed, noise, cfg, adaptive)
            for buf, x in zip(self.cur + (self.lam, self.step), new[0] + new[1:]):
                buf.copy_(x)

        # warm up on a side stream (lazy handles and workspaces), then capture
        # there; this thread's capture ignores other threads' CUDA calls
        with torch.cuda.device(self.dev):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(3):
                    body()
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, stream=side, capture_error_mode="thread_local"):
                body()

    def solve(self, cur, fixed, cfg):
        """:func:`_lm_solve` by replays; the states are cloned out of the
        buffers, which the next keyframe overwrites."""
        with self.lock, torch.cuda.device(self.dev):
            stream = torch.cuda.current_stream()
            stream.wait_event(self.done)
            for buf, x in zip(self.inputs, _leaves((cur, fixed))):
                buf.copy_(x)
            self.lam.fill_(cfg.lm_lam0)
            self.step.fill_(float("inf"))
            n_iter = 0
            for n_iter in range(1, cfg.max_num_iter + 1):
                self.graph.replay()
                if cfg.gn_tol > 0.0 and _lm_converged(self.step, cfg):
                    break
            out = tuple(x.clone() for x in self.cur)
            self.done.record(stream)
        count("fusion.lm_replays", n_iter)
        return out, n_iter


# ---------------------------------------------------------------------------
# The per-keyframe step
# ---------------------------------------------------------------------------


class FusionMid(NamedTuple):
    """Intermediates between the ingest phase and the solve phase."""

    ts: torch.Tensor
    qs: torch.Tensor
    vs: torch.Tensor
    bas: torch.Tensor
    bgs: torch.Tensor
    preints: Preint
    hist_surf: torch.Tensor
    hist_surf_mask: torch.Tensor
    hist_surf_refl: torch.Tensor
    hist_edge: torch.Tensor
    hist_edge_mask: torch.Tensor
    hist_valid: torch.Tensor
    win_surf_b: torch.Tensor
    win_surf_mask: torch.Tensor
    win_surf_refl: torch.Tensor
    win_edge_b: torch.Tensor
    win_edge_mask: torch.Tensor
    map_surf: torch.Tensor
    map_refl: torch.Tensor
    map_surf_mask: torch.Tensor
    map_edge: torch.Tensor
    map_edge_mask: torch.Tensor
    enough_map: torch.Tensor
    surf_table: tuple
    edge_table: tuple
    acc0: torch.Tensor
    gyr0: torch.Tensor


def _set_row(x: torch.Tensor, i: torch.Tensor, value) -> torch.Tensor:
    """Out-of-place ``x[i] = value`` (the carried states stay immutable)."""
    x = x.clone()
    x[i] = value
    return x


@span("fusion.ingest")
def _ingest(state: FusionState, surf_pts, surf_mask, surf_refl, edge_pts, edge_mask,
            imu_dts, imu_accs, imu_gyrs, imu_valid, cfg: FusionConfig,
            noise: ImuNoise, rebuild: bool = False) -> FusionMid:
    """IMU propagate/preintegrate, window shift, ring insert, window gather."""
    W, M = cfg.window, cfg.local_map_width
    dtype, dev = state.t.dtype, state.t.device
    t_lb, q_lb = _extrinsic(cfg, dtype, dev)

    if cfg.incremental_map:
        (map_surf, map_refl, map_surf_mask, map_edge, map_edge_mask,
         enough_map, surf_table, edge_table) = _incremental_maps(state, cfg, rebuild)
    else:
        # the maps are built at match time (match_fn / default_map_and_match);
        # placeholders here, and the (1,·) tables carried untouched
        map_surf = map_edge = torch.zeros((1, 3), dtype=dtype, device=dev)
        map_refl = torch.zeros((1,), dtype=dtype, device=dev)
        map_surf_mask = map_edge_mask = torch.zeros((1,), dtype=torch.bool, device=dev)
        enough_map = torch.zeros((), dtype=torch.bool, device=dev)
        surf_table = (state.msurf_cells, state.msurf_sums, state.msurf_cnt, state.msurf_valid)
        edge_table = (state.medge_cells, state.medge_sums, state.medge_cnt, state.medge_valid)

    accs = clamp_accel(imu_accs)
    t_new, q_new, v_new, acc0, gyr0 = propagate_world_parallel(
        state.t[-1], state.q[-1], state.v[-1], state.ba[-1], state.bg[-1],
        noise, state.acc0, state.gyr0, imu_dts, accs, imu_gyrs, imu_valid)
    pre_new = integrate_parallel(noise, state.ba[-1], state.bg[-1], state.acc0,
                                 state.gyr0, imu_dts, accs, imu_gyrs, imu_valid)
    first = state.kf_count == 0  # first keyframe: no previous interval
    t_new = torch.where(first, state.t[-1], t_new)
    q_new = torch.where(first, state.q[-1], q_new)
    v_new = torch.where(first, state.v[-1], v_new)

    def shift(a, new):
        return torch.cat([a[1:], new[None]], dim=0)

    ts, qs, vs = shift(state.t, t_new), shift(state.q, q_new), shift(state.v, v_new)
    bas, bgs = shift(state.ba, state.ba[-1]), shift(state.bg, state.bg[-1])
    preints = Preint(*[shift(a, n) for a, n in zip(state.preints, pre_new)])

    # insert the incoming keyframe, downsampled in the sensor frame
    wi = state.write_idx.long()
    sp_ds, refl_ds, sm_ds = voxel_downsample(surf_pts, surf_mask, cfg.surf_leaf,
                                             cfg.kf_surf_cap, feats=surf_refl[:, None])
    ep_ds, em_ds = voxel_downsample(edge_pts, edge_mask, cfg.edge_leaf, cfg.kf_edge_cap)
    hist_surf = _set_row(state.hist_surf, wi, sp_ds)
    hist_surf_mask = _set_row(state.hist_surf_mask, wi, sm_ds)
    hist_surf_refl = _set_row(state.hist_surf_refl, wi, refl_ds[:, 0])
    hist_edge = _set_row(state.hist_edge, wi, ep_ds)
    hist_edge_mask = _set_row(state.hist_edge_mask, wi, em_ds)
    hist_valid = _set_row(state.hist_valid, wi, True)

    # window keyframe j sits at slot (wi − (W−1) + j) mod M, post-insert
    slots = (wi - (W - 1) + torch.arange(W, device=dev)) % M
    # surf points carry the lidar→body extrinsic into their factor; edge
    # points stay raw (the edge factor ignores its extrinsic)
    win_surf_b = body_points(hist_surf[slots], t_lb, q_lb)
    return FusionMid(
        ts=ts, qs=qs, vs=vs, bas=bas, bgs=bgs, preints=preints,
        hist_surf=hist_surf, hist_surf_mask=hist_surf_mask, hist_surf_refl=hist_surf_refl,
        hist_edge=hist_edge, hist_edge_mask=hist_edge_mask, hist_valid=hist_valid,
        win_surf_b=win_surf_b, win_surf_mask=hist_surf_mask[slots],
        win_surf_refl=hist_surf_refl[slots],
        win_edge_b=hist_edge[slots], win_edge_mask=hist_edge_mask[slots],
        map_surf=map_surf, map_refl=map_refl, map_surf_mask=map_surf_mask,
        map_edge=map_edge, map_edge_mask=map_edge_mask, enough_map=enough_map,
        surf_table=surf_table, edge_table=edge_table, acc0=acc0, gyr0=gyr0,
    )


def _zero_batches(mid: FusionMid, dtype):
    """Empty correspondence batches for the warmup (unfilled-window) path."""
    sb, eb = mid.win_surf_b, mid.win_edge_b
    z2 = lambda x: torch.zeros(x.shape[:2], dtype=dtype, device=x.device)
    zb = lambda x: torch.zeros(x.shape[:2], dtype=torch.bool, device=x.device)
    return (PlaneFactorBatch(pts=sb, normals=torch.zeros_like(sb), offsets=z2(sb),
                             scores=z2(sb), mask=zb(sb)),
            EdgeFactorBatch(pts=eb, point_a=torch.zeros_like(eb),
                            point_b=torch.zeros_like(eb), scores=z2(eb), mask=zb(eb)))


def match_rows(mid: FusionMid, cfg: FusionConfig, surf_rows: slice = slice(None),
               edge_rows: slice = slice(None)):
    """The match of one block of the flattened window's query rows against
    the maps in ``mid``: surf rows ``surf_rows`` of the (W·Sc) and edge rows
    ``edge_rows`` of the (W·Ec), searched (B1 on the card) and fitted. Each
    query's answer depends on that query alone, so the blocks of a split,
    concatenated in row order, equal the whole window's rows. Returns the
    block's flat (PlaneFactorBatch, EdgeFactorBatch)."""
    pw_surf, pw_edge = window_queries(mid.ts, mid.qs, mid.win_surf_b, mid.win_edge_b, cfg)
    pw_surf, pw_edge = pw_surf[surf_rows], pw_edge[edge_rows]
    surf_qm = mid.win_surf_mask.reshape(-1)[surf_rows]
    edge_qm = mid.win_edge_mask.reshape(-1)[edge_rows]
    d2s, idxs, d2e, idxe = knn_pair_auto(
        pw_surf, mid.map_surf, mid.map_surf_mask, pw_edge, mid.map_edge,
        mid.map_edge_mask, k=cfg.k, qm1=surf_qm, qm2=edge_qm)
    sb_flat = surf_fit_and_gate(mid.win_surf_b.reshape(-1, 3)[surf_rows], pw_surf, surf_qm,
                                mid.win_surf_refl.reshape(-1)[surf_rows], d2s,
                                mid.map_surf[idxs], mid.map_refl[idxs], cfg)
    eb_flat = edge_fit_and_gate(mid.win_edge_b.reshape(-1, 3)[edge_rows], edge_qm, d2e,
                                mid.map_edge[idxe], cfg)
    return sb_flat, eb_flat


def _match_with_maps(mid: FusionMid, cfg: FusionConfig):
    """Flattened-window surf + edge searches against the incremental maps."""
    return window_batches(*match_rows(mid, cfg), cfg) + (mid.enough_map,)


def gate_batches(surf_batches: PlaneFactorBatch, edge_batches: EdgeFactorBatch,
                 enough_map: torch.Tensor, dtype):
    """No lidar factors while the map is too sparse: every mask and score
    of both batches gated by ``enough_map``."""
    return (surf_batches._replace(mask=surf_batches.mask & enough_map,
                                  scores=surf_batches.scores * enough_map.to(dtype)),
            edge_batches._replace(mask=edge_batches.mask & enough_map,
                                  scores=edge_batches.scores * enough_map.to(dtype)))


def _finish(state: FusionState, mid: FusionMid, surf_batches, edge_batches,
            cfg: FusionConfig, noise: ImuNoise, warmup: bool):
    """Window solve, guarded write-back, marginalization, ring pose write-back."""
    W, M = cfg.window, cfg.local_map_width
    dev = mid.ts.device
    ts, qs, vs, bas, bgs = mid.ts, mid.qs, mid.vs, mid.bas, mid.bgs
    preints = mid.preints
    wi = state.write_idx.long()
    slots = (wi - (W - 1) + torch.arange(W, device=dev)) % M

    preint_Ws = sqrt_info(preints)  # hoisted: depends on the covariances only
    fixed = LMInputs(preints, preint_Ws, state.prior, state.sb_anchor_on,
                     (vs[:-1], bas[:-1], bgs[:-1]),  # pre-solve anchors
                     surf_batches, edge_batches)

    cur = (ts, qs, vs, bas, bgs)
    if not warmup:
        with span("fusion.solve"):
            cur, n_iter = _lm_solve(cur, fixed, noise, cfg)
        count("fusion.lm_iters", n_iter)
    ts1, qs1, vs1, bas1, bgs1 = cur
    qs1 = unify_quaternion(qs1)

    # guarded write-back
    def gate(new, old, thresh, per_component=False):
        if per_component:
            ok = torch.abs(new - old) < thresh
        else:
            ok = (torch.linalg.norm(new - old, dim=-1) < thresh)[..., None]
        return torch.where(ok, new, old)

    ts1 = gate(ts1, ts, 10.0)
    vs1 = gate(vs1, vs, 10.0)
    bas1 = gate(bas1, bas, 22.0, per_component=True)
    bgs1 = gate(bgs1, bgs, 22.0, per_component=True)
    dq_vec = torch.linalg.norm(quat_mul(quat_conj(qs1), qs)[..., 1:], dim=-1)
    qs1 = quat_normalize(torch.where((dq_vec < 10.0)[:, None], qs1, qs))

    # marginalize the exiting keyframe into the new prior; the speed-bias
    # priors anchor at the post-solve values
    if warmup:
        prior, sb_anchor_on = state.prior, state.sb_anchor_on
    else:
        H, g = _assemble(ts1, qs1, vs1, bas1, bgs1, preints, preint_Ws, state.prior,
                         state.sb_anchor_on, (vs1[:-1], bas1[:-1], bgs1[:-1]),
                         surf_batches, edge_batches, noise, cfg, imu_first_only=True)
        J, r0 = schur_marginalize(H, g, 15)
        prior = MarginalPrior(J=J, r0=r0, t0=ts1[1:], q0=qs1[1:], v0=vs1[1:],
                              ba0=bas1[1:], bg0=bgs1[1:],
                              valid=torch.ones((), dtype=torch.bool, device=dev))
        sb_anchor_on = torch.zeros((), dtype=torch.bool, device=dev)

    hist_t = state.hist_t.clone()
    hist_t[slots] = ts1
    hist_q = state.hist_q.clone()
    hist_q[slots] = qs1

    new_state = FusionState(
        t=ts1, q=qs1, v=vs1, ba=bas1, bg=bgs1,
        preints=preints, prior=prior, sb_anchor_on=sb_anchor_on,
        hist_surf=mid.hist_surf, hist_surf_mask=mid.hist_surf_mask,
        hist_surf_refl=mid.hist_surf_refl,
        hist_edge=mid.hist_edge, hist_edge_mask=mid.hist_edge_mask,
        hist_t=hist_t, hist_q=hist_q, hist_valid=mid.hist_valid,
        write_idx=(state.write_idx + 1) % M, kf_count=state.kf_count + 1,
        msurf_cells=mid.surf_table[0], msurf_sums=mid.surf_table[1],
        msurf_cnt=mid.surf_table[2], msurf_valid=mid.surf_table[3],
        medge_cells=mid.edge_table[0], medge_sums=mid.edge_table[1],
        medge_cnt=mid.edge_table[2], medge_valid=mid.edge_table[3],
        acc0=mid.acc0, gyr0=mid.gyr0,
    )
    out = FusionOut(
        t_latest=ts1[-1], q_latest=qs1[-1], t_mature=ts1[0], q_mature=qs1[0],
        v_latest=vs1[-1], ba_latest=bas1[-1], bg_latest=bgs1[-1],
        n_surf_corr=torch.sum(surf_batches.mask.to(torch.int32)).to(torch.int32),
        n_edge_corr=torch.sum(edge_batches.mask.to(torch.int32)).to(torch.int32),
    )
    return new_state, out


def fusion_step(state: FusionState, surf_pts, surf_mask, surf_refl, edge_pts, edge_mask,
                imu_dts, imu_accs, imu_gyrs, imu_valid,
                cfg: FusionConfig = FusionConfig(), noise: ImuNoise = ImuNoise(),
                warmup: bool = False, match_fn=None, rebuild: bool = False, device=None):
    """Ingest one keyframe (see the module docstring). ``warmup``: the
    window is not full yet — no correspondence search and no solve.
    ``match_fn``: the map build and correspondence phase, called as
    :func:`default_map_and_match` is on the pre-insert state; by default
    the incremental maps, or :func:`default_map_and_match` under
    ``incremental_map=False``. ``rebuild``: rebuild the mature map tables
    from the whole ring (the first keyframe after a loop closure moved the
    ring poses). Runs on ``device`` (None = the CUDA device). Returns
    (new_state, FusionOut)."""
    dev = resolve_device(device)
    args = [a.to(dev) for a in (surf_pts, surf_mask, surf_refl, edge_pts, edge_mask,
                                imu_dts, imu_accs, imu_gyrs, imu_valid)]
    dtype = state.t.dtype
    mid = _ingest(state, *args, cfg, noise, rebuild)
    if warmup:
        surf_batches, edge_batches = _zero_batches(mid, dtype)
    else:
        with span("fusion.match"):
            # the map comes from the pre-insert ring (the reference's local
            # map leaves out the incoming keyframe)
            if match_fn is None and cfg.incremental_map:
                surf_batches, edge_batches, enough_map = _match_with_maps(mid, cfg)
            else:
                surf_batches, edge_batches, enough_map = (match_fn or default_map_and_match)(
                    state, mid.ts, mid.qs, mid.win_surf_b, mid.win_surf_mask,
                    mid.win_surf_refl, mid.win_edge_b, mid.win_edge_mask, cfg)
            surf_batches, edge_batches = gate_batches(surf_batches, edge_batches, enough_map,
                                                      dtype)
    return _finish(state, mid, surf_batches, edge_batches, cfg, noise, warmup)
