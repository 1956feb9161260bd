"""Hierarchical local pose graph: densifies the non-keyframe poses inside a
keyframe interval (port of ``lili_om_tpu/models/local_graph.py``).

* intermediate frame poses come from midpoint IMU propagation from the older
  keyframe's optimized state, with zero biases;
* the chain factors measure the relative poses between those propagated
  intermediates;
* the chain is anchored at both ends to the two bounding (optimized)
  keyframe poses, so the keyframe corrections spread over the interval while
  the propagated relative shape is kept.

The propagation is the parallel form of ``ops/preintegration.py``
(quaternion prefix products and cumulative sums) with every step's pose
kept; the JAX package scans it step by step, which rounds differently in the
last bits. The chain solve is Gauss-Newton on the 6·F tangent with the
factors batched.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.preintegration import ImuNoise, _quat_prefix
from ..solver.gn import solve_normal
from ..utils.math import exp_so3, pose_relative, quat_mul, quat_normalize, quat_rotate
from .pose_graph import _between_block, _retract, _row


class DensifiedInterval(NamedTuple):
    t: torch.Tensor  # (F,3) optimized intermediate frame poses
    q: torch.Tensor  # (F,4)
    mask: torch.Tensor  # (F,)


def propagate_interval(t0, q0, v0, imu_dts, imu_accs, imu_gyrs, imu_valid,
                       frame_idx, frame_mask, noise: ImuNoise = ImuNoise()):
    """Midpoint world propagation from the left keyframe state (zero
    biases), sampled at each frame boundary. ``frame_idx[i]`` is the number
    of IMU samples before frame i's stamp; ``imu_valid`` pads at the end.
    ``frame_mask`` is unused here (the chain solve reads it). Returns
    (t (F,3), q (F,4))."""
    dtype, dev = imu_accs.dtype, imu_accs.device
    g = noise.g_vec(dtype, dev)
    dt = torch.where(imu_valid, imu_dts, 0.0).to(dtype)
    a0 = torch.cat([imu_accs[:1], imu_accs[:-1]], dim=0)
    g0 = torch.cat([imu_gyrs[:1], imu_gyrs[:-1]], dim=0)
    q_abs = quat_normalize(quat_mul(q0.expand(imu_dts.shape[0], 4),
                                    _quat_prefix(exp_so3(0.5 * (g0 + imu_gyrs) * dt[:, None]))))
    q_prev = torch.cat([q0[None], q_abs[:-1]], dim=0)
    un_acc = 0.5 * ((quat_rotate(q_prev, a0) + g) + (quat_rotate(q_abs, imu_accs) + g))
    v_k = v0 + torch.cumsum(un_acc * dt[:, None], dim=0)
    v_prev = torch.cat([v0[None], v_k[:-1]], dim=0)
    ts = t0 + torch.cumsum(v_prev * dt[:, None] + 0.5 * un_acc * dt[:, None] * dt[:, None],
                           dim=0)
    idx = torch.clamp(frame_idx.long(), 0, ts.shape[0] - 1)
    return ts[idx], q_abs[idx]


def optimize_local_chain(t_init, q_init, mask, t_left, q_left, t_right, q_right,
                         weight: float = 1.0, n_iters: int = 10,
                         damping: float = 1e-8) -> DensifiedInterval:
    """GN chain solve. Variables: the F intermediate poses; measurements: the
    relative poses between the initial (propagated) intermediates, entry 0
    from the left keyframe; the last valid intermediate (the right
    keyframe's stamp) is pinned to the right keyframe pose."""
    F = t_init.shape[0]
    dtype, dev = t_init.dtype, t_init.device
    prev_t = torch.cat([t_left[None], t_init[:-1]], dim=0)
    prev_q = torch.cat([q_left[None], q_init[:-1]], dim=0)
    rel_t, rel_q = pose_relative(prev_t, prev_q, t_init, q_init)
    w = torch.tensor(weight, dtype=dtype, device=dev)
    w_chain = w.expand(F - 1)
    mk = mask.to(dtype)
    on = mk[1:] * mk[:-1]
    ar = torch.arange(F - 1, device=dev)
    last = torch.clamp(torch.sum(mask.to(torch.int64)) - 1, min=0).reshape(1)
    zero3 = torch.zeros(3, dtype=dtype, device=dev)
    qid = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=dev)
    freeze = torch.diag(torch.repeat_interleave((~mask).to(dtype) * 1e12, 6))
    t, q = t_init, q_init
    for _ in range(n_iters):
        # (F, F, 6, 6) blocks and (F, 6) gradient
        H = torch.zeros((F, F, 6, 6), dtype=dtype, device=dev)
        gv = torch.zeros((F, 6), dtype=dtype, device=dev)
        # left anchor: the fixed left keyframe → node 0
        r0, _, J0 = _between_block(t_left, q_left, t[0], q[0], rel_t[0], rel_q[0], w)
        H[0, 0] += mk[0] * (J0.T @ J0)
        gv[0] += mk[0] * (J0.T @ r0)
        # chain factors i-1 → i
        r, Ji, Jj = _between_block(t[:-1], q[:-1], t[1:], q[1:], rel_t[1:], rel_q[1:],
                                   w_chain)
        Hij = on[:, None, None] * torch.einsum("fab,fac->fbc", Ji, Jj)
        for rows, cols, B in (
                (ar, ar, on[:, None, None] * torch.einsum("fab,fac->fbc", Ji, Ji)),
                (ar + 1, ar + 1, on[:, None, None] * torch.einsum("fab,fac->fbc", Jj, Jj)),
                (ar, ar + 1, Hij), (ar + 1, ar, Hij.transpose(-1, -2))):
            H.index_put_((rows, cols), B, accumulate=True)
        gv.index_add_(0, ar, on[:, None] * torch.einsum("fab,fa->fb", Ji, r))
        gv.index_add_(0, ar + 1, on[:, None] * torch.einsum("fab,fa->fb", Jj, r))
        # right anchor: the last valid node pinned to the right keyframe pose
        rr, Jl, _ = _between_block(_row(t, last[0]), _row(q, last[0]), t_right, q_right,
                                   zero3, qid, w)
        H.index_put_((last, last), (Jl.T @ Jl)[None], accumulate=True)
        gv.index_add_(0, last, (Jl.T @ rr)[None])
        Hd = H.permute(0, 2, 1, 3).reshape(6 * F, 6 * F) + freeze
        t, q = _retract(t, q, solve_normal(Hd, -gv.reshape(-1), damping).reshape(F, 6))
    return DensifiedInterval(t=t, q=q, mask=mask)
