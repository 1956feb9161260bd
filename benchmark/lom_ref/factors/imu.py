"""IMU preintegration factor (port of ``lili_om_tpu/factors/imu.py``): the
whitened residual with hand-derived Jacobians (``imu_factor_analytic``, the
fusion step's) and with Jacobians by forward-mode autodiff through the
exact retraction (``imu_factor``, the reference the analytic form is held
against).

Keyframe tangent ordering (15): [δt, δθ, δv, δba, δbg].
"""
from __future__ import annotations

import torch

from ..ops.preintegration import (O_BA, O_BG, O_P, O_R, O_V, ImuNoise, Preint,
                                  bias_corrected_deltas, residual as preint_residual,
                                  sqrt_info)
from ..utils.math import (exp_so3, hat, quat_conj, quat_left_matrix, quat_mul,
                          quat_normalize, quat_right_matrix, quat_to_rotmat)


class KeyframeState:
    """Not a class used at runtime: documents the per-keyframe state layout
    used across the backend, t(3), q(4), v(3), ba(3), bg(3); tangent dim 15."""


def retract_state(t, q, v, ba, bg, delta):
    """Apply a 15-dof tangent to keyframe state(s) (batched over leading dims)."""
    return (t + delta[..., 0:3],
            quat_normalize(quat_mul(q, exp_so3(delta[..., 3:6]))),
            v + delta[..., 6:9], ba + delta[..., 9:12], bg + delta[..., 12:15])


def imu_factor(p: Preint, noise: ImuNoise, ti, qi, vi, bai, bgi, tj, qj, vj, baj, bgj,
               W=None):
    """Whitened residual (15,) and Jacobians (15,15)×2 w.r.t. the tangents of
    keyframes i and j, by ``torch.func.jacfwd`` through
    :func:`retract_state` (ImuFactor::Evaluate, ImuFactor.h:30-141, up to an
    orthogonal whitening factor). ``W``: precomputed :func:`sqrt_info`."""
    if W is None:
        W = sqrt_info(p)

    def res(di, dj):
        si = retract_state(ti, qi, vi, bai, bgi, di)
        sj = retract_state(tj, qj, vj, baj, bgj, dj)
        return W @ preint_residual(p, noise, *si, *sj)

    z = torch.zeros(15, dtype=p.dp.dtype, device=p.dp.device)
    return (res(z, z), torch.func.jacfwd(res, argnums=0)(z, z),
            torch.func.jacfwd(res, argnums=1)(z, z))


def imu_factor_analytic(p: Preint, noise: ImuNoise, ti, qi, vi, bai, bgi,
                        tj, qj, vj, baj, bgj, W=None):
    """Whitened residual (15,) and Jacobians (15,15) w.r.t. the tangents of
    keyframes i and j (the reference's ImuFactor.h forms for the right
    retraction). ``W``: precomputed :func:`sqrt_info`."""
    if W is None:
        W = sqrt_info(p)
    dtype, dev = p.dp.dtype, p.dp.device
    g = noise.g_vec(dtype, dev)
    dt = p.sum_dt
    r = preint_residual(p, noise, ti, qi, vi, bai, bgi, tj, qj, vj, baj, bgj)

    Ri_T = quat_to_rotmat(quat_conj(qi))
    alpha = -0.5 * g * dt * dt + tj - ti - vi * dt
    beta = -g * dt + vj - vi
    _, dq_corr, _ = bias_corrected_deltas(p, bai, bgi)
    q_ij = quat_mul(quat_conj(qi), qj)
    J = p.jacobian
    J_p_ba = J[O_P:O_P + 3, O_BA:O_BA + 3]
    J_p_bg = J[O_P:O_P + 3, O_BG:O_BG + 3]
    J_v_ba = J[O_V:O_V + 3, O_BA:O_BA + 3]
    J_v_bg = J[O_V:O_V + 3, O_BG:O_BG + 3]
    J_q_bg = J[O_R:O_R + 3, O_BG:O_BG + 3]

    Z = torch.zeros((3, 3), dtype=dtype, device=dev)
    I3 = torch.eye(3, dtype=dtype, device=dev)
    dq_inv = quat_conj(dq_corr)
    dq_ij = quat_mul(dq_inv, q_ij)
    Jq_ti = -(quat_left_matrix(dq_inv) @ quat_right_matrix(q_ij))[1:, 1:]
    Jq_tj = quat_left_matrix(dq_ij)[1:, 1:]
    Jq_bg = -quat_right_matrix(dq_ij)[1:, 1:] @ J_q_bg

    def rows(*blocks):
        return torch.cat([torch.cat(b, dim=1) for b in blocks], dim=0)

    Ji = rows(
        (-Ri_T, hat(Ri_T @ alpha), -Ri_T * dt, -J_p_ba, -J_p_bg),
        (Z, Jq_ti, Z, Z, Jq_bg),
        (Z, hat(Ri_T @ beta), -Ri_T, -J_v_ba, -J_v_bg),
        (Z, Z, Z, -I3, Z),
        (Z, Z, Z, Z, -I3),
    )
    Jj = rows(
        (Ri_T, Z, Z, Z, Z),
        (Z, Jq_tj, Z, Z, Z),
        (Z, Z, Ri_T, Z, Z),
        (Z, Z, Z, I3, Z),
        (Z, Z, Z, Z, I3),
    )
    return W @ r, W @ Ji, W @ Jj
