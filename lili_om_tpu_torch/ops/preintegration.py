"""IMU preintegration (port of ``lili_om_tpu/ops/preintegration.py``: the
parallel forms the fusion step runs, and the sequential midpoint forms,
``integrate`` and ``propagate_world``, one step a sample).

State ordering follows the reference: ``[p(0:3), θ(3:6), v(6:9), ba(9:12),
bg(12:15)]``. The reference's quirks are kept: the ``-1/6`` factor in
``F[0:3,12:15]``, the ``0.5·R·dt²`` position-noise mapping in ``V``, and the
covariance seeded at ``init_cov·I``.

The JAX package runs the orientation and (Jacobian, covariance) recursions
as ``associative_scan``s; here they are Hillis-Steele prefix scans of
⌈log₂N⌉ batched rounds. Only the association of the products changes, so
only the rounding differs.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..device import const
from ..utils.math import exp_so3, hat, quat_conj, quat_mul, quat_normalize, quat_rotate, quat_to_rotmat

O_P, O_R, O_V, O_BA, O_BG = 0, 3, 6, 9, 12


class ImuNoise(NamedTuple):
    """IMU noise densities & gravity (field for field as in the JAX package)."""

    acc_n: float = 0.00059
    gyr_n: float = 0.000061
    acc_w: float = 0.000011
    gyr_w: float = 0.000001
    init_cov: float = 1e-4
    g_norm: float = 9.805

    def g_vec(self, dtype=torch.float32, device=None) -> torch.Tensor:
        """Gravity vector convention of the reference: -(0,0,g); one shared
        tensor per (g, dtype, device) (:func:`device.const`)."""
        return const((0.0, 0.0, -self.g_norm), dtype, device)

    def noise_diag(self, dtype=torch.float32, device=None) -> torch.Tensor:
        """(18,) diagonal of the noise covariance."""
        return torch.tensor(
            [self.acc_n ** 2] * 3 + [self.gyr_n ** 2] * 3 + [self.acc_n ** 2] * 3
            + [self.gyr_n ** 2] * 3 + [self.acc_w ** 2] * 3 + [self.gyr_w ** 2] * 3,
            dtype=dtype, device=device)

    def noise_cov(self, dtype=torch.float32, device=None) -> torch.Tensor:
        """18×18 diagonal noise covariance (Preintegration.h:48-54)."""
        return torch.diag(self.noise_diag(dtype, device))


class Preint(NamedTuple):
    dp: torch.Tensor  # (3,) position delta in frame i
    dq: torch.Tensor  # (4,) orientation delta, wxyz
    dv: torch.Tensor  # (3,) velocity delta in frame i
    jacobian: torch.Tensor  # (15,15)
    covariance: torch.Tensor  # (15,15)
    ba: torch.Tensor  # (3,) linearization-point accel bias
    bg: torch.Tensor  # (3,) linearization-point gyro bias
    sum_dt: torch.Tensor  # ()


def init_preint(ba: torch.Tensor, bg: torch.Tensor, noise: ImuNoise) -> Preint:
    dtype, dev = ba.dtype, ba.device
    return Preint(
        dp=torch.zeros(3, dtype=dtype, device=dev),
        dq=torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=dev),
        dv=torch.zeros(3, dtype=dtype, device=dev),
        jacobian=torch.eye(15, dtype=dtype, device=dev),
        covariance=noise.init_cov * torch.eye(15, dtype=dtype, device=dev),
        ba=ba.clone(), bg=bg.clone(),
        sum_dt=torch.zeros((), dtype=dtype, device=dev),
    )


def _midpoint_step(p: Preint, acc0, gyr0, acc1, gyr1, dt, noise_diag) -> Preint:
    """One midpoint step (Preintegration.h:79-148). ``noise_diag``: (18,),
    so ``V·Q·Vᵀ = (V∘q)·Vᵀ``."""
    un_acc_0 = quat_rotate(p.dq, acc0 - p.ba)
    un_gyr = 0.5 * (gyr0 + gyr1) - p.bg
    dq1 = quat_normalize(quat_mul(p.dq, exp_so3(un_gyr * dt)))
    un_acc = 0.5 * (un_acc_0 + quat_rotate(dq1, acc1 - p.ba))
    dp1 = p.dp + p.dv * dt + 0.5 * un_acc * dt * dt
    dv1 = p.dv + un_acc * dt
    F, W = _step_FW(p.dq[None], dq1[None], (acc0 - p.ba)[None], (acc1 - p.ba)[None],
                    un_gyr[None], dt.reshape(1), noise_diag)
    F, W = F[0], W[0]
    return Preint(dp1, dq1, dv1, F @ p.jacobian, F @ p.covariance @ F.T + W,
                  p.ba, p.bg, p.sum_dt + dt)


def _step_mask(dts, mask):
    if mask is None:
        return torch.ones(dts.shape, dtype=torch.bool, device=dts.device)
    return mask


def integrate(noise: ImuNoise, ba, bg, acc0, gyr0, dts, accs, gyrs,
              mask: Optional[torch.Tensor] = None) -> Preint:
    """Integrate an IMU interval one sample at a time (the scanned form of
    repeated ``push_back``, Preintegration.h:57-62). ``acc0, gyr0``: the
    sample at the interval start; ``dts`` (N,), ``accs``/``gyrs`` (N,3): the
    samples at each step end; masked (False) steps are exact no-ops and keep
    the carried previous sample."""
    dtype = accs.dtype
    p = init_preint(ba.to(dtype), bg.to(dtype), noise)
    ncov = noise.noise_diag(dtype, accs.device)
    mask = _step_mask(dts, mask)
    a0, g0 = acc0.to(dtype), gyr0.to(dtype)
    for k in range(dts.shape[0]):
        valid = mask[k]
        dt = torch.where(valid, dts[k], 0.0).to(dtype)
        p1 = _midpoint_step(p, a0, g0, accs[k], gyrs[k], dt, ncov)
        p = Preint(*[torch.where(valid, new, old) for new, old in zip(p1, p)])
        a0 = torch.where(valid, accs[k], a0)
        g0 = torch.where(valid, gyrs[k], g0)
    return p


def propagate_world(t, q, v, ba, bg, noise: ImuNoise, acc0, gyr0, dts, accs, gyrs,
                    mask: Optional[torch.Tensor] = None):
    """World-frame midpoint IMU state propagation one sample at a time
    (BackendFusion.cpp:801-827). Returns the propagated ``(t, q, v)`` and
    the last consumed sample ``(acc, gyr)``, so callers can chain intervals."""
    dtype = accs.dtype
    g = noise.g_vec(dtype, accs.device)
    mask = _step_mask(dts, mask)
    t, q, v, a0, g0 = (x.to(dtype) for x in (t, q, v, acc0, gyr0))
    for k in range(dts.shape[0]):
        valid = mask[k]
        dt = torch.where(valid, dts[k], 0.0).to(dtype)
        a1, g1 = accs[k], gyrs[k]
        un_acc_0 = quat_rotate(q, a0 - ba) + g
        un_gyr = 0.5 * (g0 + g1) - bg
        q1 = quat_normalize(quat_mul(q, exp_so3(un_gyr * dt)))
        un_acc = 0.5 * (un_acc_0 + quat_rotate(q1, a1 - ba) + g)
        t = t + v * dt + 0.5 * un_acc * dt * dt
        v = v + un_acc * dt
        q = torch.where(valid, q1, q)
        a0 = torch.where(valid, a1, a0)
        g0 = torch.where(valid, g1, g0)
    return t, q, v, a0, g0


def prefix_scan(combine, xs):
    """Inclusive prefix scan of an associative ``combine(earlier, later)``
    over dim 0 of every tensor in the tuple ``xs`` (Hillis-Steele:
    ⌈log₂N⌉ rounds, each one batched call of ``combine``)."""
    n = xs[0].shape[0]
    off = 1
    while off < n:
        new = combine(tuple(x[:-off] for x in xs), tuple(x[off:] for x in xs))
        xs = tuple(torch.cat([x[:off], y], dim=0) for x, y in zip(xs, new))
        off *= 2
    return xs


def _quat_prefix(E: torch.Tensor) -> torch.Tensor:
    """(N,4) per-step unit quats → normalized prefix products E_1 ⊗ … ⊗ E_k."""
    (Q,) = prefix_scan(lambda a, b: (quat_mul(a[0], b[0]),), (E,))
    return Q / torch.linalg.norm(Q, dim=-1, keepdim=True)


def _step_inputs(acc0, gyr0, dts, accs, gyrs, mask):
    dt = torch.where(mask, dts, 0.0).to(accs.dtype)
    a0 = torch.cat([acc0[None], accs[:-1]], dim=0)
    g0 = torch.cat([gyr0[None], gyrs[:-1]], dim=0)
    return dt, a0, g0


def propagate_world_parallel(t, q, v, ba, bg, noise: ImuNoise, acc0, gyr0,
                             dts, accs, gyrs, mask: Optional[torch.Tensor] = None):
    """World-frame midpoint IMU state propagation (trailing padding).
    Returns (t, q, v, last acc, last gyr)."""
    dtype, dev = accs.dtype, accs.device
    g = noise.g_vec(dtype, dev)
    if mask is None:
        mask = torch.ones(dts.shape, dtype=torch.bool, device=dev)
    dt, a0, g0 = _step_inputs(acc0, gyr0, dts, accs, gyrs, mask)

    un_gyr = 0.5 * (g0 + gyrs) - bg
    E = exp_so3(un_gyr * dt[:, None])
    Qk = _quat_prefix(E)
    q_abs = quat_mul(q.expand(Qk.shape), Qk)
    q_prev = torch.cat([q[None], q_abs[:-1]], dim=0)

    un_acc = 0.5 * ((quat_rotate(q_prev, a0 - ba) + g) + (quat_rotate(q_abs, accs - ba) + g))
    dv_steps = un_acc * dt[:, None]
    v_k = v + torch.cumsum(dv_steps, dim=0)
    v_prev = torch.cat([v[None], v_k[:-1]], dim=0)
    dp_steps = v_prev * dt[:, None] + 0.5 * un_acc * dt[:, None] ** 2
    t_f = t + torch.sum(dp_steps, dim=0)

    n_valid = torch.sum(mask.to(torch.int64))
    last = torch.clamp(n_valid - 1, min=0)
    any_valid = n_valid > 0
    a_last = torch.where(any_valid, accs[last], acc0)
    g_last = torch.where(any_valid, gyrs[last], gyr0)
    return t_f, quat_normalize(q_abs[-1]), v_k[-1], a_last, g_last


def _step_FW(dq_prev, dq_k, da0, da1, un_gyr, dt, noise_diag):
    """Batched per-step F (N,15,15) and W = (V∘q)Vᵀ (N,15,15) of the midpoint
    recursion."""
    N = dt.shape[0]
    dtype, dev = dt.dtype, dt.device
    R0 = quat_to_rotmat(dq_prev)
    R1 = quat_to_rotmat(dq_k)
    Rw = hat(un_gyr)
    Ra0 = hat(da0)
    Ra1 = hat(da1)
    I3 = torch.eye(3, dtype=dtype, device=dev).expand(N, 3, 3)
    d = dt[:, None, None]
    ImRw = I3 - Rw * d
    R1Ra1 = R1 @ Ra1
    R0Ra0 = R0 @ Ra0

    F = torch.zeros((N, 15, 15), dtype=dtype, device=dev)
    F[:, 0:3, 0:3] = I3
    F[:, 0:3, 3:6] = -0.25 * R0Ra0 * d * d - 0.25 * (R1Ra1 @ ImRw) * d * d
    F[:, 0:3, 6:9] = I3 * d
    F[:, 0:3, 9:12] = -0.25 * (R0 + R1) * d * d
    F[:, 0:3, 12:15] = -0.1667 * R1Ra1 * d * d * (-d)  # reference quirk: -1/6
    F[:, 3:6, 3:6] = ImRw
    F[:, 3:6, 12:15] = -I3 * d
    F[:, 6:9, 3:6] = -0.5 * R0Ra0 * d - 0.5 * (R1Ra1 @ ImRw) * d
    F[:, 6:9, 6:9] = I3
    F[:, 6:9, 9:12] = -0.5 * (R0 + R1) * d
    F[:, 6:9, 12:15] = -0.5 * R1Ra1 * d * (-d)
    F[:, 9:12, 9:12] = I3
    F[:, 12:15, 12:15] = I3

    V = torch.zeros((N, 15, 18), dtype=dtype, device=dev)
    V[:, 0:3, 0:3] = 0.5 * R0 * d * d  # reference quirk: 0.5·R·dt²
    v03 = -0.25 * R1Ra1 * d * d * 0.5 * d
    V[:, 0:3, 3:6] = v03
    V[:, 0:3, 6:9] = 0.5 * R1 * d * d
    V[:, 0:3, 9:12] = v03
    V[:, 3:6, 3:6] = 0.5 * I3 * d
    V[:, 3:6, 9:12] = 0.5 * I3 * d
    V[:, 6:9, 0:3] = 0.5 * R0 * d
    v63 = -0.5 * R1Ra1 * d * 0.5 * d
    V[:, 6:9, 3:6] = v63
    V[:, 6:9, 6:9] = 0.5 * R1 * d
    V[:, 6:9, 9:12] = v63
    V[:, 9:12, 12:15] = I3 * d
    V[:, 12:15, 15:18] = I3 * d
    return F, (V * noise_diag[None, None, :]) @ V.transpose(-1, -2)


def integrate_parallel(noise: ImuNoise, ba, bg, acc0, gyr0, dts, accs, gyrs,
                       mask: Optional[torch.Tensor] = None) -> Preint:
    """Preintegrate an IMU interval (trailing padding; padded steps are
    exact no-ops)."""
    dtype, dev = accs.dtype, accs.device
    if mask is None:
        mask = torch.ones(dts.shape, dtype=torch.bool, device=dev)
    dt, a0, g0 = _step_inputs(acc0, gyr0, dts, accs, gyrs, mask)

    un_gyr = 0.5 * (g0 + gyrs) - bg
    E = exp_so3(un_gyr * dt[:, None])
    dq_k = _quat_prefix(E)
    qid = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=dev)
    dq_prev = torch.cat([qid[None], dq_k[:-1]], dim=0)

    un_acc = 0.5 * (quat_rotate(dq_prev, a0 - ba) + quat_rotate(dq_k, accs - ba))
    dv_k = torch.cumsum(un_acc * dt[:, None], dim=0)
    dv_prev = torch.cat([torch.zeros((1, 3), dtype=dtype, device=dev), dv_k[:-1]], dim=0)
    dp = torch.sum(dv_prev * dt[:, None] + 0.5 * un_acc * dt[:, None] ** 2, dim=0)

    F, W = _step_FW(dq_prev, dq_k, a0 - ba, accs - ba, un_gyr, dt,
                    noise.noise_diag(dtype, dev))

    def combine(x, y):
        A1, W1 = x
        A2, W2 = y
        return A2 @ A1, A2 @ W1 @ A2.transpose(-1, -2) + W2

    A_all, W_all = prefix_scan(combine, (F, W))
    Atot, Wtot = A_all[-1], W_all[-1]
    cov = noise.init_cov * (Atot @ Atot.T) + Wtot
    return Preint(dp=dp, dq=quat_normalize(dq_k[-1]), dv=dv_k[-1],
                  jacobian=Atot, covariance=cov, ba=ba, bg=bg, sum_dt=torch.sum(dt))


def bias_corrected_deltas(p: Preint, bai: torch.Tensor, bgi: torch.Tensor):
    """First-order bias correction of (dp, dq, dv)."""
    dba = bai - p.ba
    dbg = bgi - p.bg
    J = p.jacobian
    dp = p.dp + J[O_P:O_P + 3, O_BA:O_BA + 3] @ dba + J[O_P:O_P + 3, O_BG:O_BG + 3] @ dbg
    dv = p.dv + J[O_V:O_V + 3, O_BA:O_BA + 3] @ dba + J[O_V:O_V + 3, O_BG:O_BG + 3] @ dbg
    dq = quat_normalize(quat_mul(p.dq, exp_so3(J[O_R:O_R + 3, O_BG:O_BG + 3] @ dbg)))
    return dp, dq, dv


def residual(p: Preint, noise: ImuNoise, Pi, Qi, Vi, Bai, Bgi, Pj, Qj, Vj, Baj, Bgj):
    """15-dof preintegration residual (unwhitened)."""
    g = noise.g_vec(p.dp.dtype, p.dp.device)
    dt = p.sum_dt
    dp, dq, dv = bias_corrected_deltas(p, Bai, Bgi)
    Qi_inv = quat_conj(Qi)
    r_p = quat_rotate(Qi_inv, -0.5 * g * dt * dt + Pj - Pi - Vi * dt) - dp
    r_q = 2.0 * quat_normalize(quat_mul(quat_conj(dq), quat_mul(Qi_inv, Qj)))[1:]
    r_v = quat_rotate(Qi_inv, -g * dt + Vj - Vi) - dv
    return torch.cat([r_p, r_q, r_v, Baj - Bai, Bgj - Bgi])


def sqrt_info(p: Preint) -> torch.Tensor:
    """Whitening matrix W = L⁻¹ with P = L Lᵀ (so Wᵀ W = P⁻¹); batched over
    leading dims of the covariance."""
    cov = p.covariance
    L = torch.linalg.cholesky_ex(cov).L
    eye = torch.eye(15, dtype=cov.dtype, device=cov.device).expand_as(cov)
    return torch.linalg.solve_triangular(L, eye, upper=False)
