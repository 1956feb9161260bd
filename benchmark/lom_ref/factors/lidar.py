"""LiDAR scan-to-map factors: residuals + analytic tangent-space Jacobians,
batched over all correspondences (port of ``lili_om_tpu/factors/lidar.py``).

Pose tangent: right perturbation ``q ⊞ δθ = q ⊗ Exp(δθ)``, ``t ⊞ δt = t + δt``.
The edge factor ignores its stored extrinsic, as the reference's
``LidarEdgeFactor`` does: callers hand it the raw sensor points.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils.math import (_cross, hat, quat_conj, quat_mul, quat_normalize, quat_rotate,
                          quat_to_rotmat)


def huber_weight(r2: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS sqrt-weight for the Huber loss with parameter ``delta``."""
    r = torch.sqrt(torch.clamp(r2, min=1e-24))
    return torch.where(r <= delta, torch.ones_like(r), torch.sqrt(delta / r))


def cauchy_weight(r2: torch.Tensor, c: float) -> torch.Tensor:
    """IRLS sqrt-weight for the Cauchy loss ``c²·log(1+r²/c²)``."""
    return 1.0 / torch.sqrt(1.0 + r2 / (c * c))


def body_points(pts: torch.Tensor, t_lb: Optional[torch.Tensor], q_lb: Optional[torch.Tensor]):
    """Lidar-frame points → body frame: ``p_b = q_lb⁻¹ (p − t_lb)``."""
    if q_lb is None:
        return pts
    return quat_rotate(quat_conj(q_lb), pts - t_lb)


class PlaneFactorBatch(NamedTuple):
    pts: torch.Tensor  # (N,3) feature points
    normals: torch.Tensor  # (N,3) world-frame plane unit normals
    offsets: torch.Tensor  # (N,) plane d: n·x + d = 0
    scores: torch.Tensor  # (N,) per-correspondence weight s
    mask: torch.Tensor  # (N,)


def plane_residual(t: torch.Tensor, q: torch.Tensor, batch: PlaneFactorBatch):
    """r_i = s_i · (n_i · (q·p_i + t) + d_i) and J (N,6) = [∂/∂δt, ∂/∂δθ];
    invalid rows are 0."""
    R = quat_to_rotmat(q)
    pw = batch.pts @ R.T + t
    r = batch.scores * (torch.sum(batch.normals * pw, dim=-1) + batch.offsets)
    Jt = batch.scores[:, None] * batch.normals
    Rp = torch.einsum("ab,nbc->nac", R, hat(batch.pts))
    Jth = -torch.einsum("ni,nij->nj", Jt, Rp)
    m = batch.mask
    r = torch.where(m, r, 0.0)
    J = torch.where(m[:, None], torch.cat([Jt, Jth], dim=-1), 0.0)
    return r, J


class EdgeFactorBatch(NamedTuple):
    pts: torch.Tensor  # (N,3)
    point_a: torch.Tensor  # (N,3) world
    point_b: torch.Tensor  # (N,3) world
    scores: torch.Tensor  # (N,)
    mask: torch.Tensor  # (N,)


def edge_residual(t: torch.Tensor, q: torch.Tensor, batch: EdgeFactorBatch):
    """Scalar point-to-line distance residuals + Jacobians (N,), (N,6)."""
    R = quat_to_rotmat(q)
    y = batch.pts @ R.T + t
    ab = batch.point_a - batch.point_b
    ab_n = torch.linalg.norm(ab, dim=-1, keepdim=True)
    u = ab / torch.clamp(ab_n, min=1e-9)
    ya = y - batch.point_a
    dist = torch.linalg.norm(_cross(ya, u), dim=-1)
    r = batch.scores * dist
    perp = ya - torch.sum(ya * u, dim=-1, keepdim=True) * u
    g = perp / torch.clamp(dist, min=1e-9)[:, None]
    Jt = batch.scores[:, None] * g
    Rp = torch.einsum("ab,nbc->nac", R, hat(batch.pts))
    Jth = -torch.einsum("ni,nij->nj", Jt, Rp)
    m = batch.mask
    r = torch.where(m, r, 0.0)
    J = torch.where(m[:, None], torch.cat([Jt, Jth], dim=-1), 0.0)
    return r, J


def relative_pose_residual(t1, q1, t2, q2, dt, dq, weight=1.0):
    """6-dof relative-pose residual (the global and local pose graphs'
    between-factor):

    r = w·[ q₁⁻¹(p₂−p₁) − δp ; 2·vec(δq⁻¹ ⊗ q₁⁻¹ ⊗ q₂) ]

    translation first, as the tangent. Returns r (6,); callers take its
    Jacobians by forward-mode autodiff."""
    qi = quat_conj(q1)
    r_t = quat_rotate(qi, t2 - t1) - dt
    r_q = 2.0 * quat_normalize(quat_mul(quat_conj(dq), quat_mul(qi, q2)))[..., 1:]
    return weight * torch.cat([r_t, r_q], dim=-1)
