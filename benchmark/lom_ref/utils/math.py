"""Quaternion / SO(3) / SE(3) primitives (port of ``lili_om_tpu/utils/math.py``).

Conventions are those of the JAX package:

* quaternions are ``[w, x, y, z]`` (Hamilton, scalar-first);
* rotations act actively: ``rotate(q, v) = q ⊗ [0, v] ⊗ q⁻¹``;
* the pose tangent is ``[δt (3), δθ (3)]`` with the right retraction
  ``q ⊞ δθ = q ⊗ Exp(δθ)``.

All functions are plain tensor code, batched over leading dimensions, and
follow the dtype and device of their inputs; the ``*_np`` twins at the end
are numpy, for the system's host paths (loop-closure correction, submaps).
"""
from __future__ import annotations

import numpy as np
import torch


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def hat(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of ``v`` (batched over leading dims)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


skew = hat


def quat_identity(batch_shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    q = torch.zeros(tuple(batch_shape) + (4,), dtype=dtype, device=device)
    q[..., 0] = 1.0
    return q


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product ``q1 ⊗ q2`` (scalar-first, batched)."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


quat_inv = quat_conj  # unit quaternions only


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) ``v`` by unit quaternion(s) ``q``:
    v' = v + 2 w (u×v) + 2 u×(u×v)."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion → 3×3 rotation matrix (batched)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return torch.stack([
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
    ], dim=-2)


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """3×3 rotation matrix → unit quaternion (w ≥ 0), batched, branch-free:
    four candidate constructions, the one with the largest pivot wins."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    qw0 = safe_sqrt(1.0 + tr) / 2.0
    q0 = torch.stack([qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0), (m10 - m01) / (4 * qw0)], dim=-1)
    qx1 = safe_sqrt(1.0 + m00 - m11 - m22) / 2.0
    q1 = torch.stack([(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1), (m02 + m20) / (4 * qx1)], dim=-1)
    qy2 = safe_sqrt(1.0 - m00 + m11 - m22) / 2.0
    q2 = torch.stack([(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2, (m12 + m21) / (4 * qy2)], dim=-1)
    qz3 = safe_sqrt(1.0 - m00 - m11 + m22) / 2.0
    q3 = torch.stack([(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3), (m12 + m21) / (4 * qz3), qz3], dim=-1)

    pivots = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], dim=-1)
    idx = torch.argmax(pivots, dim=-1)
    cands = torch.stack([q0, q1, q2, q3], dim=-2)
    q = torch.gather(cands, -2, idx[..., None, None].expand(idx.shape + (1, 4)))[..., 0, :]
    return unify_quaternion(quat_normalize(q))


def unify_quaternion(q: torch.Tensor) -> torch.Tensor:
    """Canonicalize the sign so w ≥ 0."""
    sign = torch.where(q[..., :1] >= 0.0, 1.0, -1.0).to(q.dtype)
    return q * sign


def _quat_product_matrix(q: torch.Tensor, sign: float) -> torch.Tensor:
    w = q[..., 0]
    v = q[..., 1:]
    top = torch.cat([w[..., None], -v], dim=-1)[..., None, :]
    left = v[..., :, None]
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    block = w[..., None, None] * eye + sign * hat(v)
    bottom = torch.cat([left, block], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def quat_left_matrix(q: torch.Tensor) -> torch.Tensor:
    """4×4 matrix L(q) with L(q)·p = q ⊗ p."""
    return _quat_product_matrix(q, 1.0)


def quat_right_matrix(q: torch.Tensor) -> torch.Tensor:
    """4×4 matrix R(p) with R(p)·q = q ⊗ p."""
    return _quat_product_matrix(q, -1.0)


def exp_so3(theta: torch.Tensor) -> torch.Tensor:
    """Rotation vector → unit quaternion, Taylor-safe near 0."""
    angle2 = torch.sum(theta * theta, dim=-1, keepdim=True)
    angle = torch.sqrt(torch.clamp(angle2, min=1e-24))
    half = 0.5 * angle
    small = angle2 < 1e-12
    k = torch.where(small, 0.5 - angle2 / 48.0, torch.sin(half) / angle)
    w = torch.where(small, 1.0 - angle2 / 8.0, torch.cos(half))
    return torch.cat([w, k * theta], dim=-1)


delta_q = exp_so3


def log_so3(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion → rotation vector, Taylor-safe near identity."""
    q = unify_quaternion(q)
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    v = q[..., 1:]
    vnorm2 = torch.sum(v * v, dim=-1, keepdim=True)
    vnorm = torch.sqrt(torch.clamp(vnorm2, min=1e-24))
    small = vnorm2 < 1e-12
    angle = 2.0 * torch.atan2(vnorm, w)
    k = torch.where(
        small,
        2.0 / torch.clamp(w, min=1e-6) * (1.0 - vnorm2 / (3.0 * torch.clamp(w * w, min=1e-12))),
        angle / vnorm)
    return k * v


def so3_right_jacobian(theta: torch.Tensor) -> torch.Tensor:
    """Right Jacobian Jr of SO(3): Exp(θ+δ) ≈ Exp(θ) Exp(Jr δ)."""
    angle2 = torch.sum(theta * theta, dim=-1)
    angle = torch.sqrt(torch.clamp(angle2, min=1e-24))
    small = angle2 < 1e-12
    K = hat(theta)
    K2 = K @ K
    a = torch.where(small, 0.5 - angle2 / 24.0,
                    (1.0 - torch.cos(angle)) / torch.clamp(angle2, min=1e-24))
    b = torch.where(small, 1.0 / 6.0 - angle2 / 120.0,
                    (angle - torch.sin(angle)) / torch.clamp(angle2 * angle, min=1e-24))
    eye = torch.eye(3, dtype=theta.dtype, device=theta.device)
    return eye - a[..., None, None] * K + b[..., None, None] * K2


def so3_right_jacobian_inv(theta: torch.Tensor) -> torch.Tensor:
    """Inverse right Jacobian of SO(3)."""
    angle2 = torch.sum(theta * theta, dim=-1)
    angle = torch.sqrt(torch.clamp(angle2, min=1e-24))
    small = angle2 < 1e-12
    K = hat(theta)
    K2 = K @ K
    cot_term = torch.where(
        small,
        1.0 / 12.0 + angle2 / 720.0,
        (1.0 / torch.clamp(angle2, min=1e-24))
        - (1.0 + torch.cos(angle)) / torch.clamp(2.0 * angle * torch.sin(angle), min=1e-24))
    eye = torch.eye(3, dtype=theta.dtype, device=theta.device)
    return eye + 0.5 * K + cot_term[..., None, None] * K2


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Spherical interpolation between unit quaternions (batched, lerp
    fallback when the quaternions are nearly parallel)."""
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0.0, -q1, q1)
    dot = torch.clamp(torch.abs(dot), -1.0, 1.0)
    omega = torch.acos(torch.clamp(dot, 0.0, 1.0 - 1e-9))
    so = torch.sin(omega)
    near = dot > 1.0 - 1e-7
    t = t[..., None] if t.dim() == q0.dim() - 1 else t
    w0 = torch.where(near, 1.0 - t, torch.sin((1.0 - t) * omega) / torch.clamp(so, min=1e-12))
    w1 = torch.where(near, t, torch.sin(t * omega) / torch.clamp(so, min=1e-12))
    return quat_normalize(w0 * q0 + w1 * q1)


def pose_retract(t, q, delta):
    """Right-retraction of a 6-dof tangent [δt, δθ] onto (t, q)."""
    return t + delta[..., :3], quat_normalize(quat_mul(q, exp_so3(delta[..., 3:6])))


def pose_compose(t1, q1, t2, q2):
    """(t1,q1) ∘ (t2,q2) — apply pose2 then pose1."""
    return t1 + quat_rotate(q1, t2), quat_normalize(quat_mul(q1, q2))


def pose_inverse(t, q):
    qi = quat_conj(q)
    return -quat_rotate(qi, t), qi


def pose_relative(t1, q1, t2, q2):
    """Pose of frame 2 expressed in frame 1: (t1,q1)⁻¹ ∘ (t2,q2)."""
    qi = quat_conj(q1)
    return quat_rotate(qi, t2 - t1), quat_normalize(quat_mul(qi, q2))


def transform_points(t, q, pts):
    """Apply a pose to a point cloud: q·p + t, broadcast over points."""
    return quat_rotate(q[..., None, :], pts) + t[..., None, :]


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim=None, eps: float = 1e-9):
    m = mask.to(x.dtype)
    if dim is None:
        return torch.sum(x * m) / (torch.sum(m) + eps)
    return torch.sum(x * m, dim=dim) / (torch.sum(m, dim=dim) + eps)


def solve_psd(A: torch.Tensor, b: torch.Tensor, damping: float = 0.0) -> torch.Tensor:
    """Solve A x = b for symmetric PSD A by Cholesky with optional damping."""
    n = A.shape[-1]
    A = A + damping * torch.eye(n, dtype=A.dtype, device=A.device)
    L = torch.linalg.cholesky(A)
    vec = b.dim() == A.dim() - 1
    rhs = b[..., None] if vec else b
    y = torch.linalg.solve_triangular(L, rhs, upper=False)
    x = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)
    return x[..., 0] if vec else x


# ---------------------------------------------------------------------------
# numpy twins for the system's host paths
# ---------------------------------------------------------------------------


def quat_mul_np(q1, q2):
    """Batched Hamilton product, numpy, (...,4) wxyz."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return np.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], axis=-1)


def quat_conj_np(q):
    return q * np.array([1.0, -1.0, -1.0, -1.0], q.dtype)


def quat_normalize_np(q):
    return q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)


def quat_rotate_np(q, v):
    """Rotate (...,3) vectors by (...,4) quats, numpy."""
    w = q[..., :1]
    u = q[..., 1:]
    t = 2.0 * np.cross(u, v)
    return v + w * t + np.cross(u, t)
