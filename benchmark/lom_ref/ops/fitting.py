"""Batched geometric fits over fixed-size neighbour sets (port of
``lili_om_tpu/ops/fitting.py``): the ``A·n = −1`` plane fit, the principal-
direction line fit, a Cramer's-rule 3×3 solve and the closed-form symmetric
3×3 eigendecomposition."""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..utils.math import _cross


class PlaneFit(NamedTuple):
    normal: torch.Tensor  # (...,3) unit
    d: torch.Tensor  # (...,) plane offset: n·x + d = 0
    valid: torch.Tensor  # (...,) all points within dist_thres of the plane


def fit_plane(neighbors: torch.Tensor, mask: torch.Tensor, dist_thres: float = 0.2,
              weights: torch.Tensor | None = None) -> PlaneFit:
    """Fit n·x = −1 by (weighted) least squares over the k neighbours, via
    the 3×3 normal equations (the reference's ``"ref"`` plane form).

    neighbors: (..., k, 3); mask: (..., k); weights: optional (..., k)."""
    w = mask.to(neighbors.dtype)
    if weights is not None:
        w = w * weights
    A = neighbors * w[..., None]
    AtA = torch.einsum("...ki,...kj->...ij", A, neighbors)
    Atb = -torch.sum(A, dim=-2)
    n_raw = solve3(AtA, Atb, damping=1e-9)
    norm = torch.clamp(torch.linalg.norm(n_raw, dim=-1, keepdim=True), min=1e-12)
    normal = n_raw / norm
    d = 1.0 / norm[..., 0]
    pd = torch.abs(torch.einsum("...ki,...i->...k", neighbors, normal) + d[..., None])
    ok = torch.all(torch.where(mask, pd <= dist_thres, True), dim=-1)
    ok = ok & (torch.sum(mask, dim=-1) >= 3)
    return PlaneFit(normal=normal, d=d, valid=ok)


class LineFit(NamedTuple):
    direction: torch.Tensor  # (...,3) unit principal direction
    centroid: torch.Tensor  # (...,3)
    valid: torch.Tensor  # (...,) λ_max > ratio_thres·λ_mid


def fit_line(neighbors: torch.Tensor, mask: torch.Tensor, ratio_thres: float = 3.0) -> LineFit:
    """Principal-direction line fit with the eigenvalue gate λ₂ > 3·λ₁."""
    w = mask.to(neighbors.dtype)
    cnt = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1.0)
    mean = torch.sum(neighbors * w[..., None], dim=-2, keepdim=True) / cnt[..., None]
    ctr = (neighbors - mean) * w[..., None]
    cov = torch.einsum("...ki,...kj->...ij", ctr, ctr) / cnt[..., None]
    evals, evecs = eig3_symmetric(cov)
    direction = evecs[..., :, 2]
    valid = (evals[..., 2] > ratio_thres * evals[..., 1]) & (torch.sum(mask, dim=-1) >= 3)
    return LineFit(direction=direction, centroid=mean[..., 0, :], valid=valid)


def solve3(A: torch.Tensor, b: torch.Tensor, damping: float = 0.0) -> torch.Tensor:
    """Batched 3×3 linear solve by Cramer's rule (adjugate)."""
    if damping:
        A = A + damping * torch.eye(3, dtype=A.dtype, device=A.device)
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    det = a00 * c00 + a01 * c01 + a02 * c02
    det = torch.where(torch.abs(det) < 1e-20, torch.full_like(det, 1e-20), det)
    c10 = a02 * a21 - a01 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a01 * a20 - a00 * a21
    c20 = a01 * a12 - a02 * a11
    c21 = a02 * a10 - a00 * a12
    c22 = a00 * a11 - a01 * a10
    adjT = torch.stack([
        torch.stack([c00, c10, c20], dim=-1),
        torch.stack([c01, c11, c21], dim=-1),
        torch.stack([c02, c12, c22], dim=-1),
    ], dim=-2)
    return torch.einsum("...ij,...j->...i", adjT, b) / det[..., None]


def eig3_symmetric(A: torch.Tensor):
    """Batched closed-form symmetric 3×3 eigendecomposition, ascending:
    eigenvalues by the trigonometric (Cardano) formula, eigenvectors by the
    best-conditioned cross product of rows of (A − λI). Returns
    (evals (...,3), evecs (...,3,3) as columns)."""
    a00, a11, a22 = A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]
    a01, a02, a12 = A[..., 0, 1], A[..., 0, 2], A[..., 1, 2]
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    d0, d1, d2 = a00 - q, a11 - q, a22 - q
    p2 = d0 * d0 + d1 * d1 + d2 * d2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-30))
    detB = (d0 * (d1 * d2 - a12 * a12)
            - a01 * (a01 * d2 - a12 * a02)
            + a02 * (a01 * a12 - d1 * a02)) / (p * p * p)
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.acos(r) / 3.0
    lam2 = q + 2.0 * p * torch.cos(phi)  # largest
    lam0 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)  # smallest
    lam1 = 3.0 * q - lam2 - lam0
    iso = p2 < 1e-24  # near-isotropic: all eigenvalues = q
    lam0 = torch.where(iso, q, lam0)
    lam1 = torch.where(iso, q, lam1)
    lam2 = torch.where(iso, q, lam2)
    evals = torch.stack([lam0, lam1, lam2], dim=-1)

    def eigvec(lam, fallback_axis):
        r0 = torch.stack([a00 - lam, a01, a02], dim=-1)
        r1 = torch.stack([a01, a11 - lam, a12], dim=-1)
        r2 = torch.stack([a02, a12, a22 - lam], dim=-1)
        c01 = _cross(r0, r1)
        c02 = _cross(r0, r2)
        c12 = _cross(r1, r2)
        n01 = torch.sum(c01 * c01, dim=-1, keepdim=True)
        n02 = torch.sum(c02 * c02, dim=-1, keepdim=True)
        n12 = torch.sum(c12 * c12, dim=-1, keepdim=True)
        best = torch.where(n01 >= torch.maximum(n02, n12), c01,
                           torch.where(n02 >= n12, c02, c12))
        nrm = torch.sqrt(torch.clamp(torch.sum(best * best, dim=-1, keepdim=True), min=1e-30))
        v = best / nrm
        axis = torch.zeros_like(v)
        axis[..., fallback_axis] = 1.0
        return torch.where(iso[..., None], axis, v)

    v0 = eigvec(lam0, 0)
    v2 = eigvec(lam2, 2)
    v0 = v0 - torch.sum(v0 * v2, dim=-1, keepdim=True) * v2
    v0 = v0 / torch.sqrt(torch.clamp(torch.sum(v0 * v0, dim=-1, keepdim=True), min=1e-30))
    v1 = _cross(v2, v0)
    evecs = torch.stack([v0, v1, v2], dim=-1)
    return evals, evecs
