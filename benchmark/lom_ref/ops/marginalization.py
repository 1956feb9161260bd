"""Schur-complement marginalization (port of
``lili_om_tpu/ops/marginalization.py``):

    H = [[Amm, Amr],  g = [gm,     A = Arr − Arm·Amm⁺·Amr
         [Arm, Arr]]       gr]     b = gr  − Arm·Amm⁺·gm
    A = S·Λ·Sᵀ  →  J = √Λ⁺·Sᵀ,  r₀ = (√Λ⁺)⁻¹·Sᵀ·b

with eigenvalues below ``eps`` (1e-8) truncated. The eigenvectors' signs are
arbitrary, so (J, r₀) are defined up to a sign per row; JᵀJ and Jᵀr₀, all
that the window solve uses, are not. A non-finite input gives NaNs, as
``jnp.linalg.eigh`` does, not an exception: a poisoned fusion state must
reach the health check (``LiliOmSystem.health_check_and_recover``).
"""
from __future__ import annotations

import torch


def _eigh(M: torch.Tensor):
    """``torch.linalg.eigh``, or NaNs where it fails to converge (a
    non-finite ``M``)."""
    try:
        return torch.linalg.eigh(M)
    except torch.linalg.LinAlgError:
        nan = torch.full_like(M, float("nan"))
        return nan[0], nan


def _eig_pinv_apply(M: torch.Tensor, X: torch.Tensor, eps: float):
    """M⁺·X via the symmetric eigendecomposition with an eigenvalue floor."""
    M = 0.5 * (M + M.T)
    lam, V = _eigh(M)
    ok = lam > eps
    inv = torch.where(ok, 1.0 / torch.where(ok, lam, torch.ones_like(lam)), 0.0)
    return V @ (inv[:, None] * (V.T @ X))


def schur_marginalize(H: torch.Tensor, g: torch.Tensor, m: int, eps: float = 1e-8):
    """Marginalize the leading ``m`` tangent dims of (H, g) (g = +ΣJᵀr).
    Returns (J (D−m, D−m), r0 (D−m,))."""
    Amm, Amr = H[:m, :m], H[:m, m:]
    Arm, Arr = H[m:, :m], H[m:, m:]
    gm, gr = g[:m], g[m:]
    Amm_inv_Amr = _eig_pinv_apply(Amm, Amr, eps)
    Amm_inv_gm = _eig_pinv_apply(Amm, gm[:, None], eps)[:, 0]
    A = Arr - Arm @ Amm_inv_Amr
    b = gr - Arm @ Amm_inv_gm
    A = 0.5 * (A + A.T)
    lam, V = _eigh(A)
    ok = lam > eps
    s = torch.sqrt(torch.where(ok, lam, torch.ones_like(lam)))
    sqrt_lam = torch.where(ok, s, 0.0)
    inv_sqrt_lam = torch.where(ok, 1.0 / s, 0.0)
    return sqrt_lam[:, None] * V.T, inv_sqrt_lam * (V.T @ b)
