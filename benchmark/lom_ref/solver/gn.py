"""Dense batched Gauss-Newton / Levenberg-Marquardt building blocks (port of
``lili_om_tpu/solver/gn.py``). A singular system gives a zero step, as the
JAX Cholesky's NaNs do there: ``cholesky_ex`` reports the failure without a
host sync and the step is zeroed."""
from __future__ import annotations

import torch


def block_hessian(J: torch.Tensor, r: torch.Tensor, w: torch.Tensor | None = None):
    """(H, b) = (JᵀJ, −Jᵀr) over N residual rows, with optional row weights."""
    if w is not None:
        J = J * w[:, None]
        r = r * w
    return J.T @ J, -(J.T @ r)


def _cholesky_solve(Hd: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    L, info = torch.linalg.cholesky_ex(Hd)
    y = torch.linalg.solve_triangular(L, b[:, None], upper=False)
    delta = torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]
    good = (info == 0) & torch.all(torch.isfinite(delta))
    return torch.where(good, delta, torch.zeros_like(delta))


def solve_normal(H: torch.Tensor, b: torch.Tensor, damping=0.0) -> torch.Tensor:
    """Solve (H + λI) δ = b by Cholesky; a failed factorization gives δ = 0."""
    D = H.shape[-1]
    return _cholesky_solve(H + damping * torch.eye(D, dtype=H.dtype, device=H.device), b)


def solve_normal_lm(H: torch.Tensor, b: torch.Tensor, lam_rel) -> torch.Tensor:
    """Marquardt-scaled damped solve: (H + λ·diag(H)) δ = b."""
    d = torch.clamp(torch.diagonal(H), min=1e-12)
    return _cholesky_solve(H + lam_rel * torch.diag(d), b)


def gn_update(J: torch.Tensor, r: torch.Tensor, damping: float = 1e-6,
              w: torch.Tensor | None = None) -> torch.Tensor:
    """One Gauss-Newton step δ = (JᵀJ)⁻¹·(−Jᵀr) from batched rows."""
    H, b = block_hessian(J, r, w)
    return solve_normal(H, b, damping)


def scatter_block(H: torch.Tensor, b: torch.Tensor | None, Hij: torch.Tensor,
                  bi: torch.Tensor | None, i: int, j: int, bs: int):
    """Add a (bs×bs) block into the (i,j) slot of a big dense H, and ``bi``
    into slot i of b (a new H and b; the inputs are not written)."""
    H = H.clone()
    H[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs] += Hij
    if b is not None and bi is not None:
        b = b.clone()
        b[i * bs:(i + 1) * bs] += bi
    return H, b
