"""Block-tridiagonal solves of the pose graph's chain, plain PyTorch only:
the port's ``ops/blocktri.py`` with its CUDA route removed. The
block-Thomas factor and resolve run as loops over the nodes on every
device, with the unrolled 6×6 Cholesky and its ``max(s, 1e-30)`` pivot
clamp."""
from __future__ import annotations

import torch

_PIVOT_FLOOR = 1e-30


class _Views6:
    """A 6×6 factor ``L`` (…,6,6) and a right-hand block ``Y`` (…,6,R),
    worked on in place through views made once: on the host a view costs
    about as much as the op that takes it, and the plain loops reuse one
    pair of scratch tensors for every node."""

    def __init__(self, L: torch.Tensor, Y: torch.Tensor):
        self.L, self.Y = L, Y
        r = range(6)
        self.piv = [L[..., j, j] for j in r]
        self.piv_col = [L[..., j, j, None] for j in r]
        self.col = [L[..., j + 1:, j] for j in r]
        self.col_r = [c[..., :, None] for c in self.col]
        self.col_c = [c[..., None, :] for c in self.col]
        self.trail = [L[..., j + 1:, j + 1:] for j in r]
        self.l_ki = [[L[..., k, i, None] for i in r] for k in r]
        self.row = [Y[..., k, :] for k in r]
        self.row_r = [Y[..., k, None, :] for k in r]
        self.below = [Y[..., k + 1:, :] for k in r]

    def chol_(self) -> torch.Tensor:
        """``_chol6`` in place on L: L[i][j] = (A[i][j] − Σ_{k<j}
        L[i][k]·L[j][k]) / L[j][j], the pivot sqrt(max(s, 1e-30)),
        subtractions in ascending k, column by column."""
        for j in range(6):
            self.piv[j].clamp_(min=_PIVOT_FLOOR).sqrt_()
            if j < 5:
                self.col[j].div_(self.piv_col[j])
                self.trail[j].addcmul_(self.col_r[j], self.col_c[j], value=-1)
        return self.L.tril_()

    def cho_solve_(self) -> torch.Tensor:
        """``_cho_solve6`` in place on Y: y[i] = (B[i] − Σ_{k<i} L[i][k]·y[k])
        / L[i][i] column by column, then x[i] = (y[i] − Σ_{k>i} L[k][i]·x[k])
        / L[i][i] row by row from the last, subtractions in ascending k."""
        for k in range(6):
            self.row[k].div_(self.piv_col[k])
            if k < 5:
                self.below[k].addcmul_(self.col_r[k], self.row_r[k], value=-1)
        for i in reversed(range(6)):
            for k in range(i + 1, 6):
                self.row[i].addcmul_(self.l_ki[k][i], self.row[k], value=-1)
            self.row[i].div_(self.piv_col[i])
        return self.Y


def chol6(A: torch.Tensor) -> torch.Tensor:
    """Unrolled 6×6 Cholesky of ``A`` (…,6,6), lower factor with zeros
    above the diagonal (see :meth:`_Views6.chol_`)."""
    L = A.clone()
    return _Views6(L, L[..., :0]).chol_()


def cho_solve6(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve L·Lᵀ·x = B, B (…,6,R) (see :meth:`_Views6.cho_solve_`)."""
    return _Views6(L, B.clone()).cho_solve_()


def _b_prev(B: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.zeros_like(B[:1]), B[:-1]], dim=0)


def block_tridiag_factor_plain(D: torch.Tensor, B: torch.Tensor):
    """Block Thomas over the nodes in order: S_i = D_i − B_{i−1}ᵀ·C_{i−1},
    L_i = chol6(S_i), C_i = S_i⁻¹·B_i. Returns ``(Lcs, Cs, B_prev)``. Each
    step works in one pair of scratch tensors (~60 launches a node on the
    card)."""
    B_prev = _b_prev(B)
    Lcs, Cs = torch.empty_like(D), torch.empty_like(D)
    W, C = torch.empty_like(D[0]), torch.zeros_like(D[0])  # C: C_{i−1}, then C_i
    v = _Views6(W, C)
    for Di, Bpi, Bi, Li, Ci in zip(D.unbind(0), B_prev.unbind(0), B.unbind(0), Lcs.unbind(0),
                                   Cs.unbind(0)):
        torch.sub(Di, Bpi.transpose(-1, -2) @ C, out=W)
        Li.copy_(v.chol_())
        C.copy_(Bi)
        Ci.copy_(v.cho_solve_())
    return Lcs, Cs, B_prev


def block_tridiag_resolve_plain(factor, rhs: torch.Tensor) -> torch.Tensor:
    """T·X = rhs (N,6,R) from a factor: z_i = cho_solve6(L_i, r_i −
    B_prevᵢᵀ·z_{i−1}) forward, then x_i = z_i − C_i·x_{i+1} backward."""
    Lcs, Cs, B_prev = factor
    X = torch.empty_like(rhs)
    L, z = torch.empty_like(Lcs[0]), torch.zeros_like(rhs[0])  # z: z_{i−1}, then z_i
    v = _Views6(L, z)
    for Li, Bpi, ri, Xi in zip(Lcs.unbind(0), B_prev.unbind(0), rhs.unbind(0), X.unbind(0)):
        L.copy_(Li)
        torch.sub(ri, Bpi.transpose(-1, -2) @ z, out=z)
        Xi.copy_(v.cho_solve_())
    x = torch.zeros_like(rhs[0])
    for Ci, Xi in zip(reversed(Cs.unbind(0)), reversed(X.unbind(0))):
        x = Xi.sub_(Ci @ x)
    return X


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------



def block_tridiag_factor(D: torch.Tensor, B: torch.Tensor):
    """The plain :func:`block_tridiag_factor_plain` on every device."""
    return block_tridiag_factor_plain(D, B)


def block_tridiag_resolve(factor, rhs: torch.Tensor) -> torch.Tensor:
    """The plain :func:`block_tridiag_resolve_plain` on every device."""
    return block_tridiag_resolve_plain(factor, rhs)
