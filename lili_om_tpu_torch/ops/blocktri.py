"""Block-tridiagonal solves of the pose graph's chain (port of
``lili_om_tpu/models/pose_graph.py:_chol6`` … ``block_tridiag_resolve``):
the block-Thomas factorization of the chain's normal matrix T (6×6 blocks)
and its resolve against any number of right-hand columns.

* :func:`chol6` and :func:`cho_solve6` are the JAX package's unrolled 6×6
  Cholesky and triangular solves (``_tri_lower6`` then ``_tri_upper6``),
  batched over leading dims, with the same operations in the same order
  for every entry and the same ``max(s, 1e-30)`` clamp of each pivot. A
  pivot that is not positive therefore gives the JAX result (a tiny pivot,
  then non-finite values that ``_clamp_step`` zeroes), not LAPACK's (an
  unfactored entry left in place and finite garbage). The Cholesky and the
  lower solve are written column by column ("right-looking"), so that one
  tensor op covers a column: every entry still sees its subtractions in
  the JAX order, ascending in k (the upper solve needs a row at a time for
  that order). PyTorch's own ``addcmul_`` may contract a product and its
  subtraction into one FMA.
* :func:`block_tridiag_factor_plain` / :func:`block_tridiag_resolve_plain`
  are the plain versions: loops over the N nodes with the contract of the
  JAX scans (``factor`` returns ``(Lcs, Cs, B_prev)``, ``B[N-1]`` is
  ignored, ``rhs`` is (N,6,R)). They run on the CPU, and on the card only
  under ``device.plain_kernels()``.
* :func:`block_tridiag_factor_cuda` / :func:`block_tridiag_resolve_cuda`
  launch the hand-written kernels of ``csrc/blocktri.cu``: the factor walks
  the chain in one warp, the resolve walks it once forward and once
  backward with one thread per right-hand column. Each is one launch,
  where the plain versions take tens of launches a node.
* :func:`block_tridiag_factor` / :func:`block_tridiag_resolve` are what
  ``models/pose_graph.py`` calls: the kernel for a CUDA tensor (or an
  error), the plain version for a CPU one.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import threading

import torch

from .. import cuda_build
from ..device import use_kernel

# kernel launches since the last reset_launch_counts(), keyed by
# ("blocktri_factor", N, 6, 0) and ("blocktri_resolve", N, R, 0): the
# chain length and the right-hand columns (the kNN counts' 4-tuple form)
LAUNCHES: collections.Counter = collections.Counter()
_LAUNCHES_LOCK = threading.Lock()

# threads (right-hand columns) per block of the resolve kernel (kCols)
RESOLVE_COLS = 128
_PIVOT_FLOOR = 1e-30


def count_launch(*key):
    """One launch at ``key``; the runtime solves from its loop thread."""
    with _LAUNCHES_LOCK:
        LAUNCHES[key] += 1


def reset_launch_counts():
    with _LAUNCHES_LOCK:
        LAUNCHES.clear()


def launch_count(name: str | None = None) -> int:
    return sum(n for key, n in LAUNCHES.items() if name is None or key[0] == name)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


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


@functools.cache
def _library(dtype):
    """The kernels' ctypes functions for ``dtype``, bound once."""
    lib = cuda_build.load("blocktri")
    if lib.lili_btri_resolve_cols() != RESOLVE_COLS:
        raise RuntimeError("csrc/blocktri.cu columns per block differ from ops/blocktri.py")
    sfx = "f32" if dtype == torch.float32 else "f64"
    factor = getattr(lib, f"lili_btri_factor_{sfx}")
    factor.restype = ctypes.c_int
    factor.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_void_p]
    resolve = getattr(lib, f"lili_btri_resolve_{sfx}")
    resolve.restype = ctypes.c_int
    resolve.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
    return factor, resolve


def _check(what: str, *xs, shapes):
    dev, dtype = xs[0].device, xs[0].dtype
    if dev.type != "cuda" or any(x.device != dev for x in xs):
        raise ValueError(f"the CUDA {what} needs every tensor on one CUDA device")
    if dtype not in (torch.float32, torch.float64) or any(x.dtype != dtype for x in xs):
        raise TypeError(f"the CUDA {what} takes float32 or float64 tensors of one type")
    if any(tuple(x.shape) != s for x, s in zip(xs, shapes)):
        raise ValueError(f"the CUDA {what} takes shapes {shapes}, got "
                         f"{[tuple(x.shape) for x in xs]}")
    if not all(x.is_contiguous() for x in xs):
        raise ValueError(f"the CUDA {what} takes contiguous tensors")


def _launched(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"blocktri {what} kernel launch failed: CUDA error {err}")


def launch_factor(D, B, Lcs, Cs):
    """One factor launch on the current stream into ``Lcs``, ``Cs``."""
    _launched(_library(D.dtype)[0](D.data_ptr(), B.data_ptr(), Lcs.data_ptr(), Cs.data_ptr(),
                                   D.shape[0], cuda_build.stream_ptr(D.device)), "factor")


def launch_resolve(Lcs, Cs, B_prev, rhs, X):
    """One resolve launch on the current stream into ``X``."""
    _launched(_library(rhs.dtype)[1](Lcs.data_ptr(), Cs.data_ptr(), B_prev.data_ptr(),
                                     rhs.data_ptr(), X.data_ptr(), rhs.shape[0], rhs.shape[2],
                                     cuda_build.stream_ptr(rhs.device)), "resolve")


def block_tridiag_factor_cuda(D: torch.Tensor, B: torch.Tensor):
    """The factor kernel; the contract of :func:`block_tridiag_factor_plain`."""
    N = D.shape[0] if D.dim() == 3 else -1
    _check("block-tridiagonal factor", D, B, shapes=[(N, 6, 6)] * 2)
    Lcs, Cs = torch.empty_like(D), torch.empty_like(D)
    if N > 0:
        launch_factor(D, B, Lcs, Cs)
        count_launch("blocktri_factor", N, 6, 0)
    return Lcs, Cs, _b_prev(B)


def block_tridiag_resolve_cuda(factor, rhs: torch.Tensor) -> torch.Tensor:
    """The resolve kernel; the contract of :func:`block_tridiag_resolve_plain`."""
    N, R = (rhs.shape[0], rhs.shape[2]) if rhs.dim() == 3 else (-1, -1)
    _check("block-tridiagonal resolve", *factor, rhs, shapes=[(N, 6, 6)] * 3 + [(N, 6, R)])
    X = torch.empty_like(rhs)
    if N > 0 and R > 0:
        launch_resolve(*factor, rhs, X)
        count_launch("blocktri_resolve", N, R, 0)
    return X


def block_tridiag_factor(D: torch.Tensor, B: torch.Tensor):
    """Device-dispatching block-Thomas factorization (see the module
    docstring)."""
    if use_kernel(D):
        return block_tridiag_factor_cuda(D.contiguous(), B.contiguous())
    if D.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no block-tridiagonal factor for device {D.device}")
    return block_tridiag_factor_plain(D, B)


def block_tridiag_resolve(factor, rhs: torch.Tensor) -> torch.Tensor:
    """Device-dispatching resolve of a :func:`block_tridiag_factor`."""
    if use_kernel(rhs):
        return block_tridiag_resolve_cuda(tuple(f.contiguous() for f in factor),
                                          rhs.contiguous())
    if rhs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no block-tridiagonal resolve for device {rhs.device}")
    return block_tridiag_resolve_plain(factor, rhs)
