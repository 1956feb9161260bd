"""Global pose graph (port of ``lili_om_tpu/models/pose_graph.py``): the
replacement for GTSAM/iSAM2 in the loop-closure path.

Fixed-capacity node and factor tensors with validity masks; every factor's
residual and Jacobians from one batched pass, the Jacobians written out
(the JAX package takes them with ``jax.jacfwd`` under ``vmap``; the tests
hold the two against each other). Factors: a prior on node 0,
between factors along the odometry chain, loop between factors with
fitness-scaled noise.

Two solvers of the same Gauss-Newton problem:

* :func:`optimize_graph`, dense (6N)² normal equations — the reference the
  tests hold the other against;
* :func:`optimize_graph_chain`, linear in N: the chain factors make a
  block-tridiagonal T, factored by block Thomas (``ops/blocktri.py``: on
  the card one kernel walks the chain for the factor and one for each
  resolve; on the CPU the plain loops over the nodes, with the JAX
  package's clamped 6×6 Cholesky), and the loop factors a low-rank U·Uᵀ
  handled by the Woodbury identity. ``tol`` ends it once the largest
  per-node step is below ``tol`` (a host sync per iteration).

:func:`solve_graph_incremental` re-solves only the suffix of nodes that an
active loop factor can move, on the graph's own device. The functions are
pure: each returns a new graph.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..factors.lidar import relative_pose_residual
from ..ops import blocktri
from ..solver.gn import solve_normal
from ..utils.math import (exp_so3, hat, pose_relative, quat_conj, quat_mul, quat_normalize,
                          quat_to_rotmat)
from ..utils.metrics import host_read


class PoseGraph(NamedTuple):
    """Fixed-capacity graph state (N nodes, N chain factors, L loop factors)."""

    t: torch.Tensor  # (N,3) node positions
    q: torch.Tensor  # (N,4)
    node_valid: torch.Tensor  # (N,)
    # chain between-factors: factor i connects node i → i+1
    rel_t: torch.Tensor  # (N,3)
    rel_q: torch.Tensor  # (N,4)
    rel_valid: torch.Tensor  # (N,)
    rel_weight: torch.Tensor  # (N,) sqrt-information scale
    # loop factors
    loop_i: torch.Tensor  # (L,) int32
    loop_j: torch.Tensor  # (L,) int32
    loop_t: torch.Tensor  # (L,3) pose of j in i's frame
    loop_q: torch.Tensor  # (L,4)
    loop_valid: torch.Tensor  # (L,)
    loop_weight: torch.Tensor  # (L,)
    n_nodes: torch.Tensor  # () int32
    n_loops: torch.Tensor  # () int32


def _qid(n: int, dtype, dev) -> torch.Tensor:
    q = torch.zeros((n, 4), dtype=dtype, device=dev)
    q[:, 0] = 1.0
    return q


def init_graph(capacity: int, loop_capacity: int = 64, dtype=torch.float32,
               device=None) -> PoseGraph:
    """Empty graph on ``device`` (None = the CUDA device)."""
    dev = resolve_device(device)
    N, L = capacity, loop_capacity
    z = lambda *s: torch.zeros(s, dtype=dtype, device=dev)
    zb = lambda n: torch.zeros((n,), dtype=torch.bool, device=dev)
    zi = lambda *s: torch.zeros(s, dtype=torch.int32, device=dev)
    return PoseGraph(
        t=z(N, 3), q=_qid(N, dtype, dev), node_valid=zb(N),
        rel_t=z(N, 3), rel_q=_qid(N, dtype, dev), rel_valid=zb(N),
        rel_weight=torch.ones((N,), dtype=dtype, device=dev),
        loop_i=zi(L), loop_j=zi(L), loop_t=z(L, 3), loop_q=_qid(L, dtype, dev),
        loop_valid=zb(L), loop_weight=torch.ones((L,), dtype=dtype, device=dev),
        n_nodes=zi(), n_loops=zi(),
    )


def ensure_capacity(g: PoseGraph, n_nodes: int, n_loops: int = 0) -> PoseGraph:
    """A graph whose capacities cover ``n_nodes`` / ``n_loops``, doubling
    when exceeded. Callers grow before :func:`add_node` / :func:`add_loop`
    write: those do not check."""
    N, L = g.t.shape[0], g.loop_i.shape[0]
    newN, newL = N, L
    while newN < n_nodes:
        newN *= 2
    while newL < n_loops:
        newL *= 2
    if newN == N and newL == L:
        return g
    dtype, dev = g.t.dtype, g.t.device

    def pad(a, cap):
        return torch.cat([a, torch.zeros((cap - a.shape[0],) + a.shape[1:], dtype=a.dtype,
                                         device=dev)])

    def qpad(a, cap):
        return torch.cat([a, _qid(cap - a.shape[0], dtype, dev)])

    def wpad(a, cap):
        return torch.cat([a, torch.ones((cap - a.shape[0],), dtype=dtype, device=dev)])

    return g._replace(
        t=pad(g.t, newN), q=qpad(g.q, newN), node_valid=pad(g.node_valid, newN),
        rel_t=pad(g.rel_t, newN), rel_q=qpad(g.rel_q, newN),
        rel_valid=pad(g.rel_valid, newN), rel_weight=wpad(g.rel_weight, newN),
        loop_i=pad(g.loop_i, newL), loop_j=pad(g.loop_j, newL),
        loop_t=pad(g.loop_t, newL), loop_q=qpad(g.loop_q, newL),
        loop_valid=pad(g.loop_valid, newL), loop_weight=wpad(g.loop_weight, newL),
    )


def _row(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-dim index tensor, without a host sync."""
    return x.index_select(0, i.reshape(1))[0]


def add_node(g: PoseGraph, t, q, chain_weight: float = 100.0) -> PoseGraph:
    """Append a node; with a predecessor, also the chain between-factor with
    the measured relative pose."""
    dtype, dev = g.t.dtype, g.t.device
    t, q = t.to(device=dev, dtype=dtype), q.to(device=dev, dtype=dtype)
    n = g.n_nodes.long()
    has_prev = n > 0
    prev = torch.clamp(n - 1, min=0)
    dt, dq = pose_relative(_row(g.t, prev), _row(g.q, prev), t, q)
    qid = _qid(1, dtype, dev)[0]
    true = torch.ones((), dtype=torch.bool, device=dev)
    return g._replace(
        t=g.t.index_put((n,), t), q=g.q.index_put((n,), q),
        node_valid=g.node_valid.index_put((n,), true),
        rel_t=g.rel_t.index_put((prev,), torch.where(has_prev, dt, 0.0)),
        rel_q=g.rel_q.index_put((prev,), torch.where(has_prev, dq, qid)),
        rel_valid=g.rel_valid.index_put((prev,), _row(g.rel_valid, prev) | has_prev),
        rel_weight=g.rel_weight.index_put(
            (prev,), torch.tensor(chain_weight, dtype=dtype, device=dev)),
        n_nodes=g.n_nodes + 1,
    )


def _write_loop(g: PoseGraph, slot: torch.Tensor, i, j, rel_t, rel_q, fitness) -> PoseGraph:
    dtype, dev = g.t.dtype, g.t.device
    w = 1.0 / torch.clamp(torch.as_tensor(fitness, dtype=dtype).to(dev), min=1e-3)
    idx = lambda v: torch.as_tensor(v, dtype=torch.int32).to(dev)
    return g._replace(
        loop_i=g.loop_i.index_put((slot,), idx(i)),
        loop_j=g.loop_j.index_put((slot,), idx(j)),
        loop_t=g.loop_t.index_put((slot,), rel_t.to(device=dev, dtype=dtype)),
        loop_q=g.loop_q.index_put((slot,), rel_q.to(device=dev, dtype=dtype)),
        loop_valid=g.loop_valid.index_put((slot,), torch.ones((), dtype=torch.bool,
                                                              device=dev)),
        loop_weight=g.loop_weight.index_put((slot,), w),
    )


def add_loop(g: PoseGraph, i, j, rel_t, rel_q, fitness) -> PoseGraph:
    """Add a loop-closure between-factor; its weight is 1/fitness (noise =
    fitness·I₆)."""
    g = _write_loop(g, g.n_loops.long(), i, j, rel_t, rel_q, fitness)
    return g._replace(n_loops=g.n_loops + 1)


def set_loop(g: PoseGraph, slot: int, i, j, rel_t, rel_q, fitness) -> PoseGraph:
    """Overwrite loop factor ``slot`` in place (same-pair replacement);
    ``n_loops`` is unchanged."""
    return _write_loop(g, torch.tensor(slot, device=g.t.device), i, j, rel_t, rel_q,
                       fitness)


def _between_block(t_i, q_i, t_j, q_j, dt, dq, w):
    """Residual + Jacobians of between-factors, batched over leading dims.
    Returns (r (...,6), Ji (...,6,6), Jj (...,6,6)), the Jacobians taken
    with respect to each node's retraction tangent (δt, δθ) at zero, as
    the JAX package takes them with ``jax.jacfwd``.

    Written out: with R = R(q̂_i), v = t_j − t_i, e = (δq⁻¹ ⊗ q̂_i⁻¹ ⊗ q̂_j)
    normalized and â = δq⁻¹ normalized, the retraction moves R to R·Exp(δθ),
    and each quaternion step is orthogonal to its quaternion, so the
    normalizations drop out to first order:

        Ji = w·[[−Rᵀ, [Rᵀv]×], [0, −(e_w·I − [e_v]×)·R(â)]]
        Jj = w·[[ Rᵀ,   0   ], [0,   e_w·I + [e_v]×      ]]

    (autodiff under ``vmap`` costs tens of ms of host dispatch per call)."""
    w = torch.as_tensor(w, dtype=t_i.dtype, device=t_i.device)
    n_i, n_j = quat_normalize(q_i), quat_normalize(q_j)
    r = w[..., None] * relative_pose_residual(t_i, n_i, t_j, n_j, dt, dq)
    Rt = quat_to_rotmat(n_i).transpose(-1, -2)
    e = quat_normalize(quat_mul(quat_conj(dq), quat_mul(quat_conj(n_i), n_j)))
    ew = e[..., :1, None] * torch.eye(3, dtype=t_i.dtype, device=t_i.device)
    He = hat(e[..., 1:])
    Ra = quat_to_rotmat(quat_normalize(quat_conj(dq)))
    Z = torch.zeros_like(Rt)
    Ji = torch.cat([torch.cat([-Rt, hat((Rt @ (t_j - t_i)[..., None])[..., 0])], dim=-1),
                    torch.cat([Z, -((ew - He) @ Ra)], dim=-1)], dim=-2)
    Jj = torch.cat([torch.cat([Rt, Z], dim=-1), torch.cat([Z, ew + He], dim=-1)], dim=-2)
    return r, w[..., None, None] * Ji, w[..., None, None] * Jj


def _clamp_step(d, max_t: float = 1.0, max_r: float = 0.3):
    """Per-node trust region: translation and rotation step norms clamped,
    non-finite steps zeroed. d: (N,6)."""
    d = torch.where(torch.isfinite(d), d, 0.0)
    dt, dr = d[:, :3], d[:, 3:]
    tn = torch.linalg.norm(dt, dim=-1, keepdim=True)
    rn = torch.linalg.norm(dr, dim=-1, keepdim=True)
    dt = dt * torch.clamp(max_t / torch.clamp(tn, min=1e-12), max=1.0)
    dr = dr * torch.clamp(max_r / torch.clamp(rn, min=1e-12), max=1.0)
    return torch.cat([dt, dr], dim=-1)


def _factors(g: PoseGraph, t, q):
    """Masked (r, Ji, Jj) of the chain factors and of the loop factors."""
    N = g.t.shape[0]
    idx = torch.arange(N, device=t.device)
    chain_j = torch.clamp(idx + 1, max=N - 1)
    rc, Jci, Jcj = _between_block(t, q, t[chain_j], q[chain_j], g.rel_t, g.rel_q,
                                  g.rel_weight)
    mc = g.rel_valid & (idx + 1 < g.n_nodes)
    li, lj = g.loop_i.long(), g.loop_j.long()
    rl, Jli, Jlj = _between_block(t[li], q[li], t[lj], q[lj], g.loop_t, g.loop_q,
                                  g.loop_weight)
    ml = g.loop_valid
    mask = lambda m, *xs: [torch.where(m.reshape((-1,) + (1,) * (x.dim() - 1)), x, 0.0)
                           for x in xs]
    return (idx, chain_j, *mask(mc, rc, Jci, Jcj)), (li, lj, *mask(ml, rl, Jli, Jlj))


def _anchor_freeze(g: PoseGraph, prior_weight: float) -> torch.Tensor:
    """(N,) diagonal: the prior on node 0, 1e12 on invalid (frozen) nodes."""
    a = (~g.node_valid).to(g.t.dtype) * 1e12
    a[0] += prior_weight
    return a


def _retract(t, q, d):
    return t + d[:, :3], quat_normalize(quat_mul(q, exp_so3(d[:, 3:6])))


def optimize_graph(g: PoseGraph, n_iters: int = 10, damping: float = 1e-6,
                   prior_weight: float = 1e4) -> PoseGraph:
    """Batched GN over all node tangents with dense (6N)² normal equations.
    Node 0 is held by a strong prior; invalid nodes are frozen."""
    N = g.t.shape[0]
    D = 6 * N
    dtype, dev = g.t.dtype, g.t.device
    off = torch.arange(6, device=dev)
    diag = torch.repeat_interleave(_anchor_freeze(g, prior_weight), 6)
    t, q = g.t, g.q
    for _ in range(n_iters):
        H = torch.zeros((D, D), dtype=dtype, device=dev)
        gv = torch.zeros((D,), dtype=dtype, device=dev)
        for i_nodes, j_nodes, r, Ji, Jj in _factors(g, t, q):
            bi, bj = i_nodes * 6, j_nodes * 6
            rows = lambda b: (b[:, None, None] + off[None, :, None]).expand(-1, 6, 6)
            cols = lambda b: (b[:, None, None] + off[None, None, :]).expand(-1, 6, 6)
            Hij = torch.einsum("fab,fac->fbc", Ji, Jj)
            for rb, cb, B in ((bi, bi, torch.einsum("fab,fac->fbc", Ji, Ji)),
                              (bj, bj, torch.einsum("fab,fac->fbc", Jj, Jj)),
                              (bi, bj, Hij), (bj, bi, Hij.transpose(-1, -2))):
                H.index_put_((rows(rb), cols(cb)), B, accumulate=True)
            gv.index_put_(((bi[:, None] + off[None, :]),),
                          torch.einsum("fab,fa->fb", Ji, r), accumulate=True)
            gv.index_put_(((bj[:, None] + off[None, :]),),
                          torch.einsum("fab,fa->fb", Jj, r), accumulate=True)
        H = H + torch.diag(diag)
        delta = solve_normal(H, -gv, damping)
        t, q = _retract(t, q, _clamp_step(delta.reshape(N, 6)))
    return g._replace(t=t, q=q)


# ---------------------------------------------------------------------------
# Linear-time solver: block-tridiagonal chain + Woodbury loop updates
# ---------------------------------------------------------------------------


def block_tridiag_factor(D, B):
    """Block-Thomas factorization of the block-tridiagonal SPD T (diagonal
    blocks ``D`` (N,6,6), super-diagonal ``B`` (N,6,6) coupling i↔i+1;
    B[N-1] ignored). Returns ``(Lcs, Cs, B_prev)``, reusable for any number
    of right-hand sides (:func:`block_tridiag_resolve`). The kernel on a
    CUDA tensor, the plain loop on a CPU one (``ops/blocktri.py``)."""
    return blocktri.block_tridiag_factor(D, B)


def block_tridiag_resolve(factor, rhs):
    """Solve T·X = rhs (N,6,R) from a :func:`block_tridiag_factor`."""
    return blocktri.block_tridiag_resolve(factor, rhs)


def block_tridiag_solve(D, B, rhs):
    """Solve the block-tridiagonal SPD system T·X = rhs (factor + resolve)."""
    return block_tridiag_resolve(block_tridiag_factor(D, B), rhs)


def _shift(a):
    return torch.cat([torch.zeros_like(a[:1]), a[:-1]], dim=0)


def _chain_system(g: PoseGraph, t, q, diag_add):
    """The GN normal equations at (t, q) as :func:`optimize_graph_chain`
    solves them: the chain's block-tridiagonal T (diagonal ``D``,
    super-diagonal ``Bblk``, ``diag_add`` on each diagonal), the gradient
    ``gv`` (N,6) of every factor, and the loop factors' endpoints and
    Jacobians ``(li, lj, Jli, Jlj)`` that make the low-rank U."""
    (_, _, rc, Jci, Jcj), (li, lj, rl, Jli, Jlj) = _factors(g, t, q)
    eye6 = torch.eye(6, dtype=t.dtype, device=t.device)
    D = (torch.einsum("fab,fac->fbc", Jci, Jci)
         + _shift(torch.einsum("fab,fac->fbc", Jcj, Jcj))
         + eye6[None] * diag_add[:, None, None])
    Bblk = torch.einsum("fab,fac->fbc", Jci, Jcj)  # couples i, i+1
    gv = torch.einsum("fab,fa->fb", Jci, rc) + _shift(torch.einsum("fab,fa->fb", Jcj, rc))
    gv = gv.index_add(0, li, torch.einsum("fab,fa->fb", Jli, rl))
    gv = gv.index_add(0, lj, torch.einsum("fab,fa->fb", Jlj, rl))
    return D, Bblk, gv, (li, lj, Jli, Jlj)


def _loop_columns(N: int, loops):
    """U's columns as a dense (N,6,6L): loop l's only nonzero node blocks
    sit at rows li[l] and lj[l]."""
    li, lj, Jli, Jlj = loops
    L = li.shape[0]
    U = torch.zeros((N, L, 6, 6), dtype=Jli.dtype, device=Jli.device)
    cidx = torch.arange(L, device=Jli.device)
    U.index_put_((li, cidx), Jli.transpose(-1, -2), accumulate=True)
    U.index_put_((lj, cidx), Jlj.transpose(-1, -2), accumulate=True)
    return U.permute(0, 2, 1, 3).reshape(N, 6, 6 * L)


def optimize_graph_chain(g: PoseGraph, n_iters: int = 10, damping: float = 1e-6,
                         prior_weight: float = 1e4, tol: float = 0.0) -> PoseGraph:
    """GN with the linear-time chain + Woodbury solve; the same problem as
    :func:`optimize_graph`. ``tol`` > 0: stop once the largest per-node
    tangent step drops below ``tol`` (one host sync per iteration); 0 runs
    the fixed ``n_iters``. U's 6L columns are resolved against the factor
    in one shot (the JAX package's ``loop_chunk`` opt-in is not ported:
    ROADMAP §A)."""
    N, L = g.t.shape[0], g.loop_i.shape[0]
    dtype, dev = g.t.dtype, g.t.device
    diag_add = _anchor_freeze(g, prior_weight) + damping

    def gn_iter(t, q):
        D, Bblk, gv, loops = _chain_system(g, t, q, diag_add)
        factor = block_tridiag_factor(D, Bblk)
        y0 = block_tridiag_resolve(factor, -gv[:, :, None])[..., 0]
        if L == 0:
            x = y0
        else:
            li, lj, Jli, Jlj = loops
            Yu = block_tridiag_resolve(factor, _loop_columns(N, loops))
            K = torch.eye(6 * L, dtype=dtype, device=dev) + (
                torch.einsum("lba,las->lbs", Jli, Yu[li])
                + torch.einsum("lba,las->lbs", Jlj, Yu[lj])).reshape(6 * L, 6 * L)
            Uy = (torch.einsum("lba,la->lb", Jli, y0[li])
                  + torch.einsum("lba,la->lb", Jlj, y0[lj])).reshape(-1)
            w = torch.linalg.solve_ex(K, Uy).result
            x = y0 - torch.einsum("nas,s->na", Yu, w)
        x = _clamp_step(x)
        t, q = _retract(t, q, x)
        return t, q, torch.max(torch.linalg.norm(x, dim=-1))

    t, q = g.t, g.q
    for _ in range(n_iters):
        t, q, step = gn_iter(t, q)
        if tol > 0.0:
            with host_read("graph_gn"):
                go_on = bool(step > tol)
            if not go_on:
                break
    return g._replace(t=t, q=q)


# ---------------------------------------------------------------------------
# Affected-suffix incremental solve
# ---------------------------------------------------------------------------
#
# Every active loop factor lives in the node suffix [base+1, n), base+1 being
# the earliest endpoint of any loop factor; the prefix [0, base] is an
# anchored chain at its previous optimum, which a re-solve cannot move. The
# suffix is extracted as its own graph (node 0 = base, held by the prior
# anchor at its current pose), solved with a warm start and the early exit,
# and spliced back.


def affected_base(loop_pairs) -> int:
    """Anchor node of the suffix re-solve: one before the earliest endpoint
    of any loop factor; -1 when there is none (nothing to solve)."""
    if not loop_pairs:
        return -1
    return max(0, min(min(i, j) for i, j in loop_pairs) - 1)


def _pow2_at_least(x: int, floor: int = 64) -> int:
    c = floor
    while c < x:
        c *= 2
    return c


def extract_suffix(g: PoseGraph, base: int, n: int) -> PoseGraph:
    """Host-side: the subgraph over nodes [base, n) with indices shifted by
    −base, on the graph's device. Capacities round up to powers of two. All
    valid loop endpoints must be ≥ base (true when ``base`` comes from
    :func:`affected_base`)."""
    length = n - base
    with host_read("graph_suffix"):
        n_loops = int(g.n_loops)
        h = {k: v.cpu().numpy() for k, v in g._asdict().items()}
    sub = {k: v.cpu().numpy().copy() for k, v in init_graph(
        _pow2_at_least(length), _pow2_at_least(max(n_loops, 1), floor=8),
        dtype=g.t.dtype, device="cpu")._asdict().items()}
    for k in ("t", "q", "node_valid", "rel_t", "rel_q", "rel_valid", "rel_weight"):
        sub[k][:length] = h[k][base:n]
    sub["rel_valid"][length - 1:] = False  # no chain factor past the end
    li = h["loop_i"][:n_loops] - base
    lj = h["loop_j"][:n_loops] - base
    lv = h["loop_valid"][:n_loops]
    if n_loops and lv.any():
        assert int(min(li[lv].min(), lj[lv].min())) >= 0, \
            "suffix base must precede every active loop endpoint"
    sub["loop_i"][:n_loops] = np.maximum(li, 0)
    sub["loop_j"][:n_loops] = np.maximum(lj, 0)
    for k in ("loop_t", "loop_q", "loop_valid", "loop_weight"):
        sub[k][:n_loops] = h[k][:n_loops]
    sub["n_nodes"] = np.asarray(length, np.int32)
    sub["n_loops"] = np.asarray(n_loops, np.int32)
    return PoseGraph(**{k: torch.as_tensor(v).to(g.t.device) for k, v in sub.items()})


def solve_graph_incremental(g: PoseGraph, n: int, loop_pairs, n_iters: int = 10,
                            tol: float = 1e-3, damping: float = 1e-6):
    """Suffix-restricted, early-exit global solve on the graph's device.
    Returns host numpy (t (n,3), q (n,4)): the corrected poses of nodes
    [0, n), the prefix unchanged. A pure function of ``g``."""
    with host_read("graph_suffix"):
        t = g.t[:n].cpu().numpy().copy()
        q = g.q[:n].cpu().numpy().copy()
    base = affected_base(loop_pairs)
    if base < 0:  # no loop factors: the chain is at its optimum
        return t, q
    sub = extract_suffix(g, base, n)
    # a stiffer anchor than the full-graph prior: node 0 of the suffix
    # stands in for the whole solved prefix
    solved = optimize_graph_chain(sub, n_iters=n_iters, tol=tol, damping=damping,
                                  prior_weight=1e6)
    with host_read("graph_suffix"):
        t[base:] = solved.t[:n - base].cpu().numpy()
        q[base:] = solved.q[:n - base].cpu().numpy()
    return t, q
