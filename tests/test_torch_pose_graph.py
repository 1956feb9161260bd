"""models/pose_graph: the port's graph building and both solvers against the
JAX package's, in float64, on the graphs of tests/test_pose_graph.py.

Tolerance 1e-9: the same Gauss-Newton problem with the same Jacobians
(``jax.jacfwd`` through the retraction on the JAX side, the same
derivatives written out in the port, equal to ~1e-15); what differs is the
order of the sums (the 6×6 Cholesky and triangular solves take the JAX
package's operations in its order, ``ops/blocktri.py``), a few ulps per
step on well-conditioned systems.

The block-tridiagonal factor and resolve are also held on their own, their
non-positive pivot included, and, on the card, the CUDA kernels of
``csrc/blocktri.cu`` against their plain versions.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lili_om_tpu.models import pose_graph as JG
from lili_om_tpu.utils.math import exp_so3 as jexp
from lili_om_tpu.utils.math import pose_relative as jrel
from lili_om_tpu.utils.math import quat_mul as jmul
from lili_om_tpu.utils.math import quat_normalize as jnorm
from lili_om_tpu.utils.math import quat_rotate as jrot
from lili_om_tpu_torch import interop
from lili_om_tpu_torch.models import pose_graph as TG
from lili_om_tpu_torch.ops import blocktri as BT
from test_torch_common import CPU, assert_close_dicts, npy, tree_dict, tt

TOL = 1e-9


def _to_port(g):
    return interop.pose_graph_from_numpy(tree_dict(g), dtype=torch.float64, device=CPU)


def _assert_graphs(jg, tg, tol=TOL):
    assert_close_dicts(tree_dict(jg), tree_dict(tg), rtol=tol, atol=tol)


def square_trajectory(n_side=5, side=10.0):
    ts, qs, yaw, pos = [], [], 0.0, np.zeros(3)
    for _ in range(4):
        for _ in range(n_side):
            ts.append(pos.copy())
            qs.append(np.asarray(jexp(jnp.array([0.0, 0.0, yaw]))))
            pos = pos + np.array([np.cos(yaw), np.sin(yaw), 0.0]) * (side / n_side)
        yaw += np.pi / 2
    return np.stack(ts), np.stack(qs)


def drifted_square():
    """The drifted square of tests/test_pose_graph.py with its loop factor,
    built on both sides node by node."""
    ts, qs = square_trajectory()
    n = len(ts)
    jg = JG.init_graph(32, loop_capacity=4, dtype=jnp.float64)
    tg = TG.init_graph(32, loop_capacity=4, dtype=torch.float64, device=CPU)
    t_d, q_d = jnp.asarray(ts[0]), jnp.asarray(qs[0])
    drift = jexp(jnp.array([0.0, 0.0, 0.004]))
    for k in range(n):
        if k:
            dt, dq = jrel(jnp.asarray(ts[k - 1]), jnp.asarray(qs[k - 1]),
                          jnp.asarray(ts[k]), jnp.asarray(qs[k]))
            t_d = t_d + jrot(q_d, dt)
            q_d = jnorm(jmul(q_d, jnorm(jmul(dq, drift))))
        jg = JG.add_node(jg, t_d, q_d)
        tg = TG.add_node(tg, tt(t_d), tt(q_d))
    rel_t, rel_q = jrel(jnp.asarray(ts[-1]), jnp.asarray(qs[-1]),
                        jnp.asarray(ts[0]), jnp.asarray(qs[0]))
    jg = JG.add_loop(jg, n - 1, 0, rel_t, rel_q, jnp.asarray(0.05))
    tg = TG.add_loop(tg, n - 1, 0, tt(rel_t), tt(rel_q), 0.05)
    return jg, tg, ts


def noisy_graph(n=24, n_loops=2, seed=7, loop_capacity=4):
    """tests/test_pose_graph.py's random chain with loops, perturbed."""
    rng = np.random.default_rng(seed)
    g = JG.init_graph(32, loop_capacity=loop_capacity, dtype=jnp.float64)
    t, qs = np.zeros(3), [np.array([1.0, 0, 0, 0])]
    for i in range(n):
        g = JG.ensure_capacity(g, i + 1)
        g = JG.add_node(g, jnp.asarray(t), jnp.asarray(qs[-1]))
        t = t + rng.normal(size=3) * 0.5
        qs.append(np.asarray(jnorm(jmul(jnp.asarray(qs[-1]),
                                        jexp(jnp.asarray(rng.normal(size=3) * 0.1))))))
    for l in range(n_loops):
        g = JG.add_loop(g, n - 1 - l, 2 + l, jnp.asarray(rng.normal(size=3) * 0.1),
                        jnp.asarray([1.0, 0, 0, 0], jnp.float64), 0.05)
    return g._replace(t=g.t + jnp.asarray(rng.normal(size=g.t.shape) * 0.05))


def test_building_matches_jax():
    """init_graph, add_node (chain factors), add_loop: the same graph."""
    jg, tg, _ = drifted_square()
    _assert_graphs(jg, tg, tol=1e-12)
    assert int(tg.n_nodes) == 20 and int(tg.n_loops) == 1


def test_ensure_capacity_and_set_loop_match_jax():
    jg, tg, _ = drifted_square()
    jg, tg = JG.ensure_capacity(jg, 40, 5), TG.ensure_capacity(tg, 40, 5)
    assert tg.t.shape[0] == 64 and tg.loop_i.shape[0] == 8
    rt, rq = jnp.array([0.1, -0.2, 0.3]), jnorm(jnp.array([1.0, 0.1, 0.0, -0.1]))
    jg = JG.set_loop(jg, 0, 17, 2, rt, rq, jnp.asarray(0.2))
    tg = TG.set_loop(tg, 0, 17, 2, tt(rt), tt(rq), 0.2)
    _assert_graphs(jg, tg, tol=1e-12)
    assert TG.ensure_capacity(tg, 10) is tg


def test_between_block_jacobians_match_jax():
    """The between factor's residual and its two 6×6 Jacobians (jacfwd
    through the retraction in JAX, written out in the port)."""
    rng = np.random.default_rng(3)
    args = [rng.normal(size=3), np.asarray(jnorm(jnp.asarray(rng.normal(size=4)))),
            rng.normal(size=3), np.asarray(jnorm(jnp.asarray(rng.normal(size=4)))),
            rng.normal(size=3), np.asarray(jnorm(jnp.asarray(rng.normal(size=4)))), 2.5]
    jr = JG._between_block(*[jnp.asarray(a) for a in args])
    tr = TG._between_block(*[torch.as_tensor(a, dtype=torch.float64) for a in args])
    for a, b in zip(jr, tr):
        np.testing.assert_allclose(npy(b), np.asarray(a), rtol=1e-12, atol=1e-12)


def test_between_block_batched_non_unit_matches_jax():
    """A batch of factors with quaternions off the unit sphere (the written-out
    Jacobians assume only what the retraction gives: the normalizations drop
    out to first order) against JAX's vmap of jacfwd."""
    rng = np.random.default_rng(5)
    n = 7
    quat = lambda: rng.normal(size=(n, 4)) * rng.uniform(0.5, 2.0, size=(n, 1))
    args = [rng.normal(size=(n, 3)), quat(), rng.normal(size=(n, 3)), quat(),
            rng.normal(size=(n, 3)), quat(), rng.uniform(0.5, 3.0, size=n)]
    jr = JG._between_batch(*[jnp.asarray(a) for a in args])
    tr = TG._between_block(*[torch.as_tensor(a, dtype=torch.float64) for a in args])
    for a, b in zip(jr, tr):
        # 1e-12: different float64 expressions of the same derivatives
        np.testing.assert_allclose(npy(b), np.asarray(a), rtol=1e-12, atol=1e-12)


def test_clamp_step_matches_jax():
    d = np.random.default_rng(4).normal(size=(16, 6)) * 2.0
    d[3, 1] = np.nan
    np.testing.assert_allclose(npy(TG._clamp_step(tt(d))), np.asarray(JG._clamp_step(d)),
                               rtol=1e-14, atol=1e-14)


def test_dense_solver_matches_jax():
    jg, tg, ts = drifted_square()
    j2, t2 = JG.optimize_graph(jg, n_iters=15), TG.optimize_graph(tg, n_iters=15)
    np.testing.assert_allclose(npy(t2.t), np.asarray(j2.t), atol=TOL)
    np.testing.assert_allclose(npy(t2.q), np.asarray(j2.q), atol=TOL)
    # and it closes the loop, as the JAX test asserts
    n = len(ts)
    err_after = np.linalg.norm(npy(t2.t[:n]) - ts, axis=1)
    err_before = np.linalg.norm(npy(tg.t[:n]) - ts, axis=1)
    assert err_after.mean() < 0.5 * err_before.mean()


@pytest.mark.parametrize(
    "n_loops,tol,loop_cap",
    [(2, 0.0, 4), (0, 0.0, 4), (2, 1e-3, 4), (5, 0.0, 8)],
    ids=["loops", "chain_only", "loops_tol", "L8_one_shot"])
def test_chain_solver_matches_jax(n_loops, tol, loop_cap):
    """optimize_graph_chain (block Thomas + Woodbury), with and without
    loops (five of eight slots, three unused) and with the step-norm early
    exit, against the JAX chain solver; and, at a fixed iteration count,
    against the port's dense solver."""
    jg = noisy_graph(n_loops=n_loops, loop_capacity=loop_cap)
    tg = _to_port(jg)
    j2 = JG.optimize_graph_chain(jg, n_iters=8, tol=tol)
    t2 = TG.optimize_graph_chain(tg, n_iters=8, tol=tol)
    np.testing.assert_allclose(npy(t2.t), np.asarray(j2.t), atol=TOL)
    np.testing.assert_allclose(npy(t2.q), np.asarray(j2.q), atol=TOL)
    if tol == 0.0:
        td = TG.optimize_graph(tg, n_iters=8)
        np.testing.assert_allclose(npy(t2.t), npy(td.t), atol=TOL)


def _tridiag_case(N=12, R=3, seed=11):
    """(D, B, rhs) of a well-conditioned block-tridiagonal SPD system."""
    rng = np.random.default_rng(seed)
    Bs = rng.normal(size=(N, 6, 6)) * 0.1
    Ds = np.stack([np.eye(6) * 4 + rng.normal(size=(6, 6)) * 0.05 for _ in range(N)])
    Ds = 0.5 * (Ds + Ds.transpose(0, 2, 1))
    return Ds, Bs, rng.normal(size=(N, 6, R))


def test_block_tridiag_solve_matches_jax_and_numpy():
    Ds, Bs, rhs = _tridiag_case()
    N = Ds.shape[0]
    T = np.zeros((6 * N, 6 * N))
    for i in range(N):
        T[6 * i:6 * i + 6, 6 * i:6 * i + 6] = Ds[i]
        if i + 1 < N:
            T[6 * i:6 * i + 6, 6 * i + 6:6 * i + 12] = Bs[i]
            T[6 * i + 6:6 * i + 12, 6 * i:6 * i + 6] = Bs[i].T
    X = npy(TG.block_tridiag_solve(tt(Ds), tt(Bs), tt(rhs)))
    np.testing.assert_allclose(X, np.asarray(JG.block_tridiag_solve(Ds, Bs, rhs)),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(X.reshape(6 * N, 3), np.linalg.solve(T, rhs.reshape(-1, 3)),
                               rtol=1e-8, atol=1e-8)


# float64: the same operations in the same order but for the 6-term
# products' summation (torch's matmul against XLA's dot), a few ulps of the
# O(1) entries. float32: the jitted JAX scan and the port's op-by-op loop
# round differently (fused products, another summation order), ~1e-7 of
# the entries per step over 12 steps of a well-conditioned chain.
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 1e-4)],
                         ids=["f64", "f32"])
def test_block_tridiag_factor_and_resolve_match_jax(dtype, tol):
    """The batched 6×6 Cholesky and solve, the factor's Lcs and Cs, its
    B_prev, and the resolve of a factor, each held on its own against the
    JAX functions and scans (N = 12)."""
    Ds, Bs, rhs = _tridiag_case(R=5)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    jL = JG._chol6(jnp.asarray(Ds, jdt))
    tL = BT.chol6(tt(Ds, dtype))
    np.testing.assert_allclose(npy(tL), np.asarray(jL), rtol=tol, atol=tol)
    np.testing.assert_allclose(npy(BT.cho_solve6(tL, tt(Bs, dtype))),
                               np.asarray(JG._cho_solve6(jL, jnp.asarray(Bs, jdt))),
                               rtol=tol, atol=tol)
    jf = JG.block_tridiag_factor(jnp.asarray(Ds, jdt), jnp.asarray(Bs, jdt))
    tf = BT.block_tridiag_factor(tt(Ds, dtype), tt(Bs, dtype))
    for name, a, b in zip(("Lcs", "Cs", "B_prev"), jf, tf):
        assert b.dtype == dtype and b.shape == (12, 6, 6), name
        np.testing.assert_allclose(npy(b), np.asarray(a), rtol=tol, atol=tol, err_msg=name)
    assert not npy(tf[0])[:, np.triu_indices(6, 1)[0], np.triu_indices(6, 1)[1]].any()
    jx = JG.block_tridiag_resolve(jf, jnp.asarray(rhs, jdt))
    tx = BT.block_tridiag_resolve(tf, tt(rhs, dtype))
    np.testing.assert_allclose(npy(tx), np.asarray(jx), rtol=tol, atol=tol)


def _pivot_case(N=4):
    """(D, B, rhs) whose node-2 block meets a pivot of -1 in its Cholesky."""
    D = np.stack([4.0 * np.eye(6)] * N)
    D[2, 3, 3] = -1.0
    B = 0.1 * np.random.default_rng(0).normal(size=(N, 6, 6))
    rhs = np.random.default_rng(1).normal(size=(N, 6, 1))
    return D, B, rhs


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_block_tridiag_nonpositive_pivot_matches_jax(dtype):
    """A diagonal block whose Cholesky meets a pivot of -1 (node 2): the
    JAX package clamps it to sqrt(1e-30) and the solve turns non-finite,
    which ``_clamp_step`` turns into the zero step, so no node moves. The
    port takes the same clamp (LAPACK's ``cholesky_ex`` would leave the
    entry unfactored and give finite garbage, a step applied up to 1 m and
    0.3 rad a node): non-finite at the same nodes, the zero step in both,
    in float64 and in the soak's float32."""
    D, B, rhs = _pivot_case()
    N = D.shape[0]
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    jD, jB, jr = (jnp.asarray(a, jdt) for a in (D, B, rhs))
    jx = np.asarray(JG.block_tridiag_solve(jD, jB, jr))
    tx = npy(TG.block_tridiag_solve(tt(D, dtype), tt(B, dtype), tt(rhs, dtype)))
    np.testing.assert_array_equal(np.isfinite(npy(BT.chol6(tt(D, dtype)))),
                                  np.isfinite(np.asarray(JG._chol6(jD))))
    j_bad = ~np.isfinite(jx).reshape(N, -1).all(axis=1)
    assert j_bad.any()
    np.testing.assert_array_equal(~np.isfinite(tx).reshape(N, -1).all(axis=1), j_bad)
    np.testing.assert_array_equal(np.isfinite(tx), np.isfinite(jx))
    j_step = np.asarray(JG._clamp_step(jnp.asarray(jx[..., 0])))
    t_step = npy(TG._clamp_step(tt(tx[..., 0], dtype)))
    assert not j_step.any() and not t_step.any()


def test_block_tridiag_cpu_takes_the_plain_version():
    """The dispatchers: a CPU tensor takes the plain loops (the same values)
    and counts no kernel launch; the kernel wrappers refuse CPU tensors."""
    Ds, Bs, rhs = _tridiag_case(N=5, R=2)
    D, B, r = tt(Ds), tt(Bs), tt(rhs)
    BT.reset_launch_counts()
    f = BT.block_tridiag_factor(D, B)
    x = BT.block_tridiag_resolve(f, r)
    assert BT.launch_count() == 0 and not BT.LAUNCHES
    fp = BT.block_tridiag_factor_plain(D, B)
    for a, b in zip(f, fp):
        assert torch.equal(a, b)
    assert torch.equal(x, BT.block_tridiag_resolve_plain(fp, r))
    with pytest.raises(ValueError):
        BT.block_tridiag_factor_cuda(D, B)
    with pytest.raises(ValueError):
        BT.block_tridiag_resolve_cuda(fp, r)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode "
                    "(chip_smoke.py holds them against the plain versions on the card)")
    return torch.device("cuda")


# the kernels take the plain versions' operations in their order, but sum
# the 6-term products as FMA chains: float32 1e-5 and float64 1e-12 of the
# largest entry over a 300-node chain
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_cuda_kernels_match_plain(cuda, dtype, tol):
    """On the card: the factor and the resolve kernels (more columns than a
    block holds) against the plain versions, a launch counted each."""
    Ds, Bs, rhs = _tridiag_case(N=300, R=BT.RESOLVE_COLS + 5, seed=3)
    D, B, r = (tt(a, dtype).to(cuda) for a in (Ds, Bs, rhs))
    BT.reset_launch_counts()
    fk = BT.block_tridiag_factor(D, B)
    xk = BT.block_tridiag_resolve(fk, r)
    torch.cuda.synchronize()
    assert BT.launch_count("blocktri_factor") == 1 and BT.launch_count("blocktri_resolve") == 1
    fp = BT.block_tridiag_factor_plain(D, B)
    xp = BT.block_tridiag_resolve_plain(fp, r)
    for a, b in list(zip(fk, fp)) + [(xk, xp)]:
        assert float((a - b).abs().max()) <= tol * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_cuda_kernels_nonpositive_pivot_match_plain(cuda, dtype, tol):
    """On the card, the pivot case of the CPU test: the kernels' clamp gives
    the plain version's non-finite entries (so JAX's) in Lcs, Cs and the
    solve, its finite entries within the tolerance above, and the zero
    step after ``_clamp_step``."""
    D, B, r = (tt(a, dtype).to(cuda) for a in _pivot_case())
    fk = BT.block_tridiag_factor(D, B)
    xk = BT.block_tridiag_resolve(fk, r)
    fp = BT.block_tridiag_factor_plain(D, B)
    xp = BT.block_tridiag_resolve_plain(fp, r)
    assert not bool(torch.isfinite(xp).all())
    for a, b in list(zip(fk[:2], fp[:2])) + [(xk, xp)]:
        fin = torch.isfinite(b)
        assert torch.equal(torch.isfinite(a), fin)
        assert float((a - b)[fin].abs().max()) <= tol * float(b[fin].abs().max())
    step_k, step_p = TG._clamp_step(xk[..., 0]), TG._clamp_step(xp[..., 0])
    assert not bool(step_k.any()) and not bool(step_p.any())


def test_extract_suffix_matches_jax():
    jg = noisy_graph()
    base = JG.affected_base([(23, 2), (22, 3)])
    assert base == TG.affected_base([(23, 2), (22, 3)]) == 1
    assert TG.affected_base([]) == -1
    _assert_graphs(JG.extract_suffix(jg, base, 24), TG.extract_suffix(_to_port(jg), base, 24),
                   tol=0.0)


@pytest.mark.parametrize("pairs", [[(23, 2), (22, 3)], []], ids=["loops", "no_loops"])
def test_solve_graph_incremental_matches_jax(pairs):
    jg = noisy_graph(n_loops=len(pairs))
    jt, jq = JG.solve_graph_incremental(jg, 24, pairs, n_iters=10, tol=1e-3)
    tt_, tq = TG.solve_graph_incremental(_to_port(jg), 24, pairs, n_iters=10, tol=1e-3)
    assert isinstance(tt_, np.ndarray) and tt_.shape == (24, 3) and tq.shape == (24, 4)
    np.testing.assert_allclose(tt_, jt, atol=TOL)
    np.testing.assert_allclose(tq, jq, atol=TOL)


def test_numpy_round_trip():
    """pose_graph_to_numpy / pose_graph_from_numpy carry a JAX graph into
    the port and back, keyed by the JAX field names and dtypes."""
    jg, _, _ = drifted_square()
    d = tree_dict(jg)
    tg = interop.pose_graph_from_numpy(d, dtype=torch.float64, device=CPU)
    back = interop.pose_graph_to_numpy(tg)
    assert set(back) == set(JG.PoseGraph._fields)
    for k, v in d.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)
