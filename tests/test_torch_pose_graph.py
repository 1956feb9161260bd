"""models/pose_graph: the port's graph building and both solvers against the
JAX package's, in float64, on the graphs of tests/test_pose_graph.py.

Tolerance 1e-9: the same Gauss-Newton problem with the same Jacobians
(``jax.jacfwd`` through the retraction on the JAX side, the same
derivatives written out in the port, equal to ~1e-15); what differs is the
order of the sums and the small solves (LAPACK Cholesky in the port,
unrolled 6×6 algebra in the JAX chain solver), a few ulps per step on
well-conditioned systems.
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


def noisy_graph(n=24, n_loops=2, seed=7):
    """tests/test_pose_graph.py's random chain with loops, perturbed."""
    rng = np.random.default_rng(seed)
    g = JG.init_graph(32, loop_capacity=4, dtype=jnp.float64)
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


@pytest.mark.parametrize("n_loops,tol", [(2, 0.0), (0, 0.0), (2, 1e-3)],
                         ids=["loops", "chain_only", "loops_tol"])
def test_chain_solver_matches_jax(n_loops, tol):
    """optimize_graph_chain (block Thomas + Woodbury), with and without
    loops and with the step-norm early exit, against the JAX chain solver;
    and, at a fixed iteration count, against the port's dense solver."""
    jg = noisy_graph(n_loops=n_loops)
    tg = _to_port(jg)
    j2 = JG.optimize_graph_chain(jg, n_iters=8, tol=tol)
    t2 = TG.optimize_graph_chain(tg, n_iters=8, tol=tol)
    np.testing.assert_allclose(npy(t2.t), np.asarray(j2.t), atol=TOL)
    np.testing.assert_allclose(npy(t2.q), np.asarray(j2.q), atol=TOL)
    if tol == 0.0:
        td = TG.optimize_graph(tg, n_iters=8)
        np.testing.assert_allclose(npy(t2.t), npy(td.t), atol=TOL)


def test_block_tridiag_solve_matches_jax_and_numpy():
    rng = np.random.default_rng(11)
    N = 12
    Bs = rng.normal(size=(N, 6, 6)) * 0.1
    Ds = np.stack([np.eye(6) * 4 + rng.normal(size=(6, 6)) * 0.05 for _ in range(N)])
    Ds = 0.5 * (Ds + Ds.transpose(0, 2, 1))
    T = np.zeros((6 * N, 6 * N))
    for i in range(N):
        T[6 * i:6 * i + 6, 6 * i:6 * i + 6] = Ds[i]
        if i + 1 < N:
            T[6 * i:6 * i + 6, 6 * i + 6:6 * i + 12] = Bs[i]
            T[6 * i + 6:6 * i + 12, 6 * i:6 * i + 6] = Bs[i].T
    rhs = rng.normal(size=(N, 6, 3))
    X = npy(TG.block_tridiag_solve(tt(Ds), tt(Bs), tt(rhs)))
    np.testing.assert_allclose(X, np.asarray(JG.block_tridiag_solve(Ds, Bs, rhs)),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(X.reshape(6 * N, 3), np.linalg.solve(T, rhs.reshape(-1, 3)),
                               rtol=1e-8, atol=1e-8)


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
