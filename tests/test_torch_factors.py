"""factors/{lidar,imu,prior} and solver/gn against the JAX package, on the
same numpy inputs. The formulas are the same, so float64 agrees to 1e-10
(relative to each array's scale); float32 to 1e-5 relative."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lili_om_tpu.factors import imu as JI
from lili_om_tpu.factors import lidar as JL
from lili_om_tpu.factors import prior as JPR
from lili_om_tpu.ops import preintegration as JP
from lili_om_tpu.solver import gn as JG
from lili_om_tpu_torch.factors import imu as TI
from lili_om_tpu_torch.factors import lidar as TL
from lili_om_tpu_torch.factors import prior as TPR
from lili_om_tpu_torch.ops import preintegration as TP
from lili_om_tpu_torch.sim.trajectory import circle_trajectory, pose_at, simulate_imu
from lili_om_tpu_torch.solver import gn as TG
from test_torch_common import npy


TOL = {"float64": 1e-10, "float32": 1e-5}
DTYPES = ["float64", "float32"]


def _j(a, dtype):
    a = np.asarray(a)
    return jnp.asarray(a) if a.dtype == bool else jnp.asarray(a, getattr(jnp, dtype))


def _t(a, dtype):
    a = np.array(a)
    return torch.as_tensor(a) if a.dtype == bool else torch.as_tensor(a, dtype=getattr(torch, dtype))


def _close(a, b, dtype, scale=1.0):
    a = np.asarray(a, np.float64)
    s = max(1.0, float(np.abs(a).max())) if a.size else 1.0
    np.testing.assert_allclose(npy(b).astype(np.float64), a, rtol=TOL[dtype] * scale,
                               atol=TOL[dtype] * scale * s)


def _unit(rng, n=None):
    q = rng.normal(size=(4,) if n is None else (n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


@pytest.mark.parametrize("dtype", DTYPES)
def test_robust_weights(dtype):
    r2 = np.concatenate([[0.0], np.logspace(-8, 2, 40)])
    _close(JL.huber_weight(_j(r2, dtype), 0.1), TL.huber_weight(_t(r2, dtype), 0.1), dtype)
    _close(JL.cauchy_weight(_j(r2, dtype), 1.0), TL.cauchy_weight(_t(r2, dtype), 1.0), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_body_points(dtype):
    rng = np.random.default_rng(0)
    pts, t_lb, q_lb = rng.normal(size=(50, 3)) * 5, np.array([-0.18, 0.0, -0.095]), _unit(rng)
    _close(JL.body_points(_j(pts, dtype), _j(t_lb, dtype), _j(q_lb, dtype)),
           TL.body_points(_t(pts, dtype), _t(t_lb, dtype), _t(q_lb, dtype)), dtype)


def _plane_batch(rng, n=64):
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    return [rng.normal(size=(n, 3)) * 5, nrm, rng.normal(size=n), rng.uniform(0.2, 2, n),
            rng.uniform(size=n) > 0.2]


@pytest.mark.parametrize("dtype", DTYPES)
def test_plane_residual(dtype):
    rng = np.random.default_rng(1)
    b = _plane_batch(rng)
    t, q = rng.normal(size=3), _unit(rng)
    jr, jJ = JL.plane_residual(_j(t, dtype), _j(q, dtype),
                               JL.PlaneFactorBatch(*[_j(x, dtype) for x in b]))
    tr, tJ = TL.plane_residual(_t(t, dtype), _t(q, dtype),
                               TL.PlaneFactorBatch(*[_t(x, dtype) for x in b]))
    _close(jr, tr, dtype)
    _close(jJ, tJ, dtype)
    assert np.all(npy(tr)[~b[4]] == 0) and np.all(npy(tJ)[~b[4]] == 0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_edge_residual(dtype):
    rng = np.random.default_rng(2)
    n = 64
    ctr, d = rng.normal(size=(n, 3)) * 5, rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    b = [rng.normal(size=(n, 3)) * 5, ctr + 0.1 * d, ctr - 0.1 * d,
         np.full(n, 7.5), rng.uniform(size=n) > 0.2]
    t, q = rng.normal(size=3), _unit(rng)
    jr, jJ = JL.edge_residual(_j(t, dtype), _j(q, dtype),
                              JL.EdgeFactorBatch(*[_j(x, dtype) for x in b]))
    tr, tJ = TL.edge_residual(_t(t, dtype), _t(q, dtype),
                              TL.EdgeFactorBatch(*[_t(x, dtype) for x in b]))
    # the line direction is normalised from a 0.2 m segment: f32 loses ~2 digits
    _close(jr, tr, dtype, 1.0 if dtype == "float64" else 10.0)
    _close(jJ, tJ, dtype, 1.0 if dtype == "float64" else 10.0)


@pytest.fixture(scope="module")
def imu_interval():
    """An IMU interval of the circle trajectory with states near the truth
    and non-trivial biases (the linearisation of tests/test_imu_factor.py),
    from the port's simulator (equal to the JAX one, test_torch_sim.py)."""
    traj = circle_trajectory(radius=10.0, period=30.0)
    imu = simulate_imu(traj, 3.0, 3.25, rate=200.0)
    dts = np.diff(np.asarray(imu.stamps))
    accs, gyrs = np.asarray(imu.accs), np.asarray(imu.gyrs)
    rng = np.random.default_rng(4)
    Pi, Qi = (np.asarray(x) for x in pose_at(traj, 3.0))
    Pj, Qj = (np.asarray(x) for x in pose_at(traj, 3.25))
    ba, bg = np.array([0.02, -0.01, 0.03]), np.array([0.001, 0.002, -0.001])
    si = [Pi, Qi, rng.normal(size=3), ba, bg]
    sj = [Pj + 0.01 * rng.normal(size=3), Qj, rng.normal(size=3), ba * 1.1, bg * 0.9]
    return (np.zeros(3), np.zeros(3), accs[0], gyrs[0], dts, accs[1:], gyrs[1:]), si, sj


# whitening only in float64: the f32 Cholesky of the 1e-4..1e-12 covariance
# spectrum is rounding noise on both sides
@pytest.mark.parametrize("dtype,whiten", [("float64", False), ("float64", True),
                                          ("float32", False)])
def test_imu_factor_analytic(imu_interval, dtype, whiten):
    sig, si, sj = imu_interval
    jp = jax.jit(JP.integrate_parallel, static_argnums=0)(JP.ImuNoise(),
                                                           *[_j(x, dtype) for x in sig])
    tp = TP.integrate_parallel(TP.ImuNoise(), *[_t(x, dtype) for x in sig])
    jW = JP.sqrt_info(jp) if whiten else None
    tW = TP.sqrt_info(tp) if whiten else None
    jo = jax.jit(JI.imu_factor_analytic, static_argnums=1)(
        jp, JP.ImuNoise(), *[_j(x, dtype) for x in si + sj], W=jW)
    to = TI.imu_factor_analytic(tp, TP.ImuNoise(), *[_t(x, dtype) for x in si + sj], W=tW)
    for a, b in zip(jo, to):
        _close(a, b, dtype, 1e3 if whiten else 10.0)  # W entries reach ~1e4


@pytest.mark.parametrize("dtype", DTYPES)
def test_retract_state(dtype):
    rng = np.random.default_rng(5)
    st = [rng.normal(size=(3, 3)), _unit(rng, 3), rng.normal(size=(3, 3)),
          rng.normal(size=(3, 3)), rng.normal(size=(3, 3))]
    delta = rng.normal(size=(3, 15)) * 0.1
    for a, b in zip(jax.vmap(JI.retract_state)(*[_j(x, dtype) for x in st], _j(delta, dtype)),
                    TI.retract_state(*[_t(x, dtype) for x in st], _t(delta, dtype))):
        _close(a, b, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("valid", [False, True])
def test_marginal_prior_residual(dtype, valid):
    rng = np.random.default_rng(6)
    K = 2
    D = 15 * K
    prior = [rng.normal(size=(D, D)), rng.normal(size=D), rng.normal(size=(K, 3)),
             _unit(rng, K), rng.normal(size=(K, 3)), rng.normal(size=(K, 3)),
             rng.normal(size=(K, 3)), np.array(valid)]
    # one orientation on the far side of the double cover: the w<0 flip
    st = [rng.normal(size=(K, 3)), -_unit(rng, K), rng.normal(size=(K, 3)),
          rng.normal(size=(K, 3)), rng.normal(size=(K, 3))]
    jo = JPR.marginal_prior_residual(JPR.MarginalPrior(*[_j(x, dtype) for x in prior]),
                                     *[_j(x, dtype) for x in st])
    to = TPR.marginal_prior_residual(TPR.MarginalPrior(*[_t(x, dtype) for x in prior]),
                                     *[_t(x, dtype) for x in st])
    for a, b in zip(jo, to):
        _close(a, b, dtype, 10.0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_speed_bias_prior(dtype):
    rng = np.random.default_rng(7)
    x = [rng.normal(size=3) for _ in range(6)]
    w = np.array([8.0, 8.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0])
    for kw in ({}, {"weights": w}):
        jo = JPR.speed_bias_prior(*[_j(a, dtype) for a in x],
                                  **{k: _j(v, dtype) for k, v in kw.items()})
        to = TPR.speed_bias_prior(*[_t(a, dtype) for a in x],
                                  **{k: _t(v, dtype) for k, v in kw.items()})
        for a, b in zip(jo, to):
            _close(a, b, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_block_hessian_and_gn_update(dtype):
    rng = np.random.default_rng(8)
    J, r, w = rng.normal(size=(200, 6)), rng.normal(size=200), rng.uniform(0.1, 1, 200)
    for a, b in zip(JG.block_hessian(_j(J, dtype), _j(r, dtype), _j(w, dtype)),
                    TG.block_hessian(_t(J, dtype), _t(r, dtype), _t(w, dtype))):
        _close(a, b, dtype)
    _close(JG.gn_update(_j(J, dtype), _j(r, dtype), 1e-8, _j(w, dtype)),
           TG.gn_update(_t(J, dtype), _t(r, dtype), 1e-8, _t(w, dtype)), dtype, 10.0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_solve_normal_and_lm(dtype):
    rng = np.random.default_rng(9)
    A = rng.normal(size=(45, 45))
    H = A @ A.T + 0.1 * np.eye(45)
    b = rng.normal(size=45)
    scale = 10.0 if dtype == "float64" else 1e3  # f32 solve of a cond ~1e4 system
    _close(JG.solve_normal(_j(H, dtype), _j(b, dtype), 1e-6),
           TG.solve_normal(_t(H, dtype), _t(b, dtype), 1e-6), dtype, scale)
    for lam in (1e-4, 1.0, 100.0):
        _close(JG.solve_normal_lm(_j(H, dtype), _j(b, dtype), lam),
               TG.solve_normal_lm(_t(H, dtype), _t(b, dtype), lam), dtype, scale)


def test_singular_system_gives_zero_step():
    """A singular H (no correspondences): the plain solve gives a zero step
    on both sides, and the Marquardt solve the same (clamped) step."""
    H = np.zeros((6, 6))
    b = np.ones(6)
    assert np.all(np.asarray(JG.solve_normal(jnp.asarray(H), jnp.asarray(b))) == 0)
    assert torch.all(TG.solve_normal(torch.as_tensor(H), torch.as_tensor(b)) == 0)
    _close(JG.solve_normal_lm(jnp.asarray(H), jnp.asarray(b), 1e-4),
           TG.solve_normal_lm(torch.as_tensor(H), torch.as_tensor(b), 1e-4), "float64")


@pytest.mark.parametrize("dtype,whiten", [("float64", False), ("float64", True),
                                          ("float32", False)])
def test_imu_factor_autodiff(imu_interval, dtype, whiten):
    """``imu_factor`` (Jacobians by ``torch.func.jacfwd``) against JAX's
    (``jax.jacfwd``) on the same preintegration, at the analytic test's
    tolerances; and the port's analytic form against it, with
    tests/test_imu_factor.py's bounds (the residual to 1e-9 relative; the
    Jacobians to 2e-4 of their largest entry, as the analytic form treats
    the residual's normalize as identity and corrects biases to first
    order)."""
    sig, si, sj = imu_interval
    jp = jax.jit(JP.integrate_parallel, static_argnums=0)(JP.ImuNoise(),
                                                           *[_j(x, dtype) for x in sig])
    tp = TP.integrate_parallel(TP.ImuNoise(), *[_t(x, dtype) for x in sig])
    jW = JP.sqrt_info(jp) if whiten else None
    tW = TP.sqrt_info(tp) if whiten else None
    jo = jax.jit(JI.imu_factor, static_argnums=1)(
        jp, JP.ImuNoise(), *[_j(x, dtype) for x in si + sj], W=jW)
    to = TI.imu_factor(tp, TP.ImuNoise(), *[_t(x, dtype) for x in si + sj], W=tW)
    for a, b in zip(jo, to):
        _close(a, b, dtype, 1e3 if whiten else 10.0)
    if dtype == "float64":
        ta = TI.imu_factor_analytic(tp, TP.ImuNoise(), *[_t(x, dtype) for x in si + sj], W=tW)
        np.testing.assert_allclose(npy(ta[0]), npy(to[0]), rtol=1e-9,
                                   atol=1e-12 * float(np.abs(npy(to[0])).max()))
        scale = float(np.abs(npy(to[1])).max())
        for a, b in zip(to[1:], ta[1:]):
            np.testing.assert_allclose(npy(b), npy(a), atol=2e-4 * scale)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window_k", [1, 4])
def test_identity_prior(dtype, window_k):
    """The inert start-up prior: the same arrays, and a zero residual."""
    jp = JPR.identity_prior(window_k, getattr(jnp, dtype))
    tp = TPR.identity_prior(window_k, getattr(torch, dtype))
    for name, a, b in zip(jp._fields, jp, tp):
        assert npy(b).dtype == np.asarray(a).dtype, name
        np.testing.assert_array_equal(npy(b), np.asarray(a), err_msg=name)
    r, J = TPR.marginal_prior_residual(tp, *[tp.t0, tp.q0, tp.v0, tp.ba0, tp.bg0])
    assert not torch.any(r) and not torch.any(J)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_b", [False, True])
def test_scatter_block(dtype, with_b):
    """Blocks added into a dense H (and b) at static slots, twice into one
    slot: equal to JAX's ``.at[].add``, and the inputs left unchanged."""
    rng = np.random.default_rng(10)
    H, b = rng.normal(size=(12, 12)), rng.normal(size=12)
    blocks = [(rng.normal(size=(3, 3)), rng.normal(size=3), i, j)
              for i, j in ((0, 0), (1, 2), (1, 2), (3, 1))]
    jH, jb = _j(H, dtype), _j(b, dtype) if with_b else None
    tH, tb = _t(H, dtype), _t(b, dtype) if with_b else None
    for Hij, bi, i, j in blocks:
        jH, jb = JG.scatter_block(jH, jb, _j(Hij, dtype), _j(bi, dtype), i, j, 3)
        tH, tb = TG.scatter_block(tH, tb, _t(Hij, dtype), _t(bi, dtype), i, j, 3)
    _close(jH, tH, dtype)
    if with_b:
        _close(jb, tb, dtype)
    else:
        assert tb is None
