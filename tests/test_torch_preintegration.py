"""ops/preintegration against the JAX package: the parallel forms the fusion
step runs (``integrate_parallel``, ``propagate_world_parallel``), the bias
correction, the residual and the whitening, on the signals of
tests/test_preintegration.py. The port's prefix scans associate the products
in another order than ``jax.lax.associative_scan``, so only the rounding
differs: float64 agrees to 1e-10 (covariances, whose entries reach ~1e-3,
to 1e-14), float32 to 1e-5 relative."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lili_om_tpu.ops import preintegration as JP
from lili_om_tpu_torch.ops import preintegration as TP
from test_torch_common import npy


JN, TN = JP.ImuNoise(), TP.ImuNoise()
TOL = {"float64": 1e-10, "float32": 1e-5}


def _signal(seed, n=32, n_valid=25):
    rng = np.random.default_rng(seed)
    accs = rng.normal(size=(n, 3)) * 2.0 + np.array([0.0, 0.0, 9.8])
    gyrs = rng.normal(size=(n, 3)) * 0.5
    dts = np.full(n, 0.005)
    mask = np.arange(n) < n_valid
    ba = np.array([0.01, -0.02, 0.03])
    bg = np.array([-0.001, 0.002, 0.0005])
    a0 = np.array([0.1, 0.2, 9.7])
    g0 = np.array([0.05, -0.02, 0.01])
    return ba, bg, a0, g0, dts, accs, gyrs, mask


def _both(arrs, dtype):
    j = [jnp.asarray(a) if a.dtype == bool else jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    t = [torch.as_tensor(a) if a.dtype == bool else torch.as_tensor(a, dtype=getattr(torch, dtype))
         for a in arrs]
    return j, t


def _close(a, b, dtype, scale=1.0):
    a = np.asarray(a, np.float64)
    tol = TOL[dtype] * scale * max(1.0, float(np.abs(a).max()) if dtype == "float32" else 1.0)
    np.testing.assert_allclose(npy(b).astype(np.float64), a, rtol=TOL[dtype] * scale, atol=tol)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n_valid", [32, 25, 0])
def test_integrate_parallel_matches_jax(dtype, n_valid):
    j, t = _both(_signal(11, n_valid=n_valid), dtype)
    jp = JP.integrate_parallel(JN, *j)
    tp = TP.integrate_parallel(TN, *t)
    for name in JP.Preint._fields:
        scale = 1e-4 if (name == "covariance" and dtype == "float64") else 1.0
        _close(getattr(jp, name), getattr(tp, name), dtype, scale)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_propagate_world_parallel_matches_jax(dtype):
    ba, bg, a0, g0, dts, accs, gyrs, mask = _signal(13, n_valid=29)
    t0 = np.array([1.0, -2.0, 0.5])
    q0 = np.array([0.9, 0.1, -0.2, 0.3])
    q0 = q0 / np.linalg.norm(q0)
    v0 = np.array([0.5, 0.1, -0.2])
    j, t = _both([t0, q0, v0, ba, bg], dtype)
    js, ts = _both([a0, g0, dts, accs, gyrs, mask], dtype)
    jr = JP.propagate_world_parallel(*j, JN, *js)
    tr = TP.propagate_world_parallel(*t, TN, *ts)
    for a, b in zip(jr, tr):
        _close(a, b, dtype, 10.0)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_residual_and_sqrt_info_match_jax(dtype):
    """Bias-corrected deltas, the 15-dof residual at perturbed states and
    the whitening W = L⁻¹ (f64: W entries reach ~1e4, so 1e-10 relative)."""
    j, t = _both(_signal(2, n_valid=32), dtype)
    jp, tp = JP.integrate_parallel(JN, *j), TP.integrate_parallel(TN, *t)
    rng = np.random.default_rng(3)
    qi = rng.normal(size=4)
    qj = rng.normal(size=4)
    states = [rng.normal(size=3), qi / np.linalg.norm(qi), rng.normal(size=3),
              rng.normal(size=3) * 0.01, rng.normal(size=3) * 0.001,
              rng.normal(size=3), qj / np.linalg.norm(qj), rng.normal(size=3),
              rng.normal(size=3) * 0.01, rng.normal(size=3) * 0.001]
    js, ts = _both(states, dtype)
    for a, b in zip(JP.bias_corrected_deltas(jp, js[3], js[4]),
                    TP.bias_corrected_deltas(tp, ts[3], ts[4])):
        _close(a, b, dtype)
    _close(JP.residual(jp, JN, *js), TP.residual(tp, TN, *ts), dtype, 10.0)
    if dtype == "float64":  # f32 Cholesky of a 1e-4..1e-12 spectrum is noise
        jw, tw = np.asarray(JP.sqrt_info(jp)), npy(TP.sqrt_info(tp))
        np.testing.assert_allclose(tw, jw, rtol=1e-9, atol=1e-9 * np.abs(jw).max())


def test_sqrt_info_batched():
    """Batched over the window's stacked intervals, as fusion calls it."""
    ps = [TP.integrate_parallel(TN, *_both(_signal(s), "float64")[1]) for s in (4, 5)]
    stacked = TP.Preint(*[torch.stack(x) for x in zip(*ps)])
    W = TP.sqrt_info(stacked)
    for i, p in enumerate(ps):
        assert torch.allclose(W[i], TP.sqrt_info(p), rtol=1e-12, atol=0)
        eye = W[i] @ p.covariance @ W[i].T
        assert torch.allclose(eye, torch.eye(15, dtype=torch.float64), atol=1e-8)


def test_noise_and_gravity_conventions():
    assert TN._fields == JN._fields and tuple(TN) == tuple(JN)
    np.testing.assert_array_equal(npy(TN.g_vec(torch.float64)), np.asarray(JN.g_vec(jnp.float64)))
    np.testing.assert_allclose(npy(TN.noise_diag(torch.float64)),
                               np.asarray(JN.noise_diag(jnp.float64)), rtol=1e-15)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_noise_cov_matches_jax(dtype):
    """The 18×18 diagonal covariance, of the default noise and of the
    fr_iosb preset's: equal bit for bit (both round the same squares to
    ``dtype``), zero off the diagonal, on the device asked for."""
    from lili_om_tpu.utils.config import load_config as j_load
    from lili_om_tpu_torch.utils.config import load_config as t_load

    for jn, tn in ((JN, TN), (j_load("fr_iosb").imu_noise, t_load("fr_iosb").imu_noise)):
        got = tn.noise_cov(getattr(torch, dtype), device="cpu")
        want = np.asarray(jn.noise_cov(getattr(jnp, dtype)))
        assert got.shape == (18, 18) and got.dtype == getattr(torch, dtype)
        assert got.device.type == "cpu"
        np.testing.assert_array_equal(npy(got), want)
        np.testing.assert_array_equal(npy(got), np.diag(npy(tn.noise_diag(getattr(torch, dtype)))))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n_valid", [32, 25, 0])
def test_integrate_sequential_matches_jax(dtype, n_valid):
    """The sequential midpoint form against JAX's ``lax.scan`` form, step for
    step the same operations: float64 to 1e-12 (covariances to 1e-16),
    float32 to 1e-5 relative; and against the port's parallel form, which
    only re-associates the products, to the parallel tests' 1e-10."""
    j, t = _both(_signal(11, n_valid=n_valid), dtype)
    jp = JP.integrate(JN, *j)
    tp = TP.integrate(TN, *t)
    par = TP.integrate_parallel(TN, *t)
    for name in JP.Preint._fields:
        scale = (1e-4 if name == "covariance" else 1e-2) if dtype == "float64" else 1.0
        _close(getattr(jp, name), getattr(tp, name), dtype, scale)
        if dtype == "float64":
            _close(npy(getattr(par, name)), getattr(tp, name), dtype,
                   1e-4 if name == "covariance" else 1.0)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n_valid", [32, 25])
def test_propagate_world_sequential_matches_jax(dtype, n_valid):
    """As above, for the world-frame propagation (state and last sample)."""
    ba, bg, a0, g0, dts, accs, gyrs, mask = _signal(5, n_valid=n_valid)
    t0, q0, v0 = np.array([1.0, -2.0, 0.5]), np.array([0.9, 0.1, -0.3, 0.3]), np.array(
        [0.5, 0.2, -0.1])
    q0 = q0 / np.linalg.norm(q0)
    j, t = _both((t0, q0, v0, ba, bg, a0, g0, dts, accs, gyrs, mask), dtype)
    jo = JP.propagate_world(*j[:5], JN, *j[5:])
    to = TP.propagate_world(*t[:5], TN, *t[5:])
    po = TP.propagate_world_parallel(*t[:5], TN, *t[5:])
    for a, b, c in zip(jo, to, po):
        _close(a, b, dtype, 1e-2 if dtype == "float64" else 1.0)
        if dtype == "float64":
            _close(npy(c), b, dtype)
