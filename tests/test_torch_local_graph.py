"""models/local_graph: ``propagate_interval`` and ``optimize_local_chain``
against the JAX ones in float64, on one keyframe interval of noisy IMU
samples with padding, as ``LiliOmSystem._densify_interval`` feeds them.

Tolerance 1e-9. The port propagates in the parallel form (prefix products
and cumulative sums) where the JAX package scans step by step, so the
propagated poses differ by rounding (~1e-14 here); the chain solves are the
same Gauss-Newton on the same factors.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lili_om_tpu.models import local_graph as JL
from lili_om_tpu.ops.preintegration import ImuNoise as JN
from lili_om_tpu.utils.math import quat_normalize
from lili_om_tpu_torch.models import local_graph as TL
from lili_om_tpu_torch.ops.preintegration import ImuNoise as TN
from test_torch_common import npy, tt

TOL = 1e-9
CAP, F = 64, 8


@pytest.fixture(scope="module")
def interval():
    rng = np.random.default_rng(5)
    n = 41  # valid samples; the rest is padding
    d = np.zeros(CAP)
    d[:n] = 0.005 + rng.uniform(-5e-4, 5e-4, n)
    a = np.zeros((CAP, 3))
    a[:n] = rng.normal(size=(n, 3)) * 0.5 + np.array([0.0, 0.0, 9.81])
    g = np.zeros((CAP, 3))
    g[:n] = rng.normal(size=(n, 3)) * 0.2
    vm = np.arange(CAP) < n
    fidx = np.zeros(F, np.int32)
    fidx[:5] = [9, 19, 29, 39, 40]  # four intermediate frames + the keyframe
    fmask = np.arange(F) < 5
    t0, v0 = np.array([1.0, -2.0, 0.5]), np.array([0.8, 0.1, 0.0])
    q0 = np.asarray(quat_normalize(jnp.asarray([0.9, 0.1, -0.2, 0.3])))
    return dict(t0=t0, q0=q0, v0=v0, d=d, a=a, g=g, vm=vm, fidx=fidx, fmask=fmask)


def _propagate(iv):
    noise = dict(acc_n=2000.0, gyr_n=0.0173, acc_w=2.0, gyr_w=0.00025, init_cov=1e-3)
    args = [iv[k] for k in ("t0", "q0", "v0", "d", "a", "g", "vm", "fidx", "fmask")]
    j = JL.propagate_interval(*[jnp.asarray(x) for x in args], JN(**noise))
    t = TL.propagate_interval(*[tt(x) for x in args], TN(**noise))
    return j, t


def test_propagate_interval_matches_jax(interval):
    (jt, jq), (tt_, tq) = _propagate(interval)
    assert tt_.shape == (F, 3) and tq.shape == (F, 4)
    np.testing.assert_allclose(npy(tt_), np.asarray(jt), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(npy(tq), np.asarray(jq), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n_iters", [1, 8])
def test_optimize_local_chain_matches_jax(interval, n_iters):
    """Both keyframes moved by a correction the chain has to spread."""
    (jt, jq), _ = _propagate(interval)
    jt, jq = np.asarray(jt), np.asarray(jq)
    t_left, q_left = interval["t0"] + np.array([0.05, -0.02, 0.01]), interval["q0"]
    t_right = jt[4] + np.array([-0.1, 0.08, 0.03])
    q_right = np.asarray(quat_normalize(jnp.asarray(jq[4] + np.array([0.0, 0.01, -0.02, 0.0]))))
    args = [jt, jq, interval["fmask"], t_left, q_left, t_right, q_right]
    j = JL.optimize_local_chain(*[jnp.asarray(x) for x in args], n_iters=n_iters)
    t = TL.optimize_local_chain(*[tt(x) for x in args], n_iters=n_iters)
    np.testing.assert_allclose(npy(t.t), np.asarray(j.t), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(npy(t.q), np.asarray(j.q), rtol=TOL, atol=TOL)
    assert torch.equal(t.mask, tt(interval["fmask"]))
    # the right anchor pulls the last valid node toward the right keyframe
    assert np.linalg.norm(npy(t.t[4]) - t_right) < np.linalg.norm(jt[4] - t_right)
