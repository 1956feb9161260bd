"""ops/marginalization: ``schur_marginalize`` against the JAX package on the
cases of tests/test_marginalization.py. Both take the same symmetric
eigendecompositions (LAPACK on both sides), so float64 agrees to 1e-8 on
JᵀJ and Jᵀr₀ (J itself is defined up to the sign of each eigenvector row);
float32 to 1e-3 relative."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lili_om_tpu.ops.marginalization import schur_marginalize as jschur
from lili_om_tpu_torch.ops.marginalization import schur_marginalize as tschur
from test_torch_common import npy


def _spd(rng, n):
    A = rng.normal(size=(n, n))
    return A @ A.T + 0.1 * np.eye(n)


def _cases():
    rng = np.random.default_rng(0)
    dense = (_spd(rng, 20), rng.normal(size=20), 8)
    # rank-2 marginal block, no coupling (the pseudo-inverse path)
    H = np.zeros((12, 12))
    U = rng.normal(size=(4, 2))
    H[:4, :4] = U @ U.T
    H[4:, 4:] = _spd(rng, 8)
    rank_def = (H, rng.normal(size=12), 4)
    # the fusion window's shape: 45 dofs, the exiting keyframe's 15
    window = (_spd(rng, 45), rng.normal(size=45), 15)
    return {"dense": dense, "rank_deficient": rank_def, "window": window}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", ["dense", "rank_deficient", "window"])
def test_schur_matches_jax(dtype, case):
    H, g, m = _cases()[case]
    jJ, jr = jschur(jnp.asarray(H, getattr(jnp, dtype)), jnp.asarray(g, getattr(jnp, dtype)), m)
    tJ, tr = tschur(torch.as_tensor(H, dtype=getattr(torch, dtype)),
                    torch.as_tensor(g, dtype=getattr(torch, dtype)), m)
    jJ, jr = np.asarray(jJ, np.float64), np.asarray(jr, np.float64)
    tJ, tr = npy(tJ).astype(np.float64), npy(tr).astype(np.float64)
    assert np.all(np.isfinite(tJ)) and np.all(np.isfinite(tr))
    tol = 1e-8 if dtype == "float64" else 1e-3
    A = jJ.T @ jJ
    np.testing.assert_allclose(tJ.T @ tJ, A, rtol=tol, atol=tol * np.abs(A).max())
    b = jJ.T @ jr
    np.testing.assert_allclose(tJ.T @ tr, b, rtol=tol, atol=tol * np.abs(b).max())
    # the prior's cost ‖r₀ + J·x‖² agrees at any x, up to its constant
    x = np.random.default_rng(1).normal(size=tJ.shape[1])
    cj = np.sum((jr + jJ @ x) ** 2) - np.sum(jr ** 2)
    ct = np.sum((tr + tJ @ x) ** 2) - np.sum(tr ** 2)
    np.testing.assert_allclose(ct, cj, rtol=tol * 10)
