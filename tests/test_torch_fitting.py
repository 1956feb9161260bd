"""ops/fitting: eig3_symmetric, solve3, fit_plane and fit_line against the
JAX package (the cases of tests/test_eig3.py). float64 agrees to 1e-9: the
closed forms are the same, but eigenvectors of near-degenerate spectra
amplify rounding by 1/gap; float32 agrees to 1e-4."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lili_om_tpu.ops import fitting as JF
from lili_om_tpu_torch.ops import fitting as TF
from test_torch_common import npy

TOL = {"float64": 1e-9, "float32": 1e-4}


def _both(x, dtype):
    return jnp.asarray(x, getattr(jnp, dtype)), torch.as_tensor(x, dtype=getattr(torch, dtype))


def _close(a, b, dtype, scale=1.0):
    np.testing.assert_allclose(np.asarray(a, np.float64), npy(b).astype(np.float64),
                               rtol=TOL[dtype] * scale, atol=TOL[dtype] * scale)


def _spd(rng, n):
    A = rng.normal(size=(n, 3, 3))
    return A @ np.swapaxes(A, -1, -2)


def _fix_sign(v):
    """Eigenvector columns up to sign: make each column's largest entry +."""
    idx = np.argmax(np.abs(v), axis=-2)[..., None, :]
    return v * np.sign(np.take_along_axis(v, idx, axis=-2))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("kind", ["random", "planar", "isotropic", "linear"])
def test_eig3_matches_jax(dtype, kind):
    rng = np.random.default_rng(0)
    if kind == "random":
        A = _spd(rng, 256)
    elif kind == "planar":  # rank-2 covariance (points on a plane)
        P = rng.normal(size=(128, 8, 3))
        P[..., 2] = 0.0
        A = np.einsum("nki,nkj->nij", P, P)
    elif kind == "linear":  # rank-1 covariance (points on a line)
        d = rng.normal(size=(128, 1, 3))
        A = np.einsum("nki,nkj->nij", d, d) * rng.uniform(1, 4, size=(128, 1, 1))
    else:
        A = np.broadcast_to(np.eye(3) * 2.5, (16, 3, 3)).copy()
    ja, ta = _both(A, dtype)
    (jl, jv), (tl, tv) = JF.eig3_symmetric(ja), TF.eig3_symmetric(ta)
    # eigenvalues relative to each spectrum's scale (near-zero ones carry the
    # absolute rounding of the largest)
    sc = np.max(np.abs(np.asarray(jl, np.float64)), axis=-1, keepdims=True) + 1e-30
    _close(np.asarray(jl, np.float64) / sc, npy(tl).astype(np.float64) / sc, dtype, 10.0)
    if kind == "random":  # eigenvectors are defined up to sign
        _close(_fix_sign(np.asarray(jv, np.float64)), _fix_sign(npy(tv).astype(np.float64)),
               dtype, scale=10.0)
    else:
        # degenerate spectra: compare the well-defined eigenvectors through
        # their projectors (sign-free); inside a repeated eigenvalue the basis
        # is arbitrary (isotropic: all three; linear: the two small ones)
        cols = {"isotropic": (), "planar": (0,), "linear": (2,)}[kind]
        for col in cols:
            pj = np.einsum("ni,nj->nij", np.asarray(jv)[..., col], np.asarray(jv)[..., col])
            pt = np.einsum("ni,nj->nij", npy(tv)[..., col], npy(tv)[..., col])
            _close(pj, pt, dtype, scale=10.0)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_solve3_matches_jax(dtype):
    rng = np.random.default_rng(1)
    A = _spd(rng, 128) + np.eye(3)
    b = rng.normal(size=(128, 3))
    (ja, jb), (ta, tb) = zip(_both(A, dtype), _both(b, dtype))
    _close(JF.solve3(ja, jb, damping=1e-9), TF.solve3(ta, tb, damping=1e-9), dtype, 10.0)


def _neighbors(rng, n=200, k=5, noise=0.01):
    """Near-horizontal patches 2-4 m from the origin with a 1 m in-plane
    spread (the A·n=−1 form is ill-conditioned for planes through the
    origin or far from it), some rows partly masked."""
    base = rng.uniform(-1, 1, size=(n, 1, 3)) + np.array([0.0, 0.0, 3.0])
    offs = rng.normal(size=(n, k, 3)) * np.array([1.0, 1.0, noise])
    nb = base + offs
    mask = rng.uniform(size=(n, k)) > 0.1
    return nb, mask


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("weighted", [False, True])
def test_fit_plane_matches_jax(dtype, weighted):
    rng = np.random.default_rng(2)
    nb, mask = _neighbors(rng)
    w = rng.uniform(0.2, 2.0, size=mask.shape) if weighted else None
    jn, tn = _both(nb, dtype)
    jw, tw = (None, None) if w is None else _both(w, dtype)
    jo = JF.fit_plane(jn, jnp.asarray(mask), dist_thres=0.05, weights=jw)
    to = TF.fit_plane(tn, torch.as_tensor(mask), dist_thres=0.05, weights=tw)
    # the A·n=−1 normal equations square the condition of the neighbour
    # set: where float32 cannot resolve a row, the JAX package's own float32
    # fit is off its float64 fit too, so the float32 comparison covers the
    # rows whose float32 JAX fit agrees with its float64 fit to 1e-4 (and
    # must cover most rows)
    ok = mask.sum(-1) >= 3  # fewer neighbours: a singular system, invalid on both sides
    if dtype == "float32":
        ref = JF.fit_plane(jnp.asarray(nb), jnp.asarray(mask), dist_thres=0.05,
                           weights=None if w is None else jnp.asarray(w))
        ok &= np.all(np.abs(np.asarray(jo.normal, np.float64) - np.asarray(ref.normal)) < 1e-4,
                     axis=-1) & (np.asarray(jo.valid) == np.asarray(ref.valid))
        assert ok.mean() > 0.8
    np.testing.assert_array_equal(np.asarray(jo.valid)[ok], npy(to.valid)[ok])
    _close(np.asarray(jo.normal)[ok], npy(to.normal)[ok], dtype, 100.0)
    _close(np.asarray(jo.d)[ok], npy(to.d)[ok], dtype, 100.0)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_fit_line_matches_jax(dtype):
    rng = np.random.default_rng(3)
    n, k = 200, 5
    base = rng.uniform(-5, 5, size=(n, 1, 3))
    d = rng.normal(size=(n, 1, 3))
    t = rng.uniform(-1, 1, size=(n, k, 1))
    nb = base + t * d + rng.normal(size=(n, k, 3)) * np.where(np.arange(n) < 100, 0.01, 0.5)[:, None, None]
    mask = rng.uniform(size=(n, k)) > 0.1
    jn, tn = _both(nb, dtype)
    jo = JF.fit_line(jn, jnp.asarray(mask))
    to = TF.fit_line(tn, torch.as_tensor(mask))
    _close(jo.centroid, to.centroid, dtype)
    _close(_fix_sign(np.asarray(jo.direction, np.float64)[..., None]),
           _fix_sign(npy(to.direction).astype(np.float64)[..., None]), dtype, 100.0)
    np.testing.assert_array_equal(np.asarray(jo.valid), npy(to.valid))
