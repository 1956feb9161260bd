"""ops/features_spin against the JAX package on the same simulated scans.

The stencil, the picks and the downsample are the same operations in the
same order, so the selections (masks, picked columns) agree exactly and the
points to rounding: 1e-12 m in float64; in float32 1e-5 m (centroid sums of
up to a few dozen points in another order inside a voxel).

In float32 the port is held against the JAX function run op by op
(``jax.disable_jit``): the jitted XLA program rounds differently from its own
op-by-op run (it rewrites the voxel-key division by the leaf and fuses the
stencil), and on a plane the flat picks choose among curvatures that are
rounding noise (~1e-8), so one rounding moves a pick and one voxel boundary
reorders the downsampled slots. In float64 the jitted program is used."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lili_om_tpu.ops import features_spin as JF
from lili_om_tpu_torch.frame import sim_scans
from lili_om_tpu_torch.ops import features_spin as TF
from test_torch_common import CPU, assert_close_dicts, npy, tree_dict


TOL = {"float64": 1e-12, "float32": 1e-5}
R, C = 16, 720


@pytest.fixture(scope="module")
def scans():
    s, _ = sim_scans(3, rings=R, cols=C, imu_cap=64, dtype=torch.float64, device=CPU)
    return [(npy(x.img), npy(x.valid), npy(x.rel_time)) for x in s]


def _pair(a, dtype):
    a = np.asarray(a)
    if a.dtype == np.bool_ or np.issubdtype(a.dtype, np.integer):
        return jnp.asarray(a), torch.as_tensor(a)
    return jnp.asarray(a, getattr(jnp, dtype)), torch.as_tensor(a, dtype=getattr(torch, dtype))


def _close(a, b, dtype):
    np.testing.assert_allclose(npy(b).astype(np.float64), np.asarray(a, np.float64),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n_valid", [20, 13])
def test_integrate_gyro(dtype, n_valid):
    rng = np.random.default_rng(0)
    dts, gyrs = rng.uniform(0.004, 0.006, 20), rng.normal(0.0, 0.5, (20, 3))
    mask = np.arange(20) < n_valid
    (jd, td), (jg, tg), (jm, tm) = _pair(dts, dtype), _pair(gyrs, dtype), _pair(mask, dtype)
    _close(JF.integrate_gyro(jd, jg, jm), TF.integrate_gyro(td, tg, tm), dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("extras", [False, True])
def test_undistort(scans, dtype, extras):
    """Slerp deskew; with ``extras`` also the extrinsic conjugation and the
    linear translation deskew."""
    img, valid, rel = scans[1]
    (jp, tp), (jr, tr) = _pair(img.reshape(-1, 3), dtype), _pair(rel.reshape(-1), dtype)
    (jq, tq) = _pair([0.9998, 0.01, -0.015, 0.005] / np.linalg.norm([0.9998, 0.01, -0.015, 0.005]),
                     dtype)
    kw_j, kw_t = {}, {}
    if extras:
        (jl, tl), (jt, tt_) = _pair([0.7071, 0.0, 0.0, 0.7071], dtype), _pair([0.3, 0.1, 0.0], dtype)
        kw_j, kw_t = {"q_lb": jl, "t_scan": jt}, {"q_lb": tl, "t_scan": tt_}
    _close(JF.undistort(jp, jr, jq, **kw_j), TF.undistort(tp, tr, tq, **kw_t), dtype)


@pytest.mark.parametrize("n_rings", [16, 32, 64])
def test_ring_from_angle(n_rings):
    rng = np.random.default_rng(n_rings)
    pts = rng.normal(size=(5000, 3)) * np.array([10.0, 10.0, 2.0])
    jr, jok = JF.ring_from_angle(jnp.asarray(pts), n_rings)
    tr, tok = TF.ring_from_angle(torch.as_tensor(pts), n_rings)
    np.testing.assert_array_equal(npy(tr), np.asarray(jr))
    np.testing.assert_array_equal(npy(tok), np.asarray(jok))


def test_organize_cloud(scans):
    """Pixels hit by exactly one accepted point agree exactly (on collisions
    both sides keep one of the writers, an order neither promises)."""
    img, valid, _ = scans[1]
    pts, v = img.reshape(-1, 3), valid.reshape(-1)
    ji, jv, jr = JF.organize_cloud(jnp.asarray(pts), jnp.asarray(v), R, C)
    ti, tv, tr = TF.organize_cloud(torch.as_tensor(pts), torch.as_tensor(v), R, C)
    np.testing.assert_array_equal(npy(tv), np.asarray(jv))
    ring, ok = (np.asarray(x) for x in JF.ring_from_angle(jnp.asarray(pts), R))
    az = np.arctan2(pts[:, 1], pts[:, 0])
    col = np.floor((az + np.pi) / (2 * np.pi) * C).astype(np.int64) % C
    ok = ok & v
    hits = np.zeros((R, C), int)
    np.add.at(hits, (ring[ok], col[ok]), 1)
    single = hits == 1
    single[0, 0] = False  # rejected points write zeros there
    assert single.sum() > 1000
    np.testing.assert_array_equal(npy(ti)[single], np.asarray(ji)[single])
    np.testing.assert_array_equal(npy(tr)[single], np.asarray(jr)[single])


@pytest.mark.parametrize("mode", ["max", "min"])
def test_curvature_and_local_extremum(scans, mode):
    img, valid, _ = scans[2]
    jc, jok = JF.curvature_image(jnp.asarray(img), jnp.asarray(valid), 5)
    tc, tok = TF.curvature_image(torch.as_tensor(img), torch.as_tensor(valid), 5)
    _close(jc, tc, "float64")
    np.testing.assert_array_equal(npy(tok), np.asarray(jok))
    gate = (np.asarray(jc) > 2.0) if mode == "max" else (np.asarray(jc) < 0.1)
    jcand = JF._local_extremum(jc, jok & jnp.asarray(gate), 5, mode)
    tcand = TF._local_extremum(tc, tok & torch.as_tensor(gate), 5, mode)
    np.testing.assert_array_equal(npy(tcand), np.asarray(jcand))


CFGS = {
    "default": dict(surf_cap=2048),
    "rel_time": dict(surf_cap=2048, carry_rel_time=True, ordered_ds=False),
    "preset": dict(surf_cap=2048, ds_rate=4, per_ring_ds=False),
}


@pytest.mark.parametrize("variant,dtype", [(v, "float64") for v in sorted(CFGS)]
                         + [("default", "float32"), ("rel_time", "float32")])
def test_extract_features_spin(scans, variant, dtype):
    """Every output field: picks exactly, points to rounding."""
    kw = CFGS[variant]
    img, valid, rel = scans[2]
    (ji, ti), (jv, tv), (jr, tr) = _pair(img, dtype), _pair(valid, dtype), _pair(rel, dtype)
    with jax.disable_jit() if dtype == "float32" else contextlib.nullcontext():
        jo = JF.extract_features_spin(ji, jv, jr, JF.SpinFeatureConfig(**kw))
    to = TF.extract_features_spin(ti, tv, tr, TF.SpinFeatureConfig(**kw), device=CPU)
    assert int(np.sum(np.asarray(jo.edge_mask))) > 20
    assert int(np.sum(np.asarray(jo.surf_mask))) > 200
    assert to.surf_pts.dtype == getattr(torch, dtype)
    assert_close_dicts(tree_dict(jo), tree_dict(to), rtol=TOL[dtype], atol=TOL[dtype])
