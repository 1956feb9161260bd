"""ops/features_livox against the JAX package on simulated Livox sweeps, and
the last-writer rule of the binning scatters (``ops/scatter.py``).

The sweeps come from the port's simulator (``livox_pattern`` with 500 points
per line, held against the JAX pattern by test_torch_sim.py) and are binned
at ``n_cols = 500``, matched to that density: a wider image leaves most 6×6
patches under the 25 valid cells the classifier needs and yields no
feature. At this width the sweeps have a few cell collisions.

float64: the same operations in the same order, so the masks and the
binned points agree exactly and the eigenvectors of the accepted surf
patches and edges to 1e-9 (the closed-form 3×3 eigensolver, rounding
only). The normals of rejected patches (non-planar, near-repeated
eigenvalues, or empty) are ill-conditioned, 1e-4 apart even in float64,
and are not compared. float32: held against the JAX function
run op by op (``jax.disable_jit``; the jitted program fuses and rounds
differently, and one rounding of the depth gradient moves a per-line
argmax among near-equal values). The masks, points, edge candidates and
times agree exactly; the eigenvectors of the accepted patches to 3e-4
(VEC_TOL).
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lili_om_tpu.ops import features_livox as JL
from lili_om_tpu.ops import features_spin as JS
from lili_om_tpu_torch.ops import features_livox as TL
from lili_om_tpu_torch.ops import features_spin as TS
from lili_om_tpu_torch.sim.lidar import livox_pattern, simulate_scan
from lili_om_tpu_torch.sim.trajectory import circle_trajectory
from lili_om_tpu_torch.sim.world import make_room_world
from test_torch_common import CPU, npy

PTS_PER_LINE = 500
TIME_TOL = {"float64": 1e-15, "float32": 0.0}
# eigenvectors of the accepted patches; float32: the two covariances are
# summed in different orders and each side's normal lies up to ~1.3e-4 from
# its float64 value, so the two lie up to ~1.2e-4 apart
VEC_TOL = {"float64": 1e-9, "float32": 3e-4}


@pytest.fixture(scope="module")
def sweeps():
    """Two sweeps as numpy (pts, line, ratio, curv, valid)."""
    world = make_room_world(dtype=torch.float64, device=CPU)
    traj = circle_trajectory(radius=8.0, period=40.0)
    pattern = livox_pattern(pts_per_line=PTS_PER_LINE, dtype=torch.float64, device=CPU)
    out = []
    for t in (0.3, 1.1):
        sc = simulate_scan(world, traj, t, pattern)
        out.append((npy(sc.pts), npy(sc.line), npy(sc.rel_time), 0.1 * npy(sc.reflectivity),
                    npy(sc.valid)))
    return out


def _pair(a, dtype):
    a = np.asarray(a)
    if a.dtype == np.bool_ or np.issubdtype(a.dtype, np.integer):
        return jnp.asarray(a), torch.as_tensor(a)
    return jnp.asarray(a, getattr(jnp, dtype)), torch.as_tensor(a, dtype=getattr(torch, dtype))


def _cfgs(**kw):
    return JL.LivoxFeatureConfig(n_cols=PTS_PER_LINE, **kw), \
        TL.LivoxFeatureConfig(n_cols=PTS_PER_LINE, **kw)


def test_config_fields_and_defaults():
    assert JL.LivoxFeatureConfig._fields == TL.LivoxFeatureConfig._fields
    assert JL.LivoxFeatureConfig()._asdict() == TL.LivoxFeatureConfig()._asdict()


@pytest.mark.parametrize("which", [0, 1])
def test_bin_livox_image(sweeps, which):
    """The binned image, reflectivity and validity equal the JAX scatter's,
    collisions included (the sweeps have some)."""
    pts, line, ratio, curv, valid = sweeps[which]
    cols = np.round(ratio * (PTS_PER_LINE - 1)).astype(int)
    _, hits = np.unique((line * PTS_PER_LINE + cols)[valid], return_counts=True)
    assert (hits > 1).sum() > 0
    (jc, tc) = _cfgs()
    args = [_pair(a, "float64") for a in (pts, line, ratio, curv, valid)]
    jo = JL.bin_livox_image(*[a for a, _ in args], jc)
    to = TL.bin_livox_image(*[b for _, b in args], tc)
    for a, b in zip(jo, to):
        np.testing.assert_array_equal(npy(b), np.asarray(a))


def _collision_stream():
    """Points written to shared cells: three valid writers to one cell,
    a valid point at cell (0, 0) followed by rejected points (too near, or
    gated out by reflectivity) that write zeros there, and a valid point
    after them to another cell."""
    pts = np.array([[5.0, 1.0, 0.5], [6.0, -1.0, 0.2], [7.0, 0.5, -0.3],   # cell (2, 10)
                    [8.0, 0.0, 0.0],                                       # cell (0, 0)
                    [0.5, 0.2, 0.1],                                       # rejected: too near
                    [9.0, 1.0, 1.0],                                       # rejected: curv
                    [4.0, 4.0, 4.0]])                                      # cell (3, 7)
    line = np.array([2, 2, 2, 0, 1, 4, 3], np.int32)
    return pts, line, np.array([10, 10, 10, 0, 3, 5, 7]), np.array([1.0] * 5 + [30.0, 1.0])


@pytest.mark.parametrize("binner", ["bin_livox_image", "organize_cloud"])
def test_collisions_last_writer_wins(binner):
    """Both binnings keep the last writer of a cell, as the JAX scatter on
    the CPU does, and rejected points write zeros into cell (0, 0) after a
    valid point there (its validity stays set)."""
    pts, line, cols, curv = _collision_stream()
    valid = np.ones(len(pts), bool)
    if binner == "bin_livox_image":
        H = 20
        ratio = cols / (H - 1)
        jc, tc = JL.LivoxFeatureConfig(n_cols=H), TL.LivoxFeatureConfig(n_cols=H)
        args = [_pair(a, "float64") for a in (pts, line, ratio, curv, valid)]
        jo = JL.bin_livox_image(*[a for a, _ in args], jc)
        to = TL.bin_livox_image(*[b for _, b in args], tc)
        img, img_valid = np.asarray(jo[0]), np.asarray(jo[2])
        assert (img[2, 10] == pts[2]).all() and (img[3, 7] == pts[6]).all()
        assert img_valid[0, 0] and not img[0, 0].any()
    else:
        # a spinning cloud with every point repeated, the copies in reverse
        # order after the originals, a valid point in pixel (0, 0) (ring 0
        # at -15.5°, column 0 at azimuth -179°), then rejected points
        rng = np.random.default_rng(5)
        az = np.append(rng.uniform(-np.pi, np.pi, 400), np.deg2rad(-179.0))
        el = np.deg2rad(np.append(rng.uniform(-14.0, 14.0, 400), -15.5))
        r = np.append(rng.uniform(3.0, 20.0, 400), 10.0)[:, None]
        p = r * np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)], -1)
        pts = np.concatenate([p[:-1], p[-2::-1] * 1.01, p[-1:],
                              [[1.0, 0.0, 5.0], [2.0, 0.0, -9.0]]])
        valid = np.ones(len(pts), bool)
        jo = JS.organize_cloud(jnp.asarray(pts), jnp.asarray(valid), 16, 90)
        to = TS.organize_cloud(torch.as_tensor(pts), torch.as_tensor(valid), 16, 90)
        assert np.asarray(jo[1])[0, 0] and not np.asarray(jo[0])[0, 0].any()
    for a, b in zip(jo, to):
        np.testing.assert_array_equal(npy(b), np.asarray(a))


def _features(sweep, dtype, **kw):
    jc, tc = _cfgs(**kw)
    args = [_pair(a, dtype) for a in sweep]
    with jax.disable_jit() if dtype == "float32" else contextlib.nullcontext():
        jo = JL.extract_features_livox(*JL.bin_livox_image(*[a for a, _ in args], jc), jc)
    to = TL.extract_features_livox(*TL.bin_livox_image(*[b for _, b in args], tc), tc,
                                   device=CPU)
    return jo, to


@pytest.mark.parametrize("which,dtype", [(0, "float64"), (1, "float64"), (0, "float32"),
                                         (1, "float32")])
def test_extract_features_livox(sweeps, which, dtype):
    jo, to = _features(sweeps[which], dtype)
    assert to.surf_pts.dtype == getattr(torch, dtype)
    assert int(np.sum(np.asarray(jo.surf_mask))) > 500
    assert int(np.sum(np.asarray(jo.edge_mask))) > 20
    for f in ("surf_mask", "edge_mask", "full_mask", "surf_pts", "surf_curv", "edge_pts",
              "full_pts"):
        np.testing.assert_array_equal(npy(getattr(to, f)), np.asarray(getattr(jo, f)),
                                      err_msg=f)
    # the column → time division: the jitted float64 program rounds it
    # differently (1 ulp); the op-by-op float32 run the same
    for f in ("surf_rel_time", "edge_rel_time"):
        np.testing.assert_allclose(npy(getattr(to, f)), np.asarray(getattr(jo, f)),
                                   rtol=0.0, atol=TIME_TOL[dtype], err_msg=f)
    sm, em = np.asarray(jo.surf_mask), np.asarray(jo.edge_mask)
    for f, m in (("surf_normal", sm), ("edge_dir", em)):
        a, b = np.asarray(getattr(jo, f)), npy(getattr(to, f))
        np.testing.assert_allclose(b[m], a[m], atol=VEC_TOL[dtype], err_msg=f)


def test_depth_gradient_wraps_like_jax(sweeps):
    """The 9-tap gradient rolls across the image border as the JAX one does."""
    rng = np.random.default_rng(3)
    depth = rng.uniform(0.0, 30.0, (6, 40)) * (rng.uniform(size=(6, 40)) > 0.2)
    jc, tc = JL.LivoxFeatureConfig(n_cols=40), TL.LivoxFeatureConfig(n_cols=40)
    np.testing.assert_allclose(npy(TL._depth_gradient(torch.as_tensor(depth), tc)),
                               np.asarray(JL._depth_gradient(jnp.asarray(depth), jc)),
                               rtol=1e-13, atol=1e-13)


def test_too_wide_image_starves(sweeps):
    """The n_cols trap: the 500-point lines binned into the Horizon's 4000
    columns fill ~1/8 of each patch, and no feature survives on either side."""
    pts, line, ratio, curv, valid = sweeps[0]
    jc, tc = JL.LivoxFeatureConfig(), TL.LivoxFeatureConfig()
    args = [_pair(a, "float64") for a in (pts, line, ratio, curv, valid)]
    jo = JL.extract_features_livox(*JL.bin_livox_image(*[a for a, _ in args], jc), jc)
    to = TL.extract_features_livox(*TL.bin_livox_image(*[b for _, b in args], tc), tc,
                                   device=CPU)
    assert not np.asarray(jo.surf_mask).any() and not npy(to.surf_mask).any()
    assert not np.asarray(jo.edge_mask).any() and not npy(to.edge_mask).any()
