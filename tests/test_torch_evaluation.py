"""utils/evaluation and utils/config.dump_config against the JAX package:
TUM files byte for byte, the association's tie and miss rules, Umeyama
alignment, ATE and RPE on the same arrays (float64, to 1e-12: the same
numpy formulas, the RPE's rotation by the port's numpy quaternion twins
where JAX uses its own, ~1e-16 apart), the system export of a port run
loaded into the JAX system, and every preset's config dump."""
import numpy as np
import pytest
import torch

from lili_om_tpu.io import checkpoint as JCK
from lili_om_tpu.utils import config as JC
from lili_om_tpu.utils import evaluation as JE
from lili_om_tpu_torch.io import checkpoint as TCK
from lili_om_tpu_torch.utils import config as TC
from lili_om_tpu_torch.utils import evaluation as TE
from test_torch_common import jax_tiny_system, tiny_run


def _traj(seed, n=40):
    rng = np.random.default_rng(seed)
    stamps = np.cumsum(rng.uniform(0.05, 0.15, n))
    t = np.cumsum(rng.normal(size=(n, 3)), axis=0)
    q = rng.normal(size=(n, 4))
    return stamps, t, q / np.linalg.norm(q, axis=1, keepdims=True)


def _random_se3(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    R = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                  [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                  [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
    return R, rng.normal(size=3) * 5


@pytest.mark.parametrize("as_tensor", [False, True])
def test_export_tum_bytes_and_reload(tmp_path, as_tensor):
    """The same text as JAX's writer (``%.6f``, x y z w order), from numpy or
    from tensors; both readers give the same arrays back, within the
    format's 5e-7."""
    stamps, t, q = _traj(0)
    pj, pt = tmp_path / "j.tum", tmp_path / "t.tum"
    JE.export_tum(str(pj), stamps, t, q)
    if as_tensor:
        TE.export_tum(str(pt), torch.as_tensor(stamps), torch.as_tensor(t), torch.as_tensor(q))
    else:
        TE.export_tum(str(pt), list(stamps), t, q)
    assert pt.read_bytes() == pj.read_bytes()
    for a, b in zip(JE.load_tum(str(pj)), TE.load_tum(str(pt))):
        np.testing.assert_array_equal(b, a)
    s, tt, qq = TE.load_tum(str(pt))
    for got, want in ((s, stamps), (tt, t), (qq, q)):
        np.testing.assert_allclose(got, want, atol=5e-7)
    empty = tmp_path / "e.tum"
    empty.write_text("# nothing\n\n")
    assert [x.shape for x in TE.load_tum(str(empty))] == [(0,), (0, 3), (0, 4)]


def test_associate_ties_and_misses():
    """An estimate halfway between two truth stamps takes the later one; one
    past ``max_dt`` from every truth stamp is dropped; ends clip."""
    gt = np.array([0.0, 0.25, 0.5, 0.75, 1.0])  # binary-exact: the ties are exact
    est = np.array([-0.01, 0.125, 0.375, 0.8, 1.01, 2.0, 0.625])
    for max_dt in (0.02, 0.13):
        ie, ig = TE.associate(est, gt, max_dt)
        je, jg = JE.associate(est, gt, max_dt)
        np.testing.assert_array_equal(ie, je)
        np.testing.assert_array_equal(ig, jg)
    ie, ig = TE.associate(est, gt, 0.13)
    assert dict(zip(ie.tolist(), ig.tolist())) == {0: 0, 1: 1, 2: 2, 3: 3, 4: 4, 6: 3}
    ie, ig = TE.associate(est, gt, 0.02)  # the halfway estimates are now misses
    assert dict(zip(ie.tolist(), ig.tolist())) == {0: 0, 4: 4}


@pytest.mark.parametrize("with_scale", [False, True])
def test_align_umeyama_recovers_a_known_transform(with_scale):
    rng = np.random.default_rng(1)
    _, est, _ = _traj(1)
    R, t = _random_se3(rng)
    s = 1.7 if with_scale else 1.0
    gt = (s * (R @ est.T)).T + t
    got = TE.align_umeyama(est, gt, with_scale=with_scale)
    want = JE.align_umeyama(est, gt, with_scale=with_scale)
    np.testing.assert_allclose(got[0], s, rtol=1e-12)
    np.testing.assert_allclose(got[1], R, atol=1e-12)
    np.testing.assert_allclose(got[2], t, atol=1e-10)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("align", [False, True])
def test_ate_and_rpe_match_jax(align):
    """Noisy, transformed, time-jittered estimates against the truth: the
    same ATE and RPE statistics as JAX's to 1e-12."""
    rng = np.random.default_rng(2)
    gs, gt, gq = _traj(2, n=60)
    R, t = _random_se3(rng)
    est = (R @ gt.T).T + t + 0.05 * rng.normal(size=gt.shape)
    eq = gq + 0.01 * rng.normal(size=gq.shape)
    eq /= np.linalg.norm(eq, axis=1, keepdims=True)
    es = gs + rng.uniform(-0.01, 0.01, len(gs))
    got = TE.ate_rmse(es, torch.as_tensor(est), gs, gt, align=align)
    want = JE.ate_rmse(es, est, gs, gt, align=align)
    assert got["n"] == want["n"] == 60
    for k in ("rmse", "mean", "max"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12)
    for delta in (1, 5, 10):
        got = TE.rpe(es, est, torch.as_tensor(eq), gs, gt, gq, delta=delta)
        want = JE.rpe(es, est, eq, gs, gt, gq, delta=delta)
        assert got["n"] == want["n"] == 60 - delta
        for k in ("rmse", "mean", "max"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12)
    few = TE.ate_rmse(es[:1], est[:1], gs, gt)
    assert few["n"] == 1 and np.isnan(few["rmse"])


def test_rpe_too_short_is_nan():
    gs, gt, gq = _traj(3, n=5)
    for mod in (TE, JE):
        r = mod.rpe(gs, gt, gq, gs, gt, gq, delta=5)
        assert r["n"] == 0 and np.isnan(r["rmse"])


@pytest.fixture(scope="module")
def tiny_exports(tmp_path_factory):
    """A port run of ``tiny_system`` (8 scans), checkpointed and loaded into
    the JAX system; both export their frame and keyframe trajectories."""
    d = tmp_path_factory.mktemp("tum")
    t = tiny_run(8)
    TCK.save_system(str(d / "ck"), t)
    j = jax_tiny_system()
    JCK.load_system(str(d / "ck"), j)
    paths = {}
    for name, mod, s in (("port", TE, t), ("jax", JE, j)):
        paths[name] = (str(d / f"{name}_frames.tum"), str(d / f"{name}_kf.tum"))
        mod.export_system_tum(s, *paths[name])
    return t, paths


def test_export_system_tum_matches_jax(tiny_exports):
    t, paths = tiny_exports
    assert len(t.kf_stamps) >= 3 and len(t.dense_trajectory) == 8
    for a, b in zip(paths["jax"], paths["port"]):
        assert open(b, "rb").read() == open(a, "rb").read()
    s, tt, _ = TE.load_tum(paths["port"][1])
    np.testing.assert_allclose(s, t.kf_stamps, atol=5e-7)
    np.testing.assert_allclose(tt, t.graph.t[:len(t.kf_stamps)].numpy(), atol=5e-7)


@pytest.mark.parametrize("preset", sorted(JC.PRESETS))
def test_dump_config_matches_jax(preset):
    assert TC.dump_config(TC.load_config(preset)) == JC.dump_config(JC.load_config(preset))
