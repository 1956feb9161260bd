"""The port's simulator against the JAX package's: the same world, pattern,
scans and noise-free IMU samples, so the scans chip_smoke.py runs are the
scans the parity tests hold."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lili_om_tpu.sim import lidar as JL
from lili_om_tpu.sim import trajectory as JT
from lili_om_tpu.sim import world as JW
from lili_om_tpu_torch.sim import lidar as TL
from lili_om_tpu_torch.sim import trajectory as TT
from lili_om_tpu_torch.sim import world as TW
from test_torch_common import npy

R, C = 16, 720


@pytest.fixture(scope="module")
def worlds():
    return JW.make_room_world(), TW.make_room_world()


def _trajs():
    return (JT.circle_trajectory(radius=8.0, period=40.0),
            TT.circle_trajectory(radius=8.0, period=40.0))


def test_world_arrays_identical(worlds):
    jw, tw = worlds
    for name, a, b in zip(jw._fields, jw, tw):
        np.testing.assert_array_equal(np.asarray(a), npy(b), err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_spinning_pattern(dtype):
    # f32: the two linspace implementations round differently (1 ulp of
    # the elevation/azimuth grids); f64: the same to 1e-15
    jp = JL.spinning_pattern(R, C, dtype=getattr(jnp, dtype))
    tp = TL.spinning_pattern(R, C, dtype=getattr(torch, dtype))
    tol = 2e-6 if dtype == "float32" else 1e-14
    for name, a, b in zip(jp._fields, jp, tp):
        np.testing.assert_allclose(np.asarray(a, np.float64), npy(b).astype(np.float64),
                                   atol=tol, err_msg=name)


@pytest.mark.parametrize("t_start", [0.0, 0.3, 1.7])
def test_scan_f64(worlds, t_start):
    """f64 rays against the f32 world: points agree to 1e-8 m (rounding,
    amplified at grazing incidence by range·cot(angle) ≲ 1e4) and the
    validity is identical."""
    jw, tw = worlds
    jtr, ttr = _trajs()
    js = JL.simulate_scan(jw, jtr, t_start, JL.spinning_pattern(R, C, dtype=jnp.float64))
    ts = TL.simulate_scan(tw, ttr, t_start, TL.spinning_pattern(R, C, dtype=torch.float64))
    np.testing.assert_array_equal(np.asarray(js.valid), npy(ts.valid))
    np.testing.assert_allclose(np.asarray(js.pts), npy(ts.pts), atol=1e-8)
    np.testing.assert_allclose(np.asarray(js.reflectivity), npy(ts.reflectivity), atol=1e-8)


def test_scan_f32_same_pattern(worlds):
    """f32, the JAX pattern fed to both: the validity is identical and points
    agree to 2e-4 m — f32 trig/ray rounding (~1e-7 relative) amplified at
    grazing incidence by range·cot(angle)."""
    jw, tw = worlds
    jtr, ttr = _trajs()
    jp = JL.spinning_pattern(R, C)
    tp = TL.ScanPattern(*[torch.as_tensor(np.array(a)) for a in jp])
    js = JL.simulate_scan(jw, jtr, 0.3, jp)
    ts = TL.simulate_scan(tw, ttr, 0.3, tp)
    np.testing.assert_array_equal(np.asarray(js.valid), npy(ts.valid))
    np.testing.assert_allclose(np.asarray(js.pts), npy(ts.pts), atol=2e-4)


@pytest.mark.parametrize("t0,t1", [(0.0, 0.0), (0.2, 0.3), (2.0, 2.1)])
def test_imu_noise_free(t0, t1):
    """Exact IMU samples by autodiff on both sides (f64): agree to 1e-12."""
    jtr, ttr = _trajs()
    ji = JT.simulate_imu(jtr, t0, t1, rate=200.0)
    ti = TT.simulate_imu(ttr, t0, t1, rate=200.0)
    for name, a, b in zip(ji._fields, ji, ti):
        np.testing.assert_allclose(np.asarray(a), npy(b), atol=1e-12, err_msg=name)


def test_imu_noise_uses_generator():
    """Noise is drawn from the caller's generator: same seed, same samples."""
    _, ttr = _trajs()
    a = TT.simulate_imu(ttr, 0.0, 0.1, noise_scale=1.0,
                        generator=torch.Generator().manual_seed(3))
    b = TT.simulate_imu(ttr, 0.0, 0.1, noise_scale=1.0,
                        generator=torch.Generator().manual_seed(3))
    clean = TT.simulate_imu(ttr, 0.0, 0.1)
    np.testing.assert_array_equal(npy(a.accs), npy(b.accs))
    assert np.abs(npy(a.accs) - npy(clean.accs)).max() > 0


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_livox_pattern(dtype):
    """The Horizon-like pattern at its full width (6 × 4000): directions to
    3e-6 in float32 (the two linspace implementations and the f32 sin/cos
    round differently), 1e-14 in float64; times and lines the same."""
    jp = JL.livox_pattern(dtype=getattr(jnp, dtype))
    tp = TL.livox_pattern(dtype=getattr(torch, dtype))
    assert tp.dirs.shape == (24000, 3) and tp.dirs.dtype == getattr(torch, dtype)
    tol = 3e-6 if dtype == "float32" else 1e-14
    for name, a, b in zip(jp._fields, jp, tp):
        np.testing.assert_allclose(np.asarray(a, np.float64), npy(b).astype(np.float64),
                                   atol=tol, err_msg=name)


def test_livox_scan_f64(worlds):
    """A Livox sweep cast from the preset's sensor pose: points, validity
    and reflectivity as the JAX simulator gives them (f64, as test_scan_f64)."""
    jw, tw = worlds
    jtr, ttr = _trajs()
    t_sl, q_sl = np.array([0.03, -0.02, -0.05]), np.array([0.0, 0.0, 0.0, 1.0])
    js = JL.simulate_scan(jw, jtr, 0.7, JL.livox_pattern(pts_per_line=680, dtype=jnp.float64),
                          t_sl=t_sl, q_sl=q_sl)
    ts = TL.simulate_scan(tw, ttr, 0.7, TL.livox_pattern(pts_per_line=680, dtype=torch.float64),
                          t_sl=t_sl, q_sl=q_sl)
    np.testing.assert_array_equal(np.asarray(js.valid), npy(ts.valid))
    np.testing.assert_array_equal(np.asarray(js.line), npy(ts.line))
    np.testing.assert_allclose(np.asarray(js.pts), npy(ts.pts), atol=1e-8)
    np.testing.assert_allclose(np.asarray(js.reflectivity), npy(ts.reflectivity), atol=1e-8)


TRAJS = {"straight": dict(), "aggressive": dict(), "static": dict(p0=(1.0, -2.0, 0.5))}


def _named_trajs(name):
    kw = TRAJS[name]
    return getattr(JT, f"{name}_trajectory")(**kw), getattr(TT, f"{name}_trajectory")(**kw)


@pytest.mark.parametrize("name", sorted(TRAJS))
def test_other_trajectories_poses_and_imu(name):
    """The corridor, aggressive and static trajectories: poses at a few
    times and the exact IMU samples by autodiff (f64), to 1e-12 as the
    circle's."""
    jtr, ttr = _named_trajs(name)
    for t in (0.0, 0.7, 5.3):
        for a, b in zip(JT.pose_at(jtr, t), TT.pose_at(ttr, t)):
            np.testing.assert_allclose(np.asarray(a), npy(b), atol=1e-12, err_msg=f"{name} {t}")
    ji = JT.simulate_imu(jtr, 5.0, 5.2, rate=200.0)
    ti = TT.simulate_imu(ttr, 5.0, 5.2, rate=200.0)
    for field, a, b in zip(ji._fields, ji, ti):
        np.testing.assert_allclose(np.asarray(a), npy(b), atol=1e-12, err_msg=f"{name} {field}")


def test_aggressive_trajectory_has_fast_yaw_bursts():
    """tests/test_golden_motion.py's check on the port: body rates above
    1.5 rad/s inside its 6 s window."""
    ttr = TT.aggressive_trajectory()
    gyro, _, _ = TT.body_rates(ttr, torch.linspace(5.0, 12.0, 300, dtype=torch.float64))
    assert float(torch.linalg.norm(gyro, dim=-1).max()) > 1.5


def test_corridor_world_and_scan():
    """The corridor world's arrays are identical; a f64 sweep along the
    straight trajectory agrees as test_scan_f64's (1e-8 m, same validity)."""
    jw, tw = JW.make_corridor_world(), TW.make_corridor_world()
    for field, a, b in zip(jw._fields, jw, tw):
        np.testing.assert_array_equal(np.asarray(a), npy(b), err_msg=field)
    jtr, ttr = _named_trajs("straight")
    js = JL.simulate_scan(jw, jtr, 1.3, JL.spinning_pattern(R, C, dtype=jnp.float64))
    ts = TL.simulate_scan(tw, ttr, 1.3, TL.spinning_pattern(R, C, dtype=torch.float64))
    np.testing.assert_array_equal(np.asarray(js.valid), npy(ts.valid))
    np.testing.assert_allclose(np.asarray(js.pts), npy(ts.pts), atol=1e-8)
