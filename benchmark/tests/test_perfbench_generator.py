"""The benchmark's frozen generator gives, for a seed, the same world,
scans and IMU stream as the port's ``sim/`` (this test imports the port;
the harness does not)."""
import numpy as np
import pytest
import torch

from lili_om_tpu_torch.sim import lidar as plidar
from lili_om_tpu_torch.sim import trajectory as ptraj
from lili_om_tpu_torch.sim import world as pworld
from lom_bench import logs
from lom_ref.sim import lidar as rlidar
from lom_ref.sim import trajectory as rtraj
from lom_ref.sim import world as rworld


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 17])
def test_world_equals_the_ports(seed):
    a = rworld.make_room_world(seed=[seed, 1])
    b = pworld.make_room_world(seed=[seed, 1])
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("livox", [False, True])
def test_scans_and_imu_equal_the_ports(livox):
    w = rworld.make_room_world(seed=[5, 0])
    pw = pworld.make_room_world(seed=[5, 0])
    rt = rtraj.circle_trajectory(radius=2.0, period=11.0, speed_up=3.0)
    pt = ptraj.circle_trajectory(radius=2.0, period=11.0, speed_up=3.0)
    if livox:
        ra, pa = rlidar.livox_pattern(6, 200), plidar.livox_pattern(6, 200)
    else:
        ra, pa = rlidar.spinning_pattern(8, 90), plidar.spinning_pattern(8, 90)
    for t0 in (0.0, 0.7, 3.3):
        x = rlidar.simulate_scan(w, rt, t0, ra, t_sl=(0.1, 0.0, -0.1), q_sl=(0.7071, 0, 0, 0.7071))
        y = plidar.simulate_scan(pw, pt, t0, pa, t_sl=(0.1, 0.0, -0.1), q_sl=(0.7071, 0, 0, 0.7071))
        for u, v in zip(x, y):
            assert torch.equal(u, v)
    ia = rtraj.simulate_imu(rt, 0.0, 1.0, rate=200.0)
    ib = ptraj.simulate_imu(pt, 0.0, 1.0, rate=200.0)
    for u, v in zip(ia, ib):
        assert torch.equal(u, v)


def test_log_is_the_golden_lap_of_the_seed():
    cfg = {"scan_period": 0.1, "imu_rate": 200.0,
           "sensor": {"kind": "spin", "rings": 8, "cols": 90},
           "fusion": {"q_lb": [0.7071, 0.0, 0.0, 0.7071], "t_lb": [-0.18, 0.0, -0.095]}}
    traffic = {"speed_mps": 1.3, "lap_s": 11.0, "speed_up_s": 3.0, "height_amp_m": 0.5,
               "scans_per_session": 240}
    a = logs.make_log(cfg, traffic, 99, "cpu", n_scans=3)
    b = logs.make_log(cfg, traffic, 99, "cpu", n_scans=3)
    for sa, sb in zip(a.scans, b.scans):
        for x, y in zip(sa, sb):
            assert torch.equal(x, y)
    world, attempt = logs.world_for_seed(99, traffic, "cpu")
    assert attempt == a.layout_attempt
    assert logs.route_clearance(world, *logs.route(traffic)[1:]) > logs.ROUTE_CLEARANCE_M
    # the same scan from the port's simulator at the same pose and layout
    radius = 1.3 * 11.0 / (2 * np.pi)
    traj = ptraj.circle_trajectory(radius=radius, period=11.0, speed_up=3.0)
    q_sl = np.array([0.7071, 0.0, 0.0, -0.7071])
    from lom_ref.utils.math import quat_rotate_np
    t_sl = -quat_rotate_np(q_sl[None], np.array([[-0.18, 0.0, -0.095]]))[0]
    sc = plidar.simulate_scan(pworld.make_room_world(seed=[99, attempt]), traj, 0.2,
                              plidar.spinning_pattern(8, 90), t_sl=t_sl, q_sl=q_sl)
    assert torch.equal(sc.pts.reshape(8, 90, 3), a.scans[2][0])
    assert len(a.imu[0]) == int(round(0.4 * 200)) + 1


def test_closed_form_imu_is_the_simulators():
    traffic = {"speed_mps": 1.3, "lap_s": 11.0, "speed_up_s": 3.0, "height_amp_m": 0.5}
    traj, _, _ = logs.route(traffic)
    ref = rtraj.simulate_imu(traj, 0.0, 24.1, rate=200.0)
    t, accs, gyrs = logs.circle_imu(traffic, 0.0, 24.1, 200.0)
    np.testing.assert_array_equal(t, ref.stamps.numpy())
    np.testing.assert_allclose(accs, ref.accs.numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(gyrs, ref.gyrs.numpy(), rtol=0, atol=1e-12)
