"""The cell's log, made from ``--seed`` on the device by the benchmark's
frozen copy of the simulator (``lom_ref/sim``): the golden loop of the
port's ``chip_smoke.py:sim_lap`` (a circle at walking speed in the room
world, scans cast from the sensor pose of the preset's extrinsic, the IMU
at the configuration's rate over the whole session, in closed form), and a
room world laid out from the seed. Every seed gives the same route, scan count and IMU
stream; the seed moves the interior walls and the poles."""
from __future__ import annotations

import math
import time
from typing import NamedTuple

import numpy as np
import torch

from lom_ref.sim.lidar import livox_pattern, simulate_scan, spinning_pattern
from lom_ref.ops.preintegration import ImuNoise
from lom_ref.sim.trajectory import circle_trajectory
from lom_ref.sim.world import make_room_world
from lom_ref.utils.math import quat_conj_np, quat_rotate_np

# no pole or interior wall comes closer than this to the route (m): a
# sensor that drives through a wall is not a deployment
ROUTE_CLEARANCE_M = 1.0
LAYOUT_ATTEMPTS = 64
N_BOX_PLANES = 6


class Log(NamedTuple):
    # spin: (img (R,C,3), valid (R,C), rel_time (R,C)); livox: (pts, line, ratio, refl, valid)
    scans: list
    stamps: list  # scan start times (s)
    imu: tuple  # (stamps (N,), accs (N,3), gyrs (N,3)) host float64
    layout_attempt: int  # the draw of the world layout that cleared the route
    seconds: dict  # host seconds of the parts: world, scans, imu


def route(traffic: dict):
    """The traffic's circle: (trajectory, radius, centre xy)."""
    radius = traffic["speed_mps"] * traffic["lap_s"] / (2.0 * math.pi)
    traj = circle_trajectory(radius=radius, period=traffic["lap_s"],
                             height_amp=traffic["height_amp_m"], speed_up=traffic["speed_up_s"])
    return traj, radius, np.array([-radius, 0.0])


def circle_imu(traffic: dict, t0: float, t1: float, rate: float):
    """The route's IMU samples on [t0, t1] at ``rate`` Hz, on the host in
    float64: the simulator's ``simulate_imu`` of the circle (noiseless,
    gravity ``ImuNoise().g_vec``) in closed form. With the turn angle
    θ(t) = ω(t − s(1 − e^(−t/s))) and yaw θ + π/2, the body rate is
    (0, 0, θ') and the specific force is Rᵀ(p̈ − g). The same samples to
    float64 rounding (``tests/test_perfbench_generator.py``), without the
    forward-mode derivatives' seconds of first-use set-up."""
    _, radius, _ = route(traffic)
    omega, s, h = 2.0 * math.pi / traffic["lap_s"], traffic["speed_up_s"], traffic["height_amp_m"]
    n = int(round((t1 - t0) * rate)) + 1
    t = t0 + np.arange(n, dtype=np.float64) / rate
    e = np.exp(-t / s)
    th = omega * (t - s * (1.0 - e))
    d1, d2 = omega * (1.0 - e), omega / s * e
    a = np.stack([-radius * (np.cos(th) * d1 ** 2 + np.sin(th) * d2),
                  radius * (-np.sin(th) * d1 ** 2 + np.cos(th) * d2),
                  h * (-4.0 * np.sin(2.0 * th) * d1 ** 2 + 2.0 * np.cos(2.0 * th) * d2)], axis=1)
    a[:, 2] += ImuNoise().g_norm
    yaw = th + math.pi / 2.0
    c, sn = np.cos(yaw), np.sin(yaw)
    accs = np.stack([c * a[:, 0] + sn * a[:, 1], -sn * a[:, 0] + c * a[:, 1], a[:, 2]], axis=1)
    gyrs = np.stack([np.zeros(n), np.zeros(n), d1], axis=1)
    return t, accs, gyrs


def route_clearance(world, radius: float, centre) -> float:
    """The least horizontal distance from the route's circle to a pole's
    surface or to an interior wall."""
    def to_circle(xy):
        return np.abs(np.linalg.norm(xy - centre, axis=-1) - radius)

    best = np.inf
    base = world.cyl_base.double().cpu().numpy()[:, :2]
    rad = world.cyl_radius.double().cpu().numpy()
    if len(base):
        best = min(best, float(np.min(to_circle(base) - rad)))
    c = world.plane_center.double().cpu().numpy()[N_BOX_PLANES:, :2]
    u = world.plane_u.double().cpu().numpy()[N_BOX_PLANES:, :2]
    half = world.plane_half.double().cpu().numpy()[N_BOX_PLANES:, 0]
    s = np.linspace(-1.0, 1.0, 401)
    for ci, ui, hi in zip(c, u, half):
        best = min(best, float(np.min(to_circle(ci[None] + (s * hi)[:, None] * ui[None]))))
    return best


def world_for_seed(seed: int, traffic: dict, device):
    """The room world of ``seed``: the first layout draw (``[seed,
    attempt]``) that clears the route by ``ROUTE_CLEARANCE_M``."""
    _, radius, centre = route(traffic)
    for attempt in range(LAYOUT_ATTEMPTS):
        world = make_room_world(seed=[seed, attempt], device=device)
        if route_clearance(world, radius, centre) > ROUTE_CLEARANCE_M:
            return world, attempt
    raise RuntimeError(f"no layout of seed {seed} clears the route in {LAYOUT_ATTEMPTS} draws")


def make_log(cfg: dict, traffic: dict, seed: int, device, n_scans: int | None = None) -> Log:
    """The session's log: ``traffic['scans_per_session']`` scans (or
    ``n_scans``) on ``device`` and the IMU stream over them on the host."""
    n = traffic["scans_per_session"] if n_scans is None else n_scans
    period = cfg["scan_period"]
    cuda = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    marks = {}

    def mark(name):
        if cuda:
            torch.cuda.synchronize()
        marks[name] = time.perf_counter() - t0

    traj, _, _ = route(traffic)
    world, attempt = world_for_seed(seed, traffic, device)
    mark("world")
    sensor = cfg["sensor"]
    if sensor["kind"] == "livox":
        pattern = livox_pattern(sensor["lines"], sensor["pts_per_line"], device=device)
    else:
        pattern = spinning_pattern(n_rings=sensor["rings"], n_cols=sensor["cols"], device=device)
    q_lb = np.asarray(cfg["fusion"]["q_lb"], float)
    q_sl = quat_conj_np(q_lb[None])[0]
    t_sl = -quat_rotate_np(q_sl[None], np.asarray(cfg["fusion"]["t_lb"], float)[None])[0]
    scans, stamps = [], []
    for k in range(n):
        sc = simulate_scan(world, traj, k * period, pattern, period=period, t_sl=t_sl, q_sl=q_sl)
        if sensor["kind"] == "livox":
            scans.append((sc.pts, sc.line, sc.rel_time, sc.reflectivity, sc.valid))
        else:
            R, C = sensor["rings"], sensor["cols"]
            scans.append((sc.pts.reshape(R, C, 3), sc.valid.reshape(R, C),
                          sc.rel_time.reshape(R, C)))
        stamps.append(k * period)
    mark("scans")
    host = circle_imu(traffic, 0.0, n * period + period, cfg["imu_rate"])
    mark("imu")
    return Log(scans, stamps, host, attempt, marks)

