"""Analytic ground-truth trajectories + exact IMU synthesis (port of
``lili_om_tpu/sim/trajectory.py``: the circle the benchmark drives, the
corridor run, the aggressive handheld motion and the static pose). A trajectory is a closure ``t → (p, q)`` over a tensor of times
(any shape; p is (...,3), q is (...,4)); IMU samples come from forward-mode
derivatives through it:

  gyro_body = 2 · vec(q(t)⁻¹ ⊗ q̇(t)),   acc_body = R(t)ᵀ (p̈(t) − g_vec)
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Tuple

import torch

from ..ops.preintegration import ImuNoise
from ..utils.math import exp_so3, quat_conj, quat_mul, quat_normalize, quat_to_rotmat

Trajectory = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def circle_trajectory(radius: float = 20.0, period: float = 60.0, height_amp: float = 0.5,
                      speed_up: float = 8.0) -> Trajectory:
    """Closed circular trajectory with a gentle height oscillation, yaw
    tangent to the path, starting at rest."""
    omega = 2.0 * math.pi / period

    def traj(t):
        th = omega * (t - speed_up * (1.0 - torch.exp(-t / speed_up)))
        p = torch.stack([radius * torch.cos(th) - radius, radius * torch.sin(th),
                         height_amp * torch.sin(2.0 * th)], dim=-1)
        yaw = th + math.pi / 2.0
        zero = torch.zeros_like(yaw)
        return p, exp_so3(torch.stack([zero, zero, yaw], dim=-1))

    return traj


def straight_trajectory(speed: float = 2.0, wiggle_amp: float = 0.5, wiggle_period: float = 8.0,
                        yaw_amp: float = 0.08) -> Trajectory:
    """Corridor-style forward motion with a small lateral wiggle and a yaw
    oscillation (keeps the problem observably 6-dof)."""
    w = 2.0 * math.pi / wiggle_period

    def traj(t):
        p = torch.stack([speed * t, wiggle_amp * torch.sin(w * t),
                         0.1 * torch.sin(0.5 * w * t)], dim=-1)
        ang = torch.stack([0.02 * torch.sin(w * t), 0.02 * torch.cos(0.7 * w * t),
                           yaw_amp * torch.sin(0.8 * w * t)], dim=-1)
        return p, exp_so3(ang)

    return traj


def aggressive_trajectory(speed: float = 1.5, yaw_amp: float = 1.0, burst_amp: float = 0.8,
                          burst_freq: float = 2.2, ramp: float = 4.0) -> Trajectory:
    """Fast-rotation, speed-varying handheld-style motion: yaw bursts above
    1.5 rad/s (peak ≈ ``yaw_amp·0.8 + burst_amp·burst_freq`` ≈ 2.6 rad/s at
    the defaults), ±50 % speed modulation and gentle roll/pitch rocking,
    starting at rest."""

    def traj(t):
        u = t - ramp * (1.0 - torch.exp(-t / ramp))  # s(0)=0, s'(0)=0, s'(∞)=1
        p = torch.stack([speed * u + 1.0 * torch.sin(0.6 * u), 2.0 * torch.sin(0.35 * u),
                         0.3 * torch.sin(0.9 * u)], dim=-1)
        yaw = yaw_amp * torch.sin(0.8 * u) + burst_amp * torch.sin(burst_freq * u)
        roll = 0.08 * torch.sin(1.3 * u)
        pitch = 0.08 * torch.sin(1.1 * u + 0.7)
        zero = torch.zeros_like(yaw)
        q = quat_mul(exp_so3(torch.stack([zero, zero, yaw], dim=-1)),
                     exp_so3(torch.stack([roll, pitch, zero], dim=-1)))
        return p, quat_normalize(q)

    return traj


def static_trajectory(p0=(0.0, 0.0, 0.0)) -> Trajectory:
    """A pose at rest at ``p0`` with the identity orientation (broadcast over
    the times' shape, where the JAX closure returns one quaternion)."""

    def traj(t):
        p = torch.tensor(p0, dtype=t.dtype, device=t.device) * torch.ones_like(t)[..., None]
        q = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=t.dtype, device=t.device)
        return p, q.expand(t.shape + (4,))

    return traj


def pose_at(traj: Trajectory, t, dtype=torch.float64, device=None):
    p, q = traj(torch.as_tensor(t, dtype=dtype).to(device))
    return p, quat_normalize(q)


def _d_dt(f):
    """Elementwise time derivative of ``f`` (each output depends only on its
    own time stamp, so one forward-mode product with ones gives it)."""
    return lambda t: torch.func.jvp(f, (t,), (torch.ones_like(t),))[1]


def body_rates(traj: Trajectory, t: torch.Tensor):
    """Exact (gyro_body, acc_world, q) at the times ``t``."""
    pos = lambda tt: traj(tt)[0]
    quat = lambda tt: quat_normalize(traj(tt)[1])
    a_world = _d_dt(_d_dt(pos))(t)
    q = quat(t)
    qdot = _d_dt(quat)(t)
    gyro = 2.0 * quat_mul(quat_conj(q), qdot)[..., 1:]
    return gyro, a_world, q


class ImuSequence(NamedTuple):
    stamps: torch.Tensor  # (N,)
    accs: torch.Tensor  # (N,3) specific force, body frame
    gyrs: torch.Tensor  # (N,3) angular rate, body frame


def simulate_imu(traj: Trajectory, t0: float, t1: float, rate: float = 200.0,
                 noise: ImuNoise = ImuNoise(), acc_bias=(0.0, 0.0, 0.0),
                 gyr_bias=(0.0, 0.0, 0.0), noise_scale: float = 0.0,
                 generator: torch.Generator | None = None,
                 dtype=torch.float64, device=None) -> ImuSequence:
    """IMU samples on [t0, t1] at ``rate`` Hz. ``noise_scale`` scales white
    noise with the densities in ``noise`` (0 → exact), drawn from
    ``generator`` (a CPU ``torch.Generator``)."""
    n = int(round((t1 - t0) * rate)) + 1
    stamps = t0 + torch.arange(n, dtype=dtype, device=device) / rate
    g = noise.g_vec(dtype, device)
    gyrs, a_world, q = body_rates(traj, stamps)
    R = quat_to_rotmat(q)
    accs = torch.einsum("nji,nj->ni", R, a_world - g)  # Rᵀ (a − g)
    accs = accs + torch.tensor(acc_bias, dtype=dtype, device=device)
    gyrs = gyrs + torch.tensor(gyr_bias, dtype=dtype, device=device)
    if noise_scale > 0.0:
        if generator is None:
            raise ValueError("noise_scale > 0 needs a torch.Generator to draw the noise from")
        sqrt_rate = math.sqrt(rate)
        na = torch.randn(accs.shape, generator=generator, dtype=dtype).to(device)
        ng = torch.randn(gyrs.shape, generator=generator, dtype=dtype).to(device)
        accs = accs + noise_scale * noise.acc_n * sqrt_rate * na
        gyrs = gyrs + noise_scale * noise.gyr_n * sqrt_rate * ng
    return ImuSequence(stamps, accs, gyrs)
