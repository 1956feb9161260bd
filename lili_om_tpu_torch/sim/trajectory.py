"""Analytic ground-truth trajectories + exact IMU synthesis (port of
``lili_om_tpu/sim/trajectory.py``, the circle trajectory the benchmark
drives). A trajectory is a closure ``t → (p, q)`` over a tensor of times
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
