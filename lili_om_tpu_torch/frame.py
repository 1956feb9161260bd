"""One scan of the SLAM loop: features → scan-to-map odometry → sliding-window
fusion — the port of the ``frame`` body that ``bench.py`` times at the
``fr_iosb_rot`` parity configuration (64×1800 image, odometry 4096 queries
against a 32768-point map with one matching round, fusion window 3 × local
map 50 with up to 15 solver iterations and 32 IMU samples per interval).

As in ``bench.py``, fusion runs on every scan and never in warmup mode: an
unfilled window has no correspondences and solves on the priors and IMU
factors alone.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .device import resolve_device
from .models.fusion import FusionConfig, FusionOut, fusion_step, init_fusion_state
from .models.odometry import OdometryConfig, OdometryOut, init_state, odometry_step
from .ops.features_spin import SpinFeatureConfig, extract_features_spin
from .ops.preintegration import ImuNoise
from .sim.lidar import simulate_scan, spinning_pattern
from .sim.trajectory import circle_trajectory, simulate_imu
from .sim.world import make_room_world
from .utils.config import load_config

RINGS, COLS, PERIOD, IMU_CAP = 64, 1800, 0.1, 32


class FrameConfigs(NamedTuple):
    features: SpinFeatureConfig
    odometry: OdometryConfig
    fusion: FusionConfig
    noise: ImuNoise


def bench_configs() -> FrameConfigs:
    """The configuration ``bench.py`` runs: the ``fr_iosb_rot`` preset with
    fusion capped at 15 iterations and 32 IMU samples per interval."""
    cfg = load_config("fr_iosb_rot")
    return FrameConfigs(cfg.spin_features, cfg.odometry,
                        cfg.fusion._replace(max_num_iter=15, imu_cap=IMU_CAP),
                        cfg.imu_noise)


class ScanInputs(NamedTuple):
    img: torch.Tensor  # (R,C,3) organized scan
    valid: torch.Tensor  # (R,C)
    rel_time: torch.Tensor  # (R,C)
    imu_dts: torch.Tensor  # (imu_cap,)
    imu_accs: torch.Tensor  # (imu_cap,3)
    imu_gyrs: torch.Tensor  # (imu_cap,3)
    imu_valid: torch.Tensor  # (imu_cap,)


def frame(ostate, fstate, inputs: ScanInputs, cfgs: FrameConfigs, device=None,
          on_stage: Callable[[str], None] | None = None):
    """Run one scan through the three stages. ``on_stage(name)``, if given,
    is called after each stage ("features", "odometry", "fusion"), e.g. to
    time them. Returns (ostate, fstate, OdometryOut, FusionOut)."""
    dev = resolve_device(device)
    mark = on_stage or (lambda name: None)
    fc = extract_features_spin(inputs.img, inputs.valid, inputs.rel_time,
                               cfgs.features, device=dev)
    mark("features")
    ostate, oout = odometry_step(ostate, fc.surf_pts, fc.surf_mask, cfgs.odometry,
                                 n_rounds=cfgs.odometry.scan_match_cnt, device=dev)
    mark("odometry")
    fstate, fout = fusion_step(
        fstate, fc.surf_pts, fc.surf_mask, torch.zeros_like(fc.surf_pts[:, 0]),
        fc.edge_pts, fc.edge_mask, inputs.imu_dts, inputs.imu_accs, inputs.imu_gyrs,
        inputs.imu_valid, cfgs.fusion, cfgs.noise, device=dev)
    mark("fusion")
    return ostate, fstate, oout, fout


class Frame:
    """Owns the configs and both carried states; :meth:`step` runs one scan."""

    def __init__(self, cfgs: FrameConfigs | None = None, dtype=torch.float32, device=None):
        self.device = resolve_device(device)
        self.cfgs = bench_configs() if cfgs is None else cfgs
        self.ostate = init_state(self.cfgs.odometry, dtype=dtype, device=self.device)
        self.fstate = init_fusion_state(self.cfgs.fusion, self.cfgs.noise, dtype=dtype,
                                        device=self.device)

    def step(self, inputs: ScanInputs, on_stage=None):
        self.ostate, self.fstate, oout, fout = frame(self.ostate, self.fstate, inputs,
                                                     self.cfgs, device=self.device,
                                                     on_stage=on_stage)
        return oout, fout


def sim_scans(n: int, rings: int = RINGS, cols: int = COLS, imu_cap: int = IMU_CAP,
              dtype=torch.float32, device=None):
    """The benchmark's input stream: ``n`` scans of the room world along a
    circle of radius 8 m, with the IMU samples of each preceding interval
    padded to ``imu_cap``. Returns (list of ScanInputs, trajectory)."""
    dev = resolve_device(device)
    world = make_room_world(device=dev)
    traj = circle_trajectory(radius=8.0, period=40.0)
    pattern = spinning_pattern(n_rings=rings, n_cols=cols, device=dev)
    scans = []
    for k in range(n):
        s = simulate_scan(world, traj, k * PERIOD, pattern, period=PERIOD)
        imu = simulate_imu(traj, max(k - 1, 0) * PERIOD, k * PERIOD, rate=200.0, device=dev)
        m = min(len(imu.stamps) - 1, imu_cap)
        dts = torch.zeros((imu_cap,), dtype=dtype, device=dev)
        accs = torch.zeros((imu_cap, 3), dtype=dtype, device=dev)
        gyrs = torch.zeros((imu_cap, 3), dtype=dtype, device=dev)
        vm = torch.zeros((imu_cap,), dtype=torch.bool, device=dev)
        dts[:m] = torch.diff(imu.stamps)[:m].to(dtype)
        accs[:m] = imu.accs[1:m + 1].to(dtype)
        gyrs[:m] = imu.gyrs[1:m + 1].to(dtype)
        vm[:m] = True
        scans.append(ScanInputs(s.pts.to(dtype).reshape(rings, cols, 3),
                                s.valid.reshape(rings, cols),
                                s.rel_time.to(dtype).reshape(rings, cols),
                                dts, accs, gyrs, vm))
    return scans, traj
