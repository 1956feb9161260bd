"""End-to-end synthetic frontend run: the port's counterpart of
``examples/run_synthetic.py``. Spinning-LiDAR sweeps of a simulated room
(or, with ``--corridor``, a corridor driven straight) go through gyro
undistortion, spin features and scan-to-map odometry; it prints per-frame
progress, the final ATE and the odometry's scan rate.

    python -m lili_om_tpu_torch.apps.run_synthetic [n_frames] [--corridor] [--cpu]

The exit code is 1 when the ATE is 0.3 m or more (the JAX example's bound).
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..models.odometry import OdometryConfig
from ..ops.features_spin import SpinFeatureConfig

R, C, PERIOD = 16, 900, 0.1
ATE_BOUND_M = 0.3
FEAT_CFG = SpinFeatureConfig(surf_cap=4096)
ODO_CFG = OdometryConfig(n_recent_frames=10, scan_cap=4096, query_cap=1024, map_cap=16384)


def run(n_frames: int, corridor: bool = False, device=None, dtype=torch.float32,
        log=print) -> dict:
    """Drive the frontend over ``n_frames`` sweeps; returns the ATE (m), its
    max, the estimated and true positions and the odometry scan rate."""
    from ..device import resolve_device
    from ..models.odometry import init_state, odometry_step
    from ..ops.features_spin import extract_features_spin, integrate_gyro, undistort
    from ..sim.lidar import simulate_scan, spinning_pattern
    from ..sim.trajectory import circle_trajectory, pose_at, simulate_imu, straight_trajectory
    from ..sim.world import make_corridor_world, make_room_world
    from ..utils.evaluation import host
    from ..utils.math import pose_relative

    dev = resolve_device(device)
    if corridor:
        world, traj = make_corridor_world(device=dev), straight_trajectory(speed=1.5)
    else:
        world, traj = make_room_world(device=dev), circle_trajectory(radius=8.0, period=40.0)
    pattern = spinning_pattern(n_rings=R, n_cols=C, device=dev)
    fcfg, ocfg = FEAT_CFG, ODO_CFG

    state = init_state(ocfg, dtype=dtype, device=dev)
    t0w, q0w = pose_at(traj, 0.0, device=dev)
    est, gt = [], []
    t_start = time.time()
    odo_time = 0.0
    for k in range(n_frames):
        ts = k * PERIOD
        scan = simulate_scan(world, traj, ts, pattern, period=PERIOD)
        imu = simulate_imu(traj, ts, ts + PERIOD, rate=200.0, device=dev)
        q_scan = integrate_gyro(torch.diff(imu.stamps), imu.gyrs[1:])
        # the float64 IMU promotes the sweep, as JAX's type promotion does
        pts_u = undistort(scan.pts.to(q_scan.dtype), scan.rel_time.to(q_scan.dtype), q_scan)
        fc = extract_features_spin(pts_u.reshape(R, C, 3).to(dtype), scan.valid.reshape(R, C),
                                   scan.rel_time.reshape(R, C).to(dtype), fcfg, device=dev)
        t1 = time.time()
        rounds = ocfg.max_rounds if k < 2 else ocfg.scan_match_cnt
        state, out = odometry_step(state, fc.surf_pts, fc.surf_mask, ocfg, n_rounds=rounds,
                                   device=dev)
        t_est = host(out.t)  # one transfer ends the frame's work
        if k >= 2:  # the first two frames run the bootstrap rounds
            odo_time += time.time() - t1
        rt, _ = pose_relative(t0w, q0w, *pose_at(traj, ts, device=dev))
        est.append(t_est.astype(np.float64))
        gt.append(host(rt))
        if k % 5 == 0:
            log(f"frame {k:3d}  est={t_est.round(3)}  gt={gt[-1].round(3)}  "
                f"kf={bool(out.is_keyframe)}  corr={int(out.n_corr)}")
    err = np.linalg.norm(np.stack(est) - np.stack(gt), axis=1)
    n_timed = max(n_frames - 2, 1)
    return {"ate": float(np.sqrt((err ** 2).mean())), "max": float(err.max()),
            "est": np.stack(est), "gt": np.stack(gt),
            "odo_scans_per_s": n_timed / max(odo_time, 1e-9), "wall": time.time() - t_start}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_frames", nargs="?", type=int, default=20)
    ap.add_argument("--corridor", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    args = ap.parse_args(argv)
    r = run(args.n_frames, args.corridor, device="cpu" if args.cpu else None)
    print(f"\nATE RMSE: {r['ate']:.4f} m  (max {r['max']:.4f} m) over {args.n_frames} frames")
    print(f"odometry throughput: {r['odo_scans_per_s']:.1f} scans/s "
          f"(total wall {r['wall']:.1f}s incl. sim+features)")
    return 0 if r["ate"] < ATE_BOUND_M else 1


if __name__ == "__main__":
    sys.exit(main())
