"""Full-loop demo: a closed circle through the whole system (frontend →
backend fusion → global graph), loop closure on each revisit, and the ATE
before and after the graph correction. The port's counterpart of
``examples/run_loop_closure.py`` (the synthetic stand-in for the
reference's campus-loop bag, README.md:57-76).

    python -m lili_om_tpu_torch.apps.run_loop_closure [--cpu] [--frames N] [--export-dir DIR]

``--export-dir`` writes the TUM trajectory, the PCD and PLY map and the
overview PNG (``utils/viz.py:export_run``; the PNG needs matplotlib).
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

R, C, PERIOD = 16, 720, 0.1


def make_system(n: int, period_s: float, device=None, dtype=torch.float32):
    """The demo's system: the JAX example's capacities and loop closure
    (a closure every lap, 5 m search radius)."""
    from ..models.fusion import FusionConfig
    from ..models.odometry import OdometryConfig
    from ..models.system import LiliOmSystem
    from ..ops.features_spin import SpinFeatureConfig
    from ..utils.config import LoopClosureConfig

    return LiliOmSystem(
        odo_cfg=OdometryConfig(n_recent_frames=10, scan_cap=4096, query_cap=1024,
                               map_cap=16384),
        fusion_cfg=FusionConfig(window=3, local_map_width=20, kf_surf_cap=4096,
                                kf_edge_cap=1024, map_surf_cap=32768, map_edge_cap=4096,
                                use_reflectivity=False, weight_gate=0.3,
                                lidar_const=7.5, max_num_iter=6, imu_cap=64),
        feat_cfg=SpinFeatureConfig(surf_cap=4096),
        lc_cfg=LoopClosureConfig(time_thres=max(10.0, period_s / 3), search_radius=5.0,
                                 icp_thres=0.3, map_width=6, latest_width=1),
        graph_capacity=max(256, n), dtype=dtype, device=device)


def run(n: int, device=None, export_dir=None, system=None, log=print) -> dict:
    """Drive ``n`` scans of the circle (laps capped at 75 s so long runs
    revisit several times) through ``system`` (default: :func:`make_system`;
    a caller's system gets the same IMU stream and scans).
    Returns the system, the per-frame truth, the closures and both ATEs."""
    from ..device import resolve_device
    from ..sim.lidar import simulate_scan, spinning_pattern
    from ..sim.trajectory import circle_trajectory, pose_at, simulate_imu
    from ..sim.world import make_room_world
    from ..utils.evaluation import host
    from ..utils.math import pose_relative

    dev = resolve_device(device)
    # walking speed (~1.3 m/s, the reference's datasets): gyro-only
    # undistortion leaves translation distortion uncorrected, so faster
    # motion degrades the frontend, as in the reference. Laps of 10–75 s:
    # the JAX example's (n − 30)·0.1 s has no lap below 31 frames, so the
    # floor is evaluate_presets.py's
    period_s = min(max((n - 30) * PERIOD, 10.0), 75.0)
    radius = min(6.0, 1.3 * period_s / (2 * 3.14159))
    traj = circle_trajectory(radius=radius, period=period_s, speed_up=3.0)
    world = make_room_world(device=dev)
    pattern = spinning_pattern(n_rings=R, n_cols=C, device=dev)
    sys_ = make_system(n, period_s, device=dev) if system is None else system
    sys_.deskew_translation = True  # constant-velocity translation deskew

    imu = simulate_imu(traj, 0.0, n * PERIOD + PERIOD, rate=200.0, device=dev)
    sys_.push_imu(*(host(x) for x in imu))
    t0w, q0w = pose_at(traj, 0.0, device=dev)
    gts, loops = [], 0
    t_start = time.time()
    for k in range(n):
        ts = k * PERIOD
        scan = simulate_scan(world, traj, ts, pattern, period=PERIOD)
        sys_.process_scan(scan.pts.reshape(R, C, 3), scan.valid.reshape(R, C),
                          scan.rel_time.reshape(R, C), ts)
        gts.append(host(pose_relative(t0w, q0w, *pose_at(traj, ts, device=dev))[0]))
        if k % 10 == 0 and k > 0 and sys_.try_loop_closure():  # the 1 Hz loop thread
            loops += 1
            log(f"  loop closure fired at frame {k}")
        if k % 50 == 0:
            log(f"frame {k:4d}  kf={len(sys_.kf_stamps):3d}  "
                f"est={np.asarray(sys_.trajectory[-1]).round(2)}  gt={gts[-1].round(2)}")
    wall = time.time() - t_start
    err = np.linalg.norm(np.stack([host(t) for t in sys_.trajectory]) - np.stack(gts), axis=1)
    nk = len(sys_.kf_stamps)
    g_t = host(sys_.graph.t[:nk])
    kf_frames = [int(round(s / PERIOD)) for s in sys_.kf_stamps]
    kf_err = np.linalg.norm(g_t - np.stack([gts[f] for f in kf_frames]), axis=1)
    out = {"system": sys_, "gt": np.stack(gts), "loops": loops, "wall": wall,
           "frontend_ate": float(np.sqrt((err ** 2).mean())), "frontend_max": float(err.max()),
           "kf_ate": float(np.sqrt((kf_err ** 2).mean())), "kf_max": float(kf_err.max())}
    if export_dir:
        from ..utils.viz import export_run

        out["paths"] = export_run(export_dir, sys_, est_t=np.stack([host(t) for t in
                                                                     sys_.trajectory]),
                                  gt_t=out["gt"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    ap.add_argument("--frames", type=int, default=220)
    ap.add_argument("--export-dir", default=None,
                    help="write TUM trajectory + PCD/PLY map + overview PNG")
    args = ap.parse_args(argv)
    r = run(args.frames, device="cpu" if args.cpu else None, export_dir=args.export_dir)
    sys_ = r["system"]
    print(f"\nframes: {args.frames}, keyframes: {len(sys_.kf_stamps)}, "
          f"loop closures: {r['loops']}")
    print(f"frontend ATE RMSE: {r['frontend_ate']:.3f} m (max {r['frontend_max']:.3f})")
    print(f"graph keyframe ATE RMSE: {r['kf_ate']:.3f} m (max {r['kf_max']:.3f})")
    print(f"throughput: {args.frames / r['wall']:.1f} scans/s wall ({r['wall']:.1f}s total "
          f"incl. sim)")
    print("\nstage timing:\n" + sys_.metrics.pretty())
    for k, v in r.get("paths", {}).items():
        print(f"exported {k}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
