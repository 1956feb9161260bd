"""ATE/RPE table across presets on the golden synthetic loop: the port's
counterpart of ``examples/evaluate_presets.py`` (the stand-in for the
reference's rosbag validation).

    python -m lili_om_tpu_torch.apps.evaluate_presets                  # default presets, card
    python -m lili_om_tpu_torch.apps.evaluate_presets --cpu --frames 120 --presets synthetic
    python -m lili_om_tpu_torch.apps.evaluate_presets --presets all --tum-dir /tmp/tum

The golden loop is a deterministic closed circle at walking speed in the
room world, scans cast from the sensor pose of each preset's extrinsic
(spinning presets at their ring count × 900 columns, Livox presets in
Horizon sweeps of 6 × 4000 points), IMU at 200 Hz, and a revisit that fires
loop closure. Each preset's keyframe ATE is held to its bound (``BOUNDS``);
the exit code is 1 if any preset misses it. Trajectories export in TUM
format (``utils/evaluation.py``).
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

DEFAULT_PRESETS = ["synthetic", "fr_iosb_rot", "fr_iosb"]
# keyframe ATE bound (m) on the golden loop per preset family: loose enough
# for float32 and small capacities, tight enough to catch mis-wiring
BOUNDS = {"default": 1.0}
# rings of the spinning presets' sensors; the rest simulate 16
RINGS = {"fr_iosb_rot": 64, "urban_hk_rot": 32, "utbm_rot": 32}
COLS = 900


def run_preset(name: str, frames: int, dtype=torch.float32, tum_dir=None, device=None) -> dict:
    """Run the golden loop through ``LiliOmSystem`` at preset ``name``;
    returns the table row (keyframe and frame ATE, keyframe RPE over 5
    keyframes, keyframes, loops, scans/s) and, under ``"system"``, the
    system after the run."""
    from ..device import resolve_device
    from ..io.livox import convert_internal_imu
    from ..models.system import LiliOmSystem
    from ..sim.lidar import livox_pattern, simulate_scan, spinning_pattern
    from ..sim.trajectory import circle_trajectory, pose_at, simulate_imu
    from ..sim.world import make_room_world
    from ..utils.config import load_config
    from ..utils.evaluation import ate_rmse, export_system_tum, export_tum, host, rpe
    from ..utils.math import pose_relative, quat_conj_np, quat_rotate_np

    dev = resolve_device(device)
    cfg = load_config(name)
    period = cfg.scan_period
    rings = RINGS.get(name, 16)
    # the Livox internal-IMU mode: the IMU stream as the sensor reports it
    # (accel in g), converted back through io/livox.py:convert_internal_imu
    # with the gravity-aligned initial orientation, so the degraded mode is
    # measured end to end
    internal_imu = name == "fr_iosb_internal_imu"

    sys_ = LiliOmSystem(cfg.odometry, cfg.fusion, cfg.spin_features, cfg.livox_features,
                        cfg.loop_closure, cfg.imu_noise, dtype=dtype, device=dev)
    sys_.deskew_translation = True
    sys_.mapping_interval = cfg.mapping_interval
    # the golden loop: a walking-speed circle closing inside the run
    world = make_room_world(device=dev)
    period_s = max((frames - 30) * period, 10.0)
    radius = min(6.0, 1.3 * period_s / (2 * 3.14159))
    traj = circle_trajectory(radius=radius, period=period_s, speed_up=3.0)
    sys_.lc_cfg.time_thres = min(sys_.lc_cfg.time_thres, period_s / 3)
    sys_.lc_cfg.search_radius = max(sys_.lc_cfg.search_radius, 5.0)

    imu = simulate_imu(traj, 0.0, frames * period + period, rate=200.0, device=dev)
    stamps, accs, gyrs = (host(x) for x in imu)
    if internal_imu:
        accs, gyrs, q0 = convert_internal_imu(accs / 9.8, gyrs)
        sys_.push_imu(stamps, accs, gyrs)
        sys_.set_initial_orientation(q0)
    else:
        sys_.push_imu(stamps, accs, gyrs)
    t0w, q0w = pose_at(traj, 0.0, device=dev)

    livox = cfg.variant == "livox"
    pattern = (livox_pattern(device=dev) if livox
               else spinning_pattern(n_rings=rings, n_cols=COLS, device=dev))
    # rays from the SENSOR pose the preset's lidar→body extrinsic implies
    # (p_body = q_lb⁻¹ (p_sensor − t_lb))
    q_lb = np.asarray(cfg.fusion.q_lb, float)
    t_lb = np.asarray(cfg.fusion.t_lb, float)
    q_sl = quat_conj_np(q_lb[None])[0]
    t_sl = -quat_rotate_np(q_sl[None], t_lb[None])[0]
    gt_t, gt_q, loops = [], [], 0
    t_start = time.time()
    for k in range(frames):
        ts = k * period
        scan = simulate_scan(world, traj, ts, pattern, period=period, t_sl=t_sl, q_sl=q_sl)
        if livox:
            sys_.process_scan_livox(scan.pts, scan.line, scan.rel_time, scan.reflectivity,
                                    scan.valid, ts)
        else:
            C = scan.pts.shape[0] // rings
            sys_.process_scan(scan.pts.reshape(rings, C, 3), scan.valid.reshape(rings, C),
                              scan.rel_time.reshape(rings, C), ts)
        rt, rq = pose_relative(t0w, q0w, *pose_at(traj, ts, device=dev))
        gt_t.append(host(rt))
        gt_q.append(host(rq))
        if k % 10 == 0 and k > 0 and sys_.try_loop_closure():
            loops += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.time() - t_start

    gt_stamps = np.arange(frames) * period
    gt_t = np.stack(gt_t)
    gt_q = np.stack(gt_q)
    est_t = np.stack([host(t) for t in sys_.trajectory])
    frame_ate = ate_rmse(gt_stamps, est_t, gt_stamps, gt_t, align=False)
    nk = len(sys_.kf_stamps)
    kf_t, kf_q = host(sys_.graph.t[:nk]), host(sys_.graph.q[:nk])
    kf_ate = ate_rmse(np.asarray(sys_.kf_stamps), kf_t, gt_stamps, gt_t, align=False)
    kf_rpe = rpe(np.asarray(sys_.kf_stamps), kf_t, kf_q, gt_stamps, gt_t, gt_q, delta=5)
    if tum_dir:
        os.makedirs(tum_dir, exist_ok=True)
        export_system_tum(sys_, os.path.join(tum_dir, f"{name}_frames.tum"),
                          os.path.join(tum_dir, f"{name}_keyframes.tum"))
        export_tum(os.path.join(tum_dir, f"{name}_gt.tum"), gt_stamps, gt_t, gt_q)
    return {"preset": name, "frames": frames, "keyframes": nk, "loops": loops,
            "frame_ate": frame_ate["rmse"], "kf_ate": kf_ate["rmse"],
            "kf_rpe5": kf_rpe["rmse"], "scans_per_s": frames / wall, "system": sys_}


def bound(name: str) -> float:
    return BOUNDS.get(name, BOUNDS["default"])


def format_table(rows) -> str:
    """The summary table, as the JAX harness prints it."""
    out = [f"{'preset':24s} {'kf_ATE':>8s} {'fr_ATE':>8s} {'RPE@5':>8s} "
           f"{'kf':>4s} {'loops':>5s}  ok"]
    for r in rows:
        out.append(f"{r['preset']:24s} {r['kf_ate']:8.3f} {r['frame_ate']:8.3f} "
                   f"{r['kf_rpe5']:8.3f} {r['keyframes']:4d} {r['loops']:5d}  "
                   f"{'✓' if r['ok'] else '✗'}")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--presets", default=",".join(DEFAULT_PRESETS),
                    help="comma list or 'all'")
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    ap.add_argument("--tum-dir", default=None)
    args = ap.parse_args(argv)

    from ..utils.config import PRESETS

    names = (list(PRESETS) if args.presets == "all"
             else [p.strip() for p in args.presets.split(",")])
    device = "cpu" if args.cpu else None
    rows = []
    for name in names:
        print(f"== {name} ==", flush=True)
        r = run_preset(name, args.frames, torch.float32, args.tum_dir, device=device)
        del r["system"]  # keep the row only: each system holds its map on the card
        r["ok"] = bool(r["kf_ate"] < bound(name))  # NaN (no keyframe pairs) fails
        rows.append(r)
        print(f"   frame ATE {r['frame_ate']:.3f} m | kf ATE {r['kf_ate']:.3f} m "
              f"(bound {bound(name)}) | RPE@5kf {r['kf_rpe5']:.3f} m | "
              f"loops {r['loops']} | {r['scans_per_s']:.1f} scans/s", flush=True)
    print("\n" + format_table(rows))
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
