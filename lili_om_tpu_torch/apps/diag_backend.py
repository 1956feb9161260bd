"""Diagnostic: the backend's (fusion's) drift against the frontend's
(odometry's) over a medium synthetic run, with the velocity, bias and
correspondence counts every 50 frames. The port's counterpart of
``examples/diag_backend.py``.

    python -m lili_om_tpu_torch.apps.diag_backend [--cpu] [--frames N]

The system is the JAX example's (16×720 sweeps, loop closure off, float32,
the constant-velocity translation deskew on). The circle's lap is
``(N − 30)·0.1 s`` capped at 75 s, as there, and floored at 10 s as
``apps/run_loop_closure.py`` floors it (the JAX formula has no lap below 31
frames).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

R, C, PERIOD = 16, 720, 0.1


def make_system(n: int, device=None, dtype=torch.float32):
    """The JAX example's system."""
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
                                use_reflectivity=False, weight_gate=0.3, lidar_const=7.5,
                                max_num_iter=6, imu_cap=64),
        feat_cfg=SpinFeatureConfig(surf_cap=4096), lc_cfg=LoopClosureConfig(enabled=False),
        graph_capacity=max(256, n), dtype=dtype, device=device)


def run(n: int, device=None, log=print) -> dict:
    """``n`` frames of the circle through :func:`make_system`'s system.
    Returns the system, the per-frame truth, each frame's frontend error
    and each keyframe's backend (graph) error, both ATE RMSEs, and the
    traces printed every 50 frames."""
    from ..device import resolve_device
    from ..sim.lidar import simulate_scan, spinning_pattern
    from ..sim.trajectory import circle_trajectory, pose_at, simulate_imu
    from ..sim.world import make_room_world
    from ..utils.evaluation import host
    from ..utils.math import pose_relative

    dev = resolve_device(device)
    period_s = min(max((n - 30) * PERIOD, 10.0), 75.0)
    radius = min(6.0, 1.3 * period_s / (2 * 3.14159))
    traj = circle_trajectory(radius=radius, period=period_s, speed_up=3.0)
    world = make_room_world(device=dev)
    pattern = spinning_pattern(n_rings=R, n_cols=C, device=dev)
    sys_ = make_system(n, device=dev)
    sys_.deskew_translation = True

    imu = simulate_imu(traj, 0.0, n * PERIOD + PERIOD, rate=200.0, device=dev)
    sys_.push_imu(*(host(x) for x in imu))
    t0w, q0w = pose_at(traj, 0.0, device=dev)
    fe_err, gts, traces = [], [], []
    for k in range(n):
        ts = k * PERIOD
        scan = simulate_scan(world, traj, ts, pattern, period=PERIOD)
        sys_.process_scan(scan.pts.reshape(R, C, 3), scan.valid.reshape(R, C),
                          scan.rel_time.reshape(R, C), ts)
        gts.append(host(pose_relative(t0w, q0w, *pose_at(traj, ts, device=dev))[0]))
        fe_err.append(float(np.linalg.norm(host(sys_.trajectory[-1]) - gts[-1])))
        if k % 50 == 0 and k > 0:
            fs = sys_.fusion_state
            vals = host(torch.cat([fs.t[-1], fs.v[-1], fs.ba[-1], fs.bg[-1]]))
            fo = getattr(sys_, "last_fusion_out", None)
            corr = ((int(fo.n_surf_corr), int(fo.n_edge_corr)) if fo is not None
                    else (-1, -1))
            traces.append({"frame": k, "fe_err": fe_err[-1], "be_t": vals[0:3],
                           "gt": gts[-1], "speed": float(np.linalg.norm(vals[3:6])),
                           "ba": vals[6:9], "bg": vals[9:12], "corr": corr})
            log(f"frame {k:4d}: fe_err={fe_err[-1]:.2f}  be_t={vals[0:3].round(2)}  "
                f"gt={gts[-1].round(2)}  |v|={traces[-1]['speed']:.2f}  "
                f"ba={vals[6:9].round(4)}  bg={vals[9:12].round(5)}  "
                f"corr={corr[0]}/{corr[1]}")

    nk = len(sys_.kf_stamps)
    g_t = host(sys_.graph.t[:nk])
    kf_frames = [int(round(s / PERIOD)) for s in sys_.kf_stamps]
    be = np.array([np.linalg.norm(g_t[i] - gts[f]) for i, f in enumerate(kf_frames)])
    fe = np.array(fe_err)
    return {"system": sys_, "gt": np.stack(gts), "fe_err": fe, "be_err": be,
            "kf_frames": kf_frames, "traces": traces,
            "frontend_ate": float(np.sqrt((fe ** 2).mean())),
            "backend_ate": float(np.sqrt((be ** 2).mean()))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    ap.add_argument("--frames", type=int, default=600)
    args = ap.parse_args(argv)
    r = run(args.frames, device="cpu" if args.cpu else None)
    fe, be, nk = r["fe_err"], r["be_err"], len(r["be_err"])
    print(f"\nfrontend ATE RMSE {r['frontend_ate']:.3f} m (max {fe.max():.3f})")
    print(f"backend  ATE RMSE {r['backend_ate']:.3f} m (max {be.max():.3f})")
    # the error at the quartiles, to see how it grows
    for q in (0.25, 0.5, 0.75, 1.0):
        i = min(int(q * nk) - 1, nk - 1)
        print(f"  backend err at kf {i}/{nk}: {be[i]:.2f} m  "
              f"(frontend at same frame: {fe[r['kf_frames'][i]]:.2f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
