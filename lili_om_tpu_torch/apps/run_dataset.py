"""Record or play a ``.lom`` dataset log through the port: the counterpart
of ``examples/run_dataset.py`` (the ``roslaunch … + rosbag play``
equivalent).

    python -m lili_om_tpu_torch.apps.run_dataset record out.lom [n_frames] [--variant livox] \\
        [--cpu]
    python -m lili_om_tpu_torch.apps.run_dataset play out.lom [--preset synthetic] \\
        [--map out.pcd] [--cpu]

``record`` simulates a 16×720 spinning sweep (or a 6 × 2000-point Horizon
pattern) along a circle in the room world. ``play`` streams the log
through ``LiliOmSystem`` scan by scan, with a loop-closure attempt every
10 scans, and prints the trajectory and the stage times. Both run on the
card unless ``--cpu``.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

# the organized image that record_synthetic's spinning sweep fills
RINGS, COLS = 16, 720
# record_synthetic's Horizon pattern has 2000 points per line per sweep; the
# Livox image is binned at that density (LivoxFeatureConfig.n_cols)
LIVOX_COLS = 2000


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("cmd", choices=["record", "play"])
    ap.add_argument("path")
    ap.add_argument("n_frames", nargs="?", type=int, default=50)
    ap.add_argument("--preset", default="synthetic")
    ap.add_argument("--variant", default="rot", choices=["rot", "livox"],
                    help="sensor variant of the log (record and play)")
    ap.add_argument("--map", default=None, help="write the global map as a PCD here")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    args = ap.parse_args(argv)

    from ..io.dataset import (ImuRecord, ScanRecord, decode_livox, organize_scan,
                              read_dataset, record_synthetic)

    if args.cmd == "record":
        t0 = time.time()
        record_synthetic(args.path, n_frames=args.n_frames, variant=args.variant,
                         device="cpu" if args.cpu else None)
        print(f"recorded {args.n_frames} frames to {args.path} in {time.time() - t0:.1f}s")
        return 0

    from ..models.system import LiliOmSystem
    from ..utils.config import load_config

    cfg = load_config(args.preset)
    livox_cfg = (cfg.livox_features._replace(n_cols=LIVOX_COLS) if args.variant == "livox"
                 else cfg.livox_features)
    sys_ = LiliOmSystem(cfg.odometry, cfg.fusion, cfg.spin_features, livox_cfg,
                        cfg.loop_closure, cfg.imu_noise, dtype=torch.float32,
                        device="cpu" if args.cpu else None)
    t0 = time.time()
    n_scans = 0
    for rec in read_dataset(args.path):
        if isinstance(rec, ImuRecord):
            sys_.push_imu(np.array([rec.stamp]), rec.acc[None], rec.gyr[None])
        elif isinstance(rec, ScanRecord):
            if args.variant == "livox":
                out = sys_.process_scan_livox(*decode_livox(rec)[1], rec.stamp)
            else:
                out = sys_.process_scan(*organize_scan(rec, RINGS, COLS), rec.stamp)
            n_scans += 1
            if n_scans % 10 == 0:
                sys_.try_loop_closure()
                print(f"scan {n_scans:4d}  t={out.t.cpu().numpy().round(2)}  "
                      f"kf={len(sys_.kf_stamps)}")
    wall = time.time() - t0
    print(f"\nprocessed {n_scans} scans in {wall:.1f}s ({n_scans / max(wall, 1e-9):.1f} scans/s)")
    print(sys_.metrics.pretty())
    if args.map:
        n = sys_.export_map(args.map)
        print(f"exported global map: {n} points -> {args.map}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
