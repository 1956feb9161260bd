"""Run the port on a ROS1 bag: the counterpart of ``examples/run_bag.py``
(the reference's ``roslaunch lili_om run_*.launch`` + ``rosbag play
seq.bag``, README.md:57-76).

    python -m lili_om_tpu_torch.apps.run_bag seq.bag --preset fr_iosb_rot \\
        --lidar /velodyne_points --imu /imu/data --map out.pcd [--cpu] [--serial] \\
        [--live-viz DIR [--live-port N]] [--export-dir DIR]

Livox bags (``livox_ros_driver/CustomMsg``) take the Livox extractor;
PointCloud2 bags the spinning extractor with the ring field (or the
per-sensor vertical-angle formulas when it is absent); raw Velodyne packet
bags (``velodyne_msgs/VelodyneScan``) are decoded first. Scans go through
:class:`..runtime.ingest.ShardedIngest` into a
:class:`..runtime.pipeline.PipelineRunner` (lossless replay, loop closure
on its own thread). On the card the runner is serial (frontend and
backend on one worker): with the two on their own threads every kernel
launch costs more host time, and the overlapped replay ran at 0.56–0.68×
the serial scan rate on an H100 80GB HBM3 at 700 W (PERF.md §6;
``PipelineRunner(overlap=True)`` still runs it). On the CPU frontend and
backend overlap, as in the JAX runner, unless ``--serial``.

``--live-viz DIR`` refreshes a live viewer directory at the map-publish
cadence (``utils/live_viz.py``, the rviz-session analog), served over HTTP
with ``--live-port``; ``--export-dir`` writes the TUM trajectory, the PCD
and PLY map and the overview PNG after the run (``utils/viz.py``). The
figures need matplotlib.
"""
from __future__ import annotations

import argparse
import functools
import sys
import time

import numpy as np
import torch

from ..io.rosbag import ImuMsg, LivoxCustomMsg, PointCloud2Msg, read_bag
from ..io.velodyne import VelodyneScanMsg, decode_packets
from ..ops.features_spin import ring_from_angle


def decode_scan(msg, rings: int, cols: int):
    """One scan message → ``("spin", (img, valid, rel_time))`` or
    ``("livox", (pts, line, ratio, refl, valid))``: packet parse and
    ring/azimuth binning into the organized image, numpy and CPU tensors on
    the host (the ingest workers' work; a module-level function, so a
    spawned worker can run it)."""
    if isinstance(msg, LivoxCustomMsg):
        period = 0.1
        ratio = np.clip(msg.offset_time.astype(np.float32) * 1e-9 / period, 0, 0.999)
        return "livox", (msg.pts, msg.line.astype(np.int32), ratio,
                         msg.reflectivity.astype(np.float32), np.isfinite(msg.pts).all(axis=1))
    if isinstance(msg, VelodyneScanMsg):
        # UTBM raw packets: the reference decodes with a velodyne_pointcloud
        # cloud_node (run_utbm.launch:6-14)
        dec = decode_packets(msg.packets, "HDL32E" if rings == 32 else "VLP16")
        pts, ring = dec.pts[dec.valid], dec.ring[dec.valid]
        finite = np.isfinite(pts).all(axis=1)
    else:
        pts = msg.xyz()
        finite = np.isfinite(pts).all(axis=1)
        if "ring" in msg.fields:
            ring = msg.field("ring").astype(np.int32)
        else:
            r, ok = ring_from_angle(torch.as_tensor(pts, dtype=torch.float32), rings)
            ring = r.numpy()
            finite &= ok.numpy()
    az = np.arctan2(pts[:, 1], pts[:, 0])
    rel = ((az + np.pi) / (2 * np.pi)).astype(np.float32)
    col = np.clip((rel * cols).astype(np.int64), 0, cols - 1)
    ring = np.clip(ring, 0, rings - 1)
    img = np.zeros((rings, cols, 3), np.float32)
    valid = np.zeros((rings, cols), bool)
    relimg = np.zeros((rings, cols), np.float32)
    img[ring[finite], col[finite]] = pts[finite]
    valid[ring[finite], col[finite]] = True
    relimg[ring[finite], col[finite]] = rel[finite]
    return "spin", (img, valid, relimg)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("bag")
    ap.add_argument("--preset", default="fr_iosb_rot")
    ap.add_argument("--lidar", default=None, help="lidar topic (default: auto)")
    ap.add_argument("--imu", default=None, help="imu topic (default: auto)")
    ap.add_argument("--map", default=None, help="write the global map as a PCD here")
    ap.add_argument("--rings", type=int, default=None)
    ap.add_argument("--cols", type=int, default=1800)
    ap.add_argument("--max-scans", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    ap.add_argument("--internal-imu", action="store_true",
                    help="Livox internal IMU: g→m/s² + gravity-align init")
    ap.add_argument("--serial", action="store_true",
                    help="frontend and backend on one worker (always so on the card)")
    ap.add_argument("--ingest-hosts", type=int, default=1,
                    help="decode the raw scan stream on N parallel ingest workers")
    ap.add_argument("--live-viz", default=None, metavar="DIR",
                    help="live viewer directory (refreshes at the map-publish cadence)")
    ap.add_argument("--live-port", type=int, default=0,
                    help="with --live-viz: serve DIR over HTTP on this port (0: a free one)")
    ap.add_argument("--export-dir", default=None,
                    help="write TUM trajectory + PCD/PLY map + overview PNG")
    args = ap.parse_args(argv)

    from ..io.livox import convert_internal_imu
    from ..models.system import LiliOmSystem
    from ..runtime.ingest import ShardedIngest
    from ..runtime.pipeline import PipelineRunner
    from ..utils.config import load_config

    cfg = load_config(args.preset)
    rings = args.rings or (64 if "fr_iosb_rot" in args.preset else
                           32 if ("utbm" in args.preset or "hk" in args.preset) else 16)
    sys_ = LiliOmSystem(cfg.odometry, cfg.fusion, cfg.spin_features, cfg.livox_features,
                        cfg.loop_closure, cfg.imu_noise, dtype=torch.float32,
                        device="cpu" if args.cpu else None)
    sys_.if_to_deskew = cfg.if_to_deskew  # yaml lidar_odometry/if_to_deskew
    sys_.mapping_interval = cfg.mapping_interval  # yaml backend_fusion/mapping_interval
    viewer = None
    if args.live_viz:
        from ..utils.live_viz import LiveViewer

        viewer = LiveViewer(args.live_viz, sys_)
        port = viewer.serve(args.live_port)
        print(f"live viewer: http://localhost:{port}/ -> {args.live_viz}")
    overlap = not args.serial and sys_.device.type == "cpu"
    # lossless offline replay: drop_when_full=False
    runner = PipelineRunner(sys_, overlap=overlap, drop_when_full=False,
                            loop_period_s=1.0, scan_period=cfg.scan_period)
    runner.start()
    ingest = ShardedIngest(runner, functools.partial(decode_scan, rings=rings, cols=args.cols),
                           n_hosts=args.ingest_hosts)

    n_scans = 0
    t0 = time.time()
    imu_init = []
    q0_seeded = False
    try:
        for topic, msg in read_bag(args.bag):
            if isinstance(msg, ImuMsg) and (args.imu is None or topic == args.imu):
                acc, gyr = msg.acc, msg.gyr
                if args.internal_imu:
                    imu_init.append(msg.acc)
                    acc, gyr, _ = convert_internal_imu(msg.acc[None], msg.gyr[None])
                    acc, gyr = acc[0], gyr[0]
                    # gravity-aligned init, averaged over the first 3 samples
                    # (InternalImuUnitConverter.py:34-58)
                    if not q0_seeded and len(imu_init) == 3:
                        _, _, q_grav = convert_internal_imu(np.stack(imu_init), np.zeros((3, 3)))
                        q0_seeded = sys_.set_initial_orientation(q_grav)
                elif not q0_seeded:
                    # the first IMU message's orientation seeds R₀ (imuHandler,
                    # BackendFusion.cpp:624-665)
                    q0_seeded = sys_.set_initial_orientation(msg.orientation)
                runner.feed_imu(np.array([msg.stamp]), acc[None], gyr[None])
            elif isinstance(msg, (LivoxCustomMsg, PointCloud2Msg, VelodyneScanMsg)) \
                    and (args.lidar is None or topic == args.lidar):
                ingest.feed_raw(msg, msg.stamp)
                n_scans += 1
            if n_scans and n_scans % 50 == 0 and sys_.trajectory:
                print(f"fed {n_scans} (done {runner.n_processed})  kf={len(sys_.kf_stamps)}  "
                      f"loops={runner.loop_closures}  t={np.asarray(sys_.trajectory[-1]).round(2)}")
            if args.max_scans and n_scans >= args.max_scans:
                break
        ingest.close()
    finally:
        try:
            runner.stop(drain=True)
        finally:
            if viewer is not None:
                viewer.close()
    wall = time.time() - t0
    print(f"\n{runner.n_processed} scans, {len(sys_.kf_stamps)} keyframes, "
          f"{int(sys_.graph.n_loops)} loop factors "
          f"({runner.loop_closures} closures, {runner.n_recoveries} recoveries), "
          f"{wall:.1f}s ({runner.n_processed / max(wall, 1e-9):.1f} scans/s)")
    print(sys_.metrics.pretty())
    if args.map:
        n = sys_.export_map(args.map)
        print(f"map: {n} points -> {args.map}")
    if args.export_dir:
        from ..utils.viz import export_run

        est = np.stack(sys_.trajectory) if sys_.trajectory else None
        for k, v in export_run(args.export_dir, sys_, est_t=est).items():
            print(f"exported {k}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
