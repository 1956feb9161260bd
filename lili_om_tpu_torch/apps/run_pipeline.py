"""Pipelined-runtime demo: the same scan stream through the
``PipelineRunner`` serially (frontend and backend on one worker) and
overlapped (frontend ∥ backend), with the scan rate and the per-stage
p50/p95 of each. The port's counterpart of ``examples/run_pipeline.py``.

    python -m lili_om_tpu_torch.apps.run_pipeline [--cpu] [--frames N] [--rings R] [--cols C]

The reference overlaps its stages across four OS processes (SURVEY.md §1):
with sparse keyframes the overlapped rate approaches the frontend's alone,
as the backend's keyframe cost hides behind the next scans. On the card the
port's overlapped runner has measured slower than the serial one (every
launch costs more host time when two threads submit; PERF.md §6).
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

PERIOD = 0.1
WARM_SCANS = 2


def make_system(n: int, device=None, dtype=torch.float32):
    """The JAX example's system (loop closure off)."""
    from ..models.fusion import FusionConfig
    from ..models.odometry import OdometryConfig
    from ..models.system import LiliOmSystem
    from ..ops.features_spin import SpinFeatureConfig
    from ..utils.config import LoopClosureConfig

    return LiliOmSystem(
        odo_cfg=OdometryConfig(n_recent_frames=10, scan_cap=4096, query_cap=1024,
                               map_cap=16384),
        fusion_cfg=FusionConfig(window=3, local_map_width=20, kf_surf_cap=2048,
                                kf_edge_cap=1024, map_surf_cap=16384, map_edge_cap=4096,
                                use_reflectivity=False, weight_gate=0.3, lidar_const=7.5,
                                max_num_iter=6, imu_cap=64),
        feat_cfg=SpinFeatureConfig(surf_cap=4096), lc_cfg=LoopClosureConfig(enabled=False),
        graph_capacity=max(64, n), dtype=dtype, device=device)


def simulate(n: int, rings: int, cols: int, device=None):
    """``n`` sweeps of an R×C spinning sensor along a circle in the room
    world, on ``device``, and the IMU stream (host arrays)."""
    from ..device import resolve_device
    from ..sim.lidar import simulate_scan, spinning_pattern
    from ..sim.trajectory import circle_trajectory, simulate_imu
    from ..sim.world import make_room_world
    from ..utils.evaluation import host

    dev = resolve_device(device)
    world = make_room_world(device=dev)
    traj = circle_trajectory(radius=6.0, period=max(40.0, n * PERIOD * 1.2))
    pattern = spinning_pattern(n_rings=rings, n_cols=cols, device=dev)
    imu = tuple(host(x) for x in simulate_imu(traj, 0.0, n * PERIOD + PERIOD, rate=200.0,
                                              device=dev))
    scans = []
    for k in range(n):
        s = simulate_scan(world, traj, k * PERIOD, pattern, period=PERIOD)
        scans.append((s.pts.reshape(rings, cols, 3), s.valid.reshape(rings, cols),
                      s.rel_time.reshape(rings, cols)))
    return scans, imu


def run_mode(scans, imu, overlap: bool, device=None, system=None, timeout: float = 600.0):
    """One pass of the stream through a runner: the first scans warm up
    outside the timed window. Returns (system, runner, timed scans/s)."""
    from ..runtime.pipeline import PipelineRunner

    n = len(scans)
    sys_ = make_system(n, device=device) if system is None else system
    runner = PipelineRunner(sys_, queue_size=max(16, n), overlap=overlap, loop_period_s=1e9)
    runner.feed_imu(*imu)
    runner.start()
    try:
        for k in range(WARM_SCANS):
            runner.feed_scan(*scans[k], k * PERIOD)
        deadline = time.monotonic() + timeout
        while runner.n_processed < WARM_SCANS:
            if runner.error is not None or time.monotonic() > deadline:
                break  # stop() below re-raises the worker's exception
            time.sleep(0.01)
        t0 = time.perf_counter()
        for k in range(WARM_SCANS, n):
            runner.feed_scan(*scans[k], k * PERIOD)
    finally:
        runner.stop(drain=True, timeout=timeout)
    if runner.n_processed < WARM_SCANS:
        raise TimeoutError(f"the warm-up scans took more than {timeout} s")
    dt = time.perf_counter() - t0
    return sys_, runner, (n - WARM_SCANS) / dt


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--rings", type=int, default=16)
    ap.add_argument("--cols", type=int, default=900)
    args = ap.parse_args(argv)
    if args.frames <= WARM_SCANS:
        ap.error(f"--frames must exceed the {WARM_SCANS} warm-up scans")
    device = "cpu" if args.cpu else None
    print("simulating scans...", flush=True)
    scans, imu = simulate(args.frames, args.rings, args.cols, device=device)
    rates = {}
    for overlap in (False, True):
        sys_, runner, rate = run_mode(scans, imu, overlap, device=device)
        rates[overlap] = rate
        print(f"\n[{'overlap' if overlap else 'serial '}] {args.frames - WARM_SCANS} scans = "
              f"{rate:.1f} scans/s  (kf={len(sys_.kf_stamps)}, dropped={runner.n_dropped})")
        print(sys_.metrics.pretty())
    print(f"\noverlap speedup: {rates[True] / rates[False]:.2f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())
