"""Long-run soak: laps of a small world replayed until a keyframe count is
reached, checking the three long-run invariants. The port's counterpart of
``examples/soak_long_run.py``.

    python -m lili_om_tpu_torch.apps.soak_long_run [n_keyframes] [--spill] [--loop-every N] [--cpu]

* per-keyframe latency stays flat: the last quartile's p50 over the first
  quartile's below 1.5 (the incremental map tables and ring buffers make a
  keyframe's cost independent of the trajectory's length). Each keyframe is
  timed to a device synchronize at its end, so on the card the time is the
  work's, not its enqueue;
* the graph solve stays bounded: the last quartile of the closures' solve
  times has a p50 under 1 s (a closure to a first-lap node makes the
  affected suffix the whole graph, so a converged solve costs O(N) an
  iteration; ``models/pose_graph.py:solve_graph_incremental``);
* with ``--spill``, the resident keyframe archives stay bounded by
  ``archive_keep_recent`` (``LiliOmSystem.spill_archives``; the spill
  directory is a temporary one, removed at the end).

It prints ``SOAK PASS`` or ``SOAK FAIL`` and returns 0 or 1. One lap is
simulated once (``FRAMES_PER_LAP`` scans) and replayed with shifted stamps.
The configuration is the JAX example's (16×360 sweeps, an odometry map of
4096 points, a 2048-node graph, a closure attempt every 10 scans, float32,
``circle_trajectory``'s 8 s speed-up ramp).

``--speed-up S`` sets the ramp's time constant, a departure from the
example. Under the example's ramp a 20 s lap covers 63 % of the circle, so
every replay jumps back to the start: no closure fires in the first two
laps, and later laps close loops only now and then. With ``--speed-up
0.001`` the lap starts at full speed and closes, and closures fire from the
second lap on (a short run that must see closures uses it).
"""
from __future__ import annotations

import argparse
import resource
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

R, C, PERIOD = 16, 360, 0.1
FRAMES_PER_LAP = 200  # a 20 s lap: 2.5 m/s on the 8 m circle
LAP_T = FRAMES_PER_LAP * PERIOD
SPEED_UP = 8.0  # circle_trajectory's speed-up time constant (s), the example's
KEEP_RECENT = 128  # archive_keep_recent under --spill


def rss_mb() -> float:
    """The current resident set (``ru_maxrss`` is the peak)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * resource.getpagesize() / 2 ** 20


def make_system(device=None, dtype=torch.float32):
    """The JAX example's system: small capacities, loop closure with a
    5 m search radius, candidates older than 0.6 of a lap."""
    from ..models.fusion import FusionConfig
    from ..models.odometry import OdometryConfig
    from ..models.system import LiliOmSystem
    from ..ops.features_spin import SpinFeatureConfig
    from ..utils.config import LoopClosureConfig

    return LiliOmSystem(
        odo_cfg=OdometryConfig(n_recent_frames=4, scan_cap=1024, query_cap=256, map_cap=4096),
        fusion_cfg=FusionConfig(window=3, local_map_width=6, kf_surf_cap=512, kf_edge_cap=128,
                                map_surf_cap=4096, map_edge_cap=512, use_reflectivity=False,
                                weight_gate=0.3, lidar_const=7.5, max_num_iter=4, imu_cap=32),
        feat_cfg=SpinFeatureConfig(surf_cap=1024),
        lc_cfg=LoopClosureConfig(enabled=True, time_thres=LAP_T * 0.6, search_radius=5.0,
                                 map_width=3, latest_width=1, icp_iters=10, submap_cap=4096,
                                 merge_width=10),
        graph_capacity=2048, dtype=dtype, device=device)


def p50(x) -> float:
    return float(np.percentile(x, 50)) if len(x) else float("nan")


def run(n_keyframes: int, spill: bool = False, loop_every: int = 10, device=None,
        log=print, speed_up: float = SPEED_UP) -> dict:
    """Replay laps until ``n_keyframes`` keyframes exist (checked after each
    lap). Returns the system, the per-keyframe latencies and the closures'
    solve times (seconds), the laps, the resident set before and after (MB)
    and the resident surf archives."""
    from ..device import resolve_device
    from ..sim.lidar import simulate_scan, spinning_pattern
    from ..sim.trajectory import circle_trajectory, simulate_imu
    from ..sim.world import make_room_world
    from ..utils.evaluation import host

    dev = resolve_device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    world = make_room_world(device=dev)
    traj = circle_trajectory(radius=8.0, period=LAP_T, speed_up=speed_up)
    pattern = spinning_pattern(n_rings=R, n_cols=C, device=dev)
    sys_ = make_system(dev)
    if spill:
        sys_.archive_spill_dir = tempfile.mkdtemp(prefix="lili_spill_")
        sys_.archive_keep_recent = KEEP_RECENT
    sys_.densify_frames = False  # the soak targets the keyframe and graph path

    # one lap simulated once, replayed with shifted stamps
    lap_scans = []
    for k in range(FRAMES_PER_LAP):
        s = simulate_scan(world, traj, k * PERIOD, pattern, period=PERIOD)
        lap_scans.append((s.pts.reshape(R, C, 3), s.valid.reshape(R, C),
                          s.rel_time.reshape(R, C)))
    imu_s, imu_a, imu_g = (host(x) for x in simulate_imu(traj, 0.0, LAP_T, rate=200.0,
                                                         device=dev))

    kf_lat, solve_t, lap = [], [], 0
    n_kf_logged = n_solve_logged = 0
    rss0 = rss_mb()
    t_start = time.time()
    while len(sys_.kf_stamps) < n_keyframes:
        base = lap * LAP_T
        keep = imu_s > 1e-9 if lap else np.ones_like(imu_s, bool)
        sys_.push_imu(imu_s[keep] + base, imu_a[keep], imu_g[keep])
        for k, (img, valid, rel) in enumerate(lap_scans):
            nk0 = len(sys_.kf_stamps)
            t0 = time.perf_counter()
            sys_.process_scan(img, valid, rel, base + k * PERIOD)
            sync()
            dt = time.perf_counter() - t0
            if len(sys_.kf_stamps) > nk0:
                kf_lat.append(dt)
            if (lap * FRAMES_PER_LAP + k) % loop_every == 0:
                n_solved0 = len(sys_.metrics.samples.get("graph_solve", []))
                sys_.try_loop_closure()
                gs = sys_.metrics.samples.get("graph_solve", [])
                if len(gs) > n_solved0:
                    solve_t.append(gs[-1])
        lap += 1
        if lap % 2 == 0:
            # p50s over the two laps, so that a run cut short still shows the trend
            log(f"lap {lap:4d}  kf={len(sys_.kf_stamps):6d}  closures={len(solve_t):4d} "
                f"loops={int(sys_.graph.n_loops):3d}  rss={rss_mb():.0f}MB "
                f"({time.time() - t_start:.0f}s)  kf p50 {p50(kf_lat[n_kf_logged:]) * 1e3:.1f} ms"
                f"  solve p50 {p50(solve_t[n_solve_logged:]) * 1e3:.1f} ms")
            n_kf_logged, n_solve_logged = len(kf_lat), len(solve_t)
    return {"system": sys_, "kf_lat": kf_lat, "solve_t": solve_t, "laps": lap,
            "frames": lap * FRAMES_PER_LAP, "rss0": rss0, "rss1": rss_mb(),
            "resident": sum(1 for c in sys_.kf_clouds if not isinstance(c, str)),
            "wall": time.time() - t_start}


def quartiles(x) -> tuple[float, float]:
    """p50 of the first and of the last quartile of ``x`` (seconds)."""
    q = max(len(x) // 4, 1)
    return p50(x[:q]), p50(x[-q:])


def verdict(r: dict, spill: bool) -> bool:
    """The three invariants: keyframe latency flat, graph solve under 1 s,
    resident archives bounded under spill."""
    lat_first, lat_last = quartiles(r["kf_lat"])
    _, sol_last = quartiles(r["solve_t"])
    bounded = not spill or r["resident"] <= r["system"].archive_keep_recent
    return bool(lat_last / lat_first < 1.5 and sol_last < 1.0 and bounded)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_keyframes", nargs="?", type=int, default=10000)
    ap.add_argument("--spill", action="store_true",
                    help="spill keyframe archives older than the newest 128 to a temporary "
                         "directory")
    ap.add_argument("--loop-every", type=int, default=10,
                    help="scans between loop-closure attempts (1 Hz at 10 Hz)")
    ap.add_argument("--speed-up", type=float, default=SPEED_UP,
                    help="the circle's speed-up time constant in seconds (the example's 8; "
                         "0.001 starts at full speed, so that the lap closes)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    args = ap.parse_args(argv)
    r = run(args.n_keyframes, spill=args.spill, loop_every=args.loop_every,
            device="cpu" if args.cpu else None, speed_up=args.speed_up)
    sys_ = r["system"]
    nk = len(sys_.kf_stamps)
    lat_first, lat_last = quartiles(r["kf_lat"])
    sol_first, sol_last = quartiles(r["solve_t"])
    print(f"\nkeyframes: {nk}, frames: {r['frames']}, closures: {len(r['solve_t'])}, "
          f"loop factors: {int(sys_.graph.n_loops)}")
    print(f"per-keyframe latency p50: first-quartile {lat_first * 1e3:.1f} ms -> last-quartile "
          f"{lat_last * 1e3:.1f} ms (ratio {lat_last / lat_first:.2f})")
    print(f"graph-solve p50: first-quartile {sol_first * 1e3:.1f} ms -> last-quartile "
          f"{sol_last * 1e3:.1f} ms (ratio {sol_last / max(sol_first, 1e-9):.2f})")
    inlock = sys_.metrics.samples.get("lc_inlock", [])
    if inlock:
        print(f"lc_inlock p50 {np.percentile(inlock, 50) * 1e3:.2f} ms "
              f"p95 {np.percentile(inlock, 95) * 1e3:.2f} ms (n={len(inlock)})")
    spill_dir = sys_.archive_spill_dir
    print(f"rss: {r['rss0']:.0f} -> {r['rss1']:.0f} MB; resident surf archives: "
          f"{r['resident']}/{nk}" + (f" (spill dir {spill_dir}, removed)" if spill_dir
                                     else " (no spill)"))
    if spill_dir:
        shutil.rmtree(spill_dir, ignore_errors=True)
    ok = verdict(r, args.spill)
    print("SOAK " + ("PASS" if ok else "FAIL"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
