#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lili_om_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--profile] [--out DIR]

Phases, each printing its own line; any failed check exits non-zero:

1. device: the card's name and power limit;
2. build: every CUDA kernel of the port, from ``lili_om_tpu_torch/csrc/``
   (one ``nvcc`` per source), and beside them the native host runtime
   ``csrc/lili_runtime.cc`` by the host C++ compiler, all started together;
   the runtime library's path and compiler are printed and it is loaded;
3. main path: ``Frame`` steps (spin features → scan-to-map odometry →
   sliding-window fusion) at the full ``fr_iosb_rot`` width on simulated
   64×1800 scans, with every kernel's launch count set to 0 just before and
   read just after (the kNN B1 with its map preparation, one per search,
   and the segment sum B4 of every voxel downsample and map-table merge);
   poses are held against the simulator's
   trajectory, then the same scans run again under ``plain_kernels()``,
   which launches no kernel, and the two trajectories are held together;
4. large-map path: odometry with a 98304-point map (above the
   count-bounded kernel's 65536-row limit), which takes the dense launch;
5. kernels against their plain versions, on the inputs the two paths gave
   each call site, plus an unmasked 4096×98304 dense case: B1/B2 through
   the per-call route (the map prepared in the call) and the prepared route
   (a ``KnnMap``), bit for bit; the preparation kernel against
   ``knn_map_plain`` once per map size; the times of both routes, the
   search alone, the preparation, the
   plain version, ``torch.cdist``+``topk`` as a yardstick, and the least
   time the card could take (the larger of bytes over 3.35 TB/s and 8 f32
   operations per needed (query, point) pair over 67 TFLOP/s, H100 SXM
   data-sheet peaks);
6. system phase: the port's ``LiliOmSystem`` at the full ``fr_iosb_rot``
   width (preset odometry, fusion, features and loop-closure widths) over a
   simulated lap at walking speed that returns to its start, IMU pushed up
   front, ``try_loop_closure`` every 10 scans, ``LILI_OM_KNN_PRUNED=1``
   throughout: at least one closure fires (ICP, graph solve, correction),
   the next keyframe rebuilds the fusion maps, every search launches the
   pruned kernel (B3) and none the count-bounded one, each ICP prepares its
   target map once and then launches one B3 search per iteration, B4
   launches, and the corrected keyframes stay near the simulator's; after
   the lap, each closure attempt's fitness untrimmed and trimmed, and how
   far its submaps lie from the simulated world's surfaces (with ``--out``,
   the submaps go to ``icp_attempts.npz`` for ``python3 -m
   tools.replay_icp``, and phase 12's to ``icp_attempts_<preset>.npz``); then B3 against the plain version and B1 on the
   inputs each of its call sites gave it (ICP's prepared map and source
   order included), timed as the site calls it beside the per-call route,
   its visits per block against the plain schedule's, its bound counting
   only the pairs of the tiles it scanned; and B3's map kernels (Morton
   keys, scatter into tiles) against their plain versions;
7. Livox phase, its lap run in a process of its own beside phase 6's lap
   (its kernel checks after both laps):
   ``LiliOmSystem.process_scan_livox`` at the whole ``fr_iosb``
   preset (eigen-patch features, reflectivity-weighted fusion) on the same
   lap with Horizon sweeps at full width (6 × 4000 points, ``n_cols``
   4000), closures every 10 scans, the pruned switch unset: odometry
   against the simulated sensor poses, the keyframe RMSE, surf matches on
   ≥ 90 % of the scans, B1 and B4 launched and B3 not, each ICP preparing
   its target once (one ``knn_map``) and launching one B1 search per
   iteration, the closure attempts and their fitness; then B1 against its
   plain version on the inputs each of its call sites on the lap gave it
   (ICP k=5 and k=1 on the recorded prepared map, odometry, fusion) and the
   preparation kernel per map size, as in phase 5;
8. B4 at every call site of the three paths (the first call of each from
   the recorded scan on): ids non-decreasing, two launches bit-identical,
   equal to the plain version on a CPU copy in float32 and float64, its
   times beside the plain version's, ``index_add_``'s and the bound;
9. runtime: the first 70 scans of the system lap written to a ``.lom``
   by the port's ``DatasetWriter`` through the native log writer (in a
   temporary directory, removed at the end), the same records through the
   plain ``runtime/log.py`` writer with the same bytes, the pruned switch
   unset; read back with ``read_dataset`` (the native reader) into direct
   ``process_scan`` calls with a checkpoint after 35 scans; the same log
   through ``ShardedIngest`` (2 spawned decode processes) into a serial
   ``PipelineRunner`` and an overlapped one, each over the first 35 scans
   (equal to the direct run's checkpoint there) with the loop thread
   off, each with the native sequencer and IMU ring (their types checked,
   every IMU sample counted through the ring), each equal to the direct
   run's checkpoint (bit for bit, or within ``TRAJ_TOL_*`` with the gap printed); the checkpoint
   loaded into a fresh system and run on, equal to the direct run's end;
   meanwhile, in a process of its own, the pipeline again with the loop
   thread on (1 s): every scan processed,
   no worker exception, at least one loop closed by the loop thread, the
   keyframe RMSE within ``KF_RMSE_TOL_M``, the exported map (the native
   PCD writer, the same bytes as ``write_pcd``) at a median distance to
   the world's surfaces within ``SUBMAP_SURF_TOL_M``; every run's
   keyframes archived surf features; ``record_synthetic`` on the card.
   Each run launches B1 and B4, no B3 and no plain version; it prints the
   scan rates serial and overlapped, the ``backend`` p50 and the decode
   time. Beside the phase, in a process of its own, the soak:
   ``apps/soak_long_run.main([SOAK_KF, "--spill", "--speed-up",
   SOAK_SPEED_UP])`` (the example's configuration on a lap that closes)
   returns 0 (keyframe latency flat, graph solve under 1 s, resident
   archives bounded), its report (latency and graph-solve quartiles,
   resident archives) printed, B1 and B4 launched, no B3 and no plain
   version;
10. multichip: ``LiliOmSystem(mesh=…)`` at the whole ``fr_iosb_rot``
   preset on the first 50 scans of the runtime phase's lap, closures every 10 scans,
   the pruned switch unset. (a) NCCL at world size 1: equal to the
   single-card system with ``incremental_map=False`` (bit for bit, or within
   ``TRAJ_TOL_*``), keyframe RMSE of both it and the default system within
   ``KF_RMSE_TOL_M``. (b) two gloo ranks on the card (NCCL refuses two ranks
   on one device), spawned: every rank's keyframes within 0.05 m of (a),
   the ranks' replicated-state digests equal, B1 (with its map
   preparation) at the sharded odometry and both map-shard searches and B4
   at both map-shard builds on every rank, no B3 and no plain version; and
   ``sharded_knn`` over a map whose second block is all invalid, equal to
   the plain search. Then B1 and B4 against their plain versions at the
   mesh sites: world 1's and rank 0's inputs from scan 40 on, rank 1's
   first calls (its map shards empty: zero walk bounds), and each rank's
   ``sharded_knn`` block. Per-scan times, the ``backend`` p50 and the
   fusion's per-keyframe ``all_gather`` (bytes, CUDA-event time) of each
   run. (c) the query-sharded fusion (``parallel/dist_fusion.py``): the
   keyframe inputs of the single-card incremental run (``FusionSpy``)
   replayed from its first state, without the closures' ring corrections,
   through ``fusion_step`` on the card, through ``make_distributed_fusion``
   over NCCL at world size 1 and on the two gloo ranks of (b): the outputs
   and states equal (bit for bit, or within ``TRAJ_TOL_*`` with the gap
   printed), B1 with its map preparation at both fusion sites and B4 on
   every rank, no B3 and no plain version; B1 against its plain version at
   each rank's block (its first call and its first from keyframe 10 on,
   each block's valid queries printed); the step time and the
   ``all_gather`` (bytes, CUDA-event time) per keyframe. (d)
   ``PipelineRunner`` over the mesh system on the lap's first 45 scans
   (the IMU fed up front, the scans from host copies, lossless, closure
   attempts every 10 scans counted in scans, the first closure firing at
   scan 40): (d1) serially at NCCL world
   size 1, its replicated-state digest equal to (a)'s after the same 45
   scans (``mesh_lap`` records it); (d2) overlapped there, the same
   keyframe stamps and fired scans as (d1) and keyframes within 0.05 m;
   (d3) both on (b)'s two gloo ranks, equal digests on both ranks, the
   serial one equal to (b)'s after 45 scans, the overlapped one against
   the serial as in (d2); ``check_replicated`` true at ``stop()`` in every
   run; B1 with its map preparation at the sharded odometry and both
   map-shard searches and B4 at both map-shard builds on every rank, no B3
   and no plain version; each run's scans/s, ``backend`` p50 and fired
   closures printed; then B1 and B4 against their plain versions at
   (d1)'s sites from scan 40 on. (a), the batch-map reference, (d1), (d2)
   and (c)'s single-card and world-1 replays run in this process while
   (b)'s ranks run, so their times and the ranks' come under each other's
   load;
11. with ``--profile``, a ``torch.profiler`` window over a few main-path
   frames (device busy share, kernels by device time), and in phase 9 a
   profiler window over one more direct and one more pipeline run (device
   busy share, the CUDA runtime calls of every thread);
12. evaluate (run before 11), the pruned switch unset: (a) the JAX golden-loop
   harness's table through ``apps/evaluate_presets.run_preset`` over its
   default presets (``synthetic`` 16×900, ``fr_iosb_rot`` 64×900, ``fr_iosb``
   Livox 6 × 4000), 200 frames each, float32 (with (b)'s two runs, one
   spawned process per run, all at once), every keyframe ATE within the
   harness's bound and beside the JAX package's TPU record, B1 and B4
   launched in each run and no plain version; (b) ``aggressive_trajectory``
   (tests/test_golden_motion.py) through the whole ``fr_iosb_rot`` preset at
   64×1800 and ``fr_iosb`` at 6 × 4000, 120 frames from rest, so that the
   run flies the start-up ramp and then the yaw bursts (above 1.5 rad/s
   from 7.2 s on, required of the simulated gyro): the backend's keyframe
   ATE under 0.6 m, surf matches on ≥ 90 % of scans after two; (c) ``export_run`` of (a)'s ``fr_iosb_rot`` system:
   the TUM file reloads to the graph within its ``%.6f``, the PLY's and the
   PCD's point counts equal the map's, the PNG drawn where matplotlib is
   installed (else its ``ImportError`` names the PNG); (d) a ``LiveViewer``
   on a 40-scan run publishing every 1 s of scan time, its files written
   and ``index.html`` fetched over localhost; (e) ``device_trace`` around
   three main-path ``Frame`` steps names B1's and B4's kernels; (f)
   ``hashgrid_knn`` on the card at the odometry's search shape finds every
   neighbour B1 finds inside the NN gate for each query whose 27 cells
   hash to distinct buckets, and misses one elsewhere only where its result
   holds a point twice; both timed; in this process while (a) and (b)'s
   processes run, (h) ``apps/diag_backend.run`` over ``DIAG_FRAMES``
   frames: both ATEs finite and printed, B1 and B4 launched, no plain
   version.

Then one line with the ``kernels`` JSON, the ``nvidia-smi`` name/power-limit
line, and last ``{"ok": true, "device": {...}}``. It imports nothing of the
JAX package and needs no network.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import io
import hashlib
import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import urllib.request

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from lili_om_tpu_torch import cuda_build
from lili_om_tpu_torch.apps import diag_backend, evaluate_presets, run_loop_closure, soak_long_run
from lili_om_tpu_torch.device import plain_kernels
from lili_om_tpu_torch.frame import Frame, bench_configs, sim_scans
from lili_om_tpu_torch.io.checkpoint import load_system, save_system
from lili_om_tpu_torch.io.dataset import (DatasetWriter, ImuRecord, ScanRecord, decode_spin,
                                          read_dataset, record_synthetic)
from lili_om_tpu_torch.io.pcd import read_pcd, write_pcd
from lili_om_tpu_torch.models import system as system_mod
from lili_om_tpu_torch.models.fusion import fusion_step
from lili_om_tpu_torch.models.system import LiliOmSystem
from lili_om_tpu_torch.ops import knn as K
from lili_om_tpu_torch.ops import segred as SG
from lili_om_tpu_torch.ops import voxel as voxel_mod
from lili_om_tpu_torch.ops.hashgrid import build_grid, hashgrid_knn, neighbour_buckets
from lili_om_tpu_torch.parallel import dist_fusion as dist_fusion_mod
from lili_om_tpu_torch.parallel import map_fusion as map_fusion_mod
from lili_om_tpu_torch.parallel.dist_fusion import make_distributed_fusion
from lili_om_tpu_torch.parallel.sharded import make_mesh, sharded_knn
from lili_om_tpu_torch.runtime import log as plain_log
from lili_om_tpu_torch.runtime import native
from lili_om_tpu_torch.runtime.ingest import ShardedIngest
from lili_om_tpu_torch.runtime.pipeline import PipelineRunner
from lili_om_tpu_torch.sim.lidar import livox_pattern, simulate_scan, spinning_pattern
from lili_om_tpu_torch.sim.trajectory import (aggressive_trajectory, circle_trajectory, pose_at,
                                              simulate_imu)
from lili_om_tpu_torch.sim.world import World, make_room_world
from lili_om_tpu_torch.utils.config import load_config
from lili_om_tpu_torch.utils.evaluation import ate_rmse, host, load_tum
from lili_om_tpu_torch.utils.live_viz import LiveViewer
from lili_om_tpu_torch.utils.metrics import device_trace
from lili_om_tpu_torch.utils.viz import export_run
from lili_om_tpu_torch.utils.math import (pose_relative, quat_conj, quat_conj_np, quat_mul,
                                          quat_normalize, quat_rotate, quat_rotate_np)

PEAK_F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
FLOP_PER_PAIR = 8  # 3 sub, 3 mul, 2 add for (q-p)^2
N_WARM = 3
N_TIMED = 12  # main-path scans timed after the N_WARM warm-up scans
LARGE_MAP = 98304
# the same scans through the kernels and through their plain versions. The
# searches agree bit for bit, but the plain run's voxel sums (index_add_)
# use atomics on the card and so round in a run-dependent order; the
# solvers' stopping tests (odometry step norm 1e-5, fusion 1e-4) can turn
# that into one iteration more or less, a pose change of the order of those
# tolerances per scan
TRAJ_TOL_M, TRAJ_TOL_RAD = 5e-3, 5e-3
# odometry against the simulator's ground truth over a short run from rest
GT_TOL_M, GT_TOL_RAD = 0.25, 0.05
REPLACES = {"knn_counted": "lili_om_tpu/ops/knn_pallas.py:234",
            "knn_dense": "lili_om_tpu/ops/knn_pallas.py:64",
            # B1/B2's preparation does the work of knn_pallas_counted's
            # pre-pass around its Pallas call (masking, padding, last valid row)
            "knn_map": "lili_om_tpu/ops/knn_pallas.py:303-326",
            "knn_pruned": "lili_om_tpu/ops/knn_pallas.py:426",
            # B3's map kernels do the work of knn_pallas_pruned's pre-pass
            # around its Pallas call (Morton keys and sorts, padding, tile boxes)
            "pruned_keys": "lili_om_tpu/ops/knn_pallas.py:533-567",
            "pruned_scatter": "lili_om_tpu/ops/knn_pallas.py:533-567",
            "segred": "lili_om_tpu/ops/segred_pallas.py:39"}
SOURCE = "lili_om_tpu_torch/csrc/knn.cu"
SOURCE_PRUNED = "lili_om_tpu_torch/csrc/knn_pruned.cu"
SOURCE_SEGRED = "lili_om_tpu_torch/csrc/segred.cu"
# system phase: scans, the lap (returns to its start at scan ~139, the
# speed ramp of circle_trajectory included), closure attempts every 10 scans
SYS_SCANS = 150
SYS_RINGS, SYS_COLS = 64, 1800
SYS_LAP_S = (SYS_SCANS - 40) * 0.1
LC_EVERY = 10
# B3's inputs are copied at the first call of each call site from this scan
# on: the maps are grown by then, and the closure attempt at this scan runs
# ICP
SYS_RECORD_FROM = 40
# the closure attempts, read after the lap: the fitness trimmed to the best
# 70 % (examples/run_loop_closure.py's icp_trim) at the ICP's final pose, and
# the share of source points farther than FAR_M from the target; matches
# beyond ICP's max_corr_dist do not count, as in its own fitness
ICP_TRIM, FAR_M, ICP_MAX_CORR_M = 0.7, 1.0, 30.0
# graph keyframes against the simulator after the closures, RMSE (the JAX
# package's golden-loop harness, examples/evaluate_presets.py, bounds its
# keyframe error at 1.0 m)
KF_RMSE_TOL_M = 0.5
# median distance of a loop submap's points to the simulated world's
# surfaces: the keyframe poses' error (the bound above) plus the features'
# own spread
SUBMAP_SURF_TOL_M = 0.25
# Livox phase: the Horizon's 24k points per 0.1 s sweep as 6 lines × 4000,
# binned into the preset's 4000 columns; after the two bootstrap scans at
# least this share of scans must match surfaces (tests/test_golden_motion.py)
LIVOX_LINES, LIVOX_PTS = 6, 4000
ACQUIRED_MIN = 0.9
# runtime phase: the first RT_SCANS scans of the system lap through a .lom,
# the checkpoint after RT_SAVE_AT, RT_INGEST_HOSTS spawned decode workers,
# the loop thread's period in the closure run. The lap first comes back
# within the loop search radius of its start after time_thres (the system
# phase's first closure fires at scan 40), so 70 scans leave the loop
# thread some 30 scans of revisit to close on
RT_SCANS, RT_SAVE_AT, RT_INGEST_HOSTS, RT_LOOP_PERIOD_S = 70, 35, 2, 1.0
# multichip phase: the first MC_SCANS scans of the lap ((a)'s first closure
# fires at scan 40; (d) runs the first MC_RUNNER_SCANS), closures every
# LC_EVERY scans, 2 gloo ranks sharing the card (NCCL refuses two ranks on
# one device). The 2-rank run deduplicates voxels per rank where a voxel
# spans two ranks' keyframes: its keyframes are held to the world-1 run's
# within MC_SHARD_TOL_M (tests/test_sharded_frontend.py's bound). Its sites
# are recorded twice: at each site's first call (the map shards of an
# empty ring: zero walk bounds) and from scan MC_RECORD_FROM on (grown).
# The sharded_knn check: MC_KNN_Q queries against MC_KNN_P points, the
# second rank's block all invalid
MC_SCANS, MC_RANKS, MC_SHARD_TOL_M, MC_RECORD_FROM = 50, 2, 0.05, SYS_RECORD_FROM
MC_KNN_Q, MC_KNN_P = 4096, 65536
# (c): B1's inputs on each rank at its first call and at its first from
# this keyframe on (the maps grown)
MC_DIST_RECORD_FROM = 10
MC_JOIN_S = 900
# (d): PipelineRunner over the mesh on the lap's first MC_RUNNER_SCANS scans,
# closure attempts every LC_EVERY scans; (a) and (b) record their
# replicated-state digest after the same scans for it. No keyframe is older
# than time_thres (3.67 s) before scan ~37, so the first 35 scans
# (RT_SAVE_AT) would attempt only without a candidate: 45 take in (a)'s
# first closure, at scan 40
MC_RUNNER_SCANS = 45
# the soak (apps/soak_long_run.py with --spill), in a process of its own
# beside the runtime phase's runs, to SOAK_KF keyframes on a lap that closes
# (SOAK_SPEED_UP, a departure from the example's 8 s ramp, under which no
# closure fires in two laps): the count is checked after each lap of ~100
# keyframes and closures fire from the second lap on, time_thres being 0.6
# of a lap, so a target within the second lap runs two laps, the fewest that
# measure the graph solve; evaluate (h), in this process while (a) and (b)'s
# processes run: apps/diag_backend.py over DIAG_FRAMES frames
SOAK_KF, SOAK_SPEED_UP, DIAG_FRAMES = 150, 0.001, 60
# evaluate phase: the JAX golden-loop harness (examples/evaluate_presets.py)
# over its default presets, EV_FRAMES frames each, float32, each preset's
# keyframe ATE held to its bound there (1.0 m); beside it, for reading
# only, the JAX package's record on its TPU in float32 (docs/STATUS.md:
# 188-190; no record for "synthetic")
EV_FRAMES = 200
EV_JAX_KF_ATE = {"fr_iosb_rot": 0.111, "fr_iosb": 0.211}
# aggressive motion (tests/test_golden_motion.py at full preset widths):
# AG_FRAMES sweeps from rest, the backend's keyframe ATE against the
# world-axes truth under AG_BOUND_M (:154-155), surf matches on ACQUIRED_MIN
# of the scans after the two bootstrap scans (:168-169). The JAX test's 60
# sweeps end on the start-up ramp (peak 0.97 rad/s); the yaw bursts start at
# 7.2 s (the JAX test of the bursts samples 5-12 s, :27-32), so the run
# takes 12 s of sweeps and requires a gyro peak above AG_MIN_GYRO
AG_FRAMES, AG_BOUND_M, AG_MIN_GYRO = 120, 0.6, 1.5
AG_PRESETS = ("fr_iosb_rot", "fr_iosb")
# the live viewer's run (apps/run_loop_closure.py's system, 16×720) and
# its map-publish period in seconds of scan time
LV_FRAMES, LV_PUBLISH_S = 40, 1.0
# the hash grid against B1 at the odometry's search: buckets and slots per
# bucket (enough that no map point overflows at the odometry's 0.4 m leaf)
HG_BUCKETS, HG_CAP = 65536, 32
DEV = "cuda"


class CheckFailed(Exception):
    pass


# seconds spent in the kernel-against-plain checks (the compare_* functions),
# to read beside each phase's wall time
CHECK_S = [0.0]


def timed_check(fn):
    @functools.wraps(fn)
    def wrap(*args, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            CHECK_S[0] += time.perf_counter() - t0
    return wrap


def check(ok: bool, what: str):
    if not ok:
        raise CheckFailed(what)


def sync():
    torch.cuda.synchronize()


def reset_counts():
    """Every kernel wrapper's launch count to 0."""
    K.reset_launch_counts()
    SG.reset_launch_counts()


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    sync()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def device_ms(fn, kernel: str, iters: int = 20):
    """Mean device time of one launch of the kernel whose name holds
    ``kernel`` (``fn`` launches it once), from a ``torch.profiler`` window
    over ``iters`` calls: CUDA events around back-to-back calls time the
    host's enqueue wherever a kernel is shorter than its launch. The mean is
    over the launches the window recorded; a window that recorded fewer
    than half of them is taken again. None if none was recorded."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            sync()
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key]
        n = sum(e.count for e in rows)
        if 2 * n >= iters:
            return sum(e.self_device_time_total for e in rows) / 1e3 / n
    return None


def run_path(cfgs, scans, label: str):
    """Drive ``Frame`` over ``scans`` with the launch counts set to 0 just
    before and read just after. Returns (frame, poses, per-scan ms, kNN
    counts, segment-sum counts)."""
    frame = Frame(cfgs, device=DEV)
    sync()
    reset_counts()
    poses, host_ms, dev_ms = [], [], []
    for s in scans:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        oout, fout = frame.step(s)
        b.record()
        b.synchronize()
        host_ms.append(1e3 * (time.perf_counter() - t0))
        dev_ms.append(a.elapsed_time(b))
        poses.append((oout.t.clone(), oout.q.clone(), fout.t_latest.clone(),
                      int(oout.n_corr), int(fout.n_surf_corr), int(fout.n_edge_corr)))
    counts, seg_counts = dict(K.LAUNCHES), dict(SG.LAUNCHES)
    timed = sorted(host_ms[N_WARM:])
    print(f"[{label}] {len(scans)} scans: per-scan host ms median "
          f"{timed[len(timed) // 2]:.3f} min {timed[0]:.3f} max {timed[-1]:.3f}; "
          f"event ms median {sorted(dev_ms[N_WARM:])[len(timed) // 2]:.3f}; "
          f"launches {sum(counts.values())} "
          f"{ {f'{w}:{q}x{p}:k{k}': n for (w, q, p, k), n in sorted(counts.items())} }; "
          f"segred launches {sum(seg_counts.values())}")
    return frame, poses, host_ms, counts, seg_counts


def gt_errors(poses, pose_fn):
    """Max odometry error against the simulated sensor poses ``pose_fn(t)``,
    relative to scan 0."""
    t0, q0 = pose_fn(0.0)
    et = er = 0.0
    for k, (t, q, *_rest) in enumerate(poses):
        tk, qk = pose_fn(k * 0.1)
        rt, rq = pose_relative(t0, q0, tk, qk)
        et = max(et, float(torch.linalg.norm(t.double() - rt)))
        dq = quat_mul(quat_conj(rq), q.double())
        er = max(er, float(2.0 * torch.linalg.norm(dq[1:])))
    return et, er


def traj_gap(pa, pb):
    gt = gr = 0.0
    for (ta, qa, fa, *_), (tb, qb, fb, *_) in zip(pa, pb):
        gt = max(gt, float(torch.linalg.norm(ta - tb)), float(torch.linalg.norm(fa - fb)))
        dq = quat_mul(quat_conj(qa), qb)
        gr = max(gr, float(2.0 * torch.linalg.norm(dq[1:])))
    return gt, gr


class Patch:
    """Replaces ``module.<name>`` with ``self`` for a ``with`` block."""

    def __init__(self, module, name: str):
        self.module, self.name, self.orig = module, name, getattr(module, name)

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


class Recorder(Patch):
    """Wraps the kernel wrapper ``K.<name>`` for a run: every call launches
    the kernel once, as unwrapped, and while ``armed`` the inputs of the
    first call at each call site (Q, P, k) are copied for the kernel checks
    (one copy per site, so a timed run pays for a few copies only). The map
    may come prepared (a ``K.PrunedMap`` with the caller's query order, or a
    ``K.KnnMap``)."""

    def __init__(self, name: str, armed: bool = True):
        super().__init__(K, name)
        self.armed, self.seen = armed, {}

    def __call__(self, queries, points, k=5, p_mask=None, q_mask=None, **kw):
        prepared = isinstance(points, (K.PrunedMap, K.KnnMap))
        key = (queries.shape[0], points.n_points if prepared else points.shape[0], k)
        if self.armed and key not in self.seen:
            copy = lambda x: None if x is None else x.clone()
            if isinstance(points, K.PrunedMap):
                pts = K.PrunedMap(*(copy(x) for x in points[:5]), *points[5:])
            elif prepared:
                pts = K.KnnMap(copy(points.pts4), copy(points.bound), points.n_points)
            else:
                pts = copy(points)
            self.seen[key] = (copy(queries), pts, copy(p_mask), copy(q_mask),
                              copy(kw.get("q_order")))
        return self.orig(queries, points, k, p_mask, q_mask, **kw)


class IcpSpy(Patch):
    """Wraps the system's ``icp_point_to_plane``: keeps each attempt's
    submaps and result (by reference: the submaps are fresh tensors) under
    the scan index ``scan`` that the caller sets."""

    def __init__(self):
        super().__init__(system_mod, "icp_point_to_plane")
        self.scan, self.calls = -1, []

    def __call__(self, src, src_m, tgt, tgt_m, *args, **kw):
        res = self.orig(src, src_m, tgt, tgt_m, *args, **kw)
        self.calls.append((self.scan, (src, src_m, tgt, tgt_m), res))
        return res


class FusionSpy(Patch):
    """Wraps the system's ``fusion_step``: keeps the ``rebuild`` flag of
    every keyframe under the scan index ``scan`` that the caller sets. With
    ``record``, also host copies of each keyframe's inputs (the clouds and
    the IMU interval, with the warm-up flag) and of the first call's state,
    config and IMU noise: what a replay of the backend needs."""

    def __init__(self, record: bool = False):
        super().__init__(system_mod, "fusion_step")
        self.scan, self.rebuild = -1, []
        self.record, self.inputs, self.first = record, [], None

    def __call__(self, *args, rebuild=False, **kw):
        self.rebuild.append((self.scan, rebuild))
        if self.record:
            if self.first is None:
                self.first = (tree_to(args[0], "cpu"), args[10], args[11])
            self.inputs.append((tuple(a.cpu() for a in args[1:10]), kw.get("warmup", False)))
        return self.orig(*args, rebuild=rebuild, **kw)


def tree_to(nt, dev):
    """A (nested) NamedTuple of tensors moved to ``dev``."""
    return type(nt)(*(tree_to(v, dev) if hasattr(v, "_fields") else
                      v.to(dev) if isinstance(v, torch.Tensor) else v for v in nt))


class SegRecorder(Patch):
    """Wraps ``ops/voxel.py``'s ``segment_sum_auto`` for a run: every call
    goes on as unwrapped (B4 on the card), and while ``armed`` the inputs of
    the first call from each call site are copied for the kernel checks. A
    site is the voxel function and line, its first caller outside
    ``ops/voxel.py`` and the shape (N, C, num_out)."""

    def __init__(self, armed: bool = True):
        super().__init__(voxel_mod, "segment_sum_auto")
        self.armed, self.seen = armed, {}

    def __call__(self, payload, seg_id, num_out):
        if self.armed:
            f = sys._getframe(1)
            inner = f"{f.f_code.co_name}:{f.f_lineno}"
            while f is not None and f.f_globals.get("__name__") == voxel_mod.__name__:
                f = f.f_back
            outer = f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}" if f else "?"
            key = (outer, inner, payload.shape[0], payload.shape[1], num_out)
            if key not in self.seen:
                self.seen[key] = (payload.clone(), seg_id.clone())
        return self.orig(payload, seg_id, num_out)


def capture_inputs(frame: Frame, scan):
    """One extra step with the count-bounded and dense wrappers and the
    segment sum recording their inputs: the tensors each call site of the
    path hands the kernel. Returns (kNN inputs, segment-sum inputs)."""
    with (Recorder("knn_counted_cuda") as counted, Recorder("knn_dense_cuda") as dense,
          SegRecorder() as seg):
        frame.step(scan)
    sync()
    return ({(name,) + key: v for name, rec in (("knn_counted", counted), ("knn_dense", dense))
             for key, v in rec.seen.items()}, seg.seen)


def site_names(odo, fus, icp_cap=None):
    """{(Q, P): call site} of the kNN searches of one configuration."""
    names = {(odo.query_cap, odo.map_cap): "odometry",
             (fus.window * fus.kf_surf_cap, fus.map_surf_cap): "fusion_surf",
             (fus.window * fus.kf_edge_cap, fus.map_edge_cap): "fusion_edge"}
    if icp_cap is not None:
        names[icp_cap, icp_cap] = "icp"
    return names


def library_knn(queries, points, k, p_mask, q_mask):
    """``torch.cdist`` + ``topk``: the yardstick, used nowhere in the port."""
    d = torch.cdist(queries, points)
    if p_mask is not None:
        d = d.masked_fill(~p_mask[None, :], float("inf"))
    v, i = torch.topk(d, k, dim=1, largest=False)
    return v * v, i


def knn_map_points(kmap):
    """The raw map (points, mask) a ``K.KnnMap`` was prepared from."""
    return kmap.pts4[:, :3].contiguous(), kmap.pts4[:, 3] == 0.0


@timed_check
def compare_kernel(name, site, inputs, launches, k=5):
    """B1/B2 at one call site against the plain version on the same inputs
    (equal bit for bit), through the per-call route (the map prepared in the
    call: two launches) and the prepared route (a ``K.KnnMap``: one launch);
    the preparation kernel against ``knn_map_plain``; times of each route as
    the site calls it, the search alone (CUDA events, and the device time
    from a profiler window), the plain version and cdist+topk; the bound."""
    q, pts, pm, qm = inputs[:4]
    prepared = isinstance(pts, K.KnnMap)
    p, pm = knn_map_points(pts) if prepared else (pts, pm)
    wrapper = K.knn_counted_cuda if name == "knn_counted" else K.knn_dense_cuda
    fresh, plain_map = K.knn_map(p, pm), K.knn_map_plain(p, pm)
    sync()
    check(bool(torch.equal(fresh.pts4, plain_map.pts4))
          and bool(torch.equal(fresh.bound, plain_map.bound)),
          f"{site}: the prepared map differs from knn_map_plain")
    if prepared:
        check(bool(torch.equal(pts.pts4, fresh.pts4)) and bool(torch.equal(pts.bound, fresh.bound)),
              f"{site}: the recorded map differs from a fresh one")
    kmap = pts if prepared else fresh
    d_k, i_k = wrapper(q, p, k, pm, qm)
    d_r, i_r = wrapper(q, kmap, k, q_mask=qm)
    d_p, i_p = K.knn(q, p, k=k, q_mask=qm, p_mask=pm)
    sync()
    # the kernel sums (q-p)^2 in the plain version's order without FMA and
    # keeps the (d^2, index) order through its lanes' merge: its distances
    # and indices must equal the plain version's exactly, on either route
    fin = torch.isfinite(d_p)
    err = max(float((d[fin] - d_p[fin]).abs().max()) if bool(fin.any()) else 0.0
              for d in (d_k, d_r))
    for route, (d, i) in (("per-call", (d_k, i_k)), ("prepared", (d_r, i_r))):
        check(bool(torch.equal(d, d_p)), f"{site} ({route}): distances differ from the plain "
              f"version (max {err:.3e})")
        check(bool(torch.equal(i, i_p)), f"{site} ({route}): indices differ from the plain "
              f"version at {int((i != i_p).sum())} slots")
    check(bool(torch.all(i_k[~fin] == 0)), f"{site}: empty slots must hold index 0")
    check(bool(torch.all(d_k[:, 1:] >= d_k[:, :-1])), f"{site}: distances not ascending")
    if pm is not None:
        check(bool(torch.all(pm[i_k[fin]])), f"{site}: a masked point matched")
    # each returned index reproduces its distance, summed in the same order
    diff = q[:, None, :] - p[i_k]
    g = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
    g = g + diff[..., 2] * diff[..., 2]
    check(bool(torch.equal(g[fin], d_k[fin])), f"{site}: gathered distances differ")

    raw_ms = cuda_ms(lambda: wrapper(q, p, k, pm, qm), 50)
    prep_ms = cuda_ms(lambda: wrapper(q, kmap, k, q_mask=qm), 50)
    kernel_ms = cuda_ms(lambda: K.launch_kernel(q, kmap, qm, k), 50)
    dev_ms = device_ms(lambda: K.launch_kernel(q, kmap, qm, k), "search_kernel")
    plain_ms = cuda_ms(lambda: K.knn(q, p, k=k, q_mask=qm, p_mask=pm), 10)
    lib_ms = cuda_ms(lambda: library_knn(q, p, k, pm, qm), 10)
    ms = prep_ms if prepared else raw_ms
    fmt = lambda t: "not measured" if t is None else f"{t:.4f} ms"

    Q, P = q.shape[0], p.shape[0]
    nq = Q if qm is None else int(qm.sum())
    np_ = P if pm is None else int(pm.sum())
    flops = FLOP_PER_PAIR * nq * np_
    nbytes = 12 * Q + 12 * P + (0 if qm is None else Q) + (0 if pm is None else P) \
        + Q * k * (4 + 8)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    bound_ms = 1e3 * max(t_ops, t_bytes)
    print(f"[kernel] {site}: valid q {nq}/{Q} p {np_}/{P} (walk bound {int(kmap.bound[0])}); "
          f"max|Δd²| {err:.3e}; as called ({'prepared' if prepared else 'per-call'} route) "
          f"{ms:.4f} ms; per-call route {raw_ms:.4f} ms; prepared route {prep_ms:.4f} ms; "
          f"search kernel {kernel_ms:.4f} ms, device time {fmt(dev_ms)}; "
          f"plain {plain_ms:.4f} ms; cdist+topk {lib_ms:.4f} ms; bound "
          f"{bound_ms:.5f} ms")
    return {"name": f"{name}[{site}]", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches, "max_abs_err": err,
            "ms": ms, "kernel_only_ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib_ms, "as_called": "prepared" if prepared else "per-call",
            "per_call_route_ms": raw_ms, "prepared_route_ms": prep_ms,
            "kernel_device_ms": dev_ms, "shape": [Q, P], "valid": [nq, np_]}


@timed_check
def compare_knn_map(what, pts, mask, launches):
    """B1/B2's preparation kernel on one map against ``knn_map_plain``
    (equal bit for bit): its times as called (allocation included), the
    kernel alone and the plain version's; the bound counts its bytes (the
    points and the mask read once, the float4 rows and the bound written)."""
    P = pts.shape[0]
    kmap = K.knn_map_cuda(pts, mask)
    ref = K.knn_map_plain(pts, mask)
    sync()
    check(bool(torch.equal(kmap.pts4, ref.pts4)) and bool(torch.equal(kmap.bound, ref.bound)),
          f"knn_map {what}: differs from knn_map_plain")
    ms = cuda_ms(lambda: K.knn_map_cuda(pts, mask), 50)
    kernel_ms = cuda_ms(lambda: K.launch_map_kernel(pts, mask, kmap), 50)
    dev_ms = device_ms(lambda: K.launch_map_kernel(pts, mask, kmap), "map_kernel")
    plain_ms = cuda_ms(lambda: K.knn_map_plain(pts, mask), 50)
    t_bytes = (12 * P + (0 if mask is None else P) + 16 * P + 4) / PEAK_BYTES
    bound_ms = 1e3 * t_bytes
    print(f"[kernel] knn_map {what}: {P} rows, walk bound {int(kmap.bound[0])}; wrapper "
          f"{ms:.4f} ms kernel {kernel_ms:.4f} ms (device time "
          f"{'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'}) plain {plain_ms:.4f} ms bound "
          f"{bound_ms:.5f} ms; launches of this shape on the path {launches}")
    return {"name": f"knn_map[{what}]", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES["knn_map"], "launches": launches, "max_abs_err": 0.0,
            "ms": ms, "kernel_only_ms": kernel_ms, "kernel_device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": None, "shape": [P]}


def compare_sites(phase, inputs, counts, names, with_maps: bool = True):
    """``compare_kernel`` at every recorded site of one path, then (with
    ``with_maps``) the preparation kernel once per map size (its launches
    are counted per size). ``inputs``: {(wrapper name, Q, P, k): recorded
    inputs}."""
    rows, maps = [], {}
    for (w, q, p, k), v in sorted(inputs.items()):
        site = f"{phase}{names.get((q, p), 'site')}_k{k}_{q}x{p}"
        rows.append(compare_kernel(w, site, v, counts.get((w, q, p, k), 0), k=k))
        pts = v[1]
        if with_maps:
            maps.setdefault(p, knn_map_points(pts) if isinstance(pts, K.KnnMap)
                            else (pts, v[2]))
    for p, (pts, mask) in sorted(maps.items()):
        rows.append(compare_knn_map(f"{phase}{p}", pts, mask, counts.get(("knn_map", 0, p, 0), 0)))
    return rows


def lap_trajectory():
    """The golden loop's circle at 1.3 m/s, one lap in ``SYS_LAP_S``, and
    its radius."""
    radius = 1.3 * SYS_LAP_S / (2.0 * math.pi)
    return circle_trajectory(radius=radius, period=SYS_LAP_S, speed_up=3.0), radius


def sim_lap(cfg, n: int, livox: bool = False):
    """The golden loop of examples/evaluate_presets.py, cut to ``n`` scans:
    a circle at 1.3 m/s in the room world that returns to its start within
    the run, scans cast from the sensor pose of the preset's extrinsic, the
    IMU at 200 Hz over the whole run. Spinning 64×1800 sweeps as organized
    images, or with ``livox`` Horizon sweeps of 6 × 4000 points as flat
    streams (pts, line, time ratio, reflectivity, valid). Returns (scans,
    imu, trajectory, radius, sensor-in-body (t_sl, q_sl))."""
    traj, radius = lap_trajectory()
    world = make_room_world(device=DEV)
    pattern = (livox_pattern(LIVOX_LINES, LIVOX_PTS, device=DEV) if livox
               else spinning_pattern(n_rings=SYS_RINGS, n_cols=SYS_COLS, device=DEV))
    q_lb = np.asarray(cfg.fusion.q_lb, float)
    q_sl = quat_conj_np(q_lb[None])[0]
    t_sl = -quat_rotate_np(q_sl[None], np.asarray(cfg.fusion.t_lb, float)[None])[0]
    scans = []
    for k in range(n):
        sc = simulate_scan(world, traj, k * 0.1, pattern, period=0.1, t_sl=t_sl, q_sl=q_sl)
        if livox:
            scans.append((sc.pts, sc.line, sc.rel_time, sc.reflectivity, sc.valid))
        else:
            scans.append((sc.pts.reshape(SYS_RINGS, SYS_COLS, 3),
                          sc.valid.reshape(SYS_RINGS, SYS_COLS),
                          sc.rel_time.reshape(SYS_RINGS, SYS_COLS)))
    imu = simulate_imu(traj, 0.0, n * 0.1 + 0.1, rate=200.0, device=DEV)
    return scans, imu, traj, radius, (t_sl, q_sl)


def sensor_pose_fn(traj, t_sl, q_sl):
    """The simulated sensor pose at time t: the body pose composed with the
    sensor-in-body extrinsic (the odometry's frame is the first sensor
    pose)."""
    t_sl = torch.as_tensor(t_sl, dtype=torch.float64, device=DEV)
    q_sl = torch.as_tensor(q_sl, dtype=torch.float64, device=DEV)

    def pose(t):
        tb, qb = pose_at(traj, t, device=DEV)
        return tb + quat_rotate(qb, t_sl), quat_mul(qb, q_sl)
    return pose


def keyframe_errors(sys_, traj, t0w, q0w):
    """Each graph keyframe's distance to the simulator's body pose at its
    stamp (the odometry frame is the first body pose ``t0w, q0w``)."""
    return graph_errors(sys_.graph.t[:len(sys_.kf_stamps)], sys_.kf_stamps, traj, t0w, q0w)


def graph_errors(g_t, stamps, traj, t0w, q0w):
    """:func:`keyframe_errors` of graph positions ``g_t`` at ``stamps``."""
    gt = torch.stack([pose_relative(t0w, q0w, *pose_at(traj, s, device=DEV))[0]
                      for s in stamps])
    return torch.linalg.norm(torch.as_tensor(g_t, device=DEV).double() - gt, dim=1)


def system_config():
    """The ``fr_iosb_rot`` preset at full width: odometry, fusion, features,
    IMU noise and loop closure."""
    return load_config("fr_iosb_rot")


def system_phase():
    """Drive ``LiliOmSystem`` over the lap with the pruned kNN switched on.
    Returns (system, per-scan host ms, kNN launch counts, recorded B3
    inputs, facts for the checks, the closure attempts, (segment-sum launch
    counts, recorded B4 inputs))."""
    cfg = system_config()
    lc = dataclasses.replace(cfg.loop_closure, time_thres=SYS_LAP_S / 3.0)
    t0 = time.perf_counter()
    scans, imu, traj, radius, _ = sim_lap(cfg, SYS_SCANS)
    sync()
    print(f"[system] cuts: {SYS_SCANS} scans (a lap of {SYS_LAP_S:.1f} s, radius "
          f"{radius:.2f} m, at 1.3 m/s); time_thres {cfg.loop_closure.time_thres} -> "
          f"{lc.time_thres:.2f} s (the lap is shorter than 60 s); deskew_translation on "
          f"(as the JAX golden loop runs); ICP gate as the preset (icp_trim "
          f"{lc.icp_trim}, icp_thres {lc.icp_thres}); sim {time.perf_counter() - t0:.2f} s")
    sys_ = LiliOmSystem(cfg.odometry, cfg.fusion, cfg.spin_features, cfg.livox_features, lc,
                        cfg.imu_noise, device=DEV)
    sys_.deskew_translation = True
    sys_.push_imu(imu.stamps.cpu().numpy(), imu.accs.cpu().numpy(), imu.gyrs.cpu().numpy())
    t0w, q0w = pose_at(traj, 0.0, device=DEV)
    fired, host_ms, lc_ms = [], [], []
    prev = os.environ.get("LILI_OM_KNN_PRUNED")
    os.environ["LILI_OM_KNN_PRUNED"] = "1"
    try:
        # B3 is reached through knn_auto (odometry, fusion) and through
        # K.searcher (ICP's prepared route)
        with (Recorder("knn_pruned_cuda", armed=False) as rec,
              IcpSpy() as icp, FusionSpy() as fus, SegRecorder(armed=False) as seg):
            sync()
            reset_counts()
            for k, (img, valid, rel) in enumerate(scans):
                rec.armed = seg.armed = k >= SYS_RECORD_FROM
                icp.scan = fus.scan = k
                t1 = time.perf_counter()
                sys_.process_scan(img, valid, rel, k * 0.1)
                sync()
                host_ms.append(1e3 * (time.perf_counter() - t1))
                if k % LC_EVERY == 0 and k > 0:
                    t1 = time.perf_counter()
                    ok = sys_.try_loop_closure()
                    sync()
                    lc_ms.append(1e3 * (time.perf_counter() - t1))
                    if ok:
                        fired.append((k, float(icp.calls[-1][2].fitness)))
            counts, seg_counts = dict(K.LAUNCHES), dict(SG.LAUNCHES)
    finally:
        if prev is None:
            os.environ.pop("LILI_OM_KNN_PRUNED", None)
        else:
            os.environ["LILI_OM_KNN_PRUNED"] = prev
    # the first keyframe after each closure, its rebuild flag and its
    # backend time (the backend stage records one sample per keyframe)
    backend = sys_.metrics.samples["backend"]
    rebuilds = []
    for k, _ in fired:
        after = [(i, s, rb) for i, (s, rb) in enumerate(fus.rebuild) if s > k]
        if after:
            i, s, rb = after[0]
            rebuilds.append((s, rb, 1e3 * backend[i]))
    n = len(sys_.kf_stamps)
    kf_err = keyframe_errors(sys_, traj, t0w, q0w)
    facts = {"metrics": sys_.metrics.report(),  # throughput read at the lap's end
             "fired": fired, "rebuilds": rebuilds, "lc_ms": lc_ms,
             "kf_rmse": float(torch.sqrt(torch.mean(kf_err ** 2))),
             "kf_max": float(kf_err.max()), "n_kf": n,
             "attempts": icp_attempts(icp.calls, sys_.lc_cfg, make_room_world(device=DEV),
                                      t0w, q0w)}
    return (sys_, host_ms, counts, rec.seen, facts, icp.calls,
            (seg_counts, seg.seen))


def save_icp_attempts(path, calls, lc_cfg):
    """Every closure attempt's submaps and ICP result (``IcpSpy.calls``), for
    a replay through the JAX reference (``python3 -m tools.replay_icp``)."""
    stack = lambda j: np.stack([c[1][j].cpu().numpy() for c in calls])
    np.savez_compressed(
        path, scan=np.array([c[0] for c in calls]), src=stack(0), src_mask=stack(1),
        tgt=stack(2), tgt_mask=stack(3), n_iters=lc_cfg.icp_iters, trim=lc_cfg.icp_trim,
        t=np.stack([c[2].t.cpu().numpy() for c in calls]),
        q=np.stack([c[2].q.cpu().numpy() for c in calls]),
        fitness=np.array([float(c[2].fitness) for c in calls]))


def surface_distance(world: World, pts):
    """Distance of each point (simulator frame) to the nearest surface of
    ``world``: its bounded planes and its capped cylinders."""
    w = World(*[x.to(pts.dtype) for x in world])
    d = pts[:, None, :] - w.plane_center[None]
    n = torch.sum(d * w.plane_normal, -1)
    du = torch.clamp(torch.sum(d * w.plane_u, -1).abs() - w.plane_half[:, 0], min=0.0)
    dv = torch.clamp(torch.sum(d * w.plane_v, -1).abs() - w.plane_half[:, 1], min=0.0)
    to_plane = torch.sqrt(n * n + du * du + dv * dv).amin(dim=1)
    c = pts[:, None, :] - w.cyl_base[None]
    a = torch.sum(c * w.cyl_axis, -1)
    dr = torch.linalg.norm(c - a[..., None] * w.cyl_axis, dim=-1) - w.cyl_radius
    da = torch.clamp(a.abs() - w.cyl_half_len, min=0.0)
    return torch.minimum(to_plane, torch.sqrt(dr * dr + da * da).amin(dim=1))


def icp_attempts(calls, lc, world, t0w, q0w):
    """Each closure attempt's ICP, read after the lap (untimed): the fitness
    the gate read (untrimmed when ``icp_trim`` is 1), the fitness trimmed to
    the best ``ICP_TRIM`` at the same final pose, the share of matched
    source points farther than ``FAR_M`` from the target, and the median and
    95th percentile distance of each submap's points to the world's
    surfaces (odometry frame → simulator frame by the first body pose)."""
    rows = []
    for scan, (src, sm, tgt, tm), res in calls:
        pw = quat_rotate(res.q[None], src) + res.t[None]
        d2 = K.knn(pw, tgt, k=1, q_mask=sm, p_mask=tm)[0][:, 0]
        d2 = torch.sort(d2[sm & (d2 < ICP_MAX_CORR_M ** 2)]).values
        n_keep = max(int(d2.numel() * ICP_TRIM), 1)
        row = {"scan": scan, "fitness": float(res.fitness),
               "trimmed": float(d2[:n_keep].mean()),
               "far_share": float((d2 > FAR_M ** 2).float().mean()),
               "n_src": int(sm.sum()), "n_tgt": int(tm.sum()),
               "t_icp": float(torch.linalg.norm(res.t)),
               "accepted": bool(float(res.fitness) <= lc.icp_thres)}
        for name, pts, m in (("src", src, sm), ("tgt", tgt, tm)):
            sim = quat_rotate(q0w[None], pts[m].double()) + t0w[None]
            dist = torch.sort(surface_distance(world, sim)).values
            row[f"{name}_surf_p50"] = float(dist[len(dist) // 2])
            row[f"{name}_surf_p95"] = float(dist[int(0.95 * (len(dist) - 1))])
        rows.append(row)
    return rows


def check_system(sys_, host_ms, counts, facts):
    lc = sys_.lc_cfg
    n_icp = len(sys_.metrics.samples.get("icp", []))
    site = lambda q, p, k: counts.get(("knn_pruned", q, p, k), 0)
    cap = lc.submap_cap
    timed = sorted(host_ms[N_WARM:])
    rep = facts["metrics"]
    print(f"[system] {len(host_ms)} scans, {facts['n_kf']} keyframes: per-scan host ms "
          f"median {timed[len(timed) // 2]:.3f} min {timed[0]:.3f} max {timed[-1]:.3f}; "
          f"closure attempts {len(facts['lc_ms'])} (ms {[round(x, 1) for x in facts['lc_ms']]})"
          f"; fired (scan, fitness) {facts['fired']}; "
          f"rejects {sys_.lc_rejects}; "
          f"loop factors {len(sys_._loop_pairs)} {sys_._loop_pairs}")
    print(f"[system] ICP ms per closure attempt "
          f"{[round(1e3 * x, 1) for x in sys_.metrics.samples.get('icp', [])]}; graph_solve ms "
          f"{[round(1e3 * x, 1) for x in sys_.metrics.samples.get('graph_solve', [])]}; "
          f"rebuild keyframes (scan, rebuild, backend ms) {facts['rebuilds']}; backend ms "
          f"median {rep['backend']['p50_ms']:.3f}")
    for a in facts["attempts"]:
        print(f"[system] ICP at scan {a['scan']}: fitness {a['fitness']:.5f} "
              f"({'accepted' if a['accepted'] else 'rejected'}), trimmed to {ICP_TRIM} "
              f"{a['trimmed']:.5f}; matched source points beyond {FAR_M} m "
              f"{100 * a['far_share']:.2f} %; |t_icp| {a['t_icp']:.4f} m; points "
              f"src {a['n_src']} tgt {a['n_tgt']}; distance to the world's surfaces "
              f"p50/p95 src {a['src_surf_p50']:.4f}/{a['src_surf_p95']:.4f} m tgt "
              f"{a['tgt_surf_p50']:.4f}/{a['tgt_surf_p95']:.4f} m")
    print(f"[system] graph keyframes vs simulator: RMSE {facts['kf_rmse']:.4f} m, max "
          f"{facts['kf_max']:.4f} m")
    print(f"[system] launches {sum(counts.values())} "
          f"{ {f'{w}:{q}x{p}:k{k}': c for (w, q, p, k), c in sorted(counts.items())} }")
    print("[system] stage metrics (a sync ends every stage):\n" + sys_.metrics.pretty())
    check(len(facts["fired"]) >= 1, f"system: no loop closure fired ({sys_.lc_rejects})")
    check(n_icp >= 1 and len(sys_.metrics.samples.get("graph_solve", [])) >= 1,
          "system: ICP or the graph solve did not run")
    check(len(sys_._loop_pairs) >= 1 and int(sys_.graph.n_loops) >= 1,
          "system: no loop factor in the graph")
    check(any(rb for _, rb, _ in facts["rebuilds"]),
          f"system: no keyframe after a closure ran with rebuild=True {facts['rebuilds']}")
    check(site(cap, cap, 5) == lc.icp_iters * n_icp and site(cap, cap, 1) == n_icp,
          f"system: ICP launches {site(cap, cap, 5)} (k=5) / {site(cap, cap, 1)} (k=1) for "
          f"{n_icp} ICP runs of {lc.icp_iters} iterations")
    # each ICP prepares its target once (one scatter) and orders its source
    # once (the keys of both clouds): every iteration is one search launch
    n_maps = counts.get(("pruned_scatter", 0, cap, 0), 0)
    n_keys = counts.get(("pruned_keys", 0, cap, 0), 0)
    print(f"[system] ICP map preparations {n_maps}, Morton key launches {n_keys} for "
          f"{n_icp} ICP runs")
    check(n_maps == n_icp and n_keys == 2 * n_icp,
          f"system: {n_maps} map preparations / {n_keys} key launches at the ICP site for "
          f"{n_icp} ICP runs (one map and one source order per run)")
    odo, fus = sys_.odo_cfg, sys_.fusion_cfg
    W = fus.window
    check(site(odo.query_cap, odo.map_cap, odo.k) >= len(host_ms),
          "system: the odometry site did not launch B3 on every scan")
    check(site(W * fus.kf_surf_cap, fus.map_surf_cap, fus.k) >= 1
          and site(W * fus.kf_edge_cap, fus.map_edge_cap, fus.k) >= 1,
          "system: a fusion site did not launch B3")
    check(all(K.launch_count(w) == 0 for w in ("knn_counted", "knn_dense", "knn_map")),
          "system: B1/B2 launched under LILI_OM_KNN_PRUNED=1")
    for t in sys_.trajectory:
        check(bool(np.all(np.isfinite(t))), "system: a pose is not finite")
    check(facts["kf_rmse"] < KF_RMSE_TOL_M,
          f"system: keyframe RMSE {facts['kf_rmse']:.4f} m against the simulator")
    for a in facts["attempts"]:
        check(max(a["src_surf_p50"], a["tgt_surf_p50"]) < SUBMAP_SURF_TOL_M,
              f"system: the submaps of the attempt at scan {a['scan']} lie off the world's "
              f"surfaces (median {a['src_surf_p50']:.3f} / {a['tgt_surf_p50']:.3f} m)")


def livox_phase():
    """Drive ``LiliOmSystem.process_scan_livox`` at the whole ``fr_iosb``
    preset over the golden lap with Horizon sweeps at full width (6 × 4000
    points, ``n_cols`` 4000), ``try_loop_closure`` every 10 scans and the
    time gate cut as in the spin system phase; ``LILI_OM_KNN_PRUNED`` unset.
    Returns (system, per-scan host ms, kNN counts, segment-sum counts,
    recorded B4 inputs, facts, recorded B1 inputs)."""
    cfg = load_config("fr_iosb")
    lc = dataclasses.replace(cfg.loop_closure, time_thres=SYS_LAP_S / 3.0)
    t0 = time.perf_counter()
    scans, imu, traj, radius, (t_sl, q_sl) = sim_lap(cfg, SYS_SCANS, livox=True)
    sync()
    print(f"[livox] preset fr_iosb, {SYS_SCANS} sweeps of {LIVOX_LINES}x{LIVOX_PTS} points "
          f"(n_cols {cfg.livox_features.n_cols}), lap {SYS_LAP_S:.1f} s radius {radius:.2f} m; "
          f"time_thres {cfg.loop_closure.time_thres} -> {lc.time_thres:.2f} s (local tier "
          f"{lc.local_time_thres}); capacities: local_map_width "
          f"{cfg.fusion.local_map_width}, map_surf_cap {cfg.fusion.map_surf_cap}, scan_cap "
          f"{cfg.odometry.scan_cap}; ICP gate icp_trim {lc.icp_trim} icp_thres {lc.icp_thres}; "
          f"sim {time.perf_counter() - t0:.2f} s")
    sys_ = LiliOmSystem(cfg.odometry, cfg.fusion, cfg.spin_features, cfg.livox_features, lc,
                        cfg.imu_noise, device=DEV)
    sys_.deskew_translation = True
    sys_.push_imu(imu.stamps.cpu().numpy(), imu.accs.cpu().numpy(), imu.gyrs.cpu().numpy())
    t0w, q0w = pose_at(traj, 0.0, device=DEV)
    fired, host_ms, lc_ms, odo = [], [], [], []
    prev = os.environ.pop("LILI_OM_KNN_PRUNED", None)
    try:
        with (SegRecorder(armed=False) as seg, IcpSpy() as icp,
              Recorder("knn_counted_cuda", armed=False) as rec):
            sync()
            reset_counts()
            for k, (pts, line, ratio, refl, valid) in enumerate(scans):
                seg.armed = rec.armed = k >= SYS_RECORD_FROM
                icp.scan = k
                t1 = time.perf_counter()
                out = sys_.process_scan_livox(pts, line, ratio, refl, valid, k * 0.1)
                sync()
                host_ms.append(1e3 * (time.perf_counter() - t1))
                odo.append((out.t.clone(), out.q.clone(), int(out.n_corr)))
                if k % LC_EVERY == 0 and k > 0:
                    t1 = time.perf_counter()
                    ok = sys_.try_loop_closure()
                    sync()
                    lc_ms.append(1e3 * (time.perf_counter() - t1))
                    if ok:
                        fired.append((k, float(icp.calls[-1][2].fitness)))
            counts, seg_counts = dict(K.LAUNCHES), dict(SG.LAUNCHES)
    finally:
        if prev is not None:
            os.environ["LILI_OM_KNN_PRUNED"] = prev
    n = len(sys_.kf_stamps)
    kf_err = keyframe_errors(sys_, traj, t0w, q0w)
    # the odometry against the simulated sensor poses: over the scans the
    # main path runs from rest (what GT_TOL_* bounds) and over the whole lap
    pose_fn = sensor_pose_fn(traj, t_sl, q_sl)
    et, er = gt_errors(odo[:N_WARM + N_TIMED], pose_fn)
    lap_et, lap_er = gt_errors(odo, pose_fn)
    corr = [c for _, _, c in odo]
    facts = {"metrics": sys_.metrics.report(), "fired": fired, "lc_ms": lc_ms,
             "kf_rmse": float(torch.sqrt(torch.mean(kf_err ** 2))),
             "kf_max": float(kf_err.max()), "n_kf": n, "odo_err_m": et, "odo_err_rad": er,
             "lap_odo_err_m": lap_et, "lap_odo_err_rad": lap_er,
             "acquired": float(np.mean([c > 0 for c in corr[2:]])), "n_corr": corr,
             "attempts": icp_attempts(icp.calls, sys_.lc_cfg, make_room_world(device=DEV),
                                      t0w, q0w)}
    return sys_, host_ms, counts, seg_counts, seg.seen, facts, rec.seen


def check_livox(sys_, host_ms, counts, seg_counts, facts):
    timed = sorted(host_ms[N_WARM:])
    rep = facts["metrics"]
    stage = lambda name: rep.get(name, {}).get("p50_ms", float("nan"))
    print(f"[livox] {len(host_ms)} sweeps, {facts['n_kf']} keyframes: per-scan host ms median "
          f"{timed[len(timed) // 2]:.3f} min {timed[0]:.3f} max {timed[-1]:.3f}; stage p50 ms "
          f"preprocess {stage('preprocess'):.3f} odometry {stage('odometry'):.3f} backend "
          f"{stage('backend'):.3f} (fusion {stage('fusion'):.3f}, densify "
          f"{stage('densify'):.3f}) icp {stage('icp'):.3f} graph_solve "
          f"{stage('graph_solve'):.3f}; scans/s over the lap "
          f"{rep.get('_throughput', {}).get('scans_per_sec', float('nan'))}")
    print(f"[livox] odometry vs simulated sensor poses: max {facts['odo_err_m']:.4f} m, "
          f"{facts['odo_err_rad']:.5f} rad over the first {N_WARM + N_TIMED} scans, "
          f"{facts['lap_odo_err_m']:.4f} m, {facts['lap_odo_err_rad']:.5f} rad over the lap; "
          f"graph keyframes vs simulator: RMSE "
          f"{facts['kf_rmse']:.4f} m, max {facts['kf_max']:.4f} m; scans with surf "
          f"correspondences after scan 2: {100 * facts['acquired']:.1f} %")
    print(f"[livox] closure attempts {len(facts['lc_ms'])} (ms "
          f"{[round(x, 1) for x in facts['lc_ms']]}); fired (scan, fitness) {facts['fired']}; "
          f"rejects {sys_.lc_rejects}; loop factors {len(sys_._loop_pairs)}")
    for a in facts["attempts"]:
        print(f"[livox] ICP at scan {a['scan']}: fitness {a['fitness']:.5f} "
              f"({'accepted' if a['accepted'] else 'rejected'}), trimmed to {ICP_TRIM} "
              f"{a['trimmed']:.5f}; matched source points beyond {FAR_M} m "
              f"{100 * a['far_share']:.2f} %; |t_icp| {a['t_icp']:.4f} m; points src "
              f"{a['n_src']} tgt {a['n_tgt']}; distance to the world's surfaces p50 src "
              f"{a['src_surf_p50']:.4f} tgt {a['tgt_surf_p50']:.4f} m")
    print(f"[livox] launches {sum(counts.values())} "
          f"{ {f'{w}:{q}x{p}:k{k}': c for (w, q, p, k), c in sorted(counts.items())} }; "
          f"segred {sum(seg_counts.values())}")
    print("[livox] stage metrics (a sync ends every stage):\n" + sys_.metrics.pretty())
    for t in sys_.trajectory:
        check(bool(np.all(np.isfinite(t))), "livox: a pose is not finite")
    check(facts["odo_err_m"] < GT_TOL_M and facts["odo_err_rad"] < GT_TOL_RAD,
          f"livox: odometry error {facts['odo_err_m']:.4f} m / {facts['odo_err_rad']:.5f} rad "
          f"against the simulated sensor poses over the first {N_WARM + N_TIMED} scans")
    check(facts["kf_rmse"] < KF_RMSE_TOL_M,
          f"livox: keyframe RMSE {facts['kf_rmse']:.4f} m against the simulator")
    check(facts["acquired"] >= ACQUIRED_MIN,
          f"livox: surf correspondences on only {100 * facts['acquired']:.1f} % of the scans")
    check(sum(c for (w, *_), c in counts.items() if w == "knn_counted") > 0,
          "livox: B1 did not launch")
    # each ICP prepares its target once, then launches one B1 search per
    # iteration and one for the fitness
    lc, n_icp = sys_.lc_cfg, len(sys_.metrics.samples.get("icp", []))
    cap = lc.submap_cap
    site = lambda w, q, p, k: counts.get((w, q, p, k), 0)
    print(f"[livox] ICP runs {n_icp}: map preparations {site('knn_map', 0, cap, 0)}, B1 "
          f"searches k=5 {site('knn_counted', cap, cap, 5)} k=1 {site('knn_counted', cap, cap, 1)}")
    check(n_icp >= 1 and site("knn_map", 0, cap, 0) == n_icp,
          f"livox: {site('knn_map', 0, cap, 0)} map preparations at the ICP site for {n_icp} "
          "ICP runs (one per run)")
    check(site("knn_counted", cap, cap, 5) == lc.icp_iters * n_icp
          and site("knn_counted", cap, cap, 1) == n_icp,
          f"livox: ICP launches {site('knn_counted', cap, cap, 5)} (k=5) / "
          f"{site('knn_counted', cap, cap, 1)} (k=1) for {n_icp} ICP runs of {lc.icp_iters} "
          "iterations")
    check(all(w != "knn_pruned" for (w, *_) in counts), "livox: B3 launched")
    check(sum(seg_counts.values()) > 0, "livox: B4 did not launch")


def livox_run():
    """Phase 7's lap and its checks in a process of its own, beside phase
    6's lap (:func:`start_child`): :func:`livox_phase`, then
    :func:`check_livox`. Returns what the kernel checks after both laps
    need: the configs, the rejects, the per-scan ms, the launch counts, the
    facts and the recorded B4 and B1 inputs."""
    lvx, ms, counts, seg_counts, seg_seen, facts, inputs = livox_phase()
    check_livox(lvx, ms, counts, seg_counts, facts)
    return {"odo_cfg": lvx.odo_cfg, "fusion_cfg": lvx.fusion_cfg, "lc_cfg": lvx.lc_cfg,
            "lc_rejects": lvx.lc_rejects, "host_ms": ms, "counts": counts,
            "seg_counts": seg_counts, "seg_seen": seg_seen, "facts": facts, "inputs": inputs}


class PlainSpy(Patch):
    """Counts the calls of one plain version (``K.knn``, ``K.knn_map_plain``,
    ``SG.segment_sum_sorted_plain``): on the card's path none may run."""

    def __init__(self, module, name: str):
        super().__init__(module, name)
        self.n = 0

    def __call__(self, *args, **kw):
        self.n += 1
        return self.orig(*args, **kw)


def counted(run):
    """``run()`` with every launch count set to 0 just before and read just
    after, and the plain versions' calls counted. Returns (its result, kNN
    counts, segment-sum counts, plain calls)."""
    with (PlainSpy(K, "knn") as p1, PlainSpy(K, "knn_map_plain") as p2,
          PlainSpy(SG, "segment_sum_sorted_plain") as p3):
        sync()
        reset_counts()
        out = run()
        sync()
        counts, seg_counts = dict(K.LAUNCHES), dict(SG.LAUNCHES)
    return out, counts, seg_counts, p1.n + p2.n + p3.n


class PlainDatasetWriter(DatasetWriter):
    """``DatasetWriter`` over the plain ``runtime/log.py`` writer, the
    native writer's plain version: the same records, to compare bytes."""

    def __init__(self, path: str):
        self._w = plain_log.LogWriter(path)


def file_digest(path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(1 << 24):
            h.update(chunk)
    return h.hexdigest()


def write_lap_log(path, scans, imu, plain_path=None):
    """The lap as a ``.lom`` through the port's ``DatasetWriter`` (the
    native log writer): the IMU first, then each sweep's returns (xyz, time
    in the sweep, ring as the line; reflectivity 0, which the spin path does
    not read). With ``plain_path``, the same records also through
    :class:`PlainDatasetWriter` there.

    ``organize_scan`` (the JAX format's binning, kept for parity) puts a
    return in column ``int(rel_time * n_cols)`` of float32 values. The
    simulator times each column's returns at exactly ``c / n_cols``, and
    where that float32 product rounds below ``c`` the return lands in the
    column before: holes in every ring, and no surf feature survives them
    (the extractor needs contiguous rows). So a time whose product
    rounds low is written a few float32 ulps later (at most 8, < 5e-8 s of
    the sweep), and every return comes back in its own column. Returns
    how many returns were moved and by at most how many ulps."""
    writers = [DatasetWriter(path)] + ([PlainDatasetWriter(plain_path)] if plain_path else [])
    for s, a, g in zip(*(x.cpu().numpy() for x in (imu.stamps, imu.accs, imu.gyrs))):
        for w in writers:
            w.write_imu(ImuRecord(float(s), a.astype(np.float32), g.astype(np.float32)))
    ring = np.broadcast_to(np.arange(SYS_RINGS, dtype=np.int32)[:, None], (SYS_RINGS, SYS_COLS))
    col = np.arange(SYS_COLS)[None, :]
    moved, ulps = 0, 0
    for k, (img, valid, rel) in enumerate(scans):
        v = valid.cpu().numpy()
        t = rel.cpu().numpy().astype(np.float32)
        moved += int(((t * SYS_COLS).astype(np.int64) < col)[v].sum())
        for step in range(8):
            low = (t * SYS_COLS).astype(np.int64) < col
            if not low.any():
                break
            t, ulps = np.where(low, np.nextafter(t, np.float32(1)), t), max(ulps, step + 1)
        check(bool(((t * SYS_COLS).astype(np.int64) == col)[v].all()),
              f"runtime: scan {k}'s times do not bin into their own columns")
        rec = ScanRecord(k * 0.1, img.cpu().numpy()[v].astype(np.float32), t[v],
                         np.zeros(int(v.sum()), np.float32), ring[v])
        for w in writers:
            w.write_scan(rec)
    for w in writers:
        w.close()
    return moved, ulps


def fusion_fields(fs) -> dict:
    """A fusion state as {dotted field: tensor}, the prior's square-root pair
    (J, r0) as JᵀJ and Jᵀr0 (the eigenvectors' signs are arbitrary)."""
    out = {}
    for name, v in fs._asdict().items():
        if hasattr(v, "_fields"):
            out.update({f"{name}.{k}": x for k, x in v._asdict().items()})
        else:
            out[name] = v
    J, r0 = out.pop("prior.J"), out.pop("prior.r0")
    out["prior.JtJ"], out["prior.Jtr0"] = J.T @ J, J.T @ r0
    return out


def run_gap(a, b):
    """How far system ``a``'s run lies from ``b``'s: (every trajectory entry
    and fusion-state field bit-equal, largest trajectory gap in m, largest
    window pose gap in m and rad)."""
    ta, tb = np.asarray(a.trajectory), np.asarray(b.trajectory)
    check(ta.shape == tb.shape, f"runtime: trajectories of {ta.shape} and {tb.shape}")
    fa, fb = fusion_fields(a.fusion_state), fusion_fields(b.fusion_state)
    equal = bool(np.array_equal(ta, tb)) and all(
        torch.equal(fa[k], fb[k]) for k in fa)
    dq = quat_mul(quat_conj(a.fusion_state.q), b.fusion_state.q)
    return (equal, float(np.abs(ta - tb).max()),
            float((a.fusion_state.t - b.fusion_state.t).abs().max()),
            float(2.0 * torch.linalg.norm(dq[:, 1:], dim=1).max()))


def check_gap(what, gap):
    equal, traj_m, win_m, win_rad = gap
    print(f"[runtime] {what}: {'bit-equal' if equal else 'NOT bit-equal'} (trajectory gap "
          f"{traj_m:.3e} m, fusion window {win_m:.3e} m / {win_rad:.3e} rad)")
    check(equal or (max(traj_m, win_m) < TRAJ_TOL_M and win_rad < TRAJ_TOL_RAD),
          f"runtime: {what} differ by {traj_m:.3e} / {win_m:.3e} m, {win_rad:.3e} rad")


def check_counts(phase, what, counts, seg_counts, plain):
    """One run's launch counts (``counted``'s, possibly from another
    process): B1 (with its map preparations) and B4 launched, B3 not (the
    switch unset), no plain version."""
    by = lambda w: sum(n for (name, *_), n in counts.items() if name == w)
    print(f"[{phase}] {what}: launches B1 {by('knn_counted')} (map preparations "
          f"{by('knn_map')}), B2 {by('knn_dense')}, B3 {by('knn_pruned')}, B4 "
          f"{sum(seg_counts.values())}; plain calls {plain}; "
          f"by site { {f'{w}:{q}x{p}:k{k}': n for (w, q, p, k), n in sorted(counts.items())} } "
          f"{ {f'{n}x{c}->{o}': m for (_, n, c, o), m in sorted(seg_counts.items())} }")
    check(by("knn_counted") > 0 and by("knn_map") > 0 and sum(seg_counts.values()) > 0,
          f"{phase}: {what} launched no B1 or no B4")
    check(by("knn_pruned") == 0, f"{phase}: {what} launched B3 with the switch unset")
    check(plain == 0, f"{phase}: {what} ran a plain version {plain} times")


def check_runtime_features(what, sys_):
    """Every keyframe of the run archived surf features: the replayed scans
    fed the extractor, not only the IMU (on the simulator's noise-free IMU
    a run without features still tracks the lap)."""
    n = [len(sys_._kf_cloud_np(i)) for i in range(len(sys_.kf_clouds))]
    print(f"[runtime] {what}: {len(n)} keyframes, surf features archived per keyframe "
          f"min {min(n, default=0)} median {int(np.median(n)) if n else 0}")
    check(len(n) > 0 and min(n) > 0, f"runtime: {what} archived keyframes without surf features")


def profile_runtime(label: str, run, wall_s: float):
    """A ``torch.profiler`` window over one more run of ``run``: the device
    busy share against the unprofiled ``wall_s``, and the CUDA runtime calls
    of every thread (count, host time, mean) from CUPTI."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        sync()
    events = prof.key_averages()
    dev_s = sum(e.self_device_time_total for e in events
                if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
    api = sorted((e for e in events if e.key.startswith(("cuda", "cu"))),
                 key=lambda e: -e.self_cpu_time_total)[:6]
    print(f"[runtime] profile, {label}: device busy {dev_s:.3f} s = "
          f"{100.0 * dev_s / wall_s:.2f} % of the unprofiled {wall_s:.3f} s; CUDA runtime "
          + "; ".join(f"{e.key} n={e.count} {e.self_cpu_time_total / 1e3:.1f} ms "
                      f"(mean {e.self_cpu_time_total / max(e.count, 1):.2f} us)" for e in api))
    return {"device_busy_s": dev_s, "wall_s": wall_s,
            "api": {e.key: [e.count, e.self_cpu_time_total / 1e3] for e in api}}


def child_run(_i: int, name: str, tmp: str, args: tuple):
    """``CHILD_RUNS[name](*args)`` in a spawned process on ``cuda:0``, the
    pruned switch unset: its standard output kept and saved with its
    facts to ``tmp/{name}.pt`` (written out here if it raises)."""
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)
    os.environ.pop("LILI_OM_KNN_PRUNED", None)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            facts = CHILD_RUNS[name](*args)
    except BaseException:
        sys.stdout.write(buf.getvalue())
        sys.stdout.flush()
        raise
    torch.save({"out": buf.getvalue(), "facts": facts}, os.path.join(tmp, f"{name}.pt"))


CHILDREN = []  # every start_child process context, stopped at the end


def start_child(name: str, tmp: str, *args):
    """:func:`child_run` of ``name`` spawned, beside what this process runs
    next; :func:`join_child` waits for it."""
    ctx = mp.spawn(child_run, args=(name, tmp, args), nprocs=1, join=False)
    CHILDREN.append(ctx)
    return ctx


def stop_child(ctx):
    for proc in ctx.processes:
        if proc.is_alive():
            proc.terminate()
            proc.join(10)


def join_child(ctx, name: str, tmp: str):
    """Waits at most ``MC_JOIN_S`` seconds for a :func:`start_child` run
    (stopping it then), prints its output and returns its facts; a run that
    raised raises here."""
    deadline = time.monotonic() + MC_JOIN_S
    try:
        while not ctx.join(timeout=1.0):
            check(time.monotonic() < deadline, f"{name}: the run ran over {MC_JOIN_S} s")
    finally:
        stop_child(ctx)
    got = torch.load(os.path.join(tmp, f"{name}.pt"), weights_only=False)
    sys.stdout.write(got["out"])
    return got["facts"]


def runtime_config():
    """The runtime phase's configuration: the ``fr_iosb_rot`` preset, the
    closures' time gate cut as in the system phase. Returns (cfg, lc)."""
    cfg = system_config()
    return cfg, dataclasses.replace(cfg.loop_closure, time_thres=SYS_LAP_S / 3.0)


def runtime_system(cfg, lc):
    """A fresh system of the runtime phase on the card."""
    s = LiliOmSystem(cfg.odometry, cfg.fusion, cfg.spin_features, cfg.livox_features, lc,
                     cfg.imu_noise, device=DEV)
    s.deskew_translation = True
    return s


def runtime_decode():
    return functools.partial(decode_spin, n_rings=SYS_RINGS, n_cols=SYS_COLS)


def run_pipelined(log, loop_period, overlap=True, n_scans=RT_SCANS):
    """``log`` through ``ShardedIngest`` (spawned decode processes) into a
    lossless ``PipelineRunner`` over its first ``n_scans`` scans, the IMU
    fed as it is read, closures every ``loop_period`` s of the wall clock.
    Returns (the system, the runner, the seconds, the metrics report)."""
    s = runtime_system(*runtime_config())
    runner = PipelineRunner(s, overlap=overlap, drop_when_full=False,
                            loop_period_s=loop_period, scan_period=0.1)
    check(isinstance(runner._seq, native.Sequencer)
          and isinstance(runner._imu_ring, native.Ring),
          f"runtime: the runner's sequencer {type(runner._seq).__name__} and IMU ring "
          f"{type(runner._imu_ring).__name__} are not the native ones")
    runner.start()
    ingest = ShardedIngest(runner, runtime_decode(), n_hosts=RT_INGEST_HOSTS, processes=True)
    t1 = time.perf_counter()
    runner.n_imu_fed = fed = 0
    try:
        for r in read_dataset(log):
            if isinstance(r, ImuRecord):
                runner.feed_imu(np.array([r.stamp]), r.acc[None], r.gyr[None])
                runner.n_imu_fed += 1
            elif fed < n_scans:
                ingest.feed_raw(r, r.stamp)
                fed += 1
        ingest.close()
    finally:
        runner.stop(drain=True)
    sync()
    return s, runner, time.perf_counter() - t1, s.metrics.report()


def runtime_closure_run(log: str):
    """The runtime phase's closure run, in a process of its own beside the
    phase's other runs: ``log`` through the overlapped runner with the loop
    thread on (every ``RT_LOOP_PERIOD_S`` s), the launch counts set to 0
    just before and read just after: every scan processed, at least one
    loop closed, the keyframe RMSE, the map exported by the native PCD
    writer with ``write_pcd``'s bytes, read back and on the world's
    surfaces. Returns its facts."""
    (lcs, lc_runner, lc_s, lc_rep), *c = counted(lambda: run_pipelined(log, RT_LOOP_PERIOD_S))
    check_counts("runtime", "closure run", *c)
    check_runtime_features("closure run", lcs)
    check(lc_runner.n_processed == RT_SCANS,
          f"runtime: the closure run took {lc_runner.n_processed} of {RT_SCANS} scans")
    traj, _ = lap_trajectory()
    t0w, q0w = pose_at(traj, 0.0, device=DEV)
    kf_err = keyframe_errors(lcs, traj, t0w, q0w)
    rmse = float(torch.sqrt(torch.mean(kf_err ** 2)))
    tmp = os.path.dirname(log)
    pcd, plain_pcd = os.path.join(tmp, "map.pcd"), os.path.join(tmp, "map_plain.pcd")
    n_map = lcs.export_map(pcd)
    write_pcd(plain_pcd, lcs.build_global_map())
    with open(pcd, "rb") as f, open(plain_pcd, "rb") as g:
        pcd_bytes, plain_bytes = f.read(), g.read()
    same = pcd_bytes == plain_bytes
    print(f"[runtime] exported map: {len(pcd_bytes)} bytes by the native writer, "
          f"{len(plain_bytes)} by write_pcd, {'equal' if same else 'DIFFERENT'}")
    check(same, "runtime: the native PCD differs from write_pcd's")
    pts = torch.as_tensor(read_pcd(pcd).copy(), dtype=torch.float64, device=DEV)
    check(pts.shape == (n_map, 3) and n_map > 0, f"runtime: the PCD holds {tuple(pts.shape)}")
    dist = torch.sort(surface_distance(make_room_world(device=DEV),
                                       quat_rotate(q0w[None], pts) + t0w[None])).values
    map_p50 = float(dist[len(dist) // 2])
    print(f"[runtime] closure run (in a process of its own): {lc_runner.n_processed} scans, "
          f"{len(lcs.kf_stamps)} keyframes, {lc_runner.loop_closures} closures (rejects "
          f"{lcs.lc_rejects}), keyframe RMSE {rmse:.4f} m (max {float(kf_err.max()):.4f}); "
          f"exported map {n_map} points, median distance to the world's surfaces "
          f"{map_p50:.4f} m")
    print("[runtime] closure run stage metrics:\n" + lcs.metrics.pretty())
    check(lc_runner.loop_closures >= 1 and int(lcs.graph.n_loops) >= 1,
          f"runtime: the loop thread closed {lc_runner.loop_closures} loops "
          f"({int(lcs.graph.n_loops)} loop factors; rejects {lcs.lc_rejects})")
    check(rmse <= KF_RMSE_TOL_M, f"runtime: keyframe RMSE {rmse:.4f} m")
    check(map_p50 <= SUBMAP_SURF_TOL_M, f"runtime: the map lies {map_p50:.4f} m off the world")
    return {"seconds": lc_s, "report": lc_rep, "closures": lc_runner.loop_closures,
            "lc_rejects": lcs.lc_rejects, "kf_rmse": rmse, "n_kf": len(lcs.kf_stamps),
            "map_points": n_map, "map_surf_p50": map_p50}


def runtime_phase(tmp: str, profile: bool = False):
    """The runtime entry points on the first ``RT_SCANS`` scans of the golden
    lap at the full ``fr_iosb_rot`` width, the pruned switch unset: the lap
    into a ``.lom`` (native writer; the plain writer's copy compared byte
    for byte); a direct run from ``read_dataset`` (a checkpoint after
    ``RT_SAVE_AT`` scans); the same log through ``ShardedIngest`` (spawned
    decode processes) into a serial ``PipelineRunner`` over the first
    ``RT_SAVE_AT`` scans and an overlapped one over as many, the loop thread off
    (the native sequencer and IMU ring); the
    checkpoint resumed in a fresh system; meanwhile, in a process of its
    own, the pipeline again with the loop thread on, and its map exported
    (:func:`runtime_closure_run`). Each run with the launch counts set to
    0 just before and read just after. With ``profile``, one more direct
    and one more pipeline run under the profiler."""
    cfg, lc = runtime_config()
    t0 = time.perf_counter()
    scans, imu, traj, _, _ = sim_lap(cfg, RT_SCANS)
    log, ckpt = os.path.join(tmp, "lap.lom"), os.path.join(tmp, "ckpt")
    plain_copy = os.path.join(tmp, "lap_plain.lom")
    t1 = time.perf_counter()
    moved, ulps = write_lap_log(log, scans, imu, plain_path=plain_copy)
    write_s = time.perf_counter() - t1
    del scans
    digests = [file_digest(log), file_digest(plain_copy)]
    print(f"[runtime] the lap's .lom by the native writer and by runtime/log.py's: "
          f"{os.path.getsize(log)} / {os.path.getsize(plain_copy)} bytes, sha256 "
          f"{digests[0][:16]} / {digests[1][:16]} ({write_s:.2f} s for both)")
    check(digests[0] == digests[1], "runtime: the native and the plain log writers differ")
    os.remove(plain_copy)
    closure_child = start_child("runtime_closure", tmp, log)
    print(f"[runtime] cuts: the first {RT_SCANS} scans of the system lap "
          f"({SYS_RINGS}x{SYS_COLS}, "
          f"{os.path.getsize(log) / 2 ** 20:.1f} MiB of log; {moved} returns' times moved by "
          f"at most {ulps} float32 ulps to bin into their own columns); time_thres "
          f"{lc.time_thres:.2f} s "
          f"as the system phase; checkpoint after {RT_SAVE_AT}; sim and log "
          f"{time.perf_counter() - t0:.2f} s")
    decode = runtime_decode()

    def direct():
        s, dec_ms, save_s = runtime_system(cfg, lc), [], 0.0
        t1 = time.perf_counter()
        for r in read_dataset(log):
            if isinstance(r, ImuRecord):
                s.push_imu(np.array([r.stamp]), r.acc[None], r.gyr[None])
                continue
            t2 = time.perf_counter()
            _, args = decode(r)
            dec_ms.append(1e3 * (time.perf_counter() - t2))
            s.process_scan(*args, r.stamp)
            if s.n_frames == RT_SAVE_AT:
                sync()
                t2 = time.perf_counter()
                save_system(ckpt, s)
                save_s = time.perf_counter() - t2
        sync()
        return s, time.perf_counter() - t1 - save_s, dec_ms, s.metrics.report()

    def check_native_runner(what, runner):
        print(f"[runtime] {what}: sequencer {type(runner._seq).__module__}."
              f"{type(runner._seq).__name__}, IMU ring {type(runner._imu_ring).__name__}; "
              f"{runner.n_imu_fed} IMU samples fed, {runner.n_imu_ring} through the ring, "
              f"{runner.n_imu_direct} pushed directly (ring full)")
        check(runner.n_imu_ring > 0
              and runner.n_imu_ring + runner.n_imu_direct == runner.n_imu_fed,
              f"runtime: {what}'s IMU ring carried {runner.n_imu_ring} of "
              f"{runner.n_imu_fed} samples")

    def resumed():
        s = runtime_system(cfg, lc)
        load_system(ckpt, s)
        recs = [r for r in read_dataset(log) if isinstance(r, ScanRecord)]
        for r in recs[RT_SAVE_AT:]:
            s.process_scan(*decode(r)[1], r.stamp)
        return s

    # run_dataset record's simulator, on the card: two 16×720 sweeps and
    # the IMU over 0.3 s (61 samples at 200 Hz)
    rec_log = os.path.join(tmp, "record.lom")
    t0 = time.perf_counter()
    record_synthetic(rec_log, n_frames=2, device=DEV)
    recs = list(read_dataset(rec_log))
    sweeps = [r for r in recs if isinstance(r, ScanRecord)]
    print(f"[runtime] record_synthetic on {DEV}: {len(recs) - len(sweeps)} IMU records, "
          f"sweeps of {[len(r.pts) for r in sweeps]} returns, {time.perf_counter() - t0:.2f} s")
    check(len(sweeps) == 2 and len(recs) == 2 + 61
          and all(0.9 * 16 * 720 < len(r.pts) <= 16 * 720 and np.isfinite(r.pts).all()
                  for r in sweeps), "runtime: record_synthetic on the card")
    (ref, direct_s, dec_ms, direct_rep), *c = counted(direct)
    check(ref.n_frames == RT_SCANS, f"runtime: the direct run took {ref.n_frames} scans")
    check_counts("runtime", "direct run", *c)
    check_runtime_features("direct run", ref)
    # the serial runner (run_bag's mode on the card) over the first
    # RT_SAVE_AT scans, against the direct run's checkpoint there
    (ser, ser_runner, ser_s, ser_rep), *c = counted(
        lambda: run_pipelined(log, 1e9, overlap=False, n_scans=RT_SAVE_AT))
    check_counts("runtime", "serial pipeline run", *c)
    check_native_runner("serial pipeline run", ser_runner)
    check(ser_runner.n_processed == RT_SAVE_AT and ser_runner.n_dropped == 0,
          f"runtime: the serial pipeline took {ser_runner.n_processed} scans, dropped "
          f"{ser_runner.n_dropped}")
    at_save = runtime_system(cfg, lc)
    load_system(ckpt, at_save)
    check_gap(f"serial pipeline run vs direct run at its checkpoint ({RT_SAVE_AT} scans)",
              run_gap(ser, at_save))
    # the overlapped runner over the same scans, against the same checkpoint
    (pipe, runner, pipe_s, pipe_rep), *c = counted(
        lambda: run_pipelined(log, 1e9, n_scans=RT_SAVE_AT))
    check_counts("runtime", "pipeline run", *c)
    check_native_runner("pipeline run", runner)
    check(runner.n_processed == RT_SAVE_AT and runner.n_dropped == 0,
          f"runtime: the pipeline took {runner.n_processed} scans, dropped {runner.n_dropped}")
    check_gap(f"pipeline run vs direct run at its checkpoint ({RT_SAVE_AT} scans)",
              run_gap(pipe, at_save))
    check_runtime_features("pipeline run", pipe)
    del ser, at_save
    res, *c = counted(resumed)
    check_counts("runtime", "resumed run", *c)
    check_gap(f"resumed after {RT_SAVE_AT} scans vs direct run", run_gap(res, ref))
    lc_facts = join_child(closure_child, "runtime_closure", tmp)
    # each report read when its run ended: scans/s from the first scan's
    # start to that run's end
    rep = {"direct": direct_rep, "serial_pipeline": ser_rep, "pipeline": pipe_rep,
           "closure": lc_facts["report"]}
    facts = {"direct_scans_per_s": RT_SCANS / direct_s,
             "pipeline_scans_per_s": RT_SAVE_AT / pipe_s,
             "serial_pipeline_scans_per_s": RT_SAVE_AT / ser_s,
             "imu_ring": {"fed": runner.n_imu_fed, "ring": runner.n_imu_ring,
                          "direct": runner.n_imu_direct},
             "closure_run_scans_per_s": RT_SCANS / lc_facts["seconds"],
             "frontend_scans_per_s": {k: v["_throughput"]["scans_per_sec"]
                                      for k, v in rep.items()},
             "backend_p50_ms": {k: v["backend"]["p50_ms"] for k, v in rep.items()},
             "odometry_p50_ms": {k: v["odometry"]["p50_ms"] for k, v in rep.items()},
             "decode_ms_median": float(np.median(dec_ms)), "closures": lc_facts["closures"],
             **{k: lc_facts[k] for k in ("lc_rejects", "kf_rmse", "n_kf", "map_points",
                                         "map_surf_p50")}}
    if profile:  # the soak's process may still run beside
        facts["profile"] = {
            "direct": profile_runtime("serial direct run", direct, direct_s),
            "pipeline": profile_runtime("overlapped pipeline run",
                                        lambda: run_pipelined(log, 1e9, n_scans=RT_SAVE_AT),
                                        pipe_s)}
    fr = facts["frontend_scans_per_s"]
    print(f"[runtime] scans/s over the whole replay (log reading and decoding included, "
          f"the decode pool's start too): serial direct {facts['direct_scans_per_s']:.3f}; "
          f"serial pipeline ({RT_SAVE_AT} scans) {facts['serial_pipeline_scans_per_s']:.3f}; "
          f"overlapped pipeline {facts['pipeline_scans_per_s']:.3f}; with the loop thread "
          f"{facts['closure_run_scans_per_s']:.3f} (in its own process, beside the others and "
          f"the soak). From the first scan to the run's end: "
          f"{fr['direct']:.3f} / {fr['serial_pipeline']:.3f} / {fr['pipeline']:.3f} / "
          f"{fr['closure']:.3f}")
    print(f"[runtime] backend p50 ms: direct {facts['backend_p50_ms']['direct']:.3f}, "
          f"serial pipeline {facts['backend_p50_ms']['serial_pipeline']:.3f}, "
          f"pipeline {facts['backend_p50_ms']['pipeline']:.3f}, closure run "
          f"{facts['backend_p50_ms']['closure']:.3f}; odometry p50 ms "
          f"{facts['odometry_p50_ms']['direct']:.3f} / {facts['odometry_p50_ms']['pipeline']:.3f} / "
          f"{facts['odometry_p50_ms']['closure']:.3f} (a sync ends every stage: in the "
          f"overlapped runs it also waits for the other threads' kernels); ingest decode "
          f"(organize_scan) ms median {facts['decode_ms_median']:.3f}")
    return facts


@timed_check
def compare_segred(phase, key, inputs, launches):
    """B4 at one call site: its ids non-decreasing; two launches bit-identical;
    equal to the plain version on a CPU copy, in float32 and in float64;
    its times beside the plain version's, ``zeros().index_add_`` (atomics)
    and the bound (the bytes: payload and ids read once, output written
    once, at 3.35 TB/s)."""
    outer, inner, N, C, M = key
    pay, ids = inputs
    site = f"{phase}:{outer}>{inner}:{N}x{C}->{M}"
    check(bool((ids[1:] >= ids[:-1]).all()), f"B4 {site}: segment ids not non-decreasing")
    a = SG.segment_sum_sorted_cuda(pay, ids, M)
    b = SG.segment_sum_sorted_cuda(pay, ids, M)
    a64 = SG.segment_sum_sorted_cuda(pay.double(), ids, M)
    sync()
    ref = SG.segment_sum_sorted_plain(pay.cpu(), ids.cpu(), M)
    err = float((a.cpu() - ref).abs().max()) if ref.numel() else 0.0
    check(bool(torch.equal(a, b)), f"B4 {site}: two launches differ")
    check(bool(torch.equal(a.cpu(), ref)),
          f"B4 {site}: differs from the plain version on a CPU copy (max {err:.3e})")
    check(bool(torch.equal(a64.cpu(), SG.segment_sum_sorted_plain(pay.double().cpu(),
                                                                   ids.cpu(), M))),
          f"B4 {site}: float64 differs from the plain version on a CPU copy")
    out = torch.empty((M, C), dtype=pay.dtype, device=pay.device)
    ids_c = torch.clamp(ids, max=M)
    ms = cuda_ms(lambda: SG.segment_sum_sorted_cuda(pay, ids, M), 50)
    kernel_ms = cuda_ms(lambda: SG.launch_kernel(pay, ids, M, out), 50)
    plain_ms = cuda_ms(lambda: SG.segment_sum_sorted_plain(pay, ids, M), 50)
    lib_ms = cuda_ms(lambda: torch.zeros((M + 1, C), dtype=pay.dtype,
                                         device=pay.device).index_add_(0, ids_c, pay), 50)
    es = pay.element_size()
    t_bytes = (N * C * es + N * 8 + M * C * es) / PEAK_BYTES
    t_ops = N * C / PEAK_F32_FLOPS
    bound_ms = 1e3 * max(t_bytes, t_ops)
    kept = ids[ids < M]
    longest = int(torch.bincount(kept).max()) if kept.numel() else 0
    print(f"[kernel] B4 {site}: rows kept {kept.numel()}/{N}, longest segment {longest}; "
          f"max|Δ| {err:.3e}; wrapper {ms:.4f} ms kernel {kernel_ms:.4f} ms plain "
          f"{plain_ms:.4f} ms index_add_ {lib_ms:.4f} ms bound {bound_ms:.5f} ms; launches "
          f"of this shape in the phase {launches}")
    return {"name": f"segred[{site}]", "route": "cuda", "source": SOURCE_SEGRED,
            "replaces": REPLACES["segred"], "launches": launches, "max_abs_err": err,
            "ms": ms, "kernel_only_ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms, "library": "zeros(num_out + 1).index_add_ (atomics)",
            "shape": [N, C, M], "rows_kept": int(kept.numel()), "longest_segment": longest}


def map_points(pmap):
    """The raw map (points, mask) a ``K.PrunedMap`` was prepared from: its
    sorted rows put back at their original indices."""
    n = pmap.n_points
    rows = pmap.p_idx[:n].long()
    pts = torch.empty((n, 3), dtype=pmap.pts4.dtype, device=pmap.pts4.device)
    pts[rows] = pmap.pts4[:n, :3]
    mask = torch.empty((n,), dtype=torch.bool, device=pts.device)
    mask[rows] = pmap.pts4[:n, 3] == 0.0
    return pts.contiguous(), mask


@timed_check
def compare_pruned(site, inputs, k, launches):
    """B3 against the plain version and against B1 on the same inputs (all
    equal bit for bit), through the per-call route (map and query order
    prepared in the call) and the prepared route (as ICP calls it: the map
    prepared once, the source's order given); its visits per block against
    the plain schedule's on the same map and order; the share of (block,
    tile) pairs it skipped; its times as the site calls it and by the other
    route, the kernel alone, the map preparation, B1, the plain version,
    cdist+topk and the bound."""
    q, pts, pm, qm, q_order = inputs
    prepared = isinstance(pts, K.PrunedMap)
    p, pm = map_points(pts) if prepared else (pts, pm)
    fresh = K.pruned_map(p, pm)
    for a, b in zip(fresh[:5], K.pruned_map_plain(p, pm)[:5]):
        check(bool(torch.equal(a, b)), f"B3 {site}: the prepared map differs from its plain "
                                       "version")
    if prepared:
        for a, b in zip(pts[:5], fresh[:5]):
            check(bool(torch.equal(a, b)), f"B3 {site}: the recorded map differs from a fresh one")
        pmap, order = pts, q_order
    else:
        pmap, order = fresh, K.query_order(q, qm)
        check(bool(torch.equal(order, K.morton_order_plain(q, qm))),
              f"B3 {site}: the query order differs from its plain version")
    d_k, i_k = K.knn_pruned_cuda(q, p, k, pm, qm)
    d_r, i_r = K.knn_pruned_cuda(q, pmap, k, q_mask=qm, q_order=order)
    d_p, i_p = K.knn(q, p, k=k, q_mask=qm, p_mask=pm)
    d_1, i_1 = K.knn_counted_cuda(q, p, k, pm, qm)
    sync()
    fin = torch.isfinite(d_p)
    err = max(float((d[fin] - d_p[fin]).abs().max()) if bool(fin.any()) else 0.0
              for d in (d_k, d_r))
    for route, d, i in (("per-call", d_k, i_k), ("prepared", d_r, i_r)):
        check(bool(torch.equal(d, d_p)) and bool(torch.equal(i, i_p)),
              f"B3 {site} ({route} route): differs from the plain version (max {err:.3e}, "
              f"{int((i != i_p).sum())} indices)")
        check(bool(torch.equal(d, d_1)) and bool(torch.equal(i, i_1)),
              f"B3 {site} ({route} route): differs from B1")
    _, _, visited = K.launch_pruned_kernel(q, pmap, qm, order, k)
    _, _, visited_plain = K.knn_pruned_schedule(q, pmap, k, q_mask=qm, q_order=order)
    sync()
    check(bool(torch.equal(visited, visited_plain)),
          f"B3 {site}: tiles scanned per block differ from the plain schedule's "
          f"({int(visited.sum())} vs {int(visited_plain.sum())})")
    skipped = K.pruned_skipped_share(visited, pmap)
    pairs = scanned_pairs(q, pmap, qm, order, visited)
    raw_ms = cuda_ms(lambda: K.knn_pruned_cuda(q, p, k, pm, qm), 20)
    prep_ms = cuda_ms(lambda: K.knn_pruned_cuda(q, pmap, k, q_mask=qm, q_order=order), 20)
    kernel_ms = cuda_ms(lambda: K.launch_pruned_kernel(q, pmap, qm, order, k), 20)
    map_ms = cuda_ms(lambda: K.pruned_map(p, pm), 20)
    order_ms = cuda_ms(lambda: K.query_order(q, qm), 20)
    b1_ms = cuda_ms(lambda: K.knn_counted_cuda(q, p, k, pm, qm), 20)
    plain_ms = cuda_ms(lambda: K.knn(q, p, k=k, q_mask=qm, p_mask=pm), 5)
    lib_ms = cuda_ms(lambda: library_knn(q, p, k, pm, qm), 5)
    ms = prep_ms if prepared else raw_ms
    Q, P = q.shape[0], p.shape[0]
    nq = Q if qm is None else int(qm.sum())
    np_ = P if pm is None else int(pm.sum())
    # the walk ends early, so the bound counts the pairs this run's data
    # needed: those of the tiles the kernel scanned
    t_ops = FLOP_PER_PAIR * pairs / PEAK_F32_FLOPS
    t_bytes = (12 * Q + 12 * P + (0 if qm is None else Q) + (0 if pm is None else P)
               + Q * k * (4 + 8)) / PEAK_BYTES
    bound_ms = 1e3 * max(t_ops, t_bytes)
    active = visited[visited > 0].float()
    active_plain = visited_plain[visited_plain > 0].float()
    vis = lambda v: (float(v.mean()) if v.numel() else 0.0, int(v.max()) if v.numel() else 0)
    print(f"[kernel] B3 {site}: valid q {nq}/{Q} p {np_}/{P}; skipped {100 * skipped:.1f} % "
          f"of (block, tile) pairs; tiles scanned per active block mean/max "
          f"{vis(active)[0]:.2f}/{vis(active)[1]} (plain schedule "
          f"{vis(active_plain)[0]:.2f}/{vis(active_plain)[1]}) of {pmap.tile_any.shape[0]}; "
          f"(valid query, valid point) pairs scanned {pairs} of {nq * np_}; as called "
          f"({'prepared' if prepared else 'per-call'} route) {ms:.4f} ms; per-call route "
          f"{raw_ms:.4f} ms; prepared route {prep_ms:.4f} ms; kernel {kernel_ms:.4f} ms; map "
          f"preparation {map_ms:.4f} ms; query order {order_ms:.4f} ms; B1 {b1_ms:.4f} ms; "
          f"plain {plain_ms:.4f} ms; cdist+topk {lib_ms:.4f} ms; bound {bound_ms:.5f} ms; "
          f"launches in the system phase {launches}")
    return {"name": f"knn_pruned[{site}]", "route": "cuda", "source": SOURCE_PRUNED,
            "replaces": REPLACES["knn_pruned"], "launches": launches, "max_abs_err": err,
            "ms": ms, "kernel_only_ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib_ms, "as_called": "prepared" if prepared else "per-call",
            "per_call_route_ms": raw_ms, "prepared_route_ms": prep_ms, "map_ms": map_ms,
            "query_order_ms": order_ms, "b1_ms": b1_ms, "skipped_share": skipped,
            "visited_mean": vis(active)[0], "visited_max": vis(active)[1],
            "visited_plain_mean": vis(active_plain)[0], "visited_plain_max": vis(active_plain)[1],
            "pairs_scanned": pairs, "shape": [Q, P], "valid": [nq, np_]}


@timed_check
def compare_pruned_map(what, pts, mask, launches, scatter_launches=None):
    """B3's map kernels on one cloud: the Morton keys kernel, and for a map
    (``scatter_launches`` given) the whole preparation with its scatter
    kernel, each against its plain version (equal bit for bit), with its
    times and its byte bound. Returns the JSON rows."""
    n, dev = pts.shape[0], pts.device
    keys = K.morton_keys_cuda(pts, mask)
    keys_plain = K.morton_keys_plain(pts, mask)
    sync()
    check(bool(torch.equal(keys, keys_plain)), f"B3 keys {what}: differ from the plain version "
                                               f"at {int((keys != keys_plain).sum())} rows")
    out = torch.empty_like(keys)
    rows = []
    ms = cuda_ms(lambda: K.morton_keys_cuda(pts, mask), 20)
    kernel_ms = cuda_ms(lambda: K.launch_keys_kernel(pts, mask, out), 20)
    plain_ms = cuda_ms(lambda: K.morton_keys_plain(pts, mask), 20)
    # bytes: the points and the mask read once, the keys written; 6 f32
    # operations a row
    t_bytes = (12 * n + (0 if mask is None else n) + 8 * n) / PEAK_BYTES
    t_ops = 6 * n / PEAK_F32_FLOPS
    print(f"[kernel] B3 keys {what}: {n} rows; wrapper {ms:.4f} ms kernel {kernel_ms:.4f} ms "
          f"plain {plain_ms:.4f} ms bound {1e3 * max(t_bytes, t_ops):.5f} ms; launches of this "
          f"shape in the system phase {launches}")
    rows.append({"name": f"pruned_keys[{what}]", "route": "cuda", "source": SOURCE_PRUNED,
                 "replaces": REPLACES["pruned_keys"],
                 "launches": launches, "max_abs_err": 0.0, "ms": ms,
                 "kernel_only_ms": kernel_ms, "plain_ms": plain_ms,
                 "bound_ms": 1e3 * max(t_bytes, t_ops),
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                 "library_ms": None, "shape": [n]})
    if scatter_launches is None:
        return rows
    pmap = K.pruned_map_cuda(pts, mask)
    sync()
    for a, b in zip(pmap[:5], K.pruned_map_plain(pts, mask)[:5]):
        check(bool(torch.equal(a, b)), f"B3 scatter {what}: the map differs from its plain "
                                       "version")
    order = torch.sort(keys).values
    ms = cuda_ms(lambda: K.pruned_map_cuda(pts, mask), 20)
    kernel_ms = cuda_ms(lambda: K.launch_scatter_kernel(pts, order, pmap), 20)
    plain_ms = cuda_ms(lambda: K.pruned_map_plain(pts, mask), 20)
    nj = pmap.tile_any.shape[0]
    # bytes: sorted keys and points read, float4 rows, indices and boxes
    # written; one compare a coordinate for the boxes
    t_bytes = (8 * n + 12 * n + 20 * nj * pmap.tile + 25 * nj) / PEAK_BYTES
    t_ops = 6 * n / PEAK_F32_FLOPS
    print(f"[kernel] B3 scatter {what}: {n} rows into {nj} tiles; map preparation (keys, sort, "
          f"scatter) {ms:.4f} ms; scatter kernel {kernel_ms:.4f} ms; plain preparation "
          f"{plain_ms:.4f} ms; bound {1e3 * max(t_bytes, t_ops):.5f} ms; launches of this shape "
          f"in the system phase {scatter_launches}")
    rows.append({"name": f"pruned_scatter[{what}]", "route": "cuda", "source": SOURCE_PRUNED,
                 "replaces": REPLACES["pruned_scatter"],
                 "launches": scatter_launches, "max_abs_err": 0.0, "ms": ms,
                 "kernel_only_ms": kernel_ms, "plain_ms": plain_ms,
                 "bound_ms": 1e3 * max(t_bytes, t_ops),
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                 "library_ms": None, "shape": [n, nj]})
    return rows


def scanned_pairs(q, pmap, q_mask, q_order, visited) -> int:
    """(valid query, valid map point) pairs the pruned kernel compared: block
    b scanned the first ``visited[b]`` tiles of its order."""
    plan = K.pruned_plan(q, pmap, q_mask, q_order)
    nj = pmap.tile_any.shape[0]
    nq_block = plan.ok.sum(dim=1)
    np_tile = (pmap.pts4[:, 3] == 0.0).reshape(nj, pmap.tile).sum(dim=1)
    scanned = torch.arange(nj, device=visited.device)[None, :] < visited[:, None].long()
    per_block = torch.where(scanned, np_tile[plan.order], 0).sum(dim=1)
    return int((nq_block * per_block).sum())


def profile_frames(frame: Frame, scans, wall_ms: float):
    """Stage times (host clock, a sync after each stage), then a profiler
    window: device time and device operations per frame; the device busy
    share is taken against the unprofiled per-scan time ``wall_ms``."""
    from torch.profiler import ProfilerActivity, profile

    stages = {}
    for s in scans:
        sync()
        last = [time.perf_counter()]

        def mark(name):
            sync()
            now = time.perf_counter()
            stages.setdefault(name, []).append(1e3 * (now - last[0]))
            last[0] = now

        frame.step(s, on_stage=mark)
    print("[stages] median ms: " + ", ".join(
        f"{n} {sorted(v)[len(v) // 2]:.3f}" for n, v in stages.items()))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for s in scans:
            frame.step(s)
        sync()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / len(scans)
    n_ops = sum(e.count for e in kernels) / len(scans)
    print(f"[profile] per frame: device time {dev_ms:.3f} ms, {n_ops:.0f} device "
          f"operations; device busy {100.0 * dev_ms / wall_ms:.2f} % of the "
          f"unprofiled {wall_ms:.3f} ms per scan")
    print(events.table(sort_by="self_device_time_total", row_limit=25))


class GatherSpy(Patch):
    """Wraps the ``all_gather_cat`` of a sharded fusion ``module`` (the
    map-sharded one by default; one call per keyframe): the bytes this rank
    sends, and each call's time by CUDA events and by the host clock (the
    card synchronized before and after)."""

    def __init__(self, module=map_fusion_mod):
        super().__init__(module, "all_gather_cat")
        self.bytes, self.event_ms, self.host_ms = [], [], []

    def __call__(self, mesh, x, dim=0, **kw):
        sync()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        out = self.orig(mesh, x, dim, **kw)
        b.record()
        b.synchronize()
        self.host_ms.append(1e3 * (time.perf_counter() - t0))
        self.event_ms.append(a.elapsed_time(b))
        self.bytes.append(x.numel() * x.element_size())
        return out


def mesh_sites(cfg, n: int):
    """{(Q, P): call site} of the B1 searches of an ``n``-rank mesh system,
    and the (N, C, num_out) of its two map-shard builds (B4)."""
    odo, fus = cfg.odometry, cfg.fusion
    W, Mp = fus.window, fus.local_map_width + (-fus.local_map_width) % n
    rnd = lambda x: -(-x // n) * n  # noqa: E731
    scap, ecap = rnd(fus.map_surf_cap) // n, rnd(fus.map_edge_cap) // n
    knn = {(odo.query_cap // n, odo.map_cap): "odometry",
           (W * fus.kf_surf_cap, scap): "fusion_surf", (W * fus.kf_edge_cap, ecap): "fusion_edge"}
    seg = {(Mp // n * fus.kf_surf_cap, 5, scap): "map_shard_surf",
           (Mp // n * fus.kf_edge_cap, 4, ecap): "map_shard_edge"}
    return knn, seg


def mesh_lap(mesh, scans, imu, cfg, lc, record: bool = True):
    """``LiliOmSystem(mesh=mesh)`` (or the single-card system for ``mesh``
    None) over the lap at the whole preset, ``try_loop_closure`` every
    ``LC_EVERY`` scans, with every launch count set to 0 just before and read
    just after, and the plain versions' calls counted. With ``record``, the
    inputs of each B1 site's first call and of its first call from scan
    ``MC_RECORD_FROM`` on, and of each B4 site from then on, are copied, and
    the fusion's gathers timed. Returns the run's facts (host copies)."""
    sys_ = LiliOmSystem(cfg.odometry, cfg.fusion, cfg.spin_features, cfg.livox_features, lc,
                        cfg.imu_noise, mesh=mesh, device=None if mesh is not None else DEV)
    sys_.deskew_translation = True
    sys_.push_imu(imu.stamps.cpu().numpy(), imu.accs.cpu().numpy(), imu.gyrs.cpu().numpy())
    host_ms, fired, digest_at = [], [], None
    with (Recorder("knn_counted_cuda", armed=record) as first,
          Recorder("knn_counted_cuda", armed=False) as grown,
          SegRecorder(armed=False) as seg, GatherSpy() as gather,
          PlainSpy(K, "knn") as p1, PlainSpy(K, "knn_map_plain") as p2,
          PlainSpy(SG, "segment_sum_sorted_plain") as p3):
        sync()
        reset_counts()
        for k, (img, valid, rel) in enumerate(scans):
            grown.armed = seg.armed = record and k >= MC_RECORD_FROM
            first.armed = record and k < MC_RECORD_FROM
            t1 = time.perf_counter()
            sys_.process_scan(img, valid, rel, k * 0.1)
            sync()
            host_ms.append(1e3 * (time.perf_counter() - t1))
            if k % LC_EVERY == 0 and k > 0 and sys_.try_loop_closure():
                fired.append(k)
            if mesh is not None and k == MC_RUNNER_SCANS - 1:
                digest_at = sys_.replicated_digest()
        sync()
        counts, seg_counts = dict(K.LAUNCHES), dict(SG.LAUNCHES)
    n_kf = len(sys_.kf_stamps)
    cpu = lambda v: tuple(x.cpu() if isinstance(x, torch.Tensor) else x for x in v)  # noqa: E731
    facts = {"host_ms": host_ms, "fired": fired, "counts": counts, "seg_counts": seg_counts,
             "plain_calls": p1.n + p2.n + p3.n,
             "backend_p50_ms": sys_.metrics.report()["backend"]["p50_ms"],
             "trajectory": np.asarray(sys_.trajectory), "kf_stamps": list(sys_.kf_stamps),
             "graph_t": sys_.graph.t[:n_kf].cpu(), "n_loops": int(sys_.graph.n_loops),
             "lc_rejects": dict(sys_.lc_rejects),
             "first": {k: cpu(v) for k, v in first.seen.items()
                       if not isinstance(v[1], K.KnnMap)},
             "grown": {k: cpu(v) for k, v in grown.seen.items()
                       if not isinstance(v[1], K.KnnMap)},
             "seg": {k: cpu(v) for k, v in seg.seen.items()},
             "gather": (gather.bytes, gather.event_ms, gather.host_ms),
             "configs": (sys_.odo_cfg._asdict(), sys_.fusion_cfg._asdict())}
    if mesh is not None:
        facts["replicated"] = sys_.check_replicated()
        facts["digest"] = sys_.replicated_digest()
        facts["digest_at_runner_scans"] = digest_at
    return facts


def mesh_runner(mesh, scans, imu, cfg, lc, overlap: bool, record: bool = False):
    """(d): ``PipelineRunner`` over ``LiliOmSystem(mesh=mesh)`` at the whole
    preset, lossless: the lap's IMU fed up front, then host copies of its
    first ``MC_RUNNER_SCANS`` scans in order, a closure attempt every
    ``LC_EVERY`` scans (``loop_period_s`` = ``LC_EVERY`` · 0.1 s), serial or
    overlapped, with every launch count set to 0 just before and read just
    after and the plain versions' calls counted. With ``record`` (serial
    runs), the inputs of each B1 and B4 site's first call from scan
    ``MC_RECORD_FROM`` on are copied. Returns the run's facts (host
    copies)."""
    sys_ = LiliOmSystem(cfg.odometry, cfg.fusion, cfg.spin_features, cfg.livox_features, lc,
                        cfg.imu_noise, mesh=mesh)
    sys_.deskew_translation = True
    host_scans = [tuple(x.cpu().numpy() for x in s) for s in scans[:MC_RUNNER_SCANS]]
    imu_np = [x.cpu().numpy() for x in (imu.stamps, imu.accs, imu.gyrs)]
    runner = PipelineRunner(sys_, overlap=overlap, drop_when_full=False,
                            loop_period_s=LC_EVERY * 0.1, scan_period=0.1)
    with (Recorder("knn_counted_cuda", armed=False) as grown, SegRecorder(armed=False) as seg,
          PlainSpy(K, "knn") as p1, PlainSpy(K, "knn_map_plain") as p2,
          PlainSpy(SG, "segment_sum_sorted_plain") as p3):
        sync()
        reset_counts()
        t0 = time.perf_counter()
        runner.feed_imu(*imu_np)
        runner.start()
        try:
            for k, (img, valid, rel) in enumerate(host_scans):
                if record and k == MC_RECORD_FROM:
                    # the feed runs ahead of the workers: arm once the
                    # runner has processed every scan before this one
                    while runner.n_processed < k and runner.error is None:
                        time.sleep(0.002)
                    grown.armed = seg.armed = True
                runner.feed_scan(img, valid, rel, k * 0.1)
        finally:
            runner.stop(drain=True)
        sync()
        secs = time.perf_counter() - t0
        counts, seg_counts = dict(K.LAUNCHES), dict(SG.LAUNCHES)
    n_kf = len(sys_.kf_stamps)
    cpu = lambda v: tuple(x.cpu() if isinstance(x, torch.Tensor) else x for x in v)  # noqa: E731
    return {"overlap": overlap, "scans_per_s": len(host_scans) / secs,
            "n_processed": runner.n_processed, "fired": list(runner.fired_at),
            "replicated": runner.replicated, "digest": sys_.replicated_digest(),
            "backend_p50_ms": sys_.metrics.report()["backend"]["p50_ms"],
            "kf_stamps": list(sys_.kf_stamps), "graph_t": sys_.graph.t[:n_kf].cpu(),
            "n_loops": int(sys_.graph.n_loops), "lc_rejects": dict(sys_.lc_rejects),
            "counts": counts, "seg_counts": seg_counts, "plain_calls": p1.n + p2.n + p3.n,
            "grown": {k: cpu(v) for k, v in grown.seen.items()
                      if not isinstance(v[1], K.KnnMap)},
            "seg": {k: cpu(v) for k, v in seg.seen.items()}}


def dist_steps(mesh, rec):
    """The query-sharded step for each warm-up flag, from a replay record's
    config and IMU noise."""
    _, fcfg, noise = rec["first"]
    steps = {w: make_distributed_fusion(mesh, fcfg, noise, warmup=w)[0] for w in (True, False)}
    return steps.__getitem__


def single_steps(rec):
    """``fusion_step`` on the card for each warm-up flag."""
    _, fcfg, noise = rec["first"]
    return lambda w: functools.partial(fusion_step, cfg=fcfg, noise=noise, warmup=w, device=DEV)


def fusion_replay(step_for, rec, record: bool = False):
    """The recorded keyframes (``FusionSpy(record=True)``) through
    ``step_for(warmup)`` from the recorded first state, without the
    closures' ring corrections and with the pruned switch unset, every
    launch count set to 0 just before and read just after, the plain
    versions' calls counted, each step synchronized and timed. With
    ``record``, B1's inputs at its first call of each site and at its first
    from keyframe ``MC_DIST_RECORD_FROM`` on are copied, and B4's at its
    first call of each site from that keyframe on. Returns the run's facts
    (host copies)."""
    state0, _, _ = rec["first"]
    st, outs, ms = tree_to(state0, DEV), [], []
    with (Recorder("knn_counted_cuda", armed=record) as first,
          Recorder("knn_counted_cuda", armed=False) as grown,
          SegRecorder(armed=False) as seg, GatherSpy(dist_fusion_mod) as gather,
          PlainSpy(K, "knn") as p1, PlainSpy(K, "knn_map_plain") as p2,
          PlainSpy(SG, "segment_sum_sorted_plain") as p3):
        sync()
        reset_counts()
        for k, (args, warm) in enumerate(rec["inputs"]):
            grown.armed = seg.armed = record and k >= MC_DIST_RECORD_FROM
            args = [a.to(DEV) for a in args]
            t1 = time.perf_counter()
            st, o = step_for(warm)(st, *args)
            sync()
            ms.append(1e3 * (time.perf_counter() - t1))
            outs.append(tuple(x.cpu() for x in (o.t_latest, o.q_latest, o.n_surf_corr,
                                                 o.n_edge_corr)))
        sync()
        counts, seg_counts = dict(K.LAUNCHES), dict(SG.LAUNCHES)
    return {"state": tree_to(st, "cpu"), "outs": outs, "ms": ms, "counts": counts,
            "seg_counts": seg_counts, "plain_calls": p1.n + p2.n + p3.n,
            "gather": (gather.bytes, gather.event_ms, gather.host_ms),
            "first": host_tree({k: v for k, v in first.seen.items()
                                if not isinstance(v[1], K.KnnMap)}),
            "grown": host_tree({k: v for k, v in grown.seen.items()
                                if not isinstance(v[1], K.KnnMap)}),
            "seg": host_tree(seg.seen)}


def multichip_rank(rank: int, n: int, tmp: str):
    """One rank of the multichip phase's gloo world on ``cuda:0``: the lap
    through ``mesh_lap``, then ``sharded_knn`` on the check's map (B1 on this
    rank's block, its input recorded, the counts set to 0 just before and
    read just after), then (c) the recorded keyframes through the
    query-sharded fusion (``fusion_replay``); its facts to
    ``tmp/rank{rank}.pt``."""
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/gloo_rendezvous",
                            world_size=n, rank=rank)
    try:
        mesh = make_mesh(n, axis="kf")
        data = torch.load(os.path.join(tmp, "lap.pt"), weights_only=False)
        scans = [tuple(x.to(DEV) for x in s) for s in data["scans"]]
        imu = data["imu"]
        facts = mesh_lap(mesh, scans, imu, data["cfg"], data["lc"])
        facts["runner"] = [mesh_runner(mesh, scans, imu, data["cfg"], data["lc"], overlap=o)
                           for o in (False, True)]
        q, p, m = (data[k].to(DEV) for k in ("knn_q", "knn_p", "knn_mask"))
        with Recorder("knn_counted_cuda") as rec:
            sync()
            reset_counts()
            d, i = sharded_knn(mesh, q, p, m, k=5)
            sync()
            facts["knn"] = (d.cpu(), i.cpu(), dict(K.LAUNCHES),
                            {k: tuple(x.cpu() if isinstance(x, torch.Tensor) else x for x in v)
                             for k, v in rec.seen.items()})
        frec = data["fusion_rec"]
        facts["dist_fusion"] = fusion_replay(dist_steps(mesh, frec), frec, record=True)
        torch.save(facts, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_ranks(n: int, tmp: str, meanwhile):
    """``multichip_rank`` on ``n`` spawned processes and ``meanwhile()`` in
    this process while they run; waits at most ``MC_JOIN_S`` seconds and
    stops them all then. Returns (their facts, what ``meanwhile``
    returned)."""
    ctx = mp.spawn(multichip_rank, args=(n, tmp), nprocs=n, join=False)
    deadline = time.monotonic() + MC_JOIN_S
    try:
        got = meanwhile()
        while not ctx.join(timeout=1.0):
            check(time.monotonic() < deadline, f"multichip: the {n} ranks ran over {MC_JOIN_S} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
                proc.join(10)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(n)], got


def to_dev(v):
    return tuple(x.to(DEV) if isinstance(x, torch.Tensor) else x for x in v)


def print_lap(label, f):
    timed = sorted(f["host_ms"][N_WARM:])
    b, ev, host = f["gather"]
    gat = (f"; fusion all_gather per keyframe: {b[0] if b else 0} bytes sent by this rank, "
           f"{len(b)} calls, median {np.median(ev) if ev else float('nan'):.4f} ms by CUDA "
           f"events ({np.median(host) if host else float('nan'):.4f} ms host, synchronized)")
    print(f"[multichip] {label}: {len(f['host_ms'])} scans, {len(f['kf_stamps'])} keyframes: "
          f"per-scan host ms median {timed[len(timed) // 2]:.3f} min {timed[0]:.3f} max "
          f"{timed[-1]:.3f}; backend p50 {f['backend_p50_ms']:.3f} ms; closures fired at scans "
          f"{f['fired']} (loop factors {f['n_loops']}, rejects {f['lc_rejects']}); launches "
          f"{ {f'{w}:{q}x{p}:k{k}': c for (w, q, p, k), c in sorted(f['counts'].items())} } "
          f"B4 {sum(f['seg_counts'].values())}; plain calls {f['plain_calls']}" + gat)


def check_mesh_counts(label, f, knn_sites, seg_sites, n_scans):
    """B1 at every search site and its map preparation, B4 at both map-shard
    builds, no B3 and no plain version."""
    for (q, p), name in knn_sites.items():
        c = f["counts"].get(("knn_counted", q, p, 5), 0)
        check(c >= (n_scans if name == "odometry" else 1),
              f"multichip {label}: B1 launched {c} times at the {name} site {q}x{p}")
        check(f["counts"].get(("knn_map", 0, p, 0), 0) >= c,
              f"multichip {label}: fewer map preparations than searches at {name}")
    for key, name in seg_sites.items():
        check(f["seg_counts"].get(("segred",) + key, 0) >= 1,
              f"multichip {label}: B4 did not launch at the {name} site {key}")
    check(not any(w == "knn_pruned" for w, *_ in f["counts"]), f"multichip {label}: B3 launched")
    check(f["plain_calls"] == 0, f"multichip {label}: a plain version ran {f['plain_calls']} times")


def mesh_rows(phase, f, knn_sites, seg_sites, snapshot):
    """The kernels against their plain versions on the inputs a run
    recorded at its mesh sites (``snapshot`` "first" or "grown"), and B4 at
    its map-shard builds."""
    names = {key: name for key, name in knn_sites.items()}
    inputs = {("knn_counted",) + key: to_dev(v) for key, v in f[snapshot].items()
              if (key[0], key[1]) in knn_sites and key[2] == 5}
    check(len(inputs) == len(knn_sites), f"{phase}: a B1 site was not recorded ({snapshot})")
    rows = compare_sites(f"{phase}{snapshot}_", inputs, f["counts"], names)
    if snapshot == "grown":
        seen = {key: to_dev(v) for key, v in f["seg"].items() if key[2:] in seg_sites}
        check({key[2:] for key in seen} == set(seg_sites), f"{phase}: a B4 site was not recorded")
        rows += [compare_segred(phase.rstrip("_"), key, v,
                                f["seg_counts"].get(("segred",) + key[2:], 0))
                 for key, v in sorted(seen.items())]
    return rows


def check_runner(label, f, knn_sites, seg_sites):
    """One run of (d): every scan processed, ``check_replicated`` true at
    ``stop()``, B1 (with its map preparation) at every search site and B4 at
    both map-shard builds, no B3 and no plain version."""
    print(f"[multichip] (d) {label}: {f['n_processed']} scans, {len(f['kf_stamps'])} keyframes, "
          f"{f['scans_per_s']:.3f} scans/s; backend p50 {f['backend_p50_ms']:.3f} ms; closures "
          f"fired after scans {f['fired']} (loop factors {f['n_loops']}, rejects "
          f"{f['lc_rejects']}); check_replicated at stop() {f['replicated']}; launches "
          f"{ {f'{w}:{q}x{p}:k{k}': c for (w, q, p, k), c in sorted(f['counts'].items())} } "
          f"B4 {sum(f['seg_counts'].values())}; plain calls {f['plain_calls']}")
    check(f["n_processed"] == MC_RUNNER_SCANS,
          f"multichip (d) {label}: {f['n_processed']} of {MC_RUNNER_SCANS} scans processed")
    check(f["replicated"] is True, f"multichip (d) {label}: check_replicated failed at stop()")
    check_mesh_counts(f"(d) {label}", f, knn_sites, seg_sites, MC_RUNNER_SCANS)


def check_overlapped(label, over, serial):
    """(d): the overlapped runner against the serial one on the same world:
    the same keyframe stamps and fired scans, keyframes within
    ``MC_SHARD_TOL_M`` (its frontend runs ahead of its backend, so a
    closure's correction reaches the odometry at another scan)."""
    check(over["kf_stamps"] == serial["kf_stamps"],
          f"multichip (d) {label}: keyframes differ from the serial runner's")
    check(over["fired"] == serial["fired"] and over["fired"],
          f"multichip (d) {label}: fired after {over['fired']}, serially {serial['fired']}")
    gap = float(torch.linalg.norm(over["graph_t"] - serial["graph_t"], dim=1).max())
    print(f"[multichip] (d) {label} vs the serial runner: the same keyframe stamps and fired "
          f"scans, keyframes up to {gap:.4e} m apart")
    check(gap < MC_SHARD_TOL_M, f"multichip (d) {label}: {gap:.4f} m from the serial runner")
    return gap


def replay_gap(a, b):
    """How far replay ``a`` lies from ``b``: (every output and final state
    field bit-equal, largest ``t_latest`` gap in m, largest ``q_latest`` gap
    in rad, final window gap in m, largest correspondence-count gap)."""
    check(len(a["outs"]) == len(b["outs"]), "multichip (c): replays of different lengths")
    equal = all(torch.equal(x, y) for oa, ob in zip(a["outs"], b["outs"])
                for x, y in zip(oa, ob))
    fa, fb = fusion_fields(a["state"]), fusion_fields(b["state"])
    equal = equal and all(torch.equal(fa[k], fb[k]) for k in fa)
    t_gap = max(float(torch.linalg.norm(oa[0] - ob[0])) for oa, ob in zip(a["outs"], b["outs"]))
    r_gap = max(float(2.0 * torch.linalg.norm(quat_mul(quat_conj(oa[1]), ob[1])[1:]))
                for oa, ob in zip(a["outs"], b["outs"]))
    win = float((a["state"].t - b["state"].t).abs().max())
    corr = max(abs(int(x) - int(y)) for oa, ob in zip(a["outs"], b["outs"])
               for x, y in zip(oa[2:], ob[2:]))
    return equal, t_gap, r_gap, win, corr


def check_replay(label, f, ref, sites, n_solved):
    """One replay of (c): its launches (B1 at both fusion sites on every
    solved keyframe, each with its map preparation, B4, no B3 and no plain
    version), its per-keyframe step time and gather, and its gap to the
    single-card ``fusion_step`` replay ``ref``."""
    ms = sorted(f["ms"])
    b, ev, host = f["gather"]
    print(f"[multichip] (c) {label}: {len(f['outs'])} keyframes ({n_solved} solved); step ms "
          f"per keyframe median {ms[len(ms) // 2]:.3f} min {ms[0]:.3f} max {ms[-1]:.3f}; "
          f"all_gather per keyframe: {b[0] if b else 0} bytes sent by this rank, {len(b)} "
          f"calls, median {np.median(ev) if ev else float('nan'):.4f} ms by CUDA events "
          f"({np.median(host) if host else float('nan'):.4f} ms host, synchronized); launches "
          f"{ {f'{w}:{q}x{p}:k{k}': c for (w, q, p, k), c in sorted(f['counts'].items())} } "
          f"B4 {sum(f['seg_counts'].values())}; plain calls {f['plain_calls']}")
    for (q, p), name in sites.items():
        c = f["counts"].get(("knn_counted", q, p, 5), 0)
        check(c >= n_solved, f"multichip (c) {label}: B1 launched {c} times at {name} {q}x{p}")
        check(f["counts"].get(("knn_map", 0, p, 0), 0) >= c,
              f"multichip (c) {label}: fewer map preparations than searches at {name}")
    check(sum(f["seg_counts"].values()) > 0, f"multichip (c) {label}: B4 did not launch")
    check(not any(w in ("knn_pruned", "knn_dense") for w, *_ in f["counts"]),
          f"multichip (c) {label}: B2 or B3 launched")
    check(f["plain_calls"] == 0, f"multichip (c) {label}: a plain version ran")
    if ref is None:
        return
    equal, t_gap, r_gap, win, corr = replay_gap(f, ref)
    print(f"[multichip] (c) {label} vs the single-card fusion_step replay: "
          f"{'bit-equal' if equal else 'NOT bit-equal'} (t_latest gap {t_gap:.3e} m, q_latest "
          f"{r_gap:.3e} rad, final window {win:.3e} m, correspondence counts {corr})")
    check(equal or (max(t_gap, win) < TRAJ_TOL_M and r_gap < TRAJ_TOL_RAD),
          f"multichip (c): {label} differs from fusion_step by {t_gap:.3e} m / {r_gap:.3e} rad")


def multichip_phase(tmp: str):
    """The multi-device path at the whole ``fr_iosb_rot`` preset on the
    first ``MC_SCANS`` scans of the system lap, closures every ``LC_EVERY``
    scans: (a) ``LiliOmSystem(mesh=…)`` over NCCL at world size 1, against
    the single-card system with ``incremental_map=False`` (the merge is the
    identity at n=1: equal bit for bit, or within ``TRAJ_TOL_*``) and the
    default incremental one (keyframe RMSE of both); (b) two gloo ranks on
    the card, spawned: each rank's keyframes within ``MC_SHARD_TOL_M`` of
    (a), equal digests of the replicated state, B1 and B4 launched at every
    mesh site on every rank, and ``sharded_knn`` with an all-invalid block
    equal to the plain search; (c) the single-card incremental run's
    keyframes replayed through ``fusion_step``, the query-sharded fusion
    over NCCL at world size 1 and on (b)'s ranks, all equal. Then the
    kernels against their plain versions at the mesh sites and at (c)'s
    per-rank blocks. Returns (kernel rows, facts)."""
    cfg = system_config()
    lc = dataclasses.replace(cfg.loop_closure, time_thres=SYS_LAP_S / 3.0)
    t0 = time.perf_counter()
    scans, imu, traj, _, _ = sim_lap(cfg, MC_SCANS)
    t0w, q0w = pose_at(traj, 0.0, device=DEV)
    print(f"[multichip] cuts: the first {MC_SCANS} scans of the system lap ({SYS_RINGS}x"
          f"{SYS_COLS}), closures every {LC_EVERY} scans, time_thres {lc.time_thres:.2f} s as "
          f"the system phase; one card, so (a) NCCL at world size 1 and (b) {MC_RANKS} gloo "
          f"ranks on cuda:0; sim {time.perf_counter() - t0:.2f} s")
    rmse = lambda f: float(torch.sqrt(torch.mean(  # noqa: E731
        graph_errors(f["graph_t"], f["kf_stamps"], traj, t0w, q0w) ** 2)))

    # the single-card incremental run, whose keyframes (c) replays here and
    # on (b)'s ranks; (a) and the batch-map reference run below, beside them
    with FusionSpy(record=True) as fspy:
        inc = mesh_lap(None, scans, imu, cfg, lc, record=False)

    # (c) the incremental run's keyframes, replayed below
    frec = {"first": fspy.first, "inputs": fspy.inputs}
    fcfg = frec["first"][1]
    n_solved = sum(not w for _, w in frec["inputs"])

    def world1():
        """(a) NCCL at world size 1 and the single-card batch-map reference;
        (d1), (d2): the runner over NCCL at world size 1; (c) the keyframes
        replayed through fusion_step and through the query-sharded fusion
        at world size 1. Run in this process while (b)'s ranks run."""
        dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl_rendezvous",
                                world_size=1, rank=0)
        try:
            a = mesh_lap(make_mesh(1, axis="kf"), scans, imu, cfg, lc)
        finally:
            dist.destroy_process_group()
        batch = mesh_lap(None, scans, imu, dataclasses.replace(
            cfg, fusion=cfg.fusion._replace(incremental_map=False)), lc, record=False)
        dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl_rendezvous_d",
                                world_size=1, rank=0)
        try:
            mesh1 = make_mesh(1, axis="kf")
            d1 = mesh_runner(mesh1, scans, imu, cfg, lc, overlap=False, record=True)
            d2 = mesh_runner(mesh1, scans, imu, cfg, lc, overlap=True)
        finally:
            dist.destroy_process_group()
        c_single = fusion_replay(single_steps(frec), frec)
        dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl_rendezvous_c",
                                world_size=1, rank=0)
        try:
            c_n1 = fusion_replay(dist_steps(make_mesh(1, axis="kf"), frec), frec)
        finally:
            dist.destroy_process_group()
        return a, batch, d1, d2, c_single, c_n1

    # (b) two gloo ranks on the card
    gen = torch.Generator(device=DEV).manual_seed(1)
    box = torch.tensor([60.0, 60.0, 8.0], device=DEV)
    knn_p = torch.rand((MC_KNN_P, 3), generator=gen, device=DEV) * box - box / 2
    knn_q = knn_p[torch.randint(0, MC_KNN_P, (MC_KNN_Q,), generator=gen, device=DEV)] \
        + 0.2 * torch.randn((MC_KNN_Q, 3), generator=gen, device=DEV)
    knn_mask = torch.arange(MC_KNN_P, device=DEV) % 3 != 0
    knn_mask[MC_KNN_P // MC_RANKS:] = False  # every block but the first's: all invalid
    torch.save({"scans": [tuple(x.cpu() for x in s) for s in scans], "imu": imu.__class__(
        *(x.cpu() for x in imu)), "cfg": cfg, "lc": lc, "knn_q": knn_q.cpu(),
        "knn_p": knn_p.cpu(), "knn_mask": knn_mask.cpu(), "fusion_rec": frec},
        os.path.join(tmp, "lap.pt"))
    t0 = time.perf_counter()
    ranks, (a, batch, d1, d2, c_single, c_n1) = spawn_ranks(MC_RANKS, tmp, world1)
    del scans
    print(f"[multichip] (b) {MC_RANKS} ranks spawned and run in {time.perf_counter() - t0:.2f} s, "
          f"(a), the batch-map reference, (d1), (d2) and (c)'s world-1 replays in this process "
          f"meanwhile")
    print_lap("(a) NCCL, world size 1", a)
    print_lap("single card, incremental_map=False", batch)
    print_lap("single card, incremental maps (default)", inc)
    knn1, seg1 = mesh_sites(cfg, 1)
    check_mesh_counts("(a)", a, knn1, seg1, MC_SCANS)
    check(a["replicated"], "multichip (a): check_replicated found a difference at world size 1")
    equal = (np.array_equal(a["trajectory"], batch["trajectory"])
             and torch.equal(a["graph_t"], batch["graph_t"]))
    gap = max(float(np.abs(a["trajectory"] - batch["trajectory"]).max()),
              float((a["graph_t"] - batch["graph_t"]).abs().max()))
    print(f"[multichip] (a) vs the single-card incremental_map=False system: "
          f"{'bit-equal' if equal else f'NOT bit-equal, gap {gap:.3e} m'} (at world size 1 "
          f"the merge is the identity and every sum is the rank's own)")
    check(a["kf_stamps"] == batch["kf_stamps"] and (equal or gap < TRAJ_TOL_M),
          f"multichip (a): {gap:.3e} m from the single-card batch-map system")
    ra, rinc = rmse(a), rmse(inc)
    print(f"[multichip] keyframe RMSE vs the simulator: (a) {ra:.6f} m, single card incremental "
          f"{rinc:.6f} m, single card batch {rmse(batch):.6f} m")
    check(ra <= KF_RMSE_TOL_M and rinc <= KF_RMSE_TOL_M,
          f"multichip: keyframe RMSE (a) {ra:.4f} m, incremental {rinc:.4f} m")

    # (d1), (d2): the runner over NCCL at world size 1
    check_runner("(d1) NCCL world size 1, serial runner", d1, knn1, seg1)
    check(d1["digest"] == a["digest_at_runner_scans"],
          f"multichip (d1): the serial runner's digest after {MC_RUNNER_SCANS} scans differs "
          f"from (a)'s")
    print(f"[multichip] (d1) replicated-state digest {d1['digest'][:16]}, (a)'s after scan "
          f"{MC_RUNNER_SCANS - 1} {a['digest_at_runner_scans'][:16]}: equal")
    check_runner("(d2) NCCL world size 1, overlapped runner", d2, knn1, seg1)
    d2_gap = check_overlapped("(d2)", d2, d1)
    # (c) at world size 1
    sites1 = {(fcfg.window * fcfg.kf_surf_cap, fcfg.map_surf_cap): "fusion_surf",
              (fcfg.window * fcfg.kf_edge_cap, fcfg.map_edge_cap): "fusion_edge"}
    print(f"[multichip] (c) cuts: the {len(frec['inputs'])} keyframes of the single-card "
          f"incremental run above, replayed from its first state without the closures' ring "
          f"corrections (rebuild off), the pruned switch unset")
    check_replay("fusion_step on the card", c_single, None, sites1, n_solved)
    check_replay("make_distributed_fusion, NCCL world size 1", c_n1, c_single, sites1, n_solved)
    knn2, seg2 = mesh_sites(cfg, MC_RANKS)
    for r, f in enumerate(ranks):
        print_lap(f"(b) gloo rank {r} of {MC_RANKS}", f)
        check_mesh_counts(f"(b) rank {r}", f, knn2, seg2, MC_SCANS)
        check(f["replicated"], f"multichip (b): rank {r}'s check_replicated found a difference")
        check(f["kf_stamps"] == ranks[0]["kf_stamps"]
              and np.array_equal(f["trajectory"], ranks[0]["trajectory"]),
              f"multichip (b): rank {r}'s run differs from rank 0's")
    digests = [f["digest"] for f in ranks]
    print(f"[multichip] (b) replicated-state digests {[d[:16] for d in digests]}; configs "
          f"{ {k: ranks[0]['configs'][1][k] for k in ('map_slots_pad', 'map_surf_cap', 'map_edge_cap', 'incremental_map')} }")
    check(len(set(digests)) == 1, "multichip (b): the ranks' digests differ")
    b = ranks[0]
    check(b["kf_stamps"] == a["kf_stamps"],
          f"multichip (b): {len(b['kf_stamps'])} keyframes against (a)'s {len(a['kf_stamps'])}")
    shard_gap = float(torch.linalg.norm(b["graph_t"] - a["graph_t"], dim=1).max())
    print(f"[multichip] (b) vs (a): keyframes up to {shard_gap:.4e} m apart (voxels spanning "
          f"two ranks' keyframes deduplicate per rank); keyframe RMSE (b) {rmse(b):.6f} m")
    check(shard_gap < MC_SHARD_TOL_M, f"multichip (b): {shard_gap:.4f} m from (a)")

    # (d3): the serial and the overlapped runner on (b)'s ranks
    d3_gap = []
    for r, f in enumerate(ranks):
        ser, over = f["runner"]
        check_runner(f"(d3) gloo rank {r} of {MC_RANKS}, serial runner", ser, knn2, seg2)
        check(ser["digest"] == f["digest_at_runner_scans"],
              f"multichip (d3): rank {r}'s serial runner differs from (b) after "
              f"{MC_RUNNER_SCANS} scans")
        check_runner(f"(d3) gloo rank {r} of {MC_RANKS}, overlapped runner", over, knn2, seg2)
        d3_gap.append(check_overlapped(f"(d3) rank {r}", over, ser))
    for i, name in enumerate(("serial", "overlapped")):
        digests = [f["runner"][i]["digest"] for f in ranks]
        print(f"[multichip] (d3) {name} runner: replicated-state digests "
              f"{[d[:16] for d in digests]}" + (f", the serial one equal to (b)'s after scan "
                                                f"{MC_RUNNER_SCANS - 1}" if i == 0 else ""))
        check(len(set(digests)) == 1, f"multichip (d3): the {name} runner's digests differ")

    # sharded_knn with an all-invalid block against the plain search
    d_ref, i_ref = K.knn(knn_q, knn_p, k=5, p_mask=knn_mask)
    rows = []
    for r, f in enumerate(ranks):
        d, i, counts, seen = f["knn"]
        check(torch.equal(d.to(DEV), d_ref) and torch.equal(i.to(DEV), i_ref),
              f"multichip: rank {r}'s sharded_knn differs from the plain search")
        blk = MC_KNN_P // MC_RANKS
        rows += compare_sites(f"multichip_sharded_knn_r{r}_",
                              {("knn_counted",) + key: to_dev(v) for key, v in seen.items()},
                              counts, {(MC_KNN_Q, blk): "sharded_knn"})
    print(f"[multichip] sharded_knn {MC_KNN_Q}x{MC_KNN_P} over {MC_RANKS} ranks, block "
          f"{MC_RANKS - 1} all invalid: equal to the plain search on every rank")

    # the kernels at the mesh sites: world 1's grown maps; rank 0's grown
    # maps; rank 1's first calls (its map shards empty: zero walk bounds)
    rows += mesh_rows("multichip_n1_", a, knn1, seg1, "grown")
    rows += mesh_rows("multichip_d1_", d1, knn1, seg1, "grown")
    rows += mesh_rows("multichip_n2_r0_", ranks[0], knn2, seg2, "grown")
    rows += mesh_rows("multichip_n2_r1_", ranks[1], knn2, seg2, "first")
    zero = [x for x in rows if x["name"].startswith("knn_counted[") and x["valid"][1] == 0]
    check(any("fusion" in x["name"] for x in zero),
          "multichip: no fusion site with an all-invalid map shard was held")

    # (c) on the two gloo ranks: each rank's block of the window's rows
    sites2 = {(q // MC_RANKS, p): f"dist_{name}" for (q, p), name in sites1.items()}
    for r, f in enumerate(ranks):
        check_replay(f"make_distributed_fusion, gloo rank {r} of {MC_RANKS}", f["dist_fusion"],
                     c_single, sites2, n_solved)
    for r, f in enumerate(ranks):
        df = f["dist_fusion"]
        for snap in ("first", "grown"):
            inputs = {("knn_counted",) + key: to_dev(v) for key, v in df[snap].items()
                      if (key[0], key[1]) in sites2 and key[2] == 5}
            check(len(inputs) == len(sites2),
                  f"multichip (c): a B1 site of rank {r} was not recorded ({snap})")
            print(f"[multichip] (c) rank {r}, {snap} call: valid queries of its block "
                  + ", ".join(f"{sites2[key[1], key[2]]} {int(v[3].sum())}/{key[1]}"
                              for key, v in sorted(inputs.items())))
            # the preparation kernel once per map size (rank 1's maps are rank 0's)
            rows += compare_sites(f"multichip_c_r{r}_{snap}_", inputs, df["counts"], sites2,
                                  with_maps=r == 0 and snap == "grown")
    # B4 at every site of rank 0's step (the ingest's table merges and
    # keyframe downsamples), from keyframe MC_DIST_RECORD_FROM on
    df = ranks[0]["dist_fusion"]
    check(bool(df["seg"]), "multichip (c): no B4 site recorded on rank 0")
    rows += [compare_segred("multichip_c_r0", key, to_dev(v),
                            df["seg_counts"].get(("segred",) + key[2:], 0))
             for key, v in sorted(df["seg"].items())]
    facts = {name: {"per_scan_host_ms": f["host_ms"], "backend_p50_ms": f["backend_p50_ms"],
                    "fired": f["fired"], "kf_rmse": rmse(f),
                    "gather_bytes": f["gather"][0][:1], "gather_event_ms": f["gather"][1],
                    "gather_host_ms": f["gather"][2]}
             for name, f in (("nccl_world1", a), ("single_batch", batch),
                             ("single_incremental", inc), ("gloo_rank0", ranks[0]),
                             ("gloo_rank1", ranks[1]))}
    facts["shard_gap_m"], facts["n1_bit_equal"] = shard_gap, equal
    facts["runner"] = {
        name: {k: f[k] for k in ("scans_per_s", "backend_p50_ms", "fired", "n_loops",
                                 "replicated", "digest")}
        for name, f in (("d1_nccl_world1_serial", d1), ("d2_nccl_world1_overlapped", d2),
                        ("d3_gloo_rank0_serial", ranks[0]["runner"][0]),
                        ("d3_gloo_rank0_overlapped", ranks[0]["runner"][1]),
                        ("d3_gloo_rank1_serial", ranks[1]["runner"][0]),
                        ("d3_gloo_rank1_overlapped", ranks[1]["runner"][1]))}
    facts["runner_gap_m"] = {"d2": d2_gap, "d3": d3_gap}
    facts["dist_fusion"] = {
        name: {"step_ms": f["ms"], "gather_bytes": f["gather"][0][:1],
               "gather_event_ms": f["gather"][1], "gather_host_ms": f["gather"][2],
               "bit_equal": None if f is c_single else replay_gap(f, c_single)[0]}
        for name, f in (("single", c_single), ("nccl_world1", c_n1),
                        ("gloo_rank0", ranks[0]["dist_fusion"]),
                        ("gloo_rank1", ranks[1]["dist_fusion"]))}
    return rows, facts


# ---------------------------------------------------------------------------
# the soak: apps/soak_long_run.py
# ---------------------------------------------------------------------------


def soak_phase():
    """``apps/soak_long_run.main([SOAK_KF, "--spill", "--speed-up",
    SOAK_SPEED_UP])`` on the card, in a process of its own beside the
    runtime phase (:func:`start_child`), every launch count set to 0 just
    before and read just after: it must return 0 (keyframe latency flat,
    graph solve under 1 s, resident archives bounded); its report printed
    line by line, B1 and B4 launched, no B3 and no plain version. Returns
    its facts."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc, counts, seg_counts, plain = counted(lambda: soak_long_run.main(
                [str(SOAK_KF), "--spill", "--speed-up", str(SOAK_SPEED_UP)]))
    finally:
        lines = [x for x in buf.getvalue().splitlines() if x.strip()]
        for line in lines:
            print(f"[soak] {line}")
    secs = time.perf_counter() - t0
    b1 = sum(c for (w, *_), c in counts.items() if w == "knn_counted")
    prep = sum(c for (w, *_), c in counts.items() if w == "knn_map")
    print(f"[soak] {SOAK_KF} keyframes with --spill --speed-up {SOAK_SPEED_UP} in {secs:.1f} s "
          f"(in its own process, beside [runtime]'s runs), exit code {rc}; launches "
          f"B1 {b1} (map preparations {prep}) "
          f"{ {f'{w}:{q}x{p}:k{k}': c for (w, q, p, k), c in sorted(counts.items())} }, "
          f"B4 {sum(seg_counts.values())}; plain calls {plain}")
    check(rc == 0, f"soak: apps/soak_long_run returned {rc}")
    check(b1 > 0 and prep > 0 and sum(seg_counts.values()) > 0,
          "soak: B1 with its map preparation and B4 did not all launch")
    check(not any(w in ("knn_pruned", "knn_dense") for w, *_ in counts),
          "soak: B2 or B3 launched")
    check(plain == 0, f"soak: a plain version ran {plain} times")
    return {"seconds": secs, "report": lines, "b1": b1, "b4": sum(seg_counts.values())}


CHILD_RUNS = {"soak": soak_phase, "runtime_closure": runtime_closure_run, "livox": livox_run}


# ---------------------------------------------------------------------------
# 12. evaluate: the golden-loop table, aggressive motion, the run export, the
# live viewer, a profiler trace, the hash grid and the backend diagnostic
# ---------------------------------------------------------------------------


def tally(total, *counts):
    """Adds launch counts {key: n} into ``total``."""
    for c in counts:
        for key, n in c.items():
            total[key] = total.get(key, 0) + n


def host_tree(seen):
    """A recorder's inputs moved to the host, to be saved by a spawned run."""
    return {k: tuple(x.cpu() if isinstance(x, torch.Tensor) else x for x in v)
            for k, v in seen.items()}


def evaluate_rank(i: int, tmp: str, out: str | None):
    """One run of (a) or (b) in its own process on ``cuda:0``: ranks below
    the number of default presets run the table's preset ``i``, the rest
    an aggressive run. The runs go at once, as each is bound by its host
    thread."""
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)
    n = len(evaluate_presets.DEFAULT_PRESETS)
    if i < n:
        preset_rank(i, tmp, out)
    else:
        aggressive_rank(AG_PRESETS[i - n], tmp)


def run_evaluate_ranks(tmp, out, meanwhile=None):
    """(a) and (b): ``evaluate_rank`` for each run, spawned at once, and
    ``meanwhile()`` in this process while they run; waits at most
    ``MC_JOIN_S`` seconds and stops them all then. Returns (the wall time,
    what ``meanwhile`` returned)."""
    n = len(evaluate_presets.DEFAULT_PRESETS) + len(AG_PRESETS)
    t0 = time.perf_counter()
    ctx = mp.spawn(evaluate_rank, args=(tmp, out), nprocs=n, join=False)
    deadline = time.monotonic() + MC_JOIN_S
    try:
        got = meanwhile() if meanwhile is not None else None
        while not ctx.join(timeout=1.0):
            check(time.monotonic() < deadline, f"evaluate: the runs ran over {MC_JOIN_S} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
                proc.join(10)
    return time.perf_counter() - t0, got


def diag_run():
    """(h) ``apps/diag_backend.run`` over ``DIAG_FRAMES`` frames on the card,
    every launch count set to 0 just before and read just after: both ATEs
    finite, B1 and B4 launched, no plain version. Returns its facts."""
    t0 = time.perf_counter()
    r, counts, seg_counts, plain = counted(lambda: diag_backend.run(
        DIAG_FRAMES, device=DEV, log=lambda m: print(f"[evaluate] (h) diag_backend {m}")))
    secs = time.perf_counter() - t0
    b1 = sum(c for (w, *_), c in counts.items() if w == "knn_counted")
    fe, be = r["frontend_ate"], r["backend_ate"]
    print(f"[evaluate] (h) diag_backend, {DIAG_FRAMES} frames, {len(r['kf_frames'])} keyframes "
          f"in {secs:.1f} s (beside (a) and (b)'s processes): frontend ATE RMSE {fe:.6f} m "
          f"(max {r['fe_err'].max():.6f}), backend ATE RMSE {be:.6f} m (max "
          f"{r['be_err'].max():.6f}); launches B1 {b1}, B4 {sum(seg_counts.values())}; plain "
          f"calls {plain}")
    check(math.isfinite(fe) and math.isfinite(be), f"diag_backend: ATEs {fe} / {be}")
    check(b1 > 0 and sum(seg_counts.values()) > 0, "diag_backend: B1 or B4 did not launch")
    check(plain == 0, f"diag_backend: a plain version ran {plain} times")
    return {"seconds": secs, "frontend_ate": fe, "backend_ate": be,
            "keyframes": len(r["kf_frames"]), "traces": len(r["traces"])}


def merge_seen(knn_seen, seg_seen, f):
    """A spawned run's recorded B1 and B4 inputs, each site's first kept."""
    for seen, got in ((knn_seen, f["knn_seen"]), (seg_seen, f["seg_seen"])):
        for key, v in got.items():
            seen.setdefault(key, to_dev(v))


def preset_rank(i: int, tmp: str, out: str | None):
    """(a) one preset of the table: the launch counts set to 0 just before
    ``run_preset`` and read just after, each call site's first B1 and B4
    inputs recorded, and for ``fr_iosb_rot`` the export check (c) on its
    system. Its facts to ``tmp/preset{i}.pt``; with ``out``, its closure
    attempts to ``out/icp_attempts_{preset}.npz`` (``scan``: the attempt's
    ordinal)."""
    name = evaluate_presets.DEFAULT_PRESETS[i]
    with Recorder("knn_counted_cuda") as rec, SegRecorder() as seg, IcpSpy() as icp:
        t0 = time.perf_counter()
        r, counts, seg_counts, plain = counted(
            lambda: evaluate_presets.run_preset(name, EV_FRAMES, torch.float32, device=DEV))
        secs = time.perf_counter() - t0
    sys_ = r.pop("system")
    if out and icp.calls:
        calls = [(n, *c[1:]) for n, c in enumerate(icp.calls)]
        save_icp_attempts(os.path.join(out, f"icp_attempts_{name}.npz"), calls, sys_.lc_cfg)
    facts = {"row": r, "seconds": secs, "counts": counts, "seg_counts": seg_counts,
             "plain": plain, "rejects": dict(sys_.lc_rejects),
             "backend_p50_ms": sys_.metrics.report().get("backend", {}).get("p50_ms"),
             "knn_seen": host_tree(rec.seen), "seg_seen": host_tree(seg.seen)}
    if name == "fr_iosb_rot":
        facts["export"] = check_export(sys_, tmp)
    torch.save(facts, os.path.join(tmp, f"preset{i}.pt"))


def preset_table(tmp, wall, launches, knn_seen, seg_seen):
    """(a) ``run_preset`` over the harness's default presets, as the spawned
    runs left it (``wall``: their time): their launch counts added to
    ``launches`` and their recorded inputs to ``knn_seen``/``seg_seen``.
    Returns the table's rows and (c)'s facts."""
    names = evaluate_presets.DEFAULT_PRESETS
    rows, export = [], None
    for i, name in enumerate(names):
        f = torch.load(os.path.join(tmp, f"preset{i}.pt"), weights_only=False)
        r = f["row"]
        cfg = load_config(name)
        r["width"] = ("6x4000" if cfg.variant == "livox"
                      else f"{evaluate_presets.RINGS.get(name, 16)}x{evaluate_presets.COLS}")
        r["seconds"], r["ok"] = f["seconds"], bool(r["kf_ate"] < evaluate_presets.bound(name))
        rec = EV_JAX_KF_ATE.get(name)
        print(f"[evaluate] (a) {name} at {r['width']}, {EV_FRAMES} frames in {f['seconds']:.1f} s "
              f"({r['scans_per_s']:.3f} scans/s, the card shared by the {len(names)} presets): "
              f"kf ATE {r['kf_ate']:.4f} m (bound {evaluate_presets.bound(name)}; JAX on its "
              f"TPU, float32: {'no record' if rec is None else f'{rec} m'}), frame ATE "
              f"{r['frame_ate']:.4f} m, RPE@5 {r['kf_rpe5']:.4f} m, {r['keyframes']} keyframes, "
              f"{r['loops']} loops (rejects {f['rejects']}); backend p50 "
              f"{f['backend_p50_ms'] or float('nan'):.1f} ms")
        check_counts("evaluate", f"(a) {name}", f["counts"], f["seg_counts"], f["plain"])
        tally(launches, f["counts"], f["seg_counts"])
        merge_seen(knn_seen, seg_seen, f)
        check(r["ok"], f"evaluate: {name} keyframe ATE {r['kf_ate']} misses "
                       f"{evaluate_presets.bound(name)} m")
        rows.append(r)
        export = f.get("export", export)
    print(f"[evaluate] (a) {len(names)} presets and (b) in {wall:.1f} s (one process each, "
          "at once); table:\n" + evaluate_presets.format_table(rows))
    check(export is not None, "evaluate: the export check did not run")
    return rows, export


def aggressive_run(preset: str):
    """(b) tests/test_golden_motion.py's run at the whole preset: the sensor
    flies ``aggressive_trajectory`` (its ramp, then yaw bursts), the body
    and IMU follow through the preset's extrinsic, the fusion starts at the
    true orientation, loop closure off. Returns the facts."""
    cfg = load_config(preset)
    livox = cfg.variant == "livox"
    world = make_room_world(device=DEV)
    sensor = aggressive_trajectory()
    q_lb = torch.tensor(cfg.fusion.q_lb, dtype=torch.float64, device=DEV)
    t_lb = torch.tensor(cfg.fusion.t_lb, dtype=torch.float64, device=DEV)

    def body(t):
        p, q = sensor(t)
        return (p + quat_rotate(q, t_lb.to(t.dtype).expand(p.shape)),
                quat_normalize(quat_mul(q, q_lb.to(t.dtype))))

    q_sl = quat_conj_np(np.asarray(cfg.fusion.q_lb, float)[None])[0]
    t_sl = -quat_rotate_np(q_sl[None], np.asarray(cfg.fusion.t_lb, float)[None])[0]
    lc = dataclasses.replace(cfg.loop_closure, enabled=False)
    sys_ = LiliOmSystem(cfg.odometry, cfg.fusion, cfg.spin_features, cfg.livox_features, lc,
                        cfg.imu_noise, device=DEV)
    _, q0w = pose_at(body, 0.0, device=DEV)
    sys_.fusion_state = sys_.fusion_state._replace(
        q=q0w.to(sys_.dtype).repeat(cfg.fusion.window, 1))
    imu = simulate_imu(body, 0.0, AG_FRAMES * 0.1 + 0.1, rate=200.0, device=DEV)
    sys_.push_imu(*(host(x) for x in imu))
    pattern = (livox_pattern(LIVOX_LINES, LIVOX_PTS, device=DEV) if livox
               else spinning_pattern(n_rings=SYS_RINGS, n_cols=SYS_COLS, device=DEV))
    n_corr, host_ms = [], []
    for k in range(AG_FRAMES):
        ts = k * 0.1
        sc = simulate_scan(world, body, ts, pattern, period=0.1, t_sl=t_sl, q_sl=q_sl)
        sync()
        t1 = time.perf_counter()
        if livox:
            out = sys_.process_scan_livox(sc.pts, sc.line.to(torch.int32),
                                          torch.clamp(sc.rel_time, 0.0, 0.999),
                                          sc.reflectivity, sc.valid, ts)
        else:
            out = sys_.process_scan(sc.pts.reshape(SYS_RINGS, SYS_COLS, 3),
                                    sc.valid.reshape(SYS_RINGS, SYS_COLS),
                                    sc.rel_time.reshape(SYS_RINGS, SYS_COLS), ts)
        n_corr.append(int(out.n_corr))
        sync()
        host_ms.append(1e3 * (time.perf_counter() - t1))
    stamps = np.arange(AG_FRAMES) * 0.1
    s0 = pose_at(sensor, 0.0, device=DEV)
    front_gt = np.stack([host(pose_relative(*s0, *pose_at(sensor, s, device=DEV))[0])
                         for s in stamps])
    front = ate_rmse(stamps, np.stack(sys_.trajectory), stamps, front_gt, align=False)["rmse"]
    nk = len(sys_.kf_stamps)
    p0 = host(pose_at(body, 0.0, device=DEV)[0])
    kf_gt = np.stack([host(pose_at(body, s, device=DEV)[0]) - p0 for s in sys_.kf_stamps])
    back = ate_rmse(sys_.kf_stamps, sys_.graph.t[:nk], sys_.kf_stamps, kf_gt,
                    align=False)["rmse"]
    acquired = float(np.mean([c > 0 for c in n_corr[2:]]))
    gyro = torch.linalg.norm(imu.gyrs, dim=-1)
    return {"preset": preset, "width": "6x4000" if livox else f"{SYS_RINGS}x{SYS_COLS}",
            "front_ate": front, "back_ate": back, "acquired": acquired, "keyframes": nk,
            "peak_gyro": float(gyro.max()), "per_scan_ms": sorted(host_ms)[len(host_ms) // 2]}


def aggressive_rank(preset: str, tmp: str):
    """(b) one preset's aggressive run, its launch counts set to 0 just
    before and read just after, each call site's first B1 and B4 inputs
    recorded; its facts to ``tmp/aggressive_{preset}.pt``."""
    with Recorder("knn_counted_cuda") as rec, SegRecorder() as seg:
        f, counts, seg_counts, plain = counted(lambda: aggressive_run(preset))
    torch.save({"facts": f, "counts": counts, "seg_counts": seg_counts, "plain": plain,
                "knn_seen": host_tree(rec.seen), "seg_seen": host_tree(seg.seen)},
               os.path.join(tmp, f"aggressive_{preset}.pt"))


def aggressive_results(tmp, launches, knn_seen, seg_seen):
    """(b) as the spawned runs left it: printed and checked, the launch
    counts added to ``launches`` and the inputs to ``knn_seen``/``seg_seen``.
    Returns {preset: facts}."""
    out = {}
    for preset in AG_PRESETS:
        g = torch.load(os.path.join(tmp, f"aggressive_{preset}.pt"), weights_only=False)
        f = g["facts"]
        print(f"[evaluate] (b) aggressive {preset} at {f['width']}, {AG_FRAMES} frames: "
              f"backend kf ATE {f['back_ate']:.4f} m (bound {AG_BOUND_M}), frontend ATE "
              f"{f['front_ate']:.4f} m, surf matches on {100 * f['acquired']:.1f} % of "
              f"scans after 2, {f['keyframes']} keyframes, peak gyro "
              f"{f['peak_gyro']:.2f} rad/s, per-scan host ms median "
              f"{f['per_scan_ms']:.1f}")
        check_counts("evaluate", f"(b) {preset}", g["counts"], g["seg_counts"], g["plain"])
        tally(launches, g["counts"], g["seg_counts"])
        merge_seen(knn_seen, seg_seen, g)
        check(np.isfinite(f["back_ate"]) and f["back_ate"] < AG_BOUND_M,
              f"aggressive {preset}: backend ATE {f['back_ate']}")
        check(f["acquired"] >= ACQUIRED_MIN,
              f"aggressive {preset}: matches on {f['acquired']}")
        check(f["peak_gyro"] > AG_MIN_GYRO,
              f"aggressive {preset}: peak gyro {f['peak_gyro']} rad/s, no burst flown")
        out[f"aggressive_{preset}"] = f
    return out


def check_export(sys_, tmp):
    """(c) ``export_run`` of (a)'s fr_iosb_rot system (in (a)'s process)."""
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    out_dir = os.path.join(tmp, "export")
    est = np.stack(sys_.trajectory)
    n_map = len(sys_.build_global_map())
    if has_mpl:
        paths = export_run(out_dir, sys_, est_t=est)
    else:
        try:
            export_run(out_dir, sys_, est_t=est)
            raise CheckFailed("export_run drew no PNG and raised nothing without matplotlib")
        except ImportError as e:
            check("overview.png" in str(e), f"export_run's ImportError names no PNG: {e}")
        paths = {k: os.path.join(out_dir, f) for k, f in (
            ("trajectory_tum", "trajectory_kf.tum"), ("map_pcd", "global_map.pcd"),
            ("map_ply", "global_map.ply"))}
    nk = len(sys_.kf_stamps)
    _, t, q = load_tum(paths["trajectory_tum"])
    gap = max(float(np.abs(t - host(sys_.graph.t[:nk])).max()),
              float(np.abs(q - host(sys_.graph.q[:nk])).max()))
    with open(paths["map_ply"], "rb") as f:
        header = f.read(256).split(b"end_header")[0].decode()
    n_ply = int(header.split("element vertex ")[1].split()[0])
    n_pcd = len(read_pcd(paths["map_pcd"]))
    print(f"[evaluate] (c) export_run: {nk} keyframes in TUM, largest gap to the graph "
          f"{gap:.2e}; map {n_map} points, PLY {n_ply}, PCD read back {n_pcd}; matplotlib "
          + ("present: overview.png " + f"{os.path.getsize(paths['overview_png'])} bytes"
             if has_mpl else "absent: export_run raised its ImportError naming the PNG, "
             "the other files written"))
    check(len(t) == nk and gap <= 5e-7 + 1e-9, f"export: TUM keyframes off by {gap}")
    check(n_ply == n_map == n_pcd and n_map > 0,
          f"export: PLY {n_ply} / PCD {n_pcd} vertices against the map's {n_map}")
    if has_mpl:
        with open(paths["overview_png"], "rb") as f:
            check(f.read(8) == b"\x89PNG\r\n\x1a\n", "export: overview.png is not a PNG")
    return {"tum_gap": gap, "map_points": n_map, "png": has_mpl}


def check_live_viewer(tmp, launches, names):
    """(d) ``LiveViewer`` on a short run of apps/run_loop_closure.py's system
    with a map published every ``LV_PUBLISH_S`` s of scan time, its
    directory served on a free localhost port; the system's kNN site names
    added to ``names``."""
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    out_dir = os.path.join(tmp, "live")
    sys_ = run_loop_closure.make_system(LV_FRAMES, 10.0, device=DEV)
    names.update(site_names(sys_.odo_cfg, sys_.fusion_cfg, sys_.lc_cfg.submap_cap))
    sys_.map_publish_period = LV_PUBLISH_S
    viewer = LiveViewer(out_dir, sys_, figure=has_mpl)
    port = viewer.serve(0)
    try:
        r, counts, seg_counts, plain = counted(
            lambda: run_loop_closure.run(LV_FRAMES, device=DEV, system=sys_, log=lambda *a: None))
        check_counts("evaluate", "(d) live run", counts, seg_counts, plain)
        tally(launches, counts, seg_counts)
        index = urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=30).read()
        status = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}/status.json",
                                                   timeout=30).read())
    finally:
        viewer.close()
    with open(os.path.join(out_dir, "trajectory.tum")) as f:
        n_tum = sum(1 for line in f if line.strip() and not line.startswith("#"))
    print(f"[evaluate] (d) live viewer: {viewer.n_updates} updates over {LV_FRAMES} scans "
          f"(publish every {LV_PUBLISH_S} s), status {status}, trajectory.tum {n_tum} "
          f"positions, index.html {len(index)} bytes over http://127.0.0.1:{port}/; figure "
          f"{'drawn' if has_mpl else 'off (no matplotlib)'}; kf ATE {r['kf_ate']:.4f} m")
    check(viewer.n_updates >= 1 and status["updates"] == viewer.n_updates,
          f"live viewer: {viewer.n_updates} updates, status {status}")
    check(n_tum == status["frames"] > 0, f"live viewer: {n_tum} TUM positions for {status}")
    check(b"lili_om_tpu_torch" in index, "live viewer: index.html was not served")
    check(os.path.exists(os.path.join(out_dir, "overview.png")) == has_mpl,
          "live viewer: overview.png presence does not follow matplotlib's")
    return {"updates": viewer.n_updates, "status": status}


def check_trace(tmp, frame, scans):
    """(e) ``device_trace`` around main-path ``Frame.step``s: the trace names
    B1's search and map kernels and B4's."""
    with device_trace(os.path.join(tmp, "trace")) as prof:
        for s in scans:
            frame.step(s)
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat", "").lower() == "kernel"]
    found = {what: sum(1 for n in names if key in n) for what, key in (
        ("B1 search", "search_kernel"), ("B1 map", "map_kernel"), ("B4", "segred_kernel"))}
    print(f"[evaluate] (e) device_trace: {os.path.getsize(prof.trace_path)} bytes, "
          f"{len(names)} kernel events over {len(scans)} Frame steps; by kernel {found}")
    check(all(found.values()), f"device_trace: a kernel is missing from the trace: {found}")
    return found


def check_hashgrid(inputs, odo_cfg):
    """(f) ``hashgrid_knn`` on the card at the main path's odometry search
    against B1 on the same inputs: every neighbour within the cell (the
    odometry's NN gate) is found for each query whose 27 neighbour cells
    fall in distinct buckets (the grid's exactness condition). Where two
    share a bucket, a point returned twice can displace a neighbour, in the
    JAX package too: every neighbour missed there must belong to a query
    whose result holds a point twice."""
    q, pts, pm, qm, _ = inputs[("knn_counted", odo_cfg.query_cap, odo_cfg.map_cap, 5)]
    cell = odo_cfg.nn_gate
    grid = build_grid(pts, pm, cell, n_buckets=HG_BUCKETS, bucket_cap=HG_CAP)
    d_g, i_g = hashgrid_knn(q, grid, k=5)
    d_b, i_b = K.knn_counted_cuda(q, pts, 5, pm, qm)
    within = (d_b < cell * cell) & qm[:, None]
    # a neighbour is found when the grid returns its index (or, on a tie in
    # distance, another point at its distance). Slots are not compared one
    # for one: two of a query's 27 cells that hash to one bucket bring its
    # points twice, as in the JAX package
    found = ((i_g[:, None, :] == i_b[:, :, None])
             | torch.isclose(d_g[:, None, :], d_b[:, :, None], rtol=1e-6, atol=0.0)).any(-1)
    hb = torch.sort(neighbour_buckets(q, grid), dim=1).values
    distinct = ~(hb[:, 1:] == hb[:, :-1]).any(-1)
    exact = within & distinct[:, None]
    recall = float((found & exact).sum()) / max(int(exact.sum()), 1)
    recall_all = float((found & within).sum()) / max(int(within.sum()), 1)
    shared = int((~distinct & qm).sum())
    pair = (i_g[:, :, None] == i_g[:, None, :]) & torch.isfinite(d_g)[:, :, None]
    twice = torch.triu(pair, diagonal=1).flatten(1).any(-1) & qm
    dup = int(twice.sum())
    unexplained = int((within & ~found & ~twice[:, None]).sum())
    kept, valid = int(grid.bucket_mask.sum()), int(pm.sum())
    grid_ms = cuda_ms(lambda: hashgrid_knn(q, grid, k=5), iters=5)
    build_ms = cuda_ms(lambda: build_grid(pts, pm, cell, n_buckets=HG_BUCKETS,
                                          bucket_cap=HG_CAP), iters=5)
    b1_ms = cuda_ms(lambda: K.knn_counted_cuda(q, pts, 5, pm, qm), iters=20)
    print(f"[evaluate] (f) hash grid {q.shape[0]}x{pts.shape[0]}, cell {cell} m, "
          f"{HG_BUCKETS}x{HG_CAP} buckets ({kept} of {valid} map points kept): recall inside "
          f"the gate {recall:.6f} over the {int(exact.sum())} neighbours of queries with 27 "
          f"distinct buckets; {shared} valid queries share a bucket among their cells, "
          f"{dup} got a point twice; recall over all {int(within.sum())} neighbours "
          f"{recall_all:.6f}, {unexplained} missed where no point came twice; hashgrid_knn "
          f"{grid_ms:.4f} ms + build {build_ms:.4f} ms, B1 per call {b1_ms:.4f} ms")
    check(recall == 1.0 and unexplained == 0 and kept == valid,
          f"hash grid: recall {recall} inside the gate, {unexplained} neighbours missed "
          f"where no point came twice, {kept} of {valid} points kept")
    return {"recall": recall, "recall_all": recall_all, "shared_bucket_queries": shared,
            "duplicates": dup, "unexplained": unexplained, "grid_ms": grid_ms, "build_ms": build_ms, "b1_ms": b1_ms,
            "kept": kept, "valid": valid}


def new_site_rows(known, knn_seen, seg_seen, launches, names):
    """B1 and B4 against their plain versions at the sites of the evaluate
    path whose shapes no earlier phase compared (``known``: the rows so
    far)."""
    knn_known = {(r["name"].split("[")[0], r["shape"][0], r["shape"][1],
                  int(r["name"].rsplit("_k", 1)[1].split("_")[0]))
                 for r in known if r["name"].startswith(("knn_counted[", "knn_dense["))}
    seg_known = {tuple(r["shape"]) for r in known if r["name"].startswith("segred[")}
    fresh = {("knn_counted",) + key: v for key, v in knn_seen.items()
             if ("knn_counted",) + key not in knn_known}
    rows = compare_sites("evaluate_", fresh, launches, names)
    for key, inputs in sorted(seg_seen.items()):
        if tuple(key[2:]) not in seg_known:
            rows.append(compare_segred("evaluate", key, inputs,
                                       launches.get(("segred",) + key[2:], 0)))
    print(f"[evaluate] kernels at new site shapes: {len(fresh)} B1 sites, "
          f"{sum(1 for r in rows if r['name'].startswith('segred['))} B4 sites "
          f"({len(knn_seen)} and {len(seg_seen)} sites on the path)")
    return rows


def beside(recorders):
    """What this process runs while (a) and (b)'s processes run, the
    phase's recorders disarmed: (h) the backend diagnostic. Returns its
    facts."""
    for r in recorders:
        r.armed = False
    try:
        return diag_run()
    finally:
        for r in recorders:
            r.armed = True


def evaluate_phase(tmp, out, frame, trace_scans, main_inputs, odo_cfg, known_rows):
    """Phase 12 (``out``: ``--out``'s directory or None). Returns (its facts,
    kernel rows at the site shapes that are new on its path)."""
    t0 = time.perf_counter()
    launches = {}
    names = {}
    for name in evaluate_presets.DEFAULT_PRESETS:
        cfg = load_config(name)
        names.update(site_names(cfg.odometry, cfg.fusion, cfg.loop_closure.submap_cap))
    # B1 and B4 inputs at each call site's first call, over (a), (b), (d)
    times, mark = {}, [time.perf_counter()]

    def lap(step):
        now = time.perf_counter()
        times[step], mark[0] = now - mark[0], now

    with Recorder("knn_counted_cuda") as rec, SegRecorder() as seg:
        wall, diag = run_evaluate_ranks(tmp, out, lambda: beside((rec, seg)))
        rows, export = preset_table(tmp, wall, launches, rec.seen, seg.seen)
        facts = {"table": rows, "export": export, "diag_backend": diag}
        facts.update(aggressive_results(tmp, launches, rec.seen, seg.seen))
        lap("(a)+(b)+(c)")
        facts["live"] = check_live_viewer(tmp, launches, names)
        lap("(d)")
    facts["trace"] = check_trace(tmp, frame, trace_scans)
    lap("(e)")
    facts["hashgrid"] = check_hashgrid(main_inputs, odo_cfg)
    lap("(f)")
    facts["seconds"] = time.perf_counter() - t0
    kernel_rows = new_site_rows(known_rows, rec.seen, seg.seen, launches, names)
    lap("kernel checks")
    facts["times"] = times
    print(f"[evaluate] phase {time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in times.items()))
    return facts, kernel_rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--out", default=None, help="directory for a JSON of the results")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    phase_s, t_phase = {}, [time.perf_counter()]

    def phase_done(label):
        """The wall time since the previous phase ended, and the part of it
        spent in the kernel checks."""
        now = time.perf_counter()
        phase_s[label] = (now - t_phase[0], CHECK_S[0])
        t_phase[0], CHECK_S[0] = now, 0.0

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[device] {name}; nvidia-smi: {smi}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}; devices {torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    logs = cuda_build.build(verbose=True)
    secs = time.perf_counter() - t0
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[build] {src}: {line.strip()}")
    print(f"[build] {len(logs)} of {len(cuda_build.SOURCES)} sources compiled in {secs:.2f} s")
    # the native host runtime, built beside the kernels by the host compiler
    native.library()
    check(native.available(), "build: the native runtime did not load")
    print(f"[build] native runtime {native.library_path()} by {cuda_build.cxx_path()} "
          f"({'built in this run' if 'lili_runtime' in logs else 'already built'}; compiler "
          f"output: {logs.get('lili_runtime', '').strip() or 'none'})")

    phase_done("device and build")
    # 3. main path
    cfgs = bench_configs()
    n = N_WARM + N_TIMED
    t0 = time.perf_counter()
    scans, traj = sim_scans(n + 1, device=DEV)
    sync()
    print(f"[sim] {n + 1} scans of {scans[0].img.shape[0]}x{scans[0].img.shape[1]} "
          f"in {time.perf_counter() - t0:.2f} s")
    frame, poses, host_ms, counts, main_seg_counts = run_path(cfgs, scans[:n], "main path")
    main_counts = counts
    check(K.launch_count("knn_counted") >= 3 * n,
          f"main path: {K.launch_count('knn_counted')} kNN launches for {n} scans")
    # every search of the path prepares its map in the call: one
    # preparation a search
    check(K.launch_count("knn_map") == K.launch_count("knn_counted"),
          f"main path: {K.launch_count('knn_map')} map preparations for "
          f"{K.launch_count('knn_counted')} searches")
    check(SG.launch_count() >= n, f"main path: {SG.launch_count()} B4 launches for {n} scans")
    for (w, q, p, _), c in counts.items():
        check(c >= n, f"main path: call site {w}:{q}x{p} launched {c} times for {n} scans")
    for t, q, ft, *_ in poses:
        check(bool(torch.isfinite(t).all() and torch.isfinite(q).all()
                   and torch.isfinite(ft).all()), "main path: a pose is not finite")
    et, er = gt_errors(poses, lambda t: pose_at(traj, t, device=DEV))
    print(f"[main path] odometry vs simulated trajectory: max {et:.4f} m, {er:.5f} rad; "
          f"last scan corr odo/surf/edge {poses[-1][3:]}")
    check(et < GT_TOL_M and er < GT_TOL_RAD,
          f"odometry error {et:.4f} m / {er:.5f} rad against the simulated trajectory")
    with plain_kernels():
        _, poses_plain, host_plain, counts_plain, seg_plain = run_path(cfgs, scans[:n],
                                                                       "plain kernels")
    check(not counts_plain and not seg_plain, "the plain run launched a kernel")
    gt_, gr_ = traj_gap(poses, poses_plain)
    print(f"[main path] kernels vs plain versions, trajectories: max {gt_:.3e} m, "
          f"{gr_:.3e} rad")
    check(gt_ < TRAJ_TOL_M and gr_ < TRAJ_TOL_RAD,
          f"kernel and plain trajectories differ by {gt_:.3e} m / {gr_:.3e} rad")
    main_inputs, main_seg = capture_inputs(frame, scans[n])

    phase_done("main path")
    # 4. large-map path: the dense launch
    big = cfgs._replace(odometry=cfgs.odometry._replace(map_cap=LARGE_MAP))
    big_frame, _, _, big_counts, _ = run_path(big, scans[:N_WARM + 2], "large-map path")
    check(K.launch_count("knn_dense") >= N_WARM + 2
          and K.launch_count("knn_map") == K.launch_count("knn_dense")
          + K.launch_count("knn_counted"),
          f"large-map path: {K.launch_count('knn_dense')} dense launches, "
          f"{K.launch_count('knn_map')} map preparations")
    big_inputs = {key: v for key, v in capture_inputs(big_frame, scans[N_WARM + 2])[0].items()
                  if key[0] == "knn_dense"}

    # 5. kernels against their plain versions
    kernels = compare_sites("", main_inputs, main_counts, site_names(cfgs.odometry, cfgs.fusion))
    kernels += compare_sites("", big_inputs, big_counts,
                             {(cfgs.odometry.query_cap, LARGE_MAP): "odometry_large_map"})
    check({k["name"].split("[")[0] for k in kernels} == {"knn_counted", "knn_dense", "knn_map"},
          "a kernel had no call site to compare")
    # unmasked dense case: no masks, P above the count-bounded limit
    gen = torch.Generator(device=DEV).manual_seed(0)
    box = torch.tensor([60.0, 60.0, 8.0], device=DEV)
    pts = torch.rand((LARGE_MAP, 3), generator=gen, device=DEV) * box - box / 2
    qs = pts[torch.randint(0, LARGE_MAP, (4096,), generator=gen, device=DEV)] \
        + 0.2 * torch.randn((4096, 3), generator=gen, device=DEV)
    unmasked = compare_kernel("knn_dense", f"unmasked_4096x{LARGE_MAP}",
                              (qs.contiguous(), pts, None, None), 0)

    phase_done("large map and kernel checks")
    # 6. system phase, and beside it, in a process of its own, 7. the Livox
    # lap; then B3 at each of the system's call sites and B1 at the Livox
    # lap's, with the card to themselves
    tmp = tempfile.mkdtemp(prefix="lili_livox_")
    try:
        livox = start_child("livox", tmp)
        sys_, sys_ms, sys_counts, sys_inputs, facts, icp_calls, (sys_seg_counts, sys_seg) = \
            system_phase()
        check_system(sys_, sys_ms, sys_counts, facts)
        check(sum(sys_seg_counts.values()) > 0, "system: B4 did not launch")
        if args.out:
            save_icp_attempts(os.path.join(args.out, "icp_attempts.npz"), icp_calls,
                              sys_.lc_cfg)
        lv = join_child(livox, "livox", tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_done("system and livox laps")
    names = site_names(sys_.odo_cfg, sys_.fusion_cfg, sys_.lc_cfg.submap_cap)
    map_rows = []
    for (q, p, k), inputs in sorted(sys_inputs.items()):
        site = f"{names.get((q, p), 'site')}_k{k}_{q}x{p}"
        kernels.append(compare_pruned(site, inputs, k,
                                      sys_counts.get(("knn_pruned", q, p, k), 0)))
        # the map kernels, once per cloud shape (the counts are per shape)
        qs, pts, pm, qm = inputs[:4]
        pts, pm = map_points(pts) if isinstance(pts, K.PrunedMap) else (pts, pm)
        done = {r["shape"][0] for r in map_rows if r["name"].startswith("pruned_keys")}
        for what, cloud, mask, n, is_map in ((f"{names.get((q, p), 'site')}_map", pts, pm, p,
                                              True),
                                             (f"{names.get((q, p), 'site')}_queries", qs, qm, q,
                                              False)):
            if n not in done:
                done.add(n)
                map_rows += compare_pruned_map(
                    f"{what}_{n}", cloud, mask, sys_counts.get(("pruned_keys", 0, n, 0), 0),
                    sys_counts.get(("pruned_scatter", 0, n, 0), 0) if is_map else None)
    kernels += map_rows
    check({n.split("[")[1].split("_k")[0] for n in (x["name"] for x in kernels)
           if n.startswith("knn_pruned")} >= {"icp", "odometry", "fusion_surf", "fusion_edge"},
          "B3: a call site was not recorded")
    sys_rejects = sys_.lc_rejects
    del sys_, sys_inputs, icp_calls
    torch.cuda.empty_cache()

    phase_done("system kernel checks")
    # 7. the Livox lap's kernel checks: B1 at each of its call sites (ICP
    # runs B1 there, on its prepared map)
    lvx_ms, lvx_counts, lvx_seg_counts, lvx_seg, lvx_facts = (
        lv["host_ms"], lv["counts"], lv["seg_counts"], lv["seg_seen"], lv["facts"])
    lvx_rejects = lv["lc_rejects"]
    lvx_rows = compare_sites("livox_", {("knn_counted",) + key: v
                                        for key, v in lv["inputs"].items()},
                             lvx_counts, site_names(lv["odo_cfg"], lv["fusion_cfg"],
                                                    lv["lc_cfg"].submap_cap))
    kernels += lvx_rows
    check({n.split("[livox_")[1].split("_k")[0] for n in (x["name"] for x in lvx_rows)
           if n.startswith("knn_counted[")} >= {"icp", "odometry", "fusion_surf", "fusion_edge"},
          "B1: a call site of the Livox lap was not recorded")
    del lv

    phase_done("livox kernel checks")
    # 8. B4 against its plain version at each call site of the three paths
    for phase, seen, seg_counts in (("main", main_seg, main_seg_counts),
                                    ("system", sys_seg, sys_seg_counts),
                                    ("livox", lvx_seg, lvx_seg_counts)):
        check(bool(seen), f"B4: no call site recorded on the {phase} path")
        for key, inputs in sorted(seen.items()):
            kernels.append(compare_segred(phase, key, inputs,
                                          seg_counts.get(("segred",) + key[2:], 0)))

    phase_done("B4 checks")
    # 9. the runtime entry points, the pruned switch unset, and beside them
    # the soak in a process of its own
    prev = os.environ.pop("LILI_OM_KNN_PRUNED", None)
    tmp = tempfile.mkdtemp(prefix="lili_runtime_")
    try:
        soak = start_child("soak", tmp)
        rt_facts = runtime_phase(tmp, profile=args.profile)
        soak_facts = join_child(soak, "soak", tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if prev is not None:
            os.environ["LILI_OM_KNN_PRUNED"] = prev

    phase_done("runtime and soak")
    # 10. the multi-device path, the pruned switch unset
    prev = os.environ.pop("LILI_OM_KNN_PRUNED", None)
    tmp = tempfile.mkdtemp(prefix="lili_multichip_")
    try:
        mc_rows, mc_facts = multichip_phase(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if prev is not None:
            os.environ["LILI_OM_KNN_PRUNED"] = prev
    kernels += mc_rows

    phase_done("multichip")
    # 12. evaluate, the pruned switch unset
    prev = os.environ.pop("LILI_OM_KNN_PRUNED", None)
    tmp = tempfile.mkdtemp(prefix="lili_evaluate_")
    try:
        ev_facts, ev_rows = evaluate_phase(tmp, args.out, frame, scans[N_WARM:N_WARM + 3],
                                           main_inputs, cfgs.odometry, kernels)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if prev is not None:
            os.environ["LILI_OM_KNN_PRUNED"] = prev
    kernels += ev_rows

    phase_done("evaluate")
    # 11. profile
    if args.profile:
        timed = sorted(host_ms[N_WARM:])
        profile_frames(frame, scans[N_WARM:N_WARM + 5], timed[len(timed) // 2])

    if args.out:
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump({"device": name, "nvidia_smi": smi, "per_scan_host_ms": host_ms,
                       "per_scan_host_ms_plain": host_plain,
                       "system": {"per_scan_host_ms": sys_ms, "lc_rejects": sys_rejects,
                                  **facts},
                       "livox": {"per_scan_host_ms": lvx_ms, "lc_rejects": lvx_rejects,
                                 **lvx_facts},
                       "runtime": rt_facts, "soak": soak_facts, "multichip": mc_facts,
                       "evaluate": ev_facts,
                       "phase_s": phase_s,
                       "kernels": kernels + [unmasked]}, f, indent=1)
    print("[timing] wall s per phase (of it in the kernel checks): " + "; ".join(
        f"{k} {w:.1f} ({c:.1f})" for k, (w, c) in phase_s.items()))
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        for ctx in CHILDREN:
            stop_child(ctx)
