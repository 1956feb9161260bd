"""Full-system orchestrator, spinning-LiDAR variant (port of
``lili_om_tpu/models/system.py``).

Per 0.1 s scan: gyro undistortion + feature extraction → scan-to-map
odometry → on keyframes, sliding-window fusion, a global pose-graph node and
the densified every-frame poses of the local graph. At a lower cadence (the
reference's 1 Hz thread): loop-closure detection → ICP between a latest and
a history submap → global graph re-solve → pose correction, marginalization
prior reset and, on the next keyframe, a rebuild of the fusion map tables.

The host does sequencing and keeps the unbounded keyframe archive; the
compute runs on the system's device. Keyframe clouds are archived as
device tensors and copied to the host once, when a submap first needs them.
On the card every stage time of :attr:`LiliOmSystem.metrics` ends with a
synchronize, so it is the stage's own time there. Stages: ``preprocess``,
``odometry`` and ``backend`` per scan (``fusion`` and ``densify`` inside
``backend``); ``submaps``, ``icp``, ``graph_solve`` and ``lc_inlock`` per
closure attempt.

Two sensor variants share the backend: a spinning LiDAR's organized sweep
goes through :meth:`LiliOmSystem.process_scan`, a Livox Horizon's flat point
stream (line id, time ratio, reflectivity per point) through
:meth:`LiliOmSystem.process_scan_livox`, whose eigen-patch features and
reflectivity channel feed the reflectivity-weighted fusion of the Livox
presets.

The global map (:meth:`LiliOmSystem.build_global_map`,
:meth:`LiliOmSystem.export_map`) is every archived keyframe's full cloud at
its graph pose, downsampled on the host; ``map_callback`` receives it at a
scan-time cadence. The runtime (``runtime/pipeline.py``) drives the
frontend, the backend and the closures on three threads: the carried
states are replaced, never written in place, and the IMU buffer is guarded
by its own lock.

``LiliOmSystem(mesh=…)`` runs the multi-device path: one process per rank
(SPMD over ``torch.distributed``), each with the whole system. The
odometry's matching rounds split the queries over the ranks
(``parallel/sharded.py:make_sharded_odometry``) and fusion splits the local
map (``parallel/map_fusion.py``); the estimator states, the keyframe ring
and the graph stay replicated. Every branch the host takes reads values
that are equal on every rank by construction (all-reduced sums, or the
same arithmetic on the same inputs), so no collective is left unmatched.
Loop-closure detection, ICP and the graph solve run on rank 0 alone, and
rank 0's outcome is broadcast (:meth:`LiliOmSystem.try_loop_closure`);
:meth:`LiliOmSystem.check_replicated` compares a digest of the replicated
state across the ranks.
"""
from __future__ import annotations

import contextlib
import hashlib
import os
import threading
import warnings
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..runtime.native import pcd_write_native
from ..ops.features_livox import LivoxFeatureConfig, bin_livox_image, extract_features_livox
from ..ops.features_spin import (SpinFeatureConfig, extract_features_spin, integrate_gyro,
                                 undistort)
from ..ops.icp import icp_point_to_plane
from ..ops.preintegration import ImuNoise
from ..ops.voxel import pad_cloud, voxel_downsample, voxel_downsample_np
from ..utils.config import LoopClosureConfig
from ..utils.math import (pose_relative, quat_conj_np, quat_mul, quat_mul_np, quat_normalize,
                          quat_normalize_np, quat_rotate, quat_rotate_np)
from ..utils.metrics import StageMetrics
from .fusion import FusionConfig, fusion_step, init_fusion_state
from .local_graph import optimize_local_chain, propagate_interval
from .odometry import OdometryConfig, init_state as init_odo_state, odometry_step
from .pose_graph import (add_loop, add_node, ensure_capacity, init_graph,
                         optimize_graph_chain, set_loop, solve_graph_incremental)

__all__ = ["LiliOmSystem", "LivoxKeyframePayload", "LoopClosureConfig", "mesh_configs"]


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def mesh_configs(odo_cfg: OdometryConfig, fusion_cfg: FusionConfig, n: int):
    """The configs of an ``n``-rank mesh, as the JAX system rounds them:
    fusion builds its maps from the ring (``incremental_map=False``), the
    ring gets ``(−M) mod n`` permanently invalid pad slots so its slots
    divide the mesh (the ring cursor stays modulo M), the map caps are
    rounded up to a multiple of n, and so is ``query_cap`` when n does not
    divide it. Returns (odo_cfg, fusion_cfg)."""
    rnd = lambda x: -(-x // n) * n  # noqa: E731
    fusion_cfg = fusion_cfg._replace(
        incremental_map=False, map_slots_pad=(-fusion_cfg.local_map_width) % n,
        map_surf_cap=rnd(fusion_cfg.map_surf_cap), map_edge_cap=rnd(fusion_cfg.map_edge_cap))
    if odo_cfg.query_cap % n:
        odo_cfg = odo_cfg._replace(query_cap=rnd(odo_cfg.query_cap))
    return odo_cfg, fusion_cfg


def _host_tree(tree):
    """A NamedTuple of tensors (nested ones too) with numpy leaves."""
    return type(tree)(*[_host_tree(v) if hasattr(v, "_fields") else _np(v) for v in tree])


def _device_tree(tree, device):
    """:func:`_host_tree`'s inverse, on ``device``."""
    return type(tree)(*[_device_tree(v, device) if hasattr(v, "_fields")
                        else torch.as_tensor(v).to(device) for v in tree])


def _leaves(tree):
    for v in tree:
        yield from (_leaves(v) if hasattr(v, "_fields") else (v,))


def _reskew(pts, rel_time, trans):
    """The reference's ``if_to_deskew`` republish transform: each point
    shifted by its sweep-time fraction of the frame's relative translation."""
    return pts + torch.clamp(rel_time, 0.0, 1.0)[:, None] * trans[None, :]


def _preprocess_spin(img, valid, rel_time, dts, gyrs, imu_mask, t_scan, q_lb,
                     cfg: SpinFeatureConfig, device):
    """Gyro undistortion + feature extraction. ``q_lb`` is the lidar←IMU
    extrinsic: the gyro delta is rotated into the lidar frame as
    ``q_lb·q_si·q_lb⁻¹``."""
    q_scan = integrate_gyro(dts, gyrs, imu_mask)
    flat = undistort(img.reshape(-1, 3), rel_time.reshape(-1), q_scan, q_lb=q_lb,
                     t_scan=t_scan)
    return extract_features_spin(flat.reshape(img.shape), valid, rel_time, cfg, device=device)


class LivoxKeyframePayload(NamedTuple):
    """The Livox path's deferred-backend handoff: what the backend needs of
    a keyframe (the spin path hands its ``FeatureClouds`` instead)."""

    surf: torch.Tensor
    surf_mask: torch.Tensor
    surf_refl: torch.Tensor
    edge: torch.Tensor
    edge_mask: torch.Tensor
    full_pts: torch.Tensor
    full_mask: torch.Tensor


class LiliOmSystem:
    """End-to-end LiDAR-inertial SLAM engine, spinning-LiDAR and Livox
    wiring. Runs on ``device`` (None = the CUDA device)."""

    # unconsumed IMU backlog bound (~14 min at 200 Hz); consumed samples are
    # trimmed as keyframes integrate past them (_trim_imu)
    IMU_BACKLOG_CAP = 1 << 18

    def __init__(self, odo_cfg: OdometryConfig = OdometryConfig(),
                 fusion_cfg: FusionConfig = FusionConfig(),
                 feat_cfg: SpinFeatureConfig = SpinFeatureConfig(),
                 livox_cfg: LivoxFeatureConfig = LivoxFeatureConfig(),
                 lc_cfg: LoopClosureConfig | None = None, noise: ImuNoise = ImuNoise(),
                 graph_capacity: int = 512, q0=None, dtype=torch.float32, mesh=None,
                 device=None):
        """``mesh``: a 1-D ``DeviceMesh`` (``parallel/sharded.py:make_mesh``)
        switches to the multi-device path (see the module docstring); every
        rank constructs its system with the same arguments, on the mesh's
        device for the rank (``device`` must then be None or of the mesh's
        type). The configs are rounded to the mesh as the JAX package rounds
        them (:func:`mesh_configs`)."""
        self.mesh = mesh
        self._sharded_odo = self._dist_warm = self._dist_main = self.slot_blocks = None
        self._closure_group = None  # the mesh's group unless set_process_groups names one
        if mesh is None:
            self.device = resolve_device(device)
        else:
            from ..parallel.map_fusion import make_map_sharded_system_step
            from ..parallel.sharded import make_sharded_odometry, mesh_device

            self.device = mesh_device(mesh)
            if device is not None and torch.device(device).type != self.device.type:
                raise ValueError(f"device {device} is not the mesh's ({mesh.device_type})")
            odo_cfg, fusion_cfg = mesh_configs(odo_cfg, fusion_cfg, mesh.size())
            self._dist_warm, self._dist_main, self.slot_blocks = \
                make_map_sharded_system_step(mesh, fusion_cfg, noise)
            self._sharded_odo = make_sharded_odometry(mesh, odo_cfg)
        self.odo_cfg, self.fusion_cfg, self.feat_cfg = odo_cfg, fusion_cfg, feat_cfg
        self.livox_cfg = livox_cfg
        self.lc_cfg = LoopClosureConfig() if lc_cfg is None else lc_cfg
        self.noise = noise
        self.dtype = dtype
        self._np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
        self.odo_state = init_odo_state(odo_cfg, dtype=dtype, device=self.device)
        self.fusion_state = init_fusion_state(fusion_cfg, noise, q0=q0, dtype=dtype,
                                              device=self.device)
        self.graph = init_graph(graph_capacity, dtype=dtype, device=self.device)
        # host-side keyframe archive (unbounded): device (pts, mask) tuples
        # until first use, then host numpy, or a path once spilled
        self.kf_stamps: list[float] = []
        self.kf_clouds: list = []  # surf clouds, sensor frame
        self.kf_edge_clouds: list = []  # edge clouds, sensor frame
        self.kf_full_clouds: list = []  # full clouds, voxel-bounded at insert
        self.full_cloud_leaf = 0.3  # mapping_ds
        self.full_cloud_cap = 16384
        # long runs: spill keyframe clouds older than ``archive_keep_recent``
        # to ``archive_spill_dir`` (see spill_archives)
        self.archive_spill_dir: str | None = None
        self.archive_keep_recent: int = 256
        self._spill_marks: dict[str, int] = {}
        self.kf_positions: list = []
        self.n_frames = 0
        self.trajectory: list[np.ndarray] = []  # per-frame odometry positions
        self.last_loop_stamp = -1e9
        self._loop_pairs: list[tuple[int, int]] = []
        self.lc_rejects = {"no_candidate": 0, "fitness": 0, "max_correction": 0}
        self._imu_stamps = np.zeros((0,))
        self._imu_accs = np.zeros((0, 3))
        self._imu_gyrs = np.zeros((0, 3))
        # producers push while the backend trims: the three arrays change
        # together under this lock
        self._imu_lock = threading.Lock()
        self._last_kf_stamp: float | None = None
        self.scan_period = 0.1
        self.metrics = StageMetrics(
            sync=torch.cuda.synchronize if self.device.type == "cuda" else None)
        # constant-velocity translation deskew of the frontend input (off:
        # the reference deskews rotation only), bounded per sweep
        self.deskew_translation = False
        self.max_sweep_translation = 1.0
        self._last_rel_t = np.zeros(3)
        # the reference's ``if_to_deskew`` republish option
        self.if_to_deskew = False
        # hierarchical local pose graph: every-frame poses between keyframes
        self.densify_frames = True
        self._starved_frames = 0
        self.dense_trajectory: list[tuple[float, np.ndarray, np.ndarray]] = []
        self._frame_stamps: list[float] = []
        self._prev_kf = None  # (stamp, t, q, v) of the previous keyframe
        self._kf_count_host = 0  # mirrors fusion_state.kf_count without a sync
        # a loop closure moved the mature poses: the next fusion step
        # rebuilds its map tables from the ring
        self._maps_dirty = False
        # cadenced map assembly (the reference's publishCompleteMap thread,
        # BackendFusion.cpp:2687-2696): ``map_callback`` receives the (N,3)
        # global map every ``map_publish_period`` seconds of scan time, every
        # ``mapping_interval``-th keyframe (the presets' mapping_interval)
        self.map_callback = None
        self.map_publish_period = 50.0
        self.mapping_interval = 2
        self._last_map_pub: float | None = None

    def _tensor(self, a, dtype=None):
        """Host array, list or tensor → a tensor on the system's device."""
        if not isinstance(a, torch.Tensor):
            a = torch.as_tensor(np.asarray(a))
        return a.to(device=self.device, dtype=dtype or self.dtype)

    def set_process_groups(self, frontend=None, backend=None):
        """Under a mesh: the process groups the collectives go on, one per
        thread that issues them (``runtime/pipeline.py``). ``frontend``
        takes the sharded odometry's all-reduces; ``backend`` the map-shard
        fusion's gathers and the closure outcome's broadcast. None: the
        mesh's own group."""
        from ..parallel.map_fusion import make_map_sharded_system_step
        from ..parallel.sharded import make_sharded_odometry

        self._dist_warm, self._dist_main, _ = make_map_sharded_system_step(
            self.mesh, self.fusion_cfg, self.noise, group=backend)
        self._sharded_odo = make_sharded_odometry(self.mesh, self.odo_cfg, group=frontend)
        self._closure_group = backend

    # ------------------------------------------------------------------
    # IMU stream
    # ------------------------------------------------------------------

    def set_initial_orientation(self, q0) -> bool:
        """Seed the window orientation from the IMU's orientation quaternion
        (w,x,y,z). No-op once a keyframe exists; returns whether it applied."""
        if self._kf_count_host > 0:
            return False
        q = np.asarray(q0, float).reshape(4)
        n = np.linalg.norm(q)
        if not np.isfinite(n) or n < 1e-6:
            return False
        W = self.fusion_cfg.window
        self.fusion_state = self.fusion_state._replace(q=self._tensor(q / n).repeat(W, 1))
        return True

    def push_imu(self, stamps, accs, gyrs):
        """Append IMU samples (monotone stamps), ahead of the scans they cover."""
        with self._imu_lock:
            self._imu_stamps = np.concatenate([self._imu_stamps, np.atleast_1d(stamps)])
            self._imu_accs = np.concatenate([self._imu_accs, np.atleast_2d(accs)])
            self._imu_gyrs = np.concatenate([self._imu_gyrs, np.atleast_2d(gyrs)])
            if len(self._imu_stamps) > self.IMU_BACKLOG_CAP:
                warnings.warn(
                    f"IMU backlog {len(self._imu_stamps)} exceeds {self.IMU_BACKLOG_CAP} "
                    "samples — dropping oldest; early keyframe intervals will integrate no IMU")
                self._imu_stamps = self._imu_stamps[-self.IMU_BACKLOG_CAP:]
                self._imu_accs = self._imu_accs[-self.IMU_BACKLOG_CAP:]
                self._imu_gyrs = self._imu_gyrs[-self.IMU_BACKLOG_CAP:]

    def imu_buffer(self):
        """(stamps, accs, gyrs) of the unconsumed IMU samples, taken together."""
        with self._imu_lock:
            return self._imu_stamps, self._imu_accs, self._imu_gyrs

    def _trim_imu(self, before: float):
        """Drop consumed samples (stamp ≤ ``before``)."""
        with self._imu_lock:
            n_drop = int(np.searchsorted(self._imu_stamps, before, side="right"))
            if n_drop > 0:
                self._imu_stamps = self._imu_stamps[n_drop:]
                self._imu_accs = self._imu_accs[n_drop:]
                self._imu_gyrs = self._imu_gyrs[n_drop:]

    def _imu_slice(self, t0: float, t1: float):
        """Samples with t0 < stamp ≤ t1, plus dts (the first from t0)."""
        s, accs, gyrs = self.imu_buffer()
        idx = np.where((s > t0) & (s <= t1))[0]
        if len(idx) == 0:
            return None
        stamps = s[idx]
        dts = stamps - np.concatenate([[t0], stamps[:-1]])
        return dts, accs[idx], gyrs[idx]

    def _padded_imu(self, sl, cap: int):
        """A slice padded to ``cap`` samples as device tensors (dts, accs,
        gyrs, mask), assembled on the host and copied once each."""
        d = np.zeros((cap,), self._np_dtype)
        a = np.zeros((cap, 3), self._np_dtype)
        g = np.zeros((cap, 3), self._np_dtype)
        m = np.zeros((cap,), bool)
        if sl is not None:
            n = min(len(sl[0]), cap)
            d[:n], a[:n], g[:n], m[:n] = sl[0][:n], sl[1][:n], sl[2][:n], True
        return self._tensor(d), self._tensor(a), self._tensor(g), self._tensor(m, torch.bool)

    # ------------------------------------------------------------------
    # per-scan path
    # ------------------------------------------------------------------

    def _gyro_slice_padded(self, stamp, cap: int = 64):
        """Fixed-capacity (dts, gyrs, mask) over the sweep [stamp, stamp+period]."""
        dts, _, gyrs, mask = self._padded_imu(
            self._imu_slice(stamp, stamp + self.scan_period), cap)
        return dts, gyrs, mask

    def process_scan(self, img, valid, rel_time, stamp: float, defer_backend: bool = False):
        """One organized spinning-LiDAR sweep (R,C,3). IMU samples covering
        the sweep must already be pushed (:meth:`push_imu`). Returns the
        frontend output; with ``defer_backend``, ``(out, clouds or None)``
        and the keyframe goes to :meth:`process_keyframe` later."""
        self.metrics.count_scan()
        img = self._tensor(img)
        rel_time = self._tensor(rel_time)
        with self.metrics.stage("preprocess"):
            dts, gyrs, imu_mask = self._gyro_slice_padded(stamp)
            t_scan = self._tensor(self._last_rel_t if self.deskew_translation else np.zeros(3))
            fcfg = (self.feat_cfg._replace(carry_rel_time=True) if self.if_to_deskew
                    else self.feat_cfg)
            fc = _preprocess_spin(img, self._tensor(valid, torch.bool), rel_time, dts, gyrs,
                                  imu_mask, t_scan, self._tensor(self.fusion_cfg.q_lb), fcfg,
                                  self.device)
        out, summary = self._odometry(fc.surf_pts, fc.surf_mask, stamp,
                                      "check n_cols/ring mapping and feature thresholds")
        if self.if_to_deskew and out.is_keyframe:
            rt = self._tensor(summary[3:6])
            fc = fc._replace(surf_pts=_reskew(fc.surf_pts, fc.surf_rel_time, rt),
                             edge_pts=_reskew(fc.edge_pts, fc.edge_rel_time, rt),
                             full_pts=_reskew(fc.full_pts, fc.full_rel_time, rt))
        if defer_backend:
            return out, (fc if out.is_keyframe else None)
        if out.is_keyframe:
            with self.metrics.stage("backend"):
                self._on_keyframe(fc, stamp)
        self._maybe_publish_map(stamp)
        return out

    def _odometry(self, surf, surf_mask, stamp: float, starved_hint: str):
        """Scan-to-map odometry, then one host transfer of what the frame's
        control flow needs: the trajectory, the sweep translation for the
        next deskew and the feature-starvation watchdog. Returns (out with a
        host ``is_keyframe``, the host summary [t, rel_t, kf, n_corr])."""
        with self.metrics.stage("odometry"):
            # 8 bootstrap rounds for the first two frames
            rounds = (self.odo_cfg.max_rounds if self.n_frames < 2
                      else self.odo_cfg.scan_match_cnt)
            if self._sharded_odo is not None:
                self.odo_state, out = self._sharded_odo(self.odo_state, surf, surf_mask,
                                                        n_rounds=rounds)
            else:
                self.odo_state, out = odometry_step(self.odo_state, surf, surf_mask,
                                                    self.odo_cfg, n_rounds=rounds,
                                                    device=self.device)
        self.n_frames += 1
        summary = _np(torch.cat([out.t, out.rel_t, torch.stack([
            out.is_keyframe.to(self.dtype), out.n_corr.to(self.dtype)])]))
        out = out._replace(is_keyframe=bool(summary[6] > 0.5))
        self.trajectory.append(summary[0:3])
        self._frame_stamps.append(stamp)
        if self.deskew_translation:
            rt = summary[3:6]
            nrm = float(np.linalg.norm(rt))
            if nrm > self.max_sweep_translation:
                rt = rt * (self.max_sweep_translation / nrm)
            self._last_rel_t = rt
        # feature-starvation watchdog
        if int(summary[7]) == 0 and self.n_frames > 2:
            self._starved_frames += 1
            if self._starved_frames in (3, 50, 500):
                warnings.warn(f"no surf correspondences for {self._starved_frames} frames — "
                              + starved_hint)
        else:
            self._starved_frames = 0
        return out, summary

    def _undistort_with_buffer(self, flat_pts, rel_flat, stamp):
        """The Livox path's gyro undistortion over the sweep, plus the
        translation deskew ``+ ratio·t_rel`` when ``deskew_translation`` is
        on (the sensor advanced by ratio·t_rel when the point was taken)."""
        dts, gyrs, imu_mask = self._gyro_slice_padded(stamp)
        q_scan = integrate_gyro(dts, gyrs, imu_mask)
        t_scan = self._tensor(self._last_rel_t) if self.deskew_translation else None
        return undistort(flat_pts, rel_flat, q_scan, t_scan=t_scan)

    def process_scan_livox(self, pts, line, ratio, refl, valid, stamp: float,
                           defer_backend: bool = False):
        """One Livox sweep as flat point arrays (N,·): xyz, line id 0..5, time
        ratio in [0, 1), reflectivity (the curvature channel is
        0.1·reflectivity, as the reference's FormatConvert packs it). IMU
        samples covering the sweep must already be pushed. Returns the
        frontend output; with ``defer_backend``, ``(out, LivoxKeyframePayload
        or None)`` and the keyframe goes to :meth:`process_keyframe` later.

        ``livox_cfg.n_cols`` must match the stream's points per line per
        sweep, or the extractor starves (``ops/features_livox.py``)."""
        self.metrics.count_scan()
        pts = self._tensor(pts)
        ratio = self._tensor(ratio)
        valid = self._tensor(valid, torch.bool)
        with self.metrics.stage("preprocess"):
            pts = self._undistort_with_buffer(pts, ratio, stamp)
            img, img_curv, img_valid = bin_livox_image(
                pts, self._tensor(line, torch.int32), ratio, 0.1 * self._tensor(refl), valid,
                self.livox_cfg)
            lf = extract_features_livox(img, img_curv, img_valid, self.livox_cfg,
                                        device=self.device)
            # the surf set bounded to the odometry capacity by a 0.3 m voxel
            # downsample; the reflectivity (and under if_to_deskew the point
            # time) is averaged alongside, as PCL's VoxelGrid averages intensity
            feats = (torch.stack([lf.surf_curv, lf.surf_rel_time], dim=1) if self.if_to_deskew
                     else lf.surf_curv[:, None])
            surf, surf_refl, surf_mask = voxel_downsample(lf.surf_pts, lf.surf_mask, 0.3,
                                                          self.odo_cfg.scan_cap, feats=feats)
        out, summary = self._odometry(surf, surf_mask, stamp,
                                      "check feature thresholds and scan binning")

        payload = None
        if out.is_keyframe:
            edge, edge_mask = pad_cloud(lf.edge_pts, lf.edge_mask, self.fusion_cfg.kf_edge_cap)
            full, surf_kf = pts, surf
            if self.if_to_deskew:
                rt = self._tensor(summary[3:6])
                surf_kf = _reskew(surf, surf_refl[:, 1], rt)
                edge_rel, _ = pad_cloud(lf.edge_rel_time[:, None].expand(-1, 3), lf.edge_mask,
                                        self.fusion_cfg.kf_edge_cap)
                edge = _reskew(edge, edge_rel[:, 0], rt)
                full = _reskew(pts, ratio, rt)
            payload = LivoxKeyframePayload(surf_kf, surf_mask, surf_refl[:, 0], edge, edge_mask,
                                           full, valid)
        if defer_backend:
            return out, payload
        if payload is not None:
            with self.metrics.stage("backend"):
                self._on_livox_keyframe(payload, stamp)
        self._maybe_publish_map(stamp)
        return out

    def process_keyframe(self, fc, stamp: float):
        """Backend half of a deferred keyframe (see ``defer_backend``): the
        spin path's ``FeatureClouds`` or the Livox path's
        :class:`LivoxKeyframePayload`."""
        with self.metrics.stage("backend"):
            if isinstance(fc, LivoxKeyframePayload):
                self._on_livox_keyframe(fc, stamp)
            else:
                self._on_keyframe(fc, stamp)
        self._maybe_publish_map(stamp)

    def _maybe_publish_map(self, stamp: float):
        """Call ``map_callback`` with the global map at the publish cadence
        (scan-time clock; 50 s default = the reference's 0.02 Hz map thread,
        BackendFusion.cpp:2689)."""
        if self.map_callback is None:
            return
        if self._last_map_pub is None:
            self._last_map_pub = stamp
            return
        if stamp - self._last_map_pub >= self.map_publish_period:
            self._last_map_pub = stamp
            self.map_callback(self.build_global_map(interval=self.mapping_interval))

    def _on_livox_keyframe(self, p: LivoxKeyframePayload, stamp):
        self._on_keyframe_clouds(p.surf, p.surf_mask, p.surf_refl, p.edge, p.edge_mask, stamp,
                                 full=(p.full_pts, p.full_mask))

    def _on_keyframe(self, fc, stamp):
        self._on_keyframe_clouds(fc.surf_pts, fc.surf_mask, torch.zeros_like(fc.surf_pts[:, 0]),
                                 fc.edge_pts, fc.edge_mask, stamp,
                                 full=(fc.full_pts, fc.full_mask))

    def _on_keyframe_clouds(self, sp, sm, s_refl, ep, em, stamp, full=None):
        cfg = self.fusion_cfg
        if s_refl.shape[0] != sp.shape[0]:
            s_refl = torch.zeros_like(sp[:, 0])
        # IMU interval since the last keyframe
        if self._last_kf_stamp is None:
            # first keyframe: seed the midpoint chain with the sample at the
            # keyframe stamp (a dt = 0 step that sets acc0/gyr0)
            sl = None
            stamps, accs, gyrs = self.imu_buffer()
            if len(stamps) > 0:
                near = np.searchsorted(stamps, stamp)
                j = min(max(near - 1, 0), len(stamps) - 1)
                sl = (np.zeros(1), accs[j:j + 1], gyrs[j:j + 1])
        else:
            sl = self._imu_slice(self._last_kf_stamp, stamp)
        self._last_kf_stamp = stamp
        dts, accs, gyrs, vmask = self._padded_imu(sl, cfg.imu_cap)

        warm = self._kf_count_host + 1 < cfg.window
        self._kf_count_host += 1
        rebuild, self._maps_dirty = self._maps_dirty, False
        with self.metrics.stage("fusion"):
            if self._dist_main is not None:
                # the mesh's maps come from the ring at every keyframe:
                # there are no tables to rebuild
                fn = self._dist_warm if warm else self._dist_main
                self.fusion_state, fout = fn(self.fusion_state, sp, sm, s_refl, ep, em, dts,
                                             accs, gyrs, vmask)
            else:
                self.fusion_state, fout = fusion_step(
                    self.fusion_state, sp, sm, s_refl, ep, em, dts, accs, gyrs, vmask, cfg,
                    self.noise, warmup=warm, rebuild=rebuild, device=self.device)
        self.last_fusion_out = fout
        self.graph = ensure_capacity(self.graph, len(self.kf_stamps) + 1)
        self.graph = add_node(self.graph, fout.t_latest, fout.q_latest)
        if self.densify_frames:
            with self.metrics.stage("densify"):
                self._densify_interval(stamp, fout)
        self._prev_kf = (stamp, fout.t_latest, fout.q_latest, fout.v_latest)
        self.kf_stamps.append(stamp)
        self.kf_positions.append(fout.t_latest)
        # archive lazily: device tensors now, host numpy on first use
        self.kf_clouds.append((sp, sm))
        self.kf_edge_clouds.append((ep, em))
        if full is not None:
            self.kf_full_clouds.append(voxel_downsample(full[0], full[1], self.full_cloud_leaf,
                                                        self.full_cloud_cap))
        else:
            self.kf_full_clouds.append((sp, sm))
        # one scan period of margin for sweep-boundary undistortion
        self._trim_imu(stamp - self.scan_period)
        self.spill_archives()

    # ------------------------------------------------------------------
    # keyframe archive
    # ------------------------------------------------------------------

    def _kf_cloud_np(self, i: int, archive=None) -> np.ndarray:
        """Archived keyframe cloud i on the host: copied from the device on
        first use and cached in place (unless archives spill), or reloaded
        from its spill file."""
        if archive is None:
            archive = self.kf_clouds
        c = archive[i]
        if isinstance(c, tuple):
            sp, sm = c
            c = _np(sp[sm])
            if self.archive_spill_dir is None:
                archive[i] = c
        elif isinstance(c, str):
            return np.load(c)
        return c

    def spill_archives(self) -> int:
        """Move keyframe clouds older than ``archive_keep_recent`` to
        ``archive_spill_dir`` as .npy files (no-op unless it is set).
        Returns the number of clouds spilled."""
        if self.archive_spill_dir is None:
            return 0
        os.makedirs(self.archive_spill_dir, exist_ok=True)
        n_spilled = 0
        hi = len(self.kf_stamps) - self.archive_keep_recent
        for name, archive in (("surf", self.kf_clouds), ("edge", self.kf_edge_clouds),
                              ("full", self.kf_full_clouds)):
            lo = self._spill_marks.get(name, 0)
            for i in range(lo, min(hi, len(archive))):
                if not isinstance(archive[i], str):
                    path = os.path.join(self.archive_spill_dir, f"{name}_{i:07d}.npy")
                    np.save(path, self._kf_cloud_np(i, archive))
                    archive[i] = path
                    n_spilled += 1
            self._spill_marks[name] = max(lo, min(hi, len(archive)))
        return n_spilled

    def _world_cloud_np(self, i: int, g_t, g_q, archive=None) -> np.ndarray:
        """Archived sensor-frame cloud i → world: the lidar→body extrinsic,
        then keyframe pose i (host numpy)."""
        c = self._kf_cloud_np(i, archive)
        if len(c) == 0:
            return c.reshape(0, 3)
        q_lb = np.asarray(self.fusion_cfg.q_lb, c.dtype)
        t_lb = np.asarray(self.fusion_cfg.t_lb, c.dtype)
        cb = quat_rotate_np(quat_conj_np(q_lb)[None, :], c - t_lb[None, :])
        return quat_rotate_np(np.broadcast_to(np.asarray(g_q[i], c.dtype), (len(cb), 4)), cb) \
            + np.asarray(g_t[i], c.dtype)

    # ------------------------------------------------------------------
    # failure detection and recovery
    # ------------------------------------------------------------------

    def health_check_and_recover(self) -> bool:
        """On a non-finite estimator state, re-seed the fusion window from
        the last finite keyframe pose, keeping the map history. Returns True
        when a recovery happened."""
        fs = self.fusion_state
        if bool(torch.isfinite(torch.cat([fs.t.reshape(-1), fs.q.reshape(-1),
                                          fs.v.reshape(-1)])).all()):
            return False
        t_seed, q_seed = np.zeros(3), np.array([1.0, 0, 0, 0])
        for i in range(len(self.kf_positions) - 1, -1, -1):
            if np.all(np.isfinite(_np(self.kf_positions[i]))):
                t_seed, q_seed = _np(self.kf_positions[i]), _np(self.graph.q[i])
                break
        W = self.fusion_cfg.window
        z = torch.zeros((W, 3), dtype=self.dtype, device=self.device)
        self.fusion_state = fs._replace(
            t=self._tensor(t_seed).repeat(W, 1), q=self._tensor(q_seed).repeat(W, 1),
            v=z, ba=z.clone(), bg=z.clone(),
            prior=fs.prior._replace(valid=torch.zeros((), dtype=torch.bool, device=self.device)),
            sb_anchor_on=torch.ones((), dtype=torch.bool, device=self.device))
        return True

    def _densify_interval(self, stamp, fout, cap: int = 8):
        """Local pose graph: IMU-propagate the non-keyframe frames between
        the previous and this keyframe, then chain-solve them anchored at
        both keyframe poses."""
        if self._prev_kf is None:
            self.dense_trajectory.append((stamp, _np(fout.t_latest), _np(fout.q_latest)))
            return
        s0, t0, q0, v0 = self._prev_kf
        mids = [f for f in self._frame_stamps if s0 < f < stamp]
        if not mids:
            self.dense_trajectory.append((stamp, _np(fout.t_latest), _np(fout.q_latest)))
            return
        sl = self._imu_slice(s0, stamp)
        if sl is None:
            return
        icap = 64
        n = min(len(sl[0]), icap)
        d, a, g, vm = self._padded_imu(sl, icap)
        # sample index of each frame boundary within the IMU slice
        stamps_abs = s0 + np.cumsum(_np(d)[:n])
        frames = (mids + [stamp])[:cap]
        fidx = np.zeros((cap,), np.int32)
        fidx[:len(frames)] = np.minimum(np.searchsorted(stamps_abs, np.asarray(frames)),
                                        max(n - 1, 0))
        fmask = np.arange(cap) < len(frames)
        t0, q0, v0 = (self._tensor(x) for x in (t0, q0, v0))
        fmask_t = self._tensor(fmask, torch.bool)
        t_init, q_init = propagate_interval(t0, q0, v0, d, a, g, vm,
                                            self._tensor(fidx, torch.int32), fmask_t,
                                            self.noise)
        chain = optimize_local_chain(t_init, q_init, fmask_t, t0, q0, fout.t_latest,
                                     fout.q_latest, n_iters=8)
        F = chain.t.shape[0]
        packed = _np(torch.cat([chain.t.reshape(-1), chain.q.reshape(-1), fout.t_latest,
                                fout.q_latest]))  # one transfer
        ct, cq = packed[:3 * F].reshape(F, 3), packed[3 * F:7 * F].reshape(F, 4)
        for i, f in enumerate(frames[:-1]):
            self.dense_trajectory.append((f, ct[i], cq[i]))
        self.dense_trajectory.append((stamp, packed[7 * F:7 * F + 3],
                                      packed[7 * F + 3:7 * F + 7]))

    # ------------------------------------------------------------------
    # loop closure (call at ~1 Hz)
    # ------------------------------------------------------------------

    def _graph_poses_np(self, g, n: int):
        """(t (n,3), q (n,4)) of graph ``g`` on the host, in one transfer."""
        tq = _np(torch.cat([g.t[:n], g.q[:n]], dim=1))
        return tq[:, :3].copy(), tq[:, 3:].copy()

    def try_loop_closure(self, lock=None) -> bool:
        """One detection + closure attempt (:meth:`_attempt_closure`).

        Under a mesh every rank calls it at the same point of the stream:
        rank 0 alone attempts the closure, then broadcasts the outcome
        (fired or not, the graph, the loop pairs, the debounce stamp and
        the reject counters); the other ranks take rank 0's graph and, when
        it fired, apply the same pose correction to their replicated
        states. Returns whether a closure fired, on every rank."""
        if self.mesh is None:
            return self._attempt_closure(lock)
        from ..parallel.sharded import broadcast_object

        out = None
        if self.mesh.get_local_rank() == 0:
            fired = self._attempt_closure(lock)
            out = (fired, _host_tree(self.graph) if fired else None, list(self._loop_pairs),
                   self.last_loop_stamp, dict(self.lc_rejects))
        fired, graph, pairs, stamp, rejects = broadcast_object(self.mesh, out,
                                                               group=self._closure_group)
        if self.mesh.get_local_rank() != 0:
            self._loop_pairs, self.last_loop_stamp, self.lc_rejects = pairs, stamp, rejects
            if fired:
                self.graph = _device_tree(graph, self.device)
                self._correct_poses()
        return fired

    def replicated_digest(self) -> str:
        """SHA-256 of the state every rank of a mesh holds alike: the
        odometry and fusion states (the keyframe ring included), the graph,
        the per-frame trajectory and the keyframe stamps."""
        h = hashlib.sha256()
        for tree in (self.odo_state, self.fusion_state, self.graph):
            for a in _leaves(_host_tree(tree)):
                h.update(np.ascontiguousarray(a).tobytes())
        h.update(np.asarray(self.trajectory, np.float64).tobytes())
        h.update(np.asarray(self.kf_stamps, np.float64).tobytes())
        return h.hexdigest()

    def check_replicated(self) -> bool:
        """Under a mesh: whether every rank's :meth:`replicated_digest` is
        equal. If not, rank 0's odometry and fusion states, graph, trajectory
        and keyframe stamps are broadcast and taken by every rank, and False
        is returned (the ranks had diverged). Every rank must call it."""
        from ..parallel.sharded import broadcast_object, gather_objects

        if len(set(gather_objects(self.mesh, self.replicated_digest()))) == 1:
            return True
        snap = None
        if self.mesh.get_local_rank() == 0:
            snap = (_host_tree(self.odo_state), _host_tree(self.fusion_state),
                    _host_tree(self.graph), list(self.trajectory), list(self.kf_stamps))
        odo, fus, graph, self.trajectory, self.kf_stamps = broadcast_object(self.mesh, snap)
        self.odo_state = _device_tree(odo, self.device)
        self.fusion_state = _device_tree(fus, self.device)
        self.graph = _device_tree(graph, self.device)
        return False

    def _attempt_closure(self, lock=None) -> bool:
        """One detection + closure attempt.

        * The closure anchors at the mature keyframe ``n − window``, the
          newest pose that has left the optimization window.
        * Candidates within ``search_radius`` of it, nearest first; the
          first older than ``time_thres`` wins (with the Livox fallback tier
          when ``local_time_thres`` is set).
        * ICP aligns the latest submap to the history submap; the corrected
          mature pose gives the loop factor mature → candidate, its noise
          scaled by the fitness.

        ``lock``: optional mutex protecting the estimator state. It is held
        only for the snapshot and update phases; the submaps, ICP and the
        graph solve run unlocked, and keyframes appended meanwhile are
        re-chained by the correction of the last solved node."""
        lc = self.lc_cfg
        held = (lambda: lock) if lock is not None else contextlib.nullcontext

        # phase 1a (locked): snapshot
        with held():
            with self.metrics.stage("lc_inlock"):
                n = len(self.kf_stamps)
                mature = n - self.fusion_cfg.window
                if not lc.enabled or mature < 1:
                    return False
                stamps = np.asarray(self.kf_stamps)
                newest_stamp = float(stamps[-1])
                if abs(self.last_loop_stamp - newest_stamp) < lc.debounce:
                    return False
                graph_snap = self.graph

        # phase 1b (unlocked): candidate detection + submaps
        g_t, g_q = self._graph_poses_np(graph_snap, n)
        d = np.linalg.norm(g_t - g_t[mature], axis=1)
        dt_all = np.abs(newest_stamp - stamps)
        in_r = np.where(d < lc.search_radius)[0]
        order = in_r[np.argsort(d[in_r])]
        old_enough = order[dt_all[order] > lc.time_thres]
        if len(old_enough):
            his = int(old_enough[0])
        elif lc.local_time_thres is not None:
            band = order[(dt_all[order] > lc.local_time_thres) & (dt_all[order] < lc.time_thres)]
            if len(band) == 0:
                self.lc_rejects["no_candidate"] += 1
                return False
            his = int(band[np.argmax(dt_all[band])])
        else:
            self.lc_rejects["no_candidate"] += 1
            return False
        with self.metrics.stage("submaps"):
            src = self._submap(mature - lc.latest_width + 1, mature, g_t, g_q)
            tgt = self._submap(his - lc.map_width, min(his + lc.map_width, mature), g_t, g_q)

        # phase 2 (unlocked): ICP
        if src is None or tgt is None:
            return False
        with self.metrics.stage("icp"):
            res = icp_point_to_plane(
                src[0], src[1], tgt[0], tgt[1],
                torch.zeros(3, dtype=self.dtype, device=self.device),
                self._tensor([1.0, 0.0, 0.0, 0.0]), n_iters=lc.icp_iters, trim=lc.icp_trim)
            fitness = float(res.fitness)
        if not np.isfinite(fitness) or fitness > lc.icp_thres:
            self.lc_rejects["fitness"] += 1
            return False
        # corrected mature pose = ΔT_icp ∘ T_mature
        t_mat, q_mat = self._tensor(g_t[mature]), self._tensor(g_q[mature])
        t_corr = quat_rotate(res.q, t_mat) + res.t
        q_corr = quat_normalize(quat_mul(res.q, q_mat))
        max_corr = 2.0 * lc.search_radius if lc.max_correction is None else lc.max_correction
        corr_norm = float(np.linalg.norm(_np(t_corr) - g_t[mature]))
        if max_corr > 0.0 and corr_norm > max_corr:
            self.lc_rejects["max_correction"] += 1
            warnings.warn(f"loop candidate {mature}->{his} rejected: ICP correction "
                          f"{corr_norm:.2f} m exceeds max_correction {max_corr:.2f} m "
                          f"(fitness {fitness:.3f} — likely aliased)")
            return False
        rel_t, rel_q = pose_relative(t_corr, q_corr, self._tensor(g_t[his]),
                                     self._tensor(g_q[his]))

        # phase 3 (locked): record the factor, snapshot the graph
        with held():
            with self.metrics.stage("lc_inlock"):
                n0 = len(self.kf_stamps)
                self._record_loop(mature, his, rel_t, rel_q, res.fitness)
                snapshot = self.graph
                pairs = list(self._loop_pairs)

        # phase 4 (unlocked): suffix-restricted, early-exit solve
        with self.metrics.stage("graph_solve"):
            if lc.graph_suffix:
                solved_t, solved_q = solve_graph_incremental(
                    snapshot, n0, pairs, n_iters=lc.graph_iters, tol=lc.graph_tol)
            else:
                solved = optimize_graph_chain(snapshot, n_iters=lc.graph_iters,
                                              tol=lc.graph_tol)
                solved_t, solved_q = self._graph_poses_np(solved, n0)

        # phase 5 (locked): apply + correct
        with held():
            with self.metrics.stage("lc_inlock"):
                self._apply_solved_graph(solved_t, solved_q, n0)
                self._correct_poses()
                self.last_loop_stamp = float(stamps[mature])
        return True

    def _record_loop(self, i: int, j: int, rel_t, rel_q, fitness):
        """Add a loop factor, or replace one with nearby endpoints (see
        ``LoopClosureConfig.merge_width``)."""
        slot = self._find_mergeable_loop(i, j)
        if slot is None:
            self.graph = ensure_capacity(self.graph, len(self.kf_stamps),
                                         len(self._loop_pairs) + 1)
            self._loop_pairs.append((i, j))
            self.graph = add_loop(self.graph, i, j, rel_t, rel_q, fitness)
        else:
            self.graph = set_loop(self.graph, slot, i, j, rel_t, rel_q, fitness)
            self._loop_pairs[slot] = (i, j)

    def _find_mergeable_loop(self, i: int, j: int):
        """Slot of a loop factor whose endpoints both lie within
        ``merge_width`` keyframes of (i, j), else None."""
        w = self.lc_cfg.merge_width
        if w <= 0:
            return None
        for slot, (pi, pj) in enumerate(self._loop_pairs):
            if abs(pi - i) <= w and abs(pj - j) <= w:
                return slot
        return None

    def _apply_solved_graph(self, solved_t, solved_q, n0: int):
        """Write the solved poses of nodes [0, n0) into the live graph; nodes
        appended during the solve are re-chained by the left correction of
        the last solved node."""
        g = self.graph
        n = len(self.kf_stamps)
        new_t, new_q = self._graph_poses_np(g, g.t.shape[0])
        if n > n0:
            dq = quat_normalize_np(quat_mul_np(solved_q[n0 - 1][None],
                                               quat_conj_np(new_q[n0 - 1][None])))
            dt = solved_t[n0 - 1] - quat_rotate_np(dq, new_t[n0 - 1][None])[0]
            tail_q = np.broadcast_to(dq, (n - n0, 4))
            new_t[n0:n] = quat_rotate_np(tail_q, new_t[n0:n]) + dt
            new_q[n0:n] = quat_normalize_np(quat_mul_np(tail_q, new_q[n0:n]))
        new_t[:n0] = solved_t
        new_q[:n0] = solved_q
        self.graph = g._replace(t=self._tensor(new_t), q=self._tensor(new_q))

    # ------------------------------------------------------------------
    # global map (publishCompleteMap :2644-2685, save_pcd :2697-2722)
    # ------------------------------------------------------------------

    def build_global_map(self, leaf: float = 0.3, cap: int | None = None, interval: int = 1,
                         features_only: bool = False) -> np.ndarray:
        """The global map, (N,3) numpy: every ``interval``-th archived
        keyframe's full cloud at its (loop-corrected) graph pose ∘ the lidar
        extrinsic, voxel-downsampled at ``leaf`` on the host with keys of
        unbounded extent (``voxel_downsample_np``), as the JAX package
        builds it. ``features_only``: the surf archive instead (sparser).
        ``cap``: a random subsample of that many points (seed 0)."""
        archive = self.kf_full_clouds
        if features_only or len(archive) < len(self.kf_clouds):
            archive = self.kf_clouds
        n = len(archive)
        if n == 0:
            return np.zeros((0, 3))
        g_t, g_q = self._graph_poses_np(self.graph, n)
        parts = [w for i in range(0, n, max(interval, 1))
                 if len(w := self._world_cloud_np(i, g_t, g_q, archive))]
        if not parts:
            return np.zeros((0, 3))
        out = voxel_downsample_np(np.concatenate(parts), leaf)
        if cap is not None and len(out) > cap:
            sel = np.random.default_rng(0).choice(len(out), cap, replace=False)
            out = out[np.sort(sel)]
        return out

    def export_map(self, path: str, leaf: float = 0.3) -> int:
        """Write the global map as a binary PCD at ``path`` (the reference
        hardcodes its path, BackendFusion.cpp:2718) through the native
        writer, as the JAX package does (``io/pcd.py:write_pcd`` writes the
        same bytes). Returns the point count."""
        pts = self.build_global_map(leaf=leaf)
        if not pcd_write_native(path, pts):
            raise OSError(f"cannot write the map to {path}")
        return len(pts)

    def _submap(self, lo: int, hi: int, g_t, g_q):
        """World-frame submap of keyframes [lo, hi] (surf + edge features),
        downsampled exactly on the host and padded to ``submap_cap`` device
        rows: (pts, mask), or None when it has no point. Over capacity the
        key-ordered voxels are decimated by stride, uniformly over the
        extent."""
        lo, hi = max(0, lo), min(len(self.kf_clouds), hi + 1)
        pts = [w for i in range(lo, hi) for archive in (self.kf_clouds, self.kf_edge_clouds)
               if i < len(archive) and len(w := self._world_cloud_np(i, g_t, g_q, archive))]
        if not pts:
            return None
        cap = self.lc_cfg.submap_cap
        ds = voxel_downsample_np(np.concatenate(pts), self.lc_cfg.submap_leaf)
        if len(ds) > cap:
            ds = ds[::-(-len(ds) // cap)][:cap]
        out = np.zeros((cap, 3), self._np_dtype)
        out[:len(ds)] = ds
        return self._tensor(out), self._tensor(np.arange(cap) < len(ds), torch.bool)

    def _correct_poses(self):
        """Rewrite the keyframe poses from the graph: the fusion ring and
        window, the keyframe positions and the densified frames; drop the
        marginalization prior and flag the map tables for a rebuild."""
        n = len(self.kf_stamps)
        fs = self.fusion_state
        g_t, g_q = self._graph_poses_np(self.graph, n)
        self.kf_positions = [g_t[i] for i in range(n)]
        M, W = self.fusion_cfg.local_map_width, self.fusion_cfg.window
        wi = int(fs.write_idx)
        hist_t, hist_q = _np(fs.hist_t).copy(), _np(fs.hist_q).copy()
        for j in range(min(n, M)):
            slot = (wi - 1 - j) % M
            hist_t[slot], hist_q[slot] = g_t[n - 1 - j], g_q[n - 1 - j]
        win_t, win_q = _np(fs.t).copy(), _np(fs.q).copy()
        for j in range(min(n, W)):
            win_t[W - 1 - j], win_q[W - 1 - j] = g_t[n - 1 - j], g_q[n - 1 - j]
        self.fusion_state = fs._replace(
            t=self._tensor(win_t), q=self._tensor(win_q),
            hist_t=self._tensor(hist_t), hist_q=self._tensor(hist_q),
            prior=fs.prior._replace(valid=torch.zeros((), dtype=torch.bool, device=self.device)),
            sb_anchor_on=torch.ones((), dtype=torch.bool, device=self.device))
        self._maps_dirty = True
        if self._prev_kf is not None:
            self._prev_kf = (self._prev_kf[0], g_t[n - 1], g_q[n - 1], self._prev_kf[3])

        # re-chain the densified frames by their keyframe's left correction
        if self.dense_trajectory:
            kf_stamps = np.asarray(self.kf_stamps)
            stamps = np.array([s for s, _, _ in self.dense_trajectory])
            tts = np.stack([np.asarray(t) for _, t, _ in self.dense_trajectory])
            qqs = np.stack([np.asarray(q) for _, _, q in self.dense_trajectory])
            at_kf = np.abs(stamps[:, None] - kf_stamps[None, :]) < 1e-9  # (F,n)
            kf_dense_row = np.argmax(at_kf, axis=0)
            kf_has_old = np.any(at_kf, axis=0)
            t_old, q_old = tts[kf_dense_row], qqs[kf_dense_row]
            dq = quat_normalize_np(quat_mul_np(g_q, quat_conj_np(q_old)))
            dtc = g_t - quat_rotate_np(dq, t_old)
            j = np.clip(np.searchsorted(kf_stamps, stamps + 1e-9) - 1, 0, n - 1)
            apply = kf_has_old[j]
            dq_f = np.where(apply[:, None], dq[j], [1.0, 0, 0, 0])
            dtc_f = np.where(apply[:, None], dtc[j], 0.0)
            tts = quat_rotate_np(dq_f, tts) + dtc_f
            qqs = quat_normalize_np(quat_mul_np(dq_f, qqs))
            self.dense_trajectory = [(float(s), tts[i], qqs[i]) for i, s in enumerate(stamps)]
