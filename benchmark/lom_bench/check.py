"""The comparison that decides ``correct``.

The reference is ``lom_ref``: the port's plain paths, frozen with the
benchmark, in plain PyTorch, run on the same device once the window has
closed. It follows the program step by step: for each captured call it
starts from the program's own state before that call (the odometry and
fusion states, the graph, the keyframe archive's clouds and the graph
poses a closure's submaps are built from) and works out again, from the
log itself, everything else the call consumed — the scan's features
(undistortion, extraction, downsample, with the translation deskew from
the program's previous odometry output), the keyframe's IMU interval, the
bootstrap rounds, the warm-up and rebuild flags, the closure's submaps —
then runs the stage. The program's outputs are judged against the
reference's:

* the odometry, the median (the lower middle value) over the drawn scans
  (the largest swings: a gate or the Gauss-Newton exit that float32
  rounding turns on one scan in a hundred or two moves its pose by tenths
  of a millimetre, as far as float32 itself lies from float64 on every
  scan, see ``PERF.md``): ``odo_gap_m`` / ``odo_gap_rad`` the scan's
  odometry pose and the poses the odometry state carries on (latest,
  previous, keyframe); ``odo_map_gap_m`` the odometry's map after the scan
  (its table's voxel centroids), as a point set (``cloud_gap``);
* a solved keyframe's fusion, the median (the lower middle value) over
  the drawn keyframes (the largest swings: the LM loop's gates turn a
  rounding into a millimetre on some keyframes, see ``PERF.md``): ``fusion_gap_m`` / ``fusion_gap_rad``
  the fused window, the keyframe ring and the latest and mature poses;
  ``fusion_vel_gap`` the window's and the latest velocity;
  ``fusion_ba_gap`` / ``fusion_bg_gap`` the window's and the latest biases;
* ``fusion_warmup_gap``: the same leaves, the largest over the keyframes
  that fill the window (no solve, so no gate to flip);
* ``fusion_rebuild_gap_m`` / ``_rad``: the poses, the lower middle value
  over the first keyframes that rebuild the maps after a closure;
* ``submap_gap_m``: a closure's two submaps, point by point;
* ``icp_gap_m`` / ``icp_gap_rad``: a closure's ICP transform (the
  reference's ICP runs on the reference's submaps);
* ``graph_step_gap``: the graph solve's first Gauss-Newton step (the
  chain factor's resolve against the gradient and the loop factors'
  Woodbury update), its largest gap over its largest magnitude;
* ``graph_pose_gap``: the solved poses, their largest gap over the
  reference's largest move (1 for a solve that moves nothing).

Except where said, a number is the largest over the captured calls. The
control puts the reference computed with TF32 matrix products (the
precision below the configuration's float32 with TF32 off) in the
program's place.
"""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import numpy as np
import torch

from lom_ref import stages
from lom_ref.models import fusion as rfusion
from lom_ref.models import odometry as rodo
from lom_ref.models import pose_graph as rgraph
from lom_ref.ops import icp as ricp
from lom_ref.ops.features_livox import LivoxFeatureConfig
from lom_ref.ops.features_spin import SpinFeatureConfig
from lom_ref.ops.knn import knn
from lom_ref.ops.preintegration import ImuNoise

ODOMETRY = ("odo_gap_m", "odo_gap_rad", "odo_map_gap_m")
# the solved keyframes' numbers (median), then the warm-up keyframes'
FUSION = ("fusion_gap_m", "fusion_gap_rad", "fusion_vel_gap", "fusion_ba_gap",
          "fusion_bg_gap", "fusion_warmup_gap")
# the share of a map's centroids whose distance to the other map may stand
# out: a point that rounds into the neighbouring voxel moves a centroid by
# up to a voxel, on a handful of the tens of thousands
CLOUD_QUANTILE = 0.99
CLOSURE = ("fusion_rebuild_gap_m", "fusion_rebuild_gap_rad", "submap_gap_m", "icp_gap_m",
           "icp_gap_rad", "graph_step_gap", "graph_pose_gap")
# how a number folds its calls' gaps: the largest, or the median
MEDIAN = frozenset(ODOMETRY + FUSION[:5] + CLOSURE[:2])


# the anchor of the suffix solve (models/pose_graph.py:solve_graph_incremental)
SUFFIX_PRIOR_WEIGHT = 1e6


class Number(NamedTuple):
    name: str
    value: float
    limit: float | None
    samples: int


@contextlib.contextmanager
def precision(tf32: bool):
    """Matrix products in TF32 (the control) or in float32."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def to_ref(template, x):
    """The program's NamedTuple ``x`` as the reference's type of
    ``template``, field by field by name (nested)."""
    if hasattr(template, "_fields"):
        return type(template)(*[to_ref(getattr(template, f), getattr(x, f))
                                for f in template._fields])
    return x


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.asarray(x, dtype=np.float64)


def pos_gap(a, b) -> float:
    """The largest distance between matching rows of positions (…,3)."""
    d = np.linalg.norm(_f64(a).reshape(-1, 3) - _f64(b).reshape(-1, 3), axis=1)
    if len(d) == 0:
        return 0.0
    return float(np.max(d)) if np.all(np.isfinite(d)) else math.inf


def rot_gap(qa, qb) -> float:
    """The largest rotation angle between matching quaternions (…,4)."""
    a, b = _f64(qa).reshape(-1, 4), _f64(qb).reshape(-1, 4)
    a = a / np.linalg.norm(a, axis=1, keepdims=True)
    b = b / np.linalg.norm(b, axis=1, keepdims=True)
    w = np.abs(np.sum(a * b, axis=1))
    # |vec(a⁻¹·b)|, stable for small angles
    aw, av, bw, bv = a[:, :1], a[:, 1:], b[:, :1], b[:, 1:]
    vec = aw * bv - bw * av - np.cross(av, bv)
    ang = 2.0 * np.arctan2(np.linalg.norm(vec, axis=1), w)
    if len(ang) == 0:
        return 0.0
    return float(np.max(ang)) if np.all(np.isfinite(ang)) else math.inf


def rel_gap(a, b) -> float:
    """The largest gap of ``a`` from ``b`` over ``b``'s largest magnitude
    (inf where either is not finite)."""
    a64, b64 = _f64(a), _f64(b)
    if a64.shape != b64.shape or not (np.all(np.isfinite(a64)) and np.all(np.isfinite(b64))):
        return math.inf
    scale = float(np.max(np.abs(b64))) if b64.size else 0.0
    diff = float(np.max(np.abs(a64 - b64))) if b64.size else 0.0
    return diff / scale if scale > 0 else (0.0 if diff == 0 else math.inf)


def _nn_dist(q, p) -> torch.Tensor:
    """Each row of ``q``'s distance to its nearest row of ``p``."""
    return torch.sqrt(knn(q, p, k=1)[0][:, 0])


def cloud_gap(a_pts, a_valid, b_pts, b_valid, quantile: float = CLOUD_QUANTILE) -> float:
    """How far two point sets lie apart, whatever their row order: the
    ``quantile`` of each valid point's distance to the other set's nearest,
    both ways, the larger (inf where one set is empty and the other not, or
    a point is not finite)."""
    a = a_pts[a_valid].double()
    b = b_pts.to(a_pts.device)[b_valid.to(a_pts.device)].double()
    if len(a) == 0 and len(b) == 0:
        return 0.0
    if len(a) == 0 or len(b) == 0 or not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        return math.inf
    ab = torch.quantile(_nn_dist(a, b), quantile)
    ba = torch.quantile(_nn_dist(b, a), quantile)
    return float(torch.maximum(ab, ba))


def centroids(sums, cnt, valid):
    """A voxel table's centroids (xyz of ``sums`` over ``cnt``) and mask."""
    return sums[:, :3] / torch.clamp(cnt, min=1.0)[:, None], valid


class Reference:
    """The reference's stages at configuration ``cfg``."""

    def __init__(self, cfg: dict, traffic: dict, log, device, dtype=torch.float32):
        self.cfg, self.traffic, self.log = cfg, traffic, log
        self.device, self.dtype = torch.device(device), dtype
        self.odo_cfg = rodo.OdometryConfig(**_tuples(cfg["odometry"]))
        self.fus_cfg = rfusion.FusionConfig(**_tuples(cfg["fusion"]))
        self.spin_cfg = SpinFeatureConfig(**_tuples(cfg["spin_features"]))
        self.livox_cfg = LivoxFeatureConfig(**_tuples(cfg["livox_features"]))
        self.noise = ImuNoise(**_tuples(cfg["imu_noise"]))
        self.livox = cfg["sensor"]["kind"] == "livox"
        self.period = cfg["scan_period"]

    def features(self, k: int, t_scan_src):
        """Scan ``k``'s features: (surf, surf_mask) for the odometry and the
        keyframe inputs (surf, mask, reflectivity, edge, edge mask)."""
        scan, stamp = self.log.scans[k], self.log.stamps[k]
        t_scan = stages.deskew_translation(t_scan_src) if self.cfg["deskew_translation"] \
            else (None if self.livox else np.zeros(3))
        if self.livox:
            surf, sm, refl, edge, em = stages.preprocess_livox(
                *scan, self.log.imu, stamp, t_scan, self.livox_cfg, self.odo_cfg.scan_cap,
                self.fus_cfg.kf_edge_cap, self.period, self.dtype, self.device)
            return (surf, sm), (surf, sm, refl, edge, em)
        fc = stages.preprocess_spin(*scan, self.log.imu, stamp, t_scan, self.fus_cfg.q_lb,
                                    self.spin_cfg, self.period, self.dtype, self.device)
        return ((fc.surf_pts, fc.surf_mask),
                (fc.surf_pts, fc.surf_mask, torch.zeros_like(fc.surf_pts[:, 0]), fc.edge_pts,
                 fc.edge_mask))

    def odometry(self, k: int, rec: dict):
        (surf, sm), _ = self.features(k, rec["t_scan_src"])
        template = rodo.init_state(self.odo_cfg, dtype=self.dtype, device=self.device)
        rounds = self.odo_cfg.max_rounds if k < 2 else self.odo_cfg.scan_match_cnt
        new, out = rodo.odometry_step(to_ref(template, rec["state"]), surf, sm, self.odo_cfg,
                                      n_rounds=rounds, device=self.device)
        return out.t, out.q, new

    def fusion(self, j: int, rec: dict):
        _, inputs = self.features(rec["scan"], rec["t_scan_src"])
        imu = stages.keyframe_imu(self.log.imu, rec["prev_stamp"], rec["stamp"],
                                  self.fus_cfg.imu_cap, self.dtype, self.device)
        template = rfusion.init_fusion_state(self.fus_cfg, self.noise, dtype=self.dtype,
                                             device=self.device)
        return rfusion.fusion_step(to_ref(template, rec["state"]), *inputs, *imu,
                                   self.fus_cfg, self.noise,
                                   warmup=j + 1 < self.fus_cfg.window, rebuild=rec["rebuild"],
                                   device=self.device)

    def submaps(self, rec: dict):
        """A closure's two submaps, from the archived clouds and the graph
        poses the program built them from: [(pts, mask) or None]."""
        lc, out = self.cfg["loop_closure"], []
        for sm in rec["submaps"]:
            clouds = [(i, c) for i, pair in sorted(sm["clouds"].items()) for c in pair
                      if c is not None]
            out.append(stages.submap(clouds, sm["g_t"], sm["g_q"], self.fus_cfg.q_lb,
                                     self.fus_cfg.t_lb, lc["submap_leaf"], lc["submap_cap"],
                                     self.dtype, self.device))
        return out

    def icp(self, rec: dict, submaps):
        (src, src_mask), (tgt, tgt_mask) = submaps
        res = ricp.icp_point_to_plane(src, src_mask, tgt, tgt_mask, *rec["start"],
                                      *rec["args_rest"], **rec["kw"])
        return res.t, res.q

    def _suffix(self, rec: dict):
        template = rgraph.init_graph(1, dtype=self.dtype, device=self.device)
        g = to_ref(template, rec["graph"])
        return g, rgraph.extract_suffix(g, rgraph.affected_base(rec["pairs"]), rec["n"])

    def graph_step(self, rec: dict):
        """The first Gauss-Newton step of ``solve_graph_incremental``: the
        affected suffix, its anchored normal equations at the current
        poses, the chain factor's resolve and the loop factors' Woodbury
        update, before the clamp."""
        _, sub = self._suffix(rec)
        diag_add = rgraph._anchor_freeze(sub, SUFFIX_PRIOR_WEIGHT) + rec["kw"].get("damping",
                                                                                   1e-6)
        return rgraph.chain_step(sub, sub.t, sub.q, diag_add)

    def graph_solve(self, rec: dict):
        """The solved poses (t (n,3), q (n,4)), host arrays."""
        g, _ = self._suffix(rec)
        return rgraph.solve_graph_incremental(g, rec["n"], rec["pairs"], **rec["kw"])


def submap_gap(a, b) -> float:
    """The largest distance between two padded submaps' matching rows (inf
    where one is missing or their masks differ)."""
    if a is None or b is None:
        return 0.0 if a is None and b is None else math.inf
    (pa, ma), (pb, mb) = a, b
    if not torch.equal(ma.to(mb.device), mb):
        return math.inf
    return pos_gap(pa[ma], pb.to(pa.device)[mb.to(pa.device)])


def move_gap(prog, ref, start) -> float:
    """Solved poses (t, q) against the reference's: the largest position and
    rotation gaps, each over the reference's largest move from ``start``,
    the larger (1 for a solve that leaves ``start`` as it is)."""
    out = 0.0
    for k, gap in enumerate((pos_gap, rot_gap)):
        diff, move = gap(prog[k], ref[k]), gap(start[k], ref[k])
        out = max(out, diff / move if move > 0 else (0.0 if diff == 0 else math.inf))
    return out


def readings(capture, ref: Reference, control: bool = False) -> dict:
    """Every captured call's gaps: the program's outputs (or, with
    ``control``, the reference's in TF32) against the reference's.
    Returns {number: [gap per call]}."""
    out: dict = {name: [] for name in ODOMETRY + FUSION + CLOSURE}

    def both(fn, *args):
        with precision(False):
            r = fn(*args)
        if not control:
            return r, None
        with precision(True):
            return r, fn(*args)

    for k, rec in sorted(capture.odometry.items()):
        (t, q, new), ctl = both(ref.odometry, k, rec)
        st, sq, snew = ctl if control else (rec["t"], rec["q"], rec["new_state"])
        out["odo_gap_m"].append(max(pos_gap(st, t), *(
            pos_gap(getattr(snew, f), getattr(new, f)) for f in ("t", "t_prev", "kf_t"))))
        out["odo_gap_rad"].append(max(rot_gap(sq, q), *(
            rot_gap(getattr(snew, f), getattr(new, f)) for f in ("q", "q_prev", "kf_q"))))
        out["odo_map_gap_m"].append(cloud_gap(
            *centroids(snew.map_sums, snew.map_cnt, snew.map_valid),
            *centroids(new.map_sums, new.map_cnt, new.map_valid)))
    for j, rec in sorted(capture.keyframes.items()):
        (new, fout), ctl = both(ref.fusion, j, rec)
        snew, sout = ctl if control else (rec["new_state"], rec["out"])
        ring = new.hist_valid.to(snew.hist_t.device)
        g_m = max(pos_gap(snew.t, new.t),
                  pos_gap(snew.hist_t[ring], new.hist_t[new.hist_valid]),
                  0.0 if torch.equal(snew.hist_valid, ring) else math.inf,
                  *(pos_gap(getattr(sout, f), getattr(fout, f)) for f in ("t_latest",
                                                                          "t_mature")))
        g_rad = max(rot_gap(snew.q, new.q),
                    rot_gap(snew.hist_q[ring], new.hist_q[new.hist_valid]),
                    *(rot_gap(getattr(sout, f), getattr(fout, f)) for f in ("q_latest",
                                                                            "q_mature")))
        g_v, g_ba, g_bg = (max(pos_gap(getattr(snew, f), getattr(new, f)),
                               pos_gap(getattr(sout, f + "_latest"), getattr(fout, f + "_latest")))
                           for f in ("v", "ba", "bg"))
        if rec["kind"] == "warmup":
            out["fusion_warmup_gap"].append(max(g_m, g_rad, g_v, g_ba, g_bg))
        elif rec["kind"] == "rebuild":
            out["fusion_rebuild_gap_m"].append(g_m)
            out["fusion_rebuild_gap_rad"].append(g_rad)
        else:
            for name, g in zip(FUSION[:5], (g_m, g_rad, g_v, g_ba, g_bg)):
                out[name].append(g)
    for i, rec in sorted(capture.icp.items()):
        with precision(False):
            subs = ref.submaps(rec)
        out["submap_gap_m"].append(max(submap_gap(sm["out"], r)
                                       for sm, r in zip(rec["submaps"], subs))
                                   if len(subs) == 2 else math.inf)
        if len(subs) != 2 or any(x is None for x in subs):
            out["icp_gap_m"].append(math.inf)
            out["icp_gap_rad"].append(math.inf)
            continue
        (t, q), ctl = both(ref.icp, rec, subs)
        st, sq = ctl if control else (rec["t"], rec["q"])
        out["icp_gap_m"].append(pos_gap(st, t))
        out["icp_gap_rad"].append(rot_gap(sq, q))
    for i, rec in sorted(capture.graph.items()):
        x, ctl = both(ref.graph_step, rec)
        out["graph_step_gap"].append(rel_gap(ctl if control else rec["step"], x)
                                     if control or "step" in rec else math.inf)
        solved, ctl = both(ref.graph_solve, rec)
        start = tuple(_f64(getattr(rec["graph"], f)[:rec["n"]]) for f in ("t", "q"))
        out["graph_pose_gap"].append(move_gap(ctl if control else rec["solved"], solved, start))
    return out


def fold(name: str, xs) -> float:
    """A number's value from its calls' gaps (inf for no call)."""
    if not xs:
        return math.inf
    if name in MEDIAN:
        # the lower middle value: for two rebuild keyframes the smaller,
        # so a gate flipped on one of them does not count, a fault on both
        # does; of eight scans a fault on five or more
        return float(sorted(xs)[(len(xs) - 1) // 2])
    return max(xs)


def judge(gaps: dict, limits: dict, traffic: dict) -> tuple[bool, list]:
    """(correct, [Number]): every number the cell compares at or under its
    limit, and every planned kind of call captured at least once (a planned
    answer that never came is a failure). A number whose limit the
    configuration gives as null is not compared there (the configuration's
    ``limits_why`` says why); one it leaves out fails."""
    names = list(ODOMETRY + FUSION) + (list(CLOSURE) if traffic["check"]["closures"] else [])
    numbers, ok = [], True
    for name in names:
        if name in limits and limits[name] is None:
            continue
        xs = gaps.get(name, [])
        value = fold(name, xs)
        limit = limits.get(name)
        numbers.append(Number(name, value, limit, len(xs)))
        if not xs or limit is None or not math.isfinite(value) or value > limit:
            ok = False
    return ok, numbers
