"""What the ranks of the port's multi-device tests run (this module holds no
tests). Each test module spawns a world of gloo ranks on the CPU once
(:class:`Ranks`); every rank builds its mesh, runs one of the ``*_ranks``
functions below on inputs the test wrote with numpy, and writes its results
with ``np.savez``. The spawned children import this module and the port,
never JAX: the tests compare the results with the JAX package in the
parent."""
import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from lili_om_tpu_torch.models.fusion import FusionConfig
from lili_om_tpu_torch.models.odometry import OdometryConfig
from lili_om_tpu_torch.utils.config import LoopClosureConfig

CPU = "cpu"
# the sharded kNN cases: (name, mask of the 1024-point map), float64
KNN_P, KNN_Q = 1024, 64
# the odometry outputs compared
ODO_OUT = ("t", "q", "rel_t", "rel_q", "is_keyframe", "n_corr")


class Ranks:
    """``fn(mesh, workdir)`` on ``n`` spawned gloo ranks (rendezvous through
    a file in ``workdir``, so no port is fixed), started at construction so
    that the test's own JAX work overlaps them. :meth:`results` waits for
    them (at most ``timeout`` seconds) and returns each rank's dict."""

    def __init__(self, fn, n: int, workdir, axis: str = "q", timeout: float = 600.0):
        self.n, self.workdir, self.timeout = n, str(workdir), timeout
        self._ctx = mp.spawn(_rank, args=(fn, n, self.workdir, axis), nprocs=n, join=False)
        self._out = None

    def results(self) -> list[dict]:
        if self._out is None:
            deadline = time.monotonic() + self.timeout
            while not self._ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    for p in self._ctx.processes:
                        p.terminate()
                    raise TimeoutError(f"the {self.n} ranks ran over {self.timeout} s")
            self._out = [dict(np.load(os.path.join(self.workdir, f"rank{r}.npz")))
                         for r in range(self.n)]
        return self._out


def _rank(rank: int, fn, n: int, workdir: str, axis: str):
    from lili_om_tpu_torch.parallel.sharded import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/rendezvous",
                            world_size=n, rank=rank)
    try:
        out = fn(make_mesh(n, axis, device=CPU), workdir)
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _t(a):
    return torch.as_tensor(a)


def _np(x):
    return x.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# parallel/sharded.py
# ---------------------------------------------------------------------------


def knn_masks(n: int) -> dict:
    """Masks of the kNN cases for an ``n``-rank split of the map: all valid;
    a third masked; the last rank's block all invalid; only three valid
    points, all in the last block (the other blocks all invalid, and every
    query has fewer than k neighbours)."""
    b = KNN_P // n
    empty_last = np.ones(KNN_P, bool)
    empty_last[-b:] = False
    sparse = np.zeros(KNN_P, bool)
    sparse[[KNN_P - b, KNN_P - 7, KNN_P - 1]] = True
    return {"dense": np.ones(KNN_P, bool), "masked": np.arange(KNN_P) % 3 != 0,
            "empty_last": empty_last, "sparse": sparse}


def parallel_inputs(seed: int = 0) -> dict:
    """The kNN, Hessian and scan-match inputs (float64)."""
    rng = np.random.default_rng(seed)
    n = 1024
    a = rng.uniform(-5.0, 5.0, (n // 2, 2))
    walls = np.concatenate([np.stack([a[:, 0], a[:, 1], np.zeros(n // 2)], 1),
                            np.stack([a[:, 0], np.full(n // 2, 5.0), a[:, 1] + 5.0], 1)])
    # the scan: the walls seen from a pose off by (t_true, q_true)
    t_true = np.array([0.1, -0.08, 0.12])
    q_true = np.array([1.0, 0.01, -0.02, 0.015])
    q_true /= np.linalg.norm(q_true)
    return {"q": rng.standard_normal((KNN_Q, 3)) * 5.0,
            "p": rng.standard_normal((KNN_P, 3)) * 5.0,
            "J": rng.standard_normal((256, 6)), "r": rng.standard_normal(256),
            "walls": walls, "t_true": t_true, "q_true": q_true}


def odometry_config() -> OdometryConfig:
    """tests/test_sharded_frontend.py's configuration at smaller caps; the
    GN iteration count pinned (``gn_tol`` 0), as there: the order of the
    ranks' sums can move a step norm across the early-exit tolerance."""
    return OdometryConfig(n_recent_frames=4, scan_cap=4096, query_cap=512, map_cap=8192,
                          gn_tol=0.0)


def parallel_ranks(mesh, workdir) -> dict:
    """Every case of parallel/sharded.py on this rank's mesh."""
    from lili_om_tpu_torch.interop import odometry_state_from_numpy
    from lili_om_tpu_torch.models.odometry import OdometryState, init_state
    from lili_om_tpu_torch.parallel.sharded import (make_sharded_odometry,
                                                     sharded_hessian_reduce, sharded_knn,
                                                     sharded_scan_match_step)
    from lili_om_tpu_torch.utils.math import pose_inverse, quat_rotate

    inp = dict(np.load(os.path.join(workdir, "inputs.npz")))
    out = {}
    for name, mask in knn_masks(mesh.size()).items():
        d, i = sharded_knn(mesh, _t(inp["q"]), _t(inp["p"]), _t(mask), k=5)
        out[f"knn_{name}_d"], out[f"knn_{name}_i"] = _np(d), _np(i)
    if "J" not in inp:
        return out
    H, g = sharded_hessian_reduce(mesh, _t(inp["J"]), _t(inp["r"]))
    out["H"], out["g"] = _np(H), _np(g)

    walls = _t(inp["walls"])
    ti, qi = pose_inverse(_t(inp["t_true"]), _t(inp["q_true"]))
    scan = quat_rotate(qi.expand(walls.shape[0], 4), walls) + ti
    ones = torch.ones(walls.shape[0], dtype=torch.bool)
    t, q, n_corr = sharded_scan_match_step(
        mesh, torch.zeros(3, dtype=torch.float64),
        torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float64), scan, ones, walls, ones,
        n_iters=6)
    out["sm_t"], out["sm_q"], out["sm_n"] = _np(t), _np(q), _np(n_corr)

    # the odometry twice: each frame from the reference chain's state
    # ("carried", the test's JAX states), and free-running on its own states
    cfg = odometry_config()
    step = make_sharded_odometry(mesh, cfg)
    free = init_state(cfg, dtype=torch.float64, device=CPU)
    for k in range(int(inp["n_frames"])):
        pts, mask = _t(inp[f"surf_{k}"]), _t(inp[f"mask_{k}"])
        n_rounds = cfg.max_rounds if k < 2 else cfg.scan_match_cnt
        ref = odometry_state_from_numpy(
            {f: inp[f"state_{k}.{f}"] for f in OdometryState._fields}, torch.float64, CPU)
        _, o = step(ref, pts, mask, n_rounds=n_rounds)
        free, of = step(free, pts, mask, n_rounds=n_rounds)
        for f in ODO_OUT:
            out[f"carried_{k}.{f}"] = _np(getattr(o, f))
            out[f"free_{k}.{f}"] = _np(getattr(of, f))
    return out


# ---------------------------------------------------------------------------
# parallel/map_fusion.py and LiliOmSystem(mesh=…)
# ---------------------------------------------------------------------------


def fusion_config() -> FusionConfig:
    """tests/test_map_fusion.py's configuration: caps at which neither the
    global nor a rank's voxel budget overflows (an overflowing budget keeps
    a capacity-ordered subset, which differs between the two)."""
    return FusionConfig(window=3, local_map_width=8, kf_surf_cap=256, kf_edge_cap=64,
                        map_surf_cap=2048, map_edge_cap=1024, use_reflectivity=False,
                        weight_gate=0.3, lidar_const=7.5, max_num_iter=2, imu_cap=16,
                        incremental_map=False)


def filled_ring(cfg: FusionConfig, seed: int = 0) -> dict:
    """tests/test_map_fusion.py's ``_filled_state`` as numpy: every slot
    holds a plane patch 10 m from the next, so no voxel spans two slots."""
    rng = np.random.default_rng(seed)
    M, Sc, Ec = cfg.local_map_width, cfg.kf_surf_cap, cfg.kf_edge_cap
    hs, he = np.zeros((M, Sc, 3)), np.zeros((M, Ec, 3))
    for i in range(M):
        base = np.array([10.0 * i, 0.0, 0.0])
        hs[i] = base + np.stack([rng.uniform(0, 2, Sc), rng.uniform(0, 2, Sc),
                                 0.02 * rng.standard_normal(Sc)], axis=1)
        he[i] = base + np.stack([rng.uniform(0, 1, Ec), np.full(Ec, 1.0),
                                 rng.uniform(0, 2, Ec)], axis=1)
    return {"hist_surf": hs, "hist_surf_mask": np.ones((M, Sc), bool), "hist_edge": he,
            "hist_edge_mask": np.ones((M, Ec), bool), "hist_t": np.zeros((M, 3)),
            "hist_valid": np.ones(M, bool), "kf_count": np.int32(M)}


def scan_inputs(cfg: FusionConfig, g_norm: float, seed: int = 5) -> list:
    """tests/test_map_fusion.py's ``_scan_inputs`` as numpy: a scan over slot
    0's patch and a level, resting IMU interval."""
    rng = np.random.default_rng(seed)
    Sc, Ec, n = cfg.kf_surf_cap, cfg.kf_edge_cap, cfg.imu_cap
    sp = np.stack([rng.uniform(0, 2, Sc), rng.uniform(0, 2, Sc),
                   0.02 * rng.standard_normal(Sc)], axis=1)
    ep = np.stack([rng.uniform(0, 1, Ec), np.full(Ec, 1.0), rng.uniform(0, 2, Ec)], axis=1)
    accs = np.zeros((n, 3))
    accs[:, 2] = g_norm
    return [sp, np.ones(Sc, bool), np.zeros(Sc), ep, np.ones(Ec, bool), np.full(n, 0.005),
            accs, np.zeros((n, 3)), np.ones(n, bool)]


def system_configs():
    """tests/test_sharded_frontend.py's mesh system at the scan size of
    test_torch_system.py (16×720), loop closure off as there. Returns
    (odometry, fusion, feature caps) keyword dicts."""
    return (dict(n_recent_frames=4, scan_cap=1024, query_cap=256, map_cap=2048),
            dict(window=3, local_map_width=8, kf_surf_cap=1024, kf_edge_cap=256,
                 map_surf_cap=2048, map_edge_cap=512, use_reflectivity=False, max_num_iter=2,
                 imu_cap=32),
            dict(surf_cap=1024))


def make_system(mesh=None, closures: bool = False):
    """The port's side of :func:`system_configs` in float64 on the CPU; with
    ``closures``, detection on every call and the small ICP of a closure
    test (the last mature keyframe's own history is a candidate)."""
    from lili_om_tpu_torch.models.system import LiliOmSystem
    from lili_om_tpu_torch.ops.features_spin import SpinFeatureConfig

    odo, fus, feat = system_configs()
    lc = (LoopClosureConfig(time_thres=0.0, debounce=0.0, submap_cap=1024, icp_iters=6,
                            icp_thres=1.0, map_width=2)
          if closures else LoopClosureConfig(enabled=False))
    return LiliOmSystem(odo_cfg=OdometryConfig(**odo), fusion_cfg=FusionConfig(**fus),
                        feat_cfg=SpinFeatureConfig(**feat), lc_cfg=lc, graph_capacity=32,
                        dtype=torch.float64, mesh=mesh, device=CPU)


def run_system(sys_, scans: dict, n: int, closures: bool = False) -> dict:
    """Push the IMU, run the first ``n`` scans (a closure attempt after
    each scan from the fourth on with ``closures``); the run's results as
    numpy."""
    sys_.push_imu(scans["imu_stamps"], scans["imu_accs"], scans["imu_gyrs"])
    fired = []
    for k in range(n):
        sys_.process_scan(scans[f"img_{k}"], scans[f"valid_{k}"], scans[f"rel_{k}"],
                          float(scans[f"stamp_{k}"]))
        if closures and k >= 3:
            fired.append(sys_.try_loop_closure())
    n = len(sys_.kf_stamps)
    return {"trajectory": np.asarray(sys_.trajectory), "kf_stamps": np.asarray(sys_.kf_stamps),
            "graph_t": _np(sys_.graph.t[:n]), "graph_q": _np(sys_.graph.q[:n]),
            "fusion_t": _np(sys_.fusion_state.t), "hist_t": _np(sys_.fusion_state.hist_t),
            "n_loops": _np(sys_.graph.n_loops), "fired": np.asarray(fired, bool)}


def map_fusion_ranks(mesh, workdir) -> dict:
    """The map-sharded step on the filled ring and the warmup step on a
    fresh state (tests/test_map_fusion.py's cases), then the mesh system
    over the simulated scans, closures off and then on; every rank's
    replicated-state check and digest."""
    from lili_om_tpu_torch.models.fusion import init_fusion_state
    from lili_om_tpu_torch.ops.preintegration import ImuNoise
    from lili_om_tpu_torch.parallel.map_fusion import make_map_sharded_fusion

    cfg, noise = fusion_config(), ImuNoise()
    args = [_t(a) for a in scan_inputs(cfg, g_norm=noise.g_norm)]
    out = {}
    fresh = init_fusion_state(cfg, noise, dtype=torch.float64, device=CPU)
    for name, warm in (("main", False), ("warm", True)):
        st = fresh
        if not warm:
            st = fresh._replace(**{k: _t(v) for k, v in filled_ring(cfg).items()})
        step, blocks = make_map_sharded_fusion(mesh, cfg, noise, warmup=warm)
        st, o = step(st, *args)
        out.update({f"{name}_state.{k}": v for k, v in _tree(st).items()})
        out.update({f"{name}_out.{k}": v for k, v in _tree(o).items()})
    out["blocks"] = np.array([[b.start, b.stop] for b in blocks])

    scans = dict(np.load(os.path.join(workdir, "scans.npz")))
    for name, closures, n in (("sys", False, int(scans["n_sys"])), ("lc", True, int(scans["n"]))):
        sys_ = make_system(mesh, closures)
        res = run_system(sys_, scans, n, closures)
        res["replicated"] = np.bool_(sys_.check_replicated())
        res["digest"] = np.frombuffer(bytes.fromhex(sys_.replicated_digest()), np.uint8)
        out.update({f"{name}_{k}": v for k, v in res.items()})
    # a diverged rank: the check finds it on every rank and takes rank 0's state
    if mesh.get_local_rank() == 1:
        fs = sys_.fusion_state
        sys_.fusion_state = fs._replace(t=fs.t + 1e-9)
        sys_.trajectory[-1] = sys_.trajectory[-1] + 1e-9
    out["repair_found"] = np.bool_(not sys_.check_replicated())
    out["repair_after"] = np.bool_(sys_.check_replicated())
    out["repair_digest"] = np.frombuffer(bytes.fromhex(sys_.replicated_digest()), np.uint8)
    return out


def _tree(nt, prefix="") -> dict:
    out = {}
    for k, v in nt._asdict().items():
        if hasattr(v, "_fields"):
            out.update(_tree(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = _np(v)
    return out


# ---------------------------------------------------------------------------
# parallel/dist_fusion.py
# ---------------------------------------------------------------------------

DIST_KF = 4  # keyframes: the first window - 1 warm up, the rest solve


def dist_fusion_config() -> FusionConfig:
    """tests/test_dist_fusion.py's ``CFG``."""
    return FusionConfig(window=3, local_map_width=4, kf_surf_cap=512, kf_edge_cap=128,
                        map_surf_cap=1024, map_edge_cap=256, use_reflectivity=False,
                        weight_gate=0.3, lidar_const=7.5, max_num_iter=2, imu_cap=16)


def dist_fusion_inputs(cfg: FusionConfig, g_norm: float, seed: int = 0) -> list:
    """``DIST_KF`` keyframes of a room seen from rest, float64 numpy in
    ``fusion_step``'s argument order: 2048 surf points on the floor and two
    walls (a tenth masked), 512 edge points along four vertical poles, both
    resampled for every keyframe, and a resting IMU interval with a little
    gyro noise. Keyframe 1 sees one pole and keyframes 2 and 3 none, so at
    the solved keyframes the second rank's block of edge rows holds no
    valid query."""
    rng = np.random.default_rng(seed)
    n_s, n_e, n_i = 2048, 512, cfg.imu_cap
    out = []
    for kf in range(DIST_KF):
        u = rng.uniform(-3.0, 3.0, (n_s, 2))
        h = rng.uniform(0.0, 3.0, n_s)
        which = rng.integers(0, 3, n_s)
        surf = np.where((which == 0)[:, None], np.stack([u[:, 0], u[:, 1], np.zeros(n_s)], 1),
                        np.where((which == 1)[:, None],
                                 np.stack([np.full(n_s, 3.0), u[:, 1], h], 1),
                                 np.stack([u[:, 0], np.full(n_s, 3.0), h], 1)))
        surf = surf + 0.01 * rng.standard_normal((n_s, 3)) + np.array([0.0, 0.0, -1.0])
        poles = np.array([[2.0, -2.0], [-2.0, 2.0], [2.5, 2.5], [-2.5, -2.5]])
        pole = rng.integers(0, 4, n_e)
        edge = np.stack([poles[pole, 0], poles[pole, 1], rng.uniform(-1.0, 2.0, n_e)], 1)
        edge = edge + 0.01 * rng.standard_normal((n_e, 3))
        edge_mask = np.full(n_e, kf == 0) | ((kf == 1) & (pole == 0))
        accs = np.zeros((n_i, 3))
        accs[:, 2] = g_norm
        out.append([surf, rng.uniform(size=n_s) > 0.1, np.zeros(n_s), edge, edge_mask,
                    np.full(n_i, 0.005), accs, 1e-3 * rng.standard_normal((n_i, 3)),
                    np.ones(n_i, bool)])
    return out


def dist_fusion_ranks(mesh, workdir) -> dict:
    """The query-sharded step over ``DIST_KF`` keyframes from a fresh state
    in float64 and float32, and the single-device ``fusion_step`` on the
    same inputs in this process; each run's final state and outputs, the
    per-keyframe correspondence counts and the rank blocks."""
    from lili_om_tpu_torch.models.fusion import fusion_step, init_fusion_state
    from lili_om_tpu_torch.ops.preintegration import ImuNoise
    from lili_om_tpu_torch.parallel import make_distributed_fusion, make_sharded_state

    cfg, noise = dist_fusion_config(), ImuNoise()
    warm, blocks = make_distributed_fusion(mesh, cfg, noise, axis="d", warmup=True)
    main, _ = make_distributed_fusion(mesh, cfg, noise, warmup=False)
    out = {"blocks": np.array([[s.start, s.stop, e.start, e.stop] for s, e in blocks])}
    for dt in (torch.float64, torch.float32):
        tag = str(dt).split(".")[1]
        inputs = [[_t(a).to(dt) if a.dtype == np.float64 else _t(a) for a in kf]
                  for kf in dist_fusion_inputs(cfg, noise.g_norm)]
        st = make_sharded_state(mesh, cfg, noise, dtype=dt, axis="d")
        single = init_fusion_state(cfg, noise, dtype=dt, device=CPU)
        counts = []
        for k, args in enumerate(inputs):
            w = k + 1 < cfg.window
            st, o = (warm if w else main)(st, *args)
            single, so = fusion_step(single, *args, cfg=cfg, noise=noise, warmup=w, device=CPU)
            counts.append([int(o.n_surf_corr), int(o.n_edge_corr)])
        out.update({f"{tag}_state.{k}": v for k, v in _tree(st).items()})
        out.update({f"{tag}_out.{k}": v for k, v in _tree(o).items()})
        out.update({f"{tag}_single_state.{k}": v for k, v in _tree(single).items()})
        out.update({f"{tag}_single_out.{k}": v for k, v in _tree(so).items()})
        out[f"{tag}_counts"] = np.array(counts)
    return out
