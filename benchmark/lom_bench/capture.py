"""What the timed path produced, kept for the check: wrappers around the
stage functions that ``LiliOmSystem`` calls (``odometry_step``,
``fusion_step``, ``icp_point_to_plane``, ``solve_graph_incremental`` in
``models/system.py``) and around its loop-closure submap assembly
(``LiliOmSystem._submap``). In the first session of the window the
wrappers keep references to the inputs and outputs of the planned calls: a
few scans, keyframes and closures drawn from the seed, the warm-up
keyframes, and the first keyframes that rebuild the maps after a closure.
The window copies them (:meth:`Capture.flush`) once the scan or attempt
has ended and been synchronised, outside its timed spans, and leaves that
time out of its seconds. The program's states are tuples that every stage
replaces rather than writes into, so a reference still holds what the call
saw when the copy is made. Elsewhere the wrappers only pass through. In a
traced slice they also mark each call as a profiler span (``bench.*``)."""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from . import program

STAGES = ("odometry_step", "fusion_step", "icp_point_to_plane", "solve_graph_incremental")


def clone_tree(x):
    """A copy of a tensor, or of a NamedTuple or list of them, nested."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if hasattr(x, "_fields"):
        return type(x)(*[clone_tree(v) for v in x])
    if isinstance(x, (list, tuple)):
        return type(x)(clone_tree(v) for v in x)
    return x


class Plan(NamedTuple):
    odometry_scans: frozenset  # scan indices of the first session
    keyframes: frozenset  # keyframe ordinals (fusion calls) of the first session
    closures: frozenset  # ordinals of the first session's attempts that run ICP
    solves: frozenset  # ordinals of the first session's graph solves (closures that fire)
    warmup: int  # keyframes 0 .. warmup-1 fill the window (no solve): all kept
    rebuilds: int  # the first keyframes that rebuild the maps after a closure: kept


def make_plan(seed: int, traffic: dict, window: int) -> Plan:
    """The sample the check compares, drawn from ``seed``: scan 0, the
    fusion ``window``'s warm-up keyframes (the start, from the initial
    states) and draws from the rest of the session."""
    chk = traffic["check"]
    rng = np.random.default_rng([seed, 0x5C4E])
    n = traffic["scans_per_session"]
    warmup = window - 1
    # from the first half of the session, which the window reaches (a
    # session of the golden loop has about n/2 keyframes; the first attempt
    # with a candidate comes at scan ~40 of a revisit session)
    scans = {0} | set(rng.choice(np.arange(1, n // 2), chk["odometry_scans"] - 1,
                                 replace=False).tolist())
    kfs = set(range(warmup)) | set(rng.choice(np.arange(warmup, n // 4), chk["keyframes"],
                                              replace=False).tolist())
    n_att = n // traffic["closure_every"]
    closures = set(rng.choice(np.arange(0, n_att // 4), chk["closures"],
                              replace=False).tolist()) if chk["closures"] else set()
    # closures fire on a fraction of the attempts: draw from the first few
    solves = set(rng.choice(np.arange(0, 3), chk["closures"],
                            replace=False).tolist()) if chk["closures"] else set()
    return Plan(frozenset(scans), frozenset(kfs), frozenset(closures), frozenset(solves),
                warmup, chk.get("rebuilds", 0))


class Capture:
    def __init__(self, plan: Plan | None):
        self.plan = plan
        self.active = plan is not None  # the first session of the window
        self.annotate = False  # profiler spans (traced slice)
        self.scan = -1
        self.stamp = 0.0
        self.odometry: dict = {}
        self.keyframes: dict = {}
        self.icp: dict = {}
        self.graph: dict = {}
        self.kf_stamps: list = []  # the first session's keyframe stamps
        self.n_icp = 0  # attempts that reached ICP in the first session
        self.n_solves = 0  # graph solves in the first session
        self.n_rebuilds = 0  # rebuild keyframes kept
        self._fired_since_kf = False
        self._prev_rel_t = None
        self._t_scan_src = None
        self._submaps: list = []  # the current attempt's submaps, when its ICP is planned
        self._unflushed: list = []  # (record, keys to copy)
        self._orig: dict = {}
        self._module = None

    # ------------------------------------------------------ the window's hooks
    def begin_scan(self, k: int, stamp: float):
        self.scan, self.stamp = k, stamp
        # the translation deskew of scan k comes from scan k-1's odometry
        self._t_scan_src = self._prev_rel_t

    def after_closure(self, fired: bool):
        self._submaps = []
        if fired:
            self._fired_since_kf = True

    def end_session(self):
        self.active = False

    def dirty(self) -> bool:
        return bool(self._unflushed)

    def flush(self):
        """Copy what the planned calls of the ended scan or attempt saw and
        gave (the caller synchronises and times it)."""
        for rec, keys in self._unflushed:
            for k in keys:
                rec[k] = clone_tree(rec[k])
        self._unflushed = []

    def pending(self) -> bool:
        """Whether a planned call has not come yet."""
        p = self.plan
        return p is not None and (len(self.odometry) < len(p.odometry_scans)
                                  or sum(1 for j in self.keyframes if j in p.keyframes)
                                  < len(p.keyframes)
                                  or self.n_rebuilds < p.rebuilds
                                  or len(self.icp) < len(p.closures)
                                  or len(self.graph) < len(p.solves))

    # -------------------------------------------------------------- wrappers
    def install(self, module):
        self._module = module
        for name in STAGES:
            self._orig[name] = getattr(module, name)
        self._orig["_submap"] = module.LiliOmSystem._submap
        module.odometry_step = self._odometry
        module.fusion_step = self._fusion
        module.icp_point_to_plane = self._icp
        module.solve_graph_incremental = self._graph
        capture = self

        def submap(sys_, lo, hi, g_t, g_q):
            return capture._submap(sys_, lo, hi, g_t, g_q)
        module.LiliOmSystem._submap = submap
        return self

    def uninstall(self):
        for name, fn in self._orig.items():
            if name == "_submap":
                self._module.LiliOmSystem._submap = fn
            else:
                setattr(self._module, name, fn)
        self._orig.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.uninstall()

    def _span(self, name):
        if self.annotate:
            return torch.profiler.record_function(f"bench.{name}")
        return contextlib.nullcontext()

    def _keep(self, rec: dict, *keys):
        self._unflushed.append((rec, keys))
        return rec

    def _odometry(self, state, surf, surf_mask, cfg, *args, **kw):
        with self._span("odometry"):
            new_state, out = self._orig["odometry_step"](state, surf, surf_mask, cfg, *args, **kw)
        if self.active:
            if self.scan in self.plan.odometry_scans and self.scan not in self.odometry:
                self.odometry[self.scan] = self._keep(
                    dict(state=state, t=out.t, q=out.q, new_state=new_state,
                         t_scan_src=self._t_scan_src),
                    "state", "t", "q", "new_state", "t_scan_src")
            self._prev_rel_t = out.rel_t
        return new_state, out

    def _fusion(self, state, *args, **kw):
        with self._span("fusion"):
            new_state, out = self._orig["fusion_step"](state, *args, **kw)
        if self.active:
            j = len(self.kf_stamps)
            rebuild = self._fired_since_kf
            kind = "warmup" if j < self.plan.warmup else "rebuild" if rebuild else "solved"
            keep = j in self.plan.keyframes or (
                kind == "rebuild" and self.n_rebuilds < self.plan.rebuilds)
            if keep:
                self.n_rebuilds += kind == "rebuild"
                self.keyframes[j] = self._keep(
                    dict(kind=kind, scan=self.scan, stamp=self.stamp,
                         prev_stamp=self.kf_stamps[-1] if self.kf_stamps else None,
                         rebuild=rebuild, state=state, new_state=new_state, out=out,
                         t_scan_src=self._t_scan_src),
                    "state", "new_state", "out", "t_scan_src")
            self.kf_stamps.append(self.stamp)
            self._fired_since_kf = False
        return new_state, out

    def _submap(self, sys_, lo, hi, g_t, g_q):
        res = self._orig["_submap"](sys_, lo, hi, g_t, g_q)
        if self.active and self.n_icp in self.plan.closures:
            # the archived sensor-frame clouds of keyframes [lo, hi] (host
            # arrays the program cached), surf and edge; the reference
            # assembles the submap from them again
            clouds = {}
            for i in range(max(0, lo), min(len(sys_.kf_clouds), hi + 1)):
                clouds[i] = tuple(sys_._kf_cloud_np(i, a) if i < len(a) else None
                                  for a in (sys_.kf_clouds, sys_.kf_edge_clouds))
            self._submaps.append(dict(clouds=clouds, g_t=g_t, g_q=g_q, out=res))
        return res

    def _icp(self, src, src_mask, tgt, tgt_mask, t0, q0, *args, **kw):
        with self._span("icp"):
            res = self._orig["icp_point_to_plane"](src, src_mask, tgt, tgt_mask, t0, q0,
                                                   *args, **kw)
        if self.active:
            if self.n_icp in self.plan.closures:
                self.icp[self.n_icp] = self._keep(
                    dict(submaps=self._submaps[-2:], start=(t0, q0), args_rest=args,
                         kw=dict(kw), t=res.t, q=res.q),
                    "start", "t", "q")
            self._submaps = []
            self.n_icp += 1
        return res

    def _graph(self, g, n, loop_pairs, *args, **kw):
        planned = self.active and self.n_solves in self.plan.solves
        rec = dict(graph=g, n=n, pairs=list(loop_pairs), kw=dict(kw)) if planned else None
        with self._span("graph_solve"), self._first_step(rec):
            solved = self._orig["solve_graph_incremental"](g, n, loop_pairs, *args, **kw)
        if self.active:
            if planned:
                rec["solved"] = tuple(np.array(x, copy=True) for x in solved)
                keys = ("graph", "step") if "step" in rec else ("graph",)
                self.graph[self.n_solves] = self._keep(rec, *keys)
            self.n_solves += 1
        return solved

    @contextlib.contextmanager
    def _first_step(self, rec):
        """With ``rec``: the graph solve's first Gauss-Newton step, the chain
        factor's resolve and the loop factors' Woodbury update together, as
        it reaches the trust-region clamp, kept as ``rec['step']``."""
        if rec is None:
            yield
            return
        graph_mod = program.graph_module()
        orig = graph_mod._clamp_step

        def clamp(d, *args, **kw):
            rec.setdefault("step", d)
            return orig(d, *args, **kw)
        graph_mod._clamp_step = clamp
        try:
            yield
        finally:
            graph_mod._clamp_step = orig
