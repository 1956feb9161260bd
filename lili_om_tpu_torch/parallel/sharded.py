"""The query-sharded frontend and the collectives of the multi-device path
(port of ``lili_om_tpu/parallel/sharded.py``).

JAX drives its mesh from one controller (``shard_map``, ``psum``,
``all_gather``). Here every rank is a process running the same program
(SPMD), and the collectives are ``torch.distributed``'s on the group of a
1-D ``DeviceMesh`` (:func:`make_mesh`, PyTorch's counterpart of a named JAX
``Mesh``). What JAX reads as ``P(axis)`` on axis 0 a rank reads as its
contiguous block ``[r·N/n, (r+1)·N/n)`` (:func:`rank_block`); what JAX
replicates every rank holds whole.

* :func:`make_sharded_odometry`, the frontend that ``LiliOmSystem(mesh=…)``
  wires: the prepare and finalize phases of the odometry run replicated;
  in each matching round a rank searches its block of the downsampled
  queries against the replicated map (B1 on the card), fits it with the
  single-device code, and the 6×6 normal equations and the correspondence
  count are summed over the ranks (``all_reduce``) in every GN step. The
  solve, the trust-region clamp and the step-norm early exit then run on
  the same sums on every rank, so every rank takes the same branch.
* :func:`sharded_knn`: the map split over the ranks; each rank searches
  its block, the per-rank (Q, k) candidates are gathered rank-major to
  (Q, n·k) and the first k of a stable sort on d² kept — the order of
  ``jax.lax.top_k`` (the lower position first on ties), which
  ``torch.topk`` does not promise.
* :func:`sharded_scan_match_step`, :func:`sharded_hessian_reduce`: the
  distributed GN step and (JᵀJ, Jᵀr) reduction of the JAX module.

The collectives name their group, and so their backend: NCCL for a mesh on
the card (one rank per GPU: NCCL refuses two ranks on one device), gloo
for a mesh on the CPU. Each takes ``group`` (default: the mesh's own), so
that two threads of one rank can each issue theirs on a group of its own
(``runtime/pipeline.py``): collectives on one group must come in the same
order on every rank. Gloo takes CUDA tensors for every collective used
here, so two gloo ranks may also share one card (``tools/dist_probe.py``).
A collective that fails raises; nothing retries it another way.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..factors.lidar import PlaneFactorBatch, huber_weight, plane_residual
from ..ops.fitting import solve3
from ..ops.knn import knn_auto, world_knn_auto
from ..solver.gn import block_hessian, solve_normal
from ..utils.math import exp_so3, quat_mul, quat_normalize, quat_rotate


def make_mesh(n: int | None = None, axis: str = "q", device=None):
    """A 1-D ``DeviceMesh`` of ``n`` ranks (default: the whole world) named
    ``axis``. ``device=None`` means the card: each rank on
    ``cuda:{LOCAL_RANK % device_count}`` and, when no process group is up
    yet, the default group initialized with NCCL from the launcher's
    environment (``torchrun``). ``device="cpu"``: gloo. A group the caller
    initialized (any backend) is used as it is."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())
    return init_device_mesh(dev.type, (n or dist.get_world_size(),), mesh_dim_names=(axis,))


def mesh_device(mesh) -> torch.device:
    """This rank's device: the CPU, or the card ``make_mesh`` selected."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return torch.device(mesh.device_type, torch.cuda.current_device())


def rank_block(n_rows: int, mesh) -> slice:
    """This rank's contiguous block of ``n_rows`` rows (JAX's ``P(axis)``
    on axis 0); ``n_rows`` must divide the mesh."""
    n, r = mesh.size(), mesh.get_local_rank()
    if n_rows % n:
        raise ValueError(f"{n_rows} rows do not divide the {n}-rank mesh")
    b = n_rows // n
    return slice(r * b, (r + 1) * b)


def _group(mesh, group):
    return mesh.get_group() if group is None else group


def all_reduce_sum(mesh, x: torch.Tensor, group=None) -> torch.Tensor:
    """Σ over the ranks (JAX's ``psum``), a new tensor on every rank."""
    y = x.clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=_group(mesh, group))
    return y


def all_gather_cat(mesh, x: torch.Tensor, dim: int = 0, group=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (JAX's
    ``all_gather(..., tiled=True)``)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size())]
    dist.all_gather(parts, x, group=_group(mesh, group))
    return torch.cat(parts, dim=dim)


def broadcast_object(mesh, obj=None, src: int = 0, group=None):
    """Rank ``src``'s picklable ``obj`` on every rank (the others pass
    anything). Only the program's own ranks send, so the unpickling reads
    bytes this program wrote."""
    group = _group(mesh, group)
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, src), group=group,
                               device=mesh_device(mesh))
    return box[0]


def gather_objects(mesh, obj, group=None) -> list:
    """Every rank's picklable ``obj``, in rank order, on every rank."""
    out = [None] * mesh.size()
    dist.all_gather_object(out, obj, group=_group(mesh, group))
    return out


def new_mesh_group(mesh):
    """A new process group over the mesh's ranks. Every rank of the world
    must call it, in the same order as its other ``new_group`` calls."""
    return dist.new_group(ranks=dist.get_process_group_ranks(mesh.get_group()))


def merge_topk(d_all: torch.Tensor, k: int) -> torch.Tensor:
    """Columns of the k smallest of each row of the rank-major candidates
    ``d_all`` (Q, n·k): a stable sort, so on ties the lower position (rank,
    then slot) comes first, as ``jax.lax.top_k`` orders them."""
    return torch.sort(d_all, dim=1, stable=True).indices[:, :k]


def _local_match_and_reduce(t, q, scan_q, scan_mask, map_pts, map_mask, k: int,
                            nn_gate: float, plane_tol: float, min_weight: float, huber: float):
    """One rank's block: match its queries, fit the reference's unit-offset
    planes and return its (H, b, n_corr) — the single-device round's
    normal equations before the solve."""
    pw = quat_rotate(q[None, :], scan_q) + t[None, :]
    d2, idx = knn_auto(pw, map_pts, k=k, p_mask=map_mask)
    nbrs = map_pts[idx]
    nn_ok = d2[:, k - 1] < nn_gate
    AtA = torch.einsum("qki,qkj->qij", nbrs, nbrs)
    Atb = -torch.sum(nbrs, dim=-2)
    n_raw = solve3(AtA, Atb, damping=1e-9)
    norm = torch.clamp(torch.linalg.norm(n_raw, dim=-1, keepdim=True), min=1e-12)
    normal = n_raw / norm
    d_off = 1.0 / norm[..., 0]
    pd_nbr = torch.abs(torch.einsum("qki,qi->qk", nbrs, normal) + d_off[:, None])
    plane_ok = torch.all(pd_nbr <= plane_tol, dim=-1)
    pd = torch.sum(normal * pw, dim=-1) + d_off
    pw_norm = torch.sqrt(torch.clamp(torch.linalg.norm(pw, dim=-1), min=1e-9))
    weight = 1.0 - 0.9 * torch.abs(pd) / pw_norm
    keep = scan_mask & nn_ok & plane_ok & (weight > min_weight)
    batch = PlaneFactorBatch(scan_q, normal, d_off, torch.where(keep, weight, 0.0), keep)
    r, J = plane_residual(t, q, batch)
    H, b = block_hessian(J, r, huber_weight(r * r, huber))
    return H, b, torch.sum(keep.to(torch.int64))


def sharded_scan_match_step(mesh, t, q, scan_pts, scan_mask, map_pts, map_mask,
                            n_iters: int = 4, k: int = 5, nn_gate: float = 1.0,
                            plane_tol: float = 0.06, min_weight: float = 0.4,
                            huber: float = 0.1, damping: float = 1e-8):
    """``n_iters`` distributed scan-to-map GN updates: each rank matches its
    block of ``scan_pts`` (Q divisible by the mesh) against the replicated
    map, (H, b) are summed over the ranks, the 6-dof solve and retraction
    run on every rank. Every rank passes the whole scan. Returns (t, q,
    the correspondence count of the last update over all ranks)."""
    blk = rank_block(scan_pts.shape[0], mesh)
    scan_pts, scan_mask = scan_pts[blk], scan_mask[blk]
    n_corr = torch.zeros((), dtype=torch.int64, device=t.device)
    for _ in range(n_iters):
        H, b, n_corr = (all_reduce_sum(mesh, x) for x in _local_match_and_reduce(
            t, q, scan_pts, scan_mask, map_pts, map_mask, k, nn_gate, plane_tol,
            min_weight, huber))
        delta = solve_normal(H, b, damping)
        t = t + delta[:3]
        q = quat_normalize(quat_mul(q, exp_so3(delta[3:6])))
    return t, q, n_corr.to(torch.int32)


def make_sharded_odometry(mesh, cfg, group=None):
    """The query-sharded frontend odometry (see the module docstring):
    ``step(state, surf_pts, surf_mask, n_rounds=None)`` with
    ``odometry_step``'s result contract, equal to it up to the order of the
    ranks' sums. ``cfg.query_cap`` must divide the mesh (``LiliOmSystem``
    rounds it up). Its all-reduces go on ``group`` (default: the mesh's)."""
    from ..models.odometry import _fit_and_gn, _odo_finalize, _odo_prepare

    blk = rank_block(cfg.query_cap, mesh)
    dev = mesh_device(mesh)

    def reduce(x):
        return all_reduce_sum(mesh, x, group)

    def step(state, surf_pts, surf_mask, n_rounds: int | None = None):
        surf_pts, surf_mask = surf_pts.to(dev), surf_mask.to(dev)
        t_guess, q_guess, scan_q, scan_q_mask, map_pts, map_mask = _odo_prepare(
            state, surf_pts, surf_mask, cfg)
        q_blk, m_blk = scan_q[blk], scan_q_mask[blk]
        t, q = t_guess, q_guess
        n_corr = torch.zeros((), dtype=torch.int32, device=dev)
        for _ in range(cfg.scan_match_cnt if n_rounds is None else n_rounds):
            pw, d2, idx = world_knn_auto(t, q, q_blk, map_pts, k=cfg.k, p_mask=map_mask,
                                         q_mask=m_blk)
            t, q, n_corr = _fit_and_gn(t, q, q_blk, m_blk, pw, map_pts[idx], d2, cfg,
                                       reduce=reduce)
        return _odo_finalize(state, scan_q, scan_q_mask, surf_pts, surf_mask, t_guess,
                             q_guess, t, q, n_corr, cfg)

    return step


def sharded_knn(mesh, queries, map_pts, map_mask, k: int = 5):
    """Exact kNN with the map split over the ranks (P divisible by the
    mesh): each rank searches its block (B1 on the card), the (Q, k)
    candidates of every rank are gathered and merged (:func:`merge_topk`).
    Every rank passes the whole map and gets the replicated (d² (Q,k),
    global index (Q,k)). Slots without a neighbour hold (+inf, 0): they
    come from rank 0's candidates, whose empty slots give index 0, as the
    JAX merge gives."""
    blk = rank_block(map_pts.shape[0], mesh)
    d, i = knn_auto(queries, map_pts[blk], k=k, p_mask=map_mask[blk])
    d_all = all_gather_cat(mesh, d, dim=1)
    i_all = all_gather_cat(mesh, i + blk.start, dim=1)
    arg = merge_topk(d_all, k)
    return torch.gather(d_all, 1, arg), torch.gather(i_all, 1, arg)


def sharded_hessian_reduce(mesh, J, r):
    """(H, g) = (ΣJᵀJ, ΣJᵀr) with the rows split over the ranks (N divisible
    by the mesh; invalid rows zeroed by the caller). Every rank passes all
    rows and gets the sums."""
    blk = rank_block(J.shape[0], mesh)
    J, r = J[blk], r[blk]
    return all_reduce_sum(mesh, J.T @ J), all_reduce_sum(mesh, J.T @ r)
