"""Query-sharded backend fusion (port of ``lili_om_tpu/parallel/dist_fusion.py``):
the per-keyframe sliding-window step with the window's correspondence
queries split over the ranks.

The heavy part of ``fusion_step`` is the window's correspondence work: the
5-NN searches of the flattened window's W·Sc surf and W·Ec edge query rows
against the incremental maps, and the plane and line fits of those rows.
Here every rank is a process running the same program (SPMD, as in
``parallel/sharded.py``):

* every rank holds the whole state and runs the ingest (IMU propagation
  and preintegration, the window shift, the ring insert and the incremental
  map-table merges, B4 on the card);
* each rank searches (B1 on the card) and fits its contiguous block of the
  surf rows and of the edge rows (:func:`dist_fusion_blocks`) against the
  replicated maps, with the single-device code (``models/fusion.py:
  match_rows``);
* the factor rows of the blocks are gathered in rank order, which is row
  order, in ONE ``all_gather`` per keyframe (per row: surf normal, offset,
  score and mask, 6 values; edge end points, score and mask, 8 values);
* the map gate (``gate_batches``) and the LM window solve and Schur
  marginalization (``_finish``) then run on the whole batches on every
  rank, so every rank takes the same branches and ends with the same state.

The search answers each query independently of the others, and the fits
are row-wise, so the gathered batches equal the single-device ones bit for
bit and the step equals ``fusion_step`` whatever the world size: masked
query rows, and a rank whose block holds no valid query, come back as the
whole-window search returns them. ``n_surf_corr`` / ``n_edge_corr`` and the
marginalization's lidar rows are computed from the gathered batches; no
per-rank quantity reaches the result.

How this differs from the JAX layout: JAX jits the unchanged
``fusion_step`` with GSPMD shardings that split the ``hist_*`` capacity
axis (the per-keyframe point capacity), and XLA partitions the searches
and fits by it and all-reduces the 45×45 normal equations in each LM
iteration. PyTorch has no whole-program partitioner, so the split is made
where the work is, in the searches and fits, and the state stays
replicated (at ``fr_iosb_rot`` the ring is 2.4 MB), the precedent of
``map_fusion.py``'s replicated ring. The cross-rank traffic is one gather of
the factor rows per keyframe, not one all-reduce per LM iteration.

``parallel/map_fusion.py`` splits the map instead (its memory scales as
1/n); this module keeps the whole map on every rank, the JAX docstring's
"fallback when the map fits every chip anyway", which on an 80 GB card it
always does.
"""
from __future__ import annotations

import torch

from ..factors.lidar import EdgeFactorBatch, PlaneFactorBatch
from ..models.fusion import (FusionConfig, FusionState, _build_maps, _finish, _ingest,
                             _zero_batches, gate_batches, init_fusion_state, match_rows,
                             window_batches)
from ..ops.preintegration import ImuNoise
from ..utils.metrics import span
from .sharded import all_gather_cat, mesh_device

# values per gathered factor row: surf (normal 3, offset, score, mask), edge
# (point_a 3, point_b 3, score, mask)
_SURF_W, _EDGE_W = 6, 8


def _check_axis(mesh, axis):
    if axis is not None and axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"the mesh has no axis {axis!r} (its axes: {mesh.mesh_dim_names})")


def dist_fusion_blocks(mesh, cfg: FusionConfig) -> list[tuple[slice, slice]]:
    """Each rank's (surf rows, edge rows) of the flattened window, in rank
    order: contiguous blocks of the W·Sc surf and W·Ec edge query rows
    (both must divide the mesh)."""
    n = mesh.size()
    Qs, Qe = cfg.window * cfg.kf_surf_cap, cfg.window * cfg.kf_edge_cap
    if Qs % n or Qe % n:
        raise ValueError(f"the window's {Qs} surf and {Qe} edge rows must divide the "
                         f"{n}-rank mesh")
    bs, be = Qs // n, Qe // n
    return [(slice(r * bs, (r + 1) * bs), slice(r * be, (r + 1) * be)) for r in range(n)]


def _gather_batches(mesh, sb: PlaneFactorBatch, eb: EdgeFactorBatch, surf_pts, edge_pts):
    """Every rank's block of factor rows in rank order, as whole flat
    batches (one ``all_gather``); the query points are every rank's own."""
    dtype = sb.normals.dtype
    surf = torch.cat([sb.normals, sb.offsets[:, None], sb.scores[:, None],
                      sb.mask[:, None].to(dtype)], dim=1)
    edge = torch.cat([eb.point_a, eb.point_b, eb.scores[:, None],
                      eb.mask[:, None].to(dtype)], dim=1)
    parts = all_gather_cat(mesh, torch.cat([surf.reshape(-1), edge.reshape(-1)])[None], dim=0)
    ns = surf.numel()
    surf = parts[:, :ns].reshape(-1, _SURF_W)
    edge = parts[:, ns:].reshape(-1, _EDGE_W)
    return (PlaneFactorBatch(pts=surf_pts, normals=surf[:, 0:3], offsets=surf[:, 3],
                             scores=surf[:, 4], mask=surf[:, 5] > 0.5),
            EdgeFactorBatch(pts=edge_pts, point_a=edge[:, 0:3], point_b=edge[:, 3:6],
                            scores=edge[:, 6], mask=edge[:, 7] > 0.5))


def make_distributed_fusion(mesh, cfg: FusionConfig, noise: ImuNoise, axis: str | None = None,
                            warmup: bool = False):
    """The query-sharded fusion step over the 1-D ``mesh``
    (``parallel/sharded.py:make_mesh``) on this rank's device. Returns
    ``(step_fn, state_shardings)``: ``step_fn(state, surf_pts, surf_mask,
    surf_refl, edge_pts, edge_mask, dts, accs, gyrs, vmask)`` (JAX's
    argument order; every rank passes the whole keyframe and holds the
    whole state, :func:`make_sharded_state`) returns ``fusion_step``'s
    ``(new_state, FusionOut)``, the same on every rank; ``state_shardings``
    is each rank's (surf rows, edge rows) of the flattened window, in rank
    order (:func:`dist_fusion_blocks`). ``axis``: the mesh's axis name, as
    JAX takes it (the mesh is 1-D)."""
    _check_axis(mesh, axis)
    blocks = dist_fusion_blocks(mesh, cfg)
    surf_rows, edge_rows = blocks[mesh.get_local_rank()]
    dev = mesh_device(mesh)

    def step(state: FusionState, surf_pts, surf_mask, surf_refl, edge_pts, edge_mask,
             imu_dts, imu_accs, imu_gyrs, imu_valid):
        args = [a.to(dev) for a in (surf_pts, surf_mask, surf_refl, edge_pts, edge_mask,
                                    imu_dts, imu_accs, imu_gyrs, imu_valid)]
        dtype = state.t.dtype
        mid = _ingest(state, *args, cfg, noise)
        if warmup:
            return _finish(state, mid, *_zero_batches(mid, dtype), cfg, noise, warmup)
        with span("fusion.match"):
            if not cfg.incremental_map:
                # the batch maps of default_map_and_match, from the pre-insert ring
                ms, mr, sm, me, em, enough = _build_maps(state, cfg)
                mid = mid._replace(map_surf=ms, map_refl=mr, map_surf_mask=sm, map_edge=me,
                                   map_edge_mask=em, enough_map=enough)
            sb, eb = _gather_batches(mesh, *match_rows(mid, cfg, surf_rows, edge_rows),
                                     mid.win_surf_b.reshape(-1, 3),
                                     mid.win_edge_b.reshape(-1, 3))
            sb, eb = gate_batches(*window_batches(sb, eb, cfg), mid.enough_map, dtype)
        return _finish(state, mid, sb, eb, cfg, noise, warmup)

    return step, blocks


def make_sharded_state(mesh, cfg: FusionConfig, noise: ImuNoise, dtype=torch.float32,
                       axis: str | None = None) -> FusionState:
    """``init_fusion_state`` on this rank's device: every rank holds the
    whole state (JAX places it with its shardings)."""
    _check_axis(mesh, axis)
    return init_fusion_state(cfg, noise, dtype=dtype, device=mesh_device(mesh))
