"""The map-sharded backend fusion (port of
``lili_om_tpu/parallel/map_fusion.py``): the local map, the big operand of
the per-keyframe step, is split over the ranks.

* Rank r builds its map shard from its contiguous block of the physical
  ring slots ``[r·Mp/n, (r+1)·Mp/n)``, ``Mp = local_map_width +
  map_slots_pad`` (:func:`map_sharded_state_shardings`), voxel-downsampled
  to ``map_surf_cap/n`` and ``map_edge_cap/n`` centroids (B4 on the card):
  the map's memory and build work scale as 1/n.
* The window queries are replicated; each rank 5-NN-searches its shard
  with its valid queries (B1 on the card): the O(Q·P) distance work scales
  as 1/n once the ring is full (it fills from slot 0, so until it wraps
  the first ranks' shards hold most of the map).
* The per-rank candidates — surf d², neighbours and reflectivity, edge d²
  and neighbours — and the two map counts go out in ONE ``all_gather`` per
  keyframe (Q_surf·k·20 + Q_edge·k·16 bytes in float32: 0.86 MB at
  ``fr_iosb_rot``), are laid out rank-major as (Q, n·k), and the first k of
  a stable sort on d² are kept (``parallel/sharded.py:merge_topk``): the
  exact global k-NN, since the global top-k lies in the union of the
  per-rank top-k. The counts are summed and feed ``enough_map``.
* The plane and line fits and gates run replicated on the merged
  candidates, with the single-device code. Results equal the single-device
  batch build (``incremental_map=False``) up to voxels that span two
  ranks' keyframes: each rank deduplicates its own.

The keyframe ring stays replicated: JAX shards the ``hist_*`` fields over
the slots, but that is a placement choice, and at ``fr_iosb_rot`` the whole
ring is 2.4 MB. So every rank keeps the whole ``FusionState``, reads only
its slot block when it builds its map shard, and ``fusion_step``'s ingest,
solve, write-back and marginalization, the health check, the loop-closure
correction and the checkpoint run unchanged under a mesh.

At start-up the ring fills from slot 0, so a rank whose block holds no
keyframe yet searches an all-invalid shard (walk bound 0): every candidate
is (+inf, ·), and the merge ranks them after every finite one.
"""
from __future__ import annotations

import torch

from ..models.fusion import (FusionConfig, FusionState, _build_maps, edge_fit_and_gate,
                             fusion_step, surf_fit_and_gate, window_batches, window_queries)
from ..ops.knn import knn_auto
from ..ops.preintegration import ImuNoise
from .sharded import all_gather_cat, merge_topk, mesh_device


def _check_mesh_config(cfg: FusionConfig, n: int):
    Mp = cfg.local_map_width + cfg.map_slots_pad
    if Mp % n:
        raise ValueError(f"physical ring slots {Mp} must divide the {n}-rank mesh "
                         "(LiliOmSystem(mesh=…) pads them via FusionConfig.map_slots_pad)")
    if cfg.map_surf_cap % n or cfg.map_edge_cap % n:
        raise ValueError("the map caps must divide the mesh (LiliOmSystem(mesh=…) rounds "
                         "them up)")


def map_sharded_state_shardings(mesh, cfg: FusionConfig) -> list[slice]:
    """Each rank's block of the physical ring slots, in rank order: the
    slots whose keyframes build its map shard (JAX shards the ``hist_*``
    fields so; here every rank holds them all)."""
    n = mesh.size()
    _check_mesh_config(cfg, n)
    b = (cfg.local_map_width + cfg.map_slots_pad) // n
    return [slice(r * b, (r + 1) * b) for r in range(n)]


class MapShardedMatch:
    """``fusion_step``'s ``match_fn`` over the mesh (see the module
    docstring). Returns (surf_batches, edge_batches, enough_map)."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __call__(self, state: FusionState, ts, qs, win_surf_b, win_surf_mask, win_surf_refl,
                 win_edge_b, win_edge_mask, cfg: FusionConfig):
        n, k = self.mesh.size(), cfg.k
        block = map_sharded_state_shardings(self.mesh, cfg)[self.mesh.get_local_rank()]
        pw_surf, pw_edge = window_queries(ts, qs, win_surf_b, win_edge_b, cfg)
        map_s, map_refl, smask, map_e, emask, _ = _build_maps(
            state, cfg, block, cfg.map_surf_cap // n, cfg.map_edge_cap // n)
        surf_qm, edge_qm = win_surf_mask.reshape(-1), win_edge_mask.reshape(-1)
        d2s, idxs = knn_auto(pw_surf, map_s, k=k, p_mask=smask, q_mask=surf_qm)
        d2e, idxe = knn_auto(pw_edge, map_e, k=k, p_mask=emask, q_mask=edge_qm)
        # one gather: (Qs·k·5) surf [d², xyz, refl], (Qe·k·4) edge [d², xyz]
        # and the two map counts, per rank
        surf = torch.cat([d2s[..., None], map_s[idxs], map_refl[idxs][..., None]], dim=-1)
        edge = torch.cat([d2e[..., None], map_e[idxe]], dim=-1)
        counts = torch.stack([smask.sum(), emask.sum()]).to(surf.dtype)
        flat = torch.cat([surf.reshape(-1), edge.reshape(-1), counts])
        parts = all_gather_cat(self.mesh, flat[None], dim=0)  # (n, ·)
        ns, ne = surf.numel(), edge.numel()
        surf_all = parts[:, :ns].reshape((n,) + surf.shape).transpose(0, 1).reshape(
            surf.shape[0], n * k, 5)
        edge_all = parts[:, ns:ns + ne].reshape((n,) + edge.shape).transpose(0, 1).reshape(
            edge.shape[0], n * k, 4)
        count_s, count_e = parts[:, ns + ne:].sum(dim=0)

        arg = merge_topk(surf_all[..., 0], k)
        s_sel = torch.gather(surf_all, 1, arg[..., None].expand(-1, -1, 5))
        arg = merge_topk(edge_all[..., 0], k)
        e_sel = torch.gather(edge_all, 1, arg[..., None].expand(-1, -1, 4))

        sb_flat = surf_fit_and_gate(win_surf_b.reshape(-1, 3), pw_surf, surf_qm,
                                    win_surf_refl.reshape(-1), s_sel[..., 0], s_sel[..., 1:4],
                                    s_sel[..., 4], cfg)
        eb_flat = edge_fit_and_gate(win_edge_b.reshape(-1, 3), edge_qm, e_sel[..., 0],
                                    e_sel[..., 1:4], cfg)
        return window_batches(sb_flat, eb_flat, cfg) + ((count_s > 50) & (count_e > 0),)


def make_map_sharded_fusion(mesh, cfg: FusionConfig, noise: ImuNoise, warmup: bool = False):
    """``fusion_step`` with the map-sharded match phase on this rank's
    device. Forces ``incremental_map=False``: the match maps come from the
    ring shards, so the single-device tables would be dead weight (the
    state must be made with the same config). Returns (step_fn, each
    rank's slot block)."""
    cfg = cfg._replace(incremental_map=False)
    blocks = map_sharded_state_shardings(mesh, cfg)
    match, dev = MapShardedMatch(mesh), mesh_device(mesh)

    def step(state, surf_pts, surf_mask, surf_refl, edge_pts, edge_mask, imu_dts, imu_accs,
             imu_gyrs, imu_valid):
        return fusion_step(state, surf_pts, surf_mask, surf_refl, edge_pts, edge_mask,
                           imu_dts, imu_accs, imu_gyrs, imu_valid, cfg=cfg, noise=noise,
                           warmup=warmup, match_fn=match, device=dev)

    return step, blocks


def make_map_sharded_system_step(mesh, cfg: FusionConfig, noise: ImuNoise):
    """The warmup and main variants, for ``LiliOmSystem(mesh=…)``:
    (warm, main, each rank's slot block)."""
    warm, blocks = make_map_sharded_fusion(mesh, cfg, noise, warmup=True)
    main, _ = make_map_sharded_fusion(mesh, cfg, noise, warmup=False)
    return warm, main, blocks
