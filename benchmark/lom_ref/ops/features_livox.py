"""Livox-Horizon feature extraction by the eigenvalue patch method, as
fixed-shape tensor ops (port of ``lili_om_tpu/ops/features_livox.py``).

* Range-image binning: points carry ``line`` 0..5 and a time ratio; column =
  ``round(ratio·(H−1))``, with a depth gate of 2–200 m and a reflectivity
  gate ``0.05 < curv < 25.45``. On a collision the last writer wins
  (``ops/scatter.py``), as the JAX scatter on the CPU does.
* Per 6-column × 6-line patch (stride 6, i = 5 … H−13): the eigen-
  decomposition of the unnormalized scatter matrix of the ≥ 25 valid cells.
* Edges: a per-line 9-tap depth gradient ``g1 = (Σ±4 − 8·d)/(8·d+1e-3)``,
  the per-line maximum if > 0.06 (first index on ties, ``-inf`` for
  invalid cells); the patch's candidates are accepted if their scatter has
  λ₂ > edge_thres·λ₁ and more than 3 lines contributed.
* Planes: a patch is planar if λ₀ < surf_thres·λ₁; its valid cells that are
  not the patch's edge cells become surf features carrying the plane normal.

``n_cols`` must match the stream's points per line per sweep (the Horizon:
24k points / 0.1 s / 6 lines = 4000): the classifier needs ≥ 25 valid
cells per 6×6 patch, so a stream binned into too wide an image (under ~70 %
column fill) yields zero features. A reduced-density simulation reduces
``n_cols`` to match.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device
from .fitting import eig3_symmetric
from .scatter import scatter_last


class LivoxFeatureConfig(NamedTuple):
    """Field for field as ``lili_om_tpu.ops.features_livox.LivoxFeatureConfig``."""

    n_lines: int = 6
    n_cols: int = 4000  # points per line per sweep (see the module docstring)
    surf_thres: float = 0.28
    edge_thres: float = 4.0
    min_depth: float = 2.0
    max_depth: float = 200.0
    min_curv: float = 0.05
    max_curv: float = 25.45
    grad_thres: float = 0.06
    patch: int = 6
    col_start: int = 5
    col_margin: int = 12


class LivoxFeatures(NamedTuple):
    surf_pts: torch.Tensor  # (P·L·S, 3)
    surf_normal: torch.Tensor  # (P·L·S, 3) patch plane normal (λ₀ eigenvector)
    surf_curv: torch.Tensor  # (P·L·S,) reflectivity channel
    surf_mask: torch.Tensor  # (P·L·S,)
    edge_pts: torch.Tensor  # (P·L, 3)
    edge_dir: torch.Tensor  # (P·L, 3) line direction (λ₂ eigenvector)
    edge_mask: torch.Tensor  # (P·L,)
    full_pts: torch.Tensor  # (L·H, 3) the binned image, flat
    full_mask: torch.Tensor  # (L·H,)
    # relative sweep times recovered from the image column (the column is
    # the time bin), for the ``if_to_deskew`` re-skew
    surf_rel_time: torch.Tensor | None = None  # (P·L·S,)
    edge_rel_time: torch.Tensor | None = None  # (P·L,)


def bin_livox_image(pts: torch.Tensor, line: torch.Tensor, ratio: torch.Tensor,
                    curv: torch.Tensor, valid: torch.Tensor, cfg: LivoxFeatureConfig):
    """Scatter an (N,·) Livox point stream into the (L, H) range image with
    the reference's gates. Rejected points write zeros into cell (0, 0);
    on a collision the last writer wins. Returns (img (L,H,3), curv (L,H),
    valid (L,H))."""
    L, H = cfg.n_lines, cfg.n_cols
    dep2 = torch.sum(pts * pts, dim=-1)
    ok = (valid & (line >= 0) & (line < L)
          & (dep2 > cfg.min_depth ** 2) & (dep2 < cfg.max_depth ** 2)
          & (curv > cfg.min_curv) & (curv < cfg.max_curv))
    col = torch.round(ratio * (H - 1)).to(torch.int32)
    ok = ok & (col >= 0) & (col < H)
    flat = torch.where(ok, line.to(torch.int64) * H + col.to(torch.int64), 0)
    img, img_curv = scatter_last(flat, L * H, torch.where(ok[:, None], pts, 0.0),
                                 torch.where(ok, curv, 0.0))
    img_valid = torch.zeros((L * H,), dtype=torch.int32, device=pts.device)
    img_valid.scatter_reduce_(0, flat, ok.to(torch.int32), reduce="amax")
    return img.reshape(L, H, 3), img_curv.reshape(L, H), (img_valid > 0).reshape(L, H)


def _depth_gradient(depth: torch.Tensor, cfg: LivoxFeatureConfig):
    """g1 image: 9-tap second difference along the columns, empty cells
    contributing depth 0; the columns wrap around (``roll``), as in the JAX
    package, and the patch range keeps the wrapped columns out."""
    acc = -8.0 * depth
    for s in range(-4, 5):
        if s == 0:
            continue
        acc = acc + torch.roll(depth, -s, dims=1)
    return acc / (8.0 * depth + 1e-3)


def extract_features_livox(img: torch.Tensor, img_curv: torch.Tensor, img_valid: torch.Tensor,
                           cfg: LivoxFeatureConfig = LivoxFeatureConfig(),
                           device=None) -> LivoxFeatures:
    """Feature extraction over a binned (L, H) image (see
    :func:`bin_livox_image`). Runs on ``device`` (None = the CUDA device)."""
    dev = resolve_device(device)
    img, img_curv, img_valid = img.to(dev), img_curv.to(dev), img_valid.to(dev)
    L, H = cfg.n_lines, cfg.n_cols
    S, i0 = cfg.patch, cfg.col_start
    n_patches = len(range(i0, H - cfg.col_margin, S))
    dtype = img.dtype

    # the square root taken in float64: torch's float32 sqrt on the CPU is
    # not correctly rounded (1 ulp off on ~0.7 % of inputs), and one ulp of
    # depth can move an argmax among near-equal gradients
    depth = torch.where(img_valid, torch.sqrt(torch.sum(img * img, dim=-1).double()).to(dtype),
                        0.0)
    g1 = _depth_gradient(depth, cfg)

    # (L, P, S, ·) patch views
    span = n_patches * S
    ppts = img[:, i0:i0 + span].reshape(L, n_patches, S, 3)
    pval = img_valid[:, i0:i0 + span].reshape(L, n_patches, S)
    pcurv = img_curv[:, i0:i0 + span].reshape(L, n_patches, S)
    pg1 = g1[:, i0:i0 + span].reshape(L, n_patches, S)

    # patch scatter matrix over all L·S cells (unnormalized)
    w = pval.to(dtype)
    num = torch.sum(w, dim=(0, 2))
    ctr = torch.sum(ppts * w[..., None], dim=(0, 2)) / torch.clamp(num, min=1.0)[:, None]
    d0 = (ppts - ctr[None, :, None, :]) * w[..., None]
    cov = torch.einsum("lpsi,lpsj->pij", d0, d0)
    evals, evecs = eig3_symmetric(cov)
    patch_has_pts = num >= 25

    # edge candidates: per line, the largest g1 if above the gate
    g1m = torch.where(pval, pg1, float("-inf"))
    best_j = torch.argmax(g1m, dim=-1)  # (L,P), first index on ties
    best_g = torch.gather(g1m, 2, best_j[..., None])[..., 0]
    line_has = torch.isfinite(best_g) & (best_g > cfg.grad_thres)
    cand_pts = torch.gather(ppts, 2, best_j[..., None, None].expand(L, n_patches, 1, 3))[:, :, 0]

    wl = line_has.to(dtype)
    n_lines_hit = torch.sum(wl, dim=0)
    ectr = torch.sum(cand_pts * wl[..., None], dim=0) / torch.clamp(n_lines_hit, min=1.0)[:, None]
    ed = (cand_pts - ectr[None]) * wl[..., None]
    ecov = torch.einsum("lpi,lpj->pij", ed, ed)
    eevals, eevecs = eig3_symmetric(ecov)
    edge_patch_ok = (eevals[:, 2] > cfg.edge_thres * eevals[:, 1]) & (n_lines_hit > 3)
    edge_dir = eevecs[:, :, 2]
    edge_mask = line_has & edge_patch_ok[None, :] & patch_has_pts[None, :]  # (L,P)

    # surf patches, without the patch's edge cells
    surf_patch_ok = (evals[:, 0] < cfg.surf_thres * evals[:, 1]) & patch_has_pts
    surf_normal = evecs[:, :, 0]
    edge_cell = torch.zeros(pval.shape, dtype=torch.bool, device=dev)
    edge_cell.scatter_(2, best_j[..., None], edge_mask[..., None])
    surf_mask = pval & surf_patch_ok[None, :, None] & ~edge_cell

    surf_pts = ppts.permute(1, 0, 2, 3).reshape(-1, 3)
    surf_nrm = surf_normal[:, None, None, :].expand(n_patches, L, S, 3).reshape(-1, 3)
    surf_cv = pcurv.permute(1, 0, 2).reshape(-1)
    surf_m = surf_mask.permute(1, 0, 2).reshape(-1)
    edge_out_pts = cand_pts.permute(1, 0, 2).reshape(-1, 3)
    edge_out_dir = edge_dir[:, None, :].expand(n_patches, L, 3).reshape(-1, 3)
    edge_out_mask = edge_mask.T.reshape(-1)

    # relative times from the column: cell (l, p, s) sits at column
    # i0 + p·S + s, ratio = col / (H − 1)
    cols_ps = (i0 + torch.arange(n_patches, dtype=dtype, device=dev)[:, None] * S
               + torch.arange(S, dtype=dtype, device=dev)[None, :]) / (H - 1)
    surf_rel = cols_ps[:, None, :].expand(n_patches, L, S).reshape(-1)
    pi = torch.arange(n_patches, device=dev)[None, :]
    edge_rel = ((i0 + pi * S + best_j).to(dtype) / (H - 1)).T.reshape(-1)

    return LivoxFeatures(
        surf_pts=surf_pts, surf_normal=surf_nrm, surf_curv=surf_cv, surf_mask=surf_m,
        edge_pts=edge_out_pts, edge_dir=edge_out_dir, edge_mask=edge_out_mask,
        full_pts=img.reshape(-1, 3), full_mask=img_valid.reshape(-1),
        surf_rel_time=surf_rel, edge_rel_time=edge_rel)
