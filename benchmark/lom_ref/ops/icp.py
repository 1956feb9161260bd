"""Fixed-iteration point-to-plane ICP, the loop-closure aligner (port of
``lili_om_tpu/ops/icp.py``).

Each iteration: the 5-NN of every source point in the target (the CUDA kNN
kernel on the card), a centred covariance plane fit per neighbourhood, the
plane-distance gate, and one Huber-weighted Gauss-Newton step. The loop has
a fixed count and no host sync inside, so it enqueues all its work at once.
Fitness is PCL's ``getFitnessScore`` (mean squared 1-NN distance of matched
source points), over the best ``trim`` fraction when ``trim`` < 1.

The searches pass the source mask as their query mask: rows of padding
sources come back as (+inf, 0) instead of a distance, which changes no
valid row and lets the kernels skip blocks of padding.

The searches go through :func:`~lili_om_tpu_torch.ops.knn.searcher`: where
they take the pruned kernel B3, it prepares the target and orders the
source once per call, so each of the ``n_iters + 1`` searches is one kernel
launch.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..factors.lidar import PlaneFactorBatch, huber_weight, plane_residual
from ..ops.fitting import eig3_symmetric
from ..ops.knn import searcher
from ..solver.gn import gn_update
from ..utils.math import exp_so3, quat_mul, quat_normalize, quat_rotate


class IcpResult(NamedTuple):
    t: torch.Tensor  # (3,) source→target transform
    q: torch.Tensor  # (4,)
    fitness: torch.Tensor  # () mean squared NN distance (PCL getFitnessScore)
    n_matched: torch.Tensor  # () int32


def icp_point_to_plane(src_pts, src_mask, tgt_pts, tgt_mask, t_init, q_init,
                       n_iters: int = 20, k: int = 5, max_corr_dist: float = 30.0,
                       plane_tol: float = 0.3, damping: float = 1e-6,
                       trim: float = 0.7) -> IcpResult:
    """Align ``src`` onto ``tgt``; returns the refined transform + fitness.

    ``trim``: fitness over the best ``trim`` fraction of matched source
    points (Trimmed-ICP); ``trim=1.0`` is PCL's untrimmed score, which
    occlusion shadows inflate on a partial-overlap revisit."""
    dtype = src_pts.dtype
    search = searcher(tgt_pts, tgt_mask, src_pts, src_mask)
    t, q = t_init, q_init
    for _ in range(n_iters):
        pw = quat_rotate(q[None, :], src_pts) + t[None, :]
        d2, idx = search(pw, k)
        nbrs = tgt_pts[idx]
        nn_ok = d2[:, 0] < max_corr_dist ** 2
        # centred covariance plane fit (smallest eigenvector)
        ctr = torch.mean(nbrs, dim=-2)
        dd = nbrs - ctr[:, None, :]
        cov = torch.einsum("qki,qkj->qij", dd, dd)
        _, evecs = eig3_symmetric(cov)
        normal = evecs[..., :, 0]
        d_off = -torch.sum(normal * ctr, dim=-1)
        pd_nbr = torch.abs(torch.einsum("qki,qi->qk", nbrs, normal) + d_off[:, None])
        plane_ok = torch.all(pd_nbr <= plane_tol, dim=-1)
        keep = src_mask & nn_ok & plane_ok
        batch = PlaneFactorBatch(src_pts, normal, d_off, keep.to(dtype), keep)
        r, J = plane_residual(t, q, batch)
        # Huber IRLS: occlusion-shadow points must not drag the alignment
        w = huber_weight(r * r, 0.3)
        delta = gn_update(J, r, damping=damping, w=w)
        t = t + delta[:3]
        q = quat_normalize(quat_mul(q, exp_so3(delta[3:6])))

    pw = quat_rotate(q[None, :], src_pts) + t[None, :]
    d2, _ = search(pw, 1)
    d2 = d2[:, 0]
    ok = src_mask & (d2 < max_corr_dist ** 2)
    n = torch.sum(ok.to(torch.int32))
    if trim >= 1.0:
        num, den = torch.sum(torch.where(ok, d2, 0.0)), n
    else:
        d2_s, _ = torch.sort(torch.where(ok, d2, float("inf")))
        # float32 product, as the JAX package takes it
        n_keep = torch.clamp((n.to(torch.float32) * trim).to(torch.int32), min=1)
        in_trim = torch.arange(d2_s.shape[0], device=d2_s.device) < n_keep
        num = torch.sum(torch.where(in_trim & torch.isfinite(d2_s), d2_s, 0.0))
        den = torch.where(n > 0, n_keep, 0)
    # no matches → +inf (PCL returns max double), so fitness gates reject
    fitness = torch.where(den > 0, num / torch.clamp(den, min=1), float("inf"))
    return IcpResult(t=t, q=q, fitness=fitness, n_matched=n.to(torch.int32))
