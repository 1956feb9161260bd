"""Prior factors (port of ``lili_om_tpu/factors/prior.py``): the
marginalization (Schur-complement) prior, its inert start-up placeholder and
the speed-bias prior."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.math import quat_conj, quat_mul


class MarginalPrior(NamedTuple):
    """Linearized prior over the tangent stack of the remaining window
    states; D = 15·(window−1)."""

    J: torch.Tensor  # (D, D)
    r0: torch.Tensor  # (D,)
    t0: torch.Tensor  # (K, 3) linearization points
    q0: torch.Tensor  # (K, 4)
    v0: torch.Tensor  # (K, 3)
    ba0: torch.Tensor  # (K, 3)
    bg0: torch.Tensor  # (K, 3)
    valid: torch.Tensor  # () bool — false until the first marginalization


def box_minus(t, q, v, ba, bg, t0, q0, v0, ba0, bg0):
    """Per-keyframe 15-dof tangent x ⊟ x₀ with ``2·vec(q₀⁻¹ ⊗ q)`` and the
    w<0 sign flip."""
    dq = quat_mul(quat_conj(q0), q)
    sign = torch.where(dq[..., :1] >= 0.0, 1.0, -1.0).to(dq.dtype)
    dth = 2.0 * sign * dq[..., 1:]
    return torch.cat([t - t0, dth, v - v0, ba - ba0, bg - bg0], dim=-1)


def marginal_prior_residual(prior: MarginalPrior, t, q, v, ba, bg):
    """r = r₀ + J·dx over the stacked retained keyframes → ((D,), (D,D));
    zero while ``prior.valid`` is false."""
    dx = box_minus(t, q, v, ba, bg, prior.t0, prior.q0, prior.v0,
                   prior.ba0, prior.bg0).reshape(-1)
    r = prior.r0 + prior.J @ dx
    on = prior.valid.to(r.dtype)
    return r * on, prior.J * on


def speed_bias_prior(v, ba, bg, v0, ba0, bg0, weights=None):
    """9-dof residual + (constant, diagonal) Jacobian; uniform weight 15 by
    default."""
    if weights is None:
        weights = torch.full((9,), 15.0, dtype=v.dtype, device=v.device)
    r = weights * torch.cat([v - v0, ba - ba0, bg - bg0])
    return r, torch.diag(weights)


def identity_prior(window_k: int, dtype=torch.float32, device=None) -> MarginalPrior:
    """An inert prior placeholder (``valid`` false) for pipeline start-up."""
    D = 15 * window_k
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    return MarginalPrior(
        J=z(D, D), r0=z(D), t0=z(window_k, 3),
        q0=torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device).repeat(window_k, 1),
        v0=z(window_k, 3), ba0=z(window_k, 3), bg0=z(window_k, 3),
        valid=torch.zeros((), dtype=torch.bool, device=device))
