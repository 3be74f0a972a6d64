"""Plain PyTorch versions of the point->pillar scatter-max and its gradient
(``repro/kernels/pillar_scatter/ref.py`` and the VJP of
``repro/ops/api.py:96-112``).

Points that are invalid, or whose pillar id lies outside [0, G), are
dropped (the Pallas kernel's rule: its id -1 never matches a pillar row);
empty pillars, and pillars whose maximum is not finite, read 0.

The gradient is JAX's: ``jax.vjp`` of ``.at[idx].max(...)`` splits a
pillar's cotangent equally among the points that tie for its maximum,
each taking ``ct * (1 / count)`` (a multiply by a reciprocal, not a
division), and gives every other point 0. It is written out here rather
than taken from autograd through ``scatter_reduce``, which divides and so
can differ from JAX by an ulp; the CUDA kernel is held to this function
bit for bit.
"""
from __future__ import annotations

import torch


def _kept(pillar_idx: torch.Tensor, valid: torch.Tensor, n_pillars: int
          ) -> torch.Tensor:
    return valid & (pillar_idx >= 0) & (pillar_idx < n_pillars)


def pillar_scatter_ref(feats: torch.Tensor, pillar_idx: torch.Tensor,
                       valid: torch.Tensor, n_pillars: int) -> torch.Tensor:
    """(N, C) features, (N,) int ids, (N,) bool -> (G, C) max per pillar."""
    kept = _kept(pillar_idx, valid, n_pillars)
    f = feats[kept]
    idx = pillar_idx[kept].long()[:, None].expand(-1, feats.shape[1])
    out = feats.new_full((n_pillars, feats.shape[1]), -torch.inf)
    out.scatter_reduce_(0, idx, f, "amax")
    return torch.where(torch.isfinite(out), out, 0.0)


def pillar_scatter_bwd_ref(feats: torch.Tensor, pillar_idx: torch.Tensor,
                           valid: torch.Tensor, out: torch.Tensor,
                           ct: torch.Tensor) -> torch.Tensor:
    """Gradient of :func:`pillar_scatter_ref` for the features: (N, C).

    ``out`` is the forward's (G, C) result and ``ct`` its cotangent. A point
    ties where it is kept and equals its pillar's output. A pillar whose
    raw maximum is +inf or NaN reads 0 and passes no gradient (JAX's
    ``where(isfinite, ., 0)``); a point holding +inf or NaN marks it.
    """
    g, c = out.shape
    kept = _kept(pillar_idx, valid, g)
    safe = torch.where(kept, pillar_idx.long(), 0)
    at = safe[:, None].expand(-1, c)
    tie = kept[:, None] & (feats == out[safe])
    poison = kept[:, None] & ((feats == torch.inf) | torch.isnan(feats))
    count = torch.zeros((g, c), dtype=torch.int32, device=out.device)
    count.scatter_add_(0, at, tie.to(torch.int32))
    bad = torch.zeros((g, c), dtype=torch.int32, device=out.device)
    bad.scatter_add_(0, at, poison.to(torch.int32))
    share = ct * (1.0 / count.clamp_min(1).to(ct.dtype))
    share = torch.where(bad > 0, 0.0, share)
    return torch.where(tie, share[safe], 0.0)
