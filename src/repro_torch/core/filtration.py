"""Point filtration — Algorithm 1 of the paper.

For each object's point cluster (obtained by point projection), purify the
cluster by keeping only points near the *critical boundary point*: the point
nearest to the LiDAR origin. If fewer than ``M_T`` points survive, step the
critical point outward by at least ``S_T`` and retry, up to three iterations.

Two robustness refinements over the literal Algorithm 1 (both in the
paper's own "use previous detections" spirit, §3.3/§2.3; ablatable):
* ``prior_center`` — for objects associated with a previous-frame box, the
  critical point is chosen nearest to the *predicted object center* rather
  than the sensor origin, which prevents sparse objects from stepping onto
  background clutter behind them;
* when no iteration reaches ``M_T`` points, the best (largest) ball seen is
  kept instead of the last one.

Port of ``repro/core/filtration.py``, batched over objects. Under ``vmap``
the JAX ``while_loop`` (``filtration.py:91``) runs until every object's
condition is false and freezes the objects that are done; the body is not
idempotent (the critical point moves), so here every update is masked with
the per-object condition, and the loop runs its ``max_iter`` bound on the
device with no host check.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.fp import norm

_BIG = 1e9


class FiltrationParams(NamedTuple):
    """Paper §4: F_T = 4.5 m, M_T = 24 points, S_T = 12 m, max 3 iterations."""

    f_t: float = 4.5
    m_t: int = 24
    s_t: float = 12.0
    max_iter: int = 3
    use_prior: bool = True


def filter_clusters(points: torch.Tensor, valid: torch.Tensor,
                    params: FiltrationParams = FiltrationParams(),
                    prior_centers: Optional[torch.Tensor] = None,
                    has_prior: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Algorithm 1 over objects.

    Args:
      points: (O, P, 3) per-object point buffers.
      valid:  (O, P) validity masks.
      prior_centers: optional (O, 3) predicted centers.
      has_prior: optional (O,) bools.

    Returns:
      (O, P) bool keep-masks.
    """
    o = points.shape[0]
    dev = points.device
    rows = torch.arange(o, device=dev)
    # Line 4: distance from all points to the LiDAR origin.
    d_origin = torch.where(valid, norm(points), _BIG)
    n_valid = valid.sum(dim=1)

    # Line 5: nearest point to the origin = initial critical boundary point.
    crit = d_origin.argmin(dim=1)
    if params.use_prior and prior_centers is not None \
            and has_prior is not None:
        d_prior = torch.where(valid, norm(points - prior_centers[:, None]),
                              _BIG)
        crit = torch.where(has_prior, d_prior.argmin(dim=1), crit)

    idx = torch.zeros_like(valid)
    best_idx = torch.zeros_like(valid)
    best_n = torch.zeros((o,), dtype=torch.int64, device=dev)
    it = torch.zeros((o,), dtype=torch.int64, device=dev)
    for _ in range(params.max_iter):
        go = (idx.sum(dim=1) < params.m_t) & (it < params.max_iter) \
            & (n_valid > 0)
        # Line 7: distance from all points to the critical boundary point.
        d_crit = norm(points - points[rows, crit][:, None])
        # Line 8: keep points within F_T of the critical point.
        new_idx = valid & (d_crit < params.f_t)
        n = new_idx.sum(dim=1)
        better = go & (n > best_n)
        best_idx = torch.where(better[:, None], new_idx, best_idx)
        best_n = torch.where(go, torch.maximum(n, best_n), best_n)
        # Line 9: next critical point = nearest point at least S_T further
        # from the origin than the current critical point.
        thresh = d_origin[rows, crit] + params.s_t
        cand = torch.where(d_origin >= thresh[:, None], d_origin, _BIG)
        has_cand = cand.amin(dim=1) < _BIG
        nxt = torch.where(has_cand, cand.argmin(dim=1), crit)
        idx = torch.where(go[:, None], new_idx, idx)
        crit = torch.where(go, nxt, crit)
        it = it + go.long()
    # If no ball reached M_T, fall back to the best attempt.
    out = torch.where((idx.sum(dim=1) >= params.m_t)[:, None], idx,
                      torch.where((best_n > 0)[:, None], best_idx, idx))
    return out & valid
