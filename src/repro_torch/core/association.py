"""Tracking association (§3.2): IoU cost + optimal assignment.

The paper associates Kalman-predicted boxes with current 2D detections using
the Hungarian algorithm on an IoU criterion, rejecting pairs below a
threshold (0.3 by default, Fig. 16c/d).

Port of ``repro/core/association.py``:

* :func:`hungarian_numpy` — exact O(n^3) Jonker-Volgenant-style potentials
  algorithm in NumPy, copied as the test oracle.
* :func:`auction_assign` — Bertsekas auction with epsilon scaling. The JAX
  version runs each phase as a ``lax.while_loop`` (``association.py:121``)
  of up to 4000 bidding rounds. Here each round is masked with the loop's
  own condition (``any unassigned & it < max_iter``) — once every person is
  assigned, a round changes nothing but the counter, which the mask also
  holds — and the host tests for the end only every
  :data:`CHECK_EVERY` rounds, so the card is not synchronised once per
  round. The result is exactly the while-loop's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import boxes as box_ops

_NEG = -1e9
# float32(1 / 1000), the factor XLA's jit uses for "/ 1000.0".
_INV_1000 = float(np.float32(1e-3))

# Bidding rounds between two host checks for the end of an auction phase.
CHECK_EVERY = 8


def hungarian_numpy(cost: np.ndarray) -> np.ndarray:
    """Exact min-cost assignment. cost: (n, m) with n <= m.

    Returns row_to_col: (n,) column index per row.
    """
    cost = np.asarray(cost, dtype=np.float64)
    n, m = cost.shape
    assert n <= m, "requires n <= m (transpose first)"
    INF = 1e18
    u = np.zeros(n + 1)
    v = np.zeros(m + 1)
    p = np.zeros(m + 1, dtype=np.int64)  # p[j] = row matched to col j (1-based)
    way = np.zeros(m + 1, dtype=np.int64)
    for i in range(1, n + 1):
        p[0] = i
        j0 = 0
        minv = np.full(m + 1, INF)
        used = np.zeros(m + 1, dtype=bool)
        while True:
            used[j0] = True
            i0 = p[j0]
            delta = INF
            j1 = -1
            for j in range(1, m + 1):
                if not used[j]:
                    cur = cost[i0 - 1, j - 1] - u[i0] - v[j]
                    if cur < minv[j]:
                        minv[j] = cur
                        way[j] = j0
                    if minv[j] < delta:
                        delta = minv[j]
                        j1 = j
            for j in range(m + 1):
                if used[j]:
                    u[p[j]] += delta
                    v[j] -= delta
                else:
                    minv[j] -= delta
            j0 = j1
            if p[j0] == 0:
                break
        while j0 != 0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    row_to_col = np.zeros(n, dtype=np.int64)
    for j in range(1, m + 1):
        if p[j] > 0:
            row_to_col[p[j] - 1] = j - 1
    return row_to_col


def _auction_phase(benefit: torch.Tensor, prices: torch.Tensor, eps: float,
                   max_iter: int):
    """One auction phase at a fixed epsilon. benefit: (n, n) square."""
    n = benefit.shape[0]
    dev = benefit.device
    ar = torch.arange(n, device=dev)
    neg_col = torch.full((n, 1), _NEG, dtype=benefit.dtype, device=dev)
    neg_mat = torch.full((n, n), _NEG, dtype=benefit.dtype, device=dev)
    person_to_obj = torch.full((n,), -1, dtype=torch.int64, device=dev)
    obj_to_person = torch.full((n,), -1, dtype=torch.int64, device=dev)
    it = torch.zeros((), dtype=torch.int64, device=dev)
    for rnd in range(max_iter):
        # The while-loop's condition, evaluated on the device.
        go = (person_to_obj < 0).any() & (it < max_iter)
        if rnd % CHECK_EVERY == 0 and not bool(go):
            break
        unassigned = person_to_obj < 0
        values = benefit - prices[None, :]                      # (n, n)
        # Pad a -inf column so top-2 also works for n == 1.
        top2 = torch.topk(torch.cat([values, neg_col], dim=1), 2,
                          dim=1).values                         # (n, 2)
        best_j = values.argmax(dim=1)                           # (n,)
        bid = prices[best_j] + top2[:, 0] - top2[:, 1] + eps    # (n,)
        # Bid matrix: unassigned persons bid on their best object.
        bid_mat = neg_mat.clone()
        bid_mat[ar, best_j] = torch.where(unassigned, bid, _NEG)
        best_bid = bid_mat.amax(dim=0)                          # (n,)
        winner = bid_mat.argmax(dim=0)
        has_bid = best_bid > _NEG / 2
        # Gather-based (collision-free) state update:
        # person i wins iff it was unassigned, bid on j=best_j[i], and is the
        # argmax bidder for j.
        won = unassigned & has_bid[best_j] & (winner[best_j] == ar)
        # person i is evicted iff its current object received a winning bid
        # from someone else.
        cur = person_to_obj.clamp(0, n - 1)
        evicted = (person_to_obj >= 0) & has_bid[cur] & (winner[cur] != ar)
        new_p2o = torch.where(won, best_j,
                              torch.where(evicted, -1, person_to_obj))
        has_bid = has_bid & go
        person_to_obj = torch.where(go, new_p2o, person_to_obj)
        obj_to_person = torch.where(has_bid, winner, obj_to_person)
        prices = torch.where(has_bid, best_bid, prices)
        it = it + go.long()
    return person_to_obj, obj_to_person, prices


def auction_assign(benefit: torch.Tensor, eps_final: float = 1e-4,
                   max_iter_per_phase: int = 4000) -> torch.Tensor:
    """Maximum-benefit perfect matching on a square benefit matrix.

    Returns person_to_obj (n,) int64. Epsilon scaling: eps 0.1 -> eps_final
    by factors of 10, reusing prices across phases.
    """
    n = benefit.shape[0]
    prices = torch.zeros((n,), dtype=benefit.dtype, device=benefit.device)
    eps = 0.1
    while True:
        person_to_obj, _, prices = _auction_phase(benefit, prices, eps,
                                                  max_iter_per_phase)
        if eps <= eps_final:
            break
        eps = max(eps / 10.0, eps_final)
    return person_to_obj


def associate(track_boxes: torch.Tensor, track_valid: torch.Tensor,
              det_boxes: torch.Tensor, det_valid: torch.Tensor,
              iou_thresh: float = 0.3):
    """Associate predicted track boxes with detections (both 2D aabb).

    Args:
      track_boxes: (T, 4) [x1,y1,x2,y2] Kalman-predicted boxes.
      track_valid: (T,) bool.
      det_boxes: (D, 4) current detections.
      det_valid: (D,) bool.
      iou_thresh: association criterion (paper: 0.3).

    Returns:
      track_to_det: (T,) int64, detection index or -1.
      det_to_track: (D,) int64, track index or -1.
      iou: (T, D) IoU matrix (for diagnostics).
    """
    t, d = track_boxes.shape[0], det_boxes.shape[0]
    n = max(t, d)
    dev = track_boxes.device
    iou = box_ops.aabb_iou_2d(track_boxes, det_boxes)
    pair_ok = track_valid[:, None] & det_valid[None, :]
    benefit = torch.where(pair_ok, iou, 0.0)
    # Quantize so the auction's eps-optimality implies exact optimality on
    # the quantized benefits (grid 1e-3 >> n * eps_final). The JAX package
    # divides by 1000 inside jit, where XLA multiplies by the float32
    # reciprocal instead; that rounding (one ulp off x / 1000 for some x)
    # decides between exactly tied assignments, so it is the one kept here.
    benefit = torch.round(benefit * 1000.0) * _INV_1000
    sq = benefit.new_zeros((n, n))
    sq[:t, :d] = benefit
    person_to_obj = auction_assign(sq)
    track_to_det = person_to_obj[:t]
    track_to_det = torch.where(track_to_det >= d, -1, track_to_det)
    matched_iou = iou[torch.arange(t, device=dev), track_to_det.clamp(0, d - 1)]
    good = (track_to_det >= 0) & (matched_iou >= iou_thresh) & track_valid
    track_to_det = torch.where(good, track_to_det, -1)
    # Invert the matching with a masked argmax per detection (collision-free).
    onehot = (track_to_det[:, None] == torch.arange(d, device=dev)[None, :]) \
        & good[:, None]
    det_to_track = torch.where(onehot.any(dim=0),
                               onehot.to(torch.int8).argmax(dim=0), -1)
    return track_to_det, det_to_track, iou
