"""Plain PyTorch version of the Bertsekas auction with epsilon scaling
(``repro/core/association.py``'s ``auction_assign``, whose phases are
``lax.while_loop``s of bidding rounds).

Each round is masked with the loop's own condition (``any unassigned & it
< max_iter``): once every person is assigned, a round changes nothing but
the counter, which the mask also holds. The host tests for the end only
every :data:`CHECK_EVERY` rounds, so the result is exactly the
while-loop's. Leading batch dims (a fleet's streams) run one auction each,
with its own condition and counter, as ``jax.vmap`` of the ``while_loop``
does: the rounds go on until no auction does, and a finished one is held
by its mask. The host check is a synchronisation, so this version is for
the CPU; on the card the auction is one kernel (``csrc/auction.cu``).
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.core.batching import take

_NEG = -1e9

# Bidding rounds between two host checks for the end of an auction phase.
CHECK_EVERY = 8


def phase_epsilons(eps_final: float = 1e-4) -> List[float]:
    """The epsilon of each phase, 0.1 -> ``eps_final`` by factors of 10,
    stepped in Python double as ``auction_assign`` steps it."""
    eps, out = 0.1, []
    while True:
        out.append(eps)
        if eps <= eps_final:
            return out
        eps = max(eps / 10.0, eps_final)


def _auction_phase(benefit: torch.Tensor, prices: torch.Tensor, eps: float,
                   max_iter: int):
    """One auction phase at a fixed epsilon. benefit: (..., n, n) square,
    one auction per leading index. Returns person_to_obj, obj_to_person,
    prices and each auction's rounds."""
    n = benefit.shape[-1]
    batch = benefit.shape[:-2]
    dev = benefit.device
    ar = torch.arange(n, device=dev)
    neg_col = torch.full((*batch, n, 1), _NEG, dtype=benefit.dtype,
                         device=dev)
    neg_mat = torch.full((*batch, n, n), _NEG, dtype=benefit.dtype,
                         device=dev)
    person_to_obj = torch.full((*batch, n), -1, dtype=torch.int64, device=dev)
    obj_to_person = torch.full((*batch, n), -1, dtype=torch.int64, device=dev)
    it = torch.zeros(batch, dtype=torch.int64, device=dev)
    for rnd in range(max_iter):
        # The while-loop's condition, evaluated per auction; the host ends
        # the loop once no auction goes on.
        go = (person_to_obj < 0).any(dim=-1) & (it < max_iter)
        if rnd % CHECK_EVERY == 0 and not bool(go.any()):
            break
        unassigned = person_to_obj < 0
        values = benefit - prices[..., None, :]                 # (.., n, n)
        # Pad a -inf column so top-2 also works for n == 1.
        top2 = torch.topk(torch.cat([values, neg_col], dim=-1), 2,
                          dim=-1).values                        # (.., n, 2)
        best_j = values.argmax(dim=-1)                          # (.., n)
        bid = take(prices, best_j) + top2[..., 0] - top2[..., 1] + eps
        # Bid matrix: unassigned persons bid on their best object.
        bid_mat = neg_mat.scatter(
            -1, best_j[..., None],
            torch.where(unassigned, bid, _NEG)[..., None])
        best_bid = bid_mat.amax(dim=-2)                         # (.., n)
        winner = bid_mat.argmax(dim=-2)
        has_bid = best_bid > _NEG / 2
        # Gather-based (collision-free) state update:
        # person i wins iff it was unassigned, bid on j=best_j[i], and is the
        # argmax bidder for j.
        won = unassigned & take(has_bid, best_j) & (take(winner, best_j) == ar)
        # person i is evicted iff its current object received a winning bid
        # from someone else.
        cur = person_to_obj.clamp(0, n - 1)
        evicted = (person_to_obj >= 0) & take(has_bid, cur) \
            & (take(winner, cur) != ar)
        new_p2o = torch.where(won, best_j,
                              torch.where(evicted, -1, person_to_obj))
        go_n = go[..., None]
        has_bid = has_bid & go_n
        person_to_obj = torch.where(go_n, new_p2o, person_to_obj)
        obj_to_person = torch.where(has_bid, winner, obj_to_person)
        prices = torch.where(has_bid, best_bid, prices)
        it = it + go.long()
    return person_to_obj, obj_to_person, prices, it


def auction_ref(benefit: torch.Tensor, eps_final: float = 1e-4,
                max_iter_per_phase: int = 4000):
    """Maximum-benefit perfect matching on square benefit matrices
    (..., n, n), one per leading index.

    Returns person_to_obj (..., n) int64, the final prices (..., n) (the
    benefit's dtype) and the bidding rounds each auction took, summed over
    the phases, (...,) int32. Epsilon scaling: eps 0.1 -> eps_final by
    factors of 10, reusing prices across phases.
    """
    prices = benefit.new_zeros(benefit.shape[:-1])
    rounds = torch.zeros(benefit.shape[:-2], dtype=torch.int64,
                         device=benefit.device)
    for eps in phase_epsilons(eps_final):
        person_to_obj, _, prices, it = _auction_phase(
            benefit, prices, eps, max_iter_per_phase)
        rounds = rounds + it
    return person_to_obj, prices, rounds.to(torch.int32)
