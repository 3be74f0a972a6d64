"""Wrapper of the auction kernel (``csrc/auction.cu``).

A CPU tensor goes to the plain version (``ref.py``); a CUDA tensor
launches the kernel, or the call raises. ``launches`` counts the kernel
launches made through this wrapper: one a call, whatever the batch.
"""
from __future__ import annotations

import ctypes
import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build, _launch
from repro_torch.kernels.auction.ref import auction_ref, phase_epsilons

launches = 0

# A thread a person. The presets' largest auction is 2 * max_obj = 40.
MAX_N = 128
MAX_PHASES = 8
# The kernel's instances: warps an auction, so an instance takes n <= 32 x
# that; one warp (n <= 32) synchronises with no CTA barrier.
WARPS = (1, 2, 4)


def plan(shape: Sequence[int], dtype: torch.dtype,
         eps_final: float) -> Tuple[int, int, List[float], int]:
    """Check that the kernel takes (..., n, n) benefits of ``dtype`` at
    ``eps_final``; return the auctions, n, the phases' epsilons and the
    warps of the smallest instance that takes n."""
    if len(shape) < 2 or shape[-1] != shape[-2]:
        raise ValueError(f"auction: benefit has shape {tuple(shape)}, "
                         f"expected (..., n, n)")
    if dtype != torch.float32:
        raise TypeError(f"auction: benefit has dtype {dtype}, expected "
                        f"torch.float32")
    n = shape[-1]
    if not 1 <= n <= MAX_N:
        raise ValueError(f"auction: n = {n} persons, the kernel takes 1 to "
                         f"{MAX_N}")
    eps = phase_epsilons(eps_final)
    if len(eps) > MAX_PHASES:
        raise ValueError(f"auction: eps_final {eps_final} takes {len(eps)} "
                         f"phases, the kernel takes at most {MAX_PHASES}")
    batch = math.prod(shape[:-2])
    if batch >= 2 ** 31:
        raise ValueError(f"auction: {batch} auctions overflow the grid")
    return batch, n, eps, next(w for w in WARPS if n <= 32 * w)


def auction(benefit: torch.Tensor, eps_final: float = 1e-4,
            max_iter_per_phase: int = 4000):
    """(..., n, n) float32 benefits -> person_to_obj (..., n) int64, final
    prices (..., n) float32 and rounds (...,) int32 summed over the
    epsilon phases; one auction per leading index (see ``ref.py``)."""
    global launches
    if _launch.dispatch_device("auction", benefit) == "cpu":
        return auction_ref(benefit, eps_final, max_iter_per_phase)
    dev = benefit.device
    batch, n, eps, warps = plan(benefit.shape, benefit.dtype, eps_final)
    _launch.check_cuda("auction", "benefit", benefit, torch.float32)
    lead = tuple(benefit.shape[:-2])
    p2o = torch.empty((*lead, n), dtype=torch.int64, device=dev)
    prices = torch.empty((*lead, n), dtype=torch.float32, device=dev)
    rounds = torch.empty(lead, dtype=torch.int32, device=dev)
    # The f32 values that ``tensor + eps`` adds in the plain version.
    eps32 = (ctypes.c_float * len(eps))(
        *(float(np.float32(e)) for e in eps))
    lib = _build.load()
    with torch.cuda.device(dev):
        code = lib.moby_auction(benefit.data_ptr(), batch, n, warps, eps32,
                                len(eps), max_iter_per_phase, p2o.data_ptr(),
                                prices.data_ptr(), rounds.data_ptr(),
                                _launch.stream_handle(dev))
    _build.check(code, "auction")
    launches += 1
    return p2o, prices, rounds


def auction_skeleton(rounds: torch.Tensor) -> torch.Tensor:
    """A probe, not counted in ``launches``: one warp an auction running
    ``rounds`` (the kernel's own counts, an int32 CUDA tensor) rounds of
    the one-warp instance's synchronisation and end test with no work in
    them. Returns the rounds run."""
    _launch.check_cuda("auction_skeleton", "rounds", rounds, torch.int32)
    out = torch.empty_like(rounds)
    with torch.cuda.device(rounds.device):
        code = _build.load().moby_auction_skeleton(
            rounds.data_ptr(), rounds.numel(), out.data_ptr(),
            _launch.stream_handle(rounds.device))
    _build.check(code, "auction_skeleton")
    return out
