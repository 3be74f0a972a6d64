"""Wrapper of the auction kernel (``csrc/auction.cu``).

A CPU tensor goes to the plain version (``ref.py``); a CUDA tensor
launches the kernel, or the call raises. ``plan`` picks the instance:
1, 2 or 4 warps an auction with the rows in registers up to
:data:`ROW_MAX_N` persons (``launches`` counts these launches), the wide
instance above (rows in global memory, a warp a person; ``wide_launches``);
one launch a call either way, whatever the batch.
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
wide_launches = 0

MAX_PHASES = 8
# The row instances: warps an auction, a thread a person with its row in
# registers, so an instance takes n <= 32 x that; one warp (n <= 32)
# synchronises with no CTA barrier. The presets' largest auction is
# 2 * max_obj = 40.
WARPS = (1, 2, 4)
ROW_MAX_N = 32 * WARPS[-1]
# The wide instance (n > ROW_MAX_N): one CTA of 32 warps an auction, its
# prices, best keys and winners in shared memory (12 bytes a person, so n
# is bounded by the device's opt-in shared memory a block) and a (3, n)
# int32 workspace an auction in global memory.
WIDE_WARPS = 32
WIDE_SMEM_PER_PERSON = 12
# An H100's opt-in shared memory a block (227 KB): the bound ``plan``
# applies where no device is asked.
H100_SMEM_OPTIN = 232448


def plan(shape: Sequence[int], dtype: torch.dtype, eps_final: float,
         smem_optin: int = H100_SMEM_OPTIN
         ) -> Tuple[int, int, List[float], int]:
    """Check that the kernel takes (..., n, n) benefits of ``dtype`` at
    ``eps_final`` on a device with ``smem_optin`` bytes of opt-in shared
    memory a block; return the auctions, n, the phases' epsilons and the
    warps of the instance that takes n: the smallest row instance up to
    ``ROW_MAX_N``, the wide one (``WIDE_WARPS``) above."""
    if len(shape) < 2 or shape[-1] != shape[-2]:
        raise ValueError(f"auction: benefit has shape {tuple(shape)}, "
                         f"expected (..., n, n)")
    if dtype != torch.float32:
        raise TypeError(f"auction: benefit has dtype {dtype}, expected "
                        f"torch.float32")
    n = shape[-1]
    if n < 1:
        raise ValueError(f"auction: n = {n} persons, the kernel takes at "
                         f"least 1")
    if n * WIDE_SMEM_PER_PERSON > smem_optin:
        raise ValueError(
            f"auction: n = {n} persons need {n * WIDE_SMEM_PER_PERSON} bytes "
            f"of shared memory ({WIDE_SMEM_PER_PERSON} a person), over the "
            f"device's opt-in limit of {smem_optin} bytes a block (n <= "
            f"{smem_optin // WIDE_SMEM_PER_PERSON})")
    eps = phase_epsilons(eps_final)
    if len(eps) > MAX_PHASES:
        raise ValueError(f"auction: eps_final {eps_final} takes {len(eps)} "
                         f"phases, the kernel takes at most {MAX_PHASES}")
    batch = math.prod(shape[:-2])
    if batch >= 2 ** 31:
        raise ValueError(f"auction: {batch} auctions overflow the grid")
    if n > ROW_MAX_N:
        return batch, n, eps, WIDE_WARPS
    return batch, n, eps, next(w for w in WARPS if n <= 32 * w)


def smem_optin(device: torch.device) -> int:
    """The card's opt-in shared memory a block, in bytes."""
    got = _build.load().moby_smem_optin(device.index if device.index
                                        is not None else
                                        torch.cuda.current_device())
    if got < 0:
        _build.check(-got, "auction (shared-memory query)")
    return got


def auction(benefit: torch.Tensor, eps_final: float = 1e-4,
            max_iter_per_phase: int = 4000):
    """(..., n, n) float32 benefits -> person_to_obj (..., n) int64, final
    prices (..., n) float32 and rounds (...,) int32 summed over the
    epsilon phases; one auction per leading index (see ``ref.py``)."""
    global launches, wide_launches
    if _launch.dispatch_device("auction", benefit) == "cpu":
        return auction_ref(benefit, eps_final, max_iter_per_phase)
    dev = benefit.device
    batch, n, eps, warps = plan(
        benefit.shape, benefit.dtype, eps_final,
        smem_optin(dev) if benefit.shape[-1] > ROW_MAX_N
        else H100_SMEM_OPTIN)
    _launch.check_cuda("auction", "benefit", benefit, torch.float32)
    lead = tuple(benefit.shape[:-2])
    p2o = torch.empty((*lead, n), dtype=torch.int64, device=dev)
    prices = torch.empty((*lead, n), dtype=torch.float32, device=dev)
    rounds = torch.empty(lead, dtype=torch.int32, device=dev)
    # The f32 values that ``tensor + eps`` adds in the plain version.
    eps32 = (ctypes.c_float * len(eps))(
        *(float(np.float32(e)) for e in eps))
    lib = _build.load()
    if warps == WIDE_WARPS:
        work = torch.empty((batch, 3, n), dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            code = lib.moby_auction_wide(
                benefit.data_ptr(), batch, n, eps32, len(eps),
                max_iter_per_phase, work.data_ptr(), p2o.data_ptr(),
                prices.data_ptr(), rounds.data_ptr(),
                _launch.stream_handle(dev))
        _build.check(code, "auction")
        wide_launches += 1
        return p2o, prices, rounds
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
