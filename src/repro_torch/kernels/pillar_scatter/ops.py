"""Wrapper of the pillar scatter-max kernels (``csrc/pillar_scatter.cu``)
and the autograd Function that trains through them.

A CPU tensor goes to the plain versions (``ref.py``); a CUDA tensor
launches the kernels, or the call raises. ``launches`` counts the
forward's launches and ``bwd_launches`` the backward's (one C entry point
each, whatever number of passes it runs).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, _launch
from repro_torch.kernels.pillar_scatter.ref import (pillar_scatter_bwd_ref,
                                                    pillar_scatter_ref)

launches = 0
bwd_launches = 0


def _check(kernel: str, feats, pillar_idx, valid, n_pillars: int) -> None:
    n, c = feats.shape
    dev = feats.device
    _launch.check_cuda(kernel, "feats", feats, torch.float32, (n, c))
    _launch.check_cuda(kernel, "pillar_idx", pillar_idx, torch.int32, (n,),
                       dev)
    _launch.check_cuda(kernel, "valid", valid, torch.bool, (n,), dev)
    if n_pillars < 0 or n_pillars * c >= 2 ** 31:
        raise ValueError(f"{kernel}: {n_pillars} pillars x {c} channels "
                         f"exceed the kernel's 32-bit grid index")
    if n >= 2 ** 30:
        raise ValueError(f"{kernel}: {n} points exceed the backward's "
                         f"30-bit tie counts")


def pillar_scatter(feats: torch.Tensor, pillar_idx: torch.Tensor,
                   valid: torch.Tensor, n_pillars: int) -> torch.Tensor:
    """(N, C) float32 features, (N,) int32 pillar ids, (N,) bool -> (G, C)
    max-pooled pillar grid; dropped points and empty pillars as in
    ``ref.py``."""
    global launches
    if _launch.dispatch_device("pillar_scatter", feats) == "cpu":
        return pillar_scatter_ref(feats, pillar_idx, valid, n_pillars)
    _check("pillar_scatter", feats, pillar_idx, valid, n_pillars)
    n, c = feats.shape
    dev = feats.device
    out = torch.empty((n_pillars, c), dtype=torch.float32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        code = lib.moby_pillar_scatter(
            feats.data_ptr(), pillar_idx.data_ptr(), valid.data_ptr(), n, c,
            n_pillars, out.data_ptr(), _launch.stream_handle(dev))
    _build.check(code, "pillar_scatter")
    launches += 1
    return out


def pillar_scatter_bwd(feats: torch.Tensor, pillar_idx: torch.Tensor,
                       valid: torch.Tensor, out: torch.Tensor,
                       ct: torch.Tensor) -> torch.Tensor:
    """Gradient for the features: (N, C), split among tied maxima as
    ``ref.pillar_scatter_bwd_ref`` splits it."""
    global bwd_launches
    if _launch.dispatch_device("pillar_scatter_bwd", feats) == "cpu":
        return pillar_scatter_bwd_ref(feats, pillar_idx, valid, out, ct)
    _check("pillar_scatter_bwd", feats, pillar_idx, valid, out.shape[0])
    n, c = feats.shape
    g = out.shape[0]
    dev = feats.device
    _launch.check_cuda("pillar_scatter_bwd", "out", out, torch.float32,
                       (g, c), dev)
    _launch.check_cuda("pillar_scatter_bwd", "ct", ct, torch.float32,
                       (g, c), dev)
    if n * c >= 2 ** 31:
        raise ValueError(f"pillar_scatter_bwd: {n} points x {c} channels "
                         f"exceed the kernel's 32-bit gradient index")
    grad = torch.empty((n, c), dtype=torch.float32, device=dev)
    # Scratch: the tie counts and a mask word a point and 32 channels.
    count = torch.empty((g, c), dtype=torch.int32, device=dev)
    masks = torch.empty((n, -(-c // 32)), dtype=torch.int32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        code = lib.moby_pillar_scatter_bwd(
            feats.data_ptr(), pillar_idx.data_ptr(), valid.data_ptr(),
            out.data_ptr(), ct.data_ptr(), n, c, g, count.data_ptr(),
            masks.data_ptr(), grad.data_ptr(), _launch.stream_handle(dev))
    _build.check(code, "pillar_scatter_bwd")
    bwd_launches += 1
    return grad


class PillarScatter(torch.autograd.Function):
    """Scatter-max with JAX's tie-splitting gradient; the ids and the mask
    take none."""

    @staticmethod
    def forward(ctx, feats, pillar_idx, valid, n_pillars):
        out = pillar_scatter(feats, pillar_idx, valid, n_pillars)
        ctx.save_for_backward(feats, pillar_idx, valid, out)
        return out

    @staticmethod
    def backward(ctx, ct):
        feats, pillar_idx, valid, out = ctx.saved_tensors
        grad = pillar_scatter_bwd(feats, pillar_idx, valid, out,
                                  ct.contiguous())
        return grad, None, None, None
