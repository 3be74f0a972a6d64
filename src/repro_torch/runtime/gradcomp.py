"""Gradient compression: top-k with error feedback, int8
(``repro/runtime/gradcomp.py``).

* ``topk_compress`` keeps the largest-|g| fraction of each tensor and
  carries the dropped mass in a residual to the next step (error feedback).
  Among equal magnitudes at the k-th place the lower flat index is kept,
  as ``lax.top_k`` keeps it (a stable descending sort).
* ``int8_compress`` quantizes each tensor symmetrically to int8 with an f32
  scale; ``round`` is half to even, as ``jnp.round``.

Trees are the port's parameter trees (nested dicts of tensors; leaves in
sorted-key order). ``quantized_psum`` (an int8 all-reduce over a named
mesh axis) waits for the multi-device port (ROADMAP item 11).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.models.params import from_leaves, leaves, tree_map


class ErrorFeedbackState(NamedTuple):
    residual: Any


def init_error_feedback(params) -> ErrorFeedbackState:
    """Zero f32 residuals shaped like ``params``, on their devices."""
    return ErrorFeedbackState(residual=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def _top_k_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Flat indices of the k largest values of ``x``, ties to the lower
    index."""
    return torch.sort(x, descending=True, stable=True).indices[:k]


def topk_compress(grads, ef: ErrorFeedbackState, fraction: float = 0.05
                  ) -> Tuple[Any, ErrorFeedbackState]:
    """Sparsify each gradient tensor to its top-|fraction| entries; the
    dropped mass goes into the residual for the next step."""
    residual = dict(leaves(ef.residual))
    comp, res = [], []
    for path, g in leaves(grads):
        flat = (g.float() + residual[path]).reshape(-1)
        k = max(int(flat.shape[0] * fraction), 1)
        mask = torch.zeros_like(flat)
        mask[_top_k_indices(flat.abs(), k)] = 1.0
        kept = flat * mask
        comp.append((path, kept.reshape(g.shape)))
        res.append((path, (flat - kept).reshape(g.shape)))
    return from_leaves(comp), ErrorFeedbackState(residual=from_leaves(res))


def int8_compress(grads):
    """Quantize to int8 + scale. Returns (q_tree, scale_tree)."""
    qs, scales = [], []
    for path, g in leaves(grads):
        g = g.float()
        peak = g.abs().max() if g.numel() else g.new_zeros(())
        scale = torch.clamp_min(peak, 1e-12) / 127.0
        qs.append((path, torch.clamp(torch.round(g / scale), -127,
                                     127).to(torch.int8)))
        scales.append((path, scale))
    return from_leaves(qs), from_leaves(scales)


def int8_decompress(q_tree, scale_tree):
    scale = dict(leaves(scale_tree))
    return from_leaves((path, q.float() * scale[path])
                       for path, q in leaves(q_tree))
