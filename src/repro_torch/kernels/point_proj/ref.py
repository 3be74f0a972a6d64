"""Plain PyTorch version of the fused point projection (+ label gather).

The arithmetic is spelled out element by element in the order XLA's CPU
dot takes for a 4-term contraction — ``(a*m0 + b*m1) + (c*m2 + 1*m3)`` —
first through ``Tr`` (LiDAR -> camera), then through ``P`` (camera ->
pixel), as ``repro/kernels/point_proj/ref.py`` does with two matmuls. The
CUDA kernel (``csrc/point_proj.cu``) repeats these steps, so ``visible``,
``flat`` and the labels agree bit for bit across the two. Leading batch
dims (a fleet's streams) stand in for ``vmap``: points ``(S, N, 3)`` with
label images ``(S, H, W)`` and one calibration.
"""
from __future__ import annotations

from typing import Optional

import torch


def _row4(m: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
          c: torch.Tensor) -> torch.Tensor:
    return (a * m[0] + b * m[1]) + (c * m[2] + m[3])


def point_proj_ref(points: torch.Tensor, tr: torch.Tensor, p: torch.Tensor,
                   height: int, width: int,
                   label_img: Optional[torch.Tensor] = None):
    """Project LiDAR points into pixel space.

    Args:
      points: (..., N, 3) float32.
      tr: (3, 4) LiDAR->camera; p: (3, 4) camera->pixel.
      label_img: optional (..., H, W) int32 instance-id image, one a
        leading index of ``points``.

    Returns:
      uv (..., N, 2) float32, depth (..., N) float32, visible (..., N)
      bool, flat (..., N) int32 clamped ``v*W+u`` index, and labels
      (..., N) int32 (0 where invisible) — or None when no label image is
      given.
    """
    x, y, z = points.unbind(-1)
    c0, c1, c2 = (_row4(tr[r], x, y, z) for r in range(3))
    q0, q1, depth = (_row4(p[r], c0, c1, c2) for r in range(3))
    w = torch.where(depth.abs() < 1e-6, torch.full_like(depth, 1e-6), depth)
    u = q0 / w
    v = q1 / w
    visible = (depth > 0.1) & (u >= 0) & (u < width) & (v >= 0) \
        & (v < height)
    # Clamp in float before the cast: a saturating round-then-clip.
    ui = torch.round(u).clamp(0, width - 1).to(torch.int32)
    vi = torch.round(v).clamp(0, height - 1).to(torch.int32)
    flat = vi * width + ui
    labels = None
    if label_img is not None:
        lab = torch.gather(label_img.flatten(-2), -1, flat.long())
        labels = torch.where(visible, lab, torch.zeros_like(lab))
    return torch.stack([u, v], dim=-1), depth, visible, flat, labels
