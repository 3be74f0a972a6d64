"""Plain PyTorch version of the pairwise axis-aligned IoU matrix
(``repro/kernels/iou2d/ref.py``, the same formula in the same order), with
leading batch dims (a fleet's streams) in place of ``vmap``."""
from __future__ import annotations

import torch


def iou2d_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a: (..., N, 4), b: (..., M, 4) [x1,y1,x2,y2] -> (..., N, M) IoU."""
    ax1, ay1, ax2, ay2 = (a[..., :, k, None] for k in range(4))
    bx1, by1, bx2, by2 = (b[..., None, :, k] for k in range(4))
    ix = (torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1)).clamp_min(0.0)
    iy = (torch.minimum(ay2, by2) - torch.maximum(ay1, by1)).clamp_min(0.0)
    inter = ix * iy
    aa = ((ax2 - ax1) * (ay2 - ay1)).clamp_min(0.0)
    ab = ((bx2 - bx1) * (by2 - by1)).clamp_min(0.0)
    union = aa + ab - inter
    return torch.where(union > 1e-9, inter / union, torch.zeros_like(inter))
