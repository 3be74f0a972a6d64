"""Typed entry points for the hot ops, under ``repro/ops/api.py``'s names.

Dispatch is by the device of the tensors and nothing else: a CPU tensor
goes to the op's plain PyTorch version, a CUDA tensor to its hand-written
kernel (``repro_torch/kernels``), and any failure to build or launch that
kernel raises. There is no backend string, no environment switch and no
capability test — the JAX package's ``ref`` / ``pallas`` / ``auto``
registry has no counterpart here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.iou2d import ops as _iou_ops
from repro_torch.kernels.point_proj import ops as _pp_ops
from repro_torch.kernels.ransac_score import ops as _rs_ops


def point_proj(points: torch.Tensor, tr: torch.Tensor, p: torch.Tensor,
               height: int, width: int):
    """Fused LiDAR->pixel projection.

    (N,3) points + (3,4) Tr/P calibration -> (uv (N,2), depth (N,),
    visible (N,) bool, flat (N,) int32 gather index).
    """
    uv, depth, visible, flat, _ = _pp_ops.point_proj(points, tr, p, height,
                                                     width)
    return uv, depth, visible, flat


def project_and_label(points: torch.Tensor, tr: torch.Tensor,
                      p: torch.Tensor, label_img: torch.Tensor
                      ) -> torch.Tensor:
    """:func:`point_proj` with the instance-id gather fused in (one kernel
    launch on the card): (N,3) points, (H,W) int32 label image -> (N,)
    int32 labels, 0 for background or invisible points."""
    h, w = label_img.shape
    return _pp_ops.point_proj(points, tr, p, h, w, label_img)[4]


def label_points(flat: torch.Tensor, visible: torch.Tensor,
                 label_img: torch.Tensor) -> torch.Tensor:
    """Instance-id gather at the projected pixels (the unfused form; the
    serving path uses :func:`project_and_label`)."""
    lab = label_img.reshape(-1)[flat.long()]
    return torch.where(visible, lab, torch.zeros_like(lab))


def iou2d(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise axis-aligned IoU: (N,4) x (M,4) -> (N,M)."""
    return _iou_ops.iou2d(a, b)


def ransac_score(points: torch.Tensor, valid: torch.Tensor,
                 normals: torch.Tensor, offsets: torch.Tensor,
                 thresh: float) -> torch.Tensor:
    """Plane-hypothesis inlier counts: (O,P,3),(O,P),(O,K,3),(O,K) ->
    (O,K) int32."""
    return _rs_ops.ransac_score(points, valid, normals, offsets, thresh)
