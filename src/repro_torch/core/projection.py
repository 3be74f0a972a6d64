"""Point projection (§3.3): transfer 2D semantics onto the point cloud.

The LiDAR frame is projected into the camera image with the fixed extrinsic
``Tr`` (LiDAR -> camera) and projective ``P`` (camera -> pixel) calibration
matrices (time-invariant, provided by the sensor rig as in KITTI). Each
in-image point is labeled with the instance id of the segmentation mask it
lands in (the flattened instance-id image stands in for the stacked masks).
Labeled points are then compacted into fixed-size per-object cluster
buffers.

Port of ``repro/core/projection.py``. :func:`project_and_label` is one
launch of the fused ``point_proj`` kernel on the card (projection,
visibility, flat index and label gather).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import ops


class Calibration(NamedTuple):
    tr: torch.Tensor  # (3, 4) LiDAR -> camera rigid transform
    p: torch.Tensor   # (3, 4) camera projection matrix
    height: int       # label image height (a plain int)
    width: int        # label image width (a plain int)


def project_points(points: torch.Tensor, calib: Calibration):
    """Project LiDAR points to pixel coordinates.

    Args:
      points: (N, 3) LiDAR-frame points.
      calib: calibration.

    Returns:
      uv: (N, 2) float pixel coordinates.
      depth: (N,) camera-frame depth.
      visible: (N,) bool — in front of the camera and inside the image.
    """
    uv, depth, visible, _ = ops.point_proj(points, calib.tr, calib.p,
                                           calib.height, calib.width)
    return uv, depth, visible


def project_and_label(points: torch.Tensor, label_img: torch.Tensor,
                      calib: Calibration) -> torch.Tensor:
    """Fused projection + visibility + flat-index + label gather.

    Returns (N,) int32 instance labels (0 = background / invisible).
    """
    if tuple(label_img.shape) != (calib.height, calib.width):
        raise ValueError(f"label image {tuple(label_img.shape)} does not "
                         f"match the calibration's "
                         f"{(calib.height, calib.width)}")
    return ops.project_and_label(points, calib.tr, calib.p, label_img)


def label_points(uv: torch.Tensor, visible: torch.Tensor,
                 label_img: torch.Tensor) -> torch.Tensor:
    """Nearest-pixel instance lookup. label_img: (H, W) int32, 0=background.

    Returns (N,) int32 labels, 0 for background/invisible points.
    """
    h, w = label_img.shape
    ui = torch.round(uv[:, 0]).clamp(0, w - 1).long()
    vi = torch.round(uv[:, 1]).clamp(0, h - 1).long()
    lab = label_img[vi, ui]
    return torch.where(visible, lab, torch.zeros_like(lab))


def build_clusters(points: torch.Tensor, labels: torch.Tensor, max_obj: int,
                   pts_per_obj: int):
    """Compact labeled points into fixed per-object buffers.

    Args:
      points: (N, 3).
      labels: (N,) int32 instance ids (0 = background).
      max_obj: O, number of object slots.
      pts_per_obj: P, buffer size per object.

    Returns:
      clusters: (O, P, 3) point buffers (zeros beyond valid).
      valid: (O, P) bool masks.
      counts: (O,) number of points per object (possibly > P before capping).
    """
    obj_ids = torch.arange(1, max_obj + 1, dtype=labels.dtype,
                           device=labels.device)
    m = labels[None, :] == obj_ids[:, None]                    # (O, N)
    # Members first, in point order: a stable sort of the non-member flag
    # (sorted as an integer tensor, not a bool one).
    order = torch.argsort((~m).to(torch.int8), dim=1,
                          stable=True)[:, :pts_per_obj]        # (O, P)
    v = torch.gather(m, 1, order)
    pts = torch.where(v[..., None], points[order], 0.0)
    return pts, v, m.sum(dim=1)
