"""Plain PyTorch version of RANSAC plane-hypothesis inlier counting.

The distance is spelled out as ``((x*nx + y*ny) + z*nz) + d``, one rounded
operation at a time, so the CUDA kernel (``csrc/ransac_score.cu``), built
without FMA, compares the same floats and gives the same counts.
"""
from __future__ import annotations

import torch


def ransac_score_ref(points: torch.Tensor, valid: torch.Tensor,
                     normals: torch.Tensor, offsets: torch.Tensor,
                     thresh: float) -> torch.Tensor:
    """Count inliers per (object, hypothesis).

    Args:
      points:  (O, P, 3) cluster point buffers.
      valid:   (O, P) bool.
      normals: (O, K, 3) plane normals.
      offsets: (O, K) plane offsets d (plane: n.x + d = 0).
      thresh:  inlier distance threshold.

    Returns:
      (O, K) int32 inlier counts.
    """
    pts = points[:, None, :, :]          # (O, 1, P, 3)
    nrm = normals[:, :, None, :]         # (O, K, 1, 3)
    dist = ((pts[..., 0] * nrm[..., 0] + pts[..., 1] * nrm[..., 1])
            + pts[..., 2] * nrm[..., 2]) + offsets[:, :, None]
    inl = (dist.abs() < thresh) & valid[:, None, :]
    return inl.sum(dim=-1, dtype=torch.int32)
