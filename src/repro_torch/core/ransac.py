"""RANSAC plane fitting for 3D bounding box estimation (§3.3).

Moby finds the dominant visible surface of each point cluster by sampling
three points, forming a plane, and keeping the plane with the most inliers.
The paper uses 30 iterations (Fig. 16a/b sensitivity).

Port of ``repro/core/ransac.py``, batched over objects. Inlier scoring
goes through ``repro_torch.ops.ransac_score`` (the CUDA kernel on the
card); the triplets come from the port's threefry generator
(``repro_torch.core.prng``), which draws the JAX package's bits exactly,
so both sides fit the same planes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import ops
from repro_torch.core import fp, prng


class RansacParams(NamedTuple):
    num_iters: int = 30          # paper default (Fig. 16)
    inlier_thresh: float = 0.10  # metres from plane
    # Reject near-horizontal planes (top/bottom surfaces). The paper notes
    # (§3.3 fn 2) top surfaces are rarely found and can be handled by
    # removing them and re-running; we instead fold that into scoring.
    max_abs_nz: float = 0.7


class PlaneFit(NamedTuple):
    normal: torch.Tensor     # (O, 3) unit normal
    offset: torch.Tensor     # (O,) d in n.x + d = 0
    inliers: torch.Tensor    # (O, P) bool
    num_inliers: torch.Tensor
    ok: torch.Tensor         # (O,) bool: a valid plane was found


def _sample_triplets(keys: torch.Tensor, valid: torch.Tensor,
                     k: int) -> torch.Tensor:
    """Sample (O, k, 3) indices of valid points (with replacement across
    triplets), one key (O, 2) per object.

    Valid points are compacted to the front by a stable sort so uniform
    integers over [0, n_valid) index real points. Degenerate clusters (<3
    points) produce index 0 triplets which later score 0.
    """
    o = valid.shape[0]
    order = torch.argsort((~valid).to(torch.int8), dim=1, stable=True)
    n_valid = valid.sum(dim=1).clamp_min(1)
    u = prng.randint(keys, (k, 3), 0, n_valid)                # (O, k, 3)
    return torch.gather(order, 1, u.reshape(o, -1)).reshape(o, k, 3)


def plane_from_triplets(points: torch.Tensor, tri: torch.Tensor):
    """Planes through point triplets. points (O,P,3), tri (O,K,3) ->
    normals (O,K,3), d (O,K), ok (O,K)."""
    rows = torch.arange(points.shape[0], device=points.device)[:, None]
    p0 = points[rows, tri[..., 0]]
    p1 = points[rows, tri[..., 1]]
    p2 = points[rows, tri[..., 2]]
    n = fp.cross(p1 - p0, p2 - p0)
    norm = fp.norm(n)[..., None]
    ok = norm[..., 0] > 1e-8
    n = n / torch.where(norm < 1e-8, 1.0, norm)
    d = -fp.dot(n, p0)
    return n, d, ok


def ransac_planes(key: torch.Tensor, points: torch.Tensor,
                  valid: torch.Tensor,
                  params: RansacParams = RansacParams()) -> PlaneFit:
    """Fit the dominant (near-vertical) plane of each cluster.

    Args:
      key: (2,) PRNG key, split into one key per object.
      points: (O, P, 3) buffers.
      valid: (O, P) masks.

    Returns: PlaneFit with the best plane per object and its inlier mask.
    """
    keys = prng.split(key, points.shape[0])                   # (O, 2)
    tri = _sample_triplets(keys, valid, params.num_iters)     # (O, K, 3)
    normals, offsets, tri_ok = plane_from_triplets(points, tri)
    counts = ops.ransac_score(points, valid, normals.contiguous(),
                              offsets.contiguous(), params.inlier_thresh)
    vertical = normals[..., 2].abs() <= params.max_abs_nz
    counts = torch.where(tri_ok & vertical, counts, 0)        # (O, K)
    best = counts.argmax(dim=1)
    rows = torch.arange(points.shape[0], device=points.device)
    n_best = normals[rows, best]
    d_best = offsets[rows, best]
    dist = (fp.dot(points, n_best[:, None, :]) + d_best[:, None]).abs()
    inliers = (dist < params.inlier_thresh) & valid
    num = counts[rows, best]
    ok = num >= 3
    return PlaneFit(normal=n_best, offset=d_best, inliers=inliers,
                    num_inliers=num, ok=ok)
