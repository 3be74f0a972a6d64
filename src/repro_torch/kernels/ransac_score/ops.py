"""Wrapper of the RANSAC inlier-count kernel (``csrc/ransac_score.cu``).

A CPU tensor goes to the plain version (``ref.py``); a CUDA tensor
launches the kernel, or the call raises. ``launches`` counts the kernel
launches made through this wrapper.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, _launch
from repro_torch.kernels.ransac_score.ref import ransac_score_ref

launches = 0

# The kernel stages one object's points in the default 48 KB of dynamic
# shared memory (13 bytes a point).
MAX_POINTS = (48 * 1024) // 13


def ransac_score(points: torch.Tensor, valid: torch.Tensor,
                 normals: torch.Tensor, offsets: torch.Tensor,
                 thresh: float) -> torch.Tensor:
    """(O,P,3),(O,P),(O,K,3),(O,K) -> (O,K) int32 inlier counts."""
    global launches
    if _launch.dispatch_device("ransac_score", points) == "cpu":
        return ransac_score_ref(points, valid, normals, offsets, thresh)
    dev = points.device
    o, p = points.shape[0], points.shape[1]
    k = normals.shape[1]
    _launch.check_cuda("ransac_score", "points", points, torch.float32,
                       (None, None, 3))
    _launch.check_cuda("ransac_score", "valid", valid, torch.bool, (o, p), dev)
    _launch.check_cuda("ransac_score", "normals", normals, torch.float32,
                       (o, None, 3), dev)
    _launch.check_cuda("ransac_score", "offsets", offsets, torch.float32,
                       (o, k), dev)
    if p > MAX_POINTS:
        raise ValueError(f"ransac_score: {p} points per object exceed the "
                         f"kernel's shared-memory stage ({MAX_POINTS})")
    counts = torch.empty((o, k), dtype=torch.int32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        code = lib.moby_ransac_score(
            points.data_ptr(), valid.data_ptr(), normals.data_ptr(),
            offsets.data_ptr(), o, p, k, float(thresh), counts.data_ptr(),
            _launch.stream_handle(dev))
    _build.check(code, "ransac_score")
    launches += 1
    return counts
