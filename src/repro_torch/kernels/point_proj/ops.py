"""Wrapper of the fused point-projection kernel (``csrc/point_proj.cu``).

A CPU tensor goes to the plain version (``ref.py``); a CUDA tensor
launches the kernel, or the call raises. ``launches`` counts the kernel
launches made through this wrapper.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, _launch
from repro_torch.kernels.point_proj.ref import point_proj_ref

launches = 0


def point_proj(points: torch.Tensor, tr: torch.Tensor, p: torch.Tensor,
               height: int, width: int,
               label_img: Optional[torch.Tensor] = None):
    """(N,3) points -> (uv (N,2), depth (N,), visible (N,) bool,
    flat (N,) int32, labels (N,) int32 or None); see ``ref.point_proj_ref``.
    With ``label_img`` (H, W) int32 the instance-id gather is fused in."""
    global launches
    if _launch.dispatch_device("point_proj", points) == "cpu":
        return point_proj_ref(points, tr, p, height, width, label_img)
    dev = points.device
    n = points.shape[0]
    _launch.check_cuda("point_proj", "points", points, torch.float32,
                       (None, 3))
    _launch.check_cuda("point_proj", "tr", tr, torch.float32, (3, 4), dev)
    _launch.check_cuda("point_proj", "p", p, torch.float32, (3, 4), dev)
    if label_img is not None:
        _launch.check_cuda("point_proj", "label_img", label_img, torch.int32,
                           (height, width), dev)
    if height * width >= 2 ** 31:
        raise ValueError(f"point_proj: image {height}x{width} overflows the "
                         f"int32 flat index")
    uv = torch.empty((n, 2), dtype=torch.float32, device=dev)
    depth = torch.empty((n,), dtype=torch.float32, device=dev)
    vis = torch.empty((n,), dtype=torch.bool, device=dev)
    flat = torch.empty((n,), dtype=torch.int32, device=dev)
    labels = None if label_img is None else \
        torch.empty((n,), dtype=torch.int32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        code = lib.moby_point_proj(
            points.data_ptr(), n, tr.data_ptr(), p.data_ptr(), height, width,
            None if label_img is None else label_img.data_ptr(),
            uv.data_ptr(), depth.data_ptr(), vis.data_ptr(), flat.data_ptr(),
            None if labels is None else labels.data_ptr(),
            _launch.stream_handle(dev))
    _build.check(code, "point_proj")
    launches += 1
    return uv, depth, vis, flat, labels
