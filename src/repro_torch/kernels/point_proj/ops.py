"""Wrappers of the point-projection kernel (``csrc/point_proj.cu``), one
per instance: :func:`point_proj` (uv, depth, visible, flat: the TPU
kernel's outputs) and :func:`project_and_label` (the labels alone, the
serving path's call).

A CPU tensor goes to the plain version (``ref.py``); a CUDA tensor
launches the kernel, or the call raises. ``launches`` counts the full
instance's launches made through this module, ``labels_launches`` the
labels instance's.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, _launch
from repro_torch.kernels.point_proj.ref import point_proj_ref

launches = 0
labels_launches = 0


def _check(kernel: str, points: torch.Tensor, tr: torch.Tensor,
           p: torch.Tensor, height: int, width: int,
           label_img: Optional[torch.Tensor]) -> None:
    """Raise unless the kernel takes these card tensors. ``points`` is
    (N, 3) and may start anywhere (a view offset by any number of rows);
    the labels instance also takes (S, N, 3) with label images (S, H, W)."""
    dev = points.device
    lead = (None,) * (points.dim() - 2) if label_img is not None else ()
    if len(lead) > 1:
        raise ValueError(f"{kernel}: points has shape {tuple(points.shape)}"
                         f", expected (N, 3) or (S, N, 3)")
    _launch.check_cuda(kernel, "points", points, torch.float32,
                       (*lead, None, 3))
    _launch.check_cuda(kernel, "tr", tr, torch.float32, (3, 4), dev)
    _launch.check_cuda(kernel, "p", p, torch.float32, (3, 4), dev)
    if label_img is not None:
        _launch.check_cuda(kernel, "label_img", label_img, torch.int32,
                           (*points.shape[:-2], height, width), dev)
    if height * width >= 2 ** 31:
        raise ValueError(f"{kernel}: image {height}x{width} overflows the "
                         f"int32 flat index")
    if points.dim() == 3 and points.shape[0] >= 2 ** 16:
        raise ValueError(f"{kernel}: {points.shape[0]} streams overflow "
                         f"the kernel's grid")


def point_proj(points: torch.Tensor, tr: torch.Tensor, p: torch.Tensor,
               height: int, width: int):
    """(N,3) points -> (uv (N,2), depth (N,), visible (N,) bool,
    flat (N,) int32); see ``ref.point_proj_ref``."""
    global launches
    if _launch.dispatch_device("point_proj", points) == "cpu":
        return point_proj_ref(points, tr, p, height, width)[:4]
    _check("point_proj", points, tr, p, height, width, None)
    dev = points.device
    n = points.shape[0]
    uv = torch.empty((n, 2), dtype=torch.float32, device=dev)
    depth = torch.empty((n,), dtype=torch.float32, device=dev)
    vis = torch.empty((n,), dtype=torch.bool, device=dev)
    flat = torch.empty((n,), dtype=torch.int32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        code = lib.moby_point_proj(
            points.data_ptr(), n, tr.data_ptr(), p.data_ptr(), height, width,
            uv.data_ptr(), depth.data_ptr(), vis.data_ptr(), flat.data_ptr(),
            _launch.stream_handle(dev))
    _build.check(code, "point_proj")
    launches += 1
    return uv, depth, vis, flat


def project_and_label(points: torch.Tensor, tr: torch.Tensor,
                      p: torch.Tensor, label_img: torch.Tensor
                      ) -> torch.Tensor:
    """(N,3) points, (H,W) int32 label image -> (N,) int32 instance ids
    at the projected pixels, 0 where a point is not visible: the pixels of
    :func:`point_proj`, from a launch that writes nothing else. With a
    stream axis, (S,N,3) points and (S,H,W) images -> (S,N), one launch
    for all S; point ``i`` of stream ``s`` reads ``label_img[s]``."""
    global labels_launches
    height, width = label_img.shape[-2:]
    if _launch.dispatch_device("point_proj_labels", points) == "cpu":
        return point_proj_ref(points, tr, p, height, width, label_img)[4]
    _check("point_proj_labels", points, tr, p, height, width, label_img)
    s = points.shape[0] if points.dim() == 3 else 1
    dev = points.device
    n = points.shape[-2]
    labels = torch.empty(points.shape[:-1], dtype=torch.int32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        code = lib.moby_point_proj_labels(
            points.data_ptr(), n, s, tr.data_ptr(), p.data_ptr(), height,
            width, label_img.data_ptr(), labels.data_ptr(),
            _launch.stream_handle(dev))
    _build.check(code, "point_proj_labels")
    labels_launches += 1
    return labels
