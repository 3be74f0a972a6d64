"""Wrapper of the pairwise 2D IoU kernel (``csrc/iou2d.cu``).

A CPU tensor goes to the plain version (``ref.py``); a CUDA tensor
launches the kernel, or the call raises. ``launches`` counts the kernel
launches made through this wrapper.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, _launch
from repro_torch.kernels.iou2d.ref import iou2d_ref

launches = 0


def iou2d(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N,4) x (M,4) -> (N,M) float32 IoU; with a stream axis, (S,N,4) x
    (S,M,4) -> (S,N,M), one launch for all S."""
    global launches
    if _launch.dispatch_device("iou2d", a) == "cpu":
        return iou2d_ref(a, b)
    dev = a.device
    if a.dim() not in (2, 3):
        raise ValueError(f"iou2d: a has shape {tuple(a.shape)}, expected "
                         f"(N, 4) or (S, N, 4)")
    lead = (None,) * (a.dim() - 2)
    _launch.check_cuda("iou2d", "a", a, torch.float32, (*lead, None, 4))
    _launch.check_cuda("iou2d", "b", b, torch.float32,
                       (*a.shape[:-2], None, 4), dev)
    for name, t in (("a", a), ("b", b)):
        if t.data_ptr() % 16:
            raise ValueError(f"iou2d: {name} is not 16-byte aligned")
    s = a.shape[0] if a.dim() == 3 else 1
    n, m = a.shape[-2], b.shape[-2]
    if n * m >= 2 ** 31 or s >= 2 ** 16:
        raise ValueError(f"iou2d: {s} streams of {n}x{m} outputs overflow "
                         f"the kernel's grid")
    out = torch.empty((*a.shape[:-2], n, m), dtype=torch.float32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        code = lib.moby_iou2d(a.data_ptr(), n, b.data_ptr(), m, s,
                              out.data_ptr(), _launch.stream_handle(dev))
    _build.check(code, "iou2d")
    launches += 1
    return out
