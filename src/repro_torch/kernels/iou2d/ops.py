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
    """(N,4) x (M,4) -> (N,M) float32 IoU."""
    global launches
    if _launch.dispatch_device("iou2d", a) == "cpu":
        return iou2d_ref(a, b)
    dev = a.device
    _launch.check_cuda("iou2d", "a", a, torch.float32, (None, 4))
    _launch.check_cuda("iou2d", "b", b, torch.float32, (None, 4), dev)
    for name, t in (("a", a), ("b", b)):
        if t.data_ptr() % 16:
            raise ValueError(f"iou2d: {name} is not 16-byte aligned")
    n, m = a.shape[0], b.shape[0]
    if (n + 7) // 8 > 65535:
        raise ValueError(f"iou2d: {n} rows exceed the kernel's grid")
    out = torch.empty((n, m), dtype=torch.float32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        code = lib.moby_iou2d(a.data_ptr(), n, b.data_ptr(), m,
                              out.data_ptr(), _launch.stream_handle(dev))
    _build.check(code, "iou2d")
    launches += 1
    return out
