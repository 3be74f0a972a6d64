"""What every kernel wrapper checks before it hands pointers to CUDA."""
from __future__ import annotations

from typing import Optional, Sequence

import torch


def check_cuda(kernel: str, name: str, t: torch.Tensor, dtype: torch.dtype,
               shape: Optional[Sequence[Optional[int]]] = None,
               device: Optional[torch.device] = None,
               strided: bool = False) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (and of
    ``shape``, where None entries match any size, on ``device``). For a
    kernel that reads through element strides (``strided``), only the last
    dimension has to be contiguous."""
    if t.device.type != "cuda":
        raise ValueError(f"{kernel}: {name} is on {t.device}, the kernel "
                         f"needs a CUDA tensor")
    if device is not None and t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, expected "
                         f"{device}")
    if t.dtype != dtype:
        raise TypeError(f"{kernel}: {name} has dtype {t.dtype}, expected "
                        f"{dtype}")
    if shape is not None and (t.dim() != len(shape) or any(
            s is not None and s != n for s, n in zip(shape, t.shape))):
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if strided:
        if t.dim() and t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{kernel}: {name}'s last dimension has stride "
                             f"{t.stride(-1)}, the kernel needs 1")
    elif not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} is not contiguous")


def dispatch_device(kernel: str, t: torch.Tensor) -> str:
    """``"cpu"`` for the plain version, ``"cuda"`` for the kernel; any other
    device raises (there is no fallback from the card to the CPU)."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel}: no implementation for device "
                         f"{t.device}")
    return t.device.type


def stream_handle(device: torch.device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a raw handle."""
    return torch.cuda.current_stream(device).cuda_stream
