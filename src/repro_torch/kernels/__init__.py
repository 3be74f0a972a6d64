"""Hand-written CUDA kernels for Hopper (``sm_90a``), each beside its plain
PyTorch version.

====================  ============================  ==================================
kernel                source                        replaces (TPU, Pallas)
====================  ============================  ==================================
``point_proj``        ``csrc/point_proj.cu``        ``repro/kernels/point_proj``
``iou2d``             ``csrc/iou2d.cu``             ``repro/kernels/iou2d``
``ransac_score``      ``csrc/ransac_score.cu``      ``repro/kernels/ransac_score``
``flash_attention``   ``csrc/flash_attention.cu``   ``repro/kernels/flash_attention``
``decode_attention``  ``csrc/decode_attention.cu``  ``repro/kernels/decode_attention``
====================  ============================  ==================================

Each wrapper (``<kernel>/ops.py``) keeps a plain-integer ``launches``
count, raised by one per kernel launch and nowhere else, so a run can show
that its main path went through the kernels.
"""
from __future__ import annotations

from types import ModuleType
from typing import Dict

from repro_torch.kernels.decode_attention import ops as _decode_attention
from repro_torch.kernels.flash_attention import ops as _flash_attention
from repro_torch.kernels.iou2d import ops as _iou2d
from repro_torch.kernels.point_proj import ops as _point_proj
from repro_torch.kernels.ransac_score import ops as _ransac_score

_WRAPPERS: Dict[str, ModuleType] = {"point_proj": _point_proj,
                                    "iou2d": _iou2d,
                                    "ransac_score": _ransac_score,
                                    "flash_attention": _flash_attention,
                                    "decode_attention": _decode_attention}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: mod.launches for name, mod in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for mod in _WRAPPERS.values():
        mod.launches = 0
