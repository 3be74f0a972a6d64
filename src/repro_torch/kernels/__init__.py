"""Hand-written CUDA kernels for Hopper (``sm_90a``), each beside its plain
PyTorch version.

======================  ===============================  ==================================
kernel                  source                           replaces (TPU, Pallas)
======================  ===============================  ==================================
``point_proj``          ``csrc/point_proj.cu``           ``repro/kernels/point_proj``
``point_proj_labels``   ``csrc/point_proj.cu``           ``repro/kernels/point_proj``
                                                         (labels only: the serving path)
``iou2d``               ``csrc/iou2d.cu``                ``repro/kernels/iou2d``
``ransac_score``        ``csrc/ransac_score.cu``         ``repro/kernels/ransac_score``
``flash_attention``     ``csrc/flash_attention.cu``      ``repro/kernels/flash_attention``
                                                         (f32; bf16 at hd 16, 32, 64)
``flash_attention_tc``  ``csrc/flash_attention_tc.cu``   ``repro/kernels/flash_attention``
                                                         (bf16 at hd 128, tensor cores)
``decode_attention``    ``csrc/decode_attention.cu``     ``repro/kernels/decode_attention``
``pillar_scatter``      ``csrc/pillar_scatter.cu``       ``repro/kernels/pillar_scatter``
``pillar_scatter_bwd``  ``csrc/pillar_scatter.cu``       its VJP, ``repro/ops/api.py``
``auction``             ``csrc/auction.cu``              no Pallas kernel: the
                                                         ``lax.while_loop`` auction of
                                                         ``repro/core/association.py``
``auction_wide``        ``csrc/auction.cu``              the same, above 128 persons
======================  ===============================  ==================================

Each wrapper (``<kernel>/ops.py``) keeps a plain-integer launch count,
raised by one per kernel launch and nowhere else, so a run can show that
its main path went through the kernels. ``point_proj`` has two
instances of one kernel, one counter each (``point_proj.ops.point_proj``
and ``project_and_label``). ``flash_attention`` has two kernels, one
counter each; ``flash_attention.ops.route`` picks one. So has the auction
(``auction.ops.plan`` picks by n).
"""
from __future__ import annotations

from types import ModuleType
from typing import Dict, Tuple

from repro_torch.kernels.auction import ops as _auction
from repro_torch.kernels.decode_attention import ops as _decode_attention
from repro_torch.kernels.flash_attention import ops as _flash_attention
from repro_torch.kernels.iou2d import ops as _iou2d
from repro_torch.kernels.pillar_scatter import ops as _pillar_scatter
from repro_torch.kernels.point_proj import ops as _point_proj
from repro_torch.kernels.ransac_score import ops as _ransac_score

# kernel -> (wrapper module, name of its launch count)
_COUNTERS: Dict[str, Tuple[ModuleType, str]] = {
    "point_proj": (_point_proj, "launches"),
    "point_proj_labels": (_point_proj, "labels_launches"),
    "iou2d": (_iou2d, "launches"),
    "ransac_score": (_ransac_score, "launches"),
    "flash_attention": (_flash_attention, "launches"),
    "flash_attention_tc": (_flash_attention, "tc_launches"),
    "decode_attention": (_decode_attention, "launches"),
    "pillar_scatter": (_pillar_scatter, "launches"),
    "pillar_scatter_bwd": (_pillar_scatter, "bwd_launches"),
    "auction": (_auction, "launches"),
    "auction_wide": (_auction, "wide_launches")}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: getattr(mod, attr)
            for name, (mod, attr) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for mod, attr in _COUNTERS.values():
        setattr(mod, attr, 0)
