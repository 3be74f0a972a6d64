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
                                                         (f32; bf16 at hd 16, 32)
``flash_attention_tc``  ``csrc/flash_attention_tc.cu``   ``repro/kernels/flash_attention``
                                                         (bf16 at hd 64 and 128, and MLA's
                                                         qk 192 / value 128; tensor cores)
``flash_attention_bwd`` ``csrc/flash_attention_bwd.cu``  its VJP, ``repro/ops/api.py``
                                                         (f32; bf16 at hd 16, 32 and
                                                         MLA SMOKE's 24 / 16)
``flash_attention_bwd_tc`` ``csrc/flash_attention_bwd_tc.cu`` its VJP, ``repro/ops/api.py``
                                                         (bf16 at hd 64 and 128, and
                                                         MLA's qk 192 / value 128;
                                                         tensor cores)
``decode_attention``    ``csrc/decode_attention.cu``     ``repro/kernels/decode_attention``
``decode_attention_bwd`` ``csrc/decode_attention_bwd.cu`` its VJP, ``repro/ops/api.py``
``mla_decode_attention`` ``csrc/mla_decode_attention.cu`` no Pallas kernel: the einsums
                                                         of ``repro/models/mla.py``
                                                         (``mla_decode_apply``)
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
counter each; ``flash_attention.ops.route`` picks one, for the forward
and for the gradient alike. So has the auction
(``auction.ops.plan`` picks by n). ``mla_decode_attention`` has three
instances, a bf16 tensor-core one, an f32 3xTF32 one and a SIMT one at
SMOKE's dims, under one counter (``mla_decode_attention.ops.route``
picks; ``ops.route_launches`` counts by instance). ``decode_attention``
has two layouts under one counter (``decode_attention.ops.layout`` picks:
bf16 at G = 1 takes its own; ``ops.layout_launches`` counts by layout).
"""
from __future__ import annotations

from types import ModuleType
from typing import Dict, Tuple

from repro_torch.kernels.auction import ops as _auction
from repro_torch.kernels.decode_attention import ops as _decode_attention
from repro_torch.kernels.flash_attention import ops as _flash_attention
from repro_torch.kernels.iou2d import ops as _iou2d
from repro_torch.kernels.mla_decode_attention import ops as \
    _mla_decode_attention
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
    "flash_attention_bwd": (_flash_attention, "bwd_launches"),
    "flash_attention_bwd_tc": (_flash_attention, "bwd_tc_launches"),
    "decode_attention": (_decode_attention, "launches"),
    "decode_attention_bwd": (_decode_attention, "bwd_launches"),
    "mla_decode_attention": (_mla_decode_attention, "launches"),
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
    for route in _mla_decode_attention.route_launches:
        _mla_decode_attention.route_launches[route] = 0
    for kind in _decode_attention.layout_launches:
        _decode_attention.layout_launches[kind] = 0
