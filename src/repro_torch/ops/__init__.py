"""repro_torch.ops — the hot ops, dispatched by tensor device.

    from repro_torch import ops
    iou = ops.iou2d(a, b)   # kernel for CUDA tensors, plain PyTorch on CPU
"""
from repro_torch.ops.api import (decode_attention, flash_attention, iou2d,
                                 label_points, mla_decode_attention,
                                 pillar_scatter, point_proj,
                                 project_and_label, ransac_score)

__all__ = ["decode_attention", "flash_attention", "iou2d", "label_points",
           "mla_decode_attention", "pillar_scatter", "point_proj",
           "project_and_label", "ransac_score"]
