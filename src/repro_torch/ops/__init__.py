"""repro_torch.ops — the hot ops, dispatched by tensor device.

    from repro_torch import ops
    iou = ops.iou2d(a, b)   # kernel for CUDA tensors, plain PyTorch on CPU
"""
from repro_torch.ops.api import (iou2d, label_points, point_proj,
                                 project_and_label, ransac_score)

__all__ = ["iou2d", "label_points", "point_proj", "project_and_label",
           "ransac_score"]
