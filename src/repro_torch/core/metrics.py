"""Accuracy metrics (§5.1): F1 at a 3D-IoU threshold of 0.4.

An object is successfully detected when the 3D IoU between a detection and
a ground-truth box exceeds 40 %. Matching is greedy-by-IoU (standard for
detection F1); precision/recall/F1 follow.

Port of ``repro/core/metrics.py``; the greedy ``fori_loop`` becomes a
Python loop of ``min(D, G)`` masked steps that never leave the device.
"""
from __future__ import annotations

import torch

from repro_torch.core import boxes as box_ops


def match_greedy(iou: torch.Tensor, det_valid: torch.Tensor,
                 gt_valid: torch.Tensor, thresh: float):
    """Greedy one-to-one matching on an IoU matrix (D, G).

    Returns (tp mask over detections, matched mask over gts).
    """
    d, g = iou.shape
    dev = iou.device
    iou_cur = torch.where(det_valid[:, None] & gt_valid[None, :], iou, 0.0)
    det_used = torch.zeros((d,), dtype=torch.bool, device=dev)
    gt_used = torch.zeros((g,), dtype=torch.bool, device=dev)
    rows = torch.arange(d, device=dev)
    cols = torch.arange(g, device=dev)
    for _ in range(min(d, g)):
        flat = iou_cur.reshape(-1).argmax()
        di, gi = flat // g, flat % g
        take = iou_cur[di, gi] >= thresh
        row = (rows == di) & take
        col = (cols == gi) & take
        det_used = det_used | row
        gt_used = gt_used | col
        iou_cur = torch.where(row[:, None] | col[None, :], 0.0, iou_cur)
    return det_used, gt_used


def f1_score(det_boxes: torch.Tensor, det_valid: torch.Tensor,
             gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
             iou_thresh: float = 0.4):
    """Paper's accuracy metric. Returns (f1, precision, recall) as 0-dim
    float32 tensors."""
    iou = box_ops.pairwise_iou_3d(det_boxes, gt_boxes)
    tp_mask, _ = match_greedy(iou, det_valid, gt_valid, iou_thresh)
    tp = tp_mask.sum()
    n_det = det_valid.sum()
    n_gt = gt_valid.sum()
    zero = torch.zeros((), dtype=torch.float32, device=det_boxes.device)
    precision = torch.where(n_det > 0, tp / n_det.clamp_min(1), zero)
    recall = torch.where(n_gt > 0, tp / n_gt.clamp_min(1), zero)
    f1 = torch.where(precision + recall > 0,
                     2 * precision * recall
                     / (precision + recall).clamp_min(1e-9), zero)
    # Edge case: no GT and no detections = perfect frame.
    empty = (n_gt == 0) & (n_det == 0)
    return torch.where(empty, 1.0, f1), precision, recall
