"""PointPillars-style 3D detector (the "cloud" model, trainable)
(``repro/models/detector3d.py``).

Pipeline (Lang et al., CVPR'19):
  1. pillarize: per-point features (x, y, z, i, offsets to the pillar
     centre, range, 1) and flat pillar ids;
  2. PointNet: linear + relu, then the max-pool per pillar through
     ``ops.pillar_scatter`` (the hand-written scatter-max kernel on the
     card, ``csrc/pillar_scatter.cu``, whose backward is a kernel too);
  3. a 2D CNN backbone over the BEV grid (3 stride-2 blocks, the stride-8
     map resized and fused at stride 2);
  4. an SSD head: per-cell anchors (0 and 90 degrees) -> a class logit and
     7 box deltas.

``PillarConfig`` has the JAX config's fields but ``backend``: the port
dispatches the scatter by tensor device. Parameters keep JAX's paths and
HWIO convolution shapes, so trees and gradients compare leaf for leaf.
The convolutions and 1x1 heads run through cuDNN in full float32
(``models/cnn.py``); they are outside any Pallas kernel in JAX too.

Where XLA's compiled arithmetic decides a cell, the port reproduces it:
a division by a constant is a multiply by its float32 reciprocal
(``_times_inverse``), and ``jnp.hypot`` is ``a * sqrt(fma(q, q, 1))``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch import ops
from repro_torch.core import boxes as box_ops
from repro_torch.core import fp
from repro_torch.models import cnn
from repro_torch.models.params import (ParamDef, fanin_init, ones_init,
                                       zeros_init)


@dataclasses.dataclass(frozen=True)
class PillarConfig:
    x_range: tuple = (0.0, 64.0)
    y_range: tuple = (-32.0, 32.0)
    z_range: tuple = (-3.0, 1.0)
    pillar: float = 0.5           # metres
    grid_h: int = 128             # y cells
    grid_w: int = 128             # x cells
    feat_dim: int = 32
    backbone_dims: tuple = (32, 64, 128)
    n_anchors: int = 2
    second_style: bool = False    # z-binned dense-voxel entry (SECOND)
    z_bins: int = 8


def _conv(cin, cout):
    return ParamDef((3, 3, cin, cout), (None, None, None, "mlp"),
                    init=fanin_init())


def detector_defs(cfg: PillarConfig):
    in_feat = 9 if not cfg.second_style else 9 + cfg.z_bins
    blocks = {}
    cin = cfg.feat_dim
    for i, cout in enumerate(cfg.backbone_dims):
        blocks[f"conv{i}"] = _conv(cin, cout)
        blocks[f"scale{i}"] = ParamDef((cout,), (None,), init=ones_init())
        cin = cout
    # Upsample lateral conv back to stride 2.
    blocks["lat1"] = _conv(cfg.backbone_dims[2], cfg.backbone_dims[0])
    return {
        "pnet_w": ParamDef((in_feat, cfg.feat_dim), (None, "mlp"),
                           init=fanin_init()),
        "pnet_b": ParamDef((cfg.feat_dim,), (None,), init=zeros_init()),
        "blocks": blocks,
        "head_cls": ParamDef((1, 1, cfg.backbone_dims[0] * 2, cfg.n_anchors),
                             (None, None, None, None), init=fanin_init()),
        "head_box": ParamDef((1, 1, cfg.backbone_dims[0] * 2,
                              cfg.n_anchors * 7),
                             (None, None, None, None), init=fanin_init()),
    }


def _times_inverse(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` for a constant ``c`` as XLA compiles it: ``x`` times the
    float32 reciprocal of ``c``."""
    return x * float(np.float32(1.0) / np.float32(c))


def _hypot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``jnp.hypot``: ``a * sqrt(1 + (b / a)^2)`` with a = max(|x|, |y|),
    b = min, the square and the 1 fused into one rounding."""
    x, y = x.abs(), y.abs()
    a, b = torch.maximum(x, y), torch.minimum(x, y)
    q = b / torch.where(a == 0, 1.0, a)
    h = torch.where(a == 0, a,
                    a * torch.sqrt(fp.fma(q, q, torch.ones_like(q))))
    return torch.where((x == torch.inf) | (y == torch.inf), torch.inf, h)


def pillarize(cfg: PillarConfig, points: torch.Tensor, valid: torch.Tensor):
    """points: (N, 4) -> per-point features (N, F), flat pillar ids (N,)
    int32 (-1 where dropped) and the kept mask (N,)."""
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    ix = torch.floor(_times_inverse(x - cfg.x_range[0], cfg.pillar)
                     ).to(torch.int32)
    iy = torch.floor(_times_inverse(y - cfg.y_range[0], cfg.pillar)
                     ).to(torch.int32)
    inb = (ix >= 0) & (ix < cfg.grid_w) & (iy >= 0) & (iy < cfg.grid_h) & \
        (z >= cfg.z_range[0]) & (z <= cfg.z_range[1])
    ok = valid & inb
    pid = torch.where(ok, iy * cfg.grid_w + ix, -1).to(torch.int32)

    def centre(i, lo):
        return fp.fma(i.float() + 0.5, torch.full_like(x, cfg.pillar),
                      torch.full_like(x, lo))
    feats = [x, y, z, points[:, 3], x - centre(ix, cfg.x_range[0]),
             y - centre(iy, cfg.y_range[0]),
             z - 0.5 * (cfg.z_range[0] + cfg.z_range[1]), _hypot(x, y),
             torch.ones_like(x)]
    f = torch.stack(feats, dim=1)
    if cfg.second_style:
        zb = (_times_inverse(z - cfg.z_range[0],
                             cfg.z_range[1] - cfg.z_range[0]) * cfg.z_bins
              ).to(torch.int32).clamp(0, cfg.z_bins - 1)
        onehot = torch.nn.functional.one_hot(zb.long(), cfg.z_bins)
        f = torch.cat([f, onehot.to(f.dtype)], dim=1)
    return f, pid, ok


def _resize_nearest(x: torch.Tensor, size) -> torch.Tensor:
    """``jax.image.resize(..., "nearest")`` over the spatial dims of an
    NCHW map: output i reads input floor((i + 0.5) * m / n), in float32."""
    for dim, n in zip((2, 3), size):
        m = x.shape[dim]
        pos = (np.arange(n, dtype=np.float32) + np.float32(0.5)) \
            * np.float32(m) / np.float32(n)
        idx = torch.from_numpy(np.floor(pos).astype(np.int64)).to(x.device)
        x = x.index_select(dim, idx)
    return x


def forward(params, cfg: PillarConfig, points: torch.Tensor,
            valid: torch.Tensor):
    """points: (N, 4) one frame -> (cls (H,W,A), boxes (H,W,A,7))."""
    f, pid, ok = pillarize(cfg, points, valid)
    h = torch.relu(f @ params["pnet_w"] + params["pnet_b"])      # (N, F)
    g = cfg.grid_h * cfg.grid_w
    grid = ops.pillar_scatter(h, pid, ok, g)
    bev = grid.reshape(1, cfg.grid_h, cfg.grid_w, cfg.feat_dim
                       ).permute(0, 3, 1, 2)

    b = params["blocks"]
    with cnn.f32_convolutions():
        feats = []
        x = bev
        for i in range(len(cfg.backbone_dims)):
            x = cnn.conv2d_same(x, b[f"conv{i}"], 2)
            # Over batch and H, per (W, C): JAX's axes (0, 1) of NHWC.
            x = cnn.norm_relu(x, b[f"scale{i}"], (0, 2))
            feats.append(x)
        # Fuse strides 2 and 8 at stride 2 resolution.
        up = _resize_nearest(feats[2], feats[0].shape[2:])
        up = cnn.conv2d_same(up, b["lat1"], 1)
        fused = torch.cat([feats[0], up], dim=1)
        cls = cnn.conv2d_same(fused, params["head_cls"], 1)[0]
        box = cnn.conv2d_same(fused, params["head_box"], 1)[0]
    hh, ww = cls.shape[1:]
    # Head channel a*7 + k is anchor a, delta k.
    return cls.permute(1, 2, 0), box.permute(1, 2, 0).reshape(
        hh, ww, cfg.n_anchors, 7)


def anchor_grid(cfg: PillarConfig, hh: int, ww: int,
                device=None) -> torch.Tensor:
    """(H, W, A, 7) anchors: mean car size at two yaws."""
    ys, xs = torch.meshgrid(torch.arange(hh, device=device),
                            torch.arange(ww, device=device), indexing="ij")
    stride_x = (cfg.x_range[1] - cfg.x_range[0]) / ww
    stride_y = (cfg.y_range[1] - cfg.y_range[0]) / hh
    cx = cfg.x_range[0] + (xs.float() + 0.5) * stride_x
    cy = cfg.y_range[0] + (ys.float() + 0.5) * stride_y
    base = torch.stack([cx, cy, torch.full_like(cx, -1.0)], dim=-1)
    size = torch.tensor([3.9, 1.6, 1.56], device=device).expand(hh, ww, 3)
    return torch.stack([
        torch.cat([base, size, torch.full_like(cx, yaw)[..., None]], dim=-1)
        for yaw in (0.0, float(np.float32(math.pi / 2)))], dim=2)


def decode_boxes(cfg: PillarConfig, box_deltas: torch.Tensor) -> torch.Tensor:
    """Apply deltas to the anchor grid -> absolute boxes (H, W, A, 7)."""
    hh, ww = box_deltas.shape[:2]
    anch = anchor_grid(cfg, hh, ww, box_deltas.device)
    d = box_deltas
    diag = _hypot(anch[..., 3], anch[..., 4])
    return torch.stack([
        anch[..., 0] + d[..., 0] * diag,
        anch[..., 1] + d[..., 1] * diag,
        anch[..., 2] + d[..., 2] * anch[..., 5],
        anch[..., 3] * torch.exp(d[..., 3]),
        anch[..., 4] * torch.exp(d[..., 4]),
        anch[..., 5] * torch.exp(d[..., 5]),
        anch[..., 6] + d[..., 6],
    ], dim=-1)


def assign_targets(cfg: PillarConfig, hh: int, ww: int,
                   gt_boxes: torch.Tensor, gt_valid: torch.Tensor):
    """Nearest-cell target assignment (simplified SSD matching).

    Returns (cls_target (H,W,A), box_target (H,W,A,7), pos_mask). A later
    valid object overwrites an earlier one in the same cell.
    """
    dev = gt_boxes.device
    a_n = cfg.n_anchors
    anch = anchor_grid(cfg, hh, ww, dev)
    stride_x = (cfg.x_range[1] - cfg.x_range[0]) / ww
    stride_y = (cfg.y_range[1] - cfg.y_range[0]) / hh
    b = gt_boxes
    xi = _times_inverse(b[:, 0] - cfg.x_range[0], stride_x).to(
        torch.int32).clamp(0, ww - 1)
    yi = _times_inverse(b[:, 1] - cfg.y_range[0], stride_y).to(
        torch.int32).clamp(0, hh - 1)
    # Best-yaw anchor: 0 if |sin| < |cos| else 1.
    ai = (torch.sin(b[:, 6]).abs() > torch.cos(b[:, 6]).abs()).to(
        torch.int32)
    a = anch[yi.long(), xi.long(), ai.long()]                    # (O, 7)
    diag = _hypot(a[:, 3], a[:, 4])
    delta = torch.stack([
        (b[:, 0] - a[:, 0]) / diag, (b[:, 1] - a[:, 1]) / diag,
        (b[:, 2] - a[:, 2]) / a[:, 5],
        torch.log(torch.clamp_min(b[:, 3] / a[:, 3], 1e-3)),
        torch.log(torch.clamp_min(b[:, 4] / a[:, 4], 1e-3)),
        torch.log(torch.clamp_min(b[:, 5] / a[:, 5], 1e-3)),
        b[:, 6] - a[:, 6]], dim=-1)
    n_cells = hh * ww * a_n
    slot = cnn.last_writer_slots(((yi * ww + xi) * a_n + ai).long(),
                                 gt_valid, n_cells)
    cls_t = torch.zeros(n_cells + 1, device=dev)
    cls_t[slot] = 1.0
    box_t = torch.zeros((n_cells + 1, 7), device=dev)
    box_t[slot] = delta
    cls_t = cls_t[:n_cells].reshape(hh, ww, a_n)
    box_t = box_t[:n_cells].reshape(hh, ww, a_n, 7)
    return cls_t, box_t, cls_t > 0.5


def loss_fn(params, cfg: PillarConfig, points, valid, gt_boxes, gt_valid,
            alpha: float = 0.25, gamma: float = 2.0):
    """Focal classification + smooth-L1 box regression."""
    cls, box = forward(params, cfg, points, valid)
    hh, ww = cls.shape[:2]
    cls_t, box_t, pos = assign_targets(cfg, hh, ww, gt_boxes, gt_valid)
    p = torch.sigmoid(cls)
    pt = torch.where(cls_t > 0.5, p, 1 - p)
    af = torch.where(cls_t > 0.5, alpha, 1 - alpha)
    focal = -af * (1 - pt) ** gamma * torch.log(cnn.clip(pt, 1e-7, 1.0))
    n_pos = pos.sum().clamp_min(1)
    cls_loss = focal.sum() / n_pos
    diff = (box - box_t).abs()
    huber = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)
    box_loss = (huber * pos[..., None]).sum() / n_pos
    return cls_loss + 2.0 * box_loss, {"cls": cls_loss, "box": box_loss}


def detect(params, cfg: PillarConfig, points, valid, score_thresh=0.3,
           max_det: int = 32):
    """Inference: forward + decode + top-k + greedy BEV NMS."""
    cls, box = forward(params, cfg, points, valid)
    scores = torch.sigmoid(cls).reshape(-1)
    boxes = decode_boxes(cfg, box).reshape(-1, 7)
    # lax.top_k: descending, the lower index first among equal scores.
    idx = torch.sort(scores, descending=True, stable=True).indices[
        :max_det * 2]
    top, cand = scores[idx], boxes[idx]
    keep_score = top >= score_thresh
    n = cand.shape[0]
    big = box_ops.pairwise_iou_bev(cand, cand) > 0.5
    earlier = torch.ones((n, n), dtype=torch.bool,
                         device=cand.device).tril(-1)
    clash = big & earlier
    keep = torch.zeros(n, dtype=torch.bool, device=cand.device)
    for i in range(n):              # greedy: each box sees the kept ones
        keep[i] = keep_score[i] & ~(clash[i] & keep).any()
    order = torch.argsort((~keep).to(torch.int8), stable=True)
    return cand[order][:max_det], keep[order][:max_det]
