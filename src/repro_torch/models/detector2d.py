"""YOLO-lite 2D instance detector (the "edge" model, trainable)
(``repro/models/detector2d.py``).

CenterNet-style single-stage head over a tiny conv backbone: a centre
heatmap and a size regression. It runs no hand-written kernel; it shares
the SAME-padded, full-float32 convolutions of ``models/cnn.py`` with the
3D detector. Parameters keep JAX's paths and HWIO shapes.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import cnn
from repro_torch.models.params import ParamDef, fanin_init, ones_init


@dataclasses.dataclass(frozen=True)
class Det2DConfig:
    img_h: int = 128
    img_w: int = 416
    in_ch: int = 3
    dims: tuple = (16, 32, 64)
    stride: int = 8              # product of the stride-2 blocks
    max_det: int = 16


def detector2d_defs(cfg: Det2DConfig):
    d = {}
    cin = cfg.in_ch
    for i, cout in enumerate(cfg.dims):
        d[f"conv{i}"] = ParamDef((3, 3, cin, cout), (None,) * 4,
                                 init=fanin_init())
        d[f"scale{i}"] = ParamDef((cout,), (None,), init=ones_init())
        cin = cout
    d["head_hm"] = ParamDef((1, 1, cin, 1), (None,) * 4, init=fanin_init())
    d["head_wh"] = ParamDef((1, 1, cin, 4), (None,) * 4, init=fanin_init())
    return d


def forward(params, cfg: Det2DConfig, img: torch.Tensor):
    """img: (B, H, W, C) -> (heatmap (B,h,w), boxreg (B,h,w,4))."""
    x = img.permute(0, 3, 1, 2)
    with cnn.f32_convolutions():
        for i in range(len(cfg.dims)):
            x = cnn.conv2d_same(x, params[f"conv{i}"], 2)
            # Over H and W, per (B, C): JAX's axes (1, 2) of NHWC.
            x = cnn.norm_relu(x, params[f"scale{i}"], (2, 3))
        hm = cnn.conv2d_same(x, params["head_hm"], 1)[:, 0]
        wh = cnn.conv2d_same(x, params["head_wh"], 1)
    return hm, wh.permute(0, 2, 3, 1)


def make_targets(cfg: Det2DConfig, boxes: torch.Tensor, valid: torch.Tensor):
    """Gaussian-free point targets at box centres. boxes: (O,4) pixels.
    A later valid box overwrites an earlier one in the same cell."""
    h = cfg.img_h // cfg.stride
    w = cfg.img_w // cfg.stride
    dev = boxes.device
    mid_x = (boxes[:, 0] + boxes[:, 2]) / 2
    mid_y = (boxes[:, 1] + boxes[:, 3]) / 2
    cx = (mid_x / cfg.stride).to(torch.int32).clamp(0, w - 1)
    cy = (mid_y / cfg.stride).to(torch.int32).clamp(0, h - 1)
    size = torch.stack([(boxes[:, 2] - boxes[:, 0]) / cfg.stride,
                        (boxes[:, 3] - boxes[:, 1]) / cfg.stride,
                        torch.remainder(mid_x, cfg.stride) / cfg.stride,
                        torch.remainder(mid_y, cfg.stride) / cfg.stride],
                       dim=-1)
    slot = cnn.last_writer_slots((cy * w + cx).long(), valid, h * w)
    hm = torch.zeros(h * w + 1, device=dev)
    hm[slot] = 1.0
    wh = torch.zeros((h * w + 1, 4), device=dev)
    wh[slot] = size
    return hm[:h * w].reshape(h, w), wh[:h * w].reshape(h, w, 4)


def loss_fn(params, cfg: Det2DConfig, img, boxes, valid):
    hm_p, wh_p = forward(params, cfg, img[None])
    hm_t, wh_t = make_targets(cfg, boxes, valid)
    p = torch.sigmoid(hm_p[0])
    pos = hm_t > 0.5
    focal = torch.where(
        pos, -((1 - p) ** 2) * torch.log(cnn.clip(p, 1e-7, 1.0)),
        -(p ** 2) * torch.log(cnn.clip(1 - p, 1e-7, 1.0)))
    n_pos = pos.sum().clamp_min(1)
    cls_loss = focal.sum() / n_pos
    l1 = ((wh_p[0] - wh_t).abs() * pos[..., None]).sum() / n_pos
    return cls_loss + l1, {"cls": cls_loss, "l1": l1}


def detect(params, cfg: Det2DConfig, img: torch.Tensor):
    """Returns (boxes2d (K,4) pixels, scores (K,), label_img (H,W))."""
    hm, wh = forward(params, cfg, img[None])
    p = torch.sigmoid(hm[0])
    h, w = p.shape
    flat = p.reshape(-1)
    # lax.top_k: descending, the lower index first among equal scores.
    idx = torch.sort(flat, descending=True, stable=True).indices[
        :cfg.max_det]
    scores = flat[idx]
    cy, cx = idx // w, idx % w
    size = wh[0].reshape(-1, 4)[idx]
    bw = torch.clamp_min(size[:, 0], 0.5) * cfg.stride
    bh = torch.clamp_min(size[:, 1], 0.5) * cfg.stride
    cxs = (cx.float() + size[:, 2]) * cfg.stride
    cys = (cy.float() + size[:, 3]) * cfg.stride
    boxes = torch.stack([cxs - bw / 2, cys - bh / 2, cxs + bw / 2,
                         cys + bh / 2], dim=1)
    # Label image: boxes painted far-to-near by score, so a pixel takes the
    # best-scoring box over 0.3 that holds it (1-based; 0 for none).
    yy = torch.arange(cfg.img_h, device=p.device)[None, :, None]
    xx = torch.arange(cfg.img_w, device=p.device)[None, None, :]
    bx = boxes[:, :, None, None]
    inside = (xx >= bx[:, 0]) & (xx <= bx[:, 2]) & (yy >= bx[:, 1]) & \
        (yy <= bx[:, 3]) & (scores > 0.3)[:, None, None]
    first = inside.to(torch.int8).argmax(dim=0)
    label_img = torch.where(inside.any(dim=0), first + 1, 0).to(torch.int32)
    return boxes, scores, label_img
