"""Typed entry points for the hot ops, under ``repro/ops/api.py``'s names.

Dispatch is by the device of the tensors and nothing else: a CPU tensor
goes to the op's plain PyTorch version, a CUDA tensor to its hand-written
kernel (``repro_torch/kernels``), and any failure to build or launch that
kernel raises. There is no backend string, no environment switch and no
capability test — the JAX package's ``ref`` / ``pallas`` / ``auto``
registry has no counterpart here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import ops as _dec_ops
from repro_torch.kernels.flash_attention import ops as _fa_ops
from repro_torch.kernels.iou2d import ops as _iou_ops
from repro_torch.kernels.mla_decode_attention import ops as _mla_ops
from repro_torch.kernels.pillar_scatter import ops as _ps_ops
from repro_torch.kernels.point_proj import ops as _pp_ops
from repro_torch.kernels.ransac_score import ops as _rs_ops


def point_proj(points: torch.Tensor, tr: torch.Tensor, p: torch.Tensor,
               height: int, width: int):
    """Fused LiDAR->pixel projection.

    (N,3) points + (3,4) Tr/P calibration -> (uv (N,2), depth (N,),
    visible (N,) bool, flat (N,) int32 gather index).
    """
    return _pp_ops.point_proj(points, tr, p, height, width)


def project_and_label(points: torch.Tensor, tr: torch.Tensor,
                      p: torch.Tensor, label_img: torch.Tensor
                      ) -> torch.Tensor:
    """:func:`point_proj` with the instance-id gather fused in: (N,3)
    points, (H,W) int32 label image -> (N,) int32 labels, 0 for background
    or invisible points. On the card one launch of the kernel's labels
    instance, which writes the labels and nothing else."""
    return _pp_ops.project_and_label(points, tr, p, label_img)


def label_points(flat: torch.Tensor, visible: torch.Tensor,
                 label_img: torch.Tensor) -> torch.Tensor:
    """Instance-id gather at the projected pixels (the unfused form; the
    serving path uses :func:`project_and_label`)."""
    lab = label_img.reshape(-1)[flat.long()]
    return torch.where(visible, lab, torch.zeros_like(lab))


def iou2d(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise axis-aligned IoU: (N,4) x (M,4) -> (N,M)."""
    return _iou_ops.iou2d(a, b)


def ransac_score(points: torch.Tensor, valid: torch.Tensor,
                 normals: torch.Tensor, offsets: torch.Tensor,
                 thresh: float) -> torch.Tensor:
    """Plane-hypothesis inlier counts: (O,P,3),(O,P),(O,K,3),(O,K) ->
    (O,K) int32."""
    return _rs_ops.ransac_score(points, valid, normals, offsets, thresh)


def pillar_scatter(feats: torch.Tensor, pillar_idx: torch.Tensor,
                   valid: torch.Tensor, n_pillars: int) -> torch.Tensor:
    """Scatter-max (N,C) float32 point features into a (G,C) pillar grid by
    their (N,) int32 pillar ids; invalid points and ids outside [0, G) are
    dropped, empty pillars read 0. Differentiable for ``feats``: the
    gradient splits each pillar's cotangent among its tied maxima, as the
    JAX package's VJP does."""
    return _ps_ops.PillarScatter.apply(feats, pillar_idx, valid, n_pillars)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q: (B,H,SQ,hd); k: (B,KV,SK,hd); v: (B,KV,SK,vd) -> (B,H,SQ,vd).
    The value head dim equals the qk head dim, or not at MLA's head dims
    (``kernels/flash_attention/ops.py::route``). q, k and v may be
    transposed views (the head dim contiguous): the kernel reads them in
    place. Differentiable for q, k and v at every pair of head dims: the
    gradient is a kernel on the card (``flash_attention_bwd``), the plain
    gradient on the CPU, as the JAX package's VJP recomputes the scores
    (at MLA's vd != hd JAX differentiates its plain attention)."""
    return _fa_ops.FlashAttention.apply(q, k, v, causal)


def decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, cache_pos: torch.Tensor
                     ) -> torch.Tensor:
    """Single-token decode: q (B,H,hd) over caches (B,KV,S,hd), attending
    positions [0, cache_pos) per request -> (B,H,hd). The caches may be
    transposed views of (B,S,KV,hd) storage. Differentiable for q and the
    caches (``decode_attention_bwd`` on the card); the positions get no
    gradient."""
    return _dec_ops.DecodeAttention.apply(q, cache_k, cache_v, cache_pos)


def mla_decode_attention(q_lat: torch.Tensor, q_rope: torch.Tensor,
                         ckv: torch.Tensor, krope: torch.Tensor,
                         lengths: torch.Tensor, scale: float
                         ) -> torch.Tensor:
    """MLA's absorbed decode attention over the compressed cache: q_lat
    (B,H,R), q_rope (B,H,P), ckv (B,S,R), krope (B,S,P), lengths (B,)
    int32 -> o_lat (B,H,R), the softmax of (q_lat.ckv + q_rope.krope) *
    scale over positions [0, lengths) times ckv. A port-only op: the JAX
    package computes it with einsums (``repro/models/mla.py``). Not
    differentiable (serving only)."""
    return _mla_ops.mla_decode_attention(q_lat, q_rope, ckv, krope, lengths,
                                         scale)
