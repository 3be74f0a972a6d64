"""Plain PyTorch version of MLA's absorbed decode attention over the
compressed cache: the einsums of ``repro/models/mla.py::mla_decode_apply``
from the scores to ``o_lat``.

With the masking of the port's other attention references: masked scores
are the finite -1e30, masked positions add p = 0, and the weights are
divided by max(l, 1e-30), so a request of length 0 gives 0 (JAX's mask
always holds the new position, so its softmax never meets that case).
Otherwise the weights are JAX's softmax, rounded to the inputs' dtype
before the product with ``ckv`` as JAX rounds them.

``mla_decode_partial_ref`` and ``mla_decode_merge_ref`` are the
tensor-core instance's split of the same softmax: a segment's
unnormalised partial and the merge of a row's partials.
"""
from __future__ import annotations

import torch

NEG = -1e30
LOG2E = 1.4426950408889634


def mla_decode_attention_ref(q_lat: torch.Tensor, q_rope: torch.Tensor,
                             ckv: torch.Tensor, krope: torch.Tensor,
                             lengths: torch.Tensor, scale: float
                             ) -> torch.Tensor:
    """q_lat (B, H, R), q_rope (B, H, P), ckv (B, S, R), krope (B, S, P),
    lengths (B,) -> o_lat (B, H, R) in q_lat's dtype: the scores
    (q_lat . ckv + q_rope . krope) * scale summed in f32, the softmax over
    positions [0, lengths) in f32, its weights rounded to the dtype, and
    their product with ckv summed in f32."""
    s = (torch.einsum("bhr,bsr->bhs", q_lat.float(), ckv.float())
         + torch.einsum("bhk,bsk->bhs", q_rope.float(), krope.float())) \
        * scale
    live = (torch.arange(ckv.shape[1], device=s.device)[None, :]
            < lengths.to(s.device)[:, None])[:, None]            # (B,1,S)
    s = torch.where(live, s, NEG)
    p = torch.where(live, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    w = (p / p.sum(-1, keepdim=True).clamp_min(1e-30)).to(q_lat.dtype)
    return torch.einsum("bhs,bsr->bhr", w.float(),
                        ckv.float()).to(q_lat.dtype)


def mla_decode_partial_ref(q_lat: torch.Tensor, q_rope: torch.Tensor,
                           ckv: torch.Tensor, krope: torch.Tensor,
                           lo: int, hi: int, scale: float):
    """The unnormalised partial of positions [lo, hi) (all live), as the
    tensor-core instance writes a segment's: m (B, H), the scores' max in
    the log2 domain (scale x log2(e) folded in), l (B, H) = sum of
    p = 2^(s - m), and acc (B, H, R) = p . ckv, in f32 (p not rounded)."""
    s = (torch.einsum("bhr,bsr->bhs", q_lat.float(), ckv[:, lo:hi].float())
         + torch.einsum("bhk,bsk->bhs", q_rope.float(),
                        krope[:, lo:hi].float())) * (scale * LOG2E)
    m = s.amax(-1)
    p = torch.exp2(s - m[..., None])
    return m, p.sum(-1), torch.einsum("bhs,bsr->bhr", p,
                                      ckv[:, lo:hi].float())


def mla_decode_merge_ref(parts) -> torch.Tensor:
    """The merge of a row's partials (m, l, acc) (at least one), as the
    kernel's second pass: each rescaled by 2^(m - max m), summed, divided
    by max(l, 1e-30). A request with no live position has no partial and
    gets 0."""
    m = torch.stack([x[0] for x in parts]).amax(0)
    w = [torch.exp2(x[0] - m) for x in parts]
    l = sum(x[1] * wi for x, wi in zip(parts, w))
    acc = sum(x[2] * wi[..., None] for x, wi in zip(parts, w))
    return acc / l.clamp_min(1e-30)[..., None]
