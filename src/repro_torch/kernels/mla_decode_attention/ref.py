"""Plain PyTorch version of MLA's absorbed decode attention over the
compressed cache: the einsums of ``repro/models/mla.py::mla_decode_apply``
from the scores to ``o_lat``.

With the masking of the port's other attention references: masked scores
are the finite -1e30, masked positions add p = 0, and the weights are
divided by max(l, 1e-30), so a request of length 0 gives 0 (JAX's mask
always holds the new position, so its softmax never meets that case).
Otherwise the weights are JAX's softmax, rounded to the inputs' dtype
before the product with ``ckv`` as JAX rounds them.
"""
from __future__ import annotations

import torch

NEG = -1e30


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
