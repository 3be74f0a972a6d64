"""Plain PyTorch version of single-token decode attention over a KV cache
(``repro/kernels/decode_attention/ref.py``, with the Pallas kernel's
masking: masked scores are the finite -1e30, masked positions add p = 0,
and the sum is divided by max(l, 1e-30), so a request with cache_pos = 0
gives 0 where the JAX ``ref.py`` gives the mean of V)."""
from __future__ import annotations

import torch

NEG = -1e30


def decode_attention_ref(q: torch.Tensor, cache_k: torch.Tensor,
                         cache_v: torch.Tensor, cache_pos: torch.Tensor
                         ) -> torch.Tensor:
    """q: (B, H, hd); cache_k/v: (B, KV, S, hd); cache_pos: (B,) lengths.

    Attends over positions [0, cache_pos) per request. Returns (B, H, hd)
    in q's dtype, computed in float32.
    """
    b, h, hd = q.shape
    kv, s = cache_k.shape[1], cache_k.shape[2]
    qg = q.reshape(b, kv, h // kv, hd).float()
    scores = torch.einsum("bkgh,bksh->bkgs", qg,
                          cache_k.float()) * hd ** -0.5
    live = (torch.arange(s, device=q.device)[None, :]
            < cache_pos.to(q.device)[:, None])[:, None, None]   # (B,1,1,S)
    scores = torch.where(live, scores, NEG)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(live, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgs,bksh->bkgh", p, cache_v.float()) / \
        l.clamp_min(1e-30)
    return o.reshape(b, h, hd).to(q.dtype)
