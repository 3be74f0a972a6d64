"""Plain PyTorch version of blocked causal attention, GQA-aware
(``repro/kernels/flash_attention/ref.py``, with the Pallas kernel's
masking: masked scores are the finite -1e30, masked keys add p = 0, and the
sum is divided by max(l, 1e-30), so a row with no live key gives 0 where
the JAX ``ref.py`` gives the mean of V)."""
from __future__ import annotations

import torch

NEG = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """q: (B, H, SQ, hd); k/v: (B, KV, SK, hd). Returns (B, H, SQ, hd) in
    q's dtype, computed in float32."""
    b, h, sq, hd = q.shape
    kv, sk = k.shape[1], k.shape[2]
    qg = q.reshape(b, kv, h // kv, sq, hd).float()
    s = torch.einsum("bkgqh,bksh->bkgqs", qg, k.float()) * hd ** -0.5
    if causal:
        live = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
    else:
        live = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    s = torch.where(live, s, NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(live, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgqs,bksh->bkgqh", p, v.float()) / l.clamp_min(1e-30)
    return o.reshape(b, h, sq, hd).to(q.dtype)
