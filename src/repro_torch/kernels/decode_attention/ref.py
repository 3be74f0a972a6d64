"""Plain PyTorch versions of single-token decode attention over a KV cache
and of its gradient (``repro/kernels/decode_attention/ref.py``, with the
Pallas kernel's masking: masked scores are the finite -1e30, masked positions add p = 0,
and the sum is divided by max(l, 1e-30), so a request with cache_pos = 0
gives 0 where the JAX ``ref.py`` gives the mean of V)."""
from __future__ import annotations

import torch

NEG = -1e30


def _wide(t: torch.Tensor) -> torch.Tensor:
    """The gradients' working precision: float32, or float64 for float64
    inputs (the card's checks take the exact result from float64)."""
    return t.double() if t.dtype == torch.float64 else t.float()


def _exp_scores(qg: torch.Tensor, cache_k: torch.Tensor,
                cache_pos: torch.Tensor) -> torch.Tensor:
    """exp(s - rowmax) (B, KV, G, S) of grouped queries qg (B, KV, G, hd)
    in qg's dtype over positions [0, cache_pos): 0 elsewhere."""
    hd, s = qg.shape[-1], cache_k.shape[2]
    scores = torch.einsum("bkgh,bksh->bkgs", qg,
                          cache_k.to(qg.dtype)) * hd ** -0.5
    live = (torch.arange(s, device=qg.device)[None, :]
            < cache_pos.to(qg.device)[:, None])[:, None, None]   # (B,1,1,S)
    scores = torch.where(live, scores, NEG)
    m = scores.amax(dim=-1, keepdim=True)
    return torch.where(live, torch.exp(scores - m), 0.0)


def decode_attention_ref(q: torch.Tensor, cache_k: torch.Tensor,
                         cache_v: torch.Tensor, cache_pos: torch.Tensor
                         ) -> torch.Tensor:
    """q: (B, H, hd); cache_k/v: (B, KV, S, hd); cache_pos: (B,) lengths.

    Attends over positions [0, cache_pos) per request. Returns (B, H, hd)
    in q's dtype, computed in float32.
    """
    b, h, hd = q.shape
    kv = cache_k.shape[1]
    p = _exp_scores(q.reshape(b, kv, h // kv, hd).float(), cache_k,
                    cache_pos)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgs,bksh->bkgh", p, cache_v.float()) / \
        l.clamp_min(1e-30)
    return o.reshape(b, h, hd).to(q.dtype)


def decode_attention_bwd_ref(q: torch.Tensor, cache_k: torch.Tensor,
                             cache_v: torch.Tensor, cache_pos: torch.Tensor,
                             o: torch.Tensor, do: torch.Tensor):
    """The gradient of :func:`decode_attention_ref` at (q, cache_k,
    cache_v) for the output cotangent ``do`` (B, H, hd), given the
    forward's output ``o``, written out in float32, or float64 for float64
    inputs (no autograd): with a
    the softmax weights, dV = a^T do, dp = do.v, ds = a (dp - do.o),
    dq = scale ds K, dK = scale ds^T q, the G = H / KV query heads of a kv
    head summed. dK and dV are 0 at positions >= cache_pos; the positions
    get no gradient. Returns (dq (B, H, hd), dk, dv (B, KV, S, hd)) in the
    inputs' dtypes."""
    b, h, hd = q.shape
    kv = cache_k.shape[1]
    grouped = (b, kv, h // kv, hd)
    qg = _wide(q.reshape(grouped))
    dog = _wide(do.reshape(grouped))
    p = _exp_scores(qg, cache_k, cache_pos)
    a = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    dv = torch.einsum("bkgs,bkgh->bksh", a, dog)
    dp = torch.einsum("bkgh,bksh->bkgs", dog, _wide(cache_v))
    ds = a * (dp - (dog * _wide(o.reshape(grouped))).sum(-1, keepdim=True))
    scale = hd ** -0.5
    dq = torch.einsum("bkgs,bksh->bkgh", ds, _wide(cache_k)) * scale
    dk = torch.einsum("bkgs,bkgh->bksh", ds, qg) * scale
    return (dq.reshape(b, h, hd).to(q.dtype), dk.to(cache_k.dtype),
            dv.to(cache_v.dtype))
