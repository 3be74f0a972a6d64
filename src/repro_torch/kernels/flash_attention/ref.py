"""Plain PyTorch versions of blocked causal attention, GQA-aware, and of
its gradient (``repro/kernels/flash_attention/ref.py``, with the Pallas
kernel's masking: masked scores are the finite -1e30, masked keys add
p = 0, and the sum is divided by max(l, 1e-30), so a row with no live key
gives 0 where the JAX ``ref.py`` gives the mean of V)."""
from __future__ import annotations

import torch

NEG = -1e30


def _wide(t: torch.Tensor) -> torch.Tensor:
    """The gradients' working precision: float32, or float64 for float64
    inputs (the card's checks take the exact result from float64)."""
    return t.double() if t.dtype == torch.float64 else t.float()


def _exp_scores(qg: torch.Tensor, k: torch.Tensor, causal: bool
                ) -> torch.Tensor:
    """exp(s - rowmax) (B, KV, G, SQ, SK) of grouped queries qg (B, KV, G,
    SQ, hd) over keys k (B, KV, SK, hd) in qg's dtype: masked keys 0."""
    sq, hd, sk = qg.shape[3], qg.shape[4], k.shape[2]
    s = torch.einsum("bkgqh,bksh->bkgqs", qg, k.to(qg.dtype)) * hd ** -0.5
    live = torch.ones(sq, sk, dtype=torch.bool, device=qg.device)
    if causal:
        live = live.tril()
    s = torch.where(live, s, NEG)
    m = s.amax(dim=-1, keepdim=True)
    return torch.where(live, torch.exp(s - m), 0.0)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """q: (B, H, SQ, hd); k: (B, KV, SK, hd); v: (B, KV, SK, vd). Returns
    (B, H, SQ, vd) in q's dtype, computed in float32; the scores are
    scaled by hd^-0.5 (the value head dim may differ: MLA)."""
    b, h, sq, hd = q.shape
    kv, vd = k.shape[1], v.shape[-1]
    p = _exp_scores(q.reshape(b, kv, h // kv, sq, hd).float(), k, causal)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgqs,bksh->bkgqh", p, v.float()) / l.clamp_min(1e-30)
    return o.reshape(b, h, sq, vd).to(q.dtype)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            do: torch.Tensor, causal: bool = True):
    """The gradient of :func:`flash_attention_ref` at (q, k, v) for the
    output cotangent ``do`` (B, H, SQ, vd), given the forward's output
    ``o`` (B, H, SQ, vd), written out in float32, or float64 for float64
    inputs (no autograd): with A the softmax
    weights, dV = A^T dO, dP = dO V^T, dS = A * (dP - rowsum(dO * O)),
    dQ = scale dS K, dK = scale dS^T Q (scale = hd^-0.5, hd the qk head
    dim), the G = H / KV query heads of a kv head summed into its dK and
    dV. dq and dk have the qk head dim, dv the value head dim (MLA's
    differ). Returns (dq, dk, dv) in the inputs' dtypes."""
    b, h, sq, hd = q.shape
    kv, vd = k.shape[1], v.shape[-1]
    qg = _wide(q.reshape(b, kv, h // kv, sq, hd))
    dog = _wide(do.reshape(b, kv, h // kv, sq, vd))
    p = _exp_scores(qg, k, causal)
    a = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    dv = torch.einsum("bkgqs,bkgqh->bksh", a, dog)
    dp = torch.einsum("bkgqh,bksh->bkgqs", dog, _wide(v))
    og = _wide(o.reshape(b, kv, h // kv, sq, vd))
    ds = a * (dp - (dog * og).sum(-1, keepdim=True))
    scale = hd ** -0.5
    dq = torch.einsum("bkgqs,bksh->bkgqh", ds, _wide(k)) * scale
    dk = torch.einsum("bkgqs,bkgqh->bksh", ds, qg) * scale
    return (dq.reshape(b, h, sq, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
