"""Multi-head Latent Attention (DeepSeek-V2) with a compressed KV cache
(``repro/models/mla.py``).

Prefill expands the latent ``c_kv`` into per-head keys (qk dim nope +
rope) and values (``v_head_dim``) and runs them through
``layers.multihead_attention``: on the card flash attention's kernels at a
value head dim unequal to the qk head dim. Decode uses the *absorbed*
form: the query is projected into the latent space, so attention runs
directly against the (kv_lora + rope) compressed cache through
``ops.mla_decode_attention`` (a kernel of its own on the card; the JAX
package computes it with plain einsums).

As in ``layers``: a product that JAX asks in f32 and rounds at once to
``cfg.dtype`` is one product in ``cfg.dtype`` here (an f32 sum rounded
once); the per-head products (the latent expansion, the query absorption
``q_nope . wk_b`` and ``o_lat . wv_b``) are batched GEMMs, as JAX leaves
them to XLA outside any Pallas kernel. The decode step writes the new
latent and rope key into the caches in place.
"""
from __future__ import annotations

import torch

from repro_torch import ops
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (_matmul, apply_rope, cast,
                                       multihead_attention, norm_apply,
                                       norm_defs)
from repro_torch.models.params import ParamDef, fanin_init


def mla_defs(cfg: ArchConfig):
    d = cfg.d_model
    h = cfg.n_heads
    nope, rope = cfg.qk_nope_dim, cfg.qk_rope_dim
    vdim = cfg.v_head_dim
    defs = {
        "wkv_a": ParamDef((d, cfg.kv_lora + rope), ("embed", "kv_lora"),
                          init=fanin_init()),
        "kv_norm": norm_defs(cfg.kv_lora, "rmsnorm"),
        "wk_b": ParamDef((cfg.kv_lora, h, nope), ("kv_lora", "heads", None),
                         init=fanin_init()),
        "wv_b": ParamDef((cfg.kv_lora, h, vdim), ("kv_lora", "heads", None),
                         init=fanin_init()),
        "wo": ParamDef((h, vdim, d), ("heads", None, "embed"),
                       init=fanin_init()),
    }
    if cfg.q_lora:
        defs["wq_a"] = ParamDef((d, cfg.q_lora), ("embed", "q_lora"),
                                init=fanin_init())
        defs["q_norm"] = norm_defs(cfg.q_lora, "rmsnorm")
        defs["wq_b"] = ParamDef((cfg.q_lora, h, nope + rope),
                                ("q_lora", "heads", None), init=fanin_init())
    else:
        defs["wq"] = ParamDef((d, h, nope + rope), ("embed", "heads", None),
                              init=fanin_init())
    return defs


def _queries(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """x (B, S, D) -> q (B, S, H, nope + rope) in ``cfg.dtype``."""
    if cfg.q_lora:
        cq = _matmul(x, cast(p["wq_a"], cfg), 1)
        cq = norm_apply(p["q_norm"], cq, "rmsnorm")
        return _matmul(cq, cast(p["wq_b"], cfg), 1)
    return _matmul(x, cast(p["wq"], cfg), 1)


def _latent_kv(p, x: torch.Tensor, cfg: ArchConfig,
               positions: torch.Tensor):
    """Compressed kv: returns (c_kv (B, S, kv_lora), k_rope (B, S, 1,
    rope))."""
    kv = _matmul(x, cast(p["wkv_a"], cfg), 1)
    c_kv, k_rope = kv[..., :cfg.kv_lora], kv[..., cfg.kv_lora:]
    c_kv = norm_apply(p["kv_norm"], c_kv, "rmsnorm")
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)
    return c_kv, k_rope


def mla_apply(p, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor,
              causal: bool = True) -> torch.Tensor:
    """Full-sequence MLA (prefill): x (B, S, D) -> (B, S, D)."""
    nope, rope = cfg.qk_nope_dim, cfg.qk_rope_dim
    q = _queries(p, x, cfg)                                  # (B,S,H,nope+rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv, k_rope = _latent_kv(p, x, cfg, positions)
    # Expand the latent to per-head keys and values.
    k_nope = _matmul(c_kv, cast(p["wk_b"], cfg), 1)         # (B,S,H,nope)
    v = _matmul(c_kv, cast(p["wv_b"], cfg), 1)              # (B,S,H,vdim)
    k_rope_b = k_rope.expand(*k_rope.shape[:2], cfg.n_heads, rope)
    qf = torch.cat([q_nope, q_rope], dim=-1)
    kf = torch.cat([k_nope, k_rope_b], dim=-1)
    out = multihead_attention(qf, kf, v, causal)             # KV == H heads
    return _matmul(out, cast(p["wo"], cfg), 2).to(cfg.dtype)


def mla_decode_apply(p, x: torch.Tensor, cfg: ArchConfig,
                     cache_ckv: torch.Tensor, cache_krope: torch.Tensor,
                     cache_pos: torch.Tensor, positions: torch.Tensor):
    """Absorbed-matrix decode against the compressed cache.

    x: (B, 1, D); cache_ckv: (B, S_max, kv_lora); cache_krope: (B, S_max,
    rope); cache_pos: (B,) int32. Returns (out (B, 1, D), cache_ckv,
    cache_krope): the new latent and rope key are written into the caches
    in place, at each request's position clamped to S_max - 1 as
    ``dynamic_update_slice`` clamps it, and the returned caches are the
    same tensors. Attention covers positions [0, cache_pos].
    """
    b = x.shape[0]
    nope, rope = cfg.qk_nope_dim, cfg.qk_rope_dim
    q = _queries(p, x, cfg)[:, 0]                            # (B,H,nope+rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope[:, None], positions, cfg.rope_theta)[:, 0]
    c_kv, k_rope = _latent_kv(p, x, cfg, positions)
    rows = torch.arange(b, device=x.device)
    at = cache_pos.long().clamp(max=cache_ckv.shape[1] - 1)
    cache_ckv[rows, at] = c_kv[:, 0].to(cache_ckv.dtype)
    cache_krope[rows, at] = k_rope[:, 0, 0].to(cache_krope.dtype)
    # Absorb wk_b into the query: q_lat (B, H, kv_lora), rounded to
    # cfg.dtype as JAX rounds it before scoring.
    q_lat = torch.einsum("bhk,rhk->bhr", q_nope, cast(p["wk_b"], cfg))
    scale = (nope + rope) ** -0.5
    o_lat = ops.mla_decode_attention(q_lat, q_rope, cache_ckv, cache_krope,
                                     cache_pos + 1, scale)   # (B,H,kv_lora)
    o = torch.einsum("bhr,rhk->bhk", o_lat, cast(p["wv_b"], cfg))
    out = _matmul(o, cast(p["wo"], cfg), 2).to(cfg.dtype)   # (B, D)
    return out[:, None], cache_ckv, cache_krope
