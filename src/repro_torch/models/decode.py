"""Single-token decode with KV caches (``repro/models/decode.py``): the
serving step of the dense, vlm, moe and encoder-decoder (audio) families.

Caches are stacked on the layer axis, in the JAX package's layout:
K/V (L, B, S, KV, hd), ``cache_pos`` (B,) int32; the moe family keeps one
pair a layer stack, ``{"dense": {"k", "v"} or None, "moe": {"k", "v"}}``
(``dense`` None where there are no leading dense layers). With MLA
(deepseek-v2) the pair is the compressed cache instead: ``{"ckv"
(L, B, S, kv_lora), "krope" (L, B, S, rope)}``. The encoder-decoder keeps
``{"self": {"k", "v"}, "cross_k", "cross_v"}``, the cross caches (L, B,
enc_seq, KV, hd). ``decode_step`` writes each layer's new entries into
those tensors in place (JAX returns updated copies; XLA donates the
buffers) and returns a ``DecodeState`` that holds the same cache tensors
and the advanced positions. The other families' caches (mamba2, xLSTM)
are later slices and raise.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Union

import torch

from repro_torch import device as _device
from repro_torch import ops
from repro_torch.models import layers, mla
from repro_torch.models.config import ArchConfig
from repro_torch.models.lm import (ENCDEC, ffn_apply, layer, require_ported,
                                   stacks)


class DecodeState(NamedTuple):
    """JAX's ``DecodeState``, field for field."""
    caches: Any                 # {"k", "v"} or {"ckv", "krope"} (moe: a
    #                             pair a stack; encdec: self and cross)
    cache_pos: torch.Tensor     # (B,) int32 current lengths
    enc_out: Any = None         # (B, enc_seq, D) encoder output (encdec
    #                             only; carried along, read by no step)


def init_decode(cfg: ArchConfig, batch: int, max_len: int,
                torch_device: Union[str, torch.device] = _device.DEFAULT
                ) -> DecodeState:
    """Empty caches of ``max_len`` positions on ``torch_device`` (the card
    by default; without one the call raises). The encoder-decoder's cross
    caches are zeros of ``cfg.enc_seq`` positions, as JAX allocates them:
    no code of the JAX package fills them from ``enc_out``."""
    require_ported(cfg)
    dev = _device.resolve(torch_device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=cfg.dtype, device=dev)

    def kv(n_layers: int, s: int = max_len):
        if cfg.attn_kind == "mla":
            return {"ckv": zeros(n_layers, batch, s, cfg.kv_lora),
                    "krope": zeros(n_layers, batch, s, cfg.qk_rope_dim)}
        shape = (n_layers, batch, s, cfg.n_kv_heads, cfg.head_dim)
        return {"k": zeros(*shape), "v": zeros(*shape)}
    if cfg.family in ("dense", "vlm"):
        caches = kv(cfg.n_layers)
    elif cfg.family in ENCDEC:
        cross = kv(cfg.n_layers, cfg.enc_seq)
        caches = {"self": kv(cfg.n_layers), "cross_k": cross["k"],
                  "cross_v": cross["v"]}
    else:
        caches = {"dense": kv(cfg.first_dense) if cfg.first_dense else None,
                  "moe": kv(cfg.n_layers - cfg.first_dense)}
    return DecodeState(caches=caches,
                       cache_pos=torch.zeros((batch,), dtype=torch.int32,
                                             device=dev))


def cross_decode_apply(p, x: torch.Tensor, cfg: ArchConfig,
                       cross_k: torch.Tensor, cross_v: torch.Tensor,
                       lengths: torch.Tensor) -> torch.Tensor:
    """The decode step's cross attention (JAX's einsums in
    ``decode_step``, encdec branch): x (B, 1, D), the layer's cross caches
    (B, F, KV, hd), lengths (B,) int32 (F everywhere: every position is
    attended) -> (B, 1, D). The query is ``x @ wq`` with no bias, as in
    JAX; attention goes through ``ops.decode_attention`` on (B, KV, F, hd)
    views (the kernel on the card, its plain version on the CPU)."""
    q = layers._matmul(x, layers.cast(p["wq"], cfg), 1)
    att = ops.decode_attention(q[:, 0], cross_k.transpose(1, 2),
                               cross_v.transpose(1, 2), lengths)
    return layers._matmul(att[:, None].to(cfg.dtype),
                          layers.cast(p["wo"], cfg), 2).to(cfg.dtype)


def _encdec_layers(params, cfg: ArchConfig, state: DecodeState,
                   h: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    caches = state.caches
    self_k, self_v = caches["self"]["k"], caches["self"]["v"]
    lengths = torch.full((h.shape[0],), caches["cross_k"].shape[2],
                         dtype=torch.int32, device=h.device)
    for i in range(self_k.shape[0]):
        p = layer(params, i)
        x = layers.norm_apply(p["ln1"], h, cfg.norm)
        a, _, _ = layers.attn_decode_apply(p["attn"], x, cfg, self_k[i],
                                           self_v[i], state.cache_pos, pos)
        h = h + a
        x = layers.norm_apply(p["ln_cross"], h, cfg.norm)
        h = h + cross_decode_apply(p["cross"], x, cfg, caches["cross_k"][i],
                                   caches["cross_v"][i], lengths)
        x = layers.norm_apply(p["ln2"], h, cfg.norm)
        h = h + layers.mlp_apply(p["mlp"], x, cfg)
    return h


def decode_step(params, cfg: ArchConfig, state: DecodeState,
                tokens: torch.Tensor):
    """One serving step: tokens (B,) int -> (logits (B, vocab) f32, new
    state). The caches are updated in place. M-RoPE takes the cache
    position on all three of its streams, as JAX's step does."""
    require_ported(cfg)
    h = layers.embed_apply(params["embed"], tokens[:, None], cfg)  # (B,1,D)
    pos = state.cache_pos[:, None]                                 # (B,1)
    if cfg.pos_embedding == "mrope":
        pos = pos[None].expand(3, *pos.shape)                      # (3,B,1)
    if cfg.family in ENCDEC:
        h = _encdec_layers(params, cfg, state, h, pos)
    else:
        names = ("ckv", "krope") if cfg.attn_kind == "mla" else ("k", "v")
        attn = mla.mla_decode_apply if cfg.attn_kind == "mla" else \
            layers.attn_decode_apply
        for key, moe in stacks(cfg):
            cache = state.caches if cfg.family != "moe" else \
                state.caches["moe" if moe else "dense"]
            for i in range(cache[names[0]].shape[0]):
                p = layer(params, i, key)
                x = layers.norm_apply(p["ln1"], h, cfg.norm)
                a, _, _ = attn(p["attn"], x, cfg, cache[names[0]][i],
                               cache[names[1]][i], state.cache_pos, pos)
                h = h + a
                x = layers.norm_apply(p["ln2"], h, cfg.norm)
                h = h + ffn_apply(p, x, cfg, moe)
    h = layers.norm_apply(params["final_norm"], h, cfg.norm)
    logits = layers.unembed_apply(params["embed"], h, cfg)[:, 0]
    return logits, DecodeState(caches=state.caches,
                               cache_pos=state.cache_pos + 1,
                               enc_out=state.enc_out)
