"""Single-token decode with KV caches (``repro/models/decode.py``): the
serving step of the dense and moe families.

Caches are stacked on the layer axis, in the JAX package's layout:
K/V (L, B, S, KV, hd), ``cache_pos`` (B,) int32; the moe family keeps one
pair a layer stack, ``{"dense": {"k", "v"} or None, "moe": {"k", "v"}}``
(``dense`` None where there are no leading dense layers). With MLA
(deepseek-v2) the pair is the compressed cache instead: ``{"ckv"
(L, B, S, kv_lora), "krope" (L, B, S, rope)}``. ``decode_step`` writes each
layer's new entries into those tensors in place (JAX returns updated
copies; XLA donates the buffers) and returns a ``DecodeState`` that holds
the same cache tensors and the advanced positions. The other families'
caches (mamba2, xLSTM, encoder-decoder) are later slices and raise.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Union

import torch

from repro_torch import device as _device
from repro_torch.models import layers, mla
from repro_torch.models.config import ArchConfig
from repro_torch.models.lm import ffn_apply, layer, require_ported, stacks


class DecodeState(NamedTuple):
    """JAX's ``DecodeState`` without ``enc_out`` (the encoder-decoder
    family is not ported)."""
    caches: Any                 # {"k", "v"} or {"ckv", "krope"} (moe: a
    #                             pair a stack)
    cache_pos: torch.Tensor     # (B,) int32 current lengths


def init_decode(cfg: ArchConfig, batch: int, max_len: int,
                torch_device: Union[str, torch.device] = _device.DEFAULT
                ) -> DecodeState:
    """Empty caches of ``max_len`` positions on ``torch_device`` (the card
    by default; without one the call raises)."""
    require_ported(cfg)
    dev = _device.resolve(torch_device)

    def kv(n_layers: int):
        if cfg.attn_kind == "mla":
            lead = (n_layers, batch, max_len)
            return {"ckv": torch.zeros(lead + (cfg.kv_lora,),
                                       dtype=cfg.dtype, device=dev),
                    "krope": torch.zeros(lead + (cfg.qk_rope_dim,),
                                         dtype=cfg.dtype, device=dev)}
        shape = (n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}
    if cfg.family == "dense":
        caches = kv(cfg.n_layers)
    else:
        caches = {"dense": kv(cfg.first_dense) if cfg.first_dense else None,
                  "moe": kv(cfg.n_layers - cfg.first_dense)}
    return DecodeState(caches=caches,
                       cache_pos=torch.zeros((batch,), dtype=torch.int32,
                                             device=dev))


def decode_step(params, cfg: ArchConfig, state: DecodeState,
                tokens: torch.Tensor):
    """One serving step: tokens (B,) int -> (logits (B, vocab) f32, new
    state). The caches are updated in place."""
    require_ported(cfg)
    h = layers.embed_apply(params["embed"], tokens[:, None], cfg)  # (B,1,D)
    pos = state.cache_pos[:, None]                                 # (B,1)
    names = ("ckv", "krope") if cfg.attn_kind == "mla" else ("k", "v")
    attn = mla.mla_decode_apply if cfg.attn_kind == "mla" else \
        layers.attn_decode_apply
    for key, moe in stacks(cfg):
        cache = state.caches if cfg.family == "dense" else \
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
                               cache_pos=state.cache_pos + 1)
