"""Single-token decode with KV caches (``repro/models/decode.py``): the
serving step of the dense family.

Caches are stacked on the layer axis, in the JAX package's layout:
K/V (L, B, S, KV, hd), ``cache_pos`` (B,) int32. ``decode_step`` writes
each layer's new K/V into those tensors in place (JAX returns updated
copies; XLA donates the buffers) and returns a ``DecodeState`` that holds
the same cache tensors and the advanced positions. The other families'
caches (MLA, mamba2, xLSTM, encoder-decoder) are later slices and raise.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Union

import torch

from repro_torch import device as _device
from repro_torch.models import layers
from repro_torch.models.config import ArchConfig
from repro_torch.models.lm import layer, require_dense


class DecodeState(NamedTuple):
    """JAX's ``DecodeState`` without ``enc_out`` (the encoder-decoder
    family is not ported)."""
    caches: Any                 # {"k", "v"}: (L, B, S, KV, hd) each
    cache_pos: torch.Tensor     # (B,) int32 current lengths


def init_decode(cfg: ArchConfig, batch: int, max_len: int,
                torch_device: Union[str, torch.device] = _device.DEFAULT
                ) -> DecodeState:
    """Empty caches of ``max_len`` positions on ``torch_device`` (the card
    by default; without one the call raises)."""
    require_dense(cfg)
    dev = _device.resolve(torch_device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    caches = {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
              "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}
    return DecodeState(caches=caches,
                       cache_pos=torch.zeros((batch,), dtype=torch.int32,
                                             device=dev))


def decode_step(params, cfg: ArchConfig, state: DecodeState,
                tokens: torch.Tensor):
    """One serving step: tokens (B,) int -> (logits (B, vocab) f32, new
    state). The caches are updated in place."""
    require_dense(cfg)
    h = layers.embed_apply(params["embed"], tokens[:, None], cfg)  # (B,1,D)
    pos = state.cache_pos[:, None]                                 # (B,1)
    caches = state.caches
    for i in range(cfg.n_layers):
        p = layer(params, i)
        x = layers.norm_apply(p["ln1"], h, cfg.norm)
        a, _, _ = layers.attn_decode_apply(p["attn"], x, cfg,
                                           caches["k"][i], caches["v"][i],
                                           state.cache_pos, pos)
        h = h + a
        x = layers.norm_apply(p["ln2"], h, cfg.norm)
        h = h + layers.mlp_apply(p["mlp"], x, cfg)
    h = layers.norm_apply(params["final_norm"], h, cfg.norm)
    logits = layers.unembed_apply(params["embed"], h, cfg)[:, 0]
    return logits, DecodeState(caches=caches,
                               cache_pos=state.cache_pos + 1)
