"""Model assembly for the dense, vlm, moe and encoder-decoder (audio)
families (``repro/models/lm.py``).

The parameter tree is the JAX package's: ``{"embed", "final_norm",
"blocks"}`` for the dense and vlm families, ``{"embed", "final_norm",
"dense_blocks", "moe_blocks"}`` for the moe family (``dense_blocks`` the
``first_dense`` leading layers with a dense MLP, absent when there are
none), and for the encoder-decoder family ``{"embed", "final_norm",
"enc_blocks", "enc_final_norm", "blocks", "enc_pos"}`` (the decoder's
blocks add ``ln_cross`` and ``cross``; ``enc_pos`` the learned encoder
positions), with every leaf of a stack on a leading layer axis.
``forward`` walks the stacks in that order, a Python loop over views of
the layer axis (JAX's ``lax.scan``). It is the prefill entry point and,
under ``loss_fn``, the training forward; the serving step is
``repro_torch.models.decode.decode_step``. The moe family's attention is
full attention (``layers.attn_apply``) or MLA (``models/mla.py``,
deepseek-v2), as ``cfg.attn_kind`` says; the vlm family is the dense stack
with M-RoPE positions (3, B, S) and takes its inputs as embeddings. Every
ported family trains through ``loss_fn``, as JAX's one ``loss_fn`` trains
every family (no auxiliary loss). The ssm and hybrid families are later
slices and raise.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers, mla
from repro_torch.models.config import ArchConfig
from repro_torch.models.params import ParamDef, leaves, tree_map

# Parameter groups kept f32 by cast_params: norm_apply multiplies in f32
# (MLA's q_norm and kv_norm, the decoder's ln_cross and the encoder's final
# norm too).
_NORMS = ("ln1", "ln2", "final_norm", "q_norm", "kv_norm", "ln_cross",
          "enc_final_norm")
# The families of decoder-only layer stacks, and of the encoder-decoder.
DECODER_ONLY = ("dense", "vlm", "moe")
ENCDEC = ("encdec", "audio")


def require_ported(cfg: ArchConfig) -> None:
    """The families the port runs: dense, vlm and encoder-decoder (audio)
    with full attention, and moe with full attention or MLA."""
    kinds = ("full", "mla") if cfg.family == "moe" else ("full",)
    if cfg.family not in DECODER_ONLY + ENCDEC or \
            cfg.attn_kind not in kinds:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} (attention {cfg.attn_kind!r})"
            f" is not ported yet; the port runs the dense, vlm and "
            f"encoder-decoder families with full attention and the moe "
            f"family with full attention or MLA (see ROADMAP.md)")


def stacks(cfg: ArchConfig) -> List[Tuple[str, bool]]:
    """The layer stacks in the order the model runs them: (key of the
    parameter tree, whether its layers are MoE layers). The
    encoder-decoder's are the encoder's and the decoder's (whose layers
    add cross attention)."""
    if cfg.family in ("dense", "vlm"):
        return [("blocks", False)]
    if cfg.family in ENCDEC:
        return [("enc_blocks", False), ("blocks", False)]
    return [("dense_blocks", False)] * bool(cfg.first_dense) + \
        [("moe_blocks", True)]


def encoder_config(cfg: ArchConfig) -> ArchConfig:
    """The encoder's config: multi-head attention (a kv head a head)."""
    return dataclasses.replace(cfg, n_kv_heads=cfg.n_heads)


def stack_defs(defs, n: int):
    """Prepend a ``layers`` axis of size n to every ParamDef in the tree."""
    return tree_map(lambda d: ParamDef((n,) + d.shape,
                                       ("layers",) + d.logical_axes,
                                       d.dtype, d.init), defs)


def _attn_block_defs(cfg: ArchConfig, moe: bool = False):
    d = {"ln1": layers.norm_defs(cfg.d_model, cfg.norm),
         "ln2": layers.norm_defs(cfg.d_model, cfg.norm),
         "attn": mla.mla_defs(cfg) if cfg.attn_kind == "mla"
         else layers.attn_defs(cfg)}
    if moe:
        d["moe"] = layers.moe_defs(cfg)
    else:
        d["mlp"] = layers.mlp_defs(cfg)
    return d


def ffn_apply(p, x: torch.Tensor, cfg: ArchConfig, moe: bool
              ) -> torch.Tensor:
    """A block's feed-forward part: the MoE layer or the dense MLP."""
    return layers.moe_apply(p["moe"], x, cfg) if moe else \
        layers.mlp_apply(p["mlp"], x, cfg)


def _attn_block_apply(p, h: torch.Tensor, cfg: ArchConfig,
                      positions: torch.Tensor, moe: bool = False,
                      causal: bool = True) -> torch.Tensor:
    x = layers.norm_apply(p["ln1"], h, cfg.norm)
    attn = mla.mla_apply if cfg.attn_kind == "mla" else layers.attn_apply
    h = h + attn(p["attn"], x, cfg, positions, causal)
    x = layers.norm_apply(p["ln2"], h, cfg.norm)
    return h + ffn_apply(p, x, cfg, moe)


def _dec_block_apply(p, h: torch.Tensor, cfg: ArchConfig,
                     positions: torch.Tensor, enc: torch.Tensor
                     ) -> torch.Tensor:
    """An encoder-decoder's decoder layer: causal self attention, cross
    attention over the encoder's output ``enc``, the MLP."""
    x = layers.norm_apply(p["ln1"], h, cfg.norm)
    h = h + layers.attn_apply(p["attn"], x, cfg, positions, True)
    x = layers.norm_apply(p["ln_cross"], h, cfg.norm)
    h = h + layers.attn_apply(p["cross"], x, cfg, positions, causal=False,
                              kv_x=enc)
    x = layers.norm_apply(p["ln2"], h, cfg.norm)
    return h + layers.mlp_apply(p["mlp"], x, cfg)


def model_defs(cfg: ArchConfig):
    require_ported(cfg)
    d = {"embed": layers.embed_defs(cfg),
         "final_norm": layers.norm_defs(cfg.d_model, cfg.norm)}
    if cfg.family in ENCDEC:
        d["enc_blocks"] = stack_defs(_attn_block_defs(encoder_config(cfg)),
                                     cfg.n_enc_layers)
        d["enc_final_norm"] = layers.norm_defs(cfg.d_model, cfg.norm)
        dec = _attn_block_defs(cfg)
        dec["ln_cross"] = layers.norm_defs(cfg.d_model, cfg.norm)
        dec["cross"] = layers.attn_defs(cfg)
        d["blocks"] = stack_defs(dec, cfg.n_layers)
        # Learned encoder positions (whisper-style); the decoder's are RoPE.
        d["enc_pos"] = ParamDef((cfg.enc_seq, cfg.d_model), (None, "embed"),
                                dtype=torch.float32)
        return d
    n = {"blocks": cfg.n_layers, "dense_blocks": cfg.first_dense,
         "moe_blocks": cfg.n_layers - cfg.first_dense}
    for key, moe in stacks(cfg):
        d[key] = stack_defs(_attn_block_defs(cfg, moe), n[key])
    return d


def cast_params(params, cfg: ArchConfig):
    """The tree with every matrix and bias cast to ``cfg.dtype`` once, the
    norm parameters left f32: the values the layers would cast at each use
    (JAX stores f32 and casts at use; the encoder positions ``enc_pos``
    too), without re-reading f32 weights on every call. Serving in bf16
    reads half the bytes per step."""
    def walk(tree, keep_f32: bool):
        if isinstance(tree, dict):
            return {k: walk(v, keep_f32 or k in _NORMS)
                    for k, v in tree.items()}
        return tree if keep_f32 else tree.to(cfg.dtype)
    return walk(params, False)


def init_cast_params(cfg: ArchConfig, generator: torch.Generator,
                     torch_device=None):
    """Seeded random weights already in :func:`cast_params`'s dtypes
    (matrices ``cfg.dtype``, norms f32), drawn a layer of a stack at a
    time: the f32 tree of :func:`repro_torch.models.params.init_params`
    would hold a full-width moe stack in f32 at once (deepseek-v2's 7 MoE
    layers: 110 GB), past one card. Each leaf's distribution is
    ``init_params``'s (its initialiser, on its own shape without the layer
    axis, which keeps the fan-in); the values differ from it, since the
    draws come in another order. ``torch_device`` defaults to the
    generator's device."""
    from repro_torch.models import params as params_mod
    dev = generator.device if torch_device is None else \
        torch.device(torch_device)

    def make(path, d: ParamDef) -> torch.Tensor:
        dtype = torch.float32 if any(k in _NORMS for k in path) \
            else cfg.dtype
        if len(d.shape) < 3:
            return d.init(generator, tuple(d.shape), torch.float32,
                          dev).to(dtype)
        out = torch.empty(d.shape, dtype=dtype, device=dev)
        for i in range(d.shape[0]):
            out[i] = d.init(generator, tuple(d.shape[1:]), torch.float32, dev)
        return out
    return params_mod.from_leaves((path, make(path, d))
                                  for path, d in leaves(model_defs(cfg)))


def layer(params, i: int, key: str = "blocks"):
    """Layer ``i``'s slice of the stack ``key`` (views)."""
    return tree_map(lambda t: t[i], params[key])


def unstack(params, key: str = "blocks") -> List[dict]:
    """The stack ``key`` as one tree of views a layer, by one ``unbind``
    a leaf: in a backward pass the layers' gradients are stacked once,
    where slicing a layer at a time would give each layer's gradient a
    zero tensor of the whole stack."""
    parts = tree_map(lambda t: t.unbind(0), params[key])
    n = len(next(iter(leaves(parts)))[1])
    return [tree_map(lambda ts, i=i: ts[i], parts) for i in range(n)]


def default_positions(cfg: ArchConfig, batch: int, seq: int,
                      device: Optional[torch.device] = None) -> torch.Tensor:
    """Positions 0..seq-1 of every row: (batch, seq) int32, or for M-RoPE
    the same on each of its three streams, (3, batch, seq)."""
    pos = torch.arange(seq, dtype=torch.int32,
                       device=device)[None, :].expand(batch, seq)
    return pos[None].expand(3, batch, seq) if cfg.pos_embedding == "mrope" \
        else pos


def _stack(block, params, key: str, h: torch.Tensor, remat: bool, *args
           ) -> torch.Tensor:
    """h through the layers of the stack ``key``: ``block(p, h, *args)`` a
    layer, under ``torch.utils.checkpoint`` where ``remat``."""
    for p in unstack(params, key):
        h = checkpoint(block, p, h, *args, use_reentrant=False) if remat \
            else block(p, h, *args)
    return h


def encode(params, cfg: ArchConfig, enc_embeds: torch.Tensor,
           remat: bool = False) -> torch.Tensor:
    """The encoder-decoder's encoder (JAX's ``forward``, encdec branch):
    enc_embeds (B, F, D) plus the learned positions of its F frames, then
    the encoder layers (not causal; RoPE on positions 0..F-1 as well, as
    JAX applies it) and the final norm -> (B, F, D) in ``cfg.dtype``."""
    n = enc_embeds.shape[1]
    enc = enc_embeds.to(cfg.dtype) + \
        params["enc_pos"][None, :n].to(cfg.dtype)
    enc_cfg = encoder_config(cfg)
    enc = _stack(_attn_block_apply, params, "enc_blocks", enc, remat,
                 enc_cfg, default_positions(cfg, enc.shape[0], n,
                                            enc.device), False, False)
    return layers.norm_apply(params["enc_final_norm"], enc, cfg.norm)


def forward(params, cfg: ArchConfig, tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            enc_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence logits (prefill, training): tokens (B, S) int, or
    embeds (B, S, D) -> (B, S, vocab) f32. ``positions``: (B, S), or
    (3, B, S) for M-RoPE (default: 0..S-1 on every stream). The
    encoder-decoder family takes ``enc_embeds`` (B, F, D), F <= enc_seq.

    Where autograd records (grad enabled and a parameter or an input
    requiring grad) and ``cfg.remat`` is ``"full"``, each layer runs under
    ``torch.utils.checkpoint`` (non-reentrant): its activations are
    recomputed in the backward pass, attention kernel included, as JAX's
    ``scan_stack`` runs the layer under ``jax.checkpoint``. Serving (no
    gradient wanted) runs the layers as they are."""
    require_ported(cfg)
    if cfg.remat not in ("full", "none"):
        raise ValueError(f"remat {cfg.remat!r}: 'full' or 'none'")
    if (enc_embeds is None) != (cfg.family not in ENCDEC):
        raise ValueError(f"{cfg.name}: enc_embeds is the input of the "
                         f"encoder-decoder family, and only of it")
    h = layers.embed_apply(params["embed"], tokens, cfg) if embeds is None \
        else embeds.to(cfg.dtype)
    b, s = h.shape[0], h.shape[1]
    if positions is None:
        positions = default_positions(cfg, b, s, device=h.device)
    inputs = (h, enc_embeds) if enc_embeds is not None else (h,)
    remat = cfg.remat == "full" and torch.is_grad_enabled() and (
        any(t.requires_grad for t in inputs)
        or any(t.requires_grad for _, t in leaves(params)))
    if cfg.family in ENCDEC:
        enc = encode(params, cfg, enc_embeds, remat)
        h = _stack(_dec_block_apply, params, "blocks", h, remat, cfg,
                   positions, enc)
    else:
        for key, moe in stacks(cfg):
            h = _stack(_attn_block_apply, params, key, h, remat, cfg,
                       positions, moe)
    h = layers.norm_apply(params["final_norm"], h, cfg.norm)
    return layers.unembed_apply(params["embed"], h, cfg)


def loss_fn(params, cfg: ArchConfig, batch) -> torch.Tensor:
    """Next-token cross entropy (``repro/models/lm.py::loss_fn``).

    batch: {"tokens" (B, S) int or "embeds" (B, S, D), "labels" (B, S)
    int, optionally "mask" (B, S); "enc_embeds" (B, F, D) for the
    encoder-decoder family}: the mean over the mask (all ones by default;
    divided by max(sum, 1)) of logsumexp(logits) - the label's logit, in
    f32, at the default positions (M-RoPE: the same on its three
    streams), as JAX's. The weights are cast to ``cfg.dtype`` at each use
    (``layers.cast``), so gradients reach the f32 parameters; pass them
    as they are stored, not through :func:`cast_params`. The dense, vlm,
    encoder-decoder and moe families (full attention and MLA) train
    alike: the MoE layers' gradients are those of their dispatch
    (``layers.moe_apply``), with no load-balancing loss, as in the JAX
    package.
    """
    require_ported(cfg)
    if batch.get("enc_embeds") is not None and cfg.family not in ENCDEC:
        raise NotImplementedError(f"{cfg.name}: encoder inputs belong to "
                                  f"the encoder-decoder family")
    logits = forward(params, cfg, tokens=batch.get("tokens"),
                     embeds=batch.get("embeds"),
                     enc_embeds=batch.get("enc_embeds")).float()
    labels = batch["labels"].long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    mask = batch.get("mask")
    mask = torch.ones_like(lse) if mask is None else mask.float()
    nll = (lse - gold) * mask
    return nll.sum() / torch.clamp_min(mask.sum(), 1.0)
