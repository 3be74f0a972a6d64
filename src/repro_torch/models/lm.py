"""Model assembly for the dense family (``repro/models/lm.py``).

The parameter tree is the JAX package's: ``{"embed", "final_norm",
"blocks"}`` with every leaf of ``blocks`` stacked on a leading layer axis.
``forward`` walks the layers in a Python loop over views of that axis
(JAX's ``lax.scan``). It is the prefill entry point and, under
``loss_fn``, the training forward; the serving step is
``repro_torch.models.decode.decode_step``. The moe, ssm, hybrid, encdec and
vlm families are later slices and raise.
"""
from __future__ import annotations

from typing import List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers
from repro_torch.models.config import ArchConfig
from repro_torch.models.params import ParamDef, leaves, tree_map

# Parameter groups kept f32 by cast_params: norm_apply multiplies in f32.
_NORMS = ("ln1", "ln2", "final_norm")


def require_dense(cfg: ArchConfig) -> None:
    if cfg.family != "dense" or cfg.attn_kind != "full":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} (attention {cfg.attn_kind!r})"
            f" is not ported yet; the port runs the dense family "
            f"(see ROADMAP.md)")


def stack_defs(defs, n: int):
    """Prepend a ``layers`` axis of size n to every ParamDef in the tree."""
    return tree_map(lambda d: ParamDef((n,) + d.shape,
                                       ("layers",) + d.logical_axes,
                                       d.dtype, d.init), defs)


def _attn_block_defs(cfg: ArchConfig):
    return {"ln1": layers.norm_defs(cfg.d_model, cfg.norm),
            "ln2": layers.norm_defs(cfg.d_model, cfg.norm),
            "attn": layers.attn_defs(cfg),
            "mlp": layers.mlp_defs(cfg)}


def _attn_block_apply(p, h: torch.Tensor, cfg: ArchConfig,
                      positions: torch.Tensor, causal: bool = True
                      ) -> torch.Tensor:
    x = layers.norm_apply(p["ln1"], h, cfg.norm)
    h = h + layers.attn_apply(p["attn"], x, cfg, positions, causal)
    x = layers.norm_apply(p["ln2"], h, cfg.norm)
    return h + layers.mlp_apply(p["mlp"], x, cfg)


def model_defs(cfg: ArchConfig):
    require_dense(cfg)
    return {"embed": layers.embed_defs(cfg),
            "final_norm": layers.norm_defs(cfg.d_model, cfg.norm),
            "blocks": stack_defs(_attn_block_defs(cfg), cfg.n_layers)}


def cast_params(params, cfg: ArchConfig):
    """The tree with every matrix and bias cast to ``cfg.dtype`` once, the
    norm parameters left f32: the values the layers would cast at each use
    (JAX stores f32 and casts at use), without re-reading f32 weights on
    every call. Serving in bf16 reads half the bytes per step."""
    def walk(tree, keep_f32: bool):
        if isinstance(tree, dict):
            return {k: walk(v, keep_f32 or k in _NORMS)
                    for k, v in tree.items()}
        return tree if keep_f32 else tree.to(cfg.dtype)
    return walk(params, False)


def layer(params, i: int):
    """Layer ``i``'s slice of the stacked ``blocks`` tree (views)."""
    return tree_map(lambda t: t[i], params["blocks"])


def unstack(params) -> List[dict]:
    """The stacked ``blocks`` tree as one tree of views a layer, by one
    ``unbind`` a leaf: in a backward pass the layers' gradients are
    stacked once, where slicing a layer at a time would give each layer's
    gradient a zero tensor of the whole stack."""
    parts = tree_map(lambda t: t.unbind(0), params["blocks"])
    n = len(next(iter(leaves(parts)))[1])
    return [tree_map(lambda ts, i=i: ts[i], parts) for i in range(n)]


def default_positions(batch: int, seq: int,
                      device: Optional[torch.device] = None) -> torch.Tensor:
    """Positions 0..seq-1 of every row, (batch, seq) int32."""
    return torch.arange(seq, dtype=torch.int32,
                        device=device)[None, :].expand(batch, seq)


def forward(params, cfg: ArchConfig, tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence logits (prefill, training): tokens (B, S) int, or
    embeds (B, S, D) -> (B, S, vocab) f32.

    Where autograd records (grad enabled and a parameter or ``embeds``
    requiring grad) and ``cfg.remat`` is ``"full"``, each layer runs under
    ``torch.utils.checkpoint`` (non-reentrant): its activations are
    recomputed in the backward pass, attention kernel included, as JAX's
    ``scan_stack`` runs the layer under ``jax.checkpoint``. Serving (no
    gradient wanted) runs the layers as they are."""
    require_dense(cfg)
    if cfg.remat not in ("full", "none"):
        raise ValueError(f"remat {cfg.remat!r}: 'full' or 'none'")
    h = layers.embed_apply(params["embed"], tokens, cfg) if embeds is None \
        else embeds.to(cfg.dtype)
    b, s = h.shape[0], h.shape[1]
    if positions is None:
        positions = default_positions(b, s, device=h.device)
    remat = cfg.remat == "full" and torch.is_grad_enabled() and (
        h.requires_grad or any(t.requires_grad for _, t in leaves(params)))
    for p in unstack(params):
        if remat:
            h = checkpoint(_attn_block_apply, p, h, cfg, positions,
                           use_reentrant=False)
        else:
            h = _attn_block_apply(p, h, cfg, positions)
    h = layers.norm_apply(params["final_norm"], h, cfg.norm)
    return layers.unembed_apply(params["embed"], h, cfg)


def loss_fn(params, cfg: ArchConfig, batch) -> torch.Tensor:
    """Next-token cross entropy (``repro/models/lm.py::loss_fn``).

    batch: {"tokens" (B, S) int or "embeds" (B, S, D), "labels" (B, S)
    int, optionally "mask" (B, S)}: the mean over the mask (all ones by
    default; divided by max(sum, 1)) of logsumexp(logits) - the label's
    logit, in f32. The weights are cast to ``cfg.dtype`` at each use
    (``layers.cast``), so gradients reach the f32 parameters; pass them
    as they are stored, not through :func:`cast_params`.
    """
    require_dense(cfg)
    if batch.get("enc_embeds") is not None:
        raise NotImplementedError(f"{cfg.name}: encoder inputs belong to "
                                  f"the encdec family, not ported yet")
    logits = forward(params, cfg, tokens=batch.get("tokens"),
                     embeds=batch.get("embeds")).float()
    labels = batch["labels"].long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    mask = batch.get("mask")
    mask = torch.ones_like(lse) if mask is None else mask.float()
    nll = (lse - gold) * mask
    return nll.sum() / torch.clamp_min(mask.sum(), 1.0)

