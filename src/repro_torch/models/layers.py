"""Shared layer library of the LM families: norms, RoPE and M-RoPE,
attention (GQA/MQA; self and cross), MLPs, the mixture of experts and the
embedding (``repro/models/layers.py``).

Conventions, as in the JAX package:

* Every layer is a pair ``<layer>_defs(cfg) -> ParamDef tree`` and
  ``<layer>_apply(params, ...) -> tensor``; parameters are nested dicts of
  tensors.
* Parameters are stored f32 and cast to ``cfg.dtype`` at use (a no-op for
  a tree already cast by :func:`repro_torch.models.lm.cast_params`; the
  norm parameters stay f32 either way). Where JAX asks for an f32 result
  of a product (``preferred_element_type``) and keeps it f32 (the MLP's
  input projections, the logits), the port computes it with an f32 result
  too (:func:`_dot_f32`), never rounding it to ``cfg.dtype`` first; where
  JAX casts that result back at once, the port's product in ``cfg.dtype``
  is the same value (an f32 sum rounded once).
* Attention always goes through :mod:`repro_torch.ops`: the card runs the
  flash and decode attention kernels, the CPU their plain versions. So the
  JAX package's dense and chunked reference paths have no counterpart
  here. A value head dim unequal to the qk head dim (MLA's prefill,
  ``models/mla.py``) goes to the same flash attention op, and so does
  cross attention (queries over an encoder's keys, not causal, Sq != Sk).
  Causal attention with Sq != Sk raises (no caller of the JAX package
  reaches it).
* The mixture of experts (:func:`moe_apply`) has no Pallas kernel in the
  JAX package: its router, dispatch and expert products are XLA ops
  there, and here PyTorch ops (the products cuBLAS GEMMs), with the same
  fixed shapes and no synchronising call.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import ops
from repro_torch.models.config import ArchConfig
from repro_torch.models.params import (ParamDef, fanin_init, normal_init,
                                       ones_init, zeros_init)


def cast(x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    return x.to(cfg.dtype)


def _matmul(x: torch.Tensor, w: torch.Tensor, n_in: int) -> torch.Tensor:
    """Contract the last ``n_in`` dims of x with the leading ``n_in`` dims
    of w (``einsum('bs<in>,<in><out>->bs<out>')``)."""
    lead, k = x.shape[:-n_in], w.shape[n_in:]
    y = x.reshape(*lead, -1) @ w.reshape(-1, *k).flatten(1)
    return y.reshape(*lead, *k)


def _hi_lo(dy: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An f32 cotangent as two parts of a 16-bit ``dtype``, stacked: hi (dy
    rounded) and lo (the rest, rounded), which hold dy to 2^-16 of it."""
    parts = torch.empty((2, *dy.shape), dtype=dtype, device=dy.device)
    parts[0] = dy
    parts[1] = dy - parts[0]
    return parts


def matmul_f32_out_grads(dy: torch.Tensor, x: torch.Tensor,
                         w: torch.Tensor, mm, need_x: bool = True,
                         need_w: bool = True):
    """The gradients of ``x @ w`` (x (..., K), w (K, N), both of one 16-bit
    dtype, an f32 result) for its f32 cotangent ``dy``, as ``jax.vjp`` of
    JAX's ``einsum(..., preferred_element_type=float32)`` computes them:
    the f32 cotangent times the 16-bit operand, summed in f32 and rounded
    once to the operand's dtype. ``mm(a, b)`` multiplies two 16-bit
    matrices with f32 sums and an f32 result. The cotangent enters it as
    two 16-bit parts, ``hi`` (dy rounded) and ``lo`` (the rest, rounded),
    which hold dy to 2^-16 of it, so the two products' sum is the f32
    product up to f32 summation. (Rounding dy once to 16 bits instead puts
    13% of a bf16 gradient's entries more than a bf16 ulp from JAX's.)"""
    d = dy.reshape(-1, dy.shape[-1])
    parts = _hi_lo(d, x.dtype)
    dx = dw = None
    if need_x:
        wt = w.t()
        dx = mm(parts[0], wt).add_(mm(parts[1], wt)).to(x.dtype) \
            .reshape(x.shape)
    if need_w:
        # One product over the two parts stacked along the tokens.
        x2 = x.reshape(-1, x.shape[-1]).repeat(2, 1)
        dw = mm(x2.t(), parts.reshape(-1, d.shape[-1])).to(x.dtype)
    return dx, dw


def _mm_f32_out(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mm(a, b, out_dtype=torch.float32)


class _MatmulF32Out(torch.autograd.Function):
    """``x @ w`` (x (..., K), w (K, N), both of one 16-bit dtype) as one
    GEMM that writes f32 (``torch.mm``'s ``out_dtype``, which has no
    autograd formula). Backward: :func:`matmul_f32_out_grads`, JAX's
    arithmetic, by two such GEMMs a gradient."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[1])

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        return matmul_f32_out_grads(dy, x, w, _mm_f32_out,
                                    *ctx.needs_input_grad)


def _dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a 2-d ``w`` with an f32 result, as JAX's
    ``einsum(..., preferred_element_type=float32)``: the products of the
    inputs as they are, summed in f32 and not rounded to the input type.
    On the card a bf16 GEMM writes f32 (:class:`_MatmulF32Out`);
    elsewhere the operands are widened, which gives the same exact
    products."""
    if x.is_cuda and x.dtype != torch.float32:
        return _MatmulF32Out.apply(x, w)
    return x.float() @ w.float()


def bmm_f32_out_grads(dy: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                      bmm, need_x: bool = True, need_w: bool = True):
    """The batched counterpart of :func:`matmul_f32_out_grads`: the
    gradients of ``x @ w`` (x (E, C, K), w (E, K, N), both of one 16-bit
    dtype, an f32 result) for its f32 cotangent ``dy`` (E, C, N), as
    ``jax.vjp`` of JAX's ``einsum('ecd,edf->ecf',
    preferred_element_type=float32)`` computes them: the cotangent enters
    ``bmm(a, b)`` (16-bit batched matrices, f32 sums and result) as its
    16-bit ``hi`` and ``lo`` parts, two products a gradient, each
    gradient rounded once to the operand's dtype."""
    parts = _hi_lo(dy, x.dtype)
    dx = dw = None
    if need_x:
        wt = w.transpose(1, 2)
        dx = bmm(parts[0], wt).add_(bmm(parts[1], wt)).to(x.dtype)
    if need_w:
        # One product over the two parts stacked along the rows.
        x2 = torch.cat([x, x], dim=1).transpose(1, 2)
        dw = bmm(x2, torch.cat([parts[0], parts[1]], dim=1)).to(x.dtype)
    return dx, dw


def _bmm_f32_out(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.bmm(a, b, out_dtype=torch.float32)


class _BmmF32Out(torch.autograd.Function):
    """``x @ w`` (x (E, C, K), w (E, K, N), both of one 16-bit dtype) as
    one batched GEMM that writes f32 (``torch.bmm``'s ``out_dtype``, which
    has no autograd formula). Backward: :func:`bmm_f32_out_grads`, JAX's
    arithmetic, by two such GEMMs a gradient."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _bmm_f32_out(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        return bmm_f32_out_grads(dy, x, w, _bmm_f32_out,
                                 *ctx.needs_input_grad)


def _bmm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The batched counterpart of :func:`_dot_f32`: x (E, C, K) @ w
    (E, K, N) -> (E, C, N) f32 (JAX's ``einsum('ecd,edf->ecf',
    preferred_element_type=float32)``). On the card a 16-bit batched GEMM
    writes f32 (:class:`_BmmF32Out`, differentiable in JAX's arithmetic);
    elsewhere the operands are widened, which gives the same exact
    products."""
    if x.is_cuda and x.dtype != torch.float32:
        return _BmmF32Out.apply(x, w)
    return torch.bmm(x.float(), w.float())


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def norm_defs(d: int, kind: str):
    if kind == "rmsnorm":
        return {"scale": ParamDef((d,), ("embed",), torch.float32,
                                  ones_init())}
    return {"scale": ParamDef((d,), ("embed",), torch.float32, ones_init()),
            "bias": ParamDef((d,), ("embed",), torch.float32, zeros_init())}


def norm_apply(p, x: torch.Tensor, kind: str, eps: float = 1e-6
               ) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        var = (xf * xf).mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * p["scale"]
    else:
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE / M-RoPE
# ---------------------------------------------------------------------------


def _rope_freqs(half: int, theta: float, device) -> torch.Tensor:
    """1/theta**(i/half), i < half, f32 (JAX's order of operations)."""
    i = torch.arange(half, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (i / half))


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, 2 r) rotated by the f32 angles ang (B, S, r), half-split
    convention, in f32 and rounded once to x's dtype."""
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    xf1, xf2 = x1.float(), x2.float()
    r1 = xf1 * cos - xf2 * sin
    r2 = xf2 * cos + xf1 * sin
    return torch.cat([r1.to(x.dtype), r2.to(x.dtype)], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               fraction: float = 1.0) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S). Rotates the leading
    ``fraction`` of head dims, half-split convention."""
    hd = x.shape[-1]
    rot = int(hd * fraction)
    rot -= rot % 2
    freqs = _rope_freqs(rot // 2, theta, positions.device)
    out = _rotate(x[..., :rot], positions[..., None].float() * freqs)
    return torch.cat([out, x[..., rot:]], dim=-1) if rot < hd else out


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: tuple) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE. x: (B, S, H, hd); positions3: (3, B, S)
    (t, h, w) ids. The hd/2 rotary frequencies are split into the static
    ``sections`` (summing to hd/2), in order; each band takes the angle of
    its own positional stream. The angles are f32 products, as JAX's."""
    half = x.shape[-1] // 2
    if sum(sections) != half or len(sections) != positions3.shape[0]:
        raise ValueError(f"M-RoPE sections {sections} for {half} "
                         f"frequencies and {positions3.shape[0]} streams")
    freqs = _rope_freqs(half, theta, positions3.device)
    bands, lo = [], 0
    for stream, n in enumerate(sections):
        bands.append(positions3[stream][..., None].float()
                     * freqs[lo:lo + n])
        lo += n
    return _rotate(x, torch.cat(bands, dim=-1))


def position_encode(q: torch.Tensor, k: torch.Tensor, cfg: ArchConfig,
                    positions: torch.Tensor):
    """Dispatch on cfg.pos_embedding for self-attention q/k: positions
    (B, S) for RoPE, (3, B, S) for M-RoPE."""
    if cfg.pos_embedding == "rope":
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    elif cfg.pos_embedding == "mrope":
        q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    return q, k


# ---------------------------------------------------------------------------
# Attention (GQA / MQA / MHA)
# ---------------------------------------------------------------------------


def attn_defs(cfg: ArchConfig):
    d = cfg.d_model
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    defs = {
        "wq": ParamDef((d, h, hd), ("embed", "heads", None),
                       init=fanin_init()),
        "wk": ParamDef((d, kv, hd), ("embed", "kv_heads", None),
                       init=fanin_init()),
        "wv": ParamDef((d, kv, hd), ("embed", "kv_heads", None),
                       init=fanin_init()),
        "wo": ParamDef((h, hd, d), ("heads", None, "embed"),
                       init=fanin_init()),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((h, hd), ("heads", None), init=zeros_init())
        defs["bk"] = ParamDef((kv, hd), ("kv_heads", None), init=zeros_init())
        defs["bv"] = ParamDef((kv, hd), ("kv_heads", None), init=zeros_init())
    return defs


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool) -> torch.Tensor:
    """q: (B, Sq, H, hd); k: (B, Sk, KV, hd); v: (B, Sk, KV, vd) ->
    (B, Sq, H, vd), through ``ops.flash_attention`` on (B, heads, S, dim)
    views (no copies). The value head dim may differ from the qk head dim
    (MLA)."""
    sq = q.shape[1]
    if causal and sq != k.shape[1]:
        raise NotImplementedError(
            f"causal attention with Sq={sq} != Sk={k.shape[1]} is not "
            f"ported yet")
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal)
    return out.transpose(1, 2)


def _qkv(p, x: torch.Tensor, cfg: ArchConfig, src: torch.Tensor):
    """Queries from x, keys and values from src (x itself, or an
    encoder's output for cross attention)."""
    q = _matmul(x, cast(p["wq"], cfg), 1)
    k = _matmul(src, cast(p["wk"], cfg), 1)
    v = _matmul(src, cast(p["wv"], cfg), 1)
    if cfg.qkv_bias:
        q = q + cast(p["bq"], cfg)
        k = k + cast(p["bk"], cfg)
        v = v + cast(p["bv"], cfg)
    return q, k, v


def attn_apply(p, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor,
               causal: bool = True, kv_x: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """Full-sequence attention (train / prefill / encoder / cross). With
    ``kv_x`` (B, Sk, D) the keys and values come from it (cross
    attention) and no position encoding is applied, as in JAX."""
    q, k, v = _qkv(p, x, cfg, x if kv_x is None else kv_x)
    if kv_x is None:
        q, k = position_encode(q, k, cfg, positions)
    out = multihead_attention(q, k, v, causal)
    return _matmul(out, cast(p["wo"], cfg), 2).to(cfg.dtype)


def attn_decode_apply(p, x: torch.Tensor, cfg: ArchConfig,
                      cache_k: torch.Tensor, cache_v: torch.Tensor,
                      cache_pos: torch.Tensor, positions: torch.Tensor):
    """Single-token decode with a KV cache.

    x: (B, 1, D); cache_k/v: (B, S_max, KV, hd); cache_pos: (B,) int32
    current lengths. Returns (out (B, 1, D), cache_k, cache_v).

    Unlike JAX's functional ``dynamic_update_slice``, the new K/V are
    written into ``cache_k``/``cache_v`` in place (``index_put_``), at each
    request's position clamped to S_max - 1 as ``dynamic_update_slice``
    clamps it; the returned caches are the same tensors. Attention then
    covers positions [0, cache_pos] through ``ops.decode_attention`` on
    (B, KV, S, hd) views of the caches.
    """
    b = x.shape[0]
    q, k, v = _qkv(p, x, cfg, x)
    if cfg.pos_embedding in ("rope", "mrope"):
        q, k = position_encode(q, k, cfg, positions)
    rows = torch.arange(b, device=x.device)
    at = cache_pos.long().clamp(max=cache_k.shape[1] - 1)
    cache_k[rows, at] = k[:, 0].to(cache_k.dtype)
    cache_v[rows, at] = v[:, 0].to(cache_v.dtype)
    att = ops.decode_attention(q[:, 0], cache_k.transpose(1, 2),
                               cache_v.transpose(1, 2), cache_pos + 1)
    out = att[:, None].to(cfg.dtype)
    return _matmul(out, cast(p["wo"], cfg), 2).to(cfg.dtype), cache_k, \
        cache_v


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp_defs(cfg: ArchConfig):
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_type == "swiglu":
        return {
            "wi_gate": ParamDef((d, f), ("embed", "mlp"), init=fanin_init()),
            "wi_up": ParamDef((d, f), ("embed", "mlp"), init=fanin_init()),
            "wo": ParamDef((f, d), ("mlp", "embed"), init=fanin_init()),
        }
    return {
        "wi": ParamDef((d, f), ("embed", "mlp"), init=fanin_init()),
        "wo": ParamDef((f, d), ("mlp", "embed"), init=fanin_init()),
    }


def mlp_apply(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if cfg.mlp_type == "swiglu":
        g = _dot_f32(x, cast(p["wi_gate"], cfg))
        u = _dot_f32(x, cast(p["wi_up"], cfg))
        h = (F.silu(g) * u).to(cfg.dtype)
    else:
        h = _dot_f32(x, cast(p["wi"], cfg))
        if cfg.mlp_type == "gelu":   # jax.nn.gelu's default: the tanh form
            h = F.gelu(h, approximate="tanh").to(cfg.dtype)
        else:                        # relu2 (nemotron/minitron)
            h = F.relu(h).square().to(cfg.dtype)
    return (h @ cast(p["wo"], cfg)).to(cfg.dtype)


# ---------------------------------------------------------------------------
# Mixture of Experts (token-choice top-k, capacity-dropped)
# ---------------------------------------------------------------------------


def moe_defs(cfg: ArchConfig):
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    defs = {
        "router": ParamDef((d, e), ("embed", None), init=normal_init(0.006)),
        "w_gate": ParamDef((e, d, f), ("expert", "embed", "expert_mlp"),
                           init=fanin_init()),
        "w_up": ParamDef((e, d, f), ("expert", "embed", "expert_mlp"),
                         init=fanin_init()),
        "w_down": ParamDef((e, f, d), ("expert", "expert_mlp", "embed"),
                           init=fanin_init()),
    }
    if cfg.n_shared_experts:
        fs = cfg.moe_d_ff * cfg.n_shared_experts
        defs["shared"] = {
            "wi_gate": ParamDef((d, fs), ("embed", "mlp"), init=fanin_init()),
            "wi_up": ParamDef((d, fs), ("embed", "mlp"), init=fanin_init()),
            "wo": ParamDef((fs, d), ("mlp", "embed"), init=fanin_init()),
        }
    return defs


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def moe_capacity(cfg: ArchConfig, n_tokens: int) -> int:
    """Rows an expert takes: T k cf / E, truncated, rounded up to 128, at
    least 128 (JAX's arithmetic: a Python float, then ``int``)."""
    raw = n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts
    return max(_round_up(int(raw), 128), 128)


def _top_k(probs: torch.Tensor, k: int):
    """``lax.top_k``'s order: descending, the lower expert index first
    among equal probabilities (a stable descending sort; ``torch.topk``
    does not promise an order among ties)."""
    w, i = torch.sort(probs, dim=-1, descending=True, stable=True)
    return w[:, :k], i[:, :k]


def moe_route(p, xt: torch.Tensor, cfg: ArchConfig):
    """The router of :func:`moe_apply` for tokens xt (T, D) in
    ``cfg.dtype``: f32 logits of the 16-bit operands, f32 softmax, top-k.
    Returns (probs (T, E) f32, weights (T, k) in ``cfg.dtype``, experts
    (T, k) int64)."""
    logits = _dot_f32(xt, cast(p["router"], cfg))
    probs = torch.softmax(logits, dim=-1)
    topw, topi = _top_k(probs, cfg.top_k)
    if cfg.router_scale:
        topw = topw / torch.clamp_min(topw.sum(-1, keepdim=True), 1e-9)
    return probs, topw.to(cfg.dtype), topi


def moe_apply(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Token-choice top-k MoE with per-slot sequential dispatch
    (``repro/models/layers.py::moe_apply``). x: (B, S, D) -> (B, S, D).

    Slot j = 0..k-1 in turn: each token's j-th expert ranks it after the
    tokens that chose that expert in earlier slots and earlier in this
    one (an int32 cumulative sum); a token of rank >= capacity is
    dropped, its row written to a discard row past the buffer (JAX's
    ``.at[slot].set(..., mode="drop")``). Every shape is fixed by the
    capacity, so nothing waits on the card's values: no ``nonzero``, no
    boolean-mask indexing, no ``.item()``. The expert products are
    batched GEMMs (``torch.bmm``: JAX computes them with ``einsum``
    outside any Pallas kernel, and no kernel of the port replaces one)
    with f32 results; SwiGLU in f32 and the down product are each
    rounded once to ``cfg.dtype``. The combine runs in ``cfg.dtype`` in
    slot order, one rounding a step, then adds the shared experts.
    """
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    cap = moe_capacity(cfg, t)
    xt = x.reshape(t, d)
    _, topw, topi = moe_route(p, xt, cfg)

    experts = torch.arange(e, device=x.device)[:, None]
    counts = torch.zeros((e, 1), dtype=torch.int32, device=x.device)
    buf = torch.zeros((e * cap + 1, d), dtype=cfg.dtype, device=x.device)
    slots = []
    for j in range(k):
        ej = topi[:, j]                                        # (T,)
        # The one-hot is JAX's (T, E) transposed, so the ranks are a scan
        # along the inner dim: along the outer dim of (T, E) the scan took
        # 1.4 ms a call at T = 8192 on an H100 (chip_smoke's MoE C
        # profile), half the prefill.
        onehot = (ej[None, :] == experts).to(torch.int32)      # (E, T)
        rank = torch.cumsum(onehot, 1, dtype=torch.int32) - onehot + counts
        my_rank = torch.gather(rank, 0, ej[None, :])[0]
        counts = counts + onehot.sum(1, keepdim=True, dtype=torch.int32)
        keep = my_rank < cap
        slot = torch.where(keep, ej * cap + my_rank, e * cap)  # drop: last
        buf.index_copy_(0, slot, xt)
        slots.append((slot, keep))

    xe = buf[:e * cap].view(e, cap, d)
    g = _bmm_f32(xe, cast(p["w_gate"], cfg))
    u = _bmm_f32(xe, cast(p["w_up"], cfg))
    h = (F.silu(g) * u).to(cfg.dtype)
    out_flat = _bmm_f32(h, cast(p["w_down"], cfg)).to(cfg.dtype).reshape(
        e * cap, d)

    y = torch.zeros((t, d), dtype=cfg.dtype, device=x.device)
    for j, (slot, keep) in enumerate(slots):
        gathered = out_flat.index_select(0, torch.where(keep, slot, 0))
        y = y + torch.where(keep[:, None], gathered, 0.0) * topw[:, j:j + 1]
    if cfg.n_shared_experts:
        y = y + mlp_apply(p["shared"], xt[None], cfg)[0]
    return y.reshape(b, s, d)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed_defs(cfg: ArchConfig):
    defs = {"table": ParamDef((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                              init=normal_init(0.02))}
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef((cfg.d_model, cfg.vocab),
                                   ("embed", "vocab"), init=normal_init(0.02))
    return defs


def embed_apply(p, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    return cast(p["table"][tokens.long()], cfg)


def unembed_apply(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Logits in f32, summed in f32 from ``cfg.dtype`` inputs (JAX's
    ``preferred_element_type``)."""
    w = cast(p["table"], cfg).T if cfg.tie_embeddings else \
        cast(p["unembed"], cfg)
    return _dot_f32(x, w)
