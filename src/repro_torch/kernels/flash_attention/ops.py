"""Wrapper of the two flash attention kernels.

A CPU tensor goes to the plain version (``ref.py``); a CUDA tensor
launches one of two kernels, chosen by ``route`` before any launch, or the
call raises:

* ``"tc"``: bf16 at head dim 128 (every full-width dense config), at
  head dim 64 (zamba2's and whisper's attention) and at qk dim 192 /
  value dim 128 (deepseek-v2's MLA prefill) runs
  ``csrc/flash_attention_tc.cu`` on the tensor cores in bf16 (wgmma fed by
  TMA); ``tc_launches`` counts its launches;
* ``"tf32x3"``: f32 (head dims 16-128, and MLA's (192, 128) and SMOKE's
  (24, 16)), and bf16 at head dims 16 and 32 and at SMOKE's (24, 16)
  (deepseek-v2's SMOKE config is bf16 by default), runs
  ``csrc/flash_attention.cu`` on the tensor cores too, f32-accurate by the
  3xTF32 split (mma.sync fed by cp.async); ``launches`` counts its
  launches. Its (192, 128) instance is persistent: a block an SM walks a
  run of query tiles (``block_items``). bf16 at 16 and 32 stays there:
  only the SMOKE configs have those widths, and their rows of 64 and 32
  bytes would need another swizzle than the 128-byte one the tensor-core
  kernels' TMA boxes and wgmma descriptors are built on.

| dtype | (qk, value) head dims | route, forward and gradient |
| --- | --- | --- |
| bf16 | (64, 64), (128, 128), (192, 128) | ``tc`` |
| bf16 | (16, 16), (32, 32), (24, 16) | ``tf32x3`` |
| f32 | (16, 16) .. (128, 128), (192, 128), (24, 16) | ``tf32x3`` |

The value head dim vd may differ from the qk head dim hd only at MLA's
pairs (``MLA_DIMS``); the scores are scaled by hd^-0.5 either way. The
kernels read q, k and v through their strides (only the head dim must
be contiguous), so callers pass ``transpose`` views of their
(B, S, heads, dim) activations. On the card the output is a (B, H, SQ, vd)
view of (B, SQ, H, vd) storage, the layout the model continues in. Both
kernels copy their operands by 16-byte units (TMA, cp.async), which need
16-byte aligned base addresses and strides: the wrapper checks both and
raises, it never copies.

The gradient (``flash_attention_bwd``) has two kernels too, picked by
the same ``route``: ``"tc"`` runs ``csrc/flash_attention_bwd_tc.cu``
(bf16 products on the tensor cores, wgmma fed by TMA, P and dS rounded to
bf16 as operands of their products; ``bwd_tc_launches``), ``"tf32x3"``
runs ``csrc/flash_attention_bwd.cu`` (f32-accurate on the tensor cores by
the 3xTF32 split, mma.sync fed by cp.async, as the forward;
``bwd_launches``). A CPU tensor goes to ``ref.flash_attention_bwd_ref``.
:class:`FlashAttention` ties the two directions into one differentiable
op, at every pair of head dims the forward takes (MLA's too: dq and dk at
the qk head dim, dv at the value head dim).
"""
from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from repro_torch.kernels import _build, _launch
from repro_torch.kernels.flash_attention import ref as _ref

launches = 0         # the 3xTF32 kernel
tc_launches = 0      # the tensor-core kernel
bwd_launches = 0     # the 3xTF32 gradient kernel (the "tf32x3" route's)
bwd_tc_launches = 0  # the tensor-core gradient kernel (the "tc" route's)

# Head dims with the value head dim equal to the qk one.
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
# (qk, value) head dims of MLA: deepseek-v2 at full width and at SMOKE.
MLA_DIMS = ((192, 128), (24, 16))
# (qk, value) head dims of the bf16 tensor-core route.
TC_DIMS = ((64, 64), (128, 128), (192, 128))
# The tensor-core gradient keeps its rows' statistics for SQ rounded up to
# a multiple of this (its query tile).
TC_BWD_ROWS = 128


def route(dtype: torch.dtype, head_dim: int, value_dim=None) -> str:
    """Which kernel takes a CUDA call at qk head dim ``head_dim`` and value
    head dim ``value_dim`` (``head_dim`` when None): ``"tc"`` (bf16 at a
    pair of ``TC_DIMS``), ``"tf32x3"`` (f32 at ``HEAD_DIMS`` with equal
    dims or at ``MLA_DIMS``; bf16 at the other ``HEAD_DIMS``, 16 and 32,
    and at SMOKE's ``MLA_DIMS[1]``); anything else raises, naming what the
    kernels take."""
    vd = head_dim if value_dim is None else value_dim
    if dtype not in DTYPES:
        raise TypeError(f"flash_attention: dtype {dtype}, the kernels take "
                        f"{DTYPES}")
    dims = (head_dim, vd)
    if dtype == torch.bfloat16 and dims in TC_DIMS:
        return "tc"
    equal = vd == head_dim and head_dim in HEAD_DIMS
    if (dtype == torch.float32 and (equal or dims in MLA_DIMS)) or \
            (dtype == torch.bfloat16 and (equal or dims == MLA_DIMS[1])):
        return "tf32x3"
    raise ValueError(
        f"flash_attention: head dims (qk {head_dim}, value {vd}) in "
        f"{dtype}; the kernels take equal head dims {HEAD_DIMS} (bf16 "
        f"at 64 and 128 on the tensor-core route) and (qk, value) "
        f"{MLA_DIMS[0]} and {MLA_DIMS[1]}, in f32 and bf16")


# The tf32x3 kernel's persistent instance, MLA's f32 (192, 128): keys a
# tile, and query rows a warp stacks (16) times the warps of its blocks.
PERSISTENT_TILE = 32


def item_tiles(j: int, n_q: int, rows: int, sk: int, causal: bool,
               tile: int = PERSISTENT_TILE) -> int:
    """Key tiles the j-th item of a (b, kv head, head chunk) pair walks in
    the tf32x3 kernel: query tile n_q - 1 - j when causal (the heaviest
    first), j otherwise, over keys up to its last row (causal) or sk; at
    least 1 (an item of no key walks one tile of masked keys)."""
    qt = n_q - 1 - j if causal else j
    k_end = min(sk, (qt + 1) * rows) if causal else sk
    return max(-(-k_end // tile), 1)


def block_items(n_pairs: int, n_q: int, rows: int, sk: int, causal: bool,
                n_blocks: int, tile: int = PERSISTENT_TILE
                ) -> List[Tuple[int, int, int]]:
    """The persistent instance's schedule (``block_items`` in
    ``csrc/flash_attention.cu``): every pair's items in order, their key
    tiles laid end to end and cut into ``n_blocks`` runs of equal work;
    block c takes the items that start in run c, as (first pair, first
    item, items)."""
    per_pair = sum(item_tiles(j, n_q, rows, sk, causal, tile)
                   for j in range(n_q))
    total, out = per_pair * n_pairs, []
    for c in range(n_blocks):
        lo, hi = total * c // n_blocks, total * (c + 1) // n_blocks
        p0, j0 = lo // per_pair, 0
        s = p0 * per_pair
        while s < lo:
            s += item_tiles(j0, n_q, rows, sk, causal, tile)
            j0 += 1
            if j0 == n_q:
                p0, j0 = p0 + 1, 0
        items, j = 0, j0
        while s < hi:
            s += item_tiles(j, n_q, rows, sk, causal, tile)
            items, j = items + 1, (j + 1) % n_q
        out.append((p0, j0, items))
    return out


def _check_aligned(name: str, t: torch.Tensor, path: str) -> None:
    """The kernels copy ``t`` by 16-byte units (TMA, cp.async, 16-byte
    loads): 16-byte aligned base address and byte strides."""
    if t.data_ptr() % 16 or any(s * t.element_size() % 16
                                for s in t.stride()[:3]):
        raise ValueError(f"flash_attention: {name} (address {t.data_ptr():#x},"
                         f" strides {t.stride()}) is not 16-byte aligned, as "
                         f"the {path} kernel's 16-byte loads need")


def _check_heads(b: int, h: int, kv: int) -> None:
    if kv == 0 or h % kv:
        raise ValueError(f"flash_attention: {h} query heads over {kv} kv "
                         f"heads")
    if b * h > 65535:
        raise ValueError(f"flash_attention: {b * h} (batch, head) pairs "
                         f"exceed the kernel's grid")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, H, SQ, hd); k: (B, KV, SK, hd); v: (B, KV, SK, vd) ->
    (B, H, SQ, vd).

    Keys above the diagonal are masked when ``causal`` (query i sees keys
    [0, i]); H must be a multiple of KV.
    """
    global launches, tc_launches
    if _launch.dispatch_device("flash_attention", q) == "cpu":
        return _ref.flash_attention_ref(q, k, v, causal)
    b, h, sq, hd = q.shape
    kv, sk, vd = k.shape[1], k.shape[2], v.shape[-1]
    for name, t, shape in (("q", q, (b, h, sq, hd)), ("k", k, (b, kv, sk, hd)),
                           ("v", v, (b, kv, sk, vd))):
        _launch.check_cuda("flash_attention", name, t, q.dtype, shape,
                           q.device, strided=True)
    path = route(q.dtype, hd, vd)
    _check_heads(b, h, kv)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_aligned(name, t, path)
        if path == "tc":
            _check_tma("flash_attention", name, t)
    out = torch.empty((b, sq, h, vd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    lib = _build.load()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    stream = _launch.stream_handle(q.device)
    with torch.cuda.device(q.device):
        if path == "tc":
            code = lib.moby_flash_attention_tc(
                *ptrs, strides, b, h, kv, sq, sk, hd, int(causal),
                hd ** -0.5, stream)
        else:
            code = lib.moby_flash_attention(
                *ptrs, strides, b, h, kv, sq, sk, hd, vd, int(causal),
                int(q.dtype == torch.bfloat16), hd ** -0.5, stream)
    _build.check(code, f"flash_attention ({path})")
    if path == "tc":
        tc_launches += 1
    else:
        launches += 1
    return out


def _check_tma(kernel: str, name: str, t: torch.Tensor) -> None:
    """TMA's own limits on a tensor map over ``t`` (the tensor-core
    kernels' operands, at every head dim of ``TC_DIMS``): byte strides
    below 2^40, sizes below 2^32."""
    if any(s * t.element_size() >= 2 ** 40 for s in t.stride()[:3]) or \
            any(n >= 2 ** 32 for n in t.shape):
        raise ValueError(f"{kernel}: {name} (shape "
                         f"{tuple(t.shape)}, strides {t.stride()}) is beyond "
                         f"what a TMA tensor map describes (byte strides "
                         f"< 2^40, sizes < 2^32)")


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor,
                        causal: bool = True):
    """The gradient of :func:`flash_attention`: (dq, dk, dv) for the output
    cotangent ``do`` (B, H, SQ, vd), given the forward's output ``o``
    (B, H, SQ, vd).

    On the card one call of the kernel that ``route`` picks (each
    recomputes its rows' statistics, which the forward does not save):
    ``csrc/flash_attention_bwd_tc.cu`` for bf16 at (qk, value) head dims
    (64, 64), (128, 128) and (192, 128), ``csrc/flash_attention_bwd.cu``
    for every other dtype and pair of head dims the forward takes. At
    (192, 128) the tensor-core route's two kernels are persistent: a CTA
    an SM walks its (b*h, tile) items, heaviest first; the f32 route's dq
    kernel there runs 8 warps a block, each skipping the key tiles past
    its last row. Both
    sum the G = H / KV query heads' f32 partials of dK and dV in a pass of
    their own; at G = 1 both write them directly, equal bit for bit (no
    partials are allocated). All five inputs are read
    through their strides (the head dim contiguous, 16-byte aligned); dq
    is a (B, H, SQ, hd) view of (B, SQ, H, hd) storage, dk a (B, KV, SK,
    hd) view of (B, SK, KV, hd) storage and dv a (B, KV, SK, vd) view of
    (B, SK, KV, vd) storage, the layouts the model's projections continue
    in. The scores' scale is hd^-0.5, hd the qk head dim, as the forward's.
    """
    global bwd_launches, bwd_tc_launches
    if _launch.dispatch_device("flash_attention_bwd", q) == "cpu":
        return _ref.flash_attention_bwd_ref(q, k, v, o, do, causal)
    b, h, sq, hd = q.shape
    kv, sk, vd = k.shape[1], k.shape[2], v.shape[-1]
    for name, t, shape in (("q", q, (b, h, sq, hd)), ("k", k, (b, kv, sk, hd)),
                           ("v", v, (b, kv, sk, vd)), ("o", o, (b, h, sq, vd)),
                           ("do", do, (b, h, sq, vd))):
        _launch.check_cuda("flash_attention_bwd", name, t, q.dtype, shape,
                           q.device, strided=True)
    path = route(q.dtype, hd, vd)
    _check_heads(b, h, kv)
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        _check_aligned(name, t, f"{path} backward")
        if path == "tc":
            _check_tma("flash_attention_bwd", name, t)
    dev, dt = q.device, q.dtype
    dq = torch.empty((b, sq, h, hd), dtype=dt, device=dev).transpose(1, 2)
    dk = torch.empty((b, sk, kv, hd), dtype=dt, device=dev).transpose(1, 2)
    dv = torch.empty((b, sk, kv, vd), dtype=dt, device=dev).transpose(1, 2)
    # The f32 partials of dK (B*H, SK, hd) and then dV (B*H, SK, vd) a
    # query head, summed over each kv head's G query heads; none at G = 1.
    part = torch.empty((b * h * sk * (hd + vd) if h > kv else 0,),
                       dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 24)(
        *(s for t in (q, k, v, o, do, dq, dk, dv) for s in t.stride()[:3]))
    ptrs = tuple(t.data_ptr() for t in (q, k, v, o, do, dq, dk, dv))
    lib = _build.load()
    with torch.cuda.device(dev):
        if path == "tc":
            rows = -(-sq // TC_BWD_ROWS) * TC_BWD_ROWS
            stats = torch.empty((2, b * h, rows), dtype=torch.float32,
                                device=dev)
            code = lib.moby_flash_attention_bwd_tc(
                *ptrs, stats.data_ptr(), part.data_ptr(), strides, b, h, kv,
                sq, sk, hd, vd, rows, int(causal), hd ** -0.5,
                _launch.stream_handle(dev))
        else:
            stats = torch.empty((3, b * h, sq), dtype=torch.float32,
                                device=dev)
            code = lib.moby_flash_attention_bwd(
                *ptrs, stats.data_ptr(), part.data_ptr(), strides, b, h, kv,
                sq, sk, hd, vd, int(causal), int(dt == torch.bfloat16),
                hd ** -0.5, _launch.stream_handle(dev))
    _build.check(code, f"flash_attention_bwd ({path})")
    if path == "tc":
        bwd_tc_launches += 1
    else:
        bwd_launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """:func:`flash_attention` whose backward is
    :func:`flash_attention_bwd`: the kernel on a CUDA tensor, the plain
    gradient on a CPU tensor (never autograd of the plain forward). Saves
    q, k, v and the output only where an input needs a gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        out = flash_attention(q, k, v, causal)
        ctx.causal = causal
        if any(ctx.needs_input_grad[:3]):
            ctx.save_for_backward(q, k, v, out)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, do, ctx.causal)
        return dq, dk, dv, None
