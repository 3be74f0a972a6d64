"""Wrapper of the decode attention kernel (``csrc/decode_attention.cu``).

A CPU tensor goes to the plain version (``ref.py``); a CUDA tensor
launches the kernel (a split-S pass and, where a row has more than one
work unit, its combine: one launch of a C entry point), or the call
raises. ``launches`` counts those launches, ``layout_launches`` the same
by layout. ``layout`` picks the layout from the dtype, head dim and head
group before the launch: ``g1`` (bf16 at G = 1, ``G1_HEAD_DIMS``: a
block of 4 warps a work unit of ``g1_plan``'s span, each warp streaming
its own tiles) or ``grouped`` (every other instance: a block a 512-position
chunk and up to 8 query heads of a kv head).

The kernel reads q and the caches through their strides (only the head dim
must be contiguous), so callers pass (B, KV, S, hd) ``transpose`` views of
their (B, S, KV, hd) caches: nothing is copied. ``cache_pos`` stays on the
card; the kernel reads it there, with no host sync. The caches arrive in
shared memory by 16-byte asynchronous copies, so their base addresses and
byte strides must be multiples of 16, and a (request, kv head)'s S
positions must span fewer than 2^31 elements (32-bit offsets): the
wrapper checks and raises, it never copies.

The gradient (``decode_attention_bwd``) is a second kernel,
``csrc/decode_attention_bwd.cu`` (``bwd_launches`` counts its launches):
a pass for the softmax statistics, the gradients a cache chunk, the dq
sum, the caches streamed as the forward streams them (16-byte copies: the
same alignment checks). A CPU tensor goes to
``ref.decode_attention_bwd_ref``.
:class:`DecodeAttention` ties the two directions into one differentiable
op (the int positions get no gradient).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, _launch
from repro_torch.kernels.decode_attention import ref as _ref

launches = 0
bwd_launches = 0
layout_launches = {"g1": 0, "grouped": 0}

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
# Query heads a block serves (kHeads in csrc/decode_attention.cu): a kv
# head's G query heads take ceil(G / 8) blocks per cache chunk.
HEADS_PER_BLOCK = 8

# The G = 1 layout (decode_g1_kernel), bf16 at these head dims.
G1_HEAD_DIMS = (16, 32, 64, 128)
# kG1Warps, kG1Stages and kTile of csrc/decode_attention.cu.
G1_WARPS, G1_STAGES, TILE = 4, 3, 32
# A unit's positions at most: long caches take more units than the card
# holds blocks, dealt as blocks free up (ragged lengths balance).
G1_MAX_SPAN = 4096
# Shared memory of an SM (228 KB on an H100) and what the card reserves a
# block (1 KB).
SM_SMEM, BLOCK_RESERVED = 233472, 1024


def layout(dtype: torch.dtype, hd: int, group: int) -> str:
    """The kernel's layout for an instance, from its shapes alone:
    ``g1`` for bf16 at G = 1 and a head dim of ``G1_HEAD_DIMS``, else
    ``grouped``."""
    if dtype == torch.bfloat16 and group == 1 and hd in G1_HEAD_DIMS:
        return "g1"
    return "grouped"


def g1_smem(hd: int) -> int:
    """Shared memory of a G = 1 block: each warp a ring of G1_STAGES
    tiles of K rows (padded by 16 bytes) and V rows, bf16."""
    return G1_WARPS * G1_STAGES * TILE * (4 * hd + 16)


def g1_plan(s: int, rows: int, hd: int, sms: int):
    """(span, n_units): the positions a work unit of the G = 1 layout
    takes and the units a (b, head) row has, from S and the rows (B*H)
    alone. As many units a row as the card's blocks fill once (``sms``
    SMs, the blocks an SM by shared memory), at least one and at most one
    a warp's tile; a unit at most ``G1_MAX_SPAN`` positions. Unit u of a
    row takes positions [u * span, (u + 1) * span)."""
    per_sm = SM_SMEM // (g1_smem(hd) + BLOCK_RESERVED)
    per_row = max(1, min(sms * per_sm // max(rows, 1),
                         -(-s // (G1_WARPS * TILE))))
    span = min(max(1, -(-s // per_row)), G1_MAX_SPAN)
    return span, max(1, -(-s // span))


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_heads(kernel: str, dtype: torch.dtype, hd: int, h: int,
                 kv: int) -> None:
    if dtype not in DTYPES:
        raise TypeError(f"{kernel}: dtype {dtype}, the kernel takes "
                        f"{DTYPES}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{kernel}: head dim {hd}, the kernel takes "
                         f"{HEAD_DIMS}")
    if kv == 0 or h % kv:
        raise ValueError(f"{kernel}: {h} query heads over {kv} kv heads")


def _check_aligned(kernel: str, name: str, t: torch.Tensor) -> None:
    """The kernels copy a cache by 16-byte units: its base address and
    byte strides must be multiples of 16 (checked, never copied)."""
    if t.data_ptr() % 16 or any(st * t.element_size() % 16
                                for st in t.stride()[:3]):
        raise ValueError(f"{kernel}: {name} (address {t.data_ptr():#x}, "
                         f"strides {t.stride()}) is not 16-byte aligned, "
                         f"as the kernel's 16-byte copies need")


def decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, cache_pos: torch.Tensor
                     ) -> torch.Tensor:
    """q: (B, H, hd); cache_k/v: (B, KV, S, hd); cache_pos: (B,) int32.

    Returns (B, H, hd): each request attends positions [0, cache_pos) of
    its cache (a position past S counts as S).
    """
    global launches
    if _launch.dispatch_device("decode_attention", q) == "cpu":
        return _ref.decode_attention_ref(q, cache_k, cache_v, cache_pos)
    b, h, hd = q.shape
    kv, s = cache_k.shape[1], cache_k.shape[2]
    dev = q.device
    _launch.check_cuda("decode_attention", "q", q, q.dtype, (b, h, hd), dev,
                       strided=True)
    for name, t in (("cache_k", cache_k), ("cache_v", cache_v)):
        _launch.check_cuda("decode_attention", name, t, q.dtype,
                           (b, kv, s, hd), dev, strided=True)
        _check_aligned("decode_attention", name, t)
        if s * t.stride(2) >= 2 ** 31:
            raise ValueError(f"decode_attention: {name}'s positions span "
                             f"{s * t.stride(2)} elements, past the "
                             f"kernel's 32-bit offsets")
    _launch.check_cuda("decode_attention", "cache_pos", cache_pos,
                       torch.int32, (b,), dev)
    _check_heads("decode_attention", q.dtype, hd, h, kv)
    blocks = b * kv * -(-(h // kv) // HEADS_PER_BLOCK)
    if blocks > 65535:
        raise ValueError(f"decode_attention: {blocks} (request, kv head, "
                         f"head group) blocks exceed the kernel's grid")
    lib = _build.load()
    kind = layout(q.dtype, hd, h // kv)
    if kind == "g1":
        span, n_chunks = g1_plan(s, b * h, hd, _sm_count(dev.index))
        # One unit a row: the kernel writes the output itself.
        n_parts = n_chunks if n_chunks > 1 else 0
    else:
        n_chunks = n_parts = -(-s // lib.moby_decode_attention_chunk())
    out = torch.empty((b, h, hd), dtype=q.dtype, device=dev)
    part_m = torch.empty((n_parts, b * h), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((n_parts, b * h, hd), dtype=torch.float32,
                           device=dev)
    strides = (ctypes.c_longlong * 8)(*q.stride()[:2], *cache_k.stride()[:3],
                                      *cache_v.stride()[:3])
    ptrs = (q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
            cache_pos.data_ptr(), out.data_ptr(), part_m.data_ptr(),
            part_l.data_ptr(), part_acc.data_ptr(), strides)
    with torch.cuda.device(dev):
        if kind == "g1":
            code = lib.moby_decode_attention_g1(
                *ptrs, b, h, s, hd, span, n_chunks, hd ** -0.5,
                _launch.stream_handle(dev))
        else:
            code = lib.moby_decode_attention(
                *ptrs, b, h, kv, s, hd, int(q.dtype == torch.bfloat16),
                hd ** -0.5, _launch.stream_handle(dev))
    _build.check(code, "decode_attention")
    launches += 1
    layout_launches[kind] += 1
    return out


# The backward kernel's shared memory a block may use (227 KB on an H100).
MAX_SMEM = 232448


def decode_attention_bwd(q: torch.Tensor, cache_k: torch.Tensor,
                         cache_v: torch.Tensor, cache_pos: torch.Tensor,
                         o: torch.Tensor, do: torch.Tensor):
    """The gradient of :func:`decode_attention`: (dq (B, H, hd), dk, dv
    (B, KV, S, hd)) for the output cotangent ``do`` (B, H, hd), given the
    forward's output ``o``; dk and dv are 0 at positions >= cache_pos.

    On the card one launch of ``csrc/decode_attention_bwd.cu`` (a stats
    pass, the gradients a cache chunk, the dq sum). Every operand is read
    through its strides (the head dim contiguous); the caches by 16-byte
    copies, so their base addresses and byte strides must be multiples of
    16 (checked). dk and dv are (B, KV, S, hd) views of (B, S, KV, hd)
    storage, the caches' layout.
    """
    global bwd_launches
    if _launch.dispatch_device("decode_attention_bwd", q) == "cpu":
        return _ref.decode_attention_bwd_ref(q, cache_k, cache_v, cache_pos,
                                             o, do)
    b, h, hd = q.shape
    kv, s = cache_k.shape[1], cache_k.shape[2]
    dev, dt = q.device, q.dtype
    for name, t, shape in (("q", q, (b, h, hd)), ("o", o, (b, h, hd)),
                           ("do", do, (b, h, hd)),
                           ("cache_k", cache_k, (b, kv, s, hd)),
                           ("cache_v", cache_v, (b, kv, s, hd))):
        _launch.check_cuda("decode_attention_bwd", name, t, dt, shape, dev,
                           strided=True)
    _launch.check_cuda("decode_attention_bwd", "cache_pos", cache_pos,
                       torch.int32, (b,), dev)
    for name, t in (("cache_k", cache_k), ("cache_v", cache_v)):
        _check_aligned("decode_attention_bwd", name, t)
    _check_heads("decode_attention_bwd", dt, hd, h, kv)
    if b > 65535:
        raise ValueError(f"decode_attention_bwd: {b} requests exceed the "
                         f"kernel's grid")
    lib = _build.load()
    smem = lib.moby_decode_attention_bwd_smem(h // kv, hd,
                                              int(dt == torch.bfloat16))
    if smem > MAX_SMEM:
        raise ValueError(f"decode_attention_bwd: {h // kv} query heads a kv "
                         f"head at head dim {hd} need {smem} bytes of shared "
                         f"memory a block, over {MAX_SMEM}")
    n_chunks = -(-s // lib.moby_decode_attention_bwd_chunk())
    dq = torch.empty((b, h, hd), dtype=dt, device=dev)
    dk = torch.empty((b, s, kv, hd), dtype=dt, device=dev).transpose(1, 2)
    dv = torch.empty((b, s, kv, hd), dtype=dt, device=dev).transpose(1, 2)
    part_m = torch.empty((n_chunks, b * h), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_dq = torch.empty((n_chunks, b * h, hd), dtype=torch.float32,
                          device=dev)
    strides = (ctypes.c_longlong * 20)(
        *(st for t in (q, o, do, dq) for st in t.stride()[:2]),
        *(st for t in (cache_k, cache_v, dk, dv) for st in t.stride()[:3]))
    with torch.cuda.device(dev):
        code = lib.moby_decode_attention_bwd(
            q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
            cache_pos.data_ptr(), o.data_ptr(), do.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), part_m.data_ptr(),
            part_l.data_ptr(), part_dq.data_ptr(), strides, b, h, kv, s, hd,
            int(dt == torch.bfloat16), hd ** -0.5,
            _launch.stream_handle(dev))
    _build.check(code, "decode_attention_bwd")
    bwd_launches += 1
    return dq, dk, dv


class DecodeAttention(torch.autograd.Function):
    """:func:`decode_attention` whose backward is
    :func:`decode_attention_bwd`: the kernel on a CUDA tensor, the plain
    gradient on a CPU tensor. ``cache_pos`` gets no gradient. Saves the
    operands and the output only where an input needs a gradient."""

    @staticmethod
    def forward(ctx, q, cache_k, cache_v, cache_pos):
        out = decode_attention(q, cache_k, cache_v, cache_pos)
        if any(ctx.needs_input_grad[:3]):
            ctx.save_for_backward(q, cache_k, cache_v, cache_pos, out)
        return out

    @staticmethod
    def backward(ctx, do):
        q, cache_k, cache_v, cache_pos, out = ctx.saved_tensors
        dq, dk, dv = decode_attention_bwd(q, cache_k, cache_v, cache_pos,
                                          out, do)
        return dq, dk, dv, None
