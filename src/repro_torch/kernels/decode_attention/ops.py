"""Wrapper of the decode attention kernel (``csrc/decode_attention.cu``).

A CPU tensor goes to the plain version (``ref.py``); a CUDA tensor
launches the kernel (a split-S pass and its combine, one launch of the C
entry point), or the call raises. ``launches`` counts those launches.

The kernel reads q and the caches through their strides (only the head dim
must be contiguous), so callers pass (B, KV, S, hd) ``transpose`` views of
their (B, S, KV, hd) caches: nothing is copied. ``cache_pos`` stays on the
card; the kernel reads it there, with no host sync. The caches arrive in
shared memory by 16-byte asynchronous copies, so their base addresses and
byte strides must be multiples of 16, and a (request, kv head)'s S
positions must span fewer than 2^31 elements (32-bit offsets): the
wrapper checks and raises, it never copies.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _launch
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

launches = 0

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
# Query heads a block serves (kHeads in csrc/decode_attention.cu): a kv
# head's G query heads take ceil(G / 8) blocks per cache chunk.
HEADS_PER_BLOCK = 8


def decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, cache_pos: torch.Tensor
                     ) -> torch.Tensor:
    """q: (B, H, hd); cache_k/v: (B, KV, S, hd); cache_pos: (B,) int32.

    Returns (B, H, hd): each request attends positions [0, cache_pos) of
    its cache (a position past S counts as S).
    """
    global launches
    if _launch.dispatch_device("decode_attention", q) == "cpu":
        return decode_attention_ref(q, cache_k, cache_v, cache_pos)
    b, h, hd = q.shape
    kv, s = cache_k.shape[1], cache_k.shape[2]
    dev = q.device
    _launch.check_cuda("decode_attention", "q", q, q.dtype, (b, h, hd), dev,
                       strided=True)
    for name, t in (("cache_k", cache_k), ("cache_v", cache_v)):
        _launch.check_cuda("decode_attention", name, t, q.dtype,
                           (b, kv, s, hd), dev, strided=True)
        if t.data_ptr() % 16 or any(st * t.element_size() % 16
                                    for st in t.stride()[:3]):
            raise ValueError(f"decode_attention: {name} (address "
                             f"{t.data_ptr():#x}, strides {t.stride()}) is "
                             f"not 16-byte aligned, as the kernel's "
                             f"16-byte copies need")
        if s * t.stride(2) >= 2 ** 31:
            raise ValueError(f"decode_attention: {name}'s positions span "
                             f"{s * t.stride(2)} elements, past the "
                             f"kernel's 32-bit offsets")
    _launch.check_cuda("decode_attention", "cache_pos", cache_pos,
                       torch.int32, (b,), dev)
    if q.dtype not in DTYPES:
        raise TypeError(f"decode_attention: dtype {q.dtype}, the kernel "
                        f"takes {DTYPES}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {hd}, the kernel "
                         f"takes {HEAD_DIMS}")
    if kv == 0 or h % kv:
        raise ValueError(f"decode_attention: {h} query heads over {kv} kv "
                         f"heads")
    blocks = b * kv * -(-(h // kv) // HEADS_PER_BLOCK)
    if blocks > 65535:
        raise ValueError(f"decode_attention: {blocks} (request, kv head, "
                         f"head group) blocks exceed the kernel's grid")
    lib = _build.load()
    n_chunks = -(-s // lib.moby_decode_attention_chunk())
    out = torch.empty((b, h, hd), dtype=q.dtype, device=dev)
    part_m = torch.empty((n_chunks, b * h), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((n_chunks, b * h, hd), dtype=torch.float32,
                           device=dev)
    strides = (ctypes.c_longlong * 8)(*q.stride()[:2], *cache_k.stride()[:3],
                                      *cache_v.stride()[:3])
    with torch.cuda.device(dev):
        code = lib.moby_decode_attention(
            q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
            cache_pos.data_ptr(), out.data_ptr(), part_m.data_ptr(),
            part_l.data_ptr(), part_acc.data_ptr(), strides, b, h, kv, s, hd,
            int(q.dtype == torch.bfloat16), hd ** -0.5,
            _launch.stream_handle(dev))
    _build.check(code, "decode_attention")
    launches += 1
    return out
