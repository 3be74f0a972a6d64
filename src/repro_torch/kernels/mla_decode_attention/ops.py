"""Wrapper of the MLA decode attention kernel
(``csrc/mla_decode_attention.cu``): a port-only op, the absorbed attention
of ``repro/models/mla.py::mla_decode_apply`` over the compressed cache.

A CPU tensor goes to the plain version (``ref.py``); a CUDA tensor
launches the kernel (a split pass over the cache and its combine, one
launch of the C entry point), or the call raises. ``launches`` counts
those launches. ``route`` names the instance: ``"tc"`` (bf16 at (R, P) =
(512, 64): 64 heads a block on the tensor cores) or ``"simt"`` (f32 at
both sizes, bf16 at SMOKE's (16, 8): 8 heads a block).

The kernel reads its operands through their strides (the last dim
contiguous) and ``lengths`` on the card, with no host sync. The
tensor-core instance copies by 16-byte units, so there every base address
and byte stride must be a multiple of 16: the wrapper checks and raises,
it never copies. The scratch of the split pass (its partial maxima, sums
and accumulators, f32) is allocated here, for ``n_split`` splits a
request: as many as make B x head blocks x n_split about four blocks an
SM.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, _launch
from repro_torch.kernels.mla_decode_attention import ref as _ref

launches = 0

DTYPES = (torch.float32, torch.bfloat16)
# (R, P): the latent (kv_lora) and rope dims of deepseek-v2 at full width
# and at SMOKE.
DIMS = ((512, 64), (16, 8))
MAX_HEADS = 128
# Query heads a block serves (kHeads in the two instances of the source).
HEADS_PER_BLOCK = {"tc": 64, "simt": 8}
# Positions a tile: a split takes whole tiles.
TILE = 32
# Blocks an SM that n_splits aims at (one runs at a time: the tensor-core
# instance's shared memory allows one).
WAVES = 4


def route(dtype: torch.dtype, r: int, p: int) -> str:
    """The instance that takes a CUDA call: ``"tc"`` (bf16 at (512, 64)),
    ``"simt"`` (f32 at ``DIMS``, bf16 at (16, 8)); anything else
    raises."""
    if dtype not in DTYPES:
        raise TypeError(f"mla_decode_attention: dtype {dtype}, the kernel "
                        f"takes {DTYPES}")
    if (r, p) not in DIMS:
        raise ValueError(f"mla_decode_attention: (latent, rope) dims "
                         f"({r}, {p}), the kernel takes {DIMS}")
    return "tc" if dtype == torch.bfloat16 and (r, p) == DIMS[0] else "simt"


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def n_splits(path: str, b: int, h: int, s: int, sms: int) -> int:
    """Splits of each request's positions: about four blocks an SM over
    the B x ceil(H / heads a block) (request, head group) pairs (the
    blocks of long requests then share the SMs with short ones' blocks),
    at least 1 and at most a split a tile of S."""
    pairs = b * -(-h // HEADS_PER_BLOCK[path])
    return max(1, min(WAVES * sms // max(pairs, 1), -(-s // TILE)))


def mla_decode_attention(q_lat: torch.Tensor, q_rope: torch.Tensor,
                         ckv: torch.Tensor, krope: torch.Tensor,
                         lengths: torch.Tensor, scale: float
                         ) -> torch.Tensor:
    """q_lat (B, H, R), q_rope (B, H, P), ckv (B, S, R), krope (B, S, P),
    lengths (B,) int32 -> o_lat (B, H, R) in the inputs' dtype: softmax
    over positions [0, min(lengths, S)) of (q_lat . ckv + q_rope . krope)
    * scale, times ckv."""
    global launches
    if _launch.dispatch_device("mla_decode_attention", q_lat) == "cpu":
        return _ref.mla_decode_attention_ref(q_lat, q_rope, ckv, krope,
                                             lengths, scale)
    b, h, r = q_lat.shape
    s, p = ckv.shape[1], krope.shape[-1]
    dev, dt = q_lat.device, q_lat.dtype
    path = route(dt, r, p)
    for name, t, shape in (("q_lat", q_lat, (b, h, r)),
                           ("q_rope", q_rope, (b, h, p)),
                           ("ckv", ckv, (b, s, r)),
                           ("krope", krope, (b, s, p))):
        _launch.check_cuda("mla_decode_attention", name, t, dt, shape, dev,
                           strided=True)
        if path == "tc" and (t.data_ptr() % 16 or any(
                st * t.element_size() % 16 for st in t.stride()[:2])):
            raise ValueError(f"mla_decode_attention: {name} (address "
                             f"{t.data_ptr():#x}, strides {t.stride()}) is "
                             f"not 16-byte aligned, as the tensor-core "
                             f"instance's 16-byte copies need")
    _launch.check_cuda("mla_decode_attention", "lengths", lengths,
                       torch.int32, (b,), dev)
    if h > MAX_HEADS:
        raise ValueError(f"mla_decode_attention: {h} heads, the kernel "
                         f"takes at most {MAX_HEADS}")
    n_split = n_splits(path, b, h, s, _sm_count(dev.index))
    if b > 65535:
        raise ValueError(f"mla_decode_attention: {b} requests exceed the "
                         f"kernel's grid (65,535)")
    out = torch.empty((b, h, r), dtype=dt, device=dev)
    part_m = torch.empty((n_split, b * h), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((n_split, b * h, r), dtype=torch.float32,
                           device=dev)
    strides = (ctypes.c_longlong * 8)(*q_lat.stride()[:2],
                                      *q_rope.stride()[:2],
                                      *ckv.stride()[:2], *krope.stride()[:2])
    lib = _build.load()
    with torch.cuda.device(dev):
        code = lib.moby_mla_decode_attention(
            q_lat.data_ptr(), q_rope.data_ptr(), ckv.data_ptr(),
            krope.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
            strides, b, h, s, r, p, n_split, int(dt == torch.bfloat16),
            float(scale), _launch.stream_handle(dev))
    _build.check(code, f"mla_decode_attention ({path})")
    launches += 1
    return out
