"""Wrapper of the flash attention kernel (``csrc/flash_attention.cu``).

A CPU tensor goes to the plain version (``ref.py``); a CUDA tensor
launches the kernel, or the call raises. ``launches`` counts the kernel
launches made through this wrapper.

The kernel reads q, k and v through their strides (only the head dim must
be contiguous), so callers pass ``transpose`` views of their
(B, S, heads, hd) activations. On the card the output is a (B, H, SQ, hd)
view of (B, SQ, H, hd) storage, the layout the model continues in.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _launch
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

launches = 0

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, H, SQ, hd); k/v: (B, KV, SK, hd) -> (B, H, SQ, hd).

    Keys above the diagonal are masked when ``causal`` (query i sees keys
    [0, i]); H must be a multiple of KV.
    """
    global launches
    if _launch.dispatch_device("flash_attention", q) == "cpu":
        return flash_attention_ref(q, k, v, causal)
    b, h, sq, hd = q.shape
    kv, sk = k.shape[1], k.shape[2]
    for name, t, shape in (("q", q, (b, h, sq, hd)), ("k", k, (b, kv, sk, hd)),
                           ("v", v, (b, kv, sk, hd))):
        _launch.check_cuda("flash_attention", name, t, q.dtype, shape,
                           q.device, strided=True)
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention: dtype {q.dtype}, the kernel takes "
                        f"{DTYPES}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd}, the kernel takes "
                         f"{HEAD_DIMS}")
    if kv == 0 or h % kv:
        raise ValueError(f"flash_attention: {h} query heads over {kv} kv "
                         f"heads")
    if b * h > 65535:
        raise ValueError(f"flash_attention: {b * h} (batch, head) pairs "
                         f"exceed the kernel's grid")
    out = torch.empty((b, sq, h, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    lib = _build.load()
    with torch.cuda.device(q.device):
        code = lib.moby_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
            b, h, kv, sq, sk, hd, int(causal), int(q.dtype == torch.bfloat16),
            hd ** -0.5, _launch.stream_handle(q.device))
    _build.check(code, "flash_attention")
    launches += 1
    return out
