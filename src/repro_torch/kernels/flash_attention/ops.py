"""Wrapper of the two flash attention kernels.

A CPU tensor goes to the plain version (``ref.py``); a CUDA tensor
launches one of two kernels, chosen by ``route`` before any launch, or the
call raises:

* ``"tc"``: bf16 at head dim 128 (every full-width dense config) runs
  ``csrc/flash_attention_tc.cu`` on the tensor cores in bf16 (wgmma fed by
  TMA); ``tc_launches`` counts its launches;
* ``"tf32x3"``: f32, and bf16 at the other head dims, runs
  ``csrc/flash_attention.cu`` on the tensor cores too, f32-accurate by the
  3xTF32 split (mma.sync fed by cp.async); ``launches`` counts its
  launches.

The kernels read q, k and v through their strides (only the head dim must
be contiguous), so callers pass ``transpose`` views of their
(B, S, heads, hd) activations. On the card the output is a (B, H, SQ, hd)
view of (B, SQ, H, hd) storage, the layout the model continues in. Both
kernels copy their operands by 16-byte units (TMA, cp.async), which need
16-byte aligned base addresses and strides: the wrapper checks both and
raises, it never copies.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _launch
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

launches = 0      # the 3xTF32 kernel
tc_launches = 0   # the tensor-core kernel

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
TC_HEAD_DIMS = (128,)


def route(dtype: torch.dtype, head_dim: int) -> str:
    """Which kernel takes a CUDA call: ``"tc"`` (bf16 at a head dim of
    ``TC_HEAD_DIMS``), ``"tf32x3"`` (any other of ``DTYPES`` x
    ``HEAD_DIMS``); anything else raises."""
    if dtype not in DTYPES:
        raise TypeError(f"flash_attention: dtype {dtype}, the kernels take "
                        f"{DTYPES}")
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {head_dim}, the kernels "
                         f"take {HEAD_DIMS}")
    if dtype == torch.bfloat16 and head_dim in TC_HEAD_DIMS:
        return "tc"
    return "tf32x3"


def _check_aligned(name: str, t: torch.Tensor, path: str) -> None:
    """The kernels copy ``t`` by 16-byte units (TMA, cp.async): 16-byte
    aligned base address and byte strides."""
    if t.data_ptr() % 16 or any(s * t.element_size() % 16
                                for s in t.stride()[:3]):
        raise ValueError(f"flash_attention: {name} (address {t.data_ptr():#x},"
                         f" strides {t.stride()}) is not 16-byte aligned, as "
                         f"the {path} kernel's 16-byte loads need")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, H, SQ, hd); k/v: (B, KV, SK, hd) -> (B, H, SQ, hd).

    Keys above the diagonal are masked when ``causal`` (query i sees keys
    [0, i]); H must be a multiple of KV.
    """
    global launches, tc_launches
    if _launch.dispatch_device("flash_attention", q) == "cpu":
        return flash_attention_ref(q, k, v, causal)
    b, h, sq, hd = q.shape
    kv, sk = k.shape[1], k.shape[2]
    for name, t, shape in (("q", q, (b, h, sq, hd)), ("k", k, (b, kv, sk, hd)),
                           ("v", v, (b, kv, sk, hd))):
        _launch.check_cuda("flash_attention", name, t, q.dtype, shape,
                           q.device, strided=True)
    path = route(q.dtype, hd)
    if kv == 0 or h % kv:
        raise ValueError(f"flash_attention: {h} query heads over {kv} kv "
                         f"heads")
    if b * h > 65535:
        raise ValueError(f"flash_attention: {b * h} (batch, head) pairs "
                         f"exceed the kernel's grid")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_aligned(name, t, path)
    out = torch.empty((b, sq, h, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    lib = _build.load()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    stream = _launch.stream_handle(q.device)
    with torch.cuda.device(q.device):
        if path == "tc":
            code = lib.moby_flash_attention_tc(
                *ptrs, strides, b, h, kv, sq, sk, int(causal), hd ** -0.5,
                stream)
        else:
            code = lib.moby_flash_attention(
                *ptrs, strides, b, h, kv, sq, sk, hd, int(causal),
                int(q.dtype == torch.bfloat16), hd ** -0.5, stream)
    _build.check(code, f"flash_attention ({path})")
    if path == "tc":
        tc_launches += 1
    else:
        launches += 1
    return out
