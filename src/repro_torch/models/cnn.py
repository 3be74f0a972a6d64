"""What the two detectors share: convolutions as the JAX package writes
them (``lax.conv_general_dilated`` with ``"SAME"`` padding, NHWC
activations, HWIO weights), the normalisation, ``jnp.clip`` and the
last-writer-wins placement of training targets.

The port keeps the weights in JAX's HWIO layout (so parameter trees and
their gradients compare leaf for leaf) and permutes them to PyTorch's OIHW
at the call; activations are NCHW between the calls.

* ``"SAME"`` is not symmetric: a stride-2 3x3 convolution over an even
  size pads 0 rows before and 1 after (XLA's rule, low = total // 2),
  where ``F.conv2d(padding=1)`` would pad 1 and 1 and shift the map by a
  pixel. :func:`conv2d_same` pads explicitly.
* cuDNN runs float32 convolutions in TF32 unless told not to; the
  detectors' convolutions run under :func:`f32_convolutions`, full float32
  and deterministic algorithms, whatever the caller's global flags.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


def same_pads(size: int, kernel: int, stride: int):
    """(low, high) padding of one spatial dimension under ``"SAME"``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv2d_same(x: torch.Tensor, w_hwio: torch.Tensor, stride: int
                ) -> torch.Tensor:
    """x (B, Cin, H, W), w (kh, kw, Cin, Cout) -> (B, Cout, ceil(H/s),
    ceil(W/s)), as ``conv_general_dilated(x, w, (s, s), "SAME")``."""
    kh, kw = w_hwio.shape[:2]
    ph = same_pads(x.shape[2], kh, stride)
    pw = same_pads(x.shape[3], kw, stride)
    if any(ph + pw):
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, w_hwio.permute(3, 2, 0, 1), stride=stride)


def f32_convolutions():
    """Scope for the detectors' convolutions: cuDNN on, no TF32, no
    autotuning, deterministic algorithms (gradients repeat bit for bit)."""
    if not torch.backends.cudnn.is_available():
        return contextlib.nullcontext()
    return torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                      deterministic=True, allow_tf32=False)


def norm_relu(x: torch.Tensor, scale: torch.Tensor, dims) -> torch.Tensor:
    """``relu((x - mean) * rsqrt(var + 1e-5) * scale)`` with the mean and
    the population variance over ``dims`` of the NCHW map; ``scale`` (C,)."""
    mu = x.mean(dim=dims, keepdim=True)
    var = x.var(dim=dims, keepdim=True, correction=0)
    return torch.relu((x - mu) * torch.rsqrt(var + 1e-5)
                      * scale[None, :, None, None])


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)``, a maximum then a minimum, whose gradient at
    a bound is 1/2 (a tie splits it, in JAX and in torch.maximum alike);
    ``torch.clamp`` would pass 1."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)),
                         x.new_full((), hi))


def last_writer_slots(cell: torch.Tensor, valid: torch.Tensor,
                      spare: int) -> torch.Tensor:
    """Where each of O objects writes its target, as JAX's sequential
    ``lax.scan`` places them: a valid object writes its ``cell`` unless a
    later valid object takes the same cell; the others go to ``spare``, a
    slot past the map. Each cell is then written by one object, so no two
    writes race on the card."""
    o = torch.arange(cell.shape[0], device=cell.device)
    overwritten = ((cell[:, None] == cell[None, :]) & valid[None, :]
                   & (o[None, :] > o[:, None])).any(dim=1)
    return torch.where(valid & ~overwritten, cell, spare)
