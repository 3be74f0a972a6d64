"""Threefry-2x32 counter-based PRNG, bit-identical to ``jax.random``.

The JAX package draws its RANSAC triplets from ``jax.random`` (threefry2x32
under ``jax_threefry_partitionable=True``, the default of jax 0.9). The
triplets decide the planes, the planes decide the boxes, and the boxes
decide (through F1) the scheduler's frame kinds — so the port reproduces
the generator bit for bit instead of drawing from a ``torch.Generator``.

Keys are ``(..., 2)`` tensors of 32-bit words held in int64 lanes (values
in ``[0, 2**32)``): torch's uint32 arithmetic is incomplete, and int64
holds every intermediate of the 32-bit add/rotate/xor rounds once masked.
A leading batch shape stands in for ``vmap`` over keys. Everything runs
on the device the key lives on.

Only what the serving path calls is ported: :func:`key`, :func:`split`
and :func:`randint` (with a per-key tensor ``maxval``, as RANSAC passes a
traced ``max(n_valid, 1)``).
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the counter pair ``(x1, x2)``
    under the key ``(k1, k2)``; all int64 tensors of 32-bit words that
    broadcast together. Mirrors ``jax._src.prng._threefry2x32_lowering``."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x1 + ks[0]) & _MASK
    y = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + y) & _MASK
            y = _rotl(y, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        y = (y + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, y


def key(seed: int, device: Union[str, torch.device, None] = None
        ) -> torch.Tensor:
    """``jax.random.key_data(jax.random.key(seed))`` as a (2,) int64 tensor.

    Seeds are int32 values, as ``jax.random.key`` takes them with 64-bit
    mode off: the high word is 0 and the low word is the seed's two's
    complement."""
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} is outside the int32 range")
    return torch.tensor([0, seed & _MASK], dtype=torch.int64, device=device)


def _bits(key: torch.Tensor, shape: Sequence[int]) -> tuple[torch.Tensor,
                                                            torch.Tensor]:
    """Both threefry output words over the flattened counter iota of
    ``shape`` (high counter word 0), batched over the key's leading dims:
    ``(..., prod(shape))`` each."""
    n = math.prod(shape)
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    hi = torch.zeros_like(lo)
    return threefry2x32(key[..., 0:1], key[..., 1:2], hi, lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: (..., 2) keys -> (..., num, 2) keys."""
    b1, b2 = _bits(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element: (..., 2) keys -> (..., *shape) words."""
    b1, b2 = _bits(key, shape)
    return (b1 ^ b2).reshape(*key.shape[:-1], *shape)


def randint(key: torch.Tensor, shape: Sequence[int], minval: int,
            maxval: Union[int, torch.Tensor]) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` for int32 output.

    ``key`` is (..., 2) and ``maxval`` an int or a tensor of the key's
    batch shape (one bound per key); returns (..., *shape) int64 values.
    Two 32-bit draws per value are folded into ``[minval, maxval)`` with
    jax's multiply-mod trick, in wrapping uint32 arithmetic.
    """
    batch = key.shape[:-1]
    maxval = torch.as_tensor(maxval, dtype=torch.int64, device=key.device)
    maxval = maxval.reshape(*maxval.shape, *([1] * len(shape)))
    keys = split(key, 2)
    higher = random_bits(keys[..., 0, :], shape)
    lower = random_bits(keys[..., 1, :], shape)
    span = (maxval - minval) & _MASK
    span = torch.where(maxval <= minval, torch.ones_like(span), span)
    multiplier = torch.remainder(torch.full_like(span, 2 ** 16), span)
    multiplier = torch.remainder((multiplier * multiplier) & _MASK, span)
    offset = (torch.remainder(higher, span) * multiplier) & _MASK
    offset = (offset + torch.remainder(lower, span)) & _MASK
    offset = torch.remainder(offset, span)
    return (minval + offset).expand(*batch, *shape)
