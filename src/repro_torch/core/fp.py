"""Short float32 reductions rounded the way the JAX reference rounds them.

XLA compiles ``x * y + z`` inside a fusion to one fused multiply-add on the
CPU, so the JAX package's 2- and 3-term dots, norms and cross products
round once per term after the first product: ``fma(a2, b2, fma(a1, b1,
a0 * b0))`` and ``fma(a1, b2, -(a2 * b1))``. The difference is visible
where it decides something: a RANSAC triplet with a repeated point has a
cross product of exactly 0 without fusion, but a rounding residue (and a
plane that counts as valid) with it. These helpers reproduce the fused
forms on any device.

``fma`` is evaluated in float64: a product of two float32 values is exact
there, so the only rounding before the final one to float32 is that of the
float64 sum — which agrees with a true float32 FMA except on double-rounding
ties (about one input in 2**29).
"""
from __future__ import annotations

import torch


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to float32."""
    return (a.double() * b.double() + c.double()).float()


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum of ``a * b`` over a short last axis, accumulated by FMA."""
    acc = a[..., 0] * b[..., 0]
    for i in range(1, a.shape[-1]):
        acc = fma(a[..., i], b[..., i], acc)
    return acc


def norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over a short last axis (``jnp.linalg.norm``)."""
    return torch.sqrt(dot(v, v))


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3-vector cross product over the last axis (``jnp.cross``)."""
    def term(i, j):
        return fma(a[..., i], b[..., j], -(a[..., j] * b[..., i]))
    return torch.stack([term(1, 2), term(2, 0), term(0, 1)], dim=-1)
