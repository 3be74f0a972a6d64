"""Helpers for functions that take leading batch dimensions.

The JAX package batches its per-stream step with ``jax.vmap``; the port
writes the batch out instead: every core function takes any number of
leading dimensions, and a single stream is the case of none. Two
operations need a spelling that works at every batch rank: a gather of
rows by per-batch indices (what ``x[idx]`` is under ``vmap``), and the
select that ``vmap`` makes of ``lax.cond``.
"""
from __future__ import annotations

from typing import NamedTuple, TypeVar

import torch

T = TypeVar("T", bound=NamedTuple)


def take(x: torch.Tensor, idx: torch.Tensor, trailing: int = 0
         ) -> torch.Tensor:
    """Rows of ``x`` at ``idx``, per batch element.

    ``x`` is ``(*B, N, *F)`` with ``trailing = len(F)`` feature dims and
    ``idx`` is ``(*B, *M)`` (``M`` any shape) of indices into ``N``;
    returns ``(*B, *M, *F)`` — ``x[b][idx[b]]`` for every batch index
    ``b``."""
    feat = x.shape[x.dim() - trailing:]
    lead = x.shape[:x.dim() - trailing - 1]
    m = idx.shape[len(lead):]
    flat_x = x.reshape(*lead, x.shape[len(lead)], -1)
    flat_i = idx.reshape(*lead, -1, 1).expand(*lead, -1, flat_x.shape[-1])
    return torch.gather(flat_x, len(lead), flat_i).reshape(*lead, *m, *feat)


def select(pred: torch.Tensor, a: T, b: T) -> T:
    """``a`` where ``pred`` else ``b``, leaf by leaf over two NamedTuples
    of tensors (nested ones too) whose leaves lead with ``pred``'s dims:
    what ``jax.vmap`` makes of ``lax.cond`` with a batched predicate."""
    def one(x, y):
        if isinstance(x, tuple):
            return type(x)(*(one(u, v) for u, v in zip(x, y)))
        p = pred.reshape(*pred.shape, *([1] * (x.dim() - pred.dim())))
        return torch.where(p, x, y)
    return one(a, b)
