"""AdamW with a warm-up cosine schedule (``repro/train/optimizer.py``).

Generic over the port's parameter trees (nested dicts of tensors, leaves
in sorted-key order as JAX flattens a dict). Like the JAX version it is
functional by default: :func:`update` returns new parameters and a new
state and leaves its inputs as they were; with ``inplace=True`` (the LM
train step, whose masters and moments would not fit twice on one card) it
writes the same values into the parameters and moments, leaf by leaf.
The step count and the learning rate stay on the parameters' device, so a
step makes no host sync. ZeRO-1
(``zero1_specs``) shards moments over a device mesh and has no
counterpart here.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.models import params as params_mod


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor        # () int32
    m: Any
    v: Any


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``lr``, then a cosine down to ``min_lr_ratio``."""
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0,
                       1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    scale = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * scale


def init(params) -> OptState:
    """Zero moments shaped like ``params``; step 0 on their device."""
    dev = next(t for _, t in params_mod.leaves(params)).device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    m=params_mod.tree_map(torch.zeros_like, params),
                    v=params_mod.tree_map(torch.zeros_like, params))


def global_norm(tree) -> torch.Tensor:
    """L2 norm over every leaf, in float32."""
    total = 0
    for _, leaf in params_mod.leaves(tree):
        total = total + torch.sum(torch.square(leaf.float()))
    return torch.sqrt(total)


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state: OptState, params,
           inplace: bool = False):
    """Returns (new_params, new_state, metrics): one AdamW step on the
    gradients clipped to a global norm of ``grad_clip``. With ``inplace``
    the new values are written into ``params``, ``state.m`` and
    ``state.v`` (the same numbers), which are returned."""
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9),
                            1.0)
    step = state.step + 1
    lr = cosine_lr(cfg, step)
    b1c = 1 - torch.pow(cfg.b1, step.float())
    b2c = 1 - torch.pow(cfg.b2, step.float())
    m_of = dict(params_mod.leaves(state.m))
    v_of = dict(params_mod.leaves(state.v))
    p_of = dict(params_mod.leaves(params))
    new_p, new_m, new_v = [], [], []
    for path, g in params_mod.leaves(grads):
        p, m, v = p_of[path], m_of[path], v_of[path]
        if not inplace:
            p, m, v = p.clone(), m.clone(), v.clone()
        # Each step rounds as m2 = b1 m + (1 - b1) g, v2 = b2 v + (1 - b2)
        # g^2, delta = (m2 / b1c) / (sqrt(v2 / b2c) + eps) + wd p, p - lr
        # delta would, with at most two leaf-sized temporaries alive.
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_(torch.square(g).mul_(1 - cfg.b2))
        del g
        delta = m / b1c
        delta.div_((v / b2c).sqrt_().add_(cfg.eps))
        delta.add_(cfg.weight_decay * p.float())
        p.copy_(p.float() - delta.mul_(lr))
        new_p.append((path, p))
        new_m.append((path, m))
        new_v.append((path, v))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return (params_mod.from_leaves(new_p),
            OptState(step=step, m=params_mod.from_leaves(new_m),
                     v=params_mod.from_leaves(new_v)), metrics)
