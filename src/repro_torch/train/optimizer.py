"""AdamW with a warm-up cosine schedule (``repro/train/optimizer.py``).

Generic over the port's parameter trees (nested dicts of tensors, leaves
in sorted-key order as JAX flattens a dict). Like the JAX version it is
functional: :func:`update` returns new parameters and a new state and
leaves its inputs as they were; the step count and the learning rate stay
on the parameters' device, so a step makes no host sync. ZeRO-1
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
def update(cfg: AdamWConfig, grads, state: OptState, params):
    """Returns (new_params, new_state, metrics): one AdamW step on the
    gradients clipped to a global norm of ``grad_clip``."""
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
        p = p_of[path]
        g = g.float() * scale
        m2 = cfg.b1 * m_of[path] + (1 - cfg.b1) * g
        v2 = cfg.b2 * v_of[path] + (1 - cfg.b2) * torch.square(g)
        mhat = m2 / b1c
        vhat = v2 / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * \
            p.float()
        new_p.append((path, (p.float() - lr * delta).to(p.dtype)))
        new_m.append((path, m2))
        new_v.append((path, v2))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return (params_mod.from_leaves(new_p),
            OptState(step=step, m=params_mod.from_leaves(new_m),
                     v=params_mod.from_leaves(new_v)), metrics)
