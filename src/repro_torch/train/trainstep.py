"""The training step: loss and gradients (with accumulation), the
gradient-compression hook, AdamW (``repro/train/trainstep.py``).

Gradient accumulation runs as a Python loop over microbatches (JAX's
``lax.scan``): f32 gradient sums divided by ``grad_accum``, the mean loss
the sum of the microbatches' losses divided by it. The step runs where the
parameters are (the card, or the CPU when the caller built them there);
it updates the parameters and the optimizer state in place
(``optimizer.update(..., inplace=True)``): the f32 masters and both
moments of qwen2.5-3B are ~37 GB, which one card cannot hold twice.
"""
from __future__ import annotations

import torch

from repro_torch.models import lm
from repro_torch.models.config import ArchConfig
from repro_torch.models.params import from_leaves, leaves
from repro_torch.train import optimizer as opt


def _on_device(batch, dev: torch.device):
    """The batch's arrays on the parameters' device: numpy arrays are
    copied there; a tensor elsewhere raises (no silent copy between
    devices)."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor):
            if v.device != dev:
                raise ValueError(f"batch[{k!r}] is on {v.device}, the "
                                 f"parameters on {dev}")
            out[k] = v
        else:
            out[k] = torch.as_tensor(v, device=dev)
    return out


def make_train_step(cfg: ArchConfig, ocfg: opt.AdamWConfig,
                    grad_compressor=None):
    """Returns train_step(params, opt_state, batch) -> (params, state,
    metrics): ``params`` and ``opt_state`` updated in place and returned;
    metrics {"loss", "grad_norm", "lr"} as 0-d tensors on their device.

    grad_compressor: optional hook ``(grads, opt_state) -> (grads,
    opt_state)`` applied to the gradients before the optimizer (e.g. top-k
    with error feedback from ``runtime.gradcomp``).
    """

    def value_and_grad(params, batch):
        req = [(path, t.detach().requires_grad_())
               for path, t in leaves(params)]
        with torch.enable_grad():
            loss = lm.loss_fn(from_leaves(req), cfg, batch)
            # A leaf the loss does not reach (a stack of no layers, as at
            # n_layers == first_dense) gets zeros, as in jax.grad.
            grads = torch.autograd.grad(loss, [t for _, t in req],
                                        allow_unused=True,
                                        materialize_grads=True)
        return loss.detach(), [(path, g) for (path, _), g in zip(req, grads)]

    def loss_and_grads(params, batch):
        g = cfg.grad_accum
        if g <= 1:
            loss, grads = value_and_grad(params, batch)
            return loss, from_leaves(grads)
        micro = {k: v.reshape((g, v.shape[0] // g) + v.shape[1:])
                 for k, v in batch.items()}
        loss_sum, gsum = None, None
        for i in range(g):
            loss, grads = value_and_grad(params,
                                         {k: v[i] for k, v in micro.items()})
            if gsum is None:
                loss_sum = torch.zeros_like(loss)
                gsum = [torch.zeros(x.shape, dtype=torch.float32,
                                    device=x.device) for _, x in grads]
            loss_sum = loss_sum + loss
            for acc, (_, x) in zip(gsum, grads):
                acc.add_(x.float())
        return loss_sum / g, from_leaves(
            (path, acc / g) for (path, _), acc in zip(grads, gsum))

    def train_step(params, opt_state, batch):
        dev = next(t for _, t in leaves(params)).device
        loss, grads = loss_and_grads(params, _on_device(batch, dev))
        if grad_compressor is not None:
            grads, opt_state = grad_compressor(grads, opt_state)
        params, opt_state, metrics = opt.update(ocfg, grads, opt_state,
                                                params, inplace=True)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step
