"""Training loop: data -> train step -> metrics -> checkpoints -> restart
(``repro/train/loop.py``).

``fit`` wraps the train step (``trainstep.make_train_step``), the
deterministic token pipeline (restart-reproducible), and the
``CheckpointManager`` (async saves, crash-consistent restore). It runs on
``torch_device``: the card by default (raising without one), the CPU when
the caller asks. The initial parameters come from ``params.init_params``
with a ``torch.Generator`` on that device seeded by ``seed``, so they are
not the JAX package's; the pipeline's batches are its.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch import device as _device
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
from repro_torch.models import lm
from repro_torch.models import params as params_lib
from repro_torch.models.config import ArchConfig
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import trainstep


@dataclasses.dataclass
class FitResult:
    losses: list
    steps: int
    restored_from: Optional[int]


def fit(cfg: ArchConfig, n_steps: int, global_batch: int, seq_len: int,
        ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
        ocfg: Optional[opt_lib.AdamWConfig] = None, seed: int = 0,
        log_every: int = 10, resume: bool = True,
        torch_device: Union[str, torch.device] = _device.DEFAULT
        ) -> FitResult:
    """Train cfg's model on the synthetic pipeline for steps [start,
    n_steps), start being the latest checkpoint's step when ``resume``
    finds one in ``ckpt_dir``; a checkpoint of the parameters and the
    optimizer state every ``ckpt_every`` steps."""
    dev = _device.resolve(torch_device)
    ocfg = ocfg or opt_lib.AdamWConfig(lr=1e-3, warmup_steps=20,
                                       total_steps=n_steps)
    params = params_lib.init_params(
        lm.model_defs(cfg), torch.Generator(device=dev).manual_seed(seed),
        dev)
    opt_state = opt_lib.init(params)
    step_fn = trainstep.make_train_step(cfg, ocfg)
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=seq_len, global_batch=global_batch,
        seed=seed))

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start = 0
    restored = None
    if mgr and resume and mgr.latest_step() is not None:
        state = mgr.restore(None, {"params": params, "opt": opt_state})
        params, opt_state = state["params"], state["opt"]
        start = mgr.latest_step()
        restored = start

    losses = []
    for step in range(start, n_steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in pipe.batch_at(step).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % log_every == 0:
            print(f"step {step}: loss={loss:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f}", flush=True)
        if mgr and (step + 1) % ckpt_every == 0:
            mgr.save_async(step + 1, {"params": params, "opt": opt_state})
    if mgr:
        mgr.wait()
    return FitResult(losses=losses, steps=n_steps, restored_from=restored)
