"""The PointPillars detector's comparisons, shared by the port's tests and
``chip_smoke.py``: its tolerances, the trained-parameter rule and the check
against ``tests/goldens/det3d_smoke.npz`` (the JAX package's weights, frame,
outputs, gradients and AdamW steps at a small config). Every check raises
``AssertionError`` naming what differs.

Tolerances are relative to the largest magnitude of each tensor compared,
every gradient leaf on its own scale: float32 sums taken in another order
(the matmul, the convolutions, the variance) through three normalised conv
blocks and back. The largest seen against JAX at the small config on the
CPU: 1.4e-6 for the outputs, 6.0e-6 for a gradient leaf (``pnet_w``).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Union

import numpy as np
import torch

from repro_torch import convert
from repro_torch.models import detector3d, params
from repro_torch.train import optimizer

OUT_TOL, GRAD_TOL = 1e-5, 2e-5


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.asarray(x)


def close(got, want, tol: float, what: str = "") -> float:
    """``got`` finite, of ``want``'s shape and within ``tol`` times
    ``want``'s largest magnitude of it; returns the largest difference over
    that magnitude (the reading the tolerance bounds)."""
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape, f"{what}: shape {got.shape} != " \
        f"{want.shape}"
    assert np.isfinite(got).all(), f"{what}: not finite"
    if not want.size:
        return 0.0
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: off by {err} (tolerance {tol} x " \
        f"{scale:.3g})"
    return err / scale


def loss_grads(p: dict, cfg, points, valid, gt_boxes, gt_valid):
    """(loss, its parts, the gradient tree of every parameter)."""
    leaves = params.tree_map(lambda t: t.detach().clone().requires_grad_(),
                             p)
    loss, parts = detector3d.loss_fn(leaves, cfg, points, valid, gt_boxes,
                                     gt_valid)
    paths = [path for path, _ in params.leaves(leaves)]
    grads = torch.autograd.grad(loss, [t for _, t in params.leaves(leaves)])
    return loss.detach(), parts, params.from_leaves(zip(paths, grads))


def train(p: dict, cfg, ocfg, frame, steps: int):
    """``steps`` AdamW steps on one frame -> (params, losses, grad norms,
    the gradient tree of every step)."""
    state = optimizer.init(p)
    losses, norms, step_grads = [], [], []
    for _ in range(steps):
        loss, _, grads = loss_grads(p, cfg, *frame)
        p, state, metrics = optimizer.update(ocfg, grads, state, p)
        losses.append(loss)
        norms.append(metrics["grad_norm"])
        step_grads.append(grads)
    return p, torch.stack(losses), torch.stack(norms), step_grads


def close_trained(trained: dict, want: dict, step_grads, lr: float):
    """Trained parameters within OUT_TOL, but for the elements whose
    gradient lay within GRAD_TOL of its leaf's largest at some step: AdamW
    divides each gradient by its own running RMS, so such an element's step
    has the sign of float32 noise, and it is held to the step bound, lr a
    step either way (2 x lr x steps). They must stay under 1% of the
    elements (1 of 9,032 at the small config). Returns (loose, total)."""
    bound = 2 * lr * len(step_grads)
    loose = total = 0
    for path, t in params.leaves(trained):
        noisy = np.zeros(t.shape, bool)
        for g in step_grads:
            g = np.abs(_np(dict(params.leaves(g))[path]))
            noisy |= g <= GRAD_TOL * g.max()
        err = np.abs(_np(t) - _np(want[path]))
        name = "/".join(path)
        assert (err[~noisy] <= OUT_TOL).all(), \
            f"trained {name}: off by {err[~noisy].max()}"
        assert (err[noisy] <= bound).all(), \
            f"trained {name}: off by {err.max()} (step bound {bound})"
        loose += int((noisy & (err > OUT_TOL)).sum())
        total += t.numel()
    assert loose < 0.01 * total, \
        f"{loose} of {total} trained values off by more than {OUT_TOL}"
    return loose, total


def load_golden(path: Union[str, Path]) -> dict:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def check_golden(path: Union[str, Path],
                 device: Union[str, torch.device]) -> dict:
    """The port on ``device`` against the golden: forward, loss, every
    gradient, detect and the AdamW steps. Returns the largest difference of
    each over its tensor's largest magnitude, the golden's config, the
    counts of gradients and kept boxes, and the trained values held to the
    step bound."""
    gold = load_golden(path)
    cfg = detector3d.PillarConfig(**{
        k: tuple(v) if isinstance(v, list) else v
        for k, v in json.loads(str(gold["config"])).items()})
    ocfg = optimizer.AdamWConfig(**json.loads(str(gold["adamw"])))

    def tree(prefix):
        return params.from_leaves((tuple(k.split("/")[1:]), v)
                                  for k, v in gold.items()
                                  if k.startswith(prefix + "/"))
    p = convert.detector_params_from_jax(tree("params"), cfg, device)
    frame = [torch.from_numpy(gold[k]).to(device)
             for k in ("points", "valid", "gt_boxes", "gt_valid")]
    errs = {}
    cls, box = detector3d.forward(p, cfg, frame[0], frame[1])
    errs["forward"] = max(close(cls, gold["cls"], OUT_TOL, "cls"),
                          close(box, gold["box"], OUT_TOL, "box"))
    loss, _, grads = loss_grads(p, cfg, *frame)
    errs["loss"] = close(loss, gold["loss"], OUT_TOL, "loss")
    want = dict(params.leaves(tree("grads")))
    assert sorted(want) == sorted(path for path, _ in params.leaves(grads))
    errs["grads"] = max(close(g, want[path], GRAD_TOL,
                              "grad " + "/".join(path))
                        for path, g in params.leaves(grads))
    det_boxes, det_valid = detector3d.detect(p, cfg, frame[0], frame[1])
    assert np.array_equal(_np(det_valid), gold["det_valid"]), \
        "detect's kept flags differ"
    errs["detect"] = close(det_boxes, gold["det_boxes"], OUT_TOL,
                           "detect boxes")
    trained, losses, _, step_grads = train(p, cfg, ocfg, frame,
                                           len(gold["train_losses"]))
    errs["train losses"] = close(losses, gold["train_losses"], OUT_TOL,
                                 "training losses")
    loose, total = close_trained(trained, dict(params.leaves(
        tree("trained"))), step_grads, ocfg.lr)
    return dict(errs=errs, cfg=cfg, n_grads=len(want),
                n_kept=int(det_valid.sum()), steps=len(step_grads),
                loose=loose, total=total)
