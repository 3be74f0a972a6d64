"""repro_torch — the Moby reproduction on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package ``repro`` that sits beside it and imports
nothing of it (nor of JAX). Module paths mirror ``repro``'s
(``repro/core/transform.py`` <-> ``repro_torch/core/transform.py``); the
TPU's Pallas kernels on the serving path are hand-written CUDA kernels
under ``csrc/``, each beside its plain PyTorch version
(``repro_torch/kernels``). Tensors on the card go to the kernels, tensors
on the CPU to the plain versions, and entry points take a
``torch_device`` argument that defaults to ``"cuda"``.

This slice serves one Moby stream end to end (``api.Session`` with
``n_streams == 1``, and the edge/cloud baselines). See ROADMAP.md for what
is still to port.
"""
