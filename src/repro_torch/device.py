"""The torch device an entry point computes on.

Entry points (``api.Session``, ``serving.engine.MobyEngine``) take a
``torch_device`` argument that defaults to ``"cuda"``. It is not called
``device``: ``Scenario.device`` and ``MobyEngine(device=...)`` already
name the *modeled* edge profile (``"jetson_tx2"``). The CPU runs only
when the caller asks for it.
"""
from __future__ import annotations

from typing import Union

import torch

DEFAULT = "cuda"


def resolve(torch_device: Union[str, torch.device] = DEFAULT) -> torch.device:
    """Validate ``torch_device``; a CUDA request without a card raises."""
    dev = torch.device(torch_device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"torch_device={str(torch_device)!r} but torch sees no CUDA "
                f"device; pass torch_device='cpu' to run the plain PyTorch "
                f"versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported torch_device {str(torch_device)!r}: "
                         f"'cuda' or 'cpu'")
    return dev
