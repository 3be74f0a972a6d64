"""Architecture registry (``repro/configs/__init__.py``).

``get(name)`` returns the full ArchConfig, ``get_smoke(name)`` the reduced
same-family config of the CPU tests. The port has the dense, vlm and
encoder-decoder (audio) families and the moe family (full attention and
MLA) so far: the other architectures of ``ARCH_IDS`` (the ssm and hybrid
families) raise ``NotImplementedError`` until their families are ported
(ROADMAP.md).
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ArchConfig

ARCH_IDS = [
    "whisper_small",
    "qwen2_vl_2b",
    "deepseek_v2_236b",
    "moonshot_v1_16b_a3b",
    "glm4_9b",
    "qwen2_5_3b",
    "minitron_4b",
    "granite_20b",
    "xlstm_350m",
    "zamba2_1_2b",
]

# The architectures whose family the port runs (dense; moe with full
# attention or MLA; vlm; audio, the encoder-decoder family).
PORTED = ("glm4_9b", "qwen2_5_3b", "minitron_4b", "granite_20b",
          "moonshot_v1_16b_a3b", "deepseek_v2_236b", "qwen2_vl_2b",
          "whisper_small")


def _module(name: str):
    if name not in ARCH_IDS:
        raise KeyError(f"unknown architecture {name!r}; known: {ARCH_IDS}")
    if name not in PORTED:
        raise NotImplementedError(
            f"{name}: its model family is not ported yet (the port runs "
            f"{list(PORTED)}; see ROADMAP.md)")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ArchConfig:
    return _module(name).SMOKE

