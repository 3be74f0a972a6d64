"""Unified architecture configuration for the model zoo
(``repro/models/config.py``).

The fields and defaults are the JAX package's, so the two configs compare
field by field, with ``dtype`` a torch dtype, except for three fields the
port drops: ``backend`` (the port dispatches each op by its tensors'
device, not by a backend string), ``rules_override`` and ``seq_shard``
(there is no mesh). ``grad_accum`` and ``remat`` are the training
controls of ``train.trainstep`` and ``models.lm.forward``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128

    # Norms / MLP / embeddings
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    mlp_type: str = "swiglu"     # swiglu | gelu | relu2
    qkv_bias: bool = False
    tie_embeddings: bool = False

    # Positional encoding
    pos_embedding: str = "rope"  # rope | mrope | learned | none
    rope_theta: float = 1e6
    rope_fraction: float = 1.0
    mrope_sections: Tuple[int, ...] = (16, 24, 24)
    max_position: int = 1_048_576

    # Attention kind
    attn_kind: str = "full"      # full | mla
    # MLA (DeepSeek-V2)
    q_lora: int = 0
    kv_lora: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    first_dense: int = 0         # leading dense layers
    capacity_factor: float = 1.25
    router_scale: bool = True    # normalize top-k weights

    # Encoder-decoder (whisper)
    is_encdec: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 1500          # precomputed frame embeddings (stub frontend)

    # SSM
    ssm_kind: str = ""           # mamba2 | xlstm
    ssm_state: int = 64
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    hybrid_attn_every: int = 0   # shared attention block every k ssm layers
    slstm_every: int = 0         # every k-th xlstm block is an sLSTM block

    # Numerics
    dtype: Any = torch.bfloat16

    # Training controls: microbatches a step (train.trainstep), and
    # whether the layers' activations are recomputed in the backward pass
    # ("full": each layer under torch.utils.checkpoint) or kept ("none").
    grad_accum: int = 1
    remat: str = "full"          # full | none

    @property
    def d_head_total(self) -> int:
        return self.n_heads * self.head_dim
