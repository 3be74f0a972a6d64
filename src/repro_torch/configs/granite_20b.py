"""granite-20b [dense]: 52L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152.

GPT-BigCode-style code model: multi-query attention, GELU MLP (non-gated,
4x), LayerNorm. [arXiv:2405.04324]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite_20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab=49152,
    norm="layernorm",
    mlp_type="gelu",
    qkv_bias=True,
    rope_theta=10000.0,
)

SMOKE = ArchConfig(
    name="granite_20b_smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    head_dim=16,
    d_ff=256,
    vocab=256,
    norm="layernorm",
    mlp_type="gelu",
    qkv_bias=True,
    rope_theta=10000.0,
)
