"""qwen2.5-3b [dense]: 36L d_model=2048 16H (GQA kv=2) d_ff=11008 vocab=151936.

GQA with QKV bias, tied embeddings. [hf:Qwen/Qwen2.5-3B]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2_5_3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    head_dim=128,
    d_ff=11008,
    vocab=151936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1e6,
)

SMOKE = ArchConfig(
    name="qwen2_5_3b_smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=256,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1e6,
)
