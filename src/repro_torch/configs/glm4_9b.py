"""glm4-9b [dense]: 40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552.

RoPE (partial rotary 0.5, GLM convention), GQA, qkv bias.
[hf:THUDM/glm-4-9b]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="glm4_9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab=151552,
    qkv_bias=True,
    rope_theta=10000.0,
    rope_fraction=0.5,
    # kv=2 doesn't divide 16: replicate kv heads, shard q heads.
)

SMOKE = ArchConfig(
    name="glm4_9b_smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=256,
    qkv_bias=True,
    rope_theta=10000.0,
    rope_fraction=0.5,
)
