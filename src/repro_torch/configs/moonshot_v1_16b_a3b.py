"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (kv=16) d_ff=1408(expert)
vocab=163840, MoE 64 routed experts top-6 (kimi/moonlight lineage).

DeepSeek-style: 2 shared experts and a dense first layer (d_ff 11264)
are included per the Moonlight reference implementation.
[hf:moonshotai/Moonlight-16B-A3B]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="moonshot_v1_16b_a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=11264,              # dense first layer
    vocab=163840,
    n_experts=64,
    top_k=6,
    n_shared_experts=2,
    moe_d_ff=1408,
    first_dense=1,
    rope_theta=50000.0,
)

SMOKE = ArchConfig(
    name="moonshot_v1_16b_a3b_smoke",
    family="moe",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=160,
    vocab=256,
    n_experts=8,
    top_k=2,
    n_shared_experts=1,
    moe_d_ff=32,
    first_dense=1,
    rope_theta=50000.0,
)
