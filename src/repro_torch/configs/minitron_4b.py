"""minitron-4b [dense]: 32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000.

Pruned Nemotron: squared-ReLU MLP (non-gated), partial rotary 0.5.
[arXiv:2407.14679]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="minitron_4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab=256000,
    mlp_type="relu2",
    rope_theta=10000.0,
    rope_fraction=0.5,
    # 24 q heads / 8 kv heads don't divide 16: replicate attention heads.
)

SMOKE = ArchConfig(
    name="minitron_4b_smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=256,
    mlp_type="relu2",
    rope_theta=10000.0,
    rope_fraction=0.5,
)
