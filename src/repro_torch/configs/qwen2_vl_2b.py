"""qwen2-vl-2b [vlm]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.

M-RoPE (temporal/height/width rotary sections 16/24/24), dynamic-resolution
vision frontend STUBBED: the caller provides precomputed patch embeddings
mixed into the token stream (``lm.forward(..., embeds=...)``); positions
are the (3, B, S) M-RoPE ids. [arXiv:2409.12191]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2_vl_2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab=151936,
    qkv_bias=True,
    tie_embeddings=True,
    pos_embedding="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1e6,
)

SMOKE = ArchConfig(
    name="qwen2_vl_2b_smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=256,
    qkv_bias=True,
    tie_embeddings=True,
    pos_embedding="mrope",
    mrope_sections=(4, 2, 2),
    rope_theta=1e6,
)
