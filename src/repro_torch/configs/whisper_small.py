"""whisper-small [audio]: 12L d_model=768 12H (kv=12) d_ff=3072 vocab=51865.

Encoder-decoder with a conv audio frontend. The frontend is a STUB: the
caller provides precomputed 1500-frame encoder embeddings
(``lm.forward(..., enc_embeds=...)``). Whisper's learned decoder positions
(max 448) are replaced by RoPE, as in the JAX package's config.
[arXiv:2212.04356]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper_small",
    family="audio",
    n_layers=12,            # decoder layers
    n_enc_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab=51865,
    norm="layernorm",
    mlp_type="gelu",
    qkv_bias=True,
    pos_embedding="rope",
    rope_theta=10000.0,
    is_encdec=True,
    enc_seq=1500,
    tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="whisper_small_smoke",
    family="audio",
    n_layers=2,
    n_enc_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab=256,
    norm="layernorm",
    mlp_type="gelu",
    qkv_bias=True,
    pos_embedding="rope",
    rope_theta=10000.0,
    is_encdec=True,
    enc_seq=32,
    tie_embeddings=True,
)
