"""deepseek-v2-236b [moe]: 60L d_model=5120 128H d_ff=1536(expert) vocab=102400.

MLA with kv_lora=512 (q_lora=1536, nope/rope head dims 128/64, v=128);
MoE with 2 shared + 160 routed experts, top-6; the first layer is dense
(d_ff 12288, per the DeepSeek-V2 reference). [arXiv:2405.04434]

The JAX config's ``rules_override`` (its 2-axis expert sharding) has no
counterpart here: the port has no mesh.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek_v2_236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    head_dim=192,            # qk_nope + qk_rope
    d_ff=12288,              # dense layers
    vocab=102400,
    attn_kind="mla",
    q_lora=1536,
    kv_lora=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    n_experts=160,
    top_k=6,
    n_shared_experts=2,
    moe_d_ff=1536,
    first_dense=1,
    rope_theta=10000.0,
    grad_accum=8,            # fit activations at 1M tokens/step
)

SMOKE = ArchConfig(
    name="deepseek_v2_236b_smoke",
    family="moe",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=24,
    d_ff=160,
    vocab=256,
    attn_kind="mla",
    q_lora=32,
    kv_lora=16,
    qk_nope_dim=16,
    qk_rope_dim=8,
    v_head_dim=16,
    n_experts=8,
    top_k=2,
    n_shared_experts=1,
    moe_d_ff=32,
    first_dense=1,
    rope_theta=10000.0,
)
