"""deepseek-v2-236b — MoE with multi-head latent attention (MLA).

[arXiv:2405.04434; hf] 60L d_model=5120 128H d_ff(expert)=1536 vocab=102400,
MoE 160 routed experts top-6 + 2 shared; MLA kv_lora=512, q_lora=1536,
nope/v head 128, rope head 64. First layer is dense (d_ff=12288).
"""
from repro_torch.configs.registry import (
    MLAConfig, MoEConfig, ModelConfig, register)

CONFIG = register(ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,       # MLA: per-head K/V decompressed from shared latent
    head_dim=128,
    d_ff=12288,             # dense-layer FFN width
    vocab_size=102400,
    mlp_kind="swiglu",
    rope_theta=10_000.0,
    tie_embeddings=False,
    moe=MoEConfig(num_experts=160, top_k=6, num_shared_experts=2,
                  d_ff_expert=1536, capacity_factor=1.25,
                  first_dense_layers=1, d_ff_dense=12288),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  nope_head_dim=128, rope_head_dim=64, v_head_dim=128),
    source="arXiv:2405.04434",
))
