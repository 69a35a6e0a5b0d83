"""phi3.5-moe-42b-a6.6b — 16-expert top-2 MoE.

[hf:microsoft/Phi-3.5-MoE-instruct; hf] 32L d_model=4096 32H (GQA kv=8)
d_ff(expert)=6400 vocab=32064, MoE 16e top-2.
"""
from repro_torch.configs.registry import MoEConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab_size=32064,
    mlp_kind="swiglu",
    rope_theta=10_000.0,
    tie_embeddings=False,
    moe=MoEConfig(num_experts=16, top_k=2, num_shared_experts=0,
                  d_ff_expert=6400, capacity_factor=1.25),
    source="hf:microsoft/Phi-3.5-MoE-instruct",
))
