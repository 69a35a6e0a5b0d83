"""qwen3-4b — dense GQA with qk_norm.

[hf:Qwen/Qwen3-8B family; hf] 36L d_model=2560 32H (GQA kv=8) d_ff=9728
vocab=151936. Qwen3 uses an explicit head_dim=128 (> d_model/num_heads).
"""
from repro_torch.configs.registry import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-4b",
    family="dense",
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    mlp_kind="swiglu",
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    source="hf:Qwen/Qwen3-8B",
))
