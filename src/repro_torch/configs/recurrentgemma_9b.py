"""recurrentgemma-9b — RG-LRU + local attention hybrid, 1:2 pattern.

[arXiv:2402.19427; unverified] 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000. Block pattern repeats (rglru, rglru, local_attn); 38 layers =
12 full groups + 2 trailing recurrent blocks (matches the Griffin recipe).
"""
from repro_torch.configs.registry import (
    ModelConfig, RGLRUConfig, register)

CONFIG = register(ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    mlp_kind="geglu",
    embed_scale=True,
    rope_theta=10_000.0,
    tie_embeddings=True,
    rglru=RGLRUConfig(lru_width=4096, conv_width=4,
                      block_pattern=("rglru", "rglru", "local_attn"),
                      local_window=2048),
    source="arXiv:2402.19427",
))
