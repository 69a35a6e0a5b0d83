"""h2o-danube-1.8b — llama+mistral mix with sliding-window attention.

[arXiv:2401.16818; hf] 24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000.
"""
from repro_torch.configs.registry import ModelConfig, register

CONFIG = register(ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab_size=32000,
    mlp_kind="swiglu",
    sliding_window=4096,      # mistral-style SWA
    rope_theta=10_000.0,
    tie_embeddings=False,
    source="arXiv:2401.16818",
))
