"""nemotron-4-340b — dense GQA with squared-ReLU MLP.

[arXiv:2402.16819; unverified] 96L d_model=18432 96H (GQA kv=8) d_ff=73728
vocab=256000.
"""
from repro_torch.configs.registry import ModelConfig, register

CONFIG = register(ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    num_layers=96,
    d_model=18432,
    num_heads=96,
    num_kv_heads=8,
    head_dim=192,
    d_ff=73728,
    vocab_size=256000,
    mlp_kind="squared_relu",
    rope_theta=10_000.0,
    tie_embeddings=False,
    source="arXiv:2402.16819",
))
