"""paligemma-3b — SigLIP + gemma VLM; vision frontend stubbed.

[arXiv:2407.07726; hf] 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=257216.
The SigLIP tower is a STUB: input_specs() provides precomputed patch
embeddings [B, 256, d_model] prepended to the token sequence (prefix-LM mask
over the patch prefix, causal over text — matching the PaliGemma recipe).
"""
from repro_torch.configs.registry import ModelConfig, register

CONFIG = register(ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    mlp_kind="geglu",
    embed_scale=True,
    rope_theta=10_000.0,
    tie_embeddings=True,
    frontend="vision",
    frontend_len=256,
    source="arXiv:2407.07726",
))
