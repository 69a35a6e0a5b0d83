"""mamba2-1.3b — attention-free SSM with state-space duality (SSD).

[arXiv:2405.21060; unverified] 48L d_model=2048 d_ff=0 vocab=50280,
ssm_state=128, expand=2 (d_inner=4096), head_dim=64 (64 heads), conv=4.
"""
from repro_torch.configs.registry import ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=32,          # unused by the mixer; kept for API uniformity
    num_kv_heads=32,
    d_ff=0,
    vocab_size=50280,
    mlp_kind="gelu",
    tie_embeddings=True,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, num_groups=1,
                  conv_width=4, chunk_size=256),
    source="arXiv:2405.21060",
))
