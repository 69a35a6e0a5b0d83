"""whisper-tiny — enc-dec audio backbone, conv frontend stubbed.

[arXiv:2212.04356; unverified] 4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865.
The modality frontend is a STUB: input_specs() provides precomputed frame
embeddings [B, num_frames, d_model] in place of the mel+conv stack.
"""
from repro_torch.configs.registry import EncoderConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-tiny",
    family="encdec",
    num_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    mlp_kind="gelu",
    tie_embeddings=True,
    rope_theta=10_000.0,
    encoder=EncoderConfig(num_layers=4, num_frames=1500),
    frontend="audio",
    frontend_len=0,     # frontend feeds the encoder, not the decoder prefix
    source="arXiv:2212.04356",
))
