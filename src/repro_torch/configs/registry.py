"""Architecture config registry.

One dataclass family describes every assigned architecture; each
``configs/<id>.py`` instantiates the exact published config and registers it.
``reduced()`` derives the CPU-smoke-test variant of the same family.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    num_shared_experts: int = 0
    d_ff_expert: int = 0            # per-expert FFN width
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    first_dense_layers: int = 0     # leading dense layers (deepseek-v2 style)
    d_ff_dense: int = 0             # FFN width of those dense layers


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int
    kv_lora_rank: int
    nope_head_dim: int
    rope_head_dim: int
    v_head_dim: int


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128
    head_dim: int = 64
    expand: int = 2
    num_groups: int = 1
    conv_width: int = 4
    chunk_size: int = 256


@dataclass(frozen=True)
class RGLRUConfig:
    lru_width: int = 0              # 0 -> d_model
    conv_width: int = 4
    block_pattern: Tuple[str, ...] = ("rglru", "rglru", "local_attn")
    local_window: int = 2048


@dataclass(frozen=True)
class EncoderConfig:
    num_layers: int
    num_frames: int                 # stub-frontend sequence length
    d_model: int = 0                # 0 -> same as decoder d_model


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads
    mlp_kind: str = "swiglu"        # swiglu | squared_relu | geglu | gelu
    qk_norm: bool = False
    qkv_bias: bool = False
    sliding_window: Optional[int] = None
    rope_theta: float = 1_000_000.0
    rms_eps: float = 1e-6
    tie_embeddings: bool = True
    logit_softcap: Optional[float] = None
    embed_scale: bool = False       # gemma-style sqrt(d) embedding scale
    # Sub-family configs
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    encoder: Optional[EncoderConfig] = None
    # Modality frontend (STUB: input_specs provides precomputed embeddings)
    frontend: Optional[str] = None  # audio | vision
    frontend_len: int = 0           # frames/patches prepended to the sequence
    # Attention lowering: einsum | surrogate (perf-pass, see
    # layers.gqa_attention docstring)
    attention_impl: str = "einsum"
    # Numerics
    param_dtype: str = "bfloat16"
    dtype: str = "bfloat16"
    # Reference for provenance
    source: str = ""

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True if long_500k decode is tractable (bounded per-token state)."""
        return (
            self.family in ("ssm", "hybrid")
            or self.sliding_window is not None
        )

    def activation_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def num_params(self) -> int:
        """Analytic parameter count (total, incl. all experts)."""
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        hd = self.resolved_head_dim
        total = V * d  # embed
        if not self.tie_embeddings:
            total += V * d
        for layer in range(L):
            total += self._layer_params(layer)
        if self.encoder is not None:
            ed = self.encoder.d_model or d
            # encoder self-attn (MHA) + MLP per layer
            per = 4 * ed * ed + 2 * ed * self.d_ff + 4 * ed
            total += self.encoder.num_layers * per
        return total

    def num_active_params(self) -> int:
        """Params touched per token (MoE: only routed top-k + shared)."""
        if self.moe is None:
            return self.num_params()
        m = self.moe
        d, L = self.d_model, self.num_layers
        expert = 3 * d * m.d_ff_expert  # swiglu expert
        moe_layers = L - m.first_dense_layers
        inactive = moe_layers * (m.num_experts - m.top_k) * expert
        return self.num_params() - inactive

    def _layer_params(self, layer: int) -> int:
        d = self.d_model
        hd = self.resolved_head_dim
        n = 0
        # attention / mixer
        if self.family == "ssm":
            s = self.ssm
            d_in = d * s.expand
            n += d * (2 * d_in + 2 * s.num_groups * s.state_dim + d_in // s.head_dim)
            n += d_in * d  # out proj
            n += s.conv_width * (d_in + 2 * s.num_groups * s.state_dim)
        elif self.family == "hybrid" and self._block_kind(layer) == "rglru":
            r = self.rglru
            w = r.lru_width or d
            n += 2 * d * w + w * d + 2 * w * w + r.conv_width * w + 2 * w
        elif self.mla is not None:
            m = self.mla
            H = self.num_heads
            n += d * m.q_lora_rank + m.q_lora_rank * H * (m.nope_head_dim + m.rope_head_dim)
            n += d * (m.kv_lora_rank + m.rope_head_dim)
            n += m.kv_lora_rank * H * (m.nope_head_dim + m.v_head_dim)
            n += H * m.v_head_dim * d
        else:
            n += d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
            n += self.num_heads * hd * d
        # mlp
        if self.moe is not None and layer >= self.moe.first_dense_layers:
            m = self.moe
            n += d * m.num_experts  # router
            n += (m.num_experts + m.num_shared_experts) * 3 * d * m.d_ff_expert
        elif self.moe is not None:
            n += 3 * d * self.moe.d_ff_dense
        elif self.family == "ssm":
            pass  # mamba2 has no separate MLP
        elif self.family == "hybrid" and self._block_kind(layer) == "rglru":
            n += 3 * d * self.d_ff
        else:
            mults = {"swiglu": 3, "geglu": 3, "squared_relu": 2, "gelu": 2}
            n += mults[self.mlp_kind] * d * self.d_ff
        return n

    def _block_kind(self, layer: int) -> str:
        if self.family != "hybrid":
            return "attn"
        pat = self.rglru.block_pattern
        return pat[layer % len(pat)]

    def block_kinds(self) -> Tuple[str, ...]:
        return tuple(self._block_kind(i) for i in range(self.num_layers))

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ----------------------------------------------------------------------
_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded() -> None:
    if _REGISTRY:
        return
    # every config of the JAX package, as data
    from repro_torch.configs import (  # noqa: F401
        whisper_tiny, h2o_danube_1_8b, qwen3_4b, nemotron_4_340b,
        qwen2_1_5b, recurrentgemma_9b, mamba2_1_3b, deepseek_v2_236b,
        phi3_5_moe, paligemma_3b,
    )


def reduced(cfg: ModelConfig, *, layers: int = 2, d_model: int = 64,
            vocab: int = 256) -> ModelConfig:
    """Smoke-test variant: same family/feature set, tiny dims."""
    heads = min(cfg.num_heads, 4)
    kv = max(1, min(cfg.num_kv_heads, heads))
    while heads % kv:
        kv -= 1
    kw: dict = dict(
        name=cfg.name + "-reduced",
        num_layers=layers,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=max(8, d_model // heads),
        d_ff=d_model * 3,
        vocab_size=vocab,
        sliding_window=16 if cfg.sliding_window else None,
        param_dtype="float32",
        dtype="float32",
        frontend_len=8 if cfg.frontend else 0,
    )
    if cfg.moe:
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=2,
            num_shared_experts=min(cfg.moe.num_shared_experts, 1),
            d_ff_expert=d_model * 2,
            first_dense_layers=min(cfg.moe.first_dense_layers, 1),
            d_ff_dense=d_model * 2 if cfg.moe.first_dense_layers else 0)
    if cfg.mla:
        kw["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=32,
                              nope_head_dim=16, rope_head_dim=8, v_head_dim=16)
    if cfg.ssm:
        kw["ssm"] = dataclasses.replace(cfg.ssm, state_dim=16, head_dim=16,
                                        chunk_size=16)
    if cfg.rglru:
        kw["rglru"] = dataclasses.replace(cfg.rglru, lru_width=d_model,
                                          local_window=16)
        kw["num_layers"] = 3  # one full (rglru, rglru, local_attn) group
    if cfg.encoder:
        kw["encoder"] = EncoderConfig(num_layers=2, num_frames=16)
    return cfg.replace(**kw)
