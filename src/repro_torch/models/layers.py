"""Core transformer layers as plain functions over parameter dicts of
tensors, in the JAX package's pytree layout (``[d, H, hd]`` projection
weights, ``1 + w`` RMSNorm scales) so weights carry across one to one.

``gqa_attention`` is the reference's einsum attention under a boolean
mask; the ring-cache decode uses it over the cache's W slots. Prefill
and the paged engine attend through the hand-written kernels in
``repro_torch.kernels``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


# ----------------------------------------------------------------- init
def _trunc_normal(generator, shape, device) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                       generator=generator)


def dense_init(generator, shape, in_axis_size, dtype, device):
    scale = 1.0 / math.sqrt(in_axis_size)
    return (_trunc_normal(generator, shape, device) * scale).to(dtype)


def embed_init(generator, shape, dtype, device):
    return _trunc_normal(generator, shape, device).to(dtype)


# ----------------------------------------------------------------- norms
def rms_norm(x, weight, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dt)


# ----------------------------------------------------------------- rope
def rope_freqs(head_dim: int, theta: float, device):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: [B, S, H, D]; positions: [B, S] (absolute). Halves, not
    interleaved pairs, with f32 angles."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                   # [D/2]
    angles = positions[..., None].float() * freqs            # [B,S,D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- attention
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def attention_mask(q_pos, kv_pos, *, causal: bool, window=None,
                   kv_valid=None):
    """Boolean [B, Sq, Skv] mask (True = attend). q_pos [B, Sq] and
    kv_pos [B, Skv] are absolute positions; ``window`` keeps
    ``q - k < window``."""
    q = q_pos[:, :, None]
    k = kv_pos[:, None, :]
    mask = torch.ones(torch.broadcast_shapes(q.shape, k.shape),
                      dtype=torch.bool, device=q_pos.device)
    if causal:
        mask = mask & (k <= q)
    if window is not None:
        mask = mask & (q - k < window)
    if kv_valid is not None:
        mask = mask & kv_valid[:, None, :]
    return mask


def gqa_attention(q, k, v, mask):
    """Grouped-query attention, q [B, Sq, Hq, D], k/v [B, Skv, Hkv, D],
    mask [B, Sq, Skv] bool -> [B, Sq, Hq, D]. Logits and softmax in f32
    (the reference's ``preferred_element_type``), probabilities cast to
    v's dtype for the value product."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          k.float()) / math.sqrt(D)
    logits = torch.where(mask[:, None, None], logits,
                         torch.tensor(NEG_INF, device=q.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(B, Sq, Hq, v.shape[-1])


# ----------------------------------------------------------------- mlp
def mlp_apply(params, x, kind: str):
    if kind in ("swiglu", "geglu"):
        gate = x @ params["w_gate"]
        act = F.silu(gate) if kind == "swiglu" \
            else F.gelu(gate, approximate="tanh")
        return (act * (x @ params["w_up"])) @ params["w_down"]
    if kind == "squared_relu":
        h = torch.square(F.relu(x @ params["w_up"]))
        return h @ params["w_down"]
    if kind == "gelu":
        h = F.gelu(x @ params["w_up"] + params["b_up"], approximate="tanh")
        return h @ params["w_down"] + params["b_down"]
    raise ValueError(f"unknown mlp kind {kind!r}")


def mlp_init(generator, d_model: int, d_ff: int, kind: str, dtype, device):
    def w(shape, fan_in):
        return dense_init(generator, shape, fan_in, dtype, device)

    if kind in ("swiglu", "geglu"):
        return {"w_gate": w((d_model, d_ff), d_model),
                "w_up": w((d_model, d_ff), d_model),
                "w_down": w((d_ff, d_model), d_ff)}
    if kind == "squared_relu":
        return {"w_up": w((d_model, d_ff), d_model),
                "w_down": w((d_ff, d_model), d_ff)}
    if kind == "gelu":
        return {"w_up": w((d_model, d_ff), d_model),
                "b_up": torch.zeros((d_ff,), dtype=dtype, device=device),
                "w_down": w((d_ff, d_model), d_ff),
                "b_down": torch.zeros((d_model,), dtype=dtype,
                                      device=device)}
    raise ValueError(kind)


# ----------------------------------------------------------------- attn block
def attn_init(generator, cfg, dtype, device):
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    p = {
        "wq": dense_init(generator, (d, hq, hd), d, dtype, device),
        "wk": dense_init(generator, (d, hkv, hd), d, dtype, device),
        "wv": dense_init(generator, (d, hkv, hd), d, dtype, device),
        "wo": dense_init(generator, (hq, hd, d), hq * hd, dtype, device),
    }

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    if cfg.qkv_bias:
        p["bq"], p["bk"], p["bv"] = zeros(hq, hd), zeros(hkv, hd), \
            zeros(hkv, hd)
    if cfg.qk_norm:
        p["q_norm"], p["k_norm"] = zeros(hd), zeros(hd)
    return p


def attn_project_qkv(params, cfg, x, positions):
    """Project, add the bias, norm, then rope. Returns q [B,S,Hq,D],
    k/v [B,S,Hkv,D]."""
    q = torch.einsum("bsd,dhe->bshe", x, params["wq"])
    k = torch.einsum("bsd,dhe->bshe", x, params["wk"])
    v = torch.einsum("bsd,dhe->bshe", x, params["wv"])
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.rms_eps)
        k = rms_norm(k, params["k_norm"], cfg.rms_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_output(params, out):
    return torch.einsum("bshe,hed->bsd", out, params["wo"])
