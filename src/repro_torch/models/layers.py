"""Core transformer layers as plain functions over parameter dicts of
tensors, in the JAX package's pytree layout (``[d, H, hd]`` projection
weights, ``1 + w`` RMSNorm scales) so weights carry across one to one.

``gqa_attention`` is the reference's einsum attention under a boolean
mask (or, for the dry run, its surrogate); the ring-cache decode uses
it over the cache's W slots, and the training graph
(``models/model.py::forward``) and a prefix-LM prefill over their
whole sequence, as the reference does. Prefill and the paged
engine attend through the hand-written kernels in
``repro_torch.kernels``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as C


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
def rms_norm(x, weight, eps: float = 1e-6, *, mesh=None):
    """``mesh``: x's last dim (and ``weight``) is this rank's part of a
    dim sharded over 'model'; the mean of squares is the whole dim's,
    its sum taken over 'model' both ways (``sum_over_model``)."""
    dt = x.dtype
    x = x.float()
    if mesh is None:
        var = x.square().mean(dim=-1, keepdim=True)
    else:
        var = C.sum_over_model(x.square().sum(dim=-1, keepdim=True),
                               mesh) / (x.shape[-1] * mesh.model)
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


def sinusoidal_positions(length: int, d_model: int, device):
    """The encoder's fixed positions [length, d_model] f32: sines of
    ``pos / 10000^(2i / d)`` then their cosines."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d_model, 2, dtype=torch.float32,
                       device=device)[None, :]
    angle = pos / torch.pow(10000.0, dim / d_model)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


# ----------------------------------------------------------------- attention
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def attention_mask(q_pos, kv_pos, *, causal: bool, window=None,
                   kv_valid=None, prefix_len=None):
    """Boolean [B, Sq, Skv] mask (True = attend). q_pos [B, Sq] and
    kv_pos [B, Skv] are absolute positions; ``window`` keeps
    ``q - k < window``; ``prefix_len`` [B] is the prefix-LM boundary:
    bidirectional within the prefix, causal after it."""
    q = q_pos[:, :, None]
    k = kv_pos[:, None, :]
    mask = torch.ones(torch.broadcast_shapes(q.shape, k.shape),
                      dtype=torch.bool, device=q_pos.device)
    if causal:
        c = k <= q
        if prefix_len is not None:
            c = c | (k < prefix_len[:, None, None])
        mask = mask & c
    if window is not None:
        mask = mask & (q - k < window)
    if kv_valid is not None:
        mask = mask & kv_valid[:, None, :]
    return mask


def gqa_attention(q, k, v, mask, *, scale=None, impl: str = "einsum"):
    """Grouped-query attention, q [B, Sq, Hq, D], k/v [B, Skv, Hkv, D]
    (v may be narrower), mask [B, Sq, Skv] bool -> [B, Sq, Hq, Dv].
    Logits and softmax in f32 (the reference's
    ``preferred_element_type``), probabilities cast to v's dtype for the
    value product. ``scale`` defaults to 1/sqrt(D).

    ``impl`` "surrogate" is the reference's stand-in for the S^2 logits
    chain, which only streams Q, K, V and O: each KV head's mean of
    ``k + v`` over the keys added to the scaled queries of its group
    (the mask unread). The dry run traces it to see a cell's load
    without attention's; no card path takes it."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    if impl == "surrogate":
        s = 1.0 / math.sqrt(D) if scale is None else scale
        kv = (k + v).mean(dim=1, keepdim=True)                # reads K+V
        out = q * torch.tensor(s, dtype=q.dtype) \
            + kv.repeat_interleave(G, dim=2)                  # reads Q
        Dv = v.shape[-1]
        return out.reshape(B, Sq, Hq, Dv) if D == Dv \
            else out[..., :1].expand(B, Sq, Hq, Dv)
    if impl != "einsum":
        raise ValueError(f"unknown attention impl {impl!r}")
    qg = q.reshape(B, Sq, Hkv, G, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    logits = logits / math.sqrt(D) if scale is None else logits * scale
    logits = logits.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(B, Sq, Hq, v.shape[-1])


# ----------------------------------------------------------------- mlp
def mlp_apply(params, x, kind: str, *, out_bias: bool = True):
    """``out_bias`` False leaves the gelu kind's ``b_down`` out."""
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
        y = h @ params["w_down"]
        return y + params["b_down"] if out_bias else y
    raise ValueError(f"unknown mlp kind {kind!r}")


def mlp_tp(params, x, kind: str, mesh):
    """``mlp_apply`` with ``d_ff`` sharded over the mesh's 'model' axis
    (``w_gate``/``w_up``'s columns, ``w_down``'s rows, ``b_up``): x
    enters through ``copy_to_model`` and the partial outputs sum
    through ``reduce_from_model``. The gelu kind's output bias
    ``b_down``, held whole, is added once, after the sum."""
    y = C.reduce_from_model(mlp_apply(params, C.copy_to_model(x, mesh),
                                      kind, out_bias=False), mesh)
    return y + params["b_down"] if "b_down" in params else y


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
def attn_init(generator, cfg, dtype, device, *, d_model=None, mha=False):
    """``mha``: as many KV heads as query heads (whisper's
    cross-attention)."""
    d = d_model or cfg.d_model
    hd = cfg.resolved_head_dim
    hq = cfg.num_heads
    hkv = hq if mha else cfg.num_kv_heads
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


def attn_project_qkv(params, cfg, x, positions, *, rope=True):
    """Project, add the bias, norm, then rope (unless ``rope`` is False:
    the encoder's positions are added to its input). Returns q
    [B,S,Hq,D], k/v [B,S,Hkv,D]."""
    q = torch.einsum("bsd,dhe->bshe", x, params["wq"])
    k = torch.einsum("bsd,dhe->bshe", x, params["wk"])
    v = torch.einsum("bsd,dhe->bshe", x, params["wv"])
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.rms_eps)
        k = rms_norm(k, params["k_norm"], cfg.rms_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_output(params, out):
    return torch.einsum("bshe,hed->bsd", out, params["wo"])
