"""Multi-head latent attention (DeepSeek-V2, arXiv:2405.04434): the port
of the JAX package's ``models/mla.py``.

Prefill decompresses the shared KV latent into per-head K/V and attends
causally through ``flash_prefill`` (its plain version on the CPU or
with ``plain``): q and k are ``[q_nope | q_rope]`` and ``[k_nope |
k_rope]`` at nope + rope columns, every head its own KV head (G 1), and
V, narrower, is padded with zero columns to that width and the output
cut back, which is exact (a zero column adds nothing to any other). The
kernel's scale, 1/sqrt(its head dim), is the reference's 1/sqrt(nope +
rope). For every valid row this is the reference's masked attention,
as the dense prefill's is (``models/model.py``). The training graph
attends through the masked ``gqa_attention``, as the reference does.

Decode uses the published absorption: W_uk is absorbed into the query
and W_uv into the output, so attention runs directly against the
``[B, W, kv_lora]`` latent ring and the ``[B, W, rope]`` shared rope
keys, in torch products, as the reference computes it outside any
Pallas kernel (f32 logits, the finite ``NEG_INF`` mask, softmax, the
probabilities cast to the cache's type before the latent product).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as C
from repro_torch.kernels import ref
from repro_torch.kernels.flash_prefill import flash_prefill
from repro_torch.models.layers import NEG_INF, apply_rope, dense_init, \
    gqa_attention, rms_norm


def mla_init(generator, cfg, dtype, device):
    """The reference's tree: the down/up projections ``w_dq [d, q_lora]``,
    ``w_uq [q_lora, H, nope + rope]``, ``w_dkv [d, kv_lora + rope]``,
    ``w_uk [kv_lora, H, nope]``, ``w_uv [kv_lora, H, v]``, ``wo [H, v,
    d]`` and the two latent norms' zero scales."""
    m = cfg.mla
    d, H = cfg.d_model, cfg.num_heads

    def w(shape, fan_in):
        return dense_init(generator, shape, fan_in, dtype, device)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=device)

    return {
        "w_dq": w((d, m.q_lora_rank), d),
        "q_norm": zeros(m.q_lora_rank),
        "w_uq": w((m.q_lora_rank, H, m.nope_head_dim + m.rope_head_dim),
                  m.q_lora_rank),
        "w_dkv": w((d, m.kv_lora_rank + m.rope_head_dim), d),
        "kv_norm": zeros(m.kv_lora_rank),
        "w_uk": w((m.kv_lora_rank, H, m.nope_head_dim), m.kv_lora_rank),
        "w_uv": w((m.kv_lora_rank, H, m.v_head_dim), m.kv_lora_rank),
        "wo": w((H, m.v_head_dim, d), H * m.v_head_dim),
    }


def _to_heads(t, mesh):
    """A latent every head reads, as it enters the head-sharded products
    of a mesh: through ``copy_to_model``, since each rank's gradient of
    it is its own heads' part (off a mesh: ``t``)."""
    return t if mesh is None else C.copy_to_model(t, mesh)


def _project_q(params, cfg, x, positions, mesh=None):
    """(q_nope [B, S, H, nope], q_rope [B, S, H, rope]); over a ``mesh``
    H is this rank's heads."""
    m = cfg.mla
    q_lat = rms_norm(x @ params["w_dq"], params["q_norm"], cfg.rms_eps)
    q = torch.einsum("bsr,rhe->bshe", _to_heads(q_lat, mesh),
                     params["w_uq"])
    q_nope = q[..., :m.nope_head_dim]
    q_rope = apply_rope(q[..., m.nope_head_dim:], positions, cfg.rope_theta)
    return q_nope, q_rope


def _project_kv_latent(params, cfg, x, positions):
    """(ckv [B, S, kv_lora], k_rope [B, S, rope]): the normed latent and
    the rope key every head shares."""
    m = cfg.mla
    kv = x @ params["w_dkv"]
    ckv = rms_norm(kv[..., :m.kv_lora_rank], params["kv_norm"], cfg.rms_eps)
    k_rope = apply_rope(kv[..., None, m.kv_lora_rank:], positions,
                        cfg.rope_theta)[:, :, 0]
    return ckv, k_rope


def mla_forward(params, cfg, x, positions, *, plain: bool = False,
                graph: str = "serve", mask=None, mesh=None,
                impl: str = "einsum"):
    """The prefill path (decompressed), causal (and windowed where the
    config has a window) over the S tokens of x [B, S, d]. Returns (out
    [B, S, d], (ckv, k_rope)). ``plain`` takes ``flash_prefill``'s plain
    version on any device. ``graph`` "train" attends as the reference's
    forward does, through ``gqa_attention`` under ``mask`` [B, S, S] at
    scale 1/sqrt(nope + rope), with V unpadded: the training graph, and
    a prefill under the prefix-LM mask, which the kernel lacks.

    ``mesh`` (the training graph over a mesh): ``w_uq``, ``w_uk``,
    ``w_uv`` and ``wo`` are this rank's heads' blocks, the latents
    (``q_lat``, ``ckv``, the shared ``k_rope``) enter their products
    through ``copy_to_model``, and ``out`` is this rank's heads' part
    of the sum, for the caller's ``reduce_from_model``.

    ``impl`` "surrogate" (the dry run's, on either graph): the
    reference's stand-in for the attention, the scaled queries' first
    ``v_head_dim`` columns plus each head's mean of V over the
    sequence."""
    m = cfg.mla
    q_nope, q_rope = _project_q(params, cfg, x, positions, mesh)
    ckv, k_rope = _project_kv_latent(params, cfg, x, positions)
    ckv_h = _to_heads(ckv, mesh)
    k_nope = torch.einsum("bsr,rhe->bshe", ckv_h, params["w_uk"])
    v = torch.einsum("bsr,rhe->bshe", ckv_h, params["w_uv"])
    H = q_nope.shape[2]
    qk_dim = m.nope_head_dim + m.rope_head_dim
    k_rope_h = _to_heads(k_rope, mesh)[:, :, None, :].expand(
        k_rope.shape[:2] + (H, m.rope_head_dim))
    if impl == "surrogate":
        q = torch.cat([q_nope, q_rope], dim=-1)
        out = q[..., :m.v_head_dim] * (1.0 / math.sqrt(qk_dim)) \
            + v.mean(dim=1, keepdim=True)
        out = torch.einsum("bshe,hed->bsd", out, params["wo"])
        return out, (ckv, k_rope)
    if graph == "train":
        out = gqa_attention(torch.cat([q_nope, q_rope], dim=-1),
                            torch.cat([k_nope, k_rope_h], dim=-1), v, mask,
                            scale=1.0 / math.sqrt(qk_dim))
        out = torch.einsum("bshe,hed->bsd", out, params["wo"])
        return out, (ckv, k_rope)
    if m.v_head_dim > qk_dim:
        raise ValueError(f"v_head_dim {m.v_head_dim} > nope + rope "
                         f"{qk_dim}: V cannot be padded to the kernel's D")
    # [B, H, S, D] for the kernel, V padded with zero columns to D
    q = torch.cat([q_nope, q_rope], dim=-1).transpose(1, 2).contiguous()
    k = torch.cat([k_nope, k_rope_h], dim=-1).transpose(1, 2).contiguous()
    v = F.pad(v, (0, qk_dim - m.v_head_dim)).transpose(1, 2).contiguous()
    attend = ref.flash_prefill_ref if plain else flash_prefill
    out = attend(q, k, v, causal=True, window=cfg.sliding_window)
    out = out[..., :m.v_head_dim].transpose(1, 2)
    out = torch.einsum("bshe,hed->bsd", out, params["wo"])
    return out, (ckv, k_rope)


def mla_decode(params, cfg, x, positions, ckv_cache, krope_cache, mask):
    """Absorbed decode of x [B, 1, d] at ``positions`` [B, 1] against the
    caches ``ckv_cache`` [B, W, kv_lora] and ``krope_cache`` [B, W,
    rope], which already hold this token's latents (the caller writes
    them, from ``_project_kv_latent``, as the reference's decode step
    does), under ``mask`` [B, 1, W]. Returns out [B, 1, d]."""
    m = cfg.mla
    q_nope, q_rope = _project_q(params, cfg, x, positions)
    scale = 1.0 / math.sqrt(m.nope_head_dim + m.rope_head_dim)
    # absorb W_uk into q: [B, 1, H, kv_lora]
    q_abs = torch.einsum("bqhe,rhe->bqhr", q_nope, params["w_uk"])
    logits = (torch.einsum("bqhr,bkr->bhqk", q_abs.float(),
                           ckv_cache.float())
              + torch.einsum("bqhe,bke->bhqk", q_rope.float(),
                             krope_cache.float())) * scale
    logits = torch.where(mask[:, None, :, :], logits,
                         torch.tensor(NEG_INF, device=logits.device))
    probs = torch.softmax(logits, dim=-1).to(ckv_cache.dtype)
    o_lat = torch.einsum("bhqk,bkr->bqhr", probs, ckv_cache)
    out = torch.einsum("bqhr,rhe->bqhe", o_lat, params["w_uv"])
    return torch.einsum("bshe,hed->bsd", out, params["wo"])
