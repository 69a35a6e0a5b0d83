"""Model assembly: parameters, embedding, unembedding, the MLP block
(dense or moe), and the ring-cache ``prefill``/``decode_step`` of the
dense, moe, vlm and ssm families (those branches of the JAX package's
``models/model.py``). The vlm family runs its text path: the stub
modality frontend (``frontend_embeds`` and the prefix-LM mask) is not
ported.

Parameters are a dict of tensors in the JAX package's pytree layout:
``embed``, ``final_norm``, optional ``unembed``, layer-stacked
``layers`` (every leaf has a leading ``[num_layers]`` axis) and an
optional ``layers_pre`` list (the moe family's leading dense layers).
The reference scans the stacked layers; the port loops over them
(``layer_params``).

KV caches are ring buffers of ``W`` slots (W = capacity, or the
attention window for sliding-window configs); ``kv_pos`` tracks
absolute positions so masks stay exact after wraparound. The reference
builds a new cache functionally; the port writes the cache it is given
in place and returns it. The dense prefill attends through the
``flash_prefill`` kernel, the ssm prefill scans through ``ssd_scan``;
the ring-cache decode attends with the plain ``gqa_attention`` over the
W slots, as the reference does outside any Pallas kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_prefill import flash_prefill
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod

# the leaves the reference keeps in f32 at any param_dtype: the mixer's
# and the moe router
F32_LEAVES = ("A_log", "D", "dt_bias", "router")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue 1 item 6)")


def _check_ported(cfg) -> None:
    """The ring-cache model serves the dense, moe, vlm and ssm
    families."""
    if cfg.family not in ("dense", "moe", "vlm", "ssm"):
        raise _not_ported(f"the {cfg.family} family")
    if cfg.mla is not None:
        raise _not_ported("mla attention")
    if cfg.attention_impl != "einsum":
        raise _not_ported(f"attention_impl={cfg.attention_impl!r}")


# ======================================================================
# parameters
# ======================================================================
def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _dense_layer_init(generator, cfg, dtype, device, *, d_ff=None,
                      moe_layer=False):
    zeros = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    p = {"ln1": zeros, "ln2": zeros.clone(),
         "attn": L.attn_init(generator, cfg, dtype, device)}
    if moe_layer:
        p["moe"] = moe_mod.moe_init(generator, cfg, dtype, device)
    else:
        p["mlp"] = L.mlp_init(generator, cfg.d_model, d_ff or cfg.d_ff,
                              cfg.mlp_kind, dtype, device)
    return p


def _ssm_layer_init(generator, cfg, dtype, device):
    return {"ln1": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
            "mixer": ssm_mod.mamba2_init(generator, cfg, dtype, device)}


def init_params(cfg, generator: torch.Generator, device):
    """Random weights for the dense, moe, vlm and ssm families, drawn
    from ``generator`` (which must live on ``device``) with the
    reference's schemes. The numbers differ from JAX's for the same
    seed; tests carry JAX's weights across with ``params_from_numpy``
    instead."""
    _check_ported(cfg)
    dtype = getattr(torch, cfg.param_dtype)
    params = {
        "embed": L.embed_init(generator, (cfg.vocab_size, cfg.d_model),
                              dtype, device),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype,
                                  device=device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L.dense_init(
            generator, (cfg.d_model, cfg.vocab_size), cfg.d_model, dtype,
            device)
    n = cfg.num_layers
    if cfg.family == "moe":
        # the leading dense layers (deepseek-v2 style), then moe layers
        nd = cfg.moe.first_dense_layers
        if nd:
            params["layers_pre"] = [
                _dense_layer_init(generator, cfg, dtype, device,
                                  d_ff=cfg.moe.d_ff_dense)
                for _ in range(nd)]
        params["layers"] = _stack([
            _dense_layer_init(generator, cfg, dtype, device, moe_layer=True)
            for _ in range(n - nd)])
        return params
    layer = _ssm_layer_init if cfg.family == "ssm" else _dense_layer_init
    params["layers"] = _stack([layer(generator, cfg, dtype, device)
                               for _ in range(n)])
    return params


def _to_tensor(a, device, dtype):
    a = np.array(a)                 # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        # numpy has no bfloat16: move the bits, then reinterpret
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree, device, dtype=None):
    """The JAX package's parameter pytree, as nested dicts (and the
    ``layers_pre`` list) of numpy arrays, to the same tree of tensors on
    ``device``. Floating leaves are cast to ``dtype`` when given, except
    the ``F32_LEAVES`` (the mixer's and the moe router), which stay f32
    as in the reference."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, torch.float32
                                     if dtype is not None
                                     and k in F32_LEAVES else dtype)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device, dtype) for v in tree]
    return _to_tensor(tree, device, dtype)


def layer_params(params):
    """Per-layer parameter dicts in execution order: the unstacked
    ``layers_pre`` first, then views into each slice of the stacked
    ``layers``."""
    stacked = params["layers"]
    return list(params.get("layers_pre", [])) + [
        _index(stacked, i) for i in range(stacked["ln1"].shape[0])]


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


# ======================================================================
# shared pieces
# ======================================================================
def _embed(cfg, params, tokens):
    x = params["embed"][tokens].to(cfg.activation_dtype())
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _logits(cfg, params, x):
    x = L.rms_norm(x, params["final_norm"], cfg.rms_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    logits = (x @ w.to(x.dtype)).float()
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def _mlp_block(cfg, lp, x):
    """The MLP half of a layer: dense, or the single-device moe (its aux
    loss, a training term, is dropped)."""
    h = L.rms_norm(x, lp["ln2"], cfg.rms_eps)
    if "moe" in lp:
        return x + moe_mod.moe_apply(lp["moe"], h, cfg)[0]
    return x + L.mlp_apply(lp["mlp"], h, cfg.mlp_kind)


# ======================================================================
# ring KV cache
# ======================================================================
def cache_window(cfg, capacity: int) -> int:
    if cfg.sliding_window is not None:
        return min(capacity, cfg.sliding_window)
    return capacity


def init_cache(cfg, batch: int, capacity: int, device):
    """An empty decode cache on ``device``: ring buffers of W slots
    (dense) or the conv caches and f32 SSM state (ssm)."""
    _check_ported(cfg)
    dtype = cfg.activation_dtype()
    cache = {"len": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if cfg.family == "ssm":
        cx_shape, cbc_shape, state_shape = ssm_mod.mamba2_state_shape(
            cfg, batch)
        L_ = cfg.num_layers
        cache["conv_x"] = torch.zeros((L_,) + cx_shape, dtype=dtype,
                                      device=device)
        cache["conv_bc"] = torch.zeros((L_,) + cbc_shape, dtype=dtype,
                                       device=device)
        cache["ssm_state"] = torch.zeros((L_,) + state_shape,
                                         dtype=torch.float32, device=device)
        return cache
    W = cache_window(cfg, capacity)
    shape = (cfg.num_layers, batch, W, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    cache["k"] = torch.zeros(shape, dtype=dtype, device=device)
    cache["v"] = torch.zeros(shape, dtype=dtype, device=device)
    cache["kv_pos"] = torch.full((batch, W), -1, dtype=torch.int32,
                                 device=device)
    return cache


def _ring_write(buf, slots, new):
    """buf [B, W, ...] written in place at slots [B, S] from new
    [B, S, ...]. Slot W marks a position outside the window or past the
    row's length: the reference drops it (``mode="drop"``); here it is
    masked out, so no out-of-range index reaches the write."""
    b, s = (slots < buf.shape[1]).nonzero(as_tuple=True)
    buf[b, slots[b, s]] = new[b, s].to(buf.dtype)
    return buf


def _decode_mask(cfg, q_pos, kv_pos, window):
    return L.attention_mask(q_pos, kv_pos, causal=True, window=window,
                            kv_valid=kv_pos >= 0)


# ======================================================================
# prefill
# ======================================================================
def prefill(cfg, params, tokens, cache, *, seq_lens=None, prefix_len=None,
            frontend_embeds=None, plain: bool = False):
    """Run the full prompt, fill the cache. Returns (last_logits [B, V],
    cache).

    Supports S > W (the ring keeps the last W positions). ``seq_lens``
    marks the true per-row prompt length (padded rows produce masked
    cache slots). The dense attention is ``flash_prefill`` with the
    causal (and window) mask: for every valid row this is the
    reference's masked ``gqa_attention`` exactly, since causality
    already hides every key past ``seq_lens``. ``plain`` (tests and the
    chip check only) runs the kernels' plain versions on any device, to
    hold the kernels' prefill against it; it is never a fallback."""
    if prefix_len is not None:
        raise _not_ported("prefix_len (the prefix-LM mask)")
    if frontend_embeds is not None:
        raise _not_ported("frontend_embeds (the stub modality frontend)")
    x = _embed(cfg, params, tokens)
    B, S, _ = x.shape
    dev = x.device
    if seq_lens is None:
        seq_lens = torch.full((B,), S, dtype=torch.int32, device=dev)
    positions = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    valid = positions < seq_lens[:, None]

    if cfg.family == "ssm":
        for i, lp in enumerate(layer_params(params)):
            h = L.rms_norm(x, lp["ln1"], cfg.rms_eps)
            y, (cxc, cbc, st) = ssm_mod.mamba2_forward(lp["mixer"], cfg, h,
                                                       plain=plain)
            x = x + y
            cache["conv_x"][i] = cxc
            cache["conv_bc"][i] = cbc
            cache["ssm_state"][i] = st
    else:
        W = cache["kv_pos"].shape[1]
        in_ring = (positions >= S - W) & valid
        # ring slots; positions outside the last-W window are dropped
        slots = torch.where(in_ring, positions % W, W)

        def write(buf, new):
            if W == S:
                # fresh full-capacity cache: position-aligned, no scatter
                buf.copy_(torch.where(valid[..., None, None], new,
                                      torch.zeros((), dtype=new.dtype,
                                                  device=dev)))
            else:
                _ring_write(buf, slots, new)

        attend = ref.flash_prefill_ref if plain else flash_prefill
        for i, lp in enumerate(layer_params(params)):
            h = L.rms_norm(x, lp["ln1"], cfg.rms_eps)
            q, k, v = L.attn_project_qkv(lp["attn"], cfg, h, positions)
            a = attend(q.transpose(1, 2).contiguous(),
                       k.transpose(1, 2).contiguous(),
                       v.transpose(1, 2).contiguous(), causal=True,
                       window=cfg.sliding_window)
            x = x + L.attn_output(lp["attn"], a.transpose(1, 2))
            write(cache["k"][i], k)
            write(cache["v"][i], v)
            x = _mlp_block(cfg, lp, x)
        kv_pos = torch.where(in_ring, positions, -1)
        if W == S:
            cache["kv_pos"].copy_(kv_pos)
        else:
            cache["kv_pos"].fill_(-1)
            _ring_write(cache["kv_pos"], slots, kv_pos)
    cache["len"].copy_(seq_lens)
    # only each row's last valid token's logits are returned; slice
    # before the unembed so prefill never materialises [B, S, V]
    last = (seq_lens.long() - 1).clamp(min=0)
    xl = x[torch.arange(B, device=dev), last]
    return _logits(cfg, params, xl[:, None])[:, 0], cache


# ======================================================================
# decode
# ======================================================================
def decode_step(cfg, params, tokens, cache):
    """tokens [B] -> (logits [B, V], cache). One AR step per sequence;
    the cache is written in place."""
    B = tokens.shape[0]
    x = _embed(cfg, params, tokens[:, None])
    q_pos = cache["len"][:, None]                       # [B, 1]

    if cfg.family == "ssm":
        for i, lp in enumerate(layer_params(params)):
            h = L.rms_norm(x, lp["ln1"], cfg.rms_eps)
            y, (cxc, cbc, st) = ssm_mod.mamba2_decode(
                lp["mixer"], cfg, h,
                (cache["conv_x"][i], cache["conv_bc"][i]),
                cache["ssm_state"][i])
            x = x + y
            cache["conv_x"][i] = cxc
            cache["conv_bc"][i] = cbc
            cache["ssm_state"][i] = st
    else:
        W = cache["kv_pos"].shape[1]
        slots = (q_pos % W).long()                      # [B, 1], < W
        rows = torch.arange(B, device=x.device)[:, None]
        cache["kv_pos"][rows, slots] = q_pos
        mask = _decode_mask(cfg, q_pos, cache["kv_pos"], cfg.sliding_window)
        for i, lp in enumerate(layer_params(params)):
            h = L.rms_norm(x, lp["ln1"], cfg.rms_eps)
            q, k, v = L.attn_project_qkv(lp["attn"], cfg, h, q_pos)
            kc, vc = cache["k"][i], cache["v"][i]
            kc[rows, slots] = k.to(kc.dtype)
            vc[rows, slots] = v.to(vc.dtype)
            a = L.gqa_attention(q, kc, vc, mask)
            x = x + L.attn_output(lp["attn"], a)
            x = _mlp_block(cfg, lp, x)
    cache["len"] += 1
    return _logits(cfg, params, x)[:, 0], cache
