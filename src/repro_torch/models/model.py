"""Model assembly for the paged engine: parameters, embedding, unembedding
and the dense MLP block (the dense branch of the JAX package's
``models/model.py``).

Parameters are a dict of tensors in the JAX package's pytree layout:
``embed``, ``final_norm``, optional ``unembed``, layer-stacked
``layers`` (every leaf has a leading ``[num_layers]`` axis) and an
optional ``layers_pre`` list. The reference scans the stacked layers;
the port loops over them (``layer_params``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import layers as L


# ======================================================================
# parameters
# ======================================================================
def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _dense_layer_init(generator, cfg, dtype, device):
    zeros = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    return {"ln1": zeros, "ln2": zeros.clone(),
            "attn": L.attn_init(generator, cfg, dtype, device),
            "mlp": L.mlp_init(generator, cfg.d_model, cfg.d_ff,
                              cfg.mlp_kind, dtype, device)}


def init_params(cfg, generator: torch.Generator, device):
    """Random weights for the dense family, drawn from ``generator``
    (which must live on ``device``) with the reference's truncated-normal
    scheme. The numbers differ from JAX's for the same seed; tests carry
    JAX's weights across with ``params_from_numpy`` instead."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r}: only the dense family is ported "
            "(ROADMAP queue 1 item 9)")
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
    params["layers"] = _stack([
        _dense_layer_init(generator, cfg, dtype, device)
        for _ in range(cfg.num_layers)])
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
    ``device``. Floating leaves are cast to ``dtype`` when given."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype)
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
    if "moe" in lp:
        raise NotImplementedError(
            "moe layers are not ported (ROADMAP queue 1 item 9)")
    h = L.rms_norm(x, lp["ln2"], cfg.rms_eps)
    return x + L.mlp_apply(lp["mlp"], h, cfg.mlp_kind)
