"""The benchmark's weights: made on the device from ``--seed``, in one
canonical layout, and handed as the same tensors to the port and to the
reference.

The layout is the tree the port's model reads (``[d, H, hd]``
projections, ``1 + w`` RMSNorm scales, per-layer leaves stacked along a
leading layer axis, the moe router in f32). The scales are the usual
variance-preserving ones: a matrix N(0, 1 / fan_in), a norm scale
``1 + w`` with w N(0, 0.1^2), and the embedding N(0, s^2) with ``s``
from the configuration file's ``weights.embed_std`` (1 by default; a
tied head scores each input token ``s^2 d`` above the rest, so a tied
configuration draws it small, or its model only repeats its input). Every leaf of the
serving type is a view of one flat buffer filled by a single ``normal_``
call from a ``torch.Generator`` on the device, and the f32 leaves of a
second one; each leaf is then scaled in place. So the weights cost a
few large launches, not one per leaf, and never touch the host.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

NORM_STD = 0.1              # the norm scales' ``w`` in ``1 + w``


def leaf_shapes(model: dict, embed_std: float = 1.0
                ) -> List[Tuple[str, tuple, str, float]]:
    """(path, shape, kind, std) of every leaf; kind is ``w`` (a matrix
    in the serving type), ``n`` (a norm scale in the serving type) or
    ``f32`` (a matrix kept in f32)."""
    L, d = model["num_layers"], model["d_model"]
    hq, hkv = model["num_heads"], model["num_kv_heads"]
    hd = model.get("head_dim") or d // hq
    V = model["vocab_size"]
    n, s_d = NORM_STD, d ** -0.5
    out = [("embed", (V, d), "w", embed_std), ("final_norm", (d,), "n", n)]
    if not model.get("tie_embeddings", True):
        out.append(("unembed", (d, V), "w", s_d))
    out += [("layers/ln1", (L, d), "n", n), ("layers/ln2", (L, d), "n", n),
            ("layers/attn/wq", (L, d, hq, hd), "w", s_d),
            ("layers/attn/wk", (L, d, hkv, hd), "w", s_d),
            ("layers/attn/wv", (L, d, hkv, hd), "w", s_d),
            ("layers/attn/wo", (L, hq, hd, d), "w", (hq * hd) ** -0.5)]
    if model.get("qk_norm"):
        out += [("layers/attn/q_norm", (L, hd), "n", n),
                ("layers/attn/k_norm", (L, hd), "n", n)]
    moe = model.get("moe")
    if moe:
        E, f = moe["num_experts"], moe["d_ff_expert"]
        out += [("layers/moe/router", (L, d, E), "f32", s_d),
                ("layers/moe/w_gate", (L, E, d, f), "w", s_d),
                ("layers/moe/w_up", (L, E, d, f), "w", s_d),
                ("layers/moe/w_down", (L, E, f, d), "w", f ** -0.5)]
    else:
        f = model["d_ff"]
        out += [("layers/mlp/w_gate", (L, d, f), "w", s_d),
                ("layers/mlp/w_up", (L, d, f), "w", s_d),
                ("layers/mlp/w_down", (L, f, d), "w", f ** -0.5)]
    return out


def count(model: dict) -> int:
    n = 0
    for _, shape, _, _ in leaf_shapes(model):
        k = 1
        for s in shape:
            k *= s
        n += k
    return n


def _put(tree: dict, path: str, t: torch.Tensor) -> None:
    *parents, leaf = path.split("/")
    for p in parents:
        tree = tree.setdefault(p, {})
    tree[leaf] = t


def make(model: dict, seed: int, device, embed_std: float = 1.0) -> Dict:
    """The weight tree of ``model`` (the config file's ``model`` block)
    for ``seed``, on ``device``."""
    dtype = getattr(torch, model.get("param_dtype", "bfloat16"))
    shapes = leaf_shapes(model, embed_std)

    def numel(shape):
        k = 1
        for s in shape:
            k *= s
        return k
    n_main = sum(numel(s) for _, s, kind, _ in shapes if kind != "f32")
    n_f32 = sum(numel(s) for _, s, kind, _ in shapes if kind == "f32")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    main = torch.empty(n_main, dtype=dtype, device=device)
    main.normal_(0.0, 1.0, generator=gen)
    f32 = torch.empty(n_f32, dtype=torch.float32, device=device)
    if n_f32:
        f32.normal_(0.0, 1.0, generator=gen)
    tree: Dict = {}
    o_main = o_f32 = 0
    for path, shape, kind, std in shapes:
        k = numel(shape)
        if kind == "f32":
            t = f32[o_f32:o_f32 + k].view(shape)
            o_f32 += k
        else:
            t = main[o_main:o_main + k].view(shape)
            o_main += k
        if std != 1.0:
            t.mul_(std)
        _put(tree, path, t)
    return tree
