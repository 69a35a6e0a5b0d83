"""The yardstick's peaks and the operations and bytes of the work the
per-layer metrics divide by, computed from shapes.

``attention_least_s`` is ``chip_smoke.py::attention_bound`` at commit
197c0ec (its byte count: each valid row's Q read and out
written, the table entries it reaches and the K and V of its positions,
each once), taking the round's host arrays instead of device tensors.
"""
from __future__ import annotations

import math
from typing import Iterable, Tuple

PEAK_BF16_FLOP_S = 989e12   # NVIDIA H100 SXM, dense bf16 (data sheet)
HBM_BYTES_S = 3.35e12       # its HBM3 rate


def attention_least_s(rows: Iterable[Tuple[int, int]], Hq: int, Hkv: int,
                      D: int, page: int, elt: int = 2) -> float:
    """Least time of one ``paged_prefill_attention`` launch over rows of
    ``(q_start, n_valid)``: the larger of its bytes over the memory rate
    and its QK^T and PV multiply-adds over the bf16 peak. Padding rows
    and padding tokens are not counted."""
    rows = list(rows)
    nbytes = 2 * len(rows) * 4              # q_start, q_lens
    ops = 0
    for s, n in rows:
        if n <= 0:
            continue
        reach = s + n
        nbytes += 2 * n * Hq * D * elt      # q read, out written
        nbytes += math.ceil(reach / page) * 4
        nbytes += 2 * reach * Hkv * D * elt
        keys = n * (s + 1) + n * (n - 1) // 2
        ops += 4 * keys * D * Hq
    return max(nbytes / HBM_BYTES_S, ops / PEAK_BF16_FLOP_S)


def token_flops(model: dict, position: int) -> float:
    """Useful model FLOPs of one token at ``position`` through every
    layer: 2 x the matrix parameters it touches (the experts it is routed
    to, not all of them) plus QK^T and PV over its ``position + 1`` keys.
    The head is counted apart (``head_flops``): the program computes
    logits for one token a row."""
    d, hq = model["d_model"], model["num_heads"]
    hkv = model["num_kv_heads"]
    hd = model.get("head_dim") or d // hq
    attn = d * (hq + 2 * hkv) * hd + hq * hd * d
    moe = model.get("moe")
    if moe:
        mlp = moe["top_k"] * 3 * d * moe["d_ff_expert"] \
            + d * moe["num_experts"]
    else:
        mlp = 3 * d * model["d_ff"]
    ctx = 4 * hq * hd * (position + 1)
    return model["num_layers"] * (2 * (attn + mlp) + ctx)


def head_flops(model: dict) -> float:
    return 2 * model["d_model"] * model["vocab_size"]


def rows_flops(model: dict, rows: Iterable[Tuple[int, int]]) -> float:
    """Useful FLOPs of one fused round whose valid rows are
    ``(start, n_tokens)``."""
    at0 = token_flops(model, -1)            # a token's work with no keys
    per_key = token_flops(model, 0) - at0
    total = 0.0
    for s, n in rows:
        keys = n * (s + 1) + n * (n - 1) // 2
        total += n * at0 + keys * per_key + head_flops(model)
    return total


def moe_least_s(model: dict, tokens: int, kept: int, experts_hit: int,
                elt: int = 2) -> float:
    """Least time of one moe call: the weights of the experts that
    received tokens read once, the router read, the tokens read and the
    output written, against the kept (token, expert) pairs' FLOPs."""
    moe = model["moe"]
    d, f, E = model["d_model"], moe["d_ff_expert"], moe["num_experts"]
    nbytes = experts_hit * 3 * d * f * elt + d * E * 4 \
        + 2 * tokens * d * elt
    flops = kept * 2 * 3 * d * f + 2 * tokens * d * E
    return max(nbytes / HBM_BYTES_S, flops / PEAK_BF16_FLOP_S)
