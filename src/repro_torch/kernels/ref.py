"""Plain PyTorch versions of the kernels.

Deliberately naive (pages gathered into a dense sequence, logits
materialised, the SSD recurrence run token by token): slow but
obviously right. The attention kernels' wrappers take them for CPU
tensors, and the kernels are held against them on the card; the SSD
scan's plain version is the model's own ``models.ssm.ssd_chunked``,
and ``ssd_scan_ref`` is the oracle both are tested against. They
mirror ``repro.kernels.ref`` of the JAX package, including its finite
``NEG_INF`` sentinel and its zeroed padding rows.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
SPAN_KEYS = 128   # keys per span of the paged kernels' sequence split


def _gather(pages, block_tables):
    """[P, page, Hkv, D] pages through [B, pps] tables -> [B, pps*page,
    Hkv, D] in f32."""
    B, pps = block_tables.shape
    _, page, Hkv, D = pages.shape
    return pages[block_tables.long()].reshape(B, pps * page, Hkv, D).float()


def paged_attention_ref(q, k_pages, v_pages, block_tables, seq_lens):
    """Decode attention over paged KV.

    q [B, Hq, D]; k_pages/v_pages [P, page, Hkv, D];
    block_tables [B, pages_per_seq] int32; seq_lens [B] int32.
    """
    B, Hq, D = q.shape
    Hkv = k_pages.shape[2]
    G = Hq // Hkv
    k = _gather(k_pages, block_tables)
    v = _gather(v_pages, block_tables)
    pos = torch.arange(k.shape[1], device=q.device)
    valid = pos[None, :] < seq_lens.long()[:, None]
    qg = q.reshape(B, Hkv, G, D).float()
    logits = torch.einsum("bhgd,bshd->bhgs", qg, k) / math.sqrt(D)
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v)
    return out.reshape(B, Hq, D).to(q.dtype)


def paged_prefill_attention_ref(q, k_pages, v_pages, block_tables,
                                q_start, q_lens):
    """Fused multi-token-query attention over paged KV.

    q [B, Q, Hq, D]; k_pages/v_pages [P, page, Hkv, D];
    block_tables [B, pages_per_seq] int32; q_start/q_lens [B] int32.
    Query token t of row b attends causally over global positions
    <= q_start[b] + t; tokens t >= q_lens[b] are padding (zeroed here so
    the result is deterministic; callers discard them).
    """
    B, Q, Hq, D = q.shape
    Hkv = k_pages.shape[2]
    G = Hq // Hkv
    k = _gather(k_pages, block_tables)
    v = _gather(v_pages, block_tables)
    pos = torch.arange(k.shape[1], device=q.device)
    t = torch.arange(Q, device=q.device)
    limit = q_start.long()[:, None] + t[None, :]               # [B, Q]
    valid = pos[None, None, :] <= limit[:, :, None]            # [B, Q, S]
    valid &= (t[None, :] < q_lens.long()[:, None])[:, :, None]
    qg = q.reshape(B, Q, Hkv, G, D).float()
    logits = torch.einsum("bqhgd,bshd->bhgqs", qg, k) / math.sqrt(D)
    logits = torch.where(valid[:, None, None], logits,
                         torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqs,bshd->bqhgd", p, v)
    out = torch.where(valid.any(-1)[..., None, None, None], out,
                      torch.zeros((), device=q.device))
    return out.reshape(B, Q, Hq, D).to(q.dtype)


def paged_span_partials(q, k_pages, v_pages, block_tables, q_start,
                        q_lens, span: int = SPAN_KEYS):
    """The paged kernels' sequence split, per span: the unnormalised
    softmax partials of each query row over the keys of each fixed span
    ``[s * span, (s + 1) * span)``, counted from position 0.

    Shapes as ``paged_prefill_attention_ref``. Returns o [B, Q, Hq,
    nspan, D] (sum of p * v), m and l [B, Q, Hq, nspan] (the span's
    running max and sum of p), f32. A span past a row's limit, and every
    span of a padding row, has m = NEG_INF, l = 0 and o = 0.
    """
    B, Q, Hq, D = q.shape
    Hkv = k_pages.shape[2]
    G = Hq // Hkv
    k = _gather(k_pages, block_tables)
    v = _gather(v_pages, block_tables)
    S = k.shape[1]
    nspan = -(-S // span)
    pad = nspan * span - S
    pos = torch.arange(S, device=q.device)
    t = torch.arange(Q, device=q.device)
    limit = q_start.long()[:, None] + t[None, :]                 # [B, Q]
    live = t[None, :] < q_lens.long()[:, None]                   # [B, Q]
    qg = q.reshape(B, Q, Hkv, G, D).float()
    logits = torch.einsum("bqhgd,bshd->bqhgs", qg, k) / math.sqrt(D)
    valid = pos[None, None, :] <= limit[:, :, None]              # [B, Q, S]
    logits = torch.where(valid[:, :, None, None], logits,
                         torch.tensor(NEG_INF, device=q.device))
    # keys past the table: no such key, weight exactly 0
    logits = torch.nn.functional.pad(logits, (0, pad), value=-math.inf)
    logits = logits.reshape(B, Q, Hkv, G, nspan, span)
    vs = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    vs = vs.reshape(B, nspan, span, Hkv, D)
    m = logits.amax(-1)
    p = torch.exp(logits - m[..., None])
    l = p.sum(-1)
    o = torch.einsum("bqhgns,bnshd->bqhgnd", p, vs)
    starts = torch.arange(nspan, device=q.device) * span
    empty = (limit[:, :, None] < starts) | ~live[:, :, None]     # [B, Q, n]
    empty = empty[:, :, None, None]
    m = torch.where(empty, torch.tensor(NEG_INF, device=q.device), m)
    l = torch.where(empty, torch.zeros((), device=q.device), l)
    o = torch.where(empty[..., None], torch.zeros((), device=q.device), o)
    return (o.reshape(B, Q, Hq, nspan, D), m.reshape(B, Q, Hq, nspan),
            l.reshape(B, Q, Hq, nspan))


def merge_span_partials(o, m, l, q_lens):
    """The merge kernel: the partials of ``paged_span_partials`` combined
    in span order, span 0 first, an empty span (l = 0) taking weight
    exactly 0; padding rows are zeros. Returns f32 [B, Q, Hq, D]."""
    M = m.amax(-1)
    L = torch.zeros_like(M)
    acc = torch.zeros_like(o[..., 0, :])
    for s in range(m.shape[-1]):
        w = torch.where(l[..., s] > 0, torch.exp(m[..., s] - M),
                        torch.zeros((), device=o.device))
        L = L + l[..., s] * w
        acc = acc + o[..., s, :] * w[..., None]
    out = acc / L.clamp_min(1e-30)[..., None]
    Q = o.shape[1]
    live = torch.arange(Q, device=o.device)[None, :] < q_lens.long()[:, None]
    return torch.where(live[:, :, None, None], out,
                       torch.zeros((), device=o.device))


def paged_prefill_attention_split_ref(q, k_pages, v_pages, block_tables,
                                      q_start, q_lens,
                                      span: int = SPAN_KEYS):
    """``paged_prefill_attention`` as the kernel computes it: the per-span
    partials of ``paged_span_partials`` merged by
    ``merge_span_partials``."""
    o, m, l = paged_span_partials(q, k_pages, v_pages, block_tables,
                                  q_start, q_lens, span)
    return merge_span_partials(o, m, l, q_lens).to(q.dtype)


def paged_attention_split_ref(q, k_pages, v_pages, block_tables, seq_lens,
                              span: int = SPAN_KEYS):
    """The decode function through the same split: the Q = 1 case with
    q_start = seq_len - 1."""
    one = torch.ones_like(seq_lens)
    return paged_prefill_attention_split_ref(
        q[:, None], k_pages, v_pages, block_tables, seq_lens - one, one,
        span)[:, 0]


def flash_prefill_ref(q, k, v, *, causal: bool = True, window=None,
                      q_offset: int = 0):
    """Dense attention with causal and sliding-window masks.

    q [B, Hq, Sq, D], k/v [B, Hkv, Skv, D] -> [B, Hq, Sq, D]; query row
    t sits at position ``q_offset + t`` (chunked prefill against a
    longer KV prefix). Logits materialised in f32.
    """
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, Sq, D).float()
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) / math.sqrt(D)
    q_pos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    logits = torch.where(mask, logits, torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return out.reshape(B, Hq, Sq, D).to(q.dtype)


def ssd_scan_ref(X, dA, B_mat, C_mat):
    """The SSD recurrence token by token from a zero state — the ground
    truth of the chunked scan.

    X [B, L, H, P] (dt-scaled inputs), dA [B, L, H] log-decay,
    B_mat/C_mat [B, L, H, N]. Returns (Y [B, L, H, P] in X's dtype,
    state [B, H, P, N] f32).
    """
    b, l, h, p = X.shape
    n = B_mat.shape[-1]
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=X.device)
    ys = []
    for t in range(l):
        state = state * torch.exp(dA[:, t].float())[..., None, None] \
            + X[:, t].float()[..., :, None] * B_mat[:, t].float()[..., None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", state, C_mat[:, t].float()))
    return torch.stack(ys, dim=1).to(X.dtype), state
