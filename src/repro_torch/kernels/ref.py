"""Plain PyTorch versions of the paged-attention kernels.

Deliberately naive (pages gathered into a dense sequence, logits
materialised): slow but obviously right. The kernel wrappers take them
for CPU tensors, and the kernels are held against them on the card.
They mirror ``repro.kernels.ref`` of the JAX package, including its
finite ``NEG_INF`` sentinel and its zeroed padding rows.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


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
