"""The plain reference: the served model's forward pass in float32 with
plain PyTorch, written from the published equations and the config
file, layer by layer so that it fits beside the weights.

It imports nothing of the program and takes nothing the program made:
its inputs are the benchmark's weight tensors (``livebench/weights.py``;
widened to f32 one layer at a time) and the token streams each sampled
conversation was fed. For the moe layer it also takes the composition
of every round (which rows and tokens shared a step), because the
capacity of each expert, and so which tokens it drops, is a property
of the round; the routing, the ranks and the drops are worked out here
again from the reference's own activations.

Equations (the port's layout; each is the published model's, up to the
departures the config file lists):

- RMSNorm ``x / sqrt(mean(x^2) + eps) * (1 + w)``, also over each head
  for qk_norm;
- RoPE on halves with f32 angles ``pos * theta^(-2i / hd)``;
- causal grouped-query attention, softmax in f32;
- swiglu MLP ``(silu(x Wg) * (x Wu)) Wd``;
- moe: router logits ``x Wr`` (f32 weights, product in f64), softmax,
  the top k by a stable descending sort, renormalised; each expert
  keeps the first ``C`` of the round's (token, choice) pairs routed to
  it in flat order, ``C = max(4, 4 * ceil(ceil(T k / E * cf) / 4))``
  for the round's ``T`` real tokens; a token's output is the weighted
  sum of its kept choices' expert MLPs;
- logits ``norm(x) E^T`` (tied) or ``norm(x) U``.

``quant='fp8'`` is the control: every matrix product takes its weight
and its input rounded to float8 e4m3 (per output column and per token
scales), the precision one step below the served bfloat16.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def _f8(t: torch.Tensor, dim) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (the reduction axis)."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Linear:
    """A weight ``[..., in, out]`` (reduction over ``in``) in f32, and
    its product with activations ``[..., in]``."""

    def __init__(self, w: torch.Tensor, quant: Optional[str]):
        w = w.float()
        self.quant = quant
        self.w = _f8(w, -2) if quant == "fp8" else w

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.quant == "fp8":
            x = _f8(x, -1)
        return x @ self.w


def rms(x, w, eps):
    x = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
    return x * (1.0 + w.float())


def rope(x, pos, theta):
    """x [S, H, hd], pos [S]."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, device=x.device,
                                       dtype=torch.float32) / hd)
    ang = pos.float()[:, None] * inv                     # [S, hd/2]
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    a, b = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([a * cos - b * sin, a * sin + b * cos], -1)


def attention(q, k, v, block: int = 512):
    """Causal GQA over one sequence: q [S, Hq, hd], k/v [S, Hkv, hd]."""
    S, Hq, hd = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    out = torch.empty_like(q)
    kk = k.permute(1, 2, 0)                               # [Hkv, hd, S]
    vv = v.permute(1, 0, 2)                               # [Hkv, S, hd]
    keys = torch.arange(S, device=q.device)
    for s0 in range(0, S, block):
        qb = q[s0:s0 + block].reshape(-1, Hkv, G, hd).permute(1, 2, 0, 3)
        n = qb.shape[2]
        lim = s0 + n
        sc = (qb @ kk[:, None, :, :lim]) / math.sqrt(hd)  # [Hkv,G,n,lim]
        mask = keys[None, :lim] > (s0 + torch.arange(
            n, device=q.device))[:, None]
        sc = sc.masked_fill(mask, float("-inf"))
        p = torch.softmax(sc, -1)
        o = p @ vv[:, None, :lim]                         # [Hkv,G,n,hd]
        out[s0:lim] = o.permute(2, 0, 1, 3).reshape(n, Hq, hd)
    return out


def _layer(W: dict, i: int) -> dict:
    def take(t):
        return {k: take(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[i]
    return take(W["layers"])


def capacity(tokens: int, top_k: int, experts: int, cf: float) -> int:
    c = int(math.ceil(tokens * top_k / experts * cf))
    return max(4, -(-c // 4) * 4)


def moe(model: dict, lp: dict, h: torch.Tensor, rounds: Sequence,
        quant: Optional[str]) -> torch.Tensor:
    """The moe layer over every token of every round at once.

    ``h`` [N, d] holds the round-ordered tokens (round by round, rows in
    slot order, each row's tokens in order); ``rounds`` gives each
    round's token count. Returns [N, d]."""
    m = model["moe"]
    E, k, cf = m["num_experts"], m["top_k"], m["capacity_factor"]
    N, d = h.shape
    logits = (h.double() @ lp["router"].double()).float()
    probs = torch.softmax(logits, -1)
    w, sel = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, sel = w[:, :k], sel[:, :k]
    w = w / (w.sum(-1, keepdim=True) + 1e-9)
    # each (token, choice) pair's round, and its rank among the pairs of
    # that round routed to the same expert, in flat order
    counts = torch.tensor(list(rounds), dtype=torch.int64,
                          device=h.device)
    rid = torch.repeat_interleave(torch.arange(len(counts),
                                               device=h.device), counts)
    caps = torch.tensor([capacity(int(c), k, E, cf) for c in rounds],
                        dtype=torch.int64, device=h.device)
    flat_e = sel.reshape(-1)
    flat_r = rid.repeat_interleave(k)
    g = torch.arange(N * k, device=h.device)
    key = (flat_r * E + flat_e) * (N * k) + g
    order = torch.argsort(key)
    grp = (flat_r * E + flat_e)[order]
    first = torch.ones_like(grp, dtype=torch.bool)
    first[1:] = grp[1:] != grp[:-1]
    idx = torch.arange(N * k, device=h.device)
    start = torch.cummax(torch.where(first, idx, 0), 0).values
    rank = torch.empty_like(idx)
    rank[order] = idx - start
    keep = (rank < caps[flat_r]).reshape(N, k)
    y = torch.zeros_like(h)
    contrib = torch.zeros((N, k, d), dtype=h.dtype, device=h.device)
    for e in range(E):
        tok, j = torch.nonzero((sel == e) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        x = h[tok]
        gate = Linear(lp["w_gate"][e], quant)(x)
        up = Linear(lp["w_up"][e], quant)(x)
        out = Linear(lp["w_down"][e], quant)(F.silu(gate) * up)
        contrib[tok, j] = out * w[tok, j, None]
    # summed in ascending expert order, from zero
    order_k = torch.argsort(sel, -1)
    for j in range(k):
        y = y + torch.gather(contrib, 1, order_k[:, j, None, None]
                             .expand(N, 1, d))[:, 0]
    return y


def forward(model: dict, W: dict, streams: Dict[str, torch.Tensor],
            wanted: Dict[str, torch.Tensor], *,
            rounds: Optional[Tuple[List, List]] = None,
            quant: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """Logits [len(wanted[s]), V] f32 at positions ``wanted[s]`` of each
    stream ``streams[s]`` (token ids from position 0).

    ``rounds`` (moe only): ``(order, counts)``, where ``order`` lists
    every token of every stream as ``(sid, position)`` in round order
    and ``counts`` the tokens of each round."""
    eps = model.get("rms_eps", 1e-6)
    L = model["num_layers"]
    hq, hkv = model["num_heads"], model["num_kv_heads"]
    hd = model.get("head_dim") or model["d_model"] // hq
    theta = model["rope_theta"]
    embed = W["embed"]
    xs = {s: embed[t].float() for s, t in streams.items()}
    if rounds is not None:
        order, counts = rounds
        sids = list(streams)
        lens = [len(streams[s]) for s in sids]
        base = dict(zip(sids, [sum(lens[:i]) for i in range(len(sids))]))
        dev = embed.device
        perm = torch.tensor([base[s] + p for s, p in order],
                            dtype=torch.int64, device=dev)
        if len(order) != sum(lens):
            raise ValueError("the rounds do not cover every fed token once")
    for i in range(L):
        lp = _layer(W, i)
        a = lp["attn"]
        wq, wk, wv = (Linear(a[n].reshape(a[n].shape[0], -1), quant)
                      for n in ("wq", "wk", "wv"))
        wo = Linear(a["wo"].reshape(-1, a["wo"].shape[-1]), quant)
        for s, x in xs.items():
            h = rms(x, lp["ln1"], eps)
            S = x.shape[0]
            q = wq(h).view(S, hq, hd)
            kk = wk(h).view(S, hkv, hd)
            v = wv(h).view(S, hkv, hd)
            if "q_norm" in a:
                q = rms(q, a["q_norm"], eps)
                kk = rms(kk, a["k_norm"], eps)
            pos = torch.arange(S, device=x.device)
            q, kk = rope(q, pos, theta), rope(kk, pos, theta)
            xs[s] = x + wo(attention(q, kk, v).reshape(S, hq * hd))
        if "moe" in lp:
            cat = torch.cat([xs[s] for s in sids])
            h = rms(cat[perm], lp["ln2"], eps)
            y = torch.empty_like(cat)
            y[perm] = moe(model, lp["moe"], h, counts, quant)
            cat = cat + y
            o = 0
            for s, n in zip(sids, lens):
                xs[s] = cat[o:o + n]
                o += n
        else:
            mp = lp["mlp"]
            g, u, dn = (Linear(mp[n], quant)
                        for n in ("w_gate", "w_up", "w_down"))
            for s, x in xs.items():
                h = rms(x, lp["ln2"], eps)
                xs[s] = x + dn(F.silu(g(h)) * u(h))
    head = W["embed"].T if model.get("tie_embeddings", True) \
        else W["unembed"]
    head = Linear(head, quant)
    out = {}
    for s, x in xs.items():
        h = rms(x[wanted[s]], W["final_norm"], eps)
        out[s] = head(h)
    return out
