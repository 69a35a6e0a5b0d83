"""Mixture-of-Experts layer: the single-device path (``moe_local``) of
the JAX package's ``models/moe.py``.

Routing is f32 softmax over the router logits, top-k, renormalised;
dispatch is gather-based (a stable argsort of the chosen experts gives
an ``[E, C]`` token-index table, row T of the token array being the
zero pad), so the expert products are batched matmuls over each
expert's C slots and their cost scales with top_k. Tokens past an
expert's capacity are dropped (they keep the residual path), as in the
published dropping implementations.

``moe_local`` takes a ``valid`` mask of the real tokens: only they are
routed, and the capacity is sized from their count. The reference
routes every token of the batch, padding included, so identical padding
tokens, ranked first by the stable sort, can take the capacity that
real tokens of later rows need, and which tokens drop then depends on
what the padding holds. With the mask the result depends on the real
tokens alone; without it (``valid=None``) every token is real, as in
the reference. The mask never leaves the device: padding slots take a
sentinel expert past the last, which sorts after every real slot and
is never kept, and the capacity of the real tokens' count is a device
value that limits the ranks inside the buffer sized for the whole
batch (packing the real tokens would need their count on the host, a
sync every moe layer).

``moe_ep`` is the expert-parallel path over a ('data', 'model') mesh
of ranks (training's): each 'model' rank routes its own slice of its
data rank's tokens and holds E / M of the experts; two all-to-alls over
'model' carry the dispatched tokens to their experts and back, and one
all-gather restores the rows. Its numbers are the reference's
``moe_ep``'s, not ``moe_local``'s on the whole batch: the capacity and
the aux loss are each slice's.

``moe_tp`` is the reference's expert tensor parallelism (its
``moe_ep`` under ``set_expert_tp(True)``, the dry run's decode cells):
experts over 'model', each expert's ``d_ff`` over 'data', the tokens
replicated. ``moe_apply`` takes it as an argument (``expert_tp``), not
as a module global.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as C
from repro_torch.models.layers import dense_init, mlp_apply, mlp_init, \
    mlp_tp


# ----------------------------------------------------------------- init
def moe_init(generator, cfg, dtype, device):
    """The reference's tree: an f32 router ``[d, E]`` at any
    ``param_dtype``, per-expert stacked ``w_gate``/``w_up`` ``[E, d, f]``
    and ``w_down`` ``[E, f, d]``, and a swiglu ``shared`` MLP when the
    config has shared experts."""
    m = cfg.moe
    d, f, E = cfg.d_model, m.d_ff_expert, m.num_experts

    def experts(shape, fan_in):
        return torch.stack([dense_init(generator, shape, fan_in, dtype,
                                       device) for _ in range(E)])

    p = {"router": dense_init(generator, (d, E), d, torch.float32, device),
         "w_gate": experts((d, f), d),
         "w_up": experts((d, f), d),
         "w_down": experts((f, d), f)}
    if m.num_shared_experts:
        p["shared"] = mlp_init(generator, d, f * m.num_shared_experts,
                               "swiglu", dtype, device)
    return p


# ----------------------------------------------------------------- routing
def route(router_w, x2d, top_k: int, *, normalize: bool = True):
    """x2d [T, d] -> (weights [T, k] f32, sel [T, k] int64, aux_loss).

    The logits are an f32 product of x and the f32 router, computed in
    f64 and rounded: a product that cannot take TF32 on the card, with
    nothing global set. The top k come from a stable descending sort,
    so ties go to the lower expert index as in ``jax.lax.top_k``."""
    logits = (x2d.double() @ router_w.double()).float()
    probs = torch.softmax(logits, dim=-1)
    weights, sel = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, sel = weights[:, :top_k], sel[:, :top_k]
    if normalize:
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-9)
    # Switch-style load-balance loss: E * sum_e f_e * P_e
    E = router_w.shape[-1]
    f_e = F.one_hot(sel, E).float().mean(dim=(0, 1))
    p_e = probs.mean(dim=0)
    aux = E * (f_e * p_e).sum()
    return weights, sel, aux


def _capacity(tokens: int, top_k: int, num_experts: int, cf: float) -> int:
    c = int(math.ceil(tokens * top_k / num_experts * cf))
    return max(4, -(-c // 4) * 4)  # round up to a multiple of 4


def _capacity_of(tokens, top_k: int, num_experts: int, cf: float):
    """``_capacity`` of a device count: the same float64 operations in
    the same order, so the same value, with no host sync."""
    c = torch.ceil(tokens.double() * top_k / num_experts * cf).long()
    return ((c + 3) // 4 * 4).clamp(min=4)


def build_dispatch(sel, weights, num_experts: int, capacity: int,
                   valid=None, limit=None, slots: bool = False):
    """argsort-based dispatch tables: (tok_idx [E, C] int64, an index
    into the padded token array where row T is the zero pad; w [E, C]
    f32 combine weights, 0 on empty slots). ``valid`` [T] bool leaves
    the other tokens out (a sentinel expert past the last: they sort
    after every real slot and are never kept); ``limit`` (a device
    count <= C) keeps only ranks below it. With ``slots`` a third table
    follows, ``combine``'s: each token's flat slots ``e * C + c`` [T, k]
    int64 in ascending order, ``E * C`` for a choice not kept."""
    T, k = sel.shape
    dev = sel.device
    flat_e = sel.reshape(-1)
    if valid is not None:
        flat_e = torch.where(valid.repeat_interleave(k), flat_e,
                             num_experts)
    order = torch.argsort(flat_e, stable=True)      # slots sorted by expert
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e, torch.arange(
        num_experts + 1, device=dev, dtype=sorted_e.dtype))
    rank = torch.arange(T * k, device=dev) - starts[sorted_e]
    keep = rank < (capacity if limit is None else limit)
    if valid is not None:
        keep &= sorted_e < num_experts
    # a dropped slot writes the extra entry E * C, cut off below
    dest = torch.where(keep, sorted_e * capacity + rank,
                       num_experts * capacity)
    tok_idx = torch.full((num_experts * capacity + 1,), T,
                         dtype=torch.int64, device=dev)
    tok_idx[dest] = torch.where(keep, order // k, T)
    w_tab = torch.zeros((num_experts * capacity + 1,), dtype=torch.float32,
                        device=dev)
    w_tab[dest] = torch.where(keep, weights.reshape(-1)[order].float(),
                              0.0)
    tables = (tok_idx[:-1].reshape(num_experts, capacity),
              w_tab[:-1].reshape(num_experts, capacity))
    if not slots:
        return tables
    tok_slots = torch.empty_like(dest)
    tok_slots[order] = dest
    return (*tables, torch.sort(tok_slots.reshape(T, k), dim=1).values)


def expert_ffn(params, xe):
    """xe [E, C, d] through each expert's swiglu MLP -> [E, C, d]."""
    h = F.silu(torch.bmm(xe, params["w_gate"]))
    h = h * torch.bmm(xe, params["w_up"])
    return torch.bmm(h, params["w_down"])


def combine(tok_slots, contrib):
    """Each token's weighted expert outputs summed -> [T, d] in
    ``contrib``'s type: tok_slots [T, k] (``build_dispatch``'s, E * C
    for a choice not kept), contrib [E, C, d].

    The reference scatter-adds the slots in flat (e, c) order
    (``.at[].add``), so a token's sum starts from a zero row and adds
    its kept contributions in ascending expert order, each partial sum
    rounded to the type. The same here, on the card too: one gather
    takes each token's slots in that order, a zero for a choice not
    kept (adding it is exact), and a fixed loop over k adds them. The
    sums are the same on every run and device (``index_add_``'s atomics
    on the card add in an order that varies from run to run)."""
    n = contrib.shape[0] * contrib.shape[1]
    g = contrib.reshape(n, -1)[tok_slots.clamp_max(n - 1)]      # [T, k, d]
    first, *rest = torch.where((tok_slots < n)[..., None], g, 0).unbind(1)
    y = first + 0                          # onto the reference's zero row
    for g_j in rest:
        y = y + g_j
    return y


# ----------------------------------------------------------------- local path
def moe_local(params, x, cfg, valid=None):
    """x [B, S, d] -> (y, aux_loss). ``valid`` [B, S] bool marks the real
    tokens (None: all of them): they are routed and dispatched as the
    reference routes a batch of exactly those tokens in their flat order
    (their count sizes the capacity); the others get zero from the
    routed experts (plus the shared experts' output). The expert
    products run over the capacity of the whole batch; slots past the
    real tokens' capacity stay empty. The aux loss counts every
    token."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    x2 = x.reshape(T, d)
    weights, sel, aux = route(params["router"], x2, m.top_k)
    C = _capacity(T, m.top_k, m.num_experts, m.capacity_factor)
    limit = None
    if valid is not None:
        valid = valid.reshape(T)
        limit = _capacity_of(valid.sum(), m.top_k, m.num_experts,
                             m.capacity_factor)
    tok_idx, w_tab, tok_slots = build_dispatch(
        sel, weights, m.num_experts, C, valid, limit, slots=True)
    x_pad = torch.cat([x2, x2.new_zeros((1, d))])
    ye = expert_ffn(params, x_pad[tok_idx])             # [E, C, d]
    y = combine(tok_slots, ye * w_tab[..., None].to(ye.dtype)) \
        .reshape(B, S, d)
    if m.num_shared_experts:
        y = y + mlp_apply(params["shared"], x, "swiglu")
    return y, aux


# ----------------------------------------------------------------- EP path
def moe_ep(params, x, cfg, mesh):
    """x [b, S, d]: this data rank's rows, the same on every 'model'
    rank -> (y [b, S, d], aux), the reference's ``moe_ep`` with
    ``expert_tp`` off. The expert leaves are this rank's E / M experts
    (``[E/M, ...]``), the router whole; the shared experts' ``d_ff`` is
    this rank's slice where it divides 'model', else whole.

    The b * S tokens are padded with zeros to ``tm * M``; 'model' rank
    ``m`` routes slice ``m`` (padding included, as the reference does),
    with the capacity of ``tm`` tokens, and dispatches it [E, C, d];
    an all-to-all gives each rank its experts' slots from every slice
    [E/M, C * M, d], the experts run, and the all-to-all back returns
    [E, C, d], combined in the reference's order. The slices are
    gathered over 'model'. The aux loss is the mean of every (data,
    model) slice's; its gradient is this rank's slice's over M (the
    loss's data shares sum over 'data', ``models/model.py::loss_fn``)."""
    m = cfg.moe
    b, S, d = x.shape
    M, E = mesh.model, m.num_experts
    t = b * S
    tm = -(-t // M)                                  # ceil
    x2 = C.copy_to_model(x, mesh).reshape(t, d)
    if tm * M > t:
        x2 = torch.cat([x2, x2.new_zeros((tm * M - t, d))])
    xs = x2[mesh.idx * tm:(mesh.idx + 1) * tm]
    weights, sel, aux = route(C.copy_to_model(params["router"], mesh), xs,
                              m.top_k)
    cap = _capacity(tm, m.top_k, E, m.capacity_factor)
    tok_idx, w_tab, tok_slots = build_dispatch(sel, weights, E, cap,
                                               slots=True)
    xe = torch.cat([xs, xs.new_zeros((1, d))])[tok_idx]      # [E, C, d]
    xe = C.all_to_all_model(xe, 0, 1, mesh)                  # [E/M, C*M, d]
    ye = C.all_to_all_model(expert_ffn(params, xe), 1, 0, mesh)
    y = combine(tok_slots, ye * w_tab[..., None].to(ye.dtype))
    y = C.gather_from_model(y, 0, mesh)[:t].reshape(b, S, d)
    aux = C.mean_over_data(C.reduce_from_model(aux, mesh) / M, mesh)
    if m.num_shared_experts:
        f = m.d_ff_expert * m.num_shared_experts
        sh = params["shared"]
        y = y + (mlp_tp(sh, x, "swiglu", mesh)
                 if sh["w_up"].shape[-1] < f else
                 mlp_apply(sh, x, "swiglu"))
    return y, aux


def moe_tp(params, x, cfg, mesh):
    """x [B, S, d]: the whole batch, the same on every rank -> (y [B, S,
    d], aux), the same on every rank: the reference's ``moe_ep`` with
    ``expert_tp`` on. The expert leaves are this rank's E / M experts,
    each with this 'data' rank's slice of ``d_ff`` where the rules split
    it (``ShardingRules(expert_tp=True)``: ``w_gate``/``w_up`` ``[E/M,
    d, f/D]``, ``w_down`` ``[E/M, f/D, d]``), else whole; the router is
    whole, the shared experts' ``d_ff`` this rank's slice over 'model'
    where it divides, else whole.

    The B * S tokens are padded with zeros to ``tm * M`` and 'model'
    rank ``m`` routes slice ``m`` with the capacity of ``tm`` tokens, as
    in ``moe_ep``; an all-to-all over 'model' gives each rank its
    experts' slots from every slice, the expert products on this rank's
    ``d_ff`` slice are summed over 'data' (the contraction the split
    left open), the all-to-all back returns them, and each slice is
    combined in the reference's order and gathered over 'model'. The
    aux loss is the mean of the M slices'. Serving only: it has no
    backward (training's expert-parallel layer is ``moe_ep``)."""
    if torch.is_grad_enabled() and (x.requires_grad or any(
            t.requires_grad for t in params.values()
            if isinstance(t, torch.Tensor))):
        raise ValueError("expert_tp is the decode cells' layer and has no "
                         "backward: training takes moe_ep")
    m = cfg.moe
    B, S, d = x.shape
    M, E = mesh.model, m.num_experts
    t = B * S
    tm = -(-t // M)                                  # ceil
    x2 = x.reshape(t, d)
    if tm * M > t:
        x2 = torch.cat([x2, x2.new_zeros((tm * M - t, d))])
    xs = x2[mesh.idx * tm:(mesh.idx + 1) * tm]
    weights, sel, aux = route(params["router"], xs, m.top_k)
    cap = _capacity(tm, m.top_k, E, m.capacity_factor)
    tok_idx, w_tab, tok_slots = build_dispatch(sel, weights, E, cap,
                                               slots=True)
    xe = torch.cat([xs, xs.new_zeros((1, d))])[tok_idx]      # [E, C, d]
    xe = C.all_to_all(xe, 0, 1, mesh, "model")               # [E/M, C*M, d]
    ye = expert_ffn(params, xe)
    if params["w_up"].shape[-1] < m.d_ff_expert:
        # d_ff split over 'data': finish the contraction
        ye = C.all_reduce(ye, mesh, "data")
    ye = C.all_to_all(ye, 1, 0, mesh, "model")               # [E, C, d]
    y = combine(tok_slots, ye * w_tab[..., None].to(ye.dtype))
    y = C.all_gather(y, 0, mesh, "model")[:t].reshape(B, S, d)
    aux = C.all_reduce(aux.clone(), mesh, "model") / M
    if m.num_shared_experts:
        f = m.d_ff_expert * m.num_shared_experts
        sh = params["shared"]
        y = y + (mlp_tp(sh, x, "swiglu", mesh)
                 if sh["w_up"].shape[-1] < f else
                 mlp_apply(sh, x, "swiglu"))
    return y, aux


def moe_apply(params, x, cfg, mesh=None, valid=None, expert_tp=False):
    """``moe_local`` (``valid``: the real tokens), or over a mesh
    ``moe_ep`` (every token routed, as the reference's), or with
    ``expert_tp`` ``moe_tp`` (x the whole batch; a mesh required)."""
    if expert_tp:
        if mesh is None:
            raise ValueError("expert_tp splits the experts over a mesh: "
                             "pass one")
        return moe_tp(params, x, cfg, mesh)
    if mesh is not None:
        return moe_ep(params, x, cfg, mesh)
    return moe_local(params, x, cfg, valid)
