"""Model assembly: parameters, embedding, unembedding, the MLP block
(dense or moe), the whisper encoder, the teacher-forcing ``forward``
and ``loss_fn`` of the training graph, and the ring-cache
``prefill``/``decode_step`` of every family (the JAX package's
``models/model.py``): dense, moe, vlm, ssm, hybrid (RecurrentGemma's
rglru/local-attention pattern) and encdec (whisper's decoder over an
encoder's output), each attention layer either the grouped-query
attention or, where the config has ``mla``, multi-head latent attention
(``models/mla.py``; DeepSeek-V2's moe stack). The vlm family's stub
modality frontend prepends ``frontend_embeds`` (patch embeddings) to
the tokens under the prefix-LM mask (``prefix_len``).

Parameters are a dict of tensors in the JAX package's pytree layout:
``embed``, ``final_norm``, optional ``unembed``, ``layers`` and an
optional ``layers_pre`` list (the moe family's leading dense layers).
``layers`` is layer-stacked (every leaf has a leading ``[num_layers]``
axis), except in the hybrid family, whose mixed layer kinds make it a
list; the encdec family adds ``encoder`` (stacked layers and a final
norm). The reference scans the stacked layers; the port loops over
``unbind``'s views of them (``layer_params``), so a training step's
gradients land on the stacked ``[L, ...]`` leaves, as ``jax.grad``'s
do.

The training graph (``forward``, ``loss_fn``) is the reference's: every
attention is the masked einsum ``gqa_attention`` (mla's at scale
1/sqrt(nope + rope)), the mamba2 mixer scans with ``ssd_chunked`` and
the RG-LRU out of place, all in torch ops that autograd differentiates;
no hand-written kernel is on it, as no Pallas kernel is on the
reference's. The moe layers' aux losses are summed over the stacked
layers (the leading dense layers have none). ``remat`` checkpoints the
per-layer body the reference wraps in ``jax.checkpoint``.

KV caches are ring buffers of ``W`` slots (W = capacity, or the
attention window for sliding-window and local-attention configs);
``kv_pos`` tracks absolute positions so masks stay exact after
wraparound. The hybrid cache holds K/V for its local-attention layers
only, beside each recurrent layer's f32 state and conv tail; the encdec
cache holds each layer's cross-attention K/V over the encoder frames;
an mla cache holds each layer's latent ``ckv`` and shared rope key
``k_rope`` in place of K/V. The reference builds a new cache
functionally; the port writes the cache it is given in place and
returns it. Prefill attends through the
``flash_prefill`` kernel (causal, with the window where there is one;
not causal over the encoder frames; mla's at nope + rope columns with V
padded to them), except under the prefix-LM mask, which the kernel
does not take: such a prefill attends through ``gqa_attention`` as the
reference does. The ssm prefill scans through ``ssd_scan``; the
ring-cache decode attends with the plain ``gqa_attention`` (mla: the
absorbed latent products), as the reference computes it outside any
Pallas kernel.

``prefill`` and ``decode_step`` take a ``mesh`` as the reference's do:
every family serves over a ('data', 'model') mesh of ranks, each
holding its blocks of the parameters and of the cache
(``ShardingRules``; the section "serving over a mesh" below says how
a rank's heads and its stripe of the ring's slots meet). A config's
``attention_impl`` "surrogate" (the dry run's stand-in for attention)
replaces every attention the reference replaces: the training graph's,
the encoder's and a prefill's; decode attends as ever.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import P, ShardingRules, \
    local_block, spec_axes
from repro_torch.kernels import ref
from repro_torch.kernels.flash_prefill import flash_prefill
from repro_torch.models import layers as L
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rg
from repro_torch.models import ssm as ssm_mod

# the leaves the reference keeps in f32 at any param_dtype: the mixer's,
# the moe router and the RG-LRU's gates and decay. "parent/name" is f32
# only under that parent: the mixer's own ``w_x`` takes the param dtype
F32_LEAVES = ("A_log", "D", "dt_bias", "router", "rec/w_a", "rec/b_a",
              "rec/w_x", "rec/b_x", "rec/lam")


def keeps_f32(parent, key) -> bool:
    """Whether leaf ``key`` of the dict under ``parent`` stays f32."""
    return key in F32_LEAVES or f"{parent}/{key}" in F32_LEAVES


MOE_AUX_COEF = 0.01
Z_LOSS_COEF = 1e-4


# ======================================================================
# parameters
# ======================================================================
def _stacked(n: int, make):
    """``n`` layer trees from ``make()``, in order, stacked leaf by leaf
    into ``[n, ...]`` buffers as each is drawn, so that only one layer's
    tree lives beside the stack (stacking a list of whole layers would
    hold every layer twice: 80 GB at deepseek-v2's six layers)."""
    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        return t.new_empty((n,) + t.shape)

    def put(out, t, i):
        if isinstance(t, dict):
            for k, v in t.items():
                put(out[k], v, i)
        else:
            out[i] = t

    out = None
    for i in range(n):
        layer = make()
        if out is None:
            out = alloc(layer)
        put(out, layer, i)
    return out


def _dense_layer_init(generator, cfg, dtype, device, *, d_ff=None,
                      moe_layer=False):
    zeros = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    attn = mla_mod.mla_init if cfg.mla is not None else L.attn_init
    p = {"ln1": zeros, "ln2": zeros.clone(),
         "attn": attn(generator, cfg, dtype, device)}
    if moe_layer:
        p["moe"] = moe_mod.moe_init(generator, cfg, dtype, device)
    else:
        p["mlp"] = L.mlp_init(generator, cfg.d_model, d_ff or cfg.d_ff,
                              cfg.mlp_kind, dtype, device)
    return p


def _ssm_layer_init(generator, cfg, dtype, device):
    return {"ln1": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
            "mixer": ssm_mod.mamba2_init(generator, cfg, dtype, device)}


def _rglru_layer_init(generator, cfg, dtype, device):
    r = cfg.rglru
    zeros = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    return {"ln1": zeros,
            "rec": rg.rglru_init(generator, cfg.d_model,
                                 r.lru_width or cfg.d_model, r.conv_width,
                                 dtype, device),
            "ln2": zeros.clone(),
            "mlp": L.mlp_init(generator, cfg.d_model, cfg.d_ff,
                              cfg.mlp_kind, dtype, device)}


def _xattn_layer_init(generator, cfg, dtype, device):
    """A whisper decoder layer: self-attention, cross-attention, mlp."""
    p = _dense_layer_init(generator, cfg, dtype, device)
    p["ln_x"] = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    p["xattn"] = L.attn_init(generator, cfg, dtype, device, mha=True)
    return p


def init_params(cfg, generator: torch.Generator, device):
    """Random weights for every family, drawn from ``generator``
    (which must live on ``device``) with the reference's schemes. The
    numbers differ from JAX's for the same seed; tests carry JAX's
    weights across with ``params_from_numpy`` instead."""
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
        params["layers"] = _stacked(
            n - nd, lambda: _dense_layer_init(generator, cfg, dtype, device,
                                              moe_layer=True))
        return params
    if cfg.family == "hybrid":
        params["layers"] = [
            (_rglru_layer_init if kind == "rglru" else _dense_layer_init)(
                generator, cfg, dtype, device)
            for kind in cfg.block_kinds()]
        return params
    if cfg.family == "encdec":
        enc = cfg.encoder
        params["layers"] = _stacked(
            n, lambda: _xattn_layer_init(generator, cfg, dtype, device))
        params["encoder"] = {
            "layers": _stacked(enc.num_layers, lambda: _dense_layer_init(
                generator, cfg, dtype, device)),
            "final_norm": torch.zeros((enc.d_model or cfg.d_model,),
                                      dtype=dtype, device=device)}
        return params
    layer = _ssm_layer_init if cfg.family == "ssm" else _dense_layer_init
    params["layers"] = _stacked(
        n, lambda: layer(generator, cfg, dtype, device))
    return params


@functools.lru_cache(maxsize=16)
def param_shapes(cfg):
    """``cfg``'s parameter tree as meta tensors: every leaf's full shape
    and dtype, nothing allocated (the reference's
    ``launch/specs.py::param_shapes``, which the sharding rules read)."""
    return init_params(cfg, None, "meta")


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


def params_from_numpy(tree, device, dtype=None, _parent=None):
    """The JAX package's parameter pytree, as nested dicts (and the
    ``layers_pre`` and hybrid ``layers`` lists) of numpy arrays, to the
    same tree of tensors on ``device``. Floating leaves are cast to
    ``dtype`` when given, except the ``F32_LEAVES``, which stay f32 as
    in the reference."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, torch.float32
                                     if dtype is not None
                                     and keeps_f32(_parent, k) else dtype,
                                     k)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device, dtype, _parent) for v in tree]
    return _to_tensor(tree, device, dtype)


def layer_params(params):
    """Per-layer parameter dicts in execution order: the unstacked
    ``layers_pre`` first, then the hybrid list as it is, or views into
    each slice of the stacked ``layers``."""
    stacked = params["layers"]
    if isinstance(stacked, list):
        return list(params.get("layers_pre", [])) + stacked
    return list(params.get("layers_pre", [])) + _unstack(stacked)


def _unstack(tree):
    """A stacked layer tree as a list of per-layer trees of ``unbind``'s
    views: under autograd its backward stacks the L gradients into one
    ``[L, ...]`` tensor, where indexing layer by layer would add a
    ``[L, ...]`` tensor of zeros for each layer."""
    if isinstance(tree, dict):
        cols = {k: _unstack(v) for k, v in tree.items()}
        n = len(next(iter(cols.values())))
        return [{k: v[i] for k, v in cols.items()} for i in range(n)]
    return list(torch.unbind(tree))


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


def _mlp_aux(cfg, lp, x, valid=None):
    """The MLP half of a layer and its aux loss: dense (aux None), or the
    single-device moe, which routes only the tokens ``valid`` [B, S]
    marks (None: all)."""
    h = L.rms_norm(x, lp["ln2"], cfg.rms_eps)
    if "moe" in lp:
        y, aux = moe_mod.moe_apply(lp["moe"], h, cfg, valid=valid)
        return x + y, aux
    return x + L.mlp_apply(lp["mlp"], h, cfg.mlp_kind), None


def _mlp_block(cfg, lp, x, valid=None):
    """``_mlp_aux`` without the aux loss, a training term."""
    return _mlp_aux(cfg, lp, x, valid)[0]


def _frontend_concat(x_tok, frontend_embeds):
    """Prepend the stub modality embeddings (vlm): [B, F + S, d]."""
    if frontend_embeds is None:
        return x_tok
    return torch.cat([frontend_embeds.to(x_tok.dtype), x_tok], dim=1)


def _cross_attention(lp, cfg, x, k, v, attend):
    """A decoder layer's cross-attention half: queries from ``x``
    (normed, no rope) over the encoder's k/v [B, F, H, hd]."""
    g = L.rms_norm(x, lp["ln_x"], cfg.rms_eps)
    q = torch.einsum("bsd,dhe->bshe", g, lp["xattn"]["wq"])
    return x + L.attn_output(lp["xattn"], attend(q, k, v))


def _flash(attend, q, k, v, **kw):
    """``flash_prefill`` (or its plain version) on [B, S, H, D] tensors."""
    return attend(q.transpose(1, 2).contiguous(),
                  k.transpose(1, 2).contiguous(),
                  v.transpose(1, 2).contiguous(), **kw).transpose(1, 2)


def _prefill_attend(cfg, attend, q, k, v, *, causal=True, window=None,
                    mask=None):
    """A prefill's attention on [B, S, H, D] tensors: the surrogate
    where the config asks for it (the dry run's), the masked
    ``gqa_attention`` under ``mask`` (the prefix-LM mask, which the
    kernel lacks), else ``attend`` (``flash_prefill`` or its plain
    version) with ``causal`` and ``window``."""
    if cfg.attention_impl != "einsum":
        return L.gqa_attention(q, k, v, mask, impl=cfg.attention_impl)
    if mask is not None:
        return L.gqa_attention(q, k, v, mask)
    return _flash(attend, q, k, v, causal=causal, window=window)


def encode(cfg, params, frames, *, plain: bool = False,
           graph: str = "serve"):
    """The whisper encoder over stub frame embeddings [B, F, d]: the
    sinusoidal positions added, then non-causal self-attention layers
    through ``flash_prefill`` (``plain``: its plain version; ``graph``
    "train", or the surrogate attention: ``gqa_attention`` unmasked, as
    the reference's)."""
    enc = params["encoder"]
    B, nf, d = frames.shape
    dt = cfg.activation_dtype()
    x = frames.to(dt) + L.sinusoidal_positions(nf, d, frames.device).to(dt)
    positions = torch.arange(nf, dtype=torch.int32,
                             device=x.device).expand(B, nf)
    if graph == "train" or cfg.attention_impl != "einsum":
        mask = torch.ones((B, nf, nf), dtype=torch.bool, device=x.device)

        def attend(q, k, v):
            return L.gqa_attention(q, k, v, mask, impl=cfg.attention_impl)
    else:
        kernel = ref.flash_prefill_ref if plain else flash_prefill

        def attend(q, k, v):
            return _flash(kernel, q, k, v, causal=False)
    for lp in layer_params(enc):
        h = L.rms_norm(x, lp["ln1"], cfg.rms_eps)
        q, k, v = L.attn_project_qkv(lp["attn"], cfg, h, positions,
                                     rope=False)
        x = x + L.attn_output(lp["attn"], attend(q, k, v))
        x = _mlp_block(cfg, lp, x)
    return L.rms_norm(x, enc["final_norm"], cfg.rms_eps)


# ======================================================================
# teacher-forcing forward (the training graph)
# ======================================================================
def _attn_train(cfg, lp, x, positions, mask):
    """A layer's attention half on the training graph: the masked
    ``gqa_attention`` (mla: ``mla_forward``'s, at its scale)."""
    h = L.rms_norm(x, lp["ln1"], cfg.rms_eps)
    if cfg.mla is not None:
        a, _ = mla_mod.mla_forward(lp["attn"], cfg, h, positions,
                                   graph="train", mask=mask,
                                   impl=cfg.attention_impl)
        return x + a
    q, k, v = L.attn_project_qkv(lp["attn"], cfg, h, positions)
    return x + L.attn_output(lp["attn"], L.gqa_attention(
        q, k, v, mask, impl=cfg.attention_impl))


def forward(cfg, params, tokens, *, frontend_embeds=None, prefix_len=None,
            enc_frames=None, mesh=None, remat: bool = False,
            seq_spec=None, rules=None):
    """tokens [B, S_text] -> (logits [B, S_total, V] f32, aux loss f32
    scalar), the reference's training graph. ``frontend_embeds`` [B, F,
    d] are prepended (vlm) and ``prefix_len`` [B] makes the mask
    bidirectional within the prefix; ``enc_frames`` [B, F, d] feed the
    encoder (encdec). ``remat`` recomputes each stacked layer's body in
    the backward (``torch.utils.checkpoint``), as the reference's
    ``jax.checkpoint`` does; ``seq_spec`` (the reference's sharding of
    the residual stream) changes no value and is ignored.

    ``mesh`` (a rank's ``launch/mesh.py`` mesh) runs every family over
    it, on the blocks of ``params`` that ``rules`` (default
    ``ShardingRules(cfg, mesh)``) give this rank, with ``tokens``,
    ``frontend_embeds``, ``prefix_len`` and ``enc_frames`` this data
    rank's rows: ``_forward_mesh``."""
    if mesh is not None:
        return _forward_mesh(cfg, params, tokens, mesh,
                             rules or ShardingRules(cfg, mesh), remat,
                             frontend_embeds=frontend_embeds,
                             prefix_len=prefix_len, enc_frames=enc_frames)
    x = _embed(cfg, params, tokens)
    x = _frontend_concat(x, frontend_embeds)
    B, S, _ = x.shape
    dev = x.device
    positions = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    mask = L.attention_mask(positions, positions, causal=True,
                            window=cfg.sliding_window, prefix_len=prefix_len)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    fam = cfg.family

    if fam == "hybrid":
        local_mask = L.attention_mask(positions, positions, causal=True,
                                      window=cfg.rglru.local_window)
        for lp, kind in zip(params["layers"], cfg.block_kinds()):
            if kind == "rglru":
                h = L.rms_norm(x, lp["ln1"], cfg.rms_eps)
                y, _ = rg.recurrent_block_forward(lp["rec"], cfg, h,
                                                  graph="train")
                x = x + y
            else:
                x = _attn_train(cfg, lp, x, positions, local_mask)
            x = _mlp_block(cfg, lp, x)
        return _logits(cfg, params, x), aux

    if fam == "encdec":
        enc_out = encode(cfg, params, enc_frames, graph="train")
        xmask = torch.ones((B, S, enc_out.shape[1]), dtype=torch.bool,
                           device=dev)

    def body(h, lp):
        """One stacked layer; returns (h, aux or None)."""
        if fam == "ssm":
            y, _ = ssm_mod.mamba2_forward(
                lp["mixer"], cfg, L.rms_norm(h, lp["ln1"], cfg.rms_eps),
                graph="train")
            return h + y, None
        h = _attn_train(cfg, lp, h, positions, mask)
        if fam == "encdec":
            kx = torch.einsum("bsd,dhe->bshe", enc_out, lp["xattn"]["wk"])
            vx = torch.einsum("bsd,dhe->bshe", enc_out, lp["xattn"]["wv"])
            h = _cross_attention(
                lp, cfg, h, kx, vx,
                lambda q, k, v: L.gqa_attention(q, k, v, xmask,
                                                impl=cfg.attention_impl))
        return _mlp_aux(cfg, lp, h)

    for lp in params.get("layers_pre", []):
        # the leading dense layers: outside the remat, their aux dropped
        x = _mlp_block(cfg, lp, _attn_train(cfg, lp, x, positions, mask))
    for lp in _unstack(params["layers"]):
        if remat:
            x, a = checkpoint(body, x, lp, use_reentrant=False)
        else:
            x, a = body(x, lp)
        if a is not None:
            aux = aux + a
    return _logits(cfg, params, x), aux


def loss_fn(cfg, params, batch, *, mesh=None, remat: bool = False,
            seq_spec=None, rules=None):
    """batch: ``tokens`` [B, S], ``labels`` [B, S], optional ``weights``
    [B, S], ``patches`` [B, F, d] with ``prefix_len`` [B] (vlm) and
    ``frames`` [B, F, d] (encdec). Returns (loss, {"ce", "aux"}): the
    label-weighted cross-entropy over the text positions plus
    ``Z_LOSS_COEF`` times the weighted mean squared log-partition and
    ``MOE_AUX_COEF`` times the moe aux loss, in f32.

    Over a ``mesh``, ``batch`` is the whole (micro)batch, the same on
    every rank; this rank takes its rows by ``rules.batch`` and returns
    its data rank's share of the loss and of ``ce``: its numerators
    over the whole batch's denominators (the weights' sum), a batch
    replicated over 'data' (its rows do not divide it) and the aux term
    each divided by the data ranks' count, so that the shares sum over
    'data' to the reference's values, and so do their gradients."""
    share, denom = 1.0, None
    if mesh is not None:
        rules = rules or ShardingRules(cfg, mesh)
        specs = rules.batch(batch)
        if "data" not in spec_axes(specs["tokens"]):
            share = 1.0 / mesh.data
        w = batch.get("weights")
        denom = torch.clamp(w.sum(), min=1.0) if w is not None else \
            torch.tensor(float(batch["labels"].numel()),
                         device=batch["labels"].device)
        batch = {k: local_block(v, specs[k], mesh)
                 for k, v in batch.items()}
    logits, aux = forward(
        cfg, params, batch["tokens"],
        frontend_embeds=batch.get("patches"),
        enc_frames=batch.get("frames"),
        prefix_len=batch.get("prefix_len"),
        mesh=mesh, remat=remat, seq_spec=seq_spec, rules=rules)
    labels = batch["labels"]
    # the frontend's positions carry no labels
    logits = logits[:, logits.shape[1] - labels.shape[1]:]
    logp = F.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, labels[..., None].long())[..., 0]
    w = batch.get("weights")
    if w is None:
        w = torch.ones_like(ll)
    if denom is None:
        denom = torch.clamp(w.sum(), min=1.0)
    ce = -(ll * w).sum() / denom * share
    # the z-loss stabiliser
    z = (torch.logsumexp(logits, dim=-1).square() * w).sum()
    aux_coef = MOE_AUX_COEF / (1 if mesh is None else mesh.data)
    total = ce + Z_LOSS_COEF * z / denom * share + aux_coef * aux
    return total, {"ce": ce, "aux": aux}


# ======================================================================
# the training graph over a mesh
# ======================================================================
def _fsdp(tree, specs, mesh):
    """The leaves of a layer's tree that ``specs`` shard over 'data'
    (FSDP), gathered whole for the layer that uses them."""
    if isinstance(tree, dict):
        return {k: _fsdp(v, specs[k], mesh) for k, v in tree.items()}
    if "data" not in spec_axes(specs):
        return tree
    dim = next(i for i, e in enumerate(specs) if "data" in spec_axes([e]))
    return C.gather_over_data(tree, dim, mesh)


def _unstack_specs(specs):
    """A stacked layer tree's specs without the leading [L] entry."""
    if isinstance(specs, dict):
        return {k: _unstack_specs(v) for k, v in specs.items()}
    return type(specs)(*specs[1:])


def _sharded(spec, dim: int) -> bool:
    return "model" in spec_axes([spec[dim]])


def _enter(tree, specs, mesh):
    """The leaves of a model-parallel block that a rank holds whole,
    through ``copy_to_model`` (each rank's gradient of one is its own
    part's); the sharded ones as they are."""
    return {n: t if "model" in spec_axes(specs[n]) else
            C.copy_to_model(t, mesh) for n, t in tree.items()}


def _split_check(ok: bool, what: str, mesh) -> None:
    """A block whose leaves the rules shard over 'model' only in part
    (one dim divides the axis, a related one does not) has no meshed
    form."""
    if not ok:
        raise ValueError(f"{what} do not split over {mesh.model} 'model' "
                         "ranks")


def _kv_heads(cfg, s, q, k, v, mesh):
    """The attention's K/V over this rank's query heads: ``k``/``v``
    themselves where the KV heads split over 'model' as the query heads
    do (or nothing splits), else cut to the KV heads of this rank's
    query heads (global head // G)."""
    if not _sharded(s["wq"], 1) or _sharded(s["wk"], 1):
        return k, v
    hl = q.shape[2]
    kv = (mesh.idx * hl + torch.arange(hl, device=q.device)) \
        // (cfg.num_heads // cfg.num_kv_heads)
    return k[:, :, kv], v[:, :, kv]


def _attn_mesh(cfg, lp, sp, x, positions, mask, mesh, *, rope=True,
               attend=None):
    """A layer's attention half with its heads sharded over 'model'
    (else the whole attention on every rank, no collective): the normed
    input enters through ``copy_to_model``, and so does every leaf the
    rank holds whole (``wk``/``wv`` and their biases where the KV heads
    do not divide 'model', the q/k norms), since each rank's gradient of
    it is a partial sum; the output leaves through
    ``reduce_from_model``. Replicated KV heads are cut to the ones of
    this rank's query heads (global head // G). mla shards ``w_uq``,
    ``w_uk``, ``w_uv`` and ``wo`` over heads: ``mla_forward(mesh=)``
    enters its latents. ``rope`` False: the encoder's layers.
    ``attend(q, k, v)`` (default: ``gqa_attention`` under ``mask``, or
    its surrogate) attends over this rank's heads: the serving
    encoder's ``flash_prefill``."""
    a, s = lp["attn"], sp["attn"]
    impl = cfg.attention_impl
    if attend is None:
        def attend(q, k, v):
            return L.gqa_attention(q, k, v, mask, impl=impl)
    h = L.rms_norm(x, lp["ln1"], cfg.rms_eps)
    if cfg.mla is not None:
        if not _sharded(s["w_uq"], 1):
            out, _ = mla_mod.mla_forward(a, cfg, h, positions,
                                         graph="train", mask=mask,
                                         impl=impl)
            return x + out
        out, _ = mla_mod.mla_forward(a, cfg, h, positions, graph="train",
                                     mask=mask, mesh=mesh, impl=impl)
        return x + C.reduce_from_model(out, mesh)
    if not _sharded(s["wq"], 1):
        q, k, v = L.attn_project_qkv(a, cfg, h, positions, rope=rope)
        return x + L.attn_output(a, attend(q, k, v))
    a = _enter(a, s, mesh)
    q, k, v = L.attn_project_qkv(a, cfg, C.copy_to_model(h, mesh),
                                 positions, rope=rope)
    out = L.attn_output(a, attend(q, *_kv_heads(cfg, s, q, k, v, mesh)))
    return x + C.reduce_from_model(out, mesh)


def _enc_kv(lp, enc_out):
    """A decoder layer's cross-attention K/V over the encoder's output
    [B, F, d] (this rank's heads over a mesh): [B, F, H, hd] each."""
    return (torch.einsum("bsd,dhe->bshe", enc_out, lp["xattn"]["wk"]),
            torch.einsum("bsd,dhe->bshe", enc_out, lp["xattn"]["wv"]))


def _xattn_mesh(cfg, lp, sp, x, k, v, mesh, attend):
    """A whisper decoder layer's cross-attention half, its heads (query
    and KV alike) sharded over 'model' (else whole on every rank), over
    the encoder's K/V ``k``/``v`` (``_enc_kv``; in training its output
    has entered through ``copy_to_model``, the caller's, once for every
    layer): the normed queries enter here, ``attend(q, k, v)`` attends,
    and the output leaves through ``reduce_from_model``."""
    a = lp["xattn"]
    sharded = _sharded(sp["xattn"]["wq"], 1)
    g = L.rms_norm(x, lp["ln_x"], cfg.rms_eps)
    if sharded:
        g = C.copy_to_model(g, mesh)
    q = torch.einsum("bsd,dhe->bshe", g, a["wq"])
    out = L.attn_output(a, attend(q, k, v))
    return x + (C.reduce_from_model(out, mesh) if sharded else out)


def _ssm_mesh(cfg, lp, sp, x, mesh):
    """A mamba2 layer with ``d_in`` and the heads sharded over 'model'
    (else whole on every rank): ``w_z``/``w_x``/``conv_x``/``norm`` by
    ``d_in``, ``w_dt``/``A_log``/``D``/``dt_bias`` by heads; ``w_B``,
    ``w_C`` and ``conv_bc`` held whole enter through ``copy_to_model``
    with the normed input; ``out_proj``'s rows leave through
    ``reduce_from_model``."""
    m, s = lp["mixer"], sp["mixer"]
    h = L.rms_norm(x, lp["ln1"], cfg.rms_eps)
    if not _sharded(s["w_x"], 1):
        y, _ = ssm_mod.mamba2_forward(m, cfg, h, graph="train")
        return x + y
    _split_check(_sharded(s["w_dt"], 1), "the mamba2 heads", mesh)
    y, _ = ssm_mod.mamba2_forward(_enter(m, s, mesh), cfg,
                                  C.copy_to_model(h, mesh), graph="train",
                                  mesh=mesh)
    return x + C.reduce_from_model(y, mesh)


def _rglru_mesh(cfg, lp, sp, x, mesh):
    """A Griffin recurrent block with its channels sharded over 'model'
    (else whole on every rank): ``in_gate``/``in_rec`` column-parallel,
    the conv, gates' biases and decay by channel, the block-diagonal
    ``w_a``/``w_x`` by block (a rank's channels are its blocks'), the
    scan local, ``out`` row-parallel through ``reduce_from_model``."""
    r, s = lp["rec"], sp["rec"]
    h = L.rms_norm(x, lp["ln1"], cfg.rms_eps)
    if not _sharded(s["in_rec"], 1):
        y, _ = rg.recurrent_block_forward(r, cfg, h, graph="train")
        return x + y
    _split_check(_sharded(s["w_a"], 0), "the RG-LRU gate blocks", mesh)
    y, _ = rg.recurrent_block_forward(r, cfg, C.copy_to_model(h, mesh),
                                      graph="train")
    return x + C.reduce_from_model(y, mesh)


def _mlp_mesh(cfg, lp, sp, x, mesh, kind, *, expert_tp: bool = False,
              rows: tuple = (), serve: bool = False):
    """A layer's MLP half and its aux loss (None for a dense MLP): the
    moe layer's ``moe_ep``, or the MLP tensor-parallel over ``d_ff``
    where it divides 'model' (else whole on every rank).

    ``serve`` (serving; ``rows``: the data axes x's rows split over, if
    any): ``expert_tp`` takes the moe layer's ``moe_tp`` over the whole
    batch, x gathered over ``rows`` first and this rank's rows kept
    after; ``moe_ep`` on rows the rules replicate over the data axes
    (``decode_2d``) takes this data rank's block of them and gathers
    the outputs back, as the reference's ``shard_map`` cuts its input
    over the data axes whatever the activations' layout."""
    h = L.rms_norm(x, lp["ln2"], cfg.rms_eps)
    if "moe" in lp and expert_tp:
        for a in reversed(rows):
            h = C.all_gather(h, 0, mesh, a)
        y, aux = moe_mod.moe_apply(lp["moe"], h, cfg, mesh=mesh,
                                   expert_tp=True)
        return x + local_block(y, P(tuple(rows) or None), mesh), aux
    if "moe" in lp:
        dax = tuple(a for a in mesh.axis_names if a != "model")
        cut = serve and not rows and mesh.data > 1 \
            and h.shape[0] % mesh.data == 0
        if cut:
            h = local_block(h, P(dax), mesh)
        y, aux = moe_mod.moe_apply(lp["moe"], h, cfg, mesh=mesh)
        if cut:
            for a in reversed(dax):
                y = C.all_gather(y, 0, mesh, a)
        return x + y, aux
    if _sharded(sp["mlp"]["w_up"], -1):
        return x + L.mlp_tp(lp["mlp"], h, kind, mesh), None
    return x + L.mlp_apply(lp["mlp"], h, kind), None


def _embed_mesh(cfg, params, specs, tokens, mesh):
    """The embedding's rows of this rank's vocabulary slice looked up,
    the other tokens zero, summed over 'model' (exact: one nonzero
    term)."""
    w = _fsdp(params["embed"], specs["embed"], mesh)
    if _sharded(specs["embed"], 0):
        n = w.shape[0]
        local = tokens - mesh.idx * n
        hit = (local >= 0) & (local < n)
        x = torch.where(hit[..., None], w[local.clamp(0, n - 1)], 0)
        x = C.reduce_from_model(x, mesh)
    else:
        x = w[tokens]
    x = x.to(cfg.activation_dtype())
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _logits_mesh(cfg, params, specs, x, mesh):
    """The logits of this rank's vocabulary slice, gathered over 'model'
    to the full [B, S, V] f32 (the loss then runs as on one device)."""
    x = L.rms_norm(x, params["final_norm"], cfg.rms_eps)
    if cfg.tie_embeddings:
        w = _fsdp(params["embed"], specs["embed"], mesh).T
        split = _sharded(specs["embed"], 0)
    else:
        w = _fsdp(params["unembed"], specs["unembed"], mesh)
        split = _sharded(specs["unembed"], 1)
    if split:
        x = C.copy_to_model(x, mesh)
    logits = (x @ w.to(x.dtype)).float()
    if split:
        logits = C.gather_from_model(logits, -1, mesh)
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def _encode_mesh(cfg, params, specs, frames, mesh, attend=None):
    """``encode``'s training graph over a mesh: the encoder's stacked
    layers through the meshed attention (no rope, no mask) and MLP
    (``attend``: ``_attn_mesh``'s, the serving encoder's kernel)."""
    enc, sp = params["encoder"], _unstack_specs(specs["encoder"]["layers"])
    B, nf, d = frames.shape
    dt = cfg.activation_dtype()
    x = frames.to(dt) + L.sinusoidal_positions(nf, d, frames.device).to(dt)
    positions = torch.arange(nf, dtype=torch.int32,
                             device=x.device).expand(B, nf)
    mask = torch.ones((B, nf, nf), dtype=torch.bool, device=x.device)
    for lp in _unstack(enc["layers"]):
        lp = _fsdp(lp, sp, mesh)
        x = _attn_mesh(cfg, lp, sp, x, positions, mask, mesh, rope=False,
                       attend=attend)
        x, _ = _mlp_mesh(cfg, lp, sp, x, mesh, cfg.mlp_kind)
    return L.rms_norm(x, enc["final_norm"], cfg.rms_eps)


def _forward_mesh(cfg, params, tokens, mesh, rules, remat, *,
                  frontend_embeds=None, prefix_len=None, enc_frames=None):
    """``forward`` over a mesh, every family: each leaf this rank's
    block of it (``rules.params``), FSDP leaves gathered over 'data'
    inside the layer that uses them (and, under ``remat``, again in its
    recomputation), the collectives of ``distributed/collectives.py``
    where the reference's GSPMD puts its own. The vlm patches are
    prepended under the prefix-LM mask, the hybrid's list of layers runs
    as ``forward``'s (no remat), the encdec decoder attends over the
    encoder's output. Returns the full logits and the aux loss."""
    specs = rules.params(param_shapes(cfg))
    x = _embed_mesh(cfg, params, specs, tokens, mesh)
    x = _frontend_concat(x, frontend_embeds)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    mask = L.attention_mask(positions, positions, causal=True,
                            window=cfg.sliding_window, prefix_len=prefix_len)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    fam = cfg.family

    if fam == "hybrid":
        local_mask = L.attention_mask(positions, positions, causal=True,
                                      window=cfg.rglru.local_window)
        for lp, sp, kind in zip(params["layers"], specs["layers"],
                                cfg.block_kinds()):
            lp = _fsdp(lp, sp, mesh)
            if kind == "rglru":
                x = _rglru_mesh(cfg, lp, sp, x, mesh)
            else:
                x = _attn_mesh(cfg, lp, sp, x, positions, local_mask, mesh)
            x, _ = _mlp_mesh(cfg, lp, sp, x, mesh, cfg.mlp_kind)
        return _logits_mesh(cfg, params, specs, x, mesh), aux

    sp = _unstack_specs(specs["layers"])
    if fam == "encdec":
        enc_out = _encode_mesh(cfg, params, specs, enc_frames, mesh)
        if _sharded(sp["xattn"]["wq"], 1):
            enc_out = C.copy_to_model(enc_out, mesh)
        xmask = torch.ones((B, S, enc_out.shape[1]), dtype=torch.bool,
                           device=x.device)

    def layer(h, lp, sp, kind):
        lp = _fsdp(lp, sp, mesh)
        if fam == "ssm":
            return _ssm_mesh(cfg, lp, sp, h, mesh), None
        h = _attn_mesh(cfg, lp, sp, h, positions, mask, mesh)
        if fam == "encdec":
            h = _xattn_mesh(cfg, lp, sp, h, *_enc_kv(lp, enc_out), mesh,
                            lambda q, k, v: L.gqa_attention(
                                q, k, v, xmask, impl=cfg.attention_impl))
        return _mlp_mesh(cfg, lp, sp, h, mesh, kind)

    for lp, sq in zip(params.get("layers_pre", []),
                      specs.get("layers_pre", [])):
        # the leading dense layers: outside the remat
        x, _ = layer(x, lp, sq, cfg.mlp_kind)
    for lp in _unstack(params["layers"]):
        if remat:
            x, a = checkpoint(layer, x, lp, sp, cfg.mlp_kind,
                              use_reentrant=False)
        else:
            x, a = layer(x, lp, sp, cfg.mlp_kind)
        if a is not None:
            aux = aux + a
    return _logits_mesh(cfg, params, specs, x, mesh), aux


# ======================================================================
# ring KV cache
# ======================================================================
def cache_window(cfg, capacity: int) -> int:
    if cfg.family == "hybrid":
        return min(capacity, cfg.rglru.local_window)
    if cfg.sliding_window is not None:
        return min(capacity, cfg.sliding_window)
    return capacity


def init_cache(cfg, batch: int, capacity: int, device, *,
               enc_frames: int = 0):
    """An empty decode cache on ``device``: ring buffers of W slots for
    the attention layers (K/V, or mla's latent ``ckv`` [L, B, W,
    kv_lora] and rope key ``k_rope`` [L, B, W, rope]), the conv caches
    and f32 state of the ssm and rglru layers, and (encdec) the
    cross-attention K/V over ``enc_frames`` encoder frames."""
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
    hd = cfg.resolved_head_dim
    n_att = cfg.num_layers
    if cfg.family == "hybrid":
        kinds = cfg.block_kinds()
        n_att = kinds.count("local_attn")
        w = cfg.rglru.lru_width or cfg.d_model
        n_rec = kinds.count("rglru")
        cache["rec_h"] = torch.zeros((n_rec, batch, w), dtype=torch.float32,
                                     device=device)
        cache["rec_conv"] = torch.zeros(
            (n_rec, batch, cfg.rglru.conv_width - 1, w), dtype=dtype,
            device=device)
    if cfg.mla is not None:
        m = cfg.mla
        cache["ckv"] = torch.zeros((n_att, batch, W, m.kv_lora_rank),
                                   dtype=dtype, device=device)
        cache["k_rope"] = torch.zeros((n_att, batch, W, m.rope_head_dim),
                                      dtype=dtype, device=device)
    else:
        shape = (n_att, batch, W, cfg.num_kv_heads, hd)
        cache["k"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=device)
    cache["kv_pos"] = torch.full((batch, W), -1, dtype=torch.int32,
                                 device=device)
    if cfg.family == "encdec":
        cache["cross_k"] = torch.zeros(
            (cfg.num_layers, batch, enc_frames, cfg.num_heads, hd),
            dtype=dtype, device=device)
        cache["cross_v"] = torch.zeros_like(cache["cross_k"])
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
            frontend_embeds=None, enc_frames=None, plain: bool = False,
            mesh=None, rules=None, capacity=None):
    """Run the full prompt, fill the cache. Returns (last_logits [B, V],
    cache).

    Supports S > W (the ring keeps the last W positions). ``seq_lens``
    marks the true per-row prompt length (padded rows produce masked
    cache slots, and the moe layers route only the valid tokens).
    The attention is ``flash_prefill`` with the causal (and window)
    mask: for every valid row this is the reference's masked
    ``gqa_attention`` exactly, since causality already hides every key
    past ``seq_lens``. The encdec family needs ``enc_frames`` [B, F, d]:
    the encoder runs first, and every decoder layer attends over its
    output without a mask. The hybrid family's recurrence runs over a
    padded row's padding, as the reference's does (the engine prefills
    one row); past a local-attention layer the padding's activations
    are not the reference's (no key past a row's length is masked), so
    neither is such a row's state. ``plain`` (tests and the chip check
    only) runs the kernels' plain versions on any device, to hold the
    kernels' prefill against it; it is never a fallback.

    ``frontend_embeds`` [B, F, d] (vlm) are prepended to the tokens;
    ``seq_lens`` then counts them too. ``prefix_len`` [B] makes the
    self-attention bidirectional within the prefix (the prefix-LM
    mask). ``flash_prefill`` has no such mask, nor has the TPU kernel it
    ports, so under it the attention layers take the reference's own
    path: the masked ``gqa_attention`` (mla: ``mla_forward``'s training
    graph), over the whole sequence. The hybrid's local attention and
    the ssm mixer take no prefix, as in the reference.

    ``mesh`` (a rank's mesh, ``launch/mesh.py``; ``rules`` default
    ``ShardingRules(cfg, mesh, mode="prefill")``): ``_prefill_mesh``,
    on this rank's blocks of ``params`` and ``cache``; ``capacity`` is
    the ring's as ``init_cache`` was given it (default: the prompt's
    length)."""
    if (cfg.family == "encdec") != (enc_frames is not None):
        raise ValueError("enc_frames is required for the encdec family, "
                         "and only for it")
    if mesh is not None:
        return _prefill_mesh(
            cfg, params, tokens, cache, mesh,
            rules or ShardingRules(cfg, mesh, mode="prefill"), capacity,
            seq_lens=seq_lens, prefix_len=prefix_len,
            frontend_embeds=frontend_embeds, enc_frames=enc_frames,
            plain=plain)
    x = _frontend_concat(_embed(cfg, params, tokens), frontend_embeds)
    B, S, _ = x.shape
    dev = x.device
    full = seq_lens is None
    if full:
        seq_lens = torch.full((B,), S, dtype=torch.int32, device=dev)
    positions = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    valid = positions < seq_lens[:, None]
    # the moe layers route only the valid tokens; a full batch needs no
    # mask (and so no host sync)
    mlp_valid = None if full else valid

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
                keep = valid.reshape(valid.shape + (1,) * (new.dim() - 2))
                buf.copy_(torch.where(keep, new,
                                      torch.zeros((), dtype=new.dtype,
                                                  device=dev)))
            else:
                _ring_write(buf, slots, new)

        attend = ref.flash_prefill_ref if plain else flash_prefill
        window = cfg.rglru.local_window if cfg.family == "hybrid" \
            else cfg.sliding_window
        pmask = None
        if prefix_len is not None and cfg.family != "hybrid":
            pmask = L.attention_mask(
                positions, positions, causal=True, window=window,
                prefix_len=prefix_len) & valid[:, None, :]
        if enc_frames is not None:
            enc_out = encode(cfg, params, enc_frames, plain=plain)
        ai = ri = 0
        for i, (lp, kind) in enumerate(zip(layer_params(params),
                                           cfg.block_kinds())):
            h = L.rms_norm(x, lp["ln1"], cfg.rms_eps)
            if kind == "rglru":
                y, (cc, hl) = rg.recurrent_block_forward(lp["rec"], cfg, h)
                cache["rec_conv"][ri] = cc
                cache["rec_h"][ri] = hl
                x = x + y
                ri += 1
            elif cfg.mla is not None:
                a, (ckv, kr) = mla_mod.mla_forward(
                    lp["attn"], cfg, h, positions, plain=plain,
                    graph="serve" if pmask is None else "train", mask=pmask,
                    impl=cfg.attention_impl)
                x = x + a
                write(cache["ckv"][ai], ckv)
                write(cache["k_rope"][ai], kr)
                ai += 1
            else:
                q, k, v = L.attn_project_qkv(lp["attn"], cfg, h, positions)
                a = _prefill_attend(cfg, attend, q, k, v, window=window,
                                    mask=pmask)
                x = x + L.attn_output(lp["attn"], a)
                write(cache["k"][ai], k)
                write(cache["v"][ai], v)
                ai += 1
            if "xattn" in lp:
                kx = torch.einsum("bsd,dhe->bshe", enc_out,
                                  lp["xattn"]["wk"])
                vx = torch.einsum("bsd,dhe->bshe", enc_out,
                                  lp["xattn"]["wv"])
                x = _cross_attention(
                    lp, cfg, x, kx, vx,
                    lambda q, k, v: _prefill_attend(cfg, attend, q, k, v,
                                                    causal=False))
                cache["cross_k"][i] = kx
                cache["cross_v"][i] = vx
            x = _mlp_block(cfg, lp, x, mlp_valid)
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
def decode_step(cfg, params, tokens, cache, valid=None, *, mesh=None,
                rules=None, capacity=None):
    """tokens [B] -> (logits [B, V], cache). One AR step per sequence;
    the cache is written in place. ``valid`` [B] bool marks the rows
    whose tokens the moe layers route (None: all); the others still
    step. ``mesh``: ``_decode_mesh`` (``rules`` default
    ``ShardingRules(cfg, mesh, mode="decode")``; ``capacity`` the
    ring's, required where there is a ring)."""
    if mesh is not None:
        if valid is not None:
            raise ValueError("over a mesh the moe layers route every row "
                             "(the reference's): no valid mask")
        return _decode_mesh(cfg, params, tokens, cache, mesh,
                            rules or ShardingRules(cfg, mesh, mode="decode"),
                            capacity)
    B = tokens.shape[0]
    x = _embed(cfg, params, tokens[:, None])
    q_pos = cache["len"][:, None]                       # [B, 1]
    if valid is not None:
        valid = valid[:, None]

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
        window = cfg.rglru.local_window if cfg.family == "hybrid" \
            else cfg.sliding_window
        mask = _decode_mask(cfg, q_pos, cache["kv_pos"], window)
        if cfg.family == "encdec":
            xmask = torch.ones((B, 1, cache["cross_k"].shape[2]),
                               dtype=torch.bool, device=x.device)
        ai = ri = 0
        for i, (lp, kind) in enumerate(zip(layer_params(params),
                                           cfg.block_kinds())):
            h = L.rms_norm(x, lp["ln1"], cfg.rms_eps)
            if kind == "rglru":
                y, (cc, hh) = rg.recurrent_block_decode(
                    lp["rec"], cfg, h, cache["rec_conv"][ri],
                    cache["rec_h"][ri])
                cache["rec_conv"][ri] = cc
                cache["rec_h"][ri] = hh
                x = x + y
                ri += 1
            elif cfg.mla is not None:
                # the latents go into the ring first, then the absorbed
                # attention reads them with the rest of the ring
                ckv, kr = mla_mod._project_kv_latent(lp["attn"], cfg, h,
                                                     q_pos)
                kc, vc = cache["ckv"][ai], cache["k_rope"][ai]
                kc[rows, slots] = ckv.to(kc.dtype)
                vc[rows, slots] = kr.to(vc.dtype)
                x = x + mla_mod.mla_decode(lp["attn"], cfg, h, q_pos, kc, vc,
                                           mask)
                ai += 1
            else:
                q, k, v = L.attn_project_qkv(lp["attn"], cfg, h, q_pos)
                kc, vc = cache["k"][ai], cache["v"][ai]
                kc[rows, slots] = k.to(kc.dtype)
                vc[rows, slots] = v.to(vc.dtype)
                a = L.gqa_attention(q, kc, vc, mask)
                x = x + L.attn_output(lp["attn"], a)
                ai += 1
            if "xattn" in lp:
                x = _cross_attention(
                    lp, cfg, x, cache["cross_k"][i], cache["cross_v"][i],
                    lambda q, k, v: L.gqa_attention(q, k, v, xmask))
            x = _mlp_block(cfg, lp, x, valid)
    cache["len"] += 1
    return _logits(cfg, params, x)[:, 0], cache


# ======================================================================
# serving over a mesh
# ======================================================================
# Each rank holds the blocks of the parameters that ``rules.params``
# gives it and the block of the cache that ``rules.cache`` lays out: its
# rows of the batch where they split over the data axes, its heads (or
# channels) of the ssm state, the conv caches, the RG-LRU state and the
# cross-attention K/V, and its stripe of the ring's slots for every KV
# head (the ring splits over the sequence: over 'model', or in
# ``decode_2d`` over every data axis then 'model'). The attention runs
# over this rank's heads, so a rank's heads and its slots differ:
#
# - prefill writes each rank's stripe of positions for every KV head:
#   where the KV heads split over 'model', an all-to-all over 'model'
#   hands each rank its stripe of every rank's heads (an all-gather
#   where the ring does not split); the latents of mla are whole on
#   every rank;
# - decode gathers the [b, 1, Hq, D] query (mla: the absorbed query and
#   its rope part) over 'model'; each rank attends its stripe of slots
#   for every head, the softmax's max taken over the stripe's axes
#   (all-reduce MAX), then its sum and the probability-weighted values
#   (all-reduce SUM: a rank whose stripe holds no valid slot adds
#   zeros), and it keeps its own heads for ``wo``, whose partial
#   outputs sum over 'model'.
#
# The rest is training's meshed blocks: the embedding and logits over
# the vocabulary, the MLP over ``d_ff``, ``moe_ep`` (``moe_tp`` under
# ``rules.expert_tp``), the mamba2 and RG-LRU channels, FSDP leaves
# gathered over 'data' at the layer that uses them (the expert leaves
# of ``expert_tp`` stay split: ``moe_tp`` sums their products).
class _Ring:
    """This rank's stripe of a ring of ``W`` slots, the one slot -> rank
    map prefill and decode share: slots [lo, lo + w), the stripe's
    index row-major over ``axes`` (the ring's sequence spec)."""

    def __init__(self, W: int, spec_entry, mesh):
        self.W = W
        self.axes = () if spec_entry is None else (
            spec_entry if isinstance(spec_entry, tuple) else (spec_entry,))
        n, i = 1, 0
        for a in self.axes:
            n, i = n * mesh.shape[a], i * mesh.shape[a] + mesh.coord(a)
        self.n, self.w = n, W // n
        # the axes the softmax merges over (an axis of one rank adds
        # nothing: one stripe is the reference's softmax itself)
        self.merge = tuple(a for a in self.axes if mesh.shape[a] > 1)
        self.lo = i * self.w
        # the stripes of this rank's 'model' group: [outer * M, ...)
        self.group_lo = (i // mesh.model) * mesh.model * self.w \
            if "model" in self.axes else self.lo

    def prefill_positions(self, S: int, seq_lens, first: int, count: int):
        """(p [count], ok [b, count]): for slots [first, first + count),
        the position whose K/V prefill writes there (the last of the
        last W positions congruent to the slot mod W) and whether it is
        a valid one of each row."""
        dev = seq_lens.device
        j = torch.arange(first, first + count, device=dev)
        p = (S - self.W) + torch.remainder(j - (S - self.W), self.W)
        ok = (p >= 0)[None, :] & (p[None, :] < seq_lens[:, None])
        return p.clamp(min=0), ok

    def decode_slot(self, q_pos):
        """(local slot [b, 1] clamped into the stripe, inside [b, 1]): the
        slot of ``q_pos`` [b, 1] in this stripe, and whether it is in
        it."""
        local = torch.remainder(q_pos, self.W).long() - self.lo
        inside = (local >= 0) & (local < self.w)
        return local.clamp(0, self.w - 1), inside


def _rows_spec(rules, batch: int) -> tuple:
    """The data axes the batch's rows split over (the cache's batch
    spec), as a tuple."""
    e = rules.rows_spec(batch)
    return () if e is None else (e if isinstance(e, tuple) else (e,))


def _rows(t, rows, mesh):
    """This rank's rows of a global [B, ...] tensor (None stays None)."""
    if t is None:
        return None
    return local_block(t, P(tuple(rows) or None), mesh)


def _serve_specs(cfg, params, rules, mesh):
    """(layers, specs): [(lp, sp, kind)] in execution order, each layer's
    specs without the stack's [L] entry, and the tree's specs."""
    specs = rules.params(param_shapes(cfg))
    if cfg.family == "hybrid":
        out = list(zip(params["layers"], specs["layers"],
                       cfg.block_kinds()))
        return out, specs
    sp = _unstack_specs(specs["layers"])
    out = [(lp, sq, "attn") for lp, sq in zip(params.get("layers_pre", []),
                                               specs.get("layers_pre", []))]
    out += [(lp, sp, "attn") for lp in _unstack(params["layers"])]
    if cfg.family == "ssm":
        out = [(lp, sq, "ssm") for lp, sq, _ in out]
    return out, specs


def _gather_specs(sp, rules):
    """The specs ``_fsdp`` gathers a layer by: under ``expert_tp`` the
    moe expert leaves' 'data' split is left to ``moe_tp``."""
    if not (rules.expert_tp and "moe" in sp):
        return sp
    moe = dict(sp["moe"])
    for k in ("w_gate", "w_up", "w_down"):
        moe[k] = P(*(None if e == "data" else e for e in moe[k]))
    return {**sp, "moe": moe}


def _stripe_kv(ring, t, p, split_heads: bool, mesh):
    """This rank's stripe of slots of ``t`` [b, S, H, D] (its K or V,
    this rank's KV heads where ``split_heads``) for every KV head, each
    slot from position ``p`` (the group's slots' positions, from
    ``ring.group_lo``)."""
    if not split_heads:
        return t[:, p[ring.lo - ring.group_lo:][:ring.w]]
    if "model" in ring.axes:
        # [b, M * w, h, D] of the group's stripes: block m to rank m,
        # every rank's heads laid side by side
        return C.all_to_all(t[:, p], 1, 2, mesh, "model")
    return C.all_gather(t[:, p], 2, mesh, "model")


def _write_stripe(buf, new, ok, fresh: bool):
    """buf [b, w, ...] <- new where ``ok`` [b, w]; elsewhere zeros on a
    fresh full-capacity ring (W == S: the reference's select) or what
    ``buf`` held (its dropping scatter)."""
    keep = ok.reshape(ok.shape + (1,) * (new.dim() - 2))
    other = torch.zeros((), dtype=buf.dtype, device=buf.device) \
        if fresh else buf
    buf.copy_(torch.where(keep, new.to(buf.dtype), other))


def _prefill_mesh(cfg, params, tokens, cache, mesh, rules, capacity, *,
                  seq_lens=None, prefix_len=None, frontend_embeds=None,
                  enc_frames=None, plain=False):
    """``prefill`` over a mesh. ``tokens`` (and ``seq_lens``,
    ``prefix_len``, ``frontend_embeds``, ``enc_frames``) are the whole
    batch, the same on every rank; ``params`` and ``cache`` this rank's
    blocks. Returns this rank's rows' last logits [b, V] (the whole
    vocabulary) and the cache, written in place. The attention runs
    through ``flash_prefill`` on this rank's heads (or the prefix-LM
    mask's ``gqa_attention``, or the surrogate), the ssm scan through
    ``ssd_scan``; the moe layers route every token."""
    B = tokens.shape[0]
    S = tokens.shape[1] + (0 if frontend_embeds is None
                           else frontend_embeds.shape[1])
    rows = _rows_spec(rules, B)
    layers, specs = _serve_specs(cfg, params, rules, mesh)
    tokens = _rows(tokens, rows, mesh)
    x = _embed_mesh(cfg, params, specs, tokens, mesh)
    x = _frontend_concat(x, _rows(frontend_embeds, rows, mesh))
    b = x.shape[0]
    dev = x.device
    full = seq_lens is None
    seq_lens = torch.full((b,), S, dtype=torch.int32, device=dev) if full \
        else _rows(seq_lens, rows, mesh)
    prefix_len = _rows(prefix_len, rows, mesh)
    positions = torch.arange(S, dtype=torch.int32, device=dev).expand(b, S)
    valid = positions < seq_lens[:, None]
    attend = ref.flash_prefill_ref if plain else flash_prefill
    mlp = dict(expert_tp=rules.expert_tp, rows=rows, serve=True)
    fam = cfg.family
    if fam != "ssm":
        W = cache_window(cfg, capacity or S)
        ring = _Ring(W, rules.ring_spec(W), mesh)
        fresh = ring.W == S
        n_group = ring.w * (mesh.model if "model" in ring.axes else 1)
        p_group, _ = ring.prefill_positions(S, seq_lens, ring.group_lo,
                                            n_group)
        p_own, ok = ring.prefill_positions(S, seq_lens, ring.lo, ring.w)
        window = cfg.rglru.local_window if fam == "hybrid" \
            else cfg.sliding_window
        pmask = None
        if prefix_len is not None and fam != "hybrid":
            pmask = L.attention_mask(
                positions, positions, causal=True, window=window,
                prefix_len=prefix_len) & valid[:, None, :]
    if enc_frames is not None:
        def enc_attend(q, k, v):
            return _prefill_attend(cfg, attend, q, k, v, causal=False)
        enc_out = _encode_mesh(cfg, params, specs,
                               _rows(enc_frames, rows, mesh), mesh,
                               attend=enc_attend)
    ai = ri = 0
    for i, (lp, sp, kind) in enumerate(layers):
        lp = _fsdp(lp, _gather_specs(sp, rules), mesh)
        h = L.rms_norm(x, lp["ln1"], cfg.rms_eps)
        if kind == "ssm":
            m, s = lp["mixer"], sp["mixer"]
            split = _sharded(s["w_x"], 1)
            if split:
                _split_check(_sharded(s["w_dt"], 1), "the mamba2 heads", mesh)
            y, (cxc, cbc, st) = ssm_mod.mamba2_forward(
                m, cfg, h, plain=plain, mesh=mesh if split else None)
            x = x + (C.reduce_from_model(y, mesh) if split else y)
            cache["conv_x"][i] = cxc
            cache["conv_bc"][i] = cbc
            cache["ssm_state"][i] = st
            continue
        if kind == "rglru":
            split = _sharded(sp["rec"]["in_rec"], 1)
            if split:
                _split_check(_sharded(sp["rec"]["w_a"], 0),
                             "the RG-LRU gate blocks", mesh)
            y, (cc, hl) = rg.recurrent_block_forward(lp["rec"], cfg, h)
            x = x + (C.reduce_from_model(y, mesh) if split else y)
            cache["rec_conv"][ri] = cc
            cache["rec_h"][ri] = hl
            ri += 1
        elif cfg.mla is not None:
            a, s = lp["attn"], sp["attn"]
            split = _sharded(s["w_uq"], 1)
            out, (ckv, kr) = mla_mod.mla_forward(
                a, cfg, h, positions, plain=plain,
                graph="serve" if pmask is None else "train", mask=pmask,
                mesh=mesh if split else None, impl=cfg.attention_impl)
            x = x + (C.reduce_from_model(out, mesh) if split else out)
            _write_stripe(cache["ckv"][ai], ckv[:, p_own], ok, fresh)
            _write_stripe(cache["k_rope"][ai], kr[:, p_own], ok, fresh)
            ai += 1
        else:
            a, s = lp["attn"], sp["attn"]
            heads = _sharded(s["wq"], 1)
            q, k, v = L.attn_project_qkv(a, cfg, h, positions)
            ka, va = _kv_heads(cfg, s, q, k, v, mesh)
            o = _prefill_attend(cfg, attend, q, ka, va, window=window,
                                mask=pmask)
            out = L.attn_output(a, o)
            x = x + (C.reduce_from_model(out, mesh) if heads else out)
            kv_split = heads and _sharded(s["wk"], 1)
            for name, t in (("k", k), ("v", v)):
                _write_stripe(cache[name][ai],
                              _stripe_kv(ring, t, p_group, kv_split, mesh),
                              ok, fresh)
            ai += 1
        if "xattn" in lp:
            kx, vx = _enc_kv(lp, enc_out)
            x = _xattn_mesh(cfg, lp, sp, x, kx, vx, mesh,
                            lambda q, k, v: _prefill_attend(
                                cfg, attend, q, k, v, causal=False))
            cache["cross_k"][i] = kx
            cache["cross_v"][i] = vx
        x, _ = _mlp_mesh(cfg, lp, sp, x, mesh, cfg.mlp_kind, **mlp)
    if fam != "ssm":
        cache["kv_pos"].copy_(torch.where(ok, p_own[None, :].to(
            torch.int32), -1))
    cache["len"].copy_(seq_lens)
    last = (seq_lens.long() - 1).clamp(min=0)
    xl = x[torch.arange(b, device=dev), last]
    return _logits_mesh(cfg, params, specs, xl[:, None], mesh)[:, 0], cache


def _stripe_probs(logits, axes, mesh):
    """The softmax over every stripe's keys of ``logits`` f32 [..., w]
    (masked: ``NEG_INF``), this stripe's part: the max over the stripes
    first, then the sum of the exponentials."""
    if not axes:
        return torch.softmax(logits, dim=-1)
    m = logits.amax(dim=-1, keepdim=True)
    for a in axes:
        C.all_reduce(m, mesh, a, op=torch.distributed.ReduceOp.MAX)
    p = torch.exp(logits - m)
    den = p.sum(dim=-1, keepdim=True)
    for a in axes:
        C.all_reduce(den, mesh, a)
    return p / den


def _stripe_product(eq, probs, vals, axes, mesh):
    """``einsum(eq, probs, vals)`` summed over the stripes: the
    probabilities cast to the values' type, as the reference's product
    takes them, the stripes' partial products summed in f32 and cast
    once (one stripe: the reference's product itself)."""
    pv = probs.to(vals.dtype)
    if not axes:
        return torch.einsum(eq, pv, vals)
    out = torch.einsum(eq, pv.float(), vals.float())
    for a in axes:
        C.all_reduce(out, mesh, a)
    return out.to(vals.dtype)


def _decode_mesh(cfg, params, tokens, cache, mesh, rules, capacity):
    """``decode_step`` over a mesh: ``tokens`` [B] the whole batch, the
    same on every rank; ``params`` and ``cache`` this rank's blocks.
    Returns this rank's rows' logits [b, V] (the whole vocabulary) and
    the cache, written in place."""
    B = tokens.shape[0]
    fam = cfg.family
    if fam != "ssm" and capacity is None:
        raise ValueError("decode over a mesh needs the ring's capacity")
    rows = _rows_spec(rules, B)
    layers, specs = _serve_specs(cfg, params, rules, mesh)
    x = _embed_mesh(cfg, params, specs, _rows(tokens, rows, mesh)[:, None],
                    mesh)
    b = x.shape[0]
    q_pos = cache["len"][:, None]                       # [b, 1]
    mlp = dict(expert_tp=rules.expert_tp, rows=rows, serve=True)
    if fam != "ssm":
        W = cache_window(cfg, capacity)
        ring = _Ring(W, rules.ring_spec(W), mesh)
        ls, inside = ring.decode_slot(q_pos)
        brow = torch.arange(b, device=x.device)[:, None]

        def put(buf, new):
            """buf [b, w, ...] at this row's slot, where it is in the
            stripe."""
            keep = inside.reshape(inside.shape + (1,) * (new.dim() - 2))
            buf[brow, ls] = torch.where(keep, new.to(buf.dtype),
                                        buf[brow, ls])
        put(cache["kv_pos"], q_pos)
        window = cfg.rglru.local_window if fam == "hybrid" \
            else cfg.sliding_window
        mask = _decode_mask(cfg, q_pos, cache["kv_pos"], window)
        if fam == "encdec":
            xmask = torch.ones((b, 1, cache["cross_k"].shape[2]),
                               dtype=torch.bool, device=x.device)
    ai = ri = 0
    for i, (lp, sp, kind) in enumerate(layers):
        lp = _fsdp(lp, _gather_specs(sp, rules), mesh)
        h = L.rms_norm(x, lp["ln1"], cfg.rms_eps)
        if kind == "ssm":
            split = _sharded(sp["mixer"]["w_x"], 1)
            y, (cxc, cbc, st) = ssm_mod.mamba2_decode(
                lp["mixer"], cfg, h, (cache["conv_x"][i],
                                      cache["conv_bc"][i]),
                cache["ssm_state"][i], mesh=mesh if split else None)
            x = x + (C.reduce_from_model(y, mesh) if split else y)
            cache["conv_x"][i] = cxc
            cache["conv_bc"][i] = cbc
            cache["ssm_state"][i] = st
            continue
        if kind == "rglru":
            split = _sharded(sp["rec"]["in_rec"], 1)
            y, (cc, hh) = rg.recurrent_block_decode(
                lp["rec"], cfg, h, cache["rec_conv"][ri], cache["rec_h"][ri])
            x = x + (C.reduce_from_model(y, mesh) if split else y)
            cache["rec_conv"][ri] = cc
            cache["rec_h"][ri] = hh
            ri += 1
        elif cfg.mla is not None:
            x = x + _mla_decode_mesh(cfg, lp["attn"], sp["attn"], h, q_pos,
                                     cache["ckv"][ai], cache["k_rope"][ai],
                                     mask, ring, put, mesh)
            ai += 1
        else:
            a, s = lp["attn"], sp["attn"]
            heads = _sharded(s["wq"], 1)
            q, k, v = L.attn_project_qkv(a, cfg, h, q_pos)
            if heads and _sharded(s["wk"], 1):
                k = C.all_gather(k, 2, mesh, "model")
                v = C.all_gather(v, 2, mesh, "model")
            kc, vc = cache["k"][ai], cache["v"][ai]
            put(kc, k)
            put(vc, v)
            qa = C.all_gather(q, 2, mesh, "model") if heads else q
            Bq, Sq, Hq, D = qa.shape
            G = Hq // kc.shape[2]
            logits = torch.einsum(
                "bqhgd,bkhd->bhgqk",
                qa.reshape(Bq, Sq, kc.shape[2], G, D).float(),
                kc.float()) / math.sqrt(D)
            logits = logits.masked_fill(~mask[:, None, None], L.NEG_INF)
            o = _stripe_product("bhgqk,bkhd->bqhgd",
                                _stripe_probs(logits, ring.merge, mesh), vc,
                                ring.merge, mesh).reshape(Bq, Sq, Hq, -1)
            if heads:
                hl = q.shape[2]
                o = o[:, :, mesh.idx * hl:(mesh.idx + 1) * hl]
            out = L.attn_output(a, o)
            x = x + (C.reduce_from_model(out, mesh) if heads else out)
            ai += 1
        if "xattn" in lp:
            x = _xattn_mesh(cfg, lp, sp, x, cache["cross_k"][i],
                            cache["cross_v"][i], mesh,
                            lambda q, k, v: L.gqa_attention(q, k, v, xmask))
        x, _ = _mlp_mesh(cfg, lp, sp, x, mesh, cfg.mlp_kind, **mlp)
    cache["len"] += 1
    return _logits_mesh(cfg, params, specs, x, mesh)[:, 0], cache


def _mla_decode_mesh(cfg, a, s, h, q_pos, kc, vc, mask, ring, put, mesh):
    """``mla_decode`` over a mesh, with this token's latents written into
    this rank's stripe first (``put``): the absorbed query and its rope
    part made whole over 'model', every head attending this stripe's
    slots, the latent output summed over the stripes, this rank's heads
    through ``w_uv`` and ``wo``; the partial output for the caller
    (summed over 'model' here where the heads split)."""
    m = cfg.mla
    ckv, kr = mla_mod._project_kv_latent(a, cfg, h, q_pos)
    put(kc, ckv)
    put(vc, kr)
    heads = _sharded(s["w_uq"], 1)
    q_nope, q_rope = mla_mod._project_q(a, cfg, h, q_pos)
    q_abs = torch.einsum("bqhe,rhe->bqhr", q_nope, a["w_uk"])
    if heads:
        q_abs = C.all_gather(q_abs, 2, mesh, "model")
        q_rope = C.all_gather(q_rope, 2, mesh, "model")
    scale = 1.0 / math.sqrt(m.nope_head_dim + m.rope_head_dim)
    logits = (torch.einsum("bqhr,bkr->bhqk", q_abs.float(), kc.float())
              + torch.einsum("bqhe,bke->bhqk", q_rope.float(),
                             vc.float())) * scale
    logits = torch.where(mask[:, None, :, :], logits,
                         torch.tensor(L.NEG_INF, device=logits.device))
    o_lat = _stripe_product("bhqk,bkr->bqhr",
                            _stripe_probs(logits, ring.merge, mesh), kc,
                            ring.merge, mesh)
    if heads:
        hl = a["w_uv"].shape[1]
        o_lat = o_lat[:, :, mesh.idx * hl:(mesh.idx + 1) * hl]
    out = torch.einsum("bqhr,rhe->bqhe", o_lat, a["w_uv"])
    out = torch.einsum("bshe,hed->bsd", out, a["wo"])
    return C.reduce_from_model(out, mesh) if heads else out
