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
"""
from __future__ import annotations

import functools

import numpy as np
import torch

import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import ShardingRules, local_block, \
    spec_axes
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


def _not_ported(what: str, item: str = "6") -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue 1 item {item})")


def _check_ported(cfg) -> None:
    """The ring-cache model serves every family and both attentions; the
    dry run's surrogate attention is not ported."""
    if cfg.attention_impl != "einsum":
        raise _not_ported(f"attention_impl={cfg.attention_impl!r}")


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


def encode(cfg, params, frames, *, plain: bool = False,
           graph: str = "serve"):
    """The whisper encoder over stub frame embeddings [B, F, d]: the
    sinusoidal positions added, then non-causal self-attention layers
    through ``flash_prefill`` (``plain``: its plain version; ``graph``
    "train": ``gqa_attention`` unmasked, as the reference's)."""
    enc = params["encoder"]
    B, nf, d = frames.shape
    dt = cfg.activation_dtype()
    x = frames.to(dt) + L.sinusoidal_positions(nf, d, frames.device).to(dt)
    positions = torch.arange(nf, dtype=torch.int32,
                             device=x.device).expand(B, nf)
    if graph == "train":
        mask = torch.ones((B, nf, nf), dtype=torch.bool, device=x.device)

        def attend(q, k, v):
            return L.gqa_attention(q, k, v, mask)
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
                                   graph="train", mask=mask)
        return x + a
    q, k, v = L.attn_project_qkv(lp["attn"], cfg, h, positions)
    return x + L.attn_output(lp["attn"], L.gqa_attention(q, k, v, mask))


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
    _check_ported(cfg)
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
                lambda q, k, v: L.gqa_attention(q, k, v, xmask))
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


def _attn_mesh(cfg, lp, sp, x, positions, mask, mesh, *, rope=True):
    """A layer's attention half with its heads sharded over 'model'
    (else the whole attention on every rank, no collective): the normed
    input enters through ``copy_to_model``, and so does every leaf the
    rank holds whole (``wk``/``wv`` and their biases where the KV heads
    do not divide 'model', the q/k norms), since each rank's gradient of
    it is a partial sum; the output leaves through
    ``reduce_from_model``. Replicated KV heads are cut to the ones of
    this rank's query heads (global head // G). mla shards ``w_uq``,
    ``w_uk``, ``w_uv`` and ``wo`` over heads: ``mla_forward(mesh=)``
    enters its latents. ``rope`` False: the encoder's layers."""
    a, s = lp["attn"], sp["attn"]
    h = L.rms_norm(x, lp["ln1"], cfg.rms_eps)
    if cfg.mla is not None:
        if not _sharded(s["w_uq"], 1):
            out, _ = mla_mod.mla_forward(a, cfg, h, positions,
                                         graph="train", mask=mask)
            return x + out
        out, _ = mla_mod.mla_forward(a, cfg, h, positions, graph="train",
                                     mask=mask, mesh=mesh)
        return x + C.reduce_from_model(out, mesh)
    if not _sharded(s["wq"], 1):
        q, k, v = L.attn_project_qkv(a, cfg, h, positions, rope=rope)
        return x + L.attn_output(a, L.gqa_attention(q, k, v, mask))
    a = _enter(a, s, mesh)
    q, k, v = L.attn_project_qkv(a, cfg, C.copy_to_model(h, mesh),
                                 positions, rope=rope)
    if not _sharded(s["wk"], 1):
        hl = q.shape[2]
        kv = (mesh.idx * hl + torch.arange(hl, device=q.device)) \
            // (cfg.num_heads // cfg.num_kv_heads)
        k, v = k[:, :, kv], v[:, :, kv]
    out = L.attn_output(a, L.gqa_attention(q, k, v, mask))
    return x + C.reduce_from_model(out, mesh)


def _xattn_mesh(cfg, lp, sp, x, enc_out, xmask, mesh):
    """A whisper decoder layer's cross-attention half, its heads (query
    and KV alike) sharded over 'model' (else whole on every rank):
    ``enc_out`` has entered through ``copy_to_model`` (the caller's,
    once for every layer), the normed queries enter here, and the
    output leaves through ``reduce_from_model``."""
    a = lp["xattn"]
    sharded = _sharded(sp["xattn"]["wq"], 1)
    g = L.rms_norm(x, lp["ln_x"], cfg.rms_eps)
    if sharded:
        g = C.copy_to_model(g, mesh)
    q = torch.einsum("bsd,dhe->bshe", g, a["wq"])
    k = torch.einsum("bsd,dhe->bshe", enc_out, a["wk"])
    v = torch.einsum("bsd,dhe->bshe", enc_out, a["wv"])
    out = L.attn_output(a, L.gqa_attention(q, k, v, xmask))
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


def _mlp_mesh(cfg, lp, sp, x, mesh, kind):
    """A layer's MLP half and its aux loss (None for a dense MLP): the
    moe layer's ``moe_ep``, or the MLP tensor-parallel over ``d_ff``
    where it divides 'model' (else whole on every rank)."""
    h = L.rms_norm(x, lp["ln2"], cfg.rms_eps)
    if "moe" in lp:
        y, aux = moe_mod.moe_apply(lp["moe"], h, cfg, mesh=mesh)
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


def _encode_mesh(cfg, params, specs, frames, mesh):
    """``encode``'s training graph over a mesh: the encoder's stacked
    layers through the meshed attention (no rope, no mask) and MLP."""
    enc, sp = params["encoder"], _unstack_specs(specs["encoder"]["layers"])
    B, nf, d = frames.shape
    dt = cfg.activation_dtype()
    x = frames.to(dt) + L.sinusoidal_positions(nf, d, frames.device).to(dt)
    positions = torch.arange(nf, dtype=torch.int32,
                             device=x.device).expand(B, nf)
    mask = torch.ones((B, nf, nf), dtype=torch.bool, device=x.device)
    for lp in _unstack(enc["layers"]):
        lp = _fsdp(lp, sp, mesh)
        x = _attn_mesh(cfg, lp, sp, x, positions, mask, mesh, rope=False)
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
            h = _xattn_mesh(cfg, lp, sp, h, enc_out, xmask, mesh)
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
            frontend_embeds=None, enc_frames=None, plain: bool = False):
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
    the ssm mixer take no prefix, as in the reference."""
    if (cfg.family == "encdec") != (enc_frames is not None):
        raise ValueError("enc_frames is required for the encdec family, "
                         "and only for it")
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
                    graph="serve" if pmask is None else "train", mask=pmask)
                x = x + a
                write(cache["ckv"][ai], ckv)
                write(cache["k_rope"][ai], kr)
                ai += 1
            else:
                q, k, v = L.attn_project_qkv(lp["attn"], cfg, h, positions)
                if pmask is None:
                    a = _flash(attend, q, k, v, causal=True, window=window)
                else:
                    a = L.gqa_attention(q, k, v, pmask)
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
                    lambda q, k, v: _flash(attend, q, k, v, causal=False))
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
def decode_step(cfg, params, tokens, cache, valid=None):
    """tokens [B] -> (logits [B, V], cache). One AR step per sequence;
    the cache is written in place. ``valid`` [B] bool marks the rows
    whose tokens the moe layers route (None: all); the others still
    step."""
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
