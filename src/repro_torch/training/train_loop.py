"""The train step and loop (the JAX package's
``training/train_loop.py``): loss -> gradients (microbatched gradient
accumulation, remat) -> optimizer update, on one device or over a
('data', 'model') mesh of ranks.

Gradients come from ``torch.autograd.grad`` over the parameter leaves,
in their own types (bf16 parameters give bf16 gradients, as
``jax.grad`` does). Microbatches sum their gradients into f32 zeros and
their losses into an f32 scalar, then divide both by their count.

Over a mesh (every family) each rank holds its blocks of
the parameters and the optimizer state (``ShardingRules``), and every
rank draws the same global batch. The step splits it into microbatches
first and each microbatch over 'data' second, the reference's order
(``_microbatch_stack``); ``loss_fn`` takes this rank's rows and gives
its data rank's share of the loss (the whole batch's denominators).
The gradients of the leaves not sharded over 'data' are then summed
over 'data'; an FSDP leaf's gradient was summed by its gather's
backward (a reduce-scatter). The losses' shares sum over 'data' too.
``bf16_grad_reduce`` casts the gradients to bf16 before that sum (the
FSDP leaves' after theirs), halving its bytes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import ShardingRules, spec_axes
from repro_torch.models import model as M
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.optimizer import tree_leaves, tree_map


@dataclass(frozen=True)
class TrainConfig:
    """The reference's fields. ``seq_shard_activations`` (the
    reference's Megatron-SP sharding constraint on the residual stream)
    changes no value: the port's ranks hold the residual stream whole."""
    microbatches: int = 1            # gradient accumulation steps
    remat: bool = True
    seq_shard_activations: bool = False
    bf16_grad_reduce: bool = False   # the gradients cast to bf16 before
    # the update (on a mesh, before their sum over 'data': half the bytes)


def batch_to(batch, device):
    """A batch of numpy arrays or tensors as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def loss_and_grads(cfg, params, batch, *, remat: bool = False, mesh=None,
                   rules=None):
    """(loss, metrics, grads): ``loss_fn`` on ``batch`` and its gradient
    for every parameter leaf, in the tree's layout and the leaves'
    types, all detached. The parameters are not touched: the graph is
    built on detached aliases of them. Over a ``mesh``: this rank's
    blocks, and its data rank's share of the loss."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    leaves = tree_leaves(live)
    with torch.enable_grad():
        loss, metrics = M.loss_fn(cfg, live, batch, remat=remat, mesh=mesh,
                                  rules=rules)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = iter([torch.zeros_like(p) if g is None else g
                  for p, g in zip(leaves, grads)])
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(grads), params))


def step_grads(cfg, params, batch, tc: TrainConfig, mesh=None, rules=None):
    """(loss, grads) of one step on ``batch`` (tensors): ``loss_and_grads``
    on the whole batch, or, with ``tc.microbatches`` n > 1, on n equal
    slices of it, the gradients summed into f32 zeros and the losses
    into an f32 scalar, both divided by n. Over a ``mesh``: this rank's
    blocks' gradients before any sum over 'data' (but an FSDP leaf's),
    and its data rank's share of the loss."""
    n = tc.microbatches
    kw = dict(remat=tc.remat, mesh=mesh, rules=rules)
    if n <= 1:
        loss, _, grads = loss_and_grads(cfg, params, batch, **kw)
        return loss, grads
    B = batch["tokens"].shape[0]
    if B % n:
        raise ValueError(f"batch {B} does not split into {n} equal "
                         "microbatches")
    gsum = tree_map(opt_mod.zeros_f32, params)
    loss = torch.zeros((), dtype=torch.float32, device=gsum["embed"].device)
    parts = {k: v.chunk(n) for k, v in batch.items()}
    for i in range(n):
        lm, _, g = loss_and_grads(cfg, params,
                                  {k: v[i] for k, v in parts.items()}, **kw)
        tree_map(lambda s, x: s.add_(x), gsum, g)
        loss = loss + lm
        del g
    return loss / n, tree_map(lambda g: g / n, gsum)


def build_train_step(cfg, opt: opt_mod.OptConfig, tc: TrainConfig,
                     mesh=None, rules=None):
    """Returns train_step(params, opt_state, batch) -> (params,
    opt_state, metrics); the update is made in place (``opt_update``).
    Over a ``mesh`` (``rules``: default ``ShardingRules(cfg, mesh)``)
    the parameters and state are this rank's blocks and ``batch`` the
    global batch; the metrics are the whole step's."""
    if mesh is not None:
        return _mesh_train_step(cfg, opt, tc, mesh,
                                rules or ShardingRules(cfg, mesh))

    def train_step(params, opt_state, batch):
        batch = batch_to(batch, tree_leaves(params)[0].device)
        loss, grads = step_grads(cfg, params, batch, tc)
        if tc.bf16_grad_reduce:
            grads = tree_map(lambda g: g.to(torch.bfloat16), grads)
        params, opt_state, om = opt_mod.opt_update(opt, grads, opt_state,
                                                   params)
        return params, opt_state, {"loss": loss, **om}

    return train_step


def mesh_step_grads(cfg, params, batch, tc: TrainConfig, mesh, rules,
                    specs=None):
    """(loss, grads) of one step over a mesh: ``step_grads`` on this
    rank's blocks, the gradients (cast to bf16 first under
    ``bf16_grad_reduce``) of the leaves not sharded over 'data' summed
    over it, and the loss's shares too: the whole step's loss, and this
    rank's blocks of the whole step's gradients."""
    specs = specs or rules.params(M.param_shapes(cfg))
    loss, grads = step_grads(cfg, params, batch, tc, mesh, rules)

    def reduce(g, spec):
        if tc.bf16_grad_reduce:
            g = g.to(torch.bfloat16)
        return g if "data" in spec_axes(spec) else \
            C.all_reduce(g, mesh, "data")

    return (C.all_reduce(loss.clone(), mesh, "data"),
            tree_map(reduce, grads, specs))


def _mesh_train_step(cfg, opt, tc, mesh, rules):
    specs = rules.params(M.param_shapes(cfg))

    def train_step(params, opt_state, batch):
        batch = batch_to(batch, tree_leaves(params)[0].device)
        loss, grads = mesh_step_grads(cfg, params, batch, tc, mesh, rules,
                                      specs)
        params, opt_state, om = opt_mod.opt_update(
            opt, grads, opt_state, params, mesh, specs)
        return params, opt_state, {"loss": loss, **om}

    return train_step


def train_loop(cfg, params, opt_state, data_iter, *, steps: int,
               opt: opt_mod.OptConfig, tc: Optional[TrainConfig] = None,
               mesh=None, checkpoint_every: int = 0, ckpt_dir=None,
               log_every: int = 10, rules=None):
    """The simple loop of the examples and the launcher: ``steps``
    steps over ``data_iter``; (step, loss) every ``log_every`` steps and
    at the last; a checkpoint every ``checkpoint_every`` steps. Over a
    ``mesh`` every rank runs it on its blocks and the same batches; the
    checkpoint holds the full leaves (``save_checkpoint(shardings=)``)."""
    from repro_torch.training.checkpoint import save_checkpoint
    tc = tc or TrainConfig(remat=False)
    if mesh is not None:
        rules = rules or ShardingRules(cfg, mesh)
    step_fn = build_train_step(cfg, opt, tc, mesh=mesh, rules=rules)
    history = []
    for step in range(steps):
        batch = next(data_iter)
        params, opt_state, m = step_fn(params, opt_state, batch)
        if step % log_every == 0 or step == steps - 1:
            history.append((step, float(m["loss"])))
        if checkpoint_every and ckpt_dir and \
                (step + 1) % checkpoint_every == 0:
            save_checkpoint(ckpt_dir, step + 1, params, opt_state,
                            shardings=None if mesh is None
                            else (rules, mesh))
    return params, opt_state, history
