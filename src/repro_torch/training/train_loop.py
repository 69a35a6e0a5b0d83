"""The train step and loop on one device (the JAX package's
``training/train_loop.py``): loss -> gradients (microbatched gradient
accumulation, remat) -> optimizer update.

Gradients come from ``torch.autograd.grad`` over the parameter leaves,
in their own types (bf16 parameters give bf16 gradients, as
``jax.grad`` does). Microbatches sum their gradients into f32 zeros and
their losses into an f32 scalar, then divide both by their count. A
mesh (the reference's data/model sharding) waits for the mesh half of
training.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.models import model as M
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.optimizer import tree_leaves, tree_map


@dataclass(frozen=True)
class TrainConfig:
    """The reference's, less ``seq_shard_activations`` (a mesh's residual
    sharding, with the mesh half of training)."""
    microbatches: int = 1            # gradient accumulation steps
    remat: bool = True
    bf16_grad_reduce: bool = False   # the gradients cast to bf16 before
    # the update (on a mesh, the reduction's wire bytes halve)


def batch_to(batch, device):
    """A batch of numpy arrays or tensors as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def loss_and_grads(cfg, params, batch, *, remat: bool = False):
    """(loss, metrics, grads): ``loss_fn`` on ``batch`` and its gradient
    for every parameter leaf, in the tree's layout and the leaves'
    types, all detached. The parameters are not touched: the graph is
    built on detached aliases of them."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    leaves = tree_leaves(live)
    with torch.enable_grad():
        loss, metrics = M.loss_fn(cfg, live, batch, remat=remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = iter([torch.zeros_like(p) if g is None else g
                  for p, g in zip(leaves, grads)])
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(grads), params))


def step_grads(cfg, params, batch, tc: TrainConfig):
    """(loss, grads) of one step on ``batch`` (tensors): ``loss_and_grads``
    on the whole batch, or, with ``tc.microbatches`` n > 1, on n equal
    slices of it, the gradients summed into f32 zeros and the losses
    into an f32 scalar, both divided by n."""
    n = tc.microbatches
    if n <= 1:
        loss, _, grads = loss_and_grads(cfg, params, batch, remat=tc.remat)
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
                                  {k: v[i] for k, v in parts.items()},
                                  remat=tc.remat)
        tree_map(lambda s, x: s.add_(x), gsum, g)
        loss = loss + lm
        del g
    return loss / n, tree_map(lambda g: g / n, gsum)


def build_train_step(cfg, opt: opt_mod.OptConfig, tc: TrainConfig,
                     mesh=None):
    """Returns train_step(params, opt_state, batch) -> (params,
    opt_state, metrics); the update is made in place (``opt_update``)."""
    if mesh is not None:
        raise NotImplementedError("a train step over a mesh is not "
                                  "ported yet (ROADMAP.md queue 1 item 7)")

    def train_step(params, opt_state, batch):
        batch = batch_to(batch, tree_leaves(params)[0].device)
        loss, grads = step_grads(cfg, params, batch, tc)
        if tc.bf16_grad_reduce:
            grads = tree_map(lambda g: g.to(torch.bfloat16), grads)
        params, opt_state, om = opt_mod.opt_update(opt, grads, opt_state,
                                                   params)
        return params, opt_state, {"loss": loss, **om}

    return train_step


def train_loop(cfg, params, opt_state, data_iter, *, steps: int,
               opt: opt_mod.OptConfig, tc: Optional[TrainConfig] = None,
               mesh=None, checkpoint_every: int = 0, ckpt_dir=None,
               log_every: int = 10):
    """The simple loop of the examples and the launcher: ``steps``
    steps over ``data_iter``; (step, loss) every ``log_every`` steps and
    at the last; a checkpoint every ``checkpoint_every`` steps."""
    from repro_torch.training.checkpoint import save_checkpoint
    tc = tc or TrainConfig(remat=False)
    step_fn = build_train_step(cfg, opt, tc, mesh=mesh)
    history = []
    for step in range(steps):
        batch = next(data_iter)
        params, opt_state, m = step_fn(params, opt_state, batch)
        if step % log_every == 0 or step == steps - 1:
            history.append((step, float(m["loss"])))
        if checkpoint_every and ckpt_dir and \
                (step + 1) % checkpoint_every == 0:
            save_checkpoint(ckpt_dir, step + 1, params, opt_state)
    return params, opt_state, history
