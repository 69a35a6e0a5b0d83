"""Rank bodies for ``tests/test_torch_mesh_train.py``: training over a
CPU mesh of gloo processes that ``repro_torch.launch.mesh.spawn``
started, so this module imports neither JAX nor the reference package.

``mesh_rank`` runs every part of the test on one 2x2 mesh: the train
step cases, the expert-parallel ``moe_ep`` cases, a 1x4 view of the
same four ranks (its 'model' group the world) and the checkpoints. Its
inputs are numpy trees the test made from a seed; each rank returns
its local blocks (so the test can check what every rank holds) and the
whole leaves it gathered with ``full_leaf``.
"""
import dataclasses

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, reduced
from repro_torch.distributed.sharding import ShardingRules, local_block, \
    spec_axes, tree_full
from repro_torch.models import model as TM
from repro_torch.models import moe as tmoe
from repro_torch.training import optimizer as O
from repro_torch.training import checkpoint as tck
from repro_torch.training.checkpoint import restore_checkpoint, \
    save_checkpoint
from repro_torch.training.train_loop import TrainConfig, batch_to, \
    build_train_step, mesh_step_grads


def case_config(arch: str, moe=None, **kw):
    """The reduced config of ``arch`` (``kw``: ``reduced``'s sizes), its
    moe fields replaced by ``moe`` (a dict) where given."""
    cfg = reduced(get_config(arch), **kw)
    if moe:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe))
    return cfg


def _np(tree):
    return O.tree_map(lambda t: t.detach().float().numpy()
                      if t.dtype == torch.bfloat16
                      else t.detach().numpy().copy(), tree)


def _local(full, specs, mesh):
    return O.tree_map(lambda t, s: local_block(t, s, mesh).clone(), full,
                      specs)


def train_case(mesh, case: dict) -> dict:
    """One train step of ``case`` from its full weights: the whole step's
    loss, the gradients and new parameters made whole, and this rank's
    blocks of the new parameters and state."""
    cfg = case_config(case["arch"], case.get("moe"),
                      **case.get("reduced", {}))
    rules = ShardingRules(cfg, mesh, fsdp=case["fsdp"])
    specs = rules.params(TM.param_shapes(cfg))
    params = _local(TM.params_from_numpy(case["params"], "cpu"), specs, mesh)
    opt = O.OptConfig(**case["opt"])
    state = O.opt_init(opt, params, mesh, specs)
    tc = TrainConfig(**case["tc"])
    batch = batch_to(case["batch"], "cpu")
    loss, grads = mesh_step_grads(cfg, params, batch, tc, mesh, rules)
    grads = tree_full(grads, specs, mesh)
    step = build_train_step(cfg, opt, tc, mesh=mesh, rules=rules)
    params, state, m = step(params, state, case["batch"])
    out = {"loss": float(loss), "step_loss": float(m["loss"]),
           "grad_norm": float(m["grad_norm"]),
           "local_params": _np(params), "local_state": _np(state),
           "grads": _np(grads), "params": _np(tree_full(params, specs,
                                                         mesh))}
    if case.get("ckpt"):
        # saved on the mesh, restored on it: this rank's blocks again
        # every rank joins each leaf's gather; only rank 0 makes a full
        # leaf on the host (counted through the module's _host_array)
        d = case["ckpt"]
        made, host_array = [], tck._host_array
        tck._host_array = lambda t: made.append(t.shape) or host_array(t)
        try:
            save_checkpoint(d, 1, params, state, shardings=(rules, mesh))
        finally:
            tck._host_array = host_array
        out["host_full"] = len(made)
        out["ckpt_leaves"] = len(O.tree_leaves({"params": params,
                                                "opt_state": state}))
        tree, _ = restore_checkpoint(d, shardings=(rules, mesh))
        out["ckpt_same"] = all(
            torch.equal(a, b) and a.dtype == b.dtype for a, b in zip(
                O.tree_leaves({"params": params, "opt_state": state}),
                O.tree_leaves(tree)))
        state_specs = rules.opt_state(O.state_shapes(
            state, TM.param_shapes(cfg)))
        out["state"] = _np(tree_full(state, state_specs, mesh))
    return out


def restore_case(mesh, case: dict) -> bool:
    """A checkpoint written on one device restored onto the mesh: each
    leaf bit-equal to this rank's ``local_block`` of the full one."""
    cfg = case_config(case["arch"])
    rules = ShardingRules(cfg, mesh, fsdp=case["fsdp"])
    tree, _ = restore_checkpoint(case["dir"], shardings=(rules, mesh))
    full, _ = restore_checkpoint(case["dir"])
    specs = rules.params(TM.param_shapes(cfg))
    want = {"params": _local(full["params"], specs, mesh)}
    state_specs = rules.opt_state(O.state_shapes(full["opt_state"],
                                                 TM.param_shapes(cfg)))
    want["opt_state"] = _local(full["opt_state"], state_specs, mesh)
    return all(torch.equal(a, b) and a.dtype == b.dtype
               for a, b in zip(O.tree_leaves(want), O.tree_leaves(tree)))


def moe_case(mesh, case: dict) -> dict:
    """``moe_ep`` on this data rank's rows of ``x`` and this rank's
    experts: its rows of y and the aux loss."""
    cfg = case_config("phi3.5-moe-42b-a6.6b", case["moe"])
    rules = ShardingRules(cfg, mesh, fsdp=False)
    full = O.tree_map(torch.from_numpy, case["params"])
    # one layer's leaves: a path outside "layers/" has no stacked dim
    p = _local(full, rules.params({"moe": full})["moe"], mesh)
    x = torch.from_numpy(case["x"])
    x = local_block(x, rules.batch({"x": x})["x"], mesh)
    y, aux = tmoe.moe_ep(p, x, cfg, mesh)
    return {"y": y.numpy(), "aux": float(aux)}


def view_case(mesh, case: dict) -> dict:
    """The four ranks as a 1x4 mesh (the 'model' group the world): the
    forward's logits, the loss and the gradients made whole."""
    view = dataclasses.replace(mesh, data=1, model=mesh.world,
                               model_group=dist.group.WORLD,
                               data_group=None)
    cfg = case_config(case["arch"])
    rules = ShardingRules(cfg, view)
    specs = rules.params(TM.param_shapes(cfg))
    params = _local(TM.params_from_numpy(case["params"], "cpu"), specs,
                    view)
    batch = batch_to(case["batch"], "cpu")
    live = O.tree_map(lambda t: t.requires_grad_(), params)
    logits, _ = TM.forward(cfg, live, batch["tokens"], mesh=view,
                           rules=rules)
    loss, _ = TM.loss_fn(cfg, live, batch, mesh=view, rules=rules)
    grads = torch.autograd.grad(loss, O.tree_leaves(live))
    loss = loss.detach()
    it = iter(grads)
    grads = O.tree_map(lambda _: next(it), params)
    return {"logits": logits.detach().numpy(), "loss": loss.item(),
            "grads": _np(tree_full(grads, specs, view)),
            "replicated_kv": "model" not in spec_axes(
                specs["layers"]["attn"]["wk"]),
            "sharded_q": "model" in spec_axes(
                specs["layers"]["attn"]["wq"])}


def mesh_rank(mesh, plan: dict) -> dict:
    torch.set_num_threads(1)
    out = {"coord": {"data": mesh.coord("data"),
                     "model": mesh.coord("model")}}
    out["train"] = {k: train_case(mesh, c) for k, c in plan["train"].items()}
    out["restore"] = restore_case(mesh, plan["restore"])
    out["moe"] = {k: moe_case(mesh, c) for k, c in plan["moe"].items()}
    out["view"] = view_case(mesh, plan["view"])
    return out
