"""Rank bodies for ``tests/test_torch_mesh_families.py``: the vlm, ssm,
hybrid, encdec and mla families trained over a CPU mesh of gloo
processes that ``repro_torch.launch.mesh.spawn`` started, the ssm
norm's backward alone, ``compressed_psum`` and ``elastic_rescale``.
This module imports neither JAX nor the reference package.

``family_rank`` runs every part on one 2x2 mesh. Its inputs are numpy
trees the test made from a seed; each rank returns what it computed
and its own blocks.
"""
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from torch_train_ranks import _local, _np, case_config, train_case
from repro_torch.distributed import collectives as C
from repro_torch.distributed.compression import compressed_psum, wire_bytes
from repro_torch.distributed.fault_tolerance import elastic_rescale
from repro_torch.distributed.sharding import P, ShardingRules, local_block
from repro_torch.models import layers as L
from repro_torch.models import model as TM
from repro_torch.training import optimizer as O
from repro_torch.training.checkpoint import restore_checkpoint


def view_1xN(mesh):
    """The mesh's ranks as a 1 x world mesh (its 'model' group the
    world)."""
    return dataclasses.replace(mesh, data=1, model=mesh.world,
                               model_group=dist.group.WORLD, data_group=None)


def norm_case(mesh, case: dict) -> dict:
    """The gated norm of the mamba2 mixer alone, over this rank's part
    of a dim sharded over 'model': its output and the gradients of
    sum(y * r) by its parts of x and the weight, with the mean of
    squares summed by ``sum_over_model`` (``rms_norm(mesh=)``) and, to
    show what the test tells apart, by Megatron's
    ``reduce_from_model`` (identity backward)."""
    spec = P(None, None, "model")
    out = {}
    sum_over_model = C.sum_over_model
    for name, fn in (("sum", sum_over_model),
                     ("reduce", C.reduce_from_model)):
        x, w, r = (local_block(torch.from_numpy(case[k]), spec[-t.ndim:],
                               mesh).clone()
                   for k, t in (("x", case["x"]), ("w", case["w"]),
                                ("r", case["r"])))
        x.requires_grad_()
        w.requires_grad_()
        C.sum_over_model = fn
        try:
            y = L.rms_norm(x, w, 1e-6, mesh=mesh)
        finally:
            C.sum_over_model = sum_over_model
        gx, gw = torch.autograd.grad((y * r).sum(), (x, w))
        out[name] = {"y": y.detach().numpy(), "gx": gx.numpy(),
                     "gw": gw.numpy()}
    return out


def compress_case(mesh, case: dict) -> dict:
    """Two rounds of ``compressed_psum`` over 'data': this rank's row of
    each stacked gradient leaf, the errors of the first round fed to
    the second."""
    row = mesh.coord("data")
    errors, out = None, {}
    for i, grads in enumerate(case["rounds"]):
        mine = O.tree_map(lambda a: torch.from_numpy(a[row].copy()), grads)
        mean, errors = compressed_psum(mine, mesh, "data", errors)
        out[i] = {"mean": _np(mean), "err": _np(errors)}
    out["wire_bytes"] = wire_bytes(mine)
    return out


def rescale_case(mesh, case: dict) -> dict:
    """``elastic_rescale`` of a checkpoint the 2x2 mesh saved onto a 1x4
    view of the same ranks: every leaf bit-equal to this rank's
    ``local_block`` of the saved one."""
    cfg = case_config(case["arch"], **case.get("reduced", {}))
    tree, step, view = elastic_rescale(
        case["dir"], lambda: view_1xN(mesh),
        lambda m: ShardingRules(cfg, m))
    full, _ = restore_checkpoint(case["dir"])
    rules = ShardingRules(cfg, view)
    want = {"params": _local(full["params"],
                             rules.params(TM.param_shapes(cfg)), view),
            "opt_state": _local(full["opt_state"], rules.opt_state(
                O.state_shapes(full["opt_state"], TM.param_shapes(cfg))),
                view)}
    got, want = O.tree_leaves(tree), O.tree_leaves(want)
    return {"step": step, "model": view.model, "leaves": len(got),
            "sharded": sum(a.shape != b.shape for a, b in zip(
                got, O.tree_leaves(full))),
            "same": len(got) == len(want) and all(
                a.dtype == b.dtype and torch.equal(a, b)
                for a, b in zip(got, want))}


def family_rank(mesh, plan: dict) -> dict:
    torch.set_num_threads(1)
    out = {"coord": {"data": mesh.coord("data"),
                     "model": mesh.coord("model")}}
    out["train"] = {k: train_case(mesh, c) for k, c in plan["train"].items()}
    out["norm"] = norm_case(mesh, plan["norm"])
    out["compress"] = compress_case(mesh, plan["compress"])
    out["rescale"] = rescale_case(mesh, plan["rescale"])
    return out
