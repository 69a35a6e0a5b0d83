"""Rank bodies for ``tests/test_torch_mesh_serve.py`` and
``tests/test_torch_dryrun.py``: serving over a CPU mesh of gloo
processes that ``repro_torch.launch.mesh.spawn`` started (``prefill``
and ``decode_step`` with ``mesh=``, ``moe_apply(expert_tp=True)``),
and a dry-run cell's program run for real under the dry run's
counters. This module imports neither JAX nor the reference package.

Each rank body takes numpy inputs the test made from a seed and
returns what its rank computed and its own blocks.
"""
import dataclasses

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from torch_train_ranks import _local, _np, case_config
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch import dryrun as DR
from repro_torch.launch.specs import ShapeCell
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE
from repro_torch.training import optimizer as O


def view_1x(mesh):
    """This rank's 'model' group as a 1 x M mesh of its own."""
    return dataclasses.replace(mesh, data=1, rank=mesh.idx, data_group=None)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def serve_case(mesh, case: dict) -> dict:
    """``prefill`` then ``decode_step`` over the mesh from the case's full
    weights and an empty cache of the case's capacity: this rank's
    logits of each step and its block of the cache after the last."""
    cfg = case_config(case["arch"], **case.get("reduced", {}))
    rules = ShardingRules(cfg, mesh, mode=case["mode"], fsdp=case["fsdp"])
    specs = rules.params(TM.param_shapes(cfg))
    params = _local(TM.params_from_numpy(case["params"], "cpu"), specs, mesh)
    B = case["tokens"].shape[0]
    enc = 0 if case.get("enc_frames") is None \
        else case["enc_frames"].shape[1]
    full = TM.init_cache(cfg, B, case["capacity"], "cpu", enc_frames=enc)
    cache = _local(full, rules.cache(full), mesh)
    kw = dict(mesh=mesh, rules=rules, capacity=case["capacity"])
    logits = []
    with torch.no_grad():
        out, cache = TM.prefill(
            cfg, params, _t(case["tokens"]), cache,
            seq_lens=_t(case.get("seq_lens")),
            prefix_len=_t(case.get("prefix_len")),
            frontend_embeds=_t(case.get("frontend_embeds")),
            enc_frames=_t(case.get("enc_frames")), **kw)
        logits.append(out.numpy())
        for tok in case["steps"]:
            out, cache = TM.decode_step(cfg, params, _t(tok), cache, **kw)
            logits.append(out.numpy())
    return {"logits": logits, "cache": _np(cache),
            "coord": {"data": mesh.coord("data"),
                      "model": mesh.coord("model")}}


def expert_tp_case(mesh, case: dict) -> dict:
    """``moe_apply(expert_tp=True)`` on the whole batch: this rank's
    output and aux loss, and its expert leaves' shapes."""
    cfg = case_config(case["arch"], case.get("moe"),
                      **case.get("reduced", {}))
    rules = ShardingRules(cfg, mesh, mode="decode", expert_tp=True)
    specs = rules.params(TM.param_shapes(cfg))
    params = _local(TM.params_from_numpy(case["params"], "cpu"), specs, mesh)
    lp = TM.layer_params(params)[-1]["moe"]
    with torch.no_grad():
        y, aux = TMoE.moe_apply(lp, _t(case["x"]), cfg, mesh=mesh,
                                expert_tp=True)
    return {"y": y.numpy(), "aux": float(aux),
            "shapes": {k: tuple(v.shape) for k, v in lp.items()
                       if k != "shared"}}


def _fill(tree, rng, vocab: int):
    """Values for a cell's meta arguments on the CPU: small normals for
    the floating leaves, tokens and labels in the vocabulary, zeros for
    the other integers (an empty cache, no prefix)."""
    def leaf(path, t):
        if t.dtype.is_floating_point:
            v = rng.standard_normal(tuple(t.shape)) * 0.02
            return torch.from_numpy(v.astype(np.float32)).to(t.dtype)
        if path and path[-1] in ("tokens", "labels"):
            return torch.from_numpy(rng.integers(
                0, vocab, tuple(t.shape))).to(t.dtype)
        return torch.zeros(tuple(t.shape), dtype=t.dtype)

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, path) for v in t)
        return leaf(path, t)
    return walk(tree, ())


def cell_counts(mesh, case: dict) -> dict:
    """A dry-run cell's program (``dryrun.build_step``) of the reduced
    config run for real on this rank, on values made from a seed, under
    the dry run's counters: its flops and collective bytes by kind."""
    cfg = case_config(case["arch"], **case.get("reduced", {}))
    cell = ShapeCell(*case["cell"])
    rules = ShardingRules(cfg, mesh, mode=cell.kind, fsdp=case["fsdp"])
    step, args, _, _ = DR.build_step(cfg, cell, mesh, rules)
    args = _fill(args, np.random.default_rng(case["seed"]), cfg.vocab_size)
    if cell.kind == "train":
        # the optimizer state as opt_init makes it from the parameters
        args = (args[0], O.opt_init(O.select_optimizer(cfg), args[0], mesh,
                                    rules.params(TM.param_shapes(cfg))),
                args[2])
    with FlopCounterMode(display=False) as fc, C.recording() as coll, \
            torch.no_grad():
        step(*args)
    return {"flops": float(fc.get_total_flops()),
            "collective": {k: float(v) for k, v in coll.items()}}


def serve_rank(mesh, plan: dict) -> dict:
    """Every part of ``tests/test_torch_mesh_serve.py`` on one rank of a
    2x2 mesh: the 2x2 cases on the whole mesh first, then the 1x2 cases
    on data rank 0's 'model' group (the other ranks are done)."""
    out = {"rank": mesh.rank, "serve": {}}
    out["expert_tp"] = expert_tp_case(mesh, plan["expert_tp"])
    cases = plan["serve"].items()
    for name, case in cases:
        if case["mesh"] == "2x2":
            out["serve"][name] = serve_case(mesh, case)
    if mesh.coord("data") == 0:
        for name, case in cases:
            if case["mesh"] == "1x2":
                out["serve"][name] = serve_case(view_1x(mesh), case)
    return out


def dryrun_rank(mesh, plan: dict) -> dict:
    """``tests/test_torch_dryrun.py``'s cells, each run for real."""
    return {"rank": mesh.rank,
            "cells": {name: cell_counts(mesh, case)
                      for name, case in plan.items()}}

