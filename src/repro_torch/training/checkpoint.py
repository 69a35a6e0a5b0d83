"""Checkpoint / restart: the JAX package's ``training/checkpoint.py``
on tensors, in the same files.

Atomic-manifest checkpoints: every leaf saved as its own ``.npy`` under
a ``step_XXXXXXXX.tmp`` directory, the manifest (each leaf's file,
dtype and shape by its path in the tree) written last and the
directory then renamed, so a crash mid-save never leaves a
readable-but-corrupt checkpoint. The async mode copies the leaves to the
host before it returns and writes them from a thread; ``keep_last``
keeps the newest checkpoints and removes the rest.

The files are the reference's: a checkpoint the JAX package wrote
restores here, and an f32 one written here restores there. numpy has no
bfloat16, so a bf16 leaf is written as its 16-bit patterns under the
header ``np.save`` gives an ``ml_dtypes`` bfloat16 array (descr
``<V2``) and restored by the manifest's ``"bfloat16"``; the reference's
own restore reads such a leaf back as 2-byte voids (ROADMAP.md queue
3).

On a mesh (``shardings=(rules, mesh)``) the files are the same: a save
copies each rank's block of a leaf to its host and gathers the blocks
to rank 0 over the mesh's gloo command group (a collective every rank
joins), where they are laid into the full leaf that rank 0 alone holds
and writes; a restore maps the full leaves' files and copies this
rank's ``local_block`` of each. So a checkpoint saved on a mesh
restores on one device, and one saved on one device restores on a
mesh, or on a mesh of another shape (``distributed/fault_tolerance.py::
elastic_rescale``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import (full_shape, local_block,
                                              spec_axes)


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat):
    root: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return _fix_lists(root)


def _fix_lists(node):
    if not isinstance(node, dict):
        return node
    keys = list(node.keys())
    if keys and all(k.isdigit() for k in keys):
        return [_fix_lists(node[str(i)]) for i in range(len(keys))]
    return {k: _fix_lists(v) for k, v in node.items()}


def _to_host(t: torch.Tensor):
    """(numpy array, manifest dtype): a bf16 tensor as its bit patterns.
    Always a copy, a CPU tensor's too: the optimizer updates the live
    leaves in place while an async save is still writing."""
    return _host_array(t.detach().to("cpu", copy=True))


def _host_array(t: torch.Tensor):
    """``_to_host`` of a host tensor that is already a copy."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _gather_to_rank0(t: torch.Tensor, spec, mesh):
    """``_to_host`` of the full leaf whose block ``t`` is under
    ``spec``, on rank 0; None on the other ranks. Every rank copies its
    block to its host and the blocks are gathered to rank 0 over the
    command group (gloo, also where the axes talk NCCL), which lays
    rank ``r``'s where ``local_block`` takes it for rank ``r``. No card
    holds a full-size buffer, and only rank 0 a full leaf."""
    block = t.detach().to("cpu", copy=True).contiguous()
    if not spec_axes(spec):                    # every rank holds it whole
        return _host_array(block) if mesh.rank == 0 else None
    parts = [torch.empty_like(block) for _ in range(mesh.world)] \
        if mesh.rank == 0 else None
    dist.gather(block, parts, dst=0, group=mesh.cmd_group)
    if mesh.rank != 0:
        return None
    full = block.new_empty(full_shape(block.shape, spec, mesh))
    for r, part in enumerate(parts):
        local_block(full, spec, dataclasses.replace(mesh, rank=r)).copy_(
            part)
    return _host_array(full)


def _save_leaf(path: str, a: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, a)
        return
    a = np.ascontiguousarray(a)
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": a.shape})
        f.write(a.tobytes())


def _load_leaf(path: str, dtype: str, mmap: bool = False) -> torch.Tensor:
    """A leaf's file as a tensor; with ``mmap`` the file mapped (copy on
    write), so that a block taken from it reads only its own pages."""
    a = np.load(path, mmap_mode="c" if mmap else None)
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _specs(rules, tree) -> dict:
    """Each leaf's spec by its flat key: its rules' (``params`` by
    ``rules.params``, ``opt_state`` by ``rules.opt_state``, the same
    table) on its full shape; the root key is no part of a rule path."""
    from repro_torch.models.model import param_shapes
    from repro_torch.training.optimizer import state_shapes
    shapes = {"params": param_shapes(rules.cfg)}
    if "opt_state" in tree:
        shapes["opt_state"] = state_shapes(tree["opt_state"],
                                           shapes["params"])
    return {k: rules._stacked_fix(k.split("/")[1:], v)
            for k, v in _flatten(shapes).items()}


def save_checkpoint(ckpt_dir: str, step: int, params, opt_state=None, *,
                    async_save: bool = False, keep_last: int = 3,
                    shardings=None) -> Optional[threading.Thread]:
    """Write a step's checkpoint, the manifest last (atomic). With
    ``async_save`` the leaves are on the host when this returns and the
    returned thread writes them. With ``shardings=(rules, mesh)`` every
    rank calls this with its blocks; rank 0 writes the full leaves, and
    a synchronous save returns on every rank once they are written."""
    tree = {"params": params}
    if opt_state is not None:
        tree["opt_state"] = opt_state
    flat = _flatten(tree)
    if shardings is not None:
        rules, mesh = shardings
        specs = _specs(rules, tree)
        host = {k: _gather_to_rank0(v, specs[k], mesh)
                for k, v in flat.items()}
        if mesh.rank != 0:
            host = None
    else:
        host = {k: _to_host(v) for k, v in flat.items()}

    def _write():
        step_dir = os.path.join(ckpt_dir, f"step_{step:08d}.tmp")
        os.makedirs(step_dir, exist_ok=True)
        names = {}
        for i, (k, (a, dtype)) in enumerate(host.items()):
            fn = f"leaf_{i:05d}.npy"
            _save_leaf(os.path.join(step_dir, fn), a, dtype)
            names[k] = {"file": fn, "dtype": dtype, "shape": list(a.shape)}
        with open(os.path.join(step_dir, "manifest.json"), "w") as f:
            json.dump({"step": step, "leaves": names}, f)
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(step_dir, final)
        _gc(ckpt_dir, keep_last)

    if host is None:                   # a mesh rank other than 0
        if not async_save:
            dist.barrier(group=shardings[1].cmd_group)
        return None
    if async_save:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    if shardings is not None:
        dist.barrier(group=shardings[1].cmd_group)
    return None


def _gc(ckpt_dir: str, keep_last: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, d))


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json"))]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: Optional[int] = None, *,
                       device=None, shardings=None):
    """Load (tree, step): the leaves as host tensors, or on ``device``;
    bf16 leaves by the manifest's dtype. With ``shardings=(rules,
    mesh)`` each leaf is this rank's block of it (a copy), by its
    rules' spec on its full shape (``params`` by ``rules.params``,
    ``opt_state`` by ``rules.opt_state``), read from the mapped file."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    flat = {}
    for k, info in manifest["leaves"].items():
        t = _load_leaf(os.path.join(step_dir, info["file"]), info["dtype"],
                       mmap=shardings is not None)
        if shardings is not None:
            rules, mesh = shardings
            t = local_block(t, rules._stacked_fix(k.split("/")[1:], t),
                            mesh).clone()
        flat[k] = t if device is None else t.to(device)
    return _unflatten(flat), step
