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
3). Placing the leaves on a mesh (``shardings=``) waits for the mesh
half of training.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch


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
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _save_leaf(path: str, a: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, a)
        return
    a = np.ascontiguousarray(a)
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": a.shape})
        f.write(a.tobytes())


def _load_leaf(path: str, dtype: str) -> torch.Tensor:
    a = np.load(path)
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def save_checkpoint(ckpt_dir: str, step: int, params, opt_state=None, *,
                    async_save: bool = False,
                    keep_last: int = 3) -> Optional[threading.Thread]:
    """Write a step's checkpoint, the manifest last (atomic). With
    ``async_save`` the leaves are on the host when this returns and the
    returned thread writes them."""
    tree = {"params": params}
    if opt_state is not None:
        tree["opt_state"] = opt_state
    host = {k: _to_host(v) for k, v in _flatten(tree).items()}

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

    if async_save:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
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
    bf16 leaves by the manifest's dtype."""
    if shardings is not None:
        raise NotImplementedError(
            "restoring onto a mesh (shardings=) is not ported yet "
            "(ROADMAP.md queue 1 item 7)")
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    flat = {}
    for k, info in manifest["leaves"].items():
        t = _load_leaf(os.path.join(step_dir, info["file"]), info["dtype"])
        flat[k] = t if device is None else t.to(device)
    return _unflatten(flat), step
