"""Gradient compression for the data-parallel reduction (the JAX
package's ``distributed/compression.py``).

int8 block-quantized all-reduce with error feedback. Per leaf, on each
rank of the axis, in f32:

  1. shared block scale   s = max(pmax(max|g + e|), eps) / 127   (tiny collective)
  2. local quantization   q_i = round((g_i + e_i) / s)    int8
  3. integer reduction    Q = psum(q_i)                   (int32 sum)
  4. decode               g_hat = Q * s / N
  5. error feedback       e_i' = (g_i + e_i) - q_i * s

Only the int8 payload need cross the axis (``wire_bytes``), against
four bytes an element for an f32 all-reduce; error feedback keeps the
long-run bias bounded. The sum runs in int32, as the reference's
``psum`` does (no collective here sums int8 without overflow).

The quantization core (``BLOCK``, ``_pad_blocks``, ``block_scale``) is
``kvcache/quant.py``'s, the KV offload codec's, as in the reference.

Calling convention. The reference takes each leaf as the N shards'
gradients stacked on a leading axis of size N = ``mesh.shape[axis]``
and returns (the mean [...], the new errors [N, ...]). Here every rank
of the axis calls ``compressed_psum`` with its own gradient tree (the
reference's row ``i`` on the rank at ``coord(axis) == i``) and its own
error tree, and gets back the mean (the same on every rank) and its
own new errors (the reference's row ``i``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed.collectives import all_reduce
from repro_torch.kvcache.quant import BLOCK, _pad_blocks, block_scale
from repro_torch.training.optimizer import tree_leaves, tree_map

__all__ = ["BLOCK", "compressed_psum", "wire_bytes"]


def _leaf_reduce(g, e, mesh, axis: str):
    x = g.float() + e
    blocks, _ = _pad_blocks(x.reshape(-1))
    scale = block_scale(all_reduce(blocks.abs().amax(dim=1), mesh, axis,
                                   dist.ReduceOp.MAX))
    q = torch.round(blocks / scale[:, None]).clamp(-127, 127) \
        .to(torch.int8)
    total = all_reduce(q.to(torch.int32), mesh, axis)
    n = x.numel()
    mean = (total.float() * scale[:, None] / mesh.shape[axis]) \
        .reshape(-1)[:n].reshape(x.shape)
    deq = (q.float() * scale[:, None]).reshape(-1)[:n].reshape(x.shape)
    return mean, x - deq


def compressed_psum(grads, mesh, axis: str, errors=None):
    """This rank's gradient tree ``grads`` mean-reduced over ``axis`` in
    the int8 wire format, with error feedback: (the mean tree in f32,
    this rank's new error tree in f32). ``errors`` (default zeros) is
    this rank's error tree from the last call."""
    if errors is None:
        errors = tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                                device=g.device), grads)
    pairs = [_leaf_reduce(g, e, mesh, axis) for g, e in
             zip(tree_leaves(grads), tree_leaves(errors))]
    means, errs = iter(p[0] for p in pairs), iter(p[1] for p in pairs)
    return (tree_map(lambda _: next(means), grads),
            tree_map(lambda _: next(errs), grads))


def wire_bytes(grads) -> int:
    """int8 payload bytes a rank sends per reduction (telemetry): one a
    gradient element of its tree."""
    return sum(g.numel() for g in tree_leaves(grads))
