"""The collectives of training over a ('data', 'model') mesh, with their
backward (no counterpart in the JAX package, where GSPMD inserts them).

Every function takes a rank's mesh (``launch/mesh.py``), which gives
each axis's group, size and this rank's place on it. The autograd
ones follow Megatron's pairing:

- ``copy_to_model``: forward identity, backward a sum over 'model'. A
  replicated tensor enters work that each 'model' rank does on its own
  part (its heads, its ``d_ff`` slice, its tokens), so each rank's
  gradient is a partial sum.
- ``reduce_from_model``: forward a sum over 'model', backward
  identity. The parts' partial outputs sum to the replicated result,
  and every rank then holds its whole gradient.
- ``gather_from_model(dim)``: forward the parts laid side by side,
  backward this rank's slice of the gradient.
- ``gather_over_data(dim)``: an FSDP leaf made whole for the layer
  that uses it; backward a reduce-scatter sum over 'data', so each rank
  keeps its own block of the gradient summed over the data ranks.
- ``all_to_all_model``: the expert-parallel exchange; backward the
  exchange the other way.
- ``mean_over_data``: forward the mean over 'data', backward identity
  (each data rank's share of the loss is its own term; the train step
  sums them).
- ``sum_over_model``: forward a sum over 'model', backward a sum over
  'model' too. A statistic summed over the parts of a sharded dim (the
  mamba2 mixer's sum of squares over ``d_in``) feeds every part's own
  work, so each rank's gradient of it is a partial sum; an identity
  backward (``reduce_from_model``'s) would give each rank only its own
  part's share of the gradient: the loss right, the gradients wrong.

``torch.distributed.nn.functional.all_reduce`` is not used: its
backward is another all-reduce, which is wrong for
``reduce_from_model``.

Every gather, reduce-scatter and all-to-all is an ``all_reduce`` sum,
on both backends (a gather: each rank writes its part into zeros; an
all-to-all: each rank writes the blocks it sends into a zeroed [dst,
src] buffer and keeps its row). Gloo has no reduce-scatter, and between
ranks that share a card it stages CUDA tensors through host memory only
for ``broadcast`` and ``all_reduce``; the serving plane's
``ServingMesh.gather`` takes the same form. Each rank's result is
bit-equal across the ranks that receive it.

Every collective goes through ``_collective``, the one place that
moves data: on a placeholder mesh (``launch/mesh.py::PlaceholderMesh``,
the dry run's) it moves nothing and the caller's tensor of the
result's shape and type comes back as it is (meta tensors under the
dry run), while a real mesh runs the ``all_reduce``. On both, a
``recording()`` in force adds the per-device bytes of each
collective's result under the kind of collective it is, in the names
the reference's ``collective_bytes_from_hlo`` reads from the compiled
program (``all-gather``, ``all-reduce``, ``reduce-scatter``,
``all-to-all``, ``collective-permute``) and ``total``: the logical
collective, so a gather counts as the ``all-gather`` of its gathered
result though it travels as an ``all_reduce`` into zeros.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

_RECORDERS: list = []


@contextlib.contextmanager
def recording():
    """Within the block, every collective adds its result's bytes to the
    dict this yields, by kind and under ``total``."""
    rec: dict = {}
    _RECORDERS.append(rec)
    try:
        yield rec
    finally:
        _RECORDERS.remove(rec)


def _collective(buf: torch.Tensor, mesh, axis: str, op, kind: str,
                nbytes: int) -> torch.Tensor:
    """``buf`` summed (or ``op``) over ``axis`` in place, recorded as a
    ``kind`` collective whose result has ``nbytes`` bytes a device;
    nothing moves on a placeholder mesh."""
    for rec in _RECORDERS:
        rec[kind] = rec.get(kind, 0) + nbytes
        rec["total"] = rec.get("total", 0) + nbytes
    if not getattr(mesh, "placeholder", False):
        dist.all_reduce(buf, op=op, group=mesh.group(axis))
    return buf


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# ======================================================================
# the plain collectives (no autograd)
# ======================================================================
def all_reduce(t: torch.Tensor, mesh, axis: str,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The sum (or ``op``) of ``t`` over ``axis``, in place."""
    if mesh.shape[axis] > 1:
        _collective(t, mesh, axis, op, "all-reduce", _nbytes(t))
    return t


def all_gather(t: torch.Tensor, dim: int, mesh, axis: str) -> torch.Tensor:
    """The ``axis`` ranks' ``t`` laid side by side along ``dim``, rank
    ``i``'s at block ``i``."""
    n = mesh.shape[axis]
    if n == 1:
        return t
    dim = dim % t.dim()
    k = t.shape[dim]
    shape = list(t.shape)
    shape[dim] = n * k
    out = t.new_zeros(shape)
    out.narrow(dim, mesh.coord(axis) * k, k).copy_(t)
    return _collective(out, mesh, axis, dist.ReduceOp.SUM, "all-gather",
                       _nbytes(out))


def reduce_scatter(t: torch.Tensor, dim: int, mesh,
                   axis: str) -> torch.Tensor:
    """The sum of ``t`` over ``axis``, of which this rank keeps block
    ``coord(axis)`` along ``dim``."""
    n = mesh.shape[axis]
    if n == 1:
        return t
    dim = dim % t.dim()
    k = t.shape[dim] // n
    out = _collective(t.contiguous().clone(), mesh, axis,
                      dist.ReduceOp.SUM, "reduce-scatter", _nbytes(t) // n)
    return out.narrow(dim, mesh.coord(axis) * k, k).contiguous()


def all_to_all(t: torch.Tensor, split: int, concat: int, mesh,
               axis: str) -> torch.Tensor:
    """``t`` cut into ``n`` blocks along ``split``, block ``j`` sent to
    rank ``j`` of ``axis``; the blocks received laid side by side along
    ``concat``, the one from rank ``i`` at ``i`` (JAX's tiled
    ``all_to_all``)."""
    n = mesh.shape[axis]
    if n == 1:
        return t
    x = t.movedim(split, 0)
    x = x.reshape((n, x.shape[0] // n) + x.shape[1:]).contiguous()
    buf = x.new_zeros((n,) + x.shape)                # [dst, src, ...]
    buf[:, mesh.coord(axis)] = x
    out = _collective(buf, mesh, axis, dist.ReduceOp.SUM, "all-to-all",
                      _nbytes(x))[mesh.coord(axis)]
    # out [src, k, rest]: the block's own dims back in t's order, then
    # the source index merged into ``concat`` as its major part
    out = out.movedim(1, split + 1).movedim(0, concat)
    shape = list(out.shape)
    return out.reshape(shape[:concat] + [shape[concat] * shape[concat + 1]]
                       + shape[concat + 2:])


# ======================================================================
# the autograd collectives
# ======================================================================
class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.mesh, "model"), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(x.contiguous().clone(), mesh, "model")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh, ctx.k = dim, mesh, x.shape[dim]
        return all_gather(x, dim, mesh, "model")

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.coord("model")
        return g.narrow(ctx.dim, i * ctx.k, ctx.k), None, None


class _GatherOverData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return all_gather(x, dim, mesh, "data")

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.mesh, "data"), None, None


class _AllToAllModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split, concat, mesh):
        ctx.split, ctx.concat, ctx.mesh = split, concat, mesh
        return all_to_all(x, split, concat, mesh, "model")

    @staticmethod
    def backward(ctx, g):
        return (all_to_all(g, ctx.concat, ctx.split, ctx.mesh, "model"),
                None, None, None)


class _SumOverModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_reduce(x.contiguous().clone(), mesh, "model")

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.mesh, "model"), None


class _MeanOverData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(x.clone(), mesh, "data") / mesh.data

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x, mesh):
    return x if mesh.model == 1 else _CopyToModel.apply(x, mesh)


def reduce_from_model(x, mesh):
    return x if mesh.model == 1 else _ReduceFromModel.apply(x, mesh)


def sum_over_model(x, mesh):
    return x if mesh.model == 1 else _SumOverModel.apply(x, mesh)


def gather_from_model(x, dim: int, mesh):
    return x if mesh.model == 1 else \
        _GatherFromModel.apply(x, dim % x.dim(), mesh)


def gather_over_data(x, dim: int, mesh):
    return x if mesh.data == 1 else \
        _GatherOverData.apply(x, dim % x.dim(), mesh)


def all_to_all_model(x, split: int, concat: int, mesh):
    return x if mesh.model == 1 else \
        _AllToAllModel.apply(x, split, concat, mesh)


def mean_over_data(x, mesh):
    return x if mesh.data == 1 else _MeanOverData.apply(x, mesh)
