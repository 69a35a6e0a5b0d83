"""AdamW and Adafactor over the parameter tree (the JAX package's
``training/optimizer.py``): the reference's math leaf for leaf, with no
external optimizer.

- adamw: an f32 master copy and two f32 moments.
- adafactor: an f32 master copy and a factored second moment (row and
  column statistics) for the leaves whose last two dims are both at
  least ``factored_min_dim``, a full one for the rest.

The state mirrors the parameter tree, in the reference's layout and
names (``step``, ``master``, ``mu``/``nu`` or ``v``), so the same
checkpoint files carry it. The leaves are the stacked ``[L, ...]``
ones: weight decay applies where a leaf has two dims or more (a stacked
norm scale ``[L, d]`` too), Adafactor factors by the stacked shape and
clips its update by the RMS of the whole stacked leaf, as the
reference does. The step count, the bias corrections, ``beta2`` and the
global-norm clip are f32 scalars on the parameters' device, computed
there from Python numbers: an update copies nothing from the host, so
the host never waits for the device inside it.

Over a mesh (``mesh`` a rank's mesh, ``specs`` the tree of the
parameters' specs, ``distributed/sharding.py``) every leaf is this
rank's block, and the state's leaves follow their parameter's spec
(``rules.opt_state``). AdamW stays elementwise. The reductions that
cross a leaf's blocks sum over the axes the leaf is sharded on: the
global norm (a leaf held whole on several ranks counts once), and
Adafactor's row and column means, the mean of its row statistic and
its update's RMS. Adafactor factors by the full shape.

``opt_update`` works in place under ``torch.no_grad()``: the master,
the moments and the parameters are overwritten leaf by leaf (a copy of
the whole state would not fit beside it at full width), and the same
tensors are returned. Each new value is computed as the reference
computes it and then copied in.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import full_shape, spec_axes


@dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"              # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # adafactor
    decay_rate: float = 0.8
    factored_min_dim: int = 64


def select_optimizer(cfg) -> OptConfig:
    """Adafactor for >=40B-param configs (memory), AdamW otherwise."""
    if cfg.num_params() >= 40e9:
        return OptConfig(kind="adafactor")
    return OptConfig(kind="adamw")


# ---------------------------------------------------------------- trees
def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (nested dicts and lists) and
    what stands at the same place in each of ``rest`` (a leaf, or a
    subtree such as Adafactor's per-leaf ``{"vr", "vc"}``); the same
    structure back."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def _f32(p):
    return p.detach().to(torch.float32, copy=True)


def zeros_f32(p):
    return torch.zeros_like(p, dtype=torch.float32)


def _global_norm(grads, mesh=None, specs=None):
    if mesh is None:
        return torch.sqrt(sum(g.float().square().sum()
                              for g in tree_leaves(grads)))
    # the leaves' squares summed by the axes they shard over, each sum
    # then over its axes: in one order on every rank
    pairs = []
    tree_map(lambda g, s: pairs.append((g, s)), grads, specs)
    parts = {}
    for g, s in pairs:
        key = tuple(sorted(spec_axes(s)))
        parts[key] = parts.get(key, 0) + g.float().square().sum()
    total = 0
    for key in sorted(parts):
        t = parts[key]
        for axis in key:
            t = C.all_reduce(t, mesh, axis)
        total = total + t
    return torch.sqrt(total)


def _clip_scale(opt: OptConfig, grads, mesh=None, specs=None):
    gnorm = _global_norm(grads, mesh, specs)
    return gnorm, torch.clamp(opt.grad_clip / (gnorm + 1e-9), max=1.0)


def _mean(x, dims, spec, mesh, keepdim=False):
    """``x.mean(dims)`` (None: of every element) of a block, over the
    whole leaf: the block means (equal blocks) summed over the axes of
    those dims and divided by their sizes."""
    if dims is None:
        m, axes = x.mean(), spec_axes(spec or ())
    else:
        m = x.mean(dim=dims, keepdim=keepdim)
        axes = spec_axes([spec[dims]]) if mesh is not None else ()
    for axis in sorted(axes):
        m = C.all_reduce(m, mesh, axis) / mesh.shape[axis]
    return m


def _step_of(params):
    dev = tree_leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


# ---------------------------------------------------------------- adamw
def adamw_init(params):
    return {"step": _step_of(params),
            "master": tree_map(_f32, params),
            "mu": tree_map(zeros_f32, params),
            "nu": tree_map(zeros_f32, params)}


@torch.no_grad()
def adamw_update(opt: OptConfig, grads, state, params, mesh=None,
                 specs=None):
    state["step"] += 1
    t = state["step"].float()
    gnorm, scale = _clip_scale(opt, grads, mesh, specs)
    bc1 = 1 - torch.pow(opt.b1, t)
    bc2 = 1 - torch.pow(opt.b2, t)

    def upd(g, m, mu, nu, p):
        g = g.float() * scale
        mu.copy_(opt.b1 * mu + (1 - opt.b1) * g)
        nu.copy_(opt.b2 * nu + (1 - opt.b2) * g.square())
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + opt.eps)
        if m.dim() >= 2:
            u = u + opt.weight_decay * m
        m.copy_(m - opt.lr * u)
        p.copy_(m)

    tree_map(upd, grads, state["master"], state["mu"], state["nu"], params)
    return params, state, {"grad_norm": gnorm}


# ------------------------------------------------------------- adafactor
def _factored(shape, min_dim) -> bool:
    return len(shape) >= 2 and shape[-1] >= min_dim and shape[-2] >= min_dim


def _no_specs(params):
    return tree_map(lambda _: None, params)


def adafactor_init(params, *, min_dim: int = 128, mesh=None, specs=None):
    def vstate(p, s):
        z = dict(dtype=torch.float32, device=p.device)
        full = p.shape if mesh is None else full_shape(p.shape, s, mesh)
        if _factored(full, min_dim):
            return {"vr": torch.zeros(p.shape[:-1], **z),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
        return {"v": torch.zeros(p.shape, **z)}

    return {"step": _step_of(params),
            "master": tree_map(_f32, params),
            "v": tree_map(vstate, params, specs or _no_specs(params))}


@torch.no_grad()
def adafactor_update(opt: OptConfig, grads, state, params, mesh=None,
                     specs=None):
    state["step"] += 1
    beta2 = 1.0 - torch.pow(state["step"].float(), -opt.decay_rate)
    gnorm, scale = _clip_scale(opt, grads, mesh, specs)

    def upd(p, g, m, v, s):
        g = g.float() * scale
        g2 = g.square() + 1e-30
        if "vr" in v:
            v["vr"].copy_(beta2 * v["vr"]
                          + (1 - beta2) * _mean(g2, -1, s, mesh))
            v["vc"].copy_(beta2 * v["vc"]
                          + (1 - beta2) * _mean(g2, -2, s, mesh))
            del g2
            # vr's last dim is the parameter's second to last
            denom = torch.clamp(_mean(v["vr"], -1, s and s[:-1], mesh,
                                      keepdim=True),
                                min=1e-30)[..., None]      # [..., 1, 1]
            u = g * torch.rsqrt(v["vr"][..., None] / denom) \
                * torch.rsqrt(v["vc"][..., None, :])
        else:
            v["v"].copy_(beta2 * v["v"] + (1 - beta2) * g2)
            u = g * torch.rsqrt(v["v"] + 1e-30)
        del g
        # update clipping (RMS <= 1) per the adafactor recipe
        rms = torch.sqrt(_mean(u.square(), None, s, mesh) + 1e-30)
        u = u / torch.clamp(rms, min=1.0)
        if m.dim() >= 2:
            u = u + opt.weight_decay * m
        m.copy_(m - opt.lr * u)
        p.copy_(m)

    tree_map(upd, params, grads, state["master"], state["v"],
             specs or _no_specs(params))
    return params, state, {"grad_norm": gnorm}


# ---------------------------------------------------------------- facade
def opt_init(opt: OptConfig, params, mesh=None, specs=None):
    if opt.kind == "adamw":
        return adamw_init(params)
    return adafactor_init(params, min_dim=opt.factored_min_dim, mesh=mesh,
                          specs=specs)


def opt_update(opt: OptConfig, grads, state, params, mesh=None,
               specs=None):
    """One update, in place: returns (params, state, {"grad_norm"}),
    the tensors it was given."""
    if opt.kind == "adamw":
        return adamw_update(opt, grads, state, params, mesh, specs)
    return adafactor_update(opt, grads, state, params, mesh, specs)


def state_shapes(state, shapes):
    """The full shapes of an optimizer state's leaves, as meta tensors,
    from its parameters' (``shapes``, a tree of anything with a
    ``.shape``): ``master``/``mu``/``nu`` theirs, Adafactor's ``v``
    theirs, ``vr`` without the last dim, ``vc`` without the one before;
    ``step`` a scalar."""
    def meta(shape):
        return torch.empty(tuple(shape), device="meta")

    def v(p, st):
        full = tuple(p.shape)
        if "vr" in st:
            return {"vr": meta(full[:-1]),
                    "vc": meta(full[:-2] + full[-1:])}
        return {"v": meta(full)}

    out = {}
    for k, sub in state.items():
        if k == "step":
            out[k] = meta(())
        elif k == "v":
            out[k] = tree_map(v, shapes, sub)
        else:
            out[k] = tree_map(lambda p: meta(p.shape), shapes)
    return out
