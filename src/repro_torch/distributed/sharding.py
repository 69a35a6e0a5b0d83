"""Per-family sharding rules (DESIGN.md §8): the JAX package's
``distributed/sharding.py`` on the port's trees.

Rules map parameter-tree paths to partition specs over a
('data', 'model') (+ optional leading 'pod') mesh:

- head / d_ff / expert / vocab dimensions shard over 'model' *when
  divisible* (non-divisible dims fall back to replication — e.g.
  qwen2's 12 heads on a 16-way axis);
- for configs whose per-model-shard weights would blow device memory
  (``needs_fsdp``), the d_model/contraction dims additionally shard
  over 'data' (FSDP/ZeRO-3 at rest; the model gathers them at the
  layer that uses them);
- batch shards over all data axes; decode KV caches shard their
  *sequence* dim over 'model';
- Mamba2/RG-LRU shard heads/channels over 'model'.

The rule logic and names are the reference's. What differs is the
carrier: a spec is the port's ``P`` (a tuple of axis names, tuples of
them or ``None``, one entry a dim, a one-name tuple canonicalised to
the name as JAX's ``PartitionSpec`` does), and the trees the rules
walk are the port's nested dicts and lists, each leaf anything with a
``.shape``. Where the reference returns a ``NamedSharding``, the port
returns the ``P`` alone: the mesh travels beside it. The rules read
only ``mesh.shape`` (axis name -> size) and ``mesh.axis_names``, so
an abstract ``MeshShape`` serves as well as a rank's mesh
(``launch/mesh.py``).

``local_block`` and ``full_leaf`` (outside the rules) move between a
full leaf and the block of it that one rank of a mesh holds.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

FSDP_BYTES = 4e9       # per-chip weight budget before FSDP kicks in
# (4 GB: with bf16 params + fp32 Adafactor master at rest, a non-FSDP
# layout already costs 3x this per chip)


class P(tuple):
    """A partition spec: entry ``i`` names the mesh axis (or axes, a
    tuple, major first) that dim ``i`` shards over, or ``None``."""

    def __new__(cls, *parts):
        return super().__new__(cls, (
            p[0] if isinstance(p, tuple) and len(p) == 1
            else tuple(p) if isinstance(p, (tuple, list)) else p
            for p in parts))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


class MeshShape:
    """An abstract mesh: axis names and sizes, no devices (the shape the
    rules read)."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)


def needs_fsdp(cfg, mesh) -> bool:
    model_shards = mesh.shape["model"]
    return cfg.num_params() * 2 / model_shards > FSDP_BYTES


def axis_size(mesh, *names) -> int:
    return int(np.prod([mesh.shape[n] for n in names]))


def _tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over nested dicts and lists; the same structure
    back (path: the keys and list indices from the root)."""
    if isinstance(tree, dict):
        return {k: _tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map_with_path(fn, v, path + (i,))
                for i, v in enumerate(tree)]
    return fn(path, tree)


class ShardingRules:
    def __init__(self, cfg, mesh, *, mode: str = "train",
                 fsdp: Optional[bool] = None, expert_tp: bool = False):
        self.cfg = cfg
        self.mesh = mesh
        self.mode = mode
        self.expert_tp = expert_tp
        self.data_axes = tuple(n for n in mesh.axis_names if n != "model")
        self.fsdp = needs_fsdp(cfg, mesh) if fsdp is None else fsdp
        self.M = mesh.shape["model"]
        self.D = axis_size(mesh, *self.data_axes)

    # ------------------------------------------------------------ helpers
    def _m(self, dim_size: int):
        """'model' if divisible else replicate."""
        return "model" if dim_size % self.M == 0 else None

    def _d(self, dim_size: int):
        """FSDP at-rest sharding of contraction dims over 'data'."""
        if not self.fsdp:
            return None
        return ("data" if dim_size % self.mesh.shape["data"] == 0
                else None)

    def _b(self, dim_size: int):
        """Batch dim over data axes when divisible (long_500k has B=1)."""
        if self.decode_2d:
            return None                 # 2D-TP decode replicates batch
        return self.data_axes if dim_size % self.D == 0 else None

    @property
    def decode_2d(self) -> bool:
        """Big-model decode: weights 2D-sharded (d x heads), batch
        replicated, KV sequence sharded over BOTH axes — avoids per-token
        FSDP weight gathers (DESIGN.md §8)."""
        return self.fsdp and self.mode == "decode"

    def _seq(self, w: int):
        """KV ring sequence dim sharding."""
        if self.decode_2d and w % (self.D * self.M) == 0:
            return tuple(self.data_axes) + ("model",)
        return "model" if w % self.M == 0 else None

    # ------------------------------------------------------------ params
    def param_spec(self, path: str, shape) -> P:
        nd = len(shape)
        leaf = path.split("/")[-1]

        if leaf in ("embed",):                       # [V, d]
            return P(self._m(shape[0]), self._d(shape[1]))
        if leaf == "unembed":                        # [d, V]
            return P(self._d(shape[0]), self._m(shape[1]))
        if "attn" in path or "xattn" in path:
            if leaf == "wq":                         # [d, H, hd]
                return P(self._d(shape[0]), self._m(shape[1]), None)
            if leaf in ("wk", "wv"):                 # [d, Hkv, hd] (small)
                return P(self._d(shape[0]), self._m(shape[1]), None)
            if leaf == "wo":                         # [H, hd, d]
                return P(self._m(shape[0]), None, self._d(shape[2]))
            if leaf in ("bq", "bk", "bv"):           # [H, hd]
                return P(self._m(shape[0]), None)
            # MLA pieces
            if leaf == "w_dq":
                return P(self._d(shape[0]), None)
            if leaf == "w_uq":                       # [ql, H, e]
                return P(None, self._m(shape[1]), None)
            if leaf == "w_dkv":
                return P(self._d(shape[0]), None)
            if leaf in ("w_uk", "w_uv"):             # [r, H, e]
                return P(None, self._m(shape[1]), None)
        if "moe" in path:
            if leaf == "router":
                return P(None, None)
            if leaf in ("w_gate", "w_up") and nd == 3:   # [E, d, f]
                if self.expert_tp:
                    return P(self._m(shape[0]), None,
                             "data" if shape[2] % self.mesh.shape["data"]
                             == 0 else None)
                return P(self._m(shape[0]), self._d(shape[1]), None)
            if leaf == "w_down" and nd == 3:             # [E, f, d]
                if self.expert_tp:
                    return P(self._m(shape[0]),
                             "data" if shape[1] % self.mesh.shape["data"]
                             == 0 else None, None)
                return P(self._m(shape[0]), None, self._d(shape[2]))
        if "mixer" in path:                          # mamba2
            if leaf in ("w_z", "w_x"):               # [d, d_in]
                return P(self._d(shape[0]), self._m(shape[1]))
            if leaf in ("w_B", "w_C"):               # [d, gn] small
                return P(self._d(shape[0]), None)
            if leaf == "w_dt":                       # [d, nheads]
                return P(self._d(shape[0]), self._m(shape[1]))
            if leaf in ("conv_x", "conv_x_b"):
                return P(*([None] * (nd - 1)), self._m(shape[-1]))
            if leaf in ("conv_bc", "conv_bc_b"):
                return P(*([None] * nd))
            if leaf in ("A_log", "D", "dt_bias"):    # [nheads]
                return P(self._m(shape[0]))
            if leaf == "norm":                       # [d_in]
                return P(self._m(shape[0]))
            if leaf == "out_proj":                   # [d_in, d]
                return P(self._m(shape[0]), self._d(shape[1]))
        if "rec" in path.split("/"):                 # rg-lru
            if leaf in ("in_gate", "in_rec"):        # [d, w]
                return P(self._d(shape[0]), self._m(shape[1]))
            if leaf == "conv_w":
                return P(None, self._m(shape[1]))
            if leaf in ("conv_b", "b_a", "b_x", "lam"):
                return P(self._m(shape[0]))
            if leaf in ("w_a", "w_x"):               # [nb, bw, bw]
                return P(self._m(shape[0]), None, None)
            if leaf == "out":                        # [w, d]
                return P(self._m(shape[0]), self._d(shape[1]))
        if "mlp" in path or "shared" in path:
            if leaf in ("w_gate", "w_up") and nd == 2:
                if self.expert_tp and "shared" in path:
                    return P(None, self._m(shape[1]))
                return P(self._d(shape[0]), self._m(shape[1]))
            if leaf == "w_down" and nd == 2:
                if self.expert_tp and "shared" in path:
                    return P(self._m(shape[0]), None)
                return P(self._m(shape[0]), self._d(shape[1]))
            if leaf in ("b_up",):
                return P(self._m(shape[0]))
        # norms, scalars, everything else: replicated
        return P(*([None] * nd))

    def params(self, shapes) -> dict:
        """A tree of leaves with ``.shape`` -> the same tree of specs."""
        return _tree_map_with_path(self._stacked_fix, shapes)

    def _stacked_fix(self, kp, leaf) -> P:
        """Layer-stacked params carry a leading [L] dim not present in the
        per-layer rule table: match on the trailing dims. Adafactor
        second-moment leaves (v / vr / vc) inherit the parent parameter's
        spec (vr drops the last dim, vc the second-to-last)."""
        parts = [str(k) for k in kp]
        tail = parts[-1]
        fac = tail if tail in ("v", "vr", "vc") and len(parts) > 1 else None
        if fac:
            parts = parts[:-1]
        path = "/".join(parts)
        in_stack = "layers/" in path and "layers_pre" not in path \
            and self.cfg.family != "hybrid"
        shape = tuple(leaf.shape)
        if fac == "vr":
            shape = shape + (1,)          # reconstruct param rank
        elif fac == "vc":
            shape = shape[:-1] + (1, shape[-1])
        pshape = shape[1:] if in_stack and len(shape) >= 1 else shape
        spec = self.param_spec(path, pshape)
        if in_stack:
            spec = P(None, *spec)
        if fac == "vr":
            spec = P(*spec[:-1])
        elif fac == "vc":
            spec = P(*(spec[:-2] + (spec[-1],)))
        return spec

    # ------------------------------------------------------------ batch
    def batch(self, shapes) -> dict:
        # tokens/labels/weights [B, S]; frames/patches [B, F, d]
        return _tree_map_with_path(
            lambda kp, x: P(self._b(x.shape[0]),
                            *([None] * (len(x.shape) - 1))), shapes)

    def token_sharding(self, batch: int) -> P:
        """Decode-step token vector [B]."""
        return P(self._b(batch))

    def logits_sharding(self, batch: int) -> P:
        """Serve-step output logits [B, V]."""
        return P(self._b(batch), self._m(self.cfg.vocab_size))

    # ------------------------------------------------------------ cache
    def rows_spec(self, batch: int):
        """The spec entry of a cache's batch dim (``len``'s)."""
        return self._b(batch)

    def ring_spec(self, window: int):
        """The spec entry of a ring of ``window`` slots' sequence dim."""
        return self._seq(window)

    def cache(self, shapes) -> dict:
        """Decode/prefill cache: batch over data (when divisible); KV ring
        sequence over 'model' (over both axes in 2D-TP decode); SSM heads /
        RG-LRU channels over model."""
        def b(x):
            return self._b(x.shape[1])

        def spec(kp, x):
            name = str(kp[-1])
            nd = len(x.shape)
            if name == "len":
                return P(self._b(x.shape[0]))
            if name == "kv_pos":                       # [B, W]
                return P(self._b(x.shape[0]), self._seq(x.shape[1]))
            if name in ("k", "v"):                     # [L, B, W, Hkv, hd]
                return P(None, b(x), self._seq(x.shape[2]), None, None)
            if name in ("ckv", "k_rope"):              # [L, B, W, r]
                return P(None, b(x), self._seq(x.shape[2]), None)
            if name in ("cross_k", "cross_v"):         # [L, B, F, H, hd]
                return P(None, b(x), None, self._m(x.shape[3]), None)
            if name == "ssm_state":                    # [L, B, H, p, n]
                return P(None, b(x), self._m(x.shape[2]), None, None)
            if name in ("conv_x",):                    # [L, B, cw-1, d_in]
                return P(None, b(x), None, self._m(x.shape[3]))
            if name == "conv_bc":
                return P(None, b(x), None, None)
            if name == "rec_h":                        # [Lr, B, w]
                return P(None, b(x), self._m(x.shape[2]))
            if name == "rec_conv":                     # [Lr, B, cw-1, w]
                return P(None, b(x), None, self._m(x.shape[3]))
            return P(*([None] * nd))
        return _tree_map_with_path(spec, shapes)

    # ------------------------------------------------------------ opt
    def opt_state(self, shapes) -> dict:
        """Optimizer state mirrors param sharding (moments/master share the
        param layout -> ZeRO follows from fsdp at-rest sharding)."""
        return self.params(shapes)

    def activation_spec(self) -> P:
        """Residual-stream constraint for training: batch over data, seq
        over 'model' (Megatron-style sequence parallelism for the saved
        activations)."""
        return P(self.data_axes, "model", None)


# ======================================================================
# a rank's block of a leaf (outside the rules)
# ======================================================================
def _axes(entry) -> tuple:
    """A spec entry's axes, major first (``None``: none)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_axes(spec) -> set:
    """Every mesh axis a spec names."""
    return {a for e in spec for a in _axes(e)}


def full_shape(shape, spec, mesh) -> tuple:
    """The full shape of a leaf whose block has ``shape`` under
    ``spec``."""
    return tuple(n * axis_size(mesh, *_axes(e))
                 for n, e in zip(shape, tuple(spec) + (None,) * len(shape)))


def local_block(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of the full leaf ``t`` under ``spec``: each dim
    cut into as many equal blocks as its axes have positions (row-major
    over the axes, the first major), the block at this rank's place on
    them (``mesh.coord(axis)``). A view of ``t``."""
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        if not axes:
            continue
        n, i = 1, 0
        for a in axes:
            n, i = n * mesh.shape[a], i * mesh.shape[a] + mesh.coord(a)
        size = t.shape[dim]
        if size % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not "
                             f"split {n} ways ({spec})")
        t = t.narrow(dim, i * (size // n), size // n)
    return t


def full_leaf(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The full leaf whose block ``t`` is under ``spec``: the blocks
    gathered over every axis the spec names, the minor axis of a dim
    first (a collective: every rank of those axes calls it)."""
    for dim, entry in enumerate(spec):
        for a in reversed(_axes(entry)):
            t = mesh.gather_axis(t, dim, a)
    return t


def tree_local(tree, specs, mesh):
    """``local_block`` over a tree and its tree of specs."""
    return _tree_map_with_path(
        lambda kp, t: local_block(t, _at(specs, kp), mesh), tree)


def tree_full(tree, specs, mesh):
    """``full_leaf`` over a tree and its tree of specs."""
    return _tree_map_with_path(
        lambda kp, t: full_leaf(t, _at(specs, kp), mesh), tree)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree
