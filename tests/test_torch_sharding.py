"""The port's sharding rules (``distributed/sharding.py``) against the
JAX package's, in process: JAX's ``ShardingRules`` runs over a
``jax.sharding.AbstractMesh`` (no devices), the port's over a
``MeshShape`` of the same axes.

For every config of ``list_configs()`` on meshes 1x2, 2x2, 4x2, 2x4,
16x16 and the pod (2, 16, 16), with ``fsdp`` None (``needs_fsdp``
decides) and True and ``mode`` train and decode: the spec of every
leaf of the parameters (the port's ``param_shapes``, meta tensors, the
reference's ``launch/specs.py::param_shapes``), of the AdamW and
Adafactor states built on them, and of the decode caches at two
sizes, equals JAX's leaf for leaf and path for path; ``needs_fsdp``
agrees. ``expert_tp`` without a mesh is refused.
"""
import functools

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as j_get_config
from repro.configs import list_configs as j_list_configs
from repro.distributed import sharding as jsh
from repro.launch import specs as SP
from repro.training import optimizer as jopt
from repro_torch.configs import get_config, reduced
from repro_torch.distributed import sharding as tsh
from repro_torch.models import model as TM
from repro_torch.models import moe as tmoe
from repro_torch.training import optimizer as topt

MESHES = {"1x2": {"data": 1, "model": 2}, "2x2": {"data": 2, "model": 2},
          "4x2": {"data": 4, "model": 2}, "2x4": {"data": 2, "model": 4},
          "16x16": {"data": 16, "model": 16},
          "pod": {"pod": 2, "data": 16, "model": 16}}
CACHES = ((8, 64), (256, 4096))          # (batch, capacity)


def _jax_flat(tree) -> dict:
    """JAX NamedSharding tree -> {path: spec tuple}."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.NamedSharding))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in kp): tuple(s.spec) for kp, s in leaves}


def _port_flat(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        return {k: v for n, t in tree.items()
                for k, v in _port_flat(t, f"{prefix}{n}/").items()}
    if isinstance(tree, list):
        return {k: v for i, t in enumerate(tree)
                for k, v in _port_flat(t, f"{prefix}{i}/").items()}
    assert isinstance(tree, tsh.P), tree
    return {prefix[:-1]: tuple(tree)}


@functools.lru_cache(maxsize=None)
def _trees(name):
    """(JAX's shape trees, the port's meta trees) of ``name``: params,
    the AdamW and Adafactor states, the caches."""
    jcfg, tcfg = j_get_config(name), get_config(name)
    jp, tp = SP.param_shapes(jcfg), TM.param_shapes(tcfg)
    j, t = {"params": jp}, {"params": tp}
    for kind in ("adamw", "adafactor"):
        j[kind] = jax.eval_shape(functools.partial(
            jopt.opt_init, jopt.OptConfig(kind=kind)), jp)
        t[kind] = topt.opt_init(topt.OptConfig(kind=kind), tp)
    enc = tcfg.encoder.num_frames if tcfg.family == "encdec" else 0
    for B, W in CACHES:
        j[B, W] = SP.cache_shapes(jcfg, B, W)
        t[B, W] = TM.init_cache(tcfg, B, W, "meta", enc_frames=enc)
    return jcfg, tcfg, j, t


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", j_list_configs())
def test_specs_equal_jax_leaf_for_leaf(name, mesh):
    jcfg, tcfg, j, t = _trees(name)
    shape = MESHES[mesh]
    amesh = AbstractMesh(tuple(shape.values()), tuple(shape))
    tmesh = tsh.MeshShape(shape)
    assert tsh.needs_fsdp(tcfg, tmesh) == jsh.needs_fsdp(jcfg, amesh)
    n = 0
    for fsdp in (None, True):
        for mode in ("train", "decode"):
            jr = jsh.ShardingRules(jcfg, amesh, mode=mode, fsdp=fsdp)
            tr = tsh.ShardingRules(tcfg, tmesh, mode=mode, fsdp=fsdp)
            assert tr.fsdp == jr.fsdp and tr.decode_2d == jr.decode_2d
            for key in j:
                if key == "params":
                    want, got = jr.params(j[key]), tr.params(t[key])
                elif key in ("adamw", "adafactor"):
                    want, got = jr.opt_state(j[key]), tr.opt_state(t[key])
                else:
                    want, got = jr.cache(j[key]), tr.cache(t[key])
                want, got = _jax_flat(want), _port_flat(got)
                assert got == want, (fsdp, mode, key, {
                    k: (got.get(k), want.get(k)) for k in set(got) | set(want)
                    if got.get(k) != want.get(k)})
                n += len(got)
            assert tuple(tr.batch({"t": torch.empty(32, 8)})["t"]) == \
                tuple(jr.batch({"t": jax.ShapeDtypeStruct(
                    (32, 8), "int32")})["t"].spec)
            assert tuple(tr.activation_spec()) == tuple(jr.activation_spec())
            assert tuple(tr.logits_sharding(32)) == \
                tuple(jr.logits_sharding(32).spec)
    assert n > 0


def test_local_block_and_full_shape():
    """``local_block`` cuts each dim into its axes' blocks, row-major
    over a tuple of axes (the first major); ``full_shape`` undoes the
    shape."""
    class Rank:
        shape = {"data": 2, "model": 3}

        def __init__(self, d, m):
            self.c = {"data": d, "model": m}

        def coord(self, axis):
            return self.c[axis]

    t = torch.arange(12 * 4).reshape(12, 4)
    spec = tsh.P(("data", "model"), None)
    blocks = [tsh.local_block(t, spec, Rank(d, m))
              for d in range(2) for m in range(3)]
    assert torch.equal(torch.cat(blocks), t)
    assert tsh.full_shape(blocks[0].shape, spec, Rank(0, 0)) == (12, 4)
    b = tsh.local_block(t, tsh.P("model", "data"), Rank(1, 2))
    assert torch.equal(b, t[8:12, 2:4])


# ----------------------------------------------------------- refusals
def test_moe_apply_refuses_expert_tp():
    """``expert_tp`` splits the experts over a mesh: without one it is
    refused (over a mesh, ``tests/test_torch_mesh_serve.py``)."""
    cfg = reduced(get_config("phi3.5-moe-42b-a6.6b"))
    with pytest.raises(ValueError, match="expert_tp.*mesh"):
        tmoe.moe_apply({}, torch.zeros(1, 2, cfg.d_model), cfg,
                       expert_tp=True)
