"""The port's dry run (``repro_torch.launch.specs`` and
``repro_torch.launch.dryrun``) and the surrogate attention, against the
JAX package on the CPU.

- ``specs`` leaf for leaf against ``repro.launch.specs`` for every
  config and shape: ``param_shapes``, ``batch_specs``,
  ``prefill_specs`` and ``decode_specs`` (their caches), shapes and
  dtypes; ``model_flops`` and ``cell_supported`` equal.
- ``microbatches_for``, ``reduced_depth_cfg`` and
  ``calibration_depths`` equal to the reference's on the 16 x 16 and
  2 x 16 x 16 production meshes (JAX initialised first: importing the
  reference's dry run sets ``XLA_FLAGS``).
- The surrogate ``gqa_attention`` (MHA, GQA) and ``mla_forward``
  against the reference's, f32 within 2e-5 and bf16 within 2e-2.
- A reduced config's train, prefill and decode cells traced on a
  placeholder 2x2 mesh give the flop count and the collective bytes,
  by kind, of rank 0 of the same program run for real on a gloo 2x2
  CPU mesh (one spawn; the rank body is
  ``tests/torch_serve_ranks.py::dryrun_rank``).
- The full-depth counts of a reduced config equal the line through the
  counts at its two calibration depths.
- One production cell, qwen2-1.5b x decode_32k x pod256, on meta:
  ``ok`` and its peak under the card's 80 GB.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_serve_ranks as ranks
from repro.configs import get_config as j_get_config
from repro.configs import list_configs as j_list_configs
from repro.launch import specs as JSP
from repro.models import layers as JL
from repro.models import mla as JMLA
from repro.models import model as JM
from repro_torch.configs import get_config, list_configs
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch import dryrun as DR
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_debug_mesh, \
    make_production_mesh, spawn
from repro_torch.models import layers as TL
from repro_torch.models import mla as TMLA
from repro_torch.models.model import params_from_numpy
from test_torch_mesh_train import _jcfg, _weights
from torch_train_ranks import case_config

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SPAWN_S = 300


def _sig(t):
    """(shape, dtype name) of a meta tensor or a ShapeDtypeStruct."""
    if isinstance(t, torch.Tensor):
        return tuple(t.shape), str(t.dtype).replace("torch.", "")
    return tuple(t.shape), str(t.dtype)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: _sig(tree)}


def test_list_configs_match():
    assert list_configs() == j_list_configs()


@pytest.mark.parametrize("arch", list_configs())
def test_specs_match_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert _leaves(SP.param_shapes(cfg)) == _leaves(JSP.param_shapes(jcfg))
    assert list(SP.SHAPES) == list(JSP.SHAPES)
    for name, cell in SP.SHAPES.items():
        jcell = JSP.SHAPES[name]
        assert dataclasses.astuple(cell) == dataclasses.astuple(jcell)
        assert SP.cell_supported(cfg, name) == JSP.cell_supported(jcfg, name)
        assert SP.model_flops(cfg, cell) == JSP.model_flops(jcfg, jcell)
        assert _leaves(SP.batch_specs(cfg, cell)) == \
            _leaves(JSP.batch_specs(jcfg, jcell))
        # the caches at 32k and 500k positions are shapes only here
        assert _leaves(SP.prefill_specs(cfg, cell)) == \
            _leaves(JSP.prefill_specs(jcfg, jcell))
        assert _leaves(SP.decode_specs(cfg, cell)) == \
            _leaves(JSP.decode_specs(jcfg, jcell))


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["pod256", "pod512"])
def test_dryrun_helpers_match_reference(multi_pod):
    jax.devices()            # before the reference's dry run sets XLA_FLAGS
    from repro.launch import dryrun as JDR
    mesh = make_production_mesh(multi_pod=multi_pod)
    assert mesh.world == (512 if multi_pod else 256)
    assert mesh.data == (32 if multi_pod else 16)
    for arch in list_configs():
        cfg, jcfg = get_config(arch), j_get_config(arch)
        assert DR.calibration_depths(cfg) == JDR.calibration_depths(jcfg)
        for L0 in DR.calibration_depths(cfg):
            assert dataclasses.asdict(DR.reduced_depth_cfg(cfg, L0)) == \
                dataclasses.asdict(JDR.reduced_depth_cfg(jcfg, L0))
        for name, cell in SP.SHAPES.items():
            assert DR.microbatches_for(cfg, cell, mesh) == \
                JDR.microbatches_for(jcfg, JSP.SHAPES[name], mesh), \
                (arch, name)


def test_placeholder_meshes():
    """The production meshes as rank 0 sees them: the axes and sizes,
    'pod' a data axis whose reductions span pod x data, coordinates and
    ranks row-major."""
    from repro_torch.launch.mesh import PlaceholderMesh, data_axes
    pod, two = make_production_mesh(multi_pod=True), make_production_mesh()
    assert pod.shape == {"pod": 2, "data": 16, "model": 16}
    assert data_axes(pod) == ("pod", "data") and data_axes(two) == ("data",)
    assert pod.group("data") == ("pod", "data") and pod.data == 32
    assert (pod.rank, pod.model, pod.idx, pod.device.type) == \
        (0, 16, 0, "meta")
    r = PlaceholderMesh({"data": 2, "model": 4}, {"data": 1, "model": 3})
    assert (r.rank, r.coord("data"), r.idx, r.is_leader) == (7, 1, 3, False)
    with pytest.raises(ValueError):
        PlaceholderMesh({"data": 2, "model": 4}, {"model": 4})


ATTN_CASES = {"mha": (4, 4, 16, 16), "gqa": (8, 2, 32, 32)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_surrogate_gqa_matches_reference(case, dtype):
    Hq, Hkv, D, Dv = ATTN_CASES[case]
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((2, 7, Hq, D), (2, 9, Hkv, D), (2, 9, Hkv, Dv)))
    mask = rng.random((2, 7, 9)) < 0.7
    jd = getattr(jnp, dtype)
    want = JL.gqa_attention(*(jnp.asarray(a, jd) for a in (q, k, v)),
                            jnp.asarray(mask), impl="surrogate")
    td = getattr(torch, dtype)
    got = TL.gqa_attention(*(torch.from_numpy(a).to(td) for a in (q, k, v)),
                           torch.from_numpy(mask), impl="surrogate")
    want = np.asarray(want.astype(jnp.float32))
    assert got.dtype == td and got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_surrogate_mla_matches_reference(dtype):
    jcfg = _jcfg("deepseek-v2-236b").replace(dtype=dtype,
                                             param_dtype=dtype)
    cfg = case_config("deepseek-v2-236b").replace(dtype=dtype,
                                                  param_dtype=dtype)
    lp = jax.tree.map(lambda a: a[0], _weights(5, "deepseek-v2-236b")[
        "layers"]["attn"])
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    x = np.random.default_rng(4).standard_normal((2, 7, cfg.d_model))
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (2, 7))
    want, (jckv, jkr) = JMLA.mla_forward(
        jax.tree.map(lambda a: jnp.asarray(a, jd), lp), jcfg,
        jnp.asarray(x, jd), jnp.asarray(pos), None, impl="surrogate")
    got, (ckv, kr) = TMLA.mla_forward(
        params_from_numpy(lp, "cpu", td), cfg,
        torch.from_numpy(x).to(td), torch.from_numpy(pos.copy()),
        impl="surrogate")
    for g, w in ((got, want), (ckv, jckv), (kr, jkr)):
        assert g.dtype == td
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)),
                                   rtol=TOL[dtype], atol=TOL[dtype])


def test_surrogate_prefill_matches_reference():
    """A surrogate-attention config's prefill logits (dense, f32)."""
    jcfg = _jcfg("qwen2-1.5b").replace(attention_impl="surrogate")
    cfg = case_config("qwen2-1.5b").replace(attention_impl="surrogate")
    jp = _weights(6, "qwen2-1.5b")
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 9))
    want, _ = JM.prefill(jcfg, jax.tree.map(jnp.asarray, jp),
                         jnp.asarray(tokens), JM.init_cache(jcfg, 2, 16))
    from repro_torch.models import model as TM
    got, _ = TM.prefill(cfg, params_from_numpy(jp, "cpu"),
                        torch.from_numpy(tokens),
                        TM.init_cache(cfg, 2, 16, "cpu"))
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()


# ----------------------------------------------------- the dry run itself
# a reduced config's cells: (name, kind, seq_len, global batch)
CELLS = {"train": ("t", "train", 32, 4), "prefill": ("p", "prefill", 32, 4),
         "decode": ("d", "decode", 32, 4)}
COUNT_ARCH = "phi3.5-moe-42b-a6.6b"        # attention, the MLP and moe_ep


def _count_case(kind):
    return dict(arch=COUNT_ARCH, cell=CELLS[kind], fsdp=kind == "decode",
                seed=9)


@pytest.fixture(scope="module")
def real_counts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun_counts")
    plan = {kind: _count_case(kind) for kind in CELLS}
    return spawn("2x2", ranks.dryrun_rank, plan, device="cpu",
                 timeout_s=SPAWN_S, store_dir=str(tmp))


@pytest.mark.parametrize("kind", list(CELLS))
def test_dryrun_counts_match_a_real_mesh(real_counts, kind):
    case = _count_case(kind)
    cfg = case_config(COUNT_ARCH)
    cell = SP.ShapeCell(*CELLS[kind])
    mesh = make_debug_mesh(2, 2)
    rules = ShardingRules(cfg, mesh, mode=kind, fsdp=case["fsdp"])
    got = DR.trace_cell(cfg, cell, mesh, rules)
    want = real_counts[0]["cells"][kind]
    assert real_counts[0]["rank"] == 0
    assert got["flops"] == want["flops"] > 0
    assert got["collective"] == want["collective"], kind
    assert got["collective"]["total"] > 0
    # the placeholder run is rank 0's: every rank issues the same bytes
    for r in real_counts[1:]:
        assert r["cells"][kind]["collective"] == want["collective"]


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_full_depth_is_the_calibration_line(kind):
    cfg = case_config("qwen2-1.5b").replace(num_layers=7)
    cell = SP.ShapeCell(*CELLS[kind])
    mesh = make_debug_mesh(2, 2)
    rules = ShardingRules(cfg, mesh, mode=kind)
    full = DR.trace_cell(cfg, cell, mesh, rules)
    lo, hi = DR.calibration(cfg, cell, mesh, fsdp=rules.fsdp,
                            expert_tp=False, microbatches=None)
    assert (lo["L"], hi["L"]) == DR.calibration_depths(cfg)
    for key, value in (("flops", full["flops"]), ("bytes", full["bytes"]),
                       ("coll_total", full["collective"]["total"])):
        slope = (hi[key] - lo[key]) / (hi["L"] - lo["L"])
        assert slope > 0, key
        assert lo[key] + slope * (cfg.num_layers - lo["L"]) == value, key


def test_production_decode_cell_fits(tmp_path):
    r = DR.run_cell("qwen2-1.5b", "decode_32k", out_dir=str(tmp_path),
                    verbose=False)
    assert r["status"] == "ok", r.get("error")
    saved = json.loads((tmp_path / "qwen2-1.5b_decode_32k_pod256.json")
                       .read_text())
    assert saved["status"] == "ok" and saved["chips"] == 256
    mem = saved["memory_analysis"]
    assert 0 < mem["argument_size_in_bytes"] <= mem["peak_memory_in_bytes"]
    assert mem["peak_memory_in_bytes"] <= 80e9 and saved["fits"]
    assert saved["dominant"] in ("compute", "memory", "collective")
    assert saved["flops_per_device"] > 0 and \
        saved["collective_bytes_per_device"]["total"] > 0
    assert len(saved["calibration"]) == 2
