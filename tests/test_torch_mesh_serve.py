"""Serving over a ('data', 'model') mesh against the JAX package, on one
spawned 2x2 mesh of gloo processes on the CPU (the rank bodies are in
``tests/torch_serve_ranks.py``).

- ``prefill(mesh=)`` then four ``decode_step(mesh=)`` for every family
  (dense, a padded batch, a sliding window whose ring wraps, moe, vlm
  with its patches under the prefix-LM mask, mla, ssm, hybrid with a
  wrapping local ring, encdec) on 1x2, data rank 0's 'model' group of
  the 2x2 mesh; dense also on 2x2, with
  the batch over 'data', and with ``fsdp=True`` in the decode layout
  (``decode_2d``: the batch replicated, the weights over both axes,
  the ring over both axes). Each is held to the JAX package's
  single-device ``prefill``/``decode_step`` on the same weights and
  inputs, the moe layers the slice-wise moe of
  ``tests/jax_moe_slices.py`` (what the reference's ``moe_ep`` computes
  on the mesh), in f32: every step's logits within 1e-4 of their
  largest magnitude, and each rank's block of the cache after the last
  step equal to its block of JAX's cache under the port's
  ``ShardingRules.cache`` within 1e-5.
- ``moe_apply(expert_tp=True)`` on 2x2 (experts over 'model', ``d_ff``
  over 'data') over the whole batch against the slice-wise JAX moe of
  one data shard and two model slices, within 2e-4, the aux loss too;
  each rank holds E/M experts and f/D of their ``d_ff``.
"""
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_serve_ranks as ranks
from jax_moe_slices import slicewise_moe
from repro.models import model as JM
from repro.models import moe as jmoe
from repro_torch.distributed.sharding import MeshShape, ShardingRules, \
    tree_local
from repro_torch.launch.mesh import spawn
from test_torch_mesh_train import _jcfg, _weights
from torch_train_ranks import case_config

SPAWN_S = 300
LOGIT_TOL, CACHE_TOL, MOE_TOL = 1e-4, 1e-5, 2e-4
B, STEPS = 2, 4
# name: arch, mesh, text length S, ring capacity, fsdp, rules' mode, extras
CASES = {
    "dense": ("qwen2-1.5b", "1x2", 12, 20, False, "prefill", {}),
    "dense_padded": ("qwen2-1.5b", "1x2", 12, 16, False, "prefill",
                     {"seq_lens": [12, 9]}),
    "swa_wrap": ("h2o-danube-1.8b", "1x2", 20, 24, False, "prefill", {}),
    "moe": ("phi3.5-moe-42b-a6.6b", "1x2", 12, 16, False, "prefill", {}),
    "vlm": ("paligemma-3b", "1x2", 12, 24, False, "prefill",
            {"prefix_len": [8, 3]}),
    "mla": ("deepseek-v2-236b", "1x2", 12, 16, False, "prefill", {}),
    "ssm": ("mamba2-1.3b", "1x2", 12, 16, False, "prefill", {}),
    "hybrid": ("recurrentgemma-9b", "1x2", 20, 24, False, "prefill", {}),
    "encdec": ("whisper-tiny", "1x2", 12, 16, False, "prefill", {}),
    "dense_2x2": ("qwen2-1.5b", "2x2", 12, 16, False, "prefill", {}),
    "dense_2x2_fsdp_decode2d": ("qwen2-1.5b", "2x2", 12, 16, True,
                                "decode", {}),
}
MOE_ARCH = "phi3.5-moe-42b-a6.6b"


def _case(name, seed):
    arch, mesh, S, cap, fsdp, mode, extra = CASES[name]
    cfg = _jcfg(arch)
    rng = np.random.default_rng(seed)
    case = dict(arch=arch, mesh=mesh, capacity=cap, fsdp=fsdp, mode=mode,
                params=_weights(seed, arch),
                tokens=rng.integers(0, cfg.vocab_size, (B, S)).astype(
                    np.int32),
                steps=[rng.integers(0, cfg.vocab_size, (B,)).astype(np.int32)
                       for _ in range(STEPS)])
    for k, v in extra.items():
        case[k] = np.asarray(v, np.int32)
    if cfg.frontend == "vision":
        case["frontend_embeds"] = rng.standard_normal(
            (B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        case["enc_frames"] = rng.standard_normal(
            (B, cfg.encoder.num_frames, cfg.d_model)).astype(np.float32)
    return case


def _jax_serve(case):
    """JAX's single-device prefill and decode steps: every step's logits
    and the cache after the last, as numpy."""
    cfg = _jcfg(case["arch"])
    jp = jax.tree.map(jnp.asarray, case["params"])
    enc = 0 if "enc_frames" not in case else case["enc_frames"].shape[1]
    cache = JM.init_cache(cfg, B, case["capacity"], enc_frames=enc)
    kw = {k: jnp.asarray(case[k]) for k in ("seq_lens", "prefix_len",
                                            "frontend_embeds", "enc_frames")
          if k in case}
    prefill = jax.jit(lambda p, t, c, kw: JM.prefill(cfg, p, t, c, **kw))
    decode = jax.jit(lambda p, t, c: JM.decode_step(cfg, p, t, c))
    out, cache = prefill(jp, jnp.asarray(case["tokens"]), cache, kw)
    logits = [np.asarray(out)]
    for tok in case["steps"]:
        out, cache = decode(jp, jnp.asarray(tok), cache)
        logits.append(np.asarray(out))
    return logits, jax.tree.map(np.asarray, cache)


def _expert_tp_case(seed):
    cfg = _jcfg(MOE_ARCH)
    rng = np.random.default_rng(seed)
    return dict(arch=MOE_ARCH, params=_weights(seed, MOE_ARCH),
                x=rng.standard_normal((B, 6, cfg.d_model)).astype(
                    np.float32))


class _Rank:
    """A rank's place on a D x M mesh, for ``local_block``."""

    def __init__(self, d, m, D, M):
        self.shape = {"data": D, "model": M}
        self.axis_names = ("data", "model")
        self._c = {"data": d, "model": m}

    def coord(self, axis):
        return self._c[axis]


@pytest.fixture(scope="module")
def run(tmp_path_factory, monkeypatch_module):
    tmp = tmp_path_factory.mktemp("mesh_serve")
    plan = {"serve": {n: _case(n, i) for i, n in enumerate(CASES)},
            "expert_tp": _expert_tp_case(40)}
    with ThreadPoolExecutor(1) as pool:
        done = pool.submit(spawn, "2x2", ranks.serve_rank, plan,
                           device="cpu", timeout_s=SPAWN_S,
                           store_dir=str(tmp))
        ref = {}
        for name, case in plan["serve"].items():
            D = 2 if case["mesh"] == "2x2" and not case["fsdp"] else 1
            monkeypatch_module.setattr(jmoe, "moe_apply", slicewise_moe(D, 2))
            ref[name] = _jax_serve(case)
        # expert_tp: the whole batch in M = 2 slices, one data shard
        e = plan["expert_tp"]
        jcfg = _jcfg(MOE_ARCH)
        lp = jax.tree.map(lambda a: jnp.asarray(a[-1]),
                          e["params"]["layers"]["moe"])
        monkeypatch_module.undo()
        y, aux = slicewise_moe(1, 2)(lp, jnp.asarray(e["x"]), jcfg)
        ref["expert_tp"] = (np.asarray(y), float(aux))
        out = done.result()
    return dict(out=out, ref=ref, plan=plan)


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def _ranks_of(out, case):
    """(rank output, its (d, m, D, M)) for every rank that ran the case
    (a 1x2 case: data rank 0's two)."""
    ran = [o["serve"] for o in out if case in o["serve"]]
    assert len(ran) == (2 if CASES[case][1] == "1x2" else 4), case
    for r in ran:
        c = r[case]["coord"]
        if CASES[case][1] == "1x2":
            yield r[case], (0, c["model"], 1, 2)
        else:
            yield r[case], (c["data"], c["model"], 2, 2)


@pytest.mark.parametrize("name", list(CASES))
def test_meshed_serving_logits_match_jax(run, name):
    want, _ = run["ref"][name]
    cfg = case_config(CASES[name][0])
    for got, (d, m, D, M) in _ranks_of(run["out"], name):
        rules = ShardingRules(cfg, MeshShape({"data": D, "model": M}),
                              mode=CASES[name][5], fsdp=CASES[name][4])
        rows = tree_local({"r": torch.arange(B)},
                          {"r": rules.cache({"len": torch.empty(B)})["len"]},
                          _Rank(d, m, D, M))["r"].numpy()
        assert len(got["logits"]) == STEPS + 1
        for step, (g, w) in enumerate(zip(got["logits"], want)):
            w = w[rows]
            err = np.abs(g - w).max() / np.abs(w).max()
            assert err <= LOGIT_TOL, (name, (d, m), step, err)


@pytest.mark.parametrize("name", list(CASES))
def test_meshed_serving_cache_blocks_match_jax(run, name):
    _, want = run["ref"][name]
    cfg = case_config(CASES[name][0])
    full = {k: torch.from_numpy(np.array(v)) for k, v in want.items()}
    split = set()
    for got, (d, m, D, M) in _ranks_of(run["out"], name):
        rules = ShardingRules(cfg, MeshShape({"data": D, "model": M}),
                              mode=CASES[name][5], fsdp=CASES[name][4])
        block = tree_local(full, rules.cache(full), _Rank(d, m, D, M))
        assert set(got["cache"]) == set(block)
        for k, w in block.items():
            g = got["cache"][k]
            assert g.shape == tuple(w.shape), (name, k, g.shape, w.shape)
            if g.shape != tuple(full[k].shape):
                split.add(k)
            np.testing.assert_allclose(g, w.numpy(), rtol=0, atol=CACHE_TOL,
                                       err_msg=f"{name} {k} at {(d, m)}")
    # every case splits some of its cache: the ring, the state or both
    assert split, name


def test_expert_tp_matches_slicewise_jax(run):
    y, aux = run["ref"]["expert_tp"]
    cfg = case_config(MOE_ARCH)
    E, f = cfg.moe.num_experts, cfg.moe.d_ff_expert
    for o in run["out"]:
        e = o["expert_tp"]
        err = np.abs(e["y"] - y).max() / np.abs(y).max()
        assert err <= MOE_TOL, (o["rank"], err)
        assert abs(e["aux"] - aux) <= MOE_TOL * abs(aux), (e["aux"], aux)
        # E / M experts a rank, each with f / D of its d_ff
        assert e["shapes"]["w_up"] == (E // 2, cfg.d_model, f // 2)
        assert e["shapes"]["w_down"] == (E // 2, f // 2, cfg.d_model)
        assert e["shapes"]["router"] == (cfg.d_model, E)
