"""Training over a ('data', 'model') mesh for the vlm, ssm, hybrid,
encdec and mla families, ``compressed_psum`` and ``elastic_rescale``,
against the JAX package, on one spawned 2x2 mesh of gloo processes on
the CPU (the rank bodies are in ``tests/torch_family_ranks.py``).

- The train step (``build_train_step(mesh=)``, ``mesh_step_grads``) on
  the reduced paligemma-3b (patches under the prefix-LM mask, the
  embedding over vocabulary, MQA), mamba2-1.3b (microbatches 2 and
  remat), recurrentgemma-9b (FSDP; the RG-LRU's gate blocks over
  'model'), whisper-tiny (a vocabulary of 251 that 'model' does not
  divide; the encoder, cross-attention, the gelu MLP's output bias)
  and deepseek-v2-236b (FSDP, Adafactor, mla over heads, the dense
  layer 0 and a moe layer, with ``tests/jax_moe_slices.py`` patched
  into the reference as in ``tests/test_torch_mesh_train.py``). Each
  is held to JAX's single-device ``build_train_step`` on the same
  weights and batch: the loss within 1e-5 relative, every gradient
  leaf made whole within 1e-4 of its largest |value|, every new
  parameter within 1e-5 (f32). JAX's meshed step does not run for
  these families under this JAX (ROADMAP queue 3).
- Every rank's blocks have JAX's ``shard_shape`` over an
  ``AbstractMesh``, and each family's own leaves are sharded over
  'model', so that no case passes by replication.
- The mamba2 mixer's gated norm over a ``d_in`` sharded over 'model'
  alone: its gradients equal one device's with the sum of squares
  taken by ``sum_over_model``, and differ with Megatron's
  ``reduce_from_model`` (an identity backward), whose output is the
  same.
- ``compressed_psum`` over 'data', two rounds with the error feedback,
  against the reference's on a 2x2 mesh of forced host devices in a
  subprocess: the mean and the errors within 1e-6 of their largest
  |value|, the mean within 0.02 of the exact mean's, ``wire_bytes``
  equal.
- ``elastic_rescale`` of the deepseek case's checkpoint, saved on the
  2x2 mesh, onto a 1x4 view of the same ranks: bit-equal to each
  rank's ``local_block`` of the saved leaves.
"""
import os
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import torch_family_ranks as ranks
from repro.distributed.sharding import ShardingRules as JRules
from repro_torch.launch.mesh import spawn
from repro_torch.models import layers as TL
from test_torch_mesh_train import (D, GRAD_TOL, M, PARAM_TOL, _batch, _flat,
                                   _jax_step, _jcfg, _leaf_err, _weights,
                                   _worst, check_rank_blocks)

ROOT = Path(__file__).resolve().parents[1]
SPAWN_S = 300
ADAM = dict(kind="adamw", lr=1e-3, eps=1e-3)
ONE = dict(microbatches=1, remat=False)
TRAIN = {
    "vlm": dict(arch="paligemma-3b", fsdp=False, opt=ADAM, tc=ONE),
    "ssm_mb2_remat": dict(arch="mamba2-1.3b", fsdp=False, opt=ADAM,
                          tc=dict(microbatches=2, remat=True)),
    "hybrid_fsdp": dict(arch="recurrentgemma-9b", fsdp=True, opt=ADAM,
                        tc=ONE),
    "encdec": dict(arch="whisper-tiny", fsdp=False, opt=ADAM, tc=ONE,
                   reduced=dict(vocab=251)),
    "mla_fsdp_adafactor": dict(arch="deepseek-v2-236b", fsdp=True,
                               opt=dict(kind="adafactor", lr=1e-3),
                               tc=ONE),
}
# each family's own leaves, which the reduced config must shard over
# 'model' (path in the flat tree, dim)
OWN = {"vlm": [("embed", 0), ("layers/attn/wq", 2)],
       "ssm_mb2_remat": [("layers/mixer/w_x", 2), ("layers/mixer/w_dt", 2),
                         ("layers/mixer/norm", 1)],
       "hybrid_fsdp": [("layers/0/rec/in_rec", 1), ("layers/0/rec/w_x", 0),
                       ("layers/2/attn/wq", 1)],
       "encdec": [("layers/xattn/wq", 2), ("encoder/layers/attn/wq", 2),
                  ("layers/mlp/b_up", 1)],
       "mla_fsdp_adafactor": [("layers/attn/w_uq", 2),
                              ("layers/attn/w_uk", 2),
                              ("layers_pre/0/attn/w_uv", 1),
                              ("layers/moe/w_up", 1)]}
REPLICATED = {"encdec": ["embed", "layers/mlp/b_down"],
              "mla_fsdp_adafactor": ["layers/attn/kv_norm",
                                     "layers/attn/q_norm"],
              "ssm_mb2_remat": ["layers/mixer/w_B", "layers/mixer/conv_bc"]}
MEAN_TOL, EXACT_TOL = 1e-6, 0.02

COMPRESS_SUBPROCESS = """
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.distributed.compression import compressed_psum, wire_bytes
    inp = np.load(sys.argv[1])
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    out, errors = {}, None
    for i in range(2):
        g = {k.split("/", 1)[1]: jnp.asarray(inp[k]) for k in inp.files
             if k.startswith(f"{i}/")}
        mean, errors = compressed_psum(g, mesh, "data", errors)
        out.update({f"{i}/mean/{k}": np.asarray(v) for k, v in mean.items()})
        out.update({f"{i}/err/{k}": np.asarray(v)
                    for k, v in errors.items()})
    out["wire_bytes"] = np.asarray(wire_bytes(g))
    np.savez(sys.argv[2], **out)
"""


def _family_batch(cfg, seed):
    """``_batch`` with the vlm's patches and ``prefix_len`` and the
    encdec's frames."""
    b = _batch(cfg.vocab_size, 4, 64, seed)
    rng = np.random.default_rng(seed + 1)
    if cfg.frontend == "vision":
        b["patches"] = rng.standard_normal(
            (4, cfg.frontend_len, cfg.d_model)).astype(np.float32)
        b["prefix_len"] = np.array([8, 3, 0, 5], np.int32)
    if cfg.family == "encdec":
        b["frames"] = rng.standard_normal(
            (4, cfg.encoder.num_frames, cfg.d_model)).astype(np.float32)
    return b


def _compress_inputs():
    """Two rounds of stacked [2, ...] gradient trees: a leaf that pads
    its last block, one under a block, a zero leaf, one of two blocks."""
    rng = np.random.default_rng(11)
    shapes = {"a": (300,), "b": (4, 5), "z": (256,), "w": (2, 256)}
    return [{k: (rng.standard_normal((2,) + s) * (0 if k == "z" else 3.0))
             .astype(np.float32) for k, s in shapes.items()}
            for _ in range(2)]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX compression subprocess started first, then the one 2x2
    spawn, JAX's single-device steps while the ranks run, then the
    subprocess's result."""
    tmp = tmp_path_factory.mktemp("mesh_families")
    rounds = _compress_inputs()
    np.savez(tmp / "compress_in.npz", **{
        f"{i}/{k}": v for i, g in enumerate(rounds) for k, v in g.items()})
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count"
               "=4", JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(COMPRESS_SUBPROCESS),
         str(tmp / "compress_in.npz"), str(tmp / "compress_out.npz")],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        train = {}
        for name, case in TRAIN.items():
            kw = case.get("reduced", {})
            cfg = _jcfg(case["arch"], **kw)
            train[name] = dict(case, params=_weights(7, case["arch"], **kw),
                               batch=_family_batch(cfg, 3))
        train["mla_fsdp_adafactor"]["ckpt"] = str(tmp / "mesh_ckpt")
        rng = np.random.default_rng(5)
        norm = {"x": rng.standard_normal((2, 5, 12)).astype(np.float32),
                "w": rng.standard_normal(12).astype(np.float32),
                "r": rng.standard_normal((2, 5, 12)).astype(np.float32)}
        plan = dict(train=train, norm=norm, compress=dict(rounds=rounds),
                    rescale=dict(arch="deepseek-v2-236b",
                                 dir=str(tmp / "mesh_ckpt")))
        with ThreadPoolExecutor(1) as pool:
            ranks_done = pool.submit(
                spawn, f"{D}x{M}", ranks.family_rank, plan, device="cpu",
                timeout_s=SPAWN_S, store_dir=str(tmp))
            ref, grads_of = {}, {}
            for name, case in TRAIN.items():
                ref[name] = _jax_step(case, train[name]["params"],
                                      train[name]["batch"], grads_of)
            out = ranks_done.result()
        _, se = proc.communicate(timeout=SPAWN_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, se[-4000:]
    return dict(out=out, ref=ref, norm=norm, rounds=rounds,
                compress=dict(np.load(tmp / "compress_out.npz")))


@pytest.mark.parametrize("name", list(TRAIN))
def test_family_train_step_matches_jax_single_device(run, name):
    outs, ref = [o["train"][name] for o in run["out"]], run["ref"][name]
    losses = {o["loss"] for o in outs} | {o["step_loss"] for o in outs}
    assert len(losses) == 1, losses            # one loss on every rank
    loss = losses.pop()
    assert abs(loss - ref["loss"]) <= 1e-5 * abs(ref["loss"]), \
        (loss, ref["loss"])
    assert len({o["grad_norm"] for o in outs}) == 1
    np.testing.assert_allclose(outs[0]["grad_norm"], ref["grad_norm"],
                               rtol=1e-5)
    err, leaf = _worst(_leaf_err(outs[0]["grads"], ref["grads"]))
    assert err <= GRAD_TOL, (leaf, err)
    err, leaf = _worst(_leaf_err(outs[0]["params"], ref["params"]))
    assert err <= PARAM_TOL, (leaf, err)


@pytest.mark.parametrize("name", list(TRAIN))
def test_family_rank_blocks_are_the_rules_shards(run, name):
    check_rank_blocks(run["out"], run["ref"][name], TRAIN[name], name)


@pytest.mark.parametrize("name", list(TRAIN))
def test_family_leaves_shard_over_model(run, name):
    """The family's own leaves are sharded over 'model' by JAX's rules,
    and each rank holds 1/M of the dim (the layers' stacked dim
    first); the ones the rules hold whole are whole on every rank."""
    ref = run["ref"][name]
    jr = JRules(ref["cfg"], AbstractMesh((D, M), ("data", "model")),
                fsdp=TRAIN[name]["fsdp"])
    specs = _flat(jr.params(jax.eval_shape(lambda: ref["params"])))
    full = _flat(jax.tree.map(np.asarray, ref["params"]))
    for o in run["out"]:
        local = _flat(o["train"][name]["local_params"])
        for path, dim in OWN[name]:
            assert specs[path].spec[dim] == "model", (path, specs[path])
            assert local[path].shape[dim] * M == full[path].shape[dim], path
        for path in REPLICATED.get(name, []):
            assert "model" not in {a for e in specs[path].spec if e
                                   for a in ((e,) if isinstance(e, str)
                                             else e)}, path
            assert local[path].shape == full[path].shape, path


def test_ssm_norm_backward_sums_over_model(run):
    n = run["norm"]
    x, w, r = (torch.from_numpy(n[k]) for k in ("x", "w", "r"))
    x.requires_grad_()
    w.requires_grad_()
    y = TL.rms_norm(x, w, 1e-6)
    gx, gw = torch.autograd.grad((y * r).sum(), (x, w))
    k = x.shape[-1] // M
    got = {}
    for o in run["out"]:
        i = o["coord"]["model"]
        for kind, v in o["norm"].items():
            cut = slice(i * k, (i + 1) * k)
            np.testing.assert_allclose(v["y"], y.detach().numpy()[..., cut],
                                       rtol=1e-6, atol=1e-6)
            # the weight's gradient is a sum over the batch: each data
            # rank holds the same rows here
            got.setdefault(kind, {}).update(
                {(i, "gx"): np.abs(v["gx"] - gx.numpy()[..., cut]).max(),
                 (i, "gw"): np.abs(v["gw"] - gw.numpy()[cut]).max()})
    assert max(got["sum"].values()) <= 1e-5 * float(gx.abs().max()), \
        got["sum"]
    assert max(got["reduce"].values()) > 1e-2 * float(gx.abs().max()), \
        got["reduce"]


@pytest.mark.parametrize("rnd", [0, 1])
def test_compressed_psum_matches_jax(run, rnd):
    ref, rounds = run["compress"], run["rounds"]
    exact = {k: v.mean(axis=0) for k, v in rounds[rnd].items()}
    for o in run["out"]:
        got = o["compress"][rnd]
        row = o["coord"]["data"]
        for k in exact:
            want = ref[f"{rnd}/mean/{k}"]
            scale = max(float(np.abs(want).max()), 1e-30)
            assert np.abs(got["mean"][k] - want).max() <= MEAN_TOL * scale, k
            err = ref[f"{rnd}/err/{k}"][row]
            escale = max(float(np.abs(err).max()), 1e-30)
            assert np.abs(got["err"][k] - err).max() <= MEAN_TOL * escale, k
            if rnd == 0:         # the first round's mean is the exact one's
                top = max(float(np.abs(exact[k]).max()), 1e-30)
                assert np.abs(got["mean"][k] - exact[k]).max() <= \
                    EXACT_TOL * top, k
        assert o["compress"]["wire_bytes"] == int(ref["wire_bytes"])


def test_elastic_rescale_onto_a_1x4_view(run):
    for o in run["out"]:
        r = o["rescale"]
        assert r["step"] == 1 and r["model"] == 4 and r["same"], r
        assert 0 < r["sharded"] < r["leaves"], r
