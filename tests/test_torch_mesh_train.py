"""Training over a ('data', 'model') mesh against the JAX package, on
one spawned 2x2 mesh of gloo processes on the CPU (four ranks; the rank
bodies are in ``tests/torch_train_ranks.py``).

- The train step (``build_train_step(mesh=)``, ``mesh_step_grads``) on
  the reduced qwen3-4b (dense, 4/4 heads) and phi3.5-moe (E 4, top 2,
  capacity factor 1.25: tokens drop), with ``fsdp`` off and on,
  microbatches 1 and 2, remat on one case, AdamW, Adafactor on a moe
  case, ``bf16_grad_reduce`` on a dense case, and batch weights that
  differ between the data shards. Each is held to JAX's single-device
  ``build_train_step`` on the same weights and batch: the reference's
  meshed step runs under this JAX for the dense family at microbatches
  1 only, and on a mesh it computes the single-device numbers there
  (ROADMAP queue 3). The moe cases patch the slice-wise moe
  (``tests/jax_moe_slices.py``) into ``repro.models.moe.moe_apply``:
  ``moe_ep``'s routing, capacity and aux loss are each slice's. The
  loss within 1e-5 relative, every gradient leaf made whole
  (``full_leaf``) within ``GRAD_TOL`` of its largest |value| and every
  new parameter within ``PARAM_TOL`` (f32; the sums of the shards run
  in another order). AdamW runs at eps 1e-3 as in
  ``tests/test_torch_training.py``: its first step is about sign(g).
- Every rank's blocks: the leaves a rank holds whole are bit-equal on
  every rank that holds them, and each rank's parameter and state
  shapes (so its bytes) are the ``shard_shape`` of JAX's spec over an
  ``AbstractMesh``: no rank holds whole a leaf the rules shard.
- ``moe_ep`` alone at capacity factors 1.25 and 8 and with a shared
  expert, against JAX's ``moe_ep`` on a 2x2 mesh of forced host devices
  in a subprocess, within 2e-4 (the reference's tolerance); the same
  subprocess holds JAX's ``moe_ep`` to the slice-wise moe.
- The four ranks as a 1x4 mesh on the reduced qwen2-1.5b (4 query, 2
  KV heads: the query heads shard, the KV heads do not): logits, loss
  and gradients against JAX's.
- Checkpoints: saved on the mesh and restored on it, bit-equal; the
  same files restored on one device equal the leaves made whole; only
  rank 0 makes the full leaves on its host for the save; a
  checkpoint saved on one device restored onto the mesh, bit-equal to
  each rank's ``local_block``.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AbstractMesh

import torch_train_ranks as ranks
from jax_moe_slices import slicewise_moe
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.distributed.sharding import ShardingRules as JRules
from repro.models import init_params as j_init_params
from repro.models import model as JM
from repro.models import moe as jmoe
from repro.training import optimizer as jopt
from repro.training import train_loop as jtl
from repro.training.data import synthetic_batches as j_batches
from repro_torch.launch.mesh import spawn
from repro_torch.models.model import params_from_numpy
from repro_torch.training import checkpoint as tck
from repro_torch.training import optimizer as topt

ROOT = Path(__file__).resolve().parents[1]
SPAWN_S = 300
D, M = 2, 2
DENSE, MOE = "qwen3-4b", "phi3.5-moe-42b-a6.6b"
ADAM = dict(kind="adamw", lr=1e-3, eps=1e-3)
CF = dict(capacity_factor=1.25)
TRAIN = {
    "dense": dict(arch=DENSE, fsdp=False, opt=ADAM,
                  tc=dict(microbatches=1, remat=False)),
    "dense_fsdp_mb2_remat": dict(arch=DENSE, fsdp=True, opt=ADAM,
                                 tc=dict(microbatches=2, remat=True)),
    "dense_bf16_grads": dict(arch=DENSE, fsdp=False, opt=ADAM,
                             tc=dict(remat=False, bf16_grad_reduce=True)),
    "moe_fsdp": dict(arch=MOE, fsdp=True, opt=ADAM, moe=CF,
                     tc=dict(microbatches=1, remat=False)),
    "moe_mb2_adafactor": dict(arch=MOE, fsdp=False, moe=CF,
                              opt=dict(kind="adafactor", lr=1e-3),
                              tc=dict(microbatches=2, remat=False)),
}
MOE_EP = {"cf1.25": dict(capacity_factor=1.25),
          "cf8": dict(capacity_factor=8.0),
          "shared": dict(capacity_factor=1.25, num_shared_experts=1)}
GRAD_TOL, PARAM_TOL = 1e-4, 1e-5
BF16_GRAD_TOL = 2 ** -7       # the gradients rounded to bf16, twice


def _jcfg(arch, moe=None, **kw):
    cfg = j_reduced(j_get_config(arch), **kw)
    if moe:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe))
    return cfg


def _flat(tree, prefix="") -> dict:
    """A tree of nested dicts/lists -> {path: leaf}; JAX trees too."""
    if isinstance(tree, dict):
        return {k: v for n, t in tree.items()
                for k, v in _flat(t, f"{prefix}{n}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, t in enumerate(tree)
                for k, v in _flat(t, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tree}


def _weights(seed, arch, **kw):
    """JAX's initial weights (``kw``: ``reduced``'s sizes), every leaf
    moved off its init (norm scales off zero) so that each enters the
    gradients."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape))
        .astype(a.dtype), j_init_params(_jcfg(arch, **kw),
                                        jax.random.PRNGKey(0)))


def _batch(vocab, B, S, seed):
    """A synthetic batch whose weights differ from row to row (so between
    the data shards), some zero."""
    b = next(j_batches(vocab, B, S, seed=seed))
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.0, 2.0, (B, S)).astype(np.float32)
    w *= np.arange(1, B + 1, dtype=np.float32)[:, None]
    w[rng.random((B, S)) < 0.1] = 0.0
    return {**b, "weights": w}


def _jax_step(case, params, batch, grads_of):
    """JAX's single-device step (the slice-wise moe patched in for the
    moe cases): loss, mean gradients over the microbatches (kept in
    ``grads_of`` by arch and microbatch count: the same for the cases
    that differ in nothing else), new params and state."""
    cfg = _jcfg(case["arch"], case.get("moe"), **case.get("reduced", {}))
    jo, tc = jopt.OptConfig(**case["opt"]), jtl.TrainConfig(**case["tc"])
    with pytest.MonkeyPatch.context() as mp:
        if cfg.moe:
            mp.setattr(jmoe, "moe_apply", slicewise_moe(D, M))
        p2, s2, m = jax.jit(jtl.build_train_step(cfg, jo, tc))(
            params, jopt.opt_init(jo, params), batch)
        n = tc.microbatches
        if (case["arch"], n) not in grads_of:
            grad = jax.jit(jax.grad(lambda p, b: JM.loss_fn(cfg, p, b)[0]))
            gs = [grad(params, jax.tree.map(lambda a: np.split(a, n)[i],
                                            batch)) for i in range(n)]
            grads_of[case["arch"], n] = jax.tree.map(lambda *g: sum(g) / n,
                                                     *gs)
    grads = grads_of[case["arch"], n]
    return dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                grads=grads, params=p2, state=jax.eval_shape(lambda: s2),
                cfg=cfg)


MOE_SUBPROCESS = """
    import dataclasses, json, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax_moe_slices import slicewise_moe
    from repro.configs import get_config, reduced
    from repro.launch.mesh import mesh_context
    from repro.models import moe as jmoe
    inp = np.load(sys.argv[1])
    out, worst = {}, 0.0
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    for name, moe in json.loads(sys.argv[3]).items():
        cfg = reduced(get_config(sys.argv[4]))
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe))
        p = {k.split("/", 1)[1]: jnp.asarray(inp[k]) for k in inp.files
             if k.startswith(name + "/") and k != name + "/x"}
        if "shared/w_up" in p:
            p["shared"] = {k: p.pop("shared/" + k)
                           for k in ("w_gate", "w_up", "w_down")}
        x = jnp.asarray(inp[name + "/x"])
        with mesh_context(mesh):
            y, aux = jmoe.moe_ep(p, x, cfg, mesh)
        y2, aux2 = slicewise_moe(2, 2)(p, x, cfg)
        worst = max(worst, float(jnp.max(jnp.abs(y - y2))),
                    abs(float(aux) - float(aux2)))
        out[name + "/y"], out[name + "/aux"] = np.asarray(y), np.asarray(aux)
    np.savez(sys.argv[2], **out)
    print("SLICEWISE_WORST", worst)
"""


def _moe_inputs():
    """Per ``MOE_EP`` case: one layer's moe weights (JAX's init) and x
    [2, 33, d] (33 tokens a data rank: a padded slice)."""
    cases = {}
    for i, (name, moe) in enumerate(MOE_EP.items()):
        cfg = _jcfg(MOE, moe)
        p = jax.tree.map(np.asarray, jmoe.moe_init(
            jax.random.PRNGKey(i), cfg, jnp.float32))
        x = np.random.default_rng(i).standard_normal(
            (2, 33, cfg.d_model)).astype(np.float32)
        cases[name] = dict(moe=moe, params=p, x=x)
    return cases


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Everything at once: the JAX moe_ep subprocess started first, then
    the one 2x2 spawn, the JAX references while the ranks run, then the
    subprocess's result."""
    tmp = tmp_path_factory.mktemp("mesh_train")
    moe = _moe_inputs()
    np.savez(tmp / "moe_in.npz", **{
        f"{n}/{k}": v for n, c in moe.items()
        for k, v in {**_flat(c["params"]), "x": c["x"]}.items()})
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count"
               "=4", JAX_PLATFORMS="cpu",
               PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT / 'tests'}")
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(MOE_SUBPROCESS),
         str(tmp / "moe_in.npz"), str(tmp / "moe_out.npz"),
         json.dumps(MOE_EP), MOE], env=env,
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        weights = {a: _weights(7, a) for a in (DENSE, MOE)}
        batches = {a: _batch(_jcfg(a).vocab_size, 4, 64, seed=3)
                   for a in (DENSE, MOE)}
        train = {name: dict(case, params=weights[case["arch"]],
                            batch=batches[case["arch"]])
                 for name, case in TRAIN.items()}
        train["dense_fsdp_mb2_remat"]["ckpt"] = str(tmp / "mesh_ckpt")
        # a checkpoint written on one device, for the restore onto the mesh
        tp = params_from_numpy(weights[DENSE], "cpu")
        tck.save_checkpoint(str(tmp / "single"), 1, tp, topt.opt_init(
            topt.OptConfig(kind="adafactor"), tp))
        vcfg = _jcfg("qwen2-1.5b")
        view = dict(arch="qwen2-1.5b", params=_weights(5, "qwen2-1.5b"),
                    batch=_batch(vcfg.vocab_size, 2, 64, seed=4))
        plan = dict(train=train, moe=moe, view=view,
                    restore=dict(arch=DENSE, fsdp=True,
                                 dir=str(tmp / "single")))
        # the ranks run while this process computes JAX's references
        with ThreadPoolExecutor(1) as pool:
            ranks_done = pool.submit(
                spawn, f"{D}x{M}", ranks.mesh_rank, plan, device="cpu",
                timeout_s=SPAWN_S, store_dir=str(tmp))
            ref, grads_of = {}, {}
            for name, case in TRAIN.items():
                a = case["arch"]
                ref[name] = _jax_step(case, weights[a], batches[a], grads_of)
            vp, vb = view["params"], view["batch"]
            vlogits, _ = JM.forward(vcfg, vp, vb["tokens"])
            vloss, vgrads = jax.value_and_grad(
                lambda p: JM.loss_fn(vcfg, p, vb)[0])(vp)
            out = ranks_done.result()
        so, se = proc.communicate(timeout=SPAWN_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, se[-4000:]
    return dict(out=out, ref=ref, moe=moe, moe_jax=dict(np.load(
        tmp / "moe_out.npz")), moe_log=so, tmp=tmp,
        view=dict(logits=np.asarray(vlogits), loss=float(vloss),
                  grads=vgrads))


def _leaf_err(got, want) -> dict:
    """{path: max |got - want| over max |want|} of two trees."""
    g, w = _flat(got), _flat(jax.tree.map(np.asarray, want))
    assert set(g) == set(w), set(g) ^ set(w)
    return {k: float(np.max(np.abs(g[k] - w[k])) / max(
        float(np.max(np.abs(w[k]))), 1e-30)) for k in w}


def _worst(errs: dict) -> tuple:
    k = max(errs, key=errs.get)
    return errs[k], k


@pytest.mark.parametrize("name", list(TRAIN))
def test_train_step_matches_jax_single_device(run, name):
    outs, ref = [o["train"][name] for o in run["out"]], run["ref"][name]
    losses = {o["loss"] for o in outs} | {o["step_loss"] for o in outs}
    assert len(losses) == 1, losses            # one loss on every rank
    loss = losses.pop()
    assert abs(loss - ref["loss"]) <= 1e-5 * abs(ref["loss"]), \
        (loss, ref["loss"])
    assert len({o["grad_norm"] for o in outs}) == 1
    bf16 = TRAIN[name]["tc"].get("bf16_grad_reduce")
    np.testing.assert_allclose(outs[0]["grad_norm"], ref["grad_norm"],
                               rtol=BF16_GRAD_TOL if bf16 else 1e-5)
    err, leaf = _worst(_leaf_err(outs[0]["grads"], ref["grads"]))
    assert err <= (BF16_GRAD_TOL if bf16 else GRAD_TOL), (leaf, err)
    if not bf16:
        err, leaf = _worst(_leaf_err(outs[0]["params"], ref["params"]))
        assert err <= PARAM_TOL, (leaf, err)
        return
    # AdamW's first step moves a weight by lr * gs / (|gs| + eps) (g the
    # gradient, s the clip scale): at most lr / eps times the change of
    # gs, which the bf16 gradients bound
    s_got, s_want = (min(1.0, 1.0 / n) for n in (outs[0]["grad_norm"],
                                                 ref["grad_norm"]))
    got_g, want_g = _flat(outs[0]["grads"]), _flat(
        jax.tree.map(np.asarray, ref["grads"]))
    got_p, want_p = _flat(outs[0]["params"]), _flat(
        jax.tree.map(np.asarray, ref["params"]))
    for k in want_p:
        bound = ADAM["lr"] / ADAM["eps"] * (
            s_got * np.abs(got_g[k] - want_g[k])
            + abs(s_got - s_want) * np.abs(want_g[k])) \
            + PARAM_TOL * np.max(np.abs(want_p[k]))
        assert np.all(np.abs(got_p[k] - want_p[k]) <= bound), k


@pytest.mark.parametrize("name", list(TRAIN))
def test_rank_blocks_are_the_rules_shards(run, name):
    """Each rank's parameter and state blocks have the shard shapes of
    JAX's specs (so its bytes are the shards' bytes), and a leaf's
    blocks are bit-equal on every rank at the same place on the axes
    its spec names (a leaf held whole: on every rank)."""
    check_rank_blocks(run["out"], run["ref"][name], TRAIN[name], name)


def check_rank_blocks(outs, ref, case, name):
    """``test_rank_blocks_are_the_rules_shards`` of the train case
    ``name``: ``outs`` the ranks' results, ``ref`` JAX's step."""
    amesh = AbstractMesh((D, M), ("data", "model"))
    jr = JRules(ref["cfg"], amesh, fsdp=case["fsdp"])
    shapes = {"params": jax.eval_shape(lambda: ref["params"]),
              "state": ref["state"]}
    specs = {"params": jr.params(shapes["params"]),
             "state": jr.opt_state(shapes["state"])}
    for part, key in (("params", "local_params"), ("state", "local_state")):
        sds, sh = _flat(shapes[part]), _flat(specs[part])
        for r, o in enumerate(outs):
            local = _flat(o["train"][name][key])
            assert set(local) == set(sds), set(local) ^ set(sds)
            want = sum(int(np.prod(sh[k].shard_shape(sds[k].shape)))
                       * sds[k].dtype.itemsize for k in sds)
            got = sum(local[k].size * sds[k].dtype.itemsize for k in sds)
            assert got == want, (r, part, got, want)
            for k in sds:
                assert local[k].shape == sh[k].shard_shape(sds[k].shape), \
                    (r, k, local[k].shape)
        for k in sds:
            axes = {a for e in sh[k].spec if e is not None
                    for a in ((e,) if isinstance(e, str) else e)}
            held = {}
            for o in outs:
                place = tuple(o["coord"][a] for a in sorted(axes))
                blk = _flat(o["train"][name][key])[k]
                if place in held:
                    assert np.array_equal(held[place], blk) and \
                        held[place].tobytes() == blk.tobytes(), (part, k)
                held[place] = blk


@pytest.mark.parametrize("name", list(MOE_EP))
def test_moe_ep_matches_jax(run, name):
    """Each data rank's rows of y from model rank 0 (every model rank
    holds the same), against JAX's ``moe_ep``; the aux loss on every
    rank."""
    outs = run["out"]
    ys = {}
    for o in outs:
        got = o["moe"][name]
        ys.setdefault(o["coord"]["data"], []).append(got["y"])
        np.testing.assert_allclose(got["aux"], run["moe_jax"][name + "/aux"],
                                   rtol=2e-4, atol=2e-4)
    for rows in ys.values():
        for y in rows[1:]:
            assert np.array_equal(y, rows[0])
    y = np.concatenate([ys[d][0] for d in sorted(ys)])
    np.testing.assert_allclose(y, run["moe_jax"][name + "/y"], rtol=2e-4,
                               atol=2e-4)


def test_jax_moe_ep_is_the_slicewise_moe(run):
    """The reference the moe train steps are held to: JAX's ``moe_ep`` on
    the 2x2 mesh equals ``moe_local`` on each (data shard, model slice),
    the aux losses averaged."""
    worst = float(run["moe_log"].split("SLICEWISE_WORST")[1].split()[0])
    assert worst <= 2e-4, worst


def test_replicated_kv_view_matches_jax(run):
    """The 1x4 view: the 4 query heads shard, one a rank; the 2 KV heads
    stay whole and each rank attends with its query head's."""
    v = run["view"]
    for o in run["out"]:
        got = o["view"]
        assert got["sharded_q"] and got["replicated_kv"]
        scale = np.max(np.abs(v["logits"]))
        assert np.max(np.abs(got["logits"] - v["logits"])) <= 1e-5 * scale
        assert abs(got["loss"] - v["loss"]) <= 1e-5 * abs(v["loss"])
    err, leaf = _worst(_leaf_err(run["out"][0]["view"]["grads"], v["grads"]))
    assert err <= GRAD_TOL, (leaf, err)


def test_checkpoint_saved_on_mesh_restores_on_mesh_and_one_device(run):
    outs = [o["train"]["dense_fsdp_mb2_remat"] for o in run["out"]]
    assert all(o["ckpt_same"] for o in outs)
    tree, step = tck.restore_checkpoint(str(run["tmp"] / "mesh_ckpt"))
    assert step == 1
    got = _flat({"params": tree["params"], "opt_state": tree["opt_state"]})
    want = _flat({"params": outs[0]["params"], "opt_state": outs[0]["state"]})
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k].numpy(), want[k]), k


def test_checkpoint_saved_on_mesh_holds_full_leaves_on_rank_0_only(run):
    """A save on the mesh makes every full leaf on rank 0's host, which
    writes them, and none on the other ranks."""
    outs = [o["train"]["dense_fsdp_mb2_remat"] for o in run["out"]]
    assert outs[0]["host_full"] == outs[0]["ckpt_leaves"] > 0
    assert [o["host_full"] for o in outs[1:]] == [0] * (len(outs) - 1)


def test_checkpoint_saved_on_one_device_restores_onto_mesh(run):
    assert all(o["restore"] for o in run["out"])
