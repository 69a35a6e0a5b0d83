"""The port's single-device training against the JAX package's:

- the training graph of deepseek-v2 and recurrentgemma (the check of
  ``tests/test_torch_train_forward.py``, split off to balance the
  files);
- one AdamW and one Adafactor update (two steps each, so the bias
  corrections and ``beta2`` move) on the same gradients, over a tree
  with stacked 1-D leaves ``[L, d]`` (weight decay applies to them),
  a factored stacked shape and an unfactored one, a list, in f32 and
  with bf16 parameters: the grad norm and moments within 1e-5 and the
  master within 1e-6 of each leaf's largest |value| (the global norm
  and the means sum in another order, ~2e-6 relative), bf16 parameters
  within one bf16 ulp;
- ``build_train_step`` at microbatches 1 and 2 and with
  ``bf16_grad_reduce`` on the reduced qwen2 (f32): loss, grad norm and
  every updated parameter; a 3-step ``train_loop`` history;
- ``synthetic_batches``, array for array;
- checkpoints: the roundtrip, async saves with ``keep_last``, a
  ``.tmp`` directory never read (the reference's
  ``tests/test_distributed.py`` cases), an f32 checkpoint written by
  the JAX package restored here and one written here restored there,
  and the reference's bf16 fault: its own restore gives 2-byte voids,
  the port restores the same bits as bf16 and writes the same bytes;
- ``run_resilient``; the launcher on the CPU with ``--resume``, and its
  default device raising without a GPU (its ``--mesh`` and
  ``--distributed``: ``tests/test_torch_mesh_launch.py``).
"""
import os
import threading

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import init_params as j_init_params
from repro.training import checkpoint as jck
from repro.training import optimizer as jopt
from repro.training import train_loop as jtl
from repro.training.data import synthetic_batches as j_batches
from repro_torch.configs import get_config, reduced
from repro_torch.distributed.fault_tolerance import run_resilient
from repro_torch.launch import train as launch_train
from repro_torch.models import model as TM
from repro_torch.training import checkpoint as tck
from repro_torch.training import optimizer as topt
from repro_torch.training import train_loop as ttl
from repro_torch.training.data import synthetic_batches
from repro_torch.training.optimizer import tree_leaves
from test_torch_train_forward import HEAVY, check_training_graph

BF16 = ml_dtypes.bfloat16


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy() if t.dtype == torch.bfloat16 \
            else t.numpy()
    return np.asarray(t, np.float32) if np.asarray(t).dtype == BF16 \
        else np.asarray(t)


def _tree_close(got, want, rel, elementwise=False):
    """Leaf by leaf (in JAX's key order): the largest |error| within
    ``rel`` of the leaf's largest |value|, or each element within ``rel``
    of its own (``elementwise``)."""
    g, w = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        a, b = _np(a), _np(b)
        assert a.shape == b.shape
        if elementwise:
            np.testing.assert_allclose(a, b, rtol=rel, atol=0)
        else:
            assert np.abs(a - b).max() <= rel * np.abs(b).max(), \
                (np.abs(a - b).max(), np.abs(b).max())


@pytest.mark.parametrize("name", HEAVY)
def test_forward_loss_and_grads_match_reference(name):
    """The training graph of the two families slowest to compile (mla
    with moe and a leading dense layer; the hybrid), as
    ``tests/test_torch_train_forward.py`` holds the others."""
    check_training_graph(name)


# ------------------------------------------------------------- optimizers
def _opt_tree(rng, dtype):
    """Stacked 1-D leaves [L, d], a factored [L, 96, 80], an unfactored
    [3, 50] and a 1-D leaf, under a dict and a list."""
    def a(*shape):
        return rng.standard_normal(shape).astype(dtype)
    return {"layers": {"ln1": a(4, 70), "w": a(4, 96, 80)},
            "blocks": [{"u": a(3, 50)}, {"b": a(7)}],
            "final_norm": a(70)}


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
@pytest.mark.parametrize("dtype", [np.float32, BF16])
def test_optimizer_update_matches_reference(kind, dtype):
    rng = np.random.default_rng(0)
    jp = _opt_tree(rng, dtype)
    opt_j = jopt.OptConfig(kind=kind, lr=1e-2, grad_clip=50.0)
    opt_t = topt.OptConfig(kind=kind, lr=1e-2, grad_clip=50.0)
    js = jopt.opt_init(opt_j, jp)
    tp = TM.params_from_numpy(jp, "cpu")
    ts = topt.opt_init(opt_t, tp)
    if kind == "adafactor":     # the factored and unfactored leaves
        assert set(ts["v"]["layers"]["w"]) == {"vr", "vc"}
        assert set(ts["v"]["blocks"][0]["u"]) == {"v"}
    jupd = jax.jit(lambda g, s, p: jopt.opt_update(opt_j, g, s, p))
    for step in range(2):
        grads = _opt_tree(rng, dtype)
        jp, js, jm = jupd(grads, js, jp)
        tp, ts, tm = topt.opt_update(opt_t, TM.params_from_numpy(
            grads, "cpu"), ts, tp)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        assert int(ts["step"]) == int(js["step"]) == step + 1
        _tree_close(ts["master"], js["master"], 1e-6)
        moments = ("mu", "nu") if kind == "adamw" else ("v",)
        for k in moments:     # scaled by the clip: its norm's sum order
            _tree_close(ts[k], js[k], 1e-5)
        # bf16 params: the master's rounding, within one bf16 ulp
        if dtype == BF16:
            _tree_close(tp, jp, 2 ** -7, elementwise=True)
        else:
            _tree_close(tp, jp, 1e-6)


# ------------------------------------------------------------- train step
@pytest.fixture(scope="module")
def qwen():
    jcfg = j_reduced(j_get_config("qwen2-1.5b"))
    tcfg = reduced(get_config("qwen2-1.5b"))
    rng = np.random.default_rng(0)
    jp = jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape))
        .astype(a.dtype), j_init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, jp, tcfg


@pytest.mark.parametrize("tc", [dict(microbatches=1),
                                dict(microbatches=2, remat=False),
                                dict(microbatches=1, bf16_grad_reduce=True)],
                         ids=["mb1", "mb2", "bf16_grads"])
def test_train_step_matches_reference(qwen, tc):
    """One step from the same weights and batch. Adam's first update is
    about g / (|g| + eps): with the default eps a gradient near zero
    whose sign the two sums round apart moves its weight by 2 lr, so
    the step runs at eps 1e-3, where the update follows the gradient
    smoothly; the update's own math is held above on equal gradients."""
    jcfg, jp, tcfg = qwen
    batch = next(j_batches(jcfg.vocab_size, 4, 64, seed=3))
    opt = dict(kind="adamw", lr=1e-3, eps=1e-3)
    jstep = jax.jit(jtl.build_train_step(jcfg, jopt.OptConfig(**opt),
                                         jtl.TrainConfig(**tc)))
    js = jopt.opt_init(jopt.OptConfig(**opt), jp)
    jp2, js2, jm = jstep(jp, js, batch)
    tp = TM.params_from_numpy(jp, "cpu")
    ts = topt.opt_init(topt.OptConfig(**opt), tp)
    tstep = ttl.build_train_step(tcfg, topt.OptConfig(**opt),
                                 ttl.TrainConfig(**tc))
    tp2, ts2, tm = tstep(tp, ts, batch)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    # (1 - b1) x the grads; rounded to bf16, within one ulp of the leaf
    _tree_close(ts2["mu"], js2["mu"],
                2 ** -8 if tc.get("bf16_grad_reduce") else 1e-4)
    _tree_close(tp2, jp2, 1e-5)


def test_train_step_refuses_unequal_microbatches(qwen):
    """A batch of 8 does not split into 3 equal microbatches: the step
    raises (the reference's reshape raises too) rather than weight
    ``chunk``'s 3/3/2 slices equally."""
    jcfg, jp, tcfg = qwen
    batch = next(j_batches(jcfg.vocab_size, 8, 64, seed=3))
    tp = TM.params_from_numpy(jp, "cpu")
    opt = topt.OptConfig(kind="adamw")
    tstep = ttl.build_train_step(tcfg, opt, ttl.TrainConfig(microbatches=3))
    with pytest.raises(ValueError, match="3 equal microbatches"):
        tstep(tp, topt.opt_init(opt, tp), batch)


def test_train_loop_history_matches_reference(qwen):
    jcfg, jp, tcfg = qwen
    opt = dict(kind="adamw", lr=3e-3)
    js = jopt.opt_init(jopt.OptConfig(**opt), jp)
    _, _, jh = jtl.train_loop(jcfg, jp, js, j_batches(jcfg.vocab_size, 2,
                                                      64),
                              steps=3, opt=jopt.OptConfig(**opt),
                              log_every=1)
    tp = TM.params_from_numpy(jp, "cpu")
    ts = topt.opt_init(topt.OptConfig(**opt), tp)
    _, _, th = ttl.train_loop(tcfg, tp, ts, synthetic_batches(
        tcfg.vocab_size, 2, 64), steps=3, opt=topt.OptConfig(**opt),
        log_every=1)
    assert [s for s, _ in th] == [s for s, _ in jh] == [0, 1, 2]
    np.testing.assert_allclose([v for _, v in th], [v for _, v in jh],
                               rtol=1e-5)
    assert th[-1][1] < th[0][1]


def test_synthetic_batches_equal_reference():
    a, b = synthetic_batches(331, 3, 64, seed=5), j_batches(331, 3, 64,
                                                            seed=5)
    for _ in range(3):
        x, y = next(a), next(b)
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k])


# ------------------------------------------------------------- checkpoints
def test_checkpoint_roundtrip(tmp_path):
    cfg = reduced(get_config("recurrentgemma-9b"))     # a list of layers
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = topt.OptConfig(kind="adafactor", factored_min_dim=8)
    state = topt.opt_init(opt, params)
    tck.save_checkpoint(str(tmp_path), 7, params, state)
    assert tck.latest_step(str(tmp_path)) == 7
    tree, step = tck.restore_checkpoint(str(tmp_path))
    assert step == 7
    for key, want in (("params", params), ("opt_state", state)):
        got = tree_leaves(tree[key])
        assert len(got) == len(tree_leaves(want))
        for a, b in zip(got, tree_leaves(want)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert isinstance(tree["params"]["layers"], list)


def test_checkpoint_async_and_gc(tmp_path):
    x = {"w": torch.arange(10.0)}
    threads = [tck.save_checkpoint(str(tmp_path), s, x, async_save=True,
                                   keep_last=2) for s in (1, 2, 3)]
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert len(steps) <= 2 and tck.latest_step(str(tmp_path)) == 3


def test_checkpoint_async_save_is_a_snapshot(tmp_path, monkeypatch):
    """An async save writes the leaves as they were when it returned,
    though the optimizer updates CPU leaves in place before the writer
    thread reaches them (the writer is held until after the update)."""
    go = threading.Event()
    save_leaf = tck._save_leaf

    def held(*args):
        go.wait(timeout=30)
        save_leaf(*args)

    monkeypatch.setattr(tck, "_save_leaf", held)
    x = {"w": torch.arange(10.0), "b": torch.ones(4, dtype=torch.bfloat16)}
    want = {k: v.clone() for k, v in x.items()}
    t = tck.save_checkpoint(str(tmp_path), 1, x, async_save=True)
    x["w"].add_(1.0)
    x["b"].mul_(3.0)
    go.set()
    t.join(timeout=30)
    assert not t.is_alive()
    tree, _ = tck.restore_checkpoint(str(tmp_path))
    for k, v in want.items():
        assert tree["params"][k].dtype == v.dtype
        assert torch.equal(tree["params"][k], v)


def test_checkpoint_atomic_no_partial(tmp_path):
    """A .tmp dir without manifest is never considered a checkpoint."""
    os.makedirs(tmp_path / "step_00000005.tmp")
    assert tck.latest_step(str(tmp_path)) is None


def test_checkpoints_cross_read_f32(qwen, tmp_path):
    """A checkpoint the JAX package wrote restores in the port (onto a
    device), and one the port wrote restores in the JAX package."""
    jcfg, jp, _ = qwen
    js = jopt.opt_init(jopt.OptConfig(), jp)
    jck.save_checkpoint(str(tmp_path / "j"), 3, jp, js)
    tree, step = tck.restore_checkpoint(str(tmp_path / "j"), device="cpu")
    assert step == 3
    _tree_close(tree["params"], jp, 0)
    _tree_close({k: v for k, v in tree["opt_state"].items() if k != "step"},
                {k: v for k, v in js.items() if k != "step"}, 0)
    assert int(tree["opt_state"]["step"]) == 0
    assert tree["opt_state"]["step"].dtype == torch.int32
    tp = TM.params_from_numpy(jp, "cpu")
    ts = topt.opt_init(topt.OptConfig(), tp)
    tck.save_checkpoint(str(tmp_path / "t"), 4, tp, ts)
    jtree, step = jck.restore_checkpoint(str(tmp_path / "t"))
    assert step == 4
    for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(
            {"params": tp, "opt_state": ts})):
        assert a.dtype == b.numpy().dtype
        np.testing.assert_array_equal(a, b.numpy())


def test_bf16_checkpoint_reference_fault(tmp_path):
    """The reference saves a bf16 leaf as 2-byte voids (descr ``<V2``)
    and its own restore returns them as such; the port restores the
    same bits as bf16 and writes the same file bytes."""
    rng = np.random.default_rng(1)
    jp = {"w": jnp.asarray(rng.standard_normal((5, 7)), jnp.bfloat16),
          "n": [jnp.asarray(rng.standard_normal(3), jnp.bfloat16)]}
    jck.save_checkpoint(str(tmp_path / "j"), 1, jp)
    jtree, _ = jck.restore_checkpoint(str(tmp_path / "j"))
    assert jtree["params"]["w"].dtype == np.dtype("V2")      # the fault
    tree, _ = tck.restore_checkpoint(str(tmp_path / "j"))
    for key, got in (("w", tree["params"]["w"]),
                     ("n", tree["params"]["n"][0])):
        want = np.asarray(jp[key] if key == "w" else jp[key][0])
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16))
    tck.save_checkpoint(str(tmp_path / "t"), 1, tree["params"])
    for name in sorted(os.listdir(tmp_path / "j" / "step_00000001")):
        a = (tmp_path / "j" / "step_00000001" / name).read_bytes()
        b = (tmp_path / "t" / "step_00000001" / name).read_bytes()
        assert a == b, name


def test_run_resilient_restarts_from_checkpoint(tmp_path):
    calls = {"n": 0}

    def train_once(start):
        calls["n"] += 1
        tck.save_checkpoint(str(tmp_path), calls["n"],
                            {"w": torch.ones(3)})
        if calls["n"] < 3:
            raise RuntimeError("simulated node failure")
        return start + 100

    def on_failure(e, restarts):
        return tck.latest_step(str(tmp_path))

    out = run_resilient(train_once, max_restarts=5, on_failure=on_failure)
    assert calls["n"] == 3 and out == 2 + 100

    def always_fails(start):
        calls["n"] += 1
        raise RuntimeError("simulated node failure")

    calls["n"] = 0
    with pytest.raises(RuntimeError, match="simulated"):
        run_resilient(always_fails, max_restarts=1)
    assert calls["n"] == 2


# ------------------------------------------------------------- launcher
def test_launcher_trains_and_resumes_on_cpu(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    args = ["--device", "cpu", "--arch", "qwen2-1.5b", "--reduced",
            "--batch", "2", "--seq", "64", "--ckpt-dir", ck]
    launch_train.main(args + ["--steps", "20"])
    out = capsys.readouterr().out
    assert tck.latest_step(ck) == 20 and "resumed" not in out
    losses = [float(line.split()[-1]) for line in out.splitlines()
              if line.startswith("step")]
    assert len(losses) == 3 and np.isfinite(losses).all()
    launch_train.main(args + ["--steps", "5", "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 20" in out
    assert out.splitlines()[-1].startswith("step     4 loss")


def test_launchers_take_the_first_layers(capsys):
    """``--layers N``: the training launcher trains and the serving
    launcher serves the config's first N layers at its width; a count
    below 1, or past the served config's depth, is refused, and the
    simulator takes none."""
    from repro_torch.launch import serve
    args = dict(arch="qwen2-1.5b", reduced=True, layers=1, steps=2,
                batch=2, seq=64, microbatches=1, ckpt_dir=None,
                resume=False, device="cpu")
    run = launch_train.prepare(args)
    assert run["cfg"].num_layers == 1 and run["cfg"].d_model == \
        launch_train.prepare(dict(args, layers=None))["cfg"].d_model
    assert {t.shape[0] for t in tree_leaves(
        run["params"]["layers"])} == {1}
    with pytest.raises(SystemExit):
        launch_train.main(["--device", "cpu", "--reduced", "--layers", "0"])
    assert serve.build_config("tiny", 1).num_layers == 1
    assert serve.build_config("qwen2-1.5b", 4).d_model == 1536
    serve.main(["--engine", "real", "--device", "cpu", "--config", "tiny",
                "--layers", "1", "--json"])
    assert '"generated"' in capsys.readouterr().out
    for bad in (["--engine", "real", "--config", "tiny", "--layers", "3"],
                ["--engine", "sim", "--layers", "1"]):
        with pytest.raises(SystemExit):
            serve.main(bad)


def test_launcher_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--reduced", "--steps", "1"])
