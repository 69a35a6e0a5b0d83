"""The port's training graph against the JAX package's: ``forward``'s
logits, ``loss_fn``'s loss, ``ce`` and ``aux``, and every gradient leaf,
for each family (dense, windowed dense, the vlm with its patches and
prefix-LM mask, moe, moe with mla and a leading dense layer, ssm,
hybrid, encdec with its frames), on the reduced configs (f32) with
JAX's weights, every leaf perturbed by 0.1 N(0, 1), carried across by
``params_from_numpy``. The reference's side is jitted (one compile a
config: eager JAX over the unrolled layers is slow); deepseek-v2's and
recurrentgemma's checks, the slowest to compile, run in
``tests/test_torch_training.py``.

Tolerances: logits, loss and ``ce`` 2e-4 (``tests/test_arch_smoke.py``'s);
each gradient leaf within 1e-4 of its largest |value| (XLA and ATen
sum in different orders; the worst seen is ~7e-6, mamba2's ``A_log``).

Also held here: ``remat`` gives the same loss and gradients bit for
bit; the out-of-place RG-LRU scan equals the in-place one bit for bit;
the prefix-LM prefill with patches against the reference's prefill;
and the port's ``prefill`` plus ``decode_step`` against its own
``forward`` (the reference's ``test_prefill_decode_matches_forward``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import init_params as j_init_params
from repro.models import model as JM
from repro_torch.configs import get_config, reduced
from repro_torch.models import model as TM
from repro_torch.models import rglru as trg
from repro_torch.training.optimizer import tree_leaves
from repro_torch.training.train_loop import batch_to, loss_and_grads

ARCHS = ["qwen2-1.5b", "h2o-danube-1.8b", "paligemma-3b",
         "phi3.5-moe-42b-a6.6b", "deepseek-v2-236b", "mamba2-1.3b",
         "recurrentgemma-9b", "whisper-tiny"]
B, S = 2, 24
TOL = 2e-4
GRAD_TOL = 1e-4


def _setup(name, seed=0):
    """(jcfg, jax params, tcfg, torch params, numpy batch)."""
    jcfg, tcfg = j_reduced(j_get_config(name)), reduced(get_config(name))
    rng = np.random.default_rng(seed)
    jp = jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape))
        .astype(a.dtype), j_init_params(jcfg, jax.random.PRNGKey(seed)))
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1),
             "weights": np.ones((B, S), np.float32)}
    batch["weights"][:, -1] = 0.0
    if jcfg.frontend == "vision":
        batch["patches"] = rng.standard_normal(
            (B, jcfg.frontend_len, jcfg.d_model)).astype(np.float32)
        batch["prefix_len"] = np.full((B,), jcfg.frontend_len, np.int32)
    if jcfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, jcfg.encoder.num_frames, jcfg.d_model)).astype(np.float32)
    return jcfg, jp, tcfg, TM.params_from_numpy(jp, "cpu"), batch


def _forward(M, cfg, params, b):
    return M.forward(cfg, params, b["tokens"],
                     frontend_embeds=b.get("patches"),
                     enc_frames=b.get("frames"),
                     prefix_len=b.get("prefix_len"))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# the slowest two to compile run in tests/test_torch_training.py, so
# that each file stays near a minute alone
HEAVY = ["deepseek-v2-236b", "recurrentgemma-9b"]


@pytest.mark.parametrize("name", [a for a in ARCHS if a not in HEAVY])
def test_forward_loss_and_grads_match_reference(name):
    check_training_graph(name)


def check_training_graph(name):
    """forward's logits, loss_fn's loss, ce and aux, and every gradient
    leaf against the jitted reference."""
    jcfg, jp, tcfg, tp, batch = _setup(name)

    @jax.jit
    def reference(p, b):
        (loss, metrics), grads = jax.value_and_grad(
            lambda p: JM.loss_fn(jcfg, p, b), has_aux=True)(p)
        return _forward(JM, jcfg, p, b), loss, metrics, grads

    (jlogits, jaux), jloss, jm, jgrads = reference(jp, batch)
    tb = batch_to(batch, "cpu")
    tlogits, taux = _forward(TM, tcfg, tp, tb)
    loss, metrics, grads = loss_and_grads(tcfg, tp, tb)
    S_total = S + (jcfg.frontend_len if jcfg.frontend == "vision" else 0)
    assert tlogits.shape == (B, S_total, jcfg.vocab_size)
    _close(tlogits, jlogits)
    _close(taux, jaux)
    _close(loss, jloss)
    _close(metrics["ce"], jm["ce"])
    _close(metrics["aux"], jm["aux"])
    if jcfg.family == "moe":
        assert float(metrics["aux"]) > 0
    want = jax.tree_util.tree_leaves_with_path(jgrads)
    got = jax.tree.leaves(grads)            # in JAX's key order
    assert len(got) == len(want)
    for (path, a), g in zip(want, got):
        a = np.asarray(a)
        assert tuple(g.shape) == a.shape and g.dtype == torch.float32
        err = np.abs(g.numpy() - a).max()
        assert err <= GRAD_TOL * max(np.abs(a).max(), 1e-6), \
            (jax.tree_util.keystr(path), err, np.abs(a).max())


@pytest.mark.parametrize("name", ["qwen2-1.5b", "paligemma-3b",
                                  "deepseek-v2-236b", "mamba2-1.3b",
                                  "whisper-tiny"])
def test_remat_is_exact(name):
    _, _, tcfg, tp, batch = _setup(name)
    tb = batch_to(batch, "cpu")
    loss, _, grads = loss_and_grads(tcfg, tp, tb)
    rloss, _, rgrads = loss_and_grads(tcfg, tp, tb, remat=True)
    assert torch.equal(loss, rloss)
    for g, r in zip(tree_leaves(grads), tree_leaves(rgrads)):
        assert torch.equal(g, r)


@pytest.mark.parametrize("S_", [1, 2, 37, 64])
def test_rglru_scan_out_of_place_is_bit_equal(S_):
    g = torch.Generator().manual_seed(S_)
    a = torch.rand((2, S_, 8), generator=g)
    b = torch.randn((2, S_, 8), generator=g)
    a0, b0 = a.clone(), b.clone()
    want = trg._linear_scan(a.clone(), b.clone())
    got = trg._linear_scan_train(a, b)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(a, a0) and torch.equal(b, b0)    # untouched


def test_prefix_lm_prefill_matches_reference():
    """paligemma's prefill with its patches under the prefix-LM mask
    (the masked ``gqa_attention``), and with the patches alone, causal
    (``flash_prefill``'s plain version), against the reference's; a
    padded row included."""
    jcfg, jp, tcfg, tp, batch = _setup("paligemma-3b")
    F = jcfg.frontend_len
    sl = np.array([F + S, F + S - 5], np.int32)
    for prefix in (True, False):
        pl = batch["prefix_len"] if prefix else None
        jc = JM.init_cache(jcfg, B, F + S + 8)
        jl, jc = JM.prefill(jcfg, jp, jnp.asarray(batch["tokens"]), jc,
                            frontend_embeds=jnp.asarray(batch["patches"]),
                            prefix_len=None if pl is None
                            else jnp.asarray(pl),
                            seq_lens=jnp.asarray(sl))
        tc = TM.init_cache(tcfg, B, F + S + 8, "cpu")
        tl, tc = TM.prefill(tcfg, tp, torch.from_numpy(batch["tokens"]), tc,
                            frontend_embeds=torch.from_numpy(
                                batch["patches"]),
                            prefix_len=None if pl is None
                            else torch.from_numpy(pl),
                            seq_lens=torch.from_numpy(sl))
        _close(tl, jl)
        for k in ("k", "v"):
            _close(tc[k], jc[k], 1e-5)
        for k in ("len", "kv_pos"):
            assert np.array_equal(tc[k].numpy(), np.asarray(jc[k]))


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_decode_matches_forward(name):
    """The port's prefill of S-1 tokens then one decode step against its
    own teacher-forcing ``forward`` at S-2 and S-1."""
    _, _, tcfg, tp, batch = _setup(name)
    tb = batch_to(batch, "cpu")
    fe = tb.get("patches")
    F = tcfg.frontend_len if fe is not None else 0
    cache = TM.init_cache(tcfg, B, F + S + 8, "cpu",
                          enc_frames=tcfg.encoder.num_frames
                          if tcfg.family == "encdec" else 0)
    last, cache = TM.prefill(tcfg, tp, tb["tokens"][:, :S - 1], cache,
                             frontend_embeds=fe,
                             prefix_len=tb.get("prefix_len"),
                             enc_frames=tb.get("frames"))
    dec, cache = TM.decode_step(tcfg, tp, tb["tokens"][:, S - 1], cache)
    full, _ = _forward(TM, tcfg, tp, tb)
    _close(last, full[:, -2])
    _close(dec, full[:, -1])
    assert int(cache["len"][0]) == F + S
