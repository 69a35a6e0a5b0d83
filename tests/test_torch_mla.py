"""Multi-head latent attention (DeepSeek-V2) in the port against the JAX
package, at the reduced size (two layers, d_model 64, f32: kv_lora 32,
q_lora 32, nope 16 + rope 8, v 16; a leading dense layer, then a moe
layer of 4 experts top-2 with one shared expert), with JAX's weights,
every leaf perturbed by 0.1 N(0, 1), carried across by
``params_from_numpy``:

- ``models/mla.py`` function by function: the projections, the
  decompressed prefill (the port's through ``flash_prefill``'s plain
  version with V padded to nope + rope, the reference's masked einsum)
  and the absorbed decode over a latent ring with empty slots;
- the ring-cache ``prefill`` and 8 ``decode_step``s of the reduced
  deepseek-v2 (``layers_pre``, MLA in every layer) on padded rows, on a
  ring shorter than the prompt and on W == S; f32 logits within 2e-5
  and the same argmax, the latent caches within 1e-5, the integer
  leaves exactly;
- the single-turn engine's streams token for token the JAX engine's on
  the four scenarios of ``test_torch_single_turn.py`` (at capacity
  factor E / k, the JAX engine's graft corrected: ROADMAP.md queue 3),
  and on perturbed weights at the published capacity factor its greedy
  reference's;
- the parameter tree (the ``[r, H, e]`` and ``[H, e, d]`` leaves) and
  the cache's ``ckv``/``k_rope`` against the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving.engine as jeng
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core.scheduler import SchedulerConfig as JSchedulerConfig
from repro.core.scheduler import UrgencyScheduler as JUrgencyScheduler
from repro.models import init_params as j_init_params
from repro.models import layers as JL
from repro.models import mla as jmla
from repro.models import model as JM
import repro_torch.serving.engine as teng
from repro_torch.configs import get_config, reduced
from repro_torch.core.scheduler import SchedulerConfig, UrgencyScheduler
from repro_torch.models import mla as tmla
from repro_torch.models import model as TM
from test_torch_model import _pair
from test_torch_single_turn import SCENARIOS, _every_other, _greedy_jax, \
    _greedy_torch

NAME = "deepseek-v2-236b"
TOL = 2e-5
CACHE_TOL = 1e-5


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.fixture(scope="module")
def pair():
    jcfg, jp, tcfg, tp = _pair(NAME)
    assert tcfg.mla is not None and len(tp["layers_pre"]) == 1
    assert "moe" in tp["layers"] and "mlp" in tp["layers_pre"][0]
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def jitted(pair):
    """The reference's prefill and decode step, compiled once a shape."""
    jcfg = pair[0]
    return (jax.jit(lambda p, t, c, sl: JM.prefill(jcfg, p, t, c,
                                                   seq_lens=sl)),
            jax.jit(lambda p, t, c: JM.decode_step(jcfg, p, t, c)))


def _attn(pair, layer=0):
    """The layer's MLA params in both packages (layer 0: layers_pre)."""
    jcfg, jp, tcfg, tp = pair
    return jcfg, jp["layers_pre"][layer]["attn"], tcfg, \
        tp["layers_pre"][layer]["attn"]


# ======================================================================
# models/mla.py
# ======================================================================
@pytest.mark.parametrize("S", [1, 5, 19])
def test_mla_forward_matches_jax(pair, S):
    """The decompressed prefill over S tokens, causal: the output and
    the latents it returns."""
    jcfg, ja, tcfg, ta = _attn(pair)
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
    mask = JL.attention_mask(jnp.asarray(pos), jnp.asarray(pos),
                             causal=True)
    jo, (jckv, jkr) = jmla.mla_forward(ja, jcfg, jnp.asarray(x),
                                       jnp.asarray(pos), mask)
    to, (tckv, tkr) = tmla.mla_forward(ta, tcfg, torch.from_numpy(x),
                                       torch.from_numpy(pos.copy()))
    assert to.shape == (2, S, 64) and tckv.shape == (2, S, 32) \
        and tkr.shape == (2, S, 8)
    _close(to, jo)
    _close(tckv, jckv, CACHE_TOL)
    _close(tkr, jkr, CACHE_TOL)


@pytest.mark.parametrize("W", [6, 23])
def test_mla_decode_matches_jax(pair, W):
    """The absorbed decode of one token over a ring of W latent slots,
    some empty (masked); the new latents from ``_project_kv_latent``."""
    jcfg, ja, tcfg, ta = _attn(pair)
    rng = np.random.default_rng(10 + W)
    B = 3
    x = rng.standard_normal((B, 1, 64)).astype(np.float32)
    pos = np.array([[W - 1], [3], [W + 7]], np.int32)
    ckv = rng.standard_normal((B, W, 32)).astype(np.float32)
    kr = rng.standard_normal((B, W, 8)).astype(np.float32)
    kv_pos = np.where(rng.random((B, W)) < 0.8,
                      rng.integers(0, W + 8, (B, W)), -1).astype(np.int32)
    kv_pos[:, 0] = pos[:, 0]                 # each row sees itself
    mask = (kv_pos[:, None, :] <= pos[:, :, None]) & (kv_pos >= 0)[:, None]
    jo, (jn, jr) = jmla.mla_decode(ja, jcfg, jnp.asarray(x),
                                   jnp.asarray(pos), jnp.asarray(ckv),
                                   jnp.asarray(kr), jnp.asarray(mask))
    to = tmla.mla_decode(ta, tcfg, torch.from_numpy(x),
                         torch.from_numpy(pos), torch.from_numpy(ckv),
                         torch.from_numpy(kr), torch.from_numpy(mask))
    tn, tr = tmla._project_kv_latent(ta, tcfg, torch.from_numpy(x),
                                     torch.from_numpy(pos))
    _close(to, jo)
    _close(tn, jn, CACHE_TOL)
    _close(tr, jr, CACHE_TOL)


def test_mla_projections_match_jax(pair):
    jcfg, ja, tcfg, ta = _attn(pair)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    pos = rng.integers(0, 100, (2, 9)).astype(np.int32)
    for jf, tf in ((jmla._project_q, tmla._project_q),
                   (jmla._project_kv_latent, tmla._project_kv_latent)):
        for j, t in zip(jf(ja, jcfg, jnp.asarray(x), jnp.asarray(pos)),
                        tf(ta, tcfg, torch.from_numpy(x),
                           torch.from_numpy(pos))):
            _close(t, j, CACHE_TOL)


# ======================================================================
# the ring-cache model
# ======================================================================
DEEPSEEK_CASES = [  # S, capacity, seq_lens
    (11, 32, (11, 6)),           # a padded row
    (16, 16, (16,)),             # W == S: the position-aligned write
    (20, 12, (20, 15)),          # a ring shorter than the prompt
]


@pytest.mark.parametrize("S,capacity,seq_lens", DEEPSEEK_CASES)
def test_deepseek_prefill_decode_match_jax(pair, jitted, S, capacity,
                                          seq_lens):
    """Prefill, then 8 decode steps (the ring wraps where it is shorter
    than the context): logits, every cache leaf."""
    jcfg, jp, tcfg, tp = pair
    j_prefill, j_decode = jitted
    B = len(seq_lens)
    rng = np.random.default_rng(S)
    tokens = rng.integers(0, jcfg.vocab_size, size=(B, S))
    sl = np.asarray(seq_lens, np.int32)
    jc = JM.init_cache(jcfg, B, capacity)
    jl, jc = j_prefill(jp, jnp.asarray(tokens), jc, jnp.asarray(sl))
    tc = TM.init_cache(tcfg, B, capacity, "cpu")
    tl, tc = TM.prefill(tcfg, tp, torch.from_numpy(tokens), tc,
                        seq_lens=torch.from_numpy(sl))
    assert set(tc) == {"len", "ckv", "k_rope", "kv_pos"}
    for step in range(9):
        if step:
            nxt = rng.integers(0, jcfg.vocab_size, size=(B,))
            jl, jc = j_decode(jp, jnp.asarray(nxt, jnp.int32), jc)
            tl, tc = TM.decode_step(tcfg, tp, torch.from_numpy(nxt), tc)
        assert tl.dtype == torch.float32
        _close(tl, jl)
        assert np.array_equal(tl.argmax(-1).numpy(),
                              np.asarray(jl).argmax(-1)), step
        assert set(tc) == set(jc)
        for name in tc:
            want = np.asarray(jc[name])
            if name in ("len", "kv_pos"):
                assert np.array_equal(tc[name].numpy(), want), name
            else:
                _close(tc[name], want, CACHE_TOL)


def test_plain_prefill_is_the_kernel_route_on_cpu(pair):
    """``plain=True`` is the same arithmetic on the CPU (the wrapper's
    plain version, padded V included): bit for bit."""
    _, _, tcfg, tp = pair
    tok = torch.from_numpy(np.random.default_rng(9).integers(0, 331, (1, 30)))
    got = TM.prefill(tcfg, tp, tok, TM.init_cache(tcfg, 1, 64, "cpu"))
    want = TM.prefill(tcfg, tp, tok, TM.init_cache(tcfg, 1, 64, "cpu"),
                      plain=True)
    assert torch.equal(got[0], want[0])
    for k in got[1]:
        assert torch.equal(got[1][k], want[1][k]), k


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_mla_tree_and_cache_match_jax(param_dtype):
    """The port's init gives the reference's tree (``layers_pre`` with
    the dense layer, MLA's ``[r, H, e]`` and ``[H, e, d]`` leaves, the
    router f32), shapes and types; the carried tree keeps them; the
    caches agree (``ckv``, ``k_rope`` in place of K/V)."""
    jcfg = j_reduced(j_get_config(NAME), layers=2, d_model=64,
                     vocab=331).replace(param_dtype=param_dtype,
                                        dtype=param_dtype)
    tcfg = reduced(get_config(NAME), layers=2, d_model=64,
                   vocab=331).replace(param_dtype=param_dtype,
                                      dtype=param_dtype)
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jp)
    mine = TM.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    got = jax.tree.map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")),
        mine)
    assert got == want
    carried = TM.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                                   getattr(torch, param_dtype))
    assert jax.tree.map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")),
        carried) == want
    assert carried["layers"]["attn"]["w_uk"].shape == (1, 32, 4, 16)
    assert carried["layers_pre"][0]["attn"]["wo"].shape == (4, 16, 64)
    jc = JM.init_cache(jcfg, 3, 40)
    tc = TM.init_cache(tcfg, 3, 40, "cpu")
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in tc.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in jc.items()}


# ======================================================================
# the single-turn engine
# ======================================================================
class _GraftEveryLayer(jeng.RealtimeLLMEngine):
    """The JAX engine with its graft writing the B = 1 prefill's cache
    into each layer of the slot. The reference writes layer 0's into
    every layer (``buf.at[:, slot].set(one[0])``, ROADMAP.md queue 3), a
    fault the port does not carry; on the reduced deepseek-v2 it changes
    the streams even on the initial weights."""

    def add_session(self, session_id, prompt, max_new_tokens):
        slot = super().add_session(session_id, prompt, max_new_tokens)
        c1 = JM.init_cache(self.cfg, 1, self.capacity)
        _, c1 = JM.prefill(self.cfg, self.params,
                           jnp.asarray(prompt, jnp.int32)[None, :], c1)
        for name, one in c1.items():
            buf = self.cache[name]
            if buf.ndim >= 2 and buf.shape[1] == self.slots:
                self.cache[name] = buf.at[:, slot].set(one[:, 0])
        return slot


@pytest.fixture(scope="module")
def engine_pair():
    """The reference's weights as initialised (zero norm scales, as in
    ``test_torch_single_turn.py``) at capacity factor E / k, where no
    token can drop: the JAX engine routes its held and empty slots'
    tokens too, the port only the scheduled ones, which at a binding
    capacity can drop other tokens (the reference's moe padding fault,
    ROADMAP.md queue 3)."""
    cfgs = []
    for get, red in ((j_get_config, j_reduced), (get_config, reduced)):
        cfg = red(get(NAME), layers=2, d_model=64, vocab=331)
        m = cfg.moe
        cfgs.append(cfg.replace(moe=dataclasses.replace(
            m, capacity_factor=m.num_experts / m.top_k)))
    jcfg, tcfg = cfgs
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, tcfg, TM.params_from_numpy(
        jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_deepseek_single_turn_engine_matches_jax(engine_pair, scenario):
    """``RealtimeLLMEngine`` on MLA's latent caches (grafted by name):
    the JAX engine's streams (its graft corrected) and KV accounting,
    each held to both packages' greedy references."""
    jcfg, jp, tcfg, tp = engine_pair
    run = SCENARIOS[scenario]
    j_out, j_ref, j_acct = run(
        lambda slots: _GraftEveryLayer(jcfg, jp, slots=slots, capacity=128),
        jcfg.vocab_size, _every_other(JUrgencyScheduler, JSchedulerConfig))
    t_out, t_ref, t_acct = run(
        lambda slots: teng.RealtimeLLMEngine(tcfg, tp, slots=slots,
                                             capacity=128, device="cpu"),
        tcfg.vocab_size, _every_other(UrgencyScheduler, SchedulerConfig))
    assert t_out == j_out
    assert t_acct == j_acct
    for sid, (prompt, n) in t_ref.items():
        want = _greedy_torch(tcfg, tp, prompt, n)
        assert t_out[sid] == want == _greedy_jax(jcfg, jp, prompt, n), sid


def test_deepseek_engine_keeps_contract_on_perturbed_weights(pair):
    """With every leaf perturbed the tokens vary, and the engine's
    streams (four slots, and under the adversarial scheduler that holds
    slots every round) equal the B = 1 greedy ones."""
    _, _, tcfg, tp = pair
    seen = set()
    for name in ("matches_greedy", "every_other"):
        out, ref, _ = SCENARIOS[name](
            lambda slots: teng.RealtimeLLMEngine(tcfg, tp, slots=slots,
                                                 capacity=128,
                                                 device="cpu"),
            tcfg.vocab_size, _every_other(UrgencyScheduler,
                                          SchedulerConfig))
        for sid, (prompt, n) in ref.items():
            assert out[sid] == _greedy_torch(tcfg, tp, prompt, n), sid
            seen.update(out[sid])
    assert len(seen) > 6
