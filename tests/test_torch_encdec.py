"""The encdec family (whisper: an encoder over stub frame embeddings,
decoder layers with cross-attention) in the port against the JAX
package, on the reduced config (two decoder and two encoder layers,
d_model 64, 16 frames, f32) with JAX's weights, every leaf perturbed
by 0.1 N(0, 1), carried across by ``params_from_numpy``, on the same
seeded frames:

- the pieces: ``sinusoidal_positions``, ``attn_init``'s ``mha`` and
  ``d_model``, ``attn_project_qkv(rope=False)``, ``encode``;
- ``prefill(enc_frames=)`` and ``decode_step`` with a padded row, with
  a ring shorter than the prompt, and with more frames than tokens and
  fewer: logits within 2e-5 (relative and absolute) and the same
  argmax, the cache within 1e-5 (cross-attention K/V included);
- a batch's greedy streams equal each row's B = 1 stream;
- the parameter tree and cache against the reference's, and the
  ``enc_frames`` contract.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import init_params as j_init_params
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import get_config, reduced
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from test_torch_model import _pair

NAME = "whisper-tiny"
TOL = 2e-5
CACHE_TOL = 1e-5
D = 64


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.fixture(scope="module")
def pair():
    jcfg, jp, tcfg, tp = _pair(NAME)
    assert tcfg.family == "encdec" and tcfg.encoder.num_frames == 16
    assert tp["layers"]["xattn"]["wk"].shape[2] == tcfg.num_heads
    return jcfg, jp, tcfg, tp


def _frames(seed, B, F):
    return np.random.default_rng(seed).standard_normal(
        (B, F, D)).astype(np.float32)


# ======================================================================
# the pieces
# ======================================================================
@pytest.mark.parametrize("F,d", [(16, 64), (1500, 384)])
def test_sinusoidal_positions_match_jax(F, d):
    """At whisper-tiny's 1500 frames the angles reach 1499 rad, where an
    f32 ulp is 1.2e-4: the tolerance there is that rounding's."""
    got = TL.sinusoidal_positions(F, d, "cpu")
    assert got.shape == (F, d) and got.dtype == torch.float32
    _close(got, JL.sinusoidal_positions(F, d), TOL if F < 100 else 2e-4)


@pytest.mark.parametrize("kw", [dict(mha=True), dict(d_model=48),
                                dict(mha=True, d_model=48)])
def test_attn_init_options_match_jax(kw):
    """``mha`` gives as many KV heads as query heads (on a GQA config, 4
    query heads on 2), ``d_model`` another input width."""
    jcfg = j_reduced(j_get_config("qwen2-1.5b"), layers=2, d_model=D,
                     vocab=331)
    tcfg = reduced(get_config("qwen2-1.5b"), layers=2, d_model=D,
                   vocab=331)
    want = {k: v.shape for k, v in JL.attn_init(
        jax.random.PRNGKey(0), jcfg, jnp.float32, **kw).items()}
    got = {k: tuple(v.shape) for k, v in TL.attn_init(
        torch.Generator().manual_seed(0), tcfg, torch.float32, "cpu",
        **kw).items()}
    assert got == want
    assert got["wk"][1] == (4 if kw.get("mha") else 2)


def test_encoder_projection_matches_jax(pair):
    """The encoder's projection takes no rope (and the decoder's does)."""
    jcfg, jp, tcfg, tp = pair
    x = np.random.default_rng(2).standard_normal((2, 5, D)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(5, dtype=np.int32), (2, 5))
    lj = jax.tree.map(lambda a: a[0], jp["encoder"]["layers"])["attn"]
    lt = TM.layer_params(tp["encoder"])[0]["attn"]
    for rope in (False, True):
        want = JL.attn_project_qkv(lj, jcfg, jnp.asarray(x),
                                   jnp.asarray(pos), rope=rope)
        got = TL.attn_project_qkv(lt, tcfg, torch.from_numpy(x),
                                  torch.from_numpy(pos.copy()), rope=rope)
        for g, w in zip(got, want):
            _close(g, w)


@pytest.mark.parametrize("F", [16, 37])
def test_encode_matches_jax(pair, F):
    jcfg, jp, tcfg, tp = pair
    fr = _frames(F, 2, F)
    want = JM.encode(jcfg, jp, jnp.asarray(fr))
    got = TM.encode(tcfg, tp, torch.from_numpy(fr))
    assert got.shape == (2, F, D)
    _close(got, want)
    plain = TM.encode(tcfg, tp, torch.from_numpy(fr), plain=True)
    assert torch.equal(plain, got)


# ======================================================================
# prefill and decode
# ======================================================================
ENCDEC_CASES = [  # S, capacity, seq_lens, frames
    (12, 32, (12, 7), 16),       # a padded row
    (20, 8, (20,), 16),          # S > W: the ring drops the oldest
    (5, 32, (5, 3, 1), 40),      # more frames than tokens, ragged rows
]


@pytest.mark.parametrize("S,capacity,seq_lens,F", ENCDEC_CASES)
def test_encdec_prefill_decode_match_jax(pair, S, capacity, seq_lens, F):
    jcfg, jp, tcfg, tp = pair
    B = len(seq_lens)
    rng = np.random.default_rng(S + F)
    tokens = rng.integers(0, jcfg.vocab_size, size=(B, S))
    sl = np.asarray(seq_lens, np.int32)
    fr = _frames(F, B, F)
    jc = JM.init_cache(jcfg, B, capacity, enc_frames=F)
    jl, jc = JM.prefill(jcfg, jp, jnp.asarray(tokens), jc,
                        seq_lens=jnp.asarray(sl), enc_frames=jnp.asarray(fr))
    tc = TM.init_cache(tcfg, B, capacity, "cpu", enc_frames=F)
    tl, tc = TM.prefill(tcfg, tp, torch.from_numpy(tokens), tc,
                        seq_lens=torch.from_numpy(sl),
                        enc_frames=torch.from_numpy(fr))
    decode = jax.jit(lambda p, t, c: JM.decode_step(jcfg, p, t, c))
    for step in range(6):
        if step:
            nxt = rng.integers(0, jcfg.vocab_size, size=(B,))
            jl, jc = decode(jp, jnp.asarray(nxt, jnp.int32), jc)
            tl, tc = TM.decode_step(tcfg, tp, torch.from_numpy(nxt), tc)
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


def _greedy(cfg, params, tokens, seq_lens, frames, n):
    cache = TM.init_cache(cfg, tokens.shape[0], 64, "cpu",
                          enc_frames=frames.shape[1])
    lg, cache = TM.prefill(cfg, params, tokens, cache, seq_lens=seq_lens,
                           enc_frames=frames)
    out = [lg.argmax(-1)]
    for _ in range(n - 1):
        lg, cache = TM.decode_step(cfg, params, out[-1], cache)
        out.append(lg.argmax(-1))
    return torch.stack(out, 1)


def test_batched_streams_equal_b1(pair):
    """Four rows of 3-14 tokens over their own frames, 8 greedy steps:
    each row's stream is its B = 1 stream."""
    _, _, tcfg, tp = pair
    rng = np.random.default_rng(11)
    lens = [14, 3, 9, 6]
    tokens = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (4, 14)))
    frames = torch.from_numpy(_frames(12, 4, 16))
    got = _greedy(tcfg, tp, tokens, torch.tensor(lens, dtype=torch.int32),
                  frames, 8)
    for b, n in enumerate(lens):
        one = _greedy(tcfg, tp, tokens[b:b + 1, :n], None, frames[b:b + 1],
                      8)
        assert torch.equal(got[b], one[0]), b


def test_encdec_tree_cache_and_frames_contract():
    jcfg = j_reduced(j_get_config(NAME), layers=2, d_model=D, vocab=331)
    tcfg = reduced(get_config(NAME), layers=2, d_model=D, vocab=331)
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                        j_init_params(jcfg, jax.random.PRNGKey(0)))
    tp = TM.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    got = jax.tree.map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), tp)
    assert got == want
    jc = JM.init_cache(jcfg, 2, 24, enc_frames=16)
    tc = TM.init_cache(tcfg, 2, 24, "cpu", enc_frames=16)
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: v.shape for k, v in jc.items()}
    tok = torch.zeros((2, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="enc_frames"):
        TM.prefill(tcfg, tp, tok, tc)
    dense = reduced(get_config("qwen2-1.5b"), layers=2, d_model=D,
                    vocab=331)
    dp = TM.init_params(dense, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="enc_frames"):
        TM.prefill(dense, dp, tok, TM.init_cache(dense, 2, 8, "cpu"),
                   enc_frames=torch.zeros((2, 16, D)))
