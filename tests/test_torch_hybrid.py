"""The hybrid family (RecurrentGemma: rglru, rglru, local attention) in
the port against the JAX package, on the reduced config (three layers,
d_model 64, local window 16, f32) with JAX's weights, every leaf
perturbed by 0.1 N(0, 1), carried across by ``params_from_numpy``:

- ``models/rglru.py`` function by function: the log-step scan against
  ``jax.lax.associative_scan`` (the same combine in another tree), the
  single step, and the recurrent block over a prompt (shorter than the
  conv's tail included) and one token;
- the ring-cache ``prefill``/``decode_step`` on prompts shorter than,
  equal to, one past and far past the window (the ring wraps; a padded
  row), decoding across the wrap; logits within 2e-5 (relative and
  absolute) and the same argmax, the cache within 1e-5, the integer
  leaves exactly;
- the parameter tree, shapes and types (the RG-LRU's gates and decay
  f32 at a bf16 ``param_dtype``) and the cache's.

The single-turn engine's scenarios run on this family in
``tests/test_torch_single_turn.py``.
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
from repro.models import rglru as jrg
from repro_torch.configs import get_config, reduced
from repro_torch.models import model as TM
from repro_torch.models import rglru as trg
from test_torch_model import _pair

NAME = "recurrentgemma-9b"
TOL = 2e-5
CACHE_TOL = 1e-5
W = 16          # the reduced local window


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.fixture(scope="module")
def jitted(pair):
    """The reference's prefill and decode step, compiled once a shape
    (eager JAX over the unrolled hybrid layers is slow)."""
    jcfg = pair[0]
    return (jax.jit(lambda p, t, c, sl: JM.prefill(jcfg, p, t, c,
                                                   seq_lens=sl)),
            jax.jit(lambda p, t, c: JM.decode_step(jcfg, p, t, c)))


@pytest.fixture(scope="module")
def pair():
    jcfg, jp, tcfg, tp = _pair(NAME)
    assert tcfg.block_kinds() == ("rglru", "rglru", "local_attn")
    assert tcfg.rglru.local_window == W
    return jcfg, jp, tcfg, tp


def _rec(pair):
    """The first recurrent layer's block params in both packages."""
    jcfg, jp, tcfg, tp = pair
    return jcfg, jp["layers"][0]["rec"], tcfg, tp["layers"][0]["rec"]


# ======================================================================
# models/rglru.py
# ======================================================================
@pytest.mark.parametrize("S", [1, 2, 7, 33])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_matches_jax(pair, S, with_h0):
    _, jr, _, tr = _rec(pair)
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, 64)).astype(np.float32)
    h0 = rng.standard_normal((2, 64)).astype(np.float32) if with_h0 \
        else None
    jy, jh = jrg.rglru_scan(jr, jnp.asarray(x),
                            None if h0 is None else jnp.asarray(h0))
    ty, th = trg.rglru_scan(tr, torch.from_numpy(x),
                            None if h0 is None else torch.from_numpy(h0))
    assert ty.dtype == torch.float32 and ty.shape == (2, S, 64)
    _close(ty, jy)
    _close(th, jh)


def test_linear_scan_is_the_recurrence():
    """The log-step scan equals h_t = a_t h_{t-1} + b_t run token by
    token, and its first output is the running product of a."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 37, 5))).float()
    b = torch.from_numpy(rng.standard_normal((2, 37, 5))).float()
    aa, h = trg._linear_scan(a.clone(), b.clone())   # it overwrites them
    want, run = [], torch.zeros(2, 5)
    for t in range(37):
        run = a[:, t] * run + b[:, t]
        want.append(run)
    torch.testing.assert_close(h, torch.stack(want, 1), rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(aa, torch.cumprod(a, 1), rtol=1e-6,
                               atol=1e-6)


def test_rglru_step_matches_jax(pair):
    _, jr, _, tr = _rec(pair)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 1, 64)).astype(np.float32)
    h = rng.standard_normal((3, 64)).astype(np.float32)
    jy, jh = jrg.rglru_step(jr, jnp.asarray(x), jnp.asarray(h))
    ty, th = trg.rglru_step(tr, torch.from_numpy(x), torch.from_numpy(h))
    _close(ty, jy)
    _close(th, jh)


@pytest.mark.parametrize("S", [2, 3, 12])
def test_recurrent_block_matches_jax(pair, S):
    """The block over a prompt from an empty conv cache (S 2 is shorter
    than the conv's 3-token tail: the new tail keeps a zero row), then
    three single tokens from the caches it left."""
    jcfg, jr, tcfg, tr = _rec(pair)
    rng = np.random.default_rng(5 + S)
    x = rng.standard_normal((2, S, 64)).astype(np.float32)
    jo, (jc, jh) = jrg.recurrent_block_forward(jr, jcfg, jnp.asarray(x))
    to, (tc, th) = trg.recurrent_block_forward(tr, tcfg, torch.from_numpy(x))
    _close(to, jo)
    _close(tc, jc, CACHE_TOL)
    _close(th, jh)
    assert tc.shape == (2, 3, 64)
    if S < 3:
        assert not tc[:, 0].any()
    for _ in range(3):
        x1 = rng.standard_normal((2, 1, 64)).astype(np.float32)
        jo, (jc, jh) = jrg.recurrent_block_decode(jr, jcfg, jnp.asarray(x1),
                                                  jc, jh)
        to, (tc, th) = trg.recurrent_block_decode(tr, tcfg,
                                                  torch.from_numpy(x1), tc,
                                                  th)
        _close(to, jo)
        _close(tc, jc, CACHE_TOL)
        _close(th, jh)


# ======================================================================
# the ring-cache model
# ======================================================================
HYBRID_CASES = [  # S, capacity, seq_lens
    (W - 1, 64, (W - 1,)),           # shorter than the window
    (W, 64, (W, 9)),                 # the window, a padded row
    (W + 1, 64, (W + 1,)),           # one past: the ring drops position 0
    (40, 64, (40, 29)),              # far past, a padded row
    (W, W, (W,)),                    # W == S: the position-aligned write
    (2, 64, (2,)),                   # shorter than the conv's tail
]


@pytest.mark.parametrize("S,capacity,seq_lens", HYBRID_CASES)
def test_hybrid_prefill_decode_match_jax(pair, jitted, S, capacity,
                                        seq_lens):
    """Prefill, then 18 decode steps (past the window: the ring wraps
    and the decode mask keeps exactly the last W positions)."""
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
    assert tc["kv_pos"].shape == (B, min(capacity, W))
    for step in range(19):
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
    plain version): bit for bit, the recurrent state included."""
    _, _, tcfg, tp = pair
    tok = torch.from_numpy(np.random.default_rng(9).integers(0, 331, (1, 30)))
    got = TM.prefill(tcfg, tp, tok, TM.init_cache(tcfg, 1, 64, "cpu"))
    want = TM.prefill(tcfg, tp, tok, TM.init_cache(tcfg, 1, 64, "cpu"),
                      plain=True)
    assert torch.equal(got[0], want[0])
    for k in got[1]:
        assert torch.equal(got[1][k], want[1][k]), k


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_hybrid_tree_and_cache_match_jax(param_dtype):
    """The port's init gives the reference's tree (a list of mixed
    layers), shapes and types; the carried tree keeps ``w_a``, ``b_a``,
    ``w_x``, ``b_x`` and ``lam`` f32 at bf16; the caches agree."""
    jcfg = j_reduced(j_get_config(NAME), layers=2, d_model=64,
                     vocab=331).replace(param_dtype=param_dtype,
                                        dtype=param_dtype)
    tcfg = reduced(get_config(NAME), layers=2, d_model=64,
                   vocab=331).replace(param_dtype=param_dtype,
                                      dtype=param_dtype)
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jp)
    mine = TM.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert isinstance(mine["layers"], list) and len(mine["layers"]) == 3
    got = jax.tree.map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")),
        mine)
    assert got == want
    carried = TM.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                                   getattr(torch, param_dtype))
    rec = carried["layers"][0]["rec"]
    for k in ("w_a", "b_a", "w_x", "b_x", "lam"):
        assert rec[k].dtype == torch.float32, k
    assert rec["in_rec"].dtype == getattr(torch, param_dtype)
    assert rec["w_a"].shape == (16, 4, 4)
    jc = JM.init_cache(jcfg, 3, 40)
    tc = TM.init_cache(tcfg, 3, 40, "cpu")
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in tc.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in jc.items()}
