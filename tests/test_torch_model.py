"""The port's ring-cache model against the JAX package's: ``prefill`` and
``decode_step`` of the dense and ssm families, on the reduced configs
(two layers, d_model 64, f32), with JAX's weights carried across by
``params_from_numpy``.

The zero-initialised leaves (norm scales, biases) get random values so
the test exercises them. Logits must agree within 1e-4, the cache
leaves within 1e-5 (XLA and ATen sum in different orders), and the
integer leaves (``len``, ``kv_pos``) exactly. The dense prefill attends
through ``flash_prefill`` (its plain version on the CPU) where the
reference uses its masked einsum attention; the ssm prefill scans
through ``ssd_scan`` (the model's ``ssd_chunked``).
"""
import dataclasses

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

LOGIT_TOL = 1e-4
CACHE_TOL = 1e-5


def _pair(name, seed=0, ssm=None, **kw):
    """``ssm``: fields of the mixer config to replace in both."""
    jcfg = j_reduced(j_get_config(name), layers=2, d_model=64,
                     vocab=331).replace(**kw)
    tcfg = reduced(get_config(name), layers=2, d_model=64,
                   vocab=331).replace(**kw)
    if ssm:
        jcfg = jcfg.replace(ssm=dataclasses.replace(jcfg.ssm, **ssm))
        tcfg = tcfg.replace(ssm=dataclasses.replace(tcfg.ssm, **ssm))
    rng = np.random.default_rng(seed)
    jp = jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape))
        .astype(a.dtype), j_init_params(jcfg, jax.random.PRNGKey(seed)))
    return jcfg, jp, tcfg, TM.params_from_numpy(jp, "cpu")


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _run_both(pair, S, capacity, seq_lens, steps):
    """prefill then ``steps`` decode steps in both frameworks; returns
    [(j_logits, t_logits, j_cache, t_cache)] after each call."""
    jcfg, jp, tcfg, tp = pair
    B = len(seq_lens)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab_size, size=(B, S))
    sl = np.asarray(seq_lens, np.int32)
    jc = JM.init_cache(jcfg, B, capacity)
    jl, jc = JM.prefill(jcfg, jp, jnp.asarray(tokens), jc,
                        seq_lens=jnp.asarray(sl))
    tc = TM.init_cache(tcfg, B, capacity, "cpu")
    tl, tc = TM.prefill(tcfg, tp, torch.from_numpy(tokens), tc,
                        seq_lens=torch.from_numpy(sl))
    out = [(jl, tl, dict(jc), {k: v.clone() for k, v in tc.items()})]
    for _ in range(steps):
        nxt = rng.integers(0, jcfg.vocab_size, size=(B,))
        jl, jc = JM.decode_step(jcfg, jp, jnp.asarray(nxt), jc)
        tl, tc = TM.decode_step(tcfg, tp, torch.from_numpy(nxt), tc)
        out.append((jl, tl, dict(jc), {k: v.clone() for k, v in tc.items()}))
    return out


def _check(out):
    for jl, tl, jc, tc in out:
        assert tl.shape == jl.shape and tl.dtype == torch.float32
        _close(tl, jl, LOGIT_TOL)
        assert set(tc) == set(jc)
        for name in tc:
            want = np.asarray(jc[name])
            if name in ("len", "kv_pos"):
                assert np.array_equal(tc[name].numpy(), want), name
            else:
                # padded rows' dropped slots stay zero in both
                _close(tc[name], want, CACHE_TOL)


DENSE_CASES = [  # S, capacity, seq_lens, sliding_window
    (9, 32, (9, 5), None),        # ring larger than the prompt, a pad row
    (12, 12, (12, 7), None),      # W == S: the position-aligned write
    (20, 8, (20, 13), None),      # S > W: the ring drops the oldest
    (20, 64, (20, 11), 8),        # sliding window: W = 8, flash window
]


@pytest.mark.parametrize("S,capacity,seq_lens,window", DENSE_CASES)
def test_dense_prefill_decode_match_jax(S, capacity, seq_lens, window):
    pair = _pair("qwen2-1.5b", sliding_window=window)
    _check(_run_both(pair, S, capacity, seq_lens, steps=4))


@pytest.mark.parametrize("S,seq_lens", [(21, (21, 21)), (32, (32,)),
                                        (7, (7,))])
def test_ssm_prefill_decode_match_jax(S, seq_lens):
    """Lengths 21 and 7 are no multiple of the reduced chunk (16): the
    padding path of ``mamba2_forward`` runs."""
    pair = _pair("mamba2-1.3b")
    _check(_run_both(pair, S, 64, seq_lens, steps=4))


@pytest.mark.parametrize("S,seq_lens", [(21, (21, 9)), (32, (32,))])
def test_ssm_groups_prefill_decode_match_jax(S, seq_lens):
    """Two groups of B/C over the reduced model's eight heads: the port
    hands ``ssd_scan`` B and C per group and the reference repeats them
    over the heads, so the logits agree only if head h reads group
    h // 4 in both."""
    pair = _pair("mamba2-1.3b", ssm=dict(num_groups=2))
    assert pair[2].ssm.num_groups == 2
    assert pair[2].d_model * pair[2].ssm.expand // pair[2].ssm.head_dim == 8
    _check(_run_both(pair, S, 64, seq_lens, steps=4))


def test_ring_write_drops_sentinel_slots():
    """Slot W (outside the ring or past a row's length) is dropped as
    the reference's ``mode="drop"`` scatter drops it: a prompt of
    S > W with a padding row, against JAX's ``_ring_write``."""
    B, S, W = 3, 11, 4
    rng = np.random.default_rng(5)
    pos = np.broadcast_to(np.arange(S), (B, S))
    valid = pos < np.array([11, 6, 0])[:, None]
    slots = np.where((pos >= S - W) & valid, pos % W, W)
    new = rng.standard_normal((B, S, 2, 3)).astype(np.float32)
    buf = rng.standard_normal((B, W, 2, 3)).astype(np.float32)
    want = JM._ring_write(jnp.asarray(buf), jnp.asarray(slots),
                          jnp.asarray(new))
    got = TM._ring_write(torch.from_numpy(buf.copy()),
                         torch.from_numpy(slots), torch.from_numpy(new))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got[2].numpy(), buf[2])   # all-padding row


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_params_from_numpy_keeps_mixer_f32_leaves(param_dtype):
    """The mamba2 tree carries across leaf for leaf; cast to bf16, its
    ``A_log``, ``D`` and ``dt_bias`` stay f32 as in the reference."""
    jcfg = j_reduced(j_get_config("mamba2-1.3b"), layers=2, d_model=64,
                     vocab=331).replace(param_dtype=param_dtype)
    jp = jax.tree.map(np.asarray, j_init_params(jcfg,
                                                jax.random.PRNGKey(0)))
    for tp in (TM.params_from_numpy(jp, "cpu"),
               TM.params_from_numpy(jp, "cpu", torch.bfloat16)):
        for path, a in jax.tree_util.tree_leaves_with_path(jp):
            t = tp
            for k in path:
                t = t[k.key]
            assert tuple(t.shape) == a.shape
            key = path[-1].key
            if key in TM.F32_LEAVES:
                assert a.dtype == np.float32 and t.dtype == torch.float32
                assert np.array_equal(t.numpy(), a)
    # the port's own init gives the same tree, shapes and dtypes
    tcfg = reduced(get_config("mamba2-1.3b"), layers=2, d_model=64,
                   vocab=331).replace(param_dtype=param_dtype)
    mine = TM.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    got = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)), mine))
    want = jax.tree_util.tree_leaves_with_path(jax.tree.map(
        lambda a: (a.shape, "torch." + str(a.dtype)), jp))
    assert got == want


@pytest.mark.parametrize("kw", [dict(attention_impl="surrogate"),
                                dict(family="hybrid"), dict(family="moe"),
                                dict(family="encdec")])
def test_unported_model_options_raise(kw):
    cfg = reduced(get_config("qwen2-1.5b"), layers=2, d_model=64,
                  vocab=331).replace(**kw)
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        TM.init_cache(cfg, 1, 16, "cpu")
    dense = reduced(get_config("qwen2-1.5b"), layers=2, d_model=64,
                    vocab=331)
    tp = TM.init_params(dense, torch.Generator().manual_seed(0), "cpu")
    cache = TM.init_cache(dense, 1, 16, "cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        TM.prefill(dense, tp, torch.zeros((1, 4), dtype=torch.int64),
                   cache, prefix_len=torch.tensor([2]))
