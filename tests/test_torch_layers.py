"""The port's dense layers against the JAX package's, on the tiny config
the engine tests use, with JAX's weights carried across by
``params_from_numpy``.

Tolerance is 1e-5 in f32: XLA and ATen sum the products (and reduce the
norms) in different orders, so results agree to f32 rounding, not bit
for bit.
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
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import get_config, reduced
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

TOL = 1e-5


def _cfgs(**kw):
    jcfg = j_reduced(j_get_config("qwen2-1.5b"), layers=2, d_model=64,
                     vocab=331).replace(**kw)
    tcfg = reduced(get_config("qwen2-1.5b"), layers=2, d_model=64,
                   vocab=331).replace(**kw)
    return jcfg, tcfg


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _perturb(tree, seed):
    """Give zero-initialised leaves (norm scales, biases) random values
    so the test exercises them."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype),
        _np_tree(tree))


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = _cfgs()
    jp = _perturb(j_init_params(jcfg, jax.random.PRNGKey(0)), 0)
    return jcfg, tcfg, jp, TM.params_from_numpy(jp, "cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def test_config_matches_reference():
    """The copied registry gives the same qwen2-1.5b and the same
    reduced() variant as the reference's."""
    full = dataclasses.asdict(get_config("qwen2-1.5b"))
    assert full == dataclasses.asdict(j_get_config("qwen2-1.5b"))
    jcfg, tcfg = _cfgs()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.activation_dtype() is torch.float32
    assert get_config("qwen2-1.5b").activation_dtype() is torch.bfloat16


def test_rms_norm(tiny):
    x = _x(1, 2, 5, 64)
    w = _x(2, 64) * 0.1
    _close(TL.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))


def test_apply_rope():
    x = _x(3, 2, 5, 4, 16)
    pos = np.array([[0, 1, 2, 3, 4], [7, 9, 30, 31, 200]], np.int32)
    _close(TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                         1e6),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6))


@pytest.mark.parametrize("qk_norm", [False, True])
def test_attn_project_qkv_and_output(qk_norm):
    jcfg, tcfg = _cfgs(qk_norm=qk_norm)
    assert jcfg.qkv_bias
    jp = _perturb(JL.attn_init(jax.random.PRNGKey(1), jcfg, jnp.float32), 1)
    tp = TM.params_from_numpy(jp, "cpu")
    x = _x(4, 2, 3, 64)
    pos = np.array([[0, 1, 2], [5, 6, 7]], np.int32)
    want = JL.attn_project_qkv(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    got = TL.attn_project_qkv(tp, tcfg, torch.from_numpy(x),
                              torch.from_numpy(pos))
    for g, w in zip(got, want):
        _close(g, w)
    o = _x(5, 2, 3, tcfg.num_heads, tcfg.resolved_head_dim)
    _close(TL.attn_output(tp, torch.from_numpy(o)),
           JL.attn_output(jp, jnp.asarray(o)))


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "squared_relu",
                                  "gelu"])
def test_mlp_apply(kind):
    jp = _perturb(JL.mlp_init(jax.random.PRNGKey(2), 64, 192, kind,
                              jnp.float32), 2)
    tp = TM.params_from_numpy(jp, "cpu")
    x = _x(6, 2, 3, 64)
    _close(TL.mlp_apply(tp, torch.from_numpy(x), kind),
           JL.mlp_apply(jp, jnp.asarray(x), kind))


def test_mlp_block(tiny):
    jcfg, tcfg, jp, tp = tiny
    x = _x(7, 2, 3, 64)
    lj = jax.tree.map(lambda a: a[1], jp["layers"])
    lt = TM.layer_params(tp)[1]
    want, _ = JM._mlp_block(jcfg, lj, jnp.asarray(x), None)
    _close(TM._mlp_block(tcfg, lt, torch.from_numpy(x)), want)


@pytest.mark.parametrize("embed_scale", [False, True])
def test_embed(tiny, embed_scale):
    jcfg, tcfg, jp, tp = tiny
    jcfg = jcfg.replace(embed_scale=embed_scale)
    tcfg = tcfg.replace(embed_scale=embed_scale)
    tok = np.array([[0, 5, 330], [17, 17, 2]], np.int64)
    _close(TM._embed(tcfg, tp, torch.from_numpy(tok)),
           JM._embed(jcfg, jp, jnp.asarray(tok)))


@pytest.mark.parametrize("tie,softcap", [(True, None), (True, 30.0),
                                         (False, None)])
def test_logits(tiny, tie, softcap):
    jcfg, tcfg = _cfgs(tie_embeddings=tie, logit_softcap=softcap)
    jp = _perturb(j_init_params(jcfg, jax.random.PRNGKey(3)), 3)
    tp = TM.params_from_numpy(jp, "cpu")
    assert ("unembed" in tp) == (not tie)
    x = _x(8, 2, 3, 64)
    got = TM._logits(tcfg, tp, torch.from_numpy(x))
    assert got.dtype == torch.float32
    _close(got, JM._logits(jcfg, jp, jnp.asarray(x)), tol=1e-4)


def test_params_from_numpy_layout_and_bf16_bits():
    """The converter keeps the pytree one to one (stacked layers, the
    optional layers_pre list) and moves bf16 bits unchanged."""
    jcfg = j_reduced(j_get_config("qwen2-1.5b"), layers=2, d_model=64,
                     vocab=331).replace(param_dtype="bfloat16")
    jp = _np_tree(j_init_params(jcfg, jax.random.PRNGKey(4)))
    jp["layers_pre"] = [jax.tree.map(lambda a: a[0], jp["layers"])]
    tp = TM.params_from_numpy(jp, "cpu")
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    for path, a in flat_j:
        t = tp
        for k in path:
            t = t[getattr(k, "key", getattr(k, "idx", None))]
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape
        assert np.array_equal(t.view(torch.int16).numpy(),
                              a.view(np.int16))
    assert len(TM.layer_params(tp)) == 3       # pre layer + 2 stacked
    f32 = TM.params_from_numpy(jp, "cpu", torch.float32)
    assert f32["embed"].dtype == torch.float32


def test_init_params_shapes_match_reference():
    """The port's own random init gives the reference's tree, shapes and
    dtypes (its numbers differ: another generator)."""
    jcfg, tcfg = _cfgs()
    jp = _np_tree(j_init_params(jcfg, jax.random.PRNGKey(0)))
    tp = TM.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    jl = jax.tree_util.tree_leaves_with_path(jp)
    tl = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: np.zeros(t.shape, np.float32), tp))
    assert [(p, a.shape) for p, a in jl] == [(p, a.shape) for p, a in tl]
    w = tp["layers"]["attn"]["wq"]
    assert w.abs().max() <= 2.0 / np.sqrt(64) + 1e-6     # truncated at 2σ
