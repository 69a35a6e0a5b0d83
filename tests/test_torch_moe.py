"""The port's moe layer (``repro_torch/models/moe.py``) against the JAX
package's ``repro/models/moe.py``, function by function, on seeded numpy
inputs handed to both.

Routing is checked exactly where it is discrete (the chosen experts,
the capacity, the dispatch tables) and to the type's tolerance where it
is arithmetic: f32 2e-5 (XLA and ATen sum in other orders; the port's
router product is computed in f64 and rounded, so it cannot take TF32
on the card), bf16 2e-2 (the expert products round to bf16 at other
places in the two frameworks). The batches include runs of identical
padding-like rows, which tie on every expert and are the case where the
stable sort's order decides who keeps capacity.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import moe as jmoe
from repro_torch.configs import get_config, reduced
from repro_torch.models import moe as tmoe

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
D, F = 32, 48


def _x(rng, T, pad_rows):
    """[T, D] f32 rows; the last ``pad_rows`` all equal (a padding
    token's embedding repeated)."""
    x = rng.standard_normal((T, D)).astype(np.float32)
    if pad_rows:
        x[T - pad_rows:] = x[T - pad_rows - 1]
    return x


def _router(rng, E):
    return (rng.standard_normal((D, E)) / np.sqrt(D)).astype(np.float32)


def _j(a, dtype="float32"):
    return jnp.asarray(a, getattr(jnp, dtype))


def _t(a, dtype="float32"):
    return torch.from_numpy(np.asarray(a)).to(getattr(torch, dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,k", [(4, 1), (4, 2), (16, 1), (16, 2)])
def test_route_matches_jax(E, k, dtype):
    """Weights, chosen experts and the aux loss; x in either type, the
    router f32."""
    rng = np.random.default_rng(E * 10 + k)
    x, w = _x(rng, 40, 12), _router(rng, E)
    jw, js, ja = jmoe.route(_j(w), _j(x, dtype), k)
    tw, ts, ta = tmoe.route(_t(w), _t(x, dtype), k)
    assert tw.dtype == torch.float32
    assert np.array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tw.numpy(), _np(jw), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(float(ta), float(ja), rtol=2e-5, atol=2e-5)


def test_route_ties_take_the_lower_expert():
    """Equal probabilities (a zero router) pick experts 0, 1, ... in
    order, as ``jax.lax.top_k`` does."""
    x = np.ones((3, D), np.float32)
    w = np.zeros((D, 8), np.float32)
    _, js, _ = jmoe.route(_j(w), _j(x), 3)
    _, ts, _ = tmoe.route(_t(w), _t(x), 3)
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert ts.tolist() == [[0, 1, 2]] * 3


def test_capacity_matches_jax():
    for T in (1, 3, 8, 37, 128, 1000):
        for k in (1, 2):
            for E in (4, 16):
                for cf in (0.25, 1.25, 8.0):
                    assert tmoe._capacity(T, k, E, cf) == \
                        jmoe._capacity(T, k, E, cf)


def test_device_capacity_matches_host():
    """The capacity of a device count (the masked path's, no host sync)
    equals ``_capacity`` of the same count."""
    for k in (1, 2):
        for E in (4, 16):
            for cf in (0.25, 1.25, 8.0):
                n = torch.arange(0, 1200)
                got = tmoe._capacity_of(n, k, E, cf).tolist()
                assert got == [tmoe._capacity(int(t), k, E, cf)
                               for t in n], (k, E, cf)


@pytest.mark.parametrize("cf", [0.25, 1.25, 8.0])
@pytest.mark.parametrize("E,k", [(4, 1), (4, 2), (16, 2)])
def test_build_dispatch_matches_jax(E, k, cf):
    """The [E, C] tables equal exactly, from the same routing (a batch
    whose last rows all pick the same experts)."""
    rng = np.random.default_rng(7)
    T = 48
    sel = np.stack([rng.permutation(E)[:k] for _ in range(T)])
    sel[T - 20:] = sel[T - 21]
    wts = rng.random((T, k)).astype(np.float32)
    C = jmoe._capacity(T, k, E, cf)
    jt, jw = jmoe.build_dispatch(jnp.asarray(sel, jnp.int32), _j(wts), E, C)
    tt, tw = tmoe.build_dispatch(torch.from_numpy(sel), _t(wts), E, C)
    assert tt.shape == (E, C)
    assert np.array_equal(tt.numpy(), np.asarray(jt))
    assert np.array_equal(tw.numpy(), np.asarray(jw))


def _expert_params(rng, E, dtype, shared=False):
    p = {"w_gate": rng.standard_normal((E, D, F)) / np.sqrt(D),
         "w_up": rng.standard_normal((E, D, F)) / np.sqrt(D),
         "w_down": rng.standard_normal((E, F, D)) / np.sqrt(F),
         "router": _router(rng, E)}
    if shared:
        p["shared"] = {"w_gate": rng.standard_normal((D, F)) / np.sqrt(D),
                       "w_up": rng.standard_normal((D, F)) / np.sqrt(D),
                       "w_down": rng.standard_normal((F, D)) / np.sqrt(F)}
    p = jax.tree.map(lambda a: np.asarray(a, np.float32), p)

    def conv(fn, tree, key=None):
        if isinstance(tree, dict):
            return {k: conv(fn, v, k) for k, v in tree.items()}
        return fn(tree, "float32" if key == "router" else dtype)
    return conv(_j, p), conv(_t, p)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expert_ffn_matches_jax(dtype):
    rng = np.random.default_rng(3)
    jp, tp = _expert_params(rng, 4, dtype)
    xe = rng.standard_normal((4, 12, D)).astype(np.float32)
    got = tmoe.expert_ffn(tp, _t(xe, dtype))
    want = jmoe.expert_ffn(jp, _j(xe, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("k", [2, 6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_combine_matches_index_add_and_jax(dtype, k):
    """The combine adds each token's kept slots in ascending expert
    order onto a zero row, as the reference's ``.at[].add`` over the
    flat (e, c) slots does: equal bit for bit at top_k 2 and 6 (the
    tables from ``build_dispatch`` at cf 1.25, some slots dropped, its
    token slots the port's), in f32 and bf16. ``index_add_`` on the CPU,
    the earlier combine, gives the same bits in f32 and at top_k 2; in
    bf16 from top_k 3 on it rounds a token's sum once, not once an add,
    so there it differs from both (it is not compared)."""
    rng = np.random.default_rng(11 + k)
    E, T, d = 16, 40, 24
    sel = np.stack([rng.permutation(E)[:k] for _ in range(T)])
    wts = rng.random((T, k)).astype(np.float32)
    C = jmoe._capacity(T, k, E, 1.25)
    tok, _ = jmoe.build_dispatch(jnp.asarray(sel, jnp.int32), _j(wts), E, C)
    tok = np.asarray(tok)
    assert (tok == T).any() and np.bincount(tok.ravel())[:T].max() == k
    tt, _, slots = tmoe.build_dispatch(torch.from_numpy(sel), _t(wts), E,
                                       C, slots=True)
    assert np.array_equal(tt.numpy(), tok)
    # each token's kept slots, ascending, then E * C for the dropped
    for t in range(T):
        kept = np.flatnonzero(tok.reshape(-1) == t)
        assert slots[t].tolist() == kept.tolist() + [E * C] * (k - len(kept))
    contrib = rng.standard_normal((E, C, d)).astype(np.float32) * 8
    want = jnp.zeros((T + 1, d), getattr(jnp, dtype)).at[
        tok.reshape(-1)].add(_j(contrib, dtype).reshape(-1, d))[:T]
    got = tmoe.combine(slots, _t(contrib, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == (T, d)
    assert np.array_equal(_np(got), _np(want))
    if dtype == "float32" or k <= 2:
        y = torch.zeros((T + 1, d), dtype=getattr(torch, dtype))
        y.index_add_(0, torch.from_numpy(tok).long().reshape(-1),
                     _t(contrib, dtype).reshape(-1, d))
        assert torch.equal(got, y[:T])


def _cfgs(E, k, cf, shared):
    def one(get, red):
        cfg = red(get("phi3.5-moe-42b-a6.6b"), layers=2, d_model=D,
                  vocab=64)
        return cfg.replace(moe=dataclasses.replace(
            cfg.moe, num_experts=E, top_k=k, capacity_factor=cf,
            num_shared_experts=int(shared), d_ff_expert=F))
    return one(j_get_config, j_reduced), one(get_config, reduced)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shared", [False, True], ids=["routed", "shared"])
@pytest.mark.parametrize("cf", [0.25, 1.25, 8.0])
@pytest.mark.parametrize("E,k", [(4, 2), (16, 1), (16, 2)])
def test_moe_local_matches_jax(E, k, cf, shared, dtype):
    """x [4, 12, d] whose last 26 tokens are one repeated padding-like
    row: at cf 0.25 and 1.25 they take capacity real tokens would need,
    in both packages alike."""
    rng = np.random.default_rng(E + k)
    jcfg, tcfg = _cfgs(E, k, cf, shared)
    jp, tp = _expert_params(rng, E, dtype, shared)
    x = _x(rng, 48, 26).reshape(4, 12, D)
    ty, ta = tmoe.moe_local(tp, _t(x, dtype), tcfg)
    jy, ja = jmoe.moe_local(jp, _j(x, dtype), jcfg)
    assert ty.dtype == getattr(torch, dtype) and ty.shape == (4, 12, D)
    np.testing.assert_allclose(_np(ty), _np(jy), rtol=TOL[dtype],
                               atol=TOL[dtype])
    np.testing.assert_allclose(float(ta), float(ja), rtol=2e-5, atol=2e-5)
    via_apply = tmoe.moe_apply(tp, _t(x, dtype), tcfg)[0]
    assert torch.equal(via_apply, ty)


def test_padding_takes_capacity():
    """The reference's behaviour the port keeps: at cf 1.25 the repeated
    padding rows, ranked first, fill their two experts, so a real token
    that picked the same experts is dropped (its output 0) though it
    would be kept in a batch without them."""
    rng = np.random.default_rng(11)
    E, k, cf = 16, 2, 1.25
    _, tcfg = _cfgs(E, k, cf, False)
    _, tp = _expert_params(rng, E, "float32")
    pad = rng.standard_normal(D).astype(np.float32)
    _, sel_pad, _ = tmoe.route(tp["router"], _t(pad[None]), k)
    # a real token that routes to the padding token's experts
    real = None
    for _ in range(5000):
        cand = rng.standard_normal(D).astype(np.float32)
        _, s, _ = tmoe.route(tp["router"], _t(cand[None]), k)
        if set(s[0].tolist()) == set(sel_pad[0].tolist()):
            real = cand
            break
    assert real is not None
    x = np.concatenate([np.repeat(pad[None], 40, 0), real[None],
                        rng.standard_normal((7, D)).astype(np.float32)])
    y, _ = tmoe.moe_local(tp, _t(x).reshape(1, 48, D), tcfg)
    assert torch.count_nonzero(y[0, 40]) == 0       # dropped
    alone, _ = tmoe.moe_local(tp, _t(x[40:]).reshape(1, 8, D), tcfg)
    assert torch.count_nonzero(alone[0, 0]) > 0     # kept without padding


@pytest.mark.parametrize("shared", [False, True], ids=["routed", "shared"])
@pytest.mark.parametrize("cf", [0.25, 1.25])
@pytest.mark.parametrize("E,k", [(4, 2), (16, 1), (16, 2)])
def test_moe_local_with_mask_matches_jax_on_packed_tokens(E, k, cf, shared):
    """``moe_local(x, valid)`` on x [4, 12, d] under random masks of 14
    and 37 valid tokens equals the reference's ``moe_local`` run on the
    packed valid tokens alone (one row of T = their count), scattered
    back, with zeros from the routed experts at the padding (the shared
    experts' output there)."""
    rng = np.random.default_rng(100 + E + k)
    jcfg, tcfg = _cfgs(E, k, cf, shared)
    jp, tp = _expert_params(rng, E, "float32", shared)
    x = _x(rng, 48, 0).reshape(4, 12, D)
    for n in (14, 37):
        idx = np.sort(rng.choice(48, n, replace=False))
        valid = np.zeros(48, bool)
        valid[idx] = True
        valid = valid.reshape(4, 12)
        packed = x.reshape(48, D)[idx][None]
        jy, _ = jmoe.moe_local(jp, _j(packed), jcfg)
        want = np.zeros((48, D), np.float32)
        want[idx] = _np(jy)[0]
        if shared:
            want[~valid.reshape(-1)] = _np(jmoe.mlp_apply(
                jp["shared"], _j(x.reshape(48, D)[~valid.reshape(-1)]),
                "swiglu"))
        ty, _ = tmoe.moe_local(tp, _t(x), tcfg, torch.from_numpy(valid))
        np.testing.assert_allclose(_np(ty).reshape(48, D), want,
                                   rtol=TOL["float32"], atol=TOL["float32"])
        via_apply = tmoe.moe_apply(tp, _t(x), tcfg,
                                   valid=torch.from_numpy(valid))[0]
        assert torch.equal(via_apply, ty)


def test_moe_local_mask_edges():
    """An all-true mask is bit for bit no mask; an all-false one routes
    nothing (zeros, or the shared experts' output)."""
    rng = np.random.default_rng(12)
    for shared in (False, True):
        _, tcfg = _cfgs(16, 2, 1.25, shared)
        _, tp = _expert_params(rng, 16, "float32", shared)
        x = _t(_x(rng, 24, 10).reshape(2, 12, D))
        y, _ = tmoe.moe_local(tp, x, tcfg)
        y_all, _ = tmoe.moe_local(tp, x, tcfg, torch.ones(2, 12, dtype=bool))
        assert torch.equal(y_all, y)
        y_none, _ = tmoe.moe_local(tp, x, tcfg,
                                   torch.zeros(2, 12, dtype=bool))
        want = tmoe.mlp_apply(tp["shared"], x, "swiglu") if shared \
            else torch.zeros_like(x)
        assert torch.equal(y_none, want)


def test_masked_padding_takes_no_capacity():
    """The case of ``test_padding_takes_capacity`` with the padding
    masked out: the real token is kept, its output the one it gets in a
    batch of the real tokens alone, whatever the padding rows hold."""
    rng = np.random.default_rng(11)
    E, k = 16, 2
    _, tcfg = _cfgs(E, k, 1.25, False)
    _, tp = _expert_params(rng, E, "float32")
    x = rng.standard_normal((48, D)).astype(np.float32)
    valid = np.zeros(48, bool)
    valid[40:] = True
    alone, _ = tmoe.moe_local(tp, _t(x[40:]).reshape(1, 8, D), tcfg)
    for pad in (x[:40], np.zeros((40, D), np.float32),
                np.repeat(x[:1], 40, 0)):
        x[:40] = pad
        y, _ = tmoe.moe_local(tp, _t(x).reshape(1, 48, D), tcfg,
                              torch.from_numpy(valid)[None])
        assert torch.equal(y[0, 40:], alone[0])
        assert torch.count_nonzero(y[0, :40]) == 0


def test_moe_init_tree_matches_jax():
    """The port's init gives the reference's tree, shapes and types: the
    router f32 at a bf16 ``param_dtype``."""
    jcfg, tcfg = _cfgs(16, 2, 1.25, True)
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jmoe.moe_init(
        jax.random.PRNGKey(0), jcfg, jnp.bfloat16))
    got = jax.tree.map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")),
        tmoe.moe_init(torch.Generator().manual_seed(0), tcfg,
                      torch.bfloat16, "cpu"))
    assert got == want
    assert got["router"] == ((D, 16), "float32")


def test_moe_apply_on_a_mesh_raises():
    _, tcfg = _cfgs(4, 2, 1.25, False)
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        tmoe.moe_apply({}, torch.zeros(1, 2, D), tcfg, mesh=object())
