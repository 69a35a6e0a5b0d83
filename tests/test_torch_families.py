"""The moe and vlm families (and qwen3-4b's dense stack with ``qk_norm``)
in the port, against the JAX package, at the reduced sizes (two layers,
d_model 64, f32) with JAX's weights carried across by
``params_from_numpy``:

- the ring-cache ``prefill``/``decode_step`` of reduced phi3.5-moe (with
  and without a leading dense layer), paligemma-3b (geglu, the embedding
  scale, one KV head) and qwen3-4b; logits within 2e-5 (XLA and ATen sum
  in other orders) and the same argmax;
- the paged engine on both planes, token for token the JAX engine's on
  the same plane (the seeded ``run_round`` trace of
  ``test_torch_engine.py``: eviction, reload, barge-in), and the moe
  config on the spec-3 and int8 planes;
- the 16-expert top-2 variant at the published capacity factor 1.25 on 8
  slots: the JAX engine routes a fused round's padding, which takes
  expert capacity, so some of its streams differ from B = 1 (a fault of
  the reference); the port routes only the real tokens, and its streams
  on both planes do not depend on what the padding holds (the Pallas
  kernel's value, random values). At a capacity factor of E / k no
  token can drop: every stream equals B = 1 and the JAX engine's;
- nemotron-4's head dim 192 (squared_relu) on the ring-cache model and
  both planes of the paged engine, and h2o-danube's head dim 80 under a
  window of 8 the prompts pass, on the ring-cache model;
- the config registry as data: every config of the reference; mla, the
  last family served, giving the reference's tree and logits.

The reference's norm scales start at zero, which makes every stream one
repeated token; the weights are perturbed as in
``test_torch_single_turn.py::test_engine_keeps_contract_on_perturbed_weights``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving.paged_engine as jpe
from repro.configs import get_config as j_get_config
from repro.configs import list_configs as j_list_configs
from repro.configs import reduced as j_reduced
from repro.models import init_params as j_init_params
from repro.models import model as JM
import repro_torch.serving.paged_engine as tpe
import torch_sharded_ranks as ranks
from repro_torch.configs import get_config, list_configs, reduced
from repro_torch.kernels import ref
from repro_torch.models import model as TM
from test_torch_engine import _close_taps, _drive_differential

LOGIT_TOL = 2e-5
VOCAB = 331
MOE = "phi3.5-moe-42b-a6.6b"
FAMILIES = {  # id: (config, changes to the reduced moe, and to the config)
    "moe": (MOE, {}, {}),
    "moe-dense1": (MOE, dict(first_dense_layers=1, d_ff_dense=128), {}),
    "vlm": ("paligemma-3b", {}, {}),
    "qwen3": ("qwen3-4b", {}, {}),
    # the published head dims 192 (nemotron-4, squared_relu) and 80
    # (h2o-danube, under a window the prompts pass, so the ring wraps)
    "nemotron": ("nemotron-4-340b", {}, dict(head_dim=192)),
    "danube": ("h2o-danube-1.8b", {}, dict(head_dim=80, sliding_window=8)),
}


def _reduced(get, red, name, moe_kw, cfg_kw=None):
    cfg = red(get(name), layers=2, d_model=64, vocab=VOCAB)
    if moe_kw:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe_kw))
    return cfg.replace(**(cfg_kw or {}))


def _pair(name, moe_kw=None, cfg_kw=None, seed=0):
    """(jcfg, jax params, tcfg, port params): the reference's weights
    with every leaf perturbed by 0.1 N(0, 1), carried across."""
    jcfg = _reduced(j_get_config, j_reduced, name, moe_kw, cfg_kw)
    tcfg = _reduced(get_config, reduced, name, moe_kw, cfg_kw)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    rng = np.random.default_rng(seed)
    jp = jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape))
        .astype(a.dtype), j_init_params(jcfg, jax.random.PRNGKey(seed)))
    return jcfg, jp, tcfg, TM.params_from_numpy(jp, "cpu")


@pytest.fixture(scope="module")
def pairs():
    """``pairs(fid)``: the pair of a ``FAMILIES`` entry, built once."""
    made = {}

    def get(fid):
        if fid not in made:
            made[fid] = _pair(*FAMILIES[fid])
        return made[fid]
    return get


# ======================================================================
# the ring-cache model
# ======================================================================
@pytest.mark.parametrize("fid", list(FAMILIES))
def test_ring_cache_prefill_decode_match_jax(pairs, fid):
    jcfg, jp, tcfg, tp = pairs(fid)
    if fid == "moe-dense1":
        assert len(tp["layers_pre"]) == 1 and "mlp" in tp["layers_pre"][0]
    if fid == "danube":
        assert TM.cache_window(tcfg, 32) == 8 and tcfg.resolved_head_dim == 80
    rng = np.random.default_rng(1)
    B, S, capacity = 2, 11, 32
    tokens = rng.integers(0, VOCAB, size=(B, S))
    sl = np.array([11, 6], np.int32)
    jc = JM.init_cache(jcfg, B, capacity)
    jl, jc = JM.prefill(jcfg, jp, jnp.asarray(tokens), jc,
                        seq_lens=jnp.asarray(sl))
    tc = TM.init_cache(tcfg, B, capacity, "cpu")
    tl, tc = TM.prefill(tcfg, tp, torch.from_numpy(tokens), tc,
                        seq_lens=torch.from_numpy(sl))
    for step in range(5):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
        assert np.array_equal(tl.argmax(-1).numpy(),
                              np.asarray(jl).argmax(-1)), step
        nxt = rng.integers(0, VOCAB, size=(B,))
        jl, jc = JM.decode_step(jcfg, jp, jnp.asarray(nxt), jc)
        tl, tc = TM.decode_step(tcfg, tp, torch.from_numpy(nxt), tc)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   rtol=1e-5, atol=1e-5)


def test_bf16_embed_scale_and_geglu_match_jax(pairs):
    """paligemma's bf16 pieces: the embedding scale rounds to bf16 before
    the product (bit for bit), and geglu's tanh gelu is
    ``jax.nn.gelu``'s default."""
    jcfg, jp, tcfg, _ = pairs("vlm")
    jcfg = jcfg.replace(dtype="bfloat16", param_dtype="bfloat16")
    tcfg = tcfg.replace(dtype="bfloat16", param_dtype="bfloat16")
    assert tcfg.embed_scale and tcfg.mlp_kind == "geglu"
    jb = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), jp)
    tb = TM.params_from_numpy(jb, "cpu")
    tok = np.array([[0, 5, 330], [17, 17, 2]], np.int64)
    want = np.asarray(JM._embed(jcfg, jb, jnp.asarray(tok)))
    got = TM._embed(tcfg, tb, torch.from_numpy(tok))
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
    x = np.random.default_rng(2).standard_normal((2, 3, 64)).astype(
        np.float32)
    lj = jax.tree.map(lambda a: a[0], jp["layers"])
    lt = TM.layer_params(TM.params_from_numpy(jp, "cpu"))[0]
    want, _ = JM._mlp_block(jcfg.replace(dtype="float32"), lj,
                            jnp.asarray(x), None)
    np.testing.assert_allclose(
        TM._mlp_block(tcfg, lt, torch.from_numpy(x)).numpy(),
        np.asarray(want), rtol=1e-5, atol=1e-5)


# ======================================================================
# the paged engine, both planes, against the JAX engine
# ======================================================================
ENGINE_FAMILIES = ["moe", "vlm", "qwen3", "nemotron"]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "tokenwise"])
@pytest.mark.parametrize("fid", ENGINE_FAMILIES)
def test_paged_engine_matches_jax(pairs, fid, fused):
    jcfg, jp, tcfg, tp = pairs(fid)
    want = _drive_differential(
        lambda **kw: jpe.PagedRealtimeEngine(jcfg, jp, **kw), jcfg, 0,
        fused=fused)
    got = _drive_differential(
        lambda **kw: tpe.PagedRealtimeEngine(tcfg, tp, device="cpu", **kw),
        tcfg, 0, fused=fused)
    assert got[0] == want[0], "token histories diverged"
    assert got[1] == want[1], "event streams diverged"
    assert got[2] == want[2], "turn stats diverged"
    assert got[3].offload_events == want[3].offload_events
    assert got[3].kv.reloaded_blocks == want[3].kv.reloaded_blocks >= 1
    # the perturbed weights give streams of more than one token
    assert max(len(set(sum(h, []))) for h in got[0].values()) > 2
    _close_taps(got[3].taps, want[3].taps)


@pytest.mark.parametrize("variant", ["spec", "int8"])
def test_moe_feature_planes_match_jax(pairs, variant):
    """The reference's ``_drive_trace`` (eviction, reload, barge-in) on
    the moe config with three-token drafts or the int8 wire tier, at a
    capacity factor of E / k: there no token drops, so the JAX engine's
    routing of the padded draft and chunk slots (ROADMAP.md queue 3)
    cannot part the streams."""
    jcfg, jp, tcfg, tp = pairs("moe")
    jcfg, tcfg = (c.replace(moe=dataclasses.replace(
        c.moe, capacity_factor=c.moe.num_experts / c.moe.top_k))
        for c in (jcfg, tcfg))
    kw = dict(ranks.GEOMETRY, **ranks.VARIANTS[variant])
    want = ranks.drive_trace(jpe.PagedRealtimeEngine(jcfg, jp, **kw), VOCAB)
    got = ranks.drive_trace(tpe.PagedRealtimeEngine(tcfg, tp, device="cpu",
                                                    **kw), VOCAB)
    for key in ("histories", "offload_events", "evicted", "reloaded",
                "turn_stats"):
        assert got[key] == want[key], key
    assert got["evicted"] > 0


def _fault_engine(make, vocab, rng_seed=5, max_new=(6,) * 8):
    """8 sessions on 8 slots, submitted at once, prompts of 5-16 tokens,
    chunks of up to 4 beside decode tokens, session i capped at
    ``max_new[i]`` tokens. Returns ({sid: tokens}, {sid: prompt})."""
    rng = np.random.default_rng(rng_seed)
    eng = make(slots=8, page_size=4, pages_per_seq=8, num_pages=80)
    prompts = {f"s{i}": rng.integers(0, vocab, size=int(n))
               for i, n in enumerate(rng.integers(5, 17, size=8))}
    slots = {eng.submit_turn(sid, p, max_new_tokens=n): sid
             for (sid, p), n in zip(prompts.items(), max_new)}
    rounds = 0
    while eng.active():
        grants = {}
        for slot, sid in slots.items():
            s = eng.slot_state[slot]
            if s is None or not s.request.is_live():
                continue
            r = s.request
            left = r.prompt_len - r.prefilled
            grants[slot] = min(4, left) if left > 0 else 1
        eng.run_round(grants)
        rounds += 1
        assert rounds < 200
    return {sid: eng.sessions[sid].history[-1] for sid in prompts}, prompts


def _greedy(cfg, params, prompt, n):
    cache = TM.init_cache(cfg, 1, 64, "cpu")
    lg, cache = TM.prefill(cfg, params, torch.from_numpy(prompt)[None],
                           cache)
    toks = [int(lg[0].argmax())]
    for _ in range(n - 1):
        lg, cache = TM.decode_step(cfg, params, torch.tensor([toks[-1]]),
                                   cache)
        toks.append(int(lg[0].argmax()))
    return toks


@pytest.fixture(scope="module")
def published_routing():
    """Reduced phi3.5-moe with the published routing: 16 experts, top-2,
    capacity factor 1.25."""
    return _pair(MOE, dict(num_experts=16, top_k=2, capacity_factor=1.25))


def _pallas_padded_slots(q, k_pages, v_pages, block_tables, q_start,
                         q_lens, **kw):
    """The fused attention with the padded query slots of live rows set
    to what the Pallas kernel leaves there: every key it walks scores
    the mask sentinel, so each weight is exp(0) = 1 and the slot gets
    the mean of V over the row's key blocks up to its post-write length
    (blocks of ``_default_kv_block(page)`` = page keys at these pages).
    The port's kernel writes zeros there, as its contract says."""
    out = ref.paged_prefill_attention_ref(q, k_pages, v_pages,
                                          block_tables, q_start, q_lens,
                                          **kw)
    B, Q, Hq, D = q.shape
    _, page, Hkv, _ = k_pages.shape
    for b in range(B):
        n = int(q_lens[b])
        if 0 < n < Q:
            keys = -(-(int(q_start[b]) + n) // page) * page
            v = v_pages[block_tables[b].long()].reshape(-1, Hkv, D)[:keys]
            mean = v.float().sum(0) / keys                  # [Hkv, D]
            out[b, n:] = mean.repeat_interleave(Hq // Hkv, 0).to(out.dtype)
    return out


def _random_padded_slots(seed):
    """The fused attention with every padded query slot (rows with
    q_lens 0 included) overwritten by seeded N(0, 1) values."""
    gen = torch.Generator().manual_seed(seed)

    def attend(q, k_pages, v_pages, block_tables, q_start, q_lens, **kw):
        out = ref.paged_prefill_attention_ref(q, k_pages, v_pages,
                                              block_tables, q_start, q_lens,
                                              **kw)
        for b, n in enumerate(q_lens.tolist()):
            out[b, n:] = torch.randn(out[b, n:].shape, generator=gen)
        return out
    return attend


def _random_padding_rows(seed):
    """The decode attention with every padding row (its table all the
    scratch page, the last physical page) overwritten by one seeded
    N(0, 10^2) draw a call: identical rows route alike and can fill
    their experts."""
    gen = torch.Generator().manual_seed(seed)

    def attend(q, k_pages, v_pages, block_tables, seq_lens, **kw):
        out = ref.paged_attention_ref(q, k_pages, v_pages, block_tables,
                                      seq_lens, **kw)
        fill = 10 * torch.randn(out.shape[1:], generator=gen)
        for b in range(out.shape[0]):
            if int(block_tables[b, 0]) == k_pages.shape[0] - 1:
                out[b] = fill
        return out
    return attend


def test_moe_padding_capacity_fault_fused_plane(published_routing,
                                                monkeypatch):
    """The JAX engine routes every token of a fused round, padding
    included, so some of its streams differ from B = 1. The port routes
    only the real tokens: its streams on both planes do not change when
    the padded query slots hold the Pallas kernel's value, or random
    values, instead of the port's kernel's zeros (and the padding rows
    of a per-token step random values)."""
    jcfg, jp, tcfg, tp = published_routing
    want, prompts = _fault_engine(
        lambda **kw: jpe.PagedRealtimeEngine(jcfg, jp, **kw), VOCAB)
    b1 = {sid: _greedy(tcfg, tp, p, 6) for sid, p in prompts.items()}
    # the reference's fault (ROADMAP.md queue 3, resolved in the port)
    assert sum(want[s] == b1[s] for s in prompts) < len(prompts)
    # the per-token plane takes turn 0's prompt through the dense graft,
    # so its steps are decode rows: slots 0-5 stop after one token and
    # leave six padding rows ahead of the two live ones
    held_back = (1,) * 6 + (16,) * 2
    for fused in (True, False):
        def run():
            return _fault_engine(
                lambda **kw: tpe.PagedRealtimeEngine(
                    tcfg, tp, device="cpu", fused_step=fused, **kw),
                VOCAB, max_new=(6,) * 8 if fused else held_back)[0]
        own = run()
        fills = ((_pallas_padded_slots, _random_padded_slots(1))
                 if fused else (_random_padding_rows(1),))
        for fill in fills:
            with monkeypatch.context() as m:
                m.setattr(tpe, "paged_prefill_attention" if fused
                          else "paged_attention", fill)
                assert run() == own, (fused, fill)


def test_moe_without_drops_equals_b1(published_routing):
    """At capacity factor E / k = 8 no token can drop: every fused stream
    of the same trace equals the B = 1 greedy one, and the JAX engine's
    stream."""
    jcfg, jp, tcfg, tp = published_routing
    cfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe,
                                               capacity_factor=8.0))
    got, prompts = _fault_engine(
        lambda **kw: tpe.PagedRealtimeEngine(cfg, tp, device="cpu", **kw),
        VOCAB)
    for sid, p in prompts.items():
        assert got[sid] == _greedy(cfg, tp, p, 6), sid
    jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe,
                                                capacity_factor=8.0))
    want, _ = _fault_engine(
        lambda **kw: jpe.PagedRealtimeEngine(jcfg, jp, **kw), VOCAB)
    assert got == want


# ======================================================================
# the registry, the tree, what stays out
# ======================================================================
def test_list_configs_matches_reference():
    assert list_configs() == j_list_configs()
    for name in list_configs():
        assert dataclasses.asdict(get_config(name)) == \
            dataclasses.asdict(j_get_config(name)), name


@pytest.mark.parametrize("name,family", [("deepseek-v2-236b", "mla")])
def test_unserved_families_raise(name, family):
    """mla, the last family the port did not serve, is served: the port's
    init gives the reference's tree, shapes and types, the leading dense
    layer in ``layers_pre`` and MLA's projections in every layer, and
    the reference's prefill logits on the carried weights, and so does
    the dry run's surrogate attention, once the last option the port
    refused."""
    cfg = reduced(get_config(name), layers=2, d_model=64, vocab=VOCAB)
    assert family in (cfg.family, "mla" if cfg.mla else None)
    jcfg = j_reduced(j_get_config(name), layers=2, d_model=64, vocab=VOCAB)
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    tp = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), tp) \
        == jax.tree.map(lambda a: (a.shape, str(a.dtype)), jp)
    assert set(tp["layers_pre"][0]["attn"]) == {
        "w_dq", "q_norm", "w_uq", "w_dkv", "kv_norm", "w_uk", "w_uv", "wo"}
    carried = TM.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tokens = np.random.default_rng(3).integers(0, VOCAB, size=(2, 9))
    want, _ = JM.prefill(jcfg, jp, jnp.asarray(tokens),
                         JM.init_cache(jcfg, 2, 16))
    got, _ = TM.prefill(cfg, carried, torch.from_numpy(tokens),
                        TM.init_cache(cfg, 2, 16, "cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    scfg = cfg.replace(attention_impl="surrogate")
    sp = TM.init_params(scfg, torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), sp) == \
        jax.tree.map(lambda t: tuple(t.shape), tp)
    want, _ = JM.prefill(jcfg.replace(attention_impl="surrogate"), jp,
                         jnp.asarray(tokens), JM.init_cache(jcfg, 2, 16))
    got, _ = TM.prefill(scfg, carried, torch.from_numpy(tokens),
                        TM.init_cache(scfg, 2, 16, "cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("fid", ["moe-dense1", "vlm"])
def test_init_params_tree_matches_jax(fid):
    """The port's init gives the reference's tree, shapes and types, the
    leading dense layer of a moe stack in ``layers_pre`` and the router
    f32 at a bf16 ``param_dtype``."""
    name, moe_kw, _ = FAMILIES[fid]
    jcfg = _reduced(j_get_config, j_reduced, name, moe_kw).replace(
        param_dtype="bfloat16")
    tcfg = _reduced(get_config, reduced, name, moe_kw).replace(
        param_dtype="bfloat16")
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                        j_init_params(jcfg, jax.random.PRNGKey(0)))
    tp = TM.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    got = jax.tree.map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), tp)
    assert got == want
    carried = TM.params_from_numpy(jax.tree.map(
        np.asarray, j_init_params(jcfg, jax.random.PRNGKey(0))), "cpu",
        torch.bfloat16)
    if fid == "moe-dense1":
        assert carried["layers"]["moe"]["router"].dtype == torch.float32
        assert carried["layers"]["moe"]["w_up"].dtype == torch.bfloat16
