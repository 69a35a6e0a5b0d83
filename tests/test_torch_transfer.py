"""The port's async chunked transfer plane against the JAX package's.

The single-device cases of ``tests/test_transfer_engine.py`` run on the
JAX engine and on the port's engine (CPU, plain kernel versions) with
the knobs set: ``async_transfers``, ``chunk_pages`` and
``transfer_chunks_per_round``. Each case asserts the reference's
expectations on the port and that both engines observe the same values:

- a preload drained chunk by chunk across decode rounds reloads the
  same bytes as the synchronous control, and the turn stalls only for
  what had not arrived;
- ``transfer_chunks_per_round`` bounds the chunks one round drains;
- eviction is copy-then-free, and allocation pressure drains it;
- a hang-up mid-transfer leaks nothing.
"""
import jax
import numpy as np
import pytest
import torch

import repro.serving.paged_engine as jpe
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import init_params as j_init_params
import repro_torch.serving.paged_engine as tpe
from repro_torch.configs import get_config, reduced
from repro_torch.models.model import params_from_numpy


@pytest.fixture(scope="module")
def tiny():
    jcfg = j_reduced(j_get_config("qwen2-1.5b"), layers=2, d_model=64,
                     vocab=331)
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = reduced(get_config("qwen2-1.5b"), layers=2, d_model=64,
                   vocab=331)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")

    def make(framework, **kw):
        kw.setdefault("slots", 2)
        kw.setdefault("page_size", 4)
        kw.setdefault("pages_per_seq", 8)
        kw.setdefault("num_pages", 32)
        kw.setdefault("chunk_pages", 1)
        if framework == "jax":
            return jpe.PagedRealtimeEngine(jcfg, jp, **kw)
        return tpe.PagedRealtimeEngine(tcfg, tp, device="cpu", **kw)
    return tcfg, make


def _slow_pcie(cfg, page_size=4):
    """gb/s such that one page takes 1.0 modeled seconds, far beyond the
    virtual clock's round ticks: only drained chunks come off the
    path."""
    bytes_per_token = 2 * cfg.num_layers * cfg.num_kv_heads \
        * cfg.resolved_head_dim * 4                    # f32 store
    return bytes_per_token * page_size / 1e9


def _page(eng, phys):
    k, v = eng.k_pages[:, phys], eng.v_pages[:, phys]
    if isinstance(k, torch.Tensor):
        return k.numpy(), v.numpy()
    return np.asarray(k), np.asarray(v)


def _drive_overlap(eng, prompts, *, rounds_during_speech):
    """a's turn 1; a's suffix evicted by hand and made durable; b
    decodes while a speaks and its preload drains; a's turn 2."""
    eng.add_session("a", prompts[0], max_new_tokens=6)
    eng.run_to_completion()
    assert eng.kv.evict(4, eng.clock.now()) == 4
    eng.flush_transfers()
    assert len(eng.pool.seq("a").offloaded) == 4
    eng.add_session("b", prompts[1], max_new_tokens=20)
    for _ in range(2):
        eng.step()
    per_page = eng.kv.channel.transfer_time(1)
    window = (4 * per_page + eng.preloader.encode_delay_s) / 0.8
    assert eng.user_speech_start("a", expected_dur_s=window) is not None
    inflight = eng.pool.inflight_pages("a")
    for _ in range(rounds_during_speech):
        eng.step()
    eng.start_turn("a", prompts[2], max_new_tokens=5)
    eng.run_to_completion()
    eng.check_invariants()
    return inflight, eng.sessions["a"].turn_stats[-1]


def test_chunked_reload_bit_exact_vs_synchronous(tiny):
    cfg, make = tiny
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab_size, size=14),
               rng.integers(0, cfg.vocab_size, size=6),
               rng.integers(0, cfg.vocab_size, size=4)]
    runs = {}
    for fw in ("torch", "jax"):
        for async_transfers in (True, False):
            eng = make(fw, async_transfers=async_transfers,
                       pcie_gb_s=_slow_pcie(cfg))
            runs[fw, async_transfers] = (eng, *_drive_overlap(
                eng, prompts, rounds_during_speech=3))
    a, a_inflight, a_st = runs["torch", True]
    s, s_inflight, s_st = runs["torch", False]
    assert a_inflight == (4, 0) and s_inflight == (0, 0)
    assert a.sessions["a"].history == s.sessions["a"].history
    assert a.sessions["b"].kv_len == s.sessions["b"].kv_len
    for sid in ("a", "b"):
        pa, ps = a.pool.seq(sid), s.pool.seq(sid)
        assert [p >= 0 for p in pa.pages] == [p >= 0 for p in ps.pages]
        for la, ls in zip(pa.pages, ps.pages):
            if la >= 0:
                for x, y in zip(_page(a, la), _page(s, ls)):
                    np.testing.assert_array_equal(x, y)
    assert a.transfer.stats.reload_pages_off_path == 3
    assert a.transfer.stats.reload_pages_on_path == 1
    assert s_st["reload_off_path_s"] < 0.1 < a_st["reload_off_path_s"]
    assert s_st["reload_stall_s"] > a_st["reload_stall_s"]
    for async_transfers in (True, False):
        t, t_inflight, t_st = runs["torch", async_transfers]
        j, j_inflight, j_st = runs["jax", async_transfers]
        assert t_inflight == j_inflight
        assert t.sessions["a"].history == j.sessions["a"].history
        assert t.sessions["a"].turn_stats == j.sessions["a"].turn_stats
        assert vars(t.transfer.stats) == vars(j.transfer.stats)


def test_run_round_respects_chunk_budget(tiny):
    cfg, make = tiny
    seen = {}
    for fw in ("torch", "jax"):
        rng = np.random.default_rng(14)
        eng = make(fw, transfer_chunks_per_round=2,
                   pcie_gb_s=_slow_pcie(cfg))
        eng.add_session("a", rng.integers(0, cfg.vocab_size, size=14),
                        max_new_tokens=4)
        eng.run_to_completion()
        assert eng.kv.evict(4, eng.clock.now()) == 4
        eng.flush_transfers()
        eng.add_session("b", rng.integers(0, cfg.vocab_size, size=6),
                        max_new_tokens=20)
        eng.step()
        eng.user_speech_start("a", expected_dur_s=100.0)
        pending = [eng.transfer.pending_reload_pages("a")]
        for _ in range(2):
            eng.step()
            pending.append(eng.transfer.pending_reload_pages("a"))
        seen[fw] = pending
    assert seen["torch"] == [4, 2, 0] == seen["jax"]


def test_offload_is_copy_then_free_and_demand_drained(tiny):
    """Rounds get no drain budget, so only allocation demand completes
    the offload copies."""
    cfg, make = tiny
    seen = {}
    for fw in ("torch", "jax"):
        rng = np.random.default_rng(15)
        eng = make(fw, num_pages=8, transfer_chunks_per_round=0)
        eng.add_session("a", rng.integers(0, cfg.vocab_size, size=14),
                        max_new_tokens=4)
        eng.run_to_completion()
        free0 = eng.pool.free_pages
        assert eng.kv.evict(3, eng.clock.now()) == 3
        assert eng.kv.free_blocks >= 3
        assert eng.pool.free_pages == free0
        assert eng.pool.inflight_pages("a") == (0, 3)
        eng.check_invariants()
        eng.add_session("b", rng.integers(0, cfg.vocab_size, size=10),
                        max_new_tokens=3)
        eng.run_to_completion()
        eng.check_invariants()
        st = eng.transfer.stats
        assert st.demand_drains > 0
        assert len(eng.pool.seq("a").offloaded) \
            + eng.pool.inflight_pages("a")[1] == 3
        seen[fw] = (free0, st.demand_drains, st.offload_pages_completed,
                    sorted(eng.pool.seq("a").offloaded),
                    {s: x.history for s, x in eng.sessions.items()})
    assert seen["torch"] == seen["jax"]


def test_hangup_mid_transfer_leaks_nothing(tiny):
    cfg, make = tiny
    for fw in ("torch", "jax"):
        rng = np.random.default_rng(17)
        eng = make(fw, pcie_gb_s=_slow_pcie(cfg))
        eng.add_session("a", rng.integers(0, cfg.vocab_size, size=14),
                        max_new_tokens=4)
        eng.run_to_completion()
        assert eng.kv.evict(3, eng.clock.now()) == 3
        eng.flush_transfers()
        per_page = eng.kv.channel.transfer_time(1)
        window = (3 * per_page + eng.preloader.encode_delay_s) / 0.8
        assert eng.user_speech_start("a", expected_dur_s=window) \
            is not None
        assert eng.pool.inflight_pages("a") == (3, 0)
        eng.end_session("a")
        eng.check_invariants()
        assert eng.transfer.idle()
        assert eng.pool.free_pages == eng.num_pages
        assert "a" not in eng.pool.seqs
        assert "a" not in eng.preloader.pending
