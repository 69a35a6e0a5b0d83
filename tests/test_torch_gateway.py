"""The port's gateway front end against the JAX package's.

- ``run_replay`` (the deterministic virtual-time twin of the gateway) on
  the JAX ``PagedRealtimeEngine`` and on the port's engine (CPU), with
  the same weights (JAX's ``init_params`` carried across through
  numpy), on both planes: every ``TurnRecord``, the token histories,
  the offload events, the eviction count, the transfer stats and the
  frontier telemetry must be identical. Two examples run a pool tight
  enough to evict; in one of them a turn's reload does not fit, and the
  gateway's control round keeps it queued on the port's ``OutOfPages``.
- The port's copy of the sim-vs-real differential check
  (``tests/test_differential.py::check_differential``) on the port's
  engine and simulator, with the next-use eviction oracle installed in
  both.
- The live asyncio gateway at ``device="cpu"`` on a scaled wall clock:
  only what the trace determines is held (every session completes,
  the barged turns are the trace's, turn order, the frontier cap, the
  reload split), never wall-clock order. An engine error surfaces
  from the serve loop.
- The warm-up runs every query-axis bucket through the engine's own
  step and leaves the pool as it found it.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import init_params as j_init_params
from repro.serving.gateway.replay import ReplayConfig as JReplayConfig
from repro.serving.gateway.replay import run_replay as j_run_replay
from repro.serving.paged_engine import PagedRealtimeEngine as JEngine
from repro.serving.workload import WorkloadConfig as JWorkloadConfig
from repro_torch.configs import get_config, reduced
from repro_torch.kvcache.paged import OutOfPages
from repro_torch.models.model import params_from_numpy
from repro_torch.serving.costmodel import PIPELINES
from repro_torch.serving.engine import RoundLimitExceeded
from repro_torch.serving.gateway import run_gateway_workload
from repro_torch.serving.gateway.harness import _warm_engine, build_gateway
from repro_torch.serving.gateway.replay import ReplayConfig, run_replay
from repro_torch.serving.metrics import Metrics
from repro_torch.serving.paged_engine import PagedRealtimeEngine
from repro_torch.serving.simulator import Simulation
from repro_torch.serving.workload import WorkloadConfig, generate

APT = 0.25               # audio seconds per output token (replay side)


@pytest.fixture(scope="module")
def tiny():
    jcfg = j_reduced(j_get_config("qwen2-1.5b"), layers=2, d_model=64,
                     vocab=331)
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = reduced(get_config("qwen2-1.5b"), layers=2, d_model=64,
                   vocab=331)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jp, tcfg, tp


def _wl(mod, seed, kind, sessions, barge):
    return mod(kind=kind, num_sessions=sessions, seed=seed,
               p_barge_in=barge, arrival="poisson", rate_rps=4.0)


# ======================================================================
# the replay twin: the port's engine against the JAX engine
# ======================================================================
def _port_engine(tcfg, tp, clock, **geo):
    """The port's engine, counting the turn admissions that raised
    ``OutOfPages`` (the control round requeues them)."""
    eng = PagedRealtimeEngine(tcfg, tp, clock=clock, device="cpu", **geo)
    eng.requeues = 0
    submit = eng.submit_turn

    def counted(*a, **k):
        try:
            return submit(*a, **k)
        except OutOfPages:
            eng.requeues += 1
            raise

    eng.submit_turn = counted
    return eng


def _replays(tiny, seed, kind, sessions, barge, fused, num_pages=None):
    jcfg, jp, tcfg, tp = tiny
    geo = dict(slots=2, page_size=4, pages_per_seq=8, num_pages=num_pages,
               fused_step=fused)
    jm, jgw = j_run_replay(
        lambda clock: JEngine(jcfg, jp, clock=clock, **geo),
        _wl(JWorkloadConfig, seed, kind, sessions, barge),
        JReplayConfig(audio_per_token_s=APT), seed=seed)
    tm, tgw = run_replay(
        lambda clock: _port_engine(tcfg, tp, clock, **geo),
        _wl(WorkloadConfig, seed, kind, sessions, barge),
        ReplayConfig(audio_per_token_s=APT), seed=seed)
    return (jm, jgw), (tm, tgw)


def _assert_same_replay(want, got):
    (jm, jgw), (tm, tgw) = want, got
    want_recs = [dataclasses.asdict(t) for t in jm.turns]
    assert want_recs
    assert [dataclasses.asdict(t) for t in tm.turns] == want_recs
    want_hist = {sid: s.history for sid, s in jgw.eng.sessions.items()}
    assert any(want_hist.values())
    assert {sid: s.history for sid, s in tgw.eng.sessions.items()} == \
        want_hist
    assert {sid: s.turn_stats for sid, s in tgw.eng.sessions.items()} == \
        {sid: s.turn_stats for sid, s in jgw.eng.sessions.items()}
    assert tgw.eng.offload_events == jgw.eng.offload_events
    assert tgw.eng.kv.evicted_blocks == jgw.eng.kv.evicted_blocks
    assert dataclasses.asdict(tgw.eng.transfer.stats) == \
        dataclasses.asdict(jgw.eng.transfer.stats)
    assert tgw.max_over_frontier_s == jgw.max_over_frontier_s
    assert tgw.rounds == jgw.rounds > 0
    assert tm.summary() == jm.summary()


@pytest.mark.parametrize("fused", [True, False],
                         ids=["fused", "per-token"])
@pytest.mark.parametrize("kind", ["interactive", "sharegpt", "mixed",
                                  "duplex", "toolcall"])
def test_replay_matches_reference(tiny, kind, fused):
    want, got = _replays(tiny, 1, kind, 3, 0.5, fused)
    _assert_same_replay(want, got)


@pytest.mark.parametrize("fused", [True, False],
                         ids=["fused", "per-token"])
@pytest.mark.parametrize("seed,kind,requeues", [
    (7, "interactive", False),   # tests/test_differential.py's example
    (5, "mixed", True),
])
def test_replay_matches_reference_under_eviction(tiny, seed, kind,
                                                 requeues, fused):
    """A tight pool evicts, offloads and reloads (and, in the second
    example, cannot fit a turn's reload, which stays queued); both
    engines do it identically."""
    want, got = _replays(tiny, seed, kind, 5, 0.4, fused, num_pages=14)
    assert want[1].eng.kv.evicted_blocks > 0
    assert want[1].eng.offload_events
    assert (got[1].eng.requeues > 0) == requeues
    _assert_same_replay(want, got)


# ======================================================================
# the sim-vs-real differential on the port (a copy of the reference's
# tests/test_differential.py check)
# ======================================================================
def install_eviction_oracle(kv):
    """Wrap ``kv.evict`` so every eviction pass is checked against a
    freshly-computed Eq. 4 ranking: each victim's next-use estimate must
    dominate (>=, with fp slack) every candidate that was spared.
    Returns the violations list (empty == policy agreement)."""
    violations = []
    orig_evict = kv.evict

    def evict(need_blocks, now):
        cands = {}
        for sid, s in kv.sessions.items():
            if s.evictable(now) <= 0:
                continue
            if kv.monitor is not None and kv.monitor.immediate_reuse(sid):
                continue
            cands[sid] = kv.next_use_estimate(sid, now)
        victims = []
        orig_es = kv._evict_session

        def spy(sid, want, now2):
            victims.append(sid)
            return orig_es(sid, want, now2)

        kv._evict_session = spy
        try:
            freed = orig_evict(need_blocks, now)
        finally:
            kv._evict_session = orig_es
        vset = set(victims)
        for v in vset:
            if v not in cands:
                violations.append(("illegal-victim", now, v, dict(cands)))
        spared = [est for sid, est in cands.items() if sid not in vset]
        if vset and spared:
            lo = min(cands[v] for v in vset if v in cands)
            if lo + 1e-9 < max(spared):
                violations.append(("ranking", now, victims, dict(cands)))
        return freed

    kv.evict = evict
    return violations


def _run_real(tcfg, tp, wl, seed, *, fused=True, num_pages=None):
    box = {}

    def factory(clock):
        eng = PagedRealtimeEngine(tcfg, tp, slots=2, page_size=4,
                                  pages_per_seq=8, num_pages=num_pages,
                                  clock=clock, device="cpu",
                                  fused_step=fused)
        eng.kv.index_mode = "scan"      # fresh Eq. 4 ranking per pass
        box["violations"] = install_eviction_oracle(eng.kv)
        return eng

    metrics, gw = run_replay(factory, wl,
                             ReplayConfig(audio_per_token_s=APT,
                                          frontier_cap_s=3.0),
                             seed=seed)
    gw.eng.check_invariants()
    return metrics, gw, box["violations"]


def _run_sim(wl, seed, *, kv_gb=6.0):
    pipe = PIPELINES["qwen3-omni-like"](kv_capacity_gb=kv_gb)
    sim = Simulation(pipe, wl, policy="liveserve", eviction_index="scan",
                     seed=seed)
    violations = [install_eviction_oracle(kv) for kv in sim.kvs.values()]
    metrics = sim.run(until=3600.0)
    return metrics, sim, [v for lst in violations for v in lst]


def _completion_order(metrics: Metrics):
    per = {}
    for t in sorted(metrics.turns, key=lambda t: (t.finish_time,
                                                  t.turn_index)):
        if t.finish_time:
            per.setdefault(t.session_id, []).append(t.turn_index)
    return per


def _check_plane(metrics: Metrics, *, require_outcome: bool):
    order = _completion_order(metrics)
    assert order
    for sid, idxs in order.items():
        assert idxs == sorted(idxs), \
            f"{sid}: turns completed out of order: {idxs}"
    if require_outcome:
        for t in metrics.turns:
            assert t.completed or t.barged, \
                f"{t.session_id}/{t.turn_index} lost"
            assert t.ttfp is not None, \
                f"{t.session_id}/{t.turn_index} never produced audio"
    return order


def _trace_barges(wl, max_turns):
    return {(s.session_id, ti)
            for s in generate(wl)
            for ti, turn in enumerate(s.turns[:max_turns])
            if turn.barge_in}


def _assert_reload_split(turns, sessions):
    """The turn records carry exactly the reload seconds the engine's
    own turn stats charged, on the path and off it."""
    eng_on = sum(st["reload_stall_s"] for s in sessions
                 for st in s.turn_stats)
    eng_off = sum(st["reload_off_path_s"] for s in sessions
                  for st in s.turn_stats)
    assert sum(t.reload_stall_s for t in turns) == pytest.approx(eng_on)
    assert sum(t.reload_off_path_s for t in turns) == \
        pytest.approx(eng_off)


def check_differential(tcfg, tp, seed, kind, sessions, barge, fused):
    wl = _wl(WorkloadConfig, seed, kind, sessions, barge)
    real_m, gw, real_viol = _run_real(tcfg, tp, wl, seed, fused=fused)
    sim_m, sim, sim_viol = _run_sim(wl, seed)
    assert set(real_m.summary()) == set(sim_m.summary())
    _check_plane(real_m, require_outcome=True)
    _check_plane(sim_m, require_outcome=False)
    max_turns = ReplayConfig().max_turns
    want_keys = {(s.session_id, ti) for s in sim.sessions.values()
                 for ti in range(min(len(s.turns), max_turns))}
    assert {(t.session_id, t.turn_index) for t in real_m.turns} == \
        want_keys
    assert real_m.completed_sessions == sessions
    barges = _trace_barges(wl, max_turns)
    assert sim_m.completed_sessions == sessions
    assert {(t.session_id, t.turn_index)
            for t in real_m.turns if t.barged} == barges
    assert {(t.session_id, t.turn_index) for t in sim_m.turns
            if t.barged and t.turn_index < max_turns} == barges
    assert gw.max_over_frontier_s <= APT + 1e-6
    assert not real_viol, real_viol
    assert not sim_viol, sim_viol
    for m in (real_m, sim_m):
        s = m.summary()
        assert s["mean_reload_stall"] >= 0.0
        assert s["mean_reload_off_path"] >= 0.0
        assert 0.0 <= s["reload_overlap_frac"] <= 1.0
    _assert_reload_split(real_m.turns, gw.eng.sessions.values())


@pytest.mark.parametrize("seed,kind,sessions,barge,fused", [
    (0, "interactive", 3, 0.5, True),
    (1, "sharegpt", 2, 0.0, True),
    (2, "mixed", 4, 0.8, True),
    (0, "interactive", 3, 0.5, False),
])
def test_port_sim_vs_real_differential(tiny, seed, kind, sessions, barge,
                                       fused):
    _, _, tcfg, tp = tiny
    check_differential(tcfg, tp, seed, kind, sessions, barge, fused)


@pytest.mark.parametrize("fused", [True, False],
                         ids=["fused", "per-token"])
def test_port_differential_exercises_evictions(tiny, fused):
    _, _, tcfg, tp = tiny
    wl = _wl(WorkloadConfig, 7, "interactive", 5, 0.4)
    real_m, gw, viol = _run_real(tcfg, tp, wl, 7, fused=fused,
                                 num_pages=14)
    assert gw.eng.kv.evicted_blocks > 0
    assert not viol, viol
    _check_plane(real_m, require_outcome=True)
    sim_m, sim, sim_viol = _run_sim(wl, 7, kv_gb=0.5)
    assert any(kv.evicted_blocks > 0 for kv in sim.kvs.values())
    assert not sim_viol, sim_viol


# ======================================================================
# the live asyncio gateway on the CPU
# ======================================================================
def check_live(m, gw, wl, *, max_turns, apt):
    """The live gateway's trace-determined outcomes (no wall-clock
    order): every session completes, every clamped turn is recorded
    with a TTFP, the barged turns are the trace's, turns complete in
    order, the frontier cap holds to one token of audio, the engine's
    invariants hold and the records' reload split is the engine's."""
    eng = gw.engine
    assert m.completed_sessions == wl.num_sessions
    want = {(s.session_id, ti) for s in generate(wl)
            for ti in range(min(len(s.turns), max_turns))}
    assert want
    assert {(t.session_id, t.turn_index) for t in m.turns} == want
    assert all(t.ttfp is not None for t in m.turns)
    assert {(t.session_id, t.turn_index) for t in m.turns if t.barged} \
        == _trace_barges(wl, max_turns)
    _check_plane(m, require_outcome=True)
    assert gw.max_over_frontier_s <= apt + 1e-6
    eng.check_invariants()
    assert all(s is None for s in eng.slot_state.values())
    assert eng.pool.free_pages == eng.num_pages
    _assert_reload_split(m.turns, eng.sessions.values())


@pytest.mark.parametrize("fused", [True, False],
                         ids=["fused", "per-token"])
def test_live_gateway_on_cpu(tiny, fused):
    _, _, tcfg, tp = tiny
    kw = dict(kind="interactive", sessions=4, barge_in=0.5, seed=2,
              rate_rps=2.0)
    m, gw = run_gateway_workload(
        policy="liveserve", scale=2.0, speech_scale=0.5,
        model=(tcfg, tp), device="cpu", slots=4, page_size=8,
        pages_per_seq=8, frontier_cap_s=3.0, fused_step=fused,
        timeout_s=120, **kw)
    wl = WorkloadConfig(kind="interactive", num_sessions=4, seed=2,
                        p_barge_in=0.5, arrival="poisson", rate_rps=2.0)
    assert _trace_barges(wl, 2)          # the trace barges
    assert gw.rounds > 0
    check_live(m, gw, wl, max_turns=2, apt=gw.cfg.audio_per_token_s)


def test_live_gateway_surfaces_engine_errors(tiny):
    """An engine failure mid-serve propagates out of the harness — never
    swallowed by the event loop or misreported as a load timeout."""
    _, _, tcfg, tp = tiny
    gw = build_gateway(policy="liveserve", scale=16.0, model=(tcfg, tp),
                       device="cpu", slots=2, page_size=4, pages_per_seq=8)
    orig = gw.engine.run_round
    calls = {"n": 0}

    def failing(chunks):
        calls["n"] += 1
        if calls["n"] > 2:
            raise RoundLimitExceeded("injected engine live-lock")
        return orig(chunks)

    gw.engine.run_round = failing
    with pytest.raises(RoundLimitExceeded, match="injected"):
        run_gateway_workload(policy="liveserve", sessions=2,
                             barge_in=0.0, seed=0, gateway=gw,
                             timeout_s=120)
    assert calls["n"] == 3


def test_launcher_live_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--engine", "live", "--device", "cpu", "--config", "tiny",
                "--sessions", "2", "--clock-scale", "16", "--json"])
    s = json.loads(capsys.readouterr().out)
    assert s["turns"] == 4 and s["rounds"] > 0
    assert s["max_over_frontier_s"] <= 0.25 + 1e-6


# ======================================================================
# the warm-up
# ======================================================================
@pytest.mark.parametrize("fused,spec,chunk,widths", [
    (True, 0, 16, [1, 2, 4, 8, 16]),
    (True, 0, 3, [1, 2, 4]),
    (True, 4, 2, [1, 2, 4, 8]),
    (False, 0, 16, [1]),
])
def test_warm_engine_runs_every_bucket_on_scratch(tiny, fused, spec, chunk,
                                                  widths):
    _, _, tcfg, tp = tiny
    eng = PagedRealtimeEngine(tcfg, tp, slots=3, page_size=4,
                              pages_per_seq=8, device="cpu",
                              fused_step=fused, spec_decode=spec)
    seen = []
    name = "_fused_fn" if fused else "_step_fn"
    step = getattr(eng, name)

    def spy(cfg, params, tokens, *a, **k):
        seen.append((tokens.shape[-1] if fused else 1,
                     k.get("spec", False)))
        return step(cfg, params, tokens, *a, **k)

    setattr(eng, name, spy)
    _warm_engine(eng, chunk)
    assert seen == [(w, spec > 0) for w in widths]
    # only the scratch page was written; the pool is as it was
    assert eng.k_pages[:, eng.scratch_page].abs().sum() > 0
    assert torch.count_nonzero(eng.k_pages[:, :eng.scratch_page]) == 0
    assert torch.count_nonzero(eng.v_pages[:, :eng.scratch_page]) == 0
    assert eng.pool.free_pages == eng.num_pages
    eng.check_invariants()
