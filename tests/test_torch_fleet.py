"""The port's replica fleet against the JAX package's.

- ``run_fleet_replay`` (the fleet's deterministic virtual-time twin) on
  three JAX ``PagedRealtimeEngine`` replicas and on three of the port's
  (CPU), with the same weights (JAX's ``init_params`` carried across
  through numpy), on both planes, over seeded ``interactive``, ``mixed``
  and ``handoff`` traces with and without barge-ins, drains injected by
  ``drain_after_routes``, a pool tight enough to evict, and a shared
  prefix on the prefix plane (whose migrations deep-copy shared pages):
  the router's decision log, every ``TurnRecord``, each replica's token
  histories, turn stats, offload events and transfer stats, the
  migration plans and the ``Metrics`` migration counters must be
  identical.
- The reference's coordinator, router and ``StragglerMitigator`` unit
  scenarios (``tests/test_fleet.py``), each run on both packages, with
  the reference's assertions on each and the two outcomes equal.
- A bf16 prefix-plane migration on the port alone (numpy holds no
  bf16): the shared pages' deep copy lands bit for bit and the session
  resumes token for token.
- The live ``FleetGateway`` at ``device="cpu"`` against the port's twin
  on the same trace: only what the trace determines (routes, drains,
  migration decisions, completions on a barge-free trace), never
  wall-clock order.
- The launcher's ``--replicas 3 --workload handoff``, the same over a
  ``--mesh 1x2`` of two CPU ranks, and its one-replica ``--workload
  handoff``, on the CPU.
- ``build_fleet_gateway``: kernel autotune raises naming its ROADMAP
  item; a mesh is taken.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import repro.distributed.fault_tolerance as j_ft
import repro.serving.fleet.migration as j_mig
import repro.serving.fleet.replica_set as j_rs
import repro.serving.fleet.router as j_router
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import init_params as j_init_params
from repro.serving.fleet.replay import run_fleet_replay as j_run_fleet_replay
from repro.serving.gateway.replay import ReplayClock as JReplayClock
from repro.serving.gateway.replay import ReplayConfig as JReplayConfig
from repro.serving.metrics import Metrics as JMetrics
from repro.serving.paged_engine import PagedRealtimeEngine as JEngine
from repro.serving.workload import WorkloadConfig as JWorkloadConfig
import repro_torch.distributed.fault_tolerance as t_ft
import repro_torch.serving.fleet.migration as t_mig
import repro_torch.serving.fleet.replica_set as t_rs
import repro_torch.serving.fleet.router as t_router
from repro_torch.configs import get_config, reduced
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models.model import init_params, params_from_numpy
from repro_torch.serving.fleet import build_fleet_gateway, \
    run_fleet_replay, run_fleet_workload
from repro_torch.serving.gateway.replay import ReplayClock, ReplayConfig
from repro_torch.serving.metrics import Metrics
from repro_torch.serving.paged_engine import PagedRealtimeEngine
from repro_torch.serving.workload import WorkloadConfig, generate

ROOT = Path(__file__).resolve().parents[1]
REPLICAS = 3
VOCAB = 331


@pytest.fixture(scope="module")
def tiny():
    jcfg = j_reduced(j_get_config("qwen2-1.5b"), layers=2, d_model=64,
                     vocab=VOCAB)
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = reduced(get_config("qwen2-1.5b"), layers=2, d_model=64,
                   vocab=VOCAB)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jp, tcfg, tp


# ======================================================================
# the fleet twin: the port's replicas against the JAX package's
# ======================================================================
def _wl(mod, kind, seed, barge, **kw):
    return mod(kind=kind, num_sessions=6, seed=seed, p_barge_in=barge,
               arrival="poisson", rate_rps=2.0, **kw)


def _fleet_replays(tiny, kind, seed, barge, drain, *, fused, num_pages=128,
                   prefix=False, families=0, prefix_len=0):
    jcfg, jp, tcfg, tp = tiny
    geo = dict(slots=2, page_size=4, pages_per_seq=12 if prefix else 8,
               num_pages=num_pages, fused_step=fused, prefix_cache=prefix)
    wl = dict(prompt_families=families, family_prefix_len=prefix_len)
    want = j_run_fleet_replay(
        lambda clock: JEngine(jcfg, jp, clock=clock, **geo), REPLICAS,
        _wl(JWorkloadConfig, kind, seed, barge, **wl), JReplayConfig(),
        seed=seed, drain_after_routes=drain)
    got = run_fleet_replay(
        lambda clock: PagedRealtimeEngine(tcfg, tp, clock=clock,
                                          device="cpu", **geo),
        REPLICAS, _wl(WorkloadConfig, kind, seed, barge, **wl),
        ReplayConfig(), seed=seed, drain_after_routes=drain)
    return want, got


def _plans(gw):
    return [(p.session_id, p.src, p.dst, p.state, p.reason, p.kind,
             p.pages, p.t_start, p.net_done) for p in gw.migrator.log]


def _replica_view(eng):
    return dict(
        histories={sid: s.history for sid, s in eng.sessions.items()},
        turn_stats={sid: s.turn_stats for sid, s in eng.sessions.items()},
        offload_events=list(eng.offload_events),
        evicted=eng.kv.evicted_blocks, reloaded=eng.kv.reloaded_blocks,
        transfer=dataclasses.asdict(eng.transfer.stats),
        cow=eng.cow_copies)


def _assert_same_fleet(want, got):
    (jm, jgw), (tm, tgw) = want, got
    assert tgw.router.decisions == jgw.router.decisions
    want_recs = [dataclasses.asdict(t) for t in jm.turns]
    assert want_recs
    assert [dataclasses.asdict(t) for t in tm.turns] == want_recs
    want_views = [_replica_view(e) for e in jgw.replicas]
    assert any(v["histories"] for v in want_views)
    assert [_replica_view(e) for e in tgw.replicas] == want_views
    assert _plans(tgw) == _plans(jgw) and not tgw.migrator.plans
    for key in ("migrations", "handoffs", "migration_bytes",
                "migration_on_path_s", "migration_off_path_s",
                "replica_occupancy"):
        assert getattr(tm, key) == getattr(jm, key), key
    assert tgw.rounds == jgw.rounds > 0
    assert tm.summary() == jm.summary()


def _expected_handoffs(kind, seed):
    """Trace-predictable handoff decisions on a barge-free trace:
    session i routes to i % REPLICAS; its turn-1 handoff lands iff
    target % REPLICAS is a different replica."""
    want = {}
    for i, s in enumerate(generate(_wl(WorkloadConfig, kind, seed, 0.0))):
        for turn in s.turns[1:2]:
            if turn.handoff and turn.handoff_target % REPLICAS != i % REPLICAS:
                want[s.session_id] = [(i % REPLICAS,
                                       turn.handoff_target % REPLICAS)]
    return want


# (kind, seed, barge-in, drain_after_routes, pool pages)
TRACES = [
    ("interactive", 0, 0.0, (0, 6), 128),   # drain after the last route
    ("interactive", 0, 0.3, (0, 6), 14),    # tight: evicts and reloads
    ("mixed", 1, 0.3, (0, 4), 128),         # a drain mid-trace
    ("mixed", 2, 0.0, (0, 4), 128),
    ("handoff", 0, 0.0, None, 128),
    ("handoff", 2, 0.3, None, 128),
]


@pytest.mark.parametrize("fused", [True, False],
                         ids=["fused", "per-token"])
@pytest.mark.parametrize("kind,seed,barge,drain,pages", TRACES,
                         ids=[f"{k}-{s}-{b}-{d}-{p}"
                              for k, s, b, d, p in TRACES])
def test_fleet_replay_matches_reference(tiny, kind, seed, barge, drain,
                                        pages, fused):
    want, got = _fleet_replays(tiny, kind, seed, barge, drain, fused=fused,
                               num_pages=pages)
    _assert_same_fleet(want, got)
    tm, tgw = got
    assert tm.migrations > 0 and tm.migration_bytes > 0
    if pages < 128:
        assert any(e.kv.evicted_blocks > 0 for e in tgw.replicas)
    if kind == "handoff" and barge == 0.0:
        got_h = {}
        for _, sid, src, dst in tgw.router.handoff_decisions():
            got_h.setdefault(sid, []).append((src, dst))
        assert got_h == _expected_handoffs(kind, seed) != {}
        assert tm.handoffs == len(got_h)
        assert {t.session_id for t in tm.turns if t.handoff} == set(got_h)
    # every plan ended DONE or in a cancel the decision log accounts for
    moves = [d for d in tgw.router.decisions
             if d[0] in ("migrate", "handoff")]
    assert len(tgw.migrator.completed()) + len(tgw.migrator.cancelled()) \
        == len(moves)
    for p in tgw.migrator.completed():
        assert p.session_id not in tgw.replicas[p.src].sessions
        assert p.session_id in tgw.replicas[p.dst].sessions
    for e in tgw.replicas:
        e.flush_transfers()
        e.check_invariants()
        assert e.pool.free_pages == e.num_pages
        assert all(s.ended for s in e.sessions.values())


@pytest.mark.parametrize("fused", [True, False],
                         ids=["fused", "per-token"])
def test_fleet_replay_prefix_plane_matches_reference(tiny, fused,
                                                     monkeypatch):
    """Sessions of one prompt family share their prefix pages; each
    handoff deep-copies its shared pages to the host through the device
    plane (``migrate_out_begin``) before the copy-then-free chunks."""
    detached = []
    orig = PagedRealtimeEngine.migrate_out_begin

    def spy(self, sid):
        before = len(self.pool.seq(sid).offloaded)
        n = orig(self, sid)
        detached.append(len(self.pool.seq(sid).offloaded) - before)
        return n

    monkeypatch.setattr(PagedRealtimeEngine, "migrate_out_begin", spy)
    want, got = _fleet_replays(tiny, "handoff", 0, 0.0, None, fused=fused,
                               prefix=True, families=1, prefix_len=10)
    _assert_same_fleet(want, got)
    assert sum(detached) > 0                 # shared pages deep-copied
    assert got[0].migrations == len(detached) > 0


# ======================================================================
# coordinator and router scenarios, on both packages
# ======================================================================
def _impls(tiny):
    jcfg, jp, tcfg, tp = tiny
    return {
        "jax": SimpleNamespace(
            engine=lambda clock, **k: JEngine(jcfg, jp, clock=clock, **k),
            Clock=JReplayClock, ReplicaSet=j_rs.ReplicaSet,
            Router=j_router.SessionRouter, Metrics=JMetrics,
            Coordinator=j_mig.MigrationCoordinator,
            Straggler=j_ft.StragglerMitigator,
            pages=lambda e, p: np.asarray(e.k_pages[:, p]).tobytes()
            + np.asarray(e.v_pages[:, p]).tobytes()),
        "torch": SimpleNamespace(
            engine=lambda clock, **k: PagedRealtimeEngine(
                tcfg, tp, clock=clock, device="cpu", **k),
            Clock=ReplayClock, ReplicaSet=t_rs.ReplicaSet,
            Router=t_router.SessionRouter, Metrics=Metrics,
            Coordinator=t_mig.MigrationCoordinator,
            Straggler=t_ft.StragglerMitigator,
            pages=lambda e, p: e.k_pages[:, p].numpy().tobytes()
            + e.v_pages[:, p].numpy().tobytes()),
    }


def _fleet(F, n=2, *, num_pages=(32, 32), interconnect_gb_s=50.0):
    clock = F.Clock()
    engines = [F.engine(clock, slots=2, page_size=4, pages_per_seq=8,
                        num_pages=num_pages[i]) for i in range(n)]
    rs = F.ReplicaSet(engines, interconnect_gb_s=interconnect_gb_s)
    router = F.Router(rs)
    metrics = F.Metrics()
    return rs, router, F.Coordinator(rs, router, metrics), metrics


def _seed_session(rs, router, sid, *, prompt_len=9, n_tokens=4, seed=0):
    """Route ``sid``, run one full turn on its replica, leave it idle
    with committed KV. Returns (replica_index, produced tokens)."""
    i = router.route(sid)
    prompt = np.random.default_rng(seed).integers(0, VOCAB,
                                                  size=prompt_len)
    eng = rs[i]
    eng.add_session(sid, prompt, max_new_tokens=n_tokens)
    toks = eng.run_to_completion()[sid]
    eng.check_invariants()
    assert eng.sessions[sid].kv_len > 0
    return i, toks


def _drain_all(eng, clock):
    while eng.drain_transfers(4):
        clock.tick(1e-4)


def _counters(m):
    return (m.migrations, m.handoffs, m.migration_bytes,
            m.migration_on_path_s, m.migration_off_path_s)


def scn_natural_lifecycle(F):
    """DRAINING -> NETWORK -> LANDING -> DONE, with the session record
    transplanted wholesale and the source scrubbed at handoff; the
    landed pages are the source's bit for bit."""
    rs, router, mig, m = _fleet(F)
    src, toks = _seed_session(rs, router, "a")
    clock = rs.clock
    pages_before = rs[src].pool.resident_pages("a")
    kv_before = [F.pages(rs[src], p) for p in rs[src].pool.seq("a").pages]

    plan = mig.start("a", src, 1 - src, clock.now())
    assert plan.state == j_mig.DRAINING
    assert plan.pages == pages_before > 0
    assert rs[src].kv.sessions["a"].hbm_blocks == 0
    rs[src].check_invariants()

    _drain_all(rs[src], clock)
    mig.pump(clock.now())
    assert plan.state == j_mig.NETWORK
    assert router.placement["a"] == 1 - src
    assert "a" not in rs[src].sessions
    assert rs[src].pool.free_pages == rs[src].num_pages
    dst = rs[1 - src]
    assert dst.sessions["a"].kv_len > 0
    assert dst.kv.sessions["a"].hbm_blocks == 0
    for e in rs:
        e.check_invariants()
    assert m.migrations == 1 and m.migration_bytes > 0

    clock.advance_to(plan.net_done + 1e-6)
    mig.pump(clock.now())
    assert plan.state == j_mig.LANDING
    assert dst.transfer.pending_reload_pages("a") > 0 \
        or dst.kv.sessions["a"].hbm_blocks > 0
    _drain_all(dst, clock)
    assert dst.kv.sessions["a"].hbm_blocks == plan.pages
    dst.check_invariants()
    kv_after = [F.pages(dst, p) for p in dst.pool.seq("a").pages]
    assert kv_after == kv_before
    return dict(toks=toks, pages=plan.pages, net_done=plan.net_done,
                counters=_counters(m), now=clock.now(),
                stats=dataclasses.asdict(dst.transfer.stats))


def scn_resumes_decode_token_exact(F):
    """The destination continues the conversation bit-exactly: the
    tokens a never-migrated engine produces for turn 2."""
    rs, router, mig, _ = _fleet(F)
    src, _ = _seed_session(rs, router, "a")
    clock = rs.clock
    prompt2 = np.random.default_rng(42).integers(0, VOCAB, size=5)

    ref = F.engine(F.Clock(), slots=2, page_size=4, pages_per_seq=8,
                   num_pages=32)
    ref.add_session("a", np.random.default_rng(0).integers(0, VOCAB,
                                                           size=9),
                    max_new_tokens=4)
    ref.run_to_completion()
    ref.start_turn("a", prompt2, max_new_tokens=4)
    want = ref.run_to_completion()["a"]

    plan = mig.start("a", src, 1 - src, clock.now())
    _drain_all(rs[src], clock)
    mig.pump(clock.now())
    clock.advance_to(plan.net_done + 1e-6)
    mig.pump(clock.now())
    dst = rs[1 - src]
    _drain_all(dst, clock)
    dst.start_turn("a", prompt2, max_new_tokens=4)
    got = dst.run_to_completion()["a"]
    assert got == want
    dst.check_invariants()
    return dict(toks=got, history=dst.sessions["a"].history)


def scn_barge_cancel_zero_copy(F):
    """Barge-in mid-drain: queued chunks drop, pages return resident,
    and the interrupting turn runs on the source immediately."""
    rs, router, mig, m = _fleet(F)
    src, _ = _seed_session(rs, router, "a")
    clock = rs.clock
    eng = rs[src]
    moved0 = eng.transfer.stats.migration_pages_moved

    plan = mig.start("a", src, 1 - src, clock.now())
    mig.on_barge("a", clock.now())
    assert plan.state == j_mig.CANCELLED and plan.reason == "barge"
    assert not mig.plans and mig.cancelled() == [plan]
    assert eng.transfer.stats.migration_pages_moved == moved0
    assert eng.kv.sessions["a"].hbm_blocks == plan.pages
    assert router.placement["a"] == src
    eng.check_invariants()
    assert m.migrations == 0 and m.migration_bytes == 0.0

    eng.start_turn("a", np.random.default_rng(3).integers(0, VOCAB, size=4),
                   max_new_tokens=3)
    toks = eng.run_to_completion()["a"]
    assert len(toks) == 3
    eng.check_invariants()
    return dict(toks=toks, cancelled=eng.transfer.stats
                .migration_pages_cancelled, counters=_counters(m))


def scn_hangup_cancel_leaks_nothing(F):
    """Hangup mid-drain cancels the plan; the ordinary hangup path then
    frees every page and host copy."""
    rs, router, mig, _ = _fleet(F)
    src, _ = _seed_session(rs, router, "a")
    plan = mig.start("a", src, 1 - src, rs.clock.now())
    rs[src].drain_transfers(1)                 # a chunk already moved
    mig.on_hangup("a", rs.clock.now())
    assert plan.state == j_mig.CANCELLED and plan.reason == "hangup"
    rs[src].end_session("a")
    router.on_session_end("a")
    for e in rs:
        e.flush_transfers()
        e.check_invariants()
        assert e.pool.free_pages == e.num_pages
    return dict(stats=dataclasses.asdict(rs[src].transfer.stats))


def scn_hangup_mid_network_completes(F):
    """Post-handoff hangup is not a cancel: the bytes moved, the
    session is the destination's, and its hangup there frees all."""
    rs, router, mig, m = _fleet(F, interconnect_gb_s=1e-4)
    src, _ = _seed_session(rs, router, "a")
    clock = rs.clock
    plan = mig.start("a", src, 1 - src, clock.now())
    _drain_all(rs[src], clock)
    mig.pump(clock.now())
    assert plan.state == j_mig.NETWORK and clock.now() < plan.net_done
    mig.on_hangup("a", clock.now())
    assert plan.state == j_mig.DONE and not mig.plans
    dst = rs[1 - src]
    dst.end_session("a")
    router.on_session_end("a")
    for e in rs:
        e.flush_transfers()
        e.check_invariants()
        assert e.pool.free_pages == e.num_pages
    return dict(net_done=plan.net_done, counters=_counters(m))


def scn_demand_complete_charges_on_path(F):
    """A turn request mid-drain forces the migration through, charging
    the drain residual + network window on-path via the clock — the
    sync-reload convention."""
    rs, router, mig, m = _fleet(F)
    src, _ = _seed_session(rs, router, "a")
    clock = rs.clock
    t0 = clock.now()
    plan = mig.start("a", src, 1 - src, t0)
    assert rs[src].migrate_out_pending("a") == plan.pages
    mig.demand_complete("a", clock.now())
    assert plan.state == j_mig.LANDING
    assert clock.now() > t0
    assert m.migration_on_path_s > 0.0
    assert m.migration_on_path_s + m.migration_off_path_s == \
        pytest.approx(clock.now() - t0)
    dst = rs[1 - src]
    dst.start_turn("a", np.arange(3, dtype=np.int64), max_new_tokens=2)
    toks = dst.run_to_completion()["a"]
    assert len(toks) == 2
    dst.check_invariants()
    assert mig.plans and plan.state == j_mig.LANDING
    return dict(toks=toks, now=clock.now(), counters=_counters(m))


def scn_dst_pressure_cancels(F):
    """The destination must have room at handoff; otherwise the plan
    cancels and the session stays on the source, its drained pages
    host-resident until the next turn reloads them."""
    rs, router, mig, m = _fleet(F, num_pages=(32, 2))
    src, _ = _seed_session(rs, router, "a")    # pressure-routes to 0
    assert src == 0
    clock = rs.clock
    plan = mig.start("a", 0, 1, clock.now())
    assert plan.pages > 2
    _drain_all(rs[0], clock)
    mig.pump(clock.now())
    assert plan.state == j_mig.CANCELLED and plan.reason == "dst_pressure"
    assert router.placement["a"] == 0
    assert m.migrations == 0
    assert rs[0].kv.sessions["a"].hbm_blocks == 0
    rs[0].start_turn("a", np.random.default_rng(5).integers(0, VOCAB,
                                                            size=4),
                     max_new_tokens=3)
    toks = rs[0].run_to_completion()["a"]
    assert len(toks) == 3
    for e in rs:
        e.check_invariants()
    return dict(toks=toks, reloaded=rs[0].kv.reloaded_blocks)


def scn_router_routes_by_pressure(F):
    _, router, _, _ = _fleet(F)
    routes = [router.route(f"s{i}") for i in range(4)]
    assert routes == [0, 1, 0, 1]
    router.on_session_end("s0")
    router.on_session_end("s2")
    assert router.route("s4") == 0             # lightest replica
    return dict(decisions=router.decisions)


def scn_router_never_drains_last_replica(F):
    _, router, _, _ = _fleet(F)
    router.drain(0)
    assert router.draining == {0}
    router.drain(1)                            # refused: someone serves
    assert router.draining == {0}
    assert router.route("a") == 1
    router.recover(0)
    assert not router.draining
    assert [d[0] for d in router.decisions] == ["drain", "route",
                                                "recover"]
    return dict(decisions=router.decisions)


def scn_router_ring_next_skips_draining(F):
    clock = F.Clock()
    engines = [F.engine(clock, slots=2, page_size=4, pages_per_seq=8,
                        num_pages=16) for _ in range(3)]
    router = F.Router(F.ReplicaSet(engines))
    router.drain(1)
    ring = [router.ring_next(i) for i in range(3)]
    assert ring == [2, 2, 0]
    return dict(ring=ring)


def scn_router_rebalance_margin(F):
    _, router, _, _ = _fleet(F)
    router.rebalance_margin = 2
    for i in range(4):
        router.route(f"s{i}")                  # 2 / 2
    assert router.maybe_migrate("s0") is None  # balanced
    router.on_session_end("s1")
    router.on_session_end("s3")                # 2 / 0
    assert router.maybe_migrate("s0") == 1
    router.rebalance_margin = None
    assert router.maybe_migrate("s2") is None  # live-only knob off
    return dict(decisions=router.decisions)


def scn_router_straggler_drain_and_recovery(F):
    """Deadline blowouts drain the replica through the mitigator; its
    consecutive-good-round forgiveness lifts the drain again."""
    _, router, _, _ = _fleet(F)
    router.mitigator = F.Straggler(deadline_factor=2.0, min_samples=4,
                                   recover_after=2)
    router.strike_threshold = 2
    for _ in range(4):
        router.observe_round(1, 0.01)          # healthy baseline
    router.observe_round(0, 0.5)
    assert not router.draining                 # one strike is noise
    router.observe_round(0, 0.5)
    assert router.draining == {0}
    assert ("drain", 0) in router.decisions
    router.observe_round(0, 0.01)
    assert router.draining == {0}
    router.observe_round(0, 0.01)
    assert not router.draining
    assert ("recover", 0) in router.decisions
    return dict(decisions=router.decisions)


def scn_router_refuses_self_and_draining_handoffs(F):
    _, router, _, _ = _fleet(F, n=3, num_pages=(16, 16, 16))
    router.route("a")                          # -> replica 0
    assert router.request_handoff("a", 3) is None     # 3 % 3 == src
    router.draining.add(1)
    assert router.request_handoff("a", 1) is None     # dst draining
    assert router.request_handoff("a", 2) == 2
    assert router.handoff_decisions() == [("handoff", "a", 0, 2)]
    return dict(decisions=router.decisions)


def scn_straggler_alternating_still_accumulates(F):
    sm = F.Straggler(deadline_factor=2.0, min_samples=4, recover_after=3)
    for _ in range(6):
        sm.observe("w0", 1.0)
    # slow/fast alternation: single good rounds never erase the record
    for _ in range(3):
        sm.observe("w1", 10.0)
        sm.observe("w1", 1.0)
    assert sm.should_evict("w1", 3)
    return dict(strikes=sm.strikes, streak=sm.good_streak)


def scn_straggler_recovers_and_forgets(F):
    sm = F.Straggler(deadline_factor=2.0, min_samples=4, recover_after=2)
    for _ in range(6):
        sm.observe("w0", 1.0)
    sm.observe("w1", 10.0)
    sm.observe("w1", 10.0)
    assert "w1" in sm.strikes
    sm.observe("w1", 1.0)
    assert "w1" in sm.strikes                  # streak of 1: not yet
    sm.observe("w1", 1.0)
    assert "w1" not in sm.strikes              # clean slate
    sm.observe("w2", 10.0)
    sm.forget("w2")
    assert "w2" not in sm.strikes and "w2" not in sm.good_streak
    return dict(strikes=sm.strikes, durations=sm.durations)


SCENARIOS = [scn_natural_lifecycle, scn_resumes_decode_token_exact,
             scn_barge_cancel_zero_copy, scn_hangup_cancel_leaks_nothing,
             scn_hangup_mid_network_completes,
             scn_demand_complete_charges_on_path, scn_dst_pressure_cancels,
             scn_router_routes_by_pressure,
             scn_router_never_drains_last_replica,
             scn_router_ring_next_skips_draining,
             scn_router_rebalance_margin,
             scn_router_straggler_drain_and_recovery,
             scn_router_refuses_self_and_draining_handoffs,
             scn_straggler_alternating_still_accumulates,
             scn_straggler_recovers_and_forgets]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[f.__name__[4:] for f in SCENARIOS])
def test_fleet_scenario_matches_reference(tiny, scenario):
    impls = _impls(tiny)
    want = scenario(impls["jax"])
    got = scenario(impls["torch"])
    assert got == want


# ======================================================================
# bf16: the prefix plane's deep copy of shared pages
# ======================================================================
def test_bf16_prefix_migration_deep_copies_bit_exact():
    """Two sessions share a bf16 prefix on replica 0; migrating one of
    them deep-copies its shared pages to the host through the device
    plane (torch refuses ``.numpy()`` of bf16) and copy-then-frees its
    private ones. On replica 1 its pages read back bit for bit, the
    sharer keeps its pages hot, and the migrated session's next turn
    is the never-migrated engine's token for token."""
    cfg = reduced(get_config("qwen2-1.5b"), layers=2, d_model=64,
                  vocab=VOCAB).replace(dtype="bfloat16",
                                       param_dtype="bfloat16")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    geo = dict(slots=2, page_size=4, pages_per_seq=12, num_pages=48,
               prefix_cache=True, device="cpu")
    rng = np.random.default_rng(7)
    prefix = rng.integers(0, VOCAB, size=10)
    prompts = {sid: np.concatenate([prefix, rng.integers(0, VOCAB, 3)])
               for sid in ("a", "b")}
    prompt2 = rng.integers(0, VOCAB, size=5)

    def seed_turns(eng):
        for sid in ("a", "b"):
            eng.add_session(sid, prompts[sid], max_new_tokens=4)
            eng.run_to_completion()

    ref = PagedRealtimeEngine(cfg, params, clock=ReplayClock(), **geo)
    seed_turns(ref)
    ref.start_turn("b", prompt2, max_new_tokens=4)
    want = ref.run_to_completion()["b"]

    clock = ReplayClock()
    rs = t_rs.ReplicaSet([PagedRealtimeEngine(cfg, params, clock=clock,
                                              **geo) for _ in range(2)])
    router = t_router.SessionRouter(rs)
    mig = t_mig.MigrationCoordinator(rs, router, Metrics())
    src, dst = rs[0], rs[1]
    router.drain(1)                          # both sessions route to 0
    assert [router.route(sid) for sid in ("a", "b")] == [0, 0]
    router.recover(1)
    seed_turns(src)
    seq = src.pool.seq("b")
    shared = [p for p in seq.pages if p >= 0 and src.pool.refcount[p] > 1]
    assert shared                            # "b" attached "a"'s prefix
    before = [torch.stack([src.k_pages[:, p], src.v_pages[:, p]])
              for p in seq.pages]
    plan = mig.start("b", 0, 1, clock.now())
    assert plan.pages == len(before)
    assert all(src.pool.refcount[p] >= 1 for p in shared)   # "a" keeps them
    _drain_all(src, clock)
    mig.pump(clock.now())
    clock.advance_to(plan.net_done + 1e-6)
    mig.pump(clock.now())
    _drain_all(dst, clock)
    after = [torch.stack([dst.k_pages[:, p], dst.v_pages[:, p]])
             for p in dst.pool.seq("b").pages]
    assert len(after) == len(before)
    for x, y in zip(before, after):
        assert x.dtype == torch.bfloat16
        assert torch.equal(x.view(torch.int16), y.view(torch.int16))
    dst.start_turn("b", prompt2, max_new_tokens=4)
    assert dst.run_to_completion()["b"] == want
    for e in rs:
        e.check_invariants()


# ======================================================================
# the live fleet gateway on the CPU, against the twin
# ======================================================================
def _per_session_moves(gw):
    per = {}
    for _, sid, src, dst in gw.router.migration_decisions():
        per.setdefault(sid, []).append((src, dst))
    return per


@pytest.mark.parametrize("kind,sessions,barge", [("interactive", 4, 0.5),
                                                 ("mixed", 3, 0.0)])
def test_live_fleet_on_cpu_matches_twin_decisions(tiny, kind, sessions,
                                                  barge):
    """The live gateway's routes, drains and migration decisions are the
    twin's on the same trace, as the trace predicts them; on a
    barge-free trace every decided migration completes in both."""
    _, _, tcfg, tp = tiny
    seed = 0
    wl = WorkloadConfig(kind=kind, num_sessions=sessions, seed=seed,
                        p_barge_in=barge, arrival="poisson", rate_rps=2.0)
    twin_m, twin = run_fleet_replay(
        lambda clock: PagedRealtimeEngine(tcfg, tp, slots=2, page_size=8,
                                          pages_per_seq=8, num_pages=128,
                                          clock=clock, device="cpu"),
        REPLICAS, wl, ReplayConfig(max_prompt=6, max_response=6),
        seed=seed, drain_after_routes=(0, sessions))
    live_m, live = run_fleet_workload(
        kind=kind, sessions=sessions, barge_in=barge, seed=seed, scale=8.0,
        max_turns=2, max_prompt=6, max_response=6, timeout_s=180.0,
        replicas=REPLICAS, slots=2, num_pages=128, audio_per_token_s=0.25,
        model=(tcfg, tp), device="cpu", drain_after_routes=(0, sessions))
    assert set(twin_m.summary()) == set(live_m.summary())
    routes = [d for d in live.router.decisions if d[0] == "route"]
    assert routes == [d for d in twin.router.decisions if d[0] == "route"]
    assert [r[2] for r in routes] == [i % REPLICAS for i in range(sessions)]
    drains = [d for d in live.router.decisions
              if d[0] in ("drain", "recover")]
    assert drains == [d for d in twin.router.decisions
                      if d[0] in ("drain", "recover")] == [("drain", 0)]
    want = {s.session_id: [(0, [1, 2][i % 2])]
            for i, s in enumerate(generate(wl))
            if i % REPLICAS == 0 and len(s.turns) >= 2}
    assert want
    assert _per_session_moves(twin) == _per_session_moves(live) == want
    assert live_m.completed_sessions == twin_m.completed_sessions == sessions
    if barge == 0.0:
        for gw, m in ((twin, twin_m), (live, live_m)):
            assert not gw.migrator.plans and not gw.migrator.cancelled()
            assert len(gw.migrator.completed()) == m.migrations == len(want)
            assert sum(1 for t in m.turns if t.migrated) == len(want)
    for gw in (twin, live):
        for e in gw.replicas:
            e.flush_transfers()
            e.check_invariants()
            assert e.pool.free_pages == e.num_pages
            assert all(s.ended for s in e.sessions.values())
        for p in gw.migrator.completed():
            assert p.session_id not in gw.replicas[p.src].sessions
            assert p.session_id in gw.replicas[p.dst].sessions
        # one set of weights for the whole fleet
        assert all(e.params is gw.replicas[0].params for e in gw.replicas)


@pytest.mark.parametrize("kw,item", [
    (dict(autotune="cache.json"), "item 4"),
    (dict(mesh="1x1"), "item 8"),
])
def test_fleet_harness_rejects_what_is_not_ported(tiny, tmp_path, kw, item):
    """Kernel autotune (ROADMAP item 4) is not ported and raises naming
    its item. The fleet over a mesh (item 8) is: on a one-rank mesh the
    harness builds every replica on it, replica i as engine i, and
    nothing raises."""
    _, _, tcfg, tp = tiny
    if "autotune" in kw:
        with pytest.raises(NotImplementedError, match=f"ROADMAP.*{item}"):
            build_fleet_gateway(model=(tcfg, tp), device="cpu", **kw)
        return
    mesh = make_serving_mesh(kw["mesh"], rank=0, device="cpu",
                             init_method=f"file://{tmp_path}/rendezvous")
    try:
        gw = build_fleet_gateway(model=(tcfg, tp), device="cpu", mesh=mesh)
    finally:
        torch.distributed.destroy_process_group()
    assert [(e.mesh, e.mesh_index) for e in gw.replicas] \
        == [(mesh, i) for i in range(REPLICAS)]


# ======================================================================
# the launcher
# ======================================================================
def test_launcher_fleet_handoff_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--engine", "live", "--device", "cpu", "--config", "tiny",
                "--replicas", "3", "--workload", "handoff", "--sessions",
                "6", "--clock-scale", "16", "--json"])
    s = json.loads(capsys.readouterr().out)
    assert s["rounds"] > 0 and s["handoffs"] > 0
    assert s["migrations"] >= s["handoffs"]
    rows = [s[f"replica{i}"] for i in range(3)]
    assert [r.split()[0] for r in rows] == ["routed=2"] * 3
    moved_in = sum(int(r.split()[1].split("=")[1]) for r in rows)
    moved_out = sum(int(r.split()[2].split("=")[1]) for r in rows)
    assert moved_in == moved_out == s["migrations"]
    assert all("peak_occupancy=" in r for r in rows)


def test_launcher_fleet_over_a_mesh_on_cpu(capsys, tmp_path):
    """``--replicas 3 --mesh 1x2`` spawns two ranks; rank 0 serves the
    fleet, every replica sharding its pages over the mesh, and prints the
    routed rows, handoffs and migrations of the run without a mesh."""
    from repro_torch.launch import serve
    flags = ["--engine", "live", "--device", "cpu", "--config", "tiny",
             "--replicas", "3", "--workload", "handoff", "--sessions", "6",
             "--clock-scale", "16", "--json"]
    serve.main(flags)
    plain = json.loads(capsys.readouterr().out)
    # the ranks meet in a temporary directory: under tmp_path
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               TMPDIR=str(tmp_path), OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *flags, "--mesh",
         "1x2"], capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=240)
    assert r.returncode == 0, r.stderr[-4000:]
    assert "[mesh] 1x2: 2 rank(s), ranks on the cpu, backend gloo" \
        in r.stderr
    meshed = json.loads(r.stdout)
    for s in (plain, meshed):
        assert s["rounds"] > 0 and s["handoffs"] > 0
    for key in ("handoffs", "migrations", "migration_bytes", "turns"):
        assert meshed[key] == plain[key], key
    # routed=, migrated_in=, migrated_out= (peak occupancy is timing's)
    assert [meshed[f"replica{i}"].split()[:3] for i in range(3)] \
        == [plain[f"replica{i}"].split()[:3] for i in range(3)]


def test_launcher_one_replica_takes_handoffs_and_stays(capsys):
    """One replica, as in the reference: the gateway takes each handoff
    and the session stays where it is."""
    from repro_torch.launch import serve
    serve.main(["--engine", "live", "--device", "cpu", "--config", "tiny",
                "--workload", "handoff", "--sessions", "4", "--clock-scale",
                "16", "--json"])
    s = json.loads(capsys.readouterr().out)
    wl = WorkloadConfig(kind="handoff", num_sessions=4, seed=0,
                        arrival="poisson", rate_rps=2.0)
    assert any(t.handoff for s_ in generate(wl) for t in s_.turns[1:2])
    assert s["turns"] == sum(min(len(x.turns), 2) for x in generate(wl))
    assert s["handoffs"] == s["migrations"] == 0
    assert "replica0" not in s


def test_fleet_entry_points_raise_without_gpu(tiny):
    """Asked for the card on a host without one, the fleet's entry
    points raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from repro_torch.launch import serve
    _, _, tcfg, tp = tiny
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_fleet_gateway(model=(tcfg, tp))      # default device: cuda
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--engine", "live", "--config", "tiny", "--replicas",
                    "3", "--workload", "handoff"])
