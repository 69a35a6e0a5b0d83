"""Rank bodies and drives for ``tests/test_torch_sharded_plane.py`` and
``tests/test_torch_fleet_mesh.py``.

Each ``*_rank`` function runs on one rank of a CPU mesh, in a process of
its own that ``repro_torch.launch.mesh.spawn`` started, so this module
imports neither JAX nor the reference package (a rank would otherwise
pay for importing them). Its inputs are numpy arrays made by the test
from a seed; rank 0 returns what the test compares, the other ranks
None. The drives (``drive_trace``, ``drive_prefix``) and the fleet's
record (``fleet_replay``, ``fleet_record``) take any engine with the
reference's API, so the test runs the very same code on the JAX engine
and on the port's single-device engine.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import torch

# the reference test's engine geometry (tests/test_sharded_plane.py)
GEOMETRY = dict(slots=2, page_size=8, pages_per_seq=16, num_pages=6)
# engine options per variant of the trace; "prefix" runs drive_prefix
VARIANTS = {
    "fused": dict(),
    "per-token": dict(fused_step=False),
    "prefix": dict(prefix_cache=True),
    "int8": dict(kv_quant="int8"),
    "spec": dict(spec_decode=3),
}


def drive_trace(eng, vocab: int) -> dict:
    """The reference's ``_drive_trace``: prefill, decode, a physical
    evict/offload, a session that clobbers the freed pages, the reload
    path and a barge-in, over several turns."""
    rng = np.random.default_rng(3)
    p1 = rng.integers(0, vocab, size=10)
    p2 = rng.integers(0, vocab, size=6)
    pb = rng.integers(0, vocab, size=8)
    eng.add_session("a", p1, max_new_tokens=6)
    eng.run_to_completion()
    evicted = eng.kv.evict(2, eng.clock.now())
    eng.add_session("b", pb, max_new_tokens=4)
    eng.run_to_completion()
    eng.start_turn("a", p2, max_new_tokens=8)
    for _ in range(3):
        eng.step()
    eng.barge_in("a")
    eng.start_turn("a", rng.integers(0, vocab, size=4), max_new_tokens=5)
    eng.run_to_completion()
    eng.check_invariants()
    return _summary(eng, evicted)


def drive_prefix(eng, vocab: int) -> dict:
    """``drive_trace`` on the prefix plane with a prefix to share: b's
    prompt starts with a's, so b attaches to a's committed pages and its
    first write copies the shared partial page (copy-on-write); then
    both are evicted (the shared page stays), and a is reloaded and
    barged in."""
    rng = np.random.default_rng(3)
    p1 = rng.integers(0, vocab, size=10)
    p2 = rng.integers(0, vocab, size=6)
    pb = rng.integers(0, vocab, size=3)
    eng.add_session("a", p1, max_new_tokens=6)
    eng.run_to_completion()
    eng.add_session("b", np.concatenate([p1, pb]), max_new_tokens=4)
    eng.run_to_completion()
    evicted = eng.kv.evict(3, eng.clock.now())
    eng.start_turn("a", p2, max_new_tokens=8)
    for _ in range(3):
        eng.step()
    eng.barge_in("a")
    eng.start_turn("a", rng.integers(0, vocab, size=4), max_new_tokens=5)
    eng.run_to_completion()
    eng.check_invariants()
    return _summary(eng, evicted)


def _summary(eng, evicted: int) -> dict:
    return dict(histories={sid: s.history for sid, s in eng.sessions.items()},
                offload_events=[tuple(e) for e in eng.offload_events],
                evicted=evicted, reloaded=eng.kv.reloaded_blocks,
                cow_copies=eng.cow_copies,
                turn_stats={sid: s.turn_stats
                            for sid, s in eng.sessions.items()})


def run_variant(eng, name: str, vocab: int) -> dict:
    return (drive_prefix if name == "prefix" else drive_trace)(eng, vocab)


def _model(cfg_kw: dict, weights, config: str = "qwen2-1.5b"):
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.model import params_from_numpy
    cfg = reduced(get_config(config), **cfg_kw)
    return cfg, params_from_numpy(weights, "cpu")


def _driven(mesh, make, drive):
    """``drive(engine)`` on the leader, which then releases the other
    ranks; they follow it. Returns drive's result on the leader."""
    eng = make()
    if not mesh.is_leader:
        eng.follow()
        return None
    try:
        return drive(eng)
    finally:
        eng.release_followers()


# ======================================================================
# rank bodies
# ======================================================================
def kernels_rank(mesh, cases: dict) -> dict:
    """The global-view sharded kernels on every case: ``cases[name]`` =
    (kind, Hkv, page, dtype name, numpy inputs). Returns every rank's
    outputs (they must agree) as f32 numpy."""
    torch.set_num_threads(1)
    from repro_torch.distributed.paged import PagedKVLayout, \
        sharded_flash_prefill, sharded_paged_attention
    out = {}
    for name, (kind, Hkv, page, dtype, args) in cases.items():
        layout = PagedKVLayout(SimpleNamespace(num_kv_heads=Hkv), mesh,
                               page)
        dt = getattr(torch, dtype)
        t = [torch.from_numpy(a) for a in args]
        t = [x.to(dt) if x.is_floating_point() else x for x in t]
        if kind == "decode":
            got = sharded_paged_attention(layout, *t)
        elif kind == "prefill":
            q, kp, vp, *rest = t
            got = layout.attend_chunk(q, layout.shard(kp),
                                      layout.shard(vp), *rest)
        else:
            got = sharded_flash_prefill(layout, *t, q_offset=64)
        out[name] = (layout.kind, got.float().numpy())
    return out


def engines_rank(mesh, cfg_kw: dict, weights, names,
                 config: str = "qwen2-1.5b") -> dict:
    """Every variant of the trace on the sharded engine, one engine a
    variant, on the reduced ``config``."""
    torch.set_num_threads(1)
    from repro_torch.serving.paged_engine import PagedRealtimeEngine
    cfg, params = _model(cfg_kw, weights, config)
    res = {}
    for name in names:
        res[name] = _driven(
            mesh, lambda: PagedRealtimeEngine(
                cfg, params, device="cpu", mesh=mesh, **GEOMETRY,
                **VARIANTS[name]),
            lambda eng: dict(run_variant(eng, name, cfg.vocab_size),
                             kind=eng.layout.kind))
    return res if mesh.is_leader else None


def replay_rank(mesh, cfg_kw: dict, weights, geometry: dict, wl_kw: dict,
                seed: int):
    """``run_replay`` on the sharded engine: the turn records, the
    histories and the page traffic."""
    torch.set_num_threads(1)
    from repro_torch.serving.paged_engine import PagedRealtimeEngine
    cfg, params = _model(cfg_kw, weights)
    if not mesh.is_leader:
        PagedRealtimeEngine(cfg, params, device="cpu", mesh=mesh,
                            **geometry).follow()
        return None
    box = {}

    def factory(clock):
        box["eng"] = PagedRealtimeEngine(cfg, params, device="cpu",
                                         clock=clock, mesh=mesh, **geometry)
        return box["eng"]
    try:
        return replay_record(factory, wl_kw, seed)
    finally:
        box["eng"].release_followers()


def replay_record(factory, wl_kw: dict, seed: int) -> dict:
    import dataclasses
    from repro_torch.serving.gateway.replay import ReplayConfig, run_replay
    from repro_torch.serving.workload import WorkloadConfig
    m, gw = run_replay(factory, WorkloadConfig(**wl_kw), ReplayConfig(),
                       seed=seed)
    eng = gw.eng
    return dict(records=[dataclasses.asdict(t) for t in m.turns],
                histories={sid: s.history for sid, s in eng.sessions.items()},
                offload_events=[tuple(e) for e in eng.offload_events],
                evicted=eng.kv.evicted_blocks,
                reloaded=eng.kv.reloaded_blocks,
                max_over_frontier_s=gw.max_over_frontier_s,
                kind=None if eng.layout is None else eng.layout.kind)


def live_rank(mesh, cfg_kw: dict, weights) -> dict:
    """The asyncio gateway end to end over the sharded engine."""
    torch.set_num_threads(1)
    from repro_torch.serving.gateway import run_gateway_workload
    from repro_torch.serving.gateway.harness import build_gateway
    cfg, params = _model(cfg_kw, weights)
    gw = build_gateway(policy="liveserve", scale=16.0, model=(cfg, params),
                       device="cpu", slots=4, page_size=8, pages_per_seq=8,
                       mesh=mesh, frontier_cap_s=3.0)
    if gw is None:
        return None
    m, gw = run_gateway_workload(
        policy="liveserve", sessions=4, barge_in=0.5, seed=1, max_prompt=8,
        max_response=8, max_turns=2, speech_scale=0.5, gateway=gw,
        timeout_s=300)
    eng = gw.engine
    eng.check_invariants()
    return dict(kind=eng.layout.kind, completed=m.completed_sessions,
                turns=len(m.turns),
                every_turn_ends=all(t.completed or t.barged
                                    for t in m.turns),
                slots_free=all(s is None for s in eng.slot_state.values()),
                pages_free=eng.pool.free_pages == eng.num_pages)


# ======================================================================
# the replica fleet over a mesh
# ======================================================================
FLEET_COUNTERS = ("migrations", "handoffs", "migration_bytes",
                  "migration_on_path_s", "migration_off_path_s",
                  "replica_occupancy")


def spy_detached(eng, box: list) -> None:
    """Count, in ``box``, the shared prefix pages each
    ``migrate_out_begin`` of ``eng`` deep-copies to the host."""
    begin = eng.migrate_out_begin

    def spy(sid):
        before = len(eng.pool.seq(sid).offloaded)
        n = begin(sid)
        box.append(len(eng.pool.seq(sid).offloaded) - before)
        return n
    eng.migrate_out_begin = spy


def fleet_record(m, gw, detached=()) -> dict:
    """What the fleet differential holds equal: the router's decisions,
    every turn record, each replica's histories, turn stats, offload
    events and transfer stats, the migration plans and counters."""
    def view(eng):
        return dict(
            histories={sid: s.history for sid, s in eng.sessions.items()},
            turn_stats={sid: s.turn_stats
                        for sid, s in eng.sessions.items()},
            offload_events=[tuple(e) for e in eng.offload_events],
            evicted=eng.kv.evicted_blocks, reloaded=eng.kv.reloaded_blocks,
            transfer=dataclasses.asdict(eng.transfer.stats),
            cow=eng.cow_copies)
    return dict(
        decisions=list(gw.router.decisions),
        records=[dataclasses.asdict(t) for t in m.turns],
        replicas=[view(e) for e in gw.replicas],
        plans=[(p.session_id, p.src, p.dst, p.state, p.reason, p.kind,
                p.pages, p.t_start, p.net_done) for p in gw.migrator.log],
        open_plans=len(gw.migrator.plans),
        counters={k: getattr(m, k) for k in FLEET_COUNTERS},
        rounds=gw.rounds, summary=m.summary(), detached=list(detached))


def fleet_replay(run_fleet_replay, make_engine, make_wl, make_rc, run: dict,
                 mesh=None):
    """One fleet-twin run of ``run`` (replicas, geometry, workload and
    replay kwargs, seed, drain) through either package's
    ``run_fleet_replay``: ``make_engine(clock, **kw)`` builds a replica
    (on ``mesh``, replica i with ``mesh_index=i``). Returns the record,
    or None on a follower rank. ``empty`` says which replicas end with
    no page held, no live session and no transfer queued."""
    detached = []

    def factory(clock, *index):
        kw = dict(mesh=mesh, mesh_index=index[0]) if mesh is not None \
            else {}
        eng = make_engine(clock, **run["geometry"], **kw)
        spy_detached(eng, detached)
        return eng
    m, gw = run_fleet_replay(factory, run["replicas"],
                             make_wl(**run["workload"]),
                             make_rc(**run.get("replay", {})),
                             seed=run["seed"],
                             drain_after_routes=run.get("drain"),
                             **(dict(mesh=mesh) if mesh is not None else {}))
    if gw is None:
        return None
    return dict(fleet_record(m, gw, detached),
                kind=None if mesh is None else gw.replicas[0].layout.kind,
                empty=[e.pool.free_pages == e.num_pages
                       and all(s.ended for s in e.sessions.values())
                       and e.transfer.idle()
                       for e in gw.replicas])


def fleet_rank(mesh, cfg_kw: dict, weights, runs: dict, replay=None,
               live=None) -> dict:
    """On a 1xM mesh: every fleet-twin run of ``runs`` with its replicas
    sharding their pages over the mesh; with ``replay`` = (geometry,
    workload kwargs, seed), ``run_replay`` on one sharded engine
    (``replay_record``); with ``live`` (name -> workload kwargs),
    ``run_fleet_workload`` on the mesh for each (``live_fleet_record``);
    then the leader sends a command for an engine no rank holds. The
    leader returns the records, a follower what its loop raised."""
    torch.set_num_threads(1)
    from repro_torch.serving.fleet import run_fleet_replay
    from repro_torch.serving.gateway.replay import ReplayConfig
    from repro_torch.serving.paged_engine import (_OP_COW,
                                                  PagedRealtimeEngine,
                                                  follow_engines)
    from repro_torch.serving.workload import WorkloadConfig
    cfg, params = _model(cfg_kw, weights)

    def make_engine(clock, **kw):
        return PagedRealtimeEngine(cfg, params, clock=clock, device="cpu",
                                   **kw)
    out = {name: fleet_replay(run_fleet_replay, make_engine, WorkloadConfig,
                              ReplayConfig, run, mesh)
           for name, run in runs.items()}
    if replay is not None:
        geometry, wl_kw, seed = replay
        if mesh.is_leader:
            box = {}

            def factory(clock):
                box["eng"] = make_engine(clock, mesh=mesh, **geometry)
                return box["eng"]
            try:
                out["replay"] = replay_record(factory, wl_kw, seed)
            finally:
                box["eng"].release_followers()
        else:
            make_engine(None, mesh=mesh, **geometry).follow()
    for name, kw in (live or {}).items():
        out[f"live-{name}"] = live_fleet_record(mesh, cfg, params, kw)
    # one engine on every rank, then a command for engine 3
    eng = make_engine(None, mesh=mesh)
    if mesh.is_leader:
        mesh.send(_OP_COW, [[0, 1]], target=3)
        return out
    try:
        follow_engines([eng])
    except ValueError as e:
        return dict(unknown_target=str(e))
    return dict(unknown_target=None)


def live_fleet_record(mesh, cfg, params, live: dict) -> dict:
    """``run_fleet_workload`` over 3 replicas on ``mesh`` (``live``: the
    workload's kwargs): what the trace determines, for the test to hold
    to the twin. None on a follower rank."""
    from repro_torch.serving.fleet import run_fleet_workload
    m, gw = run_fleet_workload(
        seed=0, scale=8.0, max_turns=2, max_prompt=6, max_response=6,
        timeout_s=180.0, replicas=3, slots=2, num_pages=128,
        audio_per_token_s=0.25, model=(cfg, params), device="cpu",
        mesh=mesh, **live)
    if gw is None:
        return None
    replicas = []
    for e in gw.replicas:
        e.flush_transfers()
        e.check_invariants()
        replicas.append(dict(
            free=e.pool.free_pages == e.num_pages,
            ended=all(s.ended for s in e.sessions.values()),
            sessions=set(e.sessions), kind=e.layout.kind))
    return dict(
        decisions=list(gw.router.decisions), completed=m.completed_sessions,
        migrations=m.migrations, summary_keys=set(m.summary()),
        migrated_turns=sum(1 for t in m.turns if t.migrated),
        open_plans=len(gw.migrator.plans),
        done=[(p.session_id, p.src, p.dst)
              for p in gw.migrator.completed()],
        cancelled=len(gw.migrator.cancelled()), replicas=replicas,
        shared_weights=all(e.params is params for e in gw.replicas))
