"""Rank bodies and drives for ``tests/test_torch_sharded_plane.py``.

Each ``*_rank`` function runs on one rank of a CPU mesh, in a process of
its own that ``repro_torch.launch.mesh.spawn`` started, so this module
imports neither JAX nor the reference package (a rank would otherwise
pay for importing them). Its inputs are numpy arrays made by the test
from a seed; rank 0 returns what the test compares, the other ranks
None. The drives (``drive_trace``, ``drive_prefix``) take any engine
with the reference's API, so the test runs the very same code on the
JAX engine and on the port's single-device engine.
"""
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
