"""The port's replica fleet over a serving mesh against the JAX package.

Every replica shards its page store over one ``DxM`` mesh of gloo
processes on the CPU (``launch/mesh.py::spawn``, a ``file://`` store
under ``tmp_path``, each spawn with its own time limit): one spawn for
``1x2`` (heads) and one for ``1x4`` (slots), each running all its parts
in turn. The leader (rank 0) runs the fleet's control plane; the other
ranks follow the three replicas in one loop.

- The fleet twin (``run_fleet_replay``) on three replicas at the tiny
  width of ``tests/test_torch_fleet.py``, on both planes, over a
  barge-free handoff trace, an interactive trace with barge-ins, a
  drained replica and a pool tight enough to evict, and the prefix
  plane (handoffs that deep-copy shared pages), and on two replicas
  over a trace whose destination's pressure cancels a migration (the
  card's phase (h5b) before its cut): the router's decisions,
  every turn record, each replica's histories, turn stats, offload
  events and transfer stats, the plans and the migration counters equal
  the port's single-device fleet and the JAX single-device fleet twin,
  in f32.
- A one-replica fleet on the ``1x4`` mesh equals ``run_replay`` on one
  sharded engine and on one device, on a pool that evicts.
- The live ``FleetGateway`` on the ``1x2`` mesh: routes, drains and
  migration decisions are the twin's, as the trace predicts them.
- A follower sent a command for an engine it does not hold raises,
  naming it.

The rank bodies live in ``tests/torch_sharded_ranks.py``, which imports
no JAX.
"""
import jax
import numpy as np
import pytest

import torch_sharded_ranks as ranks
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import init_params as j_init_params
from repro.serving.fleet.replay import run_fleet_replay as j_run_fleet_replay
from repro.serving.gateway.replay import ReplayConfig as JReplayConfig
from repro.serving.paged_engine import PagedRealtimeEngine as JEngine
from repro.serving.workload import WorkloadConfig as JWorkloadConfig
from repro_torch.configs import get_config, reduced
from repro_torch.launch.mesh import spawn
from repro_torch.models.model import params_from_numpy
from repro_torch.serving.fleet import run_fleet_replay
from repro_torch.serving.gateway.replay import ReplayConfig
from repro_torch.serving.paged_engine import PagedRealtimeEngine
from repro_torch.serving.workload import WorkloadConfig, generate

CFG_KW = dict(layers=2, d_model=64, vocab=331)
REPLICAS = 3
SPAWN_S = 240                     # each spawn's time limit
LAYOUTS = {2: "heads", 4: "slots"}


def _run(kind, seed, barge, drain, pages, fused, prefix=False):
    """One fleet-twin run on three replicas, the geometry and traces of
    ``tests/test_torch_fleet.py``."""
    workload = dict(kind=kind, num_sessions=6, seed=seed, p_barge_in=barge,
                    arrival="poisson", rate_rps=2.0)
    if prefix:
        workload.update(prompt_families=1, family_prefix_len=10)
    return dict(replicas=REPLICAS, seed=seed, drain=drain, workload=workload,
                geometry=dict(slots=2, page_size=4,
                              pages_per_seq=12 if prefix else 8,
                              num_pages=pages, fused_step=fused,
                              prefix_cache=prefix))


RUNS = {
    "handoff-fused": _run("handoff", 0, 0.0, None, 128, True),
    # barge-ins, replica 0 drained after the last route, 14 pages a
    # replica: the pools evict and reload
    "tight-fused": _run("interactive", 0, 0.3, (0, 6), 14, True),
    "tight-per-token": _run("interactive", 0, 0.3, (0, 6), 14, False),
    "prefix-fused": _run("handoff", 0, 0.0, None, 128, True, prefix=True),
    # chip_smoke.py's (h5b) at its pre-cut size: 5 sessions on two
    # replicas of 4 slots, pages of 16, 18 a replica, replica 0 drained
    # after the last route; a migration is cancelled for its
    # destination's pressure
    "cancel-fused": dict(
        replicas=2, seed=0, drain=(0, 5),
        workload=dict(kind="interactive", num_sessions=5, seed=0,
                      p_barge_in=0.3, arrival="poisson", rate_rps=1.0),
        geometry=dict(slots=4, page_size=16, pages_per_seq=10,
                      num_pages=18, fused_step=True, prefix_cache=False),
        replay=dict(audio_per_token_s=0.08, round_token_budget=16,
                    prefill_chunk=16, max_prompt=64, max_response=16)),
}
# the one-replica fleet: the sharded-plane test's replay, whose pool of
# 10 pages evicts and reloads
REPLAY = (dict(slots=2, page_size=8, pages_per_seq=8, num_pages=10),
          dict(kind="interactive", num_sessions=4, seed=5, p_barge_in=0.5,
               arrival="poisson", rate_rps=4.0), 5)
ONE = dict(replicas=1, seed=REPLAY[2], drain=None, geometry=REPLAY[0],
           workload=REPLAY[1])
# the live fleet on the 1x2 mesh: (kind, sessions, barge-in) of
# test_live_fleet_on_cpu_matches_twin_decisions, replica 0 drained
# after the last route
LIVE = {"interactive": ("interactive", 4, 0.5), "mixed": ("mixed", 3, 0.0)}
LIVE_KW = {name: dict(kind=kind, sessions=n, barge_in=barge,
                     drain_after_routes=(0, n))
           for name, (kind, n, barge) in LIVE.items()}


@pytest.fixture(scope="module")
def tiny():
    jcfg = j_reduced(j_get_config("qwen2-1.5b"), **CFG_KW)
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    weights = jax.tree.map(np.asarray, jp)
    tcfg = reduced(get_config("qwen2-1.5b"), **CFG_KW)
    return jcfg, jp, tcfg, weights


@pytest.fixture(scope="module")
def mesh_runs(tiny, tmp_path_factory):
    """One spawn a mesh shape, run on first use: every fleet-twin run,
    then (1x4) the one-replica fleet and ``run_replay`` on one sharded
    engine, or (1x2) the live fleet on each trace of ``LIVE``. Returns
    every rank's result."""
    _, _, _, weights = tiny
    runs = {}

    def run(M):
        if M not in runs:
            store = str(tmp_path_factory.mktemp(f"fleet-mesh{M}"))
            args = (dict(RUNS, one=ONE), REPLAY, None) if M == 4 \
                else (RUNS, None, LIVE_KW)
            runs[M] = spawn(f"1x{M}", ranks.fleet_rank, CFG_KW, weights,
                            *args, device="cpu", timeout_s=SPAWN_S,
                            store_dir=store)
        return runs[M]
    return run


@pytest.fixture(scope="module")
def single_runs(tiny):
    """Each run on the JAX package's fleet twin (the one-replica run
    aside) and on the port's single-device fleet."""
    jcfg, jp, tcfg, weights = tiny
    tp = params_from_numpy(weights, "cpu")
    out = {}
    for name, run in dict(RUNS, one=ONE).items():
        want = None if name == "one" else ranks.fleet_replay(
            j_run_fleet_replay,
            lambda clock, **kw: JEngine(jcfg, jp, clock=clock, **kw),
            JWorkloadConfig, JReplayConfig, run)
        got = ranks.fleet_replay(
            run_fleet_replay,
            lambda clock, **kw: PagedRealtimeEngine(tcfg, tp, clock=clock,
                                                    device="cpu", **kw),
            WorkloadConfig, ReplayConfig, run)
        out[name] = (want, got)
    return out


def _expected_handoffs(run):
    """Trace-predictable handoff decisions on a barge-free trace:
    session i routes to i % REPLICAS; its turn-1 handoff lands iff
    target % REPLICAS is a different replica."""
    want = []
    for i, s in enumerate(generate(WorkloadConfig(**run["workload"]))):
        for turn in s.turns[1:2]:
            if turn.handoff and turn.handoff_target % REPLICAS != i % REPLICAS:
                want.append(("handoff", s.session_id, i % REPLICAS,
                             turn.handoff_target % REPLICAS))
    return want


# ======================================================================
# the fleet twin on a mesh
# ======================================================================
@pytest.mark.parametrize("name", list(RUNS))
@pytest.mark.parametrize("M", list(LAYOUTS))
def test_meshed_fleet_replay_matches_reference(mesh_runs, single_runs, M,
                                               name):
    """Three replicas sharding their pages over the mesh, in f32:
    decisions, turn records, each replica's histories, turn stats,
    offload events and transfer stats, the plans and the migration
    counters are the port's single-device fleet's and the JAX fleet
    twin's; every plan ended done, or cancelled as the decision log
    accounts for."""
    want_j, want_t = (dict(r) for r in single_runs[name])
    got = dict(mesh_runs(M)[0][name])
    assert got.pop("kind") == LAYOUTS[M]
    assert want_t.pop("kind") is None and want_j.pop("kind") is None
    assert want_t == want_j
    assert got == want_t
    run = RUNS[name]
    assert got["records"] and got["rounds"] > 0
    assert got["counters"]["migrations"] > 0 \
        and got["counters"]["migration_bytes"] > 0
    moves = [d for d in got["decisions"] if d[0] in ("migrate", "handoff")]
    states = [p[3] for p in got["plans"]]
    assert got["open_plans"] == 0 and len(states) == len(moves)
    assert set(states) <= {"done", "cancelled"}
    if run["geometry"]["num_pages"] < 128:
        assert any(v["evicted"] > 0 for v in got["replicas"])
        assert ("drain", 0) in got["decisions"]
    if name.startswith("cancel"):
        assert [p[4] for p in got["plans"] if p[3] == "cancelled"] \
            == ["dst_pressure"]
    if run["workload"]["kind"] == "handoff":
        assert sorted(d for d in moves) == sorted(_expected_handoffs(run))
    if run["geometry"]["prefix_cache"]:         # shared pages deep-copied
        assert sum(got["detached"]) > 0
        assert len(got["detached"]) == got["counters"]["migrations"]
    else:
        assert all(got["empty"])


def test_one_replica_fleet_on_mesh_is_the_sharded_replay(mesh_runs,
                                                         single_runs):
    """One replica on the 1x4 (slots) mesh: its turn records, streams and
    page traffic are ``run_replay``'s on one sharded engine and on one
    device, on a pool that evicts and reloads."""
    out = mesh_runs(4)[0]
    fleet, replay = out["one"], dict(out["replay"])
    assert replay.pop("kind") == fleet["kind"] == "slots"
    view = fleet["replicas"][0]
    assert fleet["records"] == replay["records"]
    for key in ("histories", "offload_events", "evicted", "reloaded"):
        assert view[key] == replay[key], key
    assert view["evicted"] > 0 and view["reloaded"] > 0
    _, single = single_runs["one"]
    assert fleet["records"] == single["records"]
    assert fleet["replicas"] == single["replicas"]


# ======================================================================
# the live fleet on a mesh
# ======================================================================
@pytest.mark.parametrize("name", list(LIVE))
def test_live_fleet_on_mesh_matches_twin_decisions(tiny, mesh_runs, name):
    """The live gateway over three replicas on the 1x2 (heads) mesh: its
    routes, drains and migration decisions are the single-device twin's
    on the same trace, as the trace predicts them; every session
    completes; on a barge-free trace every decided migration completes;
    every replica ends empty, its invariants held, on one set of
    weights."""
    _, _, tcfg, weights = tiny
    kind, sessions, barge = LIVE[name]
    tp = params_from_numpy(weights, "cpu")
    wl = WorkloadConfig(kind=kind, num_sessions=sessions, seed=0,
                        p_barge_in=barge, arrival="poisson", rate_rps=2.0)
    twin_m, twin = run_fleet_replay(
        lambda clock: PagedRealtimeEngine(tcfg, tp, slots=2, page_size=8,
                                          pages_per_seq=8, num_pages=128,
                                          clock=clock, device="cpu"),
        REPLICAS, wl, ReplayConfig(max_prompt=6, max_response=6),
        seed=0, drain_after_routes=(0, sessions))
    live = mesh_runs(2)[0][f"live-{name}"]
    assert set(twin_m.summary()) == live["summary_keys"]
    routes = [d for d in live["decisions"] if d[0] == "route"]
    assert routes == [d for d in twin.router.decisions if d[0] == "route"]
    assert [r[2] for r in routes] == [i % REPLICAS for i in range(sessions)]
    drains = [d for d in live["decisions"] if d[0] in ("drain", "recover")]
    assert drains == [d for d in twin.router.decisions
                      if d[0] in ("drain", "recover")] == [("drain", 0)]
    want = {s.session_id: [(0, [1, 2][i % 2])]
            for i, s in enumerate(generate(wl))
            if i % REPLICAS == 0 and len(s.turns) >= 2}
    assert want
    moves = {}
    for d in live["decisions"]:
        if d[0] == "migrate":
            moves.setdefault(d[1], []).append((d[2], d[3]))
    twin_moves = {}
    for _, sid, src, dst in twin.router.migration_decisions():
        twin_moves.setdefault(sid, []).append((src, dst))
    assert moves == twin_moves == want
    assert live["completed"] == twin_m.completed_sessions == sessions
    if barge == 0.0:
        assert live["open_plans"] == 0 and live["cancelled"] == 0
        assert len(live["done"]) == live["migrations"] == len(want)
        assert live["migrated_turns"] == len(want)
    for r in live["replicas"]:
        assert r["free"] and r["ended"] and r["kind"] == "heads"
    for sid, src, dst in live["done"]:
        assert sid not in live["replicas"][src]["sessions"]
        assert sid in live["replicas"][dst]["sessions"]
    assert live["shared_weights"]


# ======================================================================
# the follower's loop
# ======================================================================
@pytest.mark.parametrize("M", list(LAYOUTS))
def test_follower_raises_on_unknown_target(mesh_runs, M):
    """A command for an engine the follower does not hold is an error
    that names the engine, never a command ignored."""
    for r, out in enumerate(mesh_runs(M)[1:], start=1):
        assert out["unknown_target"] == (
            f"rank {r}: command 5 for engine 3, which this rank does not "
            f"hold (it holds [0])")
