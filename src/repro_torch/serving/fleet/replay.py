"""Deterministic virtual-time twin of the fleet gateway
(DESIGN.md §12).

Same construction as ``gateway/replay.py`` vs the asyncio gateway, one
level up: the same ``SessionRouter`` and ``MigrationCoordinator`` code
drive the same per-replica ``control_round`` body on a ``ReplayClock``
that the replay loop owns. Routing happens for the whole trace up front — the
synchronous mirror of the asyncio load generator, whose session tasks
all connect in trace order before any event is processed — and rounds
feed the router a constant ``round_dt`` duration (the one signal wall
time produces that virtual time cannot), so differential configs keep
the straggler mitigator off and inject drains deterministically via
``drain_after_routes``.

The router's decision log — routes, drains, migrations — is the
comparison surface for the live-vs-twin fleet differential
(``tests/test_torch_fleet.py`` holds it to the JAX package's twin).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.distributed.fault_tolerance import StragglerMitigator
from repro_torch.serving.fleet.migration import (MigrationCoordinator,
                                                 consider_handoff,
                                                 consider_migration)
from repro_torch.serving.fleet.replica_set import ReplicaSet
from repro_torch.serving.fleet.router import SessionRouter
from repro_torch.serving.gateway.gateway import build_scheduler, control_round
from repro_torch.serving.gateway.replay import (ReplayClock,
                                                ReplayConfig,
                                                ReplayGateway)
from repro_torch.serving.workload import WorkloadConfig


class FleetReplayGateway(ReplayGateway):
    def __init__(self, replicas: ReplicaSet, workload: WorkloadConfig,
                 cfg: Optional[ReplayConfig] = None, *, seed: int = 0,
                 mitigator: Optional[StragglerMitigator] = None,
                 strike_threshold: int = 3,
                 drain_after_routes: Optional[Tuple[int, int]] = None,
                 rebalance_margin: Optional[int] = None):
        self.replicas = replicas
        super().__init__(replicas[0], workload, cfg, seed=seed)
        sc = self.cfg.sched or SchedulerConfig()
        chunk = max(1, min(self.cfg.prefill_chunk,
                           self.cfg.round_token_budget))
        self.schedulers = [
            build_scheduler(self.cfg.policy, e.monitor, e.kv.occupancy,
                            chunk=chunk, sc=sc)
            for e in replicas]
        self.router = SessionRouter(
            replicas, mitigator=mitigator,
            strike_threshold=strike_threshold,
            drain_after_routes=drain_after_routes,
            rebalance_margin=rebalance_margin)
        self.migrator = MigrationCoordinator(replicas, self.router,
                                             self.metrics)
        # route the whole trace up front, in trace order — the mirror
        # of the asyncio clients' connect-before-first-await discipline
        for s in self._trace:
            self.router.route(s.session_id)

    # ------------------------------------------------ engine indirection
    def _eng(self, sid: str):
        return self.replicas[self.router.placement[sid]]

    def _engines(self):
        return tuple(self.replicas)

    def _pump(self) -> None:
        self.migrator.pump(self.clock.now())

    # ----------------------------------------------------- client events
    def _handoff_request(self, sid: str, target: int) -> None:
        consider_handoff(self, sid, target)

    def _speech_start(self, s, ti: int) -> None:
        sid = s.session_id
        _, _, speech_dur, _, turn = self._clamped_turn(s, ti)
        if turn.handoff:
            self._handoff_request(sid, turn.handoff_target)
        if consider_migration(self, sid):
            # migrating (drain/rebalance or a just-started handoff):
            # telemetry only; the source preload must not fire (it
            # would cancel the migration's own offload chunks)
            if turn.frame_period_tokens > 0.0:
                self._eng(sid).monitor.on_speech_start(sid)
                self._push(self.clock.now(), self._turn_request, s, ti)
            else:
                self._eng(sid).monitor.on_speech_start(sid, speech_dur)
                self._push(self.clock.now() + speech_dur,
                           self._turn_request, s, ti)
            return
        super()._speech_start(s, ti)

    def _turn_request(self, s, ti: int, resume: bool = False) -> None:
        self.migrator.demand_complete(s.session_id, self.clock.now())
        super()._turn_request(s, ti, resume)

    def _barge(self, s, ti: int) -> None:
        self.migrator.on_barge(s.session_id, self.clock.now())
        super()._barge(s, ti)

    def _hangup(self, s) -> None:
        self.migrator.on_hangup(s.session_id, self.clock.now())
        super()._hangup(s)
        self.router.on_session_end(s.session_id)

    # ------------------------------------------------------------ rounds
    def _record_admit(self, sid, r) -> None:
        super()._record_admit(sid, r)
        self.migrator.on_turn_admitted(sid, r, self._rec(sid))

    def _round(self) -> bool:
        ran = False
        for i, eng in enumerate(self.replicas):
            pend = {sid: p for sid, p in self._pending.items()
                    if self.router.placement.get(sid) == i}
            before = set(pend)
            decision, chunks, admitted = control_round(
                eng, self.schedulers[i], pend,
                token_budget=self.cfg.round_token_budget,
                frontier_cap_s=self.cfg.frontier_cap_s,
                record_admit=self._record_admit)
            for sid in before - set(pend):
                self._pending.pop(sid, None)
            if decision is None:
                continue
            if chunks:
                sids = {j: eng.slot_state[j].session_id for j in chunks}
                events = eng.run_round(chunks)
                self.rounds += 1
                self._dispatch(events, sids)
                self.router.observe_round(i, self.cfg.round_dt)
                ran = True
            elif admitted:
                ran = True
        return ran

    def run(self, **kw):
        m = super().run(**kw)
        m.replica_occupancy = self.replicas.occupancy()
        return m


def run_fleet_replay(engine_factory, n_replicas: int,
                     workload: WorkloadConfig,
                     cfg: Optional[ReplayConfig] = None, *, seed: int = 0,
                     check_invariants: bool = True,
                     interconnect_gb_s: float = 50.0, **fleet_kw):
    """Build ``n_replicas`` engines on one ReplayClock via
    ``engine_factory(clock)``, replay the workload through the fleet
    twin, return (metrics, FleetReplayGateway)."""
    clock = ReplayClock()
    engines = [engine_factory(clock) for _ in range(n_replicas)]
    rs = ReplicaSet(engines, interconnect_gb_s=interconnect_gb_s)
    gw = FleetReplayGateway(rs, workload, cfg, seed=seed, **fleet_kw)

    def check() -> None:
        for e in engines:
            e.check_invariants()

    gw.run(check_every_round=check if check_invariants else None)
    return gw.metrics, gw
