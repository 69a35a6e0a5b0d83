"""The asyncio fleet gateway (DESIGN.md §12).

A ``RealtimeGateway`` whose engine is a ``ReplicaSet``: the router picks
a replica at connect, every per-session path resolves through the
placement map (the base gateway's ``_eng`` hook), and each control
round runs Algorithm 1 once per replica over that replica's slots and
its share of the pending queue. Migration plans advance in ``_pump`` —
between event delivery and the round, atomic under the single-threaded
asyncio contract (DESIGN.md §4): a round, a barge-in abort, and a
migration state flip can never interleave.

Round durations (real ``perf_counter`` seconds per executed replica
round, plus any injected test lag) feed the router's straggler
mitigator; the virtual-time twin (fleet/replay.py) feeds a constant
``round_dt`` instead, which is why the differential config disables the
mitigator — wall time is the one input the twin cannot reproduce.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

from repro_torch.distributed.fault_tolerance import StragglerMitigator
from repro_torch.serving.gateway.events import (BargeIn, Hangup,
                                                SpeechStart, TurnRequest)
from repro_torch.serving.gateway.gateway import (GatewayConfig,
                                                 RealtimeGateway,
                                                 build_scheduler,
                                                 control_round)
from repro_torch.serving.fleet.migration import (MigrationCoordinator,
                                                 consider_handoff,
                                                 consider_migration)
from repro_torch.serving.fleet.replica_set import ReplicaSet
from repro_torch.serving.fleet.router import SessionRouter
from repro_torch.serving.metrics import Metrics


class FleetGateway(RealtimeGateway):
    def __init__(self, replicas: ReplicaSet, *,
                 cfg: Optional[GatewayConfig] = None,
                 mitigator: Optional[StragglerMitigator] = None,
                 strike_threshold: int = 3,
                 drain_after_routes: Optional[Tuple[int, int]] = None,
                 rebalance_margin: Optional[int] = None):
        self.replicas = replicas
        self.engine = replicas[0]       # single-engine compat surface
        self.cfg = cfg or GatewayConfig()
        self.clock = replicas.clock
        self._init_common()
        self.schedulers = [
            build_scheduler(self.cfg.policy, e.monitor, e.kv.occupancy,
                            chunk=self.sched_chunk(),
                            decode_chunk=max(1, min(
                                1 + getattr(e, "spec_decode", 0),
                                self.cfg.round_token_budget)),
                            sc=self.cfg.sched)
            for e in replicas]
        self.scheduler = self.schedulers[0]   # hold-wake estimates
        self.router = SessionRouter(
            replicas, mitigator=mitigator,
            strike_threshold=strike_threshold,
            drain_after_routes=drain_after_routes,
            rebalance_margin=rebalance_margin)
        self.migrator = MigrationCoordinator(replicas, self.router,
                                             self._metrics)
        # test hook: extra seconds added to replica i's observed round
        # durations (forced straggler injection for soak/bench)
        self.round_lag_s: Dict[int, float] = {}
        # peak pool occupancy per replica (end-state is always empty —
        # every session has hung up by the time metrics are read)
        self._peak_occ = [0.0] * len(replicas)

    # ------------------------------------------------ engine indirection
    def _eng(self, sid: str):
        return self.replicas[self.router.placement[sid]]

    def _engines(self):
        return tuple(self.replicas)

    # ------------------------------------------------------------ clients
    def connect(self, session_id: str):
        self.router.route(session_id)
        return super().connect(session_id)

    # ------------------------------------------------------------ events
    def _handle(self, ev) -> None:
        sid = ev.session_id
        now = self.clock.now()
        if isinstance(ev, SpeechStart):
            if consider_migration(self, sid):
                # migrating: speech telemetry still lands, but the
                # source preload must not fire — reloading the pages
                # would cancel the migration's own offload chunks
                self._eng(sid).monitor.on_speech_start(
                    sid, ev.expected_dur_s)
                return
        elif isinstance(ev, TurnRequest):
            self.migrator.demand_complete(sid, now)
        elif isinstance(ev, BargeIn):
            self.migrator.on_barge(sid, now)
        elif isinstance(ev, Hangup):
            self.migrator.on_hangup(sid, now)
        super()._handle(ev)
        if isinstance(ev, Hangup):
            self.router.on_session_end(sid)

    def _on_handoff(self, ev) -> None:
        # client-requested agent handoff: a targeted migration plan; the
        # following SpeechStart's consider_migration sees it and keeps
        # the source preload from re-paging the departing KV
        consider_handoff(self, ev.session_id, ev.target)

    # ------------------------------------------------------------ rounds
    def _record_admit(self, sid, r) -> None:
        super()._record_admit(sid, r)
        self.migrator.on_turn_admitted(sid, r, self._rec(sid))

    def _pump(self) -> None:
        self.migrator.pump(self.clock.now())

    def _round(self) -> bool:
        ran = False
        for i, eng in enumerate(self.replicas):
            pend = {sid: p for sid, p in self._pending.items()
                    if self.router.placement.get(sid) == i}
            before = set(pend)
            t0 = time.perf_counter()
            decision, chunks, admitted = control_round(
                eng, self.schedulers[i], pend,
                token_budget=self.cfg.round_token_budget,
                frontier_cap_s=self.cfg.frontier_cap_s,
                record_admit=self._record_admit)
            # control_round pops what it admitted (and re-inserts an
            # OutOfPages requeue); sync the filtered view back
            for sid in before - set(pend):
                self._pending.pop(sid, None)
            if decision is None:
                continue
            self.last_decision = decision
            if chunks:
                sids = {j: eng.slot_state[j].session_id for j in chunks}
                events = eng.run_round(chunks)
                self.rounds += 1
                self._dispatch(events, sids)
                self.router.observe_round(
                    i, time.perf_counter() - t0
                    + self.round_lag_s.get(i, 0.0))
                ran = True
            elif admitted:
                ran = True
            self._peak_occ[i] = max(
                self._peak_occ[i],
                1.0 - eng.pool.free_pages / eng.num_pages)
        return ran

    # ------------------------------------------------------------ metrics
    def metrics(self) -> Metrics:
        m = super().metrics()
        m.replica_occupancy = list(self._peak_occ)
        return m
