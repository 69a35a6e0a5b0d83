"""Replica fleet: data-parallel paged engines behind one gateway with
live cross-replica KV migration (DESIGN.md §12).

Layout:
  replica_set.py  N independent ``PagedRealtimeEngine`` instances on one
                  shared clock, plus the modeled replica interconnect
  router.py       session admission / affinity / pressure-aware load
                  balancing, drain + straggler handling — every routing
                  and migration decision, as an auditable log
  migration.py    the live-migration coordinator: drain -> network ->
                  landing plans over the engines' MIGRATE-tagged
                  transfer ledger, with the cancellation rules
  gateway.py      asyncio ``FleetGateway`` (a ``RealtimeGateway`` whose
                  per-session paths resolve through the router)
  replay.py       deterministic virtual-time fleet twin — the router
                  differential harness
  harness.py      one-call end-to-end fleet runner (serve.py
                  --replicas N, chip_smoke.py, tests)

All but the harness are copies of the reference's modules; the harness
builds the replicas on one shared set of weights.
"""
from repro_torch.serving.fleet.gateway import FleetGateway
from repro_torch.serving.fleet.harness import build_fleet_gateway, \
    run_fleet_workload
from repro_torch.serving.fleet.migration import (MigrationCoordinator,
                                                 MigrationPlan)
from repro_torch.serving.fleet.replay import (FleetReplayGateway,
                                              run_fleet_replay)
from repro_torch.serving.fleet.replica_set import ReplicaSet
from repro_torch.serving.fleet.router import SessionRouter

__all__ = [
    "ReplicaSet", "SessionRouter", "MigrationCoordinator",
    "MigrationPlan", "FleetGateway", "FleetReplayGateway",
    "build_fleet_gateway", "run_fleet_workload", "run_fleet_replay",
]
