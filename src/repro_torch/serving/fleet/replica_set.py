"""A fleet of data-parallel paged engines on one shared clock
(DESIGN.md §12).

Each replica is a full ``PagedRealtimeEngine`` — its own page pool, KV
accounting, transfer ledger, monitor, and preloader. The replicas take
one ``params`` dict, so the weights sit on the device once, and the
kernels build once per process, so an N-replica fleet pays one build,
not N. On a mesh every replica shards its pages over the same mesh
(DESIGN.md §9 inside §12), replica i's commands tagged i.

The ``interconnect`` models the replica-to-replica NIC the same way
``core/kv_manager.TransferChannel`` models PCIe: serialized shared
bandwidth, so concurrent migrations queue behind each other and their
modeled network seconds land in the migration on/off-path accounting.
"""
from __future__ import annotations

from typing import Iterator, List

from repro_torch.core.kv_manager import TransferChannel


class ReplicaSet:
    def __init__(self, engines: List, *, interconnect_gb_s: float = 50.0):
        assert engines, "a fleet needs at least one replica"
        clock = engines[0].clock
        assert all(e.clock is clock for e in engines), \
            "replicas must share one clock (one serving timeline)"
        bb = engines[0].kv.channel.block_bytes
        assert all(e.kv.channel.block_bytes == bb for e in engines), \
            "replicas must share a page geometry (same KV bytes/page)"
        ws = engines[0].kv.channel.wire_scale
        assert all(e.kv.channel.wire_scale == ws for e in engines), \
            "replicas must share a KV wire format (same kv_quant)"
        # on a mesh, replica i's device commands name engine i, which
        # every follower rank holds at that index
        mesh = engines[0].mesh
        assert all(e.mesh is mesh for e in engines) and (
            mesh is None or [e.mesh_index for e in engines]
            == list(range(len(engines)))), \
            "replicas on a mesh share it, replica i as its engine i"
        self.engines = list(engines)
        self.clock = clock
        self.block_bytes = bb
        # MIGRATE chunks carry host copies already in wire format, so
        # the modeled NIC prices the same compressed bytes PCIe does
        self.interconnect = TransferChannel(interconnect_gb_s, bb,
                                            wire_scale=ws)

    def __len__(self) -> int:
        return len(self.engines)

    def __getitem__(self, i: int):
        return self.engines[i]

    def __iter__(self) -> Iterator:
        return iter(self.engines)

    # ------------------------------------------------- pressure signals
    def live_slots(self, i: int) -> int:
        return sum(1 for s in self.engines[i].slot_state.values()
                   if s is not None and s.request.is_live())

    def free_pages(self, i: int) -> int:
        return self.engines[i].pool.free_pages

    def occupancy(self) -> List[float]:
        return [1.0 - e.pool.free_pages / e.num_pages for e in self.engines]
