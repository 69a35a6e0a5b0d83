"""Session routing for the replica fleet (DESIGN.md §12).

The router owns three decisions, all appended to one auditable log the
fleet differential compares between the asyncio gateway and its
virtual-time twin:

- ``("route", sid, replica)`` — admission: a new session lands on the
  least-pressured non-draining replica. Pressure is (sessions placed,
  live slots, -free pages), index-tiebroken; at connect time every
  replica is pristine, so routing degenerates to deterministic
  round-robin in trace order — which is exactly what makes the
  decision log twin-comparable.
- ``("drain", replica)`` / ``("recover", replica)`` — a replica stops
  taking new sessions. Either injected deterministically
  (``drain_after_routes``, used by the differential and the bench's
  forced-migration scenario) or decided by the hardened
  ``StragglerMitigator`` fed with per-replica round durations; the
  mitigator's consecutive-good-round forgiveness lifts a straggler
  drain again.
- ``("migrate", sid, src, dst)`` — at a speech start, a session placed
  on a draining replica moves to a non-draining replica in ring order
  from the source, offset by the session's admission index so a
  drained replica's sessions spread over the healthy ones instead of
  dog-piling its ring neighbour. Admission-index ring order (not
  pressure argmin) is deliberate: the destination choice must not
  depend on timing-sensitive cross-session pool state, or the twin and
  the live gateway would diverge on identical traces — route order is
  the one cross-session ordering both planes share.

``rebalance_margin`` adds live-only pressure migrations (source holds
``margin`` more sessions than the lightest replica); the differential
config leaves it None because its trigger *is* timing-sensitive — the
soak and unit tests cover it instead.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.distributed.fault_tolerance import StragglerMitigator
from repro_torch.serving.fleet.replica_set import ReplicaSet


class SessionRouter:
    def __init__(self, replicas: ReplicaSet, *,
                 mitigator: Optional[StragglerMitigator] = None,
                 strike_threshold: int = 3,
                 drain_after_routes: Optional[Tuple[int, int]] = None,
                 rebalance_margin: Optional[int] = None):
        self.replicas = replicas
        self.mitigator = mitigator
        self.strike_threshold = strike_threshold
        self.drain_after_routes = drain_after_routes
        self.rebalance_margin = rebalance_margin
        self.placement: Dict[str, int] = {}
        self.route_index: Dict[str, int] = {}   # admission order
        self.open_count: List[int] = [0] * len(replicas)
        self.routed: List[int] = [0] * len(replicas)   # cumulative
        self.draining: set = set()
        self._straggler_drained: set = set()
        self.decisions: List[tuple] = []
        self.n_routes = 0

    # ------------------------------------------------------- admission
    def _pressure_key(self, i: int) -> tuple:
        return (self.open_count[i], self.replicas.live_slots(i),
                -self.replicas.free_pages(i), i)

    def _candidates(self) -> List[int]:
        c = [i for i in range(len(self.replicas))
             if i not in self.draining]
        return c or list(range(len(self.replicas)))

    def route(self, session_id: str) -> int:
        assert session_id not in self.placement, session_id
        i = min(self._candidates(), key=self._pressure_key)
        self.placement[session_id] = i
        self.route_index[session_id] = self.n_routes
        self.open_count[i] += 1
        self.routed[i] += 1
        self.decisions.append(("route", session_id, i))
        self.n_routes += 1
        if self.drain_after_routes is not None:
            r, n = self.drain_after_routes
            if self.n_routes == n:
                self.drain(r)
        return i

    def on_session_end(self, session_id: str) -> None:
        i = self.placement.pop(session_id, None)
        self.route_index.pop(session_id, None)
        if i is not None:
            self.open_count[i] -= 1

    # ------------------------------------------------------- migration
    def ring_next(self, src: int, skip: int = 0) -> Optional[int]:
        """The ``skip``-th non-draining replica in ring order after
        ``src`` (wrapping over the healthy set)."""
        cands = []
        n = len(self.replicas)
        for k in range(1, n):
            i = (src + k) % n
            if i not in self.draining:
                cands.append(i)
        if not cands:
            return None
        return cands[skip % len(cands)]

    def maybe_migrate(self, session_id: str) -> Optional[int]:
        """Decide (and log) a migration for an idle session at its
        speech start; returns the destination replica or None. The
        caller owns candidacy (idle, has KV, not already migrating) —
        this is pure policy."""
        src = self.placement[session_id]
        if src in self.draining:
            dst = self.ring_next(src,
                                 self.route_index.get(session_id, 0))
            if dst is not None:
                self.decisions.append(("migrate", session_id, src, dst))
                return dst
            return None
        if self.rebalance_margin is not None:
            dst = min(self._candidates(), key=self._pressure_key)
            if dst != src and self.open_count[src] \
                    - self.open_count[dst] >= self.rebalance_margin:
                self.decisions.append(("migrate", session_id, src, dst))
                return dst
        return None

    def request_handoff(self, session_id: str,
                        target: int) -> Optional[int]:
        """Client-requested agent handoff to a specific model config.
        Pure policy like ``maybe_migrate`` (the caller owns candidacy):
        the requested target maps onto the fleet modulo its size —
        deterministic from the trace alone, so the decision log stays
        twin-comparable — and self-moves or draining destinations are
        refused (the session simply stays put)."""
        src = self.placement[session_id]
        dst = target % len(self.replicas)
        if dst == src or dst in self.draining:
            return None
        self.decisions.append(("handoff", session_id, src, dst))
        return dst

    def on_migrated(self, session_id: str, dst: int) -> None:
        src = self.placement[session_id]
        self.placement[session_id] = dst
        self.open_count[src] -= 1
        self.open_count[dst] += 1

    # ----------------------------------------------- drain / straggler
    def drain(self, i: int) -> None:
        """Stop routing to replica ``i`` and mark its sessions for
        migration at their next speech start. The last healthy replica
        can never be drained — someone has to serve."""
        if i in self.draining \
                or len(self.draining) + 1 >= len(self.replicas):
            return
        self.draining.add(i)
        self.decisions.append(("drain", i))

    def recover(self, i: int) -> None:
        if i not in self.draining:
            return
        self.draining.discard(i)
        self._straggler_drained.discard(i)
        if self.mitigator is not None:
            self.mitigator.forget(f"replica{i}")
        self.decisions.append(("recover", i))

    def observe_round(self, i: int, duration_s: float) -> None:
        """Feed one executed round's duration into the straggler
        mitigator; drain the replica when it crosses the strike
        threshold, and lift a straggler drain once the mitigator's
        consecutive-good-round streak forgives it."""
        if self.mitigator is None:
            return
        src = f"replica{i}"
        self.mitigator.observe(src, duration_s)
        if i not in self.draining:
            if self.mitigator.should_evict(src, self.strike_threshold):
                self.drain(i)                # no-op on the last replica
                if i in self.draining:
                    self._straggler_drained.add(i)
        elif i in self._straggler_drained \
                and src not in self.mitigator.strikes:
            self.recover(i)

    # ------------------------------------------------------- queries
    def migration_decisions(self) -> List[tuple]:
        return [d for d in self.decisions if d[0] == "migrate"]

    def handoff_decisions(self) -> List[tuple]:
        return [d for d in self.decisions if d[0] == "handoff"]
