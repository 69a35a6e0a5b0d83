"""Live cross-replica KV migration (DESIGN.md §12).

A migration is a plan over the engines' existing chunked transfer
machinery — no third data path. It fires at a speech start (like the
§5.2 preload, it hides in the window where the user is talking and the
session cannot need its KV) and walks four states:

  DRAINING  the source queues its whole device-resident context as
            MIGRATE-tagged copy-then-free offload chunks
            (``migrate_out_begin``); they drain through the same
            per-round / idle-loop budgets as eviction traffic.
  NETWORK   every page is host-resident: the session state transplants
            wholesale (``migrate_out_finalize`` -> ``migrate_in_adopt``,
            placement flips at this instant) while the page payload
            rides the modeled replica interconnect.
  LANDING   the payload has arrived; the destination pages it back in
            with the ordinary speech-time preload, so the on/off-path
            split of the page-in needs no new accounting — it *is* a
            reload split.
  DONE      the session's next turn was admitted on the destination
            (``rec.migrated`` marks it for the bench's migrated-TTFP
            comparison) — or the user hung up after handoff.

Cancellation rules (all zero-copy on the not-yet-moved bytes):

  barge-in, pre-handoff   ``migrate_out_cancel`` — queued chunks drop
                          from the ledger, their pages stay resident;
                          the interrupting turn runs on the source.
  hangup, pre-handoff     plan cancelled; the normal hangup path frees
                          everything (the ledger's cancel-session +
                          pool release already leak nothing).
  turn request, pre-handoff   not a cancel: the drain completes on
                          demand, its residual (plus the network
                          window) charged on-path — mirroring the
                          synchronous-reload fallback.
  destination OutOfPages  at handoff the destination must have room
                          (free + reclaimable); otherwise the plan
                          cancels and the session stays on the source,
                          its already-drained pages simply
                          host-resident (next turn reloads them).
  barge/hangup, post-handoff   no cancel — the session is already the
                          destination's; the barge or hangup rides the
                          normal single-replica paths there.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.serving.fleet.replica_set import ReplicaSet
from repro_torch.serving.fleet.router import SessionRouter

DRAINING = "draining"
NETWORK = "network"
LANDING = "landing"
DONE = "done"
CANCELLED = "cancelled"


@dataclass
class MigrationPlan:
    session_id: str
    src: int
    dst: int
    t_start: float
    pages: int = 0
    state: str = DRAINING
    net_done: float = 0.0
    reason: str = ""                   # cancellation reason, if any
    kind: str = "migrate"              # migrate | handoff (client-requested)


class MigrationCoordinator:
    def __init__(self, replicas: ReplicaSet, router: SessionRouter,
                 metrics):
        self.replicas = replicas
        self.router = router
        self.metrics = metrics
        self.plans: Dict[str, MigrationPlan] = {}
        self.log: List[MigrationPlan] = []

    # ------------------------------------------------------- lifecycle
    def start(self, session_id: str, src: int, dst: int,
              now: float, *, kind: str = "migrate") -> MigrationPlan:
        assert session_id not in self.plans, session_id
        pages = self.replicas[src].migrate_out_begin(session_id)
        plan = MigrationPlan(session_id, src, dst, now, pages=pages,
                             kind=kind)
        self.plans[session_id] = plan
        return plan

    def pump(self, now: float) -> None:
        """Advance every plan one observable step. Called by both fleet
        gateways between event delivery and the round, so state flips
        are atomic with rounds under the single-threaded contract."""
        for plan in list(self.plans.values()):
            if plan.state == DRAINING:
                src = self.replicas[plan.src]
                if src.migrate_out_pending(plan.session_id) == 0:
                    self._handoff(plan, now)
            elif plan.state == NETWORK and now >= plan.net_done:
                self._arrive(plan, now)

    def _handoff(self, plan: MigrationPlan, now: float) -> bool:
        """Source drain complete: transplant the session and put its
        pages on the wire. Returns False if the destination had no room
        (plan cancelled, session stays on the source)."""
        sid = plan.session_id
        src, dst = self.replicas[plan.src], self.replicas[plan.dst]
        if dst.kv.free_blocks + dst.kv.reclaimable_blocks(now) \
                < plan.pages:
            self._cancel(plan, reason="dst_pressure")
            return False
        tr = self.replicas.interconnect.submit(sid, plan.pages, now,
                                               background=True)
        plan.net_done = tr.done
        state = src.migrate_out_finalize(sid)
        dst.migrate_in_adopt(sid, state)
        self.router.on_migrated(sid, plan.dst)
        plan.state = NETWORK
        m = self.metrics
        m.migrations += 1
        if plan.kind == "handoff":
            m.handoffs += 1
        m.migration_bytes += \
            self.replicas.interconnect.wire_bytes(plan.pages)
        # drain + network seconds land off-path here; a demanded
        # completion reclassifies its residual below
        m.migration_off_path_s += \
            src.kv.channel.transfer_time(plan.pages) + (tr.done - now)
        return True

    def _arrive(self, plan: MigrationPlan, now: float,
                fire_preload: bool = True) -> None:
        """Payload landed on the destination: page it back in through
        the normal speech-time preload (admission-checked, chunked,
        cancellable, OutOfPages-recoverable at turn start). NOT
        ``user_speech_start`` — the speech already started on the
        source; re-announcing it would double-update the reply-gap
        EMA."""
        sid = plan.session_id
        plan.state = LANDING
        dst = self.replicas[plan.dst]
        sess = dst.sessions.get(sid)
        if fire_preload and sess is not None and not sess.ended \
                and all(s is None or s.session_id != sid
                        for s in dst.slot_state.values()):
            dst.preloader.on_speech_start(sid, now)

    def _reclass_on_path(self, s: float) -> None:
        if s <= 0.0:
            return
        self.metrics.migration_off_path_s -= s
        self.metrics.migration_on_path_s += s

    def demand_complete(self, session_id: str, now: float) -> None:
        """A turn request arrived before the migration finished: force
        it through (the decided move always completes on the natural
        trace — cancellation is reserved for barge/hangup/pressure),
        charging the drain residual and the network window on-path via
        the clock, exactly like a synchronous reload stall."""
        plan = self.plans.get(session_id)
        if plan is None:
            return
        clock = self.replicas.clock
        if plan.state == DRAINING:
            src = self.replicas[plan.src]
            pend = src.migrate_out_pending(session_id)
            src.transfer.drain_offloads_until(
                now, lambda: src.migrate_out_pending(session_id) == 0)
            if not self._handoff(plan, now):
                return                       # dst full: turn runs on src
            on_path = src.kv.channel.transfer_time(pend) \
                + max(0.0, plan.net_done - now)
            self._reclass_on_path(on_path)
            clock.tick(on_path)
            self._arrive(plan, clock.now(), fire_preload=False)
        elif plan.state == NETWORK:
            residual = max(0.0, plan.net_done - now)
            self._reclass_on_path(residual)
            clock.tick(residual)
            self._arrive(plan, clock.now(), fire_preload=False)
        # LANDING: nothing to force — turn admission settles the reload

    def on_turn_admitted(self, session_id: str, request, rec) -> None:
        """The migrated session's next turn bound to a destination
        slot: the admission's reload split *is* the migration page-in
        split. Completes the plan."""
        plan = self.plans.get(session_id)
        if plan is None or plan.state != LANDING:
            return
        self.metrics.migration_on_path_s += request.reload_stall_s
        self.metrics.migration_off_path_s += request.reload_off_path_s
        rec.migrated = True
        if plan.kind == "handoff":
            rec.handoff = True
        plan.state = DONE
        self.log.append(self.plans.pop(session_id))

    # ---------------------------------------------------- cancellation
    def on_barge(self, session_id: str, now: float) -> None:
        plan = self.plans.get(session_id)
        if plan is not None and plan.state == DRAINING:
            # the interrupting utterance becomes a turn on the source
            # almost immediately — cancelling beats paying the drain
            # residual on-path. Post-handoff the session already lives
            # on the destination; the barge rides normally there.
            self._cancel(plan, reason="barge")

    def on_hangup(self, session_id: str, now: float) -> None:
        plan = self.plans.get(session_id)
        if plan is None:
            return
        if plan.state == DRAINING:
            self._cancel(plan, reason="hangup")
        else:
            # bytes already moved; the session just ended before its
            # next turn — the migration itself completed
            plan.state = DONE
            self.log.append(self.plans.pop(session_id))

    def _cancel(self, plan: MigrationPlan, *, reason: str) -> None:
        src = self.replicas[plan.src]
        src.migrate_out_cancel(plan.session_id)
        plan.state = CANCELLED
        plan.reason = reason
        self.log.append(self.plans.pop(plan.session_id))

    # -------------------------------------------------------- queries
    def completed(self) -> List[MigrationPlan]:
        return [p for p in self.log if p.state == DONE]

    def cancelled(self) -> List[MigrationPlan]:
        return [p for p in self.log if p.state == CANCELLED]


def consider_migration(gw, session_id: str) -> bool:
    """Shared speech-start hook for both fleet gateways: candidacy
    check + router decision + plan start. Returns True iff the session
    has an active plan afterwards — the caller must then suppress the
    ordinary source-side preload (its pages are leaving; reloading them
    would cancel the migration's own offload chunks)."""
    mig, router = gw.migrator, gw.router
    if session_id in mig.plans:
        return True
    src = router.placement.get(session_id)
    if src is None:
        return False
    eng = gw.replicas[src]
    sess = eng.sessions.get(session_id)
    if sess is None or sess.ended or sess.kv_len == 0:
        return False                     # nothing to move yet
    if session_id in gw._pending:
        return False                     # a turn is already queued
    if any(s is not None and s.session_id == session_id
           for s in eng.slot_state.values()):
        return False                     # live turn: migration waits
    dst = router.maybe_migrate(session_id)
    if dst is None:
        return False
    mig.start(session_id, src, dst, gw.clock.now())
    return True


def consider_handoff(gw, session_id: str, target: int) -> bool:
    """Shared HandoffRequest hook for both fleet gateways: same
    candidacy rules as ``consider_migration`` (idle, has KV, no queued
    turn) but the destination is the client's requested model config,
    not a drain/rebalance decision. The transfer itself is the ordinary
    four-state migration plan, tagged kind='handoff'. Returns True iff
    a plan is active afterwards — the caller then suppresses the
    source-side preload at the following speech start (the plan's
    ``consider_migration`` short-circuit does that automatically)."""
    mig, router = gw.migrator, gw.router
    if session_id in mig.plans:
        return True                      # one move at a time
    src = router.placement.get(session_id)
    if src is None:
        return False
    eng = gw.replicas[src]
    sess = eng.sessions.get(session_id)
    if sess is None or sess.ended or sess.kv_len == 0:
        return False                     # nothing committed to hand off
    if session_id in gw._pending:
        return False
    if any(s is not None and s.session_id == session_id
           for s in eng.slot_state.values()):
        return False                     # live turn: the move must wait
    dst = router.request_handoff(session_id, target)
    if dst is None:
        return False
    mig.start(session_id, src, dst, gw.clock.now(), kind="handoff")
    return True
