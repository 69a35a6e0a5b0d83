"""Speech-triggered KV preloading (paper §5.2).

Speech start / barge-in fire a best-effort background DRAM->HBM preload.
Admission requires the transfer to hide inside the predicted window before
LLM-stage execution (remaining utterance + encode delay), under current
channel pressure. Admitted preloads protect the session KV from eviction
for a bounded TTL; cancellation or admission failure falls back to the
synchronous on-path load — latency is affected, correctness never is.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.core.kv_manager import KVManager, Transfer


@dataclass
class PreloadStats:
    triggered: int = 0
    admitted: int = 0
    skipped: int = 0          # admission check failed
    cancelled: int = 0
    hits: int = 0             # next turn found warm KV
    sync_fallbacks: int = 0


@dataclass
class PendingPreload:
    session_id: str
    transfer: Transfer
    deadline: float
    # merge accounting: a second admission before the turn arrives
    # (speech -> barge-in) folds into the same logical entry instead of
    # orphaning the first transfer — `blocks` and `span_s` accumulate
    # across the merged transfers so cancel rollback and the off-path
    # split stay page- and second-exact
    blocks: int = 0
    span_s: float = 0.0


class Preloader:
    def __init__(self, kv: KVManager, monitor, *,
                 encode_delay_s: float = 0.15,
                 speech_prior_s: float = 2.0,
                 safety_margin: float = 0.9,
                 pressure_cap: float = 0.9,
                 enabled: bool = True):
        self.kv = kv
        self.monitor = monitor
        self.encode_delay_s = encode_delay_s
        self.speech_prior_s = speech_prior_s
        self.safety_margin = safety_margin
        self.pressure_cap = pressure_cap
        self.enabled = enabled
        self.pending: Dict[str, PendingPreload] = {}
        self.stats = PreloadStats()
        # per-turn (on_path_s, off_path_s) reload split, recorded by
        # on_turn_ready and read once by the engine via pop_split — the
        # shared metrics schema reports both halves (DESIGN.md §10)
        self._last_split: Dict[str, tuple] = {}
        # how the last on_turn_ready classified the turn, so a
        # saturated-pool requeue can undo the count (the retry will
        # classify the same logical turn again)
        self._last_class: Dict[str, str] = {}

    # ------------------------------------------------------------ trigger
    def on_speech_start(self, sid: str, now: float) -> Optional[Transfer]:
        """Called on VAD speech-start or barge-in for the session."""
        if not self.enabled:
            return None
        self.stats.triggered += 1
        # always protect resident KV of a speaking session (§5.2)
        self.kv.protect(sid, now)
        self.kv.refresh_session(sid, now)
        missing = self.kv.missing_blocks(sid)
        if missing <= 0:
            return None
        view = self.monitor.view(sid)
        if view is not None and view.expected_speech_end is not None:
            window = max(0.0, view.expected_speech_end - now) \
                + self.encode_delay_s
        elif view is not None \
                and getattr(view, "frame_period_s", 0.0) > 0.0:
            # full duplex: the turn request fires at speech start, so
            # the only window is one frame period — honest admission
            # (a transfer that cannot hide in a frame is refused)
            window = view.frame_period_s + self.encode_delay_s
        else:
            window = self.speech_prior_s + self.encode_delay_s
        # only blocks whose bytes truly sit on the host cross the
        # channel (in-flight copy-then-free offloads cancel for free)
        cost = self.kv.channel.transfer_time(self.kv.transfer_blocks(sid)) \
            + self.kv.channel.queue_delay(now)
        if cost > window * self.safety_margin:
            self.stats.skipped += 1
            return None
        # bounded background work (§5.2): never preload into a pool under
        # pressure — the eviction it would force hurts live requests more
        # than the hidden transfer helps this one
        if self.kv.occupancy() > self.pressure_cap \
                and missing > self.kv.free_blocks:
            self.stats.skipped += 1
            return None
        transfer = self.kv.reload(sid, now, background=True)
        if transfer is None:
            self.stats.skipped += 1
            return None
        self.stats.admitted += 1
        span = transfer.done - transfer.start
        prior = self.pending.get(sid)
        if prior is not None and not prior.transfer.cancelled:
            # double speech-start (speech -> barge-in) before the turn
            # arrived: merge with the still-pending entry instead of
            # overwriting it. The later-finishing transfer anchors the
            # hit/fallback settlement, the deadline follows the newest
            # speech estimate, and the accumulated blocks/span keep
            # cancel and the overlap split exact for both transfers.
            keep = transfer if transfer.done >= prior.transfer.done \
                else prior.transfer
            self.pending[sid] = PendingPreload(
                sid, keep, now + window,
                blocks=prior.blocks + transfer.blocks,
                span_s=prior.span_s + span)
        else:
            self.pending[sid] = PendingPreload(
                sid, transfer, now + window,
                blocks=transfer.blocks, span_s=span)
        return transfer

    def cancel(self, sid: str, now: float) -> None:
        """Burst pressure: engine cancels background preloads (§6)."""
        p = self.pending.pop(sid, None)
        if p is None:
            return
        if self.kv.async_transfers:
            # the chunked transfer engine can revert whatever has not
            # landed yet: queued chunks are dropped, their slots return
            # to the pool, and the accounting rolls back page-exact
            # (chunks that already drained stay resident — partial
            # cancellation, no un-moving of bytes)
            if self.kv.cancel_reload(sid, now) > 0:
                p.transfer.cancelled = True
                self.stats.cancelled += 1
            return
        if self.kv.physical_pages:
            # a synchronous physical plane reloads pages at admission
            # time — the bytes already moved, so there is nothing to
            # revert; dropping the pending entry forfeits the 'hit'
            return
        p.transfer.cancelled = True
        kv = self.kv.session(sid)
        kv.hbm_blocks = max(0, kv.hbm_blocks - p.blocks)
        self.kv.reloaded_blocks -= p.blocks
        self.stats.cancelled += 1

    # ------------------------------------------------------------ turn
    def on_turn_ready(self, sid: str, now: float) -> float:
        """Next-turn request reached the LLM stage. Returns the on-path
        reload stall in seconds (0.0 on a warm preload hit); the
        on/off-path split is banked for ``pop_split``."""
        if self.kv.async_transfers:
            return self._on_turn_ready_ledger(sid, now)
        p = self.pending.pop(sid, None)
        if p is not None and not p.transfer.cancelled:
            span = p.span_s
            if p.transfer.done <= now:
                self.stats.hits += 1
                self._last_class[sid] = "hit"
                self._bank_split(sid, 0.0, span)
                return 0.0
            # transfer still in flight: wait only the residual
            self.stats.sync_fallbacks += 1
            self._last_class[sid] = "fallback"
            stall = p.transfer.done - now
            self._bank_split(sid, stall, max(0.0, span - stall))
            return stall
        missing = self.kv.missing_blocks(sid)
        if missing <= 0 and self.kv.recompute_tokens(sid) == 0:
            return 0.0
        transfer = self.kv.reload(sid, now, background=False)
        if transfer is None:
            return 0.0                # 'none' policy: engine re-prefills
        self.stats.sync_fallbacks += 1
        self._last_class[sid] = "fallback"
        stall = transfer.done - now
        self._bank_split(sid, stall, 0.0)
        return stall

    def _on_turn_ready_ledger(self, sid: str, now: float) -> float:
        """Async data plane: the stall is what the *ledger* says is
        still in flight — chunks drained during earlier rounds (or
        whose modeled DMA finished inside the speech window) are off
        the critical path; only the remainder is charged."""
        p = self.pending.pop(sid, None)
        on_s, off_s = self.kv.finish_transfers(sid, now)
        fell_back = False
        if self.kv.missing_blocks(sid) > 0 \
                and self.kv.recompute_tokens(sid) == 0:
            # pages offloaded with no preload covering them (or evicted
            # after admission): the classic synchronous fallback, now a
            # queue-and-settle pair through the same chunked path
            transfer = self.kv.reload(sid, now, background=False)
            if transfer is not None:
                on2, off2 = self.kv.finish_transfers(sid, now)
                fell_back = on2 > 0.0
                on_s += on2
                off_s += off2
        # classify the turn exactly once: a warm hit XOR a fallback —
        # never both, never a double fallback count (a requeued
        # attempt's classification is undone by ``requeue_split``)
        if p is not None:
            if on_s <= 0.0:
                self.stats.hits += 1
                self._last_class[sid] = "hit"
            else:
                self.stats.sync_fallbacks += 1
                self._last_class[sid] = "fallback"
        elif fell_back:
            self.stats.sync_fallbacks += 1
            self._last_class[sid] = "fallback"
        self._bank_split(sid, on_s, off_s)
        return on_s

    def _bank_split(self, sid: str, on_s: float, off_s: float) -> None:
        """Record the turn's split, folding in any off-path credit a
        requeued earlier attempt carried over (``requeue_split``)."""
        carry = sum(self._last_split.pop(sid, (0.0, 0.0)))
        self._last_split[sid] = (on_s, off_s + carry)

    def requeue_split(self, sid: str) -> None:
        """The turn whose arrival settled this split was requeued
        (saturated pool) before the engine could read it: the settled
        seconds stalled nothing, so they carry forward as off-path
        credit for the attempt that eventually starts — without this,
        a requeue silently dropped already-done reload work from the
        overlap accounting. The attempt's hit/fallback count is undone
        too: the retry re-classifies the same logical turn."""
        on, off = self._last_split.pop(sid, (0.0, 0.0))
        if on + off > 0.0:
            self._last_split[sid] = (0.0, on + off)
        cls = self._last_class.pop(sid, None)
        if cls == "hit":
            self.stats.hits -= 1
        elif cls == "fallback":
            self.stats.sync_fallbacks -= 1

    def pop_split(self, sid: str):
        """(on_path_s, off_path_s) of the last on_turn_ready for the
        session; read-once (the engine stamps it onto the turn)."""
        return self._last_split.pop(sid, (0.0, 0.0))

    def forget_session(self, sid: str) -> None:
        """Session ended: drop any pending preload and unread split."""
        self.pending.pop(sid, None)
        self._last_split.pop(sid, None)
        self._last_class.pop(sid, None)


# Paper naming (§5.2): the speech-triggered preloader. When the KVManager
# carries the async transfer hooks (PagedRealtimeEngine), an admitted
# preload *queues* chunked page reloads that drain across decode rounds
# while the user speaks; ``on_turn_ready`` settles the remainder
# on-path and ``cancel`` rolls back page-exact whatever has not landed.
# A synchronous physical plane (async_transfers=False) still moves
# everything at trigger time, so its ``cancel`` only forfeits the hit.
SpeechPreloader = Preloader
