"""Interaction-aware hierarchical KV cache management (paper §5).

Host-side block accounting over an HBM tier and a DRAM tier:

- Blocks of a session are ordered; HBM always holds a *prefix* range
  [0, hbm_blocks) and DRAM the suffix — because eviction takes suffix
  blocks first (§5.1: prefix blocks are shared by future turns and more
  expensive to reconstruct).
- Eviction candidates are idle multi-turn sessions ranked by predicted
  next use  T_next = now + T_play + T_reply  (Eq. 4), farthest first.
  Sessions with speech-start/barge-in are immediate-reuse and protected.
- A lazy-deletion heap keeps candidate selection O(log n) (the paper's
  eviction index, Table 1); ``index_mode='scan'`` reproduces the tail-scan
  baseline for the microbenchmark.
- ``policy='lru'`` reproduces the substrate baseline; ``policy='none'``
  models vLLM-Omni-wo (no offload: eviction discards KV, next turn must
  re-prefill). Missing monitor telemetry falls back to LRU order
  (fail-closed, §6).
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class SessionKV:
    session_id: str
    total_blocks: int = 0        # context blocks cached for the session
    hbm_blocks: int = 0          # resident prefix range [0, hbm_blocks)
    pinned: bool = False         # a live request is using this KV
    protected_until: float = -1.0  # preload protection TTL
    # tool-pause protection (distinct state, distinct TTL): the session
    # idles mid-turn while an external tool runs; its next use is the
    # tool's expected return, not the reply-gap EMA, and its hot KV must
    # not be evicted out from under the resume
    tool_protected_until: float = -1.0
    last_access: float = 0.0
    discarded: bool = False      # 'none' policy: KV dropped, must re-prefill
    # Shared-prefix accounting (DESIGN.md §13): `shared_blocks` are
    # attached prefix blocks charged to another accountant (the owner
    # session or the prefix cache); `shared_pinned_blocks` are OWN
    # resident blocks some other session shares — a page a sharer still
    # needs hot never offloads, so they leave the evictable budget.
    shared_blocks: int = 0
    shared_pinned_blocks: int = 0

    @property
    def dram_blocks(self) -> int:
        return max(0, self.total_blocks - self.shared_blocks
                   - self.hbm_blocks)

    def evictable(self, now: float) -> int:
        if self.pinned or now < self.protected_until \
                or now < self.tool_protected_until:
            return 0
        return max(0, self.hbm_blocks - self.shared_pinned_blocks)


@dataclass
class Transfer:
    session_id: str
    blocks: int
    start: float
    done: float
    background: bool
    cancelled: bool = False


class TransferChannel:
    """Serialized DRAM<->HBM path (PCIe-style shared bandwidth).

    ``wire_scale`` is the wire-format compression factor (DESIGN.md
    §14): wire bytes per logical block byte, 1.0 for the fp32 control
    and ~0.25 for int8 KV pages. It multiplies into ``transfer_time``
    here — the single point every modeled cost flows through — so
    chunk sizing, preload admission, turn-start stall settlement, and
    fleet migration all price the compressed payload without knowing
    the codec exists. ``block_bytes`` stays the *logical* size (pool
    capacity math never compresses)."""

    def __init__(self, gb_per_s: float, block_bytes: float,
                 wire_scale: float = 1.0):
        self.gb_per_s = gb_per_s
        self.block_bytes = block_bytes
        self.wire_scale = wire_scale
        self.busy_until = 0.0
        self.log: List[Transfer] = []

    def wire_bytes(self, blocks: int) -> float:
        """Bytes a transfer of ``blocks`` actually puts on the wire."""
        return blocks * self.block_bytes * self.wire_scale

    def transfer_time(self, blocks: int) -> float:
        return self.wire_bytes(blocks) / (self.gb_per_s * 1e9)

    def submit(self, session_id: str, blocks: int, now: float,
               background: bool) -> Transfer:
        start = max(now, self.busy_until)
        done = start + self.transfer_time(blocks)
        self.busy_until = done
        t = Transfer(session_id, blocks, start, done, background)
        self.log.append(t)
        return t

    def queue_delay(self, now: float) -> float:
        return max(0.0, self.busy_until - now)


class KVManager:
    def __init__(self, *, capacity_blocks: int, block_size: int,
                 bytes_per_token: float, monitor=None,
                 policy: str = "next_use", index_mode: str = "heap",
                 pcie_gb_s: float = 25.0,
                 protect_ttl_s: float = 10.0,
                 tool_protect_ttl_s: float = 30.0,
                 protected_cap_blocks: Optional[int] = None,
                 clock=None):
        assert policy in ("next_use", "lru", "none")
        assert index_mode in ("heap", "scan")
        self.capacity = capacity_blocks
        self.block_size = block_size
        self.bytes_per_token = bytes_per_token
        self.monitor = monitor
        self.policy = policy
        self.index_mode = index_mode
        self.clock = clock
        self.protect_ttl_s = protect_ttl_s
        self.tool_protect_ttl_s = tool_protect_ttl_s
        self.protected_cap = protected_cap_blocks or max(
            1, capacity_blocks // 4)
        self.sessions: Dict[str, SessionKV] = {}
        self.channel = TransferChannel(pcie_gb_s,
                                       block_size * bytes_per_token)
        # lazy-deletion heap of (-t_next, tiebreak, session_id, version)
        self._heap: List[Tuple[float, int, str, int]] = []
        self._version: Dict[str, int] = {}
        # whether a session's *current* version is live in the heap —
        # a session that becomes evictable again with no interaction
        # event (e.g. its preload-protection TTL lapses) must be
        # re-seeded by the next eviction pass, or heap mode silently
        # never finds it again
        self._in_heap: Dict[str, bool] = {}
        self._tiebreak = itertools.count()
        # working blocks owned by live requests (decode growth etc.)
        self.working_blocks = 0
        # data-plane hooks: a physical engine (PagedRealtimeEngine)
        # registers these so accounting decisions move real pages
        self._on_evict_pages = None
        self._on_reload_pages = None
        self._on_cancel_reload = None
        self._on_finish_transfers = None
        self._pending_offload = None
        # prefix-cache hooks (DESIGN.md §13): blocks kept alive purely
        # by the radix index (refcount 0, owner None) are charged here
        self._cache_reclaim = None
        self._cache_reclaimable = None
        self.cached_blocks = 0
        # telemetry
        self.evicted_blocks = 0
        self.reloaded_blocks = 0
        self.eviction_overhead_s: List[float] = []
        self.residency_log: List[Tuple[float, int]] = []

    # ------------------------------------------------------------- hooks
    def set_page_hooks(self, *, on_evict=None, on_reload=None,
                       on_cancel_reload=None, on_finish_transfers=None,
                       pending_offload=None) -> None:
        """Register the narrow data-plane hooks (DESIGN.md §3, §10):
        this manager stays pure accounting, but a paged engine can make
        every eviction/reload decision move physical pages.

        on_evict(sid, blocks): called after a session's HBM range shrank
        by `blocks` — the engine offloads that many suffix pages to its
        DRAM tier (chunked copy-then-free under the async transfer
        engine). on_reload(sid, blocks, background=..., transfer=...):
        called after a reload was admitted — the engine queues (or, on
        the synchronous path, immediately moves) the offloaded pages
        back; `transfer` carries the channel-modeled [start, done] span
        the chunks interpolate. The async hooks:

        on_cancel_reload(sid) -> pages: drop queued reload chunks (burst
        cancel); the manager reverts its accounting by the returned page
        count. on_finish_transfers(sid, now) -> (on_s, off_s): settle a
        session's queued chunks at turn start, returning the on-path
        stall and the off-path seconds already hidden. pending_offload
        (sid) -> pages: copy-then-free offloads still in flight — a
        reload cancels those for free, so the modeled transfer shrinks
        by that many blocks.
        """
        self._on_evict_pages = on_evict
        self._on_reload_pages = on_reload
        self._on_cancel_reload = on_cancel_reload
        self._on_finish_transfers = on_finish_transfers
        self._pending_offload = pending_offload

    def set_cache_hooks(self, *, reclaim=None, reclaimable=None) -> None:
        """Prefix-cache hooks: reclaim(n, now) -> blocks frees up to n
        orphaned cache-held pages (cheapest victims: no live owner, no
        host copy to write, only a future prefix miss); reclaimable(now)
        -> blocks reports how many it *could* free, counted by
        admission control next to session-evictable blocks."""
        self._cache_reclaim = reclaim
        self._cache_reclaimable = reclaimable

    @property
    def physical_pages(self) -> bool:
        """True when a data plane moves real pages on our decisions."""
        return (self._on_evict_pages is not None
                or self._on_reload_pages is not None)

    @property
    def async_transfers(self) -> bool:
        """True when the data plane settles transfers chunk-by-chunk
        (the preloader then charges stalls from the physical ledger,
        not from the modeled Transfer alone)."""
        return self._on_finish_transfers is not None

    # ------------------------------------------------------------- state
    def session(self, sid: str) -> SessionKV:
        kv = self.sessions.get(sid)
        if kv is None:
            kv = SessionKV(session_id=sid)
            self.sessions[sid] = kv
        return kv

    @property
    def used_blocks(self) -> int:
        return sum(s.hbm_blocks for s in self.sessions.values()) \
            + self.working_blocks + self.cached_blocks

    @property
    def free_blocks(self) -> int:
        return self.capacity - self.used_blocks

    def occupancy(self) -> float:
        """R_{s,occ} of Eq. 3."""
        return min(1.0, self.used_blocks / max(1, self.capacity))

    def reclaimable_blocks(self, now: float) -> int:
        """Idle HBM blocks the eviction policy could free right now.
        Admission control counts these as available — allocation evicts
        on demand (§5.1), so a full pool with idle sessions must not
        starve live decode."""
        total = 0
        for sid, kv in self.sessions.items():
            if self.monitor is not None and self.monitor.immediate_reuse(sid):
                continue
            total += kv.evictable(now)
        if self._cache_reclaimable is not None:
            total += self._cache_reclaimable(now)
        return total

    def blocks_of(self, tokens: int) -> int:
        return -(-tokens // self.block_size)

    def log_residency(self, now: float) -> None:
        self.residency_log.append((now, self.used_blocks))

    # ------------------------------------------------------------- Eq. 4
    def next_use_estimate(self, sid: str, now: float) -> float:
        if self.monitor is None:
            return now                      # fail-closed: behaves like LRU
        if self.monitor.immediate_reuse(sid):
            return now                      # immediate reuse: protect
        view = self.monitor.view(sid)
        tool_until = getattr(view, "tool_call_until", None) \
            if view is not None else None
        if tool_until is not None and tool_until > now:
            # mid-turn tool pause: next use is the tool's expected
            # return, not the playback + reply-gap estimate
            return tool_until
        t_play = self.monitor.remaining_playback_s(sid)
        t_reply = self.monitor.reply_gap_s(sid)
        return now + t_play + t_reply

    def _push_index(self, sid: str, now: float) -> None:
        t_next = self.next_use_estimate(sid, now)
        v = self._version.get(sid, 0) + 1
        self._version[sid] = v
        self._in_heap[sid] = True
        heapq.heappush(self._heap, (-t_next, next(self._tiebreak), sid, v))

    def refresh_session(self, sid: str, now: float) -> None:
        """Re-rank a session after an interaction event."""
        if self.policy == "next_use" and self.index_mode == "heap":
            if self.session(sid).evictable(now) > 0:
                self._push_index(sid, now)

    # ------------------------------------------------------------- order
    def _candidates_scan(self, now: float) -> List[str]:
        """Tail-scan baseline: full linear pass, sorted farthest-first."""
        items = []
        for sid, kv in self.sessions.items():
            if kv.evictable(now) <= 0:
                continue
            if self.monitor is not None and self.monitor.immediate_reuse(sid):
                continue          # speaking/barge-in sessions are protected
            if self.policy == "next_use":
                key = self.next_use_estimate(sid, now)
            else:                            # lru: oldest access first
                key = -kv.last_access
            items.append((key, sid))
        items.sort(reverse=True)
        return [sid for _, sid in items]

    def _pop_heap_candidate(self, now: float) -> Optional[str]:
        while self._heap:
            neg_t, _, sid, v = heapq.heappop(self._heap)
            if self._version.get(sid) != v:
                continue                     # stale entry (lazy deletion)
            self._in_heap[sid] = False       # current entry leaves heap
            kv = self.sessions.get(sid)
            if kv is None or kv.evictable(now) <= 0:
                continue
            # protect sessions whose estimate moved to immediate reuse
            if self.monitor is not None and self.monitor.immediate_reuse(sid):
                continue
            return sid
        return None

    # ------------------------------------------------------------- evict
    def evict(self, need_blocks: int, now: float) -> int:
        """Free >= need_blocks from idle resident KV. Returns blocks freed.

        Suffix blocks of the selected session go first; the session's HBM
        range shrinks from the tail (prefix continuity preserved).
        """
        import time as _time
        t0 = _time.perf_counter()
        freed = 0
        if self.policy == "next_use" and self.index_mode == "heap":
            # seed the heap lazily: unseen evictable sessions, plus
            # sessions evictable again without an interaction event
            # (protection TTL lapsed, a candidate pop rejected them
            # earlier) whose current version is no longer live in it
            for sid, kv in self.sessions.items():
                if kv.evictable(now) > 0 \
                        and not self._in_heap.get(sid, False):
                    self._push_index(sid, now)
            while freed < need_blocks:
                sid = self._pop_heap_candidate(now)
                if sid is None:
                    break
                freed += self._evict_session(sid, need_blocks - freed, now)
        else:
            for sid in self._candidates_scan(now):
                if freed >= need_blocks:
                    break
                freed += self._evict_session(sid, need_blocks - freed, now)
        self.eviction_overhead_s.append(_time.perf_counter() - t0)
        return freed

    def _evict_session(self, sid: str, want: int, now: float) -> int:
        kv = self.sessions[sid]
        take = min(kv.evictable(now), want)
        if take <= 0:
            return 0
        kv.hbm_blocks -= take
        self.evicted_blocks += take
        if self.policy == "none":
            # no offload tier: KV is discarded, next turn re-prefens
            kv.total_blocks -= take
            kv.discarded = True
        if kv.evictable(now) > 0 and self.policy == "next_use" \
                and self.index_mode == "heap":
            self._push_index(sid, now)      # partial eviction: re-rank rest
        if self._on_evict_pages is not None and self.policy != "none":
            self._on_evict_pages(sid, take)
        return take

    # ------------------------------------------------------------- alloc
    def _make_room(self, blocks: int, now: float) -> bool:
        """Free capacity for `blocks`: reclaim orphaned prefix-cache
        pages first (zero transfer cost, only a future prefix miss —
        strictly cheaper than evicting a session that must reload),
        then run the Eq.4 eviction pass. Session-victim *order* is
        unchanged by the cache tier."""
        if self.free_blocks < blocks and self._cache_reclaim is not None:
            self.cached_blocks -= self._cache_reclaim(
                blocks - self.free_blocks, now)
        if self.free_blocks < blocks:
            self.evict(blocks - self.free_blocks, now)
        return self.free_blocks >= blocks

    def try_allocate_working(self, blocks: int, now: float) -> bool:
        """Blocks for live request growth (pinned until released)."""
        if not self._make_room(blocks, now):
            return False
        self.working_blocks += blocks
        return True

    def release_working(self, blocks: int) -> None:
        self.working_blocks = max(0, self.working_blocks - blocks)

    def release_session(self, sid: str) -> None:
        """Session ended (user hung up): drop its KV accounting — the
        data plane frees the physical pages."""
        self.sessions.pop(sid, None)
        self._version.pop(sid, None)
        self._in_heap.pop(sid, None)

    def pin(self, sid: str) -> None:
        self.session(sid).pinned = True

    def unpin(self, sid: str, now: float) -> None:
        kv = self.session(sid)
        kv.pinned = False
        kv.last_access = now
        self.refresh_session(sid, now)

    def commit_turn(self, sid: str, context_tokens: int, now: float) -> None:
        """After a turn finishes: working KV becomes idle session KV."""
        kv = self.session(sid)
        blocks = self.blocks_of(context_tokens)
        grow = blocks - kv.total_blocks
        kv.total_blocks = blocks
        # own resident blocks can never exceed what isn't an attached
        # shared prefix (those stay charged to their owner / the cache)
        kv.hbm_blocks = min(kv.hbm_blocks + max(0, grow),
                            blocks - kv.shared_blocks)
        kv.pinned = False
        kv.discarded = False
        kv.last_access = now
        self.refresh_session(sid, now)

    # ------------------------------------------------------------- reload
    def missing_blocks(self, sid: str) -> int:
        kv = self.session(sid)
        return kv.dram_blocks

    def recompute_tokens(self, sid: str) -> int:
        """'none' policy: tokens whose KV was discarded (re-prefill cost)."""
        kv = self.session(sid)
        return kv.dram_blocks * self.block_size if kv.discarded else 0

    def transfer_blocks(self, sid: str) -> int:
        """Blocks a reload would actually move over the channel: the
        offloaded suffix minus copy-then-free offloads still in flight
        (cancelling those restores the pages without a transfer)."""
        n = self.session(sid).dram_blocks
        if n > 0 and self._pending_offload is not None:
            n -= min(n, self._pending_offload(sid))
        return max(0, n)

    def reload(self, sid: str, now: float, *, background: bool):
        """Bring the offloaded suffix back. Returns Transfer or None."""
        kv = self.session(sid)
        n = kv.dram_blocks
        if n <= 0 or self.policy == "none":
            return None
        if self.free_blocks < n:
            # pin across the eviction pass: the session being brought
            # back must never be selected as its own victim
            was_pinned = kv.pinned
            kv.pinned = True
            self._make_room(n, now)
            kv.pinned = was_pinned
        if self.free_blocks < n:
            return None
        # only blocks whose bytes are truly on the host cross the
        # channel; cancellable in-flight offloads come back for free
        t = self.channel.submit(sid, self.transfer_blocks(sid), now,
                                background)
        # blocks become resident on completion; account them now so
        # concurrent admissions see the pressure
        kv.hbm_blocks += n
        self.reloaded_blocks += n
        if self._on_reload_pages is not None:
            self._on_reload_pages(sid, n, background=background,
                                  transfer=t)
        return t

    def cancel_reload(self, sid: str, now: float) -> int:
        """Burst cancel: drop the session's queued reload chunks and
        revert the admission-time accounting for exactly the pages that
        had not yet landed. Returns blocks cancelled (0 without an
        async data plane — bytes already moved)."""
        if self._on_cancel_reload is None:
            return 0
        n = self._on_cancel_reload(sid)
        if n > 0:
            kv = self.session(sid)
            kv.hbm_blocks = max(0, kv.hbm_blocks - n)
            self.reloaded_blocks -= n
            self.refresh_session(sid, now)
        return n

    def finish_transfers(self, sid: str, now: float):
        """Turn-start settlement (async data plane): physically complete
        the session's queued reload chunks; returns (on_path_s,
        off_path_s). (0.0, 0.0) without an async plane."""
        if self._on_finish_transfers is None:
            return 0.0, 0.0
        return self._on_finish_transfers(sid, now)

    def protect(self, sid: str, now: float) -> None:
        """Preload-protection TTL (§5.3). Shared-prefix rule (DESIGN.md
        §13): a shared page is protected as long as ANY sharer needs it
        — while sharers live that is structural (`shared_pinned_blocks`
        keeps the page out of every evictable budget, regardless of
        TTLs), and when the last sharer detaches the radix index banks
        ``max`` over the sharers' `protected_until` values, so the
        orphaned page honors the longest outstanding TTL before
        `reclaim` may free it."""
        kv = self.session(sid)
        protected = sum(1 for s in self.sessions.values()
                        if s.protected_until > now)
        if protected * self.block_size < self.protected_cap:
            kv.protected_until = now + self.protect_ttl_s

    def protect_tool(self, sid: str, now: float,
                     expected_latency_s: float) -> None:
        """Tool-pause protection: hold the session's KV resident until
        the tool's expected return (capped by its own TTL so a tool that
        never comes back cannot squat on the pool). Distinct from the
        preload TTL — the two states expire independently and either one
        alone keeps the blocks unevictable."""
        kv = self.session(sid)
        kv.tool_protected_until = now + min(max(0.0, expected_latency_s),
                                            self.tool_protect_ttl_s)

    def clear_tool_protection(self, sid: str, now: float) -> None:
        """The tool returned (or the session resumed): lift the hold and
        re-rank the session under its refreshed next-use estimate."""
        kv = self.session(sid)
        kv.tool_protected_until = -1.0
        self.refresh_session(sid, now)
