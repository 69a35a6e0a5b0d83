"""Asynchronous chunked host<->device KV transfer engine (DESIGN.md §10).

The LiveServe claim this makes real: *most KV reload work moves off the
next-turn critical path*. The blocking hooks the paged engine used to
run (`_reload_pages` / `_offload_pages`) moved every page synchronously,
so a speech-time preload only hid latency in the simulator's virtual
clock, never on real device state. This module turns both directions into
chunked, round-interleaved jobs:

- **Chunking.** A transfer is split into page-group chunks sized by the
  modeled PCIe channel: ``chunk_pages`` defaults to however many pages
  fit in ``target_chunk_s`` of channel time, so one chunk is roughly
  one decode round's worth of DMA (Metronome's bounded periodic-task
  framing: transfer work is scheduled against the token cadence, never
  as one blocking call).
- **Draining.** ``PagedRealtimeEngine.run_round`` (and both gateways'
  idle loops) call ``drain`` with a per-round chunk budget; each drained
  chunk physically moves its pages via the engine-registered io
  callbacks. A preload issued at ``user_speech_start`` therefore lands
  across the rounds where the user is still speaking.
- **Turn-start settlement.** ``finish_session`` completes whatever is
  still queued for a session when its next turn reaches the LLM stage.
  Chunks already drained cost the turn nothing — their full modeled
  cost was banked off-path at drain time (the bytes physically landed
  during a round, so the turn can never stall on them); chunks whose
  channel-modeled completion instant has passed are late-materialized
  for free (the modeled DMA finished during the speech window — only
  our host-side bookkeeping was lazy); the true remainder is charged
  on-path at its chunk-serial channel cost. That split is the on-path
  vs off-path reload accounting the shared metrics schema reports.
- **Copy-then-free offload.** An evicted page stays resident (usable,
  attendable) until its chunk is durably in the host store; only then
  is the physical slot freed. Allocation pressure *demands* completion
  (the engine drains offload chunks until the pool can satisfy it), and
  a reload arriving before the copy drains simply cancels it — the
  bytes never left HBM.
- **Ledger + cancellation.** Every in-flight page is tracked per
  session and cross-checked against the pool's ``loading``/
  ``offloading`` marks (``check``). Barge-in burst cancellation,
  hangup, and eviction-of-a-loading-session all cancel queued chunks
  without leaking pool slots or host-store entries (the conservation
  property in tests/test_transfer_engine.py).

This module is pure host-side bookkeeping: the physical page movement
lives in the io callbacks the engine registers (``set_io``), so the
ledger is reusable by any data plane that owns a page store.

Shared pages (DESIGN.md §13) never enter the ledger: a page another
live session is attached to must stay hot, so the engine's offload
picker skips refcount>1 pages and ``PagedPool.mark_offloading`` asserts
refcount==1 — by the time a chunk is enqueued here its pages are
provably private. Fleet migration deep-copies shared pages to host
stacks *before* building its MIGRATE chunks for the same reason.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

RELOAD = "reload"
OFFLOAD = "offload"

# chunk tag marking replica-to-replica migration legs (serving/fleet):
# the source's migrate-out offload and the destination's page-in both
# ride the normal RELOAD/OFFLOAD machinery, but tagged chunks are
# separately countable so migration traffic is observable (and its
# zero-copy cancellation provable) without a third transfer kind
MIGRATE = "migrate"

# default chunk sizing target: one chunk ~ one decode round of DMA
TARGET_CHUNK_S = 0.005


@dataclass
class TransferChunk:
    """One page-group of one direction for one session."""
    chunk_id: int
    session_id: str
    kind: str                        # RELOAD | OFFLOAD
    logical: List[int]               # logical page indices (pool order)
    modeled_done: float              # channel-modeled completion instant
    state: str = "queued"            # queued | done | cancelled
    tag: Optional[str] = None        # e.g. MIGRATE — observability only

    @property
    def pages(self) -> int:
        return len(self.logical)


@dataclass
class TransferStats:
    """Ledger telemetry; the bench's overlap fraction reads this."""
    reload_pages_off_path: int = 0   # drained during rounds / time-credit
    reload_pages_on_path: int = 0    # settled at turn start (stalled)
    reload_pages_cancelled: int = 0
    offload_pages_completed: int = 0
    offload_pages_cancelled: int = 0
    chunks_drained: int = 0
    demand_drains: int = 0           # offload chunks forced by allocation
    migration_pages_moved: int = 0   # MIGRATE-tagged pages that drained
    migration_pages_cancelled: int = 0   # MIGRATE-tagged zero-copy drops
    # wire-format telemetry (DESIGN.md §14): modeled bytes completed
    # chunks put on the channel, and the bytes the codec saved against
    # the logical (uncompressed) payload. Cancelled chunks count in
    # neither — their bytes never moved.
    wire_bytes_moved: float = 0.0
    wire_bytes_saved: float = 0.0
    reload_wire_bytes: float = 0.0   # RELOAD-only share of wire_bytes_moved

    def overlap_fraction(self) -> float:
        """Off-path share of reloaded pages; 0.0 when nothing reloaded
        (the page counters disambiguate, and it keeps JSON artifacts
        strict — no NaN)."""
        moved = self.reload_pages_off_path + self.reload_pages_on_path
        if moved == 0:
            return 0.0
        return self.reload_pages_off_path / moved


class TransferEngine:
    """Chunked async transfer ledger over one modeled PCIe channel."""

    def __init__(self, channel, *, chunk_pages: Optional[int] = None,
                 target_chunk_s: float = TARGET_CHUNK_S):
        self.channel = channel
        if chunk_pages is None:
            per_page = max(1e-12, channel.transfer_time(1))
            chunk_pages = max(1, int(target_chunk_s / per_page))
        assert chunk_pages >= 1
        self.chunk_pages = chunk_pages
        self._queue: List[TransferChunk] = []     # FIFO across sessions
        self._ids = itertools.count()
        self._io_reload: Optional[Callable] = None
        self._io_offload: Optional[Callable] = None
        # per-session (on_s, off_s) accumulated by finish_session, read
        # once by the preloader via pop_split
        self._split_acc: Dict[str, List[float]] = {}
        self._off_s_acc: Dict[str, float] = {}    # off-path modeled s
        # on-path page count of the most recent settlement, kept until
        # the turn either commits or is requeued: a requeued turn's
        # settlement stalled nothing, so its pages reclassify (the
        # seconds side is carried by the preloader's requeue_split)
        self._finish_on: Dict[str, int] = {}
        self.stats = TransferStats()

    # ------------------------------------------------------------ wiring
    def set_io(self, *, reload_chunk: Callable[[str, List[int]], None],
               offload_chunk: Callable[[str, List[int]], None]) -> None:
        """Register the physical movers. ``reload_chunk(sid, logical)``
        scatters the chunk's host copies into reserved device pages;
        ``offload_chunk(sid, logical)`` copies device pages to the host
        store and frees the slots. Both run synchronously when called —
        *when* they are called is this ledger's whole job."""
        self._io_reload = reload_chunk
        self._io_offload = offload_chunk

    # ------------------------------------------------------------ submit
    def _chunks_of(self, logical: List[int]) -> List[List[int]]:
        return [logical[i:i + self.chunk_pages]
                for i in range(0, len(logical), self.chunk_pages)]

    def submit_reload(self, sid: str, logical: List[int],
                      transfer=None, *,
                      tag: Optional[str] = None) -> List[TransferChunk]:
        """Queue a host->device job. ``transfer`` is the KVManager's
        aggregate modeled Transfer; per-chunk modeled completion times
        interpolate its [start, done] span (the serialized channel
        finishes chunk i before chunk i+1)."""
        if not logical:
            return []
        groups = self._chunks_of(logical)
        out = []
        done_pages = 0
        total = len(logical)
        for g in groups:
            done_pages += len(g)
            if transfer is not None:
                md = transfer.start + (transfer.done - transfer.start) \
                    * (done_pages / total)
            else:
                md = float("inf")
            c = TransferChunk(next(self._ids), sid, RELOAD, list(g), md,
                              tag=tag)
            self._queue.append(c)
            out.append(c)
        return out

    def submit_offload(self, sid: str, logical: List[int], *,
                       tag: Optional[str] = None) -> List[TransferChunk]:
        """Queue a device->host job (copy-then-free: the caller keeps
        the pages usable until each chunk drains). Offloads are not
        stall-modeled — they never sit on a turn's critical path; the
        demand path (`drain_offloads_until`) completes them when
        allocation needs the slots."""
        if not logical:
            return []
        out = []
        for g in self._chunks_of(logical):
            c = TransferChunk(next(self._ids), sid, OFFLOAD, list(g),
                              float("-inf"), tag=tag)
            self._queue.append(c)
            out.append(c)
        return out

    # ------------------------------------------------------------ drain
    def _complete(self, chunk: TransferChunk) -> None:
        assert chunk.state == "queued", chunk
        if chunk.kind == RELOAD:
            self._io_reload(chunk.session_id, chunk.logical)
        else:
            self._io_offload(chunk.session_id, chunk.logical)
            self.stats.offload_pages_completed += chunk.pages
        if chunk.tag == MIGRATE:
            self.stats.migration_pages_moved += chunk.pages
        ch = self.channel
        wire = ch.wire_bytes(chunk.pages)
        self.stats.wire_bytes_moved += wire
        self.stats.wire_bytes_saved += \
            chunk.pages * ch.block_bytes - wire
        if chunk.kind == RELOAD:
            self.stats.reload_wire_bytes += wire
        chunk.state = "done"

    def drain(self, now: float, max_chunks: Optional[int] = None, *,
              kinds: Tuple[str, ...] = (RELOAD, OFFLOAD)) -> int:
        """Physically complete up to ``max_chunks`` queued chunks (FIFO).
        Returns chunks drained; 0 therefore means the queue holds no
        chunk of ``kinds`` — callers (``drain_offloads_until``'s break,
        the engines' round budgets) rely on that reading, so a zero
        ``max_chunks`` or empty ``kinds`` (which would return 0 with
        the queue full) is rejected as a usage error instead of
        masquerading as "queue dry". Pass ``max_chunks=None`` for
        unbounded; callers with a possibly-zero budget guard the call
        (``if budget > 0``).

        Banking contract (pinned by tests/test_transfer_engine.py): a
        reload chunk drained here banks its FULL modeled channel cost
        as off-path seconds, regardless of ``now`` vs the chunk's
        ``modeled_done``. Draining means the bytes physically landed
        during a round — the next turn can never stall on them — so
        the whole modeled cost was hidden in the speech window; the
        ``modeled_done`` instant only matters for chunks still queued
        at turn-start settlement (``finish_session``), which never
        re-charges a drained chunk."""
        if max_chunks is not None and max_chunks <= 0:
            raise ValueError(
                f"drain(max_chunks={max_chunks}): a non-positive chunk "
                "budget would return 0 with work still queued — callers "
                "treat 0 as 'queue dry'; guard the call instead")
        if not kinds:
            raise ValueError(
                "drain(kinds=()): empty kinds matches nothing and would "
                "return 0 with work still queued")
        drained = 0
        i = 0
        while i < len(self._queue):
            if max_chunks is not None and drained >= max_chunks:
                break
            c = self._queue[i]
            if c.kind not in kinds:
                i += 1
                continue
            self._queue.pop(i)
            self._complete(c)
            drained += 1
            self.stats.chunks_drained += 1
            if c.kind == RELOAD:
                self.stats.reload_pages_off_path += c.pages
                self._off_s_acc[c.session_id] = \
                    self._off_s_acc.get(c.session_id, 0.0) \
                    + self.channel.transfer_time(c.pages)
        return drained

    def drain_offloads_until(self, now: float,
                             predicate: Callable[[], bool]) -> int:
        """Demand path: complete offload chunks until ``predicate()``
        (e.g. 'pool has enough free slots') or the queue runs dry."""
        n = 0
        while not predicate():
            if not self.drain(now, 1, kinds=(OFFLOAD,)):
                break
            n += 1
            self.stats.demand_drains += 1
        return n

    # ------------------------------------------------------------ settle
    def finish_session(self, sid: str, now: float) -> Tuple[float, float]:
        """Turn-start settlement: complete every reload chunk of
        ``sid`` *still queued* at ``now``. Queued chunks whose modeled
        DMA finished by ``now`` settle off-path (the modeled channel
        completed them during the speech window — only our host-side
        bookkeeping was lazy); the rest are charged on-path at
        chunk-serial channel cost. Chunks already drained by earlier
        rounds are not re-charged: their full modeled cost was banked
        off-path at drain time (see ``drain``'s banking contract) and
        rides along in the returned split. Accumulates and returns
        (on_path_s, off_path_s)."""
        on_s = 0.0
        off_s = self._off_s_acc.pop(sid, 0.0)
        for c in [c for c in self._queue
                  if c.session_id == sid and c.kind == RELOAD]:
            self._queue.remove(c)
            self._complete(c)
            self.stats.chunks_drained += 1
            cost = self.channel.transfer_time(c.pages)
            if c.modeled_done <= now:
                off_s += cost
                self.stats.reload_pages_off_path += c.pages
            else:
                on_s += cost
                self.stats.reload_pages_on_path += c.pages
                self._finish_on[sid] = \
                    self._finish_on.get(sid, 0) + c.pages
        acc = self._split_acc.setdefault(sid, [0.0, 0.0])
        acc[0] += on_s
        acc[1] += off_s
        return on_s, off_s

    def pop_split(self, sid: str) -> Tuple[float, float]:
        on, off = self._split_acc.pop(sid, (0.0, 0.0))
        return on, off

    def requeue_settlement(self, sid: str) -> None:
        """The turn whose start settled these chunks was requeued
        (saturated pool): the settlement stalled nothing, so its
        on-path pages reclassify as off-path — by the time the turn
        eventually runs, those bytes were long resident. Keeps the
        ledger's overlap stats agreeing with the per-turn metrics,
        which carry the same seconds forward as off-path credit."""
        pages = self._finish_on.pop(sid, 0)
        self.stats.reload_pages_on_path -= pages
        self.stats.reload_pages_off_path += pages

    def settlement_committed(self, sid: str) -> None:
        """The settled turn really started: the on-path classification
        stands; drop the reclassification record."""
        self._finish_on.pop(sid, None)

    # ------------------------------------------------------------ cancel
    def _cancel_pages(self, sid: str, kind: str,
                      logical: Optional[List[int]]) -> int:
        """Drop pages of one direction from the session's queued chunks
        (``logical=None`` drops them all); emptied chunks leave the
        queue. Returns pages dropped — the caller reverts the pool
        marks and any accounting."""
        want = None if logical is None else set(logical)
        dropped = 0
        for c in list(self._queue):
            if c.session_id != sid or c.kind != kind:
                continue
            if want is None:
                keep = []
            else:
                keep = [li for li in c.logical if li not in want]
            hit = c.pages - len(keep)
            dropped += hit
            if c.tag == MIGRATE:
                self.stats.migration_pages_cancelled += hit
            c.logical = keep
            if not keep:
                c.state = "cancelled"
                self._queue.remove(c)
        return dropped

    def cancel_reload_pages(self, sid: str,
                            logical: Optional[List[int]] = None) -> int:
        """Drop pages from queued reload chunks (eviction of a loading
        session, burst cancel)."""
        dropped = self._cancel_pages(sid, RELOAD, logical)
        self.stats.reload_pages_cancelled += dropped
        return dropped

    def cancel_offload_pages(self, sid: str,
                             logical: Optional[List[int]] = None) -> int:
        """Drop pages from queued offload chunks — the copy-then-free
        win: a reload (or turn) arriving before the copy drained keeps
        the pages resident at zero transfer cost."""
        dropped = self._cancel_pages(sid, OFFLOAD, logical)
        self.stats.offload_pages_cancelled += dropped
        return dropped

    def cancel_session(self, sid: str) -> Dict[str, int]:
        """Hangup: drop every queued chunk of the session. The caller
        releases the pool entry (which frees reserved slots and host
        copies), so nothing leaks mid-transfer."""
        out = {RELOAD: self.cancel_reload_pages(sid),
               OFFLOAD: self.cancel_offload_pages(sid)}
        self._split_acc.pop(sid, None)
        self._off_s_acc.pop(sid, None)
        self._finish_on.pop(sid, None)
        return out

    # ------------------------------------------------------------ ledger
    def pending_offload_pages(self, sid: Optional[str] = None) -> int:
        return sum(c.pages for c in self._queue if c.kind == OFFLOAD
                   and (sid is None or c.session_id == sid))

    def pending_reload_pages(self, sid: Optional[str] = None) -> int:
        return sum(c.pages for c in self._queue if c.kind == RELOAD
                   and (sid is None or c.session_id == sid))

    def idle(self) -> bool:
        return not self._queue

    # ------------------------------------------------------------ checks
    def check(self, pool) -> None:
        """Ledger <-> pool bijection: every queued reload page is marked
        ``loading`` (and vice versa); every queued offload page is
        marked ``offloading`` (and vice versa); no page appears in two
        queued chunks."""
        by = {}
        for c in self._queue:
            for li in c.logical:
                key = (c.session_id, c.kind, li)
                assert key not in by, f"page queued twice: {key}"
                by[key] = c
        for sid, s in pool.seqs.items():
            qr = {li for (s2, k, li) in by if s2 == sid and k == RELOAD}
            qo = {li for (s2, k, li) in by if s2 == sid and k == OFFLOAD}
            assert qr == set(s.loading), \
                f"{sid}: queued reloads {qr} != pool loading {s.loading}"
            assert qo == set(s.offloading), \
                f"{sid}: queued offloads {qo} != pool offloading " \
                f"{s.offloading}"
        for (sid, _, _li) in by:
            assert sid in pool.seqs, f"chunk for released session {sid}"
