"""Paged multi-turn realtime engine — the LiveServe data plane on a
paged PyTorch KV store, with attention through the hand-written
paged-attention kernels (the port of the JAX package's
``serving/paged_engine.py``).

- KV lives in a ``PagedPool``-managed page store ([L, P+1, page, Hkv, hd]
  per K and V; physical page P is a scratch page for padded batch rows).
  Each round scatters its tokens' K/V into the pages in place and
  attends through per-round block tables.
- Sessions are **multi-turn**: committed pages stay owned by the session
  across turns. ``KVManager`` eviction decisions physically offload
  suffix pages to host copies (bit-exact round-trip), and the
  ``SpeechPreloader`` reloads them during user speech so the next turn
  resumes with warm KV and zero re-prefill tokens.
- The control plane decides; the engine executes. ``step()`` lets the
  engine's own ``UrgencyScheduler`` pick the round (scripted demos);
  ``submit_turn``/``run_round`` take a gateway's decision. Scheduling
  moves *when* tokens appear, never *which*.

The host logic is the reference's, line for line; only what touches the
device is rewritten. The reference's functional ``.at[].set`` updates
become in-place ``index_put_``/``index_copy_`` writes on the one page
store. Padding rows and padding token slots all write to the scratch
page, where duplicate targets are harmless because no live row ever
reads it. PyTorch runs eagerly, so the reference's jit cache has no
counterpart; ``_q_bucket`` stays because it bounds the step shapes.

Turn 0 on the per-token plane (``fused_step=False``) is the
reference's dense graft: one B=1 ring-cache ``prefill`` through the
``flash_prefill`` kernel, copied into the session's pages.

Out of this slice (each raises ``NotImplementedError`` naming its
ROADMAP item): ``mesh``, ``prefix_cache``, ``spec_decode``,
``kv_quant="int8"`` and the cross-replica migration methods.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.kv_manager import KVManager
from repro_torch.core.monitor import RuntimeMonitor
from repro_torch.core.preload import SpeechPreloader
from repro_torch.core.scheduler import SchedulerConfig, UrgencyScheduler
from repro_torch.core.session import Phase, Request, RequestState
from repro_torch.core.transfer_engine import TransferEngine
from repro_torch.device import resolve_device
from repro_torch.kernels import ref
from repro_torch.kernels.paged_attention import paged_attention, \
    paged_prefill_attention
from repro_torch.kvcache.paged import OutOfPages, PagedPool
from repro_torch.kvcache.quant import KVWireCodec
from repro_torch.models import layers as L
from repro_torch.models.model import _embed, _logits, _mlp_block, \
    init_cache, layer_params, prefill
from repro_torch.serving.block_tables import BatchTables, \
    FusedBatchTables, LayerStackedPages, assemble, assemble_fused
from repro_torch.serving.engine import RoundLimitExceeded, _StepClock, \
    schedule_round


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue 1 item {item})")


# ======================================================================
# data plane
# ======================================================================
def paged_decode_step(cfg, params, tokens, positions, k_pages, v_pages,
                      block_tables, seq_lens, write_page, write_slot,
                      *, plain: bool = False):
    """One token per batch row through the paged KV store.

    tokens/positions [B] int; write_page/write_slot [B] int64;
    k_pages/v_pages [L, P+1, page, Hkv, hd], written in place;
    block_tables [B, pps] i32; seq_lens [B] i32 (post-write lengths).
    Returns logits [B, V] f32.

    ``plain`` (tests and the chip check only) attends through the
    kernel's plain version on any device, to hold the kernel's step
    against it; it is never a fallback.
    """
    attend = ref.paged_attention_ref if plain else paged_attention
    x = _embed(cfg, params, tokens[:, None])
    pos = positions[:, None]                            # [B, 1]
    for i, lp in enumerate(layer_params(params)):
        h = L.rms_norm(x, lp["ln1"], cfg.rms_eps)
        q, k, v = L.attn_project_qkv(lp["attn"], cfg, h, pos)
        kc, vc = k_pages[i], v_pages[i]
        kc[write_page, write_slot] = k[:, 0]
        vc[write_page, write_slot] = v[:, 0]
        a = attend(q[:, 0].contiguous(), kc, vc, block_tables, seq_lens)
        x = x + L.attn_output(lp["attn"], a[:, None])
        x = _mlp_block(cfg, lp, x)
    return _logits(cfg, params, x)[:, 0]


def paged_fused_step(cfg, params, tokens, positions, k_pages, v_pages,
                     block_tables, q_start, q_lens, write_pages,
                     write_slots, *, plain: bool = False):
    """One fused round: up to Q consecutive tokens per batch row in one
    pass over the layers.

    tokens/positions [B, Q] int; write_pages/write_slots [B, Q] int64;
    q_start/q_lens [B] i32 (first absolute position / valid tokens per
    row — 0 marks a padding row); k_pages/v_pages [L, P+1, page, Hkv,
    hd], written in place; block_tables [B, pps] i32. Returns the logits
    [B, V] f32 of each row's last valid token.

    Per layer the whole chunk's K/V is scattered into the pages first,
    then every query token attends causally over history + chunk prefix
    through ``paged_prefill_attention`` — so a PREFILL slot's C-token
    grant and every DECODE slot's single token share one step.
    ``plain`` is as in ``paged_decode_step``.
    """
    attend = ref.paged_prefill_attention_ref if plain \
        else paged_prefill_attention
    x = _embed(cfg, params, tokens)                     # [B, Q, d]
    for i, lp in enumerate(layer_params(params)):
        h = L.rms_norm(x, lp["ln1"], cfg.rms_eps)
        q, k, v = L.attn_project_qkv(lp["attn"], cfg, h, positions)
        kc, vc = k_pages[i], v_pages[i]
        kc[write_pages, write_slots] = k
        vc[write_pages, write_slots] = v
        a = attend(q.contiguous(), kc, vc, block_tables, q_start, q_lens)
        x = x + L.attn_output(lp["attn"], a)
        x = _mlp_block(cfg, lp, x)
    # only each row's last valid token's logits are consumed; slice
    # before the unembed so the step never materialises [B, Q, V]
    last = (q_lens.long() - 1).clamp(min=0)
    xl = x[torch.arange(x.shape[0], device=x.device), last]
    return _logits(cfg, params, xl[:, None])[:, 0]


def _q_bucket(n: int) -> int:
    """Round a round's query-axis width up to a power of two so the
    fused step sees O(log max_chunk) shapes, not one per distinct grant
    size."""
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


# ======================================================================
# host-side session state
# ======================================================================
@dataclass
class PagedSlot:
    """A live decode slot (one in-flight turn)."""
    session_id: str
    request: Request
    pending_token: int              # next token to feed
    tokens: List[int] = field(default_factory=list)
    # prompt tokens still to be teacher-forced (scheduler-driven chunked
    # prefill via submit_turn/run_round; None on the synchronous paths)
    prompt: Optional[np.ndarray] = None


@dataclass
class PagedSession:
    """Survives across turns: the multi-turn identity that owns pages."""
    session_id: str
    kv_len: int = 0                 # tokens whose KV is written
    base_pages: int = 0             # pages owned when current turn began
    turn_index: int = 0
    turn_arrival: float = 0.0
    reload_stall_s: float = 0.0     # on-path stall charged to this turn
    reload_off_path_s: float = 0.0  # reload seconds hidden off-path
    ended: bool = False             # user hung up; pages released
    history: List[List[int]] = field(default_factory=list)
    turn_stats: List[dict] = field(default_factory=list)
    # the committed token-id history (len == kv_len): the radix prefix
    # cache keys on it, and it migrates with the session
    token_ids: List[int] = field(default_factory=list)


class PagedRealtimeEngine:
    def __init__(self, cfg, params, *, slots: int = 4, page_size: int = 16,
                 pages_per_seq: int = 16, num_pages: Optional[int] = None,
                 clock=None, scheduler: Optional[UrgencyScheduler] = None,
                 kv: Optional[KVManager] = None, kv_policy: str = "next_use",
                 pcie_gb_s: float = 25.0, preload: bool = True,
                 device="cuda", mesh=None,
                 async_transfers: bool = True,
                 chunk_pages: Optional[int] = None,
                 transfer_chunks_per_round: int = 1,
                 fused_step: bool = True,
                 prefix_cache: bool = False,
                 kv_quant: str = "fp32",
                 spec_decode: int = 0):
        if cfg.family in ("moe", "vlm"):
            raise _not_ported(f"the {cfg.family} family", "9")
        assert cfg.family == "dense" and cfg.mla is None \
            and cfg.sliding_window is None, \
            "paged engine serves global-attention KV families"
        assert kv_policy in ("next_use", "lru"), \
            "the physical data plane needs an offload tier ('none' " \
            "discards pages; use the simulator for that baseline)"
        if mesh is not None:
            raise _not_ported("mesh= (the sharded page plane)", "7")
        if prefix_cache:
            raise _not_ported("prefix_cache=True", "4")
        if spec_decode:
            raise _not_ported("spec_decode>0", "4")
        if kv_quant == "int8":
            raise _not_ported(f"kv_quant={kv_quant!r}", "4")
        self.codec = KVWireCodec(kv_quant)
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the engine on {self.device}")
        self.cfg = cfg
        self.slots = slots
        self.page_size = page_size
        self.pages_per_seq = pages_per_seq
        self.max_context = pages_per_seq * page_size
        self.num_pages = num_pages or 2 * slots * pages_per_seq
        self.scratch_page = self.num_pages     # physical page beyond pool
        self.clock = clock or _StepClock()
        self.monitor = RuntimeMonitor(self.clock)
        self.kv_quant = kv_quant
        self.pool = PagedPool(self.num_pages, page_size, codec=self.codec)
        self.params = params

        hd = cfg.resolved_head_dim
        dtype = cfg.activation_dtype()
        shape = (cfg.num_layers, self.num_pages + 1, page_size,
                 cfg.num_kv_heads, hd)
        self.k_pages = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v_pages = torch.zeros(shape, dtype=dtype, device=self.device)
        itemsize = torch.tensor([], dtype=dtype).element_size()
        bytes_per_token = 2 * cfg.num_layers * cfg.num_kv_heads * hd \
            * itemsize
        # host copies stage through pinned memory; reloads copy on a
        # side stream so the wall-time wait covers that copy alone
        self._pinned = self.device.type == "cuda"
        self._copy_stream = torch.cuda.Stream(self.device) \
            if self._pinned else None
        self.kv = kv or KVManager(
            capacity_blocks=self.num_pages, block_size=page_size,
            bytes_per_token=float(bytes_per_token), monitor=self.monitor,
            policy=kv_policy, pcie_gb_s=pcie_gb_s, clock=self.clock)
        assert self.kv.capacity == self.num_pages \
            and self.kv.block_size == page_size, \
            "KVManager accounting must be 1:1 with pool pages"
        self.kv.channel.wire_scale = self.codec.wire_scale(itemsize)
        # the async chunked transfer engine: DRAM<->HBM movement queues
        # as page-group chunks drained by run_round;
        # async_transfers=False degrades to the synchronous
        # move-at-decision-time plane (the differential control)
        self.async_transfers = async_transfers
        self.transfer_chunks_per_round = transfer_chunks_per_round
        self.transfer = TransferEngine(self.kv.channel,
                                       chunk_pages=chunk_pages)
        self.transfer.set_io(reload_chunk=self._io_reload_chunk,
                             offload_chunk=self._io_offload_chunk)
        self.kv.set_page_hooks(
            on_evict=self._offload_pages, on_reload=self._reload_pages,
            on_cancel_reload=self._cancel_reload_pages,
            on_finish_transfers=(self._finish_transfers
                                 if async_transfers else None),
            pending_offload=self.transfer.pending_offload_pages)
        self.preloader = SpeechPreloader(self.kv, self.monitor,
                                         enabled=preload)
        # prefill_chunk clamps to the self-scheduled round budget
        # (= slots tokens) exactly as the gateway clamps its own
        self.scheduler = scheduler or UrgencyScheduler(
            SchedulerConfig(), self.monitor, stage="thinker",
            kv_occupancy=self.kv.occupancy,
            prefill_chunk=max(1, slots), decode_chunk=1)

        self.sessions: Dict[str, PagedSession] = {}
        self.slot_state: Dict[int, Optional[PagedSlot]] = {
            i: None for i in range(slots)}
        self._step_fn = paged_decode_step
        # the fused token-budget plane: one step per round, C-token
        # prefill chunks included. fused_step=False keeps the per-token
        # plane as the differential control.
        self.fused_step = fused_step
        self._fused_fn = paged_fused_step if fused_step else None
        # telemetry
        self.reload_wall_s: List[float] = []   # measured host->device time
        self.offload_events: List[tuple] = []
        self.pressure_holds = 0                # feeds held mid-round
        self.fused_launches = 0                # fused-plane step launches
        # quality-gate tap: when set, called as logit_tap(sid, logits)
        # for every fed row (fused rows report last-valid-token logits —
        # the ones the argmax commits)
        self.logit_tap = None

    # ------------------------------------------------------------ pages
    def _sync_page_counts(self, sid: str) -> None:
        # read-only bounds: a session released from the pool (hangup) or
        # never admitted must report 0/0, not have `pool.seq` re-create a
        # ghost entry for it (check_invariants iterates pool.seqs)
        s = self.pool.seqs.get(sid)
        # resident = usable on device (offloading pages still count: the
        # copy-then-free slot holds valid contents); offloaded = host
        # copy is authoritative (loading pages still count: contents
        # have not landed yet) — the two partitions sum to committed
        self.monitor.on_page_movement(
            sid, resident=self.pool.resident_pages(sid),
            offloaded=len(s.offloaded) if s else 0)

    def _offload_pages(self, sid: str, blocks: int) -> None:
        """KVManager eviction hook: queue suffix pages for DRAM
        (copy-then-free — slots stay usable until each chunk drains;
        allocation pressure demand-drains via ``_demand_free_pages``).
        Suffix pages whose *reload* is still in flight are cancelled
        instead: freeing them needs no copy, their bytes never left the
        host store (the eviction-of-a-loading-session rule)."""
        cancel_lis, offload_lis = self.pool.evictable_suffix(sid, blocks)
        assert len(cancel_lis) + len(offload_lis) == blocks, \
            f"accounting evicted {blocks} but only " \
            f"{len(cancel_lis) + len(offload_lis)} evictable ({sid})"
        if cancel_lis:
            dropped = self.transfer.cancel_reload_pages(sid, cancel_lis)
            assert dropped == len(cancel_lis), (sid, cancel_lis)
            self.pool.cancel_loading(sid, cancel_lis)
        if offload_lis:
            self.pool.mark_offloading(sid, offload_lis)
            self.transfer.submit_offload(sid, offload_lis)
            if not self.async_transfers:
                self.transfer.drain(self.clock.now(),
                                    kinds=("offload",))
        self.offload_events.append((self.clock.now(), sid, blocks))
        self._sync_page_counts(sid)

    def _reload_pages(self, sid: str, blocks: int, *, background: bool,
                      transfer=None) -> None:
        """KVManager reload hook: queue the offloaded pages as chunked
        host->device transfers. In-flight offloads cancel for free
        (copy-then-free); slots for the rest are reserved now (the
        pool's ``loading`` marks), contents land as chunks drain — or
        at turn-start settlement for the on-path remainder."""
        cancelled = self.pool.cancel_offloading(sid)
        if cancelled:
            self.transfer.cancel_offload_pages(sid, cancelled)
        # reserving slots may need room the accounting freed but the
        # copy-then-free plane has not physically drained yet
        s = self.pool.seq(sid)
        need = sum(1 for li in s.offloaded if li not in s.loading)
        self._demand_free_pages(need)
        lis = self.pool.begin_reload(sid)
        assert len(lis) + len(cancelled) == blocks, \
            f"accounting reloaded {blocks} but pool restored " \
            f"{len(lis)} + cancelled {len(cancelled)} ({sid})"
        self.transfer.submit_reload(sid, lis, transfer)
        if not background or not self.async_transfers:
            # synchronous path: settle immediately; the preloader (or
            # direct kv.reload caller) reads the split via the ledger
            self.transfer.finish_session(sid, self.clock.now())
        self._sync_page_counts(sid)

    def _cancel_reload_pages(self, sid: str) -> int:
        """KVManager burst-cancel hook: drop the session's queued
        reload chunks, free their reserved slots (host copies stay
        authoritative). Returns pages cancelled."""
        dropped = self.transfer.cancel_reload_pages(sid)
        if dropped:
            lis = sorted(self.pool.seq(sid).loading)
            assert len(lis) == dropped, (sid, lis, dropped)
            self.pool.cancel_loading(sid, lis)
            self._sync_page_counts(sid)
        return dropped

    def _finish_transfers(self, sid: str, now: float):
        """KVManager settlement hook (turn start): complete the
        session's queued reload chunks; (on_path_s, off_path_s)."""
        self.transfer.finish_session(sid, now)
        return self.transfer.pop_split(sid)

    # ------------------------------------------------------ transfer io
    def _stage(self, host: torch.Tensor) -> torch.Tensor:
        """Copy a host stack to the device and wait on that copy alone
        (an event on a side stream) — waiting on the whole device would
        over-synchronise unrelated decode work."""
        if not self._pinned:
            return host.to(self.device)
        with torch.cuda.stream(self._copy_stream):
            staged = host.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        done.synchronize()
        # the buffer is read on the compute stream from here on
        staged.record_stream(torch.cuda.current_stream(self.device))
        return staged

    def _io_reload_chunk(self, sid: str, lis: List[int]) -> None:
        """Physically land one reload chunk. The host stack is staged
        to the device and only that copy is timed for the wall-time
        measurement; the pool then scatters it in place."""
        s = self.pool.seq(sid)
        host = torch.stack([self.codec.decode(s.offloaded[li])
                            for li in lis])
        if self._pinned:
            host = host.pin_memory()
        t0 = time.perf_counter()
        staged = self._stage(host)
        self.reload_wall_s.append(time.perf_counter() - t0)
        self.pool.complete_reload(
            sid, lis, LayerStackedPages(self.k_pages, self.v_pages),
            staged=staged)
        self._sync_page_counts(sid)

    def _io_offload_chunk(self, sid: str, lis: List[int]) -> None:
        """Physically land one offload chunk: gather the device pages
        to host copies (``[2, L, page, Hkv, hd]`` per page, in the
        store's dtype, so bf16 round-trips bit for bit), then free the
        slots (copy-then-free step 2)."""
        s = self.pool.seq(sid)
        phys = torch.as_tensor([s.pages[li] for li in lis],
                               dtype=torch.int64, device=self.device)
        dev = torch.stack([self.k_pages.index_select(1, phys),
                           self.v_pages.index_select(1, phys)]) \
            .movedim(2, 0)                      # [n, 2, L, page, Hkv, hd]
        host = torch.empty(dev.shape, dtype=dev.dtype,
                           pin_memory=self._pinned)
        host.copy_(dev)               # blocking: the copies are durable
        self.pool.complete_offload(
            sid, {li: self.codec.encode(host[i])
                  for i, li in enumerate(lis)})
        self._sync_page_counts(sid)

    def drain_transfers(self, max_chunks: Optional[int] = None) -> int:
        """Complete up to ``max_chunks`` queued transfer chunks (both
        directions, FIFO). run_round calls this with the per-round
        budget; the gateways call it from their idle loops so preloads
        progress even when nothing is decoding."""
        return self.transfer.drain(self.clock.now(), max_chunks)

    def flush_transfers(self) -> int:
        """Drain everything (tests / shutdown)."""
        return self.transfer.drain(self.clock.now(), None)

    def _demand_free_pages(self, need: int) -> None:
        """Allocation needs physical slots the accounting already freed:
        complete queued offload chunks until the pool can satisfy it."""
        self.transfer.drain_offloads_until(
            self.clock.now(), lambda: self.pool.free_pages >= need)

    def _grow(self, sid: str, token_capacity: int, *,
              best_effort: bool = False) -> bool:
        """Own enough pages for token_capacity tokens; KVManager evicts
        idle sessions (physically, via the hook) when the pool is short."""
        token_capacity = min(token_capacity, self.max_context)
        need = self.pool.pages_for(token_capacity) \
            - len(self.pool.seq(sid).pages)
        if need <= 0:
            return True
        now = self.clock.now()
        if best_effort and (self.kv.free_blocks < need
                            or self.pool.free_pages
                            + self.transfer.pending_offload_pages()
                            < need):
            return False
        if not self.kv.try_allocate_working(need, now):
            raise OutOfPages(
                f"{sid}: need {need} pages, {self.kv.free_blocks} free "
                "and nothing evictable")
        # accounting freed the blocks; copy-then-free may still hold the
        # physical slots until its chunks drain — demand them now
        self._demand_free_pages(need)
        if best_effort and self.pool.free_pages < need:
            self.kv.release_working(need)     # undo the allocation above
            return False
        self.pool.ensure_capacity(sid, token_capacity)
        return True

    # ------------------------------------------------------------ admit
    def free_slot(self) -> Optional[int]:
        for i, s in self.slot_state.items():
            if s is None:
                return i
        return None

    def add_session(self, session_id: str, prompt: np.ndarray,
                    max_new_tokens: int) -> int:
        """Turn 0, synchronous path: prefill the prompt into pool pages
        before returning; returns slot id."""
        sess = self._prep_first_turn(session_id)
        return self._begin_turn(sess, np.asarray(prompt, np.int32),
                                max_new_tokens, first=True)

    def start_turn(self, session_id: str, prompt: np.ndarray,
                   max_new_tokens: int) -> int:
        """A later turn reaches the LLM stage (synchronous path): reload
        whatever KV is still offloaded (warm no-op on a preload hit),
        then extend the paged context with the new prompt — the
        committed history is never re-prefilled."""
        sess = self._prep_next_turn(session_id)
        return self._begin_turn(sess, np.asarray(prompt, np.int32),
                                max_new_tokens, first=False)

    def submit_turn(self, session_id: str, prompt: np.ndarray,
                    max_new_tokens: int, *,
                    request: Optional[Request] = None) -> int:
        """Scheduler-drivable turn admission (DESIGN.md §4): bind a free
        slot and run the reload path, but leave the request in PREFILL —
        prompt tokens are teacher-forced through the shared fixed-batch
        step as ``run_round`` chunks grant them (chunked paged prefill
        that interleaves with other sessions' decode), and the first
        output token appears the round the last prompt token is fed.
        A pre-built ``request`` lets the control plane rank the turn
        while it was still queued (its arrival_time is the instant the
        utterance reached the gateway, preserving queue wait in TTFP).
        Works for turn 0 and later turns alike."""
        prompt = np.asarray(prompt, np.int32)
        if session_id not in self.sessions:
            sess = self._prep_first_turn(session_id)
        else:
            sess = self._prep_next_turn(session_id)
        if request is not None:
            sess.turn_arrival = min(sess.turn_arrival,
                                    request.arrival_time)
        slot = self.free_slot()
        assert slot is not None, "no free decode slot"
        req = self._make_request(sess, prompt, max_new_tokens,
                                 request=request)
        self.slot_state[slot] = PagedSlot(session_id, req, -1, [],
                                          prompt=prompt)
        self._sync_page_counts(session_id)
        return slot

    def _prep_first_turn(self, session_id: str) -> PagedSession:
        assert session_id not in self.sessions, \
            "session exists — use start_turn/submit_turn for later turns"
        self.monitor.register(session_id)
        self.monitor.on_turn_start(session_id, 0)
        sess = PagedSession(session_id)
        self.sessions[session_id] = sess
        sess.turn_arrival = self.clock.now()
        sess.reload_stall_s = 0.0
        sess.reload_off_path_s = 0.0
        return sess

    def _prep_next_turn(self, session_id: str) -> PagedSession:
        sess = self.sessions[session_id]
        assert not sess.ended, f"{session_id} ended; KV pages are gone"
        # reload FIRST, before any turn bookkeeping mutates: on a
        # saturated pool (every other session pinned or speech-protected)
        # the sync-fallback reload can fail to fit, and that must surface
        # as recoverable pressure the control plane can retry — not as a
        # half-started turn. Pin before the reload path: its eviction
        # pass must never pick the session being brought back as its own
        # victim.
        self.kv.pin(session_id)
        stall = self.preloader.on_turn_ready(session_id, self.clock.now())
        # the accounting view (dram blocks), not the host-copy dict, is
        # the guard: under copy-then-free a saturated-pool session can
        # have its suffix still *offloading* (chunks queued, `offloaded`
        # empty) — starting its turn anyway would let a later round's
        # FIFO drain move the pages to DRAM mid-decode and crash the
        # block-table build instead of requeueing recoverably
        if self.kv.missing_blocks(session_id) > 0:
            self.kv.session(session_id).pinned = False
            # the settlement that just ran stalled nothing (this turn is
            # requeued): its seconds carry forward as off-path credit
            # and its pages reclassify, so the overlap accounting never
            # drops already-done reload work on a requeue
            self.preloader.requeue_split(session_id)
            self.transfer.requeue_settlement(session_id)
            raise OutOfPages(
                f"{session_id}: pool too saturated to restore "
                f"{self.kv.missing_blocks(session_id)} non-resident "
                "blocks; keep the turn queued and retry")
        self.transfer.settlement_committed(session_id)
        assert self.pool.inflight_pages(session_id) == (0, 0) \
            and not self.pool.seq(session_id).offloaded, \
            f"{session_id}: turn starting with pages still in flight"
        sess.turn_index += 1
        # the utterance is over once its turn reaches the LLM stage —
        # clear `speaking` or the session stays immediate_reuse forever
        # and its idle KV becomes permanently unevictable
        self.monitor.on_speech_end(session_id)
        self.monitor.on_turn_start(session_id, sess.turn_index)
        sess.turn_arrival = self.clock.now()
        if stall > 0:
            self.clock.tick(stall)          # on-path sync reload residual
        sess.reload_stall_s = stall
        _, sess.reload_off_path_s = self.preloader.pop_split(session_id)
        return sess

    def _make_request(self, sess: PagedSession, prompt: np.ndarray,
                      max_new_tokens: int, *,
                      request: Optional[Request] = None) -> Request:
        sid = sess.session_id
        P = int(prompt.shape[0])
        assert sess.kv_len + P + max_new_tokens <= self.max_context, \
            f"{sid}: turn would exceed pages_per_seq*page_size context"
        self.kv.pin(sid)
        sess.base_pages = len(self.pool.seq(sid).pages)
        re_prefill = self.kv.recompute_tokens(sid)
        if request is None:
            req = Request(session_id=sid, stage="thinker",
                          turn_index=sess.turn_index,
                          arrival_time=sess.turn_arrival, prompt_len=P,
                          context_len=sess.kv_len,
                          max_new_tokens=max_new_tokens)
        else:
            req = request
            req.turn_index = sess.turn_index
            req.prompt_len = P
            req.context_len = sess.kv_len
            req.max_new_tokens = max_new_tokens
        req.reload_stall_s = sess.reload_stall_s
        req.reload_off_path_s = sess.reload_off_path_s
        req.prefix_hit_tokens = 0          # no prefix cache on this slice
        sess.turn_stats.append({
            "turn": sess.turn_index,
            "context_tokens": req.context_len,
            "prompt_tokens": P,
            "ttft_s": None,                 # set at first output token
            "reload_stall_s": sess.reload_stall_s,
            "reload_off_path_s": sess.reload_off_path_s,
            "re_prefill_tokens": re_prefill,
            "prefix_hit_tokens": req.prefix_hit_tokens,
            "generated": 0,
            "aborted": False,
        })
        return req

    def _begin_turn(self, sess: PagedSession, prompt: np.ndarray,
                    max_new_tokens: int, *, first: bool) -> int:
        sid = sess.session_id
        slot = self.free_slot()
        assert slot is not None, "no free decode slot"
        req = self._make_request(sess, prompt, max_new_tokens)
        self._grow(sid, sess.kv_len + req.prompt_len)
        if self.fused_step:
            # turn 0 (the former dense-prefill graft) and turn-N
            # extension share the one fused path (DESIGN.md §11)
            tok = self._prefill_fused(slot, sess, prompt)
        elif first and sess.kv_len == 0:
            # the dense graft writes whole pages from position 0 — only
            # valid when nothing (no attached prefix) precedes it
            tok = self._prefill_dense(sess, prompt)
        else:
            tok = self._prefill_paged(slot, sess, prompt)
        req.phase = Phase.DECODE
        req.prefilled = req.prompt_len
        req.first_output_time = self.clock.now()
        self.slot_state[slot] = PagedSlot(sid, req, tok, [tok])
        sess.turn_stats[-1]["ttft_s"] = self.clock.now() - sess.turn_arrival
        self._sync_page_counts(sid)
        return slot

    def _prefill_dense(self, sess: PagedSession, prompt: np.ndarray) -> int:
        """Turn-0 fast path: one dense B=1 prefill (attention through the
        ``flash_prefill`` kernel), grafted into the session's pool pages
        (page-aligned ``index_copy_`` into the page store)."""
        sid = sess.session_id
        P = int(prompt.shape[0])
        npages = self.pool.pages_for(P)
        cap = npages * self.page_size
        c1 = init_cache(self.cfg, 1, cap, self.device)
        logits, c1 = prefill(self.cfg, self.params,
                             self._tensor(prompt.astype(np.int64))[None, :],
                             c1)
        phys = self._tensor(np.asarray(self.pool.seq(sid).pages[:npages],
                                       np.int64))
        shape = (self.cfg.num_layers, npages, self.page_size,
                 *c1["k"].shape[3:])
        self.k_pages.index_copy_(1, phys, c1["k"][:, 0].reshape(shape))
        self.v_pages.index_copy_(1, phys, c1["v"][:, 0].reshape(shape))
        sess.kv_len = P
        sess.token_ids = [int(t) for t in prompt]
        self.clock.tick()
        return int(torch.argmax(logits[0]))

    def _prefill_fused(self, slot: int, sess: PagedSession,
                       prompt: np.ndarray) -> int:
        """Synchronous prefill on the fused plane: the whole prompt is
        one multi-token launch — turn 0 lands in fresh pages, turn N
        extends the committed context (never re-prefilled) — and the
        last token's logits are the first output token."""
        logits = self._run_chunk_rows(
            {slot: (sess.session_id,
                    np.asarray(prompt, np.int32))})[slot]
        sess.kv_len += int(prompt.shape[0])
        sess.token_ids += [int(t) for t in prompt]
        self.clock.tick()
        return int(np.argmax(logits))

    def _prefill_paged(self, slot: int, sess: PagedSession,
                       prompt: np.ndarray) -> int:
        """Turn-N extension on the per-token plane (``fused_step=False``
        differential control): teacher-force the new prompt through the
        paged step so its KV lands behind the committed context — no
        re-prefill of history.

        Like the dense engine's add_session, this runs synchronously:
        concurrent decode holds for prompt_len rounds (turn prompts are
        short utterance transcripts); the fused plane collapses this to
        one launch (DESIGN.md §11)."""
        logits = None
        for t in prompt:
            logits = self._run_rows({slot: (sess.session_id, int(t))})[slot]
            sess.kv_len += 1
            sess.token_ids.append(int(t))
            self.clock.tick()
        return int(np.argmax(logits))

    # ------------------------------------------------------------ speech
    def user_speech_start(self, session_id: str,
                          expected_dur_s: Optional[float] = None):
        """VAD speech-start: update telemetry and fire the speech-time
        preload (§5.2) — admitted preloads physically reload pages via
        the KVManager hook while the user is still speaking."""
        self.monitor.on_speech_start(session_id, expected_dur_s)
        return self.preloader.on_speech_start(session_id, self.clock.now())

    def barge_in(self, session_id: str,
                 expected_dur_s: Optional[float] = None):
        """User interrupts playback: abort the in-flight turn (keeping
        committed pages) and treat the interruption as speech start."""
        self.abort(session_id)
        if expected_dur_s is not None:
            self.monitor.register(session_id).expected_speech_end = \
                self.clock.now() + expected_dur_s
        return self.preloader.on_speech_start(session_id, self.clock.now())

    def tool_call_start(self, session_id: str,
                        expected_latency_s: float = 0.0) -> None:
        """The turn's reply ended in a tool invocation: the session goes
        idle mid-conversation with hot KV. Protect it under the
        tool-pause TTL and point Eq. 4 next-use at the tool's expected
        return instead of the reply-gap EMA."""
        now = self.clock.now()
        self.monitor.on_tool_call_start(session_id, expected_latency_s)
        self.kv.protect_tool(session_id, now, expected_latency_s)
        self.kv.refresh_session(session_id, now)

    def tool_call_result(self, session_id: str,
                         resume_gap_s: float = 0.0):
        """The tool returned; the resume turn arrives in ~resume_gap_s.
        Lift the tool-pause protection and fire the ordinary speech-time
        preload machinery over the gap, so a session whose pages were
        evicted anyway (TTL lapse, pool pressure) reloads off-path and
        resumes without re-prefill."""
        now = self.clock.now()
        self.monitor.on_tool_call_result(session_id, resume_gap_s)
        self.kv.clear_tool_protection(session_id, now)
        return self.preloader.on_speech_start(session_id, now)

    def end_session(self, session_id: str) -> None:
        """User hung up: free the session's pages (HBM and DRAM copies)
        and its accounting. History/turn stats stay readable."""
        assert all(s is None or s.session_id != session_id
                   for s in self.slot_state.values()), \
            "abort the live turn before ending the session"
        # drop queued transfer chunks first: release() frees the slots
        # (including loading reservations) and the host copies, so a
        # hangup mid-transfer leaks nothing
        self.transfer.cancel_session(session_id)
        self.preloader.forget_session(session_id)
        self.pool.release(session_id)
        self.kv.release_session(session_id)
        self.sessions[session_id].ended = True
        self.monitor.on_page_movement(session_id, resident=0, offloaded=0)

    def abort(self, session_id: str) -> None:
        """Barge-in: drop the in-flight request. Committed pages (context
        + tokens already written) stay owned; in-flight lookahead pages
        are trimmed back to the pool."""
        for i, s in self.slot_state.items():
            if s is None or s.session_id != session_id:
                continue
            s.request.state = RequestState.ABORTED
            self.monitor.on_barge_in(session_id)
            self._close_turn(i, aborted=True)

    # ------------------------------------------------------------ rounds
    def active(self) -> List[PagedSlot]:
        return [s for s in self.slot_state.values()
                if s is not None and s.request.is_live()
                and s.request.generated < s.request.max_new_tokens]

    def step(self) -> List[int]:
        """One self-scheduled round: the engine's own scheduler picks the
        slots *and their token grants* (``chunk_for`` — a PREFILL slot
        gets its prefill chunk, a decode slot one token), then one
        fixed-batch paged round. Returns scheduled slot ids. (The
        gateway bypasses this and calls ``run_round`` with its own
        scheduler's decision — DESIGN.md §4.)"""
        self.clock.tick()
        act = self.active()
        if not act:
            return []
        sched_slots, grants = schedule_round(
            self.scheduler, self.kv, self.clock, self.slot_state, act,
            self.slots,
            block_size=self.page_size)
        if not sched_slots:
            return []
        self.run_round(grants)
        return sched_slots

    def run_round(self, chunks: Dict[int, int]) -> Dict[int, List[tuple]]:
        """Execute one already-scheduled round: ``chunks[slot]`` is the
        token budget the control plane granted that slot this round.
        A decode slot advances one token; a PREFILL slot (submit_turn)
        teacher-forces up to its chunk of prompt tokens.

        On the fused plane (``fused_step=True``, the default) the whole
        round — every slot's grant, C-token prefill chunks included —
        packs into **one step** (DESIGN.md §11): each slot's
        chunk KV is scattered in one paged write and every query token
        attends causally over history + chunk prefix. With
        ``fused_step=False`` chunks > 1 run as sequential single-token
        sub-batches in which every other granted slot participates only
        once — the per-token differential control.

        Returns per-slot event lists for the caller to stream out:
        ``("prefill", n_prefilled)``, ``("token", tok)`` (playable output
        token, the first of which marks TTFT), ``("finished", n_tokens)``.
        Safe to interleave with ``abort``/``submit_turn`` between calls
        (asyncio single-thread discipline: never called concurrently).

        Around the launch (between decode sub-batches on the per-token
        plane) the round drains up to ``transfer_chunks_per_round``
        queued transfer chunks — this is where a speech-time preload
        physically lands while other sessions keep decoding
        (DESIGN.md §10)."""
        if self.fused_step:
            return self._run_round_fused(chunks)
        return self._run_round_tokenwise(chunks)

    def _round_feeds(self, chunks: Dict[int, int]) -> Dict[int, tuple]:
        """The round's grants as token arrays: ``{slot: (sid, tokens)}``
        — a PREFILL slot's next chunk of prompt tokens, one pending
        token for a decode slot — growing each sequence once for its
        whole grant (plus one best-effort lookahead page). A slot whose
        mandatory growth hits pool pressure is held for the round
        (``pressure_holds``): it retries next round when pressure
        drains; scheduling moves WHEN tokens appear, never WHICH
        (§5.2), so holding is safe."""
        feeds: Dict[int, tuple] = {}
        for i, c in chunks.items():
            s = self.slot_state[i]
            if s is None or not s.request.is_live():
                continue
            r = s.request
            if r.phase == Phase.PREFILL:
                n = min(c, r.prompt_len - r.prefilled)
                if n > 0:
                    feeds[i] = (s.session_id,
                                np.asarray(s.prompt[r.prefilled:
                                                    r.prefilled + n],
                                           np.int32))
            elif c > 0 and r.generated < r.max_new_tokens:
                # a zero grant is "not scheduled this round" on both
                # planes — the planes' bit-exactness contract covers
                # every run_round input, not just scheduler outputs
                feeds[i] = (s.session_id,
                            np.asarray([s.pending_token], np.int32))
        for i in list(feeds):
            sid, toks = feeds[i]
            sess = self.sessions[sid]
            try:
                self._grow(sid, sess.kv_len + len(toks))
            except OutOfPages:
                # allocation failure mid-round: admission accounted
                # blocks that interaction events (speech protection, a
                # barge-in trim re-pinning pressure elsewhere) made
                # unreclaimable by the time this round allocates.
                del feeds[i]
                self.pressure_holds += 1
                continue
            # best-effort lookahead, hoisted to once per slot per round:
            # own the page past the whole grant
            # before any write crosses into it, so boundary tokens never
            # wait on allocation/eviction (these are the in-flight pages
            # a barge-in trims)
            self._grow(sid, sess.kv_len + len(toks) + self.page_size,
                       best_effort=True)
        return feeds

    def _run_round_fused(self, chunks: Dict[int, int]) \
            -> Dict[int, List[tuple]]:
        """One round = one launch: pack every grant into a padded
        [slots, Q] token batch and advance all of it in a single
        fused step."""
        events: Dict[int, List[tuple]] = {i: [] for i in chunks}
        xfer_budget = self.transfer_chunks_per_round
        if xfer_budget > 0:
            xfer_budget -= self.drain_transfers(1)
        feeds = self._round_feeds(chunks)
        if feeds:
            out = self._run_chunk_rows(feeds)
            for i, (sid, toks) in feeds.items():
                s = self.slot_state[i]
                sess = self.sessions[sid]
                n = len(toks)
                r = s.request
                if r.phase == Phase.PREFILL:
                    sess.kv_len += n
                    sess.token_ids += [int(t) for t in toks]
                    tok = int(np.argmax(out[i]))
                    r.prefilled += n
                    # same event stream as the per-token plane: one
                    # progress event per intermediate prompt token, and
                    # the chunk's last logits become the first output
                    # token iff the prompt completed this round
                    events[i] += [("prefill", r.prefilled - n + 1 + t)
                                  for t in range(n - (1 if r.done_prefill
                                                     else 0))]
                    if r.done_prefill:
                        r.phase = Phase.DECODE
                        r.first_output_time = self.clock.now()
                        s.pending_token = tok
                        s.tokens.append(tok)
                        sess.turn_stats[-1]["ttft_s"] = \
                            self.clock.now() - sess.turn_arrival
                        events[i].append(("token", tok))
                    continue
                # decode: the row fed exactly [pending] and emits its one
                # argmax
                sess.kv_len += 1
                sess.token_ids.append(int(toks[0]))
                tok = int(np.argmax(out[i]))
                r.generated += 1
                s.pending_token = tok
                if r.generated < r.max_new_tokens:
                    s.tokens.append(tok)
                    events[i].append(("token", tok))
                else:
                    r.state = RequestState.FINISHED
                    self._close_turn(i, aborted=False)
                    events[i].append(("finished", r.generated))
        if xfer_budget > 0:
            self.drain_transfers(xfer_budget)
        return events

    def _run_round_tokenwise(self, chunks: Dict[int, int]) \
            -> Dict[int, List[tuple]]:
        """The per-token plane (``fused_step=False``): chunks > 1 run as
        sequential single-token sub-batches — the differential control
        the fused plane is bit-exactness-tested against."""
        events: Dict[int, List[tuple]] = {i: [] for i in chunks}
        xfer_budget = self.transfer_chunks_per_round
        lookahead_done = set()
        for j in range(max(chunks.values(), default=0)):
            if xfer_budget > 0:
                xfer_budget -= self.drain_transfers(1)
            feeds = {}
            for i, c in chunks.items():
                s = self.slot_state[i]
                if s is None or not s.request.is_live():
                    continue
                r = s.request
                if r.phase == Phase.PREFILL:
                    if j < c and r.prefilled < r.prompt_len:
                        feeds[i] = (s.session_id,
                                    int(s.prompt[r.prefilled]))
                elif j == 0 and c > 0 \
                        and r.generated < r.max_new_tokens:
                    feeds[i] = (s.session_id, s.pending_token)
            if not feeds:
                break
            for i in list(feeds):
                s = self.slot_state[i]
                sess = self.sessions[s.session_id]
                try:
                    self._grow(s.session_id, sess.kv_len + 1)
                except OutOfPages:
                    # mid-chunk allocation failure: admission accounted
                    # blocks that interaction events (speech protection,
                    # a barge-in trim re-pinning pressure elsewhere)
                    # made unreclaimable by the time this sub-batch
                    # allocates. Hold the slot — it retries next round
                    # when pressure drains; scheduling moves WHEN tokens
                    # appear, never WHICH (§5.2), so holding is safe.
                    del feeds[i]
                    self.pressure_holds += 1
                    continue
                # best-effort lookahead, hoisted to once per slot per
                # round: cover the slot's remaining
                # grant plus the page past it, so the boundary token
                # never waits on allocation/eviction (these are the
                # in-flight pages a barge-in trims)
                if i not in lookahead_done:
                    lookahead_done.add(i)
                    r = s.request
                    rest = min(chunks[i] - j,
                               r.prompt_len - r.prefilled) \
                        if r.phase == Phase.PREFILL else 1
                    self._grow(s.session_id,
                               sess.kv_len + rest + self.page_size,
                               best_effort=True)
            if not feeds:
                continue                     # everything held this round
            out = self._run_rows(feeds)
            for i in feeds:
                s = self.slot_state[i]
                sess = self.sessions[s.session_id]
                sess.kv_len += 1
                sess.token_ids.append(int(feeds[i][1]))
                r = s.request
                tok = int(np.argmax(out[i]))
                if r.phase == Phase.PREFILL:
                    r.prefilled += 1
                    if r.done_prefill:
                        # the last prompt token's logits are the first
                        # output token — same contract as the sync paths
                        r.phase = Phase.DECODE
                        r.first_output_time = self.clock.now()
                        s.pending_token = tok
                        s.tokens.append(tok)
                        sess.turn_stats[-1]["ttft_s"] = \
                            self.clock.now() - sess.turn_arrival
                        events[i].append(("token", tok))
                    else:
                        events[i].append(("prefill", r.prefilled))
                else:
                    r.generated += 1
                    s.pending_token = tok
                    if r.generated < r.max_new_tokens:
                        s.tokens.append(tok)
                        events[i].append(("token", tok))
                    else:
                        r.state = RequestState.FINISHED
                        self._close_turn(i, aborted=False)
                        events[i].append(("finished", r.generated))
        if xfer_budget > 0:
            self.drain_transfers(xfer_budget)
        return events

    def _tensor(self, a: np.ndarray, dtype=None) -> torch.Tensor:
        """One host array of the round's tables to the device."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(self.device, dtype) if dtype is not None \
            else t.to(self.device)

    def _run_rows(self, feeds: Dict[int, tuple]) -> Dict[int, np.ndarray]:
        """Run one step with `feeds[row] = (sid, token)`; other rows are
        padded to the scratch page. Returns per-row logits."""
        rows: List[Optional[tuple]] = [None] * self.slots
        tokens = np.zeros((self.slots,), np.int64)
        for i, (sid, tok) in feeds.items():
            rows[i] = (sid, self.sessions[sid].kv_len)
            tokens[i] = tok
        tabs: BatchTables = assemble(self.pool, rows, self.pages_per_seq,
                                     self.scratch_page)
        i64 = torch.int64
        logits = self._step_fn(
            self.cfg, self.params, self._tensor(tokens),
            self._tensor(tabs.positions), self.k_pages, self.v_pages,
            self._tensor(tabs.block_tables), self._tensor(tabs.seq_lens),
            self._tensor(tabs.write_page, i64),
            self._tensor(tabs.write_slot, i64))
        logits = logits.cpu().numpy()
        if self.logit_tap is not None:
            for i, (sid, _) in feeds.items():
                self.logit_tap(sid, logits[i])
        return {i: logits[i] for i in feeds}

    def _run_chunk_rows(self, feeds: Dict[int, tuple]) \
            -> Dict[int, np.ndarray]:
        """Run one fused step with ``feeds[row] = (sid, tokens)`` — up
        to Q consecutive tokens per row, padded (rows and token slots
        alike) onto the scratch page. Returns each row's last valid
        token's logits."""
        q_tokens = _q_bucket(max(len(t) for _, t in feeds.values()))
        rows: List[Optional[tuple]] = [None] * self.slots
        tokens = np.zeros((self.slots, q_tokens), np.int64)
        for i, (sid, toks) in feeds.items():
            rows[i] = (sid, self.sessions[sid].kv_len, len(toks))
            tokens[i, :len(toks)] = toks
        tabs: FusedBatchTables = assemble_fused(
            self.pool, rows, q_tokens, self.pages_per_seq,
            self.scratch_page)
        i64 = torch.int64
        logits = self._fused_fn(
            self.cfg, self.params, self._tensor(tokens),
            self._tensor(tabs.positions), self.k_pages, self.v_pages,
            self._tensor(tabs.block_tables), self._tensor(tabs.q_start),
            self._tensor(tabs.q_lens), self._tensor(tabs.write_pages, i64),
            self._tensor(tabs.write_slots, i64))
        self.fused_launches += 1
        logits = logits.cpu().numpy()
        if self.logit_tap is not None:
            for i, (sid, _) in feeds.items():
                self.logit_tap(sid, logits[i])
        return {i: logits[i] for i in feeds}

    def _close_turn(self, slot: int, *, aborted: bool) -> None:
        s = self.slot_state[slot]
        sid = s.session_id
        sess = self.sessions[sid]
        now = self.clock.now()
        trimmed = self.pool.trim(sid, sess.kv_len)   # in-flight lookahead
        grown = len(self.pool.seq(sid).pages) - sess.base_pages
        self.kv.release_working(grown + trimmed)
        self.kv.commit_turn(sid, sess.kv_len, now)
        if not aborted:
            self.monitor.on_response_complete(sid)
        sess.history.append(list(s.tokens))
        sess.turn_stats[-1].update(generated=s.request.generated,
                                   aborted=aborted)
        self.slot_state[slot] = None
        self._sync_page_counts(sid)

    def run_to_completion(self, max_rounds: int = 10_000) -> Dict[str, list]:
        for _ in range(max_rounds):
            if not self.active():
                break
            self.step()
        if self.active():
            raise RoundLimitExceeded(
                f"{len(self.active())} slots still live after "
                f"{max_rounds} rounds")
        out = {}
        for sid, sess in self.sessions.items():
            if sess.history:
                out[sid] = sess.history[-1]
        for s in self.slot_state.values():
            if s is not None:
                out[s.session_id] = s.tokens
        return out

    # ------------------------------------------------------------ checks
    def check_invariants(self) -> None:
        """Pool/accounting consistency (exercised by tests)."""
        from collections import Counter
        # every allocated page is referenced exactly once (no prefix
        # cache on this slice, so no sharing and no cache-held pages)
        refs = Counter(p for s in self.pool.seqs.values()
                       for p in s.pages if p >= 0)
        for p, c in self.pool.refcount.items():
            assert refs.get(p, 0) == c, \
                f"page {p}: refcount {c} != {refs.get(p, 0)} references"
        allocated = set(self.pool.refcount)
        assert set(refs).issubset(allocated)
        assert allocated.isdisjoint(self.pool.free), "free+allocated page"
        assert len(allocated) + self.pool.free_pages == self.num_pages
        assert self.kv.cached_blocks == 0 \
            and not self.pool.cache_held \
            and all(c == 1 for c in self.pool.refcount.values())
        # copy-then-free: an offloading page is accounting-evicted but
        # physically still owned until its chunk drains
        offloading = sum(len(s.offloading)
                         for s in self.pool.seqs.values())
        assert self.kv.used_blocks == len(allocated) - offloading, \
            f"accounting {self.kv.used_blocks} != physical " \
            f"{len(allocated)} - offloading {offloading}"
        # per-session page-state conservation:
        # resident + in-flight + offloaded == committed, disjointly
        for sid, s in self.pool.seqs.items():
            resident = sum(1 for li, p in enumerate(s.pages)
                           if p >= 0 and li not in s.loading
                           and li not in s.offloading)
            assert s.loading.isdisjoint(s.offloading), sid
            assert all(li in s.offloaded for li in s.loading), sid
            pure_off = len(s.offloaded) - len(s.loading)
            assert resident + len(s.loading) + len(s.offloading) \
                + pure_off == len(s.pages), \
                f"{sid}: page states do not partition the page list"
        # ledger <-> pool bijection (queued chunks match the marks)
        self.transfer.check(self.pool)


# ======================================================================
# demo driver (launch/serve.py --engine real)
# ======================================================================
def run_multiturn_demo(cfg, params, *, slots: int = 2, page_size: int = 8,
                       pages_per_seq: int = 9, num_pages: int = 11,
                       pcie_gb_s: float = 0.01, token_scale: int = 1,
                       seed: int = 0, fused_step: bool = True,
                       device="cuda", log=print) -> dict:
    """An end-to-end conversation on the real data plane, walking the
    whole interaction mechanism (the JAX package's script, whose sizes
    are the defaults here):

    1. alice's turn 1 prefills+decodes; her reply keeps playing.
    2. bob's heavy session *physically* evicts alice's suffix pages to
       the DRAM tier under pool pressure.
    3. alice speaks again — the pool is saturated, so the preloader's
       bounded-background-work guard skips; her turn 2 takes the
       synchronous on-path reload (stall reported, zero re-prefill) and
       is then barged-in mid-decode; turn 3 resumes on committed pages.
    4. alice hangs up (pages freed) — when bob's user speaks next, the
       speech-time preload is admitted and reloads his pages *during*
       the utterance: his turn 2 starts warm (zero stall, zero
       re-prefill).

    ``token_scale`` multiplies every prompt and reply length, so a pool
    of ``page_size = 8 * token_scale`` pages walks the same page counts;
    ``pcie_gb_s`` sets the modeled channel so a page's transfer time
    matches the script's. Returns per-turn stats for both sessions.
    """
    eng = PagedRealtimeEngine(cfg, params, slots=slots,
                              page_size=page_size,
                              pages_per_seq=pages_per_seq,
                              num_pages=num_pages, pcie_gb_s=pcie_gb_s,
                              device=device, fused_step=fused_step)
    rng = np.random.default_rng(seed)

    def n(tokens):
        return tokens * token_scale

    def prompt(tokens):
        return rng.integers(0, cfg.vocab_size, size=n(tokens))

    log(f"engine: {cfg.name} slots={slots} page={page_size} "
        f"pool={eng.num_pages} pages device={eng.device}")
    # ---- alice turn 1: admitted, decoded to completion -------------
    eng.add_session("alice", prompt(28), max_new_tokens=n(10))
    eng.run_to_completion()
    eng.monitor.on_audio("alice", 30.0)     # long reply still playing
    log(f"alice turn 1: kv_len={eng.sessions['alice'].kv_len} "
        f"pages={eng.pool.resident_pages('alice')}")

    # ---- pool pressure: bob's growth evicts alice's suffix ---------
    eng.add_session("bob", prompt(30), max_new_tokens=n(26))
    eng.run_to_completion()
    eng.monitor.on_audio("bob", 60.0)
    res, off = eng.monitor.page_counts("alice")
    log(f"bob served: alice pages resident={res} offloaded-to-DRAM={off} "
        f"(evictions so far: {len(eng.offload_events)})")

    # ---- alice speaks: saturated pool -> preload guard skips -------
    eng.user_speech_start("alice", expected_dur_s=2.0)
    eng.clock.tick(2.0)                     # the utterance itself
    log(f"alice speaks: preload admitted={eng.preloader.stats.admitted} "
        f"skipped={eng.preloader.stats.skipped} (pool saturated -> "
        f"sync fallback on turn start)")

    # ---- alice turn 2: on-path reload, zero re-prefill; barge-in ---
    eng.start_turn("alice", prompt(6), max_new_tokens=n(12))
    for _ in range(4):
        eng.step()
    eng.barge_in("alice", expected_dur_s=1.0)
    eng.clock.tick(1.0)

    # ---- alice turn 3 resumes on committed pages -------------------
    eng.start_turn("alice", prompt(5), max_new_tokens=n(6))
    eng.run_to_completion()
    eng.check_invariants()

    # ---- alice hangs up; bob speaks -> preload admitted ------------
    eng.end_session("alice")
    log(f"alice hung up: pool free={eng.pool.free_pages} pages; "
        f"bob offloaded={eng.monitor.page_counts('bob')[1]}")
    eng.user_speech_start("bob", expected_dur_s=2.5)
    eng.clock.tick(2.5)
    res, off = eng.monitor.page_counts("bob")
    log(f"bob speaks: preload admitted={eng.preloader.stats.admitted} "
        f"hits pending; resident={res} offloaded={off}")

    # ---- bob turn 2: warm KV, zero stall, zero re-prefill ----------
    eng.start_turn("bob", prompt(6), max_new_tokens=n(6))
    eng.run_to_completion()
    eng.check_invariants()

    all_stats = {}
    log("")
    log(f"{'session':>8} {'turn':>4} {'ctx':>5} {'prompt':>6} {'gen':>4} "
        f"{'ttft_ms':>8} {'reload_ms':>9} {'re_prefill':>10} {'aborted':>7}")
    for sid in ("alice", "bob"):
        stats = eng.sessions[sid].turn_stats
        all_stats[sid] = stats
        for t in stats:
            log(f"{sid:>8} {t['turn']:4d} {t['context_tokens']:5d} "
                f"{t['prompt_tokens']:6d} {t['generated']:4d} "
                f"{t['ttft_s'] * 1e3:8.1f} "
                f"{t['reload_stall_s'] * 1e3:9.3f} "
                f"{t['re_prefill_tokens']:10d} {str(t['aborted']):>7}")
    log("")
    log(f"preload: {eng.preloader.stats}")
    log(f"pool: {eng.pool.stats()}  evictions={len(eng.offload_events)}")
    return {"turns": all_stats,
            "preload": vars(eng.preloader.stats),
            "pool": eng.pool.stats(),
            "offload_events": len(eng.offload_events)}
