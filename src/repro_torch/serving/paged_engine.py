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

The three feature planes are the reference's, each with its twin
control:

- ``prefix_cache=True`` (DESIGN.md §13): a radix index over committed
  pages; a new session attaches to its prompt's longest cached prefix
  (refcounted shared pages) and prefills from the first uncached token.
  A write into a shared page first copies it (copy-on-write, one
  in-place ``index_copy_`` of the page across all layers).
- ``kv_quant="int8"`` (DESIGN.md §14): host copies travel and rest in
  the int8 block-quantized wire format (``kvcache/quant.py``).
- ``spec_decode=K`` (DESIGN.md §16, fused plane only): a decode slot
  feeds ``[pending, d_1..d_K]`` drafts from a proposer as one fused row;
  the verify step's per-position argmax accepts the longest matching
  prefix, so the committed stream is the greedy one.

``mesh=`` (a ``launch.mesh.ServingMesh``; DESIGN.md §9) shards the page
store over the mesh's 'model' axis by ``distributed.paged.PagedKVLayout``.
Every rank builds the engine with the same arguments and weights. Rank 0,
the leader, alone runs the control plane (pool, KV manager, scheduler,
any gateway in front): each device operation it performs (a step, an
offload gather, a reload scatter, a copy-on-write copy, a dense graft) it
first sends to the other ranks as one small command, and every rank then
runs it on its own shard. The other ranks run ``follow()`` until the
leader calls ``release_followers()``. Offload gathers a page's shards to
the leader and reload broadcasts the global chunk, so host copies (and
the int8 codec's scales) are the single-device engine's.

The cross-replica migration methods (``migrate_out_*``,
``migrate_in_adopt``; DESIGN.md §12) are the reference's; the one that
touches the device, the prefix plane's deep copy of shared pages in
``migrate_out_begin``, reads them through the device plane as an
offload chunk does.

Out of this slice (raising ``NotImplementedError`` naming its ROADMAP
item): the moe and vlm families.
"""
from __future__ import annotations

import hashlib
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
from repro_torch.core.transfer_engine import MIGRATE, TransferEngine
from repro_torch.device import resolve_device
from repro_torch.kernels import ref
from repro_torch.kernels.paged_attention import paged_attention, \
    paged_prefill_attention
from repro_torch.kvcache.paged import OutOfPages, PagedPool
from repro_torch.kvcache.prefix_cache import PrefixCache
from repro_torch.kvcache.quant import KVWireCodec
from repro_torch.models import layers as L
from repro_torch.models.model import _embed, _logits, _mlp_block, \
    init_cache, layer_params, prefill
from repro_torch.serving.block_tables import BatchTables, \
    FusedBatchTables, LayerStackedPages, assemble, assemble_fused
from repro_torch.serving.engine import RoundLimitExceeded, _StepClock, \
    schedule_round
from repro_torch.serving.spec_decode import build_proposer


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue 1 item {item})")


# ======================================================================
# data plane
# ======================================================================
def paged_decode_step(cfg, params, tokens, positions, k_pages, v_pages,
                      block_tables, seq_lens, write_page, write_slot,
                      *, plain: bool = False, plane=None):
    """One token per batch row through the paged KV store.

    tokens/positions [B] int; write_page/write_slot [B] int64;
    k_pages/v_pages [L, P+1, page, Hkv, hd], written in place;
    block_tables [B, pps] i32; seq_lens [B] i32 (post-write lengths).
    Returns logits [B, V] f32.

    ``plain`` (tests and the chip check only) attends through the
    kernel's plain version on any device, to hold the kernel's step
    against it; it is never a fallback.

    ``plane`` swaps the page write and attention: None is the
    single-device path; a ``distributed.paged.PagedKVLayout`` makes this
    one rank's step on its shard of the pages (DESIGN.md §9). Same body
    either way, so sharded and single-device engines cannot drift.
    """
    attend = ref.paged_attention_ref if plain else paged_attention
    x = _embed(cfg, params, tokens[:, None])
    pos = positions[:, None]                            # [B, 1]
    for i, lp in enumerate(layer_params(params)):
        h = L.rms_norm(x, lp["ln1"], cfg.rms_eps)
        q, k, v = L.attn_project_qkv(lp["attn"], cfg, h, pos)
        kc, vc = k_pages[i], v_pages[i]
        if plane is None:
            kc[write_page, write_slot] = k[:, 0]
            vc[write_page, write_slot] = v[:, 0]
            a = attend(q[:, 0].contiguous(), kc, vc, block_tables,
                       seq_lens)
        else:
            plane.write_token(kc, vc, k[:, 0], v[:, 0], write_page,
                              write_slot)
            a = plane.attend(q[:, 0].contiguous(), kc, vc, block_tables,
                             seq_lens)
        x = x + L.attn_output(lp["attn"], a[:, None])
        x = _mlp_block(cfg, lp, x)
    return _logits(cfg, params, x)[:, 0]


def paged_fused_step(cfg, params, tokens, positions, k_pages, v_pages,
                     block_tables, q_start, q_lens, write_pages,
                     write_slots, *, plain: bool = False,
                     spec: bool = False, plane=None):
    """One fused round: up to Q consecutive tokens per batch row in one
    pass over the layers.

    tokens/positions [B, Q] int; write_pages/write_slots [B, Q] int64;
    q_start/q_lens [B] i32 (first absolute position / valid tokens per
    row — 0 marks a padding row); k_pages/v_pages [L, P+1, page, Hkv,
    hd], written in place; block_tables [B, pps] i32. Returns the logits
    [B, V] f32 of each row's last valid token; with ``spec`` (the
    speculative verify variant, DESIGN.md §16) it returns ``(logits,
    outs)`` where ``outs`` [B, Q] int64 is the argmax after each
    position — fed tokens are ``[pending, d_1..d_m]``, so ``outs[b, j]
    == tokens[b, j+1]`` accepts draft j+1.

    Per layer the whole chunk's K/V is scattered into the pages first,
    then every query token attends causally over history + chunk prefix
    through ``paged_prefill_attention`` — so a PREFILL slot's C-token
    grant and every DECODE slot's single token share one step.
    ``plain`` and ``plane`` are as in ``paged_decode_step``.
    """
    attend = ref.paged_prefill_attention_ref if plain \
        else paged_prefill_attention
    x = _embed(cfg, params, tokens)                     # [B, Q, d]
    for i, lp in enumerate(layer_params(params)):
        h = L.rms_norm(x, lp["ln1"], cfg.rms_eps)
        q, k, v = L.attn_project_qkv(lp["attn"], cfg, h, positions)
        kc, vc = k_pages[i], v_pages[i]
        if plane is None:
            kc[write_pages, write_slots] = k
            vc[write_pages, write_slots] = v
            a = attend(q.contiguous(), kc, vc, block_tables, q_start,
                       q_lens)
        else:
            plane.write_chunk(kc, vc, k, v, write_pages, write_slots)
            a = plane.attend_chunk(q.contiguous(), kc, vc, block_tables,
                                   q_start, q_lens)
        x = x + L.attn_output(lp["attn"], a)
        x = _mlp_block(cfg, lp, x)
    last = (q_lens.long() - 1).clamp(min=0)
    rows = torch.arange(x.shape[0], device=x.device)
    if spec:
        # the verify step consumes every position's argmax, so the full
        # [B, Q, V] logits materialise here and the argmax runs on the
        # device; only outs and the last-valid rows cross to the host.
        # The [B*Q, d] unembed may round differently from the non-spec
        # [B, d] one (another product shape), never beyond float rounding
        full = _logits(cfg, params, x)                  # [B, Q, V]
        return full[rows, last], full.argmax(-1)
    # only each row's last valid token's logits are consumed; slice
    # before the unembed so the step never materialises [B, Q, V]
    return _logits(cfg, params, x[rows, last][:, None])[:, 0]


# the device operations, each a command a mesh's leader sends to every
# rank before running it on its own shard (``PagedRealtimeEngine._device``)
_OP_STOP, _OP_STEP, _OP_FUSED, _OP_OFFLOAD, _OP_RELOAD, _OP_COW, \
    _OP_DENSE = range(7)


def _weights_digest(params) -> int:
    """A 48-bit digest of a strided sample of every weight, to check that
    all ranks of a mesh hold the same weights."""
    h = hashlib.sha256()

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, (list, tuple)):
            for x in t:
                walk(x)
        else:
            flat = t.detach().reshape(-1)
            sample = flat[::max(1, flat.numel() // 4096)]
            h.update(sample.float().cpu().numpy().tobytes())
    walk(params)
    return int.from_bytes(h.digest()[:6], "little")


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
                 spec_decode: int = 0,
                 proposer=None):
        if cfg.family in ("moe", "vlm"):
            raise _not_ported(f"the {cfg.family} family", "6")
        assert cfg.family == "dense" and cfg.mla is None \
            and cfg.sliding_window is None, \
            "paged engine serves global-attention KV families"
        assert kv_policy in ("next_use", "lru"), \
            "the physical data plane needs an offload tier ('none' " \
            "discards pages; use the simulator for that baseline)"
        # KV wire format (DESIGN.md §14): int8 block-quantizes every host
        # copy on the offload path; fp32 is the bit-exact control
        self.codec = KVWireCodec(kv_quant)
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the engine on {self.device}")
        # the sharded page store (DESIGN.md §9): pages shard KV heads (or
        # page slots) over the mesh's 'model' axis; weights, tables and
        # the host control plane stay replicated
        self.mesh = mesh
        self.layout = None
        if mesh is not None:
            from repro_torch.distributed.paged import PagedKVLayout
            if mesh.device.type != self.device.type:
                raise ValueError(f"the mesh runs on {mesh.device}, the "
                                 f"engine on {self.device}")
            self.device = mesh.device
            self.layout = PagedKVLayout(cfg, mesh, page_size)
            if not mesh.agree(_weights_digest(params)):
                raise ValueError("the mesh's ranks hold different weights")
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
        if self.layout is not None:
            shape = self.layout.local_shape(shape)   # this rank's shard
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
        # speculative multi-token decode (DESIGN.md §16): a decode slot
        # feeds [pending, d_1..d_K] drafts as one fused row and the
        # verify step's per-position argmax accepts the longest
        # matching prefix — lossless by construction; spec_decode=0
        # keeps the one-token plane as the differential control
        assert spec_decode >= 0
        assert spec_decode == 0 or fused_step, \
            "spec_decode verifies drafts in one fused launch; it " \
            "cannot run on the per-token control plane " \
            "(fused_step=False)"
        self.spec_decode = int(spec_decode)
        self.proposer = None
        if self.spec_decode > 0:
            self.proposer = build_proposer(
                proposer if proposer is not None else "ngram")
        # prefill_chunk clamps to the self-scheduled round budget
        # (= slots*(1+K) tokens) exactly as the gateway clamps its own;
        # decode grants become "up to 1+K" draft budgets
        self.scheduler = scheduler or UrgencyScheduler(
            SchedulerConfig(), self.monitor, stage="thinker",
            kv_occupancy=self.kv.occupancy,
            prefill_chunk=max(1, slots),
            decode_chunk=1 + self.spec_decode)

        self.sessions: Dict[str, PagedSession] = {}
        self.slot_state: Dict[int, Optional[PagedSlot]] = {
            i: None for i in range(slots)}
        self._step_fn = paged_decode_step
        if self.layout is not None:
            from repro_torch.distributed.paged import make_sharded_step
            self._step_fn = make_sharded_step(self.layout)
        # the fused token-budget plane: one step per round, C-token
        # prefill chunks included. fused_step=False keeps the per-token
        # plane as the differential control. With speculation on, every
        # fused round runs the verify variant (prefill rows ignore the
        # per-position argmaxes).
        self.fused_step = fused_step
        self._fused_fn = paged_fused_step if fused_step else None
        if self.layout is not None and fused_step:
            from repro_torch.distributed import paged as dp
            self._fused_fn = (dp.make_sharded_spec_step if self.spec_decode
                              else dp.make_sharded_fused_step)(self.layout)
        # shared-prefix KV (DESIGN.md §13): a radix index over committed
        # pages + refcounted attach/COW in the pool; prefix_cache=False
        # keeps private pages as the differential twin
        self.prefix_cache = None
        if prefix_cache:
            self.prefix_cache = PrefixCache(page_size)
            self.kv.set_cache_hooks(reclaim=self._reclaim_cached,
                                    reclaimable=self._cached_reclaimable)
        self._pending_hit: Dict[str, int] = {}
        # telemetry
        self.reload_wall_s: List[float] = []   # measured host->device time
        self.offload_events: List[tuple] = []
        self.pressure_holds = 0                # feeds held mid-round
        self.fused_launches = 0                # fused-plane step launches
        self.peak_shared_pages = 0             # max pages with refcount>1
        self.cow_copies = 0                    # copy-on-write page copies
        # speculation accounting (accepted + rejected == drafted, always)
        self.spec_drafted = 0                  # draft tokens verified
        self.spec_accepted = 0                 # drafts matching argmax
        self.spec_rejected = 0                 # drafts rolled back
        self.spec_rounds = 0                   # verify rows with drafts
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
            if self.prefix_cache is not None:
                # about to leave HBM: forget these pages (and their
                # unreachable subtrees) in the radix index first — the
                # never-offload-shared rule is then an assert, not a
                # hope (rc>1 pages were excluded by evictable_suffix)
                seq = self.pool.seq(sid)
                self._forget_cached([seq.pages[li] for li in offload_lis])
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
        to the device (and, on a mesh, broadcast to every rank) and only
        that is timed for the wall-time measurement; the pool then
        scatters it in place, each rank its shard."""
        s = self.pool.seq(sid)
        host = torch.stack([self.codec.decode(s.offloaded[li])
                            for li in lis])
        if self._pinned:
            host = host.pin_memory()
        t0 = time.perf_counter()
        staged = self._stage(host)
        if self.mesh is not None:
            self.mesh.send(_OP_RELOAD, [[s.pages[li] for li in lis]])
            self.mesh.broadcast(staged)
        self.reload_wall_s.append(time.perf_counter() - t0)
        self.pool.complete_reload(sid, lis, self._store(), staged=staged)
        self._sync_page_counts(sid)

    def _io_offload_chunk(self, sid: str, lis: List[int]) -> None:
        """Physically land one offload chunk: gather the device pages
        to host copies (``[2, L, page, Hkv, hd]`` per page, in the
        store's dtype, so bf16 round-trips bit for bit), then free the
        slots (copy-then-free step 2)."""
        s = self.pool.seq(sid)
        host = self._device(_OP_OFFLOAD, [s.pages[li] for li in lis])
        self.pool.complete_offload(
            sid, {li: self.codec.encode(host[i])
                  for i, li in enumerate(lis)})
        self._sync_page_counts(sid)

    # ---------------------------------------------------- device plane
    # Every touch of the page store is one of the operations below. On
    # a mesh the leader sends each to the other ranks first (``_device``)
    # and every rank runs it on its shard; the follower ranks loop in
    # ``follow``. The arguments are host integer arrays, so the command
    # carries them as they are.
    def _device(self, op: int, *arrays):
        if self.mesh is not None:
            assert self.mesh.is_leader, "only the leader sends operations"
            self.mesh.send(op, arrays)
        return self._run_op(op, arrays)

    def _run_op(self, op: int, arrays):
        run = {_OP_STEP: self._op_step, _OP_FUSED: self._op_fused,
               _OP_OFFLOAD: self._op_offload, _OP_RELOAD: self._op_reload,
               _OP_COW: self._op_cow, _OP_DENSE: self._op_dense}[op]
        return run(*arrays)

    def follow(self) -> None:
        """A follower rank's loop: run the leader's device operations on
        this rank's shard of the pages until ``release_followers``."""
        assert self.mesh is not None and not self.mesh.is_leader, \
            "only a mesh's follower ranks follow"
        while True:
            op, arrays = self.mesh.recv()
            if op == _OP_STOP:
                return
            self._run_op(op, arrays)

    def release_followers(self) -> None:
        """The leader is done: every follower's ``follow`` returns."""
        if self.mesh is not None and self.mesh.is_leader:
            self.mesh.send(_OP_STOP, [])

    def _store(self) -> LayerStackedPages:
        return LayerStackedPages(self.k_pages, self.v_pages, self.layout)

    def _step(self, tokens: np.ndarray, tabs: BatchTables) -> torch.Tensor:
        """One per-token step of the fixed batch; logits [B, V]."""
        return self._device(_OP_STEP, tokens, tabs.positions,
                            tabs.block_tables, tabs.seq_lens,
                            tabs.write_page, tabs.write_slot)

    def _fused(self, tokens: np.ndarray, tabs: FusedBatchTables):
        """One fused round of the fixed batch: the step's output."""
        return self._device(_OP_FUSED, tokens, tabs.positions,
                            tabs.block_tables, tabs.q_start, tabs.q_lens,
                            tabs.write_pages, tabs.write_slots)

    def _op_step(self, tokens, positions, tables, seq_lens, page, slot):
        i32, i64 = torch.int32, torch.int64
        return self._step_fn(
            self.cfg, self.params, self._tensor(tokens, i64),
            self._tensor(positions, i32), self.k_pages, self.v_pages,
            self._tensor(tables, i32), self._tensor(seq_lens, i32),
            self._tensor(page, i64), self._tensor(slot, i64))

    def _op_fused(self, tokens, positions, tables, q_start, q_lens, pages,
                  slots):
        i32, i64 = torch.int32, torch.int64
        return self._fused_fn(
            self.cfg, self.params, self._tensor(tokens, i64),
            self._tensor(positions, i32), self.k_pages, self.v_pages,
            self._tensor(tables, i32), self._tensor(q_start, i32),
            self._tensor(q_lens, i32), self._tensor(pages, i64),
            self._tensor(slots, i64), spec=self.spec_decode > 0)

    def _op_offload(self, phys):
        """Gather pages ``phys`` to the host as [n, 2, L, page, Hkv, hd]
        (the leader's result; a follower only adds its shard)."""
        idx = self._tensor(phys, torch.int64)
        dev = torch.stack([self.k_pages.index_select(1, idx),
                           self.v_pages.index_select(1, idx)]) \
            .movedim(2, 0)                      # [n, 2, L, page, Hkv, hd]
        if self.layout is not None:
            dev = self.layout.unshard(dev)
            if not self.mesh.is_leader:
                return None
        host = torch.empty(dev.shape, dtype=dev.dtype,
                           pin_memory=self._pinned)
        host.copy_(dev)               # blocking: the copies are durable
        return host

    def _op_reload(self, phys):
        """A follower's side of ``_io_reload_chunk``: receive the global
        chunk and scatter its shard into pages ``phys``."""
        chunk = torch.empty((len(phys), 2, self.cfg.num_layers,
                             self.page_size, self.cfg.num_kv_heads,
                             self.cfg.resolved_head_dim),
                            dtype=self.k_pages.dtype, device=self.device)
        self.mesh.broadcast(chunk)
        self._store().write(phys, chunk)

    def _op_cow(self, pair):
        """Copy page ``pair[0]`` to page ``pair[1]`` across all layers,
        in place: the steps write through ``k_pages[i]`` views of this
        one store, so it is never rebound."""
        old, new = (int(x) for x in pair)
        dst = torch.tensor([new], dtype=torch.int64, device=self.device)
        self.k_pages.index_copy_(1, dst, self.k_pages[:, old:old + 1])
        self.v_pages.index_copy_(1, dst, self.v_pages[:, old:old + 1])

    def _op_dense(self, prompt, phys):
        """The dense turn-0 prefill of ``prompt`` (replicated on every
        rank) grafted into pages ``phys``; logits [1, V]."""
        npages = len(phys)
        c1 = init_cache(self.cfg, 1, npages * self.page_size, self.device)
        logits, c1 = prefill(self.cfg, self.params,
                             self._tensor(prompt, torch.int64)[None, :], c1)
        shape = (self.cfg.num_layers, npages, self.page_size,
                 *c1["k"].shape[3:])
        k, v = c1["k"][:, 0].reshape(shape), c1["v"][:, 0].reshape(shape)
        if self.layout is not None:
            k, v = self.layout.shard(k), self.layout.shard(v)
        idx = self._tensor(phys, torch.int64)
        self.k_pages.index_copy_(1, idx, k)
        self.v_pages.index_copy_(1, idx, v)
        return logits

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

    # ---------------------------------------------------- shared prefix
    # (DESIGN.md §13.) The radix cache holds NON-refcount references:
    # registering marks pages `cache_held` in the pool without touching
    # refcounts, so `sum(refcounts) == live block-table references`
    # stays the conservation invariant. Charging: every allocated page
    # bills exactly one accountant — its owner session (kv.hbm_blocks)
    # or, once the owner released/COW'd it away, the prefix cache
    # (kv.cached_blocks, pool.page_owner[p] is None).

    def _refresh_shared_pins(self) -> None:
        """Recompute every session's shared-pinned block count (own
        resident pages some other session references — never
        offloadable) after any refcount 1<->2+ transition. Sessions per
        engine are few; recomputing all of them keeps every call site
        trivially correct."""
        if self.prefix_cache is None:
            return
        for sid, kvs in self.kv.sessions.items():
            kvs.shared_pinned_blocks = self.pool.shared_charged_pages(sid)
        self.peak_shared_pages = max(self.peak_shared_pages,
                                     self.pool.shared_pages())

    def _attach_prefix(self, sess: PagedSession,
                       prompt: np.ndarray) -> np.ndarray:
        """Session birth: walk the radix index for the prompt's longest
        cached prefix and attach to it — the block table points at the
        shared pages, kv_len skips ahead, and prefill starts at the
        first uncached token (the fused kernel's per-row q_start
        renders from any offset; no kernel math changes). Returns the
        remaining (uncached) prompt."""
        if self.prefix_cache is None or sess.kv_len > 0:
            return prompt
        sid = sess.session_id
        matched, phys = self.prefix_cache.lookup(prompt)
        # the last prompt token always prefills: its logits are the
        # turn's first output token
        matched = min(matched, int(prompt.shape[0]) - 1)
        if matched <= 0:
            return prompt
        n_phys = self.pool.pages_for(matched)
        self.pool.attach_prefix(sid, phys[:n_phys], matched)
        sess.kv_len = matched
        sess.token_ids = [int(t) for t in prompt[:matched]]
        kvs = self.kv.session(sid)
        kvs.total_blocks = n_phys
        kvs.shared_blocks = n_phys      # charged to owners / the cache
        kvs.hbm_blocks = 0
        self._pending_hit[sid] = matched
        self.prefix_cache.hits += 1
        self.prefix_cache.hit_tokens += matched
        self._refresh_shared_pins()
        self._sync_page_counts(sid)
        return prompt[matched:]

    def _ensure_writable(self, sid: str) -> None:
        """Copy-on-write before a write lands: the next token's target
        page may be shared (an attached partial tail, or this session's
        own committed tail another session attached to). Allocate a
        private copy, repoint, copy the bytes. Only the FIRST page of a
        write region can be shared — everything past it is freshly
        allocated. Raises OutOfPages recoverably (same contract as
        _grow). The callers run it before the round's block tables are
        assembled, so the round's writes and reads see the new page."""
        if self.prefix_cache is None:
            return
        sess = self.sessions[sid]
        s = self.pool.seqs.get(sid)
        if s is None:
            return
        li = sess.kv_len // self.page_size
        if li >= len(s.pages):
            return
        phys = s.pages[li]
        if phys < 0 or self.pool.refcount[phys] <= 1:
            return
        now = self.clock.now()
        if not self.kv.try_allocate_working(1, now):
            raise OutOfPages(f"{sid}: no page free for copy-on-write")
        self._demand_free_pages(1)
        old, new, was_owner = self.pool.cow(sid, li)
        self.kv.release_working(1)
        kvs = self.kv.session(sid)
        if was_owner:
            # the old page stays for its sharers, now charged to the
            # cache; our new private copy replaces it 1:1 in hbm
            self.kv.cached_blocks += 1
        else:
            # an attached page became a private one
            kvs.shared_blocks -= 1
            kvs.hbm_blocks += 1
        self._device(_OP_COW, [old, new])
        self.cow_copies += 1
        self._refresh_shared_pins()

    def _register_prefix(self, sid: str) -> None:
        """Turn close: index the session's committed chain — full pages
        as interior radix nodes, the partially-filled tail as this
        node's partial child. Newly indexed pages become `cache_held`
        (kept allocated even at refcount 0 until forgotten/reclaimed);
        charging is unchanged — this session still owns them."""
        sess = self.sessions[sid]
        s = self.pool.seqs.get(sid)
        if s is None or sess.kv_len <= 0:
            return
        assert len(sess.token_ids) == sess.kv_len, \
            f"{sid}: token history {len(sess.token_ids)} != " \
            f"kv_len {sess.kv_len}"
        now = self.clock.now()
        newly = self.prefix_cache.register(
            sess.token_ids, s.pages,
            est=self.kv.next_use_estimate(sid, now),
            protect=self.kv.session(sid).protected_until)
        self.pool.cache_held.update(newly)

    def _forget_cached(self, phys: List[int]) -> None:
        """Drop pages (and their now-unreachable radix subtrees) from
        the index before they offload; orphans whose last reference was
        the index free immediately."""
        dropped = self.prefix_cache.forget_phys(phys)
        self.kv.cached_blocks -= self.pool.cache_release(dropped)

    def _reclaim_cached(self, n: int, now: float) -> int:
        """KVManager cache hook: free up to n orphaned cached pages
        (leaves-first, farthest banked next-use first). Returns blocks
        freed; the manager adjusts cached_blocks."""
        phys = self.prefix_cache.reclaim(n, now, self.pool.refcount)
        freed = self.pool.cache_release(phys)
        assert freed == len(phys), (phys, freed)
        return freed

    def _cached_reclaimable(self, now: float) -> int:
        return self.prefix_cache.reclaimable(now, self.pool.refcount)

    def _bank_detach(self, sid: str, now: float) -> None:
        """A sharer is leaving (hangup): bank its Eq.4 next-use
        estimate and protection TTL on every indexed/shared page it
        references — reclaim order for the eventual orphans is
        min-over-sharers next-use (last detacher wins) with protection
        extended to the max over sharers' TTLs."""
        s = self.pool.seqs.get(sid)
        if s is None:
            return
        held = [p for p in s.pages
                if p >= 0 and (p in self.pool.cache_held
                               or self.pool.refcount[p] > 1)]
        if held:
            self.prefix_cache.on_detach(
                held, est=self.kv.next_use_estimate(sid, now),
                protect=self.kv.session(sid).protected_until)

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
        prompt = self._attach_prefix(sess, np.asarray(prompt, np.int32))
        return self._begin_turn(sess, prompt, max_new_tokens, first=True)

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
            prompt = self._attach_prefix(sess, prompt)
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
        req.prefix_hit_tokens = self._pending_hit.pop(sid, 0)
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
        self._ensure_writable(sid)
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
        logits = self._device(_OP_DENSE, prompt,
                              self.pool.seq(sid).pages[:npages])
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
                    np.asarray(prompt, np.int32))})[0][slot]
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
        if self.prefix_cache is not None:
            self._bank_detach(session_id, self.clock.now())
        rep = self.pool.release(session_id)
        if self.prefix_cache is not None:
            # own pages surviving via sharers/the index re-charge to
            # the cache; cache-charged pages whose last reference died
            # here freed with the release
            self.kv.cached_blocks += rep["orphaned"]
            self.kv.cached_blocks -= rep["freed_orphan"]
        self.kv.release_session(session_id)
        if self.prefix_cache is not None:
            self._refresh_shared_pins()
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

    # --------------------------------------------------------- migration
    # Cross-replica migration (serving/fleet, DESIGN.md §12) rides the
    # same chunked ledger as eviction/preload: the source queues its
    # whole committed context as MIGRATE-tagged copy-then-free offload
    # chunks (drained across rounds while the user is still speaking),
    # and once everything is host-resident the session state transplants
    # wholesale to the destination engine, which pages it back in with
    # the ordinary speech-time preload machinery — so the on-path vs
    # off-path split of migration bytes needs no new accounting.

    def migrate_out_begin(self, session_id: str) -> int:
        """Queue the session's entire device-resident KV for host
        offload (copy-then-free, MIGRATE-tagged). The session must be
        idle (no live slot); any in-flight speech-time preload is
        cancelled first — its pages are about to leave this replica.
        Returns the number of pages queued for offload now (pages
        already offloaded or already offloading are not re-queued)."""
        sid = session_id
        sess = self.sessions[sid]
        assert not sess.ended, f"{sid} ended; nothing to migrate"
        assert all(s is None or s.session_id != sid
                   for s in self.slot_state.values()), \
            f"{sid}: migration requires an idle session (no live slot)"
        now = self.clock.now()
        self.preloader.cancel(sid, now)
        self.kv.cancel_reload(sid, now)
        s = self.pool.seq(sid)
        kvs = self.kv.session(sid)
        deep_copied = 0
        if self.prefix_cache is not None:
            # Shared pages cannot ride the copy-then-free ledger (their
            # slot must NOT free — sharers still need it hot). Private
            # pages the index holds are forgotten (plain again); truly
            # shared pages deep-copy to host synchronously and the
            # departing session drops its reference — the destination
            # re-resolves against its own radix index on later turns.
            self._forget_cached(
                [p for p in s.pages
                 if p >= 0 and self.pool.refcount[p] == 1
                 and p in self.pool.cache_held
                 and self.pool.page_owner[p] == sid])
            shared_lis = [li for li, p in enumerate(s.pages)
                          if p >= 0 and (self.pool.refcount[p] > 1
                                         or self.pool.page_owner[p] != sid)]
            if shared_lis:
                self._bank_detach(sid, now)
                for li in shared_lis:
                    # through the device plane, as an offload chunk is:
                    # a bf16 page round-trips bit for bit and a mesh
                    # gathers its shards
                    host = self._device(_OP_OFFLOAD, [s.pages[li]])
                    was_owner, freed = self.pool.detach_page(sid, li)
                    s.offloaded[li] = self.codec.encode(host[0])
                    if was_owner:
                        # stays for its sharers, cache-charged now
                        kvs.hbm_blocks -= 1
                        self.kv.cached_blocks += 1
                    else:
                        kvs.shared_blocks -= 1
                        if freed:
                            # last reference to an orphan: the cache
                            # was paying and the slot just freed
                            self.kv.cached_blocks -= 1
                deep_copied = len(shared_lis)
                self._refresh_shared_pins()
                self._sync_page_counts(sid)
        lis = [li for li, p in enumerate(s.pages)
               if p >= 0 and li not in s.loading and li not in s.offloading]
        assert not s.loading and kvs.hbm_blocks == len(lis), \
            f"{sid}: accounting ({kvs.hbm_blocks}) disagrees with " \
            f"resident pages ({len(lis)}) at migrate-out"
        if lis:
            self.pool.mark_offloading(sid, lis)
            self.transfer.submit_offload(sid, lis, tag=MIGRATE)
            # accounting mirrors the eviction hook: the blocks leave
            # this replica's HBM budget now; copy-then-free keeps the
            # physical slots (and their usability) until chunks drain
            kvs.hbm_blocks = 0
            self._sync_page_counts(sid)
        return len(lis) + deep_copied

    def migrate_out_pending(self, session_id: str) -> int:
        """Pages still queued on the source's offload ledger."""
        return self.transfer.pending_offload_pages(session_id)

    def migrate_out_cancel(self, session_id: str) -> int:
        """Abandon a not-yet-handed-off migration zero-copy: queued
        offload chunks drop from the ledger and their pages stay
        resident (the bytes never left HBM — the same copy-then-free
        win as a reload racing an eviction). Pages whose chunks already
        drained stay host-resident; the session's next turn on *this*
        replica reloads them through the normal path. Returns pages
        restored to resident."""
        sid = session_id
        dropped = self.transfer.cancel_offload_pages(sid)
        restored = self.pool.cancel_offloading(sid)
        assert len(restored) == dropped, (sid, restored, dropped)
        if dropped:
            self.kv.session(sid).hbm_blocks += dropped
            self._sync_page_counts(sid)
        return dropped

    def migrate_out_finalize(self, session_id: str) -> dict:
        """Every page is host-resident: detach the session wholesale —
        PagedSession (history, turn stats), monitor view (reply-gap
        EMA, expected speech end), host page copies — and scrub every
        source-side table, exactly like a hangup except the state moves
        instead of dying. The returned dict feeds ``migrate_in_adopt``
        on the destination engine."""
        sid = session_id
        s = self.pool.seqs[sid]
        assert self.transfer.pending_offload_pages(sid) == 0 \
            and not s.offloading and not s.loading \
            and all(p == -1 for p in s.pages), \
            f"{sid}: migrate-out finalize before all chunks drained"
        state = {
            "session": self.sessions.pop(sid),
            "view": self.monitor.forget(sid),
            "n_pages": len(s.pages),
            "length": s.length,
            "host": dict(s.offloaded),
        }
        self.transfer.cancel_session(sid)     # clears split accumulators
        self.preloader.forget_session(sid)
        self.pool.release(sid)
        self.kv.release_session(sid)
        return state

    def migrate_in_adopt(self, session_id: str, state: dict) -> None:
        """Install a migrated session: pool entry fully host-resident
        (``pages[li] == -1`` everywhere), KV accounting with zero HBM
        blocks, interaction view transplanted so Eq. 4 and the preload
        window keep their learned state. The caller then fires
        ``preloader.on_speech_start`` so the page-in rides the remaining
        speech window like any preload (admission-checked, chunked,
        cancellable, OutOfPages-recoverable at turn start)."""
        sid = session_id
        assert sid not in self.sessions, f"{sid} already on this replica"
        self.sessions[sid] = state["session"]
        if state["view"] is not None:
            self.monitor.adopt(sid, state["view"])
        else:
            self.monitor.register(sid)
        self.pool.adopt(sid, state["n_pages"], state["length"],
                        state["host"])
        kvs = self.kv.session(sid)
        kvs.total_blocks = state["n_pages"]
        kvs.hbm_blocks = 0
        kvs.last_access = self.clock.now()
        self._sync_page_counts(sid)

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
            self.slots * (1 + self.spec_decode),
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
                toks = [s.pending_token]
                if self.spec_decode > 0:
                    # the grant is an "up to 1+K" draft budget: the
                    # proposer fills as much of it as it can guess,
                    # capped so accepted tokens can never overshoot the
                    # turn's generation cap (frontier/cap accounting
                    # counts accepted tokens only)
                    m = min(self.spec_decode, c - 1,
                            r.max_new_tokens - r.generated - 1)
                    if m > 0:
                        if hasattr(self.proposer, "session_id"):
                            self.proposer.session_id = s.session_id
                        hist = self.sessions[s.session_id].token_ids \
                            + [s.pending_token]
                        toks += [int(t) for t in
                                 self.proposer.propose(hist, m)[:m]]
                feeds[i] = (s.session_id, np.asarray(toks, np.int32))
        for i in list(feeds):
            sid, toks = feeds[i]
            sess = self.sessions[sid]
            try:
                self._grow(sid, sess.kv_len + len(toks))
                self._ensure_writable(sid)   # COW a shared write target
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
            out, outs = self._run_chunk_rows(feeds)
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
                # decode: without speculation the row fed exactly
                # [pending] and emits its one argmax; with it the row
                # fed [pending, d_1..d_m] and the verify step's
                # per-position argmaxes accept the longest matching
                # draft prefix (the committed stream is exactly the
                # greedy one)
                if outs is None:
                    accepted, emit = 0, [int(np.argmax(out[i]))]
                else:
                    row = outs[i]
                    accepted = 0
                    while accepted < n - 1 \
                            and int(toks[accepted + 1]) \
                            == int(row[accepted]):
                        accepted += 1
                    emit = [int(row[j]) for j in range(accepted + 1)]
                    if n > 1:
                        self.spec_rounds += 1
                        self.spec_drafted += n - 1
                        self.spec_accepted += accepted
                        self.spec_rejected += (n - 1) - accepted
                # commit pending + accepted drafts; rejected KV rolls
                # back (length clamp — pages stay owned, the garbage
                # slots are never attended and are overwritten before
                # any future attend; _close_turn's trim reclaims)
                sess.kv_len += 1 + accepted
                sess.token_ids += [int(t) for t in toks[:1 + accepted]]
                if 1 + accepted < n:
                    self.pool.rollback(sid, sess.kv_len)
                for tok in emit:
                    r.generated += 1
                    s.pending_token = tok
                    if r.generated < r.max_new_tokens:
                        s.tokens.append(tok)
                        events[i].append(("token", tok))
                    else:
                        r.state = RequestState.FINISHED
                        self._close_turn(i, aborted=False)
                        events[i].append(("finished", r.generated))
                        break
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
                    self._ensure_writable(s.session_id)
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

    def _tensor(self, a, dtype) -> torch.Tensor:
        """One host array of the round's tables to the device."""
        return torch.from_numpy(np.ascontiguousarray(a)) \
            .to(self.device, dtype)

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
        logits = self._step(tokens, tabs).cpu().numpy()
        if self.logit_tap is not None:
            for i, (sid, _) in feeds.items():
                self.logit_tap(sid, logits[i])
        return {i: logits[i] for i in feeds}

    def _run_chunk_rows(self, feeds: Dict[int, tuple]) -> tuple:
        """Run one fused step with ``feeds[row] = (sid, tokens)`` — up
        to Q consecutive tokens per row, padded (rows and token slots
        alike) onto the scratch page. Returns ``(logits, outs)``: each
        row's last valid token's logits, plus each row's per-position
        argmaxes when the engine runs the speculative verify variant
        (None on the non-spec plane)."""
        q_tokens = _q_bucket(max(len(t) for _, t in feeds.values()))
        rows: List[Optional[tuple]] = [None] * self.slots
        tokens = np.zeros((self.slots, q_tokens), np.int64)
        for i, (sid, toks) in feeds.items():
            rows[i] = (sid, self.sessions[sid].kv_len, len(toks))
            tokens[i, :len(toks)] = toks
        tabs: FusedBatchTables = assemble_fused(
            self.pool, rows, q_tokens, self.pages_per_seq,
            self.scratch_page)
        out = self._fused(tokens, tabs)
        out_rows = None
        if self.spec_decode > 0:
            logits, outs = out
            outs = outs.cpu().numpy()
            out_rows = {i: outs[i] for i in feeds}
        else:
            logits = out
        self.fused_launches += 1
        logits = logits.cpu().numpy()
        if self.logit_tap is not None:
            for i, (sid, _) in feeds.items():
                self.logit_tap(sid, logits[i])
        return {i: logits[i] for i in feeds}, out_rows

    def _close_turn(self, slot: int, *, aborted: bool) -> None:
        s = self.slot_state[slot]
        sid = s.session_id
        sess = self.sessions[sid]
        now = self.clock.now()
        trimmed = self.pool.trim(sid, sess.kv_len)   # in-flight lookahead
        grown = len(self.pool.seq(sid).pages) - sess.base_pages
        self.kv.release_working(grown + trimmed)
        self.kv.commit_turn(sid, sess.kv_len, now)
        if self.prefix_cache is not None:
            self._register_prefix(sid)
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
        shape = (self.cfg.num_layers, self.num_pages + 1, self.page_size,
                 self.cfg.num_kv_heads, self.cfg.resolved_head_dim)
        if self.layout is not None:
            shape = self.layout.local_shape(shape)
        assert tuple(self.k_pages.shape) == shape \
            and tuple(self.v_pages.shape) == shape, \
            f"page store {tuple(self.k_pages.shape)} is not {shape}"
        # refcount conservation: every allocated page's refcount equals
        # its live block-table references, and zero-ref pages are
        # exactly the orphans the radix index holds
        refs = Counter(p for s in self.pool.seqs.values()
                       for p in s.pages if p >= 0)
        for p, c in self.pool.refcount.items():
            assert refs.get(p, 0) == c, \
                f"page {p}: refcount {c} != {refs.get(p, 0)} references"
            if c == 0:
                assert p in self.pool.cache_held, \
                    f"page {p}: zero refs and not cache-held — leaked"
        allocated = set(self.pool.refcount)
        assert set(refs).issubset(allocated)
        assert allocated.isdisjoint(self.pool.free), "free+allocated page"
        assert len(allocated) + self.pool.free_pages == self.num_pages
        assert self.pool.cache_held.issubset(allocated)
        if self.prefix_cache is not None:
            assert set(self.prefix_cache.by_phys) == self.pool.cache_held
            assert self.kv.cached_blocks == sum(
                1 for p in allocated
                if self.pool.page_owner[p] is None), \
                f"cached_blocks {self.kv.cached_blocks} != owner-less pages"
            for sid in self.pool.seqs:
                kvs = self.kv.sessions.get(sid)
                if kvs is not None:
                    assert kvs.shared_pinned_blocks == \
                        self.pool.shared_charged_pages(sid), \
                        f"{sid}: stale shared-pin count"
        else:
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
                       device="cuda", mesh=None, log=print) -> dict:
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
    With ``mesh`` every rank calls this: the leader runs the script on
    the sharded engine, the other ranks follow it and return None.
    """
    eng = PagedRealtimeEngine(cfg, params, slots=slots,
                              page_size=page_size,
                              pages_per_seq=pages_per_seq,
                              num_pages=num_pages, pcie_gb_s=pcie_gb_s,
                              device=device, fused_step=fused_step,
                              mesh=mesh)
    if mesh is not None and not mesh.is_leader:
        eng.follow()
        return None
    try:
        return _demo_script(eng, cfg, token_scale, seed, log)
    finally:
        eng.release_followers()


def _demo_script(eng, cfg, token_scale: int, seed: int, log) -> dict:
    slots, page_size = eng.slots, eng.page_size
    rng = np.random.default_rng(seed)

    def n(tokens):
        return tokens * token_scale

    def prompt(tokens):
        return rng.integers(0, cfg.vocab_size, size=n(tokens))

    log(f"engine: {cfg.name} slots={slots} page={page_size} "
        f"pool={eng.num_pages} pages device={eng.device}"
        + (f" layout={eng.layout}" if eng.layout else ""))
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
