"""Host-side paged KV block pool — the allocator under the
paged-attention kernels and the LiveServe KV manager.

The pool owns fixed-size pages of device KV storage
([num_pages, page_size, Hkv, hd] per layer); sequences own ordered page
lists (prefix-first, matching §5.1's suffix-first eviction). Block tables
([B, pages_per_seq] int32) are built per decode batch and handed to the
kernels. A DRAM tier holds offloaded page *contents* (host copies in the
store's own dtype) so evict/reload round-trips are bit-exact.

This is hardware-agnostic bookkeeping: the LiveServe policies decide
*which* sessions' pages move; this module moves them.

It is also *layout*-agnostic: physical page ids and the block tables
built from them never index the device store's inner dims (KV heads or
page slots). ``offload_suffix`` reads ``kv_pages[phys]`` and
``complete_reload`` writes ``kv_pages.at[phys].set(...)`` through
whatever store adapter the engine hands in (the port's
``serving.block_tables.LayerStackedPages`` writes in place on the
device).

Shared-prefix pages (DESIGN.md §13): every allocated physical page
carries a refcount — the number of sequences whose page list references
it. ``attach_prefix`` points a fresh sequence at another sequence's
committed pages (refcount goes up, no bytes move); ``cow`` swaps a
shared page for a private copy when a writer must append into it. Each
page is *charged* to exactly one accountant: its owner session
(``page_owner[p] == sid``) or the prefix cache (``page_owner[p] is
None`` — a COW'd-away or orphaned page kept alive by sharers or by the
radix index, ``cache_held``). The transfer tiers only ever move private
pages: ``mark_offloading`` asserts refcount == 1 and not cache-held, so
a page some sharer still needs hot can never leave HBM.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


class OutOfPages(RuntimeError):
    pass


@dataclass
class SeqPages:
    seq_id: str
    pages: List[int] = field(default_factory=list)   # prefix-first order
    length: int = 0                                   # tokens written
    offloaded: Dict[int, object] = field(default_factory=dict)
    # offloaded: logical page index (position in `pages`) -> host copy
    # (whatever the wire codec made of it — opaque here); an offloaded
    # slot keeps -1 in `pages`.
    #
    # In-flight transfer marks (the async chunked transfer engine,
    # DESIGN.md §10). Each logical page is in exactly one state:
    #   resident    pages[li] >= 0, li not in loading/offloading
    #   offloading  pages[li] >= 0, li in offloading — device contents
    #               still valid/usable; host copy not yet durable
    #               (copy-then-free: the slot frees when the chunk
    #               drains)
    #   loading     pages[li] >= 0 (slot reserved), li in loading AND
    #               li in offloaded — host copy is the source of truth,
    #               device contents not yet arrived
    #   offloaded   pages[li] == -1, li in offloaded only
    loading: set = field(default_factory=set)
    offloading: set = field(default_factory=set)


class PagedPool:
    def __init__(self, num_pages: int, page_size: int, codec=None):
        self.num_pages = num_pages
        self.page_size = page_size
        # KV wire codec (DESIGN.md §14): when set, the synchronous
        # offload wrapper encodes host copies (int8 payload + fp32
        # block scales) and every reload path decodes them. Host-store
        # entries are otherwise opaque — the page-state machine,
        # conservation checks, and migration handoff never look inside.
        self.codec = codec
        self.free: List[int] = list(range(num_pages - 1, -1, -1))
        self.seqs: Dict[str, SeqPages] = {}
        # Shared-prefix bookkeeping (DESIGN.md §13). Every *allocated*
        # physical page has a refcount entry (== number of sequence page
        # lists referencing it; 0 only for pages kept alive purely by
        # the radix index) and a charging owner: the session whose KV
        # accountant pays for it, or None once the owner released/COW'd
        # it away (the prefix cache pays — `cached_blocks` in
        # KVManager). `cache_held` marks pages registered in the radix
        # index: they survive refcount 0 until the cache forgets them.
        self.refcount: Dict[int, int] = {}
        self.page_owner: Dict[int, Optional[str]] = {}
        self.cache_held: set = set()

    # ------------------------------------------------------------ alloc
    @property
    def free_pages(self) -> int:
        return len(self.free)

    def _alloc_page(self, seq_id: str) -> int:
        p = self.free.pop()
        self.refcount[p] = 1
        self.page_owner[p] = seq_id
        return p

    def _free_slot(self, p: int) -> None:
        del self.refcount[p]
        del self.page_owner[p]
        self.free.append(p)

    def seq(self, seq_id: str) -> SeqPages:
        s = self.seqs.get(seq_id)
        if s is None:
            s = SeqPages(seq_id)
            self.seqs[seq_id] = s
        return s

    def pages_for(self, tokens: int) -> int:
        return -(-tokens // self.page_size)

    def ensure_capacity(self, seq_id: str, new_length: int) -> List[int]:
        """Grow a sequence to hold new_length tokens; returns newly
        allocated physical pages."""
        s = self.seq(seq_id)
        need = self.pages_for(new_length) - len(s.pages)
        out = []
        for _ in range(max(0, need)):
            if not self.free:
                raise OutOfPages(f"pool exhausted growing {seq_id}")
            p = self._alloc_page(seq_id)
            s.pages.append(p)
            out.append(p)
        s.length = max(s.length, new_length)
        return out

    def trim(self, seq_id: str, length: int) -> int:
        """Shrink a sequence's page list to what `length` tokens need,
        freeing trailing pages (in-flight lookahead pages on barge-in,
        §5.2 — committed pages are untouched). Returns pages freed."""
        s = self.seq(seq_id)
        keep = self.pages_for(length)
        freed = 0
        while len(s.pages) > keep:
            li = len(s.pages) - 1
            assert li not in s.loading and li not in s.offloading, \
                f"{seq_id}: trim would drop page {li} mid-transfer " \
                "(transfers run only for idle sessions; trim only on " \
                "the live turn's lookahead)"
            phys = s.pages.pop()
            s.offloaded.pop(len(s.pages), None)
            if phys >= 0:
                assert self.refcount[phys] == 1 \
                    and phys not in self.cache_held \
                    and self.page_owner[phys] == seq_id, \
                    f"{seq_id}: trim reached a shared/cached page " \
                    f"{phys} — only private lookahead pages trim"
                self._free_slot(phys)
                freed += 1
        s.length = min(s.length, length)
        return freed

    def rollback(self, seq_id: str, length: int) -> None:
        """Logical rollback of rejected speculative writes (DESIGN.md
        §16): clamp the sequence's token length back to ``length``
        without touching pages. Draft KV landed beyond ``length`` is
        garbage the attention mask never reads (seq_lens derive from
        the committed ``kv_len``), the next round's writes overwrite
        the same slots, and ``trim`` at turn close reclaims any whole
        trailing pages the final length doesn't need — so rollback is
        O(1) and conservation holds by the same page-state partition
        the invariant checker already enforces."""
        s = self.seq(seq_id)
        s.length = min(s.length, length)

    def release(self, seq_id: str) -> Dict[str, int]:
        """Drop a sequence's references. Returns an accounting report:
        ``freed_own`` private pages returned to the free list,
        ``freed_orphan`` cache-charged (owner-less) pages whose last
        reference died here, ``orphaned`` own pages that survive via
        other sharers or the radix index — their charge moves to the
        prefix cache (owner -> None)."""
        s = self.seqs.pop(seq_id, None)
        rep = {"freed_own": 0, "freed_orphan": 0, "orphaned": 0}
        if s is None:
            return rep
        for p in s.pages:
            if p < 0:
                continue
            owner = self.page_owner[p]
            self.refcount[p] -= 1
            if self.refcount[p] == 0 and p not in self.cache_held:
                self._free_slot(p)
                if owner is None:
                    rep["freed_orphan"] += 1
                else:
                    rep["freed_own"] += 1
            elif owner == seq_id:
                self.page_owner[p] = None
                rep["orphaned"] += 1
        return rep

    def adopt(self, seq_id: str, n_pages: int, length: int,
              offloaded: Dict[int, object]) -> SeqPages:
        """Install a sequence arriving from another pool (cross-replica
        migration handoff). Every page lands host-resident — the source
        drained its chunked offloads before the handoff — so adoption
        allocates nothing here; the destination's reload machinery pages
        the KV back in on its own clock."""
        assert seq_id not in self.seqs, f"{seq_id} already placed"
        assert set(offloaded) == set(range(n_pages)), \
            f"{seq_id}: handoff requires a full host copy " \
            f"({sorted(offloaded)} vs {n_pages} pages)"
        s = SeqPages(seq_id, pages=[-1] * n_pages, length=length,
                     offloaded=dict(offloaded))
        self.seqs[seq_id] = s
        return s

    # ------------------------------------------------- shared prefixes
    def attach_prefix(self, seq_id: str, phys: List[int],
                      length: int) -> None:
        """Point a FRESH sequence at already-resident pages holding its
        first ``length`` tokens (prefix-cache hit): each page's refcount
        goes up, no bytes move, and the pages stay charged to whoever
        pays for them today — the attacher's accountant records them as
        ``shared_blocks``."""
        s = self.seq(seq_id)
        assert not s.pages and s.length == 0 and not s.offloaded, \
            f"{seq_id}: attach_prefix only on an empty sequence"
        for p in phys:
            assert p in self.refcount, f"page {p} not allocated"
            self.refcount[p] += 1
        s.pages.extend(phys)
        s.length = length

    def cow(self, seq_id: str, li: int):
        """Copy-on-write: the writer must append into logical page
        ``li`` but shares its physical page. Allocate a private page,
        repoint, drop the shared ref. Returns (old_phys, new_phys,
        was_owner); the caller copies the device bytes old -> new and,
        when ``was_owner``, re-charges the old page to the prefix cache
        (its owner slot becomes None)."""
        s = self.seqs[seq_id]
        old = s.pages[li]
        assert old >= 0 and li not in s.loading and li not in s.offloading
        assert self.refcount[old] > 1, \
            f"{seq_id}: page {old} not shared — write in place"
        if not self.free:
            raise OutOfPages(f"pool exhausted COWing {seq_id}")
        new = self._alloc_page(seq_id)
        s.pages[li] = new
        self.refcount[old] -= 1
        was_owner = self.page_owner[old] == seq_id
        if was_owner:
            self.page_owner[old] = None
        return old, new, was_owner

    def detach_page(self, seq_id: str, li: int):
        """Drop one page reference without the offload machinery
        (migration deep-copy: the departing session keeps a host copy
        in ``offloaded`` and leaves the physical page to its sharers /
        the cache). Returns (was_owner, freed) — freed only when the
        last reference was this one and the radix index does not hold
        the page either."""
        s = self.seqs[seq_id]
        p = s.pages[li]
        assert p >= 0 and li not in s.loading and li not in s.offloading
        was_owner = self.page_owner[p] == seq_id
        self.refcount[p] -= 1
        freed = False
        if self.refcount[p] == 0 and p not in self.cache_held:
            self._free_slot(p)
            freed = True
        elif was_owner:
            self.page_owner[p] = None
        s.pages[li] = -1
        return was_owner, freed

    def cache_release(self, phys: List[int]) -> int:
        """The radix index forgot these pages: any that no sequence
        still references free now. Returns pages freed (all of them had
        owner None — the cache was paying)."""
        freed = 0
        for p in phys:
            self.cache_held.discard(p)
            if self.refcount.get(p) == 0:
                assert self.page_owner[p] is None
                self._free_slot(p)
                freed += 1
        return freed

    def shared_charged_pages(self, seq_id: str) -> int:
        """Own pages other sequences currently share (refcount > 1 and
        charged to this sequence) — pinned in HBM while any sharer
        needs them, so excluded from this session's evictable count."""
        s = self.seqs.get(seq_id)
        if s is None:
            return 0
        return sum(1 for p in s.pages
                   if p >= 0 and self.refcount[p] > 1
                   and self.page_owner[p] == seq_id)

    def shared_pages(self) -> int:
        """Physical pages with more than one live reference."""
        return sum(1 for c in self.refcount.values() if c > 1)

    # ------------------------------------------------------------ tables
    def block_table(self, seq_ids: List[str], pages_per_seq: int,
                    *, pad_page: int = 0) -> np.ndarray:
        """[B, pages_per_seq] int32 for the paged_attention kernel.
        Raises if any sequence has offloaded pages (must reload first —
        the correctness contract of §5.2's sync-fallback path)."""
        bt = np.full((len(seq_ids), pages_per_seq), pad_page, np.int32)
        for i, sid in enumerate(seq_ids):
            s = self.seq(sid)
            if s.offloaded:
                raise RuntimeError(f"{sid} has offloaded pages")
            n = min(len(s.pages), pages_per_seq)
            bt[i, :n] = s.pages[:n]
        return bt

    def seq_lens(self, seq_ids: List[str]) -> np.ndarray:
        return np.array([self.seq(s).length for s in seq_ids], np.int32)

    # ------------------------------------------------------------ tiers
    #
    # Chunk-grained primitives for the async transfer engine
    # (core/transfer_engine.py): begin_* flips accounting state and
    # reserves/marks slots; complete_* moves the bytes for one chunk;
    # cancel_* reverts marks without moving anything. The legacy
    # whole-session `offload_suffix`/`reload` below are begin+complete
    # in one call (the synchronous path, still used by pool tests and
    # the non-async engine mode).

    def begin_reload(self, seq_id: str) -> List[int]:
        """Reserve a physical slot for every offloaded page and mark it
        ``loading``. All-or-nothing: raises before mutating if the pool
        cannot hold them all. Returns the logical indices needing a
        host->device transfer, prefix-first. (Pages whose offload is
        still in flight are NOT included — cancel those with
        ``cancel_offloading`` first: their bytes never left HBM.)"""
        s = self.seq(seq_id)
        logical = sorted(li for li in s.offloaded if li not in s.loading)
        if len(self.free) < len(logical):
            raise OutOfPages(f"pool exhausted reloading {seq_id}")
        for li in logical:
            s.pages[li] = self._alloc_page(seq_id)
            s.loading.add(li)
        return logical

    def complete_reload(self, seq_id: str, logical: List[int], kv_pages,
                        staged=None):
        """Land one reload chunk: scatter the host copies into their
        reserved slots (one batched functional update), clear the
        ``loading`` marks, drop the host copies. ``staged`` overrides
        the source with an already-device-resident [n, 2, L, ...] stack
        (the engine stages it to time only the transferred bytes);
        without it the store adapter stacks the decoded host copies.
        Returns the updated kv_pages."""
        s = self.seq(seq_id)
        if not logical:
            return kv_pages
        phys = [s.pages[li] for li in logical]
        if staged is not None:
            src = staged
        else:
            from repro_torch.kvcache.quant import decode_host
            src = [decode_host(s.offloaded[li]) for li in logical]
        kv_pages = kv_pages.at[np.asarray(phys)].set(src)
        for li in logical:
            assert li in s.loading, f"{seq_id}: page {li} not loading"
            s.loading.remove(li)
            del s.offloaded[li]
        return kv_pages

    def cancel_loading(self, seq_id: str,
                       logical: Optional[List[int]] = None) -> int:
        """Un-reserve loading pages (eviction of a loading session,
        burst cancel, hangup): the slot returns to the free list, the
        host copy stays authoritative in ``offloaded``. Zero-copy —
        the contents never arrived. Returns pages cancelled."""
        s = self.seq(seq_id)
        take = sorted(s.loading) if logical is None else list(logical)
        for li in take:
            assert li in s.loading, f"{seq_id}: page {li} not loading"
            self._free_slot(s.pages[li])
            s.pages[li] = -1
            s.loading.remove(li)
        return len(take)

    def evictable_suffix(self, seq_id: str, n_pages: int):
        """Pick the LAST ``n_pages`` the eviction policy can free
        (suffix-first, §5.1), split by how they free: ``cancel_lis``
        are loading pages (cancel the in-flight reload — free
        immediately, zero copy) and ``offload_lis`` are resident pages
        (need a device->host copy). Pages already offloading are
        skipped — their blocks were accounted by an earlier pass — and
        so is any page this sequence does not privately own: a page
        with refcount > 1 (a sharer still needs it hot) or charged to
        another accountant (an attached prefix — the owner session or
        the prefix cache pays for it, and this session has no host copy
        to write). The caller's evictable budget already excludes both
        (``hbm - shared_pinned`` counts exactly the private own
        pages)."""
        s = self.seq(seq_id)
        cancel_lis, offload_lis = [], []
        for li in range(len(s.pages) - 1, -1, -1):
            if len(cancel_lis) + len(offload_lis) >= n_pages:
                break
            if s.pages[li] < 0 or li in s.offloading:
                continue
            if self.refcount[s.pages[li]] > 1 \
                    or self.page_owner[s.pages[li]] != seq_id:
                continue
            if li in s.loading:
                cancel_lis.append(li)
            else:
                offload_lis.append(li)
        return cancel_lis, offload_lis

    def mark_offloading(self, seq_id: str, logical: List[int]) -> None:
        """Copy-then-free step 1: the pages stay resident and usable;
        the slot frees only when ``complete_offload`` lands the copy."""
        s = self.seq(seq_id)
        for li in logical:
            assert s.pages[li] >= 0 and li not in s.loading \
                and li not in s.offloading, \
                f"{seq_id}: page {li} not plain-resident"
            assert self.refcount[s.pages[li]] == 1 \
                and s.pages[li] not in self.cache_held, \
                f"{seq_id}: page {s.pages[li]} is shared/cached — " \
                "never offload a page a sharer still needs hot " \
                "(forget it in the radix index first)"
            s.offloading.add(li)

    def complete_offload(self, seq_id: str,
                         copies: Dict[int, np.ndarray]) -> int:
        """Copy-then-free step 2: the host copies are durable — record
        them and free the physical slots. Returns pages freed."""
        s = self.seq(seq_id)
        for li, host in copies.items():
            assert li in s.offloading, f"{seq_id}: page {li} not offloading"
            s.offloaded[li] = host
            self._free_slot(s.pages[li])
            s.pages[li] = -1
            s.offloading.remove(li)
        return len(copies)

    def cancel_offloading(self, seq_id: str,
                          logical: Optional[List[int]] = None) -> List[int]:
        """A reload/turn arrived before the copy drained: keep the pages
        resident (their device contents never left). Returns the logical
        indices whose offload was cancelled."""
        s = self.seq(seq_id)
        take = sorted(s.offloading) if logical is None else list(logical)
        for li in take:
            assert li in s.offloading, f"{seq_id}: page {li} not offloading"
            s.offloading.remove(li)
        return take

    # --------------------------------------------- synchronous wrappers
    def offload_suffix(self, seq_id: str, n_pages: int, kv_pages) -> int:
        """Move the LAST n_pages of a sequence to host (suffix-first,
        §5.1), synchronously: begin + complete in one call. kv_pages:
        device array [num_pages, page, Hkv, hd] (or a pytree leaf).
        Loading pages in the suffix are cancelled instead of copied
        (their contents only exist on the host). Returns pages freed."""
        cancel_lis, offload_lis = self.evictable_suffix(seq_id, n_pages)
        self.cancel_loading(seq_id, cancel_lis)
        self.mark_offloading(seq_id, offload_lis)
        s = self.seq(seq_id)
        enc = self.codec.encode if self.codec is not None \
            else (lambda a: a)
        self.complete_offload(
            seq_id, {li: enc(kv_pages[s.pages[li]])
                     for li in offload_lis})
        return len(cancel_lis) + len(offload_lis)

    def reload(self, seq_id: str, kv_pages):
        """Bring offloaded pages back, synchronously. Returns (updated
        kv_pages, restored page count — transfers plus cancelled
        in-flight offloads). The scatter is functional and batched (one
        update for all pages); all-or-nothing on free space."""
        cancelled = self.cancel_offloading(seq_id)
        logical = self.begin_reload(seq_id)
        kv_pages = self.complete_reload(seq_id, logical, kv_pages)
        return kv_pages, len(logical) + len(cancelled)

    def resident_pages(self, seq_id: str) -> int:
        """Usable-resident pages: excludes loading reservations (their
        contents are still in flight), includes offloading pages (still
        valid on device until the copy drains). Read-only: an unknown
        or released sequence reports 0 without creating a ghost entry
        (callers probe sessions the pool may have dropped)."""
        s = self.seqs.get(seq_id)
        if s is None:
            return 0
        return sum(1 for li, p in enumerate(s.pages)
                   if p >= 0 and li not in s.loading)

    def inflight_pages(self, seq_id: str):
        """(loading, offloading) page counts for one sequence."""
        s = self.seq(seq_id)
        return len(s.loading), len(s.offloading)

    def stats(self) -> dict:
        return {
            "free": self.free_pages,
            "used": self.num_pages - self.free_pages,
            "seqs": len(self.seqs),
            "offloaded_pages": sum(len(s.offloaded)
                                   for s in self.seqs.values()),
            "loading_pages": sum(len(s.loading)
                                 for s in self.seqs.values()),
            "offloading_pages": sum(len(s.offloading)
                                    for s in self.seqs.values()),
            "shared_pages": self.shared_pages(),
            "cached_pages": len(self.cache_held),
        }
