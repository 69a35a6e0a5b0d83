"""Block-table assembly for the paged realtime engine.

Bridges the host-side ``PagedPool`` bookkeeping and the paged-attention
kernels: per-round [B, pages_per_seq] int32 tables for a *fixed-size*
decode batch — inactive rows point at a reserved scratch page so the
batch shape never changes across rounds — plus the layer-stacked K/V
page-store adapter the pool's DRAM tier moves page contents through.
The table builders are the JAX package's, unchanged; the adapter writes
in place on the device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kvcache.paged import PagedPool


@dataclass
class BatchTables:
    """One decode round's kernel inputs, host-side (cheap int32 arrays)."""
    block_tables: np.ndarray     # [B, pages_per_seq] i32 physical pages
    seq_lens: np.ndarray         # [B] i32 attention length (post-write)
    positions: np.ndarray        # [B] i32 absolute position of new token
    write_page: np.ndarray       # [B] i32 physical page the token writes
    write_slot: np.ndarray       # [B] i32 slot within that page
    active: np.ndarray           # [B] bool — padded rows are False


def assemble(pool: PagedPool, rows: List[Optional[Tuple[str, int]]],
             pages_per_seq: int, scratch_page: int) -> BatchTables:
    """Build the tables for one decode round.

    ``rows[i]`` is ``(seq_id, tokens_written)`` for the session served by
    batch row i, or None for a padding row. Padding rows write to (and
    attend over one slot of) ``scratch_page`` — a physical page outside
    the pool's managed range — so their lanes compute finite garbage that
    is discarded, and real pages are never clobbered.

    Every active sequence must be fully HBM-resident (§5.2 sync-fallback
    contract) and must already own the page its next token writes into.
    """
    B = len(rows)
    bt = np.full((B, pages_per_seq), scratch_page, np.int32)
    seq_lens = np.ones((B,), np.int32)
    positions = np.zeros((B,), np.int32)
    write_page = np.full((B,), scratch_page, np.int32)
    write_slot = np.zeros((B,), np.int32)
    active = np.zeros((B,), bool)
    for i, row in enumerate(rows):
        if row is None:
            continue
        sid, written = row
        s = pool.seq(sid)
        if s.offloaded:
            raise RuntimeError(
                f"{sid} has offloaded pages; reload before scheduling")
        n = len(s.pages)
        if n > pages_per_seq:
            raise ValueError(f"{sid}: {n} pages > table width "
                             f"{pages_per_seq}")
        bt[i, :n] = s.pages
        page_idx, slot = divmod(written, pool.page_size)
        if page_idx >= n:
            raise RuntimeError(
                f"{sid}: page {page_idx} for token {written} not "
                f"allocated (owns {n})")
        write_page[i] = s.pages[page_idx]
        write_slot[i] = slot
        positions[i] = written
        seq_lens[i] = written + 1
        active[i] = True
    return BatchTables(bt, seq_lens, positions, write_page, write_slot,
                       active)


@dataclass
class FusedBatchTables:
    """One fused round's kernel inputs (DESIGN.md §11): every batch row
    carries up to Q consecutive tokens of one sequence."""
    block_tables: np.ndarray     # [B, pages_per_seq] i32 physical pages
    q_start: np.ndarray          # [B] i32 first token's absolute position
    q_lens: np.ndarray           # [B] i32 valid tokens this row (0 = pad)
    positions: np.ndarray        # [B, Q] i32 absolute position per token
    write_pages: np.ndarray      # [B, Q] i32 physical page per token
    write_slots: np.ndarray      # [B, Q] i32 slot within that page


def assemble_fused(pool: PagedPool,
                   rows: List[Optional[Tuple[str, int, int]]], q_tokens: int,
                   pages_per_seq: int, scratch_page: int) -> FusedBatchTables:
    """Build the tables for one fused round.

    ``rows[i]`` is ``(seq_id, tokens_written, n_tokens)`` — the session
    served by batch row i feeds ``n_tokens`` consecutive tokens starting
    at absolute position ``tokens_written`` — or None for a padding row.
    ``q_tokens`` is the (bucketed) query-axis width; token slots past
    ``n_tokens`` and whole padding rows point at ``scratch_page`` with
    ``q_lens`` masking them out of attention, so their lanes compute
    finite garbage that is discarded and real pages are never clobbered.

    Every active sequence must be fully HBM-resident and must already
    own every page its chunk writes into (the caller grew the sequence
    for the whole grant before packing — the §5.2 contract unchanged).
    """
    B = len(rows)
    bt = np.full((B, pages_per_seq), scratch_page, np.int32)
    q_start = np.zeros((B,), np.int32)
    q_lens = np.zeros((B,), np.int32)
    positions = np.zeros((B, q_tokens), np.int32)
    write_pages = np.full((B, q_tokens), scratch_page, np.int32)
    # padded token slots spread over the scratch page so one launch's
    # scatter has as few duplicate targets as possible (their contents
    # are garbage either way; nothing ever attends to them)
    write_slots = np.tile(np.arange(q_tokens, dtype=np.int32)[None, :]
                          % max(1, pool.page_size), (B, 1))
    for i, row in enumerate(rows):
        if row is None:
            continue
        sid, written, n_tok = row
        assert 0 < n_tok <= q_tokens, (sid, n_tok, q_tokens)
        s = pool.seq(sid)
        if s.offloaded:
            raise RuntimeError(
                f"{sid} has offloaded pages; reload before scheduling")
        n = len(s.pages)
        if n > pages_per_seq:
            raise ValueError(f"{sid}: {n} pages > table width "
                             f"{pages_per_seq}")
        bt[i, :n] = s.pages
        q_start[i] = written
        q_lens[i] = n_tok
        pos = written + np.arange(n_tok)
        page_idx = pos // pool.page_size
        if page_idx[-1] >= n:
            raise RuntimeError(
                f"{sid}: page {page_idx[-1]} for token {pos[-1]} not "
                f"allocated (owns {n})")
        positions[i, :n_tok] = pos
        write_pages[i, :n_tok] = np.asarray(s.pages, np.int64)[page_idx]
        write_slots[i, :n_tok] = pos % pool.page_size
    return FusedBatchTables(bt, q_start, q_lens, positions, write_pages,
                            write_slots)


class LayerStackedPages:
    """Adapts the layer-major K/V page store ([L, P+1, page, Hkv, hd]
    tensors, the layout the steps loop over) to the PagedPool's
    page-major offload/reload interface: ``kv_pages[phys]`` -> host
    copy, ``kv_pages.at[phys].set(copy)`` -> the same store, written in
    place.

    A host copy is the stacked ``[2, L, page, Hkv, hd]`` (k, v) contents
    of one physical page as a CPU tensor of the store's dtype, so every
    dtype (bf16 included, which numpy lacks) round-trips bit for bit.
    """

    def __init__(self, k: torch.Tensor, v: torch.Tensor):
        self.k = k
        self.v = v

    def __getitem__(self, phys: int) -> torch.Tensor:
        return torch.stack([self.k[:, phys], self.v[:, phys]]).cpu()

    @property
    def at(self) -> "_StoreAt":
        return _StoreAt(self)

    def write(self, phys, stack: torch.Tensor) -> None:
        """Scatter ``stack`` [n, 2, L, page, Hkv, hd] into physical
        pages ``phys`` (n ids), in place, one ``index_copy_`` per
        component."""
        idx = torch.as_tensor(phys, dtype=torch.int64).reshape(-1) \
            .to(self.k.device)
        stack = stack.to(self.k.device, self.k.dtype)
        self.k.index_copy_(1, idx, stack[:, 0].movedim(0, 1))
        self.v.index_copy_(1, idx, stack[:, 1].movedim(0, 1))


class _StoreAt:
    def __init__(self, store: LayerStackedPages):
        self._store = store

    def __getitem__(self, phys) -> "_StoreSet":
        return _StoreSet(self._store, phys)


class _StoreSet:
    def __init__(self, store: LayerStackedPages, phys):
        self._store = store
        self._phys = phys

    def set(self, host_copy) -> LayerStackedPages:
        """Scalar phys takes one [2, L, page, ...] copy; an index array
        takes the stacked [n, 2, L, page, ...] batch or a list of n
        copies (the pool's batched reload). Writes in place and returns
        the store, so the pool's functional-update call sites hold."""
        if isinstance(host_copy, (list, tuple)):
            host_copy = torch.stack(list(host_copy))
        if np.ndim(self._phys) == 0:
            host_copy = host_copy[None]
        self._store.write(self._phys, host_copy)
        return self._store
