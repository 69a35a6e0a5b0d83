"""Tensor-sharded paged KV plane (DESIGN.md §9), on torch.distributed.

The port of the JAX package's ``distributed/paged.py``. The engine's
page store [L, P+1, page, Hkv, hd] shards over the 'model' axis of a
``launch.mesh.ServingMesh`` by the reference's rules:

- ``heads`` when KV heads divide the axis: each shard owns ``Hkv / M``
  heads of every page. Attention is local (softmax is per head); the
  shards' outputs are gathered over the head dim.
- ``slots`` when heads do not divide but the page size does: each shard
  owns ``page / M`` slots of every page. A shard runs the kernel with
  ``pos_stride = page`` and ``return_stats`` on lengths shifted by its
  first slot, and the shards merge exactly: ``m* = max m``,
  ``w = l * exp(m - m*)``, ``o = sum(o * w) / sum(w)``.
- ``replicated`` otherwise: every shard holds and computes everything.

Weights, tokens, block tables and the host control plane stay
replicated. Where JAX runs one program over the mesh, here each rank
is a process holding its own shard: the engine's leader (rank 0) runs
the control plane and sends the other ranks each device operation,
which every rank then runs on its shard through the same functions
(``serving/paged_engine.py``). The step functions are the
single-device ``paged_*_step`` bodies with ``plane=`` bound, as in the
reference, so sharded and single-device engines cannot drift.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.flash_prefill import flash_prefill
from repro_torch.kernels.paged_attention import paged_attention, \
    paged_prefill_attention


class PagedKVLayout:
    """How one engine's page store [L, P+1, page, Hkv, hd] shards over
    the mesh's 'model' axis, and this rank's part of it."""

    def __init__(self, cfg, mesh, page_size: int):
        self.cfg = cfg
        self.mesh = mesh
        self.page_size = page_size
        self.M = mesh.model
        self.idx = mesh.idx
        if cfg.num_kv_heads % self.M == 0:
            self.kind = "heads"
        elif page_size % self.M == 0:
            self.kind = "slots"
        else:
            self.kind = "replicated"

    def __repr__(self):
        return (f"PagedKVLayout(kind={self.kind!r}, M={self.M}, "
                f"mesh={self.mesh.shape})")

    # ------------------------------------------------------------ shapes
    @property
    def page_local(self) -> int:
        return self.page_size // self.M if self.kind == "slots" \
            else self.page_size

    @property
    def heads_local(self) -> int:
        Hkv = self.cfg.num_kv_heads
        return Hkv // self.M if self.kind == "heads" else Hkv

    def local_shape(self, shape) -> tuple:
        """This shard's part of a global ``[..., page, Hkv, hd]`` shape."""
        return (*shape[:-3], self.page_local, self.heads_local, shape[-1])

    def shard(self, pages: torch.Tensor) -> torch.Tensor:
        """This shard's (contiguous) part of global ``[..., page, Hkv,
        hd]`` pages."""
        if self.kind == "heads":
            n = self.heads_local
            return pages[..., self.idx * n:(self.idx + 1) * n, :] \
                .contiguous()
        if self.kind == "slots":
            n = self.page_local
            return pages[..., self.idx * n:(self.idx + 1) * n, :, :] \
                .contiguous()
        return pages

    def unshard(self, local: torch.Tensor) -> torch.Tensor:
        """The global pages from every shard's part (a collective over
        the 'model' group: every rank of it calls this)."""
        if self.kind == "heads":
            return self.mesh.gather(local, dim=-2)
        if self.kind == "slots":
            return self.mesh.gather(local, dim=-3)
        return local

    # ------------------------------------------------------- per-token
    def write_token(self, kc, vc, k, v, write_page, write_slot) -> None:
        """Write one token per batch row into this shard's pages, in
        place: ``kc``/``vc`` [P+1, page_local, Hkv_local, hd]; ``k``/``v``
        [B, Hkv, hd] the full projections; ``write_page``/``write_slot``
        [B] global coordinates."""
        self.write_chunk(kc, vc, k[:, None], v[:, None], write_page[:, None],
                         write_slot[:, None])

    def attend(self, q, kc, vc, block_tables, seq_lens):
        """This shard's paged attention and the merge across shards:
        ``q`` [B, Hq, D] the full query. Returns the full [B, Hq, D]
        output, the same on every rank."""
        if self.kind == "heads":
            n = q.shape[1] // self.M
            a = paged_attention(
                q[:, self.idx * n:(self.idx + 1) * n].contiguous(), kc, vc,
                block_tables, seq_lens)
            return self.mesh.gather(a, dim=1)
        if self.kind == "slots":
            # the shard's slots sit at offset idx * page_local in each
            # page; shifting the lengths by it is the same as offsetting
            # every local position (positions only mask)
            o, m, l = paged_attention(
                q, kc, vc, block_tables,
                seq_lens - self.idx * self.page_local,
                pos_stride=self.page_size, return_stats=True)
            return self._merge(o, m, l)
        return paged_attention(q, kc, vc, block_tables, seq_lens)

    # ----------------------------------------------------- fused chunks
    def write_chunk(self, kc, vc, k, v, write_pages, write_slots) -> None:
        """Write a round's token chunks into this shard's pages, in
        place: ``k``/``v`` [B, Q, Hkv, hd] the full projections;
        ``write_pages``/``write_slots`` [B, Q] global coordinates."""
        if self.kind == "heads":
            n = self.heads_local
            k = k[:, :, self.idx * n:(self.idx + 1) * n]
            v = v[:, :, self.idx * n:(self.idx + 1) * n]
        elif self.kind == "slots":
            # tokens another shard owns go to the scratch page (the
            # store's last page), which no live row reads: writing them
            # back in place would put two values on one local slot in
            # one scatter, and index_put_ with duplicate indices keeps
            # either on CUDA
            n = self.page_local
            own = torch.div(write_slots, n, rounding_mode="floor") \
                == self.idx
            write_pages = torch.where(own, write_pages, kc.shape[0] - 1)
            write_slots = write_slots % n
        kc[write_pages, write_slots] = k
        vc[write_pages, write_slots] = v

    def attend_chunk(self, q, kc, vc, block_tables, q_start, q_lens):
        """This shard's fused multi-token attention and the merge across
        shards: ``q`` [B, Q, Hq, D] the full query chunk. Returns the full
        [B, Q, Hq, D] output, the same on every rank."""
        if self.kind == "heads":
            n = q.shape[2] // self.M
            a = paged_prefill_attention(
                q[:, :, self.idx * n:(self.idx + 1) * n].contiguous(), kc,
                vc, block_tables, q_start, q_lens)
            return self.mesh.gather(a, dim=2)
        if self.kind == "slots":
            o, m, l = paged_prefill_attention(
                q, kc, vc, block_tables,
                q_start - self.idx * self.page_local, q_lens,
                pos_stride=self.page_size, return_stats=True)
            return self._merge(o, m, l)
        return paged_prefill_attention(q, kc, vc, block_tables, q_start,
                                       q_lens)

    def _merge(self, o, m, l):
        """The exact merge of the shards' partial softmaxes: one max and
        one sum (of ``o * w`` and ``w`` packed together) over the group.
        A row no shard saw (a padding row) comes out zeros."""
        m_star = self.mesh.pmax(m.clone())
        w = l * torch.exp(m - m_star)
        packed = self.mesh.psum(torch.cat(
            [o.float() * w[..., None], w[..., None]], dim=-1))
        a = packed[..., :-1] / packed[..., -1:].clamp_min(1e-30)
        return a.to(o.dtype)


# ======================================================================
# global-view wrappers (every rank of the 'model' group calls them)
# ======================================================================
def sharded_paged_attention(layout: PagedKVLayout, q, k_pages, v_pages,
                            block_tables, seq_lens):
    """``paged_attention`` over pages sharded by ``layout``: every rank
    passes the same full inputs, attends over its shard of the pages and
    gets the full [B, Hq, D] result."""
    return layout.attend(q, layout.shard(k_pages), layout.shard(v_pages),
                         block_tables, seq_lens)


def sharded_flash_prefill(layout: PagedKVLayout, q, k, v, *,
                          causal: bool = True, window=None,
                          q_offset: int = 0):
    """``flash_prefill`` with the heads sharded over the 'model' group
    where both head counts divide it (fully local: softmax is per head),
    else computed whole on every rank. q [B, Hq, Sq, D]; k/v [B, Hkv,
    Skv, D]; every rank passes and gets the full tensors.

    A kernel-level building block, as in the reference: the engine's
    turn-0 graft runs the replicated dense forward."""
    kernel = functools.partial(flash_prefill, causal=causal, window=window,
                               q_offset=q_offset)
    M, i = layout.M, layout.idx
    Hq, Hkv = q.shape[1], k.shape[1]
    if Hq % M or Hkv % M:
        return kernel(q, k, v)
    nq, nk = Hq // M, Hkv // M
    out = kernel(q[:, i * nq:(i + 1) * nq].contiguous(),
                 k[:, i * nk:(i + 1) * nk].contiguous(),
                 v[:, i * nk:(i + 1) * nk].contiguous())
    return layout.mesh.gather(out, dim=1)


# ======================================================================
# the sharded steps: the single-device bodies with the plane bound
# ======================================================================
def make_sharded_step(layout: PagedKVLayout):
    """The sharded twin of ``serving.paged_engine.paged_decode_step``,
    called as it is on this rank's shard of the page store."""
    from repro_torch.serving.paged_engine import paged_decode_step
    return functools.partial(paged_decode_step, plane=layout)


def make_sharded_fused_step(layout: PagedKVLayout):
    """The sharded twin of ``paged_fused_step`` (DESIGN.md §11)."""
    from repro_torch.serving.paged_engine import paged_fused_step
    return functools.partial(paged_fused_step, plane=layout)


def make_sharded_spec_step(layout: PagedKVLayout):
    """The sharded twin of the speculative verify round (DESIGN.md §16):
    ``paged_fused_step(..., spec=True)`` with the plane bound."""
    from repro_torch.serving.paged_engine import paged_fused_step
    return functools.partial(paged_fused_step, plane=layout, spec=True)
