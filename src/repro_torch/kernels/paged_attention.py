"""Paged attention: the wrappers of the hand-written Hopper kernels in
``csrc/paged_attention.cu``.

They replace the Pallas TPU kernels of the JAX package
(``repro/kernels/paged_attention.py``): ``paged_prefill_attention``
(``_fused_kernel``), which carries every round of the fused plane, and
``paged_attention`` (``_kernel``), the decode kernel of the per-token
plane. Both are one CUDA kernel body; the decode kernel is its Q = 1
case, so the two agree bit for bit at Q = 1.

What bounds them on an H100 is the K/V bytes they read (each valid page
of each (row, KV head) once) at 3.35 TB/s; the source file says what
the design does about that. Both types take one walk, split into spans
of ``ref.SPAN_KEYS`` keys, whose f32 partials the wrapper allocates from
the table width and a second kernel merges
(``ref.paged_prefill_attention_split_ref`` is that computation in plain
PyTorch); the type picks only the arithmetic of the tile products:
float32 on CUDA cores, bfloat16 on the tensor cores.

Both take the Pallas kernels' sharding options: ``pos_stride`` and
``pos_offset`` place a slot-sharded page's local slots at their global
positions, and ``return_stats`` returns each row's softmax (m, l) for
the exact merge across shards (``distributed/paged.py``). Without the
options the kernels compute exactly what they computed before them.

They also take their tiling knob, ``span``: the keys one block walks,
a multiple of 16 up to ``ref.MAX_SPAN_KEYS`` (the counterpart of
``kv_block``). Left unset, it comes from the autotune cache while one
is enabled (``kernels/autotune.py``), else it is ``ref.SPAN_KEYS``,
which launches the grid the kernels launched before the knob. Any legal
span stays within the plain version's tolerance, and at one span the
decode kernel equals the fused one at Q = 1 bit for bit. The Pallas
kernels' ``head_block`` has no counterpart: each block already takes
one KV head. On the CPU a call whose span is unset takes
``ref.paged_prefill_attention_ref`` as before, one with a span the
split version at that span.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
plain version in ``kernels/ref.py``. Each wrapper counts its calls that
launch the kernel in its ``launches`` attribute (one per call, though a
call runs the split kernel and its merge).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import autotune, ref
from repro_torch.kernels._build import library

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 80, 128, 192, 256)    # the instantiations in the .cu

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = library("paged_attention")
    if not getattr(lib, "_typed", False):
        lib.paged_prefill_attention_launch.argtypes = [
            _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
            *[_I] * 11, ctypes.c_float, _P]
        lib.paged_prefill_attention_launch.restype = _I
        lib.paged_attention_launch.argtypes = [
            _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
            *[_I] * 10, ctypes.c_float, _P]
        lib.paged_attention_launch.restype = _I
        lib.paged_span_keys.restype = _I
        lib.paged_max_span_keys.restype = _I
        spans = (lib.paged_span_keys(), lib.paged_max_span_keys())
        if spans != (ref.SPAN_KEYS, ref.MAX_SPAN_KEYS):
            raise RuntimeError(
                f"paged_attention.cu spans {spans} keys (default, most), "
                f"ref.SPAN_KEYS and MAX_SPAN_KEYS are {ref.SPAN_KEYS}, "
                f"{ref.MAX_SPAN_KEYS}: rebuild from one source")
        lib._typed = True
    return lib


def _check(q, k_pages, v_pages, block_tables, ints):
    """Device, dtype, shape and contiguity checks before any pointer
    reaches the kernel. Returns (dtype code, page, Hkv, D, pps)."""
    dev = q.device
    if q.dtype not in _DTYPES:
        raise TypeError(f"q dtype {q.dtype}: the kernel takes float32 or "
                        "bfloat16")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.device != dev or t.dtype != q.dtype:
            raise TypeError(f"{name} must be {q.dtype} on {dev}")
    for name, t in (("block_tables", block_tables), *ints):
        if t.device != dev or t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32 on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if k_pages.shape != v_pages.shape or k_pages.dim() != 4:
        raise ValueError("k_pages/v_pages must both be [P, page, Hkv, D]")
    _, page, Hkv, D = k_pages.shape
    Hq = q.shape[-2]
    if q.shape[-1] != D or Hq % Hkv:
        raise ValueError(f"q heads/dim {tuple(q.shape[-2:])} do not fit "
                         f"pages of {Hkv} heads x {D}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {_HEAD_DIMS}")
    B = q.shape[0]
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError("block_tables must be [B, pages_per_seq]")
    for name, t in ints:
        if t.shape != (B,):
            raise ValueError(f"{name} must be [B]")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             "aligned")
    return _DTYPES[q.dtype], page, Hkv, D, block_tables.shape[1]


def split_scratch(q, Q: int, Hkv: int, D: int, page: int, pps: int,
                  span: int = ref.SPAN_KEYS):
    """The kernel's f32 scratch for the partials of spans of ``span``
    keys, shaped from the table width alone (no device lengths are
    read): o [B, Hkv, nspan, G*Q, D] and (m, l) [B, Hkv, nspan, G*Q,
    2]."""
    B, Hq = q.shape[0], q.shape[-2]
    nspan = -(-pps * page // span)
    rows = Hq // Hkv * Q
    o = torch.empty((B, Hkv, nspan, rows, D), dtype=torch.float32,
                    device=q.device)
    ml = torch.empty((B, Hkv, nspan, rows, 2), dtype=torch.float32,
                     device=q.device)
    return o, ml, nspan


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _placement(page: int, pos_stride, pos_offset: int) -> tuple:
    """(stride, offset) of the local slots; the kernel walks keys in
    order, so a page's slots may not overlap the next page's."""
    stride = page if pos_stride is None else int(pos_stride)
    if stride < page:
        raise ValueError(f"pos_stride {stride} < the pages' {page} slots")
    return stride, int(pos_offset)


def _resolve(kind: str, span, q, k_pages, block_tables):
    """The span of a call: left unset, it comes from the autotune cache
    while one is enabled, else stays None (the default); an explicit
    span bypasses the cache. Raises on an illegal span."""
    if span is None and autotune.enabled():
        _, page, Hkv, D = k_pages.shape
        Q = q.shape[1] if kind == "paged_prefill_attention" else 1
        span = autotune.tiling(kind, q.shape[0], Q, q.shape[-2], Hkv, D,
                               page, block_tables.shape[1], q.dtype,
                               q.device)
    if span is not None and (span % 16 or not
                             16 <= span <= ref.MAX_SPAN_KEYS):
        raise ValueError(f"span {span}: a multiple of 16 in [16, "
                         f"{ref.MAX_SPAN_KEYS}]")
    return span


def _stats_out(q, rows_shape, return_stats: bool) -> tuple:
    """The f32 (m, l) outputs and their pointers (0 without stats)."""
    if not return_stats:
        return None, None, None, None
    m = torch.empty(rows_shape, dtype=torch.float32, device=q.device)
    l = torch.empty(rows_shape, dtype=torch.float32, device=q.device)
    return m, l, m.data_ptr(), l.data_ptr()


def paged_prefill_attention(q, k_pages, v_pages, block_tables, q_start,
                            q_lens, *, pos_stride=None, pos_offset: int = 0,
                            return_stats: bool = False, span=None):
    """q [B, Q, Hq, D]; k_pages/v_pages [P, page, Hkv, D];
    block_tables [B, pages_per_seq] i32; q_start/q_lens [B] i32
    -> [B, Q, Hq, D].

    Row b's query token t sits at position ``q_start[b] + t`` and
    attends over positions ``<= q_start[b] + t`` (history plus the chunk
    prefix, whose K/V the caller scattered into the pages before the
    call). Tokens ``t >= q_lens[b]`` are padding; callers discard them.
    Local slot ``j`` of table column ``p`` sits at ``p * pos_stride +
    pos_offset + j`` (default: ``pos_stride = page``, the identity).
    With ``return_stats`` the result is ``(out, m, l)``, m/l [B, Q, Hq]
    f32: the row's running max and softmax denominator over the keys it
    saw (``m = ref.NEG_INF``, ``l = 0`` and a zero output for a row that
    saw none). ``span``: the tiling knob (module docstring).
    """
    span = _resolve("paged_prefill_attention", span, q, k_pages,
                    block_tables)
    if q.device.type == "cpu":
        plain = ref.paged_prefill_attention_ref if span is None else \
            functools.partial(ref.paged_prefill_attention_split_ref,
                              span=span)
        return plain(q, k_pages, v_pages, block_tables, q_start, q_lens,
                     pos_stride=pos_stride, pos_offset=pos_offset,
                     return_stats=return_stats)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    code, page, Hkv, D, pps = _check(
        q, k_pages, v_pages, block_tables,
        (("q_start", q_start), ("q_lens", q_lens)))
    stride, offset = _placement(page, pos_stride, pos_offset)
    span = ref.SPAN_KEYS if span is None else span
    B, Q, Hq, _ = q.shape
    out = torch.empty_like(q)
    o_part, ml_part, nspan = split_scratch(q, Q, Hkv, D, page, pps, span)
    m, l, m_ptr, l_ptr = _stats_out(q, (B, Q, Hq), return_stats)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().paged_prefill_attention_launch(
        code, q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), q_start.data_ptr(), q_lens.data_ptr(),
        out.data_ptr(), o_part.data_ptr(), ml_part.data_ptr(), m_ptr, l_ptr,
        B, Q, Hq, Hkv, D, page, pps, nspan, span, stride, offset,
        1.0 / math.sqrt(D), stream)
    _raise_on(err, "paged_prefill_attention")
    paged_prefill_attention.launches += 1
    return (out, m, l) if return_stats else out


def paged_attention(q, k_pages, v_pages, block_tables, seq_lens, *,
                    pos_stride=None, pos_offset: int = 0,
                    return_stats: bool = False, span=None):
    """q [B, Hq, D]; k_pages/v_pages [P, page, Hkv, D];
    block_tables [B, pages_per_seq] i32; seq_lens [B] i32 -> [B, Hq, D].
    One query per row, attending over the positions ``< seq_lens[b]``;
    the options and the span are ``paged_prefill_attention``'s, with m/l
    [B, Hq]."""
    span = _resolve("paged_attention", span, q, k_pages, block_tables)
    if q.device.type == "cpu":
        plain = ref.paged_attention_ref if span is None else \
            functools.partial(ref.paged_attention_split_ref, span=span)
        return plain(q, k_pages, v_pages, block_tables, seq_lens,
                     pos_stride=pos_stride, pos_offset=pos_offset,
                     return_stats=return_stats)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    code, page, Hkv, D, pps = _check(q, k_pages, v_pages, block_tables,
                                     (("seq_lens", seq_lens),))
    stride, offset = _placement(page, pos_stride, pos_offset)
    span = ref.SPAN_KEYS if span is None else span
    B, Hq, _ = q.shape
    out = torch.empty_like(q)
    o_part, ml_part, nspan = split_scratch(q, 1, Hkv, D, page, pps, span)
    m, l, m_ptr, l_ptr = _stats_out(q, (B, Hq), return_stats)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().paged_attention_launch(
        code, q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        o_part.data_ptr(), ml_part.data_ptr(), m_ptr, l_ptr, B, Hq, Hkv, D,
        page, pps, nspan, span, stride, offset, 1.0 / math.sqrt(D), stream)
    _raise_on(err, "paged_attention")
    paged_attention.launches += 1
    return (out, m, l) if return_stats else out


paged_prefill_attention.launches = 0
paged_attention.launches = 0
