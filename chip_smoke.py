"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version at full-width shapes, then
drives the port's main paths at full width with random weights from a
seed, each with the kernels' launch counts zeroed just before it and
read just after:

- the paged multi-turn engine (qwen2-1.5b, 28 layers, bf16) on both
  planes: (a) the scripted demo, (b) a mixed prefill/decode trace;
- (a') the scripted demo on the per-token plane, whose turns 0 take the
  dense prefill graft (``flash_prefill``);
- (c) the single-turn ring-cache engine on qwen2-1.5b (``flash_prefill``)
  and (d) on mamba2-1.3b (48 layers, ``ssd_scan``), each against a B = 1
  greedy reference and a full-width prefill through the plain versions;
  (d) also profiles one prefill for the ``ssd_scan`` kernels' share;

and checks what comes out. Every phase is checked; any failure exits
non-zero. The last line of standard output is

  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

It exits non-zero without a result when no CUDA device is present or
when the package it tests is not beside it.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
HBM_BYTES_S = 3.35e12              # H100 SXM device memory rate
PEAK_OPS_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
KERNEL_SRC = "src/repro_torch/kernels/csrc/paged_attention.cu"
SOURCES = {"paged_prefill_attention": KERNEL_SRC,
           "paged_attention": KERNEL_SRC,
           "flash_prefill": "src/repro_torch/kernels/csrc/flash_prefill.cu",
           "ssd_scan": "src/repro_torch/kernels/csrc/ssd_scan.cu"}
REPLACES = {"paged_prefill_attention":
            "src/repro/kernels/paged_attention.py:283",
            "paged_attention": "src/repro/kernels/paged_attention.py:133",
            "flash_prefill": "src/repro/kernels/flash_prefill.py:80",
            "ssd_scan": "src/repro/kernels/ssd_scan.py:67"}
SSD_TOL = {d: 4 * t for d, t in TOL.items()}   # the recurrence accumulates
# the bf16 paged kernels against the f32 split plain version on the same
# inputs, per query row relative to the row's largest |value|: rounding
# P and the output to bf16 costs a few 2^-9; a span left out or a merge
# that ignores m costs more (``planted_faults`` shows it on each case)
REL_TOL = 2e-2


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(*a) -> None:
    print(*a, flush=True)


# ======================================================================
# timing and bounds
# ======================================================================
class Timer:
    """Mean device time of a call with the L2 cache flushed before each
    launch (in the engine each layer reads its own pages after the MLP
    has streamed ~80 MB of weights, so the kernel finds them cold).
    The events bracket the call as the host enqueues it, so an idle
    device also waits for the wrapper's checks, allocations and launches
    between them."""

    def __init__(self, dev):
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def __call__(self, fn, reps: int = 20) -> float:
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(reps):
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            total += a.elapsed_time(b)
        return total / reps


def attention_bound(q, k_pages, starts, lens, decode: bool):
    """Least time (ms) the card needs for one call on these inputs: the
    bytes the function must move, once each, over the memory rate, or
    the multiply-adds of QK^T and PV over the valid (query, key) pairs
    over the peak rate of the input type, whichever is larger. The bytes
    are each row's seq_len (decode) or q_start and q_lens, and for a row
    with n valid tokens from position s: their q read and out written,
    the ceil((s+n)/page) table entries it reaches and the K and V of its
    s+n positions. Padding tokens and pages past s+n are not counted."""
    elt = q.element_size()
    _, page, Hkv, D = k_pages.shape
    Hq = q.shape[-2]
    starts = starts.cpu().numpy().astype(np.int64)
    lens = np.ones_like(starts) if decode else lens.cpu().numpy()
    if decode:
        starts = starts - 1                       # seq_lens -> q_start
    nbytes = (1 if decode else 2) * starts.size * 4
    ops = 0
    for s, n in zip(starts, lens):
        if n <= 0:
            continue
        reach = s + n                             # positions 0 .. s+n-1
        nbytes += 2 * n * Hq * D * elt            # q read, out written
        nbytes += math.ceil(reach / page) * 4     # block-table entries
        nbytes += 2 * reach * Hkv * D * elt       # K and V
        keys = n * (s + 1) + n * (n - 1) // 2     # sum over t of s+t+1
        ops += 4 * keys * D * Hq
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[q.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_yardstick(q, k_pages, v_pages, bt, starts, lens, decode: bool):
    """One library call computing the same function over K/V gathered
    beforehand (the gather is not timed): the yardstick only; the port
    never calls it."""
    B = q.shape[0]
    qq = q[:, None] if decode else q                  # [B, Q, Hq, D]
    Q, Hq, D = qq.shape[1:]
    _, page, Hkv, _ = k_pages.shape
    S = bt.shape[1] * page
    k = k_pages[bt.long()].reshape(B, S, Hkv, D).repeat_interleave(
        Hq // Hkv, dim=2).transpose(1, 2).contiguous()
    v = v_pages[bt.long()].reshape(B, S, Hkv, D).repeat_interleave(
        Hq // Hkv, dim=2).transpose(1, 2).contiguous()
    st = (starts.long() - 1) if decode else starts.long()
    ln = torch.ones_like(st) if decode else lens.long()
    t = torch.arange(Q, device=q.device)
    pos = torch.arange(S, device=q.device)
    mask = (pos[None, None, :] <= (st[:, None] + t[None, :])[..., None]) \
        & (t[None, :] < ln[:, None])[..., None]
    qt = qq.transpose(1, 2).contiguous()
    mask = mask[:, None]
    F = torch.nn.functional
    return lambda: F.scaled_dot_product_attention(qt, k, v, attn_mask=mask)


def flash_bound(q, k, window, q_offset):
    """Least time (ms) for one ``flash_prefill`` call: q, k, v read and
    out written once over the memory rate, or the multiply-adds of QK^T
    and PV over the (query, key) pairs the masks leave, over the peak
    rate of the input type, whichever is larger."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    qpos = np.arange(Sq) + q_offset
    hi = np.minimum(qpos + 1, Skv)                  # causal: keys < hi
    lo = np.zeros_like(qpos) if window is None else \
        np.maximum(qpos - window + 1, 0)
    pairs = int(np.maximum(hi - lo, 0).sum())
    nbytes = q.element_size() * (2 * B * Hq * Sq * D + 2 * B * Hkv * Skv * D)
    ops = 4 * B * Hq * pairs * D
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[q.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ssd_bound(X, B_mat, cs):
    """Least time (ms) for one ``ssd_scan`` call: the bytes it must move
    (X, dA, B and C read, Y and the f32 state written, once each; B/C
    ``[B, L, G, N]`` in their own type) over the memory rate, or its
    operations over the rate of the unit that runs them, whichever is
    larger. C B^T over the cs (cs + 1) / 2 pairs j <= i of a chunk is
    needed once per (b, chunk, group), on the tensor cores when B/C are
    bf16 (f32 CUDA cores otherwise). On f32 CUDA cores (TF32 is off), per
    (b, chunk, head): the decayed scores times X over the same pairs,
    the chunk's own state (2 cs N P) and, for every chunk after the
    first (the state entering chunk 0 is zero), the carried state's
    part of Y (2 cs N P)."""
    b, l, h, p = X.shape
    g, n = B_mat.shape[-2:]
    nc = l // cs
    pairs = cs * (cs + 1) // 2
    ops_cb = b * nc * g * 2 * pairs * n
    ops_f32 = b * h * (nc * (2 * pairs * p + 2 * cs * n * p)
                       + (nc - 1) * 2 * cs * n * p)
    nbytes = X.element_size() * b * l * h * (2 * p + 1) \
        + 2 * B_mat.element_size() * b * l * g * n + 4 * b * h * p * n
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = (ops_cb / PEAK_OPS_S[B_mat.dtype]
             + ops_f32 / PEAK_OPS_S[torch.float32]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ssd_bound_per_head(X, n, cs):
    """The earlier per-head bound, kept so that rows can be compared
    with those measured before B/C were read per group: B/C repeated
    over the heads in X's type, and C B^T counted per head."""
    b, l, h, p = X.shape
    pairs = cs * (cs + 1) // 2
    ops = b * h * (l // cs) * (2 * pairs * (n + p) + 4 * cs * n * p)
    nbytes = X.element_size() * b * l * h * (2 * p + 1 + 2 * n) \
        + 4 * b * h * p * n
    return max(nbytes / HBM_BYTES_S, ops / PEAK_OPS_S[torch.float32]) * 1e3


def allclose_err(got, want, tol):
    """(max abs error, within ``tol`` as rtol and atol)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    return err.max().item(), bool((err <= tol + tol * want.abs()).all())


# ======================================================================
# phases
# ======================================================================
def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def build_kernels() -> None:
    from repro_torch.kernels import _build
    seconds, reports = _build.timed_build()
    log(f"[build] nvcc sm_90a, {len(_build.SOURCES)} source(s) in "
        f"{seconds:.1f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "Used" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    # tensor-core proof: every bf16 attention kernel's SASS holds HMMA,
    # and so does ssd_scan's C B^T for bf16 B/C, shared by its X types
    # (matched by mangled name; each pattern must match some kernel)
    seen = {"paged_attention_kernelI13__nv_bfloat16": 0,
            "flash_prefill_bf16": 0, "ssd_cb_mma": 0}
    for name in _build.SOURCES:
        for fn, n in _build.sass_counts(name).items():
            log(f"[build] {name}: {n} HMMA in {fn[:110]}")
            for pattern in seen:
                if pattern in fn:
                    seen[pattern] += 1
                    check(n > 0, f"{fn}: no HMMA, not on the tensor cores")
    check(all(seen.values()), f"bf16 tensor-core kernels not found: {seen}")


def kernel_case(dev, dtype, B, Q, ctx, g):
    """Full-width heads (Hq 12, Hkv 2, D 128), page 16, the engine's row
    count: ``ctx`` context tokens per row before its chunk, rows 0-1
    prefilling a Q-token chunk, the others decoding one token, the last
    row padding (q_lens 0)."""
    Hq, Hkv, D, page = 12, 2, 128, 16
    pps = math.ceil((max(ctx) + Q) / page)
    P = B * pps + 1
    q = torch.randn(B, Q, Hq, D, generator=g, device=dev).to(dtype)
    kp = torch.randn(P, page, Hkv, D, generator=g, device=dev).to(dtype)
    vp = torch.randn(P, page, Hkv, D, generator=g, device=dev).to(dtype)
    bt = torch.randperm(P - 1, generator=g, device=dev)[:B * pps] \
        .reshape(B, pps).int()
    qs = torch.tensor(ctx, dtype=torch.int32, device=dev)
    ql = torch.tensor([Q if i < 2 else (0 if i == B - 1 else 1)
                       for i in range(B)], dtype=torch.int32, device=dev)
    return q, kp, vp, bt, qs, ql


def max_valid_err(got, want, ql):
    errs = [(got[b, :n].float() - want[b, :n].float()).abs().max().item()
            for b, n in enumerate(ql.tolist()) if n > 0]
    return max(errs)


def row_scaled_err(got, want, ql):
    """Largest error of a live query row (b, t, head) of [B, Q, Hq, D]
    outputs, relative to that row's largest |want|."""
    got, want = got.float(), want.float()
    err = (got - want).abs().amax(-1)
    scale = want.abs().amax(-1).clamp_min(1e-30)
    live = torch.arange(got.shape[1], device=got.device)[None, :] < \
        ql[:, None]
    return (err / scale)[live].max().item()


def planted_faults(q, kp, vp, bt, qs, ql):
    """The split plain version with a fault planted in it: span 1 left
    out (its l set to 0, so the merge gives it weight 0), and a merge
    that ignores m (every span weighted 1)."""
    from repro_torch.kernels import ref
    o, m, l = ref.paged_span_partials(q, kp, vp, bt, qs, ql)
    drop = l.clone()
    drop[..., 1] = 0
    no_m = torch.where(l > 0, m.amax(-1, keepdim=True), m)
    return {"span 1 left out": ref.merge_span_partials(o, m, drop, ql),
            "merge ignores m": ref.merge_span_partials(o, no_m, l, ql)}


def split_check(tag, got, q, kp, vp, bt, qs, ql) -> None:
    """Hold a bf16 fused-kernel output to the f32 split plain version on
    the same inputs at REL_TOL, and show that each planted fault breaks
    that tolerance on these inputs."""
    from repro_torch.kernels import ref
    f32 = [x.float() for x in (q, kp, vp)]
    want = ref.paged_prefill_attention_split_ref(*f32, bt, qs, ql)
    err = row_scaled_err(got, want, ql)
    faults = {k: row_scaled_err(w, want, ql)
              for k, w in planted_faults(*f32, bt, qs, ql).items()}
    log(f"[kernels] {tag}: bf16 fused kernel vs f32 split plain, per row "
        f"relative {err} (tol {REL_TOL}); planted faults: {faults}")
    check(err <= REL_TOL, f"{tag}: bf16 vs f32 split plain {err}")
    for k, v in faults.items():
        check(v > REL_TOL, f"{tag}: the tolerance misses a planted fault "
              f"({k}: {v})")


def kernels_phase(dev) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import (
        paged_attention, paged_prefill_attention)
    g = torch.Generator(device=dev).manual_seed(SEED)
    timer = Timer(dev)
    B, Q = 8, 16                              # the engine phase's round
    ctx = [300, 170, 411, 96, 250, 333, 128, 0]
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, kp, vp, bt, qs, ql = kernel_case(dev, dtype, B, Q, ctx, g)
        got = paged_prefill_attention(q, kp, vp, bt, qs, ql)
        want = ref.paged_prefill_attention_ref(q, kp, vp, bt, qs, ql)
        torch.cuda.synchronize()
        check(torch.isfinite(got).all().item(), "fused kernel: non-finite")
        e_f = max_valid_err(got, want, ql)
        sl = qs + 1
        qd = q[:, 0].contiguous()
        got_d = paged_attention(qd, kp, vp, bt, sl)
        want_d = ref.paged_attention_ref(qd, kp, vp, bt, sl)
        fused_q1 = paged_prefill_attention(q[:, :1].contiguous(), kp, vp,
                                           bt, qs, torch.ones_like(ql))
        torch.cuda.synchronize()
        e_d = (got_d.float() - want_d.float()).abs().max().item()
        bitwise = torch.equal(fused_q1[:, 0], got_d)
        # row independence: the decode rows of the mixed Q = 16 launch
        # are the decode kernel's rows, bit for bit
        dec_rows = (ql == 1).nonzero().flatten()
        mixed = torch.equal(got[dec_rows, 0], got_d[dec_rows])
        name = str(dtype).replace("torch.", "")
        log(f"[kernels] {name}: paged_prefill_attention max_abs_err {e_f} "
            f"paged_attention max_abs_err {e_d} (tol {TOL[dtype]}); "
            f"fused Q=1 == decode bitwise: {bitwise}; decode rows of the "
            f"mixed launch == decode kernel bitwise: {mixed}")
        check(e_f <= TOL[dtype], f"paged_prefill_attention {name}: "
              f"err {e_f} > {TOL[dtype]}")
        check(e_d <= TOL[dtype], f"paged_attention {name}: "
              f"err {e_d} > {TOL[dtype]}")
        check(bitwise, f"{name}: fused kernel at Q=1 != decode kernel")
        check(mixed, f"{name}: decode rows of the mixed launch != decode "
              "kernel")
        if dtype != torch.bfloat16:
            continue
        # the bf16 kernels against the plain version in f32 on the same
        # bf16 inputs (output unrounded). Tolerance: the bf16 one, 2e-2;
        # the kernels round P to bf16 before PV (2^-9 relative per
        # weight) and their output to bf16, the f32 plain version neither
        f32 = [x.float() for x in (q, kp, vp)]
        e_f32 = max_valid_err(got, ref.paged_prefill_attention_ref(
            *f32, bt, qs, ql), ql)
        e_d32 = (got_d.float() - ref.paged_attention_ref(
            f32[0][:, 0].contiguous(), *f32[1:], bt, sl)).abs().max().item()
        log(f"[kernels] bf16 kernels vs f32 plain on the same inputs: "
            f"paged_prefill_attention {e_f32}, paged_attention {e_d32} "
            f"(tol {TOL[dtype]})")
        check(max(e_f32, e_d32) <= TOL[dtype],
              f"bf16 paged kernels vs f32 plain: {e_f32} / {e_d32}")
        split_check("engine round", got, q, kp, vp, bt, qs, ql)
        # the engine's dtype: time kernel, plain version and yardstick
        for kname, fn, plain, args, err, dec in (
                ("paged_prefill_attention", paged_prefill_attention,
                 ref.paged_prefill_attention_ref, (q, kp, vp, bt, qs, ql),
                 e_f, False),
                ("paged_attention", paged_attention,
                 ref.paged_attention_ref, (qd, kp, vp, bt, sl), e_d,
                 True)):
            ms = timer(lambda: fn(*args))
            plain_ms = timer(lambda: plain(*args))
            lens = None if dec else ql
            lib = sdpa_yardstick(args[0], kp, vp, bt, args[4], lens, dec)
            lib_ms = timer(lib)
            bound_ms, bound_by = attention_bound(args[0], kp, args[4],
                                                 lens, dec)
            rows[kname] = dict(name=kname, route="cuda",
                               source=SOURCES[kname],
                               replaces=REPLACES[kname], launches=0,
                               max_abs_err=err, ms=ms, plain_ms=plain_ms,
                               bound_ms=bound_ms, bound_by=bound_by,
                               library_ms=lib_ms)
            log(f"[kernels] {kname} bf16 B={B} Q={1 if dec else Q} "
                f"ctx={ctx}: {ms:.4f} ms (plain {plain_ms:.4f} ms, sdpa "
                f"{lib_ms:.4f} ms, bound {bound_ms:.5f} ms by {bound_by})")
    long_context_rows(dev, timer, g)
    return rows


def long_context_rows(dev, timer, g) -> None:
    """Logged, not in the kernel rows: the paged kernels at thousands of
    tokens of context (the engine's round shape), and one decode row
    alone, a grid the sequence split has to fill. Each row walks up to
    33 spans: in f32 the kernels hold the plain version to 2e-5, split
    and merge included; in bf16 ``split_check`` holds the fused kernel to
    the f32 split plain version per row. Timed in bf16."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import (
        paged_attention, paged_prefill_attention)
    cases = (("round", 8, 16, [4000, 3500, 3900, 2800, 4080, 3000, 3700,
                                0]),
             ("one row", 1, 1, [4096]))
    for tag, B, Q, ctx in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q, kp, vp, bt, qs, ql = kernel_case(dev, dtype, B, Q, ctx, g)
            if B == 1:
                ql = torch.ones_like(ql)
            sl = qs + 1
            qd = q[:, 0].contiguous()
            got = paged_prefill_attention(q, kp, vp, bt, qs, ql)
            got_d = paged_attention(qd, kp, vp, bt, sl)
            e_f = max_valid_err(got, ref.paged_prefill_attention_ref(
                q, kp, vp, bt, qs, ql), ql)
            e_d = (got_d.float() - ref.paged_attention_ref(
                qd, kp, vp, bt, sl).float()).abs().max().item()
            torch.cuda.synchronize()
            name = str(dtype).replace("torch.", "")
            log(f"[kernels] long context, {tag}, {name}: max_abs_err "
                f"paged_prefill_attention {e_f}, paged_attention {e_d} "
                f"(tol {TOL[dtype]})")
            check(max(e_f, e_d) <= TOL[dtype],
                  f"long context {tag} {name}: err {e_f} / {e_d}")
            if dtype != torch.bfloat16:
                continue
            split_check(f"long context, {tag}", got, q, kp, vp, bt, qs, ql)
            for kname, fn, args, dec in (
                    ("paged_prefill_attention", paged_prefill_attention,
                     (q, kp, vp, bt, qs, ql), False),
                    ("paged_attention", paged_attention,
                     (qd, kp, vp, bt, sl), True)):
                lens = None if dec else ql
                ms = timer(lambda: fn(*args))
                lib_ms = timer(sdpa_yardstick(args[0], kp, vp, bt, args[4],
                                              lens, dec))
                bound_ms, bound_by = attention_bound(args[0], kp, args[4],
                                                     lens, dec)
                log(f"[kernels] long context, {tag}: {kname} bf16 B={B} "
                    f"Q={1 if dec else Q} ctx={ctx}: {ms:.4f} ms (sdpa "
                    f"{lib_ms:.4f} ms, bound {bound_ms:.5f} ms by "
                    f"{bound_by})")


def prefill_kernels_phase(dev) -> dict:
    """(k) ``flash_prefill`` at qwen2-1.5b heads and ``ssd_scan`` at
    mamba2-1.3b heads against their plain versions in both types (and
    ``ssd_scan`` with B/C per group, bf16 beside f32 X); each timed at
    its main-path shape and type beside its plain version, its bound and
    (for attention) SDPA."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models.ssm import ssd_chunked
    F = torch.nn.functional
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    timer = Timer(dev)
    rows = {}

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    flash_cases = [  # B, Hq, Hkv, Sq, Skv, D, window, q_offset
        (1, 12, 2, 512, 512, 128, None, 0),
        (1, 12, 2, 2048, 2048, 128, None, 0),
        (1, 12, 2, 300, 300, 128, 128, 0),       # sliding window
        (1, 12, 2, 200, 456, 128, None, 256),    # chunk after a prefix
    ]
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        for B, Hq, Hkv, Sq, Skv, D, window, q_offset in flash_cases:
            q = randn(B, Hq, Sq, D).to(dtype)
            k = randn(B, Hkv, Skv, D).to(dtype)
            v = randn(B, Hkv, Skv, D).to(dtype)
            kw = dict(window=window, q_offset=q_offset)
            got = flash_prefill(q, k, v, **kw)
            want = ref.flash_prefill_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            err, ok = allclose_err(got, want, TOL[dtype])
            log(f"[kernels] {name}: flash_prefill Sq={Sq} Skv={Skv} "
                f"window={window} q_offset={q_offset}: max_abs_err {err} "
                f"(tol {TOL[dtype]})")
            check(torch.isfinite(got).all().item() and ok,
                  f"flash_prefill {name} Sq={Sq}: err {err}")
            if dtype == torch.bfloat16:
                # against the plain version in f32 on the same bf16
                # inputs: P is rounded to bf16 before PV (tol 2e-2)
                e32, ok32 = allclose_err(got, ref.flash_prefill_ref(
                    q.float(), k.float(), v.float(), **kw), TOL[dtype])
                log(f"[kernels] bf16 flash_prefill vs f32 plain on the "
                    f"same inputs: max_abs_err {e32} (tol {TOL[dtype]})")
                check(ok32, f"bf16 flash_prefill vs f32 plain: {e32}")
            if dtype == torch.bfloat16 and Sq == 2048:
                # the engine's type at its longest prompt
                ms = timer(lambda: flash_prefill(q, k, v))
                plain_ms = timer(lambda: ref.flash_prefill_ref(q, k, v))
                lib_ms = timer(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True))
                bound_ms, bound_by = flash_bound(q, k, None, 0)
                rows["flash_prefill"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms)
    f32, bf16 = torch.float32, torch.bfloat16
    ssd_cases = [  # b, l, h, g, p, n, chunk, X/dA type, B/C type
        (1, 2048, 64, 64, 64, 128, 256, f32, f32),  # the per-head form
        (1, 192, 64, 64, 64, 128, 64, f32, f32),    # a short prompt's chunk
        (1, 2048, 64, 64, 64, 128, 256, bf16, bf16),
        (1, 192, 64, 64, 64, 128, 64, bf16, bf16),
        (1, 2048, 64, 1, 64, 128, 256, f32, bf16),  # the model's form
        (1, 512, 64, 8, 64, 128, 256, f32, bf16),   # 1 < G < H
        (1, 512, 64, 8, 64, 128, 256, f32, f32),
    ]
    for b, l, h, grp, p, n, cs, xt, bt in ssd_cases:
        name = f"X {str(xt)[6:]}, B/C {str(bt)[6:]} G={grp}"
        X = randn(b, l, h, p, scale=0.5).to(xt)
        dA = (-randn(b, l, h).abs() * 0.3).to(xt)
        Bm = randn(b, l, grp, n, scale=0.5).to(bt)
        Cm = randn(b, l, grp, n, scale=0.5).to(bt)
        Y, st = ssd_scan(X, dA, Bm, Cm, chunk=cs)

        def plain():  # the wrapper's plain version: B/C over the heads
            return ssd_chunked(X.float(), dA.float(), *(
                t.float().repeat_interleave(h // grp, dim=2)
                for t in (Bm, Cm)), cs)
        Yw, stw = plain()
        torch.cuda.synchronize()
        # a bf16 B/C value upcasts exactly: the tolerance is X's type's
        e_y, ok_y = allclose_err(Y, Yw, SSD_TOL[xt])
        e_s, ok_s = allclose_err(st, stw, SSD_TOL[xt])
        log(f"[kernels] {name}: ssd_scan L={l} chunk={cs}: Y max_abs_err "
            f"{e_y}, state max_abs_err {e_s} (tol {SSD_TOL[xt]} abs and "
            "rel)")
        check(torch.isfinite(Y).all().item() and ok_y and ok_s,
              f"ssd_scan {name} L={l}: err {e_y} / {e_s}")
        if l == 2048 and xt == f32:
            ms = timer(lambda: ssd_scan(X, dA, Bm, Cm, chunk=cs))
            plain_ms = timer(plain)
            bound_ms, bound_by = ssd_bound(X, Bm, cs)
            old_ms = ssd_bound_per_head(X, n, cs)
            log(f"[kernels] ssd_scan {name} L={l}: {ms:.4f} ms (plain "
                f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms by "
                f"{bound_by}; earlier per-head bound {old_ms:.5f} ms)")
            if grp == 1:  # the model's form is the row
                rows["ssd_scan"] = dict(
                    max_abs_err=max(e_y, e_s), ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    for kname, r in rows.items():
        r.update(name=kname, route="cuda", source=SOURCES[kname],
                 replaces=REPLACES[kname], launches=0)
        lib = "none" if r["library_ms"] is None \
            else f"{r['library_ms']:.4f} ms"
        log(f"[kernels] {kname}: {r['ms']:.4f} ms (plain "
            f"{r['plain_ms']:.4f} ms, library {lib}, bound "
            f"{r['bound_ms']:.5f} ms by {r['bound_by']})")
    return rows


def mixed_trace(eng, rng, n_sessions: int, max_new: int, chunk: int):
    """submit_turn/run_round with chunked prefill grants interleaved with
    decode: half the sessions start at once, the rest a few rounds
    later, so prefill chunks share rounds with decoding slots. Returns
    (per-session tokens, rounds, fed tokens, seconds)."""
    from repro_torch.core.session import Phase
    V = eng.cfg.vocab_size
    lens = rng.integers(64, 320, size=n_sessions)
    prompts = [rng.integers(0, V, size=int(n)) for n in lens]
    slots = {}
    fed = rounds = 0
    t0 = time.perf_counter()
    for i in range(n_sessions // 2):
        slots[eng.submit_turn(f"s{i}", prompts[i], max_new)] = f"s{i}"
    while eng.active() or len(slots) < n_sessions:
        if rounds == 3:
            for i in range(n_sessions // 2, n_sessions):
                slots[eng.submit_turn(f"s{i}", prompts[i], max_new)] = \
                    f"s{i}"
        grants = {}
        for s in eng.active():
            slot = next(k for k, v in eng.slot_state.items() if v is s)
            r = s.request
            grants[slot] = min(chunk, r.prompt_len - r.prefilled) \
                if r.phase == Phase.PREFILL else 1
        fed += sum(grants.values())
        eng.run_round(grants)
        rounds += 1
        check(rounds < 2000, "trace did not finish")
    secs = time.perf_counter() - t0
    toks = {sid: eng.sessions[sid].history[-1] for sid in slots.values()}
    return toks, rounds, fed, secs


def engine_phase(dev) -> dict:
    from repro_torch.launch.serve import build_demo
    from repro_torch.serving.paged_engine import PagedRealtimeEngine
    t0 = time.perf_counter()
    cfg, params, kw = build_demo("qwen2-1.5b", dev, SEED)
    torch.cuda.synchronize()
    check(cfg.num_layers == 28 and cfg.d_model == 1536
          and params["embed"].dtype == torch.bfloat16,
          "not full-width qwen2-1.5b in bf16")
    log(f"[engine] {cfg.name}: {cfg.num_layers} layers d={cfg.d_model} "
        f"bf16 random weights (seed {SEED}) in "
        f"{time.perf_counter() - t0:.1f} s")
    # (a) the scripted multi-turn demo on the fused plane
    histories = run_demo(cfg, params, kw, fused=True, tag="(a)")
    # (b) submit_turn/run_round on both planes
    planes = {}
    for fused in (True, False):
        eng = PagedRealtimeEngine(cfg, params, slots=8, page_size=16,
                                  pages_per_seq=32, device=dev,
                                  fused_step=fused)
        bad = []
        eng.logit_tap = lambda sid, lg, bad=bad: \
            bad.append(sid) if not np.isfinite(lg).all() else None
        toks, rounds, fed, secs = mixed_trace(
            eng, np.random.default_rng(SEED), 8, 24, 16)
        eng.check_invariants()
        name = "fused" if fused else "per-token"
        check(not bad, f"{name}: non-finite logits for {bad}")
        check(all(len(t) == 24 for t in toks.values()),
              f"{name}: turns did not run to their cap")
        planes[name] = dict(tokens=toks, rounds=rounds, fed=fed, secs=secs)
        log(f"[engine] (b) {name} plane: {rounds} rounds, {fed} tokens fed "
            f"in {secs:.2f} s = {secs / rounds * 1e3:.2f} ms/round, "
            f"{fed / secs:.1f} tokens/s")
    same = sum(planes["fused"]["tokens"][s] == planes["per-token"]["tokens"][s]
               for s in planes["fused"]["tokens"])
    log(f"[engine] (b) sessions with identical tokens on both planes: "
        f"{same}/8 (bf16: matmuls of other shapes round differently)")
    profile_rounds(cfg, params, dev)
    return dict(params=params, cfg=cfg, planes=planes, kw=kw,
                histories=histories)


def run_demo(cfg, params, kw, *, fused: bool, tag: str) -> dict:
    """The scripted multi-turn demo on one plane, checked against the
    JAX demo's counts (5 evictions, 1 sync reload, 1 preload admitted
    and hit). Returns its engine's token histories."""
    from repro_torch.serving import paged_engine as pe
    made = []

    class Captured(pe.PagedRealtimeEngine):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)
    t0 = time.perf_counter()
    orig, pe.PagedRealtimeEngine = pe.PagedRealtimeEngine, Captured
    try:
        out = pe.run_multiturn_demo(cfg, params, fused_step=fused,
                                    log=lambda *_a: None, **kw)
    finally:
        pe.PagedRealtimeEngine = orig
    secs = time.perf_counter() - t0
    pre = out["preload"]
    gen = {s: [t["generated"] for t in ts] for s, ts in out["turns"].items()}
    log(f"[engine] {tag} demo ({'fused' if fused else 'per-token'} plane) "
        f"in {secs:.1f} s: evictions {out['offload_events']}, preload "
        f"{pre}, generated {gen}")
    check(out["offload_events"] == 5, "demo did not evict 5 times")
    check(pre["sync_fallbacks"] == 1, "demo took no sync reload")
    check(pre["admitted"] == 1 and pre["hits"] == 1,
          "demo had no preload admitted and hit")
    n = kw["token_scale"]                 # alice's turn 2 is barged at 4
    check(gen == {"alice": [10 * n, 4, 6 * n], "bob": [26 * n, 6 * n]},
          f"demo turns generated {gen}")
    return {sid: x.history for sid, x in made[0].sessions.items()}


def tokenwise_demo_phase(cfg, params, kw, fused_histories) -> None:
    """(a') the demo on the per-token plane: turns 0 take the dense
    prefill graft; its token histories must be the fused demo's."""
    hist = run_demo(cfg, params, kw, fused=False, tag="(a')")
    same = sum(hist[s] == fused_histories[s] for s in hist)
    log(f"[engine] (a') sessions with the fused demo's histories: "
        f"{same}/{len(hist)}")
    if hist != fused_histories:
        # tell bf16 rounding from a fault: in f32 the kernels agree with
        # their plain versions to 2e-5, so both planes must agree there
        c32 = cfg.replace(dtype="float32", param_dtype="float32")
        p32 = cast_params(params, torch.float32)
        h32 = {fused: run_demo(c32, p32, kw, fused=fused,
                               tag=f"(a') f32 diagnosis, fused={fused}")
               for fused in (True, False)}
        log(f"[engine] (a') f32 diagnosis: both planes' histories equal: "
            f"{h32[True] == h32[False]}")
    check(hist == fused_histories, "per-token demo histories differ from "
          "the fused demo's")


def greedy(cfg, params, prompt, n, capacity, dev):
    """B = 1 greedy reference through the model's own prefill and
    decode_step."""
    from repro_torch.models.model import decode_step, init_cache, prefill
    cache = init_cache(cfg, 1, capacity, dev)
    logits, cache = prefill(cfg, params, torch.as_tensor(
        prompt, device=dev)[None, :], cache)
    toks = [int(torch.argmax(logits[0]))]
    for _ in range(n - 1):
        lg, cache = decode_step(cfg, params,
                                torch.tensor([toks[-1]], device=dev), cache)
        toks.append(int(torch.argmax(lg[0])))
    return toks


def single_turn_serve(cfg, params, dev, prompts, n_new, capacity) -> dict:
    """The main path of (c)/(d): every prompt admitted into its own slot
    of ``RealtimeLLMEngine`` (one B = 1 prefill each), then decoded
    together to completion."""
    from repro_torch.serving.engine import RealtimeLLMEngine
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = RealtimeLLMEngine(cfg, params, slots=len(prompts),
                            capacity=capacity, device=dev)
    for sid, p in prompts.items():
        eng.add_session(sid, p, max_new_tokens=n_new)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    rounds = 0
    while eng.active():
        eng.step()
        rounds += 1
        check(rounds < 10 * n_new, "single-turn engine did not finish")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    out = {s.session_id: s.tokens for s in eng.slot_state.values()}
    log(f"[single] {cfg.name}: {len(prompts)} prompts of "
        f"{[len(p) for p in prompts.values()]} tokens admitted in "
        f"{t_prefill:.2f} s; {rounds} decode rounds; {secs:.2f} s in all")
    return out


def single_turn_check(cfg, params, dev, prompts, out, n_new, capacity):
    """Each session's tokens against the B = 1 greedy reference, and a
    full-width prefill of the longest prompt through the kernels against
    one through their plain versions."""
    from repro_torch.models.model import init_cache, prefill
    same = {sid: out[sid] == greedy(cfg, params, p, n_new, capacity, dev)
            for sid, p in prompts.items()}
    log(f"[single] {cfg.name}: sessions with the greedy reference's "
        f"tokens: {sum(same.values())}/{len(same)}; "
        f"first tokens {[out[s][:6] for s in sorted(out)]}")
    check(all(same.values()), f"{cfg.name}: engine tokens differ from the "
          f"greedy reference for {[s for s, ok in same.items() if not ok]}")
    for s in out:
        check(len(out[s]) == n_new, f"{s}: {len(out[s])} tokens")
    longest = max(prompts.values(), key=len)
    tok = torch.as_tensor(longest, device=dev)[None, :]
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype)[6:]
        c = cfg.replace(dtype=name, param_dtype=name)
        p = cast_params(params, dtype)
        got = prefill(c, p, tok, init_cache(c, 1, capacity, dev))[0]
        want = prefill(c, p, tok, init_cache(c, 1, capacity, dev),
                       plain=True)[0]
        torch.cuda.synchronize()
        check(torch.isfinite(got).all().item(),
              f"{cfg.name}: prefill logits non-finite")
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        # the kernels sum in f32 in another order than the plain
        # versions. f32: ~1e-6 relative per layer output, carried
        # through up to 48 layers: 1e-4 of the logits' scale. bf16: each
        # layer's output is rounded to bf16, so those differences flip
        # ulps (~4e-3 relative) that carry through the depth: 3e-2.
        tol = (1e-4 if dtype == torch.float32 else 3e-2) * scale
        agree = bool(got.argmax() == want.argmax())
        log(f"[single] {cfg.name} {name}: {len(longest)}-token prefill, "
            f"kernels vs plain: logits max_abs_err {err:.3e} (scale "
            f"{scale:.2f}, tol {tol:.3e}), argmax equal {agree}")
        check(err <= tol, f"{cfg.name} {name} prefill: {err} > {tol}")


def prompts_for(cfg, rng, lens) -> dict:
    return {f"s{i}": rng.integers(0, cfg.vocab_size, size=int(n))
            for i, n in enumerate(lens)}


def device_us_by_kernel(prof) -> dict:
    """{kernel name: device µs} summed over a ``torch.profiler`` run."""
    from torch.autograd import DeviceType
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us()
    return by_name


def profile_rounds(cfg, params, dev) -> None:
    """Where a fused round's time goes: the same trace once more under
    ``torch.profiler`` (its overhead stays out of the timings above).
    Prints the device's busy share of the wall time and the kernels
    that took the most device time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.paged_engine import PagedRealtimeEngine
    eng = PagedRealtimeEngine(cfg, params, slots=8, page_size=16,
                              pages_per_seq=32, device=dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, rounds, _, _ = mixed_trace(eng, np.random.default_rng(SEED),
                                      8, 24, 16)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = device_us_by_kernel(prof)
    busy = sum(by_name.values())
    if not busy:
        log("[profile] the profiler saw no device activity: device busy "
            "share not measured")
        return
    log(f"[profile] fused plane under the profiler: {rounds} rounds in "
        f"{wall_us / 1e3:.1f} ms wall; device busy {busy / 1e3:.1f} ms = "
        f"{100 * busy / wall_us:.1f}% of wall")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[profile]   {us / 1e3:8.2f} ms  {100 * us / busy:5.1f}%  "
            f"{name[:90]}")


def profile_prefill(cfg, params, dev, prompt, capacity) -> None:
    """(d) Where a full-width mamba2 prefill's time goes. One B = 1
    prefill of ``prompt`` unprofiled, timed on the host clock when it
    returns (the host has enqueued every launch) and when the device is
    done; then one under ``torch.profiler``. Prints the device ms of the
    ``ssd_scan`` kernels and their share of the prefill's device time,
    the kernels that took the most, and the host ops that took the most
    host time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.model import init_cache, prefill
    tok = torch.as_tensor(prompt, device=dev)[None, :]
    prefill(cfg, params, tok, init_cache(cfg, 1, capacity, dev))
    cache = init_cache(cfg, 1, capacity, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill(cfg, params, tok, cache)
    t_host = time.perf_counter() - t0
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    log(f"[profile] {cfg.name} {len(prompt)}-token prefill, unprofiled: "
        f"returned to the host after {t_host * 1e3:.2f} ms, device done "
        f"after {t_all * 1e3:.2f} ms")
    cache = init_cache(cfg, 1, capacity, dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prefill(cfg, params, tok, cache)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = device_us_by_kernel(prof)
    busy = sum(by_name.values())
    if not busy:
        log("[profile] the profiler saw no device activity: the ssd "
            "share of a prefill not measured")
        return
    ssd_us = sum(us for name, us in by_name.items() if "ssd_" in name)
    log(f"[profile] {cfg.name} {len(prompt)}-token prefill under the "
        f"profiler: {wall_us / 1e3:.2f} ms wall; device busy "
        f"{busy / 1e3:.2f} ms = {100 * busy / wall_us:.1f}% of wall; "
        f"ssd_scan kernels {ssd_us / 1e3:.3f} ms = "
        f"{100 * ssd_us / busy:.1f}% of device busy")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"[profile]   {us / 1e3:8.3f} ms  {100 * us / busy:5.1f}%  "
            f"{name[:90]}")
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
    for a in host[:8]:
        log(f"[profile]   host {a.self_cpu_time_total / 1e3:8.3f} ms  "
            f"{a.count:6d} calls  {a.key[:70]}")


def step_phase(dev, cfg, params) -> None:
    """(c) One fused step and one per-token step through the kernels
    and through the plain versions (the steps' explicit test-only
    ``plain`` argument) on the same page store, in bf16 (the engine's
    type) and in f32."""
    from repro_torch.serving.paged_engine import (paged_decode_step,
                                                  paged_fused_step)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    B, page, pps, C = 8, 16, 32, 256
    for dtype in (torch.bfloat16, torch.float32):
        c = cfg.replace(dtype=str(dtype).replace("torch.", ""),
                        param_dtype=str(dtype).replace("torch.", ""))
        p = cast_params(params, dtype)             # no copy in bf16
        P = B * pps
        shape = (c.num_layers, P + 1, page, c.num_kv_heads,
                 c.resolved_head_dim)
        kp = torch.zeros(shape, dtype=dtype, device=dev)
        vp = torch.zeros_like(kp)
        bt = torch.randperm(P, generator=g, device=dev).reshape(B, pps) \
            .int()
        ctx = torch.tensor([200, 256, 97, 150, 31, 222, 180, 0],
                           device=dev)

        def tables(start, n, Q):
            t = torch.arange(Q, device=dev)
            pos = start[:, None] + t[None, :]
            live = t[None, :] < n[:, None]
            pg = torch.where(live, bt.long().gather(
                1, (pos // page).clamp(max=pps - 1)), P)
            sl = torch.where(live, pos % page, t[None, :] % page)
            return pos.int(), pg, sl
        # fill each row's context with one fused prefill step
        toks = torch.randint(0, c.vocab_size, (B, C), generator=g,
                             device=dev)
        pos, pg, sl = tables(torch.zeros_like(ctx), ctx, C)
        paged_fused_step(c, p, toks, pos, kp, vp, bt,
                         torch.zeros_like(ctx).int(), ctx.int(), pg, sl)
        # one mixed round: rows 0-1 prefill 16 tokens, 2-6 decode, 7 pads
        n = torch.tensor([16, 16, 1, 1, 1, 1, 1, 0], device=dev)
        pos, pg, sl = tables(ctx, n, 16)
        toks = torch.randint(0, c.vocab_size, (B, 16), generator=g,
                             device=dev)
        k0, v0 = kp.clone(), vp.clone()
        args = (toks, pos, kp, vp, bt, ctx.int(), n.int(), pg, sl)
        got = paged_fused_step(c, p, *args)
        kp.copy_(k0), vp.copy_(v0)
        want = paged_fused_step(c, p, *args, plain=True)
        kp.copy_(k0), vp.copy_(v0)
        dargs = (toks[:, 0], pos[:, 0], kp, vp, bt, (ctx + 1).int(),
                 pg[:, 0], sl[:, 0])
        got_d = paged_decode_step(c, p, *dargs)
        kp.copy_(k0), vp.copy_(v0)
        want_d = paged_decode_step(c, p, *dargs, plain=True)
        torch.cuda.synchronize()
        live = n > 0
        for what, a, b in (("fused", got[live], want[live]),
                           ("per-token", got_d, want_d)):
            check(torch.isfinite(a).all().item(), f"{what} step non-finite")
            err = (a - b).abs().max().item()
            scale = b.abs().max().item()
            agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
            # f32: kernel and plain version differ by f32 summation
            # order (~1e-7 relative per attention call), which 28 layers
            # carry to ~1e-6 of the logits' scale: 1e-5 of scale. bf16:
            # each layer rounds its attention output to bf16, so one-ulp
            # differences (~4e-3 relative) propagate through 28 layers
            # (~7e-3 of scale on the H100): 3e-2 of scale.
            tol = (1e-5 if dtype == torch.float32 else 3e-2) * scale
            log(f"[step] {what} step {str(dtype)[6:]}: logits max_abs_err "
                f"{err:.3e} (scale {scale:.2f}, tol {tol:.3e}), argmax "
                f"agreement {agree:.3f}")
            check(err <= tol, f"{what} step {dtype}: {err} > {tol}")


def cast_params(tree, dtype, key=None):
    """Every leaf to ``dtype`` (no copy where it already is), except the
    mixer's leaves that stay f32 at any type."""
    from repro_torch.models.model import F32_LEAVES
    if isinstance(tree, dict):
        return {k: cast_params(v, dtype, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast_params(v, dtype) for v in tree]
    return tree if key in F32_LEAVES else tree.to(dtype)


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


def kernel_counts() -> dict:
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.paged_attention import (
        paged_attention, paged_prefill_attention)
    from repro_torch.kernels.ssd_scan import ssd_scan
    return {"paged_prefill_attention": paged_prefill_attention,
            "paged_attention": paged_attention,
            "flash_prefill": flash_prefill, "ssd_scan": ssd_scan}


def main_path(tag, fn, *args):
    """Drive one main path with every kernel's count zeroed just before
    and read just after. Returns (fn's result, counts)."""
    wrappers = kernel_counts()
    for w in wrappers.values():
        w.launches = 0
    out = fn(*args)
    counts = {n: w.launches for n, w in wrappers.items()}
    log(f"[launches] {tag}: {counts}")
    return out, counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.models.model import init_params
    dev = resolve_device("cuda")
    t_start = time.perf_counter()
    card_line = card()
    log(f"[card] {card_line}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    build_kernels()
    rows = kernels_phase(dev)
    rows.update(prefill_kernels_phase(dev))
    total = dict.fromkeys(rows, 0)

    def add(counts, expect):
        for name, n in counts.items():
            total[name] += n
        for name, n in expect.items():
            check(counts[name] == n if n else counts[name] > 0,
                  f"{name}: {counts[name]} launches, expected "
                  f"{n or 'some'}")

    # the paged engine, both planes: (a), (b) and the profiled window
    eng, counts = main_path("paged engine (a)+(b)", engine_phase, dev)
    add(counts, {"paged_prefill_attention": 0, "paged_attention": 0})
    cfg, params = eng["cfg"], eng["params"]
    # (a') the per-token demo: turns 0 of alice and bob take the graft
    _, counts = main_path("per-token demo (a')", tokenwise_demo_phase, cfg,
                          params, eng["kw"], eng["histories"])
    add(counts, {"paged_attention": 0,
                 "flash_prefill": 2 * cfg.num_layers})
    step_phase(dev, cfg, params)
    # (c) the dense single-turn engine: 4 slots, capacity 4096
    rng = np.random.default_rng(SEED)
    prompts = prompts_for(cfg, rng, [2048, *rng.integers(256, 2048, 3)])
    out, counts = main_path("single-turn qwen2-1.5b (c)", single_turn_serve,
                            cfg, params, dev, prompts, 32, 4096)
    add(counts, {"flash_prefill": len(prompts) * cfg.num_layers})
    single_turn_check(cfg, params, dev, prompts, out, 32, 4096)
    del eng, params
    # (d) mamba2-1.3b at full width; prompts no multiple of its chunk
    t0 = time.perf_counter()
    mcfg = get_config("mamba2-1.3b")
    mparams = init_params(mcfg, torch.Generator(device=dev).manual_seed(
        SEED), dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(mparams))
    log(f"[single] {mcfg.name}: {mcfg.num_layers} layers d={mcfg.d_model} "
        f"{n_params / 1e9:.3f} B parameters in bf16, random weights (seed "
        f"{SEED}) in {time.perf_counter() - t0:.1f} s")
    # num_params counts the matrices and convs, not the norms and biases
    check(mcfg.num_layers == 48 and mcfg.d_model == 2048
          and mparams["embed"].dtype == torch.bfloat16
          and abs(n_params / mcfg.num_params() - 1) < 1e-3,
          "not full-width mamba2-1.3b")
    lens = [2000, *rng.integers(256, 2048, 3)]
    lens = [n + 1 if n % mcfg.ssm.chunk_size == 0 else n for n in lens]
    prompts = prompts_for(mcfg, rng, lens)
    out, counts = main_path("single-turn mamba2-1.3b (d)",
                            single_turn_serve, mcfg, mparams, dev, prompts,
                            32, 4096)
    add(counts, {"ssd_scan": len(prompts) * mcfg.num_layers})
    single_turn_check(mcfg, mparams, dev, prompts, out, 32, 4096)
    profile_prefill(mcfg, mparams, dev, prompts["s0"], 4096)
    for name, n in total.items():
        check(n > 0, f"{name} never launched on a main path")
        rows[name]["launches"] = n
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [rows[n] for n in SOURCES]}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
