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
- (e) the paged engine's feature planes on qwen2-1.5b: (e1) eight
  sessions sharing a 250-token system prompt on the prefix plane (a
  copy-on-write of the shared tail page included) against the
  ``prefix_cache=False`` twin, (e2) phase (b)'s trace with three-token
  n-gram drafts against its K = 0 tokens, (e3) the int8 wire tier's
  quality gate and the quantizer's bound on real offloaded pages; the
  twins' streams must agree in f32, where only a fault can part them;
- (f) the front end on qwen2-1.5b: (f1) the live asyncio gateway
  (``run_gateway_workload``) serving 8 interactive sessions with
  barge-ins on the wall clock at scale 1 under the liveserve policy and
  (f2) the same trace under fcfs, each held to what the trace
  determines; (f3) the virtual-time replay twin (``run_replay``) on a
  pool tight enough to evict, with the next-use eviction oracle, on
  both planes in f32 (identical streams and turn records) and in bf16;
- (g) the sharded page plane (``mesh=``): (g0) the paged kernels'
  sharding options (``pos_stride``, ``pos_offset``, ``return_stats``) at
  the engine's shapes in one process, against the plain version, the
  stripe merge and the unsharded kernel; then meshes of 2 (heads), 4
  (slots) and 3 (replicated) ranks that share the card and talk gloo
  through host memory, each rank a process of its own: (g1) the
  global-view sharded kernels (and ``sharded_flash_prefill``) against
  the single-device kernels, (g2) the sharded engine at full width:
  phase (b)'s trace at M 2 in bf16 and M 4 in f32, token for token the
  single-device engine's (M 4 in bf16 logged), a short per-token trace
  at M 4 (the decode kernel with stats, the dense graft) and phase
  (f3)'s replay at M 4 in f32, record for record the single-device
  run's; the ranks' launch counts are summed into the kernels' line;
- (h) the replica fleet on qwen2-1.5b: three paged engines in this
  process sharing the one set of weights, behind one gateway: (h1) the
  fleet twin (``run_fleet_replay``) on a barge-free agent-handoff trace
  in f32, its router decisions the ones the trace predicts, every
  session's stream the single-replica run's, each migrated session's
  pages read through the device plane bit for bit on both replicas,
  the wire bytes those of the moved pages; (h2) the fleet twin in bf16
  with barge-ins, a drained replica and pools that evict: every plan
  done or cancelled as the decision log says, the drained replica
  empty; (h3) the live fleet gateway (``run_fleet_workload``) serving 12
  interactive sessions on the wall clock at scale 1 with a drained
  replica's sessions live-migrating; (h4) the launcher's ``--replicas 3
  --workload handoff``;

and checks what comes out. Every phase is checked; any failure exits
non-zero. The last line of standard output is

  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

It exits non-zero without a result when no CUDA device is present or
when the package it tests is not beside it.
"""
from __future__ import annotations

import dataclasses
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


def round_grants(eng, chunk: int, decode_grant: int) -> dict:
    """One round's grants for every live slot: up to ``chunk`` prompt
    tokens for a PREFILL slot, ``decode_grant`` for a decode slot."""
    from repro_torch.core.session import Phase
    grants = {}
    for s in eng.active():
        slot = next(k for k, v in eng.slot_state.items() if v is s)
        r = s.request
        grants[slot] = min(chunk, r.prompt_len - r.prefilled) \
            if r.phase == Phase.PREFILL else decode_grant
    return grants


def mixed_trace(eng, rng, n_sessions: int, max_new: int, chunk: int,
                decode_grant: int = 1):
    """submit_turn/run_round with chunked prefill grants interleaved with
    decode: half the sessions start at once, the rest a few rounds
    later, so prefill chunks share rounds with decoding slots. A decode
    slot is granted ``decode_grant`` tokens (1 + K carries a spec
    engine's draft budget). Returns (per-session tokens, rounds, granted
    tokens, seconds)."""
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
        grants = round_grants(eng, chunk, decode_grant)
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


# ======================================================================
# (e) the paged engine's feature planes
# ======================================================================
SYSTEM_TOKENS = 250         # 15 full pages of 16 and a 10-token tail


def drive_rounds(eng, chunk: int, decode_grant: int = 1,
                 check_every: bool = False) -> int:
    """Run the engine's live slots to completion with
    ``round_grants``. Returns the rounds run."""
    rounds = 0
    while eng.active():
        eng.run_round(round_grants(eng, chunk, decode_grant))
        if check_every:
            eng.check_invariants()
        rounds += 1
        check(rounds < 2000, "rounds did not finish")
    return rounds


def prefix_trace(cfg, params, dev, prefix: bool, n_sessions=8, new=24):
    """(e1) ``n_sessions`` sessions share one ``SYSTEM_TOKENS``-token
    system prompt, each with its own 24-120-token suffix, two turns of
    ``new`` tokens each. Session 0's first turn closes (and registers
    its pages) before the others arrive; they arrive together, then
    every session takes a second turn. ``check_invariants`` after every
    round. Returns (histories, engine, expected prefix-hit tokens)."""
    from repro_torch.serving.paged_engine import PagedRealtimeEngine
    rng = np.random.default_rng(SEED + 5)
    V = cfg.vocab_size
    system = rng.integers(0, V, size=SYSTEM_TOKENS)
    first = [np.concatenate([system, rng.integers(0, V, size=int(n))])
             for n in rng.integers(24, 121, size=n_sessions)]
    second = [rng.integers(0, V, size=int(n))
              for n in rng.integers(8, 33, size=n_sessions)]
    eng = PagedRealtimeEngine(cfg, params, slots=n_sessions, page_size=16,
                              pages_per_seq=32, device=dev,
                              prefix_cache=prefix)
    bad = []
    eng.logit_tap = lambda sid, lg: \
        bad.append(sid) if not np.isfinite(lg).all() else None
    eng.submit_turn("p0", first[0], new)
    drive_rounds(eng, 16, check_every=True)
    # what a lookup of each later prompt matches in p0's registered
    # chain: the common prefix, less the last prompt token (it always
    # prefills)
    chain = eng.sessions["p0"].token_ids
    expect = 0
    for p in first[1:]:
        n = 0
        while n < min(len(p), len(chain)) and int(p[n]) == chain[n]:
            n += 1
        expect += min(n, len(p) - 1)
    for i in range(1, n_sessions):
        eng.submit_turn(f"p{i}", first[i], new)
    drive_rounds(eng, 16, check_every=True)
    for i in range(n_sessions):
        eng.submit_turn(f"p{i}", second[i], new)
    drive_rounds(eng, 16, check_every=True)
    torch.cuda.synchronize()
    check(not bad, f"prefix={prefix}: non-finite logits for {bad}")
    hist = {sid: s.history for sid, s in eng.sessions.items()}
    check(all(len(h) == 2 and all(len(t) == new for t in h)
              for h in hist.values()),
          f"prefix={prefix}: turns did not run to their cap")
    return hist, eng, expect


def f32_twin(cfg, params):
    """The same weights in f32, to tell bf16 rounding (another product
    shape rounds differently) from a fault of a plane."""
    return (cfg.replace(dtype="float32", param_dtype="float32"),
            cast_params(params, torch.float32))


def prefix_phase(cfg, params, dev) -> None:
    """(e1) the prefix plane against its ``prefix_cache=False`` twin."""
    t0 = time.perf_counter()
    hist, eng, expect = prefix_trace(cfg, params, dev, True)
    pc = eng.prefix_cache
    log(f"[feature] (e1) prefix plane: hits {pc.hits}, hit tokens "
        f"{pc.hit_tokens} (prompts imply {expect}), copy-on-write "
        f"{eng.cow_copies}, peak shared pages {eng.peak_shared_pages}, "
        f"{eng.fused_launches} fused launches")
    check(pc.hits >= 7, f"prefix hits {pc.hits} < 7")
    check(pc.hit_tokens == expect and expect >= 7 * SYSTEM_TOKENS,
          f"hit tokens {pc.hit_tokens}, prompts imply {expect}")
    check(eng.cow_copies >= 1, "no copy-on-write happened")
    check(eng.peak_shared_pages > 0, "no page was ever shared")
    hits = sum(t["prefix_hit_tokens"] for s in eng.sessions.values()
               for t in s.turn_stats)
    check(hits == expect, f"turn stats report {hits} hit tokens")
    ctl, ceng, _ = prefix_trace(cfg, params, dev, False)
    check(ceng.cow_copies == 0 and ceng.peak_shared_pages == 0,
          "the control shared pages")
    same = sum(hist[s] == ctl[s] for s in hist)
    log(f"[feature] (e1) sessions with the control's tokens in bf16: "
        f"{same}/{len(hist)} (another product shape may round a near tie "
        f"the other way)")
    c32, p32 = f32_twin(cfg, params)
    h32, _, _ = prefix_trace(c32, p32, dev, True)
    ctl32, _, _ = prefix_trace(c32, p32, dev, False)
    same32 = sum(h32[s] == ctl32[s] for s in h32)
    log(f"[feature] (e1) f32: sessions with the control's tokens "
        f"{same32}/{len(h32)}; {time.perf_counter() - t0:.1f} s")
    check(h32 == ctl32, "f32 prefix plane's tokens differ from its "
          "control's")
    del p32
    torch.cuda.empty_cache()


def spec_trace(cfg, params, dev, spec: int, proposer=None):
    """(e2) phase (b)'s trace on the fused plane, decode slots granted
    1 + ``spec`` tokens (drafts from ``proposer``, the n-gram one by
    default). Returns (tokens, rounds, seconds, engine)."""
    from repro_torch.serving.paged_engine import PagedRealtimeEngine
    eng = PagedRealtimeEngine(cfg, params, slots=8, page_size=16,
                              pages_per_seq=32, device=dev,
                              spec_decode=spec, proposer=proposer)
    bad = []
    eng.logit_tap = lambda sid, lg: \
        bad.append(sid) if not np.isfinite(lg).all() else None
    toks, rounds, _, secs = mixed_trace(eng, np.random.default_rng(SEED),
                                        8, 24, 16, decode_grant=1 + spec)
    eng.check_invariants()
    check(not bad, f"spec={spec}: non-finite logits for {bad}")
    check(all(len(t) == 24 for t in toks.values()),
          f"spec={spec}: turns did not run to their cap")
    return toks, rounds, secs, eng


def spec_phase(cfg, params, dev, fused_b: dict, K: int = 3) -> dict:
    """(e2) spec_decode=K with the n-gram proposer against phase (b)'s
    K = 0 fused tokens. Returns phase (b)'s trace's tokens in f32 (the
    K = 0 twin), which (g2) holds the sharded engine to."""
    from repro_torch.serving.spec_decode import NGramProposer

    class TimedNGram(NGramProposer):
        """The default proposer, with the host seconds it takes."""
        calls, seconds = 0, 0.0

        def propose(self, history, k):
            t = time.perf_counter()
            out = super().propose(history, k)
            self.seconds += time.perf_counter() - t
            self.calls += 1
            return out

    t0 = time.perf_counter()
    timed = TimedNGram()
    toks, rounds, secs, eng = spec_trace(cfg, params, dev, K, timed)
    emitted = sum(len(t) for t in toks.values())
    d, a, r = eng.spec_drafted, eng.spec_accepted, eng.spec_rejected
    log(f"[feature] (e2) spec K={K} (n-gram): {rounds} rounds in "
        f"{secs:.2f} s = {secs / rounds * 1e3:.2f} ms/round (K = 0, phase "
        f"(b): {fused_b['rounds']} rounds, "
        f"{fused_b['secs'] / fused_b['rounds'] * 1e3:.2f} ms/round); "
        f"drafted {d}, accepted {a}, rejected {r}, accept rate "
        f"{a / max(d, 1):.3f}; {emitted} tokens in {eng.fused_launches} "
        f"launches = {emitted / eng.fused_launches:.3f} tokens/launch; "
        f"{timed.calls} proposals took {timed.seconds * 1e3:.2f} ms of "
        f"host time")
    check(d > 0, "the n-gram proposer drafted nothing")
    check(a + r == d, f"accepted {a} + rejected {r} != drafted {d}")
    same = sum(toks[s] == fused_b["tokens"][s] for s in toks)
    log(f"[feature] (e2) sessions with the K = 0 tokens in bf16: "
        f"{same}/{len(toks)} (the verify step unembeds [B*Q, d], another "
        f"product shape)")
    c32, p32 = f32_twin(cfg, params)
    t32, _, _, e32 = spec_trace(c32, p32, dev, K)
    b32, _, _, _ = spec_trace(c32, p32, dev, 0)
    same32 = sum(t32[s] == b32[s] for s in t32)
    log(f"[feature] (e2) f32: sessions with the K = 0 tokens "
        f"{same32}/{len(t32)} (drafted {e32.spec_drafted}, accepted "
        f"{e32.spec_accepted}); {time.perf_counter() - t0:.1f} s")
    check(t32 == b32, "f32 spec tokens differ from the K = 0 plane's")
    check(e32.spec_accepted + e32.spec_rejected == e32.spec_drafted,
          "f32 spec counters do not balance")
    del p32
    torch.cuda.empty_cache()
    # the timed run above was the first at the verify step's shapes;
    # warm, in turns, the trace's seconds on each plane (the same 192
    # tokens out of each)
    runs = []
    for k in (0, K, K, 0):
        _, r, sec, _ = spec_trace(cfg, params, dev, k)
        runs.append(f"K={k} {sec:.3f} s ({r} rounds, "
                    f"{sec / r * 1e3:.2f} ms/round)")
    log(f"[feature] (e2) warm, in turns: {'; '.join(runs)}")
    return b32


def int8_phase(cfg, params, dev) -> None:
    """(e3) the int8 wire tier: the quality gate on the card (the fp32
    control bit exact, the int8 candidate's flips and logit MSE beside
    the reference's tolerance), and the quantizer's bound on real
    offloaded full-width bf16 pages."""
    from repro_torch.kvcache.quant import BLOCK, QuantizedPage, decode_page
    from repro_torch.serving.paged_engine import PagedRealtimeEngine
    from repro_torch.serving.quality_gate import (QualityTolerance,
                                                  run_quality_gate)
    t0 = time.perf_counter()
    ctl = run_quality_gate(cfg, params, kv_quant="fp32", device=dev)
    log(f"[feature] (e3) fp32 control: flips {ctl.token_flips}/"
        f"{ctl.tokens_compared}, logit MSE {ctl.logit_mse!r} over "
        f"{ctl.logit_positions} positions, reloaded pages "
        f"{ctl.reloaded_pages}")
    check(ctl.token_flips == 0 and ctl.logit_mse == 0.0,
          "the fp32 control is not bit exact")
    check(ctl.reloaded_pages > 0, "the fp32 gate reloaded no pages")
    q8 = run_quality_gate(cfg, params, kv_quant="int8", device=dev)
    tol = QualityTolerance()
    log(f"[feature] (e3) int8: flip rate {q8.token_flip_rate:.4f} "
        f"({q8.token_flips}/{q8.tokens_compared}; tolerance "
        f"{tol.max_token_flip_rate}), logit MSE {q8.logit_mse:.3e} "
        f"(tolerance {tol.max_logit_mse}), reloaded pages "
        f"{q8.reloaded_pages}, wire bytes saved {q8.wire_bytes_saved:.0f};"
        f" within the tolerance: {q8.within(tol)}")
    check(q8.reloaded_pages > 0, "the int8 gate reloaded no pages")
    check(q8.wire_bytes_saved > 0, "the int8 gate saved no wire bytes")
    # real pages: snapshot a session's pages, offload them through the
    # int8 tier, and hold the host copies to the quantizer's bound
    eng = PagedRealtimeEngine(cfg, params, slots=2, page_size=16,
                              pages_per_seq=16, num_pages=64,
                              kv_quant="int8", device=dev)
    eng.add_session("q", np.random.default_rng(SEED + 9).integers(
        0, cfg.vocab_size, size=100), max_new_tokens=8)
    eng.run_to_completion()
    seq = eng.pool.seq("q")
    orig = {li: torch.stack([eng.k_pages[:, p], eng.v_pages[:, p]]).cpu()
            for li, p in enumerate(seq.pages)}
    check(eng.kv.evict(3, eng.clock.now()) == 3, "eviction fell short")
    eng.flush_transfers()
    check(len(seq.offloaded) == 3, "pages did not reach the host")
    worst = over = total = 0
    for li, enc in seq.offloaded.items():
        check(isinstance(enc, QuantizedPage), "host copy not quantized")
        x = orig[li].float().reshape(-1)
        n = x.numel()
        scale = enc.scales.repeat_interleave(BLOCK)[:n]
        deq = (enc.q.float() * enc.scales[:, None]).reshape(-1)[:n]
        back = decode_page(enc)
        check(back.dtype == torch.bfloat16, f"decoded as {back.dtype}")
        check(bool(((deq - x).abs()
                    <= scale / 2 + 2.0 ** -23 * x.abs()).all()),
              f"page {li}: dequantization off by more than scale/2")
        check(torch.equal(back.reshape(-1).view(torch.int16),
                          deq.to(torch.bfloat16).view(torch.int16)),
              f"page {li}: decode is not the bf16 rounding of q * scale")
        err = (back.reshape(-1).float() - x).abs()
        worst = max(worst, (err / scale).max().item())
        over += int((err > scale / 2).sum())
        total += n
    log(f"[feature] (e3) {len(seq.offloaded)} offloaded full-width bf16 "
        f"pages ({total} elements): |q * scale - x| <= scale/2 for every "
        f"element; after the bf16 rounding of decode, {over} elements "
        f"({100 * over / total:.2f}%) exceed scale/2, the worst "
        f"{worst:.3f} scale; {time.perf_counter() - t0:.1f} s")
    eng.start_turn("q", np.random.default_rng(SEED + 10).integers(
        0, cfg.vocab_size, size=8), max_new_tokens=4)
    eng.run_to_completion()
    eng.check_invariants()
    check(not seq.offloaded and eng.kv.reloaded_blocks >= 3,
          "the int8 pages did not come back")


# ======================================================================
# (f) the front end: the live gateway and its virtual-time replay twin
# ======================================================================
LIVE_TRACE = dict(kind="interactive", sessions=8, barge_in=0.3,
                  arrival="poisson", rate_rps=1.0, max_turns=2,
                  max_prompt=256, max_response=64)
LIVE_APT = 0.08             # the workload's own audio seconds a token
FRONTIER_CAP_S = 3.0
LIVE_SLOTS, LIVE_CHUNK = 8, 16
# a round's token budget holds every slot's decode token and one prefill
# chunk beside them: at the default 16, decode slots whose playback
# buffer is low (the first scheduling class) leave no room for the
# chunk, and Algorithm 1 stops admission at it every round
LIVE_BUDGET = LIVE_SLOTS + LIVE_CHUNK
# (f3): 4 sessions of 2 turns (prompts <= 64, replies <= 16 tokens) on
# 4 slots, pages of 16, 10 a session, and a pool of 18 pages: tight
# enough that idle sessions are evicted and reloaded
REPLAY_TRACE = dict(kind="interactive", num_sessions=4, seed=SEED,
                    p_barge_in=0.3, arrival="poisson", rate_rps=1.0)
REPLAY_GEOMETRY = dict(slots=4, page_size=16, pages_per_seq=10,
                       num_pages=18)


def install_eviction_oracle(kv):
    """Wrap ``kv.evict`` so every eviction pass is checked against a
    freshly-computed next-use ranking (the paper's Eq. 4): each victim's
    next-use estimate must dominate (>=, with fp slack) every candidate
    that was spared. Returns the violations list (empty == policy
    agreement)."""
    violations = []
    orig_evict = kv.evict

    def evict(need_blocks, now):
        cands = {}
        for sid, s in kv.sessions.items():
            if s.evictable(now) <= 0:
                continue
            if kv.monitor is not None and kv.monitor.immediate_reuse(sid):
                continue
            cands[sid] = kv.next_use_estimate(sid, now)
        victims = []
        orig_es = kv._evict_session

        def spy(sid, want, now2):
            victims.append(sid)
            return orig_es(sid, want, now2)

        kv._evict_session = spy
        try:
            freed = orig_evict(need_blocks, now)
        finally:
            kv._evict_session = orig_es
        vset = set(victims)
        for v in vset:
            if v not in cands:
                violations.append(("illegal-victim", now, v, dict(cands)))
        spared = [est for sid, est in cands.items() if sid not in vset]
        if vset and spared:
            lo = min(cands[v] for v in vset if v in cands)
            if lo + 1e-9 < max(spared):
                violations.append(("ranking", now, victims, dict(cands)))
        return freed

    kv.evict = evict
    return violations


def front_end_checks(tag, m, engines, wl, max_turns, apt,
                     max_over_frontier_s) -> None:
    """What the trace determines, whatever the clock: every session
    completes, every clamped turn is recorded with a TTFP, the barged
    turns are the trace's, each session's turns complete in order, the
    frontier cap holds to one token of audio, the engines' invariants
    hold, and the turn records' reload split is the engines' (a fleet's
    migrated session carries its turn stats to its destination)."""
    from repro_torch.serving.workload import generate
    trace = generate(wl)
    check(m.completed_sessions == wl.num_sessions,
          f"{tag}: {m.completed_sessions}/{wl.num_sessions} sessions "
          f"completed")
    want = {(s.session_id, ti) for s in trace
            for ti in range(min(len(s.turns), max_turns))}
    got = {(t.session_id, t.turn_index) for t in m.turns}
    check(want and got == want, f"{tag}: turns {sorted(got)}")
    check(all(t.ttfp is not None for t in m.turns),
          f"{tag}: a turn has no TTFP")
    barges = {(s.session_id, ti) for s in trace
              for ti, turn in enumerate(s.turns[:max_turns])
              if turn.barge_in}
    barged = {(t.session_id, t.turn_index) for t in m.turns if t.barged}
    check(barged == barges, f"{tag}: barged {sorted(barged)}, the trace "
          f"barges {sorted(barges)}")
    check(all(t.completed or t.barged for t in m.turns),
          f"{tag}: a turn was lost")
    order = {}
    for t in sorted(m.turns, key=lambda t: (t.finish_time, t.turn_index)):
        order.setdefault(t.session_id, []).append(t.turn_index)
    check(all(v == sorted(v) for v in order.values()),
          f"{tag}: turns completed out of order: {order}")
    check(max_over_frontier_s <= apt + 1e-6,
          f"{tag}: {max_over_frontier_s} s past the frontier cap")
    for eng in engines:
        eng.check_invariants()
    for field, key in (("reload_stall_s", "reload_stall_s"),
                       ("reload_off_path_s", "reload_off_path_s")):
        rec = sum(getattr(t, field) for t in m.turns)
        stat = sum(st[key] for eng in engines for s in eng.sessions.values()
                   for st in s.turn_stats)
        check(math.isclose(rec, stat, rel_tol=1e-9, abs_tol=1e-12),
              f"{tag}: records {field} {rec} != turn stats {stat}")


def live_phase(cfg, params, dev, policy: str) -> dict:
    """(f1)/(f2) ``run_gateway_workload`` at full width on the scaled
    wall clock at scale 1 (what a user hears): 8 interactive sessions
    with barge-ins arriving at 1 session/s, 2 turns each, prompts <=
    256 and replies <= 64 tokens, 8 slots, pages of 16, the default
    pool, prefill chunks of 16 beside every slot's decode token. Each
    round's host time is read around ``run_round`` (it ends copying the
    logits to the host). Returns the summary."""
    from repro_torch.serving.gateway.harness import (build_gateway,
                                                     run_gateway_workload)
    from repro_torch.serving.workload import WorkloadConfig
    t0 = time.perf_counter()
    gw = build_gateway(policy=policy, scale=1.0, model=(cfg, params),
                       device=dev, slots=LIVE_SLOTS, page_size=16,
                       pages_per_seq=40, round_token_budget=LIVE_BUDGET,
                       prefill_chunk=LIVE_CHUNK, audio_per_token_s=LIVE_APT,
                       frontier_cap_s=FRONTIER_CAP_S, seed=SEED)
    warm = time.perf_counter() - t0
    eng = gw.engine
    bad, round_s, grants = [], [], [0, 0]
    eng.logit_tap = lambda sid, lg: \
        bad.append(sid) if not np.isfinite(lg).all() else None
    run_round, schedule = eng.run_round, gw.scheduler.schedule

    def timed_round(chunks):
        t = time.perf_counter()
        out = run_round(chunks)
        round_s.append(time.perf_counter() - t)
        return out

    def counted_schedule(ready, budget, now):
        # U0 is the playback-urgency class: a started reply whose
        # client buffer fell to P_safe or below (an underrun risk)
        d = schedule(ready, budget, now)
        grants[0] += sum(d.classes.get(r.req_id) == 0 for r in d.batch)
        grants[1] += len(d.batch)
        return d

    eng.run_round = timed_round
    gw.scheduler.schedule = counted_schedule
    t1 = time.perf_counter()
    m, gw = run_gateway_workload(policy=policy, seed=SEED, gateway=gw,
                                 timeout_s=600, **LIVE_TRACE)
    secs = time.perf_counter() - t1
    tag = f"({'f1' if policy == 'liveserve' else 'f2'}) {policy}"
    check(not bad, f"{tag}: non-finite logits for {bad}")
    wl = WorkloadConfig(kind=LIVE_TRACE["kind"],
                        num_sessions=LIVE_TRACE["sessions"], seed=SEED,
                        p_barge_in=LIVE_TRACE["barge_in"],
                        arrival=LIVE_TRACE["arrival"],
                        rate_rps=LIVE_TRACE["rate_rps"])
    front_end_checks(tag, m, [eng], wl, LIVE_TRACE["max_turns"], LIVE_APT,
                     gw.max_over_frontier_s)
    s = m.summary()
    st = eng.transfer.stats
    moved = st.reload_pages_off_path + st.reload_pages_on_path
    gaps = sum(t.n_gaps for t in m.turns)
    log(f"[frontend] {tag}: {len(m.turns)} turns "
        f"({sum(t.barged for t in m.turns)} barged), P50 TTFP "
        f"{s['p50_ttfp']:.4f} s, P90 TTFP {s['p90_ttfp']:.4f} s, "
        f"continuity {s['continuity']:.4f}, reload_overlap_frac "
        f"{s['reload_overlap_frac']:.4f}, completed sessions/s "
        f"{s['completed_rps']:.4f}")
    log(f"[frontend] {tag}: {gw.rounds} rounds, "
        f"{1e3 * sum(round_s) / len(round_s):.2f} ms/round (min "
        f"{1e3 * min(round_s):.2f}, max {1e3 * max(round_s):.2f}), "
        f"{sum(round_s):.1f} s of {secs:.1f} s in rounds; "
        f"transfer_overlap_frac "
        f"{st.reload_pages_off_path / moved if moved else 0.0:.4f} "
        f"({moved} pages reloaded, {eng.kv.evicted_blocks} evicted); "
        f"max over frontier {gw.max_over_frontier_s:.4f} s; "
        f"playback-urgency (U0) grants {grants[0]} of {grants[1]}, "
        f"{gaps} playback gaps; warm-up {warm:.1f} s")
    return s


def replay_run(cfg, params, dev, fused: bool, mesh=None) -> dict:
    """(f3) one ``run_replay`` of the tight-pool trace with the eviction
    oracle installed (fresh next-use ranking per pass) and the engine's
    invariants checked after every round. With ``mesh`` (g2) the engine
    is sharded: the leader replays and returns the record, the other
    ranks follow it and return None."""
    from repro_torch.serving.gateway.replay import ReplayConfig, run_replay
    from repro_torch.serving.paged_engine import PagedRealtimeEngine
    from repro_torch.serving.workload import WorkloadConfig
    if mesh is not None and not mesh.is_leader:
        PagedRealtimeEngine(cfg, params, device=dev, fused_step=fused,
                            mesh=mesh, **REPLAY_GEOMETRY).follow()
        return None
    wl = WorkloadConfig(**REPLAY_TRACE)
    rc = ReplayConfig(audio_per_token_s=LIVE_APT, round_token_budget=16,
                      prefill_chunk=16, frontier_cap_s=FRONTIER_CAP_S,
                      max_prompt=64, max_response=16, max_turns=2)
    box = {}

    def factory(clock):
        eng = PagedRealtimeEngine(cfg, params, clock=clock, device=dev,
                                  fused_step=fused, mesh=mesh,
                                  **REPLAY_GEOMETRY)
        eng.kv.index_mode = "scan"
        box["violations"] = install_eviction_oracle(eng.kv)
        box["eng"] = eng
        return eng

    t0 = time.perf_counter()
    try:
        m, gw = run_replay(factory, wl, rc, seed=SEED)
    finally:
        if "eng" in box:
            box["eng"].release_followers()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    eng = gw.eng
    tag = (f"(f3) {'fused' if fused else 'per-token'} "
           f"{str(cfg.activation_dtype()).replace('torch.', '')}"
           + (f" {eng.layout}" if mesh is not None else ""))
    check(not box["violations"], f"{tag}: eviction oracle: "
          f"{box['violations'][:3]}")
    check(eng.kv.evicted_blocks > 0, f"{tag}: the pool never evicted")
    front_end_checks(tag, m, [eng], wl, rc.max_turns, LIVE_APT,
                     gw.max_over_frontier_s)
    st = eng.transfer.stats
    log(f"[frontend] {tag}: {gw.rounds} rounds in {secs:.1f} s, evicted "
        f"{eng.kv.evicted_blocks} blocks, reloaded "
        f"{eng.kv.reloaded_blocks} ({st.reload_pages_off_path} pages off "
        f"the path, {st.reload_pages_on_path} on it), "
        f"{len(eng.offload_events)} offload events, P90 TTFP "
        f"{m.summary()['p90_ttfp']:.4f} s (virtual)")
    return dict(records=[dataclasses.asdict(t) for t in m.turns],
                histories={sid: s.history for sid, s in eng.sessions.items()},
                offload_events=list(eng.offload_events),
                evicted=eng.kv.evicted_blocks,
                reloaded=eng.kv.reloaded_blocks, rounds=gw.rounds,
                secs=secs)


def replay_phase(cfg, params, dev) -> dict:
    """(f3) the replay twin on both planes in f32, where token streams
    and turn records must be identical, then a bf16 fused run, its
    streams logged against f32's (its modeled reload seconds differ:
    a bf16 page is half the bytes on the modeled PCIe link). Returns
    the f32 fused run, which (g2) holds the sharded engine to."""
    t0 = time.perf_counter()
    c32, p32 = f32_twin(cfg, params)
    fused = replay_run(c32, p32, dev, True)
    tokenwise = replay_run(c32, p32, dev, False)
    del p32
    torch.cuda.empty_cache()
    same = sum(fused["histories"][s] == tokenwise["histories"][s]
               for s in fused["histories"])
    log(f"[frontend] (f3) f32: sessions with identical streams on both "
        f"planes {same}/{len(fused['histories'])}, turn records identical "
        f"{fused['records'] == tokenwise['records']}")
    check(fused["records"] and fused["records"] == tokenwise["records"],
          "(f3) turn records differ between the planes")
    check(fused["histories"] == tokenwise["histories"],
          "(f3) token streams differ between the planes")
    check(fused["offload_events"] == tokenwise["offload_events"],
          "(f3) offload events differ between the planes")
    bf = replay_run(cfg, params, dev, True)
    agree = sum(bf["histories"][s] == fused["histories"][s]
                for s in fused["histories"])
    log(f"[frontend] (f3) bf16 fused: sessions with the f32 streams "
        f"{agree}/{len(fused['histories'])}; {time.perf_counter() - t0:.1f}"
        f" s")
    return fused


# ======================================================================
# (g) the sharded page plane: M ranks sharing the one card
# ======================================================================
G_CTX = [0, 170, 411, 96, 250, 333, 128, 0]   # row 0 prefills from 0
G_PLANS = {  # the parts each 1xM mesh runs: (g1) kernels, (g2) paths
    2: ["kernels", "flash", ("fused", "bfloat16")],
    4: ["kernels", ("fused", "bfloat16"), ("fused", "float32"),
        ("tokenwise", "float32"), ("replay", "float32")],
    3: ["kernels"],
}
G_LAYOUTS = {2: "heads", 4: "slots", 3: "replicated"}


def stripe_merge(parts):
    """The slots layout's exact merge of the stripes' (o, m, l), f32."""
    m_star = torch.stack([m for _, m, _ in parts]).amax(0)
    ws = [l * torch.exp(m - m_star) for _, m, l in parts]
    den = sum(ws).clamp_min(1e-30)
    return sum(o.float() * w[..., None]
               for (o, _, _), w in zip(parts, ws)) / den[..., None]


def options_err(tag, got, want, tol) -> list:
    """A kernel's (o, m, l) with stats against the plain version's: the
    rows that saw a key agree within ``tol`` (o, m, l; absolutely and
    relatively, l being a sum of up to hundreds of weights), the two
    agree on which rows saw one, and a row that saw none is finite zeros
    with m = NEG_INF and l = 0. Returns the largest absolute error of o,
    m and l."""
    from repro_torch.kernels import ref
    (o, m, l), (wo, wm, wl) = got, want
    seen = wl > 0
    check(torch.equal(l > 0, seen), f"{tag}: rows that saw a key differ")
    check(bool(torch.isfinite(o).all() and torch.isfinite(m).all()),
          f"{tag}: non-finite output or stats")
    check(bool((o[~seen] == 0).all() and (l[~seen] == 0).all()
               and (m[~seen] == ref.NEG_INF).all()),
          f"{tag}: a row with no key is not zeros, NEG_INF, 0")
    errs = []
    for a, b in ((o, wo), (m, wm), (l, wl)):
        e, ok = allclose_err(a[seen], b[seen], tol) if seen.any() \
            else (0.0, True)
        check(ok, f"{tag}: err {e} > {tol}")
        errs.append(e)
    return errs


def options_phase(dev) -> None:
    """(g0) the paged kernels' sharding options at the engine's shapes
    (B 8, Q 16 and Q 1, Hq 12, Hkv 2, D 128, page 16), in one process:
    every page cut into S = 2 and 4 stripes, each stripe's call with
    ``pos_stride`` and stats on shifted starts held to the plain version
    (f32: in f32 at 2e-5; bf16: the f32 plain version on the same inputs
    at 2e-2), rows that see no key finite with l = 0, ``pos_offset``
    bitwise the shifted call, the decode kernel bitwise the fused
    kernel's Q = 1 case with the options on, and the merged stripes the
    unsharded kernel. Times the stats variant beside the default."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import (
        paged_attention, paged_prefill_attention)
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    timer = Timer(dev)
    B, Q, page = 8, 16, 16
    for dtype in (torch.float32, torch.bfloat16):
        name, tol = str(dtype)[6:], TOL[dtype]
        q, kp, vp, bt, qs, ql = kernel_case(dev, dtype, B, Q, G_CTX, g)
        qd, sl = q[:, 0].contiguous(), qs + 1
        plain = (q, kp, vp) if dtype == torch.float32 \
            else tuple(x.float() for x in (q, kp, vp))
        full = paged_prefill_attention(q, kp, vp, bt, qs, ql)
        full_d = paged_attention(qd, kp, vp, bt, sl)
        opts = dict(pos_stride=page, return_stats=True)
        worst, merged, empty = [0.0] * 3, {}, 0
        for S in (2, 4):
            n = page // S
            parts, parts_d = [], []
            for st in range(S):
                ks, vs = (x[:, st * n:(st + 1) * n].contiguous()
                          for x in (kp, vp))
                pk, pv = (x[:, st * n:(st + 1) * n].contiguous()
                          for x in plain[1:])
                got = paged_prefill_attention(q, ks, vs, bt, qs - st * n,
                                              ql, **opts)
                got_d = paged_attention(qd, ks, vs, bt, sl - st * n, **opts)
                want = ref.paged_prefill_attention_ref(
                    plain[0], pk, pv, bt, qs - st * n, ql, **opts)
                want_d = ref.paged_attention_ref(
                    plain[0][:, 0].contiguous(), pk, pv, bt, sl - st * n,
                    **opts)
                torch.cuda.synchronize()
                tag = f"(g0) {name} stripe {st}/{S}"
                for errs in (options_err(f"{tag} fused", got, want, tol),
                             options_err(f"{tag} decode", got_d, want_d,
                                         tol)):
                    worst = [max(a, b) for a, b in zip(worst, errs)]
                empty += int((want[2] == 0).sum() + (want_d[2] == 0).sum())
                f1 = paged_prefill_attention(
                    q[:, :1].contiguous(), ks, vs, bt, sl - 1 - st * n,
                    torch.ones_like(ql), **opts)
                check(all(torch.equal(a[:, 0], b)
                          for a, b in zip(f1, got_d)),
                      f"{tag}: fused Q=1 != decode kernel with the options")
                by_off = paged_prefill_attention(
                    q, ks, vs, bt, qs, ql, pos_stride=page,
                    pos_offset=st * n, return_stats=True)
                check(all(torch.equal(a, b) for a, b in zip(by_off, got)),
                      f"{tag}: pos_offset != the shifted starts")
                parts.append(got)
                parts_d.append(got_d)
            merged[S] = (max_valid_err(stripe_merge(parts), full, ql),
                         (stripe_merge(parts_d)
                          - full_d.float()).abs().max().item())
            check(max(merged[S]) <= tol, f"(g0) {name}: {S} stripes "
                  f"merged vs the unsharded kernel {merged[S]}")
        log(f"[sharded] (g0) {name}: stripe calls vs plain, max abs err of "
            f"o, m, l {worst} (tol {tol} abs and rel); {empty} (row, "
            f"stripe) stats with no key, all "
            f"finite zeros with l = 0; fused Q=1 == decode and pos_offset "
            f"== shift bitwise; merged stripes vs the unsharded kernel "
            f"(fused, decode): {merged}")
        if dtype != torch.bfloat16:
            continue
        ks, vs = (x[:, 4:8].contiguous() for x in (kp, vp))
        for kname, fn, args, stripe in (
                ("paged_prefill_attention", paged_prefill_attention,
                 (q, kp, vp, bt, qs, ql), (q, ks, vs, bt, qs - 4, ql)),
                ("paged_attention", paged_attention, (qd, kp, vp, bt, sl),
                 (qd, ks, vs, bt, sl - 4))):
            ms = [timer(lambda: fn(*args)),
                  timer(lambda: fn(*args, return_stats=True)),
                  timer(lambda: fn(*stripe, **opts))]
            log(f"[sharded] (g0) {kname} bf16 B={B} ctx={G_CTX}: default "
                f"{ms[0]:.4f} ms, with stats {ms[1]:.4f} ms, one of 4 "
                f"stripes (pos_stride, stats) {ms[2]:.4f} ms")


def g1_kernels(mesh, dev) -> dict:
    """(g1) on one rank: the global-view sharded kernels at the engine's
    shapes against the single-device kernels on the same inputs (every
    rank draws them from one seed)."""
    from types import SimpleNamespace
    from repro_torch.distributed.paged import (PagedKVLayout,
                                               sharded_paged_attention)
    from repro_torch.kernels.paged_attention import (
        paged_attention, paged_prefill_attention)
    layout = PagedKVLayout(SimpleNamespace(num_kv_heads=2), mesh, 16)
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, kp, vp, bt, qs, ql = kernel_case(dev, dtype, 8, 16, G_CTX, g)
        qd, sl = q[:, 0].contiguous(), qs + 1
        one = paged_prefill_attention(q, kp, vp, bt, qs, ql)
        got = layout.attend_chunk(q, layout.shard(kp), layout.shard(vp), bt,
                                  qs, ql)
        one_d = paged_attention(qd, kp, vp, bt, sl)
        got_d = sharded_paged_attention(layout, qd, kp, vp, bt, sl)
        torch.cuda.synchronize()
        out[str(dtype)[6:]] = dict(
            kind=layout.kind, err=max_valid_err(got, one, ql),
            err_d=(got_d.float() - one_d.float()).abs().max().item(),
            bitwise=torch.equal(got, one), bitwise_d=torch.equal(got_d,
                                                                 one_d))
    return out


def g1_flash(mesh, dev) -> dict:
    """(g1) ``sharded_flash_prefill`` at phase (c)'s longest prompt
    (B 1, Hq 12, Hkv 2, 2048 tokens, D 128, bf16) against the kernel."""
    from types import SimpleNamespace
    from repro_torch.distributed.paged import (PagedKVLayout,
                                               sharded_flash_prefill)
    from repro_torch.kernels.flash_prefill import flash_prefill
    layout = PagedKVLayout(SimpleNamespace(num_kv_heads=2), mesh, 16)
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    q, k, v = (torch.randn(1, h, 2048, 128, generator=g, device=dev)
               .to(torch.bfloat16) for h in (12, 2, 2))
    one = flash_prefill(q, k, v)
    got = sharded_flash_prefill(layout, q, k, v)
    torch.cuda.synchronize()
    return dict(err=(got.float() - one.float()).abs().max().item(),
                bitwise=torch.equal(got, one))


def g2_trace(cfg, params, dev, mesh) -> dict:
    """(g2) phase (b)'s trace on the fused plane, on the sharded engine
    (the leader's result; a follower follows and returns None)."""
    from repro_torch.serving.paged_engine import PagedRealtimeEngine
    eng = PagedRealtimeEngine(cfg, params, slots=8, page_size=16,
                              pages_per_seq=32, device=dev, mesh=mesh)
    if not mesh.is_leader:
        eng.follow()
        return None
    bad = []
    eng.logit_tap = lambda sid, lg: \
        bad.append(sid) if not np.isfinite(lg).all() else None
    try:
        toks, rounds, fed, secs = mixed_trace(
            eng, np.random.default_rng(SEED), 8, 24, 16)
        eng.check_invariants()
    finally:
        eng.release_followers()
    check(not bad, f"(g2) {eng.layout}: non-finite logits for {bad}")
    return dict(tokens=toks, rounds=rounds, fed=fed, secs=secs)


def tokenwise_trace(cfg, params, dev, mesh=None) -> dict:
    """(g2) a short trace on the per-token plane: two turns 0 through
    ``add_session`` (the dense graft, ``flash_prefill``), their decode,
    and a turn 1 whose prompt is teacher-forced token by token
    (``paged_attention``). On a mesh the leader returns the result and a
    follower follows and returns None."""
    from repro_torch.serving.paged_engine import PagedRealtimeEngine
    eng = PagedRealtimeEngine(cfg, params, slots=2, page_size=16,
                              pages_per_seq=8, device=dev, fused_step=False,
                              mesh=mesh)
    if mesh is not None and not mesh.is_leader:
        eng.follow()
        return None
    rng = np.random.default_rng(SEED + 9)
    V, steps = cfg.vocab_size, 0
    t0 = time.perf_counter()
    try:
        eng.add_session("t0", rng.integers(0, V, size=40), max_new_tokens=8)
        eng.add_session("t1", rng.integers(0, V, size=56), max_new_tokens=8)
        while eng.active():
            eng.step()
            steps += 1
        eng.start_turn("t0", rng.integers(0, V, size=6), max_new_tokens=6)
        while eng.active():
            eng.step()
            steps += 1
        eng.check_invariants()
    finally:
        eng.release_followers()
    torch.cuda.synchronize()
    return dict(histories={s: x.history for s, x in eng.sessions.items()},
                steps=steps, secs=time.perf_counter() - t0)


def sharded_rank(mesh, plan) -> dict:
    """(g1)/(g2) on one rank of a 1xM mesh on the shared card: the parts
    of ``plan``, each engine path with the kernels' counts zeroed just
    before it and read just after (every rank counts its own)."""
    from repro_torch.launch.serve import build_demo
    dev = mesh.device
    out, params = {}, None
    for part in plan:
        if part == "kernels":
            out[part] = g1_kernels(mesh, dev)
            continue
        if part == "flash":
            out[part] = g1_flash(mesh, dev)
            continue
        what, dtype = part
        if params is None or params["embed"].dtype != getattr(torch, dtype):
            cfg, params, _ = build_demo("qwen2-1.5b", dev, SEED)
            if dtype == "float32":
                cfg, params = f32_twin(cfg, params)
                torch.cuda.empty_cache()
        wrappers = kernel_counts()
        for w in wrappers.values():
            w.launches = 0
        if what == "fused":
            res = g2_trace(cfg, params, dev, mesh)
        elif what == "tokenwise":
            res = tokenwise_trace(cfg, params, dev, mesh)
        else:
            res = replay_run(cfg, params, dev, True, mesh=mesh)
        out[part] = dict(result=res, counts={n: w.launches
                                             for n, w in wrappers.items()})
    return out


def sharded_phase(cfg, params, dev, planes: dict, b32: dict,
                  replay32: dict) -> list:
    """(g) the sharded page plane: (g0) the kernels' options in one
    process, then 1x2 (heads), 1x4 (slots) and 1x3 (replicated) meshes of
    ranks sharing the card over gloo: (g1) the global-view kernels
    against the single-device kernels, (g2) the sharded engine held to
    the single-device one. Returns ``[(tag, summed counts, expected)]``
    for the (g2) paths."""
    from repro_torch.launch.mesh import spawn
    t_g = time.perf_counter()
    options_phase(dev)
    c32, p32 = f32_twin(cfg, params)
    tw32 = tokenwise_trace(c32, p32, dev)
    del p32
    torch.cuda.empty_cache()
    single = {"bfloat16": planes["fused"], "float32": dict(tokens=b32)}
    paths = []
    for M, plan in G_PLANS.items():
        kind = G_LAYOUTS[M]
        t0 = time.perf_counter()
        outs = spawn(f"1x{M}", sharded_rank, plan, device="cuda",
                     timeout_s=600)
        log(f"[sharded] 1x{M} ({kind}): {M} ranks on one card, gloo "
            f"through host memory, {time.perf_counter() - t0:.1f} s")
        for r, o in enumerate(outs):
            for name, k in o["kernels"].items():
                tol = TOL[getattr(torch, name)]
                check(k["kind"] == kind, f"1x{M}: layout {k['kind']}")
                check(max(k["err"], k["err_d"]) <= tol,
                      f"(g1) 1x{M} rank {r} {name}: sharded vs single "
                      f"{k['err']} / {k['err_d']}")
                if r == 0:
                    log(f"[sharded] (g1) 1x{M} {kind} {name}: "
                        f"attend_chunk vs the kernel max err {k['err']} "
                        f"(bitwise {k['bitwise']}), sharded_paged_attention"
                        f" {k['err_d']} (bitwise {k['bitwise_d']}), tol "
                        f"{tol}")
            if "flash" in o:
                f = o["flash"]
                check(f["err"] <= TOL[torch.bfloat16],
                      f"(g1) sharded_flash_prefill rank {r}: {f['err']}")
                if r == 0:
                    log(f"[sharded] (g1) 1x{M} sharded_flash_prefill bf16 "
                        f"2048 tokens: max err {f['err']} vs the kernel "
                        f"(bitwise {f['bitwise']})")
        for part in plan:
            if not isinstance(part, tuple):
                continue
            what, dtype = part
            res = outs[0][part]["result"]
            counts = {n: sum(o[part]["counts"][n] for o in outs)
                      for n in outs[0][part]["counts"]}
            tag = f"(g2) 1x{M} {kind} {what} {dtype}"
            paths.append((tag, counts, part))
            if what == "fused":
                ref_toks = single[dtype]["tokens"]
                same = sum(res["tokens"][s] == ref_toks[s] for s in ref_toks)
                b = planes["fused"]
                log(f"[sharded] {tag}: {res['rounds']} rounds in "
                    f"{res['secs']:.2f} s = "
                    f"{res['secs'] / res['rounds'] * 1e3:.2f} ms/round "
                    f"(single device, phase (b): "
                    f"{b['secs'] / b['rounds'] * 1e3:.2f} ms/round); "
                    f"sessions with the single-device {dtype} tokens "
                    f"{same}/{len(ref_toks)}")
                if not (kind == "slots" and dtype == "bfloat16"):
                    check(res["tokens"] == ref_toks, f"{tag}: tokens "
                          "differ from the single-device engine's")
            elif what == "tokenwise":
                same = res["histories"] == tw32["histories"]
                log(f"[sharded] {tag}: {res['steps']} steps in "
                    f"{res['secs']:.2f} s = "
                    f"{res['secs'] / res['steps'] * 1e3:.2f} ms/step "
                    f"(single device {tw32['secs'] / tw32['steps'] * 1e3:.2f}"
                    f" ms/step); histories equal {same}")
                check(res["histories"] == tw32["histories"],
                      f"{tag}: histories differ from the single device's")
            else:
                log(f"[sharded] {tag}: {res['rounds']} rounds in "
                    f"{res['secs']:.1f} s, evicted {res['evicted']}, "
                    f"reloaded {res['reloaded']} (single device "
                    f"{replay32['evicted']}, {replay32['reloaded']}); "
                    f"records equal {res['records'] == replay32['records']}")
                for key in ("records", "histories", "offload_events",
                            "evicted", "reloaded"):
                    check(res[key] == replay32[key], f"{tag}: {key} differ "
                          "from the single-device run's")
    log(f"[sharded] phase (g): {time.perf_counter() - t_g:.1f} s")
    return paths


# ======================================================================
# (h) the replica fleet: replicas of the one set of weights on the card
# ======================================================================
FLEET = 3
# (h1), (h2): the fleet twin's clamps and each replica's geometry are
# (f3)'s: prompts <= 64, replies <= 16, 4 slots, pages of 16, 10 a
# session, rounds of 16 tokens
FLEET_RC = dict(audio_per_token_s=LIVE_APT, round_token_budget=16,
                prefill_chunk=16, frontier_cap_s=FRONTIER_CAP_S,
                max_prompt=64, max_response=16, max_turns=2)
FLEET_GEOMETRY = dict(slots=4, page_size=16, pages_per_seq=10)
# (h1) agent handoffs without barge-ins on the default pool (80 pages a
# replica: nothing evicts); (h2) interactive sessions with barge-ins,
# replica 0 drained after 6 routes, on 18 pages a replica: the
# destinations evict and reload
H1_TRACE = dict(kind="handoff", num_sessions=6, seed=SEED, p_barge_in=0.0,
                arrival="poisson", rate_rps=1.0)
H2_TRACE = dict(kind="interactive", num_sessions=9, seed=SEED,
                p_barge_in=0.3, arrival="poisson", rate_rps=1.0)
H2_DRAIN, H2_PAGES = (0, 6), 18
# (h3): (f1)'s trace and geometry on each replica, 12 sessions, replica 0
# drained after 6 routes (its sessions live-migrate at their next turn)
H3_TRACE = dict(LIVE_TRACE, sessions=12)
H3_DRAIN = (0, 6)


def as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.uint8)


def watch_migrations(eng, snaps: dict) -> None:
    """Read each session's pages through the device plane as
    ``migrate_out_begin`` starts on ``eng``, and again once a landing
    page-in on ``eng`` has made all of them resident (before a round
    can write): ``snaps[sid]`` holds the committed pages and both
    reads."""
    from repro_torch.serving.paged_engine import _OP_OFFLOAD
    begin, reload_chunk = eng.migrate_out_begin, eng._io_reload_chunk

    def read(sid):
        pages = list(eng.pool.seq(sid).pages)
        check(all(p >= 0 for p in pages), f"{sid}: a page is not resident")
        return eng._device(_OP_OFFLOAD, pages)

    def migrate_out_begin(sid):
        snaps[sid] = dict(pages=len(eng.pool.seq(sid).pages),
                          before=read(sid), after=None)
        return begin(sid)

    def io_reload_chunk(sid, lis):
        reload_chunk(sid, lis)
        snap, s = snaps.get(sid), eng.pool.seq(sid)
        if snap is not None and snap["after"] is None \
                and not s.offloaded and not s.loading:
            snap["after"] = read(sid)

    eng.migrate_out_begin = migrate_out_begin
    eng.transfer.set_io(reload_chunk=io_reload_chunk,
                        offload_chunk=eng._io_offload_chunk)


def fleet_replay(cfg, params, dev, trace: dict, *, replicas=FLEET,
                 num_pages=None, drain=None, snaps=None):
    """``run_fleet_replay`` (one replica: ``run_replay``) of ``trace`` on
    the fused plane, every replica's invariants checked after every
    round and its logits held finite. Returns (metrics, gateway,
    engines, seconds)."""
    from repro_torch.serving.fleet import run_fleet_replay
    from repro_torch.serving.gateway.replay import ReplayConfig, run_replay
    from repro_torch.serving.paged_engine import PagedRealtimeEngine
    from repro_torch.serving.workload import WorkloadConfig
    engines, bad = [], []

    def factory(clock):
        eng = PagedRealtimeEngine(cfg, params, clock=clock, device=dev,
                                  num_pages=num_pages, **FLEET_GEOMETRY)
        eng.logit_tap = lambda sid, lg: \
            bad.append(sid) if not np.isfinite(lg).all() else None
        if snaps is not None:
            watch_migrations(eng, snaps)
        engines.append(eng)
        return eng

    wl, rc = WorkloadConfig(**trace), ReplayConfig(**FLEET_RC)
    t0 = time.perf_counter()
    if replicas == 1:
        m, gw = run_replay(factory, wl, rc, seed=SEED)
    else:
        m, gw = run_fleet_replay(factory, replicas, wl, rc, seed=SEED,
                                 drain_after_routes=drain)
    torch.cuda.synchronize()
    check(not bad, f"fleet replay: non-finite logits for {bad}")
    check(m.completed_sessions == wl.num_sessions,
          f"fleet replay: {m.completed_sessions}/{wl.num_sessions} "
          f"sessions completed")
    return m, gw, engines, time.perf_counter() - t0


def histories(engines) -> dict:
    """Every session's token stream, wherever it ended up."""
    return {sid: s.history for e in engines for sid, s in e.sessions.items()}


def fused_counts_check(tag, counts, cfg, engines, extra=0) -> None:
    """Each fused round of every replica launched the fused kernel once a
    layer (``extra`` steps besides: the warm-up's buckets)."""
    steps = sum(e.fused_launches for e in engines) + extra
    check(counts["paged_prefill_attention"] == cfg.num_layers * steps,
          f"{tag}: {counts['paged_prefill_attention']} fused launches for "
          f"{steps} steps of {cfg.num_layers} layers")


def fleet_exact_phase(cfg, params, dev) -> dict:
    """(h1) migration is exact: the fleet twin on a barge-free handoff
    trace in f32. The router routes session i to replica i % 3 and
    hands it off iff its turn-1 target differs mod 3; every session's
    stream is the single-replica run's (in f32 a row's result does not
    depend on its batch, so a session resumed on anything but its own
    KV would differ); each migrated session's pages read back bit for
    bit on the destination; each plan moved the session's committed
    pages and the wire bytes add up."""
    from repro_torch.serving.workload import WorkloadConfig, generate
    c32, p32 = f32_twin(cfg, params)
    snaps = {}
    m, gw, engines, secs = fleet_replay(c32, p32, dev, H1_TRACE,
                                        snaps=snaps)
    _, _, single, secs1 = fleet_replay(c32, p32, dev, H1_TRACE, replicas=1)
    del p32
    torch.cuda.empty_cache()
    trace = generate(WorkloadConfig(**H1_TRACE))
    want_routes = [("route", s.session_id, i % FLEET)
                   for i, s in enumerate(trace)]
    want = [("handoff", s.session_id, i % FLEET, t.handoff_target % FLEET)
            for i, s in enumerate(trace)
            for t in s.turns[1:FLEET_RC["max_turns"]]
            if t.handoff and t.handoff_target % FLEET != i % FLEET]
    got = gw.router.decisions
    check(want and [d for d in got if d[0] == "route"] == want_routes
          and sorted(d for d in got if d[0] != "route") == sorted(want),
          f"(h1) decisions {got}, the trace predicts {want_routes} and "
          f"{want}")
    done = gw.migrator.completed()
    check(len(done) == len(want) and not gw.migrator.plans
          and not gw.migrator.cancelled()
          and all(p.kind == "handoff" for p in done),
          f"(h1) {len(done)} of {len(want)} handoffs completed")
    ref = histories(single)
    got_h = histories(engines)
    same = sum(got_h.get(sid) == h for sid, h in ref.items())
    check(got_h == ref, f"(h1) {same}/{len(ref)} sessions stream as on "
          f"one replica")
    for p in done:
        snap = snaps.get(p.session_id)
        check(snap is not None and snap["after"] is not None,
              f"(h1) {p.session_id}: its landed pages were never read")
        check(p.pages == snap["pages"] > 0,
              f"(h1) {p.session_id}: moved {p.pages} pages of "
              f"{snap['pages']} committed")
        check(torch.equal(as_bytes(snap["before"]), as_bytes(snap["after"])),
              f"(h1) {p.session_id}: landed pages differ from the source's")
    wire = sum(gw.replicas.interconnect.wire_bytes(p.pages) for p in done)
    check(m.migration_bytes == wire,
          f"(h1) migration_bytes {m.migration_bytes} != {wire}")
    log(f"[fleet] (h1) handoff f32, {FLEET} replicas: decisions as the "
        f"trace predicts ({len(want)} handoffs, routes i % {FLEET}); "
        f"streams of {len(ref)}/{len(ref)} sessions equal one replica's; "
        f"{sum(p.pages for p in done)} pages moved, each bit for bit; "
        f"migration_bytes {m.migration_bytes:.0f}; migration_off_path "
        f"{m.summary()['migration_off_path']:.4f}; {gw.rounds} replica "
        f"rounds in {secs:.1f} s (one replica: {secs1:.1f} s)")
    return dict(engines=engines + single, cfg=c32)


def fleet_drain_phase(cfg, params, dev) -> dict:
    """(h2) drains and cancels on a tight pool, bf16: the interactive
    trace with barge-ins, replica 0 drained after 6 routes, 18 pages a
    replica. Every plan ends done or cancelled as the decision log
    accounts for, the drained replica ends empty, every replica's pages
    are conserved."""
    m, gw, engines, secs = fleet_replay(cfg, params, dev, H2_TRACE,
                                        num_pages=H2_PAGES, drain=H2_DRAIN)
    moves = [d for d in gw.router.decisions
             if d[0] in ("migrate", "handoff")]
    done, cancelled = gw.migrator.completed(), gw.migrator.cancelled()
    check(moves and len(done) + len(cancelled) == len(moves)
          and not gw.migrator.plans
          and all(p.reason in ("barge", "hangup", "dst_pressure")
                  for p in cancelled),
          f"(h2) {len(moves)} decided, {len(done)} done, cancelled "
          f"{[p.reason for p in cancelled]}")
    check(("drain", H2_DRAIN[0]) in gw.router.decisions,
          f"(h2) replica {H2_DRAIN[0]} was never drained")
    check(sum(e.kv.evicted_blocks for e in engines) > 0,
          "(h2) the pools never evicted")
    for i, e in enumerate(engines):
        e.flush_transfers()
        e.check_invariants()
        check(e.pool.free_pages == e.num_pages
              and all(s.ended for s in e.sessions.values()),
              f"(h2) replica {i} ends holding pages or live sessions")
    log(f"[fleet] (h2) interactive "
        f"{str(cfg.activation_dtype()).replace('torch.', '')}, barge-in "
        f"{H2_TRACE['p_barge_in']}, replica "
        f"{H2_DRAIN[0]} drained after {H2_DRAIN[1]} routes, "
        f"{H2_PAGES} pages a replica: {len(moves)} migrations decided, "
        f"{len(done)} done, cancelled {[p.reason for p in cancelled]}; "
        f"migration seconds on the path {m.migration_on_path_s:.6g}, off "
        f"it {m.migration_off_path_s:.6g} (modeled); evicted "
        f"{[e.kv.evicted_blocks for e in engines]}, reloaded "
        f"{[e.kv.reloaded_blocks for e in engines]} blocks; routed "
        f"{gw.router.routed}; {gw.rounds} replica rounds in {secs:.1f} s")
    return dict(engines=engines)


def live_fleet_phase(cfg, params, dev, f1: dict) -> dict:
    """(h3) ``run_fleet_workload`` on the wall clock at scale 1: (f1)'s
    interactive trace at 12 sessions over 3 replicas of (f1)'s geometry
    sharing the weights, replica 0 drained after 6 routes. Held to what
    the trace determines; each replica round's host time is read around
    ``run_round``, and each replica's first round beside its median (the
    warm-up ran on replica 0 alone)."""
    from repro_torch.serving.fleet import build_fleet_gateway, \
        run_fleet_workload
    from repro_torch.serving.workload import WorkloadConfig
    t0 = time.perf_counter()
    gw = build_fleet_gateway(
        replicas=FLEET, policy="liveserve", scale=1.0, model=(cfg, params),
        device=dev, slots=LIVE_SLOTS, page_size=16, pages_per_seq=40,
        round_token_budget=LIVE_BUDGET, prefill_chunk=LIVE_CHUNK,
        audio_per_token_s=LIVE_APT, frontier_cap_s=FRONTIER_CAP_S,
        seed=SEED, drain_after_routes=H3_DRAIN)
    warm = time.perf_counter() - t0
    engines = list(gw.replicas)
    check(all(e.params is params for e in engines),
          "(h3) the replicas do not share one set of weights")
    bad, round_s = [], [[] for _ in engines]
    for i, eng in enumerate(engines):
        eng.logit_tap = lambda sid, lg: \
            bad.append(sid) if not np.isfinite(lg).all() else None

        def timed_round(chunks, run_round=eng.run_round, times=round_s[i]):
            t = time.perf_counter()
            out = run_round(chunks)
            times.append(time.perf_counter() - t)
            return out

        eng.run_round = timed_round
    t1 = time.perf_counter()
    m, gw = run_fleet_workload(policy="liveserve", seed=SEED, gateway=gw,
                               timeout_s=600, **H3_TRACE)
    secs = time.perf_counter() - t1
    tag = "(h3) live fleet"
    check(not bad, f"{tag}: non-finite logits for {bad}")
    wl = WorkloadConfig(kind=H3_TRACE["kind"],
                        num_sessions=H3_TRACE["sessions"], seed=SEED,
                        p_barge_in=H3_TRACE["barge_in"],
                        arrival=H3_TRACE["arrival"],
                        rate_rps=H3_TRACE["rate_rps"])
    front_end_checks(tag, m, engines, wl, H3_TRACE["max_turns"], LIVE_APT,
                     gw.max_over_frontier_s)
    done = gw.migrator.completed()
    check(done, f"{tag}: no migration completed")
    for i, e in enumerate(engines):
        e.flush_transfers()
        e.check_invariants()
        check(e.pool.free_pages == e.num_pages,
              f"{tag}: replica {i} ends holding pages")
    s = m.summary()
    allr = [t for r in round_s for t in r]
    log(f"[fleet] {tag}: {len(m.turns)} turns "
        f"({sum(t.barged for t in m.turns)} barged), P50 TTFP "
        f"{s['p50_ttfp']:.4f} s, P90 TTFP {s['p90_ttfp']:.4f} s (one "
        f"replica, 8 sessions, (f1): {f1['p50_ttfp']:.4f} / "
        f"{f1['p90_ttfp']:.4f} s), continuity {s['continuity']:.4f}; "
        f"{len(done)} migrations done of "
        f"{len(gw.router.migration_decisions())} decided, "
        f"migration_off_path {s['migration_off_path']:.4f}")
    for i, e in enumerate(engines):
        r = round_s[i]
        log(f"[fleet] {tag} replica {i}: routed {gw.router.routed[i]}, "
            f"migrated in {sum(p.dst == i for p in done)} out "
            f"{sum(p.src == i for p in done)}, peak occupancy "
            f"{m.replica_occupancy[i]:.4f}, {len(r)} rounds"
            + (f", {1e3 * sum(r) / len(r):.2f} ms/round (median "
               f"{1e3 * float(np.median(r)):.2f}, first "
               f"{1e3 * r[0]:.2f})" if r else "")
            + (" [drained]" if i in gw.router.draining else ""))
    log(f"[fleet] {tag}: {gw.rounds} replica rounds, "
        f"{1e3 * sum(allr) / len(allr):.2f} ms/round, {sum(allr):.1f} s of "
        f"{secs:.1f} s in rounds; warm-up {warm:.1f} s")
    return dict(engines=engines)


def launcher_fleet_phase() -> None:
    """(h4) the launcher's fleet on the card: ``--engine live --replicas
    3 --workload handoff`` at qwen2-1.5b on three sessions, two of which
    hand off to another replica; it must print one row per replica."""
    import os
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--engine",
           "live", "--replicas", str(FLEET), "--workload", "handoff",
           "--sessions", "3"]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env=dict(os.environ,
                                            PYTHONPATH=str(ROOT / "src")))
    check(out.returncode == 0, f"(h4) {' '.join(cmd[1:])} exited "
          f"{out.returncode}: {out.stderr[-2000:]}")
    lines = out.stdout.splitlines()
    rows = [ln for ln in lines if ln.startswith("replica") and "routed=" in ln]
    check(len(rows) == FLEET and all("peak_occupancy=" in r for r in rows),
          f"(h4) replica rows: {rows}")
    summary = {ln.split()[0]: ln.split()[1] for ln in lines
               if ln.split()[:1] in (["p50_ttfp"], ["p90_ttfp"],
                                     ["handoffs"], ["migrations"],
                                     ["rounds"])}
    check(int(summary.get("handoffs", 0)) > 0, f"(h4) no handoff: {summary}")
    log(f"[fleet] (h4) {' '.join(cmd[1:])}: {time.perf_counter() - t0:.1f}"
        f" s; " + "; ".join(f"{k} {v}" for k, v in summary.items())
        + "; " + "; ".join(" ".join(r.split()) for r in rows))


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
    # (e) the paged engine's feature planes at full width, each part
    # with its own counts: every one runs the fused kernel
    t_e = time.perf_counter()
    feature = {}
    for tag, fn, args in (
            ("prefix plane (e1)", prefix_phase, (cfg, params, dev)),
            ("spec plane (e2)", spec_phase,
             (cfg, params, dev, eng["planes"]["fused"])),
            ("int8 wire tier (e3)", int8_phase, (cfg, params, dev))):
        feature[tag], counts = main_path(tag, fn, *args)
        add(counts, {"paged_prefill_attention": 0})
    log(f"[feature] phase (e): {time.perf_counter() - t_e:.1f} s")
    # (f) the front end: the live gateway under each policy and the
    # replay twin, each part with its own counts
    t_f = time.perf_counter()
    f1, counts = main_path("live gateway, liveserve (f1)", live_phase, cfg,
                           params, dev, "liveserve")
    add(counts, {"paged_prefill_attention": 0})
    f2, counts = main_path("live gateway, fcfs (f2)", live_phase, cfg,
                           params, dev, "fcfs")
    add(counts, {"paged_prefill_attention": 0})
    log(f"[frontend] P90 TTFP: liveserve (f1) {f1['p90_ttfp']:.4f} s, "
        f"fcfs (f2) {f2['p90_ttfp']:.4f} s (random weights; no ordering "
        f"is held)")
    replay32, counts = main_path("replay twin (f3)", replay_phase, cfg,
                                 params, dev)
    add(counts, {"paged_prefill_attention": 0, "paged_attention": 0})
    log(f"[frontend] phase (f): {time.perf_counter() - t_f:.1f} s")
    # (g) the sharded page plane: its paths ran in the ranks, each rank
    # counting its own launches from zero just before each path
    torch.cuda.empty_cache()
    for tag, counts, (what, _) in sharded_phase(
            cfg, params, dev, eng["planes"],
            feature["spec plane (e2)"], replay32):
        log(f"[launches] {tag}: {counts}")
        add(counts, {"paged_attention": 0, "flash_prefill": 0}
            if what == "tokenwise" else {"paged_prefill_attention": 0})
    # (h) the replica fleet, each part with its own counts: every
    # replica's fused rounds run the fused kernel
    t_h = time.perf_counter()
    h1, counts = main_path("fleet twin, handoffs (h1)", fleet_exact_phase,
                           cfg, params, dev)
    add(counts, {"paged_prefill_attention": 0})
    fused_counts_check("(h1)", counts, cfg, h1["engines"])
    h2, counts = main_path("fleet twin, drains (h2)", fleet_drain_phase,
                           cfg, params, dev)
    add(counts, {"paged_prefill_attention": 0})
    fused_counts_check("(h2)", counts, cfg, h2["engines"])
    h3, counts = main_path("live fleet (h3)", live_fleet_phase, cfg, params,
                           dev, f1)
    add(counts, {"paged_prefill_attention": 0})
    # the warm-up steps once per query-axis bucket up to the chunk
    fused_counts_check("(h3)", counts, cfg, h3["engines"],
                       extra=LIVE_CHUNK.bit_length())
    del h1, h2, h3
    launcher_fleet_phase()
    log(f"[fleet] phase (h): {time.perf_counter() - t_h:.1f} s")
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
