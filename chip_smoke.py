"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version at full-width shapes, then
drives the port's main paths at full width with random weights from a
seed, each with the kernels' launch counts zeroed just before it and
read just after:

- the paged multi-turn engine (qwen2-1.5b, 28 layers, bf16) on both
  planes: (a) the scripted demo, (b) a mixed prefill/decode trace (then
  profiled on the first 4 layers);
- (a') the scripted demo on the per-token plane, whose turns 0 take the
  dense prefill graft (``flash_prefill``);
- (c) the single-turn ring-cache engine on qwen2-1.5b (``flash_prefill``)
  and (d) on mamba2-1.3b (48 layers, ``ssd_scan``), each against a B = 1
  greedy reference and a full-width prefill through the plain versions;
  (d) also profiles one prefill for the ``ssd_scan`` kernels' share;
- (e) the paged engine's feature planes on qwen2-1.5b: (e1) on its
  first 4 layers, eight sessions sharing a 250-token system prompt on
  the prefix plane (a copy-on-write of the shared tail page included)
  against the ``prefix_cache=False`` twin, (e2) phase (b)'s trace with
  three-token n-gram drafts against its K = 0 tokens, (e3) the int8 wire tier's
  quality gate and the quantizer's bound on real offloaded pages; the
  twins' streams must agree in f32, where only a fault can part them;
- (f) the front end on qwen2-1.5b: (f1) the live asyncio gateway
  (``run_gateway_workload``) serving 8 interactive sessions with
  barge-ins on the wall clock at scale 1 under the liveserve policy and
  (f2) the same trace under fcfs, each held to what the trace
  determines; (f3) the virtual-time replay twin (``run_replay``) on a
  pool tight enough to evict, with the next-use eviction oracle, on
  both planes in f32 (identical streams and turn records) and in bf16,
  on the first 4 layers (``CUT_LAYERS``);
- (g) the sharded page plane (``mesh=``), on qwen2-1.5b's first 4 of
  28 layers at full width: (g0) the paged kernels' sharding options
  (``pos_stride``, ``pos_offset``, ``return_stats``) at the engine's
  shapes in one process, against the plain version, the stripe merge
  and the unsharded kernel; then meshes of 2 (heads), 4 (slots) and 3
  (replicated) ranks that share the card and talk gloo through host
  memory, each rank a process of its own: (g1) the global-view sharded
  kernels (and ``sharded_flash_prefill``) against the single-device
  kernels, (g2) the sharded engine: phase (b)'s trace at M 2 in bf16
  and M 4 in f32, token for token the single-device engine's on the
  same layers (bf16 on slots runs in (g1) and (h5b); its M 4 trace was
  cut for the script's time), a short per-token trace at M 4 (the
  decode kernel with stats, the dense graft) and phase (f3)'s replay at
  M 4 in f32, record for record the single-device
  run's; the ranks' launch counts are summed into the kernels' line;
- (h) the replica fleet on qwen2-1.5b's first 4 layers: three paged
  engines in this process sharing the one set of weights, behind one
  gateway: (h1) the
  fleet twin (``run_fleet_replay``) on a barge-free agent-handoff trace
  in f32, its router decisions the ones the trace predicts, every
  session's stream the single-replica run's, each migrated session's
  pages read through the device plane bit for bit on both replicas,
  the wire bytes those of the moved pages; (h2) the fleet twin in bf16
  with barge-ins, a drained replica and pools that evict: every plan
  done or cancelled as the decision log says, the drained replica
  empty; (h3) the live fleet gateway (``run_fleet_workload``) serving 8
  interactive sessions on the wall clock at scale 1 with a drained
  replica's sessions live-migrating; (h4) the launcher's ``--replicas 3
  --workload handoff`` (``--layers 4``, the clock at scale 16);
- (h5) the replica fleet over a mesh on the same 4 layers: two
  replicas, each sharding its page store over one mesh of ranks that
  share the card (gloo through host memory), the leader running the
  fleet's control plane and the other ranks following both replicas in
  one loop: (h5a) (h1)'s handoff trace in f32 on a 1x2 mesh (heads),
  decisions, turn records and every session's stream equal to the
  same fleet's on one device, each migrated session's pages read
  through the device plane bit for bit; (h5b) an (h2)-style bf16 trace
  on a 1x4 mesh (slots) with barge-ins, a drained replica and pools
  that evict: every plan done or cancelled as the decision log says,
  every replica (the drained one too) empty at the end, the streams
  logged against one device's; (h5c) the launcher's ``--engine live
  --replicas 2 --mesh 1x2 --workload handoff`` (``--layers 4``, two
  sessions, the clock at scale 16), every turn served; the ranks'
  launch counts are summed into the kernels' line;
- (i) the moe and vlm families: (i0) the three attention kernels at
  head dim 256 (paligemma-3b's round, MQA with 8 query heads) against
  their plain versions; (i1) paligemma-3b on 9 of 18 layers (bf16) on
  both planes of phase (b)'s trace, and its f32 twin on both planes and
  through the per-token plane's dense graft, held to the B = 1 greedy
  streams; (i2) phi3.5-moe at full width on 2 of its 32 layers (16
  experts, top-2): bf16 at the published capacity factor on both
  planes (its streams against B = 1 logged: capacity drops tie a token
  to its batch), its fused streams unchanged when the padded query
  slots hold zeros or random values (the moe layers route only real
  tokens), and the f32 twin at capacity factor E / k, held to B = 1;
  the moe dispatch and ordered combine timed alone (host and device)
  against the ``index_add_`` combine they replaced; (i3) the launcher's ``--engine real`` at paligemma-3b and at
  qwen3-4b (36 layers, ``qk_norm``);
- (j) the hybrid and encdec families on the ring-cache model: (j0)
  ``flash_prefill`` at recurrentgemma-9b's local layers (16 query heads
  on one KV head of 256, window 2048, S 2047-3000) and whisper-tiny's
  encoder and cross-attention (D 64, not causal, 1500 frames) against
  its plain version, timed beside SDPA; (j1) recurrentgemma-9b whole
  (38 layers, bf16) on the single-turn engine, prompts of 517-3000
  tokens on a 2048-slot ring, held to B = 1 and the plain versions,
  one prefill and one decode round profiled; (j2) whisper-tiny whole
  through ``prefill(enc_frames=)`` and ``decode_step`` over 1500 seeded
  frames, B 4, in bf16 and f32 (f32 held to B = 1), against the plain
  versions;
- (k) head dims 192 and 80 and the mla family: (k0) the paged pair at
  nemotron-4's heads (96 on 8 KV heads of 192) and at h2o-danube's (32
  on 8 of 80) on trace (b)'s round, and ``flash_prefill`` causal at
  nemotron-4's heads, at multi-head latent attention's (128 heads of
  192, V's 128 columns padded) and windowed at h2o-danube's (4096,
  S 4095-5000), each against its plain version and timed beside SDPA;
  (k1) deepseek-v2-236b at full width on its first 4 of 60 layers (MLA,
  160 experts top-6) on the single-turn engine, 4 prompts of 64-2048
  tokens, against its plain prefill, and its f32 twin on 2 layers held
  to B = 1; (k2) nemotron-4-340b at full width on its first 2 of 96
  layers on both planes of trace (b), and its f32 twin on 1 layer held
  to B = 1; (k3) h2o-danube-1.8b on 12 of 24 layers on the single-turn
  engine, prompts of 1171-5000 tokens on a 4096-slot ring, bf16 and f32
  (f32 held to B = 1), against the plain versions; (k4) qwen3-4b at full
  width on 9 of its 36 layers in f32 on both planes of trace (b), held
  to B = 1;
- (l) single-device training, no kernel on its path (each part's counts
  must stay 0): (l0) qwen2-1.5b whole (28 layers, bf16, AdamW) for 15
  steps of 8 x 256 synthetic tokens, the loss falling, ms a step,
  tokens/s and peak memory, one step profiled; (l1) its first 2 layers
  at full width in f32, the card's loss and every gradient leaf against
  the CPU's, one AdamW update from the CPU's gradients on both, and
  (outside the counts) ``forward``'s logits against the
  ``flash_prefill`` prefill's; (l2) microbatches 2 with remat against
  one batch; (l3) on its first 4 layers, 10 steps straight against 5, an
  ``async_save``, a simulated failure, ``run_resilient``'s restore
  (bit-equal, bf16 leaves included) and 5 more; (l4) the launcher
  (whole) with a checkpoint, then ``--resume``; (l5) every other family
  at full width for 5 steps on one batch, the loss falling (deepseek-v2
  on its dense and one moe layer with Adafactor, recurrentgemma-9b on
  one rglru, rglru, attention group; h2o-danube past its window with
  remat, paligemma with 256 patches under the prefix-LM mask, mamba2,
  whisper over 1500 frames whole);
- (m) kernel autotune at qwen2-1.5b's live geometry (bf16, 8 slots,
  pages of 16, 40 a session): the cost model's launch cost and memory
  rate measured, the paged pair's ``span`` swept over the decode kind
  and the fused kind at Q 1-16 (one line per candidate: device µs,
  modeled µs, error against the plain version), the cache saved and
  reloaded; at the pick, the decode kernel equal to the fused one at
  Q = 1 bit for bit, and both kernels in f32 held to the plain version
  at 2e-5; the engine's fused round with the cache held to the round
  without (the bf16 tolerance, every argmax equal, the cache hit); the
  launcher's ``--engine live --autotune`` at full width; the paged rows
  re-timed at the default span with the device-only timer;
- (n) training over a ('data', 'model') mesh of rank processes sharing
  the card over gloo, no kernel on its path (every rank's counts must
  stay 0), each single-device reference run first and freed: (n1)
  qwen2-1.5b on its first 4 layers (bf16, AdamW) on 1x2 through the
  launcher's own rank body (``launch/train.py::prepare``, then
  ``train_loop``), 3 steps of 8 x 256 and a checkpoint at the last
  (saved from the mesh, full leaves from rank 0), the losses held to the
  single-device launcher's, each rank's peak memory under one device's,
  the leaves every rank holds whole bit-equal; then ``--resume``'s
  restore onto the mesh, every rank's blocks bit-equal to the ones it
  saved; (n2) its first 4 layers on 2x2 with FSDP in bf16, and an f32
  twin on 1 layer whose loss and every gradient leaf (made whole) are
  held to one device's at 1e-4; (n3)
  phi3.5-moe at full width on 2 of 32 layers on 1x2 (8 of 16 experts a
  rank, Adafactor), held to one device's step with the slice-wise moe
  (``slicewise_moe``, the checker); (n4) in the same 1x2 ranks, the
  other families at full width in bf16, 2 steps each held to one
  device's losses: paligemma-3b on 2 of 18 layers with 256 patches,
  mamba2-1.3b on 4 of 48, recurrentgemma-9b on one group,
  whisper-tiny whole over 1500 frames, deepseek-v2-236b on 2 of 60
  (mla, Adafactor; the slice-wise moe the checker); in (n2)'s 2x2
  ranks, ``compressed_psum`` of each rank's f32 twin gradients over
  'data' within 0.02 of the exact mean's max, and the bf16 parameters
  saved from the mesh and ``elastic_rescale``d onto a 1x4 view of the
  four ranks, bit-equal to its ``local_block`` of each saved leaf;
- (o) serving over a mesh and the dry run: (o1) in (n1)'s 1x2 ranks,
  qwen2-1.5b whole in bf16, ``prefill(mesh=)`` of B 2 x 1024 into a
  2048-slot ring (each rank's heads through ``flash_prefill``, 28
  launches a rank) then 8 ``decode_step(mesh=)`` calls, and its f32
  twin on 2 layers, each held to one device's logits and greedy
  tokens, the collective bytes each call records equal to the dry
  run's for the same calls on a placeholder 1x2 mesh; (o2) in (n2)'s
  2x2 ranks, phi3.5-moe on 2 of 32 layers in f32 with ``expert_tp``
  held to one device's slice-wise moe; (o3) the dry run of (l0)'s
  train step on meta tensors against the card's: its flops equal
  ``FlopCounterMode`` on the card, its peak above the arguments within
  25 % of the card's; (o4) the dry run of qwen2-1.5b x train_4k and
  deepseek-v2-236b x decode_32k (``expert_tp``) on the 16 x 16
  placeholder mesh, a process for each beside (l4), whose launcher
  processes time nothing but their whole run;

and checks what comes out. Every phase is checked; any failure exits
non-zero. The last line of standard output is

  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

It exits non-zero without a result when no CUDA device is present or
when the package it tests is not beside it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import json
import math
import os
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


def flash_bound(q, k, window, q_offset, causal=True):
    """Least time (ms) for one ``flash_prefill`` call: q, k, v read and
    out written once over the memory rate, or the multiply-adds of QK^T
    and PV over the (query, key) pairs the masks leave, over the peak
    rate of the input type, whichever is larger."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    qpos = np.arange(Sq) + q_offset
    # causal: keys < hi; otherwise every key
    hi = np.minimum(qpos + 1, Skv) if causal else np.full_like(qpos, Skv)
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
        fn = ""
        for line in rep.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1][:110]
            elif "Used" in line or "spill" in line:
                log(f"[build] {name}: {fn}: {line.strip()}")
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


def kernel_case(dev, dtype, B, Q, ctx, g, Hq=12, Hkv=2, D=128):
    """Full-width heads (qwen2-1.5b's Hq 12, Hkv 2, D 128 by default),
    page 16, the engine's row count: ``ctx`` context tokens per row
    before its chunk, rows 0-1 prefilling a Q-token chunk, the others
    decoding one token, the last row padding (q_lens 0)."""
    page = 16
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


def trace_prompts(rng, n_sessions: int, vocab: int) -> list:
    """``mixed_trace``'s prompts: 64-320 tokens each."""
    lens = rng.integers(64, 320, size=n_sessions)
    return [rng.integers(0, vocab, size=int(n)) for n in lens]


def mixed_trace(eng, rng, n_sessions: int, max_new: int, chunk: int,
                decode_grant: int = 1):
    """submit_turn/run_round with chunked prefill grants interleaved with
    decode: half the sessions start at once, the rest a few rounds
    later, so prefill chunks share rounds with decoding slots. A decode
    slot is granted ``decode_grant`` tokens (1 + K carries a spec
    engine's draft budget). Returns (per-session tokens, rounds, granted
    tokens, seconds)."""
    prompts = trace_prompts(rng, n_sessions, eng.cfg.vocab_size)
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
    profile_rounds(*first_layers(cfg, params, CUT_LAYERS), dev)
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
        f"{t_prefill:.2f} s; {rounds} decode rounds in "
        f"{secs - t_prefill:.2f} s; {secs:.2f} s in all")
    return out


def single_turn_check(cfg, params, dev, prompts, out, n_new, capacity,
                      hold: bool = True,
                      types=(torch.bfloat16, torch.float32)):
    """Each session's tokens against the B = 1 greedy reference (held,
    or with ``hold`` False only logged: in bf16 a batch's products round
    at other shapes than B = 1's, which can flip a near tie of an
    untied model's random logits), and a full-width prefill of the
    longest prompt through the kernels against one through their plain
    versions, in each of ``types``."""
    from repro_torch.models.model import init_cache, prefill
    same = {sid: out[sid] == greedy(cfg, params, p, n_new, capacity, dev)
            for sid, p in prompts.items()}
    log(f"[single] {cfg.name} {str(cfg.activation_dtype())[6:]}: sessions "
        f"with the greedy reference's tokens: {sum(same.values())}/"
        f"{len(same)}{'' if hold else ' (logged)'}; "
        f"first tokens {[out[s][:6] for s in sorted(out)]}")
    check(all(same.values()) or not hold, f"{cfg.name}: engine tokens "
          f"differ from the greedy reference for "
          f"{[s for s, ok in same.items() if not ok]}")
    for s in out:
        check(len(out[s]) == n_new, f"{s}: {len(out[s])} tokens")
    longest = max(prompts.values(), key=len)
    tok = torch.as_tensor(longest, device=dev)[None, :]
    for dtype in types:
        name = str(dtype)[6:]
        c = cfg.replace(dtype=name, param_dtype=name)
        p = cast_params(params, dtype)
        got = prefill(c, p, tok, init_cache(c, 1, capacity, dev))[0]
        want = prefill(c, p, tok, init_cache(c, 1, capacity, dev),
                       plain=True)[0]
        logits_vs_plain(f"[single] {cfg.name} {name}: {len(longest)}-token "
                        "prefill", got, want, dtype)
        del p


def logits_vs_plain(tag, got, want, dtype) -> None:
    """A prefill's logits through the kernels against the same prefill
    through their plain versions: finite, and within a tolerance of the
    logits' scale. The kernels sum in f32 in another order than the
    plain versions. f32: ~1e-6 relative per layer output, carried
    through up to 48 layers: 1e-4 of the logits' scale. bf16: each
    layer's output is rounded to bf16, so those differences flip ulps
    (~4e-3 relative) that carry through the depth: 3e-2."""
    torch.cuda.synchronize()
    check(torch.isfinite(got).all().item(), f"{tag}: logits non-finite")
    check(got.shape == want.shape, f"{tag}: shape {tuple(got.shape)}")
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    tol = (1e-4 if dtype == torch.float32 else 3e-2) * scale
    agree = bool((got.argmax(-1) == want.argmax(-1)).all())
    log(f"{tag}, kernels vs plain: logits max_abs_err {err:.3e} (scale "
        f"{scale:.2f}, tol {tol:.3e}), argmax equal {agree}")
    check(err <= tol, f"{tag}: {err} > {tol}")


def prompts_for(cfg, rng, lens) -> dict:
    return {f"s{i}": rng.integers(0, cfg.vocab_size, size=int(n))
            for i, n in enumerate(lens)}


def device_us_by_kernel(prof, ranges=()) -> dict:
    """{kernel name: device µs} summed over a ``torch.profiler`` run; the
    device-side spans of the ``record_function`` ``ranges`` (names) are
    not kernels and are left out."""
    from torch.autograd import DeviceType
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.name not in ranges:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us()
    return by_name


def profile_rounds(cfg, params, dev) -> None:
    """Where a fused round's time goes: the same trace once more under
    ``torch.profiler`` (its overhead stays out of the timings above), on
    the first CUT_LAYERS layers (cut from all 28: the profiler's
    processing of every layer's events took ~70 s). Prints the device's
    busy share of the wall time and the kernels that took the most
    device time."""
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
    log(f"[profile] fused plane under the profiler ({cfg.num_layers} "
        f"layers): {rounds} rounds in "
        f"{wall_us / 1e3:.1f} ms wall; device busy {busy / 1e3:.1f} ms = "
        f"{100 * busy / wall_us:.1f}% of wall")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[profile]   {us / 1e3:8.2f} ms  {100 * us / busy:5.1f}%  "
            f"{name[:90]}")


def profile_prefill(cfg, params, dev, prompt, capacity, kernels,
                    ranges=()) -> None:
    """(d), (j1) Where a full-width B = 1 prefill of ``prompt`` spends its
    time (``profile_call``), after one prefill to warm up."""
    from repro_torch.models.model import init_cache, prefill
    tok = torch.as_tensor(prompt, device=dev)[None, :]

    def run():
        prefill(cfg, params, tok, init_cache(cfg, 1, capacity, dev))
    run()
    profile_call(f"{cfg.name} {len(prompt)}-token prefill", run, kernels,
                 ranges)


def profile_call(tag, run, kernels, ranges=()) -> None:
    """``run()`` once unprofiled, timed on the host clock when it returns
    (the host has enqueued every launch) and when the device is done;
    then once under ``torch.profiler``. Prints the device ms and the
    share of the device time of the kernels whose names hold each
    ``kernels`` pattern, and of the kernels launched inside each
    ``ranges`` function (module, name), wrapped for this run in a
    ``record_function`` of its name; then the kernels that took the
    most device time, and the host ops that took the most host time."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    t_host = time.perf_counter() - t0
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    log(f"[profile] {tag}, unprofiled: returned to the host after "
        f"{t_host * 1e3:.2f} ms, device done after {t_all * 1e3:.2f} ms")
    originals = [(mod, name, getattr(mod, name)) for mod, name in ranges]

    def annotated(fn, name):
        def call(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return call
    torch.cuda.synchronize()
    try:
        for mod, name, fn in originals:
            setattr(mod, name, annotated(fn, name))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)
    names = [name for _, name, _ in originals]
    by_name = device_us_by_kernel(prof, names)
    busy = sum(by_name.values())
    if not busy:
        log(f"[profile] the profiler saw no device activity: the shares "
            f"of the {tag} not measured")
        return
    shares = {label: sum(us for name, us in by_name.items() if pat in name)
              for label, pat in kernels.items()}
    for name in names:
        # the kernels of the ops inside the range (not its device span)
        shares[f"{name} (its kernels)"] = sum(
            ch.device_time_total for e in prof.events()
            if e.name == name and e.cpu_children for ch in e.cpu_children)
    log(f"[profile] {tag} under the profiler: {wall_us / 1e3:.2f} ms "
        f"wall; device busy {busy / 1e3:.2f} ms = "
        f"{100 * busy / wall_us:.1f}% of wall"
        + "".join(f"; {label} {us / 1e3:.3f} ms = {100 * us / busy:.1f}% "
                  "of device busy" for label, us in shares.items()))
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
    """(e1) the prefix plane against its ``prefix_cache=False`` twin (on
    the first CUT_LAYERS layers, cut from all 28 for the script's
    time)."""
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


def spec_phase(cfg, params, dev, fused_b: dict, K: int = 3) -> None:
    """(e2) spec_decode=K with the n-gram proposer against phase (b)'s
    K = 0 fused tokens, and in f32 against its K = 0 twin."""
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


def replay_run(cfg, params, dev, fused: bool, mesh=None,
               label: str = "(f3)") -> dict:
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
    tag = (f"{label} {'fused' if fused else 'per-token'} "
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


def replay_phase(cfg, params, dev) -> None:
    """(f3) the replay twin on both planes in f32, where token streams
    and turn records must be identical, then a bf16 fused run, its
    streams logged against f32's (its modeled reload seconds differ:
    a bf16 page is half the bytes on the modeled PCIe link)."""
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


# ======================================================================
# (g) the sharded page plane: M ranks sharing the one card
# ======================================================================
G_CTX = [0, 170, 411, 96, 250, 333, 128, 0]   # row 0 prefills from 0
G_PLANS = {  # the parts each 1xM mesh runs: (g1) kernels, (g2) paths
    2: ["kernels", "flash", ("fused", "bfloat16")],
    4: ["kernels", ("fused", "float32"),
        ("tokenwise", "float32"), ("replay", "float32")],
    3: ["kernels"],
}
G_LAYOUTS = {2: "heads", 4: "slots", 3: "replicated"}
# (f3), (g), (h) and (h5) serve qwen2-1.5b at full width on its first 4
# of 28 layers: a seventh of their rounds' device work and of the
# meshes' per-layer gloo traffic, for the script's time limit
CUT_LAYERS = 4


def first_layers(cfg, params, n: int):
    """``cfg`` and ``params`` cut to their first ``n`` layers (the
    unstacked ``layers_pre`` first): views into the stacked weights,
    every width unchanged. ``layers`` leads the dict, so that
    ``f32_consuming`` frees the stacked storage before it copies the
    embeddings."""
    n_stacked = n - len(params.get("layers_pre", []))

    def cut(t):
        return {k: cut(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[:n_stacked]
    return cfg.replace(num_layers=n), dict(layers=cut(params["layers"]),
                                           **{k: v for k, v in params.items()
                                              if k != "layers"})


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


def g2_trace(cfg, params, dev, mesh=None) -> dict:
    """(g2) phase (b)'s trace on the fused plane, on the sharded engine
    (the leader's result; a follower follows and returns None), or on
    one device without ``mesh``."""
    from repro_torch.serving.paged_engine import PagedRealtimeEngine
    eng = PagedRealtimeEngine(cfg, params, slots=8, page_size=16,
                              pages_per_seq=32, device=dev, mesh=mesh)
    if mesh is not None and not mesh.is_leader:
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
    """(g1)/(g2), or (h5), on one rank of a 1xM mesh on the shared card:
    the parts of ``plan``, each engine path with the kernels' counts
    zeroed just before it and read just after (every rank counts its
    own)."""
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
            cfg, params = first_layers(
                *build_demo("qwen2-1.5b", dev, SEED)[:2], CUT_LAYERS)
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
        elif what == "replay":
            res = replay_run(cfg, params, dev, True, mesh=mesh,
                             label="(g2)")
        else:                             # (h5): "h5a" or "h5b"
            res = mesh_fleet_run(cfg, params, dev, what, mesh)
        out[part] = dict(result=res, counts={n: w.launches
                                             for n, w in wrappers.items()})
    return out


def sharded_phase(cfg, params, dev) -> list:
    """(g) the sharded page plane: (g0) the kernels' options in one
    process, then 1x2 (heads), 1x4 (slots) and 1x3 (replicated) meshes of
    ranks sharing the card over gloo: (g1) the global-view kernels
    against the single-device kernels, (g2) the sharded engine (on
    ``cfg``'s layers) held to the single-device one, run here first on
    the same layers. Returns ``[(tag, summed counts, expected)]`` for the
    (g2) paths."""
    from repro_torch.launch.mesh import spawn
    t_g = time.perf_counter()
    options_phase(dev)
    single = {"bfloat16": g2_trace(cfg, params, dev)}
    c32, p32 = f32_twin(cfg, params)
    single["float32"] = g2_trace(c32, p32, dev)
    tw32 = tokenwise_trace(c32, p32, dev)
    replay32 = replay_run(c32, p32, dev, True, label="(g2) single device")
    del p32
    torch.cuda.empty_cache()
    b = single["bfloat16"]
    log(f"[sharded] single device, {cfg.num_layers} layers: phase (b)'s "
        f"trace in {b['rounds']} rounds, "
        f"{b['secs'] / b['rounds'] * 1e3:.2f} ms/round (bf16)")
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
                log(f"[sharded] {tag}: {res['rounds']} rounds in "
                    f"{res['secs']:.2f} s = "
                    f"{res['secs'] / res['rounds'] * 1e3:.2f} ms/round "
                    f"(single device: "
                    f"{b['secs'] / b['rounds'] * 1e3:.2f} ms/round); "
                    f"sessions with the single-device {dtype} tokens "
                    f"{same}/{len(ref_toks)}")
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
# (h3): (f1)'s trace and geometry on each replica, 8 sessions (cut from
# 12 for the script's time), replica 0 drained after 6 routes (its sessions
# live-migrate at their next turn)
H3_TRACE = dict(LIVE_TRACE, sessions=8)
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
                 num_pages=None, drain=None, snaps=None, mesh=None):
    """``run_fleet_replay`` (one replica: ``run_replay``) of ``trace`` on
    the fused plane, every replica's invariants checked after every
    round and its logits held finite. Returns (metrics, gateway,
    engines, seconds). With ``mesh`` (h5) the replicas shard their pages
    over it: the leader replays, a follower follows and gets None."""
    from repro_torch.serving.fleet import run_fleet_replay
    from repro_torch.serving.gateway.replay import ReplayConfig, run_replay
    from repro_torch.serving.paged_engine import PagedRealtimeEngine
    from repro_torch.serving.workload import WorkloadConfig
    engines, bad = [], []
    leader = mesh is None or mesh.is_leader

    def factory(clock, index=0):
        eng = PagedRealtimeEngine(cfg, params, clock=clock, device=dev,
                                  num_pages=num_pages, mesh=mesh,
                                  mesh_index=index, **FLEET_GEOMETRY)
        eng.logit_tap = lambda sid, lg: \
            bad.append(sid) if not np.isfinite(lg).all() else None
        if snaps is not None and leader:
            watch_migrations(eng, snaps)
        engines.append(eng)
        return eng

    wl, rc = WorkloadConfig(**trace), ReplayConfig(**FLEET_RC)
    t0 = time.perf_counter()
    if replicas == 1:
        m, gw = run_replay(factory, wl, rc, seed=SEED)
    else:
        m, gw = run_fleet_replay(factory, replicas, wl, rc, seed=SEED,
                                 drain_after_routes=drain, mesh=mesh)
    if not leader:
        return None
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
    interactive trace at 8 sessions over 3 replicas of (f1)'s geometry
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
    3 --workload handoff`` at qwen2-1.5b's full width on its first
    CUT_LAYERS layers (cut from all 28) and three sessions, two of which
    hand off to another replica, the clock at scale 16 (cut from 1, then
    4: the trace's wall time); it must print one row per replica and
    hand off and migrate at least once."""
    import os
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--engine",
           "live", "--replicas", str(FLEET), "--workload", "handoff",
           "--sessions", "3", "--clock-scale", "16", "--layers",
           str(CUT_LAYERS)]
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
    check(int(summary.get("handoffs", 0)) > 0
          and int(summary.get("migrations", 0)) > 0,
          f"(h4) no handoff or no migration: {summary}")
    log(f"[fleet] (h4) {' '.join(cmd[1:])}: {time.perf_counter() - t0:.1f}"
        f" s; " + "; ".join(f"{k} {v}" for k, v in summary.items())
        + "; " + "; ".join(" ".join(r.split()) for r in rows))


# ======================================================================
# (h5) the replica fleet over a mesh: every replica shards its pages over
# one 1xM mesh of ranks sharing the card
# ======================================================================
H5_REPLICAS = 2
# (h5a) (h1)'s barge-free handoff trace in f32 on a 1x2 mesh (heads),
# (h5b) an (h2)-style bf16 trace on a 1x4 mesh (slots): 4 sessions with
# barge-ins, replica 0 drained after the last route and 16 pages a
# replica (the pools evict); each fleet's twin on one device runs in
# this process. (h5b) was cut from 5 sessions on 18 pages (198 replica
# rounds, a migration cancelled for its destination's pressure) to 155
# rounds; the CPU tests run the 5-session trace on a mesh
H5_PLANS = {2: [("h5a", "float32")], 4: [("h5b", "bfloat16")]}
H5_RUNS = {"h5a": (H1_TRACE, {}),
           "h5b": (dict(H2_TRACE, num_sessions=4),
                   dict(num_pages=16, drain=(0, 4)))}


def fleet_view(m, gw, engines, secs, snaps=None) -> dict:
    """What (h5) holds between a fleet on a mesh and on one device: the
    decisions, turn records, every session's stream, the plans, each
    migrated session's pages (read through the device plane before the
    move and after the landing: equal bit for bit or not), each
    replica's end state, and the fused steps, rounds and seconds."""
    done = gw.migrator.completed()
    pages = {}
    for p in done:
        snap = (snaps or {}).get(p.session_id)
        if snap is not None:
            pages[p.session_id] = (
                p.pages, snap["pages"], snap["after"] is not None
                and torch.equal(as_bytes(snap["before"]),
                                as_bytes(snap["after"])))
    return dict(
        decisions=list(gw.router.decisions),
        records=[dataclasses.asdict(t) for t in m.turns],
        histories=histories(engines),
        plans=[(p.session_id, p.src, p.dst, p.state, p.reason, p.kind,
                p.pages) for p in gw.migrator.log],
        open_plans=len(gw.migrator.plans), pages=pages,
        migration_bytes=m.migration_bytes,
        wire=sum(gw.replicas.interconnect.wire_bytes(p.pages) for p in done),
        off_path=m.summary()["migration_off_path"],
        on_path_s=m.migration_on_path_s, off_path_s=m.migration_off_path_s,
        evicted=[e.kv.evicted_blocks for e in engines],
        reloaded=[e.kv.reloaded_blocks for e in engines],
        empty=[e.pool.free_pages == e.num_pages and e.transfer.idle()
               and all(s.ended for s in e.sessions.values())
               for e in engines],
        steps=sum(e.fused_launches for e in engines), rounds=gw.rounds,
        secs=secs)


def mesh_fleet_run(cfg, params, dev, what: str, mesh=None):
    """(h5a) or (h5b): its trace on ``H5_REPLICAS`` replicas, on ``mesh``
    (the leader returns ``fleet_view``, a follower None) or on one
    device. (h5a) reads each migrated session's pages."""
    trace, kw = H5_RUNS[what]
    snaps = {} if what == "h5a" else None
    out = fleet_replay(cfg, params, dev, trace, replicas=H5_REPLICAS,
                       snaps=snaps, mesh=mesh, **kw)
    return None if out is None else fleet_view(*out, snaps)


def mesh_fleet_phase(cfg, params, dev) -> list:
    """(h5a)/(h5b): each fleet twin on one device here, then on its mesh
    of ranks sharing the card over gloo (1x2 heads in f32, 1x4 slots in
    bf16). (h5a) is held record for record, stream for stream and page
    for page to one device; (h5b) to its decision log and end states,
    its streams logged against one device's. Returns the counts of every
    path (a mesh's summed over its ranks)."""
    from repro_torch.launch.mesh import spawn
    c32, p32 = f32_twin(cfg, params)
    single = {}

    def one_device():
        single["h5a"] = mesh_fleet_run(c32, p32, dev, "h5a")
        single["h5b"] = mesh_fleet_run(cfg, params, dev, "h5b")
    _, counts = main_path("fleet twins on one device (h5)", one_device)
    paths = [counts]
    steps = single["h5a"]["steps"] + single["h5b"]["steps"]
    check(counts["paged_prefill_attention"] == cfg.num_layers * steps,
          f"(h5) one device: {counts['paged_prefill_attention']} fused "
          f"launches for {steps} steps of {cfg.num_layers} layers")
    del p32
    torch.cuda.empty_cache()
    for M, plan in H5_PLANS.items():
        kind = G_LAYOUTS[M]
        t0 = time.perf_counter()
        outs = spawn(f"1x{M}", sharded_rank, plan, device="cuda",
                     timeout_s=600)
        log(f"[fleet] (h5) 1x{M} ({kind}): {M} ranks on one card, gloo "
            f"through host memory, {time.perf_counter() - t0:.1f} s")
        for part in plan:
            what, dtype = part
            got, one = outs[0][part]["result"], single[what]
            counts = {n: sum(o[part]["counts"][n] for o in outs)
                      for n in outs[0][part]["counts"]}
            tag = f"({what}) 1x{M} {kind} {dtype}"
            log(f"[launches] {tag}: {counts}")
            paths.append(counts)
            # every rank runs the fused kernel once a layer a fused step
            check(counts["paged_prefill_attention"]
                  == M * cfg.num_layers * got["steps"],
                  f"{tag}: {counts['paged_prefill_attention']} fused "
                  f"launches for {got['steps']} steps of {cfg.num_layers} "
                  f"layers on {M} ranks")
            mesh_fleet_checks(tag, what, got, one)
            same = sum(got["histories"].get(sid) == h
                       for sid, h in one["histories"].items())
            done = [p for p in got["plans"] if p[3] == "done"]
            log(f"[fleet] {tag}: {H5_REPLICAS} replicas, "
                f"{got['rounds']} replica rounds in {got['secs']:.1f} s = "
                f"{got['secs'] / got['rounds'] * 1e3:.2f} ms/replica round "
                f"(one device {one['secs'] / one['rounds'] * 1e3:.2f}); "
                f"decisions equal {got['decisions'] == one['decisions']}, "
                f"records equal {got['records'] == one['records']}, "
                f"sessions with one device's stream {same}/"
                f"{len(one['histories'])}; {len(done)} of "
                f"{len(got['plans'])} migrations done, cancelled "
                f"{[p[4] for p in got['plans'] if p[3] == 'cancelled']}; "
                f"migration_bytes {got['migration_bytes']:.0f}, "
                f"migration_off_path {got['off_path']:.4f} (seconds on "
                f"the path {got['on_path_s']:.6g}, off it "
                f"{got['off_path_s']:.6g}, modeled); evicted "
                f"{got['evicted']}, reloaded {got['reloaded']} blocks")
    return paths


def mesh_fleet_checks(tag: str, what: str, got: dict, one: dict) -> None:
    """(h5a): decisions, records, streams and plans equal one device's,
    each migrated session's pages land bit for bit, the wire bytes add
    up. (h5b): every decided migration ended done or cancelled as the
    log accounts for, replica 0 was drained, the pools evicted. Both:
    every replica ends empty."""
    moves = [d for d in got["decisions"] if d[0] in ("migrate", "handoff")]
    states = [p[3] for p in got["plans"]]
    check(moves and len(states) == len(moves) and not got["open_plans"]
          and set(states) <= {"done", "cancelled"}
          and all(p[4] in ("barge", "hangup", "dst_pressure")
                  for p in got["plans"] if p[3] == "cancelled"),
          f"{tag}: {len(moves)} decided, plans {got['plans']}")
    check(all(got["empty"]), f"{tag}: replicas end holding pages, live "
          f"sessions or transfers: {got['empty']}")
    if what == "h5a":
        for key in ("decisions", "records", "histories", "plans",
                    "migration_bytes", "evicted", "reloaded"):
            check(got[key] == one[key], f"{tag}: {key} differ from the "
                  f"single-device fleet's")
        done = [p for p in got["plans"] if p[3] == "done"]
        check(done and sorted(got["pages"]) == sorted(p[0] for p in done),
              f"{tag}: pages read for {sorted(got['pages'])}, migrations "
              f"done {done}")
        for sid, (moved, committed, exact) in got["pages"].items():
            check(moved == committed > 0 and exact,
                  f"{tag}: {sid} moved {moved} of {committed} pages, "
                  f"bit for bit {exact}")
        check(got["migration_bytes"] == got["wire"],
              f"{tag}: migration_bytes {got['migration_bytes']} != "
              f"{got['wire']}")
    else:
        check(("drain", 0) in got["decisions"],
              f"{tag}: replica 0 was never drained")
        check(sum(got["evicted"]) > 0, f"{tag}: the pools never evicted")


def launcher_mesh_fleet_phase() -> None:
    """(h5c) the launcher's fleet over a mesh on the card: ``--engine
    live --replicas 2 --mesh 1x2 --workload handoff`` at qwen2-1.5b's
    full width on its first CUT_LAYERS layers (cut from all 28) and two
    sessions, the clock at scale 16 (cut from three sessions at scale 1,
    then scale 4, for the script's time; two still hand off and migrate
    once); every turn of the trace must be served, there must be one row
    a replica, and a handoff and a migration."""
    import os
    from repro_torch.serving.workload import WorkloadConfig, generate
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--engine",
           "live", "--replicas", str(H5_REPLICAS), "--mesh", "1x2",
           "--workload", "handoff", "--sessions", "2", "--clock-scale", "16",
           "--layers", str(CUT_LAYERS), "--json"]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env=dict(os.environ,
                                            PYTHONPATH=str(ROOT / "src")))
    check(out.returncode == 0, f"(h5c) {' '.join(cmd[1:])} exited "
          f"{out.returncode}: {out.stderr[-2000:]}")
    s = json.loads(out.stdout[out.stdout.index("{"):])
    wl = WorkloadConfig(kind="handoff", num_sessions=2, seed=SEED,
                        arrival="poisson", rate_rps=2.0)
    want = sum(min(len(x.turns), 2) for x in generate(wl))
    rows = [s.get(f"replica{i}", "") for i in range(H5_REPLICAS)]
    check(s["turns"] == want and s["rounds"] > 0,
          f"(h5c) {s['turns']} turns served of the trace's {want}")
    check(all("routed=" in r and "peak_occupancy=" in r for r in rows),
          f"(h5c) replica rows: {rows}")
    check(s["handoffs"] > 0 and s["migrations"] > 0,
          f"(h5c) handoffs {s['handoffs']}, migrations {s['migrations']}: "
          "the fleet over the mesh moved no session")
    mesh_line = [ln for ln in out.stderr.splitlines()
                 if ln.startswith("[mesh]")]
    log(f"[fleet] (h5c) {' '.join(cmd[1:])}: "
        f"{time.perf_counter() - t0:.1f} s; {mesh_line[:1]}; turns "
        f"{s['turns']}/{want}, rounds {s['rounds']}, handoffs "
        f"{s['handoffs']}, migrations {s['migrations']}, P50/P90 TTFP "
        f"{s['p50_ttfp']:.4f} / {s['p90_ttfp']:.4f} s, migration_off_path "
        f"{s['migration_off_path']:.4f}; " + "; ".join(rows))


# ======================================================================
# (i) the moe and vlm families on the paged engine
# ======================================================================
# paligemma-3b's heads: 8 query heads on one KV head of 256, so a fused
# round of 16 tokens has 128 rows (two row groups of the paged kernel)
PALI_HEADS = dict(Hq=8, Hkv=1, D=256)
# paligemma-3b's first 9 of 18 layers in (i1) (cut from all 18 for the
# script's time on a slow host)
I1_LAYERS = 9
# phi3.5-moe at full width with its depth cut: 2 of its 32 layers (all
# 32 are ~84 GB of bf16 weights, more than the card holds; 8, then 4,
# before the script's time limit asked for more room)
PHI_LAYERS = 2


def paged_dim_rows(dev, tag, heads, g, timer) -> dict:
    """The paged pair at trace (b)'s round (B 8, Q 16 and 1, contexts
    0-411) at ``heads`` (Hq, Hkv, D) in f32 (held to the plain version
    at 2e-5) and bf16 (held at 2e-2 to the plain version in bf16 and in
    f32, and per row to the f32 split plain version, planted faults
    included), the fused kernel at Q = 1 bitwise the decode kernel. The
    bf16 calls are timed beside their plain versions, SDPA and their
    bounds. Returns {kernel: its bf16 row}."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import (
        paged_attention, paged_prefill_attention)
    ctx = [300, 170, 411, 96, 250, 333, 128, 0]
    shape = f"Hq={heads['Hq']} Hkv={heads['Hkv']} D={heads['D']}"
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        q, kp, vp, bt, qs, ql = kernel_case(dev, dtype, 8, 16, ctx, g,
                                            **heads)
        sl, qd = qs + 1, q[:, 0].contiguous()
        got = paged_prefill_attention(q, kp, vp, bt, qs, ql)
        got_d = paged_attention(qd, kp, vp, bt, sl)
        one = paged_prefill_attention(q[:, :1].contiguous(), kp, vp, bt, qs,
                                      torch.ones_like(ql))
        e_f = max_valid_err(got, ref.paged_prefill_attention_ref(
            q, kp, vp, bt, qs, ql), ql)
        e_d = (got_d.float() - ref.paged_attention_ref(
            qd, kp, vp, bt, sl).float()).abs().max().item()
        if dtype == torch.bfloat16:
            f32 = [x.float() for x in (q, kp, vp)]
            e_f = max(e_f, max_valid_err(got, ref.paged_prefill_attention_ref(
                *f32, bt, qs, ql), ql))
            e_d = max(e_d, (got_d.float() - ref.paged_attention_ref(
                f32[0][:, 0].contiguous(), *f32[1:], bt, sl)).abs().max()
                .item())
        torch.cuda.synchronize()
        bitwise = torch.equal(one[:, 0], got_d)
        log(f"[family] {tag} {name} {shape}: paged_prefill_attention "
            f"max_abs_err {e_f}, paged_attention {e_d} (tol {TOL[dtype]}"
            f"{', also vs f32 plain' if dtype == torch.bfloat16 else ''});"
            f" fused Q=1 == decode bitwise: {bitwise}")
        check(torch.isfinite(got).all().item() and max(e_f, e_d)
              <= TOL[dtype], f"{tag} paged kernels {name} {shape}: "
              f"{e_f} / {e_d}")
        check(bitwise, f"{tag} {name} {shape}: fused kernel at Q=1 != "
              "decode")
        if dtype != torch.bfloat16:
            continue
        split_check(f"{tag} round, {shape}", got, q, kp, vp, bt, qs, ql)
        for kname, fn, plain, args, dec, err in (
                ("paged_prefill_attention", paged_prefill_attention,
                 ref.paged_prefill_attention_ref, (q, kp, vp, bt, qs, ql),
                 False, e_f),
                ("paged_attention", paged_attention,
                 ref.paged_attention_ref, (qd, kp, vp, bt, sl), True, e_d)):
            lens = None if dec else ql
            ms = timer(lambda: fn(*args))
            plain_ms = timer(lambda: plain(*args))
            lib_ms = timer(sdpa_yardstick(args[0], kp, vp, bt, args[4],
                                          lens, dec))
            bound_ms, bound_by = attention_bound(args[0], kp, args[4], lens,
                                                 dec)
            rows[kname] = dict(
                name=kname, route="cuda", source=SOURCES[kname],
                replaces=REPLACES[kname], launches=0, max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib_ms)
            log(f"[family] {tag} {kname} bf16 B=8 Q={1 if dec else 16} "
                f"{shape} ctx={ctx}: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
                f"sdpa {lib_ms:.4f} ms, bound {bound_ms:.5f} ms by "
                f"{bound_by})")
    return rows


def sdpa_backend(q, k, v, mask) -> str:
    """The SDPA backend PyTorch's dispatcher picks for this call."""
    from torch.nn.attention import SDPBackend
    try:
        return SDPBackend(int(torch._fused_sdp_choice(
            q, k, v, attn_mask=mask, enable_gqa=True))).name
    except (AttributeError, TypeError, RuntimeError, ValueError) as e:
        return f"not determined ({type(e).__name__})"


def flash_case_row(dev, g, timer, tag, B, Hq, Hkv, Sq, Skv, D, kw,
                   v_cols=None) -> dict:
    """``flash_prefill`` on one case in both types against its plain
    version (bf16 also against the f32 plain version on the same inputs);
    V's columns from ``v_cols`` on are zeros where it is given (MLA's V
    padded to q/k's D). The bf16 call is timed beside its plain
    version, SDPA (causal, or an explicit boolean mask at a window; the
    backend the dispatcher picks is logged) and its bound. Returns the
    bf16 row."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_prefill import flash_prefill
    F = torch.nn.functional
    shape = f"B={B} Hq={Hq} Hkv={Hkv} Sq={Sq} Skv={Skv} D={D} {kw}" + (
        f" V {v_cols} columns" if v_cols else "")
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        q = torch.randn(B, Hq, Sq, D, generator=g, device=dev).to(dtype)
        k, v = (torch.randn(B, Hkv, Skv, D, generator=g, device=dev)
                .to(dtype) for _ in range(2))
        if v_cols:
            v[..., v_cols:] = 0
        got = flash_prefill(q, k, v, **kw)
        err, ok = allclose_err(got, ref.flash_prefill_ref(q, k, v, **kw),
                               TOL[dtype])
        if dtype == torch.bfloat16:
            e32, ok32 = allclose_err(got, ref.flash_prefill_ref(
                q.float(), k.float(), v.float(), **kw), TOL[dtype])
            err, ok = max(err, e32), ok and ok32
        torch.cuda.synchronize()
        log(f"[family] {tag} {name} flash_prefill ({shape}): max_abs_err "
            f"{err} (tol {TOL[dtype]})")
        check(torch.isfinite(got).all().item() and ok,
              f"{tag} flash_prefill {name}: {err}")
    causal = kw.get("causal", True)
    window = kw.get("window")
    mask = None
    if window is not None:
        qp = torch.arange(Sq, device=dev)[:, None]
        kp = torch.arange(Skv, device=dev)[None, :]
        mask = (kp <= qp) & (qp - kp < window)
    is_causal = causal and mask is None
    ms = timer(lambda: flash_prefill(q, k, v, **kw))
    plain_ms = timer(lambda: ref.flash_prefill_ref(q, k, v, **kw))
    lib_ms = timer(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=is_causal, enable_gqa=True))
    bound_ms, bound_by = flash_bound(q, k, window, kw.get("q_offset", 0),
                                     causal)
    log(f"[family] {tag} flash_prefill bf16: {ms:.4f} ms (plain "
        f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms on "
        f"{sdpa_backend(q, k, v, mask)}, bound {bound_ms:.5f} ms by "
        f"{bound_by})")
    return dict(name="flash_prefill", route="cuda",
                source=SOURCES["flash_prefill"],
                replaces=REPLACES["flash_prefill"], launches=0,
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms)


def family_kernels_phase(dev) -> None:
    """(i0) the attention kernels at head dim 256: the paged pair at
    paligemma-3b's round (``paged_dim_rows``) and ``flash_prefill`` at
    Hq 8, Hkv 1, 2048 tokens, causal (``flash_case_row``). Logged rows:
    the kernels' line keeps the qwen2-1.5b shapes."""
    g = torch.Generator(device=dev).manual_seed(SEED + 20)
    timer = Timer(dev)
    paged_dim_rows(dev, "(i0) paligemma", PALI_HEADS, g, timer)
    flash_case_row(dev, g, timer, "(i0) paligemma causal", 1, 8, 1, 2048,
                   2048, 256, {})


def family_trace(cfg, params, dev, fused: bool) -> dict:
    """Phase (b)'s trace (8 slots, prompts of 64-320 tokens, chunk-16
    grants beside decode tokens, 24 tokens a turn) on one plane, held to
    the turn contract with finite logits. ``steps`` counts the plane's
    step launches: fused rounds, or per-token steps."""
    from repro_torch.serving.paged_engine import PagedRealtimeEngine
    eng = PagedRealtimeEngine(cfg, params, slots=8, page_size=16,
                              pages_per_seq=32, device=dev,
                              fused_step=fused)
    bad, steps = [], [0]
    eng.logit_tap = lambda sid, lg: \
        bad.append(sid) if not np.isfinite(lg).all() else None
    step = eng._step

    def counted(*a):
        steps[0] += 1
        return step(*a)
    eng._step = counted
    toks, rounds, fed, secs = mixed_trace(
        eng, np.random.default_rng(SEED), 8, 24, 16)
    del eng._step                     # no cycle keeps the engine alive
    eng.check_invariants()
    plane = "fused" if fused else "per-token"
    tag = f"{cfg.name} {str(cfg.activation_dtype())[6:]} {plane}"
    check(not bad, f"{tag}: non-finite logits for {bad}")
    check(all(len(t) == 24 for t in toks.values()),
          f"{tag}: turns did not run to their cap")
    log(f"[family] {tag}: {rounds} rounds, {fed} tokens fed in "
        f"{secs:.2f} s = {secs / rounds * 1e3:.2f} ms/round")
    return dict(tokens=toks, rounds=rounds, secs=secs,
                steps=eng.fused_launches if fused else steps[0])


def free_device() -> None:
    """Return the memory of dropped models to the card: engines hold
    their weights in reference cycles, which only the collector frees."""
    gc.collect()
    torch.cuda.empty_cache()


def f32_consuming(tree):
    """``tree``'s f32 twin, each leaf dropped from ``tree`` (a dict, or
    the ``layers_pre`` list) as its copy is made, so that the two never
    coexist whole (phi3.5-moe's 8 layers are 21 GB in bf16 and 43 GB in
    f32)."""
    if isinstance(tree, list):
        return [f32_consuming(tree.pop(0)) for _ in range(len(tree))]
    out = {}
    for k in list(tree):
        v = tree.pop(k)
        out[k] = f32_consuming(v) if isinstance(v, (dict, list)) \
            else v.float()
        del v
    return out


def both_planes(cfg, params, dev) -> dict:
    return {p: family_trace(cfg, params, dev, p == "fused")
            for p in ("fused", "per-token")}


def family_counts_check(tag, counts, cfg, planes) -> None:
    """A fused round launches the fused kernel once a layer, a per-token
    step the decode kernel once a layer; trace (b) takes no dense
    graft."""
    L = cfg.num_layers
    want = {"paged_prefill_attention": L * planes["fused"]["steps"],
            "paged_attention": L * planes["per-token"]["steps"],
            "flash_prefill": 0}
    check(all(counts[k] == n for k, n in want.items()),
          f"{tag}: launches {counts}, expected {want}")


def b1_agreement(tag, cfg, params, dev, planes) -> dict:
    """How many of each plane's streams equal the B = 1 greedy stream
    through ``prefill``/``decode_step``."""
    prompts = trace_prompts(np.random.default_rng(SEED), 8,
                            cfg.vocab_size)
    b1 = {f"s{i}": greedy(cfg, params, p, 24, 512, dev)
          for i, p in enumerate(prompts)}
    same = {p: sum(r["tokens"][s] == b1[s] for s in b1)
            for p, r in planes.items()}
    both = sum(planes["fused"]["tokens"][s]
               == planes["per-token"]["tokens"][s] for s in b1)
    log(f"[family] {tag}: streams equal to B = 1: "
        + ", ".join(f"{p} {n}/{len(b1)}" for p, n in same.items())
        + f"; equal across the planes {both}/{len(b1)}")
    return same


def paligemma_phase(dev, add) -> None:
    """(i1) paligemma-3b at full width (d 2048, MQA, head dim 256, geglu,
    the embedding scale, vocab 257216) on its first ``I1_LAYERS`` of 18
    layers (cut from 18) on both planes in bf16, and its f32 twin
    on both planes and the per-token plane's dense graft, held to the
    B = 1 greedy streams."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    t0 = time.perf_counter()
    full = get_config("paligemma-3b")
    check(full.num_layers == 18, "paligemma-3b has not 18 layers")
    cfg = full.replace(num_layers=I1_LAYERS)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    check(cfg.d_model == 2048
          and cfg.resolved_head_dim == 256 and cfg.num_kv_heads == 1
          and params["embed"].shape == (257216, 2048)
          and params["embed"].dtype == torch.bfloat16,
          "not full-width paligemma-3b in bf16")
    log(f"[family] {cfg.name}: {cfg.num_layers} of 18 layers d={cfg.d_model} "
        f"heads {cfg.num_heads}/{cfg.num_kv_heads} hd "
        f"{cfg.resolved_head_dim}, {n / 1e9:.3f} B parameters in bf16, "
        f"random weights (seed {SEED}) in {time.perf_counter() - t0:.1f} s")
    planes, counts = main_path("(i1) paligemma-3b bf16", both_planes, cfg,
                               params, dev)
    add(counts, {})
    family_counts_check("(i1) bf16", counts, cfg, planes)
    b1_agreement("(i1) paligemma-3b bf16", cfg, params, dev, planes)
    c32, p32 = f32_twin(cfg, params)
    del params
    free_device()

    def f32_paths():
        return both_planes(c32, p32, dev), tokenwise_trace(c32, p32, dev)
    (planes, tw), counts = main_path("(i1) paligemma-3b f32", f32_paths)
    add(counts, {})
    # the graft's two turns 0 and the trace's per-token steps
    check(counts["flash_prefill"] == 2 * cfg.num_layers
          and counts["paged_attention"] % cfg.num_layers == 0
          and counts["paged_prefill_attention"]
          == cfg.num_layers * planes["fused"]["steps"],
          f"(i1) f32 launches {counts}")
    same = b1_agreement("(i1) paligemma-3b f32", c32, p32, dev, planes)
    check(all(n == 8 for n in same.values()),
          f"(i1) f32 streams differ from B = 1: {same}")
    rng = np.random.default_rng(SEED + 9)
    graft = {sid: greedy(c32, p32, rng.integers(0, c32.vocab_size, size=n),
                         8, 128, dev) for sid, n in (("t0", 40), ("t1", 56))}
    ok = all(tw["histories"][s][0] == graft[s] for s in graft)
    log(f"[family] (i1) f32 per-token graft: turns 0 equal to B = 1 {ok}")
    check(ok, "(i1) the per-token graft's turns 0 differ from B = 1")
    del p32
    free_device()
    log(f"[family] phase (i1): {time.perf_counter() - t0:.1f} s")


def phi_phase(dev, add) -> None:
    """(i2) phi3.5-moe at full width (d 4096, 32/8 heads, 16 experts top-2
    of d_ff 6400, untied) on its first PHI_LAYERS layers: bf16 at the
    published capacity factor 1.25 on both planes, held to the turn
    contract, its streams against B = 1 logged (padding in a fused round
    takes expert capacity: ROADMAP.md queue 3); the f32 twin at capacity
    factor E / k = 8, where no token can drop, held to B = 1 on both
    planes."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    t0 = time.perf_counter()
    full = get_config("phi3.5-moe-42b-a6.6b")
    cfg = full.replace(num_layers=PHI_LAYERS)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    m, moe = cfg.moe, params["layers"]["moe"]
    check(cfg.d_model == 4096 and cfg.num_heads == 32
          and cfg.num_kv_heads == 8 and m.num_experts == 16 and m.top_k == 2
          and m.capacity_factor == 1.25
          and moe["w_up"].shape == (PHI_LAYERS, 16, 4096, 6400)
          and moe["w_up"].dtype == torch.bfloat16
          and moe["router"].dtype == torch.float32 and "unembed" in params,
          "not full-width phi3.5-moe")
    log(f"[family] {cfg.name}: {PHI_LAYERS} of {full.num_layers} layers "
        f"d={cfg.d_model}, {m.num_experts} experts top-{m.top_k} of d_ff "
        f"{m.d_ff_expert}, {n / 1e9:.3f} B parameters in bf16 "
        f"({full.num_params() / 1e9:.2f} B in all 32), random weights "
        f"(seed {SEED}) in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    planes, counts = main_path("(i2) phi3.5-moe bf16 cf 1.25", both_planes,
                               cfg, params, dev)
    add(counts, {})
    family_counts_check("(i2) bf16", counts, cfg, planes)
    b1_agreement("(i2) phi3.5-moe bf16 cf 1.25", cfg, params, dev, planes)
    padded_slot_fills(cfg, params, dev, planes["fused"]["tokens"])
    del moe
    free_device()
    c32 = cfg.replace(dtype="float32", param_dtype="float32",
                      moe=dataclasses.replace(
                          m, capacity_factor=m.num_experts / m.top_k))
    p32 = f32_consuming(params)
    free_device()
    planes, counts = main_path("(i2) phi3.5-moe f32 cf 8", both_planes, c32,
                               p32, dev)
    add(counts, {})
    family_counts_check("(i2) f32", counts, c32, planes)
    same = b1_agreement("(i2) phi3.5-moe f32 cf 8", c32, p32, dev, planes)
    check(all(n == 8 for n in same.values()),
          f"(i2) f32 streams differ from B = 1 at cf 8: {same}")
    del p32
    free_device()
    moe_combine_timing(dev)
    log(f"[family] phase (i2): {time.perf_counter() - t0:.1f} s")


def moe_combine_timing(dev) -> None:
    """(i2) The moe layer's dispatch and combine alone, bf16, at
    phi3.5-moe's fused round (128 tokens, 16 experts top-2, d 4096) and
    deepseek-v2's decode round (4 tokens, 160 experts top-6, d 5120):
    the host's time a call (200 calls enqueued, then synchronized; the
    rounds are host-bound) and the device's, of ``build_dispatch`` +
    ``combine`` (ordered) against ``build_dispatch`` + ``index_add_``
    (the unordered combine it replaced), on the same tables."""
    from repro_torch.kernels.autotune import DeviceTimer
    from repro_torch.models.moe import _capacity, build_dispatch, combine
    timer = DeviceTimer(dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    for name, T, E, k, d in (("phi3.5-moe fused round", 128, 16, 2, 4096),
                             ("deepseek-v2 decode round", 4, 160, 6, 5120)):
        C = _capacity(T, k, E, 1.25)
        sel = torch.rand((T, E), generator=g, device=dev).argsort(-1)[:, :k]
        w = torch.rand((T, k), generator=g, device=dev)
        ye = torch.randn((E, C, d), generator=g, device=dev).bfloat16()

        def ordered():
            _, w_tab, slots = build_dispatch(sel, w, E, C, slots=True)
            return combine(slots, ye * w_tab[..., None].bfloat16())

        def unordered():
            tok, w_tab = build_dispatch(sel, w, E, C)
            y = ye.new_zeros((T + 1, d))
            y.index_add_(0, tok.reshape(-1),
                         (ye * w_tab[..., None].bfloat16()).reshape(-1, d))
            return y[:T]
        us = {}
        for tag, run in (("ordered", ordered), ("index_add_", unordered)):
            run()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(200):
                run()
            torch.cuda.synchronize()
            us[tag] = ((time.perf_counter() - t1) / 200 * 1e6,
                       timer(run, 20))
        log(f"[family] (i2) moe dispatch + combine, {name} (T {T}, E {E}, "
            f"top-{k}, C {C}, d {d}, bf16): ordered host {us['ordered'][0]:.1f}"
            f" us a call, device {us['ordered'][1]:.1f} us; index_add_ host "
            f"{us['index_add_'][0]:.1f} us, device {us['index_add_'][1]:.1f}"
            f" us")


def padded_slot_fills(cfg, params, dev, fused_tokens) -> None:
    """(i2) The moe layers route only a fused round's real tokens, so
    its streams cannot depend on what the padded query slots hold: the
    trace again with the fused kernel's output there overwritten by
    zeros, then by seeded N(0, 1) values, gives the same streams bit for
    bit."""
    import repro_torch.serving.paged_engine as pe
    kernel = pe.paged_prefill_attention
    g = torch.Generator(device=dev).manual_seed(SEED + 50)
    for fill in ("zeros", "random values"):
        def attend(q, *args, **kw):
            out = kernel(q, *args, **kw)
            pad = torch.arange(q.shape[1], device=dev) >= args[-1][:, None]
            val = torch.zeros_like(out) if fill == "zeros" else \
                torch.randn(out.shape, generator=g, device=dev).to(out.dtype)
            return torch.where(pad[..., None, None], val, out)
        pe.paged_prefill_attention = attend
        try:
            got = family_trace(cfg, params, dev, True)["tokens"]
        finally:
            pe.paged_prefill_attention = kernel
        log(f"[family] (i2) padded query slots overwritten by {fill}: "
            f"fused streams bit for bit unchanged {got == fused_tokens}")
        check(got == fused_tokens, f"(i2) the fused streams depend on the "
              f"padded query slots ({fill})")


def launcher_family_phase() -> None:
    """(i3) the launcher's scripted demo, bf16, at paligemma-3b whole and
    at qwen3-4b whole (36 layers, ``qk_norm``, head dim 128 > d / heads):
    the demo's counts (5 evictions, one sync reload, one preload admitted
    and hit; the turns' lengths doubled)."""
    import os
    for config in ("paligemma-3b", "qwen3-4b"):
        t0 = time.perf_counter()
        cmd = [sys.executable, "-m", "repro_torch.launch.serve",
               "--engine", "real", "--config", config, "--json"]
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300, cwd=ROOT,
                             env=dict(os.environ,
                                      PYTHONPATH=str(ROOT / "src")))
        check(out.returncode == 0, f"(i3) {' '.join(cmd[1:])} exited "
              f"{out.returncode}: {out.stderr[-2000:]}")
        res = json.loads(out.stdout)
        pre = res["preload"]
        gen = {s: [t["generated"] for t in ts]
               for s, ts in res["turns"].items()}
        log(f"[family] (i3) {' '.join(cmd[1:])}: "
            f"{time.perf_counter() - t0:.1f} s; evictions "
            f"{res['offload_events']}, preload {pre}, generated {gen}")
        check(res["offload_events"] == 5 and pre["sync_fallbacks"] == 1
              and pre["admitted"] == 1 and pre["hits"] == 1
              and gen == {"alice": [20, 4, 12], "bob": [52, 12]},
              f"(i3) {config} demo counts: {res['offload_events']}, "
              f"{pre}, {gen}")


# ======================================================================
# (j) the hybrid and encdec families on the ring-cache model
# ======================================================================
FAMILY_FLASH_CASES = [  # tag, B, Hq, Hkv, Sq, Skv, D, options
    # recurrentgemma-9b's local layers: MQA at G 16, D 256, a 2048 window
    *((f"recurrentgemma local S={S}", 1, 16, 1, S, S, 256,
       dict(window=2048)) for S in (2047, 2048, 2049, 3000)),
    # whisper-tiny's encoder over 1500 frames and its cross-attention
    ("whisper encoder", 1, 6, 6, 1500, 1500, 64, dict(causal=False)),
    ("whisper cross-attention", 1, 6, 6, 448, 1500, 64,
     dict(causal=False)),
]


def family_flash_phase(dev) -> None:
    """(j0) ``flash_prefill`` at the hybrid's and the encdec family's
    shapes (``flash_case_row``). Logged rows: the kernels' line keeps
    the qwen2-1.5b shapes."""
    g = torch.Generator(device=dev).manual_seed(SEED + 30)
    timer = Timer(dev)
    for tag, *case in FAMILY_FLASH_CASES:
        flash_case_row(dev, g, timer, f"(j0) {tag}", *case)


def hybrid_phase(dev, add) -> None:
    """(j1) recurrentgemma-9b whole (38 layers: 26 rglru, 12 local
    attention with a 2048 window, d 4096, MQA, head dim 256, bf16) on
    the single-turn engine: 4 slots, capacity 4096 (a ring of W =
    2048), prompts of 3000, 2049, 1397 and 517 tokens, 32 new tokens
    each, held to the B = 1 greedy streams; the longest prefill's logits
    against the plain versions' in bf16 and f32; one 3000-token prefill
    profiled for the shares of ``flash_prefill`` and of the scan, and
    one decode round of the four slots; the scan timed alone."""
    from repro_torch.configs import get_config
    from repro_torch.models import rglru
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import RealtimeLLMEngine
    free_device()
    t0 = time.perf_counter()
    cfg = get_config("recurrentgemma-9b")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    kinds = cfg.block_kinds()
    n_att = kinds.count("local_attn")
    rec = params["layers"][0]["rec"]
    check(cfg.num_layers == 38 and cfg.d_model == 4096
          and cfg.resolved_head_dim == 256 and cfg.num_kv_heads == 1
          and cfg.rglru.local_window == 2048 and n_att == 12
          and len(params["layers"]) == 38
          and params["embed"].shape == (256000, 4096)
          and params["embed"].dtype == torch.bfloat16
          and rec["w_a"].shape == (16, 256, 256)
          and rec["w_a"].dtype == torch.float32,
          "not full-width recurrentgemma-9b in bf16")
    log(f"[hybrid] {cfg.name}: {cfg.num_layers} layers ({n_att} local "
        f"attention, window {cfg.rglru.local_window}) d={cfg.d_model} "
        f"heads {cfg.num_heads}/{cfg.num_kv_heads} hd "
        f"{cfg.resolved_head_dim}, {n / 1e9:.3f} B parameters in bf16 "
        f"(the registry counts {cfg.num_params() / 1e9:.2f} B), random "
        f"weights (seed {SEED}) in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    rng = np.random.default_rng(SEED + 31)
    prompts = prompts_for(cfg, rng, [3000, 2049, 1397, 517])
    out, counts = main_path("(j1) recurrentgemma-9b single-turn",
                            single_turn_serve, cfg, params, dev, prompts,
                            32, 4096)
    add(counts, {"flash_prefill": len(prompts) * n_att})
    single_turn_check(cfg, params, dev, prompts, out, 32, 4096)
    free_device()
    profile_prefill(cfg, params, dev, prompts["s0"], 4096,
                    {"flash_prefill": "flash_prefill"},
                    [(rglru, "rglru_scan")])
    # a decode round of the four slots: rounds 3 and 4 of the engine
    eng = RealtimeLLMEngine(cfg, params, slots=len(prompts),
                            capacity=4096, device=dev)
    for sid, p in prompts.items():
        eng.add_session(sid, p, max_new_tokens=8)
    eng.step()
    eng.step()
    profile_call(f"{cfg.name} decode round ({len(prompts)} slots)",
                 eng.step, {"flash_prefill": "flash_prefill"},
                 [(rglru, "rglru_step")])
    del eng
    # the scan alone at the 3000-token prefill's shape, for its share
    w = cfg.rglru.lru_width
    x = torch.randn(1, 3000, w, device=dev).to(torch.bfloat16)
    scan_ms = Timer(dev)(lambda: rglru.rglru_scan(rec, x))
    log(f"[hybrid] rglru_scan alone, [1, 3000, {w}]: {scan_ms:.4f} ms a "
        f"call, x {kinds.count('rglru')} layers = "
        f"{scan_ms * kinds.count('rglru'):.2f} ms a prefill")
    del params, rec, x
    free_device()
    log(f"[hybrid] phase (j1): {time.perf_counter() - t0:.1f} s")


def whisper_streams(cfg, params, dev, tokens, seq_lens, frames, n):
    """``prefill(enc_frames=)`` then ``n - 1`` greedy ``decode_step``s.
    Returns (the prefill's logits, the streams [B, n] as lists)."""
    from repro_torch.models.model import decode_step, init_cache, prefill
    cache = init_cache(cfg, tokens.shape[0], 512, dev,
                       enc_frames=frames.shape[1])
    first, cache = prefill(cfg, params, tokens, cache, seq_lens=seq_lens,
                           enc_frames=frames)
    out = [first.argmax(-1)]
    for _ in range(n - 1):
        lg, cache = decode_step(cfg, params, out[-1], cache)
        check(torch.isfinite(lg).all().item(), "(j2) decode logits")
        out.append(lg.argmax(-1))
    return first, torch.stack(out, 1).tolist()


def whisper_phase(dev, add) -> None:
    """(j2) whisper-tiny whole (4 encoder and 4 decoder layers, d 384,
    6 heads of 64, vocab 51865) through ``prefill(enc_frames=)`` and
    ``decode_step``: 1500 seeded frame embeddings (the stub frontend's
    form), B 4 with prompts of 448, 301, 97 and 16 tokens, 32 greedy
    steps, in bf16 and in its f32 twin. The prefill's logits against
    the plain versions'; the f32 streams held to each row's B = 1
    stream (the bf16 ones logged: the batched prefill's products round
    at other shapes)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params, prefill, init_cache
    t0 = time.perf_counter()
    cfg = get_config("whisper-tiny")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
    n = sum(t.numel() for t in _leaves(params))
    check(cfg.num_layers == 4 and cfg.encoder.num_layers == 4
          and cfg.d_model == 384 and cfg.resolved_head_dim == 64
          and cfg.encoder.num_frames == 1500
          and params["layers"]["xattn"]["wk"].shape == (4, 384, 6, 64)
          and params["embed"].shape == (51865, 384),
          "not full-width whisper-tiny")
    log(f"[encdec] {cfg.name}: {cfg.num_layers}+{cfg.encoder.num_layers} "
        f"layers d={cfg.d_model} heads {cfg.num_heads} hd "
        f"{cfg.resolved_head_dim}, {n / 1e6:.1f} M parameters, random "
        f"weights (seed {SEED})")
    g = torch.Generator(device=dev).manual_seed(SEED + 40)
    F = cfg.encoder.num_frames
    frames = torch.randn(4, F, cfg.d_model, generator=g, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (4, 448), generator=g,
                           device=dev)
    lens = [448, 301, 97, 16]
    seq_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    c32, p32 = f32_twin(cfg, params)
    for c, p in ((cfg, params), (c32, p32)):
        name = str(c.activation_dtype())[6:]
        (first, streams), counts = main_path(
            f"(j2) whisper-tiny {name}", whisper_streams, c, p, dev,
            tokens, seq_lens, frames, 32)
        # a prefill: the encoder's, the decoder's self- and
        # cross-attention layers, once each
        add(counts, {"flash_prefill": 2 * cfg.num_layers
                     + cfg.encoder.num_layers})
        want = prefill(c, p, tokens, init_cache(c, 4, 512, dev,
                                                enc_frames=F),
                       seq_lens=seq_lens, enc_frames=frames, plain=True)[0]
        logits_vs_plain(f"[encdec] (j2) {name} prefill", first, want,
                        c.activation_dtype())
        same = [streams[b] == whisper_streams(
            c, p, dev, tokens[b:b + 1, :lens[b]], None, frames[b:b + 1],
            32)[1][0] for b in range(4)]
        log(f"[encdec] (j2) {name}: rows of {lens} tokens over {F} "
            f"frames, 32 steps; streams equal to B = 1 {sum(same)}/4; "
            f"first tokens {[r[:6] for r in streams]}")
        if c is c32:
            check(all(same), f"(j2) f32 streams differ from B = 1: {same}")
    del params, p32
    free_device()
    log(f"[encdec] phase (j2): {time.perf_counter() - t0:.1f} s")


# ======================================================================
# (k) head dims 80 and 192, and multi-head latent attention
# ======================================================================
# the published heads the kernels take at head dims 192 and 80
NEMOTRON_HEADS = dict(Hq=96, Hkv=8, D=192)
DANUBE_HEADS = dict(Hq=32, Hkv=8, D=80)
# tag, the kernels' row it gives (the main paths' shapes), B, Hq, Hkv,
# Sq, Skv, D, options, V's columns
K0_FLASH_CASES = [
    ("(k0) nemotron-4 causal", None, 1, 96, 8, 2048, 2048, 192, {}, None),
    # MLA's prefill: q/k at nope 128 + rope 64, every head its own KV
    # head, V's 128 columns padded with zeros to 192
    ("(k0) deepseek-v2 MLA", "flash_prefill, D 192", 1, 128, 128, 2048,
     2048, 192, {}, 128),
    *((f"(k0) h2o-danube window S={S}",
       "flash_prefill, D 80" if S == 5000 else None, 1, 32, 8, S, S, 80,
       dict(window=4096), None) for S in (4095, 4096, 4097, 5000)),
]
# the depth cuts of the two models that do not fit the card whole (all
# 60 layers of deepseek-v2 are ~472 GB of bf16 weights, all 96 of
# nemotron-4 ~680 GB); their f32 twins, held to B = 1, keep fewer
DEEPSEEK_LAYERS, DEEPSEEK_F32_LAYERS = 4, 2   # 6 and 4 before (time)
NEMOTRON_LAYERS, NEMOTRON_F32_LAYERS = 2, 1
# h2o-danube-1.8b's first 12 of 24 layers in (k3) (cut from all 24 for
# the script's time on a slow host)
K3_LAYERS = 12


def dim_row(row, D) -> dict:
    """A kernel row under the name of its head dim's instantiation."""
    return dict(row, name=f"{row['name']}, D {D}")


def head_dim_kernels_phase(dev) -> dict:
    """(k0) the paged pair at nemotron-4's heads (D 192, G 12) and at
    h2o-danube's (D 80, G 4) on trace (b)'s round; ``flash_prefill``
    causal at nemotron-4's heads, at MLA's (G 1, padded V) and windowed
    at h2o-danube's around and past the 4096 window. Returns the rows of
    the dims the main paths launch: the D 192 paged pair, MLA's D 192
    prefill and the D 80 window at S 5000."""
    g = torch.Generator(device=dev).manual_seed(SEED + 60)
    timer = Timer(dev)
    rows = {}
    for kname, r in paged_dim_rows(dev, "(k0) nemotron-4", NEMOTRON_HEADS,
                                   g, timer).items():
        rows[f"{kname}, D 192"] = dim_row(r, 192)
    paged_dim_rows(dev, "(k0) h2o-danube", DANUBE_HEADS, g, timer)
    for tag, row, *case, v_cols in K0_FLASH_CASES:
        r = flash_case_row(dev, g, timer, tag, *case, v_cols=v_cols)
        if row:
            rows[row] = dim_row(r, case[5])
    return rows


def deepseek_phase(dev, add) -> dict:
    """(k1) deepseek-v2-236b at full width on its first DEEPSEEK_LAYERS
    of 60 layers (layer 0 dense, d_ff 12288; then moe layers of 160
    routed experts top-6 and 2 shared; MLA in every layer), bf16, on the
    single-turn engine: 4 slots at capacity 4096, prompts of 2048, 1171,
    397 and 64 tokens, 32 tokens each; the streams against B = 1
    (logged) and the longest prefill's logits against the plain
    versions'. Then its f32 twin on the first DEEPSEEK_F32_LAYERS (the
    dense layer and one moe layer) on the same trace, held to B = 1 and
    to the plain versions in both types. Returns the launch counts of
    both runs."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    free_device()
    t0 = time.perf_counter()
    full = get_config("deepseek-v2-236b")
    cfg = full.replace(num_layers=DEEPSEEK_LAYERS)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    m, e = cfg.mla, cfg.moe
    attn, moe = params["layers"]["attn"], params["layers"]["moe"]
    check(cfg.d_model == 5120 and cfg.num_heads == 128
          and m.kv_lora_rank == 512 and m.q_lora_rank == 1536
          and m.nope_head_dim + m.rope_head_dim == 192
          and m.v_head_dim == 128 and e.num_experts == 160 and e.top_k == 6
          and e.num_shared_experts == 2
          and len(params["layers_pre"]) == 1
          and params["layers_pre"][0]["mlp"]["w_up"].shape == (5120, 12288)
          and attn["w_uk"].shape == (DEEPSEEK_LAYERS - 1, 512, 128, 128)
          and moe["w_up"].shape == (DEEPSEEK_LAYERS - 1, 160, 5120, 1536)
          and moe["w_up"].dtype == torch.bfloat16
          and moe["router"].dtype == torch.float32
          and params["unembed"].shape == (5120, 102400),
          "not full-width deepseek-v2-236b")
    del attn, moe
    log(f"[mla] {cfg.name}: {DEEPSEEK_LAYERS} of {full.num_layers} layers "
        f"d={cfg.d_model}, {cfg.num_heads} heads, MLA kv_lora "
        f"{m.kv_lora_rank} q_lora {m.q_lora_rank} nope {m.nope_head_dim} "
        f"rope {m.rope_head_dim} v {m.v_head_dim}; {e.num_experts} experts "
        f"top-{e.top_k} + {e.num_shared_experts} shared of d_ff "
        f"{e.d_ff_expert}; {n / 1e9:.3f} B parameters in bf16 "
        f"({full.num_params() / 1e9:.1f} B in all {full.num_layers}), "
        f"random weights (seed {SEED}) in {time.perf_counter() - t0:.1f} s;"
        f" {torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    rng = np.random.default_rng(SEED + 61)
    prompts = prompts_for(cfg, rng, [2048, 1171, 397, 64])
    out, counts = main_path("(k1) deepseek-v2 bf16 single-turn",
                            single_turn_serve, cfg, params, dev, prompts,
                            32, 4096)
    add(counts, {"flash_prefill": len(prompts) * DEEPSEEK_LAYERS})
    total = dict(counts)
    # an f32 copy of these layers would not fit beside them
    single_turn_check(cfg, params, dev, prompts, out, 32, 4096, hold=False,
                      types=(torch.bfloat16,))
    c32, cut = first_layers(cfg, params, DEEPSEEK_F32_LAYERS)
    c32 = c32.replace(dtype="float32", param_dtype="float32")
    del params
    free_device()
    p32 = f32_consuming(cut)
    free_device()
    out, counts = main_path("(k1) deepseek-v2 f32 single-turn",
                            single_turn_serve, c32, p32, dev, prompts, 32,
                            4096)
    add(counts, {"flash_prefill": len(prompts) * DEEPSEEK_F32_LAYERS})
    single_turn_check(c32, p32, dev, prompts, out, 32, 4096)
    del p32
    free_device()
    log(f"[mla] phase (k1): {time.perf_counter() - t0:.1f} s")
    return {k: total[k] + counts[k] for k in counts}


def nemotron_phase(dev, add) -> dict:
    """(k2) nemotron-4-340b at full width (d 18432, 96 query heads on 8
    KV heads of 192, squared_relu of d_ff 73728, vocab 256000, untied)
    on its first NEMOTRON_LAYERS of 96 layers, bf16, on both planes of
    trace (b) (its streams against B = 1 and across the planes logged),
    then its f32 twin on the first NEMOTRON_F32_LAYERS on both planes,
    held to B = 1 (so the planes agree). Returns the launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    free_device()
    t0 = time.perf_counter()
    full = get_config("nemotron-4-340b")
    cfg = full.replace(num_layers=NEMOTRON_LAYERS)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    lay = params["layers"]
    check(cfg.d_model == 18432 and cfg.resolved_head_dim == 192
          and cfg.num_heads == 96 and cfg.num_kv_heads == 8
          and cfg.mlp_kind == "squared_relu"
          and lay["mlp"]["w_up"].shape == (NEMOTRON_LAYERS, 18432, 73728)
          and lay["attn"]["wq"].shape == (NEMOTRON_LAYERS, 18432, 96, 192)
          and params["unembed"].shape == (18432, 256000)
          and params["embed"].dtype == torch.bfloat16,
          "not full-width nemotron-4-340b")
    del lay
    log(f"[family] {cfg.name}: {NEMOTRON_LAYERS} of {full.num_layers} "
        f"layers d={cfg.d_model} heads {cfg.num_heads}/{cfg.num_kv_heads} "
        f"hd {cfg.resolved_head_dim}, {n / 1e9:.3f} B parameters in bf16 "
        f"({full.num_params() / 1e9:.1f} B in all {full.num_layers}), "
        f"random weights (seed {SEED}) in {time.perf_counter() - t0:.1f} s;"
        f" {torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    planes, counts = main_path("(k2) nemotron-4 bf16", both_planes, cfg,
                               params, dev)
    add(counts, {})
    family_counts_check("(k2) bf16", counts, cfg, planes)
    total = dict(counts)
    b1_agreement("(k2) nemotron-4 bf16", cfg, params, dev, planes)
    c32, cut = first_layers(cfg, params, NEMOTRON_F32_LAYERS)
    c32 = c32.replace(dtype="float32", param_dtype="float32")
    del params
    free_device()
    p32 = f32_consuming(cut)
    free_device()
    planes, counts = main_path("(k2) nemotron-4 f32", both_planes, c32, p32,
                               dev)
    add(counts, {})
    family_counts_check("(k2) f32", counts, c32, planes)
    same = b1_agreement("(k2) nemotron-4 f32", c32, p32, dev, planes)
    check(all(n == 8 for n in same.values()),
          f"(k2) f32 streams differ from B = 1: {same}")
    del p32
    free_device()
    log(f"[family] phase (k2): {time.perf_counter() - t0:.1f} s")
    return {k: total[k] + counts[k] for k in counts}


def danube_phase(dev, add) -> dict:
    """(k3) h2o-danube-1.8b at full width (d 2560, 32 query heads on 8 KV
    heads of 80, a 4096-token window, untied) on its first
    ``K3_LAYERS`` of 24 layers (cut from 24) on the single-turn
    engine: 4 slots at capacity 8192 (a ring of 4096), prompts of 5000,
    4097, 4096 and 1171 tokens, 32 tokens each, in bf16 (streams against
    B = 1 logged) and in its f32 twin (held to B = 1); the longest
    prefill's logits against the plain versions' in both types. Returns
    the launch counts of both runs."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import cache_window, init_params
    free_device()
    t0 = time.perf_counter()
    full = get_config("h2o-danube-1.8b")
    cfg = full.replace(num_layers=K3_LAYERS)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    check(full.num_layers == 24 and cfg.d_model == 2560
          and cfg.resolved_head_dim == 80 and cfg.num_kv_heads == 8
          and cfg.sliding_window == 4096
          and cache_window(cfg, 8192) == 4096
          and params["layers"]["attn"]["wq"].shape == (K3_LAYERS, 2560, 32,
                                                       80)
          and params["embed"].dtype == torch.bfloat16,
          "not full-width h2o-danube-1.8b")
    log(f"[family] {cfg.name}: {cfg.num_layers} of 24 layers d={cfg.d_model} "
        f"heads {cfg.num_heads}/{cfg.num_kv_heads} hd "
        f"{cfg.resolved_head_dim}, window {cfg.sliding_window}, "
        f"{n / 1e9:.3f} B parameters in bf16, random weights (seed {SEED})")
    rng = np.random.default_rng(SEED + 62)
    prompts = prompts_for(cfg, rng, [5000, 4097, 4096, 1171])
    total = {}
    c32, p32 = f32_twin(cfg, params)
    for c, p in ((cfg, params), (c32, p32)):
        name = str(c.activation_dtype())[6:]
        out, counts = main_path(f"(k3) h2o-danube {name} single-turn",
                                single_turn_serve, c, p, dev, prompts, 32,
                                8192)
        add(counts, {"flash_prefill": len(prompts) * cfg.num_layers})
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        single_turn_check(c, p, dev, prompts, out, 32, 8192,
                          hold=c is c32)
    del params, p32
    free_device()
    log(f"[family] phase (k3): {time.perf_counter() - t0:.1f} s")
    return total


K4_LAYERS = 9      # (k4): qwen3-4b's first 9 of 36 layers (its time)


def qwen3_phase(dev, add) -> None:
    """(k4) qwen3-4b at full width on 9 of its 36 layers (``qk_norm``,
    head dim 128 > d / heads) in f32 on both planes of trace (b), held
    to B = 1."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    free_device()
    t0 = time.perf_counter()
    cfg = get_config("qwen3-4b").replace(dtype="float32",
                                         param_dtype="float32",
                                         num_layers=K4_LAYERS)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
    check(cfg.num_layers == K4_LAYERS and cfg.qk_norm
          and cfg.resolved_head_dim == 128
          and params["embed"].dtype == torch.float32, "not qwen3-4b in f32")
    planes, counts = main_path("(k4) qwen3-4b f32", both_planes, cfg, params,
                               dev)
    add(counts, {})
    family_counts_check("(k4) f32", counts, cfg, planes)
    same = b1_agreement("(k4) qwen3-4b f32", cfg, params, dev, planes)
    check(all(n == 8 for n in same.values()),
          f"(k4) f32 streams differ from B = 1: {same}")
    del params
    free_device()
    log(f"[family] phase (k4): {time.perf_counter() - t0:.1f} s")


# ======================================================================
# (l) single-device training
# ======================================================================
TRAIN_B, TRAIN_S = 8, 256          # (l0), (l3), (l4): 2048 tokens a step
# (l5): the other families at full width, their depth cut only where
# memory forces it; (layers or None for whole, B, text S, remat)
L5_RUNS = (("h2o-danube-1.8b", None, 1, 4160, True),
           ("mamba2-1.3b", None, 2, 512, False),
           ("paligemma-3b", None, 2, 128, False),
           ("deepseek-v2-236b", 2, 2, 256, False),
           ("recurrentgemma-9b", 3, 2, 512, False),
           ("whisper-tiny", None, 2, 64, False))


def smoke_dir() -> Path:
    """A fresh directory for checkpoints under the checkout (git
    ignores ``.smoke_ckpt_*``), removed by the caller."""
    import tempfile
    return Path(tempfile.mkdtemp(prefix=".smoke_ckpt_", dir=ROOT))


def train_setup(cfg, dev, full=None):
    """(params, opt, opt_state): ``cfg``'s weights from a generator on
    ``dev`` seeded with SEED, and the optimizer ``select_optimizer``
    picks for ``full`` (the whole config a cut one comes from)."""
    from repro_torch.models.model import init_params
    from repro_torch.training import optimizer as O
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
    opt = O.select_optimizer(full or cfg)
    return params, opt, O.opt_init(opt, params)


def timed_steps(step, params, state, batches, n):
    """``n`` synchronized steps; returns (params, state, losses, grad
    norms, ms a step)."""
    losses, norms, ms = [], [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, state, m = step(params, state, next(batches))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        ms.append((time.perf_counter() - t) * 1e3)
    return params, state, losses, norms, ms


def train_whole_phase(dev) -> dict:
    """(l0) qwen2-1.5b whole (28 layers, bf16, AdamW) on
    ``synthetic_batches(seed=0)``, 15 steps of B 8 x S 256: every loss
    and grad norm finite, the last five steps' mean loss below the first
    five's; ms a step (median of steps 5-14), tokens/s, peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.training.data import synthetic_batches
    from repro_torch.training.train_loop import TrainConfig, build_train_step
    t0 = time.perf_counter()
    cfg = get_config("qwen2-1.5b")
    params, opt, state = train_setup(cfg, dev)
    n_params = sum(t.numel() for t in _leaves(params))
    check(cfg.num_layers == 28 and opt.kind == "adamw"
          and params["embed"].dtype == torch.bfloat16,
          "(l0) not full-width qwen2-1.5b in bf16 with AdamW")
    step = build_train_step(cfg, opt, TrainConfig(remat=False))
    torch.cuda.reset_peak_memory_stats()
    params, state, losses, norms, ms = timed_steps(
        step, params, state,
        synthetic_batches(cfg.vocab_size, TRAIN_B, TRAIN_S, seed=0), 15)
    peak = torch.cuda.max_memory_allocated()
    check(all(map(math.isfinite, losses + norms)),
          f"(l0) non-finite: losses {losses}, grad norms {norms}")
    first, last = np.mean(losses[:5]), np.mean(losses[10:])
    check(last < first, f"(l0) loss did not fall: {first} -> {last}")
    med = float(np.median(ms[5:]))
    log(f"[train] (l0) {cfg.name}, {cfg.num_layers} layers, "
        f"{n_params / 1e9:.3f} B parameters in bf16, {opt.kind}, B "
        f"{TRAIN_B} x S {TRAIN_S}: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
        f"(mean of steps 0-4 {first:.4f}, 10-14 {last:.4f}); grad norm "
        f"{norms[0]:.2f} -> {norms[-1]:.2f}; {med:.2f} ms a step (median "
        f"of 5-14; step 0 {ms[0]:.1f} ms), "
        f"{TRAIN_B * TRAIN_S / med * 1e3:.0f} tokens/s, peak "
        f"{peak / 2 ** 30:.2f} GiB; {time.perf_counter() - t0:.1f} s")
    # where a step's time goes: the products (cuBLAS names its Hopper
    # GEMMs nvjet_*), and the optimizer's kernels
    from repro_torch.training import optimizer as O
    batch = next(synthetic_batches(cfg.vocab_size, TRAIN_B, TRAIN_S,
                                   seed=1))
    profile_call("(l0) one train step", lambda: step(params, state, batch),
                 {"GEMMs (nvjet)": "nvjet", "GEMMs (gemm)": "gemm"},
                 ranges=[(O, "opt_update")])
    del params, state, step
    free_device()
    return dict(ms=med, tokens_s=TRAIN_B * TRAIN_S / med * 1e3,
                peak_gib=peak / 2 ** 30)


def grads_err(got, want) -> tuple:
    """(worst leaf's max |error| over its max |value|, its index)."""
    worst = (-1.0, None)
    for i, (g, w) in enumerate(zip(_leaves(got), _leaves(want))):
        err = (g.cpu().float() - w.cpu().float()).abs().max().item() / max(
            w.float().abs().max().item(), 1e-30)
        worst = max(worst, (err, i), key=lambda e: e[0])
    return worst


def cut_twin(dev):
    """(l1)'s model: qwen2-1.5b's first 2 of 28 layers at full width in
    f32, and a copy of its weights on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.training.optimizer import tree_map
    cfg = get_config("qwen2-1.5b").replace(num_layers=2,
                                           param_dtype="float32",
                                           dtype="float32")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
    return cfg, params, tree_map(lambda t: t.cpu(), params)


def train_twin_phase(dev) -> dict:
    """(l1) the card's step against the CPU's on the same weights and
    batch: qwen2-1.5b's first 2 layers at full width, f32, B 2 x S 64;
    loss within 1e-5 relative, every gradient leaf within 1e-4 of its
    largest |value|; then one AdamW update from the CPU's gradients on
    both devices, parameters within 1e-6 of each leaf's largest |value|
    (each device's own gradients would not do: Adam's first step is
    about sign(g), and a near-zero gradient whose sign the sums round
    apart moves its weight by 2 lr). (l2) on the same cut, a batch of 4
    at microbatches 2 with remat against one batch without: loss within
    1e-5 relative, gradients as in (l1)."""
    from repro_torch.training import optimizer as O
    from repro_torch.training.data import synthetic_batches
    from repro_torch.training.train_loop import (TrainConfig, batch_to,
                                                 loss_and_grads, step_grads)
    t0 = time.perf_counter()
    cfg, params, cpu_params = cut_twin(dev)
    batch = next(synthetic_batches(cfg.vocab_size, 2, 64, seed=1))
    loss, _, grads = loss_and_grads(cfg, params, batch_to(batch, dev))
    cpu_loss, _, cpu_grads = loss_and_grads(cfg, cpu_params,
                                            batch_to(batch, "cpu"))
    rel = abs(loss.item() - cpu_loss.item()) / abs(cpu_loss.item())
    g_err, g_leaf = grads_err(grads, cpu_grads)
    log(f"[train] (l1) {cfg.name} 2 of 28 layers, f32, B 2 x S 64: loss "
        f"card {loss.item():.6f} cpu {cpu_loss.item():.6f} (rel "
        f"{rel:.2e}); worst gradient leaf #{g_leaf} {g_err:.2e} of its max")
    check(rel <= 1e-5, f"(l1) loss rel {rel}")
    check(g_err <= 1e-4, f"(l1) gradient leaf #{g_leaf}: {g_err}")
    del grads
    opt = O.OptConfig()
    state, cpu_state = O.opt_init(opt, params), O.opt_init(opt, cpu_params)
    O.opt_update(opt, O.tree_map(lambda g: g.to(dev), cpu_grads), state,
                 params)
    O.opt_update(opt, cpu_grads, cpu_state, cpu_params)
    p_err, p_leaf = grads_err(params, cpu_params)
    log(f"[train] (l1) one AdamW update from the CPU's gradients: worst "
        f"parameter leaf #{p_leaf} {p_err:.2e} of its max")
    check(p_err <= 1e-6, f"(l1) parameter leaf #{p_leaf}: {p_err}")
    del state, cpu_state, cpu_grads
    # (l2) microbatches and remat against one plain batch, on the card
    batch4 = batch_to(next(synthetic_batches(cfg.vocab_size, 4, 64,
                                             seed=2)), dev)
    l_mb, g_mb = step_grads(cfg, params, batch4,
                            TrainConfig(microbatches=2, remat=True))
    l_one, g_one = step_grads(cfg, params, batch4,
                              TrainConfig(microbatches=1, remat=False))
    rel2 = abs(l_mb.item() - l_one.item()) / abs(l_one.item())
    e2, leaf2 = grads_err(g_mb, g_one)
    log(f"[train] (l2) microbatches 2 + remat vs 1, B 4: loss {l_mb.item():.6f}"
        f" vs {l_one.item():.6f} (rel {rel2:.2e}); worst gradient leaf "
        f"#{leaf2} {e2:.2e} of its max; {time.perf_counter() - t0:.1f} s")
    check(rel2 <= 1e-5, f"(l2) loss rel {rel2}")
    check(e2 <= 1e-4, f"(l2) gradient leaf #{leaf2}: {e2}")
    return dict(cfg=cfg, params=params, l1_loss_rel=rel, l1_grad=g_err,
                l1_param=p_err, l2_loss_rel=rel2, l2_grad=e2)


def train_vs_prefill(twin) -> None:
    """(l1) ``forward``'s logits at S-2 against ``prefill``'s last logits
    through ``flash_prefill`` on the same weights (the cut, f32): the
    kernel held against the training graph. Run outside (l)'s count: a
    comparison, not the training path."""
    from repro_torch.models.model import forward, init_cache, prefill
    cfg, params = twin["cfg"], twin["params"]
    dev = params["embed"].device
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (2, 256))).to(dev)
    with torch.no_grad():
        full, _ = forward(cfg, params, toks)
        last, _ = prefill(cfg, params, toks[:, :-1],
                          init_cache(cfg, 2, 256, dev))
    logits_vs_plain("(l1) prefill (flash_prefill) vs forward at S-2",
                    last, full[:, -2], torch.float32)


def train_resume_phase(dev) -> dict:
    """(l3) (l0)'s setup on the first CUT_LAYERS layers (full width; the
    whole model's 21.5 GB checkpoint took ~40 s of I/O) for 10 steps
    straight, against 5 steps, an ``async_save``, a simulated failure,
    ``run_resilient``'s restart from the checkpoint into fresh tensors
    (bit-equal to the saved ones, bf16 leaves included) and 5 more
    steps: losses within 1e-3 relative (the embedding's scatter-add on
    the card is not ordered)."""
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.distributed.fault_tolerance import run_resilient
    from repro_torch.training.checkpoint import (latest_step,
                                                 restore_checkpoint,
                                                 save_checkpoint)
    from repro_torch.training.data import synthetic_batches
    from repro_torch.training.train_loop import TrainConfig, build_train_step
    t0 = time.perf_counter()
    cfg = get_config("qwen2-1.5b").replace(num_layers=CUT_LAYERS)
    params, opt, state = train_setup(cfg, dev)
    step = build_train_step(cfg, opt, TrainConfig(remat=False))
    data = synthetic_batches(cfg.vocab_size, TRAIN_B, TRAIN_S, seed=0)
    params, state, straight, _, _ = timed_steps(step, params, state, data, 10)
    del params, state
    free_device()
    ck = smoke_dir()
    run = {"failed": 0, "losses": []}
    data = synthetic_batches(cfg.vocab_size, TRAIN_B, TRAIN_S, seed=0)
    try:
        def train_once(start):
            if start == 0:
                p, _, s = train_setup(cfg, dev)
                p, s, losses, _, _ = timed_steps(step, p, s, data, 5)
                run["losses"] += losses
                t = time.perf_counter()
                save_checkpoint(str(ck), 5, p, s, async_save=True).join()
                run["save_s"] = time.perf_counter() - t
                run["saved"] = (_leaves(p), _leaves(s))
                run["failed"] += 1
                raise RuntimeError("simulated failure after step 5")
            t = time.perf_counter()
            tree, at = restore_checkpoint(str(ck), start, device=dev)
            torch.cuda.synchronize()
            run["restore_s"] = time.perf_counter() - t
            p, s = tree["params"], tree["opt_state"]
            saved_p, saved_s = run.pop("saved")
            check(all(a.dtype == b.dtype and torch.equal(a, b) for a, b in
                      zip(_leaves(p) + _leaves(s), saved_p + saved_s)),
                  "(l3) the restored state differs from the saved state")
            check(p["embed"].dtype == torch.bfloat16
                  and int(s["step"]) == at == 5, "(l3) restored tree")
            del saved_p, saved_s
            free_device()
            p, s, losses, _, _ = timed_steps(step, p, s, data, 5)
            run["losses"] += losses
            return start + 5

        def on_failure(e, restarts):
            check("simulated failure" in str(e),
                  f"(l3) an unexpected failure: {e!r}")
            return latest_step(str(ck))

        last = run_resilient(train_once, max_restarts=1,
                             on_failure=on_failure)
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    check(run["failed"] == 1 and last == 10, f"(l3) run_resilient: {run}")
    gaps = [abs(a - b) / abs(b) for a, b in zip(run["losses"], straight)]
    log(f"[train] (l3) 10 steps straight vs 5 + async_save + a simulated "
        f"failure + run_resilient's restore (bit-equal, bf16 leaves "
        f"included) + 5: largest loss gap {max(gaps):.2e} relative (at step "
        f"{int(np.argmax(gaps))}); save {run['save_s']:.1f} s, restore "
        f"{run['restore_s']:.1f} s; {time.perf_counter() - t0:.1f} s")
    check(max(gaps) <= 1e-3, f"(l3) losses {run['losses']} vs {straight}")
    free_device()
    return dict(gap=max(gaps), save_s=run["save_s"],
                restore_s=run["restore_s"])


def train_launcher_phase() -> None:
    """(l4) ``python -m repro_torch.launch.train`` at qwen2-1.5b: 20
    steps of B 8 x S 256 with a checkpoint, then ``--resume`` for 5: both
    exit 0, the second prints ``resumed from step 20``."""
    import os
    import shutil
    t0 = time.perf_counter()
    ck = smoke_dir()
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "qwen2-1.5b", "--batch", str(TRAIN_B), "--seq", str(TRAIN_S),
            "--ckpt-dir", str(ck)]
    try:
        outs = []
        for extra in (["--steps", "20"], ["--resume", "--steps", "5"]):
            out = subprocess.run(base + extra, capture_output=True,
                                 text=True, timeout=300, cwd=ROOT,
                                 env=dict(os.environ,
                                          PYTHONPATH=str(ROOT / "src")))
            check(out.returncode == 0, f"(l4) {' '.join(extra)} exited "
                  f"{out.returncode}: {out.stderr[-2000:]}")
            outs.append(out.stdout)
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    check("resumed from step 20" in outs[1] and "resumed" not in outs[0],
          f"(l4) --resume printed {outs[1]!r}")
    last = [ln.split() for ln in outs[1].splitlines() if ln.startswith(
        "step")][-1]
    log(f"[train] (l4) the launcher at qwen2-1.5b: 20 steps with a "
        f"checkpoint, then --resume (resumed from step 20) for 5; last "
        f"{' '.join(last)}; {time.perf_counter() - t0:.1f} s")


def family_batch(cfg, B: int, S: int) -> dict:
    """One batch of ``cfg``'s family from seed SEED: random tokens and
    their shift as labels, the vlm's patches under a prefix of their
    length, the encdec's frames."""
    rng = np.random.default_rng(SEED)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if cfg.frontend == "vision":
        batch["patches"] = rng.standard_normal(
            (B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
        batch["prefix_len"] = np.full((B,), cfg.frontend_len, np.int32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder.num_frames, cfg.d_model)).astype(np.float32)
    return batch


def train_families_phase(dev) -> list:
    """(l5) every other family at full width, 5 steps on one repeated
    batch, depth cut only where memory forces it: the loss falls, and
    every loss and grad norm is finite."""
    from repro_torch.configs import get_config
    from repro_torch.training.train_loop import TrainConfig, build_train_step
    rows = []
    for name, layers, B, S, remat in L5_RUNS:
        t0 = time.perf_counter()
        full = get_config(name)
        cfg = full if layers is None else full.replace(num_layers=layers)
        params, opt, state = train_setup(cfg, dev, full)
        batch = family_batch(cfg, B, S)
        step = build_train_step(cfg, opt, TrainConfig(remat=remat))
        torch.cuda.reset_peak_memory_stats()
        n_params = sum(t.numel() for t in _leaves(params))
        params, state, losses, norms, ms = timed_steps(
            step, params, state, itertools.repeat(batch), 5)
        peak = torch.cuda.max_memory_allocated()
        check(all(map(math.isfinite, losses + norms)),
              f"(l5) {name}: losses {losses}, grad norms {norms}")
        check(losses[-1] < losses[0], f"(l5) {name}: loss did not fall "
              f"{losses}")
        med = float(np.median(ms[1:]))
        what = "whole" if layers is None else \
            f"{layers} of {full.num_layers} layers"
        log(f"[train] (l5) {name} ({what}, {n_params / 1e9:.3f} B "
            f"parameters, {opt.kind}{', remat' if remat else ''}), B {B} x "
            f"S {S}{' + ' + str(cfg.frontend_len) + ' patches' if cfg.frontend == 'vision' else ''}"
            f"{' + ' + str(cfg.encoder.num_frames) + ' frames' if cfg.family == 'encdec' else ''}: "
            f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; {med:.1f} ms a step "
            f"(median of 1-4), peak {peak / 2 ** 30:.2f} GiB; "
            f"{time.perf_counter() - t0:.1f} s")
        rows.append(dict(name=name, ms=med, peak_gib=peak / 2 ** 30))
        del params, state, step
        free_device()
    return rows


def training_phase(dev) -> dict:
    """(l) single-device training, each part with the kernels' counts
    zeroed just before it and read just after: no kernel is on the
    training path, so every count must stay 0. (l1)'s prefill check
    launches ``flash_prefill`` between the parts, outside the counts.
    (o4) runs on the host beside (l4)."""
    out = {}
    for tag, fn, args in (("(l0) qwen2-1.5b whole", train_whole_phase,
                           (dev,)),
                          ("(l1)+(l2) card vs CPU, microbatches",
                           train_twin_phase, (dev,)),
                          ("(l3) resume", train_resume_phase, (dev,)),
                          ("(l4) launcher", train_launcher_phase, ()),
                          ("(l5) families", train_families_phase, (dev,))):
        o4 = start_host_dryrun() if tag.startswith("(l4)") else None
        try:
            out[tag[:4]], counts = main_path(f"training {tag}", fn, *args)
            if o4 is not None:
                out["(o4)"] = host_dryrun_phase(*o4)
        finally:
            if o4 is not None:
                stop_host_dryrun(*o4)
        check(not any(counts.values()),
              f"training {tag}: kernel launches {counts}, expected none")
        if tag.startswith("(l1)"):
            twin = out["(l1)"]
            train_vs_prefill(twin)
            del twin["params"], twin["cfg"]
            free_device()
    return out


# ======================================================================
# (n) training over a mesh on the card
# ======================================================================
# (n1): qwen2-1.5b's first 4 layers (cut from all 28, whose 21.5 GB
# checkpoint took ~40 s to save from the mesh: (l4) saves and restores
# the whole model's through the launcher on one device)
N1_ARGS = dict(arch="qwen2-1.5b", reduced=False, layers=4, steps=3,
               batch=TRAIN_B, seq=TRAIN_S, microbatches=1, ckpt_dir=None,
               resume=False, device="cuda")
N2_LAYERS, N2_TWIN_LAYERS = 4, 1   # (n2): qwen2-1.5b's first layers
N3_LAYERS, N3_B, N3_S = 2, 4, 256  # (n3): phi3.5-moe's first layers
N_LOSS_TOL = 1e-2                  # bf16 mesh vs one device, relative
N_TWIN_TOL = 1e-4                  # f32 mesh vs one device, relative
# (n4): the other families at full width on 1x2, bf16: (name, layers or
# None for whole, B, text S); paligemma at B 2 (its 256 patches make the
# logits gathered over 'model' 384 positions a row)
N4_RUNS = (("paligemma-3b", 2, 2, 128),
           ("mamba2-1.3b", 4, 4, 128),
           ("recurrentgemma-9b", 3, 4, 128),
           ("whisper-tiny", None, 4, 128),
           ("deepseek-v2-236b", 2, 4, 128))
N4_STEPS = 2
N2_COMPRESS_TOL = 0.02             # int8 mean vs the exact mean, of its max


def slicewise_moe(D: int, M: int):
    """The checker of (n3): a ``moe_apply`` that runs the port's
    ``moe_local`` on each (data shard, model slice) of its input, the
    rows of each data shard flattened and padded with zeros to a
    multiple of M tokens, the aux losses averaged. It is what
    ``moe_ep`` computes over a D x M mesh (each slice routed with its
    own capacity), on one device."""
    from repro_torch.models import moe as moe_mod

    def apply(params, x, cfg, mesh=None, valid=None, expert_tp=False):
        B, S, d = x.shape
        ys, auxs = [], []
        for xd in x.chunk(D):
            t = xd.shape[0] * S
            tm = -(-t // M)
            x2 = torch.cat([xd.reshape(t, d), xd.new_zeros((tm * M - t, d))])
            parts = []
            for m in range(M):
                y, aux = moe_mod.moe_local(
                    params, x2[m * tm:(m + 1) * tm][None], cfg)
                parts.append(y[0])
                auxs.append(aux)
            ys.append(torch.cat(parts)[:t].reshape(xd.shape))
        return torch.cat(ys), torch.stack(auxs).mean()
    return apply


def family_setup(name: str, layers, dev, mesh=None):
    """``name`` at full width on its first ``layers`` layers (None:
    whole), bf16, the optimizer the whole config selects, from seed
    SEED; on a mesh this rank's blocks. Returns (cfg, opt, rules,
    params, state)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import ShardingRules, tree_local
    from repro_torch.models.model import init_params, param_shapes
    from repro_torch.training import optimizer as O
    full = get_config(name)
    cfg = full if layers is None else full.replace(num_layers=layers)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
    opt, rules, specs = O.select_optimizer(full), None, None
    if mesh is not None:
        rules = ShardingRules(cfg, mesh)
        specs = rules.params(param_shapes(cfg))
        params = O.tree_map(lambda t: t.clone(),
                            tree_local(params, specs, mesh))
    return cfg, opt, rules, params, O.opt_init(opt, params, mesh, specs)


def n3_batches(cfg):
    from repro_torch.training.data import synthetic_batches
    return synthetic_batches(cfg.vocab_size, N3_B, N3_S, seed=3)


def twin_setup(dev, layers, dtype, mesh=None, fsdp=None):
    """qwen2-1.5b at full width on its first ``layers`` layers in
    ``dtype``, from seed SEED, AdamW; on a mesh this rank's blocks under
    ``ShardingRules(fsdp=fsdp)``. Returns (cfg, opt, rules, specs,
    params, state)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import ShardingRules, tree_local
    from repro_torch.models.model import init_params, param_shapes
    from repro_torch.training import optimizer as O
    name = str(dtype).replace("torch.", "")
    cfg = get_config("qwen2-1.5b").replace(num_layers=layers,
                                           param_dtype=name, dtype=name)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
    opt, rules, specs = O.OptConfig(), None, None
    if mesh is not None:
        rules = ShardingRules(cfg, mesh, fsdp=fsdp)
        specs = rules.params(param_shapes(cfg))
        params = O.tree_map(lambda t: t.clone(),
                            tree_local(params, specs, mesh))
    return cfg, opt, rules, specs, params, O.opt_init(opt, params, mesh,
                                                      specs)


def twin_batch(cfg):
    """(n2)'s f32 twin batch: 4 rows of 64, weights that differ by row."""
    from repro_torch.training.data import synthetic_batches
    b = next(synthetic_batches(cfg.vocab_size, 4, 64, seed=5))
    b["weights"] = b["weights"] * np.arange(1, 5, dtype=np.float32)[:, None]
    return b


def held_digest(params, specs) -> dict:
    """{leaf: sha1 of its bytes} for the leaves a rank holds whole (no
    axis in their spec): every rank must hold the same bits."""
    import hashlib
    from repro_torch.distributed.sharding import spec_axes
    out = {}

    def walk(t, s, path):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], s[k], f"{path}/{k}")
        elif isinstance(t, list):
            for i, (u, z) in enumerate(zip(t, s)):
                walk(u, z, f"{path}/{i}")
        elif not spec_axes(s):
            b = t.detach().contiguous().view(torch.uint8).cpu().numpy()
            out[path] = hashlib.sha1(b.tobytes()).hexdigest()
    walk(params, specs, "")
    return out


def mesh_steps(mesh, cfg, opt, rules, params, state, batches, n):
    """``n`` timed steps of the meshed train step: (params, state,
    losses, grad norms, ms a step)."""
    from repro_torch.training.train_loop import TrainConfig, build_train_step
    step = build_train_step(cfg, opt, TrainConfig(remat=False), mesh=mesh,
                            rules=rules)
    return timed_steps(step, params, state, batches, n)


def n_rank_1x2(mesh, ckpt: str, feeds: dict) -> dict:
    """(n1), (n3) and (n4) on one rank of the 1x2 mesh, with the
    kernels' counts zeroed just before them and read just after, then
    (o1) with its own (``feeds``: the one device's greedy tokens). (n1)
    is the launcher's rank body (``prepare``, then ``train_loop``) with
    a checkpoint under ``ckpt`` at its last step, then ``--resume``'s
    ``prepare``, which restores it onto the mesh."""
    from repro_torch.launch import train as LT
    from repro_torch.models.model import param_shapes
    from repro_torch.training.train_loop import TrainConfig, train_loop
    out = {"rank": mesh.rank}
    wrappers = kernel_counts()
    for w in wrappers.values():
        w.launches = 0
    # (n1): qwen2-1.5b's first layers, timed as one call; each step's
    # start marked where train_loop draws its batch
    args = dict(N1_ARGS, ckpt_dir=ckpt)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run = LT.prepare(args, mesh)
    marks = []

    def batches(it=run["data"]):
        while True:
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            yield next(it)
    params, state, hist = train_loop(
        run["cfg"], run.pop("params"), run.pop("state"), batches(),
        steps=args["steps"], opt=run["opt"], tc=TrainConfig(remat=False),
        mesh=mesh, rules=run["rules"], checkpoint_every=args["steps"],
        ckpt_dir=ckpt, log_every=1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    specs = run["rules"].params(param_shapes(run["cfg"]))
    out["n1"] = dict(losses=[loss for _, loss in hist], call_s=t1 - t0,
                     ms=[(b - a) * 1e3 for a, b in zip(marks, marks[1:])],
                     last_and_save_s=t1 - marks[-1],
                     peak=torch.cuda.max_memory_allocated(),
                     held=held_digest(params, specs),
                     local_gib=sum(t.numel() * t.element_size()
                                   for t in _leaves(params)) / 2 ** 30)
    del run
    t0 = time.perf_counter()
    back = LT.prepare(dict(args, resume=True), mesh)
    torch.cuda.synchronize()
    saved = _leaves(params) + _leaves(state)
    got = _leaves(back["params"]) + _leaves(back["state"])
    out["n1"].update(
        restore_s=time.perf_counter() - t0, start=back["start"],
        restored=len(got) == len(saved) and all(
            a.dtype == b.dtype and torch.equal(a, b)
            for a, b in zip(got, saved)))
    del back, params, state, saved, got
    free_device()
    # (n3): phi3.5-moe, 8 of 16 experts a rank
    torch.cuda.reset_peak_memory_stats()
    cfg, opt, rules, params, state = family_setup(
        "phi3.5-moe-42b-a6.6b", N3_LAYERS, mesh.device, mesh)
    specs = rules.params(param_shapes(cfg))
    params, state, losses, norms, ms = mesh_steps(
        mesh, cfg, opt, rules, params, state, n3_batches(cfg), 2)
    out["n3"] = dict(losses=losses, norms=norms, ms=ms,
                     peak=torch.cuda.max_memory_allocated(),
                     experts=(params["layers"]["moe"]["w_up"].shape[1],
                              cfg.moe.num_experts),
                     held=held_digest(params, specs))
    del params, state
    free_device()
    # (n4): the vlm, ssm, hybrid, encdec and mla families
    out["n4"] = {}
    for name, layers, B, S in N4_RUNS:
        torch.cuda.reset_peak_memory_stats()
        cfg, opt, rules, params, state = family_setup(name, layers,
                                                      mesh.device, mesh)
        specs = rules.params(param_shapes(cfg))
        split = sum(t.shape != f.shape for t, f in zip(
            _leaves(params), _leaves(param_shapes(cfg))))
        params, state, losses, norms, ms = mesh_steps(
            mesh, cfg, opt, rules, params, state,
            itertools.repeat(family_batch(cfg, B, S)), N4_STEPS)
        out["n4"][name] = dict(losses=losses, norms=norms, ms=ms,
                               peak=torch.cuda.max_memory_allocated(),
                               split=split, leaves=len(_leaves(params)),
                               held=held_digest(params, specs))
        del params, state
        free_device()
    out["counts"] = {n: w.launches for n, w in wrappers.items()}
    out["o"] = serve_rank(mesh, {"o1": O1, "o1_twin": O1_TWIN}, feeds)
    return out


def n_rank_2x2(mesh, ref_path, feeds: dict) -> dict:
    """(n2) on one rank of the 2x2 mesh with FSDP: qwen2-1.5b's first
    N2_LAYERS layers in bf16, their parameters saved from the mesh and
    ``elastic_rescale``d onto a 1x4 view of the four ranks; then the f32
    twin on N2_TWIN_LAYERS held to the single-device step's loss, grad
    norm and every gradient leaf (made whole), and this rank's own
    gradients of it (before their sum over 'data') reduced over 'data'
    by ``compressed_psum``. Then (o2), with its own counts (``feeds``:
    the one device's greedy tokens)."""
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.compression import (compressed_psum,
                                                     wire_bytes)
    from repro_torch.distributed.sharding import tree_full
    from repro_torch.training.data import synthetic_batches
    from repro_torch.training.optimizer import tree_map
    from repro_torch.training.train_loop import (TrainConfig, batch_to,
                                                 mesh_step_grads, step_grads)
    out = {"rank": mesh.rank}
    wrappers = kernel_counts()
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    cfg, opt, rules, specs, params, state = twin_setup(
        mesh.device, N2_LAYERS, torch.bfloat16, mesh, fsdp=True)
    params, state, losses, norms, ms = mesh_steps(
        mesh, cfg, opt, rules, params, state,
        synthetic_batches(cfg.vocab_size, TRAIN_B, TRAIN_S, seed=0), 2)
    out["bf16"] = dict(losses=losses, norms=norms, ms=ms,
                       peak=torch.cuda.max_memory_allocated(),
                       held=held_digest(params, specs))
    del state
    out["rescale"] = n2_rescale(mesh, rules, params, len(losses), str(
        Path(ref_path).with_name("n2_ckpt")))
    del params
    free_device()
    cfg, opt, rules, specs, params, state = twin_setup(
        mesh.device, N2_TWIN_LAYERS, torch.float32, mesh, fsdp=True)
    batch = batch_to(twin_batch(cfg), mesh.device)
    loss, grads = mesh_step_grads(cfg, params, batch, TrainConfig(
        remat=False), mesh, rules, specs)
    grads = tree_full(grads, specs, mesh)
    out["f32"] = dict(loss=loss.item())
    # compressed_psum of this rank's own gradients over 'data', against
    # their exact mean
    _, own = step_grads(cfg, params, batch, TrainConfig(remat=False), mesh,
                        rules)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mean, errs = compressed_psum(own, mesh, "data")
    torch.cuda.synchronize()
    c_ms = (time.perf_counter() - t0) * 1e3
    exact = tree_map(lambda g: C.all_reduce(g.float().clone(), mesh, "data")
                     / mesh.data, own)
    worst = max(((m - e).abs().max() / e.abs().max().clamp_min(1e-30)).item()
                for m, e in zip(_leaves(mean), _leaves(exact)))
    out["compress"] = dict(
        worst=worst, ms=c_ms, wire=wire_bytes(own),
        f32_bytes=4 * sum(g.numel() for g in _leaves(own)),
        finite=all(bool(torch.isfinite(t).all())
                   for t in _leaves(mean) + _leaves(errs)))
    del own, mean, errs, exact
    if mesh.rank == 0:
        ref = torch.load(ref_path)
        errs = {}
        tree_map(lambda path, g, r: errs.__setitem__(path, (
            (g.cpu() - r).abs().max() / r.abs().max().clamp_min(1e-30))
            .item()), _paths(grads), grads, ref["grads"])
        leaf = max(errs, key=errs.get)
        out["f32"].update(worst=(errs[leaf], leaf), ref_loss=ref["loss"])
    del params, state, grads
    free_device()
    out["counts"] = {n: w.launches for n, w in wrappers.items()}
    out["o"] = serve_rank(mesh, {"o2": O2}, feeds)
    return out


def n2_rescale(mesh, rules, params, step: int, ckpt: str) -> dict:
    """(n2)'s parameters saved from the 2x2 mesh (its blocks gathered to
    rank 0, which writes the full leaves), then ``elastic_rescale``d
    onto a 1x4 view of the same ranks (its 'model' group the world):
    each restored block bit-equal to the view's ``local_block`` of the
    saved leaf."""
    import torch.distributed as dist
    from repro_torch.distributed.fault_tolerance import elastic_rescale
    from repro_torch.distributed.sharding import ShardingRules, tree_local
    from repro_torch.models.model import param_shapes
    from repro_torch.training.checkpoint import (restore_checkpoint,
                                                 save_checkpoint)
    cfg = rules.cfg
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_checkpoint(ckpt, step, params, shardings=(rules, mesh))
    t1 = time.perf_counter()
    view = dataclasses.replace(mesh, data=1, model=mesh.world,
                               model_group=dist.group.WORLD, data_group=None)
    tree, step, view = elastic_rescale(
        ckpt, lambda: view, lambda m: ShardingRules(cfg, m),
        device=mesh.device)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    full, _ = restore_checkpoint(ckpt)
    want = tree_local(full["params"], ShardingRules(cfg, view).params(
        param_shapes(cfg)), view)
    got, want = _leaves(tree["params"]), _leaves(want)
    return dict(save_s=t1 - t0, rescale_s=t2 - t1, step=step,
                model=view.model, leaves=len(got),
                moved=sum(a.shape != b.shape
                          for a, b in zip(got, _leaves(params))),
                same=len(got) == len(want) and all(
                    a.dtype == b.dtype and torch.equal(a.cpu(), b)
                    for a, b in zip(got, want)))


def _paths(tree, prefix=""):
    """The tree with each leaf replaced by its path."""
    if isinstance(tree, dict):
        return {k: _paths(v, f"{prefix}/{k}") for k, v in tree.items()}
    return prefix


def mesh_train_phase(dev) -> tuple:
    """(n) training over a mesh, the ranks sharing the card over gloo:
    each single-device reference first, then freed; (n1), (n3) and (n4)
    in one 1x2 spawn, (n2) in a 2x2 one; (o1) and (o2), serving over a
    mesh, run in those ranks after them. Returns the ranks' kernel
    counts of training and of serving."""
    import shutil
    from repro_torch.launch import train as LT
    from repro_torch.launch.mesh import spawn
    from repro_torch.models import moe as moe_mod
    from repro_torch.training.optimizer import tree_map
    from repro_torch.training.train_loop import (TrainConfig, batch_to,
                                                 build_train_step,
                                                 loss_and_grads)
    t0 = time.perf_counter()
    # the single-device references; each peak counts what the reference
    # allocates past what this process already holds (a rank starts from
    # nothing)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    run = LT.prepare(N1_ARGS, None)
    one = dict(zip(("params", "state", "losses", "norms", "ms"), timed_steps(
        build_train_step(run["cfg"], run["opt"], TrainConfig(remat=False)),
        run["params"], run["state"], run["data"], N1_ARGS["steps"])))
    one["peak"] = torch.cuda.max_memory_allocated() - base
    del run, one["params"], one["state"]
    free_device()
    patched = moe_mod.moe_apply
    moe_mod.moe_apply = slicewise_moe(1, 2)
    try:
        cfg, opt, _, params, state = family_setup(
            "phi3.5-moe-42b-a6.6b", N3_LAYERS, dev)
        three = dict(zip(("params", "state", "losses", "norms", "ms"),
                         timed_steps(build_train_step(cfg, opt, TrainConfig(
                             remat=False)), params, state, n3_batches(cfg),
                             2)))
        del params, state, three["params"], three["state"]
        free_device()
        # (n4)'s references, the mla family's moe layer the slice-wise
        # moe of the 1x2 mesh
        four = {}
        for name, layers, B, S in N4_RUNS:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            cfg, opt, _, params, state = family_setup(name, layers, dev)
            four[name] = dict(zip(("params", "state", "losses", "norms",
                                   "ms"), timed_steps(
                build_train_step(cfg, opt, TrainConfig(remat=False)),
                params, state, itertools.repeat(family_batch(cfg, B, S)),
                N4_STEPS)))
            four[name]["peak"] = torch.cuda.max_memory_allocated() - base
            four[name]["params_n"] = sum(t.numel() for t in _leaves(params))
            del params, state, four[name]["params"], four[name]["state"]
            free_device()
    finally:
        moe_mod.moe_apply = patched
    cfg, _, _, _, params, _ = twin_setup(dev, N2_TWIN_LAYERS, torch.float32)
    loss, _, grads = loss_and_grads(cfg, params, batch_to(twin_batch(cfg),
                                                          dev))
    tmp = smoke_dir()
    ref_path = tmp / "n2_twin.pt"
    torch.save({"loss": loss.item(),
                "grads": tree_map(lambda g: g.cpu(), grads)}, ref_path)
    del params, grads
    free_device()
    # (o1)'s and (o2)'s one-device runs
    t_o = time.perf_counter()
    refs = {name: serve_reference(plan, dev) for name, plan in (
        ("o1", O1), ("o1_twin", O1_TWIN), ("o2", O2))}
    feeds = {name: ref["greedy"][:-1] for name, ref in refs.items()}
    t_o = time.perf_counter() - t_o
    log(f"[mesh-train] single-device references: "
        f"{time.perf_counter() - t0:.1f} s ((o)'s {t_o:.1f} s)")
    try:
        r12 = spawn("1x2", n_rank_1x2, str(tmp / "n1"), feeds, device="cuda",
                    timeout_s=560)
        r22 = spawn("2x2", n_rank_2x2, str(ref_path), feeds, device="cuda",
                    timeout_s=460)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    card_line = card()
    # (n1)
    for r in r12:
        n1 = r["n1"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(n1["losses"],
                                                      one["losses"]))
        log(f"[mesh-train] (n1) qwen2-1.5b {N1_ARGS['layers']} of 28 "
            f"layers, 1x2 rank {r['rank']}, "
            f"the launcher's prepare + train_loop: loss {n1['losses']} (one "
            f"device {one['losses']}, worst rel {rel:.2e}); "
            f"{n1['call_s']:.1f} s for the call, ms a step "
            f"{[round(v, 2) for v in n1['ms']]} then the last step and the "
            f"checkpoint's save {n1['last_and_save_s']:.1f} s (one device "
            f"ms a step {[round(v, 2) for v in one['ms']]}); --resume's "
            f"restore onto the mesh {n1['restore_s']:.1f} s, from step "
            f"{n1['start']}, every block bit-equal {n1['restored']}; peak "
            f"{n1['peak'] / 2 ** 30:.2f} GiB (one device "
            f"{one['peak'] / 2 ** 30:.2f}), parameters held "
            f"{n1['local_gib']:.2f} GiB; {card_line}")
        check(len(n1["losses"]) == N1_ARGS["steps"] and rel <= N_LOSS_TOL,
              f"(n1) rank {r['rank']} losses {n1['losses']}: {rel}")
        check(n1["peak"] < one["peak"],
              f"(n1) rank {r['rank']} peak {n1['peak']} >= {one['peak']}")
        check(n1["start"] == N1_ARGS["steps"] and n1["restored"],
              f"(n1) rank {r['rank']}: restored from {n1['start']}, "
              f"bit-equal {n1['restored']}")
    check(r12[0]["n1"]["held"] == r12[1]["n1"]["held"]
          and r12[0]["n1"]["held"], "(n1) replicated leaves differ")
    # (n3)
    for r in r12:
        n3 = r["n3"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(n3["losses"],
                                                      three["losses"]))
        log(f"[mesh-train] (n3) phi3.5-moe {N3_LAYERS} of 32 layers, 1x2 "
            f"rank {r['rank']} ({n3['experts'][0]} of {n3['experts'][1]} "
            f"experts): loss "
            f"{n3['losses']} (one device, slice-wise moe "
            f"{three['losses']}, worst rel {rel:.2e}), grad norm "
            f"{n3['norms']} (one device {three['norms']}); ms a step "
            f"{[round(v, 2) for v in n3['ms']]} (one device "
            f"{[round(v, 2) for v in three['ms']]}); peak "
            f"{n3['peak'] / 2 ** 30:.2f} GiB")
        check(2 * n3["experts"][0] == n3["experts"][1] and rel <= N_LOSS_TOL,
              f"(n3) rank {r['rank']}: experts {n3['experts']}, rel {rel}")
    check(r12[0]["n3"]["held"] == r12[1]["n3"]["held"],
          "(n3) replicated leaves differ")
    # (n4)
    for name, layers, B, S in N4_RUNS:
        one = four[name]
        what = "whole" if layers is None else f"{layers} layers"
        for r in r12:
            n4 = r["n4"][name]
            rel = max(abs(a - b) / abs(b) for a, b in zip(n4["losses"],
                                                          one["losses"]))
            log(f"[mesh-train] (n4) {name} ({what}, "
                f"{one['params_n'] / 1e9:.3f} B parameters, bf16), B {B} x "
                f"S {S}, 1x2 rank {r['rank']} ({n4['split']} of "
                f"{n4['leaves']} leaves split): loss {n4['losses']} (one "
                f"device {one['losses']}, worst rel {rel:.2e}), grad norm "
                f"{n4['norms']} (one device {one['norms']}); ms a step "
                f"{[round(v, 2) for v in n4['ms']]} (one device "
                f"{[round(v, 2) for v in one['ms']]}); peak "
                f"{n4['peak'] / 2 ** 30:.2f} GiB (one device "
                f"{one['peak'] / 2 ** 30:.2f}); {card_line}")
            check(len(n4["losses"]) == N4_STEPS and rel <= N_LOSS_TOL
                  and all(map(math.isfinite, n4["losses"] + n4["norms"]))
                  and n4["split"] > 0,
                  f"(n4) {name} rank {r['rank']}: losses {n4['losses']} vs "
                  f"{one['losses']} ({rel}), split {n4['split']}")
        check(r12[0]["n4"][name]["held"] == r12[1]["n4"][name]["held"]
              and r12[0]["n4"][name]["held"],
              f"(n4) {name}: replicated leaves differ")
    # (n2)
    held = [r["bf16"]["held"] for r in r22]
    for r in r22:
        b = r["bf16"]
        log(f"[mesh-train] (n2) qwen2-1.5b {N2_LAYERS} of 28 layers bf16, "
            f"2x2 fsdp rank {r['rank']}: loss {b['losses']}, grad norm "
            f"{b['norms']}; ms a step {[round(v, 2) for v in b['ms']]}; "
            f"peak {b['peak'] / 2 ** 30:.2f} GiB")
        check(all(map(math.isfinite, b["losses"] + b["norms"])),
              f"(n2) rank {r['rank']} non-finite {b}")
    check(all(h == held[0] for h in held), "(n2) replicated leaves differ")
    f32 = r22[0]["f32"]
    rel = abs(f32["loss"] - f32["ref_loss"]) / abs(f32["ref_loss"])
    log(f"[mesh-train] (n2) f32 twin, {N2_TWIN_LAYERS} layer, 2x2 fsdp: loss "
        f"{f32['loss']:.6f} vs one device {f32['ref_loss']:.6f} (rel "
        f"{rel:.2e}); worst gradient leaf {f32['worst'][1]} "
        f"{f32['worst'][0]:.2e} of its max")
    check(all(r["f32"]["loss"] == f32["loss"] for r in r22),
          "(n2) ranks' losses differ")
    check(rel <= N_TWIN_TOL and f32["worst"][0] <= N_TWIN_TOL,
          f"(n2) f32 twin: loss rel {rel}, gradient {f32['worst']}")
    for r in r22:
        c, e = r["compress"], r["rescale"]
        log(f"[mesh-train] (n2) rank {r['rank']}: compressed_psum over "
            f"'data' of its own f32 twin gradients, worst leaf "
            f"{c['worst']:.2e} of the exact mean's max (<= "
            f"{N2_COMPRESS_TOL}), wire_bytes {c['wire']} int8 against "
            f"{c['f32_bytes']} of f32, {c['ms']:.1f} ms; bf16 parameters "
            f"saved from 2x2 in {e['save_s']:.1f} s, elastic_rescale onto "
            f"1x{e['model']} in {e['rescale_s']:.1f} s ({e['moved']} of "
            f"{e['leaves']} blocks reshaped), bit-equal {e['same']}")
        check(c["finite"] and c["worst"] <= N2_COMPRESS_TOL
              and 4 * c["wire"] == c["f32_bytes"],
              f"(n2) rank {r['rank']} compressed_psum: {c}")
        check(e["same"] and e["step"] == 2 and e["model"] == 4
              and e["moved"] > 0, f"(n2) rank {r['rank']} rescale: {e}")
    o_counts = mesh_serve_checks(refs, r12, r22)
    log(f"[mesh-train] phase (n) with (o1), (o2): "
        f"{time.perf_counter() - t0:.1f} s")
    return [r["counts"] for r in r12 + r22], o_counts


# ======================================================================
# (o) serving over a mesh, and the dry run against the card
# ======================================================================
# (o1) in (n1)'s 1x2 ranks: qwen2-1.5b whole in bf16, a prefill of B 2 x
# 1024 into a 2048-slot ring then 8 decode steps, and its f32 twin on
# the first 2 layers; (o2) in (n2)'s 2x2 ranks: phi3.5-moe on its first
# 2 of 32 layers in f32 with expert_tp, B 2 x 64 into 128 slots then 4
# decode steps. Each is held to one device's run in this process (the
# mesh decodes the one device's greedy tokens, so that every step's
# logits compare)
O1 = dict(arch="qwen2-1.5b", layers=None, dtype="bfloat16", B=2, S=1024,
          capacity=2048, steps=8, expert_tp=False, seed=11)
O1_TWIN = dict(O1, layers=2, dtype="float32")
O2 = dict(arch="phi3.5-moe-42b-a6.6b", layers=2, dtype="float32", B=2,
          S=64, capacity=128, steps=4, expert_tp=True, seed=12)
O_BF16_TOL = 5e-2      # bf16 mesh vs one device, of a step's largest |logit|
O_F32_TOL = 1e-4       # f32 mesh vs one device, the same
O3_MEM_TOL = 0.25      # the dry run's peak above its arguments vs the card's
# (o4) on the host: (arch, shape, expert_tp)
O4_CELLS = (("qwen2-1.5b", "train_4k", False),
            ("deepseek-v2-236b", "decode_32k", True))


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def plan_config(plan):
    """``plan``'s config: its first ``layers`` (None: whole)."""
    from repro_torch.configs import get_config
    full = get_config(plan["arch"])
    return full if plan["layers"] is None else \
        full.replace(num_layers=plan["layers"])


def serve_setup(plan, dev, mesh=None):
    """(cfg, params, rules): ``plan``'s config on its first ``layers``
    (None: whole) in its type, weights drawn in bf16 from seed SEED on
    ``dev`` (then cast: the one device and the mesh hold the same
    values); on a mesh this rank's blocks under ``ShardingRules(mode=
    "decode", expert_tp=)``."""
    from repro_torch.distributed.sharding import ShardingRules, tree_local
    from repro_torch.models.model import init_params, param_shapes
    from repro_torch.training.optimizer import tree_map
    cfg = plan_config(plan)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
    cfg = cfg.replace(param_dtype=plan["dtype"], dtype=plan["dtype"])
    rules = None
    if mesh is not None:
        rules = ShardingRules(cfg, mesh, mode="decode",
                              expert_tp=plan["expert_tp"])
        params = tree_map(lambda t: t.clone(), tree_local(
            params, rules.params(param_shapes(cfg)), mesh))
    params = cast_params(params, getattr(torch, plan["dtype"]))
    return cfg, params, rules


@contextlib.contextmanager
def timed_collectives(dev, calls: list):
    """Within the block, every collective the port issues (each is one
    ``torch.distributed.all_reduce``) runs between two device syncs, and
    appends its seconds to ``calls``: the host's wait on the collective
    alone, not on the device work queued before it."""
    import torch.distributed as dist
    inner = dist.all_reduce

    def timed(*a, **k):
        _sync(dev)
        t0 = time.perf_counter()
        out = inner(*a, **k)
        _sync(dev)
        calls.append(time.perf_counter() - t0)
        return out
    dist.all_reduce = timed
    try:
        yield calls
    finally:
        dist.all_reduce = inner


def serve_steps(plan, cfg, params, dev, mesh=None, rules=None, feed=None,
                time_collectives=False):
    """``prefill`` of ``plan``'s prompts into an empty ring then its decode
    steps, on one device or over ``mesh`` (``params`` this rank's
    blocks); decode step i takes ``feed[i]`` (another run's greedy
    tokens) where given, else this run's own greedy token. Returns the
    logits of every call (f32) and the greedy tokens, of this rank's
    rows (``rows``), as numpy (which the ranks' queue carries), the ms
    of each call and each call's collective bytes by kind; with
    ``time_collectives`` also each call's collectives' seconds
    (``timed_collectives``)."""
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.sharding import tree_local
    from repro_torch.models import model as M
    from repro_torch.training.optimizer import tree_map
    B, cap = plan["B"], plan["capacity"]
    rng = np.random.default_rng(plan["seed"])
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (B, plan["S"]))).to(dev)
    cache = M.init_cache(cfg, B, cap, dev)
    kw, rows = {}, np.arange(B)
    if mesh is not None:
        specs = rules.cache(cache)
        cache = tree_map(lambda t: t.clone(), tree_local(cache, specs, mesh))
        kw = dict(mesh=mesh, rules=rules, capacity=cap)
        rows = tree_local({"len": torch.arange(B)}, specs, mesh)["len"]
    out = dict(logits=[], greedy=[], ms=[], coll=[], coll_s=[],
               rows=np.asarray(rows))
    with torch.no_grad():
        for i in range(plan["steps"] + 1):
            calls = []
            timing = timed_collectives(dev, calls) if time_collectives \
                else contextlib.nullcontext()
            _sync(dev)
            t0 = time.perf_counter()
            with timing, C.recording() as rec:
                if i == 0:
                    logits, cache = M.prefill(cfg, params, tokens, cache,
                                              **kw)
                else:
                    nxt = out["greedy"][-1] if feed is None else feed[i - 1]
                    logits, cache = M.decode_step(
                        cfg, params, torch.as_tensor(nxt).to(dev), cache,
                        **kw)
            _sync(dev)
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            out["coll"].append(dict(rec))
            out["coll_s"].append(calls)
            out["logits"].append(logits.float().cpu().numpy())
            out["greedy"].append(logits.argmax(-1).cpu().numpy())
    return out


def serve_rank(mesh, plans: dict, feeds: dict) -> dict:
    """(o1) or (o2) on one rank: each plan with the kernels' counts
    zeroed just before it and read just after; (o1)'s calls then once
    more with their collectives timed (``timed_collectives``)."""
    wrappers = kernel_counts()
    out = {}
    for name, plan in plans.items():
        cfg, params, rules = serve_setup(plan, mesh.device, mesh)
        for w in wrappers.values():
            w.launches = 0
        out[name] = serve_steps(plan, cfg, params, mesh.device, mesh, rules,
                                feeds[name])
        out[name]["counts"] = {n: w.launches for n, w in wrappers.items()}
        if name == "o1":
            again = serve_steps(plan, cfg, params, mesh.device, mesh, rules,
                                feeds[name], time_collectives=True)
            out[name]["timed"] = dict(ms=again["ms"],
                                      coll_s=again["coll_s"])
        del params
        free_device()
    return out


def serve_reference(plan, dev) -> dict:
    """``plan`` on one device (its moe layers the slice-wise moe of one
    data shard and two model slices: what ``expert_tp`` computes over
    the whole batch on a 2x2 mesh)."""
    from repro_torch.models import moe as moe_mod
    patched = moe_mod.moe_apply
    if plan["expert_tp"]:
        moe_mod.moe_apply = slicewise_moe(1, 2)
    try:
        cfg, params, _ = serve_setup(plan, dev)
        out = serve_steps(plan, cfg, params, dev)
    finally:
        moe_mod.moe_apply = patched
    del params
    free_device()
    return out


def serve_check(tag, plan, one, got, tol) -> dict:
    """A rank's run of ``plan`` against one device's: every call's logits
    within ``tol`` of that call's largest |logit|, and its greedy tokens
    equal wherever the one device's top two logits are further apart
    than twice the worst error (closer, the order is within the
    types' rounding). Returns (worst error, tokens equal, decidable)."""
    worst, same, decidable = 0.0, 0, 0
    rows = got["rows"]
    for g, w in zip(got["logits"], one["logits"]):
        w = w[rows]
        check(g.shape == w.shape, f"{tag}: logits {g.shape} vs {w.shape}")
        worst = max(worst, float(np.abs(g - w).max() / np.abs(w).max()))
    for g, w, lg in zip(got["greedy"], one["greedy"], one["logits"]):
        w, lg = w[rows], lg[rows]
        top = np.sort(lg, axis=-1)[:, -2:]
        gap = (top[:, 1] - top[:, 0]) / np.abs(lg).max(axis=-1)
        ok = gap > 2 * worst
        decidable += int(ok.sum())
        same += int(((g == w) | ~ok).sum())
    check(worst <= tol, f"{tag}: logits {worst:.2e} of their max > {tol}")
    n = len(got["greedy"]) * len(rows)
    check(same == n, f"{tag}: {n - same} of {n} greedy tokens differ where "
          "the one device's top two are apart")
    return dict(worst=worst, decidable=decidable, n=n)


def mesh_serve_checks(refs: dict, r12: list, r22: list) -> list:
    """(o1) and (o2): each rank's runs against one device's, and (o1)'s
    collective bytes against the dry run's for the same calls on a 1x2
    placeholder mesh. Returns the ranks' counts."""
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.specs import ShapeCell
    from repro_torch.models.model import cache_window
    card_line = card()
    for tag, name, plan, ranks, tol in (
            ("(o1) qwen2-1.5b whole bf16, 1x2", "o1", O1, r12, O_BF16_TOL),
            ("(o1) f32 twin, 2 layers, 1x2", "o1_twin", O1_TWIN, r12,
             O_F32_TOL),
            ("(o2) phi3.5-moe 2 of 32 layers f32, 2x2 expert_tp", "o2", O2,
             r22, O_F32_TOL)):
        one = refs[name]
        for r in ranks:
            got = r["o"][name]
            res = serve_check(f"{tag} rank {r['rank']}", plan, one, got, tol)
            log(f"[mesh-serve] {tag} rank {r['rank']}: prefill B "
                f"{plan['B']} x {plan['S']} into {plan['capacity']} slots "
                f"{got['ms'][0]:.1f} ms (one device {one['ms'][0]:.1f}), a "
                f"decode step {np.median(got['ms'][1:]):.2f} ms (one device "
                f"{np.median(one['ms'][1:]):.2f}); logits within "
                f"{res['worst']:.2e} of their max (<= {tol}), greedy tokens "
                f"equal where decidable ({res['decidable']} of {res['n']}); "
                f"launches {got['counts']}; {card_line}")
    # (o1)'s collective bytes: the dry run's trace of the same calls
    cfg = plan_config(O1)
    pm = make_debug_mesh(1, 2)
    rules = ShardingRules(cfg, pm, mode="decode")
    pre = DR.trace_cell(cfg, ShapeCell("o1", "prefill", O1["S"], O1["B"]),
                        pm, rules, capacity=O1["capacity"])["collective"]
    dec = DR.trace_cell(cfg, ShapeCell("o1", "decode", O1["capacity"],
                                       O1["B"]), pm, rules)["collective"]
    for r in r12:
        coll = [{k: float(v) for k, v in c.items()}
                for c in r["o"]["o1"]["coll"]]
        log(f"[mesh-serve] (o1) rank {r['rank']} collective bytes: prefill "
            f"{coll[0]} (dry run {pre}), a decode step {coll[1]} (dry run "
            f"{dec})")
        check(coll[0] == pre and all(c == dec for c in coll[1:]),
              f"(o1) rank {r['rank']}: collective bytes differ from the dry "
              "run's")
        t = r["o"]["o1"]["timed"]
        dec_ms = np.median(t["ms"][1:])
        dec_n = [len(c) for c in t["coll_s"][1:]]
        dec_s = np.median([sum(c) for c in t["coll_s"][1:]])
        log(f"[mesh-serve] (o1) rank {r['rank']}, the same calls again with "
            f"each collective between two device syncs: prefill "
            f"{t['ms'][0]:.1f} ms, of it {len(t['coll_s'][0])} collectives "
            f"{sum(t['coll_s'][0]) * 1e3:.1f} ms; a decode step "
            f"{dec_ms:.2f} ms (median), of it {dec_n[0]} collectives "
            f"{dec_s * 1e3:.2f} ms ({dec_s * 1e3 / dec_ms:.1%}; "
            f"{dec_s * 1e6 / dec_n[0]:.0f} us each); {card_line}")
        check(len(set(dec_n)) == 1, f"(o1) rank {r['rank']}: decode steps "
              f"issued {dec_n} collectives")
        n = r["o"]["o1"]["counts"]["flash_prefill"]
        check(n == cfg.num_layers,
              f"(o1) rank {r['rank']}: {n} flash_prefill launches, expected "
              f"{cfg.num_layers} (one a layer)")
    check(cache_window(cfg, O1["capacity"]) == O1["capacity"], "(o1) ring")
    return [r["o"][name]["counts"] for r in r12
            for name in ("o1", "o1_twin")] \
        + [r["o"]["o2"]["counts"] for r in r22]


def dryrun_card_phase(dev) -> dict:
    """(o3) the dry run against the card on (l0)'s step: qwen2-1.5b whole
    in bf16, AdamW, B 8 x S 256, no remat, on one device. The flops of
    the step on meta equal ``FlopCounterMode`` on the card's step, and
    the dry run's peak above its arguments is within ``O3_MEM_TOL`` of
    the card's (``max_memory_allocated`` from a reset, less what was
    allocated before the step; one warm step first)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as DR
    from repro_torch.models.model import param_shapes
    from repro_torch.training import optimizer as O
    from repro_torch.training.data import synthetic_batches
    from repro_torch.training.train_loop import TrainConfig, build_train_step
    t0 = time.perf_counter()
    cfg = get_config("qwen2-1.5b")
    params, opt, state = train_setup(cfg, dev)
    step = build_train_step(cfg, opt, TrainConfig(remat=False))
    batches = synthetic_batches(cfg.vocab_size, TRAIN_B, TRAIN_S, seed=0)
    step(params, state, next(batches))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    step(params, state, next(batches))
    torch.cuda.synchronize()
    card_peak = torch.cuda.max_memory_allocated() - before
    batch = next(batches)
    with FlopCounterMode(display=False) as fc:
        step(params, state, batch)
    card_flops = fc.get_total_flops()
    del params, state, step
    free_device()
    mp = param_shapes(cfg)
    meta = (mp, O.opt_init(opt, mp), {
        k: torch.empty(v.shape, dtype=torch.from_numpy(v).dtype,
                       device="meta") for k, v in batch.items()})
    pred = DR.trace(build_train_step(cfg, opt, TrainConfig(remat=False)),
                    meta)
    mem = pred["memory"]
    above = mem["peak_memory_in_bytes"] - mem["argument_size_in_bytes"]
    rel = above / card_peak - 1
    log(f"[dryrun] (o3) {cfg.name} train step B {TRAIN_B} x S {TRAIN_S}, "
        f"bf16, AdamW: flops dry run {pred['flops']:.6e}, card "
        f"FlopCounterMode {card_flops:.6e}; peak above the arguments dry "
        f"run {above / 2 ** 30:.3f} GiB, card {card_peak / 2 ** 30:.3f} GiB "
        f"({rel:+.1%}); arguments "
        f"{mem['argument_size_in_bytes'] / 2 ** 30:.3f} GiB, dry-run peak "
        f"{mem['peak_memory_in_bytes'] / 2 ** 30:.3f} GiB;"
        f" the trace {pred['trace_s']:.1f} s; {card()}; "
        f"{time.perf_counter() - t0:.1f} s")
    check(pred["flops"] == card_flops,
          f"(o3) flops: dry run {pred['flops']} vs card {card_flops}")
    check(abs(rel) <= O3_MEM_TOL, f"(o3) peak: dry run {above} vs card "
          f"{card_peak} ({rel:+.1%})")
    return dict(flops=card_flops, card_peak=card_peak, dry_peak=above)


def start_host_dryrun():
    """(o4) the dry run of ``O4_CELLS`` on this host's CPU (meta tensors,
    nothing on the card), a process for each cell, started beside (l4)'s
    launcher processes, which time nothing but their whole run:
    (processes, their output directory)."""
    import tempfile
    out = tempfile.mkdtemp(prefix=".smoke_dryrun_", dir=ROOT)
    procs = []
    for a, sh, etp in O4_CELLS:
        argv = ["--arch", a, "--shape", sh, "--out", out,
                "--no-calibration"] + (["--expert-tp"] if etp else [])
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *argv],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs, out


def stop_host_dryrun(procs, out_dir) -> None:
    """The (o4) processes killed if they still run, their directory
    removed."""
    import shutil
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    shutil.rmtree(out_dir, ignore_errors=True)


def host_dryrun_phase(procs, out_dir) -> list:
    """(o4)'s result, the processes waited for: each cell ``ok``, with its
    seconds and peak GB a device."""
    from repro_torch.launch import dryrun as DR
    for proc in procs:
        text, _ = proc.communicate(timeout=600)
        check(proc.returncode == 0, f"(o4) dry run exited "
              f"{proc.returncode}: {text[-2000:]}")
    out = []
    for arch, shape, etp in O4_CELLS:
        with open(Path(out_dir) / f"{arch}_{shape}_pod256.json") as f:
            r = json.load(f)
        check(r["status"] == "ok", f"(o4) {arch} x {shape}: "
              f"{r.get('error')}")
        mem = r["memory_analysis"]
        log(f"[dryrun] (o4) {arch} x {shape} x pod256"
            f"{' expert_tp' if etp else ''}: {r['status']}, traced in "
            f"{r['trace_s']:.1f} s on the host (beside (l4)), peak "
            f"{mem['peak_memory_in_bytes'] / 1e9:.2f} GB a device (fits "
            f"80 GB: {r['fits']}), dominant {r['dominant']}, terms "
            f"compute {r['compute_term_s']:.3e} memory "
            f"{r['memory_term_s']:.3e} collective "
            f"{r['collective_term_s']:.3e} s ({DR.CARD})")
        out.append(r)
    return out


# ======================================================================
# (m) kernel autotune at qwen2-1.5b's live geometry
# ======================================================================
M_GEOMETRY = dict(B=8, Hq=12, Hkv=2, D=128, page=16, pps=40)
M_WIDTHS = (1, 2, 4, 8, 16)   # the engine's _q_bucket widths up to 16


def m_case(dev, g, Q):
    """The geometry's tables (pps 40, pages of 16) with an engine
    round's rows: rows 0-1 prefill Q tokens, the others decode one, the
    last pads; contexts up to 600 of the table's 640 keys."""
    G = M_GEOMETRY
    ctx = [600, 170, 411, 96, 250, 333, 128, 0]
    q, kp, vp, bt, qs, ql = kernel_case(dev, torch.bfloat16, G["B"], Q, ctx,
                                        g)
    pps = G["pps"]
    P = G["B"] * pps + 1
    kp = torch.randn(P, G["page"], G["Hkv"], G["D"], generator=g,
                     device=dev).to(torch.bfloat16)
    vp = torch.randn_like(kp)
    bt = torch.randperm(P - 1, generator=g, device=dev)[:G["B"] * pps] \
        .reshape(G["B"], pps).int()
    return q, kp, vp, bt, qs, ql


def autotune_round(cfg, params, dev, cache):
    """One mixed fused round of the engine's step at the geometry, with
    the cache enabled and without, on the same pages: (logits without,
    logits with, the cache's stats after the round)."""
    from repro_torch.kernels import autotune
    from repro_torch.serving.paged_engine import paged_fused_step
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    G = M_GEOMETRY
    B, page, pps, C = G["B"], G["page"], G["pps"], 256
    P = B * pps
    kp = torch.zeros((cfg.num_layers, P + 1, page, cfg.num_kv_heads,
                      cfg.resolved_head_dim), dtype=torch.bfloat16,
                     device=dev)
    vp = torch.zeros_like(kp)
    bt = torch.randperm(P, generator=g, device=dev).reshape(B, pps).int()
    ctx = torch.tensor([600, 256, 97, 150, 31, 222, 180, 0], device=dev)

    def tables(start, n, Q):
        t = torch.arange(Q, device=dev)
        pos = start[:, None] + t[None, :]
        live = t[None, :] < n[:, None]
        pg = torch.where(live, bt.long().gather(
            1, (pos // page).clamp(max=pps - 1)), P)
        sl = torch.where(live, pos % page, t[None, :] % page)
        return pos.int(), pg, sl
    # fill the contexts in chunks of 256, cache off
    done = torch.zeros_like(ctx)
    while bool((done < ctx).any()):
        n = (ctx - done).clamp(max=C)
        toks = torch.randint(0, cfg.vocab_size, (B, C), generator=g,
                             device=dev)
        pos, pg, sl = tables(done, n, C)
        paged_fused_step(cfg, params, toks, pos, kp, vp, bt, done.int(),
                         n.int(), pg, sl)
        done = done + n
    n = torch.tensor([16, 16, 1, 1, 1, 1, 1, 0], device=dev)
    pos, pg, sl = tables(ctx, n, 16)
    toks = torch.randint(0, cfg.vocab_size, (B, 16), generator=g, device=dev)
    args = (toks, pos, kp, vp, bt, ctx.int(), n.int(), pg, sl)
    k0, v0 = kp.clone(), vp.clone()
    without = paged_fused_step(cfg, params, *args)
    kp.copy_(k0), vp.copy_(v0)
    autotune.enable(str(cache))
    try:
        with_cache = paged_fused_step(cfg, params, *args)
        torch.cuda.synchronize()
        stats = autotune.stats()
    finally:
        autotune.disable()
    live = n > 0
    return without[live], with_cache[live], stats


def launcher_autotune_phase(cache) -> None:
    """(m) the launcher's ``--engine live --autotune`` at qwen2-1.5b's
    full width on two sessions (clock scale 4): every turn served, the
    cache consulted by every round."""
    import os
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--engine",
           "live", "--sessions", "2", "--clock-scale", "4", "--autotune",
           str(cache), "--json"]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env=dict(os.environ,
                                            PYTHONPATH=str(ROOT / "src")))
    check(out.returncode == 0, f"(m) {' '.join(cmd[1:])} exited "
          f"{out.returncode}: {out.stderr[-2000:]}")
    s = json.loads(out.stdout)
    stats = dict(kv.split("=") for kv in s["autotune"].split())
    log(f"[autotune] (m) {' '.join(cmd[3:])}: "
        f"{time.perf_counter() - t0:.1f} s; turns {s['turns']}, rounds "
        f"{s['rounds']}, p90_ttfp {s['p90_ttfp']}; cache {stats}")
    check(s["turns"] > 0 and int(stats["hits"]) > 0
          and int(stats["entries"]) > 0, f"(m) launcher: {s}")


def autotune_phase(dev) -> list:
    """(m) The paged pair's span swept at qwen2-1.5b's live
    geometry in bf16, the cache saved and reloaded, the picks checked,
    the engine's fused round and the launcher run with the cache, and
    the paged rows re-timed at the default knobs with the device-only
    timer. Returns the counts of the main paths it drives."""
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.kernels import autotune, ref
    from repro_torch.kernels.paged_attention import (
        paged_attention, paged_prefill_attention)
    from repro_torch.models.model import init_params
    t0 = time.perf_counter()
    consts = autotune.measure_constants(dev)
    log(f"[autotune] measured on this card: launch {consts['launch_us']} "
        f"us, HBM {consts['hbm_gb_s']} GB/s; the model's constants: launch "
        f"{autotune.C_LAUNCH_US} us, HBM {autotune.HBM_GB_S} GB/s, peaks "
        f"{ {str(k)[6:]: v for k, v in autotune.PEAK_TFLOPS.items()} } "
        f"TFLOP/s, {torch.cuda.get_device_properties(dev).multi_processor_count}"
        f" SMs")
    tmp = smoke_dir()
    cache = tmp / "autotune.json"
    autotune.enable(str(cache))
    rows = []
    t_sweep = time.perf_counter()
    autotune.sweep("paged_prefill_attention", **M_GEOMETRY, Q=16,
                   q_widths=M_WIDTHS, dtype=torch.bfloat16, device=dev,
                   reps=10, log=rows)
    t_sweep = time.perf_counter() - t_sweep
    for r in rows:
        log(f"[autotune] {r['kind']} Q={r['Q']} span={r['span']}: device "
            f"{r['us']} us, model {r['model_us']} us, max_abs_err "
            f"{r['max_abs_err']}")
        check(r["us"] is not None and r["max_abs_err"] <= TOL[torch.bfloat16],
              f"(m) candidate {r} failed against the plain version")
    entries = dict(autotune._STATE["cache"])
    for k, e in sorted(entries.items()):
        log(f"[autotune] pick {k}: {e}")
    autotune.save()
    autotune.disable()
    check(autotune.enable(str(cache)) == len(M_WIDTHS) + 1
          and autotune._STATE["cache"] == entries, "(m) reload")
    spans = {e["span"] for e in entries.values()}
    check(len(spans) == 1, f"(m) one span a geometry: {spans}")
    span = spans.pop()
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    q, kp, vp, bt, qs, ql = m_case(dev, g, 16)
    one = torch.ones_like(ql)
    q1, qd = q[:, :1].contiguous(), q[:, 0].contiguous()
    # under the cache (knobs unset): decode == fused at Q = 1, bitwise
    hits = autotune.stats()["hits"]
    d = paged_attention(qd, kp, vp, bt, qs + 1)
    f = paged_prefill_attention(q1, kp, vp, bt, qs, one)
    wide = paged_prefill_attention(q, kp, vp, bt, qs, ql)
    torch.cuda.synchronize()
    check(autotune.stats()["hits"] == hits + 3, "(m) the cache was not hit")
    autotune.disable()
    check(torch.equal(f[:, 0], d), f"(m) decode != fused Q=1 at span {span}")
    err = max_valid_err(wide, ref.paged_prefill_attention_ref(
        q, kp, vp, bt, qs, ql), ql)
    check(err <= TOL[torch.bfloat16], f"(m) span {span}: err {err}")
    # the picked span given explicitly: the cached call's bits
    check(torch.equal(paged_prefill_attention(q, kp, vp, bt, qs, ql,
                                              span=span), wide),
          "(m) the explicit span differs from the cached one")
    # both kernels at the picked span in f32 against the plain version
    q32, kp32, vp32 = q.float(), kp.float(), vp.float()
    d32 = paged_attention(qd.float(), kp32, vp32, bt, qs + 1, span=span)
    f32 = paged_prefill_attention(q32, kp32, vp32, bt, qs, ql, span=span)
    live = ql > 0
    err32 = max(
        (d32[live] - ref.paged_attention_ref(
            qd.float(), kp32, vp32, bt, qs + 1)[live]).abs().max().item(),
        max_valid_err(f32, ref.paged_prefill_attention_ref(
            q32, kp32, vp32, bt, qs, ql), ql))
    check(err32 <= TOL[torch.float32], f"(m) span {span} f32: err {err32}")
    log(f"[autotune] sweep {t_sweep:.1f} s, {len(rows)} candidates; picked "
        f"span {span}: decode == fused Q=1 bitwise, max_abs_err {err} vs "
        f"plain (tol {TOL[torch.bfloat16]}); f32 both kernels max_abs_err "
        f"{err32} (tol {TOL[torch.float32]})")
    # the engine's fused round with the cache and without
    cfg = get_config("qwen2-1.5b")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
    (without, with_cache, stats), counts = main_path(
        "autotune round (m)", autotune_round, cfg, params, dev, cache)
    err = (with_cache.float() - without.float()).abs().max().item()
    scale = without.float().abs().max().item()
    agree = (with_cache.argmax(-1) == without.argmax(-1)).float().mean() \
        .item()
    log(f"[autotune] fused round with the cache vs without: logits "
        f"max_abs_err {err:.3e} (scale {scale:.2f}, tol 3e-2 of scale), "
        f"argmax agreement {agree:.3f}; cache {stats}")
    check(torch.isfinite(with_cache).all().item() and err <= 3e-2 * scale
          and agree == 1.0 and stats["hits"] > 0,
          f"(m) round with the cache: {err}, {agree}, {stats}")
    del params
    free_device()
    launcher_autotune_phase(cache)
    shutil.rmtree(tmp, ignore_errors=True)
    # the paged rows at the default knobs, device-only timer
    timer = autotune.DeviceTimer(dev)
    ctx = [300, 170, 411, 96, 250, 333, 128, 0]
    q, kp, vp, bt, qs, ql = kernel_case(dev, torch.bfloat16, 8, 16, ctx, g)
    qd = q[:, 0].contiguous()
    for name, run in (
            ("paged_prefill_attention",
             lambda: paged_prefill_attention(q, kp, vp, bt, qs, ql)),
            ("paged_attention",
             lambda: paged_attention(qd, kp, vp, bt, qs + 1))):
        log(f"[autotune] {name} at the default span (the kernel rows' "
            f"shapes): device {timer(run, 20)} us (median of 20, L2 "
            f"flushed)")
    log(f"[autotune] phase (m): {time.perf_counter() - t0:.1f} s")
    return [counts]


def cast_params(tree, dtype, parent=None, key=None):
    """Every leaf to ``dtype`` (no copy where it already is), except the
    leaves that stay f32 at any type (the mixer's, the router, the
    RG-LRU's gates and decay)."""
    from repro_torch.models.model import keeps_f32
    if isinstance(tree, dict):
        return {k: cast_params(v, dtype, key, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast_params(v, dtype, parent, key) for v in tree]
    return tree if keeps_f32(parent, key) else tree.to(dtype)


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
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
    for tag, fn, args in (
            ("prefix plane (e1)", prefix_phase,
             (*first_layers(cfg, params, CUT_LAYERS), dev)),
            ("spec plane (e2)", spec_phase,
             (cfg, params, dev, eng["planes"]["fused"])),
            ("int8 wire tier (e3)", int8_phase, (cfg, params, dev))):
        _, counts = main_path(tag, fn, *args)
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
    _, counts = main_path("replay twin (f3)", replay_phase,
                          *first_layers(cfg, params, CUT_LAYERS), dev)
    add(counts, {"paged_prefill_attention": 0, "paged_attention": 0})
    log(f"[frontend] phase (f): {time.perf_counter() - t_f:.1f} s")
    # (g) the sharded page plane on the first CUT_LAYERS layers: its
    # paths ran in the ranks, each rank counting its own launches from
    # zero just before each path
    torch.cuda.empty_cache()
    cfg, params = first_layers(cfg, params, CUT_LAYERS)
    for tag, counts, (what, _) in sharded_phase(cfg, params, dev):
        log(f"[launches] {tag}: {counts}")
        add(counts, {"paged_attention": 0, "flash_prefill": 0}
            if what == "tokenwise" else {"paged_prefill_attention": 0})
    # (h) the replica fleet on the same layers, each part with its own
    # counts: every replica's fused rounds run the fused kernel
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
    # (h5) the fleet over a mesh on the same layers: the one-device twins
    # here, each mesh's paths in its ranks (their counts summed)
    t_h5 = time.perf_counter()
    for counts in mesh_fleet_phase(cfg, params, dev):
        add(counts, {"paged_prefill_attention": 0})
    launcher_mesh_fleet_phase()
    log(f"[fleet] phase (h5): {time.perf_counter() - t_h5:.1f} s")
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
    profile_prefill(mcfg, mparams, dev, prompts["s0"], 4096,
                    {"ssd_scan kernels": "ssd_"})
    del mparams
    free_device()
    # (i) the moe and vlm families: the kernels at head dim 256, then
    # each model's paths, each with its own counts
    t_i = time.perf_counter()
    family_kernels_phase(dev)
    paligemma_phase(dev, add)
    phi_phase(dev, add)
    launcher_family_phase()
    log(f"[family] phase (i): {time.perf_counter() - t_i:.1f} s")
    # (j) the hybrid and encdec families: the kernel at their shapes,
    # then each model's path with its own counts
    t_j = time.perf_counter()
    family_flash_phase(dev)
    hybrid_phase(dev, add)
    whisper_phase(dev, add)
    log(f"[family] phase (j): {time.perf_counter() - t_j:.1f} s")
    # (k) head dims 192 and 80, and the mla family: the kernels at those
    # dims, then each model's paths with their own counts; the rows of
    # each new dim take the launches of the paths that run at it
    t_k = time.perf_counter()
    dim_rows = head_dim_kernels_phase(dev)
    k1 = deepseek_phase(dev, add)
    k2 = nemotron_phase(dev, add)
    k3 = danube_phase(dev, add)
    qwen3_phase(dev, add)
    for name, n in (("flash_prefill, D 192", k1["flash_prefill"]),
                    ("paged_prefill_attention, D 192",
                     k2["paged_prefill_attention"]),
                    ("paged_attention, D 192", k2["paged_attention"]),
                    ("flash_prefill, D 80", k3["flash_prefill"])):
        check(n > 0, f"{name} never launched on a main path")
        dim_rows[name]["launches"] = n
    log(f"[family] phase (k): {time.perf_counter() - t_k:.1f} s")
    # (l) single-device training: no kernel is on its path
    t_l = time.perf_counter()
    training_phase(dev)
    log(f"[train] phase (l): {time.perf_counter() - t_l:.1f} s")
    # (n) training over a mesh: no kernel on its path either; each rank
    # zeroes and returns its own counts. (o1), (o2): serving over a mesh
    # in the same ranks, each part with its own counts: every rank's
    # prefill runs flash_prefill on its heads
    train_counts, serve_counts = mesh_train_phase(dev)
    for counts in train_counts:
        check(not any(counts.values()),
              f"training over a mesh: kernel launches {counts}, expected "
              "none")
    for counts in serve_counts:
        add(counts, {"flash_prefill": 0})
    # (o3) the dry run against the card (no kernel on the step)
    t_o = time.perf_counter()
    _, counts = main_path("dry run vs the card (o3)", dryrun_card_phase, dev)
    check(not any(counts.values()), f"(o3): kernel launches {counts}")
    log(f"[dryrun] phase (o3): {time.perf_counter() - t_o:.1f} s")
    # (m) kernel autotune: the engine's fused round with the cache
    for counts in autotune_phase(dev):
        add(counts, {"paged_prefill_attention": 0})
    for name, n in total.items():
        check(n > 0, f"{name} never launched on a main path")
        rows[name]["launches"] = n
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [rows[n] for n in SOURCES]
                      + list(dim_rows.values())}))
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
