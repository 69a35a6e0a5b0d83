"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version at full-width qwen2-1.5b shapes,
then drives the port's main path — the paged multi-turn engine at full
width (28 layers, bf16, random weights from a seed) — on both planes,
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
REPLACES = {"paged_prefill_attention":
            "src/repro/kernels/paged_attention.py:283",
            "paged_attention": "src/repro/kernels/paged_attention.py:133"}


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
    has streamed ~80 MB of weights, so the kernel finds them cold)."""

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
        name = str(dtype).replace("torch.", "")
        log(f"[kernels] {name}: paged_prefill_attention max_abs_err {e_f} "
            f"paged_attention max_abs_err {e_d} (tol {TOL[dtype]}); "
            f"fused Q=1 == decode bitwise: {bitwise}")
        check(e_f <= TOL[dtype], f"paged_prefill_attention {name}: "
              f"err {e_f} > {TOL[dtype]}")
        check(e_d <= TOL[dtype], f"paged_attention {name}: "
              f"err {e_d} > {TOL[dtype]}")
        check(bitwise, f"{name}: fused kernel at Q=1 != decode kernel")
        if dtype != torch.bfloat16:
            continue
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
            rows[kname] = dict(name=kname, route="cuda", source=KERNEL_SRC,
                               replaces=REPLACES[kname], launches=0,
                               max_abs_err=err, ms=ms, plain_ms=plain_ms,
                               bound_ms=bound_ms, bound_by=bound_by,
                               library_ms=lib_ms)
            log(f"[kernels] {kname} bf16 B={B} Q={1 if dec else Q} "
                f"ctx={ctx}: {ms:.4f} ms (plain {plain_ms:.4f} ms, sdpa "
                f"{lib_ms:.4f} ms, bound {bound_ms:.5f} ms by {bound_by})")
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
    from repro_torch.serving.paged_engine import (PagedRealtimeEngine,
                                                  run_multiturn_demo)
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
    t0 = time.perf_counter()
    out = run_multiturn_demo(cfg, params, log=lambda *_a: None, **kw)
    secs = time.perf_counter() - t0
    pre = out["preload"]
    gen = {s: [t["generated"] for t in ts] for s, ts in out["turns"].items()}
    log(f"[engine] (a) demo in {secs:.1f} s: evictions "
        f"{out['offload_events']}, preload {pre}, generated {gen}")
    check(out["offload_events"] > 0, "demo evicted nothing")
    check(pre["sync_fallbacks"] >= 1, "demo took no sync reload")
    check(pre["admitted"] >= 1 and pre["hits"] >= 1,
          "demo had no preload admitted")
    check(gen == {"alice": [20, 4, 12], "bob": [52, 12]},
          f"demo turns generated {gen}")
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
    return dict(params=params, cfg=cfg, planes=planes)


def profile_rounds(cfg, params, dev) -> None:
    """Where a fused round's time goes: the same trace once more under
    ``torch.profiler`` (its overhead stays out of the timings above).
    Prints the device's busy share of the wall time and the kernels
    that took the most device time."""
    from torch.autograd import DeviceType
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
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us()
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
        p = _tree(params, lambda t: t.to(dtype))   # no copy in bf16
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


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree(v, fn) for v in tree]
    return fn(tree)


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
    from repro_torch.device import resolve_device
    from repro_torch.kernels.paged_attention import (
        paged_attention, paged_prefill_attention)
    dev = resolve_device("cuda")
    t_start = time.perf_counter()
    card_line = card()
    log(f"[card] {card_line}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    build_kernels()
    rows = kernels_phase(dev)
    # the main path: counts from zero just before, read just after
    paged_attention.launches = 0
    paged_prefill_attention.launches = 0
    eng = engine_phase(dev)
    counts = {"paged_attention": paged_attention.launches,
              "paged_prefill_attention": paged_prefill_attention.launches}
    log(f"[engine] kernel launches on the main path: {counts}")
    for name, n in counts.items():
        check(n > 0, f"{name} never launched on the main path")
        rows[name]["launches"] = n
    step_phase(dev, eng["cfg"], eng["params"])
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [rows["paged_prefill_attention"],
                                  rows["paged_attention"]]}))
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
