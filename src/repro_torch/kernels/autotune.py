"""Kernel autotune for the paged pair (DESIGN.md §16).

The port of the reference's ``repro/kernels/autotune.py``. It sweeps
the tiling knob of the paged kernels per kernel shape, checks every
candidate against the plain version, gates the pick with a cost model
of the card, and caches the winner in a JSON store keyed by (kernel,
shape, backend). The wrappers in ``kernels/paged_attention.py`` take
the span a caller leaves unset from it, but only after ``enable(path)``
has loaded a cache into this module's process-global state. Disabled
(the default), a wrapper's lookup is one check and the kernels run their
defaults, so serving stays bit-exact unless a caller opts in.

Cache format (invalidation rules):
  {"__meta__": {"version": 1},
   "<kind>|<shape_key>|<backend>": {"span": int, "measured_us": float,
                                    "default_us": float,
                                    "model_us": float, "reps": int}}
A version bump discards the whole file at load; a shape not swept
misses and takes the default span (``ref.SPAN_KEYS``).

What differs from the reference, and why:

- The knob is the CUDA kernel's: ``span``, the keys one block walks
  (the counterpart of ``kv_block``, the keys one Pallas grid step
  takes). A short span puts more blocks on the SMs, a long one leaves
  the merge fewer partials to write and read.
- There is no ``head_block``. The Pallas knob bounds the VMEM of one
  grid step; each CUDA block already takes one KV head (grid.y), so a
  head block below Hkv would only cut the same blocks into more
  launches in series. A sweep on an H100 at qwen2-1.5b's live geometry
  bore that out (PERF.md, the sweep of phase (m)): one head a launch
  took 1.6-2.0 times the time of every head at every span and Q width,
  and was never picked.
- The backend component is ``"cpu"`` or ``"cuda:<device name>"``, so a
  cache tuned on one card misses on another.
- The shape key carries the dtype: bf16 runs the tile products on the
  tensor cores and f32 on the CUDA cores, so the best tiling differs.
- One span per engine geometry (B, Hq, Hkv, D, page, pps, dtype). The
  span sets the order of a row's sums, so spec decode's lossless verify
  (K > 0 against K = 0) and the decode kernel's bit-equality with the
  fused kernel at Q = 1 hold under a cache only if every Q width and
  both kinds use one span. ``sweep`` scores each span over all of a
  geometry's members (the decode kind and the fused kind at each width
  it is given: the engine's ``_q_bucket`` widths), writes one entry per
  member with that span, and drops the geometry's other entries; a
  fused call at a width not swept takes the geometry's span.
- The timer counts the device only (``DeviceTimer``): the stream is
  held with ``torch.cuda._sleep`` until the host has enqueued the whole
  call, so the events bracket the kernels alone; the median of ``reps``
  runs, each after a 64 MiB write that flushes the 50 MB L2 (the engine
  finds a layer's pages cold: its MLP has streamed the weights since).
  The reference timed the wall clock, whose pick was unsteady.
- The cost model is the card's: launches, waves of blocks over the SMs,
  K/V and partial bytes over the measured HBM rate, and flops at the
  data sheet's peak (``modeled_cost_us``).
"""
from __future__ import annotations

import functools
import json
import math
import os
import statistics
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

FORMAT_VERSION = 1
KINDS = ("paged_attention", "paged_prefill_attention")

# The cost model's constants. The launch cost and the HBM rate were
# measured by ``measure_constants`` (printed again by ``chip_smoke.py``
# phase (m)) on an NVIDIA H100 80GB HBM3 at a power limit of 700.00 W;
# the peaks are the H100 SXM data sheet's dense rates, and ``sweep``
# reads the SM count from the device (132 on that card).
C_LAUNCH_US = 3.80       # device time of one small launch, back to back
HBM_GB_S = 3018.0        # a 1 GiB device copy, bytes read + written
PEAK_TFLOPS = {torch.bfloat16: 989.0, torch.float32: 67.0}
H100_SMS = 132

_STATE: Dict[str, object] = {"path": None, "cache": {}, "hits": 0,
                             "misses": 0, "memo": {}}


# ------------------------------------------------------------------ keys
def shape_key(**dims) -> str:
    """Canonical shape key: sorted ``k=v`` pairs (a dtype by its name)."""
    return ",".join(f"{k}={_name(dims[k])}" for k in sorted(dims))


def _name(v) -> str:
    return str(v).replace("torch.", "") if isinstance(v, torch.dtype) \
        else str(v)


@functools.lru_cache(maxsize=None)
def _device_name(index: int) -> str:
    return torch.cuda.get_device_name(index)


def backend_of(device=None) -> str:
    """``"cpu"`` or ``"cuda:<device name>"``; ``None`` is the default
    device of this process (the card when there is one)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cpu":
        return "cpu"
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return f"{device.type}:{_device_name(index)}"


def cache_key(kind: str, skey: str, backend: Optional[str] = None) -> str:
    return "|".join((kind, skey, backend or backend_of()))


def _geometry(key: str) -> str:
    """A cache key without its kind and its Q: the engine geometry whose
    members share one span."""
    _, skey, backend = key.split("|")
    return "|".join((",".join(p for p in skey.split(",")
                              if not p.startswith("Q=")), backend))


# ----------------------------------------------------------------- state
def enable(path: str) -> int:
    """Load (or start) the cache at ``path``, turn lookups on and zero
    the hit and miss counts. A file that is missing starts an empty
    cache. Returns the number of tuned entries loaded."""
    _STATE.update(path=path, cache={}, hits=0, misses=0)
    if os.path.exists(path):
        with open(path) as f:
            raw = json.load(f)
        meta = raw.pop("__meta__", {})
        if meta.get("version") == FORMAT_VERSION:
            _STATE["cache"] = raw
    _STATE["memo"] = {}
    return len(_STATE["cache"])


def disable() -> None:
    _STATE["path"] = None
    _STATE["cache"] = {}
    _STATE["memo"] = {}


def enabled() -> bool:
    return _STATE["path"] is not None


def lookup(kind: str, skey: str, backend: Optional[str] = None
           ) -> Optional[dict]:
    """Tuned entry for (kind, shape, backend): None unless ``enable()``
    ran and the shape was swept."""
    if not enabled():
        return None
    ent = _STATE["cache"].get(cache_key(kind, skey, backend))
    if ent is None:
        _STATE["misses"] += 1
    else:
        _STATE["hits"] += 1
    return ent


def tiling(kind: str, B: int, Q: int, Hq: int, Hkv: int, D: int,
           page: int, pps: int, dtype: torch.dtype, device) -> Optional[int]:
    """The span of a wrapper call from the enabled cache, None where it
    has none: the call's own entry, else the span of its geometry (a
    fused width not swept). Memoised on the arguments, so a call costs a
    dict lookup; the hit and miss counts still count every call."""
    key = (kind, B, Q, Hq, Hkv, D, page, pps, dtype, device)
    memo = _STATE["memo"]
    if key not in memo:
        dims = dict(B=B, Hq=Hq, Hkv=Hkv, D=D, page=page, pps=pps,
                    dtype=dtype)
        if kind == "paged_prefill_attention":
            dims["Q"] = Q
        ck = cache_key(kind, shape_key(**dims), backend_of(device))
        ent = _STATE["cache"].get(ck)
        if ent is None:
            geo = _geometry(ck)
            ent = next((e for k, e in _STATE["cache"].items()
                        if _geometry(k) == geo), None)
        memo[key] = None if ent is None else ent["span"]
    got = memo[key]
    _STATE["hits" if got is not None else "misses"] += 1
    return got


def stats() -> dict:
    return {"entries": len(_STATE["cache"]), "hits": _STATE["hits"],
            "misses": _STATE["misses"]}


def save(path: Optional[str] = None) -> str:
    path = path or _STATE["path"]
    assert path, "autotune.save() needs enable(path) or an explicit path"
    out = {"__meta__": {"version": FORMAT_VERSION}}
    out.update(_STATE["cache"])
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path


# ------------------------------------------------------------- the model
def candidate_configs(page: int, pps: int) -> list:
    """The sweep space of one shape: spans of 16 to 512 keys and the
    whole row (the table's keys rounded up to 16), none longer than the
    whole row or ``ref.MAX_SPAN_KEYS``, plus the default span."""
    from repro_torch.kernels import ref
    whole = min(-(-page * pps // 16) * 16, ref.MAX_SPAN_KEYS)
    spans = {s for s in (16, 32, 64, 128, 256, 512) if s <= whole}
    return [{"span": s} for s in sorted(spans | {whole, ref.SPAN_KEYS})]


def modeled_cost_us(*, B: int, Hkv: int, D: int, page: int, pps: int,
                    Q: int = 1, G: int = 1, span: int,
                    dtype: torch.dtype = torch.bfloat16,
                    sms: int = H100_SMS, launch_us: float = C_LAUNCH_US,
                    hbm_gb_s: float = HBM_GB_S) -> float:
    """Device time (µs) of one call over a full table at a span:

    - two launches (split and merge), ``launch_us`` each;
    - waves of ``B * Hkv * nspan * ceil(G Q / 64)`` blocks over the SMs,
      a wave lasting one block's span: its K/V bytes at its SM's share
      of the memory rate, or its flops at its SM's share of the dtype's
      peak, whichever is longer;
    - the f32 partials the split writes and the merge reads, ``B Hkv
      nspan G Q (D + 2) 4 * 2`` bytes, over the memory rate.

    The waves carry the K/V bytes and the flops: a full grid's waves
    take their total over the card's rates, a grid smaller than the SMs
    the time of one span, which is the trade the span makes."""
    elt = torch.finfo(dtype).bits // 8
    keys = pps * page
    nspan = -(-keys // span)
    blocks = B * Hkv * nspan * -(-G * Q // 64)
    waves = -(-blocks // sms)
    span_keys = min(span, keys)
    bytes_s = hbm_gb_s * 1e3 / sms                      # bytes/µs an SM
    flops_s = PEAK_TFLOPS[dtype] * 1e6 / sms            # flops/µs an SM
    block_us = max(2 * span_keys * D * elt / bytes_s,
                   4 * min(G * Q, 64) * span_keys * D / flops_s)
    partials = B * Hkv * nspan * G * Q * (D + 2) * 4 * 2
    return 2 * launch_us + waves * block_us + partials / (hbm_gb_s * 1e3)


# ------------------------------------------------------------- the timers
class DeviceTimer:
    """Median device time (µs) of a call on the card, from CUDA events.

    Before each run the stream is held by ``torch.cuda._sleep`` for four
    times the host's enqueue time of the call (at least 200 µs), and a
    64 MiB write flushes the L2; the start event is reached only after
    both, when the host has enqueued the whole call, so the events
    bracket the device's work alone, launch gaps included."""

    def __init__(self, device):
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1000)
        a.record()
        torch.cuda._sleep(1_000_000)
        b.record()
        b.synchronize()
        self.cycles_per_us = 1_000_000 / (a.elapsed_time(b) * 1e3)

    def __call__(self, run: Callable, reps: int = 10) -> float:
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        host_us = (time.perf_counter() - t0) * 1e6
        torch.cuda.synchronize()
        hold = int(max(4 * host_us, 200.0) * self.cycles_per_us)
        events = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(hold)
            self.flush.zero_()
            a.record()
            run()
            b.record()
            events.append((a, b))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) * 1e3 for a, b in events)


def host_timer(run: Callable, reps: int = 10) -> float:
    """Median wall time (µs) of a call on the CPU."""
    run()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls) * 1e6


def measure_constants(device, reps: int = 20) -> dict:
    """The cost model's measured constants on this card: ``launch_us``,
    the device time of one launch of the paged kernels at the smallest
    shape (one block each for split and merge) run back to back, and
    ``hbm_gb_s``, a 1 GiB device-to-device copy's bytes read and written
    over its time."""
    from repro_torch.kernels.paged_attention import paged_attention
    timer = DeviceTimer(device)
    one = torch.ones((1, 1, 32), device=device)
    pages = torch.ones((2, 16, 1, 32), device=device)
    bt = torch.zeros((1, 1), dtype=torch.int32, device=device)
    sl = torch.ones((1,), dtype=torch.int32, device=device)
    calls = 100

    def run():
        for _ in range(calls):
            paged_attention(one, pages, pages, bt, sl)
    launch_us = timer(run, reps) / (2 * calls)
    src = torch.empty(1 << 30, dtype=torch.uint8, device=device)
    dst = torch.empty_like(src)
    copy_us = timer(lambda: dst.copy_(src), reps)
    return {"launch_us": launch_us, "hbm_gb_s": 2 * src.numel() / copy_us
            / 1e3}


# ------------------------------------------------------------- the sweep
def _sweep_inputs(kind, Q, *, B, Hq, Hkv, D, page, pps, dtype, device,
                  seed):
    """Seeded inputs of one member over a full table, every row
    attending over ``page * pps - 3`` keys (numpy, so that the CPU and
    the card see the same values)."""
    rng = np.random.default_rng(seed)
    num_pages = B * pps + 1

    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device=device, dtype=dtype)
    k_pages = t((num_pages, page, Hkv, D))
    v_pages = t((num_pages, page, Hkv, D))
    bt = torch.from_numpy(rng.permutation(B * pps).reshape(B, pps)
                          .astype(np.int32)).to(device)
    seq = torch.full((B,), page * pps - 3, dtype=torch.int32, device=device)
    if kind == "paged_attention":
        return (t((B, Hq, D)), k_pages, v_pages, bt, seq)
    q_lens = torch.full((B,), Q, dtype=torch.int32, device=device)
    return (t((B, Q, Hq, D)), k_pages, v_pages, bt, seq - q_lens, q_lens)


def sweep(kind: str, *, B: int, Hq: int, Hkv: int, D: int, page: int,
          pps: int, Q: int = 1, q_widths=None,
          dtype: torch.dtype = torch.float32, device="cpu", reps: int = 10,
          seed: int = 0, gate_ratio: float = 4.0,
          timer: Optional[Callable] = None,
          log: Optional[list] = None) -> dict:
    """Sweep one engine geometry; store its entries and return the entry
    of (``kind``, ``Q``).

    The members are the decode kind and the fused kind at each width of
    ``q_widths`` (default ``(Q,)``). Every span of every member is run
    against the plain version on the same inputs (2e-5 in f32, 2e-2 in
    bf16) and then timed: ``timer(cfg, run, reps)`` (µs), where ``cfg``
    holds the member's ``kind`` and ``Q`` and the candidate's ``span``;
    the default times the device with ``DeviceTimer`` on the card and
    the plain version's wall on the CPU. A span that fails the check at
    any member is never picked, nor one the model prices worse than
    ``gate_ratio`` times the default at any member, however it times. A
    span's score is the sum of its times over the members; the lowest
    score wins, and the default is kept on a tie. ``log`` collects one
    dict per candidate."""
    from repro_torch.kernels import paged_attention as pk
    from repro_torch.kernels import ref
    assert kind in KINDS, kind
    widths = tuple(q_widths) if q_widths is not None else (Q,)
    assert kind == "paged_attention" or Q in widths, (Q, widths)
    device = torch.device(device)
    fns = {"paged_attention": pk.paged_attention,
           "paged_prefill_attention": pk.paged_prefill_attention}
    plain = {"paged_attention": ref.paged_attention_ref,
             "paged_prefill_attention": ref.paged_prefill_attention_ref}
    tol = {torch.float32: 2e-5, torch.bfloat16: 2e-2}[dtype]
    if timer is None:
        time_fn = DeviceTimer(device) if device.type == "cuda" \
            else host_timer
        timer = lambda cfg, run, n: time_fn(run, n)        # noqa: E731
    sms = torch.cuda.get_device_properties(device).multi_processor_count \
        if device.type == "cuda" else H100_SMS
    G = Hq // Hkv
    geo = dict(B=B, Hq=Hq, Hkv=Hkv, D=D, page=page, pps=pps, dtype=dtype)
    members = [("paged_attention", 1)] + \
        [("paged_prefill_attention", q) for q in widths]
    default = ref.SPAN_KEYS
    spans = [c["span"] for c in candidate_configs(page, pps)]
    us, model = {}, {}
    for m in members:
        args = _sweep_inputs(*m, **geo, device=device, seed=seed)
        want = plain[m[0]](*args)
        for span in spans:
            run = functools.partial(fns[m[0]], *args, span=span)
            err = (run().float() - want.float()).abs().max().item()
            cost = modeled_cost_us(B=B, Hkv=Hkv, D=D, page=page, pps=pps,
                                   Q=m[1], G=G, span=span, dtype=dtype,
                                   sms=sms)
            model[m, span] = cost
            ok = math.isfinite(err) and err <= tol
            cfg = {"kind": m[0], "Q": m[1], "span": span}
            us[m, span] = timer(cfg, run, reps) if ok else None
            if log is not None:
                log.append(dict(cfg, us=us[m, span], model_us=cost,
                                max_abs_err=err))
    assert all(us[m, default] is not None for m in members), \
        "the default span failed its check against the plain version"

    def score(span):
        """The span's summed time, None if it is ineligible at a member."""
        if any(us[m, span] is None or (
                span != default
                and model[m, span] > gate_ratio * model[m, default])
               for m in members):
            return None
        return sum(us[m, span] for m in members)

    best_span, best_score = default, score(default)
    for span in spans:
        sc = score(span)
        if sc is not None and sc < best_score:
            best_span, best_score = span, sc
    entries = {}
    for m in members:
        dims = dict(geo, Q=m[1]) if m[0] == "paged_prefill_attention" \
            else geo
        entries[cache_key(m[0], shape_key(**dims), backend_of(device))] = {
            "span": best_span, "measured_us": round(us[m, best_span], 3),
            "default_us": round(us[m, default], 3),
            "model_us": round(model[m, best_span], 3), "reps": reps}
    geos = {_geometry(k) for k in entries}
    cache = {k: e for k, e in _STATE["cache"].items()
             if _geometry(k) not in geos}
    cache.update(entries)
    _STATE["cache"] = cache
    _STATE["memo"] = {}
    dims = dict(geo, Q=Q) if kind == "paged_prefill_attention" else geo
    return entries[cache_key(kind, shape_key(**dims), backend_of(device))]
