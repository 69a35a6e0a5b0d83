"""One run of one cell: build, warm, ramp, measure, drain, check.

The system under test is ``repro_torch``'s live gateway
(``serving.gateway.RealtimeGateway``) over its paged engine
(``serving.paged_engine.PagedRealtimeEngine``) on the fused plane, at
clock scale 1: wall time is what users hear. In order, a run

1. makes the cell's weights on the device from the seed;
2. builds the gateway (``gateway.harness.build_gateway``, which warms
   the fused step at every query bucket up to the prefill chunk: the
   shapes this traffic uses);
3. starts the closed population (``livebench/traffic.py``) and waits
   until every conversation has sent its first turn (the ramp);
4. measures for ``seconds``; a turn belongs to the window if its
   request was due inside it;
5. drains until every window turn has its first audio or the TTFP limit
   has passed since the window closed, then stops the gateway;
6. reads the device's peak memory, frees the program's state and runs
   the comparison that decides ``correct`` (``livebench/check.py``).

With ``trace`` the run reports the cell's per-layer metrics instead of
its end-to-end ones, and a fixed slice of rounds runs under the
profiler as the window closes, under the same load (started inside the
window, the profiler's own stop, ~2 s, stalled the rounds after it and
queued the turns behind them).
"""
from __future__ import annotations

import asyncio
import gc
import json
import math
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from livebench import check, manifest, stats, trace as trace_mod, weights
from livebench.probe import PREFILL, TOKENS, Probe
from livebench.traffic import Population

TRACE_ROUNDS = 24            # rounds in the profiled slice
TRACE_WAIT_S = 30.0          # the longest the slice may hold the drain


def port_config(model: dict):
    from repro_torch.configs.registry import MoEConfig, ModelConfig
    kw = dict(model)
    if kw.get("moe"):
        kw["moe"] = MoEConfig(**kw["moe"])
    return ModelConfig(**kw)


class Tracer:
    """Runs ``TRACE_ROUNDS`` rounds under the profiler (CUDA activity
    alone; ``livebench/trace.py``) once the first round after
    ``start_at`` (host clock, the window's end) has ended. Without a card the rounds are
    only marked, and no device metric is read."""

    def __init__(self, probe: Probe, start_at: float, moe_mod=None,
                 cfg=None, cuda: bool = True):
        self.probe, self.start_at, self.cuda = probe, start_at, cuda
        self.moe_mod, self.cfg = moe_mod, cfg
        self.state = "wait"
        self.n = 0
        self.prof = None
        self.cal: list = []
        self.span = None            # host (start, end) of the slice
        self.stop_s = 0.0
        self.launches0 = self.launches1 = 0

    def _launches(self) -> int:
        from repro_torch.kernels import paged_attention as pa
        return pa.paged_prefill_attention.launches

    def __call__(self, r) -> None:
        if self.state == "wait" and r.t1 >= self.start_at:
            t0 = time.perf_counter()
            if self.cuda:
                from torch.profiler import ProfilerActivity, profile
                torch.cuda.synchronize()
                self.prof = profile(activities=[ProfilerActivity.CUDA])
                self.prof.start()
                self.cal = trace_mod.calibrate()
            if self.moe_mod is not None:
                self.probe.wrap_moe(self.moe_mod, self.cfg)
            self.probe.tracing = True
            self.launches0 = self._launches()
            self.state, self.t0 = "on", t0
        elif self.state == "on" and r.traced:
            self.n += 1
            if self.n >= TRACE_ROUNDS:
                self.probe.tracing = False
                self.probe.unwrap_moe()
                self.launches1 = self._launches()
                t = time.perf_counter()
                if self.cuda:
                    torch.cuda.synchronize()
                    self.cal += trace_mod.calibrate()
                    self.prof.stop()
                self.stop_s = time.perf_counter() - t
                self.span = (self.t0, time.perf_counter())
                self.state = "done"

    def read(self):
        """The slice's trace, or None without a card."""
        if self.prof is None:
            return None
        rs = [r for r in self.probe.rounds if r.traced]
        phases = [(r.t0, r.t1, "round_host") for r in rs]
        phases += [(a, b, "moe_call") for r in rs for a, b in r.moe]
        return trace_mod.read(self.prof, self.cal,
                              (rs[0].t0, rs[-1].t1), phases)


async def _drive(gw, pop: Population, seconds: float, on_window,
                 busy=lambda: False) -> tuple:
    """Ramp, window and drain; returns (window start, window end, end
    of drain) on the host clock. The drain also lasts while ``busy()``
    (the profiled slice, which starts as the window closes), for at
    most ``TRACE_WAIT_S``."""
    gw.clock.restart()
    serve = asyncio.create_task(gw.run())
    load = asyncio.create_task(pop.run())

    def alive():
        for t, what in ((serve, "gateway serve loop"),
                        (load, "traffic")):
            if t.done():
                t.result()
                raise RuntimeError(f"the {what} ended early")
    try:
        while len(pop.first_sent) < pop.n:
            alive()
            await asyncio.sleep(0.02)
        w0 = time.perf_counter()
        on_window(w0)
        while time.perf_counter() < w0 + seconds:
            alive()
            await asyncio.sleep(0.02)
        w1 = w0 + seconds
        on_window(w1)
        while time.perf_counter() < w1 + stats.TTFP_LIMIT_S:
            alive()
            if all(t.first is not None
                   for t in stats.window_turns(pop.turns, w0, w1)):
                break
            await asyncio.sleep(0.02)
        while busy() and time.perf_counter() < w1 + TRACE_WAIT_S:
            alive()
            await asyncio.sleep(0.02)
        end = time.perf_counter()
    finally:
        serve.cancel()
        load.cancel()
        res = await asyncio.gather(serve, load, return_exceptions=True)
    for r in res:
        if isinstance(r, BaseException) and \
                not isinstance(r, asyncio.CancelledError):
            raise r
    return w0, w1, end


class GcClock:
    """Time the interpreter spends in its garbage collector (a host
    pause every round behind it waits for), from ``gc.callbacks``."""

    def __init__(self):
        self.total = self.worst = 0.0
        self.n = 0
        self._t = 0.0
        gc.callbacks.append(self)

    def __call__(self, phase, info) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        else:
            dt = time.perf_counter() - self._t
            self.total += dt
            self.worst = max(self.worst, dt)
            self.n += 1

    def close(self) -> None:
        gc.callbacks.remove(self)


def _dump(path: str, pop, probe, w0: float, w1: float) -> None:
    """Per-turn and per-round records of the run, for the knee sweep,
    and a census of the objects the garbage collector tracks."""
    from collections import Counter
    turns = [{"due": t.due - w0, "ttfp": stats.ttfp_s(t),
              "gap": stats.max_gap_s(t, w1), "n": len(t.recv),
              "max_new": t.max_new, "barged": t.barge_at is not None,
              "prompt": len(t.prompt)} for t in pop.turns]
    rounds = [{"t0": r.t0 - w0, "ms": (r.t1 - r.t0) * 1e3,
               "pages": r.pages,
               "rows": len(r.rows),
               "tokens": sum(len(x[TOKENS]) for x in r.rows),
               "prefill": sum(x[PREFILL] for x in r.rows)}
              for r in probe.rounds]
    with open(path, "w") as f:
        json.dump({"turns": turns, "rounds": rounds,
                   "window": [0.0, w1 - w0],
                   "gc_tracked": Counter(
                       type(o).__name__ for o in gc.get_objects())
                   .most_common(12)}, f, default=float)


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_start: Optional[float] = None,
             bench: Optional[dict] = None, mix_override: Optional[dict] = None,
             control: bool = False, log: Callable = print,
             faults: Optional[Callable] = None,
             dump: Optional[str] = None) -> dict:
    """Run ``cell_name`` once; returns the result line's object (with
    the numbers compared under ``checks``). ``faults``, for the tests,
    is called with the built gateway to break its timed path."""
    from repro_torch.serving.gateway.harness import build_gateway
    t_start = time.perf_counter() if t_start is None else t_start
    b = bench or manifest.bench()
    cell = manifest.cell(b, cell_name)
    conf = manifest.config(cell["config"])
    mix = manifest.traffic(cell["traffic"])
    if mix_override:
        mix = {**mix, **mix_override,
               "gateway": {**mix["gateway"],
                           **mix_override.get("gateway", {})}}
    lim = manifest.limits(cell_name)
    model = conf["model"]
    g = mix["gateway"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    W = weights.make(model, seed, dev,
                     conf.get("weights", {}).get("embed_std", 1.0))
    cfg = port_config(model)
    gw = build_gateway(
        policy=g.get("policy", "liveserve"), scale=1.0, slots=g["slots"],
        page_size=g["page_size"], pages_per_seq=g["pages_per_seq"],
        num_pages=g["num_pages"], audio_per_token_s=mix["audio_per_token_s"],
        round_token_budget=g["round_token_budget"],
        prefill_chunk=g["prefill_chunk"],
        frontier_cap_s=g.get("frontier_cap_s"), model=(cfg, W),
        device=dev, seed=seed)
    eng = gw.engine
    if faults is not None:
        faults(gw)
    if cuda:
        torch.cuda.synchronize()
    max_context = g["pages_per_seq"] * g["page_size"]
    pop = Population(gw, mix, model["vocab_size"], seed, max_context)
    probe = Probe(eng, pop)
    tracer = None
    marks: Dict[str, dict] = {}
    if trace:
        moe_mod = None
        if model.get("moe"):
            from repro_torch.models import moe as moe_mod
        tracer = Tracer(probe, math.inf, moe_mod, cfg, cuda)
        probe.on_round = tracer

    def on_window(t):
        key = "w0" if "w0" not in marks else "w1"
        marks[key] = {"evicted": eng.kv.evicted_blocks, "t": t}
        if tracer is not None and key == "w1":
            tracer.start_at = t

    gc_clock = GcClock()
    w0, w1, t_end = asyncio.run(_drive(
        gw, pop, seconds, on_window,
        busy=lambda: tracer is not None and tracer.state != "done"))
    gc_clock.close()
    setup_s = w0 - t_start
    log(f"[run] garbage collection: {gc_clock.n} passes, "
        f"{gc_clock.total:.3f} s in all, the longest {gc_clock.worst * 1e3:.1f}"
        f" ms (ramp, window and drain)")
    log(f"[run] {cell_name} seed {seed}: setup {setup_s:.2f} s, window "
        f"{w1 - w0:.1f} s, drain {t_end - w1:.2f} s, rounds "
        f"{len(probe.rounds)}, conversations begun {pop.started}, client "
        f"lateness worst {pop.late_s * 1e3:.1f} ms, the probe's own time "
        f"{probe.cost_s * 1e3 / max(1, len(probe.rounds)):.3f} ms a round")
    if cuda:
        torch.cuda.synchronize()
        peak = int(torch.cuda.max_memory_allocated(dev))
    else:
        peak = 0
    e2e = stats.end_to_end(pop.turns, w0, w1, t_end)
    rec = {"model": model, "mix": mix, "window": (w0, w1),
           "turns": stats.window_turns(pop.turns, w0, w1),
           "rounds": [r for r in probe.rounds if w0 <= r.t0 and r.t1 <= w1],
           "e2e": e2e, "tracer": tracer, "trace": None,
           "moe_calls": probe.moe_calls}
    if tracer is not None and tracer.state == "done":
        rec["trace"] = tracer.read()
        rs = [r for r in probe.rounds if r.traced]
        log(f"[trace] {tracer.n} rounds profiled "
            f"({np.mean([r.t1 - r.t0 for r in rs]) * 1e3:.1f} ms each in "
            f"run_round; the window's rounds "
            f"{np.mean([r.t1 - r.t0 for r in rec['rounds'] if not r.traced] or [0]) * 1e3:.1f}"
            f"); the profiler's stop took {tracer.stop_s:.2f} s")
        if rec["trace"] is not None:
            tr = rec["trace"]
            log(f"[trace] {len(tr.device)} device events, "
                f"{len(tr.runtime)} runtime calls, clock offset "
                f"{tr.offset:.6f} s")
    elif tracer is not None:
        log(f"[trace] the profiled slice did not end within "
            f"{TRACE_WAIT_S:.0f} s of the window: the device metrics are "
            "not measured")
    metrics, device_extra, breakdown = {}, {}, None
    if trace:
        for m in manifest.per_layer_of(b, cell_name):
            v = manifest.metric(m["name"]).read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        tr = rec["trace"]
        if tr is not None:
            busy = sum(b_ - a for a, b_ in trace_mod.busy_intervals(tr))
            device_extra = {"busy_s": busy,
                            "window_s": tr.window[1] - tr.window[0]}
            breakdown = {"device_ops": trace_mod.top_ops(tr),
                         "idle_gaps": trace_mod.idle_gaps(tr)}
    else:
        for m in manifest.end_to_end_of(b, cell_name):
            v = setup_s if m["name"] == "setup_s" else e2e.get(m["name"])
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    log(f"[run] window: {e2e['attempted']} turns, {e2e['failed']} without "
        f"first audio, good {e2e['good_share']:.3f}, TTFP P50 "
        f"{e2e['ttfp_p50_ms']:.1f} ms P90 {e2e['ttfp_p90_ms']:.1f} ms, "
        f"good turns/s {e2e['good_turns_per_s']:.3f}; pool pages in use at "
        f"most {max((r.pages for r in probe.rounds), default=0)} of "
        f"{g['num_pages']}, evicted in the window "
        f"{marks['w1']['evicted'] - marks['w0']['evicted']}, in the run "
        f"{eng.kv.evicted_blocks}")

    if dump:
        _dump(dump, pop, probe, w0, w1)
    # free the program's state before the reference runs
    probe.restore()
    turns = pop.turns
    del gw, eng, pop, rec, tracer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    nums = check.run(
        model, W, probe, turns, (w0, w1), seed,
        k=int(lim.get("sessions", 8)), control=control, log=log,
        dump=dump)
    checks = {name: (nums[name], limit)
              for name, limit in lim["compare"].items()}
    checks.update({
        "fed_mismatch": (nums["fed_mismatch"], 0),
        "position_gaps": (nums["position_gaps"], 0),
        "delivered_mismatch": (nums["delivered_mismatch"], 0),
    })
    correct = all(v <= l for v, l in checks.values())
    info = {k: v for k, v in nums.items() if k not in checks}
    log(f"[check] {json.dumps(info)}")
    out = {"correct": bool(correct), "attempted": e2e["attempted"],
           "failed": e2e["failed"], "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": torch.cuda.get_device_name(dev) if cuda
                      else "cpu", "count": 1, "memory_peak_bytes": peak,
                      **device_extra}}
    if breakdown is not None:
        out["breakdown"] = breakdown
    # a number that could not be read is inf, printed as a string
    out["checks"] = {k: {"value": v if math.isfinite(v) else str(v),
                         "limit": l} for k, (v, l) in checks.items()}
    out["_info"] = info
    return out
