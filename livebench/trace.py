"""The traced run's profiler slice and what is read from it.

A fixed number of rounds, as the window closes, runs under ``torch.profiler``
with the CUDA activity alone: the kernels, copies and sets on the
device, and the CUDA runtime calls that launched them, from CUPTI.
Tracing every host operator as well slowed a 36-layer round several
times over, so the host's side comes from the benchmark's own spans
(``livebench/probe.py``, on the host's monotonic clock), placed on the
trace's clock by calibration: a few ``cudaStreamQuery`` calls, each
between two readings of the host clock, at both ends of the slice.

Read from the raw kineto events (not the profiler's own aggregation,
which is slow on long traces):

- ``busy_s``: the union of everything on the device inside the slice,
  and ``window_s`` the slice's length;
- the device time of named kernels, and of the kernels launched while
  the host was inside given spans (a launch's CUDA correlation id names
  its kernel);
- the device's idle gaps, each named by what the host was doing at its
  midpoint: launching the step, the rest of the round, or the gateway.
"""
from __future__ import annotations

import bisect
import statistics
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

CAL_CALLS = 3


@dataclass
class Ev:
    name: str
    t0: float           # seconds on the trace's clock
    t1: float
    corr: int


@dataclass
class Trace:
    window: Tuple[float, float] = (0.0, 0.0)
    device: List[Ev] = field(default_factory=list)
    runtime: List[Ev] = field(default_factory=list)
    offset: float = 0.0     # trace clock minus host clock, seconds
    phases: List[Tuple[float, float, str]] = field(default_factory=list)


def calibrate() -> List[Tuple[float, float]]:
    """Host readings around ``CAL_CALLS`` runtime calls."""
    import torch
    s = torch.cuda.current_stream()
    out = []
    for _ in range(CAL_CALLS):
        a = time.perf_counter()
        s.query()
        out.append((a, time.perf_counter()))
    return out


def _sec(e, ns, us):
    if hasattr(e, ns):
        return getattr(e, ns)() * 1e-9
    return getattr(e, us)() * 1e-6


def read(prof, cal: List[Tuple[float, float]], span: Tuple[float, float],
         phases: List[Tuple[float, float, str]]) -> Trace:
    """The slice from a stopped profiler. ``cal``: the host readings of
    both calibrations, in order; ``span`` and ``phases`` on the host
    clock."""
    from torch.autograd import DeviceType
    tr = Trace()
    for e in prof.profiler.kineto_results.events():
        t0 = _sec(e, "start_ns", "start_us")
        t1 = t0 + _sec(e, "duration_ns", "duration_us")
        ev = Ev(e.name(), t0, t1, int(e.correlation_id() or 0))
        if e.device_type() == DeviceType.CUDA:
            tr.device.append(ev)
        elif ev.name.startswith(("cuda", "cu")):
            tr.runtime.append(ev)
    tr.device.sort(key=lambda x: x.t0)
    tr.runtime.sort(key=lambda x: x.t0)
    queries = [e for e in tr.runtime if "StreamQuery" in e.name]
    pairs = list(zip(queries[:CAL_CALLS], cal[:CAL_CALLS])) \
        + list(zip(queries[-CAL_CALLS:], cal[-CAL_CALLS:]))
    if len(queries) >= 2 * CAL_CALLS:
        tr.offset = statistics.median(
            e.t0 - 0.5 * (a + b) for e, (a, b) in pairs)
    else:
        raise RuntimeError(f"trace calibration: {len(queries)} stream "
                           f"queries in the trace, {2 * CAL_CALLS} made")
    tr.window = (span[0] + tr.offset, span[1] + tr.offset)
    tr.phases = sorted((a + tr.offset, b + tr.offset, n)
                       for a, b, n in phases)
    return tr


def busy_intervals(tr: Trace) -> List[Tuple[float, float]]:
    w0, w1 = tr.window
    out: List[Tuple[float, float]] = []
    for e in tr.device:
        a, b = max(e.t0, w0), min(e.t1, w1)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def device_seconds(tr: Trace, patterns) -> float:
    w0, w1 = tr.window
    return sum(e.t1 - e.t0 for e in tr.device
               if w0 <= e.t0 <= w1 and any(p in e.name for p in patterns))


def spans_device_seconds(tr: Trace, spans) -> float:
    """Device time of the kernels and copies launched while the host was
    inside one of ``spans`` (host clock)."""
    spans = sorted((a + tr.offset, b + tr.offset) for a, b in spans)
    starts = [a for a, _ in spans]
    ids = set()
    for la in tr.runtime:
        i = bisect.bisect_right(starts, la.t0) - 1
        if i >= 0 and la.t0 <= spans[i][1] and la.corr:
            ids.add(la.corr)
    return sum(e.t1 - e.t0 for e in tr.device if e.corr in ids)


def top_ops(tr: Trace, n: int = 10) -> List[list]:
    by: Dict[str, float] = {}
    w0, w1 = tr.window
    for e in tr.device:
        a, b = max(e.t0, w0), min(e.t1, w1)
        if b > a:
            by[e.name] = by.get(e.name, 0.0) + (b - a)
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
            [:n]]


def idle_gaps(tr: Trace, n: int = 10) -> List[list]:
    """Device idle seconds inside the slice, summed by what the host was
    doing at each gap's midpoint (the innermost phase; ``gateway``
    outside every round)."""
    busy = busy_intervals(tr)
    w0, w1 = tr.window
    gaps, prev = [], w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    by: Dict[str, float] = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        inner = [p for p in tr.phases if p[0] <= mid <= p[1]]
        label = min(inner, key=lambda p: p[1] - p[0])[2] \
            if inner else "gateway"
        by[label] = by.get(label, 0.0) + (b - a)
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
            [:n]]
