"""Moe layer (``models/moe.py``): the least time of the routed expert
work of each moe call in the profiled slice (``bounds.moe_least_s``: the
weights of the experts that received tokens, read once, and the kept
(token, expert) pairs' FLOPs, from the call's own routing and the
capacity of its real tokens) over the device time of the kernels
launched while the host was inside the call (the benchmark's span
around it)."""
import math

import torch

from livebench import bounds, trace
from livebench.metrics._slice import traced_rounds

UNIT = "%"
MOVES = "ttfp_p50_ms"


def read(rec):
    tr = rec.get("trace")
    m = rec["model"].get("moe")
    calls = rec.get("moe_calls") or []
    if tr is None or not m or not calls:
        return None
    spans = [s for r in traced_rounds(rec) for s in r.moe]
    dev_s = trace.spans_device_seconds(tr, spans) if spans else 0.0
    if not dev_s:
        return None
    E, k, cf = m["num_experts"], m["top_k"], m["capacity_factor"]
    least = 0.0
    for sel, valid in calls:
        if valid is not None:
            sel = sel[valid]
        T = int(sel.shape[0])
        if not T:
            continue
        counts = torch.bincount(sel.reshape(-1), minlength=E).cpu()
        c = int(math.ceil(T * k / E * cf))
        cap = max(4, -(-c // 4) * 4)
        kept = int(counts.clamp(max=cap).sum())
        hit = int((counts > 0).sum())
        least += bounds.moe_least_s(rec["model"], T, kept, hit)
    return 100.0 * least / dev_s
