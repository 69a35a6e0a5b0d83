"""Device (H100): the share of the profiled slice's wall time in which
no kernel, copy or set ran on the device, from the profiler's
timeline."""
from livebench import trace

UNIT = "%"
MOVES = "ttfp_p50_ms"


def read(rec):
    tr = rec.get("trace")
    if tr is None:
        return None
    w = tr.window[1] - tr.window[0]
    busy = sum(b - a for a, b in trace.busy_intervals(tr))
    return 100.0 * (1.0 - busy / w) if w > 0 and busy > 0 else None
