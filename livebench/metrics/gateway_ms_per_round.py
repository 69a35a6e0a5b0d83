"""Front end (``serving/gateway/gateway.py``, ``core/scheduler.py``):
the window's wall time outside ``run_round`` over its rounds: event
handling, the scheduler's decision, dispatch to clients and idle
waits. The profiled slice is left out."""
from livebench.metrics._slice import untraced

UNIT = "ms"
MOVES = "ttfp_p50_ms"


def read(rec):
    rounds, wall = untraced(rec)
    if not rounds:
        return None
    inside = sum(r.t1 - r.t0 for r in rounds)
    return (wall - inside) / len(rounds) * 1e3
