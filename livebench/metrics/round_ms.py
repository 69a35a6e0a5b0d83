"""Paged engine (``serving/paged_engine.py::run_round``): host time in
``run_round`` a round over the window (launches, the device's work,
which each round waits for to copy its logits, and sampling). The
profiled slice is left out."""
from livebench.metrics._slice import untraced

UNIT = "ms"
MOVES = "ttfp_p50_ms"


def read(rec):
    rounds, _ = untraced(rec)
    if not rounds:
        return None
    return sum(r.t1 - r.t0 for r in rounds) / len(rounds) * 1e3
