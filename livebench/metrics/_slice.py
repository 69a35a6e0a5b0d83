"""Shared by the readers of the profiled slice."""
from livebench.probe import START, TOKENS


def traced_rounds(rec):
    """The rounds that ran under the profiler, or [] when the run was
    not traced (or the slice did not finish)."""
    if rec.get("trace") is None:
        return []
    return [r for r in rec["tracer"].probe.rounds if r.traced]


def untraced(rec):
    """The window's rounds outside the profiled slice, and the seconds
    of the window outside it (the profiler slows the host there)."""
    w0, w1 = rec["window"]
    span = rec["tracer"].span if rec.get("tracer") is not None else None
    rounds = [r for r in rec["rounds"] if not r.traced]
    wall = w1 - w0
    if span is not None:
        wall -= max(0.0, min(span[1], w1) - max(span[0], w0))
    return rounds, wall


def rows(r):
    """(first position, tokens fed) of each row of round ``r``."""
    return [(row[START], len(row[TOKENS])) for row in r.rows]
