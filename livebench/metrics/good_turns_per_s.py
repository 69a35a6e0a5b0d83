"""Front end, as users judge it: the window's turns that met both
limits (first audio within 2 s, no playback gap over 100 ms before the
window's end or the barge-in) over the window's seconds. Not an
end-to-end metric: where a round takes about one token's 80 ms of
audio, the gap limit flips on host speed alone (PERF.md)."""

UNIT = "turns/s"
MOVES = "ttfp_p90_ms"


def read(rec):
    e = rec["e2e"]
    return e["good_turns_per_s"] if e["attempted"] else None
