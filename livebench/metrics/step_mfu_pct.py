"""Model step (``models/model.py``, the fused step): the useful model
FLOPs of the tokens fed in the profiled slice (``bounds.rows_flops``:
2 x the matrix parameters each token touches, QK^T and PV over its
keys, the head once a row; padding not counted) over the slice's time
in ``run_round`` at the H100's dense bf16 peak."""
from livebench import bounds
from livebench.metrics._slice import rows, traced_rounds

UNIT = "%"
MOVES = "ttfp_p50_ms"


def read(rec):
    rs = traced_rounds(rec)
    t = sum(r.t1 - r.t0 for r in rs)
    if not t:
        return None
    flops = sum(bounds.rows_flops(rec["model"], rows(r)) for r in rs)
    return 100.0 * flops / (t * bounds.PEAK_BF16_FLOP_S)
