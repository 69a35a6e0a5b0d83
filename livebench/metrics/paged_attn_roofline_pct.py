"""Kernels (``kernels/paged_attention.py``, ``csrc/paged_attention.cu``):
the least time of every ``paged_prefill_attention`` launch in the
profiled slice (``bounds.attention_least_s`` from each round's rows,
once per launch) over the device time of its kernels (the split kernel
and its merge) in the trace."""
from livebench import bounds, trace
from livebench.metrics._slice import rows, traced_rounds

UNIT = "%"
MOVES = "ttfp_p50_ms"
KERNELS = ("paged_attention_kernel", "paged_merge")


def read(rec):
    rs = traced_rounds(rec)
    tr = rec.get("trace")
    if not rs or tr is None:
        return None
    dev_s = trace.device_seconds(tr, KERNELS)
    tracer = rec["tracer"]
    launches = tracer.launches1 - tracer.launches0
    if not dev_s or not launches:
        return None
    m = rec["model"]
    hd = m.get("head_dim") or m["d_model"] // m["num_heads"]
    page = rec["mix"]["gateway"]["page_size"]
    per_round = launches / len(rs)
    least = sum(per_round * bounds.attention_least_s(
        rows(r), m["num_heads"], m["num_kv_heads"], hd, page) for r in rs)
    return 100.0 * least / dev_s
