"""The KV wire codec of the offload path (DESIGN.md §14).

The port carries only the ``fp32`` format: the identity codec, where
'fp32' means the KV store's native dtype, untouched, so offload ->
reload is bit exact. Host copies are CPU tensors in the store's dtype.

The ``int8`` block-quantized format is not ported yet (ROADMAP queue 2,
item 4): its quantizer has to work on those tensors, bf16 included,
and ``PagedRealtimeEngine(kv_quant="int8")`` raises until it does.
"""
from __future__ import annotations

KV_WIRE_FORMATS = ("fp32", "int8")


def decode_host(obj):
    """Decode a host-store entry. In the fp32 format the entry is the
    host copy itself, passed through untouched (bit exact)."""
    return obj


class KVWireCodec:
    """The offload path's wire-format choice, threaded from
    ``PagedRealtimeEngine(kv_quant=...)`` down to the pool and the
    modeled channel."""

    def __init__(self, fmt: str = "fp32"):
        if fmt not in KV_WIRE_FORMATS:
            raise ValueError(
                f"kv_quant must be one of {KV_WIRE_FORMATS}, got {fmt!r}")
        if fmt != "fp32":
            raise NotImplementedError(
                f"kv_quant={fmt!r} is not ported yet (ROADMAP queue 2, "
                "item 4)")
        self.fmt = fmt

    def encode(self, host):
        return host

    def decode(self, obj):
        return decode_host(obj)

    def wire_scale(self, itemsize: int) -> float:
        """Wire bytes per logical byte, the factor the modeled PCIe
        channel multiplies into ``transfer_time``: 1 for fp32."""
        return 1.0
