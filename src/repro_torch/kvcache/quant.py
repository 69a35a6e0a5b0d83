"""The shared int8 block quantizer: the KV wire codec of the offload
path (DESIGN.md §14) and the quantization core of the gradient
all-reduce.

One scheme, two call sites: ``distributed/compression.py`` quantizes
gradient blocks on the device for the int8 all-reduce with
``_pad_blocks`` and ``block_scale`` from here, so the two tiers cannot
drift. The paged KV offload path quantizes page payloads on the host before
they enter the DRAM tier: ``KVWireCodec`` encodes a page's
``[2, L, page, Hkv, hd]`` host copy (a CPU tensor in the store's dtype,
bf16 included) to ``(int8 payload, fp32 block scales)`` at offload time
and decodes it, back to the store's dtype, as the reload chunk lands.
The ``fp32`` format is the identity codec: 'fp32' means the KV store's
native dtype, untouched, so offload -> reload is bit exact.

Scheme (per BLOCK-element block, computed in f32):

  scale = max(|x|, eps) / 127        q = clamp(round(x / scale), ±127)

The epsilon guards the *max*, not the quotient, so the block's
max-magnitude element maps to ±127, exact zeros survive, and the f32
dequantization ``q * scale`` lies within scale / 2 of x (up to f32
rounding, 2^-23 of x). ``torch.round``
rounds half to even as ``np.rint`` does, so on f32 input ``q`` and the
scales are the JAX package's bit for bit. Decoding to a narrower store
dtype adds that dtype's own rounding of ``q * scale``.

Wire size: BLOCK int8 lanes + one fp32 scale per block, so an int8
page costs ``(1 + 4/BLOCK)`` bytes per element against ``itemsize``
for the native dtype — ``wire_scale`` 0.254 for an f32 store, 0.508
for bf16. The modeled PCIe channel multiplies by this factor
(``TransferChannel.wire_scale``) so chunk sizing, reload stall
accounting and ``reload_overlap_frac`` all see the compressed size.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

BLOCK = 256
EPS = 1e-12

KV_WIRE_FORMATS = ("fp32", "int8")


@dataclass
class QuantizedPage:
    """One KV page's host copy in int8 wire format: ``q`` [nb, BLOCK]
    int8 payload, ``scales`` [nb] fp32 shared block scales, plus the
    original shape/dtype for decode. Opaque to the pool's host store —
    conservation and cancellation treat it exactly like the
    native-dtype copy it replaces."""
    q: torch.Tensor
    scales: torch.Tensor
    shape: tuple
    dtype: torch.dtype

    @property
    def nbytes(self) -> int:
        return self.q.nbytes + self.scales.nbytes


def _pad_blocks(flat: torch.Tensor):
    """A flat tensor padded with zeros to a BLOCK multiple, as [nb,
    BLOCK]; returns (blocks, pad). Zeros never raise a block's max, and
    decoders cut them off by the original size."""
    pad = (-flat.numel()) % BLOCK
    return F.pad(flat, (0, pad)).reshape(-1, BLOCK), pad


def block_scale(maxabs: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Each block's scale from its max magnitude: the epsilon guards the
    max (an all-zero block), not the quotient."""
    return maxabs.clamp(min=eps) / 127.0


def encode_page(host: torch.Tensor, eps: float = EPS) -> QuantizedPage:
    """int8-encode a host tensor with BLOCK-granular fp32 scales. The
    result owns fresh tensors: ``host`` may be a view into a staging
    buffer that is reused."""
    blocks, _ = _pad_blocks(host.detach().to("cpu", torch.float32)
                            .reshape(-1))
    scales = block_scale(blocks.abs().amax(dim=1), eps)
    q = torch.round(blocks / scales[:, None]).clamp(-127, 127) \
        .to(torch.int8)
    return QuantizedPage(q=q, scales=scales, shape=tuple(host.shape),
                         dtype=host.dtype)


def decode_page(page: QuantizedPage) -> torch.Tensor:
    """Inverse of ``encode_page``: ``q * scale`` in f32 (within scale/2
    of the encoded values), then the page's own dtype."""
    flat = page.q.to(torch.float32) * page.scales[:, None]
    n = math.prod(page.shape)
    return flat.reshape(-1)[:n].reshape(page.shape).to(page.dtype)


def decode_host(obj):
    """Decode a host-store entry whatever its wire format: pass a
    native-dtype copy through untouched (bit exact), dequantize a
    ``QuantizedPage``. The pool's synchronous reload fallback and the
    engine's chunk io both route through this."""
    if isinstance(obj, QuantizedPage):
        return decode_page(obj)
    return obj


class KVWireCodec:
    """The offload path's wire-format choice, threaded from
    ``PagedRealtimeEngine(kv_quant=...)`` down to the pool and the
    modeled channel. ``fp32`` is the identity codec (the bit-exact
    differential control); ``int8`` block-quantizes every host copy."""

    def __init__(self, fmt: str = "fp32"):
        if fmt not in KV_WIRE_FORMATS:
            raise ValueError(
                f"kv_quant must be one of {KV_WIRE_FORMATS}, got {fmt!r}")
        self.fmt = fmt

    def encode(self, host: torch.Tensor):
        if self.fmt == "fp32":
            return host
        return encode_page(host)

    def decode(self, obj) -> torch.Tensor:
        return decode_host(obj)

    def wire_scale(self, itemsize: int) -> float:
        """Wire bytes per logical byte of a store whose elements take
        ``itemsize`` bytes: the factor the modeled PCIe channel
        multiplies into ``transfer_time``, so every consumer (chunk
        sizing, preload admission, stall settlement) prices the
        compressed payload. Includes the fp32 scale overhead (4 bytes
        per BLOCK elements)."""
        if self.fmt == "fp32":
            return 1.0
        return (1.0 + 4.0 / BLOCK) / itemsize
