"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427):
the port of the JAX package's ``models/rglru.py``.

h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t), with
a_t = exp(-c * softplus(Lambda) * r_t), c = 8, and r/i sigmoid gates.
The gates use block-diagonal weights (``NUM_BLOCKS`` independent channel
blocks), kept in f32 at any ``param_dtype`` as in the reference.

Prefill scans the recurrence over the sequence in f32 as a log-step
(Hillis-Steele) scan: ceil(log2 S) passes over ``[B, S, w]``, each two
elementwise ops between a pair of buffers, where the reference runs
``jax.lax.associative_scan`` (a different tree of the same associative
combine, so the two agree to f32 rounding). The prefill's scan writes
through ``out=`` into buffers it reuses, which autograd refuses; the
training graph (``graph="train"``) takes ``_linear_scan_train``, the
same passes in the same combine order out of place, which gives the
same values bit for bit. Decode is one recurrence step.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init
from repro_torch.models.ssm import causal_conv1d

_C = 8.0
NUM_BLOCKS = 16


def rglru_init(generator, d_model: int, width: int, conv_width: int, dtype,
               device):
    """The reference's tree: ``w_a``/``w_x`` ``[nb, bw, bw]`` and ``b_a``,
    ``b_x``, ``lam`` in f32; the projections and the conv in ``dtype``."""
    nb = NUM_BLOCKS if width % NUM_BLOCKS == 0 else 1
    bw = width // nb
    f32 = torch.float32

    def w(shape, fan_in, dt=dtype):
        return dense_init(generator, shape, fan_in, dt, device)

    def blocks():
        return torch.stack([w((bw, bw), bw, f32) for _ in range(nb)])

    return {
        "in_gate": w((d_model, width), d_model),
        "in_rec": w((d_model, width), d_model),
        "conv_w": (torch.randn((conv_width, width), generator=generator,
                               device=device) * 0.1).to(dtype),
        "conv_b": torch.zeros((width,), dtype=dtype, device=device),
        "w_a": blocks(),
        "b_a": torch.zeros((width,), dtype=f32, device=device),
        "w_x": blocks(),
        "b_x": torch.zeros((width,), dtype=f32, device=device),
        # a ~ uniform decay in [0.9, 0.999]
        "lam": torch.linspace(-2.0, 2.0, width, dtype=f32, device=device),
        "out": w((width, d_model), width),
    }


def _block_linear(w, x):
    """Block-diagonal matmul: w [nb, bw, bw], x [..., nb*bw]."""
    nb, bw, _ = w.shape
    xb = x.reshape(x.shape[:-1] + (nb, bw))
    return torch.einsum("...nk,nkj->...nj", xb, w).reshape(x.shape)


def _gates(params, x):
    """(log a, sqrt(1 - a^2) * i * x), both f32 [b, s, w]."""
    xf = x.float()
    r = torch.sigmoid(_block_linear(params["w_a"], xf) + params["b_a"])
    i = torch.sigmoid(_block_linear(params["w_x"], xf) + params["b_x"])
    log_a = -_C * F.softplus(params["lam"]) * r
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                   min=1e-12)) * (i * xf)
    return log_a, gated


def _linear_scan(a, b):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t from h = 0 along axis 1,
    in ceil(log2 S) passes: each pass combines every position with the
    one ``step`` before it, (a1, b1) then (a2, b2) -> (a1 a2, a2 b1 + b2),
    into the other of two buffers (the first ``step`` positions copied
    over), so a pass reads and writes each buffer about once. Returns
    (prod_{s <= t} a_s, h_t); ``a`` and ``b`` are overwritten."""
    S = a.shape[1]
    a2, b2 = torch.empty_like(a), torch.empty_like(b)
    step = 1
    while step < S:
        torch.addcmul(b[:, step:], a[:, step:], b[:, :-step],
                      out=b2[:, step:])
        torch.mul(a[:, step:], a[:, :-step], out=a2[:, step:])
        b2[:, :step] = b[:, :step]
        a2[:, :step] = a[:, :step]
        a, a2, b, b2 = a2, a, b2, b
        step *= 2
    return a, b


def _linear_scan_train(a, b):
    """``_linear_scan`` out of place, for autograd: each pass builds new
    tensors from the same products in the same order, so the values are
    ``_linear_scan``'s bit for bit; ``a`` and ``b`` are left as they
    are."""
    S = a.shape[1]
    step = 1
    while step < S:
        b = torch.cat([b[:, :step],
                       torch.addcmul(b[:, step:], a[:, step:], b[:, :-step])],
                      dim=1)
        a = torch.cat([a[:, :step], a[:, step:] * a[:, :-step]], dim=1)
        step *= 2
    return a, b


def rglru_scan(params, x, h0=None, *, graph: str = "serve"):
    """x [b, s, w] -> (y [b, s, w] f32, h_last [b, w] f32). ``graph``
    "train" scans out of place (``_linear_scan_train``)."""
    log_a, gated = _gates(params, x)
    scan = _linear_scan_train if graph == "train" else _linear_scan
    aa, y = scan(torch.exp(log_a), gated)
    if h0 is not None:
        y = y + aa * h0[:, None, :]
    return y, y[:, -1, :]


def rglru_step(params, x, h):
    """x [b, 1, w], h [b, w] -> (y [b, 1, w], h')."""
    log_a, gated = _gates(params, x)
    h = torch.exp(log_a[:, 0]) * h + gated[:, 0]
    return h[:, None, :], h


def _gate_and_conv(params, x, conv_cache):
    gate = F.gelu(x @ params["in_gate"], approximate="tanh")
    rec, conv_cache = causal_conv1d(x @ params["in_rec"], params["conv_w"],
                                    conv_cache)
    return gate, rec + params["conv_b"], conv_cache


def recurrent_block_forward(params, cfg, x, *, graph: str = "serve"):
    """The Griffin recurrent block over a prompt, from an empty conv cache
    and a zero state: (gelu gate) * (conv -> RG-LRU). Returns (out,
    (conv_cache, h_last)). ``graph`` "train": the training graph's
    out-of-place scan."""
    gate, rec, conv_cache = _gate_and_conv(params, x, None)
    y, h_last = rglru_scan(params, rec, graph=graph)
    out = (gate * y.to(x.dtype)) @ params["out"]
    return out, (conv_cache, h_last)


def recurrent_block_decode(params, cfg, x, conv_cache, h):
    """One token of the block: x [b, 1, d]. Returns (out, (conv_cache,
    h))."""
    gate, rec, conv_cache = _gate_and_conv(params, x, conv_cache)
    y, h = rglru_step(params, rec, h)
    out = (gate * y.to(x.dtype)) @ params["out"]
    return out, (conv_cache, h)
