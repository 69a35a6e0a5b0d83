"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: they skip on a host without a CUDA device. This file
imports neither JAX nor the JAX package, so it runs on the machine with
the card:

  PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

``tests/test_torch_kernels.py`` shares its cases and holds the plain
versions against the JAX kernels on the CPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref as tref
from repro_torch.kernels.paged_attention import (_HEAD_DIMS, paged_attention,
                                                 paged_prefill_attention)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _prefill_case(seed, B, Q, Hq, Hkv, D, page, pps):
    """Ragged starts/lengths incl. a zero-history row, a non-page-aligned
    start and (when B allows) a fully-padded q_lens == 0 row."""
    rng = np.random.default_rng(seed)
    P = B * pps + 3
    q = rng.standard_normal((B, Q, Hq, D)).astype(np.float32)
    kp = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    bt = rng.permutation(P)[:B * pps].reshape(B, pps).astype(np.int32)
    qs = np.array([(i * 7) % (page * pps - Q) for i in range(B)], np.int32)
    ql = np.array([0 if (B > 2 and i == B - 1) else 1 + (i * 3) % Q
                   for i in range(B)], np.int32)
    return q, kp, vp, bt, qs, ql


def _valid_close(got, want, ql, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    for b in range(got.shape[0]):
        n = int(ql[b])
        np.testing.assert_allclose(got[b, :n], want[b, :n], rtol=tol,
                                   atol=tol)


PREFILL_SHAPES = [
    (3, 4, 4, 2, 16, 8, 4),      # GQA, mixed q_lens
    (2, 8, 8, 2, 32, 8, 5),      # chunk spans pages
    (1, 7, 4, 1, 16, 4, 6),      # MQA, odd Q
    (4, 5, 6, 3, 16, 5, 4),      # non-pow2 page, padded row
    (2, 1, 4, 2, 16, 8, 4),      # decode-only round (Q=1)
    (3, 6, 12, 2, 128, 16, 3),   # qwen2-1.5b heads (G=6, D=128)
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain(dtype):
    """On the card: each kernel against its plain version, and the Q = 1
    fused kernel bitwise equal to the decode kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    dev = torch.device("cuda")
    for shape in PREFILL_SHAPES:
        if shape[4] not in _HEAD_DIMS:
            continue                      # head dims the kernel takes
        q, kp, vp, bt, qs, ql = (torch.from_numpy(a).to(dev) for a in
                                 _prefill_case(0, *shape))
        q, kp, vp = (x.to(TDT[dtype]) for x in (q, kp, vp))
        got = paged_prefill_attention(q, kp, vp, bt, qs, ql)
        want = tref.paged_prefill_attention_ref(q, kp, vp, bt, qs, ql)
        _valid_close(got.float().cpu(), want.float().cpu(), ql.cpu(),
                     TOL[dtype])
        one = torch.ones_like(ql)
        f = paged_prefill_attention(q[:, :1].contiguous(), kp, vp, bt, qs,
                                    one)
        d = paged_attention(q[:, 0].contiguous(), kp, vp, bt, qs + 1)
        assert torch.equal(f[:, 0], d)


def flash_case(seed, B, Hq, Hkv, Sq, Skv, D):
    """q [B, Hq, Sq, D], k/v [B, Hkv, Skv, D], standard normal."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, Hq, Sq, D), (B, Hkv, Skv, D),
                           (B, Hkv, Skv, D)))


def ssd_case(seed, b, l, h, p, n, g=None):
    """The JAX sweep's inputs: X, B, C ~ N(0, 0.25), dA = -0.3 |N(0, 1)|;
    B and C per group, [b, l, g, n] (g = h by default)."""
    rng = np.random.default_rng(seed)
    g = h if g is None else g
    X = rng.standard_normal((b, l, h, p)).astype(np.float32) * 0.5
    dA = -np.abs(rng.standard_normal((b, l, h))).astype(np.float32) * 0.3
    B = rng.standard_normal((b, l, g, n)).astype(np.float32) * 0.5
    C = rng.standard_normal((b, l, g, n)).astype(np.float32) * 0.5
    return X, dA, B, C


# lengths that are no multiple of the kernel's tiles, a window, an offset
FLASH_CUDA_SHAPES = [          # B, Hq, Hkv, Sq, Skv, D, window, q_offset
    (1, 12, 2, 200, 200, 128, None, 0),
    (2, 4, 4, 70, 70, 64, 24, 0),
    (1, 8, 2, 33, 97, 64, None, 64),
    (1, 4, 2, 50, 130, 64, 32, 80),
]
SSD_CUDA_SHAPES = [            # b, l, h, g, p, n, chunk
    (1, 512, 4, 4, 64, 128, 256),
    (2, 96, 3, 3, 32, 16, 32),
    (1, 200, 2, 2, 16, 128, 40),
    (1, 512, 8, 1, 64, 128, 256),   # one group (mamba2-1.3b's)
    (2, 96, 6, 2, 32, 16, 32),      # 1 < G < H, N = 16
    (1, 200, 4, 2, 16, 128, 40),    # 1 < G < H, chunk no multiple of 16
    (1, 256, 4, 1, 64, 128, 256),   # L = chunk: no recurrence
    (1, 80, 2, 1, 96, 64, 80),      # P past one 64-column tile
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_prefill_matches_plain(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    from repro_torch.kernels.flash_prefill import flash_prefill
    for B, Hq, Hkv, Sq, Skv, D, window, q_offset in FLASH_CUDA_SHAPES:
        q, k, v = (torch.from_numpy(a).to("cuda", TDT[dtype]) for a in
                   flash_case(0, B, Hq, Hkv, Sq, Skv, D))
        got = flash_prefill(q, k, v, window=window, q_offset=q_offset)
        want = tref.flash_prefill_ref(q, k, v, window=window,
                                      q_offset=q_offset)
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_ssd_scan_matches_plain(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models.ssm import ssd_chunked
    tol = 4 * TOL[dtype]             # the recurrence accumulates over l
    # B/C in either type whatever X's (bf16 beside f32 X is the model's
    # form): the plain versions take them repeated over the heads in f32,
    # which a bf16 value reaches exactly, so the tolerance is X's
    for b, l, h, g, p, n, chunk in SSD_CUDA_SHAPES:
        for bc in ("float32", "bfloat16"):
            X, dA, B, C = (torch.from_numpy(a).to("cuda") for a in
                           ssd_case(0, b, l, h, p, n, g))
            X, dA = X.to(TDT[dtype]), dA.to(TDT[dtype])
            B, C = B.to(TDT[bc]), C.to(TDT[bc])
            Y, st = ssd_scan(X, dA, B, C, chunk=chunk)
            assert Y.dtype == X.dtype and st.dtype == torch.float32
            f32 = [t.float() for t in (X, dA)] + [
                t.float().repeat_interleave(h // g, dim=2) for t in (B, C)]
            for Yw, stw in (ssd_chunked(*f32, chunk),
                            tref.ssd_scan_ref(*f32)):
                torch.testing.assert_close(Y.float(), Yw, rtol=tol,
                                           atol=tol)
                torch.testing.assert_close(st, stw, rtol=tol, atol=tol)


def _long_case(dev, dtype, B, Q, Hq, Hkv, D, page, ctx, seed=0):
    """Rows 0-1 prefill a Q-token chunk after ``ctx`` tokens, the middle
    rows decode one token, the last row pads (q_lens 0); the table is as
    wide as the longest row needs, so rows walk several spans of
    ``SPAN_KEYS`` keys and short rows leave spans empty."""
    import math
    pps = math.ceil((max(ctx) + Q) / page)
    rng = np.random.default_rng(seed)
    P = B * pps + 1
    q = rng.standard_normal((B, Q, Hq, D)).astype(np.float32)
    kp = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    bt = rng.permutation(P - 1)[:B * pps].reshape(B, pps).astype(np.int32)
    qs = np.array(ctx, np.int32)
    ql = np.array([Q if i < 2 else (0 if i == B - 1 else 1)
                   for i in range(B)], np.int32)
    f = [torch.from_numpy(x).to(dev) for x in (q, kp, vp)]
    return ([x.to(dtype) for x in f]
            + [torch.from_numpy(x).to(dev) for x in (bt, qs, ql)])


LONG_CASES = [  # B, Q, Hq, Hkv, D, page, ctx
    (4, 16, 12, 2, 128, 16, [700, 0, 129, 40]),
    (5, 8, 8, 2, 32, 8, [300, 127, 0, 128, 9]),
    (4, 5, 4, 1, 32, 5, [260, 3, 60, 7]),       # page no divisor of 16
]

# The bf16 fused kernel against the f32 split plain version on the same
# inputs, per query row relative to the row's largest |value|: rounding P
# and the output to bf16 costs a few 2^-9, each planted fault of
# ``_planted_faults`` far more (``test_torch_split.py`` shows both on
# every LONG_CASES case).
REL_TOL = 2e-2


def _row_scaled_err(got, want, ql):
    """Largest error of a live query row (b, t, head) of [B, Q, Hq, D]
    outputs, relative to that row's largest |want|."""
    got, want = got.float(), want.float()
    err = (got - want).abs().amax(-1)
    scale = want.abs().amax(-1).clamp_min(1e-30)
    live = torch.arange(got.shape[1], device=got.device)[None, :] < \
        ql[:, None]
    return (err / scale)[live].max().item()


def _planted_faults(q, kp, vp, bt, qs, ql):
    """The split plain version with a fault planted in it: span 1 left
    out (its l set to 0, so the merge gives it weight 0), and a merge
    that ignores m (every span weighted 1)."""
    o, m, l = tref.paged_span_partials(q, kp, vp, bt, qs, ql)
    drop = l.clone()
    drop[..., 1] = 0
    no_m = torch.where(l > 0, m.amax(-1, keepdim=True), m)
    return {"span 1 left out": tref.merge_span_partials(o, m, drop, ql),
            "merge ignores m": tref.merge_span_partials(o, no_m, l, ql)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_mixed_launch_decode_rows_bitwise(dtype):
    """Row independence: in a mixed launch the decode rows equal, bit
    for bit, the same rows from a ``paged_attention`` launch, with
    several spans per row and empty spans."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    for B, Q, Hq, Hkv, D, page, ctx in LONG_CASES:
        q, kp, vp, bt, qs, ql = _long_case("cuda", TDT[dtype], B, Q, Hq,
                                           Hkv, D, page, ctx)
        got = paged_prefill_attention(q, kp, vp, bt, qs, ql)
        dec = paged_attention(q[:, 0].contiguous(), kp, vp, bt, qs + 1)
        rows = (ql == 1).nonzero().flatten()
        assert rows.numel() > 0
        assert torch.equal(got[rows, 0], dec[rows])
        want = tref.paged_prefill_attention_ref(q, kp, vp, bt, qs, ql)
        _valid_close(got.float().cpu(), want.float().cpu(), ql.cpu(),
                     TOL[dtype])


@pytest.mark.cuda
def test_cuda_bf16_kernels_match_f32_plain():
    """The bf16 kernels against the plain versions computed in f32 from
    the same bf16 inputs (the plain output unrounded). Tolerance 2e-2,
    the reference's bf16 one: the kernels round P to bf16 before PV
    (relative 2^-9 per weight) and round their output to bf16 (2^-9 of
    |out|), the plain f32 version does neither. The fused kernel also
    holds the f32 split plain version to REL_TOL of each row's scale, a
    tolerance each planted fault breaks on the same inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    from repro_torch.kernels.flash_prefill import flash_prefill
    tol = TOL["bfloat16"]
    for B, Q, Hq, Hkv, D, page, ctx in LONG_CASES:
        q, kp, vp, bt, qs, ql = _long_case("cuda", torch.bfloat16, B, Q, Hq,
                                           Hkv, D, page, ctx)
        got = paged_prefill_attention(q, kp, vp, bt, qs, ql)
        want = tref.paged_prefill_attention_ref(q.float(), kp.float(),
                                                vp.float(), bt, qs, ql)
        _valid_close(got.float().cpu(), want.cpu(), ql.cpu(), tol)
        f32 = [x.float() for x in (q, kp, vp)]
        split = tref.paged_prefill_attention_split_ref(*f32, bt, qs, ql)
        assert _row_scaled_err(got, split, ql) <= REL_TOL
        for name, bad in _planted_faults(*f32, bt, qs, ql).items():
            assert _row_scaled_err(bad, split, ql) > REL_TOL, name
    for B, Hq, Hkv, Sq, Skv, D, window, q_offset in FLASH_CUDA_SHAPES:
        q, k, v = (torch.from_numpy(a).to("cuda", torch.bfloat16) for a in
                   flash_case(0, B, Hq, Hkv, Sq, Skv, D))
        got = flash_prefill(q, k, v, window=window, q_offset=q_offset)
        want = tref.flash_prefill_ref(q.float(), k.float(), v.float(),
                                      window=window, q_offset=q_offset)
        torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
