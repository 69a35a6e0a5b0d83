"""The paged kernels' sequence split, in plain PyTorch, against the JAX
package's paged kernels.

The body of ``csrc/paged_attention.cu`` cuts each row's walk, in both
types, into fixed spans of ``ref.SPAN_KEYS`` keys counted from position
0, writes each span's unnormalised (o, m, l) and merges the spans in
order.
``ref.paged_prefill_attention_split_ref`` is that computation; here it
is held against the Pallas kernels (interpret mode) and the JAX oracles
at the reference's tolerances (2e-5 in f32, 2e-2 in bf16), at the
kernel's span and at a span short enough that the small shapes have
several spans and empty ones. The kernel itself is held against it on
the card (``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.paged_attention import paged_attention as j_decode
from repro.kernels.paged_attention import \
    paged_prefill_attention as j_prefill
from repro_torch.kernels import flash_prefill as fp_mod
from repro_torch.kernels import paged_attention as pa_mod
from repro_torch.kernels import ref as tref
from test_torch_cuda import (LONG_CASES, PREFILL_SHAPES, REL_TOL, TOL,
                             _long_case, _planted_faults, _prefill_case,
                             _row_scaled_err, _valid_close)
from test_torch_kernels import DECODE_SHAPES, _both

SPANS = [16, tref.SPAN_KEYS]


@pytest.mark.parametrize("span", SPANS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Q,Hq,Hkv,D,page,pps", PREFILL_SHAPES)
def test_split_prefill_matches_jax(B, Q, Hq, Hkv, D, page, pps, dtype, span):
    arrays = _prefill_case(0, B, Q, Hq, Hkv, D, page, pps)
    j, t = zip(*(_both(a, dtype) for a in arrays))
    got = tref.paged_prefill_attention_split_ref(*t, span=span)
    assert got.dtype == t[0].dtype and got.shape == (B, Q, Hq, D)
    got = got.float().numpy()
    ql = arrays[-1]
    _valid_close(got, j_prefill(*j, interpret=True), ql, TOL[dtype])
    _valid_close(got, jref.paged_prefill_attention_ref(*j), ql, TOL[dtype])
    # padding rows, including a whole q_lens == 0 row, are zeros
    for b, n in enumerate(ql):
        assert not got[b, n:].any()


@pytest.mark.parametrize("span", SPANS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,D,page,pps", DECODE_SHAPES)
def test_split_decode_matches_jax(B, Hq, Hkv, D, page, pps, dtype, span):
    rng = np.random.default_rng(1)
    P = B * pps + 3
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    kp = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    bt = rng.permutation(P)[:B * pps].reshape(B, pps).astype(np.int32)
    # a 1-token sequence (zero history) and ragged lengths
    sl = np.array([(i * 7) % (page * pps) + 1 for i in range(B)], np.int32)
    j, t = zip(*(_both(a, dtype) for a in (q, kp, vp, bt, sl)))
    got = tref.paged_attention_split_ref(*t, span=span).float().numpy()
    for want in (j_decode(*j, interpret=True), jref.paged_attention_ref(*j)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=TOL[dtype], atol=TOL[dtype])


def test_span_partials_mark_empty_spans():
    """A span past a row's limit and every span of a padding row have
    m = NEG_INF, l = 0, o = 0; a span the row reaches has l >= 1 (its
    largest weight is exp(0))."""
    span = 8
    q, kp, vp, bt, qs, ql = (torch.from_numpy(a) for a in
                             _prefill_case(0, 4, 5, 6, 3, 16, 5, 4))
    o, m, l = tref.paged_span_partials(q, kp, vp, bt, qs, ql, span)
    B, Q, Hq, nspan = m.shape
    assert nspan == -(-bt.shape[1] * kp.shape[1] // span)
    assert int(ql[-1]) == 0 and int(qs[0]) == 0   # a pad row, no history
    n_empty = 0
    for b in range(B):
        for t in range(Q):
            limit = int(qs[b]) + t
            for s in range(nspan):
                if t >= int(ql[b]) or limit < s * span:
                    n_empty += 1
                    assert (m[b, t, :, s] == tref.NEG_INF).all()
                    assert (l[b, t, :, s] == 0).all()
                    assert not o[b, t, :, s].any()
                else:
                    assert (l[b, t, :, s] >= 1).all()
    assert n_empty > 0


@pytest.mark.parametrize("fn", [pa_mod.paged_prefill_attention,
                                tref.paged_prefill_attention_split_ref])
def test_decode_row_same_in_q8_and_q1_launch(fn):
    """Row independence: a decode row's result in a Q = 8 launch (beside
    prefill rows and padding) equals the same row launched alone at
    Q = 1, within 2e-5 in f32."""
    q, kp, vp, bt, qs, ql = (torch.from_numpy(a) for a in
                             _prefill_case(5, 4, 8, 4, 2, 32, 8, 5))
    ql = torch.tensor([8, 1, 3, 1], dtype=torch.int32)
    wide = fn(q, kp, vp, bt, qs, ql)
    one = torch.ones_like(ql)
    alone = fn(q[:, :1].contiguous(), kp, vp, bt, qs, one)
    dec = (ql == 1).nonzero().flatten()
    torch.testing.assert_close(wide[dec, 0], alone[dec, 0], rtol=2e-5,
                               atol=2e-5)
    # and equal to the decode function on those rows
    want = pa_mod.paged_attention(q[:, 0].contiguous(), kp, vp, bt, qs + 1)
    torch.testing.assert_close(wide[dec, 0], want[dec], rtol=2e-5,
                               atol=2e-5)


def _pages(dtype, page, D, Hkv=2, Hq=4, B=2, pps=3):
    q = torch.zeros((B, 1, Hq, D), dtype=dtype)
    kp = torch.zeros((B * pps, page, Hkv, D), dtype=dtype)
    bt = torch.zeros((B, pps), dtype=torch.int32)
    ints = (("q_start", torch.zeros(B, dtype=torch.int32)),
            ("q_lens", torch.ones(B, dtype=torch.int32)))
    return q, kp, bt, ints


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_takes_any_page(dtype):
    """The body stages 16 keys at a time whatever the page, in both
    types, so the wrapper puts no limit on the page size."""
    for page in (1, 5, 256, 1024):
        q, kp, bt, ints = _pages(dtype, page=page, D=128)
        assert pa_mod._check(q, kp, kp, bt, ints)[1:] == (page, 2, 128, 3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_head_dims(dtype):
    """The paged body is instantiated for the head dims 32 and 128 in
    both types (its m16n8k16 tiles need a multiple of 16), the flash
    body for 64 and 128; others raise before any launch."""
    for D, ok in ((32, True), (128, True), (64, False), (16, False)):
        q, kp, bt, ints = _pages(dtype, page=16, D=D)
        if ok:
            pa_mod._check(q, kp, kp, bt, ints)
        else:
            with pytest.raises(ValueError, match="head_dim"):
                pa_mod._check(q, kp, kp, bt, ints)
    for D, ok in ((64, True), (128, True), (32, False)):
        x = torch.zeros((1, 4, 8, D), dtype=dtype)
        if ok:
            fp_mod._check(x, x[:, :2], x[:, :2], None, 0)
        else:
            with pytest.raises(ValueError, match="head_dim"):
                fp_mod._check(x, x[:, :2], x[:, :2], None, 0)


@pytest.mark.parametrize("page,pps,nspan", [(16, 32, 4), (16, 27, 4),
                                            (5, 4, 1), (8, 17, 2)])
def test_split_scratch_from_table_width(page, pps, nspan):
    """The wrapper sizes the f32 partials from the table width alone
    (ceil(pps * page / SPAN_KEYS) spans; no device length is read), for
    either input type."""
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.zeros((3, 16, 12, 128), dtype=dtype)
        o, ml, n = pa_mod.split_scratch(q, 16, 2, 128, page, pps)
        assert n == nspan
        assert o.shape == (3, 2, nspan, 6 * 16, 128)
        assert ml.shape == (3, 2, nspan, 6 * 16, 2)
        assert o.dtype == ml.dtype == torch.float32


@pytest.mark.parametrize("case", LONG_CASES)
def test_scaled_tolerance_catches_planted_faults(case):
    """The card's tight check of the bf16 split holds the fused kernel
    to the f32 split plain version within REL_TOL of each row's scale.
    On the card test's own inputs, the f32 split rounded to bf16 sits
    well inside that tolerance, and each planted fault (a span left
    out, a merge that ignores m) lies outside it."""
    q, kp, vp, bt, qs, ql = _long_case("cpu", torch.bfloat16, *case)
    f32 = [x.float() for x in (q, kp, vp)]
    want = tref.paged_prefill_attention_split_ref(*f32, bt, qs, ql)
    assert _row_scaled_err(want.to(torch.bfloat16), want, ql) < REL_TOL / 2
    for name, bad in _planted_faults(*f32, bt, qs, ql).items():
        assert _row_scaled_err(bad, want, ql) > REL_TOL, name
