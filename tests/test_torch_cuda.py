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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_options_match_plain(dtype):
    """On the card: the slot-sharding options. Each page cut into 2 and
    4 stripes, each stripe's kernel call (``pos_stride``, shifted starts,
    stats) against the plain version, rows that see no key finite with
    l = 0, ``pos_offset`` equal to the shift bitwise, and the decode
    kernel the fused one's Q = 1 case bitwise with the options on."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    dev = torch.device("cuda")
    q, kp, vp, bt, qs, ql = (torch.from_numpy(a).to(dev) for a in
                             _prefill_case(1, 3, 6, 12, 2, 128, 16, 20))
    q, kp, vp = (x.to(TDT[dtype]) for x in (q, kp, vp))
    _options_check(q, kp, vp, bt, qs, ql, TOL[dtype])


def _options_check(q, kp, vp, bt, qs, ql, tol):
    """Pages of 16 cut into 2 and 4 stripes: each stripe's kernel call
    (``pos_stride``, shifted starts, stats) against the plain version,
    rows that see no key finite with l = 0, ``pos_offset`` equal to the
    shift bitwise, and the decode kernel the fused one's Q = 1 case
    bitwise with the options on."""
    for S in (2, 4):
        n = 16 // S
        for s in range(S):
            ks, vs = (x[:, s * n:(s + 1) * n].contiguous() for x in (kp, vp))
            args = (q, ks, vs, bt, qs - s * n, ql)
            o, m, l = paged_prefill_attention(*args, pos_stride=16,
                                              return_stats=True)
            wo, wm, wl = tref.paged_prefill_attention_ref(
                *args, pos_stride=16, return_stats=True)
            _valid_close(o.float().cpu(), wo.float().cpu(), ql.cpu(), tol)
            seen = wl > 0
            assert torch.equal(l > 0, seen)
            assert torch.isfinite(o).all() and (o[~seen] == 0).all()
            assert (m[~seen] == tref.NEG_INF).all()
            torch.testing.assert_close(m[seen], wm[seen], rtol=tol,
                                       atol=tol)
            torch.testing.assert_close(l[seen], wl[seen], rtol=tol,
                                       atol=tol)
            by_offset = paged_prefill_attention(
                q, ks, vs, bt, qs, ql, pos_stride=16, pos_offset=s * n,
                return_stats=True)
            assert all(torch.equal(a, b) for a, b in zip(by_offset,
                                                         (o, m, l)))
            one = torch.ones_like(ql)
            f = paged_prefill_attention(q[:, :1].contiguous(), ks, vs, bt,
                                        qs - s * n, one, pos_stride=16,
                                        return_stats=True)
            d = paged_attention(q[:, 0].contiguous(), ks, vs, bt,
                                qs + 1 - s * n, pos_stride=16,
                                return_stats=True)
            assert all(torch.equal(a[:, 0], b) for a, b in zip(f, d))


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


# ======================================================================
# the feature planes' uses of the fused kernel and the page store
# ======================================================================
def _small_model(dtype):
    """A reduced qwen2-1.5b on the card with head dim 32 (one the kernel
    is built for), random weights from a seed."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.model import init_params
    cfg = reduced(get_config("qwen2-1.5b"), layers=2, d_model=128,
                  vocab=331).replace(dtype=dtype, param_dtype=dtype)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    return cfg, params


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_spec_verify_step_matches_plain(dtype, monkeypatch):
    """``paged_fused_step(spec=True)`` on draft-verify rows of 1 + K = 4
    tokens (and a prefill row, a padding row) against its ``plain=True``
    twin on the same store: the last-valid logits within the step
    tolerance of ``chip_smoke.py`` (f32 1e-5, bf16 3e-2 of the logits'
    scale), the per-position argmaxes equal wherever the plain top two
    are further apart than that, and the last-valid logits those of the
    non-spec step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    from repro_torch.serving.paged_engine import paged_fused_step
    cfg, params = _small_model(dtype)
    dev = torch.device("cuda")
    B, Q, page, pps = 4, 4, 8, 6
    P = B * pps
    shape = (cfg.num_layers, P + 1, page, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    kp = torch.zeros(shape, dtype=TDT[dtype], device=dev)
    vp = torch.zeros_like(kp)
    g = torch.Generator(device=dev).manual_seed(1)
    bt = torch.randperm(P, generator=g, device=dev).reshape(B, pps).int()

    def tables(start, n, q):
        t = torch.arange(q, device=dev)
        pos = start[:, None] + t[None, :]
        live = t[None, :] < n[:, None]
        pg = torch.where(live, bt.long().gather(
            1, (pos // page).clamp(max=pps - 1)), P)
        sl = torch.where(live, pos % page, t[None, :] % page)
        return pos.int(), pg, sl

    ctx = torch.tensor([21, 9, 30, 0], device=dev)
    C = 32
    toks = torch.randint(0, cfg.vocab_size, (B, C), generator=g, device=dev)
    pos, pg, sl = tables(torch.zeros_like(ctx), ctx, C)
    paged_fused_step(cfg, params, toks, pos, kp, vp, bt,
                     torch.zeros_like(ctx).int(), ctx.int(), pg, sl)
    n = torch.tensor([4, 4, 3, 0], device=dev)      # verify, prefill, pad
    pos, pg, sl = tables(ctx, n, Q)
    toks = torch.randint(0, cfg.vocab_size, (B, Q), generator=g, device=dev)
    args = (toks, pos, kp, vp, bt, ctx.int(), n.int(), pg, sl)
    k0, v0 = kp.clone(), vp.clone()
    logits, outs = paged_fused_step(cfg, params, *args, spec=True)
    kp.copy_(k0), vp.copy_(v0)
    want_l, want_o = paged_fused_step(cfg, params, *args, spec=True,
                                      plain=True)
    kp.copy_(k0), vp.copy_(v0)
    plain_last = paged_fused_step(cfg, params, *args)
    live = n > 0
    scale = want_l[live].abs().max().item()
    tol = (1e-5 if dtype == "float32" else 3e-2) * scale
    assert outs.shape == (B, Q) and logits.shape == (B, cfg.vocab_size)
    assert (logits[live] - want_l[live]).abs().max().item() <= tol
    assert (logits[live] - plain_last[live]).abs().max().item() <= tol
    # per-position logits of the plain twin, to find clear argmaxes
    kp.copy_(k0), vp.copy_(v0)
    import repro_torch.serving.paged_engine as pe
    full = []
    unembed = pe._logits
    monkeypatch.setattr(pe, "_logits", lambda c, p, x: full.append(
        unembed(c, p, x)) or full[-1])
    paged_fused_step(cfg, params, *args, spec=True, plain=True)
    top2 = full[0].topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * tol
    valid = torch.arange(Q, device=dev)[None, :] < n[:, None]
    sel = clear & valid
    if dtype == "float32":
        assert sel.sum().item() > valid.sum().item() // 2
    assert torch.equal(outs[sel], want_o[sel])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_fused_kernel_aliased_block_tables(dtype):
    """Rows whose block tables point at the same physical pages (a
    shared prefix, then private pages; one row a full alias of another
    at another q_start) at Q = 4 against the plain version; rows with
    the same table, queries and start agree bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    B, Q, Hq, Hkv, D, page, pps = 5, 4, 12, 2, 128, 16, 6
    P = 4 * pps
    shared = rng.permutation(P)[:3]
    own = rng.permutation(np.setdiff1d(np.arange(P), shared))
    bt = np.empty((B, pps), np.int32)
    for b in range(3):                 # three rows attach the prefix
        bt[b, :3] = shared
        bt[b, 3:] = own[b * 3:(b + 1) * 3]
    bt[3] = bt[0]                      # a full alias of row 0
    bt[4] = bt[1]
    qs = np.array([45, 40, 33, 60, 40], np.int32)
    ql = np.array([4, 4, 1, 4, 4], np.int32)
    q = rng.standard_normal((B, Q, Hq, D)).astype(np.float32)
    q[4] = q[1]                        # row 4 repeats row 1 exactly
    kp = rng.standard_normal((P + 1, page, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((P + 1, page, Hkv, D)).astype(np.float32)
    q, kp, vp = (torch.from_numpy(x).to(dev, TDT[dtype])
                 for x in (q, kp, vp))
    bt, qs, ql = (torch.from_numpy(x).to(dev) for x in (bt, qs, ql))
    got = paged_prefill_attention(q, kp, vp, bt, qs, ql)
    want = tref.paged_prefill_attention_ref(q, kp, vp, bt, qs, ql)
    _valid_close(got.float().cpu(), want.float().cpu(), ql.cpu(),
                 TOL[dtype])
    assert torch.equal(got[4], got[1])


@pytest.mark.cuda
def test_cuda_cow_copy_and_prefix_plane():
    """The copy-on-write page copy on a CUDA store (one in-place
    ``index_copy_`` along the page axis, source and destination in the
    same tensor) leaves the copy equal to its source and every other
    page untouched; and the prefix plane on the card (f32), which
    attaches a partial tail page and copies it on write, gives its
    ``prefix_cache=False`` twin's tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    from repro_torch.serving.paged_engine import PagedRealtimeEngine
    store = torch.randn(2, 9, 4, 2, 32, device="cuda").to(torch.bfloat16)
    before = store.clone()
    view = store[0]                      # the steps write through views
    store.index_copy_(1, torch.tensor([6], device="cuda"), store[:, 2:3])
    assert torch.equal(store[:, 6], before[:, 2])
    keep = [i for i in range(9) if i != 6]
    assert torch.equal(store[:, keep], before[:, keep])
    assert view.data_ptr() == store.data_ptr()
    cfg, params = _small_model("float32")
    rng = np.random.default_rng(0)
    fam = rng.integers(0, cfg.vocab_size, size=21)
    tails = [rng.integers(0, cfg.vocab_size, size=3) for _ in range(3)]
    hist = {}
    for prefix in (True, False):
        eng = PagedRealtimeEngine(cfg, params, slots=2, page_size=8,
                                  pages_per_seq=8, num_pages=32,
                                  prefix_cache=prefix, device="cuda")
        for i, t in enumerate(tails):
            eng.add_session(f"s{i}", np.concatenate([fam, t]),
                            max_new_tokens=6)
            eng.run_to_completion()
            eng.check_invariants()
        hist[prefix] = {s: x.history for s, x in eng.sessions.items()}
        if prefix:
            assert eng.cow_copies >= 1 and eng.prefix_cache.hits == 2
    assert hist[True] == hist[False]


# ======================================================================
# head dim 256 (paligemma-3b: 8 query heads on one KV head)
# ======================================================================
D256_PAGED_CASES = [  # B, Q, Hq, Hkv, D, page, ctx
    (8, 16, 8, 1, 256, 16, [300, 170, 411, 96, 250, 333, 128, 0]),
    (3, 5, 8, 1, 256, 16, [129, 0, 40]),
]
D256_FLASH_SHAPES = [  # B, Hq, Hkv, Sq, Skv, D, window, q_offset
    (1, 8, 1, 200, 200, 256, None, 0),
    (2, 8, 1, 77, 141, 256, None, 64),       # a chunk after a prefix
    (1, 8, 1, 130, 130, 256, 48, 0),         # sliding window
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_head_dim_256_matches_plain(dtype):
    """On the card, at head dim 256 with G = 8 (a fused round's 128 rows
    are two row groups): both paged kernels and ``flash_prefill`` against
    their plain versions, the Q = 1 fused kernel bitwise the decode
    kernel, and in bf16 the fused kernel against the f32 split plain
    version per row (REL_TOL), a tolerance each planted fault breaks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    from repro_torch.kernels.flash_prefill import flash_prefill
    tol = TOL[dtype]
    for B, Q, Hq, Hkv, D, page, ctx in D256_PAGED_CASES:
        q, kp, vp, bt, qs, ql = _long_case("cuda", TDT[dtype], B, Q, Hq,
                                           Hkv, D, page, ctx, seed=2)
        got = paged_prefill_attention(q, kp, vp, bt, qs, ql)
        want = tref.paged_prefill_attention_ref(q, kp, vp, bt, qs, ql)
        _valid_close(got.float().cpu(), want.float().cpu(), ql.cpu(), tol)
        dec = paged_attention(q[:, 0].contiguous(), kp, vp, bt, qs + 1)
        want_d = tref.paged_attention_ref(q[:, 0].contiguous(), kp, vp, bt,
                                          qs + 1)
        torch.testing.assert_close(dec.float(), want_d.float(), rtol=tol,
                                   atol=tol)
        one = paged_prefill_attention(q[:, :1].contiguous(), kp, vp, bt, qs,
                                      torch.ones_like(ql))
        assert torch.equal(one[:, 0], dec)
        if dtype == "bfloat16":
            f32 = [x.float() for x in (q, kp, vp)]
            split = tref.paged_prefill_attention_split_ref(*f32, bt, qs, ql)
            assert _row_scaled_err(got, split, ql) <= REL_TOL
            for name, bad in _planted_faults(*f32, bt, qs, ql).items():
                assert _row_scaled_err(bad, split, ql) > REL_TOL, name
    for B, Hq, Hkv, Sq, Skv, D, window, q_offset in D256_FLASH_SHAPES:
        q, k, v = (torch.from_numpy(a).to("cuda", TDT[dtype]) for a in
                   flash_case(0, B, Hq, Hkv, Sq, Skv, D))
        got = flash_prefill(q, k, v, window=window, q_offset=q_offset)
        want = tref.flash_prefill_ref(q, k, v, window=window,
                                      q_offset=q_offset)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


FAMILY_FLASH_CASES = [  # B, Hq, Hkv, Sq, Skv, D, options
    # recurrentgemma-9b's local-attention layers: 16 query heads on one
    # KV head of 256, a 2048-token window, prompts around and past it
    *((1, 16, 1, S, S, 256, dict(window=2048))
      for S in (2047, 2048, 2049, 3000)),
    # whisper-tiny's encoder self-attention over 1500 frames and its
    # decoder's cross-attention, 448 tokens over them: D 64, not causal
    (1, 6, 6, 1500, 1500, 64, dict(causal=False)),
    (1, 6, 6, 448, 1500, 64, dict(causal=False)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_prefill_window_and_noncausal(dtype):
    """On the card, ``flash_prefill`` at the hybrid and encdec families'
    shapes against its plain version: windowed at G = 16, D 256 (S = W
    - 1, W, W + 1 and far past W), and ``causal=False`` with Sq = Skv
    and with Sq != Skv, no length a multiple of the tiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    from repro_torch.kernels.flash_prefill import flash_prefill
    for B, Hq, Hkv, Sq, Skv, D, kw in FAMILY_FLASH_CASES:
        q, k, v = (torch.from_numpy(a).to("cuda", TDT[dtype]) for a in
                   flash_case(0, B, Hq, Hkv, Sq, Skv, D))
        got = flash_prefill(q, k, v, **kw)
        want = tref.flash_prefill_ref(q, k, v, **kw)
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=TOL[dtype], atol=TOL[dtype])


# ======================================================================
# head dims 80 (h2o-danube-1.8b) and 192 (nemotron-4-340b, MLA prefill)
# ======================================================================
HEAD_DIM_PAGED_CASES = [  # B, Q, Hq, Hkv, D, page, ctx
    (4, 16, 32, 8, 80, 16, [300, 0, 129, 40]),     # h2o-danube's heads
    (3, 6, 96, 8, 192, 16, [170, 3, 0]),           # nemotron-4's, G 12
]
HEAD_DIM_FLASH_CASES = [  # B, Hq, Hkv, Sq, Skv, D, options
    (1, 32, 8, 200, 200, 80, dict()),
    (1, 32, 8, 130, 130, 80, dict(window=48)),
    (2, 32, 8, 77, 141, 80, dict(window=40, q_offset=64)),
    (1, 6, 6, 70, 130, 80, dict(causal=False)),
    (1, 96, 8, 70, 70, 192, dict()),
    (1, 8, 8, 130, 130, 192, dict(window=48)),
    (1, 16, 16, 33, 97, 192, dict(causal=False)),
    (1, 16, 16, 150, 150, 192, dict()),            # MLA's G 1
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_head_dims_80_192_match_plain(dtype):
    """On the card, at head dims 80 (rows padded to an odd count of
    16-byte chunks) and 192 (whole groups of 8 chunks, 3 loader
    phases): both paged kernels against their plain versions with
    several spans a row, the Q = 1 fused kernel bitwise the decode
    kernel, the sharding options on 2 and 4 stripes, and in bf16 the
    fused kernel against the f32 split plain version per row with each
    planted fault breaking that tolerance; ``flash_prefill`` causal,
    windowed (with an offset) and not causal, lengths no multiple of
    the tiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    from repro_torch.kernels.flash_prefill import flash_prefill
    tol = TOL[dtype]
    for B, Q, Hq, Hkv, D, page, ctx in HEAD_DIM_PAGED_CASES:
        q, kp, vp, bt, qs, ql = _long_case("cuda", TDT[dtype], B, Q, Hq,
                                           Hkv, D, page, ctx, seed=3)
        got = paged_prefill_attention(q, kp, vp, bt, qs, ql)
        want = tref.paged_prefill_attention_ref(q, kp, vp, bt, qs, ql)
        _valid_close(got.float().cpu(), want.float().cpu(), ql.cpu(), tol)
        dec = paged_attention(q[:, 0].contiguous(), kp, vp, bt, qs + 1)
        want_d = tref.paged_attention_ref(q[:, 0].contiguous(), kp, vp, bt,
                                          qs + 1)
        torch.testing.assert_close(dec.float(), want_d.float(), rtol=tol,
                                   atol=tol)
        one = paged_prefill_attention(q[:, :1].contiguous(), kp, vp, bt, qs,
                                      torch.ones_like(ql))
        assert torch.equal(one[:, 0], dec)
        _options_check(q, kp, vp, bt, qs, ql, tol)
        if dtype == "bfloat16":
            f32 = [x.float() for x in (q, kp, vp)]
            split = tref.paged_prefill_attention_split_ref(*f32, bt, qs, ql)
            assert _row_scaled_err(got, split, ql) <= REL_TOL
            for name, bad in _planted_faults(*f32, bt, qs, ql).items():
                assert _row_scaled_err(bad, split, ql) > REL_TOL, name
    for B, Hq, Hkv, Sq, Skv, D, kw in HEAD_DIM_FLASH_CASES:
        q, k, v = (torch.from_numpy(a).to("cuda", TDT[dtype]) for a in
                   flash_case(0, B, Hq, Hkv, Sq, Skv, D))
        got = flash_prefill(q, k, v, **kw)
        for want in (tref.flash_prefill_ref(q, k, v, **kw),
                     tref.flash_prefill_ref(q.float(), k.float(),
                                            v.float(), **kw)):
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_mla_prefill_matches_plain(dtype):
    """On the card: multi-head latent attention's prefill at
    deepseek-v2's head shapes (q/k dim nope 128 + rope 64 = 192, v 128,
    8 of its 128 heads, G 1) through ``flash_prefill`` with V padded to
    192, against the plain ``mla_forward``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    from repro_torch.configs import get_config
    from repro_torch.models import mla
    cfg = get_config("deepseek-v2-236b").replace(
        d_model=512, num_heads=8, num_kv_heads=8, dtype=dtype,
        param_dtype=dtype)
    g = torch.Generator(device="cuda").manual_seed(0)
    params = mla.mla_init(g, cfg, TDT[dtype], "cuda")
    x = torch.randn(2, 150, cfg.d_model, generator=g,
                    device="cuda").to(TDT[dtype])
    pos = torch.arange(150, device="cuda", dtype=torch.int32).expand(2, 150)
    got, (ckv, kr) = mla.mla_forward(params, cfg, x, pos)
    want, (wckv, wkr) = mla.mla_forward(params, cfg, x, pos, plain=True)
    assert torch.equal(ckv, wckv) and torch.equal(kr, wkr)
    scale = want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype] * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["qwen2-1.5b", "paligemma-3b",
                                  "deepseek-v2-236b", "mamba2-1.3b"])
def test_cuda_train_step_matches_cpu(name):
    """On the card: the training graph's loss and every gradient leaf at
    ``reduced(...)`` (f32) against the CPU's on the same weights and
    batch (loss within 1e-5 relative, each leaf within 1e-4 of its
    largest |value|), then one AdamW update from the CPU's gradients on
    both devices (parameters within 1e-6 of each leaf's largest
    |value|); no kernel launches on the way."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models.model import init_params
    from repro_torch.training import optimizer as O
    from repro_torch.training.data import synthetic_batches
    from repro_torch.training.train_loop import batch_to, loss_and_grads
    from repro_torch.device import resolve_device
    resolve_device("cuda")                      # no TF32
    cfg = reduced(get_config(name))
    cpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gpu = O.tree_map(lambda t: t.to("cuda"), cpu)
    batch = next(synthetic_batches(cfg.vocab_size, 2, 64, seed=0))
    rng = np.random.default_rng(0)
    if cfg.frontend == "vision":
        batch["patches"] = rng.standard_normal(
            (2, cfg.frontend_len, cfg.d_model)).astype(np.float32)
        batch["prefix_len"] = np.full((2,), cfg.frontend_len, np.int32)
    counts = (flash_prefill.launches, ssd_scan.launches)
    loss, _, grads = loss_and_grads(cfg, gpu, batch_to(batch, "cuda"))
    assert (flash_prefill.launches, ssd_scan.launches) == counts
    want, _, cpu_grads = loss_and_grads(cfg, cpu, batch_to(batch, "cpu"))
    assert abs(loss.item() - want.item()) <= 1e-5 * abs(want.item())

    def leaves_close(got, ref, rel):
        for g, w in zip(O.tree_leaves(got), O.tree_leaves(ref)):
            err = (g.cpu() - w).abs().max().item()
            assert err <= rel * w.abs().max().item(), err

    leaves_close(grads, cpu_grads, 1e-4)
    opt = O.OptConfig()
    gs, cs = O.opt_init(opt, gpu), O.opt_init(opt, cpu)
    O.opt_update(opt, O.tree_map(lambda g: g.to("cuda"), cpu_grads), gs, gpu)
    O.opt_update(opt, cpu_grads, cs, cpu)
    leaves_close(gpu, cpu, 1e-6)


# ======================================================================
# the tiling knob (span) and the moe combine
# ======================================================================
KNOB_SPANS = [16, 32, 48, 64, 128, 256, 512, 1024]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_tiling_knobs_match_plain(dtype):
    """Every span (a multiple of 16 up to past the whole row, 48 no
    power of two) against the plain version; the launch with stats
    equal to the one without, bit for bit; at each span the decode
    kernel equal to the fused one at Q = 1, and the decode rows of the
    mixed launch equal to the decode kernel's (row independence), bit
    for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    for B, Q, Hq, Hkv, D, page, ctx in LONG_CASES:
        q, kp, vp, bt, qs, ql = _long_case("cuda", TDT[dtype], B, Q, Hq,
                                           Hkv, D, page, ctx)
        want = tref.paged_prefill_attention_ref(q, kp, vp, bt, qs, ql)
        one = torch.ones_like(ql)
        q1, qd = q[:, :1].contiguous(), q[:, 0].contiguous()
        rows = (ql == 1).nonzero().flatten()
        for span in KNOB_SPANS:
            whole = paged_prefill_attention(q, kp, vp, bt, qs, ql,
                                            span=span, return_stats=True)
            _valid_close(whole[0].float().cpu(), want.float().cpu(),
                         ql.cpu(), TOL[dtype])
            assert torch.equal(paged_prefill_attention(
                q, kp, vp, bt, qs, ql, span=span), whole[0]), span
            d = paged_attention(qd, kp, vp, bt, qs + 1, span=span)
            f = paged_prefill_attention(q1, kp, vp, bt, qs, one, span=span)
            assert torch.equal(f[:, 0], d), span
            assert torch.equal(whole[0][rows, 0], d[rows]), span


@pytest.mark.cuda
def test_cuda_default_knobs_are_the_parent_grid():
    """An unset span, no cache: the same launch as span ref.SPAN_KEYS,
    bit for bit; an illegal span raises before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    B, Q, Hq, Hkv, D, page, ctx = LONG_CASES[0]
    q, kp, vp, bt, qs, ql = _long_case("cuda", torch.bfloat16, B, Q, Hq,
                                       Hkv, D, page, ctx)
    got = paged_prefill_attention(q, kp, vp, bt, qs, ql)
    assert torch.equal(got, paged_prefill_attention(
        q, kp, vp, bt, qs, ql, span=tref.SPAN_KEYS))
    for span in (24, 8, 0, 8192):
        with pytest.raises(ValueError):
            paged_prefill_attention(q, kp, vp, bt, qs, ql, span=span)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_moe_combine_deterministic(dtype):
    """The moe dispatch and combine at top_k 6 (deepseek-v2's) on the
    card, some slots dropped: the tables equal the CPU's, five combines
    bit-identical and equal to the CPU's on the same inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    from repro_torch.models.moe import _capacity, build_dispatch, combine
    rng = np.random.default_rng(0)
    E, T, d, k = 160, 256, 512, 6
    C = _capacity(T, k, E, 1.25)
    sel = np.stack([rng.permutation(E)[:k] for _ in range(T)])
    sel[T - 40:] = sel[T - 41]
    sel = torch.from_numpy(sel)
    wts = torch.from_numpy(rng.random((T, k)).astype(np.float32))
    cpu = build_dispatch(sel, wts, E, C, slots=True)
    gpu = build_dispatch(sel.cuda(), wts.cuda(), E, C, slots=True)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(gpu, cpu))
    assert (cpu[2] == E * C).any()
    contrib = torch.from_numpy(rng.standard_normal((E, C, d)).astype(
        np.float32)).to(TDT[dtype])
    want = combine(cpu[2], contrib)
    runs = [combine(gpu[2], contrib.cuda()) for _ in range(5)]
    assert all(torch.equal(r, runs[0]) for r in runs)
    assert torch.equal(runs[0].cpu(), want)
