"""The port's kernels against the JAX package's: paged attention, dense
prefill attention and the SSD scan.

On the CPU the port's wrappers take their plain versions; these are held
against the Pallas kernels (interpret mode, as tests/test_kernels.py and
tests/test_fused_step.py run them) and against the JAX oracles in
``repro.kernels.ref``, on the same inputs made with numpy. Tolerances
are the reference's own: 2e-5 in f32 and 2e-2 in bf16 (four times that
for the SSD scan, whose recurrence accumulates error over the
sequence). Only valid query rows of the paged kernels are compared
(padding rows are unspecified).

The CUDA kernels themselves run only on the card:
``tests/test_torch_cuda.py`` holds them there (``python3 chip_smoke.py``
does the same at the engine's shapes).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_prefill import flash_prefill as j_flash
from repro.kernels.paged_attention import paged_attention as j_decode
from repro.kernels.paged_attention import \
    paged_prefill_attention as j_prefill
from repro.kernels.ssd_scan import ssd_scan as j_ssd_scan
from repro.models.ssm import ssd_chunked as j_ssd_chunked
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_prefill import flash_prefill
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_prefill_attention)
from repro_torch.kernels.ssd_scan import ssd_scan
from test_torch_cuda import (PREFILL_SHAPES, TDT, TOL, _prefill_case,
                             _valid_close, flash_case, ssd_case)

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _both(a: np.ndarray, dtype: str):
    """One numpy array as a JAX array and a torch tensor of ``dtype``
    (float inputs are rounded to bf16 identically in both)."""
    if a.dtype.kind == "f":
        return jnp.asarray(a, JDT[dtype]), torch.from_numpy(a).to(TDT[dtype])
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Q,Hq,Hkv,D,page,pps", PREFILL_SHAPES)
def test_prefill_plain_matches_jax(B, Q, Hq, Hkv, D, page, pps, dtype):
    arrays = _prefill_case(0, B, Q, Hq, Hkv, D, page, pps)
    j, t = zip(*(_both(a, dtype) for a in arrays))
    got = paged_prefill_attention(*t)
    assert got.dtype == TDT[dtype] and got.shape == (B, Q, Hq, D)
    got = got.float().numpy()
    ql = arrays[-1]
    tol = TOL[dtype]
    _valid_close(got, j_prefill(*j, interpret=True), ql, tol)
    _valid_close(got, jref.paged_prefill_attention_ref(*j), ql, tol)
    # padding rows come out finite (zeros in the plain version)
    assert np.isfinite(got).all()


DECODE_SHAPES = [
    (1, 2, 2, 16, 8, 2),
    (3, 8, 2, 32, 8, 5),
    (2, 4, 1, 64, 16, 4),
    (4, 16, 8, 32, 4, 8),
    (4, 12, 2, 128, 16, 5),      # qwen2-1.5b heads
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,D,page,pps", DECODE_SHAPES)
def test_decode_plain_matches_jax(B, Hq, Hkv, D, page, pps, dtype):
    rng = np.random.default_rng(1)
    P = B * pps + 3
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    kp = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    bt = rng.permutation(P)[:B * pps].reshape(B, pps).astype(np.int32)
    # ragged lengths incl. a partially-filled last page and a 1-token seq
    sl = np.array([(i * 7) % (page * pps) + 1 for i in range(B)], np.int32)
    j, t = zip(*(_both(a, dtype) for a in (q, kp, vp, bt, sl)))
    got = paged_attention(*t)
    assert got.dtype == TDT[dtype] and got.shape == (B, Hq, D)
    got = got.float().numpy()
    tol = TOL[dtype]
    for want in (j_decode(*j, interpret=True), jref.paged_attention_ref(*j)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


def test_plain_q1_prefill_matches_decode():
    """At Q = 1 the fused function is the decode function (the kernels
    agree bit for bit on the card; the plain versions to f32 rounding)."""
    q, kp, vp, bt, qs, _ = (torch.from_numpy(a) for a in
                            _prefill_case(3, 3, 1, 8, 2, 32, 8, 5))
    got = paged_prefill_attention(q, kp, vp, bt, qs, torch.ones_like(qs))
    want = paged_attention(q[:, 0].contiguous(), kp, vp, bt, qs + 1)
    torch.testing.assert_close(got[:, 0], want, rtol=2e-5, atol=2e-5)


def test_wrapper_rejects_devices_without_a_kernel():
    """Only CPU tensors take the plain version; any other non-CUDA
    device raises instead of computing somewhere else."""
    q = torch.empty((1, 2, 16), device="meta")
    kp = torch.empty((3, 4, 1, 16), device="meta")
    bt = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    sl = torch.ones((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        paged_attention(q, kp, kp, bt, sl)
    with pytest.raises(ValueError, match="no kernel"):
        paged_prefill_attention(q[:, None], kp, kp, bt, sl, sl)


# the six shapes of tests/test_kernels.py::test_flash_prefill_sweep; the
# Pallas kernel's tiles bq/bkv apply to the JAX side only
FLASH_SHAPES = [  # B, Hq, Hkv, Sq, Skv, D, bq, bkv, window, q_offset
    (1, 2, 2, 32, 32, 16, 8, 8, None, 0),       # MHA causal
    (2, 8, 2, 64, 64, 32, 16, 16, None, 0),     # GQA
    (1, 4, 1, 128, 128, 64, 32, 32, None, 0),   # MQA larger
    (2, 4, 4, 64, 64, 16, 16, 16, 24, 0),       # sliding window
    (1, 8, 2, 32, 96, 32, 16, 16, None, 64),    # chunked prefill offset
    (1, 4, 2, 16, 80, 16, 8, 16, 32, 64),       # offset + window
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,bq,bkv,window,q_offset",
                         FLASH_SHAPES)
def test_flash_prefill_plain_matches_jax(B, Hq, Hkv, Sq, Skv, D, bq, bkv,
                                         window, q_offset, dtype):
    j, t = zip(*(_both(a, dtype) for a in
                 flash_case(2, B, Hq, Hkv, Sq, Skv, D)))
    got = flash_prefill(*t, causal=True, window=window, q_offset=q_offset)
    assert got.dtype == TDT[dtype] and got.shape == (B, Hq, Sq, D)
    got = got.float().numpy()
    tol = TOL[dtype]
    for want in (j_flash(*j, causal=True, window=window, q_offset=q_offset,
                         block_q=bq, block_kv=bkv, interpret=True),
                 jref.flash_prefill_ref(*j, causal=True, window=window,
                                        q_offset=q_offset)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


# the four shapes of tests/test_kernels.py::test_ssd_scan_sweep
SSD_SHAPES = [  # b, l, h, p, n, chunk
    (1, 64, 1, 8, 8, 16),
    (2, 128, 3, 16, 8, 32),
    (1, 256, 2, 64, 128, 64),   # production-shaped head
    (2, 96, 4, 32, 16, 32),     # chunk not power-of-two multiple
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,l,h,p,n,chunk", SSD_SHAPES)
def test_ssd_scan_plain_matches_jax(b, l, h, p, n, chunk, dtype):
    """The kernel's plain version (the model's chunked SSD in f32) and
    the port's sequential oracle against the Pallas kernel, the JAX
    oracle and the JAX model's ``ssd_chunked``."""
    j, t = zip(*(_both(a, dtype) for a in ssd_case(3, b, l, h, p, n)))
    Y, st = ssd_scan(*t, chunk=chunk)
    assert Y.dtype == TDT[dtype] and st.dtype == torch.float32
    j32 = [jnp.asarray(x, jnp.float32) for x in j]
    wants = [j_ssd_scan(*j, chunk=chunk, interpret=True),
             jref.ssd_scan_ref(*j32), j_ssd_chunked(*j32, chunk)]
    tol = 4 * TOL[dtype]
    for got_y, got_st in ((Y, st), tref.ssd_scan_ref(*t)):
        for want_y, want_st in wants:
            np.testing.assert_allclose(got_y.float().numpy(),
                                       np.asarray(want_y, np.float32),
                                       rtol=tol, atol=tol)
            np.testing.assert_allclose(got_st.numpy(), np.asarray(want_st),
                                       rtol=tol, atol=tol)


# B/C per group: one group (mamba2-1.3b's), 1 < G < H, and G = H
SSD_GROUP_SHAPES = [  # b, l, h, g, p, n, chunk
    (1, 64, 4, 1, 8, 8, 16),
    (2, 96, 6, 2, 16, 16, 32),
    (1, 256, 4, 1, 64, 128, 64),   # production-shaped head, one group
    (2, 128, 6, 3, 16, 8, 32),
    (1, 32, 2, 2, 8, 16, 32),      # G = H, L = chunk
]
SSD_TYPES = [("float32", "float32"), ("float32", "bfloat16"),
             ("bfloat16", "bfloat16"),
             ("bfloat16", "float32")]     # (X and dA, B and C)


@pytest.mark.parametrize("x_dtype,bc_dtype", SSD_TYPES)
@pytest.mark.parametrize("b,l,h,g,p,n,chunk", SSD_GROUP_SHAPES)
def test_ssd_scan_groups_plain_matches_jax(b, l, h, g, p, n, chunk,
                                           x_dtype, bc_dtype):
    """The wrapper's extended contract: B/C [b, l, g, n] read by head h
    as group h // (h / g), in their own type (bf16 beside f32 X is the
    model's form), against the Pallas kernel and the JAX model's
    ``ssd_chunked`` fed the same values repeated over the heads in f32
    (a bf16 value upcasts exactly, so the tolerance is X's type's)."""
    X, dA, B, C = ssd_case(4, b, l, h, p, n, g)
    (jX, tX), (jdA, tdA) = _both(X, x_dtype), _both(dA, x_dtype)
    tB, tC = (torch.from_numpy(a).to(TDT[bc_dtype]) for a in (B, C))
    Y, st = ssd_scan(tX, tdA, tB, tC, chunk=chunk)
    assert Y.dtype == TDT[x_dtype] and Y.shape == (b, l, h, p)
    assert st.dtype == torch.float32 and st.shape == (b, h, p, n)
    jB, jC = (jnp.repeat(jnp.asarray(t.float().numpy()), h // g, axis=2)
              for t in (tB, tC))
    j32 = [jnp.asarray(x, jnp.float32) for x in (jX, jdA)] + [jB, jC]
    tol = 4 * TOL[x_dtype]
    for want_y, want_st in (
            j_ssd_scan(jX, jdA, jB, jC, chunk=chunk, interpret=True),
            j_ssd_chunked(*j32, chunk)):
        np.testing.assert_allclose(Y.float().numpy(),
                                   np.asarray(want_y, np.float32),
                                   rtol=tol, atol=tol)
        np.testing.assert_allclose(st.numpy(), np.asarray(want_st),
                                   rtol=tol, atol=tol)


def test_ssd_scan_rejects_groups_that_do_not_divide_heads():
    X, dA, B, C = (torch.from_numpy(a) for a in
                   ssd_case(0, 1, 16, 6, 8, 8, 4))
    with pytest.raises(ValueError, match="groups"):
        ssd_scan(X, dA, B, C, chunk=16)


class _OnDevice:
    """A stand-in for a tensor on ``device`` (a device this host has no
    backend for): the wrappers read its shape and device and must
    raise before touching anything else."""

    def __init__(self, shape, device):
        self.shape = torch.Size(shape)
        self.device = torch.device(device)

    def dim(self):
        return len(self.shape)


def test_new_wrappers_reject_devices_without_a_kernel():
    """A device with neither a kernel nor a plain version raises. Meta
    tensors, the dry run's, take the plain version's arithmetic
    (``launch/dryrun.py``): its shapes and types come back."""
    for device in ("mps", "xpu"):
        q = _OnDevice((1, 2, 4, 64), device)
        with pytest.raises(ValueError, match="no kernel"):
            flash_prefill(q, q, q)
        X = _OnDevice((1, 32, 2, 16), device)
        dA = _OnDevice((1, 32, 2), device)
        B = _OnDevice((1, 32, 2, 16), device)
        with pytest.raises(ValueError, match="no kernel"):
            ssd_scan(X, dA, B, B, chunk=16)
    q = torch.empty((1, 2, 4, 64), device="meta", dtype=torch.bfloat16)
    out = flash_prefill(q, q, q)
    assert out.device.type == "meta" and out.shape == q.shape \
        and out.dtype == q.dtype
    X = torch.empty((1, 32, 2, 16), device="meta")
    dA = torch.empty((1, 32, 2), device="meta")
    B = torch.empty((1, 32, 1, 16), device="meta", dtype=torch.bfloat16)
    Y, state = ssd_scan(X, dA, B, B, chunk=16)
    assert Y.device.type == "meta" and Y.shape == X.shape
    assert state.shape == (1, 2, 16, 16) and state.dtype == torch.float32
