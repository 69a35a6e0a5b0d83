"""The port's paged-attention kernels against the JAX package's.

On the CPU the port's wrappers take their plain versions; these are held
against the Pallas kernels (interpret mode, as tests/test_kernels.py and
tests/test_fused_step.py run them) and against the JAX oracles in
``repro.kernels.ref``, on the same inputs made with numpy. Tolerances
are the reference's own: 2e-5 in f32 and 2e-2 in bf16. Only valid query
rows are compared (padding rows are unspecified).

The CUDA kernels themselves run only on the card:
``tests/test_torch_cuda.py`` holds them there (``python3 chip_smoke.py``
does the same at the engine's shapes).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.paged_attention import paged_attention as j_decode
from repro.kernels.paged_attention import \
    paged_prefill_attention as j_prefill
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_prefill_attention)
from test_torch_cuda import (PREFILL_SHAPES, TDT, TOL, _prefill_case,
                             _valid_close)

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
