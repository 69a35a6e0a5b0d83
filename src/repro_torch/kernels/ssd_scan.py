"""Mamba2 SSD chunked scan: the wrapper of the hand-written Hopper
kernel in ``csrc/ssd_scan.cu``.

It replaces the Pallas TPU kernel of the JAX package
(``repro/kernels/ssd_scan.py``), which computes the mamba2 model's
``ssd_chunked`` from a zero state — what every prefill starts from.
What bounds it on an H100 is the intra-chunk ``C B^T`` arithmetic in
f32; the source file says what the design does about that.

The contract is the TPU kernel's: zero initial state, chunk
``cs = min(chunk, L)`` with ``L % cs == 0`` and ``cs <= 256``, inputs
f32 or bf16, the state and every sum f32, Y in X's dtype.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
plain version, the model's ``models.ssm.ssd_chunked`` on the inputs in
f32. The wrapper counts its kernel launches in its ``launches``
attribute.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import library

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_CHUNK = 256
_MAX_STATE = 128
_P_TILE = 16                             # columns of P per block

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = library("ssd_scan")
    if not getattr(lib, "_typed", False):
        lib.ssd_scan_launch.argtypes = [
            _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
        lib.ssd_scan_launch.restype = _I
        lib._typed = True
    return lib


def _check(X, dA, B_mat, C_mat, cs):
    if X.dtype not in _DTYPES:
        raise TypeError(f"X dtype {X.dtype}: the kernel takes float32 or "
                        "bfloat16")
    for name, t in (("dA", dA), ("B_mat", B_mat), ("C_mat", C_mat)):
        if t.device != X.device or t.dtype != X.dtype:
            raise TypeError(f"{name} must be {X.dtype} on {X.device}")
    b, l, h, p = X.shape
    n = B_mat.shape[-1]
    if dA.shape != (b, l, h) or B_mat.shape != (b, l, h, n) \
            or C_mat.shape != B_mat.shape:
        raise ValueError("dA must be [B, L, H] and B_mat/C_mat both "
                         "[B, L, H, N]")
    if cs > _MAX_CHUNK or p % _P_TILE or n % 16 or n > _MAX_STATE:
        raise ValueError(f"chunk {cs} > {_MAX_CHUNK}, head_dim {p} not a "
                         f"multiple of {_P_TILE} or state {n} not a "
                         f"multiple of 16 up to {_MAX_STATE}")
    for name, t in (("X", X), ("dA", dA), ("B_mat", B_mat),
                    ("C_mat", C_mat)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def ssd_scan(X, dA, B_mat, C_mat, *, chunk: int = 64):
    """X [B, L, H, P] (dt-scaled), dA [B, L, H], B_mat/C_mat [B, L, H, N]
    -> (Y [B, L, H, P] in X's dtype, final state [B, H, P, N] f32)."""
    b, l, h, p = X.shape
    cs = min(chunk, l)
    if l % cs:
        raise ValueError(f"length {l} is not a multiple of chunk {cs}")
    if X.device.type == "cpu":
        # imported here: models.ssm calls this wrapper
        from repro_torch.models.ssm import ssd_chunked
        Y, state = ssd_chunked(X.float(), dA.float(), B_mat.float(),
                               C_mat.float(), cs)
        return Y.to(X.dtype), state
    if X.device.type != "cuda":
        raise ValueError(f"no kernel for device {X.device}")
    _check(X, dA, B_mat, C_mat, cs)
    n = B_mat.shape[-1]
    Y = torch.empty_like(X)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=X.device)
    err = _lib().ssd_scan_launch(
        _DTYPES[X.dtype], X.data_ptr(), dA.data_ptr(), B_mat.data_ptr(),
        C_mat.data_ptr(), Y.data_ptr(), state.data_ptr(), b, l, h, p, n, cs,
        torch.cuda.current_stream(X.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err}")
    ssd_scan.launches += 1
    return Y, state


ssd_scan.launches = 0
