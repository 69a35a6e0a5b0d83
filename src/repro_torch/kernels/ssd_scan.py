"""Mamba2 SSD chunked scan: the wrapper of the hand-written Hopper
kernel in ``csrc/ssd_scan.cu``.

It replaces the Pallas TPU kernel of the JAX package
(``repro/kernels/ssd_scan.py``), which computes the mamba2 model's
``ssd_chunked`` from a zero state — what every prefill starts from.
What bounds it on an H100 is the f32 arithmetic of the products with X
and with the carried state; the source file says what the design does
about that.

The contract is a superset of the TPU kernel's: zero initial state,
chunk ``cs = min(chunk, L)`` with ``L % cs == 0`` and ``cs <= 256``; X
and dA f32 or bf16 (one type), Y in that type; the state and every sum
f32. ``B_mat``/``C_mat`` are ``[B, L, G, N]`` for any G that divides H
(head h reads group ``h // (H // G)``, the order of ``jnp.repeat`` and
``repeat_interleave`` over the heads; G = H is the TPU kernel's
contract), f32 or bf16 whatever X's type: like the TPU kernel, the
kernel takes each input to f32 on its own.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
plain version, the model's ``models.ssm.ssd_chunked`` on the inputs in
f32 with B and C repeated over the heads, and so does a meta tensor
(the dry run traces the plain version's arithmetic); any other device
raises. ``ssd_scan.launches`` counts
calls of the function that reached the card (one call issues four
kernel launches on the caller's stream).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import library

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_CHUNK = 256
_MAX_STATE = 128
_P_TILE = 16                             # head_dim must be a multiple

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _lib():
    lib = library("ssd_scan")
    if not getattr(lib, "_typed", False):
        lib.ssd_scan_work_floats.argtypes = [_I] * 7
        lib.ssd_scan_work_floats.restype = _L
        lib.ssd_scan_launch.argtypes = [
            _I, _I, _P, _P, _P, _P, _P, _P, _P, _L,
            _I, _I, _I, _I, _I, _I, _I, _P]
        lib.ssd_scan_launch.restype = _I
        lib._typed = True
    return lib


def _check(X, dA, B_mat, C_mat, cs):
    for name, t in (("X", X), ("B_mat", B_mat)):
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} dtype {t.dtype}: the kernel takes "
                            "float32 or bfloat16")
    if dA.dtype != X.dtype or C_mat.dtype != B_mat.dtype:
        raise TypeError("dA must have X's dtype and C_mat B_mat's")
    for name, t in (("dA", dA), ("B_mat", B_mat), ("C_mat", C_mat)):
        if t.device != X.device:
            raise TypeError(f"{name} must be on {X.device}")
    b, l, h, p = X.shape
    g, n = B_mat.shape[-2:]
    if dA.shape != (b, l, h) or B_mat.shape != (b, l, g, n) \
            or C_mat.shape != B_mat.shape or h % g:
        raise ValueError("dA must be [B, L, H] and B_mat/C_mat both "
                         "[B, L, G, N] with G dividing H")
    if cs > _MAX_CHUNK or p % _P_TILE or n % 16 or n > _MAX_STATE:
        raise ValueError(f"chunk {cs} > {_MAX_CHUNK}, head_dim {p} not a "
                         f"multiple of {_P_TILE} or state {n} not a "
                         f"multiple of 16 up to {_MAX_STATE}")
    for name, t in (("X", X), ("dA", dA), ("B_mat", B_mat),
                    ("C_mat", C_mat)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def ssd_scan(X, dA, B_mat, C_mat, *, chunk: int = 64):
    """X [B, L, H, P] (dt-scaled), dA [B, L, H], B_mat/C_mat
    [B, L, G, N] with G | H -> (Y [B, L, H, P] in X's dtype, final state
    [B, H, P, N] f32)."""
    b, l, h, p = X.shape
    g, n = B_mat.shape[-2:]
    cs = min(chunk, l)
    if l % cs:
        raise ValueError(f"length {l} is not a multiple of chunk {cs}")
    if X.device.type in ("cpu", "meta"):
        # imported here: models.ssm calls this wrapper
        from repro_torch.models.ssm import ssd_chunked
        if h % g:
            raise ValueError(f"{g} groups do not divide {h} heads")
        Bh, Ch = (t.float().repeat_interleave(h // g, dim=2)
                  for t in (B_mat, C_mat))
        Y, state = ssd_chunked(X.float(), dA.float(), Bh, Ch, cs)
        return Y.to(X.dtype), state
    if X.device.type != "cuda":
        raise ValueError(f"no kernel for device {X.device}")
    _check(X, dA, B_mat, C_mat, cs)
    lib = _lib()
    floats = lib.ssd_scan_work_floats(b, l, h, g, p, n, cs)
    if floats < 0:
        raise ValueError(f"ssd_scan does not take shape B {b} L {l} H {h} "
                         f"G {g} P {p} N {n} chunk {cs}")
    Y = torch.empty_like(X)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=X.device)
    work = torch.empty(floats, dtype=torch.float32, device=X.device)
    err = lib.ssd_scan_launch(
        _DTYPES[X.dtype], _DTYPES[B_mat.dtype], X.data_ptr(), dA.data_ptr(),
        B_mat.data_ptr(), C_mat.data_ptr(), Y.data_ptr(), state.data_ptr(),
        work.data_ptr(), floats, b, l, h, g, p, n, cs,
        torch.cuda.current_stream(X.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err}")
    ssd_scan.launches += 1
    return Y, state


ssd_scan.launches = 0
