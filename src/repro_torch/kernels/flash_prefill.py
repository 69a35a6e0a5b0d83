"""Dense prefill attention: the wrapper of the hand-written Hopper kernel
in ``csrc/flash_prefill.cu``.

It replaces the Pallas TPU kernel of the JAX package
(``repro/kernels/flash_prefill.py``), which the ring-cache model's
prefill computes as its masked ``gqa_attention``. What bounds it on an
H100 is the causal QK^T and PV arithmetic at prompt lengths; the source
file says what the design does about that. The type picks the
arithmetic: float32 runs on CUDA cores in f32, bfloat16 on the tensor
cores (FlashAttention-2 on ``mma.sync``, with P rounded to bf16 before
PV).

The contract is the TPU kernel's (``causal``, ``window``, ``q_offset``,
q/k/v ``[B, H, S, D]``, f32 or bf16, GQA through ``h // G``) except that
``Sq`` and ``Skv`` may be any length: the kernel bounds-checks its tiles.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
plain version ``ref.flash_prefill_ref``. The wrapper counts its kernel
launches in its ``launches`` attribute.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import library

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)                  # the instantiations in the .cu

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = library("flash_prefill")
    if not getattr(lib, "_typed", False):
        lib.flash_prefill_launch.argtypes = [
            _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
            ctypes.c_float, _P]
        lib.flash_prefill_launch.restype = _I
        lib._typed = True
    return lib


def _check(q, k, v, window, q_offset):
    if q.dtype not in _DTYPES:
        raise TypeError(f"q dtype {q.dtype}: the kernel takes float32 or "
                        "bfloat16")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise TypeError(f"{name} must be {q.dtype} on {q.device}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("q must be [B, Hq, Sq, D] and k/v both "
                         "[B, Hkv, Skv, D]")
    B, Hq, _, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or Hq % k.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} does not fit k/v "
                         f"{tuple(k.shape)}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {_HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"window {window} must be >= 1")
    if q_offset < 0:
        raise ValueError(f"q_offset {q_offset} must be >= 0")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             "aligned")


def flash_prefill(q, k, v, *, causal: bool = True, window=None,
                  q_offset: int = 0):
    """q [B, Hq, Sq, D], k/v [B, Hkv, Skv, D] -> [B, Hq, Sq, D].

    Query row t sits at position ``q_offset + t``; it attends to keys
    ``<= q_offset + t`` when ``causal`` and to the last ``window``
    positions when a window is given."""
    if q.device.type == "cpu":
        return ref.flash_prefill_ref(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check(q, k, v, window, q_offset)
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    err = _lib().flash_prefill_launch(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), B, Hq, Hkv, Sq, Skv, D, int(causal), window or 0,
        q_offset, 1.0 / math.sqrt(D),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_prefill launch failed: CUDA error {err}")
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0
