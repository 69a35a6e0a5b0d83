"""Input specs for every (arch x input-shape) cell of the dry run: the
JAX package's ``launch/specs.py`` on meta tensors.

Every spec is a meta tensor (shape and dtype, no storage), so nothing
is allocated; the shapes and dtypes are the reference's
``ShapeDtypeStruct``s leaf for leaf. Modality frontends are stubs, as
in the reference: whisper gets precomputed frame embeddings, paligemma
precomputed patch embeddings.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.models import model as M


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


@dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str              # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}


def cell_supported(cfg, shape_name: str) -> Optional[str]:
    """None if runnable; otherwise the skip reason (recorded in the table)."""
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return ("full quadratic attention: 500k-token decode needs "
                "sub-quadratic state (DESIGN.md §6)")
    return None


def param_shapes(cfg):
    """The parameter tree's full shapes, as meta tensors."""
    return M.param_shapes(cfg)


def cache_shapes(cfg, batch: int, capacity: int):
    enc = cfg.encoder.num_frames if cfg.family == "encdec" else 0
    return M.init_cache(cfg, batch, capacity, "meta", enc_frames=enc)


def batch_specs(cfg, cell: ShapeCell) -> dict:
    """The training batch's meta tensors."""
    B, S = cell.global_batch, cell.seq_len
    d = cfg.d_model
    dt = getattr(torch, cfg.dtype)
    if cfg.frontend == "vision":
        P = cfg.frontend_len
        return {
            "tokens": _meta((B, S - P), torch.int32),
            "labels": _meta((B, S - P), torch.int32),
            "patches": _meta((B, P, d), dt),
            "prefix_len": _meta((B,), torch.int32),
        }
    out = {"tokens": _meta((B, S), torch.int32),
           "labels": _meta((B, S), torch.int32)}
    if cfg.family == "encdec":
        out["frames"] = _meta((B, cfg.encoder.num_frames, d), dt)
    return out


def prefill_specs(cfg, cell: ShapeCell):
    """(tokens, cache, extras) meta tensors for a prefill step."""
    B, S = cell.global_batch, cell.seq_len
    d = cfg.d_model
    dt = getattr(torch, cfg.dtype)
    extras = {}
    S_text = S
    if cfg.frontend == "vision":
        P = cfg.frontend_len
        S_text = S - P
        extras["frontend_embeds"] = _meta((B, P, d), dt)
        extras["prefix_len"] = _meta((B,), torch.int32)
    if cfg.family == "encdec":
        extras["enc_frames"] = _meta((B, cfg.encoder.num_frames, d), dt)
    tokens = _meta((B, S_text), torch.int32)
    cache = cache_shapes(cfg, B, S)
    return tokens, cache, extras


def decode_specs(cfg, cell: ShapeCell):
    """(tokens, cache) for a single decode step over a seq_len-deep cache."""
    B, S = cell.global_batch, cell.seq_len
    tokens = _meta((B,), torch.int32)
    cache = cache_shapes(cfg, B, S)
    return tokens, cache


def model_flops(cfg, cell: ShapeCell) -> float:
    """Reference useful-FLOPs: 6*N_active*D for training, 2*N_active*D for
    inference (D = tokens processed in the step)."""
    n = cfg.num_active_params()
    if cell.kind == "train":
        return 6.0 * n * cell.global_batch * cell.seq_len
    if cell.kind == "prefill":
        return 2.0 * n * cell.global_batch * cell.seq_len
    return 2.0 * n * cell.global_batch          # decode: one token per seq
