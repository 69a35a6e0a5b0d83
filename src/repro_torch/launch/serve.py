"""Serving launcher for the port: runs the scripted multi-turn
conversation on the paged engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --engine real
  PYTHONPATH=src python -m repro_torch.launch.serve --engine real \\
      --device cpu --config tiny

``--config qwen2-1.5b`` (the default) serves the published width
(28 layers, bf16) with random weights drawn from ``--seed``; ``tiny`` is
the reduced two-layer f32 variant the CPU tests use. Only ``--engine
real`` is ported so far; the live gateway comes in a later slice.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.models.model import init_params
from repro_torch.serving.paged_engine import run_multiturn_demo

# the demo's page counts and per-page transfer times are the reference
# script's at any width: pages hold 8 * token_scale tokens, every
# prompt and reply is token_scale times longer, and the modeled PCIe
# rate scales with the page's bytes (a full-width bf16 page is
# 28 layers x K,V x 16 slots x 2 heads x 128 x 2 B = 458,752 B, 112x the
# tiny config's 4,096 B page, so 0.01 GB/s becomes 1.12 GB/s)
DEMOS = {
    "tiny": dict(page_size=8, token_scale=1, pcie_gb_s=0.01),
    "qwen2-1.5b": dict(page_size=16, token_scale=2, pcie_gb_s=1.12),
}


def build_config(name: str):
    if name == "tiny":
        return reduced(get_config("qwen2-1.5b"), layers=2, d_model=64,
                       vocab=503)
    return get_config(name)


def build_demo(config: str, device, seed: int = 0):
    """(cfg, params, demo kwargs) for ``run_multiturn_demo``: weights are
    random, drawn from a ``torch.Generator`` on ``device`` seeded with
    ``seed``."""
    dev = resolve_device(device)
    cfg = build_config(config)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(cfg, gen, dev)
    return cfg, params, dict(DEMOS[config], seed=seed, device=dev)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--engine", default="real", choices=["real"],
                    help="real: the scripted multi-turn paged-engine "
                         "conversation")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--config", default="qwen2-1.5b", choices=list(DEMOS))
    ap.add_argument("--fused-step", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="run each round's whole token budget as one "
                         "fused step (default) or on the per-token plane")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    cfg, params, kw = build_demo(args.config, args.device, args.seed)
    try:
        out = run_multiturn_demo(
            cfg, params, fused_step=args.fused_step,
            log=(lambda *_a, **_k: None) if args.json else print, **kw)
    except NotImplementedError as e:
        ap.error(str(e))
    if args.json:
        print(json.dumps(out, indent=1, default=str))


if __name__ == "__main__":
    main()
