"""Training launcher (single device).

The JAX package's ``launch/train.py`` on the port: the reference's
flags plus ``--device`` (default ``cuda``; ``cpu`` for the reduced
configs here). The reference's ``--mesh`` and ``--distributed`` wait
for the mesh half of training and are refused before any model is
built.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch qwen3-4b --reduced --steps 50 --batch 8 --seq 256
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --steps 20 --batch 8 --seq 256 --ckpt-dir CKPT [--resume]
"""
from __future__ import annotations

import argparse

import torch


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mesh", default=None,
                    help="'DxM' data x model mesh (not ported yet)")
    ap.add_argument("--distributed", action="store_true",
                    help="multi-host initialisation (not ported yet)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    for flag, on in (("--mesh", args.mesh), ("--distributed",
                                             args.distributed)):
        if on:
            ap.error(f"{flag} is not ported yet (ROADMAP.md queue 1 "
                     "item 7)")

    from repro_torch.configs import get_config, reduced
    from repro_torch.device import resolve_device
    from repro_torch.models.model import init_params
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training.checkpoint import (latest_step,
                                                 restore_checkpoint)
    from repro_torch.training.data import synthetic_batches
    from repro_torch.training.train_loop import TrainConfig, train_loop

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    opt = opt_mod.select_optimizer(cfg)
    state = opt_mod.opt_init(opt, params)
    if args.resume and args.ckpt_dir and latest_step(args.ckpt_dir):
        del params, state
        tree, start = restore_checkpoint(args.ckpt_dir, device=dev)
        params, state = tree["params"], tree["opt_state"]
        print(f"resumed from step {start}")

    data = synthetic_batches(cfg.vocab_size, args.batch, args.seq)
    params, state, hist = train_loop(
        cfg, params, state, data, steps=args.steps, opt=opt,
        tc=TrainConfig(microbatches=args.microbatches, remat=False),
        checkpoint_every=20 if args.ckpt_dir else 0,
        ckpt_dir=args.ckpt_dir)
    for step, loss in hist[-5:]:
        print(f"step {step:5d} loss {loss:.4f}")


if __name__ == "__main__":
    main()
