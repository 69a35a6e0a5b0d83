"""Training launcher.

The JAX package's ``launch/train.py`` on the port: the reference's
flags plus ``--device`` (default ``cuda``; ``cpu`` for the reduced
configs here). ``--mesh DxM`` trains over a ('data', 'model') mesh of
D * M rank processes started from this one (``launch/mesh.py::spawn``;
ranks that share a card talk gloo), every family;
``--distributed`` takes the ranks from ``torchrun``'s environment
instead (one process a rank, ``init_method="env://"``) and needs
``--mesh`` with D * M ranks. ``--layers N`` trains the config's first
N layers at its full width. Rank 0 prints the losses.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch qwen3-4b --reduced --steps 50 --batch 8 --seq 256
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --steps 20 --batch 8 --seq 256 --ckpt-dir CKPT [--resume]
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch qwen2-1.5b --reduced --steps 3 --batch 2 --seq 64 --mesh 1x2
  PYTHONPATH=src torchrun --nproc_per_node 2 -m repro_torch.launch.train \\
      --device cpu --reduced --distributed --mesh 1x2
"""
from __future__ import annotations

import argparse
import os

import torch


def prepare(args: dict, mesh=None) -> dict:
    """What a run of ``args`` trains, on one device or as this rank of
    ``mesh``: the config, the optimizer, the rules (None off a mesh),
    the parameters drawn from seed 0 (on a mesh this rank's blocks of
    them) and their optimizer state, or both restored by ``resume``, the
    step resumed from (or None) and the synthetic batches."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.device import resolve_device
    from repro_torch.distributed.sharding import ShardingRules, local_block
    from repro_torch.models.model import init_params, param_shapes
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training.checkpoint import (latest_step,
                                                 restore_checkpoint)
    from repro_torch.training.data import synthetic_batches

    dev = mesh.device if mesh is not None else resolve_device(args["device"])
    cfg = get_config(args["arch"])
    if args["reduced"]:
        cfg = reduced(cfg)
    if args["layers"] is not None:
        cfg = cfg.replace(num_layers=args["layers"])
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    opt = opt_mod.select_optimizer(cfg)
    rules = specs = None
    if mesh is not None:
        rules = ShardingRules(cfg, mesh)
        specs = rules.params(param_shapes(cfg))
        params = opt_mod.tree_map(
            lambda t, s: local_block(t, s, mesh).clone(), params, specs)
    state = opt_mod.opt_init(opt, params, mesh, specs)
    start, ckpt = None, args["ckpt_dir"]
    if args["resume"] and ckpt and latest_step(ckpt):
        del params, state
        tree, start = restore_checkpoint(
            ckpt, device=dev,
            shardings=None if mesh is None else (rules, mesh))
        params, state = tree["params"], tree["opt_state"]
    return dict(cfg=cfg, opt=opt, rules=rules, params=params, state=state,
                start=start, data=synthetic_batches(
                    cfg.vocab_size, args["batch"], args["seq"]))


def _train(args: dict, mesh=None) -> tuple:
    """Train as ``args`` say (``prepare``, then ``train_loop``); returns
    (the step resumed from or None, the loss history)."""
    from repro_torch.training.train_loop import TrainConfig, train_loop
    run = prepare(args, mesh)
    ckpt = args["ckpt_dir"]
    _, _, hist = train_loop(
        run["cfg"], run.pop("params"), run.pop("state"), run["data"],
        steps=args["steps"], opt=run["opt"],
        tc=TrainConfig(microbatches=args["microbatches"], remat=False),
        mesh=mesh, rules=run["rules"], checkpoint_every=20 if ckpt else 0,
        ckpt_dir=ckpt)
    return run["start"], hist


def train_rank(mesh, args: dict) -> tuple:
    """One rank of ``--mesh``: ``_train`` on its blocks."""
    return _train(args, mesh)


def _report(start, hist) -> None:
    if start is not None:
        print(f"resumed from step {start}")
    for step, loss in hist[-5:]:
        print(f"step {step:5d} loss {loss:.4f}")


def main(argv=None) -> None:
    from repro_torch.launch.mesh import parse_mesh
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config")
    ap.add_argument("--layers", type=int, default=None,
                    help="train the config's first N layers (default all)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mesh", default=None,
                    help="'DxM' data x model mesh (default: single device)")
    ap.add_argument("--distributed", action="store_true",
                    help="ranks from torchrun's environment (needs --mesh)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.layers is not None and args.layers < 1:
        ap.error("--layers must be >= 1")
    if args.mesh is not None:
        try:
            d, m = parse_mesh(args.mesh)
        except ValueError as e:
            ap.error(str(e))
    if args.distributed:
        if args.mesh is None:
            ap.error("--distributed needs --mesh DxM")
        world = os.environ.get("WORLD_SIZE")
        if world is None or "RANK" not in os.environ:
            ap.error("--distributed needs torchrun's RANK and WORLD_SIZE")
        if d * m != int(world):
            ap.error(f"--mesh {args.mesh} has {d * m} ranks, WORLD_SIZE "
                     f"is {world}")
    conf = vars(args)

    if args.distributed:
        import torch.distributed as dist
        from repro_torch.launch.mesh import make_serving_mesh
        mesh = make_serving_mesh(args.mesh, rank=int(os.environ["RANK"]),
                                 init_method="env://", device=args.device)
        try:
            out = _train(conf, mesh)
        finally:
            dist.destroy_process_group()
        if mesh.is_leader:
            _report(*out)
    elif args.mesh is not None:
        from repro_torch.launch.mesh import spawn
        _report(*spawn(args.mesh, train_rank, conf, device=args.device)[0])
    else:
        _report(*_train(conf))


if __name__ == "__main__":
    main()
