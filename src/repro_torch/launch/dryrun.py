"""The dry run: every (architecture x input shape x mesh) cell traced on
meta tensors over a placeholder production mesh, with its roofline
terms on one NVIDIA H100 (the JAX package's ``launch/dryrun.py``).

For each cell, rank 0's program (the train step, a prefill or a decode
step, as the card would run it over the mesh) is built on meta
parameters, optimizer state, batch and cache from ``launch/specs.py``,
each the block ``ShardingRules`` gives rank 0, and traced once:

- flops a device from ``torch.utils.flop_counter.FlopCounterMode``:
  matmuls, convolutions and attention, no elementwise work (XLA's
  ``cost_analysis`` counts elementwise work too);
- bytes a device: every aten op's input and output bytes summed, each
  tensor once an op (views move nothing), the unfused count: a fused
  kernel reads and writes less;
- collective bytes a device by kind, from the recorder of
  ``distributed/collectives.py`` (the placeholder mesh moves nothing);
- memory, under the reference's ``memory_analysis`` keys: the rank's
  arguments (parameters, optimizer state, its rows of the batch, its
  block of the cache), the outputs, and the peak of the storages the
  trace holds live (``temp`` is that peak less the new outputs), from a
  dispatch mode that follows every storage the trace makes until it is
  freed.

The port's layers are a Python loop, so the count at full depth is
exact: there is no calibration to correct. The JSON keeps the two
shallow counts of the reference's calibration depths under
``calibration``, so that the full count can be held to the line
through them. The roofline's denominators are one H100 SXM's published
peaks at 700 W, and the fit check is against its 80 GB. Nothing is
allocated on a device: CUDA is never initialised and no rank is
spawned.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape decode_32k
  python -m repro_torch.launch.dryrun --all --both-meshes
      [--out experiments/dryrun_torch]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_config, list_configs
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import ShardingRules, local_block
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.optimizer import tree_leaves, tree_map
from repro_torch.training.train_loop import TrainConfig, build_train_step

# One NVIDIA H100 SXM 80GB at 700 W, published peaks (the roofline's
# denominators): dense bf16 tensor-core rate, HBM3 rate, and NVLink 4's
# 900 GB/s split into 450 GB/s each way. A 16-wide 'model' axis spans
# two 8-card NVLink hosts, so its collectives partly cross the slower
# network between hosts: the collective term is a floor.
PEAK_FLOPS = 989e12          # FLOP/s, bf16
HBM_BW = 3.35e12             # bytes/s
LINK_BW = 450e9              # bytes/s, each way
DEVICE_BYTES = 80e9          # the card's memory
CARD = "NVIDIA H100 80GB HBM3, 700 W published peaks, modeled"
OUT_DIR = "experiments/dryrun_torch"
FLOPS_COUNTER = ("torch.utils.flop_counter.FlopCounterMode: matmuls, "
                 "convolutions and attention, no elementwise work")
BYTES_COUNTER = ("each aten op's distinct input and output tensors' bytes "
                 "summed, views excluded: the unfused count")


def reduced_depth_cfg(cfg, L0: int):
    """Same architecture at depth L0 (a calibration depth)."""
    kw = {"num_layers": L0}
    if cfg.encoder is not None:
        kw["encoder"] = dataclasses.replace(cfg.encoder, num_layers=L0)
    return cfg.replace(**kw)


def calibration_depths(cfg):
    if cfg.family == "hybrid":
        pat = len(cfg.rglru.block_pattern)
        return pat, 2 * pat            # keep the block pattern intact
    return 2, 4


def microbatches_for(cfg, cell, mesh) -> int:
    """Grad-accum so per-device live attention logits stay within ~1.5 GB
    (the training graph's einsum attention materializes [B_dev/mb, H_dev,
    S, S] f32 logits)."""
    if cell.kind != "train":
        return 1
    M_ = mesh.shape["model"]
    D = mesh.size // M_
    h = cfg.num_heads
    h_dev = h // M_ if h % M_ == 0 else h
    s = cell.seq_len
    if cfg.family == "hybrid":
        s = min(s, cfg.rglru.local_window)  # mask bounds the live window
    b_dev = max(1, cell.global_batch // D)
    logits_bytes = b_dev * h_dev * cell.seq_len * s * 4
    mb = max(1, -(-logits_bytes // int(1.5e9)))
    # round to a divisor of the per-device batch
    while b_dev % mb:
        mb += 1
    return min(mb, b_dev)


# ======================================================================
# the trace
# ======================================================================
def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Meter(TorchDispatchMode):
    """Sums each op's distinct input and output tensors' bytes (view ops
    excluded), and follows every storage an op makes until it is freed:
    the bytes live now and at the peak. The arguments' storages are
    known beforehand and never counted as made."""

    def __init__(self, args):
        super().__init__()
        self.bytes = 0
        self.live = self.peak = 0
        self.known = {id(t.untyped_storage()): t.untyped_storage()
                      for t in _tensors(args)}
        self.refs = {}

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self.known or key in self.refs:
            return
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)

        def freed(_, key=key, n=n):
            self.live -= n
            self.refs.pop(key, None)
        self.refs[key] = weakref.ref(st, freed)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not getattr(func, "is_view", False):
            seen = {}
            for t in _tensors(args) + _tensors(kwargs or {}) + _tensors(out):
                seen.setdefault(id(t), t)
            self.bytes += sum(_nbytes(t) for t in seen.values())
        for t in _tensors(out):
            self._track(t)
        return out


def trace(fn, args, *, arg_bytes=None) -> dict:
    """``fn(*args)`` run once on meta tensors under the counters: flops,
    bytes, collective bytes by kind and ``memory_analysis``.
    ``arg_bytes`` (default: the arguments' own) is what the arguments
    hold on the device the program runs on."""
    meter = _Meter(args)
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc, C.recording() as coll, \
            meter, torch.no_grad():
        out = fn(*args)
    secs = time.perf_counter() - t0
    args_ids = {id(t.untyped_storage()) for t in _tensors(args)}
    outs = _tensors(out)
    aliased = sum(_nbytes(t) for t in outs
                  if id(t.untyped_storage()) in args_ids)
    new = sum(_nbytes(t) for t in outs
              if id(t.untyped_storage()) not in args_ids)
    arg = arg_bytes if arg_bytes is not None else \
        sum(_nbytes(t) for t in _tensors(args))
    coll = {k: float(v) for k, v in coll.items()}
    coll.setdefault("total", 0.0)
    return {"flops": float(fc.get_total_flops()), "bytes": float(meter.bytes),
            "collective": coll, "trace_s": secs,
            "memory": {"argument_size_in_bytes": int(arg),
                       "output_size_in_bytes": int(aliased + new),
                       "alias_size_in_bytes": int(aliased),
                       "temp_size_in_bytes": int(max(meter.peak - new, 0)),
                       "peak_memory_in_bytes": int(arg + meter.peak)}}


# ======================================================================
# a cell's program
# ======================================================================
def _local(tree, specs, mesh):
    """Meta tensors of this rank's blocks of ``tree``'s leaves."""
    return tree_map(lambda t, s: torch.empty(
        local_block(t, s, mesh).shape, dtype=t.dtype, device="meta"),
        tree, specs)


def _block_bytes(tree, specs, mesh) -> int:
    return sum(_nbytes(t) for t in tree_leaves(_local(tree, specs, mesh)))


def build_step(cfg, cell, mesh, rules, *, microbatches=None,
               capacity=None):
    """Returns (fn, args, arg_bytes, microbatches): rank 0's program of
    the cell and its meta arguments (the parameters and optimizer state
    its blocks, the batch or tokens whole as every rank takes them, the
    cache its block), and the bytes of what the rank holds of them.
    ``capacity``: a prefill's ring (default the prompt's length; a
    decode's is the cell's ``seq_len``)."""
    pspecs = rules.params(SP.param_shapes(cfg))
    params = _local(SP.param_shapes(cfg), pspecs, mesh)
    p_bytes = sum(_nbytes(t) for t in tree_leaves(params))
    if cell.kind == "train":
        if rules.expert_tp:
            raise ValueError("expert_tp is the decode cells' layer: no "
                             "backward (training takes moe_ep)")
        opt = opt_mod.select_optimizer(cfg)
        mb = (microbatches if microbatches is not None
              else microbatches_for(cfg, cell, mesh))
        tc = TrainConfig(microbatches=mb, remat=True,
                         seq_shard_activations=rules.fsdp)
        step = build_train_step(cfg, opt, tc, mesh=mesh, rules=rules)
        state = opt_mod.opt_init(opt, params, mesh, pspecs)
        batch = SP.batch_specs(cfg, cell)
        arg = p_bytes + sum(_nbytes(t) for t in tree_leaves(state)) \
            + _block_bytes(batch, rules.batch(batch), mesh)
        return step, (params, state, batch), arg, mb
    if cell.kind == "prefill":
        tokens, cache, extras = SP.prefill_specs(cfg, cell)
        cap = capacity or cell.seq_len
        if cap != cell.seq_len:
            cache = SP.cache_shapes(cfg, cell.global_batch, cap)
        cspecs = rules.cache(cache)
        local = _local(cache, cspecs, mesh)

        def step(params, tokens, cache, extras):
            return M.prefill(cfg, params, tokens, cache, mesh=mesh,
                             rules=rules, capacity=cap, **extras)
        arg = p_bytes + _block_bytes({"tokens": tokens, **extras},
                                     rules.batch({"tokens": tokens,
                                                  **extras}), mesh) \
            + sum(_nbytes(t) for t in tree_leaves(local))
        return step, (params, tokens, local, extras), arg, 1
    tokens, cache = SP.decode_specs(cfg, cell)
    cspecs = rules.cache(cache)
    local = _local(cache, cspecs, mesh)

    def step(params, tokens, cache):
        return M.decode_step(cfg, params, tokens, cache, mesh=mesh,
                             rules=rules, capacity=cell.seq_len)
    arg = p_bytes + _block_bytes(
        tokens, rules.token_sharding(tokens.shape[0]), mesh) \
        + sum(_nbytes(t) for t in tree_leaves(local))
    return step, (params, tokens, local), arg, 1


def trace_cell(cfg, cell, mesh, rules, *, microbatches=None,
               capacity=None) -> dict:
    step, args, arg, mb = build_step(cfg, cell, mesh, rules,
                                     microbatches=microbatches,
                                     capacity=capacity)
    out = trace(step, args, arg_bytes=arg)
    out["microbatches"] = mb
    return out


def calibration(cfg, cell, mesh, *, fsdp, expert_tp, microbatches):
    """The counts at the reference's two calibration depths."""
    samples = []
    for L0 in calibration_depths(cfg):
        c0 = reduced_depth_cfg(cfg, L0)
        rules = ShardingRules(c0, mesh, mode=cell.kind, fsdp=fsdp,
                              expert_tp=expert_tp)
        t = trace_cell(c0, cell, mesh, rules, microbatches=microbatches)
        samples.append({"L": L0, "flops": t["flops"], "bytes": t["bytes"],
                        **{f"coll_{k}": v
                           for k, v in t["collective"].items()}})
    return samples


def run_cell(arch: str, shape: str, *, multi_pod: bool = False,
             out_dir: str = OUT_DIR, fsdp=None, calibrate: bool = True,
             verbose: bool = True, attention_impl: str = "einsum",
             microbatches=None, expert_tp: bool = False,
             tag: str = "") -> dict:
    cfg = get_config(arch)
    if attention_impl != "einsum":
        cfg = cfg.replace(attention_impl=attention_impl)
    cell = SP.SHAPES[shape]
    mesh_tag = ("pod512" if multi_pod else "pod256") + tag
    result = {"arch": arch, "shape": shape, "mesh": mesh_tag,
              "status": "ok", "attention_impl": attention_impl,
              "expert_tp": expert_tp, "device_model": CARD}
    skip = SP.cell_supported(cfg, shape)
    if skip:
        result.update(status="skip", reason=skip)
        _write(out_dir, result)
        return result
    t0 = time.time()
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        chips = mesh.world
        rules = ShardingRules(cfg, mesh, mode=cell.kind, fsdp=fsdp,
                              expert_tp=expert_tp)
        full = trace_cell(cfg, cell, mesh, rules, microbatches=microbatches)
        t_trace = time.time() - t0
        mb = full["microbatches"]
        cal = calibration(cfg, cell, mesh, fsdp=rules.fsdp,
                          expert_tp=expert_tp, microbatches=mb) \
            if calibrate else None
        coll = full["collective"]
        flops_dev, bytes_dev = full["flops"], full["bytes"]
        mf = SP.model_flops(cfg, cell)
        compute_t = flops_dev / PEAK_FLOPS
        memory_t = bytes_dev / HBM_BW
        coll_t = coll["total"] / LINK_BW
        dominant = max((("compute", compute_t), ("memory", memory_t),
                        ("collective", coll_t)), key=lambda kv: kv[1])[0]
        mem = full["memory"]
        result.update(
            chips=chips,
            fsdp=rules.fsdp,
            trace_s=round(t_trace, 2),
            calibration_s=round(time.time() - t0 - t_trace, 2),
            flops_per_device=flops_dev,
            flops_counter=FLOPS_COUNTER,
            bytes_per_device=bytes_dev,
            bytes_counter=BYTES_COUNTER,
            collective_bytes_per_device=coll,
            compute_term_s=compute_t,
            memory_term_s=memory_t,
            collective_term_s=coll_t,
            dominant=dominant,
            model_flops_global=mf,
            useful_flops_fraction=(
                mf / (flops_dev * chips) if flops_dev else None),
            memory_analysis=mem,
            fits=mem["peak_memory_in_bytes"] <= DEVICE_BYTES,
            calibration=cal,
            microbatches=mb,
        )
        if verbose:
            print(f"[{arch} x {shape} x {mesh_tag}] OK "
                  f"trace={t_trace:.1f}s dominant={dominant} "
                  f"c/m/coll={compute_t:.2e}/{memory_t:.2e}/{coll_t:.2e}s "
                  f"peak={mem['peak_memory_in_bytes'] / 1e9:.2f} GB",
                  flush=True)
    except Exception as e:                       # noqa: BLE001
        result.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-2000:])
        if verbose:
            print(f"[{arch} x {shape} x {mesh_tag}] FAIL {e}", flush=True)
    _write(out_dir, result)
    return result


def _write(out_dir: str, result: dict) -> None:
    os.makedirs(out_dir, exist_ok=True)
    fn = f"{result['arch']}_{result['shape']}_{result['mesh']}.json"
    with open(os.path.join(out_dir, fn), "w") as f:
        json.dump(result, f, indent=1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--no-calibration", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--attn-impl", default="einsum",
                    choices=["einsum", "surrogate"])
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--expert-tp", action="store_true")
    ap.add_argument("--tag", default="",
                    help="suffix for output JSONs (perf iterations)")
    args = ap.parse_args(argv)

    cells = []
    archs = list_configs() if (args.all or not args.arch) else [args.arch]
    shapes = (list(SP.SHAPES) if (args.all or not args.shape)
              else [args.shape])
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                cells.append((arch, shape, mp))
    n_ok = n_fail = 0
    t0 = time.time()
    for arch, shape, mp in cells:
        tag = f"{arch}_{shape}_{'pod512' if mp else 'pod256'}{args.tag}"
        if args.skip_existing and os.path.exists(
                os.path.join(args.out, tag + ".json")):
            with open(os.path.join(args.out, tag + ".json")) as f:
                if json.load(f).get("status") in ("ok", "skip"):
                    print(f"[{tag}] cached")
                    continue
        r = run_cell(arch, shape, multi_pod=mp, out_dir=args.out,
                     calibrate=not args.no_calibration,
                     attention_impl=args.attn_impl,
                     microbatches=args.microbatches,
                     expert_tp=args.expert_tp, tag=args.tag)
        n_ok += r["status"] in ("ok", "skip")
        n_fail += r["status"] == "error"
    print(f"dry-run complete: {n_ok} ok/skip, {n_fail} failed, "
          f"{time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
