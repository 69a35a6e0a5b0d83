"""Serving launcher for the port — runs the realtime interaction
pipeline.

Simulated pipeline (paper-scale policies on the virtual clock; touches
no device):

  PYTHONPATH=src python -m repro_torch.launch.serve --engine sim \\
      --model qwen3-omni-like --workload interactive --concurrency 12 \\
      --barge-in 0.5 --system liveserve

Live gateway (the asyncio front end over the port's paged engine on a
scaled wall clock):

  PYTHONPATH=src python -m repro_torch.launch.serve --engine live \\
      --workload interactive --sessions 8 --barge-in 0.3
  PYTHONPATH=src python -m repro_torch.launch.serve --engine live \\
      --device cpu --config tiny --sessions 4

Replica fleet (``--replicas N``, N >= 2: N paged engines sharing one
set of weights behind one gateway, with live cross-replica KV
migration; DESIGN.md §12), e.g. under agent handoffs:

  PYTHONPATH=src python -m repro_torch.launch.serve --engine live \\
      --replicas 3 --workload handoff --sessions 6

Real engine demo (the scripted multi-turn conversation, no gateway):

  PYTHONPATH=src python -m repro_torch.launch.serve --engine real \\
      --device cpu --config tiny

``--config qwen2-1.5b`` (the default for live and real),
``paligemma-3b`` (the vlm family's text path, head dim 256) and
``qwen3-4b`` serve the published width (bf16) with random weights drawn
from ``--seed``; ``tiny`` is the reduced two-layer f32 variant the CPU
tests use. ``--layers N`` serves a config's first N layers at its full
width. All run on ``--device cuda`` unless asked for the CPU.

``--mesh DxM`` (real and live) shards the paged KV plane over D x M
ranks (DESIGN.md §9): the launcher builds the kernels, spawns the ranks
(``launch/mesh.py``), each builds the same weights from ``--seed``, and
rank 0 serves and prints. Rank r runs on ``cuda:(r % device_count)``;
ranks that share a card talk gloo through host memory:

  PYTHONPATH=src python -m repro_torch.launch.serve --engine real \
      --device cpu --config tiny --mesh 1x2

``--mesh`` composes with ``--replicas``: every replica shards its page
store over the same mesh, and rank 0 runs the fleet's control plane
(DESIGN.md §9 inside §12):

  PYTHONPATH=src python -m repro_torch.launch.serve --engine live \
      --device cpu --config tiny --replicas 3 --mesh 1x2 \
      --workload handoff

The flags and their rejections are the reference launcher's.
``--autotune CACHE.json`` (live) has the paged kernels take their
tiling from a cache that ``kernels/autotune.py::sweep`` built (a
missing file starts empty; serving never sweeps or saves), and the
summary reports the cache's entries, hits and misses:

  PYTHONPATH=src python -m repro_torch.launch.serve --engine live \
      --device cpu --config tiny --autotune cache.json
"""
from __future__ import annotations

import argparse
import functools
import json

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import parse_mesh, spawn
from repro_torch.models.model import init_params

# the demo's page counts and per-page transfer times are the reference
# script's at any width: pages hold 8 * token_scale tokens, every
# prompt and reply is token_scale times longer, and the modeled PCIe
# rate scales with the page's bytes (a full-width qwen2-1.5b bf16 page is
# 28 layers x K,V x 16 slots x 2 heads x 128 x 2 B = 458,752 B, 112x the
# tiny config's 4,096 B page, so 0.01 GB/s becomes 1.12 GB/s; paligemma-3b
# 18 x 2 x 16 x 1 x 256 x 2 B = 294,912 B, 0.72 GB/s; qwen3-4b
# 36 x 2 x 16 x 8 x 128 x 2 B = 2,359,296 B, 5.76 GB/s). phi3.5-moe is no
# choice: its 32 layers (~84 GB in bf16) do not fit one card
DEMOS = {
    "tiny": dict(page_size=8, token_scale=1, pcie_gb_s=0.01),
    "qwen2-1.5b": dict(page_size=16, token_scale=2, pcie_gb_s=1.12),
    "paligemma-3b": dict(page_size=16, token_scale=2, pcie_gb_s=0.72),
    "qwen3-4b": dict(page_size=16, token_scale=2, pcie_gb_s=5.76),
}

# the live gateway's geometry and trace clamps per config: ``tiny`` is
# the reference harness's own (pages of 8, 8 a session, prompts <= 16
# and replies <= 12 tokens, 0.25 s of audio a token, clock x4, rounds
# of 16 tokens); qwen2-1.5b serves realistic turns (prompts <= 256,
# replies <= 64) on pages of 16, 40 a session (two such turns), at the
# workload's 0.08 s of audio a token and the clock a user hears (x1).
# Its rounds hold every slot's decode token beside a prefill chunk of
# 16 (budget None = slots + 16): a round of ~45 ms on the card adds
# less than 80 ms of audio to a slot, so slots spend long stretches
# below the playback-safety buffer, and at a budget of 16 their decode
# tokens would leave no room for any chunk. paligemma-3b and qwen3-4b
# serve qwen2-1.5b's geometry
_FULL_WIDTH_LIVE = dict(page_size=16, pages_per_seq=40, max_prompt=256,
                        max_response=64, max_turns=2,
                        audio_per_token_s=0.08, scale=1.0,
                        round_token_budget=None)
LIVE = {
    "tiny": dict(page_size=8, pages_per_seq=8, max_prompt=16,
                 max_response=12, max_turns=2, audio_per_token_s=0.25,
                 scale=4.0, round_token_budget=16),
    "qwen2-1.5b": _FULL_WIDTH_LIVE,
    "paligemma-3b": _FULL_WIDTH_LIVE,
    "qwen3-4b": _FULL_WIDTH_LIVE,
}
PREFILL_CHUNK = 16

# flags meaningful only for the sim / live engines; --engine real must
# reject them explicitly instead of silently ignoring them
_WORKLOAD_FLAGS = ("workload", "system", "sessions", "concurrency",
                   "barge_in", "kv_gb")


def build_config(name: str, layers=None):
    """``name``'s config, on its first ``layers`` layers (None: all)."""
    if name == "tiny":
        cfg = reduced(get_config("qwen2-1.5b"), layers=2, d_model=64,
                      vocab=503)
    else:
        cfg = get_config(name)
    return cfg if layers is None else cfg.replace(num_layers=layers)


def build_model(config: str, device, seed: int = 0, layers=None):
    """(cfg, params, device): weights are random, drawn from a
    ``torch.Generator`` on ``device`` seeded with ``seed``."""
    dev = resolve_device(device)
    cfg = build_config(config, layers)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return cfg, init_params(cfg, gen, dev), dev


def build_demo(config: str, device, seed: int = 0, layers=None):
    """(cfg, params, demo kwargs) for ``run_multiturn_demo``."""
    cfg, params, dev = build_model(config, device, seed, layers)
    return cfg, params, dict(DEMOS[config], seed=seed, device=dev)


def _serve(mesh_spec, device: str, fn) -> None:
    """``fn(None)`` here, or ``fn(mesh)`` on every rank of a ``DxM``
    mesh spawned from here (the kernels built first, so the ranks only
    load them)."""
    if mesh_spec is None:
        fn(None)
        return
    if resolve_device(device).type == "cuda":
        from repro_torch.kernels import _build
        _build.build()
    spawn(mesh_spec, fn, device=device)


def _print(s: dict, as_json: bool) -> None:
    if as_json:
        print(json.dumps(s, indent=1))
    else:
        for k, v in s.items():
            print(f"{k:20s} {v:.4f}" if isinstance(v, float)
                  else f"{k:20s} {v}")


def _real(config: str, device, seed: int, fused_step: bool, as_json: bool,
          mesh, layers=None) -> None:
    """--engine real on this process (or this rank of ``mesh``)."""
    from repro_torch.serving.paged_engine import run_multiturn_demo
    cfg, params, kw = build_demo(config, mesh.device if mesh else device,
                                 seed, layers)
    out = run_multiturn_demo(
        cfg, params, fused_step=fused_step, mesh=mesh,
        log=(lambda *_a, **_k: None) if as_json else print, **kw)
    if out is not None and as_json:
        print(json.dumps(out, indent=1, default=str))


def _live(config: str, device, seed: int, kw: dict, as_json: bool,
          replicas: int, mesh, layers=None) -> None:
    """--engine live on this process (or this rank of ``mesh``): one
    engine, or a fleet of ``replicas`` engines sharing the weights."""
    cfg, params, dev = build_model(config, mesh.device if mesh else device,
                                   seed, layers)
    if replicas > 1:
        from repro_torch.serving.fleet import run_fleet_workload
        m, gw = run_fleet_workload(replicas=replicas, model=(cfg, params),
                                   device=dev, seed=seed, mesh=mesh, **kw)
    else:
        from repro_torch.serving.gateway import run_gateway_workload
        m, gw = run_gateway_workload(model=(cfg, params), device=dev,
                                     seed=seed, mesh=mesh, **kw)
    if gw is None:                       # a follower rank
        return
    engines = list(gw.replicas) if replicas > 1 else [gw.engine]
    s = m.summary()
    s["rounds"] = gw.rounds
    s["max_over_frontier_s"] = gw.max_over_frontier_s
    off = sum(e.transfer.stats.reload_pages_off_path for e in engines)
    on = sum(e.transfer.stats.reload_pages_on_path for e in engines)
    s["transfer_overlap_frac"] = off / (off + on) if off + on else 0.0
    if kw.get("autotune"):
        from repro_torch.kernels import autotune
        s["autotune"] = " ".join(f"{k}={v}"
                                 for k, v in autotune.stats().items())
    if replicas > 1:
        done = gw.migrator.completed()
        for i in range(replicas):
            mig_in = sum(1 for p in done if p.dst == i)
            mig_out = sum(1 for p in done if p.src == i)
            s[f"replica{i}"] = (
                f"routed={gw.router.routed[i]} "
                f"migrated_in={mig_in} migrated_out={mig_out} "
                f"peak_occupancy={m.replica_occupancy[i]:.3f}"
                + (" [drained]" if i in gw.router.draining else ""))
    _print(s, as_json)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--engine", default="sim",
                    choices=["sim", "real", "live"],
                    help="sim: event-driven simulator; live: asyncio "
                         "gateway over the port's paged engine "
                         "(DESIGN.md §4); real: scripted paged-engine "
                         "demo (DESIGN.md §3)")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="real/live engines (default cuda)")
    ap.add_argument("--config", default=None, choices=list(DEMOS),
                    help="real/live engines: the served model (default "
                         "qwen2-1.5b at full width; tiny is the reduced "
                         "two-layer variant)")
    ap.add_argument("--model", default=None,
                    choices=["qwen3-omni-like", "ming-omni-like"],
                    help="sim engine only; live/real serve --config")
    ap.add_argument("--workload", default=None,
                    choices=["sharegpt", "interactive", "mixed",
                             "duplex", "toolcall", "handoff"],
                    help="duplex: full-duplex periodic-frame sessions "
                         "(per-token deadlines, deadline_miss_rate); "
                         "toolcall: agentic tool-call pauses (hot-KV "
                         "idle + resume without re-prefill); handoff: "
                         "mid-conversation transfer to another replica. "
                         "These need --engine live")
    ap.add_argument("--system", default=None,
                    choices=["liveserve", "vllm-omni", "vllm-omni-wo"])
    ap.add_argument("--sessions", type=int, default=None)
    ap.add_argument("--concurrency", type=int, default=None)
    ap.add_argument("--barge-in", type=float, default=None)
    ap.add_argument("--kv-gb", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", action="store_true")
    # --engine real | live (the paged data plane)
    ap.add_argument("--fused-step", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="real/live engines: run each round's whole "
                         "token budget (prefill chunks + decode) as one "
                         "fused step (DESIGN.md §11). --no-fused-step "
                         "serves on the per-token differential-control "
                         "plane")
    ap.add_argument("--layers", type=int, default=None,
                    help="real/live engines: serve the config's first N "
                         "layers at its full width (default all)")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="real/live engines: shard the paged KV plane "
                         "over D x M ranks, e.g. 1x2 (DESIGN.md §9); "
                         "the launcher spawns the ranks, rank 0 prints")
    # --engine live only
    ap.add_argument("--prefix-cache", default=None,
                    action=argparse.BooleanOptionalAction,
                    help="live engine: share committed KV pages across "
                         "sessions with identical prompt prefixes — "
                         "refcounted copy-on-write pages behind a radix "
                         "prefix index (DESIGN.md §13). Off by default "
                         "(the bit-exact no-sharing control)")
    ap.add_argument("--prompt-families", type=int, default=None,
                    help="live engine: assign sessions round-robin to K "
                         "shared-system-prompt families (workload knob "
                         "that makes --prefix-cache hits observable)")
    ap.add_argument("--family-prefix-len", type=int, default=None,
                    help="live engine: shared prefix tokens per family "
                         "(with --prompt-families)")
    ap.add_argument("--clock-scale", type=float, default=None,
                    help="live engine: wall-clock speedup factor "
                         "(default 4 for tiny, 1 for qwen2-1.5b)")
    ap.add_argument("--slots", type=int, default=None,
                    help="live engine: decode batch rows")
    ap.add_argument("--kv-pages", type=int, default=None,
                    help="live engine: KV pool size in pages")
    ap.add_argument("--preload-chunks", type=int, default=None,
                    help="live engine: transfer chunks each round may "
                         "drain between decode sub-batches — the async "
                         "chunked KV transfer budget that lands "
                         "speech-time preloads off the turn critical "
                         "path (DESIGN.md §10)")
    ap.add_argument("--kv-quant", default=None,
                    choices=["fp32", "int8"],
                    help="live engine: KV wire format on the offload "
                         "path (DESIGN.md §14). int8 block-quantizes "
                         "host copies (~4x less modeled PCIe per page, "
                         "tolerance-gated quality); fp32 is the "
                         "bit-exact default")
    ap.add_argument("--spec-decode", type=int, default=None,
                    metavar="K",
                    help="live engine: draft up to K tokens per decode "
                         "slot per round and verify them in the same "
                         "fused step (self-speculative prompt-lookup "
                         "drafts; DESIGN.md §16). Lossless: accepted "
                         "streams equal K=0's. Needs --fused-step")
    ap.add_argument("--autotune", default=None, metavar="CACHE.json",
                    help="live engine: the paged kernels take their "
                         "tiling from this autotune cache JSON, built "
                         "with repro_torch.kernels.autotune.sweep (a "
                         "missing file starts empty; serving never "
                         "sweeps or saves)")
    ap.add_argument("--replicas", type=int, default=None,
                    help="live engine: data-parallel engine replicas "
                         "behind one gateway, sharing one set of weights, "
                         "with live cross-replica KV migration "
                         "(DESIGN.md §12). Composes with --mesh: every "
                         "replica shards its page store over the same "
                         "mesh")
    args = ap.parse_args(argv)

    if args.engine != "live":
        live_only = [f"--{f.replace('_', '-')}" for f in
                     ("clock_scale", "slots", "kv_pages",
                      "preload_chunks", "replicas", "prefix_cache",
                      "prompt_families", "family_prefix_len",
                      "kv_quant", "spec_decode", "autotune")
                     if getattr(args, f) is not None]
        if live_only:
            ap.error(f"{', '.join(live_only)} only apply to "
                     f"--engine live")
    if args.engine == "sim" and args.mesh is not None:
        ap.error("--mesh shards the real paged data plane; the simulator "
                 "models costs, not placement (use --engine real|live)")
    if args.engine == "sim" and not args.fused_step:
        ap.error("--no-fused-step selects the paged data plane's "
                 "per-token control; the simulator has no data plane "
                 "(use --engine real|live)")
    if args.mesh is not None:
        try:
            parse_mesh(args.mesh)
        except ValueError as e:
            ap.error(str(e))
    if args.engine != "sim" and args.model is not None:
        ap.error("--model only applies to --engine sim; live/real serve "
                 "--config")
    if args.engine == "sim":
        given = [f for f, v in (("--device", args.device),
                                ("--config", args.config),
                                ("--layers", args.layers))
                 if v is not None]
        if given:
            ap.error(f"{', '.join(given)} only apply to --engine "
                     f"real|live; the simulator touches no device")
    device = args.device or "cuda"
    config = args.config or "qwen2-1.5b"
    if args.layers is not None and not \
            1 <= args.layers <= build_config(config).num_layers:
        ap.error(f"--layers must be 1..{build_config(config).num_layers} "
                 f"for {config}")

    if args.engine == "real":
        given = [f"--{f.replace('_', '-')}" for f in _WORKLOAD_FLAGS
                 if getattr(args, f) is not None]
        if given:
            ap.error(
                f"--engine real runs a fixed scripted demo and does not "
                f"take {', '.join(given)}; use --engine live (real data "
                f"plane under load) or --engine sim (paper-scale "
                f"simulation)")
        _serve(args.mesh, device, functools.partial(
            _real, config, device, args.seed, args.fused_step, args.json,
            layers=args.layers))
        return

    # shared workload defaults for sim and live
    workload = args.workload or "interactive"
    if args.engine != "live" \
            and workload in ("duplex", "toolcall", "handoff"):
        ap.error(f"--workload {workload} drives gateway-level "
                 f"interaction events (frame deadlines, tool pauses, "
                 f"handoffs); use --engine live")
    system = args.system or "liveserve"
    sessions = args.sessions if args.sessions is not None else 32
    barge_in = args.barge_in if args.barge_in is not None else 0.0

    if args.engine == "live":
        bad = [n for n, v in (("--kv-gb", args.kv_gb),
                              ("--concurrency", args.concurrency))
               if v is not None]
        if bad:
            ap.error(f"--engine live is open-loop on a page pool; "
                     f"{', '.join(bad)} do not apply (use --kv-pages "
                     f"for pool size)")
        policies = {"liveserve": "liveserve", "vllm-omni": "fcfs"}
        if system not in policies:
            ap.error(f"--engine live supports --system "
                     f"{'|'.join(policies)} (the paged data plane needs "
                     f"an offload tier; 'vllm-omni-wo' discards KV — "
                     f"use --engine sim for that baseline)")
        replicas = args.replicas if args.replicas is not None else 1
        if replicas < 1:
            ap.error("--replicas must be >= 1")
        spec_decode = args.spec_decode if args.spec_decode is not None \
            else 0
        if spec_decode < 0:
            ap.error("--spec-decode must be >= 0")
        if spec_decode > 0 and not args.fused_step:
            ap.error("--spec-decode verifies drafts in one fused launch "
                     "and cannot run on the per-token control plane; "
                     "drop --no-fused-step (DESIGN.md §16)")
        live = LIVE[config]
        page = live["page_size"]
        slots = args.slots if args.slots is not None else 8
        kw = dict(
            policy=policies[system], kind=workload, sessions=sessions,
            barge_in=barge_in,
            scale=(args.clock_scale
                   if args.clock_scale is not None else live["scale"]),
            slots=slots, num_pages=args.kv_pages, page_size=page,
            prefill_chunk=PREFILL_CHUNK,
            round_token_budget=(live["round_token_budget"]
                                or slots + PREFILL_CHUNK),
            preload_chunks=(args.preload_chunks
                            if args.preload_chunks is not None else 1),
            fused_step=args.fused_step,
            prefix_cache=bool(args.prefix_cache),
            kv_quant=args.kv_quant or "fp32",
            spec_decode=spec_decode,
            autotune=args.autotune,
            prompt_families=(args.prompt_families
                             if args.prompt_families is not None else 0),
            family_prefix_len=(args.family_prefix_len
                               if args.family_prefix_len is not None
                               else 0),
            # the family prefix rides on top of the per-turn prompt
            # draw, so grow each session's context window to fit it
            pages_per_seq=live["pages_per_seq"]
            + -(-(args.family_prefix_len or 0) // page),
            max_prompt=live["max_prompt"],
            max_response=live["max_response"],
            max_turns=live["max_turns"],
            audio_per_token_s=live["audio_per_token_s"],
            frontier_cap_s=3.0 if system == "liveserve" else None)
        _serve(args.mesh, device, functools.partial(
            _live, config, device, args.seed, kw, args.json, replicas,
            layers=args.layers))
        return
    else:
        from repro_torch.serving.costmodel import PIPELINES
        from repro_torch.serving.simulator import run_sim
        from repro_torch.serving.workload import WorkloadConfig

        systems = {
            "liveserve": dict(policy="liveserve"),
            "vllm-omni": dict(policy="fcfs", kv_policy="lru",
                              preload=False),
            "vllm-omni-wo": dict(policy="fcfs", kv_policy="none",
                                 preload=False),
        }
        pipe = PIPELINES[args.model or "qwen3-omni-like"](
            kv_capacity_gb=args.kv_gb if args.kv_gb is not None else 4.0)
        wl = WorkloadConfig(
            kind=workload, num_sessions=sessions,
            concurrency=(args.concurrency
                         if args.concurrency is not None else 8),
            seed=args.seed, p_barge_in=barge_in)
        m = run_sim(pipe, wl, until=3600.0, **systems[system])
        s = m.summary()

    _print(s, args.json)


if __name__ == "__main__":
    main()
