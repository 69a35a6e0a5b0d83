"""One-call end-to-end gateway runner (DESIGN.md §4).

Shared by ``launch/serve.py --engine live``, ``chip_smoke.py`` and the
tests: build a model + ``PagedRealtimeEngine`` on a ``ScaledWallClock``,
put a ``RealtimeGateway`` with the requested policy in front of it, and
replay a ``serving/workload.py`` trace through in-process clients.
Returns the same ``Metrics`` object the simulator produces, so
sim-vs-real comparisons are a dict-diff away.

The reference's runner builds its model with JAX and warms jitted
executables; this one builds weights from a ``torch.Generator`` on the
engine's device (or takes ``model=(cfg, params)``, e.g. JAX weights
carried across with ``params_from_numpy``) and warms the eager steps:
the kernels' ``nvcc`` build at first use, the CUDA context and the
first use of each GEMM shape all happen before the clock starts.
"""
from __future__ import annotations

import asyncio
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.serving.gateway.client import LoadGenConfig, run_load
from repro_torch.serving.gateway.clock import ScaledWallClock
from repro_torch.serving.gateway.gateway import GatewayConfig, RealtimeGateway
from repro_torch.serving.metrics import Metrics
from repro_torch.serving.workload import WorkloadConfig


def tiny_model(seed: int = 0, device="cuda") -> Tuple[object, dict]:
    """The reduced two-layer config the CPU tests serve, with random
    weights drawn from a ``torch.Generator`` on ``device``."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.device import resolve_device
    from repro_torch.models.model import init_params
    dev = resolve_device(device)
    cfg = reduced(get_config("qwen2-1.5b"), layers=2, d_model=64,
                  vocab=331)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return cfg, init_params(cfg, gen, dev)


def _warm_engine(eng, prefill_chunk: int = 1) -> None:
    """Run padded all-scratch rounds through the engine's own step
    before the clock starts, so first-use costs never land in TTFP: on
    the card, the ``nvcc`` build of the paged kernels (at their first
    launch), the CUDA context and the first use of each GEMM shape. On
    the fused plane every query-axis bucket up to the gateway's prefill
    chunk is warmed (and ``1 + spec_decode``, a spec engine's widest
    decode row); on the per-token plane the decode step, which also
    carries that plane's prefill (``submit_turn`` teacher-forces every
    turn's prompt through ``run_round``). Padding rows write only the
    scratch page."""
    from repro_torch.serving.block_tables import assemble, assemble_fused
    from repro_torch.serving.paged_engine import _q_bucket
    B = eng.slots
    if not eng.fused_step:
        tabs = assemble(eng.pool, [None] * B, eng.pages_per_seq,
                        eng.scratch_page)
        eng._step(np.zeros((B,), np.int64), tabs).cpu()  # waits for it
        return
    spec = eng.spec_decode > 0
    top = _q_bucket(max(prefill_chunk, 1 + eng.spec_decode))
    q = 1
    while True:
        tabs = assemble_fused(eng.pool, [None] * B, q, eng.pages_per_seq,
                              eng.scratch_page)
        out = eng._fused(np.zeros((B, q), np.int64), tabs)
        (out[0] if spec else out).cpu()      # waits for the device
        if q >= top:
            break
        q *= 2


def build_gateway(*, policy: str = "liveserve", scale: float = 8.0,
                  slots: int = 8, page_size: int = 8,
                  pages_per_seq: int = 8, num_pages: Optional[int] = None,
                  audio_per_token_s: float = 0.25,
                  round_token_budget: int = 16, prefill_chunk: int = 16,
                  frontier_cap_s: Optional[float] = None,
                  sched_cfg: Optional[SchedulerConfig] = None,
                  model: Optional[tuple] = None, device="cuda",
                  seed: int = 0,
                  preload_chunks: int = 1,
                  fused_step: bool = True,
                  prefix_cache: bool = False,
                  kv_quant: str = "fp32",
                  spec_decode: int = 0,
                  proposer=None,
                  mesh=None,
                  autotune: Optional[str] = None
                  ) -> Optional[RealtimeGateway]:
    """``model``: ``(cfg, params)`` with params on ``device``; the
    default is ``tiny_model(seed)``. ``mesh``: a ``ServingMesh`` shards
    the engine's page store (DESIGN.md §9); every rank calls this with
    the same arguments, the leader (rank 0) gets the gateway, and every
    other rank follows the leader's device operations here until the
    leader releases it, then gets None. ``preload_chunks``: transfer chunks
    each round may drain between decode sub-batches (the serve flag of
    the same name; DESIGN.md §10). ``fused_step=False`` serves on the
    per-token differential-control plane (one step per token —
    DESIGN.md §11). ``spec_decode=K`` drafts up to K tokens per decode
    slot per round and verifies them in the same fused step
    (DESIGN.md §16); ``autotune`` names a kernel-config cache JSON the
    paged kernels consult for their tiling (``kernels/autotune.py``; a
    missing file starts empty, and serving never sweeps or saves). On a
    mesh every rank enables it before it builds or follows its engine;
    a shard's shapes simply miss."""
    from repro_torch.serving.paged_engine import PagedRealtimeEngine
    if autotune:
        from repro_torch.kernels import autotune as at
        at.enable(autotune)
    cfg, params = model if model is not None \
        else tiny_model(seed, device=device)
    clock = ScaledWallClock(scale)
    eng = PagedRealtimeEngine(cfg, params, slots=slots,
                              page_size=page_size,
                              pages_per_seq=pages_per_seq,
                              num_pages=num_pages, clock=clock,
                              device=device,
                              transfer_chunks_per_round=preload_chunks,
                              fused_step=fused_step,
                              prefix_cache=prefix_cache,
                              kv_quant=kv_quant,
                              spec_decode=spec_decode,
                              proposer=proposer, mesh=mesh)
    if mesh is not None and not mesh.is_leader:
        eng.follow()
        return None
    _warm_engine(eng, min(prefill_chunk, round_token_budget))
    gw = RealtimeGateway(eng, cfg=GatewayConfig(
        policy=policy, audio_per_token_s=audio_per_token_s,
        round_token_budget=round_token_budget,
        prefill_chunk=prefill_chunk, frontier_cap_s=frontier_cap_s,
        sched=sched_cfg))
    return gw


def run_gateway_workload(*, policy: str = "liveserve",
                         kind: str = "interactive", sessions: int = 8,
                         barge_in: float = 0.0, seed: int = 0,
                         arrival: str = "poisson", rate_rps: float = 2.0,
                         scale: float = 8.0, max_turns: int = 2,
                         max_prompt: int = 16, max_response: int = 12,
                         speech_scale: float = 1.0,
                         prompt_families: int = 0,
                         family_prefix_len: int = 0,
                         gateway: Optional[RealtimeGateway] = None,
                         timeout_s: Optional[float] = None,
                         **gw_kw) -> Tuple[Metrics, RealtimeGateway]:
    """Replay an open-loop workload through a gateway; returns
    (metrics, gateway). Pass ``gateway`` to use a pre-built (and
    pre-warmed, but not yet run) stack; otherwise ``gw_kw`` goes to
    ``build_gateway``. A gateway serves exactly one workload — its
    session registry and metrics are single-run state. On a mesh
    (``mesh=`` in ``gw_kw``, or a gateway built with one) the workload
    runs on the leader, which releases the follower ranks when it ends;
    a follower rank gets ``(None, None)``.
    """
    if gateway is not None:
        assert not gw_kw, "gateway already built; engine kwargs ignored"
        assert gateway.cfg.policy == policy, \
            f"gateway was built for {gateway.cfg.policy!r}, not {policy!r}"
        assert not gateway._stopping and not gateway._sessions, \
            "a RealtimeGateway serves one workload; build a fresh one"
        gw = gateway
    else:
        gw = build_gateway(policy=policy, scale=scale, seed=seed,
                           **gw_kw)
        if gw is None:                   # a follower rank, released
            return None, None
    wl = WorkloadConfig(kind=kind, num_sessions=sessions, seed=seed,
                        p_barge_in=barge_in, arrival=arrival,
                        rate_rps=rate_rps,
                        prompt_families=prompt_families,
                        family_prefix_len=family_prefix_len)
    lcfg = LoadGenConfig(workload=wl, vocab=gw.engine.cfg.vocab_size,
                         max_prompt=max_prompt, max_response=max_response,
                         max_turns=max_turns,
                         audio_per_token_s=gw.cfg.audio_per_token_s,
                         speech_scale=speech_scale, seed=seed)

    async def main():
        gw.clock.restart()
        serve = asyncio.create_task(gw.run())
        load = asyncio.create_task(run_load(gw, lcfg))
        try:
            done, _ = await asyncio.wait(
                {serve, load}, timeout=timeout_s,
                return_when=asyncio.FIRST_COMPLETED)
            if serve in done and load not in done:
                # the serve loop died under live clients: surface its
                # error instead of letting every client block forever
                serve.result()
                raise RuntimeError("gateway serve loop exited early")
            if load not in done:
                raise asyncio.TimeoutError(
                    f"load generator exceeded {timeout_s}s")
            load.result()                # propagate client errors
        except BaseException:
            gw.stop(force=True)
            load.cancel()
            await asyncio.gather(serve, load, return_exceptions=True)
            raise
        gw.stop()
        await serve                      # surface late serve errors

    try:
        asyncio.run(main())
    finally:
        gw.engine.release_followers()
    return gw.metrics(), gw
