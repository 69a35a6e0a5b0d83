"""One-call end-to-end fleet runner (DESIGN.md §12).

Shared by ``launch/serve.py --replicas N``, ``chip_smoke.py`` and the
fleet tests: build N paged engines on one ``ScaledWallClock``, put a
``FleetGateway`` in front, and replay a workload through the same
in-process clients the single-engine harness uses.

The reference's runner builds its model with JAX and shares one jitted
step across the replicas; here every replica takes the one ``params``
dict (the weights sit on the device once, not N times) and the eager
steps share the kernels, which build once per process. One warm-up of
the first replica pays the kernels' ``nvcc`` build, the CUDA context and
the first use of each GEMM shape for the whole fleet, before the clock
starts.
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.distributed.fault_tolerance import StragglerMitigator
from repro_torch.serving.fleet.gateway import FleetGateway
from repro_torch.serving.fleet.replica_set import ReplicaSet
from repro_torch.serving.gateway.clock import ScaledWallClock
from repro_torch.serving.gateway.gateway import GatewayConfig
from repro_torch.serving.gateway.harness import (_warm_engine,
                                                 run_gateway_workload,
                                                 tiny_model)
from repro_torch.serving.metrics import Metrics


def build_fleet_gateway(*, replicas: int = 3, policy: str = "liveserve",
                        scale: float = 8.0, slots: int = 8,
                        page_size: int = 8, pages_per_seq: int = 8,
                        num_pages: Optional[int] = None,
                        audio_per_token_s: float = 0.25,
                        round_token_budget: int = 16,
                        prefill_chunk: int = 16,
                        frontier_cap_s: Optional[float] = None,
                        sched_cfg: Optional[SchedulerConfig] = None,
                        model: Optional[tuple] = None, mesh=None,
                        seed: int = 0, preload_chunks: int = 1,
                        fused_step: bool = True,
                        prefix_cache: bool = False,
                        kv_quant: str = "fp32",
                        spec_decode: int = 0,
                        proposer=None,
                        autotune: Optional[str] = None,
                        interconnect_gb_s: float = 50.0,
                        mitigator: Optional[StragglerMitigator] = None,
                        strike_threshold: int = 3,
                        drain_after_routes: Optional[Tuple[int, int]] = None,
                        rebalance_margin: Optional[int] = None,
                        device="cuda") -> FleetGateway:
    """N data-parallel engines behind one gateway. All engine knobs are
    per replica (each replica gets its own ``num_pages`` pool); the
    weights are shared. ``model``: ``(cfg, params)`` with params on
    ``device``; the default is ``tiny_model(seed)``."""
    from repro_torch.serving.paged_engine import PagedRealtimeEngine
    if autotune:
        raise NotImplementedError(
            "kernel autotune is not ported yet (ROADMAP.md queue 1 "
            "item 4)")
    if mesh is not None:
        # one follower loop follows one engine: N engines on a mesh need
        # every command to carry its replica's index
        raise NotImplementedError(
            "the fleet over a mesh is not ported yet (ROADMAP.md queue 1 "
            "item 8)")
    cfg, params = model if model is not None \
        else tiny_model(seed, device=device)
    clock = ScaledWallClock(scale)
    engines = [
        PagedRealtimeEngine(cfg, params, slots=slots,
                            page_size=page_size,
                            pages_per_seq=pages_per_seq,
                            num_pages=num_pages, clock=clock,
                            device=device,
                            transfer_chunks_per_round=preload_chunks,
                            fused_step=fused_step,
                            prefix_cache=prefix_cache,
                            kv_quant=kv_quant,
                            spec_decode=spec_decode,
                            proposer=proposer)
        for _ in range(replicas)]
    # one warm-up warms the fleet: the replicas share the weights, the
    # kernels and every step shape
    _warm_engine(engines[0], min(prefill_chunk, round_token_budget))
    rs = ReplicaSet(engines, interconnect_gb_s=interconnect_gb_s)
    return FleetGateway(rs, cfg=GatewayConfig(
        policy=policy, audio_per_token_s=audio_per_token_s,
        round_token_budget=round_token_budget,
        prefill_chunk=prefill_chunk, frontier_cap_s=frontier_cap_s,
        sched=sched_cfg),
        mitigator=mitigator, strike_threshold=strike_threshold,
        drain_after_routes=drain_after_routes,
        rebalance_margin=rebalance_margin)


def run_fleet_workload(*, policy: str = "liveserve",
                       kind: str = "interactive", sessions: int = 12,
                       barge_in: float = 0.0, seed: int = 0,
                       arrival: str = "poisson", rate_rps: float = 2.0,
                       scale: float = 8.0, max_turns: int = 2,
                       max_prompt: int = 16, max_response: int = 12,
                       speech_scale: float = 1.0,
                       prompt_families: int = 0,
                       family_prefix_len: int = 0,
                       gateway: Optional[FleetGateway] = None,
                       timeout_s: Optional[float] = None,
                       **gw_kw) -> Tuple[Metrics, FleetGateway]:
    """Replay an open-loop workload through a fleet gateway; returns
    (metrics, gateway). The load path is the single-engine harness's —
    the fleet gateway is a ``RealtimeGateway`` to its clients."""
    if gateway is None:
        gateway = build_fleet_gateway(policy=policy, scale=scale,
                                      seed=seed, **gw_kw)
    else:
        assert not gw_kw, "gateway already built; engine kwargs ignored"
    return run_gateway_workload(
        policy=policy, kind=kind, sessions=sessions, barge_in=barge_in,
        seed=seed, arrival=arrival, rate_rps=rate_rps, scale=scale,
        max_turns=max_turns, max_prompt=max_prompt,
        max_response=max_response, speech_scale=speech_scale,
        prompt_families=prompt_families,
        family_prefix_len=family_prefix_len,
        gateway=gateway, timeout_s=timeout_s)
