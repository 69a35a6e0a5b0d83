"""Realtime session gateway — the event-driven serving front-end that
puts the LiveServe control plane in charge of the real paged engine
(DESIGN.md §4).

Layout:
  events.py   typed duplex event protocol (client <-> gateway)
  clock.py    scaled wall clock shared by engine, monitor, and policies
  gateway.py  asyncio gateway: session registry + scheduler-driven
              continuous-batching step loop over PagedRealtimeEngine
  client.py   in-process clients: load generator replaying
              serving/workload.py traces in scaled real time
  harness.py  one-call end-to-end runner (serve.py --engine live,
              chip_smoke.py, tests)
  replay.py   deterministic virtual-time replay twin of gateway.py —
              the differential sim-vs-real harness (DESIGN.md §9)
"""
from repro_torch.serving.gateway.clock import ScaledWallClock
from repro_torch.serving.gateway.events import (AudioChunk, BargeIn, Hangup,
                                                SessionClosed, SpeechEnd,
                                                SpeechStart, TurnDone,
                                                TurnRequest, UserAudio)
from repro_torch.serving.gateway.gateway import GatewayConfig, RealtimeGateway
from repro_torch.serving.gateway.client import LoadGenConfig, run_load
from repro_torch.serving.gateway.harness import run_gateway_workload
from repro_torch.serving.gateway.replay import (ReplayClock, ReplayConfig,
                                                ReplayGateway, run_replay)

__all__ = [
    "AudioChunk", "BargeIn", "Hangup", "SessionClosed", "SpeechEnd",
    "SpeechStart", "TurnDone", "TurnRequest", "UserAudio",
    "GatewayConfig", "RealtimeGateway", "ScaledWallClock",
    "LoadGenConfig", "run_load", "run_gateway_workload",
    "ReplayClock", "ReplayConfig", "ReplayGateway", "run_replay",
]
