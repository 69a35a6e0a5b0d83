"""KV-quantization quality gate (DESIGN.md §14).

Replays one seeded multi-turn trace through two engines with identical
geometry and weights — an fp32-wire control and a candidate wire
format — and forces each turn's committed pages through an
evict -> flush -> reload round trip between turns, so every later turn
decodes on KV that crossed the wire in the candidate's format. The
gate then compares what the two engines computed:

- ``token_flip_rate``: committed-token mismatches / tokens compared,
  censored at the first divergence per turn — after a flip the two
  contexts differ, so later mismatches measure drift compounding, not
  codec error.
- ``logit_mse``: mean squared logit error over tap positions strictly
  before each turn's first argmax flip (contexts provably identical
  there, so the difference is purely quantization noise).

``fp32`` vs ``fp32`` is the control's control: the identity codec must
reproduce the trace bit-exactly (flip rate 0.0, MSE 0.0) — the same
contract every other differential twin in this repo holds
(``async_transfers=False``, ``fused_step=False``, ``prefix_cache=False``).
``int8`` is the repo's first tolerance-based tier: it must hold
``QualityTolerance`` (token flips <= 1% by default).

Scheduling is value-blind: round composition depends on token *counts*
and page geometry, never token *values*, so the two engines stay in
lockstep (identical tap streams position-by-position) even after a
flip — which is what makes the censored comparison well-defined.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class QualityTolerance:
    """Acceptance thresholds for a lossy KV wire format."""
    max_token_flip_rate: float = 0.01
    max_logit_mse: float = 1e-2


@dataclass
class QualityReport:
    kv_quant: str
    token_flips: int = 0
    tokens_compared: int = 0
    logit_mse: float = 0.0
    logit_positions: int = 0
    reloaded_pages: int = 0        # pages that crossed the wire (candidate)
    wire_bytes_saved: float = 0.0  # candidate engine ledger
    per_turn_flips: List[int] = field(default_factory=list)

    @property
    def token_flip_rate(self) -> float:
        return (self.token_flips / self.tokens_compared
                if self.tokens_compared else 0.0)

    def within(self, tol: QualityTolerance) -> bool:
        return (self.token_flip_rate <= tol.max_token_flip_rate
                and self.logit_mse <= tol.max_logit_mse)

    def summary(self) -> dict:
        return {
            "kv_quant": self.kv_quant,
            "quant_token_flip_rate": self.token_flip_rate,
            "quant_logit_mse": self.logit_mse,
            "tokens_compared": self.tokens_compared,
            "reloaded_pages": self.reloaded_pages,
            "kv_wire_bytes_saved": self.wire_bytes_saved,
        }


def _build_engine(cfg, params, kv_quant: str, *, fused_step: bool,
                  device):
    from repro_torch.serving.paged_engine import PagedRealtimeEngine
    return PagedRealtimeEngine(cfg, params, slots=2, page_size=4,
                               pages_per_seq=8, num_pages=32,
                               fused_step=fused_step, kv_quant=kv_quant,
                               device=device)


def _drive_turn(eng, sid: str, prompt, gen: int) -> List[np.ndarray]:
    """Run one turn to completion, collecting every fed row's logits."""
    taps: List[np.ndarray] = []
    eng.logit_tap = lambda s, lg: taps.append(np.array(lg))
    try:
        if sid in eng.sessions:
            eng.start_turn(sid, prompt, max_new_tokens=gen)
        else:
            eng.add_session(sid, prompt, max_new_tokens=gen)
        eng.run_to_completion()
    finally:
        eng.logit_tap = None
    return taps


def _wire_pressure(eng, sid: str) -> None:
    """Force the session's committed pages through the offload tier:
    evict everything evictable, flush (host copies durable in wire
    format), then a speech window so the next turn reloads them."""
    now = eng.clock.now()
    n = eng.kv.reclaimable_blocks(now)
    if n:
        assert eng.kv.evict(n, now) == n
        eng.flush_transfers()           # copy-then-free drains; durable
    eng.user_speech_start(sid, expected_dur_s=1.0)
    eng.clock.tick(1.0)


def run_quality_gate(cfg, params, *, kv_quant: str = "int8",
                     seed: int = 0, turns: int = 3,
                     fused_step: bool = True,
                     tol: Optional[QualityTolerance] = None,
                     device="cuda") -> QualityReport:
    """Replay the seeded trace on fp32-control and candidate engines;
    returns the comparison (pass ``tol`` to also assert it). Both
    engines run on ``device``, where ``params`` must live."""
    rng = np.random.default_rng(seed)
    # sized to the control geometry: 8 pages * 4 tokens context budget
    trace = [(rng.integers(0, cfg.vocab_size, size=int(rng.integers(4, 7))),
              4) for _ in range(turns)]

    control = _build_engine(cfg, params, "fp32", fused_step=fused_step,
                            device=device)
    candidate = _build_engine(cfg, params, kv_quant, fused_step=fused_step,
                              device=device)

    report = QualityReport(kv_quant=kv_quant)
    sq_err, sq_n = 0.0, 0
    for prompt, gen in trace:
        taps_c = _drive_turn(control, "q", prompt, gen)
        taps_q = _drive_turn(candidate, "q", prompt, gen)
        hist_c = control.sessions["q"].history[-1]
        hist_q = candidate.sessions["q"].history[-1]

        # committed tokens, censored at the turn's first divergence
        n = min(len(hist_c), len(hist_q))
        flip_at = next((i for i in range(n) if hist_c[i] != hist_q[i]), n)
        flips = 1 if flip_at < n else 0
        report.token_flips += flips
        report.tokens_compared += flip_at + flips
        report.per_turn_flips.append(flips)

        # logits, strictly before the first argmax flip in the tap
        # stream (identical contexts up to there; the streams align
        # because scheduling is value-blind)
        m = min(len(taps_c), len(taps_q))
        tap_flip = next(
            (i for i in range(m)
             if int(np.argmax(taps_c[i])) != int(np.argmax(taps_q[i]))), m)
        for i in range(tap_flip):
            d = taps_c[i].astype(np.float64) - taps_q[i].astype(np.float64)
            sq_err += float(np.mean(d * d))
            sq_n += 1

        _wire_pressure(control, "q")
        _wire_pressure(candidate, "q")

    control.check_invariants()
    candidate.check_invariants()
    report.logit_mse = sq_err / sq_n if sq_n else 0.0
    report.logit_positions = sq_n
    report.reloaded_pages = candidate.kv.reloaded_blocks
    report.wire_bytes_saved = candidate.transfer.stats.wire_bytes_saved
    if tol is not None:
        assert report.within(tol), (
            f"kv_quant={kv_quant} failed the quality gate: "
            f"flip_rate={report.token_flip_rate:.4f} "
            f"(max {tol.max_token_flip_rate}), "
            f"logit_mse={report.logit_mse:.3e} (max {tol.max_logit_mse})")
    return report
