"""Serving metrics shared by the virtual-clock simulator and the
realtime gateway.

``TurnRecord`` / ``Metrics`` used to live inside ``serving/simulator.py``;
they are a standalone module so the gateway's collector produces the
*same object* (and therefore the same ``summary()`` schema) as the
simulator — sim-vs-real policy behavior is directly comparable, and a
summary-key drift between the two planes is impossible by construction.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class TurnRecord:
    session_id: str
    turn_index: int
    speech_end: float = 0.0
    ttfp: Optional[float] = None           # audio time-to-first-packet
    text_ttft: Optional[float] = None
    audio_delivered_s: float = 0.0
    audio_heard_s: float = 0.0
    gen_span_s: float = 0.0
    max_gap_s: float = 0.0
    n_gaps: int = 0
    talker_generated: int = 0
    talker_wasted: int = 0
    barged: bool = False
    reload_stall_s: float = 0.0            # on-path (turn-start) reload
    reload_off_path_s: float = 0.0         # reload hidden off the path
    prefix_hit_tokens: int = 0             # prompt tokens attached from the
    #                                        shared prefix cache (no prefill)
    prompt_tokens: int = 0                 # total prompt tokens this turn
    #                                        (prefilled + prefix hits)
    completed: bool = False
    finish_time: float = 0.0
    migrated: bool = False                 # turn started on a replica the
    #                                        session was live-migrated to
    # full-duplex frame accounting (zero on half-duplex turns)
    frames: int = 0                        # output frames emitted
    deadline_misses: int = 0               # frames past their deadline
    # agentic scenario markers
    tool_resumed: bool = False             # turn resumed a tool pause
    handoff: bool = False                  # turn started on a replica the
    #                                        client requested via handoff

    @property
    def continuous(self) -> bool:
        return self.max_gap_s <= 0.100

    @property
    def rtf(self) -> Optional[float]:
        if self.audio_delivered_s <= 0 or self.ttfp is None:
            return None
        return self.gen_span_s / self.audio_delivered_s


@dataclass
class Metrics:
    turns: List[TurnRecord] = field(default_factory=list)
    completed_sessions: int = 0
    sim_end: float = 0.0
    # fleet fields (serving/fleet) — zero/empty on single-engine planes
    # so the sim/gateway summary schema stays a strict dict diff
    migrations: int = 0                    # completed cross-replica moves
    migration_bytes: float = 0.0           # KV bytes moved between replicas
    migration_on_path_s: float = 0.0       # charged to a turn start
    migration_off_path_s: float = 0.0      # hidden in the speech window
    replica_occupancy: List[float] = field(default_factory=list)
    # shared-prefix fields (zero when the prefix cache is off, keeping
    # the sim/gateway summary schema a strict dict diff)
    pages_shared: int = 0                  # peak physical pages at rc > 1
    # KV wire-format fields (DESIGN.md §14) — zero on fp32 planes
    kv_wire_bytes_saved: float = 0.0       # logical minus wire bytes moved
    quant_token_flip_rate: float = 0.0     # quality-gate flip rate, if run
    # scenario-suite fields (DESIGN.md §15) — zero on plain workloads
    tool_pauses: int = 0                   # ToolCallStart events observed
    handoffs: int = 0                      # completed client-requested moves
    # speculative-decode fields (DESIGN.md §16) — zero at spec_decode=0
    spec_drafted: int = 0                  # draft tokens fed to verify
    spec_accepted: int = 0                 # drafts matching the argmax
    spec_rejected: int = 0                 # drafts rolled back
    spec_rounds: int = 0                   # verify rounds with >= 1 draft

    def ttfps(self):
        return sorted(t.ttfp for t in self.turns if t.ttfp is not None)

    def percentile(self, vals, p):
        if not vals:
            return float("nan")
        i = min(len(vals) - 1, int(math.ceil(p / 100 * len(vals))) - 1)
        return vals[max(0, i)]

    def p90_ttfp(self):
        return self.percentile(self.ttfps(), 90)

    def continuity(self):
        done = [t for t in self.turns
                if t.completed and not t.barged and t.ttfp is not None]
        if not done:
            return float("nan")
        return sum(t.continuous for t in done) / len(done)

    def waste_ratio(self):
        gen = sum(t.talker_generated for t in self.turns)
        waste = sum(t.talker_wasted for t in self.turns)
        return waste / gen if gen else 0.0

    def completed_rps(self):
        n = sum(1 for t in self.turns if t.completed or t.barged)
        return n / self.sim_end if self.sim_end > 0 else 0.0

    def reload_overlap_frac(self) -> float:
        """Fraction of modeled reload seconds completed off the turn
        critical path (speech-time preload chunks that drained before
        the turn started) — the paper's 'most reload work moves off the
        next-turn critical path' claim, as one number. 0.0 when the
        workload never reloaded (nothing was hidden — and a NaN would
        poison the summary-dict comparisons determinism tests rely
        on)."""
        on = sum(t.reload_stall_s for t in self.turns)
        off = sum(t.reload_off_path_s for t in self.turns)
        if on + off <= 0.0:
            return 0.0
        return off / (on + off)

    def migration_off_path(self) -> float:
        """Share of modeled migration seconds kept off the next-turn
        critical path (source drain + destination page-in during the
        speech window vs charged at turn start). Same 0.0-not-NaN
        convention as ``reload_overlap_frac``."""
        tot = self.migration_on_path_s + self.migration_off_path_s
        if tot <= 0.0:
            return 0.0
        return self.migration_off_path_s / tot

    def deadline_miss_rate(self) -> float:
        """Fraction of full-duplex output frames emitted past their
        per-frame deadline — the periodic-real-time analogue of TTFP.
        Same 0.0-not-NaN convention as ``reload_overlap_frac``."""
        frames = sum(t.frames for t in self.turns)
        if frames <= 0:
            return 0.0
        return sum(t.deadline_misses for t in self.turns) / frames

    def tool_pause_reloads(self) -> int:
        """Resume turns that had to move KV at all (evicted during the
        tool pause) — each is a resume-without-reprefill the protection
        state failed to make free."""
        return sum(1 for t in self.turns if t.tool_resumed
                   and t.reload_stall_s + t.reload_off_path_s > 0.0)

    def tool_resume_off_path(self) -> float:
        """Of the reload seconds spent resuming tool pauses, the share
        hidden in the tool-result gap (off the resume turn's critical
        path). Same 0.0-not-NaN convention as above."""
        on = sum(t.reload_stall_s for t in self.turns if t.tool_resumed)
        off = sum(t.reload_off_path_s for t in self.turns
                  if t.tool_resumed)
        if on + off <= 0.0:
            return 0.0
        return off / (on + off)

    def prefix_hit_frac(self) -> float:
        """Fraction of all prompt tokens served by attaching to the
        shared prefix cache instead of prefilling. Same 0.0-not-NaN
        convention as ``reload_overlap_frac``."""
        hit = sum(t.prefix_hit_tokens for t in self.turns)
        tot = sum(t.prompt_tokens for t in self.turns)
        if tot <= 0:
            return 0.0
        return hit / tot

    def spec_accept_rate(self) -> float:
        """Fraction of drafted tokens the verify step accepted. Same
        0.0-not-NaN convention as ``reload_overlap_frac``."""
        if self.spec_drafted <= 0:
            return 0.0
        return self.spec_accepted / self.spec_drafted

    def spec_tokens_per_launch(self) -> float:
        """Mean committed tokens per speculative verify launch
        (pending + accepted drafts); 1.0 is the non-spec floor, 0.0
        when speculation never ran (0.0-not-NaN convention)."""
        if self.spec_rounds <= 0:
            return 0.0
        return (self.spec_rounds + self.spec_accepted) / self.spec_rounds

    def summary(self) -> dict:
        tt = self.ttfps()
        rtfs = sorted(t.rtf for t in self.turns if t.rtf is not None)
        stalls = [t.reload_stall_s for t in self.turns]
        offs = [t.reload_off_path_s for t in self.turns]
        return {
            "turns": len(self.turns),
            "p50_ttfp": self.percentile(tt, 50),
            "p90_ttfp": self.percentile(tt, 90),
            "p95_ttfp": self.percentile(tt, 95),
            "continuity": self.continuity(),
            "waste_ratio": self.waste_ratio(),
            "completed_rps": self.completed_rps(),
            "p50_rtf": self.percentile(rtfs, 50),
            "p90_rtf": self.percentile(rtfs, 90),
            "mean_reload_stall": (sum(stalls) / len(stalls)
                                  if stalls else 0.0),
            "mean_reload_off_path": (sum(offs) / len(offs)
                                     if offs else 0.0),
            "reload_overlap_frac": self.reload_overlap_frac(),
            "migrations": self.migrations,
            "migration_bytes": self.migration_bytes,
            "migration_off_path_s": self.migration_off_path_s,
            "migration_off_path": self.migration_off_path(),
            "replica_occupancy": list(self.replica_occupancy),
            "prefix_hit_tokens": sum(t.prefix_hit_tokens
                                     for t in self.turns),
            "prefix_hit_frac": self.prefix_hit_frac(),
            "pages_shared": self.pages_shared,
            "kv_wire_bytes_saved": self.kv_wire_bytes_saved,
            "quant_token_flip_rate": self.quant_token_flip_rate,
            "deadline_miss_rate": self.deadline_miss_rate(),
            "frames": sum(t.frames for t in self.turns),
            "tool_pauses": self.tool_pauses,
            "tool_pause_reloads": self.tool_pause_reloads(),
            "tool_resume_off_path": self.tool_resume_off_path(),
            "handoffs": self.handoffs,
            "spec_drafted": self.spec_drafted,
            "spec_accepted": self.spec_accepted,
            "spec_rejected": self.spec_rejected,
            "spec_accept_rate": self.spec_accept_rate(),
            "spec_tokens_per_launch": self.spec_tokens_per_launch(),
        }
