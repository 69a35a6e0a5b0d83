"""Stage execution cost models + the two Omni pipeline stand-ins.

The paper's testbed models (Qwen3-Omni, Ming-Flash-Omni 2.0) are not
available offline; these pipeline specs preserve the relevant structure —
stage graph, chunked hand-off, audio codec rate, per-token KV footprint —
with per-round costs calibrated so a solo session reproduces the paper's
Fig. 15 example (≈8 s generation for ≈66 s of audio on the baseline).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass(frozen=True)
class StageCost:
    round_overhead_s: float
    prefill_token_s: float
    decode_token_s: float          # per decode request per round


@dataclass(frozen=True)
class StageSpec:
    name: str
    cost: StageCost
    kv_bytes_per_token: float = 0.0
    kv_capacity_blocks: int = 0
    block_size: int = 16
    token_budget: int = 2048       # per scheduling round
    max_batch: int = 64


@dataclass(frozen=True)
class PipelineSpec:
    name: str
    stages: List[StageSpec]
    # cross-stage coupling
    thinker_chunk: int = 8         # thinker tokens per talker hand-off chunk
    speech_per_text: int = 4       # talker tokens per thinker token
    vocoder_chunk: int = 16        # talker tokens per audio fragment
    vocoder_chunk_s: float = 0.004
    audio_per_token_s: float = 0.08
    encode_delay_s: float = 0.15   # utterance -> embeddings -> orchestrator
    pcie_gb_s: float = 25.0

    def stage(self, name: str) -> StageSpec:
        return next(s for s in self.stages if s.name == name)


def qwen3_omni_like(kv_capacity_gb: float = 6.0) -> PipelineSpec:
    """3-stage pipeline: encoder colocated with thinker; vocoder with
    talker (paper §7.1 footnote). DP replicas are folded into the
    stage-level cost constants."""
    kv_tok = 147_456.0   # 36L*2*8kv*128hd*2B — qwen3-4b-class backbone
    talker_tok = 36_864.0
    cap = int(kv_capacity_gb * 1e9 / (kv_tok * 16))
    return PipelineSpec(
        name="qwen3-omni-like",
        stages=[
            StageSpec("thinker",
                      StageCost(round_overhead_s=0.010,
                                prefill_token_s=0.00004,
                                decode_token_s=0.002),
                      kv_bytes_per_token=kv_tok,
                      kv_capacity_blocks=cap, block_size=16),
            StageSpec("talker",
                      StageCost(round_overhead_s=0.004,
                                prefill_token_s=0.00002,
                                decode_token_s=0.004),
                      kv_bytes_per_token=talker_tok,
                      kv_capacity_blocks=cap * 2, block_size=16),
        ],
    )


def ming_omni_like(kv_capacity_gb: float = 6.0) -> PipelineSpec:
    """2-stage pipeline (TP=2,DP=2 thinker + DP=4 talker): heavier MoE
    thinker, faster talker."""
    kv_tok = 196_608.0
    talker_tok = 49_152.0
    cap = int(kv_capacity_gb * 1e9 / (kv_tok * 16))
    return PipelineSpec(
        name="ming-omni-like",
        stages=[
            StageSpec("thinker",
                      StageCost(round_overhead_s=0.014,
                                prefill_token_s=0.00005,
                                decode_token_s=0.0025),
                      kv_bytes_per_token=kv_tok,
                      kv_capacity_blocks=cap, block_size=16),
            StageSpec("talker",
                      StageCost(round_overhead_s=0.003,
                                prefill_token_s=0.00002,
                                decode_token_s=0.003),
                      kv_bytes_per_token=talker_tok,
                      kv_capacity_blocks=cap * 2, block_size=16),
        ],
        thinker_chunk=8, speech_per_text=4,
    )


PIPELINES = {
    "qwen3-omni-like": qwen3_omni_like,
    "ming-omni-like": ming_omni_like,
}
