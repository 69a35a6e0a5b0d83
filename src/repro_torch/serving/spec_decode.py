"""Draft proposers for speculative multi-token decode (DESIGN.md §16).

A proposer is anything with ``propose(history, k) -> list[int]``: given
the session's committed token history (prompt + accepted output,
*including* the pending token about to be fed), return up to ``k``
guessed next tokens. The engine feeds ``[pending] + drafts`` as one
fused multi-token row, verifies every position in the same launch via
``paged_prefill_attention``'s intra-chunk causal mask, and accepts the
longest prefix of drafts matching the model's own argmax — so any
proposer, however bad, is *lossless*: a wrong guess costs KV writes
that are rolled back, never a wrong token.

``NGramProposer`` is the self-speculative default (prompt lookup, the
"assisted generation" trick): find the most recent earlier occurrence
of the history's trailing n-gram and replay what followed it. Sessions
replaying structured prompts (tool-call scaffolding, shared system
prefixes) hit long runs; random traffic degrades to zero-length drafts,
i.e. plain decode.

``DraftModelConfig`` is the hook for a small draft LM: the engine
accepts any proposer object, so wiring a real draft model is config +
a propose() adapter, no engine changes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence


class NGramProposer:
    """Prompt-lookup drafting over the session's own history."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        assert max_ngram >= min_ngram >= 1
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        h = list(history)
        n_hist = len(h)
        if k <= 0 or n_hist < self.min_ngram + 1:
            return []
        for n in range(min(self.max_ngram, n_hist - 1),
                       self.min_ngram - 1, -1):
            suffix = h[-n:]
            # most recent earlier occurrence of the trailing n-gram
            # whose continuation fills the whole draft budget; a match
            # too close to the end (short continuation) only wins when
            # no older occurrence does better
            best: List[int] = []
            for i in range(n_hist - n - 1, -1, -1):
                cont = h[i + n:i + n + k]
                if h[i:i + n] == suffix and len(cont) > len(best):
                    best = cont
                    if len(best) == k:
                        break
            if best:
                return best
        return []


class ScriptedProposer:
    """Deterministic per-session draft scripts — the test/bench oracle
    (a script replaying the model's own greedy outputs yields 100%
    acceptance; a corrupted script exercises rollback)."""

    def __init__(self, scripts: Optional[dict] = None):
        self.scripts = scripts or {}      # sid -> list of draft lists
        self._cursor: dict = {}
        self.session_id: Optional[str] = None   # set by the engine

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        sid = self.session_id
        script = self.scripts.get(sid)
        if not script:
            return []
        i = self._cursor.get(sid, 0)
        if i >= len(script):
            return []
        self._cursor[sid] = i + 1
        return list(script[i])[:k]


@dataclass
class DraftModelConfig:
    """Configuration hook for a small draft LM proposer. Not wired to a
    real model yet: building one raises, keeping the dependency surface
    explicit until a draft checkpoint exists."""
    name: str = ""
    max_draft_tokens: int = 4

    def build(self):
        raise NotImplementedError(
            "draft-model speculation is a config hook only; use the "
            "self-speculative NGramProposer (the default) or any object "
            "with propose(history, k)")


def build_proposer(spec="ngram", **kw):
    """``"ngram"`` | an existing proposer object | a DraftModelConfig."""
    if spec == "ngram":
        return NGramProposer(**kw)
    if isinstance(spec, DraftModelConfig):
        return spec.build()
    assert hasattr(spec, "propose"), f"not a proposer: {spec!r}"
    return spec
