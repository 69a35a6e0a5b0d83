"""Synthetic token pipeline (offline container: no external corpora).

Generates a deterministic mixture of structured sequences (copy runs,
arithmetic-progression spans, Zipf-sampled vocabulary) so a ~100M model
shows a real, falling loss curve within a few hundred steps — not pure
noise, not memorizable constants.
"""
from __future__ import annotations

import numpy as np


def synthetic_batches(vocab_size: int, batch: int, seq: int, *,
                      seed: int = 0):
    rng = np.random.default_rng(seed)
    zipf_p = 1.0 / np.arange(1, vocab_size + 1) ** 1.1
    zipf_p /= zipf_p.sum()
    while True:
        toks = rng.choice(vocab_size, size=(batch, seq), p=zipf_p)
        # structure: repeat spans (copy task) make next-token predictable
        for b in range(batch):
            n_spans = rng.integers(2, 6)
            for _ in range(n_spans):
                ln = int(rng.integers(8, 32))
                src = int(rng.integers(0, seq - 2 * ln))
                dst = int(rng.integers(src + ln, seq - ln))
                toks[b, dst:dst + ln] = toks[b, src:src + ln]
        tokens = toks.astype(np.int32)
        labels = np.roll(tokens, -1, axis=1)
        weights = np.ones_like(tokens, np.float32)
        weights[:, -1] = 0.0
        yield {"tokens": tokens, "labels": labels, "weights": weights}
