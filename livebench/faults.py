"""Faults planted in the timed path, to see ``correct`` come out false:
the tests run each at a tiny size on the CPU, and ``run.py --fault
<name>`` plants one in a run on the card (never in a check's runs).
Each is called with the built gateway, before the probe wraps it."""
from __future__ import annotations

import torch


def altered_tokens(gw) -> None:
    """Every token served is altered where it is produced."""
    eng = gw.engine
    run = eng.run_round

    def altered(chunks):
        ev = run(chunks)
        return {s: [(k, (v + 1) % eng.cfg.vocab_size) if k == "token"
                    else (k, v) for k, v in e] for s, e in ev.items()}
    eng.run_round = altered


def state_unchanged(gw) -> None:
    """The step returns the page store unchanged."""
    eng = gw.engine
    step = eng._fused_fn

    def frozen(cfg, params, tokens, positions, k_pages, v_pages, *a, **kw):
        return step(cfg, params, tokens, positions, k_pages.clone(),
                    v_pages.clone(), *a, **kw)
    eng._fused_fn = frozen


def half_batch(gw) -> None:
    """The upper half of the batch's rows is left out: each takes the
    mean of the rest's logits."""
    eng = gw.engine
    step = eng._fused_fn

    def half(cfg, params, tokens, *a, **kw):
        out = step(cfg, params, tokens, *a, **kw)
        h = out.shape[0] // 2
        return torch.cat([out[:h], out[:h].mean(0, keepdim=True)
                          .expand(out.shape[0] - h, -1)])
    eng._fused_fn = half


FAULTS = {f.__name__: f for f in (altered_tokens, state_unchanged,
                                  half_batch)}
