"""The port's single-turn ring-cache engine against the JAX package's.

``RealtimeLLMEngine`` of both frameworks runs the four scenarios of
``tests/test_real_engine.py`` on tiny qwen2 and tiny mamba2 (two layers,
d_model 64, f32) with the same weights, carried across through numpy.
Their tokens must be identical, and identical to the greedy reference
(B = 1 ``prefill`` then ``decode_step``) of each framework: scheduling
moves *when* tokens appear, never *which*.

Two faults of the reference engine are not carried over. Its
``add_session`` grafts the B = 1 prefill cache with ``one[0]``, which
indexes the layer axis, so every layer of the slot gets layer 0's
cache; the port grafts each layer's own row. And a held ssm slot's
state advances with the decode step that its length is rewound from;
the port restores it. The tiny models' greedy tokens with the
reference's initial weights do not depend on either (each session
repeats one token), so the parity checks hold for both engines;
``test_engine_keeps_contract_on_perturbed_weights`` holds the port to
its greedy reference where they do.
"""
import jax
import numpy as np
import pytest
import torch

import repro.serving.engine as jeng
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core.scheduler import SchedulerConfig as JSchedulerConfig
from repro.core.scheduler import UrgencyScheduler as JUrgencyScheduler
from repro.models import decode_step as j_decode_step
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro.models import prefill as j_prefill
import repro_torch.serving.engine as teng
from repro_torch.configs import get_config, reduced
from repro_torch.core.scheduler import SchedulerConfig, UrgencyScheduler
from repro_torch.models import model as TM

MODELS = ["qwen2-1.5b", "mamba2-1.3b"]


@pytest.fixture(scope="module", params=MODELS)
def pair(request):
    jcfg = j_reduced(j_get_config(request.param), layers=2, d_model=64,
                     vocab=331)
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = reduced(get_config(request.param), layers=2, d_model=64,
                   vocab=331)
    return jcfg, jp, tcfg, TM.params_from_numpy(
        jax.tree.map(np.asarray, jp), "cpu")


def _greedy_jax(cfg, params, prompt, n):
    cache = j_init_cache(cfg, 1, 128)
    logits, cache = j_prefill(cfg, params, np.asarray(prompt)[None, :],
                              cache)
    toks = [int(np.argmax(logits[0]))]
    for _ in range(n - 1):
        lg, cache = j_decode_step(cfg, params,
                                  np.asarray([toks[-1]], np.int32), cache)
        toks.append(int(np.argmax(lg[0])))
    return toks


def _greedy_torch(cfg, params, prompt, n):
    cache = TM.init_cache(cfg, 1, 128, "cpu")
    logits, cache = TM.prefill(cfg, params,
                               torch.as_tensor(prompt)[None, :], cache)
    toks = [int(torch.argmax(logits[0]))]
    for _ in range(n - 1):
        lg, cache = TM.decode_step(cfg, params, torch.tensor([toks[-1]]),
                                   cache)
        toks.append(int(torch.argmax(lg[0])))
    return toks


def _every_other(base, config):
    class EveryOther(base):
        """Adversarial policy: admits a rotating single session."""
        def __init__(self, monitor):
            super().__init__(config(), monitor, stage="t")
            self.i = 0

        def schedule(self, ready, budget, now):
            self.i += 1
            d = super().schedule(ready, budget, now)
            keep = [d.batch[self.i % max(1, len(d.batch))]] \
                if d.batch else []
            d.batch = keep
            d.chunks = {r.req_id: 1 for r in keep}
            return d
    return EveryOther


# the four scenarios of tests/test_real_engine.py; each drives an engine
# built by ``make(slots)`` and returns (outputs, {sid: (prompt, n)} to
# hold against the greedy reference, KV accounting)
def _matches_greedy(make, vocab, every_other):
    rng = np.random.default_rng(0)
    prompts = {f"s{i}": rng.integers(0, vocab, size=ln)
               for i, ln in enumerate((7, 11, 5))}
    eng = make(4)
    for sid, p in prompts.items():
        eng.add_session(sid, p, max_new_tokens=10)
    out = eng.run_to_completion()
    return out, {s: (p, 10) for s, p in prompts.items()}, ()


def _every_other_scheduler(make, vocab, every_other):
    rng = np.random.default_rng(1)
    prompts = {f"s{i}": rng.integers(0, vocab, size=6) for i in range(3)}
    eng = make(4)
    eng.scheduler = every_other(eng.monitor)
    for sid, p in prompts.items():
        eng.add_session(sid, p, max_new_tokens=8)
    out = eng.run_to_completion(max_rounds=200)
    return out, {s: (p, 8) for s, p in prompts.items()}, ()


def _commit_releases(make, vocab, every_other):
    rng = np.random.default_rng(7)
    eng = make(2)
    eng.add_session("a", rng.integers(0, vocab, size=7), 5)
    out = dict(eng.run_to_completion())
    acct = [eng.kv.working_blocks, eng.kv.session("a").total_blocks]
    eng.add_session("b", rng.integers(0, vocab, size=7), 50)
    eng.step()
    eng.abort("b")
    acct.append(eng.kv.working_blocks)
    assert acct == [0, eng.kv.blocks_of(12), 0]
    return out, {}, tuple(acct)


def _abort_frees_slot(make, vocab, every_other):
    rng = np.random.default_rng(2)
    eng = make(2)
    eng.add_session("a", rng.integers(0, vocab, size=5), 50)
    eng.add_session("b", rng.integers(0, vocab, size=5), 6)
    for _ in range(3):
        eng.step()
    eng.abort("a")                       # barge-in on a
    assert eng.free_slot() is not None
    p3 = rng.integers(0, vocab, size=4)
    eng.add_session("c", p3, 6)
    out = eng.run_to_completion(max_rounds=100)
    acct = (eng.kv.session("a").total_blocks,)
    assert acct[0] > 0
    return out, {"c": (p3, 6)}, acct


SCENARIOS = {"matches_greedy": _matches_greedy,
             "every_other": _every_other_scheduler,
             "commit_releases": _commit_releases,
             "abort_frees_slot": _abort_frees_slot}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_single_turn_engine_matches_jax(pair, scenario):
    jcfg, jp, tcfg, tp = pair
    run = SCENARIOS[scenario]
    j_out, j_ref, j_acct = run(
        lambda slots: jeng.RealtimeLLMEngine(jcfg, jp, slots=slots,
                                             capacity=128),
        jcfg.vocab_size, _every_other(JUrgencyScheduler, JSchedulerConfig))
    t_out, t_ref, t_acct = run(
        lambda slots: teng.RealtimeLLMEngine(tcfg, tp, slots=slots,
                                             capacity=128, device="cpu"),
        tcfg.vocab_size, _every_other(UrgencyScheduler, SchedulerConfig))
    assert t_out == j_out
    assert t_acct == j_acct
    for sid, (prompt, n) in t_ref.items():
        want = _greedy_torch(tcfg, tp, prompt, n)
        assert t_out[sid] == want == _greedy_jax(jcfg, jp, prompt, n), sid


def test_graft_writes_every_layer(pair):
    """After add_session the slot holds the B = 1 prefill's cache in
    every layer, and no other slot changed."""
    _, _, tcfg, tp = pair
    eng = teng.RealtimeLLMEngine(tcfg, tp, slots=3, capacity=32,
                                 device="cpu")
    before = {k: v.clone() for k, v in eng.cache.items()}
    prompt = np.arange(9) + 5
    eng.add_session("a", prompt, 4)
    slot = 0
    c1 = TM.init_cache(tcfg, 1, 32, "cpu")
    _, c1 = TM.prefill(tcfg, tp, torch.as_tensor(prompt)[None, :], c1)
    for name, one in c1.items():
        got = eng.cache[name]
        if got.dim() >= 2 and name not in ("kv_pos",):
            assert torch.equal(got[:, slot], one[:, 0]), name
            assert torch.equal(got[:, 1:], before[name][:, 1:]), name
        else:
            assert torch.equal(got[slot], one[0]), name
            assert torch.equal(got[1:], before[name][1:]), name


@pytest.mark.parametrize("name", MODELS)
def test_engine_keeps_contract_on_perturbed_weights(name):
    """With every leaf perturbed the tokens vary, and the port's engine
    still gives its greedy reference's tokens, under the adversarial
    scheduler too (which holds slots every round)."""
    from test_torch_model import _pair
    _, _, tcfg, tp = _pair(name)
    seen = set()
    for run in (_matches_greedy, _every_other_scheduler):
        out, ref, _ = run(
            lambda slots: teng.RealtimeLLMEngine(tcfg, tp, slots=slots,
                                                 capacity=128,
                                                 device="cpu"),
            tcfg.vocab_size, _every_other(UrgencyScheduler,
                                          SchedulerConfig))
        for sid, (prompt, n) in ref.items():
            assert out[sid] == _greedy_torch(tcfg, tp, prompt, n), sid
            seen.update(out[sid])
    assert len(seen) > 6
