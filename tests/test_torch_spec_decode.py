"""The port's speculative multi-token decode against the JAX package's.

- the proposer cases of ``tests/test_spec_decode.py``, on the JAX
  package's copy of ``serving/spec_decode.py`` and on the port's;
- that file's seeded multi-turn drive (chunked prefill, random decode
  grants carrying the draft budget, a mid-decode barge, a physical
  evict + reload across turns) on the JAX engine and on the port's,
  over its sweep of seeds and draft depths with the junk proposer
  (every draft rolled back) and with the n-gram proposer: identical
  token histories, event streams, turn stats and speculation counters,
  each fed row's logits within 1e-4; and within the port, the spec
  plane against its ``spec_decode=0`` control, barging at the same
  emitted-token count;
- rollback conserves pages, partial acceptance balances the counters,
  spec together with the prefix cache, the generation budget is never
  overrun, and a frontier cap over emitted audio is overshot by at most
  one round's accepted tokens.

The verify step unembeds every position ([B*Q, d] @ [d, V]) where the
non-spec step unembeds one row per slot; the two product shapes may
round differently, so logits are held to 1e-4 and tokens exactly.
"""
import jax
import numpy as np
import pytest

import repro.serving.paged_engine as jpe
import repro.serving.spec_decode as jsd
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import init_params as j_init_params
import repro_torch.serving.paged_engine as tpe
import repro_torch.serving.spec_decode as tsd
from repro_torch.configs import get_config, reduced
from repro_torch.models.model import params_from_numpy

LOGIT_TOL = 1e-4
MODS = {"jax": jsd, "torch": tsd}


@pytest.fixture(scope="module")
def tiny():
    jcfg = j_reduced(j_get_config("qwen2-1.5b"), layers=2, d_model=64,
                     vocab=331)
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = reduced(get_config("qwen2-1.5b"), layers=2, d_model=64,
                   vocab=331)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")

    def make(framework, **kw):
        if framework == "jax":
            return jpe.PagedRealtimeEngine(jcfg, jp, **kw)
        return tpe.PagedRealtimeEngine(tcfg, tp, device="cpu", **kw)
    return tcfg, make


def _tap(eng):
    eng.taps = []
    eng.logit_tap = lambda sid, lg: eng.taps.append((sid, np.array(lg)))
    return eng


def _close_taps(got, want):
    assert [s for s, _ in got] == [s for s, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=LOGIT_TOL, atol=LOGIT_TOL)


def _counters(eng):
    return (eng.spec_drafted, eng.spec_accepted, eng.spec_rejected,
            eng.spec_rounds, eng.fused_launches)


# ======================================================================
# proposer units, on both copies
# ======================================================================
@pytest.mark.parametrize("fw", MODS)
def test_ngram_proposer(fw):
    m = MODS[fw]
    p = m.NGramProposer(max_ngram=3)
    h = [1, 2, 3] * 3
    assert p.propose(h, 3) == [1, 2, 3]
    assert p.propose(h, 5) == [1, 2, 3, 1, 2]
    # an older occurrence that fills the budget beats a closer one
    assert m.NGramProposer(max_ngram=2).propose(
        [1, 2, 3, 4, 9, 1, 2], 3) == [3, 4, 9]
    p = m.NGramProposer()
    assert p.propose([1, 2, 3, 4, 5], 4) == []
    assert p.propose([7], 4) == []
    assert p.propose([1, 2, 1, 2], 0) == []


@pytest.mark.parametrize("fw", MODS)
def test_scripted_proposer_and_dispatch(fw):
    m = MODS[fw]
    p = m.ScriptedProposer({"a": [[5, 6, 7], [8]]})
    p.session_id = "a"
    assert [p.propose([0], 2), p.propose([0], 4), p.propose([0], 4)] == \
        [[5, 6], [8], []]
    p.session_id = "b"
    assert p.propose([0], 4) == []
    assert isinstance(m.build_proposer("ngram"), m.NGramProposer)
    obj = m.ScriptedProposer()
    assert m.build_proposer(obj) is obj
    with pytest.raises(NotImplementedError):
        m.build_proposer(m.DraftModelConfig(name="toy"))
    with pytest.raises(AssertionError):
        m.build_proposer(42)


def test_ngram_proposals_match_jax():
    """Both copies draft the same tokens over seeded histories."""
    rng = np.random.default_rng(0)
    for _ in range(200):
        h = list(rng.integers(0, 6, size=int(rng.integers(1, 30))))
        k = int(rng.integers(0, 6))
        n = int(rng.integers(1, 4))
        assert tsd.NGramProposer(max_ngram=n).propose(h, k) == \
            jsd.NGramProposer(max_ngram=n).propose(h, k)


def test_spec_requires_fused_plane(tiny):
    _, make = tiny
    with pytest.raises(AssertionError, match="fused"):
        make("torch", slots=2, page_size=4, pages_per_seq=8,
             fused_step=False, spec_decode=2)


def _junk_proposer(vocab):
    """Drafts the argmax (almost surely) never confirms: every decode
    round drafts and every draft rolls back."""

    class _Junk:
        session_id = None

        def propose(self, history, k):
            return [(int(history[-1]) + 1 + i) % vocab for i in range(k)]

    return _Junk()


# ======================================================================
# the seeded drive of tests/test_spec_decode.py, on either engine
# ======================================================================
def _drive(make, vocab, seed, *, spec, proposer=None, max_chunk=4,
           barge_emit=None, evict_pages=4, prefix_cache=False):
    """Returns (histories, per-slot client events, turn stats, evicted
    pages, engine)."""
    rng = np.random.default_rng(seed)
    grng = np.random.default_rng(seed + 7777)
    unit = rng.integers(0, vocab, size=3)
    pa = np.tile(unit, 4)
    pb = rng.integers(0, vocab, size=int(rng.integers(5, 10)))
    mna = int(rng.integers(6, 10))
    mnb = int(rng.integers(4, 8))
    pa2 = np.tile(unit, 3)
    pa3 = rng.integers(0, vocab, size=int(rng.integers(3, 7)))
    mna3 = int(rng.integers(3, 6))

    eng = _tap(make(slots=2, page_size=4, pages_per_seq=16, num_pages=32,
                    fused_step=True, spec_decode=spec, proposer=proposer,
                    prefix_cache=prefix_cache))
    events = {}

    def emitted_of_a():
        s = next((s for s in eng.slot_state.values()
                  if s is not None and s.session_id == "a"), None)
        return len(s.tokens) if s is not None else None

    def drive(live, barge=False):
        rounds = 0
        while eng.active() and rounds < 500:
            grants = {}
            for slot, sid in list(live.items()):
                s = eng.slot_state[slot]
                if s is None or s.session_id != sid \
                        or not s.request.is_live():
                    continue
                g = int(grng.integers(1, max_chunk + 1))
                if s.request.phase.name == "DECODE":   # either engine's
                    g += spec
                grants[slot] = g
            if not grants:
                break
            for slot, evs in eng.run_round(grants).items():
                events.setdefault(slot, []).extend(
                    e for e in evs if e[0] != "prefill")
            eng.check_invariants()
            rounds += 1
            if barge and barge_emit is not None:
                e = emitted_of_a()
                if e is not None and e >= barge_emit:
                    eng.barge_in("a")
                    return

    sa = eng.submit_turn("a", pa, max_new_tokens=mna)
    sb = eng.submit_turn("b", pb, max_new_tokens=mnb)
    drive({sa: "a", sb: "b"})
    evicted = eng.kv.evict(evict_pages, eng.clock.now())
    eng.flush_transfers()
    sa2 = eng.submit_turn("a", pa2, max_new_tokens=10)
    drive({sa2: "a"}, barge=True)
    sa3 = eng.submit_turn("a", pa3, max_new_tokens=mna3)
    drive({sa3: "a"})
    eng.check_invariants()
    assert eng.spec_accepted + eng.spec_rejected == eng.spec_drafted
    hist = {sid: s.history for sid, s in eng.sessions.items()}
    stats = {sid: [(t["re_prefill_tokens"], t["generated"], t["aborted"])
                   for t in s.turn_stats]
             for sid, s in eng.sessions.items()}
    return hist, events, stats, evicted, eng


SWEEP = [(0, 2), (1, 4), (2, 1), (3, 4), (4, 3)]


@pytest.fixture(scope="module")
def drives(tiny):
    cfg, make = tiny
    cache = {}

    def get(framework, seed, spec, proposer="junk", barge_emit=2):
        key = (framework, seed, spec, proposer, barge_emit)
        if key not in cache:
            prop = _junk_proposer(cfg.vocab_size) \
                if proposer == "junk" and spec else None
            cache[key] = _drive(
                lambda **kw: make(framework, **kw), cfg.vocab_size, seed,
                spec=spec, proposer=prop, barge_emit=barge_emit)
        return cache[key]
    return get


def _same_drive(got, want):
    assert got[0] == want[0], "token histories diverged"
    assert got[1] == want[1], "client event streams diverged"
    assert got[2] == want[2], "turn stats diverged"
    assert got[3] == want[3], "evicted pages diverged"


@pytest.mark.parametrize("seed,spec", SWEEP)
def test_spec_drive_matches_jax(drives, seed, spec):
    """Junk drafts: every decode round drafts and rolls back, on both
    engines alike."""
    want = drives("jax", seed, spec)
    got = drives("torch", seed, spec)
    _same_drive(got, want)
    assert _counters(got[4]) == _counters(want[4])
    assert got[4].spec_drafted > 0 and got[4].spec_rejected > 0
    assert got[4].kv.reloaded_blocks == want[4].kv.reloaded_blocks
    _close_taps(got[4].taps, want[4].taps)


@pytest.mark.parametrize("seed,spec", SWEEP)
def test_spec_drive_matches_its_control(drives, seed, spec):
    """Within the port, the spec plane commits the greedy stream: the
    ``spec_decode=0`` control, barged at the emitted-token count the
    spec run was barged at, gives the same histories, events and
    stats."""
    got = drives("torch", seed, spec)
    aborted = got[2]["a"][1][2]
    emitted = len(got[0]["a"][1]) if aborted else None
    want = drives("torch", seed, 0, barge_emit=emitted)
    _same_drive(got, want)


@pytest.mark.parametrize("seed", [0, 3])
def test_spec_ngram_stream_matches_jax_and_control(drives, seed):
    """The n-gram proposer (whatever it drafts and whatever sticks) on
    both engines, and lossless against the port's control."""
    want = drives("jax", seed, 4, proposer="ngram")
    got = drives("torch", seed, 4, proposer="ngram")
    _same_drive(got, want)
    assert _counters(got[4]) == _counters(want[4])
    assert got[4].spec_accepted > 0
    _close_taps(got[4].taps, want[4].taps)
    aborted = got[2]["a"][1][2]
    emitted = len(got[0]["a"][1]) if aborted else None
    _same_drive(got, drives("torch", seed, 0, barge_emit=emitted))


# ======================================================================
# rollback conservation, partial acceptance, prefix sharing
# ======================================================================
def test_spec_rejection_rolls_back_and_conserves_pages(tiny):
    cfg, make = tiny
    prompt = np.random.default_rng(5).integers(0, cfg.vocab_size, size=7)

    def run(fw, spec, proposer=None):
        eng = make(fw, slots=2, page_size=4, pages_per_seq=8,
                   num_pages=24, fused_step=True, spec_decode=spec,
                   proposer=proposer)
        free0 = eng.pool.free_pages
        eng.add_session("a", prompt, max_new_tokens=9)
        eng.run_to_completion()
        eng.check_invariants()
        hist = eng.sessions["a"].history
        held = len(eng.pool.seq("a").pages)
        eng.end_session("a")
        eng.check_invariants()
        return eng, free0, hist, held

    eng, free0, hist, held = run("torch", 4, _junk_proposer(cfg.vocab_size))
    assert eng.spec_rejected > 0
    assert eng.spec_accepted + eng.spec_rejected == eng.spec_drafted
    assert eng.pool.free_pages == free0
    _, _, want, held0 = run("torch", 0)
    assert hist == want and held == held0
    jeng, _, jhist, jheld = run("jax", 4, _junk_proposer(cfg.vocab_size))
    assert (hist, held, _counters(eng)) == (jhist, jheld, _counters(jeng))


def test_spec_partial_acceptance_accounting(tiny):
    """First draft right, second wrong, every round: the counters
    balance, both engines count alike, and generation stops exactly at
    max_new_tokens."""
    cfg, make = tiny
    prompt = np.random.default_rng(8).integers(0, cfg.vocab_size, size=6)
    eng0 = make("torch", slots=1, page_size=4, pages_per_seq=8,
                fused_step=True)
    eng0.add_session("a", prompt, max_new_tokens=8)
    eng0.run_to_completion()
    greedy = list(eng0.sessions["a"].history[-1])

    class _HalfRight:
        session_id = None

        def propose(self, history, k):
            g = len(history) - len(prompt)
            good = greedy[g:g + 1]
            if not good or k < 2:
                return good
            return [good[0], (good[0] + 1) % cfg.vocab_size]

    got = {}
    for fw in ("torch", "jax"):
        eng = make(fw, slots=1, page_size=4, pages_per_seq=8,
                   fused_step=True, spec_decode=3, proposer=_HalfRight())
        eng.add_session("a", prompt, max_new_tokens=8)
        eng.run_to_completion()
        eng.check_invariants()
        assert eng.sessions["a"].history == eng0.sessions["a"].history
        assert eng.spec_accepted + eng.spec_rejected == eng.spec_drafted
        assert eng.spec_rejected > 0 and eng.spec_accepted > 0
        assert eng.sessions["a"].turn_stats[-1]["generated"] == 8
        got[fw] = _counters(eng)
    assert got["torch"] == got["jax"]


def test_spec_with_prefix_cache_shared_pages(tiny):
    """Drafts with the radix prefix cache live: a second session
    attaching the first one's pages drafts without perturbing them —
    streams equal the non-spec control's, both planes end with the same
    pool population, and the JAX engine counts alike."""
    cfg, make = tiny
    fam = np.tile(np.random.default_rng(11).integers(
        0, cfg.vocab_size, size=4), 3)

    def run(fw, spec):
        eng = make(fw, slots=2, page_size=4, pages_per_seq=8,
                   num_pages=32, fused_step=True, prefix_cache=True,
                   spec_decode=spec,
                   proposer=_junk_proposer(cfg.vocab_size) if spec
                   else None)
        eng.add_session("a", fam, max_new_tokens=6)
        eng.run_to_completion()
        eng.add_session("b", fam, max_new_tokens=6)
        eng.run_to_completion()
        eng.check_invariants()
        assert eng.prefix_cache.hit_tokens > 0
        hists = (eng.sessions["a"].history, eng.sessions["b"].history)
        eng.end_session("a")
        eng.end_session("b")
        eng.check_invariants()
        return hists, eng.pool.free_pages, eng

    want, free_want, _ = run("torch", 0)
    got, free_got, eng = run("torch", 3)
    assert got == want and free_got == free_want
    assert eng.spec_rejected > 0
    assert eng.spec_accepted + eng.spec_rejected == eng.spec_drafted
    jgot, jfree, jeng = run("jax", 3)
    assert (got, free_got, _counters(eng), eng.cow_copies) == \
        (jgot, jfree, _counters(jeng), jeng.cow_copies)


# ======================================================================
# budgets and the frontier cap count accepted tokens only
# ======================================================================
@pytest.mark.parametrize("max_new", [1, 2, 5])
def test_spec_never_overruns_generation_budget(tiny, max_new):
    cfg, make = tiny
    rng = np.random.default_rng(3)
    prompt = np.tile(rng.integers(0, cfg.vocab_size, size=3), 3)
    for prop in (None, _junk_proposer(cfg.vocab_size)):
        eng = make("torch", slots=1, page_size=4, pages_per_seq=8,
                   fused_step=True, spec_decode=4, proposer=prop)
        eng.add_session("a", prompt, max_new_tokens=max_new)
        eng.run_to_completion()
        eng.check_invariants()
        assert eng.sessions["a"].turn_stats[-1]["generated"] == max_new


def _frontier_drive(make, vocab, spec, *, apt=0.25, cap=2.0, dt=0.05):
    """A playback frontier over emitted audio, as the gateway keeps it:
    each emitted token buffers ``apt`` seconds of audio, playback drains
    ``dt`` per round, and a slot whose buffer is at or past ``cap`` is
    not granted that round. Returns (worst over-frontier excursion,
    per-round emissions, histories, engine)."""
    rng = np.random.default_rng(4)
    eng = make(slots=3, page_size=4, pages_per_seq=16, num_pages=48,
               fused_step=True, spec_decode=spec)
    slots = {}
    for i in range(3):
        unit = rng.integers(0, vocab, size=3)
        slots[eng.submit_turn(f"s{i}", np.tile(unit, 3), 14)] = f"s{i}"
    buf = dict.fromkeys(slots, 0.0)
    worst, emitted = 0.0, []
    for _ in range(400):
        if not eng.active():
            break
        grants = {}
        for slot in slots:
            s = eng.slot_state[slot]
            if s is None or not s.request.is_live():
                continue
            if s.request.phase.name == "PREFILL":
                grants[slot] = 4
            elif buf[slot] < cap:
                grants[slot] = 1 + spec
        evs = eng.run_round(grants)
        row = {}
        for slot, es in evs.items():
            n = sum(1 for e in es if e[0] == "token")
            row[slots[slot]] = n
            buf[slot] += n * apt
            worst = max(worst, buf[slot] - cap)
        emitted.append(row)
        for slot in buf:
            buf[slot] = max(0.0, buf[slot] - dt)
    return worst, emitted, {s: x.history for s, x in
                            eng.sessions.items()}, eng


def test_frontier_cap_counts_accepted_tokens_only(tiny):
    """The frontier moves on emitted (accepted) tokens only, so the
    worst overshoot is one round's accepted emission, (1 + K) tokens of
    audio, never the drafted count; both engines emit alike round by
    round, and the streams are the K = 0 control's."""
    cfg, make = tiny
    apt, K = 0.25, 4
    worst, emitted, hist, eng = _frontier_drive(
        lambda **kw: make("torch", **kw), cfg.vocab_size, K, apt=apt)
    jworst, jemitted, jhist, jeng = _frontier_drive(
        lambda **kw: make("jax", **kw), cfg.vocab_size, K, apt=apt)
    assert (worst, emitted, hist) == (jworst, jemitted, jhist)
    assert _counters(eng) == _counters(jeng)
    assert eng.spec_accepted > 0
    assert max(n for row in emitted for n in row.values()) <= 1 + K
    assert worst <= (1 + K) * apt + 1e-9
    gen = {sid: t["generated"] for sid, s in eng.sessions.items()
           for t in s.turn_stats}
    # the prefill's token is not generated; the last generated one is
    # reported as "finished", not played
    assert gen == {sid: sum(r.get(sid, 0) for r in emitted)
                   for sid in gen}
    _, _, control, _ = _frontier_drive(
        lambda **kw: make("torch", **kw), cfg.vocab_size, 0, apt=apt)
    assert hist == control
