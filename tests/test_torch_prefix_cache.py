"""The port's shared-prefix KV plane against the JAX package's.

Two layers:

- **pool and radix**: the unit cases of ``tests/test_prefix_cache.py``
  (refcounted attach / copy-on-write / release on ``PagedPool``, and
  ``PrefixCache`` lookup / register / forget / reclaim), each run on
  the JAX package's copy and on the port's copy, which must give the
  same outputs;
- **engine**: a seeded ``submit_turn``/``run_round`` drive over
  shared-prefix prompts (not page-aligned, so the attached tail page is
  copied on write) with an eviction, a barge-in and hang-ups, run on
  the JAX engine and on the port's engine with ``prefix_cache=True``:
  token histories, event streams, turn stats (``prefix_hit_tokens``
  included), ``cow_copies`` and ``peak_shared_pages`` must be identical
  and each fed row's logits within 1e-4. The port's prefix plane must
  also give its own ``prefix_cache=False`` control's tokens.

The JAX engine attends through the Pallas kernel in interpret mode;
the port's CPU path takes the kernel's plain version.
"""
from collections import Counter

import jax
import numpy as np
import pytest

import repro.kvcache.paged as jpaged
import repro.kvcache.prefix_cache as jprefix
import repro.serving.paged_engine as jpe
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import init_params as j_init_params
import repro_torch.kvcache.paged as tpaged
import repro_torch.kvcache.prefix_cache as tprefix
import repro_torch.serving.paged_engine as tpe
from repro_torch.configs import get_config, reduced
from repro_torch.models.model import params_from_numpy

LOGIT_TOL = 1e-4
IMPLS = {"jax": (jpaged, jprefix), "torch": (tpaged, tprefix)}


# ======================================================================
# pool and radix: each case returns what it observed
# ======================================================================
def case_attach_refcounts_and_release_report(paged, _):
    pool = paged.PagedPool(num_pages=8, page_size=4)
    pool.ensure_capacity("a", 8)
    pages = list(pool.seq("a").pages)
    pool.attach_prefix("b", pages, 8)
    assert pool.seq("b").pages == pages and pool.seq("b").length == 8
    assert all(pool.refcount[p] == 2 for p in pages)
    assert pool.free_pages == 6
    rep_a = pool.release("a")
    assert rep_a == {"freed_own": 0, "freed_orphan": 0, "orphaned": 2}
    assert all(pool.page_owner[p] is None for p in pages)
    rep_b = pool.release("b")
    assert rep_b == {"freed_own": 0, "freed_orphan": 2, "orphaned": 0}
    assert pool.free_pages == 8 and not pool.refcount
    return pages, rep_a, rep_b


def case_cache_held_pages_survive_release(paged, _):
    pool = paged.PagedPool(num_pages=8, page_size=4)
    pool.ensure_capacity("a", 8)
    pages = list(pool.seq("a").pages)
    pool.cache_held.update(pages)
    rep = pool.release("a")
    assert rep == {"freed_own": 0, "freed_orphan": 0, "orphaned": 2}
    assert all(pool.refcount[p] == 0 for p in pages)
    free = pool.free_pages
    assert free == 6
    assert pool.cache_release(pages) == 2
    assert pool.free_pages == 8
    return rep, free


def case_cow_reassigns_ownership(paged, _):
    pool = paged.PagedPool(num_pages=8, page_size=4)
    pool.ensure_capacity("a", 6)
    pages = list(pool.seq("a").pages)
    pool.attach_prefix("b", pages, 6)
    old, new, was_owner = pool.cow("b", 1)
    assert old == pages[1] and new not in pages and not was_owner
    assert pool.refcount[old] == 1 and pool.refcount[new] == 1
    assert pool.page_owner[new] == "b" and pool.page_owner[old] == "a"
    pool.attach_prefix("c", pages[:1] + [new], 6)
    old2, new2, was_owner2 = pool.cow("a", 0)
    assert was_owner2 and pool.page_owner[old2] is None
    assert pool.page_owner[new2] == "a"
    return (old, new, was_owner, old2, new2, was_owner2,
            dict(pool.refcount), dict(pool.page_owner))


def case_shared_pages_never_offloadable(paged, _):
    pool = paged.PagedPool(num_pages=8, page_size=4)
    pool.ensure_capacity("a", 12)
    pages = list(pool.seq("a").pages)
    pool.attach_prefix("b", pages[:2], 8)
    suffix = pool.evictable_suffix("a", 3)
    assert suffix == ([], [2])
    with pytest.raises(AssertionError):
        pool.mark_offloading("a", [0])           # refcount 2
    pool.cache_held.add(pages[2])
    with pytest.raises(AssertionError):
        pool.mark_offloading("a", [2])           # indexed in the radix
    pool.cache_held.discard(pages[2])
    pool.mark_offloading("a", [2])
    return suffix, sorted(pool.seq("a").offloading)


def case_attacher_cannot_offload_orphaned_prefix(paged, _):
    pool = paged.PagedPool(num_pages=8, page_size=4)
    pool.ensure_capacity("a", 8)
    pool.attach_prefix("b", list(pool.seq("a").pages), 8)
    pool.release("a")
    suffix = pool.evictable_suffix("b", 2)
    assert suffix == ([], [])
    return suffix


def case_conservation_under_random_pool_ops(paged, _):
    rng = np.random.default_rng(7)
    pool = paged.PagedPool(num_pages=24, page_size=4)
    lengths = {}
    trace = []
    for _step in range(300):
        sid = f"s{rng.integers(0, 6)}"
        op = rng.random()
        try:
            if sid not in lengths:
                donors = [d for d in lengths if lengths[d] >= 4]
                if op < 0.5 and donors:
                    d = donors[int(rng.integers(0, len(donors)))]
                    n_phys = int(rng.integers(1, lengths[d] // 4 + 1))
                    phys = pool.seq(d).pages[:n_phys]
                    pool.attach_prefix(sid, phys, n_phys * 4)
                    lengths[sid] = n_phys * 4
                else:
                    n = int(rng.integers(1, 9))
                    pool.ensure_capacity(sid, n)
                    lengths[sid] = n
            elif op < 0.5:
                lengths[sid] += int(rng.integers(1, 6))
                pool.ensure_capacity(sid, lengths[sid])
                li = (lengths[sid] - 1) // 4
                p = pool.seq(sid).pages[li]
                if pool.refcount[p] > 1:
                    trace.append(pool.cow(sid, li))
            elif op < 0.8:
                trace.append(pool.release(sid))
                del lengths[sid]
        except paged.OutOfPages:
            if lengths:
                victim = sorted(lengths)[0]
                pool.release(victim)
                del lengths[victim]
        refs = Counter(p for sid2 in lengths
                       for p in pool.seq(sid2).pages if p >= 0)
        assert dict(refs) == {p: c for p, c in pool.refcount.items()
                              if c > 0}
        assert len(pool.refcount) + pool.free_pages == pool.num_pages
    return trace, dict(pool.refcount)


def case_radix_lookup_register_roundtrip(_, prefix):
    c = prefix.PrefixCache(page_size=4)
    toks = list(range(10))
    newly = c.register(toks, [3, 7, 9])
    assert newly == [3, 7, 9] and len(c) == 3
    out = [c.lookup(toks), c.lookup(toks[:9] + [99]),
           c.lookup([0, 1, 2, 3, 99, 5]), c.lookup([50, 51])]
    assert out == [(10, [3, 7, 9]), (9, [3, 7, 9]), (4, [3]), (0, [])]
    return newly, out


def case_radix_cross_session_chain(_, prefix):
    c = prefix.PrefixCache(page_size=4)
    c.register(list(range(4)), [1])
    newly = c.register(list(range(8)), [2, 5])
    assert newly == [5]
    m = c.lookup(list(range(8)))
    assert m == (8, [1, 5])
    return newly, m


def case_radix_partial_promotes_when_page_fills(_, prefix):
    c = prefix.PrefixCache(page_size=4)
    c.register([0, 1, 2, 3, 4, 5], [8, 9])
    first = c.lookup([0, 1, 2, 3, 4, 5, 6])
    assert first == (6, [8, 9])
    c.register([0, 1, 2, 3, 4, 5, 6], [8, 9])
    grown = c.lookup([0, 1, 2, 3, 4, 5, 6, 7])[0]
    assert grown == 7
    newly = c.register([0, 1, 2, 3, 4, 5, 6, 7], [8, 9])
    assert newly == [9]
    node = c.root.children[(0, 1, 2, 3)]
    assert node.partial is None and (4, 5, 6, 7) in node.children
    full = c.lookup(list(range(8)))[0]
    assert full == 8
    return first, grown, newly, full


def case_radix_forget_drops_subtree(_, prefix):
    c = prefix.PrefixCache(page_size=2)
    c.register([0, 1, 2, 3, 4, 5], [10, 11, 12])
    dropped = sorted(c.forget_phys([11]))
    assert dropped == [11, 12]
    m = c.lookup([0, 1, 2, 3])[0]
    assert m == 2 and len(c) == 1
    return dropped, m


def case_radix_reclaim_order_and_protection(_, prefix):
    c = prefix.PrefixCache(page_size=2)
    c.register([0, 1, 2, 3], [5, 6])
    c.register([8, 9], [7])
    rc = {5: 1, 6: 0, 7: 0}
    c.on_detach([6], est=100.0, protect=-1.0)
    c.on_detach([7], est=50.0, protect=-1.0)
    order = c.reclaim(3, now=0.0, refcount=rc)
    assert order == [6, 7] and len(c) == 1
    c2 = prefix.PrefixCache(page_size=2)
    c2.register([0, 1], [3])
    c2.on_detach([3], est=10.0, protect=5.0)
    seen = [c2.reclaim(1, now=4.0, refcount={3: 0}),
            c2.reclaimable(4.0, {3: 0}), c2.reclaimable(6.0, {3: 0}),
            c2.reclaim(1, now=6.0, refcount={3: 0})]
    assert seen == [[], 0, 1, [3]]
    return order, seen


def case_radix_reclaimable_counts_whole_free_subtrees(_, prefix):
    c = prefix.PrefixCache(page_size=2)
    c.register([0, 1, 2, 3], [5, 6])
    got = (c.reclaimable(0.0, {5: 2, 6: 0}),
           c.reclaimable(0.0, {5: 0, 6: 0}))
    assert got == (1, 2)
    return got


CASES = [v for k, v in sorted(globals().items()) if k.startswith("case_")]


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__[5:])
def test_pool_and_radix_match_jax(case):
    """Each case holds its expectations on both copies, and the two
    copies observe the same values."""
    assert case(*IMPLS["torch"]) == case(*IMPLS["jax"])


# ======================================================================
# engine: the shared-prefix drive on both frameworks
# ======================================================================
def _pair(vocab: int = 331):
    jcfg = j_reduced(j_get_config("qwen2-1.5b"), layers=2, d_model=64,
                     vocab=vocab)
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = reduced(get_config("qwen2-1.5b"), layers=2, d_model=64,
                   vocab=vocab)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def tiny():
    return _pair()


def _drive_prefix(make, vocab, seed, *, prefix: bool, barge_emit: int = 3,
                  max_chunk: int = 5):
    """Five sessions whose prompts share one family prefix (not a page
    multiple: the attached tail page is copied on the first write).
    s0's first turn closes before the others arrive (pages register at
    turn close); s1 and s2 then attach while decoding together and s1
    is barged once it has emitted ``barge_emit`` tokens; an eviction
    offloads private suffix pages; s3 attaches while s0 and s1 take
    second turns; s2 hangs up, then s0, and s4 attaches to the orphaned
    cached pages. Grants are random (their own generator), the script
    is drawn up front, and ``check_invariants`` runs after every round.
    Returns (histories, event stream, turn stats, engine)."""
    rng = np.random.default_rng(seed)
    grng = np.random.default_rng(seed + 7777)
    plen = int(rng.integers(9, 15))
    plen += plen % 4 == 0                      # never a page multiple
    fam = rng.integers(0, vocab, size=plen)
    prompts = {f"s{i}": np.concatenate(
        [fam, rng.integers(0, vocab, size=int(rng.integers(2, 6)))])
        for i in range(5)}
    news = {sid: int(rng.integers(4, 8)) for sid in prompts}
    later = {sid: rng.integers(0, vocab, size=int(rng.integers(2, 5)))
             for sid in ("s0", "s1")}
    eng = make(slots=3, page_size=4, pages_per_seq=16, num_pages=30,
               fused_step=True, prefix_cache=prefix)
    eng.taps = []
    eng.logit_tap = lambda sid, lg: eng.taps.append((sid, np.array(lg)))
    stream = []

    def drive(barge=None):
        rounds = 0
        while eng.active() and rounds < 400:
            grants = {i: int(grng.integers(1, max_chunk + 1))
                      for i, s in eng.slot_state.items()
                      if s is not None and s.request.is_live()}
            sids = {i: eng.slot_state[i].session_id for i in grants}
            evs = eng.run_round(grants)
            stream.append({sids[i]: e for i, e in sorted(evs.items())})
            eng.check_invariants()
            rounds += 1
            s = next((s for s in eng.slot_state.values()
                      if s is not None and s.session_id == barge), None)
            if s is not None and len(s.tokens) >= barge_emit:
                eng.barge_in(barge)
                stream.append(("barge", barge, len(s.tokens)))
                eng.check_invariants()
                barge = None

    eng.submit_turn("s0", prompts["s0"], news["s0"])
    drive()
    eng.submit_turn("s1", prompts["s1"], news["s1"])
    eng.submit_turn("s2", prompts["s2"], news["s2"])
    drive(barge="s1")
    stream.append(("evicted", eng.kv.evict(6, eng.clock.now())))
    eng.flush_transfers()
    eng.check_invariants()
    eng.submit_turn("s3", prompts["s3"], news["s3"])
    eng.submit_turn("s0", later["s0"], 5)
    eng.submit_turn("s1", later["s1"], 5)
    drive()
    eng.end_session("s2")
    eng.end_session("s0")
    eng.check_invariants()
    eng.submit_turn("s4", prompts["s4"], news["s4"])
    drive()
    eng.end_session("s4")
    eng.check_invariants()
    hist = {sid: s.history for sid, s in eng.sessions.items()}
    stats = {sid: s.turn_stats for sid, s in eng.sessions.items()}
    return hist, stream, stats, eng


def _client_stream(stream):
    """Per-session token/finished events: what each client hears. The
    cached plane prefills fewer tokens, so its prefill-progress events
    and its round count differ from the control's by design."""
    out = {}
    for rec in stream:
        if isinstance(rec, dict):
            for sid, evs in rec.items():
                out.setdefault(sid, []).extend(
                    e for e in evs if e[0] != "prefill")
    return out


@pytest.fixture(scope="module")
def drives(tiny):
    jcfg, jp, tcfg, tp = tiny
    cache = {}

    def get(framework, seed, prefix=True):
        key = (framework, seed, prefix)
        if key not in cache:
            if framework == "jax":
                def make(**kw):
                    return jpe.PagedRealtimeEngine(jcfg, jp, **kw)
            else:
                def make(**kw):
                    return tpe.PagedRealtimeEngine(tcfg, tp, device="cpu",
                                                   **kw)
            cache[key] = _drive_prefix(make, tcfg.vocab_size, seed,
                                       prefix=prefix)
        return cache[key]
    return get


SEEDS = [0, 1, 2]


@pytest.mark.parametrize("seed", SEEDS)
def test_prefix_engine_matches_jax(drives, seed):
    want = drives("jax", seed)
    got = drives("torch", seed)
    assert got[0] == want[0], "token histories diverged"
    assert got[1] == want[1], "event streams diverged"
    assert got[2] == want[2], "turn stats diverged"
    g, w = got[3], want[3]
    assert g.cow_copies == w.cow_copies >= 1
    assert g.peak_shared_pages == w.peak_shared_pages > 0
    assert (g.prefix_cache.hits, g.prefix_cache.hit_tokens) == \
        (w.prefix_cache.hits, w.prefix_cache.hit_tokens)
    assert g.prefix_cache.hits >= 4
    assert g.offload_events == w.offload_events
    assert g.pool.stats() == w.pool.stats()
    assert g.kv.cached_blocks == w.kv.cached_blocks
    assert [s for s, _ in g.taps] == [s for s, _ in w.taps]
    for (_, a), (_, b) in zip(g.taps, w.taps):
        np.testing.assert_allclose(a, b, rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("seed", SEEDS)
def test_prefix_engine_matches_its_control(drives, seed):
    """Sharing changes which tokens are prefilled, never which tokens
    come out: the port's prefix plane gives its ``prefix_cache=False``
    twin's histories, client streams and per-turn counts."""
    got = drives("torch", seed)
    want = drives("torch", seed, prefix=False)
    assert got[0] == want[0]
    assert _client_stream(got[1]) == _client_stream(want[1])

    def counts(stats):
        return {s: [(t["generated"], t["aborted"]) for t in ts]
                for s, ts in stats.items()}
    assert counts(got[2]) == counts(want[2])
    hits = sum(t["prefix_hit_tokens"] for ts in got[2].values()
               for t in ts)
    assert hits > 0
    assert all(t["prefix_hit_tokens"] == 0 for ts in want[2].values()
               for t in ts)
    assert want[3].cow_copies == 0 and want[3].peak_shared_pages == 0


def test_fixed_pool_holds_more_sessions_with_sharing(tiny):
    """``tests/test_prefix_cache.py``'s capacity case on both engines:
    with one prompt family the prefix plane keeps strictly more
    sessions resident on a fixed pool, and the two frameworks admit
    the same number with the same histories."""
    jcfg, jp, tcfg, tp = tiny
    fam = np.random.default_rng(0).integers(0, tcfg.vocab_size,
                                            size=32).astype(np.int32)
    suffix = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, size=(16, 4)).astype(np.int32)

    def admit_until_full(make, oom, prefix):
        eng = make(slots=2, page_size=8, pages_per_seq=8, num_pages=16,
                   fused_step=True, prefix_cache=prefix)
        resident = 0
        for i in range(16):
            sid = f"s{i}"
            try:
                eng.add_session(sid, np.concatenate([fam, suffix[i]]),
                                max_new_tokens=2)
            except oom:
                break
            eng.run_to_completion()
            eng.kv.pin(sid)
            eng.check_invariants()
            resident += 1
        return resident, {s: x.history for s, x in eng.sessions.items()}

    def jmake(**kw):
        return jpe.PagedRealtimeEngine(jcfg, jp, **kw)

    def tmake(**kw):
        return tpe.PagedRealtimeEngine(tcfg, tp, device="cpu", **kw)

    n_t, h_t = admit_until_full(tmake, tpaged.OutOfPages, True)
    n_j, h_j = admit_until_full(jmake, jpaged.OutOfPages, True)
    n_ctl, _ = admit_until_full(tmake, tpaged.OutOfPages, False)
    assert n_t == n_j >= 8 and h_t == h_j
    assert n_t > n_ctl
