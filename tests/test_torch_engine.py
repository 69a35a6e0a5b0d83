"""The port's paged engine against the JAX package's, as a whole.

The same weights (JAX's ``init_params``, carried across through numpy)
go through the JAX ``PagedRealtimeEngine`` and the port's engine on the
CPU, on two scripted traces:

- the ``run_multiturn_demo`` script: eviction to DRAM, the sync reload
  fallback, barge-in, hang-up and an admitted speech-time preload;
- the seeded ``submit_turn``/``run_round`` trace of
  ``tests/test_fused_step.py::_drive_differential`` (copied here, with a
  builder argument so it drives either engine), on both planes.

Token histories, event streams, turn stats (virtual clock), offload
events, preload and pool stats must be identical. Each round's logits
must agree within 1e-4: the two frameworks sum in different orders and
the JAX engine attends through the Pallas kernel in interpret mode
while the port's CPU path takes the kernel's plain version.
"""
import ast
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.serving.paged_engine as jpe
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import init_params as j_init_params
import repro_torch.serving.paged_engine as tpe
from repro_torch.configs import get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.models.model import init_params, params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
LOGIT_TOL = 1e-4


def _pair(vocab: int):
    jcfg = j_reduced(j_get_config("qwen2-1.5b"), layers=2, d_model=64,
                     vocab=vocab)
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = reduced(get_config("qwen2-1.5b"), layers=2, d_model=64,
                   vocab=vocab)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def tiny():
    return _pair(331)


def _tap(eng):
    eng.taps = []
    eng.logit_tap = lambda sid, lg: eng.taps.append((sid, np.array(lg)))
    return eng


def _recording(module, made):
    class Recording(module.PagedRealtimeEngine):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(_tap(self))
    return Recording


def _close_taps(got, want):
    assert [s for s, _ in got] == [s for s, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=LOGIT_TOL, atol=LOGIT_TOL)


# ======================================================================
# (a) the run_multiturn_demo script
# ======================================================================
def _run_demos(fused_step: bool):
    """Both demos, each with its engine captured: the JAX one as it
    stands (it builds its own weights from PRNGKey(0)), the port's with
    the same weights and the JAX script's own sizes."""
    made_j, made_t = [], []
    _, _, tcfg, tp = _pair(503)
    quiet = (lambda *_a, **_k: None)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpe, "PagedRealtimeEngine", _recording(jpe, made_j))
        mp.setattr(tpe, "PagedRealtimeEngine", _recording(tpe, made_t))
        jout = jpe.run_multiturn_demo(seed=0, fused_step=fused_step,
                                      log=quiet)
        tout = tpe.run_multiturn_demo(
            tcfg, tp, slots=2, page_size=8, pages_per_seq=9, num_pages=11,
            pcie_gb_s=0.01, seed=0, fused_step=fused_step, device="cpu",
            log=quiet)
    return (jout, made_j[0]), (tout, made_t[0])


@pytest.fixture(scope="module")
def demos():
    return _run_demos(fused_step=True)


@pytest.fixture(scope="module")
def tokenwise_demos():
    """The demo on the per-token plane: turn 0 takes the dense prefill
    graft (``_prefill_dense``) in both frameworks."""
    return _run_demos(fused_step=False)


def test_demo_histories_and_turn_stats(demos):
    (jout, jeng), (tout, teng) = demos
    assert {s: x.history for s, x in teng.sessions.items()} == \
        {s: x.history for s, x in jeng.sessions.items()}
    assert tout["turns"] == jout["turns"]


def test_demo_offload_preload_pool(demos):
    (jout, jeng), (tout, teng) = demos
    assert teng.offload_events == jeng.offload_events
    assert vars(teng.preloader.stats) == vars(jeng.preloader.stats)
    assert tout == jout
    # the script really evicted, fell back to the sync reload and had a
    # preload admitted
    assert tout["offload_events"] > 0 and tout["preload"]["admitted"] >= 1
    assert tout["preload"]["sync_fallbacks"] >= 1
    assert teng.kv.reloaded_blocks >= 1
    teng.check_invariants()


def test_demo_logits(demos):
    (_, jeng), (_, teng) = demos
    assert len(teng.taps) > 50
    _close_taps(teng.taps, jeng.taps)


def test_tokenwise_demo_matches_jax(tokenwise_demos):
    (jout, jeng), (tout, teng) = tokenwise_demos
    assert {s: x.history for s, x in teng.sessions.items()} == \
        {s: x.history for s, x in jeng.sessions.items()}
    assert tout["turns"] == jout["turns"]
    assert teng.offload_events == jeng.offload_events
    assert vars(teng.preloader.stats) == vars(jeng.preloader.stats)
    assert tout == jout
    teng.check_invariants()


def test_tokenwise_demo_counts(tokenwise_demos):
    """The JAX demo's counts: 5 evictions, 1 sync reload, 1 preload
    admitted and hit; no fused launch."""
    _, (tout, teng) = tokenwise_demos
    pre = tout["preload"]
    assert tout["offload_events"] == 5
    assert pre["sync_fallbacks"] == 1
    assert pre["admitted"] == 1 and pre["hits"] == 1
    assert teng.fused_launches == 0


def test_tokenwise_demo_logits(tokenwise_demos):
    (_, jeng), (_, teng) = tokenwise_demos
    assert len(teng.taps) > 50
    _close_taps(teng.taps, jeng.taps)


def test_tokenwise_demo_matches_fused_demo(demos, tokenwise_demos):
    """Within the port, the per-token demo gives the fused demo's token
    histories and per-turn counts (its clock differs: it ticks once per
    prompt token)."""
    (_, (fout, feng)), (_, (tout, teng)) = demos, tokenwise_demos
    assert {s: x.history for s, x in teng.sessions.items()} == \
        {s: x.history for s, x in feng.sessions.items()}

    def counts(out):
        return {s: [(t["generated"], t["aborted"], t["re_prefill_tokens"])
                    for t in ts] for s, ts in out["turns"].items()}
    assert counts(tout) == counts(fout)


# ======================================================================
# (b) the seeded run_round trace, both planes
# ======================================================================
def _drive_differential(make, cfg, seed, *, fused: bool = True,
                        max_chunk: int = 5, barge_round: int = 3,
                        evict_pages: int = 6, page_size: int = 4,
                        num_pages: int = 24):
    """tests/test_fused_step.py's trace; ``make(**kw)`` builds the
    engine. Returns (histories, event stream, turn stats, engine)."""
    rng = np.random.default_rng(seed)
    eng = _tap(make(slots=2, page_size=page_size, pages_per_seq=16,
                    num_pages=num_pages, fused_step=fused))
    stream = []

    def drive(live_grants, barge_at=None):
        rounds = 0
        while eng.active() and rounds < 400:
            grants = {}
            for slot, sid in list(live_grants.items()):
                s = eng.slot_state[slot]
                if s is None or s.session_id != sid \
                        or not s.request.is_live():
                    continue
                grants[slot] = int(rng.integers(1, max_chunk + 1))
            if not grants:
                break
            stream.append((rounds, eng.run_round(grants)))
            rounds += 1
            if barge_at is not None and rounds == barge_at:
                eng.barge_in("a")
                stream.append(("barge", rounds))
                return

    pa = rng.integers(0, cfg.vocab_size, size=int(rng.integers(8, 14)))
    pb = rng.integers(0, cfg.vocab_size, size=int(rng.integers(5, 10)))
    sa = eng.submit_turn("a", pa, max_new_tokens=int(rng.integers(5, 9)))
    sb = eng.submit_turn("b", pb, max_new_tokens=int(rng.integers(4, 8)))
    drive({sa: "a", sb: "b"})
    evicted = eng.kv.evict(evict_pages, eng.clock.now())
    eng.flush_transfers()
    stream.append(("evicted", evicted))
    pc = rng.integers(0, cfg.vocab_size, size=8)
    sc = eng.submit_turn("c", pc, max_new_tokens=int(rng.integers(4, 8)))
    drive({sc: "c"})
    pa2 = rng.integers(0, cfg.vocab_size, size=int(rng.integers(4, 9)))
    sa2 = eng.submit_turn("a", pa2, max_new_tokens=10)
    drive({sa2: "a"}, barge_at=barge_round)
    pa3 = rng.integers(0, cfg.vocab_size, size=int(rng.integers(3, 7)))
    sa3 = eng.submit_turn("a", pa3, max_new_tokens=int(rng.integers(3, 6)))
    drive({sa3: "a"})
    eng.check_invariants()
    hist = {sid: s.history for sid, s in eng.sessions.items()}
    stats = {sid: [(t["re_prefill_tokens"], t["generated"], t["aborted"])
                   for t in s.turn_stats]
             for sid, s in eng.sessions.items()}
    return hist, stream, stats, eng


SWEEP = [(0, 3, 2), (1, 5, 4), (3, 7, 6)]    # of test_fused_step.SWEEP


@pytest.fixture(scope="module")
def traces(tiny):
    """Each (framework, seed, plane) trace, run once and shared."""
    jcfg, jp, tcfg, tp = tiny
    cache = {}

    def get(framework, seed, max_chunk, barge_round, fused):
        key = (framework, seed, fused)
        if key not in cache:
            if framework == "jax":
                cfg = jcfg

                def make(**kw):
                    return jpe.PagedRealtimeEngine(jcfg, jp, **kw)
            else:
                cfg = tcfg

                def make(**kw):
                    return tpe.PagedRealtimeEngine(tcfg, tp, device="cpu",
                                                   **kw)
            cache[key] = _drive_differential(
                make, cfg, seed, fused=fused, max_chunk=max_chunk,
                barge_round=barge_round)
        return cache[key]
    return get


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "tokenwise"])
@pytest.mark.parametrize("seed,max_chunk,barge_round", SWEEP)
def test_trace_matches_jax(traces, seed, max_chunk, barge_round, fused):
    want = traces("jax", seed, max_chunk, barge_round, fused)
    got = traces("torch", seed, max_chunk, barge_round, fused)
    assert got[0] == want[0], "token histories diverged"
    assert got[1] == want[1], "event streams diverged"
    assert got[2] == want[2], "turn stats diverged"
    assert got[3].offload_events == want[3].offload_events
    assert got[3].pool.stats() == want[3].pool.stats()
    assert got[3].kv.reloaded_blocks == want[3].kv.reloaded_blocks >= 1
    _close_taps(got[3].taps, want[3].taps)


@pytest.mark.parametrize("seed,max_chunk,barge_round", SWEEP)
def test_port_planes_agree(traces, seed, max_chunk, barge_round):
    """Within the port, the fused plane equals its per-token plane."""
    fused = traces("torch", seed, max_chunk, barge_round, True)
    tokenwise = traces("torch", seed, max_chunk, barge_round, False)
    assert fused[:3] == tokenwise[:3]
    assert fused[3].fused_launches > 0 and tokenwise[3].fused_launches == 0


# ======================================================================
# the host copies, the device contract, the slice's edges
# ======================================================================
def test_bf16_offload_reload_bit_exact():
    """A bf16 page store (which numpy cannot hold) goes to host copies
    and comes back bit for bit, into other physical pages."""
    cfg = reduced(get_config("qwen2-1.5b"), layers=2, d_model=64,
                  vocab=331).replace(dtype="bfloat16",
                                     param_dtype="bfloat16")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = tpe.PagedRealtimeEngine(cfg, params, slots=2, page_size=4,
                                  pages_per_seq=16, num_pages=24,
                                  device="cpu")
    rng = np.random.default_rng(0)
    s = eng.submit_turn("a", rng.integers(0, 331, size=9), max_new_tokens=4)
    while eng.active():
        eng.run_round({s: 4})
    pages = list(eng.pool.seq("a").pages)
    before = [(eng.k_pages[:, p].clone(), eng.v_pages[:, p].clone())
              for p in pages]
    eng.kv.evict(len(pages), eng.clock.now())
    eng.flush_transfers()
    gone = [li for li in eng.pool.seq("a").offloaded]
    assert gone and all(eng.pool.seq("a").pages[li] == -1 for li in gone)
    for li in gone:                     # clobber the freed slots
        eng.k_pages[:, pages[li]] = 7.0
        eng.v_pages[:, pages[li]] = 7.0
    eng.submit_turn("a", rng.integers(0, 331, size=3), max_new_tokens=2)
    after = eng.pool.seq("a").pages
    assert not eng.pool.seq("a").offloaded
    for li, (k, v) in enumerate(before):
        assert torch.equal(eng.k_pages[:, after[li]].view(torch.int16),
                           k.view(torch.int16))
        assert torch.equal(eng.v_pages[:, after[li]].view(torch.int16),
                           v.view(torch.int16))
    eng.check_invariants()


@pytest.mark.parametrize("kw,item", [
    (dict(mesh=object()), "item 7"),
    (dict(prefix_cache=True), "item 4"),
    (dict(spec_decode=2), "item 4"),
    (dict(kv_quant="int8"), "item 4"),
])
def test_out_of_slice_options_raise(tiny, kw, item):
    _, _, tcfg, tp = tiny
    with pytest.raises(NotImplementedError, match=f"ROADMAP.*{item}"):
        tpe.PagedRealtimeEngine(tcfg, tp, device="cpu", **kw)


def _drive_add_session(make, cfg, seed):
    """Turn 0 through ``add_session`` on the per-token plane (the dense
    prefill graft), decoded by ``run_round``; then an eviction and a
    second turn through ``start_turn``. Returns (histories, event
    stream, turn stats, engine)."""
    rng = np.random.default_rng(seed)
    eng = _tap(make(slots=2, page_size=4, pages_per_seq=16, num_pages=24,
                    fused_step=False))
    stream = []

    def drive():
        while eng.active():
            stream.append(eng.run_round(
                {i: 1 for i, s in eng.slot_state.items()
                 if s is not None and s.request.is_live()}))
    sa = eng.add_session("a", rng.integers(0, cfg.vocab_size, size=13),
                         max_new_tokens=6)
    sb = eng.add_session("b", rng.integers(0, cfg.vocab_size, size=6),
                         max_new_tokens=4)
    stream.append(("slots", sa, sb))
    drive()
    stream.append(("evicted", eng.kv.evict(4, eng.clock.now())))
    eng.flush_transfers()
    eng.start_turn("a", rng.integers(0, cfg.vocab_size, size=3),
                   max_new_tokens=5)
    drive()
    eng.check_invariants()
    hist = {sid: s.history for sid, s in eng.sessions.items()}
    return hist, stream, {sid: s.turn_stats
                          for sid, s in eng.sessions.items()}, eng


@pytest.mark.parametrize("seed", [0, 1])
def test_tokenwise_add_session_matches_jax(tiny, seed):
    """add_session on the per-token plane: the port's dense graft gives
    the JAX engine's histories, events, turn stats and page traffic."""
    jcfg, jp, tcfg, tp = tiny
    want = _drive_add_session(
        lambda **kw: jpe.PagedRealtimeEngine(jcfg, jp, **kw), jcfg, seed)
    got = _drive_add_session(
        lambda **kw: tpe.PagedRealtimeEngine(tcfg, tp, device="cpu", **kw),
        tcfg, seed)
    assert got[0] == want[0], "token histories diverged"
    assert got[1] == want[1], "event streams diverged"
    assert got[2] == want[2], "turn stats diverged"
    assert got[3].offload_events == want[3].offload_events
    assert got[3].kv.reloaded_blocks == want[3].kv.reloaded_blocks
    _close_taps(got[3].taps, want[3].taps)


def test_cuda_entry_points_raise_without_gpu(tiny):
    """Asked for the card on a host without one, the entry points raise
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from repro_torch.launch import serve
    from repro_torch.serving.engine import RealtimeLLMEngine
    _, _, tcfg, tp = tiny
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpe.PagedRealtimeEngine(tcfg, tp)          # default device: cuda
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--config", "tiny"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpe.run_multiturn_demo(tcfg, tp, log=lambda *_a: None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpe.run_multiturn_demo(tcfg, tp, fused_step=False,
                               log=lambda *_a: None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--no-fused-step", "--config", "tiny"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RealtimeLLMEngine(tcfg, tp)                # default device: cuda


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{f.relative_to(ROOT)} imports {mod}"
