"""The port's kernel autotune (``kernels/autotune.py``) and the paged
kernels' tiling knobs, against the JAX package's.

The counterparts of ``tests/test_autotune.py``, in the port's terms:

- keys, defaults and ``_resolve``: the cache is consulted only for a
  span the caller leaves unset and only while enabled; disabled, a call
  takes the default (``ref.SPAN_KEYS``) without a lookup;
- the cache round trip (enable, sweep, save, reload, lookup) and the
  invalidation rules: a version bump discards the file; the backend
  (``"cpu"`` or ``"cuda:<device name>"``) and the dtype are parts of
  the key;
- the tilings: the port's plain versions at a ``span`` against the
  Pallas kernels (interpret mode) at ``kv_block`` and ``head_block``
  and ``repro.kernels.ref`` on seeded numpy inputs, on valid rows, at
  2e-5 (the port has no ``head_block``: one launch takes every head);
- the sweep with an injected timer (no clock decides a pick): a
  non-default span is picked when it times faster, the model's gate
  blocks a measured winner, a candidate that fails its check is never
  picked, and one span serves a geometry's every Q width and both
  kinds (decode equals fused at Q = 1 bit for bit under the cache);
- a tuned entry reaches the wrappers (hit counter), and the launcher's
  ``--engine live --autotune`` serves on the CPU.

The kernels themselves are held to the same invariants on the card in
``tests/test_torch_cuda.py``.
"""
import json

import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.paged_attention import paged_attention as j_decode
from repro.kernels.paged_attention import \
    paged_prefill_attention as j_prefill
from repro_torch.kernels import autotune
from repro_torch.kernels import ref as tref
from repro_torch.kernels.paged_attention import (_resolve, paged_attention,
                                                 paged_prefill_attention)
from test_torch_cuda import _prefill_case, _valid_close
from test_torch_kernels import _both

TOL = 2e-5
GEO = dict(B=2, Hq=4, Hkv=2, D=16, page=8, pps=4)   # 32 keys a row


@pytest.fixture(autouse=True)
def _clean_state():
    """Autotune state is process-global; never leak it across tests."""
    autotune.disable()
    yield
    autotune.disable()


def _decode_case(seed, B=3, Hq=4, Hkv=2, D=16, page=32, pps=3):
    rng = np.random.default_rng(seed)
    P = B * pps + 2
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    kp = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    bt = rng.permutation(P)[:B * pps].reshape(B, pps).astype(np.int32)
    sl = np.array([page * pps - 5, 7, 1], np.int32)[:B]
    return q, kp, vp, bt, sl


def _tensors(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _key(kind, dtype=torch.float32, backend="cpu", **dims):
    return autotune.cache_key(kind, autotune.shape_key(
        **dict(GEO, dtype=dtype, **dims)), backend)


def _fixed_timer(fast_span, fast_us=1.0, slow_us=2.0):
    """An injected timer: ``fast_span`` times ``fast_us``, every other
    candidate ``slow_us``; it runs nothing."""
    def timer(cfg, run, reps):
        return fast_us if cfg["span"] == fast_span else slow_us
    return timer


# ======================================================================
# keys, defaults, resolve
# ======================================================================
def test_shape_key_is_canonical():
    assert autotune.shape_key(b=1, a=2) == autotune.shape_key(a=2, b=1)
    assert autotune.shape_key(B=4, page=32) == "B=4,page=32"
    assert autotune.shape_key(dtype=torch.bfloat16) == "dtype=bfloat16"


def test_cache_key_carries_backend():
    k = autotune.cache_key("paged_attention", "B=1", backend="cuda:H100")
    assert k == "paged_attention|B=1|cuda:H100"
    assert autotune.backend_of("cpu") == "cpu"
    assert autotune.cache_key("paged_attention", "B=1") \
        == f"paged_attention|B=1|{autotune.backend_of()}"


def test_default_span_matches_the_kernel_source():
    """The default and the longest span of ``csrc/paged_attention.cu``
    are ``ref.SPAN_KEYS`` and ``ref.MAX_SPAN_KEYS`` (the wrapper checks
    the built library too), and the default is one the sweep offers."""
    from pathlib import Path
    import repro_torch.kernels as k
    src = (Path(k.__file__).parent / "csrc" / "paged_attention.cu") \
        .read_text()
    assert f"kSpanKeys = {tref.SPAN_KEYS};" in src
    assert f"kMaxSpanKeys = {tref.MAX_SPAN_KEYS};" in src
    assert tref.SPAN_KEYS % 16 == 0
    for page, pps in ((8, 2), (16, 40), (32, 200)):
        assert tref.SPAN_KEYS in {c["span"] for c in
                                  autotune.candidate_configs(page, pps)}


def test_resolve_disabled_uses_static_defaults(monkeypatch):
    q, kp, vp, bt, _ = _tensors(_decode_case(0))
    monkeypatch.setattr(autotune, "tiling", lambda *a: pytest.fail(
        "a disabled cache is looked up"))
    assert not autotune.enabled()
    assert _resolve("paged_attention", None, q, kp, bt) is None
    # an explicit span always wins
    assert _resolve("paged_attention", 32, q, kp, bt) == 32
    for span in (24, 0, -16, tref.MAX_SPAN_KEYS + 16):
        with pytest.raises(ValueError):
            _resolve("paged_attention", span, q, kp, bt)


def test_resolve_consults_cache_only_for_unset_knobs(tmp_path):
    q = torch.zeros((GEO["B"], GEO["Hq"], GEO["D"]))
    kp = torch.zeros((9, GEO["page"], GEO["Hkv"], GEO["D"]))
    bt = torch.zeros((GEO["B"], GEO["pps"]), dtype=torch.int32)
    autotune.enable(str(tmp_path / "cache.json"))
    autotune._STATE["cache"][_key("paged_attention")] = {"span": 16}
    assert _resolve("paged_attention", None, q, kp, bt) == 16
    # a set span is never overridden, and is not looked up
    assert _resolve("paged_attention", 32, q, kp, bt) == 32
    assert autotune.stats()["hits"] == 1
    # unswept shape: miss, default
    assert _resolve("paged_attention", None, q[:1], kp, bt[:1]) is None
    # a fused width not swept takes its geometry's span
    qf = torch.zeros((GEO["B"], 8, GEO["Hq"], GEO["D"]))
    assert _resolve("paged_prefill_attention", None, qf, kp, bt) == 16
    assert autotune.stats() == {"entries": 1, "hits": 2, "misses": 1}


# ======================================================================
# cache round trip + invalidation
# ======================================================================
def test_cache_round_trip(tmp_path):
    path = str(tmp_path / "cache.json")
    assert autotune.enable(path) == 0
    entry = autotune.sweep("paged_attention", **GEO, reps=1,
                           timer=_fixed_timer(16))
    skey = autotune.shape_key(**GEO, dtype=torch.float32)
    assert autotune.lookup("paged_attention", skey, "cpu") == entry
    assert autotune.save() == path
    autotune.disable()
    assert autotune.lookup("paged_attention", skey, "cpu") is None
    assert autotune.enable(path) == 2      # decode and fused at Q = 1
    got = autotune.lookup("paged_attention", skey, "cpu")
    assert got == entry
    assert {"span", "measured_us", "default_us", "model_us", "reps"} \
        == set(got)
    with open(path) as f:
        assert json.load(f)["__meta__"] == {"version":
                                            autotune.FORMAT_VERSION}


def test_version_bump_discards_cache(tmp_path):
    path = str(tmp_path / "stale.json")
    with open(path, "w") as f:
        json.dump({"__meta__": {"version": autotune.FORMAT_VERSION + 1},
                   _key("paged_attention"): {"span": 16}}, f)
    assert autotune.enable(path) == 0
    # a versionless file is equally stale; a missing one starts empty
    with open(path, "w") as f:
        json.dump({_key("paged_attention"): {"span": 16}}, f)
    assert autotune.enable(path) == 0
    assert autotune.enable(str(tmp_path / "missing.json")) == 0
    assert autotune.enabled()


def test_backend_and_dtype_invalidate(tmp_path):
    """An entry tuned on another backend (another card) or for another
    dtype misses; the same entry for this one hits."""
    q, kp, vp, bt, sl = _tensors(_decode_case(0, **{
        k: GEO[k] for k in ("B", "Hq", "Hkv", "D", "page", "pps")}))
    autotune.enable(str(tmp_path / "cache.json"))
    entry = {"span": 16}
    autotune._STATE["cache"][_key("paged_attention",
                                  backend="cuda:another card")] = entry
    autotune._STATE["cache"][_key("paged_attention",
                                  dtype=torch.bfloat16)] = entry
    assert _resolve("paged_attention", None, q, kp, bt) is None
    assert autotune.stats()["hits"] == 0
    autotune._STATE["cache"][_key("paged_attention")] = entry
    autotune._STATE["memo"] = {}
    assert _resolve("paged_attention", None, q, kp, bt) == 16


# ======================================================================
# tiling exactness against the Pallas kernels
# ======================================================================
def test_span_tilings_match_jax():
    """The decode function split at spans of 16, 32 and 96 keys against
    the Pallas kernel at ``kv_block`` 8, 16 and 32 and the JAX oracle."""
    arrays = _decode_case(0)
    j, t = zip(*(_both(a, "float32") for a in arrays))
    want = np.asarray(jref.paged_attention_ref(*j))
    for span, kv_block in ((16, 8), (32, 16), (96, 32)):
        got = paged_attention(*t, span=span).numpy()
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                                   err_msg=f"span={span}")
        jk = np.asarray(j_decode(*j, interpret=True, kv_block=kv_block))
        np.testing.assert_allclose(got, jk, rtol=TOL, atol=TOL,
                                   err_msg=f"kv_block={kv_block}")


def test_every_head_launch_matches_pallas_head_blocks():
    """The port has no ``head_block``: one launch takes every KV head.
    It equals the Pallas decode kernel at head_block 1 and 2 (each a
    tiling of the same function, bit-equal to each other) at 2e-5,
    at the default span and at a short one."""
    arrays = _decode_case(1)
    t = _tensors(arrays)
    j = [np.asarray(a) for a in arrays]
    jk = {hb: np.asarray(j_decode(*j, interpret=True, kv_block=16,
                                  head_block=hb)) for hb in (1, 2)}
    np.testing.assert_array_equal(jk[1], jk[2])
    for span in (None, 16):
        got = paged_attention(*t, span=span).numpy()
        np.testing.assert_allclose(got, jk[1], rtol=TOL, atol=TOL,
                                   err_msg=f"span={span}")


def test_prefill_tilings_match_jax():
    B, Q, Hq, Hkv, D, page, pps = 2, 4, 4, 2, 16, 32, 3
    arrays = _prefill_case(2, B, Q, Hq, Hkv, D, page, pps)
    j, t = zip(*(_both(a, "float32") for a in arrays))
    ql = arrays[-1]
    want = np.asarray(jref.paged_prefill_attention_ref(*j))
    for (span, kv_block), head_block in (((16, 8), 2), ((32, 32), 2),
                                         ((96, 16), 1)):
        got = paged_prefill_attention(*t, span=span).numpy()
        _valid_close(got, want, ql, TOL)
        jk = j_prefill(*j, interpret=True, kv_block=kv_block,
                       head_block=head_block)
        _valid_close(got, jk, ql, TOL)


# ======================================================================
# the sweep
# ======================================================================
def test_sweep_selects_nondefault_span(tmp_path):
    """A span that times faster at every member is picked, and the
    entry keeps both times."""
    autotune.enable(str(tmp_path / "cache.json"))
    entry = autotune.sweep("paged_attention", **GEO, reps=1,
                           timer=_fixed_timer(16))
    assert entry["span"] == 16
    assert entry["measured_us"] < entry["default_us"]


def test_sweep_roofline_gate_blocks_measured_winner(tmp_path):
    """With a gate ratio below 1 every non-default candidate is modeled
    ineligible: the sweep keeps the default whatever the timer says."""
    autotune.enable(str(tmp_path / "cache.json"))
    entry = autotune.sweep("paged_attention", **GEO, reps=1,
                           timer=_fixed_timer(16), gate_ratio=1e-9)
    assert entry["span"] == tref.SPAN_KEYS


def test_sweep_never_picks_a_failing_candidate(tmp_path, monkeypatch):
    """A span whose output is off by more than the tolerance fails its
    check and is never timed, however fast it would be; a tie keeps the
    default."""
    split = tref.paged_prefill_attention_split_ref

    def faulty(*a, **kw):
        out = split(*a, **kw)
        span = a[6] if len(a) > 6 else kw.get("span", tref.SPAN_KEYS)
        return out + 1e-3 if span == 16 else out
    monkeypatch.setattr(tref, "paged_prefill_attention_split_ref", faulty)
    timed, log = [], []

    def timer(cfg, run, reps):
        timed.append(cfg["span"])
        return 1.0 if cfg["span"] == 16 else 2.0
    autotune.enable(str(tmp_path / "cache.json"))
    entry = autotune.sweep("paged_prefill_attention", **GEO, Q=2,
                           q_widths=(1, 2), reps=1, timer=timer, log=log)
    assert 16 not in timed and entry["span"] == tref.SPAN_KEYS
    assert all(r["us"] is None for r in log if r["span"] == 16)
    assert entry["measured_us"] == entry["default_us"]


def test_sweep_one_span_across_widths_and_kinds(tmp_path):
    """The span invariant: a span faster only at Q = 4 does not win the
    geometry unless its sum does; every member's entry carries the one
    span picked; under the cache the decode
    call equals the fused call at Q = 1 bit for bit, and a width not
    swept takes the geometry's span."""
    def timer(cfg, run, reps):       # span 16 wins Q = 4 only; 32 the sum
        if cfg["span"] == 16:
            return 1.0 if cfg["Q"] == 4 else 9.0
        return 2.0 if cfg["span"] == 32 else 3.0
    autotune.enable(str(tmp_path / "cache.json"))
    autotune.sweep("paged_prefill_attention", **GEO, Q=4,
                   q_widths=(1, 2, 4), reps=1, timer=timer)
    entries = autotune._STATE["cache"]
    assert len(entries) == 4
    assert {e["span"] for e in entries.values()} == {32}
    assert entries[_key("paged_prefill_attention", Q=4)]["measured_us"] \
        == 2.0
    # a later sweep of the geometry replaces all of its entries
    autotune.sweep("paged_attention", **GEO, reps=1, timer=_fixed_timer(16))
    assert {e["span"] for e in autotune._STATE["cache"].values()} == {16}
    assert len(autotune._STATE["cache"]) == 2
    arrays = _prefill_case(3, GEO["B"], 8, GEO["Hq"], GEO["Hkv"], GEO["D"],
                           GEO["page"], GEO["pps"])
    q, kp, vp, bt, qs, ql = _tensors(arrays)
    one = torch.ones_like(ql)
    hits = autotune.stats()["hits"]
    d = paged_attention(q[:, 0].contiguous(), kp, vp, bt, qs + 1)
    f = paged_prefill_attention(q[:, :1].contiguous(), kp, vp, bt, qs, one)
    wide = paged_prefill_attention(q, kp, vp, bt, qs, ql)
    assert autotune.stats()["hits"] == hits + 3
    assert torch.equal(f[:, 0], d)
    assert torch.equal(wide, tref.paged_prefill_attention_split_ref(
        q, kp, vp, bt, qs, ql, span=16))


def test_modeled_cost_orders_launches_waves_and_partials():
    kw = dict(B=8, Hkv=2, D=128, page=16, pps=40, G=6, dtype=torch.bfloat16)
    # an empty grid still pays the split's and the merge's launches
    assert autotune.modeled_cost_us(span=128, **dict(kw, B=0)) \
        == 2 * autotune.C_LAUNCH_US
    # a grid of a few blocks: a shorter span fills more SMs
    one = dict(kw, B=1)
    assert autotune.modeled_cost_us(span=640, **one) \
        > autotune.modeled_cost_us(span=128, **one)
    # a full grid: a shorter span only adds partials for the merge
    assert autotune.modeled_cost_us(span=16, Q=16, **kw) \
        > autotune.modeled_cost_us(span=64, Q=16, **kw)
    # f32 runs on the CUDA cores: never cheaper than bf16
    assert autotune.modeled_cost_us(span=128, Q=16,
                                    **dict(kw, dtype=torch.float32)) \
        > autotune.modeled_cost_us(span=128, Q=16, **kw)


def test_candidate_space_covers_default_and_whole_row():
    cfgs = autotune.candidate_configs(16, 40)     # 640 keys a row
    assert [c["span"] for c in cfgs] == [16, 32, 64, 128, 256, 512, 640]
    # a short row: nothing past the whole row but the default
    assert {c["span"] for c in autotune.candidate_configs(8, 3)} \
        == {16, 32, tref.SPAN_KEYS}
    assert max(c["span"] for c in autotune.candidate_configs(64, 500)) \
        == tref.MAX_SPAN_KEYS


def test_tuned_lookup_feeds_the_kernel(tmp_path):
    """End to end: a cache holding a non-default tiling for the exact
    call shape, the wrapper called with its knobs unset: the entry is
    consulted (hit counter) and the call computes the split at that
    span, within tolerance of the oracle."""
    q, kp, vp, bt, sl = t = _tensors(_decode_case(3))
    B, Hq, D = q.shape
    _, page, Hkv, _ = kp.shape
    autotune.enable(str(tmp_path / "cache.json"))
    autotune._STATE["cache"][autotune.cache_key(
        "paged_attention", autotune.shape_key(
            B=B, Hq=Hq, Hkv=Hkv, D=D, page=page, pps=bt.shape[1],
            dtype=torch.float32), "cpu")] = {"span": 48}
    hits0 = autotune.stats()["hits"]
    got = paged_attention(*t)
    assert autotune.stats()["hits"] == hits0 + 1
    assert torch.equal(got, tref.paged_attention_split_ref(*t, span=48))
    np.testing.assert_allclose(got.numpy(), tref.paged_attention_ref(
        *t).numpy(), rtol=TOL, atol=TOL)


def test_launcher_live_autotune_serves(tmp_path, capsys):
    """``--engine live --autotune`` on the CPU: a cache swept for the
    tiny config's live geometry (an injected timer picks span 16) is
    consulted by every round, and every turn is served."""
    from repro_torch.launch import serve
    cfg = serve.build_config("tiny")
    live = serve.LIVE["tiny"]
    path = str(tmp_path / "cache.json")
    autotune.enable(path)
    autotune.sweep("paged_prefill_attention", B=8, Hq=cfg.num_heads,
                   Hkv=cfg.num_kv_heads, D=cfg.resolved_head_dim,
                   page=live["page_size"], pps=live["pages_per_seq"],
                   q_widths=(1, 2, 4, 8, 16), reps=1,
                   timer=_fixed_timer(16))
    autotune.save()
    autotune.disable()
    serve.main(["--engine", "live", "--device", "cpu", "--config", "tiny",
                "--sessions", "2", "--autotune", path, "--json"])
    s = json.loads(capsys.readouterr().out)
    stats = dict(kv.split("=") for kv in s["autotune"].split())
    assert int(stats["entries"]) == 6 and int(stats["hits"]) > 0
    assert int(stats["misses"]) == 0
    assert s["turns"] > 0 and s["rounds"] > 0
