"""The port's sharded page plane (DESIGN.md §9) against the JAX package.

- The paged kernels' sharding options (``pos_stride``, ``pos_offset``,
  ``return_stats``) on one process: the port's wrappers (on the CPU,
  their plain versions) and the kernels' span split against the Pallas
  kernels in interpret mode, in f32 and bf16; the stripe merge, rows that
  see no key, and a nonzero ``pos_offset``.
- The sharded plane on CPU meshes of gloo processes, one spawn a layout:
  heads (M 2), slots (M 4) and replicated (M 3), at the tiny width of the
  other tests (two KV heads, pages of 8). Each spawn runs the global-view
  kernels (``sharded_paged_attention``, ``attend_chunk``,
  ``sharded_flash_prefill``), held to the JAX oracles, then the sharded
  ``PagedRealtimeEngine`` on the reference's ``_drive_trace`` on both
  planes, with ``prefix_cache=True`` (a shared prefix, copy-on-write
  included), ``kv_quant="int8"`` and ``spec_decode=3``: token for token
  the single-device port's and the JAX single-device engine's, in f32;
  and the moe family's sharded engine (heads, M 2) on both planes, the
  moe layer running on every rank, token for token the single-device
  port's.
- ``run_replay`` at M 4 on a pool tight enough to evict, record for
  record the single-device port's; the live gateway on an M 2 engine;
  the launcher's ``--mesh 1x2``.

Nothing is held to the JAX mesh engine, whose full-trace tests are red.
The ranks meet through a ``file://`` store under ``tmp_path``, and every
spawn has its own time limit, after which its ranks are killed.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving.paged_engine as jpe
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.kernels import paged_attention as jpa
from repro.kernels import ref as jref
from repro.models import init_params as j_init_params
import repro_torch.serving.paged_engine as tpe
import torch_sharded_ranks as ranks
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ref
from repro_torch.kernels.paged_attention import paged_attention, \
    paged_prefill_attention
from repro_torch.launch.mesh import spawn
from repro_torch.models.model import params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
CFG_KW = dict(layers=2, d_model=64, vocab=331)
SPAWN_S = 240                     # each spawn's time limit
LAYOUTS = {2: "heads", 4: "slots", 3: "replicated"}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _to_jax(a, dtype):
    return jnp.asarray(a, getattr(jnp, dtype)) if a.dtype.kind == "f" \
        else jnp.asarray(a)


def _to_torch(a, dtype):
    t = torch.from_numpy(a)
    return t.to(getattr(torch, dtype)) if t.is_floating_point() else t


# ======================================================================
# the kernels' options, one process
# ======================================================================
def _paged_case(seed, B, Q, Hq, Hkv, D, page, pps):
    """Numpy inputs: pages in a permuted table, q_start ragged (a row at
    0 included), row 1 a decode token and the last row padding."""
    rng = np.random.default_rng(seed)
    P = B * pps + 3
    q = rng.standard_normal((B, Q, Hq, D)).astype(np.float32)
    kp = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    bt = rng.permutation(P)[:B * pps].reshape(B, pps).astype(np.int32)
    qs = np.array([(i * 7) % (page * pps - Q) for i in range(B)], np.int32)
    ql = np.array([Q if i != 1 else 1 for i in range(B)], np.int32)
    ql[-1] = 0
    return q, kp, vp, bt, qs, ql


def _stripes(kp, vp, S):
    psl = kp.shape[1] // S
    return [(np.ascontiguousarray(kp[:, s * psl:(s + 1) * psl]),
             np.ascontiguousarray(vp[:, s * psl:(s + 1) * psl]), s * psl)
            for s in range(S)]


def _merge(parts):
    """The shards' flash merge (``m* = max m``, ``w = l exp(m - m*)``)."""
    m_star = np.max([m for _, m, _ in parts], axis=0)
    ws = [l * np.exp(m - m_star) for _, m, l in parts]
    den = np.maximum(sum(ws), 1e-30)
    return sum(o * w[..., None] for (o, _, _), w in zip(parts, ws)) \
        / den[..., None]


def _hold_stats(got, want, tol):
    """Port (o, m, l) against Pallas's: rows that saw a key agree within
    ``tol`` (m absolutely, o and l relatively too); a row that saw none
    is zeros with l = 0 in the port, and m = NEG_INF in both (Pallas
    leaves such a row's l and o unnormalised garbage when its tile ran
    for another row: the merge weighs them by exp(NEG_INF - m*) = 0)."""
    (o, m, l), (wo, wm, wl) = got, want
    seen = l > 0
    assert np.isfinite(o).all() and np.isfinite(m).all()
    assert (l[~seen] == 0).all() and (o[~seen] == 0).all()
    np.testing.assert_array_equal(m[~seen], np.float32(jref.NEG_INF))
    np.testing.assert_array_equal(wm[~seen], np.float32(jref.NEG_INF))
    np.testing.assert_allclose(m[seen], wm[seen], rtol=tol, atol=tol)
    np.testing.assert_allclose(l[seen], wl[seen], rtol=tol, atol=tol)
    np.testing.assert_allclose(o[seen], wo[seen], rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [2, 4])
def test_prefill_stripes_match_pallas(dtype, S):
    """Each page's slots cut into S stripes: per stripe, the port's
    ``paged_prefill_attention`` (and its span split) with ``pos_stride =
    page`` and stats on a shifted ``q_start`` agrees with the Pallas
    kernel, and the merged stripes reproduce the unsharded function."""
    q, kp, vp, bt, qs, ql = _paged_case(0, 4, 5, 4, 2, 16, 8, 4)
    tol = TOL[dtype]
    want = jref.paged_prefill_attention_ref(
        *(_to_jax(a, dtype) for a in (q, kp, vp, bt, qs, ql)))
    parts = []
    for ks, vs, off in _stripes(kp, vp, S):
        args = (q, ks, vs, bt, qs - off, ql)
        j = jpa.paged_prefill_attention(
            *(_to_jax(a, dtype) for a in args), pos_stride=8,
            return_stats=True, interpret=True)
        t_args = [_to_torch(a, dtype) for a in args]
        got = paged_prefill_attention(*t_args, pos_stride=8,
                                      return_stats=True)
        split = ref.paged_prefill_attention_split_ref(
            *t_args, span=4, pos_stride=8, return_stats=True)
        got_np = tuple(x.float().numpy() for x in got)
        _hold_stats(got_np, tuple(_np(x) for x in j), tol)
        _hold_stats(tuple(x.float().numpy() for x in split),
                    tuple(_np(x) for x in j), tol)
        parts.append(got_np)
    live = np.arange(q.shape[1])[None, :] < ql[:, None]
    np.testing.assert_allclose(_merge(parts)[live], _np(want)[live],
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [2, 4])
def test_decode_stripes_match_pallas(dtype, S):
    """The decode kernel through the same stripes, on seq_lens shifted by
    each stripe's offset (zero or negative for a short row: no key, so a
    zero output with m = NEG_INF, l = 0), against Pallas and merged
    against the unsharded function."""
    q, kp, vp, bt, _, _ = _paged_case(1, 4, 1, 4, 2, 16, 8, 4)
    q = q[:, 0]
    sl = np.array([1, 3, 17, 32], np.int32)
    tol = TOL[dtype]
    want = jref.paged_attention_ref(
        *(_to_jax(a, dtype) for a in (q, kp, vp, bt, sl)))
    parts = []
    for ks, vs, off in _stripes(kp, vp, S):
        args = (q, ks, vs, bt, sl - off)
        j = jpa.paged_attention(*(_to_jax(a, dtype) for a in args),
                                pos_stride=8, return_stats=True,
                                interpret=True)
        t_args = [_to_torch(a, dtype) for a in args]
        got = tuple(x.float().numpy() for x in paged_attention(
            *t_args, pos_stride=8, return_stats=True))
        split = ref.paged_attention_split_ref(*t_args, span=4, pos_stride=8,
                                              return_stats=True)
        _hold_stats(got, tuple(_np(x) for x in j), tol)
        _hold_stats(tuple(x.float().numpy() for x in split),
                    tuple(_np(x) for x in j), tol)
        parts.append(got)
    np.testing.assert_allclose(_merge(parts), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pos_offset_matches_pallas(dtype):
    """A stripe placed by ``pos_offset`` on the unshifted ``q_start``
    (and seq_lens) is the Pallas kernel's, and equals the shifted call."""
    q, kp, vp, bt, qs, ql = _paged_case(2, 4, 5, 4, 2, 16, 8, 4)
    (ks, vs, off), = _stripes(kp, vp, 2)[1:]
    tol = TOL[dtype]
    args = (q, ks, vs, bt, qs, ql)
    j = jpa.paged_prefill_attention(
        *(_to_jax(a, dtype) for a in args), pos_stride=8, pos_offset=off,
        return_stats=True, interpret=True)
    t_args = [_to_torch(a, dtype) for a in args]
    got = paged_prefill_attention(*t_args, pos_stride=8, pos_offset=off,
                                  return_stats=True)
    shifted = paged_prefill_attention(
        *t_args[:4], t_args[4] - off, t_args[5], pos_stride=8,
        return_stats=True)
    _hold_stats(tuple(x.float().numpy() for x in got),
                tuple(_np(x) for x in j), tol)
    for a, b in zip(got, shifted):
        assert torch.equal(a, b)
    sl = qs + 1
    jd = jpa.paged_attention(
        *(_to_jax(a, dtype) for a in (q[:, 0], ks, vs, bt, sl)),
        pos_stride=8, pos_offset=off, return_stats=True, interpret=True)
    gd = paged_attention(*(_to_torch(a, dtype)
                           for a in (q[:, 0], ks, vs, bt, sl)),
                         pos_stride=8, pos_offset=off, return_stats=True)
    _hold_stats(tuple(x.float().numpy() for x in gd),
                tuple(_np(x) for x in jd), tol)


def test_options_off_are_the_default_path():
    """Without stats, stride or offset the wrappers return what they
    return without the options; a stride below the page is refused."""
    q, kp, vp, bt, qs, ql = (torch.from_numpy(a) for a in
                             _paged_case(3, 3, 4, 4, 2, 16, 8, 3))
    base = paged_prefill_attention(q, kp, vp, bt, qs, ql)
    same = paged_prefill_attention(q, kp, vp, bt, qs, ql, pos_stride=8,
                                   pos_offset=0)
    o, _, _ = paged_prefill_attention(q, kp, vp, bt, qs, ql,
                                      return_stats=True)
    assert torch.equal(base, same) and torch.equal(base, o)
    with pytest.raises(ValueError, match="pos_stride"):
        paged_attention(q[:, 0], kp, vp, bt, qs + 1, pos_stride=4)


# ======================================================================
# the sharded plane on CPU meshes of gloo processes
# ======================================================================
@pytest.fixture(scope="module")
def tiny():
    jcfg = j_reduced(j_get_config("qwen2-1.5b"), **CFG_KW)
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    weights = jax.tree.map(np.asarray, jp)
    tcfg = reduced(get_config("qwen2-1.5b"), **CFG_KW)
    return jcfg, jp, tcfg, weights


def _kernel_cases():
    """Inputs of the global-view kernels at the tiny width (Hq 4, Hkv 2,
    D 16, pages of 8), each in f32 and bf16."""
    q, kp, vp, bt, qs, ql = _paged_case(4, 3, 5, 4, 2, 16, 8, 4)
    sl = np.array([1, 9, 31], np.int32)
    rng = np.random.default_rng(5)
    fq = rng.standard_normal((2, 4, 32, 16)).astype(np.float32)
    fk = rng.standard_normal((2, 2, 96, 16)).astype(np.float32)
    fv = rng.standard_normal((2, 2, 96, 16)).astype(np.float32)
    cases = {}
    for dt in TOL:
        cases[f"decode-{dt}"] = ("decode", 2, 8, dt,
                                 (q[:, 0].copy(), kp, vp, bt, sl))
        cases[f"prefill-{dt}"] = ("prefill", 2, 8, dt,
                                  (q, kp, vp, bt, qs, ql))
        cases[f"flash-{dt}"] = ("flash", 2, 8, dt, (fq, fk, fv))
    return cases


def _kernel_want(kind, dtype, args):
    a = [_to_jax(x, dtype) for x in args]
    if kind == "decode":
        return _np(jref.paged_attention_ref(*a))
    if kind == "prefill":
        return _np(jref.paged_prefill_attention_ref(*a))
    return _np(jref.flash_prefill_ref(*a, q_offset=64))


@pytest.fixture(scope="module")
def mesh_runs(tiny, tmp_path_factory):
    """Two spawns a layout, each run on first use: the kernels on every
    rank, and the engine variants on the leader."""
    _, _, _, weights = tiny
    runs = {}

    def run(M, what):
        if (M, what) not in runs:
            store = str(tmp_path_factory.mktemp(f"mesh{M}"))
            if what == "kernels":
                out = spawn(f"1x{M}", ranks.kernels_rank, _kernel_cases(),
                            device="cpu", timeout_s=SPAWN_S,
                            store_dir=store)
            else:
                out = spawn(f"1x{M}", ranks.engines_rank, CFG_KW, weights,
                            list(ranks.VARIANTS), device="cpu",
                            timeout_s=SPAWN_S, store_dir=store)[0]
            runs[M, what] = out
        return runs[M, what]
    return run


@pytest.mark.parametrize("M", list(LAYOUTS))
def test_sharded_kernels_match_jax(mesh_runs, M):
    """Heads (M 2), slots (M 4) and replicated (M 3): every rank's
    ``sharded_paged_attention``, ``attend_chunk`` and
    ``sharded_flash_prefill`` output is the JAX oracle's."""
    cases = _kernel_cases()
    per_rank = mesh_runs(M, "kernels")
    for name, (kind, _, _, dtype, args) in cases.items():
        want = _kernel_want(kind, dtype, args)
        for rank_out in per_rank:
            layout, got = rank_out[name]
            if kind != "flash":
                assert layout == LAYOUTS[M]
            if kind == "prefill":        # padding tokens are discarded
                live = np.arange(args[0].shape[1])[None, :] \
                    < args[5][:, None]
                got, want_l = got[live], want[live]
            else:
                want_l = want
            np.testing.assert_allclose(got, want_l, rtol=TOL[dtype],
                                       atol=TOL[dtype], err_msg=name)
        # every rank holds the same full result
        for rank_out in per_rank[1:]:
            np.testing.assert_array_equal(rank_out[name][1],
                                          per_rank[0][name][1])


def _engine_kw(name):
    return dict(ranks.GEOMETRY, **ranks.VARIANTS[name])


@pytest.fixture(scope="module")
def single_runs(tiny):
    """Every variant on the JAX and the port's single-device engines."""
    jcfg, jp, tcfg, weights = tiny
    tp = params_from_numpy(weights, "cpu")
    out = {}
    for name in ranks.VARIANTS:
        jeng = jpe.PagedRealtimeEngine(jcfg, jp, **_engine_kw(name))
        teng = tpe.PagedRealtimeEngine(tcfg, tp, device="cpu",
                                       **_engine_kw(name))
        out[name] = (ranks.run_variant(jeng, name, jcfg.vocab_size),
                     ranks.run_variant(teng, name, tcfg.vocab_size))
    return out


@pytest.mark.parametrize("name", list(ranks.VARIANTS))
@pytest.mark.parametrize("M", list(LAYOUTS))
def test_sharded_engine_token_exact(mesh_runs, single_runs, M, name):
    """The sharded engine on the trace, in f32: histories, page traffic
    (offload events, evicted and reloaded blocks, copy-on-write copies)
    and turn stats are the single-device port's and the JAX
    single-device engine's."""
    want_j, want_t = single_runs[name]
    got = dict(mesh_runs(M, "engines")[name])
    assert got.pop("kind") == LAYOUTS[M]
    assert want_t["histories"] == want_j["histories"]
    assert got == want_t
    assert got["reloaded"] > 0 and got["offload_events"]
    if name == "prefix":
        assert got["cow_copies"] > 0


def test_sharded_moe_engine_token_exact(tmp_path):
    """The moe family on the heads layout (M 2), every rank running the
    moe layer on the replicated weights: the trace on both planes, in
    f32, token for token and page for page the single-device port's.
    The reference's weights are perturbed so the streams are not one
    repeated token."""
    name = "phi3.5-moe-42b-a6.6b"
    jcfg = j_reduced(j_get_config(name), **CFG_KW)
    rng = np.random.default_rng(0)
    weights = jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape))
        .astype(a.dtype), j_init_params(jcfg, jax.random.PRNGKey(0)))
    tcfg = reduced(get_config(name), **CFG_KW)
    assert tcfg.family == "moe"
    tp = params_from_numpy(weights, "cpu")
    variants = ["fused", "per-token"]
    got = spawn("1x2", ranks.engines_rank, CFG_KW, weights, variants, name,
                device="cpu", timeout_s=SPAWN_S,
                store_dir=str(tmp_path))[0]
    for v in variants:
        want = ranks.run_variant(tpe.PagedRealtimeEngine(
            tcfg, tp, device="cpu", **_engine_kw(v)), v, tcfg.vocab_size)
        res = dict(got[v])
        assert res.pop("kind") == "heads"
        assert res == want, v
        assert want["reloaded"] > 0
        assert len(set(sum(want["histories"]["a"], []))) > 2


# the replay: 4 sessions of the reference's interactive trace on 2
# slots, pages of 8, 8 a session, a pool of 10 pages: evicts and reloads
REPLAY_GEOMETRY = dict(slots=2, page_size=8, pages_per_seq=8, num_pages=10)
REPLAY_WL = dict(kind="interactive", num_sessions=4, seed=5,
                 p_barge_in=0.5, arrival="poisson", rate_rps=4.0)


def test_sharded_replay_matches_single_device(tiny, tmp_path):
    """``run_replay`` on the slots layout (M 4): the turn records, token
    streams and page traffic are the single-device port's, record for
    record, and the pool did evict and reload."""
    _, _, tcfg, weights = tiny
    tp = params_from_numpy(weights, "cpu")
    want = ranks.replay_record(
        lambda clock: tpe.PagedRealtimeEngine(tcfg, tp, device="cpu",
                                              clock=clock,
                                              **REPLAY_GEOMETRY),
        REPLAY_WL, 5)
    got = spawn("1x4", ranks.replay_rank, CFG_KW, weights, REPLAY_GEOMETRY,
                REPLAY_WL, 5, device="cpu", timeout_s=SPAWN_S,
                store_dir=str(tmp_path))[0]
    assert got.pop("kind") == "slots"
    want.pop("kind")
    assert got == want
    assert want["records"] and want["evicted"] > 0 and want["reloaded"] > 0


def test_live_gateway_on_sharded_engine(tiny, tmp_path):
    """The asyncio gateway end to end over an M 2 engine: every session
    completes, every turn completes or is barged, the slots and pages are
    free at the end and the invariants hold."""
    _, _, _, weights = tiny
    got = spawn("1x2", ranks.live_rank, CFG_KW, weights, device="cpu",
                timeout_s=SPAWN_S, store_dir=str(tmp_path))
    assert got[1] is None
    assert got[0] == dict(kind="heads", completed=4, turns=got[0]["turns"],
                          every_turn_ends=True, slots_free=True,
                          pages_free=True)
    assert got[0]["turns"] >= 4


def _serve_json(tmp_path, *flags):
    # the launcher's ranks meet in a temporary directory: under tmp_path
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               TMPDIR=str(tmp_path))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--engine",
         "real", "--device", "cpu", "--config", "tiny", "--json", *flags],
        capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=SPAWN_S)
    assert r.returncode == 0, r.stderr[-4000:]
    return r


def test_launcher_mesh_prints_the_same_turn_stats(tmp_path):
    """``--engine real --mesh 1x2`` spawns its ranks and rank 0 prints the
    turn stats, pool and preload counts of the run without a mesh; the
    mapping and backend are logged."""
    plain = _serve_json(tmp_path)
    mesh = _serve_json(tmp_path, "--mesh", "1x2")
    assert mesh.stdout == plain.stdout
    assert "[mesh] 1x2: 2 rank(s), ranks on the cpu, backend gloo" \
        in mesh.stderr
