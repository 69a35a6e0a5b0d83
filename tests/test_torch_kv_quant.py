"""The port's int8 KV wire tier against the JAX package's.

- ``encode_page`` on the same f32 arrays gives the JAX package's int8
  payload and block scales bit for bit (both round half to even), and
  ``decode_page`` its values;
- the quantizer's guarantees on the port's CPU tensors: the f32
  dequantization ``q * scale`` lies within scale/2 of the input (plus
  f32 rounding), exact zeros survive, pad lanes never raise a tail
  block's scale; a bf16 page decodes to bf16, to exactly the bf16
  rounding of that dequantization;
- ``wire_scale`` and the modeled channel's pricing;
- the engine's offload/reload round trip through the int8 tier against
  the JAX engine's (decoded host copies, reloaded pages, ledger), on an
  f32 store and on a bf16 one, and the fp32 engine's ledger that saves
  nothing (``tests/test_kv_quant.py``'s engine cases).
"""
import jax
import numpy as np
import pytest
import torch

import repro.kvcache.quant as jq
import repro.serving.paged_engine as jpe
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import init_params as j_init_params
import repro_torch.kvcache.quant as tq
import repro_torch.serving.paged_engine as tpe
from repro_torch.configs import get_config, reduced
from repro_torch.models.model import init_params, params_from_numpy

BLOCK = tq.BLOCK
GRID_SHAPES = [(BLOCK,), (3, BLOCK), (5,), (BLOCK + 3,),
               (2, 2, BLOCK // 2 + 1), (2, 3, 4, 5),
               (2, 2, 4, 2, 16)]          # an engine page's host copy
MAGS = (1e-8, 1.0, 1e4)


def _grid():
    rng = np.random.default_rng(7)
    out = [(rng.standard_normal(s) * m).astype(np.float32)
           for s in GRID_SHAPES for m in MAGS]
    out.append(np.zeros((BLOCK + 9,), np.float32))
    x = np.zeros((BLOCK,), np.float32)
    x[0], x[1] = 1e6, -1e6
    out.append(x)
    return out


GRID = _grid()


@pytest.mark.parametrize("i", range(len(GRID)))
def test_encode_page_bit_exact_vs_jax(i):
    x = GRID[i]
    want = jq.encode_page(x)
    got = tq.encode_page(torch.from_numpy(x))
    assert got.q.dtype == torch.int8 and got.scales.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), want.q)
    np.testing.assert_array_equal(got.scales.numpy().view(np.uint32),
                                  want.scales.view(np.uint32))
    assert got.shape == want.shape and got.dtype == torch.float32
    back = tq.decode_page(got)
    assert back.dtype == torch.float32 and tuple(back.shape) == x.shape
    np.testing.assert_array_equal(back.numpy().view(np.uint32),
                                  jq.decode_page(want).view(np.uint32))
    assert got.nbytes == want.nbytes


def _bounds(x: torch.Tensor, page):
    flat = x.float().reshape(-1)
    n = flat.numel()
    scale = page.scales.repeat_interleave(BLOCK)[:n]
    deq = (page.q.float() * page.scales[:, None]).reshape(-1)[:n]
    return flat, scale, deq


@pytest.mark.parametrize("i", range(len(GRID)))
def test_roundtrip_guarantees(i):
    """The JAX test's three guarantees on the port's tensors."""
    x = torch.from_numpy(GRID[i])
    page = tq.encode_page(x)
    back = tq.decode_page(page)
    flat, scale, _ = _bounds(x, page)
    err = (back.reshape(-1) - flat).abs()
    assert bool((err <= scale / 2 + 1e-7).all()), \
        f"max err {err.max()} vs bound {scale.min() / 2}"
    assert bool((back.reshape(-1)[flat == 0] == 0).all())


def test_pad_lanes_never_raise_the_tail_scale():
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(
        BLOCK + 17).astype(np.float32))
    whole, tail = tq.encode_page(x), tq.encode_page(x[BLOCK:])
    assert whole.scales[-1] == tail.scales[0]
    assert torch.equal(whole.q[-1], tail.q[0])
    # the block's max-magnitude element maps to exactly +/-127
    page = tq.encode_page(x[:BLOCK])
    assert abs(int(page.q.reshape(-1)[int(x[:BLOCK].abs().argmax())])) \
        == 127


@pytest.mark.parametrize("mag", [1e-3, 1.0, 30.0])
def test_bf16_page_roundtrip(mag):
    """A bf16 host copy (what a bf16 store offloads): the f32
    dequantization lies within scale/2 of every element (plus f32
    rounding, 2^-23 of the value); decoding gives a bf16 tensor that is
    exactly the bf16 rounding of it, so each element is off by at most
    scale/2 and half a bf16 step more. (That last rounding can take an
    element past scale/2 alone: bf16's step near a block's max is
    about the scale.) The input is never held by the encoded page."""
    g = torch.Generator().manual_seed(1)
    x = (torch.randn(2, 2, 4, 2, 16, generator=g) * mag).to(torch.bfloat16)
    x[0, 0, 0, 0, :3] = 0
    keep = x.clone()
    page = tq.encode_page(x)
    x.fill_(7)                                  # a reused staging buffer
    back = tq.decode_page(page)
    assert back.dtype == torch.bfloat16 and back.shape == keep.shape
    flat, scale, deq = _bounds(keep, page)
    assert bool(((deq - flat).abs()
                 <= scale / 2 + 2.0 ** -23 * flat.abs()).all())
    assert torch.equal(back.reshape(-1).view(torch.int16),
                       deq.to(torch.bfloat16).view(torch.int16))
    half_step = 2.0 ** (torch.floor(torch.log2(deq.abs().clamp(
        min=1e-30))) - 8)
    err = (back.reshape(-1).float() - flat).abs()
    assert bool((err <= scale / 2 + half_step + 2.0 ** -23 * flat.abs())
                .all())
    assert bool((back.reshape(-1)[flat == 0] == 0).all())


def test_codec_formats_and_wire_scale():
    c = tq.KVWireCodec("fp32")
    x = torch.ones(4, 3)
    assert c.encode(x) is x and c.decode(x) is x
    assert c.wire_scale(4) == 1.0 and c.wire_scale(2) == 1.0
    q = tq.KVWireCodec("int8")
    enc = q.encode(x)
    assert isinstance(enc, tq.QuantizedPage)
    assert torch.allclose(q.decode(enc), x, atol=1e-6)
    assert q.wire_scale(4) == (1 + 4 / BLOCK) / 4 \
        == jq.KVWireCodec("int8").wire_scale(np.float32)
    assert q.wire_scale(2) == (1 + 4 / BLOCK) / 2
    assert round(q.wire_scale(4), 3) == 0.254
    assert round(q.wire_scale(2), 3) == 0.508
    with pytest.raises(ValueError, match="kv_quant"):
        tq.KVWireCodec("int4")


# ======================================================================
# the engine's int8 tier against the JAX engine's
# ======================================================================
@pytest.fixture(scope="module")
def tiny():
    jcfg = j_reduced(j_get_config("qwen2-1.5b"), layers=2, d_model=64,
                     vocab=331)
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = reduced(get_config("qwen2-1.5b"), layers=2, d_model=64,
                   vocab=331)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")

    def make(framework, **kw):
        kw.setdefault("slots", 2)
        kw.setdefault("page_size", 4)
        kw.setdefault("pages_per_seq", 8)
        kw.setdefault("num_pages", 32)
        kw.setdefault("chunk_pages", 1)
        if framework == "jax":
            return jpe.PagedRealtimeEngine(jcfg, jp, **kw)
        return tpe.PagedRealtimeEngine(tcfg, tp, device="cpu", **kw)
    return tcfg, make


def test_channel_prices_compressed_bytes(tiny):
    _, make = tiny
    f32 = make("torch")
    i8 = make("torch", kv_quant="int8")
    ji8 = make("jax", kv_quant="int8")
    ws = i8.codec.wire_scale(4)
    assert f32.kv.channel.wire_scale == 1.0
    assert i8.kv.channel.wire_scale == ws == ji8.kv.channel.wire_scale
    assert i8.kv.channel.block_bytes == f32.kv.channel.block_bytes \
        == ji8.kv.channel.block_bytes
    assert i8.kv.channel.transfer_time(5) == pytest.approx(
        f32.kv.channel.transfer_time(5) * ws)
    assert i8.kv.channel.transfer_time(5) == \
        ji8.kv.channel.transfer_time(5)


def _offload_reload(eng, vocab):
    """tests/test_kv_quant.py's drive: evict two pages of a, flush,
    clobber the freed slots with b, reload a through its next turn.
    Returns (decoded host copies before the reload, a's pages after)."""
    rng = np.random.default_rng(3)
    eng.add_session("a", rng.integers(0, vocab, size=10), max_new_tokens=6)
    eng.run_to_completion()
    seq = eng.pool.seq("a")
    assert eng.kv.evict(2, eng.clock.now()) == 2
    eng.flush_transfers()
    assert len(seq.offloaded) == 2 and not seq.offloading
    before = {li: eng.codec.decode(enc) for li, enc in seq.offloaded.items()}
    kinds = {type(enc).__name__ for enc in seq.offloaded.values()}
    eng.add_session("b", rng.integers(0, vocab, size=8), max_new_tokens=2)
    eng.run_to_completion()
    eng.start_turn("a", rng.integers(0, vocab, size=4), max_new_tokens=4)
    eng.run_to_completion()
    eng.check_invariants()
    assert not seq.offloaded
    after = {li: (eng.k_pages[:, seq.pages[li]], eng.v_pages[:, seq.pages[li]])
             for li in before}
    return before, after, kinds


def _ledger(eng):
    st = eng.transfer.stats
    return (st.wire_bytes_saved, st.wire_bytes_moved, st.reload_wire_bytes,
            st.offload_pages_completed, eng.kv.reloaded_blocks)


def test_int8_offload_reload_matches_jax(tiny):
    """The int8 engine's host copies are QuantizedPages that decode to
    the JAX engine's values; the reloaded device pages are exactly the
    decoded copies; histories and the wire ledger are the JAX engine's,
    and the ledger reports the savings."""
    cfg, make = tiny
    t = make("torch", num_pages=12, kv_quant="int8")
    j = make("jax", num_pages=12, kv_quant="int8")
    tb, ta, tkinds = _offload_reload(t, cfg.vocab_size)
    jb, ja, jkinds = _offload_reload(j, cfg.vocab_size)
    assert tkinds == {"QuantizedPage"} and jkinds == {"QuantizedPage"}
    assert {s: x.history for s, x in t.sessions.items()} == \
        {s: x.history for s, x in j.sessions.items()}
    for li, host in tb.items():
        np.testing.assert_allclose(host.numpy(), jb[li], rtol=0, atol=1e-5)
        assert torch.equal(ta[li][0], host[0])
        assert torch.equal(ta[li][1], host[1])
    assert _ledger(t) == pytest.approx(_ledger(j))
    st = t.transfer.stats
    assert st.wire_bytes_saved > 0
    bb = t.kv.channel.block_bytes
    assert st.wire_bytes_moved == pytest.approx(
        (st.offload_pages_completed + t.kv.reloaded_blocks) * bb
        * t.kv.channel.wire_scale)
    assert st.reload_wire_bytes <= 0.5 * t.kv.reloaded_blocks * bb


def test_fp32_engine_ledger_saves_nothing(tiny):
    """The identity codec: host copies stay plain tensors, nothing is
    saved, wire bytes equal logical bytes — as in the JAX engine."""
    cfg, make = tiny
    for fw in ("torch", "jax"):
        eng = make(fw, num_pages=12)
        rng = np.random.default_rng(3)
        eng.add_session("a", rng.integers(0, cfg.vocab_size, size=10),
                        max_new_tokens=6)
        eng.run_to_completion()
        assert eng.kv.evict(2, eng.clock.now()) == 2
        eng.flush_transfers()
        plain = torch.Tensor if fw == "torch" else np.ndarray
        for enc in eng.pool.seq("a").offloaded.values():
            assert isinstance(enc, plain)
        st = eng.transfer.stats
        assert st.wire_bytes_saved == 0.0
        assert st.wire_bytes_moved == \
            st.offload_pages_completed * eng.kv.channel.block_bytes


def test_bf16_store_int8_roundtrip():
    """A bf16 page store through the int8 tier: the wire scale is the
    bf16 one, host copies decode to bf16, the reloaded pages are those
    decoded copies bit for bit, and each element is within the bf16
    round-trip bound of what was offloaded."""
    cfg = reduced(get_config("qwen2-1.5b"), layers=2, d_model=64,
                  vocab=331).replace(dtype="bfloat16",
                                     param_dtype="bfloat16")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = tpe.PagedRealtimeEngine(cfg, params, slots=2, page_size=4,
                                  pages_per_seq=8, num_pages=12,
                                  chunk_pages=1, kv_quant="int8",
                                  device="cpu")
    assert eng.kv.channel.wire_scale == (1 + 4 / BLOCK) / 2
    rng = np.random.default_rng(3)
    eng.add_session("a", rng.integers(0, 331, size=10), max_new_tokens=6)
    eng.run_to_completion()
    seq = eng.pool.seq("a")
    lis = list(range(len(seq.pages)))[-2:]
    orig = {li: torch.stack([eng.k_pages[:, seq.pages[li]],
                             eng.v_pages[:, seq.pages[li]]]).clone()
            for li in lis}
    assert eng.kv.evict(2, eng.clock.now()) == 2
    eng.flush_transfers()
    assert sorted(seq.offloaded) == lis
    decoded = {}
    for li, enc in seq.offloaded.items():
        back = eng.codec.decode(enc)
        assert back.dtype == torch.bfloat16
        flat, scale, deq = _bounds(orig[li], enc)
        assert bool(((deq - flat).abs()
                     <= scale / 2 + 2.0 ** -23 * flat.abs()).all())
        assert torch.equal(back.reshape(-1).view(torch.int16),
                           deq.to(torch.bfloat16).view(torch.int16))
        decoded[li] = back
    eng.add_session("b", rng.integers(0, 331, size=8), max_new_tokens=2)
    eng.run_to_completion()
    eng.start_turn("a", rng.integers(0, 331, size=4), max_new_tokens=4)
    eng.run_to_completion()
    eng.check_invariants()
    for li, back in decoded.items():
        got = torch.stack([eng.k_pages[:, seq.pages[li]],
                           eng.v_pages[:, seq.pages[li]]])
        assert torch.equal(got.view(torch.int16), back.view(torch.int16))
    assert eng.transfer.stats.wire_bytes_saved > 0
