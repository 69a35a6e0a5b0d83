"""The control comes out as not correct: the reference put in the
program's place in float8 (the precision below the served bfloat16)
reads a widest gap several times the served precision's, at a size a
test run holds (the cells' readings, at their own size on the card, are
in PERF.md)."""
from __future__ import annotations

import torch

from livebench import manifest, weights
from livebench.reference import model as ref


def _gaps(lg, toks):
    return lg.max(-1).values - lg.gather(1, toks[:, None])[:, 0]


def test_float8_control_fails_where_bfloat16_passes():
    from repro_torch.configs.registry import ModelConfig
    from repro_torch.models.model import forward
    conf = manifest.config("qwen3-4b")
    model = dict(conf["model"], num_layers=4, d_model=256, num_heads=4,
                 num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=4096)
    W = weights.make(model, 2 ** 33 + 5, "cpu",
                     conf["weights"]["embed_std"])
    g = torch.Generator().manual_seed(3)
    toks = torch.randint(0, model["vocab_size"], (128,), generator=g)
    pos = torch.arange(len(toks))
    with torch.no_grad():
        want = ref.forward(model, W, {"s": toks}, {"s": pos})["s"]
        served = forward(ModelConfig(**model), W, toks[None])
        served = served[0] if isinstance(served, torch.Tensor) \
            else served[0][0]
        ctl = ref.forward(model, W, {"s": toks}, {"s": pos},
                          quant="fp8")["s"]
    bf16 = _gaps(want, served.float().argmax(-1))
    fp8 = _gaps(want, ctl.argmax(-1))
    assert fp8.max() > 3 * bf16.max(), (float(fp8.max()), float(bf16.max()))
    assert fp8.mean() > 3 * bf16.mean()
