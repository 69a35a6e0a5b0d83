"""The port's KV-quantization quality gate against the JAX package's.

``run_quality_gate`` replays one seeded multi-turn trace through an
fp32-wire control engine and a candidate engine, forcing every turn's
pages through evict -> flush -> reload so later turns decode on KV
that crossed the wire. Here the port's gate (on the CPU, the paged
kernels' plain versions) and the JAX gate run on the same weights, on
seeds 0 and 1, on both planes:

- token flips, tokens compared, reloaded pages and wire bytes saved
  are equal, and the logit MSE agrees within 1e-6;
- the fp32 control is exactly 0 (no flips, ``logit_mse == 0.0``);
- int8 holds the reference's ``QualityTolerance`` and saves wire bytes.
"""
import jax
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import init_params as j_init_params
from repro.serving import quality_gate as jgate
from repro_torch.configs import get_config, reduced
from repro_torch.models.model import params_from_numpy
from repro_torch.serving import quality_gate as tgate

MSE_TOL = 1e-6


@pytest.fixture(scope="module")
def gates():
    jcfg = j_reduced(j_get_config("qwen2-1.5b"), layers=2, d_model=64,
                     vocab=331)
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = reduced(get_config("qwen2-1.5b"), layers=2, d_model=64,
                   vocab=331)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    cache = {}

    def get(framework, kv_quant, seed, fused):
        key = (framework, kv_quant, seed, fused)
        if key not in cache:
            if framework == "jax":
                cache[key] = jgate.run_quality_gate(
                    jcfg, jp, kv_quant=kv_quant, seed=seed,
                    fused_step=fused)
            else:
                cache[key] = tgate.run_quality_gate(
                    tcfg, tp, kv_quant=kv_quant, seed=seed,
                    fused_step=fused, device="cpu")
        return cache[key]
    get.model = (tcfg, tp)
    return get


def _counts(r):
    return (r.token_flips, r.tokens_compared, r.logit_positions,
            r.reloaded_pages, r.wire_bytes_saved, r.per_turn_flips)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "tokenwise"])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kv_quant", ["fp32", "int8"])
def test_gate_matches_jax(gates, kv_quant, seed, fused):
    got = gates("torch", kv_quant, seed, fused)
    want = gates("jax", kv_quant, seed, fused)
    assert _counts(got) == _counts(want)
    assert abs(got.logit_mse - want.logit_mse) <= MSE_TOL
    assert got.reloaded_pages > 0, "gate drove no pages through the wire"
    assert got.tokens_compared > 0 and got.logit_positions > 0
    if kv_quant == "fp32":
        assert got.token_flips == 0
        assert got.logit_mse == 0.0
        assert got.wire_bytes_saved == 0.0
    else:
        tol = tgate.QualityTolerance()
        assert (tol.max_token_flip_rate, tol.max_logit_mse) == (0.01, 1e-2)
        assert got.within(tol)
        assert 0.0 < got.logit_mse
        assert got.wire_bytes_saved > 0.0
        assert got.summary()["quant_token_flip_rate"] == \
            got.token_flip_rate


def test_gate_asserts_its_tolerance(gates):
    """With ``tol`` the gate raises when the candidate misses it."""
    r = gates("torch", "int8", 0, True)
    strict = tgate.QualityTolerance(max_token_flip_rate=1.0,
                                    max_logit_mse=r.logit_mse / 2)
    with pytest.raises(AssertionError, match="failed the quality gate"):
        tgate.run_quality_gate(*gates.model, kv_quant="int8", seed=0,
                               tol=strict, device="cpu")
