"""Whole runs of the harness on the CPU at a tiny size: the reference
agrees with the port's CPU path, and each fault a served cell can have,
planted in the timed path, turns ``correct`` false. The card's own
look (``run.py``) is skipped; everything after it runs."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

from livebench import manifest
from livebench.faults import FAULTS
from livebench.harness import run_cell

HERE = Path(__file__).resolve().parent
SECONDS = 0.8


def _tiny(kind: str) -> dict:
    base = manifest.config("qwen3-4b" if kind == "dense"
                           else "phi3.5-moe-16of32")
    m = dict(base["model"], name=f"tiny-{kind}", num_layers=2,
             d_model=64, num_heads=4, num_kv_heads=2, head_dim=32,
             d_ff=96, vocab_size=331, dtype="float32",
             param_dtype="float32")
    if kind == "moe":
        m["moe"] = dict(m["moe"], num_experts=4, d_ff_expert=96)
    return {"name": m["name"], "weights": base.get("weights", {}),
            "model": m}


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    d = tmp_path_factory.mktemp("livebench")
    for sub in ("configs", "traffic", "limits"):
        (d / sub).mkdir()
    shutil.copytree(HERE / "metrics", d / "metrics")
    mix = manifest.traffic(json.loads(
        (HERE.parent / "BENCHMARK.json").read_text())["workloads"][0]
        ["traffic"])
    mix.update(conversations=5, ramp_s=0.2, audio_per_token_s=0.01)
    g = mix["generator"]
    g["turns"] = [2, 3]
    g["prompt_tokens"] = dict(median=12, sigma=0.5, min=3, max=40)
    g["reply_audio_s"] = dict(median=0.12, sigma=0.5, min=0.05, max=0.3)
    g["speech_s"] = g["think_s"] = dict(median=0.04, sigma=0.3, min=0.02,
                                        max=0.08)
    mix["gateway"].update(slots=4, page_size=8, pages_per_seq=16,
                          num_pages=80,
                          round_token_budget=8, prefill_chunk=4,
                          frontier_cap_s=0.2)
    (d / "traffic" / "tiny.json").write_text(json.dumps(mix))
    cells = []
    for kind in ("dense", "moe"):
        c = _tiny(kind)
        (d / "configs" / f"{c['name']}.json").write_text(json.dumps(c))
        name = f"{c['name']}.tiny"
        (d / "limits" / f"{name}.json").write_text(json.dumps(
            {"compare": {"gap_max": 1e-3, "gap_q50": 1e-3,
                         "gap_turn_far_max": 1e-3}, "sessions": 1000}))
        cells.append({"name": name, "config": c["name"], "traffic": "tiny",
                      "chips": 1, "why": "test"})
    # the moe cell's own numbers: the median gap and the largest share
    # of a turn's tokens far off
    phi = manifest.limits("phi3.5-moe.voice")
    (d / "limits" / "tiny-moe.medians.json").write_text(json.dumps(
        {"compare": {k: 1e-3 for k in phi["compare"]}, "sessions": 1000}))
    cells.append({"name": "tiny-moe.medians", "config": "tiny-moe",
                  "traffic": "tiny", "chips": 1, "why": "test"})
    b = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    b["workloads"] = cells
    for m in b["end_to_end"] + b["per_layer"]:
        m.pop("workloads", None)
    old = manifest.HERE
    manifest.HERE = d
    yield b
    manifest.HERE = old


def _run(bench, cell, trace=False, faults=None):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return run_cell(cell, 2 ** 31 + 11, SECONDS, trace, device="cpu",
                        bench=bench, log=lambda m: None, faults=faults)
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("cell", ["tiny-dense.tiny", "tiny-moe.tiny"])
def test_reference_agrees_with_the_port_on_the_cpu(bench, cell):
    out = _run(bench, cell, trace=cell.startswith("tiny-moe"))
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["_info"]["served_tokens"] > 20
    assert list(out)[-2:] == ["checks", "_info"]
    assert out["device"]["platform"] == "cpu"
    # no device metric is read from a CPU run
    assert not {"device_idle_pct", "step_mfu_pct",
                "paged_attn_roofline_pct"} & set(out["metrics"])


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(bench, fault):
    out = _run(bench, "tiny-dense.tiny", faults=FAULTS[fault])
    assert not out["correct"], out["checks"]


def test_the_moe_cells_numbers_see_a_fault_in_a_few_rows(bench):
    out = _run(bench, "tiny-moe.medians")
    assert out["correct"], out["checks"]
    out = _run(bench, "tiny-moe.medians", faults=FAULTS["half_batch"])
    assert not out["correct"], out["checks"]
    assert out["checks"]["gap_turn_far_max"]["value"] > 1e-3
