"""The port's copies of the workload traces, the metrics, the cost
model and the simulator, and its launcher's ``--engine sim``, against
the JAX package's.

These modules are framework-free copies (only their imports differ),
so everything they produce is held to the reference exactly: the
seeded sessions and turns field by field, the simulator's
``Metrics.summary()`` dict, and the launcher's JSON. The launcher keeps
every argparse rejection of the reference (``--mesh``'s included); what
it once refused as not ported is taken: ``--autotune`` (handed to the
live harness), and a fleet of ``--replicas`` above 1 over a ``--mesh``,
whatever its ``--workload``.
"""
import dataclasses
import json
import sys

import numpy as np
import pytest

import repro.launch.serve as j_serve
from repro.serving import costmodel as j_costmodel
from repro.serving import simulator as j_simulator
from repro.serving import workload as j_workload
import repro_torch.launch.serve as t_serve
from repro_torch.serving import costmodel as t_costmodel
from repro_torch.serving import simulator as t_simulator
from repro_torch.serving import workload as t_workload

KINDS = ("sharegpt", "interactive", "mixed", "duplex", "toolcall",
         "handoff")
# open-loop Poisson, open-loop bursty, and the closed loop (concurrency)
ARRIVALS = ("poisson", "burstgpt", "closed")


def _wl(mod, kind, arrival, families, seed, **kw):
    closed = arrival == "closed"
    return mod.WorkloadConfig(
        kind=kind, num_sessions=6, seed=seed, p_barge_in=0.4,
        arrival="poisson" if closed else arrival,
        concurrency=3 if closed else None, rate_rps=1.5,
        prompt_families=families,
        family_prefix_len=12 if families else 0, **kw)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("families", [0, 3])
@pytest.mark.parametrize("arrival", ARRIVALS)
@pytest.mark.parametrize("kind", KINDS)
def test_generate_matches_reference(kind, arrival, families, seed):
    want = j_workload.generate(_wl(j_workload, kind, arrival, families,
                                   seed))
    got = t_workload.generate(_wl(t_workload, kind, arrival, families,
                                  seed))
    assert want and all(s.turns for s in want)
    assert [dataclasses.asdict(s) for s in got] == \
        [dataclasses.asdict(s) for s in want]
    if families:
        for fam in range(families):
            np.testing.assert_array_equal(
                t_workload.family_prefix(_wl(t_workload, kind, arrival,
                                             families, seed), fam, 331,
                                         seed),
                j_workload.family_prefix(_wl(j_workload, kind, arrival,
                                             families, seed), fam, 331,
                                         seed))
    assert t_workload.TOOL_RESUME_GAP_S == j_workload.TOOL_RESUME_GAP_S


# the launcher's three systems (launch/serve.py)
SYSTEMS = {
    "liveserve": dict(policy="liveserve"),
    "vllm-omni": dict(policy="fcfs", kv_policy="lru", preload=False),
    "vllm-omni-wo": dict(policy="fcfs", kv_policy="none", preload=False),
}


def _sim(mod_cost, mod_sim, mod_wl, pipeline, system, barge):
    pipe = mod_cost.PIPELINES[pipeline](kv_capacity_gb=2.0)
    wl = mod_wl.WorkloadConfig(kind="interactive", num_sessions=8,
                               concurrency=4, seed=3, p_barge_in=barge)
    return mod_sim.run_sim(pipe, wl, until=3600.0, **SYSTEMS[system])


@pytest.mark.parametrize("barge", [0.0, 0.5])
@pytest.mark.parametrize("pipeline", ["qwen3-omni-like", "ming-omni-like"])
@pytest.mark.parametrize("system", list(SYSTEMS))
def test_simulation_summary_matches_reference(system, pipeline, barge):
    want = _sim(j_costmodel, j_simulator, j_workload, pipeline, system,
                barge)
    got = _sim(t_costmodel, t_simulator, t_workload, pipeline, system,
               barge)
    assert want.turns and want.completed_sessions == 8
    assert got.summary() == want.summary()
    assert [dataclasses.asdict(t) for t in got.turns] == \
        [dataclasses.asdict(t) for t in want.turns]


# ======================================================================
# the launcher
# ======================================================================
def _ref_main(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve.py", *argv])
    j_serve.main()


def _port_main(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve.py", *argv])
    t_serve.main(argv)


SIM_FLAGS = [
    ["--sessions", "6", "--concurrency", "3", "--barge-in", "0.5"],
    ["--model", "ming-omni-like", "--system", "vllm-omni", "--sessions",
     "6", "--workload", "mixed"],
    ["--system", "vllm-omni-wo", "--kv-gb", "2", "--sessions", "5",
     "--workload", "sharegpt", "--seed", "4"],
]


@pytest.mark.parametrize("flags", SIM_FLAGS, ids=lambda f: "-".join(f[:2]))
def test_launcher_sim_json_matches_reference(flags, monkeypatch, capsys):
    argv = ["--engine", "sim", "--json", *flags]
    _ref_main(argv, monkeypatch)
    want = capsys.readouterr().out
    _port_main(argv, monkeypatch)
    got = capsys.readouterr().out
    assert json.loads(want)["turns"] > 0
    assert got == want


def _rejection(main, argv, monkeypatch, capsys) -> str:
    with pytest.raises(SystemExit) as e:
        main(argv, monkeypatch)
    assert e.value.code == 2
    err = capsys.readouterr().err.strip().splitlines()[-1]
    assert err.startswith("serve.py: error: ")
    return err[len("serve.py: error: "):]


# every argparse rejection of the reference launcher, with the words
# that must stand in both launchers' messages
REJECTIONS = [
    (["--engine", "sim", "--clock-scale", "2"], "--clock-scale only apply"),
    (["--engine", "real", "--slots", "2", "--kv-pages", "9"],
     "--slots, --kv-pages only apply to --engine live"),
    (["--engine", "sim", "--preload-chunks", "2"], "--preload-chunks"),
    (["--engine", "real", "--replicas", "2"], "--replicas only apply"),
    (["--engine", "sim", "--prefix-cache"], "--prefix-cache only apply"),
    (["--engine", "sim", "--prompt-families", "2",
      "--family-prefix-len", "8"],
     "--prompt-families, --family-prefix-len only apply"),
    (["--engine", "real", "--kv-quant", "int8"], "--kv-quant only apply"),
    (["--engine", "sim", "--spec-decode", "2"], "--spec-decode only apply"),
    (["--engine", "sim", "--autotune", "c.json"], "--autotune only apply"),
    (["--engine", "sim", "--mesh", "1x8"], "the simulator models costs"),
    (["--engine", "sim", "--no-fused-step"], "the simulator has no data"),
    (["--engine", "real", "--model", "ming-omni-like"],
     "--model only applies to --engine sim"),
    (["--engine", "live", "--model", "qwen3-omni-like"],
     "--model only applies to --engine sim"),
    (["--engine", "real", "--workload", "mixed", "--sessions", "3"],
     "does not take --workload, --sessions"),
    (["--engine", "real", "--barge-in", "0.5", "--kv-gb", "2"],
     "does not take --barge-in, --kv-gb"),
    (["--engine", "sim", "--workload", "duplex"],
     "--workload duplex drives gateway-level"),
    (["--engine", "sim", "--workload", "toolcall"],
     "--workload toolcall drives gateway-level"),
    (["--engine", "sim", "--workload", "handoff"],
     "--workload handoff drives gateway-level"),
    (["--engine", "live", "--kv-gb", "2", "--concurrency", "3"],
     "--kv-gb, --concurrency do not apply"),
    (["--engine", "live", "--system", "vllm-omni-wo"],
     "supports --system liveserve|vllm-omni"),
    (["--engine", "live", "--replicas", "0"], "--replicas must be >= 1"),
    (["--engine", "live", "--spec-decode", "-1"],
     "--spec-decode must be >= 0"),
    (["--engine", "live", "--spec-decode", "2", "--no-fused-step"],
     "cannot run on the per-token control plane"),
    (["--engine", "live", "--mesh", "1xq"], "--mesh wants DxM"),
    (["--engine", "real", "--mesh", "0x2"], "--mesh dims must be >= 1"),
]


@pytest.mark.parametrize("argv,words", REJECTIONS,
                         ids=[" ".join(a) for a, _ in REJECTIONS])
def test_launcher_rejects_as_reference(argv, words, monkeypatch, capsys):
    want = _rejection(_ref_main, argv, monkeypatch, capsys)
    got = _rejection(_port_main, argv, monkeypatch, capsys)
    assert words in want
    assert words in got


# what the port once refused as not ported, each ported since (item
# None): the fleet (``--replicas`` above 1, the ``handoff`` workload) over
# a mesh, which the launcher launches on the mesh with the replica count,
# and ``--autotune``, which it hands to the live harness
NOT_PORTED = [
    ("--engine live --autotune cache.json",
     ["--engine", "live", "--autotune", "cache.json"], "--autotune", None),
    ("--engine live --replicas 2",
     ["--engine", "live", "--replicas", "2", "--mesh", "1x2"], "--mesh",
     None),
    ("--engine live --workload handoff",
     ["--engine", "live", "--workload", "handoff", "--replicas", "3",
      "--mesh", "1x2"], "--mesh", None),
]


@pytest.mark.parametrize("argv,flag,item", [c[1:] for c in NOT_PORTED],
                         ids=[c[0] for c in NOT_PORTED])
def test_launcher_rejects_what_is_not_ported(argv, flag, item,
                                             monkeypatch, capsys):
    if item is None:
        launched = []
        monkeypatch.setattr(t_serve, "_serve", lambda mesh, device, fn:
                            launched.append((mesh, fn.args)))
        _port_main(argv, monkeypatch)
        [(mesh, args)] = launched
        value = argv[argv.index(flag) + 1]
        if flag == "--autotune":         # the live harness's keyword
            assert mesh is None and args[3]["autotune"] == value
        else:
            replicas = int(argv[argv.index("--replicas") + 1])
            assert (mesh, args[-1]) == (value, replicas)
        return
    got = _rejection(_port_main, argv, monkeypatch, capsys)
    assert flag in got
    assert got.endswith(f"not ported yet (ROADMAP.md queue 1 item "
                        f"{item})")


@pytest.mark.parametrize("flag", [["--device", "cpu"],
                                  ["--config", "tiny"]])
def test_launcher_sim_takes_no_device(flag, monkeypatch, capsys):
    got = _rejection(_port_main, ["--engine", "sim", *flag], monkeypatch,
                     capsys)
    assert got.startswith(f"{flag[0]} only apply to --engine real|live")
