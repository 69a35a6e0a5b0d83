"""The benchmark's entry point: one cell, run once.

    python3 livebench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer ones; the numbers that decide ``correct`` come last in it,
each beside its limit, and again as the last lines of standard error.
It exits with a code other than 0, and prints no result, when no CUDA
device is present, or when the process has loaded JAX or the JAX
package once the window has closed.

Options for measuring the benchmark itself (never passed by a check):
``--control 1`` also runs the reference in float8 at the same positions
(the control that the limits are set against); ``--conversations`` and
``--num-pages`` override the mix's population and pool (the knee
sweep); ``--fault <name>`` plants a fault of ``livebench/faults.py`` in
the timed path; ``--dump <file>`` writes the run's records and every
compared token's readings.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".livebench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _env() -> None:
    """Caches inside the checkout, at fixed paths; no JAX through a
    library."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    ap.add_argument("--conversations", type=int)
    ap.add_argument("--num-pages", type=int)
    ap.add_argument("--fault")
    ap.add_argument("--dump", help="write per-turn and per-round records "
                    "of the run to this JSON file")
    a = ap.parse_args(argv)
    _env()
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("livebench: the system under test (src/repro_torch) is not "
              "in this checkout", file=sys.stderr)
        return 2
    import torch
    from livebench import manifest
    cell = manifest.cell(manifest.bench(ROOT), a.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"livebench: {a.workload} needs {cell['chips']} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    from livebench.faults import FAULTS
    from livebench.harness import run_cell
    override = {}
    if a.conversations:
        override["conversations"] = a.conversations
    if a.num_pages:
        override["gateway"] = {"num_pages": a.num_pages}

    def log(msg):
        print(msg, file=sys.stderr, flush=True)
    out = run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                   t_start=T_START, mix_override=override or None,
                   control=bool(a.control), log=log, dump=a.dump,
                   faults=FAULTS[a.fault] if a.fault else None)
    bad = loaded_forbidden()
    if bad:
        print(f"livebench: the process loaded {bad}; the benchmark runs "
              "the port alone", file=sys.stderr)
        return 4
    out.pop("_info", None)
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(out, allow_nan=False), flush=True)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    rc = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # skip the interpreter's teardown: the result is out, and the CUDA
    # profiler's teardown has crashed the process at exit
    os._exit(rc)
