"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is
compiled by ``nvcc`` for ``sm_90a`` into a shared library under
``kernels/build/`` (git-ignored), named by a hash of its source and of
the shared ``csrc/*.cuh`` headers so an edited source is rebuilt, and
loaded with ``ctypes``. Nothing here runs when the module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
CSRC = HERE / "csrc"
BUILD = HERE / "build"
SOURCES = ("paged_attention", "flash_prefill", "ssd_scan")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict = {}


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels are built on the machine with the card")
    return found


def _lib_path(name: str) -> Path:
    """Named by a hash of the source, the shared headers and the flags."""
    text = b"".join(p.read_bytes() for p in
                    [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD / f"lib{name}-{digest[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile every missing library, one ``nvcc`` per source, all
    started together. Returns ``{name: ptxas report}`` for the sources
    built now; raises with the compiler's output if one fails."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = _lib_path(name)
        if lib.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, lib)
    reports, failed = {}, []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}:\n{out}")
            continue
        os.replace(tmp, lib)        # atomic: a reader never sees half
        reports[name] = out
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        _loaded[name] = lib
    return lib


def sass_counts(name: str) -> dict:
    """{kernel symbol: number of ``HMMA`` instructions, the tensor-core
    products} in the built library's SASS, from ``cuobjdump
    --dump-sass``."""
    tool = Path(nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "--dump-sass", str(_lib_path(name))],
                         capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        line = line.strip()
        if line.startswith("Function : "):
            fn = line[len("Function : "):]
            counts[fn] = 0
        elif fn is not None and " HMMA." in line:
            counts[fn] += 1
    return counts


def timed_build(names=SOURCES) -> tuple:
    """(seconds, ptxas reports) of building ``names`` from scratch."""
    for name in names:
        _lib_path(name).unlink(missing_ok=True)
    t0 = time.perf_counter()
    reports = build(names)
    return time.perf_counter() - t0, reports
