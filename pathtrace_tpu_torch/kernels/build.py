"""Build the CUDA kernels of ``pathtrace_tpu_torch/csrc`` into one shared
library with a plain C interface.

The library is compiled at first use by ``nvcc`` for Hopper (``sm_90a``)
into ``pathtrace_tpu_torch/_build/``: one ``nvcc -c`` per source, all
started together, then one link. Its file name carries a hash of the sources
and flags, so an edit rebuilds and an unchanged tree reuses the library.
Nothing here runs at import time.

Flags: ``-fmad=false`` keeps each kernel's rounding next to its plain-torch
twin (no contracted multiply-adds); fast math is never used, because the
sphere padding rows rely on NaN failing every compare.

Run ``python -m pathtrace_tpu_torch.kernels.build`` to build and print the
library's path.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
SOURCES = ("fused_bounce.cu", "shadow_any_hit.cu", "intersect.cu", "bvh.cu",
           "combined_closest_small.cu", "triangle_closest.cu", "binned.cu", "resident.cu",
           "rng.cu")
HEADERS = ("geom.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC",
)


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else the toolkit's default location, else PATH."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libpt_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> tuple[Path, float]:
    """Compile the library unless it exists; returns ``(path, seconds)``
    (0 seconds when it was already built)."""
    out = library_path()
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, src + ".o") for src in SOURCES]
        _run_all([[nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
                   "-I", str(CSRC), "-c", "-o", obj, str(CSRC / src)]
                  for src, obj in zip(SOURCES, objs)], verbose)
        lib = os.path.join(tmp, "lib.so")
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]], verbose)
        os.replace(lib, out)   # atomic: a concurrent build sees a whole file
    return out, time.perf_counter() - t0


def _run_all(cmds, verbose: bool) -> None:
    """Start every command at once, wait for all, raise on the first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outputs = [p.communicate()[0] for p in procs]
    for cmd, p, output in zip(cmds, procs, outputs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{' '.join(cmd)}\n{output}")
        if verbose and output:
            print(output)


if __name__ == "__main__":
    path, secs = build(verbose=True)
    print(f"{path} ({secs:.1f} s)")
