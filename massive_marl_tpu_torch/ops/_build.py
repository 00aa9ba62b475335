"""Build the CUDA sources of ops/csrc/ at first use.

Each source is compiled by `nvcc` into a shared library with a plain C
interface under `<repo>/build/kernels/`, named by a hash of the source, the
headers of csrc/ and the flags, so an edit rebuilds and an unchanged source
is reused.  Python loads it with ctypes.  Nothing here runs at import time.
"""
from __future__ import annotations

import glob
import hashlib
import os
import shutil
import subprocess
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BUILD_DIR = os.path.join(REPO_ROOT, "build", "kernels")
# -fmad=false: no fused multiply-add, so a kernel rounds exactly where its
# plain PyTorch version (one rounding per elementwise op) does
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels are "
                           "built from ops/csrc/ at first use")
    return found


class BuildResult:
    """Path of the built library, the compiler's log and the build seconds
    (0 when an up-to-date library was reused)."""

    def __init__(self, path: str, log: str, seconds: float):
        self.path, self.log, self.seconds = path, log, seconds


def build(source: str) -> BuildResult:
    """Compile csrc/<source> unless a library built from the same bytes exists."""
    src = os.path.join(CSRC, source)
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as fh:
            h.update(fh.read())
    digest = h.hexdigest()[:16]
    stem = os.path.splitext(source)[0]
    out = os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")
    log_path = out + ".log"
    if os.path.exists(out):
        log = ""
        if os.path.exists(log_path):
            with open(log_path) as fh:
                log = fh.read()
        return BuildResult(out, log, 0.0)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {src}:\n{log}")
    with open(log_path, "w") as fh:
        fh.write(log)
    os.replace(tmp, out)
    return BuildResult(out, log, seconds)
