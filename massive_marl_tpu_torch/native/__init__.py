"""ctypes binding of the native TensorBoard event writer (the tfevents half
of massive_marl_tpu/native/__init__.py).

tbevents.cc is a copy of the JAX package's source: TFRecord framing, masked
CRC32C and hand-encoded Event protos.  It is built with g++ at first use
into <repo>/build/native/, named by a hash of the source and the flags, as
ops/_build.py names the CUDA libraries, so an edit rebuilds.  Nothing is
built at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import socket
import subprocess
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(os.path.dirname(_HERE))
BUILD_DIR = os.path.join(REPO_ROOT, "build", "native")
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_tb_lib = None


def build_lib(source: str) -> str:
    """Compile native/<source> with g++ unless a library built from the
    same bytes exists; returns its path (RuntimeError when g++ fails)."""
    src = os.path.join(_HERE, source)
    with open(src, "rb") as fh:
        digest = hashlib.sha256(" ".join(GXX_FLAGS).encode() + fh.read()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"lib{os.path.splitext(source)[0]}_{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, src], capture_output=True,
                              text=True)
    except OSError as e:
        raise RuntimeError(f"g++ is not available to build {source}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}) on {src}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def get_tb_lib():
    global _tb_lib
    if _tb_lib is None:
        lib = ctypes.CDLL(build_lib("tbevents.cc"))
        lib.tb_open.restype = ctypes.c_void_p
        lib.tb_open.argtypes = [ctypes.c_char_p, ctypes.c_double]
        lib.tb_scalar.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_float,
                                  ctypes.c_longlong, ctypes.c_double]
        lib.tb_flush.argtypes = [ctypes.c_void_p]
        lib.tb_close.argtypes = [ctypes.c_void_p]
        _tb_lib = lib
    return _tb_lib


class TBEventWriter:
    """Native tfevents scalar writer: the SummaryWriter.add_scalar subset
    the trainers use.  Files are named and framed as the JAX package's
    writer names and frames them.  Raises RuntimeError when the library
    cannot be built; utils/logging.Writer then falls back to torch's
    SummaryWriter."""

    def __init__(self, log_dir: str):
        lib = get_tb_lib()
        os.makedirs(log_dir, exist_ok=True)
        now = time.time()
        self.path = os.path.join(
            log_dir, f"events.out.tfevents.{int(now)}.{socket.gethostname()}.{os.getpid()}")
        self._lib = lib
        self._h = lib.tb_open(self.path.encode(), now)
        if not self._h:
            raise RuntimeError(f"tb_open failed for {self.path}")

    def add_scalar(self, tag: str, value: float, step: int, wall_time: float | None = None):
        self._lib.tb_scalar(self._h, tag.encode(), float(value), int(step),
                            time.time() if wall_time is None else wall_time)

    def flush(self):
        if self._h:
            self._lib.tb_flush(self._h)

    def close(self):
        if self._h:
            self._lib.tb_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
