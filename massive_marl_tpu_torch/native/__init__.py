"""ctypes bindings of the native runtime libraries (twin of
massive_marl_tpu/native/__init__.py).

  mmtio.cc    - mmap'd float32 .npy dataset IO (write, zero-copy read, row
                gather) for the offline-RL data path;
  tbevents.cc - the TensorBoard event writer: TFRecord framing, masked
                CRC32C and hand-encoded Event protos.

Both are copies of the JAX package's sources.  Each is built with g++ at
first use into <repo>/build/native/, named by a hash of the source and the
flags, as ops/_build.py names the CUDA libraries, so an edit rebuilds.
Nothing is built at import time.  The .npy functions fall back to numpy's
reader and writer when the library cannot be built, as the JAX binding's
do.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import socket
import subprocess
import time

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(os.path.dirname(_HERE))
BUILD_DIR = os.path.join(REPO_ROOT, "build", "native")
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_tb_lib = None
_mmtio_lib = None


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


def get_mmtio_lib():
    """The mmtio library, or None when g++ cannot build it."""
    global _mmtio_lib
    if _mmtio_lib is None:
        try:
            lib = ctypes.CDLL(build_lib("mmtio.cc"))
        except (RuntimeError, OSError):
            return None
        f32p, i64p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64)
        lib.mmtio_write_npy.restype = ctypes.c_int
        lib.mmtio_write_npy.argtypes = [ctypes.c_char_p, f32p, ctypes.c_int64, ctypes.c_int64]
        lib.mmtio_open_npy.restype = ctypes.c_void_p
        lib.mmtio_open_npy.argtypes = [ctypes.c_char_p, i64p, i64p]
        lib.mmtio_data.restype = f32p
        lib.mmtio_data.argtypes = [ctypes.c_void_p]
        lib.mmtio_gather_rows.restype = ctypes.c_int
        lib.mmtio_gather_rows.argtypes = [ctypes.c_void_p, i64p, ctypes.c_int64, f32p]
        lib.mmtio_close.argtypes = [ctypes.c_void_p]
        _mmtio_lib = lib
    return _mmtio_lib


def write_npy(path: str, arr) -> None:
    """Write `arr` as a float32 [rows, cols] .npy file (a 1-d array becomes
    one column) with the native writer, or numpy's when the library cannot
    be built."""
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    if arr.ndim == 1:
        arr = arr[:, None]
    lib = get_mmtio_lib()
    if lib is None:
        np.save(path if path.endswith(".npy") else path + ".npy", arr)
        return
    rc = lib.mmtio_write_npy(path.encode(), arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                             arr.shape[0], arr.shape[1])
    if rc != 0:
        raise IOError(f"mmtio_write_npy failed rc={rc} for {path}")


class NpyMmap:
    """Zero-copy mmap'd float32 .npy reader with a native row gather;
    numpy's mmap reader when the library cannot be built."""

    def __init__(self, path: str):
        lib = get_mmtio_lib()
        self._h = None
        if lib is None:
            self._np = np.load(path, mmap_mode="r")
            self.shape = self._np.shape
            return
        rows, cols = ctypes.c_int64(), ctypes.c_int64()
        self._h = lib.mmtio_open_npy(path.encode(), ctypes.byref(rows), ctypes.byref(cols))
        if not self._h:
            raise IOError(f"mmtio_open_npy failed for {path}")
        self._lib = lib
        self.shape = (rows.value, cols.value)
        self._np = None

    def as_array(self) -> np.ndarray:
        if self._np is not None:
            return np.asarray(self._np)
        n = self.shape[0] * self.shape[1]
        return np.ctypeslib.as_array(self._lib.mmtio_data(self._h), shape=(n,)).reshape(self.shape)

    def gather(self, idx) -> np.ndarray:
        idx = np.ascontiguousarray(idx, dtype=np.int64)
        if self._h is None:
            return np.asarray(self.as_array()[idx])
        out = np.empty((len(idx), self.shape[1]), np.float32)
        rc = self._lib.mmtio_gather_rows(
            self._h, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(idx),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc != 0:
            raise IOError(f"mmtio_gather_rows rc={rc}")
        return out

    def close(self):
        if self._h is not None:
            self._lib.mmtio_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


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
