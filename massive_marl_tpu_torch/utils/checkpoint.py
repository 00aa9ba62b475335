"""Asynchronous checkpoints and automatic restore (twin of
massive_marl_tpu/utils/checkpoint.py).

A checkpoint is a tree of string-keyed dicts with tensor leaves, written in
flax's msgpack format by utils/msgpack_lite, so the JAX package's files and
the port's are one format.  `AsyncCheckpointer` moves the tree to the host
in `save` and encodes and writes it on a worker thread, keeping the newest
`keep` files; every write goes to a `.tmp` file that is renamed into place,
so a reader never sees a partial checkpoint.  `restore_latest` resumes from
the newest complete one.
"""
from __future__ import annotations

import glob
import os
import queue
import re
import threading
from typing import Any

import torch

from massive_marl_tpu_torch.utils import msgpack_lite
from massive_marl_tpu_torch.utils.tree import tree_map


def to_host(tree):
    """Every tensor leaf detached and copied to the CPU (a copy for a CPU
    tensor too, so a later in-place update cannot reach a pending write)."""
    return tree_map(lambda x: x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor)
                    else x, tree)


def _step_of(path: str) -> int:
    m = re.search(r"_(\d+)\.ckpt$", path)
    return int(m.group(1)) if m else -1


def newest(paths):
    """The newest of `paths` by modification time, then by step number."""
    return max(paths, key=lambda p: (os.path.getmtime(p), _step_of(p))) if paths else None


class AsyncCheckpointer:
    def __init__(self, directory: str, keep: int = 3, prefix: str = "ckpt"):
        self.directory = directory
        self.keep = keep
        self.prefix = prefix
        os.makedirs(directory, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._error: Exception | None = None
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{self.prefix}_{step}.ckpt")

    def save(self, step: int, tree: Any):
        """Returns once the tree is on the host; the disk write runs on the
        worker thread."""
        self._q.put((step, to_host(tree)))

    def _run(self):
        while True:
            step, tree = self._q.get()
            try:
                if step is None:
                    break
                atomic_write_bytes(self._path(step), msgpack_lite.packb(tree))
                self._gc()
            except Exception as e:  # noqa: BLE001 - handed to the caller in wait()
                self._error = e
            finally:
                self._q.task_done()

    def _gc(self):
        paths = sorted(glob.glob(os.path.join(self.directory, f"{self.prefix}_*.ckpt")),
                       key=lambda p: (os.path.getmtime(p), _step_of(p)))
        for p in paths[: -self.keep]:
            try:
                os.remove(p)
            except OSError:
                pass

    def wait(self):
        """Block until every pending write is on disk; raise the first
        error a write met."""
        self._q.join()
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def close(self):
        self.wait()
        self._q.put((None, None))
        self._worker.join(timeout=5)


def restore_into(template, state, path: str = ""):
    """`state` (a decoded checkpoint) in the structure of `template`: every
    key of a template dict must be in state's, and a tensor leaf must have
    the template leaf's shape; it takes the template leaf's dtype and
    device."""
    where = path or "/"
    if isinstance(template, dict):
        if not isinstance(state, dict):
            raise ValueError(f"checkpoint holds {type(state).__name__} at {where}, "
                             "the template a dict")
        missing = set(template) - set(state)
        if missing:
            raise ValueError(f"checkpoint lacks keys {sorted(missing)} at {where}")
        return {k: restore_into(v, state[k], f"{path}/{k}") for k, v in template.items()}
    if isinstance(template, torch.Tensor):
        if not isinstance(state, torch.Tensor) or state.shape != template.shape:
            got = tuple(state.shape) if isinstance(state, torch.Tensor) else type(state).__name__
            raise ValueError(f"checkpoint holds {got} at {where}, the template "
                             f"{tuple(template.shape)}")
        return state.to(device=template.device, dtype=template.dtype)
    return state


def load_tree(path: str):
    with open(path, "rb") as f:
        return msgpack_lite.unpackb(f.read())


def restore_latest(directory: str, template: Any, prefix: str = "ckpt"):
    """(the newest complete checkpoint in `template`'s structure, its step),
    or (None, None) if the directory has none (a fresh start)."""
    path = newest(glob.glob(os.path.join(directory, f"{prefix}_*.ckpt")))
    if path is None:
        return None, None
    return restore_into(template, load_tree(path)), _step_of(path)


def atomic_write_bytes(path: str, blob: bytes):
    """tmp file, fsync, os.replace: a process killed mid-write leaves the
    previous complete file (or none) at `path`, never a truncated one."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
