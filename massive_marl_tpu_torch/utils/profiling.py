"""Tracing and timing helpers (twin of massive_marl_tpu/utils/profiling.py).

- `trace(logdir)`: a torch.profiler context (CPU, and CUDA when a card is
  there) that writes a Chrome trace into logdir on exit, with the
  program's spans recorded in it;
- `PhaseTimer`: accumulating per-phase wall-clock splits; a phase given a
  `sync` tensor on CUDA waits for its device with torch.cuda.synchronize
  before it stops the clock;
- `span(name)` / `spanned(name)`: the program's spans at its layer
  boundaries (the trainer's rollout, policy and update steps, the env step,
  its physics, substeps, box substep and finish_step), recorded by one
  process-wide `SpanRecorder` while `enable()` has turned it on: calls,
  total and self seconds per name (`totals()`), and, while torch.profiler
  records, a `record_function` range named PREFIX + name on the trace's
  clock.  Off (the default) a span is one shared no-op object;
- `measure_rtt`: the host <-> device round trip of a tiny fetch;
- `time_scanned`: the per-call device time of a `carry -> carry` step, by
  CUDA events around n calls (wall clock on the CPU);
- `assert_finite`: a host-side NaN / Inf check over a nested dict, list or
  nn.Module state.
"""
from __future__ import annotations

import contextlib
import functools
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Tuple

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; on exit write logdir/trace_<pid>.json (open it in
    Perfetto or chrome://tracing).  Yields the torch.profiler.profile."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(logdir, exist_ok=True)
    was_on, RECORDER.on = RECORDER.on, True
    try:
        with profile(activities=acts) as prof:
            yield prof
    finally:
        RECORDER.on = was_on
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}.json"))


def _wait(sync):
    if isinstance(sync, torch.Tensor) and sync.is_cuda:
        torch.cuda.synchronize(sync.device)


class PhaseTimer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        """Time the block; with `sync` (a tensor the block produces, on
        CUDA) the clock stops once its device has finished."""
        t0 = time.perf_counter()
        yield
        _wait(sync)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def summary(self) -> str:
        return " ".join(
            f"{k}={self.totals[k] / max(self.counts[k], 1) * 1000:.1f}ms"
            for k in sorted(self.totals))

    def fps(self, name: str, steps_per_call: int) -> float:
        t = self.totals[name] / max(self.counts[name], 1)
        return steps_per_call / t if t > 0 else 0.0


PREFIX = "mmt."     # the profiler's name of span s is PREFIX + s


class _Off:
    """The span of a recorder that is off: enters and leaves doing nothing."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class SpanRecorder(PhaseTimer):
    """Host-clock spans that nest: per name, `counts` calls and `totals`
    seconds as a PhaseTimer keeps them (so `summary()` prints the mean per
    call), and `self_totals`, each span's duration less its direct
    children's.  Each thread keeps its own stack of open spans.  A span
    times the host's work: CUDA launches return before the device runs
    them."""

    def __init__(self):
        super().__init__()
        self.on = False
        self.self_totals: Dict[str, float] = defaultdict(float)
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _add(self, name: str, total_ns: int, self_ns: int):
        with self._lock:
            self.counts[name] += 1
            self.totals[name] += total_ns * 1e-9
            self.self_totals[name] += self_ns * 1e-9

    def reset(self):
        with self._lock:
            self.counts.clear()
            self.totals.clear()
            self.self_totals.clear()


class _Span:
    """One recorded span: perf_counter_ns at entry and exit, around the
    profiler's record_function range where torch.profiler records (so the
    recorded interval holds the profiler's)."""
    __slots__ = ("rec", "name", "t0", "child_ns", "rf")

    def __init__(self, rec: SpanRecorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        self.rec._stack().append(self)
        self.child_ns, self.rf = 0, None
        self.t0 = time.perf_counter_ns()
        if torch._C._autograd._profiler_enabled():
            self.rf = torch.autograd.profiler.record_function(PREFIX + self.name)
            self.rf.__enter__()
        return None

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        dur = time.perf_counter_ns() - self.t0
        stack = self.rec._stack()
        stack.pop()
        if stack:
            stack[-1].child_ns += dur
        self.rec._add(self.name, dur, dur - self.child_ns)
        return False


RECORDER = SpanRecorder()   # the process's one recorder, which every span reports to


def span(name: str):
    """A context manager around one layer's work, recorded under `name`
    while the recorder is on; off, the one shared no-op object."""
    return _Span(RECORDER, name) if RECORDER.on else _OFF


def spanned(name: str):
    """Decorator: every call of the function in span(name)."""
    def wrap(fn):
        @functools.wraps(fn)
        def spanned_fn(*args, **kw):
            if not RECORDER.on:
                return fn(*args, **kw)
            with _Span(RECORDER, name):
                return fn(*args, **kw)
        return spanned_fn
    return wrap


def enable():
    RECORDER.on = True


def disable():
    RECORDER.on = False


def reset():
    """Forget every recorded span (the on/off state stays)."""
    RECORDER.reset()


def totals() -> Dict[str, Tuple[int, float, float]]:
    """{name: (calls, total seconds, self seconds)} of the recorded spans."""
    rec = RECORDER
    with rec._lock:
        return {k: (rec.counts[k], rec.totals[k], rec.self_totals[k]) for k in rec.counts}


def measure_rtt(n: int = 10, device=None) -> float:
    """Seconds for one host <-> device round trip of a tiny fetch on
    `device` (default: CUDA when there is a card, else the CPU)."""
    dev = torch.device(device if device is not None else
                       ("cuda" if torch.cuda.is_available() else "cpu"))
    x = torch.zeros((), device=dev)
    float(x + 1.0)
    t0 = time.perf_counter()
    for i in range(n):
        float(x + float(i))
    return (time.perf_counter() - t0) / n


def time_scanned(step_fn, init_carry, n: int = 20, warmup: int = 2) -> float:
    """Seconds per call of `carry -> carry` step_fn: `warmup` untimed
    calls, then n calls between two CUDA events when the carry holds a CUDA
    tensor (the device time, however far the host runs ahead), else
    between two wall-clock reads."""
    carry = init_carry
    for _ in range(warmup):
        carry = step_fn(carry)
    leaves = carry if isinstance(carry, (list, tuple)) else \
        list(carry.values()) if isinstance(carry, dict) else [carry]
    dev = next((x.device for x in leaves if isinstance(x, torch.Tensor) and x.is_cuda), None)
    if dev is None:
        t0 = time.perf_counter()
        for _ in range(n):
            carry = step_fn(carry)
        return (time.perf_counter() - t0) / n
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    start.record()
    for _ in range(n):
        carry = step_fn(carry)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1000.0 / n


def _leaves(tree, path=""):
    if isinstance(tree, torch.nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def assert_finite(tree, name: str = "tree"):
    """Raise FloatingPointError naming the first leaf (a tensor or array in
    a nested dict / list / tuple, or an nn.Module's state) that holds a
    NaN or an Inf (a debug tool: it reads every leaf on the host)."""
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            ok = bool(torch.isfinite(leaf).all()) if leaf.is_floating_point() else True
        else:
            import numpy as np
            ok = bool(np.isfinite(np.asarray(leaf, dtype=np.float64)).all())
        if not ok:
            raise FloatingPointError(f"non-finite values in {name}{path}")
