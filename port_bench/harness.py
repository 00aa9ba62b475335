"""The benchmark's harness: one run of one cell.

Everything that belongs to a cell, a configuration, a trainer or a
per-layer metric sits in a file of its own that the harness finds by name:

  workloads/<cell>.json    the configuration, the traffic, the warm-up,
                           checked and traced iterations and the limits of
                           the comparison;
  traffic/<traffic>.json   the envs and the physics path;
  configs/<config>.json    the configuration as it is run, with its source;
  trainers/<trainer>.py    builds the port's trainer, drives its checked
                           iterations, follows them with the plain reference
                           and counts an iteration's work;
  metrics/<metric>.py      read(r) -> the metric's value, or None where the
                           run has nothing to read for it; a metric timed by
                           a synced span of the harness names the call in
                           WRAPS.

BENCHMARK.json at the checkout's root says which metrics a cell reports.

A run: build the trainer from the seed, drive its warm-up iterations (the
first of them checked; every shape of the window is used in them), then the
window, whole iterations of train_iter and the metrics' fetch until
`seconds` have passed.  A traced run turns the program's own spans on
(`utils/profiling`), times the calls its metrics' WRAPS name on the host
clock in its window, then profiles a few more iterations with no wrapper
installed, so they run what the untraced window runs (PPO's rollout graph
refuses an env whose step_batch is wrapped).  After the window the port's
state is freed and the plain reference follows the checked iterations from
the same inputs; `correct` is the comparison's verdict.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from port_bench import window

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BANNED = ("jax", "jaxlib", "flax", "massive_marl_tpu")
SPAN_PREFIX = "port_bench."


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def load_cell(name: str):
    """(cell, configuration) of a cell name: the cell's file with its
    traffic's parameters folded in, and its configuration's file."""
    cell = load_json(os.path.join(HERE, "workloads", f"{name}.json"))
    traffic = load_json(os.path.join(HERE, "traffic", f"{cell['traffic']}.json"))
    cell = {**{k: v for k, v in traffic.items() if k != "why"}, **cell}
    config = load_json(os.path.join(HERE, "configs", f"{cell['config']}.json"))
    return cell, config


def trainer_module(config: dict):
    return importlib.import_module(f"port_bench.trainers.{config['trainer']}")


def metrics_of(bench: dict, cell_name: str, kind: str) -> List[dict]:
    """The entries of BENCHMARK.json's `kind` list that cell_name reports."""
    return [m for m in bench[kind] if cell_name in m.get("workloads", [cell_name])]


def reader(name: str):
    """metrics/<name>.py, loaded by its path (a metric's name may hold dots)."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def banned_modules() -> List[str]:
    """The JAX stack's and the JAX package's top-level modules in
    sys.modules, compared by whole top-level name."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(BANNED))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unread ({type(e).__name__})"
    lines = out.stdout.strip().splitlines()
    return lines[0].split(",")[-1].strip() if lines else "unread"


class Spans:
    """Host-clock spans around calls into the layers, installed on the
    program's objects as instance attributes (the program is not edited).
    Each span synchronizes the device before and after, so its time is the
    layer's whole time.  An instance attribute can change what runs: PPO's
    rollout graph refuses an env whose step_batch is overridden."""

    def __init__(self):
        self.times: Dict[str, List[float]] = {}
        self._installed = []

    def wrap(self, obj, attr: str, name: str):
        import torch
        orig = getattr(obj, attr)
        times = self.times.setdefault(name, [])
        sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)

        def spanned(*args, **kw):
            sync()
            t0 = time.perf_counter()
            out = orig(*args, **kw)
            sync()
            times.append(time.perf_counter() - t0)
            return out

        setattr(obj, attr, spanned)
        self._installed.append((obj, attr))

    def install(self, built, wraps):
        """Wrap each (object, method, span name) of `wraps`; the object is
        an attribute of `built` (`trainer`, `env`)."""
        for obj, attr, name in wraps:
            self.wrap(getattr(built, obj), attr, name)

    def remove(self):
        for obj, attr in self._installed:
            delattr(obj, attr)
        self._installed = []


@dataclass
class Readings:
    """What a per-layer metric's reader may read."""
    cell: dict
    config: dict
    work: dict                       # the trainer's counted work per iteration
    iter_s: List[float]              # the window's iteration wall times
    spans: Dict[str, List[float]] = field(default_factory=dict)
    trace: Optional[object] = None   # trace.Trace of the profiled iterations
    # the program's spans over the window: {name: (calls, total s, self s)}
    program: Dict[str, Tuple[int, float, float]] = field(default_factory=dict)


def program_summary(program: Dict[str, Tuple[int, float, float]], iterations: int) -> str:
    """The program's spans over the window, per window iteration, as text."""
    lines = [f"the program's spans (host clock, unsynced), per window iteration of "
             f"{iterations}:", f"{'total':>12}  {'self':>12}  {'calls':>8}"]
    for name, (n, total, own) in sorted(program.items(), key=lambda kv: -kv[1][1]):
        lines.append(f"{1e3 * total / iterations:9.3f} ms  {1e3 * own / iterations:9.3f} ms  "
                     f"{n / iterations:8.2f}  {name}")
    return "\n".join(lines) + "\n"


def run_cell(name: str, seed: int, seconds: float, traced: bool, t_start: float,
             device: str = "cuda", err=None, bench=None, cell=None, config=None) -> dict:
    """One run of cell `name`; returns the result line's object.  t_start
    is the process's start on the host clock (time.perf_counter).  bench,
    cell and config default to the files (tests pass small ones)."""
    import torch

    from massive_marl_tpu_torch.utils import profiling

    err = err or sys.stderr
    bench = bench or benchmark()
    if cell is None:
        cell, config = load_cell(name)
    chips = next(w["chips"] for w in bench["workloads"] if w["name"] == name)
    mod = trainer_module(config)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    # ---- set-up: build, then the warm-up iterations through the window's own
    # call, the first of them checked; they use every shape of the window
    built = mod.build(config, cell, seed, dev)
    prog = mod.checked(built, config, cell["checked_iterations"])
    for _ in range(cell["warmup_iterations"] - cell["checked_iterations"]):
        mod.iterate(built)
    sync()
    setup_s = time.perf_counter() - t_start

    # ---- the window; a traced run has the program's spans on from here to the
    # profiled iterations' end
    spans = Spans()
    if traced:
        readers = {m["name"]: reader(m["name"]) for m in metrics_of(bench, name, "per_layer")}
        spans.install(built, [r.WRAPS for r in readers.values() if hasattr(r, "WRAPS")])
        profiling.reset()
        profiling.enable()
    iter_s, attempted, failed = [], 0, 0
    t0 = t_end = time.perf_counter()
    while True:
        attempted += 1
        ti = time.perf_counter()
        try:
            m = mod.iterate(built)
        except Exception:  # a failed iteration is counted and ends the window
            traceback.print_exc(file=err)
            failed += 1
            break
        t1 = t_end = time.perf_counter()
        iter_s.append(t1 - ti)
        if not all(math.isfinite(v) for v in m.values()):
            failed += 1
        if t1 - t0 >= seconds:
            break
    window_s = t_end - t0
    spans.remove()
    program = profiling.totals() if traced else {}
    if iter_s:
        q = max(1, len(iter_s) // 4)
        parts = [iter_s[k:k + q] for k in range(0, len(iter_s), q)]
        print("window: ms per iteration by quarter " + " ".join(
            f"{1e3 * sum(p) / len(p):.1f}" for p in parts), file=err)

    trace = None
    try:
        if traced and cuda and not failed:
            from port_bench import trace as trace_mod
            trace = trace_mod.profile_iterations(lambda: mod.iterate(built),
                                                 cell["trace_iterations"],
                                                 (SPAN_PREFIX, profiling.PREFIX))
            print(f"trace: {trace.iterations} iterations, {trace.launches} launches, "
                  f"busy {trace.busy_s:.6f} of {trace.window_s:.6f} s, "
                  f"{trace.unattributed_s:.6f} of {trace.device_s:.6f} s of device time "
                  f"unattributed, read in {trace.read_s:.1f} s", file=err)
            os.makedirs(os.path.join(HERE, "out"), exist_ok=True)
            with open(os.path.join(HERE, "out", f"{name}.{seed}.trace.txt"), "w") as fh:
                fh.write(trace.summary())
                fh.write(program_summary(program, len(iter_s)))
    finally:
        profiling.disable()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    found = banned_modules()
    if found:
        raise RuntimeError(f"modules of the JAX stack loaded by the window: {found}")

    # ---- the port's state freed, the reference follows the checked iterations
    del built
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = mod.reference(config, cell, seed, dev, cell["checked_iterations"])
    from port_bench.reference import compare
    values = compare.numbers(prog, ref)
    limits = cell["limits"]
    correct = compare.judge(values, limits) and failed == 0 and bool(iter_s)
    print(f"reference: {cell['checked_iterations']} iterations in "
          f"{time.perf_counter() - t_ref:.1f} s", file=err)

    # ---- metrics
    metrics = {}
    if not traced and iter_s:
        e2e = {"env_steps_per_s": window.rate(mod.env_steps_per_iter(config, cell),
                                              len(iter_s), window_s),
               "iter_ms.p90": 1e3 * window.percentile(iter_s, 90),
               "setup_s": setup_s}
        for m in metrics_of(bench, name, "end_to_end"):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    elif traced and iter_s:
        r = Readings(cell=cell, config=config, work=mod.counted_work(config, cell),
                     iter_s=iter_s, spans=spans.times, trace=trace, program=program)
        for m in metrics_of(bench, name, "per_layer"):
            v = readers[m["name"]].read(r)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    line = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
            "device": {"platform": "gpu" if cuda else dev.type,
                       "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
                       "count": chips,
                       "memory_peak_bytes": peak,
                       "power_limit": power_limit() if cuda else "none"}}
    if trace is not None:
        line["device"].update(busy_s=trace.busy_s, window_s=trace.window_s)
        line["breakdown"] = trace.breakdown()
    line["window"] = {"iterations": len(iter_s), "seconds": window_s}
    line["checks"] = {k: {"value": values[k], "limit": limits[k]} for k in compare.NUMBERS}
    for k in compare.NUMBERS:
        print(f"check {k}: {values[k]!r} (limit {limits[k]!r})", file=err)
    return line
