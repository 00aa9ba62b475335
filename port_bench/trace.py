"""Reading a profiler trace of a few window iterations: the device's busy
time as the union of its operations' intervals, kernel time and launches by
name, the device operations by group, and the device's idle gaps by what
the host was doing."""
from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

# device kernels grouped by what issues them (profiler names; the first
# group with a key in the name takes the kernel)
KERNEL_GROUPS = (("B1 substep kernel", ("substep_kernel",)),
                 ("B4 mlp_tower fwd", ("tower_fwd_wgmma",)),
                 ("B5 mlp_tower bwd row pass", ("tower_bwd_wgmma",)),
                 ("B2 dense_elu_ln fwd", ("dense_fwd_wgmma",)),
                 ("B3 dense_elu_ln bwd row pass", ("ln_bwd_rows_wgmma",)),
                 ("B3/B5 dW pass", ("dw_wgmma", "reduce_dw_kernel")),
                 ("B3/B5 partial-sum reductions", ("colsum_partial_kernel", "colsum_final_kernel")),
                 ("GEMM", ("gemm", "nvjet", "cutlass", "gemv")),
                 ("optimizer (foreach)", ("multi_tensor_apply",)),
                 ("reductions", ("reduce_kernel",)),
                 ("ELU fwd/bwd", ("elu",)),
                 ("copies and cat", ("Cat", "copy", "Memcpy")),
                 ("other elementwise", ("elementwise", "cross_kernel", "index")))

def kernel_group(name: str) -> str:
    return next((g for g, keys in KERNEL_GROUPS if any(k in name for k in keys)), "other")


@dataclass
class Trace:
    iterations: int
    window_s: float                  # the traced window's length
    busy_s: float                    # union of the device's operation intervals in it
    launches: int                    # kernel launches in it (not copies or fills)
    kernels: Dict[str, Tuple[int, float]] = field(default_factory=dict)  # device op: (count, s)
    idle: Dict[str, float] = field(default_factory=dict)   # host activity: idle s

    def kernel_time(self, key: str) -> Tuple[int, float]:
        """(launches, seconds) of the kernels whose name holds `key`."""
        n = s = 0
        for name, (c, t) in self.kernels.items():
            if key in name:
                n, s = n + c, s + t
        return n, s

    def summary(self) -> str:
        """Every device operation by time, then every idle gap's host
        activity, as text."""
        lines = [f"{self.iterations} iterations, {self.launches} launches, busy "
                 f"{self.busy_s:.6f} s of {self.window_s:.6f} s"]
        for name, (c, t) in sorted(self.kernels.items(), key=lambda kv: -kv[1][1]):
            lines.append(f"{t:12.6f} s {c:7d}x  {name}")
        lines.append("idle, by what the host was doing where the gap began:")
        for name, t in sorted(self.idle.items(), key=lambda kv: -kv[1]):
            lines.append(f"{t:12.6f} s  {name}")
        return "\n".join(lines) + "\n"

    def breakdown(self, top: int = 10) -> dict:
        groups: Dict[str, float] = {}
        for name, (_, t) in self.kernels.items():
            g = kernel_group(name)
            groups[g] = groups.get(g, 0.0) + t
        ops = sorted(groups.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _top_level(events: List[Tuple[int, int, str]]) -> List[Tuple[int, int, str]]:
    """The events that no other one of the list contains."""
    out: List[Tuple[int, int, str]] = []
    for a, b, n in sorted(events):
        if not out or a >= out[-1][1]:
            out.append((a, b, n))
    return out


def _innermost(spans: List[Tuple[int, int, str]], t: int) -> str | None:
    best = None
    for a, b, n in spans:
        if a <= t < b and (best is None or a >= best[0]):
            best = (a, b, n)
    return None if best is None else best[2]


def _on_device(e) -> bool:
    return "CUDA" in str(e.device_type())


def _interval(e) -> Tuple[int, int]:
    a = e.start_ns()
    return a, a + e.duration_ns()


def read(events, t0_ns: int, t1_ns: int, iterations: int, span_prefix: str) -> Trace:
    """Reduce the profiler's raw events (torch's _KinetoEvent: name,
    device_type, start_ns, duration_ns) between t0_ns and t1_ns.  On the
    device: kernels, copies ("Memcpy ...") and fills ("Memset ..."), less
    the device-side copies of the host's annotations; on the host: the
    annotations named with span_prefix, and every other event as an op."""
    dev: List[Tuple[int, int]] = []
    kernels: Dict[str, Tuple[int, float]] = {}
    ops: List[Tuple[int, int, str]] = []
    spans: List[Tuple[int, int, str]] = []
    launches = 0
    for e in events:
        a, b = _interval(e)
        name = e.name()
        if name.startswith(span_prefix):
            if not _on_device(e):
                spans.append((a, b, name[len(span_prefix):]))
        elif _on_device(e):
            a, b = max(a, t0_ns), min(b, t1_ns)
            if b <= a:
                continue
            dev.append((a, b))
            launches += not name.startswith(("Memcpy", "Memset"))
            c, s = kernels.get(name, (0, 0.0))
            kernels[name] = (c + 1, s + (b - a) * 1e-9)
        elif b > t0_ns and a < t1_ns:
            ops.append((a, b, name))
    busy = _union(dev)
    tops = _top_level(ops)
    starts = [a for a, _, _ in tops]
    idle: Dict[str, float] = {}
    prev = t0_ns
    for a, b in busy + [(t1_ns, t1_ns)]:
        if a > prev:
            t = prev
            k = bisect.bisect_right(starts, t) - 1
            op = tops[k][2] if k >= 0 and tops[k][1] > t else "host outside any op"
            name = f"{_innermost(spans, t) or 'window'}: {op}"
            idle[name] = idle.get(name, 0.0) + (a - prev) * 1e-9
        prev = max(prev, b)
    return Trace(iterations=iterations, window_s=(t1_ns - t0_ns) * 1e-9,
                 busy_s=sum(b - a for a, b in busy) * 1e-9, launches=launches,
                 kernels=kernels, idle=idle)


def profile_iterations(step: Callable[[], object], iterations: int, span_prefix: str) -> Trace:
    """Run `step` `iterations` times under torch.profiler (host and device)
    and read the trace of that window."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(span_prefix + "window"):
            for _ in range(iterations):
                step()
            torch.cuda.synchronize()
    t_read = time.perf_counter()
    events = list(prof.profiler.kineto_results.events())
    window = [e for e in events if e.name() == span_prefix + "window" and not _on_device(e)]
    if not window:
        raise RuntimeError("the profiler recorded no window annotation")
    t0, t1 = _interval(window[0])
    tr = read(events, t0, t1, iterations, span_prefix)
    tr.read_s = time.perf_counter() - t_read
    return tr
