"""Reading a profiler trace of a few window iterations: the device's busy
time as the union of its operations' intervals, kernel time and launches by
name, the device operations by group, the device's idle gaps by what the
host was doing, and device time by the span around the host call that
launched each operation."""
from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Sequence, Tuple, Union

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
    # span name: (launches, device s) of the operations launched inside a span
    # of that name at any depth, and of those whose innermost span it is
    spans: Dict[str, Tuple[int, float]] = field(default_factory=dict)
    self_spans: Dict[str, Tuple[int, float]] = field(default_factory=dict)
    device_s: float = 0.0            # every device operation's time, summed
    unattributed_s: float = 0.0      # of it, operations linked to no host call

    def kernel_time(self, key: str) -> Tuple[int, float]:
        """(launches, seconds) of the kernels whose name holds `key`."""
        n = s = 0
        for name, (c, t) in self.kernels.items():
            if key in name:
                n, s = n + c, s + t
        return n, s

    def span_time(self, name: str) -> Tuple[int, float]:
        """(launches, device seconds) of the operations launched inside a
        span `name`, at any depth."""
        return self.spans.get(name, (0, 0.0))

    def summary(self) -> str:
        """Every device operation by time, device time by span, then every
        idle gap's host activity, as text."""
        lines = [f"{self.iterations} iterations, {self.launches} launches, busy "
                 f"{self.busy_s:.6f} s of {self.window_s:.6f} s"]
        for name, (c, t) in sorted(self.kernels.items(), key=lambda kv: -kv[1][1]):
            lines.append(f"{t:12.6f} s {c:7d}x  {name}")
        share = self.unattributed_s / self.device_s if self.device_s else 0.0
        lines.append(f"device time by the span around the launching host call: "
                     f"{self.device_s:.6f} s of operations, {self.unattributed_s:.6f} s "
                     f"({100 * share:.2f}%) unattributed (linked to no host call)")
        lines.append(f"{'inside, any depth':>28}  {'innermost':>24}")
        for name in sorted(set(self.spans) | set(self.self_spans),
                           key=lambda n: -self.span_time(n)[1]):
            (c, t), (cs, ts) = self.span_time(name), self.self_spans.get(name, (0, 0.0))
            lines.append(f"{t:12.6f} s {c:7d}x  {ts:12.6f} s {cs:7d}x  {name}")
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


class _Spans:
    """Host spans that nest (the harness's and the program's, on the thread
    that drives the trainer): the spans that hold a host time, innermost
    first."""

    def __init__(self, spans: List[Tuple[int, int, str]]):
        self.spans = sorted(spans, key=lambda s: (s[0], -s[1]))   # outer first at a tie
        self.starts = [a for a, _, _ in self.spans]
        self.parent: List[int] = []
        open_: List[int] = []
        for i, (a, _, _) in enumerate(self.spans):
            while open_ and self.spans[open_[-1]][1] <= a:
                open_.pop()
            self.parent.append(open_[-1] if open_ else -1)
            open_.append(i)

    def holding(self, t: int) -> List[str]:
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.spans[i][1] <= t:
            i = self.parent[i]
        out = []
        while i >= 0:
            out.append(self.spans[i][2])
            i = self.parent[i]
        return out


def _on_device(e) -> bool:
    return "CUDA" in str(e.device_type())


def _runtime_call(name: str) -> bool:
    """A CUDA runtime or driver call on the host (cudaLaunchKernel,
    cudaGraphLaunch, cudaMemcpyAsync, cuLaunchKernel...): torch 2.11's events
    carry no activity type, and its ops are named aten::, autograd::..."""
    return name.startswith("cu")


def _interval(e) -> Tuple[int, int]:
    a = e.start_ns()
    return a, a + e.duration_ns()


Prefixes = Union[str, Sequence[str]]


def _prefixes(span_prefix: Prefixes) -> Tuple[str, ...]:
    return (span_prefix,) if isinstance(span_prefix, str) else tuple(span_prefix)


def read(events, t0_ns: int, t1_ns: int, iterations: int, span_prefix: Prefixes) -> Trace:
    """Reduce the profiler's raw events (torch's _KinetoEvent: name,
    device_type, start_ns, duration_ns, correlation_id,
    linked_correlation_id) between t0_ns and t1_ns.  On the device: kernels,
    copies ("Memcpy ...") and fills ("Memset ..."), less the device-side
    copies of the host's annotations; on the host: the annotations named
    with a span prefix (one, or a sequence: the harness's and the
    program's) as spans under their names less the prefix, and every other
    event as an op.

    Each device operation is put in the spans around the host call that
    launched it: the CUDA runtime or driver call of the same correlation id
    (a CUDA graph's kernel nodes carry their cudaGraphLaunch's), or else the
    op that the profiler links it to.  An operation with neither is
    unattributed; none is placed by when it ran."""
    prefixes = _prefixes(span_prefix)
    dev: List[Tuple[int, int]] = []
    dev_ops: List[Tuple[float, bool, int, int]] = []   # s, a launch?, correlation, link
    kernels: Dict[str, Tuple[int, float]] = {}
    ops: List[Tuple[int, int, str]] = []
    spans: List[Tuple[int, int, str]] = []
    calls: Dict[int, int] = {}       # runtime call's correlation id: its host start
    op_at: Dict[int, int] = {}       # host op's correlation id: its host start
    launches = 0
    for e in events:
        a, b = _interval(e)
        name = e.name()
        prefix = next((p for p in prefixes if name.startswith(p)), None)
        if _on_device(e):
            if prefix is not None:
                continue
            a, b = max(a, t0_ns), min(b, t1_ns)
            if b <= a:
                continue
            dev.append((a, b))
            launch = not name.startswith(("Memcpy", "Memset"))
            launches += launch
            c, s = kernels.get(name, (0, 0.0))
            kernels[name] = (c + 1, s + (b - a) * 1e-9)
            dev_ops.append(((b - a) * 1e-9, launch, e.correlation_id(),
                            e.linked_correlation_id()))
            continue
        if _runtime_call(name):
            calls[e.correlation_id()] = a
        else:
            op_at[e.correlation_id()] = a
        if prefix is not None:
            spans.append((a, b, name[len(prefix):]))
        elif b > t0_ns and a < t1_ns:
            ops.append((a, b, name))
    nest = _Spans(spans)
    by_span: Dict[str, Tuple[int, float]] = {}
    by_self: Dict[str, Tuple[int, float]] = {}
    device_s = unattributed_s = 0.0
    for s, launch, corr, link in dev_ops:
        device_s += s
        t = calls.get(corr)
        if t is None and link:
            t = op_at.get(link)
        if t is None:
            unattributed_s += s
            continue
        held = nest.holding(t)
        for table, names in ((by_span, set(held)), (by_self, held[:1])):
            for n in names:
                c, x = table.get(n, (0, 0.0))
                table[n] = (c + launch, x + s)
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
            held = nest.holding(t)
            name = f"{held[0] if held else 'window'}: {op}"
            idle[name] = idle.get(name, 0.0) + (a - prev) * 1e-9
        prev = max(prev, b)
    return Trace(iterations=iterations, window_s=(t1_ns - t0_ns) * 1e-9,
                 busy_s=sum(b - a for a, b in busy) * 1e-9, launches=launches,
                 kernels=kernels, idle=idle, spans=by_span, self_spans=by_self,
                 device_s=device_s, unattributed_s=unattributed_s)


def profile_iterations(step: Callable[[], object], iterations: int,
                       span_prefix: Prefixes) -> Trace:
    """Run `step` `iterations` times under torch.profiler (host and device)
    and read the trace of that window, which is annotated with the first
    span prefix."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    mark = _prefixes(span_prefix)[0] + "window"
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(mark):
            for _ in range(iterations):
                step()
            torch.cuda.synchronize()
    t_read = time.perf_counter()
    events = list(prof.profiler.kineto_results.events())
    window = [e for e in events if e.name() == mark and not _on_device(e)]
    if not window:
        raise RuntimeError("the profiler recorded no window annotation")
    t0, t1 = _interval(window[0])
    tr = read(events, t0, t1, iterations, span_prefix)
    tr.read_s = time.perf_counter() - t_read
    return tr
