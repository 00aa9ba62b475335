"""B3's share of its roofline: the sum of the bounds of the profiled
iterations' B3 calls, each at its own shape (roofline/fused_mlp.py, the
stated input widths), over the device time of B3's kernels (its row pass,
which counts the calls, the dW pass and the reductions).  The tower
backward B5 launches the same dW pass and reductions: in a cell that ran
both, this time would hold B5's share too.  Nothing to read without a B3
call, or where the calls are not those the cell's update makes."""
from port_bench.roofline import fused_mlp


def read(r):
    if r.trace is None:
        return None
    n, _ = r.trace.kernel_time(fused_mlp.B3_ROW_PASS)
    calls = [c for c in fused_mlp.mappo_calls(r.config["train"], r.cell["num_envs"])
             if c.kind == "bwd"]
    if n == 0 or n != len(calls) * r.trace.iterations:
        return None
    s = sum(r.trace.kernel_time(k)[1] for k in fused_mlp.B3_KERNELS)
    bound = sum(fused_mlp.bound_s(c)[0] for c in calls) * r.trace.iterations
    return 100.0 * bound / s
