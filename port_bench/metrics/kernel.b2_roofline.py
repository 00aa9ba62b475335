"""B2's share of its roofline: the sum of the bounds of the profiled
iterations' B2 calls, each at its own shape (roofline/fused_mlp.py, the
stated input widths), over the device time of B2's kernel.  Nothing to read
without a B2 launch, or where the launches are not the calls the cell's
update makes."""
from port_bench.roofline import fused_mlp


def read(r):
    if r.trace is None:
        return None
    n, s = r.trace.kernel_time(fused_mlp.B2_KERNEL)
    calls = [c for c in fused_mlp.mappo_calls(r.config["train"], r.cell["num_envs"])
             if c.kind == "fwd"]
    if n == 0 or n != len(calls) * r.trace.iterations:
        return None
    bound = sum(fused_mlp.bound_s(c)[0] for c in calls) * r.trace.iterations
    return 100.0 * bound / s
