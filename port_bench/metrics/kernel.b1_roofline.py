"""B1's share of its roofline: the least time of one launch at the cell's
E x 10 articulations (roofline/b1.py) over B1's mean device time per
launch in the profiled iterations.  Nothing to read without a B1 launch."""
from port_bench.roofline import b1


def read(r):
    if r.trace is None:
        return None
    n, s = r.trace.kernel_time(b1.KERNEL)
    if n == 0:
        return None
    E = r.cell["num_envs"]
    bound, _ = b1.bound_s(10 * E, E)
    return 100.0 * bound / (s / n)
