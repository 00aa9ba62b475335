"""The whole iteration's share of the chip's peak: the least time of its
counted work (the policy and value matmuls at the peak of the precision
each runs in, bf16 hidden layers on the tensor cores and float32 heads,
plus B1's operations at the float32 rate) over the window's mean iteration
time.  Recomputed or unneeded work does not count."""
import statistics

from port_bench import peaks


def read(r):
    if not r.iter_s:
        return None
    w = r.work
    least = (w["bf16_flop"] / peaks.BF16_OPS_PER_S
             + (w["fp32_flop"] + w["b1_ops"]) / peaks.FP32_OPS_PER_S)
    return 100.0 * least / statistics.fmean(r.iter_s)
