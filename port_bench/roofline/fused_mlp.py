"""The bounds of the fused Dense -> ELU -> LayerNorm kernels, B2 (forward)
and B3 (backward), and the calls a MAPPO iteration makes of them.

A call's bound is the least time the card could take for it: each input
read once and each output written once at the memory's rate, or the
products at the bf16 tensor-core rate plus the elementwise work (counted
from the kernels' code: 2 operations per input column, 12 per hidden column
forward, 20 backward) at the float32 rate, whichever is larger.  The input
width is the stated one (46, 388, 512): the kernels pad it to a multiple of
128, and that padding is counted as lost time, not as work.
"""
from __future__ import annotations

from typing import List, NamedTuple

from port_bench import peaks

B2_KERNEL = "dense_fwd_wgmma"
# B3's device kernels: the row pass (one launch a call, so it counts the
# calls), the dW pass with its reduction, the partial sums' reductions.
# A cell that runs the tower backward B5 launches the last four as well.
B3_ROW_PASS = "ln_bwd_rows_wgmma"
B3_KERNELS = (B3_ROW_PASS, "dw_wgmma", "reduce_dw_kernel", "colsum_partial_kernel",
              "colsum_final_kernel")


class Call(NamedTuple):
    kind: str        # "fwd" (B2) or "bwd" (B3)
    N: int           # agents in the call
    B: int           # rows per agent
    Din: int         # stated input width
    H: int           # hidden width
    need_dx: bool    # B3 stores the input's gradient


def bound_s(c: Call):
    """(seconds, "bytes" | "operations") of one call."""
    N, B, Din, H = c.N, c.B, c.Din, c.H
    x_bytes = N * B * Din * 2
    vec_bytes = N * (3 * H + 2 * Din) * 4
    if c.kind == "fwd":
        nbytes = x_bytes + N * Din * H * 2 + vec_bytes + 2 * N * B * H * 2
        mm, ew = 2 * N * B * Din * H, N * B * (2 * Din + 12 * H)
    else:
        nbytes = (2 * N * B * H * 2 + x_bytes + N * Din * H * 2 + N * (H + 2 * Din) * 4
                  + (N * B * Din * 2 if c.need_dx else 0) + N * Din * H * 4 + vec_bytes)
        mm, ew = 4 * N * B * Din * H, N * B * (6 * Din + 20 * H)
    by_bytes = nbytes / peaks.HBM_BYTES_PER_S
    by_ops = mm / peaks.BF16_OPS_PER_S + ew / peaks.FP32_OPS_PER_S
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def mappo_calls(train: dict, num_envs: int, obs_dim: int = 46, share_dim: int = 388,
                num_agents: int = 10) -> List[Call]:
    """B2's and B3's calls in one iteration of the sequential MAPPO update:
    per agent and epoch (one minibatch of every row), the actor's and the
    centralised critic's blocks forward, then backward; the first block's
    input (the observations) takes no gradient."""
    H, blocks = train["hidden_size"], 1 + train["layer_N"]
    B = train["episode_length"] * num_envs // max(1, train["num_mini_batch"])
    steps = num_agents * train["ppo_epoch"] * max(1, train["num_mini_batch"])
    calls = []
    for kind in ("fwd", "bwd"):
        for din0 in (obs_dim, share_dim):
            for k in range(blocks):
                calls.append(Call(kind, 1, B, din0 if k == 0 else H, H, k > 0))
    return calls * steps
