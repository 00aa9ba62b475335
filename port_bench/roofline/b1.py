"""The roofline of B1, the substep kernel (ops/csrc/substep.cu,
`substep_kernel`): one launch steps B articulations of E envs by one
physics substep.

Operations are counted on the plain scalar substep (reference/phys/
scalar_phys.py), which is branch-free, so every articulation needs the same
count; the count is frozen here and a test counts it again.  Bytes: the
state, torques and box state read once, the table once, the outputs
(qpos', qvel', box wrench, four foot sensors) written once.  Peaks: the
H100 SXM's float32 rate outside the tensor cores and its HBM bandwidth.
"""
from __future__ import annotations

from port_bench import peaks

KERNEL = "substep_kernel"
OPS_PER_ARTICULATION = 30391      # elementwise operations, counted by count_ops_per_articulation
TABLE_FLOATS = 656                 # the baked table's length for the ant's contact points
OUT_FLOATS = 15 + 14 + 6 + 24      # qpos', qvel', wrench, sensors per articulation

# what counts as one operation of the plain version (aten names)
ARITH_OPS = {"add", "sub", "rsub", "mul", "div", "reciprocal", "neg", "sqrt", "sin", "cos",
             "abs", "sign", "clamp", "clamp_min", "clamp_max", "maximum", "minimum", "where",
             "gt", "lt", "ge", "le", "eq", "ne", "logical_and", "logical_or", "logical_not",
             "bitwise_and", "bitwise_or", "bitwise_not", "_to_copy"}


def bound_s(n_art: int, n_envs: int):
    """(least seconds of one launch, "operations" | "bytes") over n_art
    articulations of n_envs envs."""
    nbytes = 4 * (n_art * (15 + 14 + 8) + n_envs * (7 + 6) + TABLE_FLOATS + n_art * OUT_FLOATS)
    by_bytes = nbytes / peaks.HBM_BYTES_PER_S
    by_ops = OPS_PER_ARTICULATION * n_art / peaks.FP32_OPS_PER_S
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def count_ops_per_articulation():
    """(operations per articulation, table length) of the plain substep,
    counted on the CPU over one TenAnt env's ten ants at their reset pose."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from port_bench.reference.phys import scalar_phys as sp
    from port_bench.reference.tenant import A, TenAnt

    env = TenAnt({"episodeLength": 1000, "dofVelocityScale": 0.2, "powerScale": 1.0,
                  "upWeight": 0.1, "actionsCost": 0.005, "energyCost": 0.05,
                  "jointsAtLimitCost": 0.1, "deathCost": -2.0, "terminationHeight": 0.31,
                  "plane": {"staticFriction": 1.0}},
                 {"dt": 0.0166, "substeps": 3, "friction_combine": "average",
                  "contact": {"stiffness": 2500.0, "damping": 25.0, "friction_vel": 0.3}}, "cpu")
    s = env.reset(torch.Generator().manual_seed(0), 1)
    qpos = list(s.aq.reshape(A, sp.NQ).t())
    qvel = list(s.av.reshape(A, sp.NV).t())
    tau = list(torch.zeros(sp.NJ, A))
    bq = list(s.bq.t().repeat_interleave(A, dim=1))
    bv = list(s.bv.t().repeat_interleave(A, dim=1))
    n = [0]

    class Counter(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket.__name__ in ARITH_OPS and isinstance(out, torch.Tensor):
                n[0] += out.numel()
            return out

    with Counter():
        sp.substep(env.consts, qpos, qvel, tau, bq, bv)
    return n[0] / A, env.consts.table.numel()
