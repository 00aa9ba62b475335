"""Smoke test of the PyTorch/CUDA port (massive_marl_tpu_torch) on one GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:
  1. the card's name and power limit (nvidia-smi) and torch's device name;
  2. build the kernels from massive_marl_tpu_torch/ops/csrc/ (substep.cu:
     B1; fused_mlp.cu: B2/B3; fused_tower.cu: B4/B5), one nvcc per source,
     started together; print the build seconds and ptxas' register and
     spill report;
  3. hold B1 against its plain PyTorch version at E=4096 envs x 10 ants
     over four state families (feet on the ground, points inside and just
     outside the push-box, hinges beyond their limits, no box); print the
     errors per output, the kernel's time (CUDA events, median of 30
     launches) beside its bound and the plain version's time;
  4. hold B2/B3 against their plain versions at the MARL update's three
     layer shapes (actor layer 0 128->512, hidden 512->512, critic layer 0
     512->512 with the share obs read by every agent), B = 32,768 rows, for
     the stacked schedule's N = 10 agents and the sequential schedule's
     N = 1: every output, with tolerances; each kernel's time beside its
     bound and its plain version's time, and a bf16 torch.bmm of the same
     product alone as a note;
  4b. hold B4/B5 against their plain versions at the update's two tower
     shapes (actor: Din 128 -> 512, critic: Din 512 with the share obs read
     by every agent; 3 layers), N = 1 and N = 10, B = 32,768, dx both ways;
     B5 twice for the same bits; each kernel's time beside its bound and
     its plain version's, and three chained B2 (B3) launches as a note;
  5. TenAnt + PPO at full width (E=4096, hidden 1024-1024-512, nsteps 8,
     5 epochs x 4 minibatches): 1 warm-up iteration through PPO.run and 3
     timed iterations through PPO.rollout_phase / update_phase;
     env-steps/s, rollout ms, update ms; finite losses and observations;
     exactly 24 B1 launches (8 steps x 3 substeps) per iteration, counted
     from 0 just before this phase;
  6. TenAnt + MAPPO at full width (MarlConfig(): N=10, hidden 512, 3 fused
     blocks per tower, episode_length 8, 5 epochs, E=4096, the sequential
     schedule): 1 warm-up iteration through MarlRunner.run and 3 timed
     iterations through rollout_phase / update_phase; env-steps/s, rollout
     ms, update ms, peak memory; finite metrics; exactly 24 B1, 300 B2 and
     300 B3 launches per iteration, counted from 0 just before this phase;
     then one iteration of the stacked schedule (30 B2, 30 B3) and one of
     HAPPO (360 B2, 300 B3), checked the same way; then MAPPO with
     FUSED_TOWER=1 (1 warm-up iteration through MarlRunner.run, 1 timed:
     24 B1, 100 B4, 100 B5, no B2/B3 per iteration); HATRPO
     (MarlConfig.from_cfg_train({}, "hatrpo"), 1 warm-up iteration through
     MarlRunner.run, 2 timed) with B2/B3 launches exactly as its conjugate
     gradients and line searches ran them, inside the range the code
     allows; and one HATRPO iteration with FUSED_TOWER=1 (30 B2 from the
     linearizations, no B3, B4/B5 as counted);
  7. one PPO, one MAPPO, one HATRPO and one MAPPO FUSED_TOWER=1 iteration
     under torch.profiler: device time by kernel group, the device's busy
     share (full lists in build/), and for PPO a host-clock breakdown of one
     rollout step into its parts.
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time

E, A = 4096, 10                 # the benchmark's env count; ants per TenAnt env
KERNEL_REPS, PLAIN_REPS = 30, 5
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
FP32_OPS_PER_S = 67e12          # H100 SXM FP32 outside the tensor cores
BF16_OPS_PER_S = 989e12         # H100 SXM dense bf16 tensor cores
MLP_B = 8 * 4096                # episode_length x E rows per agent in the MARL update
MLP_SHAPES = (("actor layer 0", 128, 512, False), ("hidden", 512, 512, False),
              ("critic layer 0", 512, 512, True))   # (name, Din, H, share obs)
MLP_OUTPUTS = ("dx", "dw", "db", "dgamma", "dbeta", "dg0", "db0")
TOWER_SHAPES = (("actor tower", 128, False), ("critic tower", 512, True))  # (name, Din, share obs)
TOWER_H, TOWER_L = 512, 3
# B4/B5 against their plain versions, of the output's scale (y: one bf16 ulp
# plus this): each layer's one-ulp flips feed the layers after it and,
# through B5's f32 cotangent, the layers below; the plain version alone with
# float64 products on the CPU moves y by 1.1e-3 beyond one ulp, dx by 4.7e-3
# and the sums by 1.0e-3 of their scale (tests/test_torch_fused_tower.py)
TOWER_TOL = {"y": 3e-3, "dx": 1e-2, "sum": 3e-3}
TOL = {"qpos": (2e-4, 2e-4), "qvel": (5e-3, 5e-3), "wrench": (5e-3, 5e-2),
       "sensors": (5e-3, 5e-2)}
# elementwise arithmetic and comparison ops counted as operations when the
# plain version runs under the op counter
ARITH_OPS = {"add", "sub", "rsub", "mul", "div", "reciprocal", "neg", "sqrt", "sin", "cos",
             "abs", "sign", "clamp", "clamp_min", "clamp_max", "maximum", "minimum", "where",
             "gt", "lt", "ge", "le", "eq", "ne", "logical_and", "logical_or", "logical_not",
             "bitwise_and", "bitwise_or", "bitwise_not", "_to_copy"}


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def make_states(env, n_env, seed, device):
    """[field, B] operands over three state families, one per env by index:
    feet in ground contact, ants in and around the push-box, hinges beyond
    their limits."""
    import torch
    g = torch.Generator().manual_seed(seed)
    s = env.reset(n_env).pipeline
    qpos = s.ant_qpos.cpu().clone()
    qvel = torch.randn(n_env, A, 14, generator=g) * 0.5
    box = s.box_qpos.cpu().clone()
    qpos[..., 2] = 0.45 + 0.2 * torch.rand(n_env, A, generator=g)
    lo = env.spec.ant_sys.jnt_range[:, 0].cpu()
    hi = env.spec.ant_sys.jnt_range[:, 1].cpu()
    fam = torch.arange(n_env) % 3
    nbox = int((fam == 1).sum())
    yaw = 0.4 * torch.rand(nbox, generator=g) - 0.2
    box[fam == 1] = torch.stack([torch.full((nbox,), 0.8), torch.zeros(nbox),
                                 torch.full((nbox,), 0.45), torch.zeros(nbox), torch.zeros(nbox),
                                 torch.sin(yaw / 2), torch.cos(yaw / 2)], 1)
    qpos[fam == 1, :, 0:3] = torch.tensor([0.5, -0.3, 0.55]) + 0.3 * torch.randn(
        nbox, A, 3, generator=g)
    beyond = 0.02 + 0.18 * torch.rand(n_env, A, 8, generator=g)
    past = torch.where(torch.rand(n_env, A, 8, generator=g) < 0.5, lo - beyond, hi + beyond)
    qpos[fam == 2, :, 7:] = past[fam == 2]
    tau = (torch.rand(n_env, A, 8, generator=g) * 2 - 1) * 15
    bvel = torch.randn(n_env, 6, generator=g) * 0.2
    B = n_env * A
    t = lambda x, n: x.reshape(B, n).t().contiguous().to(device)
    return (t(qpos, 15), t(qvel, 14), t(tau, 8), box.t().contiguous().to(device),
            bvel.t().contiguous().to(device))


def ops_per_articulation(fs, c, env) -> float:
    """Operations of one substep per articulation, counted from the plain
    version (branch-free, so every input needs the same count) on the CPU."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Counter(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket.__name__ in ARITH_OPS and isinstance(out, torch.Tensor):
                Counter.n += out.numel()
            return out

    ops = make_states(env, 1, 0, "cpu")
    with Counter():
        fs.substep_plain(c, A, *ops)
    return Counter.n / A


def time_cuda_ms(fn, reps, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_kernel(fs, c, ops, label):
    """Kernel vs plain version on the same operands; returns the worst
    absolute error and raises on any tolerance break."""
    import torch
    got = fs.substep_kernel(c.device_table(ops[0].device), c.P, A, *ops)
    torch.cuda.synchronize()
    ref = fs.substep_plain(c, A, *ops)
    torch.cuda.synchronize()
    worst = 0.0
    for name, g, r in zip(TOL, got, ref):
        if name == "wrench" and not c.has_box:
            continue
        rtol, atol = TOL[name]
        if not torch.isfinite(g).all():
            raise AssertionError(f"{label}: kernel {name} has non-finite values")
        err = (g - r).abs()
        rel = (err / r.abs().clamp(min=1e-6)).max().item()
        bad = int((err > atol + rtol * r.abs()).sum())
        print(f"  {label:6s} {name:8s} max|ref| {r.abs().max().item():.6g}  "
              f"max abs err {err.max().item():.3e}  max rel err {rel:.3e}  "
              f"breaks {bad} (rtol {rtol}, atol {atol})")
        if bad:
            raise AssertionError(f"{label}: kernel {name} disagrees with the plain version")
        worst = max(worst, err.max().item())
    return worst


def mlp_operands(N, Din, H, layer0, shared, gen, dev):
    """Operands of one fused block at the MARL update's shapes.  Layer 0
    reads feature_norm'd observations (obs 46 or share obs 388, padded) with
    the feature LayerNorm's affine; a hidden layer reads a bf16 LayerNorm
    output with ones/zeros.  Weights at the orthogonal init's scale."""
    import torch
    from massive_marl_tpu_torch.ops import fused_mlp as fm
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    rows = 1 if shared else N
    if layer0:
        x = fm.feature_norm(r(rows, MLP_B, 388 if shared else 46))
        g0, b0 = 1 + 0.1 * r(N, Din), 0.1 * r(N, Din)
    else:
        x = r(rows, MLP_B, Din).to(torch.bfloat16)
        g0, b0 = torch.ones(N, Din, device=dev), torch.zeros(N, Din, device=dev)
    if shared:
        x = x.expand(N, MLP_B, Din)
    w16 = (r(N, Din, H) * (2.0 / Din) ** 0.5).to(torch.bfloat16)
    return dict(x=x, w16=w16, b=0.1 * r(N, H), g=1 + 0.1 * r(N, H), be=0.1 * r(N, H),
                g0=g0, b0=b0, dy=r(N, MLP_B, H).to(torch.bfloat16))


def mlp_fwd(fm, d, plain=False):
    f = fm.fwd_plain if plain else fm.fwd_kernel
    return f(d["x"], d["w16"], d["b"], d["g"], d["be"], d["g0"], d["b0"])


def mlp_bwd(fm, d, a, plain=False):
    f = fm.bwd_plain if plain else fm.bwd_kernel
    return f(d["dy"], a, d["x"], d["w16"], d["g"], d["g0"], d["b0"])


def mlp_bound(kind, N, Din, H, shared):
    """(bound ms, "bytes" | "operations", bytes, tensor-core flops) of B2
    ("fwd") or B3 ("bwd") on [N, MLP_B] rows: each input read once, each
    output written once; the products at the bf16 tensor-core rate plus the
    elementwise work (counted from the kernels' code: 2 ops per input
    column, 12 per hidden column forward, 20 backward) at the FP32 rate."""
    B = MLP_B
    x_bytes = (1 if shared else N) * B * Din * 2
    vec_bytes = N * (3 * H + 2 * Din) * 4
    if kind == "fwd":
        nbytes = x_bytes + N * Din * H * 2 + vec_bytes + 2 * N * B * H * 2
        mm, ew = 2 * N * B * Din * H, N * B * (2 * Din + 12 * H)
    else:
        nbytes = (2 * N * B * H * 2 + x_bytes + N * Din * H * 2 + N * (H + 2 * Din) * 4
                  + N * B * Din * 2 + N * Din * H * 4 + vec_bytes)
        mm, ew = 4 * N * B * Din * H, N * B * (6 * Din + 20 * H)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = (mm / BF16_OPS_PER_S + ew / FP32_OPS_PER_S) * 1e3
    return (ops_ms, "operations", nbytes, mm) if ops_ms >= bytes_ms else \
        (bytes_ms, "bytes", nbytes, mm)


def check_mlp(fm, d, label):
    """B2 and B3 against their plain versions on the same operands (B3 on
    the plain version's residual a); returns the worst absolute error of
    each ({"fwd": ..., "bwd": ...}) and raises on any tolerance break.
    bf16 outputs: within one bf16 ulp (relative 2^-7) plus 1e-3 of their
    scale (the product's f32 summation order flips a few roundings); f32
    sums: 1e-3 relative plus 1e-4 of their scale (summation order over
    32,768 rows, and for dW, dg0, db0 the one-ulp flips of dh16)."""
    import torch
    y, a = mlp_fwd(fm, d)
    torch.cuda.synchronize()
    yp, ap = mlp_fwd(fm, d, plain=True)
    got = mlp_bwd(fm, d, ap)
    torch.cuda.synchronize()
    ref = mlp_bwd(fm, d, ap, plain=True)
    worst = {"fwd": 0.0, "bwd": 0.0}
    for name, g, r in zip(("y", "a") + MLP_OUTPUTS, (y, a) + tuple(got), (yp, ap) + tuple(ref)):
        g, r = g.float(), r.float()
        if not torch.isfinite(g).all():
            raise AssertionError(f"{label}: kernel {name} has non-finite values")
        scale = r.abs().max().item()
        rtol, atol = (2.0 ** -7, 1e-3 * scale) if name in ("y", "a", "dx") else \
            (1e-3, 1e-4 * scale)
        err = (g - r).abs()
        bad = int((err > atol + rtol * r.abs()).sum())
        print(f"  {label:22s} {name:6s} max|ref| {scale:.6g}  max abs err "
              f"{err.max().item():.3e}  differ {(err > 0).float().mean().item():.2e}  "
              f"breaks {bad} (rtol {rtol:.4g}, atol {atol:.3g})")
        if bad:
            raise AssertionError(f"{label}: kernel {name} disagrees with the plain version")
        kind = "fwd" if name in ("y", "a") else "bwd"
        worst[kind] = max(worst[kind], err.max().item())
    return worst


def mlp_phase(fm, dev):
    """Phase 4: B2/B3 against their plain versions at the three layer
    shapes for N = 10 and N = 1, and their times.  Returns the worst errors
    and the times of the sequential schedule's hidden layer (N = 1)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(2)
    worst = {"fwd": 0.0, "bwd": 0.0}
    main = {}
    for N in (10, 1):
        for name, din, h, shared in MLP_SHAPES:
            label = f"{name} {din}->{h} N={N}"
            d = mlp_operands(N, din, h, name != "hidden", shared, gen, dev)
            err = check_mlp(fm, d, label)
            worst = {k: max(worst[k], err[k]) for k in worst}
            _, a = mlp_fwd(fm, d)
            row = {
                "fwd": time_cuda_ms(lambda: mlp_fwd(fm, d), 20),
                "bwd": time_cuda_ms(lambda: mlp_bwd(fm, d, a), 20),
                "fwd_plain": time_cuda_ms(lambda: mlp_fwd(fm, d, True), PLAIN_REPS, warmup=1),
                "bwd_plain": time_cuda_ms(lambda: mlp_bwd(fm, d, a, True), PLAIN_REPS, warmup=1),
                "bmm": time_cuda_ms(lambda: torch.bmm(d["x"], d["w16"]), 20),
            }
            for kind in ("fwd", "bwd"):
                row[kind + "_bound"], row[kind + "_by"], nbytes, mm = \
                    mlp_bound(kind, N, din, h, shared)
                print(f"  {label:22s} {'B2' if kind == 'fwd' else 'B3'} "
                      f"{row[kind]:.4f} ms (median of 20), bound {row[kind + '_bound']:.4f} ms "
                      f"by {row[kind + '_by']} ({nbytes / 1e6:.1f} MB, {mm / 1e9:.2f} GFLOP "
                      f"on tensor cores), plain {row[kind + '_plain']:.3f} ms")
            print(f"  {label:22s} note: bf16 torch.bmm of the product alone {row['bmm']:.4f} ms")
            if N == 1 and name == "hidden":
                main = row
            del d, a
            torch.cuda.empty_cache()
    return worst, main


def tower_operands(N, Din, shared, gen, dev):
    """Operands of a whole tower at the MARL update's shapes: x the
    feature_norm'd obs (46, padded to 128) or share obs (388, padded to 512,
    stride 0 over agents), the feature LayerNorm's affine, 3 layers of
    width 512 at the orthogonal init's scale."""
    import torch
    from massive_marl_tpu_torch.ops import fused_mlp as fm
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    x = fm.feature_norm(r(1 if shared else N, MLP_B, 388 if shared else 46))
    if shared:
        x = x.expand(N, MLP_B, Din)
    H, L = TOWER_H, TOWER_L
    ws16 = [(r(N, Din if li == 0 else H, H) * (2.0 / (Din if li == 0 else H)) ** 0.5)
            .to(torch.bfloat16) for li in range(L)]
    return dict(x=x, g0=1 + 0.1 * r(N, Din), b0=0.1 * r(N, Din), ws16=ws16,
                bs=[0.1 * r(N, H) for _ in range(L)], gs=[1 + 0.1 * r(N, H) for _ in range(L)],
                bes=[0.1 * r(N, H) for _ in range(L)], dy=r(N, MLP_B, H).to(torch.bfloat16))


def tower_args(d):
    return d["x"], d["g0"], d["b0"], d["ws16"], d["bs"], d["gs"], d["bes"]


def tower_bound(kind, N, Din, shared, need_dx=False):
    """(bound ms, "bytes" | "operations", bytes, tensor-core flops) of B4
    ("fwd") or B5 ("bwd") on [N, MLP_B] rows: each input read once, each
    output written once (B4 reads x and the weights and writes y; B5 reads
    dy too and writes dx if asked and every gradient); the products (B5:
    the forward it must recompute, since no activation is an input, and
    the dW and dx products) at the bf16 tensor-core rate plus the
    elementwise work (as mlp_bound, per layer) at the FP32 rate."""
    B, H, L = MLP_B, TOWER_H, TOWER_L
    x_bytes = (1 if shared else N) * B * Din * 2
    w_elems = N * (Din * H + (L - 1) * H * H)
    vec_bytes = N * (2 * Din + 3 * L * H) * 4
    fwd_mm = 2 * N * B * H * (Din + (L - 1) * H)
    if kind == "fwd":
        nbytes = x_bytes + w_elems * 2 + vec_bytes + N * B * H * 2
        mm, ew = fwd_mm, N * B * (2 * Din + 12 * H * L)
    else:
        nbytes = (N * B * H * 2 + x_bytes + w_elems * 2 + vec_bytes
                  + (N * B * Din * 2 if need_dx else 0) + w_elems * 4 + vec_bytes)
        mm, ew = 3 * fwd_mm, N * B * (8 * Din + 32 * H * L)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = (mm / BF16_OPS_PER_S + ew / FP32_OPS_PER_S) * 1e3
    return (ops_ms, "operations", nbytes, mm) if ops_ms >= bytes_ms else \
        (bytes_ms, "bytes", nbytes, mm)


def check_tower(fm, d, label):
    """B4 and B5 (dx both ways) against their plain versions on the same
    operands; B5 run twice for the same bits.  Returns the worst absolute
    error of each ({"fwd": ..., "bwd": ...}) and raises on any break, at
    TOWER_TOL of the output's scale (y: plus one bf16 ulp)."""
    import torch
    args = tower_args(d)
    y = fm.tower_fwd_kernel(*args)
    out = fm.tower_bwd_kernel(d["dy"], *args, need_dx=True)
    again = fm.tower_bwd_kernel(d["dy"], *args, need_dx=False)
    torch.cuda.synchronize()
    yp = fm.tower_fwd_plain(*args)
    ref = fm.tower_bwd_plain(d["dy"], *args, need_dx=True)
    flat = lambda o: [("dx", o[0])] + [
        (f"{k}[{li}]", t) for k, ts in zip(("dw", "db", "dgamma", "dbeta"), o[1:5])
        for li, t in enumerate(ts)] + [("dg0", o[5]), ("db0", o[6])]
    worst = {"fwd": 0.0, "bwd": 0.0}
    for (name, g), (_, r) in zip([("y", y)] + flat(out), [("y", yp)] + flat(ref)):
        g, r = g.float(), r.float()
        if not torch.isfinite(g).all():
            raise AssertionError(f"{label}: kernel {name} has non-finite values")
        scale = r.abs().max().item()
        rtol = 2.0 ** -7 if name == "y" else 0.0
        atol = TOWER_TOL[name if name in ("y", "dx") else "sum"] * scale
        err = (g - r).abs()
        bad = int((err > atol + rtol * r.abs()).sum())
        print(f"  {label:22s} {name:10s} max|ref| {scale:.6g}  max abs err "
              f"{err.max().item():.3e} ({err.max().item() / max(scale, 1e-30):.2e} of scale)  "
              f"breaks {bad} (rtol {rtol:.4g}, atol {atol:.3g})")
        if bad:
            raise AssertionError(f"{label}: kernel {name} disagrees with the plain version")
        kind = "fwd" if name == "y" else "bwd"
        worst[kind] = max(worst[kind], err.max().item())
    if again[0] is not None or not all(torch.equal(a, b) for (_, a), (_, b) in
                                       zip(flat(again)[1:], flat(out)[1:])):
        raise AssertionError(f"{label}: B5 gave other bits on a second run")
    print(f"  {label:22s} B5 again with need_dx False: the same bits")
    return worst


def tower_phase(fm, dev):
    """Phase 4b: B4/B5 against their plain versions at the two tower shapes
    for N = 1 and N = 10, and their times.  Returns the worst errors and the
    times of the sequential schedule's critic tower (N = 1, need_dx False),
    the largest tower of the main path."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(3)
    worst = {"fwd": 0.0, "bwd": 0.0}
    main = {}
    for N in (1, 10):
        for name, din, shared in TOWER_SHAPES:
            label = f"{name} {din}->{TOWER_H}x{TOWER_L} N={N}"
            d = tower_operands(N, din, shared, gen, dev)
            err = check_tower(fm, d, label)
            worst = {k: max(worst[k], err[k]) for k in worst}
            args = tower_args(d)
            ones = torch.ones(N, TOWER_H, device=dev)
            zeros = torch.zeros(N, TOWER_H, device=dev)
            aff = lambda li: (d["g0"], d["b0"]) if li == 0 else (ones, zeros)

            def chain_fwd():
                h, acts = d["x"], []
                for li in range(TOWER_L):
                    h, a = fm.fwd_kernel(h, d["ws16"][li], d["bs"][li], d["gs"][li],
                                         d["bes"][li], *aff(li))
                    acts.append((h, a))
                return acts
            acts = chain_fwd()
            ins = [d["x"]] + [h for h, _ in acts[:-1]]

            def chain_bwd():
                for li in reversed(range(TOWER_L)):
                    fm.bwd_kernel(d["dy"], acts[li][1], ins[li], d["ws16"][li], d["gs"][li],
                                  *aff(li), need_dx=li > 0)
            row = {
                "fwd": time_cuda_ms(lambda: fm.tower_fwd_kernel(*args), 20),
                "bwd": time_cuda_ms(lambda: fm.tower_bwd_kernel(d["dy"], *args), 20),
                "fwd_plain": time_cuda_ms(lambda: fm.tower_fwd_plain(*args), PLAIN_REPS,
                                          warmup=1),
                "bwd_plain": time_cuda_ms(lambda: fm.tower_bwd_plain(d["dy"], *args),
                                          PLAIN_REPS, warmup=1),
                "chain_fwd": time_cuda_ms(chain_fwd, 20),
                "chain_bwd": time_cuda_ms(chain_bwd, 20),
            }
            for kind in ("fwd", "bwd"):
                row[kind + "_bound"], row[kind + "_by"], nbytes, mm = \
                    tower_bound(kind, N, din, shared)
                print(f"  {label:22s} {'B4' if kind == 'fwd' else 'B5'} "
                      f"{row[kind]:.4f} ms (median of 20), bound {row[kind + '_bound']:.4f} ms "
                      f"by {row[kind + '_by']} ({nbytes / 1e6:.1f} MB, {mm / 1e9:.2f} GFLOP "
                      f"on tensor cores), plain {row[kind + '_plain']:.3f} ms")
            print(f"  {label:22s} note: three chained B2 {row['chain_fwd']:.4f} ms, "
                  f"three chained B3 {row['chain_bwd']:.4f} ms (no one PyTorch call computes "
                  f"the tower)")
            if N == 1 and name == "critic tower":
                main = row
            del d, acts, ins
            torch.cuda.empty_cache()
    return worst, main


def timed_iteration(trainer):
    """One training iteration (PPO or MARL) on the host clock around
    synchronised work: (metrics as floats, rollout s, update s)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    traj = trainer.rollout_phase()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    m = trainer.update_phase(traj, trainer.state.env_state.obs)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return {k: float(v) for k, v in m.items()}, t1 - t0, t2 - t1


# device kernels grouped by what issues them (names as the profiler reports them)
# (first match wins: the tower's names contain B2's and B3's)
KERNEL_GROUPS = (("B1 substep kernel", ("substep_kernel",)),
                 ("B4 mlp_tower fwd", ("tower_fwd_kernel",)),
                 ("B5 mlp_tower bwd (row pass, sums)", ("tower_bwd_rows_kernel",
                                                        "tower_reduce_vec_kernel")),
                 ("B2 dense_elu_ln fwd", ("fwd_kernel",)),
                 ("B3 dense_elu_ln bwd (row pass, sums)", ("bwd_rows_kernel",
                                                           "reduce_vec_kernel")),
                 ("B3/B5 dW pass", ("bwd_dw_kernel", "reduce_dw_kernel")),
                 ("GEMM", ("gemm", "nvjet", "cutlass", "gemv")),
                 ("optimizer (foreach)", ("multi_tensor_apply",)),
                 ("reductions", ("reduce_kernel",)),
                 ("ELU fwd/bwd", ("elu",)),
                 ("copies and cat", ("Cat", "copy", "Memcpy")),
                 ("other elementwise", ("elementwise", "cross_kernel", "index")))


def profile_iteration(trainer, path, label):
    """One training iteration under torch.profiler: device time by kernel
    group and name and the device's busy share; the full list goes to path."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, roll_s, upd_s = timed_iteration(trainer)
    by_name, n_kernels = {}, 0
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3
            n_kernels += 1
    groups = {}
    for name, ms in by_name.items():
        g = next((g for g, keys in KERNEL_GROUPS if any(k in name for k in keys)), "other")
        groups[g] = groups.get(g, 0.0) + ms
    busy_ms = sum(by_name.values())
    wall_ms = (roll_s + upd_s) * 1e3
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        fh.write(f"{label}: wall ms {wall_ms:.3f} (rollout {1e3 * roll_s:.3f}, update "
                 f"{1e3 * upd_s:.3f}); device busy ms {busy_ms:.3f}; kernels {n_kernels}\n")
        for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1]):
            fh.write(f"{ms:12.3f} ms  {name}\n")
    print(f"profile {label} (profiler on): wall {wall_ms:.3f} ms (rollout {1e3 * roll_s:.3f}, "
          f"update {1e3 * upd_s:.3f}), device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%), {n_kernels} kernel launches -> {path}")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:10.3f} ms  {g}")


def rollout_step_parts(ppo):
    """Host clock, profiler off: one PPO rollout step and its parts."""
    import torch
    from massive_marl_tpu_torch.ops import fused_substep as fs
    env, st = ppo.env, ppo.state.env_state
    g = torch.Generator(device=st.obs.device).manual_seed(0)
    actions = torch.rand(st.obs.shape[0], 80, generator=g, device=st.obs.device) * 2 - 1
    a3 = actions.reshape(-1, 10, 8)
    obs = torch.clamp(st.obs, -5.0, 5.0)
    h = env.spec.dt / env.spec.substeps
    bq, bv = st.pipeline.box_qpos, st.pipeline.box_qvel
    stepped = fs.fused_scene_step(env.spec, st.pipeline, a3, env.substep_consts)
    parts = {
        "policy forward (actor+critic)": lambda: ppo.model(obs),
        "env.step_batch (whole step)": lambda: env.step_batch(st, actions),
        "  fused_scene_step (3 substeps)": lambda: fs.fused_scene_step(
            env.spec, st.pipeline, a3, env.substep_consts),
        "    box_substep (one substep)": lambda: fs.box_substep(
            env.spec, bq, bv, torch.zeros_like(bv), h),
        "  _finish_step (reset, obs, reward)": lambda: env._finish_step(stepped, a3, st),
    }
    print("rollout step parts (host clock after synchronize, median of 5):")
    with torch.no_grad():
        for name, fn in parts.items():
            times = []
            for _ in range(6):
                torch.cuda.synchronize()
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            print(f"  {statistics.median(times[1:]):9.3f} ms  {name}")


def build_all(libs):
    """Build every kernel source at once (one nvcc each, in threads) and
    print each build's seconds and ptxas' register and spill report."""
    errors = []

    def build(lib):
        try:
            lib.load()
        except RuntimeError as e:   # re-raised below, in the main thread
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=build, args=(lib,)) for lib in libs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    print(f"build: {len(libs)} sources in {time.perf_counter() - t0:.1f} s wall")
    for lib in libs:
        res = lib.build_result
        print(f"  {res.path}: {res.seconds:.1f} s nvcc")
        for line in res.log.splitlines():
            if any(w in line for w in ("Compiling entry", "registers", "spill", "stack frame",
                                       "error")):
                print("  ptxas:", line.strip())


def marl_phase(dev):
    """Phase 6: TenAnt + MAPPO (sequential schedule) at full width, then one
    stacked-schedule and one HAPPO iteration, MAPPO with FUSED_TOWER=1,
    HATRPO, and HATRPO with FUSED_TOWER=1.  Returns the MAPPO run's launch
    counts of B1-B3, the FUSED_TOWER=1 MAPPO run's of B4/B5, and the
    MAPPO, MAPPO FUSED_TOWER=1 and HATRPO runners for the profiles."""
    import torch
    from massive_marl_tpu_torch.algos.marl.runner import MarlConfig, MarlRunner
    from massive_marl_tpu_torch.envs.ten_ant import TenAntEnv
    from massive_marl_tpu_torch.ops import fused_mlp as fm
    from massive_marl_tpu_torch.ops import fused_substep as fs
    from massive_marl_tpu_torch.utils.tree import tree_leaves
    counters = (fs.substep_kernel, fm.fwd_kernel, fm.bwd_kernel, fm.tower_fwd_kernel,
                fm.tower_bwd_kernel)
    counts = lambda: tuple(k.launches for k in counters)

    def make(cfg, tower=False):
        env = TenAntEnv(device=dev, seed=0)
        r = MarlRunner(env, E, cfg, seed=0, device=dev, print_log=False)
        r.init_state()
        c = r.cfg
        towers = c.ppo_epoch * 2 * (r.N if r.sequential else 1)
        factor = r.N * 2 if r.is_happo else 0    # old/new logp forwards
        b1 = c.episode_length * env.spec.substeps
        if tower:
            return r, (b1, 0, 0, towers + factor, towers)
        blocks = 1 + c.layer_n
        return r, (b1, blocks * (towers + factor), blocks * towers, 0, 0)

    def trpo_want(r, tower=False):
        """Launches of a HATRPO iteration as its conjugate gradients and
        line searches ran (runner.trpo_log): per agent the old/new logp
        forwards, the graph forward, the linearization (always B2), one
        forward per line-search candidate and ppo_epoch critic forwards;
        the gradient's backward, one per Fisher-vector product and ppo_epoch
        critic backwards."""
        c, blocks = r.cfg, 1 + r.cfg.layer_n
        b1 = c.episode_length * r.env.spec.substeps
        fwd = sum(3 + len(g["candidates"]) + c.ppo_epoch for g in r.trpo_log)
        bwd = sum(1 + g["fvps"] + c.ppo_epoch for g in r.trpo_log)
        if tower:
            return b1, blocks * r.N, 0, fwd, bwd
        return b1, blocks * (fwd + r.N), blocks * bwd, 0, 0

    def check(r, it, m, got, want):
        obs = r.state.env_state.obs
        if tuple(obs.shape) != (E, 388) or not torch.isfinite(obs).all():
            raise AssertionError(f"iteration {it}: bad observations {tuple(obs.shape)}")
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"iteration {it}: non-finite metrics {m}")
        if got != want:
            raise AssertionError(f"iteration {it}: B1-B5 launches {got}, expected {want}")
        print(f" rew/step {m['mean_reward']:.3f}, vloss {m['value_loss']:.4f}, "
              f"policy loss {m['policy_loss']:.5g}, launches B1/B2/B3/B4/B5 {got}")

    def delta(before):
        return tuple(b - a for a, b in zip(before, counts()))

    runner, per_iter = make(MarlConfig())
    T = runner.cfg.episode_length
    torch.cuda.reset_peak_memory_stats()
    for k in counters:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner.run(T * E)
    torch.cuda.synchronize()
    print(f"  MAPPO it 0 (warm-up, MarlRunner.run): {1e3 * (time.perf_counter() - t0):.1f} ms;",
          end="")
    check(runner, 0, runner.last_metrics, counts(), per_iter)
    rows = []
    for it in range(1, 1 + 3):
        before = counts()
        m, roll_s, upd_s = timed_iteration(runner)
        rows.append((roll_s, upd_s))
        print(f"  MAPPO it {it}: rollout {1e3 * roll_s:.1f} ms, update {1e3 * upd_s:.1f} ms;",
              end="")
        check(runner, it, m, delta(before), per_iter)
    main_counts = counts()
    roll_ms = statistics.median(r for r, _ in rows) * 1e3
    upd_ms = statistics.median(u for _, u in rows) * 1e3
    sps = statistics.median(T * E / (r + u) for r, u in rows)
    print(f"TenAnt+MAPPO E={E}: {sps:.1f} env-steps/s (median of 3), rollout {roll_ms:.1f} ms, "
          f"update {upd_ms:.1f} ms, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches B1/B2/B3 "
          f"{main_counts} over 4 iterations")

    for label, cfg in (("MAPPO stacked schedule", MarlConfig(update_schedule="stacked")),
                       ("HAPPO", MarlConfig.from_cfg_train({}, "happo"))):
        other, want = make(cfg)
        timed_iteration(other)       # first iteration: allocator and library warm-up
        before = counts()
        m, roll_s, upd_s = timed_iteration(other)
        print(f"  {label}: rollout {1e3 * roll_s:.1f} ms, update {1e3 * upd_s:.1f} ms "
              f"({T * E / (roll_s + upd_s):.1f} env-steps/s, second iteration);", end="")
        check(other, 2, m, delta(before), want)
        del other
        torch.cuda.empty_cache()

    # MAPPO with the whole-tower kernels
    os.environ["FUSED_TOWER"] = "1"
    try:
        tower, want = make(MarlConfig(), tower=True)
        for k in counters:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tower.run(T * E)
        torch.cuda.synchronize()
        print(f"  MAPPO FUSED_TOWER=1 it 0 (warm-up, MarlRunner.run): "
              f"{1e3 * (time.perf_counter() - t0):.1f} ms;", end="")
        check(tower, 0, tower.last_metrics, counts(), want)
        before = counts()
        m, roll_s, upd_s = timed_iteration(tower)
        print(f"  MAPPO FUSED_TOWER=1 it 1: rollout {1e3 * roll_s:.1f} ms, update "
              f"{1e3 * upd_s:.1f} ms ({T * E / (roll_s + upd_s):.1f} env-steps/s);", end="")
        check(tower, 1, m, delta(before), want)
        tower_counts = counts()
    finally:
        os.environ.pop("FUSED_TOWER")

    # HATRPO (cfg/hatrpo/config.yaml's settings)
    cfg = MarlConfig.from_cfg_train({}, "hatrpo")
    trpo, _ = make(cfg)
    t0 = time.perf_counter()
    before = counts()
    trpo.run(T * E)
    torch.cuda.synchronize()
    print(f"  HATRPO it 0 (warm-up, MarlRunner.run): {1e3 * (time.perf_counter() - t0):.1f} ms;",
          end="")
    check(trpo, 0, trpo.last_metrics, delta(before), trpo_want(trpo))
    rows = []
    for it in (1, 2):
        before = counts()
        m, roll_s, upd_s = timed_iteration(trpo)
        rows.append((roll_s, upd_s))
        got = delta(before)
        print(f"  HATRPO it {it}: rollout {1e3 * roll_s:.1f} ms, update {1e3 * upd_s:.1f} ms, "
              f"{T * E / (roll_s + upd_s):.1f} env-steps/s; Fisher-vector products per agent "
              f"{[g['fvps'] for g in trpo.trpo_log]}, line-search candidates "
              f"{[len(g['candidates']) for g in trpo.trpo_log]};", end="")
        check(trpo, it, m, got, trpo_want(trpo))
        blocks, n = 1 + cfg.layer_n, trpo.N
        lo2 = n * blocks * (4 + 1 + cfg.ppo_epoch)
        hi2 = n * blocks * (4 + cfg.ls_step + cfg.ppo_epoch)
        lo3, hi3 = n * blocks * (1 + 2 + cfg.ppo_epoch), n * blocks * (1 + 11 + cfg.ppo_epoch)
        if not (lo2 <= got[1] <= hi2 and lo3 <= got[2] <= hi3):
            raise AssertionError(f"HATRPO it {it}: B2/B3 {got[1:3]} outside [{lo2}, {hi2}] x "
                                 f"[{lo3}, {hi3}]")
    if not all(torch.isfinite(x).all() for x in tree_leaves(trpo.state.actor_params)):
        raise AssertionError("HATRPO: non-finite actor parameters")
    sps = statistics.median(T * E / (r + u) for r, u in rows)
    print(f"TenAnt+HATRPO E={E}: {sps:.1f} env-steps/s (median of 2), rollout "
          f"{1e3 * statistics.median(r for r, _ in rows):.1f} ms, update "
          f"{1e3 * statistics.median(u for _, u in rows):.1f} ms (B2/B3 per iteration within "
          f"[{lo2}, {hi2}] x [{lo3}, {hi3}])")

    # HATRPO with the whole-tower kernels: only the linearizations use B2
    os.environ["FUSED_TOWER"] = "1"
    try:
        before = counts()
        m, roll_s, upd_s = timed_iteration(trpo)
        print(f"  HATRPO FUSED_TOWER=1: rollout {1e3 * roll_s:.1f} ms, update "
              f"{1e3 * upd_s:.1f} ms ({T * E / (roll_s + upd_s):.1f} env-steps/s);", end="")
        check(trpo, 3, m, delta(before), trpo_want(trpo, tower=True))
    finally:
        os.environ.pop("FUSED_TOWER")
    return main_counts, tower_counts, (runner, tower, trpo)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from massive_marl_tpu_torch.algos.rl.ppo import PPO, PPOConfig
    from massive_marl_tpu_torch.envs.ten_ant import TenAntEnv
    from massive_marl_tpu_torch.ops import fused_mlp as fm
    from massive_marl_tpu_torch.ops import fused_substep as fs
    # the plain versions' float32 products in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. the card
    dev = torch.device("cuda")
    card = smi_line()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- 2. build
    build_all([fs.substep_kernel, fm.fused_mlp_lib, fm.fused_tower_lib])

    # ---- 3. B1 vs plain version at the main path's shapes
    env = TenAntEnv(device=dev, seed=0)
    c_box = env.substep_consts
    c_nobox = fs.scene_consts(env.spec._replace(box_sys=None, box_half_extents=None))
    ops = make_states(env, E, 1, dev)
    B = E * A
    print(f"B1 vs plain at E={E} (B={B} articulations):")
    max_err = max(check_kernel(fs, c_box, ops, "box"), check_kernel(fs, c_nobox, ops, "no-box"))
    table = c_box.device_table(dev)
    kernel_ms = time_cuda_ms(lambda: fs.substep_kernel(table, c_box.P, A, *ops), KERNEL_REPS)
    plain_ms = time_cuda_ms(lambda: fs.substep_plain(c_box, A, *ops), PLAIN_REPS, warmup=1)
    per_ant = ops_per_articulation(fs, c_box, env)
    bytes_moved = 4 * (B * (15 + 14 + 8) + E * (7 + 6) + table.numel()
                       + B * (15 + 14 + 6 + 24))
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = per_ant * B / FP32_OPS_PER_S * 1e3
    bound_ms, bound_by = (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")
    print(f"  kernel {kernel_ms:.4f} ms (median of {KERNEL_REPS}), plain {plain_ms:.2f} ms "
          f"(median of {PLAIN_REPS}); bound {bound_ms:.4f} ms by {bound_by}: "
          f"{bytes_moved / 1e6:.2f} MB -> {bytes_ms:.4f} ms, "
          f"{per_ant:.0f} ops/articulation x {B} -> {ops_ms:.4f} ms")
    del ops

    # ---- 4. B2/B3 vs plain versions at the MARL update's shapes
    print(f"B2/B3 vs plain at B={MLP_B} rows per agent:")
    mlp_err, mlp_main = mlp_phase(fm, dev)

    # ---- 4b. B4/B5 vs plain versions at the MARL update's tower shapes
    print(f"B4/B5 vs plain at B={MLP_B} rows per agent:")
    tower_err, tower_main = tower_phase(fm, dev)

    # ---- 5. TenAnt + PPO at full width
    env = TenAntEnv(device=dev, seed=0)
    ppo = PPO(env, E, PPOConfig(), seed=0, device=dev, print_log=False)
    ppo.init_state()
    torch.cuda.reset_peak_memory_stats()
    fs.substep_kernel.launches = 0
    per_iter = ppo.cfg.nsteps * env.spec.substeps

    def check(it, m, n):
        obs = ppo.state.env_state.obs
        if tuple(obs.shape) != (E, 388) or not torch.isfinite(obs).all():
            raise AssertionError(f"iteration {it}: bad observations {tuple(obs.shape)}")
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"iteration {it}: non-finite metrics {m}")
        if n != per_iter:
            raise AssertionError(f"iteration {it}: {n} kernel launches, expected {per_iter}")
        print(f"  rew/step {m['mean_reward']:.3f}, vloss {m['mean_value_loss']:.3f}, "
              f"surr {m['mean_surrogate_loss']:.4f}, lr {m['lr']:.2e}, launches {n}")

    # warm-up: one iteration through the trainer's own entry point
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ppo.run(1)
    torch.cuda.synchronize()
    print(f"  it 0 (warm-up, PPO.run): {1e3 * (time.perf_counter() - t0):.1f} ms;", end="")
    check(0, ppo.last_metrics, fs.substep_kernel.launches)
    rows = []
    for it in range(1, 1 + 3):
        n0 = fs.substep_kernel.launches
        m, roll_s, upd_s = timed_iteration(ppo)
        rows.append((roll_s, upd_s))
        print(f"  it {it}: rollout {1e3 * roll_s:.1f} ms, update {1e3 * upd_s:.1f} ms;", end="")
        check(it, m, fs.substep_kernel.launches - n0)
    ppo_launches = fs.substep_kernel.launches
    roll_ms = statistics.median(r for r, _ in rows) * 1e3
    upd_ms = statistics.median(u for _, u in rows) * 1e3
    sps = statistics.median(ppo.cfg.nsteps * E / (r + u) for r, u in rows)
    print(f"TenAnt+PPO E={E}: {sps:.1f} env-steps/s (median of 3), rollout {roll_ms:.1f} ms, "
          f"update {upd_ms:.1f} ms, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"kernel launches {ppo_launches} over 4 iterations")

    # ---- 6. TenAnt + MAPPO (then stacked, HAPPO, FUSED_TOWER=1, HATRPO) at full width
    marl_counts, tower_counts, (runner, tower, trpo) = marl_phase(dev)

    # ---- 7. where the time goes
    profile_iteration(ppo, os.path.join(root, "build", "profile_iteration.txt"), "PPO")
    rollout_step_parts(ppo)
    del ppo
    profile_iteration(runner, os.path.join(root, "build", "profile_mappo_iteration.txt"),
                      "MAPPO")
    profile_iteration(trpo, os.path.join(root, "build", "profile_hatrpo_iteration.txt"),
                      "HATRPO")
    os.environ["FUSED_TOWER"] = "1"
    try:
        profile_iteration(tower, os.path.join(root, "build", "profile_mappo_tower_iteration.txt"),
                          "MAPPO FUSED_TOWER=1")
    finally:
        os.environ.pop("FUSED_TOWER")

    print(card)
    mlp_entry = lambda name, kind, n, src, line, err, main: {
        "name": name, "route": "cuda", "source": f"massive_marl_tpu_torch/ops/csrc/{src}",
        "replaces": f"massive_marl_tpu/ops/fused_mlp.py:{line}",
        "launches": n, "max_abs_err": err[kind], "ms": main[kind],
        "plain_ms": main[kind + "_plain"], "bound_ms": main[kind + "_bound"],
        "bound_by": main[kind + "_by"], "library_ms": None}
    print(json.dumps({"kernels": [
        {"name": "ant_substep", "route": "cuda",
         "source": "massive_marl_tpu_torch/ops/csrc/substep.cu",
         "replaces": "massive_marl_tpu/ops/fused_substep.py:114",
         "launches": ppo_launches, "max_abs_err": max_err,
         "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
         "library_ms": None},
        mlp_entry("dense_elu_ln_fwd", "fwd", marl_counts[1], "fused_mlp.cu", 46, mlp_err,
                  mlp_main),
        mlp_entry("dense_elu_ln_bwd", "bwd", marl_counts[2], "fused_mlp.cu", 66, mlp_err,
                  mlp_main),
        mlp_entry("mlp_tower_fwd", "fwd", tower_counts[3], "fused_tower.cu", 265, tower_err,
                  tower_main),
        mlp_entry("mlp_tower_bwd", "bwd", tower_counts[4], "fused_tower.cu", 288, tower_err,
                  tower_main)]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
