"""Smoke test of the PyTorch/CUDA port (massive_marl_tpu_torch) on one GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:
  1. the card's name and power limit (nvidia-smi) and torch's device name;
  2. build the substep kernel from massive_marl_tpu_torch/ops/csrc/substep.cu
     with nvcc (sm_90a); print the build seconds and ptxas' register report;
  3. hold the kernel against its plain PyTorch version at E=4096 envs x 10
     ants over four state families (feet on the ground, points inside and
     just outside the push-box, hinges beyond their limits, no box); print
     the errors per output, the kernel's time (CUDA events, median of 30
     launches) beside its bound and the plain version's time;
  4. TenAnt + PPO at full width (E=4096, hidden 1024-1024-512, nsteps 8,
     5 epochs x 4 minibatches): 1 warm-up iteration through PPO.run and 3
     timed iterations through PPO.rollout_phase / update_phase;
     env-steps/s, rollout ms, update ms;
     finite losses and observations; exactly 24 kernel launches (8 steps x 3
     substeps) per iteration, counted from 0 just before this phase;
  5. one more iteration under torch.profiler: device time by kernel group,
     the device's busy share (full list in build/profile_iteration.txt),
     and a host-clock breakdown of one rollout step into its parts.
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
import time

E, A = 4096, 10                 # the benchmark's env count; ants per TenAnt env
KERNEL_REPS, PLAIN_REPS = 30, 5
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
FP32_OPS_PER_S = 67e12          # H100 SXM FP32 outside the tensor cores
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


# device kernels grouped by what issues them (names as the profiler reports them)
KERNEL_GROUPS = (("B1 substep kernel", ("substep_kernel",)),
                 ("GEMM", ("gemm", "nvjet", "cutlass", "gemv")),
                 ("optimizer (foreach)", ("multi_tensor_apply",)),
                 ("reductions", ("reduce_kernel",)),
                 ("ELU fwd/bwd", ("elu",)),
                 ("copies and cat", ("Cat", "copy", "Memcpy")),
                 ("other elementwise", ("elementwise", "cross_kernel", "index")))


def profile_iteration(ppo, out_dir):
    """One training iteration under torch.profiler (device time by kernel
    group and name, the device's busy share), then a host-clock breakdown of
    one rollout step into its parts; the full list goes to out_dir."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from massive_marl_tpu_torch.ops import fused_substep as fs
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        traj = ppo.rollout_phase()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ppo.update_phase(traj, ppo.state.env_state.obs)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
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
    wall_ms = (t2 - t0) * 1e3
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "profile_iteration.txt")
    with open(path, "w") as fh:
        fh.write(f"wall ms {wall_ms:.3f} (rollout {1e3 * (t1 - t0):.3f}, update "
                 f"{1e3 * (t2 - t1):.3f}); device busy ms {busy_ms:.3f}; kernels {n_kernels}\n")
        for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1]):
            fh.write(f"{ms:12.3f} ms  {name}\n")
    print(f"profile (profiler on): wall {wall_ms:.3f} ms (rollout {1e3 * (t1 - t0):.3f}, "
          f"update {1e3 * (t2 - t1):.3f}), device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%), {n_kernels} kernel launches -> {path}")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:10.3f} ms  {g}")

    # host clock, profiler off: one rollout step and its parts
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
    from massive_marl_tpu_torch.ops import fused_substep as fs

    # ---- 1. the card
    dev = torch.device("cuda")
    card = smi_line()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- 2. build
    t0 = time.perf_counter()
    fs.substep_kernel.load()
    res = fs.substep_kernel.build_result
    print(f"build: {res.path} in {res.seconds:.1f} s nvcc ({time.perf_counter() - t0:.1f} s total)")
    for line in res.log.splitlines():
        if any(w in line for w in ("registers", "spill", "stack frame", "error")):
            print("  ptxas:", line.strip())

    # ---- 3. kernel vs plain version at the main path's shapes
    env = TenAntEnv(device=dev, seed=0)
    c_box = env.substep_consts
    c_nobox = fs.scene_consts(env.spec._replace(box_sys=None, box_half_extents=None))
    ops = make_states(env, E, 1, dev)
    B = E * A
    print(f"kernel vs plain at E={E} (B={B} articulations):")
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

    # ---- 4. the main path: TenAnt + PPO at full width
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
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        traj = ppo.rollout_phase()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        m = ppo.update_phase(traj, ppo.state.env_state.obs)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        rows.append((t1 - t0, t2 - t1))
        print(f"  it {it}: rollout {1e3 * (t1 - t0):.1f} ms, update {1e3 * (t2 - t1):.1f} ms;",
              end="")
        check(it, {k: float(v) for k, v in m.items()}, fs.substep_kernel.launches - n0)
    main_launches = fs.substep_kernel.launches
    roll_ms = statistics.median(r for r, _ in rows) * 1e3
    upd_ms = statistics.median(u for _, u in rows) * 1e3
    sps = statistics.median(ppo.cfg.nsteps * E / (r + u) for r, u in rows)
    print(f"TenAnt+PPO E={E}: {sps:.1f} env-steps/s (median of 3), rollout {roll_ms:.1f} ms, "
          f"update {upd_ms:.1f} ms, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"kernel launches {main_launches} over 4 iterations")

    # ---- 5. where the time goes
    profile_iteration(ppo, os.path.join(root, "build"))

    print(card)
    print(json.dumps({"kernels": [{
        "name": "ant_substep", "route": "cuda",
        "source": "massive_marl_tpu_torch/ops/csrc/substep.cu",
        "replaces": "massive_marl_tpu/ops/fused_substep.py:114",
        "launches": main_launches, "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
