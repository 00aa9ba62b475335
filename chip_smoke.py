"""Smoke test of the PyTorch/CUDA port (massive_marl_tpu_torch) on one GPU.

Run from the root of a checkout:  python3 chip_smoke.py

It checks what the benchmark (port_bench/) does not; what the two share
(peaks, B1's and B2/B3's bounds, kernel groups, the trace's reading) is
port_bench's.

Phases; any failure raises and the script exits non-zero:
  1. torch's device name and the card's power limit (nvidia-smi);
  2. build the kernels from massive_marl_tpu_torch/ops/csrc/ (substep.cu:
     B1, its DR instantiation and B6; fused_mlp.cu: B2/B3; fused_tower.cu: B4/B5), one nvcc per
     source, started together; print the build seconds and ptxas' register
     and spill report, and the substep kernel's resident blocks per SM for
     each instantiation (cudaOccupancyMaxActiveBlocksPerMultiprocessor);
  3. hold B1 against its plain PyTorch version at E=4096 envs x 10 ants
     over four state families (feet on the ground, points inside and just
     outside the push-box, hinges beyond their limits, no box); print the
     errors per output (and whether it is bit-identical), the kernel's time
     (CUDA events, median of 30 launches) beside port_bench.roofline.b1's
     bound, the bound's no-FMA floor (twice the operations bound: under
     -fmad=false each operation is an instruction) and the plain version's
     time; raises unless the plain version's operation count and the
     table's length are the ones that bound assumes;
  3b. the same for B1's legacy branch (ContactParams(beta=None)) over the
     same families; then B6 against its plain version at B = 1024 (its TPU
     shape) and B = 40,960 over the debug tool's three scenarios, box on
     and off (the same non-finite mask, the finite values within TOL); the
     times and bounds of both;
  3c. the debug tool (cli/debug_fused.main) for the three scenarios on the
     card, which prints its table: exactly 2 B6 and 2 B1 launches per
     scenario, counted from 0 before the phase;
  3d. B1's DR instantiation (the [41, B] domain-randomization operand)
     against its plain version at E=4096 over phase 3's families, both
     contact branches, with DrSamples drawn from cfg/TenAnt.yaml's spec
     (read by the port's YAML loader) as the file is and with `maps_to:
     armature`; its time beside B1's in the same call, its bound and the
     plain version's time;
  3e. one TenAnt control step of E=4096 envs with one DrSample through
     fused_scene_step (B1-DR) and the array engine's scene_step, from fresh
     resets, held at the control-step tolerances;
  3f. the push-box kernel (box_body_step, which replaces no TPU kernel)
     against the plain envs/ant_scene.box_substep at E=4096 over five
     families of box states (at rest on a face, sliding, tilted on an edge,
     airborne, pressed past the depenetration cap), each with no ant
     wrench and with a large random one, on TenAnt under the scene's
     default contact and cfg/TenAnt.yaml's and on OneAnt: bit for bit; its
     time on TenAnt (CUDA events, median of 30 launches) beside its bound
     and the plain version's time;
  4. hold B2/B3 against their plain versions at the MARL update's three
     layer shapes (actor layer 0 128->512, hidden 512->512, critic layer 0
     512->512 with the share obs read by every agent), B = 32,768 rows, for
     the stacked schedule's N = 10 agents and the sequential schedule's
     N = 1: every output, with tolerances, and B3 twice for the same bits;
     each kernel's time beside its bound and its plain version's time; as
     notes, bf16 torch.bmm of B2's product and of B3's two products, and
     the bytes of W that B2 reads from L2 per call (once per cluster and
     work item); at the main shape (hidden, N = 1) B2's and B3's host time
     per call and B3's device time per pass (row pass, dW pass,
     reductions) from a short torch.profiler window;
  4b. hold B4/B5 against their plain versions at the update's two tower
     shapes (actor: Din 128 -> 512, critic: Din 512 with the share obs read
     by every agent; 3 layers), N = 1 and N = 10, B = 32,768, dx both ways;
     B5 twice for the same bits; each kernel's time beside its bound and
     its plain version's, and three chained B2 (B3) launches as a note, and
     the bytes of W that B4 reads from L2 per call; at the main shape
     (critic, N = 1) B4's and B5's host time per call, B5's device time per
     pass and its nine products as bf16 torch.bmm (a note);
  5. TenAnt + PPO at full width (E=4096, hidden 1024-1024-512, nsteps 8,
     5 epochs x 4 minibatches; untimed: the cell tenant-ppo.e4096 times it):
     1 warm-up iteration through PPO.run and 3 through
     PPO.rollout_phase / update_phase; finite losses and observations;
     exactly 24 B1 launches (8 steps x 3 substeps) and 24 box kernel
     launches from the host per iteration whose rollout runs on the host
     (eager or captured), none where it replays the rollout graph, counted
     from 0 just before this phase; the update graph's and the rollout
     graph's counters (1 eager, 1 capture, 2 replays each), and a second
     trainer from the same seeds with both graphs held off beside it, the
     same bits after every iteration (the JSON's launch totals are the
     graphed trainer's host launches and the kernels of one more rollout
     of that trainer, a replay traced under torch.profiler, which raises
     unless it holds exactly 24 B1 and 24 box kernels and the host
     launched none); 5b and 5c check the graphs' counters the same way
     (5b's rollouts eager: the array engine's step is not declared
     device-only); then the rollout graph at E and 4 E envs on trainers of
     their own: the rollout's ms eagerly against replayed (host clock
     around synchronised rollouts, medians of 10), and one replay traced
     as above: its kernels and the device's busy time;
  5b. TenAnt + PPO at full width on the array engine (sim.fused_kernel
     false): 1 warm-up iteration through PPO.run and 1 timed; finite
     metrics and no B1 or box launch; then one TenAnt step_batch with
     contact beta None on the kernel path: 3 B1 launches, all of them of
     the legacy branch, and every env finite or reset;
  5c. OneAnt + PPO (E=4096, PPOConfig()): 1 warm-up iteration through
     PPO.run and 2 timed; 24 B1 and 24 box launches from the host on the
     eager and the capturing rollout, none on the replay (with sensor
     outputs, one ant per env), finite observations of width 60;
  5d. the slice's path through the CLI: cli.train.main(--task TenAnt
     --algo ppo --randomize --num_envs 4096 --max_iterations 3) with the
     env and PPO configured from cfg/ (a temporary --cfg_env copy of
     cfg/TenAnt.yaml with frequency 8, and --episode_length 16, so every
     env re-draws its parameters within the run): exactly 24 B1-DR and no
     other B1 launch per iteration, counted from 0 before the phase; finite
     losses; rollout ms, update ms and env-steps/s; the setup_only mass
     kept and the damping re-drawn;
  5e. the trainer's files on the card, through cli.train.main at E=4096:
     TenAnt + PPO for 2 iterations with save_interval 1 (model_1.ckpt,
     model_2.ckpt, metrics.csv and an event file; each checkpoint's size,
     the save's and restore's ms), --model_dir latest restoring that state
     bit for bit, and --test --headless --episode_length 100 (a finite
     mean return, exactly 300 B1 launches counted from 0 before the call);
     TenAnt + MAPPO the same with 1 iteration (24 B1, 300 B2, 300 B3;
     marl_1.ckpt; runner.eval() through --test, 300 B1); --test without
     --headless and VIEWER_STEPS=50 (viewer_TenAnt.html); --random_actions
     --bench_len 3 (env-steps/s per report; exactly (1 + 3) x 256 x 3 B1
     launches).  Its files go under build/smoke_5e/, removed at its end;
  5f. the single-agent zoo and the other tasks, through cli.train.main
     from cfg/: TenAnt + TRPO at E=4096 (the YAML's 1024-1024-512), 2
     iterations with exactly 24 B1 launches, 11 Fisher-vector products and
     1..10 line-search candidates each, rollout ms, update ms and
     env-steps/s; TenAnt + SAC (6 iterations), TD3 and DDPG (10 each) at the
     YAMLs' configuration (numEnvs 128): 24 B1 per iteration, the
     collect-only warm-up (4 iterations for SAC, 8 for TD3/DDPG), then SAC
     32 and TD3/DDPG 160 gradient steps per iteration (TD3's pi steps half
     of them), the ring's device bytes, a finite q_loss; SAC again with
     --model_dir latest --test --headless: params and target_params bit for
     bit, 300 B1; MultiAntCircle and MultiIngenuity at E=4096, one MAPPO
     iteration (B2/B3 launches as its update runs them, no B1) and one PPO
     iteration each, finite rewards and observations on the card.  Its
     files go under build/smoke_5f/, removed at its end; phase 4 holds
     B2/B3 at the new tasks' layer-0 widths (38, 76, 13, 52 padded to 128)
     as well;
  5g. the rest of the MARL zoo on TenAnt: MAT at cfg/mat and E=4096 (1
     warm-up iteration through MatRunner.run, 2 timed through
     rollout_phase / update_phase; exactly 24 B1 and no B2-B5 launch each;
     rollout ms, update ms, env-steps/s, peak memory; the KV-cached decode
     against N full decodes on the card at E=4096, rtol 1e-5 + atol 1e-5);
     MADDPG through cli.train.main at cfg/maddpg (save_interval 10) and
     TenAnt.yaml's numEnvs 128: 10 iterations, 8 collect-only, then 2
     with 8 gradient steps, 24 B1 each, the bf16 ring's device bytes
     (R x E x 3,560 B), then --model_dir latest --test --headless: the
     parameters bit for bit from maddpg_10.ckpt and 300 B1; recurrent
     MAPPO (cfg/mappo with use_recurrent_policy: hidden 512, L = T = 8) at
     E=4096 for 2 timed iterations and recurrent HAPPO (data_chunk_length
     4, num_mini_batch 2) for 1, through cli.train.main: 24 B1 and no
     B2-B5 per iteration.  Its YAMLs and files go under build/smoke_5g/,
     removed at its end; it prints its seconds;
  5h. the multi-task, meta and offline trainers through cli.train.main,
     with build/smoke_5h/ as the working directory (its YAML copies,
     logs and ./datasets go there; removed at its end; it prints its
     seconds): MTPPO and MTTRPO on OneAnt + MultiAntCircle at cfg/
     widths (1024-1024-512) and --num_envs 4096 per task, 2 iterations
     each with exactly 24 B1 (OneAnt: 8 steps x 3 substeps; the array
     engine steps MultiAntCircle) and no B2-B5 launch, env-steps/s =
     8 x 4096 x 2 / iteration seconds, and model_2.ckpt restored bit for
     bit into a fresh trainer; MTSAC at the YAML's numEnvs 128 for 4
     iterations (the first collect-only, then 4 gradient steps each, 24
     B1 each), its float32 ring's device bytes (5000 x 128 x 696 B);
     random for 2 iterations (48 B1); MAML-PPO on TenAnt at --num_envs
     4096 for 2 meta-iterations (192 B1 each: 4 slots x 16 steps x 3),
     then eval_adaptation(n_tasks=2) with 144 B1 and its pre and post
     rewards; ppo_collect on OneAnt at --num_envs 4096 for 1 iteration
     with collect_steps 65,536 (72 B1), then TD3+BC, BCQ and IQL on that
     dataset for 200 steps each (the YAMLs' 100,000 cut), each followed
     by its online evaluation (64 envs x 1,000 steps: 3,000 B1); train
     steps/s and evaluation seconds.  Every reward, loss and pre/post
     value finite, every trainer and env on the card;
  6. TenAnt + MAPPO at full width (MarlConfig(): N=10, hidden 512, 3 fused
     blocks per tower, episode_length 8, 5 epochs, E=4096, the sequential
     schedule; untimed: the cell tenant-mappo.e4096 times it): 1 warm-up
     iteration through MarlRunner.run, then the update graph's capture and
     two replays; finite metrics; exactly 24 B1, 300 B2 and 300 B3 host
     launches per eager or capturing iteration (24, 0, 0 a replay), counted
     from 0 just before this phase; graphed against eager, bit for bit;
     then one iteration of the stacked schedule (30 B2, 30 B3) and one of
     HAPPO (360 B2, 300 B3), checked the same way; then MAPPO with
     FUSED_TOWER=1 (1 warm-up iteration through MarlRunner.run, 1 timed:
     24 B1, 100 B4, 100 B5, no B2/B3 per iteration); HATRPO
     (MarlConfig.from_cfg_train({}, "hatrpo"), 1 warm-up iteration through
     MarlRunner.run, 2 timed) with B2/B3 launches exactly as its conjugate
     gradients and line searches ran them, inside the range the code
     allows; and one HATRPO iteration with FUSED_TOWER=1 (30 B2 from the
     linearizations, no B3, B4/B5 as counted);
  7. one PPO --randomize (the CLI's trainer), one PPO array-path, one
     TRPO, one SAC and one TD3 training iteration (E=128), one OneAnt PPO,
     one MAT, one MADDPG training iteration (E=128), one recurrent MAPPO,
     one MAPPO, one HATRPO and one MAPPO FUSED_TOWER=1 iteration read by
     port_bench.trace: busy share, device time by kernel group, idle gaps
     (full lists in build/), and for both PPO runs on B1 a host-clock
     breakdown of one rollout step into its parts; it raises if B2's group
     (MAPPO, HATRPO) or B4's (FUSED_TOWER=1) shows no device time in an
     iteration that launched it;
  8. data parallelism (parallel/mesh.py) on TenAnt + PPO and + MAPPO at
     full width, E=4096, 2 iterations each, every launch count exact (24
     B1; 24 B1, 300 B2, 300 B3 per iteration and rank).  8a, one process:
     the runs without a mesh; each rank's first rollout on a 2-rank layout
     against their rows (the same bits in every field of P8_ROWS_RULE);
     each trainer's own spread under another summation order
     (p8_other_order); then the same seeds with an NCCL mesh of world size
     1, its all-reduces' bytes and NCCL device time (torch.profiler).  8b:
     two ranks sharing the card (parallel/launch.py --backend gloo, 2,048
     env rows each), both ranks' parameters and optimizer state the same
     bits.  8a's and 8b's runs start from the one-process parameters bit
     for bit and land within 3 x their trainer's own spread (p8_agrees).
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import sys
import threading
import time

from port_bench import harness, peaks, trace
from port_bench.roofline import b1 as b1_roof
from port_bench.roofline import fused_mlp as mlp_roof

E, A = 4096, 10                 # the benchmark's env count; ants per TenAnt env
PROFILES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")  # phase 7's lists
KERNEL_REPS, PLAIN_REPS = 30, 5
MLP_B = 8 * 4096                # episode_length x E rows per agent in the MARL update
MLP_SHAPES = (("actor layer 0", 128, 512, False), ("hidden", 512, 512, False),
              ("critic layer 0", 512, 512, True))   # (name, Din, H, share obs)
MLP_OUTPUTS = ("dx", "dw", "db", "dgamma", "dbeta", "dg0", "db0")
# layer 0 of MAPPO on MultiAntCircle and MultiIngenuity: (name, obs width,
# share obs); the caller pads each to Din = 128
MLP_PAD_SHAPES = (("MultiAntCircle actor", 38, False), ("MultiAntCircle critic", 76, True),
                  ("MultiIngenuity actor", 13, False), ("MultiIngenuity critic", 52, True))
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
    """Operations of one B1 substep per articulation, counted from the plain
    version on the CPU."""
    return count_ops(fs.substep_plain, c, A, *make_states(env, 1, 0, "cpu")) / A


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


def pass_split(fn, reps=3):
    """Device ms per call of each pass of a backward kernel (B3 or B5): its
    row pass, dW pass and partial-sum reductions, port_bench.trace's kernel
    groups, over `reps` calls after one warm-up call."""
    from massive_marl_tpu_torch.utils import profiling
    fn()
    tr = trace.profile_iterations(fn, reps, profiling.PREFIX)
    split = {g: 1e3 * t / reps for g, t in tr.breakdown()["device_ops"]}
    if len(split) != 3 or "other" in split or not all(split.values()):
        raise AssertionError(f"pass_split: not a row pass, a dW pass and the partial sums "
                             f"on the card: {split}")
    return split


def host_ms(fn, reps=20):
    """Host milliseconds per call of fn, which only enqueues work (no
    synchronize inside the timed loop): the wrapper's checks, allocations,
    tensor-map encodes and launches."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / reps


def fmt_split(split):
    return ", ".join(f"{g} {ms:.4f} ms" for g, ms in split.items())


def check_kernel(fs, c, ops, label, dr=None):
    """Kernel vs plain version on the same operands (dr: the DR operand or
    None); returns the worst absolute error and raises on any tolerance
    break."""
    import torch
    got = fs.substep_kernel(c, A, *ops, dr=dr)
    torch.cuda.synchronize()
    ref = fs.substep_plain(c, A, *ops, dr=dr)
    torch.cuda.synchronize()
    return compare_outputs(zip(TOL, got, ref), c.has_box, label)


def compare_outputs(triples, has_box, label, finite_only=True):
    """(name, kernel output, plain output) against TOL; with finite_only
    False the non-finite masks must agree and the finite values are held to
    TOL.  Returns the worst absolute error."""
    import torch
    worst = 0.0
    for name, g, r in triples:
        if name == "wrench" and not has_box:
            continue
        rtol, atol = TOL[name]
        if finite_only and not torch.isfinite(g).all():
            raise AssertionError(f"{label}: kernel {name} has non-finite values")
        mask = torch.isfinite(r)
        if not torch.equal(torch.isfinite(g), mask):
            raise AssertionError(f"{label}: kernel {name}'s non-finite values differ")
        g, r = g[mask], r[mask]
        err = (g - r).abs()
        rel = (err / r.abs().clamp(min=1e-6)).max().item()
        bad = int((err > atol + rtol * r.abs()).sum())
        same = " (bit-identical)" if torch.equal(g, r) else ""
        print(f"  {label:6s} {name:8s} max|ref| {r.abs().max().item():.6g}  "
              f"max abs err {err.max().item():.3e}  max rel err {rel:.3e}  "
              f"breaks {bad} (rtol {rtol}, atol {atol}){same}")
        if bad:
            raise AssertionError(f"{label}: kernel {name} disagrees with the plain version")
        worst = max(worst, err.max().item())
    return worst


def roof_ms(nbytes, fp32_ops, bf16_ops=0):
    """(least ms, "bytes" | "operations") of work that moves nbytes through
    device memory and runs fp32_ops outside the tensor cores and bf16_ops
    on them, at port_bench.peaks' rates."""
    bytes_ms = nbytes / peaks.HBM_BYTES_PER_S * 1e3
    ops_ms = (bf16_ops / peaks.BF16_OPS_PER_S + fp32_ops / peaks.FP32_OPS_PER_S) * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def substep_bound(per_art, n_art, n_box, table_numel, n_out, n_dr=0):
    """(bound ms, "bytes" | "operations", bytes) of one launch of a substep
    variant that port_bench.roofline.b1 does not bound (B1's legacy branch,
    B1-DR, B6): state, torques, box state (and the n_dr DR fields) read
    once, outputs written once; the articulations' operations at the FP32
    rate."""
    nbytes = 4 * (n_art * (15 + 14 + 8 + n_dr) + n_box * (7 + 6) + table_numel
                  + n_art * n_out)
    return roof_ms(nbytes, per_art * n_art) + (nbytes,)


def fmt_bound(bound_ms, by) -> str:
    """A substep bound, with its no-FMA floor when operations bound it: the
    FP32 rate counts a fused multiply-add as two operations, and under
    -fmad=false every operation is one instruction."""
    floor = f", no-FMA floor {2 * bound_ms:.4f} ms" if by == "operations" else ""
    return f"bound {bound_ms:.4f} ms by {by}{floor}"


def count_ops(fn, *args) -> int:
    """Operations of fn(*args) (a plain version, branch-free, so every input
    needs the same count) on the CPU: one per element of an elementwise
    operation, n - 1 additions per output of a sum of n, three per component
    of a cross product, 2n per norm of n."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Counter(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            if isinstance(out, torch.Tensor):
                if name in b1_roof.ARITH_OPS:
                    Counter.n += out.numel()
                elif name == "sum":
                    Counter.n += args[0].numel() - out.numel()
                elif name == "linalg_cross":
                    Counter.n += 3 * out.numel()
                elif name == "linalg_vector_norm":
                    Counter.n += 2 * args[0].numel()
            return out

    with Counter():
        fn(*args)
    return Counter.n


BOX_FAMILIES = ("rest", "sliding", "edge", "airborne", "deep")


def box_states(family, n_env, seed):
    """[E, 7], [E, 6] push-box states of one family (the 1 x 28 x 1 box, its
    corners of radius 0)."""
    import torch
    g = torch.Generator().manual_seed(seed)
    u = lambda *s: torch.rand(*s, generator=g)
    yaw = (u(n_env) * 2 - 1) * 3.14159
    z0 = torch.zeros(n_env)
    quat = torch.stack([z0, z0, torch.sin(yaw / 2), torch.cos(yaw / 2)], 1)
    pos = torch.stack([u(n_env) * 8 - 4, u(n_env) * 8 - 4, torch.full((n_env,), 0.5)], 1)
    vel = (u(n_env, 6) * 2 - 1) * 0.05
    if family == "rest":
        pos[:, 2] = 0.5 - 0.002 * u(n_env)
    elif family == "sliding":
        pos[:, 2] = 0.499
        vel[:, 0:2] = (u(n_env, 2) * 2 - 1) * 3.0
    elif family == "edge":   # the yaw, then a tilt about the long axis: on one edge
        tilt = 0.2 + 0.4 * u(n_env)
        st, ct, sy, cy = (f(x / 2) for x in (tilt, yaw) for f in (torch.sin, torch.cos))
        quat = torch.stack([-sy * st, cy * st, sy * ct, cy * ct], 1)
        pos[:, 2] = 0.5 * torch.cos(tilt) + 0.5 * torch.sin(tilt) - 0.003 * u(n_env)
        vel[:, 3:6] = (u(n_env, 3) * 2 - 1) * 2.0
    elif family == "airborne":
        pos[:, 2] = 2.0 + 3 * u(n_env)
        quat = torch.nn.functional.normalize(torch.randn(n_env, 4, generator=g), dim=1)
        vel = (u(n_env, 6) * 2 - 1) * torch.tensor([5.0, 5.0, 5.0, 70.0, 70.0, 70.0])
    elif family == "deep":
        pos[:, 2] = 0.2 + 0.15 * u(n_env)
        vel[:, 2] = -2.0 * u(n_env)
    return torch.cat([pos, quat], 1), vel


def box_ops_per_env(env) -> float:
    """Operations of one push-box substep per env, the ants' wrench sum
    included, counted from the plain version on the CPU."""
    import torch
    from massive_marl_tpu_torch.envs.ant_scene import box_substep
    spec = env.spec._replace(box_sys=env.spec.box_sys.to("cpu"))
    bq, bv = box_states("rest", 1, 0)
    h = spec.dt / spec.substeps
    return count_ops(lambda w: box_substep(spec, bq, bv, w.reshape(6, 1, A).sum(-1).t(), h),
                     torch.zeros(6, A))


def box_kernel_phase(fs, root, dev):
    """Phase 3f: the push-box kernel against the plain box_substep at E over
    BOX_FAMILIES, no ant wrench and a large one, on TenAnt under the scene's
    default contact and cfg/TenAnt.yaml's and on OneAnt, bit for bit; its
    time, bound and plain time on TenAnt.  Returns its row: worst error (0,
    or it raises), ms, plain ms, bound ms, bound by."""
    import torch
    from massive_marl_tpu_torch.envs.ant_scene import box_substep
    from massive_marl_tpu_torch.envs.one_ant import OneAntEnv
    from massive_marl_tpu_torch.envs.ten_ant import TenAntEnv
    from massive_marl_tpu_torch.utils import yaml_lite
    env = TenAntEnv(device=dev, seed=0)
    yaml_env = TenAntEnv(yaml_lite.load(os.path.join(root, "cfg", "TenAnt.yaml")), device=dev)
    h = env.spec.dt / env.spec.substeps
    g = torch.Generator().manual_seed(7)
    big = torch.tensor([2000.0] * 3 + [500.0] * 3)[:, None]
    print(f"push-box kernel vs plain box_substep at E={E}:")
    for label, spec in (("TenAnt, default contact", env.spec),
                        ("TenAnt, cfg/TenAnt.yaml", yaml_env.spec),
                        ("OneAnt, default contact", OneAntEnv(device=dev, seed=0).spec)):
        n = spec.num_ants
        for k, family in enumerate(BOX_FAMILIES):
            bq, bv = (x.to(dev) for x in box_states(family, E, 10 + k))
            for wrench in (torch.zeros(6, E * n), torch.randn(6, E * n, generator=g) * big):
                wrench = wrench.to(dev)
                got = fs.box_substep_kernel(spec, bq, bv, wrench, h)
                want = box_substep(spec, bq, bv, wrench.reshape(6, E, n).sum(-1).t(), h)
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
                    raise AssertionError(f"box kernel differs from plain: {label}, {family}, "
                                         f"max abs error {err}")
        print(f"  {label}: bit-identical over {2 * len(BOX_FAMILIES)} cases "
              f"({', '.join(BOX_FAMILIES)}; no ant wrench and a large one)")
    bq, bv = (x.to(dev) for x in box_states("rest", E, 10))
    wrench = torch.randn(6, E * A, generator=g).to(dev)
    kernel_ms = time_cuda_ms(lambda: fs.box_substep_kernel(env.spec, bq, bv, wrench, h),
                             KERNEL_REPS)
    plain_ms = time_cuda_ms(lambda: box_substep(env.spec, bq, bv,
                                                wrench.reshape(6, E, A).sum(-1).t(), h),
                            PLAIN_REPS, warmup=1)
    table = fs.box_substep_kernel.table(env.spec, h, dev)
    nbytes = 4 * (6 * E * A + 2 * E * (7 + 6) + table.numel())
    per_env = box_ops_per_env(env)
    bound_ms, bound_by = roof_ms(nbytes, per_env * E)
    print(f"  kernel {kernel_ms:.4f} ms (median of {KERNEL_REPS}), plain {plain_ms:.2f} ms "
          f"(median of {PLAIN_REPS}); {fmt_bound(bound_ms, bound_by)} ({nbytes / 1e6:.3f} MB, "
          f"{per_env:.0f} ops/env)")
    return {"err": 0.0, "ms": kernel_ms, "plain_ms": plain_ms, "bound": bound_ms,
            "by": bound_by}


def legacy_phase(fs, env, dev):
    """Phase 3b: B1's legacy branch at E x A over the phase-3 families, B6
    at B = 1024 and 40,960 over the debug tool's scenarios.  Returns
    (B1-legacy row, B6 row): worst error, ms, plain ms, bound ms, bound by."""
    import torch
    from massive_marl_tpu_torch.cli import debug_fused as df
    from massive_marl_tpu_torch.phys.engine import ContactParams
    c_leg = fs.scene_consts(env.spec._replace(contact=ContactParams(beta=None)))
    ops = make_states(env, E, 1, dev)
    B = E * A
    print(f"B1 legacy branch (beta=None) vs plain at E={E} (B={B} articulations):")
    leg = {"err": check_kernel(fs, c_leg, ops, "legacy")}
    leg["ms"] = time_cuda_ms(lambda: fs.substep_kernel(c_leg, A, *ops), KERNEL_REPS)
    leg["plain_ms"] = time_cuda_ms(lambda: fs.substep_plain(c_leg, A, *ops), PLAIN_REPS, warmup=1)
    per_art = ops_per_articulation(fs, c_leg, env)
    leg["bound"], leg["by"], nbytes = substep_bound(per_art, B, E, c_leg.table.numel(), 59)
    print(f"  kernel {leg['ms']:.4f} ms (median of {KERNEL_REPS}), plain {leg['plain_ms']:.2f} ms; "
          f"{fmt_bound(leg['bound'], leg['by'])} ({nbytes / 1e6:.2f} MB, "
          f"{per_art:.0f} ops/articulation)")
    del ops

    sys_, hinge = env.spec.ant_sys, env.model.init_hinge
    consts = {box: df.kernel_consts(sys_, box, clamp=False) for box in (True, False)}
    b6 = {"err": 0.0}
    for n in (1024, B):
        for sc in sorted(df.SCENARIOS):
            ops = [x.t().contiguous() for x in df.make_states(sys_, hinge, n, sc, 0, dev)]
            for box, c in consts.items():
                got = fs.debug_substep_kernel(c, *ops)
                torch.cuda.synchronize()
                ref = fs.debug_substep_plain(c, *ops)
                nonfinite = sum(int((~torch.isfinite(r)).sum()) for r in ref)
                err = compare_outputs(zip(("qpos", "qvel", "wrench"), got, ref), box,
                                      f"B6 B={n} {sc} box={box}", finite_only=False)
                print(f"  B6 B={n} {sc:8s} box={box!s:5s}: max abs err {err:.3e}, "
                      f"max|qvel| {ref[1].abs().max().item():.6g}, non-finite {nonfinite}")
                b6["err"] = max(b6["err"], err)
        # timed on the tool's box case in the chaotic scenario
        c = consts[True]
        ops = [x.t().contiguous() for x in df.make_states(sys_, hinge, n, "chaotic", 0, dev)]
        small = [x.t().contiguous() for x in df.make_states(sys_, hinge, 8, "chaotic")]
        per_art = count_ops(fs.debug_substep_plain, c, *small) / 8
        row = {"ms": time_cuda_ms(lambda: fs.debug_substep_kernel(c, *ops), KERNEL_REPS),
               "plain_ms": time_cuda_ms(lambda: fs.debug_substep_plain(c, *ops), PLAIN_REPS,
                                        warmup=1)}
        row["bound"], row["by"], nbytes = substep_bound(per_art, n, n, c.table.numel(), 35)
        print(f"  B6 at B={n} (chaotic, box): kernel {row['ms']:.4f} ms (median of "
              f"{KERNEL_REPS}), plain {row['plain_ms']:.2f} ms; {fmt_bound(row['bound'], row['by'])} "
              f"({nbytes / 1e6:.3f} MB, {per_art:.0f} ops/articulation)")
        b6[n] = row
        del ops
    return leg, b6


def debug_tool_phase(fs):
    """Phase 3c: the debug tool's main() for the three scenarios on the
    card: 2 B6 and 2 B1 launches per scenario.  Returns B6's launches."""
    from massive_marl_tpu_torch.cli import debug_fused as df
    fs.substep_kernel.launches = fs.debug_substep_kernel.launches = 0
    for sc in sorted(df.SCENARIOS):
        before = fs.debug_substep_kernel.launches, fs.substep_kernel.launches
        rows = df.main(["--scenario", sc, "--device", "cuda"])
        got = (fs.debug_substep_kernel.launches - before[0], fs.substep_kernel.launches - before[1])
        if len(rows) != 4 or got != (2, 2):
            raise AssertionError(f"debug tool {sc}: {len(rows)} cases, B6/B1 launches {got}, "
                                 "expected 4 cases and (2, 2)")
    print(f"debug tool: B6/B1 launches {fs.debug_substep_kernel.launches}/"
          f"{fs.substep_kernel.launches} over the three scenarios")
    return fs.debug_substep_kernel.launches


def tenant_dr_spec(root, armature=False):
    """cfg/TenAnt.yaml's actor_params.ant spec, read by the port's YAML
    loader; armature: with `maps_to: armature` on dof_properties.stiffness,
    so the armature is randomized too."""
    import copy
    from massive_marl_tpu_torch.utils import yaml_lite
    cfg = yaml_lite.load(os.path.join(root, "cfg", "TenAnt.yaml"))
    spec = copy.deepcopy(cfg["task"]["randomization_params"]["actor_params"]["ant"])
    if armature:
        spec["dof_properties"]["stiffness"]["maps_to"] = "armature"
    return spec


def dr_kernel_phase(fs, env, root, dev):
    """Phase 3d: B1's DR instantiation against its plain version at E x A
    over the phase-3 families, both contact branches, with DrSamples drawn
    from cfg/TenAnt.yaml's spec as the file is and with `maps_to: armature`
    (the in-thread inverse inertias then see non-nominal armature).
    Returns the row: worst error, ms, plain ms, bound ms, bound by, and B1's
    ms in the same call."""
    import torch
    from massive_marl_tpu_torch.phys import dr as drm
    from massive_marl_tpu_torch.phys.engine import ContactParams
    consts = {"implicit": env.substep_consts,
              "legacy": fs.scene_consts(env.spec._replace(contact=ContactParams(beta=None)))}
    ops = make_states(env, E, 1, dev)
    g = torch.Generator(device=dev).manual_seed(4)
    sys_ = env.spec.ant_sys
    B = E * A
    print(f"B1-DR vs plain at E={E} (B={B} articulations, a [{fs.DR_LEN}, B] DR operand):")
    row = {"err": 0.0}
    for name, armature in (("cfg/TenAnt.yaml", False), ("maps_to: armature", True)):
        d = drm.sample_dr(sys_, tenant_dr_spec(root, armature), (E, A), g)
        moved = {k: float((getattr(d, k) - getattr(drm.DrSample.identity(sys_), k)).abs().max())
                 for k in ("mass", "damping", "armature", "jnt_lo", "jnt_hi")}
        print(f"  sample {name}: max |value - nominal| " +
              ", ".join(f"{k} {v:.4g}" for k, v in moved.items()))
        if (moved["armature"] > 0) != armature:
            raise AssertionError(f"DR sample {name}: armature moved {moved['armature']}")
        dro = fs.pack_dr(d)
        for branch, c in consts.items():
            err = check_kernel(fs, c, ops, "DR " + branch[:3], dr=dro)
            print(f"  {name}, {branch} branch: max abs err {err:.3e}"
                  f"{' (bit-identical)' if err == 0.0 else ''}")
            row["err"] = max(row["err"], err)
    c = consts["implicit"]
    row["ms"] = time_cuda_ms(lambda: fs.substep_kernel(c, A, *ops, dr=dro), KERNEL_REPS)
    row["b1_ms"] = time_cuda_ms(lambda: fs.substep_kernel(c, A, *ops), KERNEL_REPS)
    row["plain_ms"] = time_cuda_ms(lambda: fs.substep_plain(c, A, *ops, dr=dro), PLAIN_REPS,
                                   warmup=1)
    small = make_states(env, 1, 0, "cpu")
    d1 = drm.sample_dr(sys_.to("cpu"), tenant_dr_spec(root, True), (1, A),
                       torch.Generator().manual_seed(0))
    per_art = count_ops(fs.substep_plain, c, A, *small, fs.pack_dr(d1)) / A
    row["bound"], row["by"], nbytes = substep_bound(per_art, B, E, c.table.numel(), 59,
                                                    n_dr=fs.DR_LEN)
    print(f"  B1-DR {row['ms']:.4f} ms (median of {KERNEL_REPS}; B1 without DR {row['b1_ms']:.4f} "
          f"ms in this call), plain {row['plain_ms']:.2f} ms; {fmt_bound(row['bound'], row['by'])} "
          f"({nbytes / 1e6:.2f} MB, {per_art:.0f} ops/articulation)")
    return row


def dr_paths_phase(fs, root, dev):
    """Phase 3e: one control step of E TenAnt envs with one DrSample (the
    armature variant of the spec) through fused_scene_step (B1-DR) and the
    array engine's scene_step, from fresh resets (ants and box in the air,
    hinges at their reset noise, some beyond their randomized limits), held
    at the control-step tolerances of tests/test_torch_phys.py."""
    import torch
    from massive_marl_tpu_torch.envs.ant_scene import scene_step
    from massive_marl_tpu_torch.envs.ten_ant import TenAntEnv
    from massive_marl_tpu_torch.utils import yaml_lite
    cfg = yaml_lite.load(os.path.join(root, "cfg", "TenAnt.yaml"))
    cfg["task"]["randomize"] = True
    cfg["task"]["randomization_params"]["actor_params"]["ant"] = tenant_dr_spec(root, True)
    env = TenAntEnv(cfg, device=dev, seed=1)
    st = env.reset(E).pipeline
    g = torch.Generator(device=dev).manual_seed(5)
    actions = torch.rand(E, A, 8, generator=g, device=dev) * 2 - 1
    n0 = fs.substep_kernel.dr_launches
    got = fs.fused_scene_step(env.spec, st, actions, env.substep_consts)
    ref = scene_step(env.spec, st, actions)
    torch.cuda.synchronize()
    if fs.substep_kernel.dr_launches - n0 != env.spec.substeps:
        raise AssertionError("the kernel path did not run B1-DR once per substep")
    lo, hi = st.dr.jnt_lo, st.dr.jnt_hi
    beyond = int(((st.ant_qpos[..., 7:] < lo) | (st.ant_qpos[..., 7:] > hi)).sum())
    print(f"B1-DR path vs array path, one TenAnt step at E={E} with one DrSample "
          f"({beyond} hinges beyond their randomized limits at the start):")
    for name, key in (("ant_qpos", "qpos"), ("ant_qvel", "qvel"), ("box_qpos", "qpos"),
                      ("box_qvel", "qvel"), ("sensors", "sensors")):
        compare_outputs([(key, getattr(got, name), getattr(ref, name))], True, name[:6])


def cli_dr_phase(fs, root, dev):
    """Phase 5d, the slice's path: cli.train.main(--task TenAnt --algo ppo
    --randomize --num_envs E --max_iterations 3) with a --cfg_env copy of
    cfg/TenAnt.yaml whose re-randomization frequency is 8 and
    --episode_length 16, so every env resets at step 17 and re-draws its
    parameters within the 24 steps.  Each iteration (PPO.train_iter, timed
    here with synchronize) must launch exactly 24 B1-DR and no other B1;
    the losses must be finite; the setup_only mass must stay and the
    damping of the re-drawn envs change.  Returns the run's B1-DR launches
    and the trainer."""
    import tempfile
    import torch
    from massive_marl_tpu_torch.algos.rl.ppo import PPO
    from massive_marl_tpu_torch.cli import train as cli
    with open(os.path.join(root, "cfg", "TenAnt.yaml")) as fh:
        text = fh.read()
    if text.count("    frequency: 600\n") != 1:
        raise AssertionError("cfg/TenAnt.yaml: no `frequency: 600` line to lower")
    rows, snap = [], {}
    orig = PPO.train_iter

    def timed(self):
        if not snap:
            d = self.state.env_state.pipeline.dr
            snap.update(mass=d.mass.clone(), damping=d.damping.clone())
        n0, d0 = fs.substep_kernel.launches, fs.substep_kernel.dr_launches
        m, roll_s, upd_s = timed_iteration(self)
        rows.append((m, roll_s, upd_s, fs.substep_kernel.launches - n0,
                     fs.substep_kernel.dr_launches - d0))
        return m

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "TenAnt.yaml")
        with open(path, "w") as fh:
            fh.write(text.replace("    frequency: 600\n", "    frequency: 8\n"))
        PPO.train_iter = timed
        try:
            fs.substep_kernel.launches = fs.substep_kernel.dr_launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ppo = cli.main(["--task", "TenAnt", "--algo", "ppo", "--randomize", "--num_envs", str(E),
                            "--max_iterations", "3", "--seed", "0", "--episode_length", "16",
                            "--cfg_env", path])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            PPO.train_iter = orig
    env = ppo.env
    if (env.spec.contact.stiffness, ppo.num_envs, env.dr_frequency) != (2500.0, E, 8):
        raise AssertionError("the CLI did not configure the run from the YAML files")
    want = ppo.cfg.nsteps * env.spec.substeps
    for it, (m, roll_s, upd_s, n, n_dr) in enumerate(rows):
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"CLI DR iteration {it}: non-finite metrics {m}")
        if (n, n_dr) != (want, want):
            raise AssertionError(f"CLI DR iteration {it}: {n} B1 launches, {n_dr} of them DR; "
                                 f"expected {want}, all DR")
        print(f"  CLI DR it {it}{' (warm-up)' if it == 0 else ''}: rollout {1e3 * roll_s:.1f} ms, "
              f"update {1e3 * upd_s:.1f} ms; rew/step {m['mean_reward']:.3f}, vloss "
              f"{m['mean_value_loss']:.3f}, surr {m['mean_surrogate_loss']:.4f}, "
              f"B1-DR launches {n_dr}, other B1 {n - n_dr}")
    print_rate("TenAnt+PPO --randomize through the CLI", ppo.cfg.nsteps * E,
               [(r, u) for _, r, u, _, _ in rows[1:]], f"; main() {wall:.1f} s in all")
    d = ppo.state.env_state.pipeline.dr
    redrawn = (d.damping != snap["damping"]).flatten(1).any(1)
    if not torch.equal(d.mass, snap["mass"]) or int(redrawn.sum()) < 1:
        raise AssertionError(f"re-randomization: mass kept {torch.equal(d.mass, snap['mass'])}, "
                             f"{int(redrawn.sum())} envs with new damping")
    print(f"  re-randomization: {int(redrawn.sum())} of {E} envs drew new damping, the "
          f"setup_only mass of every env unchanged; contact stiffness "
          f"{env.spec.contact.stiffness} from cfg/TenAnt.yaml")
    return fs.substep_kernel.dr_launches, ppo


def trainer_files_phase(fs, root, dev):
    """Phase 5e, the trainer's files on the card, all through cli.train.main
    at E envs with fixed seeds, in build/smoke_5e/ (emptied first):
    (a) TenAnt + PPO, 2 iterations with a --cfg_train copy of
    cfg/ppo/config.yaml whose save_interval is 1: model_1.ckpt,
    model_2.ckpt, metrics.csv and an event file; each checkpoint's size and
    the save's and restore's ms (median of 3, synchronized); (b) --model_dir
    latest: parameters, Adam moments, count, lr and iteration equal (a)'s
    bit for bit; (c) --test --headless --episode_length 100: a finite mean
    return and exactly 100 x 3 B1 launches, counted from 0 before the call;
    (d) TenAnt + MAPPO, the same: 1 iteration (24 B1, 300 B2, 300 B3)
    writing marl_1.ckpt, restored bit for bit, and runner.eval() through
    --test at --episode_length 100 (100 x 3 B1); (e) --test without
    --headless and VIEWER_STEPS=50: viewer_TenAnt.html; (f) --random_actions
    --bench_len 3: env-steps/s per report and exactly (1 + 3) x 256 x 3 B1
    launches.  The directory is removed at the end."""
    import shutil
    import torch
    from massive_marl_tpu_torch.cli import train as cli
    from massive_marl_tpu_torch.ops import fused_mlp as fm
    from massive_marl_tpu_torch.utils.tree import tree_leaves
    t_phase = time.perf_counter()
    work = os.path.join(root, "build", "smoke_5e")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cfgs = {}
    for algo, key in (("ppo", "  save_interval: 1000\n"), ("mappo", "save_interval: 200\n")):
        with open(os.path.join(root, "cfg", algo, "config.yaml")) as fh:
            text = fh.read()
        if text.count(key) != 1:
            raise AssertionError(f"cfg/{algo}/config.yaml: no `{key.strip()}` line")
        cfgs[algo] = os.path.join(work, f"{algo}.yaml")
        with open(cfgs[algo], "w") as fh:
            fh.write(text.replace(key, key.split(":")[0] + ": 1\n"))

    def run(algo, *extra):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = cli.main(["--task", "TenAnt", "--algo", algo, "--num_envs", str(E), "--seed", "0",
                        "--logdir", os.path.join(work, algo), "--cfg_train", cfgs[algo], *extra])
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def ms3(fn):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times)

    def same(a, b, what):
        if len(a) != len(b) or not all(x.dtype == y.dtype and torch.equal(x, y)
                                       for x, y in zip(a, b)):
            raise AssertionError(f"{what}: the restored state differs from the saved one")

    def evaluate(algo, label):
        fs.substep_kernel.launches = 0
        tested, secs = run(algo, "--test", "--headless", "--episode_length", "100",
                           "--model_dir", "latest")
        n = fs.substep_kernel.launches
        if not math.isfinite(tested.last_eval) or n != 100 * 3:
            raise AssertionError(f"{label} eval: return {tested.last_eval}, {n} B1 launches, "
                                 f"expected 300")
        print(f"  {label} eval (--test --headless, 100 steps): mean return "
              f"{tested.last_eval:.3f}, {n} B1 launches, main() {secs:.2f} s")

    # (a) PPO writes its files; (b) resume
    ppo, secs = run("ppo", "--max_iterations", "2")
    d = os.path.join(work, "ppo", "seed0")
    files = sorted(os.listdir(d))
    if not ({"model_1.ckpt", "model_2.ckpt", "metrics.csv"} <= set(files)
            and any(f.startswith("events.out.tfevents") for f in files)):
        raise AssertionError(f"PPO logdir holds {files}")
    path = os.path.join(d, "model_2.ckpt")
    sizes = {f: os.path.getsize(os.path.join(d, f)) for f in ("model_1.ckpt", "model_2.ckpt")}
    save_ms = ms3(lambda: ppo.save(os.path.join(work, "ppo_save.ckpt")))
    n_params = sum(p.numel() for p in ppo.model.parameters())
    back, back_secs = run("ppo", "--max_iterations", "2", "--model_dir", "latest")
    state = lambda t: ([p.detach() for p in t.model.parameters()] + t.state.opt.mu
                       + t.state.opt.nu + [t.state.lr])
    same(state(ppo), state(back), "PPO --model_dir latest")
    if (back.state.opt.count, back.state.iteration) != (ppo.state.opt.count, 2):
        raise AssertionError("PPO resume: Adam count or iteration differs")
    load_ms = ms3(lambda: back.load(path))
    print(f"  PPO: 2 iterations in {secs:.2f} s wrote {', '.join(files)}; checkpoint sizes "
          + ", ".join(f"{f} {b} B" for f, b in sizes.items())
          + f" ({n_params} parameters); save {save_ms:.1f} ms, restore {load_ms:.1f} ms "
          f"(median of 3); --model_dir latest restored parameters, Adam moments, count "
          f"{back.state.opt.count}, lr and iteration {back.state.iteration} bit for bit "
          f"(main() {back_secs:.2f} s)")
    # (c) evaluate
    evaluate("ppo", "PPO")
    del ppo, back

    # (d) MAPPO: one iteration, restore, eval
    counters = (fs.substep_kernel, fm.fwd_kernel, fm.bwd_kernel)
    for k in counters:
        k.launches = 0
    runner, secs = run("mappo", "--max_iterations", "1")
    launches = tuple(k.launches for k in counters)
    if launches != (24, 300, 300):
        raise AssertionError(f"MAPPO iteration: B1/B2/B3 launches {launches}, expected "
                             f"(24, 300, 300)")
    md = os.path.join(work, "mappo", "seed0")
    mpath = os.path.join(md, "marl_1.ckpt")
    if not os.path.exists(mpath):
        raise AssertionError(f"MAPPO logdir holds {sorted(os.listdir(md))}")
    msave_ms = ms3(lambda: runner.save(os.path.join(work, "mappo_save.ckpt")))

    def marl_state(r):
        st = r.state
        return (tree_leaves(st.actor_params) + tree_leaves(st.critic_params) + st.actor_opt.mu
                + st.actor_opt.nu + st.critic_opt.mu + st.critic_opt.nu
                + [st.vnorm.mean, st.vnorm.mean_sq, st.vnorm.debias])
    mback, _ = run("mappo", "--max_iterations", "1", "--model_dir", "latest")
    same(marl_state(runner), marl_state(mback), "MAPPO --model_dir latest")
    if (mback.state.actor_opt.count, mback.state.iteration) != (runner.state.actor_opt.count, 1):
        raise AssertionError("MAPPO resume: Adam counts or iteration differ")
    mload_ms = ms3(lambda: mback.restore(mpath))
    print(f"  MAPPO: 1 iteration in {secs:.2f} s (B1/B2/B3 launches {launches}); marl_1.ckpt "
          f"{os.path.getsize(mpath)} B; save {msave_ms:.1f} ms, restore {mload_ms:.1f} ms "
          f"(median of 3); restored bit for bit")
    evaluate("mappo", "MAPPO")
    del runner, mback

    # (e) the viewer
    os.environ["VIEWER_STEPS"] = "50"
    try:
        _, secs = run("ppo", "--test", "--episode_length", "100", "--model_dir", "latest")
    finally:
        os.environ.pop("VIEWER_STEPS")
    html = os.path.join(d, "viewer_TenAnt.html")
    if not os.path.exists(html):
        raise AssertionError("--test without --headless wrote no viewer_TenAnt.html")
    print(f"  viewer: {html} ({os.path.getsize(html)} B, 50 steps), main() {secs:.2f} s")

    # (f) random actions
    bench = os.path.join(work, "bench.jsonl")
    fs.substep_kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    recs = cli.main(["--task", "TenAnt", "--num_envs", str(E), "--seed", "0", "--random_actions",
                     "--bench_len", "3", "--bench_file", bench])
    secs = time.perf_counter() - t0
    n_bench = fs.substep_kernel.launches
    want = (1 + 3) * cli.BENCH_CHUNK * 3
    with open(bench) as fh:
        lines = [json.loads(x) for x in fh]
    if n_bench != want or len(recs) != 3 or lines != recs:
        raise AssertionError(f"--random_actions: {n_bench} B1 launches (expected {want}), "
                             f"{len(recs)} reports, {len(lines)} lines in --bench_file")
    print(f"  --random_actions (TenAnt, E={E}, {cli.BENCH_CHUNK} steps a report): "
          + ", ".join(f"{r['env_steps_per_s']:.1f}" for r in recs)
          + f" env-steps/s; {n_bench} B1 launches; main() {secs:.2f} s")
    shutil.rmtree(work)     # ~0.5 GB of checkpoints
    print(f"phase 5e: {time.perf_counter() - t_phase:.1f} s")


def patch_train_iter(cls, wrap):
    """cls.train_iter replaced by wrap(the original); returns the undo."""
    orig = cls.train_iter
    cls.train_iter = wrap(orig)
    return lambda: setattr(cls, "train_iter", orig)


def sarl_zoo_phase(fs, fm, root, dev):
    """Phase 5f, the single-agent zoo and the other tasks, all through
    cli.train.main from cfg/ with fixed seeds, in build/smoke_5f/ (emptied
    first, removed at the end): (a) TenAnt + TRPO at E envs for 2
    iterations: per iteration exactly 24 B1 launches, cg_nsteps + 1
    Fisher-vector products, 1..max_num_backtrack line-search candidates,
    the accepted flag, a finite value loss; rollout ms, update ms,
    env-steps/s.  (b) TenAnt + SAC (6 iterations), TD3 and DDPG (10 each)
    at their YAMLs' configuration (numEnvs 128): 24 B1 per iteration, the
    collect-only warm-up iterations (batch_size slots at 8 a step), then
    noptepochs x nminibatches gradient steps per env step (SAC 32 an
    iteration, TD3/DDPG 160) and pi steps (TD3 half of them), the ring's
    device bytes, a finite q_loss; then SAC once more with --model_dir
    latest --test --headless --episode_length 100: params and target_params
    bit for bit, 300 B1.  (c) MultiAntCircle and MultiIngenuity at E envs,
    1 iteration each of MAPPO (B2/B3 launches as the update's towers run
    them, no B1: the array engine) and PPO; finite rewards and
    observations on the card.  Returns the TRPO, SAC and TD3 trainers for
    the profiles."""
    import shutil
    import torch
    from massive_marl_tpu_torch.algos.rl.offpolicy import OffPolicy
    from massive_marl_tpu_torch.algos.rl.trpo import TRPO
    from massive_marl_tpu_torch.cli import train as cli
    from massive_marl_tpu_torch.utils.tree import tree_leaves
    t_phase = time.perf_counter()
    work = os.path.join(root, "build", "smoke_5f")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)

    def run(task, algo, *extra):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = cli.main(["--task", task, "--algo", algo, "--seed", "0",
                        "--logdir", os.path.join(work, f"{task}_{algo}"), *extra])
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # (a) TRPO at E envs
    rows = []

    def trpo_timed(self):
        n0 = fs.substep_kernel.launches
        m, roll_s, upd_s = timed_iteration(self)
        rows.append((m, roll_s, upd_s, fs.substep_kernel.launches - n0, dict(self.last_search)))
        return m
    restore = patch_train_iter(TRPO, lambda orig: trpo_timed)
    try:
        trpo, secs = run("TenAnt", "trpo", "--num_envs", str(E), "--max_iterations", "2")
    finally:
        restore()
    c = trpo.cfg
    want = c.nsteps * trpo.env.spec.substeps
    for it, (m, roll_s, upd_s, n, search) in enumerate(rows):
        if n != want or search["fvps"] != c.cg_nsteps + 1 \
                or not 1 <= search["candidates"] <= c.max_num_backtrack \
                or m["accepted"] not in (0.0, 1.0) or not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"TRPO iteration {it}: {n} B1 launches (expected {want}), "
                                 f"search {search}, metrics {m}")
        print(f"  TRPO it {it}: rollout {1e3 * roll_s:.1f} ms, update {1e3 * upd_s:.1f} ms, "
              f"{c.nsteps * E / (roll_s + upd_s):.1f} env-steps/s; B1 launches {n}, "
              f"Fisher-vector products {search['fvps']}, line-search candidates "
              f"{search['candidates']}, accepted {m['accepted']:.0f}, value loss "
              f"{m['value_loss']:.4f}, rew/step {m['mean_reward']:.3f}")
    n_params = sum(p.numel() for p in trpo.actor.parameters()) + \
        sum(p.numel() for p in trpo.critic.parameters())
    print(f"  TRPO (E={E}, hidden {c.hidden}, {n_params} parameters): main() {secs:.1f} s")

    # (b) SAC, TD3, DDPG at the YAMLs' configuration
    with open(os.path.join(root, "cfg", "sac", "config.yaml")) as fh:
        text = fh.read()
    if text.count("  save_interval: 1000\n") != 1:
        raise AssertionError("cfg/sac/config.yaml: no `save_interval: 1000` line")
    sac_cfg = os.path.join(work, "sac.yaml")
    with open(sac_cfg, "w") as fh:
        fh.write(text.replace("  save_interval: 1000\n", "  save_interval: 1\n"))
    off_rows = []

    def off_timed(orig):
        def timed(self, update=True):
            torch.cuda.synchronize()
            n0, g0, p0 = fs.substep_kernel.launches, self.grad_steps, self.pi_steps
            t0 = time.perf_counter()
            m = orig(self, update)
            torch.cuda.synchronize()
            off_rows.append((update, time.perf_counter() - t0, fs.substep_kernel.launches - n0,
                             self.grad_steps - g0, self.pi_steps - p0,
                             {k: float(v) for k, v in m.items()}))
            return m
        return timed
    restore = patch_train_iter(OffPolicy, off_timed)
    trained = {}
    try:
        for algo, iters in (("sac", 6), ("td3", 10), ("ddpg", 10)):
            off_rows.clear()
            extra = ("--cfg_train", sac_cfg) if algo == "sac" else ()
            t, secs = run("TenAnt", algo, "--max_iterations", str(iters), *extra)
            c = t.cfg
            want_b1 = c.nsteps * t.env.spec.substeps
            collect = -(-c.batch_size // c.nsteps)
            steps = c.nsteps * c.noptepochs * c.nminibatches
            pi_want = steps // c.policy_delay if algo == "td3" else steps
            for it, (upd, dt, n, g, pi, m) in enumerate(off_rows):
                ok = n == want_b1 and upd == (it >= collect) and \
                    (g, pi) == ((steps, pi_want) if upd else (0, 0)) and \
                    all(math.isfinite(v) for v in m.values())
                if not ok:
                    raise AssertionError(f"{algo} iteration {it}: training {upd}, B1 {n} "
                                         f"(expected {want_b1}), gradient steps {g}, pi steps "
                                         f"{pi} (expected {steps}, {pi_want} after {collect} "
                                         f"collect-only iterations), metrics {m}")
            if len(off_rows) != iters:
                raise AssertionError(f"{algo}: {len(off_rows)} iterations, expected {iters}")
            ring = t.state.replay.nbytes()
            want_ring = c.replay_size * t.num_envs * (2 * (2 * t.obs_dim + t.act_dim) + 8)
            if ring != want_ring or not t.state.replay.obs.is_cuda:
                raise AssertionError(f"{algo}: ring of {ring} B on {t.state.replay.obs.device}, "
                                     f"expected {want_ring} B on the card")
            n_params = sum(x.numel() for x in tree_leaves(t.state.params))
            coll_ms = statistics.median(1e3 * dt for upd, dt, *_ in off_rows if not upd)
            train_ms = statistics.median(1e3 * dt for upd, dt, *_ in off_rows if upd)
            q = [r[5]["q_loss"] for r in off_rows if r[0]]
            print(f"  {algo.upper()} (E={t.num_envs}, hidden {c.hidden_nodes}x{c.hidden_layer}, "
                  f"{n_params} parameters, batch {c.batch_size} slots = "
                  f"{c.batch_size * t.num_envs} rows, R={c.replay_size}): {collect} collect-only "
                  f"iterations {coll_ms:.1f} ms (median), {iters - collect} training iterations "
                  f"{train_ms:.1f} ms (median; update ~{train_ms - coll_ms:.1f} ms), "
                  f"{c.nsteps * t.num_envs / (train_ms / 1e3):.1f} env-steps/s training; "
                  f"{steps} gradient steps and {pi_want} pi steps per training iteration, "
                  f"{want_b1} B1 per iteration; ring {ring} B on the card; q_loss "
                  + ", ".join(f"{v:.4g}" for v in q) + f"; main() {secs:.1f} s")
            trained[algo] = t
    finally:
        restore()
    sac, td3 = trained["sac"], trained["td3"]
    del trained
    fs.substep_kernel.launches = 0
    tested, secs = run("TenAnt", "sac", "--cfg_train", sac_cfg, "--test", "--headless",
                       "--episode_length", "100", "--model_dir", "latest")
    n = fs.substep_kernel.launches
    leaves = lambda tr: tree_leaves(tr.state.params) + tree_leaves(tr.state.target_params)
    same = all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(leaves(sac), leaves(tested)))
    if not same or tested.state.iteration != 6 or n != 300 or not math.isfinite(tested.last_eval):
        raise AssertionError(f"SAC --model_dir latest --test: bit for bit {same}, iteration "
                             f"{tested.state.iteration}, {n} B1, return {tested.last_eval}")
    print(f"  SAC --model_dir latest --test --headless (100 steps): params and target_params "
          f"bit for bit from model_6.ckpt "
          f"({os.path.getsize(os.path.join(work, 'TenAnt_sac', 'seed0', 'model_6.ckpt'))} B), "
          f"mean return {tested.last_eval:.3f}, {n} B1, main() {secs:.2f} s")
    del tested
    torch.cuda.empty_cache()

    # (c) the other tasks: MAPPO and PPO, one iteration each
    for task in ("MultiAntCircle", "MultiIngenuity"):
        for algo in ("mappo", "ppo"):
            counters = (fs.substep_kernel, fm.fwd_kernel, fm.bwd_kernel)
            for k in counters:
                k.launches = 0
            t, secs = run(task, algo, "--num_envs", str(E), "--max_iterations", "1")
            got = tuple(k.launches for k in counters)
            env = t.env
            obs = t.state.env_state.obs
            if algo == "mappo":
                c = t.cfg
                towers = c.ppo_epoch * max(1, c.num_mini_batch) * 2 * (t.N if t.sequential else 1)
                want = (0, (1 + c.layer_n) * towers, (1 + c.layer_n) * towers)
                m = t.last_metrics
            else:
                want, m = (0, 0, 0), t.last_metrics
            if got != want or tuple(obs.shape) != (E, env.num_obs) or not obs.is_cuda \
                    or not torch.isfinite(obs).all() or not math.isfinite(m["mean_reward"]):
                raise AssertionError(f"{task} {algo}: B1/B2/B3 launches {got} (expected {want}), "
                                     f"obs {tuple(obs.shape)} on {obs.device}, metrics {m}")
            print(f"  {task} + {algo.upper()} (E={E}, {env.num_agents} agents, obs "
                  f"{env.num_ant_obs} per agent, {env.num_obs} shared): rew/step "
                  f"{m['mean_reward']:.4f}, {m['fps']:.1f} env-steps/s, B1/B2/B3 launches {got}, "
                  f"main() {secs:.1f} s")
            del t
    shutil.rmtree(work)
    print(f"phase 5f: {time.perf_counter() - t_phase:.1f} s")
    return trpo, sac, td3


def marl_zoo_phase(fs, fm, root, dev):
    """Phase 5g, the rest of the MARL zoo on TenAnt, in build/smoke_5g/
    (emptied first, removed at its end; the modified YAMLs go there):
    (a) MAT at cfg/mat (embed 64, 2 blocks, 1 head, episode_length 8, 5
    epochs) and E envs: 1 warm-up iteration through MatRunner.run and 2
    timed through rollout_phase / update_phase, each with exactly 24 B1 and
    no B2-B5 launch and finite metrics; rollout ms, update ms, env-steps/s,
    peak memory; then the cached decode against N full decodes on the card
    at E envs, with one set of normal draws, at the CPU test's tolerance.
    (b) MADDPG through cli.train.main at cfg/maddpg (save_interval 10) and
    TenAnt.yaml's numEnvs: 10 iterations, the first 8 collect-only, then 2
    with 8 gradient steps each, 24 B1 and no B2-B5 per iteration; the
    ring's device bytes against R x E x 3,560 B (the 4.56 GB reckoned for
    the bf16 ring); then --model_dir latest --test --headless
    --episode_length 100: actors and critics bit for bit from
    maddpg_10.ckpt, 300 B1.  (c) recurrent MAPPO through cli.train.main at
    cfg/mappo with use_recurrent_policy (hidden 512, layer_N 2, L = T = 8)
    at E envs, 2 timed iterations, and recurrent HAPPO (data_chunk_length
    4, num_mini_batch 2) for 1; each iteration 24 B1 and no B2-B5 (the
    recurrent nets are the flax-mirror MLPBase).  Returns the MAT, MADDPG
    and recurrent MAPPO runners for the profiles."""
    import shutil
    import torch
    from massive_marl_tpu_torch.algos.marl.maddpg import MaddpgRunner
    from massive_marl_tpu_torch.algos.marl.mat import MatConfig, MatRunner
    from massive_marl_tpu_torch.algos.marl.recurrent_runner import RecurrentMarlRunner
    from massive_marl_tpu_torch.cli import train as cli
    from massive_marl_tpu_torch.envs.ten_ant import TenAntEnv
    from massive_marl_tpu_torch.utils import yaml_lite
    from massive_marl_tpu_torch.utils.tree import tree_leaves
    t_phase = time.perf_counter()
    work = os.path.join(root, "build", "smoke_5g")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    counters = (fs.substep_kernel, fm.fwd_kernel, fm.bwd_kernel, fm.tower_fwd_kernel,
                fm.tower_bwd_kernel)

    def zero():
        for k in counters:
            k.launches = 0

    counts = lambda: tuple(k.launches for k in counters)

    def peak_gib(held):
        """The peak since the last reset, and how far it rose above `held`
        (the bytes other phases' trainers still hold)."""
        peak = torch.cuda.max_memory_allocated()
        return (f"{peak / 2**30:.2f} GiB ({(peak - held) / 2**30:.2f} GiB above the "
                f"{held / 2**30:.2f} held before)")

    def check(label, it, got, want, m):
        if got != want or not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"{label} iteration {it}: B1-B5 launches {got} (expected "
                                 f"{want}), metrics {m}")

    def yaml_copy(algo, edits):
        with open(os.path.join(root, "cfg", algo, "config.yaml")) as fh:
            text = fh.read()
        for old, new in edits:
            if text.count(old) != 1:
                raise AssertionError(f"cfg/{algo}/config.yaml: no single {old!r}")
            text = text.replace(old, new)
        path = os.path.join(work, f"{algo}.yaml")
        with open(path, "w") as fh:
            fh.write(text)
        return path

    def run(algo, *extra):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = cli.main(["--task", "TenAnt", "--algo", algo, "--seed", "0",
                        "--logdir", os.path.join(work, algo), *extra])
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # (a) MAT at E envs
    env = TenAntEnv(device=dev, seed=0)
    mat = MatRunner(env, E, MatConfig.from_cfg_train(
        yaml_lite.load(os.path.join(root, "cfg", "mat", "config.yaml"))), seed=0, device=dev,
        print_log=False)
    c = mat.cfg
    want = (c.episode_length * env.spec.substeps, 0, 0, 0, 0)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    zero()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mat.run(c.episode_length * E)
    torch.cuda.synchronize()
    check("MAT", 0, counts(), want, mat.last_metrics)
    print(f"  MAT it 0 (warm-up, MatRunner.run): {1e3 * (time.perf_counter() - t0):.1f} ms, "
          f"B1-B5 launches {counts()}")
    rows = []
    for it in (1, 2):
        zero()
        m, roll_s, upd_s = timed_iteration(mat)
        check("MAT", it, counts(), want, m)
        rows.append((roll_s, upd_s))
        print(f"  MAT it {it}: rollout {1e3 * roll_s:.1f} ms, update {1e3 * upd_s:.1f} ms, "
              f"{c.episode_length * E / (roll_s + upd_s):.1f} env-steps/s; B1-B5 launches "
              f"{counts()}; rew/step {m['mean_reward']:.4f}, value loss {m['value_loss']:.4f}, "
              f"policy loss {m['policy_loss']:.5f}")
    n_params = sum(x.numel() for x in tree_leaves(mat.state.params))
    print(f"  MAT (E={E}, embed {c.embed}, {c.blocks} blocks, {c.heads} head, {n_params} "
          f"parameters): rollout {statistics.median(1e3 * r for r, _ in rows):.1f} ms, update "
          f"{statistics.median(1e3 * u for _, u in rows):.1f} ms (medians of 2), peak memory "
          f"{peak_gib(held)}")
    # the cached decode against N full decodes, one set of draws
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    draws = torch.randn((mat.N, E, mat.act_dim), generator=gen, device=dev)
    it_draws = iter(draws)
    mat._normal = lambda shape: next(it_draws)
    try:
        with torch.no_grad():
            rep, _ = mat.model.encode(mat.state.params, mat._obs_view(mat.state.env_state.obs))
            actions, mean, std = mat.decode_autoregressive(mat.state.params, rep)
            ref = torch.zeros_like(actions)
            for i in range(mat.N):
                prev = torch.cat([torch.zeros_like(ref[:, :1]), ref[:, :-1]], 1)
                m_full, s_full = mat.model.decode(mat.state.params, rep, prev)
                ref[:, i] = m_full[:, i] + s_full[:, i] * draws[i]
    finally:
        del mat._normal
    err = max(float((actions - ref).abs().max()), float((mean - m_full).abs().max()))
    if not (torch.allclose(actions, ref, rtol=1e-5, atol=1e-5)
            and torch.allclose(mean, m_full, rtol=1e-5, atol=1e-5) and torch.equal(std, s_full)):
        raise AssertionError(f"MAT cached decode vs full decode at E={E}: max abs err {err}")
    print(f"  MAT cached decode vs {mat.N} full decodes at E={E}: max abs err {err:.3g} "
          f"(tolerance rtol 1e-5 + atol 1e-5, as tests/test_torch_mat.py)")

    # (b) MADDPG at cfg/maddpg through the CLI
    md_yaml = yaml_copy("maddpg", [("  save_interval: 1000\n", "  save_interval: 10\n")])
    md_rows = []

    def md_timed(orig):
        def timed(self, update=True):
            torch.cuda.synchronize()
            zero()
            g0 = self.grad_steps
            t0 = time.perf_counter()
            m = orig(self, update)
            torch.cuda.synchronize()
            md_rows.append((update, time.perf_counter() - t0, counts(), self.grad_steps - g0,
                            {k: float(v) for k, v in m.items()}))
            return m
        return timed
    restore = patch_train_iter(MaddpgRunner, md_timed)
    try:
        maddpg, secs = run("maddpg", "--max_iterations", "10", "--cfg_train", md_yaml)
    finally:
        restore()
    c = maddpg.cfg
    want = (c.nsteps * maddpg.env.spec.substeps, 0, 0, 0, 0)
    collect = -(-c.batch_size // c.nsteps)
    steps = c.nsteps * c.updates_per_step
    for it, (upd, dt, got, g, m) in enumerate(md_rows):
        check("MADDPG", it, got, want, m)
        if upd != (it >= collect) or g != (steps if upd else 0):
            raise AssertionError(f"MADDPG iteration {it}: training {upd}, {g} gradient steps "
                                 f"(expected {steps} after {collect} collect-only iterations)")
    if len(md_rows) != 10:
        raise AssertionError(f"MADDPG: {len(md_rows)} iterations, expected 10")
    rp = maddpg.state.replay
    ring = rp.nbytes()
    per_row = 2 * (2 * maddpg.N * maddpg.obs_dim + 2 * maddpg.share_dim
                   + maddpg.N * maddpg.act_dim) + 2 * 4
    if ring != c.replay_size * maddpg.num_envs * per_row or not rp.obs.is_cuda \
            or rp.obs.dtype != torch.bfloat16:
        raise AssertionError(f"MADDPG ring of {ring} B ({rp.obs.dtype} on {rp.obs.device}), "
                             f"expected {c.replay_size * maddpg.num_envs * per_row} B of bf16 "
                             "rows on the card")
    coll_ms = statistics.median(1e3 * dt for upd, dt, *_ in md_rows if not upd)
    train_ms = statistics.median(1e3 * dt for upd, dt, *_ in md_rows if upd)
    print(f"  MADDPG (E={maddpg.num_envs}, hidden {c.hidden}x{c.layers}, batch {c.batch_size} "
          f"rows = {c.batch_size * maddpg.num_envs} samples, R={c.replay_size}): {collect} "
          f"collect-only iterations {coll_ms:.1f} ms (median), {len(md_rows) - collect} "
          f"training iterations {train_ms:.1f} ms (median; {steps} gradient steps each), "
          f"{c.nsteps * maddpg.num_envs / (train_ms / 1e3):.1f} env-steps/s training; B1-B5 "
          f"launches {want} per iteration; ring {ring} B on the card ({per_row} B a row x "
          f"{c.replay_size} x {maddpg.num_envs}; the bf16 ring reckoned at 4.56e9 B); critic "
          f"loss " + ", ".join(f"{r[4]['critic_loss']:.4g}" for r in md_rows if r[0])
          + f"; main() {secs:.1f} s")
    zero()
    tested, secs = run("maddpg", "--cfg_train", md_yaml, "--test", "--headless",
                       "--episode_length", "100", "--model_dir", "latest")
    n = fs.substep_kernel.launches
    leaves = lambda r: tree_leaves(r.state.actor_params) + tree_leaves(r.state.critic_params)
    same = all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(leaves(maddpg), leaves(tested)))
    path = os.path.join(work, "maddpg", "seed0", "maddpg_10.ckpt")
    if not same or tested.state.iteration != 10 or n != 300 or not math.isfinite(tested.last_eval):
        raise AssertionError(f"MADDPG --model_dir latest --test: bit for bit {same}, iteration "
                             f"{tested.state.iteration}, {n} B1, return {tested.last_eval}")
    print(f"  MADDPG --model_dir latest --test --headless (100 steps): actors and critics bit "
          f"for bit from maddpg_10.ckpt ({os.path.getsize(path)} B), mean return "
          f"{tested.last_eval:.3f}, {n} B1, main() {secs:.2f} s")
    del tested
    torch.cuda.empty_cache()

    # (c) recurrent MAPPO and HAPPO through the CLI at E envs
    rnn_rows = []

    def rnn_timed(orig):
        def timed(self):
            zero()
            m, roll_s, upd_s = timed_iteration(self)
            rnn_rows.append((m, roll_s, upd_s, counts()))
            return m
        return timed
    recurrent = [("use_recurrent_policy: false\n", "use_recurrent_policy: true\n")]
    rnn = {}
    for algo, iters, edits in (
            ("mappo", 2, recurrent),
            ("happo", 1, recurrent + [("data_chunk_length: null\n", "data_chunk_length: 4\n"),
                                      ("num_mini_batch: 1\n", "num_mini_batch: 2\n")])):
        rnn_rows.clear()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        restore = patch_train_iter(RecurrentMarlRunner, rnn_timed)
        try:
            r, secs = run(algo, "--num_envs", str(E), "--max_iterations", str(iters),
                          "--cfg_train", yaml_copy(algo, edits))
        finally:
            restore()
        c = r.cfg
        if not isinstance(r, RecurrentMarlRunner) or r.use_fused or len(rnn_rows) != iters:
            raise AssertionError(f"recurrent {algo}: {type(r).__name__}, fused {r.use_fused}, "
                                 f"{len(rnn_rows)} iterations")
        want = (c.episode_length * r.env.spec.substeps, 0, 0, 0, 0)
        for it, (m, roll_s, upd_s, got) in enumerate(rnn_rows):
            check(f"recurrent {algo}", it, got, want, m)
            print(f"  recurrent {algo.upper()} it {it}: rollout {1e3 * roll_s:.1f} ms, update "
                  f"{1e3 * upd_s:.1f} ms, {c.episode_length * E / (roll_s + upd_s):.1f} "
                  f"env-steps/s; B1-B5 launches {got}; value loss {m['value_loss']:.4f}, "
                  f"policy loss {m['policy_loss']:.5f}, rew/step {m['mean_reward']:.3f}")
        print(f"  recurrent {algo.upper()} (E={E}, hidden {c.hidden_size}, layer_N {c.layer_n}, "
              f"L={r.L} of T={c.episode_length}, {max(1, c.num_mini_batch)} minibatches): "
              f"main() {secs:.1f} s, peak memory {peak_gib(held)}")
        rnn[algo] = r
    del rnn["happo"]
    shutil.rmtree(work)
    print(f"phase 5g: {time.perf_counter() - t_phase:.1f} s")
    return mat, maddpg, rnn["mappo"]


def other_algos_phase(fs, fm, root, dev):
    """Phase 5h: the multi-task, meta and offline trainers through
    cli.train.main, with build/smoke_5h/ (emptied first, removed at the end)
    as the working directory, so ./datasets lands there (see the module
    docstring for what each part checks)."""
    import shutil
    import torch
    from massive_marl_tpu_torch.algos.metarl.maml import MAMLPPO
    from massive_marl_tpu_torch.algos.mtrl.mtppo import MTPPO
    from massive_marl_tpu_torch.algos.mtrl.mtsac import MTSAC
    from massive_marl_tpu_torch.algos.offrl import datasets
    from massive_marl_tpu_torch.algos.offrl.trainers import OfflineTrainer
    from massive_marl_tpu_torch.cli import train as cli
    t_phase = time.perf_counter()
    work = os.path.join(root, "build", "smoke_5h")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    counters = (fs.substep_kernel, fm.fwd_kernel, fm.bwd_kernel, fm.tower_fwd_kernel,
                fm.tower_bwd_kernel)

    def zero():
        for k in counters:
            k.launches = 0

    counts = lambda: tuple(k.launches for k in counters)

    def finite(label, values):
        values = list(values)
        if not all(math.isfinite(v) for v in values):
            raise AssertionError(f"{label}: non-finite values {values}")

    def on_card(label, trainer, envs):
        devs = {torch.device(trainer.device).type} | {torch.device(e.device).type for e in envs}
        if devs != {dev.type}:
            raise AssertionError(f"{label}: trainer and envs on {devs}, expected the card")

    def yaml_copy(algo, edits):
        with open(os.path.join(root, "cfg", algo, "config.yaml")) as fh:
            text = fh.read()
        for old, new in edits:
            if text.count(old) != 1:
                raise AssertionError(f"cfg/{algo}/config.yaml: no single {old!r}")
            text = text.replace(old, new)
        path = os.path.join(work, f"{algo}.yaml")
        with open(path, "w") as fh:
            fh.write(text)
        return path

    def patch(cls, name, wrap):
        orig = getattr(cls, name)
        setattr(cls, name, wrap(orig))
        return lambda: setattr(cls, name, orig)

    def timed(rows, extra=lambda self: None):
        """Wrap a method: each call timed on the host clock around
        synchronised work, counted from 0; rows get (seconds, launches,
        result, extra(self))."""
        def wrap(orig):
            def call(self, *a, **k):
                torch.cuda.synchronize()
                zero()
                t0 = time.perf_counter()
                out = orig(self, *a, **k)
                torch.cuda.synchronize()
                rows.append((time.perf_counter() - t0, counts(), out, extra(self)))
                return out
            return call
        return wrap

    def run_cli(*argv):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = cli.main(["--seed", "0", "--device", dev.type, *argv])
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    cwd = os.getcwd()
    os.chdir(work)
    try:
        # (a) MTPPO and MTTRPO on OneAnt + MultiAntCircle at cfg/ widths
        for algo in ("mtppo", "mttrpo"):
            rows = []
            undo = patch(MTPPO, "train_iter",
                         timed(rows, lambda self: dict(getattr(self, "last_search", {}))))
            try:
                tr, secs = run_cli("--algo", algo, "--num_envs", str(E), "--max_iterations", "2",
                                "--logdir", os.path.join(work, algo), "--cfg_train",
                                yaml_copy(algo, [("  save_interval: 1000\n",
                                                  "  save_interval: 2\n")]))
            finally:
                undo()
            on_card(algo, tr, tr.envs.values())
            want = (tr.cfg.nsteps * tr.envs["OneAnt"].spec.substeps, 0, 0, 0, 0)
            if len(rows) != 2 or tr.cfg.hidden != (1024, 1024, 512) or \
                    tr.task_names != ["MultiAntCircle", "OneAnt"]:
                raise AssertionError(f"{algo}: {len(rows)} iterations, hidden {tr.cfg.hidden}, "
                                     f"tasks {tr.task_names}")
            for it, (dt, got, (rews, vloss), search) in enumerate(rows):
                finite(f"{algo} iteration {it}", [float(vloss), *(float(r) for r in rews.values())])
                if got != want:
                    raise AssertionError(f"{algo} iteration {it}: B1-B5 launches {got}, expected "
                                         f"{want}")
                print(f"  {algo.upper()} it {it}: {1e3 * dt:.1f} ms, "
                      f"{tr.cfg.nsteps * E * tr.K / dt:.1f} env-steps/s (8 x {E} x {tr.K}); "
                      f"B1-B5 launches {got}; value loss {float(vloss):.4f}, rew/step "
                      + ", ".join(f"{t} {float(r):.3f}" for t, r in rews.items())
                      + (f"; {search}" if search else ""))
            path = os.path.join(work, algo, "seed0", "model_2.ckpt")
            fresh = type(tr)(tr.envs, E, tr.cfg, seed=1, device=dev, print_log=False)
            fresh.load(path)
            same = all(torch.equal(a, b) for a, b in zip(fresh.model.parameters(),
                                                         tr.model.parameters()))
            if not same or fresh.state.iteration != 2:
                raise AssertionError(f"{algo}: model_2.ckpt restored bit for bit {same}, "
                                     f"iteration {fresh.state.iteration}")
            n_params = sum(p.numel() for p in tr.model.parameters())
            print(f"  {algo.upper()} (E={E} per task, obs {tr.obs_dim}, act {tr.max_act}, "
                  f"{n_params} parameters): model_2.ckpt ({os.path.getsize(path)} B) restored "
                  f"bit for bit; main() {secs:.1f} s")
            del tr, fresh
            torch.cuda.empty_cache()

        # (b) MTSAC at the YAML's numEnvs 128
        rows = []
        undo = patch(MTSAC, "train_iter", timed(rows, lambda self: self.grad_steps))
        try:
            sac, secs = run_cli("--algo", "mtsac", "--max_iterations", "4",
                             "--logdir", os.path.join(work, "mtsac"))
        finally:
            undo()
        on_card("mtsac", sac, sac.envs.values())
        c, ring = sac.cfg, sac.state.replay
        want = (c.nsteps * sac.envs["OneAnt"].spec.substeps, 0, 0, 0, 0)
        steps = c.noptepochs * c.nminibatches
        prev = 0
        for it, (dt, got, (rews, qloss), g) in enumerate(rows):
            if got != want or g - prev != (0 if it == 0 else steps):
                raise AssertionError(f"MTSAC iteration {it}: B1-B5 launches {got} (expected "
                                     f"{want}), {g - prev} gradient steps")
            finite(f"MTSAC iteration {it}", [float(r) for r in rews.values()]
                   + ([] if qloss is None else [float(qloss)]))
            print(f"  MTSAC it {it}: {1e3 * dt:.1f} ms, {g - prev} gradient steps, B1-B5 "
                  f"launches {got}, q_loss {'-' if qloss is None else f'{float(qloss):.4g}'}")
            prev = g
        per_slot = 4 * (2 * sac.obs_dim + sac.act_dim + 2)
        nbytes = ring.nbytes()
        if len(rows) != 4 or nbytes != c.replay_size * sac.num_envs * per_slot or \
                ring.obs.device.type != dev.type or ring.obs.dtype != torch.float32:
            raise AssertionError(f"MTSAC: {len(rows)} iterations, ring {nbytes} B "
                                 f"({ring.obs.dtype} on {ring.obs.device})")
        print(f"  MTSAC (E={sac.num_envs} per task, obs {sac.obs_dim}, act {sac.act_dim}, "
              f"hidden {c.hidden_nodes}x{c.hidden_layer}, batch {c.batch_size} slots x "
              f"{sac.num_envs}): float32 ring {nbytes} B on the card ({per_slot} B a row x "
              f"{c.replay_size} x {sac.num_envs}); main() {secs:.1f} s")
        del sac, ring
        torch.cuda.empty_cache()

        # (c) the random baseline
        zero()
        rnd, secs = run_cli("--algo", "random", "--max_iterations", "2",
                         "--logdir", os.path.join(work, "random"))
        got = counts()
        on_card("random", rnd, rnd.envs.values())
        finite("random", rnd.results.values())
        if got != (2 * 8 * rnd.envs["OneAnt"].spec.substeps, 0, 0, 0, 0):
            raise AssertionError(f"random: B1-B5 launches {got}")
        print(f"  random (2 iterations x 8 steps, E={rnd.num_envs}): B1-B5 launches {got}, "
              f"mean reward/step {rnd.results}; main() {secs:.2f} s")

        # (d) MAML-PPO on TenAnt
        rows = []
        undo = patch(MAMLPPO, "meta_iter", timed(rows))
        try:
            maml, secs = run_cli("--task", "TenAnt", "--algo", "mamlppo", "--num_envs", str(E),
                              "--max_iterations", "2", "--logdir", os.path.join(work, "maml"))
        finally:
            undo()
        on_card("mamlppo", maml, [maml.env])
        c = maml.cfg
        sub = maml.env.spec.substeps
        want = (c.meta_batch_size * (c.support_steps + c.query_steps) * sub, 0, 0, 0, 0)
        if len(rows) != 2:
            raise AssertionError(f"mamlppo: {len(rows)} meta-iterations")
        for it, (dt, got, m, _) in enumerate(rows):
            finite(f"mamlppo meta-iteration {it}", [float(v) for v in m.values()])
            if got != want:
                raise AssertionError(f"mamlppo meta-iteration {it}: B1-B5 launches {got}, "
                                     f"expected {want}")
            print(f"  MAML-PPO meta-it {it}: {1e3 * dt:.1f} ms, B1-B5 launches {got}, meta loss "
                  f"{float(m['meta_loss']):.4f}, task rew/step {float(m['mean_reward']):.4f}")
        zero()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pre, post = maml.eval_adaptation(n_tasks=2)
        torch.cuda.synchronize()
        dt, got = time.perf_counter() - t0, counts()
        finite("eval_adaptation", [pre, post])
        if got != (2 * (2 * c.query_steps + c.support_steps) * sub, 0, 0, 0, 0):
            raise AssertionError(f"eval_adaptation: B1-B5 launches {got}")
        print(f"  MAML-PPO (TenAnt, E={E} per slot, {c.meta_batch_size} slots, hidden "
              f"{c.hidden}): eval_adaptation(n_tasks=2) pre {pre:.4f}, post {post:.4f}, "
              f"{1e3 * dt:.1f} ms, B1-B5 launches {got}; main() {secs:.1f} s")
        del maml
        torch.cuda.empty_cache()

        # (e) ppo_collect on OneAnt, then the offline trainers on its dataset
        zero()
        pc, secs = run_cli("--task", "OneAnt", "--algo", "ppo_collect", "--num_envs", str(E),
                        "--max_iterations", "1", "--logdir", os.path.join(work, "ppo_collect"),
                        "--cfg_train", yaml_copy("ppo_collect", [
                            ("  collect_steps: 100000\n", f"  collect_steps: {16 * E}\n")]))
        got = counts()
        on_card("ppo_collect", pc.ppo, [pc.env])
        data = datasets.load_dataset(pc.out_dir)
        shapes = {k: v.shape for k, v in data.items()}
        sub = pc.env.spec.substeps
        n = 16 * E
        if got != ((8 + 16) * sub, 0, 0, 0, 0) or shapes != {
                "states": (n, 60), "actions": (n, 8), "rewards": (n, 1), "dones": (n, 1),
                "next_states": (n, 60)}:
            raise AssertionError(f"ppo_collect: B1-B5 launches {got}, dataset {shapes}")
        finite("ppo_collect dataset", [float(abs(v).max()) for v in data.values()])
        print(f"  ppo_collect (OneAnt, E={E}, 1 iteration, then 2 chunks of 8 steps): B1-B5 "
              f"launches {got}; {len(data['states'])} transitions in {pc.out_dir} "
              f"({sum(v.nbytes for v in data.values())} B); main() {secs:.1f} s")
        del pc, data
        for algo in ("td3_bc", "bcq", "iql"):
            runs, evals = [], []
            undo_run = patch(OfflineTrainer, "run", timed(runs))
            undo_eval = patch(OfflineTrainer, "eval_online", timed(evals))
            try:
                tr, secs = run_cli("--task", "OneAnt", "--algo", algo,
                                "--logdir", os.path.join(work, algo), "--cfg_train",
                                yaml_copy(algo, [("  max_iterations: 100000\n",
                                                  "  max_iterations: 200\n"),
                                                 ("  log_interval: 1000\n",
                                                  "  log_interval: 100\n")]))
            finally:
                undo_run()
                undo_eval()
            (t_train, got_train, _, _), = runs
            (t_eval, got_eval, ret, _), = evals
            on_card(algo, tr, [])
            finite(algo, [ret, *tr.last_metrics.values()])
            if tr.state.step != 200 or got_train != (0,) * 5 or \
                    got_eval != (1000 * sub, 0, 0, 0, 0) or tr.N != 16 * E:
                raise AssertionError(f"{algo}: {tr.state.step} steps, B1-B5 launches "
                                     f"{got_train} training and {got_eval} evaluating, "
                                     f"{tr.N} rows")
            print(f"  {algo} (batch {tr.cfg.batch_size}, hidden {tr.cfg.hidden}x"
                  f"{tr.cfg.layers}, {tr.N} rows): 200 steps in {t_train:.2f} s "
                  f"({200 / t_train:.1f} steps/s), q_loss {tr.last_metrics['q_loss']:.4g}; "
                  f"eval_online (64 envs x 1000 steps) {t_eval:.2f} s, B1-B5 launches "
                  f"{got_eval}, mean reward/step {ret:.4f}; main() {secs:.1f} s")
            del tr
    finally:
        os.chdir(cwd)
    shutil.rmtree(work)
    torch.cuda.empty_cache()
    print(f"phase 5h: {time.perf_counter() - t_phase:.1f} s")


def check_ppo(ppo, it, m, launches, want, width):
    """Finite metrics and observations of width `width`; B1 and box-kernel
    launches (pairs)."""
    import torch
    obs = ppo.state.env_state.obs
    if tuple(obs.shape) != (E, width) or not torch.isfinite(obs).all():
        raise AssertionError(f"iteration {it}: bad observations {tuple(obs.shape)}")
    if not all(math.isfinite(v) for v in m.values()):
        raise AssertionError(f"iteration {it}: non-finite metrics {m}")
    if launches != want:
        raise AssertionError(f"iteration {it}: B1 and box kernel launches {launches}, "
                             f"expected {want}")
    print(f" rew/step {m['mean_reward']:.3f}, vloss {m['mean_value_loss']:.3f}, "
          f"surr {m['mean_surrogate_loss']:.4f}, lr {m['lr']:.2e}, launches B1/box {launches}")


def ppo_phase(env, label, iters, want, width, dev, twin=None):
    """PPO at E envs on `env`: 1 warm-up iteration through PPO.run, then
    `iters` through PPO.rollout_phase / update_phase; B1 and box-kernel
    host launches counted from 0 and checked against `want` (B1, box) per
    iteration whose rollout ran on the host (eagerly or captured), none
    where it replayed the rollout graph; the update graph's counters: 1
    eager update, then a capture and `iters` - 1 replays; the rollout
    graph's the same where it takes the env's rollouts, else `iters` + 1
    eager rollouts.  twin: an env made as `env` was, for a second trainer
    from the same seeds with its update and rollout graphs held off, run
    beside the first each iteration: every parameter, Adam moment, the step
    count, the lr and every metric the same bits.  Returns the trainer,
    each of the `iters` iterations' (rollout s, update s) and the (B1, box)
    host launches of the trainer's own 1 + `iters` iterations, the twin's
    left out."""
    import torch
    from massive_marl_tpu_torch.algos.rl.ppo import PPO, PPOConfig
    from massive_marl_tpu_torch.algos.rl.rollout_graph import PPORolloutGraph
    from massive_marl_tpu_torch.algos.rl.update_graph import state_tensors
    from massive_marl_tpu_torch.ops import fused_substep as fs
    ppo = PPO(env, E, PPOConfig(), seed=0, device=dev, print_log=False)
    ppo.init_state()
    eager = None
    if twin is not None:
        eager = PPO(twin, E, PPOConfig(), seed=0, device=dev, print_log=False)
        eager.init_state()
    counters = (fs.substep_kernel, fs.box_substep_kernel)
    counts = lambda: tuple(k.launches for k in counters)

    def same(it, m, m_eager):
        if eager is None:
            return
        m, m_eager = ({k: v for k, v in d.items() if k != "fps"} for d in (m, m_eager))
        differ = [i for i, (a, b) in enumerate(zip(state_tensors(ppo), state_tensors(eager)))
                  if not torch.equal(a, b)]
        if differ or m != m_eager or ppo.state.opt.count != eager.state.opt.count:
            raise AssertionError(f"{label} it {it}, graphed against eager: state leaves "
                                 f"{differ} differ, metrics {m} / {m_eager}, counts "
                                 f"{ppo.state.opt.count} / {eager.state.opt.count}")
        print(f"  {label} it {it}: graphed and eager the same bits")

    for k in counters:
        k.launches = 0
    with graph_held_off(eager) if eager is not None else contextlib.nullcontext():
        ppo.run(1)
        print(f"  {label} it 0 (warm-up, PPO.run):", end="")
        own = counts()
        check_ppo(ppo, 0, ppo.last_metrics, own, want, width)
        if eager is not None:
            eager.run(1)
            same(0, ppo.last_metrics, eager.last_metrics)
        rows = []
        rolls = ppo.rollout_graph
        for it in range(1, 1 + iters):
            before, replays = counts(), rolls.replays
            m, roll_s, upd_s = timed_iteration(ppo)
            rows.append((roll_s, upd_s))
            print(f"  {label} it {it}:", end="")
            delta = tuple(b - a for a, b in zip(before, counts()))
            own = tuple(a + d for a, d in zip(own, delta))
            check_ppo(ppo, it, m, delta, want if rolls.replays == replays else (0, 0), width)
            if eager is not None:
                same(it, m, timed_iteration(eager)[0])
    g = ppo.update_graph
    got = (g.eager_updates, g.captures, g.replays)
    if got != (1, min(iters, 1), max(iters - 1, 0)):
        raise AssertionError(f"{label}: update graph eager/captures/replays {got} after "
                             f"1 + {iters} iterations")
    print(f"  {label} update graph: {got[0]} eager, {got[1]} capture, {got[2]} replays")
    got = (rolls.eager_rollouts, rolls.captures, rolls.replays)
    refusal = PPORolloutGraph.refusal(ppo)
    if got != ((1, min(iters, 1), max(iters - 1, 0)) if refusal is None else (1 + iters, 0, 0)):
        raise AssertionError(f"{label}: rollout graph eager/captures/replays {got} after "
                             f"1 + {iters} iterations (refusal: {refusal})")
    print(f"  {label} rollout graph: {got[0]} eager, {got[1]} capture, {got[2]} replays"
          + (f" ({refusal})" if refusal else ""))
    return ppo, rows, own


def profile_rollout_replay(ppo, label):
    """One rollout of a PPO trainer whose rollout graph takes it, under
    torch.profiler (port_bench.trace): raises unless it replayed, the host
    launched no B1 or box kernel, and the trace holds nsteps x substeps of
    each.  Returns the Trace and the (B1, box) kernels in it."""
    from massive_marl_tpu_torch.ops import fused_substep as fs
    from massive_marl_tpu_torch.utils import profiling
    g = ppo.rollout_graph
    replays = g.replays
    host = (fs.substep_kernel.launches, fs.box_substep_kernel.launches)
    tr = trace.profile_iterations(ppo.rollout_phase, 1, profiling.PREFIX)
    host = tuple(b - a for a, b in zip(host, (fs.substep_kernel.launches,
                                              fs.box_substep_kernel.launches)))
    per = ppo.cfg.nsteps * ppo.env.spec.substeps
    got = (tr.kernel_time("substep_kernel")[0], tr.kernel_time("box_body_step")[0])
    if g.replays != replays + 1 or host != (0, 0) or got != (per, per):
        raise AssertionError(f"{label} rollout replay: replays {replays} -> {g.replays}, B1/box "
                             f"host launches {host}, kernels in the trace {got} (expected "
                             f"{per} each)")
    return tr, got


def rollout_graph_phase(dev, reps=10):
    """Phase 5's rollout graph at the two PPO cells' env counts, E and 4 E:
    TenAnt + PPO at full width, the rollout's wall time eagerly (the graph
    held off) and replayed, on the host clock around synchronised
    rollouts, medians of `reps` each, after one eager rollout and the
    capture; then one replay under torch.profiler (profile_rollout_replay):
    its kernels and the device's busy time."""
    import torch
    from massive_marl_tpu_torch.algos.rl.ppo import PPO, PPOConfig
    from massive_marl_tpu_torch.envs.ten_ant import TenAntEnv
    for n_env in (E, 4 * E):
        ppo = PPO(TenAntEnv(device=dev, seed=0), n_env, PPOConfig(), seed=0, device=dev,
                  print_log=False)
        ppo.init_state()

        def ms():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ppo.rollout_phase()
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t0)

        ms()        # the trainer's first rollout runs eagerly
        with graph_held_off(ppo):
            eager = [ms() for _ in range(reps)]
        capture = ms()
        replayed = [ms() for _ in range(reps)]
        g = ppo.rollout_graph
        counts = (g.eager_rollouts, g.captures, g.replays)
        if counts != (1 + reps, 1, reps):
            raise AssertionError(f"rollout graph at E={n_env}: eager/captures/replays {counts}")
        tr, got = profile_rollout_replay(ppo, f"TenAnt+PPO E={n_env}")
        print(f"PPO rollout, TenAnt E={n_env}: eager {statistics.median(eager):.3f} ms, "
              f"replayed {statistics.median(replayed):.3f} ms (medians of {reps}; the "
              f"capturing rollout {capture:.1f} ms); a replay runs {tr.launches} kernels "
              f"({got[0]} B1, {got[1]} box), device busy {1e3 * tr.busy_s:.3f} of "
              f"{1e3 * tr.window_s:.3f} ms")
        del ppo, g
        torch.cuda.empty_cache()


def print_rate(label, steps, rows, note=""):
    """Median env-steps/s, rollout and update ms of iterations of `steps`
    env-steps each; rows: (rollout s, update s) per iteration."""
    print(f"{label} E={E}: {statistics.median(steps / (r + u) for r, u in rows):.1f} env-steps/s "
          f"(median of {len(rows)}), rollout {1e3 * statistics.median(r for r, _ in rows):.1f} "
          f"ms, update {1e3 * statistics.median(u for _, u in rows):.1f} ms{note}")


def legacy_step_check(fs, dev):
    """One TenAnt step_batch with contact beta None on the kernel path: 3 B1
    launches of the legacy branch; every env finite, or reset (progress 0)."""
    import torch
    from massive_marl_tpu_torch.envs.ten_ant import TenAntEnv
    env = TenAntEnv({"sim": {"contact": {"beta": None}}}, device=dev, seed=0)
    st = env.reset(E)
    g = torch.Generator(device=dev).manual_seed(1)
    actions = torch.rand(E, 80, generator=g, device=dev) * 2 - 1
    fs.substep_kernel.launches = fs.substep_kernel.legacy_launches = 0
    out = env.step_batch(st, actions)
    torch.cuda.synchronize()
    got = (fs.substep_kernel.launches, fs.substep_kernel.legacy_launches)
    finite = all(torch.isfinite(x).all() for x in (out.obs, out.pipeline.ant_qpos,
                                                   out.pipeline.ant_qvel, out.pipeline.box_qpos))
    resets = int((out.progress == 0).sum())
    if got != (3, 3) or not finite or not bool(((out.progress == 0) | (out.progress == 1)).all()):
        raise AssertionError(f"legacy TenAnt step: B1/legacy launches {got}, finite {finite}")
    print(f"TenAnt step_batch, contact beta None (kernel path): B1 launches {got[0]}, all of the "
          f"legacy branch; every env finite after the step, {resets} of {E} reset")


def mlp_operands(N, Din, H, layer0, shared, gen, dev, width=None):
    """Operands of one fused block at the MARL update's shapes.  Layer 0
    reads feature_norm'd observations (obs 46 or share obs 388, padded) with
    the feature LayerNorm's affine; a hidden layer reads a bf16 LayerNorm
    output with ones/zeros.  Weights at the orthogonal init's scale.  With
    `width`, layer 0 reads observations of that width padded as the MARL
    update pads them (algos/marl/fused_nets.py): zero columns of x, zero
    affine and zero rows of W past the width."""
    import torch
    from massive_marl_tpu_torch.ops import fused_mlp as fm
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    rows = 1 if shared else N
    if layer0:
        x = fm.feature_norm(r(rows, MLP_B, width or (388 if shared else 46)))
        g0, b0 = 1 + 0.1 * r(N, Din), 0.1 * r(N, Din)
    else:
        x = r(rows, MLP_B, Din).to(torch.bfloat16)
        g0, b0 = torch.ones(N, Din, device=dev), torch.zeros(N, Din, device=dev)
    if shared:
        x = x.expand(N, MLP_B, Din)
    w16 = (r(N, Din, H) * (2.0 / Din) ** 0.5).to(torch.bfloat16)
    if width:
        g0[:, width:], b0[:, width:], w16[:, width:] = 0.0, 0.0, 0.0
    return dict(x=x, w16=w16, b=0.1 * r(N, H), g=1 + 0.1 * r(N, H), be=0.1 * r(N, H),
                g0=g0, b0=b0, dy=r(N, MLP_B, H).to(torch.bfloat16))


def mlp_fwd(fm, d, plain=False):
    f = fm.fwd_plain if plain else fm.fwd_kernel
    return f(d["x"], d["w16"], d["b"], d["g"], d["be"], d["g0"], d["b0"])


def mlp_bwd(fm, d, a, plain=False):
    f = fm.bwd_plain if plain else fm.bwd_kernel
    return f(d["dy"], a, d["x"], d["w16"], d["g"], d["g0"], d["b0"])


def fwd_w_l2_bytes(fm, N, Din, H, L):
    """Bytes of W that B2 (L = 1) or B4 reads from L2 in one call at
    [N, MLP_B] rows, from the design: a work item is one cluster's 64-row
    blocks of one agent, and each W tile is read once per item and
    multicast to the cluster's blocks."""
    cluster = fm.fused_mlp_lib.load().mlp_fwd_cluster_blocks()
    blocks = -(-MLP_B // 64)
    items = N * -(-blocks // cluster)
    return items * (Din * H + (L - 1) * H * H) * 2


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
    again = mlp_bwd(fm, d, ap)
    torch.cuda.synchronize()
    if not all(torch.equal(u, v) for u, v in zip(got, again)):
        raise AssertionError(f"{label}: B3 gave other bits on a second run")
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
    print(f"  {label:22s} B3 twice (need_dx both times): the same bits")
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
                bound_s, row[kind + "_by"] = mlp_roof.bound_s(
                    mlp_roof.Call(kind, N, MLP_B, din, h, need_dx=True))
                row[kind + "_bound"] = 1e3 * bound_s
                print(f"  {label:22s} {'B2' if kind == 'fwd' else 'B3'} "
                      f"{row[kind]:.4f} ms (median of 20), bound {row[kind + '_bound']:.4f} ms "
                      f"by {row[kind + '_by']}, plain {row[kind + '_plain']:.3f} ms")
            print(f"  {label:22s} note: bf16 torch.bmm of the product alone {row['bmm']:.4f} ms")
            dh16, xt = d["dy"], d["x"].contiguous()
            w_t = d["w16"].transpose(1, 2)
            row["bwd_bmm"] = time_cuda_ms(lambda: (torch.bmm(dh16, w_t),
                                                   torch.bmm(xt.transpose(1, 2), dh16)), 20)
            print(f"  {label:22s} note: B3's two products dh16 @ w^T and xt^T @ dh16 as bf16 "
                  f"torch.bmm {row['bwd_bmm']:.4f} ms (a yardstick; no one call computes B3)")
            print(f"  {label:22s} B2 reads {fwd_w_l2_bytes(fm, N, din, h, 1) / 1e6:.1f} MB of W "
                  f"from L2 ({N * din * h * 2 / 1e6:.2f} MB of W per agent set, once per cluster and "
                  f"work item)")
            if N == 1 and name == "hidden":
                print(f"  {label:22s} B2 host {host_ms(lambda: mlp_fwd(fm, d)):.4f} ms per call "
                      f"(enqueue: checks, two output allocations, 4 cached tensor maps, 1 launch)")
                row["split"] = pass_split(lambda: mlp_bwd(fm, d, a))
                print(f"  {label:22s} B3 by pass (profiler, per call): {fmt_split(row['split'])}; "
                      f"host {host_ms(lambda: mlp_bwd(fm, d, a)):.4f} ms per call (enqueue: checks, "
                      f"allocations, 4 tensor-map encodes, 5 launches)")
                main = row
            del d, a
            torch.cuda.empty_cache()
    # layer 0 of MAPPO on the other tasks: obs and share obs narrower than
    # 128, padded by the caller (one agent of the sequential schedule)
    for name, width, shared in MLP_PAD_SHAPES:
        d = mlp_operands(1, 128, 512, True, shared, gen, dev, width=width)
        err = check_mlp(fm, d, f"{name} {width}->128->512")
        worst = {k: max(worst[k], err[k]) for k in worst}
        del d
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
    elementwise work (as port_bench.roofline.fused_mlp counts B2/B3's, per
    layer) at the FP32 rate."""
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
    return roof_ms(nbytes, ew, mm) + (nbytes, mm)


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
            print(f"  {label:22s} B4 reads {fwd_w_l2_bytes(fm, N, din, TOWER_H, TOWER_L) / 1e6:.1f} "
                  f"MB of W from L2 (once per cluster and work item)")
            if N == 1 and name == "critic tower":
                print(f"  {label:22s} B4 host {host_ms(lambda: fm.tower_fwd_kernel(*args)):.4f} ms per "
                      f"call (enqueue: checks, one output allocation, 5 cached tensor maps, 1 launch)")
                row["split"] = pass_split(lambda: fm.tower_bwd_kernel(d["dy"], *args))
                print(f"  {label:22s} B5 by pass (profiler, per call): {fmt_split(row['split'])}; "
                      f"host {host_ms(lambda: fm.tower_bwd_kernel(d['dy'], *args)):.4f} ms per call "
                      f"(enqueue: checks, allocations, 13 tensor-map encodes, 9 launches)")
                xs = [d["x"].contiguous()] + [h for h, _ in acts[:-1]]

                def nine():   # forward h_l, dh16_l @ W_l^T, x_l^T @ dh16_l per layer
                    for li in range(TOWER_L):
                        torch.bmm(xs[li], d["ws16"][li])
                        torch.bmm(d["dy"], d["ws16"][li].transpose(1, 2))
                        torch.bmm(xs[li].transpose(1, 2), d["dy"])
                row["bmm9"] = time_cuda_ms(nine, 20)
                print(f"  {label:22s} note: B5's nine products as bf16 torch.bmm "
                      f"{row['bmm9']:.4f} ms (a yardstick; no one call computes B5)")
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


def offpolicy_iteration(trainer):
    """One training iteration of an off-policy trainer (env steps and
    gradient steps interleave): (metrics as floats, wall s, None)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = trainer.train_iter()
    torch.cuda.synchronize()
    return {k: float(v) for k, v in m.items()}, time.perf_counter() - t0, None


def profile_iteration(trainer, name, label, require=(), run=timed_iteration):
    """One training iteration (`run`) read as the benchmark reads its cells
    (port_bench.trace): the device's busy share (the union of its
    operations' intervals over the window), device time by kernel group and
    the longest idle gaps; every operation and gap goes to
    PROFILES/profile_<name>_iteration.txt.  require: (group, kernel
    wrapper) pairs; raises if a wrapper launched in the iteration and no
    kernel of its group shows device time.  Returns the Trace."""
    from massive_marl_tpu_torch.utils import profiling
    before = [k.launches for _, k in require]
    tr = trace.profile_iterations(lambda: run(trainer), 1, profiling.PREFIX)
    path = os.path.join(PROFILES, f"profile_{name}_iteration.txt")
    os.makedirs(PROFILES, exist_ok=True)
    with open(path, "w") as fh:
        fh.write(f"{label}: " + tr.summary())
    print(f"profile {label} (profiler on): device busy {1e3 * tr.busy_s:.3f} ms of "
          f"{1e3 * tr.window_s:.3f} ms ({100 * tr.busy_s / tr.window_s:.1f}%), {tr.launches} "
          f"kernel launches -> {path}")
    b = tr.breakdown()
    for g, t in b["device_ops"]:
        print(f"  {1e3 * t:10.3f} ms  {g}")
    for g, t in b["idle_gaps"]:
        print(f"  {1e3 * t:10.3f} ms  idle: {g}")
    for (g, k), n0 in zip(require, before):
        if k.launches > n0 and not sum(t for name, (_, t) in tr.kernels.items()
                                       if trace.kernel_group(name) == g):
            raise AssertionError(f"profile {label}: {k.launches - n0} launches of the {g} "
                                 "kernel but no device time in its group")
    return tr


# per B2-B5 wrapper (update_graph.KERNELS), the kernel it launches once a call
ROW_PASS = ("dense_fwd_wgmma", "ln_bwd_rows_wgmma", "tower_fwd_wgmma", "tower_bwd_wgmma")


def profile_replay(runner, name, label, require):
    """profile_iteration of a MARL runner whose update is a replay of its
    update graph: raises unless it replayed and the trace holds each B2-B5
    row-pass kernel as often as the capture called its wrapper.  Returns
    those counts (B2-B5)."""
    g = runner.update_graph
    replays = g.replays
    tr = profile_iteration(runner, name, label, require)
    got = [tr.kernel_time(k)[0] for k in ROW_PASS]
    if g.replays != replays + 1 or got != g.calls:
        raise AssertionError(f"profile {label}: replays {replays} -> {g.replays}, row-pass "
                             f"kernels B2-B5 {got} in the trace, the capture's calls {g.calls}")
    print(f"  {label}'s update replayed its graph: B2-B5 row-pass kernels in the trace {got}")
    return got


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
                                       "error", "C75")):
                print("  ptxas:", line.strip())


@contextlib.contextmanager
def graph_held_off(runner):
    """A context in which the MARL runner's or the PPO trainer's update
    graph refuses every update, and the PPO trainer's rollout graph every
    rollout, so that each runs eagerly; unittest.mock restores them on
    leaving."""
    from unittest import mock
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(runner.update_graph, "refusal",
                                              lambda r, perm=None: "held off"))
        if hasattr(runner, "rollout_graph"):
            stack.enter_context(mock.patch.object(runner.rollout_graph, "refusal",
                                                  lambda r: "held off"))
        yield


def graph_against_eager(make, check, counts, delta, per_iter):
    """Phase 6's comparison of MAPPO's update graph with the eager update:
    two runners from the same seeds, the second with the graph held off,
    3 iterations each in turns (eager, capture, replay on the first); every
    parameter, Adam moment, value-normaliser statistic, step count and loss
    the same bits after each.  B1-B5 host launches: the eager runner's are
    per_iter, the graphed runner's too but for the replay, which calls no
    B2-B5 wrapper.  Returns the eager runner's launches of B1-B5 over its
    3 iterations."""
    import torch
    from massive_marl_tpu_torch.algos.marl.runner import MarlConfig
    from massive_marl_tpu_torch.algos.marl.update_graph import state_tensors

    graphed, _ = make(MarlConfig())
    eager, _ = make(MarlConfig())
    eager_launches = (0,) * len(per_iter)
    with graph_held_off(eager):
        for it in range(3):
            out = []
            for r in (graphed, eager):
                before = counts()
                m, roll_s, upd_s = timed_iteration(r)
                got = delta(before)
                want = replay_launches(per_iter) if r is graphed and it == 2 else per_iter
                check(r, it, m, got, want)
                out.append((m, upd_s, [r.state.actor_opt.count, r.state.critic_opt.count]))
                if r is eager:
                    eager_launches = tuple(a + b for a, b in zip(eager_launches, got))
            (mg, ug, cg), (me, ue, ce) = out
            differ = [i for i, (a, b) in
                      enumerate(zip(state_tensors(graphed), state_tensors(eager)))
                      if not torch.equal(a, b)]
            if differ or mg != me or cg != ce:
                raise AssertionError(f"graph against eager, iteration {it}: state leaves "
                                     f"{differ} differ, losses {mg} / {me}, counts {cg} / {ce}")
            print(f"  graph against eager, it {it}: update {1e3 * ug:.1f} ms graphed, "
                  f"{1e3 * ue:.1f} ms eager; the same bits")
    g = graphed.update_graph
    print(f"MAPPO update graph against the eager update (E={E}, 3 iterations): the same bits "
          f"each iteration; {g.eager_updates} eager, {g.captures} capture, {g.replays} replay; "
          f"eager runner's launches B1-B5 {eager_launches}")
    del graphed, eager
    torch.cuda.empty_cache()
    return eager_launches


def replay_launches(per_iter):
    """The B1-B5 host launches of an iteration whose update is a replay of
    the update graph: the rollout's B1 alone."""
    return per_iter[:1] + (0,) * (len(per_iter) - 1)


def marl_phase(dev):
    """Phase 6: TenAnt + MAPPO (sequential schedule) at full width, then one
    stacked-schedule and one HAPPO iteration, MAPPO with FUSED_TOWER=1,
    HATRPO, and HATRPO with FUSED_TOWER=1.  Returns the B1-B5 wrappers'
    host launches of the MAPPO run's 4 iterations (eager, the update
    graph's capture, two replays, which call no B2/B3 wrapper) and of the
    FUSED_TOWER=1 MAPPO run's 2 (eager, capture), and the MAPPO, MAPPO
    FUSED_TOWER=1 and HATRPO runners for the profiles."""
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
    for k in counters:
        k.launches = 0
    runner.run(T * E)
    print("  MAPPO it 0 (warm-up, MarlRunner.run):", end="")
    check(runner, 0, runner.last_metrics, counts(), per_iter)
    for it in range(1, 1 + 3):      # the update graph's capture, then two replays
        before = counts()
        m, _, _ = timed_iteration(runner)
        print(f"  MAPPO it {it}:", end="")
        check(runner, it, m, delta(before), per_iter if it == 1 else replay_launches(per_iter))
    main_counts = counts()
    g = runner.update_graph
    if (g.eager_updates, g.captures, g.replays, g.calls) != (1, 1, 2, list(per_iter[1:])):
        raise AssertionError(f"MAPPO update graph: eager {g.eager_updates}, captures "
                             f"{g.captures}, replays {g.replays}, B2-B5 calls a replay "
                             f"{g.calls}; expected 1, 1, 2, {list(per_iter[1:])}")
    print(f"TenAnt+MAPPO E={E}: host launches B1-B5 "
          f"{main_counts} over 4 iterations; update graph: {g.eager_updates} eager, "
          f"{g.captures} capture, {g.replays} replays of {g.calls} B2-B5 calls each "
          "(counted on the device in phase 7)")
    graph_against_eager(make, check, counts, delta, per_iter)

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
        m, roll_s, upd_s = timed_iteration(tower)     # the update graph's capture
        print(f"  MAPPO FUSED_TOWER=1 it 1: rollout {1e3 * roll_s:.1f} ms, update "
              f"{1e3 * upd_s:.1f} ms ({T * E / (roll_s + upd_s):.1f} env-steps/s);", end="")
        check(tower, 1, m, delta(before), want)
        tower_counts = counts()
        if tower.update_graph.calls != list(want[1:]):
            raise AssertionError(f"MAPPO FUSED_TOWER=1 update graph: B2-B5 calls a replay "
                                 f"{tower.update_graph.calls}, expected {list(want[1:])}")
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
    print_rate("TenAnt+HATRPO", T * E, rows,
               f" (B2/B3 per iteration within [{lo2}, {hi2}] x [{lo3}, {hi3}])")

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


# ---------------------------------------------------------------- phase 8
P8_ITERS = 2          # iterations of each phase-8 run
P8_ROWS_OFF = 1e-4    # an entry off by more than this is counted (printed)


def p8_trainers(dev, mesh):
    """(PPO, MAPPO) at full width (E envs, PPOConfig(), MarlConfig()) on
    TenAnt envs of seed 0, with `mesh` (None: one process alone)."""
    from massive_marl_tpu_torch.algos.marl.runner import MarlConfig, MarlRunner
    from massive_marl_tpu_torch.algos.rl.ppo import PPO, PPOConfig
    from massive_marl_tpu_torch.envs.ten_ant import TenAntEnv
    return (PPO(TenAntEnv(device=dev, seed=0), E, PPOConfig(), seed=0, device=dev,
                print_log=False, mesh=mesh),
            MarlRunner(TenAntEnv(device=dev, seed=0), E, MarlConfig(), seed=0, device=dev,
                       print_log=False, mesh=mesh))


def p8_state(t):
    """(parameters, optimizer state) of a phase-8 trainer as tensor lists."""
    from massive_marl_tpu_torch.utils.tree import tree_leaves
    if hasattr(t, "model"):
        return list(t.model.parameters()), t.state.opt.mu + t.state.opt.nu
    st = t.state
    return (tree_leaves(st.actor_params) + tree_leaves(st.critic_params),
            st.actor_opt.mu + st.actor_opt.nu + st.critic_opt.mu + st.critic_opt.nu)


def p8_run(t, mesh=None):
    """P8_ITERS timed iterations of a phase-8 trainer: per iteration the
    metrics, the B1/B2/B3 launches and (under a mesh) the all-reduces and
    their bytes; the parameters on the host before and after, and
    env-steps/s."""
    import torch
    from massive_marl_tpu_torch.ops import fused_mlp as fm
    from massive_marl_tpu_torch.ops import fused_substep as fs
    from massive_marl_tpu_torch.utils.tree import tree_leaves
    counters = (fs.substep_kernel, fm.fwd_kernel, fm.bwd_kernel)
    t.init_state()
    flat = lambda: torch.cat([p.detach().float().reshape(-1) for p in p8_state(t)[0]]).cpu()
    start = flat()
    actor = (sum(p.numel() for p in tree_leaves(t.state.actor_params))
             if hasattr(t.state, "actor_params") else None)
    iters = []
    for _ in range(P8_ITERS):
        for k in counters:
            k.launches = 0
        c0, b0 = (mesh.collectives, mesh.bytes_reduced) if mesh is not None else (0, 0)
        m, roll_s, upd_s = timed_iteration(t)
        iters.append(dict(metrics=m, s=roll_s + upd_s,
                          launches=tuple(k.launches for k in counters),
                          collectives=(mesh.collectives - c0) if mesh is not None else 0,
                          bytes=(mesh.bytes_reduced - b0) if mesh is not None else 0))
    rows = t.state.env_state.obs.shape[0]
    sps = P8_ITERS * 8 * E / sum(i["s"] for i in iters)
    return dict(iters=iters, params=flat(), start=start, rows=rows, sps=sps, actor=actor)


def p8_want(name):
    """B1/B2/B3 launches of one phase-8 iteration (phases 5 and 6)."""
    return (24, 0, 0) if name == "ppo" else (24, 300, 300)


def p8_other_order(t):
    """A context in which the one-process trainer `t` sums in another
    order: every product on the other BLAS library (cuBLAS / cuBLASLt:
    other tiles and K splits), bf16 products with the other
    reduced-precision setting of their split-K reductions, and for MAPPO
    the update's batch rows in another order, a fixed random permutation
    (the same rows, so the same update, summed in another order by B3,
    the heads and the loss means)."""
    import contextlib

    import torch

    def reordered(fn):
        def run(data, share, *a):
            g = torch.Generator(device=share.device)
            g.manual_seed(7)
            p = torch.randperm(share.shape[0], generator=g, device=share.device)
            return fn({k: v[:, p] for k, v in data.items()}, share[p], *a)
        return run

    @contextlib.contextmanager
    def ctx():
        flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
        lib = torch.backends.cuda.preferred_blas_library()
        torch.backends.cuda.preferred_blas_library(
            "cublas" if "lt" in str(lib).lower() else "cublaslt")
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = not flag
        marl = hasattr(t, "_sequential")
        if marl:
            t._sequential, t._stacked = reordered(t._sequential), reordered(t._stacked)
        try:
            # the update graph would fix the library and the rows' order at
            # its capture, and draws no permutation inside it
            with graph_held_off(t) if marl else contextlib.nullcontext():
                yield
        finally:
            torch.backends.cuda.preferred_blas_library(lib)
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
            for attr in ("_sequential", "_stacked"):
                t.__dict__.pop(attr, None)
    return ctx()


P8_ROWS_RULE = {"ppo": ("obs", "actions", "mean", "logp", "reward", "done"),
                "mappo": ("obs", "share", "actions", "logp", "values", "reward", "done")}


def p8_rows_rule(dev):
    """The rows rule on the card: PPO's and MAPPO's first rollout in one
    process against the same on each rank of a 2-rank layout (Mesh(2, 1,
    r): the rank's envs and its draws over the global env axis; a rollout
    runs no collective): per trajectory field the entries that differ.
    Raises if a field of P8_ROWS_RULE differs (PPO's critic values are
    float32 cuBLAS products, whose bits cuBLAS may set by the row count)."""
    import torch
    from massive_marl_tpu_torch.parallel.mesh import Mesh
    for i, name in enumerate(("ppo", "mappo")):
        one = p8_trainers(dev, None)[i]
        one.init_state()
        full = one.rollout_phase()
        del one
        parts = []
        for r in range(2):
            t = p8_trainers(dev, Mesh(2, 1, r))[i]
            t.init_state()
            parts.append(t.rollout_phase())
            del t
        differ = {k: (int((v != torch.cat([p[k] for p in parts], 1)).sum()), v.numel())
                  for k, v in full.items()}     # [T, E, ...]
        print(f"  {name} rollout, one process against 2 ranks' rows (entries that differ): " +
              "; ".join(f"{k} {n} of {tot}" for k, (n, tot) in differ.items()))
        bad = [k for k in P8_ROWS_RULE[name] if differ[k][0]]
        if bad:
            raise AssertionError(f"8a {name}: a rank's rollout differs from one process's rows "
                                 f"in {bad}")
        torch.cuda.empty_cache()


def p8_dist(got, ref):
    """`got`'s parameters against `ref`'s: the largest |difference|, the
    entries beyond P8_ROWS_OFF, and the difference's norm over the
    distance `ref`'s training moved its parameters (`rel`; for MAPPO also
    its actor's and its critic's apart)."""
    d = (got["params"] - ref["params"]).abs()
    moved = ref["params"] - ref["start"]
    out = dict(max=float(d.max()), off=int((d > P8_ROWS_OFF).sum()),
               rel=float(d.norm() / moved.norm()))
    if ref.get("actor"):
        k = ref["actor"]
        out.update(actor=float(d[:k].norm() / moved[:k].norm()),
                   critic=float(d[k:].norm() / moved[k:].norm()))
    return out


def p8_spread(ref, alt):
    """The one-process run's own spread under another summation order
    (`alt`, run under p8_other_order): per iteration and metric the
    |difference|, and p8_dist of the parameters."""
    return dict(p8_dist(alt, ref),
                metrics=[{k: abs(a["metrics"][k] - v) for k, v in r["metrics"].items()}
                         for r, a in zip(ref["iters"], alt["iters"])])


def p8_agrees(label, got, ref, spread):
    """Whether a phase-8 run agrees with the one-process run `ref` of the
    same seeds: the same initial parameters bit for bit, and within the
    trainer's own spread under another summation order (p8_spread) each
    metric within 1e-4 + 1e-3 |ref| + 3 x its spread, and the parameters'
    difference, over the distance training moved them, within 3 x the
    spread's (an update that went elsewhere is off by about the distance
    moved).  Prints the reading."""
    import torch
    ok = bool(torch.equal(got["start"], ref["start"]))
    if not ok:
        print(f"  {label}: the initial parameters differ from one process's")
    for it, (g, r) in enumerate(zip(got["iters"], ref["iters"])):
        for k, v in r["metrics"].items():
            tol = 1e-4 + 1e-3 * abs(v) + 3.0 * spread["metrics"][it][k]
            if not math.isfinite(g["metrics"][k]) or abs(g["metrics"][k] - v) > tol:
                print(f"  {label} iteration {it}: {k} {g['metrics'][k]} vs {v} "
                      f"(tolerance {tol:.3g})")
                ok = False
    d = p8_dist(got, ref)
    ok = ok and d["rel"] <= 3.0 * spread["rel"]
    print(f"  {label}: parameters {'within' if ok else 'BEYOND'} the tolerance: |diff| "
          f"{100 * d['rel']:.3f}% of the distance moved (own spread {100 * spread['rel']:.3f}%,"
          f" limit {300 * spread['rel']:.3f}%); max |diff| {d['max']:.3e} (spread "
          f"{spread['max']:.3e}), {d['off']} entries beyond {P8_ROWS_OFF:g} (spread "
          f"{spread['off']})" + (f"; actor {100 * d['actor']:.3f}%, critic "
                                 f"{100 * d['critic']:.3f}%" if "actor" in d else ""))
    return ok


def p8_check(label, got, ref, spread):
    """p8_agrees, raising when the run does not agree."""
    if not p8_agrees(label, got, ref, spread):
        raise AssertionError(f"{label}: beyond the tolerance of its own spread")


def p8_print_iters(label, res):
    for it, i in enumerate(res["iters"]):
        m = i["metrics"]
        print(f"  {label} it {it}: {1e3 * i['s']:.1f} ms; launches B1/B2/B3 {i['launches']}; "
              f"{i['collectives']} all-reduces, {i['bytes'] / 1e6:.3f} MB; rew/step "
              f"{m['mean_reward']:.4f}, " + ", ".join(
                  f"{k} {v:.5g}" for k, v in m.items() if "loss" in k))


def nccl_profile(t, mesh, label):
    """One more iteration of a mesh trainer under torch.profiler: the
    device time of the NCCL kernels and the all-reduces' bytes."""
    from massive_marl_tpu_torch.utils import profiling
    c0, b0 = mesh.collectives, mesh.bytes_reduced
    tr = trace.profile_iterations(lambda: timed_iteration(t), 1, profiling.PREFIX)
    n, s = tr.kernel_time("nccl")
    print(f"  {label} NCCL (profiler on, one iteration): {mesh.collectives - c0} all-reduces, "
          f"{(mesh.bytes_reduced - b0) / 1e6:.3f} MB, {n} NCCL kernels, {1e3 * s:.3f} device ms")


def phase8a(dev):
    """Phase 8a: one process, NCCL at world size 1: PPO and MAPPO with the
    mesh against the same seeds without one, each within its own spread.
    Returns the one-process runs and their spreads (phase 8b's
    references)."""
    import torch
    import torch.distributed as dist
    from massive_marl_tpu_torch.parallel import launch as launch_mod
    from massive_marl_tpu_torch.parallel import mesh as meshlib
    t_phase = time.perf_counter()
    ref, spread = {}, {}
    for name, t in zip(("ppo", "mappo"), p8_trainers(dev, None)):
        ref[name] = p8_run(t)
        if any(i["launches"] != p8_want(name) for i in ref[name]["iters"]):
            raise AssertionError(f"8a {name} without a mesh: launches "
                                 f"{[i['launches'] for i in ref[name]['iters']]}")
        p8_print_iters(f"{name} (no mesh)", ref[name])
        del t
    p8_rows_rule(dev)
    for name, t in zip(("ppo", "mappo"), p8_trainers(dev, None)):
        with p8_other_order(t):
            spread[name] = p8_spread(ref[name], p8_run(t))
        print(f"  {name} (no mesh, another summation order, p8_other_order): "
              f"{spread[name]['off']} parameter entries beyond {P8_ROWS_OFF:g}, max "
              f"{spread[name]['max']:.3e}, {100 * spread[name]['rel']:.3f}% of the distance "
              "moved; metric spread " + "; ".join(
                  ", ".join(f"{k} {v:.3g}" for k, v in m.items())
                  for m in spread[name]["metrics"]))
        del t
    torch.cuda.empty_cache()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{launch_mod.free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = meshlib.make_mesh()
        print(f"  mesh {mesh.shape}, backend {mesh.backend}")
        for name, t in zip(("ppo", "mappo"), p8_trainers(dev, mesh)):
            got = p8_run(t, mesh)
            p8_print_iters(f"{name} (NCCL mesh of 1)", got)
            if any(i["launches"] != p8_want(name) for i in got["iters"]):
                raise AssertionError(f"8a {name}: launches {[i['launches'] for i in got['iters']]}"
                                     f", expected {p8_want(name)} per iteration")
            p8_check(f"8a {name}", got, ref[name], spread[name])
            nccl_profile(t, mesh, f"8a {name}")
            del t
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    print(f"phase 8a: {time.perf_counter() - t_phase:.1f} s")
    return ref, spread


def gloo_cuda_probe():
    """Which collectives gloo takes on CUDA tensors (mesh.py copies every
    gloo collective of a CUDA tensor through the host either way): each is
    called with a CUDA tensor; a refusal is recorded with its message."""
    import torch
    import torch.distributed as dist
    x, n = torch.ones(4, device="cuda"), dist.get_world_size()
    calls = (("all_reduce", lambda: dist.all_reduce(x.clone())),
             ("broadcast", lambda: dist.broadcast(x.clone(), 0)),
             ("all_gather", lambda: dist.all_gather([torch.empty_like(x) for _ in range(n)], x)),
             ("reduce_scatter", lambda: dist.reduce_scatter(
                 torch.empty_like(x), [x.clone() for _ in range(n)])))
    out = {}
    for name, call in calls:
        try:
            call()
            torch.cuda.synchronize()
            out[name] = "taken"
        except (RuntimeError, ValueError) as e:     # the probe's answer, printed
            out[name] = f"refused ({type(e).__name__}: {str(e).splitlines()[0][:100]})"
    return out


def phase8_rank(out_path) -> int:
    """A rank of phase 8b (`python -m chip_smoke --phase8-rank OUT`, started
    by parallel/launch.py): PPO and MAPPO on its E / 2 envs; rank 0 saves
    the runs to OUT."""
    import hashlib

    import torch
    import torch.distributed as dist
    from massive_marl_tpu_torch.parallel import mesh as meshlib
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not meshlib.init_distributed(device="cuda"):
        raise AssertionError("phase 8b: a rank started without MMT_NUM_PROCESSES > 1")
    mesh = meshlib.make_mesh()
    res = {"probe": gloo_cuda_probe(), "backend": mesh.backend, "device":
           torch.cuda.current_device()}
    for name, t in zip(("ppo", "mappo"), p8_trainers(torch.device("cuda"), mesh)):
        res[name] = p8_run(t, mesh)
        h = hashlib.sha256()
        for x in sum(p8_state(t), []):
            h.update(x.detach().float().cpu().numpy().tobytes())
        digests = [None] * dist.get_world_size()
        dist.all_gather_object(digests, h.hexdigest())
        res[name]["digests"] = digests
        del t
        torch.cuda.empty_cache()
    if mesh.rank == 0:
        torch.save(res, out_path)
    dist.destroy_process_group()
    return 0


def phase8b(root, ref, spread):
    """Phase 8b: two ranks sharing the one card (parallel/launch.py,
    gloo over CUDA tensors through the host), PPO and MAPPO at global
    E = 2 x E / 2 against the one-process runs of phase 8a, each within
    its own spread."""
    import torch
    from massive_marl_tpu_torch.parallel import launch as launch_mod
    t_phase = time.perf_counter()
    out = os.path.join(root, "build", "phase8b_rank0.pt")
    if os.path.exists(out):
        os.remove(out)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root, os.environ.get("PYTHONPATH", "")]))
    env.pop("OMP_NUM_THREADS", None)
    rc = launch_mod.launch(2, ["--phase8-rank", out], backend="gloo", module="chip_smoke",
                           timeout=600, env=dict(env, OMP_NUM_THREADS="2"))
    if rc != 0:
        raise AssertionError(f"phase 8b: a rank exited with {rc}")
    got = torch.load(out)
    print(f"  2 ranks, backend {got['backend']}, both on cuda:{got['device']}; gloo on CUDA "
          "tensors: " + ", ".join(f"{k} {v}" for k, v in got["probe"].items()))
    for name in ("ppo", "mappo"):
        g = got[name]
        p8_print_iters(f"{name} (rank 0 of 2)", g)
        if g["rows"] != E // 2:
            raise AssertionError(f"8b {name}: rank 0 held {g['rows']} env rows, not {E // 2}")
        if any(i["launches"] != p8_want(name) for i in g["iters"]):
            raise AssertionError(f"8b {name}: launches {[i['launches'] for i in g['iters']]}, "
                                 f"expected {p8_want(name)} per iteration and rank")
        if len(set(g["digests"])) != 1:
            raise AssertionError(f"8b {name}: the ranks' parameters or optimizer state differ")
        p8_check(f"8b {name}", g, ref[name], spread[name])
        print(f"  8b {name}: {g['rows']} env rows a rank, parameters and optimizer state "
              f"identical on both ranks; {g['sps']:.1f} global env-steps/s over "
              f"{P8_ITERS} iterations (two ranks share one card and gloo copies through the "
              "host: not a scaling figure)")
    print(f"phase 8b: {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from massive_marl_tpu_torch.algos.rl.ppo import PPOConfig
    from massive_marl_tpu_torch.envs.ten_ant import TenAntEnv
    from massive_marl_tpu_torch.ops import fused_mlp as fm
    from massive_marl_tpu_torch.ops import fused_substep as fs
    # the plain versions' float32 products in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. the card
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = f"{kind}, {harness.power_limit()}"
    print(card)
    print(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- 2. build
    build_all([fs.substep_kernel, fm.fused_mlp_lib, fm.fused_tower_lib])
    print("substep kernel occupancy: " + ", ".join(
        f"{name} {n} blocks/SM x {threads} threads"
        for name, (n, threads) in fs.substep_kernel.occupancy().items()))

    # ---- 3. B1 vs plain version at the main path's shapes
    env = TenAntEnv(device=dev, seed=0)
    c_box = env.substep_consts
    c_nobox = fs.scene_consts(env.spec._replace(box_sys=None, box_half_extents=None))
    ops = make_states(env, E, 1, dev)
    B = E * A
    print(f"B1 vs plain at E={E} (B={B} articulations):")
    b1_row = {"err": max(check_kernel(fs, c_box, ops, "box"),
                         check_kernel(fs, c_nobox, ops, "no-box")),
              "ms": time_cuda_ms(lambda: fs.substep_kernel(c_box, A, *ops), KERNEL_REPS),
              "plain_ms": time_cuda_ms(lambda: fs.substep_plain(c_box, A, *ops), PLAIN_REPS,
                                       warmup=1)}
    # the benchmark's bound holds only while its counts are B1's own
    per_ant, n_table = ops_per_articulation(fs, c_box, env), c_box.device_table(dev).numel()
    if (per_ant, n_table) != (b1_roof.OPS_PER_ARTICULATION, b1_roof.TABLE_FLOATS):
        raise AssertionError(f"B1: {per_ant} operations an articulation and a {n_table}-float "
                             f"table; port_bench/roofline/b1.py counts "
                             f"{b1_roof.OPS_PER_ARTICULATION} and {b1_roof.TABLE_FLOATS}")
    bound_s, b1_row["by"] = b1_roof.bound_s(B, E)
    b1_row["bound"] = 1e3 * bound_s
    print(f"  kernel {b1_row['ms']:.4f} ms (median of {KERNEL_REPS}), plain "
          f"{b1_row['plain_ms']:.2f} ms (median of {PLAIN_REPS}); "
          f"{fmt_bound(b1_row['bound'], b1_row['by'])} (port_bench.roofline.b1; {per_ant:.0f} "
          f"ops/articulation as the benchmark counts, a {n_table}-float table)")
    del ops

    # ---- 3b. B1's legacy branch and B6 vs their plain versions
    _, b6_row = legacy_phase(fs, env, dev)

    # ---- 3c. the debug tool on the card
    b6_launches = debug_tool_phase(fs)

    # ---- 3d. B1's DR instantiation vs its plain version; 3e. the two paths with one DrSample
    dr_row = dr_kernel_phase(fs, env, root, dev)
    dr_paths_phase(fs, root, dev)
    torch.cuda.empty_cache()

    # ---- 3f. the push-box kernel vs the plain box_substep
    box_row = box_kernel_phase(fs, root, dev)

    # ---- 4. B2/B3 vs plain versions at the MARL update's shapes
    print(f"B2/B3 vs plain at B={MLP_B} rows per agent:")
    mlp_err, mlp_main = mlp_phase(fm, dev)

    # ---- 4b. B4/B5 vs plain versions at the MARL update's tower shapes
    print(f"B4/B5 vs plain at B={MLP_B} rows per agent:")
    tower_err, tower_main = tower_phase(fm, dev)

    # ---- 5. TenAnt + PPO at full width (the benchmark's tenant-ppo.e4096 times it)
    env = TenAntEnv(device=dev, seed=0)
    per_iter = PPOConfig().nsteps * env.spec.substeps
    print("TenAnt+PPO (kernel path):")
    ppo, _, (ppo_launches, box_launches) = ppo_phase(
        env, "TenAnt+PPO", 3, (per_iter, per_iter), 388, dev, twin=TenAntEnv(device=dev, seed=0))
    # B1 and box launches: the host's (the trainer's eager and capturing
    # rollouts) and the kernels of one of its replays, traced
    _, (replay_b1, replay_box) = profile_rollout_replay(ppo, "TenAnt+PPO")
    print(f"  TenAnt+PPO rollout replay traced: {replay_b1} B1, {replay_box} box kernels")
    ppo_launches += replay_b1
    box_launches += replay_box
    rollout_graph_phase(dev)

    # ---- 5b. TenAnt + PPO on the array engine; one legacy step on the kernel
    print("TenAnt+PPO on the array engine (sim.fused_kernel false):")
    ppo_arr, rows, _ = ppo_phase(TenAntEnv({"sim": {"fused_kernel": False}}, device=dev, seed=0),
                                 "TenAnt+PPO array path", 1, (0, 0), 388, dev)
    print_rate("TenAnt+PPO array path", ppo_arr.cfg.nsteps * E, rows)
    legacy_step_check(fs, dev)
    torch.cuda.empty_cache()

    # ---- 5c. OneAnt + PPO
    from massive_marl_tpu_torch.envs.one_ant import OneAntEnv
    print("OneAnt+PPO (kernel path, sensors):")
    ppo_one, rows, _ = ppo_phase(OneAntEnv(device=dev, seed=0), "OneAnt+PPO", 2,
                                 (per_iter, per_iter), 60, dev)
    print_rate("OneAnt+PPO", ppo_one.cfg.nsteps * E, rows)
    torch.cuda.empty_cache()

    # ---- 5d. the slice's path: TenAnt + PPO with domain randomization through the CLI
    print("TenAnt+PPO --randomize through cli.train (cfg/TenAnt.yaml, cfg/ppo/config.yaml):")
    dr_launches, ppo_dr = cli_dr_phase(fs, root, dev)
    torch.cuda.empty_cache()

    # ---- 5e. the trainer's files on the card: checkpoints, logs, eval, viewer, random actions
    print("the trainer's files through cli.train (checkpoints, logs, evaluation):")
    trainer_files_phase(fs, root, dev)
    torch.cuda.empty_cache()

    # ---- 5f. TRPO and the off-policy trainers on TenAnt; MultiAntCircle, MultiIngenuity
    print("the single-agent zoo and the other tasks through cli.train (cfg/):")
    sarl = sarl_zoo_phase(fs, fm, root, dev)
    torch.cuda.empty_cache()

    # ---- 5g. MAT, MADDPG and the recurrent runner on TenAnt
    print("the rest of the MARL zoo on TenAnt (cfg/mat, cfg/maddpg, recurrent cfg/mappo, happo):")
    zoo = marl_zoo_phase(fs, fm, root, dev)
    torch.cuda.empty_cache()

    # ---- 5h. the multi-task, meta and offline trainers through the CLI
    print("the multi-task, meta and offline trainers through cli.train (cfg/, build/smoke_5h/):")
    other_algos_phase(fs, fm, root, dev)

    # ---- 6. TenAnt + MAPPO (then stacked, HAPPO, FUSED_TOWER=1, HATRPO) at full width
    marl_counts, tower_counts, (runner, tower, trpo) = marl_phase(dev)

    # ---- 7. where the time goes (port_bench.run --trace 1 reads the two cells)
    rollout_step_parts(ppo)
    del ppo
    profile_iteration(ppo_dr, "dr", "PPO --randomize (CLI)")
    rollout_step_parts(ppo_dr)
    del ppo_dr
    profile_iteration(ppo_arr, "array", "PPO array path")
    sarl_trpo, sac, td3 = sarl
    del sarl
    profile_iteration(sarl_trpo, "trpo", "TRPO")
    for name, t in (("SAC", sac), ("TD3", td3)):
        profile_iteration(t, name.lower(), f"{name} training iteration (E={t.num_envs})",
                          run=offpolicy_iteration)
    del sarl_trpo, sac, td3, t
    profile_iteration(ppo_one, "one_ant", "OneAnt PPO")
    del ppo_arr, ppo_one
    mat, maddpg, rnn_mappo = zoo
    del zoo
    profile_iteration(mat, "mat", "MAT")
    profile_iteration(maddpg, "maddpg", f"MADDPG training iteration (E={maddpg.num_envs})",
                      run=offpolicy_iteration)
    profile_iteration(rnn_mappo, "rnn_mappo", "recurrent MAPPO")
    del mat, maddpg, rnn_mappo
    b2_req = (("B2 dense_elu_ln fwd", fm.fwd_kernel),)
    marl_replay = profile_replay(runner, "mappo", "MAPPO", b2_req)
    profile_iteration(trpo, "hatrpo", "HATRPO", b2_req)
    os.environ["FUSED_TOWER"] = "1"
    try:
        tower_replay = profile_replay(tower, "mappo_tower", "MAPPO FUSED_TOWER=1",
                                      (("B4 mlp_tower fwd", fm.tower_fwd_kernel),))
    finally:
        os.environ.pop("FUSED_TOWER")
    del runner, tower, trpo
    torch.cuda.empty_cache()

    # ---- 8. data parallelism: NCCL at world size 1, then two ranks on the one card
    print(f"phase 8a: TenAnt + PPO and + MAPPO at E={E}, {P8_ITERS} iterations each, without "
          "a mesh and with an NCCL mesh of world size 1:")
    p8_ref, p8_spread_ = phase8a(dev)
    print(f"phase 8b: the same on 2 ranks sharing the card (parallel/launch.py --backend gloo), "
          f"E={E // 2} envs a rank:")
    phase8b(root, p8_ref, p8_spread_)

    print(card)
    # B2-B5 launches: the wrappers' host calls (eager updates and captures,
    # phase 6) and the row-pass kernels of the replay traced in phase 7
    mlp_launches = [h + r for h, r in zip(marl_counts[1:], marl_replay)]
    tower_launches = [h + r for h, r in zip(tower_counts[1:], tower_replay)]
    entry = lambda name, src, replaces, n, row: {
        "name": name, "route": "cuda", "source": f"massive_marl_tpu_torch/ops/csrc/{src}",
        "replaces": replaces, "launches": n, "max_abs_err": row["err"], "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound"], "bound_by": row["by"],
        "library_ms": None}
    pick = lambda err, main, kind: {"err": err[kind], "ms": main[kind],
                                    "plain_ms": main[kind + "_plain"],
                                    "bound": main[kind + "_bound"], "by": main[kind + "_by"]}
    jax_mlp = "massive_marl_tpu/ops/fused_mlp.py:"
    print(json.dumps({"kernels": [
        entry("ant_substep", "substep.cu", "massive_marl_tpu/ops/fused_substep.py:114",
              ppo_launches, b1_row),
        entry("ant_substep_dr", "substep.cu", "massive_marl_tpu/ops/fused_substep.py:114",
              dr_launches, dr_row),
        entry("dense_elu_ln_fwd", "fused_mlp.cu", jax_mlp + "46", mlp_launches[0],
              pick(mlp_err, mlp_main, "fwd")),
        entry("dense_elu_ln_bwd", "fused_mlp.cu", jax_mlp + "66", mlp_launches[1],
              pick(mlp_err, mlp_main, "bwd")),
        entry("mlp_tower_fwd", "fused_tower.cu", jax_mlp + "265", tower_launches[2],
              pick(tower_err, tower_main, "fwd")),
        entry("mlp_tower_bwd", "fused_tower.cu", jax_mlp + "288", tower_launches[3],
              pick(tower_err, tower_main, "bwd")),
        entry("box_substep", "substep.cu", None, box_launches, box_row),
        entry("debug_substep", "substep.cu", "scripts/debug_fused_tpu.py:134", b6_launches,
              dict(b6_row[1024], err=b6_row["err"]))]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase8-rank"]:
        sys.exit(phase8_rank(sys.argv[2]))
    sys.exit(main())
