"""CLI trainer of the port (twin of massive_marl_tpu/cli/train.py): the
single-agent algorithms PPO, TRPO, DDPG, TD3 and SAC on every task (OneAnt,
TenAnt, MultiAntCircle, MultiIngenuity; a task of many agents through its
joint-action interface), MAPPO/IPPO/HAPPO/HATRPO (with GRU policies
when the train YAML sets use_recurrent_policy), MAT and MADDPG on the tasks
of many agents, the multi-task trainers MTPPO, MTTRPO, MTSAC and the
random baseline over the train YAML's `tasks` (default OneAnt +
MultiAntCircle), MAML-PPO on --task, and the offline family: ppo_collect
writes a dataset under ./datasets, TD3+BC, BCQ and IQL train on it and then
evaluate online on --task.

    python -m massive_marl_tpu_torch.cli.train --task TenAnt --algo ppo \
        --num_envs 4096 --max_iterations 100 [--randomize] [--logdir DIR]
    python -m massive_marl_tpu_torch.cli.train --task TenAnt --algo mappo \
        --num_envs 4096 --num_env_steps 2000000
    python -m massive_marl_tpu_torch.cli.train --task TenAnt --algo mat \
        --num_envs 4096 --max_iterations 100
    python -m massive_marl_tpu_torch.cli.train --task TenAnt --algo maddpg \
        --max_iterations 100
    python -m massive_marl_tpu_torch.cli.train --task TenAnt --algo mappo \
        --cfg_train my_recurrent_mappo.yaml --num_envs 4096 --max_iterations 10
    python -m massive_marl_tpu_torch.cli.train --task OneAnt --algo ppo \
        --num_envs 4096 --max_iterations 100 --fused_kernel 0
    python -m massive_marl_tpu_torch.cli.train --task TenAnt --algo trpo|ddpg|td3|sac \
        --max_iterations 100
    python -m massive_marl_tpu_torch.cli.train --task MultiAntCircle|MultiIngenuity \
        --algo mappo --num_envs 4096 --max_iterations 10
    python -m massive_marl_tpu_torch.cli.train --task TenAnt --algo ppo \
        --seed 1 --model_dir latest --test [--headless]
    python -m massive_marl_tpu_torch.cli.train --task TenAnt \
        --num_envs 4096 --random_actions --bench_len 10 [--bench_file F]
    python -m massive_marl_tpu_torch.cli.train --algo mtppo|mttrpo|mtsac \
        --num_envs 4096 --max_iterations 100 [--cfg_train tasks.yaml]
    python -m massive_marl_tpu_torch.cli.train --algo random --max_iterations 10
    python -m massive_marl_tpu_torch.cli.train --task TenAnt --algo mamlppo \
        --num_envs 4096 --max_iterations 100
    python -m massive_marl_tpu_torch.cli.train --task OneAnt --algo ppo_collect \
        --num_envs 4096 --max_iterations 100
    python -m massive_marl_tpu_torch.cli.train --task OneAnt --algo td3_bc|bcq|iql \
        --max_iterations 100000 [--datatype random]

As in the JAX package, the env comes from cfg/<Task>.yaml and the trainer
from cfg/<algo>/config.yaml (or --cfg_env / --cfg_train), with the
command line's overrides (utils/config.load_cfg): --num_envs (the YAML
says 128), --episode_length, --randomize (task.randomize: domain
randomization from the env YAML's randomization_params) and --seed (-1, the
default, draws one).  --max_iterations caps a single-agent trainer's
and MADDPG's iterations, and gives another MARL run max_iterations x
episode_length x num_envs steps unless --num_env_steps is set.
--fused_kernel sets the env's sim.fused_kernel: 0 steps the physics on the
array engine, 1 or auto (the YAML's default) on the substep kernel.
FUSED_TOWER=1 in the environment runs the MARL update's towers on kernels
B4/B5.  Runs on CUDA unless --device cpu (or --rl_device cpu) is given.  MAT, MADDPG and the recurrent runner have no
viewer policy: --test without --headless prints that the export was
skipped, as the JAX CLI does.  The multi-task, meta and offline trainers
neither restore nor --test, as in the JAX CLI; each multi-task env is
built from its own cfg/<Task>.yaml with num_envs from --task's (or
--num_envs), and `random` runs --max_iterations (default 10) iterations.

The trainers log to <logdir>/seed<seed> (metrics.csv and a tfevents file)
and save checkpoints there every save_interval iterations, in the JAX
package's file format.  --model_dir PATH|latest (or --resume N) restores
before training; --test or --play evaluates deterministic episodes instead
of training and, without --headless, writes viewer_<task>.html;
--random_actions times the env alone under uniform random actions.  `main`
returns the trainer (its `last_eval` holds a --test's result), or the
benchmark's records under --random_actions.

A job of several processes runs the same command in each, with
MMT_COORDINATOR (host:port), MMT_NUM_PROCESSES and MMT_PROCESS_ID set, as
the JAX CLI's (parallel/launch.py starts them on one host):

    python -m massive_marl_tpu_torch.parallel.launch --nproc 4 -- \
        --task TenAnt --algo mappo --num_envs 8 --max_iterations 2 --device cpu

Each process is one rank of a data-parallel mesh (parallel/mesh.py): NCCL
on cuda:<rank % cards>, gloo on the CPU (or MMT_BACKEND).  --seed -1 is
drawn on rank 0 and broadcast, only rank 0 writes the logs and
checkpoints, and --num_envs counts the envs of all ranks, each stepping
its own E / R: a trainer given the mesh builds only those envs
(Mesh.shard_env), where the JAX CLI builds the whole state and places it
(_place_state_global).  The SARL and MARL families run on several
processes; the others raise, as in the JAX CLI.
"""
from __future__ import annotations

import json
import os
import time

import torch

from massive_marl_tpu_torch.envs.base import eval_generator, evaluate_episodes
from massive_marl_tpu_torch.utils import config as cfg_mod
from massive_marl_tpu_torch.utils import yaml_lite
from massive_marl_tpu_torch.utils.registry import build_env

# env steps per timed chunk of --random_actions
BENCH_CHUNK = 256


def export_viewer(env, runner, logdir, task, n_steps: int | None = None):
    """Roll one deterministic episode (VIEWER_STEPS steps, 200 by default)
    and write viewer_<task>.html into the logdir (utils/viewer).  The
    viewer is cosmetic, so a failure only prints why it was skipped."""
    from massive_marl_tpu_torch.utils.viewer import export_interactive, record_episode_3d
    if n_steps is None:
        n_steps = int(os.environ.get("VIEWER_STEPS", 200))
    try:
        if hasattr(runner, "actor"):        # MARL runner: per-agent means
            clip = runner.cfg.clip_obs
            ap = (runner.state or runner.init_state()).actor_params

            def policy(obs):
                o, _ = runner._agent_views(torch.clamp(obs, -clip, clip))
                mean, _ = runner.actor.apply(ap, o)
                return torch.clamp(mean.transpose(0, 1).reshape(obs.shape[0], -1), -1, 1)
        else:                               # SARL: joint-action mean
            def policy(obs):
                return torch.clamp(runner.act_inference(obs), -1, 1)

        ant, box = record_episode_3d(env, policy, n_steps=n_steps)
        out = os.path.join(logdir or ".", f"viewer_{task}.html")
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        export_interactive(ant, box, out=out)
        print("interactive viewer written:", out)
    except Exception as e:  # noqa: BLE001 - cosmetic surface
        print(f"viewer export skipped ({type(e).__name__}: {e})")


def evaluate_sarl(trainer, env, num_envs, n_episodes: int = 32, seed: int = 0):
    """Deterministic (mean-action) episodes in E = min(n_episodes,
    num_envs) dedicated envs reset from a stream seeded from seed + 10_000;
    the mean return over the first episode of each env."""
    if trainer.state is None:
        trainer.init_state()
    E = max(1, min(n_episodes, num_envs))
    policy = lambda obs: torch.clamp(trainer.act_inference(obs), -1.0, 1.0)
    return evaluate_episodes(env, E, policy, eval_generator(seed, trainer.device))


def setup_distributed(args):
    """Join the job when MMT_NUM_PROCESSES > 1 (parallel/mesh.init_distributed
    on --device) and return its ('data', 'model') mesh; None for one
    process (the JAX CLI's setup_distributed)."""
    from massive_marl_tpu_torch.parallel import mesh as meshlib
    if not meshlib.init_distributed(device=args.device):
        return None
    import torch.distributed as dist
    mesh = meshlib.make_mesh()
    print(f"[dist] process {dist.get_rank()}/{dist.get_world_size()}: "
          f"{dist.get_backend()}, data rank {mesh.data_rank} of {mesh.size}", flush=True)
    return mesh


def process_sarl(args, env, cfg_train, logdir, num_envs, mesh=None):
    """The single-agent trainer of --algo, configured from its train YAML
    (as the JAX CLI's process_sarl)."""
    algo, kw = args.algo, dict(seed=cfg_train["seed"], log_dir=logdir, device=args.device,
                               mesh=mesh)
    if algo == "ppo":
        from massive_marl_tpu_torch.algos.rl.ppo import PPO, PPOConfig
        return PPO(env, num_envs, PPOConfig.from_cfg_train(cfg_train), **kw)
    if algo == "trpo":
        from massive_marl_tpu_torch.algos.rl.trpo import TRPO, TRPOConfig
        return TRPO(env, num_envs, TRPOConfig.from_cfg_train(cfg_train), **kw)
    from massive_marl_tpu_torch.algos.rl.offpolicy import OffPolicy, OffPolicyConfig
    return OffPolicy(env, num_envs, OffPolicyConfig.from_cfg_train(cfg_train, algo), **kw)


def process_marl(algo, env, cfg_train, num_envs, kw):
    """The MARL runner of --algo, configured from its train YAML (as the JAX
    CLI routes them): MAT, MADDPG, or MAPPO/IPPO/HAPPO/HATRPO on the
    recurrent runner when use_recurrent_policy is set, else on the
    feed-forward one."""
    if algo == "mat":
        from massive_marl_tpu_torch.algos.marl.mat import MatConfig, MatRunner
        return MatRunner(env, num_envs, MatConfig.from_cfg_train(cfg_train), **kw)
    if algo == "maddpg":
        from massive_marl_tpu_torch.algos.marl.maddpg import MaddpgConfig, MaddpgRunner
        return MaddpgRunner(env, num_envs, MaddpgConfig.from_cfg_train(cfg_train), **kw)
    from massive_marl_tpu_torch.algos.marl.runner import MarlConfig, MarlRunner
    mc = MarlConfig.from_cfg_train(cfg_train, algo)
    if mc.use_recurrent_policy:
        from massive_marl_tpu_torch.algos.marl.recurrent_runner import RecurrentMarlRunner
        return RecurrentMarlRunner(env, num_envs, mc, **kw)
    return MarlRunner(env, num_envs, mc, **kw)


def process_other(args, cfg, cfg_train, logdir, num_envs):
    """The multi-task, meta and offline algorithms, routed as the JAX CLI
    routes them; returns the trainer (or the random runner) after its
    run."""
    algo, seed, dev = args.algo, cfg["seed"], args.device
    if algo in cfg_mod.MTRL_ALGOS:
        from massive_marl_tpu_torch.algos.mtrl.mtppo import MTPPO, MTPPOConfig, RandomPolicyRunner
        envs = {}
        for i, t in enumerate(cfg_train.get("tasks", ["OneAnt", "MultiAntCircle"])):
            task_cfg = yaml_lite.load(os.path.join(cfg_mod.CFG_ROOT, f"{t}.yaml"))
            if args.fused_kernel is not None:
                task_cfg.setdefault("sim", {})["fused_kernel"] = cfg_mod.FUSED[args.fused_kernel]
            envs[t] = build_env(t, task_cfg, multi_agent=False, device=dev, seed=seed + i)
        if algo == "random":
            runner = RandomPolicyRunner(envs, num_envs=num_envs, seed=seed, device=dev)
            runner.results = runner.run(args.max_iterations or 10)
            return runner
        kw = dict(seed=seed, log_dir=logdir, device=dev)
        if algo == "mtsac":
            from massive_marl_tpu_torch.algos.mtrl.mtsac import MTSAC, MTSACConfig
            trainer = MTSAC(envs, num_envs, MTSACConfig.from_cfg_train(cfg_train, "sac"), **kw)
        elif algo == "mttrpo":
            from massive_marl_tpu_torch.algos.mtrl.mttrpo import MTTRPO, MTTRPOConfig
            trainer = MTTRPO(envs, num_envs, MTTRPOConfig.from_cfg_train(cfg_train), **kw)
        else:
            trainer = MTPPO(envs, num_envs, MTPPOConfig.from_cfg_train(cfg_train), **kw)
        trainer.run(args.max_iterations or None)
        return trainer
    if algo in cfg_mod.METARL_ALGOS:
        from massive_marl_tpu_torch.algos.metarl.maml import MAMLPPO, MAMLConfig
        env = build_env(args.task, cfg, multi_agent=False, device=dev, seed=seed)
        trainer = MAMLPPO(env, num_envs, MAMLConfig.from_cfg_train(cfg_train), seed=seed,
                          log_dir=logdir, device=dev)
        trainer.run(args.max_iterations or None)
        return trainer
    from massive_marl_tpu_torch.algos.offrl import run_offrl
    return run_offrl(args, cfg, cfg_train, logdir)


def _restore(args, restore, logdir):
    """--model_dir PATH|latest: restore the trainer before it trains or
    tests."""
    if not args.model_dir:
        return
    path = cfg_mod.latest_checkpoint(logdir) if args.model_dir == "latest" else args.model_dir
    if path is None:
        print(f"no checkpoint found under {logdir}; starting fresh "
              "(pass a fixed --seed so --resume finds the prior run's logdir)")
    else:
        restore(path)


def bench_random_actions(args, cfg, num_envs):
    """Env throughput under uniform random actions in [-1, 1) from a
    generator on the env's device: one untimed chunk of BENCH_CHUNK steps,
    then --bench_len timed ones, each ended by a device synchronize.
    Prints one JSON line per report and appends them to --bench_file."""
    env = build_env(args.task, cfg, multi_agent=False, device=args.device, seed=cfg["seed"])
    dev = torch.device(env.device)
    g = torch.Generator(device=dev)
    g.manual_seed(cfg["seed"])
    act_dim = env.num_actions * env.num_agents

    def chunk(state):
        for _ in range(BENCH_CHUNK):
            a = torch.rand((num_envs, act_dim), generator=g, device=dev) * 2.0 - 1.0
            state = env.step_batch(state, a)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return state

    state = chunk(env.reset(num_envs))
    results = []
    for i in range(args.bench_len):
        t0 = time.perf_counter()
        state = chunk(state)
        dt = time.perf_counter() - t0
        rec = {"report": i, "env_steps_per_s": num_envs * BENCH_CHUNK / dt,
               "num_envs": num_envs, "task": args.task}
        print(json.dumps(rec), flush=True)
        results.append(rec)
    if args.bench_file:
        with open(args.bench_file, "a") as f:
            for rec in results:
                f.write(json.dumps(rec) + "\n")
    return results


def main(argv=None):
    args = cfg_mod.get_args(argv)
    cfg_mod.set_np_formatting()
    algo = args.algo
    # several processes: join before load_cfg, so that --seed -1 is drawn
    # once, on rank 0, and every rank runs the same seed
    mesh = setup_distributed(args)
    if mesh is not None:
        import random

        from massive_marl_tpu_torch.parallel.mesh import broadcast_int
        args.seed = broadcast_int(args.seed if args.seed >= 0 else random.randint(0, 10000))
    cfg, cfg_train, logdir = cfg_mod.load_cfg(args)
    run_dir = logdir        # where --model_dir latest looks, on every rank
    if mesh is not None and mesh.rank != 0:
        logdir = None       # one writer and checkpointer per job: rank 0
    if args.fused_kernel is not None:
        cfg.setdefault("sim", {})["fused_kernel"] = cfg_mod.FUSED[args.fused_kernel]
    num_envs = cfg["env"]["numEnvs"]
    seed = cfg["seed"]
    if args.random_actions:
        return bench_random_actions(args, cfg, num_envs)
    if algo in cfg_mod.MTRL_ALGOS + cfg_mod.METARL_ALGOS + cfg_mod.OFFRL_ALGOS:
        if mesh is not None:
            raise NotImplementedError(
                f"multi-process CLI launch supports the SARL and MARL families; --algo "
                f"{algo} runs single-process (its mesh support is exercised in-process, "
                f"tests/test_torch_distributed_other.py)")
        return process_other(args, cfg, cfg_train, logdir, num_envs)
    if args.task == "OneAnt" and algo in cfg_mod.MARL_ALGOS:
        raise SystemExit(f"OneAnt is a single-agent task: --algo one of {cfg_mod.SARL_ALGOS}")
    # --play alone also evaluates (reference config.py:288-294); --resume N
    # resumes from the newest checkpoint in the logdir
    args.test = bool(args.test or args.play)
    if args.resume > 0 and not args.model_dir:
        args.model_dir = "latest"

    if algo in cfg_mod.MARL_ALGOS:
        env = build_env(args.task, cfg, multi_agent=True, device=args.device, seed=seed)
        runner = process_marl(algo, env, cfg_train, num_envs,
                              dict(seed=seed, log_dir=logdir, device=args.device, mesh=mesh))
        _restore(args, runner.restore, run_dir)
        if args.test:
            runner.last_eval = runner.eval()
            print("eval mean episode reward:", runner.last_eval)
            if not args.headless:
                export_viewer(env, runner, logdir, args.task)
            return runner
        if algo == "maddpg":        # an off-policy runner counts iterations
            runner.run(args.max_iterations or None)
            return runner
        steps = args.num_env_steps or None
        if steps is None and args.max_iterations > 0:
            steps = args.max_iterations * runner.cfg.episode_length * num_envs
        runner.run(steps)
        return runner

    env = build_env(args.task, cfg, multi_agent=False, device=args.device, seed=seed)
    trainer = process_sarl(args, env, cfg_train, logdir, num_envs, mesh)
    _restore(args, trainer.load, run_dir)
    if args.test:
        trainer.last_eval = evaluate_sarl(trainer, env, num_envs)
        print("eval mean reward/step:", trainer.last_eval)
        if not args.headless:
            export_viewer(env, trainer, logdir, args.task)
        return trainer
    trainer.run(args.max_iterations or None)
    return trainer


if __name__ == "__main__":
    main()
