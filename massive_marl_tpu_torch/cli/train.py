"""CLI trainer of the port (twin of massive_marl_tpu/cli/train.py): the
single-agent algorithms PPO, TRPO, DDPG, TD3 and SAC on every task (OneAnt,
TenAnt, MultiAntCircle, MultiIngenuity; a task of many agents through its
joint-action interface), and MAPPO/IPPO/HAPPO/HATRPO on the tasks of many
agents.

    python -m massive_marl_tpu_torch.cli.train --task TenAnt --algo ppo \
        --num_envs 4096 --max_iterations 100 [--randomize] [--logdir DIR]
    python -m massive_marl_tpu_torch.cli.train --task TenAnt --algo mappo \
        --num_envs 4096 --num_env_steps 2000000
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

As in the JAX package, the env comes from cfg/<Task>.yaml and the trainer
from cfg/<algo>/config.yaml (or --cfg_env / --cfg_train), with the
command line's overrides (utils/config.load_cfg): --num_envs (the YAML
says 128), --episode_length, --randomize (task.randomize: domain
randomization from the env YAML's randomization_params) and --seed (-1, the
default, draws one).  --max_iterations caps a single-agent trainer's
iterations, and gives a MARL run max_iterations x episode_length x
num_envs steps unless --num_env_steps is set.  --fused_kernel sets the env's sim.fused_kernel: 0
steps the physics on the array engine, 1 or auto (the YAML's default) on
the substep kernel.  FUSED_TOWER=1 in the environment runs the MARL
update's towers on kernels B4/B5.  Runs on CUDA unless --device cpu (or
--rl_device cpu) is given.

The trainers log to <logdir>/seed<seed> (metrics.csv and a tfevents file)
and save checkpoints there every save_interval iterations, in the JAX
package's file format.  --model_dir PATH|latest (or --resume N) restores
before training; --test or --play evaluates deterministic episodes instead
of training and, without --headless, writes viewer_<task>.html;
--random_actions times the env alone under uniform random actions.  `main`
returns the trainer (its `last_eval` holds a --test's result), or the
benchmark's records under --random_actions.
"""
from __future__ import annotations

import json
import os
import time

import torch

from massive_marl_tpu_torch.envs.base import eval_generator, evaluate_episodes
from massive_marl_tpu_torch.utils import config as cfg_mod
from massive_marl_tpu_torch.utils.registry import build_env

# the MARL algorithms the port's runner implements
MARL_PORTED = ("mappo", "ippo", "happo", "hatrpo")
# where ROADMAP.md queues the others
NOT_PORTED = {"mat": "A.7", "maddpg": "A.7",
              **{a: "A.8" for a in cfg_mod.MTRL_ALGOS + cfg_mod.METARL_ALGOS
                 + cfg_mod.OFFRL_ALGOS}}
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


def process_sarl(args, env, cfg_train, logdir, num_envs):
    """The single-agent trainer of --algo, configured from its train YAML
    (as the JAX CLI's process_sarl)."""
    algo, kw = args.algo, dict(seed=cfg_train["seed"], log_dir=logdir, device=args.device)
    if algo == "ppo":
        from massive_marl_tpu_torch.algos.rl.ppo import PPO, PPOConfig
        return PPO(env, num_envs, PPOConfig.from_cfg_train(cfg_train), **kw)
    if algo == "trpo":
        from massive_marl_tpu_torch.algos.rl.trpo import TRPO, TRPOConfig
        return TRPO(env, num_envs, TRPOConfig.from_cfg_train(cfg_train), **kw)
    from massive_marl_tpu_torch.algos.rl.offpolicy import OffPolicy, OffPolicyConfig
    return OffPolicy(env, num_envs, OffPolicyConfig.from_cfg_train(cfg_train, algo), **kw)


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
    cfg, cfg_train, logdir = cfg_mod.load_cfg(args)
    if args.fused_kernel is not None:
        cfg.setdefault("sim", {})["fused_kernel"] = cfg_mod.FUSED[args.fused_kernel]
    num_envs = cfg["env"]["numEnvs"]
    seed = cfg["seed"]
    if args.random_actions:
        return bench_random_actions(args, cfg, num_envs)
    if algo in NOT_PORTED:
        raise NotImplementedError(f"--algo {algo} is not ported yet (ROADMAP {NOT_PORTED[algo]})")
    if args.task == "OneAnt" and algo in MARL_PORTED:
        raise SystemExit(f"OneAnt is a single-agent task: --algo one of {cfg_mod.SARL_ALGOS}")
    # --play alone also evaluates (reference config.py:288-294); --resume N
    # resumes from the newest checkpoint in the logdir
    args.test = bool(args.test or args.play)
    if args.resume > 0 and not args.model_dir:
        args.model_dir = "latest"

    if algo in MARL_PORTED:
        from massive_marl_tpu_torch.algos.marl.runner import MarlConfig, MarlRunner
        env = build_env(args.task, cfg, multi_agent=True, device=args.device, seed=seed)
        mc = MarlConfig.from_cfg_train(cfg_train, algo)
        if mc.use_recurrent_policy:
            raise NotImplementedError("the recurrent MARL runner is not ported yet (ROADMAP A.7)")
        runner = MarlRunner(env, num_envs, mc, seed=seed, log_dir=logdir, device=args.device)
        _restore(args, runner.restore, logdir)
        if args.test:
            runner.last_eval = runner.eval()
            print("eval mean episode reward:", runner.last_eval)
            if not args.headless:
                export_viewer(env, runner, logdir, args.task)
            return runner
        steps = args.num_env_steps or None
        if steps is None and args.max_iterations > 0:
            steps = args.max_iterations * mc.episode_length * num_envs
        runner.run(steps)
        return runner

    env = build_env(args.task, cfg, multi_agent=False, device=args.device, seed=seed)
    trainer = process_sarl(args, env, cfg_train, logdir, num_envs)
    _restore(args, trainer.load, logdir)
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
