"""CLI trainer of the port.  TenAnt with PPO or MAPPO/IPPO/HAPPO/HATRPO, and
OneAnt with PPO:

    python -m massive_marl_tpu_torch.cli.train --task TenAnt --algo ppo \
        --num_envs 4096 --max_iterations 100
    python -m massive_marl_tpu_torch.cli.train --task TenAnt --algo mappo \
        --num_envs 4096 --num_env_steps 2000000
    python -m massive_marl_tpu_torch.cli.train --task OneAnt --algo ppo \
        --num_envs 4096 --max_iterations 100 --fused_kernel 0

The env and trainers use their built-in defaults, which are the benchmark
configurations of the JAX package (bench.py: TenAnt with the default
contact constants; PPO hidden (1024, 1024, 512), nsteps 8, 5 epochs x 4
minibatches; MARL: MarlConfig(), which equals cfg/mappo/config.yaml and
cfg/hatrpo/config.yaml, with IPPO's decentralized critic).  FUSED_TOWER=1
in the environment runs the MARL update's towers on kernels B4/B5.
--fused_kernel sets the env's sim.fused_kernel (bench.py's BENCH_FUSED): 0
steps the physics on the array engine, 1 or auto (the default) on the
substep kernel.  There is no YAML config loader on the GPU host yet.  Runs
on CUDA unless --device cpu is given.
"""
from __future__ import annotations

import argparse

from massive_marl_tpu_torch.algos.marl.runner import MarlConfig, MarlRunner
from massive_marl_tpu_torch.algos.rl.ppo import PPO, PPOConfig
from massive_marl_tpu_torch.envs.one_ant import OneAntEnv
from massive_marl_tpu_torch.envs.ten_ant import TenAntEnv

TASKS = {"TenAnt": TenAntEnv, "OneAnt": OneAntEnv}
FUSED = {"auto": "auto", "0": False, "1": True}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task", choices=sorted(TASKS), default="TenAnt")
    ap.add_argument("--algo", choices=["ppo", "mappo", "ippo", "happo", "hatrpo"], default="ppo")
    ap.add_argument("--num_envs", type=int, default=4096)
    ap.add_argument("--max_iterations", type=int, default=PPOConfig.max_iterations,
                    help="PPO iterations")
    ap.add_argument("--num_env_steps", type=int, default=MarlConfig.num_env_steps,
                    help="MARL env steps")
    ap.add_argument("--fused_kernel", choices=sorted(FUSED), default="auto",
                    help="sim.fused_kernel: 0 = array engine, 1 or auto = substep kernel")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    if args.task == "OneAnt" and args.algo != "ppo":
        ap.error("OneAnt is a single-agent task: --algo ppo")
    env = TASKS[args.task]({"sim": {"fused_kernel": FUSED[args.fused_kernel]}},
                           device=args.device, seed=args.seed)
    if args.algo == "ppo":
        trainer = PPO(env, num_envs=args.num_envs, seed=args.seed, device=args.device)
        trainer.run(args.max_iterations)
    else:
        cfg = MarlConfig.from_cfg_train({}, args.algo)
        runner = MarlRunner(env, args.num_envs, cfg, seed=args.seed, device=args.device)
        runner.run(args.num_env_steps)


if __name__ == "__main__":
    main()
