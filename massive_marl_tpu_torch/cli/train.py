"""CLI trainer of the port.  Only TenAnt + PPO is ported so far:

    python -m massive_marl_tpu_torch.cli.train --task TenAnt --algo ppo \
        --num_envs 4096 --max_iterations 100

The env and trainer use their built-in defaults, which are the benchmark
configuration of the JAX package (bench.py: TenAnt with the default contact
constants, PPO hidden (1024, 1024, 512), nsteps 8, 5 epochs x 4
minibatches).  Runs on CUDA unless --device cpu is given.
"""
from __future__ import annotations

import argparse

from massive_marl_tpu_torch.algos.rl.ppo import PPO, PPOConfig
from massive_marl_tpu_torch.envs.ten_ant import TenAntEnv


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task", choices=["TenAnt"], default="TenAnt")
    ap.add_argument("--algo", choices=["ppo"], default="ppo")
    ap.add_argument("--num_envs", type=int, default=4096)
    ap.add_argument("--max_iterations", type=int, default=PPOConfig.max_iterations)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    env = TenAntEnv(device=args.device, seed=args.seed)
    trainer = PPO(env, num_envs=args.num_envs, seed=args.seed, device=args.device)
    trainer.run(args.max_iterations)


if __name__ == "__main__":
    main()
