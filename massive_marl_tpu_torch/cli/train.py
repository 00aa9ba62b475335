"""CLI trainer of the port (twin of massive_marl_tpu/cli/train.py): TenAnt
with PPO or MAPPO/IPPO/HAPPO/HATRPO, and OneAnt with PPO.

    python -m massive_marl_tpu_torch.cli.train --task TenAnt --algo ppo \
        --num_envs 4096 --max_iterations 100 [--randomize]
    python -m massive_marl_tpu_torch.cli.train --task TenAnt --algo mappo \
        --num_envs 4096 --num_env_steps 2000000
    python -m massive_marl_tpu_torch.cli.train --task OneAnt --algo ppo \
        --num_envs 4096 --max_iterations 100 --fused_kernel 0

As in the JAX package, the env comes from cfg/<Task>.yaml and the trainer
from cfg/<algo>/config.yaml (or --cfg_env / --cfg_train), with the
command line's overrides (utils/config.load_cfg): --num_envs (the YAML
says 128), --episode_length, --randomize (task.randomize: domain
randomization from the env YAML's randomization_params) and --seed (-1, the
default, draws one).  --max_iterations caps PPO's iterations, and gives a
MARL run max_iterations x episode_length x num_envs steps unless
--num_env_steps is set.  --fused_kernel sets the env's sim.fused_kernel: 0
steps the physics on the array engine, 1 or auto (the YAML's default) on
the substep kernel.  FUSED_TOWER=1 in the environment runs the MARL
update's towers on kernels B4/B5.  Runs on CUDA unless --device cpu is
given.  `main` returns the trainer.  Nothing is written to the logdir yet
(checkpoints and logs: ROADMAP A.4).
"""
from __future__ import annotations

from massive_marl_tpu_torch.utils import config as cfg_mod
from massive_marl_tpu_torch.utils.registry import build_env

# the MARL algorithms the port's runner implements
MARL_PORTED = ("mappo", "ippo", "happo", "hatrpo")
# where ROADMAP.md queues the others
NOT_PORTED = {**{a: "A.5" for a in ("trpo", "ddpg", "td3", "sac")}, "mat": "A.7", "maddpg": "A.7",
              **{a: "A.8" for a in cfg_mod.MTRL_ALGOS + cfg_mod.METARL_ALGOS
                 + cfg_mod.OFFRL_ALGOS}}


def main(argv=None):
    args = cfg_mod.get_args(argv)
    algo = args.algo
    if algo in NOT_PORTED:
        raise NotImplementedError(f"--algo {algo} is not ported yet (ROADMAP {NOT_PORTED[algo]})")
    if args.task == "OneAnt" and algo != "ppo":
        raise SystemExit("OneAnt is a single-agent task: --algo ppo")
    cfg, cfg_train, _logdir = cfg_mod.load_cfg(args)
    if args.fused_kernel is not None:
        cfg.setdefault("sim", {})["fused_kernel"] = cfg_mod.FUSED[args.fused_kernel]
    num_envs = cfg["env"]["numEnvs"]
    seed = cfg["seed"]

    if algo in MARL_PORTED:
        from massive_marl_tpu_torch.algos.marl.runner import MarlConfig, MarlRunner
        env = build_env(args.task, cfg, multi_agent=True, device=args.device, seed=seed)
        mc = MarlConfig.from_cfg_train(cfg_train, algo)
        if mc.use_recurrent_policy:
            raise NotImplementedError("the recurrent MARL runner is not ported yet (ROADMAP A.7)")
        runner = MarlRunner(env, num_envs, mc, seed=seed, device=args.device)
        steps = args.num_env_steps or None
        if steps is None and args.max_iterations > 0:
            steps = args.max_iterations * mc.episode_length * num_envs
        runner.run(steps)
        return runner

    from massive_marl_tpu_torch.algos.rl.ppo import PPO, PPOConfig
    env = build_env(args.task, cfg, multi_agent=False, device=args.device, seed=seed)
    trainer = PPO(env, num_envs, PPOConfig.from_cfg_train(cfg_train), seed=cfg_train["seed"],
                  device=args.device)
    trainer.run(args.max_iterations or None)
    return trainer


if __name__ == "__main__":
    main()
