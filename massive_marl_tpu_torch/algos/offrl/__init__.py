"""Offline RL: ppo_collect (the dataset writer), TD3+BC, BCQ and IQL (twin
of massive_marl_tpu/algos/offrl/__init__.py).  Datasets are float32 .npy
files (states, actions, rewards, dones, next_states) under
<dataset_dir>/<task>_<datatype>/."""
from __future__ import annotations


def run_offrl(args, cfg, cfg_train, logdir):
    """--algo ppo_collect, or an offline trainer followed by its online
    evaluation (64 envs, 1,000 steps) on --task."""
    from massive_marl_tpu_torch.utils.registry import build_env
    algo, seed = args.algo, cfg.get("seed", 0)
    if algo == "ppo_collect":
        from massive_marl_tpu_torch.algos.offrl.collect import PPOCollect
        env = build_env(args.task, cfg, multi_agent=False, device=args.device, seed=seed)
        runner = PPOCollect(env, cfg["env"]["numEnvs"], cfg_train, seed=seed, log_dir=logdir,
                            dataset_dir=cfg_train["learn"].get("dataset_dir", "./datasets"),
                            task=args.task, datatype=args.datatype, device=args.device)
        runner.run(args.max_iterations or None)
        return runner
    from massive_marl_tpu_torch.algos.offrl.trainers import OfflineConfig, OfflineTrainer
    trainer = OfflineTrainer(task=args.task, datatype=args.datatype,
                             cfg=OfflineConfig.from_cfg_train(cfg_train, algo), seed=seed,
                             log_dir=logdir, device=args.device)
    trainer.run(args.max_iterations or None)
    env = build_env(args.task, cfg, multi_agent=False, device=args.device, seed=seed)
    trainer.last_eval = trainer.eval_online(env, num_envs=64, n_steps=1000)
    print(f"[{algo}] online eval mean reward/step:", trainer.last_eval, flush=True)
    return trainer
