"""Config and flags of the CLI (twin of massive_marl_tpu/utils/config.py).

Every task maps to an env YAML (cfg/<Task>.yaml) and every algorithm to a
train YAML (cfg/<algo>/config.yaml), read with the port's own loader
(utils/yaml_lite).  `load_cfg` applies the command line's overrides as the
JAX package does: numEnvs, episodeLength, task.randomize, and the seed (-1
draws one).  The flag surface is the JAX CLI's for what the port runs, plus
--device and --fused_kernel; flags of algorithms and tasks the port lacks
parse, and the CLI refuses them by name.
"""
from __future__ import annotations

import argparse
import os
import random

import numpy as np

from massive_marl_tpu_torch.utils import yaml_lite

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CFG_ROOT = os.path.join(REPO_ROOT, "cfg")

SARL_ALGOS = ["ppo", "trpo", "ddpg", "td3", "sac"]
MARL_ALGOS = ["mappo", "happo", "hatrpo", "ippo", "maddpg", "mat"]
MTRL_ALGOS = ["mtppo", "mtsac", "mttrpo", "random"]
METARL_ALGOS = ["mamlppo"]
OFFRL_ALGOS = ["td3_bc", "bcq", "iql", "ppo_collect"]
ALL_ALGOS = SARL_ALGOS + MARL_ALGOS + MTRL_ALGOS + METARL_ALGOS + OFFRL_ALGOS

TASKS = ["OneAnt", "TenAnt", "MultiAntCircle", "MultiIngenuity"]
FUSED = {"auto": "auto", "0": False, "1": True}


def get_args(argv=None):
    p = argparse.ArgumentParser("massive_marl_tpu_torch trainer")
    p.add_argument("--task", type=str, default="TenAnt", choices=TASKS)
    p.add_argument("--algo", type=str, default="ppo", choices=ALL_ALGOS)
    p.add_argument("--num_envs", type=int, default=0, help="override cfg numEnvs")
    p.add_argument("--episode_length", type=int, default=0, help="override episodeLength")
    p.add_argument("--seed", type=int, default=-1, help="-1 draws one")
    p.add_argument("--max_iterations", type=int, default=0)
    p.add_argument("--num_env_steps", type=int, default=0, help="MARL total steps override")
    p.add_argument("--logdir", type=str, default="")
    p.add_argument("--cfg_train", type=str, default="")
    p.add_argument("--cfg_env", type=str, default="")
    p.add_argument("--randomize", action="store_true", help="enable domain randomization")
    p.add_argument("--fused_kernel", choices=sorted(FUSED), default=None,
                   help="sets sim.fused_kernel: 0 = array engine, 1 or auto = substep kernel")
    p.add_argument("--device", default=None, help="default: cuda")
    return p.parse_args(argv)


def retrieve_cfg(args):
    """task/algo -> (logdir, cfg_train path, cfg_env path)."""
    logdir = args.logdir or os.path.join(REPO_ROOT, "logs", args.task.lower(), args.algo)
    cfg_train = args.cfg_train or os.path.join(CFG_ROOT, args.algo, "config.yaml")
    cfg_env = args.cfg_env or os.path.join(CFG_ROOT, f"{args.task}.yaml")
    return logdir, cfg_train, cfg_env


def load_cfg(args):
    """(cfg, cfg_train, logdir) with the command line's overrides applied.
    Nothing writes to the logdir yet."""
    logdir, cfg_train_path, cfg_env_path = retrieve_cfg(args)
    cfg_train = yaml_lite.load(cfg_train_path)
    cfg = yaml_lite.load(cfg_env_path)

    if args.num_envs > 0:
        cfg["env"]["numEnvs"] = args.num_envs
    if args.episode_length > 0:
        cfg["env"]["episodeLength"] = args.episode_length
    if args.randomize:
        cfg.setdefault("task", {})["randomize"] = True

    seed = args.seed if args.seed >= 0 else random.randint(0, 10000)
    cfg["seed"] = seed
    cfg_train["seed"] = seed
    np.random.seed(seed)
    random.seed(seed)
    return cfg, cfg_train, os.path.join(logdir, f"seed{seed}")
