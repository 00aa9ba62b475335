"""Config and flags of the CLI (twin of massive_marl_tpu/utils/config.py).

Every task maps to an env YAML (cfg/<Task>.yaml) and every algorithm to a
train YAML (cfg/<algo>/config.yaml), read with the port's own loader
(utils/yaml_lite).  `load_cfg` applies the command line's overrides as the
JAX package does: numEnvs, episodeLength, task.randomize, and the seed (-1
draws one).  `get_args` takes every flag of the JAX CLI with its default,
plus --device and --fused_kernel; --horovod and --checkpoint are refused
with the JAX messages, and --rl_device cpu is --device cpu.  Flags of
algorithms and tasks the port lacks parse, and the CLI refuses them by
name.  With --experiment and --metadata the logdir's suffix names the
torch device type and "torchphys", so the two packages' logdirs differ.
"""
from __future__ import annotations

import argparse
import os
import random

import numpy as np
import torch

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
    p.add_argument("--test", action="store_true",
                   help="evaluate the policy (after --model_dir) and return; no training")
    p.add_argument("--play", action="store_true", help="the same as --test")
    p.add_argument("--model_dir", type=str, default="",
                   help="checkpoint to restore before training or testing; 'latest' takes "
                        "the newest .ckpt under the logdir")
    p.add_argument("--logdir", type=str, default="")
    p.add_argument("--experiment", "--experiment_name", dest="experiment",
                   type=str, default="Base",
                   help="experiment name; with --metadata, task-type/device/"
                        "engine info is appended (reference config.py:236-240)")
    p.add_argument("--metadata", action="store_true")
    p.add_argument("--cfg_train", type=str, default="")
    p.add_argument("--cfg_env", type=str, default="")
    p.add_argument("--randomize", action="store_true", help="enable domain randomization")
    p.add_argument("--datatype", type=str, default="expert",
                   help="offline RL dataset flavor (process_offrl.py:40-44)")
    p.add_argument("--task_type", type=str, default="Python",
                   help="accepted for parity; the wrapper flavor is inferred from --algo")
    p.add_argument("--rl_device", type=str, default="tpu",
                   help="'cpu' is the same as --device cpu; any other value leaves the "
                        "device to --device")
    p.add_argument("--headless", action="store_true",
                   help="with --test, skip the viewer file (viewer_<task>.html)")
    p.add_argument("--horovod", action="store_true",
                   help="rejected like the reference (config.py:299-300)")
    p.add_argument("--torch_deterministic", action="store_true",
                   help="accepted for parity; the trainers draw from seeded generators")
    p.add_argument("--resume", type=int, default=0,
                   help=">0 resumes from the latest checkpoint in the logdir (reference --resume)")
    p.add_argument("--checkpoint", type=str, default="Base",
                   help="rl_games-style load path; rejected on the native path like the "
                        "reference (config.py:305-306)")
    p.add_argument("--minibatch_size", type=int, default=-1,
                   help="rl_games-style minibatch override (train_rlgames.py path)")
    p.add_argument("--steps_num", type=int, default=-1,
                   help="rl_games-style horizon override (train_rlgames.py path)")
    p.add_argument("--num_proc", type=int, default=1,
                   help="accepted for parity; the envs are batched on the device, no "
                        "worker processes")
    p.add_argument("--random_actions", action="store_true",
                   help="benchmark mode: run random actions instead of a policy")
    p.add_argument("--bench_len", type=int, default=10,
                   help="number of timing reports in benchmark mode")
    p.add_argument("--bench_file", type=str, default="",
                   help="file to append benchmark JSON results to")
    p.add_argument("--fused_kernel", choices=sorted(FUSED), default=None,
                   help="sets sim.fused_kernel: 0 = array engine, 1 or auto = substep kernel")
    p.add_argument("--device", default=None, help="default: cuda")
    args = p.parse_args(argv)
    if args.horovod:
        raise SystemExit("Distributed training with Horovod is not supported; "
                         "use the data-parallel mesh (massive_marl_tpu_torch.parallel.mesh).")
    if args.checkpoint != "Base":
        raise SystemExit("--checkpoint is not supported on the native path. "
                         "Please use --resume or --model_dir (reference config.py:305-306).")
    if args.rl_device == "cpu":
        if args.device not in (None, "cpu"):
            raise SystemExit(f"--rl_device cpu contradicts --device {args.device}")
        args.device = "cpu"
    return args


def retrieve_cfg(args):
    """task/algo -> (logdir, cfg_train path, cfg_env path)."""
    logdir = args.logdir or os.path.join(REPO_ROOT, "logs", args.task.lower(), args.algo)
    # experiment / metadata logdir suffix (reference config.py:167-174)
    exp = getattr(args, "experiment", "Base")
    if exp != "Base":
        if getattr(args, "metadata", False):
            device = torch.device(getattr(args, "device", None) or "cuda").type
            logdir += f"_{exp}_{getattr(args, 'task_type', 'Python')}_{device}_torchphys"
            if getattr(args, "randomize", False):
                logdir += "_DR"
        else:
            logdir += f"_{exp}"
    cfg_train = args.cfg_train or os.path.join(CFG_ROOT, args.algo, "config.yaml")
    cfg_env = args.cfg_env or os.path.join(CFG_ROOT, f"{args.task}.yaml")
    return logdir, cfg_train, cfg_env


def load_cfg(args):
    """(cfg, cfg_train, logdir) with the command line's overrides applied."""
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


def set_np_formatting():
    np.set_printoptions(edgeitems=30, infstr="inf", linewidth=4000, nanstr="nan",
                        precision=2, suppress=False, threshold=10000, formatter=None)


def get_agent_index(cfg) -> list:
    """The AgentIndex grouping of an env cfg (reference get_AgentIndex,
    agents/utils/process_marl.py:9-16)."""
    import ast
    raw = cfg.get("env", {}).get("AgentIndex", "[[0]]")
    if isinstance(raw, str):
        return ast.literal_eval(raw)
    return raw


def latest_checkpoint(logdir: str, prefix: str = "") -> str | None:
    """The newest complete .ckpt under logdir (a write in progress is a
    .tmp file and never matches)."""
    import glob

    from massive_marl_tpu_torch.utils.checkpoint import newest
    return newest(glob.glob(os.path.join(logdir, "**", f"{prefix}*.ckpt"), recursive=True))
