"""Task registry, env construction and the library API (twin of
massive_marl_tpu/utils/registry.py): OneAnt, TenAnt, MultiAntCircle and
MultiIngenuity."""
from __future__ import annotations

import os

from massive_marl_tpu_torch.utils import config as cfg_mod
from massive_marl_tpu_torch.utils import yaml_lite


def task_class(name: str):
    if name == "OneAnt":
        from massive_marl_tpu_torch.envs.one_ant import OneAntEnv
        return OneAntEnv
    if name == "TenAnt":
        from massive_marl_tpu_torch.envs.ten_ant import TenAntEnv
        return TenAntEnv
    if name == "MultiAntCircle":
        from massive_marl_tpu_torch.envs.multi_ant_circle import MultiAntCircleEnv
        return MultiAntCircleEnv
    if name == "MultiIngenuity":
        from massive_marl_tpu_torch.envs.multi_ingenuity import MultiIngenuityEnv
        return MultiIngenuityEnv
    raise ValueError(f"unknown task {name}")


def is_multi_agent(algo: str) -> bool:
    return algo in cfg_mod.MARL_ALGOS


def build_env(task: str, cfg: dict, multi_agent: bool, device=None, seed: int = 0):
    """The batched env of `task` from its env cfg.  OneAnt is single-agent;
    a task of many agents gives SARL algorithms its joint-action interface
    (multi_agent False) and MARL ones the per-agent views, which the runner
    takes."""
    return task_class(task)(cfg, device=device, seed=seed)


def make_env(task: str, algo: str = "ppo", num_envs: int | None = None, seed: int = 0,
             device=None, **overrides):
    """Library API: a ready vectorized env from cfg/<task>.yaml, its env
    section updated with `overrides`.  A MARL algorithm on a task of many
    agents gets MultiVecTaskPython, anything else VecTaskPython.  The env
    runs on CUDA unless device="cpu" is given."""
    cfg = yaml_lite.load(os.path.join(cfg_mod.CFG_ROOT, f"{task}.yaml"))
    if overrides:
        cfg["env"].update(overrides)
    E = num_envs or cfg["env"].get("numEnvs", 128)
    env = build_env(task, cfg, is_multi_agent(algo), device=device, seed=seed)
    from massive_marl_tpu_torch.wrap.vec_task import MultiVecTaskPython, VecTaskPython
    if is_multi_agent(algo) and env.num_agents > 1:
        return MultiVecTaskPython(env, num_envs=E, seed=seed)
    return VecTaskPython(env, num_envs=E, seed=seed)
