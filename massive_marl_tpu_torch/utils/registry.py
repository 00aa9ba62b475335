"""Task registry and env construction (twin of
massive_marl_tpu/utils/registry.py) for the tasks the port runs: TenAnt and
OneAnt.  `make_env` and the VecTask wrapper classes are still to port."""
from __future__ import annotations

from massive_marl_tpu_torch.utils import config as cfg_mod


def task_class(name: str):
    if name == "OneAnt":
        from massive_marl_tpu_torch.envs.one_ant import OneAntEnv
        return OneAntEnv
    if name == "TenAnt":
        from massive_marl_tpu_torch.envs.ten_ant import TenAntEnv
        return TenAntEnv
    if name in cfg_mod.TASKS:
        raise NotImplementedError(f"task {name} is not ported yet (ROADMAP A.6)")
    raise ValueError(f"unknown task {name}")


def is_multi_agent(algo: str) -> bool:
    return algo in cfg_mod.MARL_ALGOS


def build_env(task: str, cfg: dict, multi_agent: bool, device=None, seed: int = 0):
    """The batched env of `task` from its env cfg.  OneAnt is single-agent;
    TenAnt gives SARL algorithms its joint-action interface (multi_agent
    False) and MARL ones the per-agent views, which the runner takes."""
    return task_class(task)(cfg, device=device, seed=seed)
