"""VecTask helpers (twin of massive_marl_tpu/wrap/vec_task.py).

Only the multi-agent obs split is ported so far; the wrapper classes
(VecTaskPython, MultiVecTaskPython) are still to port (ROADMAP A.8e).
"""
from __future__ import annotations

import torch


def split_multi_agent_obs(obs_buf: torch.Tensor, num_agents: int, num_ant_obs: int):
    """[E, N*num_ant_obs + tail] -> per-agent obs [E, N, num_ant_obs + tail]
    (each agent sees its own block + the shared tail, multi_vec_task.py:104-116)."""
    E = obs_buf.shape[0]
    blocks = obs_buf[:, : num_agents * num_ant_obs].reshape(E, num_agents, num_ant_obs)
    tail = obs_buf[:, num_agents * num_ant_obs:]
    tails = tail[:, None, :].expand(E, num_agents, tail.shape[-1])
    return torch.cat([blocks, tails], dim=-1)
