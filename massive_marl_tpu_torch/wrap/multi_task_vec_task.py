"""Multi-task and meta-RL wrappers (twin of
massive_marl_tpu/wrap/multi_task_vec_task.py).

A set of task envs behind one interface: each task in a VecTaskPython of
its own (seeded seed + its index in name order), the observations padded
with zeros to the widest task's and, in mode "add-onehot", followed by the
task's one-hot; actions cut to the current task's width.  `sample_task`
moves to the next task (round_robin) or draws one (uniform) from the
wrapper's own seeded generator, where the JAX wrapper uses numpy's global
one.  MetaVecTaskPython adds `set_task` and `task_envs` for adaptation
loops.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from massive_marl_tpu_torch.wrap.vec_task import VecTaskPython


class MultiTaskVecTaskPython:
    """mode="add-onehot" appends the task one-hot to every obs;
    mode="vanilla" returns the padded obs."""

    def __init__(self, envs: Dict[str, object], num_envs: int, seed: int = 0,
                 sample_strategy: str = "round_robin", mode: str = "add-onehot",
                 clip_observations: float = 5.0, clip_actions: float = 1.0):
        if mode not in ("add-onehot", "vanilla"):
            raise ValueError(f"unknown multi-task mode {mode!r}")
        self.task_names = sorted(envs)
        self.K = len(self.task_names)
        self.wrapped = {t: VecTaskPython(envs[t], num_envs, seed + i, clip_observations,
                                         clip_actions)
                        for i, t in enumerate(self.task_names)}
        self.num_envs = num_envs
        self.sample_strategy = sample_strategy
        self.mode = mode
        self.max_obs = max(e.num_obs for e in envs.values())
        self.num_obs = self.max_obs + (self.K if mode == "add-onehot" else 0)
        self.num_actions = max(w.num_actions for w in self.wrapped.values())
        self.rng = np.random.default_rng(seed)
        self._cur = 0

    def _aug(self, obs, idx):
        obs = F.pad(obs, (0, self.max_obs - obs.shape[-1]))
        if self.mode == "vanilla":
            return obs
        onehot = torch.zeros((obs.shape[0], self.K), dtype=obs.dtype, device=obs.device)
        onehot[:, idx] = 1.0
        return torch.cat([obs, onehot], dim=-1)

    def sample_task(self) -> int:
        if self.sample_strategy == "round_robin":
            self._cur = (self._cur + 1) % self.K
        elif self.sample_strategy == "uniform":
            self._cur = int(self.rng.integers(self.K))
        return self._cur

    @property
    def current_task(self) -> str:
        return self.task_names[self._cur]

    def reset(self):
        return self._aug(self.wrapped[self.current_task].reset(), self._cur)

    def step(self, actions):
        w = self.wrapped[self.current_task]
        obs, rew, done, info = w.step(torch.as_tensor(actions)[:, : w.num_actions])
        return self._aug(obs, self._cur), rew, done, info


class MetaVecTaskPython(MultiTaskVecTaskPython):
    """The meta-RL flavour: an explicit `set_task` and the `task_envs`
    list."""

    def set_task(self, idx: int):
        self._cur = int(idx)

    @property
    def task_envs(self) -> List[str]:
        return self.task_names
