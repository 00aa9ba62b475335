"""Offline dataset files (twin of massive_marl_tpu/algos/offrl/datasets.py).

A dataset is a directory <root>/<task>_<datatype>/ of five float32 .npy
files, each [N, dim]: states, actions, rewards, dones, next_states (the
reference collector's layout).  They are written and read through the
native mmtio library (native/__init__.py), with numpy's reader and writer
as its fallback, so the JAX package and the port read each other's files.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from massive_marl_tpu_torch import native

FILES = ("states", "actions", "rewards", "dones", "next_states")


def dataset_dir(root: str, task: str, datatype: str) -> str:
    return os.path.join(root, f"{task}_{datatype}")


def save_dataset(path: str, states, actions, rewards, dones, next_states):
    """Write the five arrays (numpy or tensors) as float32 .npy files under
    `path`."""
    os.makedirs(path, exist_ok=True)
    arrays = dict(states=states, actions=actions, rewards=rewards, dones=dones,
                  next_states=next_states)
    for name in FILES:
        x = arrays[name]
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        native.write_npy(os.path.join(path, f"{name}.npy"), np.asarray(x, np.float32))


def load_dataset(path: str) -> dict:
    """The five arrays of a dataset directory as numpy copies (read through
    the native mmap reader)."""
    out = {}
    for name in FILES:
        m = native.NpyMmap(os.path.join(path, f"{name}.npy"))
        out[name] = m.as_array().copy()
        m.close()
    n = len(out["states"])
    for name in FILES:
        if len(out[name]) != n:
            raise ValueError(f"{path}: {name} holds {len(out[name])} rows, states {n}")
    return out


@torch.no_grad()
def make_random_dataset(path: str, task: str = "OneAnt", n: int = 20000, num_envs: int = 64,
                        seed: int = 0, device=None):
    """A random-policy dataset (the reference's `--datatype random`): the
    port's `task` env from cfg/<task>.yaml, E = num_envs envs stepped
    n // E + 1 times with actions uniform in [-1, 1) from a generator
    seeded by `seed`; the first n transitions are written."""
    from massive_marl_tpu_torch.utils import config as cfg_mod
    from massive_marl_tpu_torch.utils import yaml_lite
    from massive_marl_tpu_torch.utils.registry import build_env
    cfg = yaml_lite.load(os.path.join(cfg_mod.CFG_ROOT, f"{task}.yaml"))
    env = build_env(task, cfg, multi_agent=False, device=device, seed=seed)
    dev = torch.device(env.device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    act_dim = env.num_actions * env.num_agents
    state = env.reset(num_envs)
    bufs = {k: [] for k in FILES}
    for _ in range(n // num_envs + 1):
        a = torch.rand((num_envs, act_dim), generator=g, device=dev) * 2.0 - 1.0
        nxt = env.step_batch(state, a)
        for k, v in zip(FILES, (state.obs, a, nxt.reward[:, None],
                                nxt.done.to(torch.float32)[:, None], nxt.obs)):
            bufs[k].append(v.cpu())
        state = nxt
    save_dataset(path, **{k: torch.cat(v)[:n] for k, v in bufs.items()})
    return path
