"""Batched environment state (twin of massive_marl_tpu/envs/base.py).

State is an explicit dataclass with a leading env axis on every tensor;
auto-reset is a masked select, so a step never leaves the device.  Step
order follows the reference: physics advances the old state, envs flagged
done on the previous step are then overwritten with a fresh reset sample,
and obs / reward / done are computed on the result.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass
class EnvState:
    pipeline: Any            # physics state (task-specific dataclass)
    carry: Any               # reward bookkeeping (pos_before etc.)
    progress: torch.Tensor   # [E] int32, steps since reset
    done: torch.Tensor       # [E] bool, this step's reset flag
    obs: torch.Tensor        # [E, num_obs]
    reward: torch.Tensor     # [E] float32 (shared by all agents of an env)


def finish_step(env, stepped, actions: torch.Tensor, state: EnvState) -> EnvState:
    """What follows the physics in an ant task's step: blow-up containment
    (a non-finite env resets), the auto-reset overwrite, obs, reward.  Fresh
    states are drawn for every env and selected where an env resets, as in
    the reference.  `env` provides _fresh_pipeline, _carry_of, _obs and
    _reward."""
    E = actions.shape[0]
    fresh = env._fresh_pipeline(E, frame=stepped.frame)
    finite = (torch.isfinite(stepped.ant_qpos).flatten(1).all(1)
              & torch.isfinite(stepped.ant_qvel).flatten(1).all(1)
              & torch.isfinite(stepped.box_qpos).all(1)
              & torch.isfinite(stepped.box_qvel).all(1))
    reset_now = state.done | ~finite
    pipeline = select_tree(reset_now, fresh, stepped)
    carry_prev = select_tree(reset_now, env._carry_of(fresh), state.carry)
    progress = torch.where(reset_now, 0, state.progress + 1).to(torch.int32)
    obs = env._obs(pipeline, actions)
    reward, done = env._reward(obs, actions, pipeline, carry_prev, progress)
    return EnvState(pipeline=pipeline, carry=env._carry_of(pipeline),
                    progress=progress, done=done, obs=obs, reward=reward)


def select_tree(pred: torch.Tensor, a, b):
    """torch.where(pred, a, b) over equal-shaped dataclasses / tuples of
    tensors; pred [E] broadcasts over each leaf's trailing axes."""
    if isinstance(a, torch.Tensor):
        p = pred.reshape(pred.shape + (1,) * (a.dim() - pred.dim()))
        return torch.where(p, a, b)
    if dataclasses.is_dataclass(a):
        return dataclasses.replace(a, **{
            f.name: select_tree(pred, getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(a)})
    if isinstance(a, tuple):
        return type(a)(select_tree(pred, x, y) for x, y in zip(a, b))
    raise TypeError(f"select_tree: unsupported leaf {type(a).__name__}")
