"""Batched environment state (twin of massive_marl_tpu/envs/base.py).

State is an explicit dataclass with a leading env axis on every tensor;
auto-reset is a masked select, so a step never leaves the device.  Step
order follows the reference: physics advances the old state, envs flagged
done on the previous step are then overwritten with a fresh reset sample,
and obs / reward / done are computed on the result.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

import torch

from massive_marl_tpu_torch.phys import dr
from massive_marl_tpu_torch.utils.profiling import spanned


@dataclasses.dataclass
class EnvState:
    pipeline: Any            # physics state (task-specific dataclass)
    carry: Any               # reward bookkeeping (pos_before etc.)
    progress: torch.Tensor   # [E] int32, steps since reset
    done: torch.Tensor       # [E] bool, this step's reset flag
    obs: torch.Tensor        # [E, num_obs]
    reward: torch.Tensor     # [E] float32 (shared by all agents of an env)


@spanned("env.finish_step")
def finish_step(env, stepped, actions: torch.Tensor, state: EnvState) -> EnvState:
    """What follows the physics in an ant task's step: blow-up containment
    (a non-finite env resets), the auto-reset overwrite, obs, reward, then
    the observation noise of domain randomization (the reward reads the
    clean obs).  Fresh states are drawn for every env and selected where an
    env resets, as in the reference.  `env` provides _fresh_pipeline,
    _carry_of, _obs, _reward, _dr_reset (`dr_reset`) and the attributes
    `configure_dr` sets; `actions` are the policy's, before any noise."""
    E = actions.shape[0]
    fresh = env._dr_reset(env._fresh_pipeline(E, frame=stepped.frame), stepped, state.pipeline)
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
    if env.randomize:
        obs = env._obs_noise(obs, env.generator, pipeline.frame, pipeline.corr_obs)
    return EnvState(pipeline=pipeline, carry=env._carry_of(pipeline),
                    progress=progress, done=done, obs=obs, reward=reward)


device_only_step = property(lambda env: env.use_fused, doc="""Whether an ant
task's step_batch makes no read from the device on the host (no sync, no
blocking copy, no branch on a device value), so that a CUDA graph can hold
it (algos/rl/rollout_graph.py): the fused substep path.  The array engine's
step is not held to it.""")


def configure_dr(env, cfg) -> dict | None:
    """Set an ant task's domain-randomization attributes from its cfg
    (task.randomize, task.randomization_params): randomize, dr_frequency
    (re-randomization gate in env steps), _dr_mass_setup_only, _obs_noise,
    _act_noise.  Returns the actor_params.ant spec, None without DR."""
    task_cfg = cfg.get("task", {})
    env.randomize = bool(task_cfg.get("randomize", False))
    rp = task_cfg.get("randomization_params", {}) or {}
    dr_spec = (rp.get("actor_params", {}) or {}).get("ant") if env.randomize else None
    env.dr_frequency = int(rp.get("frequency", 1))
    rb = (dr_spec or {}).get("rigid_body_properties", {})
    env._dr_mass_setup_only = bool(rb.get("mass", {}).get("setup_only", False))
    env._obs_noise = dr.noise_fn(rp.get("observations") if env.randomize else None)
    env._act_noise = dr.noise_fn(rp.get("actions") if env.randomize else None)
    return dr_spec


def dr_reset(env, fresh, stepped, prev):
    """DR bookkeeping of the fresh states: an env draws new parameters (and
    new correlated noise) only once it has lived `env.dr_frequency` steps
    since its last randomization, else it keeps `prev`'s; a setup_only mass
    keeps its first draw.  The identity without randomization."""
    if not env.randomize:
        return fresh
    resample = stepped.dr_count >= env.dr_frequency
    new_dr = select_tree(resample, fresh.dr, prev.dr)
    if env._dr_mass_setup_only:
        new_dr = dataclasses.replace(new_dr, mass=prev.dr.mass)
    return dataclasses.replace(
        fresh, dr=new_dr,
        dr_count=torch.where(resample, 0, stepped.dr_count).to(torch.int32),
        corr_act=select_tree(resample, fresh.corr_act, prev.corr_act),
        corr_obs=select_tree(resample, fresh.corr_obs, prev.corr_obs))


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


@contextlib.contextmanager
def env_generator(env, generator: torch.Generator):
    """Run the block with `generator` as env's random stream (its resets,
    auto-resets and DR noise), then give env back its own."""
    own = env.generator
    env.generator = generator
    try:
        yield env
    finally:
        env.generator = own


def eval_generator(seed: int, device, iteration: int | None = None) -> torch.Generator:
    """The evaluation stream: seeded from seed + 10_000 and, for periodic
    evaluation, the training iteration, so successive evaluations start
    from fresh states and none disturbs the training envs' stream."""
    g = torch.Generator(device=device)
    g.manual_seed(seed + 10_000 if iteration is None else ((seed + 10_000) << 32) + iteration)
    return g


@torch.no_grad()
def evaluate_episodes(env, num_envs: int, policy: Callable, generator: torch.Generator,
                      with_done: bool = False) -> float:
    """Mean return of one episode in each of `num_envs` dedicated envs,
    reset from `generator` and stepped `env.max_episode_length` times with
    actions = policy(obs), or policy(obs, done) when `with_done` (a
    recurrent policy resets its hidden state where done): each env's
    reward is summed until its first `done`."""
    with env_generator(env, generator):
        state = env.reset(num_envs)
        ret = torch.zeros(num_envs, device=state.obs.device)
        alive = torch.ones(num_envs, dtype=torch.bool, device=state.obs.device)
        for _ in range(int(env.max_episode_length)):
            actions = policy(state.obs, state.done) if with_done else policy(state.obs)
            state = env.step_batch(state, actions)
            ret = ret + torch.where(alive, state.reward, 0.0)
            alive = alive & ~state.done
    return float(ret.mean())
