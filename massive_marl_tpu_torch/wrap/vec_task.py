"""VecTask wrappers (twin of massive_marl_tpu/wrap/vec_task.py).

They hold a batched EnvState and expose step/reset with the reference's
clamping: actions +-1, obs +-5 for one agent and +-7 for many.  The
trainers step the env directly; the wrappers are the library surface
(`massive_marl_tpu_torch.make`).  They run on the env's device, and a
torch.Generator seeded from `seed` takes the place of the JAX wrappers'
PRNG key: the env's resets, auto-resets and noise draw from it while the
wrapper steps.
"""
from __future__ import annotations

import torch

from massive_marl_tpu_torch.envs.base import env_generator


def split_multi_agent_obs(obs_buf: torch.Tensor, num_agents: int, num_ant_obs: int):
    """[E, N*num_ant_obs + tail] -> per-agent obs [E, N, num_ant_obs + tail]
    (each agent sees its own block + the shared tail, multi_vec_task.py:104-116)."""
    E = obs_buf.shape[0]
    blocks = obs_buf[:, : num_agents * num_ant_obs].reshape(E, num_agents, num_ant_obs)
    tail = obs_buf[:, num_agents * num_ant_obs:]
    tails = tail[:, None, :].expand(E, num_agents, tail.shape[-1])
    return torch.cat([blocks, tails], dim=-1)


class _Wrapper:
    def __init__(self, env, num_envs: int, seed: int, clip_observations: float,
                 clip_actions: float):
        self.env = env
        self.num_envs = num_envs
        self.clip_obs = clip_observations
        self.clip_actions = clip_actions
        self.device = torch.device(env.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._state = None

    def _reset_state(self):
        with env_generator(self.env, self.generator):
            self._state = self.env.reset(self.num_envs)

    def _step_state(self, flat_actions):
        """Step before reset is legal: the reference's sim buffers exist
        from construction (base_task.py:56-68)."""
        if self._state is None:
            self._reset_state()
        with env_generator(self.env, self.generator):
            self._state = self.env.step_batch(self._state, flat_actions)

    def _clip_actions(self, actions):
        actions = torch.as_tensor(actions, dtype=torch.float32, device=self.device)
        return torch.clamp(actions, -self.clip_actions, self.clip_actions)

    @property
    def state(self):
        return self._state


class VecTaskPython(_Wrapper):
    """Single-agent joint-action wrapper (vec_task.py:121-139)."""

    def __init__(self, env, num_envs: int, seed: int = 0,
                 clip_observations: float = 5.0, clip_actions: float = 1.0):
        super().__init__(env, num_envs, seed, clip_observations, clip_actions)
        self.num_obs = env.num_obs
        self.num_actions = env.num_actions * env.num_agents

    def _obs(self):
        return torch.clamp(self._state.obs, -self.clip_obs, self.clip_obs)

    def reset(self):
        self._reset_state()
        return self._obs()

    def step(self, actions):
        self._step_state(self._clip_actions(actions))
        return self._obs(), self._state.reward, self._state.done, {}

    def get_state(self):
        if self._state is None:
            self._reset_state()
        return self._obs()


class MultiVecTaskPython(_Wrapper):
    """Multi-agent wrapper (multi_vec_task.py:89-175): the global obs split
    into per-agent views, the share obs, reward and done broadcast to every
    agent."""

    def __init__(self, env, num_envs: int, seed: int = 0,
                 clip_observations: float = 7.0, clip_actions: float = 1.0):
        super().__init__(env, num_envs, seed, clip_observations, clip_actions)
        self.num_agents = env.num_agents
        self.num_ant_obs = env.num_ant_obs
        self.num_obs = env.num_ant_obs + (env.num_obs - env.num_agents * env.num_ant_obs)
        self.num_share_obs = env.num_obs
        self.num_actions = env.num_actions

    def _outputs(self):
        obs_buf = torch.clamp(self._state.obs, -self.clip_obs, self.clip_obs)
        obs = split_multi_agent_obs(obs_buf, self.num_agents, self.num_ant_obs)
        share = obs_buf[:, None, :].expand(self.num_envs, self.num_agents, obs_buf.shape[-1])
        return obs, share

    def reset(self):
        """Reference semantics: reset() on a live state steps the sim with
        zero actions (multi_vec_task.py:146-175)."""
        if self._state is None:
            self._reset_state()
        else:
            self._step_state(torch.zeros((self.num_envs, self.num_agents * self.num_actions),
                                         device=self.device))
        obs, share = self._outputs()
        return obs, share, None

    def step(self, actions):
        """actions: [E, N, act] or a list of N [E, act]."""
        if isinstance(actions, (list, tuple)):
            actions = torch.stack([torch.as_tensor(a, device=self.device) for a in actions], 1)
        self._step_state(self._clip_actions(actions).reshape(self.num_envs, -1))
        obs, share = self._outputs()
        E, N = self.num_envs, self.num_agents
        rewards = self._state.reward[:, None, None].expand(E, N, 1)
        dones = self._state.done[:, None].expand(E, N)
        return obs, share, rewards, dones, [{}] * N, None
