"""MultiIngenuity: 4 Mars coax-helicopters fly to per-agent goals under Mars
gravity (twin of massive_marl_tpu/envs/multi_ingenuity.py).

  * spawns (0, +-2, 1), (0, +-6, 1); goals (4, +-2, 1), (4, +-6, 1); gravity
    (0, 0, -3.721);
  * the helicopter is ingenuity.xml welded into one free body (phys/mjcf);
  * actions 6 per helicopter, per rotor (lateral x, lateral y, vertical):
    the vertical thrust a * 2000 clamped to +-2000 and scaled by dt, the
    lateral fractions clamped to +-0.2 and scaled by the thrust; the forces
    act at the rotor offsets (0, 0, 0) and (0, 0, 0.025) in the body frame,
    turned into the world frame by the body's rotation;
  * obs 13 per helicopter, the raw root state [pos3, quat4 (xyzw), linvel3,
    angvel3];
  * reward: pos + pos * (up + spin) with pos = sum 1 / (1 + dist^2), up =
    sum 5 / (1 + tilt^2), spin = sum 1 / (1 + w_z^2); an env is done when a
    helicopter is more than 8 m from its goal or below z = 0.5, or at the
    episode's end.

Every method works on a batch of envs.  The bodies step on the array
engine (engine.forward_dynamics with the rotor forces as one external
spatial force about the base; sim.substeps substeps of dt / substeps), as
in the JAX task.  A reset is deterministic: every env starts at the spawns
at rest.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from massive_marl_tpu_torch import resolve_device
from massive_marl_tpu_torch.envs.base import EnvState, select_tree
from massive_marl_tpu_torch.phys import engine, mjcf
from massive_marl_tpu_torch.phys.maths import quat_rotate

SPAWNS = np.array([[0.0, 2.0, 1.0], [0.0, -2.0, 1.0], [0.0, 6.0, 1.0], [0.0, -6.0, 1.0]],
                  np.float32)
GOALS = np.array([[4.0, 2.0, 1.0], [4.0, -2.0, 1.0], [4.0, 6.0, 1.0], [4.0, -6.0, 1.0]],
                 np.float32)


@dataclasses.dataclass
class HeliPipeline:
    qpos: torch.Tensor   # [E, 4, 7]
    qvel: torch.Tensor   # [E, 4, 6]


class MultiIngenuityEnv:
    num_agents = 4
    num_actions = 6
    num_ant_obs = 13     # per-agent obs block (root state)
    num_obs = 52
    num_states = 52

    def __init__(self, cfg: Dict[str, Any] | None = None, device=None, seed: int = 0):
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        cfg = cfg or {}
        self.max_episode_length = cfg.get("env", {}).get("episodeLength", 1000)
        sim_cfg = cfg.get("sim", {})
        self.dt = sim_cfg.get("dt", 0.0166)
        self.substeps = sim_cfg.get("substeps", 2)
        dev = self.device
        self.gravity = torch.tensor([0.0, 0.0, -3.721], device=dev)
        self.sys = mjcf.parse_mjcf(mjcf.asset_path("ingenuity.xml")).system.to(dev)
        self.spawns = torch.as_tensor(SPAWNS, device=dev)
        self.goals = torch.as_tensor(GOALS, device=dev)
        self.thrust_limit = 2000.0
        self.lateral_limit = 0.2
        self.rotor_offsets = torch.tensor([[0.0, 0.0, 0.0], [0.0, 0.0, 0.025]], device=dev)

    def _fresh_pipeline(self, num_envs: int) -> HeliPipeline:
        quat = torch.tensor([0.0, 0.0, 0.0, 1.0], device=self.device).expand(4, 4)
        qpos = torch.cat([self.spawns, quat], dim=1)
        return HeliPipeline(qpos=qpos.expand(num_envs, 4, 7).clone(),
                            qvel=torch.zeros((num_envs, 4, 6), device=self.device))

    def _obs(self, pipeline: HeliPipeline) -> torch.Tensor:
        return torch.cat([pipeline.qpos, pipeline.qvel], dim=-1).reshape(pipeline.qpos.shape[0], -1)

    def _thrusts(self, actions):
        """[E,24] actions -> per-helicopter rotor forces [E,4,2,3] in the
        body frame (note the dt scale)."""
        a = actions.reshape(actions.shape[0], 4, 2, 3)   # [E, heli, rotor, (lat0, lat1, vert)]
        vert = torch.clamp(a[..., 2] * 2000.0, -self.thrust_limit, self.thrust_limit) * self.dt
        lat = torch.clamp(a[..., 0:2], -self.lateral_limit, self.lateral_limit)
        return torch.cat([vert[..., None] * lat, vert[..., None]], dim=-1)

    def _substep(self, qpos, qvel, thrust, h):
        fk = engine.fwd_kinematics(self.sys, qpos, qvel)
        quat = qpos[..., 3:7]
        f0 = torch.zeros_like(qvel)
        for r in range(2):
            f_w = quat_rotate(quat, thrust[..., r, :])
            p_w = qpos[..., 0:3] + quat_rotate(quat, self.rotor_offsets[r].expand_as(f_w))
            f0 = f0 + engine.point_force_spatial(p_w, f_w, fk.base)
        qacc = engine.forward_dynamics(self.sys, fk, qvel, qvel.new_zeros(qvel.shape[:-1] + (0,)),
                                       [f0], self.gravity)
        return engine.integrate(self.sys, qpos, qvel, qacc, h)

    def reset(self, num_envs: int) -> EnvState:
        pipeline = self._fresh_pipeline(num_envs)
        return EnvState(pipeline=pipeline, carry=(),
                        progress=torch.zeros(num_envs, dtype=torch.int32, device=self.device),
                        done=torch.zeros(num_envs, dtype=torch.bool, device=self.device),
                        obs=self._obs(pipeline), reward=torch.zeros(num_envs, device=self.device))

    def step_batch(self, state: EnvState, actions: torch.Tensor) -> EnvState:
        """actions [E,24] -> the next EnvState: the physics advances every
        env, then envs done on the previous step restart at the spawns."""
        h = self.dt / self.substeps
        thrusts = self._thrusts(actions)
        qpos, qvel = state.pipeline.qpos, state.pipeline.qvel
        for _ in range(self.substeps):
            qpos, qvel = self._substep(qpos, qvel, thrusts, h)
        E = actions.shape[0]
        pipeline = select_tree(state.done, self._fresh_pipeline(E), HeliPipeline(qpos, qvel))
        progress = torch.where(state.done, 0, state.progress + 1).to(torch.int32)
        reward, done = self._reward(pipeline, progress)
        return EnvState(pipeline=pipeline, carry=state.carry, progress=progress, done=done,
                        obs=self._obs(pipeline), reward=reward)

    def _reward(self, pipeline: HeliPipeline, progress):
        """Reward and done flags, [E] each."""
        pos = pipeline.qpos[..., 0:3]
        dist = torch.sqrt(torch.sum((self.goals - pos) ** 2, dim=-1))        # [E,4]
        pos_reward = torch.sum(1.0 / (1.0 + dist * dist), dim=-1)
        ez = pos.new_tensor([0.0, 0.0, 1.0]).expand_as(pos)
        tilt = torch.abs(1.0 - quat_rotate(pipeline.qpos[..., 3:7], ez)[..., 2])
        up_reward = torch.sum(5.0 / (1.0 + tilt * tilt), dim=-1)
        spin = torch.abs(pipeline.qvel[..., 5])
        spin_reward = torch.sum(1.0 / (1.0 + spin * spin), dim=-1)
        reward = pos_reward + pos_reward * (up_reward + spin_reward)
        die = torch.any(dist > 8.0, dim=-1) | torch.any(pos[..., 2] < 0.5, dim=-1)
        return reward, die | (progress >= self.max_episode_length - 1)
