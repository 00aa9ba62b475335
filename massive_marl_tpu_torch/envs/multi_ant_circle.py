"""MultiAntCircle: 2 ants walk a radius-3 circle clockwise (twin of
massive_marl_tpu/envs/multi_ant_circle.py).

  * scene: the ants spawn at (+-3, 0, 1); no box; the scene's default
    contact parameters, as in the JAX task (the env YAML's sim.contact is
    not read);
  * obs: 2 x 38 per-ant blocks (TenAnt's layout), no shared tail;
  * reward, per env: for each ant +2 when it moved clockwise while inside
    the 2.7..3.3 radius band, else -1, plus the up reward, minus the
    action, electricity and joint-limit costs; deathCost when an ant's
    torso falls below terminationHeight.  As in the original, agent 2's xy
    enters negated.

Every method works on a batch of envs.  The physics runs on the array
engine's envs/ant_scene.scene_step, as in the JAX task.  A non-finite env
resets at once (failure containment).  The task takes no domain
randomization.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from massive_marl_tpu_torch import resolve_device
from massive_marl_tpu_torch.envs import obs_math
from massive_marl_tpu_torch.envs.ant_scene import (AntSceneSpec, AntSceneState, reset_scene,
                                                   scene_step)
from massive_marl_tpu_torch.envs.base import EnvState, dr_reset, finish_step
from massive_marl_tpu_torch.phys import mjcf


@dataclasses.dataclass
class CircleCarry:
    pos_before: torch.Tensor    # [E,2,2] per-ant signed xy (agent 2 negated)


def angle_deg(pos):
    """0..360 degrees, measured so that clockwise motion increases the
    angle for y < 0."""
    a = torch.abs(torch.atan2(pos[..., 1], pos[..., 0]) * 180.0 / math.pi)
    return torch.where(pos[..., 1] < 0, 360.0 - a, a)


class MultiAntCircleEnv:
    num_agents = 2
    num_actions = 8
    num_ant_obs = 38
    num_obs = 76
    num_states = 76
    randomize = False

    def __init__(self, cfg: Dict[str, Any] | None = None, device=None, seed: int = 0):
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        cfg = cfg or {}
        env_cfg = cfg.get("env", {})
        self.max_episode_length = env_cfg.get("episodeLength", 1000)
        self.dof_vel_scale = env_cfg.get("dofVelocityScale", 0.2)
        self.power_scale = env_cfg.get("powerScale", 1.0)
        self.up_weight = env_cfg.get("upWeight", 0.1)
        self.actions_cost_scale = env_cfg.get("actionsCost", 0.005)
        self.energy_cost_scale = env_cfg.get("energyCost", 0.05)
        self.joints_at_limit_cost_scale = env_cfg.get("jointsAtLimitCost", 0.1)
        self.death_cost = env_cfg.get("deathCost", -2.0)
        self.termination_height = env_cfg.get("terminationHeight", 0.31)

        sim_cfg = cfg.get("sim", {})
        plane_cfg = env_cfg.get("plane", {}) or {}
        model = mjcf.parse_mjcf(mjcf.asset_path("ant.xml"))
        self.model = model
        self.spec = AntSceneSpec(
            ant_sys=model.system.to(self.device), box_sys=None, box_half_extents=None,
            num_ants=2, dt=sim_cfg.get("dt", 0.0166), substeps=sim_cfg.get("substeps", 3),
            power_scale=self.power_scale,
            plane_friction=float(plane_cfg.get("staticFriction", 1.0)),
            friction_combine=str(sim_cfg.get("friction_combine", "average")))
        dev = self.device
        self.init_hinge = torch.as_tensor(model.init_hinge, dtype=torch.float32, device=dev)
        self.targets = torch.zeros(3, device=dev)
        self.ant_start = torch.tensor([[3.0, 0.0, 1.0], [-3.0, 0.0, 1.0]], device=dev)
        self.sign = torch.tensor([[1.0], [-1.0]], device=dev)

    def _signed_xy(self, pipeline: AntSceneState) -> torch.Tensor:
        return pipeline.ant_qpos[..., 0:2] * self.sign

    def _fresh_pipeline(self, num_envs: int, frame=None) -> AntSceneState:
        return reset_scene(self.spec, self.generator, num_envs, self.ant_start, None,
                           self.init_hinge, frame=frame)

    def _carry_of(self, pipeline: AntSceneState) -> CircleCarry:
        return CircleCarry(pos_before=self._signed_xy(pipeline))

    def _obs(self, pipeline: AntSceneState, actions) -> torch.Tensor:
        """actions [E,2,8] -> the flat [E,76] obs."""
        sys = self.spec.ant_sys
        per_ant = obs_math.ant_obs_38(pipeline.ant_qpos, pipeline.ant_qvel, actions,
                                      self.targets, sys.jnt_range[:, 0], sys.jnt_range[:, 1],
                                      self.dof_vel_scale)
        return per_ant.reshape(per_ant.shape[0], -1)

    def reset(self, num_envs: int) -> EnvState:
        pipeline = self._fresh_pipeline(num_envs)
        obs = self._obs(pipeline, torch.zeros((num_envs, 2, 8), device=self.device))
        return EnvState(pipeline=pipeline, carry=self._carry_of(pipeline),
                        progress=torch.zeros(num_envs, dtype=torch.int32, device=self.device),
                        done=torch.zeros(num_envs, dtype=torch.bool, device=self.device),
                        obs=obs, reward=torch.zeros(num_envs, device=self.device))

    def step_batch(self, state: EnvState, actions: torch.Tensor) -> EnvState:
        """actions [E,16] (joint-action layout) -> the next EnvState."""
        actions = actions.reshape(actions.shape[0], 2, 8)
        return self._finish_step(scene_step(self.spec, state.pipeline, actions), actions, state)

    _finish_step = finish_step
    _dr_reset = dr_reset

    def _reward(self, obs, actions, pipeline: AntSceneState, carry: CircleCarry, progress):
        """Reward and done flags, [E] each."""
        per_ant = obs.reshape(obs.shape[0], 2, 38)
        pos = self._signed_xy(pipeline)
        dist = torch.sqrt(torch.sum(pos ** 2, dim=-1))
        clockwise = (angle_deg(pos) - angle_deg(carry.pos_before)) > 0
        on_circle = (dist >= 2.7) & (dist <= 3.3)
        good = (clockwise & on_circle).to(torch.float32)
        circle_rew = torch.sum(good * 2.0 + (good - 1.0), dim=1)

        up_reward = torch.sum(torch.where(per_ant[..., 12] > 0.93, self.up_weight, 0.0), dim=1)
        actions_cost = torch.sum(actions ** 2, dim=(1, 2))
        electricity = torch.sum(torch.abs(actions * per_ant[..., 22:30]), dim=(1, 2))
        at_limit = torch.sum(per_ant[..., 14:22] > 0.99, dim=(1, 2))

        total = (up_reward + circle_rew
                 - self.actions_cost_scale * actions_cost
                 - self.energy_cost_scale * electricity
                 - self.joints_at_limit_cost_scale * at_limit)
        fallen = torch.any(per_ant[..., 2] < self.termination_height, dim=1)
        total = torch.where(fallen, torch.full_like(total, self.death_cost), total)
        done = fallen | (progress >= self.max_episode_length - 1)
        return total, done
