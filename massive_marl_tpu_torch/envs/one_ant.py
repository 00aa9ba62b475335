"""OneAnt: one ant pushes a 1x1x1 box (mass 1, material friction 0) to the
origin (twin of massive_marl_tpu/envs/one_ant.py).

  * scene: the ant spawns at (-6, 0, 1), the box at (-4, 0, 1);
  * obs (60): [z, vel_loc3, angvel_loc3, yaw, roll, angle_to_target,
    up_proj, heading_proj, dof_pos8, dof_vel8, foot sensors 24, actions8];
    the foot sensors are the last substep's contact wrenches in the foot
    frames, scaled by contactForceScale;
  * reward: alive 0.5 + up + box alignment + 500 x the approach to the box
    (gated off within 1.5 m) + 500 x the box's progress to the origin +
    arrive and success bonuses - action, electricity and joint-limit costs;
    death below terminationHeight.

Every method works on a batch of envs.  The physics of `step_batch` runs
through ops/fused_substep (the CUDA substep kernel with sensor outputs,
num_ants = 1) unless `sim.fused_kernel` is false, which takes the array
engine's envs/ant_scene.scene_step; "auto" keeps the kernel path on every
device, as in TenAntEnv.  With task.randomize, domain randomization
works as in TenAntEnv.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from massive_marl_tpu_torch import resolve_device
from massive_marl_tpu_torch.envs import obs_math
from massive_marl_tpu_torch.envs.ant_scene import (AntSceneSpec, AntSceneState, reset_scene,
                                                   scene_step)
from massive_marl_tpu_torch.envs.base import (EnvState, configure_dr, device_only_step, dr_reset,
                                              finish_step)
from massive_marl_tpu_torch.ops import fused_substep
from massive_marl_tpu_torch.phys import mjcf
from massive_marl_tpu_torch.phys.engine import ContactParams


@dataclasses.dataclass
class OneAntCarry:
    pos_before: torch.Tensor   # [E,2] ant xy
    box_before: torch.Tensor   # [E,2] box xy


class OneAntEnv:
    num_obs = 60
    num_actions = 8
    num_agents = 1
    num_states = 60

    def __init__(self, cfg: Dict[str, Any] | None = None, device=None, seed: int = 0):
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        cfg = cfg or {}
        env_cfg = cfg.get("env", {})
        self.max_episode_length = env_cfg.get("episodeLength", 1000)
        self.dof_vel_scale = env_cfg.get("dofVelocityScale", 0.2)
        self.contact_force_scale = env_cfg.get("contactForceScale", 0.1)
        self.power_scale = env_cfg.get("powerScale", 1.0)
        self.up_weight = env_cfg.get("upWeight", 0.1)
        self.actions_cost_scale = env_cfg.get("actionsCost", 0.005)
        self.energy_cost_scale = env_cfg.get("energyCost", 0.05)
        self.joints_at_limit_cost_scale = env_cfg.get("jointsAtLimitCost", 0.1)
        self.death_cost = env_cfg.get("deathCost", -2.0)
        self.termination_height = env_cfg.get("terminationHeight", 0.31)
        self.quat_reward_scale = 1.0
        self.ant_dist_reward_scale = 500.0
        self.goal_dist_reward_scale = 500.0
        dr_spec = configure_dr(self, cfg)

        sim_cfg = cfg.get("sim", {})
        fused = sim_cfg.get("fused_kernel", "auto")
        self.use_fused = True if fused == "auto" else bool(fused)
        plane_cfg = env_cfg.get("plane", {}) or {}
        abm = sim_cfg.get("ant_box_friction", None)
        bgm = sim_cfg.get("box_ground_friction", None)
        model = mjcf.parse_mjcf(mjcf.asset_path("ant.xml"))
        self.model = model
        self.spec = AntSceneSpec(
            ant_sys=model.system.to(self.device),
            box_sys=mjcf.make_box_system((0.5, 0.5, 0.5), density=1.0,
                                         friction=0.0).to(self.device),
            box_half_extents=(0.5, 0.5, 0.5),
            num_ants=1,
            dt=sim_cfg.get("dt", 0.0166),
            substeps=sim_cfg.get("substeps", 3),
            power_scale=self.power_scale,
            plane_friction=float(plane_cfg.get("staticFriction", 1.0)),
            friction_combine=str(sim_cfg.get("friction_combine", "average")),
            ant_box_mu=None if abm is None else float(abm),
            box_ground_mu=None if bgm is None else float(bgm),
            contact=ContactParams(**(sim_cfg.get("contact", {}) or {})),
            dr_spec=dr_spec,
        )
        self.substep_consts = fused_substep.scene_consts(self.spec)
        dev = self.device
        self.init_hinge = torch.as_tensor(model.init_hinge, dtype=torch.float32, device=dev)
        self.targets = torch.zeros(3, device=dev)
        self.box_targets = torch.zeros(2, device=dev)
        self.ant_start = torch.tensor([[-6.0, 0.0, 1.0]], device=dev)
        self.box_start = torch.tensor([-4.0, 0.0, 1.0], device=dev)

    def _fresh_pipeline(self, num_envs: int, frame=None) -> AntSceneState:
        return reset_scene(self.spec, self.generator, num_envs, self.ant_start,
                           self.box_start, self.init_hinge, frame=frame,
                           corr_shapes=((8,), (60,)) if self.randomize else None)

    def _carry_of(self, pipeline: AntSceneState) -> OneAntCarry:
        return OneAntCarry(pos_before=pipeline.ant_qpos[:, 0, 0:2],
                           box_before=pipeline.box_qpos[:, 0:2])

    def _obs(self, pipeline: AntSceneState, actions) -> torch.Tensor:
        """actions [E,8] -> the [E,60] obs."""
        sys = self.spec.ant_sys
        return obs_math.ant_obs_60(pipeline.ant_qpos[:, 0], pipeline.ant_qvel[:, 0], actions,
                                   pipeline.sensors[:, 0], self.targets, sys.jnt_range[:, 0],
                                   sys.jnt_range[:, 1], self.dof_vel_scale,
                                   self.contact_force_scale)

    def reset(self, num_envs: int) -> EnvState:
        pipeline = self._fresh_pipeline(num_envs)
        obs = self._obs(pipeline, torch.zeros((num_envs, 8), device=self.device))
        return EnvState(pipeline=pipeline, carry=self._carry_of(pipeline),
                        progress=torch.zeros(num_envs, dtype=torch.int32, device=self.device),
                        done=torch.zeros(num_envs, dtype=torch.bool, device=self.device),
                        obs=obs, reward=torch.zeros(num_envs, device=self.device))

    def step_batch(self, state: EnvState, actions: torch.Tensor) -> EnvState:
        """actions [E,8] -> the next EnvState."""
        p = state.pipeline
        applied = self._act_noise(actions, self.generator, p.frame, p.corr_act)[:, None, :]
        if self.use_fused:
            stepped = fused_substep.fused_scene_step(self.spec, p, applied, self.substep_consts)
        else:
            stepped = scene_step(self.spec, p, applied)
        return self._finish_step(stepped, actions, state)

    _finish_step = finish_step
    _dr_reset = dr_reset
    device_only_step = device_only_step

    def _reward(self, obs, actions, pipeline: AntSceneState, carry: OneAntCarry, progress):
        """Reward and done flags, [E] each."""
        ant_pos = pipeline.ant_qpos[:, 0, 0:2]
        box_pos = pipeline.box_qpos[:, 0:2]
        quat_dist = obs_math.box_quat_alignment(pipeline.box_qpos[:, 3:7])
        quat_reward = self.quat_reward_scale * quat_dist

        ant_push = 1.0 - (obs_math.l2_xy(ant_pos, box_pos) < 1.5).to(torch.float32)
        ant_dist = (obs_math.l2_xy(carry.pos_before, carry.box_before)
                    - obs_math.l2_xy(ant_pos, box_pos))
        ant_dist_reward = self.ant_dist_reward_scale * ant_dist * ant_push

        goal_dist_before = obs_math.l2_xy(self.box_targets, carry.box_before)
        goal_dist = obs_math.l2_xy(self.box_targets, box_pos)
        goal_arrive = (goal_dist < 0.5).to(torch.float32)
        goal_dist_reward = self.goal_dist_reward_scale * (goal_dist_before - goal_dist)
        goal_arrive_reward = 2.0 * goal_arrive
        success_reward = (quat_dist > 0.9) * goal_arrive * 10.0

        up_reward = torch.where(obs[:, 10] > 0.93, self.up_weight, 0.0)
        actions_cost = torch.sum(actions ** 2, dim=1)
        electricity_cost = torch.sum(torch.abs(actions * obs[:, 20:28]), dim=1)
        dof_at_limit_cost = torch.sum(obs[:, 12:20] > 0.99, dim=1)

        total = (0.5 + up_reward + quat_reward + ant_dist_reward
                 + goal_dist_reward + goal_arrive_reward + success_reward
                 - self.actions_cost_scale * actions_cost
                 - self.energy_cost_scale * electricity_cost
                 - self.joints_at_limit_cost_scale * dof_at_limit_cost)
        fallen = obs[:, 0] < self.termination_height
        total = torch.where(fallen, torch.full_like(total, self.death_cost), total)
        done = fallen | (progress >= self.max_episode_length - 1)
        return total, done
