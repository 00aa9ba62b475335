"""TenAnt: 10 ants cooperatively push a 1x28x1 box (mass 28) so that
per-ant goal slots on the box's long axis reach their targets (twin of
massive_marl_tpu/envs/ten_ant.py).

  * scene: ants spawn in two columns at x=6, y=+-1.5..+-13.5, z=1; the box
    at (4, 0, 1);
  * goal slots: box_pos + k_i * (sin a, -cos a) with a the box yaw and
    k = [1.5,-1.5,4.5,-4.5,...,13.5,-13.5]; targets at (0, -k_i);
  * obs: 10 x 38 per-ant blocks + [box_pos2, box_quat4, box_targets2] = 388;
  * one shared team reward per env.

Every method works on a batch of envs.  The physics of `step_batch` runs
through ops/fused_substep (the CUDA substep kernel on the card) unless
`sim.fused_kernel` is false, which takes the array engine's
envs/ant_scene.scene_step.  "auto" (the default) keeps the kernel path on
every device, CPU included, where the kernel wrapper runs its plain version;
the JAX package's "auto" means the kernel only on a TPU.

With task.randomize (cfg/TenAnt.yaml's randomization_params), every ant
steps with its own randomized mass, damping, armature and joint limits
(phys/dr.py; on the kernel path B1's DR instantiation), an env re-draws
them at a reset once `frequency` steps have passed (`_dr_reset`; the
setup_only mass keeps its first draw), the actions get their noise before
the physics and the observations theirs after the reward, which reads the
clean ones.  The observations keep the nominal joint limits.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
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
from massive_marl_tpu_torch.utils.profiling import spanned

GOAL_OFFSETS = np.array([1.5, -1.5, 4.5, -4.5, 7.5, -7.5, 10.5, -10.5, 13.5, -13.5], np.float32)
SPAWN_Y = np.array([-1.5, 1.5, -4.5, 4.5, -7.5, 7.5, -10.5, 10.5, -13.5, 13.5], np.float32)


@dataclasses.dataclass
class TenAntCarry:
    pos_before: torch.Tensor    # [E,10,2] ant xy
    goal_before: torch.Tensor   # [E,10,2] goal slots


class TenAntEnv:
    num_agents = 10
    num_actions = 8            # per agent; 80 joint
    num_ant_obs = 38
    num_obs = 388
    num_states = 388

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
        self.quat_reward_scale = 0.0
        self.ant_dist_reward_scale = 500.0
        self.goal_dist_reward_scale = 500.0
        dr_spec = configure_dr(self, cfg)

        sim_cfg = cfg.get("sim", {})
        plane_cfg = env_cfg.get("plane", {}) or {}
        fused = sim_cfg.get("fused_kernel", "auto")
        self.use_fused = True if fused == "auto" else bool(fused)
        abm = sim_cfg.get("ant_box_friction", None)
        bgm = sim_cfg.get("box_ground_friction", None)
        model = mjcf.parse_mjcf(mjcf.asset_path("ant.xml"))
        self.model = model
        sys = model.system.to(self.device)
        self.spec = AntSceneSpec(
            ant_sys=sys,
            box_sys=mjcf.make_box_system((0.5, 14.0, 0.5), density=1.0,
                                         friction=0.0).to(self.device),
            box_half_extents=(0.5, 14.0, 0.5),
            num_ants=10,
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
        self.offsets = torch.as_tensor(GOAL_OFFSETS, device=dev)
        self.box_targets_i = torch.stack([torch.zeros(10, device=dev), -self.offsets], dim=1)
        self.box_targets = torch.zeros(2, device=dev)
        self.box_start = torch.tensor([4.0, 0.0, 1.0], device=dev)
        self.ant_start = torch.stack([torch.full((10,), 6.0, device=dev),
                                      torch.as_tensor(SPAWN_Y, device=dev),
                                      torch.ones(10, device=dev)], dim=1)

    def _goals(self, box_qpos) -> torch.Tensor:
        """[E,10,2] goal slots from the box poses [E,7]."""
        d = obs_math.box_yaw_goal_dir(box_qpos[:, 3:7])
        return box_qpos[:, None, 0:2] + self.offsets[None, :, None] * d[:, None, :]

    def _fresh_pipeline(self, num_envs: int, frame=None) -> AntSceneState:
        return reset_scene(self.spec, self.generator, num_envs, self.ant_start,
                           self.box_start, self.init_hinge, frame=frame,
                           corr_shapes=((10, 8), (388,)) if self.randomize else None)

    def _carry_of(self, pipeline: AntSceneState) -> TenAntCarry:
        return TenAntCarry(pos_before=pipeline.ant_qpos[..., 0:2],
                           goal_before=self._goals(pipeline.box_qpos))

    def _obs(self, pipeline: AntSceneState, actions) -> torch.Tensor:
        """actions [E,10,8] -> the flat [E,388] obs."""
        sys = self.spec.ant_sys
        per_ant = obs_math.ant_obs_38(pipeline.ant_qpos, pipeline.ant_qvel, actions,
                                      self.targets, sys.jnt_range[:, 0], sys.jnt_range[:, 1],
                                      self.dof_vel_scale)
        E = per_ant.shape[0]
        return torch.cat([per_ant.reshape(E, -1), pipeline.box_qpos[:, 0:2],
                          pipeline.box_qpos[:, 3:7], self.box_targets.expand(E, 2)], dim=1)

    def reset(self, num_envs: int) -> EnvState:
        pipeline = self._fresh_pipeline(num_envs)
        obs = self._obs(pipeline, torch.zeros((num_envs, 10, 8), device=self.device))
        return EnvState(pipeline=pipeline, carry=self._carry_of(pipeline),
                        progress=torch.zeros(num_envs, dtype=torch.int32, device=self.device),
                        done=torch.zeros(num_envs, dtype=torch.bool, device=self.device),
                        obs=obs, reward=torch.zeros(num_envs, device=self.device))

    @spanned("env.step")
    def step_batch(self, state: EnvState, actions: torch.Tensor) -> EnvState:
        """actions [E,80] (joint-action layout) -> the next EnvState."""
        actions = actions.reshape(actions.shape[0], 10, 8)
        p = state.pipeline
        applied = self._act_noise(actions, self.generator, p.frame, p.corr_act)
        if self.use_fused:
            stepped = fused_substep.fused_scene_step(self.spec, p, applied, self.substep_consts)
        else:
            stepped = scene_step(self.spec, p, applied)
        return self._finish_step(stepped, actions, state)

    _finish_step = finish_step
    _dr_reset = dr_reset
    device_only_step = device_only_step

    def _reward(self, obs, actions, pipeline: AntSceneState, carry: TenAntCarry, progress):
        """Shared team reward and done flags, [E] each."""
        E = obs.shape[0]
        per_ant = obs[:, :10 * 38].reshape(E, 10, 38)
        goals = self._goals(pipeline.box_qpos)
        quat_dist = obs_math.box_quat_alignment(pipeline.box_qpos[:, 3:7])
        quat_reward = self.quat_reward_scale * quat_dist

        ant_xy = per_ant[..., 0:2]
        ant_push = 1.0 - (obs_math.l2_xy(ant_xy, goals) < 1.5).to(torch.float32)
        ant_dist = (obs_math.l2_xy(carry.pos_before, carry.goal_before)
                    - obs_math.l2_xy(ant_xy, goals))
        ant_dist_reward = torch.sum(self.ant_dist_reward_scale * ant_dist * ant_push, dim=1)

        goal_dist_before = obs_math.l2_xy(self.box_targets_i, carry.goal_before)
        goal_dist = obs_math.l2_xy(self.box_targets_i, goals)
        goal_arrive = (goal_dist < 0.5).to(torch.float32)
        goal_dist_reward = torch.sum(self.goal_dist_reward_scale * (goal_dist_before - goal_dist),
                                     dim=1)
        goal_arrive_reward = torch.sum(2.0 * goal_arrive, dim=1)
        success_reward = (quat_dist > 0.9) * torch.prod(goal_arrive, dim=1) * 100.0

        up_reward = torch.sum(torch.where(per_ant[..., 12] > 0.93, self.up_weight, 0.0),
                              dim=1) * 10.0
        actions_cost = torch.sum(actions ** 2, dim=(1, 2))
        electricity_cost = torch.sum(torch.abs(actions * per_ant[..., 22:30]), dim=(1, 2))
        dof_at_limit_cost = torch.sum(per_ant[..., 14:22] > 0.99, dim=(1, 2))

        total = (5.0 + up_reward + quat_reward + ant_dist_reward
                 + goal_dist_reward + goal_arrive_reward + success_reward
                 - self.actions_cost_scale * actions_cost
                 - self.energy_cost_scale * electricity_cost
                 - self.joints_at_limit_cost_scale * dof_at_limit_cost)
        fallen = torch.any(per_ant[..., 2] < self.termination_height, dim=1)
        total = torch.where(fallen, torch.full_like(total, self.death_cost), total)
        done = fallen | (progress >= self.max_episode_length - 1)
        return total, done
