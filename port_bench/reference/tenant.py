"""TenAnt in plain PyTorch: the reference's env step.

Ten ants push a 1x28x1 box so that per-ant goal slots on its long axis reach
their targets (SafeRL-Lab/Massive-MARL-Benchmark, the TenAnt task).  The
physics is the plain scalar substep (phys/scalar_phys.py, one [B] tensor per
physical scalar, B = E x 10 articulations) for the ants and the array
engine's free-body substep for the box, three substeps a control step.  The
model comes from this folder's own copy of ant.xml, and every constant the
substep reads is baked here again.

The random stream is the task's documented one: a reset draws
`torch.rand((2, E, 8))` from the env's generator (hinge position and rate
noise, shared by an env's ants), and every step draws one fresh reset
sample for all envs and keeps it where an env was done.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from port_bench.reference.phys import engine, mjcf, obs_math
from port_bench.reference.phys import scalar_phys as sp

GOAL_OFFSETS = [1.5, -1.5, 4.5, -4.5, 7.5, -7.5, 10.5, -10.5, 13.5, -13.5]
SPAWN_Y = [-1.5, 1.5, -4.5, 4.5, -7.5, 7.5, -10.5, 10.5, -13.5, 13.5]
A, NOBS, NACT = 10, 388, 80


@dataclasses.dataclass
class State:
    aq: torch.Tensor          # [E, 10, 15]
    av: torch.Tensor          # [E, 10, 14]
    bq: torch.Tensor          # [E, 7]
    bv: torch.Tensor          # [E, 6]
    pos_before: torch.Tensor  # [E, 10, 2]
    goal_before: torch.Tensor  # [E, 10, 2]
    progress: torch.Tensor    # [E] int32
    done: torch.Tensor        # [E] bool
    obs: torch.Tensor         # [E, 388]
    reward: torch.Tensor      # [E]


class TenAnt:
    def __init__(self, env_cfg: dict, sim_cfg: dict, device):
        dev = self.device = torch.device(device)
        model = mjcf.parse_mjcf(mjcf.asset_path("ant.xml"))
        self.sys = model.system.to(dev)
        self.box_sys = mjcf.make_box_system((0.5, 14.0, 0.5), density=1.0,
                                            friction=0.0).to(dev)
        self.box_he = (0.5, 14.0, 0.5)
        self.dt = sim_cfg["dt"]
        self.substeps = sim_cfg["substeps"]
        self.h = self.dt / self.substeps
        self.power_scale = env_cfg["powerScale"]
        self.plane_friction = float(env_cfg["plane"]["staticFriction"])
        self.combine = str(sim_cfg["friction_combine"])
        self.contact = engine.ContactParams(**sim_cfg["contact"])
        self.max_episode_length = env_cfg["episodeLength"]
        self.dof_vel_scale = env_cfg["dofVelocityScale"]
        self.up_weight = env_cfg["upWeight"]
        self.actions_cost_scale = env_cfg["actionsCost"]
        self.energy_cost_scale = env_cfg["energyCost"]
        self.joints_at_limit_cost_scale = env_cfg["jointsAtLimitCost"]
        self.death_cost = env_cfg["deathCost"]
        self.termination_height = env_cfg["terminationHeight"]
        bsys = self.box_sys
        box_inv = (1.0 / float(bsys.mass[0]),
                   np.linalg.inv(bsys.inertia[0].detach().cpu().numpy().astype(np.float64)))
        self.consts = sp.bake_consts(self.sys, sp.SubstepParams(
            h=self.h, gravity=(0.0, 0.0, -9.81), contact=self.contact,
            plane_friction=self.plane_friction, box_friction=float(bsys.point_friction[0]),
            friction_combine=self.combine, box_he=self.box_he, box_inv=box_inv))
        self.init_hinge = torch.as_tensor(model.init_hinge, dtype=torch.float32, device=dev)
        self.offsets = torch.tensor(GOAL_OFFSETS, device=dev)
        self.box_targets_i = torch.stack([torch.zeros(10, device=dev), -self.offsets], dim=1)
        self.ant_start = torch.stack([torch.full((10,), 6.0, device=dev),
                                      torch.tensor(SPAWN_Y, device=dev),
                                      torch.ones(10, device=dev)], dim=1)
        self.box_start = torch.tensor([4.0, 0.0, 1.0], device=dev)

    # ------------------------------------------------------------- resets
    def _fresh(self, gen, E):
        """(ant qpos, ant qvel, box qpos, box qvel) of E fresh envs."""
        sys, dev = self.sys, self.device
        u = torch.rand((2, E, sys.nj), generator=gen, device=dev)
        dpos = u[0] * (2 * 0.2) - 0.2
        dvel = u[1] * (2 * 0.1) - 0.1
        hinge = torch.clamp(self.init_hinge + dpos, sys.jnt_range[:, 0], sys.jnt_range[:, 1])
        quat = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev)
        aq = torch.cat([self.ant_start.expand(E, A, 3), quat.expand(E, A, 4),
                        hinge[:, None, :].expand(E, A, sys.nj)], dim=-1)
        av = torch.zeros((E, A, sys.nv), device=dev)
        av[..., 6:] = dvel[:, None, :]
        bq = torch.cat([self.box_start, quat]).expand(E, 7).clone()
        return aq, av, bq, torch.zeros((E, 6), device=dev)

    def _goals(self, bq):
        d = obs_math.box_yaw_goal_dir(bq[:, 3:7])
        return bq[:, None, 0:2] + self.offsets[None, :, None] * d[:, None, :]

    def _obs(self, aq, av, bq, actions):
        sys = self.sys
        per_ant = obs_math.ant_obs_38(aq, av, actions, torch.zeros(3, device=self.device),
                                      sys.jnt_range[:, 0], sys.jnt_range[:, 1],
                                      self.dof_vel_scale)
        E = per_ant.shape[0]
        return torch.cat([per_ant.reshape(E, -1), bq[:, 0:2], bq[:, 3:7],
                          torch.zeros(2, device=self.device).expand(E, 2)], dim=1)

    def reset(self, gen, E) -> State:
        aq, av, bq, bv = self._fresh(gen, E)
        dev = self.device
        return State(aq, av, bq, bv, aq[..., 0:2], self._goals(bq),
                     torch.zeros(E, dtype=torch.int32, device=dev),
                     torch.zeros(E, dtype=torch.bool, device=dev),
                     self._obs(aq, av, bq, torch.zeros((E, 10, 8), device=dev)),
                     torch.zeros(E, device=dev))

    # ------------------------------------------------------------ physics
    def _box_substep(self, bq, bv, wrench_sum):
        bsys, cp, h = self.box_sys, self.contact, self.h
        fk_b = engine.fwd_kinematics(bsys, bq, bv)
        p_b, v_b = engine.points_world(bsys, fk_b)
        pi_b = engine.point_inertia(bsys, fk_b, p_b)
        mu_bg = engine.combine_mu(bsys.point_friction, self.plane_friction, self.combine)
        f_b = engine.contact_plane(p_b, v_b, bsys.point_radius, mu_bg, cp, pi=pi_b, h=h)
        f_ext_b = engine.accumulate_body_forces(bsys, p_b, f_b, fk_b.base)
        f_ext_b = [f_ext_b[0] + wrench_sum]
        gravity = torch.tensor((0.0, 0.0, -9.81), dtype=bq.dtype, device=bq.device)
        bacc = engine.forward_dynamics(bsys, fk_b, bv, bq.new_zeros(bq.shape[:-1] + (0,)),
                                       f_ext_b, gravity)
        return engine.integrate(bsys, bq, bv, bacc, h)

    def physics(self, aq, av, bq, bv, actions):
        """One control step of E envs: ants on the scalar substep, the box on
        the free-body substep with the ants' summed wrench."""
        E = actions.shape[0]
        B = E * A
        tau = (actions * self.sys.gear * self.power_scale).to(torch.float32)
        qpos = aq.reshape(B, sp.NQ).t().contiguous()
        qvel = av.reshape(B, sp.NV).t().contiguous()
        tau = tau.reshape(B, sp.NJ).t().contiguous()
        for _ in range(self.substeps):
            bqa = bq.t().contiguous().repeat_interleave(A, dim=1)
            bva = bv.t().contiguous().repeat_interleave(A, dim=1)
            nqp, nqv, wr, _ = sp.substep(self.consts, list(qpos), list(qvel), list(tau),
                                         list(bqa), list(bva))
            qpos, qvel, wrench = torch.stack(nqp), torch.stack(nqv), torch.stack(wr)
            bq, bv = self._box_substep(bq, bv, wrench.reshape(6, E, A).sum(-1).t())
        return qpos.t().reshape(E, A, sp.NQ), qvel.t().reshape(E, A, sp.NV), bq, bv

    # -------------------------------------------------------------- step
    def step(self, s: State, actions, gen) -> State:
        """actions [E, 80] (clipped to +-1 by the trainer) -> the next state."""
        E = actions.shape[0]
        actions = actions.reshape(E, 10, 8)
        aq, av, bq, bv = self.physics(s.aq, s.av, s.bq, s.bv, actions)
        fq, fv, fbq, fbv = self._fresh(gen, E)
        finite = (torch.isfinite(aq).flatten(1).all(1) & torch.isfinite(av).flatten(1).all(1)
                  & torch.isfinite(bq).all(1) & torch.isfinite(bv).all(1))
        reset = s.done | ~finite
        r3, r2 = reset[:, None, None], reset[:, None]
        aq, av = torch.where(r3, fq, aq), torch.where(r3, fv, av)
        bq, bv = torch.where(r2, fbq, bq), torch.where(r2, fbv, bv)
        pos_before = torch.where(r3, fq[..., 0:2], s.pos_before)
        goal_before = torch.where(r3, self._goals(fbq), s.goal_before)
        progress = torch.where(reset, 0, s.progress + 1).to(torch.int32)
        obs = self._obs(aq, av, bq, actions)
        reward, done = self._reward(obs, actions, bq, pos_before, goal_before, progress)
        return State(aq, av, bq, bv, aq[..., 0:2], self._goals(bq), progress, done, obs, reward)

    def _reward(self, obs, actions, bq, pos_before, goal_before, progress):
        E = obs.shape[0]
        per_ant = obs[:, :10 * 38].reshape(E, 10, 38)
        goals = self._goals(bq)
        quat_dist = obs_math.box_quat_alignment(bq[:, 3:7])
        ant_xy = per_ant[..., 0:2]
        ant_push = 1.0 - (obs_math.l2_xy(ant_xy, goals) < 1.5).to(torch.float32)
        ant_dist = obs_math.l2_xy(pos_before, goal_before) - obs_math.l2_xy(ant_xy, goals)
        ant_dist_reward = torch.sum(500.0 * ant_dist * ant_push, dim=1)
        goal_dist_before = obs_math.l2_xy(self.box_targets_i, goal_before)
        goal_dist = obs_math.l2_xy(self.box_targets_i, goals)
        goal_arrive = (goal_dist < 0.5).to(torch.float32)
        goal_dist_reward = torch.sum(500.0 * (goal_dist_before - goal_dist), dim=1)
        goal_arrive_reward = torch.sum(2.0 * goal_arrive, dim=1)
        success_reward = (quat_dist > 0.9) * torch.prod(goal_arrive, dim=1) * 100.0
        up_reward = torch.sum(torch.where(per_ant[..., 12] > 0.93, self.up_weight, 0.0),
                              dim=1) * 10.0
        actions_cost = torch.sum(actions ** 2, dim=(1, 2))
        electricity_cost = torch.sum(torch.abs(actions * per_ant[..., 22:30]), dim=(1, 2))
        dof_at_limit_cost = torch.sum(per_ant[..., 14:22] > 0.99, dim=(1, 2))
        total = (5.0 + up_reward + 0.0 * quat_dist + ant_dist_reward
                 + goal_dist_reward + goal_arrive_reward + success_reward
                 - self.actions_cost_scale * actions_cost
                 - self.energy_cost_scale * electricity_cost
                 - self.joints_at_limit_cost_scale * dof_at_limit_cost)
        fallen = torch.any(per_ant[..., 2] < self.termination_height, dim=1)
        total = torch.where(fallen, torch.full_like(total, self.death_cost), total)
        return total, fallen | (progress >= self.max_episode_length - 1)
