"""Batched ant(+box) scene: state, reset and the array-path control step
(twin of massive_marl_tpu/envs/ant_scene.py).

One env = A ant articulations and, optionally, one free push-box.  Ants
never collide with each other; the box's material friction is 0 and pair
frictions follow `friction_combine`; actions are hinge torques
action * gear * power_scale.  A control step runs either here on the array
engine (`scene_step`, the reference's path off the TPU), or on the substep
kernel (ops/fused_substep.fused_scene_step); both take the push-box's
free-body substep from `box_substep`.  Joint damping and the joint-limit
spring and damping integrate implicitly.

Domain randomization: with `dr_spec` set, state.dr holds a DrSample per ant
([E, A, ...] leaves) that overrides mass, damping, armature and the joint
limits on both paths; `dr_count` and `frame` drive the re-randomization
gating and the schedules (phys/dr.py), and `corr_act` / `corr_obs` hold
the standard-normal draws of the correlated action and observation noise
until the env re-randomizes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import torch

from massive_marl_tpu_torch.parallel.mesh import draw
from massive_marl_tpu_torch.phys import dr as dr_mod
from massive_marl_tpu_torch.phys import engine
from massive_marl_tpu_torch.phys.system import System
from massive_marl_tpu_torch.utils.profiling import spanned


@dataclasses.dataclass
class AntSceneState:
    ant_qpos: torch.Tensor   # [E, A, 15]
    ant_qvel: torch.Tensor   # [E, A, 14]
    box_qpos: torch.Tensor   # [E, 7] (identity pose when the scene has no box)
    box_qvel: torch.Tensor   # [E, 6]
    sensors: torch.Tensor    # [E, A, 4, 6] foot contact wrenches (foot frame)
    dr_count: torch.Tensor   # [E] int32, steps since the last randomization
    frame: torch.Tensor      # [E] int32, frames lived
    # with domain randomization: the per-ant DrSample ([E, A, ...] leaves)
    # and the correlated noise draws ([E, *action shape], [E, obs]); the
    # empty tuple without it
    dr: Any = ()
    corr_act: Any = ()
    corr_obs: Any = ()


class AntSceneSpec(NamedTuple):
    ant_sys: System
    box_sys: Optional[System]
    box_half_extents: Optional[Tuple[float, float, float]]
    num_ants: int
    dt: float = 0.0166
    substeps: int = 3
    power_scale: float = 1.0
    gravity: Tuple[float, float, float] = (0.0, 0.0, -9.81)
    contact: engine.ContactParams = engine.ContactParams()
    # pair friction = combine(material_a, material_b); 'average' is PhysX's
    # default combine mode, which the original benchmark never overrides
    plane_friction: float = 1.0
    friction_combine: str = "average"
    ant_box_mu: Optional[float] = None     # ant-box pair override
    box_ground_mu: Optional[float] = None  # box-ground pair override
    dr_spec: Any = None
    limit_k: Optional[float] = None        # None = engine.LIMIT_K
    limit_damp: Optional[float] = None     # None = engine.LIMIT_DAMP


@spanned("env.box_substep")
def box_substep(spec: AntSceneSpec, bq, bv, wrench_sum, h):
    """One free-body substep of the push-box for every env ([E,7], [E,6]),
    with the summed ant contact wrench about the box origin folded in."""
    bsys, cp = spec.box_sys, spec.contact
    fk_b = engine.fwd_kinematics(bsys, bq, bv)
    p_b, v_b = engine.points_world(bsys, fk_b)
    pi_b = engine.point_inertia(bsys, fk_b, p_b)
    mu_bg = (spec.box_ground_mu if spec.box_ground_mu is not None
             else engine.combine_mu(bsys.point_friction, spec.plane_friction,
                                    spec.friction_combine))
    f_b = engine.contact_plane(p_b, v_b, bsys.point_radius, mu_bg, cp, pi=pi_b, h=h)
    f_ext_b = engine.accumulate_body_forces(bsys, p_b, f_b, fk_b.base)
    f_ext_b = [f_ext_b[0] + wrench_sum]
    gravity = torch.tensor(spec.gravity, dtype=bq.dtype, device=bq.device)
    bacc = engine.forward_dynamics(bsys, fk_b, bv, bq.new_zeros(bq.shape[:-1] + (0,)),
                                   f_ext_b, gravity)
    return engine.integrate(bsys, bq, bv, bacc, h)


def scene_step(spec: AntSceneSpec, state: AntSceneState, actions: torch.Tensor) -> AntSceneState:
    """Advance one control step on the array engine.  state has a leading
    env axis (ant_qpos [E,A,15], box_qpos [E,7]); actions [E,A,8] in [-1,1].

    Per substep and ant: plane contacts, and box contacts against the box
    state at the start of the substep; foot sensors; the joint-limit spring
    with its damping and stiffness (and the joints' own damping) implicit in
    the solve.  Then the box's free-body substep with the ants' summed
    wrench.  The sensors are the last substep's.  As in the reference, the
    contacts always take the implicit branch here (the point inertia and the
    substep are given), whatever ContactParams.beta is.  With spec.dr_spec
    set, every ant steps with its own parameters from state.dr."""
    sys, cp = spec.ant_sys, spec.contact
    if spec.dr_spec is not None:
        sys = state.dr.apply(sys)
    h = spec.dt / spec.substeps
    gravity = torch.tensor(spec.gravity, dtype=actions.dtype, device=actions.device)
    tau_act = actions * sys.gear * spec.power_scale
    has_box = spec.box_sys is not None
    mu_plane = engine.combine_mu(sys.point_friction, spec.plane_friction, spec.friction_combine)
    if has_box:
        bsys = spec.box_sys
        box_inv = (1.0 / bsys.mass[0], engine._inv3x3_sym(bsys.inertia[0]))
        mu_box = (spec.ant_box_mu if spec.ant_box_mu is not None
                  else engine.combine_mu(sys.point_friction, float(bsys.point_friction[0]),
                                         spec.friction_combine))
    limit_k = spec.limit_k if spec.limit_k is not None else engine.LIMIT_K
    limit_damp = spec.limit_damp if spec.limit_damp is not None else engine.LIMIT_DAMP

    aq, av, bq, bv = state.ant_qpos, state.ant_qvel, state.box_qpos, state.box_qvel
    for _ in range(spec.substeps):
        fk = engine.fwd_kinematics(sys, aq, av)
        p_w, v_w = engine.points_world(sys, fk)
        pi = engine.point_inertia(sys, fk, p_w)
        f_pts = engine.contact_plane(p_w, v_w, sys.point_radius, mu_plane, cp, pi=pi, h=h)
        if has_box:
            f_box, wrench = engine.contact_box(
                p_w, v_w, sys.point_radius, mu_box, bq[:, None, 0:3], bq[:, None, 3:7],
                bv[:, None, :], spec.box_half_extents, cp, pi=pi, h=h, box_inv=box_inv)
            f_pts = f_pts + f_box
        f_ext = engine.accumulate_body_forces(sys, p_w, f_pts, fk.base)
        sensors = engine.sensor_forces(sys, f_pts, fk, p_w)
        t_lim, d_lim, k_lim = engine.joint_limit_spring(sys, aq, k=limit_k, damp=limit_damp)
        qacc = engine.forward_dynamics(sys, fk, av, tau_act + t_lim, f_ext, gravity,
                                       imp_damping=sys.damping + d_lim, h=h,
                                       imp_stiffness=k_lim)
        if has_box:
            bq, bv = box_substep(spec, bq, bv, wrench.sum(dim=1), h)
        aq, av = engine.integrate(sys, aq, av, qacc, h)
    return dataclasses.replace(state, ant_qpos=aq, ant_qvel=av, box_qpos=bq, box_qvel=bv,
                               sensors=sensors, dr_count=state.dr_count + 1,
                               frame=state.frame + 1)


def reset_scene(spec: AntSceneSpec, generator: torch.Generator, num_envs: int,
                ant_start: torch.Tensor, box_start: Optional[torch.Tensor],
                init_hinge: torch.Tensor, pos_noise: float = 0.2, vel_noise: float = 0.1,
                frame: Optional[torch.Tensor] = None,
                corr_shapes: Optional[Tuple[tuple, tuple]] = None) -> AntSceneState:
    """Fresh scene states for `num_envs` envs: roots at their spawn poses with
    zero velocity, hinge positions and rates perturbed uniformly.  As in the
    original, one noise vector per env is shared by all of its ants.  With
    spec.dr_spec set, every ant gets its own DrSample (the schedules read
    `frame`); corr_shapes (per-env action and observation shapes) draws the
    correlated noise's standard normals."""
    sys = spec.ant_sys
    E, A, nj = num_envs, spec.num_ants, sys.nj
    dev = ant_start.device
    u = draw(torch.rand, (2, E, nj), generator, axis=1, device=dev)
    dpos = u[0] * (2 * pos_noise) - pos_noise
    dvel = u[1] * (2 * vel_noise) - vel_noise
    hinge = torch.clamp(init_hinge + dpos, sys.jnt_range[:, 0], sys.jnt_range[:, 1])
    quat = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev)
    qpos = torch.cat([ant_start.expand(E, A, 3), quat.expand(E, A, 4),
                      hinge[:, None, :].expand(E, A, nj)], dim=-1)
    qvel = torch.zeros((E, A, sys.nv), device=dev)
    qvel[..., 6:] = dvel[:, None, :]
    if box_start is not None:
        box_qpos = torch.cat([box_start, quat]).expand(E, 7).clone()
    else:
        box_qpos = quat.new_tensor([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0]).expand(E, 7).clone()
    zeros_i = torch.zeros(E, dtype=torch.int32, device=dev)
    dr, corr_act, corr_obs = (), (), ()
    if spec.dr_spec is not None:
        dr = dr_mod.sample_dr(sys, spec.dr_spec, (E, A), generator,
                              None if frame is None else frame[:, None])
    if corr_shapes is not None:
        corr_act, corr_obs = (draw(torch.randn, (E,) + tuple(sh), generator, device=dev)
                              for sh in corr_shapes)
    return AntSceneState(
        ant_qpos=qpos, ant_qvel=qvel, box_qpos=box_qpos,
        box_qvel=torch.zeros((E, 6), device=dev),
        sensors=torch.zeros((E, A, max(sys.num_sensors, 1), 6), device=dev),
        dr_count=zeros_i, frame=zeros_i.clone() if frame is None else frame.to(torch.int32),
        dr=dr, corr_act=corr_act, corr_obs=corr_obs)
