"""Batched ant(+box) scene state and reset (twin of
massive_marl_tpu/envs/ant_scene.py).

One env = A ant articulations and, optionally, one free push-box.  Ants
never collide with each other; the box's material friction is 0 and pair
frictions follow `friction_combine`; actions are hinge torques
action * gear * power_scale.  The control step itself is
ops/fused_substep.fused_scene_step.  Domain randomization is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import torch

from massive_marl_tpu_torch.phys import engine
from massive_marl_tpu_torch.phys.system import System


@dataclasses.dataclass
class AntSceneState:
    ant_qpos: torch.Tensor   # [E, A, 15]
    ant_qvel: torch.Tensor   # [E, A, 14]
    box_qpos: torch.Tensor   # [E, 7] (identity pose when the scene has no box)
    box_qvel: torch.Tensor   # [E, 6]
    sensors: torch.Tensor    # [E, A, 4, 6] foot contact wrenches (foot frame)
    dr_count: torch.Tensor   # [E] int32, steps since the last randomization
    frame: torch.Tensor      # [E] int32, frames lived


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


def reset_scene(spec: AntSceneSpec, generator: torch.Generator, num_envs: int,
                ant_start: torch.Tensor, box_start: Optional[torch.Tensor],
                init_hinge: torch.Tensor, pos_noise: float = 0.2, vel_noise: float = 0.1,
                frame: Optional[torch.Tensor] = None) -> AntSceneState:
    """Fresh scene states for `num_envs` envs: roots at their spawn poses with
    zero velocity, hinge positions and rates perturbed uniformly.  As in the
    original, one noise vector per env is shared by all of its ants."""
    sys = spec.ant_sys
    E, A, nj = num_envs, spec.num_ants, sys.nj
    dev = ant_start.device
    u = torch.rand((2, E, nj), generator=generator, device=dev)
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
    return AntSceneState(
        ant_qpos=qpos, ant_qvel=qvel, box_qpos=box_qpos,
        box_qvel=torch.zeros((E, 6), device=dev),
        sensors=torch.zeros((E, A, max(sys.num_sensors, 1), 6), device=dev),
        dr_count=zeros_i, frame=zeros_i.clone() if frame is None else frame.to(torch.int32))
