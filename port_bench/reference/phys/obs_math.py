"""Observation math of the ant tasks (twin of
massive_marl_tpu/envs/obs_math.py), batched over leading axes."""
from __future__ import annotations

from typing import NamedTuple

import torch

from .maths import (get_euler_xyz, normalize, quat_rotate,
                                               quat_rotate_inverse, unscale)


class BodyFrameObs(NamedTuple):
    up_proj: torch.Tensor
    heading_proj: torch.Tensor
    vel_loc: torch.Tensor
    angvel_loc: torch.Tensor
    roll: torch.Tensor
    pitch: torch.Tensor
    yaw: torch.Tensor
    angle_to_target: torch.Tensor


def heading_and_rot(torso_pos, torso_quat, velocity, ang_velocity, targets) -> BodyFrameObs:
    """compute_heading_and_up + compute_rot of the original benchmark (the
    start rotation is identity, so torso_quat is the raw rotation)."""
    to_target = targets - torso_pos
    to_target = torch.cat([to_target[..., :2], torch.zeros_like(to_target[..., 2:])], dim=-1)
    target_dir = normalize(to_target)
    ez = torso_pos.new_tensor([0.0, 0.0, 1.0])
    ex = torso_pos.new_tensor([1.0, 0.0, 0.0])
    up_proj = quat_rotate(torso_quat, ez)[..., 2]
    heading_proj = torch.sum(quat_rotate(torso_quat, ex) * target_dir, dim=-1)
    vel_loc = quat_rotate_inverse(torso_quat, velocity)
    angvel_loc = quat_rotate_inverse(torso_quat, ang_velocity)
    roll, pitch, yaw = get_euler_xyz(torso_quat)
    # quirk kept from the original: the walk target angle uses the z delta in
    # place of y
    walk_target_angle = torch.atan2(targets[..., 2] - torso_pos[..., 2],
                                    targets[..., 0] - torso_pos[..., 0])
    return BodyFrameObs(up_proj, heading_proj, vel_loc, angvel_loc, roll, pitch, yaw,
                        walk_target_angle - yaw)


def ant_obs_38(qpos, qvel, actions, targets, dof_lower, dof_upper, dof_vel_scale):
    """Per-ant 38-dim observation: [pos3, vel_loc3, angvel_loc3, yaw, roll,
    angle_to_target, up_proj, heading_proj, dof_pos_scaled8, dof_vel*scale8,
    actions8]."""
    pos = qpos[..., 0:3]
    b = heading_and_rot(pos, qpos[..., 3:7], qvel[..., 0:3], qvel[..., 3:6], targets)
    return torch.cat([
        pos, b.vel_loc, b.angvel_loc,
        torch.stack([b.yaw, b.roll, b.angle_to_target, b.up_proj, b.heading_proj], dim=-1),
        unscale(qpos[..., 7:], dof_lower, dof_upper), qvel[..., 6:] * dof_vel_scale, actions,
    ], dim=-1)


def ant_obs_60(qpos, qvel, actions, sensors, targets, dof_lower, dof_upper, dof_vel_scale,
               contact_force_scale):
    """OneAnt's 60-dim observation: [z, vel_loc3, angvel_loc3, yaw, roll,
    angle_to_target, up_proj, heading_proj, dof_pos_scaled8, dof_vel*scale8,
    foot_sensors24*scale, actions8]; sensors [..., 4, 6]."""
    pos = qpos[..., 0:3]
    b = heading_and_rot(pos, qpos[..., 3:7], qvel[..., 0:3], qvel[..., 3:6], targets)
    return torch.cat([
        pos[..., 2:3], b.vel_loc, b.angvel_loc,
        torch.stack([b.yaw, b.roll, b.angle_to_target, b.up_proj, b.heading_proj], dim=-1),
        unscale(qpos[..., 7:], dof_lower, dof_upper), qvel[..., 6:] * dof_vel_scale,
        sensors.flatten(-2) * contact_force_scale, actions,
    ], dim=-1)


def box_yaw_goal_dir(box_quat):
    """(sin a, -cos a) with a = atan(2 qw qz / (1 - 2 qz^2)), the box-yaw goal
    direction."""
    qz, qw = box_quat[..., 2], box_quat[..., 3]
    angle = torch.atan(2 * qw * qz / (1 - 2 * qz * qz))
    return torch.stack([torch.sin(angle), -torch.cos(angle)], dim=-1)


def box_quat_alignment(box_quat, goal_axis=(0.0, 1.0, 0.0)):
    """Cosine between the box's rotated y-axis and the goal axis."""
    qx, qy, qz, qw = box_quat.unbind(-1)
    x = 2 * (qx * qy + qw * qz)
    y = 1 - 2 * (qx * qx + qz * qz)
    z = 2 * (qy * qz - qw * qx)
    gx, gy, gz = goal_axis
    num = x * gx + y * gy + z * gz
    den = torch.sqrt(x * x + y * y + z * z) * (gx * gx + gy * gy + gz * gz) ** 0.5
    return num / den


def l2_xy(a, b):
    d = a - b
    return torch.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2)
