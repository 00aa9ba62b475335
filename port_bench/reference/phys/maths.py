"""Quaternion / rotation math (PyTorch twin of massive_marl_tpu/phys/maths.py).

Quaternions are stored (x, y, z, w); angular velocities are world-frame;
Euler angles use the XYZ (roll, pitch, yaw) extraction.  Every function
batches over leading dimensions.
"""
from __future__ import annotations

import math

import torch


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis, with broadcasting."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b for xyzw quaternions."""
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    x = aw * bx + ax * bw + ay * bz - az * by
    y = aw * by - ax * bz + ay * bw + az * bx
    z = aw * bz + ax * by - ay * bx + az * bw
    w = aw * bw - ax * bx - ay * by - az * bz
    return torch.stack([x, y, z, w], dim=-1)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def quat_normalize(q: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=eps)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector v by quaternion q (body -> world for a body orientation)."""
    qvec = q[..., :3]
    qw = q[..., 3:4]
    t = 2.0 * cross(qvec, v)
    return v + qw * t + cross(qvec, t)


def quat_rotate_inverse(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return quat_rotate(quat_conjugate(q), v)


def quat_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """axis: (...,3) unit, angle: (...,) radians -> xyzw quaternion."""
    half = 0.5 * angle
    xyz = axis * torch.sin(half)[..., None]
    w = torch.cos(half)[..., None]
    return torch.cat([xyz, w], dim=-1)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(...,4) xyzw -> (...,3,3) rotation matrix."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def quat_integrate(q: torch.Tensor, omega_world: torch.Tensor, dt) -> torch.Tensor:
    """q' = normalize(q + (w dt/2, 0) * q) for a world-frame angular velocity."""
    dq = torch.cat([omega_world * (0.5 * dt), torch.zeros_like(q[..., 3:4])], dim=-1)
    return quat_normalize(q + quat_mul(dq, q))


def get_euler_xyz(q: torch.Tensor):
    """roll, pitch, yaw from an xyzw quaternion."""
    qx, qy, qz, qw = q.unbind(-1)
    sinr_cosp = 2.0 * (qw * qx + qy * qz)
    cosr_cosp = qw * qw - qx * qx - qy * qy + qz * qz
    roll = torch.atan2(sinr_cosp, cosr_cosp)
    sinp = 2.0 * (qw * qy - qz * qx)
    pitch = torch.where(torch.abs(sinp) >= 1.0,
                        torch.sign(sinp) * (math.pi / 2.0),
                        torch.asin(torch.clamp(sinp, -1.0, 1.0)))
    siny_cosp = 2.0 * (qw * qz + qx * qy)
    cosy_cosp = qw * qw + qx * qx - qy * qy - qz * qz
    yaw = torch.atan2(siny_cosp, cosy_cosp)
    return roll, pitch, yaw


def normalize(v: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=eps)


def unscale(x, lower, upper):
    """Map [lower, upper] -> [-1, 1]."""
    return (2.0 * x - upper - lower) / (upper - lower)


def mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched small mat-vec (..., i, j) x (..., j), summed in index order."""
    return torch.sum(m * v[..., None, :], dim=-1)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched small mat-mat (..., i, k) x (..., k, j)."""
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


def skew(v: torch.Tensor) -> torch.Tensor:
    """(...,3) -> (...,3,3) cross-product matrix: skew(v) @ u == v x u."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))
