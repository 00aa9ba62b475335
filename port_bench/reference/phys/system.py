"""Static description of one articulated rigid-body system (PyTorch twin of
massive_marl_tpu/phys/system.py).

A `System` is a plain dataclass: topology and metadata are Python values,
physical parameters are float32 tensors.  Supported topology: a free-joint
base body plus a tree of one-hinge bodies, so nq = 7 + nj and nv = 6 + nj.

qpos layout: [x, y, z, qx, qy, qz, qw, hinge_0 .. hinge_{nj-1}]
qvel layout: [vx, vy, vz, wx, wy, wz, hinge rates...] (world-frame linear
velocity of the base origin and world-frame angular velocity).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

# geom type codes
SPHERE = 0
CAPSULE = 1
BOX = 2
CYLINDER = 3


@dataclasses.dataclass
class System:
    parent: Tuple[int, ...]          # per body, -1 = the free base
    body_names: Tuple[str, ...]
    point_body: Tuple[int, ...]      # contact sample point -> body
    point_sensor: Tuple[int, ...]    # contact sample point -> foot sensor (-1 none)
    num_sensors: int

    body_pos: torch.Tensor   # [nb,3] fixed offset from the parent frame
    body_quat: torch.Tensor  # [nb,4] xyzw fixed rotation from the parent frame
    mass: torch.Tensor       # [nb]
    com: torch.Tensor        # [nb,3] com in the body frame
    inertia: torch.Tensor    # [nb,3,3] about the com, body frame

    jnt_axis: torch.Tensor   # [nj,3] in the child body frame
    jnt_pos: torch.Tensor    # [nj,3] anchor in the child body frame
    jnt_range: torch.Tensor  # [nj,2] radians
    armature: torch.Tensor   # [nj]
    damping: torch.Tensor    # [nj]
    gear: torch.Tensor       # [nj] actuator gear

    point_local: torch.Tensor     # [P,3]
    point_radius: torch.Tensor    # [P]
    point_friction: torch.Tensor  # [P]

    @property
    def nb(self) -> int:
        return len(self.parent)

    @property
    def nj(self) -> int:
        return self.nb - 1

    @property
    def nq(self) -> int:
        return 7 + self.nj

    @property
    def nv(self) -> int:
        return 6 + self.nj

    @property
    def np_points(self) -> int:
        return len(self.point_body)

    def to(self, device) -> "System":
        """A copy with every tensor field on `device`."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def _geom_mass_com_inertia(gtype: int, size: np.ndarray, density: float):
    """Mass and inertia about the geom com in the geom frame (z = axis)."""
    if gtype == SPHERE:
        r = size[0]
        m = density * 4.0 / 3.0 * np.pi * r**3
        i = 0.4 * m * r * r
        I = np.diag([i, i, i])
    elif gtype == CAPSULE:
        r, hl = size[0], size[1]
        L = 2 * hl
        m_cyl = density * np.pi * r * r * L
        m_cap = density * 4.0 / 3.0 * np.pi * r**3
        m = m_cyl + m_cap
        ixx_cyl = m_cyl * (L * L / 12.0 + r * r / 4.0)
        izz_cyl = m_cyl * r * r / 2.0
        m_h = m_cap / 2.0
        izz_h = 0.4 * m_h * r * r
        ixx_h_com = m_h * (0.4 * r * r - (3.0 * r / 8.0) ** 2)
        d = hl + 3.0 * r / 8.0
        ixx = ixx_cyl + 2.0 * (ixx_h_com + m_h * d * d)
        izz = izz_cyl + 2.0 * izz_h
        I = np.diag([ixx, ixx, izz])
    elif gtype == BOX:
        sx, sy, sz = size
        m = density * 8.0 * sx * sy * sz
        I = np.diag([m / 3.0 * (sy * sy + sz * sz),
                     m / 3.0 * (sx * sx + sz * sz),
                     m / 3.0 * (sx * sx + sy * sy)])
    elif gtype == CYLINDER:
        r, hl = size[0], size[1]
        L = 2 * hl
        m = density * np.pi * r * r * L
        ixx = m * (L * L / 12.0 + r * r / 4.0)
        I = np.diag([ixx, ixx, m * r * r / 2.0])
    else:
        raise ValueError(f"unknown geom type {gtype}")
    return m, I


def _quat_to_mat_np(q):
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


@dataclasses.dataclass
class GeomSpec:
    """Host-side geom record used while building a System."""
    body: int
    gtype: int
    size: np.ndarray          # sphere:[r], capsule:[r,hl], box half-extents
    pos: np.ndarray           # geom frame origin in the body frame
    quat: np.ndarray          # xyzw in the body frame
    density: float
    friction: float
    contact: bool = True
    sensor: int = -1


def build_body_inertia(geoms, nb: int):
    """Per-body (mass, com, inertia) from the geoms (MJCF inertiafromgeom)."""
    mass = np.zeros(nb)
    first_moment = np.zeros((nb, 3))
    for g in geoms:
        m, _ = _geom_mass_com_inertia(g.gtype, g.size, g.density)
        mass[g.body] += m
        first_moment[g.body] += m * g.pos
    com = np.where(mass[:, None] > 0, first_moment / np.maximum(mass[:, None], 1e-12), 0.0)
    inertia = np.zeros((nb, 3, 3))
    for g in geoms:
        m, I_geom = _geom_mass_com_inertia(g.gtype, g.size, g.density)
        R = _quat_to_mat_np(g.quat)
        d = g.pos - com[g.body]
        inertia[g.body] += R @ I_geom @ R.T + m * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
    mass = np.maximum(mass, 1e-9)
    for b in range(nb):
        if np.trace(inertia[b]) <= 0:
            inertia[b] = np.eye(3) * 1e-9
    return mass, com, inertia


def make_contact_points(geoms, samples_per_capsule: int = 3):
    """Contact sample points (body frame): capsules as `samples_per_capsule`
    spheres along the axis, spheres as one point, boxes as their 8 corners
    (radius 0), cylinders as their two end centres."""
    body_ids, sensors, locals_, radii, frictions = [], [], [], [], []
    for g in geoms:
        if not g.contact:
            continue
        if g.gtype == SPHERE:
            pts = [g.pos]
            r = g.size[0]
        elif g.gtype == CAPSULE:
            axis = _quat_to_mat_np(g.quat)[:, 2]
            hl = g.size[1]
            pts = [g.pos + t * hl * axis for t in np.linspace(-1.0, 1.0, samples_per_capsule)]
            r = g.size[0]
        elif g.gtype == BOX:
            R = _quat_to_mat_np(g.quat)
            sx, sy, sz = g.size
            pts = [g.pos + R @ np.array([ex * sx, ey * sy, ez * sz])
                   for ex in (-1, 1) for ey in (-1, 1) for ez in (-1, 1)]
            r = 0.0
        elif g.gtype == CYLINDER:
            axis = _quat_to_mat_np(g.quat)[:, 2]
            pts = [g.pos - g.size[1] * axis, g.pos + g.size[1] * axis]
            r = g.size[0]
        else:
            continue
        for p in pts:
            body_ids.append(g.body)
            sensors.append(g.sensor)
            locals_.append(p)
            radii.append(r)
            frictions.append(g.friction)
    return (tuple(body_ids), tuple(sensors), np.array(locals_, np.float32),
            np.array(radii, np.float32), np.array(frictions, np.float32))
