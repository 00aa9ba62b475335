"""Minimal MJCF parser producing a `System` (PyTorch twin of
massive_marl_tpu/phys/mjcf.py).

Covers nested <body> trees with a free base and one hinge per non-base
body, sphere/capsule/box/cylinder <geom> (with fromto), a single-level
<default> for joint/geom, degree angles, density-derived inertia and
<actuator><motor gear=...>.  An asset whose bodies do not each carry one
hinge (ingenuity.xml: a hinge on the base and locked rotor joints) is welded
into one rigid free body: every geom moves into the base body with its
body's fixed transform composed from the root, so nb = 1 and nj = 0.
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np
import torch

from .maths import quat_mul
from .system import (BOX, CAPSULE, CYLINDER, SPHERE, GeomSpec, System, _quat_to_mat_np,
                     build_body_inertia, make_contact_points)

_GEOM_TYPES = {"sphere": SPHERE, "capsule": CAPSULE, "box": BOX,
               "cylinder": CYLINDER, "plane": -1, "mesh": -2}


def _fvec(s, n=None):
    v = np.array([float(x) for x in s.split()])
    if n is not None and len(v) != n:
        raise ValueError(f"expected {n} numbers, got {s!r}")
    return v


def _axis_to_quat(axis):
    """xyzw quat rotating +z onto `axis`."""
    axis = axis / np.linalg.norm(axis)
    z = np.array([0.0, 0.0, 1.0])
    c = float(np.dot(z, axis))
    if c > 1 - 1e-8:
        return np.array([0.0, 0.0, 0.0, 1.0])
    if c < -1 + 1e-8:
        return np.array([1.0, 0.0, 0.0, 0.0])
    cr = np.cross(z, axis)
    s = np.linalg.norm(cr)
    half = np.arctan2(s, c) / 2.0
    return np.array([*(cr / s * np.sin(half)), np.cos(half)])


def _mj_quat_to_xyzw(q):
    w, x, y, z = q
    return np.array([x, y, z, w])


class MjcfModel:
    """Parsed MJCF: a System plus actuator metadata."""

    def __init__(self, system: System, gear_dof: np.ndarray, init_hinge: np.ndarray):
        self.system = system
        self.gear_dof = gear_dof      # [nj] actuator gear per dof
        self.init_hinge = init_hinge  # [nj] default hinge angles (0 clamped into range)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32))


def _quat_mul_np(a, b):
    return quat_mul(torch.as_tensor(a, dtype=torch.float64),
                    torch.as_tensor(b, dtype=torch.float64)).numpy()


def _weld(body_names, parents, body_pos, body_quat, geoms):
    """Merge every body into the base: each body's transform from the base
    frame (the bodies' fixed offsets composed down the tree; the base's own
    offset excluded) is applied to its geoms, which then belong to body 0."""
    X = {0: (np.zeros(3), np.array([0.0, 0.0, 0.0, 1.0]))}
    for b in range(1, len(body_names)):
        pp, pq = X[parents[b]]
        X[b] = (pp + _quat_to_mat_np(pq) @ body_pos[b], _quat_mul_np(pq, body_quat[b]))
    merged = []
    for g in geoms:
        p, q = X[g.body]
        merged.append(GeomSpec(body=0, gtype=g.gtype, size=g.size,
                               pos=p + _quat_to_mat_np(q) @ g.pos, quat=_quat_mul_np(q, g.quat),
                               density=g.density, friction=g.friction, contact=g.contact))
    return [body_names[0]], [-1], [body_pos[0]], [body_quat[0]], merged


def parse_mjcf(path: str) -> MjcfModel:
    root = ET.parse(path).getroot()

    compiler = root.find("compiler")
    degrees = compiler is None or compiler.get("angle", "degree") == "degree"
    ang = (np.pi / 180.0) if degrees else 1.0

    jd = {"armature": 0.0, "damping": 0.0}
    gd = {"density": 1000.0, "friction": 1.0}
    default = root.find("default")
    if default is not None:
        dj = default.find("joint")
        if dj is not None:
            jd["armature"] = float(dj.get("armature", 0.0))
            jd["damping"] = float(dj.get("damping", 0.0))
        dg = default.find("geom")
        if dg is not None:
            gd["density"] = float(dg.get("density", 1000.0))
            fr = dg.get("friction")
            if fr is not None:
                gd["friction"] = float(fr.split()[0])

    body_names, parents, body_pos, body_quat, geoms = [], [], [], [], []
    jnt_axis, jnt_pos, jnt_range, jnt_armature, jnt_damping, jnt_names = [], [], [], [], [], []

    def parse_geom(el, body_id):
        gtype = _GEOM_TYPES.get(el.get("type", "sphere"))
        if gtype is None or gtype < 0:
            return
        density = float(el.get("density", gd["density"]))
        fr = el.get("friction")
        friction = float(fr.split()[0]) if fr else gd["friction"]
        contact = el.get("contype", "1") != "0" or el.get("conaffinity", "1") != "0"
        if el.get("fromto") is not None:
            ft = _fvec(el.get("fromto"), 6)
            p1, p2 = ft[:3], ft[3:]
            d = p2 - p1
            hl = 0.5 * np.linalg.norm(d)
            quat = _axis_to_quat(d) if hl > 1e-9 else np.array([0, 0, 0, 1.0])
            size = np.array([_fvec(el.get("size"))[0], hl, 0.0])
            pos = 0.5 * (p1 + p2)
        else:
            size_in = _fvec(el.get("size", "0.1"))
            size = np.zeros(3)
            size[: len(size_in)] = size_in
            pos = _fvec(el.get("pos", "0 0 0"), 3)
            quat = _mj_quat_to_xyzw(_fvec(el.get("quat", "1 0 0 0"), 4))
        geoms.append(GeomSpec(body=body_id, gtype=gtype, size=size, pos=pos, quat=quat,
                              density=density, friction=friction, contact=contact))

    def parse_body(el, parent_id):
        body_id = len(body_names)
        body_names.append(el.get("name", f"body{body_id}"))
        parents.append(parent_id)
        body_pos.append(_fvec(el.get("pos", "0 0 0"), 3))
        body_quat.append(_mj_quat_to_xyzw(_fvec(el.get("quat", "1 0 0 0"), 4)))
        for j in el.findall("joint"):
            if j.get("type", "hinge") == "free":
                continue
            rng = j.get("range")
            locked = rng is not None and _fvec(rng)[0] == _fvec(rng)[1] == 0.0
            if parent_id == -1 or locked:
                continue
            jnt_names.append(j.get("name", f"joint{len(jnt_names)}"))
            ax = _fvec(j.get("axis", "0 0 1"), 3)
            jnt_axis.append(ax / np.linalg.norm(ax))
            jnt_pos.append(_fvec(j.get("pos", "0 0 0"), 3))
            jnt_range.append(_fvec(rng, 2) * ang if rng is not None else np.array([-1e6, 1e6]))
            jnt_armature.append(float(j.get("armature", jd["armature"])))
            jnt_damping.append(float(j.get("damping", jd["damping"])))
        for g in el.findall("geom"):
            parse_geom(g, body_id)
        for child in el.findall("body"):
            parse_body(child, body_id)

    top_bodies = root.find("worldbody").findall("body")
    if len(top_bodies) != 1:
        raise ValueError("one root body per asset")
    parse_body(top_bodies[0], -1)

    nb, nj = len(body_names), len(jnt_names)
    if nj != nb - 1:
        body_names, parents, body_pos, body_quat, geoms = _weld(
            body_names, parents, body_pos, body_quat, geoms)
        nb, nj = 1, 0
        jnt_axis, jnt_pos, jnt_range, jnt_armature, jnt_damping, jnt_names = \
            [], [], [], [], [], []

    foot_body_ids = [i for i, n in enumerate(body_names) if "foot" in n]
    for g in geoms:
        g.sensor = foot_body_ids.index(g.body) if g.body in foot_body_ids else -1

    mass, com, inertia = build_body_inertia(geoms, nb)
    pb, ps, pl, pr, pf = make_contact_points(geoms)

    gear_dof = np.zeros(max(nj, 1), np.float32)
    actuator = root.find("actuator")
    if actuator is not None and nj > 0:
        for m in actuator.findall("motor"):
            if m.get("joint") in jnt_names:
                gear_dof[jnt_names.index(m.get("joint"))] = float(m.get("gear", 1.0))
    jnt_range_arr = (np.array(jnt_range, np.float32).reshape(nj, 2) if nj
                     else np.zeros((0, 2), np.float32))
    init_hinge = (np.clip(0.0, jnt_range_arr[:, 0], jnt_range_arr[:, 1]) if nj
                  else np.zeros((0,), np.float32))

    system = System(
        parent=tuple(parents), body_names=tuple(body_names),
        point_body=pb, point_sensor=ps, num_sensors=len(foot_body_ids),
        body_pos=_f32(np.array(body_pos)), body_quat=_f32(np.array(body_quat)),
        mass=_f32(mass), com=_f32(com), inertia=_f32(inertia),
        jnt_axis=_f32(np.array(jnt_axis).reshape(nj, 3)),
        jnt_pos=_f32(np.array(jnt_pos).reshape(nj, 3)),
        jnt_range=_f32(jnt_range_arr),
        armature=_f32(np.array(jnt_armature).reshape(nj)),
        damping=_f32(np.array(jnt_damping).reshape(nj)),
        gear=_f32(gear_dof[:nj]),
        point_local=_f32(pl.reshape(-1, 3)), point_radius=_f32(pr),
        point_friction=_f32(pf),
    )
    return MjcfModel(system, gear_dof[:nj], init_hinge)


def make_box_system(half_extents, density=1.0, friction=0.0) -> System:
    """A single free box body (the TenAnt push-box is 1x28x1 with its
    material friction forced to 0)."""
    hx, hy, hz = half_extents
    g = GeomSpec(body=0, gtype=BOX, size=np.array([hx, hy, hz]),
                 pos=np.zeros(3), quat=np.array([0, 0, 0, 1.0]),
                 density=density, friction=friction)
    mass, com, inertia = build_body_inertia([g], 1)
    pb, ps, pl, pr, pf = make_contact_points([g])
    return System(
        parent=(-1,), body_names=("box",), point_body=pb, point_sensor=ps,
        num_sensors=0,
        body_pos=torch.zeros((1, 3)), body_quat=torch.tensor([[0.0, 0.0, 0.0, 1.0]]),
        mass=_f32(mass), com=_f32(com), inertia=_f32(inertia),
        jnt_axis=torch.zeros((0, 3)), jnt_pos=torch.zeros((0, 3)),
        jnt_range=torch.zeros((0, 2)), armature=torch.zeros((0,)),
        damping=torch.zeros((0,)), gear=torch.zeros((0,)),
        point_local=_f32(pl.reshape(-1, 3)), point_radius=_f32(pr),
        point_friction=_f32(pf),
    )


def asset_path(name: str) -> str:
    """Path of an asset shipped with this package (assets/)."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(here, "assets", name)
