"""Scalar-form (structure-of-arrays) ant substep: the plain PyTorch version of
the CUDA kernel in ops/csrc/substep.cu.

An op-for-op port of massive_marl_tpu/ops/scalar_phys.py::substep and
_contact_force: every physical scalar is its own [B] tensor (one lane per
articulation) and every model constant is a Python float.  The constants
come from one flat float32 table (`bake_consts`) that the kernel reads too,
so the two versions share every number, including the host-side derived
ones (inverse masses and inertias, per-point pair frictions, composite
masses), which are computed in float64 and rounded once, as the reference
bakes them.

Conventions: xyzw quaternions, spatial vectors [angular; linear] about the
base origin, qvel = [v_base(world), omega(world), hinges].  Both contact
branches of the reference are here: with `ContactParams.beta` set, the
implicit effective-mass normal force with exact-stiction friction; with
`beta=None` (the table's `legacy` flag), the explicit spring-damper with
friction ramped over `friction_vel`, which reads no inverse inertia (so a
box scene may then come without box_inv).  The joint limits are implicit in
both.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .engine import (LIMIT_DAMP, LIMIT_K, ContactParams,
                                                cholesky_solve_rows, combine_mu, dof_chains)

# articulation shape the kernel is compiled for (the ant: torso + 4 legs + 4 feet)
NB, NJ, NV, NQ, NS = 9, 8, 14, 15, 4
# velocity clamps of the semi-implicit integrator (PhysX-style defaults)
MAX_LIN_VEL, MAX_ANG_VEL, MAX_DOF_VEL = 200.0, 64.0, 64.0


# ---------------------------------------------------------------------------
# the constant table
# ---------------------------------------------------------------------------

def table_layout(P: int) -> List[Tuple[str, int]]:
    """Field order and sizes of the flat table.  ops/csrc/substep.cu declares
    the same offsets; the kernel wrapper checks the total length."""
    return [
        ("gravity", 3), ("h", 1), ("h2", 1), ("half_h", 1),
        ("kn", 1), ("kd", 1), ("max_depen_vel", 1), ("hc_vel", 1), ("hc_cap", 1),
        ("acc_units", 1), ("legacy", 1), ("friction_vel", 1),
        ("limit_k", 1), ("limit_damp", 1),
        ("max_lin_vel", 1), ("max_ang_vel", 1), ("max_dof_vel", 1),
        ("has_box", 1), ("box_he", 3), ("box_inv_mass", 1), ("box_inv_inertia", 9),
        ("parent", NB), ("body_sensor", NB), ("point_start", NB + 1), ("chain_mask", NV),
        ("body_pos", NB * 3), ("body_quat", NB * 4), ("jnt_axis", NJ * 3), ("jnt_pos", NJ * 3),
        ("jnt_lo", NJ), ("jnt_hi", NJ), ("armature", NJ), ("damping", NJ),
        ("mass", NB), ("inv_mass", NB), ("comp_mass", NB), ("com", NB * 3),
        ("inertia", NB * 9), ("inertia_inv_aug", NB * 9),
        ("point_local", P * 3), ("point_radius", P), ("mu_plane", P), ("mu_box", P),
    ]


@dataclasses.dataclass(frozen=True)
class SubstepParams:
    """Scene and solver options baked into the table."""
    h: float
    gravity: Tuple[float, float, float] = (0.0, 0.0, -9.81)
    contact: ContactParams = ContactParams()
    plane_friction: float = 1.0
    box_friction: float = 0.0          # box material friction
    friction_combine: str = "multiply"
    ant_box_mu: Optional[float] = None  # ant-box pair override
    limit_k: Optional[float] = None
    limit_damp: Optional[float] = None
    box_he: Optional[Tuple[float, float, float]] = None  # None = no box
    box_inv: Optional[tuple] = None     # (1/m, 3x3 body-frame inverse inertia);
                                        # not read on the legacy branch


def _inv3x3_sym_t(m, one=1.0):
    """Closed-form inverse of a symmetric 3x3 given as nested tuples of
    Python floats, or of [B] tensors (then `one` is a tensor of ones, so the
    reciprocal is a true division, as in the kernel)."""
    a, b, cc = m[0][0], m[0][1], m[0][2]
    d, e, f = m[1][1], m[1][2], m[2][2]
    A = d * f - e * e
    B = cc * e - b * f
    C = b * e - cc * d
    det = a * A + b * B + cc * C
    D = a * f - cc * cc
    E = b * cc - a * e
    F = a * d - b * b
    inv = one / det
    return ((A * inv, B * inv, C * inv), (B * inv, D * inv, E * inv), (C * inv, E * inv, F * inv))


@dataclasses.dataclass
class AntConsts:
    """The flat table plus the same numbers as Python floats (read back from
    the float32 table, so both versions see identical constants)."""
    table: torch.Tensor   # [table_len] float32, CPU
    P: int
    has_box: bool
    legacy: bool          # the table's legacy flag: the explicit contact branch
    f: dict               # field name -> list of Python floats
    parent: Tuple[int, ...]
    point_body: Tuple[int, ...]
    point_sensor: Tuple[int, ...]
    num_sensors: int
    body_of_dof: Tuple[int, ...]
    chains: Tuple[Tuple[int, ...], ...]
    _device_tables: dict = dataclasses.field(default_factory=dict, repr=False)

    def device_table(self, device) -> torch.Tensor:
        """The table on `device`, copied once per device."""
        key = str(torch.device(device))
        if key not in self._device_tables:
            self._device_tables[key] = self.table.to(device)
        return self._device_tables[key]


def bake_consts(sys, params: SubstepParams) -> AntConsts:
    """System + options -> the flat constant table (float32)."""
    if (sys.nb, sys.nj, sys.num_sensors) != (NB, NJ, NS):
        raise ValueError(f"the substep is compiled for nb={NB}, nj={NJ}, "
                         f"{NS} sensors; got {sys.nb}, {sys.nj}, {sys.num_sensors}")
    pb = list(sys.point_body)
    if pb != sorted(pb):
        raise ValueError("contact points must be grouped by body in body order")
    P = len(pb)
    cp = params.contact
    legacy = cp.beta is None
    has_box = params.box_he is not None
    if has_box and params.box_inv is None and not legacy:
        raise ValueError("a box scene needs box_inv (only the legacy branch reads none)")
    f64 = lambda x: np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x,
                               np.float64)
    mass = f64(sys.mass)
    inertia = f64(sys.inertia)
    armature = f64(sys.armature)
    friction = f64(sys.point_friction)
    jnt_range = f64(sys.jnt_range)
    body_of_dof, chains = dof_chains(sys)

    inv_aug = []
    for b in range(NB):
        I_aug = inertia[b].copy()
        if b > 0:
            I_aug[np.diag_indices(3)] += armature[b - 1]
        inv_aug.append(_inv3x3_sym_t(I_aug.tolist()))
    comp_mass = mass.tolist()
    for b in range(NB - 1, 0, -1):
        comp_mass[sys.parent[b]] = comp_mass[sys.parent[b]] + comp_mass[b]
    body_sensor = [-1] * NB
    for b, s in zip(sys.point_body, sys.point_sensor):
        if s >= 0:
            body_sensor[b] = s
    point_start = [pb.index(b) if b in pb else None for b in range(NB)] + [P]
    for b in range(NB - 1, -1, -1):
        if point_start[b] is None:
            point_start[b] = point_start[b + 1]
    limit_k = LIMIT_K if params.limit_k is None else params.limit_k
    limit_damp = LIMIT_DAMP if params.limit_damp is None else params.limit_damp
    h = float(params.h)
    mu_plane = [combine_mu(float(m), params.plane_friction, params.friction_combine)
                for m in friction]
    mu_box = [params.ant_box_mu if params.ant_box_mu is not None
              else combine_mu(float(m), params.box_friction, params.friction_combine)
              for m in friction]
    box_he = params.box_he if has_box else (0.0, 0.0, 0.0)
    box_inv_mass, box_inv_I = (params.box_inv if has_box and params.box_inv is not None
                               else (0.0, np.zeros((3, 3))))

    values = {
        "gravity": params.gravity, "h": h, "h2": h * h, "half_h": 0.5 * h,
        "kn": cp.stiffness, "kd": cp.damping, "max_depen_vel": cp.max_depen_vel,
        "hc_vel": cp.hc_vel, "hc_cap": cp.hc_cap, "acc_units": float(bool(cp.acc_units)),
        "legacy": float(legacy), "friction_vel": cp.friction_vel,
        "limit_k": limit_k, "limit_damp": limit_damp,
        "max_lin_vel": MAX_LIN_VEL, "max_ang_vel": MAX_ANG_VEL, "max_dof_vel": MAX_DOF_VEL,
        "has_box": float(has_box), "box_he": box_he, "box_inv_mass": box_inv_mass,
        "box_inv_inertia": np.asarray(box_inv_I, np.float64).reshape(9),
        "parent": sys.parent, "body_sensor": body_sensor, "point_start": point_start,
        "chain_mask": [sum(1 << i for i in ch) for ch in chains],
        "body_pos": f64(sys.body_pos).reshape(-1), "body_quat": f64(sys.body_quat).reshape(-1),
        "jnt_axis": f64(sys.jnt_axis).reshape(-1), "jnt_pos": f64(sys.jnt_pos).reshape(-1),
        "jnt_lo": jnt_range[:, 0], "jnt_hi": jnt_range[:, 1],
        "armature": armature, "damping": f64(sys.damping),
        "mass": mass, "inv_mass": 1.0 / mass, "comp_mass": comp_mass,
        "com": f64(sys.com).reshape(-1), "inertia": inertia.reshape(-1),
        "inertia_inv_aug": np.asarray(inv_aug, np.float64).reshape(-1),
        "point_local": f64(sys.point_local).reshape(-1), "point_radius": f64(sys.point_radius),
        "mu_plane": mu_plane, "mu_box": mu_box,
    }
    parts = []
    for name, n in table_layout(P):
        arr = np.asarray(values[name], np.float64).reshape(-1)
        if arr.size != n:
            raise AssertionError(f"table field {name}: {arr.size} values, layout says {n}")
        parts.append(arr)
    flat = np.concatenate(parts).astype(np.float32)
    fields, off = {}, 0
    for name, n in table_layout(P):
        fields[name] = flat[off:off + n].astype(np.float64).tolist()
        off += n
    return AntConsts(table=torch.from_numpy(flat), P=P, has_box=has_box, legacy=legacy, f=fields,
                     parent=tuple(sys.parent), point_body=tuple(sys.point_body),
                     point_sensor=tuple(sys.point_sensor), num_sensors=sys.num_sensors,
                     body_of_dof=tuple(body_of_dof),
                     chains=tuple(tuple(ch) for ch in chains))


# ---------------------------------------------------------------------------
# component-tuple algebra: v3 = (x,y,z), q4 = (x,y,z,w), m33 = 3x3 nested
# ---------------------------------------------------------------------------

def v3_add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def v3_sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def v3_scale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def v3_dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def v3_cross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def m33_mv(m, v):
    return (m[0][0] * v[0] + m[0][1] * v[1] + m[0][2] * v[2],
            m[1][0] * v[0] + m[1][1] * v[1] + m[1][2] * v[2],
            m[2][0] * v[0] + m[2][1] * v[1] + m[2][2] * v[2])


def m33_mtv(m, v):
    return (m[0][0] * v[0] + m[1][0] * v[1] + m[2][0] * v[2],
            m[0][1] * v[0] + m[1][1] * v[1] + m[2][1] * v[2],
            m[0][2] * v[0] + m[1][2] * v[1] + m[2][2] * v[2])


def m33_mm(a, b):
    return tuple(tuple(a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j]
                       for j in range(3)) for i in range(3))


def m33_mmt(a, b):
    """a b^T."""
    return tuple(tuple(a[i][0] * b[j][0] + a[i][1] * b[j][1] + a[i][2] * b[j][2]
                       for j in range(3)) for i in range(3))


def quat_mul(a, b):
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return (aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz)


def quat_rotate(q, v):
    qv = (q[0], q[1], q[2])
    t = v3_scale(v3_cross(qv, v), 2.0)
    return v3_add(v3_add(v, v3_scale(t, q[3])), v3_cross(qv, t))


def quat_to_mat(q):
    x, y, z, w = q
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return ((1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)),
            (2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)),
            (2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)))


def quat_axis_angle(axis, angle):
    half = 0.5 * angle
    s = torch.sin(half)
    return (axis[0] * s, axis[1] * s, axis[2] * s, torch.cos(half))


def quat_normalize(q):
    n = torch.sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3] + 1e-12)
    inv = 1.0 / n
    return (q[0] * inv, q[1] * inv, q[2] * inv, q[3] * inv)


def s6_add(a, b):
    return tuple(a[i] + b[i] for i in range(6))


def s6_scale(a, s):
    return tuple(a[i] * s for i in range(6))


def s6_dot(a, b):
    out = a[0] * b[0]
    for i in range(1, 6):
        out = out + a[i] * b[i]
    return out


def s6_motion_cross(v, m):
    w1, p1 = (v[0], v[1], v[2]), (v[3], v[4], v[5])
    w2, p2 = (m[0], m[1], m[2]), (m[3], m[4], m[5])
    return (*v3_cross(w1, w2), *v3_add(v3_cross(w1, p2), v3_cross(p1, w2)))


def s6_force_cross(v, f):
    w, p = (v[0], v[1], v[2]), (v[3], v[4], v[5])
    t, fo = (f[0], f[1], f[2]), (f[3], f[4], f[5])
    return (*v3_add(v3_cross(w, t), v3_cross(p, fo)), *v3_cross(w, fo))


def _rows3(flat, k):
    """The k-th 3x3 block of a flat float list, as nested tuples."""
    m = flat[9 * k:9 * k + 9]
    return ((m[0], m[1], m[2]), (m[3], m[4], m[5]), (m[6], m[7], m[8]))


def _vec(flat, k, n):
    return tuple(flat[n * k:n * k + n])


# ---------------------------------------------------------------------------
# the substep
# ---------------------------------------------------------------------------

def substep(c: AntConsts, qpos: Sequence, qvel: Sequence, tau_act: Sequence,
            box_qpos: Sequence | None = None, box_qvel: Sequence | None = None,
            dr: dict | None = None):
    """One physics substep in scalar form (plain version of the kernel).

    qpos: 15 [B] tensors, qvel: 14, tau_act: 8 (actuation only); box_*: the
    box state broadcast per articulation (ignored when the table has no box).
    dr: per-articulation parameters (domain randomization), lists of [B]
    tensors {mass [9], damping, armature, jnt_lo, jnt_hi [8 each]} in place
    of the table's; the quantities baked from them (inverse masses, the
    armature-augmented inverse inertias, the composite masses) are then
    computed per lane in the kernel's order, with true divisions.
    Returns (qpos' list, qvel' list, box wrench six-tuple or None, sensor
    wrenches: one (fx,fy,fz,tx,ty,tz) per foot sensor in the foot frame)."""
    f = c.f
    nb, nj = NB, NJ
    h, h2, half_h = f["h"][0], f["h2"][0], f["half_h"][0]
    kn, kd, mdv = f["kn"][0], f["kd"][0], f["max_depen_vel"][0]
    hc_vel, hc_cap, acc_units = f["hc_vel"][0], f["hc_cap"][0], bool(f["acc_units"][0])
    clamp = not c.legacy          # the reference's `clamp = beta is not None`
    fv = f["friction_vel"][0]
    limit_k, limit_damp = f["limit_k"][0], f["limit_damp"][0]
    gravity = tuple(f["gravity"])
    src = dr if dr else f
    mass, armature, damping = src["mass"], src["armature"], src["damping"]
    jnt_lo, jnt_hi = src["jnt_lo"], src["jnt_hi"]
    has_box = c.has_box

    base = (qpos[0], qpos[1], qpos[2])
    base_q = (qpos[3], qpos[4], qpos[5], qpos[6])

    # ---------------- FK ----------------
    pos, quat, axes_w = [base], [base_q], []
    for b in range(1, nb):
        j = b - 1
        p_p, q_p = pos[c.parent[b]], quat[c.parent[b]]
        p0 = v3_add(p_p, quat_rotate(q_p, _vec(f["body_pos"], b, 3)))
        q0 = quat_mul(q_p, _vec(f["body_quat"], b, 4))
        n_w = quat_rotate(q0, _vec(f["jnt_axis"], j, 3))
        q_c = quat_mul(quat_axis_angle(n_w, qpos[7 + j]), q0)
        jp = _vec(f["jnt_pos"], j, 3)
        anchor = v3_add(p0, quat_rotate(q0, jp))
        pos.append(v3_sub(anchor, quat_rotate(q_c, jp)))
        quat.append(q_c)
        axes_w.append((n_w, v3_sub(anchor, base)))
    R = [quat_to_mat(q) for q in quat]
    com_w = [v3_add(pos[b], m33_mv(R[b], _vec(f["com"], b, 3))) for b in range(nb)]

    zero = qpos[0] * 0.0
    one = zero + 1.0
    # the contact force's divisors as device tensors: torch on CUDA divides
    # by a Python float as a product with its reciprocal, one rounding away
    # from the kernel's (and the reference's) division
    fv_t, hc_t = zero + fv, zero + max(hc_vel, 1e-9)
    e = [(one, zero, zero), (zero, one, zero), (zero, zero, one)]
    phi = [(zero, zero, zero, *e[k]) for k in range(3)]
    phi += [(*e[k], zero, zero, zero) for k in range(3)]
    for j in range(nj):
        n, w = axes_w[j]
        phi.append((*n, *v3_cross(w, n)))

    v = [(qvel[3], qvel[4], qvel[5], qvel[0], qvel[1], qvel[2])]
    for b in range(1, nb):
        j = 6 + b - 1
        v.append(s6_add(v[c.parent[b]], s6_scale(phi[j], qvel[j])))

    # ---------------- contacts ----------------
    f_body = [(zero,) * 6 for _ in range(nb)]
    sensors = [(zero, zero, zero) for _ in range(NS)]
    sensor_tq = [(zero, zero, zero) for _ in range(NS)]
    box_wrench = (zero,) * 6 if has_box else None
    if has_box:
        bq = (box_qpos[3], box_qpos[4], box_qpos[5], box_qpos[6])
        bR = quat_to_mat(bq)
        bp = (box_qpos[0], box_qpos[1], box_qpos[2])
        bv = (box_qvel[0], box_qvel[1], box_qvel[2])
        bw = (box_qvel[3], box_qvel[4], box_qvel[5])
        box_he = f["box_he"]
        if clamp:
            bim = f["box_inv_mass"][0]
            bIinvw = m33_mmt(m33_mm(bR, _rows3(f["box_inv_inertia"], 0)), bR)

    # per-body world inverse inertia (armature-augmented) for the contact
    # effective mass; the legacy branch reads none.  Under DR the bodies
    # below the torso invert inertia + armature * 1 per lane (every entry a
    # tensor, so each product rounds in float32 as in the kernel)
    if clamp:
        I_inv_w = []
        for b in range(nb):
            I_inv_b = _rows3(f["inertia_inv_aug"], b)
            if dr and b > 0:
                I_b = [[zero + x for x in row] for row in _rows3(f["inertia"], b)]
                for k in range(3):
                    I_b[k][k] = I_b[k][k] + armature[b - 1]
                I_inv_b = _inv3x3_sym_t(I_b, one)
            I_inv_w.append(m33_mmt(m33_mm(R[b], I_inv_b), R[b]))

    for p_i in range(c.P):
        b = c.point_body[p_i]
        radius = f["point_radius"][p_i]
        p_w = v3_add(pos[b], m33_mv(R[b], _vec(f["point_local"], p_i, 3)))
        vb = v[b]
        v_w = v3_add((vb[3], vb[4], vb[5]),
                     v3_cross((vb[0], vb[1], vb[2]), v3_sub(p_w, base)))
        w_fn = None
        if clamp:
            r_pt = v3_sub(p_w, com_w[b])
            inv_m = one / mass[b] if dr else f["inv_mass"][b]

            def w_fn(d, _r=r_pt, _I=I_inv_w[b], _im=inv_m):
                rxd = v3_cross(_r, d)
                return _im + v3_dot(rxd, m33_mv(_I, rxd))

        depth = radius - p_w[2]
        f_pt = _contact_force(depth, (zero, zero, one), v_w, f["mu_plane"][p_i],
                              kn, kd, fv_t, w_fn, h, mdv, acc_units, hc_vel, hc_t, hc_cap)

        if has_box:
            rel = v3_sub(p_w, bp)
            local = m33_mtv(bR, rel)
            cl = tuple(torch.clamp(local[k], -box_he[k], box_he[k]) for k in range(3))
            delta = v3_sub(local, cl)
            dist_out = torch.sqrt(v3_dot(delta, delta) + 1e-12)
            inside = ((torch.abs(local[0]) < box_he[0])
                      & (torch.abs(local[1]) < box_he[1])
                      & (torch.abs(local[2]) < box_he[2]))
            fp = [box_he[k] - torch.abs(local[k]) for k in range(3)]
            min_pen = torch.minimum(torch.minimum(fp[0], fp[1]), fp[2])
            m0 = fp[0] <= min_pen + 1e-12
            m1 = (fp[1] <= min_pen + 1e-12) & ~m0
            m2 = ~m0 & ~m1
            sgn = [torch.sign(local[k]) for k in range(3)]
            oh = (m0.to(zero.dtype), m1.to(zero.dtype), m2.to(zero.dtype))
            n_loc_in = (sgn[0] * oh[0], sgn[1] * oh[1], sgn[2] * oh[2])
            n_loc_out = v3_scale(delta, 1.0 / dist_out)
            insf = inside.to(zero.dtype)
            n_loc = tuple(insf * n_loc_in[k] + (1 - insf) * n_loc_out[k] for k in range(3))
            depth_b = insf * (radius + min_pen) + (1 - insf) * (radius - dist_out)
            n_w = m33_mv(bR, n_loc)
            surf = tuple(insf * local[k] + (1 - insf) * cl[k] for k in range(3))
            cpnt = v3_add(bp, m33_mv(bR, surf))
            v_box_pt = v3_add(bv, v3_cross(bw, v3_sub(cpnt, bp)))
            v_rel = v3_sub(v_w, v_box_pt)
            r_box = v3_sub(cpnt, bp)
            w_fn_box = None
            if clamp:
                def w_fn_box(d, _wf=w_fn, _r=r_box):
                    rxd = v3_cross(_r, d)
                    return _wf(d) + bim + v3_dot(rxd, m33_mv(bIinvw, rxd))

            f_bx = _contact_force(depth_b, n_w, v_rel, f["mu_box"][p_i],
                                  kn, kd, fv_t, w_fn_box, h, mdv, acc_units, hc_vel, hc_t,
                                  hc_cap)
            f_pt = v3_add(f_pt, f_bx)
            tq = v3_cross(r_box, f_bx)
            box_wrench = s6_add(box_wrench,
                                (-tq[0], -tq[1], -tq[2], -f_bx[0], -f_bx[1], -f_bx[2]))

        tq_pt = v3_cross(v3_sub(p_w, base), f_pt)
        f_body[b] = s6_add(f_body[b], (*tq_pt, *f_pt))
        s = c.point_sensor[p_i]
        if s >= 0:
            sensors[s] = v3_add(sensors[s], f_pt)
            sensor_tq[s] = v3_add(sensor_tq[s], v3_cross(v3_sub(p_w, pos[b]), f_pt))

    foot_body = {s: pb for pb, s in zip(c.point_body, c.point_sensor) if s >= 0}
    sensor_out = [(*m33_mtv(R[foot_body[s]], sensors[s]),
                   *m33_mtv(R[foot_body[s]], sensor_tq[s])) for s in range(NS)]

    # ---------------- gravity + bias ----------------
    I_sp = []
    for b in range(nb):
        Iw = m33_mmt(m33_mm(R[b], _rows3(f["inertia"], b)), R[b])
        cr = v3_sub(com_w[b], base)
        m = mass[b]
        cx = ((zero, -cr[2], cr[1]), (cr[2], zero, -cr[0]), (-cr[1], cr[0], zero))
        cxcx = m33_mm(cx, cx)
        A = tuple(tuple(Iw[i][j] - m * cxcx[i][j] for j in range(3)) for i in range(3))
        B = tuple(tuple(m * cx[i][j] for j in range(3)) for i in range(3))
        I_sp.append((A, B, m))

    def I_mv(Iblk, s):
        A, B, m = Iblk
        w, p = (s[0], s[1], s[2]), (s[3], s[4], s[5])
        top = v3_add(m33_mv(A, w), m33_mv(B, p))
        Bw = m33_mv(B, w)
        return (*top, *v3_add((-Bw[0], -Bw[1], -Bw[2]), v3_scale(p, m)))

    # CRBA composite inertias (composite masses come summed from the table,
    # or under DR summed per lane, children into parents from the last body)
    Ic = list(I_sp)
    comp_mass = list(mass) if dr else f["comp_mass"]
    for b in range(nb - 1, 0, -1):
        A1, B1, _ = Ic[c.parent[b]]
        A2, B2, _ = Ic[b]
        Ic[c.parent[b]] = (tuple(tuple(A1[i][j] + A2[i][j] for j in range(3)) for i in range(3)),
                           tuple(tuple(B1[i][j] + B2[i][j] for j in range(3)) for i in range(3)),
                           None)
        if dr:
            comp_mass[c.parent[b]] = comp_mass[c.parent[b]] + comp_mass[b]
    Ic = [(A, B, comp_mass[b]) for b, (A, B, _) in enumerate(Ic)]
    Mrows = [[None] * NV for _ in range(NV)]
    for j in range(NV):
        fI = I_mv(Ic[c.body_of_dof[j]], phi[j])
        for i in c.chains[j]:
            mij = s6_dot(phi[i], fI)
            Mrows[i][j] = mij
            Mrows[j][i] = mij
    for j in range(6, NV):
        Mrows[j][j] = Mrows[j][j] + armature[j - 6]

    avp = [(zero, zero, zero, *v3_cross((qvel[0], qvel[1], qvel[2]),
                                        (qvel[3], qvel[4], qvel[5])))]
    for b in range(1, nb):
        j = b - 1
        vJ = s6_scale(phi[6 + j], qvel[6 + j])
        avp.append(s6_add(avp[c.parent[b]], s6_motion_cross(v[c.parent[b]], vJ)))

    fb = []
    for b in range(nb):
        cr = v3_sub(com_w[b], base)
        fg = v3_scale(gravity, mass[b])
        f_grav = (*v3_cross(cr, fg), *fg)
        bias = s6_add(I_mv(I_sp[b], avp[b]), s6_force_cross(v[b], I_mv(I_sp[b], v[b])))
        fb.append(tuple(bias[i] - f_grav[i] - f_body[b][i] for i in range(6)))
    fs = list(fb)
    for b in range(nb - 1, 0, -1):
        fs[c.parent[b]] = s6_add(fs[c.parent[b]], fs[b])
    C = [s6_dot(phi[j], fs[c.body_of_dof[j]]) for j in range(NV)]

    # hinge torques: actuation + limit spring; joint + limit damping and the
    # limit spring integrate implicitly: (M + h D + h^2 K) qacc = tau - (D + h K) qd - C
    rhs = [-C[j] for j in range(6)]
    for j in range(nj):
        q = qpos[7 + j]
        qd = qvel[6 + j]
        below = torch.clamp(jnt_lo[j] - q, min=0.0)
        above = torch.clamp(q - jnt_hi[j], min=0.0)
        viol = (below > 0) | (above > 0)
        t_lim = limit_k * (below - above)
        D_j = damping[j] + torch.where(viol, limit_damp, 0.0)
        K_j = torch.where(viol, limit_k, 0.0)
        Mrows[6 + j][6 + j] = Mrows[6 + j][6 + j] + h * D_j + h2 * K_j
        rhs.append(tau_act[j] + t_lim - (D_j + h * K_j) * qd - C[6 + j])

    # ---------------- Cholesky solve (structural zeros skipped) ----------------
    qacc = cholesky_solve_rows(Mrows, rhs, 0, NV)

    # ---------------- integrate ----------------
    vmax = ([f["max_lin_vel"][0]] * 3 + [f["max_ang_vel"][0]] * 3
            + [f["max_dof_vel"][0]] * nj)
    nqv = [torch.clamp(qvel[j] + h * qacc[j], -vmax[j], vmax[j]) for j in range(NV)]
    npos = [qpos[k] + h * nqv[k] for k in range(3)]
    dq = (nqv[3] * half_h, nqv[4] * half_h, nqv[5] * half_h, zero)
    q_new = quat_mul(dq, base_q)
    q_new = quat_normalize(tuple(base_q[k] + q_new[k] for k in range(4)))
    nqp = npos + list(q_new) + [qpos[7 + j] + h * nqv[6 + j] for j in range(nj)]
    return nqp, nqv, box_wrench, sensor_out


def _contact_force(depth, normal, v_rel, friction, kn, kd, fv, w_fn, h, mdv,
                   acc_units, hc_vel, hc_div, hc_cap):
    """Implicit spring-damper normal force along the point's effective mass
    plus exact-stiction Coulomb friction (w_fn(d) = inverse mass along d);
    with w_fn None, the legacy explicit spring-damper with friction ramped
    over fv.  fv and hc_div (= max(hc_vel, 1e-9)) are tensors."""
    active = (depth > 0.0).to(depth.dtype)
    vn = v3_dot(v_rel, normal)
    vt = v3_sub(v_rel, v3_scale(normal, vn))
    vt_norm = torch.sqrt(v3_dot(vt, vt) + 1e-12)
    if w_fn is None:
        fn = torch.clamp(kn * depth - kd * vn, min=0.0) * active
        ft_mag = torch.minimum(friction * fn, friction * fn * vt_norm / fv)
        return v3_sub(v3_scale(normal, fn), v3_scale(vt, ft_mag / vt_norm))
    w_n = w_fn(normal)
    t_dir = v3_scale(vt, 1.0 / vt_norm)
    w_t = w_fn(t_dir)
    if hc_vel != 0.0:
        fac = torch.clamp(1.0 - vn / hc_div, min=0.0)
        if hc_cap > 0.0:
            fac = torch.clamp(fac, max=hc_cap)
        if hc_vel > 0.0:
            kn = kn * fac
    kh = kn * h + kd
    if acc_units:
        fn = (kn * depth - kh * vn) / (w_n * (1.0 + h * kh))
    else:
        fn = (kn * depth - kh * vn) / (1.0 + w_n * h * kh)
    fn = torch.clamp(fn, min=0.0) * active
    fn = torch.minimum(fn, torch.clamp(mdv - vn, min=0.0) / (w_n * h))
    ft_mag = torch.minimum(friction * fn, vt_norm / (w_t * h))
    return v3_sub(v3_scale(normal, fn), v3_scale(vt, ft_mag / vt_norm))
