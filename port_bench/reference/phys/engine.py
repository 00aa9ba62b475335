"""Articulated rigid-body dynamics in batched PyTorch: the array engine,
twin of massive_marl_tpu/phys/engine.py.

It covers the whole of the reference engine: forward kinematics, the CRBA
mass matrix with the unrolled Cholesky solve (`forward_dynamics`, with the
implicit joint damping and stiffness terms and the welded base), plane and
oriented-box penalty contacts in both branches (the implicit effective-mass
normal force when the point inertia and the substep are given, the legacy
explicit spring-damper with ramped friction when they are not), the
joint-limit penalties (explicit torque and implicit spring), the foot-sensor
wrenches and the semi-implicit integrator.  The array-path scene step
(envs/ant_scene.scene_step) and the push-box's free-body substep run on it;
the fused path's ant substep is the kernel in ops/.

Every function batches over leading dimensions: qpos [..., nq], qvel
[..., nv], contact points [..., P, 3].  The System's mass, armature, damping
and jnt_range may carry the same leading dimensions (one set per
articulation, from domain randomization, phys/dr.DrSample.apply); with the
nominal unbatched System the arithmetic is the same.  Per-body and per-dof quantities are
Python lists of tensors over the static tree, as in the reference.  Spatial
vectors ([angular; linear]) are in the world frame about the articulation's
base position.  `points_world` returns positions and velocities only (the
reference also returns the static point->body map, which is sys.point_body).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from .maths import (cross, mm, mv, quat_from_axis_angle, quat_integrate,
                    quat_mul, quat_rotate, quat_to_matrix)
from .spatial import force_cross, motion_cross, spatial_inertia
from .system import System

# joint-limit penalty constants (both terms integrate implicitly; see the
# reference engine for their derivation)
LIMIT_K = 16000.0
LIMIT_DAMP = 20.0


class FK(NamedTuple):
    base: torch.Tensor                # [...,3] base body origin, world
    pos: Sequence[torch.Tensor]       # per body [...,3]
    quat: Sequence[torch.Tensor]      # per body [...,4]
    R: Sequence[torch.Tensor]         # per body [...,3,3]
    com_w: Sequence[torch.Tensor]     # per body [...,3]
    phi: Sequence[torch.Tensor]       # per dof [...,6] motion axis
    v: Sequence[torch.Tensor]         # per body [...,6] spatial velocity


def dof_chains(sys: System):
    """For each dof, the ancestor dofs (self included); and each dof's body.
    Root free-joint dofs 0..5 live on body 0."""
    body_of_dof = [0] * 6 + list(range(1, sys.nb))
    chains = []
    for j in range(sys.nv):
        if j < 6:
            chains.append(list(range(j + 1)))
            continue
        b, path = body_of_dof[j], []
        while b != 0:
            path.append(6 + b - 1)
            b = sys.parent[b]
        chains.append(list(range(6)) + list(reversed(path)))
    return body_of_dof, chains


def ancestor_mask(sys: System) -> np.ndarray:
    """A[j, b] = 1 if dof j moves body b."""
    A = np.zeros((sys.nv, sys.nb), np.float32)
    A[:6, :] = 1.0
    for b in range(1, sys.nb):
        chain = b
        while chain != 0:
            A[6 + chain - 1, b] = 1.0
            chain = sys.parent[chain]
    return A


def fwd_kinematics(sys: System, qpos: torch.Tensor, qvel: torch.Tensor) -> FK:
    base_pos = qpos[..., 0:3]
    hinge = qpos[..., 7:]
    pos, quat, axes_w, anchors_w = [base_pos], [qpos[..., 3:7]], [], []
    for b in range(1, sys.nb):
        j = b - 1
        p_p, q_p = pos[sys.parent[b]], quat[sys.parent[b]]
        p0 = p_p + quat_rotate(q_p, sys.body_pos[b])
        q0 = quat_mul(q_p, sys.body_quat[b].expand_as(q_p))
        n_w = quat_rotate(q0, sys.jnt_axis[j])
        q_c = quat_mul(quat_from_axis_angle(n_w, hinge[..., j]), q0)
        anchor0 = p0 + quat_rotate(q0, sys.jnt_pos[j])
        pos.append(anchor0 - quat_rotate(q_c, sys.jnt_pos[j]))
        quat.append(q_c)
        axes_w.append(n_w)
        anchors_w.append(anchor0)
    R = [quat_to_matrix(q) for q in quat]
    com_w = [pos[b] + mv(R[b], sys.com[b]) for b in range(sys.nb)]

    zero3 = torch.zeros_like(base_pos)
    e = [torch.zeros_like(base_pos) for _ in range(3)]
    for k in range(3):
        e[k][..., k] = 1.0
    phi = [torch.cat([zero3, e[k]], dim=-1) for k in range(3)]
    phi += [torch.cat([e[k], zero3], dim=-1) for k in range(3)]
    for j in range(sys.nj):
        n = axes_w[j]
        phi.append(torch.cat([n, cross(anchors_w[j] - base_pos, n)], dim=-1))

    v = [torch.cat([qvel[..., 3:6], qvel[..., 0:3]], dim=-1)]
    for b in range(1, sys.nb):
        j = 6 + b - 1
        v.append(v[sys.parent[b]] + phi[j] * qvel[..., j:j + 1])
    return FK(base=base_pos, pos=pos, quat=quat, R=R, com_w=com_w, phi=phi, v=v)


def point_force_spatial(point, force, base):
    """Linear force at a world point -> spatial force about `base`."""
    torque = cross(point - base, force)
    return torch.cat([torque, force.expand_as(torque)], dim=-1)


def forward_dynamics(sys: System, fk: FK, qvel: torch.Tensor, tau_hinge: torch.Tensor,
                     f_ext: Sequence[torch.Tensor], gravity: torch.Tensor,
                     fixed_base: bool = False, imp_damping: torch.Tensor | None = None,
                     h: float | None = None,
                     imp_stiffness: torch.Tensor | None = None) -> torch.Tensor:
    """qacc [..., nv] from hinge torques and per-body external spatial forces
    (CRBA mass matrix, velocity-product bias, unrolled Cholesky solve).

    fixed_base: solve the hinge block only (base welded to the world; the
    base accelerations are 0).  imp_damping [..., nj]: viscous coefficients
    integrated implicitly, (M + h D) qacc = tau - D qd - C; the caller must
    not also subtract D qd from tau_hinge.  imp_stiffness [..., nj]: spring
    coefficients whose position term the caller already put in tau_hinge,
    evaluated at the end-of-step position: (M + h D + h^2 K) qacc =
    tau - (D + h K) qd - C."""
    body_of_dof, chains = dof_chains(sys)
    I_sp = []
    for b in range(sys.nb):
        I_w = mm(mm(fk.R[b], sys.inertia[b]), fk.R[b].transpose(-1, -2))
        I_sp.append(spatial_inertia(sys.mass[..., b], fk.com_w[b] - fk.base, I_w))

    Ic = list(I_sp)
    for b in range(sys.nb - 1, 0, -1):
        Ic[sys.parent[b]] = Ic[sys.parent[b]] + Ic[b]
    Mrows = [[None] * sys.nv for _ in range(sys.nv)]
    for j in range(sys.nv):
        fI = mv(Ic[body_of_dof[j]], fk.phi[j])
        for i in chains[j]:
            mij = torch.sum(fk.phi[i] * fI, dim=-1)
            Mrows[i][j] = mij
            Mrows[j][i] = mij
    for j in range(6, sys.nv):
        Mrows[j][j] = Mrows[j][j] + sys.armature[..., j - 6]
    if imp_damping is not None:
        for j in range(sys.nj):
            Mrows[6 + j][6 + j] = Mrows[6 + j][6 + j] + h * imp_damping[..., j]
    if imp_stiffness is not None:
        for j in range(sys.nj):
            Mrows[6 + j][6 + j] = Mrows[6 + j][6 + j] + h * h * imp_stiffness[..., j]

    v_lin, omega = qvel[..., 0:3], qvel[..., 3:6]
    avp = [torch.cat([torch.zeros_like(v_lin), cross(v_lin, omega)], dim=-1)]
    for b in range(1, sys.nb):
        j = 6 + b - 1
        vJ = fk.phi[j] * qvel[..., j:j + 1]
        avp.append(avp[sys.parent[b]] + motion_cross(fk.v[sys.parent[b]], vJ))

    fs = []
    for b in range(sys.nb):
        f_grav = point_force_spatial(fk.com_w[b], sys.mass[..., b, None] * gravity, fk.base)
        fs.append(mv(I_sp[b], avp[b]) + force_cross(fk.v[b], mv(I_sp[b], fk.v[b]))
                  - f_grav - f_ext[b])
    for b in range(sys.nb - 1, 0, -1):
        fs[sys.parent[b]] = fs[sys.parent[b]] + fs[b]
    C = [torch.sum(fk.phi[j] * fs[body_of_dof[j]], dim=-1) for j in range(sys.nv)]
    rhs = [(-C[j] if j < 6 else tau_hinge[..., j - 6] - C[j]) for j in range(sys.nv)]
    if imp_damping is not None:
        for j in range(sys.nj):
            rhs[6 + j] = rhs[6 + j] - imp_damping[..., j] * qvel[..., 6 + j]
    if imp_stiffness is not None:
        for j in range(sys.nj):
            rhs[6 + j] = rhs[6 + j] - h * imp_stiffness[..., j] * qvel[..., 6 + j]
    lo = 6 if fixed_base else 0
    x = cholesky_solve_rows(Mrows, rhs, lo, sys.nv)
    if fixed_base:
        return torch.stack([torch.zeros_like(rhs[0])] * 6 + x, dim=-1)
    return torch.stack(x, dim=-1)


def cholesky_solve_rows(Mrows, rhs, lo: int, hi: int):
    """Solve M[lo:hi, lo:hi] x = rhs[lo:hi] for an SPD matrix given as a 2D
    list of batched scalars; None entries are structural zeros."""
    idx = list(range(lo, hi))
    n = len(idx)
    L = [[None] * n for _ in range(n)]
    inv_diag = [None] * n
    for a in range(n):
        for bq in range(a + 1):
            s = Mrows[idx[a]][idx[bq]]
            for k in range(bq):
                if L[a][k] is None or L[bq][k] is None:
                    continue
                t = L[a][k] * L[bq][k]
                s = -t if s is None else s - t
            if a == bq:
                s = s if s is not None else torch.zeros_like(rhs[lo])
                L[a][a] = torch.sqrt(torch.clamp(s, min=1e-12))
                inv_diag[a] = 1.0 / L[a][a]
            else:
                L[a][bq] = None if s is None else s * inv_diag[bq]
    y = [None] * n
    for a in range(n):
        s = rhs[idx[a]]
        for k in range(a):
            if L[a][k] is not None:
                s = s - L[a][k] * y[k]
        y[a] = s * inv_diag[a]
    x = [None] * n
    for a in reversed(range(n)):
        s = y[a]
        for k in range(a + 1, n):
            if L[k][a] is not None:
                s = s - L[k][a] * x[k]
        x[a] = s * inv_diag[a]
    return x


def cholesky_solve_small(M: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Dense-array form of the unrolled solve: M [..., n, n], rhs [..., n]."""
    n = M.shape[-1]
    Mrows = [[M[..., i, j] for j in range(n)] for i in range(n)]
    return torch.stack(cholesky_solve_rows(Mrows, [rhs[..., i] for i in range(n)], 0, n), dim=-1)


def joint_limit_torque(sys: System, qpos: torch.Tensor, qvel: torch.Tensor,
                       k: float = 80.0, damp: float = 2.0) -> torch.Tensor:
    """Explicit penalty torque [..., nj] pushing the hinges back inside
    [lower, upper] (the legacy form, kept for the debug tool; the scene step
    uses `joint_limit_spring` with implicit damping)."""
    if sys.nj == 0:
        return qpos.new_zeros(qpos.shape[:-1] + (0,))
    q, qd = qpos[..., 7:], qvel[..., 6:]
    below = torch.clamp(sys.jnt_range[..., 0] - q, min=0.0)
    above = torch.clamp(q - sys.jnt_range[..., 1], min=0.0)
    viol = (below > 0) | (above > 0)
    return k * (below - above) - torch.where(viol, damp * qd, torch.zeros_like(qd))


def joint_limit_spring(sys_or_range, qpos: torch.Tensor, k: float = LIMIT_K,
                       damp: float = LIMIT_DAMP):
    """(spring torque, active damping coefficient, active stiffness), each
    [..., nj], for the hinge limits.  The caller adds the spring to tau and
    passes the coefficients to forward_dynamics' imp_damping (with the
    joint's own damping) and imp_stiffness."""
    jnt_range = getattr(sys_or_range, "jnt_range", sys_or_range)
    q = qpos[..., 7:]
    below = torch.clamp(jnt_range[..., 0] - q, min=0.0)
    above = torch.clamp(q - jnt_range[..., 1], min=0.0)
    viol = (below > 0) | (above > 0)
    zero = torch.zeros_like(q)
    return (k * (below - above), torch.where(viol, zero + damp, zero),
            torch.where(viol, zero + k, zero))


def integrate(sys: System, qpos: torch.Tensor, qvel: torch.Tensor, qacc: torch.Tensor,
              dt, max_ang_vel: float = 64.0, max_lin_vel: float = 200.0,
              max_dof_vel: float = 64.0):
    """Semi-implicit Euler with the PhysX-style velocity clamps."""
    qvel = qvel + dt * qacc
    lin = torch.clamp(qvel[..., 0:3], -max_lin_vel, max_lin_vel)
    omega = torch.clamp(qvel[..., 3:6], -max_ang_vel, max_ang_vel)
    hinge_rate = torch.clamp(qvel[..., 6:], -max_dof_vel, max_dof_vel)
    qvel = torch.cat([lin, omega, hinge_rate], dim=-1)
    pos = qpos[..., 0:3] + dt * lin
    quat = quat_integrate(qpos[..., 3:7], omega, dt)
    hinge = qpos[..., 7:] + dt * hinge_rate
    return torch.cat([pos, quat, hinge], dim=-1), qvel


# ---------------------------------------------------------------------------
# contacts
# ---------------------------------------------------------------------------

class ContactParams(NamedTuple):
    """Contact constants; see the reference engine's ContactParams for the
    implicit spring-damper model they parameterise.  stiffness/damping are
    mass-scaled (acc units) when acc_units is True."""
    stiffness: float = 2.0e5
    damping: float = 894.0
    friction_vel: float = 0.3
    beta: float = 0.2
    max_depen_vel: float = 4.0
    acc_units: bool = True
    hc_vel: float = 0.5
    hc_cap: float = 0.0


class PointInertia(NamedTuple):
    """Per-contact-point effective-mass info of the point's own body."""
    inv_mass: torch.Tensor       # [..., P]
    inv_inertia_w: torch.Tensor  # [..., P, 3, 3]
    r: torch.Tensor              # [..., P, 3] lever arm from the body com


def _inv3x3_sym(I: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a symmetric positive-definite 3x3."""
    a, b, c = I[..., 0, 0], I[..., 0, 1], I[..., 0, 2]
    d, e = I[..., 1, 1], I[..., 1, 2]
    f = I[..., 2, 2]
    A = d * f - e * e
    B = c * e - b * f
    C = b * e - c * d
    det = a * A + b * B + c * C
    D = a * f - c * c
    E = b * c - a * e
    F = a * d - b * b
    rows = torch.stack([A, B, C, B, D, E, C, E, F], dim=-1)
    return (rows / det[..., None]).reshape(I.shape)


def _point_ranges(sys: System):
    """Static contiguous (body, start, stop) runs of sys.point_body."""
    runs, pb, i = [], sys.point_body, 0
    while i < len(pb):
        j = i
        while j < len(pb) and pb[j] == pb[i]:
            j += 1
        runs.append((pb[i], i, j))
        i = j
    return tuple(runs)


def points_world(sys: System, fk: FK):
    """World positions and velocities [..., P, 3] of the contact points."""
    ps, vs = [], []
    for b, s, e in _point_ranges(sys):
        pl = sys.point_local[s:e]
        p_w = fk.pos[b][..., None, :] + torch.sum(fk.R[b][..., None, :, :] * pl[:, None, :], dim=-1)
        v_sp = fk.v[b][..., None, :]
        v_w = v_sp[..., 3:6] + cross(v_sp[..., 0:3], p_w - fk.base[..., None, :])
        ps.append(p_w)
        vs.append(v_w)
    return torch.cat(ps, dim=-2), torch.cat(vs, dim=-2)


def point_inertia(sys: System, fk: FK, p_w: torch.Tensor) -> PointInertia:
    """Effective-mass info per contact point: the point's own body, with the
    body's joint armature added to its rotational inertia."""
    inv_m, inv_I, r = [], [], []
    eye3 = torch.eye(3, dtype=p_w.dtype, device=p_w.device)
    for b, s, e in _point_ranges(sys):
        k = e - s
        I_b = sys.inertia[b]
        if b > 0 and sys.nj > 0:
            I_b = I_b + sys.armature[..., b - 1, None, None] * eye3
        I_inv_w = mm(mm(fk.R[b], _inv3x3_sym(I_b)), fk.R[b].transpose(-1, -2))
        lead = p_w.shape[:-2]
        inv_m.append((1.0 / sys.mass[..., b, None]).expand(lead + (k,)))
        inv_I.append(I_inv_w[..., None, :, :].expand(lead + (k, 3, 3)))
        r.append(p_w[..., s:e, :] - fk.com_w[b][..., None, :])
    return PointInertia(inv_mass=torch.cat(inv_m, dim=-1),
                        inv_inertia_w=torch.cat(inv_I, dim=-3),
                        r=torch.cat(r, dim=-2))


def inv_mass_along(pi: PointInertia, d: torch.Tensor) -> torch.Tensor:
    """w = 1/m + (r x d)^T I^-1 (r x d) per point; d: [..., P, 3] unit."""
    rxd = cross(pi.r, d)
    return pi.inv_mass + torch.sum(rxd * torch.sum(pi.inv_inertia_w * rxd[..., None, :], dim=-1), dim=-1)


def _contact_force(depth, normal, v_rel, friction, cp: ContactParams,
                   pi: PointInertia | None = None, h: float | None = None, w_extra_fn=None):
    """Force on the point's body for one contact candidate (0 when apart).

    With (pi, h): implicit spring-damper normal force along the point's
    effective mass and exact-stiction Coulomb friction (see the reference's
    ContactParams); w_extra_fn(d) adds the other body's inverse mass along d
    (ant foot against the push-box).  Without them: the legacy explicit
    spring-damper, fn = max(kn depth - kd vn, 0), with friction ramped over
    cp.friction_vel."""
    active = depth > 0.0
    vn = torch.sum(v_rel * normal, dim=-1)
    vt = v_rel - vn[..., None] * normal
    vt_norm = torch.sqrt(torch.sum(vt * vt, dim=-1) + 1e-12)
    if pi is not None and h is not None:
        w_n = inv_mass_along(pi, normal)
        t_dir = vt / vt_norm[..., None]
        w_t = inv_mass_along(pi, t_dir)
        if w_extra_fn is not None:
            w_n = w_n + w_extra_fn(normal)
            w_t = w_t + w_extra_fn(t_dir)
        kn = cp.stiffness
        if cp.hc_vel != 0.0:
            fac = torch.clamp(1.0 - vn / max(cp.hc_vel, 1e-9), min=0.0)
            if cp.hc_cap > 0.0:
                fac = torch.clamp(fac, max=cp.hc_cap)
            if cp.hc_vel > 0.0:
                kn = kn * fac
        kh = kn * h + cp.damping
        if cp.acc_units:
            fn = (kn * depth - kh * vn) / (w_n * (1.0 + h * kh))
        else:
            fn = (kn * depth - kh * vn) / (1.0 + w_n * h * kh)
        fn = torch.clamp(fn, min=0.0) * active
        fn = torch.minimum(fn, torch.clamp(cp.max_depen_vel - vn, min=0.0) / (w_n * h))
        ft_mag = torch.minimum(friction * fn, vt_norm / (w_t * h))
    else:
        fn = cp.stiffness * depth - cp.damping * vn
        fn = torch.clamp(fn, min=0.0) * active
        ft_mag = torch.minimum(friction * fn, friction * fn * vt_norm / cp.friction_vel)
    ft = -ft_mag[..., None] * vt / vt_norm[..., None]
    return fn[..., None] * normal + ft


def combine_mu(mu_a, mu_b, mode: str = "multiply"):
    """Pair friction from two materials (PhysX combine modes; 'max' is
    MuJoCo's rule).  Works on Python floats and tensors."""
    if mode == "multiply":
        return mu_a * mu_b
    if mode == "average":
        return 0.5 * (mu_a + mu_b)
    if mode in ("max", "min"):
        if isinstance(mu_a, torch.Tensor) or isinstance(mu_b, torch.Tensor):
            a, b = torch.as_tensor(mu_a), torch.as_tensor(mu_b)
            return torch.maximum(a, b) if mode == "max" else torch.minimum(a, b)
        return max(mu_a, mu_b) if mode == "max" else min(mu_a, mu_b)
    raise ValueError(f"unknown friction_combine mode: {mode!r}")


def contact_plane(p_w, v_w, radius, friction, cp: ContactParams,
                  pi: PointInertia | None = None, h: float | None = None):
    """Points vs the ground plane z=0: [..., P, 3] world forces."""
    depth = radius - p_w[..., 2]
    normal = torch.zeros_like(p_w)
    normal[..., 2] = 1.0
    return _contact_force(depth, normal, v_w, friction, cp, pi=pi, h=h)


def contact_box(p_w, v_w, radius, friction, box_pos, box_quat, box_vel, half_extents,
                cp: ContactParams, pi: PointInertia | None = None, h: float | None = None,
                box_inv=None):
    """Sphere points [..., P, 3] against an oriented box whose pose and
    velocity (box_pos [..., 3], box_quat [..., 4], box_vel [..., 6] =
    [v_origin, omega], world) have the points' leading shape without P.

    Inside the box the normal is the face of least penetration, ties broken
    x before y before z; outside it points from the nearest surface point.
    box_inv = (1/m, body-frame inverse inertia [3, 3]) adds the box's inverse
    mass along each direction (the implicit branch only).  Returns (force on
    the points' bodies [..., P, 3], wrench on the box about its origin
    [..., 6], summed over the points)."""
    he = torch.as_tensor(half_extents, dtype=p_w.dtype, device=p_w.device)
    R = quat_to_matrix(box_quat)[..., None, :, :]
    bp = box_pos[..., None, :]
    local = torch.sum(R * (p_w - bp)[..., :, None], dim=-2)   # R^T x
    clamped = torch.maximum(torch.minimum(local, he), -he)
    delta = local - clamped
    dist_out = torch.sqrt(torch.sum(delta * delta, dim=-1) + 1e-12)
    inside = torch.all(torch.abs(local) < he, dim=-1)
    face_pen = he - torch.abs(local)
    min_pen = torch.min(face_pen, dim=-1).values
    is_min = face_pen <= min_pen[..., None] + 1e-12
    m0 = is_min[..., 0]
    m1 = is_min[..., 1] & ~m0
    m2 = is_min[..., 2] & ~m0 & ~m1
    onehot = torch.stack([m0, m1, m2], dim=-1).to(local.dtype)
    face_n_local = torch.sign(local) * onehot
    n_local = torch.where(inside[..., None], face_n_local, delta / dist_out[..., None])
    depth = torch.where(inside, radius + min_pen, radius - dist_out)
    normal = torch.sum(R * n_local[..., None, :], dim=-1)      # box -> world

    surf_local = torch.where(inside[..., None], local, clamped)
    cpnt = bp + torch.sum(R * surf_local[..., None, :], dim=-1)
    r_box = cpnt - bp
    v_box_pt = box_vel[..., None, 0:3] + cross(box_vel[..., None, 3:6], r_box)
    w_extra_fn = None
    if box_inv is not None:
        box_inv_m, box_I_inv_body = box_inv
        box_I_inv_w = mm(mm(R, box_I_inv_body), R.transpose(-1, -2))

        def w_extra_fn(d):
            rxd = cross(r_box, d)
            return box_inv_m + torch.sum(rxd * torch.sum(box_I_inv_w * rxd[..., None, :], dim=-1),
                                         dim=-1)

    f = _contact_force(depth, normal, v_w - v_box_pt, friction, cp, pi=pi, h=h,
                       w_extra_fn=w_extra_fn)
    return f, torch.sum(-point_force_spatial(cpnt, f, bp), dim=-2)


def accumulate_body_forces(sys: System, p_w, f_w, base):
    """Per-body spatial forces about `base` (list of [..., 6])."""
    f_sp = point_force_spatial(p_w, f_w, base[..., None, :])
    per_body = [torch.zeros_like(f_sp[..., 0, :]) for _ in range(sys.nb)]
    for b, s, e in _point_ranges(sys):
        per_body[b] = per_body[b] + torch.sum(f_sp[..., s:e, :], dim=-2)
    return per_body


def sensor_forces(sys: System, f_w: torch.Tensor, fk: FK,
                  p_w: torch.Tensor | None = None) -> torch.Tensor:
    """Per-foot contact wrench [..., num_sensors, 6] in the foot body frame:
    the force sum and, when the points' world positions p_w are given, the
    contact moment sum((p - foot origin) x f); without them the torque
    channels are 0."""
    lead = f_w.shape[:-2]
    if sys.num_sensors == 0:
        return f_w.new_zeros(lead + (0, 6))
    ns = sys.num_sensors
    zero = f_w.new_zeros(lead + (3,))
    f_world, t_world, foot_body = [zero] * ns, [zero] * ns, [0] * ns
    for p, (pb, s) in enumerate(zip(sys.point_body, sys.point_sensor)):
        if s >= 0:
            f_world[s] = f_world[s] + f_w[..., p, :]
            if p_w is not None:
                t_world[s] = t_world[s] + cross(p_w[..., p, :] - fk.pos[pb], f_w[..., p, :])
            foot_body[s] = pb
    out = []
    for s in range(ns):
        R = fk.R[foot_body[s]]
        out.append(torch.cat([torch.sum(R * f_world[s][..., :, None], dim=-2),
                              torch.sum(R * t_world[s][..., :, None], dim=-2)], dim=-1))
    return torch.stack(out, dim=-2)
