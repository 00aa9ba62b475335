"""Bisect the substep kernels against the array engine at one substep
(counterpart of scripts/debug_fused_tpu.py):

    python -m massive_marl_tpu_torch.cli.debug_fused [--scenario chaotic|standing|airborne]
        [--mode scalar] [--B 1024] [--device cpu]

Four cases, contact clamp off/on x box off/on, each one substep of B random
articulation states through the array engine (`engine_substep`, a
line-for-line twin of the script's: the explicit joint-limit torque, the
joint damping subtracted explicitly, a frictionless box) and through a
kernel: clamp off through B6 (the legacy `beta=None` branch without sensor
outputs), clamp on through B1 with the box's inverse inertia, one box state
per articulation in both.  The kernels take the script's settings (plane
friction under 'multiply', the implicit joint-limit spring), so the two
sides differ by design: the printed max|dqpos| and max|dqvel| are what the
tool shows.  `--mode scalar` (the script's MODE=xla_scalar) holds B1's plain
version against the engine instead, clamp on, no box.

SCENARIO and MODE in the environment give the defaults of --scenario and
--mode, as the script reads them.  The states come from a seeded
torch.Generator; JAX's PRNG cannot be replayed here, so the numbers are not
those of a run of the script.  Runs on CUDA unless --device cpu is given.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from massive_marl_tpu_torch import resolve_device
from massive_marl_tpu_torch.ops import fused_substep as fs
from massive_marl_tpu_torch.ops import scalar_phys as sp
from massive_marl_tpu_torch.phys import engine, mjcf

GRAV = (0.0, 0.0, -9.81)
CP = engine.ContactParams()
HE = (0.5, 14.0, 0.5)
H = 0.0166 / 3
BOX_MASS = 28.0
# (base height, base position noise, hinge noise, velocity noise, torque
# range, box height)
SCENARIOS = {
    "airborne": (3.0, 0.05, 0.2, 0.3, 5.0, -5.0),   # no contacts: articulated dynamics only
    "standing": (0.75, 0.0, 0.05, 0.05, 1.0, 0.45),  # light contact, small motion
    "chaotic": (0.55, 0.3, 0.3, 0.5, 15.0, 0.45),    # deep penetration, large random motion
}


def box_inertia() -> np.ndarray:
    m = BOX_MASS
    return np.diag([m / 3.0 * (HE[1] ** 2 + HE[2] ** 2),
                    m / 3.0 * (HE[0] ** 2 + HE[2] ** 2),
                    m / 3.0 * (HE[0] ** 2 + HE[1] ** 2)])


def engine_substep(sys, qpos, qvel, tau, box_qpos, box_qvel, use_box, clamp):
    """One substep of [B, ...] states on the array engine, as the script's."""
    fk = engine.fwd_kinematics(sys, qpos, qvel)
    p_w, v_w = engine.points_world(sys, fk)
    pi = engine.point_inertia(sys, fk, p_w) if clamp else None
    h = H if clamp else None
    f_pts = engine.contact_plane(p_w, v_w, sys.point_radius, sys.point_friction,
                                 CP, pi=pi, h=h)
    if use_box:
        I = torch.as_tensor(box_inertia(), dtype=torch.float32, device=qpos.device)
        f_box, _ = engine.contact_box(
            p_w, v_w, sys.point_radius, sys.point_friction * 0.0,
            box_qpos[..., 0:3], box_qpos[..., 3:7], box_qvel, HE, CP, pi=pi, h=h,
            box_inv=(1.0 / BOX_MASS, engine._inv3x3_sym(I)) if clamp else None)
        f_pts = f_pts + f_box
    fe = engine.accumulate_body_forces(sys, p_w, f_pts, fk.base)
    tt = tau + engine.joint_limit_torque(sys, qpos, qvel) - sys.damping * qvel[..., 6:]
    qacc = engine.forward_dynamics(sys, fk, qvel, tt, fe,
                                   torch.tensor(GRAV, dtype=qpos.dtype, device=qpos.device))
    return engine.integrate(sys, qpos, qvel, qacc, H)


def kernel_consts(sys, use_box, clamp, contact=CP) -> sp.AntConsts:
    """The table of the script's kernels: clamp off bakes beta=None (B6's
    legacy branch, no box inverse inertia), clamp on passes the box's."""
    inv = (1.0 / BOX_MASS, np.linalg.inv(box_inertia()))
    return sp.bake_consts(sys, sp.SubstepParams(
        h=H, gravity=GRAV, contact=contact if clamp else contact._replace(beta=None),
        plane_friction=1.0, box_friction=0.0, friction_combine="multiply",
        box_he=HE if use_box else None, box_inv=inv if use_box and clamp else None))


def make_states(sys, init_hinge, B, scenario, seed=0, device="cpu"):
    """[B, n] states of a scenario: (qpos, qvel, tau, box_qpos, box_qvel)."""
    z0, posn, hingen, veln, taun, box_z = SCENARIOS[scenario]
    g = torch.Generator().manual_seed(seed)
    qpos = torch.cat([torch.tensor([0.5, -0.3, z0, 0.0, 0.0, 0.0, 1.0]),
                      torch.as_tensor(init_hinge, dtype=torch.float32)]).repeat(B, 1)
    qpos[:, 0:3] += torch.randn(B, 3, generator=g) * posn
    qpos[:, 7:] += (torch.rand(B, 8, generator=g) * 2 - 1) * hingen
    qvel = torch.randn(B, sys.nv, generator=g) * veln
    tau = (torch.rand(B, 8, generator=g) * 2 - 1) * taun
    box_qpos = torch.tensor([0.8, 0.0, box_z, 0.0, 0.0, 0.1, 0.995]).repeat(B, 1)
    box_qvel = torch.randn(B, 6, generator=g) * 0.2
    return tuple(x.to(device) for x in (qpos, qvel, tau, box_qpos, box_qvel))


def _soa(x):
    return x.t().contiguous()


def main(argv=None):
    """Prints one line per case; returns [{"clamp", "box", "dqpos", "dqvel"}]."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", choices=sorted(SCENARIOS),
                    default=os.environ.get("SCENARIO", "chaotic"))
    ap.add_argument("--mode", choices=["kernels", "scalar"],
                    default="scalar" if os.environ.get("MODE") == "xla_scalar" else "kernels")
    ap.add_argument("--B", type=int, default=1024)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device={dev}", flush=True)
    model = mjcf.parse_mjcf(mjcf.asset_path("ant.xml"))
    sys = model.system.to(dev)
    print(f"scenario={args.scenario}", flush=True)
    qpos, qvel, tau, box_qpos, box_qvel = make_states(sys, model.init_hinge, args.B,
                                                      args.scenario, device=dev)
    ops = [_soa(x) for x in (qpos, qvel, tau, box_qpos, box_qvel)]

    if args.mode == "scalar":
        # the script calls the scalar substep with its default hc_vel of 0
        c = kernel_consts(sys, False, True, contact=CP._replace(hc_vel=0.0))
        qp_e, qv_e = engine_substep(sys, qpos, qvel, tau, box_qpos, box_qvel, False, True)
        qp_s, qv_s = (x.t() for x in fs.substep_plain(c, 1, *ops)[:2])
        dq = float(torch.max(torch.abs(qp_s - qp_e)))
        dv = float(torch.max(torch.abs(qv_s - qv_e)))
        print(f"scalar vs engine (clamp, no box): max|dqpos|={dq:.3e} max|dqvel|={dv:.3e}",
              flush=True)
        idx = int(torch.argmax(torch.max(torch.abs(qv_s - qv_e), dim=1).values))
        print("worst row qvel diff per dof:",
              np.round((qv_s[idx] - qv_e[idx]).cpu().numpy(), 4), flush=True)
        print("qpos row:", np.round(qpos[idx].cpu().numpy(), 3), flush=True)
        return [{"clamp": True, "box": False, "dqpos": dq, "dqvel": dv}]

    rows = []
    for clamp in (False, True):
        for use_box in (False, True):
            qp_e, qv_e = engine_substep(sys, qpos, qvel, tau, box_qpos, box_qvel, use_box, clamp)
            c = kernel_consts(sys, use_box, clamp)
            if clamp:
                out = fs.substep_soa(c, 1, *ops)
            else:
                out = fs.debug_substep_soa(c, *ops)
            qp_s, qv_s = out[0].t(), out[1].t()
            dq = float(torch.max(torch.abs(qp_s - qp_e)))
            dv = float(torch.max(torch.abs(qv_s - qv_e)))
            print(f"clamp={clamp} box={use_box}:  max|dqpos|={dq:.3e}  max|dqvel|={dv:.3e}",
                  flush=True)
            rows.append({"clamp": clamp, "box": use_box, "dqpos": dq, "dqvel": dv})
    return rows


if __name__ == "__main__":
    main()
