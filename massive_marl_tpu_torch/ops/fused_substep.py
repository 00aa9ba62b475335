"""Batched ant(+box) control step on the hand-written substep kernel
(counterpart of massive_marl_tpu/ops/fused_substep.py::fused_scene_step).

The flat articulation batch B = E * num_ants is laid out struct-of-arrays,
[field, B], and each physics substep is ONE launch of the CUDA kernel in
csrc/substep.cu (one articulation per thread).  Between launches the
per-ant box wrenches are summed per env and the push-box (one free body per
env) takes its own substep in plain PyTorch.  Only the foot sensors of the
last substep are kept, as the reference does.

`substep_soa` is the dispatch point: a CUDA tensor goes to the kernel (or
raises), a CPU tensor goes to the plain version in scalar_phys.  There is no
other fallback.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from massive_marl_tpu_torch.ops import _build
from massive_marl_tpu_torch.ops import scalar_phys as sp
from massive_marl_tpu_torch.phys import engine

NQ, NV, NU = sp.NQ, sp.NV, sp.NJ


class SubstepKernel:
    """ctypes binding of csrc/substep.cu.  `launches` counts kernel launches
    (and nothing else); the library is built and loaded at first use."""

    def __init__(self):
        self.launches = 0
        self.build_result = None
        self._lib = None

    def load(self):
        if self._lib is None:
            res = _build.build("substep.cu")
            lib = ctypes.CDLL(res.path)
            lib.substep_table_len.argtypes = [ctypes.c_int]
            lib.substep_table_len.restype = ctypes.c_int
            lib.substep_launch.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 10
            lib.substep_launch.restype = ctypes.c_int
            self._lib, self.build_result = lib, res
        return self._lib

    def __call__(self, table, P, num_ants, qpos, qvel, tau, box_qpos, box_qvel):
        """table [L]; qpos [15,B], qvel [14,B], tau [8,B]; box_* [7|6, E]
        (E = B / num_ants).  Returns (qpos', qvel', wrench [6,B], sensors [24,B])."""
        dev = qpos.device
        B, E = qpos.shape[1], box_qpos.shape[1]
        expect = {"table": (table, (table.numel(),)), "qpos": (qpos, (NQ, B)),
                  "qvel": (qvel, (NV, B)), "tau": (tau, (NU, B)),
                  "box_qpos": (box_qpos, (7, E)), "box_qvel": (box_qvel, (6, E))}
        for name, (t, shape) in expect.items():
            if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous() \
                    or tuple(t.shape) != shape:
                raise ValueError(f"substep kernel: {name} must be a contiguous float32 "
                                 f"{shape} tensor on {dev}, got {t.dtype} "
                                 f"{tuple(t.shape)} on {t.device}")
        if dev.type != "cuda":
            raise ValueError("the substep kernel takes CUDA tensors")
        if B != E * num_ants:
            raise ValueError(f"B={B} articulations is not E={E} envs x {num_ants} ants")
        lib = self.load()
        if lib.substep_table_len(P) != table.numel():
            raise ValueError(f"constant table has {table.numel()} floats, the kernel "
                             f"expects {lib.substep_table_len(P)} for P={P}")
        qpos_out = torch.empty_like(qpos)
        qvel_out = torch.empty_like(qvel)
        wrench = torch.empty((6, B), dtype=torch.float32, device=dev)
        sens = torch.empty((6 * sp.NS, B), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.substep_launch(
            table.data_ptr(), table.numel(), P, num_ants, B, E,
            qpos.data_ptr(), qvel.data_ptr(), tau.data_ptr(), box_qpos.data_ptr(),
            box_qvel.data_ptr(), qpos_out.data_ptr(), qvel_out.data_ptr(),
            wrench.data_ptr(), sens.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"substep kernel launch failed with CUDA error {err}")
        self.launches += 1
        return qpos_out, qvel_out, wrench, sens


substep_kernel = SubstepKernel()


def substep_plain(c: sp.AntConsts, num_ants, qpos, qvel, tau, box_qpos, box_qvel):
    """The plain PyTorch version on the same [field, B] operands."""
    bq = box_qpos.repeat_interleave(num_ants, dim=1) if c.has_box else None
    bv = box_qvel.repeat_interleave(num_ants, dim=1) if c.has_box else None
    nqp, nqv, wr, sens = sp.substep(c, list(qpos), list(qvel), list(tau),
                                    None if bq is None else list(bq),
                                    None if bv is None else list(bv))
    wrench = torch.stack(wr) if wr is not None else qpos.new_zeros((6, qpos.shape[1]))
    return (torch.stack(nqp), torch.stack(nqv), wrench,
            torch.stack([x for s in sens for x in s]))


def substep_soa(c: sp.AntConsts, num_ants, qpos, qvel, tau, box_qpos, box_qvel):
    """One substep on [field, B] operands: the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if qpos.device.type == "cuda":
        return substep_kernel(c.device_table(qpos.device), c.P, num_ants,
                              qpos, qvel, tau, box_qpos, box_qvel)
    if qpos.device.type == "cpu":
        return substep_plain(c, num_ants, qpos, qvel, tau, box_qpos, box_qvel)
    raise ValueError(f"no substep for device {qpos.device}")


def scene_consts(spec) -> sp.AntConsts:
    """Bake an AntSceneSpec's model and options into the substep table."""
    has_box = spec.box_sys is not None
    box_inv, box_he, box_mu = None, None, 0.0
    if has_box:
        bsys = spec.box_sys
        box_inv = (1.0 / float(bsys.mass[0]),
                   np.linalg.inv(bsys.inertia[0].detach().cpu().numpy().astype(np.float64)))
        box_he = tuple(float(x) for x in spec.box_half_extents)
        box_mu = float(bsys.point_friction[0])
    params = sp.SubstepParams(
        h=spec.dt / spec.substeps, gravity=tuple(float(g) for g in spec.gravity),
        contact=spec.contact, plane_friction=float(spec.plane_friction),
        box_friction=box_mu, friction_combine=spec.friction_combine,
        ant_box_mu=spec.ant_box_mu, limit_k=spec.limit_k, limit_damp=spec.limit_damp,
        box_he=box_he, box_inv=box_inv)
    return sp.bake_consts(spec.ant_sys, params)


def box_substep(spec, bq, bv, wrench_sum, h):
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


def fused_scene_step(spec, state, actions: torch.Tensor, consts: sp.AntConsts | None = None):
    """Advance one control step for a batch of envs.

    spec: AntSceneSpec; state: AntSceneState with a leading env axis
    (ant_qpos [E,A,15], box_qpos [E,7]); actions [E,A,8] in [-1,1].
    consts: the baked table (scene_consts(spec)), baked here when None."""
    if spec.dr_spec is not None:
        raise NotImplementedError("domain randomization is not ported yet")
    c = consts if consts is not None else scene_consts(spec)
    E, A = actions.shape[0], spec.num_ants
    B = E * A
    h = spec.dt / spec.substeps
    has_box = spec.box_sys is not None
    tau = (actions * spec.ant_sys.gear * spec.power_scale).to(torch.float32)

    qpos = state.ant_qpos.reshape(B, NQ).t().contiguous()
    qvel = state.ant_qvel.reshape(B, NV).t().contiguous()
    tau = tau.reshape(B, NU).t().contiguous()
    bq, bv = state.box_qpos, state.box_qvel
    for _ in range(spec.substeps):
        qpos, qvel, wrench, sens = substep_soa(c, A, qpos, qvel, tau,
                                               bq.t().contiguous(), bv.t().contiguous())
        if has_box:
            bq, bv = box_substep(spec, bq, bv, wrench.reshape(6, E, A).sum(-1).t(), h)

    sensors = sens.reshape(sp.NS, 6, E, A).permute(2, 3, 0, 1)
    return dataclasses.replace(
        state,
        ant_qpos=qpos.t().reshape(E, A, NQ), ant_qvel=qvel.t().reshape(E, A, NV),
        box_qpos=bq, box_qvel=bv, sensors=sensors,
        dr_count=state.dr_count + 1, frame=state.frame + 1)
