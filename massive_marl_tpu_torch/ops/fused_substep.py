"""Batched ant(+box) control step on the hand-written substep kernel
(counterpart of massive_marl_tpu/ops/fused_substep.py::fused_scene_step).

The flat articulation batch B = E * num_ants is laid out struct-of-arrays,
[field, B], and each physics substep is ONE launch of the CUDA kernel in
csrc/substep.cu (a team of four lanes per articulation, one per leg).  The
kernel is compiled for the ant's tree (KERNEL_TREE); its wrappers refuse a
table baked from another (`check_kernel_tree`).  Only the foot sensors of
the last substep are kept, as the reference does.

`substep_soa` is the dispatch point: a CUDA tensor goes to the kernel (or
raises), a CPU tensor goes to the plain version in scalar_phys.  There is no
other fallback.  A table baked from `ContactParams(beta=None)` runs the
kernel's legacy instantiation (the reference's explicit contact branch).
With domain randomization (spec.dr_spec set) the scene's DrSample travels
as one more [41, B] operand (`pack_dr`, fields in DR_LAYOUT's order) and
runs the kernel's DR instantiation of either branch.

The push-box (one free body per env) steps after each launch of B1 on
`box_substep_soa`: on the card one launch of the same library's box kernel
(`BoxSubstepKernel`), which sums the env's ants' [6, B] wrenches on the way
in and reads its constants from a table baked once per device
(`box_table`); on the CPU the wrench sum in torch and envs/ant_scene.py's
plain `box_substep`, which the kernel follows operation for operation.

The same source holds B6 (`DebugSubstepKernel`, dispatched by
`debug_substep_soa`): the counterpart of scripts/debug_fused_tpu.py's
one-off kernel, B1's body on the legacy branch without sensor outputs, with
one box state per articulation.  cli/debug_fused.py holds it and B1 against
the array engine.
"""
from __future__ import annotations

import ctypes
import dataclasses
import inspect

import numpy as np
import torch

from massive_marl_tpu_torch.envs.ant_scene import box_substep
from massive_marl_tpu_torch.ops import _build
from massive_marl_tpu_torch.ops import scalar_phys as sp
from massive_marl_tpu_torch.phys import engine
from massive_marl_tpu_torch.utils.profiling import span, spanned

NQ, NV, NU = sp.NQ, sp.NV, sp.NJ
# the DR operand's fields, in order (massive_marl_tpu's _dr_field_layout)
DR_LAYOUT = (("mass", sp.NB), ("damping", sp.NJ), ("armature", sp.NJ), ("jnt_lo", sp.NJ),
             ("jnt_hi", sp.NJ))
DR_LEN = sum(n for _, n in DR_LAYOUT)


def pack_dr(d) -> torch.Tensor:
    """A DrSample with [..., n] leaves -> the contiguous float32 [41, B]
    operand, B the product of the leading dimensions."""
    fields = [getattr(d, name) for name, _ in DR_LAYOUT]
    B = fields[0][..., 0].numel()
    return torch.cat([x.reshape(B, -1) for x in fields], dim=1).to(torch.float32).t().contiguous()


def unpack_dr(dr: torch.Tensor) -> dict:
    """The [41, B] operand -> scalar_phys.substep's dr dict of [B] rows."""
    out, off = {}, 0
    for name, n in DR_LAYOUT:
        out[name] = list(dr[off:off + n])
        off += n
    return out


# the ant's tree as csrc/substep.cu compiles it (its constexpr PARENT,
# POINT_START, CHAIN_MASK, BODY_OF_DOF and BODY_SENSOR)
KERNEL_TREE = {
    "parent": (-1, 0, 1, 0, 3, 0, 5, 0, 7),
    "point_start": (0, 13, 16, 19, 22, 25, 28, 31, 34, 37),
    "chain_mask": (1, 3, 7, 15, 31, 63, 127, 255, 319, 831, 1087, 3135, 4159, 12351),
    "body_of_dof": (0, 0, 0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8),
    "body_sensor": (-1, -1, 0, -1, 1, -1, 2, -1, 3),
}


def table_tree(c: sp.AntConsts) -> dict:
    """The tree a baked table describes, in KERNEL_TREE's keys (the table's
    own fields, and the plain version's body_of_dof)."""
    as_int = lambda xs: tuple(int(x) for x in xs)
    tree = {k: as_int(c.f[k]) for k in ("parent", "point_start", "chain_mask", "body_sensor")}
    tree["body_of_dof"] = as_int(c.body_of_dof)
    return tree


def check_kernel_tree(c: sp.AntConsts) -> None:
    """Raise ValueError unless the table (and the plain version's parent and
    point_sensor beside it) was baked from the tree the substep kernel is
    compiled for."""
    bad = {k: v for k, v in table_tree(c).items() if v != KERNEL_TREE[k]}
    if tuple(c.parent) != KERNEL_TREE["parent"]:
        bad["parent of the plain version"] = tuple(c.parent)
    if tuple(c.point_sensor) != tuple(KERNEL_TREE["body_sensor"][b] for b in c.point_body):
        bad["point_sensor"] = tuple(c.point_sensor)
    if bad:
        raise ValueError(f"the substep kernel is compiled for the ant's tree {KERNEL_TREE}; "
                         f"this table differs in {bad}")


def _check_operands(expect, dev):
    for name, (t, shape) in expect.items():
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous() \
                or tuple(t.shape) != shape:
            raise ValueError(f"substep kernel: {name} must be a contiguous float32 "
                             f"{shape} tensor on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if dev.type != "cuda":
        raise ValueError("the substep kernel takes CUDA tensors")


def _device_table(lib, c: sp.AntConsts, dev):
    """The kernel's table on dev.  Its tree is checked at its first upload
    to dev (AntConsts.device_table copies once per device), so a launch
    pays for the check once."""
    if str(dev) not in c._device_tables:
        check_kernel_tree(c)
    table = c.device_table(dev)
    if lib.substep_table_len(c.P) != table.numel():
        raise ValueError(f"constant table has {table.numel()} floats, the kernel "
                         f"expects {lib.substep_table_len(c.P)} for P={c.P}")
    return table


_P, _I = ctypes.c_void_p, ctypes.c_int


class SubstepKernel:
    """ctypes binding of csrc/substep.cu's B1 launcher.  `launches` counts
    kernel launches (and nothing else); `legacy_launches` and `dr_launches`
    count those of the legacy and the DR instantiations among them.  The
    library is built and loaded at first use.  signatures: {function:
    (argtypes, restype)} of the source's C interface."""

    source = "substep.cu"
    signatures = {
        "substep_table_len": ([_I], _I),
        "substep_launch": ([_P] + [_I] * 6 + [_P] * 11, _I),
        "debug_substep_launch": ([_P] + [_I] * 3 + [_P] * 9, _I),
        "substep_threads_per_block": ([], _I),
        "substep_blocks_per_sm": ([_I], _I),
        "box_table_len": ([], _I),
        "box_substep_launch": ([_P] + [_I] * 3 + [_P] * 6, _I),
    }
    # the instantiations substep_blocks_per_sm numbers
    INSTANTIATIONS = ("B1", "B1 legacy", "B1-DR", "B1-DR legacy", "B6")

    def __init__(self):
        self.launches = 0
        self.legacy_launches = 0
        self.dr_launches = 0
        self.build_result = None
        self._lib = None

    def load(self):
        if self._lib is None:
            res = _build.build(self.source)
            lib = ctypes.CDLL(res.path)
            for name, (argtypes, restype) in self.signatures.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
            self._lib, self.build_result = lib, res
        return self._lib

    def occupancy(self) -> dict:
        """{instantiation: (resident blocks per SM, threads per block)} from
        cudaOccupancyMaxActiveBlocksPerMultiprocessor (needs the card)."""
        lib = self.load()
        threads = lib.substep_threads_per_block()
        out = {}
        for k, name in enumerate(self.INSTANTIATIONS):
            n = lib.substep_blocks_per_sm(k)
            if n < 0:
                raise RuntimeError(f"occupancy query for {name} failed with CUDA error {-n}")
            out[name] = (n, threads)
        return out

    def __call__(self, c: sp.AntConsts, num_ants, qpos, qvel, tau, box_qpos, box_qvel, dr=None):
        """c: the baked table (its legacy flag picks the instantiation);
        qpos [15,B], qvel [14,B], tau [8,B]; box_* [7|6, E] (E = B /
        num_ants); dr: the [41,B] DR operand (pack_dr) or None for the
        table's parameters.  Returns (qpos', qvel', wrench [6,B], sensors
        [24,B])."""
        dev = qpos.device
        B, E = qpos.shape[1], box_qpos.shape[1]
        expect = {"qpos": (qpos, (NQ, B)), "qvel": (qvel, (NV, B)), "tau": (tau, (NU, B)),
                  "box_qpos": (box_qpos, (7, E)), "box_qvel": (box_qvel, (6, E))}
        if dr is not None:
            expect["dr"] = (dr, (DR_LEN, B))
        _check_operands(expect, dev)
        if B != E * num_ants:
            raise ValueError(f"B={B} articulations is not E={E} envs x {num_ants} ants")
        lib = self.load()
        table = _device_table(lib, c, dev)
        qpos_out = torch.empty_like(qpos)
        qvel_out = torch.empty_like(qvel)
        wrench = torch.empty((6, B), dtype=torch.float32, device=dev)
        sens = torch.empty((6 * sp.NS, B), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.substep_launch(
            table.data_ptr(), table.numel(), c.P, num_ants, B, E, int(c.legacy),
            None if dr is None else dr.data_ptr(),
            qpos.data_ptr(), qvel.data_ptr(), tau.data_ptr(), box_qpos.data_ptr(),
            box_qvel.data_ptr(), qpos_out.data_ptr(), qvel_out.data_ptr(),
            wrench.data_ptr(), sens.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"substep kernel launch failed with CUDA error {err}")
        self.launches += 1
        self.legacy_launches += int(c.legacy)
        self.dr_launches += int(dr is not None)
        return qpos_out, qvel_out, wrench, sens


substep_kernel = SubstepKernel()


class DebugSubstepKernel:
    """ctypes binding of csrc/substep.cu's B6 launcher (the legacy
    instantiation without sensors; the library is B1's).  `launches` counts
    its launches and nothing else."""

    def __init__(self):
        self.launches = 0

    def __call__(self, c: sp.AntConsts, qpos, qvel, tau, box_qpos, box_qvel):
        """c: a table baked with ContactParams(beta=None); qpos [15,B],
        qvel [14,B], tau [8,B], box_qpos [7,B], box_qvel [6,B] (read only
        when the table has a box).  Returns (qpos', qvel', wrench [6,B])."""
        dev = qpos.device
        B = qpos.shape[1]
        _check_operands({"qpos": (qpos, (NQ, B)), "qvel": (qvel, (NV, B)), "tau": (tau, (NU, B)),
                         "box_qpos": (box_qpos, (7, B)), "box_qvel": (box_qvel, (6, B))}, dev)
        if not c.legacy:
            raise ValueError("the debug substep kernel runs the legacy branch: bake the "
                             "table with ContactParams(beta=None)")
        lib = substep_kernel.load()
        table = _device_table(lib, c, dev)
        qpos_out = torch.empty_like(qpos)
        qvel_out = torch.empty_like(qvel)
        wrench = torch.empty((6, B), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.debug_substep_launch(
            table.data_ptr(), table.numel(), c.P, B, qpos.data_ptr(), qvel.data_ptr(),
            tau.data_ptr(), box_qpos.data_ptr(), box_qvel.data_ptr(), qpos_out.data_ptr(),
            qvel_out.data_ptr(), wrench.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"debug substep kernel launch failed with CUDA error {err}")
        self.launches += 1
        return qpos_out, qvel_out, wrench


debug_substep_kernel = DebugSubstepKernel()

# the box kernel's constant table, in csrc/substep.cu's X_* order
BOX_POINTS = 8
BOX_LAYOUT = (("mass", 1), ("inv_mass", 1), ("com", 3), ("inertia", 9), ("inertia_inv", 9),
              ("mg", 3), ("h", 1), ("half_h", 1), ("kn", 1), ("kd", 1), ("kh", 1), ("den", 1),
              ("hc_inv", 1), ("hc_vel", 1), ("hc_cap", 1), ("acc_units", 1),
              ("max_depen_vel", 1), ("max_lin_vel", 1), ("max_ang_vel", 1),
              ("point_local", 3 * BOX_POINTS), ("radius", BOX_POINTS), ("mu", BOX_POINTS))
BOX_ANTS = (1, 10)   # ants per env the box kernel is compiled for: OneAnt's, TenAnt's


def box_table(spec, h: float, dev) -> torch.Tensor:
    """The box kernel's float32 table on dev, BOX_LAYOUT's fields in order.  Each
    entry is made by the operation that box_substep applies to it on every
    call (the reciprocal of the mass, the closed-form inverse inertia, the
    pair friction, mass x gravity on dev; a Python float rounded to float32
    where torch rounds it; kh and den from their double values, as box_substep
    computes them when kn is a Python float)."""
    bsys, cp = spec.box_sys, spec.contact
    mass = bsys.mass.to(dev)
    gravity = torch.tensor(spec.gravity, dtype=torch.float32, device=dev)
    mu = (spec.box_ground_mu if spec.box_ground_mu is not None
          else engine.combine_mu(bsys.point_friction.to(dev), spec.plane_friction,
                                 spec.friction_combine))
    kh = cp.stiffness * h + cp.damping
    clamps = inspect.signature(engine.integrate).parameters
    parts = {
        "mass": mass[..., 0], "inv_mass": 1.0 / mass[..., 0, None], "com": bsys.com[0],
        "inertia": bsys.inertia[0], "inertia_inv": engine._inv3x3_sym(bsys.inertia[0].to(dev)),
        "mg": mass[..., 0, None] * gravity, "h": h, "half_h": 0.5 * h, "kn": cp.stiffness,
        "kd": cp.damping, "kh": kh, "den": 1.0 + h * kh,
        "hc_inv": np.float32(1.0) / np.float32(max(cp.hc_vel, 1e-9)), "hc_vel": cp.hc_vel,
        "hc_cap": cp.hc_cap, "acc_units": float(bool(cp.acc_units)),
        "max_depen_vel": cp.max_depen_vel, "max_lin_vel": clamps["max_lin_vel"].default,
        "max_ang_vel": clamps["max_ang_vel"].default, "point_local": bsys.point_local,
        "radius": bsys.point_radius, "mu": mu,
    }
    out = []
    for name, n in BOX_LAYOUT:
        x = torch.as_tensor(parts[name], dtype=torch.float32, device=dev).reshape(-1)
        out.append(x.expand(n) if x.numel() == 1 else x)
        if out[-1].numel() != n:
            raise ValueError(f"box table: {name} has {x.numel()} floats, the kernel reads {n}")
    return torch.cat(out).contiguous()


class BoxSubstepKernel:
    """ctypes binding of csrc/substep.cu's push-box launcher (B1's library):
    the box's free-body substep for every env in one launch.  `launches`
    counts its launches and nothing else.  Tables are kept per box system,
    device and the options they bake (each with its system, so no key's id
    is reused)."""

    def __init__(self):
        self.launches = 0
        self._tables = {}

    def table(self, spec, h: float, dev) -> torch.Tensor:
        key = (id(spec.box_sys), str(dev), h, spec.contact, tuple(spec.gravity),
               spec.plane_friction, spec.friction_combine, spec.box_ground_mu)
        if key not in self._tables:
            self._tables[key] = (spec.box_sys, box_table(spec, h, dev))
        return self._tables[key][1]

    def __call__(self, spec, box_qpos, box_qvel, wrench, h: float):
        """box_qpos [E,7], box_qvel [E,6]; wrench: B1's un-summed [6, B]
        output, B = E x spec.num_ants.  Returns the box's (qpos', qvel')."""
        bsys, A = spec.box_sys, spec.num_ants
        if tuple(bsys.point_body) != (0,) * BOX_POINTS or bsys.nb != 1:
            raise ValueError(f"the box kernel steps one body with {BOX_POINTS} contact points, "
                             f"got {bsys.nb} bodies and {len(bsys.point_body)} points")
        if A not in BOX_ANTS:
            raise ValueError(f"the box kernel is compiled for {BOX_ANTS} ants an env, got {A}")
        dev, E = box_qpos.device, box_qpos.shape[0]
        _check_operands({"box_qpos": (box_qpos, (E, 7)), "box_qvel": (box_qvel, (E, 6)),
                         "wrench": (wrench, (6, E * A))}, dev)
        lib = substep_kernel.load()
        table = self.table(spec, h, dev)
        if lib.box_table_len() != table.numel():
            raise ValueError(f"box table has {table.numel()} floats, the kernel expects "
                             f"{lib.box_table_len()}")
        qpos_out = torch.empty_like(box_qpos)
        qvel_out = torch.empty_like(box_qvel)
        err = lib.box_substep_launch(
            table.data_ptr(), table.numel(), A, E, wrench.data_ptr(), box_qpos.data_ptr(),
            box_qvel.data_ptr(), qpos_out.data_ptr(), qvel_out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"box substep kernel launch failed with CUDA error {err}")
        self.launches += 1
        return qpos_out, qvel_out


box_substep_kernel = BoxSubstepKernel()


def box_substep_soa(spec, box_qpos, box_qvel, wrench, h: float):
    """The push-box's substep from B1's un-summed [6, B] wrench: the box
    kernel for CUDA tensors, the wrench sum and the plain box_substep for CPU
    tensors."""
    if box_qpos.device.type == "cuda":
        with span("env.box_substep"):
            return box_substep_kernel(spec, box_qpos.contiguous(), box_qvel.contiguous(), wrench, h)
    if box_qpos.device.type == "cpu":
        wrench_sum = wrench.reshape(6, box_qpos.shape[0], spec.num_ants).sum(-1).t()
        return box_substep(spec, box_qpos, box_qvel, wrench_sum, h)
    raise ValueError(f"no box substep for device {box_qpos.device}")


def substep_plain(c: sp.AntConsts, num_ants, qpos, qvel, tau, box_qpos, box_qvel, dr=None):
    """The plain PyTorch version on the same [field, B] operands."""
    bq = box_qpos.repeat_interleave(num_ants, dim=1) if c.has_box else None
    bv = box_qvel.repeat_interleave(num_ants, dim=1) if c.has_box else None
    nqp, nqv, wr, sens = sp.substep(c, list(qpos), list(qvel), list(tau),
                                    None if bq is None else list(bq),
                                    None if bv is None else list(bv),
                                    dr=None if dr is None else unpack_dr(dr))
    wrench = torch.stack(wr) if wr is not None else qpos.new_zeros((6, qpos.shape[1]))
    return (torch.stack(nqp), torch.stack(nqv), wrench,
            torch.stack([x for s in sens for x in s]))


@spanned("env.substep")
def substep_soa(c: sp.AntConsts, num_ants, qpos, qvel, tau, box_qpos, box_qvel, dr=None):
    """One substep on [field, B] operands (dr: the [41, B] DR operand or
    None): the kernel for CUDA tensors, the plain version for CPU tensors."""
    if qpos.device.type == "cuda":
        return substep_kernel(c, num_ants, qpos, qvel, tau, box_qpos, box_qvel, dr)
    if qpos.device.type == "cpu":
        return substep_plain(c, num_ants, qpos, qvel, tau, box_qpos, box_qvel, dr)
    raise ValueError(f"no substep for device {qpos.device}")


def debug_substep_plain(c: sp.AntConsts, qpos, qvel, tau, box_qpos, box_qvel):
    """The plain version of B6 (the legacy branch, box state per
    articulation) on the same [field, B] operands."""
    if not c.legacy:
        raise ValueError("the debug substep runs the legacy branch: bake the table "
                         "with ContactParams(beta=None)")
    return substep_plain(c, 1, qpos, qvel, tau, box_qpos, box_qvel)[:3]


def debug_substep_soa(c: sp.AntConsts, qpos, qvel, tau, box_qpos, box_qvel):
    """One legacy-branch substep on [field, B] operands, box state per
    articulation: B6 for CUDA tensors, its plain version for CPU tensors."""
    if qpos.device.type == "cuda":
        return debug_substep_kernel(c, qpos, qvel, tau, box_qpos, box_qvel)
    if qpos.device.type == "cpu":
        return debug_substep_plain(c, qpos, qvel, tau, box_qpos, box_qvel)
    raise ValueError(f"no debug substep for device {qpos.device}")


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


@spanned("env.physics")
def fused_scene_step(spec, state, actions: torch.Tensor, consts: sp.AntConsts | None = None):
    """Advance one control step for a batch of envs.

    spec: AntSceneSpec; state: AntSceneState with a leading env axis
    (ant_qpos [E,A,15], box_qpos [E,7]); actions [E,A,8] in [-1,1].
    consts: the baked table (scene_consts(spec)), baked here when None.
    With spec.dr_spec set, state.dr's per-ant parameters go to every launch
    as the DR operand."""
    c = consts if consts is not None else scene_consts(spec)
    E, A = actions.shape[0], spec.num_ants
    B = E * A
    h = spec.dt / spec.substeps
    has_box = spec.box_sys is not None
    tau = (actions * spec.ant_sys.gear * spec.power_scale).to(torch.float32)

    qpos = state.ant_qpos.reshape(B, NQ).t().contiguous()
    qvel = state.ant_qvel.reshape(B, NV).t().contiguous()
    tau = tau.reshape(B, NU).t().contiguous()
    dr = pack_dr(state.dr) if spec.dr_spec is not None else None
    bq, bv = state.box_qpos, state.box_qvel
    for _ in range(spec.substeps):
        qpos, qvel, wrench, sens = substep_soa(c, A, qpos, qvel, tau,
                                               bq.t().contiguous(), bv.t().contiguous(), dr)
        if has_box:
            bq, bv = box_substep_soa(spec, bq, bv, wrench, h)

    sensors = sens.reshape(sp.NS, 6, E, A).permute(2, 3, 0, 1)
    return dataclasses.replace(
        state,
        ant_qpos=qpos.t().reshape(E, A, NQ), ant_qvel=qvel.t().reshape(E, A, NV),
        box_qpos=bq, box_qvel=bv, sensors=sensors,
        dr_count=state.dr_count + 1, frame=state.frame + 1)
