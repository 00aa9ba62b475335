"""The substep kernels' wrappers (B1 with and without its DR operand, and B6
on B1's legacy branch) and their device rule.

CPU tests: a CPU tensor takes the plain version and never touches the
launch counters; the kernel wrappers refuse CPU tensors; entry points raise
when CUDA is absent and the caller did not ask for the CPU; a legacy table
(ContactParams(beta=None)) bakes without the box's inverse inertia.

Tests marked `cuda` hold B1 (both branches, with and without the DR
operand) and B6 against their plain versions on the card and skip without
one.  They import nothing of JAX, so on the GPU host they
run without the repository's JAX conftest:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fused_substep.py -m cuda
"""
import dataclasses
import pathlib
import re

import numpy as np
import pytest
import torch

import massive_marl_tpu_torch
from massive_marl_tpu_torch.envs.ten_ant import TenAntEnv
from massive_marl_tpu_torch.ops import fused_substep as fs
from massive_marl_tpu_torch.ops import scalar_phys as sp
from massive_marl_tpu_torch.cli import debug_fused
from massive_marl_tpu_torch.phys import mjcf
from massive_marl_tpu_torch.phys.engine import ContactParams


@pytest.fixture(scope="module")
def env_cpu():
    return TenAntEnv(device="cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _states(env, E, seed, device):
    """Feet in ground contact, ants inside / just outside the box, hinges
    beyond their limits: one family per env, by env index."""
    g = torch.Generator().manual_seed(seed)
    s = env.reset(E).pipeline
    A = env.spec.num_ants
    qpos, qvel = s.ant_qpos.cpu().clone(), torch.randn(E, A, 14, generator=g) * 0.5
    box = s.box_qpos.cpu().clone()
    qpos[..., 2] = 0.45 + 0.2 * torch.rand(E, A, generator=g)
    lo, hi = env.spec.ant_sys.jnt_range.cpu().unbind(1)
    fam = torch.arange(E) % 3
    box[fam == 1, 0:3] = torch.tensor([0.8, 0.0, 0.45])
    qpos[fam == 1, :, 0:3] = torch.tensor([0.5, -0.3, 0.55]) + 0.3 * torch.randn(
        int((fam == 1).sum()), A, 3, generator=g)
    beyond = 0.02 + 0.18 * torch.rand(E, A, 8, generator=g)
    past = torch.where(torch.rand(E, A, 8, generator=g) < 0.5, lo - beyond, hi + beyond)
    qpos[fam == 2, :, 7:] = past[fam == 2]
    tau = (torch.rand(E, A, 8, generator=g) * 2 - 1) * 15
    B = E * A
    t = lambda x, n: x.reshape(B, n).t().contiguous().to(device)
    return (t(qpos, 15), t(qvel, 14), t(tau, 8),
            box.t().contiguous().to(device), torch.zeros(6, E, device=device))


def test_cpu_tensors_take_the_plain_version(env_cpu):
    c = env_cpu.substep_consts
    ops = _states(env_cpu, 3, 0, "cpu")
    before = fs.substep_kernel.launches
    out = fs.substep_soa(c, 10, *ops)
    assert fs.substep_kernel.launches == before
    assert [tuple(o.shape) for o in out] == [(15, 30), (14, 30), (6, 30), (24, 30)]
    assert all(torch.isfinite(o).all() for o in out)
    with pytest.raises(ValueError, match="CUDA"):
        fs.substep_kernel(c, 10, *ops)


def test_legacy_table_needs_no_box_inverse_inertia(env_cpu):
    legacy = env_cpu.spec.contact._replace(beta=None)
    params = sp.SubstepParams(h=0.005, contact=legacy, box_he=(0.5, 14.0, 0.5))
    c = sp.bake_consts(env_cpu.spec.ant_sys, params)
    assert c.legacy and c.f["legacy"] == [1.0] and c.f["box_inv_mass"] == [0.0]
    assert c.f["friction_vel"][0] == pytest.approx(legacy.friction_vel)
    assert not env_cpu.substep_consts.legacy and env_cpu.substep_consts.f["legacy"] == [0.0]
    with pytest.raises(ValueError, match="box_inv"):
        sp.bake_consts(env_cpu.spec.ant_sys, dataclasses.replace(params, contact=ContactParams()))


def test_debug_kernel_refuses_cpu_tensors_and_clamped_tables(env_cpu):
    sys, hinge = env_cpu.spec.ant_sys, env_cpu.model.init_hinge
    ops = [x.t().contiguous() for x in debug_fused.make_states(sys, hinge, 8, "standing")]
    before = fs.debug_substep_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        fs.debug_substep_kernel(debug_fused.kernel_consts(sys, True, False), *ops)
    with pytest.raises(ValueError, match="legacy"):
        fs.debug_substep_soa(debug_fused.kernel_consts(sys, True, True), *ops)
    assert fs.debug_substep_kernel.launches == before


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        massive_marl_tpu_torch.resolve_device(None)
    with pytest.raises(RuntimeError):
        TenAntEnv()
    assert massive_marl_tpu_torch.resolve_device("cpu") == torch.device("cpu")


def test_table_layout_and_shape_checks(env_cpu):
    c = env_cpu.substep_consts
    assert c.table.numel() == sum(n for _, n in sp.table_layout(c.P))
    assert c.f["mu_plane"][0] == pytest.approx(1.25)  # average(1.5, 1.0)
    assert c.f["mu_box"][0] == pytest.approx(0.75)    # average(1.5, 0.0)
    with pytest.raises(ValueError, match="nb=9"):
        sp.bake_consts(mjcf.make_box_system((0.5, 14.0, 0.5)), sp.SubstepParams(h=0.005))


def test_cuda_table_offsets_match_python_layout():
    """Each O_<FIELD> offset in csrc/substep.cu equals the position of
    <field> in scalar_phys.table_layout; the per-point fields follow
    FIXED_LEN in layout order."""
    src = (pathlib.Path(fs.__file__).parent / "csrc" / "substep.cu").read_text()
    cu = {"NB": sp.NB, "NJ": sp.NJ, "NV": sp.NV}
    for name, expr in re.findall(r"constexpr int (O_\w+|FIXED_LEN) = ([^;]+);", src):
        cu[name] = eval(expr, {}, dict(cu))
    off, py = 0, {}
    for name, n in sp.table_layout(P=0):
        py["O_" + name.upper()] = off
        off += n
    point_fields = ["O_POINT_LOCAL", "O_POINT_RADIUS", "O_MU_PLANE", "O_MU_BOX"]
    assert {k: cu.get(k) for k in py if k not in point_fields} == \
        {k: v for k, v in py.items() if k not in point_fields}
    assert list(py)[-4:] == point_fields and py["O_POINT_LOCAL"] == cu["FIXED_LEN"]


def test_cuda_dr_offsets_match_python_layout():
    """Each D_<FIELD> offset in csrc/substep.cu equals the position of the
    field in fused_substep.DR_LAYOUT, and DR_LEN its total."""
    src = (pathlib.Path(fs.__file__).parent / "csrc" / "substep.cu").read_text()
    cu = {"NB": sp.NB, "NJ": sp.NJ}
    for name, expr in re.findall(r"constexpr int (D_\w+|DR_LEN) = ([^;]+);", src):
        cu[name] = eval(expr, {}, dict(cu))
    off, py = 0, {}
    for name, n in fs.DR_LAYOUT:
        py["D_" + name.upper()] = off
        off += n
    py["DR_LEN"] = off
    assert {k: cu[k] for k in py} == py and off == fs.DR_LEN == 41


def _dr_operand(env, E, seed, device, armature=True):
    """A [41, E*10] DR operand from cfg/TenAnt.yaml's ranges (mass, damping
    and, with armature, the armature scaled by U[0.5, 1.5]; the limits
    moved by N(0, 0.01))."""
    from massive_marl_tpu_torch.phys import dr
    spec = {"rigid_body_properties": {"mass": {"range": [0.5, 1.5]}},
            "dof_properties": {"damping": {"range": [0.5, 1.5]},
                               "stiffness": {"range": [0.5, 1.5], "maps_to": "armature"},
                               "lower": {"range": [0, 0.01], "operation": "additive",
                                         "distribution": "gaussian"},
                               "upper": {"range": [0, 0.01], "operation": "additive",
                                         "distribution": "gaussian"}}}
    if not armature:
        del spec["dof_properties"]["stiffness"]
    g = torch.Generator().manual_seed(seed)
    d = dr.sample_dr(env.spec.ant_sys.to("cpu"), spec, (E, 10), g)
    return fs.pack_dr(d).to(device)


def _assert_close_masked(got, ref, names, tol):
    """Same non-finite mask; the finite values within (rtol, atol)."""
    for name, g, r, (rtol, atol) in zip(names, got, ref, tol):
        g, r = g.cpu().numpy(), r.cpu().numpy()
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(r), err_msg=name)
        fin = np.isfinite(r)
        np.testing.assert_allclose(g[fin], r[fin], rtol=rtol, atol=atol, err_msg=name)


TOL = [(2e-4, 2e-4), (5e-3, 5e-3), (5e-3, 5e-2), (5e-3, 5e-2)]


@pytest.mark.cuda
@pytest.mark.parametrize("legacy", [False, True])
@pytest.mark.parametrize("has_box", [True, False])
def test_kernel_matches_plain_on_card(cuda, has_box, legacy):
    env = TenAntEnv(device=cuda)
    spec = env.spec if has_box else env.spec._replace(box_sys=None, box_half_extents=None)
    if legacy:
        spec = spec._replace(contact=spec.contact._replace(beta=None))
    c = fs.scene_consts(spec)
    assert c.legacy == legacy
    ops = _states(env, 24, 1, cuda)
    before = fs.substep_kernel.launches, fs.substep_kernel.legacy_launches
    got = fs.substep_kernel(c, 10, *ops)
    torch.cuda.synchronize()
    assert (fs.substep_kernel.launches, fs.substep_kernel.legacy_launches) == \
        (before[0] + 1, before[1] + int(legacy))
    ref = fs.substep_plain(c, 10, *ops)
    _assert_close_masked(got, ref, ["qpos", "qvel", "wrench", "sensors"], TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("armature", [False, True])
@pytest.mark.parametrize("legacy", [False, True])
@pytest.mark.parametrize("has_box", [True, False])
def test_dr_kernel_matches_plain_on_card(cuda, has_box, legacy, armature):
    """B1's DR instantiation at E = 24 (B = 240, a ragged last block): the
    same bits as its plain version, held at the tolerance of the other B1
    branches."""
    env = TenAntEnv(device=cuda)
    spec = env.spec if has_box else env.spec._replace(box_sys=None, box_half_extents=None)
    if legacy:
        spec = spec._replace(contact=spec.contact._replace(beta=None))
    c = fs.scene_consts(spec)
    ops = _states(env, 24, 1, cuda)
    dr = _dr_operand(env, 24, 2, cuda, armature)
    before = (fs.substep_kernel.launches, fs.substep_kernel.legacy_launches,
              fs.substep_kernel.dr_launches)
    got = fs.substep_kernel(c, 10, *ops, dr=dr)
    torch.cuda.synchronize()
    assert (fs.substep_kernel.launches, fs.substep_kernel.legacy_launches,
            fs.substep_kernel.dr_launches) == (before[0] + 1, before[1] + int(legacy),
                                               before[2] + 1)
    ref = fs.substep_plain(c, 10, *ops, dr=dr)
    _assert_close_masked(got, ref, ["qpos", "qvel", "wrench", "sensors"], TOL)
    nominal = fs.substep_kernel(c, 10, *ops)
    assert not torch.equal(nominal[1], got[1])


@pytest.mark.cuda
def test_dr_kernel_rejects_bad_operands(cuda):
    env = TenAntEnv(device=cuda)
    c = env.substep_consts
    ops = _states(env, 4, 2, cuda)
    dr = _dr_operand(env, 4, 3, cuda)
    before = fs.substep_kernel.launches
    with pytest.raises(ValueError, match="dr"):
        fs.substep_kernel(c, 10, *ops, dr=dr[:-1].contiguous())
    with pytest.raises(ValueError, match="dr"):
        fs.substep_kernel(c, 10, *ops, dr=dr.t().contiguous().t())
    with pytest.raises(ValueError, match="dr"):
        fs.substep_kernel(c, 10, *ops, dr=dr.cpu())
    assert fs.substep_kernel.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("scenario", sorted(debug_fused.SCENARIOS))
@pytest.mark.parametrize("use_box", [True, False])
def test_debug_kernel_matches_plain_on_card(cuda, scenario, use_box):
    """B6 at B = 1029 (a ragged last block): the legacy scenarios drive qvel
    onto the integrator's clamps, so the non-finite masks must agree too."""
    env = TenAntEnv(device=cuda)
    sys, hinge = env.spec.ant_sys, env.model.init_hinge
    c = debug_fused.kernel_consts(sys, use_box, clamp=False)
    ops = [x.t().contiguous() for x in debug_fused.make_states(sys, hinge, 1029, scenario, 3,
                                                                cuda)]
    before = fs.debug_substep_kernel.launches, fs.substep_kernel.launches
    got = fs.debug_substep_kernel(c, *ops)
    torch.cuda.synchronize()
    assert (fs.debug_substep_kernel.launches, fs.substep_kernel.launches) == \
        (before[0] + 1, before[1])
    ref = fs.debug_substep_plain(c, *ops)
    _assert_close_masked(got, ref, ["qpos", "qvel", "wrench"], TOL)


@pytest.mark.cuda
def test_kernel_rejects_bad_operands(cuda):
    env = TenAntEnv(device=cuda)
    c = env.substep_consts
    qpos, qvel, tau, bq, bv = _states(env, 4, 2, cuda)
    with pytest.raises(ValueError, match="qvel"):
        fs.substep_kernel(c, 10, qpos, qvel[:, :-1], tau, bq, bv)
    with pytest.raises(ValueError, match="P="):
        fs.substep_kernel(dataclasses.replace(c, P=c.P + 1), 10, qpos, qvel, tau, bq, bv)


@pytest.mark.cuda
def test_debug_kernel_rejects_bad_operands(cuda):
    env = TenAntEnv(device=cuda)
    sys, hinge = env.spec.ant_sys, env.model.init_hinge
    c = debug_fused.kernel_consts(sys, True, clamp=False)
    qpos, qvel, tau, bq, bv = [x.t().contiguous() for x in
                               debug_fused.make_states(sys, hinge, 256, "chaotic", 0, cuda)]
    before = fs.debug_substep_kernel.launches
    with pytest.raises(ValueError, match="box_qpos"):   # box state per env, not per articulation
        fs.debug_substep_kernel(c, qpos, qvel, tau, bq[:, :128].contiguous(), bv)
    with pytest.raises(ValueError, match="tau"):
        fs.debug_substep_kernel(c, qpos, qvel, tau.double(), bq, bv)
    with pytest.raises(ValueError, match="legacy"):
        fs.debug_substep_kernel(debug_fused.kernel_consts(sys, True, clamp=True),
                                qpos, qvel, tau, bq, bv)
    assert fs.debug_substep_kernel.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("n_env,num_ants", [(4097, 10), (1, 1), (3, 1)])
def test_kernel_tail_matches_plain_on_card(cuda, n_env, num_ants):
    """B1 at B = 10 x 4097, 1 and 3, no multiple of a block's articulations:
    lanes past B compute on the last articulation and store nothing."""
    env = TenAntEnv(device=cuda)
    c = env.substep_consts
    qpos, qvel, tau, bq, bv = _states(env, n_env, 4, cuda)
    B = n_env * num_ants
    qpos, qvel, tau = (x[:, :B].contiguous() for x in (qpos, qvel, tau))
    got = fs.substep_kernel(c, num_ants, qpos, qvel, tau, bq, bv)
    torch.cuda.synchronize()
    ref = fs.substep_plain(c, num_ants, qpos, qvel, tau, bq, bv)
    assert [tuple(g.shape) for g in got] == [(15, B), (14, B), (6, B), (24, B)]
    _assert_close_masked(got, ref, ["qpos", "qvel", "wrench", "sensors"], TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1024, 1, 37])
def test_debug_kernel_at_its_shape_and_ragged_on_card(cuda, B):
    """B6 at its TPU shape (B = 1024) and at sizes that end inside a block."""
    env = TenAntEnv(device=cuda)
    sys, hinge = env.spec.ant_sys, env.model.init_hinge
    c = debug_fused.kernel_consts(sys, True, clamp=False)
    ops = [x.t().contiguous() for x in debug_fused.make_states(sys, hinge, B, "chaotic", 5,
                                                                cuda)]
    got = fs.debug_substep_kernel(c, *ops)
    torch.cuda.synchronize()
    _assert_close_masked(got, fs.debug_substep_plain(c, *ops), ["qpos", "qvel", "wrench"], TOL)


@pytest.mark.cuda
def test_kernels_refuse_another_tree(cuda):
    """A table baked from another tree raises in both wrappers before any
    launch."""
    env = TenAntEnv(device=cuda)
    ops = _states(env, 2, 6, cuda)
    other = (-1, 0, 1, 0, 3, 0, 5, 0, 5)
    bad = dataclasses.replace(env.substep_consts, parent=other, _device_tables={})
    sys, hinge = env.spec.ant_sys, env.model.init_hinge
    c6 = debug_fused.kernel_consts(sys, True, clamp=False)
    bad6 = dataclasses.replace(c6, parent=other, _device_tables={})
    ops6 = [x.t().contiguous() for x in debug_fused.make_states(sys, hinge, 8, "chaotic", 0,
                                                                 cuda)]
    before = fs.substep_kernel.launches, fs.debug_substep_kernel.launches
    with pytest.raises(ValueError, match="tree"):
        fs.substep_kernel(bad, 10, *ops)
    with pytest.raises(ValueError, match="tree"):
        fs.debug_substep_kernel(bad6, *ops6)
    assert (fs.substep_kernel.launches, fs.debug_substep_kernel.launches) == before
