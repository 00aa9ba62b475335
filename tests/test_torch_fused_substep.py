"""The substep kernel's wrapper and its device rule.

CPU tests: a CPU tensor takes the plain version and never touches the
launch counter; the kernel wrapper refuses CPU tensors; entry points raise
when CUDA is absent and the caller did not ask for the CPU.

Tests marked `cuda` hold the kernel against its plain version on the card
and skip without one.  They import nothing of JAX, so on the GPU host they
run without the repository's JAX conftest:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fused_substep.py -m cuda
"""
import pathlib
import re

import numpy as np
import pytest
import torch

import massive_marl_tpu_torch
from massive_marl_tpu_torch.envs.ten_ant import TenAntEnv
from massive_marl_tpu_torch.ops import fused_substep as fs
from massive_marl_tpu_torch.ops import scalar_phys as sp
from massive_marl_tpu_torch.phys import mjcf


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
        fs.substep_kernel(c.table, c.P, 10, *ops)


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


@pytest.mark.cuda
@pytest.mark.parametrize("has_box", [True, False])
def test_kernel_matches_plain_on_card(cuda, has_box):
    env = TenAntEnv(device=cuda)
    spec = env.spec if has_box else env.spec._replace(box_sys=None, box_half_extents=None)
    c = fs.scene_consts(spec)
    ops = _states(env, 24, 1, cuda)
    before = fs.substep_kernel.launches
    got = fs.substep_kernel(c.device_table(cuda), c.P, 10, *ops)
    torch.cuda.synchronize()
    assert fs.substep_kernel.launches == before + 1
    ref = fs.substep_plain(c, 10, *ops)
    tol = [(2e-4, 2e-4), (5e-3, 5e-3), (5e-3, 5e-2), (5e-3, 5e-2)]
    for name, g, r, (rtol, atol) in zip(["qpos", "qvel", "wrench", "sensors"], got, ref, tol):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(), rtol=rtol, atol=atol,
                                   err_msg=name)


@pytest.mark.cuda
def test_kernel_rejects_bad_operands(cuda):
    env = TenAntEnv(device=cuda)
    c = env.substep_consts
    qpos, qvel, tau, bq, bv = _states(env, 4, 2, cuda)
    with pytest.raises(ValueError, match="qvel"):
        fs.substep_kernel(c.device_table(cuda), c.P, 10, qpos, qvel[:, :-1], tau, bq, bv)
    with pytest.raises(ValueError, match="P="):
        fs.substep_kernel(c.device_table(cuda), c.P + 1, 10, qpos, qvel, tau, bq, bv)
