"""The push-box kernel (csrc/substep.cu's box_body_step, launched through
fused_substep.BoxSubstepKernel) and its dispatch in fused_scene_step.

CPU tests: the wrapper refuses what the kernel does not take before it
loads any library; a CPU tensor takes the wrench sum and the plain
envs/ant_scene.box_substep and leaves `launches` as it was; the source's
table offsets are BOX_LAYOUT's; the profiler's name for the kernel falls in
no other kernel's group.

Tests marked `cuda` hold the kernel bit for bit to the plain box_substep on
the card, which it follows operation for operation in torch's own rounding
order, at E = 4,096 over five families of box states (at rest on a face,
sliding, tilted on an edge, airborne, pressed deep enough that the
depenetration cap binds), each with no ant wrench and with a large random
one, under four contact settings on TenAnt (the scene's default,
cfg/TenAnt.yaml's, kn a Python float with force units, a capped hc factor)
and OneAnt's (one ant, a 1 x 1 x 1 box); and 24 substeps of
fused_scene_step on both tasks against the same loop with the plain box
step fed the same B1 outputs.  They import nothing of JAX, so on the GPU host they run
without the repository's JAX conftest:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_box_kernel.py -m cuda
"""
import pathlib
import re

import pytest
import torch

from massive_marl_tpu_torch.envs.ant_scene import box_substep
from massive_marl_tpu_torch.envs.one_ant import OneAntEnv
from massive_marl_tpu_torch.envs.ten_ant import TenAntEnv
from massive_marl_tpu_torch.ops import fused_substep as fs

SOURCE = pathlib.Path(fs.__file__).parent / "csrc" / "substep.cu"
TASKS = {"TenAnt": TenAntEnv, "OneAnt": OneAntEnv}
CONTACTS = {
    "default": {},
    "yaml": {"stiffness": 2500.0, "damping": 25.0, "friction_vel": 0.3},
    "python_kn_force_units": {"hc_vel": 0.0, "acc_units": False},
    "hc_capped": {"hc_vel": 0.8, "hc_cap": 1.5, "max_depen_vel": 2.0},
}
FAMILIES = ("rest", "sliding", "edge", "airborne", "deep")


@pytest.fixture(scope="module")
def env_cpu():
    return TenAntEnv(device="cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _box_states(family, E, seed):
    """[E, 7], [E, 6] box states of one family (the box is 1 x 28 x 1, its
    corners of radius 0)."""
    g = torch.Generator().manual_seed(seed)
    u = lambda *s: torch.rand(*s, generator=g)
    yaw = (u(E) * 2 - 1) * 3.14159
    quat = torch.stack([torch.zeros(E), torch.zeros(E), torch.sin(yaw / 2), torch.cos(yaw / 2)], 1)
    pos = torch.stack([u(E) * 8 - 4, u(E) * 8 - 4, torch.full((E,), 0.5)], 1)
    vel = (u(E, 6) * 2 - 1) * 0.05
    if family == "rest":
        pos[:, 2] = 0.5 - 0.002 * u(E)
    elif family == "sliding":
        pos[:, 2] = 0.499
        vel[:, 0:2] = (u(E, 2) * 2 - 1) * 3.0
    elif family == "edge":
        tilt = 0.2 + 0.4 * u(E)   # the yaw, then a tilt about the long (y) axis
        st, ct, sy, cy = (f(x / 2) for x in (tilt, yaw) for f in (torch.sin, torch.cos))
        quat = torch.stack([-sy * st, cy * st, sy * ct, cy * ct], 1)
        pos[:, 2] = 0.5 * torch.cos(tilt) + 0.5 * torch.sin(tilt) - 0.003 * u(E)
        vel[:, 3:6] = (u(E, 3) * 2 - 1) * 2.0
    elif family == "airborne":
        pos[:, 2] = 2.0 + 3 * u(E)
        quat = torch.nn.functional.normalize(torch.randn(E, 4, generator=g), dim=1)
        vel = (u(E, 6) * 2 - 1) * torch.tensor([5.0, 5.0, 5.0, 70.0, 70.0, 70.0])
    elif family == "deep":
        pos[:, 2] = 0.2 + 0.15 * u(E)
        vel[:, 2] = -2.0 * u(E)
    return torch.cat([pos, quat], 1), vel


def _wrench(E, A, seed, large):
    if not large:
        return torch.zeros(6, E * A)
    g = torch.Generator().manual_seed(seed)
    return torch.randn(6, E * A, generator=g) * torch.tensor([2000.0] * 3 + [500.0] * 3)[:, None]


def _plain(spec, bq, bv, wrench, h):
    E = bq.shape[0]
    return box_substep(spec, bq, bv, wrench.reshape(6, E, spec.num_ants).sum(-1).t(), h)


def _spec(env, contact):
    return env.spec._replace(contact=env.spec.contact._replace(**CONTACTS[contact]))


# ---------------------------------------------------------------- CPU


def test_cpu_tensors_take_the_plain_box_substep(env_cpu):
    spec, E, h = env_cpu.spec, 4, env_cpu.spec.dt / env_cpu.spec.substeps
    bq, bv = _box_states("sliding", E, 0)
    wrench = _wrench(E, 10, 1, True)
    before = fs.box_substep_kernel.launches
    got = fs.box_substep_soa(spec, bq, bv, wrench, h)
    want = _plain(spec, bq, bv, wrench, h)
    assert fs.box_substep_kernel.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("bad", ["cpu", "dtype", "shape", "stride", "wrench", "ants"])
def test_wrapper_refuses_before_loading(env_cpu, monkeypatch, bad):
    def no_load():
        raise AssertionError("loaded the library")

    monkeypatch.setattr(fs.substep_kernel, "load", no_load)
    spec, E = env_cpu.spec, 4
    bq, bv = _box_states("rest", E, 2)
    wrench = _wrench(E, 10, 3, True)
    if bad == "dtype":
        bv = bv.double()
    elif bad == "shape":
        bq = bq[:, :6].contiguous()
    elif bad == "stride":
        bq = bq.t().contiguous().t()
    elif bad == "wrench":
        wrench = wrench[:, :-1].contiguous()
    elif bad == "ants":
        spec, wrench = spec._replace(num_ants=4), _wrench(E, 4, 3, True)
    match = {"cpu": "CUDA", "ants": "ants"}.get(bad, "contiguous float32")
    before = fs.box_substep_kernel.launches
    with pytest.raises(ValueError, match=match):
        fs.box_substep_kernel(spec, bq, bv, wrench, 0.005)
    assert fs.box_substep_kernel.launches == before


def test_box_table_offsets_match_the_source(env_cpu):
    """Each X_<FIELD> offset in csrc/substep.cu is <field>'s position in
    BOX_LAYOUT; the table has BOX_TABLE_LEN floats and bakes the doubles."""
    src = SOURCE.read_text()
    cu = {"BOX_PTS": int(re.search(r"constexpr int BOX_PTS = (\d+);", src).group(1))}
    for name, expr in re.findall(r"constexpr int (X_\w+|BOX_TABLE_LEN) = ([^;]+);", src):
        cu[name] = eval(expr, {}, dict(cu))
    off, py = 0, {}
    for name, n in fs.BOX_LAYOUT:
        py["X_" + name.upper()] = off
        off += n
    assert {k: cu[k] for k in py} == py and cu["BOX_TABLE_LEN"] == off
    assert cu["BOX_PTS"] == fs.BOX_POINTS
    ants = re.search(r"constexpr int BOX_ANTS_ONE = (\d+), BOX_ANTS_TEN = (\d+);", src)
    assert tuple(int(a) for a in ants.groups()) == fs.BOX_ANTS
    spec, h = env_cpu.spec, env_cpu.spec.dt / env_cpu.spec.substeps
    table = fs.box_table(spec, h, "cpu")
    at = dict(zip((k[2:].lower() for k in py), py.values()))
    assert table.numel() == off and table.dtype == torch.float32
    cp = spec.contact
    assert table[at["kh"]] == torch.tensor(cp.stiffness * h + cp.damping, dtype=torch.float32)
    assert table[at["inv_mass"]] == torch.tensor(1.0) / spec.box_sys.mass[0]


def test_profiler_name_falls_in_no_kernel_group():
    """port_bench's breakdown counts the box kernel as `other`: not in B1's
    group, whose mean time a launch kernel.b1_roofline reads."""
    from port_bench import trace
    shown = ("void (anonymous namespace)::box_body_step<10>(float const*, int, float const*, "
             "float const*, float const*, float*, float*)")
    assert "__global__ void __launch_bounds__(BOX_THREADS)\nbox_body_step(" in SOURCE.read_text()
    assert trace.kernel_group(shown) == "other"


# ---------------------------------------------------------------- card


@pytest.mark.cuda
@pytest.mark.parametrize("task,contact", [("TenAnt", c) for c in sorted(CONTACTS)]
                         + [("OneAnt", "default")])
def test_kernel_matches_plain_on_card(cuda, task, contact):
    env = TASKS[task](device=cuda)
    spec, E, h = _spec(env, contact), 4096, env.spec.dt / env.spec.substeps
    for k, family in enumerate(FAMILIES):
        bq, bv = (x.to(cuda) for x in _box_states(family, E, 10 + k))
        for large in (False, True):
            wrench = _wrench(E, spec.num_ants, 20 + k, large).to(cuda)
            before = fs.box_substep_kernel.launches
            got = fs.box_substep_kernel(spec, bq, bv, wrench, h)
            assert fs.box_substep_kernel.launches == before + 1
            want = _plain(spec, bq, bv, wrench, h)
            torch.cuda.synchronize()
            for name, a, b in zip(("qpos", "qvel"), got, want):
                assert torch.isfinite(b).all(), (family, large)
                bad = (a != b).any(1).nonzero()[:, 0]
                assert bad.numel() == 0, (contact, family, large, name, bad.numel(),
                                          a[bad[:2]].tolist(), b[bad[:2]].tolist())


@pytest.mark.cuda
def test_deep_family_binds_the_depenetration_cap(cuda):
    """In the deep family the plain contact force sits at the cap
    max(max_depen_vel - vn, 0) / (w_n h) on some corner of most envs."""
    from massive_marl_tpu_torch.phys import engine
    env = TenAntEnv(device=cuda)
    spec, E, h = env.spec, 4096, env.spec.dt / env.spec.substeps
    bq, bv = (x.to(cuda) for x in _box_states("deep", E, 14))
    bsys, cp = spec.box_sys, spec.contact
    fk = engine.fwd_kinematics(bsys, bq, bv)
    p, v = engine.points_world(bsys, fk)
    pi = engine.point_inertia(bsys, fk, p)
    fz = engine.contact_plane(p, v, bsys.point_radius, 0.0, cp, pi=pi, h=h)[..., 2]
    uncapped = engine.contact_plane(p, v, bsys.point_radius, 0.0, cp._replace(max_depen_vel=1e9),
                                    pi=pi, h=h)[..., 2]
    assert ((fz < uncapped).any(1).float().mean() > 0.5).item()


@pytest.mark.cuda
@pytest.mark.parametrize("task", sorted(TASKS))
def test_fused_scene_step_matches_the_plain_box_path(cuda, monkeypatch, task):
    env = TASKS[task](device=cuda)
    E, A = 4096, env.spec.num_ants
    s0 = env.reset(E).pipeline
    g = torch.Generator(device=cuda).manual_seed(5)
    actions = [torch.rand(E, A, 8, generator=g, device=cuda) * 2 - 1 for _ in range(8)]
    before = fs.box_substep_kernel.launches
    s = s0
    for a in actions:
        s = fs.fused_scene_step(env.spec, s, a, env.substep_consts)
    assert fs.box_substep_kernel.launches == before + 8 * env.spec.substeps

    monkeypatch.setattr(fs, "box_substep_kernel", _plain)
    r = s0
    for a in actions:
        r = fs.fused_scene_step(env.spec, r, a, env.substep_consts)
    torch.cuda.synchronize()
    for name in ("ant_qpos", "ant_qvel", "box_qpos", "box_qvel", "sensors"):
        assert torch.equal(getattr(s, name), getattr(r, name)), name
