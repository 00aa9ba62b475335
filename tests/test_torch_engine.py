"""The port's array engine (phys/engine.py) against the JAX package's, one
function at a time, on the CPU.

Each function runs under jax.jit(jax.vmap(...)) on the JAX side and batched
on the port's side, on the same numpy inputs made from seeds:
* contact_box in both branches (the implicit effective-mass force with the
  box's inverse inertia, and the legacy explicit force), with contact
  points inside the box and just outside it;
* contact_plane in both branches;
* joint_limit_torque and joint_limit_spring, hinges inside and beyond
  their limits;
* forward_dynamics with the implicit damping and stiffness terms, free and
  with a welded base;
* sensor_forces with and without the points' positions;
* ancestor_mask and cholesky_solve_small.
Tolerance: rtol 1e-4 (tests/test_torch_phys.py's) with an absolute floor of
1e-4 of each output's scale, since the legacy contact forces reach 1e5 N
and their small components come out of cancellations.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from massive_marl_tpu.phys import engine as je
from massive_marl_tpu.phys import mjcf as jmjcf
from massive_marl_tpu_torch.phys import engine as pe
from massive_marl_tpu_torch.phys import mjcf as pmjcf

N = 8
HE = (0.5, 14.0, 0.5)
H = 0.0166 / 3
CP = je.ContactParams()
PCP = pe.ContactParams()


@pytest.fixture(scope="module")
def systems():
    return (jmjcf.parse_mjcf(jmjcf.asset_path("ant.xml")).system,
            pmjcf.parse_mjcf(pmjcf.asset_path("ant.xml")).system)


def close(got, ref, name=""):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * scale, err_msg=name)


def make_inputs(seed=1):
    """numpy f32 inputs: ant states around the push-box (points inside it and
    just outside it, feet on the ground, half the hinges beyond their
    limits), box states, torques, forces, implicit coefficients."""
    rng = np.random.default_rng(seed)
    base = np.array([0.5, -0.3, 0.5]) + rng.normal(0, 0.3, (N, 3)) * [1, 1, 0.4]
    tilt = rng.normal(0, 0.1, (N, 3))
    quat = np.concatenate([tilt, np.ones((N, 1))], 1)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    hinge = rng.uniform(-1.5, 1.5, (N, 8))
    yaw = rng.uniform(-0.2, 0.2, N)
    f32 = lambda x: np.asarray(x, np.float32)
    return dict(
        qpos=f32(np.concatenate([base, quat, hinge], 1)), qvel=f32(rng.normal(0, 0.5, (N, 14))),
        bq=f32(np.stack([np.full(N, 0.8), np.zeros(N), np.full(N, 0.45), np.zeros(N),
                         np.zeros(N), np.sin(yaw / 2), np.cos(yaw / 2)], 1)),
        bv=f32(rng.normal(0, 0.2, (N, 6))), tau=f32(rng.uniform(-15, 15, (N, 8))),
        f_ext=f32(rng.normal(0, 5, (N, 9, 6))), damp=f32(rng.uniform(0.5, 20, (N, 8))),
        stiff=f32(np.where(rng.random((N, 8)) < 0.5, 16000.0, 0.0)),
        f_w=f32(rng.normal(0, 10, (N, 37, 3))), box_I=f32(np.diag([2.0, 0.5, 2.0])),
        grav=f32([0.0, 0.0, -9.81]))


def T(x):
    return torch.from_numpy(np.asarray(x))


def engine_outputs(e, sys, d, fk, p_w, v_w, pi, inv3):
    """Every function under test, for one package (e = its engine module)."""
    box_inv = (1 / 28.0, inv3(d["box_I"]))
    out = {}
    for name, impl in (("implicit", True), ("legacy", False)):
        kw = dict(pi=pi, h=H) if impl else {}
        out["box_" + name] = e.contact_box(
            p_w, v_w, sys.point_radius, sys.point_friction * 0.5, d["bq"][..., 0:3],
            d["bq"][..., 3:7], d["bv"], HE, d["cp"], box_inv=box_inv if impl else None, **kw)
        out["plane_" + name] = e.contact_plane(p_w, v_w, sys.point_radius, sys.point_friction,
                                               d["cp"], **kw)
    out["limit_torque"] = e.joint_limit_torque(sys, d["qpos"], d["qvel"])
    out["limit_spring"] = e.joint_limit_spring(sys, d["qpos"])
    out["limit_spring_range"] = e.joint_limit_spring(sys.jnt_range, d["qpos"], k=100.0, damp=3.0)
    for fixed in (False, True):
        out[f"qacc_fixed_{fixed}"] = e.forward_dynamics(
            sys, fk, d["qvel"], d["tau"], d["f_ext_list"], d["grav"], fixed_base=fixed,
            imp_damping=d["damp"], h=H, imp_stiffness=d["stiff"])
    out["sensors_moment"] = e.sensor_forces(sys, d["f_w"], fk, p_w)
    out["sensors_force_only"] = e.sensor_forces(sys, d["f_w"], fk)
    return out


@pytest.fixture(scope="module")
def outputs(systems):
    """(port outputs, JAX outputs, port points) from make_inputs()."""
    jsys, psys = systems
    raw = make_inputs()

    def jf(d):
        fk = je.fwd_kinematics(jsys, d["qpos"], d["qvel"])
        p_w, v_w, _ = je.points_world(jsys, fk)
        d = dict(d, cp=CP, f_ext_list=[d["f_ext"][i] for i in range(9)])
        return engine_outputs(je, jsys, d, fk, p_w, v_w, je.point_inertia(jsys, fk, p_w),
                              lambda I: je._inv3x3_sym(jnp.asarray(I)))

    shared = ("box_I", "grav")
    axes = {k: (None if k in shared else 0) for k in raw}
    ref = jax.jit(jax.vmap(jf, in_axes=(axes,)))(raw)
    d = {k: T(v) for k, v in raw.items()}
    d.update(cp=PCP, f_ext_list=[d["f_ext"][:, i] for i in range(9)])
    fk = pe.fwd_kinematics(psys, d["qpos"], d["qvel"])
    p_w, v_w = pe.points_world(psys, fk)
    got = engine_outputs(pe, psys, d, fk, p_w, v_w, pe.point_inertia(psys, fk, p_w),
                         pe._inv3x3_sym)
    return got, ref, (d, p_w)


@pytest.mark.parametrize("implicit", [True, False], ids=["implicit", "legacy"])
def test_contact_box_matches_jax(outputs, implicit):
    got, ref, (d, p_w) = outputs
    # the points really sit inside the box and just outside it
    R = pe.quat_to_matrix(d["bq"][:, 3:7])[:, None]
    local = torch.sum(R * (p_w - d["bq"][:, None, 0:3])[..., :, None], dim=-2)
    he = torch.tensor(HE)
    out = (local.abs() - he).clamp(min=0).norm(dim=-1)
    radius = pmjcf.parse_mjcf(pmjcf.asset_path("ant.xml")).system.point_radius
    assert int((local.abs() < he).all(-1).sum()) > 0
    assert int(((out > 0) & (out < radius)).sum()) > 0
    key = "box_" + ("implicit" if implicit else "legacy")
    assert float(np.abs(np.asarray(ref[key][0])).max()) > 1.0   # real contact forces
    close(got[key][0], ref[key][0], "force")
    close(got[key][1], ref[key][1], "wrench")


@pytest.mark.parametrize("implicit", [True, False], ids=["implicit", "legacy"])
def test_contact_plane_matches_jax(outputs, implicit):
    got, ref, _ = outputs
    key = "plane_" + ("implicit" if implicit else "legacy")
    assert float(np.abs(np.asarray(ref[key])).max()) > 1.0       # feet on the ground
    close(got[key], ref[key], "force")


def test_joint_limits_match_jax(outputs, systems):
    got, ref, (d, _) = outputs
    lo, hi = systems[1].jnt_range.T
    viol = (d["qpos"][:, 7:] < lo) | (d["qpos"][:, 7:] > hi)
    assert 0 < int(viol.sum()) < viol.numel()
    close(got["limit_torque"], ref["limit_torque"], "torque")
    for key in ("limit_spring", "limit_spring_range"):
        for name, g, r in zip(("spring", "damping", "stiffness"), got[key], ref[key]):
            close(g, r, f"{key} {name}")


@pytest.mark.parametrize("fixed_base", [False, True], ids=["free", "fixed_base"])
def test_forward_dynamics_implicit_terms_match_jax(outputs, fixed_base):
    got, ref, _ = outputs
    key = f"qacc_fixed_{fixed_base}"
    if fixed_base:
        assert (got[key][:, :6] == 0).all()
    close(got[key], ref[key], "qacc")


@pytest.mark.parametrize("with_points", [True, False], ids=["moment", "force_only"])
def test_sensor_forces_match_jax(outputs, with_points):
    got, ref, _ = outputs
    key = "sensors_moment" if with_points else "sensors_force_only"
    assert got[key].shape == (N, 4, 6)
    if not with_points:
        assert (got[key][..., 3:] == 0).all()
    close(got[key], ref[key], "sensors")


def test_ancestor_mask_and_dense_cholesky_match_jax(systems):
    jsys, psys = systems
    np.testing.assert_array_equal(pe.ancestor_mask(psys), je.ancestor_mask(jsys))
    rng = np.random.default_rng(8)
    A = rng.normal(0, 1, (N, 14, 14)).astype(np.float32)
    M = (A @ A.transpose(0, 2, 1) + 14 * np.eye(14)).astype(np.float32)
    rhs = rng.normal(0, 1, (N, 14)).astype(np.float32)
    ref = jax.vmap(je.cholesky_solve_small)(M, rhs)
    got = pe.cholesky_solve_small(T(M), T(rhs))
    close(got, ref, "x")
    np.testing.assert_allclose(got.numpy(), np.linalg.solve(M.astype(np.float64),
                                                            rhs[..., None])[..., 0],
                               rtol=1e-3, atol=1e-4)
