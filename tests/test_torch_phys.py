"""The port's physics against the JAX package on the CPU.

* parse_mjcf gives the same System arrays in both packages;
* the port's plain substep (the kernel's plain PyTorch version) agrees with
  the JAX scalar substep, called eagerly (the jitted scalar graph takes
  XLA:CPU tens of minutes to compile), over four state families: feet in
  ground contact, points inside and just outside the push-box, hinges
  beyond their limits, and no box;
* the port's fused_scene_step (plain path on the CPU) agrees with
  jax.vmap(scene_step) over one control step with ants against the box.
Inputs are made with numpy from fixed seeds and handed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from massive_marl_tpu.envs import ant_scene as j_scene
from massive_marl_tpu.envs.ten_ant import TenAntEnv as JTenAnt
from massive_marl_tpu.ops import scalar_phys as j_sp
from massive_marl_tpu.phys import engine as j_engine
from massive_marl_tpu.phys import mjcf as j_mjcf
from massive_marl_tpu_torch.envs.ant_scene import AntSceneState
from massive_marl_tpu_torch.envs.ten_ant import TenAntEnv as PTenAnt
from massive_marl_tpu_torch.ops import fused_substep as p_fs
from massive_marl_tpu_torch.ops import scalar_phys as p_sp
from massive_marl_tpu_torch.phys import engine as p_engine
from massive_marl_tpu_torch.phys import mjcf as p_mjcf
from massive_marl_tpu_torch.utils.bridge import system_arrays

GRAV = (0.0, 0.0, -9.81)
CP = j_engine.ContactParams()
BOX_HE = (0.5, 14.0, 0.5)
H = 0.0166 / 3
B = 24


@pytest.fixture(scope="module")
def models():
    return (j_mjcf.parse_mjcf(j_mjcf.asset_path("ant.xml")),
            p_mjcf.parse_mjcf(p_mjcf.asset_path("ant.xml")))


def test_parse_mjcf_system_arrays_match(models):
    jm, pm = models
    ja, pa = system_arrays(jm.system), system_arrays(pm.system)
    assert (pm.system.nb, pm.system.nj, pm.system.np_points, pm.system.num_sensors) == (9, 8, 37, 4)
    assert ja.keys() == pa.keys()
    for k in ja:
        assert ja[k].shape == pa[k].shape, k
        np.testing.assert_allclose(pa[k], ja[k], rtol=1e-6, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(pm.init_hinge, jm.init_hinge)
    np.testing.assert_array_equal(pm.gear_dof, jm.gear_dof)


def _box_inv():
    m = 8.0 * BOX_HE[0] * BOX_HE[1] * BOX_HE[2]
    I = np.diag([m / 3.0 * (BOX_HE[1] ** 2 + BOX_HE[2] ** 2),
                 m / 3.0 * (BOX_HE[0] ** 2 + BOX_HE[2] ** 2),
                 m / 3.0 * (BOX_HE[0] ** 2 + BOX_HE[1] ** 2)]).astype(np.float32)
    return 1.0 / m, np.linalg.inv(I.astype(np.float64))


def make_family(kind, n, seed, jsys):
    """numpy float32 states of one family: qpos [n,15], qvel [n,14],
    tau [n,8], box_qpos [n,7], box_qvel [n,6]."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(jsys.jnt_range[:, 0]), np.asarray(jsys.jnt_range[:, 1])
    hinge0 = np.clip(0.0, lo, hi)
    tilt = rng.normal(0, 0.08, (n, 3))
    quat = np.concatenate([tilt, np.ones((n, 1))], 1)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    base = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n), rng.uniform(0.45, 0.62, n)], 1)
    hinge = hinge0 + rng.uniform(-0.3, 0.3, (n, 8))
    box_qpos = np.tile([50.0, 0.0, 0.5, 0.0, 0.0, 0.0, 1.0], (n, 1))
    if kind == "box":
        base = np.array([0.5, -0.3, 0.55]) + rng.normal(0, 0.3, (n, 3))
        yaw = rng.uniform(-0.2, 0.2, n)
        box_qpos = np.stack([np.full(n, 0.8), np.zeros(n), np.full(n, 0.45), np.zeros(n),
                             np.zeros(n), np.sin(yaw / 2), np.cos(yaw / 2)], 1)
    elif kind == "limits":
        beyond = rng.uniform(0.02, 0.2, (n, 8))
        hinge = np.where(rng.random((n, 8)) < 0.5, lo - beyond, hi + beyond)
    qpos = np.concatenate([base, quat, hinge], 1).astype(np.float32)
    qvel = rng.normal(0, 0.5, (n, 14)).astype(np.float32)
    tau = rng.uniform(-15, 15, (n, 8)).astype(np.float32)
    box_qvel = rng.normal(0, 0.2, (n, 6)).astype(np.float32)
    return qpos, qvel, tau, box_qpos.astype(np.float32), box_qvel


FAMILIES = [("ground", True), ("box", True), ("limits", True), ("nobox", False)]


@pytest.mark.parametrize("kind,has_box", FAMILIES)
def test_plain_substep_matches_jax_scalar(models, kind, has_box):
    jm, pm = models
    qpos, qvel, tau, bq, bv = make_family(kind, B, 7 + len(kind), jm.system)
    if kind == "box":
        # the family really has points inside and just outside the box
        p_w, _ = p_engine.points_world(pm.system, p_engine.fwd_kinematics(
            pm.system, torch.from_numpy(qpos), torch.from_numpy(qvel)))
        rel = p_w - torch.from_numpy(bq[:, None, 0:3])
        inside = (rel.abs() < torch.tensor(BOX_HE)).all(-1)
        assert 0 < int(inside.sum()) < inside.numel()
    bm_inv, bI_inv = _box_inv()
    he = BOX_HE if has_box else None
    jl = lambda x: [jnp.asarray(x[:, k]) for k in range(x.shape[1])]
    j_out = j_sp.substep(
        j_sp.bake_consts(jm.system), jl(qpos), jl(qvel), jl(tau),
        jl(bq) if has_box else None, jl(bv) if has_box else None, he, GRAV, H,
        CP.stiffness, CP.damping, CP.friction_vel, plane_friction=1.0, box_friction=0.0,
        friction_combine="average", beta=CP.beta, max_depen_vel=CP.max_depen_vel,
        acc_units=True, hc_vel=CP.hc_vel, hc_cap=CP.hc_cap,
        box_inv=(bm_inv, bI_inv.tolist()) if has_box else None)
    params = p_sp.SubstepParams(h=H, gravity=GRAV, contact=p_engine.ContactParams(),
                                plane_friction=1.0, box_friction=0.0,
                                friction_combine="average", box_he=he,
                                box_inv=(bm_inv, bI_inv) if has_box else None)
    pl = lambda x: list(torch.from_numpy(np.ascontiguousarray(x.T)))
    p_out = p_sp.substep(p_sp.bake_consts(pm.system, params), pl(qpos), pl(qvel), pl(tau),
                         pl(bq) if has_box else None, pl(bv) if has_box else None)

    def st(xs):
        return np.stack([np.asarray(x) for x in xs])

    names = ["qpos", "qvel", "wrench", "sensors"]
    for name, j, p in zip(names, j_out, p_out):
        if name == "wrench" and not has_box:
            assert j is None and p is None
            continue
        if name == "sensors":
            j, p = [x for s in j for x in s], [x for s in p for x in s]
        j, p = st(j), st([x.numpy() for x in p])
        assert np.isfinite(p).all(), name
        np.testing.assert_allclose(p, j, rtol=1e-4, atol=1e-4, err_msg=f"{kind}: {name}")


@pytest.fixture(scope="module")
def scene_pair():
    cfg = {"sim": {"substeps": 2}}
    return JTenAnt(cfg), PTenAnt(cfg, device="cpu")


def test_fused_scene_step_matches_vmapped_jax(scene_pair):
    jenv, penv = scene_pair
    E = 2
    keys = jax.random.split(jax.random.PRNGKey(3), E)
    st = jax.vmap(jenv._fresh_pipeline)(keys)
    rng = np.random.default_rng(11)
    aq = np.array(st.ant_qpos)
    # ants of env 0 pressed against the box's +x face (the box spans
    # x in [3.5, 4.5]), with their torsos at varied heights
    aq[0, :, 0] = 4.5 + rng.uniform(0.05, 0.45, 10)
    aq[0, :, 2] = rng.uniform(0.5, 0.8, 10)
    aq[1, :, 2] = rng.uniform(0.4, 0.6, 10)
    av = rng.normal(0, 0.3, aq.shape[:2] + (14,)).astype(np.float32)
    av[0, :, 0] = -1.0  # moving into the box
    st = st.replace(ant_qpos=jnp.asarray(aq), ant_qvel=jnp.asarray(av))
    actions = rng.uniform(-1, 1, (E, 10, 8)).astype(np.float32)

    ref = jax.jit(jax.vmap(lambda s, a: j_scene.scene_step(jenv.spec, s, a)))(
        st, jnp.asarray(actions))
    t = lambda x: torch.from_numpy(np.array(x))
    pst = AntSceneState(ant_qpos=t(st.ant_qpos), ant_qvel=t(st.ant_qvel),
                        box_qpos=t(st.box_qpos), box_qvel=t(st.box_qvel),
                        sensors=t(st.sensors), dr_count=t(st.dr_count), frame=t(st.frame))
    got = p_fs.fused_scene_step(penv.spec, pst, torch.from_numpy(actions),
                                penv.substep_consts)
    assert float(np.abs(np.asarray(ref.box_qvel)[0]).max()) > 1e-3  # the box was pushed
    tol = {"ant_qpos": (2e-4, 2e-4), "box_qpos": (2e-4, 2e-4), "ant_qvel": (5e-3, 5e-3),
           "box_qvel": (5e-3, 5e-3), "sensors": (5e-3, 5e-2)}
    for name, (rtol, atol) in tol.items():
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=rtol, atol=atol, err_msg=name)
    np.testing.assert_array_equal(got.frame.numpy(), np.asarray(ref.frame))
