"""B1's domain-randomization operand and the randomized physics paths
against the JAX package on the CPU.

* The port's plain substep with `dr=` (the plain version of B1's DR
  instantiation) against JAX's scalar substep with `dr=`, called eagerly
  (never jitted: XLA:CPU takes tens of minutes on the scalar graph), over
  tests/test_torch_phys.py's four state families and both contact
  branches.  Every parameter group is away from nominal: mass, damping and
  armature scaled by U[0.5, 2], the joint limits moved by N(0, 0.05).
  Tolerance 1e-4 (tests/test_torch_phys.py's); on the legacy branch
  relative to each output's scale with the same non-finite mask
  (tests/test_torch_legacy_substep.py's).
* The array path's scene_step with one DrSample against JAX's
  jax.vmap(scene_step) with the same sample, in one jitted JAX call;
  fused_scene_step on the CPU (the DR plain version) against the port's
  scene_step with that sample.  Control-step tolerances of
  tests/test_torch_phys.py.
* The DR operand: its packing, and substep_soa's dispatch of CPU tensors
  to the plain version.
The samples are drawn with numpy from fixed seeds and handed to both
packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from massive_marl_tpu.envs import ant_scene as j_scene
from massive_marl_tpu.envs.ten_ant import TenAntEnv as JTenAnt
from massive_marl_tpu.ops import scalar_phys as j_sp
from massive_marl_tpu.phys import dr as j_dr
from massive_marl_tpu.phys import mjcf as j_mjcf
from massive_marl_tpu_torch.envs import ant_scene as p_scene
from massive_marl_tpu_torch.envs.ten_ant import TenAntEnv as PTenAnt
from massive_marl_tpu_torch.ops import fused_substep as p_fs
from massive_marl_tpu_torch.ops import scalar_phys as p_sp
from massive_marl_tpu_torch.phys import dr as p_dr
from massive_marl_tpu_torch.phys import engine as p_engine
from massive_marl_tpu_torch.phys import mjcf as p_mjcf
from test_torch_legacy_substep import assert_close_to_scale
from test_torch_phys import BOX_HE, CP, FAMILIES, GRAV, H, _box_inv, make_family

B = 24
FIELDS = ("mass", "damping", "armature", "jnt_lo", "jnt_hi")
SCENE_TOL = {"ant_qpos": (2e-4, 2e-4), "box_qpos": (2e-4, 2e-4), "ant_qvel": (5e-3, 5e-3),
             "box_qvel": (5e-3, 5e-3), "sensors": (5e-3, 5e-2)}


@pytest.fixture(scope="module")
def models():
    return (j_mjcf.parse_mjcf(j_mjcf.asset_path("ant.xml")),
            p_mjcf.parse_mjcf(p_mjcf.asset_path("ant.xml")))


def dr_values(sys, shape, seed):
    """{field: float32 [*shape, n]} away from the nominal values."""
    rng = np.random.default_rng(seed)
    nom = {"mass": np.asarray(sys.mass), "damping": np.asarray(sys.damping),
           "armature": np.asarray(sys.armature), "jnt_lo": np.asarray(sys.jnt_range)[:, 0],
           "jnt_hi": np.asarray(sys.jnt_range)[:, 1]}
    out = {}
    for name, v in nom.items():
        size = tuple(shape) + v.shape
        if name.startswith("jnt"):
            out[name] = (v + rng.normal(0, 0.05, size)).astype(np.float32)
        else:
            out[name] = (v * rng.uniform(0.5, 2.0, size)).astype(np.float32)
    return out


@pytest.mark.parametrize("legacy", [False, True], ids=["implicit", "legacy"])
@pytest.mark.parametrize("kind,has_box", FAMILIES)
def test_plain_dr_substep_matches_jax_scalar(models, kind, has_box, legacy):
    jm, pm = models
    qpos, qvel, tau, bq, bv = make_family(kind, B, 31 + len(kind), jm.system)
    drv = dr_values(jm.system, (B,), 5 + len(kind) + 10 * legacy)
    bm_inv, bI_inv = _box_inv()
    he = BOX_HE if has_box else None
    beta = None if legacy else CP.beta
    jl = lambda x: [jnp.asarray(x[:, k]) for k in range(x.shape[1])]
    j_out = j_sp.substep(
        j_sp.bake_consts(jm.system), jl(qpos), jl(qvel), jl(tau),
        jl(bq) if has_box else None, jl(bv) if has_box else None, he, GRAV, H,
        CP.stiffness, CP.damping, CP.friction_vel, plane_friction=1.0, box_friction=0.0,
        friction_combine="average", beta=beta, max_depen_vel=CP.max_depen_vel,
        acc_units=True, hc_vel=CP.hc_vel, hc_cap=CP.hc_cap,
        box_inv=(bm_inv, bI_inv.tolist()) if has_box else None,
        dr={k: jl(v) for k, v in drv.items()})
    params = p_sp.SubstepParams(h=H, gravity=GRAV, contact=CP._replace(beta=beta),
                                plane_friction=1.0, box_friction=0.0,
                                friction_combine="average", box_he=he,
                                box_inv=(bm_inv, bI_inv) if has_box else None)
    c = p_sp.bake_consts(pm.system, params)
    assert c.legacy == legacy
    pl = lambda x: list(torch.from_numpy(np.ascontiguousarray(x.T)))
    p_out = p_sp.substep(c, pl(qpos), pl(qvel), pl(tau), pl(bq) if has_box else None,
                         pl(bv) if has_box else None, dr={k: pl(v) for k, v in drv.items()})
    # the parameters matter: the nominal substep lands elsewhere
    nominal = p_sp.substep(c, pl(qpos), pl(qvel), pl(tau), pl(bq) if has_box else None,
                           pl(bv) if has_box else None)
    moved = torch.stack(nominal[1]) - torch.stack(p_out[1])
    assert float(moved[torch.isfinite(moved)].abs().max()) > 1e-3

    st = lambda xs: np.stack([np.asarray(x) for x in xs])
    for name, j, p in zip(["qpos", "qvel", "wrench", "sensors"], j_out, p_out):
        if name == "wrench" and not has_box:
            assert j is None and p is None
            continue
        if name == "sensors":
            j, p = [x for s in j for x in s], [x for s in p for x in s]
        j, p = st(j), st([x.numpy() for x in p])
        if legacy:
            assert_close_to_scale(p, j, f"{kind}: {name}")
        else:
            assert np.isfinite(p).all(), name
            np.testing.assert_allclose(p, j, rtol=1e-4, atol=1e-4, err_msg=f"{kind}: {name}")


def test_dr_operand_layout_and_cpu_dispatch(models):
    """pack_dr/unpack_dr round-trip in DR_LAYOUT's order, and a CPU tensor
    with a DR operand takes the plain version without a launch."""
    _, pm = models
    sys = pm.system
    d = p_dr.DrSample(**{k: torch.from_numpy(v) for k, v in dr_values(sys, (2, 3), 1).items()})
    packed = p_fs.pack_dr(d)
    assert packed.shape == (p_fs.DR_LEN, 6) == (41, 6) and packed.is_contiguous()
    rows = p_fs.unpack_dr(packed)
    for name in FIELDS:
        np.testing.assert_array_equal(torch.stack(rows[name]).t().numpy(),
                                      getattr(d, name).reshape(6, -1).numpy())
    env = PTenAnt(device="cpu")
    ops = [torch.zeros(n, 6) for n in (15, 14, 8)] + [torch.zeros(7, 1), torch.zeros(6, 1)]
    ops[0][6] = ops[3][6] = 1.0
    ops[0][2] = 2.0
    before = p_fs.substep_kernel.launches, p_fs.substep_kernel.dr_launches
    got = p_fs.substep_soa(env.substep_consts, 6, *ops, dr=packed)
    ref = p_fs.substep_plain(env.substep_consts, 6, *ops, dr=packed)
    assert (p_fs.substep_kernel.launches, p_fs.substep_kernel.dr_launches) == before
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.fixture(scope="module")
def dr_scene():
    """(JAX env, port env, JAX state, port state, actions [E,10,8]) with one
    DrSample per ant and ants against the push-box."""
    cfg = {"sim": {"substeps": 2}, "task": {"randomize": True, "randomization_params": {
        "actor_params": {"ant": {"rigid_body_properties": {"mass": {"range": [0.5, 1.5]}}}}}}}
    jenv, penv = JTenAnt(cfg), PTenAnt(cfg, device="cpu")
    assert jenv.spec.dr_spec is not None and penv.spec.dr_spec is not None
    E = 2
    st = jax.vmap(jenv._fresh_pipeline)(jax.random.split(jax.random.PRNGKey(3), E))
    rng = np.random.default_rng(12)
    aq = np.array(st.ant_qpos)
    aq[0, :, 0] = 4.5 + rng.uniform(0.05, 0.45, 10)
    aq[0, :, 2] = rng.uniform(0.5, 0.8, 10)
    aq[1, :, 2] = rng.uniform(0.4, 0.6, 10)
    aq[1, :, 7:] += rng.normal(0, 0.4, (10, 8))
    av = rng.normal(0, 0.3, aq.shape[:2] + (14,)).astype(np.float32)
    av[0, :, 0] = -1.0
    drv = dr_values(jenv.spec.ant_sys, (E, 10), 21)
    st = st.replace(ant_qpos=jnp.asarray(aq), ant_qvel=jnp.asarray(av),
                    dr=j_dr.DrSample(**{k: jnp.asarray(v) for k, v in drv.items()}))
    t = lambda x: torch.from_numpy(np.array(x))
    pst = p_scene.AntSceneState(
        ant_qpos=t(st.ant_qpos), ant_qvel=t(st.ant_qvel), box_qpos=t(st.box_qpos),
        box_qvel=t(st.box_qvel), sensors=t(st.sensors), dr_count=t(st.dr_count),
        frame=t(st.frame), dr=p_dr.DrSample(**{k: t(v) for k, v in drv.items()}))
    actions = rng.uniform(-1, 1, (E, 10, 8)).astype(np.float32)
    return jenv, penv, st, pst, actions


def _assert_scene(got, ref):
    for name, (rtol, atol) in SCENE_TOL.items():
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=rtol, atol=atol, err_msg=name)


def test_array_path_scene_step_with_dr_matches_jax(dr_scene):
    jenv, penv, st, pst, actions = dr_scene
    ref = jax.jit(jax.vmap(lambda s, a: j_scene.scene_step(jenv.spec, s, a)))(
        st, jnp.asarray(actions))
    got = p_scene.scene_step(penv.spec, pst, torch.from_numpy(actions))
    assert float(np.abs(np.asarray(ref.box_qvel)[0]).max()) > 1e-3  # the box was pushed
    _assert_scene(got, ref)
    np.testing.assert_array_equal(got.dr_count.numpy(), np.asarray(ref.dr_count))
    # the sample matters: the nominal parameters land elsewhere
    nominal = p_scene.scene_step(penv.spec._replace(dr_spec=None), pst,
                                 torch.from_numpy(actions))
    assert float((nominal.ant_qvel - got.ant_qvel).abs().max()) > 1e-3


def test_fused_scene_step_with_dr_matches_array_path(dr_scene):
    _, penv, _, pst, actions = dr_scene
    a = torch.from_numpy(actions)
    got = p_fs.fused_scene_step(penv.spec, pst, a, penv.substep_consts)
    ref = p_scene.scene_step(penv.spec, pst, a)
    for name, (rtol, atol) in SCENE_TOL.items():
        np.testing.assert_allclose(getattr(got, name).numpy(), getattr(ref, name).numpy(),
                                   rtol=rtol, atol=atol, err_msg=name)
    assert got.dr is pst.dr


def test_engine_takes_per_articulation_parameters(models):
    """forward_dynamics and point_inertia with [E, A]-batched parameters
    equal the unbatched calls one articulation at a time."""
    _, pm = models
    sys = pm.system
    drv = dr_values(sys, (2, 3), 9)
    d = p_dr.DrSample(**{k: torch.from_numpy(v) for k, v in drv.items()})
    g = torch.Generator().manual_seed(0)
    qpos = torch.cat([torch.randn(2, 3, 3, generator=g), torch.nn.functional.normalize(
        torch.randn(2, 3, 4, generator=g), dim=-1), torch.randn(2, 3, 8, generator=g)], -1)
    qvel = torch.randn(2, 3, 14, generator=g)
    tau = torch.randn(2, 3, 8, generator=g)
    grav = torch.tensor(GRAV)

    def run(s, q, v, t):
        fk = p_engine.fwd_kinematics(s, q, v)
        p_w, _ = p_engine.points_world(s, fk)
        pi = p_engine.point_inertia(s, fk, p_w)
        f_ext = [torch.zeros(q.shape[:-1] + (6,)) for _ in range(s.nb)]
        t_lim, d_lim, k_lim = p_engine.joint_limit_spring(s, q)
        qacc = p_engine.forward_dynamics(s, fk, v, t + t_lim, f_ext, grav,
                                         imp_damping=s.damping + d_lim, h=H, imp_stiffness=k_lim)
        return qacc, pi.inv_mass, pi.inv_inertia_w

    batched = run(d.apply(sys), qpos, qvel, tau)
    for e in range(2):
        for a in range(3):
            one = p_dr.DrSample(**{k: getattr(d, k)[e, a] for k in FIELDS}).apply(sys)
            for x, y in zip(batched, run(one, qpos[e, a], qvel[e, a], tau[e, a])):
                np.testing.assert_allclose(x[e, a].numpy(), y.numpy(), rtol=1e-5, atol=1e-5)
