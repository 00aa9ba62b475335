"""The port's MultiAntCircle and MultiIngenuity, and the mjcf weld pass,
against the JAX package on the CPU.

* parse_mjcf("ingenuity.xml"): the welded one-body System (nb = 1, nj = 0)
  equals JAX's in every field at 1e-6.
* MultiIngenuity: _thrusts and _reward on numpy inputs, and one step (from
  a state with displaced, tilted and spinning helicopters, one env done on
  the previous step and one at the episode's end) against JAX's eager
  jax.vmap(step), at 1e-4; the engine's nj = 0 path runs in the step.
* MultiAntCircle: _reward on numpy inputs (ants on and off the circle band,
  moving either way, one fallen, one env at the episode's end) against JAX's
  at 1e-5, and one control step from a converted state against one jitted
  jax.vmap(step) at tests/test_torch_scene_step.py's control-step
  tolerances (pipeline, obs, reward, done, progress).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from massive_marl_tpu.envs.base import EnvState as JEnvState
from massive_marl_tpu.envs.multi_ant_circle import CircleCarry as JCarry
from massive_marl_tpu.envs.multi_ant_circle import MultiAntCircleEnv as JCircle
from massive_marl_tpu.envs.multi_ingenuity import HeliPipeline as JHeli
from massive_marl_tpu.envs.multi_ingenuity import SPAWNS
from massive_marl_tpu.envs.multi_ingenuity import MultiIngenuityEnv as JIngenuity
from massive_marl_tpu.phys import mjcf as j_mjcf
from massive_marl_tpu_torch.envs import ant_scene as p_scene
from massive_marl_tpu_torch.envs.base import EnvState
from massive_marl_tpu_torch.envs.multi_ant_circle import CircleCarry
from massive_marl_tpu_torch.envs.multi_ant_circle import MultiAntCircleEnv as PCircle
from massive_marl_tpu_torch.envs.multi_ingenuity import HeliPipeline
from massive_marl_tpu_torch.envs.multi_ingenuity import MultiIngenuityEnv as PIngenuity
from massive_marl_tpu_torch.phys import mjcf as p_mjcf
from massive_marl_tpu_torch.utils.bridge import system_arrays

TOL = {"ant_qpos": (2e-4, 2e-4), "ant_qvel": (5e-3, 5e-3)}


def t(x):
    return torch.from_numpy(np.array(x))


def test_weld_pass_matches_jax():
    j = j_mjcf.parse_mjcf(j_mjcf.asset_path("ingenuity.xml"))
    p = p_mjcf.parse_mjcf(p_mjcf.asset_path("ingenuity.xml"))
    ja, pa = system_arrays(j.system), system_arrays(p.system)
    assert (p.system.nb, p.system.nj, p.system.nq, p.system.nv) == (1, 0, 7, 6)
    assert p.system.body_names == j.system.body_names
    for k in ja:
        assert pa[k].shape == ja[k].shape, k
        np.testing.assert_allclose(pa[k], ja[k], rtol=1e-6, atol=1e-6, err_msg=k)
    assert p.gear_dof.shape == p.init_hinge.shape == (0,)


# ----------------------------------------------------------- MultiIngenuity
def _heli_state(rng, E):
    pos = SPAWNS[None] + rng.normal(0, 0.3, (E, 4, 3))
    quat = rng.normal(0, 1, (E, 4, 4))
    quat[..., 3] += 4.0                                   # tilted, not upside down
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    qpos = np.concatenate([pos, quat], -1).astype(np.float32)
    qvel = rng.normal(0, 1.0, (E, 4, 6)).astype(np.float32)
    return qpos, qvel


def test_ingenuity_thrusts_and_reward_match_jax():
    jenv, penv = JIngenuity(), PIngenuity(device="cpu")
    rng = np.random.default_rng(1)
    E = 6
    actions = rng.uniform(-1.5, 1.5, (E, 24)).astype(np.float32)
    np.testing.assert_allclose(penv._thrusts(torch.from_numpy(actions)).numpy(),
                               np.asarray(jax.vmap(jenv._thrusts)(jnp.asarray(actions))),
                               rtol=1e-4, atol=1e-4)
    qpos, qvel = _heli_state(rng, E)
    qpos[1, 2, 2] = 0.3                                   # below z = 0.5: dies
    qpos[2, 0, 0] = 13.0                                  # 9 m from its goal: dies
    progress = np.array([0, 5, 7, 999, 998, 12], np.int32)
    j_r, j_d = jax.vmap(jenv._reward)(JHeli(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel)),
                                      jnp.asarray(progress))
    p_r, p_d = penv._reward(HeliPipeline(t(qpos), t(qvel)), t(progress))
    np.testing.assert_allclose(p_r.numpy(), np.asarray(j_r), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(p_d.numpy(), np.asarray(j_d))
    assert p_d.numpy().tolist() == [False, True, True, True, True, False]


def test_ingenuity_step_matches_jax():
    jenv, penv = JIngenuity(), PIngenuity(device="cpu")
    rng = np.random.default_rng(2)
    E = 4
    qpos, qvel = _heli_state(rng, E)
    done = np.array([False, True, False, False])          # env 1 restarts at the spawns
    progress = np.array([3, 40, 998, 0], np.int32)        # env 2 reaches the end
    actions = rng.uniform(-1, 1, (E, 24)).astype(np.float32)
    obs = np.concatenate([qpos, qvel], -1).reshape(E, -1)
    js = JEnvState(pipeline=JHeli(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel)),
                   carry=jnp.zeros(E), progress=jnp.asarray(progress), done=jnp.asarray(done),
                   key=jax.random.split(jax.random.PRNGKey(0), E), obs=jnp.asarray(obs),
                   reward=jnp.zeros(E))
    ref = jax.vmap(jenv.step)(js, jnp.asarray(actions))
    ps = EnvState(pipeline=HeliPipeline(t(qpos), t(qvel)), carry=(), progress=t(progress),
                  done=t(done), obs=t(obs), reward=torch.zeros(E))
    got = penv.step_batch(ps, torch.from_numpy(actions))
    for name in ("qpos", "qvel"):
        np.testing.assert_allclose(getattr(got.pipeline, name).numpy(),
                                   np.asarray(getattr(ref.pipeline, name)), rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    np.testing.assert_allclose(got.obs.numpy(), np.asarray(ref.obs), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.reward.numpy(), np.asarray(ref.reward), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.done.numpy(), np.asarray(ref.done))
    np.testing.assert_array_equal(got.progress.numpy(), np.asarray(ref.progress))
    assert got.progress.numpy().tolist() == [4, 0, 999, 1]
    # the physics moved every env that did not restart
    moved = np.abs(got.pipeline.qpos.numpy() - qpos).reshape(E, -1).max(1)
    assert (moved[[0, 2, 3]] > 1e-4).all()


# ----------------------------------------------------------- MultiAntCircle
def test_circle_reward_matches_jax():
    jenv, penv = JCircle(), PCircle(device="cpu")
    rng = np.random.default_rng(3)
    E = 8
    ang = rng.uniform(0, 2 * np.pi, (E, 2))
    rad = rng.uniform(2.4, 3.6, (E, 2))
    qpos = np.zeros((E, 2, 15), np.float32)
    qpos[..., 0], qpos[..., 1] = rad * np.cos(ang), rad * np.sin(ang)
    step = rng.choice([-0.05, 0.05], (E, 2))              # either way round
    before = np.stack([rad * np.cos(ang - step), rad * np.sin(ang - step)], -1)
    before *= np.array([1.0, -1.0])[None, :, None]         # signed, as the carry holds it
    obs = rng.uniform(-1, 1, (E, 76)).astype(np.float32)
    per = obs.reshape(E, 2, 38)
    per[..., 2] = rng.uniform(0.35, 0.8, (E, 2))
    per[3, 1, 2] = 0.2                                    # fallen
    per[..., 12] = rng.uniform(0.9, 1.0, (E, 2))
    per[..., 14:22] = rng.uniform(0.95, 1.0, (E, 2, 8))
    actions = rng.uniform(-1, 1, (E, 2, 8)).astype(np.float32)
    progress = np.array([0, 3, 999, 5, 998, 7, 8, 9], np.int32)
    jp = jax.vmap(jenv._fresh_pipeline)(jax.random.split(jax.random.PRNGKey(0), E))
    jp = jp.replace(ant_qpos=jnp.asarray(qpos))
    j_r, j_d = jax.vmap(jenv._reward)(jnp.asarray(obs), jnp.asarray(actions), jp,
                                      JCarry(pos_before=jnp.asarray(before, jnp.float32)),
                                      jnp.asarray(progress))
    pp = p_scene.AntSceneState(ant_qpos=t(qpos), ant_qvel=torch.zeros(E, 2, 14),
                               box_qpos=torch.zeros(E, 7), box_qvel=torch.zeros(E, 6),
                               sensors=torch.zeros(E, 2, 4, 6),
                               dr_count=torch.zeros(E, dtype=torch.int32),
                               frame=torch.zeros(E, dtype=torch.int32))
    p_r, p_d = penv._reward(t(obs), t(actions), pp, CircleCarry(t(before.astype(np.float32))),
                            t(progress))
    np.testing.assert_allclose(p_r.numpy(), np.asarray(j_r), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(p_d.numpy(), np.asarray(j_d))
    # env 2 at the episode's end, env 3 fallen; env 4 (progress 998) one step short
    assert p_d.numpy().tolist() == [False, False, True, True, False, False, False, False]
    assert len(np.unique(np.asarray(j_r)[[0, 1, 4, 5, 6, 7]].round(3))) > 2


def test_circle_step_matches_jax():
    cfg = {"sim": {"substeps": 2}}
    jenv, penv = JCircle(cfg), PCircle(cfg, device="cpu")
    E = 3
    s = jax.jit(jax.vmap(jenv.reset))(jax.random.split(jax.random.PRNGKey(4), E))
    rng = np.random.default_rng(6)
    p = s.pipeline
    aq = np.array(p.ant_qpos)
    aq[..., 2] = rng.uniform(0.28, 0.36, aq.shape[:2])  # feet pressed into the ground
    av = rng.normal(0, 0.3, aq.shape[:2] + (14,)).astype(np.float32)
    s = s.replace(pipeline=p.replace(ant_qpos=jnp.asarray(aq), ant_qvel=jnp.asarray(av)),
                  progress=jnp.asarray([0, 10, 998], jnp.int32))   # env 2 reaches the end
    actions = rng.uniform(-1, 1, (E, 16)).astype(np.float32)
    ref = jax.jit(jax.vmap(jenv.step))(s, jnp.asarray(actions))
    pp = s.pipeline
    state = EnvState(
        pipeline=p_scene.AntSceneState(ant_qpos=t(pp.ant_qpos), ant_qvel=t(pp.ant_qvel),
                                       box_qpos=t(pp.box_qpos), box_qvel=t(pp.box_qvel),
                                       sensors=t(pp.sensors), dr_count=t(pp.dr_count),
                                       frame=t(pp.frame)),
        carry=CircleCarry(t(s.carry.pos_before)), progress=t(s.progress), done=t(s.done),
        obs=t(s.obs), reward=t(s.reward))
    got = penv.step_batch(state, torch.from_numpy(actions))
    assert not np.asarray(s.done).any()
    assert float(np.abs(np.asarray(ref.pipeline.sensors)).max()) > 1.0     # feet in contact
    for name, (rtol, atol) in TOL.items():
        np.testing.assert_allclose(getattr(got.pipeline, name).numpy(),
                                   np.asarray(getattr(ref.pipeline, name)), rtol=rtol, atol=atol,
                                   err_msg=name)
    np.testing.assert_array_equal(got.progress.numpy(), np.asarray(ref.progress))
    np.testing.assert_array_equal(got.done.numpy(), np.asarray(ref.done))
    assert got.done.numpy().tolist()[2]
    np.testing.assert_allclose(got.obs.numpy(), np.asarray(ref.obs), rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(got.reward.numpy(), np.asarray(ref.reward), rtol=5e-3, atol=2e-2)
    np.testing.assert_allclose(got.carry.pos_before.numpy(), np.asarray(ref.carry.pos_before),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("cls", [PCircle, PIngenuity])
def test_reset_shapes(cls):
    env = cls(device="cpu", seed=1)
    st = env.reset(5)
    assert st.obs.shape == (5, env.num_obs) and torch.isfinite(st.obs).all()
    assert env.num_obs == env.num_agents * env.num_ant_obs


@pytest.mark.parametrize("n_agents,width", [(2, 38), (2, 76), (4, 13), (4, 52)])
def test_fused_path_pads_the_new_widths(n_agents, width):
    """MAPPO on MultiAntCircle (obs 38, share 76) and MultiIngenuity (13,
    52): the fused blocks (their plain versions here) pad layer 0's input to
    128 columns; the actor's means and the critic's values, and the layer-0
    kernel's gradient, equal the unfused networks' at the bf16 towers'
    tolerance (rtol 2e-2 plus 2% of the scale)."""
    from massive_marl_tpu_torch.algos.marl import fused_nets
    from massive_marl_tpu_torch.algos.marl.nets import MarlActor, MarlCritic
    g = torch.Generator().manual_seed(width)
    actor, critic = MarlActor(8, hidden_size=128), MarlCritic(hidden_size=128)
    ap, cp = actor.init(n_agents, width, g), critic.init(n_agents, width, g)
    x = torch.randn(n_agents, 64, width, generator=g) * 2

    def close(a, b):
        a, b = a.detach().numpy(), b.detach().numpy()
        np.testing.assert_allclose(a, b, rtol=2e-2, atol=2e-2 * np.abs(b).max())

    w = ap["MLPBase_0"]["Dense_0"]["kernel"].requires_grad_(True)
    mean_f, _ = fused_nets.actor_apply(ap, x)
    mean_p, _ = actor.apply(ap, x)
    close(mean_f, mean_p)
    gf, = torch.autograd.grad(mean_f.sum(), w)
    gp, = torch.autograd.grad(mean_p.sum(), w)
    assert gf.shape == (n_agents, width, 128)
    close(gf, gp)
    close(fused_nets.critic_apply(cp, x), critic.apply(cp, x))
