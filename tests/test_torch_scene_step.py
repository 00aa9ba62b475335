"""The port's array-path scene step (envs/ant_scene.scene_step) against the
JAX package's on the CPU.

* TenAnt: one jitted call of JAX's `step_batch` with `fused_kernel: false`
  (jax.vmap(TenAntEnv.step), whose physics is jax.vmap(scene_step)) from a
  state with ants pressed against the push-box, feet on the ground and one
  env at the episode's end.  No env resets on this step (a done flag takes
  effect on the next), so JAX's pipeline is its scene_step's output: the
  port's scene_step is held against it, and the port's step_batch with the
  same flag against the whole step (obs, reward, done, progress).
* OneAnt: the port's scene_step against jax.jit(jax.vmap(scene_step)) on
  OneAnt's spec (one ant, the 1 m box), the ant against the box.
Two jitted JAX scene steps in all.  Tolerances are
tests/test_torch_phys.py's for a control step; inputs are made with numpy
from fixed seeds and handed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from massive_marl_tpu.envs import ant_scene as j_scene
from massive_marl_tpu.envs.one_ant import OneAntEnv as JOneAnt
from massive_marl_tpu.envs.ten_ant import TenAntEnv as JTenAnt
from massive_marl_tpu_torch.envs import ant_scene as p_scene
from massive_marl_tpu_torch.envs.base import EnvState
from massive_marl_tpu_torch.envs.one_ant import OneAntEnv as POneAnt
from massive_marl_tpu_torch.envs.ten_ant import TenAntCarry
from massive_marl_tpu_torch.envs.ten_ant import TenAntEnv as PTenAnt

CFG = {"sim": {"substeps": 2, "fused_kernel": False}}
TOL = {"ant_qpos": (2e-4, 2e-4), "box_qpos": (2e-4, 2e-4), "ant_qvel": (5e-3, 5e-3),
       "box_qvel": (5e-3, 5e-3), "sensors": (5e-3, 5e-2)}


def t(x):
    return torch.from_numpy(np.array(x))


def to_port_pipeline(p):
    return p_scene.AntSceneState(ant_qpos=t(p.ant_qpos), ant_qvel=t(p.ant_qvel),
                                 box_qpos=t(p.box_qpos), box_qvel=t(p.box_qvel),
                                 sensors=t(p.sensors), dr_count=t(p.dr_count), frame=t(p.frame))


def assert_scene_close(got, ref):
    for name, (rtol, atol) in TOL.items():
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=rtol, atol=atol, err_msg=name)
    np.testing.assert_array_equal(got.frame.numpy(), np.asarray(ref.frame))


@pytest.fixture(scope="module")
def tenant():
    """(port env, JAX state, actions [3,80], JAX step_batch output)."""
    jenv, penv = JTenAnt(CFG), PTenAnt(CFG, device="cpu")
    assert not jenv.use_fused and not penv.use_fused
    E = 3
    s = jax.jit(jax.vmap(jenv.reset))(jax.random.split(jax.random.PRNGKey(4), E))
    rng = np.random.default_rng(5)
    p = s.pipeline
    aq = np.array(p.ant_qpos)
    aq[..., 2] = rng.uniform(0.45, 0.7, aq.shape[:2])   # feet in ground contact
    aq[0, :, 0] = 4.5 + rng.uniform(0.05, 0.45, 10)     # env 0's ants against the box's +x face
    av = rng.normal(0, 0.3, aq.shape[:2] + (14,)).astype(np.float32)
    av[0, :, 0] = -1.0                                   # moving into the box
    s = s.replace(pipeline=p.replace(ant_qpos=jnp.asarray(aq), ant_qvel=jnp.asarray(av)),
                  progress=jnp.asarray([0, 10, 998], jnp.int32))   # env 2 reaches the end
    actions = rng.uniform(-1, 1, (E, 80)).astype(np.float32)
    ref = jax.jit(jenv.step_batch)(s, jnp.asarray(actions))
    return penv, s, actions, ref


def test_scene_step_matches_jax_tenant(tenant):
    penv, s, actions, ref = tenant
    got = p_scene.scene_step(penv.spec, to_port_pipeline(s.pipeline),
                             torch.from_numpy(actions).reshape(3, 10, 8))
    assert float(np.abs(np.asarray(ref.pipeline.box_qvel)[0]).max()) > 1e-3   # the box was pushed
    assert float(np.abs(np.asarray(ref.pipeline.sensors)).max()) > 1.0        # feet in contact
    assert_scene_close(got, ref.pipeline)


def test_step_batch_array_path_matches_jax(tenant):
    penv, s, actions, ref = tenant
    state = EnvState(pipeline=to_port_pipeline(s.pipeline),
                     carry=TenAntCarry(pos_before=t(s.carry.pos_before),
                                       goal_before=t(s.carry.goal_before)),
                     progress=t(s.progress), done=t(s.done), obs=t(s.obs), reward=t(s.reward))
    calls = []
    real = p_scene.scene_step
    with pytest.MonkeyPatch.context() as mp:   # the array path, not the kernel's
        mp.setattr("massive_marl_tpu_torch.envs.ten_ant.scene_step",
                   lambda *a: calls.append(1) or real(*a))
        got = penv.step_batch(state, torch.from_numpy(actions))
    assert calls == [1]
    assert not np.asarray(ref.done)[:2].any() and bool(np.asarray(ref.done)[2])
    np.testing.assert_array_equal(got.progress.numpy(), np.asarray(ref.progress))
    np.testing.assert_array_equal(got.done.numpy(), np.asarray(ref.done))
    np.testing.assert_allclose(got.obs.numpy(), np.asarray(ref.obs), rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(got.reward.numpy(), np.asarray(ref.reward), rtol=5e-3, atol=2e-2)


def test_scene_step_matches_jax_one_ant():
    jenv, penv = JOneAnt(CFG), POneAnt(CFG, device="cpu")
    E = 2
    st = jax.vmap(jenv._fresh_pipeline)(jax.random.split(jax.random.PRNGKey(6), E))
    rng = np.random.default_rng(7)
    aq = np.array(st.ant_qpos)
    aq[:, 0, 0] = -4.5 - rng.uniform(0.05, 0.3, E)      # against the box's -x face
    aq[:, 0, 2] = rng.uniform(0.45, 0.6, E)
    av = rng.normal(0, 0.3, aq.shape[:2] + (14,)).astype(np.float32)
    av[:, 0, 0] = 1.0                                    # moving into the box
    st = st.replace(ant_qpos=jnp.asarray(aq), ant_qvel=jnp.asarray(av))
    actions = rng.uniform(-1, 1, (E, 1, 8)).astype(np.float32)
    ref = jax.jit(jax.vmap(lambda s, a: j_scene.scene_step(jenv.spec, s, a)))(
        st, jnp.asarray(actions))
    got = p_scene.scene_step(penv.spec, to_port_pipeline(st), torch.from_numpy(actions))
    assert float(np.abs(np.asarray(ref.box_qvel)).max()) > 1e-3
    assert float(np.abs(np.asarray(ref.sensors)).max()) > 1.0
    assert_scene_close(got, ref)
