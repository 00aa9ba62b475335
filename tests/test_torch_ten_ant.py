"""The port's TenAnt env against the JAX package on the CPU.

step_batch of the port (physics through the plain substep on the CPU) is
held against jax.vmap(TenAntEnv.step) from the same state, over one control
step in which no env resets; then the reset layout and the auto-reset
overwrite are checked on the port alone.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from massive_marl_tpu.envs.ten_ant import TenAntEnv as JTenAnt
from massive_marl_tpu_torch.envs.ant_scene import AntSceneState
from massive_marl_tpu_torch.envs.base import EnvState
from massive_marl_tpu_torch.envs.ten_ant import TenAntCarry
from massive_marl_tpu_torch.envs.ten_ant import TenAntEnv as PTenAnt

CFG = {"sim": {"substeps": 2}}
E = 3


@pytest.fixture(scope="module")
def envs():
    return JTenAnt(CFG), PTenAnt(CFG, device="cpu", seed=1)


def _to_port(s) -> EnvState:
    t = lambda x: torch.from_numpy(np.array(x))
    p = s.pipeline
    return EnvState(
        pipeline=AntSceneState(ant_qpos=t(p.ant_qpos), ant_qvel=t(p.ant_qvel),
                               box_qpos=t(p.box_qpos), box_qvel=t(p.box_qvel),
                               sensors=t(p.sensors), dr_count=t(p.dr_count), frame=t(p.frame)),
        carry=TenAntCarry(pos_before=t(s.carry.pos_before), goal_before=t(s.carry.goal_before)),
        progress=t(s.progress), done=t(s.done), obs=t(s.obs), reward=t(s.reward))


def test_step_batch_matches_vmapped_jax_step(envs):
    jenv, penv = envs
    s = jax.jit(jax.vmap(jenv.reset))(jax.random.split(jax.random.PRNGKey(4), E))
    rng = np.random.default_rng(5)
    p = s.pipeline
    aq = np.array(p.ant_qpos)
    aq[..., 2] = rng.uniform(0.45, 0.7, aq.shape[:2])   # some feet in ground contact
    aq[0, :3, 0] = 4.7                                   # three ants against the box
    av = rng.normal(0, 0.3, aq.shape[:2] + (14,)).astype(np.float32)
    progress = np.array([0, 10, 998], np.int32)          # env 2 reaches the episode end
    s = s.replace(pipeline=p.replace(ant_qpos=jnp.asarray(aq), ant_qvel=jnp.asarray(av)),
                  progress=jnp.asarray(progress))
    actions = rng.uniform(-1, 1, (E, 80)).astype(np.float32)

    ref = jax.jit(jax.vmap(jenv.step))(s, jnp.asarray(actions))
    got = penv.step_batch(_to_port(s), torch.from_numpy(actions))

    assert not np.asarray(ref.done)[:2].any() and bool(np.asarray(ref.done)[2])
    np.testing.assert_array_equal(got.progress.numpy(), np.asarray(ref.progress))
    np.testing.assert_allclose(got.obs.numpy(), np.asarray(ref.obs), rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(got.reward.numpy(), np.asarray(ref.reward), rtol=5e-3, atol=2e-2)
    np.testing.assert_array_equal(got.done.numpy(), np.asarray(ref.done))
    np.testing.assert_allclose(got.carry.goal_before.numpy(), np.asarray(ref.carry.goal_before),
                               rtol=2e-4, atol=2e-4)


def test_reset_layout_and_shared_hinge_noise(envs):
    _, penv = envs
    n = 16
    s = penv.reset(n)
    p = s.pipeline
    lo, hi = penv.spec.ant_sys.jnt_range[:, 0], penv.spec.ant_sys.jnt_range[:, 1]
    assert s.obs.shape == (n, 388) and p.ant_qpos.shape == (n, 10, 15)
    assert p.ant_qvel.shape == (n, 10, 14) and p.sensors.shape == (n, 10, 4, 6)
    assert not s.done.any() and (s.progress == 0).all()
    torch.testing.assert_close(p.ant_qpos[..., 0:3], penv.ant_start.expand(n, 10, 3))
    torch.testing.assert_close(p.ant_qpos[..., 3:7], torch.tensor([0.0, 0, 0, 1]).expand(n, 10, 4))
    torch.testing.assert_close(p.box_qpos, torch.tensor([4.0, 0, 1, 0, 0, 0, 1]).expand(n, 7))
    # one hinge noise vector per env, shared by its ants
    hinge, hvel = p.ant_qpos[..., 7:], p.ant_qvel[..., 6:]
    assert torch.equal(hinge, hinge[:, :1].expand_as(hinge))
    assert torch.equal(hvel, hvel[:, :1].expand_as(hvel))
    assert not torch.equal(hinge[0], hinge[1])
    assert ((hinge >= lo) & (hinge <= hi)).all()
    assert ((hinge - penv.init_hinge).abs() <= 0.2 + 1e-6).all()
    assert (hvel.abs() <= 0.1).all()
    assert (p.ant_qvel[..., :6] == 0).all() and (p.box_qvel == 0).all()


def test_done_env_is_overwritten_by_a_fresh_episode(envs):
    _, penv = envs
    s = penv.reset(2)
    s.done = torch.tensor([True, False])
    s.progress = torch.tensor([999, 5], dtype=torch.int32)
    out = penv.step_batch(s, torch.zeros(2, 80))
    assert out.progress.tolist() == [0, 6]
    torch.testing.assert_close(out.pipeline.ant_qpos[0, :, 0:3], penv.ant_start)
    assert (out.pipeline.ant_qvel[0, :, :6] == 0).all()
    assert not torch.equal(out.pipeline.ant_qpos[1, :, 0:3], penv.ant_start)
