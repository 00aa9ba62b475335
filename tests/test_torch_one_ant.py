"""The port's OneAnt env against the JAX package on the CPU.

* obs_math.ant_obs_60 against JAX's under jax.vmap;
* step_batch from the same state, on both of the port's physics paths (the
  kernel path, through the plain substep with sensor outputs on the CPU;
  and `fused_kernel: false`, the array engine), each against
  jax.vmap(OneAntEnv.step), which is JAX's array path ("auto" is off away
  from the TPU in the JAX package): the ant pressed against the box with
  its feet on the ground, one env at the episode's end, no env resetting on
  this step;
* one OneAnt + PPO iteration of the port on the CPU with finite metrics.
Tolerances as tests/test_torch_ten_ant.py's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from massive_marl_tpu.envs import obs_math as j_obs
from massive_marl_tpu.envs.one_ant import OneAntEnv as JOneAnt
from massive_marl_tpu_torch.algos.rl.ppo import PPO, PPOConfig
from massive_marl_tpu_torch.envs import obs_math as p_obs
from massive_marl_tpu_torch.envs.ant_scene import AntSceneState
from massive_marl_tpu_torch.envs.base import EnvState
from massive_marl_tpu_torch.envs.one_ant import OneAntCarry
from massive_marl_tpu_torch.envs.one_ant import OneAntEnv as POneAnt

CFG = {"sim": {"substeps": 2}}
E = 3


def t(x):
    return torch.from_numpy(np.array(x))


def test_ant_obs_60_matches_jax():
    rng = np.random.default_rng(0)
    n = 16
    quat = rng.normal(0, 1, (n, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    qpos = np.concatenate([rng.normal(0, 1, (n, 3)), quat, rng.uniform(-1, 1, (n, 8))], 1)
    args = [qpos, rng.normal(0, 1, (n, 14)), rng.uniform(-1, 1, (n, 8)),
            rng.normal(0, 50, (n, 4, 6)), rng.normal(0, 5, 3), rng.uniform(-1, -0.2, 8),
            rng.uniform(0.2, 1, 8)]
    args = [np.asarray(a, np.float32) for a in args]
    ref = jax.vmap(j_obs.ant_obs_60, in_axes=(0, 0, 0, 0, None, None, None, None, None))(
        *args, 0.2, 0.1)
    got = p_obs.ant_obs_60(*[torch.from_numpy(a) for a in args], 0.2, 0.1)
    assert got.shape == (n, 60)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jax_step():
    """(JAX state, actions [E,8], jax.vmap(OneAntEnv.step) output)."""
    jenv = JOneAnt(CFG)
    assert not jenv.use_fused
    s = jax.jit(jax.vmap(jenv.reset))(jax.random.split(jax.random.PRNGKey(1), E))
    rng = np.random.default_rng(2)
    p = s.pipeline
    aq = np.array(p.ant_qpos)
    aq[:, 0, 0] = -4.5 - rng.uniform(0.05, 0.3, E)       # against the box's -x face
    aq[:, 0, 2] = rng.uniform(0.45, 0.6, E)              # feet on the ground
    av = rng.normal(0, 0.3, aq.shape[:2] + (14,)).astype(np.float32)
    av[:, 0, 0] = 1.0
    s = s.replace(pipeline=p.replace(ant_qpos=jnp.asarray(aq), ant_qvel=jnp.asarray(av)),
                  progress=jnp.asarray([0, 10, 998], jnp.int32))
    actions = rng.uniform(-1, 1, (E, 8)).astype(np.float32)
    return s, actions, jax.jit(jax.vmap(jenv.step))(s, jnp.asarray(actions))


@pytest.mark.parametrize("fused", [True, False], ids=["kernel_path", "array_path"])
def test_step_batch_matches_vmapped_jax_step(jax_step, fused):
    s, actions, ref = jax_step
    penv = POneAnt(dict(CFG, sim=dict(CFG["sim"], fused_kernel=fused)), device="cpu")
    assert penv.use_fused == fused
    p = s.pipeline
    state = EnvState(
        pipeline=AntSceneState(ant_qpos=t(p.ant_qpos), ant_qvel=t(p.ant_qvel),
                               box_qpos=t(p.box_qpos), box_qvel=t(p.box_qvel),
                               sensors=t(p.sensors), dr_count=t(p.dr_count), frame=t(p.frame)),
        carry=OneAntCarry(pos_before=t(s.carry.pos_before), box_before=t(s.carry.box_before)),
        progress=t(s.progress), done=t(s.done), obs=t(s.obs), reward=t(s.reward))
    got = penv.step_batch(state, torch.from_numpy(actions))
    assert not np.asarray(ref.done)[:2].any() and bool(np.asarray(ref.done)[2])
    assert float(np.abs(np.asarray(ref.obs)[:, 28:52]).max()) > 0.1   # foot sensors read contact
    np.testing.assert_array_equal(got.progress.numpy(), np.asarray(ref.progress))
    np.testing.assert_array_equal(got.done.numpy(), np.asarray(ref.done))
    np.testing.assert_allclose(got.obs.numpy(), np.asarray(ref.obs), rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(got.reward.numpy(), np.asarray(ref.reward), rtol=5e-3, atol=2e-2)
    np.testing.assert_allclose(got.carry.box_before.numpy(), np.asarray(ref.carry.box_before),
                               rtol=2e-4, atol=2e-4)


def test_one_ant_ppo_iteration_on_cpu():
    env = POneAnt({"sim": {"substeps": 1}}, device="cpu")
    ppo = PPO(env, 4, PPOConfig(hidden=(32, 32), nsteps=4), device="cpu", print_log=False)
    ppo.run(1)
    m = ppo.last_metrics
    for k in ("mean_value_loss", "mean_surrogate_loss", "mean_reward", "lr"):
        assert np.isfinite(m[k]), k
    obs = ppo.state.env_state.obs
    assert obs.shape == (4, 60) and torch.isfinite(obs).all()
