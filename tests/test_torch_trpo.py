"""The port's TRPO against the JAX package's on the CPU.

* TRPOConfig.from_cfg_train gives the JAX config on cfg/trpo/config.yaml,
  with the JAX key map's traps kept (cg_iters, cg_damping, backtrack_*,
  optim_stepsize and vf_hid_sizes are not read).
* One iteration on a scripted env, written here for both frameworks: its
  obs, reward and done come from numpy arrays indexed by the step, and
  jax.random.normal is stood in by a function that returns one numpy noise
  array (the rollout's lax.scan traces its body once, so that draw serves
  every step; the port is fed the same array at every step).  The JAX
  jitted train_iter and the port's rollout_phase + update_phase then see the
  same trajectory up to the bf16 roundings of the two frameworks' towers:
  the accepted flag agrees exactly, the actor's step within 1% of its size
  (the HATRPO precedent, tests/test_torch_marl.py), the value loss at rtol
  2e-2, and the critic after its 5 Adam steps within 5 * lr with a median
  difference far below lr (the rule of
  tests/test_torch_ppo.py::test_one_adam_step_matches_jax).
* TRPO.run(2) on the port's TenAnt (E = 4, small widths) stays finite.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from massive_marl_tpu.algos.rl import trpo as j_trpo
from massive_marl_tpu.envs.base import EnvState as JEnvState
from massive_marl_tpu_torch.algos.rl import trpo as p_trpo
from massive_marl_tpu_torch.envs.base import EnvState as PEnvState
from massive_marl_tpu_torch.envs.ten_ant import TenAntEnv
from massive_marl_tpu_torch.utils import bridge, yaml_lite
from massive_marl_tpu_torch.utils.config import CFG_ROOT

T, E, OBS, ACT = 8, 8, 12, 4
HIDDEN = (64, 64)
RNG = np.random.default_rng(3)
OBS_TAB = RNG.normal(0.0, 1.5, (T + 1, E, OBS)).astype(np.float32)
REW_TAB = RNG.normal(0.5, 1.0, (T + 1, E)).astype(np.float32)
DONE_TAB = RNG.random((T + 1, E)) < 0.15
NOISE = RNG.standard_normal((E, ACT)).astype(np.float32)


class JScripted:
    """The scripted env for the JAX trainer: a batched step that reads the
    tables at progress + 1."""
    num_agents, num_actions, num_obs = 1, ACT, OBS

    def reset(self, key):
        return JEnvState(pipeline=jnp.zeros(()), carry=jnp.zeros(()),
                         progress=jnp.asarray(0, jnp.int32), done=jnp.asarray(False), key=key,
                         obs=jnp.asarray(OBS_TAB[0, 0]), reward=jnp.asarray(0.0))

    def step_batch(self, state, actions):
        t = state.progress[0] + 1
        return state.replace(progress=state.progress + 1, obs=jnp.asarray(OBS_TAB)[t],
                             reward=jnp.asarray(REW_TAB)[t], done=jnp.asarray(DONE_TAB)[t])


class PScripted:
    num_agents, num_actions, num_obs = 1, ACT, OBS
    device = torch.device("cpu")

    def reset(self, num_envs):
        return PEnvState(pipeline=(), carry=(), progress=torch.zeros(num_envs, dtype=torch.int32),
                         done=torch.zeros(num_envs, dtype=torch.bool),
                         obs=torch.from_numpy(OBS_TAB[0]), reward=torch.zeros(num_envs))

    def step_batch(self, state, actions):
        t = int(state.progress[0]) + 1
        return PEnvState(pipeline=(), carry=(), progress=state.progress + 1,
                         done=torch.from_numpy(DONE_TAB[t]), obs=torch.from_numpy(OBS_TAB[t]),
                         reward=torch.from_numpy(REW_TAB[t]))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _fields(cfg):
    return {k: v for k, v in vars(cfg).items()}


def test_config_from_yaml_matches_jax():
    cfg_train = yaml_lite.load(f"{CFG_ROOT}/trpo/config.yaml")
    got = _fields(p_trpo.TRPOConfig.from_cfg_train(cfg_train))
    assert got == _fields(j_trpo.TRPOConfig.from_cfg_train(cfg_train))
    # the YAML's cg_iters / backtrack_iters / optim_stepsize are not read
    # (the JAX keys are cg_nsteps / max_num_backtrack; vf_lr stays 3e-4)
    assert (got["cg_nsteps"], got["max_num_backtrack"], got["vf_lr"]) == (10, 10, 3e-4)
    assert got["hidden"] == (1024, 1024, 512)
    assert _fields(p_trpo.TRPOConfig.from_cfg_train({})) == _fields(p_trpo.TRPOConfig())


@pytest.fixture(scope="module")
def jax_iteration():
    """(initial train state, state after one jitted train_iter, metrics)."""
    jt = j_trpo.TRPO(JScripted(), num_envs=E, cfg=j_trpo.TRPOConfig(hidden=HIDDEN), seed=0,
                     print_log=False)
    ts = jt.init_state()
    ts = ts.replace(env_state=JEnvState(
        pipeline=jnp.zeros(E), carry=jnp.zeros(E), progress=jnp.zeros(E, jnp.int32),
        done=jnp.zeros(E, bool), key=ts.env_state.key, obs=jnp.asarray(OBS_TAB[0]),
        reward=jnp.zeros(E)))
    orig = jax.random.normal
    jax.random.normal = lambda key, shape=(), dtype=None: jnp.asarray(NOISE).reshape(shape)
    try:
        new, m = jt._train_iter(ts)
    finally:
        jax.random.normal = orig
    return ts, new, _np(m)


def _port_from(ts):
    tr = p_trpo.TRPO(PScripted(), E, p_trpo.TRPOConfig(hidden=HIDDEN), device="cpu",
                     print_log=False)
    actor, critic, _ = bridge.trpo_state_from_flax(
        {"actor_params": _np(ts.actor_params), "critic_params": _np(ts.critic_params),
         "iteration": 0})
    tr.actor.load_state_dict(actor)
    tr.critic.load_state_dict(critic)
    tr.init_state()
    tr._normal = lambda shape: torch.from_numpy(NOISE).reshape(shape)
    return tr


def test_one_iteration_matches_jax(jax_iteration):
    ts, new, j_m = jax_iteration
    tr = _port_from(ts)
    traj = tr.rollout_phase()
    np.testing.assert_array_equal(traj["obs"].numpy(), np.clip(OBS_TAB[:T], -5, 5))
    p_m = {k: float(v) for k, v in tr.update_phase(traj, tr.state.env_state.obs).items()}
    assert p_m["accepted"] == j_m["accepted"] == 1.0
    assert tr.last_search == {"fvps": 11, "candidates": tr.last_search["candidates"]}
    np.testing.assert_allclose(p_m["mean_reward"], j_m["mean_reward"], rtol=1e-6)
    np.testing.assert_allclose(p_m["value_loss"], j_m["value_loss"], rtol=2e-2)

    # the actor's step, relative to its size
    before, _, _ = bridge.trpo_state_from_flax({"actor_params": _np(ts.actor_params),
                                                "critic_params": _np(ts.critic_params),
                                                "iteration": 0})
    j_after, j_critic, _ = bridge.trpo_state_from_flax(
        {"actor_params": _np(new.actor_params), "critic_params": _np(new.critic_params),
         "iteration": 0})
    flat = lambda sd: torch.cat([sd[k].reshape(-1) for k in sorted(sd)])
    step_j = flat(j_after) - flat(before)
    step_p = flat(tr.actor.state_dict()) - flat(before)
    assert float(step_j.norm()) > 0
    assert float((step_p - step_j).norm() / step_j.norm()) < 0.01

    # the critic after vf_epochs Adam steps of lr each
    lr, n = 3e-4, 5
    p_critic = tr.critic.state_dict()
    diffs = []
    for k, j in j_critic.items():
        d = (p_critic[k] - j).abs()
        assert float(d.max()) <= n * lr * (1 + 1e-3), k
        diffs.append(d.reshape(-1))
    assert float(torch.cat(diffs).median()) < 0.05 * lr


def test_line_search_keeps_the_old_actor_when_nothing_passes():
    tr = p_trpo.TRPO(PScripted(), E, p_trpo.TRPOConfig(hidden=HIDDEN, max_kl=1e-12,
                                                       max_num_backtrack=3),
                     device="cpu", print_log=False)
    tr.init_state()
    before = [p.detach().clone() for p in tr.actor.parameters()]
    m = tr.train_iter()
    assert float(m["accepted"]) == 0.0 and tr.last_search["candidates"] == 3
    assert all(torch.equal(a, b) for a, b in zip(before, tr.actor.parameters()))


def test_port_trpo_run_two_iterations():
    env = TenAntEnv({"sim": {"substeps": 1}}, device="cpu")
    tr = p_trpo.TRPO(env, 4, p_trpo.TRPOConfig(hidden=(32, 16), nsteps=4), device="cpu",
                     print_log=False)
    tr.run(2)
    assert tr.state.iteration == 2
    assert all(np.isfinite(v) for v in tr.last_metrics.values())
    assert all(torch.isfinite(p).all() for p in tr.actor.parameters())
    assert tr.state.env_state.obs.shape == (4, 388)
