"""TRPO and off-policy checkpoint files between the two packages, on the CPU.

* A file written by the JAX TRPO.save / OffPolicy.save (ToyEnv of
  tests/test_ppo.py, small widths; sac, td3, ddpg and SAC with auto_alpha)
  loads into the port's trainer bit for bit: every parameter (TRPO's
  weights transposed), the targets, log_alpha and the iteration.
* A file written by the port loads into the JAX trainer's `load` with the
  same leaves.
* A file of another algorithm (or another set of networks) raises
  ValueError in the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from massive_marl_tpu.algos.rl import offpolicy as j_off
from massive_marl_tpu.algos.rl import trpo as j_trpo
from massive_marl_tpu_torch.algos.rl import offpolicy as p_off
from massive_marl_tpu_torch.algos.rl import trpo as p_trpo
from massive_marl_tpu_torch.envs.base import EnvState
from massive_marl_tpu_torch.utils import bridge
from massive_marl_tpu_torch.utils.tree import tree_map
from tests.test_ppo import ToyEnv

E = 4
TRPO_HIDDEN = (16, 8)
OFF = dict(hidden_nodes=16, hidden_layer=2, replay_size=4, batch_size=2)
ALGOS = {"sac": dict(algo="sac"), "td3": dict(algo="td3"), "ddpg": dict(algo="ddpg"),
         "sac_auto_alpha": dict(algo="sac", auto_alpha=True)}


class PToy:
    """The port-side stand-in for ToyEnv's interface (obs 3, one action)."""
    num_obs, num_actions, num_agents = 3, 1, 1
    device = torch.device("cpu")

    def reset(self, num_envs):
        return EnvState(pipeline=(), carry=(), progress=torch.zeros(num_envs, dtype=torch.int32),
                        done=torch.zeros(num_envs, dtype=torch.bool),
                        obs=torch.zeros(num_envs, 3), reward=torch.zeros(num_envs))


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x), tree)


def _jax_trpo():
    jt = j_trpo.TRPO(ToyEnv(), num_envs=E, cfg=j_trpo.TRPOConfig(hidden=TRPO_HIDDEN), seed=1,
                     print_log=False)
    jt.state = jt.init_state()
    return jt


def _port_trpo():
    return p_trpo.TRPO(PToy(), E, p_trpo.TRPOConfig(hidden=TRPO_HIDDEN), device="cpu",
                       print_log=False)


def _jax_off(name):
    jt = j_off.OffPolicy(ToyEnv(), num_envs=E, cfg=j_off.OffPolicyConfig(**OFF, **ALGOS[name]),
                         seed=1, print_log=False)
    jt.state = jt.init_state()
    return jt


def _port_off(name):
    return p_off.OffPolicy(PToy(), E, p_off.OffPolicyConfig(**OFF, **ALGOS[name]), device="cpu",
                           print_log=False)


def _trpo_sds(jstate):
    return bridge.trpo_state_from_flax({"actor_params": _np(jstate.actor_params),
                                        "critic_params": _np(jstate.critic_params),
                                        "iteration": 0})[:2]


def _equal_sd(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def _equal_tree(port, jax_tree):
    got = []
    tree_map(lambda p, j: got.append(np.array_equal(p.detach().numpy(), np.asarray(j))),
             port, jax_tree)
    assert got and all(got)


def test_trpo_jax_file_loads_in_port(tmp_path):
    jt = _jax_trpo()
    jt.state = jt.state.replace(iteration=jnp.asarray(3, jnp.int32))
    path = str(tmp_path / "model_3.ckpt")
    jt.save(path)
    tr = _port_trpo()
    tr.load(path)
    actor, critic = _trpo_sds(jt.state)
    _equal_sd(tr.actor.state_dict(), actor)
    _equal_sd(tr.critic.state_dict(), critic)
    assert tr.state.iteration == 3


def test_trpo_port_file_loads_in_jax(tmp_path):
    tr = _port_trpo()
    tr.init_state()
    tr.state.iteration = 5
    path = str(tmp_path / "model_5.ckpt")
    tr.save(path)
    jt = _jax_trpo()
    jt.load(path)
    assert int(jt.state.iteration) == 5
    actor, critic = _trpo_sds(jt.state)
    _equal_sd(actor, tr.actor.state_dict())
    _equal_sd(critic, tr.critic.state_dict())


@pytest.mark.parametrize("name", list(ALGOS))
def test_offpolicy_jax_file_loads_in_port(name, tmp_path):
    jt = _jax_off(name)
    # targets unlike the parameters, so a swap would show
    jt.state = jt.state.replace(
        target_params=jax.tree_util.tree_map(lambda x: x + 0.5, jt.state.target_params),
        iteration=jnp.asarray(7, jnp.int32))
    path = str(tmp_path / "model_7.ckpt")
    jt.save(path)
    tr = _port_off(name)
    tr.load(path)
    _equal_tree(tr.state.params, _np(jt.state.params))
    _equal_tree(tr.state.target_params, _np(jt.state.target_params))
    assert tr.state.iteration == 7
    assert all(t.requires_grad for t in (tr.state.params["pi"]["params"]["Dense_0"]["kernel"],
                                         tr.state.params["q1"]["params"]["Dense_0"]["bias"]))


@pytest.mark.parametrize("name", list(ALGOS))
def test_offpolicy_port_file_loads_in_jax(name, tmp_path):
    tr = _port_off(name)
    st = tr.init_state()
    with torch.no_grad():
        tree_map(lambda t: t.add_(0.25), st.target_params)
    st.iteration = 2
    path = str(tmp_path / "model_2.ckpt")
    tr.save(path)
    jt = _jax_off(name)
    jt.load(path)
    assert int(jt.state.iteration) == 2
    _equal_tree(st.params, _np(jt.state.params))
    _equal_tree(st.target_params, _np(jt.state.target_params))


@pytest.mark.parametrize("saved,loaded", [("trpo", "sac"), ("sac", "trpo"), ("td3", "sac"),
                                          ("ddpg", "td3"), ("sac", "sac_auto_alpha"),
                                          ("sac_auto_alpha", "sac")])
def test_other_algorithm_refused(saved, loaded, tmp_path):
    path = str(tmp_path / "other.ckpt")
    (_jax_trpo() if saved == "trpo" else _jax_off(saved)).save(path)
    tr = _port_trpo() if loaded == "trpo" else _port_off(loaded)
    with pytest.raises(ValueError, match="checkpoint holds"):
        tr.load(path)
