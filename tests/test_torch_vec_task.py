"""The port's VecTask wrappers and `make` against the JAX package's, on the
CPU.

* A small stub env, written once per package with the same arithmetic
  (observations beyond the clips, a reward and a done flag that depend on
  the actions and the step), goes through both packages' VecTaskPython and
  MultiVecTaskPython: step before reset, action clipping at +-1,
  observation clipping at +-5 / +-7, the per-agent split, the broadcast
  share obs, reward and done, a zero-action reset of a live state, and
  actions given as a list of agents.  Every output agrees exactly.
* The port's wrappers draw the env's randomness from their own seeded
  generator and leave the env's own in place.
* `make("OneAnt", device="cpu")` runs a random-action loop and
  `make("TenAnt", algo="mappo", device="cpu")` takes a multi-agent step;
  without device="cpu" and without a card, `make` raises.
"""
from dataclasses import dataclass
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import massive_marl_tpu_torch as port
from massive_marl_tpu.wrap import vec_task as j_vt
from massive_marl_tpu_torch.wrap import vec_task as p_vt

E = 3
BASE = np.array([-9.0, -6.0, -3.0, -1.0, 1.0, 3.0, 6.0, 9.0], np.float32)
ACTIONS = np.array([[[1.5, -0.2], [0.3, -3.0]], [[0.0, 0.9], [-1.2, 2.0]],
                    [[-0.4, 0.4], [5.0, -5.0]]], np.float32)            # [E, N, act]


class JState(NamedTuple):
    obs: jnp.ndarray
    reward: jnp.ndarray
    done: jnp.ndarray
    t: jnp.ndarray


class JStub:
    """One env: 2 agents of 3 own obs each and a shared tail of 2."""
    num_agents, num_ant_obs, num_obs, num_actions = 2, 3, 8, 2

    def reset(self, key):
        return JState(jnp.asarray(BASE), jnp.float32(0.0), jnp.bool_(False), jnp.int32(0))

    def step(self, s, a):
        t = s.t + 1
        obs = jnp.asarray(BASE) * (1 + t) + jnp.concatenate([a, a])
        return JState(obs, jnp.sum(a) + t, t % 3 == 0, t)


@dataclass
class PState:
    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    t: torch.Tensor
    draw: torch.Tensor


class PStub:
    """JStub batched, as the port's envs are; `draw` records the generator."""
    num_agents, num_ant_obs, num_obs, num_actions = 2, 3, 8, 2

    def __init__(self):
        self.device = torch.device("cpu")
        self.generator = torch.Generator().manual_seed(99)

    def reset(self, n):
        return PState(torch.from_numpy(BASE).expand(n, 8).clone(), torch.zeros(n),
                      torch.zeros(n, dtype=torch.bool), torch.zeros(n, dtype=torch.int32),
                      torch.rand(n, generator=self.generator))

    def step_batch(self, s, a):
        t = s.t + 1
        obs = torch.from_numpy(BASE) * (1 + t[:, None]) + torch.cat([a, a], 1)
        return PState(obs, a.sum(1) + t, t % 3 == 0, t,
                      torch.rand(a.shape[0], generator=self.generator))


def _eq(port_out, jax_out):
    np.testing.assert_array_equal(np.asarray(port_out), np.asarray(jax_out))


def test_vec_task_python_matches_jax():
    jw, pw = j_vt.VecTaskPython(JStub(), E, seed=0), p_vt.VecTaskPython(PStub(), E, seed=0)
    assert (pw.num_obs, pw.num_actions) == (jw.num_obs, jw.num_actions) == (8, 4)
    flat = ACTIONS.reshape(E, -1)
    for call in (lambda w: w.step(flat),          # step before reset
                 lambda w: (w.reset(),), lambda w: w.step(flat), lambda w: w.step(-flat),
                 lambda w: w.step(2 * flat), lambda w: (w.get_state(),)):
        for p, j in zip(call(pw)[:3], call(jw)[:3]):
            _eq(p, j)
    assert float(pw.get_state().abs().max()) == 5.0


def test_multi_vec_task_python_matches_jax():
    jw, pw = j_vt.MultiVecTaskPython(JStub(), E), p_vt.MultiVecTaskPython(PStub(), E)
    assert (pw.num_obs, pw.num_share_obs, pw.num_actions, pw.num_agents) == \
        (jw.num_obs, jw.num_share_obs, jw.num_actions, jw.num_agents) == (5, 8, 2, 2)
    as_list = lambda a: [a[:, i] for i in range(a.shape[1])]
    calls = [lambda w, a: w.step(a),              # step before reset
             lambda w, a: w.reset(),              # live state: a zero-action step
             lambda w, a: w.step(a), lambda w, a: w.step(as_list(a)), lambda w, a: w.reset()]
    for call in calls:
        p_out = call(pw, torch.from_numpy(ACTIONS))
        j_out = call(jw, jnp.asarray(ACTIONS))
        for p, j in zip(p_out, j_out):
            if j is None or isinstance(j, list):
                assert p == j
            else:
                _eq(p, j)
    obs, share, _ = p_vt.MultiVecTaskPython(PStub(), E).reset()   # a fresh reset
    obs_j, share_j, _ = j_vt.MultiVecTaskPython(JStub(), E).reset()
    _eq(obs, obs_j)
    _eq(share, share_j)
    _, _, rewards, dones, infos, _ = pw.step(torch.from_numpy(ACTIONS))
    assert rewards.shape == (E, 2, 1) and dones.shape == (E, 2) and infos == [{}, {}]
    assert float(obs.abs().max()) == 7.0


def test_wrappers_draw_from_their_generator():
    env = PStub()
    own = env.generator
    draws = []
    for seed in (5, 5, 6):
        w = p_vt.VecTaskPython(env, E, seed=seed)
        w.reset()
        w.step(np.zeros((E, 4), np.float32))
        draws.append(w.state.draw)
        assert env.generator is own
    assert torch.equal(draws[0], draws[1]) and not torch.equal(draws[0], draws[2])


def test_make_one_ant_random_loop():
    env = port.make("OneAnt", num_envs=2, seed=1, device="cpu")
    assert isinstance(env, p_vt.VecTaskPython) and env.num_actions == 8
    obs = env.reset()
    g = torch.Generator().manual_seed(0)
    for _ in range(3):
        obs, rew, done, info = env.step(torch.rand((2, 8), generator=g) * 2 - 1)
        assert obs.shape == (2, env.num_obs) and rew.shape == (2,) and done.dtype == torch.bool
        assert torch.isfinite(obs).all() and float(obs.abs().max()) <= 5.0
        assert info == {}


def test_make_ten_ant_mappo_step():
    env = port.make("TenAnt", algo="mappo", num_envs=2, device="cpu")
    assert isinstance(env, p_vt.MultiVecTaskPython)
    obs, share, _ = env.reset()
    assert obs.shape == (2, 10, 46) and share.shape == (2, 10, 388)
    obs, share, rewards, dones, infos, _ = env.step([torch.zeros(2, 8)] * 10)
    assert rewards.shape == (2, 10, 1) and dones.shape == (2, 10) and len(infos) == 10
    assert torch.equal(rewards[:, 0], rewards[:, 9]) and torch.isfinite(share).all()
    ppo = port.make("TenAnt", num_envs=2, device="cpu", episodeLength=7)
    assert isinstance(ppo, p_vt.VecTaskPython) and ppo.num_actions == 80
    assert ppo.env.max_episode_length == 7


def test_make_defaults_to_cuda():
    if torch.cuda.is_available():
        assert port.make("OneAnt", num_envs=2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port.make("OneAnt", num_envs=2)
