"""The port's multi-task and meta-RL wrappers against the JAX package's, on
the CPU.

* Two stub tasks of different widths (obs 5 / 3, actions 2 / 1), written
  once per package with the same arithmetic, behind both packages'
  MultiTaskVecTaskPython and MetaVecTaskPython in both modes: the padded
  obs and the one-hot, reward and done after reset and steps of each task
  (actions cut to the task's width, clipped to +-1), reached by round-robin
  sampling and by set_task, agree exactly; task_envs, num_obs and
  num_actions too.
* Uniform task sampling draws every task with frequency 1/K (3,000 draws,
  within 0.04), from the wrapper's own seeded generator: two wrappers of
  one seed draw the same sequence.
"""
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from massive_marl_tpu.wrap import multi_task_vec_task as j_mt
from massive_marl_tpu_torch.envs.base import EnvState
from massive_marl_tpu_torch.wrap import multi_task_vec_task as p_mt

E = 3
BASES = {"A": np.array([-7.0, -2.0, 0.5, 3.0, 8.0], np.float32),
         "B": np.array([4.0, -1.0, 6.5], np.float32)}
ACTS = {"A": 2, "B": 1}


class JState(NamedTuple):
    obs: jnp.ndarray
    reward: jnp.ndarray
    done: jnp.ndarray
    t: jnp.ndarray


def j_stub(name):
    base, n_act = BASES[name], ACTS[name]

    class JStub:
        num_agents, num_obs, num_actions = 1, len(base), n_act

        def reset(self, key):
            return JState(jnp.asarray(base), jnp.float32(0.0), jnp.bool_(False), jnp.int32(0))

        def step(self, s, a):
            t = s.t + 1
            return JState(jnp.asarray(base) * (1 + t) + jnp.sum(a), jnp.sum(a) + t,
                          t % 2 == 0, t)
    return JStub()


def p_stub(name):
    base, n_act = torch.from_numpy(BASES[name]), ACTS[name]

    class PStub:
        num_agents, num_obs, num_actions = 1, len(base), n_act
        device = torch.device("cpu")
        generator = torch.Generator()

        def reset(self, n):
            return EnvState(pipeline=(), carry=(), progress=torch.zeros(n, dtype=torch.int32),
                            done=torch.zeros(n, dtype=torch.bool), obs=base.expand(n, -1).clone(),
                            reward=torch.zeros(n))

        def step_batch(self, s, a):
            t = s.progress + 1
            return EnvState(pipeline=(), carry=(), progress=t, done=t % 2 == 0,
                            obs=base * (1 + t[:, None]) + a.sum(1, keepdim=True),
                            reward=a.sum(1) + t)
    return PStub()


def _pair(mode, cls="MultiTaskVecTaskPython", **kw):
    j = getattr(j_mt, cls)({n: j_stub(n) for n in BASES}, E, seed=1, mode=mode, **kw)
    p = getattr(p_mt, cls)({n: p_stub(n) for n in BASES}, E, seed=1, mode=mode, **kw)
    return j, p


def _same(j_out, p_out):
    for a, b in zip(j_out[:3], p_out[:3]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("mode", ["add-onehot", "vanilla"])
def test_round_robin_matches_jax(mode):
    j, p = _pair(mode)
    assert (p.num_obs, p.num_actions, p.task_names) == (j.num_obs, j.num_actions, j.task_names)
    assert p.num_obs == 5 + (2 if mode == "add-onehot" else 0)
    rng = np.random.default_rng(0)
    for _ in range(4):
        np.testing.assert_array_equal(p.reset().numpy(), np.asarray(j.reset()))
        for _ in range(3):
            a = rng.uniform(-2, 2, (E, 2)).astype(np.float32)
            _same(j.step(a), p.step(torch.from_numpy(a)))
        assert p.sample_task() == j.sample_task()
        assert p.current_task == j.current_task
    obs = p.step(torch.zeros(E, 2))[0]
    if mode == "add-onehot":
        np.testing.assert_array_equal(obs[:, 5:].numpy(), np.tile([1.0, 0.0], (E, 1)))
    assert obs.shape == (E, p.num_obs)


def test_meta_set_task_matches_jax():
    j, p = _pair("add-onehot", "MetaVecTaskPython")
    assert p.task_envs == j.task_envs == ["A", "B"]
    rng = np.random.default_rng(1)
    for idx in (1, 0, 1):
        j.set_task(idx)
        p.set_task(idx)
        assert p.current_task == j.current_task
        a = rng.uniform(-2, 2, (E, 2)).astype(np.float32)
        _same(j.step(a), p.step(torch.from_numpy(a)))
    with pytest.raises(ValueError):
        p_mt.MultiTaskVecTaskPython({"A": p_stub("A")}, E, mode="concat")


def test_uniform_sampling_distribution():
    envs = {n: p_stub(n) for n in BASES}
    envs["C"] = p_stub("A")
    w = p_mt.MultiTaskVecTaskPython(envs, E, seed=7, sample_strategy="uniform")
    draws = np.array([w.sample_task() for _ in range(3000)])
    freq = np.bincount(draws, minlength=3) / len(draws)
    np.testing.assert_allclose(freq, 1 / 3, atol=0.04)
    again = p_mt.MultiTaskVecTaskPython(envs, E, seed=7, sample_strategy="uniform")
    assert [again.sample_task() for _ in range(50)] == draws[:50].tolist()
    rr = p_mt.MultiTaskVecTaskPython(envs, E, seed=7)
    assert [rr.sample_task() for _ in range(4)] == [1, 2, 0, 1]
