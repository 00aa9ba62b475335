"""The port's offline RL (datasets, TD3+BC, BCQ, IQL, ppo_collect) against
the JAX package's on the CPU.

* OfflineConfig from cfg/{td3_bc,bcq,iql}/config.yaml equals JAX's field
  for field (dataset_dir, vae_latent and quantile are not read).
* One train step per algorithm from bridged parameters and one batch:
  jax.random.randint and jax.random.normal are stood in by numpy draws
  handed out in trace order (BCQ's perturbation step re-reads the VAE
  step's key, so its stand-in hands that draw out twice), and the port's
  `_slots` / `_normal` hand out the same draws in its call order.  Every
  network is float32 on both sides: q_loss at rtol 1e-5, every parameter
  after its one Adam step within 2 * lr of JAX's with a median difference
  below 0.05 * lr (a gradient near 0 may flip Adam's sign), and every
  target within tau of that.
* Each algorithm's acting rule through eval_online on a scripted env
  whose reward is a fixed linear function of the action, 4 envs x 4 steps,
  BCQ's z stood in: the mean reward at rtol 1e-5.
* A dataset written by the JAX save_dataset is read by the port bit for
  bit, through the g++-built mmtio reader and through numpy's, and one the
  port writes (either writer) is read by the JAX load_dataset bit for bit.
* OfflineTrainer checkpoints both ways bit for bit; a file of another
  algorithm raises ValueError.
* make_random_dataset steps the port's OneAnt (64 transitions) into the
  JAX file layout; PPOCollect trains the port's PPO one iteration on a
  scripted env and writes the first collect_steps transitions of its
  rollout chunks.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from massive_marl_tpu.algos.offrl import datasets as j_data
from massive_marl_tpu.algos.offrl import trainers as j_off
from massive_marl_tpu.envs.base import EnvState as JEnvState
from massive_marl_tpu_torch import native as p_native
from massive_marl_tpu_torch.algos.offrl import datasets as p_data
from massive_marl_tpu_torch.algos.offrl import trainers as p_off
from massive_marl_tpu_torch.envs.base import EnvState as PEnvState
from massive_marl_tpu_torch.utils import bridge, yaml_lite
from massive_marl_tpu_torch.utils.config import CFG_ROOT
from massive_marl_tpu_torch.utils.tree import tree_map

N, OBS, ACT, B = 96, 6, 2, 16
LR, TAU = 3e-4, 0.005
RNG = np.random.default_rng(8)
DATA = dict(states=RNG.normal(0.5, 2.0, (N, OBS)), actions=RNG.uniform(-1, 1, (N, ACT)),
            rewards=RNG.normal(0, 1, (N, 1)), dones=(RNG.random((N, 1)) < 0.1) * 1.0,
            next_states=RNG.normal(0.5, 2.0, (N, OBS)))
DATA = {k: v.astype(np.float32) for k, v in DATA.items()}
IDX = RNG.integers(0, N, B).astype(np.int32)
SMALL = dict(batch_size=B, hidden=32, layers=2, log_interval=1, save_interval=0)
ALGOS = ["td3_bc", "bcq", "iql"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("algo", ALGOS)
def test_config_from_yaml_matches_jax(algo):
    cfg_train = yaml_lite.load(f"{CFG_ROOT}/{algo}/config.yaml")
    got = p_off.OfflineConfig.from_cfg_train(cfg_train, algo)
    assert vars(got) == vars(j_off.OfflineConfig.from_cfg_train(cfg_train, algo))
    assert got.dataset_root == "./datasets" and got.max_iterations == 100_000


class Queue:
    def __init__(self, arrays):
        self.arrays, self.i = list(arrays), 0

    def __call__(self, shape):
        a = self.arrays[self.i]
        self.i += 1
        assert a.shape == tuple(shape), (a.shape, shape)
        return a


def _draws(algo):
    """(the JAX trace's normal draws, the port's) of one train step."""
    if algo == "td3_bc":
        d = [RNG.standard_normal((B, ACT)).astype(np.float32)]
        return d, d
    if algo == "bcq":
        eps = RNG.standard_normal((B, 2 * ACT)).astype(np.float32)
        cand = RNG.standard_normal((10 * B, 2 * ACT)).astype(np.float32)
        return [eps, cand, eps], [eps, cand]
    return [], []


def _pair(algo, **kw):
    jt = j_off.OfflineTrainer(task="X", datatype="y", cfg=j_off.OfflineConfig(
        algo=algo, **SMALL, **kw), seed=0, data=DATA, print_log=False)
    js = jt.init_state()
    pt = p_off.OfflineTrainer(task="X", datatype="y", cfg=p_off.OfflineConfig(
        algo=algo, **SMALL, **kw), data=DATA, device="cpu", print_log=False)
    st = pt.init_state()
    with torch.no_grad():
        for mine, theirs in ((st.params, js.params), (st.target_params, js.target_params)):
            tree_map(lambda a, b: a.copy_(b), mine, bridge.tree_from_flax(_np(theirs)))
    return jt, js, pt


def _pairs(port_tree, jax_tree):
    out = []
    tree_map(lambda p, j: out.append(np.abs(p.detach().numpy() - np.asarray(j)).reshape(-1)),
             port_tree, _np(jax_tree))
    return np.concatenate(out)


@pytest.mark.parametrize("algo", ALGOS)
def test_one_train_step_matches_jax(algo, monkeypatch):
    jt, js, pt = _pair(algo)
    j_draws, p_draws = _draws(algo)
    jq = Queue(j_draws)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), dtype=None: jnp.asarray(jq(shape)))
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, minval, maxval, dtype=None: jnp.asarray(IDX))
    j_new, j_m = jt._train_step(js)
    assert jq.i == len(j_draws)
    pq = Queue(p_draws)
    pt._normal = lambda shape, generator=None: torch.from_numpy(pq(shape))
    pt._slots = lambda: torch.from_numpy(IDX.astype(np.int64))
    q_loss = float(pt.train_step())
    assert pq.i == len(p_draws) and pt.state.step == 1
    np.testing.assert_allclose(q_loss, float(j_m["q_loss"]), rtol=1e-5)
    d = _pairs(pt.state.params, j_new.params)
    assert d.max() <= 2 * LR * (1 + 1e-3) and np.median(d) < 0.05 * LR, (d.max(), np.median(d))
    moved = _pairs(pt.state.params, js.params)
    assert np.median(moved) > 0.5 * LR          # every network took its step
    assert _pairs(pt.state.target_params, j_new.target_params).max() <= TAU * 2 * LR * 1.001


class JLinear:
    """Obs from a table; reward = a . W[t] (exposes the action)."""
    num_agents, num_actions, num_obs = 1, ACT, OBS

    def __init__(self, obs, w):
        self.obs, self.w = obs, w

    def reset(self, key):
        return JEnvState(pipeline=jnp.zeros(()), carry=jnp.zeros(()),
                         progress=jnp.asarray(0, jnp.int32), done=jnp.asarray(False), key=key,
                         obs=jnp.asarray(self.obs[0, 0]), reward=jnp.asarray(0.0))

    def step_batch(self, state, actions):
        t = state.progress[0]
        obs = jnp.asarray(self.obs)[t + 1]
        return state.replace(progress=state.progress + 1, obs=obs,
                             reward=jnp.sum(actions * jnp.asarray(self.w)[t], -1))


class PLinear:
    num_agents, num_actions, num_obs = 1, ACT, OBS
    device = torch.device("cpu")

    def __init__(self, obs, w):
        self.obs, self.w = torch.from_numpy(obs), torch.from_numpy(w)
        self.generator = torch.Generator()

    def reset(self, num_envs):
        return PEnvState(pipeline=(), carry=(), progress=torch.zeros(num_envs, dtype=torch.int32),
                         done=torch.zeros(num_envs, dtype=torch.bool), obs=self.obs[0],
                         reward=torch.zeros(num_envs))

    def step_batch(self, state, actions):
        t = int(state.progress[0])
        return PEnvState(pipeline=(), carry=(), progress=state.progress + 1,
                         done=state.done, obs=self.obs[t + 1],
                         reward=torch.sum(actions * self.w[t], -1))


@pytest.mark.parametrize("algo", ALGOS)
def test_eval_online_acting_rule_matches_jax(algo, monkeypatch):
    n_envs, n_steps = 4, 4
    obs = RNG.normal(0, 4, (n_steps + 1, n_envs, OBS)).astype(np.float32)
    obs[0] = obs[0, 0]      # JLinear resets one env at a time, without its index
    w = RNG.normal(0, 1, (n_steps, n_envs, ACT)).astype(np.float32)
    z = RNG.standard_normal((10 * n_envs, 2 * ACT)).astype(np.float32)
    jt, js, pt = _pair(algo)
    jt.state = js
    monkeypatch.setattr(jax.random, "normal", lambda key, shape=(), dtype=None: jnp.asarray(z))
    j_r = jt.eval_online(JLinear(obs, w), num_envs=n_envs, n_steps=n_steps)
    pt._normal = lambda shape, generator=None: torch.from_numpy(z)
    p_r = pt.eval_online(PLinear(obs, w), num_envs=n_envs, n_steps=n_steps)
    assert np.isfinite(p_r) and p_r != 0.0
    np.testing.assert_allclose(p_r, j_r, rtol=1e-5)


# ---------------------------------------------------------------- files
def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype == np.float32
        np.testing.assert_array_equal(a[k], b[k])


def test_native_lib_builds_into_build_native():
    lib = p_native.get_mmtio_lib()
    assert lib is not None, "g++ build of mmtio failed"
    assert os.path.dirname(lib._name) == p_native.BUILD_DIR


@pytest.mark.parametrize("native_io", [True, False], ids=["mmtio", "numpy"])
def test_datasets_both_ways(tmp_path, native_io, monkeypatch):
    if not native_io:                        # the fallback when g++ cannot build mmtio
        monkeypatch.setattr(p_native, "get_mmtio_lib", lambda: None)
    j_dir, p_dir = str(tmp_path / "OneAnt_expert"), str(tmp_path / "port_expert")
    j_data.save_dataset(j_dir, **DATA)
    got = p_data.load_dataset(j_dir)
    _equal(got, DATA)
    p_data.save_dataset(p_dir, **{k: torch.from_numpy(v) for k, v in DATA.items()})
    _equal(j_data.load_dataset(p_dir), DATA)
    for name in p_data.FILES:
        with open(os.path.join(j_dir, f"{name}.npy"), "rb") as a, \
                open(os.path.join(p_dir, f"{name}.npy"), "rb") as b:
            if native_io:                    # the same writer: the same bytes
                assert a.read() == b.read(), name
    m = p_native.NpyMmap(os.path.join(j_dir, "states.npy"))
    np.testing.assert_array_equal(m.gather(np.array([5, 0, 95])), DATA["states"][[5, 0, 95]])
    m.close()
    assert p_data.dataset_dir("root", "OneAnt", "expert") == os.path.join("root", "OneAnt_expert")


@pytest.mark.parametrize("algo", ALGOS)
def test_checkpoints_both_ways(algo, tmp_path):
    jt, js, pt = _pair(algo)
    jt.state = js.replace(step=jnp.asarray(11, jnp.int32))
    jt.save(str(tmp_path / "jax.ckpt"))
    pt.state.params = tree_map(lambda t: (t + 1.0).detach().requires_grad_(True), pt.state.params)
    pt.load(str(tmp_path / "jax.ckpt"))
    assert pt.state.step == 11 and _pairs(pt.state.params, js.params).max() == 0.0
    with torch.no_grad():
        tree_map(lambda t: t.mul_(0.5), pt.state.params)
    pt.state.step = 13
    pt.save(str(tmp_path / "port.ckpt"))
    jt.load(str(tmp_path / "port.ckpt"))
    assert int(jt.state.step) == 13 and _pairs(pt.state.params, jt.state.params).max() == 0.0
    other = {"td3_bc": "iql", "bcq": "td3_bc", "iql": "bcq"}[algo]
    _, _, po = _pair(other)
    with pytest.raises(ValueError):
        po.load(str(tmp_path / "port.ckpt"))


def test_make_random_dataset_and_ppo_collect(tmp_path):
    path = p_data.make_random_dataset(str(tmp_path / "OneAnt_random"), n=64, num_envs=16,
                                      device="cpu")
    d = j_data.load_dataset(path)
    assert {k: v.shape for k, v in d.items()} == {
        "states": (64, 60), "actions": (64, 8), "rewards": (64, 1), "dones": (64, 1),
        "next_states": (64, 60)}
    assert all(np.isfinite(v).all() for v in d.values())
    assert np.abs(d["actions"]).max() <= 1.0
    np.testing.assert_array_equal(d["next_states"][:48], d["states"][16:])

    from massive_marl_tpu_torch.algos.offrl.collect import PPOCollect
    from tests.test_torch_mtrl import PScripted, TABLES
    cfg_train = {"policy": {"pi_hid_sizes": [16]},
                 "learn": {"nsteps": 4, "noptepochs": 1, "nminibatches": 1, "collect_steps": 100}}
    pc = PPOCollect(PScripted("a"), 8, cfg_train, dataset_dir=str(tmp_path), task="T",
                    datatype="expert", device="cpu")
    pc.ppo.print_log = False
    out = pc.run(1)
    d = p_data.load_dataset(out)
    assert out == os.path.join(str(tmp_path), "T_expert") and len(d["states"]) == 100
    # the trainer ran 4 steps; the chunks continue the scripted tables from there
    obs = np.clip(TABLES["a"]["obs"], -5, 5)
    np.testing.assert_array_equal(d["states"][:8], obs[4])
    np.testing.assert_array_equal(d["next_states"][:8], obs[5])
    np.testing.assert_array_equal(d["rewards"][:8, 0], TABLES["a"]["rew"][5])
