"""The port's recurrent MARL runner and GRU nets against the JAX package's
on the CPU.

The team env of tests/test_marl.py gets a torch twin here (PTeamEnv), used
by tests/test_torch_{mat,maddpg}.py as well: three agents, each moving a
point, a shared reward -mean(pos^2).  The twin steps bit for bit as JAX's
jitted step on the CPU (it rounds the move and the mean as XLA's fused
multiply-adds do); an env that auto-resets takes the fixed position FRESH,
which stands in for JAX's jax.random.uniform draw there.

* The GRU cell (f32) and both RNN nets (MLPBase in bf16, the cell and the
  heads in f32) at bridged parameters against flax: rel 1e-5.
* `to_chunks` / `chunk_starts` against the JAX runner's own (taken from
  its jitted train_iter's closure), the chunk index chunk_t * E + e.
* One iteration (rollout and update) against JAX's jitted `_train_iter`
  for MAPPO with L = None (whole-rollout chunks), MAPPO with L = 2, and
  HAPPO with L = 2 and num_mini_batch 2.  Both sides see the same draws:
  jax.random.normal, uniform and permutation are stood in (each is traced
  once, so one draw serves every step, agent and epoch), and the port's
  `_normal` / `_chunk_perm` hand out the same arrays, HAPPO's agent order
  passed in.  Some envs end their episode inside the rollout, so the masks
  reset hiddens, and the rollout starts from nonzero hiddens.  Tolerances
  are tests/test_torch_marl.py's (bf16 MLPBase on both sides): the mean
  reward to 1e-5, value and policy losses rel 0.15 / abs 0.05, the
  ValueNorm statistics rel 1e-3, parameters after the update within 3 *
  lr * steps with the median difference below lr / 10; the hiddens after
  the rollout within 1e-2.
* A data_chunk_length that does not divide episode_length raises.
* eval() twice gives the same number, and stepping the training envs
  does not change it.
* A recurrent-MAPPO file written by the JAX runner's save restores in the
  port bit for bit, and the port's file in the JAX runner.
* One iteration on the port's TenAnt (N = 10, obs 46, share 388, act 8).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from massive_marl_tpu.algos.marl import nets as j_nets
from massive_marl_tpu.algos.marl.recurrent_runner import RecurrentMarlRunner as JRunner
from massive_marl_tpu.algos.marl.runner import MarlConfig as JConfig
from massive_marl_tpu_torch.algos.marl import nets as p_nets
from massive_marl_tpu_torch.algos.marl import recurrent_runner as p_rec
from massive_marl_tpu_torch.algos.marl.runner import MarlConfig as PConfig
from massive_marl_tpu_torch.envs.base import EnvState
from massive_marl_tpu_torch.envs.ten_ant import TenAntEnv
from massive_marl_tpu_torch.utils.bridge import marl_params_from_flax
from massive_marl_tpu_torch.utils.tree import tree_leaves, tree_map
from tests.test_marl import TeamEnv

N, ACT, OBS, SHARE = 3, 2, 6, 14
E, T, H = 8, 4, 32
LR = 5e-4
RNG = np.random.default_rng(11)
FRESH = RNG.uniform(-2, 2, 3).astype(np.float32)
PROGRESS0 = np.array([0, 13, 12, 14, 3, 5, 13, 2], np.int32)


def _fma(a, b: float, c):
    """float32 a * b + c rounded once, as XLA's CPU code fuses it (the
    product is exact in float64)."""
    b = torch.tensor(b, dtype=torch.float32).double()
    return (a.double() * b + c.double()).float()


def _mean_sq(pos):
    """mean(pos^2) over the last axis of 3, rounded as XLA's CPU code for
    jnp.mean(pos * pos) rounds it: a chain of fused multiply-adds, then a
    product with the float32 1/3."""
    acc = torch.zeros(pos.shape[:-1])
    for k in range(pos.shape[-1]):
        acc = (pos[..., k].double() ** 2 + acc.double()).float()
    return acc * torch.tensor(1.0 / 3.0, dtype=torch.float32)


class PTeamEnv:
    """Torch twin of tests/test_marl.py's TeamEnv, batched: an env that
    resets takes FRESH (or, with fresh=None, a uniform draw in [-2, 2)
    from its generator)."""
    num_agents, num_actions, num_ant_obs, num_obs = 3, 2, 4, 14
    max_len = 16
    device = torch.device("cpu")

    def __init__(self, fresh=FRESH, max_episode_length=None, seed=0):
        self.fresh = None if fresh is None else torch.as_tensor(fresh)
        if max_episode_length is not None:
            self.max_episode_length = max_episode_length
        self.generator = torch.Generator()
        self.generator.manual_seed(seed)

    def _obs(self, pos, progress):
        E_ = pos.shape[0]
        blocks = torch.stack([pos, pos * pos, torch.ones_like(pos), torch.zeros_like(pos)], -1)
        tail = torch.stack([progress.float() / self.max_len, torch.ones(E_)], -1)
        return torch.cat([blocks.reshape(E_, -1), tail], -1)

    def _draw(self, n):
        return torch.rand(n, 3, generator=self.generator) * 4.0 - 2.0

    def reset(self, num_envs):
        pos = self._draw(num_envs)
        progress = torch.zeros(num_envs, dtype=torch.int32)
        return EnvState(pipeline=pos, carry=(), progress=progress,
                        done=torch.zeros(num_envs, dtype=torch.bool),
                        obs=self._obs(pos, progress), reward=torch.zeros(num_envs))

    def step_batch(self, state, actions):
        E_ = actions.shape[0]
        a = actions.reshape(E_, 3, 2)
        fresh = self._draw(E_) if self.fresh is None else self.fresh.expand(E_, 3)
        moved = torch.clamp(_fma(a[..., 0], 0.2, state.pipeline), -3.0, 3.0)
        pos = torch.where(state.done[:, None], fresh, moved)
        progress = torch.where(state.done, 0, state.progress + 1).to(torch.int32)
        return EnvState(pipeline=pos, carry=(), progress=progress,
                        done=progress >= self.max_len - 1, obs=self._obs(pos, progress),
                        reward=-_mean_sq(pos))


class PTimedTeam(PTeamEnv):
    max_episode_length = PTeamEnv.max_len


def port_env_state(j_state):
    """The port twin's EnvState from a batched JAX _TeamState."""
    t = lambda x: torch.from_numpy(np.array(x))
    return EnvState(pipeline=t(j_state.pos), carry=(), progress=t(j_state.progress),
                    done=t(j_state.done), obs=t(j_state.obs), reward=t(j_state.reward))


def start_state(ts, progress=PROGRESS0):
    """JAX train state with the envs at `progress` (some end inside the
    rollout) and their obs recomputed."""
    env = TeamEnv()
    es = ts.env_state.replace(progress=jnp.asarray(progress))
    return ts.replace(env_state=es.replace(obs=jax.vmap(env._obs)(es.pos, es.progress)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _copy_params(dst, src):
    """src (flax numpy tree) into the port tree dst, by key."""
    with torch.no_grad():
        tree_map(lambda d, s: d.copy_(torch.from_numpy(np.array(s, np.float32))), dst, src)


# ------------------------------------------------------------------ nets
def test_gru_cell_matches_flax():
    rng = np.random.default_rng(0)
    cell = fnn.GRUCell(features=16)
    x, h = rng.normal(size=(5, 12)).astype(np.float32), rng.normal(size=(5, 16)).astype(np.float32)
    v = cell.init(jax.random.PRNGKey(1), h, x)
    j_h, _ = cell.apply(v, h, x)
    p = tree_map(lambda a: torch.from_numpy(np.array(a))[None], _np(v["params"]))
    p_h = p_nets.gru_step(p, torch.from_numpy(h)[None],
                          *p_nets.gru_inputs(p, torch.from_numpy(x)[None]))[0]
    np.testing.assert_allclose(p_h.numpy(), np.asarray(j_h), rtol=1e-5, atol=1e-6)
    # the port's init: flax's variable names, shapes and distributions
    g = torch.Generator().manual_seed(0)
    mine = p_nets.gru_init(2, 64, 64, g)
    assert {k: sorted(x) for k, x in mine.items()} == \
        {k: sorted(x) for k, x in _np(v["params"]).items()}
    for gate in "rzn":
        k = mine["h" + gate]["kernel"][0]
        np.testing.assert_allclose((k.T @ k).numpy(), np.eye(64), atol=1e-5)
        assert float(mine["i" + gate]["kernel"].std()) == pytest.approx(64 ** -0.5, rel=0.1)
        assert not mine["i" + gate]["bias"].any()


def test_rnn_nets_match_flax():
    rng = np.random.default_rng(2)
    ja = j_nets.MarlActorRNN(act_dim=ACT, hidden_size=H, layer_n=1)
    jc = j_nets.MarlCriticRNN(hidden_size=H, layer_n=1)
    keys = jax.random.split(jax.random.PRNGKey(3), N)
    h1, m1 = jnp.zeros((1, H)), jnp.ones((1,))
    av = jax.vmap(lambda k: ja.init(k, jnp.zeros((1, OBS)), h1, m1))(keys)
    cv = jax.vmap(lambda k: jc.init(k, jnp.zeros((1, SHARE)), h1, m1))(keys)
    pa, pc = marl_params_from_flax(_np(av), _np(cv))
    obs = rng.normal(size=(N, E, OBS)).astype(np.float32)
    share = rng.normal(size=(N, E, SHARE)).astype(np.float32)
    h = rng.normal(size=(N, E, H)).astype(np.float32)
    mask = (rng.random(E) > 0.3).astype(np.float32)
    jm, js, jh = jax.vmap(ja.apply, in_axes=(0, 0, 0, None))(av, obs, h, mask)
    jv, jhc = jax.vmap(jc.apply, in_axes=(0, 0, 0, None))(cv, share, h, mask)
    pa_net = p_nets.MarlActorRNN(act_dim=ACT, hidden_size=H, layer_n=1)
    pc_net = p_nets.MarlCriticRNN(hidden_size=H, layer_n=1)
    t = torch.from_numpy
    pm, ps, ph = pa_net.apply(pa, t(obs), t(h), t(mask))
    pv, phc = pc_net.apply(pc, t(share), t(h), t(mask))
    for p, j in ((pm, jm), (ps, js), (ph, jh), (pv, jv), (phc, jhc)):
        assert p.dtype == torch.float32
        np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=1e-5, atol=1e-6)
    # the sequence form equals the step-by-step one
    L = 3
    obs_seq = rng.normal(size=(N, L, E, OBS)).astype(np.float32)
    mask_seq = (rng.random((1, L, E)) > 0.3).astype(np.float32)
    mean_seq, _ = pa_net.apply_seq(pa, t(obs_seq), t(h), t(mask_seq))
    hh = t(h)
    for i in range(L):
        m, _, hh = pa_net.apply(pa, t(obs_seq[:, i]), hh, t(mask_seq[0, i]))
        np.testing.assert_allclose(mean_seq[:, i].numpy(), m.numpy(), rtol=1e-6, atol=1e-7)
    # the port's init has the flax layout
    g = torch.Generator().manual_seed(0)
    assert tree_map(lambda x: tuple(x.shape), pa_net.init(N, OBS, g)) == \
        tree_map(lambda x: tuple(x.shape), pa)


# ---------------------------------------------------------------- chunks
def _jax_closure(runner, name):
    fn = runner._train_iter.__wrapped__
    return dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))[name]


def test_chunk_layout_matches_jax():
    cfg = JConfig(algorithm_name="mappo", episode_length=T, hidden_size=H, layer_n=1,
                  use_recurrent_policy=True, data_chunk_length=2)
    jr = JRunner(TeamEnv(), num_envs=E, cfg=cfg, seed=0, print_log=False)
    to_chunks, chunk_starts = _jax_closure(jr, "to_chunks"), _jax_closure(jr, "chunk_starts")
    x = np.arange(T * E * 5, dtype=np.float32).reshape(T, E, 5)
    got = p_rec.to_chunks(torch.from_numpy(x)[None], 2)[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(to_chunks(x)))
    assert got.shape == (2, (T // 2) * E, 5)
    assert float(got[1, E + 3, 0]) == x[3, 3, 0]          # chunk 1 of env 3, its 2nd step
    h = np.arange(T * E * H, dtype=np.float32).reshape(T, E, H)
    np.testing.assert_array_equal(p_rec.chunk_starts(torch.from_numpy(h)[None], 2)[0].numpy(),
                                  np.asarray(chunk_starts(h, h[0])))


def test_bad_chunk_length_rejected():
    cfg = dataclasses.replace(PConfig(), episode_length=4, hidden_size=H, layer_n=1,
                              use_recurrent_policy=True, data_chunk_length=3)
    with pytest.raises(ValueError, match="data_chunk_length"):
        p_rec.RecurrentMarlRunner(PTeamEnv(), E, cfg, device="cpu", print_log=False)


# ------------------------------------------------------------ iteration
CASES = {"mappo_whole": dict(algorithm_name="mappo", data_chunk_length=None),
         "mappo_L2": dict(algorithm_name="mappo", data_chunk_length=2),
         "happo_L2_mb2": dict(algorithm_name="happo", data_chunk_length=2, num_mini_batch=2)}
NOISE = RNG.standard_normal((E, N, ACT)).astype(np.float32)
AGENT_PERM = np.array([2, 0, 1], np.int32)
CHUNK_PERM = RNG.permutation((T // 2) * E).astype(np.int32)


def _cfgs(**kw):
    base = dict(episode_length=T, ppo_epoch=2, hidden_size=H, layer_n=1,
                use_recurrent_policy=True, **kw)
    return JConfig(**base), dataclasses.replace(PConfig(), **base)


def _hiddens(seed):
    return np.random.default_rng(seed).normal(0, 0.5, (E, N, H)).astype(np.float32)


def _jax_iteration(jcfg, monkeypatch):
    jr = JRunner(TeamEnv(), num_envs=E, cfg=jcfg, seed=0, print_log=False)
    ts = start_state(jr.init_state())
    ts = ts.replace(actor_h=jnp.asarray(_hiddens(1)), critic_h=jnp.asarray(_hiddens(2)))
    with monkeypatch.context() as m:
        m.setattr(jax.random, "normal",
                  lambda key, shape=(), dtype=None: jnp.asarray(NOISE).reshape(shape))
        m.setattr(jax.random, "uniform", lambda key, shape=(), *a, **k: jnp.asarray(FRESH))
        m.setattr(jax.random, "permutation",
                  lambda key, x, *a, **k: jnp.asarray(AGENT_PERM if x == N else CHUNK_PERM))
        new, metrics = jr._train_iter(ts)
    return ts, new, {k: float(v) for k, v in metrics.items()}


def _port_runner(pcfg, ts, env=None):
    r = p_rec.RecurrentMarlRunner(env or PTeamEnv(), E, pcfg, seed=0, device="cpu",
                                  print_log=False)
    st = r.init_state()
    _copy_params(st.actor_params, _np(ts.actor_params["params"]))
    _copy_params(st.critic_params, _np(ts.critic_params["params"]))
    st.env_state = port_env_state(ts.env_state)
    st.actor_h = torch.from_numpy(np.array(ts.actor_h)).transpose(0, 1).contiguous()
    st.critic_h = torch.from_numpy(np.array(ts.critic_h)).transpose(0, 1).contiguous()
    r._normal = lambda shape: torch.from_numpy(NOISE).reshape(shape)
    r._chunk_perm = lambda C: torch.from_numpy(CHUNK_PERM).long()
    return r


def _assert_params_close(j_tree, p_tree, before, steps, tag):
    diffs = []

    def one(j, p, b):
        j = torch.from_numpy(np.array(j, np.float32))
        d = (p - j).abs()
        assert float(d.max()) <= 3 * LR * steps, f"{tag}: {float(d.max())}"
        assert float((j - b).abs().max()) > 0.5 * LR, f"{tag}: did not move"
        diffs.append(d.reshape(-1))
    tree_map(lambda p, j, b: one(j, p, b), p_tree, _np(j_tree), before)
    assert float(torch.cat(diffs).median()) < 0.1 * LR, tag


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_iteration_matches_jax(case, monkeypatch):
    jcfg, pcfg = _cfgs(**CASES[case])
    ts, new, j_m = _jax_iteration(jcfg, monkeypatch)
    r = _port_runner(pcfg, ts)
    before = (tree_map(torch.clone, r.state.actor_params),
              tree_map(torch.clone, r.state.critic_params))
    traj = r.rollout_phase()
    assert traj["mask"].min() == 0 and traj["done"].any()      # an episode ends inside
    assert ("ah" in traj) == (CASES[case]["data_chunk_length"] is not None)
    perm = AGENT_PERM.tolist() if r.is_happo else None
    p_m = {k: float(v) for k, v in r.update_phase(traj, r.state.env_state.obs, perm=perm).items()}
    assert p_m["mean_reward"] == pytest.approx(j_m["mean_reward"], abs=1e-5)
    for k in ("value_loss", "policy_loss"):
        assert p_m[k] == pytest.approx(j_m[k], rel=0.15, abs=0.05), (k, p_m[k], j_m[k])
    assert p_m["episodes_done"] == j_m["episodes_done"] > 0
    assert p_m["episode_rewards"] == pytest.approx(j_m["episode_rewards"], rel=1e-4)
    for name, j in (("actor_h", new.actor_h), ("critic_h", new.critic_h)):
        np.testing.assert_allclose(getattr(r.state, name).transpose(0, 1).numpy(),
                                   np.asarray(j), rtol=0, atol=1e-2, err_msg=name)
    for name in ("mean", "mean_sq", "debias"):
        np.testing.assert_allclose(getattr(r.state.vnorm, name).numpy(),
                                   np.asarray(getattr(new.vnorm, name)), rtol=1e-3, err_msg=name)
    steps = pcfg.ppo_epoch * max(1, pcfg.num_mini_batch)
    assert r.state.actor_opt.count == r.state.critic_opt.count == [steps] * N
    _assert_params_close(new.actor_params["params"], r.state.actor_params, before[0], steps,
                         f"{case} actor")
    _assert_params_close(new.critic_params["params"], r.state.critic_params, before[1], steps,
                         f"{case} critic")
    assert r.state.iteration == int(new.iteration) == 1


# ------------------------------------------------------ eval, checkpoint
def test_eval_is_deterministic_and_independent_of_training():
    _, pcfg = _cfgs(algorithm_name="mappo", data_chunk_length=None)
    r = p_rec.RecurrentMarlRunner(PTimedTeam(fresh=None), 4, dataclasses.replace(
        pcfg, eval_episodes=4), seed=0, device="cpu", print_log=False)
    r.init_state()
    e1, e2 = r.eval(), r.eval()
    assert e1 == e2 and np.isfinite(e1)
    r.state.env_state = r.env.step_batch(r.state.env_state, torch.zeros(4, N * ACT))
    r.state.actor_h = torch.ones_like(r.state.actor_h)
    assert r.eval() == e1


def test_checkpoint_both_ways(tmp_path):
    from flax import serialization
    jcfg, pcfg = _cfgs(algorithm_name="mappo", data_chunk_length=2)
    jr = JRunner(TeamEnv(), num_envs=E, cfg=jcfg, seed=0, print_log=False)
    jr.state = jr.init_state()
    rnd = np.random.default_rng(4)
    jr.state = jr.state.replace(
        actor_params=jax.tree_util.tree_map(
            lambda x: jnp.asarray(rnd.normal(size=x.shape), x.dtype), jr.state.actor_params),
        iteration=jnp.asarray(7, jnp.int32))
    jpath = str(tmp_path / "jax.ckpt")
    jr.save(jpath)
    r = p_rec.RecurrentMarlRunner(PTeamEnv(), E, pcfg, seed=1, device="cpu", print_log=False)
    r.restore(jpath)
    assert r.state.iteration == 7
    tree_map(lambda p, j: np.testing.assert_array_equal(p.numpy(), j),
             r.state.actor_params, _np(jr.state.actor_params["params"]))
    tree_map(lambda p, j: np.testing.assert_array_equal(p.numpy(), j),
             r.state.critic_params, _np(jr.state.critic_params["params"]))
    assert "GRUCell_0" in r.state.actor_params and "GRUCell_0" in r.state.critic_params

    with torch.no_grad():
        for leaf in tree_leaves(r.state.critic_params):
            leaf.add_(torch.randn(leaf.shape, generator=torch.Generator().manual_seed(2)))
    r.state.iteration = 9
    ppath = str(tmp_path / "port.ckpt")
    r.save(ppath)
    back = JRunner(TeamEnv(), num_envs=E, cfg=jcfg, seed=3, print_log=False)
    back.restore(ppath)
    assert int(back.state.iteration) == 9
    tree_map(lambda p, j: np.testing.assert_array_equal(p.numpy(), j),
             r.state.critic_params, _np(back.state.critic_params["params"]))
    blob = open(ppath, "rb").read()
    assert serialization.msgpack_restore(blob)["actor_params"]["params"]["GRUCell_0"].keys() \
        == {"ir", "iz", "in", "hr", "hz", "hn"}


def test_port_tenant_iteration():
    env = TenAntEnv({"sim": {"substeps": 1}}, device="cpu")
    cfg = dataclasses.replace(PConfig(), episode_length=2, ppo_epoch=1, hidden_size=16,
                              use_recurrent_policy=True, algorithm_name="happo")
    r = p_rec.RecurrentMarlRunner(env, 2, cfg, seed=0, device="cpu", print_log=False)
    r.init_state()
    traj = r.rollout_phase()
    assert traj["obs"].shape == (2, 2, 10, 46) and traj["share"].shape == (2, 2, 388)
    assert traj["actions"].shape == (2, 2, 10, 8) and r.state.actor_h.shape == (10, 2, 16)
    m = r.update_phase(traj, r.state.env_state.obs)
    assert all(np.isfinite(float(v)) for v in m.values())
    assert not r.use_fused
