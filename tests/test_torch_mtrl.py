"""The port's multi-task trainers (MTPPO, MTTRPO, MTSAC, the random runner)
against the JAX package's on the CPU.

Two scripted envs of different widths (obs 5 / act 2 and obs 7 / act 3),
written here for both frameworks as tests/test_torch_trpo.py's are: obs,
reward and done come from numpy tables indexed by (progress + 1) mod STEPS.
JAX draws inside jitted scans, so a stand-in for jax.random.normal /
uniform / randint is called once per traced body: one numpy draw serves
every step of a collect, and the port's `_normal` / `_uniform` / `_slots`
hand out the same draws.
* `_aug_obs` pads and appends the one-hot (or not, in "vanilla") exactly as
  the JAX trainer does; MTPPOConfig, MTTRPOConfig and MTSACConfig from
  cfg/ equal JAX's field for field.
* One MTPPO iteration (each task's `_collect`, then `_update`, noptepochs
  2) from bridged parameters: the joined batch's obs bit for bit, the
  per-task mean rewards at rtol 1e-6, the value loss at rtol 2e-2 (the
  bf16 towers round at different places), every parameter within 5 * lr
  of JAX's with a median difference below 0.05 * lr (the rule of
  tests/test_torch_ppo.py::test_one_adam_step_matches_jax).
* One MTTRPO update on the same kind of batch: the TRPO step over the
  whole ActorCritic moves only the actor and log_std, within 1% of the step's
  size (the TRPO/HATRPO precedent); the critic after vf_epochs 5 Adam steps
  within 5 * lr, median below 0.05 * lr; the value loss at rtol 2e-2.
* MTSAC: the shared float32 ring after one collect per task, bit for bit
  for obs, rewards, dones and next_obs; the actions (tanh of a float32
  MLP whose products the two frameworks sum in their own orders) at rtol
  1e-6 + atol 1e-6; then one gradient step from a numpy-filled ring: q_loss at
  rtol 1e-4, every parameter within 2 * lr with a median below 0.05 * lr,
  the targets within (1 - polyak) of that.
* RandomPolicyRunner: per-task means (rewards that depend on the actions)
  equal JAX's at rtol 1e-6, and are finite.
* MTPPO.run on the port's scripted envs saves model_<it>.ckpt; MTPPO,
  MTTRPO and MAMLPPO files are the JAX trainers' own: either package
  restores the other's bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from massive_marl_tpu.algos.mtrl import mtppo as j_mtppo
from massive_marl_tpu.algos.mtrl import mtsac as j_mtsac
from massive_marl_tpu.algos.mtrl import mttrpo as j_mttrpo
from massive_marl_tpu.envs.base import EnvState as JEnvState
from massive_marl_tpu_torch.algos.mtrl import mtppo as p_mtppo
from massive_marl_tpu_torch.algos.mtrl import mtsac as p_mtsac
from massive_marl_tpu_torch.algos.mtrl import mttrpo as p_mttrpo
from massive_marl_tpu_torch.envs.base import EnvState as PEnvState
from massive_marl_tpu_torch.utils import bridge, yaml_lite
from massive_marl_tpu_torch.utils.config import CFG_ROOT
from massive_marl_tpu_torch.utils.tree import tree_map

T, E, STEPS = 8, 8, 11
WIDTHS = {"a": (5, 2), "b": (7, 3)}
HIDDEN = (32, 32)
LR = 3e-4
RNG = np.random.default_rng(12)
TABLES = {t: dict(obs=RNG.normal(0.0, 2.0, (STEPS, E, o)).astype(np.float32),
                  rew=RNG.normal(0.3, 1.0, (STEPS, E)).astype(np.float32),
                  done=RNG.random((STEPS, E)) < 0.15)
          for t, (o, _) in WIDTHS.items()}
MAX_ACT = max(a for _, a in WIDTHS.values())
NOISE = RNG.standard_normal((E, MAX_ACT)).astype(np.float32)


class JScripted:
    """A scripted env for the JAX trainers; reward = table - action_cost x
    |a|^2."""
    num_agents = 1

    def __init__(self, task, action_cost=0.0):
        self.tab = TABLES[task]
        self.num_obs, self.num_actions = WIDTHS[task]
        self.action_cost = action_cost

    def reset(self, key):
        return JEnvState(pipeline=jnp.zeros(()), carry=jnp.zeros(()),
                         progress=jnp.asarray(0, jnp.int32), done=jnp.asarray(False), key=key,
                         obs=jnp.asarray(self.tab["obs"][0, 0]), reward=jnp.asarray(0.0))

    def step_batch(self, state, actions):
        t = (state.progress[0] + 1) % STEPS
        reward = jnp.asarray(self.tab["rew"])[t] - self.action_cost * jnp.sum(actions ** 2, -1)
        return state.replace(progress=state.progress + 1, obs=jnp.asarray(self.tab["obs"])[t],
                             reward=reward, done=jnp.asarray(self.tab["done"])[t])


class PScripted:
    num_agents = 1
    device = torch.device("cpu")

    def __init__(self, task, action_cost=0.0):
        self.tab = TABLES[task]
        self.num_obs, self.num_actions = WIDTHS[task]
        self.action_cost = action_cost

    def reset(self, num_envs):
        return PEnvState(pipeline=(), carry=(), progress=torch.zeros(num_envs, dtype=torch.int32),
                         done=torch.zeros(num_envs, dtype=torch.bool),
                         obs=torch.from_numpy(self.tab["obs"][0]), reward=torch.zeros(num_envs))

    def step_batch(self, state, actions):
        t = (int(state.progress[0]) + 1) % STEPS
        reward = torch.from_numpy(self.tab["rew"][t]) - self.action_cost * torch.sum(
            actions ** 2, -1)
        return PEnvState(pipeline=(), carry=(), progress=state.progress + 1,
                         done=torch.from_numpy(self.tab["done"][t]),
                         obs=torch.from_numpy(self.tab["obs"][t]), reward=reward)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _fields(cfg):
    return dict(vars(cfg))


def _jenv_state(task):
    tab = TABLES[task]
    return JEnvState(pipeline=jnp.zeros(E), carry=jnp.zeros(E), progress=jnp.zeros(E, jnp.int32),
                     done=jnp.zeros(E, bool), key=jnp.zeros((E, 2), jnp.uint32),
                     obs=jnp.asarray(tab["obs"][0]), reward=jnp.zeros(E))


@pytest.fixture
def stand_in(monkeypatch):
    """jax.random.normal / uniform / randint -> fixed arrays by shape."""
    def install(normal=None, uniform=None, randint=None):
        if normal is not None:
            monkeypatch.setattr(jax.random, "normal",
                                lambda key, shape=(), dtype=None: jnp.asarray(normal(shape)))
        if uniform is not None:
            monkeypatch.setattr(jax.random, "uniform",
                                lambda key, shape=(), dtype=None, minval=0.0, maxval=1.0:
                                jnp.asarray(uniform(shape)))
        if randint is not None:
            monkeypatch.setattr(jax.random, "randint",
                                lambda key, shape, minval, maxval, dtype=None:
                                jnp.asarray(randint(shape)))
    return install


def _noise(shape):
    return NOISE[:, :shape[-1]].reshape(shape)


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("algo", ["mtppo", "mttrpo", "mtsac"])
def test_config_from_yaml_matches_jax(algo):
    cfg_train = yaml_lite.load(f"{CFG_ROOT}/{algo}/config.yaml")
    if algo == "mtsac":
        got = p_mtsac.MTSACConfig.from_cfg_train(cfg_train, "sac")
        assert _fields(got) == _fields(j_mtsac.MTSACConfig.from_cfg_train(cfg_train, "sac"))
        assert (got.hidden_nodes, got.hidden_layer, got.replay_size) == (1024, 3, 5000)
        return
    mod_p, mod_j = (p_mtppo, j_mtppo) if algo == "mtppo" else (p_mttrpo, j_mttrpo)
    name = "MTPPOConfig" if algo == "mtppo" else "MTTRPOConfig"
    got = getattr(mod_p, name).from_cfg_train(cfg_train)
    assert type(got).__name__ == name
    assert _fields(got) == _fields(getattr(mod_j, name).from_cfg_train(cfg_train))
    assert got.hidden == (1024, 1024, 512) and got.mode == "add-onehot"
    if algo == "mttrpo":
        # MTPPO's key map: cg_iters, cg_damping, max_kl, backtrack_* unread
        assert (got.cg_nsteps, got.damping, got.max_kl, got.backtrack_coeff,
                got.max_num_backtrack) == (10, 0.1, 0.016, 0.8, 10)


@pytest.mark.parametrize("mode", ["add-onehot", "vanilla"])
def test_aug_obs_matches_jax(mode):
    cfg = dict(hidden=HIDDEN, mode=mode)
    jt = j_mtppo.MTPPO({t: JScripted(t) for t in WIDTHS}, num_envs=E,
                       cfg=j_mtppo.MTPPOConfig(**cfg), print_log=False)
    pt = p_mtppo.MTPPO({t: PScripted(t) for t in WIDTHS}, E, p_mtppo.MTPPOConfig(**cfg),
                       device="cpu", print_log=False)
    assert pt.obs_dim == jt.obs_dim == 7 + (2 if mode == "add-onehot" else 0)
    for i, t in enumerate(sorted(WIDTHS)):
        x = TABLES[t]["obs"][:3]
        np.testing.assert_array_equal(pt._aug_obs(torch.from_numpy(x), i).numpy(),
                                      np.asarray(jt._aug_obs(jnp.asarray(x), i)))


# ------------------------------------------------------------------- MTPPO
def _jax_mt(cls, cfg_cls, **cfg):
    jt = cls({t: JScripted(t) for t in WIDTHS}, num_envs=E, cfg=cfg_cls(**cfg), seed=0,
             print_log=False)
    ts = jt.init_state()
    return jt, ts.replace(env_states={t: _jenv_state(t) for t in WIDTHS})


def _jax_iteration(jt, ts, stand_in):
    """Each task's jitted collect, then the jitted update."""
    stand_in(normal=_noise)
    batches, rews = [], {}
    key = ts.key
    for t in jt.task_names:
        _, key, batch, rews[t] = jt._collect[t](ts.env_states[t], key, ts.params)
        batches.append(batch)
    batch = jax.tree_util.tree_map(lambda *xs: jnp.concatenate(xs), *batches)
    params, _, vloss = jt._update(ts.params, ts.opt_state, ts.lr, batch)
    return _np(batch), {t: float(r) for t, r in rews.items()}, params, float(vloss)


def _port_mt(cls, cfg_cls, params, **cfg):
    pt = cls({t: PScripted(t) for t in WIDTHS}, E, cfg_cls(**cfg), device="cpu",
             print_log=False)
    pt.model.load_state_dict(bridge.actor_critic_from_flax(_np(params)))
    pt.init_state()
    pt._normal = lambda shape: torch.from_numpy(_noise(shape))
    return pt


def _close(p_sd, j_sd, keys, n_steps):
    diffs = []
    for k in keys:
        d = (p_sd[k] - j_sd[k]).abs()
        assert float(d.max()) <= n_steps * LR * (1 + 1e-3), k
        diffs.append(d.reshape(-1))
    assert float(torch.cat(diffs).median()) < 0.05 * LR


def test_mtppo_iteration_matches_jax(stand_in):
    cfg = dict(hidden=HIDDEN, nsteps=T, noptepochs=2)
    jt, ts = _jax_mt(j_mtppo.MTPPO, j_mtppo.MTPPOConfig, **cfg)
    j_batch, j_rews, j_params, j_vloss = _jax_iteration(jt, ts, stand_in)
    pt = _port_mt(p_mtppo.MTPPO, p_mtppo.MTPPOConfig, ts.params, **cfg)
    batch, rews = pt.collect_all()
    np.testing.assert_array_equal(batch["obs"].numpy(), j_batch["obs"])
    for t in WIDTHS:
        np.testing.assert_allclose(float(rews[t]), j_rews[t], rtol=1e-6)
    np.testing.assert_allclose(batch["adv"].numpy(), j_batch["adv"], rtol=2e-2, atol=2e-2)
    vloss = float(pt.update(batch))
    np.testing.assert_allclose(vloss, j_vloss, rtol=2e-2)
    j_sd = bridge.actor_critic_from_flax(_np(j_params))
    before = bridge.actor_critic_from_flax(_np(ts.params))
    p_sd = pt.model.state_dict()
    _close(p_sd, j_sd, j_sd, 5)
    assert all(float((j_sd[k] - before[k]).abs().max()) > 0.5 * LR for k in j_sd)


def test_mttrpo_update_matches_jax(stand_in):
    cfg = dict(hidden=HIDDEN, nsteps=T)
    jt, ts = _jax_mt(j_mttrpo.MTTRPO, j_mttrpo.MTTRPOConfig, **cfg)
    _, _, j_params, j_vloss = _jax_iteration(jt, ts, stand_in)
    pt = _port_mt(p_mttrpo.MTTRPO, p_mttrpo.MTTRPOConfig, ts.params, **cfg)
    vloss = float(pt.update(pt.collect_all()[0]))
    assert pt.last_search["accepted"] == 1 and pt.last_search["fvps"] == 11
    np.testing.assert_allclose(vloss, j_vloss, rtol=2e-2)
    before = bridge.actor_critic_from_flax(_np(ts.params))
    j_sd = bridge.actor_critic_from_flax(_np(j_params))
    p_sd = pt.model.state_dict()
    actor = sorted(k for k in j_sd if not k.startswith("critic"))
    step = lambda sd: torch.cat([(sd[k] - before[k]).reshape(-1) for k in actor])
    s_j, s_p = step(j_sd), step(p_sd)
    assert float(s_j.norm()) > 0
    assert float((s_p - s_j).norm() / s_j.norm()) < 0.01
    _close(p_sd, j_sd, [k for k in j_sd if k.startswith("critic")], 5)


# ------------------------------------------------------------------- MTSAC
SAC = dict(hidden_nodes=32, hidden_layer=2, replay_size=6, batch_size=3, nsteps=2,
           noptepochs=1, nminibatches=1)


def _jax_mtsac():
    jt = j_mtsac.MTSAC({t: JScripted(t) for t in WIDTHS}, num_envs=E,
                       cfg=j_mtsac.MTSACConfig(algo="sac", **SAC), seed=0, print_log=False)
    ts = jt.init_state()
    return jt, ts.replace(env_states={t: _jenv_state(t) for t in WIDTHS})


def _port_mtsac(ts):
    pt = p_mtsac.MTSAC({t: PScripted(t) for t in WIDTHS}, E,
                       p_mtsac.MTSACConfig(algo="sac", **SAC), device="cpu", print_log=False)
    st = pt.init_state()
    with torch.no_grad():
        for mine, theirs in ((st.params, ts.params), (st.target_params, ts.target_params)):
            tree_map(lambda a, b: a.copy_(b), mine, bridge.tree_from_flax(_np(theirs)))
    return pt


def test_mtsac_ring_after_collect_matches_jax(stand_in):
    jt, ts = _jax_mtsac()
    stand_in(normal=_noise)
    replay, key = ts.replay, ts.key
    for t in jt.task_names:
        _, replay, key, _ = jt._collect[t](ts.env_states[t], replay, ts.params, key)
    pt = _port_mtsac(ts)
    pt._normal = lambda shape: torch.from_numpy(_noise(shape))
    for t in pt.task_names:
        pt.collect(t)
    rp = pt.state.replay
    assert (rp.ptr, rp.count) == (int(replay["ptr"]), int(replay["count"])) == (4, 4)
    assert pt.obs_dim == 9 and rp.obs.dtype == torch.float32
    for k in ("obs", "rewards", "dones", "next_obs"):
        np.testing.assert_array_equal(getattr(rp, k).numpy(), np.asarray(replay[k]), err_msg=k)
    np.testing.assert_allclose(rp.actions.numpy(), np.asarray(replay["actions"]), rtol=1e-6,
                               atol=1e-6)


def test_mtsac_update_matches_jax(stand_in):
    jt, ts = _jax_mtsac()
    R, D, A = SAC["replay_size"], 9, MAX_ACT
    fill = dict(obs=RNG.normal(0, 1.5, (R, E, D)), actions=RNG.uniform(-1, 1, (R, E, A)),
                rewards=RNG.normal(0, 1, (R, E)), dones=(RNG.random((R, E)) < 0.2) * 1.0,
                next_obs=RNG.normal(0, 1.5, (R, E, D)))
    fill = {k: v.astype(np.float32) for k, v in fill.items()}
    idx = np.array([4, 0, 3], np.int32)
    B = SAC["batch_size"] * E
    draws = [RNG.standard_normal((B, A)).astype(np.float32) for _ in range(2)]
    it = iter(draws)
    stand_in(normal=lambda shape: next(it), randint=lambda shape: idx)
    replay = dict(ts.replay, **{k: jnp.asarray(v) for k, v in fill.items()},
                  ptr=jnp.asarray(5, jnp.int32), count=jnp.asarray(5, jnp.int32))
    params, tp, _, _, _, j_ql = jt._update(ts.params, ts.target_params, ts.opt_pi, ts.opt_q,
                                           replay, ts.key)
    pt = _port_mtsac(ts)
    rp = pt.state.replay
    for k, v in fill.items():
        getattr(rp, k).copy_(torch.from_numpy(v))
    rp.ptr = rp.count = 5
    pd = iter(draws)
    pt._normal = lambda shape: torch.from_numpy(next(pd))
    pt._slots = lambda count: torch.from_numpy(idx.astype(np.int64))
    ql = float(pt.grad_step())
    np.testing.assert_allclose(ql, float(j_ql), rtol=1e-4)
    pairs = []
    tree_map(lambda a, b: pairs.append((a.detach().numpy(), np.asarray(b))), pt.state.params,
             _np(params))
    diffs = np.concatenate([np.abs(a - b).reshape(-1) for a, b in pairs])
    assert diffs.max() <= 2 * LR * (1 + 1e-3) and np.median(diffs) < 0.05 * LR
    t_pairs = []
    tree_map(lambda a, b: t_pairs.append((a.numpy(), np.asarray(b))), pt.state.target_params,
             _np(tp))
    assert max(np.abs(a - b).max() for a, b in t_pairs) <= 0.01 * 2 * LR * (1 + 1e-3)


# ------------------------------------------------------------- random runner
def test_random_runner_matches_jax(stand_in):
    U = {t: RNG.uniform(-1, 1, (E, a)).astype(np.float32) for t, (_, a) in WIDTHS.items()}
    by_width = {a: U[t] for t, (_, a) in WIDTHS.items()}
    stand_in(uniform=lambda shape: by_width[shape[-1]])
    jr = j_mtppo.RandomPolicyRunner({t: JScripted(t, 0.5) for t in WIDTHS}, num_envs=E)
    j_res = jr.run(iterations=2, steps_per_iter=3)
    pr = p_mtppo.RandomPolicyRunner({t: PScripted(t, 0.5) for t in WIDTHS}, num_envs=E,
                                    device="cpu")
    pr._uniform = lambda shape: torch.from_numpy(by_width[shape[-1]])
    p_res = pr.run(iterations=2, steps_per_iter=3)
    assert list(p_res) == list(j_res) == ["a", "b"]
    for t in WIDTHS:
        assert np.isfinite(p_res[t])
        np.testing.assert_allclose(p_res[t], j_res[t], rtol=1e-6)


# ---------------------------------------------------------------- files
def _tree_equal(a, b):
    la = jax.tree_util.tree_leaves_with_path(a)
    lb = dict(jax.tree_util.tree_leaves_with_path(b))
    assert len(la) == len(lb)
    for path, x in la:
        np.testing.assert_array_equal(np.asarray(x), np.asarray(lb[path]))


@pytest.mark.parametrize("kind", ["mtppo", "mttrpo", "mamlppo"])
def test_checkpoints_both_ways(kind, tmp_path):
    from massive_marl_tpu.algos.metarl import maml as j_maml
    from massive_marl_tpu_torch.algos.metarl import maml as p_maml
    if kind == "mamlppo":
        from tests.test_ppo import ToyEnv
        from tests.test_torch_maml import PToy
        jt = j_maml.MAMLPPO(ToyEnv(), num_envs=4, cfg=j_maml.MAMLConfig(hidden=(16, 8)), seed=1,
                            print_log=False)
        pt = p_maml.MAMLPPO(PToy(), 4, p_maml.MAMLConfig(hidden=(16, 8)), device="cpu",
                            print_log=False)
    else:
        cls = {"mtppo": (j_mtppo.MTPPO, p_mtppo.MTPPO), "mttrpo": (j_mttrpo.MTTRPO,
                                                                   p_mttrpo.MTTRPO)}[kind]
        jt = cls[0]({t: JScripted(t) for t in WIDTHS}, num_envs=E, seed=1, print_log=False,
                    cfg=j_mtppo.MTPPOConfig(hidden=(16, 8)) if kind == "mtppo"
                    else j_mttrpo.MTTRPOConfig(hidden=(16, 8)))
        pt = cls[1]({t: PScripted(t) for t in WIDTHS}, E, device="cpu", print_log=False,
                    cfg=p_mtppo.MTPPOConfig(hidden=(16, 8)) if kind == "mtppo"
                    else p_mttrpo.MTTRPOConfig(hidden=(16, 8)))
    jt.state = jt.init_state().replace(iteration=jnp.asarray(7, jnp.int32))
    jt.save(str(tmp_path / "jax.ckpt"))
    pt.load(str(tmp_path / "jax.ckpt"))
    assert pt.state.iteration == 7
    ref = bridge.actor_critic_from_flax(_np(jt.state.params))
    for k, v in pt.model.state_dict().items():
        assert torch.equal(v, ref[k]), k
    with torch.no_grad():
        for p in pt.model.parameters():
            p.add_(0.125)
    pt.state.iteration = 9
    pt.save(str(tmp_path / "port.ckpt"))
    jt.load(str(tmp_path / "port.ckpt"))
    assert int(jt.state.iteration) == 9
    _tree_equal(jt.state.params, _np(bridge.actor_critic_to_flax(pt.model.state_dict())))
    with pytest.raises(ValueError):
        bridge.mtppo_state_from_flax({"params": {}, "iteration": 0})


def test_mtppo_run_saves_and_restores(tmp_path):
    pt = p_mtppo.MTPPO({t: PScripted(t) for t in WIDTHS}, E,
                       p_mtppo.MTPPOConfig(hidden=(16, 8), nsteps=4, noptepochs=1,
                                           save_interval=1),
                       device="cpu", print_log=False, log_dir=str(tmp_path))
    pt.run(2)
    assert pt.state.iteration == 2 and all(np.isfinite(v) for v in pt.last_metrics.values())
    assert set(pt.last_metrics) == {"reward_a", "reward_b", "value_loss"}
    other = p_mtppo.MTPPO({t: PScripted(t) for t in WIDTHS}, E,
                          p_mtppo.MTPPOConfig(hidden=(16, 8)), seed=3, device="cpu",
                          print_log=False)
    other.load(str(tmp_path / "model_2.ckpt"))
    assert other.state.iteration == 2
    for a, b in zip(other.model.parameters(), pt.model.parameters()):
        assert torch.equal(a, b)
