"""The port's off-policy trainers (DDPG, TD3, SAC) against the JAX
package's on the CPU.

Both sides hold the same parameters (the JAX init's, copied into the port's
trees of the same layout) and see the same random numbers: jax.random.normal
and jax.random.randint are stood in by functions that hand out queued numpy
draws in trace order, and the port's `_normal` / `_slots` hand out the same
draws in its call order.  Both networks are float32, so:
* OffPolicyConfig.from_cfg_train equals the JAX config on cfg/{sac,td3,
  ddpg}/config.yaml and on `ent_coef: auto`;
* the port's init has flax's shapes and draws from flax's lecun_normal
  (the kernels' std within 5% of the JAX init's, cut at two stds);
* squashed_sample's action and log-prob, _q_loss and _pi_loss (with the
  pi step's mean logp) agree with the JAX functions on numpy batches at
  rtol 1e-5;
* one training iteration (one env step on a scripted env, its ring write,
  one gradient step) from a ring pre-filled from numpy, whose write slot
  wraps to 0: the ring's contents bit for bit, ptr and count; q_loss at
  rtol 1e-4; every parameter after its one Adam step within 2 * lr with a
  median difference far below lr (the rule of
  tests/test_torch_ppo.py::test_one_adam_step_matches_jax); the targets
  after Polyak within (1 - polyak) of that; log_alpha under auto_alpha;
* TD3 with two gradient steps: pi moves on the first and not the second;
* the ring fills and wraps as tests/test_offpolicy.py:11-29 says.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from massive_marl_tpu.algos.rl import offpolicy as j_off
from massive_marl_tpu.envs.base import EnvState as JEnvState
from massive_marl_tpu_torch.algos.rl import offpolicy as p_off
from massive_marl_tpu_torch.envs.base import EnvState as PEnvState
from massive_marl_tpu_torch.utils import yaml_lite
from massive_marl_tpu_torch.utils.config import CFG_ROOT
from massive_marl_tpu_torch.utils.tree import tree_leaves, tree_map

E, OBS, ACT, R, B = 4, 6, 3, 6, 3
STEPS = 9
RNG = np.random.default_rng(5)
OBS_TAB = RNG.normal(0.0, 2.5, (STEPS, E, OBS)).astype(np.float32)
REW_TAB = RNG.normal(0.0, 1.0, (STEPS, E)).astype(np.float32)
DONE_TAB = RNG.random((STEPS, E)) < 0.3
SMALL = dict(hidden_nodes=32, hidden_layer=2, replay_size=R, batch_size=B, nsteps=1,
             noptepochs=1, nminibatches=1)
CASES = {"sac": dict(algo="sac"), "td3": dict(algo="td3"), "ddpg": dict(algo="ddpg"),
         "sac_auto_alpha": dict(algo="sac", auto_alpha=True)}


class JScripted:
    """Scripted env for the JAX trainer: obs, reward and done read from the
    tables at (progress + 1) mod STEPS."""
    num_agents, num_actions, num_obs = 1, ACT, OBS

    def reset(self, key):
        return JEnvState(pipeline=jnp.zeros(()), carry=jnp.zeros(()),
                         progress=jnp.asarray(0, jnp.int32), done=jnp.asarray(False), key=key,
                         obs=jnp.asarray(OBS_TAB[0, 0]), reward=jnp.asarray(0.0))

    def step_batch(self, state, actions):
        t = (state.progress[0] + 1) % STEPS
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
        t = (int(state.progress[0]) + 1) % STEPS
        return PEnvState(pipeline=(), carry=(), progress=state.progress + 1,
                         done=torch.from_numpy(DONE_TAB[t]), obs=torch.from_numpy(OBS_TAB[t]),
                         reward=torch.from_numpy(REW_TAB[t]))


class Draws:
    """Queued numpy draws handed out in order, cyclically (a retrace of the
    same program sees the same sequence)."""

    def __init__(self, arrays):
        self.arrays, self.i = list(arrays), 0

    def next(self, shape):
        a = self.arrays[self.i % len(self.arrays)]
        self.i += 1
        assert a.shape == tuple(shape), (a.shape, shape)
        return a


@pytest.fixture
def stand_in(monkeypatch):
    def install(normals, slots):
        n, s = Draws(normals), Draws(slots)
        monkeypatch.setattr(jax.random, "normal",
                            lambda key, shape=(), dtype=None: jnp.asarray(n.next(shape)))
        monkeypatch.setattr(jax.random, "randint",
                            lambda key, shape, minval, maxval, dtype=None: jnp.asarray(
                                s.next(shape)))
    return install


def _normals(algo, n_updates=1):
    """The normal draws of one env step and its gradient steps, in order."""
    shapes = [(E, ACT)]
    per_update = {"sac": 2, "td3": 1, "ddpg": 0}[algo]
    shapes += [(B * E, ACT)] * (per_update * n_updates)
    return [RNG.standard_normal(s).astype(np.float32) for s in shapes]


def _jax(case, **kw):
    cfg = j_off.OffPolicyConfig(**{**SMALL, **case, **kw})
    return j_off.OffPolicy(JScripted(), num_envs=E, cfg=cfg, seed=0, print_log=False)


def _port(case, **kw):
    return p_off.OffPolicy(PScripted(), E, p_off.OffPolicyConfig(**{**SMALL, **case, **kw}),
                           device="cpu", print_log=False)


def _to_torch(tree):
    return jax.tree_util.tree_map(lambda x: torch.from_numpy(np.array(x, np.float32)), tree)


def _pairs(port_tree, jax_tree):
    """(port leaf, JAX leaf) numpy pairs matched by key path."""
    out = []
    tree_map(lambda p, j: out.append((p.detach().float().numpy(), np.asarray(j, np.float32))),
             port_tree, jax_tree)
    return out


def _install(tr, params, target):
    """Copy JAX trees into the port state's leaves (same keys and shapes)."""
    st = tr.init_state()
    with torch.no_grad():
        tree_map(lambda a, b: a.copy_(b), st.params, _to_torch(params))
        tree_map(lambda a, b: a.copy_(b), st.target_params, _to_torch(target))
    return st


@pytest.mark.parametrize("algo", ["sac", "td3", "ddpg"])
def test_config_from_yaml_matches_jax(algo):
    cfg_train = yaml_lite.load(f"{CFG_ROOT}/{algo}/config.yaml")
    assert vars(p_off.OffPolicyConfig.from_cfg_train(cfg_train, algo)) == \
        vars(j_off.OffPolicyConfig.from_cfg_train(cfg_train, algo))
    auto = {"learn": {"ent_coef": "auto"}}
    got = p_off.OffPolicyConfig.from_cfg_train(auto, algo)
    assert vars(got) == vars(j_off.OffPolicyConfig.from_cfg_train(auto, algo))
    assert got.auto_alpha and got.ent_coef == 0.2


@pytest.mark.parametrize("name", list(CASES))
def test_init_has_flax_layout_and_distribution(name):
    jt, tr = _jax(CASES[name], hidden_nodes=256), _port(CASES[name], hidden_nodes=256)
    j_params = jt.init_state().params
    st = tr.init_state()
    j_shapes = jax.tree_util.tree_map(lambda x: tuple(x.shape), j_params)
    assert tree_map(lambda x: tuple(x.shape), st.params) == j_shapes
    for pl, jl in _pairs(st.params, j_params):
        if jl.ndim == 2 and jl.size >= 256 * 32:     # kernels large enough for a std
            np.testing.assert_allclose(pl.std(), jl.std(), rtol=0.05)
            assert np.abs(pl).max() <= 2 * np.sqrt(1.0 / jl.shape[0]) / 0.87962566 * (1 + 1e-6)
        elif jl.ndim == 1:
            np.testing.assert_array_equal(pl, jl)     # zero biases
    assert tree_map(lambda x: x.requires_grad, st.target_params) == \
        tree_map(lambda x: False, st.target_params)


def _batch():
    o = np.clip(RNG.normal(0, 2, (B * E, OBS)), -5, 5).astype(np.float32)
    return dict(obs=o, actions=RNG.uniform(-1, 1, (B * E, ACT)).astype(np.float32),
                rewards=RNG.normal(0, 1, B * E).astype(np.float32),
                next_obs=np.clip(o + RNG.normal(0, 0.3, o.shape), -5, 5).astype(np.float32),
                dones=(RNG.random(B * E) < 0.2).astype(np.float32))


@pytest.mark.parametrize("name", list(CASES))
def test_losses_match_jax(name, stand_in):
    case = CASES[name]
    jt, tr = _jax(case), _port(case)
    ts = jt.init_state()
    st = _install(tr, ts.params, ts.target_params)
    batch = _batch()
    normals = [RNG.standard_normal((B * E, ACT)).astype(np.float32) for _ in range(2)]
    stand_in(normals, [])
    q_params = {k: v for k, v in ts.params.items() if k.startswith("q")}
    j_q = float(jt._q_loss(q_params, ts.params, ts.target_params, batch, None))
    j_pi, j_logp = (float(x) for x in jt._pi_loss(ts.params["pi"], ts.params, batch, None))
    feed = Draws(normals)
    tr._normal = lambda shape: torch.from_numpy(feed.next(shape))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    p_q = float(tr._q_loss({k: v for k, v in st.params.items() if k.startswith("q")},
                           st.params, st.target_params, tb).detach())
    p_pi, p_logp = tr._pi_loss(st.params["pi"], st.params, tb)
    np.testing.assert_allclose(p_q, j_q, rtol=1e-5)
    np.testing.assert_allclose(float(p_pi.detach()), j_pi, rtol=1e-5)
    if case["algo"] == "sac":
        np.testing.assert_allclose(float(p_logp), j_logp, rtol=1e-5)
        mu = RNG.normal(0, 1, (B * E, ACT)).astype(np.float32)
        log_std = RNG.uniform(-3, 1.5, (B * E, ACT)).astype(np.float32)
        stand_in([normals[0]], [])
        j_a, j_lp = j_off.squashed_sample(None, jnp.asarray(mu), jnp.asarray(log_std))
        p_a, p_lp = p_off.squashed_sample(torch.from_numpy(mu), torch.from_numpy(log_std),
                                          torch.from_numpy(normals[0]))
        np.testing.assert_allclose(p_a.numpy(), np.asarray(j_a), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(p_lp.numpy(), np.asarray(j_lp), rtol=1e-5)


def _ring_np():
    bf = lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16))
    return dict(obs=bf(RNG.normal(0, 2, (R, E, OBS))), actions=bf(RNG.uniform(-1, 1, (R, E, ACT))),
                rewards=RNG.normal(0, 1, (R, E)).astype(np.float32),
                next_obs=bf(RNG.normal(0, 2, (R, E, OBS))),
                dones=(RNG.random((R, E)) < 0.2).astype(np.float32))


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, np.float32), tree)


@pytest.mark.parametrize("name", list(CASES))
def test_one_train_iteration_matches_jax(name, stand_in):
    case = CASES[name]
    cfg = j_off.OffPolicyConfig(**SMALL, **case)
    jt, tr = _jax(case), _port(case)
    ts = jt.init_state()
    ring = _ring_np()
    # the next write goes to the last slot, and ptr wraps to 0
    ts = ts.replace(
        replay=j_off.Replay(**{k: jnp.asarray(v) for k, v in ring.items()},
                            ptr=jnp.asarray(R - 1, jnp.int32), count=jnp.asarray(R - 1, jnp.int32)),
        env_state=JEnvState(pipeline=jnp.zeros(E), carry=jnp.zeros(E),
                            progress=jnp.zeros(E, jnp.int32), done=jnp.zeros(E, bool),
                            key=ts.env_state.key, obs=jnp.asarray(OBS_TAB[0]),
                            reward=jnp.zeros(E)))
    params0, target0 = _np_tree(ts.params), _np_tree(ts.target_params)
    st = _install(tr, params0, target0)
    for k, v in ring.items():
        getattr(st.replay, k).copy_(torch.from_numpy(v.astype(np.float32)))
    st.replay.ptr, st.replay.count = R - 1, R - 1

    normals = _normals(case["algo"])
    idx = RNG.integers(0, R, (B,)).astype(np.int32)
    stand_in(normals, [idx])
    j_ts, j_m = jt._train_iter(ts)
    feed = Draws(normals)
    tr._normal = lambda shape: torch.from_numpy(feed.next(shape))
    counts = []
    tr._slots = lambda count: (counts.append(count), torch.from_numpy(idx).long())[1]
    p_m = tr.train_iter()
    assert feed.i == len(normals) and counts == [R]

    jr, pr = j_ts.replay, st.replay
    for k in ring:
        a, b = getattr(pr, k), np.asarray(getattr(jr, k))
        assert a.dtype == (torch.bfloat16 if b.dtype != np.float32 else torch.float32), k
        np.testing.assert_array_equal(a.float().numpy(), b.astype(np.float32), err_msg=k)
    assert (pr.ptr, pr.count) == (int(jr.ptr), int(jr.count)) == (0, R)
    np.testing.assert_allclose(float(p_m["mean_reward"]), float(j_m["mean_reward"]), rtol=1e-6)
    np.testing.assert_allclose(float(p_m["q_loss"]), float(j_m["q_loss"]), rtol=1e-4)

    lr = cfg.lr
    j_params, j_target = _np_tree(j_ts.params), _np_tree(j_ts.target_params)
    diffs = []
    for key in ("pi", "q1", "q2"):
        if key not in j_params:
            continue
        for (pl, jl), (_, l0) in zip(_pairs(st.params[key], j_params[key]),
                                     _pairs(st.params[key], params0[key])):
            d = np.abs(pl - jl)
            assert d.max() <= 2 * lr * (1 + 1e-3), key
            assert np.abs(jl - l0).max() > 0.5 * lr, key          # the step moved it
            diffs.append(d.reshape(-1))
        for pl, jl in _pairs(st.target_params[key], j_target[key]):
            d = np.abs(pl - jl)
            assert d.max() <= (1 - cfg.polyak) * 2 * lr * (1 + 1e-3) + 1e-6 * np.abs(jl).max(), key
    assert np.median(np.concatenate(diffs)) < 0.05 * lr
    if case.get("auto_alpha"):
        j_la = float(j_params["alpha"]["log_alpha"])
        assert j_la != pytest.approx(float(np.log(0.2)), abs=1e-9)     # the dual step moved it
        np.testing.assert_allclose(float(st.params["alpha"]["log_alpha"]), j_la, atol=1e-7)
    assert tr.grad_steps == tr.pi_steps == 1 and st.update_count == int(j_ts.update_count) == 1


def test_td3_pi_moves_on_the_first_update_only():
    tr = _port({"algo": "td3"}, nminibatches=2)
    st = tr.init_state()
    for _ in range(B):
        tr.train_iter(update=False)
    snap = lambda tree: [t.detach().clone() for t in tree_leaves(tree)]
    moved = lambda a, b: any(not torch.equal(x, y) for x, y in zip(a, b))
    pi0, q0 = snap(st.params["pi"]), snap(st.params["q1"])
    tr._grad_update(st)
    pi1, q1 = snap(st.params["pi"]), snap(st.params["q1"])
    tr._grad_update(st)
    assert moved(pi0, pi1) and moved(q0, q1)
    assert not moved(pi1, snap(st.params["pi"])) and moved(q1, snap(st.params["q1"]))
    assert (st.update_count, tr.grad_steps, tr.pi_steps) == (2, 2, 1)
    tr.train_iter()                        # one env step, two gradient steps: pi once
    assert (tr.grad_steps, tr.pi_steps) == (4, 2)


@pytest.mark.parametrize("algo", ["sac", "td3", "ddpg"])
def test_ring_fills_and_wraps(algo):
    cfg = p_off.OffPolicyConfig(algo=algo, nsteps=4, noptepochs=1, nminibatches=1, replay_size=32,
                                batch_size=4, hidden_nodes=32, hidden_layer=2)
    tr = p_off.OffPolicy(PScripted(), E, cfg, device="cpu", print_log=False)
    st = tr.init_state()
    tr.train_iter(update=False)
    assert (st.replay.count, st.replay.ptr, tr.grad_steps) == (4, 4, 0)
    m = tr.train_iter()
    assert st.replay.count == 8 and np.isfinite(float(m["q_loss"])) and tr.grad_steps == 4
    for _ in range(8):
        tr.train_iter()
    assert (st.replay.count, st.replay.ptr) == (32, (4 + 9 * 4) % 32)
    assert st.replay.nbytes() == 32 * 4 * (2 * (2 * OBS + ACT) + 8)


def test_run_warms_up_then_trains():
    tr = _port({"algo": "sac"}, nsteps=2)
    tr.run(3)
    # batch_size 3 slots at 2 a step: iterations 0 and 1 collect, 2 trains
    assert (tr.state.iteration, tr.grad_steps) == (3, 2)
    assert tr.last_metrics["q_loss"] > 0 and all(np.isfinite(v) for v in tr.last_metrics.values())
