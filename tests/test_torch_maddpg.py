"""The port's MADDPG (algos/marl/maddpg.py) against the JAX package's on the
CPU.

Both sides hold the same parameters (the JAX init's, copied by key into the
port's trees of the same layout), start from the same team-env states (the
torch twin of tests/test_torch_recurrent.py, some envs ending their episode
inside the run) and see the same random numbers: jax.random.normal,
randint and uniform are stood in.  Each jitted iteration traces its env
step once, so one [E, N, act] normal draw serves every step of the
collect-only iteration and one other every step of the training
iteration, and one randint draw every gradient step; the port's `_normal`
and `_rows` hand out the same arrays.  The networks are float32, so:
* MaddpgConfig.from_cfg_train equals JAX's on cfg/maddpg/config.yaml;
* the port's init has flax's layout and lecun_normal distribution;
* two collect-only iterations fill the ring as JAX's: the bf16 obs,
  share, actions, next obs and share and the f32 dones bit for bit, the
  f32 rewards within 4 ulp (`_assert_ring_equal`), the same ptr and
  count;
* the training iteration that follows (its second ring write wraps to
  row 0): critic_loss at rel 1e-5; actors, critics and both target sets
  within 2 * lr of JAX's after the two gradient steps; the ring again;
* the ring wraps and keeps the newest rows;
* eval is deterministic and does not depend on the training envs
  (tests/test_algo_zoo.py::test_maddpg_eval_episode_faithful);
* a file written by the JAX runner's save restores in the port bit for
  bit, and the port's file in the JAX runner; a MAT file is refused;
* two iterations on the port's TenAnt (N = 10, obs 46, share 388, act 8):
  one collect-only, one training.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from massive_marl_tpu.algos.marl import maddpg as j_md
from massive_marl_tpu_torch.algos.marl import maddpg as p_md
from massive_marl_tpu_torch.envs.ten_ant import TenAntEnv
from massive_marl_tpu_torch.utils import bridge, yaml_lite
from massive_marl_tpu_torch.utils.config import CFG_ROOT
from massive_marl_tpu_torch.utils.tree import tree_leaves, tree_map
from tests.test_marl import TeamEnv
from tests.test_torch_recurrent import (FRESH, PTeamEnv, PTimedTeam, port_env_state,
                                        start_state)

N, ACT, OBS, SHARE = 3, 2, 6, 14
E = 8
SMALL = dict(nsteps=2, replay_size=5, batch_size=3, hidden=32, layers=2)
LR = 1e-4
RNG = np.random.default_rng(9)
NOISE_COLLECT = RNG.standard_normal((E, N, ACT)).astype(np.float32)
NOISE_TRAIN = RNG.standard_normal((E, N, ACT)).astype(np.float32)
ROWS = np.array([3, 0, 3], np.int32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_config_from_yaml_matches_jax():
    cfg_train = yaml_lite.load(f"{CFG_ROOT}/maddpg/config.yaml")
    got = vars(p_md.MaddpgConfig.from_cfg_train(cfg_train))
    assert got == vars(j_md.MaddpgConfig.from_cfg_train(cfg_train))
    assert (got["replay_size"], got["batch_size"], got["hidden"], got["lr"]) == \
        (10_000, 64, 256, 1e-4)
    assert vars(p_md.MaddpgConfig.from_cfg_train({})) == vars(p_md.MaddpgConfig())


def test_init_layout_and_distribution():
    jr = j_md.MaddpgRunner(TeamEnv(), num_envs=E, cfg=j_md.MaddpgConfig(**SMALL), seed=0,
                           print_log=False)
    ts = jr.init_state()
    r = p_md.MaddpgRunner(PTeamEnv(), E, p_md.MaddpgConfig(**SMALL), device="cpu",
                          print_log=False)
    actor, critic = r.init_params()
    shapes = lambda t: {k: shapes(x) if isinstance(x, dict) else tuple(np.shape(x))
                        for k, x in t.items()}
    assert shapes(actor) == shapes(_np(ts.actor_params))
    assert shapes(critic) == shapes(_np(ts.critic_params))
    big = p_md.init_stacked_mlp(10, [388 + 80, 256, 1], torch.Generator().manual_seed(0))
    k = big["params"]["Dense_0"]["kernel"]
    assert k.shape == (10, 468, 256)
    assert float(k.std()) == pytest.approx(468 ** -0.5, rel=0.05)
    assert float(k.abs().max()) <= 2 * 468 ** -0.5 / 0.8796 + 1e-6
    assert not big["params"]["Dense_1"]["bias"].any()


@pytest.fixture(scope="module")
def runs():
    """(JAX states: initial, after two collect-only iterations, after the
    training iteration; its metrics; the port runner after each step)."""
    jr = j_md.MaddpgRunner(TeamEnv(), num_envs=E, cfg=j_md.MaddpgConfig(**SMALL), seed=0,
                           print_log=False)
    ts0 = start_state(jr.init_state())
    mp = pytest.MonkeyPatch()
    noise = [NOISE_COLLECT]             # what a trace of the env step draws
    mp.setattr(jax.random, "normal",
               lambda key, shape=(), dtype=None: jnp.asarray(noise[0]).reshape(shape))
    mp.setattr(jax.random, "randint",
               lambda key, shape, minval, maxval, dtype=None: jnp.asarray(ROWS))
    mp.setattr(jax.random, "uniform", lambda key, shape=(), *a, **k: jnp.asarray(FRESH))
    try:
        ts1, _ = jr._collect_iter(ts0)
        ts1, _ = jr._collect_iter(ts1)
        noise[0] = NOISE_TRAIN
        # the training iteration donates its input
        ts2, m = jr._train_iter(jax.tree_util.tree_map(jnp.copy, ts1))
    finally:
        mp.undo()

    r = p_md.MaddpgRunner(PTeamEnv(), E, p_md.MaddpgConfig(**SMALL), seed=0, device="cpu",
                          print_log=False)
    st = r.init_state()
    for dst, src in ((st.actor_params, ts0.actor_params), (st.critic_params, ts0.critic_params),
                     (st.target_actor, ts0.target_actor), (st.target_critic, ts0.target_critic)):
        tree_map(lambda d, s: d.copy_(torch.from_numpy(np.array(s))), dst, _np(src))
    st.env_state = port_env_state(ts0.env_state)
    r._rows = lambda count: torch.from_numpy(ROWS).long()
    r._normal = lambda shape: torch.from_numpy(NOISE_COLLECT).reshape(shape)
    r.train_iter(update=False)
    r.train_iter(update=False)
    collected = [t.clone() for t in st.replay.tensors()], st.replay.ptr, st.replay.count
    r._normal = lambda shape: torch.from_numpy(NOISE_TRAIN).reshape(shape)
    p_m = r.train_iter(update=True)
    return ts1, ts2, {k: float(v) for k, v in m.items()}, r, collected, \
        {k: float(v) for k, v in p_m.items()}


def _assert_ring_equal(port_tensors, ptr, count, j_replay):
    """The bf16 rows and the dones bit for bit; the float32 rewards within
    4 ulp (the positions they come from moved by the actors' float32
    outputs, which XLA's tanh and products round differently from torch's
    in the last bit)."""
    names = ("obs", "share", "actions", "rewards", "next_obs", "next_share", "dones")
    for name, p in zip(names, port_tensors):
        j = np.asarray(getattr(j_replay, name))
        assert str(p.dtype).split(".")[-1] == str(j.dtype), name
        if name == "rewards":
            np.testing.assert_array_max_ulp(p.numpy(), j, maxulp=4)
        else:
            np.testing.assert_array_equal(p.float().numpy(), j.astype(np.float32),
                                          err_msg=name)
    assert (ptr, count) == (int(j_replay.ptr), int(j_replay.count))


def test_collect_iterations_fill_the_ring_bit_for_bit(runs):
    ts1, _, _, _, (tensors, ptr, count), _ = runs
    assert (ptr, count) == (4, 4)
    assert tensors[6][:4].any()                      # an episode ended
    _assert_ring_equal(tensors, ptr, count, ts1.replay)


def test_training_iteration_matches_jax(runs):
    _, ts2, j_m, r, _, p_m = runs
    st = r.state
    assert st.replay.ptr == 1 and st.replay.count == 5 and r.grad_steps == 2
    _assert_ring_equal(st.replay.tensors(), st.replay.ptr, st.replay.count, ts2.replay)
    assert p_m["mean_reward"] == pytest.approx(j_m["mean_reward"], rel=1e-6)
    assert p_m["critic_loss"] == pytest.approx(j_m["critic_loss"], rel=1e-5)
    moved = []
    for mine, theirs in ((st.actor_params, ts2.actor_params),
                         (st.critic_params, ts2.critic_params),
                         (st.target_actor, ts2.target_actor),
                         (st.target_critic, ts2.target_critic)):
        def one(p, j):
            assert float((p - torch.from_numpy(np.array(j))).abs().max()) <= 2 * LR
        tree_map(one, mine, _np(theirs))
    for p, j in zip(tree_leaves(st.actor_params), tree_leaves(st.target_actor)):
        moved.append(float((p - j).abs().max()))
    assert max(moved) > 0.5 * LR                     # the actors moved off their targets
    assert st.actor_opt.count == st.critic_opt.count == 2


def test_ring_wraps():
    cfg = p_md.MaddpgConfig(nsteps=2, replay_size=3, batch_size=2, hidden=8, layers=1)
    r = p_md.MaddpgRunner(PTeamEnv(fresh=None), 2, cfg, seed=0, device="cpu", print_log=False)
    r.run(3)
    rp = r.state.replay
    assert (rp.ptr, rp.count, r.state.iteration) == (0, 3, 3)
    assert r.grad_steps == 4                     # iterations 2 and 3 train
    obs = torch.clamp(r.state.env_state.obs, -7, 7)
    # the newest row (index 2) holds the last step's next obs
    np.testing.assert_array_equal(rp.next_share[2].float().numpy(),
                                  obs.to(torch.bfloat16).float().numpy())
    assert rp.nbytes() == 3 * 2 * (2 * (2 * (N * OBS) + 2 * SHARE + N * ACT) + 2 * 4)


def test_eval_episode_faithful():
    cfg = p_md.MaddpgConfig(nsteps=2, replay_size=16, batch_size=4, hidden=16, layers=2)
    r = p_md.MaddpgRunner(PTimedTeam(fresh=None), 4, cfg, seed=0, device="cpu",
                          print_log=False)
    r.init_state()
    e1, e2 = r.eval(), r.eval()
    assert e1 == e2 and np.isfinite(e1)
    r.state.env_state = r.env.step_batch(r.state.env_state, torch.zeros(4, N * ACT))
    assert r.eval() == e1


def test_checkpoint_both_ways(tmp_path):
    jr = j_md.MaddpgRunner(TeamEnv(), num_envs=E, cfg=j_md.MaddpgConfig(**SMALL), seed=0,
                           print_log=False)
    jr.state = jr.init_state()
    rnd = np.random.default_rng(5)
    noisy = lambda t: jax.tree_util.tree_map(
        lambda x: jnp.asarray(rnd.normal(size=x.shape), x.dtype), t)
    jr.state = jr.state.replace(actor_params=noisy(jr.state.actor_params),
                                critic_params=noisy(jr.state.critic_params),
                                iteration=jnp.asarray(12, jnp.int32))
    jpath = str(tmp_path / "maddpg_12.ckpt")
    jr.save(jpath)
    r = p_md.MaddpgRunner(PTeamEnv(), E, p_md.MaddpgConfig(**SMALL), seed=1, device="cpu",
                          print_log=False)
    r.restore(jpath)
    assert r.state.iteration == 12
    for mine, theirs in ((r.state.actor_params, jr.state.actor_params),
                         (r.state.critic_params, jr.state.critic_params)):
        tree_map(lambda p, j: np.testing.assert_array_equal(p.numpy(), j), mine, _np(theirs))
    with torch.no_grad():
        for leaf in tree_leaves(r.state.actor_params):
            leaf.mul_(-2.0)
    r.state.iteration = 13
    ppath = str(tmp_path / "maddpg_13.ckpt")
    r.save(ppath)
    back = j_md.MaddpgRunner(TeamEnv(), num_envs=E, cfg=j_md.MaddpgConfig(**SMALL), seed=2,
                             print_log=False)
    back.restore(ppath)
    assert int(back.state.iteration) == 13
    for mine, theirs in ((r.state.actor_params, back.state.actor_params),
                         (r.state.critic_params, back.state.critic_params)):
        tree_map(lambda p, j: np.testing.assert_array_equal(p.numpy(), j), mine, _np(theirs))
    from massive_marl_tpu_torch.algos.marl.mat import MatConfig, MatRunner
    other = MatRunner(PTeamEnv(), 2, MatConfig(embed=8, blocks=1), device="cpu",
                      print_log=False)
    other.init_state()
    other.save(str(tmp_path / "mat.ckpt"))
    with pytest.raises(ValueError, match="MADDPG checkpoint"):
        r.restore(str(tmp_path / "mat.ckpt"))


def test_port_tenant_iterations():
    env = TenAntEnv({"sim": {"substeps": 1}}, device="cpu")
    cfg = p_md.MaddpgConfig(nsteps=2, replay_size=4, batch_size=2, hidden=16, layers=1)
    r = p_md.MaddpgRunner(env, 2, cfg, seed=0, device="cpu", print_log=False)
    r.run(2)
    rp = r.state.replay
    assert rp.obs.shape == (4, 2, 10, 46) and rp.share.shape == (4, 2, 388)
    assert rp.actions.shape == (4, 2, 10, 8) and rp.obs.dtype == torch.bfloat16
    assert r.grad_steps == 2 and rp.count == 4
    assert all(np.isfinite(v) for v in r.last_metrics.values())
    assert all(torch.isfinite(p).all() for p in tree_leaves(r.state.critic_params))
    assert bridge.maddpg_params_to_flax(r.state.actor_params, r.state.critic_params)[0][
        "params"]["Dense_1"]["kernel"].shape == (10, 16, 8)
