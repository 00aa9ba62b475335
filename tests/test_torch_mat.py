"""The port's MAT (algos/marl/mat.py) against the JAX package's on the CPU.

Everything in MAT is float32, so the model agrees with flax to float32
rounding:
* MatConfig.from_cfg_train equals JAX's on cfg/mat/config.yaml;
* the port's init has the flax variable layout and shapes, flax's
  distributions (lecun_normal kernels, the head orthogonal(0.01),
  log_std = log 0.5, LayerNorms at one and zero);
* the encoder and the full causal decoder at bridged parameters against
  flax within 1e-5 of each output's scale (two heads, so the attention's
  split is checked);
* the port's cached decode against its own full decode (the loop of
  tests/test_algo_zoo.py::test_mat_cached_decode_matches_full) and each
  cached step against JAX's decode_step within 1e-5 of its scale;
* one iteration (rollout on the team env twin of
  tests/test_torch_recurrent.py, GAE, 5 full-batch Adam steps) against
  JAX's jitted _train_iter, jax.random.normal stood in by one [E, act]
  draw (traced once, so it serves every agent and step; the port's
  `_normal` hands out the same) and the auto-reset's uniform draw by
  FRESH: the mean reward and both losses at rel 1e-5, the ValueNorm
  statistics within 1e-5 of their scale, every parameter within 2 * lr of
  JAX's after its 5 steps;
* eval is deterministic and does not depend on the training envs
  (tests/test_algo_zoo.py::test_mat_eval_episode_faithful);
* a file written by the JAX runner's save restores in the port bit for
  bit, and the port's file in the JAX runner; a MADDPG file is refused;
* one iteration on the port's TenAnt (N = 10, obs 46, act 8).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from massive_marl_tpu.algos.marl import mat as j_mat
from massive_marl_tpu_torch.algos.marl import mat as p_mat
from massive_marl_tpu_torch.envs.ten_ant import TenAntEnv
from massive_marl_tpu_torch.utils import bridge, yaml_lite
from massive_marl_tpu_torch.utils.config import CFG_ROOT
from massive_marl_tpu_torch.utils.tree import tree_leaves, tree_map
from tests.test_marl import TeamEnv
from tests.test_torch_recurrent import (FRESH, PTeamEnv, PTimedTeam, port_env_state,
                                        start_state)

N, ACT, OBS = 3, 2, 6
E, T = 8, 4
LR = 5e-4
SMALL = dict(episode_length=T, ppo_epoch=5, embed=16, blocks=2, heads=2)
NOISE = np.random.default_rng(7).standard_normal((E, ACT)).astype(np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(p, j, rel=1e-5, msg=""):
    """Within rel of the reference's scale (its largest magnitude)."""
    j = np.asarray(j)
    np.testing.assert_allclose(p.detach().numpy(), j, rtol=0,
                               atol=rel * max(float(np.abs(j).max()), 1e-30), err_msg=msg)


def test_config_from_yaml_matches_jax():
    cfg_train = yaml_lite.load(f"{CFG_ROOT}/mat/config.yaml")
    got = vars(p_mat.MatConfig.from_cfg_train(cfg_train))
    assert got == vars(j_mat.MatConfig.from_cfg_train(cfg_train))
    assert (got["embed"], got["blocks"], got["heads"], got["max_grad_norm"]) == (64, 2, 1, 10.0)
    assert vars(p_mat.MatConfig.from_cfg_train(None)) == vars(p_mat.MatConfig())


@pytest.fixture(scope="module")
def jax_model():
    model = j_mat.MatModel(ACT, 16, 2, 2)
    v = model.init(jax.random.PRNGKey(0), jnp.zeros((1, N, OBS)), jnp.zeros((1, N, ACT)))
    return model, _np(v)


def test_init_layout_and_distributions(jax_model):
    _, v = jax_model
    mine = p_mat.MatModel(ACT, 16, 2, 2).init(OBS, torch.Generator().manual_seed(0))
    shapes = lambda t: {k: shapes(x) if isinstance(x, dict) else tuple(np.shape(x))
                        for k, x in t.items()}
    assert shapes(mine) == shapes(v)          # the same keys and shapes at every level
    big = p_mat.MatModel(8, 64, 2, 1).init(46, torch.Generator().manual_seed(1))["params"]
    dec, enc = big["decoder"], big["encoder"]
    head = dec["head"]["kernel"]
    np.testing.assert_allclose((head.T @ head).numpy(), 1e-4 * np.eye(8), atol=1e-9)
    assert torch.equal(dec["log_std"], torch.full((8,), float(np.log(0.5))))
    assert float(enc["Block_0"]["fc1"]["kernel"].std()) == pytest.approx(64 ** -0.5, rel=0.05)
    assert float(enc["Dense_0"]["kernel"].std()) == pytest.approx(46 ** -0.5, rel=0.1)
    assert torch.equal(enc["LayerNorm_0"]["scale"], torch.ones(46))
    assert not enc["Block_1"]["attn"]["wo"]["bias"].any()


def test_encoder_and_decoder_match_flax(jax_model):
    model, v = jax_model
    rng = np.random.default_rng(1)
    obs = rng.normal(0, 2, (5, N, OBS)).astype(np.float32)
    prev = rng.normal(0, 1, (5, N, ACT)).astype(np.float32)
    pm = p_mat.MatModel(ACT, 16, 2, 2)
    params = bridge.mat_params_from_flax(v)
    rep_p, val_p = pm.encode(params, torch.from_numpy(obs))
    rep_j, val_j = model.apply(v, obs, method=j_mat.MatModel.encode)
    _close(rep_p, rep_j, msg="repr")
    _close(val_p, val_j, msg="values")
    mean_p, std_p = pm.decode(params, rep_p, torch.from_numpy(prev))
    mean_j, std_j = model.apply(v, rep_j, prev, method=j_mat.MatModel.decode)
    _close(mean_p, mean_j, msg="mean")
    _close(std_p, std_j, msg="std")
    assert std_p.shape == (5, N, ACT)


def test_cached_decode_matches_full_and_jax(jax_model):
    model, v = jax_model
    cfg = p_mat.MatConfig(**SMALL)
    r = p_mat.MatRunner(PTeamEnv(), 5, cfg, device="cpu", print_log=False)
    params = bridge.mat_params_from_flax(v)
    draws = np.random.default_rng(3).standard_normal((N, 5, ACT)).astype(np.float32)
    it = iter(draws)
    r._normal = lambda shape: torch.from_numpy(next(it))
    obs = np.random.default_rng(4).normal(0, 2, (5, N, OBS)).astype(np.float32)
    rep, _ = r.model.encode(params, torch.from_numpy(obs))
    with torch.no_grad():
        actions, mean, std = r.decode_autoregressive(params, rep)
        ref = torch.zeros(5, N, ACT)
        for i in range(N):                       # the full decoder per agent
            prev = torch.cat([torch.zeros(5, 1, ACT), ref[:, :-1]], 1)
            m_full, s_full = r.model.decode(params, rep, prev)
            ref[:, i] = m_full[:, i] + s_full[:, i] * torch.from_numpy(draws[i])
    np.testing.assert_allclose(actions.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mean.numpy(), m_full.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(std.numpy(), s_full.numpy(), rtol=0, atol=0)
    # each cached step against JAX's decode_step from the same caches
    rep_np = rep.numpy()
    caches = tuple((jnp.zeros((5, N, 2, 8)), jnp.zeros((5, N, 2, 8))) for _ in range(2))
    prev = np.zeros((5, ACT), np.float32)
    for i in range(N):
        m_j, s_j, caches = model.apply(v, rep_np[:, i:i + 1], prev[:, None], caches, i,
                                       method=j_mat.MatModel.decode_step)
        _close(mean[:, i], m_j, msg=f"cached step {i}")
        _close(std[0, 0], s_j)
        prev = actions[:, i].numpy()


# ------------------------------------------------------------ iteration
def _jax_runner(env, cfg=None, seed=0):
    return j_mat.MatRunner(env, num_envs=E, cfg=cfg or j_mat.MatConfig(**SMALL), seed=seed,
                           print_log=False)


def _port_runner(env, params, cfg=None, seed=0):
    r = p_mat.MatRunner(env, E, cfg or p_mat.MatConfig(**SMALL), seed=seed, device="cpu",
                        print_log=False)
    st = r.init_state()
    with torch.no_grad():
        tree_map(lambda d, s: d.copy_(s), st.params, bridge.mat_params_from_flax(_np(params)))
    return r


def test_one_iteration_matches_jax(monkeypatch):
    jr = _jax_runner(TeamEnv())
    ts = start_state(jr.init_state())
    with monkeypatch.context() as m:
        m.setattr(jax.random, "normal",
                  lambda key, shape=(), dtype=None: jnp.asarray(NOISE).reshape(shape))
        m.setattr(jax.random, "uniform", lambda key, shape=(), *a, **k: jnp.asarray(FRESH))
        new, j_m = jr._train_iter(ts)
    j_m = {k: float(x) for k, x in j_m.items()}
    r = _port_runner(PTeamEnv(), ts.params)
    r.state.env_state = port_env_state(ts.env_state)
    r._normal = lambda shape: torch.from_numpy(NOISE).reshape(shape)
    traj = r.rollout_phase()
    assert traj["done"].any()
    p_m = {k: float(x) for k, x in r.update_phase(traj, r.state.env_state.obs).items()}
    for k in ("mean_reward", "policy_loss", "value_loss", "episode_rewards"):
        assert p_m[k] == pytest.approx(j_m[k], rel=1e-5, abs=1e-7), (k, p_m[k], j_m[k])
    assert p_m["episodes_done"] == j_m["episodes_done"] > 0
    for name in ("mean", "mean_sq", "debias"):
        _close(getattr(r.state.vnorm, name), getattr(new.vnorm, name), msg=name)
    assert r.state.opt.count == 5 and r.state.iteration == int(new.iteration) == 1
    moved = []

    def one(p, j, b):
        d = float((p - torch.from_numpy(np.array(j))).abs().max())
        assert d <= 2 * LR, d
        moved.append(float((p - b).abs().max()))
    before = bridge.mat_params_from_flax(_np(ts.params))
    tree_map(one, r.state.params, _np(new.params), before)
    assert max(moved) > 2 * LR


def test_eval_episode_faithful():
    cfg = p_mat.MatConfig(episode_length=T, ppo_epoch=1, embed=16, blocks=1)
    r = p_mat.MatRunner(PTimedTeam(fresh=None), 4, cfg, seed=0, device="cpu", print_log=False)
    r.init_state()
    e1, e2 = r.eval(), r.eval()
    assert e1 == e2 and np.isfinite(e1)
    r.state.env_state = r.env.step_batch(r.state.env_state, torch.zeros(4, N * ACT))
    assert r.eval() == e1


def test_checkpoint_both_ways(tmp_path):
    jr = _jax_runner(TeamEnv())
    jr.state = jr.init_state()
    rnd = np.random.default_rng(6)
    jr.state = jr.state.replace(params=jax.tree_util.tree_map(
        lambda x: jnp.asarray(rnd.normal(size=x.shape), x.dtype), jr.state.params),
        iteration=jnp.asarray(4, jnp.int32))
    jpath = str(tmp_path / "mat_4.ckpt")
    jr.save(jpath)
    r = p_mat.MatRunner(PTeamEnv(), E, p_mat.MatConfig(**SMALL), seed=1, device="cpu",
                        print_log=False)
    r.restore(jpath)
    assert r.state.iteration == 4
    tree_map(lambda p, j: np.testing.assert_array_equal(p.numpy(), j), r.state.params,
             _np(jr.state.params))
    with torch.no_grad():
        for leaf in tree_leaves(r.state.params):
            leaf.mul_(1.5)
    r.state.iteration = 6
    ppath = str(tmp_path / "mat_6.ckpt")
    r.save(ppath)
    back = _jax_runner(TeamEnv(), seed=2)
    back.restore(ppath)
    assert int(back.state.iteration) == 6
    tree_map(lambda p, j: np.testing.assert_array_equal(p.numpy(), j), r.state.params,
             _np(back.state.params))
    from massive_marl_tpu_torch.algos.marl.maddpg import MaddpgConfig, MaddpgRunner
    other = MaddpgRunner(PTeamEnv(), 2, MaddpgConfig(replay_size=2, hidden=8, layers=1),
                         device="cpu", print_log=False)
    other.init_state()
    other.save(str(tmp_path / "maddpg.ckpt"))
    with pytest.raises(ValueError, match="MAT checkpoint"):
        r.restore(str(tmp_path / "maddpg.ckpt"))


def test_port_tenant_iteration():
    env = TenAntEnv({"sim": {"substeps": 1}}, device="cpu")
    cfg = p_mat.MatConfig(episode_length=2, ppo_epoch=1, embed=16)
    r = p_mat.MatRunner(env, 2, cfg, seed=0, device="cpu", print_log=False)
    r.init_state()
    traj = r.rollout_phase()
    assert traj["obs"].shape == (2, 2, 10, 46) and traj["actions"].shape == (2, 2, 10, 8)
    assert r.obs_dim == 46
    m = r.update_phase(traj, r.state.env_state.obs)
    assert all(np.isfinite(float(x)) for x in m.values())
    assert dataclasses.asdict(r.cfg)["embed"] == 16
