"""The port's policy and PPO update against the JAX package on the CPU.

* ActorCritic with weights bridged from flax gives flax's (mean, value,
  log_std): rtol 2e-2, because both hidden towers compute in bf16.
* One trajectory, collected by the JAX rollout_phase (TenAnt, E=4, small
  widths), goes through both update_phases: the losses and the final
  adaptive lr agree; after exactly one Adam step the parameters agree.
* PPO.run of the port takes two iterations with finite losses, and the
  port's CLI trains TenAnt + PPO.
"""
import jax
import numpy as np
import pytest
import torch

from massive_marl_tpu.algos import nets as j_nets
from massive_marl_tpu.algos.rl.ppo import PPO as JPPO
from massive_marl_tpu.algos.rl.ppo import PPOConfig as JConfig
from massive_marl_tpu.envs.ten_ant import TenAntEnv as JTenAnt
from massive_marl_tpu_torch.algos import nets as p_nets
from massive_marl_tpu_torch.algos.rl.ppo import PPO as PPPO
from massive_marl_tpu_torch.algos.rl.ppo import PPOConfig as PConfig
from massive_marl_tpu_torch.envs.ten_ant import TenAntEnv as PTenAnt
from massive_marl_tpu_torch.utils.bridge import actor_critic_from_flax

HIDDEN = (64, 64)
ENV_CFG = {"sim": {"substeps": 1}}
E = 4


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_bridged_actor_critic_matches_flax():
    model = j_nets.ActorCritic(act_dim=80, hidden_actor=HIDDEN, hidden_critic=HIDDEN)
    params = model.init(jax.random.PRNGKey(0), np.zeros((1, 388), np.float32))
    obs = np.clip(np.random.default_rng(0).normal(0, 2, (32, 388)), -5, 5).astype(np.float32)
    j_mean, j_value, j_log_std = (np.asarray(x) for x in model.apply(params, obs))
    port = p_nets.ActorCritic(388, 80, HIDDEN, HIDDEN)
    port.load_state_dict(actor_critic_from_flax(_np_tree(params)))
    with torch.no_grad():
        p_mean, p_value, p_log_std = port(torch.from_numpy(obs))
    # bf16 towers round at different places in the two frameworks: compare
    # at rtol 2e-2 with an absolute floor of 2% of each output's scale
    for p, j in ((p_mean, j_mean), (p_value, j_value)):
        np.testing.assert_allclose(p.numpy(), j, rtol=2e-2, atol=2e-2 * np.abs(j).max())
    np.testing.assert_array_equal(p_log_std.detach().numpy(), j_log_std)


@pytest.fixture(scope="module")
def jax_rollout():
    """(env, train state, env_state, key, traj) of one JAX rollout_phase at E=4."""
    jppo = JPPO(JTenAnt(ENV_CFG), num_envs=E, cfg=JConfig(hidden=HIDDEN), seed=0,
                print_log=False)
    ts = jppo.init_state()
    env_state, key, traj = jax.jit(jppo._make_train_iter().rollout_phase)(ts)
    return jppo.env, ts, env_state, key, traj


@pytest.fixture(scope="module")
def port_env():
    return PTenAnt(ENV_CFG, device="cpu")


def _port_ppo(env, params, **cfg):
    ppo = PPPO(env, E, PConfig(hidden=HIDDEN, **cfg), device="cpu", print_log=False)
    ppo.model.load_state_dict(actor_critic_from_flax(_np_tree(params)))
    ppo.init_state()
    return ppo


def _jax_update(jenv, ts, env_state, key, traj, **cfg):
    jppo = JPPO(jenv, num_envs=E, cfg=JConfig(hidden=HIDDEN, **cfg), seed=0, print_log=False)
    return jax.jit(jppo._make_train_iter().update_phase)(ts, env_state, key, traj)


def test_update_phase_matches_jax(jax_rollout, port_env):
    jenv, ts, env_state, key, traj = jax_rollout
    _, j_m = _jax_update(jenv, ts, env_state, key, traj)
    ppo = _port_ppo(port_env, ts.params)
    p_m = ppo.update_phase({k: _t(v) for k, v in traj.items()}, _t(env_state.obs))
    np.testing.assert_allclose(float(p_m["mean_value_loss"]), float(j_m["mean_value_loss"]),
                               rtol=2e-2)
    # the surrogate loss is in units of the normalised advantage (std 1) and
    # averages to near 0, so it gets an absolute floor in those units
    np.testing.assert_allclose(float(p_m["mean_surrogate_loss"]),
                               float(j_m["mean_surrogate_loss"]), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(float(p_m["lr"]), float(j_m["lr"]), rtol=2e-2)
    np.testing.assert_allclose(float(p_m["mean_reward"]), float(j_m["mean_reward"]), rtol=1e-6)


def test_one_adam_step_matches_jax(jax_rollout, port_env):
    """noptepochs=1, nminibatches=1: each side takes exactly one Adam step.
    Adam's first step moves every weight by about lr * sign(g), so a bf16
    gradient near 0 may flip sign between the two frameworks: parameters
    agree to 2 * lr, and the median difference stays far below lr."""
    jenv, ts, env_state, key, traj = jax_rollout
    one = dict(noptepochs=1, nminibatches=1)
    j_ts, j_m = _jax_update(jenv, ts, env_state, key, traj, **one)
    ppo = _port_ppo(port_env, ts.params, **one)
    p_traj = {k: _t(v) for k, v in traj.items()}
    # the rollout's stored mean is each package's own forward, so the
    # pre-step KL is exactly 0 on both sides and the lr stays 3e-4
    with torch.no_grad():
        p_traj["mean"] = ppo.model(p_traj["obs"].reshape(-1, 388))[0].reshape(p_traj["mean"].shape)
    p_m = ppo.update_phase(p_traj, _t(env_state.obs))
    lr = 3e-4
    assert float(j_m["lr"]) == pytest.approx(lr) and float(p_m["lr"]) == pytest.approx(lr)
    j_sd = actor_critic_from_flax(_np_tree(j_ts.params))
    p_sd = ppo.model.state_dict()
    before = actor_critic_from_flax(_np_tree(ts.params))
    diffs = []
    for k, j in j_sd.items():
        d = (p_sd[k] - j).abs()
        assert float(d.max()) <= 2 * lr * (1 + 1e-3), k
        assert float((j - before[k]).abs().max()) > 0.5 * lr, k  # the step moved it
        diffs.append(d.reshape(-1))
    assert float(torch.cat(diffs).median()) < 0.05 * lr


def test_port_ppo_run_two_iterations(port_env):
    ppo = PPPO(port_env, E, PConfig(hidden=HIDDEN), device="cpu", print_log=False)
    ppo.run(2)
    assert ppo.state.iteration == 2
    m = ppo.last_metrics
    for k in ("mean_value_loss", "mean_surrogate_loss", "mean_reward", "lr"):
        assert np.isfinite(m[k]), k
    assert all(torch.isfinite(p).all() for p in ppo.model.parameters())
    assert ppo.state.env_state.obs.shape == (E, 388)


def test_cli_trains_tenant_ppo(capsys):
    from massive_marl_tpu_torch.cli.train import main
    main(["--device", "cpu", "--num_envs", "2", "--max_iterations", "1"])
    assert "it 0: rew/step" in capsys.readouterr().out
    with pytest.raises(SystemExit):   # OneAnt is single-agent: PPO only
        main(["--task", "OneAnt", "--algo", "mappo", "--device", "cpu"])
    with pytest.raises(SystemExit):
        main(["--task", "TenAnt", "--fused_kernel", "2", "--device", "cpu"])
